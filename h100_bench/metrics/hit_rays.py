"""Rays a frame that the culled frame sends to the model: the mean of
the ``frame`` spans' ``hit_rays`` over the traced slice's frames (a
count: it follows the cameras the slice renders, not the clock). Read
from the program's spans (``fourier_feature_nets_torch.utils.tracing``);
None from a program without them."""


def read(trace):
    if not trace.get("units"):
        return None
    try:
        from fourier_feature_nets_torch.utils.tracing import latest
    except ImportError:
        return None
    hits = [s.attrs["hit_rays"] for s in latest()[0] if s.name == "frame"]
    return sum(hits) / len(hits) if hits else None
