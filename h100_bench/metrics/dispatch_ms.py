"""Milliseconds a frame that the host spent issuing the frame's work
after its hit count: ``frame.chunks`` (each chunk's sampling, K1 and
scatter) and ``frame.finish`` (the composite and the uint8 cast). Read
from the program's spans of the traced slice
(``fourier_feature_nets_torch.utils.tracing``); None from a program
without them."""

PARTS = ("frame.chunks", "frame.finish")


def read(trace):
    if not trace.get("units"):
        return None
    try:
        from fourier_feature_nets_torch.utils.tracing import latest
    except ImportError:
        return None
    spans = latest()[0]
    frames = sum(s.name == "frame" for s in spans)
    if not frames:
        return None
    return 1e3 * sum(s.seconds for s in spans if s.name in PARTS) / frames
