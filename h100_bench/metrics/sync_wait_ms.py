"""Milliseconds a frame that the host waited in ``frame.hit_count``: the
``nonzero`` that reads the frame's hit count, which waits for the device
to finish the work queued before it (the probe, and with a frame in
flight that frame's chunks). Read from the program's spans of the traced
slice (``fourier_feature_nets_torch.utils.tracing``); None from a
program without them."""


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
    return 1e3 * sum(s.seconds for s in spans
                     if s.name == "frame.hit_count") / frames
