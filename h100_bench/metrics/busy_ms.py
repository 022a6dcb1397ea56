"""Milliseconds a frame or step in which some operation ran on the
device, in the traced slice. Against the untraced ``frame_ms`` or
``step_ms`` it bounds the device's idle share from below; the slice's
own idle share also holds the profiler's cost."""


def read(trace):
    if trace.get("busy_s", 0.0) <= 0.0 or not trace.get("units"):
        return None
    return 1e3 * trace["busy_s"] / trace["units"]
