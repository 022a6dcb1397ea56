"""K2's share of its roofline in the traced slice: the frozen bound of
the backward it ran (3 forwards a point) over K2's device time by kernel
name, in percent."""

from h100_bench.trace import K2_NAMES, kernel_seconds


def read(trace):
    seconds = kernel_seconds(trace.get("device_ops", ()), K2_NAMES)
    bound = trace.get("k2_bound_s", 0.0)
    if seconds <= 0.0 or bound <= 0.0:
        return None
    return 100.0 * bound / seconds
