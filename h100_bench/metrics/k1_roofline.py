"""K1's share of its roofline in the traced slice: the frozen bound of
every forward it launched (the teacher's and the student's when
distilling) over K1's device time by kernel name, in percent."""

from h100_bench.trace import K1_NAMES, kernel_seconds


def read(trace):
    seconds = kernel_seconds(trace.get("device_ops", ()), K1_NAMES)
    bound = trace.get("k1_bound_s", 0.0)
    if seconds <= 0.0 or bound <= 0.0:
        return None
    return 100.0 * bound / seconds
