"""The hash encoding's share of its roofline in the traced slice: the
frozen bound of its forward and backward (``hash_bound_s``, compulsory
bytes at the HBM rate, ``counts/hash_grid.py``) over the device time of
the kernels whose name holds ``hash_grid``, in percent. None on a trace
without them."""

from h100_bench.trace import kernel_seconds

HASH_NAMES = ("hash_grid",)


def read(trace):
    seconds = kernel_seconds(trace.get("device_ops", ()), HASH_NAMES)
    bound = trace.get("hash_bound_s", 0.0)
    if seconds <= 0.0 or bound <= 0.0:
        return None
    return 100.0 * bound / seconds
