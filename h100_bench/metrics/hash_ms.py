"""Device milliseconds a step in the hash encoding's kernels (every
kernel whose name holds ``hash_grid``: the encode and the backward) in
the traced slice. None on a trace without them."""

from h100_bench.metrics.hash_roofline import HASH_NAMES
from h100_bench.trace import kernel_seconds


def read(trace):
    seconds = kernel_seconds(trace.get("device_ops", ()), HASH_NAMES)
    if seconds <= 0.0 or not trace.get("units"):
        return None
    return 1e3 * seconds / trace["units"]
