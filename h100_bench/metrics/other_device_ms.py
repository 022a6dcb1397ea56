"""Device milliseconds a frame or step of every operation but K1 and K2
in the traced slice: sampling, the probe, compositing, the loss, Adam."""

from h100_bench.trace import K1_NAMES, K2_NAMES, kernel_seconds


def read(trace):
    ops = trace.get("device_ops", ())
    if not ops or not trace.get("units"):
        return None
    total = sum((end - start) * 1e-6 for _, start, end in ops)
    kernels = kernel_seconds(ops, K1_NAMES + K2_NAMES)
    return 1e3 * (total - kernels) / trace["units"]
