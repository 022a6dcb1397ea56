"""The whole frame's or step's share of the bf16 peak: the model
operations of the untraced window (a frame: the reference's drawn rays x
samples x a forward; a step: 3 forwards a point trained, 1 a teacher's
point) over the window's seconds, in percent. The profiler's slice is
not used: it runs slower than the window."""

from h100_bench.counts.h100 import PEAK_BF16_FLOPS


def read(trace):
    seconds = trace.get("window_seconds", 0.0)
    flops = trace.get("window_model_flops", 0)
    if seconds <= 0.0 or not flops:
        return None
    return 100.0 * flops / seconds / PEAK_BF16_FLOPS
