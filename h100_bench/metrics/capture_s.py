"""Seconds of set-up in the CUDA graphs' warm-up chunks and captures:
the ``graph.warmup`` and ``graph.capture`` set-up spans of the run
(``render/raycaster.py::_GraphChunk._capture``), less the kernel
libraries' builds and loads that ran while they were open
(``kernels.build``, on any thread: autograd runs a backward's launches
on a thread of its own; nvcc makes a build long in a new checkout). Read
from the program's set-up spans
(``fourier_feature_nets_torch.utils.tracing``); None from a program
without them."""

PARTS = ("graph.warmup", "graph.capture")


def read(trace):
    if not trace.get("units"):
        return None
    try:
        from fourier_feature_nets_torch.utils.tracing import latest
    except ImportError:
        return None
    setup = latest()[1]
    parts = [s for s in setup if s.name in PARTS]
    if not parts:
        return None
    builds = sum(b.seconds for b in setup if b.name == "kernels.build"
                 and any(p.start_ns <= b.start_ns and b.end_ns <= p.end_ns
                         for p in parts))
    return sum(s.seconds for s in parts) - builds
