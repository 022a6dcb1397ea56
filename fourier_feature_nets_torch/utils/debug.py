"""Debugging and profiling hooks.

Port of ``fourier_feature_nets_tpu/utils/debug.py``:

* NaN detection: :func:`enable_debug_nans` turns on autograd's anomaly
  mode with its NaN check (``torch.autograd.set_detect_anomaly(True,
  check_nan=True)``), so a backward function that returns a NaN raises
  ``RuntimeError`` naming it and the forward operation that made it.
  The JAX switch raises at the first NaN of any jitted computation,
  forward included; this one checks the gradients. ``FFN_TORCH_DEBUG_NANS``
  (any value but empty, ``0`` or ``false``) turns it on when the package
  is imported. The check reads every gradient on the host, which a CUDA
  graph cannot capture: a graph chunk (``--steps-per-call`` > 1 on CUDA)
  raises ``ValueError`` under it.
* Profiling: :func:`profile` records the enclosed region with
  ``torch.profiler`` (the host, and the card where there is one) and the
  program's spans on every thread (:mod:`.tracing`), and writes both in
  a Chrome trace that Perfetto or TensorBoard reads.

The JAX package's ``FFN_TPU_FORCE_CPU`` has no counterpart: the port's
CLIs take ``--device cpu``.
"""

import contextlib
import json
import os

import torch

from . import tracing

__all__ = ["debug_nans_enabled", "enable_debug_nans", "init_from_env",
           "profile"]


def enable_debug_nans(enable: bool = True) -> None:
    """Raises at the first backward function that returns a NaN."""
    torch.autograd.set_detect_anomaly(enable, check_nan=enable)


def debug_nans_enabled() -> bool:
    """Whether :func:`enable_debug_nans`'s check is on."""
    return (torch.is_anomaly_enabled()
            and torch.is_anomaly_check_nan_enabled())


@contextlib.contextmanager
def profile(log_dir: str):
    """Records the enclosed region with ``torch.profiler`` and writes
    its trace to ``log_dir/trace.json`` (Chrome trace format)::

        with profile("/tmp/trace"):
            train_step(...)

    The program's spans are recorded on every thread meanwhile (the
    render server's too) and written into the trace on its clock
    (:func:`.tracing.profile_spans`), category ``program_span``.
    """
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with torch.profiler.profile(activities=activities) as prof:
        with tracing.record_all_threads() as session:
            yield prof
    prof.export_chrome_trace(path)
    with open(path) as handle:
        trace = json.load(handle)
    # the trace's clock: microseconds after baseTimeNanoseconds, where
    # profile_spans' is microseconds after the profile's start
    shift = (tracing.trace_start_ns(prof)
             - trace.get("baseTimeNanoseconds", 0)) * 1e-3
    trace["traceEvents"].extend(
        {"ph": "X", "cat": "program_span", "name": name,
         "pid": os.getpid(), "tid": item.thread, "ts": start + shift,
         "dur": end - start,
         "args": dict(item.attrs, id=item.id, parent=item.parent)}
        for name, start, end, item in tracing.profile_spans(prof, session))
    with open(path, "w") as handle:
        json.dump(trace, handle)


def init_from_env() -> None:
    """Applies ``FFN_TORCH_DEBUG_NANS`` (read when the package is
    imported)."""
    if os.environ.get("FFN_TORCH_DEBUG_NANS", "") not in ("", "0",
                                                           "false"):
        enable_debug_nans()
