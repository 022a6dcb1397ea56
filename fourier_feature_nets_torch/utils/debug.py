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
  ``torch.profiler`` (the host, and the card where there is one) and
  writes a Chrome trace that Perfetto or TensorBoard reads.

The JAX package's ``FFN_TPU_FORCE_CPU`` has no counterpart: the port's
CLIs take ``--device cpu``.
"""

import contextlib
import os

import torch

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
    """
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def init_from_env() -> None:
    """Applies ``FFN_TORCH_DEBUG_NANS`` (read when the package is
    imported)."""
    if os.environ.get("FFN_TORCH_DEBUG_NANS", "") not in ("", "0",
                                                           "false"):
        enable_debug_nans()
