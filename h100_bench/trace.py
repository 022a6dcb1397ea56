"""The traced window: ``torch.profiler`` over a slice of the run's work,
reduced to device operations, busy time and idle gaps.

On a card the profiler records the device's activity alone (CUPTI's
kernels, copies and the CUDA runtime's calls): it slowed a traced
800 px frame from 84 to ~97 ms, where recording every host operator as
well slowed it to ~122 ms. An idle gap of the device is labelled by the
innermost host event that covers its middle: on a card, the CUDA
runtime call the host was in.
"""

import time

import torch

__all__ = ["Tracer", "kernel_seconds", "reduce_events"]

K1_NAMES = ("fused_nerf_bf16_kernel", "fused_nerf_tf32_kernel")
K2_NAMES = ("fused_nerf_backward",)
# the profiler's own host events, which name no work of the program
_PROFILER_EVENTS = ("Activity Buffer Request", "Buffer Flush",
                    "Command Buffer Full")


class Tracer:
    """Starts and stops the profiler around the traced slice; the slice's
    length is the host clock between the two, each after a device
    synchronise."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = torch.device(device)
        self.profile = None
        self.window_s = 0.0
        self._start = 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        activities = ([ProfilerActivity.CUDA] if self.device.type == "cuda"
                      else [ProfilerActivity.CPU])
        self._sync()
        self.profile = profile(activities=activities)
        self.profile.start()
        self._start = time.perf_counter()

    def stop(self):
        if self.profile is None:
            return
        self._sync()
        self.window_s = time.perf_counter() - self._start
        self.profile.stop()

    def summary(self) -> dict:
        """The slice reduced by :func:`reduce_events`; empty when off."""
        if self.profile is None:
            return {}
        from torch.autograd import DeviceType
        device_ops, host_ops = [], []
        for event in self.profile.events():
            row = (event.name, float(event.time_range.start),
                   float(event.time_range.end))
            if event.device_type == DeviceType.CUDA:
                # a host annotation's shadow on the device timeline is no
                # work of the device's
                if not getattr(event, "is_user_annotation", False):
                    device_ops.append(row)
            elif (event.device_type == DeviceType.CPU
                  and event.name not in _PROFILER_EVENTS):
                host_ops.append(row)
        return reduce_events(device_ops, host_ops, self.window_s)


def _merge(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def reduce_events(device_ops, host_ops, window_s: float) -> dict:
    """``device_ops`` and ``host_ops`` as (name, start_us, end_us) ->
    the slice's ``device_ops``, ``busy_s``, ``window_s``, the ten device
    operations that took most time (``top``) and the ten longest idle
    gaps between the first and the last device operation, each named by
    the innermost host event covering its middle (``gaps``)."""
    merged = _merge([(s, e) for _, s, e in device_ops])
    busy_s = sum(e - s for s, e in merged) * 1e-6
    totals = {}
    for name, start, end in device_ops:
        totals[name] = totals.get(name, 0.0) + (end - start) * 1e-6
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(((start - end, end, start) for (_, end), (start, _)
                   in zip(merged[:-1], merged[1:])), reverse=True)[:10]
    named = []
    for length, end, start in gaps:
        middle = 0.5 * (end + start)
        covering = [(e - s, name) for name, s, e in host_ops
                    if s <= middle <= e]
        named.append([min(covering)[1] if covering else "(no host event)",
                      length * 1e-6])
    return {"device_ops": device_ops, "busy_s": busy_s,
            "window_s": window_s, "top": [list(r) for r in top],
            "gaps": named}


def kernel_seconds(device_ops, names) -> float:
    """Device seconds of the operations whose name holds one of
    ``names``."""
    return sum((end - start) * 1e-6 for name, start, end in device_ops
               if any(n in name for n in names))
