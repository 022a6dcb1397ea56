"""Kind ``train``: ``Raycaster.fit`` training a NeRF on the synthetic
scene, in graph chunks of ``steps_per_call`` steps, as ``train_nerf``
runs it.

Set-up renders the scene's images from its fixed rig, seeds the model's
weights on the device and calls ``fit`` for more steps than any window
holds. ``fit``'s first call captures the chunk's CUDA graph and runs the
first ``steps_per_call`` steps, and ``fit`` validates after it; the
benchmark's visualizer, which ``fit`` calls after each call, closes
set-up at its first call and the window at the first call after
``--seconds``. ``step_ms`` is the window's seconds, ending in a device
synchronise, over the steps of the calls issued in it. A traced run then
traces ``trace_calls`` more calls. One more call runs after that, and
the visualizer raises out of ``fit`` after it.

The check follows two calls with the plain reference (:class:`Calls`
reads them): the first, from the seeded weights and a fresh Adam, and
the call after the window, from the weights and Adam's moments the
program held before it, at the step the window's calls have reached.
Each call's steps' losses, the first step's gradient as the optimizer
received it, and each parameter's change over the call are compared.
"""

import sys

import numpy as np
import torch

from ..families import family
from ..reference.geometry import rig_rays
from ..reference.steps import follow_training
from ..traffic.generator import synthetic_scene
from ..weights import seeded_flat
from .common import (Check, WindowClosed, call_summary, compute_dtype,
                     leaf_diff, leaf_gap, moving_leaves, now, sync)

__all__ = ["Cell", "Calls", "CallChecks", "Phases", "TINY"]

# the CPU tests' cut of a train mix
TINY = {"batch_size": 64, "num_samples": 8, "steps_per_call": 4,
        "trace_calls": 2,
        "scene": {"resolution": 16, "split_counts": [3, 1, 1],
                  "num_cameras": 5, "volume_side": 16, "march_samples": 32}}


class Calls:
    """Reads two calls of the program's chunked step: the first, and the
    call after :meth:`arm`. Of each it keeps the ``steps`` values its loss
    function returned (``sys.monitoring`` on that function's code, which
    touches nothing else), the first step's gradients as the optimizer
    stepped on them (an optimizer hook) and the parameters after it; of
    the armed call also the parameters and Adam's moments before it.

    On a card the first call's values are read while its graph is
    captured: the tensors are kept, so each replay writes its call's
    values into them, and they are copied on the device's stream when a
    call (``chunk_call``, also monitored) returns from its replay: the
    first call, and the call after :meth:`arm`. ``on_first`` runs after
    the first copy. On a CPU the calls run eagerly and their own tensors
    are read: the first call's as it runs (its parameters at
    :meth:`close_first`), the armed call's until its ``steps``-th
    optimizer step."""

    TOOL = 4

    def __init__(self, device, loss_function, steps: int, params,
                 chunk_call, on_first=None):
        from torch.optim.optimizer import register_optimizer_step_post_hook
        self.device = torch.device(device)
        self.code, self.steps = loss_function.__code__, steps
        self.chunk_code = chunk_call.__code__
        self.params = list(params)
        self.on_first = on_first
        self.losses, self.grads = [], None
        self.first = self.late = self.armed = self.optimizer = None
        self.open, self.armed_steps = True, 0
        self._hook = register_optimizer_step_post_hook(self._on_step)
        monitoring = sys.monitoring
        monitoring.use_tool_id(self.TOOL, "h100_bench")
        monitoring.register_callback(self.TOOL, monitoring.events.PY_RETURN,
                                     self._on_return)
        for code in (self.code, self.chunk_code):
            monitoring.set_local_events(self.TOOL, code,
                                        monitoring.events.PY_RETURN)

    def recording(self) -> bool:
        if not self.open:
            return False
        if self.device.type == "cuda":
            return torch.cuda.is_current_stream_capturing()
        return True

    def _on_return(self, code, offset, value) -> None:
        if code is self.code:
            if self.recording() and len(self.losses) < self.steps:
                self.losses.append(value)
        elif self.first is None and self.losses:
            self.first = self._copy()
            if self.on_first is not None:
                self.on_first()
        elif self.armed is not None and self.late is None:
            self.late = self._copy()

    def _on_step(self, optimizer, args, kwargs) -> None:
        self.optimizer = optimizer
        if not self.recording():
            return
        if self.grads is None:
            self.grads = [p.grad for group in optimizer.param_groups
                          for p in group["params"]]
        if self.armed is not None:
            self.armed_steps += 1
            if self.armed_steps == self.steps:
                self.late = self._copy()
                self.open = False

    def _copy(self) -> dict:
        return {"losses": [v.detach().clone() for v in self.losses],
                "grads": [g.detach().clone() for g in self.grads or ()],
                "params": [p.detach().clone() for p in self.params]}

    def close_first(self) -> dict:
        """The first call's values; stops reading them."""
        self.open = False
        first = self.first or self._copy()
        first["losses"] = [float(v) for v in first["losses"]]
        return first

    def arm(self, step: int) -> None:
        """Reads the next call, which starts at ``step``: the parameters
        and Adam's moments now, and the call's values once it has run."""
        # a program that never stepped its optimizer has no moments: zero
        state = self.optimizer.state if self.optimizer is not None else {}
        zeros = [torch.zeros_like(p) for p in self.params]
        self.armed = {
            "step": step,
            "params": [p.detach().clone() for p in self.params],
            "exp_avg": [state[p]["exp_avg"].detach().clone() if p in state
                        else z for p, z in zip(self.params, zeros)],
            "exp_avg_sq": [state[p]["exp_avg_sq"].detach().clone()
                           if p in state else z
                           for p, z in zip(self.params, zeros)]}
        if self.device.type != "cuda":
            self.losses, self.grads, self.open = [], None, True

    def late_call(self) -> dict:
        """The armed call's values, with its start (empty if it never
        ran)."""
        late = dict(self.late or {"losses": [], "grads": [], "params": []})
        late["losses"] = [float(v) for v in late["losses"]]
        return dict(late, start=self.armed)

    def finish(self) -> None:
        """Stops reading for good."""
        if self._hook is None:
            return
        self.open = False
        self._hook.remove()
        self._hook = None
        monitoring = sys.monitoring
        for code in (self.code, self.chunk_code):
            monitoring.set_local_events(self.TOOL, code, 0)
        monitoring.register_callback(self.TOOL, monitoring.events.PY_RETURN,
                                     None)
        monitoring.free_tool_id(self.TOOL)


class Phases:
    """The clock of a run of calls, told after each call (``after_call``)
    the step the next call starts at. The first call ends set-up (the
    window opens there, or earlier by :meth:`open`); then the window for
    ``seconds``, in a traced run ``trace_calls`` calls under the tracer,
    and one call that :class:`Calls` reads; after it :meth:`after_call`
    raises :class:`WindowClosed`."""

    def __init__(self, cell, seconds: float, tracer, trace_calls: int):
        self.cell, self.seconds, self.tracer = cell, seconds, tracer
        self.trace_calls = trace_calls
        self.phase, self.start, self.end = "set-up", 0.0, 0.0
        self.first_step = self.window_steps = self.traced_steps = 0
        self.traced = 0
        self.marks = []

    def open(self, step: int) -> None:
        """Opens the window before the call that starts at ``step``."""
        sync(self.cell.device)
        self.phase, self.start, self.first_step = "window", now(), step

    def after_call(self, next_step: int) -> None:
        cell = self.cell
        if cell.first is None:
            cell.first = cell.reader.close_first()
            if self.phase == "set-up":
                self.open(next_step)
                return
        if self.phase == "window":
            self.marks.append(now())
            self.window_steps = next_step - self.first_step
            if now() - self.start < self.seconds:
                return
            sync(cell.device)
            self.end = now()
            if self.tracer.enabled:
                self.tracer.start()
                self.phase, self.trace_from = "trace", next_step
                return
        elif self.phase == "trace":
            self.traced += 1
            self.traced_steps = next_step - self.trace_from
            if self.traced < self.trace_calls:
                return
            self.tracer.stop()
        elif self.phase == "late":
            raise WindowClosed
        cell.reader.arm(next_step)
        self.phase = "late"


class CallChecks:
    """The check of a cell whose window drives a chunked training step:
    the program's first call and its call after the window (``first`` and
    ``late``, read by :class:`Calls`), each against the reference's
    follower of that call (``follow``, judged by ``readings``)."""

    def program_sides(self) -> dict:
        """The two calls the program ran, as followers' results read."""
        first = self.first
        late = self.late
        start = late["start"]["params"] if late["start"] else []
        return {"": {"losses": first["losses"], "grads": first["grads"],
                     "change": [p - s for p, s in zip(
                         first["params"], _leaves(self.flat,
                                                  first["params"]))]},
                "late_": {"losses": late["losses"], "grads": late["grads"],
                          "change": [p - s for p, s
                                     in zip(late["params"], start)]}}

    def truths(self, **kwargs) -> dict:
        """The followers (the reference, or a control) of the two calls."""
        out = {"": self.follow(**kwargs)}
        if self.late["start"]:
            out["late_"] = self.follow(start=self.late["start"], **kwargs)
        return out

    def values(self, sides: dict, truths: dict) -> dict:
        values = {}
        for prefix, side in sides.items():
            if prefix not in truths:
                continue
            for name, value in self.readings(side, truths[prefix]).items():
                values[prefix + name] = value
        return values

    def check(self, limits: dict) -> list:
        values = self.values(self.program_sides(), self.truths())
        return [Check(name, values.get(name, float("inf")), limit)
                for name, limit in limits.items()]

    def control(self) -> dict:
        """Readings of the program, the fp8 control and a loss over half
        the batch, each against the reference, on both calls."""
        truths = self.truths()
        rows = {"program": self.values(self.program_sides(), truths)}
        for name, kwargs in (("control", {"quant": "fp8"}),
                             ("half_batch", {"half_batch": True})):
            followed = self.truths(**kwargs)
            sides = {prefix: dict(side, grads=side["first_grads"])
                     for prefix, side in followed.items()}
            rows[name] = self.values(sides, truths)
        return rows


class Cell(CallChecks):
    """One run of a ``train`` cell."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, configs):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.first = self.phases = None

    def _datasets(self):
        from fourier_feature_nets_torch.cameras import CameraInfo, Resolution
        from fourier_feature_nets_torch.datasets import ImageDataset
        mix, scene = self.mix, self.mix["scene"]
        images, k, e, scale = synthetic_scene(scene, self.device)
        self.images, self.k, self.e = images, k, e
        self.scale = scale
        bounds = np.diag([2 * scale] * 3 + [1.0]).astype(np.float32)
        size = scene["resolution"]
        train_n, val_n = scene["split_counts"][:2]
        cameras = [CameraInfo.create(f"cam{i}", Resolution(size, size),
                                     k[i], e[i]) for i in range(len(k))]
        train = ImageDataset("train", images[:train_n], bounds,
                             cameras[:train_n], mix["num_samples"], True,
                             True, None, mix["batch_size"], "RGB",
                             anneal_start=mix["anneal_start"],
                             num_anneal_steps=mix["num_anneal_steps"],
                             alpha_weight=mix["alpha_weight"],
                             device=self.device)
        val = ImageDataset("val", images[train_n:train_n + val_n], bounds,
                           cameras[train_n:train_n + val_n],
                           mix["num_samples"], True, False, None,
                           mix["batch_size"], "RGB",
                           alpha_weight=mix["alpha_weight"],
                           device=self.device)
        return train, val

    def setup(self) -> None:
        from fourier_feature_nets_torch.render import Raycaster
        from fourier_feature_nets_torch.render.raycaster import _GraphChunk
        self.train, self.val = self._datasets()
        generator = torch.Generator(self.device).manual_seed(self.seed)
        self.flat = seeded_flat(self.cfg, generator, self.device)
        self.model = family(self.cfg).program(self.cfg, self.flat,
                                              self.device)
        self.raycaster = Raycaster(self.model,
                                   compute_dtype=compute_dtype(self.cfg))
        self.reader = Calls(self.device, type(self.train).loss,
                            self.mix["steps_per_call"],
                            self.model.parameters(), _GraphChunk.__call__)

    def _fit(self, visualizer) -> None:
        mix = self.mix
        self.raycaster.fit(
            self.train, self.val, mix["batch_size"], mix["learning_rate"],
            num_steps=10 ** 12, crop_steps=0, report_interval=10 ** 12,
            decay_rate=mix["decay_rate"], decay_steps=mix["decay_steps"],
            weight_decay=0.0, visualizers=[visualizer], seed=self.seed,
            steps_per_call=mix["steps_per_call"])

    def window(self, seconds: float, tracer) -> dict:
        phases = self.phases = Phases(self, seconds, tracer,
                                      self.mix["trace_calls"])

        class Clock:
            def visualize(self, step, render_fn, act_fn):
                phases.after_call(step + 1)

        try:
            self._fit(Clock())
        except WindowClosed:
            pass
        finally:
            self.reader.finish()
        self.late = self.reader.late_call()
        marks = [phases.start] + phases.marks
        print("train: host time between calls: "
              + call_summary(np.diff(marks).tolist()), file=sys.stderr)
        steps = phases.window_steps
        return {"start": phases.start, "attempted": steps, "failed": 0,
                "metrics": {"step_ms": ((phases.end - phases.start) * 1e3
                                        / steps, "ms")}}

    def release(self) -> None:
        self.raycaster = self.model = self.train = self.val = None

    def follow(self, quant=None, half_batch=False, start=None) -> dict:
        """The reference (or, with ``quant``, the control) over the first
        call's steps, or over the call from ``start``."""
        size = self.mix["scene"]["resolution"]
        train_n = self.mix["scene"]["split_counts"][0]
        origins, dirs = rig_rays(self.k[:train_n], self.e[:train_n], size,
                                 size)
        images = torch.from_numpy(self.images[:train_n].reshape(-1, 4))
        images = images.to(self.device).float() / 255.0
        data = {"starts": torch.from_numpy(origins).to(self.device),
                "dirs": torch.from_numpy(dirs).to(self.device),
                "colors": images[:, :3], "alphas": images[:, 3],
                "lo": torch.full((3,), -self.scale, device=self.device),
                "hi": torch.full((3,), self.scale, device=self.device)}
        flat = _flat(start["params"]) if start is not None else self.flat
        model = family(self.cfg).reference(self.cfg, flat, self.device)
        out = follow_training(model, data, self.mix, self.seed,
                              self.mix["steps_per_call"], quant, half_batch,
                              start)
        out["change"] = [p - f for p, f in zip(out["params"],
                                                _leaves(flat, model))]
        return out

    def readings(self, side: dict, truth: dict) -> dict:
        return training_readings(side, truth)

    def counts(self) -> dict:
        counts = family(self.cfg).counts
        points = self.mix["batch_size"] * self.mix["num_samples"]
        steps = self.phases.traced_steps
        bounds = counts.step_bounds(self.cfg, points)
        return dict({key: steps * seconds for key, seconds in bounds.items()},
                    units=steps,
                    window_model_flops=self.phases.window_steps * points
                    * counts.step_flops(self.cfg),
                    window_seconds=self.phases.end - self.phases.start)


def training_readings(side: dict, truth: dict) -> dict:
    """Every step's relative loss gap, the first gradient's gap of norms
    and norm of the difference, and the gap of the changes' norms, each
    by the worst leaf (leaves that move by round-off alone left out of
    the change)."""
    keep = moving_leaves(truth["first_grads"])
    # a step that never reached the optimizer has no gradient to read
    grads = side["grads"] or [torch.full_like(g, float("inf"))
                              for g in truth["first_grads"]]
    losses = np.asarray(side["losses"], np.float64)
    true_losses = np.asarray(truth["losses"], np.float64)
    loss_gap = (float(np.max(np.abs(losses - true_losses) / true_losses))
                if losses.shape == true_losses.shape else float("inf"))
    change = side["change"] or [torch.full_like(c, float("inf"))
                                for c in truth["change"]]
    return {"loss_gap": loss_gap,
            "grad_gap": leaf_gap(grads, truth["first_grads"]),
            "grad_diff": leaf_diff(grads, truth["first_grads"]),
            "change_gap": leaf_gap(change, truth["change"], keep)}


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _leaves(flat: torch.Tensor, like) -> list:
    """``flat`` cut into tensors shaped as ``like``'s (parameters, or a
    module's)."""
    tensors = list(like.parameters()) if hasattr(like, "parameters") \
        else list(like)
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()
    return out
