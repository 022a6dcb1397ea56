"""Kind ``distill``: ``render.distill.distill`` of a student NeRF from a
seeded teacher along the rays of a hemisphere rig, in graph chunks of
``steps_per_call`` steps, as ``distill_model`` runs it.

Set-up seeds the teacher's and the student's weights on the device,
builds the program's stratified occupancy sampler from the mix's
occupancy source (``kinds/orbit.py``; by default the teacher's density
grid) and calls ``distill`` for more steps than any window holds,
reporting every ``report_interval`` steps (``distill_model``'s 1000).
``distill``'s first chunk captures the CUDA graph and runs the first
``steps_per_call`` steps; the window opens when it returns (on a CPU, at
the first report) and closes at the first report after ``--seconds``.
The reporter's loss is read on the host, so each report ends in a
synchronise; ``distill_step_ms`` is the window's seconds over its steps. A
traced run then traces ``trace_calls`` more reports. After that one
more chunk is read (``train.Calls``), and the next report raises out of
``distill``.

The check follows two chunks with the plain reference: the first, from
the seeded weights and a fresh Adam, and the chunk after the window,
from the weights and Adam's moments the program held before it, at the
step the window reached. It compares the first step's gradient and each
parameter's change over the chunk. The loss is not compared: it is the
squared difference of two random fields, whose relative gap swings from
seed to seed by more than the control's (PERF.md).
"""

import sys

import torch

from ..families import family
from ..reference.geometry import Occupancy, rig_tables
from ..reference.steps import follow_distillation
from ..traffic.generator import hemisphere_rig
from ..weights import seeded_flat
from .common import WindowClosed, add_bounds, call_summary
from .orbit import cameras_of, program_sampler, reference_grid
from .train import (CallChecks, Calls, Phases, _flat, _leaves,
                    training_readings)

__all__ = ["Cell", "TINY"]

# the CPU tests' cut of a distill mix
TINY = {"resolution": 16, "num_cameras": 4, "num_samples": 8,
        "batch_rays": 32, "steps_per_call": 4, "report_interval": 4,
        "trace_calls": 2,
        "occupancy": {"resolution": 8, "probe_resolution": 4}}


class Cell(CallChecks):
    """One run of a ``distill`` cell."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, configs):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.teacher_cfg = configs[mix["teacher"]]
        self.device = torch.device(device)
        self.first = self.phases = None

    def setup(self) -> None:
        generator = torch.Generator(self.device).manual_seed(self.seed)
        self.teacher_flat = seeded_flat(self.teacher_cfg, generator,
                                        self.device)
        self.flat = seeded_flat(self.cfg, generator, self.device)
        self.teacher = family(self.teacher_cfg).program(
            self.teacher_cfg, self.teacher_flat,
            self.device).requires_grad_(False)
        self.student = family(self.cfg).program(self.cfg, self.flat,
                                                self.device)
        self.k, self.e = hemisphere_rig(self.mix)
        cameras = cameras_of(self.k, self.e, self.mix["resolution"])
        self.sampler = program_sampler(self.teacher, self.mix, cameras,
                                       self.device, stratified=True)
        from fourier_feature_nets_torch.render.distill import distill_loss
        from fourier_feature_nets_torch.render.raycaster import _GraphChunk
        self.reader = Calls(self.device, distill_loss,
                            self.mix["steps_per_call"],
                            self.student.parameters(), _GraphChunk.__call__,
                            on_first=self._first_chunk_returned)

    def _first_chunk_returned(self) -> None:
        if self.phases is not None and self.phases.phase == "set-up":
            self.phases.open(self.mix["steps_per_call"])

    def window(self, seconds: float, tracer) -> dict:
        from fourier_feature_nets_torch.render.distill import distill
        mix = self.mix
        phases = self.phases = Phases(self, seconds, tracer,
                                      mix["trace_calls"])
        try:
            distill(self.teacher, self.student, self.sampler,
                    num_steps=10 ** 12, batch_rays=mix["batch_rays"],
                    learning_rate=mix["learning_rate"], seed=self.seed,
                    steps_per_call=mix["steps_per_call"],
                    rgb_floor=mix["rgb_floor"],
                    report_interval=mix["report_interval"],
                    reporter=lambda step, loss: phases.after_call(step))
        except WindowClosed:
            pass
        finally:
            self.reader.finish()
        self.late = self.reader.late_call()
        marks = [phases.start] + phases.marks
        print("distill: time between reports: " + call_summary(
            [b - a for a, b in zip(marks[:-1], marks[1:])]), file=sys.stderr)
        steps = phases.window_steps
        return {"start": phases.start, "attempted": steps, "failed": 0,
                "metrics": {"distill_step_ms": ((phases.end - phases.start) * 1e3
                                        / steps, "ms")}}

    def release(self) -> None:
        self.teacher = self.student = self.sampler = None

    def follow(self, quant=None, half_batch=False, start=None) -> dict:
        """The reference (or, with ``quant``, the control) over the first
        chunk's steps, or over the chunk from ``start``."""
        mix, occ = self.mix, self.mix["occupancy"]
        teacher = family(self.teacher_cfg).reference(
            self.teacher_cfg, self.teacher_flat,
            self.device).requires_grad_(False)
        flat = _flat(start["params"]) if start is not None else self.flat
        student = family(self.cfg).reference(self.cfg, flat, self.device)
        scale = mix["box_scale"]
        grid = reference_grid(teacher, mix, self.device)
        occupancy = Occupancy(grid, scale, occ["num_probes"],
                              occ["empty_weight"], occ["probe_resolution"])
        ray_m, positions = rig_tables(self.k, self.e, self.device)
        rig = {"ray_m": ray_m, "positions": positions,
               "width": mix["resolution"], "height": mix["resolution"],
               "lo": torch.full((3,), -scale, device=self.device),
               "hi": torch.full((3,), scale, device=self.device)}
        out = follow_distillation(teacher, student, rig, occupancy, mix,
                                  self.seed, mix["steps_per_call"], quant,
                                  half_batch, start)
        out["change"] = [p - f for p, f in zip(out["params"],
                                                _leaves(flat, student))]
        return out

    def readings(self, side: dict, truth: dict) -> dict:
        """As training's, but the loss gap is the first step's alone."""
        values = training_readings(side, truth)
        first = truth["losses"][0]
        values["loss_gap"] = (abs(side["losses"][0] - first) / first
                              if side["losses"] else float("inf"))
        return values

    def counts(self) -> dict:
        points = self.mix["batch_rays"] * self.mix["num_samples"]
        steps = self.phases.traced_steps
        teacher, student = self.teacher_cfg, self.cfg
        t_counts, s_counts = family(teacher).counts, family(student).counts
        bounds = add_bounds(add_bounds({}, t_counts.forward_bounds(
            teacher, points)), s_counts.step_bounds(student, points))
        return dict({key: steps * seconds for key, seconds in bounds.items()},
                    units=steps,
                    window_model_flops=self.phases.window_steps * points * (
                        t_counts.forward_flops(teacher)
                        + s_counts.step_flops(student)),
                    window_seconds=self.phases.end - self.phases.start)
