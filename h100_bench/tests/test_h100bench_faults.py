"""Runs with the timed path broken underneath, at a tiny size on the CPU:
each must come out not correct. The faults: a step that leaves the state
unchanged, a loss over half the batch, frames altered or half left out
where they are produced. The cell's own limits judge them."""

import importlib
import itertools

import pytest

from h100_bench.run import run_cell
from h100_bench.spec import cell_parts, load_benchmark
from h100_bench.tests.tiny import tiny_parts, with_held_out

BENCH = with_held_out(load_benchmark())
ORBIT_CELLS = [w["name"] for w in BENCH["workloads"]
               if cell_parts(BENCH, w["name"])["mix"]["kind"] == "orbit"]


def _run(workload, seed=11, seconds=0.3):
    return run_cell(BENCH, workload, seed, seconds, False, "cpu", 0.0,
                    tiny_parts(workload, BENCH))


def _late_run(monkeypatch):
    """A training run whose window closes after 100 calls (400 steps)
    however fast the CPU is: its clock ticks 1 ms each time it is read,
    twice a call. Late enough that Adam's bias correction has moved on
    from the first call's."""
    ticks = itertools.count()
    monkeypatch.setattr("h100_bench.kinds.train.now",
                        lambda: next(ticks) * 1e-3)
    return _run("train-8x256", seconds=0.2)


@pytest.mark.parametrize("workload", ["train-8x256", "distill-6x192"])
def test_unchanged_state_is_caught(monkeypatch, workload):
    from fourier_feature_nets_torch.utils.optim import ClippedAdam
    assert _run(workload)["correct"]
    monkeypatch.setattr(ClippedAdam, "step", lambda self, lr: None)
    result = _run(workload)
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_batch_loss_is_caught_in_training(monkeypatch):
    from fourier_feature_nets_torch.datasets import ImageDataset
    from fourier_feature_nets_torch.render.raycaster import RenderResult
    full = ImageDataset.loss

    def half(self, rays, render):
        keep = rays.shape[0] // 2
        return full(self, rays[:keep], RenderResult(
            render.color[:keep], render.alpha[:keep], None))

    monkeypatch.setattr(ImageDataset, "loss", half)
    assert not _run("train-8x256")["correct"]


def test_half_batch_loss_is_caught_in_distillation(monkeypatch):
    distill = importlib.import_module(
        "fourier_feature_nets_torch.render.distill")
    full = distill.distill_loss

    def half(t_logits, s_logits, t_values, valid, rgb_floor):
        valid = valid.clone()
        valid[valid.shape[0] // 2:] = False
        return full(t_logits, s_logits, t_values, valid, rgb_floor)

    monkeypatch.setattr(distill, "distill_loss", half)
    assert not _run("distill-6x192")["correct"]


@pytest.mark.parametrize("workload", ORBIT_CELLS)
def test_altered_frames_are_caught(monkeypatch, workload):
    from fourier_feature_nets_torch.render import Raycaster
    frame = Raycaster.render_frame_async

    def altered(self, *args, **kwargs):
        image = frame(self, *args, **kwargs)
        image[: image.shape[0] // 4] = 255 - image[: image.shape[0] // 4]
        return image

    assert _run(workload)["correct"]
    monkeypatch.setattr(Raycaster, "render_frame_async", altered)
    assert not _run(workload)["correct"]


@pytest.mark.parametrize("workload", ORBIT_CELLS)
def test_half_the_rays_left_out_is_caught(monkeypatch, workload):
    from fourier_feature_nets_torch.render import Raycaster
    rays = Raycaster._render_rays

    def half(self, sample, offsets):
        colors = rays(self, sample, offsets)
        colors[colors.shape[0] // 2:] = 0.0
        return colors

    monkeypatch.setattr(Raycaster, "_render_rays", half)
    assert not _run(workload)["correct"]


def test_altered_served_frames_are_caught(monkeypatch):
    from fourier_feature_nets_torch.render.server import RenderServer
    serve = RenderServer.frame_pose
    served = []

    def altered(self, extrinsics, intrinsics=None):
        image = serve(self, extrinsics, intrinsics)
        served.append(1)
        return image if len(served) == 1 else 255 - image

    assert _run("serve-6x192")["correct"]
    monkeypatch.setattr(RenderServer, "frame_pose", altered)
    assert not _run("serve-6x192")["correct"]


def test_a_frozen_adam_step_is_caught_after_the_window(monkeypatch):
    from fourier_feature_nets_torch.utils.optim import ClippedAdam
    step = ClippedAdam.step

    def frozen(self, lr):
        step(self, lr)
        for state in self.optimizer.state.values():
            state["step"].clamp_(max=4.0)

    monkeypatch.setattr(ClippedAdam, "step", frozen)
    result = _late_run(monkeypatch)
    assert not result["correct"]
    checks = result["checks"]
    assert checks["change_gap"]["value"] <= checks["change_gap"]["limit"]
    assert checks["late_change_gap"]["value"] > \
        checks["late_change_gap"]["limit"]


def test_a_reused_batch_is_caught_after_the_window(monkeypatch):
    from fourier_feature_nets_torch.render import Raycaster
    make = Raycaster._make_train_step

    def reusing(self, *args, **kwargs):
        step_fn, first = make(self, *args, **kwargs), []

        def again(perm, offset, step, rng):
            first.append((perm, offset))
            return step_fn(*first[0], step, rng)
        return again

    monkeypatch.setattr(Raycaster, "_make_train_step", reusing)
    result = _late_run(monkeypatch)
    assert not result["correct"]
    checks = result["checks"]
    assert checks["loss_gap"]["value"] <= checks["loss_gap"]["limit"]
    assert checks["late_loss_gap"]["value"] > checks["late_loss_gap"]["limit"]
