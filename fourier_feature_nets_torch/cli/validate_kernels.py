"""CLI: holds the port's Hopper kernels to plain PyTorch on the card.

Port of ``tools/validate_kernels_tpu.py``, with its configurations,
sizes and tolerances:

* K1, the fused NeRF forward, in f32 (atol 5e-3) and bf16 (atol 0.2)
  against the plain model, at "flagship 8x256" and "2x32 no-skip
  no-raw", n = 4096 (the JAX tool's feature-major variants are the same
  kernel here, so one check per dtype);
* K2, the recompute backward, in f32: the loss of a fused train forward
  within 1e-4 and every gradient leaf within 5e-3 of autograd of the
  plain model, at both configurations;
* K3, the fused ray render, at S = 42, 48 and 128 with R = 64 on the
  4x64 skip-2 model: color and alpha within 5e-3 of
  ``Raycaster(model, fused=False).render`` in f32, and within 0.05 of
  its plain twin in bf16;
* T1, K3's exclusive-cumprod scan, within rtol 1e-5 of
  ``ops.blend.exclusive_cumprod`` at 128, 20 and 77 lanes.

* under a data-parallel mesh (the JAX tool's mesh checks; the ranks
  ``torchrun`` started, or this process alone): a fused train step (3
  steps a call, one CUDA graph on a card) against the plain one from
  the same weights, loss within 1e-3, and a fused frame against the
  same frame without the mesh, uint8 within 1.

It prints ``OK``/``FAIL`` lines in the JAX tool's format, then ``ALL
OK`` and exits 0, or exits 1 on any failure. It runs on ``--device cuda`` (the default) and exits 2
without a CUDA device; ``--device cpu`` runs the wrappers' plain twins,
which checks no kernel.

    python -m fourier_feature_nets_torch.cli.validate_kernels
"""

import sys
import time
from argparse import ArgumentParser

import numpy as np
import torch

from ..kernels.fused_nerf import (
    fused_nerf_apply,
    pack_fused_nerf,
    prepare_fused_nerf,
)
from ..kernels.fused_nerf_train import fused_nerf_train_apply
from ..kernels.fused_ray_render import (
    exclusive_cumprod_scan,
    fused_ray_render,
    fused_ray_render_reference,
)
from ..models import NeRF, flagship_nerf
from ..ops.blend import exclusive_cumprod
from ..render import Raycaster, RaySamples
from .common import kernel_device

CONFIGS = [
    ("flagship 8x256",
     lambda: flagship_nerf(torch.Generator().manual_seed(0))),
    ("2x32 no-skip no-raw",
     lambda: NeRF(num_layers=2, num_channels=32, max_log_scale_pos=3.0,
                  num_freq_pos=4, max_log_scale_view=1.0, num_freq_view=2,
                  skips=[], include_inputs=False,
                  generator=torch.Generator().manual_seed(0))),
]
RAY_MODEL = dict(num_layers=4, num_channels=64, max_log_scale_pos=9.0,
                 num_freq_pos=10, max_log_scale_view=3.0, num_freq_view=4,
                 skips=[2], include_inputs=True)
SCAN_LANES = (128, 20, 77)


class Report:
    """Prints one ``OK``/``FAIL`` line per check and remembers whether
    every check passed."""

    def __init__(self):
        self.ok = True
        self.lines = []

    def line(self, passed: bool, text: str) -> bool:
        line = f"{'OK ' if passed else 'FAIL'} {text}"
        print(line, flush=True)
        self.lines.append(line)
        self.ok &= passed
        return passed

    def check(self, name, actual, expected, atol) -> bool:
        err = _max_abs(actual, expected)
        return self.line(err <= atol, f"{name}: max err {err:.2e} "
                                      f"(atol {atol:g})")


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _max_abs(actual, expected) -> float:
    return float(np.max(np.abs(_numpy(actual) - _numpy(expected))))


def _points(rng: np.random.Generator, num: int, device):
    pos = rng.uniform(-1.5, 1.5, (num, 3)).astype(np.float32)
    views = rng.normal(size=(num, 3)).astype(np.float32)
    views /= np.linalg.norm(views, axis=-1, keepdims=True)
    return (torch.from_numpy(pos).to(device),
            torch.from_numpy(views).to(device))


def check_forward(report: Report, label: str, model: NeRF,
                  rng: np.random.Generator, device, num: int = 4096):
    """K1 in f32 and bf16 against the plain f32 model."""
    model = model.to(device)
    pos, views = _points(rng, num, device)
    with torch.no_grad():
        ref = model(pos, views)
        for dtype, name, atol in ((torch.float32, "f32", 5e-3),
                                  (torch.bfloat16, "bf16", 0.2)):
            out = fused_nerf_apply(prepare_fused_nerf(model, dtype), pos,
                                   views)
            report.check(f"fused_nerf {name} [{label}]", out, ref, atol)


def check_train(report: Report, label: str, model: NeRF,
                rng: np.random.Generator, device, num: int = 4096):
    """K2 in f32: loss and parameter gradients of a fused train forward
    (K1 forward, K2 backward) against autograd of the plain model."""
    model = model.to(device)
    pos, views = _points(rng, num, device)
    target = torch.from_numpy(rng.uniform(0, 1, (num, 4)).astype(
        np.float32)).to(device)
    results = {}
    for fused in (True, False):
        model.zero_grad()
        if fused:
            out = fused_nerf_train_apply(pack_fused_nerf(model, torch.float32),
                                         pos, views)
        else:
            out = model(pos, views)
        loss = torch.mean(torch.square(torch.sigmoid(out) - target))
        loss.backward()
        results[fused] = (loss.detach(),
                          [p.grad.detach().clone() for p in model.parameters()])
    report.check(f"fused_train loss [{label}]", results[True][0],
                 results[False][0], 1e-4)
    grad_err = max(_max_abs(a, b) for a, b in zip(results[True][1],
                                                  results[False][1]))
    report.line(grad_err < 5e-3,
                f"fused_train grads [{label}]: max err {grad_err:.2e}")
    model.zero_grad()


def _rays(rng: np.random.Generator, num_rays: int, num_samples: int, device):
    """The JAX tool's rays: sorted depths in [1, 4), unit directions,
    starts in [-0.5, 0.5); positions (R, S, 3), directions (R, 3)."""
    t = np.sort(rng.uniform(1, 4, (num_rays, num_samples)).astype(np.float32),
                -1)
    d = rng.normal(size=(num_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    start = rng.uniform(-0.5, 0.5, (num_rays, 3)).astype(np.float32)
    pos = (start[:, None] + t[..., None] * d[:, None]).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (pos, d, t))


def check_ray_render(report: Report, rng: np.random.Generator, device,
                     num_rays: int = 64, samples=(42, 48, 128)):
    """K3 against the plain render in f32 and its twin in bf16, at the
    sample counts where the TPU kernel's last-sample gate once failed
    (42, 48) and at 128."""
    model = NeRF(**RAY_MODEL, generator=torch.Generator().manual_seed(1))
    model = model.to(device)
    caster = Raycaster(model, fused=False)
    w32 = prepare_fused_nerf(model, torch.float32)
    wbf = prepare_fused_nerf(model, torch.bfloat16)
    with torch.no_grad():
        for num_samples in samples:
            pos, d, t = _rays(rng, num_rays, num_samples, device)
            ref = caster.render(RaySamples(pos, d[:, None].expand(pos.shape),
                                           t, None))
            out = fused_ray_render(w32, pos, d, t)
            report.check(f"fused_ray_render S={num_samples} color",
                         out[:, :3], ref.color, 5e-3)
            report.check(f"fused_ray_render S={num_samples} alpha",
                         out[:, 3], ref.alpha, 5e-3)
            report.check(f"fused_ray_render bf16 S={num_samples} vs twin",
                         fused_ray_render(wbf, pos, d, t),
                         fused_ray_render_reference(wbf, pos, d, t), 0.05)


def check_scan(report: Report, rng: np.random.Generator, device,
               lanes=SCAN_LANES, rtol: float = 1e-5):
    """T1: the scan kernel against the plain exclusive cumprod."""
    for count in lanes:
        x = torch.from_numpy(rng.uniform(0.5, 1.0, (16, count)).astype(
            np.float32)).to(device)
        out = exclusive_cumprod_scan(x)
        ref = exclusive_cumprod(x)
        err = float(((out - ref).abs() / ref.abs()).max())
        report.line(err <= rtol, f"exclusive_cumprod_scan lanes={count}: "
                                 f"max rel err {err:.2e} (rtol {rtol:g})")


def check_mesh(report: Report, device):
    """The JAX tool's mesh checks on a 2x32 NeRF and its 24 px synthetic
    scene: a fused data-parallel train step (3 steps a call) against
    the plain one from the same weights, and a fused frame under the
    mesh against the same frame without it."""
    import tempfile

    from ..datasets import ImageDataset
    from ..datasets.synthetic import load_or_generate
    from ..parallel import make_shard_map_train_step
    from .common import data_parallel_mesh

    start = time.perf_counter()
    mesh = data_parallel_mesh(device)
    print(f"mesh: {mesh}", file=sys.stderr)
    with tempfile.TemporaryDirectory() as root:
        path = f"{root}/scene.npz"
        if mesh.is_primary:
            load_or_generate(path, resolution=24, device=mesh.device)
        mesh.barrier()
        scene = ImageDataset.load(path, "train", 16, device=mesh.device)
        mesh.barrier()

    def make_model():
        return NeRF(num_layers=2, num_channels=32, max_log_scale_pos=3.0,
                    num_freq_pos=4, max_log_scale_view=1.0, num_freq_view=2,
                    skips=[1], include_inputs=True,
                    generator=torch.Generator().manual_seed(0)).to(
                        mesh.device)

    idx = torch.from_numpy(scene.index_pool()[:128]).to(mesh.device)
    losses = {}
    for fused in (True, False):
        caster = Raycaster(make_model(), fused_train=fused)
        step = make_shard_map_train_step(caster, scene, 128, 5e-4, 0.1,
                                         250000, 0.0, mesh, fused=fused,
                                         steps_per_call=3)
        losses[fused] = float(step(idx, 0, 0, 0))
    report.check("shard_map fused train step (mesh) loss", losses[True],
                 losses[False], 1e-3)

    caster = Raycaster(make_model(), fused=True)
    frame_mesh = caster.render_frame(scene.sampler, 0, chunk_size=2048,
                                     mesh=mesh)
    frame_one = caster.render_frame(scene.sampler, 0, chunk_size=2048)
    report.check("render_frame fused under mesh (uint8)", frame_mesh,
                 frame_one, 1.0)
    print(f"  (fused-under-mesh run {time.perf_counter() - start:.1f}s)",
          file=sys.stderr)


def main(argv=None) -> int:
    parser = ArgumentParser("Validates the port's Hopper kernels against "
                            "plain PyTorch")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (their plain twins)")
    args = parser.parse_args(argv)
    device = kernel_device("validate_kernels", args.device,
                           "so no kernel is checked")
    if device is None:
        return 2
    report = Report()
    rng = np.random.default_rng(0)
    for label, make in CONFIGS:
        start = time.perf_counter()
        model = make()
        check_forward(report, label, model, rng, device)
        check_train(report, label, model, rng, device)
        print(f"  (build+run {time.perf_counter() - start:.1f}s)",
              file=sys.stderr)
    check_ray_render(report, rng, device)
    check_scan(report, rng, device)
    check_mesh(report, device)
    print("ALL OK" if report.ok else "FAILURES — see above")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
