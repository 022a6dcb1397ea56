"""CLI: the fused NeRF forward's ablations, timed on the card.

Port of ``tools/kernel_ablation_bench.py``: the flagship NeRF in bf16
(seeded random weights), 16384 rays x 32 samples from the origin with
depths ``linspace(1, 4, 32)`` along unit directions, through the
ablation kernel (``kernels/fused_nerf_ablation.py``) in the five modes
the tool runs: ``base``, ``no-view``, ``no-bias``, ``no-relu``,
``matmul-only``. Each mode is first held against its plain twin (bf16
atol 0.05, the fused forward's tolerance), then timed over 20
back-to-back launches between CUDA events after a warm-up, and prints
``{mode:12s}: {ms:8.2f} ms ({Mpts:6.1f} Mpts/s)`` as the tool does, or
``FAILED`` and goes on. Exits 1 if any mode failed, 2 without a card on
``--device cuda`` (the default), 0 otherwise. ``--device cpu`` runs the
plain twins; ``--rays`` and ``--samples`` cut the size for the CPU
tests and default to the tool's.

The tool's ``tile=2048`` has no counterpart: each mode runs K1's own
kernel (bf16: the persistent wgmma kernel, 128-point tiles) with the
mode a compile-time policy, and ``base`` is K1's launch, so the five
lines split K1's time: each mode's ms minus base's is what its part of
K1 costs. Its ``bf16-accum`` and ``no-sincos`` modes, which the tool
defines but its run never selects, are ported (``ALL_MODES``) and run
by ``chip_smoke.py``; this CLI prints the five the tool runs.

    python -m fourier_feature_nets_torch.cli.kernel_ablation_bench
"""

import sys
from argparse import ArgumentParser

import numpy as np
import torch

from ..kernels.fused_nerf import prepare_fused_nerf
from ..kernels.fused_nerf_ablation import (
    MODES,
    fused_nerf_ablation,
    fused_nerf_ablation_reference,
)
from ..models import flagship_nerf
from .common import bench_ms, kernel_device

BF16_ATOL = 0.05   # tests/test_fused_nerf.py:64


def ablation_inputs(rays: int, samples: int, device):
    """The tool's points: origin at zero, depths linspace(1, 4, samples),
    unit directions from a seeded normal; (rays * samples, 3) positions
    and views."""
    t = np.linspace(1.0, 4.0, samples, dtype=np.float32)
    d = np.random.default_rng(0).normal(size=(rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pos = (t[None, :, None] * d[:, None, :]).reshape(-1, 3)
    views = np.broadcast_to(d[:, None], (rays, samples, 3)).reshape(-1, 3)
    return (torch.from_numpy(np.ascontiguousarray(pos)).to(device),
            torch.from_numpy(np.ascontiguousarray(views)).to(device))


def main(argv=None) -> int:
    parser = ArgumentParser("Times the fused NeRF forward's ablations")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernel) or cpu (its plain twin)")
    parser.add_argument("--rays", type=int, default=16384)
    parser.add_argument("--samples", type=int, default=32)
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    device = kernel_device("kernel_ablation_bench", args.device,
                           "so every time printed is a twin's")
    if device is None:
        return 2
    model = flagship_nerf(torch.Generator().manual_seed(0)).to(device)
    weights = prepare_fused_nerf(model, torch.bfloat16)
    pos, views = ablation_inputs(args.rays, args.samples, device)
    n = pos.shape[0]
    print("tile: the JAX tool's tile=2048 has no counterpart here; the "
          "kernel is K1's own, on 128-point tiles")
    failed = False
    for mode in MODES:
        try:
            with torch.no_grad():
                out = fused_nerf_ablation(weights, pos, views, mode)
                twin = fused_nerf_ablation_reference(weights, pos, views,
                                                     mode)
                err = (out - twin).abs().max().item()
                if not err <= BF16_ATOL:
                    raise AssertionError(f"max abs err {err:.3e} against its "
                                         f"plain twin (atol {BF16_ATOL})")
                dt = bench_ms(lambda: fused_nerf_ablation(weights, pos,
                                                          views, mode),
                              args.reps, device) / 1e3
            print(f"{mode:12s}: {dt * 1e3:8.2f} ms "
                  f"({n / dt / 1e6:6.1f} Mpts/s)")
        except Exception as e:
            print(f"{mode:12s}: FAILED {str(e)[:140]}")
            failed = True
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
