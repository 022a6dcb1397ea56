"""CLI: what moving the fused NeRF forward's data costs, on the card.

Port of ``tools/kernel_io_floor_bench.py``, at its size (16384 rays x
48 samples = 786,432 points), 20 timed launches a row between CUDA
events after a warm-up:

* the model sweep: the fused NeRF forward (``fused_nerf_apply``, K1) in
  bf16 on seeded random NeRFs of 8x256 f10/4, 4x128 f10/4, 4x128 f6/2
  and 2x64 f10/4 (``skips=[max(1, layers // 2)]``, raw inputs), each
  first held against its plain twin (atol 0.05);
* the tool's ``kernel-fm`` rows: one line, since the port has one
  layout and those rows are the model sweep's;
* the copy kernels (``kernels/io_floor.py``): ``io-narrow`` at tiles of
  2048 and 4096 rows, ``io-wide`` and ``packed8``, each first held
  bit-exact against its plain twin. ``io-wide`` takes no tile: its
  blocks move 4 KB each.

Rows print in the tool's format, ``{label:18s}: {ms:7.2f} ms
({Mrows:6.1f} Mrows/s)``, or ``FAILED`` and the run goes on. Exits 1 if
any row failed, 2 without a card on ``--device cuda`` (the default), 0
otherwise. ``--device cpu`` runs the plain twins; ``--rays`` and
``--samples`` cut the size for the CPU tests and default to the tool's.

    python -m fourier_feature_nets_torch.cli.kernel_io_floor_bench
"""

import sys
from argparse import ArgumentParser

import numpy as np
import torch

from ..kernels.fused_nerf import (
    fused_nerf_apply,
    fused_nerf_reference,
    prepare_fused_nerf,
)
from ..kernels.io_floor import (
    io_narrow,
    io_narrow_reference,
    io_wide,
    io_wide_reference,
    packed8,
    packed8_reference,
)
from ..models import NeRF
from .common import bench_ms, kernel_device

SWEEP = ((8, 256, 10, 4), (4, 128, 10, 4), (4, 128, 6, 2), (2, 64, 10, 4))
BF16_ATOL = 0.05   # tests/test_fused_nerf.py:64


def sweep_config(layers: int, channels: int, fpos: int, fview: int) -> dict:
    """The NeRF arguments of a sweep row, as the tool builds them."""
    return dict(num_layers=layers, num_channels=channels,
                max_log_scale_pos=9.0, num_freq_pos=fpos,
                max_log_scale_view=3.0, num_freq_view=fview,
                skips=[max(1, layers // 2)], include_inputs=True)


def sweep_model(layers: int, channels: int, fpos: int, fview: int) -> NeRF:
    """The tool's model of a sweep row, with seeded random weights."""
    return NeRF(**sweep_config(layers, channels, fpos, fview),
                generator=torch.Generator().manual_seed(0))


def io_inputs(n: int, device):
    """Normal positions, unit normal views, and the tool's packed
    [pos | views | 0, 0] and zero (n, 128) inputs, from a seed."""
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    views = rng.normal(size=(n, 3)).astype(np.float32)
    views /= np.linalg.norm(views, axis=-1, keepdims=True)
    packed = np.concatenate([pos, views, np.zeros((n, 2), np.float32)], -1)
    return (torch.from_numpy(pos).to(device),
            torch.from_numpy(views).to(device),
            torch.from_numpy(packed).to(device),
            torch.zeros((n, 128), dtype=torch.float32, device=device))


class Rows:
    """Checks, times and prints one row at a time; remembers failures."""

    def __init__(self, n: int, reps: int, device):
        self.n, self.reps, self.device = n, reps, device
        self.failed = False

    def run(self, label, fn, twin, atol=0.0):
        try:
            with torch.no_grad():
                out, ref = fn(), twin()
                err = (out - ref).abs().max().item()
                exact = atol > 0 or torch.equal(out.view(torch.int32),
                                                ref.view(torch.int32))
                if not (err <= atol and exact):
                    raise AssertionError(f"max abs err {err:.3e} against "
                                         f"its plain twin (atol {atol:g})")
                dt = bench_ms(fn, self.reps, self.device) / 1e3
            print(f"{label:18s}: {dt * 1e3:7.2f} ms "
                  f"({self.n / dt / 1e6:6.1f} Mrows/s)")
        except Exception as exc:
            print(f"{label:18s}: FAILED {type(exc).__name__}: "
                  f"{str(exc)[:100]}")
            self.failed = True


def main(argv=None) -> int:
    parser = ArgumentParser("Times the fused NeRF forward across model "
                            "sizes against pure copy kernels")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (their plain twins)")
    parser.add_argument("--rays", type=int, default=16384)
    parser.add_argument("--samples", type=int, default=48)
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    device = kernel_device("kernel_io_floor_bench", args.device,
                           "so every time printed is a twin's")
    if device is None:
        return 2
    n = args.rays * args.samples
    pos, views, packed, wide = io_inputs(n, device)
    rows = Rows(n, args.reps, device)

    for layers, channels, fpos, fview in SWEEP:
        model = sweep_model(layers, channels, fpos, fview).to(device)
        weights = prepare_fused_nerf(model, torch.bfloat16)
        rows.run(f"kernel {layers}x{channels} f{fpos}/{fview}",
                 lambda: fused_nerf_apply(weights, pos, views),
                 lambda: fused_nerf_reference(weights, pos, views),
                 atol=BF16_ATOL)
    print(f"{'kernel-fm':18s}: the port has one layout; these rows are "
          f"the kernel rows above")

    for tile in (2048, 4096):
        rows.run(f"io-narrow t{tile}", lambda: io_narrow(pos, views, tile),
                 lambda: io_narrow_reference(pos, views))
    rows.run("io-wide", lambda: io_wide(wide), lambda: io_wide_reference(wide))
    rows.run("packed8", lambda: packed8(packed),
             lambda: packed8_reference(packed))
    return 1 if rows.failed else 0


if __name__ == "__main__":
    sys.exit(main())
