"""CLI: the int8 tensor-core probe on the card.

Port of ``tools/int8_probe.py``, with its stages, shapes and seeds:

1. P1a, an int8 (128, 128) @ int8 (128, 256) -> int32 kernel, runs;
2. its result equals NumPy's int32 product exactly;
2b. P1b, quantize + int8 product + dequantize in one kernel, against
   the tool's NumPy reference (max rel err; more than 1e-6 fails);
3. P1c, eight chained (192, 192) @ (192, 2048) layers in bf16 and in
   int8, each timed over 200 back-to-back launches between CUDA events
   after a warm-up (the tool timed a 200-step ``lax.scan``), and the
   int8/bf16 ratio.

Each stage prints its line in the JAX tool's format. A failed stage
prints ``FAIL`` and exits 1 (the JAX tool returned 0); all stages
passing exits 0; ``--device cuda`` (the default) without a card exits
2. ``--device cpu`` runs the kernels' plain twins. ``--columns`` and
``--steps`` cut stage 3 for the CPU tests; they default to the tool's.

    python -m fourier_feature_nets_torch.cli.int8_probe
"""

import sys
from argparse import ArgumentParser

import numpy as np
import torch

from ..kernels.int8_probe import int8_matmul, layer_stack, quantized_matmul
from .common import bench_ms, kernel_device

CHANNELS = 192   # stage 3: Co = Ci, the student kernel's width
LAYERS = 8


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stage3_inputs(rng: np.random.Generator, dtype, columns: int, device):
    """The tool's chain: LAYERS weights in [-5, 5], then h0 in [0, 5],
    as integers drawn in that order, cast to ``dtype``; (L, C, C) and
    (C, columns) on ``device``."""
    ws = np.stack([rng.integers(-5, 6, (CHANNELS, CHANNELS))
                   for _ in range(LAYERS)])
    h0 = rng.integers(0, 6, (CHANNELS, columns))
    return (torch.from_numpy(ws).to(device, dtype),
            torch.from_numpy(h0).to(device, dtype))


def main(argv=None) -> int:
    parser = ArgumentParser("Probes int8 tensor-core products against bf16")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (their plain twins)")
    parser.add_argument("--columns", type=int, default=2048,
                        help="stage 3 columns of h (the tool's tile)")
    parser.add_argument("--steps", type=int, default=200,
                        help="stage 3 timed launches")
    args = parser.parse_args(argv)
    device = kernel_device("int8_probe", args.device,
                           "so every time printed is a twin's")
    if device is None:
        return 2

    # --- stage 1 + 2: int8 dot kernel, exact numerics ---
    co, ci, t = 128, 128, 256
    rng = np.random.default_rng(0)
    w = rng.integers(-127, 128, (co, ci), dtype=np.int8)
    h = rng.integers(-127, 128, (ci, t), dtype=np.int8)
    w_t = torch.from_numpy(w).to(device)
    try:
        out = int8_matmul(w_t, torch.from_numpy(h).to(device))
        _sync(device)
        out = out.cpu().numpy()
    except Exception as error:
        print(f"stage1 FAIL: int8 dot kernel did not compile/run: "
              f"{str(error)[:500]}")
        return 1
    print("stage1 OK: int8 dot kernel compiled and ran")

    ref = w.astype(np.int32) @ h.astype(np.int32)
    if not np.array_equal(out, ref):
        bad = np.abs(out.astype(np.int64) - ref).max()
        print(f"stage2 FAIL: numerics off, max abs err {bad}")
        return 1
    print("stage2 OK: exact int32 numerics")

    # --- stage 2b: quantize + dot + dequantize in one kernel ---
    try:
        xf = rng.normal(size=(ci, t)).astype(np.float32)
        outq = quantized_matmul(torch.from_numpy(xf).to(device), w_t)
        _sync(device)
        outq = outq.cpu().numpy()
    except Exception as error:
        print(f"stage2b FAIL: quantize ops inside kernel: {str(error)[:500]}")
        return 1
    scale = np.abs(xf).max() / 127.0 + 1e-30
    qref = np.round(xf / scale).astype(np.int8)
    reff = (w.astype(np.int32) @ qref.astype(np.int32)).astype(
        np.float32) * scale
    rel = np.abs(outq - reff).max() / (np.abs(reff).max() + 1e-30)
    if not rel <= 1e-6:
        print(f"stage2b FAIL: quantize+dot+dequant kernel, max rel err vs "
              f"numpy {rel:.2e} (limit 1e-6)")
        return 1
    print(f"stage2b OK: quantize+dot+dequant kernel runs, "
          f"max rel err vs numpy {rel:.2e}")

    # --- stage 3: throughput, int8 vs bf16 ---
    ops = 2 * CHANNELS * CHANNELS * args.columns * LAYERS
    times = {}
    try:
        for dtype, name in ((torch.bfloat16, "bf16"), (torch.int8, "int8")):
            ws, h0 = stage3_inputs(rng, dtype, args.columns, device)
            dt = bench_ms(lambda: layer_stack(h0, ws), args.steps,
                          device) / 1e3
            times[name] = dt
            print(f"stage3 {name}: {dt * 1e6:.1f} us/call, "
                  f"{ops / dt / 1e12:.2f} T(op)/s")
    except Exception as error:
        print(f"stage3 FAIL: {str(error)[:500]}")
        return 1
    print(f"stage3 ratio: int8 is {times['bf16'] / times['int8']:.2f}x bf16")
    return 0


if __name__ == "__main__":
    sys.exit(main())
