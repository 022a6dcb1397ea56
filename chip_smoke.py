"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds
it against its plain PyTorch twin at the flagship width, renders three
800x800 ``--preset fast`` frames through the port's ``orbit_video`` CLI
with a seeded random flagship NeRF, checks that the frames went through
the kernel, and compares a low-resolution fused render with the plain
render. Each phase prints its own lines; any failure raises and the
script exits non-zero without printing a result. The last two lines are
the per-kernel JSON record and ``{"ok": true, "device": ...}``.

Needs one CUDA device; on a machine without one it exits with code 2.
Outputs go to ``smoke_out/`` inside the checkout.
"""

import json
import os
import struct
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "smoke_out")
BENCH_POINTS = 16384 * 128     # bench.py's render batch: rays x samples
CHUNK_POINTS = 16384 * 48      # one --preset fast frame chunk: rays x samples
RAGGED_POINTS = 100_003        # not a multiple of the kernel's 64-point tile
F32_RTOL, F32_ATOL = 1e-3, 2e-4   # tests/test_fused_nerf.py:44
BF16_ATOL = 0.05                  # tests/test_fused_nerf.py:64
SEED = 0


def log(message: str) -> None:
    print(message, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call from CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def random_points(num: int, rng: np.random.Generator, device):
    positions = rng.uniform(-1.0, 1.0, (num, 3)).astype(np.float32)
    views = rng.normal(size=(num, 3)).astype(np.float32)
    views /= np.linalg.norm(views, axis=-1, keepdims=True)
    return (torch.from_numpy(positions).to(device),
            torch.from_numpy(views).to(device))


def png_shape(path: str):
    """(height, width, channels) and the largest pixel value of an
    8-bit RGB PNG, with the pixel data decompressed to check it is
    complete."""
    with open(path, "rb") as handle:
        data = handle.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path} is not a PNG")
    width, height, depth, color = struct.unpack(">IIBB", data[16:26])
    if (depth, color) != (8, 2):
        raise AssertionError(f"{path} is not 8-bit RGB")
    channels = 3
    idat, pos = b"", 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    raw = zlib.decompress(idat)
    if len(raw) != height * (1 + width * channels):
        raise AssertionError(f"{path}: unexpected PNG payload")
    rows = np.frombuffer(raw, np.uint8).reshape(height, 1 + width * channels)
    return (height, width, channels), int(rows[:, 1:].max())


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(f"device: {name}, count {torch.cuda.device_count()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    from fourier_feature_nets_torch.kernels.fused_nerf import load_kernel
    start = time.perf_counter()
    built = load_kernel()
    log(f"kernel build: {built.path.name}, nvcc {built.seconds:.3f} s, "
        f"load {time.perf_counter() - start:.3f} s")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  {line.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    return name


def phase_kernel_vs_twin(model):
    """K1 against its plain twin at the bench shape, the main path's
    chunk shape and a ragged N."""
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        fused_nerf_apply, fused_nerf_reference, prepare_fused_nerf)
    log("kernel vs plain twin: torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} (the twin's f32 GEMMs "
        "are full f32)")
    rng = np.random.default_rng(SEED)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        weights = prepare_fused_nerf(model, dtype)
        for num in (BENCH_POINTS, CHUNK_POINTS, RAGGED_POINTS):
            positions, views = random_points(num, rng, "cuda")
            with torch.no_grad():
                ref = fused_nerf_reference(weights, positions, views)
                out = fused_nerf_apply(weights, positions, views)
            torch.cuda.synchronize()
            if out.shape != (num, 4) or not torch.isfinite(out).all():
                raise AssertionError(f"kernel output not finite (N={num})")
            err = (out - ref).abs()
            max_abs = err.max().item()
            max_rel = (err / ref.abs().clamp(min=1e-3)).max().item()
            if dtype == torch.float32:
                bound = F32_ATOL + F32_RTOL * ref.abs()
                ok = bool((err <= bound).all())
                stated = f"|d| <= {F32_ATOL} + {F32_RTOL}|ref|"
            else:
                ok = max_abs <= BF16_ATOL
                stated = f"|d| <= {BF16_ATOL}"
            log(f"  {str(dtype)[6:]:8s} N={num:>9,d}: max abs err "
                f"{max_abs:.3e}, max rel err {max_rel:.3e} "
                f"(tolerance {stated}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("kernel disagrees with its plain twin")
            if num == BENCH_POINTS:
                with torch.no_grad():
                    kernel_ms = cuda_ms(
                        lambda: fused_nerf_apply(weights, positions, views),
                        5)
                    plain_ms = cuda_ms(
                        lambda: fused_nerf_reference(weights, positions,
                                                     views), 5)
                log(f"  {str(dtype)[6:]:8s} N={num:>9,d}: kernel "
                    f"{kernel_ms:.3f} ms, plain twin {plain_ms:.3f} ms "
                    f"(CUDA events, mean of 5)")
                results[dtype] = (max_abs, kernel_ms, plain_ms)
            del positions, views, ref, out, err
        del weights
        torch.cuda.empty_cache()
    return results


def phase_orbit(model):
    """The main path: the port's orbit_video CLI, --preset fast."""
    from fourier_feature_nets_torch.cli import orbit_video
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        fused_nerf_apply)
    from fourier_feature_nets_torch.models import save_model

    os.makedirs(OUT_DIR, exist_ok=True)
    checkpoint = os.path.join(OUT_DIR, "flagship_seed0.npz")
    save_model(model, checkpoint)
    frames_dir = os.path.join(OUT_DIR, "frames")
    for name in os.listdir(frames_dir) if os.path.isdir(frames_dir) else ():
        os.remove(os.path.join(frames_dir, name))
    fused_nerf_apply.launches = 0
    start = time.perf_counter()
    rc = orbit_video.main([checkpoint, "800", frames_dir, "--preset", "fast",
                           "--num-frames", "3"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = fused_nerf_apply.launches
    if rc != 0:
        raise AssertionError(f"orbit_video returned {rc}")
    names = sorted(os.listdir(frames_dir))
    if names != [f"frame_{i:05d}.png" for i in range(3)]:
        raise AssertionError(f"unexpected frames: {names}")
    for name in names:
        shape, peak = png_shape(os.path.join(frames_dir, name))
        if shape != (800, 800, 3) or peak == 0:
            raise AssertionError(f"{name}: shape {shape}, max pixel {peak}")
    log(f"orbit_video --preset fast: 3 PNG frames of 800x800, "
        f"{wall:.3f} s for the whole CLI call (checkpoint load, density "
        f"grid, weight pack, 3 frames, PNG writes), K1 launches {launches}")
    if launches <= 0:
        raise AssertionError("the main path did not launch the kernel")
    return launches


def phase_fused_vs_plain(model):
    """One low-resolution frame through the kernel and through the
    plain PyTorch model in the same dtype."""
    from fourier_feature_nets_torch.cameras import Resolution
    from fourier_feature_nets_torch.render import (OccupancyGridSampler,
                                                   Raycaster)
    from fourier_feature_nets_torch.utils import orbit

    cameras = orbit(np.array([0, 1, 0], np.float32),
                    np.array([0, 0, -1], np.float32), 4, 40,
                    Resolution(96, 96), 4.0)
    bounds = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
    sampler = OccupancyGridSampler.from_model(model, cameras, 48,
                                              bounds=bounds)
    for dtype in (torch.bfloat16, None):
        fused = Raycaster(model, compute_dtype=dtype, fused=True)
        plain = Raycaster(model, compute_dtype=dtype, fused=False)
        a = fused.render_frame(sampler, 1).astype(np.int32)
        b = plain.render_frame(sampler, 1).astype(np.int32)
        diff = np.abs(a - b)
        share = float((diff <= 1).mean())
        name = "bfloat16" if dtype is not None else "float32"
        log(f"fused vs plain render, 96x96, 48 samples, {name}: "
            f"{share:.6f} of uint8 values within +-1, max diff "
            f"{int(diff.max())}")
        if a.shape != (96, 96, 3) or share < 0.999:
            raise AssertionError("fused render disagrees with plain render")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on a GPU only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from fourier_feature_nets_torch.models import flagship_nerf

    name = phase_device()
    model = flagship_nerf(torch.Generator().manual_seed(SEED)).cuda()
    results = phase_kernel_vs_twin(model)
    launches = phase_orbit(model)
    phase_fused_vs_plain(model)

    bf16 = results[torch.bfloat16]
    f32 = results[torch.float32]
    print(json.dumps({"kernels": [{
        "name": "fused_nerf",
        "route": "cuda",
        "source": "fourier_feature_nets_torch/kernels/csrc/fused_nerf.cu",
        "replaces": "fourier_feature_nets_tpu/ops/fused_nerf.py:323",
        "launches": launches,
        "max_abs_err": bf16[0],
        "ms": bf16[1],
        "plain_ms": bf16[2],
        "f32_max_abs_err": f32[0],
        "f32_ms": f32[1],
        "f32_plain_ms": f32[2],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
