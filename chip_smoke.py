"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1, the fused NeRF forward; K2, the
fused recompute backward) from the sources in this checkout, in
parallel, and drives both paths of the port at the flagship width:

* serving: K1 against its plain twin; three 800x800 ``--preset fast``
  frames of a seeded random flagship NeRF through ``orbit_video``,
  which must go through K1; a low-resolution fused render against the
  plain render;
* training: K2 against its plain twin in bf16 and f32 at the CLI batch
  (1024 rays x 128 samples) and a ragged N; 30 steps of ``train_nerf``
  on the generated ``synthetic`` scene in bf16 and f32, fused (through
  K1 and K2, which must both launch) and ``--no-fused``; the trained
  checkpoint then renders an 800x800 frame through ``orbit_video``.

Each phase prints its own lines; any failure raises and the script
exits non-zero without printing a result. The last two lines are the
per-kernel JSON record and ``{"ok": true, "device": ...}``.

Needs one CUDA device; on a machine without one it exits with code 2.
Outputs go to ``smoke_out/`` inside the checkout.
"""

import concurrent.futures
import contextlib
import io
import json
import os
import re
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
TRAIN_POINTS = 1024 * 128      # train_nerf's default batch: rays x samples
F32_RTOL, F32_ATOL = 1e-3, 2e-4   # tests/test_fused_nerf.py:44
BF16_ATOL = 0.05                  # tests/test_fused_nerf.py:64
# K2 vs its twin, per gradient leaf and cotangent: max|kernel - twin| <=
# GRAD_SHARE * max|twin|. Readings at the flagship on an H100 80GB HBM3 at
# 700 W, N = 131,072 / 100,003 (bf16; f32):
# * random: N(0, 1); each gradient is a cancelling sum that grows like
#   sqrt(N), so a few terms that differ stand out. (1.03e-2 / 6.98e-3;
#   7.13e-3 / 1.04e-2.) In f32 they are ReLU-mask flips: K2 and the twin
#   sum each pre-activation in another order, and one within rounding of 0
#   takes the other side of the mask in each; zeroing the cotangent of the
#   180 points within 1e-7 of a boundary takes 1.04e-2 to 5.6e-6, zeroing
#   180 other points leaves it at 1.04e-2. In bf16 they are activations one
#   bf16 step apart: K2 sums on the tensor cores, the twin in f32 FMAs, and
#   a twin whose forward products run on the tensor cores (cuBLAS) sits
#   6.4e-3 from the plain twin, as K2 does.
# * margin (f32): random with the cotangent zeroed on the ~2% of points that
#   have a pre-activation within MARGIN of 0 (relu_margin); with the flips
#   gone, what is left is rounding. (5.7e-6 / 5.3e-6.)
# * same-sign: all ones, so the sums do not cancel. (6.5e-5 / 8.1e-5;
#   5.8e-5 / 3.1e-5.)
# * tail: random on the last GROUP points (at N = 100,003 the ragged last
#   tile, 3 points) and on one other GROUP, zero elsewhere: those points make
#   up the whole gradient, so a dropped or mis-masked tile cannot hide.
#   (2.4e-3 / 7.7e-4; 6.9e-7 / 6.6e-7.)
# At N = 100,003, a K2 that skips the ragged tile, drops its last point's
# cotangent, or rounds f32 dz to bf16 fails tail (>= 0.14; >= 6.0e-3) and
# the f32 margin check (>= 3.3e-3), and passes random and same-sign.
GRAD_SHARE = {"random": {"bfloat16": 2e-2, "float32": 2e-2},
              "margin": {"float32": 5e-5},
              "same-sign": {"bfloat16": 2e-3, "float32": 3e-4},
              "tail": {"bfloat16": 1e-2, "float32": 2e-5}}
MARGIN = {"float32": 1e-6}
GROUP = 32    # K2's bf16 tile, two of its f32 tiles
TRAIN_STEPS = 30
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
    from fourier_feature_nets_torch.kernels import fused_nerf, fused_nerf_train
    start = time.perf_counter()
    # one nvcc per source, all started together
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        builds = list(pool.map(lambda module: module.load_kernel(),
                               (fused_nerf, fused_nerf_train)))
    log(f"kernel builds (in parallel): {time.perf_counter() - start:.3f} s")
    for built in builds:
        log(f"  {built.path.name}: nvcc {built.seconds:.3f} s")
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")
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


def backward_cotangents(weights, positions, views, rng):
    """The (N, 4) cotangents K2 is held to its twin with, by name (see
    GRAD_SHARE)."""
    from fourier_feature_nets_torch.kernels.fused_nerf_train import (
        relu_margin)
    num = positions.shape[0]
    random = torch.from_numpy(rng.normal(size=(num, 4)).astype(
        np.float32)).to(positions.device)
    tail = torch.zeros_like(random)
    last = num % GROUP or GROUP
    mid = num // GROUP // 2 * GROUP
    tail[num - last:] = random[num - last:]
    tail[mid:mid + GROUP] = random[mid:mid + GROUP]
    gs = {"random": random, "same-sign": torch.ones_like(random),
          "tail": tail}
    name = str(weights.weights.dtype)[6:]
    if name in MARGIN:
        far = relu_margin(weights, positions, views) >= MARGIN[name]
        gs["margin"] = torch.where(far[:, None], random, 0.0)
    return gs


def backward_errors(weights, positions, views, g):
    """[(leaf, max|kernel - twin|, that over max|twin|)] of K2 against
    its twin for the cotangent g; raises if the kernel gives a value
    that is not finite."""
    from fourier_feature_nets_torch.kernels.fused_nerf_train import (
        fused_nerf_backward, fused_nerf_backward_reference)
    out = fused_nerf_backward(weights, positions, views, g)
    twin = fused_nerf_backward_reference(weights, positions, views, g)
    rows = []
    for (leaf, a), (_, b) in zip(weights.split_flat(*out),
                                 weights.split_flat(*twin)):
        if not torch.isfinite(a).all():
            raise AssertionError(f"K2 {leaf}: not finite")
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        rows.append((leaf, err, err / scale if scale > 0 else err))
    return rows


def phase_backward_vs_twin(model):
    """K2 against its plain twin at the CLI batch and a ragged N, under
    each cotangent of backward_cotangents."""
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        prepare_fused_nerf)
    from fourier_feature_nets_torch.kernels.fused_nerf_train import (
        fused_nerf_backward, fused_nerf_backward_reference)
    rng = np.random.default_rng(SEED + 1)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        log(f"  {name}: per leaf, max abs err / max rel err (max|d| / "
            f"max|twin|) under each cotangent; tolerance on the rel err: "
            + ", ".join(f"{k} {v[name]:g}" for k, v in GRAD_SHARE.items()
                        if name in v))
        weights = prepare_fused_nerf(model, dtype)
        for num in (TRAIN_POINTS, RAGGED_POINTS):
            positions, views = random_points(num, rng, "cuda")
            gs = backward_cotangents(weights, positions, views, rng)
            log(f"  {name:8s} N={num:>7,d}: tail cotangent on "
                f"{int(torch.count_nonzero(gs['tail'][:, 0]))} points"
                + (f"; margin cotangent zero on the "
                   f"{num - int(torch.count_nonzero(gs['margin'][:, 0])):,d} "
                   f"points within {MARGIN[name]:g} of a ReLU boundary"
                   if "margin" in gs else ""))
            table = {key: backward_errors(weights, positions, views, g)
                     for key, g in gs.items()}
            failed = []
            for row in range(len(table["random"])):
                cells = []
                for key, rows in table.items():
                    leaf, err, rel = rows[row]
                    bad = rel > GRAD_SHARE[key][name]
                    if bad:
                        failed.append(f"{key} {leaf}")
                    cells.append(f"{key} {err:.3e}/{rel:.3e}"
                                 + (" FAIL" if bad else ""))
                log(f"  {name:8s} N={num:>7,d} {leaf:>3s}: "
                    + ", ".join(cells))
            if failed:
                raise AssertionError(f"K2 {name} N={num} disagrees with its "
                                     f"plain twin: {failed}")
            g = gs["random"]
            out = fused_nerf_backward(weights, positions, views, g)
            again = fused_nerf_backward(weights, positions, views, g)
            torch.cuda.synchronize()
            bitwise = all(torch.equal(a, b) for a, b in zip(out, again))
            log(f"  {name:8s} N={num:>7,d}: two kernel calls bitwise equal: "
                f"{bitwise}")
            if num == TRAIN_POINTS:
                kernel_ms = cuda_ms(lambda: fused_nerf_backward(
                    weights, positions, views, g), 5)
                plain_ms = cuda_ms(lambda: fused_nerf_backward_reference(
                    weights, positions, views, g), 5)
                log(f"  {name:8s} N={num:>7,d}: K2 {kernel_ms:.3f} ms, plain "
                    f"twin {plain_ms:.3f} ms (CUDA events, mean of 5)")
                results[name] = {
                    "max_abs_err": max(r[1] for r in table["random"]),
                    "max_rel_err": {key: max(r[2] for r in rows)
                                    for key, rows in table.items()},
                    "ms": kernel_ms, "plain_ms": plain_ms,
                    "bitwise_equal": bitwise}
            del positions, views, gs, g, out, again
        del weights
        torch.cuda.empty_cache()
    return results


def _read_log(path):
    """(step, train PSNR, val PSNR) rows of a train_nerf log.txt."""
    with open(path) as handle:
        lines = handle.read().split("\n\n", 1)[1].strip().splitlines()
    rows = [line.split("\t") for line in lines[1:]]
    return [(int(r[0]), float(r[2]), float(r[3])) for r in rows]


def phase_train():
    """The training path: train_nerf on the generated synthetic scene,
    fused (K1 + K2) and --no-fused, in bf16 and the f32 default."""
    from fourier_feature_nets_torch.cli import train_nerf
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        fused_nerf_apply)
    from fourier_feature_nets_torch.kernels.fused_nerf_train import (
        fused_nerf_backward)
    os.environ["FFN_TORCH_DATA_DIR"] = os.path.join(OUT_DIR, "data")
    step_ms, launches, checkpoint = {}, {"fused_nerf": 0,
                                         "fused_nerf_train": 0}, None
    for dtype in ("bfloat16", "float32"):
        for fused in (True, False):
            label = f"{dtype}, {'fused' if fused else 'plain'}"
            results = os.path.join(OUT_DIR, "train",
                                   f"{dtype}_{'fused' if fused else 'plain'}")
            argv = ["synthetic", results, "--num-steps", str(TRAIN_STEPS),
                    "--report-interval", "10", "--compute-dtype", dtype]
            if not fused:
                argv.append("--no-fused")
            fused_nerf_apply.launches = 0
            fused_nerf_backward.launches = 0
            captured = io.StringIO()
            start = time.perf_counter()
            with contextlib.redirect_stdout(captured):
                rc = train_nerf.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            k1, k2 = fused_nerf_apply.launches, fused_nerf_backward.launches
            output = captured.getvalue()
            log("\n".join(f"    {line}" for line in output.splitlines()))
            if rc != 0:
                raise AssertionError(f"train_nerf ({label}) returned {rc}")
            summary = re.search(r"([0-9.]+) ms/step over steps 2", output)
            step_ms[label] = float(summary.group(1))
            rows = _read_log(os.path.join(results, "log.txt"))
            psnrs = [p for row in rows for p in row[1:]]
            for name in ("nerf.npz", "log.txt",
                         os.path.join("train", "s0000000_c000.png")):
                if not os.path.exists(os.path.join(results, name)):
                    raise AssertionError(f"{label}: no {name} written")
            shape, _ = png_shape(os.path.join(results, "train",
                                              "s0000000_c000.png"))
            log(f"train_nerf {label}: {TRAIN_STEPS + 1} steps in {wall:.3f} s "
                f"(CLI call), {step_ms[label]:.3f} ms/step over steps 2.."
                f"{TRAIN_STEPS + 1}; val PSNR {rows[0][2]:.3f} -> "
                f"{rows[-1][2]:.3f} dB at steps {[r[0] for r in rows]}; "
                f"K1 launches {k1}, K2 launches {k2}; eval PNG {shape}")
            if not all(np.isfinite(psnrs)) or len(rows) < 2:
                raise AssertionError(f"{label}: PSNRs {rows}")
            if not rows[-1][2] > rows[0][2]:
                raise AssertionError(f"{label}: val PSNR did not rise")
            if fused:
                if k1 <= 0 or k2 <= 0:
                    raise AssertionError(f"{label}: the training path did "
                                         f"not launch K1 ({k1}) and K2 "
                                         f"({k2})")
                launches["fused_nerf"] += k1
                launches["fused_nerf_train"] += k2
                checkpoint = os.path.join(results, "nerf.npz")
    return step_ms, launches, checkpoint


def phase_render_trained(checkpoint):
    """The trained checkpoint renders one 800x800 frame."""
    from fourier_feature_nets_torch.cli import orbit_video
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        fused_nerf_apply)
    frames_dir = os.path.join(OUT_DIR, "trained_frame")
    fused_nerf_apply.launches = 0
    rc = orbit_video.main([checkpoint, "800", frames_dir, "--preset", "fast",
                           "--num-frames", "1"])
    torch.cuda.synchronize()
    shape, peak = png_shape(os.path.join(frames_dir, "frame_00000.png"))
    log(f"trained checkpoint, orbit_video --preset fast: frame {shape}, "
        f"max pixel {peak}, K1 launches {fused_nerf_apply.launches}")
    if rc != 0 or shape != (800, 800, 3) or fused_nerf_apply.launches <= 0:
        raise AssertionError("the trained checkpoint did not render")


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
    log("K2 vs plain twin, flagship:")
    backward = phase_backward_vs_twin(model)
    del model
    torch.cuda.empty_cache()
    step_ms, train_launches, checkpoint = phase_train()
    log("train ms/step over steps 2.." + str(TRAIN_STEPS + 1) + ": "
        + ", ".join(f"{k} {v:.3f}" for k, v in step_ms.items()))
    phase_render_trained(checkpoint)

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
        "train_launches": train_launches["fused_nerf"],
    }, {
        "name": "fused_nerf_train",
        "route": "cuda",
        "source": "fourier_feature_nets_torch/kernels/csrc/"
                  "fused_nerf_train.cu",
        "replaces": "fourier_feature_nets_tpu/ops/fused_nerf_train.py:150",
        "launches": train_launches["fused_nerf_train"],
        "max_abs_err": backward["bfloat16"]["max_abs_err"],
        "ms": backward["bfloat16"]["ms"],
        "plain_ms": backward["bfloat16"]["plain_ms"],
        "f32_max_abs_err": backward["float32"]["max_abs_err"],
        "f32_ms": backward["float32"]["ms"],
        "f32_plain_ms": backward["float32"]["plain_ms"],
        "max_rel_err_by_cotangent": backward["bfloat16"]["max_rel_err"],
        "f32_max_rel_err_by_cotangent": backward["float32"]["max_rel_err"],
        "bitwise_equal": backward["bfloat16"]["bitwise_equal"],
        "train_ms_per_step": step_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
