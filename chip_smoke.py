"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1, the fused NeRF forward; K2, the
fused recompute backward; K3, the fused ray render, with T1's scan;
P1a-c, the int8 probe's; P2, the forward's ablations; P3a-c, the
IO-floor copy kernels) from the sources in this checkout, in parallel,
and drives the port's paths at the flagship width:

* serving: K1 against its plain twin (and timed beside it at the bench
  batch, the frame chunk and the train batch), in bf16 within
  K1_BF16_ATOL and K1_BF16_MEAN_ATOL, limits that each twin with a
  rounding point moved must fail; three 800x800 ``--preset
  fast`` frames of a seeded random flagship NeRF through
  ``orbit_video``, which must go through K1; a ``torch.profiler`` split
  of one such frame by kernel; a low-resolution fused render against
  the plain render;
* training: K2 against its plain twin in bf16 and f32 at the CLI batch
  (1024 rays x 128 samples) and a ragged N, and in bf16 within
  ``fused_nerf_train.K2_BF16_MEAN_SHARE`` under the tail cotangent there
  and under a margin cotangent at 3x256, a limit each twin with a
  rounding point moved must fail, as the twin with dz left in f32 must
  fail the same-sign limit; 30 steps of ``train_nerf``
  on the generated ``synthetic`` scene in bf16 and f32, ``--fused``
  (through K1 and K2, which must both launch) and ``--no-fused``, then
  at the CLI's defaults (f32, no fused flag), which must print the
  plain path and launch neither; the trained checkpoint then renders an
  800x800 frame through ``orbit_video``;
* kernel validation: K3 against its plain twin in bf16 and f32 at
  S = 42, 48 and 128, a ragged R and a case where only the last ray
  block carries signal, and against the plain render; T1's scan against
  ``exclusive_cumprod`` (up to 128 lanes within SCAN_RTOL, at 130 and
  4096 within ``scan_rtol``, and at bases one row and one element into
  a buffer); K3, its twin and K1 followed by ``_composite`` timed at
  16384 rays x 48 and x 128 samples; then ``cli/validate_kernels``,
  which must launch K1, K2, K3 and the scan and end in ``ALL OK``;
* the probes: P1a (also with W and h one row and one element into
  larger buffers), P1b, P1c in int8 and P3a-c bit for bit against their
  twins, P1c in bf16 within a stated share, P2 in each of its seven
  modes (the ablation CLI's five, bf16-accum and no-sincos) within K1's
  bf16 tolerance (bf16-accum within ACCUM_ATOL and ACCUM_MEAN_ATOL, and
  farther than that from base's twin), at their CLIs' shapes and ragged
  ones, each timed beside its bound (and, where one PyTorch call
  computes the same function, that call's time); then ``cli/int8_probe``,
  ``cli/kernel_ablation_bench`` and ``cli/kernel_io_floor_bench``, each
  of which must exit 0 and launch its kernels;
* the short kernels (P1a, P1b, T1, P3a at both tiles, P3c), P1c (int8
  and bf16), P3b and their library calls, each timed three ways
  (:func:`call_times`): wrapper ms, device ms from a CUDA graph replay,
  and host us a call.

Each phase prints its own lines; any failure raises and the script
exits non-zero without printing a result. The last two lines are the
per-kernel JSON record (every kernel with its launches on its path,
error, time, its plain twin's time, bound and library time; the short
kernels also with ``device_ms``, ``library_device_ms`` and ``host_us``)
and ``{"ok": true, "device": ...}``.

``--k2-limits [all|tail] [--tree DIR]`` prints only the readings behind
K2's bf16 limits: its random, same-sign, tail and margin shares against
the twin and against each twin with a rounding point moved, over several
seeds, sizes and models (``tail``: the flagship's tail lines alone), for
the port found in ``DIR``.

``--times-only [--tree DIR]`` prints only those three times for the
kernels of the last item, the host cost of each launch-path step, K1-K3
at their PERF.md sizes, P2 in each of its modes, the fused core of a
bf16 train step and whole bf16 ``train_nerf`` steps, fused and plain,
as one JSON line, for the port found in ``DIR`` (an unpacked parent
commit, say), so that two trees can be timed in turns on one card.

Needs one CUDA device; on a machine without one it exits with code 2.
Outputs go to ``smoke_out/`` inside the checkout.
"""

import argparse
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
RAGGED_POINTS = 100_003        # not a multiple of 64 or 128 (the tiles)
TRAIN_POINTS = 1024 * 128      # train_nerf's default batch: rays x samples
K1_TIMED_POINTS = (BENCH_POINTS, CHUNK_POINTS, TRAIN_POINTS)
F32_RTOL, F32_ATOL = 1e-3, 2e-4   # tests/test_fused_nerf.py:44
BF16_ATOL = 0.05                  # tests/test_fused_nerf.py:64
# K1 bf16 (the wgmma kernel) against its twin: max and mean |d|. The two
# round at the same points and sum each layer's products in other orders,
# so they differ only where a sum lands within f32 rounding of a bf16
# rounding boundary: sparse, small differences. A twin with one rounding
# point moved (fused_nerf.MOVED_ROUNDINGS) differs at most points but by
# little, and stays within any max limit that K1 passes; its mean error
# tells it apart. Readings at the flagship, N = 2,097,152 to 100,003 (H100
# 80GB HBM3, 700 W): max 2.6e-4 to 3.6e-4, mean 7.2e-7 to 7.4e-7 against
# the twin; against the moved twins max 3.9e-4 to 7.9e-4, mean 2.95e-5
# (uncast-bottleneck) to 1.0e-4 (cast-heads). The card tests hold the
# small, structural and sweep models to the same limits.
K1_BF16_ATOL = 4e-3               # max |d|
K1_BF16_MEAN_ATOL = 5e-6          # mean |d|
# K2 vs its twin, per gradient leaf and cotangent: max|kernel - twin| <=
# GRAD_SHARE * max|twin|. Readings at the flagship on an H100 80GB HBM3 at
# 700 W, N = 131,072 / 100,003 (bf16, the wgmma kernel; f32, the FFMA tile);
# ``--k2-limits`` reads bf16 at four seeds and both N:
# * random: N(0, 1); each gradient is a cancelling sum that grows like
#   sqrt(N), so a few terms that differ stand out: ReLU-mask flips. K2 and
#   the twin sum each pre-activation in another order (in bf16, K2's sums
#   are K1's wgmma chains and the twin's are f32 GEMMs), and one within
#   rounding of 0 takes the other side of the mask in each; in f32, zeroing
#   the cotangent of the 180 points within 1e-7 of a boundary takes 1.04e-2
#   to 5.6e-6. In bf16 most flips follow a bf16 activation that rounds one
#   step apart in the two, which no f32 sum order of the twin removes.
#   (bf16 5.9e-3 to 1.6e-2 over the seeds, 5.0e-3 to 6.7e-3 at 262,143
#   points; f32 7.13e-3 / 1.04e-2.)
# * margin (f32): random with the cotangent zeroed on the ~2% of points that
#   have a pre-activation within MARGIN of 0 (relu_margin); with the flips
#   gone, what is left is rounding. (5.7e-6 / 5.3e-6.)
# * same-sign: all ones, so the sums do not cancel. A twin with dz left in
#   f32 (SAME_SIGN_CATCHES) must fail it. (bf16 6.4e-5 to 9.7e-5, that twin
#   2.52e-3 to 2.55e-3: the limit 5.2x above the one and 5.0x below the
#   other; f32 5.8e-5 / 3.1e-5.)
# * tail: random on the last GROUP points (at N = 100,003 the ragged last
#   tile, 35 points) and on one other GROUP, zero elsewhere: those points make
#   up the whole gradient, so a dropped or mis-masked tile cannot hide. Over
#   256 points one ReLU flip is ~1/16 of a leaf, so in bf16 each of those
#   points is, of K2_BF16_TAIL_POOL drawn for it, the one farthest from every
#   ReLU boundary (fused_nerf_train.far_from_relu; each then lies >= 3.5e-4
#   from one). With no pick, one seed's N = 131,072 read 1.13e-2; points only
#   1e-5 from a boundary still flipped (4.4e-2, 1.4e-2 in two pairs of
#   eight). (bf16
#   4.7e-4 to 1.3e-3 over the seeds; f32 8.7e-7 / 7.4e-7.) In bf16 the tail
#   also carries the mean-share control below.
# A K2 bf16 that skips the ragged tile fails tail at N = 100,003 in all four
# seeds (max share >= 0.83), one that drops its last point's cotangent at
# both N (>= 4.1e-2); in f32 those two and one that rounds dz to bf16 fail
# tail (the f32 tile).
GRAD_SHARE = {"random": {"bfloat16": 2e-2, "float32": 2e-2},
              "margin": {"float32": 5e-5},
              "same-sign": {"bfloat16": 5e-4, "float32": 3e-4},
              "tail": {"bfloat16": 1e-2, "float32": 2e-5}}
MARGIN = {"float32": 1e-6}
# the twins with a rounding point moved that bf16's same-sign limit must
# fail: all-ones are exact in bf16, so cast-head-cotangent is the twin there
SAME_SIGN_CATCHES = ("uncast-dz",)
# K2 bf16's control against a rounding point moved
# (fused_nerf_train.K2_BF16_MEAN_SHARE): per leaf, mean|kernel - twin| <=
# 1.5e-3 * mean|twin|, which each twin with a rounding point moved
# (fused_nerf_train.MOVED_BACKWARD_ROUNDINGS) must fail. Under a random
# cotangent at the flagship's depth, ReLU flips between the kernel's wgmma
# sums and the twin's f32 GEMMs move every statistic as much as a moved
# rounding point does (mean share: the kernel 4.2e-3 to 7.0e-3, the moved
# twins from 6.2e-3). So the control runs under two cotangents with
# no point near a ReLU boundary: the flagship's tail (above), and, at the
# flagship's width cut to 3 layers (K2_BF16_CONTROL_MODEL), random zeroed on
# the points within K2_BF16_MARGIN of a boundary, where a third of the
# points are left. Readings (``--k2-limits``): at 3x256, 4x64 and 3x96, N =
# 3,001 and 20,011, two seeds each, the kernel 3.0e-5 to 7.5e-4, the moved
# twins 3.1e-3 to 8.6e-3; the flagship's tail, four seeds and both N, the
# kernel 1.4e-4 to 5.4e-4, the moved twins 4.7e-3 to 9.3e-3. So 1.5e-3:
# 2.0x above the highest reading, 2.1x below the nearest moved twin.
CONTROL_POINTS = 20_011
MANY_POINTS = 262_143   # --k2-limits: 2048 tiles, ~16 a block, the last ragged
GROUP = 128   # K2's bf16 tile, eight of its f32 tiles
RENDER_RAYS = 16384            # one frame chunk / bench.py's render batch
RAGGED_RAYS = 1001             # not a multiple of any ray block
PLAIN_RENDER_ATOL = 5e-3       # tools/validate_kernels_tpu.py:167-170
SCAN_RTOL = 1e-5               # tests/test_fused_ray_render.py:31
TRAIN_STEPS = 30
TIMED_TRAIN_STEPS = 100   # --times-only: whole train steps a path
SEED = 0
# The probes, at the shapes of their CLIs (the JAX tools') and ragged ones.
P1_GEMM_SHAPES = ((128, 128, 256), (100, 72, 250))     # (M, K, N)
P1A_CASES = tuple((shape, offset) for shape in P1_GEMM_SHAPES
                  for offset in ("none", "one row", "one element"))
P1B_RTOL = 1e-6                # max|kernel - twin| / max|twin|; reads 0
P1C_SHAPES = ((192, 2048, 8), (192, 1000, 8))          # (C, N, layers)
# P1c bf16: max|kernel - twin| / max|twin|. Reads 0 at both shapes (H100
# 80GB HBM3, 700 W). The sums pass 2**24 from the fifth layer on and may
# round in another order on the tensor cores than in the twin's f32 GEMM;
# the bound lets such a sum land one bf16 step (2**-8) away and the later
# layers carry it.
P1C_BF16_SHARE = 2e-2
ABLATION_POINTS = 16384 * 32   # the ablation CLI: rays x samples
# P2 bf16-accum against its twin. It differs from base by rounding only: at
# the flagship the two twins are max 5.5e-4 / 5.1e-4 and mean 5.2e-5 /
# 5.1e-5 apart, so a kernel that computed base would pass BF16_ATOL and any
# max-error limit the real kernel passes (max 4.1e-4 / 2.9e-4). Its mean
# error tells them apart: 4.1e-7 / 3.8e-7 against its twin, 5.2e-5 / 5.1e-5
# against base's (H100 80GB HBM3, 700 W; N = 524,288 at the ablation CLI's
# points / 100,003 ragged). The kernel must be within both limits of its
# twin and farther than ACCUM_MEAN_ATOL from base's.
ACCUM_ATOL = 4e-3              # max |d|
ACCUM_MEAN_ATOL = 5e-6         # mean |d|
IO_POINTS = 16384 * 48         # the IO-floor CLI: rays x samples
# Peak rates of one H100 SXM at 700 W (NVIDIA's data sheet, dense), for
# the least time the card could take: the larger of operations over the
# peak and bytes (each input read once, each output written once) over
# the HBM rate.
PEAK = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
TIME_REPS = 200      # back-to-back calls for wrapper ms and host us
GRAPH_CALLS = 100    # calls captured in one CUDA graph for device ms
GRAPH_REPLAYS = 10
FLAGSHIP_REPS = 10   # K1, K2, K3 calls (milliseconds each) per timing


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


def graph_ms(fn) -> float:
    """Device milliseconds per call: GRAPH_CALLS calls captured once in a
    CUDA graph (a raw launch goes to PyTorch's current stream, which is
    the capture stream), replayed GRAPH_REPLAYS times between CUDA
    events. The host issues one replay, not each call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (GRAPH_REPLAYS * GRAPH_CALLS)


def profiler_kernel_ms(fn, reps: int):
    """The device time of the kernels ``fn`` launches, summed by
    ``torch.profiler`` over ``reps`` calls, per call; None when the
    trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for event in prof.key_averages():
        if event.device_type == DeviceType.CUDA:
            total_us += getattr(event, "self_device_time_total",
                                getattr(event, "self_cuda_time_total", 0.0))
    return total_us / reps / 1e3 if total_us > 0 else None


def call_times(fn, reps: int = TIME_REPS) -> dict:
    """Three times of one call of ``fn``, which launches work on the card:

    * wrapper_ms: ``reps`` back-to-back calls between CUDA events
      (:func:`cuda_ms`), so the host's issue rate shows when a call is
      short;
    * device_ms: :func:`graph_ms`, the calls replayed from a CUDA graph
      (or, if capture fails, :func:`profiler_kernel_ms`; device_method
      says which);
    * host_us: the host clock around ``reps`` calls, read before any
      synchronise: what issuing one call costs the host.

    kernel_ms is the profiler's device time of the launched kernels
    alone, per call, beside them."""
    wrapper_ms = cuda_ms(fn, reps)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    host_us = (time.perf_counter() - start) * 1e6 / reps
    torch.cuda.synchronize()
    try:
        device_ms, method = graph_ms(fn), "cuda graph"
    except RuntimeError as error:
        torch.cuda.synchronize()
        device_ms = profiler_kernel_ms(fn, reps)
        method = f"torch.profiler (graph capture failed: {str(error)[:120]})"
    return {"wrapper_ms": wrapper_ms, "device_ms": device_ms,
            "host_us": host_us, "device_method": method,
            "kernel_ms": profiler_kernel_ms(fn, reps)}


def with_times(row: dict, times: dict) -> dict:
    """A kernel's JSON row with its :func:`call_times` (ms is the wrapper
    ms) and its library call's, where it has one."""
    merged = dict(row, ms=times["wrapper_ms"], device_ms=times["device_ms"],
                  host_us=times["host_us"], kernel_ms=times["kernel_ms"],
                  device_method=times["device_method"])
    if "library_wrapper_ms" in times:
        merged.update(library_ms=times["library_wrapper_ms"],
                      library_device_ms=times["library_device_ms"],
                      library_host_us=times["library_host_us"],
                      library_kernel_ms=times["library_kernel_ms"])
    else:
        merged.update(library_ms=None, library_device_ms=None)
    return merged


def bound(ops: float, kind: str, num_bytes: float):
    """{"bound_ms", "bound_by"}: the larger of ops over the ``kind``
    peak and bytes over the HBM rate, in ms."""
    ops_ms = ops / PEAK[kind] * 1e3
    bytes_ms = num_bytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def nerf_macs(weights, no_view: bool = False, view_once_per: int = 0):
    """Multiply-adds per point of the packed NeRF's live (unpadded)
    layers; ``no_view`` leaves out everything after the opacity head;
    ``view_once_per`` > 0 counts the hidden layer's view rows once per
    that many points (K3's per-ray view product)."""
    c = weights.channels
    inputs = 3 if weights.include_inputs else 0
    pos = 2 * weights.pos_enc.shape[1] + inputs
    view = 2 * weights.view_enc.shape[1] + inputs
    macs = pos * c + (weights.num_layers - 1) * c * c \
        + len(weights.skips) * pos * c + c
    if no_view:
        return macs
    view_macs = view * (c // 2)
    if view_once_per:
        view_macs /= view_once_per
    return macs + c * c + c * (c // 2) + view_macs + (c // 2) * 3


def pack_bytes(weights) -> int:
    return (weights.weights.numel() * weights.weights.element_size()
            + weights.biases.numel() * 4)


def flagship_bounds(packs):
    """The bounds of K1, K2 and K3 at the shapes they are timed at, for
    the flagship packs {dtype: pack}: K1 at BENCH_POINTS (40 B a point:
    positions, views, logits); K2 at TRAIN_POINTS, three times K1's
    products (the recompute, then the products for dX and dW), 40 B a
    point (positions, views, cotangents) and f32 gradients the size of
    the pack; K3 at RENDER_RAYS x 128 and x 48, its view rows once per
    ray, 16 B a sample (position, depth) and 28 B a ray."""
    bounds = {"fused_nerf": {}, "fused_nerf_train": {},
              "fused_ray_render": {}}
    for dtype, pack in packs.items():
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        weights = pack_bytes(pack)
        grads = (pack.weights.numel() + pack.biases.numel()) * 4
        macs = nerf_macs(pack)
        bounds["fused_nerf"][kind] = bound(
            2 * macs * BENCH_POINTS, kind, 40 * BENCH_POINTS + weights)
        bounds["fused_nerf_train"][kind] = bound(
            3 * 2 * macs * TRAIN_POINTS, kind,
            40 * TRAIN_POINTS + weights + grads)
        for samples, key in ((128, kind), (48, f"{kind}_s48")):
            points = RENDER_RAYS * samples
            bounds["fused_ray_render"][key] = bound(
                2 * nerf_macs(pack, view_once_per=samples) * points, kind,
                16 * points + 28 * RENDER_RAYS + weights)
    return bounds


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
    import importlib
    modules = [importlib.import_module(f"fourier_feature_nets_torch.kernels."
                                       f"{name}")
               for name in ("fused_nerf", "fused_nerf_train",
                            "fused_ray_render", "int8_probe",
                            "fused_nerf_ablation", "io_floor")]
    start = time.perf_counter()
    # one nvcc per source, all started together
    with concurrent.futures.ThreadPoolExecutor(len(modules)) as pool:
        builds = list(pool.map(lambda module: module.load_kernel(), modules))
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
    chunk shape, the train batch and a ragged N; timed beside the twin
    at the first three. In bf16 also against the twin with each of its
    rounding points moved, which the limits must reject."""
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        MOVED_ROUNDINGS, fused_nerf_apply, fused_nerf_reference,
        prepare_fused_nerf, slab_image)
    log("kernel vs plain twin: torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} (the twin's f32 GEMMs "
        "are full f32)")
    rng = np.random.default_rng(SEED)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        weights = prepare_fused_nerf(model, dtype)
        row = {"times": {}}
        if weights.slabs is not None:
            log(f"  bfloat16 slab image: {weights.slabs.numel() * 2:,d} "
                f"bytes, streamed once a 128-point tile")
            shapes = [tuple(w.shape) for w, _ in weights.layers]
            offsets = weights.meta[8:8 + len(shapes)]
            row["slab_image_ms"] = cuda_ms(
                lambda: slab_image(weights.weights, shapes, offsets), 20)
            log(f"  bfloat16 slab image (one gather, built with every "
                f"pack): {row['slab_image_ms']:.4f} ms a pack (CUDA "
                f"events, mean of 20)")
        for num in (*K1_TIMED_POINTS, RAGGED_POINTS):
            positions, views = random_points(num, rng, "cuda")
            with torch.no_grad():
                ref = fused_nerf_reference(weights, positions, views)
                out = fused_nerf_apply(weights, positions, views)
            torch.cuda.synchronize()
            if out.shape != (num, 4) or not torch.isfinite(out).all():
                raise AssertionError(f"kernel output not finite (N={num})")
            err = (out - ref).abs()
            max_abs = err.max().item()
            mean_abs = err.mean().item()
            max_rel = (err / ref.abs().clamp(min=1e-3)).max().item()
            if dtype == torch.float32:
                bound = F32_ATOL + F32_RTOL * ref.abs()
                ok = bool((err <= bound).all())
                stated = f"|d| <= {F32_ATOL} + {F32_RTOL}|ref|"
            else:
                ok = max_abs <= K1_BF16_ATOL and mean_abs <= K1_BF16_MEAN_ATOL
                stated = (f"max |d| <= {K1_BF16_ATOL}, mean |d| <= "
                          f"{K1_BF16_MEAN_ATOL}")
            log(f"  {str(dtype)[6:]:8s} N={num:>9,d}: max abs err "
                f"{max_abs:.3e}, mean abs err {mean_abs:.3e}, max rel err "
                f"{max_rel:.3e} (tolerance {stated}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("kernel disagrees with its plain twin")
            row["max_abs_err"] = max(row.get("max_abs_err", 0.0), max_abs)
            row["mean_abs_err"] = max(row.get("mean_abs_err", 0.0), mean_abs)
            if dtype == torch.bfloat16:
                # the control: each moved twin must fail the mean limit
                moved = {}
                for name in MOVED_ROUNDINGS:
                    with torch.no_grad():
                        d = (out - fused_nerf_reference(weights, positions,
                                                        views, name)).abs()
                    moved[name] = (d.max().item(), d.mean().item())
                    del d
                log(f"  bfloat16 N={num:>9,d}: against the twin with a "
                    f"rounding point moved, max / mean abs err: " + ", ".join(
                        f"{name} {a:.3e} / {m:.3e}"
                        for name, (a, m) in moved.items()))
                caught = [name for name, (_, m) in moved.items()
                          if m > K1_BF16_MEAN_ATOL]
                if len(caught) != len(moved):
                    raise AssertionError(
                        f"K1's bf16 limits pass a twin with a rounding point "
                        f"moved: {sorted(set(moved) - set(caught))}")
                low = row.setdefault("moved_rounding_min_mean_abs_err", {})
                for name, (_, m) in moved.items():
                    low[name] = min(low.get(name, m), m)
            if num in K1_TIMED_POINTS:
                with torch.no_grad():
                    kernel_ms = cuda_ms(
                        lambda: fused_nerf_apply(weights, positions, views),
                        5)
                    plain_ms = cuda_ms(
                        lambda: fused_nerf_reference(weights, positions,
                                                     views), 5)
                log(f"  {str(dtype)[6:]:8s} N={num:>9,d}: kernel "
                    f"{kernel_ms:.4f} ms, plain twin {plain_ms:.3f} ms "
                    f"(CUDA events, mean of 5)")
                row["times"][num] = (kernel_ms, plain_ms)
            del positions, views, ref, out, err
        results[dtype] = row
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


def phase_frame_profile(model):
    """One 800x800 ``--preset fast`` frame (orbit_video's set-up: the
    density grid, 48 samples, bf16, the fused default) under
    ``torch.profiler`` after one warm-up frame: wall time, device time by
    kernel, and the device's busy share of the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fourier_feature_nets_torch.cameras import Resolution
    from fourier_feature_nets_torch.cli import orbit_video
    from fourier_feature_nets_torch.render import Raycaster
    from fourier_feature_nets_torch.utils import orbit

    args = orbit_video._parse_args(["model.npz", "800", OUT_DIR, "--preset",
                                    "fast", "--num-frames", "3"])
    cameras = orbit(orbit_video.VECTORS[args.up_dir],
                    orbit_video.VECTORS[args.forward_dir], args.num_frames,
                    args.fov_y_degrees, Resolution(800, 800), args.distance)
    bounds = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
    raycaster = Raycaster(model, compute_dtype=torch.bfloat16)
    sampler = orbit_video.build_render_sampler(args, model, cameras, bounds)
    chunk = args.batch_size * 4
    raycaster.render_frame(sampler, 0, chunk_size=chunk)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        raycaster.render_frame(sampler, 1, chunk_size=chunk)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    kernels = []
    for event in prof.key_averages():
        if event.device_type != DeviceType.CUDA:
            continue
        device_us = getattr(event, "self_device_time_total",
                            getattr(event, "self_cuda_time_total", 0.0))
        kernels.append((device_us / 1e3, event.count, event.key))
    kernels.sort(reverse=True)
    device_ms = sum(ms for ms, _, _ in kernels)
    log(f"one --preset fast frame under torch.profiler: {wall_ms:.3f} ms "
        f"wall, {device_ms:.3f} ms of device time, busy "
        f"{device_ms / wall_ms:.1%} of the wall")
    for ms, count, name in kernels[:8]:
        log(f"  {ms:9.3f} ms {ms / device_ms:6.1%} x{count:<4d} {name[:90]}")
    k1 = [(ms, count) for ms, count, name in kernels
          if "fused_nerf_bf16_kernel" in name]
    if not k1:
        raise AssertionError("the profiled frame launched no bf16 K1")
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms, "k1_ms": k1[0][0],
            "k1_launches": k1[0][1], "k1_share": k1[0][0] / device_ms,
            "top": [[name[:90], ms, count] for ms, count, name in kernels[:8]]}


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


def tail_rows(num: int, device) -> torch.Tensor:
    """The points of the tail cotangent: the last GROUP (the ragged last
    tile at a ragged N) and one full GROUP in the middle."""
    last = num % GROUP or GROUP
    mid = num // GROUP // 2 * GROUP
    return torch.cat([torch.arange(mid, mid + GROUP, device=device),
                      torch.arange(num - last, num, device=device)])


def backward_cotangents(weights, positions, views, rng, pool=None):
    """The (N, 4) cotangents K2 is held to its twin with, by name (see
    GRAD_SHARE). In bf16 the tail's points are first replaced, in
    ``positions`` and ``views``, by those of ``pool`` (default
    K2_BF16_TAIL_POOL) random points drawn for each that lie farthest from
    every ReLU boundary; returns the cotangents and the smallest ReLU
    margin among the tail's points (None in f32)."""
    from fourier_feature_nets_torch.kernels.fused_nerf_train import (
        K2_BF16_TAIL_POOL, far_from_relu, relu_margin)
    num = positions.shape[0]
    name = str(weights.weights.dtype)[6:]
    rows = tail_rows(num, positions.device)
    least = None
    if name == "bfloat16":
        positions[rows], views[rows], least = far_from_relu(
            weights, rows.numel(), rows.numel() * (pool or K2_BF16_TAIL_POOL),
            lambda n: random_points(n, rng, positions.device))
    random = torch.from_numpy(rng.normal(size=(num, 4)).astype(
        np.float32)).to(positions.device)
    tail = torch.zeros_like(random)
    tail[rows] = random[rows]
    gs = {"random": random, "same-sign": torch.ones_like(random),
          "tail": tail}
    if name in MARGIN:
        margin = relu_margin(weights, positions, views)
        gs["margin"] = torch.where((margin >= MARGIN[name])[:, None], random,
                                   0.0)
    return gs, least


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
        fused_nerf_backward, fused_nerf_backward_reference, scratch_bytes)
    rng = np.random.default_rng(SEED + 1)
    control = {}
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        log(f"  {name}: per leaf, max abs err / max rel err (max|d| / "
            f"max|twin|) under each cotangent; tolerance on the rel err: "
            + ", ".join(f"{k} {v[name]:g}" for k, v in GRAD_SHARE.items()
                        if name in v))
        weights = prepare_fused_nerf(model, dtype)
        if dtype == torch.bfloat16:
            parked = scratch_bytes(weights, TRAIN_POINTS,
                                   torch.device("cuda", 0))
            log(f"  {name}: the wgmma kernel parks its tiles' activations in "
                f"{parked:,d} bytes of scratch at N={TRAIN_POINTS:,d}")
        for num in (TRAIN_POINTS, RAGGED_POINTS):
            positions, views = random_points(num, rng, "cuda")
            gs, least = backward_cotangents(weights, positions, views, rng)
            log(f"  {name:8s} N={num:>7,d}: tail cotangent on "
                f"{int(torch.count_nonzero(gs['tail'][:, 0]))} points"
                + (f" (each at least {least:.2e} from a ReLU boundary)"
                   if least is not None else "")
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
            if name == "bfloat16":
                control[num] = {
                    "same-sign": same_sign_control(
                        weights, positions, views, gs["same-sign"],
                        f"flagship N={num:,d}"),
                    "tail": mean_share_control(
                        weights, positions, views, gs["tail"],
                        f"flagship N={num:,d}, tail cotangent")}
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
                results.setdefault(name, {}).update({
                    "max_abs_err": max(r[1] for r in table["random"]),
                    "max_rel_err": {key: max(r[2] for r in rows)
                                    for key, rows in table.items()},
                    "ms": kernel_ms, "plain_ms": plain_ms,
                    "bitwise_equal": bitwise})
            del positions, views, gs, g, out, again
        del weights
        torch.cuda.empty_cache()
    results["bfloat16"]["flagship_control"] = control
    return results


def leaf_max_share(weights, out, twin) -> float:
    """The largest per-leaf max|out - twin| / max|twin|."""
    return max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
               for (_, a), (_, b) in zip(weights.split_flat(*out),
                                         weights.split_flat(*twin)))


def same_sign_control(weights, positions, views, g, what: str) -> dict:
    """K2 bf16's same-sign limit against each twin with a rounding point
    moved that a same-sign cotangent can show (SAME_SIGN_CATCHES): logs
    and returns the largest per-leaf max share of each, and raises unless
    each is beyond GRAD_SHARE["same-sign"]."""
    from fourier_feature_nets_torch.kernels.fused_nerf_train import (
        fused_nerf_backward, fused_nerf_backward_reference)
    limit = GRAD_SHARE["same-sign"]["bfloat16"]
    out = fused_nerf_backward(weights, positions, views, g)
    shares = {name: leaf_max_share(weights, out, fused_nerf_backward_reference(
        weights, positions, views, g, name)) for name in SAME_SIGN_CATCHES}
    log(f"  bfloat16 {what}, same-sign: largest per-leaf max|d| / max|twin| "
        f"against the twin with a rounding point moved: " + ", ".join(
            f"{k} {v:.3e}" for k, v in shares.items()) + f" (limit {limit:g})")
    passed = sorted(k for k, v in shares.items() if v <= limit)
    if passed:
        raise AssertionError(f"K2's bf16 same-sign limit passes a twin with "
                             f"a rounding point moved: {passed}")
    return shares


def mean_share_control(weights, positions, views, g, what: str) -> dict:
    """K2 bf16 under the cotangent ``g`` against the twin and against each
    twin with a rounding point moved: logs and returns the largest
    per-leaf mean share of each, by name ("kernel" for the twin). Raises
    unless the kernel is within K2_BF16_MEAN_SHARE and every moved twin
    beyond it."""
    from fourier_feature_nets_torch.kernels.fused_nerf_train import (
        K2_BF16_MEAN_SHARE, MOVED_BACKWARD_ROUNDINGS, fused_nerf_backward,
        fused_nerf_backward_reference, leaf_mean_share)
    out = fused_nerf_backward(weights, positions, views, g)
    shares = {name or "kernel": leaf_mean_share(
        weights, out,
        fused_nerf_backward_reference(weights, positions, views, g, name))
        for name in (None, *MOVED_BACKWARD_ROUNDINGS)}
    log(f"  bfloat16 {what}: largest per-leaf mean|d| / mean|twin|: kernel "
        f"{shares['kernel']:.3e}; against the twin with a rounding point "
        f"moved: " + ", ".join(f"{k} {v:.3e}" for k, v in shares.items()
                               if k != "kernel")
        + f" (limit {K2_BF16_MEAN_SHARE:g})")
    if shares["kernel"] > K2_BF16_MEAN_SHARE:
        raise AssertionError(f"K2 bf16 disagrees with its twin under {what}")
    passed = sorted(k for k, v in shares.items()
                    if k != "kernel" and v <= K2_BF16_MEAN_SHARE)
    if passed:
        raise AssertionError(f"K2's bf16 limit under {what} passes a twin "
                             f"with a rounding point moved: {passed}")
    return shares


def phase_backward_control():
    """K2 bf16's mean-share control (mean_share_control) under the margin
    cotangent at K2_BF16_CONTROL_MODEL."""
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        prepare_fused_nerf)
    from fourier_feature_nets_torch.kernels.fused_nerf_train import (
        K2_BF16_CONTROL_MODEL, K2_BF16_MARGIN, relu_margin)
    from fourier_feature_nets_torch.models import NeRF
    model = NeRF(**K2_BF16_CONTROL_MODEL,
                 generator=torch.Generator().manual_seed(SEED + 1)).cuda()
    weights = prepare_fused_nerf(model, torch.bfloat16)
    rng = np.random.default_rng(SEED + 2)
    positions, views = random_points(CONTROL_POINTS, rng, "cuda")
    g = torch.from_numpy(rng.normal(size=(CONTROL_POINTS, 4)).astype(
        np.float32)).cuda()
    far = relu_margin(weights, positions, views) >= K2_BF16_MARGIN
    g = torch.where(far[:, None], g, 0.0)
    return mean_share_control(
        weights, positions, views, g,
        f"{K2_BF16_CONTROL_MODEL['num_layers']}x"
        f"{K2_BF16_CONTROL_MODEL['num_channels']} N={CONTROL_POINTS:,d}, "
        f"margin cotangent on {int(far.sum())} points")


def run_train_nerf(results: str, steps: int, flags, report: int = 10):
    """cli/train_nerf on the generated synthetic scene for ``steps``
    steps, validating every ``report``; returns (exit code, its standard output, the path its summary
    names, its ms/step over steps 2..)."""
    from fourier_feature_nets_torch.cli import train_nerf
    os.environ["FFN_TORCH_DATA_DIR"] = os.path.join(OUT_DIR, "data")
    captured = io.StringIO()
    with contextlib.redirect_stdout(captured):
        rc = train_nerf.main(["synthetic", results, "--num-steps", str(steps),
                              "--report-interval", str(report), *flags])
    torch.cuda.synchronize()
    output = captured.getvalue()
    # cli/train_nerf.py's summary names the path it trained
    summary = re.search(r"(fused|plain): first step .* ([0-9.]+) ms/step "
                        r"over steps 2", output)
    if summary is None:
        return rc, output, None, None
    return rc, output, summary.group(1), float(summary.group(2))


def train_step_ms(flags, steps: int, path: str) -> float:
    """train_nerf's ms/step over ``steps`` steps; raises unless it ran
    and trained through ``path`` (fused or plain)."""
    rc, output, trained, ms = run_train_nerf(
        os.path.join(OUT_DIR, "timed_train", path), steps, flags, steps)
    if rc != 0 or trained != path:
        raise AssertionError(f"train_nerf {flags} returned {rc}, trained "
                             f"{trained}:\n{output[-2000:]}")
    return ms


def _read_log(path):
    """(step, train PSNR, val PSNR) rows of a train_nerf log.txt."""
    with open(path) as handle:
        lines = handle.read().split("\n\n", 1)[1].strip().splitlines()
    rows = [line.split("\t") for line in lines[1:]]
    return [(int(r[0]), float(r[2]), float(r[3])) for r in rows]


def phase_train():
    """The training path: train_nerf on the generated synthetic scene,
    --fused (K1 + K2) and --no-fused, in bf16 and f32; then at the CLI's
    defaults (f32, no fused flag), which must train plain."""
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        fused_nerf_apply)
    from fourier_feature_nets_torch.kernels.fused_nerf_train import (
        fused_nerf_backward)
    step_ms, launches, checkpoint = {}, {"fused_nerf": 0,
                                         "fused_nerf_train": 0}, None
    runs = [(f"{dtype}, {'fused' if fused else 'plain'}",
             ["--compute-dtype", dtype, "--fused" if fused else "--no-fused"],
             fused)
            for dtype in ("bfloat16", "float32") for fused in (True, False)]
    runs.append(("float32, defaults", [], False))
    for label, flags, fused in runs:
        results = os.path.join(OUT_DIR, "train", label.replace(", ", "_"))
        fused_nerf_apply.launches = 0
        fused_nerf_backward.launches = 0
        start = time.perf_counter()
        rc, output, trained, step_ms[label] = run_train_nerf(
            results, TRAIN_STEPS, flags)
        wall = time.perf_counter() - start
        k1, k2 = fused_nerf_apply.launches, fused_nerf_backward.launches
        log("\n".join(f"    {line}" for line in output.splitlines()))
        if rc != 0 or trained is None:
            raise AssertionError(f"train_nerf ({label}) returned {rc}")
        rows = _read_log(os.path.join(results, "log.txt"))
        psnrs = [p for row in rows for p in row[1:]]
        for name in ("nerf.npz", "log.txt",
                     os.path.join("train", "s0000000_c000.png")):
            if not os.path.exists(os.path.join(results, name)):
                raise AssertionError(f"{label}: no {name} written")
        shape, _ = png_shape(os.path.join(results, "train",
                                          "s0000000_c000.png"))
        log(f"train_nerf {label}: {trained}, {TRAIN_STEPS + 1} steps "
            f"in {wall:.3f} s (CLI call), {step_ms[label]:.3f} ms/step over "
            f"steps 2..{TRAIN_STEPS + 1}; val PSNR {rows[0][2]:.3f} -> "
            f"{rows[-1][2]:.3f} dB at steps {[r[0] for r in rows]}; "
            f"K1 launches {k1}, K2 launches {k2}; eval PNG {shape}")
        if not all(np.isfinite(psnrs)) or len(rows) < 2:
            raise AssertionError(f"{label}: PSNRs {rows}")
        if not rows[-1][2] > rows[0][2]:
            raise AssertionError(f"{label}: val PSNR did not rise")
        if trained != ("fused" if fused else "plain"):
            raise AssertionError(f"{label}: trained {trained}")
        if fused:
            if k1 <= 0 or k2 <= 0:
                raise AssertionError(f"{label}: the training path did "
                                     f"not launch K1 ({k1}) and K2 ({k2})")
            launches["fused_nerf"] += k1
            launches["fused_nerf_train"] += k2
            checkpoint = os.path.join(results, "nerf.npz")
        elif k1 or k2:
            raise AssertionError(f"{label}: the plain path launched K1 ({k1}) "
                                 f"or K2 ({k2})")
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


def render_rays(num_rays: int, num_samples: int, rng: np.random.Generator):
    """Rays through the volume as the validation tool makes them: sorted
    depths in [1, 4), unit directions, starts in [-0.5, 0.5); (R, S, 3)
    positions, (R, 3) directions, (R, S) depths on the card."""
    t = np.sort(rng.uniform(1, 4, (num_rays, num_samples)).astype(np.float32),
                -1)
    d = rng.normal(size=(num_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    start = rng.uniform(-0.5, 0.5, (num_rays, 3)).astype(np.float32)
    pos = (start[:, None] + t[..., None] * d[:, None]).astype(np.float32)
    return tuple(torch.from_numpy(a).cuda() for a in (pos, d, t))


def render_error(out, twin, dtype):
    """(max abs err, within tolerance, stated tolerance) of K3 against
    its twin: K1's tolerances."""
    err = (out - twin).abs()
    if dtype == torch.float32:
        ok = bool((err <= F32_ATOL + F32_RTOL * twin.abs()).all())
        return err.max().item(), ok, f"|d| <= {F32_ATOL} + {F32_RTOL}|ref|"
    return err.max().item(), err.max().item() <= BF16_ATOL, \
        f"|d| <= {BF16_ATOL}"


def phase_ray_render_vs_twin(model):
    """K3 against its plain twin at S = 42, 48 and 128 with a ragged R,
    with signal only in the last ray block, and against the plain render
    (f32)."""
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        prepare_fused_nerf)
    from fourier_feature_nets_torch.kernels.fused_ray_render import (
        fused_ray_render, fused_ray_render_reference, rays_per_block)
    from fourier_feature_nets_torch.render import Raycaster, RaySamples
    rng = np.random.default_rng(SEED + 2)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        weights = prepare_fused_nerf(model, dtype)
        cases = [(f"R={RAGGED_RAYS:,d} S={s}", RAGGED_RAYS, s, False)
                 for s in (42, 48, 128)]
        cases += [(f"R={RAGGED_RAYS:,d} S={s}, signal only in the last ray "
                   f"block", RAGGED_RAYS, s, True) for s in (42, 48)]
        for label, num_rays, num_samples, last_only in cases:
            pos, d, t = render_rays(num_rays, num_samples, rng)
            if last_only:
                # every other ray has all its samples at one depth: alpha 0
                last = num_rays % rays_per_block(num_samples) \
                    or rays_per_block(num_samples)
                t[:-last] = 2.0
                pos[:-last] = d[:-last, None] * 2.0
            with torch.no_grad():
                out = fused_ray_render(weights, pos, d, t)
                twin = fused_ray_render_reference(weights, pos, d, t)
            torch.cuda.synchronize()
            if out.shape != (num_rays, 4) or not torch.isfinite(out).all():
                raise AssertionError(f"K3 output not finite ({label})")
            max_abs, ok, stated = render_error(out, twin, dtype)
            if last_only:
                quiet = torch.count_nonzero(twin[:-last, 3]).item()
                loud = twin[-last:, 3].min().item()
                label += (f" ({last} rays; twin alpha nonzero on {quiet} "
                          f"others, min {loud:.3f} in the block)")
                ok = ok and quiet == 0 and loud > 0.1
            log(f"  K3 {name:8s} {label}: max abs err {max_abs:.3e} "
                f"(tolerance {stated}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K3 disagrees with its plain twin "
                                     f"({name}, {label})")
    weights = prepare_fused_nerf(model, torch.float32)
    pos, d, t = render_rays(RAGGED_RAYS, 128, rng)
    with torch.no_grad():
        out = fused_ray_render(weights, pos, d, t)
        ref = Raycaster(model, fused=False).render(
            RaySamples(pos, d[:, None].expand(pos.shape), t, None))
    color = (out[:, :3] - ref.color).abs().max().item()
    alpha = (out[:, 3] - ref.alpha).abs().max().item()
    ok = max(color, alpha) <= PLAIN_RENDER_ATOL
    log(f"  K3 float32 vs Raycaster(fused=False).render, R={RAGGED_RAYS:,d} "
        f"S=128: color max err {color:.3e}, alpha max err {alpha:.3e} "
        f"(atol {PLAIN_RENDER_ATOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("K3 disagrees with the plain render")


def phase_ray_render_timing(model):
    """K3, its twin, and K1 followed by _composite (the port's render
    path today) at R = 16384 rays, S = 48 (a --preset fast chunk) and 128
    (bench.py's render batch)."""
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        fused_nerf_apply, prepare_fused_nerf)
    from fourier_feature_nets_torch.kernels.fused_ray_render import (
        fused_ray_render, fused_ray_render_reference)
    from fourier_feature_nets_torch.render.raycaster import _composite
    rng = np.random.default_rng(SEED + 3)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        weights = prepare_fused_nerf(model, dtype)
        for num_samples in (48, 128):
            pos, d, t = render_rays(RENDER_RAYS, num_samples, rng)
            flat = pos.reshape(-1, 3)
            views = d[:, None].expand(pos.shape).reshape(-1, 3).contiguous()

            def k1_composite():
                logits = fused_nerf_apply(weights, flat, views)
                return _composite(logits.reshape(RENDER_RAYS, num_samples, 4),
                                  t, False)

            with torch.no_grad():
                out = fused_ray_render(weights, pos, d, t)
                twin = fused_ray_render_reference(weights, pos, d, t)
                k1 = k1_composite()
                max_abs, ok, stated = render_error(out, twin, dtype)
                k1_diff = max((out[:, :3] - k1.color).abs().max().item(),
                              (out[:, 3] - k1.alpha).abs().max().item())
                ms = cuda_ms(lambda: fused_ray_render(weights, pos, d, t), 5)
                plain_ms = cuda_ms(lambda: fused_ray_render_reference(
                    weights, pos, d, t), 5)
                k1_ms = cuda_ms(k1_composite, 5)
                k1_alone_ms = cuda_ms(
                    lambda: fused_nerf_apply(weights, flat, views), 5)
            log(f"  K3 {name:8s} R={RENDER_RAYS} S={num_samples:3d}: K3 "
                f"{ms:.3f} ms, plain twin {plain_ms:.3f} ms, K1 + _composite "
                f"{k1_ms:.3f} ms (K1 alone {k1_alone_ms:.3f} ms) (CUDA "
                f"events, mean of 5); K3 vs twin max abs err {max_abs:.3e} "
                f"({stated}) {'ok' if ok else 'FAIL'}; K3 vs K1 + _composite "
                f"max abs diff {k1_diff:.3e}")
            if not ok:
                raise AssertionError(f"K3 disagrees with its plain twin "
                                     f"({name}, S={num_samples})")
            results[(name, num_samples)] = {
                "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
                "k1_composite_ms": k1_ms, "k1_ms": k1_alone_ms,
                "k1_composite_max_abs_diff": k1_diff}
            del pos, d, t, flat, views, out, twin, k1
        del weights
        torch.cuda.empty_cache()
    return results


def scan_rtol(lanes: int) -> float:
    """T1's tolerance on max|kernel - twin| / |twin|. Up to 128 lanes it
    is the JAX test's SCAN_RTOL. Beyond, the kernel and the twin each
    round every one of a row's lanes - 1 products once, with a relative
    error of at most 2**-24, in orders that differ, so they can differ
    by up to about 2 * lanes * 2**-24 (1.55e-5 at 130 lanes, 4.88e-4 at
    4096)."""
    return SCAN_RTOL if lanes <= 128 else 2 * lanes * 2.0 ** -24


def _placed(values: torch.Tensor, offset: str) -> torch.Tensor:
    """``values`` (2-D, on the card) alone, or copied into a view one row
    or one element into a larger buffer: "one element" gives a base that
    is not 16-byte aligned."""
    if offset == "none":
        return values
    skip = values.shape[1] if offset == "one row" else 1
    buffer = torch.empty(values.numel() + skip, dtype=values.dtype,
                         device=values.device)
    view = buffer[skip:].view(values.shape)
    view.copy_(values)
    return view


def _scan_input(rng, rows: int, lanes: int, offset: str):
    """(rows, lanes) f32 on the card, in (0.5, 1) up to 130 lanes and in
    (0.99, 1) beyond, so every product stays a normal float, placed by
    :func:`_placed`."""
    low = 0.5 if lanes <= 130 else 0.99
    return _placed(torch.from_numpy(rng.uniform(low, 1.0, (
        rows, lanes)).astype(np.float32)).cuda(), offset)


def phase_scan():
    """T1's scan kernel against exclusive_cumprod: within SCAN_RTOL at the
    JAX test's (16, 128), at lane counts that are not a multiple of 4 or
    32, at the render batch's (16384, 128) and at views one row and one
    element into a buffer (the scalar path of a 16-byte misaligned base);
    within :func:`scan_rtol` at 130 lanes (a carry across 128-lane
    passes) and 4096 (K3's largest S)."""
    from fourier_feature_nets_torch.kernels.fused_ray_render import (
        exclusive_cumprod_scan)
    from fourier_feature_nets_torch.ops import exclusive_cumprod
    rng = np.random.default_rng(SEED + 4)
    worst = 0.0
    for rows, lanes, offset in ((16, 128, "none"), (1003, 20, "none"),
                                (1003, 45, "none"), (1003, 77, "none"),
                                (RENDER_RAYS, 128, "none"),
                                (1003, 128, "one row"),
                                (1003, 128, "one element"),
                                (1003, 77, "one row"),
                                (1003, 130, "none"), (1003, 4096, "none"),
                                (1003, 4096, "one element")):
        x = _scan_input(rng, rows, lanes, offset)
        before = exclusive_cumprod_scan.launches
        out = exclusive_cumprod_scan(x)
        ref = exclusive_cumprod(x)
        torch.cuda.synchronize()
        rel = ((out - ref).abs() / ref.abs()).max().item()
        if lanes <= 128:
            worst = max(worst, (out - ref).abs().max().item())
        rtol = scan_rtol(lanes)
        ok = rel <= rtol and exclusive_cumprod_scan.launches == before + 1 \
            and bool(torch.isfinite(out).all())
        log(f"  T1 scan ({rows}, {lanes}), offset {offset}: max rel err "
            f"{rel:.3e} (rtol {rtol:.3g}), min |twin| "
            f"{ref.abs().min().item():.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the scan kernel disagrees with "
                                 "exclusive_cumprod")
    x = _scan_input(rng, RENDER_RAYS, 128, "none")
    plain_ms = cuda_ms(lambda: exclusive_cumprod(x), TIME_REPS)
    log(f"  T1 scan ({RENDER_RAYS}, 128): exclusive_cumprod {plain_ms:.4f} "
        f"ms (CUDA events, mean of {TIME_REPS})")
    return {"max_abs_err": worst, "plain_ms": plain_ms,
            "library_call": "torch.cumprod(x, -1), inclusive: one shift "
                            "from the exclusive scan",
            **bound(x.numel(), "f32", 2 * x.numel() * 4)}


def phase_validate():
    """The kernel-validation path: cli/validate_kernels, counts set to 0
    just before and read just after."""
    from fourier_feature_nets_torch.cli import validate_kernels
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        fused_nerf_apply)
    from fourier_feature_nets_torch.kernels.fused_nerf_train import (
        fused_nerf_backward)
    from fourier_feature_nets_torch.kernels.fused_ray_render import (
        exclusive_cumprod_scan, fused_ray_render)
    wrappers = {"fused_nerf": fused_nerf_apply,
                "fused_nerf_train": fused_nerf_backward,
                "fused_ray_render": fused_ray_render,
                "exclusive_cumprod_scan": exclusive_cumprod_scan}
    for wrapper in wrappers.values():
        wrapper.launches = 0
    captured = io.StringIO()
    start = time.perf_counter()
    with contextlib.redirect_stdout(captured):
        rc = validate_kernels.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = {name: w.launches for name, w in wrappers.items()}
    lines = captured.getvalue().strip().splitlines()
    log("\n".join(f"    {line}" for line in lines))
    log(f"validate_kernels: rc {rc}, {wall:.3f} s, launches {launches}")
    if rc != 0 or lines[-1] != "ALL OK":
        raise AssertionError(f"validate_kernels returned {rc}")
    missing = [name for name, count in launches.items() if count <= 0]
    if missing:
        raise AssertionError(f"validate_kernels did not launch {missing}")
    return launches


def _bits_equal(a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def _ints(rng, shape, low, high, dtype):
    return torch.from_numpy(rng.integers(low, high, shape)).to("cuda", dtype)


def phase_int8_probe():
    """P1a-c against their twins at the probe CLI's shapes and ragged
    ones, P1a also with W and h one row and one element into larger
    buffers; P1c timed at the CLI's shape (P1a and P1b by phase_times)."""
    from fourier_feature_nets_torch.kernels import int8_probe as probe
    rng = np.random.default_rng(SEED + 5)
    results = {}
    for (m, k, n), offset in P1A_CASES:
        w = _placed(_ints(rng, (m, k), -127, 128, torch.int8), offset)
        h = _placed(_ints(rng, (k, n), -127, 128, torch.int8), offset)
        before = probe.int8_matmul.launches
        out, twin = probe.int8_matmul(w, h), probe.int8_matmul_reference(w, h)
        torch.cuda.synchronize()
        exact = torch.equal(out, twin) \
            and probe.int8_matmul.launches == before + 1
        err_a = (out - twin).abs().max().item()
        log(f"  P1a int8_matmul ({m}, {k}) @ ({k}, {n}), offset {offset} "
            f"(W base % 16 = {w.data_ptr() % 16}, h base % 16 = "
            f"{h.data_ptr() % 16}): max abs err {err_a} (exact) "
            f"{'ok' if exact else 'FAIL'}")
        if not exact:
            raise AssertionError("P1a disagrees with its plain twin")
        if ((m, k, n), offset) == (P1_GEMM_SHAPES[0], "none"):
            results["int8_matmul"] = {
                "max_abs_err": err_a,
                "plain_ms": cuda_ms(lambda: probe.int8_matmul_reference(
                    w, h), TIME_REPS),
                "library_call": "torch._int_mm(w, h)",
                **bound(2 * m * k * n, "int8", m * k + k * n + 4 * m * n)}
    for m, k, n in P1_GEMM_SHAPES:
        w = _ints(rng, (m, k), -127, 128, torch.int8)
        x = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).cuda()
        outq = probe.quantized_matmul(x, w)
        twinq = probe.quantized_matmul_reference(x, w)
        torch.cuda.synchronize()
        err_b = (outq - twinq).abs().max().item()
        rel_b = err_b / twinq.abs().max().item()
        ok_b = rel_b <= P1B_RTOL
        log(f"  P1b quantized_matmul ({m}, {k}) @ ({k}, {n}): max abs err "
            f"{err_b:.3e}, rel {rel_b:.3e}, bitwise equal "
            f"{_bits_equal(outq, twinq)} (rel <= {P1B_RTOL:g}) "
            f"{'ok' if ok_b else 'FAIL'}")
        if not ok_b:
            raise AssertionError("P1b disagrees with its plain twin")
        if (m, k, n) == P1_GEMM_SHAPES[0]:
            results["quantized_matmul"] = {
                "max_abs_err": err_b,
                "plain_ms": cuda_ms(lambda: probe.quantized_matmul_reference(
                    x, w), TIME_REPS),
                "library_ms": None,
                **bound(2 * m * k * n, "int8",
                        4 * k * n + m * k + 4 * m * n)}
    stack = {}
    for channels, n, layers in P1C_SHAPES:
        for dtype, name in ((torch.bfloat16, "bf16"), (torch.int8, "int8")):
            ws = _ints(rng, (layers, channels, channels), -5, 6, dtype)
            h0 = _ints(rng, (channels, n), 0, 6, dtype)
            out = probe.layer_stack(h0, ws)
            twin = probe.layer_stack_reference(h0, ws)
            torch.cuda.synchronize()
            err = (out - twin).abs().max().item()
            rel = err / twin.abs().max().item()
            if name == "int8":
                ok, stated = torch.equal(out, twin), "exact"
                wraps = int((twin < 0).sum().item())
                stated += f"; {wraps} wrapped negative values"
            else:
                ok = rel <= P1C_BF16_SHARE
                stated = f"rel <= {P1C_BF16_SHARE:g}"
            log(f"  P1c layer_stack {name} C={channels} N={n} L={layers}: "
                f"max abs err {err:.3e}, rel {rel:.3e}, max|twin| "
                f"{twin.abs().max().item():.3e} ({stated}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("P1c disagrees with its plain twin")
            if (channels, n, layers) == P1C_SHAPES[0]:
                size = 1 if name == "int8" else 2
                stack[name] = {
                    "max_abs_err": err, "max_rel_err": rel,
                    "ms": cuda_ms(lambda: probe.layer_stack(h0, ws), 200),
                    "plain_ms": cuda_ms(lambda: probe.layer_stack_reference(
                        h0, ws), 20),
                    **bound(2 * channels * channels * n * layers, name,
                            size * (channels * n + layers * channels ** 2)
                            + 4 * channels * n)}
    results["layer_stack"] = {**stack["int8"], "library_ms": None,
                              **{f"bf16_{k}": v for k, v in
                                 stack["bf16"].items()}}
    for name, row in results.items():
        log(f"  {name}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()))
    return results


def phase_ablation():
    """P2 in each of its seven modes (the five the ablation CLI runs,
    then bf16-accum and no-sincos) against its twin at the ablation
    CLI's points and a ragged N; timed at the CLI's. The CLI's run never
    selects the last two, so this phase is their path: each mode's
    launches here are counted and must be > 0."""
    from fourier_feature_nets_torch.cli.kernel_ablation_bench import (
        ablation_inputs)
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        prepare_fused_nerf)
    from fourier_feature_nets_torch.kernels.fused_nerf_ablation import (
        ALL_MODES, fused_nerf_ablation, fused_nerf_ablation_reference)
    from fourier_feature_nets_torch.models import flagship_nerf
    model = flagship_nerf(torch.Generator().manual_seed(SEED)).cuda()
    weights = prepare_fused_nerf(model, torch.bfloat16)
    cli_points = ablation_inputs(16384, ABLATION_POINTS // 16384, "cuda")
    ragged = random_points(RAGGED_POINTS, np.random.default_rng(SEED + 6),
                           "cuda")
    modes = {}
    with torch.no_grad():
        for mode in ALL_MODES:
            fused_nerf_ablation.launches = 0
            for pos, views in (cli_points, ragged):
                out = fused_nerf_ablation(weights, pos, views, mode)
                twin = fused_nerf_ablation_reference(weights, pos, views,
                                                     mode)
                torch.cuda.synchronize()
                err = (out - twin).abs().max().item()
                ok = torch.isfinite(out).all().item()
                if mode == "bf16-accum":
                    base = fused_nerf_ablation_reference(weights, pos, views,
                                                         "base")
                    mean = (out - twin).abs().mean().item()
                    base_mean = (out - base).abs().mean().item()
                    ok = ok and err <= ACCUM_ATOL \
                        and mean <= ACCUM_MEAN_ATOL < base_mean
                    stated = (f"|d| <= {ACCUM_ATOL}; mean {mean:.3e} <= "
                              f"{ACCUM_MEAN_ATOL}, from base's twin "
                              f"{base_mean:.3e} > {ACCUM_MEAN_ATOL}; the "
                              f"twins max {(twin - base).abs().max():.3e}, "
                              f"mean {(twin - base).abs().mean():.3e} apart")
                else:
                    ok = ok and err <= BF16_ATOL
                    stated = f"|d| <= {BF16_ATOL}"
                log(f"  P2 {mode:12s} N={pos.shape[0]:>7,d}: max abs err "
                    f"{err:.3e} ({stated}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"P2 {mode} disagrees with its twin")
                if pos is cli_points[0]:
                    ms = cuda_ms(lambda: fused_nerf_ablation(
                        weights, pos, views, mode), 10)
                    plain_ms = cuda_ms(lambda: fused_nerf_ablation_reference(
                        weights, pos, views, mode), 5)
                    macs = nerf_macs(weights, no_view=mode == "no-view")
                    modes[mode] = {"max_abs_err": err, "ms": ms,
                                   "plain_ms": plain_ms,
                                   **bound(2 * macs * ABLATION_POINTS, "bf16",
                                           ABLATION_POINTS * 40
                                           + pack_bytes(weights))}
                    log(f"  P2 {mode:12s} N={ABLATION_POINTS:,d}: kernel "
                        f"{ms:.3f} ms, plain twin {plain_ms:.3f} ms, bound "
                        f"{modes[mode]['bound_ms']:.3f} ms (CUDA events, "
                        f"mean of 10 / 5)")
            modes[mode]["launches"] = fused_nerf_ablation.launches
            if modes[mode]["launches"] <= 0:
                raise AssertionError(f"P2 {mode} was never launched")
    return modes


def phase_io_floor():
    """P3a-c bit for bit against their twins at the IO-floor CLI's n
    (both tiles) and a ragged n; their twins timed at the CLI's n (the
    kernels and their library calls by phase_times)."""
    from fourier_feature_nets_torch.kernels import io_floor as io
    rng = np.random.default_rng(SEED + 7)
    results = {}
    for n in (IO_POINTS, RAGGED_POINTS):
        pos, views = (torch.from_numpy(rng.normal(size=(n, 3)).astype(
            np.float32)).cuda() for _ in range(2))
        wide = torch.from_numpy(rng.normal(size=(n, 128)).astype(
            np.float32)).cuda()
        packed = torch.from_numpy(rng.normal(size=(n, 8)).astype(
            np.float32)).cuda()
        cases = [(f"io_narrow t{tile}", lambda tile=tile: io.io_narrow(
                      pos, views, tile),
                  lambda: io.io_narrow_reference(pos, views),
                  lambda: torch.cat([pos, views[:, :1]], -1),
                  "torch.cat([p, v[:, :1]], -1)", 0, 40)
                 for tile in (2048, 4096)]
        cases += [("io_wide", lambda: io.io_wide(wide),
                   lambda: io.io_wide_reference(wide), lambda: wide * 2.0,
                   "x * 2.0", 128, 1024),
                  ("packed8", lambda: io.packed8(packed),
                   lambda: io.packed8_reference(packed), None, None, 4, 64)]
        # per row: multiplies, and bytes read once and written once
        for name, fn, twin, library, call, row_ops, row_bytes in cases:
            out, ref = fn(), twin()
            torch.cuda.synchronize()
            exact = _bits_equal(out, ref)
            log(f"  P3 {name} n={n:,d}: bitwise equal to its twin {exact}")
            if not exact:
                raise AssertionError(f"P3 {name} disagrees with its twin")
            if n == IO_POINTS and name != "io_narrow t4096":
                key = name.split()[0]
                results[key] = {
                    "max_abs_err": (out - ref).abs().max().item(),
                    "plain_ms": cuda_ms(twin, 20),
                    **bound(n * row_ops, "f32", n * row_bytes)}
                if call:
                    results[key]["library_call"] = call
                log(f"  P3 {key} n={n:,d}: " + ", ".join(
                    f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in results[key].items()))
        del pos, views, wide, packed
    torch.cuda.empty_cache()
    return results


def phase_probe_clis():
    """The probes' path: the three CLIs that run P1, P2 and P3 (and K1
    in the IO-floor sweep), each with the counts of its kernels set to 0
    just before it and read just after."""
    from fourier_feature_nets_torch.cli import (int8_probe,
                                                kernel_ablation_bench,
                                                kernel_io_floor_bench)
    from fourier_feature_nets_torch.kernels import fused_nerf_ablation, io_floor
    from fourier_feature_nets_torch.kernels import int8_probe as probe
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        fused_nerf_apply)
    runs = (
        (int8_probe, {"int8_matmul": probe.int8_matmul,
                      "quantized_matmul": probe.quantized_matmul,
                      "layer_stack": probe.layer_stack}),
        (kernel_ablation_bench,
         {"fused_nerf_ablation": fused_nerf_ablation.fused_nerf_ablation}),
        (kernel_io_floor_bench, {"fused_nerf": fused_nerf_apply,
                                 "io_narrow": io_floor.io_narrow,
                                 "io_wide": io_floor.io_wide,
                                 "packed8": io_floor.packed8}))
    launches = {}
    for cli, wrappers in runs:
        name = cli.__name__.rsplit(".", 1)[1]
        for wrapper in wrappers.values():
            wrapper.launches = 0
        captured = io.StringIO()
        start = time.perf_counter()
        with contextlib.redirect_stdout(captured):
            rc = cli.main([])
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        counts = {key: w.launches for key, w in wrappers.items()}
        log("\n".join(f"    {line}" for line in
                      captured.getvalue().strip().splitlines()))
        log(f"{name}: rc {rc}, {wall:.3f} s, launches {counts}")
        missing = [key for key, count in counts.items() if count <= 0]
        if rc != 0 or missing:
            raise AssertionError(f"{name} returned {rc}; no launch of "
                                 f"{missing}")
        launches.update({key: count for key, count in counts.items()
                         if key != "fused_nerf"})
    return launches


def host_step_costs(reps: int = 5000) -> dict:
    """Host microseconds per call of each step a kernel wrapper's launch
    path can take, on the host clock (no synchronise)."""
    from fourier_feature_nets_torch.kernels import int8_probe as probe
    lib = probe.load_kernel().lib
    device = torch.device("cuda", torch.cuda.current_device())
    w = torch.zeros((128, 128), dtype=torch.int8, device=device)
    small = torch.zeros(16, device=device)
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)

    def device_context():
        with torch.cuda.device(device):
            pass

    steps = {
        "ctypes call, 1 int argument": lambda: lib.int8_probe_error_string(0),
        "torch.cuda.current_stream(device).cuda_stream":
            lambda: torch.cuda.current_stream(device).cuda_stream,
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "torch._C._cuda_getCurrentRawStream(index)":
            (lambda: raw(device.index)) if raw else None,
        "torch.cuda.current_device()": torch.cuda.current_device,
        "with torch.cuda.device(device)": device_context,
        "torch.empty((128, 256), int32)": lambda: torch.empty(
            (128, 256), dtype=torch.int32, device=device),
        "tensor.data_ptr()": w.data_ptr,
        "tensor.is_contiguous()": w.is_contiguous,
        "tensor.device": lambda: w.device,
        "tensor.get_device()": w.get_device,
        "torch.add, 16 floats (a whole library call)":
            lambda: torch.add(small, small),
    }
    costs = {}
    for name, fn in steps.items():
        if fn is None:
            costs[name] = None
            continue
        fn()
        start = time.perf_counter()
        for _ in range(reps):
            fn()
        costs[name] = (time.perf_counter() - start) * 1e6 / reps
    torch.cuda.synchronize()
    return costs


def phase_times(flagship: bool) -> dict:
    """:func:`call_times` of the short kernels, P1c, P3b, and the one
    PyTorch call that computes each one's function (P1a and
    ``torch._int_mm``, T1 and ``torch.cumprod``, P3a and ``torch.cat``,
    P3b and ``x * 2.0``; P1b, P1c and P3c have none), at the shapes of
    their paths; with ``flagship``, also K1 (at the frame chunk, the
    train batch and the bench batch), K2 and K3 at the sizes PERF.md
    times them and P2 in each of its modes at the ablation CLI's points
    (CUDA events, FLAGSHIP_REPS calls)."""
    from fourier_feature_nets_torch.kernels import int8_probe as probe
    from fourier_feature_nets_torch.kernels import io_floor as io
    from fourier_feature_nets_torch.kernels.fused_ray_render import (
        exclusive_cumprod_scan)
    rng = np.random.default_rng(SEED + 8)
    rows = {}
    m, k, n = P1_GEMM_SHAPES[0]
    w = _ints(rng, (m, k), -127, 128, torch.int8)
    h = _ints(rng, (k, n), -127, 128, torch.int8)
    x = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).cuda()
    scan_in = torch.from_numpy(rng.uniform(0.5, 1.0, (RENDER_RAYS, 128)).astype(
        np.float32)).cuda()
    pos, views = (torch.from_numpy(rng.normal(size=(IO_POINTS, 3)).astype(
        np.float32)).cuda() for _ in range(2))
    packed = torch.from_numpy(rng.normal(size=(IO_POINTS, 8)).astype(
        np.float32)).cuda()
    wide = torch.from_numpy(rng.normal(size=(IO_POINTS, 128)).astype(
        np.float32)).cuda()
    channels, columns, layers = P1C_SHAPES[0]
    stacks = {name: (_ints(rng, (channels, columns), 0, 6, dtype),
                     _ints(rng, (layers, channels, channels), -5, 6, dtype))
              for name, dtype in (("int8", torch.int8),
                                  ("bf16", torch.bfloat16))}
    cases = [
        ("int8_matmul", lambda: probe.int8_matmul(w, h),
         lambda: torch._int_mm(w, h)),
        ("quantized_matmul", lambda: probe.quantized_matmul(x, w), None),
        ("exclusive_cumprod_scan", lambda: exclusive_cumprod_scan(scan_in),
         lambda: torch.cumprod(scan_in, -1)),
        ("io_narrow", lambda: io.io_narrow(pos, views),
         lambda: torch.cat([pos, views[:, :1]], -1)),
        ("io_narrow_t4096", lambda: io.io_narrow(pos, views, 4096), None),
        ("io_wide", lambda: io.io_wide(wide), lambda: wide * 2.0),
        ("packed8", lambda: io.packed8(packed), None),
        ("layer_stack", lambda: probe.layer_stack(*stacks["int8"]), None),
        ("layer_stack_bf16", lambda: probe.layer_stack(*stacks["bf16"]),
         None)]
    for name, fn, library in cases:
        rows[name] = call_times(fn)
        if library is not None:
            rows[name].update({f"library_{key}": value for key, value in
                               call_times(library).items()})
        log(f"  {name}: " + ", ".join(
            f"{key} {value:.5f}" if isinstance(value, float)
            else f"{key} {value}" for key, value in rows[name].items()))
    del wide
    torch.cuda.empty_cache()
    if not flagship:
        return rows
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        fused_nerf_apply, pack_fused_nerf, prepare_fused_nerf)
    from fourier_feature_nets_torch.kernels.fused_nerf_train import (
        fused_nerf_backward, fused_nerf_train_apply)
    from fourier_feature_nets_torch.kernels.fused_ray_render import (
        fused_ray_render)
    from fourier_feature_nets_torch.models import flagship_nerf
    model = flagship_nerf(torch.Generator().manual_seed(SEED)).cuda()
    packs = {kind: prepare_fused_nerf(model, dtype)
             for dtype, kind in ((torch.bfloat16, "bf16"),
                                 (torch.float32, "f32"))}

    def timed(name, fn):
        rows[name] = cuda_ms(fn, FLAGSHIP_REPS)
        log(f"  {name}: {rows[name]:.4f} ms (CUDA events, mean of "
            f"{FLAGSHIP_REPS})")

    # K1 last: its load must not set the clocks the others are timed at
    with torch.no_grad():
        pos, views = random_points(TRAIN_POINTS, rng, "cuda")
        g = torch.from_numpy(rng.normal(size=(TRAIN_POINTS, 4)).astype(
            np.float32)).cuda()
        rays = render_rays(RENDER_RAYS, 128, rng)
        for kind, weights in packs.items():
            timed(f"fused_nerf_train_{kind}",
                  lambda: fused_nerf_backward(weights, pos, views, g))
            timed(f"fused_ray_render_{kind}",
                  lambda: fused_ray_render(weights, *rays))
        del g, rays
        from fourier_feature_nets_torch.cli.kernel_ablation_bench import (
            ablation_inputs)
        from fourier_feature_nets_torch.kernels import fused_nerf_ablation
        pos, views = ablation_inputs(16384, ABLATION_POINTS // 16384, "cuda")
        for mode in fused_nerf_ablation.ALL_MODES:
            timed(f"fused_nerf_ablation_{mode}",
                  lambda: fused_nerf_ablation.fused_nerf_ablation(
                      packs["bf16"], pos, views, mode))
        for kind, weights in packs.items():
            for num in (CHUNK_POINTS, TRAIN_POINTS, BENCH_POINTS):
                pos, views = random_points(num, rng, "cuda")
                name = (f"fused_nerf_{kind}" if num == BENCH_POINTS
                        else f"fused_nerf_{kind}_n{num}")
                timed(name, lambda: fused_nerf_apply(weights, pos, views))
    del packs
    torch.cuda.empty_cache()
    # the fused part of a bf16 train step: pack (with the slab image),
    # K1 forward and K2 backward through autograd, at the train batch
    pos, views = random_points(TRAIN_POINTS, rng, "cuda")

    def fused_train_core():
        packed = pack_fused_nerf(model, torch.bfloat16)
        fused_nerf_train_apply(packed, pos, views).sum().backward()

    timed("fused_train_core_bf16", fused_train_core)
    # the same core split: the host's time to issue one (host clock, no
    # synchronise) and the device time of the kernels it launches
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(FLAGSHIP_REPS):
        fused_train_core()
    rows["fused_train_core_bf16_host_ms"] = (
        (time.perf_counter() - start) * 1e3 / FLAGSHIP_REPS)
    torch.cuda.synchronize()
    rows["fused_train_core_bf16_device_ms"] = profiler_kernel_ms(
        fused_train_core, FLAGSHIP_REPS)
    log(f"  fused_train_core_bf16: host issue "
        f"{rows['fused_train_core_bf16_host_ms']:.4f} ms, device "
        f"{rows['fused_train_core_bf16_device_ms']} ms a call")
    model.zero_grad(set_to_none=True)
    del model, pos, views
    torch.cuda.empty_cache()
    # whole bf16 train steps through the CLI, fused and plain: its summary's
    # ms/step (CUDA events around each step, validation left out)
    for path, flag in (("fused", "--fused"), ("plain", "--no-fused")):
        rows[f"train_step_bf16_{path}"] = train_step_ms(
            ["--compute-dtype", "bfloat16", flag], TIMED_TRAIN_STEPS, path)
        log(f"  train_step_bf16_{path}: "
            f"{rows[f'train_step_bf16_{path}']:.4f} ms/step over steps "
            f"2..{TIMED_TRAIN_STEPS + 1}")
    return rows


def run_k2_limits(which: str) -> int:
    """--k2-limits: the readings behind K2's bf16 limits, one line each:
    max share and mean share against the twin and against each twin with
    a rounding point moved. At the flagship, four seeds and both N, the
    random, same-sign and tail cotangents as phase_backward_vs_twin builds
    them, the tail also with its points picked from other pools (each
    with the verdict of the tail's checks); at MANY_POINTS, random, and
    random on the quarter of 4 x MANY_POINTS points farthest from the ReLU
    boundaries; at three shallow models, two N and two seeds, the margin
    cotangent (K2_BF16_MARGIN). ``which == "tail"``: the flagship's tail
    lines at K2_BF16_TAIL_POOL alone."""
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        prepare_fused_nerf)
    from fourier_feature_nets_torch.kernels.fused_nerf_train import (
        K2_BF16_CONTROL_MODEL, K2_BF16_MARGIN, K2_BF16_MEAN_SHARE,
        K2_BF16_TAIL_POOL, MOVED_BACKWARD_ROUNDINGS, far_from_relu,
        fused_nerf_backward, fused_nerf_backward_reference, leaf_mean_share,
        relu_margin)
    from fourier_feature_nets_torch.models import NeRF, flagship_nerf
    import fourier_feature_nets_torch
    phase_device()
    log(f"readings of the port in "
        f"{os.path.dirname(fourier_feature_nets_torch.__file__)}")

    def shares(weights, positions, views, g):
        """[(twin, max share, mean share)] of K2 against the twin and
        each moved twin; the max share is the largest per leaf."""
        out = fused_nerf_backward(weights, positions, views, g)
        rows = []
        for moved in (None, *MOVED_BACKWARD_ROUNDINGS):
            twin = fused_nerf_backward_reference(weights, positions, views, g,
                                                 moved)
            rows.append((moved or "twin", leaf_max_share(weights, out, twin),
                         leaf_mean_share(weights, out, twin)))
        return rows

    def text(rows):
        return "; ".join(f"{name} max {worst:.2e} mean {mean:.2e}"
                         for name, worst, mean in rows)

    flagship = prepare_fused_nerf(
        flagship_nerf(torch.Generator().manual_seed(SEED)).cuda(),
        torch.bfloat16)
    pools = ((K2_BF16_TAIL_POOL,) if which == "tail"
             else (K2_BF16_TAIL_POOL, 1, 16, 256))
    for seed in (SEED + 1, 11, 12, 13):
        for pool in pools:
            # at K2_BF16_TAIL_POOL and seed 1: the inputs of
            # phase_backward_vs_twin
            rng = np.random.default_rng(seed)
            for num in (TRAIN_POINTS, RAGGED_POINTS):
                positions, views = random_points(num, rng, "cuda")
                gs, least = backward_cotangents(flagship, positions, views,
                                                rng, pool)
                keys = ("tail",)
                if pool == K2_BF16_TAIL_POOL and which == "all":
                    keys = ("random", "same-sign", "tail")
                for key in keys:
                    rows = shares(flagship, positions, views, gs[key])
                    verdict = ""
                    if key == "tail":
                        bad = (rows[0][1] > GRAD_SHARE["tail"]["bfloat16"]
                               or rows[0][2] > K2_BF16_MEAN_SHARE)
                        verdict = (f", pool {pool} a point, margin >= "
                                   f"{least:.2e}; tail check: "
                                   + ("FAIL" if bad else "pass"))
                    log(f"flagship seed {seed} N={num:,d} {key}{verdict}: "
                        + text(rows))
    if which == "tail":
        return 0
    for seed in (SEED + 1, 11, 12, 13):
        rng = np.random.default_rng(seed)
        positions, views = random_points(MANY_POINTS, rng, "cuda")
        g = torch.from_numpy(rng.normal(size=(MANY_POINTS, 4)).astype(
            np.float32)).cuda()
        log(f"flagship seed {seed} N={MANY_POINTS:,d} random: "
            + text(shares(flagship, positions, views, g)))
        positions, views, least = far_from_relu(
            flagship, MANY_POINTS, 4 * MANY_POINTS,
            lambda n: random_points(n, rng, "cuda"))
        log(f"flagship seed {seed} N={MANY_POINTS:,d} random, the quarter "
            f"farthest from a boundary (margin >= {least:.2e}): "
            + text(shares(flagship, positions, views, g)))
    del flagship
    shallow = {"3x256": K2_BF16_CONTROL_MODEL,
               "4x64": dict(num_layers=4, num_channels=64, skips=[2],
                            include_inputs=True, max_log_scale_pos=9.0,
                            num_freq_pos=10, max_log_scale_view=3.0,
                            num_freq_view=4),
               "3x96": dict(K2_BF16_CONTROL_MODEL, num_channels=96,
                            include_inputs=False)}
    for name, config in shallow.items():
        weights = prepare_fused_nerf(
            NeRF(**config, generator=torch.Generator().manual_seed(
                SEED + 1)).cuda(), torch.bfloat16)
        for seed in (SEED + 2, 21):
            rng = np.random.default_rng(seed)
            for num in (3001, CONTROL_POINTS):
                positions, views = random_points(num, rng, "cuda")
                g = torch.from_numpy(rng.normal(size=(num, 4)).astype(
                    np.float32)).cuda()
                far = relu_margin(weights, positions, views) \
                    >= K2_BF16_MARGIN
                log(f"{name} seed {seed} N={num:,d} margin, "
                    f"{int(far.sum())} points: " + text(shares(
                        weights, positions, views,
                        torch.where(far[:, None], g, 0.0))))
    return 0


def run_times(tree: str) -> int:
    """--times-only: the step-1 timings of the port found in ``tree``,
    as one JSON line, so that two checkouts can be timed in turns."""
    name = phase_device()
    log(f"times of the port in {os.path.abspath(tree)}")
    costs = host_step_costs()
    for step, cost in costs.items():
        log(f"  host: {step}: " + (f"{cost:.3f} us" if cost is not None
                                   else "not available"))
    rows = phase_times(flagship=True)
    print(json.dumps({"tree": os.path.abspath(tree), "device": name,
                      "host_step_us": costs, "times": rows}))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Smoke run of the PyTorch port on one NVIDIA GPU")
    parser.add_argument("--times-only", action="store_true",
                        help="only time the short kernels, their library "
                             "calls and K1-K3 (one JSON line)")
    parser.add_argument("--k2-limits", nargs="?", const="all",
                        choices=("all", "tail"),
                        help="only print the readings behind K2's bf16 "
                             "limits (tail: the flagship's tail alone)")
    parser.add_argument("--tree", default=ROOT,
                        help="with --times-only or --k2-limits: import the "
                             "port from this checkout (e.g. an unpacked "
                             "parent commit)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on a GPU only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.k2_limits or args.times_only:
        sys.path.insert(0, os.path.abspath(args.tree))
    if args.k2_limits:
        return run_k2_limits(args.k2_limits)
    if args.times_only:
        return run_times(args.tree)
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        prepare_fused_nerf)
    from fourier_feature_nets_torch.models import flagship_nerf

    name = phase_device()
    model = flagship_nerf(torch.Generator().manual_seed(SEED)).cuda()
    packs = {dtype: prepare_fused_nerf(model, dtype)
             for dtype in (torch.bfloat16, torch.float32)}
    bounds = flagship_bounds(packs)
    del packs
    results = phase_kernel_vs_twin(model)
    launches = phase_orbit(model)
    frame = phase_frame_profile(model)
    phase_fused_vs_plain(model)
    log("K2 vs plain twin, flagship:")
    backward = phase_backward_vs_twin(model)
    log("K2 bf16's limit against a moved rounding point:")
    backward["bfloat16"]["control"] = phase_backward_control()
    del model
    torch.cuda.empty_cache()
    step_ms, train_launches, checkpoint = phase_train()
    log("train ms/step over steps 2.." + str(TRAIN_STEPS + 1) + ": "
        + ", ".join(f"{k} {v:.3f}" for k, v in step_ms.items()))
    phase_render_trained(checkpoint)
    model = flagship_nerf(torch.Generator().manual_seed(SEED)).cuda()
    log("K3 vs plain twin, flagship:")
    phase_ray_render_vs_twin(model)
    render = phase_ray_render_timing(model)
    del model
    torch.cuda.empty_cache()
    scan = phase_scan()
    validate_launches = phase_validate()
    log("P1, the int8 probe's kernels, vs plain twins:")
    probe = phase_int8_probe()
    log("P2, the ablation kernel, vs plain twin, flagship bf16:")
    ablation = phase_ablation()
    log("P3, the IO-floor copy kernels, vs plain twins:")
    io_rows = phase_io_floor()
    log("the short kernels and their library calls: wrapper ms (CUDA events "
        f"over {TIME_REPS} calls), device ms ({GRAPH_CALLS} calls replayed "
        f"from a CUDA graph), host us (host clock over {TIME_REPS} calls):")
    times = phase_times(flagship=False)
    scan = with_times(scan, times["exclusive_cumprod_scan"])
    for key in ("int8_matmul", "quantized_matmul"):
        probe[key] = with_times(probe[key], times[key])
    for key in ("io_narrow", "io_wide", "packed8"):
        io_rows[key] = with_times(io_rows[key], times[key])
    io_rows["io_narrow"].update(
        t4096_ms=times["io_narrow_t4096"]["wrapper_ms"],
        t4096_device_ms=times["io_narrow_t4096"]["device_ms"])
    stack = probe["layer_stack"]
    probe["layer_stack"] = with_times(stack, times["layer_stack"])
    probe["layer_stack"].update(
        bf16_ms=stack["bf16_ms"],
        bf16_device_ms=times["layer_stack_bf16"]["device_ms"],
        bf16_host_us=times["layer_stack_bf16"]["host_us"])
    log("the probes' path: their three CLIs")
    probe_launches = phase_probe_clis()

    bf16 = results[torch.bfloat16]
    f32 = results[torch.float32]
    print(json.dumps({"kernels": [{
        "name": "fused_nerf",
        "route": "cuda",
        "source": "fourier_feature_nets_torch/kernels/csrc/fused_nerf.cu",
        "replaces": "fourier_feature_nets_tpu/ops/fused_nerf.py:323",
        "launches": launches,
        "max_abs_err": bf16["max_abs_err"],
        "ms": bf16["times"][BENCH_POINTS][0],
        "plain_ms": bf16["times"][BENCH_POINTS][1],
        **bounds["fused_nerf"]["bf16"],
        "library_ms": None,
        "shape": f"N={BENCH_POINTS} (ms); n<N>_ms at each timed N; f32 "
                 f"(f32_*)",
        **{f"n{num}_{key}": bf16["times"][num][i]
           for num in K1_TIMED_POINTS
           for i, key in enumerate(("ms", "plain_ms"))},
        "mean_abs_err": bf16["mean_abs_err"],
        "moved_rounding_min_mean_abs_err":
            bf16["moved_rounding_min_mean_abs_err"],
        "slab_image_ms": bf16["slab_image_ms"],
        "f32_bound_ms": bounds["fused_nerf"]["f32"]["bound_ms"],
        "f32_max_abs_err": f32["max_abs_err"],
        "f32_ms": f32["times"][BENCH_POINTS][0],
        "f32_plain_ms": f32["times"][BENCH_POINTS][1],
        **{f"f32_n{num}_{key}": f32["times"][num][i]
           for num in K1_TIMED_POINTS
           for i, key in enumerate(("ms", "plain_ms"))},
        "frame_profile": frame,
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
        **bounds["fused_nerf_train"]["bf16"],
        "library_ms": None,
        "shape": f"N={TRAIN_POINTS} (ms) and f32 (f32_*)",
        "f32_bound_ms": bounds["fused_nerf_train"]["f32"]["bound_ms"],
        "f32_max_abs_err": backward["float32"]["max_abs_err"],
        "f32_ms": backward["float32"]["ms"],
        "f32_plain_ms": backward["float32"]["plain_ms"],
        "max_rel_err_by_cotangent": backward["bfloat16"]["max_rel_err"],
        "f32_max_rel_err_by_cotangent": backward["float32"]["max_rel_err"],
        "bitwise_equal": backward["bfloat16"]["bitwise_equal"],
        "moved_rounding_control": {
            "margin_3x256": backward["bfloat16"]["control"],
            "flagship": backward["bfloat16"]["flagship_control"]},
        "train_ms_per_step": step_ms,
    }, {
        "name": "fused_ray_render",
        "route": "cuda",
        "source": "fourier_feature_nets_torch/kernels/csrc/"
                  "fused_ray_render.cu",
        "replaces": "fourier_feature_nets_tpu/ops/fused_ray_render.py:82",
        "launches": validate_launches["fused_ray_render"],
        "max_abs_err": render[("bfloat16", 128)]["max_abs_err"],
        "ms": render[("bfloat16", 128)]["ms"],
        "plain_ms": render[("bfloat16", 128)]["plain_ms"],
        **bounds["fused_ray_render"]["bf16"],
        "library_ms": None,
        "shape": f"R={RENDER_RAYS} S=128 (ms) and S=48 (s48_*)",
        "f32_bound_ms": bounds["fused_ray_render"]["f32"]["bound_ms"],
        "s48_bound_ms": bounds["fused_ray_render"]["bf16_s48"]["bound_ms"],
        "k1_composite_ms": render[("bfloat16", 128)]["k1_composite_ms"],
        "f32_max_abs_err": render[("float32", 128)]["max_abs_err"],
        "f32_ms": render[("float32", 128)]["ms"],
        "f32_plain_ms": render[("float32", 128)]["plain_ms"],
        "f32_k1_composite_ms": render[("float32", 128)]["k1_composite_ms"],
        "s48_ms": render[("bfloat16", 48)]["ms"],
        "s48_plain_ms": render[("bfloat16", 48)]["plain_ms"],
        "s48_k1_composite_ms": render[("bfloat16", 48)]["k1_composite_ms"],
        "s48_f32_ms": render[("float32", 48)]["ms"],
        "s48_f32_plain_ms": render[("float32", 48)]["plain_ms"],
        "s48_f32_k1_composite_ms":
            render[("float32", 48)]["k1_composite_ms"],
        "validate_launches": validate_launches,
    }, {
        "name": "exclusive_cumprod_scan",
        "route": "cuda",
        "source": "fourier_feature_nets_torch/kernels/csrc/"
                  "fused_ray_render.cu",
        "replaces": "tests/test_fused_ray_render.py:26",
        "launches": validate_launches["exclusive_cumprod_scan"],
        **scan,
        "shape": f"({RENDER_RAYS}, 128)",
    }] + [{
        "name": key,
        "route": "cuda",
        "source": f"fourier_feature_nets_torch/kernels/csrc/{source}",
        "replaces": replaces,
        **row,
        "launches": probe_launches[key],   # the CLIs' path, not a mode's
    } for key, source, replaces, row in (
        ("int8_matmul", "int8_probe.cu", "tools/int8_probe.py:31",
         probe["int8_matmul"]),
        ("quantized_matmul", "int8_probe.cu", "tools/int8_probe.py:63",
         probe["quantized_matmul"]),
        ("layer_stack", "int8_probe.cu", "tools/int8_probe.py:99",
         probe["layer_stack"]),
        ("fused_nerf_ablation", "fused_nerf_ablation.cu",
         "tools/kernel_ablation_bench.py:50",
         {**ablation["base"], "library_ms": None,
          "max_abs_err": max(m["max_abs_err"] for m in ablation.values()),
          "shape": f"N={ABLATION_POINTS}, bf16; ms is base, modes below",
          "modes": ablation}),
        ("io_narrow", "io_floor.cu", "tools/kernel_io_floor_bench.py:142",
         io_rows["io_narrow"]),
        ("io_wide", "io_floor.cu", "tools/kernel_io_floor_bench.py:165",
         io_rows["io_wide"]),
        ("packed8", "io_floor.cu", "tools/kernel_io_floor_bench.py:185",
         io_rows["packed8"]))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
