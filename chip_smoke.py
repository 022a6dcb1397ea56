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
  rounding point moved must fail, in f32 (3xTF32 products) within the
  JAX suite's rtol / atol and K1_F32_MEAN_ATOL, which the twin on single
  tf32 products (``allow_tf32=True``) must fail; each type's slab image
  (bytes, build time); three 800x800 ``--preset
  fast`` frames of a seeded random flagship NeRF through
  ``orbit_video``, which must go through K1; a ``torch.profiler`` split
  of one such frame by kernel; a low-resolution fused render against
  the plain render;
* the empty-space paths: two 800x800 frames at ``orbit_video``'s
  defaults (focus sampling, the model its own opacity model, 128
  samples, bf16), the opacity sweep timed apart; bench.py's seeded tree
  built by the port's C++ library and saved, then ``orbit_video
  --octree`` at 32 samples, 3 frames in occupancy mode and 1 in
  traversal mode, the torch traversal on the card held to the C++
  tracer on the host for one frame chunk's rays (leaves equal, t within
  1e-5 + 1e-6 |t|), that chunk profiled for the traversal's share of its
  device time, and a 200px occupancy frame through K1 within +-1 of the
  plain bf16 frame; each path must launch K1;
* training: K2 against its plain twin in bf16 and f32 at the CLI batch
  (1024 rays x 128 samples) and a ragged N, and in bf16 within
  ``fused_nerf_train.K2_BF16_MEAN_SHARE`` under the tail cotangent there
  and under a margin cotangent at 3x256, a limit each twin with a
  rounding point moved must fail, as the twin with dz left in f32 must
  fail the same-sign limit; in f32 the twin on single tf32 products must
  fail the tail or the same-sign limit; K2 bf16 alone at the CLI batch
  at 8x256 and 6x192, each pass's device time (the recompute-backward,
  the dW kernel, the sum), the bound and the dW kernel's launches a call
  (one); 30 steps of ``train_nerf``
  on the generated ``synthetic`` scene in bf16 and f32, ``--fused``
  (through K1 and K2, which must both launch) and ``--no-fused``, then
  at the CLI's defaults (f32, no fused flag), which must train the path
  ``render/raycaster.py::resolve_fused`` gives (fused: K1 and K2 must
  launch; plain: neither); the trained checkpoint then renders an
  800x800 frame through ``orbit_video``, and ``voxelize_model --fused``
  (K1 must launch) makes a tree of it (at a lower ``--alpha-threshold``,
  logged, if the checkpoint has no surface above 0.3), which renders an
  ``--octree`` frame;
* training's left-overs and early termination: ``train_nerf
  --steps-per-call 8 --fused`` in bf16 and f32 for 32 steps, each chunk
  one CUDA-graph replay: the capture must record one K1 and one K2
  launch a step and ``torch.profiler`` must name both kernels 8 times in
  one more replay (the wrappers' counts do not see a replay; their
  launches there are the captured launches times the replays); one
  chunk of the plain f32 step against the same steps run eagerly
  (rtol 1e-5 / atol 1e-6 on every weight) and of the fused bf16 step
  (K2's atomics: each leaf's mean |d| within 5e-2 of its mean update);
  ``--checkpoint-interval 10`` to step 20, then
  ``--resume --steps-per-call 5`` to step 30, with the optimizer state
  copied onto the card equal to the file; occupancy-guided training
  refreshing its grid twice in place under one captured chunk; and
  ``orbit_video --preset quality`` of the random and of the trained
  checkpoint at 800x800 for 3 frames beside ``--preset fast``: K1 must
  launch in both passes, and frame 0 with early termination must lie
  within ceil(255 * 1e-2) + 1 of the frame without it; each of these
  phases prints its time;
* pose frames, serving and distillation: the stride-2 culled frames'
  rays that the occupancy probe's hit flag, conservative at cell faces,
  adds to the plain gather's on the smoke-render and smoke-octree rigs
  (none dropped), with the probe's and the frame's ms; pose frames of
  the random flagship at 800x800 ``--preset fast`` (a rig camera's pose
  equals its indexed frame bit for bit, a novel pose a sampler built
  around it; both timed; one focus pose frame with its CDF sweep); 2
  frames of ``orbit_video --chunked`` within +-1 of ``render_frame``;
  K1 and K2 at the 6x192 student's width against their twins, timed
  beside their bounds, then ``distill_model --fused`` of the 30-step
  checkpoint into 6x192 (1024 x 128, chunks of 100 steps, each one
  CUDA-graph replay that must record K1 for teacher and student and K2
  every step) to step 200, whose loss must fall, ``--resume`` to step
  300, and one fused step against the plain f32 step, from the fresh
  student held in each leaf's mean, from the step-200 checkpoint logged;
  that student served at 800x800
  ``--preset fast`` by ``RenderServer`` on an ephemeral port (raw frame
  = ``render_frame``, PNG = raw, a well-formed JPEG, ``/pose`` of a rig
  camera = ``/frame``, a 16-frame stream, 4 concurrent streams,
  ``/stats``, the JPEG encoder's ms) and by ``cli.serve`` as a process
  (one request, then SIGTERM); K1 must launch on every served and pose
  frame;
* the FFN family, the voxel fields and the regression CLIs, on which no
  kernel runs (the fused kernels take a NeRF only): ``train_tiny_nerf``
  on smoke-train's scene, positional and gaussian at the CLI's widths (3
  x 256, embedding 256, 128 samples, 1024 rays), 200 steps each, val
  PSNR rising by more than 1 dB, K1 and K2 launching 0 times, then
  ``orbit_video --preset fast`` of the positional checkpoint (two
  800x800 frames, well formed and not constant); ``train_voxels`` (a
  dense 128^3 grid at 256 samples for 1000 steps and a rank-16
  factorized field for 200, val PSNR rising by more than 1 dB; each
  again at ``--steps-per-call 8``, one CUDA graph a chunk) and
  ``train_tiny_nerf --opacity-model`` of the dense grid;
  ``train_image_regression synthetic:512`` gaussian and positional at
  the CLI's defaults for 200 steps (PSNR rising, ``superres.png``
  1024x1024); ``train_signal_regression multifreq --fourier --no-plot``
  (val loss falling); ``convert_checkpoint`` NPZ -> .pt -> NPZ
  bit-equal for each type with a .pt format (a factorized field's must
  raise); and each model type (the flagship NeRF, both FFNs, the grid,
  the factorized field) on 65,536 points on the card against the same
  module on the CPU within the JAX suite's f32 rtol / atol and within
  rtol = atol = 1e-5, which the MLPs with TF32 products break (the
  control); one train
  step of each new cell under ``torch.profiler`` (its top kernels); each
  with its ms a step or forward, and the card's name and power limit;
* queue 1, item 7: ``--make-video`` of ``train_nerf`` (flagship, bf16,
  ``--fused``, 40 steps: 5 orbit frames at the JAX cadence, through K1),
  ``train_voxels`` and ``train_tiny_nerf`` (no kernel); one
  ``ComparisonVisualizer`` strip of the 30-step checkpoint (through K1);
  ``distill_model --fused`` of the dense 128^3 voxel grid into 6x192 in
  100-step graph chunks (the loss falls; each capture records the
  student's K1 and K2 alone); ``export_mesh`` of a voxel ball at 192^3
  (radii within one ball cell), the card's mesh at 64^3 equal to the
  CPU's within 1e-5, and the 8x256 field sweep at 192^3 timed with its
  peak memory; a two-run ``sweep`` of ``train_signal_regression``
  processes sharing the card; ``inspect_ray_sampling`` plain and
  stratified-focused; bench.py's tree at 800 px in ``trilinear`` and
  ``probe_mode="gather"`` (gather's hit set within the default's, each
  culled frame within 1 of its unculled frame where it renders), a
  focus frame and batch with ``FFN_TORCH_IID_FOCUS_QUANTILES``; a NaN
  weight that raises under ``enable_debug_nans`` and not without it, and
  whether a graph captures under it;
* queue 1, item 7, sub-items 8-12: ``orbit_video --preset fast --mp4``
  (K1 renders the frames; every MP4 sample is the port's JPEG of its PNG
  byte for byte and the port's decoder reads it back within
  MP4_MIN_PSNR; encode and decode timed on the host), ``near_orbit``,
  ``train_image_regression --make-video`` and
  ``train_signal_regression --make-video`` (which must raise naming
  matplotlib where it is missing); ``PixelDataset`` from a ``.jpg`` and
  a few image-regression steps on it, a 512px decode timed;
  ``view_angle_animation`` of the trained checkpoint (its depth through
  K1); the three ``to_scenepic`` entry points raising ``ImportError``;
  then a one-rank NCCL mesh (``MASTER_ADDR=127.0.0.1``, a free port):
  fused bf16 flagship steps under it and without it, eager and in a
  CUDA-graph chunk that captures the all-reduce, losses within
  MESH_LOSS_RTOL and ms a step side by side, ``train_nerf
  --data-parallel --steps-per-call``, a culled frame under the mesh
  within 1 of the frame without it, and ``serve --data-parallel`` as a
  process answering a few requests; the group stays up for
  ``validate_kernels``, whose two mesh checks must print OK;
* kernel validation: K3 (K1's kernels with a per-ray view product and a
  compositing epilogue) against its plain twin in bf16 and f32 within
  its limits (kernels/fused_ray_render.py: bf16 max K3_BF16_ATOL and
  mean K3_BF16_MEAN_ATOL, which the twin with its view product
  unrounded must fail; f32 the JAX suite's rtol / atol and mean
  K3_F32_MEAN_ATOL, which the twin on single tf32 products must fail)
  at S = 2, 42, 48, 128 and 4096, a ragged R, a case where only the last
  ray group carries signal and a 32-wide model, one CUDA graph replay,
  and against the plain render; T1's scan against
  ``exclusive_cumprod`` (up to 128 lanes within SCAN_RTOL, at 130 and
  4096 within ``scan_rtol``, and at bases one row and one element into
  a buffer); K3, its twin and K1 followed by ``_composite`` timed at
  16384 rays x 48 and x 128 samples, and K3 at the validate CLI's own
  launches; then ``cli/validate_kernels``, which must launch K1, K2, K3
  and the scan, print its two mesh checks OK (under the one-rank NCCL
  group) and end in ``ALL OK``;
* the probes: P1a and P1b (both also with their operands one row and
  one element into larger buffers, P1b once more from a CUDA graph
  replay), P1c in int8 and P3a-c bit for bit against their
  twins, P1c in bf16 within a stated share (with the blocks and clusters
  its launch takes), P2 (K1's own kernels in an ablation mode) in each
  of its seven modes in bf16 (the ablation CLI's five, bf16-accum and
  no-sincos) and six in f32, within K1's tolerances (bf16-accum within
  ACCUM_ATOL and ACCUM_MEAN_ATOL, and farther than that from base's
  twin) and base equal to K1 bit for bit, each mode timed between two
  timings of K1 at the same N (K1's split), at their CLIs' shapes and
  ragged ones, each timed beside its bound (and, where one PyTorch call
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
error, time, its plain twin's time, bound and library time; K1 also with
its launches on each path, ``launches_by_path``; the short kernels also
with ``device_ms``, ``library_device_ms`` and ``host_us``)
and ``{"ok": true, "device": ...}``.

``--k2-limits [all|tail] [--tree DIR]`` prints only the readings behind
K2's bf16 limits: its random, same-sign, tail and margin shares against
the twin and against each twin with a rounding point moved, over several
seeds, sizes and models (``tail``: the flagship's tail lines alone), for
the port found in ``DIR``.

``--times-only [--tree DIR]`` prints only those three times for the
kernels of the last item, the host cost of each launch-path step, K2 and
K3 at their PERF.md sizes, P2 in each of its modes in both types between
two timings of K1 at the same N, then K1 at its PERF.md sizes (the K1-like
loads last, since they set the clocks), the fused core of a
train step and whole ``train_nerf`` steps, fused and plain, each in bf16
and f32, as one JSON line, for the port found in ``DIR`` (an unpacked
parent commit, say), so that two trees can be timed in turns on one
card.

``--train-turns`` prints only the ms per step of ``train_nerf`` at
``--steps-per-call`` 8 against 1 (turns 1 8 8 1 in one process), fused
and plain, in bf16 and f32, with the host's ms to issue a call, as one
JSON line.

``--sass DIR`` prints only the SASS instruction count of each kernel of
``fused_nerf.cu``, ``fused_nerf_ablation.cu`` and ``fused_nerf_train.cu``
(K1, P2, K2) in ``DIR`` and in this checkout, and whether the two are
identical (``nvcc -cubin``, ``cuobjdump -sass``): the check that a
change to the shared kernels leaves their code as it was.

Needs one CUDA device; on a machine without one it exits with code 2.
Outputs go to ``smoke_out/`` inside the checkout.
"""

import argparse
import concurrent.futures
import contextlib
import importlib
import io
import json
import os
import re
import shutil
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
# K1 f32 (3xTF32 products) against its twin: |d| <= F32_ATOL + F32_RTOL |ref|
# and mean |d| <= K1_F32_MEAN_ATOL. Its control is the twin on single tf32
# products (allow_tf32=True), which must fail them; it passes the first (max
# 1.0e-4 to 1.8e-4 against the twin), so the mean limit tells them apart.
# Readings, at the flagship (N = 100,003 to 2,097,152) and at 4x64, 2x32 and
# 3x96 (N = 63 to 4,099), H100 80GB HBM3, 700 W: the kernel mean 2.5e-8 to
# 4.1e-8 (max 6e-8 to 2.4e-7), the single-tf32 twin 1.31e-5 to 2.7e-5. So
# 1e-6: 24x above the one, 13x below the other.
K1_F32_MEAN_ATOL = 1e-6
# K2 vs its twin, per gradient leaf and cotangent: max|kernel - twin| <=
# GRAD_SHARE * max|twin|. Readings at the flagship on an H100 80GB HBM3 at
# 700 W, N = 131,072 / 100,003 (bf16 and f32, the wgmma kernels; f32 also
# the twin on single tf32 products, which must fail the tail or the
# same-sign limit and read past all four); ``--k2-limits`` reads bf16 at
# four seeds and both N:
# * random: N(0, 1); each gradient is a cancelling sum that grows like
#   sqrt(N), so a few terms that differ stand out: ReLU-mask flips. K2 and
#   the twin sum each pre-activation in another order (in bf16, K2's sums
#   are K1's wgmma chains and the twin's are f32 GEMMs), and one within
#   rounding of 0 takes the other side of the mask in each (in f32, with
#   the FFMA tile the kernel had, zeroing the cotangent of the 180 points
#   within 1e-7 of a boundary took 1.04e-2 to 5.6e-6). In bf16 most flips
#   follow a bf16 activation that rounds one step apart in the two, which
#   no f32 sum order of the twin removes. (bf16 5.9e-3 to 1.6e-2 over the
#   seeds, 5.0e-3 to 6.7e-3 at 262,143 points; f32 5.2e-3 / 6.4e-3, the
#   single-tf32 twin 3.5e-2 / 4.7e-2.)
# * margin (f32): random with the cotangent zeroed on the ~2% of points that
#   have a pre-activation within MARGIN of 0 (relu_margin); with the flips
#   gone, what is left is rounding. (1.29e-5 / 1.27e-5; the single-tf32
#   twin 3.4e-2 / 4.7e-2.)
# * same-sign: all ones, so the sums do not cancel. A twin with dz left in
#   f32 (SAME_SIGN_CATCHES) must fail it. (bf16 6.4e-5 to 9.7e-5, that twin
#   2.52e-3 to 2.55e-3: the limit 5.2x above the one and 5.0x below the
#   other; f32 4.3e-5 / 4.8e-5, the single-tf32 twin 7.3e-4 / 8.1e-4.)
# * tail: random on the last GROUP points (at N = 100,003 the ragged last
#   tile, 35 points) and on one other GROUP, zero elsewhere: those points make
#   up the whole gradient, so a dropped or mis-masked tile cannot hide. Over
#   256 points one ReLU flip is ~1/16 of a leaf, so in bf16 each of those
#   points is, of K2_BF16_TAIL_POOL drawn for it, the one farthest from every
#   ReLU boundary (fused_nerf_train.far_from_relu; each then lies >= 3.5e-4
#   from one). With no pick, one seed's N = 131,072 read 1.13e-2; points only
#   1e-5 from a boundary still flipped (4.4e-2, 1.4e-2 in two pairs of
#   eight). (bf16
#   4.7e-4 to 1.3e-3 over the seeds; f32 1.16e-5 / 1.24e-5, the single-tf32
#   twin 0.216 / 0.202.) In bf16 the tail also carries the mean-share
#   control below.
# A K2 bf16 that skips the ragged tile fails tail at N = 100,003 in all four
# seeds (max share >= 0.83), one that drops its last point's cotangent at
# both N (>= 4.1e-2); in f32 those two and one that rounds dz to bf16
# failed tail with the FFMA tile (PR 2; not run on the 3xTF32 kernel).
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
RAGGED_RAYS = 1001             # not a multiple of any ray group
PLAIN_RENDER_ATOL = 5e-3       # tools/validate_kernels_tpu.py:167-170
SCAN_RTOL = 1e-5               # tests/test_fused_ray_render.py:31
TRAIN_STEPS = 30
CHUNK_STEPS = 8                # --steps-per-call of the chunk phases
CHUNK_TRAIN_STEPS = 32         # four chunks
TURN_STEPS = 64                # --train-turns: steps a timed train_nerf run
CHUNK_MEAN_SHARE = 5e-2        # a fused graph chunk vs the eager steps, per
                               # leaf: mean |d| over its mean update
FRAME_RES = 800                # the focus, octree and voxelize phases' frames
TIMED_TRAIN_STEPS = 100   # --times-only: whole train steps a path
SEED = 0
# The probes, at the shapes of their CLIs (the JAX tools') and ragged ones.
P1_GEMM_SHAPES = ((128, 128, 256), (100, 72, 250))     # (M, K, N)
P1A_CASES = tuple((shape, offset) for shape in P1_GEMM_SHAPES
                  for offset in ("none", "one row", "one element"))
# (C, N, layers): the CLI's, a ragged N, the ring that streams (bf16 at C =
# 256) and the smallest
P1C_SHAPES = ((192, 2048, 8), (192, 1000, 8), (256, 2048, 8), (16, 65, 1))
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
# "tf32x3": the f32 kernels' 3xTF32 products, three tf32 products (495
# TFLOP/s dense) for each f32 one.
PEAK = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12,
        "tf32x3": 494.7e12 / 3}
HBM_BYTES_PER_S = 3.35e12
TIME_REPS = 200      # back-to-back calls for wrapper ms and host us
GRAPH_CALLS = 100    # calls captured in one CUDA graph for device ms
GRAPH_REPLAYS = 10
FLAGSHIP_REPS = 10   # K1, K2, K3 calls (milliseconds each) per timing
CARD = ""            # the card's name and power limit (phase_device)


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


def k1_f32_within(out, ref) -> bool:
    """K1 f32's limits against its twin."""
    err = (out - ref).abs()
    return bool((err <= F32_ATOL + F32_RTOL * ref.abs()).all()) \
        and err.mean().item() <= K1_F32_MEAN_ATOL


@contextlib.contextmanager
def single_tf32():
    """PyTorch's f32 matrix products on single tf32 products
    (allow_tf32=True) inside, full f32 again after."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


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
    positions, views, logits; also at CHUNK_POINTS and TRAIN_POINTS);
    K2 at TRAIN_POINTS, three times K1's products (the recompute, then
    the products for dX and dW), 40 B a point (positions, views,
    cotangents) and f32 gradients the size of the pack; K3 at
    RENDER_RAYS x 128 and x 48, its view rows once per ray, 16 B a
    sample (position, depth) and 28 B a ray. An f32 pack's K1, K2 and
    K3 have two: f32 FFMA ("f32") and 3xTF32 on the tensor cores
    ("tf32x3"), the rate their products run at."""
    bounds = {"fused_nerf": {}, "fused_nerf_train": {},
              "fused_ray_render": {}}
    for dtype, pack in packs.items():
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        weights = pack_bytes(pack)
        grads = (pack.weights.numel() + pack.biases.numel()) * 4
        macs = nerf_macs(pack)
        # K1 and K2 in f32 also on the tensor cores, at 3xTF32 (the heads'
        # few operations counted there too)
        for peak in ((kind, "tf32x3") if kind == "f32" else (kind,)):
            key = kind if peak == kind else peak
            bounds["fused_nerf"][key] = bound(
                2 * macs * BENCH_POINTS, peak, 40 * BENCH_POINTS + weights)
            bounds["fused_nerf"][f"{key}_n{CHUNK_POINTS}"] = bound(
                2 * macs * CHUNK_POINTS, peak, 40 * CHUNK_POINTS + weights)
            bounds["fused_nerf"][f"{key}_n{TRAIN_POINTS}"] = bound(
                2 * macs * TRAIN_POINTS, peak, 40 * TRAIN_POINTS + weights)
            bounds["fused_nerf_train"][key] = bound(
                3 * 2 * macs * TRAIN_POINTS, peak,
                40 * TRAIN_POINTS + weights + grads)
        # K3 in f32 also at 3xTF32, the rate its products run at
        for peak in ((kind, "tf32x3") if kind == "f32" else (kind,)):
            prefix = kind if peak == kind else peak
            for samples, key in ((128, prefix), (48, f"{prefix}_s48")):
                points = RENDER_RAYS * samples
                bounds["fused_ray_render"][key] = bound(
                    2 * nerf_macs(pack, view_once_per=samples) * points, peak,
                    16 * points + 28 * RENDER_RAYS + weights)
    return bounds


def random_points(num: int, rng: np.random.Generator, device):
    positions = rng.uniform(-1.0, 1.0, (num, 3)).astype(np.float32)
    views = rng.normal(size=(num, 3)).astype(np.float32)
    views /= np.linalg.norm(views, axis=-1, keepdims=True)
    return (torch.from_numpy(positions).to(device),
            torch.from_numpy(views).to(device))


def png_pixels(data: bytes) -> np.ndarray:
    """The (H, W, 3) pixels of an 8-bit RGB, filter-0 PNG (the port's
    writer), read with ``zlib``."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    width, height, depth, color = struct.unpack(">IIBB", data[16:26])
    if (depth, color) != (8, 2):
        raise AssertionError("not an 8-bit RGB PNG")
    idat, pos = b"", 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        height, 1 + 3 * width)
    if rows[:, 0].any():
        raise AssertionError("a PNG row with a filter")
    return rows[:, 1:].reshape(height, width, 3)


def png_shape(path: str):
    """(height, width, channels) and the largest pixel value of an
    8-bit RGB PNG, with the pixel data decompressed to check it is
    complete."""
    with open(path, "rb") as handle:
        pixels = png_pixels(handle.read())
    return pixels.shape, int(pixels.max())


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
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    log(CARD)
    return name


def phase_kernel_vs_twin(model):
    """K1 against its plain twin at the bench shape, the main path's
    chunk shape, the train batch and a ragged N; timed beside the twin
    at the first three. In bf16 also against the twin with each of its
    rounding points moved, which the limits must reject."""
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        MOVED_ROUNDINGS, f32_slab_image, fused_nerf_apply,
        fused_nerf_reference, prepare_fused_nerf, slab_image)
    log("kernel vs plain twin: torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} (the twin's f32 GEMMs "
        "are full f32)")
    rng = np.random.default_rng(SEED)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        weights = prepare_fused_nerf(model, dtype)
        name = str(dtype)[6:]
        row = {"times": {}}
        shapes = [tuple(w.shape) for w, _ in weights.layers]
        offsets = weights.meta[8:8 + len(shapes)]
        image = slab_image if dtype == torch.bfloat16 else f32_slab_image
        row["slab_image_bytes"] = (weights.slabs.numel()
                                   * weights.slabs.element_size())
        row["slab_image_ms"] = cuda_ms(
            lambda: image(weights.weights, shapes, offsets), 20)
        log(f"  {name} slab image: {row['slab_image_bytes']:,d} bytes "
            + ("(streamed once a 128-point tile)" if dtype == torch.bfloat16
               else "(tf32 hi and lo: K1 streams its forward part once a "
                    "128-point tile, K2 all but the heads once a 64-point "
                    "tile)")
            + f"; built with every pack in {row['slab_image_ms']:.4f} ms "
              f"(CUDA events, mean of 20)")
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
                ok = k1_f32_within(out, ref)
                stated = (f"|d| <= {F32_ATOL} + {F32_RTOL}|ref|, mean |d| <= "
                          f"{K1_F32_MEAN_ATOL}")
                # the control: the twin on single tf32 products must fail
                with torch.no_grad(), single_tf32():
                    one = fused_nerf_reference(weights, positions, views)
                d = (one - ref).abs()
                log(f"  float32  N={num:>9,d}: the twin on single tf32 "
                    f"products (allow_tf32=True) against the twin: max "
                    f"{d.max().item():.3e}, mean {d.mean().item():.3e}")
                if k1_f32_within(one, ref):
                    raise AssertionError("K1's f32 limits pass the twin on "
                                         "single tf32 products")
                low = row.setdefault("single_tf32_min", [np.inf, np.inf])
                low[0] = min(low[0], d.max().item())
                low[1] = min(low[1], d.mean().item())
                del one, d
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


def run_orbit(checkpoint: str, frames_dir: str, resolution: int, flags):
    """cli/orbit_video into an emptied ``frames_dir``; returns (its
    standard output, K1's launches, the wall seconds of the call). Raises
    unless it exits 0."""
    from fourier_feature_nets_torch.cli import orbit_video
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        fused_nerf_apply)
    if os.path.isdir(frames_dir):
        for name in os.listdir(frames_dir):
            os.remove(os.path.join(frames_dir, name))
    captured = io.StringIO()
    fused_nerf_apply.launches = 0
    start = time.perf_counter()
    with contextlib.redirect_stdout(captured):
        rc = orbit_video.main([checkpoint, str(resolution), frames_dir,
                               *flags])
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = fused_nerf_apply.launches
    output = captured.getvalue()
    if rc != 0:
        raise AssertionError(f"orbit_video {flags} returned {rc}:\n"
                             f"{output[-2000:]}")
    return output, launches, wall


def check_frames(frames_dir: str, count: int, resolution: int):
    """``count`` PNGs of resolution x resolution x 3 with a non-zero
    peak each."""
    names = sorted(os.listdir(frames_dir))
    if names != [f"frame_{i:05d}.png" for i in range(count)]:
        raise AssertionError(f"unexpected frames: {names}")
    for name in names:
        shape, peak = png_shape(os.path.join(frames_dir, name))
        if shape != (resolution, resolution, 3) or peak == 0:
            raise AssertionError(f"{name}: shape {shape}, max pixel {peak}")


def orbit_summary(output: str) -> dict:
    """The sampler set-up seconds and frame milliseconds of
    cli/orbit_video's summary line."""
    found = re.search(r"sampler set-up ([0-9.]+) s, first frame ([0-9.]+) "
                      r"ms, (?:([0-9.]+) ms/frame|no later frames)", output)
    if found is None:
        raise AssertionError(f"no orbit_video summary in:\n{output[-2000:]}")
    steady = found.group(3)
    return {"setup_s": float(found.group(1)),
            "first_frame_ms": float(found.group(2)),
            "steady_frame_ms": None if steady is None else float(steady)}


def phase_focus_orbit():
    """The CLI's default sampler: focus sampling with the model as its
    own opacity model, 128 samples, bf16 (K1), two 800x800 frames."""
    checkpoint = os.path.join(OUT_DIR, "flagship_seed0.npz")
    frames_dir = os.path.join(OUT_DIR, "focus_frames")
    torch.cuda.reset_peak_memory_stats()
    output, launches, wall = run_orbit(
        checkpoint, frames_dir, FRAME_RES,
        ["--compute-dtype", "bfloat16", "--num-frames", "2"])
    check_frames(frames_dir, 2, FRAME_RES)
    times = orbit_summary(output)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"orbit_video (focus sampling, 128 samples, bf16): 2 PNG frames of "
        f"{FRAME_RES}x{FRAME_RES}, {wall:.3f} s for the CLI call; the "
        f"opacity sweep (CDFs of {2 * FRAME_RES ** 2} rays x 64 points, f32 "
        f"plain) {times['setup_s']:.3f} "
        f"s; frames {times['first_frame_ms']:.3f} ms then "
        f"{times['steady_frame_ms']:.3f} ms; peak device memory "
        f"{peak_gb:.2f} GB; K1 launches {launches}")
    if launches <= 0:
        raise AssertionError("the focus orbit did not launch K1")
    return {"launches": launches, "wall_s": wall, "peak_gb": peak_gb,
            **times}


def _profile_device_ms(fn):
    """(wall ms, device ms summed over kernels) of one call of ``fn``
    under torch.profiler, after a warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    device_us = sum(getattr(event, "self_device_time_total",
                            getattr(event, "self_cuda_time_total", 0.0))
                    for event in prof.key_averages()
                    if event.device_type == DeviceType.CUDA)
    return wall_ms, device_us / 1e3


def phase_octree_orbit(model):
    """bench.py's headline tree (its seeded cloud, depth 6, leaves of 2
    points or more), built by the port's C++ library and saved as NPZ,
    then orbit_video --octree at 800x800, 32 samples, bf16: 3 frames in
    occupancy mode and 1 in traversal mode. The torch traversal on the
    card is held to the C++ tracer on the host for one frame chunk's
    rays; an occupancy frame at 200 px through K1 is held to the same
    frame through the plain model in bf16; one traversal-mode chunk is
    profiled for the traversal's share of its device time."""
    from fourier_feature_nets_torch.cameras import Resolution
    from fourier_feature_nets_torch.cli import orbit_video
    from fourier_feature_nets_torch.octree import OcTree
    from fourier_feature_nets_torch.octree.traversal import (
        device_batch_intersect)
    from fourier_feature_nets_torch.render import Raycaster
    from fourier_feature_nets_torch.utils import orbit

    rng = np.random.default_rng(1)
    cloud = np.concatenate([rng.normal([0.2, 0.0, 0.0], 0.2, (20000, 3)),
                            [[-1, -1, -1], [1, 1, 1]]]).astype(np.float32)
    start = time.perf_counter()
    tree = OcTree.build_from_samples(cloud, depth=6, min_leaf_size=2)
    build_s = time.perf_counter() - start
    tree_path = os.path.join(OUT_DIR, "bench_tree.npz")
    tree.save(tree_path)
    log(f"octree of bench.py's cloud (g++ build and C++ BFS): "
        f"{tree.num_leaves} leaves, depth {tree.depth}, {build_s:.3f} s")
    checkpoint = os.path.join(OUT_DIR, "flagship_seed0.npz")
    result = {"leaves": tree.num_leaves, "build_s": build_s}
    for mode, frames in (("occupancy", 3), ("traversal", 1)):
        frames_dir = os.path.join(OUT_DIR, f"octree_{mode}_frames")
        output, launches, wall = run_orbit(
            checkpoint, frames_dir, FRAME_RES,
            ["--octree", tree_path, "--octree-mode", mode, "--num-samples",
             "32", "--compute-dtype", "bfloat16", "--num-frames",
             str(frames)])
        check_frames(frames_dir, frames, FRAME_RES)
        times = orbit_summary(output)
        steady = times["steady_frame_ms"]
        log(f"orbit_video --octree ({mode}, 32 samples, bf16): {frames} PNG "
            f"frames of {FRAME_RES}x{FRAME_RES}, {wall:.3f} s for the CLI "
            f"call; sampler "
            f"set-up {times['setup_s']:.3f} s; first frame "
            f"{times['first_frame_ms']:.3f} ms"
            + (f", {steady:.3f} ms a steady frame" if steady else "")
            + f"; K1 launches {launches}")
        if launches <= 0:
            raise AssertionError(f"the {mode} octree orbit did not "
                                 f"launch K1")
        result[mode] = {"launches": launches, "wall_s": wall, **times}

    device = next(model.parameters()).device
    args = orbit_video._parse_args(["m.npz", str(FRAME_RES), OUT_DIR,
                                    "--octree",
                                    tree_path, "--octree-mode", "traversal",
                                    "--num-samples", "32", "--num-frames",
                                    "1"])
    bounds = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
    cameras = orbit(orbit_video.VECTORS[args.up_dir],
                    orbit_video.VECTORS[args.forward_dir], 1,
                    args.fov_y_degrees, Resolution(FRAME_RES, FRAME_RES),
                    args.distance)
    sampler = orbit_video.build_render_sampler(args, model, cameras, bounds)
    chunk = min(args.batch_size * 4, FRAME_RES ** 2)
    # the chunk through the middle of the frame, where the tree is
    middle = FRAME_RES ** 2 // 2
    offsets = torch.arange(middle - chunk // 2, middle + chunk // 2,
                           device=device)
    starts, dirs, _, _, _ = sampler.camera_ray_geometry(0, offsets)
    path = device_batch_intersect(
        sampler._node_index, sampler._leaf_index, starts, dirs,
        scale=tree.scale, max_depth=tree.depth,
        max_length=sampler.max_length)
    host = tree.intersect(starts.cpu().numpy(), dirs.cpu().numpy(),
                          sampler.max_length)
    leaves = path.leaves.cpu().numpy()
    t_err = np.abs(path.t_stops.cpu().numpy() - host.t_stops)
    t_bound = 1e-5 + 1e-6 * np.abs(host.t_stops)
    log(f"torch traversal on the card vs the C++ tracer on the host, "
        f"{chunk} rays x {sampler.max_length} slots: leaves equal "
        f"{bool(np.array_equal(leaves, host.leaves))} ({int((leaves >= 0).sum())}"
        f" leaf slots), max |dt| {float(t_err.max()):.3e} (bound 1e-5 + "
        f"1e-6 |t|)")
    if not np.array_equal(leaves, host.leaves) or (t_err > t_bound).any():
        raise AssertionError("the torch traversal disagrees with the C++ "
                             "tracer")
    if not (leaves >= 0).any():
        raise AssertionError("the checked chunk crossed no leaf")

    caster = Raycaster(model, compute_dtype=torch.bfloat16)

    def render_chunk():
        rays, _ = sampler.sample_camera_rays(0, offsets)
        return caster.render(rays).color

    def traverse_chunk():
        return device_batch_intersect(
            sampler._node_index, sampler._leaf_index, starts, dirs,
            scale=tree.scale, max_depth=tree.depth,
            max_length=sampler.max_length)

    chunk_wall, chunk_device = _profile_device_ms(render_chunk)
    trav_wall, trav_device = _profile_device_ms(traverse_chunk)
    log(f"one traversal-mode chunk ({chunk} rays, 32 samples) under "
        f"torch.profiler: {chunk_wall:.3f} ms wall, {chunk_device:.3f} ms "
        f"device; its traversal alone {trav_wall:.3f} ms wall, "
        f"{trav_device:.3f} ms device: {trav_device / chunk_device:.1%} of "
        f"the chunk's device time, {trav_wall / chunk_wall:.1%} of its wall")
    result["traversal_chunk"] = {
        "rays": chunk, "wall_ms": chunk_wall, "device_ms": chunk_device,
        "traversal_wall_ms": trav_wall, "traversal_device_ms": trav_device,
        "traversal_device_share": trav_device / chunk_device}

    from fourier_feature_nets_torch.render import OccupancyGridSampler
    small = orbit(orbit_video.VECTORS[args.up_dir],
                  orbit_video.VECTORS[args.forward_dir], 3,
                  args.fov_y_degrees, Resolution(200, 200), args.distance)
    occupancy = OccupancyGridSampler.from_tree(tree, small, 32,
                                               bounds=bounds, device=device)
    fused = Raycaster(model, compute_dtype=torch.bfloat16, fused=True)
    plain = Raycaster(model, compute_dtype=torch.bfloat16, fused=False)
    a = fused.render_frame(occupancy, 1).astype(np.int32)
    b = plain.render_frame(occupancy, 1).astype(np.int32)
    diff = np.abs(a - b)
    share = float((diff <= 1).mean())
    log(f"occupancy-octree frame, 200x200, 32 samples, bf16, K1 vs plain: "
        f"{share:.6f} of uint8 values within +-1, max diff {int(diff.max())}")
    if a.shape != (200, 200, 3) or not a.any() or diff.max() > 1:
        raise AssertionError("the fused octree frame disagrees with the "
                             "plain one")
    result["fused_vs_plain_200px"] = {"share_within_1": share,
                                      "max_diff": int(diff.max())}
    return result


def phase_voxelize(checkpoint):
    """voxelize_model --fused on the trained checkpoint and the
    synthetic scene it trained on (K1 f32 in its surface sweep), then
    one --octree frame from the tree it wrote."""
    from fourier_feature_nets_torch.cli import voxelize_model
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        fused_nerf_apply)
    from fourier_feature_nets_torch.octree import OcTree

    tree_path = os.path.join(OUT_DIR, "voxelized.npz")
    result = {}
    for threshold in ("0.3", "0.1", "0.02"):
        if os.path.exists(tree_path):
            os.remove(tree_path)
        captured = io.StringIO()
        fused_nerf_apply.launches = 0
        start = time.perf_counter()
        with contextlib.redirect_stdout(captured):
            rc = voxelize_model.main([checkpoint, "synthetic", tree_path,
                                      "--fused", "--alpha-threshold",
                                      threshold])
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        output = captured.getvalue()
        launches = fused_nerf_apply.launches
        log("\n".join(f"    {line}" for line in output.splitlines()))
        log(f"voxelize_model --fused --alpha-threshold {threshold}: exit "
            f"{rc}, {wall:.3f} s for the CLI call, K1 launches {launches}")
        if launches <= 0:
            raise AssertionError("voxelize_model did not launch K1")
        if rc == 0:
            break
        if "no surface points" not in output:
            raise AssertionError(f"voxelize_model returned {rc}")
        log(f"  no surface point of the {TRAIN_STEPS}-step checkpoint has "
            f"alpha above {threshold}: the sweep runs again with a lower "
            f"threshold")
    if rc != 0:
        raise AssertionError(f"voxelize_model returned {rc} at every "
                             f"threshold")
    tree = OcTree.load(tree_path)
    if tree.num_leaves <= 0:
        raise AssertionError("voxelize_model wrote a tree without leaves")
    result.update(launches=launches, wall_s=wall, threshold=float(threshold),
                  leaves=tree.num_leaves, depth=tree.depth)
    frames_dir = os.path.join(OUT_DIR, "voxelized_frame")
    output, frame_launches, _ = run_orbit(
        checkpoint, frames_dir, FRAME_RES,
        ["--octree", tree_path, "--num-samples", "32", "--compute-dtype",
         "bfloat16", "--num-frames", "1"])
    shape, peak = png_shape(os.path.join(frames_dir, "frame_00000.png"))
    log(f"tree of {tree.num_leaves} leaves (depth {tree.depth}); its "
        f"orbit_video --octree frame: {shape}, max pixel {peak}, K1 "
        f"launches {frame_launches}")
    if shape != (FRAME_RES, FRAME_RES, 3) or frame_launches <= 0:
        raise AssertionError("the voxelized tree did not render")
    result["octree_frame_launches"] = frame_launches
    return result


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
    control = {"bfloat16": {}, "float32": {}}
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
                control[name][num] = {
                    "same-sign": same_sign_control(
                        weights, positions, views, gs["same-sign"],
                        f"flagship N={num:,d}"),
                    "tail": mean_share_control(
                        weights, positions, views, gs["tail"],
                        f"flagship N={num:,d}, tail cotangent")}
            else:
                control[name][num] = single_tf32_control(
                    weights, positions, views, gs, num)
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
    results["bfloat16"]["flagship_control"] = control["bfloat16"]
    results["float32"]["single_tf32_control"] = control["float32"]
    return results


# K2 bf16's kernels by name: the recompute-backward (pass 1), the split-K
# dW kernel (pass 2) and the fixed-order sum
K2_PASSES = {"pass1": "fused_nerf_backward_bf16_kernel",
             "dw": "fused_nerf_backward_dw_bf16_kernel",
             "sum": "fused_nerf_backward_sum_kernel"}


def k2_pass_times(weights, positions, views, g) -> dict:
    """K2 bf16 alone on these inputs: its time (CUDA events, mean of
    FLAGSHIP_REPS calls), each pass's device time a call from the
    profiler by kernel name, the dW kernel's launches a call
    (``fused_nerf_backward.dw_launches``) and the bound (three forwards a
    point; positions, views, cotangents, the pack and its f32
    gradients)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from fourier_feature_nets_torch.kernels.fused_nerf_train import (
        fused_nerf_backward)
    num = positions.shape[0]

    def call():
        return fused_nerf_backward(weights, positions, views, g)

    ms = cuda_ms(call, FLAGSHIP_REPS)
    before = fused_nerf_backward.dw_launches
    call()
    dw_launches = fused_nerf_backward.dw_launches - before
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(FLAGSHIP_REPS):
            call()
        torch.cuda.synchronize()
    device = dict.fromkeys(K2_PASSES, 0.0)
    for event in prof.key_averages():
        if event.device_type != DeviceType.CUDA:
            continue
        for key, name in K2_PASSES.items():
            if name + "<" in event.key or event.key.endswith(name) \
                    or name + "(" in event.key:
                device[key] += getattr(
                    event, "self_device_time_total",
                    getattr(event, "self_cuda_time_total", 0.0))
    grads = (weights.weights.numel() + weights.biases.numel()) * 4
    return {"ms": ms, "dw_launches": dw_launches,
            **{f"{key}_device_ms": us / FLAGSHIP_REPS / 1e3
               for key, us in device.items()},
            **bound(3 * 2 * nerf_macs(weights) * num, "bf16",
                    40 * num + pack_bytes(weights) + grads)}


def phase_k2_passes(model) -> dict:
    """K2 bf16 alone at TRAIN_POINTS at the flagship's width and the
    serving student's (6x192), split by pass (k2_pass_times); the dW
    kernel must launch once a call at this N."""
    from fourier_feature_nets_torch.cli.common import RECOMMENDED_STUDENT
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        prepare_fused_nerf)
    from fourier_feature_nets_torch.models import NeRF
    layers, channels = RECOMMENDED_STUDENT
    student = NeRF(layers, channels, 9.0, 10, 3.0, 4, [layers // 2], True,
                   generator=torch.Generator().manual_seed(SEED)).cuda()
    rng = np.random.default_rng(SEED + 5)
    positions, views = random_points(TRAIN_POINTS, rng, "cuda")
    g = torch.from_numpy(rng.normal(size=(TRAIN_POINTS, 4)).astype(
        np.float32)).cuda()
    rows = {}
    for label, net in (("8x256", model), (f"{layers}x{channels}", student)):
        weights = prepare_fused_nerf(net, torch.bfloat16)
        row = k2_pass_times(weights, positions, views, g)
        log(f"  K2 bf16 {label} N={TRAIN_POINTS:,d}: {row['ms']:.4f} ms "
            f"(CUDA events, mean of {FLAGSHIP_REPS}); device ms a call: pass "
            f"1 {row['pass1_device_ms']:.4f}, dW {row['dw_device_ms']:.4f}, "
            f"sum {row['sum_device_ms']:.4f}; bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}); dW launches a call {row['dw_launches']}")
        if row["dw_launches"] != 1:
            raise AssertionError(f"K2 bf16 {label}: {row['dw_launches']} dW "
                                 f"launches a call at N={TRAIN_POINTS:,d}")
        rows[label] = row
        del weights
    return rows


def single_tf32_control(weights, positions, views, gs, num) -> dict:
    """K2 f32's limits against the twin on single tf32 products
    (allow_tf32=True), which no f32 path runs: logs, per cotangent, the
    largest per-leaf max share of that twin against the twin beside the
    kernel's, and raises unless at least the tail or the same-sign limit
    fails it."""
    from fourier_feature_nets_torch.kernels.fused_nerf_train import (
        fused_nerf_backward, fused_nerf_backward_reference)
    readings = {}
    for key, g in gs.items():
        out = fused_nerf_backward(weights, positions, views, g)
        twin = fused_nerf_backward_reference(weights, positions, views, g)
        with single_tf32():
            one = fused_nerf_backward_reference(weights, positions, views, g)
        readings[key] = {"kernel": leaf_max_share(weights, out, twin),
                         "single_tf32": leaf_max_share(weights, one, twin)}
    log(f"  float32  N={num:>7,d}: largest per-leaf max share, kernel / twin "
        f"on single tf32 products: " + ", ".join(
            f"{key} {r['kernel']:.3e} / {r['single_tf32']:.3e}"
            + (" (fails)" if r["single_tf32"] > GRAD_SHARE[key]["float32"]
               else "") for key, r in readings.items()))
    if not any(readings[key]["single_tf32"] > GRAD_SHARE[key]["float32"]
               for key in ("tail", "same-sign")):
        raise AssertionError("K2's f32 tail and same-sign limits pass the "
                             "twin on single tf32 products")
    return readings


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
    defaults (f32, no fused flag), which must train the path
    ``resolve_fused`` gives a NeRF on CUDA in f32."""
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        fused_nerf_apply)
    from fourier_feature_nets_torch.kernels.fused_nerf_train import (
        fused_nerf_backward)
    from fourier_feature_nets_torch.render.raycaster import resolve_fused
    step_ms, launches, checkpoint = {}, {"fused_nerf": 0,
                                         "fused_nerf_train": 0}, None
    runs = [(f"{dtype}, {'fused' if fused else 'plain'}",
             ["--compute-dtype", dtype, "--fused" if fused else "--no-fused"],
             fused)
            for dtype in ("bfloat16", "float32") for fused in (True, False)]
    runs.append(("float32, defaults", [],
                 resolve_fused(None, True, torch.float32)))
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


# ---------------------------------------------------------------------------
# training's left-overs and early termination
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _instances(cls):
    """Collects every instance of ``cls`` built inside the block (the
    CLIs build their raycasters and graph chunks themselves)."""
    made, init = [], cls.__init__

    def collecting(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    cls.__init__ = collecting
    try:
        yield made
    finally:
        cls.__init__ = init


def run_train_cli(results: str, flags):
    """cli/train_nerf on the generated synthetic scene; returns (its
    standard output, the raycaster it built, the graph chunks it
    captured). Raises unless it exits 0."""
    from fourier_feature_nets_torch.cli import train_nerf
    from fourier_feature_nets_torch.render import raycaster
    os.environ["FFN_TORCH_DATA_DIR"] = os.path.join(OUT_DIR, "data")
    captured = io.StringIO()
    with _instances(raycaster.Raycaster) as casters, \
            _instances(raycaster._GraphChunk) as chunks, \
            contextlib.redirect_stdout(captured):
        rc = train_nerf.main(["synthetic", results, *flags])
    torch.cuda.synchronize()
    output = captured.getvalue()
    if rc != 0:
        raise AssertionError(f"train_nerf {flags} returned {rc}:\n"
                             f"{output[-2000:]}")
    return output, casters[-1], chunks


def _launch_counts():
    from fourier_feature_nets_torch.render.raycaster import _kernel_launches
    return _kernel_launches()


def _reset_launches():
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        fused_nerf_apply)
    from fourier_feature_nets_torch.kernels.fused_nerf_train import (
        fused_nerf_backward)
    fused_nerf_apply.launches = 0
    fused_nerf_backward.launches = 0


def replay_kernel_names(chunk) -> dict:
    """The device kernels ``torch.profiler`` records in one more replay
    of a graph chunk: {name: count}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        chunk.graph.replay()
        torch.cuda.synchronize()
    return {event.key: event.count for event in prof.key_averages()
            if event.device_type == DeviceType.CUDA}


def _steady_ms_per_step(caster, first: int = 1, last=None) -> float:
    """Mean ms a step over calls ``first``..``last`` of a fit."""
    pairs = list(zip(caster.step_ms, caster.call_steps))[first:last]
    return (sum(ms * n for ms, n in pairs) / sum(n for _, n in pairs))


def phase_train_chunks() -> dict:
    """``train_nerf synthetic --steps-per-call 8 --fused`` in bf16 and
    f32 for 32 steps: each chunk is one CUDA-graph replay, so the
    wrappers' counts do not see it. K1 and K2 run in it if the capture
    recorded one launch of each a step (the counts during capture) and
    the profiler names both kernels in one more replay; their launches
    in the replays are the captured launches times the replays. Then
    one chunk of the plain f32 step against the same 8 steps run
    eagerly (rtol 1e-5 / atol 1e-6 on every weight), and one chunk of
    the fused bf16 step against the same steps run eagerly (each leaf's
    mean |d| within CHUNK_MEAN_SHARE of its mean update)."""
    rows = {}
    kernel = {"bfloat16": ("fused_nerf_bf16_kernel",
                           "fused_nerf_backward_bf16_kernel"),
              "float32": ("fused_nerf_tf32_kernel",
                          "fused_nerf_backward_tf32_kernel")}
    for dtype in ("bfloat16", "float32"):
        _reset_launches()
        start = time.perf_counter()
        output, caster, chunks = run_train_cli(
            os.path.join(OUT_DIR, "train_chunks", dtype),
            ["--compute-dtype", dtype, "--fused", "--steps-per-call",
             str(CHUNK_STEPS), "--num-steps", str(CHUNK_TRAIN_STEPS - 1),
             "--report-interval", "16", "--image-interval", "0"])
        wall = time.perf_counter() - start
        eager = _launch_counts()
        if len(chunks) != 1:
            raise AssertionError(f"{dtype}: {len(chunks)} graph chunks")
        chunk = chunks[0]
        names = replay_kernel_names(chunk)
        found = [sum(n for name, n in names.items() if symbol in name)
                 for symbol in kernel[dtype]]
        row = {
            "wall_s": wall,
            "calls": len(caster.call_steps),
            "steps": sum(caster.call_steps),
            "captures": chunk.captures,
            "replays": chunk.replays,
            "captured_launches": chunk.captured,
            "launches_in_replays": {name: count * chunk.replays
                                    for name, count in chunk.captured.items()},
            "eager_launches": eager,
            "profiled_replay_kernels": dict(zip(("fused_nerf",
                                                 "fused_nerf_train"), found)),
            "first_call_ms": caster.step_ms[0] * caster.call_steps[0],
            "ms_per_step": _steady_ms_per_step(caster),
            "host_ms_per_call": float(np.mean(caster.host_ms[1:])),
        }
        rows[dtype] = row
        log(f"train_nerf --steps-per-call {CHUNK_STEPS} --fused, {dtype}: "
            f"{row['steps']} steps in {row['calls']} calls, {wall:.3f} s "
            f"for the CLI call; first call (warm-up and capture) "
            f"{row['first_call_ms']:.3f} ms, then {row['ms_per_step']:.3f} "
            f"ms/step, host {row['host_ms_per_call']:.3f} ms a call; "
            f"{row['captures']} capture, {row['replays']} replays; launches "
            f"captured a chunk {chunk.captured}, in the replays "
            f"{row['launches_in_replays']}, eager (warm-up, validation) "
            f"{eager}; the profiler names K1 x{found[0]} and K2 x{found[1]} "
            f"in one replay")
        if chunk.captures != 1 or chunk.replays != CHUNK_TRAIN_STEPS \
                // CHUNK_STEPS:
            raise AssertionError(f"{dtype}: {chunk.captures} captures, "
                                 f"{chunk.replays} replays")
        if any(chunk.captured[name] != CHUNK_STEPS
               for name in ("fused_nerf", "fused_nerf_train")):
            raise AssertionError(f"{dtype}: the graph captured "
                                 f"{chunk.captured} launches, not one of "
                                 f"K1 and K2 a step")
        if found != [CHUNK_STEPS, CHUNK_STEPS]:
            raise AssertionError(f"{dtype}: one replay ran K1 x{found[0]} "
                                 f"and K2 x{found[1]}; the profiler saw "
                                 f"{sorted(names)[:12]}")
    rows["eager_vs_graph"] = {
        "float32_plain": chunk_vs_eager(torch.float32, False),
        "bfloat16_fused": chunk_vs_eager(torch.bfloat16, True)}
    return rows


def chunk_vs_eager(dtype, fused: bool) -> dict:
    """One graph chunk of CHUNK_STEPS steps against the same steps run
    eagerly, from the same weights, on the synthetic scene at the CLI's
    batch: the largest |d| of each weight leaf and its share of the
    leaf's largest update, and the mean |d| over the mean update. The
    plain f32 step must agree within rtol 1e-5 / atol 1e-6; the fused
    step differs by K2's atomics and is held in the mean, within
    CHUNK_MEAN_SHARE."""
    from fourier_feature_nets_torch.cli import common
    from fourier_feature_nets_torch.datasets import ImageDataset
    from fourier_feature_nets_torch.models import flagship_nerf
    from fourier_feature_nets_torch.render import Raycaster
    from fourier_feature_nets_torch.utils.optim import ClippedAdam
    os.environ["FFN_TORCH_DATA_DIR"] = os.path.join(OUT_DIR, "data")
    path = common.resolve_data_path("synthetic", "cuda")
    dataset = ImageDataset.load(path, "train", 128, True, True,
                                device="cuda", num_anneal_steps=2000)
    perm = torch.from_numpy(dataset.index_pool()).cuda()
    perm = perm[torch.randperm(len(perm), generator=torch.Generator()
                               .manual_seed(SEED)).cuda()]
    models, losses = [], []
    for graph in (True, False):
        model = flagship_nerf(torch.Generator().manual_seed(SEED)).cuda()
        caster = Raycaster(model, compute_dtype=(
            dtype if dtype == torch.bfloat16 else None), fused=fused,
            fused_train=fused)
        optimizer = ClippedAdam(model.parameters(), 5e-4, capturable=True)
        if graph:
            step = caster._make_train_step(dataset, 1024, 5e-4, 0.1, 250000,
                                           optimizer, CHUNK_STEPS)
            loss = step(perm, 7 * 1024, 40, 1234)
        else:
            step = caster._make_train_step(dataset, 1024, 5e-4, 0.1, 250000,
                                           optimizer)
            modulo = max(perm.shape[0] - 1024 + 1, 1)
            for k in range(CHUNK_STEPS):
                loss = step(perm, (7 * 1024 + k * 1024) % modulo, 40 + k,
                            1234)
        torch.cuda.synchronize()
        models.append(model)
        losses.append(float(loss))
    start = flagship_nerf(torch.Generator().manual_seed(SEED))
    worst_abs, worst_share, worst_mean, within = 0.0, 0.0, 0.0, True
    for (name, a), (_, b), (_, s) in zip(models[0].named_parameters(),
                                         models[1].named_parameters(),
                                         start.named_parameters()):
        a, b = a.detach().cpu(), b.detach().cpu()
        diff = (a - b).abs()
        update = (b - s.detach()).abs()
        worst_abs = max(worst_abs, float(diff.max()))
        worst_share = max(worst_share,
                          float(diff.max()) / max(float(update.max()), 1e-30))
        worst_mean = max(worst_mean, float(diff.mean())
                         / max(float(update.mean()), 1e-30))
        within &= bool((diff <= 1e-6 + 1e-5 * b.abs()).all())
    label = f"{'fused' if fused else 'plain'} {str(dtype)[6:]}"
    log(f"one graph chunk of {CHUNK_STEPS} steps vs the same steps eager "
        f"({label}): max |d weight| {worst_abs:.3e}, at most "
        f"{worst_share:.3e} of a leaf's largest update, mean |d| at most "
        f"{worst_mean:.3e} of a leaf's mean update; last loss "
        f"{losses[0]:.6f} vs {losses[1]:.6f}; within rtol 1e-5 / atol "
        f"1e-6: {within}")
    if not fused and not within:
        raise AssertionError(f"the plain graph chunk left the eager steps "
                             f"by {worst_abs:.3e}")
    # K2's atomics move the gradients' last bits, which can flip the sign
    # of a near-zero element's Adam update: the fused chunk is held in the
    # mean of each leaf
    if fused and worst_mean > CHUNK_MEAN_SHARE:
        raise AssertionError(f"the fused graph chunk left the eager steps "
                             f"by {worst_mean:.3e} of a leaf's mean update")
    return {"max_abs_diff": worst_abs, "max_update_share": worst_share,
            "mean_update_share": worst_mean, "losses": losses,
            "within_rtol_1e-5_atol_1e-6": within}


def phase_train_resume() -> dict:
    """``train_nerf --checkpoint-interval 10`` to step 20 (fused bf16,
    one step a call), then ``--resume --steps-per-call 5`` to step 30:
    the resumed run starts at 21, its first call captures after the
    checkpoint is copied in, and the optimizer state copied onto the
    card from the file equals the file."""
    from fourier_feature_nets_torch.models.serialization import (
        named_parameters, params_from_jax, params_to_jax)
    from fourier_feature_nets_torch.utils.checkpoint import (
        latest_checkpoint, load_train_state)
    from fourier_feature_nets_torch.utils.optim import ClippedAdam
    results = os.path.join(OUT_DIR, "train_resume")
    shutil.rmtree(results, ignore_errors=True)
    common = ["--compute-dtype", "bfloat16", "--report-interval", "10",
              "--image-interval", "0", "--checkpoint-interval", "10",
              "--crop-steps", "10"]
    _reset_launches()
    start = time.perf_counter()
    run_train_cli(results, [*common, "--num-steps", "20"])
    first = time.perf_counter() - start
    saved = sorted(os.listdir(os.path.join(results, "checkpoints")))
    path = latest_checkpoint(os.path.join(results, "checkpoints"))
    state = load_train_state(path)
    model = state.model.cuda()
    optimizer = ClippedAdam(model.parameters(), 5e-4, capturable=True)
    named = named_parameters(model)
    optimizer.load_jax_state(named, *state.opt_state)
    step, mu, nu = optimizer.jax_state(named)
    equal = (step == state.opt_state.step
             and all(np.array_equal(mu[k], state.opt_state.mu[k])
                     and np.array_equal(nu[k], state.opt_state.nu[k])
                     for k in mu)
             and all(np.array_equal(v, state.params[k])
                     for k, v in params_to_jax(model).items()))
    start = time.perf_counter()
    output, caster, chunks = run_train_cli(
        results, [*common, "--num-steps", "30", "--resume",
                  "--steps-per-call", "5"])
    second = time.perf_counter() - start
    resumed = re.search(r"Resumed from .*ckpt_(\d+)\.npz at step (\d+)",
                        output)
    rows = _read_log(os.path.join(results, "log.txt"))
    launches = _launch_counts()
    log(f"train_nerf --checkpoint-interval 10 to step 20: {first:.3f} s, "
        f"checkpoints {saved}; the newest on the card equals the file "
        f"(weights, moments, Adam step {step}): {equal}; --resume "
        f"--steps-per-call 5 to step 30: {second:.3f} s, "
        f"{resumed.group(0) if resumed else 'no resume line'}, log steps "
        f"{[r[0] for r in rows]}, {len(chunks)} graph chunk(s) with "
        f"{chunks[0].replays if chunks else 0} replays; launches {launches}")
    if saved != ["ckpt_00000010.npz", "ckpt_00000020.npz"] or not equal \
            or resumed is None or resumed.group(2) != "21" \
            or [r[0] for r in rows] != [30] or len(chunks) != 1 \
            or chunks[0].captured["fused_nerf_train"] != 5:
        raise AssertionError("checkpoint/resume did not resume at step 21 "
                             "through a captured chunk")
    return {"first_s": first, "resumed_s": second, "checkpoints": saved,
            "state_equals_file": equal, "launches": launches,
            "replays": chunks[0].replays,
            "captured_launches": chunks[0].captured,
            "ms_per_step": _steady_ms_per_step(caster)}


def phase_train_occupancy() -> dict:
    """Occupancy-guided ``train_nerf`` (fused bf16, --steps-per-call 5,
    no crop): 128 samples a ray to step 14, then 48 through the density
    grid of the live model, refreshed in place at steps 24 and 34 with
    no new capture; K1 and K2 launch, and run in the guided graph."""
    results = os.path.join(OUT_DIR, "train_occupancy")
    _reset_launches()
    start = time.perf_counter()
    output, caster, chunks = run_train_cli(
        results, ["--compute-dtype", "bfloat16", "--crop-steps", "0",
                  "--report-interval", "20", "--image-interval", "0",
                  "--steps-per-call", "5", "--num-steps", "39",
                  "--occupancy-interval", "10", "--occupancy-start", "10"])
    wall = time.perf_counter() - start
    launches = _launch_counts()
    # calls 0-2: steps 0-14 at 128 samples; call 3 captures the guided
    # chunk; calls 4-7 guided
    full_ms = _steady_ms_per_step(caster, 1, 3)
    guided_ms = _steady_ms_per_step(caster, 4)
    refresh = caster.occupancy_refresh_ms
    guided = chunks[-1] if chunks else None
    log(f"train_nerf --occupancy-interval 10 --occupancy-start 10 "
        f"--steps-per-call 5 (bf16, fused): {wall:.3f} s for the CLI call; "
        f"{full_ms:.3f} ms/step at 128 samples, {guided_ms:.3f} ms/step at "
        f"48 guided; refreshes {len(refresh)} of "
        f"{', '.join(f'{ms:.3f}' for ms in refresh)} ms; graph chunks "
        f"{len(chunks)}, the guided one {guided.captures if guided else 0} "
        f"capture(s), {guided.replays if guided else 0} replays, "
        f"{guided.captured if guided else {}} a chunk; launches {launches}")
    if "Enabling occupancy-guided sampling" not in output \
            or len(refresh) != 2 or len(chunks) != 2 \
            or guided.captures != 1 or guided.replays != 5 \
            or any(guided.captured[k] != 5 for k in guided.captured) \
            or min(launches.values()) <= 0:
        raise AssertionError(f"occupancy-guided training: {output[-2000:]}")
    return {"wall_s": wall, "ms_per_step_128": full_ms,
            "ms_per_step_48_guided": guided_ms, "refresh_ms": refresh,
            "launches": launches, "replays": guided.replays,
            "captured_launches": guided.captured}


def phase_quality_orbit(checkpoint: str, label: str) -> dict:
    """``orbit_video --preset quality`` (96 density-grid samples, early
    termination at 1e-2 after 48, bf16) of ``checkpoint`` at 800x800 for
    3 frames beside ``--preset fast``: K1 must launch in both passes;
    then frame 0 with and without early termination, every value within
    ceil(255 * 1e-2) + 1 of the other."""
    from fourier_feature_nets_torch.cameras import Resolution
    from fourier_feature_nets_torch.cli import orbit_video
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        fused_nerf_apply)
    from fourier_feature_nets_torch.models import load_model
    from fourier_feature_nets_torch.render import Raycaster
    from fourier_feature_nets_torch.utils import orbit

    passes = {"prefix": 0, "suffix": 0}
    wrapped = {}
    for name in passes:
        method = getattr(Raycaster, f"_render_{name}")
        wrapped[name] = method

        def counting(self, *args, _name=name, _method=method, **kwargs):
            before = fused_nerf_apply.launches
            out = _method(self, *args, **kwargs)
            passes[_name] += fused_nerf_apply.launches - before
            return out

        setattr(Raycaster, f"_render_{name}", counting)
    try:
        output, launches, wall = run_orbit(
            checkpoint, os.path.join(OUT_DIR, "quality_frames"), FRAME_RES,
            ["--preset", "quality", "--num-frames", "3"])
    finally:
        for name, method in wrapped.items():
            setattr(Raycaster, f"_render_{name}", method)
    check_frames(os.path.join(OUT_DIR, "quality_frames"), 3, FRAME_RES)
    quality = orbit_summary(output)
    survived = re.search(r"(\d+) of (\d+) hit rays survived", output)
    fast_output, fast_launches, _ = run_orbit(
        checkpoint, os.path.join(OUT_DIR, "fast_frames"), FRAME_RES,
        ["--preset", "fast", "--num-frames", "3"])
    fast = orbit_summary(fast_output)

    args = orbit_video._parse_args([checkpoint, str(FRAME_RES), OUT_DIR,
                                    "--preset", "quality"])
    cameras = orbit(orbit_video.VECTORS[args.up_dir],
                    orbit_video.VECTORS[args.forward_dir], args.num_frames,
                    args.fov_y_degrees, Resolution(FRAME_RES, FRAME_RES),
                    args.distance)
    model = load_model(checkpoint).cuda()
    sampler = orbit_video.build_render_sampler(
        args, model, cameras, np.diag([2.0, 2.0, 2.0, 1.0]).astype(
            np.float32))
    caster = Raycaster(model, compute_dtype=torch.bfloat16)
    chunk = args.batch_size * 4
    early = caster.render_frame(sampler, 0, chunk_size=chunk,
                                early_term=args.early_term,
                                early_split=args.early_split)
    full = caster.render_frame(sampler, 0, chunk_size=chunk)
    diff = int(np.abs(early.astype(int) - full.astype(int)).max())
    limit = int(np.ceil(255 * args.early_term)) + 1
    share = (int(survived.group(1)) / int(survived.group(2))
             if survived else None)
    log(f"orbit_video --preset quality, {label}: 3 PNG frames of {FRAME_RES}x"
        f"{FRAME_RES}, {wall:.3f} s for the CLI call; frames "
        f"{quality['first_frame_ms']:.3f} ms then "
        f"{quality['steady_frame_ms']:.3f} ms (--preset fast "
        f"{fast['steady_frame_ms']:.3f} ms); "
        f"{survived.group(0) if survived else 'no survivor count'} "
        f"({share:.2%} of them); K1 launches {launches} (pass 1 "
        f"{passes['prefix']}, pass 2 {passes['suffix']}; fast "
        f"{fast_launches}); frame 0 with and without early termination: max "
        f"|d| {diff} (limit {limit})")
    if passes["prefix"] <= 0 or passes["suffix"] <= 0 or diff > limit \
            or survived is None:
        raise AssertionError("--preset quality did not run K1 in both "
                             "passes within the bound")
    return {"launches": launches, "pass_launches": passes,
            "steady_frame_ms": quality["steady_frame_ms"],
            "first_frame_ms": quality["first_frame_ms"],
            "fast_steady_frame_ms": fast["steady_frame_ms"],
            "survivor_share": share, "max_abs_diff_vs_full": diff,
            "limit": limit}


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
    """(max abs err, mean abs err, within K3's limits, stated limits) of
    K3 against its twin (kernels/fused_ray_render.py: the mean limit from
    MEAN_RAYS rays on)."""
    from fourier_feature_nets_torch.kernels.fused_ray_render import (
        K3_BF16_ATOL, K3_BF16_MEAN_ATOL, K3_F32_MEAN_ATOL, MEAN_RAYS)
    err = (out - twin).abs()
    max_abs, mean_abs = err.max().item(), err.mean().item()
    held = out.shape[0] >= MEAN_RAYS
    if dtype == torch.float32:
        ok = bool((err <= F32_ATOL + F32_RTOL * twin.abs()).all())
        mean_limit = K3_F32_MEAN_ATOL
        stated = f"|d| <= {F32_ATOL} + {F32_RTOL}|ref|"
    else:
        ok = max_abs <= K3_BF16_ATOL
        mean_limit = K3_BF16_MEAN_ATOL
        stated = f"|d| <= {K3_BF16_ATOL}"
    if held:
        ok = ok and mean_abs <= mean_limit
        stated += f", mean <= {mean_limit}"
    return max_abs, mean_abs, ok, stated


def phase_ray_render_vs_twin(model):
    """K3 against its plain twin, within K3's limits, in both types: the
    flagship at S = 42, 48 and 128 with a ragged R, with signal only in
    the last ray group, at S = 2 and 4096, and a 32-wide model; one CUDA
    graph replay; the controls (bf16: the twin with its view product
    unrounded must fail the mean limit; f32: the twin on single tf32
    products must fail the limits); against the plain render (f32)."""
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        prepare_fused_nerf)
    from fourier_feature_nets_torch.kernels.fused_ray_render import (
        fused_ray_render, fused_ray_render_reference, launch_ray_group)
    from fourier_feature_nets_torch.models import NeRF
    from fourier_feature_nets_torch.render import Raycaster, RaySamples
    rng = np.random.default_rng(SEED + 2)
    narrow = NeRF(num_layers=2, num_channels=32, max_log_scale_pos=3.0,
                  num_freq_pos=4, max_log_scale_view=1.0, num_freq_view=2,
                  skips=[], include_inputs=False,
                  generator=torch.Generator().manual_seed(SEED)).cuda()
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        weights = prepare_fused_nerf(model, dtype)
        cases = [(f"R={RAGGED_RAYS:,d} S={s}", weights, RAGGED_RAYS, s, False)
                 for s in (42, 48, 128)]
        cases += [(f"R={RAGGED_RAYS:,d} S={s}, signal only in the last ray "
                   f"group", weights, RAGGED_RAYS, s, True) for s in (42, 48)]
        cases += [(f"R={RAGGED_RAYS:,d} S=2", weights, RAGGED_RAYS, 2, False),
                  ("R=9 S=4096", weights, 9, 4096, False),
                  (f"2x32 model R={RAGGED_RAYS:,d} S=48",
                   prepare_fused_nerf(narrow, dtype), RAGGED_RAYS, 48,
                   False)]
        worst = {"max_abs_err": 0.0, "mean_abs_err": 0.0}
        for label, pack, num_rays, num_samples, last_only in cases:
            pos, d, t = render_rays(num_rays, num_samples, rng)
            if last_only:
                # every other ray has all its samples at one depth: alpha 0
                rays, _ = launch_ray_group(num_rays, num_samples,
                                           pos.device)
                last = num_rays % rays or rays
                t[:-last] = 2.0
                pos[:-last] = d[:-last, None] * 2.0
            with torch.no_grad():
                out = fused_ray_render(pack, pos, d, t)
                twin = fused_ray_render_reference(pack, pos, d, t)
            torch.cuda.synchronize()
            if out.shape != (num_rays, 4) or not torch.isfinite(out).all():
                raise AssertionError(f"K3 output not finite ({label})")
            max_abs, mean_abs, ok, stated = render_error(out, twin, dtype)
            if last_only:
                quiet = torch.count_nonzero(twin[:-last, 3]).item()
                loud = twin[-last:, 3].min().item()
                label += (f" ({last} rays; twin alpha nonzero on {quiet} "
                          f"others, min {loud:.3f} in the group)")
                ok = ok and quiet == 0 and loud > 0.1
            worst["max_abs_err"] = max(worst["max_abs_err"], max_abs)
            worst["mean_abs_err"] = max(worst["mean_abs_err"], mean_abs)
            log(f"  K3 {name:8s} {label}: max abs err {max_abs:.3e}, mean "
                f"{mean_abs:.3e} ({stated}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K3 disagrees with its plain twin "
                                     f"({name}, {label})")
        # the control at the flagship, R = 1001, S = 48
        pos, d, t = render_rays(RAGGED_RAYS, 48, rng)
        with torch.no_grad():
            out = fused_ray_render(weights, pos, d, t)
            twin = fused_ray_render_reference(weights, pos, d, t)
            if dtype == torch.bfloat16:
                control = "the twin with its view product unrounded"
                wrong = fused_ray_render_reference(weights, pos, d, t,
                                                   "unrounded-view")
            else:
                control = "the twin on single tf32 products"
                with single_tf32():
                    wrong = fused_ray_render_reference(weights, pos, d, t)
        torch.cuda.synchronize()
        max_abs, mean_abs, ok, stated = render_error(out, twin, dtype)
        c_max, c_mean, c_ok, _ = render_error(out, wrong, dtype)
        log(f"  K3 {name:8s} control R={RAGGED_RAYS:,d} S=48: K3 vs twin max "
            f"{max_abs:.3e} mean {mean_abs:.3e} ({stated}); K3 vs {control} "
            f"max {c_max:.3e} mean {c_mean:.3e}, which must fail: "
            f"{'fails, ok' if not c_ok else 'PASSES: FAIL'}")
        if not ok or c_ok:
            raise AssertionError(f"K3 {name}'s limits do not tell the twin "
                                 f"from {control}")
        worst.update(control=control, control_max_abs_err=c_max,
                     control_mean_abs_err=c_mean)
        # one CUDA graph replay of the same launch
        with torch.no_grad():
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fused_ray_render(weights, pos, d, t)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                captured = fused_ray_render(weights, pos, d, t)
            captured.zero_()
            graph.replay()
        torch.cuda.synchronize()
        replayed = torch.equal(captured, out)
        log(f"  K3 {name:8s} CUDA graph replay equals the eager launch: "
            f"{replayed}")
        if not replayed:
            raise AssertionError("K3's graph replay differs")
        del graph
        results[name] = worst
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
    return results


def k1_composite(weights, pos, d, t):
    """K1 followed by the plain composite (the port's render path): the
    same rays as K3 takes them, a (color, alpha) result."""
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        fused_nerf_apply)
    from fourier_feature_nets_torch.render.raycaster import _composite
    num_rays, num_samples = t.shape
    views = d[:, None].expand(pos.shape).reshape(-1, 3).contiguous()
    logits = fused_nerf_apply(weights, pos.reshape(-1, 3), views)
    return _composite(logits.reshape(num_rays, num_samples, 4), t, False)


def phase_ray_render_timing(model):
    """K3, its twin, and K1 followed by _composite (the port's render
    path today) at R = 16384 rays, S = 48 (a --preset fast chunk) and 128
    (bench.py's render batch); then K3 at the validate CLI's own launches
    (R = 64 on its 4x64 model at S = 42, 48, 128)."""
    from fourier_feature_nets_torch.cli.validate_kernels import RAY_MODEL
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        fused_nerf_apply, prepare_fused_nerf)
    from fourier_feature_nets_torch.kernels.fused_ray_render import (
        fused_ray_render, fused_ray_render_reference)
    from fourier_feature_nets_torch.models import NeRF
    rng = np.random.default_rng(SEED + 3)
    results = {}
    small = NeRF(**RAY_MODEL, generator=torch.Generator().manual_seed(1))
    small = small.cuda()
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        weights = prepare_fused_nerf(model, dtype)
        for num_samples in (48, 128):
            pos, d, t = render_rays(RENDER_RAYS, num_samples, rng)
            flat = pos.reshape(-1, 3)
            views = d[:, None].expand(pos.shape).reshape(-1, 3).contiguous()
            with torch.no_grad():
                out = fused_ray_render(weights, pos, d, t)
                twin = fused_ray_render_reference(weights, pos, d, t)
                k1 = k1_composite(weights, pos, d, t)
                max_abs, mean_abs, ok, stated = render_error(out, twin, dtype)
                k1_diff = max((out[:, :3] - k1.color).abs().max().item(),
                              (out[:, 3] - k1.alpha).abs().max().item())
                ms = cuda_ms(lambda: fused_ray_render(weights, pos, d, t), 5)
                plain_ms = cuda_ms(lambda: fused_ray_render_reference(
                    weights, pos, d, t), 5)
                k1_ms = cuda_ms(lambda: k1_composite(weights, pos, d, t), 5)
                k1_alone_ms = cuda_ms(
                    lambda: fused_nerf_apply(weights, flat, views), 5)
            log(f"  K3 {name:8s} R={RENDER_RAYS} S={num_samples:3d}: K3 "
                f"{ms:.3f} ms, plain twin {plain_ms:.3f} ms, K1 + _composite "
                f"{k1_ms:.3f} ms (K1 alone {k1_alone_ms:.3f} ms) (CUDA "
                f"events, mean of 5); K3 vs twin max abs err {max_abs:.3e}, "
                f"mean {mean_abs:.3e} ({stated}) {'ok' if ok else 'FAIL'}; K3 "
                f"vs K1 + _composite max abs diff {k1_diff:.3e}")
            if not ok:
                raise AssertionError(f"K3 disagrees with its plain twin "
                                     f"({name}, S={num_samples})")
            results[(name, num_samples)] = {
                "max_abs_err": max_abs, "mean_abs_err": mean_abs, "ms": ms,
                "plain_ms": plain_ms, "k1_composite_ms": k1_ms,
                "k1_ms": k1_alone_ms, "k1_composite_max_abs_diff": k1_diff}
            del pos, d, t, flat, views, out, twin, k1
        del weights
        torch.cuda.empty_cache()
        pack = prepare_fused_nerf(small, dtype)
        for num_samples in (42, 48, 128):
            rays = render_rays(64, num_samples, rng)
            with torch.no_grad():
                ms = cuda_ms(lambda: fused_ray_render(pack, *rays), 200)
            results[(name, "validate", num_samples)] = ms
            log(f"  K3 {name:8s} at the validate CLI's R=64 S={num_samples} "
                f"(4x64 model): {ms * 1e3:.2f} us a call (CUDA events, mean "
                f"of 200 back to back)")
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
    for check in ("shard_map fused train step (mesh) loss",
                  "render_frame fused under mesh (uint8)"):
        if not any(line.startswith(f"OK  {check}") for line in lines):
            raise AssertionError(f"validate_kernels: no OK line for {check}")
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
    ones, P1a and P1b also with their operands one row and one element
    into larger buffers, P1b once more from a CUDA graph replay; P1c
    timed at the CLI's shape (P1a and P1b by phase_times)."""
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
    for (m, k, n), offset in P1A_CASES:
        w = _placed(_ints(rng, (m, k), -127, 128, torch.int8), offset)
        x = _placed(torch.from_numpy(rng.normal(size=(k, n)).astype(
            np.float32)).cuda(), offset)
        before = probe.quantized_matmul.launches
        outq = probe.quantized_matmul(x, w)
        twinq = probe.quantized_matmul_reference(x, w)
        torch.cuda.synchronize()
        err_b = (outq - twinq).abs().max().item()
        rel_b = err_b / twinq.abs().max().item()
        ok_b = _bits_equal(outq, twinq) \
            and probe.quantized_matmul.launches == before + 1
        log(f"  P1b quantized_matmul ({m}, {k}) @ ({k}, {n}), offset {offset} "
            f"(x base % 16 = {x.data_ptr() % 16}): max abs err {err_b:.3e}, "
            f"rel {rel_b:.3e}, bitwise equal {_bits_equal(outq, twinq)} "
            f"(bit for bit) {'ok' if ok_b else 'FAIL'}")
        if not ok_b:
            raise AssertionError("P1b disagrees with its plain twin")
        if ((m, k, n), offset) == (P1_GEMM_SHAPES[0], "none"):
            # one CUDA graph replay, x changed after the capture
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                captured = probe.quantized_matmul(x, w)
            x.mul_(3.0)
            graph.replay()
            torch.cuda.synchronize()
            replayed = _bits_equal(captured,
                                   probe.quantized_matmul_reference(x, w))
            log(f"  P1b CUDA graph replay after x *= 3 equals the twin bit "
                f"for bit: {replayed}")
            if not replayed:
                raise AssertionError("P1b's graph replay differs")
            del graph
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
            plan = probe.layer_stack_plan(channels, n, layers, dtype,
                                          out.device)
            log(f"    launch: {plan['ctas']} blocks in clusters of "
                f"{plan['cluster']}, {plan['stages']} layers' weight slices "
                f"kept, {plan['smem_bytes']:,d} bytes of shared memory a "
                f"block")
            if (channels, n, layers) == P1C_SHAPES[0]:
                size = 1 if name == "int8" else 2
                stack[name] = {
                    "ctas": plan["ctas"], "cluster": plan["cluster"],
                    "stages": plan["stages"],
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
    """P2, K1's own kernels in each ablation mode: in bf16 all seven (the
    five the ablation CLI runs, then bf16-accum and no-sincos), in f32 the
    six an f32 pack takes, against the twin at the ablation CLI's points
    and a ragged N, and base against K1 bit for bit at both; each mode
    timed at the CLI's points between two timings of K1 at the same N
    (K1_ms, their mean), so that each mode's ms minus base's, over K1's,
    is the share of K1's time its part costs. The CLI's run never selects
    the f32 pack or the last two modes, so this phase is their path: each
    mode's launches here are counted and must be > 0."""
    from fourier_feature_nets_torch.cli.kernel_ablation_bench import (
        ablation_inputs)
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        fused_nerf_apply, prepare_fused_nerf)
    from fourier_feature_nets_torch.kernels.fused_nerf_ablation import (
        ALL_MODES, fused_nerf_ablation, fused_nerf_ablation_reference)
    from fourier_feature_nets_torch.models import flagship_nerf
    model = flagship_nerf(torch.Generator().manual_seed(SEED)).cuda()
    cli_points = ablation_inputs(16384, ABLATION_POINTS // 16384, "cuda")
    ragged = random_points(RAGGED_POINTS, np.random.default_rng(SEED + 6),
                           "cuda")
    results = {}
    with torch.no_grad():
        for dtype, kind in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            weights = prepare_fused_nerf(model, dtype)
            modes = {}
            for mode in ALL_MODES:
                if mode == "bf16-accum" and kind == "f32":
                    continue
                fused_nerf_ablation.launches = 0
                for pos, views in (cli_points, ragged):
                    out = fused_nerf_ablation(weights, pos, views, mode)
                    twin = fused_nerf_ablation_reference(weights, pos, views,
                                                         mode)
                    torch.cuda.synchronize()
                    err = (out - twin).abs().max().item()
                    ok = torch.isfinite(out).all().item()
                    if mode == "bf16-accum":
                        base = fused_nerf_ablation_reference(weights, pos,
                                                             views, "base")
                        mean = (out - twin).abs().mean().item()
                        base_mean = (out - base).abs().mean().item()
                        ok = ok and err <= ACCUM_ATOL \
                            and mean <= ACCUM_MEAN_ATOL < base_mean
                        stated = (f"|d| <= {ACCUM_ATOL}; mean {mean:.3e} <= "
                                  f"{ACCUM_MEAN_ATOL}, from base's twin "
                                  f"{base_mean:.3e} > {ACCUM_MEAN_ATOL}; "
                                  f"the twins max "
                                  f"{(twin - base).abs().max():.3e}, mean "
                                  f"{(twin - base).abs().mean():.3e} apart")
                    elif kind == "f32":
                        ok = ok and torch.allclose(out, twin, rtol=1e-3,
                                                   atol=2e-4)
                        stated = "rtol 1e-3, atol 2e-4"
                    else:
                        ok = ok and err <= BF16_ATOL
                        stated = f"|d| <= {BF16_ATOL}"
                    if mode == "base":
                        k1 = fused_nerf_apply(weights, pos, views)
                        same = torch.equal(out, k1)
                        ok = ok and same
                        stated += f"; K1 bit for bit: {same}"
                    log(f"  P2 {kind} {mode:12s} N={pos.shape[0]:>7,d}: max "
                        f"abs err {err:.3e} ({stated}) "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"P2 {kind} {mode} disagrees "
                                             f"with its twin or K1")
                    if pos is cli_points[0]:
                        macs = nerf_macs(weights, no_view=mode == "no-view")
                        modes[mode] = {
                            "max_abs_err": err,
                            "plain_ms": cuda_ms(
                                lambda: fused_nerf_ablation_reference(
                                    weights, pos, views, mode), 5),
                            **bound(2 * macs * ABLATION_POINTS,
                                    "bf16" if kind == "bf16" else "tf32x3",
                                    ABLATION_POINTS * 40
                                    + pack_bytes(weights))}
                modes[mode]["launches"] = fused_nerf_ablation.launches
                if modes[mode]["launches"] <= 0:
                    raise AssertionError(f"P2 {kind} {mode} was never "
                                         f"launched")
            # the times: K1, every mode, K1 again, at the CLI's points
            pos, views = cli_points
            k1_before = cuda_ms(lambda: fused_nerf_apply(weights, pos, views),
                                10)
            for mode in modes:
                modes[mode]["ms"] = cuda_ms(lambda: fused_nerf_ablation(
                    weights, pos, views, mode), 10)
            k1_after = cuda_ms(lambda: fused_nerf_apply(weights, pos, views),
                               10)
            k1_ms = (k1_before + k1_after) / 2
            for mode, row in modes.items():
                row["share_of_k1"] = (row["ms"] - modes["base"]["ms"]) / k1_ms
                log(f"  P2 {kind} {mode:12s} N={ABLATION_POINTS:,d}: kernel "
                    f"{row['ms']:.4f} ms, minus base {row['share_of_k1']:+.2%}"
                    f" of K1's {k1_ms:.4f} ms (K1 {k1_before:.4f} before, "
                    f"{k1_after:.4f} after the modes), plain twin "
                    f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.3f} "
                    f"ms (CUDA events, mean of 10 / 5)")
            results[kind] = {"k1_ms": k1_ms, "k1_before_ms": k1_before,
                             "k1_after_ms": k1_after, "modes": modes}
    return results


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
    times them (K3 beside K1 + _composite, and at the validate CLI's
    launches) and P2 in each of its modes in both types at the ablation
    CLI's points, between two timings of K1 at that N (CUDA events,
    FLAGSHIP_REPS calls); K1 and P2, which runs K1's kernels, come
    last."""
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
    from fourier_feature_nets_torch.cli.validate_kernels import RAY_MODEL
    from fourier_feature_nets_torch.kernels.fused_ray_render import (
        fused_ray_render)
    from fourier_feature_nets_torch.models import NeRF, flagship_nerf
    model = flagship_nerf(torch.Generator().manual_seed(SEED)).cuda()
    packs = {kind: prepare_fused_nerf(model, dtype)
             for dtype, kind in ((torch.bfloat16, "bf16"),
                                 (torch.float32, "f32"))}

    def timed(name, fn):
        rows[name] = cuda_ms(fn, FLAGSHIP_REPS)
        log(f"  {name}: {rows[name]:.4f} ms (CUDA events, mean of "
            f"{FLAGSHIP_REPS})")

    # K1 and P2 (K1's kernels) last: their load must not set the clocks the
    # others are timed at
    with torch.no_grad():
        pos, views = random_points(TRAIN_POINTS, rng, "cuda")
        g = torch.from_numpy(rng.normal(size=(TRAIN_POINTS, 4)).astype(
            np.float32)).cuda()
        for kind, weights in packs.items():
            timed(f"fused_nerf_train_{kind}",
                  lambda: fused_nerf_backward(weights, pos, views, g))
        # K3 beside K1 + _composite at R = 16384, S = 128 and 48, then at
        # the validate CLI's launches (R = 64 on its 4x64 model)
        rays = {samples: render_rays(RENDER_RAYS, samples, rng)
                for samples in (128, 48)}
        small = NeRF(**RAY_MODEL, generator=torch.Generator().manual_seed(1))
        small = small.cuda()
        for kind, weights in packs.items():
            for samples, suffix in ((128, ""), (48, "_s48")):
                timed(f"fused_ray_render_{kind}{suffix}",
                      lambda: fused_ray_render(weights, *rays[samples]))
                timed(f"k1_composite_{kind}{suffix}",
                      lambda: k1_composite(weights, *rays[samples]))
            pack = prepare_fused_nerf(small, torch.bfloat16 if kind == "bf16"
                                      else torch.float32)
            for samples in (42, 48, 128):
                few = render_rays(64, samples, rng)
                name = f"fused_ray_render_validate_{kind}_s{samples}"
                rows[name] = call_times(lambda: fused_ray_render(pack, *few))
                log(f"  {name}: " + ", ".join(
                    f"{key} {value:.5f}" if isinstance(value, float)
                    else f"{key} {value}" for key, value in rows[name].items()))
        del g, rays
        from fourier_feature_nets_torch.cli.kernel_ablation_bench import (
            ablation_inputs)
        from fourier_feature_nets_torch.kernels import fused_nerf_ablation
        pos, views = ablation_inputs(16384, ABLATION_POINTS // 16384, "cuda")
        # P2 runs K1's kernels: its modes between two timings of K1 at the
        # same N, before the other K1 timings
        for kind, weights in packs.items():
            suffix = "" if kind == "bf16" else "_f32"
            timed(f"fused_nerf_{kind}_n{ABLATION_POINTS}",
                  lambda: fused_nerf_apply(weights, pos, views))
            for mode in fused_nerf_ablation.ALL_MODES:
                if mode == "bf16-accum" and kind == "f32":
                    continue
                timed(f"fused_nerf_ablation_{mode}{suffix}",
                      lambda: fused_nerf_ablation.fused_nerf_ablation(
                          weights, pos, views, mode))
            timed(f"fused_nerf_{kind}_n{ABLATION_POINTS}_after",
                  lambda: fused_nerf_apply(weights, pos, views))
        for kind, weights in packs.items():
            for num in (CHUNK_POINTS, TRAIN_POINTS, BENCH_POINTS):
                pos, views = random_points(num, rng, "cuda")
                name = (f"fused_nerf_{kind}" if num == BENCH_POINTS
                        else f"fused_nerf_{kind}_n{num}")
                timed(name, lambda: fused_nerf_apply(weights, pos, views))
    del packs
    torch.cuda.empty_cache()
    # the fused part of a train step in each type: pack (with the slab
    # image), K1 forward and K2 backward through autograd, at the train batch
    pos, views = random_points(TRAIN_POINTS, rng, "cuda")
    for kind, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        def fused_train_core():
            packed = pack_fused_nerf(model, dtype)
            fused_nerf_train_apply(packed, pos, views).sum().backward()

        name = f"fused_train_core_{kind}"
        timed(name, fused_train_core)
        # the same core split: the host's time to issue one (host clock, no
        # synchronise) and the device time of the kernels it launches
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(FLAGSHIP_REPS):
            fused_train_core()
        rows[f"{name}_host_ms"] = (
            (time.perf_counter() - start) * 1e3 / FLAGSHIP_REPS)
        torch.cuda.synchronize()
        rows[f"{name}_device_ms"] = profiler_kernel_ms(fused_train_core,
                                                       FLAGSHIP_REPS)
        log(f"  {name}: host issue {rows[f'{name}_host_ms']:.4f} ms, device "
            f"{rows[f'{name}_device_ms']} ms a call")
    model.zero_grad(set_to_none=True)
    del model, pos, views
    torch.cuda.empty_cache()
    # whole train steps through the CLI, fused and plain, in both types: its
    # summary's ms/step (CUDA events around each step, validation left out)
    for dtype in ("bfloat16", "float32"):
        kind = "bf16" if dtype == "bfloat16" else "f32"
        for path, flag in (("fused", "--fused"), ("plain", "--no-fused")):
            name = f"train_step_{kind}_{path}"
            rows[name] = train_step_ms(["--compute-dtype", dtype, flag],
                                       TIMED_TRAIN_STEPS, path)
            log(f"  {name}: {rows[name]:.4f} ms/step over steps "
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


def sass_instructions(tree: str, source: str) -> dict:
    """{(source, kernel, C, mode): [instructions]} of the kernels of
    ``csrc/<source>`` in the checkout ``tree``, compiled with the build's
    target and optimisation to a cubin under OUT_DIR."""
    from fourier_feature_nets_torch.kernels.build import _nvcc
    path = os.path.join(tree, "fourier_feature_nets_torch", "kernels",
                        "csrc", source)
    os.makedirs(OUT_DIR, exist_ok=True)
    cubin = os.path.join(OUT_DIR, f"{zlib.crc32(path.encode())}_{source}"
                                  f".cubin")
    subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-cubin", "-o", cubin, path],
                   check=True, capture_output=True)
    dump = subprocess.run(
        [os.path.join(os.path.dirname(_nvcc()), "cuobjdump"), "-sass",
         cubin], check=True, capture_output=True, text=True).stdout
    names = subprocess.run(["c++filt"], input=dump, check=True,
                           capture_output=True, text=True).stdout
    kernels, current = {}, None
    for line in names.splitlines():
        function = re.search(r"Function : (.*)$", line)
        if function:
            kernel = re.search(r"(\w+_kernel)<(\d+)(?:, (\d+))?",
                               function.group(1))
            current = ((source, kernel.group(1), int(kernel.group(2)),
                        kernel.group(3)) if kernel else None)
            if current:
                kernels[current] = []
            continue
        body = re.sub(r"/\*[^*]*\*/", "", line).strip()
        if current and body and body[0] not in ".{}":
            kernels[current].append(body)
    return kernels


def run_sass(tree: str) -> int:
    """--sass: each kernel's SASS instruction count in ``tree`` and here."""
    sources = ("fused_nerf.cu", "fused_nerf_ablation.cu",
               "fused_nerf_train.cu")
    jobs = [(where, source) for where in (tree, ROOT) for source in sources]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        found = list(pool.map(lambda job: sass_instructions(*job), jobs))
    before = {k: v for part in found[:len(sources)] for k, v in part.items()}
    after = {k: v for part in found[len(sources):] for k, v in part.items()}
    counted = same = 0
    for key in sorted(before):
        old, new = before[key], after.get(key, [])
        counted += len(old) == len(new)
        same += old == new
        log(f"SASS {key}: {len(old)} in {tree}, {len(new)} here: "
            + ("identical" if old == new else
               "same count" if len(old) == len(new) else "OTHER COUNT"))
    log(f"SASS: {counted} of {len(before)} kernels with the same instruction "
        f"count ({same} identical); {len(after)} kernels here")
    return 0 if counted == len(before) else 1


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


def run_train_turns() -> int:
    """``--train-turns``: ms per step of ``train_nerf synthetic`` at
    ``--steps-per-call`` 8 against 1, fused and plain, in bf16 and f32,
    in turns 1 8 8 1 within this one process (the CUDA events of each
    call over calls 2.., validation left out), and the host's ms to
    issue a call; one JSON line."""
    from fourier_feature_nets_torch.kernels import (fused_nerf,
                                                    fused_nerf_train)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda module: module.load_kernel(),
                      (fused_nerf, fused_nerf_train)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    rows = {}
    for dtype in ("bfloat16", "float32"):
        for fused in (True, False):
            label = f"{dtype}, {'fused' if fused else 'plain'}"
            rows[label] = []
            for calls in (1, CHUNK_STEPS, CHUNK_STEPS, 1):
                _, caster, _ = run_train_cli(
                    os.path.join(OUT_DIR, "train_turns"),
                    ["--compute-dtype", dtype,
                     "--fused" if fused else "--no-fused",
                     "--steps-per-call", str(calls), "--num-steps",
                     str(TURN_STEPS - 1), "--report-interval",
                     str(TURN_STEPS), "--image-interval", "0"])
                row = {"steps_per_call": calls,
                       "ms_per_step": _steady_ms_per_step(caster),
                       "host_ms_per_call": float(np.mean(
                           caster.host_ms[1:]))}
                rows[label].append(row)
                log(f"  {label}, --steps-per-call {calls}: "
                    f"{row['ms_per_step']:.4f} ms/step, host "
                    f"{row['host_ms_per_call']:.4f} ms a call")
    print(json.dumps({"train_turns": rows, "steps": TURN_STEPS}))
    return 0


# ---------------------------------------------------------------------------
# pose frames, the render server and distillation; the probe at cell faces
# ---------------------------------------------------------------------------

SERVE_CAMERAS = 16             # the served rig (a 16-frame stream)
SERVE_CLIENTS = 4              # concurrent stream clients
DISTILL_STEPS = 200            # then --resume DISTILL_RESUMED steps more
DISTILL_RESUMED = 100
DISTILL_CALL = 100             # --steps-per-call of the distill phase
DISTILL_BATCH = (1024, 128)    # rays x samples a distill step (the CLI's)
# The mean loss of the last 20 of DISTILL_STEPS steps must be at most
# 1/DISTILL_FALL of the first 20's (three H100 80GB HBM3 runs at 700 W
# read 206x to 217x).
DISTILL_FALL = 10.0
# One distill step, fused against the same step on the kernels' twins
# (the same bf16 packs): the loss's relative gap. The K1 / twin logits
# differ by ~4e-7 in the mean (at most 3.3e-4) against a colour residual
# of ~1e-2 after 200 steps, which moves the loss by ~1e-5 of itself; a
# gradient or loss scaled wrong moves it by its own factor.
DISTILL_TWIN_LOSS_GAP = 1e-3
# Fused against the plain f32 step from the fresh student: the loss's
# relative gap, the bf16 packs' rounding (2^-8 = 3.9e-3 of a logit) at
# most (5.8e-4 on an H100 80GB HBM3 at 700 W).
DISTILL_PLAIN_LOSS_GAP = 1e-2


def jpeg_header(data: bytes) -> dict:
    """The markers of a baseline JFIF file up to its scan, its size and
    sampling factors; raises unless it is well formed (SOI, APP0 JFIF,
    two quantization tables, SOF0, four Huffman tables, SOS, EOI)."""
    if data[:2] != b"\xff\xd8" or data[-2:] != b"\xff\xd9":
        raise AssertionError("a JPEG without SOI / EOI")
    markers, pos = [], 2
    while True:
        marker, length = struct.unpack(">HH", data[pos:pos + 4])
        payload = data[pos + 4:pos + 2 + length]
        markers.append(marker)
        if marker == 0xFFC0:
            _, height, width, comps = struct.unpack(">BHHB", payload[:6])
            sampling = [payload[6 + 3 * i + 1] for i in range(comps)]
        pos += 2 + length
        if marker == 0xFFDA:
            break
    if (markers[0] != 0xFFE0 or 0xFFC0 not in markers
            or 0xFFC4 not in markers or 0xFFDB not in markers):
        raise AssertionError(f"JPEG markers {[hex(m) for m in markers]}")
    scan = data[pos:-2]
    stray = re.search(rb"\xff[^\x00]", scan)
    if stray is not None:
        raise AssertionError("an unstuffed 0xFF byte in the JPEG scan")
    return {"height": height, "width": width, "sampling": sampling,
            "bytes": len(data)}


class _GatherHit:
    """An occupancy sampler whose probe's hit flag is the plain gather
    (each probe's own truncated cell only): the flag before the repair
    at cell faces."""

    def __init__(self, sampler):
        self.sampler = sampler

    def __getattr__(self, name):
        return getattr(self.sampler, name)

    def _probe_cdf_geometry(self, starts, directions, near, far):
        s = self.sampler
        edges, probes = s._probe_positions(starts, directions, near, far)
        return edges, None, s._occupancy_at(probes).amax(-1) > 0


def _frames_ms(caster, sampler, cameras, reps: int = 1) -> float:
    """Mean host ms of ``render_frame`` (which ends in a host copy) over
    ``cameras``, after one warm-up frame."""
    caster.render_frame(sampler, cameras[0])
    start = time.perf_counter()
    for _ in range(reps):
        for camera in cameras:
            caster.render_frame(sampler, camera)
    return (time.perf_counter() - start) * 1e3 / (reps * len(cameras))


def _probe_ms(sampler, camera, stride, reps: int = 5) -> float:
    from fourier_feature_nets_torch.render import Raycaster
    Raycaster._compute_hit(sampler, camera, stride)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        Raycaster._compute_hit(sampler, camera, stride)
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3 / reps


def phase_face_probe(model) -> dict:
    """The occupancy probe's hit flag, repaired at cell faces: on the
    smoke-render frames (the random flagship's density grid, ``--preset
    fast``) and the smoke-octree frames (bench.py's tree as a 64^3
    occupancy grid, 32 samples), the rays of each 800x800 frame's stride-2
    culled raster that the repaired flag adds to the plain gather's (and
    none that it drops), the probe's ms with each flag, and frame ms."""
    from fourier_feature_nets_torch.cameras import Resolution
    from fourier_feature_nets_torch.cli import orbit_video
    from fourier_feature_nets_torch.octree import OcTree
    from fourier_feature_nets_torch.render import (OccupancyGridSampler,
                                                   Raycaster)
    from fourier_feature_nets_torch.utils import orbit

    args = orbit_video._parse_args(["m.npz", str(FRAME_RES), OUT_DIR,
                                    "--preset", "fast", "--num-frames", "3"])
    cameras = orbit(orbit_video.VECTORS[args.up_dir],
                    orbit_video.VECTORS[args.forward_dir], 3,
                    args.fov_y_degrees, Resolution(FRAME_RES, FRAME_RES),
                    args.distance)
    bounds = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
    tree = OcTree.load(os.path.join(OUT_DIR, "bench_tree.npz"))
    samplers = {
        "smoke-render": (orbit_video.build_render_sampler(
            args, model, cameras, bounds), 48),
        "smoke-octree": (OccupancyGridSampler.from_tree(
            tree, cameras, 32, bounds=bounds, device="cuda"), 32)}
    caster = Raycaster(model, compute_dtype=torch.bfloat16)
    rows = {}
    for name, (sampler, samples) in samplers.items():
        stride = Raycaster._safe_probe_subsample(sampler, 2)
        added, dropped, hit = [], [], []
        for camera in range(3):
            repaired = Raycaster._compute_hit(sampler, camera, stride)
            gather = Raycaster._compute_hit(_GatherHit(sampler), camera,
                                            stride)
            added.append(int((repaired & ~gather).sum()))
            dropped.append(int((gather & ~repaired).sum()))
            hit.append(int(repaired.sum()))
        row = {"stride": stride, "added": added, "dropped": dropped,
               "hit": hit, "samples": samples,
               "probe_ms": _probe_ms(sampler, 1, stride),
               "gather_probe_ms": _probe_ms(_GatherHit(sampler), 1, stride),
               "frame_ms": _frames_ms(caster, sampler, [0, 1, 2])}
        rows[name] = row
        log(f"face probe, {name} ({samples} samples, stride {stride}, "
            f"{FRAME_RES}x{FRAME_RES}): rays the repaired flag adds to the "
            f"gather's {added} of {hit} hit, drops {dropped}; probe "
            f"{row['probe_ms']:.3f} ms (gather only "
            f"{row['gather_probe_ms']:.3f} ms); frame {row['frame_ms']:.3f} "
            f"ms (mean of 3 after a warm-up)")
        if any(dropped) or not all(hit):
            raise AssertionError(f"{name}: the repaired flag is not a "
                                 f"superset of the gather's")
    return rows


def phase_pose(model) -> dict:
    """Pose frames of the random flagship at 800x800 ``--preset fast``
    (bf16, K1): a rig camera's pose equals its indexed frame bit for bit,
    a novel pose equals a sampler built around that camera at its index,
    each timed; then one focus-sampled pose frame (128 samples, its CDFs
    swept on the fly) timed with its sweep."""
    from fourier_feature_nets_torch.cameras import Resolution
    from fourier_feature_nets_torch.cli import orbit_video
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        fused_nerf_apply)
    from fourier_feature_nets_torch.render import (OccupancyGridSampler,
                                                   Raycaster, RaySampler,
                                                   density_grid_from_model)
    from fourier_feature_nets_torch.utils import orbit

    args = orbit_video._parse_args(["m.npz", str(FRAME_RES), OUT_DIR,
                                    "--preset", "fast"])
    cameras = orbit(orbit_video.VECTORS[args.up_dir],
                    orbit_video.VECTORS[args.forward_dir], 4,
                    args.fov_y_degrees, Resolution(FRAME_RES, FRAME_RES),
                    args.distance)
    bounds = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
    grid = density_grid_from_model(model)

    def occupancy(rig):
        return OccupancyGridSampler(grid, 1.0, rig, args.num_samples,
                                    empty_weight=0.1, bounds=bounds,
                                    device="cuda")

    rig, fresh = occupancy(cameras[:3]), occupancy(cameras[3:])
    caster = Raycaster(model, compute_dtype=torch.bfloat16, fused=True)
    chunk = args.batch_size * 4
    caster.render_frame(rig, 0, chunk_size=chunk)
    caster.render_frame_pose(rig, cameras[0], chunk_size=chunk)

    def timed(fn):
        """``fn()``'s frame, host ms and K1 launches."""
        fused_nerf_apply.launches = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        return (out, (time.perf_counter() - start) * 1e3,
                fused_nerf_apply.launches)

    indexed = [timed(lambda: caster.render_frame(rig, camera,
                                                 chunk_size=chunk))
               for camera in range(3)]
    posed = [timed(lambda: caster.render_frame_pose(
        rig, cameras[camera], chunk_size=chunk)) for camera in range(3)]
    novel = timed(lambda: caster.render_frame_pose(rig, cameras[3],
                                                   chunk_size=chunk))
    reference = timed(lambda: caster.render_frame(fresh, 0,
                                                  chunk_size=chunk))
    rig_equal = all(np.array_equal(a[0], b[0])
                    for a, b in zip(posed, indexed))
    novel_equal = bool(np.array_equal(novel[0], reference[0]))

    focus_start = time.perf_counter()
    focus = RaySampler(bounds, cameras[:1], 128, "cuda", opacity_model=model,
                       batch_size=args.batch_size)
    torch.cuda.synchronize()
    focus_setup_s = time.perf_counter() - focus_start
    focus_frame, focus_ms, focus_launches = timed(
        lambda: caster.render_frame_pose(focus, cameras[3], chunk_size=chunk))
    row = {"indexed_ms": [f[1] for f in indexed],
           "pose_ms": [f[1] for f in posed], "novel_pose_ms": novel[1],
           "rig_pose_equals_indexed": rig_equal,
           "novel_pose_equals_fresh_sampler": novel_equal,
           "launches_indexed": [f[2] for f in indexed],
           "launches": [f[2] for f in posed] + [novel[2]],
           "launches_fresh_sampler": reference[2], "focus_pose_ms": focus_ms,
           "focus_rig_setup_s": focus_setup_s,
           "focus_launches": focus_launches}
    log(f"pose frames ({FRAME_RES}x{FRAME_RES}, --preset fast, bf16, K1): "
        f"rig cameras through the pose path equal the indexed frames bit "
        f"for bit: {rig_equal}; a novel pose equals a sampler built around "
        f"it: {novel_equal}; ms a frame, indexed "
        f"{', '.join(f'{ms:.3f}' for ms in row['indexed_ms'])}, pose "
        f"{', '.join(f'{ms:.3f}' for ms in row['pose_ms'])}, novel pose "
        f"{novel[1]:.3f} (host clock, each ending in its host copy); K1 "
        f"launches a frame, indexed {row['launches_indexed']}, pose "
        f"{row['launches']} (the novel pose last; its fresh sampler's "
        f"frame {reference[2]}); one focus pose frame (128 samples, CDFs "
        f"swept on the fly) {focus_ms:.3f} ms, {focus_launches} K1 "
        f"launches (the rig sampler's own sweep of 1 camera "
        f"{focus_setup_s:.3f} s)")
    # each pose frame launches K1 as often as the indexed frame it equals
    if not rig_equal or not novel_equal \
            or row["launches"] != row["launches_indexed"] + [reference[2]] \
            or min(row["launches"]) <= 0 or focus_launches <= 0 \
            or not focus_frame.any():
        raise AssertionError("pose frames disagree with the indexed path "
                             "or did not launch K1 on every frame")
    return row


def phase_chunked() -> dict:
    """2 frames of ``orbit_video --chunked --preset fast`` (the chunked
    parity path, ``render_image``) of the random flagship, each within
    +-1 of ``render_frame``."""
    from fourier_feature_nets_torch.cameras import Resolution
    from fourier_feature_nets_torch.cli import orbit_video
    from fourier_feature_nets_torch.models import load_model
    from fourier_feature_nets_torch.render import Raycaster
    from fourier_feature_nets_torch.utils import orbit

    checkpoint = os.path.join(OUT_DIR, "flagship_seed0.npz")
    frames_dir = os.path.join(OUT_DIR, "chunked_frames")
    flags = ["--preset", "fast", "--chunked", "--num-frames", "2",
             "--device", "cuda"]
    output, launches, wall = run_orbit(checkpoint, frames_dir, FRAME_RES,
                                       flags)
    times = orbit_summary(output)
    args = orbit_video._parse_args([checkpoint, str(FRAME_RES), frames_dir,
                                    *flags])
    cameras = orbit(orbit_video.VECTORS[args.up_dir],
                    orbit_video.VECTORS[args.forward_dir], 2,
                    args.fov_y_degrees, Resolution(FRAME_RES, FRAME_RES),
                    args.distance)
    model = load_model(checkpoint).cuda()
    sampler = orbit_video.build_render_sampler(
        args, model, cameras, np.diag([2.0, 2.0, 2.0, 1.0]).astype(
            np.float32))
    caster = Raycaster(model, compute_dtype=torch.bfloat16)
    # one K1 launch for each batch of each frame's valid rays
    expected = sum(-(-sampler.rays_for_camera(frame).positions.shape[0]
                     // args.batch_size) for frame in range(2))
    diffs = []
    for frame in range(2):
        with open(os.path.join(frames_dir, f"frame_{frame:05d}.png"),
                  "rb") as handle:
            chunked = png_pixels(handle.read()).astype(np.int32)
        whole = caster.render_frame(sampler, frame,
                                    chunk_size=args.batch_size * 4)
        diffs.append(int(np.abs(chunked - whole.astype(np.int32)).max()))
    log(f"orbit_video --chunked --preset fast: 2 PNG frames of "
        f"{FRAME_RES}x{FRAME_RES}, {wall:.3f} s for the CLI call; frames "
        f"{times['first_frame_ms']:.3f} ms then "
        f"{times['steady_frame_ms']:.3f} ms; K1 launches {launches} (held: "
        f"one a batch of {args.batch_size} valid rays, {expected}); max "
        f"|d| against render_frame {diffs} (limit 1)")
    if launches != expected or max(diffs) > 1:
        raise AssertionError("the chunked frames disagree with render_frame "
                             "or did not launch K1 on every batch")
    return {"launches": launches, "wall_s": wall, "max_abs_diff": diffs,
            **times}


def student_kernels(rng) -> dict:
    """K1 and K2 in bf16 at the serving student's width (6x192, the
    distill CLI's student) and distillation's batch (1024 rays x 128
    samples) against their twins: K1 within K1_BF16_ATOL /
    K1_BF16_MEAN_ATOL, K2 within GRAD_SHARE under the tail cotangent
    (the other cotangents logged); each timed beside its twin and its
    bound."""
    from fourier_feature_nets_torch.cli.common import RECOMMENDED_STUDENT
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        fused_nerf_apply, fused_nerf_reference, prepare_fused_nerf)
    from fourier_feature_nets_torch.kernels.fused_nerf_train import (
        fused_nerf_backward, fused_nerf_backward_reference)
    from fourier_feature_nets_torch.models import NeRF

    layers, channels = RECOMMENDED_STUDENT
    student = NeRF(layers, channels, 9.0, 10, 3.0, 4, [layers // 2], True,
                   generator=torch.Generator().manual_seed(SEED)).cuda()
    weights = prepare_fused_nerf(student, torch.bfloat16)
    num = TRAIN_POINTS
    positions, views = random_points(num, rng, "cuda")
    with torch.no_grad():
        out = fused_nerf_apply(weights, positions, views)
        ref = fused_nerf_reference(weights, positions, views)
    err = (out - ref).abs()
    macs = nerf_macs(weights)
    pack = pack_bytes(weights)
    grads = (weights.weights.numel() + weights.biases.numel()) * 4
    k1 = {"max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
          "ms": cuda_ms(lambda: fused_nerf_apply(weights, positions, views),
                        FLAGSHIP_REPS),
          "plain_ms": cuda_ms(lambda: fused_nerf_reference(
              weights, positions, views), FLAGSHIP_REPS),
          **bound(2 * macs * num, "bf16", 40 * num + pack)}
    gs, least = backward_cotangents(weights, positions, views, rng)
    table = {key: backward_errors(weights, positions, views, g)
             for key, g in gs.items()}
    shares = {key: max(r[2] for r in rows) for key, rows in table.items()}
    g = gs["random"]
    k2 = {"max_abs_err": max(r[1] for r in table["tail"]),
          "max_rel_err": shares, "tail_least_relu_margin": least,
          "ms": cuda_ms(lambda: fused_nerf_backward(weights, positions,
                                                    views, g), FLAGSHIP_REPS),
          "plain_ms": cuda_ms(lambda: fused_nerf_backward_reference(
              weights, positions, views, g), FLAGSHIP_REPS),
          **bound(3 * 2 * macs * num, "bf16", 40 * num + pack + grads)}
    log(f"K1 and K2 at the student's {layers}x{channels}, N={num:,d}, bf16 "
        f"({macs:,d} MACs a point): K1 max / mean |d| {k1['max_abs_err']:.3e}"
        f" / {k1['mean_abs_err']:.3e} (limits {K1_BF16_ATOL} / "
        f"{K1_BF16_MEAN_ATOL}), {k1['ms']:.4f} ms against twin "
        f"{k1['plain_ms']:.3f} ms, bound {k1['bound_ms']:.4f} ms "
        f"({k1['bound_by']}); K2 max share by cotangent "
        + ", ".join(f"{k} {v:.3e}" for k, v in shares.items())
        + f" (held: tail <= {GRAD_SHARE['tail']['bfloat16']}), "
        f"{k2['ms']:.4f} ms against twin {k2['plain_ms']:.3f} ms, bound "
        f"{k2['bound_ms']:.4f} ms ({k2['bound_by']}) (CUDA events, mean of "
        f"{FLAGSHIP_REPS})")
    if k1["max_abs_err"] > K1_BF16_ATOL \
            or k1["mean_abs_err"] > K1_BF16_MEAN_ATOL \
            or not torch.isfinite(out).all():
        raise AssertionError("K1 at the student's width disagrees with its "
                             "twin")
    if shares["tail"] > GRAD_SHARE["tail"]["bfloat16"]:
        raise AssertionError("K2 at the student's width disagrees with its "
                             "twin under the tail cotangent")
    return {"fused_nerf": k1, "fused_nerf_train": k2,
            "shape": f"{layers}x{channels}, N={num}"}


def _run_distill_cli(flags) -> dict:
    """cli/distill_model in-process; returns its output, the losses
    ``distill`` returned, the graph chunks it built and K1's and K2's
    wrapper counts over the call."""
    from fourier_feature_nets_torch.cli import distill_model
    from fourier_feature_nets_torch.render import raycaster
    returned = []
    inner = distill_model.distill

    def recording(*args, **kwargs):
        result = inner(*args, **kwargs)
        returned.append(result[1])
        return result

    distill_model.distill = recording
    _reset_launches()
    captured = io.StringIO()
    start = time.perf_counter()
    try:
        with _instances(raycaster._GraphChunk) as chunks, \
                contextlib.redirect_stdout(captured):
            rc = distill_model.main(flags)
        torch.cuda.synchronize()
    finally:
        distill_model.distill = inner
    wall = time.perf_counter() - start
    output = captured.getvalue()
    if rc != 0:
        raise AssertionError(f"distill_model {flags} returned {rc}:\n"
                             f"{output[-2000:]}")
    return {"output": output, "losses": returned[0], "chunks": chunks,
            "counts": _launch_counts(), "wall_s": wall}


def _graph_launches(run) -> dict:
    """K1's and K2's launches in a distill CLI call: recorded a chunk in
    each capture, in the replays (captured x replays), and eager (the
    wrapper counts less the captures' recordings: the warm-up chunks)."""
    captured = {k: sum(c.captured[k] * c.captures for c in run["chunks"])
                for k in run["counts"]}
    return {"captured_a_chunk": [c.captured for c in run["chunks"]],
            "replays": [c.replays for c in run["chunks"]],
            "in_graph_replays": {
                k: sum(c.captured[k] * c.replays for c in run["chunks"])
                for k in run["counts"]},
            "eager": {k: run["counts"][k] - captured[k]
                      for k in run["counts"]}}


def phase_distill(checkpoint) -> dict:
    """Distillation of smoke-train's 30-step 8x256 checkpoint into the
    6x192 student with ``--fused`` (1024 rays x 128 samples, the density
    grid's sampler, a 64-camera hemisphere at 400 px): DISTILL_STEPS
    steps in chunks of DISTILL_CALL (one CUDA-graph replay each), then
    ``--resume`` for DISTILL_RESUMED more. K1 and K2 at the student's
    width against their twins first; K1 (teacher and student) and K2
    must run in the captured chunks; the loss must fall DISTILL_FALL
    times; then :func:`distill_step_checks`."""
    rng = np.random.default_rng(SEED + 14)
    kernels = student_kernels(rng)
    out_dir = os.path.join(OUT_DIR, "distill")
    shutil.rmtree(out_dir, ignore_errors=True)
    common = [checkpoint, out_dir, "--device", "cuda", "--fused",
              "--batch-rays", str(DISTILL_BATCH[0]), "--num-samples",
              str(DISTILL_BATCH[1]), "--steps-per-call",
              str(DISTILL_CALL), "--checkpoint-interval", str(DISTILL_CALL),
              "--report-interval", str(DISTILL_CALL)]
    first = _run_distill_cli([*common, "--num-steps", str(DISTILL_STEPS)])
    resumed = _run_distill_cli([*common, "--num-steps",
                                str(DISTILL_STEPS + DISTILL_RESUMED), "--resume"])
    steady = re.search(r"([0-9.]+) ms/step over calls", first["output"])
    steady = float(steady.group(1)) if steady else None
    losses = first["losses"]
    falls = (float(losses[-20:].mean()) * DISTILL_FALL
             <= float(losses[:20].mean()))
    at = re.search(r"Resumed distillation from .*ckpt_(\d+)\.npz at step "
                   r"(\d+)", resumed["output"])
    launches = {"first": _graph_launches(first),
                "resumed": _graph_launches(resumed)}
    row = {"kernels": kernels, "wall_s": [first["wall_s"],
                                          resumed["wall_s"]],
           "ms_per_step": steady, "loss_first_20": float(losses[:20].mean()),
           "loss_last_20": float(losses[-20:].mean()),
           "loss_resumed_last": float(resumed["losses"][-1]),
           "resumed_at": int(at.group(2)) if at else None,
           "resumed_steps": int(resumed["losses"].shape[0]),
           "launches": launches}
    log(f"distill_model --fused, 8x256 -> 6x192, {DISTILL_BATCH[0]} x "
        f"{DISTILL_BATCH[1]}, --steps-per-call {DISTILL_CALL}: "
        f"{DISTILL_STEPS} steps in "
        f"{first['wall_s']:.3f} s for the CLI call, loss {row['loss_first_20']:.4e}"
        f" (steps 1-20) -> {row['loss_last_20']:.4e} (the last 20; held: "
        f"a fall of {DISTILL_FALL:g}x at least); "
        f"--resume: {at.group(0) if at else 'no resume line'}, "
        f"{row['resumed_steps']} steps in {resumed['wall_s']:.3f} s, loss "
        f"{row['loss_resumed_last']:.4e}; {steady} ms a step in the "
        f"replay after the first call (CUDA events); launches {launches}")
    chunk_ok = all(
        len(run["chunks"]) == 1 and run["chunks"][0].captures == 1
        and run["chunks"][0].captured == {"fused_nerf": 2 * DISTILL_CALL,
                                          "fused_nerf_train": DISTILL_CALL}
        for run in (first, resumed))
    if not falls or not chunk_ok or row["resumed_at"] != DISTILL_STEPS \
            or row["resumed_steps"] != DISTILL_RESUMED or steady is None \
            or first["chunks"][0].replays != DISTILL_STEPS // DISTILL_CALL:
        raise AssertionError("distillation did not run its captured "
                             "chunks, fall and resume at step "
                             f"{DISTILL_STEPS}")
    row["one_step"] = distill_step_checks(checkpoint, out_dir)
    row["student"] = os.path.join(out_dir, "student.npz")
    return row


@contextlib.contextmanager
def kernel_twins():
    """K1's and K2's plain twins in place of the kernels on the fused
    distill path (``render/distill.py``'s teacher, ``FusedNeRFTrain``'s
    forward and backward): the same bf16 packs, autograd function, loss
    and Adam, with ``fused_nerf_reference`` for K1 and
    ``fused_nerf_backward_reference`` for K2."""
    from fourier_feature_nets_torch.kernels import fused_nerf_train
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        fused_nerf_reference)
    # the render package's ``distill`` is the function, not its module
    distill_module = importlib.import_module(
        "fourier_feature_nets_torch.render.distill")
    saved = (distill_module.fused_nerf_apply,
             fused_nerf_train.fused_nerf_apply,
             fused_nerf_train.fused_nerf_backward)
    distill_module.fused_nerf_apply = fused_nerf_reference
    fused_nerf_train.fused_nerf_apply = fused_nerf_reference
    fused_nerf_train.fused_nerf_backward = (
        fused_nerf_train.fused_nerf_backward_reference)
    try:
        yield
    finally:
        (distill_module.fused_nerf_apply, fused_nerf_train.fused_nerf_apply,
         fused_nerf_train.fused_nerf_backward) = saved


def _leaf_shares(out: dict, ref: dict, base=None) -> dict:
    """Per leaf, mean |out - ref| over mean |ref - base| (``base`` None:
    over mean |ref|)."""
    shares = {}
    for path, b in ref.items():
        scale = (b - base[path]) if base is not None else b
        shares[path] = (float((out[path] - b).abs().mean())
                        / max(float(scale.abs().mean()), 1e-30))
    return shares


def distill_step_checks(checkpoint, out_dir) -> dict:
    """One distill step on the CLI's sampler three ways, from the fresh
    student (step 0, seeded as the CLI seeds it) and from the
    DISTILL_STEPS checkpoint in ``out_dir``, where Adam's moments make
    the update follow the gradient's size: fused (bf16 K1 for the
    teacher, K1 + K2 for the student), the same step on the kernels'
    plain twins (:func:`kernel_twins`) and plain f32.

    Held, fused against the twins, from both states: the loss within
    DISTILL_TWIN_LOSS_GAP, each leaf's raw gradient (before Adam) within
    GRAD_SHARE["random"] of its mean |twin gradient| in the mean, and
    each leaf's update within CHUNK_MEAN_SHARE of its mean update; the
    fused step launches 2 K1 (teacher, student) and 1 K2, the others
    none. Held, fused against plain f32 from the fresh student: the
    loss within DISTILL_PLAIN_LOSS_GAP and each leaf's update within
    CHUNK_MEAN_SHARE. From the checkpoint the plain f32 step is logged:
    there the loss is ~200x smaller and the teacher's bf16 rounding is
    not small beside the residual the gradient follows."""
    from fourier_feature_nets_torch.cli import distill_model
    from fourier_feature_nets_torch.models import NeRF, load_model
    from fourier_feature_nets_torch.models.serialization import (
        named_parameters)
    from fourier_feature_nets_torch.render import OccupancyGridSampler
    from fourier_feature_nets_torch.render.distill import distill
    from fourier_feature_nets_torch.utils.checkpoint import load_train_state

    args = distill_model.build_parser().parse_args(
        [checkpoint, out_dir, "--device", "cuda", "--num-samples",
         str(DISTILL_BATCH[1])])
    teacher = load_model(checkpoint).cuda().requires_grad_(False)
    cameras, bounds, _, _ = distill_model._supervision(args, "cuda")
    sampler = OccupancyGridSampler.from_model(
        teacher, cameras, args.num_samples, stratified=True,
        grid_resolution=args.occupancy_resolution,
        alpha_threshold=args.density_threshold,
        scale=float(bounds[0, 0]) / 2.0, bounds=bounds)
    state_dir = os.path.join(OUT_DIR, "distill_step")
    shutil.rmtree(state_dir, ignore_errors=True)
    os.makedirs(state_dir)
    source = os.path.join(out_dir, "checkpoints",
                          f"ckpt_{DISTILL_STEPS:08d}.npz")
    shutil.copy(source, state_dir)

    def student(first):
        if first:
            return load_train_state(source).model.cuda()
        layers, channels = args.student_layers, args.student_channels
        return NeRF(layers, channels, 9.0, args.student_freq_pos, 3.0,
                    args.student_freq_view, [layers // 2], True,
                    generator=torch.Generator().manual_seed(args.seed)
                    ).cuda()

    def one_step(first, variant):
        model = student(first)
        start = {k: v.detach().clone()
                 for k, v in named_parameters(model).items()}
        fused = variant != "plain"
        _reset_launches()
        with (kernel_twins() if variant == "twins"
              else contextlib.nullcontext()):
            _, loss = distill(teacher, model, sampler, first + 1,
                              batch_rays=DISTILL_BATCH[0], steps_per_call=1,
                              seed=args.seed, fused_teacher=fused,
                              fused_student=fused, checkpoint_dir=state_dir,
                              resume=first > 0)
        torch.cuda.synchronize()
        leaves = named_parameters(model)
        return {"loss": float(loss[0]), "start": start,
                "grad": {k: v.grad.detach().clone()
                         for k, v in leaves.items()},
                "param": {k: v.detach().clone() for k, v in leaves.items()},
                "launches": _launch_counts()}

    rows = {}
    for first in (0, DISTILL_STEPS):
        runs = {v: one_step(first, v) for v in ("fused", "twins", "plain")}
        fused = runs["fused"]
        row = {"launches": {v: r["launches"] for v, r in runs.items()}}
        for ref in ("twins", "plain"):
            other = runs[ref]
            grads = _leaf_shares(fused["grad"], other["grad"])
            updates = _leaf_shares(fused["param"], other["param"],
                                   other["start"])
            row[ref] = {
                "fused_loss": fused["loss"], "loss": other["loss"],
                "loss_rel_gap": abs(fused["loss"] - other["loss"])
                / other["loss"],
                "grad_mean_share": max(grads.values()),
                "grad_worst_leaf": max(grads, key=grads.get),
                "update_mean_share": max(updates.values()),
                "update_worst_leaf": max(updates, key=updates.get)}
            log(f"one distill step from step {first}, fused (bf16 K1 "
                f"teacher, K1 + K2 student) vs "
                + ("the kernels' twins (the same bf16 packs)"
                   if ref == "twins" else "plain f32")
                + f": loss {fused['loss']:.6e} vs {other['loss']:.6e} (rel "
                f"gap {row[ref]['loss_rel_gap']:.3e}); each leaf's raw "
                f"gradient mean |d| at most "
                f"{row[ref]['grad_mean_share']:.3e} of its mean "
                f"({row[ref]['grad_worst_leaf']}), its update's at most "
                f"{row[ref]['update_mean_share']:.3e} of the mean update "
                f"({row[ref]['update_worst_leaf']}); by leaf (gradient, "
                f"update): " + ", ".join(
                    f"{path} {grads[path]:.2e} {updates[path]:.2e}"
                    for path in grads))
        rows[f"step {first}"] = row
        log(f"launches of the one-step runs from step {first}: "
            f"{row['launches']}")
    failed = []
    for label, row in rows.items():
        twins = row["twins"]
        if (twins["loss_rel_gap"] > DISTILL_TWIN_LOSS_GAP
                or twins["grad_mean_share"] > GRAD_SHARE["random"]["bfloat16"]
                or twins["update_mean_share"] > CHUNK_MEAN_SHARE):
            failed.append(f"{label}: the fused step left its twins' step")
        if (row["launches"]["fused"] != {"fused_nerf": 2,
                                         "fused_nerf_train": 1}
                or any(row["launches"][v] != {"fused_nerf": 0,
                                              "fused_nerf_train": 0}
                       for v in ("twins", "plain"))):
            failed.append(f"{label}: launches {row['launches']}")
    plain = rows["step 0"]["plain"]
    if (plain["loss_rel_gap"] > DISTILL_PLAIN_LOSS_GAP
            or plain["update_mean_share"] > CHUNK_MEAN_SHARE):
        failed.append("step 0: the fused step left the plain f32 step")
    if failed:
        raise AssertionError("; ".join(failed))
    return rows


def _http(url: str, data=None) -> bytes:
    import urllib.request
    request = urllib.request.Request(url, data=data,
                                     method="POST" if data else "GET")
    with urllib.request.urlopen(request, timeout=300) as response:
        return response.read()


def _stream_frames(url: str, count: int) -> int:
    body = _http(f"{url}/stream.mjpeg?count={count}")
    return body.count(b"Content-Type: image/jpeg")


def phase_serve(student_path: str) -> dict:
    """The 6x192 student served at 800x800 ``--preset fast`` on
    127.0.0.1 and an ephemeral port (in-process RenderServer): raw /frame
    equals render_frame, the PNG decodes (zlib) to it, the JPEG is well
    formed, /pose of a rig camera equals /frame; a 16-frame stream, then
    SERVE_CLIENTS concurrent streams, and /stats; the JPEG encoder's ms a
    frame; then ``python -m fourier_feature_nets_torch.cli.serve`` as a
    process: one request, then stopped."""
    import json as json_module
    import threading

    from fourier_feature_nets_torch.cameras import Resolution
    from fourier_feature_nets_torch.cli import orbit_video
    from fourier_feature_nets_torch.cli import serve as serve_cli
    from fourier_feature_nets_torch.kernels.fused_nerf import (
        fused_nerf_apply)
    from fourier_feature_nets_torch.models import load_model
    from fourier_feature_nets_torch.render import Raycaster
    from fourier_feature_nets_torch.render.server import RenderServer, serve
    from fourier_feature_nets_torch.utils import orbit
    from fourier_feature_nets_torch.utils.jpeg import encode_jpeg

    args = serve_cli._parse_args([student_path, str(FRAME_RES), "--preset",
                                  "fast", "--num-frames",
                                  str(SERVE_CAMERAS)])
    cameras = orbit(orbit_video.VECTORS[args.up_dir],
                    orbit_video.VECTORS[args.forward_dir], SERVE_CAMERAS,
                    args.fov_y_degrees, Resolution(FRAME_RES, FRAME_RES),
                    args.distance)
    model = load_model(student_path).cuda()
    sampler = orbit_video.build_render_sampler(
        args, model, cameras, np.diag([2.0, 2.0, 2.0, 1.0]).astype(
            np.float32))
    caster = Raycaster(model, compute_dtype=torch.bfloat16)
    server = RenderServer(caster, sampler, chunk_size=args.chunk_size)
    warmup = server.warmup()
    # each rig camera's K1 launches in a direct frame: the server must
    # launch as many for each frame it serves
    direct, per_camera = [], []
    for camera in range(SERVE_CAMERAS):
        fused_nerf_apply.launches = 0
        direct.append(caster.render_frame(sampler, camera,
                                          chunk_size=args.chunk_size))
        per_camera.append(fused_nerf_apply.launches)
    http = serve(server, "127.0.0.1", 0)
    thread = threading.Thread(target=http.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{http.server_address[1]}"
    shape = (FRAME_RES, FRAME_RES, 3)
    try:
        fused_nerf_apply.launches = 0
        raw = np.frombuffer(_http(f"{url}/frame?camera=3&format=raw"),
                            np.uint8).reshape(shape)
        frame_launches = fused_nerf_apply.launches
        png = png_pixels(_http(f"{url}/frame?camera=3&format=png"))
        jpeg = jpeg_header(_http(f"{url}/frame?camera=3&format=jpg"))
        calibration = {"extrinsics": cameras[2].extrinsics.tolist(),
                       "intrinsics": cameras[2].intrinsics.tolist(),
                       "format": "raw"}
        fused_nerf_apply.launches = 0
        posed = np.frombuffer(_http(f"{url}/pose", json_module.dumps(
            calibration).encode()), np.uint8).reshape(shape)
        pose_launches = fused_nerf_apply.launches
        rig2 = np.frombuffer(_http(f"{url}/frame?camera=2&format=raw"),
                             np.uint8).reshape(shape)
        with server._timing_lock:
            server._timings.clear()
        fused_nerf_apply.launches = 0
        start = time.perf_counter()
        streamed = _stream_frames(url, SERVE_CAMERAS)
        stream_s = time.perf_counter() - start
        one = json_module.loads(_http(f"{url}/stats"))
        with server._timing_lock:
            server._timings.clear()
        counts = [0] * SERVE_CLIENTS

        def client(i):
            counts[i] = _stream_frames(url, SERVE_CAMERAS)

        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(SERVE_CLIENTS)]
        start = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        clients_s = time.perf_counter() - start
        stream_launches = fused_nerf_apply.launches
        many = json_module.loads(_http(f"{url}/stats"))
    finally:
        http.shutdown()
        http.server_close()
        server.close()
    start = time.perf_counter()
    for _ in range(5):
        encode_jpeg(direct[3])
    jpeg_ms = (time.perf_counter() - start) * 1e3 / 5
    row = {"warmup_s": warmup, "launches_a_camera": per_camera,
           "frame_launches": frame_launches, "pose_launches": pose_launches,
           "stream_launches": stream_launches,
           "raw_equals_render_frame": bool(np.array_equal(raw, direct[3])),
           "png_equals_raw": bool(np.array_equal(png, raw)),
           "pose_equals_frame": bool(np.array_equal(posed, rig2)),
           "jpeg": jpeg, "jpeg_encode_ms": jpeg_ms,
           "stream": {"frames": streamed, "wall_s": stream_s,
                      "stats": {k: one.get(k) for k in
                                ("frames", "p50_ms", "p90_ms", "fps")}},
           "clients": {"frames": counts, "wall_s": clients_s,
                       "fps": sum(counts) / clients_s,
                       "stats": {k: many.get(k) for k in
                                 ("frames", "p50_ms", "p90_ms", "fps")}}}
    log(f"serve, the 6x192 student at {FRAME_RES}x{FRAME_RES} --preset fast "
        f"(bf16, K1): warm-up {warmup:.3f} s; raw /frame equals render_frame:"
        f" {row['raw_equals_render_frame']}; PNG (zlib) equals it: "
        f"{row['png_equals_raw']}; JPEG {jpeg}; /pose of rig camera 2 equals"
        f" /frame: {row['pose_equals_frame']}; K1 launches: the direct "
        f"frames {per_camera}, /frame of camera 3 {frame_launches}, /pose "
        f"of camera 2 {pose_launches}, the {1 + SERVE_CLIENTS} streams "
        f"{stream_launches} (held: {1 + SERVE_CLIENTS} x "
        f"{sum(per_camera)}); a {SERVE_CAMERAS}-frame stream {streamed} "
        f"frames in {stream_s:.3f} s, /stats {row['stream']['stats']}; "
        f"{SERVE_CLIENTS} concurrent streams {counts} in {clients_s:.3f} s "
        f"({row['clients']['fps']:.3f} frames/s), /stats "
        f"{row['clients']['stats']}; JPEG encode {jpeg_ms:.3f} ms a frame "
        f"(host, mean of 5)")
    if not (row["raw_equals_render_frame"] and row["png_equals_raw"]
            and row["pose_equals_frame"] and streamed == SERVE_CAMERAS
            and counts == [SERVE_CAMERAS] * SERVE_CLIENTS
            and min(per_camera) > 0 and frame_launches == per_camera[3]
            and pose_launches == per_camera[2]
            and stream_launches == (1 + SERVE_CLIENTS) * sum(per_camera)
            and jpeg["height"] == FRAME_RES and jpeg["width"] == FRAME_RES
            and jpeg["sampling"] == [0x22, 0x11, 0x11]):
        raise AssertionError("the render server's frames disagree, or K1 "
                             "did not run on every frame")
    row["cli"] = serve_cli_process(student_path)
    return row


def serve_cli_process(student_path: str) -> dict:
    """``python -m fourier_feature_nets_torch.cli.serve`` as a process on
    an ephemeral port: one raw frame, then SIGTERM; it must exit 0."""
    import selectors
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    start = time.perf_counter()
    process = subprocess.Popen(
        [sys.executable, "-m", "fourier_feature_nets_torch.cli.serve",
         student_path, str(FRAME_RES), "--preset", "fast", "--port", "0",
         "--num-frames", "8", "--device", "cuda"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        selector = selectors.DefaultSelector()
        selector.register(process.stdout, selectors.EVENT_READ)
        found = None
        while found is None:
            if time.perf_counter() - start > 300 or \
                    not selector.select(timeout=300):
                raise AssertionError("cli.serve did not start:\n"
                                     + "".join(lines[-40:]))
            line = process.stdout.readline()
            if not line:
                raise AssertionError("cli.serve exited:\n"
                                     + "".join(lines[-40:]))
            lines.append(line)
            found = re.search(r"serving .* on (http://\S+)", line)
        ready_s = time.perf_counter() - start
        begin = time.perf_counter()
        body = _http(f"{found.group(1)}/frame?camera=1&format=raw")
        request_ms = (time.perf_counter() - begin) * 1e3
    finally:
        process.terminate()
        try:
            rc = process.wait(timeout=60)
        except subprocess.TimeoutExpired:
            process.kill()
            rc = process.wait()
    log(f"python -m fourier_feature_nets_torch.cli.serve (--preset fast, "
        f"--port 0): serving after {ready_s:.3f} s, one raw frame of "
        f"{len(body):,d} bytes in {request_ms:.3f} ms, exit code {rc} after "
        f"SIGTERM; its lines: {[l.strip() for l in lines]}")
    if len(body) != FRAME_RES * FRAME_RES * 3 or rc != 0:
        raise AssertionError("cli.serve did not serve a frame and stop")
    return {"ready_s": ready_s, "request_ms": request_ms, "rc": rc}


# ---------------------------------------------------------------------------
# the FFN family, the voxel fields and the regression CLIs (no kernel: the
# fused kernels take the NeRF only)
# ---------------------------------------------------------------------------

FFN_STEPS = 200                # tiny NeRF, voxels, image regression steps
FFN_REPORT = 100               # their validation interval (and steps 0-9)
DENSE_STEPS = 1000             # a dense grid's val PSNR first dips, then rises
DENSE_REPORT = 250
FIT_MIN_RISE = 1.0             # dB a fit's val PSNR must rise
FOCUS_STEPS = 10               # train_tiny_nerf --opacity-model <voxels.npz>
VOXEL_SIDE = 128
VOXEL_RANK = 16
IMAGE_SIZE = 512               # train_image_regression's default
SIGNAL_STEPS = 500
CARD_CPU_POINTS = 65_536       # each model type on the card against the CPU
CARD_CPU_TOL = 1e-5            # its tight rtol = atol (f32 readings < 1e-6)
TF32_CONTROL = ("nerf", "fourier_positional", "fourier_gaussian")


def run_main(main, argv):
    """A CLI's ``main(argv)`` with its standard output captured; returns
    (the output, the wall seconds, K1's and K2's launches in the call).
    Raises unless it returns 0 or a log (the regression CLIs)."""
    os.environ["FFN_TORCH_DATA_DIR"] = os.path.join(OUT_DIR, "data")
    _reset_launches()
    captured = io.StringIO()
    start = time.perf_counter()
    with contextlib.redirect_stdout(captured):
        rc = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    output = captured.getvalue()
    if rc not in (0, None) and not isinstance(rc, list):
        raise AssertionError(f"{argv} returned {rc}:\n{output[-2000:]}")
    return output, wall, _launch_counts()


def _no_kernel(label: str, launches: dict) -> None:
    """The fused kernels take a NeRF only: none may launch on an FFN,
    voxel or regression path."""
    if any(launches.values()):
        raise AssertionError(f"{label}: the fused kernels launched "
                             f"{launches} on a path without a NeRF")


def _steady_ms(output: str) -> float:
    """The ms a step after the first call, from a CLI's summary
    line."""
    found = re.search(r"([0-9.]+) ms/step over steps", output)
    if found is None:
        raise AssertionError(f"no ms/step in:\n{output[-2000:]}")
    return float(found.group(1))


def _fit_psnrs(results: str):
    """The (step, train PSNR, val PSNR) rows of a fit's log.txt, all
    finite, at least two."""
    rows = _read_log(os.path.join(results, "log.txt"))
    psnrs = [p for row in rows for p in row[1:]]
    if len(rows) < 2 or not all(np.isfinite(psnrs)):
        raise AssertionError(f"{results}: PSNRs {rows}")
    return rows


def _fit_run(main, label: str, argv) -> dict:
    """A fit CLI (train_tiny_nerf, train_voxels) whose val PSNR must rise
    by more than FIT_MIN_RISE dB from its first report to its last, with
    no fused kernel launched."""
    output, wall, launches = run_main(main, argv)
    _no_kernel(label, launches)
    rows = _fit_psnrs(argv[2])          # the results directory
    row = {"steps": [r[0] for r in rows],
           "train_psnr": [rows[0][1], rows[-1][1]],
           "val_psnr": [rows[0][2], rows[-1][2]],
           "ms_per_step": _steady_ms(output), "wall_s": wall,
           "launches": launches}
    log(f"{label}: val PSNR {row['val_psnr'][0]:.3f} -> "
        f"{row['val_psnr'][1]:.3f} dB, train PSNR "
        f"{row['train_psnr'][0]:.3f} -> {row['train_psnr'][1]:.3f} dB at "
        f"steps {row['steps']} (held: the val PSNR rises by more than "
        f"{FIT_MIN_RISE} dB), "
        f"{row['ms_per_step']:.3f} ms/step (CUDA events, after the first "
        f"call), {wall:.3f} s for the CLI call, K1/K2 launches "
        f"{launches['fused_nerf']}/{launches['fused_nerf_train']} ({CARD})")
    first, last = row["val_psnr"]
    if not last - first > FIT_MIN_RISE:
        raise AssertionError(f"{label}: val PSNR did not rise by more than "
                             f"{FIT_MIN_RISE} dB")
    return row


def phase_tiny_nerf() -> dict:
    """train_tiny_nerf on smoke-train's scene, positional and gaussian,
    at the JAX CLI's widths (3 x 256, embedding 256, 128 samples, 1024
    rays), FFN_STEPS steps each; then orbit_video --preset fast of the
    positional checkpoint (the density grid of a model without views),
    two 800x800 frames that must be well formed and not constant."""
    from fourier_feature_nets_torch.cli import orbit_video, train_tiny_nerf
    rows = {}
    for encoding in ("positional", "gaussian"):
        results = os.path.join(OUT_DIR, "tiny_nerf", encoding)
        rows[encoding] = _fit_run(
            train_tiny_nerf.main, f"train_tiny_nerf {encoding}",
            ["synthetic", encoding, results, "--device", "cuda",
             "--num-steps", str(FFN_STEPS), "--report-interval",
             str(FFN_REPORT), "--image-interval", "0"])
    checkpoint = os.path.join(OUT_DIR, "tiny_nerf", "positional",
                              "tiny_nerf.npz")
    frames_dir = os.path.join(OUT_DIR, "tiny_nerf_frames")
    shutil.rmtree(frames_dir, ignore_errors=True)
    output, wall, launches = run_main(
        orbit_video.main, [checkpoint, str(FRAME_RES), frames_dir,
                           "--device", "cuda", "--preset", "fast",
                           "--num-frames", "2"])
    _no_kernel("orbit_video of a tiny NeRF", launches)
    check_frames(frames_dir, 2, FRAME_RES)
    for name in sorted(os.listdir(frames_dir)):
        with open(os.path.join(frames_dir, name), "rb") as handle:
            pixels = png_pixels(handle.read())
        if pixels.min() == pixels.max():
            raise AssertionError(f"{name}: a constant frame")
    rows["orbit"] = {**orbit_summary(output), "wall_s": wall,
                     "launches": launches}
    orbit_row = rows["orbit"]
    log(f"orbit_video --preset fast of the positional tiny NeRF: 2 frames "
        f"of {FRAME_RES}x{FRAME_RES}, density grid {orbit_row['setup_s']:.3f}"
        f" s, frames {orbit_row['first_frame_ms']:.3f} then "
        f"{orbit_row['steady_frame_ms']:.3f} ms ({CARD})")
    return rows


def phase_train_voxels() -> dict:
    """train_voxels on smoke-train's scene: a dense VOXEL_SIDE^3 grid at
    256 samples for DENSE_STEPS steps and a rank-VOXEL_RANK factorized
    field for FFN_STEPS, each eager and at --steps-per-call CHUNK_STEPS
    (one CUDA graph a chunk), their val PSNR rising; then
    train_tiny_nerf focus-sampled by the dense grid (--opacity-model)
    for FOCUS_STEPS steps."""
    from fourier_feature_nets_torch.cli import train_tiny_nerf, train_voxels
    rows = {}
    # a dense grid's val PSNR moves 0.08 dB in 200 steps and dips before
    # it rises (11.03, 10.84, 11.97, 14.94 dB at steps 0, 250, 500, 1000
    # on an H100), so the dense runs take DENSE_STEPS
    dense = [str(DENSE_STEPS), str(DENSE_REPORT)]
    factorized = [str(FFN_STEPS), str(FFN_REPORT), "--factorized-rank",
                  str(VOXEL_RANK)]
    chunks = ["--steps-per-call", str(CHUNK_STEPS)]
    for label, (steps, report, *flags) in (
            ("dense", dense), ("factorized", factorized),
            ("dense_chunks", dense + chunks),
            ("factorized_chunks", factorized + chunks)):
        results = os.path.join(OUT_DIR, "voxels", label)
        rows[label] = _fit_run(
            train_voxels.main, f"train_voxels {label} side {VOXEL_SIDE}",
            ["synthetic", str(VOXEL_SIDE), results, "--device", "cuda",
             "--num-steps", steps, "--report-interval", report,
             "--image-interval", "0", *flags])
    results = os.path.join(OUT_DIR, "tiny_nerf", "voxel_focus")
    output, wall, launches = run_main(train_tiny_nerf.main, [
        "synthetic", "positional", results, "--device", "cuda",
        "--num-steps", str(FOCUS_STEPS), "--report-interval",
        str(FOCUS_STEPS), "--image-interval", "0", "--opacity-model",
        os.path.join(OUT_DIR, "voxels", "dense", "voxels.npz")])
    _no_kernel("train_tiny_nerf --opacity-model voxels", launches)
    fit_rows = _fit_psnrs(results)
    first, last = fit_rows[0][2], fit_rows[-1][2]
    rows["tiny_nerf_voxel_focus"] = {
        "val_psnr": [first, last], "ms_per_step": _steady_ms(output),
        "wall_s": wall}
    log(f"train_tiny_nerf --opacity-model <dense voxels>: {FOCUS_STEPS + 1} "
        f"focus-sampled steps, val PSNR {first:.3f} -> {last:.3f} dB, "
        f"{rows['tiny_nerf_voxel_focus']['ms_per_step']:.3f} ms/step, "
        f"{wall:.3f} s for the CLI call ({CARD})")
    if not all(np.isfinite([first, last])):
        raise AssertionError("the voxel-focused tiny NeRF's PSNR")
    return rows


def _log_rows(path: str):
    with open(path) as handle:
        lines = handle.read().strip().splitlines()[1:]
    return [[float(v) for v in line.split("\t")] for line in lines]


def phase_regression() -> dict:
    """train_image_regression synthetic:IMAGE_SIZE, gaussian and
    positional, at the CLI's defaults for FFN_STEPS steps (PSNR rises,
    superres.png is 2 IMAGE_SIZE square); train_signal_regression
    multifreq --fourier --no-plot for SIGNAL_STEPS steps (val loss
    falls)."""
    from fourier_feature_nets_torch.cli import (
        train_image_regression,
        train_signal_regression,
    )
    rows = {}
    for encoding in ("gaussian", "positional"):
        results = os.path.join(OUT_DIR, "image_regression", encoding)
        output, wall, launches = run_main(
            train_image_regression.main,
            [f"synthetic:{IMAGE_SIZE}", encoding, results, "--device",
             "cuda", "--image-size", str(IMAGE_SIZE), "--num-steps",
             str(FFN_STEPS)])
        _no_kernel(f"train_image_regression {encoding}", launches)
        psnrs = [row[1] for row in _log_rows(os.path.join(results,
                                                          "log.txt"))]
        shape, _ = png_shape(os.path.join(results, "superres.png"))
        rows[encoding] = {"psnr": [psnrs[0], psnrs[-1]],
                          "ms_per_step": _steady_ms(output), "wall_s": wall}
        log(f"train_image_regression {encoding}: PSNR {psnrs[0]:.3f} -> "
            f"{psnrs[-1]:.3f} dB, {rows[encoding]['ms_per_step']:.3f} "
            f"ms/step (CUDA events), {wall:.3f} s for the CLI call, "
            f"superres {shape} ({CARD})")
        if not psnrs[-1] > psnrs[0]:
            raise AssertionError(f"image regression {encoding}: PSNR "
                                 f"did not rise")
        if shape != (2 * IMAGE_SIZE, 2 * IMAGE_SIZE, 3):
            raise AssertionError(f"superres.png is {shape}")
    results = os.path.join(OUT_DIR, "signal_regression")
    output, wall, launches = run_main(
        train_signal_regression.main,
        ["multifreq", results, "--device", "cuda", "--fourier",
         "--no-plot", "--num-steps", str(SIGNAL_STEPS)])
    _no_kernel("train_signal_regression", launches)
    losses = [row[2] for row in _log_rows(os.path.join(results, "log.txt"))]
    rows["signal"] = {"val_loss": [losses[0], losses[-1]],
                      "ms_per_step": _steady_ms(output), "wall_s": wall}
    log(f"train_signal_regression multifreq --fourier: val loss "
        f"{losses[0]:.4g} -> {losses[-1]:.4g}, "
        f"{rows['signal']['ms_per_step']:.3f} ms/step, {wall:.3f} s for the "
        f"CLI call ({CARD})")
    if not losses[-1] < losses[0]:
        raise AssertionError("signal regression: val loss did not fall")
    return rows


def phase_convert(checkpoints) -> dict:
    """convert_checkpoint NPZ -> .pt -> NPZ of each checkpoint: the
    weights come back bit-equal; a factorized field's .pt must raise."""
    from fourier_feature_nets_torch.cli import convert_checkpoint
    rows = {}
    for label, path in checkpoints.items():
        pt_path = os.path.join(OUT_DIR, "convert", f"{label}.pt")
        back = os.path.join(OUT_DIR, "convert", f"{label}.npz")
        os.makedirs(os.path.dirname(pt_path), exist_ok=True)
        with np.load(path) as data:
            manifest = json.loads(str(data["__manifest__"]))
            before = {k: data[k] for k in data.files if k != "__manifest__"}
        if manifest["type"] == "factorized_voxels":
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    convert_checkpoint.main([path, pt_path])
            except ValueError:
                rows[label] = "no .pt format (raised)"
                continue
            raise AssertionError("a factorized field's .pt did not raise")
        with contextlib.redirect_stdout(io.StringIO()):
            convert_checkpoint.main([path, pt_path])
            convert_checkpoint.main([pt_path, back])
        with np.load(back) as data:
            after = {k: data[k] for k in data.files if k != "__manifest__"}
        if sorted(after) != sorted(before) or not all(
                np.array_equal(after[k], before[k]) for k in before):
            raise AssertionError(f"{label}: the NPZ -> .pt -> NPZ weights "
                                 f"differ")
        rows[label] = f"bit-equal over {len(before)} arrays"
    log("convert_checkpoint NPZ -> .pt -> NPZ: "
        + ", ".join(f"{k}: {v}" for k, v in rows.items()))
    return rows


def _model_zoo():
    """One seeded model of each type at its CLI's full width: the
    flagship NeRF, the tiny NeRF's positional and gaussian FFNs (3 x 256,
    embedding 256), a VOXEL_SIDE^3 grid (random, not the zero init) and
    a rank-VOXEL_RANK factorized field."""
    from fourier_feature_nets_torch import models
    def gen():
        return torch.Generator().manual_seed(SEED)
    voxels = models.Voxels(VOXEL_SIDE, 1.0)
    with torch.no_grad():
        voxels.voxels.normal_(generator=gen())
    return {
        "nerf": models.flagship_nerf(gen()),
        "fourier_positional": models.PositionalFourierMLP(
            3, 4, 5.5, generator=gen()),
        "fourier_gaussian": models.GaussianFourierMLP(
            3, 4, 6.05, generator=gen()),
        "voxels": voxels,
        "factorized_voxels": models.FactorizedVoxels(
            VOXEL_SIDE, 1.0, VOXEL_RANK, generator=gen()),
    }


def phase_card_vs_cpu() -> dict:
    """Each model type at full width on CARD_CPU_POINTS seeded points:
    the module's f32 output on the card against the same module on the
    CPU, within the JAX suite's rtol / atol and within the far tighter
    CARD_CPU_TOL (rtol = atol); each forward timed on the card (CUDA
    events). The control: the MLPs (TF32_CONTROL) again on the card with
    allow_tf32 on, which must break CARD_CPU_TOL, so that the bound
    tells an f32 product from a TF32 one."""
    from fourier_feature_nets_torch.models import query_model
    rng = np.random.default_rng(SEED)
    positions, views = random_points(CARD_CPU_POINTS, rng, "cpu")
    rows = {}
    for label, model in _model_zoo().items():
        with torch.no_grad():
            ref = query_model(model, positions, views)
            on_card = model.cuda()
            pos, vd = positions.cuda(), views.cuda()
            out = query_model(on_card, pos, vd).cpu()
            ms = cuda_ms(lambda: query_model(on_card, pos, vd), 10)
            tf32 = None
            if label in TF32_CONTROL:
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    tf32 = query_model(on_card, pos, vd).cpu()
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
        rel = ref.abs()
        err = (out - ref).abs()
        rows[label] = {
            "max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
            "max_tight_ratio": float((err / (CARD_CPU_TOL * (1 + rel))).max()),
            "ms": ms}
        if tf32 is not None:
            tf32_err = (tf32 - ref).abs()
            rows[label]["tf32_max_abs_err"] = float(tf32_err.max())
            rows[label]["tf32_tight_ratio"] = float(
                (tf32_err / (CARD_CPU_TOL * (1 + rel))).max())
            rows[label]["tf32_within_f32_bound"] = bool(
                (tf32_err <= F32_ATOL + F32_RTOL * rel).all())
        row = rows[label]
        control = ("" if tf32 is None else
                   f"; TF32 control max |d| {row['tf32_max_abs_err']:.3g}, "
                   f"{row['tf32_tight_ratio']:.3g} x the tight bound, "
                   f"{'within' if row['tf32_within_f32_bound'] else 'outside'}"
                   f" the rtol {F32_RTOL} / atol {F32_ATOL} bound")
        log(f"  {label}: card vs CPU on {CARD_CPU_POINTS} points, max |d| "
            f"{row['max_abs_err']:.3g}, mean {row['mean_abs_err']:.3g}, "
            f"{row['max_tight_ratio']:.3g} x the tight bound (rtol = atol "
            f"= {CARD_CPU_TOL}){control}; forward {ms:.4f} ms ({CARD})")
        if not bool((err <= F32_ATOL + F32_RTOL * rel).all()):
            raise AssertionError(f"{label}: the card's f32 output is not "
                                 f"the CPU's within rtol {F32_RTOL} / atol "
                                 f"{F32_ATOL}")
        if not row["max_tight_ratio"] <= 1.0:
            raise AssertionError(f"{label}: the card's f32 output is not "
                                 f"the CPU's within rtol = atol = "
                                 f"{CARD_CPU_TOL}")
        if tf32 is not None and not row["tf32_tight_ratio"] > 1.0:
            raise AssertionError(f"{label}: a TF32 forward passes the tight "
                                 f"bound, which then tells nothing")
        del model, on_card
    return rows


def _step_split(step) -> dict:
    """One call of ``step`` under torch.profiler, after a warm-up call:
    its wall ms (host clock to a synchronise), its device ms summed
    over kernels (None when the trace holds no device time, which
    happened to the last of several traces in one process), and the
    four kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    kernels = sorted(
        ((event.key, getattr(event, "self_device_time_total",
                             getattr(event, "self_cuda_time_total", 0.0))
          / 1e3)
         for event in prof.key_averages()
         if event.device_type == DeviceType.CUDA),
        key=lambda pair: -pair[1])
    device_ms = sum(ms for _, ms in kernels)
    return {"wall_ms": wall_ms, "device_ms": device_ms or None,
            "top_kernels": [[name[:60], ms] for name, ms in kernels[:4]]}


def phase_ffn_step_split() -> dict:
    """Where a step of each new training cell goes: one step of the
    tiny NeRF (positional, 1024 x 128), the dense and the factorized
    voxel fields (1024 x 256) through ``Raycaster``'s train step on
    smoke-train's scene, and one image regression step at IMAGE_SIZE,
    each under torch.profiler."""
    from fourier_feature_nets_torch import models
    from fourier_feature_nets_torch.cli import train_image_regression
    from fourier_feature_nets_torch.datasets import ImageDataset
    from fourier_feature_nets_torch.datasets.pixel_dataset import (
        PixelDataset)
    from fourier_feature_nets_torch.render import Raycaster
    from fourier_feature_nets_torch.utils.optim import ClippedAdam
    scene = os.path.join(OUT_DIR, "data", "synthetic_100.npz")
    rows = {}

    def gen():
        return torch.Generator().manual_seed(SEED)

    for label, model, samples in (
            ("tiny_nerf", models.PositionalFourierMLP(
                3, 4, 5.5, generator=gen()), 128),
            ("voxels_dense", models.Voxels(VOXEL_SIDE, 1.0), 256),
            ("voxels_factorized", models.FactorizedVoxels(
                VOXEL_SIDE, 1.0, VOXEL_RANK, generator=gen()), 256)):
        model = model.cuda()
        data = ImageDataset.load(scene, "train", samples, True, True,
                                 batch_size=1024, device="cuda")
        perm = torch.from_numpy(data.index_pool()).cuda()
        step = Raycaster(model)._make_train_step(
            data, 1024, 1e-3, 0.1, 25000,
            ClippedAdam(model.parameters(), 1e-3))
        rows[label] = _step_split(lambda: step(perm, 0, 1, 1))
    image = os.path.join(OUT_DIR, "data", f"synthetic_image_{IMAGE_SIZE}.png")
    pixels = PixelDataset.create(image, "RGB", IMAGE_SIZE, device="cuda")
    model = models.GaussianFourierMLP(2, 3, 10.0, generator=gen()).cuda()
    step = train_image_regression.make_train_step(model, pixels, 1e-3, 0.1,
                                                  2500)
    rows["image_regression"] = _step_split(lambda: step(1))
    for label, row in rows.items():
        device = ("no device time in the trace (not measured)"
                  if row["device_ms"] is None
                  else f"{row['device_ms']:.3f} ms of device time")
        log(f"  {label}: one step {row['wall_ms']:.3f} ms wall, {device}; "
            "top kernels "
            + "; ".join(f"{name} {ms:.3f}" for name, ms in row["top_kernels"])
            + f" ({CARD})")
    return rows


def phase_ffn_paths() -> dict:
    """The slice's phases, each timed: tiny NeRF (and its orbit), the
    voxel fields, the regressions, the checkpoint conversion and the
    card against the CPU."""
    rows, seconds = {}, {}
    for name, fn in (("tiny_nerf", phase_tiny_nerf),
                     ("train_voxels", phase_train_voxels),
                     ("regression", phase_regression)):
        start = time.perf_counter()
        rows[name] = fn()
        seconds[name] = time.perf_counter() - start
    start = time.perf_counter()
    rows["convert"] = phase_convert({
        "tiny_nerf": os.path.join(OUT_DIR, "tiny_nerf", "gaussian",
                                  "tiny_nerf.npz"),
        "voxels": os.path.join(OUT_DIR, "voxels", "dense", "voxels.npz"),
        "factorized_voxels": os.path.join(OUT_DIR, "voxels", "factorized",
                                          "voxels.npz"),
        "nerf": os.path.join(OUT_DIR, "flagship_seed0.npz")})
    log("each model type on the card against the CPU, f32:")
    rows["card_vs_cpu"] = phase_card_vs_cpu()
    log("one train step of each new cell under torch.profiler:")
    rows["step_split"] = phase_ffn_step_split()
    seconds["convert_card_vs_cpu_split"] = time.perf_counter() - start
    rows["phase_s"] = seconds
    log("FFN, voxel and regression phases: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in seconds.items())
        + f", {sum(seconds.values()):.3f} s in all ({CARD})")
    return rows


def _ffn_launches(ffn, kernel: str) -> dict:
    """A kernel's launches on the FFN, voxel and orbit paths (0: the
    fused kernels take a NeRF only)."""
    return {"train_tiny_nerf_positional":
                ffn["tiny_nerf"]["positional"]["launches"][kernel],
            "train_tiny_nerf_gaussian":
                ffn["tiny_nerf"]["gaussian"]["launches"][kernel],
            "orbit_tiny_nerf": ffn["tiny_nerf"]["orbit"]["launches"][kernel],
            "train_voxels_dense":
                ffn["train_voxels"]["dense"]["launches"][kernel],
            "train_voxels_factorized":
                ffn["train_voxels"]["factorized"]["launches"][kernel],
            **{f"train_voxels_{name}":
               ffn["train_voxels"][name]["launches"][kernel]
               for name in ("dense_chunks", "factorized_chunks")}}


def _chunk_launches(chunks, resume, occupancy, kernel: str) -> dict:
    """A kernel's launches on the chunked, resumed and occupancy-guided
    train paths: eager (the wrapper's count: warm-up, validation) and in
    the CUDA-graph replays (captured launches x replays; the replays
    themselves call no wrapper)."""
    rows = {f"train_nerf_chunks_{dtype}": {
        "eager": chunks[dtype]["eager_launches"][kernel],
        "in_graph_replays": chunks[dtype]["launches_in_replays"][kernel]}
        for dtype in ("bfloat16", "float32")}
    for name, row in (("train_nerf_resume", resume),
                      ("train_nerf_occupancy", occupancy)):
        rows[name] = {"eager": row["launches"][kernel],
                      "in_graph_replays":
                          row["captured_launches"][kernel] * row["replays"]}
    return rows


# ---------------------------------------------------------------------------
# queue 1, item 7: --make-video, the comparison strip, a voxel teacher,
# mesh export, the sweep, the inspector, the sampler switches, debug NaNs
# ---------------------------------------------------------------------------

VIDEO_STEPS = 40               # train_nerf --make-video (flagship, bf16)
VIDEO_FRAMES = 4               # --num-frames: a frame every 10 steps, 0..40
VIDEO_SHORT_STEPS = 10         # train_voxels / train_tiny_nerf --make-video
BALL_SIDE = 24                 # tests/test_mesh_export.py's ball field
BALL_RADIUS = 0.5
MESH_RESOLUTION = 192          # export_mesh's default
MESH_CPU_RESOLUTION = 64       # the card's vertices against the CPU's
MESH_CPU_ATOL = 1e-5
SWEEP_VALUES = ("16", "32")    # --num-channels of the two sweep runs
SWEEP_STEPS = 200


def _video_frames(results: str, count: int, resolution: int,
                  varied: bool) -> list:
    """``count`` orbit frames ``video/frame_NNNNN.png``, each well formed
    (resolution^2 x 3, read back with zlib) and, when ``varied``, not
    constant (a zero-initialized voxel grid renders black at first)."""
    frames_dir = os.path.join(results, "video")
    names = sorted(os.listdir(frames_dir))
    if names != [f"frame_{i:05d}.png" for i in range(count)]:
        raise AssertionError(f"unexpected frames: {names}")
    for name in names:
        with open(os.path.join(frames_dir, name), "rb") as handle:
            pixels = png_pixels(handle.read())
        if pixels.shape != (resolution, resolution, 3) or (
                varied and pixels.min() == pixels.max()):
            raise AssertionError(f"{frames_dir}/{name}: {pixels.shape}, "
                                 f"{pixels.min()}..{pixels.max()}")
    return names


@contextlib.contextmanager
def _visualizer_launches(cls):
    """K1's launches inside ``cls.visualize`` alone (the frames), summed
    over the block."""
    counted = {"fused_nerf": 0}
    inner = cls.visualize

    def counting(self, *args, **kwargs):
        before = _launch_counts()["fused_nerf"]
        inner(self, *args, **kwargs)
        counted["fused_nerf"] += _launch_counts()["fused_nerf"] - before

    cls.visualize = counting
    try:
        yield counted
    finally:
        cls.visualize = inner


def phase_make_video() -> dict:
    """``--make-video`` of the three NeRF-field trainers on smoke-train's
    scene: train_nerf at the flagship (8x256), bf16, --fused for
    VIDEO_STEPS steps with VIDEO_FRAMES frames (at JAX's cadence, steps
    0, 10, .., 40: one more frame than --num-frames), whose frames must
    launch K1; then train_voxels (a VOXEL_SIDE^3 grid) and
    train_tiny_nerf (positional, 3 x 256) for VIDEO_SHORT_STEPS steps
    with 2 frames, which launch no kernel. Every frame is well formed;
    the flagship's are not constant (a zero-initialized grid renders
    black at first)."""
    from fourier_feature_nets_torch import visualizers
    from fourier_feature_nets_torch.cli import (train_nerf, train_tiny_nerf,
                                                train_voxels)
    resolution = 100                      # the synthetic scene's cameras
    rows = {}
    runs = (
        ("train_nerf", train_nerf.main, [], VIDEO_STEPS, VIDEO_FRAMES,
         ["--compute-dtype", "bfloat16", "--fused"]),
        ("train_voxels", train_voxels.main, [str(VOXEL_SIDE)],
         VIDEO_SHORT_STEPS, 2, []),
        ("train_tiny_nerf", train_tiny_nerf.main, ["positional"],
         VIDEO_SHORT_STEPS, 2, []))
    for label, main, positional, steps, frames, flags in runs:
        results = os.path.join(OUT_DIR, "make_video", label)
        shutil.rmtree(results, ignore_errors=True)
        with _visualizer_launches(visualizers.OrbitVideoVisualizer) as k1:
            output, wall, launches = run_main(main, [
                "synthetic", *positional, results, "--device", "cuda",
                "--num-steps", str(steps), "--report-interval", str(steps),
                "--make-video", "--num-frames", str(frames), *flags])
        varied = label == "train_nerf"
        names = _video_frames(results, steps // (steps // frames) + 1,
                              resolution, varied)
        rows[label] = {"frames": len(names), "frame_launches": k1[
            "fused_nerf"], "launches": launches, "wall_s": wall,
            "ms_per_step": _steady_ms(output)}
        log(f"{label} --make-video --num-frames {frames}, {steps} steps: "
            f"{len(names)} frames of {resolution}x{resolution} in video/ "
            f"(well formed{', not constant' if varied else ''}), K1 "
            f"launches in the frames "
            f"{k1['fused_nerf']}, in the whole call {launches}, "
            f"{rows[label]['ms_per_step']:.3f} ms/step, {wall:.3f} s for "
            f"the CLI call ({CARD})")
    if rows["train_nerf"]["frame_launches"] <= 0:
        raise AssertionError("the fused train_nerf's orbit frames did not "
                             "launch K1")
    for label in ("train_voxels", "train_tiny_nerf"):
        _no_kernel(f"{label} --make-video", rows[label]["launches"])
    return rows


def phase_comparison(checkpoint) -> dict:
    """One ComparisonVisualizer strip of smoke-train's checkpoint (bf16,
    through K1): the train set's first cameras beside the val set's,
    ground truth beside the prediction, (H * cameras, 4 W, 3)."""
    from fourier_feature_nets_torch.cli.common import resolve_data_path
    from fourier_feature_nets_torch.datasets import ImageDataset
    from fourier_feature_nets_torch.models import load_model
    from fourier_feature_nets_torch.render import Raycaster
    from fourier_feature_nets_torch.visualizers import ComparisonVisualizer
    os.environ["FFN_TORCH_DATA_DIR"] = os.path.join(OUT_DIR, "data")
    scene = resolve_data_path("synthetic", "cuda")
    val = ImageDataset.load(scene, "val", 128, device="cuda")
    train = ImageDataset.load(scene, "train", 128, device="cuda").subset(
        list(range(val.num_cameras)), 128, False, "train")
    caster = Raycaster(load_model(checkpoint).cuda(),
                       compute_dtype=torch.bfloat16)
    out_dir = os.path.join(OUT_DIR, "comparison")
    shutil.rmtree(out_dir, ignore_errors=True)
    visualizer = ComparisonVisualizer(out_dir, 1, 1, train, val)
    _reset_launches()
    start = time.perf_counter()
    visualizer.visualize(0, lambda s, d: caster.batched_render(s, 16384, d),
                         None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = _launch_counts()["fused_nerf"]
    shape, peak = png_shape(os.path.join(out_dir, "compare",
                                         "frame_00000.png"))
    width, height = val.cameras[0].resolution
    expected = (height * val.num_cameras, 4 * width, 3)
    log(f"ComparisonVisualizer of the 30-step checkpoint: strip {shape} "
        f"(held: {expected}), max pixel {peak}, {wall * 1e3:.3f} ms, K1 "
        f"launches {launches} ({CARD})")
    if shape != expected or peak == 0 or launches <= 0:
        raise AssertionError("the comparison strip")
    return {"shape": list(shape), "ms": wall * 1e3, "launches": launches}


def phase_distill_voxels() -> dict:
    """distill_model --fused of the dense VOXEL_SIDE^3 grid
    (phase_train_voxels' checkpoint) into the 6x192 student: 1024 rays x
    128 samples on the stratified uniform sampler a non-NeRF teacher
    takes, DISTILL_STEPS steps in chunks of DISTILL_CALL, each one
    CUDA-graph replay. Held: the loss falls; each capture records K1 and
    K2 once a step, the student's (the teacher's query is plain: K1 0
    times for it)."""
    teacher = os.path.join(OUT_DIR, "voxels", "dense", "voxels.npz")
    out_dir = os.path.join(OUT_DIR, "distill_voxels")
    shutil.rmtree(out_dir, ignore_errors=True)
    run = _run_distill_cli([
        teacher, out_dir, "--device", "cuda", "--fused", "--batch-rays",
        str(DISTILL_BATCH[0]), "--num-samples", str(DISTILL_BATCH[1]),
        "--steps-per-call", str(DISTILL_CALL), "--report-interval",
        str(DISTILL_CALL), "--num-steps", str(DISTILL_STEPS)])
    steady = re.search(r"([0-9.]+) ms/step over calls", run["output"])
    losses = run["losses"]
    launches = _graph_launches(run)
    row = {"ms_per_step": float(steady.group(1)) if steady else None,
           "loss_first_20": float(losses[:20].mean()),
           "loss_last_20": float(losses[-20:].mean()),
           "wall_s": run["wall_s"], "launches": launches}
    log(f"distill_model --fused, dense {VOXEL_SIDE}^3 voxels -> 6x192, "
        f"{DISTILL_BATCH[0]} x {DISTILL_BATCH[1]}, --steps-per-call "
        f"{DISTILL_CALL}: {DISTILL_STEPS} steps in {run['wall_s']:.3f} s "
        f"for the CLI call, loss {row['loss_first_20']:.4e} (steps 1-20) "
        f"-> {row['loss_last_20']:.4e} (the last 20; held: it falls); "
        f"{row['ms_per_step']} ms a step in the replay after the first "
        f"call (CUDA events; predicted 2.3-3.0); launches {launches} "
        f"({CARD})")
    student_only = {"fused_nerf": DISTILL_CALL,
                    "fused_nerf_train": DISTILL_CALL}
    if not row["loss_last_20"] < row["loss_first_20"] \
            or row["ms_per_step"] is None or len(run["chunks"]) != 1 \
            or run["chunks"][0].captured != student_only \
            or launches["in_graph_replays"]["fused_nerf_train"] <= 0:
        raise AssertionError("distillation from the voxel teacher did not "
                             "fall, or its captures were not the "
                             f"student's K1 and K2 alone: {launches}")
    return row


def _ball_voxels(path: str) -> None:
    """tests/test_mesh_export.py's field: an opaque red ball of radius
    BALL_RADIUS in a BALL_SIDE^3 Voxels grid over [-1, 1]^3, saved."""
    from fourier_feature_nets_torch.models import Voxels, save_model
    centers = (np.arange(BALL_SIDE) + 0.5) / BALL_SIDE * 2 - 1
    z, y, x = np.meshgrid(centers, centers, centers, indexing="ij")
    inside = x * x + y * y + z * z < BALL_RADIUS ** 2
    grid = np.zeros((4, BALL_SIDE, BALL_SIDE, BALL_SIDE), np.float32)
    grid[0], grid[1:3] = 15.0, -15.0
    grid[3] = np.where(inside, 200.0, -200.0)
    model = Voxels(BALL_SIDE, 1.0)
    with torch.no_grad():
        model.voxels.copy_(torch.from_numpy(grid)[None])
        model.bias.zero_()
    save_model(model, path)


def _obj_counts(path: str):
    """(vertices, faces) of an OBJ, every face's indices within the
    vertices and every vertex with its color."""
    verts = faces = 0
    with open(path) as obj:
        for line in obj:
            if line.startswith("v "):
                verts += 1
                if len(line.split()) != 7:
                    raise AssertionError(f"a vertex line {line!r}")
            elif line.startswith("f "):
                faces += 1
                if not all(1 <= int(i) <= verts for i in line.split()[1:]):
                    raise AssertionError(f"a face line {line!r}")
    return verts, faces


def phase_export_mesh(checkpoint) -> dict:
    """export_mesh on the card: the ball field at the CLI's default
    MESH_RESOLUTION (vertex radii within one of the ball grid's cells of
    BALL_RADIUS, the OBJ parses), the card's vertices at
    MESH_CPU_RESOLUTION against the CPU's (within MESH_CPU_ATOL, the
    same triangles), and the field sweep of smoke-train's 8x256
    checkpoint at MESH_RESOLUTION^3 points timed, with its peak device
    memory (nothing held about its surface)."""
    from fourier_feature_nets_torch.cli import export_mesh
    from fourier_feature_nets_torch.mesh_export import (alpha_field,
                                                        mesh_from_model,
                                                        surface_nets)
    from fourier_feature_nets_torch.models import load_model
    out_dir = os.path.join(OUT_DIR, "mesh")
    os.makedirs(out_dir, exist_ok=True)
    ball = os.path.join(out_dir, "ball.npz")
    _ball_voxels(ball)
    obj = os.path.join(out_dir, "ball.obj")
    output, wall, _ = run_main(export_mesh.main,
                               [ball, obj, "--device", "cuda"])
    verts, faces = _obj_counts(obj)
    with open(obj) as handle:
        points = np.array([[float(v) for v in line.split()[1:4]]
                           for line in handle if line.startswith("v ")])
    radii = np.linalg.norm(points, axis=1)
    cell = 2.0 / BALL_SIDE
    row = {"ball": {"vertices": verts, "faces": faces, "wall_s": wall,
                    "radius_min": float(radii.min()),
                    "radius_max": float(radii.max())}}
    log(f"export_mesh of the ball field at {MESH_RESOLUTION}^3: {verts} "
        f"vertices, {faces} triangles, radii {radii.min():.4f}..."
        f"{radii.max():.4f} (held: within {cell:.4f} of {BALL_RADIUS}), "
        f"{wall:.3f} s for the CLI call ({CARD})")
    if verts < 1000 or np.abs(radii - BALL_RADIUS).max() >= cell:
        raise AssertionError("the ball's mesh")

    model = load_model(ball)
    ours = mesh_from_model(model.cuda(), MESH_CPU_RESOLUTION)
    ref = mesh_from_model(model.cpu(), MESH_CPU_RESOLUTION)
    gap = float(np.abs(ours[0] - ref[0]).max())
    row["card_vs_cpu"] = {"vertices": len(ours[0]), "max_abs_err": gap}
    log(f"mesh_from_model at {MESH_CPU_RESOLUTION}^3, card against CPU: "
        f"{len(ours[0])} vertices, max |d| {gap:.3e} (held: "
        f"{MESH_CPU_ATOL:g}), the same triangles ({CARD})")
    if ours[0].shape != ref[0].shape or gap > MESH_CPU_ATOL \
            or not np.array_equal(ours[1], ref[1]):
        raise AssertionError("the card's mesh is not the CPU's")

    nerf = load_model(checkpoint).cuda()
    alpha_field(nerf, 16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    field = alpha_field(nerf, MESH_RESOLUTION)
    query_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated()
    start = time.perf_counter()
    vertices, triangles = surface_nets(field - 0.5, 0.0)
    nets_s = time.perf_counter() - start
    row["nerf_8x256"] = {"query_s": query_s, "peak_bytes": peak,
                         "surface_nets_s": nets_s,
                         "vertices": len(vertices),
                         "alpha_max": float(field.max())}
    log(f"mesh field sweep of the 30-step 8x256 checkpoint at "
        f"{MESH_RESOLUTION}^3 = {MESH_RESOLUTION ** 3} points (plain f32, "
        f"batches of 2^18, one host copy): {query_s:.4f} s (predicted "
        f"0.15-0.5; the FFMA bound ~0.125), peak device memory "
        f"{peak / 2 ** 20:.1f} MiB; surface nets on the host "
        f"{nets_s:.3f} s, {len(vertices)} vertices at alpha 0.5 (max alpha "
        f"{field.max():.3f}; not held) ({CARD})")
    return row


def phase_sweep() -> dict:
    """sweep train_signal_regression, grid over --num-channels
    SWEEP_VALUES, two trainer processes at a time on the card, each
    SWEEP_STEPS steps of multifreq --fourier --no-plot; held: both exit
    0 with a finite val loss, and the sweep names a best run. (The
    signal trainer has no --learning-rate flag, in JAX neither.)"""
    from fourier_feature_nets_torch.cli import sweep
    codes = {}
    inner = sweep._launch

    def recording(trainer, run_dir, trainer_args, overrides, extra_env=None):
        code = inner(trainer, run_dir, trainer_args, overrides, extra_env)
        codes[os.path.basename(run_dir)] = code
        return code

    sweep_dir = os.path.join(OUT_DIR, "sweep")
    shutil.rmtree(sweep_dir, ignore_errors=True)
    sweep._launch = recording
    start = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            best, scores = sweep.run_sweep(
                "train_signal_regression", "num-channels",
                list(SWEEP_VALUES), sweep_dir,
                ["multifreq", "--device", "cuda", "--fourier", "--no-plot",
                 "--num-steps", str(SWEEP_STEPS), "--report-interval",
                 str(SWEEP_STEPS // 2)],
                metric="val_loss", max_concurrent=2)
    finally:
        sweep._launch = inner
    wall = time.perf_counter() - start
    log(f"sweep train_signal_regression --num-channels "
        f"{','.join(SWEEP_VALUES)}, 2 at a time on the card: exit codes "
        f"{codes}, best val loss by run {scores}, best {best}, {wall:.3f} s "
        f"({CARD})")
    if sorted(codes.values()) != [0, 0] or not all(
            np.isfinite(list(scores.values()))) or best not in SWEEP_VALUES:
        raise AssertionError("the sweep's runs")
    return {"codes": codes, "scores": scores, "best": best, "wall_s": wall}


def phase_inspect() -> dict:
    """inspect_ray_sampling on smoke-train's scene, plain and
    --stratified --opacity-model <the dense voxels>: a mask PNG a mode a
    camera (4 cameras; full, sparse, center, dilate) and
    t_histogram.png."""
    from fourier_feature_nets_torch.cli import inspect_ray_sampling
    rows = {}
    for label, flags in (("plain", []), ("stratified_focus", [
            "--stratified", "--opacity-model",
            os.path.join(OUT_DIR, "voxels", "dense", "voxels.npz")])):
        out_dir = os.path.join(OUT_DIR, "inspect", label)
        shutil.rmtree(out_dir, ignore_errors=True)
        output, wall, _ = run_main(inspect_ray_sampling.main,
                                   ["synthetic", out_dir, "--device",
                                    "cuda", *flags])
        names = sorted(os.listdir(out_dir))
        masks = [n for n in names if n.endswith(".png")
                 and n != "t_histogram.png"]
        expected = {f"{mode}_cam{c:03d}.png" for c in range(4)
                    for mode in ("full", "sparse", "center", "dilate")}
        shape, _ = png_shape(os.path.join(out_dir, "t_histogram.png"))
        rows[label] = {"masks": len(masks), "wall_s": wall}
        log(f"inspect_ray_sampling {label}: {len(masks)} mask PNGs, "
            f"t_histogram.png {shape}, {wall:.3f} s for the CLI call "
            f"({CARD})")
        if set(masks) != expected or shape != (400, 800, 3):
            raise AssertionError(f"inspect_ray_sampling {label}: {names}")
    return rows


def phase_sampler_switches(model) -> dict:
    """The occupancy sampler's modes on bench.py's tree (the smoke-octree
    sampler, 32 samples, bf16 through K1) at FRAME_RES: one frame in each
    of ``trilinear=True`` and ``probe_mode="gather"`` beside the default,
    each timed; held: the gather mode's hit set within the default's
    (max-pooling only grows occupancy), and each culled frame within 1
    of the same mode's unculled frame on every pixel it renders (the
    random flagship has density everywhere, so the culled rays, black in
    the culled frame, are counted, not held). Then a focus frame with
    FFN_TORCH_IID_FOCUS_QUANTILES set (a frame draws no jitter: equal to
    the frame without it) and a stratified 1024-ray batch of that
    sampler with and without it (the iid quantiles sorted, and not the
    stratified ones)."""
    from fourier_feature_nets_torch.cameras import Resolution
    from fourier_feature_nets_torch.cli import orbit_video
    from fourier_feature_nets_torch.octree import OcTree
    from fourier_feature_nets_torch.render import (OccupancyGridSampler,
                                                   Raycaster, RaySampler)
    from fourier_feature_nets_torch.utils import orbit
    args = orbit_video._parse_args(["m.npz", str(FRAME_RES), OUT_DIR])
    cameras = orbit(orbit_video.VECTORS[args.up_dir],
                    orbit_video.VECTORS[args.forward_dir], 3,
                    args.fov_y_degrees, Resolution(FRAME_RES, FRAME_RES),
                    args.distance)
    bounds = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
    tree = OcTree.load(os.path.join(OUT_DIR, "bench_tree.npz"))
    caster = Raycaster(model, compute_dtype=torch.bfloat16)
    rows, hits = {}, {}
    for mode, kwargs in (("default", {}), ("trilinear", {"trilinear": True}),
                         ("gather", {"probe_mode": "gather"})):
        sampler = OccupancyGridSampler.from_tree(tree, cameras, 32,
                                                 bounds=bounds,
                                                 device="cuda", **kwargs)
        hits[mode] = Raycaster._compute_hit(sampler, 1, 1)
        _reset_launches()
        culled = caster.render_frame(sampler, 1)
        launches = _launch_counts()["fused_nerf"]
        frame_ms = _frames_ms(caster, sampler, [1], reps=3)
        whole = caster.render_frame(sampler, 1, cull_empty=False)
        gap = np.abs(culled.astype(int) - whole.astype(int)).max(-1)
        drawn = culled.any(-1)
        rows[mode] = {"frame_ms": frame_ms, "launches": launches,
                      "hit_rays": int(hits[mode].sum()),
                      "max_gap_rendered": int(gap[drawn].max(initial=0)),
                      "pixels_off_culled": int((gap[~drawn] > 1).sum())}
        log(f"occupancy sampler {mode}, bench tree at {FRAME_RES}px, 32 "
            f"samples, bf16: {frame_ms:.3f} ms a frame (mean of 3 after a "
            f"warm-up), K1 launches {launches}, {rows[mode]['hit_rays']} hit "
            f"rays (stride 1); culled vs unculled: max |d| "
            f"{rows[mode]['max_gap_rendered']} on the rendered pixels "
            f"(held: 1), {rows[mode]['pixels_off_culled']} culled pixels the "
            f"unculled frame colors (not held) ({CARD})")
        if launches <= 0 or rows[mode]["max_gap_rendered"] > 1:
            raise AssertionError(f"the {mode} sampler's frame")
    if bool((hits["gather"] & ~hits["default"]).any()):
        raise AssertionError("the gather mode hit a ray the max-pooled "
                             "table missed")
    log(f"gather hit set within the default's: "
        f"{rows['gather']['hit_rays']} of {rows['default']['hit_rays']}")

    focus_cameras = cameras[1:2]
    sampler = RaySampler(bounds, focus_cameras, 64, "cuda", stratified=True,
                         opacity_model=model)
    plain = caster.render_frame(sampler, 0, cull_empty=False)
    offsets = torch.arange(0, FRAME_RES * FRAME_RES, 625, device="cuda")
    batch = {}
    for iid in (False, True):
        if iid:
            os.environ["FFN_TORCH_IID_FOCUS_QUANTILES"] = "1"
        try:
            start = time.perf_counter()
            frame = caster.render_frame(sampler, 0, cull_empty=False)
            focus_ms = (time.perf_counter() - start) * 1e3
            batch[iid] = sampler.sample_camera_rays(0, offsets, 3, 7)[0]
        finally:
            os.environ.pop("FFN_TORCH_IID_FOCUS_QUANTILES", None)
    t_iid = batch[True].t_values
    rows["iid_focus"] = {"frame_ms": focus_ms,
                         "frame_equal": bool(np.array_equal(frame, plain))}
    log(f"focus frame with FFN_TORCH_IID_FOCUS_QUANTILES: {focus_ms:.3f} ms,"
        f" equal to the frame without it: {rows['iid_focus']['frame_equal']}"
        f"; a stratified batch of {offsets.numel()} rays: sorted t "
        f"{bool((t_iid.diff(dim=-1) >= 0).all())}, differs from the "
        f"stratified draw {not torch.equal(t_iid, batch[False].t_values)} "
        f"({CARD})")
    if not rows["iid_focus"]["frame_equal"] or not bool(
            (t_iid.diff(dim=-1) >= 0).all()) or torch.equal(
            t_iid, batch[False].t_values):
        raise AssertionError("the iid focus quantiles")
    return rows


def phase_debug_nans() -> dict:
    """One plain (not fused) flagship train step (1024 rays x 128) with a
    NaN in one weight: under enable_debug_nans it raises, without it it
    does not. Then whether a CUDA graph captures a backward under the
    NaN check, and that a graph chunk refuses the switch."""
    from fourier_feature_nets_torch.cli.common import resolve_data_path
    from fourier_feature_nets_torch.datasets import ImageDataset
    from fourier_feature_nets_torch.models import flagship_nerf
    from fourier_feature_nets_torch.render import Raycaster
    from fourier_feature_nets_torch.render.raycaster import _GraphChunk
    from fourier_feature_nets_torch.utils.debug import enable_debug_nans
    from fourier_feature_nets_torch.utils.optim import ClippedAdam
    os.environ["FFN_TORCH_DATA_DIR"] = os.path.join(OUT_DIR, "data")
    dataset = ImageDataset.load(resolve_data_path("synthetic", "cuda"),
                                "train", 128, stratified=True, device="cuda")
    perm = torch.from_numpy(np.asarray(dataset.index_pool(), np.int64)
                            ).cuda()
    row = {}
    for debug in (False, True):
        model = flagship_nerf(torch.Generator().manual_seed(SEED)).cuda()
        with torch.no_grad():
            model.layers[0].weight[0, 0] = float("nan")
        caster = Raycaster(model, fused=False, fused_train=False)
        step = caster._make_train_step(dataset, 1024, 5e-4, 0.1, 250000,
                                       ClippedAdam(model.parameters(), 5e-4))
        enable_debug_nans(debug)
        try:
            start = time.perf_counter()
            loss = float(step(perm, 0, 0, 0))
            row[f"debug_{debug}"] = f"no raise, loss {loss}"
        except RuntimeError as error:
            row[f"debug_{debug}"] = f"raised: {str(error)[:160]}"
        finally:
            torch.cuda.synchronize()
            row[f"debug_{debug}_ms"] = (time.perf_counter() - start) * 1e3
            enable_debug_nans(False)
    layer = torch.nn.Linear(64, 64).cuda()
    x = torch.randn(256, 64, device="cuda")
    layer(x).sum().backward()
    enable_debug_nans(True)
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            layer(x).sum().backward()
        row["graph_capture"] = "captured"
    except RuntimeError as error:
        row["graph_capture"] = f"raised: {str(error)[:200]}"
    try:
        _GraphChunk(lambda inputs: None,
                    ClippedAdam(layer.parameters(), 1e-3, capturable=True),
                    ("step",))(0)
        row["graph_chunk"] = "ran"
    except ValueError as error:
        row["graph_chunk"] = f"ValueError: {str(error)[:120]}"
    finally:
        enable_debug_nans(False)
    torch.cuda.synchronize()
    log(f"debug NaNs, flagship plain step with a NaN weight: without the "
        f"switch {row['debug_False']} ({row['debug_False_ms']:.1f} ms); "
        f"with it {row['debug_True']} ({row['debug_True_ms']:.1f} ms); a "
        f"CUDA graph capture of a backward under the NaN check: "
        f"{row['graph_capture']}; a graph chunk under it: "
        f"{row['graph_chunk']} ({CARD})")
    if not row["debug_True"].startswith("raised") \
            or not row["debug_False"].startswith("no raise") \
            or not row["graph_chunk"].startswith("ValueError"):
        raise AssertionError("the debug NaN switch")
    return row


def phase_item7_paths(model, checkpoint) -> dict:
    """The slice's phases, each timed."""
    rows, seconds = {}, {}
    for name, fn, args in (
            ("make_video", phase_make_video, ()),
            ("comparison", phase_comparison, (checkpoint,)),
            ("distill_voxels", phase_distill_voxels, ()),
            ("export_mesh", phase_export_mesh, (checkpoint,)),
            ("sweep", phase_sweep, ()),
            ("inspect", phase_inspect, ()),
            ("sampler_switches", phase_sampler_switches, (model,)),
            ("debug_nans", phase_debug_nans, ())):
        start = time.perf_counter()
        rows[name] = fn(*args)
        seconds[name] = time.perf_counter() - start
    rows["phase_s"] = seconds
    log("item-7 phases: " + ", ".join(f"{k} {v:.3f} s"
                                      for k, v in seconds.items())
        + f", {sum(seconds.values()):.3f} s in all ({CARD})")
    return rows


def _item7_launches(item7, kernel: str) -> dict:
    """A kernel's launches on the item-7 paths: the orbit frames of each
    --make-video trainer (K1), the comparison strip (K1), the voxel
    teacher's distillation (eager and in the graph replays) and the
    sampler modes' frames (K1)."""
    distill = item7["distill_voxels"]["launches"]
    rows = {"distill_voxel_teacher": {
        "in_graph_replays": distill["in_graph_replays"][kernel],
        "eager": distill["eager"][kernel]}}
    if kernel == "fused_nerf":
        rows.update({f"make_video_{label}": row["frame_launches"]
                     for label, row in item7["make_video"].items()})
        rows["comparison"] = item7["comparison"]["launches"]
        rows.update({f"occupancy_{mode}_frame": item7["sampler_switches"][
            mode]["launches"] for mode in ("trilinear", "gather")})
    else:
        rows.update({f"make_video_{label}": row["launches"][kernel]
                     for label, row in item7["make_video"].items()})
    return rows


# ---------------------------------------------------------------------------
# queue 1, item 7, sub-items 8-12: the MP4 writer (orbit_video --mp4,
# near_orbit, the regressions' --make-video), JPEG input, the view-angle
# animation, the scenepic entry points, and a one-rank NCCL mesh
# ---------------------------------------------------------------------------

MP4_FRAMES = 3                 # orbit_video --mp4 --preset fast frames
MP4_MIN_PSNR = 25.0            # each decoded sample against its PNG (dB)
NEAR_FRAMES = 10               # near_orbit's frames
NEAR_RES = 256
REGRESSION_VIDEO_STEPS = 20    # train_image_regression --make-video
JPEG_SIDE = 512                # the decode timing's image
MESH_BATCH = 1024              # rays a step under the mesh (global)
MESH_SAMPLES = 64
MESH_STEPS = 8                 # steps of each mesh run (eager; 2 chunks of 4)
MESH_CHUNK = 4
MESH_LOSS_RTOL = 1e-3          # mesh against no mesh: K2's atomics only
SERVE_MESH_FRAMES = 3


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _psnr(a, b) -> float:
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64))
                  ** 2)
    return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))


def phase_mp4_orbit() -> dict:
    """``orbit_video --mp4`` on the seeded flagship at ``--preset fast``:
    K1 renders the frames; every MP4 sample is the port's JPEG of its
    PNG byte for byte and decodes (the port's decoder) close to it; the
    encode and the decode are timed on the host."""
    from fourier_feature_nets_torch.utils.jpeg import decode_jpeg, encode_jpeg
    from fourier_feature_nets_torch.utils.png import read_png
    from fourier_feature_nets_torch.utils.video import read_mp4
    checkpoint = os.path.join(OUT_DIR, "flagship_seed0.npz")
    frames_dir = os.path.join(OUT_DIR, "mp4_frames")
    mp4 = os.path.join(OUT_DIR, "orbit.mp4")
    output, launches, wall = run_orbit(
        checkpoint, frames_dir, FRAME_RES,
        ["--preset", "fast", "--num-frames", str(MP4_FRAMES), "--mp4", mp4])
    check_frames(frames_dir, MP4_FRAMES, FRAME_RES)
    rate, size, samples = read_mp4(mp4)
    if (rate, size, len(samples)) != (20.0, (FRAME_RES, FRAME_RES),
                                      MP4_FRAMES):
        raise AssertionError(f"orbit.mp4: {rate} fps, {size}, "
                             f"{len(samples)} samples")
    encode_ms, decode_ms, psnrs = [], [], []
    for index, sample in enumerate(samples):
        png = read_png(os.path.join(frames_dir, f"frame_{index:05d}.png"))
        start = time.perf_counter()
        data = encode_jpeg(png)
        encode_ms.append((time.perf_counter() - start) * 1e3)
        start = time.perf_counter()
        decoded = decode_jpeg(sample)
        decode_ms.append((time.perf_counter() - start) * 1e3)
        psnrs.append(_psnr(decoded, png))
        if data != sample:
            raise AssertionError(f"sample {index} is not the JPEG of its "
                                 "PNG")
    row = {"launches": launches, "wall_s": wall, "bytes": os.path.getsize(mp4),
           "encode_ms_per_frame": float(np.mean(encode_ms)),
           "decode_ms_per_frame": float(np.mean(decode_ms)),
           "psnr_db": psnrs,
           "cli_line": [l for l in output.splitlines() if "wrote" in l]}
    log(f"orbit_video --preset fast --mp4: {MP4_FRAMES} frames of "
        f"{FRAME_RES}x{FRAME_RES}, K1 launches {launches}, {wall:.3f} s for "
        f"the CLI call, {row['bytes']:,d} bytes of MJPEG in MP4; "
        f"{row['cli_line']}; the port's JPEG encode "
        f"{row['encode_ms_per_frame']:.1f} ms a frame and decode "
        f"{row['decode_ms_per_frame']:.1f} ms a frame (host), decoded "
        f"samples against their PNGs {', '.join(f'{p:.2f}' for p in psnrs)} "
        f"dB ({CARD})")
    if launches <= 0 or min(psnrs) < MP4_MIN_PSNR:
        raise AssertionError("orbit_video --mp4")
    return row


def phase_video_clis() -> dict:
    """``near_orbit`` on the synthetic scene, ``train_image_regression
    --make-video`` (5 fps, a frame a report) and
    ``train_signal_regression --make-video``, which draws with matplotlib:
    without it (the card's machine) it must raise naming matplotlib."""
    from fourier_feature_nets_torch.cli import (near_orbit,
                                                train_image_regression,
                                                train_signal_regression)
    from fourier_feature_nets_torch.cli.common import resolve_data_path
    from fourier_feature_nets_torch.utils.jpeg import decode_jpeg
    from fourier_feature_nets_torch.utils.video import read_mp4
    os.environ["FFN_TORCH_DATA_DIR"] = os.path.join(OUT_DIR, "data")
    rows = {}
    near = os.path.join(OUT_DIR, "near_orbit.mp4")
    output, wall, launches = run_main(near_orbit.main, [
        resolve_data_path("synthetic", "cuda"), near, "--num-frames",
        str(NEAR_FRAMES), "--resolution", str(NEAR_RES)])
    rate, size, samples = read_mp4(near)
    shapes = {decode_jpeg(s).shape for s in samples}
    rows["near_orbit"] = {"wall_s": wall, "frames": len(samples)}
    log(f"near_orbit: {len(samples)} frames of {size} at {rate} fps in "
        f"{wall:.3f} s, decoded shapes {shapes}")
    if len(samples) != NEAR_FRAMES or shapes != {(NEAR_RES, NEAR_RES, 3)}:
        raise AssertionError("near_orbit")
    _no_kernel("near_orbit", launches)

    results = os.path.join(OUT_DIR, "image_video")
    shutil.rmtree(results, ignore_errors=True)
    output, wall, launches = run_main(train_image_regression.main, [
        "synthetic:256", "gaussian", results, "--device", "cuda",
        "--image-size", "64", "--num-steps", str(REGRESSION_VIDEO_STEPS),
        "--report-interval", "10", "--make-video"])
    rate, size, samples = read_mp4(os.path.join(results, "training.mp4"))
    rows["image_regression"] = {"wall_s": wall, "frames": len(samples),
                                "framerate": rate}
    log(f"train_image_regression --make-video: {len(samples)} frames of "
        f"{size} at {rate} fps, {wall:.3f} s for the CLI call")
    if len(samples) != 3 or rate != 5.0 or size != (128, 64):
        raise AssertionError("train_image_regression --make-video")
    _no_kernel("train_image_regression --make-video", launches)

    argv = ["multifreq", os.path.join(OUT_DIR, "signal_video"), "--device",
            "cuda", "--num-steps", "10", "--report-interval", "5",
            "--make-video"]
    try:
        import matplotlib  # noqa: F401
        have_matplotlib = True
    except ModuleNotFoundError:
        have_matplotlib = False
    if have_matplotlib:
        run_main(train_signal_regression.main, argv)
        outcome = "wrote training.mp4 (matplotlib is installed)"
    else:
        try:
            run_main(train_signal_regression.main, argv)
        except ModuleNotFoundError as error:
            if "matplotlib" not in str(error):
                raise
            outcome = f"raised ModuleNotFoundError: {error}"
        else:
            raise AssertionError("train_signal_regression --make-video ran "
                                 "without matplotlib")
    rows["signal_regression"] = outcome
    log(f"train_signal_regression --make-video: {outcome}")
    return rows


def phase_jpeg_input() -> dict:
    """``PixelDataset`` from a ``.jpg`` (the port's encoder, of the
    synthetic test image) and a few image-regression steps on it; the
    decode of a 512px JPEG timed on the host."""
    from fourier_feature_nets_torch.cli import train_image_regression
    from fourier_feature_nets_torch.datasets import PixelDataset
    from fourier_feature_nets_torch.datasets.synthetic import (
        generate_synthetic_image)
    from fourier_feature_nets_torch.utils.jpeg import decode_jpeg, encode_jpeg
    from fourier_feature_nets_torch.utils.png import read_png
    png = os.path.join(OUT_DIR, "test_image.png")
    generate_synthetic_image(png, JPEG_SIDE)
    image = read_png(png)
    data = encode_jpeg(image)
    path = os.path.join(OUT_DIR, "test_image.jpg")
    with open(path, "wb") as handle:
        handle.write(data)
    times = []
    for _ in range(3):
        start = time.perf_counter()
        decoded = decode_jpeg(data)
        times.append((time.perf_counter() - start) * 1e3)
    dataset = PixelDataset.create(path, "RGB", 64, device="cuda")
    results = os.path.join(OUT_DIR, "jpeg_regression")
    shutil.rmtree(results, ignore_errors=True)
    output, wall, _ = run_main(train_image_regression.main, [
        path, "positional", results, "--device", "cuda", "--image-size",
        "64", "--num-steps", "20", "--report-interval", "10"])
    psnrs = [float(v) for v in re.findall(r"val: ([0-9.]+)", output)]
    row = {"decode_ms": float(np.median(times)), "bytes": len(data),
           "psnr_db": _psnr(decoded, image), "val_psnr": psnrs,
           "dataset_device": str(dataset.device)}
    log(f"JPEG input: a {JPEG_SIDE}px test image as a {len(data):,d}-byte "
        f"JPEG decodes in {row['decode_ms']:.1f} ms (median of 3, host) at "
        f"{row['psnr_db']:.2f} dB; PixelDataset on {dataset.device}; "
        f"train_image_regression on the .jpg: val PSNR {psnrs} ({CARD})")
    if len(psnrs) != 3 or not all(np.isfinite(psnrs)) \
            or dataset.device.type != "cuda":
        raise AssertionError("JPEG input")
    return row


def phase_view_angle(checkpoint) -> dict:
    """``view_angle_animation`` of smoke-train's 30-step flagship
    checkpoint on the synthetic scene: the source pixel's depth through
    K1 (bf16), the frames drawn in NumPy and written as PNGs and an
    MP4."""
    from fourier_feature_nets_torch.cli.common import resolve_data_path
    from fourier_feature_nets_torch.datasets import ImageDataset
    from fourier_feature_nets_torch.lecture import view_angle_animation
    from fourier_feature_nets_torch.models import load_model
    from fourier_feature_nets_torch.render import Raycaster
    from fourier_feature_nets_torch.utils.video import read_mp4
    os.environ["FFN_TORCH_DATA_DIR"] = os.path.join(OUT_DIR, "data")
    dataset = ImageDataset.load(resolve_data_path("synthetic", "cuda"),
                                "train", 64, device="cuda")
    caster = Raycaster(load_model(checkpoint).cuda(),
                       compute_dtype=torch.bfloat16)
    out = os.path.join(OUT_DIR, "lecture")
    shutil.rmtree(out, ignore_errors=True)
    _reset_launches()
    start = time.perf_counter()
    count = view_angle_animation(dataset, caster, out, angle_threshold=0.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = _launch_counts()["fused_nerf"]
    _, size, samples = read_mp4(os.path.join(out, "view_angle.mp4"))
    row = {"frames": count, "launches": launches, "wall_s": wall,
           "ms_per_frame": wall * 1e3 / max(count, 1), "size": size}
    log(f"view_angle_animation (30-step flagship, bf16, fused): {count} "
        f"frames of {size}, {row['ms_per_frame']:.1f} ms a frame over "
        f"{wall:.3f} s (depth, drawing, PNG and JPEG writes), K1 launches "
        f"{launches} ({CARD})")
    if count < 1 or len(samples) != count or launches <= 0:
        raise AssertionError("view_angle_animation")
    return row


def phase_scenepic() -> dict:
    """The three ``to_scenepic`` entry points raise the JAX package's
    ImportError: scenepic is not installed."""
    from fourier_feature_nets_torch.cli.common import resolve_data_path
    from fourier_feature_nets_torch.datasets import ImageDataset
    from fourier_feature_nets_torch.models import flagship_nerf
    from fourier_feature_nets_torch.render import Raycaster
    dataset = ImageDataset.load(resolve_data_path("synthetic", "cuda"),
                                "val", 8, device="cuda")
    caster = Raycaster(flagship_nerf(torch.Generator().manual_seed(SEED))
                       .cuda())
    raised = []
    for call in (dataset.cameras[0].to_scenepic, dataset.to_scenepic,
                 lambda: caster.to_scenepic(dataset)):
        try:
            call()
        except ImportError as error:
            raised.append(str(error))
    log(f"to_scenepic: {len(raised)} of 3 entry points raised ImportError "
        f"({raised[:1]})")
    if len(raised) != 3 or not all("scenepic" in r for r in raised):
        raise AssertionError("to_scenepic did not raise ImportError")
    return {"raised": raised}


def _mesh_steps(train, mesh, calls: int):
    """MESH_STEPS fused bf16 flagship steps from the seeded weights, one
    a call (eager) or ``calls`` a call (a CUDA graph), under ``mesh`` or
    none; returns (each call's loss, ms a step after the first call, the
    wrappers' launches, the graph chunk or None)."""
    from fourier_feature_nets_torch.models import flagship_nerf
    from fourier_feature_nets_torch.render import Raycaster
    from fourier_feature_nets_torch.render import raycaster as raycaster_mod
    from fourier_feature_nets_torch.utils.optim import ClippedAdam
    model = flagship_nerf(torch.Generator().manual_seed(SEED)).cuda()
    caster = Raycaster(model, compute_dtype=torch.bfloat16)
    optimizer = ClippedAdam(model.parameters(), 5e-4, capturable=calls > 1)
    pool = torch.from_numpy(train.index_pool())
    perm = pool[torch.randperm(len(pool), generator=torch.Generator()
                               .manual_seed(SEED))].cuda()
    _reset_launches()
    with _instances(raycaster_mod._GraphChunk) as chunks:
        step = caster._make_train_step(train, MESH_BATCH, 5e-4, 0.1, 250000,
                                       optimizer, calls, mesh)
        losses, marks = [], []
        for k in range(MESH_STEPS // calls):
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            marks.append(event)
            losses.append(step(perm, k * calls * MESH_BATCH, k * calls, 7))
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
    marks.append(end)
    ms = marks[1].elapsed_time(marks[-1]) / (MESH_STEPS - calls)
    return ([float(v) for v in losses], ms, _launch_counts(),
            chunks[0] if chunks else None)


def phase_mesh(checkpoint) -> dict:
    """A one-rank NCCL mesh (``MASTER_ADDR=127.0.0.1``, a free port):
    fused bf16 flagship steps under it and without it, eager and in a
    CUDA-graph chunk that captures the all-reduce, their losses held
    within MESH_LOSS_RTOL and their ms a step compared (the all-reduce's
    cost); ``train_nerf --data-parallel --steps-per-call`` (fit under the
    mesh); a ``--preset fast`` frame under the mesh against the frame
    without it, within 1; ``serve --data-parallel`` as a process of its
    own one-rank group answering a few requests. The group stays up for
    ``validate_kernels``' mesh checks."""
    import selectors

    import torch.distributed as dist

    from fourier_feature_nets_torch.cli.common import resolve_data_path
    from fourier_feature_nets_torch.datasets import ImageDataset
    from fourier_feature_nets_torch.models import load_model
    from fourier_feature_nets_torch.parallel import (initialize_distributed,
                                                     make_mesh)
    from fourier_feature_nets_torch.render import (OccupancyGridSampler,
                                                   Raycaster)
    from fourier_feature_nets_torch.cameras import Resolution
    from fourier_feature_nets_torch.utils import orbit
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                      WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    os.environ["FFN_TORCH_DATA_DIR"] = os.path.join(OUT_DIR, "data")
    if not initialize_distributed(device="cuda"):
        raise AssertionError("initialize_distributed did not start a group")
    mesh = make_mesh()
    backend = dist.get_backend()
    if backend != "nccl" or (mesh.size, mesh.rank) != (1, 0):
        raise AssertionError(f"mesh {mesh} on {backend}")
    scene = resolve_data_path("synthetic", "cuda")
    train = ImageDataset.load(scene, "train", MESH_SAMPLES, stratified=True,
                              device="cuda")
    rows = {"mesh": repr(mesh)}
    for label, calls in (("eager", 1), ("chunk", MESH_CHUNK)):
        plain = _mesh_steps(train, None, calls)
        meshed = _mesh_steps(train, mesh, calls)
        err = max(abs(a - b) / abs(b) for a, b in zip(meshed[0], plain[0]))
        chunk = meshed[3]
        launches = meshed[2]
        if chunk is not None:
            launches = {"eager": launches, "in_graph_replays": {
                k: v * chunk.replays for k, v in chunk.captured.items()}}
            if any(chunk.captured[k] != calls for k in chunk.captured):
                raise AssertionError(f"the mesh chunk captured "
                                     f"{chunk.captured}")
        rows[label] = {"losses": meshed[0], "plain_losses": plain[0],
                       "max_rel_err": err, "ms_per_step": meshed[1],
                       "plain_ms_per_step": plain[1], "launches": launches}
        log(f"flagship fused bf16, {MESH_BATCH} rays x {MESH_SAMPLES} "
            f"samples, {label} ({calls} step(s) a call): under the one-rank "
            f"NCCL mesh {meshed[1]:.3f} ms/step against "
            f"{plain[1]:.3f} without it; losses {meshed[0]} against "
            f"{plain[0]}, max rel err {err:.2e}; launches {launches} "
            f"({CARD})")
        if err > MESH_LOSS_RTOL:
            raise AssertionError(f"mesh {label} losses")
    if rows["eager"]["launches"]["fused_nerf_train"] != MESH_STEPS:
        raise AssertionError("the eager mesh steps did not launch K2 once "
                             "a step")

    # fit under the mesh, through the CLI, in graph chunks
    _reset_launches()
    output, caster, chunks = run_train_cli(
        os.path.join(OUT_DIR, "mesh_train"),
        ["--data-parallel", "--compute-dtype", "bfloat16", "--fused",
         "--steps-per-call", str(MESH_CHUNK), "--num-steps",
         str(MESH_STEPS - 1), "--report-interval", str(MESH_STEPS),
         "--image-interval", "0", "--num-samples", str(MESH_SAMPLES)])
    eager = _launch_counts()
    fit_launches = {"eager": eager, "in_graph_replays": {
        k: v * sum(c.replays for c in chunks)
        for k, v in chunks[0].captured.items()}}
    rows["fit_cli"] = {"launches": fit_launches,
                       "ms_per_step": _steady_ms_per_step(caster)}
    log(f"train_nerf --data-parallel --steps-per-call {MESH_CHUNK} (one-rank "
        f"NCCL mesh): {sum(caster.call_steps)} steps, "
        f"{rows['fit_cli']['ms_per_step']:.3f} ms/step after the capture, "
        f"launches {fit_launches}")
    if not os.path.exists(os.path.join(OUT_DIR, "mesh_train", "nerf.npz")):
        raise AssertionError("train_nerf --data-parallel wrote no model")

    # a culled frame under the mesh against the frame without it
    model = load_model(checkpoint).cuda()
    cameras = orbit(np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, -1.0]),
                    2, 40.0, Resolution(FRAME_RES, FRAME_RES), 4.0)
    sampler = OccupancyGridSampler.from_model(
        model, cameras, 48,
        bounds=np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32))
    frame_caster = Raycaster(model, compute_dtype=torch.bfloat16)
    frame_caster.render_frame(sampler, 1)
    _reset_launches()
    start = time.perf_counter()
    ours = frame_caster.render_frame(sampler, 1, mesh=mesh)
    mesh_ms = (time.perf_counter() - start) * 1e3
    frame_launches = _launch_counts()["fused_nerf"]
    start = time.perf_counter()
    ref = frame_caster.render_frame(sampler, 1)
    plain_ms = (time.perf_counter() - start) * 1e3
    diff = int(np.abs(ours.astype(int) - ref.astype(int)).max())
    rows["frame"] = {"max_diff": diff, "launches": frame_launches,
                     "ms": mesh_ms, "plain_ms": plain_ms}
    log(f"render_frame(mesh=...) of the 30-step checkpoint, {FRAME_RES}px "
        f"--preset fast: max |diff| {diff} against the frame without the "
        f"mesh, {mesh_ms:.1f} ms against {plain_ms:.1f} ms (host clock, one "
        f"frame each), K1 launches {frame_launches} ({CARD})")
    if diff > 1 or frame_launches <= 0 or not ours.any():
        raise AssertionError("render_frame under the mesh")

    # serve --data-parallel: a process of its own, a one-rank group
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               MASTER_PORT=str(_free_port()))
    start = time.perf_counter()
    process = subprocess.Popen(
        [sys.executable, "-m", "fourier_feature_nets_torch.cli.serve",
         checkpoint, "400", "--preset", "fast", "--port", "0",
         "--num-frames", "8", "--device", "cuda", "--data-parallel"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines, bodies = [], []
    try:
        selector = selectors.DefaultSelector()
        selector.register(process.stdout, selectors.EVENT_READ)
        found = None
        while found is None:
            if time.perf_counter() - start > 300 or \
                    not selector.select(timeout=300):
                raise AssertionError("serve --data-parallel did not start:\n"
                                     + "".join(lines[-40:]))
            line = process.stdout.readline()
            if not line:
                raise AssertionError("serve --data-parallel exited:\n"
                                     + "".join(lines[-40:]))
            lines.append(line)
            found = re.search(r"serving .* on (http://\S+)", line)
        begin = time.perf_counter()
        for camera in range(SERVE_MESH_FRAMES):
            bodies.append(_http(f"{found.group(1)}/frame?camera={camera}"
                                "&format=raw"))
        request_ms = (time.perf_counter() - begin) * 1e3 / SERVE_MESH_FRAMES
    finally:
        process.terminate()
        try:
            rc = process.wait(timeout=60)
        except subprocess.TimeoutExpired:
            process.kill()
            rc = process.wait()
    rows["serve"] = {"frames": len(bodies), "request_ms": request_ms,
                     "rc": rc}
    log(f"serve --data-parallel (a one-rank NCCL group, 400px --preset "
        f"fast): {len(bodies)} raw frames, {request_ms:.1f} ms a request, "
        f"exit code {rc} after SIGTERM")
    if rc != 0 or any(len(b) != 400 * 400 * 3 for b in bodies):
        raise AssertionError("serve --data-parallel")
    return rows


def phase_finish_paths(checkpoint) -> dict:
    """The sub-items 8-12 phases, each timed."""
    rows, seconds = {}, {}
    for name, fn, args in (
            ("mp4_orbit", phase_mp4_orbit, ()),
            ("video_clis", phase_video_clis, ()),
            ("jpeg_input", phase_jpeg_input, ()),
            ("view_angle", phase_view_angle, (checkpoint,)),
            ("scenepic", phase_scenepic, ()),
            ("mesh", phase_mesh, (checkpoint,))):
        start = time.perf_counter()
        rows[name] = fn(*args)
        seconds[name] = time.perf_counter() - start
    rows["phase_s"] = seconds
    log("sub-items 8-12 phases: " + ", ".join(f"{k} {v:.3f} s"
                                              for k, v in seconds.items())
        + f", {sum(seconds.values()):.3f} s in all ({CARD})")
    return rows


def _finish_launches(finish, kernel: str) -> dict:
    """A kernel's launches on the sub-items 8-12 paths: the --mp4 orbit
    and the view-angle depth (K1), the mesh steps (eager, and in the
    graph replays), fit under the mesh through the CLI, the frame under
    the mesh (K1)."""
    mesh = finish["mesh"]
    chunk = mesh["chunk"]["launches"]
    rows = {"mesh_steps_eager": mesh["eager"]["launches"][kernel],
            "mesh_steps_chunk": {
                "eager": chunk["eager"][kernel],
                "in_graph_replays": chunk["in_graph_replays"][kernel]},
            "train_nerf_data_parallel": {
                "eager": mesh["fit_cli"]["launches"]["eager"][kernel],
                "in_graph_replays":
                    mesh["fit_cli"]["launches"]["in_graph_replays"][kernel]}}
    if kernel == "fused_nerf":
        rows.update(orbit_mp4=finish["mp4_orbit"]["launches"],
                    view_angle=finish["view_angle"]["launches"],
                    mesh_frame=mesh["frame"]["launches"])
    return rows


# ---------------------------------------------------------------------------
# the asset cache and the downloader: a named model and dataset, get_rays
# ---------------------------------------------------------------------------

ASSET_FRAMES = 2               # orbit_video frames of a cached model
ASSET_TRAIN_STEPS = 6          # train_nerf steps on a cached dataset
ASSET_RAYS = 20000             # get_rays' dataset-local indices


@contextlib.contextmanager
def _asset_cache():
    """A fresh ``FFN_TORCH_DATA_DIR`` and an empty working directory, both
    under ``OUT_DIR``; the old cache variable and directory come back
    after the block."""
    import tempfile
    saved_dir, saved_cwd = os.environ.get("FFN_TORCH_DATA_DIR"), os.getcwd()
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as root:
        cache, work = os.path.join(root, "cache"), os.path.join(root, "work")
        os.makedirs(os.path.join(cache, "models"))
        os.makedirs(work)
        os.environ["FFN_TORCH_DATA_DIR"] = cache
        os.chdir(work)
        try:
            yield cache
        finally:
            os.chdir(saved_cwd)
            if saved_dir is None:
                os.environ.pop("FFN_TORCH_DATA_DIR", None)
            else:
                os.environ["FFN_TORCH_DATA_DIR"] = saved_dir


def _asset_train(data: str, results: str) -> dict:
    """``train_nerf --fused`` in bf16 for ``ASSET_TRAIN_STEPS`` steps on
    ``data``: K1's and K2's launches and the wall seconds."""
    from fourier_feature_nets_torch.cli import train_nerf
    _reset_launches()
    captured = io.StringIO()
    start = time.perf_counter()
    with contextlib.redirect_stdout(captured):
        rc = train_nerf.main([data, results, "--num-steps",
                              str(ASSET_TRAIN_STEPS), "--report-interval",
                              str(ASSET_TRAIN_STEPS), "--compute-dtype",
                              "bfloat16", "--fused"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    output = captured.getvalue()
    if rc != 0 or not os.path.exists(os.path.join(results, "nerf.npz")):
        raise AssertionError(f"train_nerf {data} returned {rc}:\n"
                             f"{output[-2000:]}")
    return {**_launch_counts(), "wall_s": wall}


def phase_assets(model, device="cuda") -> dict:
    """The loaders' data cache, on the card and off the network, under a
    temporary ``FFN_TORCH_DATA_DIR``: (a) ``orbit_video <name>.npz`` of
    the seeded flagship from ``models/`` in the cache, whose frames must
    equal the same CLI's from the checkpoint's own path, with K1 launched
    as often; (b) ``train_nerf <name>.npz --fused`` in bf16 on the
    synthetic scene from the cache, with K1 and K2 launched as on the
    ``synthetic`` path; (c) ``ImageDataset.get_rays`` on ``cuda`` with a
    pixel subset, rendered through K1, whose uint8 colours must equal
    those of ``sampler.sample`` on the same filtered ids; (d)
    ``download_asset`` of an unknown name returns False and writes
    nothing. ``device`` is where (c) runs (``cpu`` for a rehearsal)."""
    from fourier_feature_nets_torch.datasets import ImageDataset, Mode
    from fourier_feature_nets_torch.render import Raycaster
    from fourier_feature_nets_torch.utils import download_asset
    from fourier_feature_nets_torch.utils.png import read_png
    checkpoint = os.path.join(OUT_DIR, "flagship_seed0.npz")
    scene = os.path.join(OUT_DIR, "data", "synthetic_100.npz")
    row, seconds = {}, {}
    with _asset_cache() as cache:
        start = time.perf_counter()
        shutil.copyfile(checkpoint,
                        os.path.join(cache, "models", "smoke_flagship.npz"))
        frames = {}
        for how, path in (("cached", "smoke_flagship.npz"),
                          ("direct", checkpoint)):
            frames_dir = os.path.join(OUT_DIR, "asset_frames", how)
            _, launches, wall = run_orbit(
                path, frames_dir, FRAME_RES,
                ["--preset", "fast", "--num-frames", str(ASSET_FRAMES)])
            check_frames(frames_dir, ASSET_FRAMES, FRAME_RES)
            frames[how] = [read_png(os.path.join(
                frames_dir, f"frame_{i:05d}.png")).astype(np.int32)
                for i in range(ASSET_FRAMES)]
            row[f"orbit_{how}"] = {"launches": launches, "wall_s": wall}
        max_d = max(int(np.abs(a - b).max())
                    for a, b in zip(frames["cached"], frames["direct"]))
        per_frame = row["orbit_cached"]["launches"] / ASSET_FRAMES
        row["orbit_max_abs_diff"] = max_d
        log(f"  (a) orbit_video smoke_flagship.npz from the cache: "
            f"{ASSET_FRAMES} frames of {FRAME_RES}x{FRAME_RES}, K1 launches "
            f"{row['orbit_cached']['launches']} ({per_frame:.1f} a frame; "
            f"{row['orbit_direct']['launches']} from the direct path), "
            f"frames max |d| {max_d} against the direct path, "
            f"{row['orbit_cached']['wall_s']:.3f} s for the CLI call")
        if (max_d != 0 or row["orbit_cached"]["launches"] <= 0
                or row["orbit_cached"]["launches"]
                != row["orbit_direct"]["launches"]):
            raise AssertionError("orbit_video from the cache")
        seconds["a_orbit"] = time.perf_counter() - start

        start = time.perf_counter()
        os.environ["FFN_TORCH_DATA_DIR"] = os.path.join(OUT_DIR, "data")
        row["train_synthetic"] = _asset_train(
            "synthetic", os.path.join(OUT_DIR, "asset_train", "synthetic"))
        os.environ["FFN_TORCH_DATA_DIR"] = cache
        shutil.copyfile(scene, os.path.join(cache, "smoke_scene.npz"))
        row["train_cached"] = _asset_train(
            "smoke_scene.npz", os.path.join(OUT_DIR, "asset_train", "cached"))
        cached, direct = row["train_cached"], row["train_synthetic"]
        log(f"  (b) train_nerf smoke_scene.npz --fused bf16 from the cache, "
            f"{ASSET_TRAIN_STEPS} steps: K1 {cached['fused_nerf']}, K2 "
            f"{cached['fused_nerf_train']} launches (synthetic path: K1 "
            f"{direct['fused_nerf']}, K2 {direct['fused_nerf_train']}), "
            f"{cached['wall_s']:.3f} s for the CLI call")
        if (cached["fused_nerf"] <= 0 or cached["fused_nerf_train"] <= 0
                or cached["fused_nerf"] != direct["fused_nerf"]
                or cached["fused_nerf_train"] != direct["fused_nerf_train"]):
            raise AssertionError("train_nerf from the cache")
        seconds["b_train"] = time.perf_counter() - start

        start = time.perf_counter()
        data = ImageDataset.load("smoke_scene.npz", "train", 64,
                                 device=device)
        data.mode = Mode.Center
        subset = range(0, data.sampler.rays_per_camera, 2)
        data.subsample_index = subset
        local = np.arange(min(ASSET_RAYS, len(data)))
        ids = data.crop_index[local]
        ids = data.to_valid(ids[np.isin(ids % data.sampler.rays_per_camera,
                                        np.asarray(subset))])
        caster = Raycaster(model, torch.bfloat16, fused=True)
        _reset_launches()
        samples = data.get_rays(local)
        colors = caster.render(samples).color
        torch.cuda.synchronize()
        launches = _launch_counts()["fused_nerf"]
        expected = caster.render(data.sampler.sample(
            torch.from_numpy(ids).to(device))).color

        def to_u8(color):
            return (color.float().clamp(0, 1) * 255).to(torch.uint8).cpu()

        staged = samples.to("cpu").pin_memory().to(device, non_blocking=True)
        equal = (torch.equal(samples.rays.cpu(), torch.from_numpy(ids))
                 and torch.equal(to_u8(colors), to_u8(expected))
                 and all(torch.equal(a, b) for a, b in zip(staged, samples)))
        row["get_rays"] = {"rays": len(ids), "launches": launches,
                           "equal": equal}
        log(f"  (c) get_rays on cuda, Center mode, every other pixel: "
            f"{len(local)} local ids -> {len(ids)} rays, K1 launches "
            f"{launches}; uint8 colours equal to sampler.sample on the "
            f"same ids: {equal}; samples.to('cpu').pin_memory().to('cuda') "
            f"round trip equal")
        if not equal or launches <= 0:
            raise AssertionError("get_rays on the card")
        seconds["c_get_rays"] = time.perf_counter() - start

        start = time.perf_counter()
        target = os.path.join(cache, "no-such-asset")
        got = download_asset("no-such-asset", target)
        left = sorted(name for name in os.listdir(cache)
                      if name.startswith("no-such-asset"))
        row["unknown_asset"] = {"returned": got, "files": left}
        log(f"  (d) download_asset('no-such-asset'): {got}, files left "
            f"{left}")
        if got is not False or left:
            raise AssertionError("download_asset of an unknown name")
        seconds["d_unknown"] = time.perf_counter() - start
    row["phase_s"] = seconds
    log("asset phases: " + ", ".join(f"{k} {v:.3f} s"
                                     for k, v in seconds.items())
        + f" ({CARD})")
    return row


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
    parser.add_argument("--sass", metavar="DIR",
                        help="only compare the SASS instruction counts of "
                             "K1's, P2's and K2's kernels in DIR and here")
    parser.add_argument("--train-turns", action="store_true",
                        help="only time train_nerf at --steps-per-call 8 "
                             "against 1, fused and plain, bf16 and f32, in "
                             "turns (one JSON line)")
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
    if args.sass:
        return run_sass(os.path.abspath(args.sass))
    if args.k2_limits or args.times_only:
        sys.path.insert(0, os.path.abspath(args.tree))
    if args.k2_limits:
        return run_k2_limits(args.k2_limits)
    if args.train_turns:
        return run_train_turns()
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
    focus = phase_focus_orbit()
    octree = phase_octree_orbit(model)
    phase_fused_vs_plain(model)
    log("K2 vs plain twin, flagship:")
    backward = phase_backward_vs_twin(model)
    log("K2 bf16's limit against a moved rounding point:")
    backward["bfloat16"]["control"] = phase_backward_control()
    log("K2 bf16 alone by pass, at the flagship's and the student's width:")
    backward["bfloat16"]["passes"] = phase_k2_passes(model)
    del model
    torch.cuda.empty_cache()
    step_ms, train_launches, checkpoint = phase_train()
    log("train ms/step over steps 2.." + str(TRAIN_STEPS + 1) + ": "
        + ", ".join(f"{k} {v:.3f}" for k, v in step_ms.items()))
    phase_render_trained(checkpoint)
    voxelize = phase_voxelize(checkpoint)
    new_phases = {}

    def timed(name, fn, *args):
        start = time.perf_counter()
        result = fn(*args)
        new_phases[name] = time.perf_counter() - start
        log(f"phase {name}: {new_phases[name]:.3f} s")
        return result

    chunks = timed("train_chunks", phase_train_chunks)
    resume = timed("train_resume", phase_train_resume)
    occupancy = timed("train_occupancy", phase_train_occupancy)
    quality = {
        "random": timed("quality_orbit_random", phase_quality_orbit,
                        os.path.join(OUT_DIR, "flagship_seed0.npz"),
                        "random flagship"),
        "trained": timed("quality_orbit_trained", phase_quality_orbit,
                         checkpoint, "30-step trained checkpoint")}
    model = flagship_nerf(torch.Generator().manual_seed(SEED)).cuda()
    face = timed("face_probe", phase_face_probe, model)
    pose = timed("pose", phase_pose, model)
    chunked = timed("chunked", phase_chunked)
    distilled = timed("distill", phase_distill, checkpoint)
    served = timed("serve", phase_serve, distilled["student"])
    log("the FFN family, the voxel fields and the regression CLIs (no "
        "kernel on these paths):")
    ffn = timed("ffn_paths", phase_ffn_paths)
    log("queue 1, item 7: --make-video, the comparison strip, a voxel "
        "teacher, mesh export, the sweep, the inspector, the sampler "
        "switches, debug NaNs:")
    item7 = timed("item7_paths", phase_item7_paths, model, checkpoint)
    torch.cuda.empty_cache()
    log("queue 1, item 7, sub-items 8-12: orbit_video --mp4, near_orbit, "
        "the regressions' --make-video, JPEG input, the view-angle "
        "animation, to_scenepic, a one-rank NCCL mesh:")
    finish = timed("finish_paths", phase_finish_paths, checkpoint)
    torch.cuda.empty_cache()
    log("the data cache: a model and a dataset by name, get_rays, an "
        "unknown asset (no network):")
    assets = timed("assets", phase_assets, model)
    torch.cuda.empty_cache()
    log("K3 vs plain twin, flagship:")
    render_checks = phase_ray_render_vs_twin(model)
    render = phase_ray_render_timing(model)
    del model
    torch.cuda.empty_cache()
    scan = phase_scan()
    validate_launches = phase_validate()
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    log("P1, the int8 probe's kernels, vs plain twins:")
    probe = phase_int8_probe()
    log("P2, K1's kernels in each ablation mode, vs plain twin and K1, "
        "flagship:")
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
        bf16_host_us=times["layer_stack_bf16"]["host_us"],
        bf16_kernel_ms=times["layer_stack_bf16"]["kernel_ms"])
    log(f"  P1c layer_stack at {P1C_SHAPES[0]}: int8 device "
        f"{times['layer_stack']['device_ms'] * 1e3:.2f} us, host "
        f"{times['layer_stack']['host_us']:.2f} us, twin "
        f"{stack['plain_ms'] * 1e3:.1f} us; bf16 device "
        f"{times['layer_stack_bf16']['device_ms'] * 1e3:.2f} us, host "
        f"{times['layer_stack_bf16']['host_us']:.2f} us, twin "
        f"{stack['bf16_plain_ms'] * 1e3:.1f} us; {stack['ctas']} blocks "
        f"(clusters of {stack['cluster']})")
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
        "slab_image_bytes": bf16["slab_image_bytes"],
        "f32_bound_ms": bounds["fused_nerf"]["f32"]["bound_ms"],
        "f32_tf32x3_bound_ms": bounds["fused_nerf"]["tf32x3"]["bound_ms"],
        **{f"f32_tf32x3_n{num}_bound_ms":
           bounds["fused_nerf"][f"tf32x3_n{num}"]["bound_ms"]
           for num in (CHUNK_POINTS, TRAIN_POINTS)},
        "f32_max_abs_err": f32["max_abs_err"],
        "f32_mean_abs_err": f32["mean_abs_err"],
        "f32_single_tf32_min_max_mean_abs_err": f32["single_tf32_min"],
        "f32_slab_image_ms": f32["slab_image_ms"],
        "f32_slab_image_bytes": f32["slab_image_bytes"],
        "f32_ms": f32["times"][BENCH_POINTS][0],
        "f32_plain_ms": f32["times"][BENCH_POINTS][1],
        **{f"f32_n{num}_{key}": f32["times"][num][i]
           for num in K1_TIMED_POINTS
           for i, key in enumerate(("ms", "plain_ms"))},
        "frame_profile": frame,
        "train_launches": train_launches["fused_nerf"],
        "launches_by_path": {
            "orbit_preset_fast": launches,
            "orbit_focus": focus["launches"],
            "orbit_octree_occupancy": octree["occupancy"]["launches"],
            "orbit_octree_traversal": octree["traversal"]["launches"],
            "voxelize_model": voxelize["launches"],
            "orbit_voxelized_octree": voxelize["octree_frame_launches"],
            "train_nerf": train_launches["fused_nerf"],
            **_chunk_launches(chunks, resume, occupancy, "fused_nerf"),
            "orbit_preset_quality": {
                name: {"total": row["launches"], **row["pass_launches"]}
                for name, row in quality.items()},
            "orbit_pose": pose["launches"],
            "orbit_pose_focus": pose["focus_launches"],
            "orbit_chunked": chunked["launches"],
            "serve_student": served["stream_launches"],
            "distill": {name: {"in_graph_replays":
                               row["in_graph_replays"]["fused_nerf"],
                               "eager": row["eager"]["fused_nerf"]}
                        for name, row in distilled["launches"].items()},
            **_ffn_launches(ffn, "fused_nerf"),
            **_item7_launches(item7, "fused_nerf"),
            **_finish_launches(finish, "fused_nerf"),
            "orbit_cached_model": assets["orbit_cached"]["launches"],
            "train_nerf_cached_dataset":
                assets["train_cached"]["fused_nerf"],
            "get_rays": assets["get_rays"]["launches"]},
        "student_6x192": distilled["kernels"]["fused_nerf"],
        "assets": assets,
        "ffn_voxel_regression": ffn,
        "item7_paths": item7,
        "finish_paths": finish,
        "face_probe": face,
        "pose": pose,
        "chunked": chunked,
        "serve": served,
        "quality_orbit": quality,
        "focus_orbit": focus,
        "octree_orbit": octree,
        "voxelize": voxelize,
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
        "f32_tf32x3_bound_ms":
            bounds["fused_nerf_train"]["tf32x3"]["bound_ms"],
        "f32_single_tf32_control":
            backward["float32"]["single_tf32_control"],
        "f32_max_abs_err": backward["float32"]["max_abs_err"],
        "f32_ms": backward["float32"]["ms"],
        "f32_plain_ms": backward["float32"]["plain_ms"],
        "max_rel_err_by_cotangent": backward["bfloat16"]["max_rel_err"],
        "f32_max_rel_err_by_cotangent": backward["float32"]["max_rel_err"],
        "bitwise_equal": backward["bfloat16"]["bitwise_equal"],
        "passes": backward["bfloat16"]["passes"],
        "moved_rounding_control": {
            "margin_3x256": backward["bfloat16"]["control"],
            "flagship": backward["bfloat16"]["flagship_control"]},
        "train_ms_per_step": step_ms,
        "launches_by_path": {
            "train_nerf": train_launches["fused_nerf_train"],
            **_chunk_launches(chunks, resume, occupancy,
                              "fused_nerf_train"),
            "distill": {name: {"in_graph_replays":
                               row["in_graph_replays"]["fused_nerf_train"],
                               "eager": row["eager"]["fused_nerf_train"]}
                        for name, row in distilled["launches"].items()},
            **_ffn_launches(ffn, "fused_nerf_train"),
            **_item7_launches(item7, "fused_nerf_train"),
            **_finish_launches(finish, "fused_nerf_train"),
            "train_nerf_cached_dataset":
                assets["train_cached"]["fused_nerf_train"]},
        "student_6x192": distilled["kernels"]["fused_nerf_train"],
        "distill": {k: v for k, v in distilled.items() if k != "kernels"},
        "train_chunks": chunks,
        "train_resume": resume,
        "train_occupancy": occupancy,
        "new_phase_s": new_phases,
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
        "shape": f"R={RENDER_RAYS} S=128 (ms) and S=48 (s48_*); f32 (f32_*); "
                 f"the validate CLI's R=64 (validate_ms_s<S>)",
        "mean_abs_err": render[("bfloat16", 128)]["mean_abs_err"],
        "checks": render_checks,
        "f32_bound_ms": bounds["fused_ray_render"]["f32"]["bound_ms"],
        "f32_tf32x3_bound_ms":
            bounds["fused_ray_render"]["tf32x3"]["bound_ms"],
        "s48_bound_ms": bounds["fused_ray_render"]["bf16_s48"]["bound_ms"],
        "s48_f32_tf32x3_bound_ms":
            bounds["fused_ray_render"]["tf32x3_s48"]["bound_ms"],
        "k1_composite_ms": render[("bfloat16", 128)]["k1_composite_ms"],
        "f32_max_abs_err": render[("float32", 128)]["max_abs_err"],
        "f32_mean_abs_err": render[("float32", 128)]["mean_abs_err"],
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
        **{f"{prefix}validate_ms_s{samples}":
           render[(name, "validate", samples)]
           for name, prefix in (("bfloat16", ""), ("float32", "f32_"))
           for samples in (42, 48, 128)},
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
         {**ablation["bf16"]["modes"]["base"], "library_ms": None,
          "max_abs_err": max(m["max_abs_err"] for r in ablation.values()
                             for m in r["modes"].values()),
          "shape": f"N={ABLATION_POINTS}, bf16; ms is base, every mode and "
                   f"f32 below, each beside K1 (k1_ms)",
          "k1_ms": ablation["bf16"]["k1_ms"], "modes": ablation}),
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
