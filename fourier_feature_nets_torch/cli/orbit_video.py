"""CLI: renders an orbit of frames of a trained model.

Port of ``fourier_feature_nets_tpu/cli/orbit_video.py``: the model is a
checkpoint of any of the four types (a NeRF, an FFN, dense or
factorized voxels; NPZ or ``.pt``), rendered with all of the JAX CLI's
samplers: focus sampling with the model as its own opacity model
(the default), with another checkpoint (``--opacity-model``), the
density grid (``--density-grid``, ``--preset fast``), an octree
(``--octree`` with ``--octree-mode occupancy|traversal``) and plain
uniform samples (``--no-focus``). ``--early-term`` (with
``--early-split``) terminates the rays of a culled frame early, as
``--preset quality`` does. Frames are written as PNGs by a standard
library encoder. ``--chunked`` renders each frame the chunked way
(``Raycaster.render_image``, the parity path). ``--mp4`` also writes the
frames, read back from their PNGs, into an MP4 as Motion-JPEG
(:mod:`..utils.video`; the JAX CLI's frames are MPEG-4 Part 2).
``--data-parallel`` renders each frame over the ranks ``torchrun``
started: each renders its slab of every chunk (K1 where fused) and rank
0 writes the files.

    python -m fourier_feature_nets_torch.cli.orbit_video model.npz 800 out/ \\
        --preset fast --num-frames 10
"""

import os
import sys
import time
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser

import numpy as np
import torch

from ..cameras import Resolution
from ..models import load_model
from ..octree import OcTree
from ..render import (
    OccupancyGridSampler,
    OctreeRaySampler,
    Raycaster,
    RaySampler,
)
from ..utils import ETABar, orbit, write_png
from ..utils.png import read_png
from ..utils.video import VideoWriter
from .common import (
    add_preset_arg,
    apply_render_preset,
    data_parallel_mesh,
    load_opacity,
)

VECTORS = {
    "x+": np.array([1, 0, 0], np.float32),
    "x-": np.array([-1, 0, 0], np.float32),
    "y+": np.array([0, 1, 0], np.float32),
    "y-": np.array([0, -1, 0], np.float32),
    "z+": np.array([0, 0, 1], np.float32),
    "z-": np.array([0, 0, -1], np.float32),
}


def _parse_args(argv=None):
    parser = ArgumentParser("Orbit Video Maker",
                            formatter_class=ArgumentDefaultsHelpFormatter)
    parser.add_argument("model_path", help="Path to the trained model")
    parser.add_argument("resolution", type=int)
    parser.add_argument("output_dir")
    parser.add_argument("--device", default="cuda",
                        help="Torch device to render on")
    parser.add_argument("--opacity-model")
    parser.add_argument("--distance", type=float, default=4)
    parser.add_argument("--fov-y-degrees", type=float, default=40)
    parser.add_argument("--num-frames", type=int, default=200)
    parser.add_argument("--up-dir", default="y+", choices=sorted(VECTORS))
    parser.add_argument("--forward-dir", default="z-",
                        choices=sorted(VECTORS))
    parser.add_argument("--num-samples", type=int, default=128)
    parser.add_argument("--batch-size", type=int, default=4096)
    parser.add_argument("--no-focus", action="store_true",
                        help="Disable opacity-guided focus sampling")
    parser.add_argument("--octree", help="Path to an octree NPZ")
    parser.add_argument("--octree-mode", default="occupancy",
                        choices=["occupancy", "traversal"])
    parser.add_argument("--compute-dtype",
                        choices=["float32", "bfloat16"],
                        default="float32")
    parser.add_argument("--chunked", action="store_true",
                        help="Per-chunk render path (render_image)")
    parser.add_argument("--data-parallel", action="store_true",
                        help="Shard each frame's rays across devices")
    parser.add_argument("--density-grid", action="store_true",
                        help="Occupancy-guided sampling from the "
                        "model's own density field")
    parser.add_argument("--density-threshold", type=float,
                        default=1e-3,
                        help="Per-cell alpha threshold for "
                        "--density-grid")
    parser.add_argument("--early-term", type=float, default=0.0,
                        help="Early-ray-termination transmittance "
                        "threshold (0 = off)")
    parser.add_argument("--early-split", type=int, default=0)
    parser.add_argument("--mp4", help="Also assemble the frames into "
                        "this MP4 file")
    parser.add_argument("--framerate", type=float, default=20)
    add_preset_arg(parser)
    return apply_render_preset(parser.parse_args(argv), parser, argv)


def _frame_mesh(args):
    """The ``--data-parallel`` mesh, or None: ``--chunked`` ignores
    ``--data-parallel`` and ``--early-term``, with the JAX CLI's
    warning."""
    if args.chunked:
        if args.data_parallel or args.early_term:
            print("WARNING: --chunked is the single-device parity path; "
                  "--data-parallel/--early-term are ignored",
                  file=sys.stderr)
        return None
    if args.data_parallel:
        return data_parallel_mesh(args.device)
    return None


def build_render_sampler(args, model, cameras, bounds):
    """The render-time sampler from the CLI flags, on the model's
    device: the density grid (``--density-grid``), an octree
    (``--octree``, rasterized to an occupancy grid or traversed),
    focus sampling with ``--opacity-model`` or, by default, with the
    model itself, or uniform samples (``--no-focus``)."""
    device = next(model.parameters()).device
    if args.density_grid:
        return OccupancyGridSampler.from_model(
            model, cameras, args.num_samples,
            alpha_threshold=args.density_threshold, bounds=bounds)
    if args.octree:
        tree = OcTree.load(args.octree)
        if args.octree_mode == "occupancy":
            return OccupancyGridSampler.from_tree(
                tree, cameras, args.num_samples, bounds=bounds,
                device=device)
        return OctreeRaySampler(tree, cameras, args.num_samples,
                                bounds=bounds, device=device)
    if args.opacity_model:
        opacity_model = load_opacity(args.opacity_model, device)
    elif not args.no_focus:
        opacity_model = model
    else:
        opacity_model = None
    return RaySampler(bounds, cameras, args.num_samples, device,
                      opacity_model=opacity_model,
                      batch_size=args.batch_size)


def main(argv=None):
    args = _parse_args(argv)
    mesh = _frame_mesh(args)
    primary = mesh is None or mesh.is_primary
    device = torch.device(args.device) if mesh is None else mesh.device
    orbit_cameras = orbit(VECTORS[args.up_dir], VECTORS[args.forward_dir],
                          args.num_frames, args.fov_y_degrees,
                          Resolution(args.resolution, args.resolution),
                          args.distance)
    bounds = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)

    model = load_model(args.model_path).to(device)
    compute_dtype = (torch.bfloat16 if args.compute_dtype == "bfloat16"
                     else None)
    # fused=None (Raycaster's resolve_fused): the Hopper kernel for a NeRF
    # on a CUDA device in bf16 (--preset fast), the plain PyTorch path in
    # f32 and on the CPU
    raycaster = Raycaster(model, compute_dtype=compute_dtype)
    start = time.perf_counter()
    sampler = build_render_sampler(args, model, orbit_cameras, bounds)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # the sampler's set-up: a focus sampler's opacity sweep over every
    # ray of the orbit, or a grid's rasterization
    setup_s = time.perf_counter() - start

    if primary:
        os.makedirs(args.output_dir, exist_ok=True)
    progress = ETABar("Rendering", max=args.num_frames)
    frame_ms, hit, survived = [], 0, 0
    for frame in range(args.num_frames):
        progress.next()
        # render_frame returns a host array, so the time includes the
        # device work and the copy (the culled path syncs once per
        # frame on the hit count, so frames are not pipelined)
        start = time.perf_counter()
        if args.chunked:
            image = raycaster.render_image(sampler, frame, args.batch_size)
        else:
            image = raycaster.render_frame(sampler, frame,
                                           chunk_size=args.batch_size * 4,
                                           early_term=args.early_term,
                                           early_split=args.early_split,
                                           mesh=mesh)
            hit += raycaster.frame_rays["hit"]
            survived += raycaster.frame_rays.get("survived", 0)
        frame_ms.append((time.perf_counter() - start) * 1e3)
        if primary:
            write_png(os.path.join(args.output_dir,
                                   "frame_{:05d}.png".format(frame)), image)
    progress.finish()
    if not primary:
        return 0

    if args.mp4:
        # as the JAX CLI: the frames are read back from their PNGs
        start = time.perf_counter()
        with VideoWriter(args.mp4, args.framerate,
                         (args.resolution, args.resolution)) as writer:
            for frame in range(args.num_frames):
                writer.write(read_png(os.path.join(
                    args.output_dir, "frame_{:05d}.png".format(frame))))
        print(f"wrote {args.mp4}: {args.num_frames} frames, "
              f"{(time.perf_counter() - start) * 1e3 / args.num_frames:.3f}"
              " ms/frame to read and encode")

    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else str(device))
    steady = (f"{np.mean(frame_ms[1:]):.3f} ms/frame over frames 2.."
              f"{len(frame_ms)}" if len(frame_ms) > 1 else "no later frames")
    early = ""
    if "survived" in getattr(raycaster, "frame_rays", {}):
        early = (f", early termination at {args.early_term:g}: "
                 f"{survived} of {hit} hit rays survived pass 1")
    print(f"orbit_video: {args.num_frames} frames of {args.resolution}x"
          f"{args.resolution} on {where}, {args.num_samples} samples, "
          f"{args.compute_dtype}: sampler set-up {setup_s:.3f} s, first "
          f"frame {frame_ms[0]:.3f} ms, {steady}{early}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
