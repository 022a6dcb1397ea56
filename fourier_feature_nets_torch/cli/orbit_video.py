"""CLI: renders an orbit of frames of a trained NeRF.

Port of ``fourier_feature_nets_tpu/cli/orbit_video.py`` for the
density-grid (``--density-grid``, ``--preset fast``) and plain uniform
(``--no-focus``) samplers. Frames are written as PNGs by a standard
library encoder. Every other path of the JAX CLI raises
``NotImplementedError`` naming the ROADMAP.md item that ports it.

    python -m fourier_feature_nets_torch.cli.orbit_video model.npz 800 out/ \\
        --preset fast --num-frames 10
"""

import os
import time
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser

import numpy as np
import torch

from ..cameras import Resolution
from ..models import load_model
from ..render import OccupancyGridSampler, Raycaster, RaySampler
from ..utils import ETABar, orbit, write_png
from ..utils.errors import not_ported
from .common import add_preset_arg, apply_render_preset

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


def _reject_unported(args):
    """Raises for every flag whose path the port does not have yet
    (the sampler flags are checked by :func:`build_render_sampler`)."""
    if args.early_term > 0.0:
        raise not_ported("--early-term", "Early termination")
    if args.chunked:
        raise not_ported("--chunked (render_image)",
                          "Pose rendering and serving")
    if args.data_parallel:
        raise not_ported("--data-parallel", "Remaining models, data, "
                          "CLIs and parallel")
    if args.mp4:
        raise not_ported("--mp4", "Remaining models, data, CLIs and "
                          "parallel")


def build_render_sampler(args, model, cameras, bounds):
    """The render-time sampler from the CLI flags, on the model's
    device: the density grid (``--density-grid``) or uniform samples
    (``--no-focus``)."""
    if args.density_grid:
        return OccupancyGridSampler.from_model(
            model, cameras, args.num_samples,
            alpha_threshold=args.density_threshold, bounds=bounds)
    if args.octree:
        raise not_ported("--octree", "Octree")
    if args.opacity_model:
        raise not_ported("--opacity-model (focus sampling)",
                          "Focus sampling")
    if not args.no_focus:
        raise not_ported("Focus sampling (the default without "
                          "--no-focus or --density-grid)", "Focus sampling")
    device = next(model.parameters()).device
    return RaySampler(bounds, cameras, args.num_samples, device)


def main(argv=None):
    args = _parse_args(argv)
    _reject_unported(args)
    device = torch.device(args.device)
    orbit_cameras = orbit(VECTORS[args.up_dir], VECTORS[args.forward_dir],
                          args.num_frames, args.fov_y_degrees,
                          Resolution(args.resolution, args.resolution),
                          args.distance)
    bounds = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)

    model = load_model(args.model_path).to(device)
    compute_dtype = (torch.bfloat16 if args.compute_dtype == "bfloat16"
                     else None)
    # fused=None: the Hopper kernel for a NeRF on a CUDA device, the
    # plain PyTorch path on the CPU
    raycaster = Raycaster(model, compute_dtype=compute_dtype)
    sampler = build_render_sampler(args, model, orbit_cameras, bounds)

    os.makedirs(args.output_dir, exist_ok=True)
    progress = ETABar("Rendering", max=args.num_frames)
    frame_ms = []
    for frame in range(args.num_frames):
        progress.next()
        # render_frame returns a host array, so the time includes the
        # device work and the copy (the culled path syncs once per
        # frame on the hit count, so frames are not pipelined)
        start = time.perf_counter()
        image = raycaster.render_frame(sampler, frame,
                                       chunk_size=args.batch_size * 4)
        frame_ms.append((time.perf_counter() - start) * 1e3)
        write_png(os.path.join(args.output_dir,
                               "frame_{:05d}.png".format(frame)), image)
    progress.finish()

    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else str(device))
    steady = (f"{np.mean(frame_ms[1:]):.3f} ms/frame over frames 2.."
              f"{len(frame_ms)}" if len(frame_ms) > 1 else "no later frames")
    print(f"orbit_video: {args.num_frames} frames of {args.resolution}x"
          f"{args.resolution} on {where}, {args.num_samples} samples, "
          f"{args.compute_dtype}: first frame {frame_ms[0]:.3f} ms, "
          f"{steady}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
