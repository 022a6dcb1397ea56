"""CLI: a persistent render server for a trained NeRF.

Port of ``fourier_feature_nets_tpu/cli/serve.py`` with its flags: the
model and an orbit rig's sampler stay on the device, and
:mod:`..render.server` serves frames over HTTP (``/``, ``/info``,
``/frame``, ``/pose``, ``/stream.mjpeg``, ``/stats``). The sampler
comes from the orbit CLI's flags and presets (``build_render_sampler``);
the kernels follow ``Raycaster``'s default (``resolve_fused``: K1 in
bf16 on CUDA). ``--data-parallel`` renders every frame over the ranks
``torchrun`` started: rank 0 serves HTTP and broadcasts each frame
request, the others follow (``render/server.py::follow``) until it
stops. ``--port 0`` takes a free port, which the serving line names.

    python -m fourier_feature_nets_torch.cli.serve student.npz 800 \\
        --preset fast --port 8765
"""

import signal
import sys
import threading
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser

import numpy as np
import torch

from ..cameras import Resolution
from ..models import load_model
from ..render import Raycaster
from ..render.server import RenderServer, follow, serve
from ..utils import orbit
from .common import add_preset_arg, apply_render_preset, data_parallel_mesh
from .orbit_video import VECTORS, build_render_sampler


def _parse_args(argv=None):
    parser = ArgumentParser("Render server",
                            formatter_class=ArgumentDefaultsHelpFormatter)
    parser.add_argument("model_path", help="Path to the trained model")
    parser.add_argument("resolution", type=int)
    parser.add_argument("--device", default="cuda",
                        help="Torch device to render on")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8765)
    parser.add_argument("--opacity-model")
    parser.add_argument("--distance", type=float, default=4)
    parser.add_argument("--fov-y-degrees", type=float, default=40)
    parser.add_argument("--num-frames", type=int, default=200,
                        help="Cameras on the served orbit rig")
    parser.add_argument("--up-dir", default="y+", choices=sorted(VECTORS))
    parser.add_argument("--forward-dir", default="z-",
                        choices=sorted(VECTORS))
    parser.add_argument("--num-samples", type=int, default=128)
    parser.add_argument("--batch-size", type=int, default=4096)
    parser.add_argument("--chunk-size", type=int, default=16384)
    parser.add_argument("--no-focus", action="store_true")
    parser.add_argument("--octree")
    parser.add_argument("--octree-mode", default="occupancy",
                        choices=["occupancy", "traversal"])
    parser.add_argument("--density-grid", action="store_true",
                        help="Occupancy-guided sampling from the model's "
                        "own density field (culled frames)")
    parser.add_argument("--density-threshold", type=float, default=1e-3)
    parser.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                        default="bfloat16")
    parser.add_argument("--data-parallel", action="store_true",
                        help="Shard each frame's rays across the ranks "
                        "that torchrun started (one device each)")
    parser.add_argument("--early-term", type=float, default=0.0,
                        help="Early-ray-termination transmittance "
                        "threshold (0 = off; needs an occupancy sampler)")
    parser.add_argument("--early-split", type=int, default=0,
                        help="Samples before the termination test (0 = "
                        "half the budget)")
    add_preset_arg(parser)
    return apply_render_preset(parser.parse_args(argv), parser, argv)


def main(argv=None):
    args = _parse_args(argv)
    mesh = data_parallel_mesh(args.device) if args.data_parallel else None
    device = torch.device(args.device) if mesh is None else mesh.device
    cameras = orbit(VECTORS[args.up_dir], VECTORS[args.forward_dir],
                    args.num_frames, args.fov_y_degrees,
                    Resolution(args.resolution, args.resolution),
                    args.distance)
    bounds = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)

    model = load_model(args.model_path).to(device)
    compute_dtype = (torch.bfloat16 if args.compute_dtype == "bfloat16"
                     else None)
    # fused=None (resolve_fused): K1 for a NeRF on CUDA in bf16
    raycaster = Raycaster(model, compute_dtype=compute_dtype)
    sampler = build_render_sampler(args, model, cameras, bounds)
    options = dict(chunk_size=args.chunk_size, early_term=args.early_term,
                   early_split=args.early_split)
    if mesh is not None and not mesh.is_primary:
        frames = follow(raycaster, sampler, mesh, **options)
        print(f"rank {mesh.rank}: joined {frames} frames", flush=True)
        return 0
    server = RenderServer(raycaster, sampler, mesh=mesh, **options)
    print(f"warming up ({args.resolution}x{args.resolution}, "
          f"{args.num_samples} samples, "
          f"{'fused' if raycaster.fused else 'plain'})...", flush=True)
    warmup = server.warmup()
    http = serve(server, args.host, args.port)
    host, port = http.server_address[:2]
    print(f"warm-up {warmup:.3f} s; serving {args.num_frames} cameras on "
          f"http://{host}:{port}", flush=True)
    if threading.current_thread() is threading.main_thread():
        # SIGTERM stops the server as Ctrl-C does
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    try:
        http.serve_forever()
    except (KeyboardInterrupt, SystemExit):
        pass
    finally:
        http.shutdown()
        http.server_close()
        server.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
