"""CLI: bakes a trained NeRF into a smaller serving student.

Port of ``fourier_feature_nets_tpu/cli/distill_model.py`` with its flags,
plus ``--device`` (default ``cuda``): point-space distillation
(:func:`..render.distill.distill`) along the rays of a hemisphere rig
(or of ``--data``'s train cameras), placed by the teacher's own density
grid (``OccupancyGridSampler.from_model`` over the half extent of the
bounds) or uniformly (``--uniform``). The student (default
``RECOMMENDED_STUDENT``, 6x192) is seeded with ``--seed``. ``--data``
takes a local NPZ or ``synthetic[:res]`` and reports the student's (and
with ``--eval-teacher`` the teacher's) val PSNR at 128 uniform samples.
Writes ``student.npz`` and ``distill_log.txt``; ``--checkpoint-interval``
and ``--resume`` keep and resume train-state checkpoints in
``<results_dir>/checkpoints``. A teacher of another model type raises
``NotImplementedError`` naming its ROADMAP.md item.

    python -m fourier_feature_nets_torch.cli.distill_model teacher.npz out/ \\
        --num-steps 20000
    python -m fourier_feature_nets_torch.cli.serve out/student.npz 800 \\
        --preset fast
"""

import os
import time
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser

import numpy as np
import torch

from ..cameras import Resolution
from ..models import NeRF, load_model, save_model
from ..ops import psnr_from_mse
from ..render import OccupancyGridSampler, Raycaster, RaySampler
from ..render.distill import distill
from ..utils import ETABar, hemisphere
from ..utils.errors import not_ported
from .common import RECOMMENDED_STUDENT, resolve_data_path
from .orbit_video import VECTORS


def build_parser() -> ArgumentParser:
    parser = ArgumentParser("Model Distillation (baking for serving)",
                            formatter_class=ArgumentDefaultsHelpFormatter)
    parser.add_argument("teacher_path", help="Trained teacher checkpoint "
                        "(.npz)")
    parser.add_argument("results_dir")
    parser.add_argument("--device", default="cuda",
                        help="Torch device to distill on")
    parser.add_argument("--student-layers", type=int,
                        default=RECOMMENDED_STUDENT[0],
                        help="Student depth (default: the recommended "
                        "serving shape)")
    parser.add_argument("--student-channels", type=int,
                        default=RECOMMENDED_STUDENT[1])
    parser.add_argument("--student-freq-pos", type=int, default=10)
    parser.add_argument("--student-freq-view", type=int, default=4)
    parser.add_argument("--num-steps", type=int, default=20000)
    parser.add_argument("--batch-rays", type=int, default=1024)
    parser.add_argument("--num-samples", type=int, default=128,
                        help="Supervision samples per ray")
    parser.add_argument("--learning-rate", type=float, default=5e-4)
    parser.add_argument("--decay-rate", type=float, default=1.0,
                        help="Exponential LR decay factor (applied over "
                        "--decay-steps); 1.0 disables")
    parser.add_argument("--decay-steps", type=int, default=0)
    parser.add_argument("--seed", type=int, default=20080524)
    parser.add_argument("--steps-per-call", type=int, default=100,
                        help="Steps a call; on CUDA one CUDA-graph replay")
    parser.add_argument("--report-interval", type=int, default=1000)
    parser.add_argument("--num-cameras", type=int, default=64,
                        help="Hemisphere supervision rig size")
    parser.add_argument("--resolution", type=int, default=400,
                        help="Supervision rig image resolution")
    parser.add_argument("--distance", type=float, default=4.0)
    parser.add_argument("--fov-y-degrees", type=float, default=40.0)
    parser.add_argument("--up-dir", default="y+", choices=sorted(VECTORS))
    parser.add_argument("--forward-dir", default="z-",
                        choices=sorted(VECTORS))
    parser.add_argument("--scale", type=float, default=2.0,
                        help="Render-volume bounds diagonal; the cube "
                        "half extent is scale/2 (overridden by --data "
                        "bounds)")
    parser.add_argument("--uniform", action="store_true",
                        help="Uniform sample placement instead of the "
                        "teacher's density-grid occupancy CDF")
    parser.add_argument("--occupancy-resolution", type=int, default=64)
    parser.add_argument("--density-threshold", type=float, default=1e-3)
    parser.add_argument("--data",
                        help="Optional dataset NPZ or 'synthetic[:res]': "
                        "supervise with its train cameras and report "
                        "student/teacher val PSNR (128 uniform samples)")
    parser.add_argument("--eval-teacher", action="store_true",
                        help="Also evaluate the teacher on the val cameras")
    parser.add_argument("--fused", action="store_true", default=None,
                        help="Force the kernels (teacher K1; student K1 "
                        "and K2); default: on for a NeRF on CUDA")
    parser.add_argument("--no-fused", dest="fused", action="store_false")
    parser.add_argument("--checkpoint-interval", type=int, default=0,
                        help="Steps between resumable train-state "
                        "checkpoints (in the background, to "
                        "<results_dir>/checkpoints); 0 disables")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from the newest checkpoint in "
                        "<results_dir>/checkpoints")
    return parser


def _val_psnr(model, cameras, bounds, gt_rgb, device, num_samples=128,
              fused=None) -> float:
    """Mean val PSNR of whole uniform frames (bf16, no culling), on the
    forward path ``fused`` selects."""
    caster = Raycaster(model, compute_dtype=torch.bfloat16, fused=fused)
    sampler = RaySampler(bounds, cameras, num_samples, device)
    scores = []
    for cam in range(len(cameras)):
        image = caster.render_frame(sampler, cam, cull_empty=False)
        mse = np.mean(np.square(image.astype(np.float32) / 255.0
                                - gt_rgb[cam].astype(np.float32) / 255.0))
        scores.append(float(psnr_from_mse(max(mse, 1e-10))))
    return float(np.mean(scores))


def _supervision(args, device):
    """(cameras, bounds, val cameras, val ground truth) of ``--data``, or
    a hemisphere rig with no val set."""
    if not args.data:
        cameras = hemisphere(
            VECTORS[args.up_dir], VECTORS[args.forward_dir],
            args.num_cameras, args.fov_y_degrees,
            Resolution(args.resolution, args.resolution), args.distance,
            rng=np.random.default_rng(args.seed))
        bounds = np.diag([args.scale] * 3 + [1.0]).astype(np.float32)
        return cameras, bounds, None, None
    from ..datasets import ImageDataset
    path = resolve_data_path(args.data, device)
    train = ImageDataset.load(path, "train", args.num_samples, device=device)
    val = ImageDataset.load(path, "val", args.num_samples, device=device)
    with np.load(path) as data:
        train_count, val_count = (int(n) for n in data["split_counts"][:2])
        gt = data["images"][train_count:train_count + val_count]
    if gt.shape[-1] == 4:
        gt = (gt[..., :3].astype(np.float32)
              * (gt[..., 3:4].astype(np.float32) / 255.0)).astype(np.uint8)
    else:
        gt = gt[..., :3]
    return (train.cameras, np.asarray(train.sampler.bounds, np.float32),
            val.cameras, gt)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.decay_rate != 1.0 and args.decay_steps <= 0:
        parser.error("--decay-rate has no effect without --decay-steps > 0 "
                     "(the schedule is lr * decay_rate ** (step / "
                     "decay_steps)); e.g. --decay-steps equal to "
                     "--num-steps")
    device = torch.device(args.device)
    os.makedirs(args.results_dir, exist_ok=True)
    teacher = load_model(args.teacher_path).to(device).requires_grad_(False)
    if teacher.model_type != "nerf":
        raise not_ported(f"distillation from a {teacher.model_type} "
                         "teacher", "Remaining models, data, CLIs and "
                         "parallel")

    cameras, bounds, val_cameras, gt_rgb = _supervision(args, device)
    if args.uniform:
        sampler = RaySampler(bounds, cameras, args.num_samples, device,
                             stratified=True)
    else:
        # the half extent: the cube spans bounds @ [+-0.5, ..., 1]
        sampler = OccupancyGridSampler.from_model(
            teacher, cameras, args.num_samples, stratified=True,
            grid_resolution=args.occupancy_resolution,
            alpha_threshold=args.density_threshold,
            scale=float(bounds[0, 0]) / 2.0, bounds=bounds)

    student = NeRF(num_layers=args.student_layers,
                   num_channels=args.student_channels,
                   max_log_scale_pos=9.0, num_freq_pos=args.student_freq_pos,
                   max_log_scale_view=3.0,
                   num_freq_view=args.student_freq_view,
                   skips=[args.student_layers // 2], include_inputs=True,
                   generator=torch.Generator().manual_seed(args.seed))
    student = student.to(device)

    bar = ETABar("Distilling", max=args.num_steps)
    log = []
    last_step = [0]

    def reporter(step, loss):
        bar.next(step - last_step[0])
        last_step[0] = step
        bar.info(f"loss {loss:.3e}")
        log.append((step, loss))

    call_ms = []
    start = time.perf_counter()
    _, losses = distill(
        teacher, student, sampler, num_steps=args.num_steps,
        batch_rays=args.batch_rays, learning_rate=args.learning_rate,
        decay_rate=args.decay_rate, decay_steps=args.decay_steps,
        seed=args.seed, steps_per_call=args.steps_per_call,
        fused_teacher=args.fused, fused_student=args.fused,
        report_interval=args.report_interval, reporter=reporter,
        checkpoint_dir=(os.path.join(args.results_dir, "checkpoints")
                        if args.checkpoint_interval or args.resume
                        else None),
        checkpoint_interval=args.checkpoint_interval or None,
        resume=args.resume, call_ms=call_ms)
    wall = time.perf_counter() - start
    bar.finish()

    out_path = os.path.join(args.results_dir, "student.npz")
    save_model(student, out_path)
    with open(os.path.join(args.results_dir, "distill_log.txt"),
              "w") as stream:
        stream.write("step\tloss\n")
        for step, loss in log:
            stream.write(f"{step}\t{loss:.6e}\n")
    final = (f"final loss {losses[-1]:.3e}" if len(losses)
             else "no steps left to run (the checkpoint is complete)")
    later = call_ms[1:]
    steady = (f"{sum(ms for ms, _ in later) / sum(n for _, n in later):.3f} "
              f"ms/step over calls 2..{len(call_ms)}" if later
              else "no later calls")
    print(f"student ({args.student_layers}x{args.student_channels}) -> "
          f"{out_path}  {final}; {len(losses)} steps in {wall:.3f} s, "
          f"{steady}")

    if gt_rgb is not None:
        psnr_s = _val_psnr(student, val_cameras, bounds, gt_rgb, device,
                           fused=args.fused)
        print(f"student val PSNR: {psnr_s:.2f} dB (128-sample uniform "
              "protocol)")
        if args.eval_teacher:
            psnr_t = _val_psnr(teacher, val_cameras, bounds, gt_rgb, device,
                               fused=args.fused)
            print(f"teacher val PSNR: {psnr_t:.2f} dB (distillation cost "
                  f"{psnr_t - psnr_s:+.2f} dB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
