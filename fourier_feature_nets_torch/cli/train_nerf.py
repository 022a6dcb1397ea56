"""CLI: trains a full NeRF model.

Port of ``fourier_feature_nets_tpu/cli/train_nerf.py``, same flags and
defaults plus ``--device`` (default ``cuda``). On a CUDA device with
``--compute-dtype bfloat16``, or with ``--fused``, each training step
runs the fused NeRF forward (K1) and recompute backward (K2) Hopper
kernels; at the f32 default, or with ``--no-fused``, it trains through
autograd of the plain model, which a fused f32 step (3xTF32 kernels)
did not beat in every run on an H100. ``--opacity-model`` focus-samples
the train and val rays with that checkpoint's density.
``--steps-per-call N`` runs N steps a call, on CUDA as one CUDA-graph
replay; ``--checkpoint-interval`` writes resumable train-state
checkpoints to ``<results_dir>/checkpoints`` and ``--resume`` continues
from the newest; ``--occupancy-*`` trains occupancy-guided.
``--make-video`` writes an orbit of ``--num-frames`` frames over the
run to ``<results_dir>/video`` (through K1 when the run is fused) in
place of the evaluation grids. ``--data-parallel`` trains over the
ranks ``torchrun`` started, each on its slab of every batch (K1/K2 on
each rank when fused), and only rank 0 writes files:

    torchrun --nproc-per-node 4 -m fourier_feature_nets_torch.cli.train_nerf \
        synthetic out/ --data-parallel --compute-dtype bfloat16

    python -m fourier_feature_nets_torch.cli.train_nerf synthetic out/ \\
        --num-steps 30 --report-interval 10 --steps-per-call 8
"""

import os
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser

import torch

from ..models import NeRF, save_model
from ..render import Raycaster
from . import common


def _parse_args(argv=None):
    parser = ArgumentParser("NeRF Training script",
                            formatter_class=ArgumentDefaultsHelpFormatter)
    parser.add_argument("data_path", help="Path to the data NPZ "
                        "(or 'synthetic[:res]')")
    parser.add_argument("results_dir", help="Path to output results")
    parser.add_argument("--opacity-model")
    parser.add_argument("--num-samples", type=int, default=128)
    parser.add_argument("--num-layers", type=int, default=8)
    parser.add_argument("--learning-rate", type=float, default=5e-4)
    parser.add_argument("--num-channels", type=int, default=256)
    parser.add_argument("--pos-freq", type=int, default=10)
    parser.add_argument("--pos-max-log-scale", type=float, default=9)
    parser.add_argument("--view-freq", type=int, default=4)
    parser.add_argument("--view-max-log-scale", type=float, default=3)
    parser.add_argument("--num-steps", type=int, default=50000)
    parser.add_argument("--crop-steps", type=int, default=1000)
    parser.add_argument("--omit-inputs", action="store_true")
    parser.add_argument("--decay-rate", type=float, default=0.1)
    parser.add_argument("--decay-steps", type=int, default=250000)
    parser.add_argument("--weight-decay", type=float, default=0)
    common.add_common_train_args(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = _parse_args(argv)
    kwargs = common.fit_kwargs(args)
    device = torch.device(args.device)
    args.data_path = common.resolve_data_path(args.data_path, device,
                                              args.mesh)
    os.makedirs(args.results_dir, exist_ok=True)

    model = NeRF(args.num_layers, args.num_channels,
                 args.pos_max_log_scale, args.pos_freq,
                 args.view_max_log_scale, args.view_freq,
                 [4], not args.omit_inputs,
                 generator=torch.Generator().manual_seed(args.seed)).to(device)
    opacity_model = common.load_opacity(args.opacity_model, device)
    train_dataset, val_dataset = common.load_train_val(args, opacity_model)
    visualizers = common.make_visualizers(args, train_dataset, val_dataset)
    raycaster = Raycaster(model, compute_dtype=common.get_compute_dtype(args),
                          fused=args.fused, fused_train=args.fused)
    log = raycaster.fit(train_dataset, val_dataset, args.batch_size,
                        args.learning_rate, args.num_steps, args.crop_steps,
                        args.report_interval, args.decay_rate,
                        args.decay_steps, args.weight_decay, visualizers,
                        **kwargs)

    if not common.is_primary(args):
        return 0
    save_model(model, os.path.join(args.results_dir, "nerf.npz"))
    common.save_best_model(args.results_dir, "nerf", model, log)
    common.write_run_log(os.path.join(args.results_dir, "log.txt"), args,
                         log)
    print(f"train_nerf: {sum(raycaster.call_steps)} steps of "
          f"{args.batch_size} rays x {args.num_samples} samples on "
          f"{common.device_name(device)}, {args.compute_dtype}, "
          f"{'fused' if raycaster.fused_train else 'plain'}: "
          f"{common.timing_detail(raycaster, device)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
