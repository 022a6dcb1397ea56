"""CLI: trains a Tiny NeRF (a position-only radiance field).

Port of ``fourier_feature_nets_tpu/cli/train_tiny_nerf.py``, same flags
and defaults plus ``--device`` (default ``cuda``): a 3 -> 4 FFN variant
(``mlp``, ``basic``, ``positional`` or ``gaussian``, seeded with
``--seed``) trained through ``Raycaster.fit`` as plain PyTorch (the
fused kernels are the NeRF's only), optionally focus-sampled by
``--opacity-model`` (any checkpoint type). ``--make-activations`` writes
an orbit of the last hidden layer's activation grid to
``<results_dir>/activations``. ``--steps-per-call``, ``--resume``,
``--make-video`` and the other common training flags work as in
``train_nerf``. Writes
``tiny_nerf.npz``, ``tiny_nerf_best.npz`` and ``log.txt``.

    python -m fourier_feature_nets_torch.cli.train_tiny_nerf synthetic \\
        positional out/ --num-steps 2000
"""

import os
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser

import torch

from ..models import save_model
from ..render import Raycaster
from ..visualizers import ActivationVisualizer
from . import common


def _parse_args(argv=None):
    parser = ArgumentParser("Tiny NeRF Training Script",
                            formatter_class=ArgumentDefaultsHelpFormatter)
    parser.add_argument("data_path", help="Path to the data NPZ "
                        "(or 'synthetic[:res]')")
    parser.add_argument("nerf_model", choices=["mlp", "basic",
                                               "positional", "gaussian"])
    parser.add_argument("results_dir", help="Path to output results")
    parser.add_argument("--opacity-model")
    parser.add_argument("--num-samples", type=int, default=128)
    parser.add_argument("--learning-rate", type=float, default=5e-4)
    parser.add_argument("--num-channels", type=int, default=256)
    parser.add_argument("--embedding-size", type=int, default=256)
    parser.add_argument("--pos-max-log-scale", type=float, default=5.5)
    parser.add_argument("--gauss-sigma", type=float, default=6.05)
    parser.add_argument("--num-steps", type=int, default=50000)
    parser.add_argument("--crop-steps", type=int, default=1000)
    parser.add_argument("--decay-rate", type=float, default=0.1)
    parser.add_argument("--decay-steps", type=int, default=25000)
    parser.add_argument("--weight-decay", type=float, default=0)
    parser.add_argument("--make-activations", action="store_true")
    common.add_common_train_args(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = _parse_args(argv)
    kwargs = common.fit_kwargs(args)
    device = torch.device(args.device)
    args.data_path = common.resolve_data_path(args.data_path, device,
                                              args.mesh)
    os.makedirs(args.results_dir, exist_ok=True)

    model = common.build_ffn(
        args.nerf_model, 3, 4, args,
        torch.Generator().manual_seed(args.seed)).to(device)
    opacity_model = common.load_opacity(args.opacity_model, device)
    train_dataset, val_dataset = common.load_train_val(args, opacity_model)
    visualizers = common.make_visualizers(args, train_dataset, val_dataset)
    if args.make_activations and common.is_primary(args):
        visualizers.append(ActivationVisualizer(
            args.results_dir, args.num_steps,
            train_dataset.cameras[0].resolution, args.num_frames,
            args.num_samples, args.color_space, device))

    raycaster = Raycaster(model, compute_dtype=common.get_compute_dtype(args),
                          fused=args.fused, fused_train=args.fused)
    log = raycaster.fit(train_dataset, val_dataset, args.batch_size,
                        args.learning_rate, args.num_steps, args.crop_steps,
                        args.report_interval, args.decay_rate,
                        args.decay_steps, args.weight_decay, visualizers,
                        **kwargs)

    if not common.is_primary(args):
        return 0
    save_model(model, os.path.join(args.results_dir, "tiny_nerf.npz"))
    common.save_best_model(args.results_dir, "tiny_nerf", model, log)
    common.write_run_log(os.path.join(args.results_dir, "log.txt"), args,
                         log)
    print(f"train_tiny_nerf: {args.nerf_model}, "
          f"{sum(raycaster.call_steps)} steps of {args.batch_size} rays x "
          f"{args.num_samples} samples on {common.device_name(device)}, "
          f"{args.compute_dtype}: "
          f"{common.timing_detail(raycaster, device)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
