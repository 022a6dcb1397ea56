"""CLI: trains a voxel radiance field from images.

Port of ``fourier_feature_nets_tpu/cli/train_voxels.py``, same flags
and defaults plus ``--device`` (default ``cuda``): a dense ``Voxels``
grid of ``side`` cubed cells, or with ``--factorized-rank R`` > 0 a
``FactorizedVoxels`` field of rank R (seeded with ``--seed``), trained
through ``Raycaster.fit`` as plain PyTorch, with no crop curriculum and
no weight decay. The cube spans the render volume: its half extent is
``bounds[0, 0] / 2`` (the JAX package's corrected form).
``--steps-per-call``, ``--resume``, ``--make-video`` and the other
common training flags work as in ``train_nerf``. Writes ``voxels.npz``, ``voxels_best.npz``
and ``log.txt``.

    python -m fourier_feature_nets_torch.cli.train_voxels synthetic 128 out/
"""

import os
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser

import torch

from ..models import FactorizedVoxels, Voxels, save_model
from ..render import Raycaster
from . import common


def _parse_args(argv=None):
    parser = ArgumentParser("Voxel Training Script",
                            formatter_class=ArgumentDefaultsHelpFormatter)
    parser.add_argument("data_path", help="Path to the data NPZ "
                        "(or 'synthetic[:res]')")
    parser.add_argument("side", type=int, help="Voxels per volume side")
    parser.add_argument("results_dir", help="Path to output results")
    parser.add_argument("--num-samples", type=int, default=256)
    parser.add_argument("--learning-rate", type=float, default=0.01)
    parser.add_argument("--num-steps", type=int, default=10000)
    parser.add_argument("--decay-rate", type=float, default=0.9)
    parser.add_argument("--decay-steps", type=int, default=25000)
    parser.add_argument("--factorized-rank", type=int, default=0,
                        help="Rank > 0 trains a TensoRF-VM factorized "
                             "voxel field instead of the dense grid")
    common.add_common_train_args(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = _parse_args(argv)
    kwargs = common.fit_kwargs(args)
    device = torch.device(args.device)
    args.data_path = common.resolve_data_path(args.data_path, device,
                                              args.mesh)
    os.makedirs(args.results_dir, exist_ok=True)

    train_dataset, val_dataset = common.load_train_val(args)
    visualizers = common.make_visualizers(args, train_dataset, val_dataset)

    # the reference's scale = 2 / bounds[0, 0] agrees only for a volume
    # with bounds[0, 0] == 2; the half extent is bounds[0, 0] / 2
    scale = float(train_dataset.sampler.bounds[0, 0]) / 2.0
    if args.factorized_rank > 0:
        model = FactorizedVoxels(
            args.side, scale, rank=args.factorized_rank,
            generator=torch.Generator().manual_seed(args.seed))
    else:
        model = Voxels(args.side, scale)
    model = model.to(device)
    raycaster = Raycaster(model, compute_dtype=common.get_compute_dtype(args),
                          fused=args.fused, fused_train=args.fused)
    log = raycaster.fit(train_dataset, val_dataset, args.batch_size,
                        args.learning_rate, args.num_steps, 0,
                        args.report_interval, args.decay_rate,
                        args.decay_steps, 0.0, visualizers, **kwargs)

    if not common.is_primary(args):
        return 0
    save_model(model, os.path.join(args.results_dir, "voxels.npz"))
    common.save_best_model(args.results_dir, "voxels", model, log)
    common.write_run_log(os.path.join(args.results_dir, "log.txt"), args,
                         log)
    print(f"train_voxels: {model.model_type} side {args.side}, "
          f"{sum(raycaster.call_steps)} steps of {args.batch_size} rays x "
          f"{args.num_samples} samples on {common.device_name(device)}: "
          f"{common.timing_detail(raycaster, device)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
