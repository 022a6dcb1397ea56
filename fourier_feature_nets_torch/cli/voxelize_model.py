"""CLI: converts a trained radiance-field model into a sparse octree.

Port of ``fourier_feature_nets_tpu/cli/voxelize_model.py``: every train
ray is rendered with depth on the device (``Raycaster.extract_surface``,
through the fused forward kernel K1 when fused), the surface points
(alpha > threshold) at ``start + depth * direction`` form a point cloud,
and the C++ octree library fits a sparse tree to it. ``--fused`` /
``--no-fused`` force the kernel or the plain model; with neither the
sweep takes :func:`..render.raycaster.resolve_fused`'s choice (f32 here,
so plain).

    python -m fourier_feature_nets_torch.cli.voxelize_model nerf.npz \\
        synthetic tree.npz --fused
"""

import os
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser

import torch

from ..datasets import ImageDataset
from ..models import load_model
from ..octree import OcTree
from ..render import Raycaster
from . import common


def _parse_args(argv=None):
    parser = ArgumentParser("Model Voxelizer",
                            formatter_class=ArgumentDefaultsHelpFormatter)
    parser.add_argument("model_path", help="Path to the trained model")
    parser.add_argument("data_path", help="Path to the data NPZ "
                        "(or 'synthetic[:res]')")
    parser.add_argument("output_path", help="Output NPZ path")
    parser.add_argument("--device", default="cuda",
                        help="Torch device of the sweep")
    parser.add_argument("--num-samples", type=int, default=128)
    parser.add_argument("--num-cameras", type=int, default=100,
                        help="Max cameras used for the sweep "
                        "(voxelize_model.py:20-21)")
    parser.add_argument("--batch-size", type=int, default=16384)
    parser.add_argument("--depth", type=int, default=8,
                        help="Octree depth")
    parser.add_argument("--min-leaf-size", type=int, default=4)
    parser.add_argument("--alpha-threshold", type=float, default=0.3)
    parser.add_argument("--color-space", choices=["YCrCb", "RGB"],
                        default="RGB")
    parser.add_argument("--fused", action="store_true", default=None,
                        help="Force the fused NeRF kernel for the sweep "
                        "(default: on for a NeRF on a CUDA device in "
                        "bf16, so off at this CLI's f32)")
    parser.add_argument("--no-fused", dest="fused", action="store_false",
                        help="Force the plain PyTorch render path")
    return parser.parse_args(argv)


def main(argv=None):
    args = _parse_args(argv)
    device = torch.device(args.device)
    args.data_path = common.resolve_data_path(args.data_path, device)

    model = load_model(args.model_path).to(device)
    dataset = ImageDataset.load(args.data_path, "train", args.num_samples,
                                color_space=args.color_space, device=device)
    if args.num_cameras and args.num_cameras < dataset.num_cameras:
        dataset = dataset.sample_cameras(args.num_cameras,
                                         dataset.num_samples, False)

    raycaster = Raycaster(model, fused=args.fused)
    positions, colors = raycaster.extract_surface(
        dataset, args.batch_size, args.alpha_threshold)
    print(f"voxelizing {len(positions)} surface points")
    if len(positions) == 0:
        print("no surface points above --alpha-threshold "
              f"{args.alpha_threshold}: is the model trained? Try a "
              "lower threshold.")
        return 1

    tree = OcTree.build_from_samples(positions, args.depth,
                                     args.min_leaf_size, colors)
    print(f"octree: {tree.num_leaves} leaves, depth {tree.depth}")
    os.makedirs(os.path.dirname(os.path.abspath(args.output_path)),
                exist_ok=True)
    tree.save(args.output_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
