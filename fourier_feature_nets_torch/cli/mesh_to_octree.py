"""CLI: voxelizes a triangle mesh into a sparse octree.

Port of ``fourier_feature_nets_tpu/cli/mesh_to_octree.py``: loads an
OBJ, samples a Basu-Owen barycentric point cloud on its faces
(``octree/mesh.py``) and fits an octree. Mesh loading needs the
optional ``trimesh`` package; without it the CLI fails with an
``ImportError`` naming it.

    python -m fourier_feature_nets_torch.cli.mesh_to_octree mesh.obj tree.npz
"""

from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser

import numpy as np

from ..octree import OcTree


def _parse_args(argv=None):
    parser = ArgumentParser("Mesh Voxelizer",
                            formatter_class=ArgumentDefaultsHelpFormatter)
    parser.add_argument("mesh_path", help="Path to the OBJ file")
    parser.add_argument("output_path", help="Path to the output NPZ")
    parser.add_argument("--voxel-depth", type=int, default=8,
                        help="Depth of the octree to use")
    parser.add_argument("--min-leaf-size", type=int, default=4,
                        help="Minimum number of samples in a leaf")
    parser.add_argument("--up-dir", default="0,1,0",
                        help="Comma-separated scene up direction")
    return parser.parse_args(argv)


def main(argv=None):
    args = _parse_args(argv)
    up_dir = np.array([float(v) for v in args.up_dir.split(",")],
                      np.float32)
    print("Building the octree")
    voxels = OcTree.build_from_mesh(args.mesh_path, args.voxel_depth,
                                    args.min_leaf_size, up_dir)
    voxels.save(args.output_path)
    print(f"wrote {args.output_path}: depth {voxels.depth}, "
          f"{voxels.num_leaves} leaves")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
