"""CLI: extracts a colored triangle mesh (OBJ) from a trained field.

Port of ``fourier_feature_nets_tpu/cli/export_mesh.py``, same flags and
defaults plus ``--device`` (default ``cuda``): surface nets over the
model's own per-cell alpha field (any checkpoint type; the plain f32
model, swept in batches on the device, :mod:`..mesh_export`), with the
field's emission as vertex colors. Returns 1 when nothing clears
``--alpha-threshold``.

    python -m fourier_feature_nets_torch.cli.export_mesh model.npz out.obj
"""

import os
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser

import torch

from ..mesh_export import export_obj, mesh_from_model
from ..models import load_model

__all__ = ["main"]


def _parse_args(argv=None):
    parser = ArgumentParser("Mesh Exporter",
                            formatter_class=ArgumentDefaultsHelpFormatter)
    parser.add_argument("model_path", help="Path to the trained model")
    parser.add_argument("output_path", help="Output OBJ path")
    parser.add_argument("--device", default="cuda",
                        help="Torch device to sweep the field on")
    parser.add_argument("--resolution", type=int, default=192,
                        help="Sampling grid side")
    parser.add_argument("--scale", type=float, default=1.0,
                        help="Half extent of the sampled volume")
    parser.add_argument("--alpha-threshold", type=float, default=0.5,
                        help="Per-cell alpha isovalue")
    parser.add_argument("--no-colors", action="store_true",
                        help="Skip vertex colors")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = _parse_args(argv)
    model = load_model(args.model_path).to(torch.device(args.device))
    vertices, triangles, colors = mesh_from_model(
        model, resolution=args.resolution, scale=args.scale,
        alpha_threshold=args.alpha_threshold,
        with_colors=not args.no_colors)
    if len(vertices) == 0:
        print("no surface at --alpha-threshold "
              f"{args.alpha_threshold} — is the model trained? Try a "
              "lower threshold.")
        return 1
    out_dir = os.path.dirname(os.path.abspath(args.output_path))
    os.makedirs(out_dir, exist_ok=True)
    export_obj(args.output_path, vertices, triangles, colors)
    print(f"wrote {args.output_path}: {len(vertices)} vertices, "
          f"{len(triangles)} triangles "
          f"({args.resolution}^3 field, alpha {args.alpha_threshold})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
