"""CLI: converts a checkpoint between the NPZ and the reference's ``.pt``.

Port of ``fourier_feature_nets_tpu/cli/convert_checkpoint.py``:
``load_model`` reads either format (of any model type), and the output
is written in the format its suffix names: ``.pt`` / ``.pth`` the
reference's (which factorized voxels do not have), anything else the
NPZ.

    python -m fourier_feature_nets_torch.cli.convert_checkpoint \\
        input.{npz|pt} output.{npz|pt}
"""

import argparse

from ..models import load_model, save_model, save_torch_model


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("input",
                        help="checkpoint to read (.npz, .pt or .pth)")
    parser.add_argument("output",
                        help="checkpoint to write (.npz, .pt or .pth)")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    model = load_model(args.input)
    if args.output.endswith((".pt", ".pth")):
        save_torch_model(model, args.output)
    else:
        save_model(model, args.output)
    print(f"{args.input} -> {args.output} ({model.model_type})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
