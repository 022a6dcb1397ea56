"""Named render presets shared by the rendering CLIs (port of
``RENDER_PRESETS``, ``add_preset_arg`` and ``apply_render_preset`` from
``fourier_feature_nets_tpu/cli/common.py``). A preset only fills flags
the user left unset, so explicit flags always win."""

import sys

__all__ = ["RENDER_PRESETS", "add_preset_arg", "apply_render_preset"]

RENDER_PRESETS = {
    "fast": {
        # density-grid culling + the production 48-sample dose
        "density_grid": True,
        "num_samples": 48,
        "compute_dtype": "bfloat16",
    },
    "quality": {
        # 96 guided samples + early termination
        "density_grid": True,
        "num_samples": 96,
        "early_term": 1e-2,
        "early_split": 48,
        "compute_dtype": "bfloat16",
    },
}


def add_preset_arg(parser):
    parser.add_argument("--preset", choices=sorted(RENDER_PRESETS),
                        help="Named render/serving configuration "
                             "(fills any flag you did not set "
                             "explicitly): 'fast' = density-grid "
                             "culling at 48 samples; 'quality' = 96 "
                             "samples + early termination")


def apply_render_preset(args, parser, argv=None):
    """Fills preset values for flags the user did not pass.

    Presence is decided from ``argv`` (passing the default value
    explicitly must still beat the preset), with abbreviated long
    options resolved the way argparse resolves them."""
    preset = getattr(args, "preset", None)
    if not preset:
        return args
    tokens = list(sys.argv[1:] if argv is None else argv)
    options = list(parser._option_string_actions)

    explicit = set()
    for tok in tokens:
        if tok == "--":
            break
        if not tok.startswith("--"):
            continue
        stem = tok.split("=", 1)[0]
        if stem in options:
            explicit.add(stem)
            continue
        matches = [opt for opt in options if opt.startswith(stem)]
        if len(matches) == 1:
            explicit.add(matches[0])

    for name, value in RENDER_PRESETS[preset].items():
        if "--" + name.replace("_", "-") not in explicit:
            setattr(args, name, value)
    return args
