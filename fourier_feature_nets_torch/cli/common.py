"""Shared plumbing of the CLIs (port of
``fourier_feature_nets_tpu/cli/common.py``): the training flags and the
helpers around ``Raycaster.fit``, the named render presets, and the
kernel CLIs' device and timing helpers. A preset only fills
flags the user left unset, so explicit flags always win."""

import json
import os
import sys
import time

import numpy as np
import torch

from ..utils.errors import not_ported

__all__ = ["RECOMMENDED_STUDENT", "RENDER_PRESETS", "add_common_train_args",
           "add_preset_arg", "apply_render_preset", "bench_ms", "build_ffn",
           "device_name", "fit_kwargs", "get_compute_dtype", "kernel_device",
           "load_opacity", "load_train_val", "make_visualizers",
           "resolve_data_path", "save_best_model", "timing_detail",
           "write_run_log"]


_REMAINING = "Remaining models, data, CLIs and parallel"


def add_common_train_args(parser):
    """Arguments shared by the 3D trainers, with the JAX CLI's
    defaults, plus ``--device``."""
    parser.add_argument("--device", default="cuda",
                        help="Torch device to train on")
    parser.add_argument("--mode", choices=["rgba", "rgb", "dilate"],
                        default="rgba")
    parser.add_argument("--batch-size", type=int, default=1024)
    parser.add_argument("--report-interval", type=int, default=1000)
    parser.add_argument("--image-interval", type=int, default=2000)
    parser.add_argument("--seed", type=int, default=20080524)
    parser.add_argument("--make-video", action="store_true")
    parser.add_argument("--color-space", choices=["YCrCb", "RGB"],
                        default="RGB")
    parser.add_argument("--num-frames", type=int, default=200)
    parser.add_argument("--anneal-start", type=float, default=0.2)
    parser.add_argument("--num-anneal-steps", type=int, default=2000)
    parser.add_argument("--data-parallel", action="store_true",
                        help="Shard the ray batch across all devices")
    parser.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                        default="float32",
                        help="Matmul dtype for the model body")
    parser.add_argument("--fused", action="store_true", default=None,
                        help="Force the fused NeRF kernels for rendering "
                             "and training (default: on for a NeRF on a "
                             "CUDA device with --compute-dtype bfloat16, "
                             "where they beat the plain path; off in f32, "
                             "where a whole step did not in every run)")
    parser.add_argument("--no-fused", dest="fused", action="store_false",
                        help="Force the plain PyTorch autograd/render path")
    parser.add_argument("--steps-per-call", type=int, default=1,
                        help="Training steps per call; above 1, on CUDA "
                             "one CUDA-graph replay")
    parser.add_argument("--checkpoint-interval", type=int, default=0,
                        help="Steps between resumable train-state "
                             "checkpoints (written in the background to "
                             "<results_dir>/checkpoints); 0 disables")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from the newest checkpoint in "
                             "<results_dir>/checkpoints")
    parser.add_argument("--occupancy-interval", type=int, default=0,
                        help="Occupancy-guided training: refresh the "
                             "density grid of the live model every this "
                             "many steps; 0 disables")
    parser.add_argument("--occupancy-samples", type=int, default=48,
                        help="Samples/ray of occupancy-guided steps")
    parser.add_argument("--occupancy-start", type=int, default=0,
                        help="First occupancy-guided step (0: after the "
                             "crop, at least 1000)")
    parser.add_argument("--occupancy-end", type=int, default=0,
                        help="Step from which full sampling returns (0: "
                             "occupancy until the end)")
    parser.add_argument("--occupancy-empty-weight", type=float, default=0.1,
                        help="CDF mass of the grid's empty probes")
    parser.add_argument("--occupancy-mix", type=int, default=0,
                        help="Full-sampling steps after each guided call")


def fit_kwargs(args) -> dict:
    """``fit`` kwargs from the common flags: the seed, steps per call,
    occupancy-guided training and checkpoint/resume, as the JAX CLI
    passes them. ``--make-video`` and ``--data-parallel`` raise here."""
    if args.make_video:
        raise not_ported("--make-video", _REMAINING)
    if args.data_parallel:
        raise not_ported("--data-parallel", _REMAINING)
    kwargs = {"seed": args.seed, "steps_per_call": args.steps_per_call}
    if args.occupancy_interval:
        kwargs.update(
            occupancy_interval=args.occupancy_interval,
            occupancy_samples=args.occupancy_samples,
            occupancy_start=args.occupancy_start or None,
            occupancy_end=args.occupancy_end or None,
            occupancy_empty_weight=args.occupancy_empty_weight,
            occupancy_mix=args.occupancy_mix)
    if args.checkpoint_interval or args.resume:
        kwargs.update(checkpoint_dir=os.path.join(args.results_dir,
                                                  "checkpoints"),
                      checkpoint_interval=args.checkpoint_interval or None,
                      resume=args.resume)
    return kwargs


def data_dir() -> str:
    """Where generated datasets are cached: ``$FFN_TORCH_DATA_DIR`` or
    ``~/.cache/fourier_feature_nets_torch``."""
    root = os.environ.get("FFN_TORCH_DATA_DIR")
    if root:
        return root
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "fourier_feature_nets_torch")


def resolve_data_path(path: str, device="cpu") -> str:
    """Resolves a dataset path; ``synthetic[:<res>]`` generates the
    built-in synthetic scene on ``device`` into :func:`data_dir` on
    first use (the scheme must match exactly: a file named
    ``synthetic_800.npz`` is a path)."""
    parts = path.split(":")
    if parts[0] == "synthetic":
        from ..datasets.synthetic import load_or_generate
        res = int(parts[1]) if len(parts) > 1 else 100
        out = os.path.join(data_dir(), f"synthetic_{res}.npz")
        return load_or_generate(out, resolution=res, device=device)
    return path


def load_opacity(path, device):
    """The optional opacity model of focus sampling (``--opacity-model``)
    on ``device``, or None without a path."""
    if not path:
        return None
    from ..models import load_model
    return load_model(path).to(device)


def load_train_val(args, opacity_model=None, num_samples=None):
    """Train (stratified, annealed) and val datasets on ``args.device``,
    both focus-sampled with ``opacity_model`` when one is given."""
    from ..datasets import ImageDataset, Mode
    include_alpha = args.mode == "rgba"
    num_samples = num_samples or args.num_samples
    train = ImageDataset.load(args.data_path, "train", num_samples,
                              include_alpha, True, opacity_model,
                              args.batch_size, args.color_space,
                              anneal_start=args.anneal_start,
                              num_anneal_steps=args.num_anneal_steps,
                              device=args.device)
    val = ImageDataset.load(args.data_path, "val", num_samples,
                            include_alpha, False, opacity_model,
                            args.batch_size, args.color_space,
                            device=args.device)
    if args.mode == "dilate":
        train.mode = Mode.Dilate
    return train, val


def make_visualizers(args, train_dataset, val_dataset):
    """The per-run visualizers: evaluation grids of the train and val
    sets every ``--image-interval`` steps (0 disables them)."""
    from ..visualizers import EvaluationVisualizer
    if args.image_interval <= 0:
        return []
    return [EvaluationVisualizer(args.results_dir, train_dataset,
                                 args.image_interval),
            EvaluationVisualizer(args.results_dir, val_dataset,
                                 args.image_interval)]


def get_compute_dtype(args):
    return torch.bfloat16 if args.compute_dtype == "bfloat16" else None


def save_best_model(results_dir, name, model, log):
    """Writes ``<name>_best.npz``, the report snapshot with the highest
    val PSNR, beside the final model."""
    from ..models import build_model, params_from_jax, save_model
    entries = [e for e in log if np.isfinite(e.val_psnr)]
    if not entries:
        return None
    best = max(entries, key=lambda e: e.val_psnr)
    path = os.path.join(results_dir, f"{name}_best.npz")
    snapshot = build_model(model.model_type, model.params_manifest)
    save_model(params_from_jax(snapshot, best.state), path)
    print(f"best val checkpoint: step {best.step} "
          f"({best.val_psnr:.2f} dB) -> {path}")
    return path


def build_ffn(name: str, num_inputs: int, num_outputs: int, args,
              generator=None):
    """One of the four FFN variants (``mlp``, ``basic``, ``positional``,
    ``gaussian``) at the CLI's ``--num-channels``, ``--embedding-size``,
    ``--pos-max-log-scale`` and ``--gauss-sigma``, drawn from
    ``generator`` (the Gaussian matrix first, then the layers)."""
    from ..models import (
        MLP,
        BasicFourierMLP,
        GaussianFourierMLP,
        PositionalFourierMLP,
    )
    if name == "mlp":
        return MLP(num_inputs, num_outputs, num_channels=args.num_channels,
                   generator=generator)
    if name == "basic":
        return BasicFourierMLP(num_inputs, num_outputs,
                               num_channels=args.num_channels,
                               generator=generator)
    if name == "positional":
        return PositionalFourierMLP(num_inputs, num_outputs,
                                    max_log_scale=args.pos_max_log_scale,
                                    num_channels=args.num_channels,
                                    embedding_size=args.embedding_size,
                                    generator=generator)
    if name == "gaussian":
        return GaussianFourierMLP(num_inputs, num_outputs,
                                  sigma=args.gauss_sigma,
                                  num_channels=args.num_channels,
                                  embedding_size=args.embedding_size,
                                  generator=generator)
    raise NotImplementedError(f"Unsupported model: {name}")


def timing_detail(raycaster, device) -> str:
    """A fit's step times: for one step a call "first step ... ms,
    ... ms/step over steps 2..N"; for chunks "first call ... (k steps,
    with its capture on CUDA), ... ms/step over steps k+1..N, host ...
    ms a call"."""
    step_ms, steps = raycaster.step_ms, raycaster.call_steps
    total = sum(steps)
    later = sum(ms * n for ms, n in zip(step_ms[1:], steps[1:]))
    steady = (f"{later / (total - steps[0]):.3f} ms/step over steps "
              f"{steps[0] + 1}..{total}" if len(steps) > 1
              else "no later steps")
    if max(steps) == 1:
        return f"first step {step_ms[0]:.3f} ms, {steady}"
    host = (f", host {np.mean(raycaster.host_ms[1:]):.3f} ms a call"
            if len(steps) > 1 else "")
    capture = ", with its capture" if device.type == "cuda" else ""
    return (f"first call {step_ms[0] * steps[0]:.3f} ms ({steps[0]} "
            f"steps{capture}), {steady}{host}")


def device_name(device) -> str:
    """The card's name on CUDA, else the device."""
    device = torch.device(device)
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))


def write_run_log(path, args, log):
    """JSON args header + TSV of the LogEntry rows."""
    from ..utils.progress import write_log
    with open(path, "w") as file:
        json.dump({k: v for k, v in vars(args).items()
                   if isinstance(v, (int, float, str, bool, type(None)))},
                  file)
        file.write("\n\n")
        write_log(file, log)


def kernel_device(tool: str, name: str, cpu_note: str):
    """The torch device of a kernel CLI, named on stderr, or None (after
    saying why) when it asks for a card and there is none. On a card the
    plain twins' f32 products are full f32 (no TF32); on the CPU the
    wrappers run the twins, which ``cpu_note`` says the output means."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print(f"{tool}: no CUDA device; the kernels run on a GPU only",
                  file=sys.stderr)
            return None
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"device: {torch.cuda.get_device_name(device)}",
              file=sys.stderr)
    else:
        print(f"device: {device}; the wrappers run the kernels' plain "
              f"twins, {cpu_note}", file=sys.stderr)
    return device


def bench_ms(fn, reps: int, device) -> float:
    """Mean milliseconds per call over ``reps`` back-to-back calls of
    ``fn`` after one warm-up call: CUDA events on a card, the host clock
    elsewhere."""
    fn()
    if torch.device(device).type != "cuda":
        start = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - start) * 1e3 / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# The serving student's (num_layers, num_channels): the shape
# ``--preset fast`` pairs with, and distill_model's default student (the
# JAX package's ``RECOMMENDED_STUDENT``).
RECOMMENDED_STUDENT = (6, 192)

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
