"""CLI: 1-D signal regression.

Port of ``fourier_feature_nets_tpu/cli/train_signal_regression.py``,
same flags, defaults and outputs plus ``--device`` (default ``cuda``):
an MLP (``--fourier``: on hand-built Fourier features, b = 1..N/2 and a
= 1/b), seeded with ``--seed``, its last bias set to the train mean, fit
to a signal by full-batch steps of MSE and plain Adam (lr 5e-4, weight
decay 1e-3, no clipping). Every ``--report-interval`` steps (and at the
last) it prints the train and val loss; at the end it writes
``log.txt``, ``model.npz`` and, unless ``--no-plot``, ``final.png``
(which needs matplotlib: without it the run raises naming it), and a
summary line with the ms a step (CUDA events on a card).
``--make-video`` raises ``NotImplementedError`` naming its ROADMAP.md
item.

    python -m fourier_feature_nets_torch.cli.train_signal_regression \\
        multifreq out/ --fourier --no-plot
"""

import os
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser
from typing import NamedTuple

import numpy as np
import torch

from ..datasets.signal_dataset import SignalDataset, pyplot
from ..models import FourierFeatureMLP, save_model
from ..render.raycaster import _StepTimer
from ..utils.errors import not_ported
from ..utils.optim import ClippedAdam
from . import common

LEARNING_RATE = 5e-4
WEIGHT_DECAY = 1e-3


def multifreq(x):
    """2 + sin(pi x) + 0.5 sin(2 pi x) - 0.2 cos(5 pi x)."""
    return (2 + np.sin(x * np.pi) + 0.5 * np.sin(2 * x * np.pi)
            - 0.2 * np.cos(5 * x * np.pi))


def triangle(x):
    """Triangle wave with period 1 over [0, 2)."""
    section = 0.5
    out = np.zeros_like(x)
    s0 = x < section
    s1 = (x >= section) & (x < 2 * section)
    s2 = (x >= 2 * section) & (x < 3 * section)
    s3 = x >= 3 * section
    out[s0] = x[s0]
    out[s1] = 2 * section - x[s1]
    out[s2] = x[s2] - 2 * section
    out[s3] = 4 * section - x[s3]
    return out


def sawtooth(x):
    """Sawtooth wave with period 0.5 over [0, 2)."""
    return x % 0.5


SIGNALS = {"multifreq": multifreq, "sawtooth": sawtooth,
           "triangle": triangle}


class LogEntry(NamedTuple):
    step: int
    train_loss: float
    val_loss: float


def _parse_args(argv=None):
    parser = ArgumentParser("1-D Signal Regression",
                            formatter_class=ArgumentDefaultsHelpFormatter)
    parser.add_argument("signal", choices=sorted(SIGNALS))
    parser.add_argument("results_dir", help="Output directory")
    parser.add_argument("--device", default="cuda",
                        help="Torch device to train on")
    parser.add_argument("--num-channels", type=int, default=64)
    parser.add_argument("--num-layers", type=int, default=1)
    parser.add_argument("--num-samples", type=int, default=32)
    parser.add_argument("--sample-rate", type=int, default=8)
    parser.add_argument("--num-plot", type=int, default=48)
    parser.add_argument("--max-hidden", type=int, default=10)
    parser.add_argument("--fourier", action="store_true",
                        help="Use hand-built Fourier features")
    parser.add_argument("--resolution", default="1280x720")
    parser.add_argument("--num-steps", type=int, default=10000)
    parser.add_argument("--make-video", action="store_true")
    parser.add_argument("--framerate", type=int, default=5)
    parser.add_argument("--no-plot", action="store_true")
    parser.add_argument("--report-interval", type=int, default=50)
    parser.add_argument("--seed", type=int, default=20080524)
    return parser.parse_args(argv)


def build_model(args, dataset: SignalDataset) -> FourierFeatureMLP:
    """The 1 -> 1 MLP on the CPU, its last bias the train mean."""
    if args.fourier:
        b_values = np.arange(1, args.num_samples // 2 + 1,
                             dtype=np.float32).reshape(1, -1)
        a_values = 1 / np.arange(1, args.num_samples // 2 + 1,
                                 dtype=np.float32)
    else:
        a_values = b_values = None
    model = FourierFeatureMLP(1, 1, a_values, b_values,
                              [args.num_channels] * args.num_layers,
                              torch.Generator().manual_seed(args.seed))
    with torch.no_grad():
        model.layers[-1].bias.copy_(dataset.train_y.mean().reshape(1))
    return model


def make_train_step(model, dataset: SignalDataset):
    """The full-batch step: MSE at the train samples, plain Adam with
    weight decay. ``step()`` returns the loss before the update."""
    optimizer = ClippedAdam(model.parameters(), LEARNING_RATE,
                            weight_decay=WEIGHT_DECAY, clip_value=None,
                            clip_norm=None)

    def train_step() -> torch.Tensor:
        optimizer.zero_grad()
        loss = torch.mean(torch.square(model(dataset.train_x)
                                       - dataset.train_y))
        loss.backward()
        optimizer.step(LEARNING_RATE)
        return loss.detach()

    return train_step


def main(argv=None):
    args = _parse_args(argv)
    if args.make_video:
        raise not_ported("--make-video", "Remaining models, data, CLIs and "
                         "parallel")
    plt = None if args.no_plot else pyplot()
    device = torch.device(args.device)
    dataset = SignalDataset.create(SIGNALS[args.signal], args.num_samples,
                                   args.sample_rate, device)
    model = build_model(args, dataset).to(device)
    os.makedirs(args.results_dir, exist_ok=True)
    train_step = make_train_step(model, dataset)

    timer = _StepTimer(device)
    log = []
    for step in range(args.num_steps + 1):
        timer.start()
        loss = train_step()
        timer.stop()
        if step % args.report_interval == 0 or step == args.num_steps:
            with torch.no_grad():
                val_loss = float(torch.mean(torch.square(
                    model(dataset.val_x) - dataset.val_y)))
            train_loss = float(loss)
            print(step, "train:", train_loss, "val:", val_loss)
            log.append(LogEntry(step, train_loss, val_loss))

    if plt is not None:
        width, height = (int(v) for v in args.resolution.split("x"))
        fig = plt.figure(figsize=(width / 100, height / 100), dpi=100)
        colors = plt.get_cmap("viridis")(
            np.linspace(0, 1, args.num_plot))[..., :3]
        hidden_ax = fig.add_subplot(121)
        space_ax = fig.add_subplot(122)
        hidden_ax.set_title("Hidden Layer Basis")
        space_ax.set_title("{}MLP {}x{} {:.3f}@{:05d}".format(
            "Fourier " if args.fourier else "", args.num_layers,
            args.num_channels, log[-1].val_loss, log[-1].step))
        dataset.plot(space_ax, hidden_ax, model, args.num_plot, colors,
                     args.max_hidden)
        fig.tight_layout()
        fig.savefig(os.path.join(args.results_dir, "final.png"))
        plt.close(fig)

    with open(os.path.join(args.results_dir, "log.txt"), "w") as file:
        file.write("step\ttrain_loss\tval_loss\n")
        for entry in log:
            file.write(f"{entry.step}\t{entry.train_loss}\t"
                       f"{entry.val_loss}\n")
    save_model(model, os.path.join(args.results_dir, "model.npz"))

    step_ms = timer.milliseconds()
    steady = (f"{np.mean(step_ms[1:]):.3f} ms/step over steps 2.."
              f"{len(step_ms)}" if len(step_ms) > 1 else "no later steps")
    print(f"train_signal_regression: {args.signal}, {len(step_ms)} steps on "
          f"{common.device_name(device)}: first step {step_ms[0]:.3f} ms, "
          f"{steady}")
    return log


if __name__ == "__main__":
    main()
