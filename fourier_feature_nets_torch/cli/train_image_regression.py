"""CLI: 2-D image regression.

Port of ``fourier_feature_nets_tpu/cli/train_image_regression.py``, same
flags, defaults and outputs plus ``--device`` (default ``cuda``): one of
the four FFN variants (2 -> 3, seeded with ``--seed``) fit to a PNG's
pixels by full-batch steps of sigmoid + 0.5 * MSE and plain Adam (no
clipping) at an exponentially decaying learning rate. ``synthetic[:size]``
generates the procedural test image into the port's data directory
(``$FFN_TORCH_DATA_DIR``). Every ``--report-interval`` steps (and at the
last) it prints the val PSNR and writes ``val<step>.png`` (ground truth
beside the prediction, or the activation grid with ``--activations``);
at the end ``superres.png`` (a 2x render), ``log.txt`` and
``model.npz``, and a summary line with the ms a step (CUDA events on a
card). ``--make-video`` raises ``NotImplementedError`` naming its
ROADMAP.md item (no video writer without OpenCV).

    python -m fourier_feature_nets_torch.cli.train_image_regression \\
        synthetic:512 gaussian out/
"""

import os
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser

import numpy as np
import torch

from ..datasets.pixel_dataset import PixelDataset
from ..models import save_model
from ..render.raycaster import _StepTimer
from ..utils.errors import not_ported
from ..utils.optim import ClippedAdam, exponential_lr
from ..utils.png import write_png
from . import common


def _parse_args(argv=None):
    parser = ArgumentParser("NeRF2D Image Trainer",
                            formatter_class=ArgumentDefaultsHelpFormatter)
    parser.add_argument("image_path", help="Path to a PNG file (or "
                        "'synthetic[:size]')")
    parser.add_argument("nerf_model", choices=["mlp", "basic",
                                               "positional", "gaussian"])
    parser.add_argument("results_dir")
    parser.add_argument("--device", default="cuda",
                        help="Torch device to train on")
    parser.add_argument("--activations", action="store_true")
    parser.add_argument("--vertical", action="store_true")
    parser.add_argument("--omit-gt", action="store_true")
    parser.add_argument("--image-size", type=int, default=512)
    parser.add_argument("--color-space", choices=["YCrCb", "RGB"],
                        default="RGB")
    parser.add_argument("--num-channels", type=int, default=256)
    parser.add_argument("--embedding-size", type=int, default=256)
    parser.add_argument("--pos-max-log-scale", type=float, default=6)
    parser.add_argument("--gauss-sigma", type=float, default=10)
    parser.add_argument("--num-steps", type=int, default=2000)
    parser.add_argument("--learning-rate", type=float, default=1e-3)
    parser.add_argument("--report-interval", type=int, default=50)
    parser.add_argument("--make-video", action="store_true")
    parser.add_argument("--decay-rate", type=float, default=0.1)
    parser.add_argument("--decay-steps", type=int, default=2500)
    parser.add_argument("--seed", type=int, default=20080524)
    return parser.parse_args(argv)


def resolve_image_path(path: str, default_size: int) -> str:
    """``synthetic[:size]`` -> the procedural test image in the data
    directory, generated on first use; any other path as it is."""
    parts = path.split(":")
    if parts[0] != "synthetic":
        return path
    from ..datasets.synthetic import generate_synthetic_image
    size = int(parts[1]) if len(parts) > 1 else default_size
    out = os.path.join(common.data_dir(), f"synthetic_image_{size}.png")
    if not os.path.exists(out):
        generate_synthetic_image(out, size)
    return out


def make_train_step(model, dataset: PixelDataset, learning_rate: float,
                    decay_rate: float, decay_steps: int):
    """The full-batch step: sigmoid of the model at the train UVs, 0.5 *
    MSE against the train colors, plain Adam at
    ``exponential_lr(learning_rate, step, ...)``. ``step(i)`` returns the
    loss before the update."""
    optimizer = ClippedAdam(model.parameters(), learning_rate,
                            clip_value=None, clip_norm=None)

    def train_step(step: int) -> torch.Tensor:
        optimizer.zero_grad()
        output = torch.sigmoid(model(dataset.train_uv))
        loss = 0.5 * torch.mean(torch.square(output - dataset.train_color))
        loss.backward()
        optimizer.step(exponential_lr(learning_rate, step, decay_rate,
                                      decay_steps))
        return loss.detach()

    return train_step


def main(argv=None):
    args = _parse_args(argv)
    if args.make_video:
        raise not_ported("--make-video", "Remaining models, data, CLIs and "
                         "parallel")
    device = torch.device(args.device)
    os.makedirs(args.results_dir, exist_ok=True)

    print("Creating dataset...")
    args.image_path = resolve_image_path(args.image_path, args.image_size)
    data_dir = os.path.join(os.path.dirname(__file__), "..", "..", "data")
    dataset = PixelDataset.create(args.image_path, args.color_space,
                                  args.image_size,
                                  data_dir=os.path.abspath(data_dir),
                                  device=device)

    model = common.build_ffn(
        args.nerf_model, 2, 3, args,
        torch.Generator().manual_seed(args.seed)).to(device)
    train_step = make_train_step(model, dataset, args.learning_rate,
                                 args.decay_rate, args.decay_steps)

    @torch.no_grad()
    def predict(uv):
        return torch.sigmoid(model(uv))

    # the composite frame: ground truth (or the activation grid) beside
    # the prediction
    size = args.image_size
    if args.omit_gt and not args.activations:
        width, height = size, size
    elif args.vertical:
        width, height = size, 2 * size
    else:
        width, height = 2 * size, size
    frame = np.zeros((height, width, 3), np.uint8)
    if not args.omit_gt:
        if args.vertical:
            frame[:size, :] = dataset.image
        else:
            frame[:, :size] = dataset.image

    timer = _StepTimer(device)
    log = []
    for step in range(args.num_steps + 1):
        if step % args.report_interval == 0 or step == args.num_steps:
            output = predict(dataset.val_uv)
            psnr_val = dataset.psnr(output)
            print("step", step, "val:", psnr_val)
            log.append((step, psnr_val))
            image = dataset.to_image(output)
            if args.omit_gt and not args.activations:
                frame[:] = image
            elif args.vertical:
                frame[size:, :] = image
            else:
                frame[:, size:] = image
            if args.activations:
                act_image = dataset.to_act_image(model, size)
                if args.vertical:
                    frame[:size, :] = act_image
                else:
                    frame[:, :size] = act_image
            write_png(os.path.join(args.results_dir, f"val{step:05}.png"),
                      frame)
        timer.start()
        train_step(step)
        timer.stop()

    # the 2x super-resolution render
    uvs = PixelDataset.generate_uvs(size * 2, device)
    write_png(os.path.join(args.results_dir, "superres.png"),
              dataset.to_image(predict(uvs), size * 2))

    with open(os.path.join(args.results_dir, "log.txt"), "w") as file:
        file.write("step\tpsnr_val\n")
        for step_num, psnr_val in log:
            file.write(f"{step_num}\t{psnr_val}\n")
    save_model(model, os.path.join(args.results_dir, "model.npz"))

    step_ms = timer.milliseconds()
    steady = (f"{np.mean(step_ms[1:]):.3f} ms/step over steps 2.."
              f"{len(step_ms)}" if len(step_ms) > 1 else "no later steps")
    print(f"train_image_regression: {args.nerf_model}, {len(step_ms)} steps "
          f"of {size // 2}^2 pixels on {common.device_name(device)}: first "
          f"step {step_ms[0]:.3f} ms, {steady}")
    return log


if __name__ == "__main__":
    main()
