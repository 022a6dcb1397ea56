"""CLI: visual inspection of ray sampling.

Port of ``fourier_feature_nets_tpu/cli/inspect_ray_sampling.py``, same
flags plus ``--device`` (default ``cuda``): for each sampling mode
(full, sparse, center and, where the scene has alpha, dilate) and each
of ``--num-cameras`` farthest-point cameras, the camera's image with the
mode's selected pixels kept and the rest darkened to a quarter,
``<mode>_camNNN.png``; and ``t_histogram.png``, the sampled depths of
the first 256 rays of the pool in 100 bins over their range, drawn as
bars (deterministic, ``--stratified`` with the sampler's hash jitter
under key 0 at step 0, or focus-sampled by ``--opacity-model``). Every
image goes through the port's PNG writer; the histogram is drawn in
NumPy (the JAX CLI plots it with matplotlib, and writes with OpenCV).

    python -m fourier_feature_nets_torch.cli.inspect_ray_sampling \\
        synthetic out/ --stratified
"""

import os
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser

import numpy as np
import torch

from ..datasets import ImageDataset, Mode
from ..utils.png import write_png
from . import common

__all__ = ["histogram_image", "main"]

# the histogram's image: the JAX CLI's 8 x 4 inch figure at 100 dpi
HISTOGRAM_SIZE = (400, 800)
HISTOGRAM_BINS = 100
_BAR = np.array([31, 119, 180], np.uint8)    # matplotlib's first color


def _parse_args(argv=None):
    parser = ArgumentParser("Ray Sampling Inspector",
                            formatter_class=ArgumentDefaultsHelpFormatter)
    parser.add_argument("data_path", help="Path to the data NPZ "
                        "(or 'synthetic[:res]')")
    parser.add_argument("output_dir")
    parser.add_argument("--device", default="cuda",
                        help="Torch device to sample on")
    parser.add_argument("--num-cameras", type=int, default=4)
    parser.add_argument("--num-samples", type=int, default=32)
    parser.add_argument("--stratified", action="store_true")
    parser.add_argument("--opacity-model",
                        help="Optional opacity model for focus sampling")
    return parser.parse_args(argv)


def histogram_image(values: np.ndarray, bins: int = HISTOGRAM_BINS,
                    size=HISTOGRAM_SIZE) -> np.ndarray:
    """An (H, W, 3) uint8 bar chart of ``np.histogram(values, bins)``
    (the bins matplotlib's ``hist`` takes): white, one bar a bin, the
    tallest bar the full height."""
    counts, _ = np.histogram(values, bins=bins)
    height, width = size
    image = np.full((height, width, 3), 255, np.uint8)
    edges = np.linspace(0, width, bins + 1).astype(np.int64)
    tops = height - np.round(counts / max(counts.max(), 1)
                             * height).astype(np.int64)
    for left, right, top in zip(edges[:-1], edges[1:], tops):
        image[top:, left:max(right - 1, left + 1)] = _BAR
    return image


def main(argv=None) -> int:
    args = _parse_args(argv)
    device = torch.device(args.device)
    args.data_path = common.resolve_data_path(args.data_path, device)
    os.makedirs(args.output_dir, exist_ok=True)

    opacity_model = common.load_opacity(args.opacity_model, device)
    dataset = ImageDataset.load(args.data_path, "train", args.num_samples,
                                stratified=args.stratified,
                                opacity_model=opacity_model, device=device)
    dataset = dataset.sample_cameras(args.num_cameras, args.num_samples,
                                     args.stratified)

    modes = [Mode.Full, Mode.Sparse, Mode.Center]
    if len(dataset.dilate_index):
        modes.append(Mode.Dilate)

    resolution = dataset.cameras[0].resolution
    for mode in modes:
        dataset.mode = mode
        for camera in range(dataset.num_cameras):
            mask = np.zeros(resolution.width * resolution.height, np.uint8)
            mask[dataset.index_for_camera(camera)] = 255
            mask = mask.reshape(resolution.height, resolution.width)
            overlay = dataset.images[camera][..., :3].copy()
            overlay[mask == 0] //= 4
            name = f"{mode.name.lower()}_cam{camera:03d}.png"
            write_png(os.path.join(args.output_dir, name), overlay)
    dataset.mode = Mode.Full

    # depth-distribution diagnostic
    idx = torch.from_numpy(np.asarray(dataset.index_pool()[:256], np.int64))
    rays = dataset.sampler.sample(idx.to(device), 0,
                                  0 if args.stratified else None)
    t = rays.t_values.cpu().numpy()
    write_png(os.path.join(args.output_dir, "t_histogram.png"),
              histogram_image(t.reshape(-1)))
    print("Wrote sampling diagnostics to", args.output_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
