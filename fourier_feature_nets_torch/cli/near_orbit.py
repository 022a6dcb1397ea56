"""CLI: video of the dataset images nearest to an orbit path.

Port of ``fourier_feature_nets_tpu/cli/near_orbit.py``: for each camera
on the orbit, the training image whose camera is closest, as a
ground-truth companion to ``orbit_video``. A non-square image is
cropped to the centre square on its long axis, an RGBA image is
premultiplied by its alpha, and each frame is resized bilinearly
(:func:`..utils.image.resize_linear`, ``cv2.resize``'s default) and
written as Motion-JPEG in MP4 (:mod:`..utils.video`), where the JAX CLI
writes MPEG-4 Part 2 frames with OpenCV. It runs on the host only.

    python -m fourier_feature_nets_torch.cli.near_orbit scene.npz near.mp4 \\
        --num-frames 200 --resolution 512
"""

from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser

import numpy as np

from ..cameras import Resolution
from ..utils.camera_paths import orbit
from ..utils.image import resize_linear
from ..utils.video import VideoWriter


def _parse_args(argv=None):
    parser = ArgumentParser("Near-orbit ground-truth video",
                            formatter_class=ArgumentDefaultsHelpFormatter)
    parser.add_argument("data_path", help="Path to the data NPZ")
    parser.add_argument("mp4_path", help="Output MP4 path")
    parser.add_argument("--num-frames", type=int, default=200)
    parser.add_argument("--up-dir", default="0,1,0")
    parser.add_argument("--forward-dir", default="0,0,-1")
    parser.add_argument("--framerate", type=float, default=10)
    parser.add_argument("--resolution", type=int, default=512)
    parser.add_argument("--distance", type=float, default=3)
    return parser.parse_args(argv)


def nearest_frame(image: np.ndarray, resolution: Resolution) -> np.ndarray:
    """One dataset image as a frame: the centre square crop on the long
    axis, RGBA premultiplied by its alpha, resized bilinearly."""
    height, width = image.shape[:2]
    if width != height:
        side = min(width, height)
        row0 = (height - side) // 2
        col0 = (width - side) // 2
        image = image[row0:row0 + side, col0:col0 + side]
    if image.shape[-1] == 4:
        image = image / 255
        image = image[..., :3] * image[..., 3:]
        image = (image * 255).astype(np.uint8)
    return resize_linear(np.ascontiguousarray(image), resolution.width,
                         resolution.height)


def main(argv=None):
    args = _parse_args(argv)
    up_dir = np.array([float(x) for x in args.up_dir.split(",")],
                      np.float32)
    forward_dir = np.array([float(x) for x in args.forward_dir.split(",")],
                           np.float32)

    data = np.load(args.data_path)
    images = data["images"]
    height, width = images.shape[1:3]
    resolution = Resolution(width, height).scale_to_height(
        args.resolution).square()
    train_count = int(data["split_counts"][0])
    data_positions = np.stack([ext[:3, 3]
                               for ext in data["extrinsics"][:train_count]])

    orbit_cameras = orbit(up_dir, forward_dir, args.num_frames, 40,
                          resolution, args.distance)
    orbit_positions = np.stack([cam.position[0] for cam in orbit_cameras])
    distances = np.square(orbit_positions[:, None]
                          - data_positions[None]).sum(-1)
    gt_index = distances.argmin(-1)

    with VideoWriter(args.mp4_path, args.framerate,
                     (resolution.width, resolution.height)) as writer:
        for i in gt_index:
            writer.write(nearest_frame(images[i], resolution))
    print(f"wrote {args.mp4_path}: {len(gt_index)} frames")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
