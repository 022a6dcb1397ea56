"""Lecture animations: cameras, rays and the rendering equation.

Port of ``fourier_feature_nets_tpu/lecture/animations.py``. Each
function writes a PNG frame sequence and an MP4 of it, built from the
port's geometry ops: frames through the port's PNG writer and its
Motion-JPEG MP4 writer (:mod:`..utils.video`), where the JAX package
uses OpenCV (its MP4 frames are MPEG-4 Part 2). The matplotlib
animations raise ``ModuleNotFoundError`` naming matplotlib without it.
``view_angle_animation`` needs no matplotlib: it renders the source
pixel's depth through the port's raycaster (K1 where it is fused) and
draws its nearest-neighbour zoom, rectangles and lines in NumPy, where
the JAX function calls ``cv2.resize``, ``cv2.rectangle`` and
``cv2.line``.
"""

import os

import numpy as np
import torch

from ..cameras import Resolution
from ..ops import bounds_min_max, calculate_blend_weights, ray_aabb_near_far
from ..utils.camera_paths import orbit
from ..utils.png import write_png
from ..utils.video import VideoWriter
from .figures import _agg_plt

__all__ = ["camera_to_world_animation", "world_to_camera_animation",
           "ray_cube_intersection_animation",
           "rendering_equation_animation", "volume_raycasting_animation",
           "voxels_animation", "view_angle_animation",
           "save_all_animations"]


class _FrameSink:
    """Writes frames to ``<output_dir>/<name>/frame_NNNN.png`` and to
    ``<output_dir>/<name>.mp4``, the video sized by its first frame."""

    def __init__(self, output_dir, name, framerate=10):
        self.frame_dir = os.path.join(output_dir, name)
        os.makedirs(self.frame_dir, exist_ok=True)
        self.video_path = os.path.join(output_dir, f"{name}.mp4")
        self.framerate = framerate
        self.writer = None
        self.count = 0

    def write(self, pixels: np.ndarray) -> None:
        pixels = np.ascontiguousarray(pixels)
        write_png(os.path.join(self.frame_dir, f"frame_{self.count:04d}.png"),
                  pixels)
        if self.writer is None:
            self.writer = VideoWriter(self.video_path, self.framerate,
                                      (pixels.shape[1], pixels.shape[0]))
        self.writer.write(pixels)
        self.count += 1

    def close(self) -> None:
        if self.writer is not None:
            self.writer.release()


def _save_frames(fig_fn, num_frames, output_dir, name, framerate=10):
    """Renders each figure's canvas to a PNG and the MP4."""
    plt = _agg_plt()
    sink = _FrameSink(output_dir, name, framerate)
    try:
        for i in range(num_frames):
            fig = fig_fn(i)
            fig.canvas.draw()
            pixels = np.asarray(fig.canvas.buffer_rgba())[..., :3]
            plt.close(fig)
            sink.write(pixels)
    finally:
        sink.close()


def _cube_edges(lo, hi):
    corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                        for y in (lo[1], hi[1])
                        for z in (lo[2], hi[2])])
    edges = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
             (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]
    return corners, edges


def _draw_cube(ax, lo, hi, color="tab:blue", alpha=0.6):
    corners, edges = _cube_edges(lo, hi)
    for a, b in edges:
        ax.plot(*zip(corners[a], corners[b]), color=color, alpha=alpha)


def camera_to_world_animation(output_dir, num_frames=60):
    """A camera orbits the scene; its frustum and axes shown in world
    coordinates."""
    plt = _agg_plt()
    cameras = orbit(np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0]),
                    num_frames, 40, Resolution(64, 64), 3.0)

    def frame(i):
        camera = cameras[i]
        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(projection="3d")
        _draw_cube(ax, [-1, -1, -1], [1, 1, 1])
        pos = camera.position[0]
        for axis, color in zip(camera.extrinsics[:3, :3].T,
                               ("r", "g", "b")):
            ax.quiver(*pos, *axis, length=0.6, color=color)
        corners = camera.raycast(np.array(
            [[0, 0], [63, 0], [63, 63], [0, 63]], np.float32))
        for origin, direction in zip(corners.origin, corners.direction):
            end = origin + direction * 1.5
            ax.plot(*zip(origin, end), "k-", alpha=0.4)
        ax.set_xlim(-3, 3)
        ax.set_ylim(-3, 3)
        ax.set_zlim(-3, 3)
        ax.set_title("camera-to-world: frustum in world space")
        return fig

    _save_frames(frame, num_frames, output_dir, "camera_to_world")


def world_to_camera_animation(output_dir, num_frames=60):
    """World points projected into a moving camera's image plane."""
    plt = _agg_plt()
    cameras = orbit(np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0]),
                    num_frames, 40, Resolution(256, 256), 3.0)
    rng = np.random.default_rng(0)
    points = rng.uniform(-0.8, 0.8, (128, 3)).astype(np.float32)
    colors = (points + 1) / 2

    def frame(i):
        camera = cameras[i]
        projected = camera.project(points)
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.scatter(projected[:, 0], projected[:, 1], c=colors, s=12)
        ax.set_xlim(0, 256)
        ax.set_ylim(256, 0)
        ax.set_title("world-to-camera: projected points")
        return fig

    _save_frames(frame, num_frames, output_dir, "world_to_camera")


def ray_cube_intersection_animation(output_dir, num_frames=60):
    """The slab method: a rotating ray against the unit cube with its
    near/far planes."""
    plt = _agg_plt()
    bounds = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
    lo, hi = bounds_min_max(bounds)

    def frame(i):
        angle = 2 * np.pi * i / num_frames
        start = np.array([2.5 * np.cos(angle), 0.6,
                          2.5 * np.sin(angle)], np.float32)
        direction = -start / np.linalg.norm(start)
        direction += np.array([0.3 * np.sin(3 * angle), 0.2, 0],
                              np.float32)
        direction /= np.linalg.norm(direction)
        nf = ray_aabb_near_far(torch.from_numpy(start[None]),
                               torch.from_numpy(direction[None]),
                               torch.from_numpy(lo), torch.from_numpy(hi))
        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(projection="3d")
        _draw_cube(ax, lo, hi)
        end = start + direction * 6
        ax.plot(*zip(start, end), "k-", alpha=0.5)
        if bool(nf.valid[0]):
            p0 = start + float(nf.near[0]) * direction
            p1 = start + float(nf.far[0]) * direction
            ax.plot(*zip(p0, p1), "r-", linewidth=3)
            ax.scatter(*p0, color="g", s=40)
            ax.scatter(*p1, color="m", s=40)
        ax.set_xlim(-3, 3)
        ax.set_ylim(-3, 3)
        ax.set_zlim(-3, 3)
        ax.set_title("ray/AABB slab intersection")
        return fig

    _save_frames(frame, num_frames, output_dir, "ray_cube_intersection")


def rendering_equation_animation(output_dir, num_frames=50):
    """The emission-absorption integral along one ray: opacity, alpha,
    transmittance and blend weights as opacity grows."""
    plt = _agg_plt()
    t = np.linspace(1.0, 3.0, 64, dtype=np.float32)
    base = np.exp(-0.5 * ((t - 2.0) / 0.15) ** 2)

    def frame(i):
        scale = 12.0 * (i + 1) / num_frames
        opacity = scale * base
        weights = calculate_blend_weights(
            torch.from_numpy(t[None]),
            torch.from_numpy(opacity[None].astype(np.float32)))[0].numpy()
        trans = np.concatenate([[1.0], 1 - np.cumsum(weights)[:-1]])
        fig, axes = plt.subplots(3, 1, figsize=(6, 7), sharex=True)
        axes[0].plot(t, opacity)
        axes[0].set_ylabel("sigma(t)")
        axes[0].set_ylim(0, 13)
        axes[1].plot(t, trans)
        axes[1].set_ylabel("transmittance")
        axes[1].set_ylim(0, 1.05)
        axes[2].plot(t, weights)
        axes[2].set_ylabel("blend weight")
        axes[2].set_xlabel("t")
        axes[2].set_ylim(0, 0.4)
        fig.suptitle("the rendering equation along a ray")
        return fig

    _save_frames(frame, num_frames, output_dir, "rendering_equation")


def volume_raycasting_animation(output_dir, num_frames=40, resolution=96,
                                device="cuda"):
    """Volume raycasting of the synthetic scene from an orbiting camera,
    rendered by the port's ray marcher on ``device``."""
    plt = _agg_plt()
    from ..datasets.synthetic import make_scene_volume, render_dataset_images

    volume = make_scene_volume(48)
    bounds = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
    cameras = orbit(np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0]),
                    num_frames, 40, Resolution(resolution, resolution),
                    3.0)
    images = render_dataset_images(volume, cameras, bounds,
                                   num_samples=128, device=device)

    def frame(i):
        fig, ax = plt.subplots(figsize=(5, 5))
        ax.imshow(images[i][..., :3])
        ax.set_axis_off()
        ax.set_title(f"volume raycasting (frame {i})")
        return fig

    _save_frames(frame, num_frames, output_dir, "volume_raycasting")


def voxels_animation(voxels, output_dir, min_depth=4, num_frames=60):
    """A model increasing in voxel resolution: the octree is pruned from
    its full depth down to ``min_depth``; an orbiting view shows each
    level's leaf voxels (coloured by leaf data) with a voxel-count
    label, sweeping from coarse to fine over the animation.

    Args:
        voxels: an :class:`~..octree.OcTree` at maximum resolution (it
            is pruned level by level).
        output_dir: directory for the PNG frames + MP4.
        min_depth: coarsest level in the sweep.
        num_frames: frames in the orbit.
    """
    plt = _agg_plt()
    max_depth = voxels.depth
    levels = {}
    while voxels.depth >= min_depth:
        colors = voxels.leaf_data()
        if colors is None:
            colors = np.full((voxels.num_leaves, 3), 0.5, np.float32)
        levels[voxels.depth] = (voxels.leaf_centers(),
                                voxels.leaf_depths(),
                                np.clip(colors[:, :3], 0.0, 1.0),
                                voxels.scale)
        if voxels.depth == min_depth:
            break
        voxels = voxels.prune()

    frame_depth = np.linspace(min_depth, max_depth + 1, num_frames,
                              endpoint=False).astype(np.int32)

    def frame(i):
        centers, depths, colors, scale = levels[int(frame_depth[i])]
        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(projection="3d")
        # marker area tracks the world-space voxel edge length
        sizes = (2.0 ** (1 - depths.astype(np.float32)) * scale
                 / (2 * scale) * 72) ** 2
        ax.scatter(centers[:, 0], centers[:, 1], centers[:, 2],
                   c=colors, s=sizes, marker="s", depthshade=False)
        ax.view_init(elev=20, azim=360.0 * i / num_frames)
        lim = scale
        ax.set_xlim(-lim, lim)
        ax.set_ylim(-lim, lim)
        ax.set_zlim(-lim, lim)
        ax.set_axis_off()
        ax.set_title(f"{len(centers)} voxels")
        return fig

    _save_frames(frame, num_frames, output_dir, "voxels")


def resize_nearest(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(..., interpolation=cv2.INTER_NEAREST)``: output
    pixel ``d`` reads source ``floor(d * src / dst)``."""
    rows = np.minimum((np.arange(height) * (image.shape[0] / height))
                      .astype(np.int64), image.shape[0] - 1)
    cols = np.minimum((np.arange(width) * (image.shape[1] / width))
                      .astype(np.int64), image.shape[1] - 1)
    return image[rows][:, cols]


def draw_segment(frame: np.ndarray, start, end, color,
                 thickness: int = 2) -> None:
    """Sets, in place, every pixel whose centre lies within
    ``thickness / 2`` of the segment from ``start`` to ``end`` ((x, y)
    pixel coordinates): a line of that thickness with round ends."""
    (x0, y0), (x1, y1) = start, end
    radius = thickness / 2
    lo_x = max(int(np.floor(min(x0, x1) - radius)), 0)
    hi_x = min(int(np.ceil(max(x0, x1) + radius)), frame.shape[1] - 1)
    lo_y = max(int(np.floor(min(y0, y1) - radius)), 0)
    hi_y = min(int(np.ceil(max(y0, y1) + radius)), frame.shape[0] - 1)
    if lo_x > hi_x or lo_y > hi_y:
        return
    yy, xx = np.mgrid[lo_y:hi_y + 1, lo_x:hi_x + 1].astype(np.float64)
    dx, dy = x1 - x0, y1 - y0
    length = dx * dx + dy * dy
    t = (np.clip(((xx - x0) * dx + (yy - y0) * dy) / length, 0.0, 1.0)
         if length else np.zeros_like(xx))
    near = np.hypot(xx - (x0 + t * dx), yy - (y0 + t * dy)) <= radius
    frame[lo_y:hi_y + 1, lo_x:hi_x + 1][near] = color


def draw_rectangle(frame: np.ndarray, corner0, corner1, color,
                   thickness: int = 2) -> None:
    """The outline of the axis-aligned rectangle between two (x, y)
    corners, as four segments of ``thickness``."""
    (x0, y0), (x1, y1) = corner0, corner1
    for start, end in (((x0, y0), (x1, y0)), ((x1, y0), (x1, y1)),
                       ((x1, y1), (x0, y1)), ((x0, y1), (x0, y0))):
        draw_segment(frame, start, end, color, thickness)


def view_angle_animation(dataset, raycaster, output_dir, camera=1, row=None,
                         col=None, angle_threshold=0.5, patch_size=32,
                         zoom_size=128):
    """How one surface point looks from different viewing angles: a
    pixel in a source camera is lifted to 3D with the model's rendered
    depth (``raycaster.render``: K1 where it is fused), then every
    camera within ``angle_threshold`` (cosine) of the source view whose
    image holds the whole reprojected patch gets a frame: its image,
    the patch outlined, and a nearest-neighbour inset of the patch
    joined to it by two lines.

    Args:
        dataset: an ImageDataset (images + cameras + ray sampler).
        raycaster: the model's :class:`~..render.Raycaster`.
        output_dir: directory for the PNG frames + MP4.
        camera: source camera index.
        row / col: source pixel (defaults to the image centre).
        angle_threshold: minimum cosine between camera positions.
        patch_size / zoom_size: reprojected patch + inset sizes.

    Returns:
        The number of frames written.
    """
    sampler = dataset.sampler
    width = sampler.image_width
    height = sampler.image_height
    if row is None:
        row = height // 2
    if col is None:
        col = width // 2

    # lift the source pixel to 3D with the model's depth
    index = camera * sampler.rays_per_camera + row * width + col
    rays = sampler.sample(torch.tensor([index], device=sampler.device),
                          None, None)
    render = raycaster.render(rays, include_depth=True)
    start = sampler.ray_tables.starts[index].cpu().numpy()
    direction = sampler.ray_tables.directions[index].cpu().numpy()
    position = start + direction * float(render.depth[0])

    def _rgb(image):
        image = image.astype(np.float32) / 255
        if image.shape[-1] == 4:
            image = image[..., :3] * image[..., 3:]
        return (image * 255).astype(np.uint8)

    source_pos = dataset.cameras[camera].position.reshape(-1)
    source_pos = source_pos / np.linalg.norm(source_pos)

    sink = _FrameSink(output_dir, "view_angle")
    half = patch_size // 2
    # the inset must fit the frame
    zoom_size = min(zoom_size, height, width)
    zoom_row = (height - zoom_size) // 2
    zoom_col = width + (width - zoom_size) // 2
    white = (255, 255, 255)
    try:
        for cam, image in zip(dataset.cameras, dataset.images):
            pos = cam.position.reshape(-1)
            angle = float((source_pos * pos / np.linalg.norm(pos)).sum())
            if angle < angle_threshold:
                continue

            u, v = cam.project(position[np.newaxis])[0]
            c, r = int(u) - half, int(v) - half
            if not (0 <= r <= height - patch_size
                    and 0 <= c <= width - patch_size):
                continue
            image = _rgb(image)
            patch = resize_nearest(image[r:r + patch_size, c:c + patch_size],
                                   zoom_size, zoom_size)

            frame = np.zeros((height, 2 * width, 3), np.uint8)
            frame[:, :width] = image
            frame[zoom_row:zoom_row + zoom_size,
                  zoom_col:zoom_col + zoom_size] = patch
            draw_rectangle(frame, (c, r), (c + patch_size, r + patch_size),
                           white)
            draw_rectangle(frame, (zoom_col, zoom_row),
                           (zoom_col + zoom_size, zoom_row + zoom_size),
                           white)
            draw_segment(frame, (c + patch_size, r), (zoom_col, zoom_row),
                         white)
            draw_segment(frame, (c + patch_size, r + patch_size),
                         (zoom_col, zoom_row + zoom_size), white)
            sink.write(frame)
    finally:
        sink.close()
    return sink.count


def save_all_animations(output_dir: str, num_frames: int = 40,
                        device="cuda"):
    """Renders every lecture animation that needs no trained model (the
    volume raycasting on ``device``).

    ``voxels_animation`` and ``view_angle_animation`` take an octree /
    trained model respectively and are invoked separately.
    """
    camera_to_world_animation(output_dir, num_frames)
    world_to_camera_animation(output_dir, num_frames)
    ray_cube_intersection_animation(output_dir, num_frames)
    rendering_equation_animation(output_dir, num_frames)
    volume_raycasting_animation(output_dir, num_frames, device=device)
