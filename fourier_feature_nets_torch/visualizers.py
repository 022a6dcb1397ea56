"""Training-loop visualization hooks.

Port of ``Visualizer``, ``EvaluationVisualizer`` and
``ActivationVisualizer`` (with its orbit rig) from
``fourier_feature_nets_tpu/visualizers.py``: a visualizer receives a
``render(samples, include_depth)`` callable that runs the current model
through the chunked renderer, and an ``act_render(sampler, camera)``
callable that renders the activation grid
(``Raycaster.render_activations``), so it never touches model state.
Images are written by the port's standard-library PNG writer. The orbit
and comparison visualizers are not ported yet (ROADMAP.md, queue 1,
item 7).
"""

import os
from abc import ABC, abstractmethod
from typing import Callable

import numpy as np

from .cameras import Resolution
from .datasets.image_dataset import ImageDataset
from .render.ray_sampler import RaySampler, RaySamples
from .render.raycaster import RenderResult
from .utils.camera_paths import orbit
from .utils.png import write_png

__all__ = ["Visualizer", "EvaluationVisualizer", "ActivationVisualizer"]

ImageRender = Callable[[RaySamples, bool], RenderResult]
ActivationRender = Callable[[RaySampler, int], np.ndarray]


class Visualizer(ABC):
    """Hook into the training process producing artifacts."""

    @abstractmethod
    def visualize(self, step: int, render: ImageRender,
                  act_render: ActivationRender):
        """Creates a visualization with the provided render functions."""

    def _due(self, step: int) -> bool:
        """True when ``step`` enters a new ``self._interval`` window
        (at one step per call: ``step % interval == 0``)."""
        prev = getattr(self, "_prev_step", None)
        self._prev_step = step
        if prev is None:
            return step % self._interval == 0
        return step // self._interval > prev // self._interval


class EvaluationVisualizer(Visualizer):
    """2x2 grids of prediction / ground truth / depth / error."""

    def __init__(self, results_dir: str, dataset: ImageDataset,
                 interval: int, max_depth: float = 10):
        path = os.path.join(results_dir, dataset.label)
        os.makedirs(path, exist_ok=True)
        self._output_dir = path
        self._dataset = dataset
        self._interval = interval
        self._index = 0
        self._max_depth = max_depth

    def visualize(self, step: int, render: ImageRender,
                  _: ActivationRender):
        """Writes one evaluation grid if the step is on the interval."""
        if not self._due(step):
            return

        camera = self._index % self._dataset.num_cameras
        samples = self._dataset.rays_for_camera(camera)
        act = self._dataset.render(samples.rays)
        act_color = act.color.cpu().numpy()
        act_alpha = None if act.alpha is None else act.alpha.cpu().numpy()
        pred = render(samples, True)

        error = np.square(act_color - pred.color).sum(-1)
        if act_alpha is not None:
            error = (3 * error + np.square(act_alpha - pred.alpha)) / 4

        width, height = self._dataset.cameras[camera].resolution
        predicted_image = self._dataset.to_image(
            camera, np.clip(pred.color, 0, 1))
        if act_alpha is not None:
            gt_color = act_color * act_alpha[..., np.newaxis]
        else:
            gt_color = act_color
        actual_image = self._dataset.to_image(camera, gt_color)
        depth = np.clip(pred.depth, 0, self._max_depth) / self._max_depth
        depth_image = self._dataset.to_image(camera, depth)
        error = np.sqrt(error)
        error_image = self._dataset.to_image(
            camera, error / max(error.max(), 1e-8))

        compare = np.zeros((height * 2, width * 2, 3), np.uint8)
        compare[:height, :width] = predicted_image
        compare[height:, :width] = actual_image
        compare[:height, width:] = depth_image
        compare[height:, width:] = error_image

        name = "s{:07}_c{:03}.png".format(step, camera)
        write_png(os.path.join(self._output_dir, name), compare)
        self._index += 1


class _OrbitRigVisualizer(Visualizer):
    """The orbit visualizers' set-up: an orbit rig of its own (distance
    4, fov 40, bounds 2 I, the reference's construction) on ``device``,
    one frame an interval of ``num_steps // num_frames`` steps."""

    def __init__(self, results_dir: str, subdir: str, num_steps: int,
                 resolution: Resolution, num_frames: int,
                 num_samples: int, color_space: str, device="cpu"):
        out_dir = os.path.join(results_dir, subdir)
        os.makedirs(out_dir, exist_ok=True)
        self._output_dir = out_dir
        cameras = orbit(np.array([0.0, 1.0, 0.0]),
                        np.array([0.0, 0.0, -1.0]), num_frames, 40,
                        Resolution(*resolution).square(), 4)
        bounds = np.eye(4, dtype=np.float32) * 2
        self._sampler = RaySampler(bounds, cameras, num_samples, device)
        self._interval = max(1, num_steps // num_frames)
        self._index = 0
        self._color_space = color_space


class ActivationVisualizer(_OrbitRigVisualizer):
    """An orbit video of the last hidden layer's activation grid, one
    frame (``activations/frame_NNNNN.png``) an interval."""

    def __init__(self, results_dir: str, num_steps: int,
                 resolution: Resolution, num_frames: int,
                 num_samples: int, color_space: str, device="cpu"):
        super().__init__(results_dir, "activations", num_steps,
                         resolution, num_frames, num_samples,
                         color_space, device)

    def visualize(self, step: int, _: ImageRender,
                  act_render: ActivationRender):
        """Writes one activation-grid frame if the step is on the
        interval."""
        if not self._due(step):
            return
        image = act_render(self._sampler, self._index)
        name = "frame_{:05d}.png".format(self._index)
        write_png(os.path.join(self._output_dir, name), image)
        self._index += 1
