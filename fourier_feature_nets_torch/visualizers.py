"""Training-loop visualization hooks.

Port of ``Visualizer`` and ``EvaluationVisualizer`` from
``fourier_feature_nets_tpu/visualizers.py``: a visualizer receives a
``render(samples, include_depth)`` callable that runs the current model
through the chunked renderer, so it never touches model state. Images
are written by the port's standard-library PNG writer. The orbit,
activation and comparison visualizers are not ported yet (ROADMAP.md,
queue 1, item 7).
"""

import os
from abc import ABC, abstractmethod
from typing import Callable

import numpy as np

from .datasets.image_dataset import ImageDataset
from .render.ray_sampler import RaySampler, RaySamples
from .render.raycaster import RenderResult
from .utils.png import write_png

__all__ = ["Visualizer", "EvaluationVisualizer"]

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
