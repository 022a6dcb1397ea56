"""Ray dataset protocol.

Port of ``fourier_feature_nets_tpu/datasets/ray_dataset.py``: sampling
modes are host-side int64 index pools of global ray ids, and ``loss`` /
``render`` are tensor functions of a batch of ray ids on the dataset's
device. ``RenderResult`` lives in :mod:`..render.raycaster`.
"""

import enum
from abc import ABC, abstractmethod
from typing import List, Optional

import numpy as np
import torch

from ..cameras import CameraInfo
from ..render.ray_sampler import RaySamples
from ..render.raycaster import RenderResult
from ..utils.errors import not_ported

__all__ = ["Mode", "RayDataset"]


class Mode(enum.Enum):
    """Sampling mode of a dataset."""

    Full = 0
    Sparse = 1
    Center = 2
    Dilate = 3
    Patch = 4


class RayDataset(ABC):
    """Contract for datasets that produce rays for volume rendering."""

    Mode = Mode

    @property
    @abstractmethod
    def num_cameras(self) -> int:
        """Number of cameras in the dataset."""

    @property
    @abstractmethod
    def num_samples(self) -> int:
        """Samples per ray."""

    @property
    @abstractmethod
    def color_space(self) -> str:
        """Color space used by the dataset."""

    @property
    @abstractmethod
    def label(self) -> str:
        """Human-readable dataset label."""

    @property
    @abstractmethod
    def cameras(self) -> List[CameraInfo]:
        """Camera calibration list."""

    @property
    @abstractmethod
    def mode(self) -> Mode:
        """Active sampling mode."""

    @mode.setter
    @abstractmethod
    def mode(self, value: Mode):
        """Sets the sampling mode."""

    @abstractmethod
    def index_pool(self, mode: Optional[Mode] = None) -> np.ndarray:
        """Global *valid* ray ids available under the given mode."""

    @abstractmethod
    def render(self, rays: torch.Tensor) -> RenderResult:
        """Ground-truth colors for global ray ids."""

    @abstractmethod
    def loss(self, rays: torch.Tensor,
             render: RenderResult) -> torch.Tensor:
        """Training loss of a prediction against ground truth."""

    @abstractmethod
    def index_for_camera(self, camera: int) -> np.ndarray:
        """Valid per-camera pixel indices under the active mode."""

    @abstractmethod
    def rays_for_camera(self, camera: int) -> RaySamples:
        """Ray samples for one camera under the active mode."""

    @abstractmethod
    def to_valid(self, idx) -> np.ndarray:
        """Filters global ray ids to those hitting the volume."""

    @abstractmethod
    def __len__(self) -> int:
        """Number of rays under the active mode."""

    @abstractmethod
    def subset(self, cameras: List[int], num_samples: int,
               stratified: bool, label: str) -> "RayDataset":
        """Creates a camera-subset dataset."""

    def to_image(self, camera: int, colors: np.ndarray) -> np.ndarray:
        """Scatters mode-aware ray colors into an (H, W, 3) uint8
        image."""
        if self.color_space != "RGB":
            raise not_ported(f"color space {self.color_space!r}",
                             "Remaining models, data, CLIs and parallel")
        colors = np.asarray(colors)
        if colors.ndim == 1:
            colors = colors[..., np.newaxis]
        resolution = self.cameras[camera].resolution
        pixels = np.zeros((resolution.width * resolution.height, 3),
                          np.float32)
        pixels[self.index_for_camera(camera)] = colors
        pixels = pixels.reshape(resolution.height, resolution.width, 3)
        return (pixels * 255).astype(np.uint8)

    def sample_cameras(self, num_cameras: int, num_samples: int,
                       stratified: bool) -> "RayDataset":
        """Selects a farthest-point camera subset."""
        if self.num_cameras < num_cameras:
            samples = list(range(self.num_cameras))
        else:
            positions = np.concatenate([cam.position
                                        for cam in self.cameras])
            chosen = {0}
            while len(chosen) < num_cameras:
                sample_positions = positions[sorted(chosen)]
                distances = positions[:, None, :] - sample_positions[None]
                distances = np.square(distances).sum(-1).min(-1)
                unchosen = np.array(sorted(
                    set(range(len(positions))) - chosen))
                chosen.add(int(unchosen[distances[unchosen].argmax()]))
            samples = sorted(chosen)
        return self.subset(samples, num_samples, stratified, self.label)
