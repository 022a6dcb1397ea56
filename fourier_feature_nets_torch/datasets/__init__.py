"""Ray datasets of the training path."""

from .image_dataset import ImageDataset, ellipse_stencil
from .ray_dataset import Mode, RayDataset

__all__ = ["ImageDataset", "Mode", "RayDataset", "ellipse_stencil"]
