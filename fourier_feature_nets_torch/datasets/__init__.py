"""Ray datasets of the training path."""

from .image_dataset import ImageDataset, ellipse_stencil
from .pixel_dataset import PixelData, PixelDataset
from .ray_dataset import Mode, RayDataset
from .signal_dataset import SignalData, SignalDataset

__all__ = ["ImageDataset", "Mode", "PixelData", "PixelDataset", "RayDataset",
           "SignalData", "SignalDataset", "ellipse_stencil"]
