"""Ray datasets of the training path, and the synthetic scene."""

from ..render.raycaster import RenderResult
from .image_dataset import ImageDataset, ellipse_stencil
from .pixel_dataset import PixelData, PixelDataset
from .ray_dataset import Mode, RayDataset
from .signal_dataset import SignalData, SignalDataset
from .synthetic import generate_synthetic_dataset, load_or_generate

__all__ = ["ImageDataset", "Mode", "PixelData", "PixelDataset", "RayDataset",
           "RenderResult", "SignalData", "SignalDataset", "ellipse_stencil",
           "generate_synthetic_dataset", "load_or_generate"]
