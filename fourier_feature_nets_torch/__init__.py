"""PyTorch port of ``fourier_feature_nets_tpu`` for NVIDIA Hopper GPUs.

The JAX package beside this one is the reference. The port imports
``torch`` and NumPy and never ``jax``; importing it needs no CUDA. Its
kernels (:mod:`.kernels`) are hand-written CUDA built at first use.

The package exports the JAX package's names and its own
``flagship_nerf`` and ``OccupancyGridSampler``. ``FFN_TORCH_DEBUG_NANS``
is read at import (:mod:`.utils.debug`).
"""

from . import ops
from .cameras import CameraInfo, Ray, Resolution
from .datasets import (
    ImageDataset,
    Mode,
    PixelDataset,
    RayDataset,
    SignalDataset,
)
from .datasets.synthetic import generate_synthetic_dataset
from .models import (
    MLP,
    BasicFourierMLP,
    FourierFeatureMLP,
    GaussianFourierMLP,
    NeRF,
    PositionalFourierMLP,
    Voxels,
    flagship_nerf,
    load_model,
    save_model,
)
from .octree import OcTree
from .ops import calculate_blend_weights, interpolate_bilinear
from .render import (
    OccupancyGridSampler,
    Raycaster,
    RaySampler,
    RaySamples,
    RenderResult,
)
from .utils import ETABar, download_asset, hemisphere, orbit
from .utils.debug import init_from_env as _init_debug_from_env
from .utils.optim import exponential_lr
from .utils.optim import exponential_lr as exponential_lr_decay
from .visualizers import (
    ActivationVisualizer,
    ComparisonVisualizer,
    EvaluationVisualizer,
    OrbitVideoVisualizer,
    Visualizer,
)

_init_debug_from_env()

__all__ = [
    "ops",
    "CameraInfo",
    "Ray",
    "Resolution",
    "ImageDataset",
    "Mode",
    "PixelDataset",
    "RayDataset",
    "RenderResult",
    "SignalDataset",
    "generate_synthetic_dataset",
    "OccupancyGridSampler",
    "Raycaster",
    "RaySampler",
    "RaySamples",
    "ETABar",
    "download_asset",
    "exponential_lr",
    "exponential_lr_decay",
    "hemisphere",
    "orbit",
    "OcTree",
    "Visualizer",
    "ActivationVisualizer",
    "ComparisonVisualizer",
    "EvaluationVisualizer",
    "OrbitVideoVisualizer",
    "BasicFourierMLP",
    "FourierFeatureMLP",
    "GaussianFourierMLP",
    "MLP",
    "NeRF",
    "PositionalFourierMLP",
    "Voxels",
    "flagship_nerf",
    "load_model",
    "save_model",
    "calculate_blend_weights",
    "interpolate_bilinear",
]
