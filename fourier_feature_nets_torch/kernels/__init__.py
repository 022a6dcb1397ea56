"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch twin. Sources live in ``csrc/`` and build at first use
(:mod:`.build`); importing this package needs no CUDA."""

from .fused_nerf import (
    FusedNeRFWeights,
    fused_nerf_apply,
    fused_nerf_reference,
    prepare_fused_nerf,
)
from .fused_ray_render import (
    exclusive_cumprod_scan,
    fused_ray_render,
    fused_ray_render_reference,
)

__all__ = ["FusedNeRFWeights", "exclusive_cumprod_scan", "fused_nerf_apply",
           "fused_nerf_reference", "fused_ray_render",
           "fused_ray_render_reference", "prepare_fused_nerf"]
