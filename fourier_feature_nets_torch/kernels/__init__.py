"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch twin. Sources live in ``csrc/`` and build at first use
(:mod:`.build`); importing this package needs no CUDA."""

from .fused_nerf import (
    FusedNeRFWeights,
    fused_nerf_apply,
    fused_nerf_reference,
    prepare_fused_nerf,
)

__all__ = ["FusedNeRFWeights", "fused_nerf_apply", "fused_nerf_reference",
           "prepare_fused_nerf"]
