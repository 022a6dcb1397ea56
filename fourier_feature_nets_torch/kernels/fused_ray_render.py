"""Fused ray render: the Hopper kernel (K3), its lane scan (T1) and twins.

The CUDA kernel (``csrc/fused_ray_render.cu``) replaces the TPU Pallas
kernel ``fourier_feature_nets_tpu/ops/fused_ray_render.py::_kernel``:
from ray geometry to composited color in one pass, with the view
features computed once per ray. The same library holds T1, the port of
the lane-scan test kernel of ``tests/test_fused_ray_render.py`` (around
``_exclusive_cumprod_lanes``): an exclusive cumprod with a ``float4`` a
lane, apart from K3's own scan. The source comment says what bounds
each on an H100.

* :func:`fused_ray_render_reference` is the plain PyTorch twin, with
  the kernel's rounding: K1's twin body per sample, the view product
  once per ray rounded to the working type, then emission-absorption
  compositing.
* :func:`fused_ray_render` launches the kernel for CUDA tensors and
  runs the twin for CPU tensors. A CUDA call launches the kernel or
  raises; it never falls back.
* :func:`exclusive_cumprod_scan` launches the scan kernel for CUDA
  tensors and runs :func:`..ops.blend.exclusive_cumprod` for CPU ones.

The weights are the pack of :func:`~.fused_nerf.prepare_fused_nerf`.
The JAX API rejects its double-angle pack; the port's pack has no
double-angle layout, so there is nothing to reject.
"""

import math

import torch
import torch.nn.functional as F

from ..ops.blend import calculate_blend_weights, exclusive_cumprod
from .fused_nerf import (
    _DTYPE_CODES,
    FusedNeRFWeights,
    _check_pack,
    _dense,
    _features,
    _trunk,
)
from .launch import INT, LONG, PTR, KernelLibrary, on_cuda

__all__ = ["exclusive_cumprod_scan", "fused_ray_render",
           "fused_ray_render_reference", "load_kernel", "rays_per_block"]

TILE = 64                  # kTile: points per tile of the forward
MAX_RAYS_PER_BLOCK = 32    # kMaxRaysPerBlock in csrc/fused_ray_render.cu
MAX_BLOCK_POINTS = 4096    # kMaxBlockPoints: 64 KB of logits per block
TARGET_BLOCK_POINTS = 1024


def rays_per_block(num_samples: int) -> int:
    """Rays each block of the kernel owns: the fewest whose samples
    fill whole 64-point tiles, within 32 rays and ~1024 points."""
    whole = TILE // math.gcd(num_samples, TILE)
    return max(1, min(whole, MAX_RAYS_PER_BLOCK,
                      TARGET_BLOCK_POINTS // num_samples))


def _per_ray_views(view_directions: torch.Tensor) -> torch.Tensor:
    """(R, 3), or the first sample's of (R, S, 3), as the JAX API."""
    if view_directions.dim() == 3:
        view_directions = view_directions[:, 0, :]
    return view_directions


def fused_ray_render_reference(weights: FusedNeRFWeights,
                               positions: torch.Tensor,
                               view_directions: torch.Tensor,
                               t_values: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of K3: (R, S, 3) positions, (R, 3) or
    (R, S, 3) views and (R, S) depths -> (R, 4) f32 [color | alpha].

    Rounds where the kernel rounds: the body as
    :func:`~.fused_nerf.fused_nerf_reference`, the view product
    ``venc . W_hidden[C:]`` once per ray and cast to the working type
    before it joins each sample's ``bottleneck . W_hidden[:C]`` and the
    bias. Alpha leaves out the absorbing tail sample."""
    dtype = weights.weights.dtype
    layers = weights.layers
    num_layers = weights.num_layers
    channels = weights.channels
    num_rays, num_samples = t_values.shape
    views = _per_ray_views(view_directions)
    opacity, bottleneck = _trunk(weights, positions.reshape(-1, 3))
    venc = _features(views.float(), weights.view_enc, weights.view_width,
                     weights.include_inputs, dtype)
    w_hidden, b_hidden = layers[num_layers + 2]
    view_term = (venc.float() @ w_hidden[channels:].float()).to(dtype).float()
    hidden = torch.relu(bottleneck.float() @ w_hidden[:channels].float()
                        + view_term.repeat_interleave(num_samples, 0)
                        + b_hidden).to(dtype)
    color = _dense(hidden, layers[num_layers + 3])[:, :3]
    logits = torch.cat([color, opacity], -1).reshape(num_rays, num_samples, 4)
    blend = calculate_blend_weights(t_values.float(), F.softplus(logits[..., 3]))
    rgb = torch.sum(blend[..., None] * torch.sigmoid(logits[..., :3]), dim=-2)
    alpha = torch.sum(blend[..., :-1], dim=-1, keepdim=True)
    return torch.cat([rgb, alpha], -1)


_LIB = KernelLibrary("fused_ray_render.cu", "fused_ray_render_error_string",
                     fused_ray_render=(PTR,) * 9 + (LONG, INT, INT, INT),
                     exclusive_cumprod_scan=(PTR, PTR, LONG, INT))


def load_kernel():
    """Builds (first call) and loads the K3/T1 library; returns the
    :class:`~.build.BuiltLibrary`."""
    return _LIB.load()


def _check_cuda_inputs(weights: FusedNeRFWeights, positions, views,
                       t_values):
    device = positions.device
    if t_values.dim() != 2:
        raise ValueError(f"t_values must be (R, S), got "
                         f"{tuple(t_values.shape)}")
    num_rays, num_samples = t_values.shape
    for name, tensor, shape, described in (
            ("positions", positions, (num_rays, num_samples, 3), "(R, S, 3)"),
            ("views", views, (num_rays, 3), "(R, 3)"),
            ("t_values", t_values, (num_rays, num_samples), "(R, S)")):
        if tensor.dtype != torch.float32 or tuple(tensor.shape) != shape \
                or not tensor.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {described} "
                             f"float32 tensor, got {tensor.dtype} "
                             f"{tuple(tensor.shape)}")
        if tensor.device != device:
            raise ValueError(f"{name} is on {tensor.device}, positions on "
                             f"{device}")
    if not 2 <= num_samples <= MAX_BLOCK_POINTS:
        raise ValueError(f"the kernel takes 2 to {MAX_BLOCK_POINTS} samples "
                         f"per ray, got {num_samples}")
    _check_pack(weights, device)


def fused_ray_render(weights: FusedNeRFWeights, positions: torch.Tensor,
                     view_directions: torch.Tensor,
                     t_values: torch.Tensor) -> torch.Tensor:
    """Renders rays in one fused pass: (R, S, 3) positions, (R, 3) or
    (R, S, 3) view directions (the first sample's is taken) and (R, S)
    depths -> (R, 4) f32 composited color and alpha. Inference only.

    CPU tensors run :func:`fused_ray_render_reference`. CUDA tensors
    launch the kernel on the current stream (building it on first use)
    or raise; each launch adds one to ``fused_ray_render.launches``.
    """
    if not on_cuda(positions, "fused ray render"):
        return fused_ray_render_reference(weights, positions,
                                          view_directions, t_values)
    views = _per_ray_views(view_directions).contiguous()
    _check_cuda_inputs(weights, positions, views, t_values)
    num_rays, num_samples = t_values.shape
    device = positions.device
    out = torch.empty((num_rays, 4), dtype=torch.float32, device=device)
    if num_rays == 0:
        return out
    _LIB.launch(fused_ray_render, "fused_ray_render", device,
                positions.data_ptr(), views.data_ptr(), t_values.data_ptr(),
                weights.pos_enc.data_ptr(), weights.view_enc.data_ptr(),
                weights.weights.data_ptr(), weights.biases.data_ptr(),
                weights.meta.ctypes.data, out.data_ptr(), num_rays,
                num_samples, rays_per_block(num_samples),
                _DTYPE_CODES[weights.weights.dtype])
    return out


fused_ray_render.launches = 0


def exclusive_cumprod_scan(x: torch.Tensor) -> torch.Tensor:
    """Exclusive cumulative product along the lanes of a (rows, lanes)
    f32 tensor (first lane 1): T1, a warp a row, four values a lane.

    CPU tensors run :func:`..ops.blend.exclusive_cumprod`. CUDA tensors
    launch the scan kernel or raise; each launch adds one to
    ``exclusive_cumprod_scan.launches``."""
    if not on_cuda(x, "exclusive cumprod"):
        return exclusive_cumprod(x)
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] < 1 \
            or not x.is_contiguous():
        raise ValueError(f"the scan takes a contiguous (rows, lanes) float32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    rows, lanes = x.shape
    out = torch.empty_like(x)
    if rows == 0:
        return out
    _LIB.launch(exclusive_cumprod_scan, "exclusive_cumprod_scan", x.device,
                x.data_ptr(), out.data_ptr(), rows, lanes)
    return out


exclusive_cumprod_scan.launches = 0
