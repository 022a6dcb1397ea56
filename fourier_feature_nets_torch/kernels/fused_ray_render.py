"""Fused ray render: the Hopper kernel (K3), its lane scan (T1) and twins.

The CUDA kernel (``csrc/fused_ray_render.cu``) replaces the TPU Pallas
kernel ``fourier_feature_nets_tpu/ops/fused_ray_render.py::_kernel``:
from ray geometry to composited color in one pass, with the view
product computed once per ray. It is K1's own kernels
(``csrc/fused_nerf_forward.cuh``) with a per-ray view product and a
compositing epilogue, each consumer warpgroup taking a group of whole
rays (:func:`ray_group`). The same library holds T1, the port of the
lane-scan test kernel of ``tests/test_fused_ray_render.py`` (around
``_exclusive_cumprod_lanes``): an exclusive cumprod with a ``float4`` a
lane, apart from K3's own scan. The source comment says what bounds
each on an H100.

* :func:`fused_ray_render_reference` is the plain PyTorch twin, with
  the kernel's rounding: K1's twin body per sample, the view product
  once per ray rounded to the working type, then emission-absorption
  compositing; ``moved="unrounded-view"`` leaves the view product
  unrounded, the control that K3's bf16 limits must reject.
* :func:`fused_ray_render` launches the kernel for CUDA tensors and
  runs the twin for CPU tensors. A CUDA call launches the kernel or
  raises; it never falls back.
* :func:`exclusive_cumprod_scan` launches the scan kernel for CUDA
  tensors and runs :func:`..ops.blend.exclusive_cumprod` for CPU ones.

The weights are the pack of :func:`~.fused_nerf.prepare_fused_nerf`.
The JAX API rejects its double-angle pack; the port's pack has no
double-angle layout, so there is nothing to reject.

K3's limits against its twin, which the card tests and ``chip_smoke.py``
hold, are K1's (``chip_smoke.py``, K1_BF16_ATOL and K1_F32_MEAN_ATOL):

* bf16: max |d| <= :data:`K3_BF16_ATOL` and, from :data:`MEAN_RAYS`
  rays on, mean |d| <= :data:`K3_BF16_MEAN_ATOL`, a mean that the twin
  with its view product unrounded must fail;
* f32: the JAX suite's rtol 1e-3 / atol 2e-4 and, from MEAN_RAYS rays
  on, mean |d| <= :data:`K3_F32_MEAN_ATOL`, which the twin on single
  tf32 products must fail.

Readings from ``chip_smoke.py`` on an H100 80GB HBM3 at 700 W, at the
flagship and a 2x32 model, R = 1001 at S = 2 to 128 and R = 16384 at
S = 48 and 128, and R = 9 at S = 4096: bf16 max 3.0e-6 to 6.2e-5 and
mean 3.3e-8 to 2.2e-7 against the twin, the unrounded twin mean 1.28e-5
(2.6x above the limit); f32 max up to 7.2e-7 and, from 1001 rays, mean
8.4e-9 to 4.3e-8, the single-tf32 twin mean 1.58e-6 (1.6x above the
limit, 37x above the kernel).
"""

import functools
import math
from typing import Optional

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

__all__ = ["K3_BF16_ATOL", "K3_BF16_MEAN_ATOL", "K3_F32_MEAN_ATOL",
           "MEAN_RAYS", "RAY_MOVED_ROUNDINGS", "exclusive_cumprod_scan",
           "fused_ray_render", "fused_ray_render_reference",
           "launch_ray_group", "load_kernel", "ray_group"]

GROUP_ROWS = 64            # kWgRows: the rows of a piece of a ray group
MAX_GROUP_RAYS = 32        # kMaxGroupRays in csrc/fused_ray_render.cu
MAX_GROUP_POINTS = 2048    # a group's rows, unless one ray is longer
MAX_SAMPLES = 4096         # kMaxSamples
K3_BF16_ATOL = 4e-3        # K1's
K3_BF16_MEAN_ATOL = 5e-6
K3_F32_MEAN_ATOL = 1e-6
MEAN_RAYS = 1000           # the mean limits hold from this many rays on
# The twin with one rounding point moved (``fused_ray_render_reference(
# moved=...)``): the view product left in f32, K1's rounding point.
RAY_MOVED_ROUNDINGS = ("unrounded-view",)


def ray_group(num_samples: int, num_rays: Optional[int] = None,
              sms: int = 1):
    """(rays, pieces): the whole rays a consumer warpgroup of the kernel
    takes at a time, and the 64-row pieces their samples fill: the
    fewest rays whose samples fill whole pieces, within 32 rays and
    2048 samples (at least one ray). With ``num_rays``, no more than
    leave two groups (one block's pair) to each of the card's ``sms``
    multiprocessors, so a small launch spreads over the card. The last
    piece of a group whose samples do not fill it, and the ragged last
    group, are masked."""
    whole = GROUP_ROWS // math.gcd(num_samples, GROUP_ROWS)
    rays = min(whole, MAX_GROUP_RAYS, MAX_GROUP_POINTS // num_samples)
    if num_rays is not None:
        rays = min(rays, num_rays // (2 * sms))
    rays = max(1, rays)
    return rays, -(-rays * num_samples // GROUP_ROWS)


@functools.lru_cache(maxsize=None)
def _multiprocessors(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_ray_group(num_rays: int, num_samples: int,
                     device: torch.device):
    """The :func:`ray_group` a launch of ``num_rays`` rays on the CUDA
    ``device`` (a tensor's, with its index) takes."""
    return ray_group(num_samples, num_rays, _multiprocessors(device))


def _per_ray_views(view_directions: torch.Tensor) -> torch.Tensor:
    """(R, 3), or the first sample's of (R, S, 3), as the JAX API."""
    if view_directions.dim() == 3:
        view_directions = view_directions[:, 0, :]
    return view_directions


def fused_ray_render_reference(weights: FusedNeRFWeights,
                               positions: torch.Tensor,
                               view_directions: torch.Tensor,
                               t_values: torch.Tensor,
                               moved: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch twin of K3: (R, S, 3) positions, (R, 3) or
    (R, S, 3) views and (R, S) depths -> (R, 4) f32 [color | alpha].

    Rounds where the kernel rounds: the body as
    :func:`~.fused_nerf.fused_nerf_reference`, the view product
    ``venc . W_hidden[C:]`` once per ray and cast to the working type
    before it joins each sample's ``bottleneck . W_hidden[:C]`` and the
    bias. Alpha leaves out the absorbing tail sample. ``moved``, one of
    :data:`RAY_MOVED_ROUNDINGS`, leaves the view product unrounded (in
    bf16, K1's rounding point): a control that K3's bf16 limits must
    reject."""
    if moved is not None and moved not in RAY_MOVED_ROUNDINGS:
        raise ValueError(f"moved must be one of {RAY_MOVED_ROUNDINGS}, got "
                         f"{moved!r}")
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
    view_term = venc.float() @ w_hidden[channels:].float()
    if moved is None:
        view_term = view_term.to(dtype).float()
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
                     fused_ray_render=(PTR,) * 11 + (LONG, INT, INT, INT),
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
    if not 2 <= num_samples <= MAX_SAMPLES:
        raise ValueError(f"the kernel takes 2 to {MAX_SAMPLES} samples "
                         f"per ray, got {num_samples}")
    _check_pack(weights, device)
    if weights.slabs is None or weights.slabs.device != device:
        raise ValueError(f"a fused NeRF pack needs its slab image on "
                         f"{device}")


def fused_ray_render(weights: FusedNeRFWeights, positions: torch.Tensor,
                     view_directions: torch.Tensor,
                     t_values: torch.Tensor) -> torch.Tensor:
    """Renders rays in one fused pass: (R, S, 3) positions, (R, 3) or
    (R, S, 3) view directions (the first sample's is taken) and (R, S)
    depths -> (R, 4) f32 composited color and alpha. Inference only.

    CPU tensors run :func:`fused_ray_render_reference`. CUDA tensors
    launch the kernel on the current stream (building it on first use)
    or raise; each launch adds one to ``fused_ray_render.launches``. A
    bf16 pack runs K1's wgmma kernel, an f32 pack its 3xTF32 kernel,
    each on the pack's slab image; a model whose rows, view products
    and two ring stages do not fit in a block's shared memory makes the
    launch raise.
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
    sms = _multiprocessors(device)
    logits = 0
    if weights.weights.dtype == torch.float32:
        # the f32 kernel's logits on their way to its composite: 2 KB a
        # block, one block a multiprocessor at most (bf16 keeps them in
        # shared memory)
        scratch = torch.empty((sms, 2 * GROUP_ROWS, 4), dtype=torch.float32,
                              device=device)
        logits = scratch.data_ptr()
    _LIB.launch(fused_ray_render, "fused_ray_render", device,
                positions.data_ptr(), views.data_ptr(), t_values.data_ptr(),
                weights.pos_enc.data_ptr(), weights.view_enc.data_ptr(),
                weights.slabs.data_ptr(), weights.weights.data_ptr(),
                weights.biases.data_ptr(), weights.meta.ctypes.data, logits,
                out.data_ptr(), num_rays, num_samples,
                ray_group(num_samples, num_rays, sms)[0],
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
