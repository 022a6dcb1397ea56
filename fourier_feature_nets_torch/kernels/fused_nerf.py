"""Fused NeRF forward: the Hopper kernel, its weight pack and its plain twin.

The CUDA kernel (``csrc/fused_nerf.cu``) replaces the TPU Pallas kernels
``fourier_feature_nets_tpu/ops/fused_nerf.py::_kernel`` and
``ops/fused_nerf_fm.py::_kernel_fm``, which compute the same function
in two layouts. The source comment says what bounds it on an H100.

* :func:`pack_fused_nerf` packs a :class:`~..models.nerf.NeRF` into
  one contiguous weight buffer (bf16 or f32), one f32 bias buffer and
  an offset table, differentiably; :func:`prepare_fused_nerf` is the
  same pack without autograd.
* :func:`fused_nerf_reference` is the plain PyTorch twin: the same
  packed weights, the same rounding points and the same sin/cos.
* :func:`fused_nerf_apply` launches the kernel for CUDA tensors and
  runs the twin for CPU tensors. A CUDA call launches the kernel or
  raises; it never falls back.
"""

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.nerf import NeRF
from ..ops.encoding import encode_phases
from .launch import INT, LONG, PTR, KernelLibrary, on_cuda

__all__ = ["FusedNeRFWeights", "pack_fused_nerf", "prepare_fused_nerf",
           "fast_sincos", "fused_nerf_reference", "fused_nerf_apply",
           "load_kernel"]

HEAD_WIDTH = 16       # heads padded to the MMA tile width
MAX_CHANNELS = 256    # kMaxChannels in csrc/fused_nerf.cu
MAX_LAYERS = 16       # kMaxLayers in csrc/fused_nerf.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class FusedNeRFWeights(NamedTuple):
    """A NeRF packed for the fused kernel.

    ``layers`` holds (weight (K, N), bias (N,)) views into the two
    buffers, in packing order: body layers, opacity head, bottleneck,
    hidden layer, color head. Weights are (in, out); K is padded to the
    encoded features' padded width, the heads' N to 16.
    """

    weights: torch.Tensor      # flat, bf16 or f32
    biases: torch.Tensor       # flat, f32
    pos_enc: torch.Tensor      # (3, E_pos) f32
    view_enc: torch.Tensor     # (3, E_view) f32
    meta: np.ndarray           # int64 descriptor read by the C entry point
    layers: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]
    num_layers: int
    channels: int
    skips: Tuple[int, ...]
    include_inputs: bool
    pos_width: int
    view_width: int

    def split_flat(self, flat_weights: torch.Tensor,
                   flat_biases: torch.Tensor):
        """(name, flat view) of every layer's weight (``w<i>``) and bias
        (``b<i>``) in two flat buffers laid out like this pack's, such
        as the gradients K2 returns; ``i`` is the packing order."""
        count = self.num_layers + 4
        w_off, b_off = self.meta[8:8 + count], self.meta[8 + count:]
        leaves = []
        for i, (w, b) in enumerate(self.layers):
            leaves.append((f"w{i}", flat_weights[w_off[i]:w_off[i]
                                                 + w.numel()]))
            leaves.append((f"b{i}", flat_biases[b_off[i]:b_off[i]
                                                + b.numel()]))
        return leaves


def pack_fused_nerf(model: NeRF, dtype=torch.bfloat16) -> FusedNeRFWeights:
    """Packs ``model``'s parameters for the kernels, on the model's
    device, with weights cast to ``dtype`` (bf16 or f32).

    The pack is built from ``F.pad``, ``cat`` and a cast of the live
    parameters, so under autograd the gradients of the two flat
    buffers flow back to the module's parameters (a bf16 weight
    gradient returns to its f32 parameter through the cast)."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"fused NeRF weights must be bf16 or f32, got {dtype}")
    if 0 in model.skips:
        raise ValueError("the fused NeRF forward takes no skip at layer 0")
    num_layers = model.num_layers
    channels = model.num_channels
    skips = tuple(s for s in sorted(model.skips) if 0 < s < num_layers)
    e_pos = model.pos_encoding.shape[1]
    e_view = model.view_encoding.shape[1]
    pos_width = _round_up(model.num_pos_encoded, 16)
    view_width = _round_up(model.num_view_encoded, 16)

    def padded(layer, rows, cols):
        """The (in, out) weight and its bias, zero-padded to (rows,
        cols). Inputs keep their order ([h | features] for the skip and
        hidden layers), so padding rows go to the end, where the
        kernel's padded feature columns hold zeros."""
        w_t = layer.weight.T.float()
        w_t = F.pad(w_t, (0, cols - w_t.shape[1], 0, rows - w_t.shape[0]))
        bias = F.pad(layer.bias.float(), (0, cols - layer.bias.shape[0]))
        return w_t, bias

    packed = []
    for i, layer in enumerate(model.layers):
        rows = channels if i > 0 else 0
        if i == 0 or i in skips:
            rows += pos_width
        packed.append(padded(layer, rows, channels))
    packed.append(padded(model.opacity_out, channels, HEAD_WIDTH))
    packed.append(padded(model.bottleneck, channels, channels))
    packed.append(padded(model.hidden_view, channels + view_width,
                         channels // 2))
    packed.append(padded(model.color_out, channels // 2, HEAD_WIDTH))

    w_offsets = np.cumsum([0] + [w.numel() for w, _ in packed])
    b_offsets = np.cumsum([0] + [b.numel() for _, b in packed])
    weights = torch.cat([w.reshape(-1) for w, _ in packed]).to(dtype)
    biases = torch.cat([b for _, b in packed])
    layers = tuple(
        (weights[w_offsets[i]:w_offsets[i + 1]].view(w.shape),
         biases[b_offsets[i]:b_offsets[i + 1]])
        for i, (w, _) in enumerate(packed))
    skip_mask = sum(1 << s for s in skips)
    meta = np.array([num_layers, channels, pos_width, view_width, e_pos,
                     e_view, int(model.include_inputs), skip_mask,
                     *w_offsets[:-1], *b_offsets[:-1]], np.int64)
    return FusedNeRFWeights(
        weights=weights, biases=biases,
        pos_enc=model.pos_encoding.detach().float().contiguous(),
        view_enc=model.view_encoding.detach().float().contiguous(),
        meta=meta, layers=layers, num_layers=num_layers, channels=channels,
        skips=skips, include_inputs=bool(model.include_inputs),
        pos_width=pos_width, view_width=view_width)


def prepare_fused_nerf(model: NeRF, dtype=torch.bfloat16) -> FusedNeRFWeights:
    """:func:`pack_fused_nerf` outside autograd: a detached pack for
    rendering."""
    with torch.no_grad():
        return pack_fused_nerf(model, dtype)


def fast_sincos(x: torch.Tensor):
    """sin and cos with one shared range reduction and Taylor tails
    (the polynomial of ``ops/fused_nerf.py::_fast_sincos``, ~1e-5 over
    the encode's phase range)."""
    two_pi = 6.283185307179586
    f = x * (1.0 / two_pi)
    f = f - torch.round(f)
    t = f * two_pi
    t2 = t * t
    cos = 1.0 + t2 * (-0.5 + t2 * (
        4.1666666666666664e-2 + t2 * (-1.3888888888888889e-3 + t2 * (
            2.4801587301587302e-5 + t2 * (-2.7557319223985893e-7
                                          + t2 * (2.08767569878681e-9
                                                  - t2 * 1.1470745597729725e-11))))))
    sin = t * (1.0 + t2 * (-1.6666666666666666e-1 + t2 * (
        8.3333333333333332e-3 + t2 * (-1.9841269841269841e-4 + t2 * (
            2.7557319223985893e-6 + t2 * (-2.5052108385441720e-8
                                          + t2 * 1.6059043836821613e-10))))))
    return sin, cos


def _features(x, encoding, width, include_inputs, dtype):
    """[cos | sin | raw x | zeros] to ``width`` columns, in ``dtype``."""
    sin, cos = fast_sincos(encode_phases(x, encoding))
    parts = [cos, sin] + ([x] if include_inputs else [])
    feats = torch.cat(parts, dim=-1)
    feats = torch.nn.functional.pad(feats, (0, width - feats.shape[-1]))
    return feats.to(dtype)


def _dense(x, layer):
    """bf16/f32 inputs and weights, f32 products and sum, f32 bias."""
    weight, bias = layer
    return x.float() @ weight.float() + bias


def _trunk(weights: FusedNeRFWeights, positions: torch.Tensor):
    """The twin's per-point body: the (N, 1) f32 opacity logit and the
    bottleneck in the working type."""
    dtype = weights.weights.dtype
    layers = weights.layers
    num_layers = weights.num_layers
    enc = _features(positions.float(), weights.pos_enc, weights.pos_width,
                    weights.include_inputs, dtype)
    h = torch.relu(_dense(enc, layers[0]).to(dtype))
    for i in range(1, num_layers):
        inputs = torch.cat([h, enc], -1) if i in weights.skips else h
        h = torch.relu(_dense(inputs, layers[i]).to(dtype))
    opacity = _dense(h, layers[num_layers])[:, :1]
    bottleneck = _dense(h, layers[num_layers + 1]).to(dtype)
    return opacity, bottleneck


def fused_nerf_reference(weights: FusedNeRFWeights, positions: torch.Tensor,
                         views: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: (N, 3) positions and views ->
    (N, 4) f32 logits, rounding where the kernel rounds. On a CUDA
    device the f32 products rely on ``allow_tf32`` being False."""
    dtype = weights.weights.dtype
    layers = weights.layers
    num_layers = weights.num_layers
    opacity, bottleneck = _trunk(weights, positions)
    venc = _features(views.float(), weights.view_enc, weights.view_width,
                     weights.include_inputs, dtype)
    hidden = torch.relu(_dense(torch.cat([bottleneck, venc], -1),
                               layers[num_layers + 2])).to(dtype)
    color = _dense(hidden, layers[num_layers + 3])[:, :3]
    return torch.cat([color, opacity], dim=-1)


_LIB = KernelLibrary("fused_nerf.cu", "fused_nerf_error_string",
                     fused_nerf_forward=(PTR,) * 8 + (LONG, INT))


def load_kernel():
    """Builds (first call) and loads the kernel library; returns the
    :class:`~.build.BuiltLibrary`."""
    return _LIB.load()


def _check_pack(weights: FusedNeRFWeights, device: torch.device):
    """Raises unless the pack lies on ``device`` and the kernels take
    its type and shape."""
    for name, tensor in (("weights", weights.weights),
                         ("biases", weights.biases),
                         ("pos_enc", weights.pos_enc),
                         ("view_enc", weights.view_enc)):
        if tensor.device != device:
            raise ValueError(f"{name} is on {tensor.device}, positions on "
                             f"{device}")
    if weights.weights.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported weight dtype {weights.weights.dtype}")
    if weights.channels % 32 or weights.channels > MAX_CHANNELS \
            or weights.num_layers > MAX_LAYERS:
        raise ValueError(
            f"the kernel takes channels a multiple of 32 up to "
            f"{MAX_CHANNELS} and at most {MAX_LAYERS} layers; got "
            f"{weights.channels} channels, {weights.num_layers} layers")


def _check_cuda_inputs(weights: FusedNeRFWeights, positions, views):
    device = positions.device
    for name, tensor in (("positions", positions), ("views", views)):
        if tensor.dtype != torch.float32 or tensor.dim() != 2 \
                or tensor.shape[1] != 3 or not tensor.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (N, 3) float32 "
                             f"tensor, got {tensor.dtype} "
                             f"{tuple(tensor.shape)}")
    if views.shape != positions.shape:
        raise ValueError("positions and views must have the same shape")
    if views.device != device:
        raise ValueError(f"views is on {views.device}, positions on {device}")
    _check_pack(weights, device)


def fused_nerf_apply(weights: FusedNeRFWeights, positions: torch.Tensor,
                     views: torch.Tensor) -> torch.Tensor:
    """Fused NeRF forward: (N, 3) positions + views -> (N, 4) logits.

    CPU tensors run :func:`fused_nerf_reference`. CUDA tensors launch
    the kernel on the current stream (building it on first use) or
    raise; each launch adds one to ``fused_nerf_apply.launches``.
    """
    if not on_cuda(positions, "fused NeRF"):
        return fused_nerf_reference(weights, positions, views)
    _check_cuda_inputs(weights, positions, views)
    num = positions.shape[0]
    device = positions.device
    out = torch.empty((num, 4), dtype=torch.float32, device=device)
    if num == 0:
        return out
    _LIB.launch(fused_nerf_apply, "fused_nerf_forward", device,
                positions.data_ptr(), views.data_ptr(),
                weights.pos_enc.data_ptr(), weights.view_enc.data_ptr(),
                weights.weights.data_ptr(), weights.biases.data_ptr(),
                weights.meta.ctypes.data, out.data_ptr(), num,
                _DTYPE_CODES[weights.weights.dtype])
    return out


fused_nerf_apply.launches = 0
