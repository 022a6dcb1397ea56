"""Fused NeRF forward: the Hopper kernel, its weight pack and its plain twin.

The CUDA kernels (``csrc/fused_nerf.cu``) replace the TPU Pallas kernels
``fourier_feature_nets_tpu/ops/fused_nerf.py::_kernel`` and
``ops/fused_nerf_fm.py::_kernel_fm``, which compute the same function
in two layouts. The source comment says what bounds them on an H100.

* :func:`pack_fused_nerf` packs a :class:`~..models.nerf.NeRF` into
  one contiguous weight buffer (bf16 or f32), one f32 bias buffer and
  an offset table, differentiably; :func:`prepare_fused_nerf` is the
  same pack without autograd. A pack also carries the weights once
  more as the slab image its kernels stream, built outside autograd:
  bf16 (:func:`slab_image`) or f32 (:func:`f32_slab_image`, the tf32
  hi and lo parts the 3xTF32 products read, :func:`tf32_split`).
* :func:`fused_nerf_reference` is the plain PyTorch twin: the same
  packed weights, the same rounding points and the same sin/cos; with
  ``products``, an f32 twin whose products are emulated 3xTF32 or
  single tf32 (:data:`TF32_PRODUCTS`).
* :func:`fused_nerf_apply` launches the kernel for CUDA tensors and
  runs the twin for CPU tensors. A CUDA call launches the kernel or
  raises; it never falls back.
"""

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.nerf import NeRF
from ..ops.encoding import encode_phases
from .launch import INT, LONG, PTR, KernelLibrary, on_cuda

__all__ = ["FusedNeRFWeights", "MOVED_ROUNDINGS", "TF32_PRODUCTS",
           "pack_fused_nerf", "prepare_fused_nerf", "slab_index",
           "slab_image", "f32_slab_index", "f32_slab_image", "tf32_round",
           "tf32_split", "fast_sincos", "fused_nerf_reference",
           "fused_nerf_apply", "load_kernel"]

HEAD_WIDTH = 16       # heads padded to the MMA tile width
MAX_CHANNELS = 256    # kMaxChannels in csrc/fused_nerf_common.cuh
MAX_LAYERS = 16       # kMaxLayers in csrc/fused_nerf_common.cuh
SLAB_K = 64           # K rows of a slab: one 128-byte swizzled row of bf16
F32_SLAB_K = 32       # the same row of f32
MAX_PIECE = 128       # kMaxPiece in csrc/fused_nerf_tf32.cuh
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# One rounding point of the twin moved (``fused_nerf_reference(moved=...)``):
# a body layer's sum cast before its bias is added and cast again after;
# the bottleneck, or the hidden layer, left in f32; the heads rounded to
# bf16. Moving a ReLU across its cast is no such move: they commute.
MOVED_ROUNDINGS = ("bias-after-cast", "uncast-bottleneck", "uncast-hidden",
                   "cast-heads")
# The products of an f32 twin emulated on the tensor cores' terms
# (``fused_nerf_reference(products=...)``): "3xtf32", the f32 kernels'
# lo hi + hi lo + hi hi of tf32 parts (:func:`tf32_split`); "tf32", one
# product of tf32-rounded operands, which no f32 path runs: the control
# that the f32 limits must reject.
TF32_PRODUCTS = ("3xtf32", "tf32")
_SLAB_INDEX_CACHE = {}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class FusedNeRFWeights(NamedTuple):
    """A NeRF packed for the fused kernel.

    ``layers`` holds (weight (K, N), bias (N,)) views into the two
    buffers, in packing order: body layers, opacity head, bottleneck,
    hidden layer, color head. Weights are (in, out); K is padded to the
    encoded features' padded width, the heads' N to 16. ``slabs`` is
    the kernels' copy of ``weights``: :func:`slab_image` in a bf16 pack,
    :func:`f32_slab_image` in an f32 one.
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
    slabs: Optional[torch.Tensor] = None

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
    image = slab_image if dtype == torch.bfloat16 else f32_slab_image
    slabs = image(weights.detach(), [tuple(w.shape) for w, _ in packed],
                  w_offsets[:-1])
    return FusedNeRFWeights(
        weights=weights, biases=biases,
        pos_enc=model.pos_encoding.detach().float().contiguous(),
        view_enc=model.view_encoding.detach().float().contiguous(),
        meta=meta, layers=layers, num_layers=num_layers, channels=channels,
        skips=skips, include_inputs=bool(model.include_inputs),
        pos_width=pos_width, view_width=view_width, slabs=slabs)


def _slab_part(k_dim: int, n_dim: int, source, slab_k: int,
               pieces: int = 1, copies: int = 1):
    """The flat index (``-1`` for a zero) and the copy number of each
    element of a (k_dim, n_dim) matrix stored as slabs: ceil(k_dim /
    slab_k) slabs, each as ``pieces`` pieces of n_dim / pieces rows,
    each piece ``copies`` times; row ``n`` of a piece holds slab_k
    K-rows of column n, its 16-byte chunk ``q`` stored at chunk ``q ^
    (n % 8)`` of the row (wgmma's 128-byte swizzled K-major layout).
    ``source(krow, col)`` gives the flat index of element (krow, col)."""
    width = n_dim // pieces
    chunk = slab_k // 8
    slab = np.arange(-(-k_dim // slab_k))[:, None, None, None, None]
    piece = np.arange(pieces)[None, :, None, None, None]
    copy = np.arange(copies)[None, None, :, None, None]
    row = np.arange(width)[None, None, None, :, None]
    pos = np.arange(slab_k)[None, None, None, None, :]
    krow = slab * slab_k + ((pos // chunk) ^ (row % 8)) * chunk + pos % chunk
    col = piece * width + row
    index = np.where(krow < k_dim, source(krow, col), -1)
    shape = np.broadcast_shapes(index.shape, copy.shape)
    return (np.broadcast_to(index, shape).reshape(-1),
            np.broadcast_to(copy, shape).reshape(-1))


def slab_index(shapes, offsets) -> np.ndarray:
    """Where each element of the bf16 kernel's slab image comes from:
    an index into the flat weights, or ``-1`` for a zero.

    ``shapes`` are the packed layers' (K, N), in packing order, and
    ``offsets`` their offsets into the flat weights. Each layer becomes
    ceil(K / 64) slabs of N rows x 64 elements: slab ``s``, row ``n``
    holds column ``n`` of the (in, out) weight for K rows 64 s .. 64 s
    + 63 (zeros past K), its 16-byte chunk ``q`` (8 elements) stored
    at chunk ``q ^ (n % 8)`` of the row. That is wgmma's 128-byte
    swizzled K-major layout, so one slab is one contiguous copy into a
    1024-byte-aligned ring stage (``csrc/hopper.cuh``)."""
    return np.concatenate([
        _slab_part(k, n, lambda krow, col, o=int(offset), n=n:
                   o + krow * n + col, SLAB_K)[0]
        for (k, n), offset in zip(shapes, offsets)])


def _cached(flat: torch.Tensor, key, build):
    """The index arrays ``build()`` makes for ``key`` (the first an
    index into ``flat``, -1 for a zero), on ``flat``'s device and cached
    there, with each -1 turned into ``flat.numel()``: the zero the
    gather appends to ``flat``."""
    entry = _SLAB_INDEX_CACHE.get((key, flat.device))
    if entry is None:
        arrays = build()
        arrays[0][arrays[0] < 0] = flat.numel()
        entry = tuple(torch.from_numpy(a).to(flat.device) for a in arrays)
        _SLAB_INDEX_CACHE[(key, flat.device)] = entry
    return entry


def slab_image(flat: torch.Tensor, shapes, offsets) -> torch.Tensor:
    """The bf16 kernel's slab image of the flat weights (see
    :func:`slab_index`): one gather on ``flat``'s device, with the index
    cached for the model's shape."""
    key = ("bf16", tuple(shapes), tuple(int(o) for o in offsets))
    index, = _cached(flat, key, lambda: (slab_index(shapes, offsets),))
    return F.pad(flat, (0, 1))[index]


def _pieces(n: int) -> int:
    return 2 if n > MAX_PIECE else 1


def f32_slab_index(shapes, offsets):
    """Where each element of the f32 kernels' slab image comes from (an
    index into the flat weights, ``-1`` for a zero) and what it holds:
    0 the tf32 ``hi`` of that weight, 1 its ``lo`` (:func:`tf32_split`),
    2 the weight itself.

    The image (``csrc/fused_nerf_tf32.cuh``) holds, in this order:
    the forward's layers (body 0..L-1, bottleneck, hidden), each (K, N)
    as ceil(K / 32) slabs of 32 K-rows in ``_pieces(N)`` pieces of N
    rows (128 columns at most), each piece its hi rows then its lo
    rows, swizzled as :func:`slab_index` (16-byte chunks of 4 values);
    the backward's dX operands, W^T of the first C rows of the hidden
    layer, the bottleneck and body layers L-1 .. 1, each a (N, C)
    matrix stored the same way; then the opacity and the color head as
    they lie in the flat weights (kind 2)."""
    num_layers = len(shapes) - 4
    channels = shapes[0][1]
    offsets = [int(o) for o in offsets]
    parts = []
    forward = [*range(num_layers), num_layers + 1, num_layers + 2]
    for j in forward:
        k, n = shapes[j]
        parts.append(_slab_part(k, n, lambda krow, col, o=offsets[j], n=n:
                                o + krow * n + col, F32_SLAB_K, _pieces(n),
                                2))
    backward = [num_layers + 2, num_layers + 1,
                *range(num_layers - 1, 0, -1)]
    for j in backward:
        _, n = shapes[j]
        # W^T[k][c] = W[c][k]: K = the layer's outputs, N = its first C
        # inputs
        parts.append(_slab_part(n, channels,
                                lambda krow, col, o=offsets[j], n=n:
                                o + col * n + krow, F32_SLAB_K,
                                _pieces(channels), 2))
    for j in (num_layers, num_layers + 3):
        k, n = shapes[j]
        index = offsets[j] + np.arange(k * n)
        parts.append((index, np.full(index.shape, 2)))
    return (np.concatenate([index for index, _ in parts]),
            np.concatenate([kind for _, kind in parts]).astype(np.int8))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to tf32, to nearest with ties away from zero,
    as ``cvt.rna.tf32.f32``: the low 13 bits of the significand
    zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo) of f32 ``x``: hi = tf32(x), lo = x - hi, which is exact,
    so hi + lo == x. The 3xTF32 products read hi and tf32(lo)."""
    hi = tf32_round(x)
    return hi, x - hi


def f32_slab_image(flat: torch.Tensor, shapes, offsets) -> torch.Tensor:
    """The f32 kernels' slab image of the flat f32 weights (see
    :func:`f32_slab_index`): one gather on ``flat``'s device, then each
    element's tf32 part, with the index cached for the model's
    shape."""
    key = ("f32", tuple(shapes), tuple(int(o) for o in offsets))
    index, kind = _cached(flat, key, lambda: f32_slab_index(shapes, offsets))
    values = F.pad(flat, (0, 1))[index]
    hi, lo = tf32_split(values)
    return torch.where(kind == 0, hi,
                       torch.where(kind == 1, tf32_round(lo), values))


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


def _dense(x, layer, products: Optional[str] = None):
    """bf16/f32 inputs and weights, f32 products and sum, f32 bias; with
    ``products`` (:data:`TF32_PRODUCTS`), the products emulated on tf32
    parts."""
    weight, bias = layer
    a, b = x.float(), weight.float()
    if products is None:
        return a @ b + bias
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    if products == "tf32":
        return a_hi @ b_hi + bias
    return (tf32_round(a_lo) @ b_hi + a_hi @ tf32_round(b_lo)) \
        + a_hi @ b_hi + bias


def _trunk(weights: FusedNeRFWeights, positions: torch.Tensor,
           moved: Optional[str] = None, products: Optional[str] = None):
    """The twin's per-point body: the (N, 1) f32 opacity logit and the
    bottleneck in the working type (see :data:`MOVED_ROUNDINGS` and
    :data:`TF32_PRODUCTS`: the heads are f32 on the CUDA cores, so only
    the layers' products take ``products``)."""
    dtype = weights.weights.dtype
    layers = weights.layers
    num_layers = weights.num_layers

    def body(inputs, layer):
        if moved == "bias-after-cast":
            weight, bias = layer
            total = (inputs.float() @ weight.float()).to(dtype).float() + bias
        else:
            total = _dense(inputs, layer, products)
        return torch.relu(total.to(dtype))

    enc = _features(positions.float(), weights.pos_enc, weights.pos_width,
                    weights.include_inputs, dtype)
    h = body(enc, layers[0])
    for i in range(1, num_layers):
        h = body(torch.cat([h, enc], -1) if i in weights.skips else h,
                 layers[i])
    opacity = _dense(h, layers[num_layers])[:, :1]
    bottleneck = _dense(h, layers[num_layers + 1], products)
    if moved != "uncast-bottleneck":
        bottleneck = bottleneck.to(dtype)
    return opacity, bottleneck


def fused_nerf_reference(weights: FusedNeRFWeights, positions: torch.Tensor,
                         views: torch.Tensor, moved: Optional[str] = None,
                         products: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: (N, 3) positions and views ->
    (N, 4) f32 logits, rounding where the kernel rounds. On a CUDA
    device the f32 products rely on ``allow_tf32`` being False.

    ``moved``, one of :data:`MOVED_ROUNDINGS`, moves one rounding point
    of a bf16 pack: a control that a bf16 kernel's tolerance against
    the twin must reject. ``products``, one of :data:`TF32_PRODUCTS`,
    emulates the layers' products of an f32 pack on tf32 parts."""
    if moved is not None and moved not in MOVED_ROUNDINGS:
        raise ValueError(f"moved must be one of {MOVED_ROUNDINGS}, got "
                         f"{moved!r}")
    if products is not None and products not in TF32_PRODUCTS:
        raise ValueError(f"products must be one of {TF32_PRODUCTS}, got "
                         f"{products!r}")
    dtype = weights.weights.dtype
    layers = weights.layers
    num_layers = weights.num_layers
    opacity, bottleneck = _trunk(weights, positions, moved, products)
    venc = _features(views.float(), weights.view_enc, weights.view_width,
                     weights.include_inputs, dtype)
    hidden = torch.relu(_dense(torch.cat([bottleneck,
                                          venc.to(bottleneck.dtype)], -1),
                               layers[num_layers + 2], products))
    if moved != "uncast-hidden":
        hidden = hidden.to(dtype)
    out = torch.cat([_dense(hidden, layers[num_layers + 3])[:, :3], opacity],
                    dim=-1)
    return out.to(dtype).float() if moved == "cast-heads" else out


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
    if weights.slabs is None or weights.slabs.device != device:
        raise ValueError(f"a fused NeRF pack needs its slab image on "
                         f"{device}")


def fused_nerf_apply(weights: FusedNeRFWeights, positions: torch.Tensor,
                     views: torch.Tensor) -> torch.Tensor:
    """Fused NeRF forward: (N, 3) positions + views -> (N, 4) logits.

    CPU tensors run :func:`fused_nerf_reference`. CUDA tensors launch
    the kernel on the current stream (building it on first use) or
    raise; each launch adds one to ``fused_nerf_apply.launches``. A
    pack launches its type's wgmma kernel on its slab image: bf16
    products, or f32 as 3xTF32 products. A model whose activation rows
    and two ring stages do not fit in a block's shared memory makes the
    launch raise (``csrc/fused_nerf.cu::bf16_shared_bytes``,
    ``tf32_shared_bytes``).
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
                weights.slabs.data_ptr(), weights.biases.data_ptr(),
                weights.meta.ctypes.data, out.data_ptr(), num,
                _DTYPE_CODES[weights.weights.dtype])
    return out


fused_nerf_apply.launches = 0
