"""The fused NeRF forward's ablations: the Hopper kernel and its plain twin.

The CUDA kernel (``csrc/fused_nerf_ablation.cu``) replaces the TPU
Pallas kernel of ``tools/kernel_ablation_bench.py::make_kernel``: K1's
forward with one part of the work changed, in the modes of
:data:`ALL_MODES`. :data:`MODES` are the five the tool's run times
(``:174``), and the ablation CLI prints those. Each mode is an
instantiation of K1's own kernels (``csrc/fused_nerf_forward.cuh``:
the bf16 wgmma kernel, the f32 3xTF32 kernel) with the mode a
compile-time policy, so the modes split the time of the kernel the
serving and training paths run. The modes touch only the body layers
and the position encode, as that tool does:

* ``base`` is K1's own instantiation: it equals
  :func:`~.fused_nerf.fused_nerf_apply` bit for bit, in both types;
* ``no-view`` skips the bottleneck, the view encode, the hidden layer
  and the color head (their slabs are not streamed), and sets the
  color to ``opacity * 0 + color bias``;
* ``no-bias`` adds no body bias, ``no-relu`` casts without a ReLU,
  ``matmul-only`` does both;
* ``bf16-accum`` (bf16 packs only) rounds each body product to bf16,
  and sums the products and adds the bias in bf16: the tool's
  ``preferred_element_type=bf16``. Layer 0 is the chain ``((cos + sin)
  + raw) + bias``, a skip layer ``(h + ((cos + sin) + raw)) + bias``,
  one bf16 rounding after every product and every add. The kernel reads
  its own slab image (:func:`accum_slab_image`), built once a pack;
* ``no-sincos`` encodes positions as ``[phase | phase * 0.5 | raw]``
  in place of ``[cos | sin | raw]``; the view encode keeps its sin/cos.

The weights are the pack of :func:`~.fused_nerf.prepare_fused_nerf`, in
bf16 or f32. :func:`fused_nerf_ablation` runs the twin for CPU tensors;
for CUDA tensors it launches the kernel or raises, and each launch adds
one to ``fused_nerf_ablation.launches``.
"""

import ctypes
import weakref

import numpy as np
import torch

from ..ops.encoding import encode_phases
from .fused_nerf import (
    _DTYPE_CODES,
    SLAB_K,
    FusedNeRFWeights,
    _cached,
    _check_cuda_inputs,
    _dense,
    _features,
    _round_up,
    _slab_part,
    fast_sincos,
    slab_index,
)
from .launch import INT, LONG, PTR, KernelLibrary, on_cuda

__all__ = ["ALL_MODES", "MODES", "accum_parts", "accum_piece",
           "accum_slab_image",
           "accum_slab_index", "fused_nerf_ablation",
           "fused_nerf_ablation_reference", "load_kernel", "shared_bytes"]

MODES = ("base", "no-view", "no-bias", "no-relu", "matmul-only")
ALL_MODES = MODES + ("bf16-accum", "no-sincos")


def _check_mode(mode: str, dtype: torch.dtype) -> None:
    if mode not in ALL_MODES:
        raise ValueError(f"unknown ablation mode {mode!r}; one of "
                         f"{ALL_MODES}")
    if mode == "bf16-accum" and dtype != torch.bfloat16:
        raise ValueError(f"bf16-accum takes a bf16 pack, got {dtype}")


def _pos_parts(weights: FusedNeRFWeights, positions, mode, dtype):
    """The position encode's parts in ``dtype``: [cos, sin(, raw)], or
    [phase, phase * 0.5(, raw)] in ``no-sincos``."""
    x = positions.float()
    phases = encode_phases(x, weights.pos_enc)
    if mode == "no-sincos":
        parts = [phases, phases * 0.5]
    else:
        sin, cos = fast_sincos(phases)
        parts = [cos, sin]
    if weights.include_inputs:
        parts.append(x)
    return [part.to(dtype) for part in parts]


def _body(x, layer, mode, dtype):
    """One body layer in ``mode``: f32 sum (+ bias), cast (, ReLU)."""
    weight, bias = layer
    acc = x.float() @ weight.float()
    if mode not in ("no-bias", "matmul-only"):
        acc = acc + bias
    h = acc.to(dtype)
    return h if mode in ("no-relu", "matmul-only") else torch.relu(h)


def _bf16_body(h, parts, layer):
    """One body layer in ``bf16-accum``: each product rounded to bf16,
    the sums and the bias add in bf16, then the ReLU. ``parts`` are the
    encode's parts, whose weight rows follow ``h``'s (none for a middle
    layer); their products chain left to right, and ``h``'s product
    joins that chain last, as the tool's skip layer adds them."""
    weight, bias = layer
    rows = h.shape[1] if h is not None else 0
    acc = None
    for part in parts:
        width = part.shape[1]
        product = (part.float() @ weight[rows:rows + width].float()).to(
            torch.bfloat16)
        acc = product if acc is None else acc + product
        rows += width
    if h is not None:
        product = (h.float() @ weight[:h.shape[1]].float()).to(torch.bfloat16)
        acc = product if acc is None else product + acc
    return torch.relu(acc + bias.to(torch.bfloat16))


def fused_nerf_ablation_reference(weights: FusedNeRFWeights,
                                  positions: torch.Tensor,
                                  views: torch.Tensor,
                                  mode: str) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: (N, 3) positions and views ->
    (N, 4) f32 logits, with K1's twin's rounding; ``base`` equals
    :func:`~.fused_nerf.fused_nerf_reference`."""
    dtype = weights.weights.dtype
    _check_mode(mode, dtype)
    layers = weights.layers
    num_layers = weights.num_layers
    parts = _pos_parts(weights, positions, mode, dtype)
    enc = torch.cat(parts, -1)
    enc = torch.nn.functional.pad(enc, (0, weights.pos_width - enc.shape[1]))
    if mode == "bf16-accum":
        h = _bf16_body(None, parts, layers[0])
        for i in range(1, num_layers):
            h = _bf16_body(h, parts if i in weights.skips else [], layers[i])
    else:
        h = _body(enc, layers[0], mode, dtype)
        for i in range(1, num_layers):
            inputs = torch.cat([h, enc], -1) if i in weights.skips else h
            h = _body(inputs, layers[i], mode, dtype)
    opacity = _dense(h, layers[num_layers])[:, :1]
    if mode == "no-view":
        color = opacity * 0.0 + layers[num_layers + 3][1][:3]
    else:
        bottleneck = _dense(h, layers[num_layers + 1]).to(dtype)
        venc = _features(views.float(), weights.view_enc, weights.view_width,
                         weights.include_inputs, dtype)
        hidden = torch.relu(_dense(torch.cat([bottleneck, venc], -1),
                                   layers[num_layers + 2])).to(dtype)
        color = _dense(hidden, layers[num_layers + 3])[:, :3]
    return torch.cat([color, opacity], dim=-1)


def accum_parts(e_pos: int, include_inputs: bool):
    """bf16-accum's runs of the position encode: ((offset, length) of
    cos, sin and, with raw inputs, raw; the runs' width). Each run is its
    part's length rounded up to 16 (a whole number of wgmma k16 steps,
    ``csrc/fused_nerf_forward.cuh::accum_parts``); the kernel's
    activation rows hold part p at columns C + offset, zeros after it."""
    parts, width = [], 0
    for length in (e_pos, e_pos) + ((3,) if include_inputs else ()):
        parts.append((width, length))
        width += _round_up(length, 16)
    return tuple(parts), width


def accum_piece(channels: int) -> int:
    """The output columns of one product of a bf16-accum body layer
    (``csrc/fused_nerf_forward.cuh::accum_piece``): a layer's outputs
    are computed, and its accum image stored, in pieces this wide."""
    return 64 if channels % 64 == 0 else 32


def _accum_layer_parts(weights: FusedNeRFWeights, layer: int):
    """The parts of body layer ``layer`` in bf16-accum, in the order the
    kernel sums them (the tool's): for layer 0 and the skip layers the
    position encode's cos, sin and raw, then h for every layer but 0.
    Each is an array of the packed weight rows its run of rows reads
    (``-1`` for a zero row): a position part's length rounded up to 16,
    h's C rows."""
    channels = weights.channels
    e_pos = weights.pos_enc.shape[1]
    parts, _ = accum_parts(e_pos, weights.include_inputs)
    runs = []
    if layer == 0 or layer in weights.skips:
        first_row = 0 if layer == 0 else channels   # packed: [h | pos]
        for (_, length), first in zip(parts, (0, e_pos, 2 * e_pos)):
            run = np.full(_round_up(length, 16), -1)
            run[:length] = first_row + first + np.arange(length)
            runs.append(run)
    if layer > 0:
        runs.append(np.arange(channels))
    return runs


def accum_slab_index(weights: FusedNeRFWeights) -> np.ndarray:
    """Where each element of bf16-accum's slab image comes from: an
    index into the flat weights, or ``-1`` for a zero.

    Each body layer is stored in pieces of :func:`accum_piece` output
    columns; a piece holds each part of :func:`_accum_layer_parts` in
    turn as a (rows, piece) matrix of its own slabs, stored as
    :func:`~.fused_nerf.slab_index` stores a layer, so every part starts
    a slab and its products have a fresh accumulator. The heads, the
    bottleneck and the hidden layer follow as in
    :func:`~.fused_nerf.slab_index`."""
    shapes = [tuple(w.shape) for w, _ in weights.layers]
    offsets = [int(o) for o in weights.meta[8:8 + len(shapes)]]
    width = accum_piece(weights.channels)
    pieces = []
    for layer in range(weights.num_layers):
        n = shapes[layer][1]
        runs = _accum_layer_parts(weights, layer)
        for first in range(0, n, width):
            for rows in runs:
                padded = np.concatenate([rows,
                                         np.full(-len(rows) % SLAB_K, -1)])

                def source(krow, col, o=offsets[layer], n=n, first=first,
                           padded=padded):
                    row = padded[krow]
                    return np.where(row >= 0, o + row * n + first + col, -1)
                pieces.append(_slab_part(len(rows), width, source,
                                         SLAB_K)[0])
    num = weights.num_layers
    pieces.append(slab_index(shapes[num:], offsets[num:]))
    return np.concatenate(pieces)


def accum_slab_image(weights: FusedNeRFWeights) -> torch.Tensor:
    """bf16-accum's slab image of a bf16 pack (:func:`accum_slab_index`):
    one gather on the pack's device, the index cached for the model's
    shape."""
    flat = weights.weights
    key = ("accum", tuple(int(v) for v in weights.meta),
           weights.pos_enc.shape[1], weights.skips)
    index, = _cached(flat, key, lambda: (accum_slab_index(weights),))
    return torch.nn.functional.pad(flat, (0, 1))[index]


# accum images by pack: {id(weights.weights): (weak reference, version,
# image)}, so a timed bf16-accum call gathers no image
_ACCUM_IMAGES = {}


def _accum_image(weights: FusedNeRFWeights) -> torch.Tensor:
    flat = weights.weights
    key = id(flat)
    entry = _ACCUM_IMAGES.get(key)
    if entry is None or entry[0]() is not flat or entry[1] != flat._version:
        ref = weakref.ref(flat, lambda _, key=key: _ACCUM_IMAGES.pop(key,
                                                                      None))
        entry = (ref, flat._version, accum_slab_image(weights))
        _ACCUM_IMAGES[key] = entry
    return entry[2]


_LIB = KernelLibrary("fused_nerf_ablation.cu",
                     "fused_nerf_ablation_error_string",
                     fused_nerf_ablation_forward=(PTR,) * 8 + (LONG, INT,
                                                               INT),
                     fused_nerf_ablation_shared_bytes=(PTR, INT, PTR))


def shared_bytes(weights: FusedNeRFWeights, mode: str,
                 device: torch.device) -> int:
    """The dynamic shared memory a bf16 launch in ``mode`` takes for this
    pack's model on the CUDA ``device``, as the kernel's library counts
    it (``csrc/fused_nerf_forward.cuh::bf16_shared_bytes``; 0 if it does
    not fit). Launches nothing."""
    out = ctypes.c_longlong(0)
    _LIB.call("fused_nerf_ablation_shared_bytes", device,
              weights.meta.ctypes.data, ALL_MODES.index(mode),
              ctypes.addressof(out))
    return out.value


def load_kernel():
    """Builds (first call) and loads the ablation library; returns the
    :class:`~.build.BuiltLibrary`."""
    return _LIB.load()


def fused_nerf_ablation(weights: FusedNeRFWeights, positions: torch.Tensor,
                        views: torch.Tensor, mode: str) -> torch.Tensor:
    """K1's forward in an ablation ``mode``: (N, 3) positions + views ->
    (N, 4) logits, on K1's kernel for the pack's type (``base``: K1's
    own launch)."""
    _check_mode(mode, weights.weights.dtype)
    if not on_cuda(positions, "fused NeRF ablation"):
        return fused_nerf_ablation_reference(weights, positions, views, mode)
    _check_cuda_inputs(weights, positions, views)
    num = positions.shape[0]
    device = positions.device
    out = torch.empty((num, 4), dtype=torch.float32, device=device)
    if num == 0:
        return out
    slabs = _accum_image(weights) if mode == "bf16-accum" else weights.slabs
    _LIB.launch(fused_nerf_ablation, "fused_nerf_ablation_forward", device,
                positions.data_ptr(), views.data_ptr(),
                weights.pos_enc.data_ptr(), weights.view_enc.data_ptr(),
                slabs.data_ptr(), weights.biases.data_ptr(),
                weights.meta.ctypes.data, out.data_ptr(), num,
                ALL_MODES.index(mode), _DTYPE_CODES[weights.weights.dtype])
    return out


fused_nerf_ablation.launches = 0
