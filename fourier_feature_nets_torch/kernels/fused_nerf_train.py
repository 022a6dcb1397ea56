"""Fused NeRF training: the recompute-backward Hopper kernel and its twin.

The CUDA kernel (``csrc/fused_nerf_train.cu``) replaces the TPU Pallas
kernels ``fourier_feature_nets_tpu/ops/fused_nerf_train.py::_bwd_kernel``
and ``ops/fused_nerf_train_fm.py::_bwd_kernel_fm`` (the same function in
two layouts). Given positions, views, the packed weights and the (N, 4)
f32 cotangent of the logits, it recomputes the forward on chip and
returns the f32 gradient of every packed weight and bias. In bf16 it
is a persistent wgmma kernel on K1's 128-point tile that streams the
pack's slab image and parks each tile's activations in a scratch
buffer this wrapper allocates; in f32, an FFMA tile on the flat pack.
The source comment says what bounds it on an H100.

* :func:`fused_nerf_train_apply` is the differentiable forward: the
  packed weights from :func:`~.fused_nerf.pack_fused_nerf` (built from
  the live parameters) go through :class:`FusedNeRFTrain`, whose
  forward launches K1 (:func:`~.fused_nerf.fused_nerf_apply`) and whose
  backward launches K2 (:func:`fused_nerf_backward`).
* :func:`fused_nerf_backward_reference` is the plain PyTorch twin of
  K2: an explicit backward with the kernel's rounding points, not
  autograd through :func:`~.fused_nerf.fused_nerf_reference`; with
  ``moved``, one of its rounding points moved (a control for the bf16
  limits). :func:`relu_margin` says how close each point comes to a ReLU mask
  boundary in it. With :func:`far_from_relu`, :func:`leaf_mean_share`
  and the ``K2_BF16_*`` limits it makes up the kernel's checks, which
  ``chip_smoke.py`` and the card tests share.
* :func:`fused_nerf_backward` launches the kernel for CUDA tensors and
  runs the twin for CPU tensors. A CUDA call launches the kernel or
  raises; it never falls back.
"""

import ctypes
from typing import Callable, Optional, Tuple

import torch

from .fused_nerf import (
    _DTYPE_CODES,
    HEAD_WIDTH,
    FusedNeRFWeights,
    _check_cuda_inputs,
    _dense,
    _features,
    fused_nerf_apply,
)
from .launch import INT, LONG, PTR, KernelLibrary, on_cuda

# One rounding point of the twin moved (``fused_nerf_backward_reference(
# moved=...)``): every dz left in f32 before its products, or the heads'
# f32 cotangent rounded to bf16.
MOVED_BACKWARD_ROUNDINGS = ("uncast-dz", "cast-head-cotangent")

__all__ = ["K2_BF16_CONTROL_MODEL", "K2_BF16_MARGIN", "K2_BF16_MEAN_SHARE",
           "K2_BF16_TAIL_POOL", "FusedNeRFTrain", "MOVED_BACKWARD_ROUNDINGS",
           "fused_nerf_backward", "fused_nerf_backward_reference",
           "far_from_relu", "fused_nerf_train_apply", "leaf_mean_share",
           "load_kernel", "relu_margin", "scratch_bytes"]


def _body_grad(inputs: torch.Tensor, dz: torch.Tensor):
    """Weight and bias gradient of a dense layer: ``inputs^T @ dz``
    and ``sum(dz)``, both from the working-type values in f32."""
    dz = dz.float()
    return inputs.float().T @ dz, dz.sum(0)


def _head_grad(inputs: torch.Tensor, g: torch.Tensor):
    """Gradient of a head padded to HEAD_WIDTH columns: the f32
    cotangent ``g`` stays f32 (JAX promotes a bf16 x f32 product)."""
    d_w = inputs.new_zeros((inputs.shape[1], HEAD_WIDTH), dtype=torch.float32)
    d_b = g.new_zeros(HEAD_WIDTH)
    d_w[:, :g.shape[1]] = inputs.float().T @ g
    d_b[:g.shape[1]] = g.sum(0)
    return d_w, d_b


def _recompute(weights: FusedNeRFWeights, positions: torch.Tensor,
               views: torch.Tensor):
    """The twin's forward, rounding where K1 rounds: the input and the
    working-type pre-activation of every body layer, the last body
    activation, and the hidden layer's input and f32 pre-activation."""
    dtype = weights.weights.dtype
    layers = weights.layers
    num_layers = weights.num_layers
    enc = _features(positions.float(), weights.pos_enc, weights.pos_width,
                    weights.include_inputs, dtype)
    inputs, zs = [], []
    h = enc
    for i in range(num_layers):
        if i in weights.skips:
            h = torch.cat([h, enc], -1)
        inputs.append(h)
        zs.append(_dense(h, layers[i]).to(dtype))
        h = torch.relu(zs[-1])
    bottleneck = _dense(h, layers[num_layers + 1]).to(dtype)
    venc = _features(views.float(), weights.view_enc, weights.view_width,
                     weights.include_inputs, dtype)
    hidden_in = torch.cat([bottleneck, venc], -1)
    return inputs, zs, h, hidden_in, _dense(hidden_in, layers[num_layers + 2])


def relu_margin(weights: FusedNeRFWeights, positions: torch.Tensor,
                views: torch.Tensor) -> torch.Tensor:
    """(N,) f32: each point's smallest |pre-activation| over every ReLU
    unit (body and hidden layers) of the twin's forward.

    K2 and its twin sum each pre-activation in another order. A point
    whose margin is within that rounding of 0 can take the other side
    of a ReLU mask in each, and its gradient terms then differ by a
    whole term rather than by rounding. Zeroing the cotangent of such
    points separates those flips from a fault in the kernel."""
    with torch.no_grad():
        _, zs, _, _, hidden_z = _recompute(weights, positions, views)
        margin = hidden_z.abs().amin(-1)
        for z in zs:
            margin = torch.minimum(margin, z.float().abs().amin(-1))
    return margin


# K2 bf16's checks against the twin, shared by chip_smoke.py and the card
# tests (the comments at chip_smoke.py's GRAD_SHARE give the readings
# behind them):
# * the tail cotangent's points are, of K2_BF16_TAIL_POOL random points
#   drawn for each, the ones farthest from every ReLU boundary
#   (far_from_relu): over a tail of ~256 points one ReLU flip is ~1/16 of a
#   leaf;
# * per leaf, mean|kernel - twin| <= K2_BF16_MEAN_SHARE * mean|twin| under
#   that tail cotangent at the flagship, and under a random cotangent zeroed
#   on the points within K2_BF16_MARGIN of a boundary at
#   K2_BF16_CONTROL_MODEL (the flagship's width, 3 layers); each twin with a
#   rounding point moved (MOVED_BACKWARD_ROUNDINGS) must fail it.
K2_BF16_TAIL_POOL = 1024
K2_BF16_MARGIN = 3e-4
K2_BF16_MEAN_SHARE = 1.5e-3
K2_BF16_CONTROL_MODEL = dict(num_layers=3, num_channels=256, skips=[2],
                             include_inputs=True, max_log_scale_pos=6.0,
                             num_freq_pos=7, max_log_scale_view=2.0,
                             num_freq_view=3)


def leaf_mean_share(weights: FusedNeRFWeights, out, twin) -> float:
    """The largest per-leaf mean|out - twin| / mean|twin| of two
    (d_weights, d_biases) pairs in ``weights``' layout."""
    return max((a - b).abs().mean().item() / max(b.abs().mean().item(), 1e-30)
               for (_, a), (_, b) in zip(weights.split_flat(*out),
                                         weights.split_flat(*twin)))


def far_from_relu(weights: FusedNeRFWeights, num: int, pool: int,
                  draw: Callable[[int], Tuple[torch.Tensor, torch.Tensor]]
                  ) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """Of ``pool`` points from ``draw(pool) -> (positions, views)``, the
    ``num`` farthest from every ReLU boundary of the twin's forward (the
    largest :func:`relu_margin`), in the order drawn, and the smallest
    margin among them.

    A check that gives such points a cotangent holds every one of them,
    and the farther they lie from a boundary, the less likely the
    kernel's rounding and its twin's put one on opposite sides of a
    ReLU mask."""
    positions, views = draw(pool)
    margin = relu_margin(weights, positions, views)
    keep = margin.topk(num).indices.sort().values
    return positions[keep], views[keep], margin[keep].min().item()


def fused_nerf_backward_reference(weights: FusedNeRFWeights,
                                  positions: torch.Tensor,
                                  views: torch.Tensor, g: torch.Tensor,
                                  moved: Optional[str] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of K2.

    Recomputes the fused forward (rounding where K1 rounds) and
    backpropagates the (N, 4) f32 cotangent ``g`` of the logits [r, g,
    b, opacity]. Every ``dz`` is cast to the working type before it
    feeds the next product; the head products take ``g`` in f32.

    ``moved``, one of :data:`MOVED_BACKWARD_ROUNDINGS`, moves one
    rounding point of a bf16 pack (a control that K2's bf16 limits
    must reject): every ``dz`` left in f32, or ``g`` rounded to bf16
    before the head products.

    Returns:
        (d_weights, d_biases): f32 flat buffers in the pack's layout.
    """
    if moved is not None and moved not in MOVED_BACKWARD_ROUNDINGS:
        raise ValueError(f"moved must be one of {MOVED_BACKWARD_ROUNDINGS}, "
                         f"got {moved!r}")
    dtype = weights.weights.dtype
    layers = weights.layers
    num_layers = weights.num_layers
    channels = weights.channels
    inputs, zs, h, hidden_in, hidden_z = _recompute(weights, positions, views)
    hidden = torch.relu(hidden_z).to(dtype)

    def cast(dz):
        return dz if moved == "uncast-dz" else dz.to(dtype)

    g = g.float()
    if moved == "cast-head-cotangent":
        g = g.to(dtype).float()
    g_color, g_opacity = g[:, :3], g[:, 3:4]
    grads = [None] * (num_layers + 4)
    grads[num_layers + 3] = _head_grad(hidden, g_color)
    color_w = layers[num_layers + 3][0].float()[:, :3]
    dz = cast(torch.where(hidden > 0, g_color @ color_w.T, 0.0))
    grads[num_layers + 2] = _body_grad(hidden_in, dz)
    hidden_w = layers[num_layers + 2][0].float()[:channels]
    d_bottleneck = cast(dz.float() @ hidden_w.T)
    grads[num_layers + 1] = _body_grad(h, d_bottleneck)
    grads[num_layers] = _head_grad(h, g_opacity)
    dh = (d_bottleneck.float() @ layers[num_layers + 1][0].float().T
          + g_opacity @ layers[num_layers][0].float()[:, :1].T)
    for i in range(num_layers - 1, -1, -1):
        dz = cast(torch.where(zs[i] > 0, dh, 0.0))
        grads[i] = _body_grad(inputs[i], dz)
        if i:
            dh = dz.float() @ layers[i][0].float()[:channels].T
    return (torch.cat([w.reshape(-1) for w, _ in grads]),
            torch.cat([b for _, b in grads]))


_LIB = KernelLibrary("fused_nerf_train.cu", "fused_nerf_train_error_string",
                     fused_nerf_backward=(PTR,) * 11 + (LONG, LONG, INT),
                     fused_nerf_backward_scratch_bytes=(PTR, LONG, PTR))


def load_kernel():
    """Builds (first call) and loads K2's library; returns the
    :class:`~.build.BuiltLibrary`."""
    return _LIB.load()


def scratch_bytes(weights: FusedNeRFWeights, num: int,
                  device: torch.device) -> int:
    """Bytes of the bf16 kernel's scratch for ``num`` points on the CUDA
    ``device``, as the kernel's library counts them (``csrc/
    fused_nerf_train.cu::fused_nerf_backward_scratch_bytes``): each of
    its min(tiles, SMs) blocks parks, per warpgroup of 64 points, every
    body layer's h as ceil(C / 64) blocks of 8 KB."""
    out = ctypes.c_longlong(0)
    _LIB.call("fused_nerf_backward_scratch_bytes", device,
              weights.meta.ctypes.data, num, ctypes.addressof(out))
    return out.value


def fused_nerf_backward(weights: FusedNeRFWeights, positions: torch.Tensor,
                        views: torch.Tensor, g: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: f32 gradients of the packed weights and biases.

    CPU tensors run :func:`fused_nerf_backward_reference`. CUDA tensors
    launch the kernel on the current stream (building it on first use)
    or raise; each launch adds one to ``fused_nerf_backward.launches``.
    A bf16 pack launches the wgmma kernel on its slab image, with a
    scratch buffer allocated here (:func:`scratch_bytes`) in which its
    tiles park their activations; a bf16 model whose activation blocks
    and two ring stages do not fit in a block's shared memory makes the
    launch raise (``csrc/fused_nerf_train.cu::bf16_shared_bytes``). An
    f32 pack launches the FFMA tile on its flat weights.
    """
    if not on_cuda(positions, "fused NeRF backward"):
        return fused_nerf_backward_reference(weights, positions, views, g)
    _check_cuda_inputs(weights, positions, views)
    num = positions.shape[0]
    if g.dtype != torch.float32 or g.shape != (num, 4) \
            or not g.is_contiguous() or g.device != positions.device:
        raise ValueError(f"the cotangent must be a contiguous (N, 4) float32 "
                         f"tensor beside the positions, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    device = positions.device
    d_weights = torch.zeros(weights.weights.numel(), dtype=torch.float32,
                            device=device)
    d_biases = torch.zeros(weights.biases.numel(), dtype=torch.float32,
                           device=device)
    if num == 0:
        return d_weights, d_biases
    flat, scratch = weights.weights, None
    if weights.slabs is not None:
        flat = weights.slabs
        scratch = torch.empty(scratch_bytes(weights, num, device),
                              dtype=torch.uint8, device=device)
    _LIB.launch(fused_nerf_backward, "fused_nerf_backward", device,
                positions.data_ptr(), views.data_ptr(),
                weights.pos_enc.data_ptr(), weights.view_enc.data_ptr(),
                flat.data_ptr(), weights.biases.data_ptr(),
                weights.meta.ctypes.data, g.data_ptr(), d_weights.data_ptr(),
                d_biases.data_ptr(),
                0 if scratch is None else scratch.data_ptr(),
                0 if scratch is None else scratch.numel(), num,
                _DTYPE_CODES[weights.weights.dtype])
    return d_weights, d_biases


fused_nerf_backward.launches = 0


class FusedNeRFTrain(torch.autograd.Function):
    """Logits of the packed NeRF with the recompute backward: the
    forward keeps only positions and views (no activations); the
    backward recomputes the forward inside K2. Positions and views get
    no gradient."""

    @staticmethod
    def forward(ctx, weights_flat, biases_flat, positions, views, packed):
        del weights_flat, biases_flat   # the same buffers, inside `packed`
        ctx.packed = packed
        ctx.save_for_backward(positions, views)
        return fused_nerf_apply(packed, positions, views)

    @staticmethod
    def backward(ctx, g):
        positions, views = ctx.saved_tensors
        packed = ctx.packed
        d_weights, d_biases = fused_nerf_backward(
            packed, positions, views, g.float().contiguous())
        # the weight gradient leaves in the pack's type: a bf16 gradient
        # is rounded once here and returns to the f32 parameters as f32
        return (d_weights.to(packed.weights.dtype), d_biases, None, None,
                None)


def fused_nerf_train_apply(packed: FusedNeRFWeights, positions: torch.Tensor,
                           views: torch.Tensor) -> torch.Tensor:
    """Differentiable fused NeRF forward: (N, 3) positions + views ->
    (N, 4) logits. ``packed`` comes from
    :func:`~.fused_nerf.pack_fused_nerf` under autograd, so the
    gradients reach the module's parameters."""
    return FusedNeRFTrain.apply(packed.weights, packed.biases,
                                positions.contiguous(), views.contiguous(),
                                packed)
