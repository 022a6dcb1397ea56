"""Fused NeRF training: the recompute-backward Hopper kernel and its twin.

The CUDA kernel (``csrc/fused_nerf_train.cu``) replaces the TPU Pallas
kernels ``fourier_feature_nets_tpu/ops/fused_nerf_train.py::_bwd_kernel``
and ``ops/fused_nerf_train_fm.py::_bwd_kernel_fm`` (the same function in
two layouts). Given positions, views, the packed weights and the (N, 4)
f32 cotangent of the logits, it recomputes the forward on chip and
returns the f32 gradient of every packed weight and bias. The source
comment says what bounds it on an H100.

* :func:`fused_nerf_train_apply` is the differentiable forward: the
  packed weights from :func:`~.fused_nerf.pack_fused_nerf` (built from
  the live parameters) go through :class:`FusedNeRFTrain`, whose
  forward launches K1 (:func:`~.fused_nerf.fused_nerf_apply`) and whose
  backward launches K2 (:func:`fused_nerf_backward`).
* :func:`fused_nerf_backward_reference` is the plain PyTorch twin of
  K2: an explicit backward with the kernel's rounding points, not
  autograd through :func:`~.fused_nerf.fused_nerf_reference`.
  :func:`relu_margin` says how close each point comes to a ReLU mask
  boundary in it, which the kernel's checks use.
* :func:`fused_nerf_backward` launches the kernel for CUDA tensors and
  runs the twin for CPU tensors. A CUDA call launches the kernel or
  raises; it never falls back.
"""

from typing import Tuple

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

__all__ = ["FusedNeRFTrain", "fused_nerf_backward",
           "fused_nerf_backward_reference", "fused_nerf_train_apply",
           "load_kernel", "relu_margin"]


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


def fused_nerf_backward_reference(weights: FusedNeRFWeights,
                                  positions: torch.Tensor,
                                  views: torch.Tensor, g: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of K2.

    Recomputes the fused forward (rounding where K1 rounds) and
    backpropagates the (N, 4) f32 cotangent ``g`` of the logits [r, g,
    b, opacity]. Every ``dz`` is cast to the working type before it
    feeds the next product; the head products take ``g`` in f32.

    Returns:
        (d_weights, d_biases): f32 flat buffers in the pack's layout.
    """
    dtype = weights.weights.dtype
    layers = weights.layers
    num_layers = weights.num_layers
    channels = weights.channels
    inputs, zs, h, hidden_in, hidden_z = _recompute(weights, positions, views)
    hidden = torch.relu(hidden_z).to(dtype)

    g = g.float()
    g_color, g_opacity = g[:, :3], g[:, 3:4]
    grads = [None] * (num_layers + 4)
    grads[num_layers + 3] = _head_grad(hidden, g_color)
    color_w = layers[num_layers + 3][0].float()[:, :3]
    dz = torch.where(hidden > 0, g_color @ color_w.T, 0.0).to(dtype)
    grads[num_layers + 2] = _body_grad(hidden_in, dz)
    hidden_w = layers[num_layers + 2][0].float()[:channels]
    d_bottleneck = (dz.float() @ hidden_w.T).to(dtype)
    grads[num_layers + 1] = _body_grad(h, d_bottleneck)
    grads[num_layers] = _head_grad(h, g_opacity)
    dh = (d_bottleneck.float() @ layers[num_layers + 1][0].float().T
          + g_opacity @ layers[num_layers][0].float()[:, :1].T)
    for i in range(num_layers - 1, -1, -1):
        dz = torch.where(zs[i] > 0, dh, 0.0).to(dtype)
        grads[i] = _body_grad(inputs[i], dz)
        if i:
            dh = dz.float() @ layers[i][0].float()[:channels].T
    return (torch.cat([w.reshape(-1) for w, _ in grads]),
            torch.cat([b for _, b in grads]))


_LIB = KernelLibrary("fused_nerf_train.cu", "fused_nerf_train_error_string",
                     fused_nerf_backward=(PTR,) * 10 + (LONG, INT))


def load_kernel():
    """Builds (first call) and loads K2's library; returns the
    :class:`~.build.BuiltLibrary`."""
    return _LIB.load()


def fused_nerf_backward(weights: FusedNeRFWeights, positions: torch.Tensor,
                        views: torch.Tensor, g: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: f32 gradients of the packed weights and biases.

    CPU tensors run :func:`fused_nerf_backward_reference`. CUDA tensors
    launch the kernel on the current stream (building it on first use)
    or raise; each launch adds one to ``fused_nerf_backward.launches``.
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
    _LIB.launch(fused_nerf_backward, "fused_nerf_backward", device,
                positions.data_ptr(), views.data_ptr(),
                weights.pos_enc.data_ptr(), weights.view_enc.data_ptr(),
                weights.weights.data_ptr(), weights.biases.data_ptr(),
                weights.meta.ctypes.data, g.data_ptr(), d_weights.data_ptr(),
                d_biases.data_ptr(), num, _DTYPE_CODES[weights.weights.dtype])
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
