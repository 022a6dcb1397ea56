"""The fused recompute-backward's plain twin (K2's counterpart in
``fourier_feature_nets_torch.kernels.fused_nerf_train``) against the JAX
package's Pallas training kernels (interpret mode on the CPU), JAX
autodiff and torch autograd, and the differentiable weight pack. The
Hopper kernel itself is held against the twin on a card by
tests/test_torch_kernel_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourier_feature_nets_torch.kernels import fused_nerf as port_fwd
from fourier_feature_nets_torch.kernels import fused_nerf_train as port
from fourier_feature_nets_torch.models import NeRF as TorchNeRF
from fourier_feature_nets_torch.models import params_from_jax, params_to_jax
from fourier_feature_nets_tpu.models import NeRF
from fourier_feature_nets_tpu.models.serialization import _flatten
from fourier_feature_nets_tpu.ops.fused_nerf_train import (
    fused_nerf_train_apply,
    model_statics,
    pack_fused_nerf,
)
from fourier_feature_nets_tpu.ops.fused_nerf_train_fm import (
    fused_nerf_train_apply_fm,
    model_statics_fm,
    pack_fused_nerf_fm,
)

SMALL = dict(num_layers=4, num_channels=32, max_log_scale_pos=4.0,
             num_freq_pos=5, max_log_scale_view=2.0, num_freq_view=3,
             skips=[2], include_inputs=True)
NUM = 300          # not a multiple of the JAX tile: a ragged tail
TILE = 128
# weight gradients, f32 (tests/test_fused_train_fm.py:71)
F32_RTOL, F32_ATOL = 2e-3, 2e-4
# bf16, per leaf: max|port - jax| <= BF16_SHARE * max|jax|
BF16_SHARE = 2e-2
# K2 bf16, per leaf: mean|kernel - twin| <= BF16_MEAN_SHARE * mean|twin|
# (readings at chip_smoke.py's GRAD_SHARE), a limit that each twin with a
# rounding point moved must fail
BF16_MEAN_SHARE = port.K2_BF16_MEAN_SHARE


def _pair(config, seed=0):
    model = NeRF(**config)
    params = model.init(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    return model, params, params_from_jax(TorchNeRF(**config), flat)


def _inputs(num, seed=3):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.0, 1.0, (num, 3)).astype(np.float32)
    views = rng.normal(size=(num, 3)).astype(np.float32)
    views /= np.linalg.norm(views, axis=-1, keepdims=True)
    g = rng.normal(size=(num, 4)).astype(np.float32)
    return pos, views, g


@pytest.fixture(scope="module")
def nerf():
    return _pair(SMALL)


@pytest.fixture(scope="module")
def inputs():
    return _inputs(NUM)


def _jax_fused_grads(model, params, dtype, layout, pos, views, g):
    """Parameter gradients of sum(logits * g) through the JAX custom VJP
    (the forward kernel, then ``_bwd_call`` or ``_bwd_call_fm``), in
    interpret mode; the inputs are zero-padded to whole tiles, and the
    padding's zero cotangent adds nothing."""
    pad = (-pos.shape[0]) % TILE
    pos, views, g = (jnp.asarray(np.pad(a, ((0, pad), (0, 0))))
                     for a in (pos, views, g))
    if layout == "rm":
        statics = model_statics(model, dtype)

        def loss(p):
            packed = pack_fused_nerf(model, p, dtype)
            out = fused_nerf_train_apply(statics, packed, pos, views, TILE,
                                         True)
            return jnp.sum(out * g)
    else:
        statics = model_statics_fm(model, dtype)

        def loss(p):
            packed = pack_fused_nerf_fm(model, p, dtype)
            out = fused_nerf_train_apply_fm(statics, packed, pos, views,
                                            TILE, True)
            return jnp.sum(out * g)

    grads = jax.grad(loss)(params)
    return {k: np.asarray(v, np.float32) for k, v in _flatten(grads).items()}


def _port_fused_grads(torch_model, dtype, pos, views, g):
    """The same gradients through the port's differentiable pack and
    FusedNeRFTrain (the twin backward on the CPU), in the JAX layout."""
    torch_model.zero_grad()
    packed = port_fwd.pack_fused_nerf(torch_model, dtype)
    out = port.fused_nerf_train_apply(packed, torch.from_numpy(pos),
                                      torch.from_numpy(views))
    torch.sum(out * torch.from_numpy(g)).backward()
    return _grads_in_jax_layout(torch_model)


def _grads_in_jax_layout(torch_model):
    grads = {}
    for key, value in params_to_jax(torch_model).items():
        path, field = key.rsplit("/", 1)
        layer = torch_model
        for part in path.split("/"):
            layer = layer[int(part)] if part.isdigit() else getattr(layer,
                                                                     part)
        grad = getattr(layer, field).grad.numpy()
        grads[key] = grad.T if field == "weight" else grad
        assert grads[key].shape == value.shape, key
    return grads


def _assert_grads_close(ours, ref, dtype):
    assert sorted(ours) == sorted(ref)
    for key in ref:
        if dtype == jnp.float32:
            np.testing.assert_allclose(ours[key], ref[key], rtol=F32_RTOL,
                                       atol=F32_ATOL, err_msg=key)
        else:
            bound = BF16_SHARE * np.abs(ref[key]).max()
            assert np.abs(ours[key] - ref[key]).max() <= bound, key


@pytest.mark.parametrize("layout", ["rm", "fm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twin_backward_matches_pallas(nerf, inputs, layout, dtype):
    """K2's twin against ``_bwd_call`` (row-major, K2) and
    ``_bwd_call_fm`` (feature-major, K2-fm) in interpret mode."""
    model, params, torch_model = nerf
    jax_dtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = _jax_fused_grads(model, params, jax_dtype, layout, *inputs)
    ours = _port_fused_grads(torch_model, getattr(torch, dtype), *inputs)
    _assert_grads_close(ours, ref, jax_dtype)


def _mean_share(ours, ref):
    """The largest per-leaf mean|ours - ref| / mean|ref|."""
    return max(np.abs(ours[key] - ref[key]).mean()
               / max(np.abs(ref[key]).mean(), 1e-30) for key in ref)


@pytest.fixture(scope="module")
def bf16_pallas_grads(nerf, inputs):
    model, params, _ = nerf
    return _jax_fused_grads(model, params, jnp.bfloat16, "rm", *inputs)


def _moved_twin_grads(torch_model, moved, pos, views, g):
    """The port's bf16 gradients through the twin with a rounding point
    moved, in the JAX layout."""
    torch_model.zero_grad()
    packed = port_fwd.pack_fused_nerf(torch_model, torch.bfloat16)
    with torch.no_grad():
        d_w, d_b = port.fused_nerf_backward_reference(
            packed, torch.from_numpy(pos), torch.from_numpy(views),
            torch.from_numpy(g), moved)
    # the pack's flat gradients reach the parameters through autograd
    torch.autograd.backward([packed.weights, packed.biases],
                            [d_w.to(torch.bfloat16), d_b])
    return _grads_in_jax_layout(torch_model)


@pytest.mark.parametrize("moved", port.MOVED_BACKWARD_ROUNDINGS)
def test_k2_limits_reject_a_moved_rounding_point(nerf, inputs,
                                                 bf16_pallas_grads, moved):
    """Against ``_bwd_call`` in interpret mode the twin lies within K2's
    bf16 mean limit, and the twin with one rounding point moved lies
    beyond it, farther than the twin by a wide margin."""
    _, _, torch_model = nerf
    twin = _mean_share(_moved_twin_grads(torch_model, None, *inputs),
                       bf16_pallas_grads)
    wrong = _mean_share(_moved_twin_grads(torch_model, moved, *inputs),
                        bf16_pallas_grads)
    assert twin <= BF16_MEAN_SHARE < wrong
    assert wrong > 100 * twin


def test_moved_backward_rounding_changes_only_bf16_and_is_checked(nerf,
                                                                  inputs):
    _, _, torch_model = nerf
    pos, views, g = (torch.from_numpy(a) for a in inputs)
    weights = port_fwd.prepare_fused_nerf(torch_model, torch.float32)
    plain = port.fused_nerf_backward_reference(weights, pos, views, g)
    for moved in port.MOVED_BACKWARD_ROUNDINGS:
        for a, b in zip(port.fused_nerf_backward_reference(
                weights, pos, views, g, moved), plain):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="moved must be one of"):
        port.fused_nerf_backward_reference(weights, pos, views, g, "cast-x")


def _jax_autodiff_grads(model, params, pos, views, g):
    def loss(p):
        return jnp.sum(model.apply(p, jnp.asarray(pos), jnp.asarray(views))
                       * jnp.asarray(g))
    grads = jax.grad(loss)(params)
    return {k: np.asarray(v) for k, v in _flatten(grads).items()}


@pytest.mark.parametrize("config", [
    dict(num_layers=2, num_channels=32, skips=[], include_inputs=True),
    dict(num_layers=3, num_channels=48, skips=[1, 2], include_inputs=True),
    dict(num_layers=3, num_channels=32, skips=[2], include_inputs=False),
], ids=["no_skips", "double_skip", "no_raw_inputs"])
def test_twin_backward_structural_sweep(config, inputs):
    """The twin re-derives the skip/encode structure independently of
    the forward: no skips, two skips, raw inputs off, each against JAX
    autodiff of the plain model in f32."""
    config = dict(max_log_scale_pos=4.0, num_freq_pos=5,
                  max_log_scale_view=2.0, num_freq_view=3, **config)
    model, params, torch_model = _pair(config, seed=6)
    ref = _jax_autodiff_grads(model, params, *inputs)
    ours = _port_fused_grads(torch_model, torch.float32, *inputs)
    _assert_grads_close(ours, ref, jnp.float32)


def test_twin_backward_matches_torch_autograd(nerf, inputs):
    """f32: the explicit backward against torch autograd of the plain
    NeRF module."""
    _, _, torch_model = nerf
    pos, views, g = (torch.from_numpy(a) for a in inputs)
    ours = _port_fused_grads(torch_model, torch.float32, *inputs)
    torch_model.zero_grad()
    torch.sum(torch_model(pos, views) * g).backward()
    ref = _grads_in_jax_layout(torch_model)
    _assert_grads_close(ours, ref, jnp.float32)


def test_twin_backward_layout_and_zero_cotangent(nerf, inputs):
    """The flat gradients have the pack's layout; head padding columns
    and a zero cotangent give zero gradients."""
    _, _, torch_model = nerf
    pos, views, g = (torch.from_numpy(a) for a in inputs)
    weights = port_fwd.prepare_fused_nerf(torch_model, torch.float32)
    d_w, d_b = port.fused_nerf_backward(weights, pos, views, g)
    assert d_w.shape == weights.weights.shape and d_w.dtype == torch.float32
    assert d_b.shape == weights.biases.shape
    leaves = dict(weights.split_flat(d_w, d_b))
    color = leaves[f"w{weights.num_layers + 3}"].view(-1, port_fwd.HEAD_WIDTH)
    assert torch.count_nonzero(color[:, 3:]) == 0
    assert torch.count_nonzero(color[:, :3]) > 0
    zero_w, zero_b = port.fused_nerf_backward(weights, pos, views,
                                              torch.zeros_like(g))
    assert torch.count_nonzero(zero_w) == 0
    assert torch.count_nonzero(zero_b) == 0


def test_split_flat_names_every_packed_leaf(nerf):
    """split_flat cuts two flat buffers along the pack's offset table:
    the pack's own buffers give back its layers, in packing order."""
    _, _, torch_model = nerf
    weights = port_fwd.prepare_fused_nerf(torch_model, torch.bfloat16)
    leaves = weights.split_flat(weights.weights, weights.biases)
    count = weights.num_layers + 4
    assert [name for name, _ in leaves] == [
        f"{kind}{i}" for i in range(count) for kind in "wb"]
    for i, (w, b) in enumerate(weights.layers):
        assert torch.equal(leaves[2 * i][1], w.reshape(-1))
        assert torch.equal(leaves[2 * i + 1][1], b)


def test_relu_margin_is_smallest_pre_activation(nerf, inputs):
    """relu_margin is each point's smallest |pre-activation| over the
    body and hidden layers, here against the plain module in f32 (the
    twin's polynomial sin/cos differs from torch's by ~1e-6)."""
    _, _, torch_model = nerf
    pos, views, _ = (torch.from_numpy(a) for a in inputs)
    weights = port_fwd.prepare_fused_nerf(torch_model, torch.float32)
    margin = port.relu_margin(weights, pos, views)
    zs = []
    with torch.no_grad():
        enc = torch_model._encode(pos, torch_model.pos_encoding)
        h = enc
        for i, layer in enumerate(torch_model.layers):
            if i in torch_model.skips:
                h = torch.cat([h, enc], -1)
            zs.append(layer(h))
            h = torch.relu(zs[-1])
        hidden_in = torch.cat([torch_model.bottleneck(h), torch_model._encode(
            views, torch_model.view_encoding)], -1)
        zs.append(torch_model.hidden_view(hidden_in))
    ref = torch.stack([z.abs().amin(-1) for z in zs]).amin(0)
    assert margin.shape == (NUM,) and margin.dtype == torch.float32
    torch.testing.assert_close(margin, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_far_from_relu_keeps_the_points_with_the_largest_margins(nerf, dtype):
    """Of the pool drawn, the points kept are those with the largest
    ReLU margins, in the order drawn, with the least of those margins."""
    _, _, torch_model = nerf
    weights = port_fwd.prepare_fused_nerf(torch_model, dtype)
    pos, views, _ = (torch.from_numpy(a) for a in _inputs(NUM))
    margin = port.relu_margin(weights, pos, views)
    calls = []

    def draw(n):
        calls.append(n)
        return pos[:n], views[:n]

    kept_pos, kept_views, least = port.far_from_relu(weights, 40, NUM, draw)
    assert calls == [NUM]
    keep = margin.argsort(descending=True)[:40].sort().values
    assert torch.equal(kept_pos, pos[keep])
    assert torch.equal(kept_views, views[keep])
    assert least == margin[keep].min().item()
    assert least >= margin.quantile(1 - 40 / NUM).item() - 1e-12


def test_leaf_mean_share_is_the_worst_leaf(nerf, inputs):
    _, _, torch_model = nerf
    weights = port_fwd.prepare_fused_nerf(torch_model, torch.float32)
    pos, views, g = (torch.from_numpy(a) for a in inputs)
    twin = port.fused_nerf_backward_reference(weights, pos, views, g)
    assert port.leaf_mean_share(weights, twin, twin) == 0.0
    d_weights, d_biases = twin[0].clone(), twin[1].clone()
    leaf = weights.split_flat(d_weights, d_biases)[-1][1]
    leaf.mul_(1.5)   # a view into d_biases: that leaf alone moves by half
    assert port.leaf_mean_share(weights, (d_weights, d_biases), twin) \
        == pytest.approx(0.5, rel=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_is_differentiable(dtype):
    """The pack carries autograd back to every module parameter, with
    f32 gradients; the render-time pack is detached and equal."""
    torch_model = TorchNeRF(**SMALL,
                            generator=torch.Generator().manual_seed(2))
    packed = port_fwd.pack_fused_nerf(torch_model, dtype)
    assert packed.weights.dtype == dtype and packed.weights.requires_grad
    assert packed.biases.requires_grad
    detached = port_fwd.prepare_fused_nerf(torch_model, dtype)
    assert not detached.weights.requires_grad
    assert torch.equal(detached.weights, packed.weights.detach())
    assert torch.equal(detached.biases, packed.biases.detach())
    pos, views, g = (torch.from_numpy(a) for a in _inputs(64))
    out = port.fused_nerf_train_apply(packed, pos, views)
    torch.sum(out * g).backward()
    for name, param in torch_model.named_parameters():
        assert param.grad is not None, name
        assert param.grad.dtype == torch.float32, name
        assert torch.count_nonzero(param.grad) > 0, name


def test_forward_value_and_no_input_gradient(nerf, inputs):
    """The differentiable forward returns K1's twin's logits; positions
    and views get no gradient."""
    _, _, torch_model = nerf
    pos, views, _ = (torch.from_numpy(a) for a in inputs)
    pos.requires_grad_(True)
    packed = port_fwd.pack_fused_nerf(torch_model, torch.float32)
    out = port.fused_nerf_train_apply(packed, pos, views)
    with torch.no_grad():
        ref = port_fwd.fused_nerf_reference(packed, pos, views)
    torch.testing.assert_close(out.detach(), ref, rtol=0, atol=0)
    out.sum().backward()
    assert pos.grad is None


def test_cpu_call_never_touches_the_kernel(nerf, inputs):
    """On CPU tensors the wrapper runs the twin and counts no launch,
    neither of K2 nor of its dW kernel."""
    _, _, torch_model = nerf
    before = (port.fused_nerf_backward.launches,
              port.fused_nerf_backward.dw_launches)
    weights = port_fwd.prepare_fused_nerf(torch_model, torch.bfloat16)
    pos, views, g = (torch.from_numpy(a) for a in inputs)
    port.fused_nerf_backward(weights, pos, views, g)
    assert (port.fused_nerf_backward.launches,
            port.fused_nerf_backward.dw_launches) == before
