"""The Hopper fused-NeRF kernel against its plain twin, on a CUDA card.

Every test here needs a card and skips without one (the kernel has no
CPU mode). The file imports no jax, so it also runs on a machine that
has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernel_cuda.py
"""

import numpy as np
import pytest
import torch

from fourier_feature_nets_torch.kernels import fused_nerf as port
from fourier_feature_nets_torch.kernels import fused_nerf_train as train
from fourier_feature_nets_torch.models import NeRF, flagship_nerf
from fourier_feature_nets_torch.render import Raycaster, RaySampler

SMALL = dict(num_layers=4, num_channels=64, max_log_scale_pos=9.0,
             num_freq_pos=10, max_log_scale_view=3.0, num_freq_view=4,
             skips=[2], include_inputs=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(num, device, seed=3):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.5, 1.5, (num, 3)).astype(np.float32)
    views = rng.normal(size=(num, 3)).astype(np.float32)
    views /= np.linalg.norm(views, axis=-1, keepdims=True)
    return torch.from_numpy(pos).to(device), torch.from_numpy(views).to(device)


def _assert_matches_twin(weights, pos, views):
    before = port.fused_nerf_apply.launches
    with torch.no_grad():
        out = port.fused_nerf_apply(weights, pos, views)
        twin = port.fused_nerf_reference(weights, pos, views)
    torch.cuda.synchronize()
    assert port.fused_nerf_apply.launches == before + 1
    assert out.shape == (pos.shape[0], 4)
    if weights.weights.dtype == torch.float32:
        torch.testing.assert_close(out, twin, rtol=1e-3, atol=2e-4)
    else:
        torch.testing.assert_close(out, twin, rtol=0, atol=0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("num", [1, 63, 1000, 4099])
def test_small_model_matches_twin(cuda, dtype, num):
    model = NeRF(**SMALL, generator=torch.Generator().manual_seed(1)).to(cuda)
    _assert_matches_twin(port.prepare_fused_nerf(model, dtype),
                         *_inputs(num, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("config", [
    dict(num_layers=2, num_channels=32, skips=[], include_inputs=False),
    dict(num_layers=3, num_channels=96, skips=[1, 2], include_inputs=True),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_structural_configs_match_twin(cuda, config, dtype):
    model = NeRF(max_log_scale_pos=6.0, num_freq_pos=7,
                 max_log_scale_view=2.0, num_freq_view=3, **config,
                 generator=torch.Generator().manual_seed(2)).to(cuda)
    _assert_matches_twin(port.prepare_fused_nerf(model, dtype),
                         *_inputs(777, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flagship_matches_twin(cuda, dtype):
    model = flagship_nerf(torch.Generator().manual_seed(0)).to(cuda)
    _assert_matches_twin(port.prepare_fused_nerf(model, dtype),
                         *_inputs(50_001, cuda))


@pytest.mark.cuda
def test_empty_batch_launches_nothing(cuda):
    model = NeRF(**SMALL).to(cuda)
    weights = port.prepare_fused_nerf(model, torch.bfloat16)
    pos = torch.zeros(0, 3, device=cuda)
    before = port.fused_nerf_apply.launches
    out = port.fused_nerf_apply(weights, pos, pos)
    assert out.shape == (0, 4)
    assert port.fused_nerf_apply.launches == before


@pytest.mark.cuda
def test_mixed_devices_raise(cuda):
    model = NeRF(**SMALL)
    weights = port.prepare_fused_nerf(model, torch.bfloat16)   # on the CPU
    pos, views = _inputs(8, cuda)
    with pytest.raises(ValueError, match="weights is on cpu"):
        port.fused_nerf_apply(weights, pos, views)


@pytest.mark.cuda
def test_fused_frame_matches_plain_frame(cuda):
    from fourier_feature_nets_torch.cameras import Resolution
    from fourier_feature_nets_torch.utils import orbit
    model = NeRF(**SMALL, generator=torch.Generator().manual_seed(3)).to(cuda)
    cameras = orbit(np.array([0, 1, 0]), np.array([0, 0, 1]), 2, 40.0,
                    Resolution(32, 32), 3.0)
    sampler = RaySampler(np.diag([2.0, 2.0, 2.0, 1.0]), cameras, 16, cuda)
    fused = Raycaster(model, compute_dtype=torch.bfloat16)
    assert fused.fused
    plain = Raycaster(model, compute_dtype=torch.bfloat16, fused=False)
    a = fused.render_frame(sampler, 1).astype(int)
    b = plain.render_frame(sampler, 1).astype(int)
    assert np.abs(a - b).max() <= 1


# ---------------------------------------------------------------------------
# K2: the recompute backward against its plain twin
# ---------------------------------------------------------------------------


# per-leaf bound on max|kernel - twin| as a share of max|twin|, by cotangent;
# chip_smoke.py's GRAD_SHARE says what each holds and what it reads at the
# flagship. random: a cancelling sum, in which a few terms that differ (in
# f32, ReLU-mask flips) stand out: up to 1.43e-2 here. margin (f32): random
# with zero cotangent on the points near a ReLU boundary; same-sign: sums
# that do not cancel; tail: only the ragged last tile and one full tile.
GRAD_SHARE = {"random": {torch.float32: 2e-2, torch.bfloat16: 2e-2},
              "margin": {torch.float32: 5e-5},
              "same-sign": {torch.float32: 3e-4, torch.bfloat16: 2e-3},
              "tail": {torch.float32: 2e-5, torch.bfloat16: 1e-2}}
MARGIN = 1e-6
GROUP = 32    # K2's bf16 tile, two of its f32 tiles


def _cotangent(kind, weights, pos, views, seed=5):
    """(N, 4) f32 cotangent of the given kind, from a seed."""
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.normal(size=(pos.shape[0], 4)).astype(
        np.float32)).to(pos.device)
    num = pos.shape[0]
    keep = torch.ones(num, dtype=torch.bool, device=pos.device)
    if kind == "same-sign":
        return torch.ones_like(g)
    if kind == "margin":
        keep = train.relu_margin(weights, pos, views) >= MARGIN
    elif kind == "tail":
        keep[:] = False
        keep[num - (num % GROUP or GROUP):] = True
        keep[num // GROUP // 2 * GROUP:][:GROUP] = True
    return torch.where(keep[:, None], g, 0.0)


def _assert_backward_matches_twin(weights, pos, views, kind="random"):
    g = _cotangent(kind, weights, pos, views)
    before = train.fused_nerf_backward.launches
    out = train.fused_nerf_backward(weights, pos, views, g)
    twin = train.fused_nerf_backward_reference(weights, pos, views, g)
    torch.cuda.synchronize()
    assert train.fused_nerf_backward.launches == before + 1
    share = GRAD_SHARE[kind][weights.weights.dtype]
    for (name, a), (_, b) in zip(weights.split_flat(*out),
                                 weights.split_flat(*twin)):
        assert torch.isfinite(a).all(), name
        bound = share * b.abs().max().item() + 1e-6
        assert (a - b).abs().max().item() <= bound, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("num", [1, 33, 1000])
def test_backward_small_model_matches_twin(cuda, dtype, num):
    model = NeRF(**SMALL, generator=torch.Generator().manual_seed(1)).to(cuda)
    _assert_backward_matches_twin(port.prepare_fused_nerf(model, dtype),
                                  *_inputs(num, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("config", [
    dict(num_layers=2, num_channels=32, skips=[], include_inputs=False),
    dict(num_layers=3, num_channels=96, skips=[1, 2], include_inputs=True),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_structural_configs_match_twin(cuda, config, dtype):
    model = NeRF(max_log_scale_pos=6.0, num_freq_pos=7,
                 max_log_scale_view=2.0, num_freq_view=3, **config,
                 generator=torch.Generator().manual_seed(2)).to(cuda)
    _assert_backward_matches_twin(port.prepare_fused_nerf(model, dtype),
                                  *_inputs(777, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_flagship_ragged_matches_twin(cuda, dtype):
    model = flagship_nerf(torch.Generator().manual_seed(0)).to(cuda)
    _assert_backward_matches_twin(port.prepare_fused_nerf(model, dtype),
                                  *_inputs(20_011, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_flagship_coherent_cotangent(cuda, dtype):
    """With a same-sign cotangent the gradient sums do not cancel, so an
    odd ReLU-mask flip or dz rounding is a small share of them: the
    kernel must then sit much closer to its twin."""
    model = flagship_nerf(torch.Generator().manual_seed(0)).to(cuda)
    _assert_backward_matches_twin(port.prepare_fused_nerf(model, dtype),
                                  *_inputs(20_011, cuda), kind="same-sign")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, kind", [(torch.bfloat16, "tail"),
                                         (torch.float32, "tail"),
                                         (torch.float32, "margin")])
def test_backward_flagship_ragged_tight_cotangents(cuda, dtype, kind):
    """At a ragged N, with only the ragged last tile and one full tile
    given a cotangent (tail), or in f32 with the points near a ReLU
    boundary given none (margin), K2 must agree with its twin to
    rounding."""
    model = flagship_nerf(torch.Generator().manual_seed(0)).to(cuda)
    _assert_backward_matches_twin(port.prepare_fused_nerf(model, dtype),
                                  *_inputs(20_011, cuda), kind=kind)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, None])
def test_fused_train_step_matches_plain_step(cuda, dtype):
    """One train step's loss and parameter gradients through K1 + K2
    against the plain model under autograd."""
    model = NeRF(**SMALL, generator=torch.Generator().manual_seed(4)).to(cuda)
    pos, views = _inputs(4096, cuda)
    target = torch.rand(4096, 4, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(0))
    grads = {}
    for fused in (True, False):
        model.zero_grad()
        if fused:
            packed = port.pack_fused_nerf(model, dtype or torch.float32)
            out = train.fused_nerf_train_apply(packed, pos, views)
        else:
            out = model(pos, views, compute_dtype=dtype)
        loss = torch.mean(torch.square(torch.sigmoid(out) - target))
        loss.backward()
        grads[fused] = (loss.item(), [p.grad.clone() for p in
                                      model.parameters()])
    assert grads[True][0] == pytest.approx(grads[False][0], rel=1e-3)
    share = 1e-3 if dtype is None else 5e-2
    for a, b in zip(grads[True][1], grads[False][1]):
        bound = share * b.abs().max().item() + 1e-7
        assert (a - b).abs().max().item() <= bound
