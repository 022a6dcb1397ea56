"""The Hopper kernels (K1, K2, K3, T1's scan, the int8 probe's P1a-c,
the ablation P2 in all its modes and the copy kernels P3a-c) against
their plain twins, on a CUDA card, and their launch path (counts, CUDA
graph capture).

Every test here needs a card and skips without one (the kernel has no
CPU mode). The file imports no jax, so it also runs on a machine that
has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernel_cuda.py
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from fourier_feature_nets_torch.cli import kernel_io_floor_bench
from fourier_feature_nets_torch.kernels import fused_nerf as port
from fourier_feature_nets_torch.kernels import fused_nerf_ablation as ablation
from fourier_feature_nets_torch.kernels import fused_nerf_train as train
from fourier_feature_nets_torch.kernels import int8_probe as probe
from fourier_feature_nets_torch.kernels import io_floor as io
from fourier_feature_nets_torch.kernels.fused_ray_render import (
    K3_BF16_ATOL,
    K3_BF16_MEAN_ATOL,
    K3_F32_MEAN_ATOL,
    MEAN_RAYS,
    exclusive_cumprod_scan,
    fused_ray_render,
    fused_ray_render_reference,
    launch_ray_group,
)
from fourier_feature_nets_torch.models import NeRF, flagship_nerf
from fourier_feature_nets_torch.ops import exclusive_cumprod
from fourier_feature_nets_torch.render import Raycaster, RaySampler, RaySamples

SMALL = dict(num_layers=4, num_channels=64, max_log_scale_pos=9.0,
             num_freq_pos=10, max_log_scale_view=3.0, num_freq_view=4,
             skips=[2], include_inputs=True)
# P2 bf16-accum, max and mean |kernel - twin| (readings and reasons at
# chip_smoke.py, ACCUM_ATOL)
ACCUM_ATOL, ACCUM_MEAN_ATOL = 4e-3, 5e-6
# K1 bf16, max and mean |kernel - twin| (readings and reasons at
# chip_smoke.py, K1_BF16_ATOL); the mean is held from MEAN_POINTS points
# on, below which one point's difference can carry it
K1_BF16_ATOL, K1_BF16_MEAN_ATOL = 4e-3, 5e-6
# K1 f32 (3xTF32), mean |kernel - twin| besides the JAX suite's rtol / atol
# (readings and reasons at chip_smoke.py, K1_F32_MEAN_ATOL), a limit the twin
# on single tf32 products must fail
K1_F32_MEAN_ATOL = 1e-6
MEAN_POINTS = 1000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _points(rng, num, device):
    pos = rng.uniform(-1.5, 1.5, (num, 3)).astype(np.float32)
    views = rng.normal(size=(num, 3)).astype(np.float32)
    views /= np.linalg.norm(views, axis=-1, keepdims=True)
    return torch.from_numpy(pos).to(device), torch.from_numpy(views).to(device)


def _inputs(num, device, seed=3):
    return _points(np.random.default_rng(seed), num, device)


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
        if pos.shape[0] >= MEAN_POINTS:
            assert (out - twin).abs().mean().item() <= K1_F32_MEAN_ATOL
    else:
        torch.testing.assert_close(out, twin, rtol=0, atol=K1_BF16_ATOL)
        if pos.shape[0] >= MEAN_POINTS:
            assert (out - twin).abs().mean().item() <= K1_BF16_MEAN_ATOL


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


# K1's bf16 wgmma kernel: a persistent grid of 128-point tiles streaming
# the weights through a ring of stages whose mbarrier phases run on across
# layers and tiles, so ragged tiles, a second pass over the grid and many
# tiles a block are where its faults would show.


@pytest.fixture(scope="module")
def flagship_bf16():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    model = flagship_nerf(torch.Generator().manual_seed(0)).cuda()
    return port.prepare_fused_nerf(model, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("num", [1, 127, 128, 129, 4099])
def test_wgmma_tile_edges_match_twin(cuda, flagship_bf16, num):
    _assert_matches_twin(flagship_bf16, *_inputs(num, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", ["one more than the grid", "many a block"])
def test_wgmma_persistent_grid_matches_twin(cuda, flagship_bf16, tiles):
    if tiles == "many a block":
        num = 786_431        # 6144 tiles, the last ragged: ~47 a block
    else:
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        num = sms * 128 + 1  # one point past one tile a block
    _assert_matches_twin(flagship_bf16, *_inputs(num, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("moved", port.MOVED_ROUNDINGS)
@pytest.mark.parametrize("model", ["small", "flagship"])
def test_k1_bf16_limits_reject_a_moved_rounding_point(cuda, flagship_bf16,
                                                      model, moved):
    """The control: against the twin with one rounding point moved, the
    kernel fails the mean limit it holds against its twin."""
    if model == "flagship":
        weights = flagship_bf16
    else:
        weights = port.prepare_fused_nerf(
            NeRF(**SMALL, generator=torch.Generator().manual_seed(1)).to(cuda),
            torch.bfloat16)
    pos, views = _inputs(50_001, cuda)
    _assert_matches_twin(weights, pos, views)
    with torch.no_grad():
        out = port.fused_nerf_apply(weights, pos, views)
        wrong = port.fused_nerf_reference(weights, pos, views, moved)
    assert (out - wrong).abs().mean().item() > K1_BF16_MEAN_ATOL


@pytest.mark.cuda
def test_wgmma_refuses_a_model_too_wide_for_shared_memory(cuda):
    # 256 channels with a 400-wide positional encode: the two warpgroups'
    # activation rows and two ring stages exceed 227 KB
    wide = NeRF(num_layers=2, num_channels=256, max_log_scale_pos=9.0,
                num_freq_pos=64, max_log_scale_view=3.0, num_freq_view=4,
                skips=[], include_inputs=True).to(cuda)
    pos, views = _inputs(64, cuda)
    with torch.no_grad(), pytest.raises(RuntimeError,
                                        match="invalid argument"):
        port.fused_nerf_apply(port.prepare_fused_nerf(wide, torch.bfloat16),
                              pos, views)


@pytest.mark.cuda
def test_wgmma_relaunch_is_bit_equal(cuda, flagship_bf16):
    # no atomics: every point's sums run in one fixed order
    pos, views = _inputs(20_011, cuda)
    with torch.no_grad():
        first = port.fused_nerf_apply(flagship_bf16, pos, views)
        second = port.fused_nerf_apply(flagship_bf16, pos, views)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_wgmma_launch_in_cuda_graph(cuda, flagship_bf16):
    pos, views = _inputs(50_001, cuda)
    with torch.no_grad():
        eager = port.fused_nerf_apply(flagship_bf16, pos, views)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            port.fused_nerf_apply(flagship_bf16, pos, views)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = port.fused_nerf_apply.launches
        with torch.cuda.graph(graph):
            captured = port.fused_nerf_apply(flagship_bf16, pos, views)
        assert port.fused_nerf_apply.launches == before + 1
        captured.zero_()
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


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
# flagship. random: a cancelling sum, in which a few terms that differ (ReLU-
# mask flips) stand out: up to 1.43e-2 here. margin: random with zero
# cotangent on the points within MARGIN of a ReLU boundary; clear (bf16):
# random on the quarter of four times as many points that lie farthest from
# the boundaries; same-sign: sums that do not cancel; tail: only the ragged
# last tile and one full tile, in bf16 on the points farthest from the
# boundaries of K2_BF16_TAIL_POOL drawn for each.
GRAD_SHARE = {"random": {torch.float32: 2e-2, torch.bfloat16: 2e-2},
              "margin": {torch.float32: 5e-5, torch.bfloat16: 2e-2},
              "clear": {torch.bfloat16: 2e-2},
              "same-sign": {torch.float32: 3e-4, torch.bfloat16: 5e-4},
              "tail": {torch.float32: 2e-5, torch.bfloat16: 1e-2}}
MARGIN = {torch.float32: 1e-6, torch.bfloat16: train.K2_BF16_MARGIN}
GROUP = 128   # K2's bf16 tile, two of its f32 tiles
# K2 bf16 runs its two passes a slice of at most this many points at a time
# (csrc/fused_nerf_train.cu::kSlicePoints), one dW launch a slice
SLICE_POINTS = 262_144


def _tail_rows(num, device):
    """The ragged last tile (or the last full one) and one full tile."""
    mid = num // GROUP // 2 * GROUP
    keep = torch.zeros(num, dtype=torch.bool, device=device)
    keep[num - (num % GROUP or GROUP):] = True
    keep[mid:mid + GROUP] = True
    return keep.nonzero()[:, 0]


def _off_boundaries(kind, weights, pos, views, seed=7):
    """In bf16, for the tail and clear cotangents: copies of pos and
    views whose points that the cotangent holds are each the farthest
    from every ReLU boundary of a pool drawn for it."""
    if weights.weights.dtype != torch.bfloat16 or kind not in ("tail",
                                                                "clear"):
        return pos, views
    pos, views = pos.clone(), views.clone()
    num = pos.shape[0]
    rows, pool = ((_tail_rows(num, pos.device), train.K2_BF16_TAIL_POOL)
                  if kind == "tail"
                  else (torch.arange(num, device=pos.device), 4))
    rng = np.random.default_rng(seed)
    pos[rows], views[rows], _ = train.far_from_relu(
        weights, rows.numel(), rows.numel() * pool,
        lambda n: _points(rng, n, pos.device))
    return pos, views


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
        keep = train.relu_margin(weights, pos, views) \
            >= MARGIN[weights.weights.dtype]
    elif kind == "tail":
        keep[:] = False
        keep[_tail_rows(num, pos.device)] = True
    return torch.where(keep[:, None], g, 0.0)


def _assert_backward_matches_twin(weights, pos, views, kind="random"):
    """K2 within GRAD_SHARE[kind] of its twin (in bf16 under the margin
    and tail cotangents also within the mean share); returns its
    gradients and the inputs it ran on."""
    pos, views = _off_boundaries(kind, weights, pos, views)
    g = _cotangent(kind, weights, pos, views)
    before = (train.fused_nerf_backward.launches,
              train.fused_nerf_backward.dw_launches)
    out = train.fused_nerf_backward(weights, pos, views, g)
    twin = train.fused_nerf_backward_reference(weights, pos, views, g)
    torch.cuda.synchronize()
    # one K2 call; in bf16 one dW launch a slice of points, in f32 none
    slices = (-(-pos.shape[0] // SLICE_POINTS)
              if weights.weights.dtype == torch.bfloat16 else 0)
    assert (train.fused_nerf_backward.launches,
            train.fused_nerf_backward.dw_launches) \
        == (before[0] + 1, before[1] + slices)
    share = GRAD_SHARE[kind][weights.weights.dtype]
    for (name, a), (_, b) in zip(weights.split_flat(*out),
                                 weights.split_flat(*twin)):
        assert torch.isfinite(a).all(), name
        bound = share * b.abs().max().item() + 1e-6
        assert (a - b).abs().max().item() <= bound, name
    if weights.weights.dtype == torch.bfloat16 and kind in ("margin", "tail"):
        assert train.leaf_mean_share(weights, out, twin) \
            <= train.K2_BF16_MEAN_SHARE
    return out, pos, views


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
def test_k2_bf16_same_sign_limit_rejects_uncast_dz(cuda, flagship_bf16):
    """Sums that do not cancel carry dz left in f32 past the same-sign
    limit that the kernel holds. (All-ones are exact in bf16, so the twin
    with the heads' cotangent cast is the twin itself here.)"""
    out, pos, views = _assert_backward_matches_twin(
        flagship_bf16, *_inputs(20_011, cuda), kind="same-sign")
    wrong = train.fused_nerf_backward_reference(
        flagship_bf16, pos, views, torch.ones(20_011, 4, device=cuda),
        "uncast-dz")
    share = GRAD_SHARE["same-sign"][torch.bfloat16]
    assert any((a - b).abs().max().item() > share * b.abs().max().item()
               for (_, a), (_, b) in zip(flagship_bf16.split_flat(*out),
                                         flagship_bf16.split_flat(*wrong)))


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


# K2's bf16 wgmma kernels: K1's persistent grid of 128-point tiles, which
# stores each tile's layer inputs and dz in a scratch buffer, then a split-K
# kernel that sums dW over every point in a fixed order, a slice of points
# at a time, so ragged tiles, a second pass over the grid, many tiles a
# block, slices, every channel width and the shared-memory budget are where
# its faults would show.


@pytest.mark.cuda
@pytest.mark.parametrize("num", [1, 127, 128, 129, 4099])
def test_backward_wgmma_tile_edges_match_twin(cuda, flagship_bf16, num):
    _assert_backward_matches_twin(flagship_bf16, *_inputs(num, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", ["one more than the grid", "many a block"])
def test_backward_wgmma_persistent_grid_matches_twin(cuda, flagship_bf16,
                                                     tiles):
    if tiles == "many a block":
        num = 262_143        # 2048 tiles, the last ragged: ~16 a block
    else:
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        num = sms * 128 + 1  # one point past one tile a block
    # random, on points kept off the ReLU boundaries: at 262,143 points the
    # plain random cotangent's flips read up to 2.1e-2 (PERF.md)
    _, pos, views = _assert_backward_matches_twin(
        flagship_bf16, *_inputs(num, cuda), kind="clear")
    # every point's share is the kernel's own, whichever block and pass take
    # its tile: the gradient of all points is the sum of those of two parts
    # split at a tile boundary, up to the order of the f32 sums
    g = _cotangent("random", flagship_bf16, pos, views)
    cut = num // 2 // GROUP * GROUP
    whole = train.fused_nerf_backward(flagship_bf16, pos, views, g)
    parts = [train.fused_nerf_backward(flagship_bf16, pos[s], views[s], g[s])
             for s in (slice(0, cut), slice(cut, num))]
    summed = [a + b for a, b in zip(*parts)]
    for (name, a), (_, b) in zip(flagship_bf16.split_flat(*whole),
                                 flagship_bf16.split_flat(*summed)):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item(), name


@pytest.mark.cuda
@pytest.mark.parametrize("channels, num_freq_pos", [
    *(pytest.param(c, 7, id=str(c))
      for c in (32, 64, 96, 128, 160, 192, 224, 256)),
    pytest.param(256, 20, id="256-pos128")])
def test_backward_wgmma_every_width_matches_twin(cuda, channels,
                                                 num_freq_pos):
    """Every channel width the kernel takes, with a skip layer, raw inputs
    at every other width, under the margin and tail cotangents (random
    ones with no cotangent near a ReLU boundary, or on points picked far
    from one: at 3,001 points one flip can carry a leaf past the random
    limit). The last case widens the positional encode to 128 columns at
    256 channels, which pass 1's shared memory takes (the one-pass kernel
    refused it): two 64-column blocks of features in the skip layer's
    input, for pass 1 and for pass 2."""
    model = NeRF(num_layers=3, num_channels=channels, skips=[2],
                 include_inputs=channels % 64 == 0, max_log_scale_pos=6.0,
                 num_freq_pos=num_freq_pos, max_log_scale_view=2.0,
                 num_freq_view=3,
                 generator=torch.Generator().manual_seed(channels)).to(cuda)
    weights = port.prepare_fused_nerf(model, torch.bfloat16)
    pos, views = _inputs(3001, cuda)
    _assert_backward_matches_twin(weights, pos, views, kind="margin")
    _assert_backward_matches_twin(weights, pos, views, kind="tail")


@pytest.mark.cuda
@pytest.mark.parametrize("moved", train.MOVED_BACKWARD_ROUNDINGS)
@pytest.mark.parametrize("model, kind", [("small", "margin"),
                                         ("flagship width", "margin"),
                                         ("flagship", "tail")])
def test_k2_bf16_limits_reject_a_moved_rounding_point(cuda, model, kind,
                                                      moved):
    """The control: under the margin cotangent (the tail at the flagship's
    depth, where the margin leaves no point) the kernel is within the mean
    limit of its twin, and beyond it from the twin with one rounding point
    moved."""
    if model == "flagship":
        net = flagship_nerf(torch.Generator().manual_seed(0))
    else:
        config = SMALL if model == "small" else train.K2_BF16_CONTROL_MODEL
        net = NeRF(**config, generator=torch.Generator().manual_seed(1))
    weights = port.prepare_fused_nerf(net.to(cuda), torch.bfloat16)
    out, pos, views = _assert_backward_matches_twin(
        weights, *_inputs(20_011, cuda), kind=kind)
    g = _cotangent(kind, weights, pos, views)
    wrong = train.fused_nerf_backward_reference(weights, pos, views, g, moved)
    assert train.leaf_mean_share(weights, out, wrong) \
        > train.K2_BF16_MEAN_SHARE


@pytest.mark.cuda
def test_backward_wgmma_relaunch_agrees(cuda, flagship_bf16):
    # every cross-tile dW sum is taken in a fixed order: two launches give
    # the same gradients bit for bit
    pos, views = _inputs(20_011, cuda)
    g = _cotangent("random", flagship_bf16, pos, views)
    first = train.fused_nerf_backward(flagship_bf16, pos, views, g)
    second = train.fused_nerf_backward(flagship_bf16, pos, views, g)
    torch.cuda.synchronize()
    for (name, a), (_, b) in zip(flagship_bf16.split_flat(*first),
                                 flagship_bf16.split_flat(*second)):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_backward_wgmma_launch_in_cuda_graph(cuda, flagship_bf16):
    pos, views = _inputs(50_001, cuda)
    g = _cotangent("random", flagship_bf16, pos, views)
    eager = train.fused_nerf_backward(flagship_bf16, pos, views, g)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        train.fused_nerf_backward(flagship_bf16, pos, views, g)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (train.fused_nerf_backward.launches,
              train.fused_nerf_backward.dw_launches)
    with torch.cuda.graph(graph):
        captured = train.fused_nerf_backward(flagship_bf16, pos, views, g)
    assert (train.fused_nerf_backward.launches,
            train.fused_nerf_backward.dw_launches) \
        == (before[0] + 1, before[1] + 1)
    graph.replay()
    torch.cuda.synchronize()
    # the replay sums in the eager launch's order: bit for bit
    for (name, a), (_, b) in zip(flagship_bf16.split_flat(*captured),
                                 flagship_bf16.split_flat(*eager)):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_backward_wgmma_refuses_a_model_too_wide_for_shared_memory(cuda):
    # 256 channels with a 368-wide positional encode: two warpgroups'
    # activation and feature blocks and two ring stages exceed 227 KB
    wide = NeRF(num_layers=2, num_channels=256, max_log_scale_pos=9.0,
                num_freq_pos=60, max_log_scale_view=3.0, num_freq_view=4,
                skips=[], include_inputs=True).to(cuda)
    weights = port.prepare_fused_nerf(wide, torch.bfloat16)
    pos, views = _inputs(64, cuda)
    g = torch.ones(64, 4, device=cuda)
    with pytest.raises(RuntimeError, match="invalid argument"):
        train.fused_nerf_backward(weights, pos, views, g)


@pytest.mark.cuda
@pytest.mark.parametrize("num", [1, 129, 262_143, SLICE_POINTS + 1,
                                 1_000_000])
def test_backward_wgmma_scratch_is_a_block_per_tile_up_to_the_sms(
        cuda, flagship_bf16, num):
    # one slice of at most SLICE_POINTS points: its records (every 64-point
    # row block of its tiles holds 2 (L + 1) ceil(C / 64) + ceil(P / 64) +
    # ceil(V / 64) + ceil(C / 128) blocks of 8 KB: the layers' inputs and
    # dz, the features), its row blocks' head sums (5 C / 2 + 4 floats) and
    # ReLU masks (16 bytes a body layer and consumer thread), and pass 2's
    # partials (a row of every weight and bias a range of points: ranges for
    # 4 items an SM over the pairs of 64-column input slices, each range at
    # least 64 row blocks), each at a 1024-byte boundary
    device = flagship_bf16.weights.device
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    w = flagship_bf16
    layers, channels = w.num_layers, w.channels

    def blocks(width):
        return -(-width // 64)

    rows = 2 * -(-min(num, SLICE_POINTS) // GROUP)
    h, pos, view = blocks(channels), blocks(w.pos_width), blocks(w.view_width)
    records = ((2 * (layers + 1) * h + pos + view + blocks(channels // 2))
               * rows * 8192)
    heads = rows * (5 * channels // 2 + 4) * 4
    masks = rows * layers * 128 * 16
    slices = ([pos] + [h + (pos if i in w.skips else 0)
                       for i in range(1, layers)] + [h, h + view])
    pairs = sum(-(-n // 2) for n in slices)
    ranges = max(1, min(-(-4 * sms // pairs), rows // 64))
    ranges = -(-rows // -(-rows // ranges))
    partial = ranges * (w.weights.numel() + w.biases.numel()) * 4

    def aligned(n):
        return -(-n // 1024) * 1024

    assert train.scratch_bytes(w, num, device) \
        == aligned(records) + aligned(heads) + aligned(masks) \
        + aligned(partial)
    if num >= SLICE_POINTS:
        assert train.scratch_bytes(w, num, device) \
            == train.scratch_bytes(w, SLICE_POINTS, device)


@pytest.mark.cuda
def test_backward_wgmma_slices_sum_their_parts(cuda, flagship_bf16):
    """Above SLICE_POINTS points K2 runs its two passes a slice at a time
    (one dW launch each): at a ragged N it agrees with its twin, and the
    whole equals the sum of the two slices launched apart, bit for bit,
    since each slice's sums are the fixed-order sums of its own launch."""
    num = SLICE_POINTS + 4099
    _, pos, views = _assert_backward_matches_twin(
        flagship_bf16, *_inputs(num, cuda), kind="clear")
    g = _cotangent("random", flagship_bf16, pos, views)
    whole = train.fused_nerf_backward(flagship_bf16, pos, views, g)
    parts = [train.fused_nerf_backward(flagship_bf16, pos[s], views[s], g[s])
             for s in (slice(0, SLICE_POINTS), slice(SLICE_POINTS, num))]
    torch.cuda.synchronize()
    for (name, a), (_, b), (_, c) in zip(
            flagship_bf16.split_flat(*whole),
            flagship_bf16.split_flat(*parts[0]),
            flagship_bf16.split_flat(*parts[1])):
        assert torch.equal(a, b + c), name


# K1 and K2 in f32: 3xTF32 wgmma kernels on persistent grids (K1 of
# 128-point tiles, K2 of 64-point tiles, both streaming the f32 slab image),
# so ragged tiles, many tiles a block, every width, the shared-memory budget,
# K2's scratch, the control (single tf32 products) and the recompute's
# identity with K1 are where their faults would show.


@pytest.fixture(scope="module")
def flagship_f32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    model = flagship_nerf(torch.Generator().manual_seed(0)).cuda()
    return port.prepare_fused_nerf(model, torch.float32)


@contextlib.contextmanager
def _single_tf32():
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("num", [1, 63, 127, 128, 129, 100_003])
def test_tf32_tile_edges_match_twin(cuda, flagship_f32, num):
    _assert_matches_twin(flagship_f32, *_inputs(num, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("num", [262_143, 786_431])
def test_tf32_persistent_grid_matches_twin(cuda, flagship_f32, num):
    # 2048 and 6144 tiles, the last ragged: ~16 and ~47 a block
    _assert_matches_twin(flagship_f32, *_inputs(num, cuda))


@pytest.mark.cuda
def test_k1_f32_limits_reject_single_tf32_products(cuda, flagship_f32):
    """The control: the twin on single tf32 products (allow_tf32=True)
    fails the limits the kernel holds against the twin."""
    pos, views = _inputs(50_001, cuda)
    _assert_matches_twin(flagship_f32, pos, views)
    with torch.no_grad():
        twin = port.fused_nerf_reference(flagship_f32, pos, views)
        with _single_tf32():
            wrong = port.fused_nerf_reference(flagship_f32, pos, views)
    err = (wrong - twin).abs()
    assert (err > 2e-4 + 1e-3 * twin.abs()).any() \
        or err.mean().item() > K1_F32_MEAN_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("num", [1, 63, 64, 65, 4099])
def test_backward_tf32_tile_edges_match_twin(cuda, flagship_f32, num):
    # margin: at 4,099 flagship points one ReLU flip between the 3xTF32 sums
    # and the twin's f32 GEMMs carried a leaf to 2.1e-2 of its max under a
    # random cotangent, past 3e-4 under the same-sign one
    _assert_backward_matches_twin(flagship_f32, *_inputs(num, cuda),
                                  kind="margin")


@pytest.mark.cuda
@pytest.mark.parametrize("num", [100_003, 262_143])
@pytest.mark.parametrize("kind", ["margin", "tail", "same-sign"])
def test_backward_tf32_persistent_grid_matches_twin(cuda, flagship_f32, num,
                                                    kind):
    # a ragged last tile, and 4096 tiles (the last ragged): ~31 a block
    _assert_backward_matches_twin(flagship_f32, *_inputs(num, cuda),
                                  kind=kind)


@pytest.mark.cuda
def test_k2_f32_limits_reject_single_tf32_products(cuda, flagship_f32):
    """The control: the twin on single tf32 products fails the tail limit
    the kernel holds against the twin."""
    out, pos, views = _assert_backward_matches_twin(
        flagship_f32, *_inputs(20_011, cuda), kind="tail")
    g = _cotangent("tail", flagship_f32, pos, views)
    twin = train.fused_nerf_backward_reference(flagship_f32, pos, views, g)
    with _single_tf32():
        wrong = train.fused_nerf_backward_reference(flagship_f32, pos, views,
                                                    g)
    share = GRAD_SHARE["tail"][torch.float32]
    assert any((a - b).abs().max().item() > share * b.abs().max().item()
               for (_, a), (_, b) in zip(flagship_f32.split_flat(*wrong),
                                         flagship_f32.split_flat(*twin)))


@pytest.mark.cuda
def test_backward_tf32_recompute_is_k1_bit_for_bit(cuda):
    """K2's f32 recompute is K1's f32 forward: with one-hot heads, K1's
    opacity logit is h_{L-1}[c] and its red logit the hidden layer's
    [c'], each exact; K2's weight gradient of those head entries, under a
    cotangent of 1 on that logit of one point, is the same value."""
    model = flagship_nerf(torch.Generator().manual_seed(0)).to(cuda)
    with torch.no_grad():
        for head in (model.opacity_out, model.color_out):
            head.weight.zero_()
            head.bias.zero_()
        model.opacity_out.weight[0, 37] = 1.0
        model.color_out.weight[0, 11] = 1.0
    weights = port.prepare_fused_nerf(model, torch.float32)
    num = 1000
    pos, views = _inputs(num, cuda)
    with torch.no_grad():
        out = port.fused_nerf_apply(weights, pos, views)
    layers = weights.num_layers
    for point in (0, 63, 64, 999):
        g = torch.zeros(num, 4, device=cuda)
        g[point, 0] = g[point, 3] = 1.0
        leaves = dict(weights.split_flat(
            *train.fused_nerf_backward(weights, pos, views, g)))
        assert leaves[f"w{layers}"].view(-1, 16)[37, 0].item() \
            == out[point, 3].item()
        assert leaves[f"w{layers + 3}"].view(-1, 16)[11, 0].item() \
            == out[point, 0].item()


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [32, 64, 96, 128, 160, 192, 224, 256])
def test_tf32_every_width_matches_twin(cuda, channels):
    """Every channel width the f32 kernels take (one or two ring pieces a
    slab), with a skip layer, raw inputs at every other width."""
    model = NeRF(num_layers=3, num_channels=channels, skips=[2],
                 include_inputs=channels % 64 == 0, max_log_scale_pos=6.0,
                 num_freq_pos=7, max_log_scale_view=2.0, num_freq_view=3,
                 generator=torch.Generator().manual_seed(channels)).to(cuda)
    weights = port.prepare_fused_nerf(model, torch.float32)
    pos, views = _inputs(3001, cuda)
    _assert_matches_twin(weights, pos, views)
    _assert_backward_matches_twin(weights, pos, views, kind="margin")
    _assert_backward_matches_twin(weights, pos, views, kind="tail")


@pytest.mark.cuda
def test_tf32_budget_admits_every_configuration_in_the_repo(cuda):
    """The flagship (train_nerf's default), the validate CLI's small model,
    the IO-floor sweep's, K2 bf16's control model and this file's small one
    all fit both f32 kernels' shared memory."""
    configs = [flagship_nerf(torch.Generator().manual_seed(0)),
               NeRF(**SMALL), NeRF(**train.K2_BF16_CONTROL_MODEL),
               NeRF(num_layers=2, num_channels=32, max_log_scale_pos=3.0,
                    num_freq_pos=4, max_log_scale_view=1.0, num_freq_view=2,
                    skips=[], include_inputs=False)]
    configs += [kernel_io_floor_bench.sweep_model(*row)
                for row in kernel_io_floor_bench.SWEEP]
    pos, views = _inputs(300, cuda)
    for model in configs:
        weights = port.prepare_fused_nerf(model.to(cuda), torch.float32)
        with torch.no_grad():
            assert torch.isfinite(port.fused_nerf_apply(weights, pos,
                                                        views)).all()
        grads = train.fused_nerf_backward(weights, pos, views,
                                          torch.ones(300, 4, device=cuda))
        assert all(torch.isfinite(x).all() for x in grads)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_tf32_refuses_a_model_too_wide_for_shared_memory(cuda, kernel):
    # 256 channels with a 400-wide (K1) or 128-wide (K2) positional encode:
    # K1's two warpgroups' rows, or K2's dz^T and x, and two ring stages
    # exceed 227 KB
    wide = NeRF(num_layers=2, num_channels=256, max_log_scale_pos=9.0,
                num_freq_pos=64 if kernel == "K1" else 20,
                max_log_scale_view=3.0, num_freq_view=4, skips=[],
                include_inputs=True).to(cuda)
    weights = port.prepare_fused_nerf(wide, torch.float32)
    pos, views = _inputs(64, cuda)
    with torch.no_grad(), pytest.raises(RuntimeError,
                                        match="invalid argument"):
        if kernel == "K1":
            port.fused_nerf_apply(weights, pos, views)
        else:
            train.fused_nerf_backward(weights, pos, views,
                                      torch.ones(64, 4, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("num", [1, 65, 262_143])
def test_backward_tf32_scratch_is_a_block_per_tile_up_to_the_sms(
        cuda, flagship_f32, num):
    # each block parks the 8 body layers' h of a 64-point tile, 64 x 256
    # floats each; there are min(tiles, SMs) blocks, and a buffer one
    # granule smaller makes the launch raise
    device = flagship_f32.weights.device
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = min(-(-num // 64), sms)
    need = train.scratch_bytes(flagship_f32, num, device)
    assert need == blocks * 8 * 64 * 256 * 4
    pos, views = _inputs(num, cuda)
    g = torch.ones(num, 4, device=cuda)
    grads = [torch.zeros(t.numel(), device=cuda)
             for t in (flagship_f32.weights, flagship_f32.biases)]
    scratch = torch.empty(need - 16, dtype=torch.uint8, device=cuda)
    dw_launches = ctypes.c_longlong(-1)
    with pytest.raises(RuntimeError, match="invalid argument"):
        train._LIB.launch(
            train.fused_nerf_backward, "fused_nerf_backward", device,
            pos.data_ptr(), views.data_ptr(), flagship_f32.pos_enc.data_ptr(),
            flagship_f32.view_enc.data_ptr(), flagship_f32.slabs.data_ptr(),
            flagship_f32.biases.data_ptr(), flagship_f32.meta.ctypes.data,
            g.data_ptr(), grads[0].data_ptr(), grads[1].data_ptr(),
            scratch.data_ptr(), scratch.numel(), num, 0,
            ctypes.addressof(dw_launches))
    assert dw_launches.value == 0     # f32 runs no dW kernel


@pytest.mark.cuda
def test_backward_tf32_launch_in_cuda_graph(cuda, flagship_f32):
    pos, views = _inputs(50_001, cuda)
    g = _cotangent("random", flagship_f32, pos, views)
    eager = train.fused_nerf_backward(flagship_f32, pos, views, g)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        train.fused_nerf_backward(flagship_f32, pos, views, g)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = train.fused_nerf_backward(flagship_f32, pos, views, g)
    graph.replay()
    torch.cuda.synchronize()
    for (name, a), (_, b) in zip(flagship_f32.split_flat(*captured),
                                 flagship_f32.split_flat(*eager)):
        bound = GRAD_SHARE["tail"][torch.float32] * b.abs().max().item()
        assert (a - b).abs().max().item() <= bound + 1e-7, name


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


@pytest.fixture
def train_scene(cuda, tmp_path):
    from fourier_feature_nets_torch.datasets import ImageDataset
    from fourier_feature_nets_torch.datasets.synthetic import (
        generate_synthetic_dataset)
    path = generate_synthetic_dataset(str(tmp_path / "scene.npz"),
                                      resolution=24, split_counts=(3, 1, 1),
                                      volume_side=16, num_samples=64,
                                      device=cuda)
    dataset = ImageDataset.load(path, "train", 16, stratified=True,
                                num_anneal_steps=8, device=cuda)
    perm = torch.from_numpy(dataset.index_pool()).to(cuda)
    return dataset, perm[torch.randperm(len(perm), generator=torch.Generator()
                                        .manual_seed(1)).to(cuda)]


def _chunk_and_eager(dataset, perm, dtype, fused, steps=4, batch=128):
    """The weights after one CUDA-graph chunk of ``steps`` steps from an
    offset where it wraps, and after the same steps run eagerly, from the
    same start; and the chunk."""
    from fourier_feature_nets_torch.utils.optim import ClippedAdam
    modulo = perm.shape[0] - batch + 1
    offset = (modulo // batch - 1) * batch
    out = []
    for graph in (True, False):
        model = NeRF(**SMALL, generator=torch.Generator().manual_seed(6)).to(
            perm.device)
        caster = Raycaster(model, compute_dtype=dtype, fused=fused,
                           fused_train=fused)
        optimizer = ClippedAdam(model.parameters(), 1e-3, capturable=True)
        if graph:
            chunk = caster._make_train_step(dataset, batch, 1e-3, 0.1, 100,
                                            optimizer, steps)
            chunk(perm, offset, 3, 77)
        else:
            step = caster._make_train_step(dataset, batch, 1e-3, 0.1, 100,
                                           optimizer)
            for k in range(steps):
                step(perm, (offset + k * batch) % modulo, 3 + k, 77)
        out.append([p.detach().clone() for p in model.parameters()])
    return out[0], out[1], chunk


@pytest.mark.cuda
def test_plain_train_chunk_is_the_eager_steps(train_scene):
    """A graph chunk of the plain f32 step (stratified, annealed, wrapping
    the perm) leaves the weights where the same steps run eagerly leave
    them: rtol 1e-5 / atol 1e-6."""
    chunked, eager, chunk = _chunk_and_eager(*train_scene, None, False)
    assert chunk.captures == 1 and chunk.replays == 1
    for a, b in zip(chunked, eager):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, None], ids=["bf16", "f32"])
def test_fused_train_chunk_captures_k1_and_k2(train_scene, dtype):
    """A graph chunk of the fused step records one K1 and one K2 launch
    a step (and K5's two), replays without calling the wrappers, and lands near the
    eager steps: K2's atomics change the gradients' last bits, which can
    flip the sign of a near-zero element's Adam update, so each leaf is
    held in the mean, within 5e-2 of its mean change."""
    launches = (port.fused_nerf_apply.launches,
                train.fused_nerf_backward.launches)
    chunked, eager, chunk = _chunk_and_eager(*train_scene, dtype, True)
    assert chunk.captured == {"fused_nerf": 4, "fused_nerf_train": 4,
                              "clipped_adam": 2 * 4}
    before = (port.fused_nerf_apply.launches,
              train.fused_nerf_backward.launches)
    assert before[0] > launches[0] and before[1] > launches[1]
    chunk.graph.replay()
    torch.cuda.synchronize()
    assert (port.fused_nerf_apply.launches,
            train.fused_nerf_backward.launches) == before
    start = NeRF(**SMALL, generator=torch.Generator().manual_seed(6))
    for a, b, s in zip(chunked, eager, start.parameters()):
        change = (b.cpu() - s.detach()).abs().mean().item()
        assert (a - b).abs().mean().item() <= 5e-2 * change + 1e-9


# ---------------------------------------------------------------------------
# K3: the fused ray render, and T1's scan, against their plain twins
# ---------------------------------------------------------------------------


def _rays(num_rays, num_samples, device, seed=7):
    """Sorted depths in [1, 4), unit directions, starts in [-0.5, 0.5):
    (R, S, 3) positions, (R, 3) directions, (R, S) depths."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(1, 4, (num_rays, num_samples)).astype(np.float32),
                -1)
    d = rng.normal(size=(num_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    start = rng.uniform(-0.5, 0.5, (num_rays, 3)).astype(np.float32)
    pos = (start[:, None] + t[..., None] * d[:, None]).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (pos, d, t))


def _assert_render_within(out, twin, dtype):
    """K3's limits against its twin (kernels/fused_ray_render.py): the
    mean ones from MEAN_RAYS rays on."""
    if dtype == torch.float32:
        torch.testing.assert_close(out, twin, rtol=1e-3, atol=2e-4)
        mean = K3_F32_MEAN_ATOL
    else:
        torch.testing.assert_close(out, twin, rtol=0, atol=K3_BF16_ATOL)
        mean = K3_BF16_MEAN_ATOL
    if out.shape[0] >= MEAN_RAYS:
        assert (out - twin).abs().mean().item() <= mean


def _assert_render_matches_twin(weights, pos, d, t):
    before = fused_ray_render.launches
    with torch.no_grad():
        out = fused_ray_render(weights, pos, d, t)
        twin = fused_ray_render_reference(weights, pos, d, t)
    torch.cuda.synchronize()
    assert fused_ray_render.launches == before + 1
    assert out.shape == (t.shape[0], 4) and torch.isfinite(out).all()
    _assert_render_within(out, twin, weights.weights.dtype)
    return twin


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("num_samples", [42, 48, 128])
@pytest.mark.parametrize("num_rays", [64, 1001])
def test_ray_render_matches_twin(cuda, dtype, num_samples, num_rays):
    model = NeRF(**SMALL, generator=torch.Generator().manual_seed(1)).to(cuda)
    _assert_render_matches_twin(port.prepare_fused_nerf(model, dtype),
                                *_rays(num_rays, num_samples, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("num_samples", [42, 48])
def test_ray_render_signal_only_in_last_ray_block(cuda, dtype, num_samples):
    """Every ray outside the ragged last ray group (the last warpgroup's
    rays, :func:`launch_ray_group`) has all its samples at one depth, so
    its alpha is exactly 0: only the last group's alphas carry signal,
    and a group the kernel dropped or mis-masked there cannot hide
    behind the rest."""
    num_rays = 1001
    rays, _ = launch_ray_group(num_rays, num_samples, cuda)
    last = num_rays % rays or rays
    model = NeRF(**SMALL, generator=torch.Generator().manual_seed(1)).to(cuda)
    pos, d, t = _rays(num_rays, num_samples, cuda)
    t[:-last] = 2.0
    pos[:-last] = d[:-last, None] * 2.0
    twin = _assert_render_matches_twin(port.prepare_fused_nerf(model, dtype),
                                       pos, d, t)
    assert torch.count_nonzero(twin[:-last, 3]) == 0
    assert twin[-last:, 3].min() > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("num_samples", [42, 48, 128])
def test_ray_render_flagship_matches_twin(cuda, dtype, num_samples):
    model = flagship_nerf(torch.Generator().manual_seed(0)).to(cuda)
    _assert_render_matches_twin(port.prepare_fused_nerf(model, dtype),
                                *_rays(1001, num_samples, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("channels", [32, 64, 96, 128, 160, 192, 224, 256])
def test_ray_render_every_width_matches_twin(cuda, dtype, channels):
    """Every channel width the kernels take (a hidden layer of C / 2
    outputs, view rows that start inside a slab at C = 96, 160, 224),
    with a skip layer, raw inputs at every other width."""
    model = NeRF(num_layers=3, num_channels=channels, skips=[2],
                 include_inputs=channels % 64 == 0, max_log_scale_pos=6.0,
                 num_freq_pos=7, max_log_scale_view=2.0, num_freq_view=3,
                 generator=torch.Generator().manual_seed(channels)).to(cuda)
    _assert_render_matches_twin(port.prepare_fused_nerf(model, dtype),
                                *_rays(1001, 48, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("num_samples, num_rays", [(2, 1001), (4096, 9)])
def test_ray_render_shortest_and_longest_rays_match_twin(cuda, dtype,
                                                         num_samples,
                                                         num_rays):
    """S = 2: 32 rays a 64-row piece, each with its view product; S =
    4096: one ray a group, 64 pieces, its transmittance and sums carried
    through all of them."""
    model = NeRF(**SMALL, generator=torch.Generator().manual_seed(1)).to(cuda)
    pos, d, t = _rays(num_rays, num_samples, cuda)
    _assert_render_matches_twin(port.prepare_fused_nerf(model, dtype),
                                pos, d, t)


@pytest.mark.cuda
def test_k3_bf16_limits_reject_the_unrounded_view_product(cuda):
    """The control: against the twin with its view product left in f32
    (K1's rounding point), K3 bf16 fails the mean limit it holds against
    its twin."""
    model = flagship_nerf(torch.Generator().manual_seed(0)).to(cuda)
    weights = port.prepare_fused_nerf(model, torch.bfloat16)
    pos, d, t = _rays(1001, 48, cuda)
    _assert_render_matches_twin(weights, pos, d, t)
    with torch.no_grad():
        out = fused_ray_render(weights, pos, d, t)
        wrong = fused_ray_render_reference(weights, pos, d, t,
                                           "unrounded-view")
    assert (out - wrong).abs().mean().item() > K3_BF16_MEAN_ATOL


@pytest.mark.cuda
def test_k3_f32_limits_reject_single_tf32_products(cuda):
    """The control: the twin on single tf32 products (allow_tf32=True)
    fails the limits K3 f32 holds against the twin."""
    model = flagship_nerf(torch.Generator().manual_seed(0)).to(cuda)
    weights = port.prepare_fused_nerf(model, torch.float32)
    pos, d, t = _rays(1001, 48, cuda)
    twin = _assert_render_matches_twin(weights, pos, d, t)
    with torch.no_grad(), _single_tf32():
        wrong = fused_ray_render_reference(weights, pos, d, t)
    err = (wrong - twin).abs()
    assert (err > 2e-4 + 1e-3 * twin.abs()).any() \
        or err.mean().item() > K3_F32_MEAN_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ray_render_launch_in_cuda_graph(cuda, dtype):
    model = flagship_nerf(torch.Generator().manual_seed(0)).to(cuda)
    weights = port.prepare_fused_nerf(model, dtype)
    pos, d, t = _rays(1001, 48, cuda)
    with torch.no_grad():
        eager = fused_ray_render(weights, pos, d, t)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fused_ray_render(weights, pos, d, t)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = fused_ray_render.launches
        with torch.cuda.graph(graph):
            captured = fused_ray_render(weights, pos, d, t)
        assert fused_ray_render.launches == before + 1
        captured.zero_()
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


@pytest.mark.cuda
def test_ray_render_matches_plain_render(cuda):
    model = NeRF(**SMALL, generator=torch.Generator().manual_seed(1)).to(cuda)
    pos, d, t = _rays(64, 42, cuda)
    with torch.no_grad():
        out = fused_ray_render(port.prepare_fused_nerf(model, torch.float32),
                               pos, d, t)
        ref = Raycaster(model, fused=False).render(
            RaySamples(pos, d[:, None].expand(pos.shape), t, None))
    torch.testing.assert_close(out[:, :3], ref.color, rtol=0, atol=5e-3)
    torch.testing.assert_close(out[:, 3], ref.alpha, rtol=0, atol=5e-3)


def _placed(values, offset):
    """``values`` alone, or copied one row or one element into a larger
    buffer (a base that is not 16-byte aligned)."""
    if offset == "none":
        return values
    skip = values.shape[1] if offset == "one row" else 1
    buffer = torch.empty(values.numel() + skip, dtype=values.dtype,
                         device=values.device)
    view = buffer[skip:].view(values.shape)
    view.copy_(values)
    return view


def _assert_scan_matches(x, rtol):
    before = exclusive_cumprod_scan.launches
    out = exclusive_cumprod_scan(x)
    torch.cuda.synchronize()
    assert exclusive_cumprod_scan.launches == before + 1
    torch.testing.assert_close(out, exclusive_cumprod(x), rtol=rtol, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [128, 20, 45, 77])
def test_scan_matches_exclusive_cumprod(cuda, lanes):
    x = torch.from_numpy(np.random.default_rng(lanes).uniform(
        0.5, 1.0, (1003, lanes)).astype(np.float32)).to(cuda)
    _assert_scan_matches(x, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("rows, lanes", [(16, 128), (16384, 128)])
def test_scan_matches_at_the_test_and_render_shapes(cuda, rows, lanes):
    x = torch.from_numpy(np.random.default_rng(rows).uniform(
        0.5, 1.0, (rows, lanes)).astype(np.float32)).to(cuda)
    _assert_scan_matches(x, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", ["one row", "one element"])
@pytest.mark.parametrize("lanes", [128, 77])
def test_scan_offset_bases_match(cuda, offset, lanes):
    """A view one element in has a base that is not 16-byte aligned: the
    kernel's scalar path, at 128 lanes too."""
    x = torch.from_numpy(np.random.default_rng(lanes).uniform(
        0.5, 1.0, (1003, lanes)).astype(np.float32)).to(cuda)
    _assert_scan_matches(_placed(x, offset), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes, low, offset", [(130, 0.5, "none"),
                                                (4096, 0.99, "none"),
                                                (4096, 0.99, "one element")])
def test_scan_long_rows_match_within_row_tolerance(cuda, lanes, low, offset):
    """Rows past 128 lanes carry a product from one 128-lane pass to the
    next; each side rounds lanes - 1 products in its own order, so the
    tolerance is 2 * lanes * 2**-24 (chip_smoke.py, scan_rtol). The
    values keep every product a normal float."""
    x = torch.from_numpy(np.random.default_rng(lanes).uniform(
        low, 1.0, (1003, lanes)).astype(np.float32)).to(cuda)
    _assert_scan_matches(_placed(x, offset), 2 * lanes * 2.0 ** -24)


@pytest.mark.cuda
def test_validate_scan_check_launches_the_kernel(cuda):
    from fourier_feature_nets_torch.cli import validate_kernels
    report = validate_kernels.Report()
    before = exclusive_cumprod_scan.launches
    validate_kernels.check_scan(report, np.random.default_rng(0), cuda)
    assert report.ok, report.lines
    assert exclusive_cumprod_scan.launches == before + len(
        validate_kernels.SCAN_LANES)


# ---------------------------------------------------------------------------
# P1: the int8 probe's kernels against their plain twins
# ---------------------------------------------------------------------------


def _ints(shape, low, high, dtype, device, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(low, high, shape)).to(device, dtype)


def _assert_int8_matmul_exact(w, h):
    before = probe.int8_matmul.launches
    out = probe.int8_matmul(w, h)
    torch.cuda.synchronize()
    assert probe.int8_matmul.launches == before + 1
    assert out.dtype == torch.int32
    assert torch.equal(out, probe.int8_matmul_reference(w, h))


@pytest.mark.cuda
@pytest.mark.parametrize("m, k, n", [(128, 128, 256), (100, 72, 250),
                                     (1, 1, 1), (65, 129, 63),
                                     (33, 160, 40), (129, 256, 264)])
def test_int8_matmul_matches_twin_exactly(cuda, m, k, n):
    """Besides the tool's shapes: K past one 128-byte stage, and ragged
    tiles that still take the 16-byte W and 8-byte h paths."""
    w = _ints((m, k), -127, 128, torch.int8, cuda, 1)
    h = _ints((k, n), -127, 128, torch.int8, cuda, 2)
    _assert_int8_matmul_exact(w, h)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", ["one row", "one element"])
@pytest.mark.parametrize("m, k, n", [(128, 128, 256), (100, 72, 250)])
def test_int8_matmul_offset_bases_match_twin_exactly(cuda, m, k, n, offset):
    """W and h one row into larger buffers (aligned at the tool's shape)
    and one element (a byte) in: the byte-wise staging path."""
    w = _placed(_ints((m, k), -127, 128, torch.int8, cuda, 1), offset)
    h = _placed(_ints((k, n), -127, 128, torch.int8, cuda, 2), offset)
    _assert_int8_matmul_exact(w, h)


@pytest.mark.cuda
def test_int8_matmul_extreme_values_match_twin_exactly(cuda):
    """All -128 and all 127: the largest sums, and the sign bit of every
    byte through the transpose."""
    for value in (-128, 127):
        w = torch.full((64, 128), value, dtype=torch.int8, device=cuda)
        h = torch.full((128, 96), -128, dtype=torch.int8, device=cuda)
        _assert_int8_matmul_exact(w, h)


@pytest.mark.cuda
def test_int8_probe_cli_launches_the_product(cuda, capsys):
    from fourier_feature_nets_torch.cli import int8_probe as cli
    before = probe.int8_matmul.launches
    assert cli.main(["--columns", "64", "--steps", "2"]) == 0
    assert probe.int8_matmul.launches == before + 1
    assert "stage2 OK" in capsys.readouterr().out


@pytest.mark.cuda
def test_wrappers_launch_inside_cuda_graph_capture(cuda):
    """The launch path takes the current stream, which during capture is
    the capture stream: a replay recomputes the product."""
    w = _ints((128, 128), -127, 128, torch.int8, cuda, 1)
    h = _ints((128, 256), -127, 128, torch.int8, cuda, 2)
    x = torch.rand(64, 128, device=cuda) * 0.5 + 0.5
    probe.int8_matmul(w, h)
    exclusive_cumprod_scan(x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = probe.int8_matmul(w, h)
        scanned = exclusive_cumprod_scan(x)
    w.copy_(_ints((128, 128), -127, 128, torch.int8, cuda, 3))
    x.mul_(0.99)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, probe.int8_matmul_reference(w, h))
    torch.testing.assert_close(scanned, exclusive_cumprod(x), rtol=1e-5,
                               atol=0)


def _assert_quantized_matmul_exact(x, w):
    before = probe.quantized_matmul.launches
    out = probe.quantized_matmul(x, w)
    torch.cuda.synchronize()
    assert probe.quantized_matmul.launches == before + 1
    assert torch.equal(out, probe.quantized_matmul_reference(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("m, k, n", [(128, 128, 256), (100, 72, 250),
                                     (1, 1, 1), (65, 129, 63)])
def test_quantized_matmul_matches_twin_exactly(cuda, m, k, n):
    """The tool's shape, its ragged one, and shapes past one K stage and
    one tile, over P1a's grid: every block's max|x| is the same."""
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(k, n)).astype(
        np.float32)).to(cuda)
    w = _ints((m, k), -127, 128, torch.int8, cuda, 4)
    _assert_quantized_matmul_exact(x, w)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", ["one row", "one element"])
@pytest.mark.parametrize("m, k, n", [(128, 128, 256), (100, 72, 250)])
def test_quantized_matmul_offset_bases_match_twin_exactly(cuda, m, k, n,
                                                          offset):
    """x and W one row into larger buffers and one element in: a base
    that is not 16-byte aligned takes the scalar max and the byte-wise
    quantize."""
    x = _placed(torch.from_numpy(np.random.default_rng(5).normal(
        size=(k, n)).astype(np.float32)).to(cuda), offset)
    w = _placed(_ints((m, k), -127, 128, torch.int8, cuda, 6), offset)
    _assert_quantized_matmul_exact(x, w)


@pytest.mark.cuda
def test_quantized_matmul_max_in_the_last_block_is_seen_by_all(cuda):
    """The largest |x| in one value of the last K rows and columns: a
    block that reduced only its own tile's share of x would quantize
    with another scale."""
    x = torch.from_numpy(np.random.default_rng(7).uniform(
        -1, 1, (128, 256)).astype(np.float32)).to(cuda)
    x[127, 255] = -40.0
    w = _ints((128, 128), -127, 128, torch.int8, cuda, 8)
    _assert_quantized_matmul_exact(x, w)


@pytest.mark.cuda
def test_quantized_matmul_launch_in_cuda_graph(cuda):
    """A replay of the captured launch recomputes the scale from x."""
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(128, 256)).astype(np.float32)).to(cuda)
    w = _ints((128, 128), -127, 128, torch.int8, cuda, 10)
    probe.quantized_matmul(x, w)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = probe.quantized_matmul.launches
    with torch.cuda.graph(graph):
        out = probe.quantized_matmul(x, w)
    assert probe.quantized_matmul.launches == before + 1
    x.mul_(3.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, probe.quantized_matmul_reference(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("channels, n, layers", [
    (192, 2048, 8), (32, 1000, 3), (256, 65, 2), (192, 1000, 8),
    (256, 2048, 8), (16, 65, 1), (48, 130, 3), (96, 64, 1)])
def test_layer_stack_matches_twin(cuda, dtype, channels, n, layers):
    ws = _ints((layers, channels, channels), -5, 6, dtype, cuda, 5)
    h0 = _ints((channels, n), 0, 6, dtype, cuda, 6)
    before = probe.layer_stack.launches
    out = probe.layer_stack(h0, ws)
    torch.cuda.synchronize()
    assert probe.layer_stack.launches == before + 1
    twin = probe.layer_stack_reference(h0, ws)
    if dtype == torch.int8:
        assert torch.equal(out, twin)
    else:
        # bf16 sums past 2**24 round in another order (chip_smoke.py,
        # P1C_BF16_SHARE)
        err = (out - twin).abs().max().item()
        assert err <= 2e-2 * twin.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, stages", [(torch.int8, 6),
                                           (torch.bfloat16, 3)])
def test_layer_stack_spreads_the_tool_shape_over_the_card(cuda, dtype,
                                                          stages):
    """At the probe's (192, 2048, 8) a cluster of 4 blocks shares each
    64-point tile: 128 blocks, each keeping the next layers' weight
    slices in half an SM's shared memory; at (256, 2048, 8) bf16 the ring
    streams (fewer stages than layers)."""
    plan = probe.layer_stack_plan(192, 2048, 8, dtype, cuda)
    assert plan["ctas"] == 128 and plan["cluster"] == 4
    assert plan["stages"] == stages
    assert plan["smem_bytes"] <= 232448 // 2
    wide = probe.layer_stack_plan(256, 2048, 8, torch.bfloat16, cuda)
    assert wide["ctas"] == 128 and wide["stages"] < 8


# ---------------------------------------------------------------------------
# P2: the ablation kernel against its plain twin
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ablation.MODES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ablation_matches_twin(cuda, mode, dtype):
    model = flagship_nerf(torch.Generator().manual_seed(0)).to(cuda)
    weights = port.prepare_fused_nerf(model, dtype)
    pos, views = _inputs(20_011, cuda)
    before = ablation.fused_nerf_ablation.launches
    with torch.no_grad():
        out = ablation.fused_nerf_ablation(weights, pos, views, mode)
        twin = ablation.fused_nerf_ablation_reference(weights, pos, views,
                                                      mode)
    torch.cuda.synchronize()
    assert ablation.fused_nerf_ablation.launches == before + 1
    assert torch.isfinite(out).all()
    if dtype == torch.float32:
        torch.testing.assert_close(out, twin, rtol=1e-3, atol=2e-4)
    else:
        torch.testing.assert_close(out, twin, rtol=0, atol=0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("mode, dtype", [("bf16-accum", torch.bfloat16),
                                         ("no-sincos", torch.bfloat16),
                                         ("no-sincos", torch.float32)])
@pytest.mark.parametrize("num", [20_011, 16384 * 32])
def test_new_ablation_modes_match_twin(cuda, mode, dtype, num):
    """The two modes the tool defines but its run never selects, at a
    ragged N and at the ablation CLI's points (and views)."""
    from fourier_feature_nets_torch.cli.kernel_ablation_bench import (
        ablation_inputs)
    model = flagship_nerf(torch.Generator().manual_seed(0)).to(cuda)
    weights = port.prepare_fused_nerf(model, dtype)
    if num == 16384 * 32:
        pos, views = ablation_inputs(16384, 32, cuda)
    else:
        pos, views = _inputs(num, cuda)
    before = ablation.fused_nerf_ablation.launches
    with torch.no_grad():
        out = ablation.fused_nerf_ablation(weights, pos, views, mode)
        twin = ablation.fused_nerf_ablation_reference(weights, pos, views,
                                                      mode)
    torch.cuda.synchronize()
    assert ablation.fused_nerf_ablation.launches == before + 1
    assert torch.isfinite(out).all()
    if dtype == torch.float32:
        torch.testing.assert_close(out, twin, rtol=1e-3, atol=2e-4)
    elif mode == "bf16-accum":
        # base's twin lies within any max-error limit of bf16-accum's, so
        # the mean error holds the mode (chip_smoke.py, ACCUM_MEAN_ATOL)
        torch.testing.assert_close(out, twin, rtol=0, atol=ACCUM_ATOL)
        assert (out - twin).abs().mean().item() <= ACCUM_MEAN_ATOL
        with torch.no_grad():
            base = ablation.fused_nerf_ablation_reference(weights, pos,
                                                          views, "base")
        assert (out - base).abs().mean().item() > ACCUM_MEAN_ATOL
    else:
        torch.testing.assert_close(out, twin, rtol=0, atol=0.05)


@pytest.mark.cuda
def test_bf16_accum_refuses_an_f32_pack(cuda):
    model = NeRF(**SMALL).to(cuda)
    weights = port.prepare_fused_nerf(model, torch.float32)
    pos, views = _inputs(64, cuda)
    with pytest.raises(ValueError, match="bf16-accum takes a bf16 pack"):
        ablation.fused_nerf_ablation(weights, pos, views, "bf16-accum")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("model", ["small", "flagship"])
@pytest.mark.parametrize("num", [4099, 100_003])
def test_ablation_base_is_k1(cuda, dtype, model, num):
    """base is K1's own instantiation: the same kernel, bit for bit."""
    if model == "small":
        net = NeRF(**SMALL, generator=torch.Generator().manual_seed(1))
    else:
        net = flagship_nerf(torch.Generator().manual_seed(0))
    weights = port.prepare_fused_nerf(net.to(cuda), dtype)
    pos, views = _inputs(num, cuda)
    with torch.no_grad():
        assert torch.equal(
            ablation.fused_nerf_ablation(weights, pos, views, "base"),
            port.fused_nerf_apply(weights, pos, views))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("num", [1, 4099, 100_003])
def test_ablation_no_view_masks_the_ragged_tile(cuda, dtype, num):
    """no-view streams a shorter slab sequence (the body and the opacity
    head): its last, ragged tile is masked and each point's opacity is
    base's, bit for bit."""
    model = flagship_nerf(torch.Generator().manual_seed(0)).to(cuda)
    weights = port.prepare_fused_nerf(model, dtype)
    pos, views = _inputs(num, cuda)
    out = torch.full((num + 7, 4), 7.0, device=cuda)
    with torch.no_grad():
        out[:num] = ablation.fused_nerf_ablation(weights, pos, views,
                                                 "no-view")
        base = ablation.fused_nerf_ablation(weights, pos, views, "base")
        twin = ablation.fused_nerf_ablation_reference(weights, pos, views,
                                                      "no-view")
    assert torch.equal(out[:num, 3], base[:, 3])
    if dtype == torch.float32:
        torch.testing.assert_close(out[:num], twin, rtol=1e-3, atol=2e-4)
    else:
        torch.testing.assert_close(out[:num], twin, rtol=0, atol=0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["small", "flagship"])
def test_bf16_accum_shared_memory_fits_its_runs(cuda, model):
    """bf16-accum's activation rows hold the encode's 16-aligned runs
    (accum_parts) in place of the packed encode; the launch's shared
    memory counts them and fits a block."""
    if model == "small":
        net = NeRF(**SMALL)
    else:
        net = flagship_nerf(torch.Generator().manual_seed(0))
    weights = port.prepare_fused_nerf(net.to(cuda), torch.bfloat16)
    _, width = ablation.accum_parts(weights.pos_enc.shape[1],
                                    weights.include_inputs)
    for mode, encode in (("base", weights.pos_width), ("bf16-accum", width)):
        # two warpgroups' 64 rows of [h | encode | view] in 8 KB blocks,
        # the barriers, then as many C x 128-byte stages as fit, up to 8
        blocks = -(-(weights.channels + encode + weights.view_width) // 64)
        fixed = 1024 + 2 * blocks * 8192 + (2 * 8 + 8) * 8
        stage = weights.channels * 128
        stages = min(8, (232448 - fixed) // stage)
        assert stages >= 2
        assert ablation.shared_bytes(weights, mode, cuda) \
            == fixed + stages * stage


# ---------------------------------------------------------------------------
# P3: the IO-floor sweep's small models through K1, and the copy kernels
# against their plain twins, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("row", kernel_io_floor_bench.SWEEP[1:])
def test_sweep_models_match_twin(cuda, dtype, row):
    """4x128 skip 2, its f6/2 encode (39 and 15 encoded widths) and 2x64
    skip 1, as the IO-floor CLI builds them."""
    model = kernel_io_floor_bench.sweep_model(*row).to(cuda)
    _assert_matches_twin(port.prepare_fused_nerf(model, dtype),
                         *_inputs(4099, cuda))


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("n, tile", [(786_432, 2048), (786_432, 4096),
                                     (1001, 2048), (4099, 64), (3, 4)])
def test_io_floor_kernels_match_twins_bitwise(cuda, n, tile):
    rng = np.random.default_rng(7)
    pos, views = (torch.from_numpy(rng.normal(size=(n, 3)).astype(
        np.float32)).to(cuda) for _ in range(2))
    wide = torch.from_numpy(rng.normal(size=(min(n, 5000), 128)).astype(
        np.float32)).to(cuda)
    packed = torch.from_numpy(rng.normal(size=(n, 8)).astype(
        np.float32)).to(cuda)
    packed[0, :4] = torch.tensor([float("nan"), -1.0, float("inf"), 0.0])
    before = (io.io_narrow.launches, io.io_wide.launches,
              io.packed8.launches)
    narrow = io.io_narrow(pos, views, tile)
    doubled = io.io_wide(wide)
    p8 = io.packed8(packed, tile)
    torch.cuda.synchronize()
    assert (io.io_narrow.launches, io.io_wide.launches,
            io.packed8.launches) == tuple(b + 1 for b in before)
    assert torch.equal(_bits(narrow), _bits(io.io_narrow_reference(pos,
                                                                   views)))
    assert torch.equal(_bits(doubled), _bits(io.io_wide_reference(wide)))
    ref = io.packed8_reference(packed)
    assert torch.isnan(p8[0, 4]) and torch.isnan(p8[0, 6])
    finite = torch.isfinite(ref)
    assert torch.equal(_bits(p8)[finite], _bits(ref)[finite])


@pytest.mark.cuda
@pytest.mark.parametrize("n, tile", [(786_432, 2048), (786_432, 4096),
                                     (786_431, 2048), (786_431, 4096),
                                     (5_001, 1500), (2_047, 2048), (1, 2048),
                                     (3, 4)])
def test_io_narrow_matches_twin_bitwise_at_every_chunking(cuda, n, tile):
    """The IO-floor CLI's n at both tiles; n not a multiple of 4 or of the
    tile; a tile that is not a multiple of the kernel's 1024-row chunk;
    n smaller than one block."""
    rng = np.random.default_rng(n)
    pos, views = (torch.from_numpy(rng.normal(size=(n, 3)).astype(
        np.float32)).to(cuda) for _ in range(2))
    before = io.io_narrow.launches
    out = io.io_narrow(pos, views, tile)
    torch.cuda.synchronize()
    assert io.io_narrow.launches == before + 1
    assert torch.equal(_bits(out), _bits(io.io_narrow_reference(pos, views)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [786_432, 786_431, 100_003, 33, 1])
def test_io_wide_matches_twin_bitwise(cuda, n):
    """The IO-floor CLI's n, ragged ones (the last block is partial) and
    n smaller than one block; a NaN, a negative zero, an infinity and a
    subnormal keep what ``x * 2`` makes of them."""
    x = torch.from_numpy(np.random.default_rng(n).normal(
        size=(n, 128)).astype(np.float32)).to(cuda)
    x[0, :4] = torch.tensor([float("nan"), -0.0, float("inf"), 1e-40])
    ref = io.io_wide_reference(x)
    before = io.io_wide.launches
    out = io.io_wide(x)
    torch.cuda.synchronize()
    assert io.io_wide.launches == before + 1
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(out), nan)
    assert torch.equal(_bits(out)[~nan], _bits(ref)[~nan])


@pytest.mark.cuda
def test_io_narrow_rejects_a_tile_not_a_multiple_of_4(cuda):
    pos = torch.zeros(8, 3, device=cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        io.io_narrow(pos, pos, 6)
