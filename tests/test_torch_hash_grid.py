"""Instant-NGP's hash-grid NeRF (``models/hash_grid.py``) and its
encoding's kernels (``kernels/hash_grid.py``) against the benchmark's
plain reference (``h100_bench/reference/hash_grid.py``), the one
reference of the family, on seeded random weights.

On the CPU: the model's logits and gradients, the corner rows and
weights on hand-worked points, the spherical harmonics on the axes, the
twin against the reference, the checkpoints, ``train_nerf --model
instant-ngp`` and a frame of its checkpoint. On a card (marked ``cuda``,
skipped without one): the kernels against their twin at the published
widths. The file imports no jax, so the card's tests run with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_hash_grid.py
"""

import numpy as np
import pytest
import torch

from fourier_feature_nets_torch.cameras import Resolution
from fourier_feature_nets_torch.cli import train_nerf
from fourier_feature_nets_torch.kernels import hash_grid as kernel
from fourier_feature_nets_torch.models import (
    HashGridNeRF,
    load_model,
    load_torch_model,
    query_model,
    save_model,
    save_torch_model,
)
from fourier_feature_nets_torch.models.hash_grid import (
    INSTANT_NGP,
    harmonics_matrix,
    spherical_harmonics,
)
from fourier_feature_nets_torch.render import Raycaster, RaySampler
from fourier_feature_nets_torch.utils.camera_paths import orbit
from h100_bench.reference import hash_grid as reference

# two dense levels and two hashed ones, at the published feature count,
# MLP depths and harmonics
TINY = dict(INSTANT_NGP, n_levels=4, log2_hashmap_size=10,
            base_resolution=4, per_level_scale=2.0, density_neurons=16,
            color_neurons=16)
# ROADMAP's weight-gradient tolerance: the reference sums each gradient
# in another order (its corners and levels, and its products' blocks)
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4


@pytest.fixture(autouse=True)
def _no_tf32():
    """The reference's products in full f32 on a card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _pair(cfg=TINY, seed=0, device="cpu"):
    """The port's model and the reference holding the same seeded
    weights; the table drawn from U(-1, 1), so that its features, not
    the init's 1e-4, carry the logits."""
    generator = torch.Generator().manual_seed(seed)
    model = HashGridNeRF(**cfg, generator=generator)
    with torch.no_grad():
        model.table.uniform_(-1.0, 1.0, generator=generator)
    model = model.to(device)
    plain = reference.PlainHashGridNeRF(cfg, device)
    plain.load_state_dict(model.state_dict())
    return model, plain


def _points(num, seed=1, device="cpu", spread=1.2):
    """Positions a little beyond the box [-1, 1]^3 (the clamp), and view
    directions that are not unit length."""
    rng = np.random.default_rng(seed)
    positions = rng.uniform(-spread, spread, (num, 3)).astype(np.float32)
    views = rng.normal(size=(num, 3)).astype(np.float32) * 2.0
    return (torch.from_numpy(positions).to(device),
            torch.from_numpy(views).to(device))


def test_logits_and_gradients_match_the_reference():
    model, plain = _pair()
    positions, views = _points(777)
    ours = model(positions, views)
    ref = plain(positions, views)
    torch.testing.assert_close(ours, ref, rtol=1e-5, atol=1e-6)
    cotangent = torch.from_numpy(np.random.default_rng(2).normal(
        size=ours.shape).astype(np.float32))
    (ours * cotangent).sum().backward()
    (ref * cotangent).sum().backward()
    for (name, a), (_, b) in zip(model.named_parameters(),
                                 plain.named_parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, msg=name)


def test_parameters_are_the_families_leaves():
    model = HashGridNeRF(**INSTANT_NGP)
    names = [name for name, _ in model.named_parameters()]
    assert names == ["table", "density.0.weight", "density.1.weight",
                     "color.0.weight", "color.1.weight", "color.2.weight"]
    assert model.table.shape == (6_098_120, 2)
    assert sum(p.numel() for p in model.parameters()) == 12_196_240 + 9_408
    assert list(model.grid.resolutions) == [
        16, 23, 31, 43, 59, 81, 112, 154, 213, 295, 407, 562, 777, 1073,
        1483, 2048]
    assert model.grid.dense.tolist() == [True] * 5 + [False] * 11
    assert abs(model.table).max() <= 1e-4


@pytest.mark.parametrize("key, value", [("n_features_per_level", 4),
                                        ("sh_degree", 3)])
def test_other_feature_counts_and_harmonics_are_refused(key, value):
    """The kernels hold 2 features a level and the view takes the
    harmonics of degree 4; the model refuses other values, as the
    reference does."""
    with pytest.raises(ValueError, match=key):
        HashGridNeRF(**dict(TINY, **{key: value}))
    with pytest.raises(ValueError):
        reference.PlainHashGridNeRF(dict(TINY, **{key: value}), "cpu")


def _hash(cx, cy, cz, size):
    """tiny-cuda-nn's hash in uint32 arithmetic, written out."""
    mask = 0xFFFFFFFF
    return ((cx * 1) & mask ^ (cy * 2654435761) & mask
            ^ (cz * 805459861) & mask) % size


@pytest.mark.parametrize("point,level,corners", [
    # level 0 (dense, res 16, s = 15): q = (8.0, 4.25, 11.75), c0 = (8, 4,
    # 11), w = (0, 0.25, 0.75); corner 0 and corner (1, 1, 1)
    ((0.0, -0.5, 0.5), 0, {0: (8 + 4 * 16 + 11 * 256, 1.0 * 0.75 * 0.25),
                           7: (9 + 5 * 16 + 12 * 256, 0.0)}),
    # the top edge, level 0: x = 1, q = 15.5, c0 = 15; the +1 corner's row
    # 16 + 15 * 16 + 15 * 256 = 4096 wraps to 0, (16, 16, 16) to 272
    ((1.0, 1.0, 1.0), 0, {0: (15 + 15 * 16 + 15 * 256, 0.125),
                          1: (0, 0.125), 7: (272, 0.125)}),
    # level 5 (hashed, res 81, s = 79.63495): c0 = (40, 20, 60); its rows
    # start at 4096 + 12168 + 29792 + 79512 + 205384 = 330952
    ((0.0, -0.5, 0.5), 5, {0: (330952 + _hash(40, 20, 60, 524288), None),
                           3: (330952 + _hash(41, 21, 60, 524288), None),
                           6: (330952 + _hash(40, 21, 61, 524288), None)}),
])
def test_corner_rows_on_hand_worked_points(point, level, corners):
    grid = HashGridNeRF(**INSTANT_NGP).grid
    assert grid.dense[level] == (level < 5)
    rows, weights = kernel.corner_indices(torch.tensor([point]), grid)
    for corner, (row, weight) in corners.items():
        assert int(rows[level, corner, 0]) == row
        if weight is not None:
            assert float(weights[level, corner, 0]) == weight
    assert float(weights[level, :, 0].sum()) == pytest.approx(1.0)
    # the reference reads the same rows: row r of the table holds (r, -r)
    cfg = dict(INSTANT_NGP, compute_dtype="float32")
    plain = reference.PlainHashGridNeRF(cfg, "cpu")
    index = torch.arange(plain.table.shape[0], dtype=torch.float64)
    with torch.no_grad():
        plain.table.copy_(torch.stack([index, -index], -1))
        features = plain.encode(torch.tensor([point]))[0]
    expected = sum(float(w) * float(r) for w, r in
                   zip(weights[level, :, 0], rows[level, :, 0]))
    assert float(features[2 * level]) == pytest.approx(expected, rel=1e-6)
    assert float(features[2 * level + 1]) == pytest.approx(-expected,
                                                           rel=1e-6)


C0, C1 = 0.28209479177387814, 0.48860251190291987
ZZ = 0.94617469575755997 - 0.31539156525251999   # z^2 = 1
AXES = {
    (1, 0, 0): {0: C0, 3: -C1, 6: -0.31539156525251999,
                8: 0.54627421529603959, 13: 0.45704579946446572,
                15: 0.59004358992664352},
    (-1, 0, 0): {0: C0, 3: C1, 6: -0.31539156525251999,
                 8: 0.54627421529603959, 13: -0.45704579946446572,
                 15: -0.59004358992664352},
    (0, 1, 0): {0: C0, 1: -C1, 6: -0.31539156525251999,
                8: -0.54627421529603959, 9: -0.59004358992664352,
                11: 0.45704579946446572},
    (0, -1, 0): {0: C0, 1: C1, 6: -0.31539156525251999,
                 8: -0.54627421529603959, 9: 0.59004358992664352,
                 11: -0.45704579946446572},
    (0, 0, 1): {0: C0, 2: C1, 6: ZZ, 12: 2 * 0.3731763325901154},
    (0, 0, -1): {0: C0, 2: -C1, 6: ZZ, 12: -2 * 0.3731763325901154},
}


@pytest.mark.parametrize("axis", sorted(AXES))
def test_spherical_harmonics_on_the_axes(axis):
    """The closed forms of the 16 harmonics on an axis: every term with
    a factor of another axis is 0."""
    expected = torch.zeros(16, dtype=torch.float64)
    for index, value in AXES[axis].items():
        expected[index] = value
    direction = torch.tensor([axis], dtype=torch.float32)
    for ours in (spherical_harmonics(3.0 * direction,
                                     harmonics_matrix())[0],
                 reference.spherical_harmonics(direction)[0]):
        torch.testing.assert_close(ours.double(), expected, rtol=1e-6,
                                   atol=1e-7)


def test_twin_matches_the_reference():
    model, plain = _pair(seed=3)
    positions, _ = _points(1000, seed=4)
    ours = kernel.hash_grid_encode_reference(positions, model.table.detach(),
                                             model.grid)
    table = plain.table
    ref = plain.encode(positions)
    torch.testing.assert_close(ours, ref.detach(), rtol=1e-6, atol=1e-6)
    grad = torch.from_numpy(np.random.default_rng(5).normal(
        size=ref.shape).astype(np.float32))
    (ref * grad).sum().backward()
    twin = kernel.hash_grid_backward_reference(positions, grad, model.grid)
    torch.testing.assert_close(twin, table.grad, rtol=1e-5, atol=1e-5)
    bf16 = kernel.hash_grid_encode_reference(
        positions, model.table.detach(), model.grid, torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    torch.testing.assert_close(bf16, ours.to(torch.bfloat16))


def test_cpu_encode_runs_the_twin_and_counts_nothing():
    model, _ = _pair()
    positions, _ = _points(10)
    before = (kernel.hash_grid_encode.launches,
              kernel.hash_grid_backward.launches)
    features = kernel.hash_grid_apply(model.table, positions, model.grid)
    features.sum().backward()
    assert features.shape == (10, 8)
    assert model.table.grad.shape == model.table.shape
    assert (kernel.hash_grid_encode.launches,
            kernel.hash_grid_backward.launches) == before


def test_bf16_logits_stay_near_f32():
    model, plain = _pair()
    positions, views = _points(500)
    ours = query_model(model, positions, views, torch.bfloat16)
    assert ours.dtype == torch.float32
    ref = plain(positions, views)
    gap = (ours - ref).abs().max() / ref.abs().max()
    assert 0 < gap < 0.05


def test_checkpoints_round_trip(tmp_path):
    model, _ = _pair()
    positions, views = _points(50)
    expected = model(positions, views)
    save_model(model, str(tmp_path / "ngp.npz"))
    save_torch_model(model, str(tmp_path / "ngp.pt"))
    for loaded in (load_model(str(tmp_path / "ngp.npz")),
                   load_torch_model(str(tmp_path / "ngp.pt")),
                   load_model(str(tmp_path / "ngp.pt"))):
        assert isinstance(loaded, HashGridNeRF)
        assert loaded.params_manifest == model.params_manifest
        torch.testing.assert_close(loaded(positions, views), expected,
                                   rtol=0, atol=0)


def test_train_nerf_trains_instant_ngp_and_its_checkpoint_renders(
        tmp_path, monkeypatch):
    monkeypatch.setenv("FFN_TORCH_DATA_DIR", str(tmp_path / "data"))
    out = tmp_path / "run"
    assert train_nerf.main([
        "synthetic:16", str(out), "--device", "cpu", "--model",
        "instant-ngp", "--num-samples", "8", "--num-steps", "2",
        "--report-interval", "2", "--batch-size", "64", "--crop-steps",
        "0", "--image-interval", "0", "--learning-rate", "1e-2"]) == 0
    model = load_model(str(out / "nerf.npz"))
    assert isinstance(model, HashGridNeRF)
    assert model.params_manifest == dict(INSTANT_NGP)
    fresh = HashGridNeRF(**INSTANT_NGP,
                         generator=torch.Generator().manual_seed(0))
    moved = [name for (name, a), (_, b) in zip(model.named_parameters(),
                                               fresh.named_parameters())
             if not torch.equal(a, b)]
    assert moved == [name for name, _ in model.named_parameters()]
    with open(out / "log.txt") as handle:
        assert "instant-ngp" in handle.read()

    cameras = orbit(np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0]), 2,
                    40.0, Resolution(12, 12), 3.0)
    bounds = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
    raycaster = Raycaster(model)
    assert not raycaster.fused
    frame = raycaster.render_frame(RaySampler(bounds, cameras, 8), 1,
                                   cull_empty=False)
    assert frame.shape == (12, 12, 3) and frame.dtype == np.uint8
    assert frame.any()


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

U24 = 2.0 ** -24


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hash grid's kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _order_bound(positions, grad, grid):
    """Per table row, what two sums of the same f32 terms in any two
    orders can differ by: 2 (m - 1) u sum |term| for m terms (the
    kernel's atomics add in the order the card schedules them)."""
    rows, _ = kernel.corner_indices(positions, grid)
    terms = torch.bincount(rows.reshape(-1), minlength=grid.entries)
    magnitude = kernel.hash_grid_backward_reference(positions, grad.abs(),
                                                    grid)
    return 2.0 * (terms.clamp(min=1) - 1).double()[:, None] * U24 \
        * magnitude.double()


def _within_order(a, b, bound):
    excess = ((a.double() - b.double()).abs() - bound).max()
    assert excess <= 0.0, float(excess)


@pytest.mark.cuda
@pytest.mark.parametrize("num", [1, 4_099, 262_144])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_the_twin_at_the_published_widths(cuda, num, dtype):
    """N = 1 and 4,099 leave the last block ragged (256 points a
    block)."""
    model, _ = _pair(INSTANT_NGP, seed=7, device=cuda)
    grid, table = model.grid, model.table.detach()
    positions, _ = _points(num, seed=num, device=cuda)
    launches = (kernel.hash_grid_encode.launches,
                kernel.hash_grid_encode.points,
                kernel.hash_grid_backward.launches)
    features = kernel.hash_grid_encode(positions, table, grid, dtype)
    twin = kernel.hash_grid_encode_reference(positions, table, grid, dtype)
    assert features.dtype == dtype and features.shape == (num, 32)
    # the same products and adds in the same order: equal but for the last
    # bit, and a bf16 feature rounds the same f32 sum
    torch.testing.assert_close(features.float(), twin.float(),
                               rtol=2.0 ** -20 if dtype == torch.float32
                               else 2.0 ** -7, atol=1e-30)
    grad = torch.randn(num, 32, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(num))
    grad = grad.to(dtype)
    out = kernel.hash_grid_backward(positions, grad, grid)
    torch.cuda.synchronize()
    expected = kernel.hash_grid_backward_reference(positions, grad, grid)
    _within_order(out, expected, _order_bound(positions, grad, grid))
    assert (kernel.hash_grid_encode.launches,
            kernel.hash_grid_encode.points,
            kernel.hash_grid_backward.launches) == (
        launches[0] + 1, launches[1] + num, launches[2] + 1)


@pytest.mark.cuda
def test_two_launches_and_a_graph_replay_agree_within_the_order(cuda):
    model, _ = _pair(INSTANT_NGP, seed=8, device=cuda)
    grid, table = model.grid, model.table.detach()
    positions, _ = _points(262_144, seed=9, device=cuda, spread=1.0)
    grad = torch.randn(262_144, 32, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(9))
    grad = grad.to(torch.bfloat16)
    first = kernel.hash_grid_backward(positions, grad, grid)
    second = kernel.hash_grid_backward(positions, grad, grid)
    features = kernel.hash_grid_encode(positions, table, grid,
                                       torch.bfloat16)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):   # warm the allocator off the graph
        kernel.hash_grid_backward(positions, grad, grid)
    torch.cuda.current_stream().wait_stream(stream)
    captured = kernel.hash_grid_encode.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replay_features = kernel.hash_grid_encode(positions, table, grid,
                                                  torch.bfloat16)
        replay = kernel.hash_grid_backward(positions, grad, grid)
    assert kernel.hash_grid_encode.launches == captured + 1
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert kernel.hash_grid_encode.launches == captured + 1
    assert torch.equal(replay_features, features)
    bound = _order_bound(positions, grad, grid)
    _within_order(second, first, bound)
    _within_order(replay, first, bound)


@pytest.mark.cuda
def test_the_model_trains_through_the_kernels_on_a_card(cuda):
    """One bf16 step of the published model on the card against the same
    step of the CPU twin: the logits, and the table's gradient within
    the bf16 features' rounding."""
    model, _ = _pair(INSTANT_NGP, seed=10, device=cuda)
    positions, views = _points(4096, seed=11, device=cuda)
    before = (kernel.hash_grid_encode.launches,
              kernel.hash_grid_backward.launches)
    logits = query_model(model, positions, views, torch.bfloat16)
    logits.square().sum().backward()
    assert (kernel.hash_grid_encode.launches,
            kernel.hash_grid_backward.launches) == (before[0] + 1,
                                                     before[1] + 1)
    cpu, _ = _pair(INSTANT_NGP, seed=10)
    ref = query_model(cpu, positions.cpu(), views.cpu(), torch.bfloat16)
    torch.testing.assert_close(logits.cpu(), ref, rtol=0.02, atol=0.02)
    ref.square().sum().backward()
    gap = (model.table.grad.cpu() - cpu.table.grad).norm() \
        / cpu.table.grad.norm()
    assert gap < 0.05, float(gap)
