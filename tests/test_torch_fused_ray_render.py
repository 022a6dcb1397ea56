"""The fused ray render's plain twin (K3) and the lane scan (T1) against
the JAX package's Pallas kernels in interpret mode on the CPU, the
wrappers' CPU contract, and the validate CLI's checks on the CPU twins.
The Hopper kernels themselves are held against the twins on a card by
tests/test_torch_kernel_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fourier_feature_nets_tpu as ffn
from fourier_feature_nets_torch.cli import validate_kernels
from fourier_feature_nets_torch.kernels.fused_nerf import (
    fused_nerf_reference,
    prepare_fused_nerf as port_prepare,
)
from fourier_feature_nets_torch.kernels.fused_ray_render import (
    K3_BF16_ATOL,
    K3_BF16_MEAN_ATOL,
    exclusive_cumprod_scan,
    fused_ray_render as port_render,
    fused_ray_render_reference,
    ray_group,
)
from fourier_feature_nets_torch.models import NeRF as TorchNeRF
from fourier_feature_nets_torch.models import flagship_nerf as torch_flagship
from fourier_feature_nets_torch.models import params_from_jax
from fourier_feature_nets_torch.ops import exclusive_cumprod
from fourier_feature_nets_torch.render import Raycaster as TorchRaycaster
from fourier_feature_nets_torch.render import RaySamples as TorchRaySamples
from fourier_feature_nets_torch.render.raycaster import _composite
from fourier_feature_nets_tpu.models import NeRF, flagship_nerf
from fourier_feature_nets_tpu.models.serialization import (
    _flatten,
    _unflatten,
)
from fourier_feature_nets_tpu.ops.fused_nerf import prepare_fused_nerf
from fourier_feature_nets_tpu.ops.fused_ray_render import (
    _exclusive_cumprod_lanes,
    fused_ray_render,
)
from fourier_feature_nets_tpu.render.ray_sampler import RaySamples

# the 4x64 skip-2 model of tests/test_fused_ray_render.py and the
# validation tool's ray-render check
SMALL = dict(num_layers=4, num_channels=64, max_log_scale_pos=9.0,
             num_freq_pos=10, max_log_scale_view=3.0, num_freq_view=4,
             skips=[2], include_inputs=True)
NUM_RAYS = 16    # one tile of the JAX kernel: keeps interpret mode quick


@pytest.fixture(scope="module")
def nerf():
    model = NeRF(**SMALL)
    params = model.init(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    return model, params, params_from_jax(TorchNeRF(**SMALL), flat)


def _rays(num_rays, num_samples, seed=3):
    """Rays through the unit volume as the JAX kernel's tests make them:
    sorted depths in [1, 4), unit directions, starts in [-0.5, 0.5)."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(1, 4, (num_rays, num_samples)).astype(np.float32),
                -1)
    d = rng.normal(size=(num_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    start = rng.uniform(-0.5, 0.5, (num_rays, 3)).astype(np.float32)
    pos = (start[:, None] + t[..., None] * d[:, None]).astype(np.float32)
    return pos, d, t


def _jax_render(model, params, dtype, pos, d, t):
    weights = prepare_fused_nerf(model, params, dtype=dtype)
    return np.asarray(fused_ray_render(model, weights, jnp.asarray(pos),
                                       jnp.asarray(d), jnp.asarray(t),
                                       interpret=True))


def _twin(torch_model, dtype, pos, d, t):
    weights = port_prepare(torch_model, dtype)
    with torch.no_grad():
        return fused_ray_render_reference(
            weights, torch.from_numpy(pos), torch.from_numpy(d),
            torch.from_numpy(t)).numpy()


@pytest.mark.parametrize("num_samples", [42, 128])
def test_twin_f32_matches_pallas(nerf, num_samples):
    model, params, torch_model = nerf
    pos, d, t = _rays(NUM_RAYS, num_samples)
    ref = _jax_render(model, params, jnp.float32, pos, d, t)
    ours = _twin(torch_model, torch.float32, pos, d, t)
    assert ours.shape == (NUM_RAYS, 4)
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("num_samples", [42, 128])
def test_twin_bf16_matches_pallas(nerf, num_samples):
    model, params, torch_model = nerf
    pos, d, t = _rays(NUM_RAYS, num_samples)
    ref = _jax_render(model, params, jnp.bfloat16, pos, d, t)
    ours = _twin(torch_model, torch.bfloat16, pos, d, t)
    np.testing.assert_allclose(ours, ref, atol=0.05)


@pytest.mark.parametrize("num_samples", [42, 128])
def test_twin_matches_raycaster_render(nerf, num_samples):
    """As tests/test_fused_ray_render.py holds the Pallas kernel to the
    JAX Raycaster.render."""
    model, params, torch_model = nerf
    pos, d, t = _rays(NUM_RAYS, num_samples, seed=4)
    views = np.ascontiguousarray(np.broadcast_to(d[:, None], pos.shape))
    ref = ffn.Raycaster(model).render(params, RaySamples(
        jnp.asarray(pos), jnp.asarray(views), jnp.asarray(t), None))
    ours = _twin(torch_model, torch.float32, pos, d, t)
    np.testing.assert_allclose(ours[:, :3], np.asarray(ref.color), atol=2e-3)
    np.testing.assert_allclose(ours[:, 3], np.asarray(ref.alpha), atol=2e-3)


def test_exclusive_cumprod_matches_lane_scan():
    """T1: the Pallas lane scan, run as its own test runs it."""
    from jax.experimental import pallas as pl

    x = np.random.default_rng(0).uniform(0.5, 1.0, (16, 128)).astype(
        np.float32)

    def kernel(x_ref, o_ref):
        o_ref[:] = _exclusive_cumprod_lanes(x_ref[:])

    ref = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((16, 128), jnp.float32),
        interpret=True)(jnp.asarray(x))
    ours = exclusive_cumprod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-5)
    assert np.all(ours[:, 0] == 1.0)


@pytest.mark.parametrize("lanes, low", [(130, 0.5), (4096, 0.99)])
def test_exclusive_cumprod_matches_lane_scan_on_long_rows(lanes, low):
    """T1's twin against the Pallas lane scan past one 128-lane pass (130)
    and at K3's largest S (4096), with values that keep every product a
    normal float: (0.5, 1) underflows from about 256 lanes on."""
    from jax.experimental import pallas as pl

    x = np.random.default_rng(lanes).uniform(low, 1.0, (8, lanes)).astype(
        np.float32)

    def kernel(x_ref, o_ref):
        o_ref[:] = _exclusive_cumprod_lanes(x_ref[:])

    ref = np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((8, lanes), jnp.float32),
        interpret=True)(jnp.asarray(x)))
    ours = exclusive_cumprod(torch.from_numpy(x)).numpy()
    assert np.all(ref > np.finfo(np.float32).tiny)
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    assert np.all(ours[:, 0] == 1.0)


def test_twin_needs_the_per_ray_view_rounding(nerf):
    """In bf16 K3 rounds each ray's view product to bf16 before adding
    it to every sample; K1 followed by compositing does not. With the
    view weights scaled up, so that the view product is large and its
    bf16 step coarse, the twin sits much closer to the Pallas kernel
    than the same model without that rounding."""
    model, params, _ = nerf
    channels = SMALL["num_channels"]
    flat = {k: np.array(v) for k, v in _flatten(params).items()}
    flat["hidden_view/weight"][channels:] *= 40.0
    params = jax.tree.map(jnp.asarray, _unflatten(flat))
    scaled = params_from_jax(TorchNeRF(**SMALL), flat)
    pos, d, t = _rays(NUM_RAYS, 42, seed=6)
    ref = _jax_render(model, params, jnp.bfloat16, pos, d, t)
    ours = _twin(scaled, torch.bfloat16, pos, d, t)

    weights = port_prepare(scaled, torch.bfloat16)
    views = np.ascontiguousarray(np.broadcast_to(d[:, None], pos.shape))
    with torch.no_grad():
        logits = fused_nerf_reference(weights,
                                      torch.from_numpy(pos.reshape(-1, 3)),
                                      torch.from_numpy(views.reshape(-1, 3)))
        result = _composite(logits.reshape(NUM_RAYS, 42, 4),
                            torch.from_numpy(t), False)
    unrounded = torch.cat([result.color, result.alpha[:, None]], -1).numpy()
    twin_err = np.abs(ours - ref).max()
    unrounded_err = np.abs(unrounded - ref).max()
    # read on the CPU: 2.4e-7 and 1.8e-3
    assert twin_err < 1e-4
    assert unrounded_err > 1e-3


def test_cpu_wrapper_runs_twin_without_counting(nerf):
    _, _, torch_model = nerf
    weights = port_prepare(torch_model, torch.float32)
    pos, d, t = map(torch.from_numpy, _rays(9, 48))
    views3 = d[:, None].expand(pos.shape)
    before = port_render.launches
    with torch.no_grad():
        out = port_render(weights, pos, d, t)
        per_sample = port_render(weights, pos, views3, t)
        twin = fused_ray_render_reference(weights, pos, d, t)
    assert port_render.launches == before
    assert torch.equal(out, twin)
    assert torch.equal(per_sample, twin)


def test_scan_wrapper_on_cpu_is_exclusive_cumprod():
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0.5, 1.0, (5, 45)).astype(np.float32))
    before = exclusive_cumprod_scan.launches
    assert torch.equal(exclusive_cumprod_scan(x), exclusive_cumprod(x))
    assert exclusive_cumprod_scan.launches == before


def test_wrappers_reject_other_devices(nerf):
    _, _, torch_model = nerf
    weights = port_prepare(torch_model, torch.float32)
    meta = torch.empty(2, 4, 3, device="meta")
    with pytest.raises(ValueError, match="no fused ray render kernel"):
        port_render(weights, meta, meta[:, 0], meta[..., 0])
    with pytest.raises(ValueError, match="no exclusive cumprod kernel"):
        exclusive_cumprod_scan(torch.empty(2, 4, device="meta"))


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "samples"])
def test_cuda_input_checks(nerf, bad):
    from fourier_feature_nets_torch.kernels.fused_ray_render import (
        _check_cuda_inputs)
    _, _, torch_model = nerf
    weights = port_prepare(torch_model, torch.bfloat16)
    pos, views, t = torch.zeros(4, 8, 3), torch.zeros(4, 3), torch.zeros(4, 8)
    if bad == "dtype":
        t = t.double()
    elif bad == "shape":
        views = torch.zeros(5, 3)
    elif bad == "strided":
        t = torch.zeros(8, 4).T
    else:
        pos, t = torch.zeros(4, 1, 3), torch.zeros(4, 1)
    with pytest.raises(ValueError):
        _check_cuda_inputs(weights, pos, views, t)


def test_ray_group_fills_whole_pieces():
    """The rays a warpgroup of the kernel takes at a time: the fewest
    whose samples fill whole 64-row pieces, within 32 rays and 2048
    samples, and for a small launch no more than leave each SM two
    groups."""
    assert ray_group(42) == (32, 21)     # 1,344 samples, 21 pieces
    assert ray_group(48) == (4, 3)       # 192 samples, 3 pieces
    assert ray_group(128) == (1, 2)
    assert ray_group(4096) == (1, 64)
    for num_samples in range(2, 300):
        rays, pieces = ray_group(num_samples)
        assert 1 <= rays <= 32 and rays * num_samples <= 4096
        assert (pieces - 1) * 64 < rays * num_samples <= pieces * 64
    # an H100's 132 SMs: the render chunk keeps whole groups, the
    # validate CLI's 64 rays go one a group
    assert ray_group(42, 16384, 132) == (32, 21)
    assert ray_group(42, 64, 132) == (1, 1)
    assert ray_group(48, 1001, 132) == (3, 3)


def _kernel_rows(num_rays, num_samples, rays):
    """The points each live row of the kernel takes, as
    csrc/fused_nerf_forward.cuh::piece_rows maps them: tile t's
    warpgroup w takes group 2t + w of `rays` rays, its rows piece by
    piece, those below the group's end and R S live; (point, group)
    for each."""
    pieces = -(-rays * num_samples // 64)
    group_points = rays * num_samples
    groups = -(-num_rays // rays)
    taken = []
    for tile in range((groups + 1) // 2):
        for piece in range(pieces):
            for w in range(2):
                first = (2 * tile + w) * group_points
                end = min(first + group_points, num_rays * num_samples)
                row0 = first + 64 * piece
                taken += [(p, 2 * tile + w)
                          for p in range(row0, min(row0 + 64, end))]
    return taken, rays


@pytest.mark.parametrize("num_rays, num_samples", [
    (1001, 42), (1001, 48), (517, 128), (3, 4096), (65, 2), (999, 65)])
@pytest.mark.parametrize("sms", [1, 132])
def test_ray_groups_cover_every_ray_once(num_rays, num_samples, sms):
    """For a ragged R, the groups' live rows take every sample of every
    ray exactly once, each ray's samples within one group (no ray
    straddles two warpgroups), whole groups (one SM) or those of a
    launch on 132 SMs."""
    rays, _ = ray_group(num_samples, num_rays, sms)
    taken, _ = _kernel_rows(num_rays, num_samples, rays)
    points = [p for p, _ in taken]
    assert sorted(points) == list(range(num_rays * num_samples))
    for p, group in taken:
        assert (p // num_samples) // rays == group


@pytest.fixture(scope="module")
def flagship():
    model = flagship_nerf()
    params = model.init(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    return model, params, params_from_jax(torch_flagship(), flat)


def test_unrounded_view_twin_fails_the_bf16_mean_limit(flagship):
    """The control behind K3's bf16 limits, on the flagship: the twin
    with each ray's view product left unrounded (K1's rounding point)
    differs from the twin by more than K3_BF16_MEAN_ATOL, while the twin
    stays within K3's limits of the Pallas kernel in interpret mode.
    (Read on the CPU: twin vs Pallas max 1.2e-6, mean 9.9e-8; the
    unrounded twin mean 1.3e-5 from both.)"""
    model, params, torch_model = flagship
    pos, d, t = _rays(NUM_RAYS, 42)
    ref = _jax_render(model, params, jnp.bfloat16, pos, d, t)
    weights = port_prepare(torch_model, torch.bfloat16)
    with torch.no_grad():
        twin, unrounded = (fused_ray_render_reference(
            weights, torch.from_numpy(pos), torch.from_numpy(d),
            torch.from_numpy(t), moved).numpy()
            for moved in (None, "unrounded-view"))
    assert np.abs(twin - ref).max() <= K3_BF16_ATOL
    assert np.abs(twin - ref).mean() <= K3_BF16_MEAN_ATOL
    assert np.abs(unrounded - twin).mean() > K3_BF16_MEAN_ATOL
    assert np.abs(unrounded - ref).mean() > K3_BF16_MEAN_ATOL


def test_unrounded_view_twin_is_the_twin_in_f32(nerf):
    """In f32 the view product has no rounding to leave out."""
    _, _, torch_model = nerf
    weights = port_prepare(torch_model, torch.float32)
    pos, d, t = map(torch.from_numpy, _rays(9, 48))
    with torch.no_grad():
        assert torch.equal(
            fused_ray_render_reference(weights, pos, d, t),
            fused_ray_render_reference(weights, pos, d, t, "unrounded-view"))
    with pytest.raises(ValueError, match="moved must be one of"):
        fused_ray_render_reference(weights, pos, d, t, "uncast-hidden")


# ---------------------------------------------------------------------------
# the validate CLI's checks, run on the CPU twins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("label", [label for label, _ in
                                   validate_kernels.CONFIGS])
def test_validate_forward_and_train_checks_pass_on_twins(label):
    make = dict(validate_kernels.CONFIGS)[label]
    rng = np.random.default_rng(0)
    model = make()
    report = validate_kernels.Report()
    validate_kernels.check_forward(report, label, model, rng, "cpu", num=256)
    validate_kernels.check_train(report, label, model, rng, "cpu", num=256)
    assert report.ok, report.lines
    assert [line.split()[0] for line in report.lines] == ["OK"] * 4


def test_validate_ray_render_and_scan_checks_pass_on_twins():
    rng = np.random.default_rng(0)
    report = validate_kernels.Report()
    validate_kernels.check_ray_render(report, rng, "cpu", num_rays=8,
                                      samples=(42, 48))
    validate_kernels.check_scan(report, rng, "cpu")
    assert report.ok, report.lines
    assert len(report.lines) == 2 * 3 + 3


def test_validate_report_fails_on_a_bad_value(capsys):
    report = validate_kernels.Report()
    report.check("good", np.zeros(3), np.zeros(3), 1e-3)
    report.check("bad", np.ones(3), np.zeros(3), 1e-3)
    assert not report.ok
    out = capsys.readouterr().out
    assert "OK  good: max err 0.00e+00 (atol 0.001)" in out
    assert "FAIL bad: max err 1.00e+00 (atol 0.001)" in out


def test_validate_cli_runs_end_to_end_on_cpu_twins(capsys):
    assert validate_kernels.main(["--device", "cpu"]) == 0
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    assert lines[-1] == "ALL OK"
    # the JAX tool's two mesh checks, on a mesh of this process alone
    assert lines[-3].startswith("OK  shard_map fused train step (mesh) loss")
    assert lines[-2].startswith("OK  render_frame fused under mesh (uint8)")
    assert sum(line.startswith("OK ") for line in lines) == 8 + 9 + 3 + 2
    assert "no kernel is checked" in captured.err


def test_validate_cli_refuses_a_missing_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert validate_kernels.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_raycaster_plain_render_matches_twin_in_f32(nerf):
    """The validate CLI holds K3 to the port's plain render in f32."""
    _, _, torch_model = nerf
    pos, d, t = map(torch.from_numpy, _rays(6, 48, seed=8))
    with torch.no_grad():
        ref = TorchRaycaster(torch_model, fused=False).render(
            TorchRaySamples(pos, d[:, None].expand(pos.shape), t, None))
        ours = fused_ray_render_reference(port_prepare(torch_model,
                                                       torch.float32),
                                          pos, d, t)
    torch.testing.assert_close(ours[:, :3], ref.color, rtol=0, atol=2e-4)
    torch.testing.assert_close(ours[:, 3], ref.alpha, rtol=0, atol=2e-4)
