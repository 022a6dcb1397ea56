"""Early ray termination in the port against the JAX package
(mirrors tests/test_early_term.py): the split blend weights and the
two-pass culled frame. The orbit CLI's ``--early-term`` and ``--preset
quality`` are held to the JAX CLI in tests/test_torch_render_frame.py.

Tolerances: the prefix weights equal the port's own unsplit prefix bit
for bit; against JAX's they are within rtol 1e-6 / atol 1e-7, since
torch's and XLA's CPU ``exp`` differ by an ulp on ~9% of inputs; the
split integral rebuilds the whole one within 2e-6 (the JAX suite's);
frames are uint8 within +-1 of JAX's, as every frame test of the port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from fourier_feature_nets_torch.models import NeRF as TorchNeRF
from fourier_feature_nets_torch.models import params_from_jax
from fourier_feature_nets_torch.ops import (
    blend_weights_prefix,
    blend_weights_suffix,
    calculate_blend_weights,
)
from fourier_feature_nets_torch.render import (
    OccupancyGridSampler as TorchOccupancy,
)
from fourier_feature_nets_torch.render import Raycaster as TorchRaycaster
from fourier_feature_nets_torch.render.occupancy_sampler import FACE_DELTA
from fourier_feature_nets_torch.render import RaySampler as TorchRaySampler
from fourier_feature_nets_tpu import ops as jax_ops
from fourier_feature_nets_tpu.cameras import Resolution
from fourier_feature_nets_tpu.models import NeRF
from fourier_feature_nets_tpu.models.serialization import _flatten
from fourier_feature_nets_tpu.render import Raycaster
from fourier_feature_nets_tpu.render.occupancy_sampler import (
    OccupancyGridSampler,
)
from fourier_feature_nets_tpu.utils.camera_paths import orbit
from face_probe import face_bound

CONFIG = dict(num_layers=3, num_channels=32, max_log_scale_pos=4.0,
              num_freq_pos=5, max_log_scale_view=2.0, num_freq_view=3,
              skips=[1], include_inputs=True)
BOUNDS = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)


def _arrays(seed, rays, samples):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(1.0, 4.0, (rays, samples)), -1).astype(
        np.float32)
    opacity = rng.uniform(0.0, 5.0, (rays, samples)).astype(np.float32)
    color = rng.uniform(0.0, 1.0, (rays, samples, 3)).astype(np.float32)
    return t, opacity, color


@pytest.mark.parametrize("k", [1, 7, 15])
def test_prefix_weights_bit_equal(k):
    t, opacity, _ = _arrays(0, 32, 16)
    weights, trans_out = blend_weights_prefix(torch.from_numpy(t),
                                              torch.from_numpy(opacity[:, :k]))
    full = calculate_blend_weights(torch.from_numpy(t),
                                   torch.from_numpy(opacity))
    assert torch.equal(weights, full[:, :k])
    ref_w, ref_t = jax_ops.blend_weights_prefix(jnp.asarray(t),
                                                jnp.asarray(opacity[:, :k]))
    np.testing.assert_allclose(weights.numpy(), np.asarray(ref_w),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(trans_out.numpy(), np.asarray(ref_t),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("k", [8, 12, 23])
def test_split_reconstructs_full_integral(k):
    t, opacity, color = _arrays(1, 64, 24)
    t, opacity, color = (torch.from_numpy(a) for a in (t, opacity, color))
    full = torch.sum(calculate_blend_weights(t, opacity)[..., None] * color,
                     -2)
    w1, t1 = blend_weights_prefix(t, opacity[:, :k])
    w2 = blend_weights_suffix(t, opacity[:, k:])
    c1 = torch.sum(w1[..., None] * color[:, :k], -2)
    c2 = torch.sum(w2[..., None] * color[:, k:], -2)
    np.testing.assert_allclose((c1 + t1[:, None] * c2).numpy(),
                               full.numpy(), rtol=2e-6, atol=2e-6)
    ref = jax_ops.blend_weights_suffix(jnp.asarray(t.numpy()),
                                       jnp.asarray(opacity[:, k:].numpy()))
    np.testing.assert_allclose(w2.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


def _sphere_grid(resolution, center=(0.3, 0.0, 0.0), radius=0.45):
    c = (np.arange(resolution) + 0.5) / resolution * 2 - 1
    zz, yy, xx = np.meshgrid(c, c, c, indexing="ij")
    dist = np.sqrt((xx - center[0]) ** 2 + (yy - center[1]) ** 2
                   + (zz - center[2]) ** 2)
    return (dist < radius).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    # 16 probes: no ray of this rig has its hit flag rounded apart from
    # JAX's frame; at 8 some are (the open fault pinned by
    # test_eight_probe_hit_sets_differ_only_at_cell_faces)
    cameras = orbit(np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0]),
                    3, 40.0, Resolution(20, 20), 3.0)
    grid = _sphere_grid(16)
    jax_sampler = OccupancyGridSampler(
        None, cameras, 12, num_probes=16, empty_weight=0.1, bounds=BOUNDS,
        occupancy_grid=grid, grid_scale=1.0)
    port_sampler = TorchOccupancy(grid, 1.0, cameras, 12, num_probes=16,
                                  empty_weight=0.1, bounds=BOUNDS)
    return jax_sampler, port_sampler


def _nerf_pair(seed, opacity_bias=None):
    """A small JAX NeRF and its port, the opacity head's bias set to
    ``opacity_bias`` (an opaque field) when given."""
    model = NeRF(**CONFIG)
    params = model.init(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    if opacity_bias is not None:
        flat["opacity_out/bias"] = np.full_like(flat["opacity_out/bias"],
                                                opacity_bias)
        params = dict(params)
        params["opacity_out"] = dict(params["opacity_out"],
                                     bias=jnp.asarray(
                                         flat["opacity_out/bias"]))
    return model, params, params_from_jax(TorchNeRF(**CONFIG), flat)


def _frames(scene, seed, camera, opacity_bias=None, **early):
    jax_sampler, port_sampler = scene
    model, params, port = _nerf_pair(seed, opacity_bias)
    ref = Raycaster(model).render_frame(params, jax_sampler, camera,
                                        chunk_size=64, **early)
    caster = TorchRaycaster(port)
    ours = caster.render_frame(port_sampler, camera, chunk_size=64, **early)
    rays = caster.frame_rays
    base = caster.render_frame(port_sampler, camera, chunk_size=64)
    return ours, ref, base, rays


def _diff(a, b):
    return int(np.abs(a.astype(int) - b.astype(int)).max())


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_early_term_frame_matches_jax(scene, fused):
    """An opaque field: most hit rays stop after 4 samples; the port's
    two-pass frame is within +-1 of JAX's ``frame_fn_culled_early``
    (fused: the kernel's plain twin on the CPU)."""
    jax_sampler, port_sampler = scene
    model, params, port = _nerf_pair(1, opacity_bias=6.0)
    early = dict(early_term=1e-3, early_split=4)
    ref = Raycaster(model).render_frame(params, jax_sampler, 1,
                                        chunk_size=64, **early)
    caster = TorchRaycaster(port, fused=fused)
    ours = caster.render_frame(port_sampler, 1, chunk_size=64, **early)
    assert ours.shape == ref.shape == (20, 20, 3)
    assert _diff(ours, ref) <= 1
    rays = caster.frame_rays
    assert 0 < rays["survived"] < rays["hit"], rays
    base = caster.render_frame(port_sampler, 1, chunk_size=64)
    assert _diff(ours, base) <= 1


def test_early_term_matches_culled_when_nothing_saturates(scene):
    """An eps below any reachable transmittance keeps every hit ray: the
    split integral reproduces the culled frame within 1 LSB."""
    ours, ref, base, rays = _frames(scene, 0, 0, early_term=1e-12)
    assert rays["survived"] == rays["hit"] > 0
    assert _diff(ours, base) <= 1
    assert _diff(ours, ref) <= 1


def test_early_term_actually_skips(scene):
    """eps > 1 stops every hit ray after the prefix: on a translucent
    field the frame differs visibly from the full one, as JAX's does."""
    ours, ref, base, rays = _frames(scene, 2, 0, opacity_bias=-1.0,
                                    early_term=2.0, early_split=3)
    assert rays["survived"] == 0
    assert _diff(ours, ref) <= 1
    assert _diff(ours, base) > 3


def test_early_term_bad_split_raises(scene):
    _, port_sampler = scene
    _, _, port = _nerf_pair(0)
    with pytest.raises(ValueError, match="early_split"):
        TorchRaycaster(port).render_frame(port_sampler, 0, chunk_size=64,
                                          early_term=1e-3, early_split=12)


def test_early_term_without_culling_raises(scene):
    """Early termination reuses the culled frame's hit rays, so both
    packages refuse it on a frame that does not cull."""
    jax_sampler, port_sampler = scene
    model, params, port = _nerf_pair(0)
    match = "early_term requires empty-space culling"
    with pytest.raises(ValueError, match=match):
        Raycaster(model).render_frame(params, jax_sampler, 0, chunk_size=64,
                                      cull_empty=False, early_term=1e-3)
    with pytest.raises(ValueError, match=match):
        TorchRaycaster(port).render_frame(port_sampler, 0, chunk_size=64,
                                          cull_empty=False, early_term=1e-3)
    focus = TorchRaySampler(BOUNDS, port_sampler.cameras, 12, "cpu")
    with pytest.raises(ValueError, match=match):
        TorchRaycaster(port).render_frame(focus, 0, chunk_size=64,
                                          early_term=1e-3)


class _SureHit:
    """A port occupancy sampler whose probe reports, for each ray, the
    hit flag that holds however a probe within FACE_DELTA cells of a
    cell face rounds: a hit only where every such rounding hits (the
    repaired flag is the other side: where any one does)."""

    def __init__(self, sampler):
        self.sampler = sampler

    def __getattr__(self, name):
        return getattr(self.sampler, name)

    def _probe_cdf_geometry(self, starts, directions, near, far):
        s = self.sampler
        _, pos = s._probe_positions(starts, directions, near, far)
        cell = s._cells(pos)
        ends = [torch.floor(cell + d).to(torch.int64)
                for d in (-FACE_DELTA, FACE_DELTA)]
        occ = torch.stack([
            s._table_at(ends[x][:, 0], ends[y][:, 1], ends[z][:, 2])
            for z in (0, 1) for y in (0, 1) for x in (0, 1)]).amin(0)
        return None, None, occ.reshape(pos.shape[:-1]).amax(-1) > 0


@pytest.mark.parametrize("camera", [0, 1, 2])
def test_eight_probe_hit_sets_differ_only_at_cell_faces(camera):
    """The occupancy probe's hit flag at cell faces (ROADMAP.md, queue
    3): with 8 probes the rig's axis-aligned cameras put probes exactly
    on cell faces, where the JAX frame (one XLA program) and the port
    (op by op) round the f32 probe positions a few ulps apart. The
    port's flag also counts the cell across a face within FACE_DELTA
    (1e-4 cells, 10x the geometry's measured f32 gap), so on its own
    geometry it is a superset of JAX's probe run op by op, equal to it
    off the face-bound rays; no ray that the JAX frame renders is black
    in the port's; off the rays whose frame flag the faces decide, the
    early-term frame is within +-1 of JAX's; and where the port's culled
    frame renders a ray that only a face decides, it is within +-1 of
    its own frame without culling."""
    cameras = orbit(np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0]),
                    3, 40.0, Resolution(20, 20), 3.0)
    grid = _sphere_grid(16)
    jax_sampler = OccupancyGridSampler(
        None, cameras, 12, num_probes=8, empty_weight=0.1, bounds=BOUNDS,
        occupancy_grid=grid, grid_scale=1.0)
    port_sampler = TorchOccupancy(grid, 1.0, cameras, 12, num_probes=8,
                                  empty_weight=0.1, bounds=BOUNDS)
    offsets = torch.arange(port_sampler.rays_per_camera)
    geometry = port_sampler.camera_ray_geometry(camera, offsets)[:4]
    _, _, hit = port_sampler._probe_cdf_geometry(*geometry)
    _, _, ref_hit = jax_sampler._probe_cdf_geometry(
        *(jnp.asarray(g.numpy()) for g in geometry))
    hit, ref_hit = hit.numpy(), np.asarray(ref_hit)
    bound = face_bound(port_sampler, *geometry).numpy()
    assert (hit >= ref_hit).all()
    np.testing.assert_array_equal(hit[~bound], ref_hit[~bound])
    assert (hit != ref_hit).any() or bound.any()

    stride = TorchRaycaster._safe_probe_subsample(port_sampler, 2)
    sure = TorchRaycaster._compute_hit(_SureHit(port_sampler), camera,
                                       stride).numpy()
    frame_hit = TorchRaycaster._compute_hit(port_sampler, camera,
                                            stride).numpy()
    assert (sure <= frame_hit).all()
    settled = (sure == frame_hit).reshape(20, 20)
    assert not settled.all(), "the rig no longer probes a cell face"

    model, params, port = _nerf_pair(1, opacity_bias=6.0)
    early = dict(early_term=1e-3, early_split=4)
    ref = Raycaster(model).render_frame(params, jax_sampler, camera,
                                        chunk_size=64, **early)
    caster = TorchRaycaster(port)
    ours = caster.render_frame(port_sampler, camera, chunk_size=64, **early)
    assert not ((ref.max(-1) > 0) & (ours.max(-1) == 0)).any()
    gap = np.abs(ours.astype(int) - ref.astype(int)).max(-1)
    assert gap[settled].max() <= 1

    culled = caster.render_frame(port_sampler, camera, chunk_size=64)
    whole = caster.render_frame(port_sampler, camera, chunk_size=64,
                                cull_empty=False)
    decided = ~settled & frame_hit.reshape(20, 20)
    assert decided.any()
    assert np.abs(culled.astype(int)
                  - whole.astype(int)).max(-1)[decided].max() <= 1
