"""Volumetric raycaster and trainer.

Port of ``fourier_feature_nets_tpu/render/raycaster.py``: ``_composite``,
``Raycaster.render``/``batched_render``, the surface sweep of
``voxelize_model`` (``extract_surface``), the whole-frame renderer
``render_frame``/``render_frame_async`` with empty-space culling and
early ray termination, and the trainer: ``_train_forward``,
``_make_train_step``, ``_validate`` and ``fit`` with train-state
checkpoints and resume, several steps a call and occupancy-guided
training. The JAX package compiles a frame into one ``lax.scan`` and a
train step into one jitted function (N steps into one ``lax.scan``);
here a frame is eager PyTorch, and a train step is eager, or N steps
are one CUDA-graph replay. On a CUDA device in bf16 NeRF queries go
through the fused Hopper kernels by default (:func:`resolve_fused`): K1
(:mod:`..kernels.fused_nerf`) for rendering, K1 forward and K2 backward
(:mod:`..kernels.fused_nerf_train`) for training.

Frames of any camera pose (``render_frame_pose``) share the indexed
frame's code, and ``render_image`` is the chunked parity path. A model
without view directions (the FFNs, the voxel fields) is queried on the
positions alone (:func:`~..models.module.query_model`), and its last
layer's units render as an activation grid (``render_activations``).

Under a data-parallel mesh (:mod:`..parallel`, one process a device) a
train step takes this rank's slab of the global ray batch and averages
the loss and the gradients over the ranks before the clipped Adam step,
and a frame is a collective: every rank renders its slab of each chunk
and gathers the others'.
"""

import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.fused_nerf import (
    fused_nerf_apply,
    pack_fused_nerf,
    prepare_fused_nerf,
)
from ..kernels.fused_nerf_train import fused_nerf_train_apply
from ..models.module import query_model
from ..models.serialization import (
    named_parameters,
    params_from_jax,
    params_to_jax,
)
from ..ops import (
    blend_weights_prefix,
    blend_weights_suffix,
    calculate_blend_weights,
)
from ..utils.color import ycrcb_to_rgb
from ..utils.debug import debug_nans_enabled
from ..utils.optim import ClippedAdam, exponential_lr
from ..utils.progress import LogEntry
from .ray_sampler import RaySampler, RaySamples

__all__ = ["Raycaster", "RenderResult", "resolve_fused"]


class RenderResult(NamedTuple):
    """Per-ray render outputs (``datasets/ray_dataset.py::RenderResult``
    in the JAX package)."""

    color: torch.Tensor
    alpha: torch.Tensor
    depth: Optional[torch.Tensor]

    def numpy(self) -> "RenderResult":
        """The outputs as NumPy arrays (detached, on the host)."""
        return RenderResult(*[None if t is None else t.detach().cpu().numpy()
                              for t in self])


def _composite(color_o: torch.Tensor, t_values: torch.Tensor,
               include_depth: bool) -> RenderResult:
    """Emission-absorption compositing of raw model logits: sigmoid
    color, softplus opacity, alpha without the absorbing tail sample,
    depth at the highest-weight sample (the last one where alpha <
    0.1)."""
    num_samples = t_values.shape[-1]
    color = torch.sigmoid(color_o[..., :3])
    opacity = F.softplus(color_o[..., 3])

    weights = calculate_blend_weights(t_values, opacity)
    output_color = torch.sum(weights[..., None] * color, dim=-2)
    leading = weights[..., :-1]
    output_alpha = torch.sum(leading, dim=-1)

    if include_depth:
        cutoff = torch.argmax(leading, dim=-1)
        cutoff = torch.where(output_alpha < 0.1, num_samples - 1, cutoff)
        output_depth = torch.gather(t_values, -1, cutoff[..., None])[..., 0]
    else:
        output_depth = None
    return RenderResult(output_color, output_alpha, output_depth)


def resolve_fused(requested: Optional[bool], on_cuda: bool,
                  compute_dtype: Optional[torch.dtype]) -> bool:
    """Whether a NeRF's queries take the fused kernels.

    An explicit True or False (``--fused`` / ``--no-fused``) wins. None
    turns them on only on a CUDA device with ``compute_dtype`` bf16. In
    f32 the kernels (3xTF32 products) beat their plain twins on an H100,
    but a whole fused f32 train step beat the plain one in most turns,
    not all (PERF.md, section 5), so f32 stays plain until it does:
    the JAX package turns its kernels on only where they measured a
    win."""
    if requested is not None:
        return bool(requested)
    return on_cuda and compute_dtype == torch.bfloat16


class Raycaster:
    """Renders rays through a radiance field."""

    def __init__(self, model, compute_dtype: Optional[torch.dtype] = None,
                 fused: Optional[bool] = None,
                 fused_train: Optional[bool] = None):
        """Constructor.

        Args:
            model: the radiance-field ``nn.Module``; its device is the
                render device.
            compute_dtype: optional matmul dtype for the MLP (e.g.
                torch.bfloat16); None keeps full f32.
            fused: route NeRF queries through the fused kernel's
                wrapper. None (default) resolves by
                :func:`resolve_fused`: on for a NeRF on a CUDA device
                in bf16, off elsewhere (in f32 too, where a fused step
                did not beat the plain one in every turn). With True on
                the CPU the
                wrapper runs the kernel's plain twin.
            fused_train: route training forwards through the fused
                recompute-backward (K1 forward, K2 backward). None
                (default) resolves as ``fused`` does; with True on the
                CPU the wrappers run the kernels' plain twins. Off
                trains through autograd of the plain model.
        """
        self.model = model
        self.compute_dtype = compute_dtype
        is_nerf = getattr(model, "model_type", None) == "nerf"
        on_cuda = next(model.parameters()).is_cuda
        self.fused = is_nerf and resolve_fused(fused, on_cuda, compute_dtype)
        self.fused_train = is_nerf and resolve_fused(fused_train, on_cuda,
                                                     compute_dtype)
        self.step_ms: List[float] = []
        self._fused_weights = None
        self._fused_key = None

    def _get_fused_weights(self):
        """The kernel's weight pack, built once per parameter state:
        the key holds each parameter's version counter, which an
        in-place update bumps."""
        key = (self.compute_dtype,
               tuple(p._version for p in self.model.parameters()))
        if self._fused_key != key:
            dtype = (self.compute_dtype if self.compute_dtype is not None
                     else torch.float32)
            self._fused_weights = prepare_fused_nerf(self.model, dtype)
            self._fused_key = key
        return self._fused_weights

    def _query(self, positions: torch.Tensor,
               views: torch.Tensor) -> torch.Tensor:
        """(N, 3) positions and views -> (N, 4) logits."""
        if self.fused:
            return fused_nerf_apply(self._get_fused_weights(),
                                    positions.contiguous(),
                                    views.contiguous())
        return query_model(self.model, positions, views, self.compute_dtype)

    @torch.no_grad()
    def render(self, ray_samples: RaySamples,
               include_depth: bool = False) -> RenderResult:
        """Renders ray samples through the model."""
        num_rays, num_samples = ray_samples.t_values.shape
        positions = ray_samples.positions.reshape(-1, 3)
        views = ray_samples.view_directions.reshape(-1, 3)
        color_o = self._query(positions, views)
        color_o = color_o.reshape(num_rays, num_samples, 4)
        return _composite(color_o, ray_samples.t_values, include_depth)

    def batched_render(self, samples: RaySamples, batch_size: int,
                       include_depth: bool) -> RenderResult:
        """Renders arbitrarily many rays in chunks of ``batch_size``;
        returns host NumPy arrays."""
        num_rays = samples.positions.shape[0]
        colors, alphas, depths = [], [], []
        for start in range(0, num_rays, batch_size):
            chunk = RaySamples(samples.positions[start:start + batch_size],
                               samples.view_directions[start:start
                                                       + batch_size],
                               samples.t_values[start:start + batch_size],
                               None)
            result = self.render(chunk, include_depth)
            colors.append(result.color)
            alphas.append(result.alpha)
            if include_depth:
                depths.append(result.depth)
        color = torch.cat(colors).cpu().numpy()
        alpha = torch.cat(alphas).cpu().numpy()
        depth = torch.cat(depths).cpu().numpy() if include_depth else None
        return RenderResult(color, alpha, depth)

    @torch.no_grad()
    def extract_surface(self, dataset, batch_size: int = 16384,
                        alpha_threshold: float = 0.3):
        """Surface point cloud of a trained model (the voxelize sweep).

        Every ``index_pool()`` ray of ``dataset`` is sampled and
        rendered with depth (through K1 when fused); the rays with
        ``alpha > alpha_threshold`` are compacted on the device and
        copied to the host once.

        Returns:
            (positions, colors): (K, 3) f32 NumPy arrays; positions are
            ray origin + depth * direction, colors clipped to [0, 1].
        """
        sampler = dataset.sampler
        pool = torch.from_numpy(
            np.asarray(dataset.index_pool(), np.int64)).to(sampler.device)
        points, colors, keeps = [], [], []
        for start in range(0, pool.shape[0], batch_size):
            rays = sampler.sample(pool[start:start + batch_size])
            result = self.render(rays, include_depth=True)
            # origin and direction from the sample geometry, as the JAX
            # sweep recovers them
            dirs = rays.view_directions[:, 0]
            origin = rays.positions[:, 0] - rays.t_values[:, :1] * dirs
            points.append(origin + result.depth[:, None] * dirs)
            colors.append(torch.clamp(result.color, 0.0, 1.0))
            keeps.append(result.alpha > alpha_threshold)
        if not keeps:
            empty = np.zeros((0, 3), np.float32)
            return empty, empty.copy()
        keep = torch.cat(keeps)
        packed = torch.cat([torch.cat(points), torch.cat(colors)], -1)
        out = packed[keep].float().cpu().numpy()
        return out[:, :3], out[:, 3:]

    @staticmethod
    def _safe_probe_subsample(sampler, stride: int) -> int:
        """Clamps the cull-probe stride to 1 when occupancy cells are
        too small on screen for the coarse raster to stay conservative.

        The stride-s raster culls a ray only when its probe and every
        3x3-dilated coarse neighbor miss, a superset of the exact
        per-ray test only while an occupied cell spans several coarse
        probes; require a >= 3*s pixel cell span (estimated from the
        rig's calibration) before subsampling."""
        if stride <= 1 or not hasattr(sampler, "_grid_resolution"):
            return stride
        cell = 2.0 * sampler._grid_scale / sampler._grid_resolution
        focal = min(float(c.intrinsics[0, 0]) for c in sampler.cameras)
        distance = max(float(np.linalg.norm(c.position[0]))
                       for c in sampler.cameras)
        span_px = focal * cell / max(distance, 1e-6)
        return stride if span_px >= 3.0 * stride else 1

    @staticmethod
    def _compute_hit(sampler, camera, probe_subsample: int):
        """Probe phase of the culled frame: which of the frame's rays
        touch occupied space. ``camera`` is a rig index or a ``(ray_m,
        position)`` calibration (:func:`_frame_rays`). With
        ``probe_subsample`` s > 1 only every s-th pixel in each image
        axis is probed and the coarse hit raster is 3x3 max-dilated
        before upsampling: a ray is culled only when its probe and every
        neighboring coarse probe miss."""
        geometry, _ = _frame_rays(sampler, camera)
        height, width = sampler.image_height, sampler.image_width
        device = sampler.device
        offsets = torch.arange(sampler.rays_per_camera, device=device)
        starts, dirs, near, far, valid = geometry(offsets)
        if probe_subsample > 1:
            s = probe_subsample
            coarse_h = -(-height // s)
            coarse_w = -(-width // s)
            cy = torch.clamp(torch.arange(coarse_h, device=device) * s,
                             max=height - 1)
            cx = torch.clamp(torch.arange(coarse_w, device=device) * s,
                             max=width - 1)
            coarse_off = (cy[:, None] * width + cx[None, :]).reshape(-1)
            cs, cd, cn, cf, cvalid = geometry(coarse_off)
            _, _, hit_c = sampler._probe_cdf_geometry(cs, cd, cn, cf)
            grid = (hit_c & cvalid).reshape(1, 1, coarse_h, coarse_w)
            dilated = F.max_pool2d(grid.float(), 3, stride=1, padding=1) > 0
            fine = dilated[0, 0].repeat_interleave(s, 0).repeat_interleave(
                s, 1)[:height, :width]
            hit = fine.reshape(-1)
        else:
            _, _, hit = sampler._probe_cdf_geometry(starts, dirs, near, far)
        return hit & valid

    def _render_rays(self, sample, offsets: torch.Tensor) -> torch.Tensor:
        """(R,) pixel offsets -> (R, 3) colors; ``sample`` draws their
        samples (:func:`_frame_rays`)."""
        return self.render(sample(offsets)).color

    def _render_prefix(self, sample, offsets: torch.Tensor, k1: int):
        """Pass 1 of early termination: each ray's first ``k1`` samples.

        Returns:
            ((R, 3) partial color, (R,) transmittance after them)."""
        rays = sample(offsets)
        logits = self._query(rays.positions[:, :k1].reshape(-1, 3),
                             rays.view_directions[:, :k1].reshape(-1, 3))
        logits = logits.reshape(offsets.shape[0], k1, 4)
        weights, trans_out = blend_weights_prefix(
            rays.t_values, F.softplus(logits[..., 3]))
        color = torch.sum(weights[..., None] * torch.sigmoid(logits[..., :3]),
                          dim=-2)
        return color, trans_out

    def _render_suffix(self, sample, offsets: torch.Tensor,
                       k1: int) -> torch.Tensor:
        """Pass 2 of early termination: the samples after the first
        ``k1`` of each surviving ray, composited unscaled (the frame
        multiplies by pass 1's transmittance). The samples are drawn
        again from the ray geometry, as the JAX frame does."""
        rays = sample(offsets)
        logits = self._query(rays.positions[:, k1:].reshape(-1, 3),
                             rays.view_directions[:, k1:].reshape(-1, 3))
        logits = logits.reshape(offsets.shape[0], -1, 4)
        weights = blend_weights_suffix(rays.t_values,
                                       F.softplus(logits[..., 3]))
        return torch.sum(weights[..., None] * torch.sigmoid(logits[..., :3]),
                         dim=-2)

    def _chunks(self, ray_offsets: torch.Tensor, chunk_size: int, fn,
                mesh=None):
        """Runs ``fn`` on each ``chunk_size`` slice of ``ray_offsets``;
        under a ``mesh`` each rank runs it on its slab of the slice and
        gathers the other slabs (:meth:`..parallel.Mesh.map_rows`)."""
        for start in range(0, ray_offsets.shape[0], chunk_size):
            chunk = ray_offsets[start:start + chunk_size]
            yield chunk, (fn(chunk) if mesh is None
                          else mesh.map_rows(fn, chunk))

    @torch.no_grad()
    def render_frame_async(self, sampler: RaySampler, camera: int,
                           chunk_size: int = 16384,
                           cull_empty: bool = True,
                           probe_subsample: int = 2,
                           early_term: float = 0.0,
                           early_split: int = 0,
                           mesh=None) -> torch.Tensor:
        """Renders one camera frame and returns it as an (H, W, 3) uint8
        tensor on the render device, without a host copy.

        With ``cull_empty`` and a sampler that probes occupancy
        (:class:`OccupancyGridSampler`), rays whose probes all miss are
        never sent to the model and render black. Invalid rays (missing
        the volume) render black.

        ``early_term`` > 0 (with culling) terminates rays early, as the
        JAX package's ``frame_fn_culled_early``: pass 1 runs each hit
        ray's first ``early_split`` samples (default half), pass 2 only
        the rest of the rays whose transmittance after them is still
        above ``early_term``, and the frame is ``C1 + T1 * C2``. Each
        skipped sample adds at most ``early_term`` of a color. The hit
        and surviving ray counts of the frame are left in
        ``self.frame_rays``.

        Under a data-parallel ``mesh`` the frame is a collective: every
        rank calls it with the same camera, computes the same hit set
        from the same probe, and renders its slab of each chunk (the
        chunk rounded up to a multiple of the mesh size, the last one
        padded, as the JAX frame's shard_map); the slabs are gathered,
        so every rank returns the whole frame.
        """
        return self._frame(sampler, camera % sampler.num_cameras, chunk_size,
                           cull_empty, probe_subsample, early_term,
                           early_split, mesh)

    def _frame(self, sampler: RaySampler, camera, chunk_size: int,
               cull_empty: bool, probe_subsample: int, early_term: float,
               early_split: int, mesh=None) -> torch.Tensor:
        """The frame of a rig index or a ``(ray_m, position)``
        calibration (:func:`_frame_rays`): the indexed and the pose
        path share it, and its probe."""
        if mesh is not None:
            chunk_size = -(-chunk_size // mesh.size) * mesh.size
        cull = cull_empty and hasattr(sampler, "_probe_cdf_geometry")
        if early_term > 0.0 and not cull:
            raise ValueError(
                "early_term requires empty-space culling (an "
                "OccupancyGridSampler and cull_empty=True): the "
                "termination passes reuse the culled frame's hit rays")
        num_samples = sampler.num_samples
        k1 = early_split if early_split > 0 else num_samples // 2
        if early_term > 0.0 and not 1 <= k1 < num_samples:
            raise ValueError(f"early_split {k1} must be in [1, "
                             f"{num_samples})")
        geometry, sample = _frame_rays(sampler, camera)
        rays_per_cam = sampler.rays_per_camera
        device = sampler.device
        if cull:
            probe_subsample = self._safe_probe_subsample(sampler,
                                                         probe_subsample)
            mask = self._compute_hit(sampler, camera, probe_subsample)
            # the stable partition: hit rays in pixel order. nonzero()
            # reads the hit count on the host, once per pass; the JAX
            # package instead keeps a fixed chunk count and skips empty
            # chunks with lax.cond
            ray_offsets = torch.nonzero(mask).reshape(-1)
        else:
            ray_offsets = torch.arange(rays_per_cam, device=device)
            mask = geometry(ray_offsets)[4]
        colors = torch.zeros(rays_per_cam, 3, device=device)
        self.frame_rays = {"hit": int(ray_offsets.shape[0])}
        if cull and early_term > 0.0:
            trans = torch.zeros(rays_per_cam, device=device)
            for chunk, (color, trans_out) in self._chunks(
                    ray_offsets, chunk_size,
                    lambda c: self._render_prefix(sample, c, k1), mesh):
                colors[chunk] = color
                trans[chunk] = trans_out
            survivors = torch.nonzero(mask & (trans > early_term)).reshape(-1)
            self.frame_rays["survived"] = int(survivors.shape[0])
            suffix = torch.zeros(rays_per_cam, 3, device=device)
            for chunk, color in self._chunks(
                    survivors, chunk_size,
                    lambda c: self._render_suffix(sample, c, k1), mesh):
                suffix[chunk] = color
            colors = colors + trans[:, None] * suffix
        else:
            for chunk, color in self._chunks(
                    ray_offsets, chunk_size,
                    lambda c: self._render_rays(sample, c), mesh):
                colors[chunk] = color
        colors = torch.where(mask[:, None], colors, 0.0)
        image = torch.clamp(colors, 0.0, 1.0).reshape(
            sampler.image_height, sampler.image_width, 3)
        return (image * 255.0).to(torch.uint8)   # truncates, as the JAX frame

    def render_frame(self, sampler: RaySampler, camera: int,
                     chunk_size: int = 16384, cull_empty: bool = True,
                     probe_subsample: int = 2, early_term: float = 0.0,
                     early_split: int = 0,
                     color_space: str = "RGB", mesh=None) -> np.ndarray:
        """:meth:`render_frame_async`, copied to a host (H, W, 3) uint8
        array; a ``YCrCb`` model's frame is converted to RGB."""
        return _to_host(self.render_frame_async(
            sampler, camera, chunk_size, cull_empty, probe_subsample,
            early_term, early_split, mesh), color_space)

    @torch.no_grad()
    def render_frame_pose_async(self, sampler: RaySampler, camera,
                                chunk_size: int = 16384,
                                cull_empty: bool = True,
                                probe_subsample: int = 2,
                                early_term: float = 0.0,
                                early_split: int = 0,
                                mesh=None) -> torch.Tensor:
        """:meth:`render_frame_async` for any camera pose: ``camera`` is
        a :class:`CameraInfo` at the sampler's resolution (another
        resolution raises ``ValueError``) or a ``(ray_m, position)``
        calibration pair (:meth:`RaySampler.pose_calibration`). A rig
        camera's pose renders the indexed frame bit for bit. Its rays
        are keyed by pixel offset, and a focus sampler computes their
        CDFs on the fly. Under a ``mesh`` it is a collective, as
        :meth:`render_frame_async`."""
        if hasattr(camera, "extrinsics"):
            resolution = tuple(camera.resolution)
            expected = (sampler.image_width, sampler.image_height)
            if resolution != expected:
                raise ValueError(f"pose resolution {resolution} != sampler "
                                 f"resolution {expected}")
            camera = RaySampler.pose_calibration(camera, sampler.device)
        ray_m, position = camera
        return self._frame(sampler, (ray_m.to(sampler.device),
                                     position.to(sampler.device)),
                           chunk_size, cull_empty, probe_subsample,
                           early_term, early_split, mesh)

    def render_frame_pose(self, sampler: RaySampler, camera,
                          chunk_size: int = 16384, cull_empty: bool = True,
                          probe_subsample: int = 2, early_term: float = 0.0,
                          early_split: int = 0,
                          color_space: str = "RGB",
                          mesh=None) -> np.ndarray:
        """:meth:`render_frame_pose_async`, copied to a host (H, W, 3)
        uint8 array; a ``YCrCb`` model's frame is converted to RGB."""
        return _to_host(self.render_frame_pose_async(
            sampler, camera, chunk_size, cull_empty, probe_subsample,
            early_term, early_split, mesh), color_space)

    def render_image(self, sampler: RaySampler, index: int, batch_size: int,
                     color_space: str = "RGB") -> np.ndarray:
        """A camera's frame the chunked way (the JAX package's parity
        path): its valid rays' samples (``rays_for_camera``), rendered
        ``batch_size`` rays at a time, scattered into an (H, W, 3)
        uint8 image (``to_image``)."""
        camera = index % sampler.num_cameras
        samples = sampler.rays_for_camera(camera)
        pred = self.batched_render(samples, batch_size, False)
        return sampler.to_image(camera, pred.color, color_space)

    def to_scenepic(self, dataset, num_cameras=10, resolution=50,
                    num_samples=64, empty_threshold=0.1):
        """Model-state inspection scene (optional scenepic dependency,
        :func:`..scenepic_io.model_to_scenepic`)."""
        from ..scenepic_io import model_to_scenepic
        return model_to_scenepic(self, dataset, num_cameras, resolution,
                                 num_samples, empty_threshold)

    @torch.no_grad()
    def render_activations(self, sampler: RaySampler, index: int,
                           batch_size: int,
                           color_space: str = "RGB") -> np.ndarray:
        """An 8x8 grid of renders of one camera, one a unit of the
        model's last hidden layer (the JAX package's
        ``render_activations``).

        Cell ``u`` renders the camera with unit ``u``'s contribution as
        the model's output: its activation times its row of the last
        layer's weights, plus the last layer's bias. Needs a model with
        ``return_hidden`` (the FFN family) and at least 64 hidden units.
        The model runs in f32, ``batch_size`` rays at a time.

        Returns:
            (8 H, 8 W, 3) uint8 RGB image.
        """
        camera = index % sampler.num_cameras
        samples = sampler.rays_for_camera(camera)
        out_layer = self.model.layers[-1]
        palette = out_layer.weight.T     # (hidden, 4)
        num_rays = samples.positions.shape[0]
        unit_colors = []
        for start in range(0, num_rays, batch_size):
            positions = samples.positions[start:start + batch_size]
            t_values = samples.t_values[start:start + batch_size]
            _, hidden = self.model(positions.reshape(-1, 3),
                                   return_hidden=True)
            # (units, rays * samples, 4): unit u contributes
            # hidden[:, u] (outer) palette[u, :] + bias
            per_unit = (hidden.T[:, :, None] * palette[:, None, :]
                        + out_layer.bias)
            per_unit = per_unit.reshape(palette.shape[0], t_values.shape[0],
                                        -1, 4)
            weights = calculate_blend_weights(
                t_values, F.softplus(per_unit[..., 3]))
            unit_colors.append(torch.sum(
                weights[..., None] * torch.sigmoid(per_unit[..., :3]),
                dim=-2))
        unit_colors = torch.cat(unit_colors, dim=1).cpu().numpy()

        num_grid = 8
        cell_h, cell_w = sampler.image_height, sampler.image_width
        act_pixels = np.zeros((cell_h * num_grid, cell_w * num_grid, 3),
                              np.uint8)
        for i in range(num_grid):
            for j in range(num_grid):
                act_pixels[i * cell_h:(i + 1) * cell_h,
                           j * cell_w:(j + 1) * cell_w] = sampler.to_image(
                    camera, unit_colors[i * num_grid + j], color_space)
        return act_pixels

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def _train_forward(self, rays: RaySamples) -> RenderResult:
        """Differentiable forward for training: the fused custom-autograd
        kernels when enabled (``self.fused_train``), otherwise autograd
        of the plain model."""
        num_rays, num_samples = rays.t_values.shape
        positions = rays.positions.reshape(-1, 3)
        views = rays.view_directions.reshape(-1, 3)
        if self.fused_train:
            dtype = (self.compute_dtype if self.compute_dtype is not None
                     else torch.float32)
            # packed from the live parameters, so autograd carries the
            # packed gradients back to them
            packed = pack_fused_nerf(self.model, dtype)
            logits = fused_nerf_train_apply(packed, positions, views)
        else:
            logits = query_model(self.model, positions, views,
                                 self.compute_dtype)
        return _composite(logits.reshape(num_rays, num_samples, 4),
                          rays.t_values, False)

    def _make_train_step(self, dataset, batch_size: int,
                         learning_rate: float, decay_rate: float,
                         decay_steps: int, optimizer: ClippedAdam,
                         steps_per_call: int = 1, mesh=None):
        """The training step: sample the batch's rays, forward, loss,
        backward, clipped Adam at the step's learning rate.

        The step keeps the sampler the dataset had when it was built.
        With ``steps_per_call`` 1 it is eager and reads the dataset's
        mode on every call, so the crop curriculum's mode switches
        (Dilate drops the alpha term) take effect at once; it returns
        the step's loss.

        With ``steps_per_call`` N > 1 one call runs N steps, inner step
        ``k`` drawing ``perm[(offset + k * batch_size) % modulo:][:
        batch_size]`` (``modulo = max(len(perm) - batch_size + 1, 1)``)
        at step ``step + k``, as the JAX package's ``multi_step``; it
        returns the last step's loss. On CUDA the N steps are one CUDA
        graph (:class:`_GraphChunk`), which reads the dataset's mode
        when it is captured: a step built before a switch into Dilate
        must be built again, as the JAX package rebuilds its step. On
        the CPU they run as an eager loop.

        Under a ``mesh`` (JAX's shard_map step, ``parallel/
        data_parallel.py``) ``batch_size`` is the global batch, which must
        divide by the mesh size: rank ``r`` takes rows ``[r * local, (r +
        1) * local)`` of it, and the loss and the gradients are averaged
        over the ranks (one all-reduce, then a division) before the
        clip and the Adam step, which every rank runs on the same
        values. The stratified jitter is keyed by the global ray id.
        On CUDA a graph chunk captures the all-reduce.
        """
        sampler = dataset.sampler
        shard = slice(0, batch_size)
        if mesh is not None:
            if batch_size % mesh.size:
                raise ValueError(f"batch_size {batch_size} must divide "
                                 f"evenly over the {mesh.size}-device mesh")
            shard = mesh.shard(batch_size)

        def one_step(idx, step, rng):
            idx = idx[shard]
            rays = sampler.sample(idx, step,
                                  rng if sampler.stratified else None)
            optimizer.zero_grad()
            loss = dataset.loss(idx, self._train_forward(rays))
            loss.backward()
            loss = loss.detach()
            if mesh is not None:
                # JAX's order: the mean over the ranks first, then clip
                mesh.all_reduce_mean_([loss] + [p.grad for p
                                                in optimizer.params])
            optimizer.step(exponential_lr(learning_rate, step, decay_rate,
                                          decay_steps))
            return loss

        if steps_per_call <= 1:
            def train_step(perm: torch.Tensor, offset: int, step: int,
                           rng: int) -> torch.Tensor:
                return one_step(perm[offset:offset + batch_size], step, rng)

            return train_step
        if sampler.device.type == "cuda":
            def chunk_fn(inputs):
                perm = inputs["perm"]
                modulo = max(perm.shape[0] - batch_size + 1, 1)
                rows = torch.arange(min(batch_size, perm.shape[0]),
                                    device=perm.device)
                loss = None
                for k in range(steps_per_call):
                    start = (inputs["offset"] + k * batch_size) % modulo
                    loss = one_step(perm[start + rows], inputs["step"] + k,
                                    inputs["seed"])
                return loss

            def drop_pack():
                # the replay moved the weights without bumping their
                # version counters
                self._fused_key = None

            return _GraphChunk(chunk_fn, optimizer,
                               ("perm", "offset", "step", "seed"), drop_pack)

        def eager_chunk(perm: torch.Tensor, offset: int, step: int,
                        rng: int) -> torch.Tensor:
            modulo = max(perm.shape[0] - batch_size + 1, 1)
            for k in range(steps_per_call):
                start = (offset + k * batch_size) % modulo
                loss = one_step(perm[start:start + batch_size], step + k, rng)
            return loss

        return eager_chunk

    @torch.no_grad()
    def _validate(self, dataset, batch_size: int, step: int) -> float:
        """PSNR over <= 102,400 evenly strided valid rays of the active
        mode, in whole batches of ``batch_size``."""
        num_rays = len(dataset)
        num_validate = min(num_rays, 1024 * 100)
        if num_validate < num_rays:
            val_index = np.linspace(0, num_rays, num_validate,
                                    endpoint=False).astype(np.int64)
        else:
            val_index = np.arange(num_rays)
        if dataset.mode != dataset.Mode.Full:
            val_index = dataset._mode_index(dataset.mode)[val_index]
        val_index = dataset.to_valid(val_index)
        num_batches = len(val_index) // batch_size
        if num_batches == 0:
            return float("nan")
        batches = torch.from_numpy(
            val_index[:num_batches * batch_size]).to(dataset.device).reshape(
                num_batches, batch_size)
        losses = torch.stack([
            dataset.loss(idx, self._train_forward(
                dataset.sampler.sample(idx, step, None)))
            for idx in batches])
        mean_loss = float(losses.mean())
        return float(-10.0 * np.log10(max(mean_loss, 1e-10)))

    def fit(self, train_dataset, val_dataset, batch_size: int,
            learning_rate: float, num_steps: int, crop_steps: int,
            report_interval: int, decay_rate: float, decay_steps: int,
            weight_decay: float = 0.0, visualizers=(), seed: int = 0,
            mesh=None, checkpoint_dir: Optional[str] = None,
            checkpoint_interval: Optional[int] = None,
            resume: bool = False, steps_per_call: int = 1,
            occupancy_interval: Optional[int] = None,
            occupancy_samples: int = 48,
            occupancy_start: Optional[int] = None,
            occupancy_end: Optional[int] = None,
            occupancy_empty_weight: float = 0.1,
            occupancy_mix: int = 0) -> List[LogEntry]:
        """Fits the model (in place) to the dataset.

        Args:
            train_dataset / val_dataset: ray datasets on the model's
                device.
            batch_size: rays per training step.
            learning_rate / decay_rate / decay_steps: per-step
                exponential LR schedule.
            num_steps: the last step (steps 0..num_steps run; a chunk
                may run past it, as in the JAX package).
            crop_steps: steps of center-crop curriculum at the start.
            report_interval: steps between train/val PSNR reports.
            weight_decay: Adam L2 weight decay.
            visualizers: objects with
                ``visualize(step, render_fn, act_fn)``.
            seed: seeds the epoch shuffles and the stratified jitter
                (a CPU ``torch.Generator``; after a resume it is keyed
                by the seed and the first step).
            mesh: a data-parallel mesh (:func:`..parallel.make_mesh`):
                ``batch_size`` is the global batch, every rank runs this
                call with the same arguments, rank 0's weights are
                broadcast first, each rank trains on its slab of every
                batch (:meth:`_make_train_step`) and validates every
                ray; only rank 0 prints, writes checkpoints and runs the
                visualizers. The occupancy grid is refreshed on every
                rank from the same weights.
            checkpoint_dir / checkpoint_interval: write a resumable
                train-state checkpoint (:mod:`..utils.checkpoint`) in
                the background whenever a call's steps cover a multiple
                of ``checkpoint_interval``.
            resume: restore the newest checkpoint in ``checkpoint_dir``
                (weights and Adam state, copied in place into the
                module and the optimizer) and start at its step + 1.
            steps_per_call: steps per call of the train step,
                ``min(steps_per_call, report_interval)``: on CUDA one
                CUDA-graph replay (see :meth:`_make_train_step`);
                reports, checkpoints and visualizers land on call
                boundaries.
            occupancy_interval: occupancy-guided training: from
                ``occupancy_start`` (default ``max(crop_steps, 1000)``)
                the train rays are sampled by a stratified
                :class:`OccupancyGridSampler` at ``occupancy_samples``
                samples a ray over the live model's density grid
                (:func:`density_grid_from_model`), refreshed in place
                every ``occupancy_interval`` steps; from
                ``occupancy_end`` the dataset's own sampler returns.
                ``occupancy_empty_weight`` is the CDF mass of empty
                probes; ``occupancy_mix`` steps through the dataset's
                own sampler follow each guided call. Validation keeps
                the dataset's own sampler.

        Returns:
            The LogEntry of every report interval. The time of each
            call of the train step per step it ran (host clock, or CUDA
            events on a GPU, validation and visualizers excluded) is
            left in ``self.step_ms``, its step count in
            ``self.call_steps``, the host time to issue it in
            ``self.host_ms`` and each occupancy refresh's time in
            ``self.occupancy_refresh_ms``.
        """
        from ..utils.checkpoint import (
            AsyncCheckpointer,
            latest_checkpoint,
            load_train_state,
        )
        from .occupancy_sampler import (
            OccupancyGridSampler,
            density_grid_from_model,
        )

        primary = mesh is None or mesh.is_primary
        say = print if primary else (lambda *args, **kwargs: None)
        device = train_dataset.device
        chunk = max(1, min(steps_per_call, report_interval))
        trainval_dataset = train_dataset.sample_cameras(
            val_dataset.num_cameras, val_dataset.num_samples, False)
        optimizer = ClippedAdam(
            self.model.parameters(), learning_rate, weight_decay,
            capturable=device.type == "cuda" and max(chunk,
                                                     occupancy_mix) > 1)
        start_step = 0
        if resume and checkpoint_dir:
            path = latest_checkpoint(checkpoint_dir)
            if path:
                state = load_train_state(path)
                params_from_jax(self.model, state.params)
                optimizer.load_jax_state(named_parameters(self.model),
                                         *state.opt_state)
                start_step = state.step + 1
                say(f"Resumed from {path} at step {start_step}")
        if mesh is not None:
            from ..parallel import replicate
            replicate(self.model, mesh)
        generator = torch.Generator().manual_seed(
            seed if start_step == 0 else hash((seed, start_step)) % 2 ** 63)

        modes = train_dataset.Mode
        dataset_mode = train_dataset.mode
        if crop_steps and start_step < crop_steps:
            train_dataset.mode = modes.Center
            val_dataset.mode = modes.Center
            trainval_dataset.mode = modes.Center
        else:
            val_dataset.mode = dataset_mode
            trainval_dataset.mode = dataset_mode

        def make_step(calls):
            return self._make_train_step(train_dataset, batch_size,
                                         learning_rate, decay_rate,
                                         decay_steps, optimizer, calls,
                                         mesh)

        train_step = make_step(chunk)

        def render_image_fn(samples: RaySamples, include_depth: bool):
            return self.batched_render(samples, max(batch_size, 16384),
                                       include_depth)

        def render_act_fn(sampler, camera):
            return self.render_activations(sampler, camera, batch_size,
                                           train_dataset.color_space)

        checkpointer = None
        if checkpoint_dir and checkpoint_interval and primary:
            checkpointer = AsyncCheckpointer(checkpoint_dir)

        base_sampler = train_dataset.sampler
        occupancy_active = occupancy_done = False
        mix_step = None
        if occupancy_interval:
            if base_sampler.focus_sampling:
                raise ValueError("occupancy-guided training is "
                                 "incompatible with a focus/opacity sampler")
            if occupancy_start is None:
                occupancy_start = max(crop_steps, 1000)
        self.occupancy_refresh_ms = []

        def update_occupancy():
            """Installs (first call) or refreshes in place the
            density-grid sampler of the train rays."""
            nonlocal train_step, occupancy_active, mix_step
            start = time.perf_counter()
            scale = float(base_sampler.bounds_max[0])
            grid = density_grid_from_model(self.model, scale=scale)
            if occupancy_active:
                train_dataset.sampler.set_occupancy_grid(grid)
                self.occupancy_refresh_ms.append(
                    (time.perf_counter() - start) * 1e3)
                return
            say(f"Enabling occupancy-guided sampling ({occupancy_samples} "
                "samples/ray" + (f", {occupancy_mix} full steps/chunk"
                                 if occupancy_mix else "") + ")...")
            if occupancy_mix and mix_step is None:
                # the anchor step, built while the dataset still has its
                # own sampler
                mix_step = make_step(occupancy_mix)
            occupancy = OccupancyGridSampler(
                grid, scale, base_sampler.cameras, occupancy_samples,
                empty_weight=occupancy_empty_weight,
                bounds=base_sampler.bounds, device=base_sampler.device,
                stratified=base_sampler.stratified)
            # the same cameras and bounds: share the base sampler's
            # per-ray tables instead of building them again
            occupancy.__dict__["ray_tables"] = base_sampler.ray_tables
            train_dataset.sampler = occupancy
            train_step = make_step(chunk)
            occupancy_active = True

        timer = _StepTimer(device)
        self.call_steps = []
        log: List[LogEntry] = []
        step = start_step
        start_time = time.time()

        def run(fn, perm, offset, first_step, rng, steps):
            timer.start()
            fn(perm, offset, first_step, rng)
            timer.stop()
            self.call_steps.append(steps)

        try:
            while step <= num_steps:
                pool = torch.from_numpy(train_dataset.index_pool())
                perm = pool[torch.randperm(len(pool),
                                           generator=generator)].to(device)
                strat_key = int(torch.randint(0, 2 ** 31, (1,),
                                              generator=generator))
                num_batches = len(pool) // batch_size
                restart_epoch = False
                for batch_num in range(0, max(num_batches, chunk), chunk):
                    if step > num_steps or restart_epoch:
                        break
                    run(train_step, perm, batch_num * batch_size, step,
                        strat_key, chunk)
                    # this call ran steps [first, last]; reports,
                    # checkpoints and visualizers anchor on `last`
                    first, last = step, step + chunk - 1
                    step = last + 1
                    if occupancy_active and mix_step is not None:
                        # the anchor: full-sampling steps through the
                        # dataset's own sampler after each guided call
                        modulo = max(len(pool) - batch_size + 1, 1)
                        run(mix_step, perm,
                            ((batch_num + chunk) * batch_size) % modulo,
                            step, strat_key, occupancy_mix)
                        last = step + occupancy_mix - 1
                        step = last + 1

                    # due when [first, last] covers a multiple of the
                    # interval; single-step runs also report steps 0-9
                    interval_due = (last // report_interval
                                    > (first - 1) // report_interval)
                    if interval_due or (chunk == 1 and last < 10):
                        train_psnr = self._validate(trainval_dataset,
                                                    batch_size, last)
                        val_psnr = self._validate(val_dataset, batch_size,
                                                  last)
                        current_time = time.time()
                        # over the steps of this run, not since step 0
                        steps_run = last - start_step
                        time_per_step = ((current_time - start_time)
                                         / steps_run
                                         if steps_run >= report_interval
                                         else 0)
                        say("{:07}".format(last),
                            "{:2f} s/step".format(time_per_step),
                            "psnr_train: {:2f}".format(train_psnr),
                            "val_psnr: {:2f}".format(val_psnr))
                        if interval_due:
                            log.append(LogEntry(last,
                                                current_time - start_time,
                                                params_to_jax(self.model),
                                                train_psnr, val_psnr))
                        if (train_dataset.mode == modes.Center
                                and last >= crop_steps):
                            say("Removing center crop...")
                            train_dataset.mode = dataset_mode
                            val_dataset.mode = dataset_mode
                            trainval_dataset.mode = dataset_mode
                            if dataset_mode == modes.Dilate:
                                # a captured chunk read the Center
                                # mode's loss; Dilate drops the alpha
                                # term
                                train_step = make_step(chunk)
                            restart_epoch = True

                    if (checkpointer is not None and last > start_step
                            and last // checkpoint_interval
                            > (first - 1) // checkpoint_interval):
                        checkpointer.save(self.model, optimizer, last, seed)

                    if (occupancy_active and occupancy_end is not None
                            and last >= occupancy_end):
                        say("Restoring full sampling for the fine-tune "
                            "tail...")
                        train_dataset.sampler = base_sampler
                        train_step = make_step(chunk)
                        occupancy_active = False
                        occupancy_done = True
                    elif (occupancy_interval and not occupancy_done
                          and last >= occupancy_start
                          and train_dataset.mode != modes.Center
                          and (not occupancy_active
                               or last // occupancy_interval
                               > (first - 1) // occupancy_interval)):
                        update_occupancy()

                    if not restart_epoch and primary:
                        for visualizer in visualizers:
                            visualizer.visualize(last, render_image_fn,
                                                 render_act_fn)
        finally:
            # on a normal exit and an interruption alike: the dataset
            # gets its own sampler back and the writer is joined
            if checkpointer is not None:
                checkpointer.close()
            if occupancy_active:
                train_dataset.sampler = base_sampler
        self.step_ms = [ms / steps for ms, steps
                        in zip(timer.milliseconds(), self.call_steps)]
        self.host_ms = timer.host_ms
        return log


def _frame_rays(sampler: RaySampler, camera):
    """(geometry, sample) of one frame's rays: functions of (R,) pixel
    offsets giving (starts, directions, near, far, valid) and their
    RaySamples. ``camera`` is a rig index or a ``(ray_m, position)``
    calibration on the sampler's device."""
    if isinstance(camera, tuple):
        ray_m, position = camera
        return (lambda off: sampler.pose_ray_geometry(ray_m, position, off),
                lambda off: sampler.sample_pose_rays(ray_m, position,
                                                     off)[0])
    return (lambda off: sampler.camera_ray_geometry(camera, off),
            lambda off: sampler.sample_camera_rays(camera, off)[0])


def _to_host(image: torch.Tensor, color_space: str) -> np.ndarray:
    """A device uint8 frame as a host array, a ``YCrCb`` frame in RGB."""
    image = image.cpu().numpy()
    if color_space == "YCrCb":
        image = ycrcb_to_rgb(image)
    return image


class _GraphChunk:
    """Several optimizer steps as one CUDA graph.

    ``chunk_fn(inputs)`` runs the chunk's steps on ``inputs``, a dict of
    static device tensors named by ``names``: each call's positional
    arguments in that order, an int written into a 0-d int64 tensor
    (a counter: the first step, an offset, a key) and a tensor copied
    into a static one. So nothing in the graph reads the host. The graph
    is captured at the first call, and again when a tensor argument's
    shape changes (the train step's perm, in a new sampling mode):
    first one eager warm-up chunk on a side stream (the slab-image index
    uploads, the optimizer state, the library handles), after which the
    optimizer's parameters and state are restored, then the capture.
    Capture errors are raised, naming ``--steps-per-call``; the chunk
    never runs eagerly in its stead. Under a data-parallel mesh the
    graph holds the all-reduce of the step's gradients (the warm-up
    chunk runs it once first, on the process group made before). Under autograd's NaN check (``utils.debug.enable_debug_nans``,
    ``FFN_TORCH_DEBUG_NANS``), which reads every gradient on the host,
    the capture raises ``ValueError``. A call returns what ``chunk_fn`` returned at the capture (a
    static tensor the next replay overwrites); ``on_replay`` runs after
    each replay.

    ``captured`` holds each kernel wrapper's launches recorded into the
    graph, ``replays`` the number of replays: a replay launches the
    graph, not the wrappers, so their counts do not grow with it.
    """

    def __init__(self, chunk_fn, optimizer: ClippedAdam, names,
                 on_replay=None):
        if not optimizer.capturable:
            raise ValueError("a CUDA-graph chunk needs a capturable "
                             "ClippedAdam")
        self.chunk_fn = chunk_fn
        self.optimizer = optimizer
        self.names = tuple(names)
        self.on_replay = on_replay
        self.graph = None
        self.inputs = None
        self.result = None
        self.captured = {}
        self.replays = 0
        self.captures = 0

    def _capture(self, values, device) -> None:
        if debug_nans_enabled():
            raise ValueError(
                "a CUDA-graph chunk (--steps-per-call > 1 on CUDA) cannot "
                "run under the debug NaN check (enable_debug_nans, "
                "FFN_TORCH_DEBUG_NANS), whose host reads a graph cannot "
                "capture: turn one of them off")
        self.graph = self.result = None
        self.inputs = {
            name: (value.clone() if isinstance(value, torch.Tensor)
                   else torch.zeros((), dtype=torch.int64, device=device))
            for name, value in zip(self.names, values)}
        state = [*self.optimizer.params, *self.optimizer.state_tensors()]
        with torch.no_grad():
            saved = [t.detach().clone() for t in state]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self.chunk_fn(self.inputs)
        torch.cuda.current_stream(device).wait_stream(side)
        with torch.no_grad():
            for tensor, value in zip(state, saved):
                tensor.copy_(value)
        self.optimizer.zero_grad()
        before = _kernel_launches()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                self.result = self.chunk_fn(self.inputs)
        except RuntimeError as error:
            raise RuntimeError(
                "capturing the CUDA graph of a chunk of steps "
                f"(--steps-per-call > 1 on CUDA) failed: {error}") from error
        after = _kernel_launches()
        self.captured = {name: after[name] - before[name] for name in after}
        self.graph = graph
        self.captures += 1

    def __call__(self, *values):
        """Writes ``values`` into the static inputs, replays the graph
        (capturing it first when needed) and returns the chunk's
        result."""
        device = self.optimizer.params[0].device
        if self.graph is None or any(
                isinstance(v, torch.Tensor)
                and v.shape != self.inputs[name].shape
                for name, v in zip(self.names, values)):
            self._capture(values, device)
        for name, value in zip(self.names, values):
            if isinstance(value, torch.Tensor):
                self.inputs[name].copy_(value)
            else:
                self.inputs[name].fill_(value)
        self.graph.replay()
        self.replays += 1
        if self.on_replay is not None:
            self.on_replay()
        return self.result


def _kernel_launches() -> dict:
    """The launch counts of the kernels a train step can run."""
    from ..kernels.fused_nerf import fused_nerf_apply
    from ..kernels.fused_nerf_train import fused_nerf_backward
    return {"fused_nerf": fused_nerf_apply.launches,
            "fused_nerf_train": fused_nerf_backward.launches}


class _StepTimer:
    """Wall time of each call of the train step: CUDA events on a GPU
    (read once at the end, so timing adds no synchronisation), the host
    clock elsewhere; ``host_ms`` holds the host clock's time to issue
    each call."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []
        self.host_ms = []
        self._host_start = 0.0

    def start(self):
        self.marks.append([self._mark(), None])
        self._host_start = time.perf_counter()

    def stop(self):
        self.host_ms.append((time.perf_counter() - self._host_start) * 1e3)
        self.marks[-1][1] = self._mark()

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def milliseconds(self) -> List[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self.marks]
        return [(b - a) * 1e3 for a, b in self.marks]
