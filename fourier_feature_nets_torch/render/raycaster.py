"""Volumetric raycaster and trainer.

Port of ``fourier_feature_nets_tpu/render/raycaster.py``: ``_composite``,
``Raycaster.render``/``batched_render``, the whole-frame renderer
``render_frame``/``render_frame_async`` with empty-space culling, and
the trainer: ``_train_forward``, ``_make_train_step``, ``_validate``
and ``fit``. The JAX package compiles a frame into one ``lax.scan`` and
a train step into one jitted function; here both are eager PyTorch.
On a CUDA device NeRF queries go through the fused Hopper kernels:
K1 (:mod:`..kernels.fused_nerf`) for rendering, K1 forward and K2
backward (:mod:`..kernels.fused_nerf_train`) for training.

Pose rendering, early termination, occupancy-guided training,
checkpoint/resume and the data-parallel mesh are not ported yet
(ROADMAP.md, queue 1).
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
from ..models.serialization import params_to_jax
from ..ops import calculate_blend_weights
from ..utils.errors import not_ported
from ..utils.optim import ClippedAdam, exponential_lr
from ..utils.progress import LogEntry
from .ray_sampler import RaySampler, RaySamples

__all__ = ["Raycaster", "RenderResult"]


class RenderResult(NamedTuple):
    """Per-ray render outputs (``datasets/ray_dataset.py::RenderResult``
    in the JAX package)."""

    color: torch.Tensor
    alpha: torch.Tensor
    depth: Optional[torch.Tensor]


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
                wrapper. None (default) = on for a NeRF on a CUDA
                device, off elsewhere. With True on the CPU the wrapper
                runs the kernel's plain twin.
            fused_train: route training forwards through the fused
                recompute-backward (K1 forward, K2 backward). None
                (default) = on for a NeRF on a CUDA device, off
                elsewhere; with True on the CPU the wrappers run the
                kernels' plain twins. Off trains through autograd of
                the plain model.
        """
        self.model = model
        self.compute_dtype = compute_dtype
        is_nerf = getattr(model, "model_type", None) == "nerf"
        on_cuda = next(model.parameters()).is_cuda
        if fused is None:
            fused = on_cuda
        if fused_train is None:
            fused_train = on_cuda
        self.fused = bool(fused) and is_nerf
        self.fused_train = bool(fused_train) and is_nerf
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
        return self.model(positions, views, compute_dtype=self.compute_dtype)

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

    def _render_rays(self, sampler: RaySampler, camera: int,
                     offsets: torch.Tensor) -> torch.Tensor:
        """(R,) pixel offsets of one camera -> (R, 3) colors."""
        rays, _ = sampler.sample_camera_rays(camera, offsets)
        return self.render(rays).color

    @staticmethod
    def _compute_hit(sampler, camera: int, probe_subsample: int):
        """Probe phase of the culled frame: which of the frame's rays
        touch occupied space. With ``probe_subsample`` s > 1 only every
        s-th pixel in each image axis is probed and the coarse hit
        raster is 3x3 max-dilated before upsampling: a ray is culled
        only when its probe and every neighboring coarse probe miss."""
        height, width = sampler.image_height, sampler.image_width
        device = sampler.device
        offsets = torch.arange(sampler.rays_per_camera, device=device)
        _, _, _, _, valid = sampler.camera_ray_geometry(camera, offsets)
        if probe_subsample > 1:
            s = probe_subsample
            coarse_h = -(-height // s)
            coarse_w = -(-width // s)
            cy = torch.clamp(torch.arange(coarse_h, device=device) * s,
                             max=height - 1)
            cx = torch.clamp(torch.arange(coarse_w, device=device) * s,
                             max=width - 1)
            coarse_off = (cy[:, None] * width + cx[None, :]).reshape(-1)
            cs, cd, cn, cf, cvalid = sampler.camera_ray_geometry(
                camera, coarse_off)
            _, _, hit_c = sampler._probe_cdf_geometry(cs, cd, cn, cf)
            grid = (hit_c & cvalid).reshape(1, 1, coarse_h, coarse_w)
            dilated = F.max_pool2d(grid.float(), 3, stride=1, padding=1) > 0
            fine = dilated[0, 0].repeat_interleave(s, 0).repeat_interleave(
                s, 1)[:height, :width]
            hit = fine.reshape(-1)
        else:
            starts, dirs, near, far, _ = sampler.camera_ray_geometry(
                camera, offsets)
            _, _, hit = sampler._probe_cdf_geometry(starts, dirs, near, far)
        return hit & valid

    @torch.no_grad()
    def render_frame_async(self, sampler: RaySampler, camera: int,
                           chunk_size: int = 16384,
                           cull_empty: bool = True,
                           probe_subsample: int = 2) -> torch.Tensor:
        """Renders one camera frame and returns it as an (H, W, 3) uint8
        tensor on the render device, without a host copy.

        With ``cull_empty`` and a sampler that probes occupancy
        (:class:`OccupancyGridSampler`), rays whose probes all miss are
        never sent to the model and render black. Invalid rays (missing
        the volume) render black.
        """
        camera = camera % sampler.num_cameras
        rays_per_cam = sampler.rays_per_camera
        device = sampler.device
        cull = cull_empty and hasattr(sampler, "_probe_cdf_geometry")
        if cull:
            probe_subsample = self._safe_probe_subsample(sampler,
                                                         probe_subsample)
            mask = self._compute_hit(sampler, camera, probe_subsample)
            # the stable partition: hit rays in pixel order. nonzero()
            # reads the hit count on the host, once per frame; the JAX
            # package instead keeps a fixed chunk count and skips empty
            # chunks with lax.cond
            ray_offsets = torch.nonzero(mask).reshape(-1)
        else:
            ray_offsets = torch.arange(rays_per_cam, device=device)
            mask = sampler.camera_ray_geometry(camera, ray_offsets)[4]
        colors = torch.zeros(rays_per_cam, 3, device=device)
        for start in range(0, ray_offsets.shape[0], chunk_size):
            chunk = ray_offsets[start:start + chunk_size]
            colors[chunk] = self._render_rays(sampler, camera, chunk)
        colors = torch.where(mask[:, None], colors, 0.0)
        image = torch.clamp(colors, 0.0, 1.0).reshape(
            sampler.image_height, sampler.image_width, 3)
        return (image * 255.0).to(torch.uint8)   # truncates, as the JAX frame

    def render_frame(self, sampler: RaySampler, camera: int,
                     chunk_size: int = 16384, cull_empty: bool = True,
                     probe_subsample: int = 2) -> np.ndarray:
        """:meth:`render_frame_async`, copied to a host (H, W, 3) uint8
        array."""
        return self.render_frame_async(sampler, camera, chunk_size,
                                       cull_empty,
                                       probe_subsample).cpu().numpy()

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def _train_forward(self, rays: RaySamples) -> RenderResult:
        """Differentiable forward for training: the fused custom-autograd
        kernels when enabled, otherwise autograd of the plain model."""
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
            logits = self.model(positions, views,
                                compute_dtype=self.compute_dtype)
        return _composite(logits.reshape(num_rays, num_samples, 4),
                          rays.t_values, False)

    def _make_train_step(self, dataset, batch_size: int,
                         learning_rate: float, decay_rate: float,
                         decay_steps: int, optimizer: ClippedAdam):
        """One training step: sample the batch's rays, forward, loss,
        backward, clipped Adam at the step's learning rate. The step
        keeps the sampler the dataset had when it was built; it reads
        the dataset's mode on every call, so the crop curriculum's
        mode switches (Dilate drops the alpha term) take effect at
        once."""
        sampler = dataset.sampler

        def train_step(perm: torch.Tensor, offset: int, step: int,
                       rng: int) -> torch.Tensor:
            idx = perm[offset:offset + batch_size]
            rays = sampler.sample(idx, step,
                                  rng if sampler.stratified else None)
            optimizer.zero_grad()
            loss = dataset.loss(idx, self._train_forward(rays))
            loss.backward()
            optimizer.step(exponential_lr(learning_rate, step, decay_rate,
                                          decay_steps))
            return loss.detach()

        return train_step

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
            occupancy_interval: Optional[int] = None) -> List[LogEntry]:
        """Fits the model (in place) to the dataset.

        Args:
            train_dataset / val_dataset: ray datasets on the model's
                device.
            batch_size: rays per training step.
            learning_rate / decay_rate / decay_steps: per-step
                exponential LR schedule.
            num_steps: the last step (steps 0..num_steps run).
            crop_steps: steps of center-crop curriculum at the start.
            report_interval: steps between train/val PSNR reports.
            weight_decay: Adam L2 weight decay.
            visualizers: objects with
                ``visualize(step, render_fn, act_fn)``.
            seed: seeds the epoch shuffles and the stratified jitter
                (a CPU ``torch.Generator``).
            mesh / checkpoint_dir / checkpoint_interval / resume /
                steps_per_call > 1 / occupancy_interval: not ported;
                each raises ``NotImplementedError``.

        Returns:
            The LogEntry of every report interval. The wall time of
            each training step (host clock, or CUDA events on a GPU,
            validation and visualizers excluded) is left in
            ``self.step_ms``.
        """
        if mesh is not None:
            raise not_ported("data-parallel training (a mesh)",
                             "Remaining models, data, CLIs and parallel")
        if checkpoint_dir or checkpoint_interval or resume:
            raise not_ported("checkpoint/resume", "Training")
        if steps_per_call > 1:
            raise not_ported("steps_per_call > 1 (a TPU dispatch knob; "
                             "its counterpart is a CUDA-graph step)",
                             "Training")
        if occupancy_interval:
            raise not_ported("occupancy-guided training", "Training")
        generator = torch.Generator().manual_seed(seed)
        trainval_dataset = train_dataset.sample_cameras(
            val_dataset.num_cameras, val_dataset.num_samples, False)
        optimizer = ClippedAdam(self.model.parameters(), learning_rate,
                                weight_decay)
        modes = train_dataset.Mode
        dataset_mode = train_dataset.mode
        if crop_steps:
            train_dataset.mode = modes.Center
            val_dataset.mode = modes.Center
            trainval_dataset.mode = modes.Center
        else:
            val_dataset.mode = dataset_mode
            trainval_dataset.mode = dataset_mode
        train_step = self._make_train_step(train_dataset, batch_size,
                                           learning_rate, decay_rate,
                                           decay_steps, optimizer)

        def render_image_fn(samples: RaySamples, include_depth: bool):
            return self.batched_render(samples, max(batch_size, 16384),
                                       include_depth)

        def render_act_fn(sampler, camera):
            raise not_ported("activation renders",
                             "Remaining models, data, CLIs and parallel")

        device = train_dataset.device
        timer = _StepTimer(device)
        log: List[LogEntry] = []
        step = 0
        start_time = time.time()
        while step <= num_steps:
            pool = torch.from_numpy(train_dataset.index_pool())
            perm = pool[torch.randperm(len(pool), generator=generator)].to(
                device)
            strat_key = int(torch.randint(0, 2 ** 31, (1,),
                                          generator=generator))
            num_batches = len(pool) // batch_size
            for batch_num in range(max(num_batches, 1)):
                if step > num_steps:
                    break
                timer.start()
                train_step(perm, batch_num * batch_size, step, strat_key)
                timer.stop()
                last = step
                step += 1
                restart_epoch = False
                if last % report_interval == 0 or last < 10:
                    train_psnr = self._validate(trainval_dataset, batch_size,
                                                last)
                    val_psnr = self._validate(val_dataset, batch_size, last)
                    current_time = time.time()
                    time_per_step = ((current_time - start_time) / last
                                     if last >= report_interval else 0)
                    print("{:07}".format(last),
                          "{:2f} s/step".format(time_per_step),
                          "psnr_train: {:2f}".format(train_psnr),
                          "val_psnr: {:2f}".format(val_psnr))
                    if last % report_interval == 0:
                        log.append(LogEntry(last, current_time - start_time,
                                            params_to_jax(self.model),
                                            train_psnr, val_psnr))
                    if (train_dataset.mode == modes.Center
                            and last >= crop_steps):
                        print("Removing center crop...")
                        train_dataset.mode = dataset_mode
                        val_dataset.mode = dataset_mode
                        trainval_dataset.mode = dataset_mode
                        restart_epoch = True
                if restart_epoch:
                    break
                for visualizer in visualizers:
                    visualizer.visualize(last, render_image_fn,
                                         render_act_fn)
        self.step_ms = timer.milliseconds()
        return log


class _StepTimer:
    """Wall time of each training step: CUDA events on a GPU (read once
    at the end, so timing adds no synchronisation), the host clock
    elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def start(self):
        self.marks.append([self._mark(), None])

    def stop(self):
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
