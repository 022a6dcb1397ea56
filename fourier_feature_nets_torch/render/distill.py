"""Teacher -> student radiance-field distillation (baking a serving model).

Port of ``fourier_feature_nets_tpu/render/distill.py``: a smaller student
NeRF is trained directly against a trained teacher's field (of any model
type: a NeRF, an FFN, a voxel field), at the
sample points of rays a renderer asks for (a camera rig and a sampler),
with no dataset. The loss matches, per sample point,

    rgb:    || sigmoid(c_s) - sigmoid(c_t) ||^2, weighted by the
            teacher's alpha plus ``rgb_floor`` (color is unobservable
            where the field is empty; the floor keeps gradients there);
    alpha:  (1 - exp(-softplus(o) * delta)) of both, on the rays' own
            sample spacings,

both masked to the rays that hit the volume. Adam has torch semantics
with L2 ``weight_decay`` and no clipping, at ``exponential_lr``.

With the kernels (``fused_teacher`` / ``fused_student``; None: for a
NeRF on CUDA, as the JAX package turns its kernels on on a TPU) a
frozen NeRF teacher runs K1 from one bf16 pack built once, and the
student runs K1 forward and K2 backward (``fused_nerf_train_apply``) on
a bf16 pack of its live weights, rebuilt each step; both packs are bf16
whatever ``compute_dtype`` is, as in the JAX package. The kernels take a
NeRF only: another teacher is always queried plain
(``models.module.query_model``, without the views when it takes none).
Without them both run the plain model at ``compute_dtype``.

Each step draws its camera, its pixels and the sampler's jitter on the
device from a stateless hash of (seed, absolute step)
(:func:`draw_rays`, ``ops.sampling.per_ray_uniform``), so a resumed run
repeats the uninterrupted one; the bits differ from the JAX package's
threefry draws. ``steps_per_call`` > 1 runs each chunk of steps as one
CUDA-graph replay on CUDA (``raycaster._GraphChunk``) and as an eager
loop with the same schedule elsewhere.

Where the JAX package's distill has known faults, the port holds to the
intended behaviour (ROADMAP.md, queue 3): a chunk is clamped to the
steps that remain; a resume of a finished run returns no losses; a
resume checks the checkpoint's model and seed and raises on a mismatch.
"""

from typing import Callable, List, Optional

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
from ..models.serialization import named_parameters, params_from_jax
from ..ops.sampling import per_ray_uniform
from ..utils.optim import ClippedAdam, exponential_lr
from .raycaster import _GraphChunk, _StepTimer

__all__ = ["distill", "distill_loss", "draw_rays"]

# the salts of the step's camera and pixel draws (the samplers' jitter
# uses 0-2)
_CAMERA_SALT, _PIXEL_SALT = 3, 4


def _uniform_ints(seed, step, count: int, high: int, salt: int,
                  device) -> torch.Tensor:
    """(count,) int64 draws in [0, high): each a 24-bit uniform of
    ``per_ray_uniform`` scaled in integers, so none reaches ``high``."""
    slots = torch.arange(count, device=device)
    bits = (per_ray_uniform(seed, step, slots, 1, salt=salt)[:, 0]
            * float(1 << 24)).to(torch.int64)
    return (bits * high) >> 24


def draw_rays(seed, step, num_cameras: int, rays_per_camera: int,
              batch_rays: int, device):
    """The rays of one distillation step: a camera (a 0-d int64 tensor)
    and ``batch_rays`` pixel offsets of it, uniform and drawn on the
    device from (seed, step), either of which may be a 0-d int64 device
    tensor (a CUDA graph's counters)."""
    camera = _uniform_ints(seed, step, 1, num_cameras, _CAMERA_SALT,
                           device)[0]
    offsets = _uniform_ints(seed, step, batch_rays, rays_per_camera,
                            _PIXEL_SALT, device)
    return camera, offsets


def distill_loss(t_logits: torch.Tensor, s_logits: torch.Tensor,
                 t_values: torch.Tensor, valid: torch.Tensor,
                 rgb_floor: float) -> torch.Tensor:
    """The distillation loss of (R * S, 4) teacher and student logits at
    (R, S) sample depths of R rays, ``valid`` (R,) marking the rays that
    hit the volume."""
    num_samples = t_values.shape[-1]
    deltas = torch.diff(t_values, dim=-1)
    deltas = torch.cat([deltas, deltas[..., -1:]], -1).reshape(-1)
    rgb_t = torch.sigmoid(t_logits[:, :3])
    rgb_s = torch.sigmoid(s_logits[:, :3])
    alpha_t = 1.0 - torch.exp(-F.softplus(t_logits[:, 3]) * deltas)
    alpha_s = 1.0 - torch.exp(-F.softplus(s_logits[:, 3]) * deltas)
    mask = valid.float()[:, None].expand(-1, num_samples).reshape(-1)
    w_rgb = mask * (alpha_t.detach() + rgb_floor)
    l_rgb = (torch.sum(w_rgb * torch.sum(torch.square(rgb_s - rgb_t), -1))
             / (3.0 * torch.sum(w_rgb) + 1e-9))
    l_alpha = (torch.sum(mask * torch.square(alpha_s - alpha_t))
               / (torch.sum(mask) + 1e-9))
    return l_rgb + l_alpha


def _teacher_fn(teacher, fused: bool, compute_dtype):
    """(positions, views) -> (N, 4) logits of the frozen teacher: K1 for
    a NeRF when ``fused``, else the plain query of any model type."""
    if fused and teacher.model_type == "nerf":
        weights = prepare_fused_nerf(teacher, torch.bfloat16)
        return lambda pos, views: fused_nerf_apply(weights, pos, views)

    def plain(pos, views):
        with torch.no_grad():
            return query_model(teacher, pos, views, compute_dtype)
    return plain


def _student_fn(student, fused: bool, compute_dtype):
    """(positions, views) -> (N, 4) differentiable student logits."""
    if fused:
        # a pack of the live parameters each step, so autograd carries
        # K2's packed gradients back to them
        return lambda pos, views: fused_nerf_train_apply(
            pack_fused_nerf(student, torch.bfloat16), pos, views)
    return lambda pos, views: student(pos, views,
                                      compute_dtype=compute_dtype)


def _resume(checkpoint_dir: str, student, optimizer: ClippedAdam,
            seed: int) -> int:
    """Restores the newest checkpoint into ``student`` and
    ``optimizer`` in place; returns its completed-step count (0 without
    one). Raises ``ValueError`` when its model or seed is not this
    run's."""
    from ..utils.checkpoint import latest_checkpoint, load_train_state
    path = latest_checkpoint(checkpoint_dir)
    if not path:
        return 0
    state = load_train_state(path)
    if (state.model.model_type != student.model_type
            or state.model.params_manifest != student.params_manifest):
        raise ValueError(
            f"{path} holds a {state.model.model_type} "
            f"{state.model.params_manifest}, not the student "
            f"{student.model_type} {student.params_manifest}")
    if state.seed != seed:
        raise ValueError(f"{path} was distilled with seed {state.seed}, "
                         f"not {seed}: its steps' draws would not repeat")
    params_from_jax(student, state.params)
    optimizer.load_jax_state(named_parameters(student), *state.opt_state)
    print(f"Resumed distillation from {path} at step {state.step}")
    return state.step


def distill(teacher, student, sampler, num_steps: int,
            batch_rays: int = 1024, learning_rate: float = 5e-4,
            decay_rate: float = 1.0, decay_steps: int = 0,
            weight_decay: float = 0.0, seed: int = 20080524,
            steps_per_call: int = 100, rgb_floor: float = 0.01,
            fused_teacher: Optional[bool] = None,
            fused_student: Optional[bool] = None,
            compute_dtype: Optional[torch.dtype] = None,
            report_interval: int = 1000,
            reporter: Optional[Callable[[int, float], None]] = None,
            checkpoint_dir: Optional[str] = None,
            checkpoint_interval: Optional[int] = None,
            resume: bool = False,
            call_ms: Optional[List] = None):
    """Trains ``student`` (in place) to match ``teacher``'s field.

    Args:
        teacher: the trained field to bake (frozen; any model type), on
            the sampler's device.
        student: the NeRF to train, initialized by the caller (the CLI
            seeds it with ``seed``), on the same device.
        sampler: the ray source, any sampler with
            ``sample_camera_rays`` (a stratified ``RaySampler`` for
            uniform placement, ``OccupancyGridSampler.from_model(teacher,
            ...)`` to follow the teacher's density).
        num_steps: the total steps of the run.
        batch_rays: rays a step (the sampler gives the samples a ray).
        learning_rate / decay_rate / decay_steps: the step's learning
            rate, ``lr * decay_rate ** (step / decay_steps)``; decay
            needs ``decay_steps`` > 0 (else ``ValueError``).
        weight_decay: Adam's L2 weight decay.
        seed: keys every step's draws.
        steps_per_call: steps a call, the last call clamped to the
            steps that remain; on CUDA each call is one CUDA-graph
            replay.
        rgb_floor: the alpha-weight floor of the color term.
        fused_teacher / fused_student: the kernels (K1 for a NeRF
            teacher, K1 + K2 for the student); None: for a NeRF on CUDA.
            A teacher of another type is queried plain either way. On
            the CPU they run the kernels' plain twins.
        compute_dtype: the plain models' matmul dtype (None: f32).
        reporter: ``f(step, loss)``, called after a call whose last step
            count is a multiple of ``report_interval``, and at the end.
        checkpoint_dir / checkpoint_interval: a resumable train-state
            checkpoint (written in the background) after each call
            that crosses a multiple of the interval, and at the end; its
            ``step`` is the count of steps done.
        resume: restore the newest checkpoint in ``checkpoint_dir``
            first; its model and seed must be this run's.
        call_ms: when given, gets one (milliseconds, steps) pair a call
            (CUDA events on a GPU, the host clock elsewhere).

    Returns:
        (student, losses): the trained student and the (n,) f32 losses
        of the steps this call ran (none after a resume of a finished
        run).
    """
    if decay_rate != 1.0 and decay_steps <= 0:
        raise ValueError(
            f"decay_rate={decay_rate} has no effect with decay_steps=0: "
            "the schedule is lr * decay_rate ** (step / decay_steps); "
            "pass decay_steps > 0 (e.g. num_steps) to enable decay")
    device = next(student.parameters()).device
    on_cuda = device.type == "cuda"
    if fused_teacher is None:
        fused_teacher = teacher.model_type == "nerf" and on_cuda
    if fused_student is None:
        fused_student = student.model_type == "nerf" and on_cuda
    teacher_fn = _teacher_fn(teacher, fused_teacher, compute_dtype)
    student_fn = _student_fn(student, fused_student, compute_dtype)
    chunk = max(1, min(steps_per_call, num_steps))
    optimizer = ClippedAdam(student.parameters(), learning_rate,
                            weight_decay, clip_value=None, clip_norm=None,
                            capturable=on_cuda and chunk > 1)

    def one_step(step):
        """One optimizer step at ``step`` (an int, or a 0-d int64
        device tensor); returns its loss."""
        camera, offsets = draw_rays(seed, step, sampler.num_cameras,
                                    sampler.rays_per_camera, batch_rays,
                                    device)
        rays, valid = sampler.sample_camera_rays(camera, offsets, step,
                                                 seed)
        positions = rays.positions.reshape(-1, 3)
        views = rays.view_directions.reshape(-1, 3)
        loss = distill_loss(teacher_fn(positions, views),
                            student_fn(positions, views), rays.t_values,
                            valid, rgb_floor)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step(exponential_lr(learning_rate, step, decay_rate,
                                      decay_steps)
                       if decay_steps else learning_rate)
        return loss.detach()

    graphs = {}

    def run_chunk(step: int, steps: int) -> torch.Tensor:
        """Steps ``step`` .. ``step + steps - 1``; their (steps,) losses."""
        if not optimizer.capturable:
            return torch.stack([one_step(step + k) for k in range(steps)])
        if steps not in graphs:
            graphs[steps] = _GraphChunk(
                lambda inputs: torch.stack(
                    [one_step(inputs["step"] + k) for k in range(steps)]),
                optimizer, ("step",))
        return graphs[steps](step).clone()

    start_step = 0
    if resume and checkpoint_dir:
        start_step = _resume(checkpoint_dir, student, optimizer, seed)
    checkpointer = None
    if checkpoint_dir and checkpoint_interval:
        from ..utils.checkpoint import AsyncCheckpointer
        checkpointer = AsyncCheckpointer(checkpoint_dir)

    timer = _StepTimer(device)
    losses, steps_run = [], []
    step = start_step
    try:
        while step < num_steps:
            steps = min(chunk, num_steps - step)
            timer.start()
            losses.append(run_chunk(step, steps))
            timer.stop()
            steps_run.append(steps)
            prev, step = step, step + steps
            if checkpointer is not None and (
                    step // checkpoint_interval > prev // checkpoint_interval
                    or step >= num_steps):
                checkpointer.save(student, optimizer, step, seed)
            if reporter is not None and (step % report_interval == 0
                                         or step >= num_steps):
                reporter(step, float(losses[-1][-1]))
    finally:
        if checkpointer is not None:
            checkpointer.close()
    if call_ms is not None:
        call_ms.extend(zip(timer.milliseconds(), steps_run))
    if not losses:
        return student, np.zeros(0, np.float32)
    return student, torch.cat(losses).float().cpu().numpy()

