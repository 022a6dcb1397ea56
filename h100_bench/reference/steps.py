"""Training and distillation steps in plain float32, followed from the
same seed and inputs as the program's first steps.

Training (the project's ``train_nerf`` step): an epoch's ray order is a
``torch.randperm`` of the valid rays from a CPU generator seeded with
the run's seed, and its jitter key the generator's next
``randint(0, 2**31)``. Step k takes the k-th run of ``batch`` rays, with
near/far shrunk toward their midpoint by ``clamp(k / anneal_steps,
anneal_start, 1)`` until ``anneal_steps``, and 128 stratified samples
jittered by the keyed generator (salt 0). The loss is the color MSE
against the image (black where its alpha is 0) plus 0.1 x the alpha
MSE. Each gradient is clipped to [-0.1, 0.1], then the whole to norm
0.1, then torch's Adam steps at ``lr * decay_rate ** (k / decay_steps)``.

Distillation: step k draws a camera and ``batch`` pixels from the keyed
generator (salts 3 and 4, key = the seed), samples them through the
teacher's occupancy grid with jittered quantiles (salt 2) and matches
the student's per-sample color (weighted by the teacher's alpha plus
``rgb_floor``) and alpha to the teacher's on rays that meet the box,
with Adam (no clipping) at a fixed rate.

An epoch of training runs whole calls of ``steps_per_call`` steps: call
j of an epoch starts at row ``j * steps_per_call * batch`` of its order,
and inner step k takes the ``batch`` rows from ``(offset + k * batch)
% (rows - batch + 1)``; the next epoch draws a new order and key from
the same generator.

Each follower starts at step 0 from the model's weights and a fresh
Adam, or at step ``start["step"]`` from Adam's moments in ``start``
(the model holding the weights of that step), and returns the loss of
every step, the gradient of the first step as the optimizer received
it, and the parameters after the last. ``half_batch`` plants a fault:
each step's loss is taken over the first half of its rays only.
"""

import torch
import torch.nn.functional as F

from .geometry import box_near_far, composite, pixel_rays, uniform_keyed

__all__ = ["follow_training", "follow_distillation"]


def _adam(params, lr: float, start) -> torch.optim.Adam:
    """torch's Adam over ``params``, at ``start``'s step and moments when
    given."""
    optimizer = torch.optim.Adam(params, lr=lr)
    if start is not None:
        for p, m, v in zip(params, start["exp_avg"], start["exp_avg_sq"]):
            optimizer.state[p] = {"step": torch.tensor(float(start["step"])),
                                  "exp_avg": m.detach().clone(),
                                  "exp_avg_sq": v.detach().clone()}
    return optimizer


def _record(params, losses, first_grads, loss):
    losses.append(float(loss.detach()))
    if not first_grads:
        first_grads.extend(p.grad.detach().clone() for p in params)


def follow_training(model, data: dict, mix: dict, seed: int, steps: int,
                    quant=None, half_batch: bool = False,
                    start: dict = None) -> dict:
    """Follows the first ``steps`` training steps of ``model`` (updated
    in place) of the call that starts at step 0, or at ``start["step"]``.

    ``data`` holds the rig's rays (``starts``, ``dirs`` on the device),
    ``colors`` (R, 3) and ``alphas`` (R,) in [0, 1], and the box
    ``lo``/``hi``."""
    device = data["starts"].device
    near_all, far_all, valid = box_near_far(data["starts"], data["dirs"],
                                            data["lo"], data["hi"])
    pool = torch.nonzero(valid.cpu()).reshape(-1)
    batch, samples = mix["batch_size"], mix["num_samples"]
    chunk = mix["steps_per_call"]
    first = start["step"] if start is not None else 0
    calls_per_epoch = len(range(0, max(len(pool) // batch, chunk), chunk))
    call = first // chunk
    generator = torch.Generator().manual_seed(seed)
    for _ in range(call // calls_per_epoch + 1):
        order = torch.randperm(len(pool), generator=generator)
        key = int(torch.randint(0, 2 ** 31, (1,), generator=generator))
    perm = pool[order].to(device)
    offset = (call % calls_per_epoch) * chunk * batch
    modulo = max(len(perm) - batch + 1, 1)
    params = list(model.parameters())
    optimizer = _adam(params, mix["learning_rate"], start)
    losses, first_grads = [], []
    for step in range(first, first + steps):
        row = (offset + (step - call * chunk) * batch) % modulo
        idx = perm[row:row + batch]
        near, far = near_all[idx], far_all[idx]
        if step < mix["num_anneal_steps"]:
            shrink = min(max(step / mix["num_anneal_steps"],
                             mix["anneal_start"]), 1.0)
            middle = (near + far) * 0.5
            near = middle + (near - middle) * shrink
            far = middle + (far - middle) * shrink
        jitter = uniform_keyed(key, step, idx, samples, salt=0)
        edges = torch.arange(samples, device=device) / (samples - 1)
        t = (near[:, None] + edges * (far - near)[:, None]
             + jitter * ((far - near) / samples)[:, None])
        starts, dirs = data["starts"][idx], data["dirs"][idx]
        points = starts[:, None, :] + t[..., None] * dirs[:, None, :]
        views = dirs[:, None, :].expand(points.shape)
        logits = model(points.reshape(-1, 3), views.reshape(-1, 3),
                       quant=quant).reshape(idx.shape[0], samples, 4)
        color, alpha = composite(logits, t)
        target_alpha = data["alphas"][idx]
        target = torch.where(target_alpha[:, None] > 0, data["colors"][idx],
                             0.0)
        rows = slice(0, batch // 2 if half_batch else batch)
        loss = (torch.mean(torch.square(target[rows] - color[rows]))
                + mix["alpha_weight"] * torch.mean(
                    torch.square(target_alpha[rows] - alpha[rows])))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        torch.nn.utils.clip_grad_value_(params, mix["clip_value"])
        torch.nn.utils.clip_grad_norm_(params, mix["clip_norm"])
        _record(params, losses, first_grads, loss)
        for group in optimizer.param_groups:
            group["lr"] = mix["learning_rate"] * mix["decay_rate"] ** (
                step / mix["decay_steps"])
        optimizer.step()
    return {"losses": losses, "first_grads": first_grads,
            "params": [p.detach().clone() for p in params]}


def _uniform_ints(key: int, step: int, count: int, high: int, salt: int,
                  device) -> torch.Tensor:
    slots = torch.arange(count, device=device)
    bits = (uniform_keyed(key, step, slots, 1, salt)[:, 0]
            * float(1 << 24)).to(torch.int64)
    return (bits * high) >> 24


def follow_distillation(teacher, student, rig: dict, occupancy, mix: dict,
                        seed: int, steps: int, quant=None,
                        half_batch: bool = False, start: dict = None) -> dict:
    """Follows ``steps`` distillation steps of ``student`` (updated in
    place) against ``teacher``. ``rig`` holds ``ray_m`` (C, 3, 3),
    ``positions`` (C, 3), ``width``, ``height`` and the box
    ``lo``/``hi``."""
    device = rig["ray_m"].device
    batch, samples = mix["batch_rays"], mix["num_samples"]
    pixels = rig["width"] * rig["height"]
    params = list(student.parameters())
    optimizer = _adam(params, mix["learning_rate"], start)
    first = start["step"] if start is not None else 0
    losses, first_grads = [], []
    for step in range(first, first + steps):
        camera = int(_uniform_ints(seed, step, 1, rig["ray_m"].shape[0], 3,
                                   device)[0])
        offsets = _uniform_ints(seed, step, batch, pixels, 4, device)
        starts, dirs = pixel_rays(rig["ray_m"][camera],
                                  rig["positions"][camera], rig["width"],
                                  offsets)
        near, far, valid = box_near_far(starts, dirs, rig["lo"], rig["hi"])
        jitter = uniform_keyed(seed, step, camera * pixels + offsets,
                               samples, salt=2)
        t = occupancy.t_values(starts, dirs, near, far, samples, jitter)
        points = (starts[:, None, :] + t[..., None] * dirs[:, None, :])
        points = points.reshape(-1, 3)
        views = dirs[:, None, :].expand(-1, samples, -1).reshape(-1, 3)
        with torch.no_grad():
            t_logits = teacher(points, views, quant=quant)
        s_logits = student(points, views, quant=quant)
        deltas = torch.diff(t, dim=-1)
        deltas = torch.cat([deltas, deltas[:, -1:]], -1).reshape(-1)
        alpha_t = 1.0 - torch.exp(-F.softplus(t_logits[:, 3]) * deltas)
        alpha_s = 1.0 - torch.exp(-F.softplus(s_logits[:, 3]) * deltas)
        keep = valid.clone()
        if half_batch:
            keep[batch // 2:] = False
        mask = keep.float()[:, None].expand(-1, samples).reshape(-1)
        w_rgb = mask * (alpha_t + mix["rgb_floor"])
        rgb_error = torch.sum(torch.square(torch.sigmoid(s_logits[:, :3])
                                           - torch.sigmoid(t_logits[:, :3])),
                              -1)
        loss = (torch.sum(w_rgb * rgb_error) / (3.0 * torch.sum(w_rgb) + 1e-9)
                + torch.sum(mask * torch.square(alpha_s - alpha_t))
                / (torch.sum(mask) + 1e-9))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        _record(params, losses, first_grads, loss)
        optimizer.step()
    return {"losses": losses, "first_grads": first_grads,
            "params": [p.detach().clone() for p in params]}
