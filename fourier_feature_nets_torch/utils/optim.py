"""The trainer's optimizer: torch's Adam with value then norm clipping.

The JAX package's ``utils/optim.py`` reproduces, as a pure pytree
update, exactly these torch semantics: each gradient element clipped
to [-clip_value, clip_value] (``clip_grad_value_``), then all gradients
scaled by ``clip_norm / (norm + 1e-6)`` when their global L2 norm
exceeds ``clip_norm`` (``clip_grad_norm_``), then ``torch.optim.Adam``
with L2 weight decay.

CPU parameters take the torch calls themselves. CUDA parameters take
K5 (:mod:`..kernels.clipped_adam`): the optimizer is then a
``torch.optim.Adam`` whose ``step`` clips and updates in two kernel
launches, in the float order of torch's capturable Adam, and leaves in
each ``.grad`` the gradient clipped as torch's calls leave it. torch
wraps that ``step`` as any optimizer's, so its step hooks fire; its
state keeps torch's keys, with every step count on the device.

A capturable :class:`ClippedAdam` (its learning rate in a device
tensor, ``Adam(capturable=True)``'s) can be captured in a CUDA graph:
nothing in its step reads the host. Its state maps both ways to the JAX
package's ``AdamState`` (one ``step``, ``mu`` and ``nu`` named and laid
out as :func:`~..models.serialization.params_to_jax` lays out the
weights), so a train-state checkpoint resumes in either package.
"""

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..kernels.clipped_adam import clipped_adam
from .layout import from_jax_layout, to_jax_layout

__all__ = ["ClippedAdam", "exponential_lr"]


def exponential_lr(initial_learning_rate: float, step, decay_rate: float,
                   decay_steps: float):
    """Continuous exponential decay: ``lr0 * rate ** (step / steps)``.

    ``step`` is an int (a float comes back), or a device tensor: then
    the rate is computed on the device in f64, the float form's
    precision, and comes back as a 0-d f32 tensor, with no host read (a
    CUDA graph's learning rate)."""
    if not isinstance(step, torch.Tensor):
        return initial_learning_rate * decay_rate ** (step / decay_steps)
    exponent = step.to(torch.float64) / decay_steps
    rate = torch.full_like(exponent, decay_rate)
    return (initial_learning_rate * torch.pow(rate, exponent)).to(
        torch.float32)


def _zero_state(state: dict, p: torch.Tensor) -> None:
    """A parameter's Adam state before its first step: a step count of 0
    (f32, on the parameter's device) and zero moments."""
    state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
    state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
    state["exp_avg_sq"] = torch.zeros_like(
        p, memory_format=torch.preserve_format)


class _KernelAdam(torch.optim.Adam):
    """``torch.optim.Adam`` of CUDA parameters whose step is K5: the value
    and norm clips, then Adam, in two launches; the learning rate is the
    group's (a float, or a device tensor when capturable)."""

    def __init__(self, params, lr, weight_decay: float, capturable: bool,
                 clip_value: Optional[float], clip_norm: Optional[float]):
        super().__init__(params, lr=lr, weight_decay=weight_decay,
                         capturable=capturable)
        self.clip_value = clip_value
        self.clip_norm = clip_norm

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("clipped Adam takes no closure")
        for group in self.param_groups:
            if group["amsgrad"] or group["maximize"]:
                raise ValueError("clipped Adam has no amsgrad or maximize")
            params = [p for p in group["params"] if p.grad is not None]
            for p in params:
                if not self.state[p]:
                    _zero_state(self.state[p], p)
            states = [self.state[p] for p in params]
            beta1, beta2 = group["betas"]
            clipped_adam(params, [p.grad for p in params],
                         [s["exp_avg"] for s in states],
                         [s["exp_avg_sq"] for s in states],
                         [s["step"] for s in states], lr=group["lr"],
                         beta1=beta1, beta2=beta2, eps=group["eps"],
                         weight_decay=group["weight_decay"],
                         clip_value=self.clip_value, clip_norm=self.clip_norm)
        return None


class ClippedAdam:
    """``torch.optim.Adam`` behind value and global-norm clipping: torch's
    calls on the CPU, K5 on CUDA."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 learning_rate: float, weight_decay: float = 0.0,
                 clip_value: float = 0.1, clip_norm: float = 0.1,
                 capturable: bool = False):
        """Constructor.

        Args:
            params: the parameters to train, f32 (on CUDA, contiguous).
            learning_rate: the initial learning rate.
            weight_decay: Adam's L2 weight decay.
            clip_value / clip_norm: the gradient clips (None: no clip,
                as distillation's plain Adam).
            capturable: keep the learning rate in a 0-d f32 tensor on
                the parameters' device (a CUDA device), so that
                :meth:`step` can be captured in a CUDA graph.
        """
        self.params = [p for p in params if p.requires_grad]
        self.capturable = capturable
        self.kernel = self.params[0].device.type == "cuda"
        lr = learning_rate
        if capturable:
            self.lr = lr = torch.tensor(float(learning_rate),
                                        dtype=torch.float32,
                                        device=self.params[0].device)
        if self.kernel:
            self.optimizer = _KernelAdam(self.params, lr, weight_decay,
                                         capturable, clip_value, clip_norm)
        else:
            self.optimizer = torch.optim.Adam(self.params, lr=lr,
                                              weight_decay=weight_decay,
                                              capturable=capturable)
        self.clip_value = clip_value
        self.clip_norm = clip_norm

    def step(self, learning_rate) -> None:
        """Clips the parameters' ``.grad`` and takes one Adam step at
        ``learning_rate``: a float, or for a capturable optimizer also a
        device tensor, which is copied into its learning-rate tensor on
        the device. On CUDA the optimizer's step clips (K5)."""
        if not self.kernel:
            if self.clip_value is not None:
                torch.nn.utils.clip_grad_value_(self.params, self.clip_value)
            if self.clip_norm is not None:
                torch.nn.utils.clip_grad_norm_(self.params, self.clip_norm)
        if isinstance(learning_rate, torch.Tensor):
            self.lr.copy_(learning_rate)
        elif self.capturable:
            self.lr.fill_(learning_rate)
        else:
            for group in self.optimizer.param_groups:
                group["lr"] = learning_rate
        self.optimizer.step()

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def init_state(self) -> None:
        """Creates every parameter's zero Adam state now, as the first
        step would (a step count of 0, zero moments), so that it can be
        read, copied into, or captured before any step."""
        for p in self.params:
            state = self.optimizer.state[p]
            if not state:
                _zero_state(state, p)

    def state_tensors(self):
        """Every tensor of the optimizer's state (steps and moments), in
        a fixed order (after :meth:`init_state`)."""
        self.init_state()
        return [self.optimizer.state[p][key] for p in self.params
                for key in ("step", "exp_avg", "exp_avg_sq")]

    def jax_state(self, named: Dict[str, torch.Tensor]
                  ) -> Tuple[int, Dict[str, np.ndarray],
                             Dict[str, np.ndarray]]:
        """The state as the JAX package's ``AdamState``: (step, mu, nu),
        ``mu`` and ``nu`` flat ``{path: array}`` dicts keyed as
        ``named`` (path -> parameter, e.g.
        :func:`~..models.serialization.named_parameters`), each moment
        in its path's JAX layout (:func:`~.layout.to_jax_layout`). torch
        keeps a step per parameter; they are all equal under this
        optimizer."""
        self.init_state()
        mu, nu, steps = {}, {}, set()
        for path, p in named.items():
            state = self.optimizer.state[p]
            steps.add(int(state["step"]))
            for out, key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
                value = state[key].detach().cpu().numpy()
                out[path] = to_jax_layout(path, value).copy()
        if len(steps) != 1:
            raise ValueError(f"parameters at different Adam steps {steps}")
        return steps.pop(), mu, nu

    def load_jax_state(self, named: Dict[str, torch.Tensor], step: int,
                       mu: Dict[str, np.ndarray],
                       nu: Dict[str, np.ndarray]) -> None:
        """Copies a JAX ``AdamState`` (see :meth:`jax_state`) into the
        optimizer's state in place: the tensors keep their storage, so
        a graph captured afterwards reads them."""
        self.init_state()
        with torch.no_grad():
            for path, p in named.items():
                state = self.optimizer.state[p]
                state["step"].fill_(float(step))
                for source, key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
                    value = torch.tensor(from_jax_layout(
                        path, np.asarray(source[path], np.float32)))
                    if tuple(value.shape) != tuple(p.shape):
                        raise ValueError(
                            f"{key} of {path}: shape {tuple(value.shape)} "
                            f"does not match {tuple(p.shape)}")
                    state[key].copy_(value)
