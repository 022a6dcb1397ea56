"""The trainer's optimizer: torch's Adam with value then norm clipping.

The JAX package's ``utils/optim.py`` reproduces, as a pure pytree
update, exactly these torch semantics: each gradient element clipped
to [-clip_value, clip_value] (``clip_grad_value_``), then all gradients
scaled by ``clip_norm / (norm + 1e-6)`` when their global L2 norm
exceeds ``clip_norm`` (``clip_grad_norm_``), then ``torch.optim.Adam``
with L2 weight decay. Here they are the torch calls themselves.
"""

from typing import Iterable

import torch

__all__ = ["ClippedAdam", "exponential_lr"]


def exponential_lr(initial_learning_rate: float, step: int,
                   decay_rate: float, decay_steps: float) -> float:
    """Continuous exponential decay: ``lr0 * rate ** (step / steps)``."""
    return initial_learning_rate * decay_rate ** (step / decay_steps)


class ClippedAdam:
    """``torch.optim.Adam`` behind value and global-norm clipping."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 learning_rate: float, weight_decay: float = 0.0,
                 clip_value: float = 0.1, clip_norm: float = 0.1):
        self.params = [p for p in params if p.requires_grad]
        self.optimizer = torch.optim.Adam(self.params, lr=learning_rate,
                                          weight_decay=weight_decay)
        self.clip_value = clip_value
        self.clip_norm = clip_norm

    def step(self, learning_rate: float) -> None:
        """Clips the parameters' ``.grad`` and takes one Adam step at
        ``learning_rate`` (set on the group before the step)."""
        torch.nn.utils.clip_grad_value_(self.params, self.clip_value)
        torch.nn.utils.clip_grad_norm_(self.params, self.clip_norm)
        for group in self.optimizer.param_groups:
            group["lr"] = learning_rate
        self.optimizer.step()

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)
