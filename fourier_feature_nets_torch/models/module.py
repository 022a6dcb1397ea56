"""Dense layer with torch.nn.Linear's default init drawn from an
explicit generator, and the mixed-precision apply rule of
``fourier_feature_nets_tpu/models/module.py::linear_apply``."""

import math
from typing import Optional

import torch
from torch import nn

__all__ = ["Linear", "linear_apply"]


class Linear(nn.Linear):
    """``nn.Linear`` whose weight and bias are drawn from
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with ``generator``.

    The layer is created on the CPU (a CPU generator draws the values);
    move the owning module with ``.to(device)``. Weights keep torch's
    (out, in) layout; the JAX package stores (in, out).
    """

    def __init__(self, num_inputs: int, num_outputs: int,
                 generator: Optional[torch.Generator] = None):
        self._generator = generator
        super().__init__(num_inputs, num_outputs)

    def reset_parameters(self) -> None:
        bound = 1.0 / math.sqrt(self.in_features)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=self._generator)
            self.bias.uniform_(-bound, bound, generator=self._generator)


def linear_apply(layer: nn.Linear, inputs: torch.Tensor,
                 compute_dtype: Optional[torch.dtype] = None
                 ) -> torch.Tensor:
    """``x @ W + b`` with the JAX package's precision rule.

    With ``compute_dtype`` (e.g. bfloat16) inputs and weights are cast
    to it, the products accumulate in f32 (an f32 product of the cast
    values is exact per term) and the f32 bias is added to the f32 sum.
    Without it the matmul is plain f32; on a CUDA device that relies on
    ``torch.backends.cuda.matmul.allow_tf32`` being False, PyTorch's
    default.
    """
    weight = layer.weight
    if compute_dtype is not None:
        inputs = inputs.to(compute_dtype).float()
        weight = weight.to(compute_dtype).float()
    return inputs @ weight.T + layer.bias
