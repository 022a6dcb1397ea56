"""Dense layer with torch.nn.Linear's default init drawn from an
explicit generator, the mixed-precision apply rule of
``fourier_feature_nets_tpu/models/module.py::linear_apply``, the ReLU
MLP body of ``mlp_init``/``mlp_apply`` built on them, and
:func:`query_model`, which calls a radiance field with or without view
directions."""

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

__all__ = ["Linear", "linear_apply", "logit", "mlp_apply", "mlp_layers",
           "query_model"]


def logit(x: float) -> float:
    """Inverse sigmoid (the voxel models' bias init)."""
    return float(np.log(x) - np.log1p(-x))


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


def mlp_layers(num_inputs: int, layer_channels: Sequence[int],
               num_outputs: int,
               generator: Optional[torch.Generator] = None) -> nn.ModuleList:
    """The layers of a ReLU MLP: one :class:`Linear` a hidden width and
    a linear head, drawn from ``generator`` in order."""
    widths = [num_inputs, *layer_channels, num_outputs]
    return nn.ModuleList([Linear(n_in, n_out, generator)
                          for n_in, n_out in zip(widths[:-1], widths[1:])])


def mlp_apply(layers: nn.ModuleList, inputs: torch.Tensor,
              compute_dtype: Optional[torch.dtype] = None,
              return_hidden: bool = False):
    """Applies a ReLU MLP (linear last layer) with :func:`linear_apply`'s
    precision rule; with ``return_hidden`` also returns the last hidden
    activations (the input of the head)."""
    hidden = inputs
    for layer in layers[:-1]:
        hidden = torch.relu(linear_apply(layer, hidden, compute_dtype))
    output = linear_apply(layers[-1], hidden, compute_dtype)
    if return_hidden:
        return output, hidden
    return output


def query_model(model, positions: torch.Tensor, views: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(N, 4) logits of a radiance field at (N, 3) positions: a model
    with ``use_view`` (the NeRF) also takes the (N, 3) view directions,
    any other is called on the positions alone."""
    if model.use_view:
        return model(positions, views, compute_dtype=compute_dtype)
    return model(positions, compute_dtype=compute_dtype)
