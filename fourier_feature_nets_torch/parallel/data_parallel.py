"""The explicit data-parallel train step.

Port of ``fourier_feature_nets_tpu/parallel/data_parallel.py``, keeping
its name: JAX's ``jax.shard_map`` step with a hand-placed ``pmean``
becomes the raycaster's train step under a :class:`~.mesh.Mesh` of
``torch.distributed`` ranks, with the same data discipline. Every rank
holds the same epoch permutation and takes rows ``[r * local, (r + 1) *
local)`` of each global batch; the stratified jitter is keyed by the
global ray id (``ops/sampling.py::per_ray_uniform``), so the samples do
not depend on the mesh; the loss and the gradients are summed by one
all-reduce and divided by the mesh size, then clipped, then Adam runs
on every rank (JAX's order: the mean first, then the clip). With
``fused=True`` each rank runs the fused kernels (K1 forward, K2
backward) on its shard.
"""

import copy

import torch

from ..utils.optim import ClippedAdam

__all__ = ["make_shard_map_train_step"]


def make_shard_map_train_step(caster, dataset, batch_size: int,
                              learning_rate: float, decay_rate: float,
                              decay_steps: int, weight_decay: float,
                              mesh, clip_value: float = 0.1,
                              clip_norm: float = 0.1,
                              fused: bool = False,
                              steps_per_call: int = 1):
    """Builds the data-parallel train step of ``caster``'s model.

    Returns:
        ``step(perm, offset, step_no, rng) -> loss``, which trains the
        model in place (the JAX step returns new params and optimizer
        state): ``perm`` is the epoch's ray-id permutation (the same on
        every rank), ``offset`` the first batch's start, ``rng`` the
        jitter key. With ``steps_per_call`` N > 1 one call runs N steps,
        inner step ``k`` at ``(offset + k * batch_size) % modulo``, and
        returns the last loss; on CUDA the N steps and their all-reduces
        are one CUDA graph. ``step.optimizer`` is the step's
        :class:`ClippedAdam`. ``step.refresh()`` makes the next call read
        the dataset's and sampler's tensors as they are then: an eager
        step reads them at every call, a graph chunk is captured again.

    Raises:
        ValueError: ``batch_size`` does not divide by the mesh size.
    """
    params = list(caster.model.parameters())
    capturable = params[0].is_cuda and steps_per_call > 1
    optimizer = ClippedAdam(params, learning_rate, weight_decay,
                            clip_value=clip_value, clip_norm=clip_norm,
                            capturable=capturable)
    # the step's own view of the caster, trained with the fused kernels
    # or without them as ``fused`` says; it shares the model
    step_caster = copy.copy(caster)
    step_caster.fused_train = bool(fused)
    inner = step_caster._make_train_step(dataset, batch_size,
                                         learning_rate, decay_rate,
                                         decay_steps, optimizer,
                                         steps_per_call, mesh)

    def step(perm: torch.Tensor, offset: int, step_no: int,
             rng: int) -> torch.Tensor:
        return inner(perm, offset, step_no, rng)

    def refresh():
        if hasattr(inner, "graph"):
            inner.graph = None

    step.optimizer = optimizer
    step.refresh = refresh
    return step
