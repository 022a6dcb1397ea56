"""Data parallelism over ``torch.distributed``: the mesh of ranks and
the explicit data-parallel train step (port of
``fourier_feature_nets_tpu/parallel``)."""

from .data_parallel import make_shard_map_train_step
from .mesh import (
    DATA_AXIS,
    Mesh,
    initialize_distributed,
    make_mesh,
    put_replicated,
    replicate,
    shard_rays,
)

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "initialize_distributed",
    "make_mesh",
    "make_shard_map_train_step",
    "put_replicated",
    "replicate",
    "shard_rays",
]
