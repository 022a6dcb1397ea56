"""The data-parallel mesh: one process per device over ``torch.distributed``.

Port of ``fourier_feature_nets_tpu/parallel/mesh.py``. Rays are
embarrassingly parallel, so training and rendering shard the ray-batch
axis over a 1-D mesh ("data"); the parameters are replicated and the
gradients are all-reduced. The JAX package is one controller over the
local chips; here each rank is a process (started by ``torchrun`` or
by a test's spawner) that owns one device, and the collectives are
NCCL on CUDA and gloo on the CPU: the backend follows the device and
never falls back from one to the other. A run started without a
launcher is a mesh of one rank without a process group, whose
collectives are the identity, as JAX's ``make_mesh()`` on one chip.

``data_sharding`` and ``replicated_sharding`` name JAX shardings and
have no counterpart: a tensor here lives on its rank's device.
"""

import datetime
import os
from typing import Iterable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

__all__ = ["DATA_AXIS", "Mesh", "initialize_distributed", "make_mesh",
           "put_replicated", "replicate", "shard_rays"]

DATA_AXIS = "data"

# every collective of a process group gives up after this long, so a
# rank that raised ends its peers' waits instead of hanging them
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=5)


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


class Mesh:
    """A 1-D data-parallel mesh seen from one rank: ``size`` ranks, this
    one ``rank``, its ``device`` and the process ``group`` (None for a
    mesh of one rank without a launcher)."""

    axis_names = (DATA_AXIS,)

    def __init__(self, group, size: int, rank: int, device: torch.device):
        self.group = group
        self.size = size
        self.rank = rank
        self.device = torch.device(device)

    def __repr__(self):
        backend = dist.get_backend(self.group) if self.group else "none"
        return (f"Mesh(size={self.size}, rank={self.rank}, "
                f"device={self.device}, backend={backend})")

    @property
    def is_primary(self) -> bool:
        """Whether this rank writes the run's files and logs."""
        return self.rank == 0

    @property
    def collective(self) -> bool:
        """Whether the mesh has a process group to reduce over."""
        return self.group is not None

    def shard(self, rows: int) -> slice:
        """This rank's contiguous slab of ``rows`` rows, which must
        divide by the mesh size."""
        if rows % self.size:
            raise ValueError(f"{rows} rows must divide evenly over the "
                             f"{self.size}-device mesh")
        local = rows // self.size
        return slice(self.rank * local, (self.rank + 1) * local)

    def all_reduce_mean_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Replaces each tensor, in place, by its mean over the ranks: one
        all-reduce of their flattened concatenation, summed and divided
        by the size (gloo has no average)."""
        if not self.collective:
            return
        tensors = list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        flat.div_(self.size)
        start = 0
        for tensor in tensors:
            count = tensor.numel()
            tensor.copy_(flat[start:start + count].view_as(tensor))
            start += count

    def all_gather_rows(self, tensor: torch.Tensor) -> torch.Tensor:
        """The ranks' ``tensor`` (the same shape on each) stacked along
        rows in rank order."""
        if not self.collective:
            return tensor
        tensor = tensor.contiguous()
        out = torch.empty((self.size * tensor.shape[0],) + tensor.shape[1:],
                          dtype=tensor.dtype, device=tensor.device)
        dist.all_gather_into_tensor(out, tensor, group=self.group)
        return out

    def map_rows(self, fn, rows: torch.Tensor):
        """``fn(rows)`` with the rows split over the ranks: each rank runs
        ``fn`` on its slab of ``rows`` (padded with its last row to a
        multiple of the size) and the slabs' outputs (a tensor or a
        tuple of tensors, one row each) are gathered and cropped, so
        every rank gets the whole result."""
        if not self.collective:
            return fn(rows)
        count = rows.shape[0]
        pad = -count % self.size
        if pad:
            rows = torch.cat([rows, rows[-1:].expand(pad)])
        out = fn(rows[self.shard(rows.shape[0])])
        if isinstance(out, tuple):
            return tuple(self.all_gather_rows(t)[:count] for t in out)
        return self.all_gather_rows(out)[:count]

    def broadcast_(self, tensors: Iterable[torch.Tensor]) -> None:
        """Rank 0's values of each tensor, in place on every rank."""
        if not self.collective:
            return
        for tensor in tensors:
            data = tensor.data
            # a transposed parameter is broadcast through a contiguous copy
            buffer = data if data.is_contiguous() else data.contiguous()
            dist.broadcast(buffer, src=0, group=self.group)
            if buffer is not data:
                data.copy_(buffer)

    def broadcast_object(self, value=None):
        """Rank 0's ``value`` (any picklable object) on every rank."""
        if not self.collective:
            return value
        box = [value]
        dist.broadcast_object_list(box, src=0, group=self.group,
                                   device=(self.device
                                           if self.device.type == "cuda"
                                           else None))
        return box[0]

    def barrier(self) -> None:
        if self.collective:
            dist.barrier(group=self.group)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: Union[str, torch.device] = "cuda",
                           timeout: datetime.timedelta = COLLECTIVE_TIMEOUT
                           ) -> bool:
    """Joins this process to the ranks of a run:
    ``dist.init_process_group`` over NCCL for a CUDA ``device`` and
    gloo for the CPU, with every collective timing out after
    ``timeout``.

    Args:
        coordinator_address: ``host:port`` of rank 0's store. Defaults
            to ``$MASTER_ADDR:$MASTER_PORT`` (what ``torchrun`` sets);
            with neither this is a no-op returning False, as the JAX
            function's single-process run.
        num_processes / process_id: the world size and this rank;
            default ``$WORLD_SIZE`` / ``$RANK``.
        device: the device kind of the run. On CUDA this rank takes card
            ``$LOCAL_RANK`` (default: its rank modulo the card count).

    Returns:
        True when the process group is up (also when it already was).
    """
    if dist.is_initialized():
        return True
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    device = torch.device(device)
    options = {}
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        options["device_id"] = torch.device("cuda", local)
    dist.init_process_group(_backend(device),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=timeout, **options)
    return True


def make_mesh(device: Union[str, torch.device, None] = None) -> Mesh:
    """The mesh of this run's ranks (:func:`initialize_distributed`), or
    a mesh of one rank without a process group. ``device`` defaults to
    this rank's card under NCCL, the CPU under gloo, and CUDA without a
    group; a device of the other kind than the group's backend
    raises."""
    if not dist.is_initialized():
        return Mesh(None, 1, 0, torch.device("cuda" if device is None
                                             else device))
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if _backend(device) != backend:
        raise ValueError(f"a {device.type} mesh needs the "
                         f"{_backend(device)} backend; the process group "
                         f"runs {backend}")
    return Mesh(dist.group.WORLD, dist.get_world_size(), dist.get_rank(),
                device)


def replicate(tree, mesh: Mesh):
    """Rank 0's values of a module's parameters and buffers, or of a
    tensor or a list of tensors, in place on every rank; returns
    ``tree``."""
    if isinstance(tree, torch.nn.Module):
        tensors: List[torch.Tensor] = [*tree.parameters(), *tree.buffers()]
    elif isinstance(tree, torch.Tensor):
        tensors = [tree]
    else:
        tensors = list(tree)
    with torch.no_grad():
        mesh.broadcast_(tensors)
    return tree


put_replicated = replicate


def shard_rays(array: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous slab of ``array``'s leading (ray) axis,
    which must divide by the mesh size."""
    return array[mesh.shard(array.shape[0])]
