"""Octree point queries and ray marching in PyTorch.

The counterpart of ``fourier_feature_nets_tpu/octree/device.py``: the
*linear octree* (sorted id tensors, ``torch.searchsorted`` for the id
lookups) is walked by every point or ray in lockstep, for a fixed
number of steps, on whatever device the tensors live. Ids are int64, so
unlike the JAX module (int32 ids, depth <= 10) any depth the C++
library builds is walked.
"""

from typing import NamedTuple

import torch

__all__ = ["Path", "device_batch_intersect", "device_batch_query"]

X_POS, Y_POS, Z_POS = 0b100, 0b010, 0b001


class Path(NamedTuple):
    """Ray-marching output: per-step entry depths and leaf indices
    (-1 = empty space), the reference's Path contract (octree.py:23)."""

    t_stops: torch.Tensor
    leaves: torch.Tensor


def _sorted_member(arr: torch.Tensor, ids: torch.Tensor):
    """(found, index) of ``ids`` in the sorted 1-D tensor ``arr``."""
    if arr.shape[0] == 0:
        # a root-only tree has an empty node index: nothing to gather
        return (torch.zeros(ids.shape, dtype=torch.bool, device=ids.device),
                torch.zeros(ids.shape, dtype=torch.int64, device=ids.device))
    index = torch.searchsorted(arr, ids)
    found = arr[torch.clamp(index, max=arr.shape[0] - 1)] == ids
    return found, index


def _descend(node_index: torch.Tensor, leaf_index: torch.Tensor,
             scale: float, max_depth: int, points: torch.Tensor):
    """Descends all points from the root to their deepest cell.

    Returns (center (N, 3), half (N,), leaf (index or -1)).
    """
    num = points.shape[0]
    device = points.device
    center = torch.zeros((num, 3), dtype=torch.float32, device=device)
    half = torch.full((num,), scale, dtype=torch.float32, device=device)
    node_id = torch.zeros((num,), dtype=torch.int64, device=device)
    leaf = torch.full((num,), -1, dtype=torch.int64, device=device)
    done = torch.zeros((num,), dtype=torch.bool, device=device)
    bits = torch.tensor([X_POS, Y_POS, Z_POS], dtype=torch.int64,
                        device=device)
    for _ in range(max_depth):
        upper = points >= center                      # (N, 3) octant bits
        octant = (upper.to(torch.int64) * bits).sum(-1)
        child_id = (node_id << 3) + 1 + octant
        child_half = half * 0.5
        offsets = torch.where(upper, child_half[:, None], -child_half[:, None])
        child_center = center + offsets

        is_leaf, leaf_pos = _sorted_member(leaf_index, child_id)
        is_node, _ = _sorted_member(node_index, child_id)

        step = ~done
        center = torch.where(step[:, None], child_center, center)
        half = torch.where(step, child_half, half)
        node_id = torch.where(step, child_id, node_id)
        leaf = torch.where(step & is_leaf, leaf_pos, leaf)
        done = done | is_leaf | ~is_node
    return center, half, leaf


def device_batch_query(node_index: torch.Tensor, leaf_index: torch.Tensor,
                       points: torch.Tensor, *, scale: float,
                       max_depth: int) -> torch.Tensor:
    """(N, 3) points -> (N,) int64 leaf index, or -1 in empty space or
    outside the root cube (octree.py:513-541)."""
    _, _, leaf = _descend(node_index, leaf_index, scale, max_depth, points)
    inside = torch.amax(torch.abs(points), dim=-1) <= scale
    return torch.where(inside, leaf, -1)


def _cell_near_far(center, half, starts, inv_dirs):
    t0 = (center - half[:, None] - starts) * inv_dirs
    t1 = (center + half[:, None] - starts) * inv_dirs
    near = torch.minimum(t0, t1).amax(-1)
    far = torch.maximum(t0, t1).amin(-1)
    return near, far


def device_batch_intersect(node_index: torch.Tensor,
                           leaf_index: torch.Tensor, starts: torch.Tensor,
                           directions: torch.Tensor, *, scale: float,
                           max_depth: int, max_length: int) -> Path:
    """Marches rays cell to cell through the sparse tree.

    Per step: descend to the deepest cell containing the current point,
    record (t_entry, leaf or -1), jump past the cell's exit plane.
    Unvisited tail slots hold the root exit t and leaf -1
    (octree.py:418-501 contract).

    Returns:
        Path of (R, max_length) f32 t stops and int64 leaves.
    """
    directions = torch.where(directions == 0, 1e-8, directions)
    inv_dirs = 1.0 / directions
    num_rays = starts.shape[0]
    device = starts.device

    root_center = torch.zeros((num_rays, 3), dtype=torch.float32,
                              device=device)
    root_half = torch.full((num_rays,), scale, dtype=torch.float32,
                           device=device)
    root_t0, root_t1 = _cell_near_far(root_center, root_half, starts,
                                      inv_dirs)
    hit = root_t0 < root_t1

    t = root_t0 + 1e-5
    stop = torch.zeros((num_rays,), dtype=torch.int64, device=device)
    t_steps, leaf_steps, actives = [], [], []
    for _ in range(max_length):
        points = starts + t[:, None] * directions
        inside = (torch.amax(torch.abs(points), dim=-1) <= scale) & hit
        active = inside & (t < root_t1) & (stop < max_length - 1)

        center, half, leaf = _descend(node_index, leaf_index, scale,
                                      max_depth, points)
        _, cell_t1 = _cell_near_far(center, half, starts, inv_dirs)

        t_steps.append(t)
        leaf_steps.append(leaf)
        actives.append(active)
        # forward-progress guard: a fixed +1e-5 nudge underflows one f32
        # ulp once t >= ~256, stalling the march on the same cell; the
        # relative term keeps the nudge above an ulp at any depth
        base = torch.maximum(cell_t1, t)
        t = torch.where(active, base + torch.clamp(base * 1e-6, min=1e-5), t)
        stop = stop + active.to(torch.int64)

    # once a ray goes inactive it stays inactive (t stops advancing), so
    # the active steps form a prefix and step == output slot; inactive
    # slots take the tail values (root exit, leaf -1)
    actives = torch.stack(actives, -1)
    t_stops = torch.where(actives, torch.stack(t_steps, -1),
                          root_t1[:, None])
    leaves = torch.where(actives, torch.stack(leaf_steps, -1), -1)
    return Path(t_stops, leaves)
