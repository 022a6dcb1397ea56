"""Host-side octree algorithms (NumPy).

A copy of ``fourier_feature_nets_tpu/octree/host.py``: vectorized
replacements for the reference's numba kernels used at build time, BFS
construction from a point cloud (octree.py:733-805) with whole-array
octant assignment, and arithmetic id->geometry decoding that replaces
the reference's BFS leaf reconstruction (_leaf_nodes, octree.py:566-581).
The port's trees come from the C++ library (:mod:`.build`); these are
the NumPy twins its tests hold that library to.
"""

from collections import deque
from typing import Optional, Tuple

import numpy as np

__all__ = ["build_from_samples_numpy", "decode_ids_numpy"]

X_POS, Y_POS, Z_POS = 0b100, 0b010, 0b001


def decode_ids_numpy(ids: np.ndarray, scale: float,
                     max_depth: int = 21) -> Tuple[np.ndarray, np.ndarray]:
    """Decodes linear-octree ids to (centers (N,3), depths (N,)).

    A node's id encodes its root path in base 8 (child c of node i has
    id 8i+1+c), so geometry follows arithmetically from the digits.
    """
    ids = np.asarray(ids, np.int64)
    num = len(ids)
    digits = np.zeros((max_depth, num), np.int8)
    depths = np.zeros(num, np.int32)
    cur = ids.copy()
    level = 0
    while (cur > 0).any():
        active = cur > 0
        digits[level, active] = ((cur[active] - 1) & 7).astype(np.int8)
        cur[active] = (cur[active] - 1) >> 3
        depths[active] += 1
        level += 1
        if level >= max_depth:
            break

    centers = np.zeros((num, 3), np.float64)
    # digits[k] is the k-th digit leaf-up; tree level j (root-down)
    # for an id of depth d is digits[d - 1 - j], with half-size
    # scale / 2^(j+1).
    for j in range(level):
        mask = depths > j
        if not mask.any():
            continue
        dig = digits[depths[mask] - 1 - j, np.nonzero(mask)[0]]
        offset = scale / (2.0 ** (j + 1))
        centers[mask, 0] += np.where(dig & X_POS, offset, -offset)
        centers[mask, 1] += np.where(dig & Y_POS, offset, -offset)
        centers[mask, 2] += np.where(dig & Z_POS, offset, -offset)

    return centers.astype(np.float32), depths


def build_from_samples_numpy(positions: np.ndarray, depth: int,
                             min_leaf_size: int,
                             data: Optional[np.ndarray], scale: float):
    """BFS octree construction (the NumPy twin of the C++ build).

    Args:
        positions: (N, 3) points already centered on the root.
        depth: maximum tree depth (leaves live at depth-1 at deepest).
        min_leaf_size: minimum points for a leaf/child to exist.
        data: optional (N, D) per-point data, averaged per leaf.
        scale: root half-extent.

    Returns:
        (node_ids sorted, leaf_ids sorted, leaf_data or None).
    """
    num_points = len(positions)
    data_dim = 0 if data is None else data.shape[1]

    queue = deque()
    queue.append((0, np.zeros(3, np.float64), float(scale), 0,
                  np.arange(num_points)))
    node_ids = []
    leaves = {}

    while queue:
        node_id, center, half, level, index = queue.popleft()

        def make_leaf():
            if data_dim:
                leaves[node_id] = data[index].mean(0)
            else:
                leaves[node_id] = None

        if level == depth - 1:
            if len(index) >= min_leaf_size:
                make_leaf()
        elif level < depth - 1:
            pts = positions[index]
            octant = ((pts[:, 0] >= center[0]).astype(np.int8) * X_POS
                      + (pts[:, 1] >= center[1]).astype(np.int8) * Y_POS
                      + (pts[:, 2] >= center[2]).astype(np.int8) * Z_POS)
            valid_child = False
            children = []
            for oct in range(8):
                child_index = index[octant == oct]
                if len(child_index) >= min_leaf_size:
                    s = half / 2
                    child_center = center + np.array([
                        s if oct & X_POS else -s,
                        s if oct & Y_POS else -s,
                        s if oct & Z_POS else -s])
                    children.append(((node_id << 3) + 1 + oct,
                                     child_center, s, level + 1,
                                     child_index))
                    valid_child = True
            if valid_child:
                node_ids.append(node_id)
                queue.extend(children)
            else:
                make_leaf()

    leaf_ids = np.array(sorted(leaves), np.int64)
    if data_dim:
        leaf_data = np.stack([leaves[i] for i in leaf_ids])
    else:
        leaf_data = None
    return np.array(sorted(node_ids), np.int64), leaf_ids, leaf_data
