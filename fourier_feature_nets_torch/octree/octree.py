"""Sparse octree with native and torch traversal.

The counterpart of ``fourier_feature_nets_tpu/octree/octree.py``, with
the same *linear octree* data model (children of node i occupy ids
8i+1..8i+8; sorted id arrays and binary search instead of pointers):

  * construction (BFS), ``query`` and ``intersect`` run in the C++
    library (``csrc/octree.cpp``, built by :mod:`.build`); there is no
    NumPy fallback;
  * ``query_device`` and ``intersect_device`` walk the tree in torch
    (:mod:`.traversal`) on the device of the tensors they are given;
  * leaf geometry is arithmetic id decoding.

Trees save to the JAX package's NPZ keys (``node_index``,
``leaf_index``, ``scale``, ``leaf_data``), so a tree saved by either
package loads in the other.
"""

import ctypes
import os
from typing import Dict, Optional, Union

import numpy as np
import torch

from .build import load_library
from .traversal import Path, device_batch_intersect, device_batch_query

__all__ = ["OcTree", "Path"]


def _ptr(array: np.ndarray, ctype):
    return array.ctypes.data_as(ctypes.POINTER(ctype))


class OcTree:
    """Sparse octree over the cube [-scale, scale]^3."""

    def __init__(self, scale: float, node_ids, leaf_ids,
                 leaf_data: Optional[np.ndarray] = None):
        """Constructor.

        Args:
            scale: root half side length.
            node_ids: interior node ids (iterable of int).
            leaf_ids: leaf ids (iterable of int).
            leaf_data: optional (num_leaves, D) per-leaf payload.
        """
        self._update(node_ids, leaf_ids, scale)
        self._leaf_data = leaf_data

    def _update(self, node_ids, leaf_ids, scale: float):
        self._scale = float(scale)
        leaf_set = set(int(i) for i in leaf_ids)
        node_set = set(int(i) for i in node_ids) - leaf_set
        self._node_index = np.array(sorted(node_set), np.int64)
        self._leaf_index = np.array(sorted(leaf_set), np.int64)
        self._leaf_centers, self._leaf_depths = self._decode(
            self._leaf_index)

    def _decode(self, ids: np.ndarray):
        centers = np.zeros((len(ids), 3), np.float32)
        depths = np.zeros(len(ids), np.int32)
        if len(ids):
            load_library().octree_decode_ids(
                _ptr(ids, ctypes.c_int64), len(ids), self._scale,
                _ptr(centers, ctypes.c_float), _ptr(depths, ctypes.c_int32))
        return centers, depths

    # ------------------------------------------------------------------
    # basic properties
    # ------------------------------------------------------------------

    def leaf_centers(self) -> np.ndarray:
        """(N, 3) leaf center coordinates."""
        return self._leaf_centers

    def leaf_depths(self) -> np.ndarray:
        """(N,) leaf depths."""
        return self._leaf_depths

    def leaf_data(self) -> Optional[np.ndarray]:
        """Per-leaf payload (or None)."""
        return self._leaf_data

    def __len__(self) -> int:
        """Total node count (interior + leaves)."""
        return len(self._node_index) + len(self._leaf_index)

    @property
    def num_leaves(self) -> int:
        """Number of leaves."""
        return len(self._leaf_index)

    @property
    def scale(self) -> float:
        """Root half side length."""
        return self._scale

    @property
    def depth(self) -> int:
        """Maximum depth of the tree: the deepest leaf's depth + 1
        (octree.py:624-633)."""
        if len(self._leaf_index) == 0:
            return 1
        return int(self._leaf_depths.max()) + 1

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    def query(self, positions: np.ndarray) -> np.ndarray:
        """Maps positions to containing-leaf indices (-1 = empty/out),
        in the C++ library."""
        positions = np.ascontiguousarray(positions, np.float32)
        if positions.shape[-1] != 3 or positions.ndim > 2:
            raise ValueError(f"positions must be (N, 3); got "
                             f"{positions.shape}")
        positions = positions.reshape(-1, 3)
        result = np.zeros(len(positions), np.int64)
        load_library().octree_batch_query(
            self._scale, _ptr(self._node_index, ctypes.c_int64),
            len(self._node_index), _ptr(self._leaf_index, ctypes.c_int64),
            len(self._leaf_index), _ptr(positions, ctypes.c_float),
            len(positions), _ptr(result, ctypes.c_int64))
        return result

    def index_tensors(self, device) -> tuple:
        """The sorted (node, leaf) int64 id tensors on ``device``."""
        return (torch.from_numpy(self._node_index).to(device),
                torch.from_numpy(self._leaf_index).to(device))

    def query_device(self, positions: torch.Tensor) -> torch.Tensor:
        """Point query in torch on the tensor's device."""
        node_index, leaf_index = self.index_tensors(positions.device)
        return device_batch_query(node_index, leaf_index, positions,
                                  scale=self._scale, max_depth=self.depth)

    def intersect(self, starts: np.ndarray, directions: np.ndarray,
                  max_length: int) -> Path:
        """Marches rays through the tree in the C++ library ->
        (t_stops, leaves) NumPy arrays."""
        starts = np.ascontiguousarray(starts, np.float32)
        directions = np.ascontiguousarray(directions, np.float32)
        if starts.shape[-1] != 3 or directions.shape[-1] != 3:
            raise ValueError("starts and directions must be (R, 3)")
        if starts.ndim == 1:
            starts = starts.reshape(1, 3)
            directions = directions.reshape(1, 3)
        if starts.shape != directions.shape:
            # the C++ loop is sized from starts alone and would read past
            # a shorter directions buffer
            raise ValueError(
                "starts and directions must have matching shapes; got "
                f"{starts.shape} vs {directions.shape}")
        num_rays = len(starts)
        t_stops = np.zeros((num_rays, max_length), np.float32)
        leaves = np.zeros((num_rays, max_length), np.int64)
        load_library().octree_batch_intersect(
            self._scale, _ptr(self._node_index, ctypes.c_int64),
            len(self._node_index), _ptr(self._leaf_index, ctypes.c_int64),
            len(self._leaf_index), _ptr(starts, ctypes.c_float),
            _ptr(directions, ctypes.c_float), num_rays, max_length,
            _ptr(t_stops, ctypes.c_float), _ptr(leaves, ctypes.c_int64))
        return Path(t_stops, leaves)

    def intersect_device(self, starts: torch.Tensor,
                         directions: torch.Tensor, max_length: int) -> Path:
        """Ray marching in torch on the tensors' device."""
        node_index, leaf_index = self.index_tensors(starts.device)
        return device_batch_intersect(node_index, leaf_index, starts,
                                      directions, scale=self._scale,
                                      max_depth=self.depth,
                                      max_length=max_length)

    # ------------------------------------------------------------------
    # construction / editing
    # ------------------------------------------------------------------

    @staticmethod
    def build_from_samples(positions: np.ndarray, depth: int,
                           min_leaf_size: int,
                           data: Optional[np.ndarray] = None) -> "OcTree":
        """Builds a sparse octree from a point cloud in the C++ library
        (octree.py:733-805).

        1-D ``data`` (one scalar per point) is treated as a single-column
        payload; leaf data then has shape (num_leaves, 1).
        """
        if data is not None:
            data = np.asarray(data)
            if data.ndim == 1:
                data = data[:, None]
        positions = np.asarray(positions, np.float32).copy()
        min_pos = positions.min(0)
        max_pos = positions.max(0)
        scale = float((max_pos - min_pos).max() * 0.5)
        positions -= 0.5 * (min_pos + max_pos)
        positions = np.ascontiguousarray(positions)
        if data is not None and len(data) != len(positions):
            raise ValueError(f"{len(data)} data rows for "
                             f"{len(positions)} points")

        lib = load_library()
        data_arr = (np.ascontiguousarray(data, np.float64)
                    if data is not None else np.zeros((0, 0)))
        data_dim = 0 if data is None else data_arr.shape[1]
        handle = lib.octree_build(
            _ptr(positions, ctypes.c_float), len(positions),
            _ptr(data_arr, ctypes.c_double), data_dim, depth, min_leaf_size,
            scale)
        try:
            counts = (ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64())
            lib.octree_counts(handle, *(ctypes.byref(c) for c in counts))
            num_nodes, num_leaves, dim = (c.value for c in counts)
            node_ids = np.zeros(num_nodes, np.int64)
            leaf_ids = np.zeros(num_leaves, np.int64)
            leaf_data = np.zeros((num_leaves, max(dim, 1)), np.float64)
            lib.octree_export(handle, _ptr(node_ids, ctypes.c_int64),
                              _ptr(leaf_ids, ctypes.c_int64),
                              _ptr(leaf_data, ctypes.c_double))
        finally:
            lib.octree_release(handle)
        payload = leaf_data if data is not None else None
        return OcTree(scale, node_ids.tolist(), leaf_ids.tolist(), payload)

    @staticmethod
    def build_from_mesh(mesh_path: str, voxel_depth: int,
                        min_leaf_size: int, up_dir=(0, 1, 0)) -> "OcTree":
        """Builds an octree by low-discrepancy sampling of a textured
        mesh surface (octree.py:807-853). Needs ``trimesh``, which
        raises ``ImportError`` when it is missing."""
        from .mesh import build_octree_from_mesh
        return build_octree_from_mesh(mesh_path, voxel_depth,
                                      min_leaf_size, up_dir)

    def prune(self) -> "OcTree":
        """Merges all deepest-level leaves into their parents
        (octree.py:635-671, payload averaged)."""
        if self._leaf_data is None:
            leaf_data = np.zeros((self.num_leaves, 1))
            no_data = True
        else:
            leaf_data = self._leaf_data
            no_data = False

        max_depth = self.depth - 1
        node_ids = set(self._node_index.tolist())
        new_data: Dict[int, np.ndarray] = {}
        new_counts: Dict[int, int] = {}
        for leaf_id, depth, data in zip(self._leaf_index.tolist(),
                                        self._leaf_depths, leaf_data):
            if depth < max_depth:
                new_data[leaf_id] = data
                new_counts[leaf_id] = 1
                continue
            parent = (leaf_id - 1) >> 3
            if parent not in new_data:
                node_ids.discard(parent)
                new_data[parent] = np.zeros_like(data)
                new_counts[parent] = 0
            new_data[parent] = new_data[parent] + data
            new_counts[parent] += 1

        leaf_ids = sorted(new_data)
        payload = None if no_data else np.stack(
            [new_data[i] / new_counts[i] for i in leaf_ids])
        return OcTree(self._scale, node_ids, leaf_ids, payload)

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------

    @property
    def state_dict(self) -> Dict[str, np.ndarray]:
        """State needed to reconstruct the tree (octree.py:868-880)."""
        state = {
            "node_index": self._node_index,
            "leaf_index": self._leaf_index,
            "scale": self._scale,
        }
        if self._leaf_data is not None:
            state["leaf_data"] = self._leaf_data
        return state

    def save(self, path: str):
        """Saves the tree as NPZ."""
        np.savez(path, **self.state_dict)

    @staticmethod
    def load(path_or_data: Union[str, Dict[str, np.ndarray]]) -> "OcTree":
        """Loads a tree from an NPZ path or a state dict."""
        if isinstance(path_or_data, str):
            if not os.path.exists(path_or_data):
                raise FileNotFoundError(path_or_data)
            with np.load(path_or_data) as data:
                return OcTree.load(dict(data))
        data = path_or_data
        scale = float(data["scale"])
        leaf_data = data["leaf_data"] if "leaf_data" in data else None
        return OcTree(scale, np.asarray(data["node_index"]).tolist(),
                      np.asarray(data["leaf_index"]).tolist(), leaf_data)

    def load_state(self, state_dict: Dict[str, np.ndarray]):
        """Re-initializes from a state dict (octree.py:922-927)."""
        self._update(state_dict["node_index"].tolist(),
                     state_dict["leaf_index"].tolist(),
                     float(state_dict["scale"]))
        self._leaf_data = state_dict.get("leaf_data")
