"""Sparse octree: the native C++ build and traversal, and the torch
traversal of the render path."""

from .octree import OcTree
from .traversal import Path, device_batch_intersect, device_batch_query

__all__ = ["OcTree", "Path", "device_batch_intersect", "device_batch_query"]
