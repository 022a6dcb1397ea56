"""Sparse octree: the native C++ build and traversal, and the torch
traversal of the render path."""

from .octree import OcTree
from .traversal import Path

__all__ = ["OcTree", "Path"]
