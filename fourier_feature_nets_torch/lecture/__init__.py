"""Lecture companion: educational figures and animations (port of
``fourier_feature_nets_tpu/lecture``), built on the port's ops, models
and raycaster. Frames are written by the port's PNG writer and
Motion-JPEG MP4 writer, where the JAX package uses OpenCV."""

from .animations import (
    save_all_animations,
    view_angle_animation,
    voxels_animation,
)
from .figures import save_all_figures

__all__ = ["save_all_animations", "save_all_figures",
           "voxels_animation", "view_angle_animation"]
