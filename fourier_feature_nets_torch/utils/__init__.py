"""Host-side helpers: camera paths, progress bar, PNG writer."""

from .camera_paths import look_at_extrinsics, orbit, rotation_about_axis
from .png import write_png
from .progress import ETABar

__all__ = ["ETABar", "look_at_extrinsics", "orbit", "rotation_about_axis",
           "write_png"]
