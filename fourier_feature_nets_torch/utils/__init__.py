"""Host-side helpers: camera paths, progress bar, PNG writer."""

from .camera_paths import (
    fibonacci_hemisphere,
    hemisphere,
    look_at_extrinsics,
    orbit,
    rotation_about_axis,
)
from .png import write_png
from .progress import ETABar

__all__ = ["ETABar", "fibonacci_hemisphere", "hemisphere",
           "look_at_extrinsics", "orbit", "rotation_about_axis", "write_png"]
