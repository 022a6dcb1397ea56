"""Host-side helpers: the asset cache and downloader, checkpoints, debug
switches, camera paths, the learning-rate schedule, logging and the PNG
writer."""

from .assets import ASSETS, default_data_dir, download_asset
from .camera_paths import (
    fibonacci_hemisphere,
    hemisphere,
    look_at_extrinsics,
    orbit,
    rotation_about_axis,
    shuffle_positions,
)
from .checkpoint import (
    AdamState,
    AsyncCheckpointer,
    TrainState,
    latest_checkpoint,
    load_train_state,
    save_train_state,
)
from .debug import enable_debug_nans, init_from_env, profile
from .optim import exponential_lr
from .png import write_png
from .progress import ETABar, LogEntry, write_log

__all__ = ["ASSETS", "AdamState", "AsyncCheckpointer", "ETABar", "LogEntry",
           "TrainState", "default_data_dir", "download_asset",
           "enable_debug_nans", "exponential_lr", "fibonacci_hemisphere",
           "hemisphere", "init_from_env", "latest_checkpoint",
           "load_train_state", "look_at_extrinsics", "orbit", "profile",
           "rotation_about_axis", "save_train_state", "shuffle_positions",
           "write_log", "write_png"]
