"""Console progress bar and run log (port of ``ETABar``, ``LogEntry``
and ``write_log`` from ``fourier_feature_nets_tpu/utils/progress.py``)."""

import sys
import time
from typing import NamedTuple

__all__ = ["ETABar", "LogEntry", "write_log"]


class ETABar:
    """Minimal console progress bar with an ETA readout."""

    def __init__(self, message: str, max: int):
        self.message = message
        self.max = max
        self.current = 0
        self._info = ""
        self._start = time.time()

    def next(self, n: int = 1):
        """Advances the bar by n units and redraws."""
        self.current = min(self.current + n, self.max)
        self._draw()

    def info(self, text: str):
        """Appends a status message to the progress bar."""
        self._info = text

    def _draw(self):
        if not sys.stderr.isatty():
            return
        fraction = self.current / self.max if self.max else 1.0
        elapsed = time.time() - self._start
        eta = elapsed / fraction - elapsed if fraction > 0 else 0
        width = 24
        filled = int(width * fraction)
        bar = "█" * filled + "∙" * (width - filled)
        sys.stderr.write(f"\r{self.message} {bar} {fraction:6.1%}"
                         f" - {eta:.0f}s {self._info}")
        sys.stderr.flush()

    def finish(self):
        """Completes and terminates the progress line."""
        if sys.stderr.isatty():
            sys.stderr.write("\n")
            sys.stderr.flush()


class LogEntry(NamedTuple):
    """A training-trajectory snapshot: ``state`` is the model's
    parameters as the JAX package's flat ``{path: array}`` dict."""

    step: int
    timestamp: float
    state: dict
    train_psnr: float
    val_psnr: float


def write_log(path, log) -> None:
    """Writes the training log as TSV to a path or an open file."""
    if hasattr(path, "write"):
        _write_log_rows(path, log)
        return
    with open(path, "w") as file:
        _write_log_rows(file, log)


def _write_log_rows(file, log) -> None:
    file.write("step\ttimestamp\tpsnr_train\tpsnr_val\n")
    for entry in log:
        file.write(f"{entry.step}\t{entry.timestamp}\t"
                   f"{entry.train_psnr}\t{entry.val_psnr}\n")
