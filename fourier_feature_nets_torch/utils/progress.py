"""Console progress bar (port of ``ETABar`` from
``fourier_feature_nets_tpu/utils/progress.py``)."""

import sys
import time

__all__ = ["ETABar"]


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
