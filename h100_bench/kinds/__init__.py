"""The kinds of cell, one module each: ``Cell(cfg, mix, seed, device,
configs)`` with ``setup``, ``window``, ``release``, ``check``, ``counts``
and ``control``."""
