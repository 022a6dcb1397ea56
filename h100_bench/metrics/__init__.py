"""Per-layer metric readers, one a family: the metric ``<family>.<part>``
is read by ``<family>.py``, whose ``read(trace) -> float | None`` gets a
traced run's readings as a dict:

* the traced slice: the profiler's ``device_ops`` (name, start and end
  in microseconds), ``busy_s`` and ``window_s``, and the slice's work
  from the frozen counts: ``units`` (frames or steps), ``k1_bound_s``
  and ``k2_bound_s``;
* the untraced window that ran before it: ``window_seconds`` and its
  model operations, ``window_model_flops``.

A reader that finds nothing to read returns None; none returns 0 for a
share.
"""
