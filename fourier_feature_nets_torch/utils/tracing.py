"""Spans: the port's record of where its time goes, kept in memory.

A span is a named interval of the program's work: its name, its start
and end on ``time.perf_counter_ns``, the span it opened inside (on the
same thread), an id, and attributes, which hold the counts (hit rays,
chunks, steps, a request id)::

    with span("frame") as frame:
        ...
        frame.set(hit_rays=hit, chunks=count)

Spans are off by default. :func:`span` records only while tracing is
active: while a ``torch.profiler`` session runs on the calling thread
(``torch.autograd._profiler_enabled()``, thread-local), or while
:func:`record_all_threads` has switched the recorder on for the whole
process (``utils.debug.profile`` does). Off, a span costs that check and
nothing is kept. A span is not a ``record_function`` range: under a
profile of the device's activity alone, as the benchmark takes, the
profiler keeps no range, and the frame's 37 ranges slowed a traced
800 px frame by 16-52% on an H100 (PERF.md, section 5).

Spans are grouped in sessions. A session opens at a thread's first
active span after an inactive one, or after another session opened, or
at :func:`record_all_threads`; two profiles on one thread with no span
between them make one session. A session reads ``time.perf_counter_ns``
and ``time.time_ns`` together at its start. The profiler's clock is the
Unix clock, so :func:`profile_spans` puts the session's spans on a
finished profile's clock, beside the device's kernels, through that
pair. (A ``record_function`` range opened as an anchor lagged the pair
by 0.07-0.25 ms, and by 8 ms on a loaded host.)

Set-up spans (:func:`setup_span`) mark work that a process does a
bounded number of times: a kernel library's build or load, a graph's
warm-up and capture. They are recorded whether tracing is active or not.

Nothing is written out on the hot path: the readers are
:func:`latest` (the newest session's spans and the set-up spans since
the session before it), :func:`profile_spans` and :func:`idle_by_span`,
which puts each idle gap of the device in a finished profile under the
innermost span covering it.
"""

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

__all__ = ["CALLER", "Session", "Span", "idle_by_span", "latest",
           "profile_spans", "record_all_threads", "setup_span", "span",
           "trace_start_ns"]

# idle_by_span's name for a gap that no span covers
CALLER = "(caller)"
# spans kept; the oldest go first
_KEPT = 1 << 18


class Session:
    """Spans recorded over one stretch of active tracing: ``perf_ns`` and
    ``wall_ns`` are ``time.perf_counter_ns`` and ``time.time_ns`` read
    together at its start; ``first_id`` is an id no later span takes."""

    __slots__ = ("perf_ns", "wall_ns", "first_id")

    def __init__(self, first_id: int):
        self.first_id = first_id
        self.perf_ns = time.perf_counter_ns()
        self.wall_ns = time.time_ns()


class Span:
    """One recorded span; ``end_ns`` is 0 while it is open."""

    __slots__ = ("name", "attrs", "id", "parent", "thread", "session",
                 "setup", "start_ns", "end_ns")

    def __init__(self, name: str, attrs: dict, session: Optional[Session],
                 setup: bool):
        self.name, self.attrs = name, attrs
        self.session, self.setup = session, setup
        self.id = next(_ids)
        self.parent = None
        self.thread = threading.get_native_id()
        self.start_ns = self.end_ns = 0

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def set(self, **attrs) -> None:
        """Adds attributes (counts known only inside the span)."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        stack = _stack()
        if stack:
            self.parent = stack[-1].id
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        stack = _stack()
        if stack[-1] is self:
            stack.pop()
        else:  # a generator's span, closed out of order
            stack.remove(self)
        _spans.append(self)
        return False


class _Off:
    """The span of inactive tracing: records nothing."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()
_ids = itertools.count(1)
_spans = collections.deque(maxlen=_KEPT)
_sessions: List[Session] = []
_sessions_lock = threading.Lock()
_local = threading.local()
# the session of record_all_threads, or None
_everywhere: Optional[Session] = None


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _open_session() -> Session:
    with _sessions_lock:
        session = Session(next(_ids))
        _sessions.append(session)
    return session


def _session() -> Optional[Session]:
    """The calling thread's active session, or None when tracing is
    inactive. A thread's first active span after an inactive one opens a
    session, and so does its first active span after another session
    opened."""
    if _everywhere is not None:
        return _everywhere
    if not torch.autograd._profiler_enabled():
        _local.session = None
        return None
    session = getattr(_local, "session", None)
    if session is None or session is not _sessions[-1]:
        session = _local.session = _open_session()
    return session


def span(name: str, **attrs):
    """A span of the program's work, recorded while tracing is active."""
    session = _session()
    if session is None:
        return _OFF
    return Span(name, attrs, session, False)


def setup_span(name: str, **attrs) -> Span:
    """A span of set-up work, recorded whether tracing is active or
    not."""
    return Span(name, attrs, _session(), True)


@contextlib.contextmanager
def record_all_threads():
    """Records the spans of every thread while open, in one session,
    which it yields."""
    global _everywhere
    if _everywhere is not None:
        raise RuntimeError("the recorder is already on for every thread")
    _everywhere = _open_session()
    try:
        yield _everywhere
    finally:
        _everywhere = None


def latest():
    """(the newest session's spans, the set-up spans recorded since the
    session before it), each in the order they started; ([], set-up
    spans) before any session."""
    with _sessions_lock:
        sessions = list(_sessions)
    spans = sorted(list(_spans), key=lambda s: s.start_ns)
    newest = sessions[-1] if sessions else None
    before = sessions[-2] if len(sessions) > 1 else None
    ours = [s for s in spans if newest is not None and s.session is newest]
    setup = [s for s in spans if s.setup and (
        before is None or (s.session is not before
                           and s.id > before.first_id))]
    return ours, setup


def trace_start_ns(prof) -> int:
    """The Unix nanosecond at which the finished profile ``prof``'s
    clock starts: its events' microseconds count from there."""
    return prof.profiler.kineto_results.trace_start_ns()


def profile_spans(prof, session: Optional[Session] = None) -> List[tuple]:
    """The spans of ``session`` (the newest by default) on the finished
    profile ``prof``'s clock: (name, start_us, end_us, span) rows, in
    microseconds from the profile's start as its events have them."""
    if session is None:
        with _sessions_lock:
            if not _sessions:
                return []
            session = _sessions[-1]
    base = session.wall_ns - session.perf_ns - trace_start_ns(prof)
    return [(s.name, (s.start_ns + base) * 1e-3, (s.end_ns + base) * 1e-3, s)
            for s in sorted(list(_spans), key=lambda s: s.start_ns)
            if s.session is session]


def idle_by_span(events, spans) -> Dict[str, float]:
    """Milliseconds of device idle time under each span, from a finished
    profile's ``events`` (``prof.events()``: name, ``device_type`` and
    ``time_range`` in microseconds) and ``spans``, (name, start_us,
    end_us, ...) rows on the events' clock::

        idle_by_span(prof.events(), profile_spans(prof))

    Each gap between the device's operations, from its first to its last,
    goes to the innermost span covering the gap's middle. A gap that no
    span covers is the caller's (:data:`CALLER`)."""
    device = [(float(e.time_range.start), float(e.time_range.end))
              for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              # a host range's shadow on the device is no work of its own
              and not getattr(e, "is_user_annotation", False)]
    ranges = [tuple(row[:3]) for row in spans]
    merged = []
    for start, end in sorted(device):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    idle: Dict[str, float] = {}
    for (_, gap_start), (gap_end, _) in zip(merged[:-1], merged[1:]):
        middle = 0.5 * (gap_start + gap_end)
        covering = [(end - start, name) for name, start, end in ranges
                    if start <= middle <= end]
        name = min(covering)[1] if covering else CALLER
        idle[name] = idle.get(name, 0.0) + (gap_end - gap_start) * 1e-3
    return idle
