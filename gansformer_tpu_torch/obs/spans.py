"""Trace spans: per-phase wall time and Chrome-trace events (the port's
copy of ``gansformer_tpu/obs/spans.py``).

``span("phase")`` is a nestable context manager with a span stack per
thread.  On exit a span adds its self time (its duration less the time
of its child spans on the same thread), its total time and one Chrome
trace event (``"ph": "X"``, microseconds) to the tracer; the events are
appended to the run's ``events.jsonl``.  Self times partition the
covered wall time, so the ``timing/phase/*`` stats of a tick sum to
``sec_per_tick``.  Production code uses the process-global tracer;
tests build their own ``Tracer`` with a fake clock.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

# events buffered in memory before an incremental append to the sink
_FLUSH_EVERY = 512


class SpanHandle:
    """What ``span(...)`` yields: ``duration_s`` is filled at span exit."""

    __slots__ = ("name", "duration_s")

    def __init__(self, name: str):
        self.name = name
        self.duration_s = 0.0


class Tracer:
    """Accumulates per-phase wall time and emits Chrome-trace events.

    ``time_fn`` is the monotonic span clock (tests pass a fake);
    durations and the trace timeline both derive from it, so a
    monkeypatched clock produces a fully consistent trace.
    """

    def __init__(self, time_fn: Callable[[], float] = time.perf_counter):
        self._time = time_fn
        self._lock = threading.Lock()
        self._local = threading.local()
        self._self_s: Dict[str, float] = {}
        self._total_s: Dict[str, float] = {}
        self._count: Dict[str, int] = {}
        self._events: List[dict] = []
        self._sink_path: Optional[str] = None
        self._pid = 0
        self._origin = time_fn()

    # -- configuration -----------------------------------------------------

    def configure(self, events_path: Optional[str],
                  process_index: int = 0, truncate: bool = True) -> None:
        """Point the tracer at a run dir's ``events.jsonl`` (truncated:
        one trace per run).  ``events_path=None`` keeps accumulating
        totals but drops trace events (non-zero processes).

        ``truncate=False`` (resume) appends instead, preserving the
        crash-window events the aborted process flushed; the resumed
        process's ``ts`` restarts at 0, which Chrome-trace viewers
        render as overlapping tracks rather than an error."""
        with self._lock:
            self._flush_locked()
            self._sink_path = events_path
            self._pid = process_index
            self._origin = self._time()
            if events_path and (truncate or not os.path.exists(events_path)):
                parent = os.path.dirname(events_path)
                if parent:
                    os.makedirs(parent, exist_ok=True)
                open(events_path, "w").close()

    def reset(self) -> None:
        """Discard accumulated totals and buffered events (run start)."""
        with self._lock:
            self._self_s.clear()
            self._total_s.clear()
            self._count.clear()
            self._events.clear()

    # -- spans -------------------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextmanager
    def span(self, name: str):
        """Yields a handle whose ``duration_s`` is set on exit, so call
        sites that also want the duration (e.g. for a gauge) read it from
        the span instead of re-timing the same region."""
        stack = self._stack()
        frame = [name, self._time(), 0.0]       # name, start, child time
        stack.append(frame)
        handle = SpanHandle(name)
        try:
            yield handle
        finally:
            end = self._time()
            stack.pop()
            dur = end - frame[1]
            handle.duration_s = dur
            self_s = max(dur - frame[2], 0.0)
            if stack:
                stack[-1][2] += dur
            with self._lock:
                self._self_s[name] = self._self_s.get(name, 0.0) + self_s
                self._total_s[name] = self._total_s.get(name, 0.0) + dur
                self._count[name] = self._count.get(name, 0) + 1
                if self._sink_path is not None:
                    self._events.append({
                        "name": name, "ph": "X",
                        "ts": round((frame[1] - self._origin) * 1e6, 3),
                        "dur": round(dur * 1e6, 3),
                        "pid": self._pid, "tid": threading.get_ident(),
                    })
                    if len(self._events) >= _FLUSH_EVERY:
                        self._flush_locked()

    # -- pre-formed events (request tracing) --------------------------------

    @property
    def process_index(self) -> int:
        return self._pid

    def ts_us(self, t: Optional[float] = None) -> float:
        """A ``time_fn`` timestamp (default: now) in microseconds on this
        tracer's timeline, clamped at 0 (an event recorded before
        ``configure()`` moved the origin lands at the start)."""
        t = self._time() if t is None else t
        return round(max(t - self._origin, 0.0) * 1e6, 3)

    def emit(self, event: dict) -> None:
        """Append one pre-formed Chrome-trace event (a request's async
        events, a serving batch) to the sink the span events go to; its
        ``ts`` should come from ``ts_us``.  Dropped while no sink is
        configured, as span events are."""
        with self._lock:
            if self._sink_path is None:
                return
            self._events.append(event)
            if len(self._events) >= _FLUSH_EVERY:
                self._flush_locked()

    # -- draining / flushing -----------------------------------------------

    def drain(self) -> Dict[str, Dict[str, float]]:
        """{phase: {self_s, total_s, count}} accumulated since the last
        drain; resets the accumulators and flushes buffered events."""
        with self._lock:
            out = {n: {"self_s": self._self_s[n],
                       "total_s": self._total_s.get(n, 0.0),
                       "count": float(self._count.get(n, 0))}
                   for n in self._self_s}
            self._self_s, self._total_s, self._count = {}, {}, {}
            self._flush_locked()
        return out

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._events:
            return
        if self._sink_path is not None:
            with open(self._sink_path, "a") as f:
                for ev in self._events:
                    f.write(json.dumps(ev) + "\n")
        self._events.clear()


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def configure_tracer(events_path: Optional[str],
                     process_index: int = 0, truncate: bool = True) -> Tracer:
    _TRACER.configure(events_path, process_index, truncate=truncate)
    return _TRACER


def span(name: str):
    """``with span("data_wait"): ...`` on the process-global tracer."""
    return _TRACER.span(name)
