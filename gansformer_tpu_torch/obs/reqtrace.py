"""Per-request tracing: "what happened to request X?" (the port's copy of
``gansformer_tpu/obs/reqtrace.py``).

Every ``Ticket`` of the service (``serve/service.py``) gets a request ID
at submit and a lifecycle event stream::

    submitted → admitted → popped → batched → wcache_hit|map_dispatch
              → synth → fetch → fulfilled
                               └ terminal: shed / expired / cancelled /
                                 failed (with a cause)

* **Bounded overhead.**  An emit point is a dict append under one lock:
  never a device fetch, a file write (``flush`` alone writes) or an
  allocation that grows with traffic.
* **Bounded growth.**  Active traces are capped (``max_active``; the
  oldest is evicted into ``reqtrace/dropped_total``), the ledger is
  capped (``max_ledger_rows``; the overflow counts in
  ``reqtrace/ledger_dropped_total``) and the recent ring is a fixed
  deque.
* **Two exports.**  A ``requests.jsonl`` ledger (one row per terminal
  request: outcome, cause, e2e, its events) and Chrome async events
  (``ph`` b / n / e keyed by the request ID) in the span tracer's
  ``events.jsonl`` (``obs/spans.py``), beside a ``serve_batch`` event per
  dispatched batch that lists the request IDs it carried.

The service uses the process-global tracer (``get_reqtracer()``); tests
build their own ``ReqTracer`` with fake clocks.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, List, Optional

from gansformer_tpu_torch.obs import registry as telemetry
from gansformer_tpu_torch.obs.spans import get_tracer

# terminal event kinds: every submitted request reaches exactly one
TERMINAL_KINDS = ("fulfilled", "shed", "expired", "cancelled", "failed")
EVENT_KINDS = ("submitted", "admitted", "popped", "batched", "wcache_hit",
               "map_dispatch", "synth", "fetch") + TERMINAL_KINDS

# ledger rows buffered in memory before an append
_LEDGER_FLUSH_EVERY = 64

_COUNTERS = ("reqtrace/requests_total", "reqtrace/events_total",
             "reqtrace/terminal_total", "reqtrace/dropped_total",
             "reqtrace/ledger_rows_total", "reqtrace/ledger_dropped_total")


class ReqTracer:
    """Request-ID allocator and per-request event recorder.

    ``begin()`` opens a trace (the ``submitted`` event), ``event()``
    appends one; a terminal kind finalizes it: the trace leaves the
    active table for the recent ring and, with a ledger configured, the
    buffer of ``requests.jsonl``.  Every method is a cheap no-op while
    ``enabled`` is False."""

    def __init__(self, time_fn: Callable[[], float] = time.perf_counter,
                 wall_fn: Callable[[], float] = time.time):
        self._time = time_fn
        self._wall = wall_fn
        self._lock = threading.Lock()
        self._seq = 0
        self._pid = os.getpid()
        self._active: "OrderedDict[str, dict]" = OrderedDict()
        self._recent: "deque[dict]" = deque(maxlen=4096)
        self._buffer: List[dict] = []
        self._ledger_path: Optional[str] = None
        self._ledger_rows = 0
        self._max_ledger_rows = 20000
        self._max_active = 65536
        self._chrome = True
        self.enabled = True

    # -- configuration -------------------------------------------------------

    def configure(self, ledger_path: Optional[str] = None,
                  max_ledger_rows: int = 20000, truncate: bool = True,
                  enabled: bool = True, max_active: int = 65536,
                  chrome_events: bool = True) -> "ReqTracer":
        """Point the tracer at a ``requests.jsonl`` (or None: in memory
        only, the recent ring still answers).  Creates the ``reqtrace/*``
        counters, so their absence in a prom means the wiring broke,
        never "no traffic yet"."""
        with self._lock:
            self._flush_locked()
            self._ledger_path = ledger_path
            self._max_ledger_rows = int(max_ledger_rows)
            self._max_active = int(max_active)
            self._chrome = bool(chrome_events)
            self.enabled = bool(enabled)
            self._ledger_rows = 0
            if ledger_path and (truncate
                                or not os.path.exists(ledger_path)):
                parent = os.path.dirname(ledger_path)
                if parent:
                    os.makedirs(parent, exist_ok=True)
                open(ledger_path, "w").close()
        for name in _COUNTERS:
            telemetry.counter(name)
        telemetry.gauge("reqtrace/enabled").set(1.0 if enabled else 0.0)
        return self

    def reset(self) -> None:
        """Drop the active traces, the recent ring and the buffered rows
        (the ID sequence goes on, so IDs stay unique in a process)."""
        with self._lock:
            self._active.clear()
            self._recent.clear()
            self._buffer.clear()
            self._ledger_rows = 0

    # -- recording -----------------------------------------------------------

    def begin(self, seed=None, psi=None) -> Optional[str]:
        """Open a trace and return its request ID (None while disabled)."""
        if not self.enabled:
            return None
        t0 = self._time()
        with self._lock:
            self._seq += 1
            rid = f"r{self._pid}-{self._seq}"
            evicted = None
            if len(self._active) >= self._max_active:
                # tickets that never resolve must not grow the table
                _, evicted = self._active.popitem(last=False)
            self._active[rid] = {
                "rid": rid, "t0": t0, "t_wall": self._wall(),
                "seed": seed, "psi": psi, "batch": None,
                "events": [["submitted", 0.0, None]],
            }
        telemetry.counter("reqtrace/requests_total").inc()
        telemetry.counter("reqtrace/events_total").inc()
        if evicted is not None:
            telemetry.counter("reqtrace/dropped_total").inc()
        return rid

    def event(self, rid: Optional[str], kind: str, **attrs) -> None:
        """Append one lifecycle event; a terminal kind finalizes the
        trace.  A None or unknown (evicted) rid is ignored."""
        if not self.enabled or rid is None:
            return
        t = self._time()
        row = None
        with self._lock:
            rec = self._active.get(rid)
            if rec is None:
                return
            dt_ms = round((t - rec["t0"]) * 1000.0, 3)
            rec["events"].append([kind, dt_ms, attrs or None])
            if "batch" in attrs:
                rec["batch"] = attrs["batch"]
            if kind in TERMINAL_KINDS:
                del self._active[rid]
                row = self._finalize_locked(rec, kind, dt_ms, attrs)
        telemetry.counter("reqtrace/events_total").inc()
        if row is not None:
            telemetry.counter("reqtrace/terminal_total").inc()
            if row.get("_ledgered"):
                telemetry.counter("reqtrace/ledger_rows_total").inc()
            else:
                telemetry.counter("reqtrace/ledger_dropped_total").inc()
            if self._chrome:
                self._emit_chrome(row)

    def _finalize_locked(self, rec: dict, outcome: str, dt_ms: float,
                         attrs: dict) -> dict:
        row = {
            "rid": rec["rid"], "t_wall": rec["t_wall"],
            "seed": rec["seed"], "psi": rec["psi"],
            "batch": rec["batch"], "outcome": outcome,
            "cause": attrs.get("cause"), "e2e_ms": dt_ms,
            "events": [
                ({"kind": k, "t_ms": t} | (a or {}))
                for k, t, a in rec["events"]],
            "_t0": rec["t0"],
        }
        self._recent.append(row)
        ledgered = (self._ledger_path is not None
                    and self._ledger_rows < self._max_ledger_rows)
        if ledgered:
            self._ledger_rows += 1
            self._buffer.append(row)
            if len(self._buffer) >= _LEDGER_FLUSH_EVERY:
                self._flush_locked()
        row["_ledgered"] = ledgered
        return row

    def _emit_chrome(self, row: dict) -> None:
        """The finalized trace as Chrome async events on the span
        tracer's timeline: a b / e pair around an instant per event."""
        tracer = get_tracer()
        tid = threading.get_ident()
        t0 = row["_t0"]

        def ev(ph: str, dt_ms: float, args: Optional[dict]) -> dict:
            e = {"name": "request", "cat": "req", "ph": ph,
                 "id": row["rid"], "ts": tracer.ts_us(t0 + dt_ms / 1e3),
                 "pid": tracer.process_index, "tid": tid}
            if args:
                e["args"] = args
            return e

        tracer.emit(ev("b", 0.0, {"rid": row["rid"],
                                  "seed": row["seed"]}))
        for e in row["events"][1:-1]:
            tracer.emit(ev("n", e["t_ms"],
                           {k: v for k, v in e.items() if k != "t_ms"}))
        tracer.emit(ev("e", row["e2e_ms"],
                       {"outcome": row["outcome"],
                        "cause": row["cause"]}))

    def batch_span(self, batch: int, bucket: int, rids: List[str],
                   t0: float, dur_s: float) -> None:
        """One ``serve_batch`` complete event listing the request IDs a
        dispatch carried: the batch → requests link."""
        if not self.enabled or not self._chrome:
            return
        tracer = get_tracer()
        tracer.emit({"name": "serve_batch", "ph": "X",
                     "ts": tracer.ts_us(t0),
                     "dur": round(max(dur_s, 0.0) * 1e6, 3),
                     "pid": tracer.process_index,
                     "tid": threading.get_ident(),
                     "args": {"batch": batch, "bucket": bucket,
                              "rids": [r for r in rids if r]}})

    # -- reading / flushing --------------------------------------------------

    def recent(self) -> List[dict]:
        """The finalized traces in the recent ring (newest last), without
        the private keys."""
        with self._lock:
            rows = list(self._recent)
        return [{k: v for k, v in r.items() if not k.startswith("_")}
                for r in rows]

    def active_rids(self) -> List[str]:
        with self._lock:
            return list(self._active)

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._buffer:
            return
        if self._ledger_path is not None:
            with open(self._ledger_path, "a") as f:
                for row in self._buffer:
                    f.write(json.dumps(
                        {k: v for k, v in row.items()
                         if not k.startswith("_")}) + "\n")
        self._buffer.clear()


_REQTRACER = ReqTracer()


def get_reqtracer() -> ReqTracer:
    return _REQTRACER


def configure_reqtrace(ledger_path: Optional[str] = None,
                       **kw) -> ReqTracer:
    return _REQTRACER.configure(ledger_path, **kw)


def read_requests(path: str) -> List[dict]:
    """The rows of a ``requests.jsonl``; torn lines are skipped (a crashed
    run's ledger is the one worth reading)."""
    out: List[dict] = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            try:
                row = json.loads(line)
            except ValueError:
                continue
            if isinstance(row, dict):
                out.append(row)
    return out


def render_timeline(row: dict) -> str:
    """One request's events as an aligned text timeline."""
    head = (f"request {row.get('rid')}  seed={row.get('seed')} "
            f"psi={row.get('psi')}  outcome={row.get('outcome')}"
            + (f" cause={row['cause']}" if row.get("cause") else "")
            + (f"  batch={row['batch']}"
               if row.get("batch") is not None else "")
            + f"  e2e={row.get('e2e_ms')} ms")
    lines = [head]
    for ev in row.get("events", []):
        extras = ", ".join(f"{k}={v}" for k, v in sorted(ev.items())
                           if k not in ("kind", "t_ms") and v is not None)
        lines.append("  +{:>10.3f} ms  {:<12s}{}".format(
            float(ev.get("t_ms", 0.0)), str(ev.get("kind")),
            f"  ({extras})" if extras else ""))
    return "\n".join(lines)
