"""The supervisor event ledger and the exit contract of a training run
(the port's copy of ``gansformer_tpu/supervise/events.py``, standard
library only).

``supervisor_events.jsonl`` holds one JSON line per lifecycle event
(start, exit, resume, elastic, give-up, complete); an unsupervised
``--resume`` writes its ``resume`` line here.  The exit codes are the
JAX package's, so one supervisor drives either package:
``EXIT_PREEMPTED`` (75) after a graceful SIGTERM checkpoint,
``EXIT_DATA_CORRUPT`` (65) once the corruption budget is spent,
``EXIT_DATA_STALLED`` (74) when the input pipeline stalls.
``PreemptionExit`` is what the loop raises to reach the first.
``availability`` sums a ledger into uptime, downtime, restarts and exit
causes for the supervisor's telemetry and the doctor.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

EVENTS_FILE = "supervisor_events.jsonl"
SCHEMA_VERSION = 1

# Exit code of a gracefully preempted training process (SIGTERM → final
# synchronous checkpoint → exit).  75 is EX_TEMPFAIL: "try again later",
# which is literally the supervisor's reading of it.
EXIT_PREEMPTED = 75

# Typed data-plane exits.  EX_DATAERR (65): the corruption
# budget is exhausted — a STATIC defect of the data on disk, so the
# supervisor treats it as non-retryable instead of crash-looping on it.
# EX_IOERR (74): the input pipeline stalled past its watchdog — possibly
# a transient filesystem wedge, so it stays retryable but classified.
EXIT_DATA_CORRUPT = 65
EXIT_DATA_STALLED = 74

# The exit-cause vocabulary the supervisor classifies into; anything
# else in the ledger is an "unclassified exit" the doctor WARNs on.
CAUSES = ("clean", "crash", "preemption", "hang", "data-corrupt",
          "data-stall")

# Causes a restart cannot fix: the supervisor gives up immediately
# WITHOUT consuming restart budget (the budget exists for transient
# failures; burning it on a static defect is a crash loop).
NON_RETRYABLE_CAUSES = ("data-corrupt",)

# Event kinds the ledger schema lint accepts (telemetry_schema.py).
KINDS = ("supervisor_start", "start", "exit", "resume", "elastic",
         "give_up", "complete", "supervisor_preempted")


class PreemptionExit(RuntimeError):
    """Raised by the train loop after a graceful preemption checkpoint;
    the train CLI converts it into ``SystemExit(EXIT_PREEMPTED)``."""

    def __init__(self, step: int):
        super().__init__(f"preemption checkpoint complete at step {step}")
        self.step = int(step)


def events_path(run_dir: str) -> str:
    return os.path.join(run_dir, EVENTS_FILE)


def append_event(run_dir: str, kind: str, **fields) -> dict:
    """Append one ledger line (fsync'd: the very next thing after some
    of these events is a SIGKILL, and the record must survive it)."""
    rec = {"schema": SCHEMA_VERSION, "kind": kind, "time": time.time(),
           "pid": os.getpid(), **fields}
    os.makedirs(run_dir, exist_ok=True)
    with open(events_path(run_dir), "a") as f:
        f.write(json.dumps(rec) + "\n")
        f.flush()
        os.fsync(f.fileno())
    return rec


def read_events(run_dir: str) -> List[dict]:
    """Ledger lines, torn-line-tolerant (a SIGKILL mid-append is the
    normal ending for exactly the runs this ledger describes)."""
    path = events_path(run_dir)
    out: List[dict] = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    return out


def availability(events: List[dict],
                 now: Optional[float] = None) -> Dict[str, object]:
    """Availability summary over a ledger, the one derivation the doctor's
    availability check and the supervisor's own telemetry both use.

    * ``uptime_s`` / ``downtime_s`` — summed from exit/start events.
    * ``ratio`` — uptime / (uptime + downtime), or None before any
      exit landed.
    * ``restarts`` — supervisor re-arms (start events with
      restart_index > 0) plus train-side ``resume`` events.
    * ``restarts_last_hour`` — the restart-storm signal.
    * ``causes`` — exit-cause counts; ``unclassified`` lists causes
      outside the vocabulary.
    * ``gave_up`` / ``completed`` — terminal verdicts, if any.
    """
    now = time.time() if now is None else now
    uptime = sum(float(e.get("uptime_s", 0.0)) for e in events
                 if e.get("kind") == "exit")
    downtime = sum(float(e.get("downtime_s", 0.0)) for e in events
                   if e.get("kind") in ("start", "resume"))
    restart_events = [e for e in events
                      if (e.get("kind") == "start"
                          and e.get("restart_index", 0))
                      or e.get("kind") == "resume"]
    causes: Dict[str, int] = {}
    for e in events:
        if e.get("kind") == "exit":
            c = str(e.get("cause", "?"))
            causes[c] = causes.get(c, 0) + 1
    total = uptime + downtime
    return {
        "uptime_s": uptime,
        "downtime_s": downtime,
        "ratio": (uptime / total) if total > 0 else None,
        "restarts": len(restart_events),
        "restarts_last_hour": sum(
            1 for e in restart_events
            if float(e.get("time", 0.0)) >= now - 3600.0),
        "causes": causes,
        "unclassified": sorted(c for c in causes if c not in CAUSES),
        "gave_up": any(e.get("kind") == "give_up" for e in events),
        "completed": any(e.get("kind") == "complete" for e in events),
        "last_step": max((int(e.get("step", 0)) for e in events
                          if "step" in e), default=0),
    }
