"""Deterministic fault injection at named code points (the port's copy of
``gansformer_tpu/supervise/faults.py``), so every recovery path is
exercised by a test rather than trusted:

    GANSFORMER_TPU_FAULTS="sigterm@tick:tick=0"
    GANSFORMER_TPU_FAULT_LEDGER=<run_dir>/faults_fired.jsonl

A spec is ``<action>@<point>[:k=v[,k=v...]]``; each condition reads
``coordinate >= value``, so a fault fires at the first crossing, and
each spec fires once (recorded in the ledger before it acts, so a
restarted process with the same environment does not fire it again).

Actions: ``sigkill`` (the unannounced crash), ``sigterm`` (the
preemption notice; the loop turns it into a graceful checkpoint),
``hang`` (a wedged thread), ``torn`` (truncate the file named by the
fire site's ``path``) and ``raise`` (``FaultInjected``).

Points of the port: ``ckpt_mid_write`` and ``ckpt_after_write``
(``train/checkpoint.py``, ``step=``), ``tick`` (``train/loop.py``,
``tick=``/``step=``), ``data_thread`` (the prefetch producer,
``batch=``), and the TFRecord read path's ``data_read_error`` /
``data_slow_read`` (before every record read) and
``data_corrupt_record`` (before every parse), all with ``n=``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Dict, List, Optional, Tuple

ENV_SPEC = "GANSFORMER_TPU_FAULTS"
ENV_LEDGER = "GANSFORMER_TPU_FAULT_LEDGER"

ACTIONS = ("sigkill", "sigterm", "hang", "torn", "raise")


class FaultInjected(RuntimeError):
    """The ``raise`` action's exception."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    action: str
    point: str
    cond: Tuple[Tuple[str, float], ...] = ()

    @property
    def key(self) -> str:
        tail = ",".join(f"{k}={v:g}" for k, v in self.cond)
        return f"{self.action}@{self.point}" + (f":{tail}" if tail else "")

    def matches(self, coords: Dict[str, object]) -> bool:
        for k, v in self.cond:
            have = coords.get(k)
            if have is None:
                return False
            try:
                if float(have) < v:
                    return False
            except (TypeError, ValueError):
                return False
        return True


def parse_spec(s: str) -> FaultSpec:
    s = s.strip()
    action, sep, rest = s.partition("@")
    if not sep or not rest:
        raise ValueError(f"fault spec {s!r}: expected <action>@<point>"
                         f"[:k=v,...]")
    if action not in ACTIONS:
        raise ValueError(f"fault spec {s!r}: unknown action {action!r} "
                         f"(have {ACTIONS})")
    point, _, condstr = rest.partition(":")
    cond: List[Tuple[str, float]] = []
    if condstr:
        for kv in condstr.split(","):
            k, sep, v = kv.partition("=")
            if not sep:
                raise ValueError(f"fault spec {s!r}: condition {kv!r} is "
                                 f"not k=v")
            cond.append((k.strip(), float(v)))
    return FaultSpec(action=action, point=point, cond=tuple(cond))


def parse_specs(s: str) -> List[FaultSpec]:
    return [parse_spec(p) for p in _split_specs(s)]


def _split_specs(s: str) -> List[str]:
    """Split a comma-separated spec list — but a comma may also separate
    conditions inside one spec, so split only before ``action@`` heads."""
    parts, cur = [], ""
    for tok in s.split(","):
        if "@" in tok and cur:
            parts.append(cur)
            cur = tok
        else:
            cur = f"{cur},{tok}" if cur else tok
    if cur:
        parts.append(cur)
    return [p for p in (x.strip() for x in parts) if p]


# --- armed state -------------------------------------------------------------

# None = not yet initialized (first fire() reads the env); [] = armed
# with nothing (the cheap common case).
_ARMED: Optional[List[FaultSpec]] = None
_LEDGER: Optional[str] = None
_FIRED: set = set()


def arm(specs: List[FaultSpec], ledger_path: Optional[str] = None) -> None:
    global _ARMED, _LEDGER, _FIRED
    _ARMED = list(specs)
    _LEDGER = ledger_path
    _FIRED = set(_read_ledger(ledger_path))


def disarm() -> None:
    arm([], None)


def install_from_env(environ=None) -> None:
    env = os.environ if environ is None else environ
    spec = env.get(ENV_SPEC, "")
    arm(parse_specs(spec) if spec else [], env.get(ENV_LEDGER))


def _read_ledger(path: Optional[str]) -> List[str]:
    if not path or not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and "key" in rec:
                out.append(rec["key"])
    return out


def _record_fired(spec: FaultSpec, coords: Dict[str, object]) -> None:
    """Ledger line BEFORE the action runs (fsync'd: the action may be a
    SIGKILL) — the one-shot guarantee across process restarts."""
    _FIRED.add(spec.key)
    if not _LEDGER:
        return
    rec = {"key": spec.key, "point": spec.point, "time": time.time(),
           "pid": os.getpid(),
           "coords": {k: v for k, v in coords.items()
                      if isinstance(v, (int, float))}}
    with open(_LEDGER, "a") as f:
        f.write(json.dumps(rec) + "\n")
        f.flush()
        os.fsync(f.fileno())


def _execute(spec: FaultSpec, coords: Dict[str, object]) -> None:
    if spec.action == "sigkill":
        os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(30)  # SIGKILL is not synchronous; never proceed past it
    elif spec.action == "sigterm":
        os.kill(os.getpid(), signal.SIGTERM)
    elif spec.action == "hang":
        while True:    # only SIGKILL (the supervisor's) ends this thread
            time.sleep(1.0)
    elif spec.action == "torn":
        path = coords.get("path")
        if isinstance(path, str) and os.path.exists(path):
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(max(1, int(size * 0.6)))
    elif spec.action == "raise":
        raise FaultInjected(f"injected fault {spec.key} at {coords}")


def fire(point: str, **coords) -> None:
    """Fire any armed, not-yet-fired spec matching this point+coords.
    Called from production code at named boundaries; must stay O(armed
    specs) and allocation-free when nothing is armed."""
    global _ARMED
    if _ARMED is None:
        install_from_env()
    if not _ARMED:
        return
    for spec in _ARMED:
        if spec.point != point or spec.key in _FIRED:
            continue
        if not spec.matches(coords):
            continue
        _record_fired(spec, coords)
        _execute(spec, coords)
