"""Run supervisor: keeps a training run alive on preemptible capacity
(the port's copy of ``gansformer_tpu/supervise/supervisor.py``).

* runs training as a supervised child process;
* classifies every exit: ``clean`` (rc 0), ``preemption`` (the loop's
  ``EXIT_PREEMPTED`` after a graceful SIGTERM checkpoint, or a raw
  SIGTERM death), ``data-corrupt`` / ``data-stall`` (the typed data
  exits), ``crash`` (anything else, a SIGKILL's -9 included) and
  ``hang`` (no fresh heartbeat within the staleness budget, or step skew
  beyond bounds: the supervisor SIGTERMs, waits ``hang_kill_grace_s``,
  then SIGKILLs, since the loop's SIGTERM handler only sets a flag that
  a wedged loop never reads);
* resumes through ``--resume`` under bounded exponential backoff
  (progress resets the exponent) within a restart budget; a
  non-retryable cause (``data-corrupt``) gives up at once and spends no
  budget;
* appends every lifecycle event to ``supervisor_events.jsonl``
  (``supervise/events.py``) and exports the ``supervise/*`` family to
  ``supervisor.prom`` on a private registry; the doctor's availability
  section grades both.

The supervisor imports neither torch nor CUDA: it must not claim the
card its child needs, and it runs where only the standard library is.
Liveness comes from the heartbeat files the loop writes at every tick
(``obs/heartbeat.py``); the beats with ``phase`` ``setup`` (before the
first iteration) and ``finalize`` (before the final snapshot and
checkpoint) keep the startup grace.

A SIGTERM or SIGINT to the supervisor itself is forwarded to the child
as SIGTERM (its graceful-checkpoint window), the exit is recorded, and
the supervisor stops without restarting, exiting ``EXIT_PREEMPTED``;
backoff sleeps are sliced so the notice is honored within a poll
interval, and the signal handlers are restored on the way out.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional

from gansformer_tpu_torch.obs.heartbeat import read_heartbeats
from gansformer_tpu_torch.obs.registry import Registry, atomic_write_text
from gansformer_tpu_torch.supervise import events

SUPERVISOR_PROM = "supervisor.prom"


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    """Knobs for one supervised run (CLI flags map 1:1)."""

    max_restarts: int = 8
    backoff_base_s: float = 2.0
    backoff_max_s: float = 120.0
    poll_interval_s: float = 2.0
    # Hang detection: a child that HAS beaten must beat again within
    # heartbeat_max_age_s; one that has NEVER beaten gets startup_grace_s
    # (compiles happen before the first beat).  hang_kill_grace_s is the
    # SIGTERM→SIGKILL window once a hang verdict lands.
    heartbeat_max_age_s: float = 300.0
    startup_grace_s: float = 1800.0
    hang_kill_grace_s: float = 15.0
    # Grace the child is allowed for its preemption checkpoint when the
    # supervisor forwards a SIGTERM (exported to the child's env so the
    # loop bounds its shutdown to the same window).
    preempt_grace_s: float = 30.0
    max_step_skew: Optional[int] = None


def classify_exit(returncode: int, killed_for_hang: bool = False) -> str:
    """Exit-cause classification — the supervisor's one source of truth
    (and the unit-testable core of it)."""
    if killed_for_hang:
        return "hang"
    if returncode == 0:
        return "clean"
    if returncode == events.EXIT_PREEMPTED:
        return "preemption"        # graceful: checkpoint already on disk
    if returncode == events.EXIT_DATA_CORRUPT:
        return "data-corrupt"      # static data defect: non-retryable
    if returncode == events.EXIT_DATA_STALLED:
        return "data-stall"        # input pipeline stall: retry classified
    if returncode < 0 and -returncode == signal.SIGTERM:
        return "preemption"        # raw SIGTERM death: no final checkpoint
    return "crash"


def probe_hang(run_dir: str, child_start: float,
               cfg: SupervisorConfig,
               now: Optional[float] = None) -> Optional[str]:
    """Liveness verdict for a running child, or None while healthy.

    Only beats written SINCE this child started count — a stale file
    from the previous attempt must not convict the fresh one.  Until
    the first beat lands, ``startup_grace_s`` applies (compile time);
    after it, ``heartbeat_max_age_s`` — EXCEPT while the newest beat
    carries ``phase="setup"`` (written BEFORE the first-dispatch
    compiles) or ``phase="finalize"`` (written before the final
    snapshot + synchronous checkpoint): both windows legitimately go
    beat-less for longer than a tick, so they stay under the startup
    grace — or a cold-cache flagship compile / a slow final save would
    be killed as a hang.  With several fresh beats and
    ``max_step_skew`` set, a straggler process is also a hang verdict
    (the survivors are wedged in a collective against it)."""
    now = time.time() if now is None else now
    beats = read_heartbeats(run_dir)
    fresh = {i: r for i, r in beats.items()
             if float(r.get("time", 0.0)) >= child_start}
    if not fresh:
        if now - child_start > cfg.startup_grace_s:
            return (f"no heartbeat within the startup grace "
                    f"({cfg.startup_grace_s:.0f}s)")
        return None
    newest_rec = max(fresh.values(), key=lambda r: float(r["time"]))
    newest = float(newest_rec["time"])
    phase = newest_rec.get("phase")
    graced = phase in ("setup", "finalize")
    budget = (max(cfg.heartbeat_max_age_s, cfg.startup_grace_s)
              if graced else cfg.heartbeat_max_age_s)
    if now - newest > budget:
        return (f"heartbeat stale: last beat {now - newest:.0f}s ago "
                f"(budget {budget:.0f}s"
                + (f", {phase} phase" if graced else "") + ")")
    if cfg.max_step_skew is not None and len(fresh) > 1:
        steps = [int(r.get("step", 0)) for r in fresh.values()]
        skew = max(steps) - min(steps)
        if skew > cfg.max_step_skew:
            return (f"step skew {skew} > {cfg.max_step_skew} — a process "
                    f"is straggling the collectives")
    return None


def last_heartbeat_step(run_dir: str) -> int:
    beats = read_heartbeats(run_dir)
    return max((int(r.get("step", 0)) for r in beats.values()), default=0)


class _Telemetry:
    """supervise/* instruments on a PRIVATE registry (the supervisor may
    run in-process in tests — it must not fight the loop's process-global
    registry resets), exported to ``<run_dir>/supervisor.prom``."""

    def __init__(self, run_dir: str, cfg: SupervisorConfig):
        self.path = os.path.join(run_dir, SUPERVISOR_PROM)
        self.reg = Registry()
        # Materialize the whole family up front: the schema lint's
        # explicit-marker discipline — absence must mean "wiring rotted",
        # never "nothing happened yet".
        for c in ("restarts_total", "exits_total", "clean_exits_total",
                  "crashes_total", "preemptions_total", "hangs_total",
                  "data_corrupt_exits_total", "data_stall_exits_total"):
            self.reg.counter(f"supervise/{c}")
        self.reg.gauge("supervise/restart_budget_remaining").set(
            cfg.max_restarts)
        for g in ("availability_ratio", "uptime_s_total",
                  "downtime_s_total", "last_exit_code", "last_step"):
            self.reg.gauge(f"supervise/{g}")
        self.flush()

    def record_exit(self, cause: str, rc: int, step: int,
                    run_dir: str) -> None:
        self.reg.counter("supervise/exits_total").inc()
        name = {"clean": "clean_exits_total", "crash": "crashes_total",
                "preemption": "preemptions_total",
                "hang": "hangs_total",
                "data-corrupt": "data_corrupt_exits_total",
                "data-stall": "data_stall_exits_total"}[cause]
        self.reg.counter(f"supervise/{name}").inc()
        self.reg.gauge("supervise/last_exit_code").set(float(rc))
        self.reg.gauge("supervise/last_step").set(float(step))
        avail = events.availability(events.read_events(run_dir))
        self.reg.gauge("supervise/uptime_s_total").set(avail["uptime_s"])
        self.reg.gauge("supervise/downtime_s_total").set(
            avail["downtime_s"])
        if avail["ratio"] is not None:
            self.reg.gauge("supervise/availability_ratio").set(
                avail["ratio"])
        self.flush()

    def record_restart(self, budget_remaining: int) -> None:
        self.reg.counter("supervise/restarts_total").inc()
        self.reg.gauge("supervise/restart_budget_remaining").set(
            budget_remaining)
        self.flush()

    def flush(self) -> None:
        atomic_write_text(self.path, self.reg.export_text())


def supervise(build_argv: Callable[[bool, int], List[str]],
              run_dir: str,
              cfg: SupervisorConfig = SupervisorConfig(),
              child_env: Optional[Dict[str, str]] = None,
              log: Optional[Callable[[str], None]] = None) -> dict:
    """Supervise ``build_argv(resume, restart_index)`` until it exits
    clean, the restart budget runs out, or the supervisor itself is
    preempted.  Returns ``{ok, cause, restarts, exit_code, step}`` —
    ``exit_code`` is what the CLI should exit with."""
    log = log or (lambda m: print(f"[supervise] {m}", flush=True))
    os.makedirs(run_dir, exist_ok=True)
    tele = _Telemetry(run_dir, cfg)
    env = {**os.environ, **(child_env or {}),
           "GANSFORMER_TPU_SUPERVISED": "1",
           "GANSFORMER_TPU_PREEMPT_GRACE_S": str(cfg.preempt_grace_s)}

    shutdown = {"sig": None}
    proc_box: List[Optional[subprocess.Popen]] = [None]

    def _on_preempt(signum, frame):
        shutdown["sig"] = signum
        p = proc_box[0]
        if p is not None and p.poll() is None:
            try:
                p.send_signal(signal.SIGTERM)
            except OSError:
                pass

    old_handlers = {}
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, _on_preempt)
            except (ValueError, OSError):
                pass

    events.append_event(run_dir, "supervisor_start",
                        max_restarts=cfg.max_restarts)
    restarts = 0
    no_progress = 0
    prev_step = -1
    prev_exit_time: Optional[float] = None
    try:
        while True:
            if shutdown["sig"] is not None:
                # Preempted between children (backoff sleep): never
                # spawn into a dying allocation.
                log("supervisor preempted during backoff — not "
                    "restarting")
                events.append_event(run_dir, "supervisor_preempted",
                                    restarts=restarts,
                                    step=last_heartbeat_step(run_dir))
                return {"ok": False, "cause": "supervisor_preempted",
                        "restarts": restarts,
                        "step": last_heartbeat_step(run_dir),
                        "exit_code": events.EXIT_PREEMPTED}
            resume = os.path.isdir(os.path.join(run_dir, "checkpoints"))
            argv = build_argv(resume, restarts)
            t0 = time.time()
            downtime = (t0 - prev_exit_time) if prev_exit_time else 0.0
            events.append_event(run_dir, "start", restart_index=restarts,
                                resume=resume,
                                downtime_s=round(downtime, 3), argv=argv)
            log(f"start #{restarts}{' (resume)' if resume else ''}: "
                f"{' '.join(argv)}")
            proc = subprocess.Popen(argv, env=env)
            proc_box[0] = proc
            killed_for_hang = False
            hang_reason = None
            while True:
                rc = proc.poll()
                if rc is not None:
                    break
                if shutdown["sig"] is not None:
                    # Forward SIGTERM here too — the handler only
                    # reaches the child that was alive when the signal
                    # landed; a child spawned in the race window would
                    # otherwise never get its preemption notice.  Then
                    # give it the checkpoint grace, then insist.
                    try:
                        proc.send_signal(signal.SIGTERM)
                    except OSError:
                        pass
                    try:
                        proc.wait(cfg.preempt_grace_s
                                  + cfg.hang_kill_grace_s)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait()
                    rc = proc.returncode
                    break
                hang_reason = probe_hang(run_dir, t0, cfg)
                if hang_reason:
                    killed_for_hang = True
                    log(f"hang: {hang_reason}; SIGTERM, then SIGKILL "
                        f"after {cfg.hang_kill_grace_s:.0f}s")
                    proc.terminate()
                    try:
                        proc.wait(cfg.hang_kill_grace_s)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait()
                    rc = proc.returncode
                    break
                time.sleep(cfg.poll_interval_s)
            uptime = time.time() - t0
            cause = classify_exit(rc, killed_for_hang=killed_for_hang)
            step = last_heartbeat_step(run_dir)
            events.append_event(
                run_dir, "exit", cause=cause, exit_code=rc,
                uptime_s=round(uptime, 3), step=step,
                restart_index=restarts,
                **({"hang_reason": hang_reason} if hang_reason else {}))
            tele.record_exit(cause, rc, step, run_dir)
            log(f"exit rc={rc} cause={cause} after {uptime:.1f}s "
                f"(step {step})")
            prev_exit_time = time.time()

            if cause == "clean":
                events.append_event(run_dir, "complete",
                                    restarts=restarts, step=step)
                return {"ok": True, "cause": "clean",
                        "restarts": restarts, "step": step,
                        "exit_code": 0}
            if shutdown["sig"] is not None:
                log("supervisor preempted — not restarting")
                events.append_event(run_dir, "supervisor_preempted",
                                    restarts=restarts, step=step)
                return {"ok": False, "cause": "supervisor_preempted",
                        "restarts": restarts, "step": step,
                        "exit_code": events.EXIT_PREEMPTED}
            if cause in events.NON_RETRYABLE_CAUSES:
                # A restart cannot fix a static data defect: give up NOW
                # with the cause classified and the restart budget
                # untouched, never crash-loop on an unrecoverable cause.
                events.append_event(run_dir, "give_up",
                                    restarts=restarts, cause=cause,
                                    step=step, non_retryable=True)
                log(f"non-retryable exit cause {cause!r}; giving up "
                    f"without consuming the restart budget "
                    f"({restarts} restart(s) used)")
                return {"ok": False, "cause": cause,
                        "restarts": restarts, "step": step,
                        "exit_code": 1}
            if restarts >= cfg.max_restarts:
                events.append_event(run_dir, "give_up",
                                    restarts=restarts, cause=cause,
                                    step=step)
                log(f"restart budget exhausted "
                    f"({cfg.max_restarts}); giving up after {cause}")
                return {"ok": False, "cause": cause,
                        "restarts": restarts, "step": step,
                        "exit_code": 1}
            # Progress resets the backoff exponent: a run that advances
            # between preemptions restarts eagerly forever; only
            # back-to-back no-progress failures escalate.
            no_progress = 0 if step > prev_step else no_progress + 1
            prev_step = step
            delay = min(cfg.backoff_max_s,
                        cfg.backoff_base_s * (2 ** max(0,
                                                       no_progress - 1)))
            restarts += 1
            tele.record_restart(cfg.max_restarts - restarts)
            log(f"restart #{restarts}/{cfg.max_restarts} in "
                f"{delay:.1f}s (cause {cause})")
            # Sliced sleep: a preemption notice landing mid-backoff must
            # be honored within a poll interval, not after the full
            # (up to backoff_max_s) delay — the loop-top check then
            # stops the supervisor before it spawns anything.
            deadline = time.time() + delay
            while shutdown["sig"] is None:
                left = deadline - time.time()
                if left <= 0:
                    break
                time.sleep(min(cfg.poll_interval_s, left))
    finally:
        for sig, h in old_handlers.items():
            try:
                signal.signal(sig, h)
            except (ValueError, OSError):
                pass
