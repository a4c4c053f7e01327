"""The generation service: a continuous-batching request front end over
``ServePrograms`` (the counterpart of ``gansformer_tpu/serve/service.py``).

One dispatcher thread (``utils/background.LoopWorker``) runs
``_serve_dispatch``: pop what is queued (up to the largest bucket,
waiting ``max_fill_wait_ms`` after the first arrival for the batch to
fill), assemble the batch's w rows with ``serve.cache.map_rows`` (w cache
hits, one ``map_seeds`` dispatch for the misses), pad to the bucket by
repeating the last row, run ``synthesize`` with the request seeds as the
rows' noise tags, fetch, and fulfil the tickets.  The queue drains
whenever the device is free; a batch never waits for stragglers beyond
the fill wait, and a backlog is served in chunks of the largest bucket.

An image is a pure function of ``(seed, psi, noise_seed)``: row i's
noise comes from ``noise_seed(noise_seed, seed_i)`` (``serve/programs``),
and padding rows repeat the last real row and its tag, so no batch,
bucket or restart enters an image.

Robustness, as JAX's service has it:

* **Admission** is bounded (``max_queue_depth``): a submit past the bound
  raises ``Overloaded`` at once (``serve/shed_total``), after compacting
  cancelled and expired tickets out of the queue.
* **Deadlines** (``submit(deadline_s=…)`` or ``default_deadline_s``): an
  expired ticket is dropped at pop time, before dispatch, and fails with
  ``Expired`` (``serve/expired_total``).  A client whose
  ``result(timeout)`` ran out cancels its ticket, so the dispatcher skips
  that work (``serve/cancelled_total``).
* **A supervised dispatcher.**  A supervisor thread restarts a crashed
  dispatcher, or one hung on a batch for ``hang_after_s``, under a
  backoff that progress resets; the in-flight batch fails, nothing hangs.
  After ``max_dispatcher_restarts`` deaths in a row without a fulfilled
  batch between them the circuit breaker trips: queued tickets fail with
  ``ServiceUnhealthy``, submits are refused and ``health()`` is
  unhealthy.
* **Bucket quarantine**: ``quarantine_after`` failures in a row of one
  bucket's synthesis route later batches to the next larger bucket (the
  largest is never quarantined).
* **A graceful drain**: ``close()`` (and ``install_signal_drain``'s
  SIGTERM hook) stops admitting, serves the queue within the grace and
  fails what is left with ``ServiceClosed``; no thread leaks.
* **Fault points** (``supervise/faults.py``): ``serve_dispatch``,
  ``serve_map``, ``serve_fetch``, ``serve_fulfill``, with the monotonic
  ``batch`` number (and ``n``) as coordinates.

Telemetry: the ``serve/queue_depth``, ``serve/batch_fill``,
``serve/e2e_ms`` and ``serve/batch_ms`` histograms; the counters
``serve/requests_total``, ``images_total``, ``shed_total``,
``expired_total``, ``cancelled_total``, ``dispatcher_restarts_total``,
``bucket_quarantined_total``; the gauges ``serve/health_state`` (0 ready,
1 degraded, 2 unhealthy, 3 closed), ``dispatcher_alive``, ``queue_bound``,
``queue_depth_now`` and the worker's ``serve/dispatch_heartbeat``; all
created at construction.  With ``replica_id`` the liveness gauges move to
``serve/replica<i>/…`` (a fleet member).  Every ticket carries a request
ID and its lifecycle events (``obs/reqtrace``); ``Ticket._resolve`` is
the one funnel every outcome passes through.

Where torch differs from JAX here:

* **Thread-local state.**  ``torch.inference_mode()`` and the current
  CUDA device belong to a thread.  The dispatcher thread enters
  inference mode and sets the programs' device itself; otherwise every
  batch would record an autograd graph or run on another device.
* **Cold start.**  JAX's "cold" batch is one whose executable is not
  compiled yet; here it is a batch on the card before this process has
  loaded the kernel library (``ops/_build.loaded()``): without a warm
  start it pays the ``nvcc`` build (12.75–16.38 s on an H100).  Such a
  batch gets ``hang_startup_grace_s``, not ``hang_after_s``.
* **A hung dispatcher.**  A thread inside a CUDA call cannot be killed.
  The watchdog abandons it, as JAX's does, and bumps the generation, so
  the thread retires at its next pop; on the card the work it queued
  stays ahead of the replacement's on the same stream.
* **Rows through the host.**  ``map_rows`` brings an all-miss batch's
  mapped rows to the host for the cache before synthesis; JAX keeps them
  on the device and overlaps the copy.
"""

from __future__ import annotations

import signal
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Set

import numpy as np

from gansformer_tpu_torch.obs import registry as telemetry
from gansformer_tpu_torch.obs import reqtrace
from gansformer_tpu_torch.obs.spans import span
from gansformer_tpu_torch.serve.cache import WCache, map_rows
from gansformer_tpu_torch.supervise import faults
from gansformer_tpu_torch.utils.background import LoopWorker

HEALTH_READY, HEALTH_DEGRADED, HEALTH_UNHEALTHY, HEALTH_CLOSED = \
    0, 1, 2, 3
HEALTH_NAMES = {HEALTH_READY: "ready", HEALTH_DEGRADED: "degraded",
                HEALTH_UNHEALTHY: "unhealthy", HEALTH_CLOSED: "closed"}


class ServeError(RuntimeError):
    """Base of the typed serving outcomes; ``Ticket.result`` raises them
    unwrapped, so callers catch by class."""


class Overloaded(ServeError):
    """The admission queue is at its bound: the request was shed."""


class Expired(ServeError):
    """The request's deadline passed before dispatch."""


class Cancelled(ServeError):
    """The client abandoned the ticket (``cancel()`` or a result
    timeout)."""


class ServiceUnhealthy(ServeError):
    """The circuit breaker is open, or the dispatcher hung."""


class ServiceClosed(ServeError):
    """The service closed before this ticket could be served."""


class Ticket:
    """One submitted request; ``result()`` blocks until it resolves.

    States: ``pending``, then one of ``done`` (an image), ``failed`` (an
    error) or ``cancelled``.  A transition happens once: a late fulfil
    of a cancelled ticket is a no-op, so cancel and dispatch may race."""

    __slots__ = ("seed", "psi", "label", "t_submit", "t_done", "deadline",
                 "rid", "_event", "_image", "_error", "_state", "_lock")

    def __init__(self, seed: int, psi: float, label,
                 deadline_s: Optional[float] = None):
        self.seed = int(seed)
        self.psi = float(psi)
        self.label = label
        # the request ID and its "submitted" event (None while tracing
        # is disabled: every later emit is then a no-op)
        self.rid = reqtrace.get_reqtracer().begin(seed=int(seed),
                                                  psi=float(psi))
        self.t_submit = time.perf_counter()
        self.t_done: Optional[float] = None
        self.deadline = (None if deadline_s is None
                         else self.t_submit + float(deadline_s))
        self._event = threading.Event()
        self._image: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None
        self._state = "pending"
        self._lock = threading.Lock()

    @property
    def state(self) -> str:
        return self._state

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline is None:
            return False
        return (time.perf_counter() if now is None else now) > self.deadline

    def _resolve(self, state: str, image=None, error=None) -> bool:
        with self._lock:
            if self._state != "pending":
                return False
            self._state = state
            self._image, self._error = image, error
            self.t_done = time.perf_counter()
        rt = reqtrace.get_reqtracer()
        if state == "done":
            # the request ID rides the histogram's max as its exemplar
            telemetry.histogram("serve/e2e_ms").observe(
                (self.t_done - self.t_submit) * 1000.0, exemplar=self.rid)
            rt.event(self.rid, "fulfilled")
        elif state == "cancelled":
            rt.event(self.rid, "cancelled", cause="client_cancelled")
        elif isinstance(error, Expired):
            rt.event(self.rid, "expired", cause="deadline")
        else:
            rt.event(self.rid, "failed",
                     cause=(type(error).__name__
                            if error is not None else None))
        self._event.set()
        return True

    def _fulfill(self, image: np.ndarray) -> bool:
        return self._resolve("done", image=image)

    def _fail(self, err: BaseException) -> bool:
        return self._resolve("failed", error=err)

    def cancel(self) -> bool:
        """Abandon the request (skipped at pop time).  False when the
        ticket had already resolved."""
        return self._resolve(
            "cancelled",
            error=Cancelled(f"request (seed={self.seed}) cancelled"))

    @property
    def latency_ms(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return (self.t_done - self.t_submit) * 1000.0

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """The image [R, R, C] fp32.  A timeout cancels the ticket (the
        dispatcher then skips it) and raises ``TimeoutError``, unless the
        ticket resolved in the meantime: then its outcome stands."""
        if not self._event.wait(timeout):
            if self.cancel():
                raise TimeoutError(
                    f"request (seed={self.seed}) not served in "
                    f"{timeout}s")
            self._event.wait(1.0)   # _resolve sets the event next
        if self._error is not None:
            if isinstance(self._error, ServeError):
                raise self._error
            raise RuntimeError("generation request failed") from self._error
        return self._image


class GenerationService:
    """A continuous-batching queue in front of a ``ServePrograms``, with
    bounded admission, deadlines, a supervised dispatcher, health states
    and a graceful drain."""

    def __init__(self, programs, max_fill_wait_ms: float = 2.0,
                 wcache_capacity: int = 4096, noise_seed: int = 0,
                 max_queue_depth: int = 256,
                 default_deadline_s: Optional[float] = None,
                 max_dispatcher_restarts: int = 3,
                 restart_backoff_base_s: float = 0.05,
                 restart_backoff_max_s: float = 2.0,
                 hang_after_s: Optional[float] = 300.0,
                 hang_startup_grace_s: float = 1800.0,
                 quarantine_after: int = 2,
                 replica_id: Optional[int] = None):
        if max_queue_depth < 1:
            raise ValueError(f"max_queue_depth must be >= 1, got "
                             f"{max_queue_depth}")
        # A fleet member's liveness gauges live under serve/replica<i>/;
        # counters and histograms stay global (they sum over members).
        self.replica_id = replica_id
        if replica_id is None:
            self._g = lambda name: name
        else:
            pfx = f"serve/replica{int(replica_id)}/"
            self._g = lambda name: pfx + name[len("serve/"):]
        self.programs = programs
        self._max_bucket = programs.buckets[-1]
        self._fill_wait_s = max(0.0, max_fill_wait_ms) / 1000.0
        self.wcache = WCache(wcache_capacity)
        self._noise_seed = int(noise_seed)
        self._batches = 0
        self._pending: "deque[Ticket]" = deque()
        self._cv = threading.Condition()
        self._stop = False
        self._drain_failed = False
        self._tripped = False
        self._trip_cause: Optional[BaseException] = None
        self._max_queue_depth = int(max_queue_depth)
        self._default_deadline_s = default_deadline_s
        self._max_restarts = int(max_dispatcher_restarts)
        self._backoff_base_s = float(restart_backoff_base_s)
        self._backoff_max_s = float(restart_backoff_max_s)
        self._hang_after_s = hang_after_s
        self._hang_startup_grace_s = float(hang_startup_grace_s)
        self._quarantine_after = int(quarantine_after)
        self._quarantined: Set[int] = set()
        self._bucket_fails: Dict[int, int] = {}
        self._restarts = 0
        self._deaths_in_row = 0
        self._fulfilled = 0
        self._fulfilled_at_restart = 0
        self._inflight: List[Ticket] = []
        self._busy_since: Optional[float] = None
        self._busy_cold = False     # the current batch loads the library
        self._poll_s = 0.05
        # Bumped (under _cv) at every restart and breaker trip: a worker
        # abandoned as hung that wakes later retires at its next pop.
        self._gen = 0
        # every family exists from the start, so an idle service exports
        # explicit zeros
        for name in ("serve/queue_depth", "serve/batch_fill",
                     "serve/e2e_ms", "serve/batch_ms"):
            telemetry.histogram(name)
        for name in ("serve/requests_total", "serve/images_total",
                     "serve/shed_total", "serve/expired_total",
                     "serve/cancelled_total",
                     "serve/dispatcher_restarts_total",
                     "serve/bucket_quarantined_total",
                     "reqtrace/requests_total", "reqtrace/events_total",
                     "reqtrace/terminal_total", "reqtrace/dropped_total",
                     "reqtrace/ledger_rows_total",
                     "reqtrace/ledger_dropped_total"):
            telemetry.counter(name)
        telemetry.gauge("reqtrace/enabled").set(
            1.0 if reqtrace.get_reqtracer().enabled else 0.0)
        if replica_id is not None:
            telemetry.counter(self._g("serve/images_total"))
            telemetry.histogram(self._g("serve/batch_ms"))
            telemetry.histogram(self._g("serve/batch_fill"))
        telemetry.gauge(self._g("serve/queue_bound")).set(
            self._max_queue_depth)
        telemetry.gauge(self._g("serve/health_state")).set(HEALTH_READY)
        telemetry.gauge(self._g("serve/queue_depth_now")).set(0)
        self._worker = LoopWorker(self._serve_dispatch,
                                  "serve/dispatch").start()
        telemetry.gauge(self._g("serve/dispatcher_alive")).set(1)
        self._monitor = threading.Thread(target=self._supervise_dispatch,
                                         name="serve-supervisor",
                                         daemon=True)
        self._monitor.start()

    # -- producer side -------------------------------------------------------

    def submit(self, seed: int, psi: float = 0.7, label=None,
               deadline_s: Optional[float] = None) -> Ticket:
        """Admit one request.  Refusals are typed: ``ServiceClosed``
        (closed or draining), ``ServiceUnhealthy`` (breaker open),
        ``Overloaded`` (queue at its bound; ``serve/shed_total``)."""
        t = Ticket(seed, psi, label,
                   deadline_s if deadline_s is not None
                   else self._default_deadline_s)
        shed = False
        rt = reqtrace.get_reqtracer()
        dropped: List[Ticket] = []
        with self._cv:
            if self._stop:
                rt.event(t.rid, "failed", cause="ServiceClosed")
                raise ServiceClosed("service is closed")
            if self._tripped:
                rt.event(t.rid, "failed", cause="ServiceUnhealthy")
                raise ServiceUnhealthy(
                    f"circuit breaker open after {self._restarts} "
                    f"dispatcher restart(s): "
                    f"{self._trip_cause}") from self._trip_cause
            if len(self._pending) >= self._max_queue_depth:
                # slots held by dead tickets (cancelled, expired) must
                # not shed live traffic
                now = time.perf_counter()
                keep: "deque[Ticket]" = deque()
                for t2 in self._pending:
                    if t2.state == "cancelled" or t2.expired(now):
                        dropped.append(t2)
                    else:
                        keep.append(t2)
                self._pending = keep
            if len(self._pending) >= self._max_queue_depth:
                shed = True
            else:
                self._pending.append(t)
                rt.event(t.rid, "admitted", depth=len(self._pending))
                telemetry.gauge(self._g("serve/queue_depth_now")).set(
                    len(self._pending))
                self._cv.notify()
        self._settle_dropped(dropped)
        if shed:
            telemetry.counter("serve/shed_total").inc()
            rt.event(t.rid, "shed", cause="overloaded")
            raise Overloaded(
                f"admission queue at its bound "
                f"({self._max_queue_depth}) — request shed")
        telemetry.counter("serve/requests_total").inc()
        return t

    def _settle_dropped(self, dropped: List[Ticket]) -> None:
        """Count (and fail, if expired) tickets dropped before dispatch."""
        for t in dropped:
            if t.state == "cancelled":
                telemetry.counter("serve/cancelled_total").inc()
            else:
                telemetry.counter("serve/expired_total").inc()
                t._fail(Expired(
                    f"request (seed={t.seed}) deadline passed "
                    f"before dispatch"))

    def load(self) -> int:
        """Queued and in-flight tickets (a router's signal)."""
        with self._cv:
            return len(self._pending) + len(self._inflight)

    def accepting(self) -> bool:
        """Whether ``submit`` would not refuse outright (not closed, the
        breaker closed); a full queue is not checked."""
        with self._cv:
            return not self._stop and not self._tripped

    def health(self) -> dict:
        """``ready`` / ``degraded`` / ``unhealthy`` / ``closed`` with the
        reasons, also set as the ``serve/health_state`` gauge."""
        with self._cv:
            depth = len(self._pending)
            stop, tripped = self._stop, self._tripped
            restarts = self._restarts
            quarantined = sorted(self._quarantined)
        alive = self._worker.alive
        reasons: List[str] = []
        if tripped:
            state = HEALTH_UNHEALTHY
            reasons.append(f"circuit breaker open after {restarts} "
                           f"dispatcher restart(s)")
        elif stop and self._drain_failed:
            state = HEALTH_UNHEALTHY
            reasons.append("drain failed: tickets were still "
                           "queued/in-flight past the grace window")
        elif stop:
            state = HEALTH_CLOSED
            reasons.append("service closed/draining")
        else:
            state = HEALTH_READY
            if depth >= self._max_queue_depth:
                reasons.append(f"admission queue saturated "
                               f"({depth}/{self._max_queue_depth})")
            if restarts > 0:
                reasons.append(f"dispatcher restarted {restarts} time(s) "
                               f"(budget {self._max_restarts})")
            if not alive:
                reasons.append("dispatcher down (restart pending)")
            if quarantined:
                reasons.append(f"bucket(s) {quarantined} quarantined")
            stale = getattr(self.programs, "manifest_stale", 0)
            hits = getattr(self.programs, "warm_hits", 0)
            if stale + hits > 0 and stale / (stale + hits) > 0.5:
                reasons.append(
                    f"warm-start fallback rate "
                    f"{stale / (stale + hits):.0%} — the manifest is "
                    f"mostly stale (building at serve time)")
            if reasons:
                state = HEALTH_DEGRADED
        telemetry.gauge(self._g("serve/health_state")).set(state)
        telemetry.gauge(self._g("serve/queue_depth_now")).set(depth)
        return {"state": HEALTH_NAMES[state], "state_code": state,
                "replica_id": self.replica_id,
                "reasons": reasons, "queue_depth": depth,
                "queue_bound": self._max_queue_depth,
                "dispatcher_alive": alive,
                "dispatcher_restarts": restarts,
                "quarantined_buckets": quarantined,
                "shed_total": telemetry.counter("serve/shed_total").value,
                "expired_total":
                    telemetry.counter("serve/expired_total").value,
                "cancelled_total":
                    telemetry.counter("serve/cancelled_total").value}

    def install_signal_drain(self, grace_s: float = 30.0) -> bool:
        """SIGTERM → ``close(grace_s)`` on a thread of its own.  Only the
        main thread may install a signal handler: returns whether it was
        installed."""
        if threading.current_thread() is not threading.main_thread():
            return False

        def _on_term(signum, frame):
            # the handler may interrupt this thread inside _cv (a
            # submit): close() inline would deadlock on it
            threading.Thread(target=self.close,
                             kwargs={"timeout": grace_s},
                             name="serve-sigterm-drain",
                             daemon=True).start()

        try:
            signal.signal(signal.SIGTERM, _on_term)
        except (ValueError, OSError):
            return False
        return True

    def close(self, timeout: float = 30.0) -> None:
        """Stop admitting, serve the queue within ``timeout``, then fail
        every leftover, queued or in flight, with ``ServiceClosed``."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        try:
            deadline = time.monotonic() + max(0.0, timeout)
            self._monitor.join(timeout)
            self._worker.join(max(0.0, deadline - time.monotonic()))
        finally:
            with self._cv:
                leftovers = list(self._pending)
                self._pending.clear()
                telemetry.gauge(self._g("serve/queue_depth_now")).set(0)
            now = time.perf_counter()
            self._settle_dropped([t for t in leftovers
                                  if t.state == "cancelled"
                                  or t.expired(now)])
            failed = 0
            for t in leftovers:
                failed += t._fail(ServiceClosed(
                    "service closed with request queued"))
            if self._worker.alive:
                # wedged past the grace: its batch fails below, so its
                # generation is superseded
                with self._cv:
                    self._gen += 1
                    self._cv.notify_all()
            failed += self._fail_inflight(ServiceClosed(
                "service closed mid-batch (dispatcher did not drain "
                "within the grace window)"))
            telemetry.gauge(self._g("serve/dispatcher_alive")).set(
                1.0 if self._worker.alive else 0.0)
            if failed:
                self._drain_failed = True
                telemetry.gauge(self._g("serve/health_state")).set(
                    HEALTH_UNHEALTHY)
            elif not self._tripped:
                telemetry.gauge(self._g("serve/health_state")).set(
                    HEALTH_CLOSED)

    def __enter__(self) -> "GenerationService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- dispatcher supervision (monitor thread) -----------------------------

    def _fail_inflight(self, err: BaseException) -> int:
        """Fail what the dispatcher popped and did not fulfil."""
        with self._cv:
            batch = list(self._inflight)
            self._inflight = []
        failed = 0
        for t in batch:
            if t._fail(err):
                failed += 1
            elif t.state == "cancelled":
                telemetry.counter("serve/cancelled_total").inc()
        return failed

    def _trip_breaker(self, cause: BaseException) -> None:
        with self._cv:
            self._tripped = True
            self._trip_cause = cause
            self._gen += 1
            leftovers = list(self._pending)
            self._pending.clear()
            telemetry.gauge(self._g("serve/queue_depth_now")).set(0)
            self._cv.notify_all()
        now = time.perf_counter()
        self._settle_dropped([t for t in leftovers
                              if t.state == "cancelled" or t.expired(now)])
        for t in leftovers:
            t._fail(ServiceUnhealthy(
                f"circuit breaker open after {self._restarts} dispatcher "
                f"restart(s): {cause}"))
        telemetry.gauge(self._g("serve/health_state")).set(HEALTH_UNHEALTHY)
        telemetry.gauge(self._g("serve/dispatcher_alive")).set(0)

    def _supervise_dispatch(self) -> None:
        """Wait for the dispatcher to die (a crash, or a batch busy past
        its budget), fail its in-flight tickets and restart it under
        backoff; too many deaths in a row trip the breaker."""
        while True:
            worker = self._worker
            hung = False
            while True:
                worker.join(self._poll_s)
                if not worker.alive:
                    break
                busy = self._busy_since
                # before the first fulfilled batch, and for a batch that
                # loads the kernel library, the startup grace applies
                cold = self._fulfilled == 0 or self._busy_cold
                budget = (max(self._hang_after_s or 0.0,
                              self._hang_startup_grace_s)
                          if cold else self._hang_after_s)
                if self._hang_after_s is not None and busy is not None \
                        and time.monotonic() - busy > budget:
                    hung = True
                    break
            if hung:
                err: BaseException = ServiceUnhealthy(
                    f"dispatcher hung: one batch busy for more than "
                    f"{self._hang_after_s:.0f}s — abandoning the thread")
            else:
                err = worker.error
                if err is None:
                    return           # a clean exit: the drain completed
            with self._cv:
                # supersede the generation before failing its batch
                self._gen += 1
                self._cv.notify_all()
            self._fail_inflight(err)
            with self._cv:
                self._busy_since = None
                self._busy_cold = False
            telemetry.gauge(self._g("serve/dispatcher_alive")).set(0)
            # progress (a fulfilled batch since the last death) resets
            # the count; every death counts itself
            progress = self._fulfilled > self._fulfilled_at_restart
            self._deaths_in_row = 1 if progress \
                else self._deaths_in_row + 1
            self._fulfilled_at_restart = self._fulfilled
            if self._deaths_in_row > self._max_restarts:
                self._trip_breaker(err)
                return
            delay = min(self._backoff_max_s,
                        self._backoff_base_s
                        * (2 ** (self._deaths_in_row - 1)))
            deadline = time.monotonic() + delay
            while time.monotonic() < deadline:
                with self._cv:
                    if self._stop and not self._pending:
                        return   # nothing left to drain: stay down
                time.sleep(min(self._poll_s,
                               max(0.0, deadline - time.monotonic())))
            with self._cv:
                self._restarts += 1
            telemetry.counter("serve/dispatcher_restarts_total").inc()
            self._worker = LoopWorker(self._serve_dispatch,
                                      "serve/dispatch").start()
            telemetry.gauge(self._g("serve/dispatcher_alive")).set(1)
            telemetry.gauge(self._g("serve/health_state")).set(
                HEALTH_DEGRADED)

    # -- consumer side (dispatcher thread) -----------------------------------

    def _select_bucket(self, n: int) -> int:
        """The smallest bucket >= n that is not quarantined; the largest
        is the route of last resort."""
        for b in self.programs.buckets:
            if b >= n and b not in self._quarantined:
                return b
        return self._max_bucket

    def _note_bucket_failure(self, bucket: int) -> None:
        with self._cv:
            fails = self._bucket_fails.get(bucket, 0) + 1
            self._bucket_fails[bucket] = fails
            quarantine = (fails >= self._quarantine_after
                          and bucket != self._max_bucket
                          and bucket not in self._quarantined)
            if quarantine:
                self._quarantined.add(bucket)
        if quarantine:
            telemetry.counter("serve/bucket_quarantined_total").inc()

    def _pop_batch(self, gen: int) -> Optional[List[Ticket]]:
        """Up to a largest bucket of live queued tickets; None once
        stopped and drained, or when this generation was superseded.
        Cancelled and expired tickets are dropped here, before dispatch.
        After the first arrival, waits up to ``max_fill_wait_ms`` for the
        batch to fill."""
        while True:
            with self._cv:
                while not self._pending and not self._stop and \
                        gen == self._gen:
                    self._cv.wait(0.25)
                if gen != self._gen:
                    return None            # superseded after a hang
                if not self._pending:
                    return None            # stopped and drained
                if self._fill_wait_s > 0 and \
                        len(self._pending) < self._max_bucket:
                    deadline = time.monotonic() + self._fill_wait_s
                    while len(self._pending) < self._max_bucket and \
                            not self._stop and gen == self._gen:
                        left = deadline - time.monotonic()
                        if left <= 0:
                            break
                        self._cv.wait(left)
                    if gen != self._gen:
                        return None
                depth = len(self._pending)
                batch: List[Ticket] = []
                dropped: List[Ticket] = []
                now = time.perf_counter()
                while self._pending and len(batch) < self._max_bucket:
                    t = self._pending.popleft()
                    if t.state == "cancelled" or t.expired(now):
                        dropped.append(t)
                    else:
                        batch.append(t)
                telemetry.histogram("serve/queue_depth").observe(depth)
                telemetry.gauge(self._g("serve/queue_depth_now")).set(
                    len(self._pending))
                if batch:
                    self._inflight = list(batch)
                    self._busy_since = time.monotonic()
            self._settle_dropped(dropped)
            if batch:
                rt = reqtrace.get_reqtracer()
                for t in batch:
                    rt.event(t.rid, "popped", depth=depth)
                return batch

    def _finish_batch(self, gen: int) -> None:
        with self._cv:
            if gen == self._gen:
                self._inflight = []
                self._busy_since = None
                self._busy_cold = False

    def _library_cold(self) -> bool:
        """Whether a batch now would load (or build) the kernel library."""
        if self.programs.device.type != "cuda":
            return False
        from gansformer_tpu_torch.ops import _build

        return not _build.loaded()

    def _serve_dispatch(self) -> None:
        """The dispatch loop; the device is read only inside
        ``span("serve_fetch")``."""
        import torch

        programs, cache = self.programs, self.wcache
        rt = reqtrace.get_reqtracer()
        gen = self._gen
        if programs.device.type == "cuda":
            torch.cuda.set_device(programs.device)
        with torch.inference_mode():
            while True:
                batch = self._pop_batch(gen)
                if batch is None:
                    return
                self._dispatch_batch(batch, gen, programs, cache, rt)

    def _dispatch_batch(self, batch, gen, programs, cache, rt) -> None:
        import torch

        self._worker.beat()
        t0 = time.perf_counter()
        # the bucket whose program is running, for quarantine (the
        # mapping bucket while map_seeds runs)
        fail_bucket = None
        try:
            n = len(batch)
            self._batches += 1
            faults.fire("serve_dispatch", batch=self._batches, n=n)
            bucket = self._select_bucket(n)
            fail_bucket = bucket
            telemetry.histogram("serve/batch_fill").observe(n / bucket)
            for t in batch:
                rt.event(t.rid, "batched", batch=self._batches,
                         bucket=bucket)
            with self._cv:
                # published under _cv: the supervisor reads it with
                # _busy_since as a pair
                self._busy_cold = self._library_cold()
            map_bucket = None

            def hits(miss: List[int]) -> None:
                for i in sorted(set(range(n)) - set(miss)):
                    rt.event(batch[i].rid, "wcache_hit")

            def on_map(miss: List[int], mb: int) -> None:
                nonlocal fail_bucket, map_bucket
                hits(miss)
                faults.fire("serve_map", batch=self._batches, n=len(miss))
                fail_bucket = map_bucket = mb
                for i in miss:
                    rt.event(batch[i].rid, "map_dispatch", bucket=mb)

            labels = (None if not programs.bundle.cfg.label_dim else
                      np.stack([np.asarray(t.label, np.float32)
                                for t in batch]))
            ws = map_rows(programs, cache, [t.seed for t in batch],
                          labels, on_map=on_map,
                          select_bucket=self._select_bucket)
            if map_bucket is None:
                hits([])                  # every row was a hit
            fail_bucket = bucket          # the mapping ran
            if bucket > n:
                ws = torch.cat([ws, ws[-1:].expand(bucket - n,
                                                   *ws.shape[1:])])
            psi = [t.psi for t in batch] + [1.0] * (bucket - n)
            # the request seed is the row's noise tag; padding repeats
            # the last real one, as it repeats the last real row
            tags = [t.seed for t in batch] + [batch[-1].seed] * (bucket - n)
            out = programs.synthesize(ws, psi, seed=self._noise_seed,
                                      tags=tags)
            for t in batch:
                rt.event(t.rid, "synth", bucket=bucket)
            with span("serve_fetch"):
                faults.fire("serve_fetch", batch=self._batches)
                imgs = out[:n].float().cpu().numpy()
            for t in batch:
                rt.event(t.rid, "fetch")
            if gen != self._gen:
                # superseded mid-batch: the supervisor failed these
                return
            faults.fire("serve_fulfill", batch=self._batches, n=n)
            delivered = 0
            for i, t in enumerate(batch):
                if t._fulfill(imgs[i]):
                    delivered += 1
                elif t.state == "cancelled":
                    telemetry.counter("serve/cancelled_total").inc()
            with self._cv:
                self._fulfilled += 1
                # this batch proved the programs it ran
                self._bucket_fails.pop(bucket, None)
                if map_bucket is not None:
                    self._bucket_fails.pop(map_bucket, None)
            telemetry.counter("serve/images_total").inc(delivered)
            batch_s = time.perf_counter() - t0
            telemetry.histogram("serve/batch_ms").observe(
                batch_s * 1000.0, exemplar=batch[0].rid)
            if self.replica_id is not None:
                telemetry.counter(
                    self._g("serve/images_total")).inc(delivered)
                telemetry.histogram(
                    self._g("serve/batch_ms")).observe(batch_s * 1000.0)
                telemetry.histogram(
                    self._g("serve/batch_fill")).observe(n / bucket)
            rt.batch_span(self._batches, bucket, [t.rid for t in batch],
                          t0, batch_s)
            self._finish_batch(gen)
        except BaseException as e:
            # a superseded worker charges no bucket: its verdict belongs
            # to a dead generation
            if fail_bucket is not None and gen == self._gen:
                self._note_bucket_failure(fail_bucket)
            for t in batch:
                if not t._fail(e) and t.state == "cancelled":
                    telemetry.counter("serve/cancelled_total").inc()
            self._finish_batch(gen)
            raise   # the LoopWorker keeps it; the supervisor restarts
