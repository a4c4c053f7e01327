"""Single-slot background writers (the port's copy of
``gansformer_tpu/utils/background.py``).

Checkpoint writes and image snapshots move off the loop thread onto a
writer thread with bounded buffering: one job in flight (a submit while
busy joins the previous job first), failures stored and re-raised
(wrapped in ``BackgroundWriteError``) at the next ``poll()`` /
``submit()`` / ``wait()`` (the loop polls every tick), and bounded joins
(``wait(timeout=...)``) so a wedged writer cannot eat a preemption's
grace window.  ``LoopWorker`` is the same contract for a continuous
loop.  Telemetry per ``prefix``: ``<prefix>_inflight``,
``<prefix>_total``, ``<prefix>_errors_total``, ``<prefix>_write_ms``
and ``<prefix>_writer_heartbeat``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class BackgroundWriteError(RuntimeError):
    """A background writer job failed; ``__cause__`` is the original."""


class LoopWorker:
    """A long-lived background loop thread with the writer discipline.

    ``SingleSlotWriter`` owns one-shot jobs; this owns a CONTINUOUS
    loop (a serving dispatch loop) under the same
    failure contract: the target runs once on its own thread (the
    target body is the ``while``), an escaped exception is stored
    STICKY — readable un-wrapped via ``error`` (how the serving
    supervisor classifies a death before restarting a replacement
    worker) or re-raised wrapped in
    ``BackgroundWriteError`` at EVERY later ``poll()``.  Unlike
    ``SingleSlotWriter`` (one-shot jobs, error delivered once then
    cleared), a dead continuous loop never becomes healthy again —
    one ``LoopWorker`` is one dispatcher lifetime; recovery means a
    NEW worker, never a cleared error.  Telemetry, per ``prefix``:
    ``<prefix>_heartbeat`` gauge (last liveness touch — call
    ``beat()`` from inside the loop), ``<prefix>_errors_total``.
    """

    def __init__(self, target: Callable[[], None], prefix: str):
        self.prefix = prefix
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._run, args=(target,), name=f"{prefix}-loop",
            daemon=True)

    def _inst(self, kind: str, suffix: str):
        from gansformer_tpu_torch.obs import registry as telemetry

        return getattr(telemetry, kind)(f"{self.prefix}{suffix}")

    def start(self) -> "LoopWorker":
        self._inst("gauge", "_heartbeat").set(time.time())
        self._thread.start()
        return self

    def beat(self) -> None:
        """Liveness touch — the loop body calls this per iteration so a
        wedged dispatch is visible from telemetry.prom."""
        self._inst("gauge", "_heartbeat").set(time.time())

    def poll(self) -> None:
        """Re-raise a loop crash — sticky forever: the loop is dead, so
        every caller from now on must see it, not just the first."""
        with self._lock:
            err = self._error
        if err is not None:
            raise BackgroundWriteError(
                f"{self.prefix} background loop died: "
                f"{type(err).__name__}: {err}") from err

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)

    def wait(self, reraise: bool = True,
             timeout: Optional[float] = None) -> bool:
        """Bounded join + optional error delivery.  Returns False when
        the loop thread is still running after ``timeout`` — a wedged
        dispatch must not block a preemption shutdown past its grace
        window (the thread is a daemon; abandoning it is safe)."""
        self._thread.join(timeout)
        if reraise:
            self.poll()
        return not self._thread.is_alive()

    def close(self, timeout: Optional[float] = None) -> bool:
        """Shutdown-path join: never raises (the sticky error stays for
        ``poll``), just reports whether the thread ended in time."""
        return self.wait(reraise=False, timeout=timeout)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    @property
    def error(self) -> Optional[BaseException]:
        """The stored loop crash, un-raised and un-wrapped — for a
        SUPERVISOR deciding restart-vs-trip, where
        ``poll()``'s raise-on-read contract is the wrong shape."""
        with self._lock:
            return self._error

    def _run(self, target: Callable[[], None]) -> None:
        try:
            target()
        except BaseException as e:  # noqa: BLE001 — re-raised via poll()
            with self._lock:
                self._error = e
            self._inst("counter", "_errors_total").inc()
        finally:
            self._inst("gauge", "_heartbeat").set(time.time())


class SingleSlotWriter:
    """Bounded (depth-1) background executor for writeback jobs."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._error_job: Optional[str] = None
        self._lock = threading.Lock()

    def _inst(self, kind: str, suffix: str):
        # Instruments are resolved PER CALL, not cached at construction:
        # writers outlive a single train() run (checkpoint.py keys them by
        # directory), and the loop resets the registry at run start — a
        # cached Gauge would silently update an orphaned instrument.
        from gansformer_tpu_torch.obs import registry as telemetry

        return getattr(telemetry, kind)(f"{self.prefix}{suffix}")

    # -- consumer-side API (loop thread) ------------------------------------

    def submit(self, job: Callable[[], None], label: str = "") -> None:
        """Run ``job()`` on the writer thread.  Joins any in-flight job
        first (single slot = bounded backpressure) and raises a prior
        failure rather than burying it under new work."""
        self.wait()                     # join + re-raise sticky error
        with self._lock:
            self._inst("gauge", "_inflight").set(1)
            self._inst("gauge", "_writer_heartbeat").set(time.time())
            self._thread = threading.Thread(
                target=self._run, args=(job, label),
                name=f"{self.prefix}-writer", daemon=True)
            self._thread.start()

    def poll(self) -> None:
        """Re-raise a failed job's exception (tick-boundary check).
        Non-blocking; a still-running job is not an error.  The error is
        delivered ONCE and then cleared — a ``--resume`` reusing the same
        writer (checkpoint.py keys writers by directory) starts clean
        instead of tripping over the crash it is recovering from."""
        with self._lock:
            err, job = self._error, self._error_job
            self._error = self._error_job = None
        if err is not None:
            raise BackgroundWriteError(
                f"{self.prefix} background write"
                f"{f' ({job})' if job else ''} failed: "
                f"{type(err).__name__}: {err}") from err

    def wait(self, reraise: bool = True,
             timeout: Optional[float] = None) -> bool:
        """Join the in-flight job (if any); optionally re-raise failures.
        ``reraise=False`` is for ``finally`` blocks where a writer error
        must not mask the exception already unwinding.  ``timeout``
        bounds the join (preemption shutdown: a wedged writer must not
        eat the grace window); returns False when the job is still
        running after it — the sticky-error contract is untouched (an
        already-stored failure is still delivered when ``reraise``, and
        a failure that lands later surfaces at the next poll/wait)."""
        t = self._thread
        joined = True
        if t is not None:
            t.join(timeout)
            joined = not t.is_alive()
        if reraise:
            self.poll()
        return joined

    def close(self, timeout: Optional[float] = None) -> bool:
        """Shutdown-path join: never raises; reports whether the writer
        drained in time (daemon thread — abandoning it is safe)."""
        return self.wait(reraise=False, timeout=timeout)

    def clear_error(self) -> None:
        """Drop an undelivered sticky error WITHOUT raising it.  For run
        starts only: a writer cached across train() runs (checkpoint.py
        keys them by directory) may hold a failure from a previous run
        that aborted before its tick-boundary poll — the new run must
        not crash on it (the error was that run's secondary diagnostics;
        its ``_errors_total`` count remains)."""
        with self._lock:
            self._error = self._error_job = None

    @property
    def busy(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    # -- writer thread -------------------------------------------------------

    def _run(self, job: Callable[[], None], label: str) -> None:
        t0 = time.perf_counter()
        try:
            job()
            self._inst("counter", "_total").inc()
        except BaseException as e:  # noqa: BLE001 — re-raised via poll()
            with self._lock:
                self._error = e
                self._error_job = label
            self._inst("counter", "_errors_total").inc()
        finally:
            self._inst("histogram", "_write_ms").observe(
                (time.perf_counter() - t0) * 1000.0)
            self._inst("gauge", "_writer_heartbeat").set(time.time())
            self._inst("gauge", "_inflight").set(0)
