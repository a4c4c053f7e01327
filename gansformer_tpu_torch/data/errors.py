"""Typed data failures (the port's copy of
``gansformer_tpu/data/errors.py``).

* ``DataCorrupt``: more than ``DataConfig.max_corrupt_frac`` of the
  records are quarantined, a static defect of the data on disk; the
  train CLI exits with ``EXIT_DATA_CORRUPT`` and a supervisor does not
  retry it.
* ``DataStalled``: the input producer made no progress for
  ``DataConfig.stall_after_s`` while the loop waited; the CLI exits
  with ``EXIT_DATA_STALLED``, which stays retryable.

``stall_guarded_get`` is the one stall rule the prefetch layer wraps
its queue pops in.
"""

from __future__ import annotations

import queue
import time
from typing import Callable


class DataError(RuntimeError):
    """Base of the typed data-plane failures."""


class DataCorrupt(DataError):
    """Corruption budget exhausted — a static, non-retryable data defect."""


class DataStalled(DataError):
    """The data producer made no progress within the stall budget."""


def stall_guarded_get(q: "queue.Queue", stall_after_s: float,
                      last_progress: Callable[[], float],
                      stall_counter, what: str):
    """``q.get()`` bounded by the producer-progress stall watchdog.

    With ``stall_after_s <= 0`` this is a plain blocking get.  Otherwise
    the wait is sliced, and a producer that makes NO progress (as
    reported by the zero-arg ``last_progress`` monotonic-timestamp
    callable) past the budget is convicted with typed ``DataStalled``
    (after ``stall_counter.inc()``).  The clock measures from the LATER
    of producer progress and entry to this wait, so a producer that was
    merely blocked on a full queue is never convicted for the idle time.
    """
    if stall_after_s <= 0:
        return q.get()
    entered = time.monotonic()
    while True:
        try:
            return q.get(timeout=min(1.0, stall_after_s / 4))
        except queue.Empty:
            now = time.monotonic()
            ref = max(last_progress(), entered)
            if now - ref > stall_after_s:
                stall_counter.inc()
                raise DataStalled(
                    f"{what} made no progress for {now - ref:.0f}s "
                    f"(stall_after_s={stall_after_s:g})") from None
