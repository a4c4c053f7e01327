"""Supervision contract of the port's training runs: the event ledger and
exit codes (``events``) and fault injection (``faults``), copies of the
JAX package's, so one supervisor drives either package."""

from gansformer_tpu_torch.supervise import events, faults  # noqa: F401
from gansformer_tpu_torch.supervise.events import (  # noqa: F401
    EXIT_DATA_CORRUPT, EXIT_DATA_STALLED, EXIT_PREEMPTED, PreemptionExit)
