"""Telemetry of the port's training loop and service (standard library
only): the span tracer (``events.jsonl``, ``timing/phase/*``), the metric
registry (``telemetry.prom``), the per-process heartbeats and the request
tracer (``reqtrace``: ``requests.jsonl``).  Copies of the JAX package's
``obs/spans.py``, ``obs/registry.py``, ``obs/heartbeat.py`` and
``obs/reqtrace.py``; the compile listener and the retrace watch, which
count XLA compiles, have no counterpart here."""

from gansformer_tpu_torch.obs.heartbeat import (  # noqa: F401
    Heartbeat, device_memory_stats, read_heartbeats, sample_hbm)
from gansformer_tpu_torch.obs.registry import (  # noqa: F401
    Registry, counter, gauge, get_registry, histogram, parse_prom_values)
from gansformer_tpu_torch.obs.spans import (  # noqa: F401
    Tracer, configure_tracer, get_tracer, span)
