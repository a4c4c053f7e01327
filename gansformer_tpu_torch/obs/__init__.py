"""Telemetry of the port's training loop and service (standard library
only): the span tracer (``events.jsonl``, ``timing/phase/*``), the metric
registry (``telemetry.prom``), the per-process heartbeats and the request
tracer (``reqtrace``: ``requests.jsonl``), the SLO error budgets
over its artifacts (``slo``), the device-time sampler over
``torch.profiler`` (``device_time``, torch imported only when it runs)
and the fleet view of several processes' artifacts (``aggregate``).
Copies of the JAX package's ``obs/spans.py``, ``obs/registry.py``,
``obs/heartbeat.py``, ``obs/reqtrace.py``, ``obs/slo.py``,
``obs/device_time.py`` and ``obs/aggregate.py``; the compile listener
and the retrace watch, which count XLA compiles, have no counterpart
here."""

from gansformer_tpu_torch.obs.device_time import (  # noqa: F401
    DeviceTimeSampler)
from gansformer_tpu_torch.obs.heartbeat import (  # noqa: F401
    Heartbeat, check_heartbeats, device_memory_stats, read_heartbeats,
    sample_hbm)
from gansformer_tpu_torch.obs.registry import (  # noqa: F401
    Registry, counter, gauge, get_registry, histogram, parse_prom_exemplars,
    parse_prom_values)
from gansformer_tpu_torch.obs.reqtrace import (  # noqa: F401
    ReqTracer, configure_reqtrace, get_reqtracer, read_requests,
    render_timeline)
from gansformer_tpu_torch.obs.slo import (  # noqa: F401
    DEFAULT_OBJECTIVES, evaluate_slos, render_slos)
from gansformer_tpu_torch.obs.spans import (  # noqa: F401
    Tracer, configure_tracer, get_tracer, span)
