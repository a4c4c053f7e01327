"""Counters, gauges and histograms: the process-global metric registry
(the port's copy of ``gansformer_tpu/obs/registry.py``).

Instruments are created or fetched by slash-path name
(``counter("data/starved_total")``).  ``snapshot()`` is the nested dict
each ``stats.jsonl`` tick record embeds as ``telemetry``;
``export_text()`` is the Prometheus text (``data/wait_ms`` ->
``data_wait_ms``) written atomically to ``telemetry.prom`` every tick,
and ``parse_prom_values`` (``parse_prom_exemplars``) reads its
samples (exemplars) back.  Histograms keep count, sum,
min and max.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Dict, Optional

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def atomic_write_text(path: str, text: str) -> None:
    """Write-then-rename so a concurrent reader never sees a torn file;
    the tmp file is removed if the write itself fails."""
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def prom_name(name: str) -> str:
    """Slash-path instrument name → legal Prometheus metric name."""
    n = _NAME_RE.sub("_", name)
    if not n or not (n[0].isalpha() or n[0] in "_:"):
        n = "_" + n
    return n


def parse_prom_values(path: str) -> Dict[str, float]:
    """``telemetry.prom`` sample lines → {prom name: value} (last write
    wins).  Lives next to ``export_text`` so the ONE module that owns
    the format both writes and reads it — the doctor and the schema
    lint's family check are the consumers."""
    out: Dict[str, float] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) != 2:
                continue
            try:
                out[parts[0]] = float(parts[1])
            except ValueError:
                continue
    return out


def parse_prom_exemplars(path: str) -> Dict[str, str]:
    """``# EXEMPLAR <sample_name> <label>`` comment lines → {sample name:
    label}: the read half of the histogram exemplar channel (the
    requests CLI resolves ``serve_e2e_ms_max`` here to the request whose
    timeline explains the p99 outlier)."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 4 and parts[0] == "#" and \
                    parts[1] == "EXEMPLAR":
                out[parts[2]] = parts[3]
    return out


class Counter:
    """Monotonic count.  ``inc()`` only — decrements are a gauge's job."""

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-write-wins instantaneous value (queue depth, peak bytes)."""

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def max(self, v: float) -> None:
        """Keep the high-water mark (peak-memory style gauges)."""
        with self._lock:
            self._value = max(self._value, float(v))

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Streaming count/sum/min/max of observations.

    ``observe(v, exemplar=...)`` may attach an exemplar label (a request
    ID) to the observation; the histogram retains the exemplar of its
    CURRENT max, so a p99 outlier in ``serve/e2e_ms`` links straight to
    the request timeline that produced it (exported as a ``# EXEMPLAR``
    comment line in the prom text — comments are transparent to
    ``parse_prom_values`` and the schema lint, so the channel costs the
    readers nothing)."""

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.max_exemplar: Optional[str] = None

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            if self.max is None or v >= self.max:
                self.max = v
                if exemplar is not None:
                    self.max_exemplar = str(exemplar)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def _get(self, table: dict, others: tuple, name: str, cls):
        with self._lock:
            if name in table:
                return table[name]
            for other in others:
                if name in other:
                    raise TypeError(
                        f"telemetry name {name!r} already registered as a "
                        f"different instrument type")
            inst = cls(name, threading.Lock())
            table[name] = inst
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, (self._gauges, self._histograms),
                         name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, (self._counters, self._histograms),
                         name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(self._histograms, (self._counters, self._gauges),
                         name, Histogram)

    def reset(self) -> None:
        """Drop every instrument.  The train loop calls this at run start
        so telemetry.prom / stats.jsonl describe ONE run even when several
        train() calls share a process (experiment arms, tests)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    # -- exports -----------------------------------------------------------

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {
                "counters": {n: c.value for n, c in self._counters.items()},
                "gauges": {n: g.value for n, g in self._gauges.items()},
                "histograms": {
                    n: ({"count": h.count, "sum": h.sum, "mean": h.mean,
                         "min": h.min, "max": h.max}
                        | ({"max_exemplar": h.max_exemplar}
                           if h.max_exemplar is not None else {}))
                    for n, h in self._histograms.items()},
            }

    def export_text(self) -> str:
        """Prometheus text exposition format (one family per instrument;
        histograms as <name>_count/_sum/_min/_max).  Values use Python's
        shortest round-trip float repr — ``%g``-style 6-digit formatting
        would silently corrupt counters past ~1e6."""
        def fmt(v) -> str:
            return repr(float(v))

        lines = []
        with self._lock:
            for n, c in sorted(self._counters.items()):
                pn = prom_name(n)
                lines += [f"# TYPE {pn} counter", f"{pn} {fmt(c.value)}"]
            for n, g in sorted(self._gauges.items()):
                pn = prom_name(n)
                lines += [f"# TYPE {pn} gauge", f"{pn} {fmt(g.value)}"]
            for n, h in sorted(self._histograms.items()):
                pn = prom_name(n)
                lines.append(f"# TYPE {pn} summary")
                lines.append(f"{pn}_count {fmt(h.count)}")
                lines.append(f"{pn}_sum {fmt(h.sum)}")
                if h.count:
                    lines.append(f"{pn}_min {fmt(h.min)}")
                    lines.append(f"{pn}_max {fmt(h.max)}")
                    if h.max_exemplar is not None:
                        # comment channel: readers that don't know about
                        # exemplars (parse_prom_values, check_prom) skip
                        # '#' lines by contract
                        lines.append(f"# EXEMPLAR {pn}_max "
                                     f"{h.max_exemplar}")
        return "\n".join(lines) + "\n" if lines else ""

    def write_prom(self, path: str) -> None:
        """Atomic rewrite — a scraper never sees a torn file."""
        atomic_write_text(path, self.export_text())


_REGISTRY = Registry()


def get_registry() -> Registry:
    return _REGISTRY


def counter(name: str) -> Counter:
    return _REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return _REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return _REGISTRY.histogram(name)
