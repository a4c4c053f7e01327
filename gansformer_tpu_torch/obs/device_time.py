"""Periodic device-time sampler over ``torch.profiler`` (the port's
counterpart of ``gansformer_tpu/obs/device_time.py``).

Wall-clock spans (``obs/spans.py``) say where the host loop's time went,
not what the card was doing.  Every ``every_ticks`` ticks the sampler
wraps one whole tick window (boundary to boundary, both ends synchronized
by the loop) in a ``torch.profiler`` trace and, once it is stopped,
reads the profiler's events from memory into ``utils/profparse.py``'s
model (``trace_from_kineto``: a whole tick's Chrome trace runs to many
MB, and its export and JSON parse cost several times the fold) and
folds the report into the registry.  Gauges and counters (JAX's
names):

* ``device/busy_ms`` / ``device/span_ms`` / ``device/wall_ms`` — the
  window's merged device-busy time, the trace's span and the host wall;
* ``device/wall_busy_ratio`` — busy / wall: about 1 when the card sets
  the pace, much less when the host does, above 1 when the wall clock
  misses device work;
* ``device/phase_ms/<program>`` — per program (``d_step``,
  ``d_step_r1``, ``g_step``, ``g_step_pl``: the steps' ``program:``
  ranges), the 12 heaviest;
* ``device/mfu`` — only with a FLOP count per iteration and a peak (the
  port has none yet, so the loop passes ``flops_per_it=None``);
* ``device/samples_total`` / ``device/sample_failed_total``,
  ``device/unavailable`` (the last trace gave no report) and
  ``device/sampler_off`` (the marker that sampling is off).

The profiler is process-global: a start that fails (another profiler
active, no tracer) costs one failed sample, never the run, and
``close()`` releases an open trace on every exit path.  The trace's
``cuda`` activities are asked for only where ``device`` is a card.
``start_profiler`` / ``export_trace`` are also the loop's one-shot
``profile_dir`` trace, which ``profparse.device_time_report`` reads.
"""

from __future__ import annotations

import os
import socket
import time
from typing import Optional

from gansformer_tpu_torch.obs.registry import counter, gauge

# bound the device/phase_ms/* cardinality: keep the heaviest programs
_MAX_PROGRAMS = 12


def _on_card(device) -> bool:
    import torch

    return device is not None and torch.device(device).type == "cuda"


def start_profiler(device=None):
    """A started ``torch.profiler.profile`` of the host's ops, with the
    card's activities when ``device`` is a CUDA device."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if _on_card(device):
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def profile_report(prof, host_ops: bool = True) -> dict:
    """``device_time_report``'s dict for a stopped profiler, from its
    events in memory (without the host's operators where ``host_ops`` is
    False: a profile of the card)."""
    from gansformer_tpu_torch.utils.profparse import (trace_from_kineto,
                                                      trace_report)

    trace = trace_from_kineto(prof.profiler.kineto_results.events(),
                              host_ops=host_ops)
    return trace_report(trace, "profiler-memory" if trace else
                        "no device or host event in the profile")


def export_trace(prof, trace_dir: str) -> str:
    """Write a stopped ``prof``'s Chrome trace under ``trace_dir`` as
    ``<host>_<pid>.<ms>.pt.trace.json`` (the name
    ``torch.profiler.tensorboard_trace_handler`` gives); returns its
    path."""
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"{socket.gethostname()}_{os.getpid()}."
                                   f"{int(time.time() * 1000)}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


class DeviceTimeSampler:
    def __init__(self, every_ticks: int = 0,
                 flops_per_it: Optional[float] = None,
                 peak_tflops: Optional[float] = None,
                 enabled: bool = True, device=None):
        self.every = int(every_ticks or 0)
        self.enabled = bool(enabled) and self.every > 0
        self.flops_per_it = flops_per_it
        self.peak_tflops = peak_tflops
        self.device = device
        self._prof = None
        self._t0 = 0.0
        # the markers exist from construction (the loop builds the
        # sampler after the per-run registry reset), so the first prom
        # write already says whether device time is sampled
        gauge("device/sampler_off").set(0.0 if self.enabled else 1.0)
        if self.enabled:
            counter("device/samples_total")
            self._warm()

    def _warm(self) -> None:
        """Pay the profiler's one-time per-process setup (CUPTI's, seconds
        on the card) here, outside any tick window, with a throwaway start
        and stop; a failure only means the first sample pays it."""
        try:
            start_profiler(self.device).stop()
        except Exception:
            pass

    @property
    def sampling(self) -> bool:
        return self._prof is not None

    def maybe_start(self, tick: int) -> bool:
        """Start a trace at this tick boundary when the cadence says so
        (``tick % every == 1 % every``: the first steady-state window, as
        the one-shot ``profile_dir`` trace; ``every == 1`` fires at every
        boundary).  ``stop_and_fold`` stops it at the next boundary."""
        if not self.enabled or self.sampling \
                or tick % self.every != 1 % self.every:
            return False
        try:
            self._prof = start_profiler(self.device)
        except Exception:
            # tracer unavailable or already active: one failed sample
            counter("device/sample_failed_total").inc()
            return False
        self._t0 = time.time()
        return True

    def stop_and_fold(self, wall_s: Optional[float] = None,
                      iters: Optional[float] = None) -> Optional[dict]:
        """Stop the trace, fold its events into the gauges and drop it.
        ``wall_s`` is the window's host wall (the loop's
        ``sec_per_tick``), ``iters`` its iterations (for ``device/mfu``).
        Returns the ``device_time_report`` dict with ``wall_s`` and the
        seconds of the stop and of the fold (``stop_s``, ``fold_s``)
        added, or None when no trace was active or the stop failed."""
        if not self.sampling:
            return None
        prof, self._prof = self._prof, None
        wall = wall_s if wall_s is not None else time.time() - self._t0
        t0 = time.perf_counter()
        try:
            prof.stop()
        except Exception:
            counter("device/sample_failed_total").inc()
            return None
        t1 = time.perf_counter()
        try:
            rep = profile_report(prof, host_ops=not _on_card(self.device))
        except Exception as e:            # a profile the fold cannot read
            rep = {"status": "unavailable",
                   "reason": f"{type(e).__name__}: {e}"}
        rep.update(wall_s=wall, stop_s=t1 - t0,
                   fold_s=time.perf_counter() - t1)
        if rep.get("status") != "ok":
            counter("device/sample_failed_total").inc()
            gauge("device/unavailable").set(1.0)
            return rep
        counter("device/samples_total").inc()
        gauge("device/unavailable").set(0.0)
        busy = rep["busy_s"]
        gauge("device/busy_ms").set(busy * 1e3)
        gauge("device/span_ms").set(rep["span_s"] * 1e3)
        gauge("device/wall_ms").set(wall * 1e3)
        if wall > 0:
            gauge("device/wall_busy_ratio").set(busy / wall)
        progs = sorted(rep.get("program_busy_s", {}).items(),
                       key=lambda kv: -kv[1])[:_MAX_PROGRAMS]
        for name, s in progs:
            gauge(f"device/phase_ms/{name}").set(s * 1e3)
        if self.flops_per_it and self.peak_tflops and iters and busy > 0:
            rep["device_mfu"] = (self.flops_per_it * iters / busy
                                 / (self.peak_tflops * 1e12))
            gauge("device/mfu").set(rep["device_mfu"])
        return rep

    def close(self) -> None:
        """Discard an open trace without folding (exception paths, end of
        run), so the process-global profiler is released."""
        if not self.sampling:
            return
        prof, self._prof = self._prof, None
        try:
            prof.stop()
        except Exception:
            pass
