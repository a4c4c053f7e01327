"""Per-process heartbeats: liveness files of a training run (the port's
copy of ``gansformer_tpu/obs/heartbeat.py``).

Each process rewrites ``heartbeat-p<idx>.json`` atomically at every tick
with its step, kimg, wall time and memory; ``read_heartbeats()`` reads
them back, so a supervisor can restart a hung run, and
``check_heartbeats()`` grades their staleness and step skew.  Device
memory comes from ``torch.cuda.memory_stats`` of the visible cards; on
the CPU there is none, and ``hbm/unavailable`` says so.
"""

from __future__ import annotations

import glob
import json
import os
import re
import socket
import time
from typing import Callable, Dict, List, Optional

from gansformer_tpu_torch.obs.registry import atomic_write_text, gauge

_HB_RE = re.compile(r"heartbeat-p(\d+)\.json$")


def _card_stats() -> List[dict]:
    """``torch.cuda.memory_stats`` of every visible card that has been
    initialised, [] on the CPU (no CUDA, or none initialised yet: reading
    the stats must not create a context)."""
    try:
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return []
        out = []
        for i in range(torch.cuda.device_count()):
            s = torch.cuda.memory_stats(i)
            if s:
                out.append({
                    "bytes_in_use": int(s.get("allocated_bytes.all.current",
                                              0)),
                    "peak_bytes_in_use": int(s.get(
                        "allocated_bytes.all.peak", 0)),
                    "bytes_reserved": int(s.get("reserved_bytes.all.current",
                                                0)),
                    "bytes_limit": int(torch.cuda.get_device_properties(
                        i).total_memory)})
        return out
    except Exception:
        return []


def device_memory_stats() -> Optional[dict]:
    """Summed memory stats over the cards, or None on the CPU.  Also
    records the ``device/mem_peak_bytes`` gauge."""
    per_dev = _card_stats()
    if not per_dev:
        return None
    out = {
        "bytes_in_use": sum(s["bytes_in_use"] for s in per_dev),
        "peak_bytes_in_use": sum(s["peak_bytes_in_use"] for s in per_dev),
        "num_devices": len(per_dev),
    }
    gauge("device/mem_peak_bytes").max(out["peak_bytes_in_use"])
    return out


def hbm_device_stats() -> Optional[dict]:
    """The largest card's memory stats right now (a straggler card runs
    out first), or None on the CPU.  Reads only."""
    per_dev = _card_stats()
    if not per_dev:
        return None
    return {
        "bytes_in_use": max(s["bytes_in_use"] for s in per_dev),
        "peak_bytes": max(s["peak_bytes_in_use"] for s in per_dev),
        "bytes_limit": max(s["bytes_limit"] for s in per_dev),
        "devices": len(per_dev),
    }


def sample_hbm() -> Optional[dict]:
    """The per-tick memory gauges: ``hbm/bytes_in_use``,
    ``hbm/peak_bytes`` (high-water), ``hbm/bytes_limit``,
    ``hbm/devices``, and ``hbm/unavailable`` (1.0 on the CPU, the
    explicit marker that no numbers exist).  Returns the sample or
    None."""
    out = hbm_device_stats()
    if out is None:
        gauge("hbm/unavailable").set(1.0)
        return None
    gauge("hbm/unavailable").set(0.0)
    gauge("hbm/bytes_in_use").set(out["bytes_in_use"])
    gauge("hbm/peak_bytes").max(out["peak_bytes"])
    gauge("hbm/devices").set(out["devices"])
    if out["bytes_limit"]:
        gauge("hbm/bytes_limit").set(out["bytes_limit"])
    return out


def host_rss_peak_bytes() -> Optional[int]:
    """Peak resident set of this process (linux ru_maxrss is KiB)."""
    try:
        import resource

        kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    except Exception:
        return None
    peak = int(kib) * 1024
    gauge("host/mem_peak_bytes").max(peak)
    return peak


class Heartbeat:
    """Writer for one process's ``heartbeat-p<idx>.json``."""

    def __init__(self, run_dir: str, process_index: int = 0,
                 time_fn: Callable[[], float] = time.time):
        self.run_dir = run_dir
        self.process_index = process_index
        self.path = os.path.join(run_dir,
                                 f"heartbeat-p{process_index}.json")
        self._time = time_fn
        # every process needs the dir to exist for ITS file, even when
        # process 0 hasn't finished creating the shared run dir yet
        os.makedirs(run_dir, exist_ok=True)

    def beat(self, step: int = 0, kimg: float = 0.0,
             extra: Optional[dict] = None) -> dict:
        rec = {
            "process": self.process_index,
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "time": self._time(),
            "step": int(step),
            "kimg": float(kimg),
        }
        mem = device_memory_stats()
        if mem is not None:
            rec["device_memory"] = mem
        hbm = sample_hbm()
        if hbm is not None:
            rec["hbm"] = hbm
        rss = host_rss_peak_bytes()
        if rss is not None:
            rec["host_rss_peak_bytes"] = rss
        if extra:
            rec.update(extra)
        atomic_write_text(self.path, json.dumps(rec))
        return rec


def read_heartbeats(run_dir: str) -> Dict[int, dict]:
    """{process_index: record} for every readable heartbeat file."""
    out: Dict[int, dict] = {}
    for path in glob.glob(os.path.join(run_dir, "heartbeat-p*.json")):
        m = _HB_RE.search(os.path.basename(path))
        if not m:
            continue
        try:
            with open(path) as f:
                out[int(m.group(1))] = json.load(f)
        except (OSError, ValueError):
            continue  # mid-replace or torn file: next probe sees it
    return out


def check_heartbeats(run_dir: str, max_age_s: float = 300.0,
                     expected: Optional[List[int]] = None,
                     now: Optional[float] = None,
                     max_step_skew: Optional[int] = None) -> dict:
    """Staleness and straggler probe over a run dir's heartbeat files.

    Returns ``{"ok", "ages", "stale", "missing", "steps", "step_skew",
    "skew_exceeded"}``: ``ages`` maps process index → seconds since its
    last beat, ``stale`` lists processes older than ``max_age_s``,
    ``missing`` the expected indices with no file at all, and
    ``step_skew`` is ``max(step) - min(step)`` over the processes.
    ``skew_exceeded`` is True when ``max_step_skew`` is given and the
    spread is larger; ``ok`` is True iff nothing is stale, missing or
    skew-exceeded.  ``expected=None`` checks only the processes that have
    ever written."""
    now = time.time() if now is None else now
    beats = read_heartbeats(run_dir)
    ages = {idx: now - rec.get("time", 0.0) for idx, rec in beats.items()}
    stale = sorted(idx for idx, age in ages.items() if age > max_age_s)
    missing = (sorted(set(expected) - set(beats))
               if expected is not None else [])
    steps = {idx: int(rec.get("step", 0)) for idx, rec in beats.items()}
    step_skew = (max(steps.values()) - min(steps.values())) if steps else 0
    skew_exceeded = (max_step_skew is not None
                     and step_skew > max_step_skew)
    return {"ok": not stale and not missing and not skew_exceeded,
            "ages": ages, "stale": stale, "missing": missing,
            "steps": steps, "step_skew": step_skew,
            "skew_exceeded": skew_exceeded}
