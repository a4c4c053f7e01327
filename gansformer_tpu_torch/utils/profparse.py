"""Parse ``torch.profiler`` traces for DEVICE time (the port's
counterpart of ``gansformer_tpu/utils/profparse.py``, standard library
only).

A wall clock around a synchronize says how long the host waited, not what
the card ran; the profiler's trace records what the device itself
executed.  The source is the Chrome trace that ``torch.profiler`` exports
(``*.pt.trace.json``, optionally gzipped, as ``profile_dir`` writes it),
or the events a stopped profiler holds in memory (``trace_from_kineto``:
the device-time sampler's fold, which skips the export and the JSON),
read into the JAX parser's event model: plane → ``[(name, start_ps,
dur_ps)]``.

* **Busy time** is the merged intervals of the card's ``kernel``,
  ``gpu_memcpy`` and ``gpu_memset`` events (plane ``/device:GPU:<i>``).
  Annotation ranges and the host's ``cuda_runtime`` launch events are not
  busy time.  A trace of the host alone has the ``cpu_op`` events
  (plane ``/host:CPU``), the only executor plane it has.
* **Program attribution.**  The steps of ``train/steps.py`` run inside a
  ``torch.profiler.record_function`` named ``program:<name>``
  (``program_range``), which the trace holds as a ``user_annotation``.  A
  kernel belongs to the range that encloses its launch: the
  ``cuda_runtime`` (or ``cuda_driver``) event with the kernel's
  ``correlation`` id, on the same thread where a range there encloses
  it, else on any thread (autograd's device thread launches a step's
  backward while the step's own thread waits inside its range).  A kernel
  whose launch is not in the trace (queued before the trace began) falls
  to the card's ``gpu_user_annotation`` range of one program that
  encloses it on its own device, where the trace has one.  A host op
  belongs to the range that encloses its start the same way.
  ``Trace.unattributed`` counts the busy events of each plane that no
  range claimed.

Every entry point degrades instead of raising: a trace is a witness,
never a dependency.  ``device_time_report`` returns JAX's keys, or the
``{"status": "unavailable", "reason": ...}`` sentinel, and a trace torn
by a kill mid-write keeps its complete records.
"""

from __future__ import annotations

import bisect
import dataclasses
import glob
import gzip
import json
import os
import re
from typing import Dict, List, Optional, Tuple

# plane -> [(event name, start_ps, duration_ps), ...]
Events = Dict[str, List[Tuple[str, int, int]]]

PROGRAM_PREFIX = "program:"
HOST_PLANE = "/host:CPU"
_BUSY_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_API_RE = re.compile(r"^cu(?:da)?[A-Z]")       # a runtime or driver call
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def program_range(name: str) -> str:
    """The ``record_function`` name that marks program ``name``."""
    return PROGRAM_PREFIX + name


@dataclasses.dataclass
class Trace:
    """One parsed trace: the busy events by plane, the intervals of those
    events that each program claimed (plane → program → ``[(start_ps,
    end_ps)]``) and the count of busy events no program claimed."""

    events: Events
    programs: Dict[str, Dict[str, List[Tuple[int, int]]]]
    unattributed: Dict[str, int]


def _latest(trace_dir: str, pattern: str) -> Optional[str]:
    paths = glob.glob(os.path.join(trace_dir, "**", pattern),
                      recursive=True)
    return max(paths, key=os.path.getmtime) if paths else None


def _merge_busy(intervals: List[Tuple[int, int]]) -> int:
    """Total covered picoseconds of possibly-overlapping intervals."""
    busy = 0
    end = -1
    for s, t in sorted(intervals):
        if s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return busy


# --- the Chrome trace ---------------------------------------------------------


def _trace_records(text: str) -> List[dict]:
    """The ``traceEvents`` records of a Chrome trace document.  A document
    torn by a kill mid-write keeps every record before the tear."""
    try:
        doc = json.loads(text)
    except ValueError:
        doc = None
    if isinstance(doc, list):
        return [ev for ev in doc if isinstance(ev, dict)]
    if isinstance(doc, dict):
        return [ev for ev in doc.get("traceEvents", [])
                if isinstance(ev, dict)]
    at = text.find('"traceEvents"')
    at = text.find("[", at) if at >= 0 else text.find("[")
    if at < 0:
        raise ValueError("no traceEvents array")
    decoder = json.JSONDecoder()
    out: List[dict] = []
    i, n = at + 1, len(text)
    while i < n:
        while i < n and text[i] in " \t\r\n,":
            i += 1
        if i >= n or text[i] == "]":
            break
        try:
            ev, i = decoder.raw_decode(text, i)
        except ValueError:
            break                       # the torn trailing record
        if isinstance(ev, dict):
            out.append(ev)
    return out


def _ps(us) -> int:
    """Trace microseconds (ns resolution) → integer picoseconds."""
    return int(round(float(us) * 1e3)) * 1000


class _Ranges:
    """Program ranges, sorted by start, for enclosure lookups: the
    innermost enclosing range on the thread, else on any thread."""

    def __init__(self, ranges: List[Tuple[int, int, object, str]]):
        self.r = sorted(ranges, key=lambda x: (x[0], -x[1]))
        self.starts = [x[0] for x in self.r]
        self.max_end = []
        m = -1
        for x in self.r:
            m = max(m, x[1])
            self.max_end.append(m)

    def find(self, t: int, tid=None) -> Optional[str]:
        j = bisect.bisect_right(self.starts, t) - 1
        other = None
        while j >= 0 and self.max_end[j] >= t:
            s, e, rtid, prog = self.r[j]
            if e >= t:
                if tid is None or rtid == tid:
                    return prog
                if other is None:
                    other = prog
            j -= 1
        return other


def _chrome_trace(trace_dir: str) -> Optional[Trace]:
    """The newest ``*.trace.json[.gz]`` under ``trace_dir`` parsed into a
    ``Trace``; None when there is no file."""
    path = _latest(trace_dir, "*.trace.json.gz") \
        or _latest(trace_dir, "*.trace.json")
    if path is None:
        return None
    if path.endswith(".gz"):
        parts = []
        with gzip.open(path, "rt", errors="replace") as f:
            try:
                while True:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        break
                    parts.append(chunk)
            except EOFError:            # a stream cut mid-write
                pass
        text = "".join(parts)
    else:
        with open(path, errors="replace") as f:
            text = f.read()
    return trace_from_records(_trace_records(text))


def trace_from_records(records: List[dict]) -> Optional[Trace]:
    """A ``Trace`` from Chrome trace records (see the module docstring for
    the rules); None when no record is a busy event."""
    events: Events = {}
    busy_meta: List[Tuple[str, int, int, object, object]] = []
    launches: Dict[object, Tuple[object, int]] = {}
    ranges: List[Tuple[int, int, object, str]] = []
    gpu_ranges: Dict[str, List[Tuple[int, int, object, str]]] = {}
    for ev in records:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        name = str(ev.get("name", ""))
        args = ev.get("args") or {}
        try:
            s, d = _ps(ev.get("ts", 0)), _ps(ev.get("dur", 0))
        except (TypeError, ValueError):
            continue
        if cat in _BUSY_CATS:
            plane = f"/device:GPU:{args.get('device', ev.get('pid', 0))}"
            events.setdefault(plane, []).append((name, s, d))
            busy_meta.append((plane, s, d, args.get("correlation"), None))
        elif cat == "cpu_op":
            events.setdefault(HOST_PLANE, []).append((name, s, d))
            busy_meta.append((HOST_PLANE, s, d, None, ev.get("tid")))
        elif cat in _LAUNCH_CATS:
            if args.get("correlation") is not None:
                launches[args["correlation"]] = (ev.get("tid"), s)
        elif cat == "user_annotation":
            prog = program_name(name)
            if prog:
                ranges.append((s, s + d, ev.get("tid"), prog))
        elif cat == "gpu_user_annotation":
            prog = program_name(name)
            if prog:
                plane = f"/device:GPU:{args.get('device', ev.get('pid', 0))}"
                gpu_ranges.setdefault(plane, []).append(
                    (s, s + d, None, prog))
    return _attribute(events, busy_meta, launches, ranges, gpu_ranges)


def _attribute(events, busy_meta, launches, ranges, gpu_ranges):
    """The ``Trace`` of the busy events, each claimed by the program
    range that encloses its launch (or its own start on the host)."""
    if not events:
        return None
    host = _Ranges(ranges)
    card = {p: _Ranges(r) for p, r in gpu_ranges.items()}
    programs: Dict[str, Dict[str, List[Tuple[int, int]]]] = {}
    unattributed: Dict[str, int] = {p: 0 for p in events}
    for plane, s, d, corr, tid in busy_meta:
        if plane == HOST_PLANE:
            prog = host.find(s, tid)
        else:
            launch = launches.get(corr) if corr is not None else None
            prog = host.find(launch[1], launch[0]) if launch else None
            if prog is None and launch is None and plane in card:
                prog = card[plane].find(s)
        if prog is None:
            unattributed[plane] += 1
        else:
            programs.setdefault(plane, {}).setdefault(prog, []).append(
                (s, s + d))
    return Trace(events, programs, unattributed)


def trace_from_kineto(kineto_events, host_ops: bool = True
                      ) -> Optional[Trace]:
    """A ``Trace`` from the events a stopped ``torch.profiler`` holds in
    memory (``prof.profiler.kineto_results.events()``), by the rules of
    ``trace_from_records``, without the Chrome trace's export and parse.
    Each event's kind comes from its device, its annotation flag, its
    link and its name: a CUDA runtime or driver call is a host event
    linked to an operator (``linked_correlation_id``) or named as the
    API names its calls (``cudaEventRecord``, ``cuLaunchKernel``), and a
    launch shares its kernel's ``correlation_id``; a host operator is any
    other host event.  ``host_ops=False`` leaves the host's operators out
    (a profile of the card, whose report reads the card's plane): most
    of a profile's events, and most of the fold's time."""
    events: Events = {}
    busy_meta: List[Tuple[str, int, int, object, object]] = []
    launches: Dict[object, Tuple[object, int]] = {}
    ranges: List[Tuple[int, int, object, str]] = []
    gpu_ranges: Dict[str, List[Tuple[int, int, object, str]]] = {}
    on_card: Dict[object, bool] = {}        # device type -> a CUDA device
    for ev in kineto_events:
        dt = ev.device_type()
        if dt not in on_card:
            on_card[dt] = str(dt).endswith("CUDA")
        if on_card[dt]:
            name = ev.name()
            s, d = ev.start_ns() * 1000, ev.duration_ns() * 1000
            plane = f"/device:GPU:{ev.device_index()}"
            if ev.is_user_annotation():
                prog = program_name(name)
                if prog:
                    gpu_ranges.setdefault(plane, []).append(
                        (s, s + d, None, prog))
                continue
            events.setdefault(plane, []).append((name, s, d))
            busy_meta.append((plane, s, d, ev.correlation_id(), None))
        elif ev.is_user_annotation():
            prog = program_name(ev.name())
            if prog:
                s = ev.start_ns() * 1000
                ranges.append((s, s + ev.duration_ns() * 1000,
                               ev.start_thread_id(), prog))
        elif ev.linked_correlation_id():
            launches[ev.correlation_id()] = (ev.start_thread_id(),
                                             ev.start_ns() * 1000)
        else:
            name = ev.name()
            if _API_RE.match(name):
                launches[ev.correlation_id()] = (ev.start_thread_id(),
                                                 ev.start_ns() * 1000)
            elif host_ops:
                s, d = ev.start_ns() * 1000, ev.duration_ns() * 1000
                events.setdefault(HOST_PLANE, []).append((name, s, d))
                busy_meta.append((HOST_PLANE, s, d, None,
                                  ev.start_thread_id()))
    return _attribute(events, busy_meta, launches, ranges, gpu_ranges)


def parse_trace(trace_dir: str):
    """``(Trace, "chrome-trace")``, or ``(None, reason)``."""
    try:
        trace = _chrome_trace(trace_dir)
    except Exception as e:               # unreadable or not a trace
        return None, f"chrome-trace parse failed ({type(e).__name__}: {e})"
    if trace is None:
        return None, f"no parseable trace under {trace_dir}"
    return trace, "chrome-trace"


def parse_trace_events(trace_dir: str):
    """``(events, source)`` from the trace under ``trace_dir``, or
    ``(None, reason)``."""
    trace, source = parse_trace(trace_dir)
    return (trace.events if trace else None), source


# --- summaries ----------------------------------------------------------------


def _summarize(events: Events) -> Dict[str, Dict[str, float]]:
    out: Dict[str, Dict[str, float]] = {}
    for plane, evs in events.items():
        iv = [(s, s + d) for _, s, d in evs]
        if not iv:
            continue
        lo = min(s for s, _ in iv)
        hi = max(t for _, t in iv)
        out[plane] = {
            "busy_s": _merge_busy(iv) / 1e12,
            "span_s": (hi - lo) / 1e12,
            "events": float(len(iv)),
        }
    return out


def parse_planes(trace_dir: str) -> Optional[Dict[str, Dict[str, float]]]:
    """{plane name: {busy_s, span_s, events}}."""
    events, _ = parse_trace_events(trace_dir)
    return _summarize(events) if events else None


def _pick_plane(planes: Dict[str, Dict[str, float]]) -> Optional[str]:
    """Preference: a GPU plane (the busiest); else any ``/device:``
    plane; else the host's CPU ops (the only plane a trace of the host
    has)."""
    for want in ("/device:GPU", "/device:", HOST_PLANE):
        cands = {n: v for n, v in planes.items() if n.startswith(want)}
        if cands:
            return max(cands, key=lambda n: cands[n]["busy_s"])
    return None


def device_busy_span(trace_dir: str) -> Optional[Tuple[float, float, str]]:
    """(busy_s, span_s, plane) for the best executor plane in the trace;
    ``busy_s`` is interval-merged, so overlapping streams do not count
    twice."""
    planes = parse_planes(trace_dir)
    if not planes:
        return None
    name = _pick_plane(planes)
    if name is None:
        return None
    return planes[name]["busy_s"], planes[name]["span_s"], name


# --- program (phase) attribution ---------------------------------------------

_PJIT_RE = re.compile(r"^PjitFunction\((.+)\)$")
_JIT_RE = re.compile(r"^jit_+(.+?)(?:[.(].*)?$")
_RANGE_RE = re.compile(r"^" + re.escape(PROGRAM_PREFIX) + r"(.+)$")


def program_name(event_name: str) -> Optional[str]:
    """The program an event name marks, sanitized for the telemetry
    registry namespace (lowercase ``[a-z0-9_]``): the port's
    ``program:<name>`` ranges, and JAX's ``PjitFunction(<name>)`` and
    ``jit_<name>`` forms.  Anything else returns None."""
    m = (_RANGE_RE.match(event_name) or _PJIT_RE.match(event_name)
         or _JIT_RE.match(event_name))
    if not m:
        return None
    n = re.sub(r"[^a-z0-9_]+", "_", m.group(1).strip().lower()).strip("_")
    return n or None


def attribute_programs(trace: Trace) -> Dict[str, float]:
    """{program name: merged busy seconds} over the trace's programs.
    Device planes win when any of them carries program events (the card's
    own time); otherwise every plane contributes (a trace of the host)."""
    per_plane = {p: v for p, v in trace.programs.items() if v}
    if not per_plane:
        return {}
    device_planes = {p: v for p, v in per_plane.items()
                     if p.startswith("/device:")}
    chosen = device_planes or per_plane
    merged: Dict[str, List[Tuple[int, int]]] = {}
    for progs in chosen.values():
        for prog, iv in progs.items():
            merged.setdefault(prog, []).extend(iv)
    return {prog: _merge_busy(iv) / 1e12 for prog, iv in merged.items()}


def trace_report(trace: Optional[Trace], source: str) -> dict:
    """``device_time_report`` of an already parsed trace."""
    if trace is None:
        return {"status": "unavailable", "reason": source}
    planes = _summarize(trace.events)
    plane = _pick_plane(planes)
    if plane is None:
        return {"status": "unavailable",
                "reason": "no executor plane in trace"}
    return {
        "status": "ok",
        "source": source,
        "plane": plane,
        "busy_s": planes[plane]["busy_s"],
        "span_s": planes[plane]["span_s"],
        "events": int(planes[plane]["events"]),
        "program_busy_s": attribute_programs(trace),
    }


def device_time_report(trace_dir: str) -> dict:
    """One-call device-time summary of a profiler trace dir.

    ``{"status": "ok", "source", "plane", "busy_s", "span_s", "events",
    "program_busy_s": {name: s}}`` on success;
    ``{"status": "unavailable", "reason": ...}`` when there is no
    parseable trace: a sentinel, never an exception, so the loop's
    sampler folds the outcome into telemetry either way."""
    return trace_report(*parse_trace(trace_dir))
