"""Fleet telemetry aggregation: N processes' artifacts → one view (the
port's copy of ``gansformer_tpu/obs/aggregate.py``, standard library
only).

Per-process artifacts (``telemetry.prom`` / ``telemetry-p<idx>.prom``,
``heartbeat-p*.json``, ``supervisor_events.jsonl``) answer per-process
questions; the fleet's are which process straggles (step skew), how wide
the device-MFU spread is and whether restarts clustered on one input
(restart asymmetry).  ``aggregate_fleet`` folds them into one
``fleet.json`` / ``fleet.prom`` pair with declared merge rules:

=============  ==========================================================
family         merge
=============  ==========================================================
counters       sum over reporting processes
gauges         max / min / spread (exported as ``<name>_max`` /
               ``<name>_min`` / ``<name>_spread``)
histograms     ``_count``/``_sum`` sum, ``_min`` min, ``_max`` max
heartbeats     roster + step skew via ``check_heartbeats`` (the same
               computation as the doctor and the heartbeats command)
supervisor     restart events counted per input (restart asymmetry =
               max − min across inputs)
=============  ==========================================================

A missing process, a stale heartbeat, gauge timestamps too far apart to
describe one instant, or a partially written prom file give a PARTIAL
view: ``fleet/partial`` is set, the reasons are listed, and nothing
raises.

Inputs: ONE shared run dir (the ``heartbeat-p*.json`` roster; per-process
proms as ``telemetry-p<idx>.prom`` when present, else ``telemetry.prom``
attributed to process 0, the loop's single-writer layout), or a LIST of
per-process run dirs (each with its own ``telemetry.prom``).
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Dict, List, Optional, Tuple, Union

from gansformer_tpu_torch.obs.heartbeat import (check_heartbeats,
                                                read_heartbeats)
from gansformer_tpu_torch.obs.registry import atomic_write_text

_SUMMARY_SUFFIX = re.compile(r"_(count|sum|min|max)$")


def _parse_prom_typed(path: str) -> Tuple[Dict[str, str],
                                          Dict[str, float], List[str]]:
    """({family: type}, {sample name: value}, issues).  Never raises:
    unreadable files and torn lines become issues — the partial-view
    inputs this module exists to tolerate."""
    types: Dict[str, str] = {}
    values: Dict[str, float] = {}
    issues: List[str] = []
    try:
        with open(path) as f:
            lines = f.readlines()
    except OSError as e:
        return types, values, [f"{path}: unreadable ({e})"]
    for i, line in enumerate(lines, 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) == 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        parts = line.split()
        if len(parts) != 2:
            issues.append(f"{path}:{i}: torn line")
            continue
        try:
            values[parts[0]] = float(parts[1])
        except ValueError:
            issues.append(f"{path}:{i}: non-numeric value")
    return types, values, issues


def _family_of(name: str, types: Dict[str, str]) -> Tuple[str, str]:
    """(family base name, declared type) for one sample name; summary
    member suffixes resolve to their family."""
    if name in types:
        return name, types[name]
    base = _SUMMARY_SUFFIX.sub("", name)
    if base in types:
        return base, types[base]
    return name, "untyped"


def _discover_inputs(run_dirs) -> List[dict]:
    """Normalize the two input shapes into per-process descriptors:
    {idx, heartbeat (rec or None), prom_path (or None)}."""
    if isinstance(run_dirs, (str, os.PathLike)):
        run_dir = str(run_dirs)
        beats = read_heartbeats(run_dir)
        indices = sorted(beats) or [0]
        procs = []
        for idx in indices:
            prom = os.path.join(run_dir, f"telemetry-p{idx}.prom")
            if not os.path.exists(prom):
                # single-writer layout: process 0 owns telemetry.prom
                prom = (os.path.join(run_dir, "telemetry.prom")
                        if idx == 0 else None)
            procs.append({"idx": idx, "dir": run_dir,
                          "heartbeat": beats.get(idx),
                          "prom_path": prom})
        return procs
    procs = []
    for i, d in enumerate(run_dirs):
        d = str(d)
        beats = read_heartbeats(d)
        idx = sorted(beats)[0] if beats else i
        prom = os.path.join(d, "telemetry.prom")
        procs.append({"idx": idx, "dir": d,
                      "heartbeat": beats.get(idx),
                      "prom_path": prom if os.path.exists(prom)
                      else None})
    return procs


def _count_restarts(run_dir: str) -> Optional[int]:
    """Restart events in a dir's supervisor ledger (None when absent);
    torn lines skipped — the ledger's own readers do the same."""
    path = os.path.join(run_dir, "supervisor_events.jsonl")
    if not os.path.exists(path):
        return None
    n = 0
    try:
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and rec.get("kind") == "restart":
                    n += 1
    except OSError:
        return None
    return n


def aggregate_fleet(run_dirs: Union[str, List[str]],
                    expected: Optional[int] = None,
                    max_age_s: Optional[float] = None,
                    now: Optional[float] = None,
                    gauge_skew_s: float = 300.0) -> dict:
    """Fold per-process artifacts into the fleet view (see module
    docstring for merge semantics and the degradation contract).

    ``expected`` declares the roster size (missing processes detected);
    ``max_age_s`` judges heartbeat staleness; ``gauge_skew_s`` bounds
    how far apart per-process heartbeat times may be before gauge
    merges are flagged as non-simultaneous (conflicting timestamps).
    Never raises on bad inputs — the return carries ``partial`` +
    ``partial_reasons`` instead."""
    now = time.time() if now is None else now
    procs = _discover_inputs(run_dirs)
    partial_reasons: List[str] = []

    # -- roster / heartbeats (the check_heartbeats verdict verbatim) --------
    single_dir = isinstance(run_dirs, (str, os.PathLike))
    hb_dir = str(run_dirs) if single_dir else None
    steps: Dict[int, int] = {}
    ages: Dict[int, float] = {}
    hb_times: List[float] = []
    for p in procs:
        rec = p["heartbeat"]
        if rec is not None:
            steps[p["idx"]] = int(rec.get("step", 0))
            ages[p["idx"]] = now - rec.get("time", 0.0)
            hb_times.append(rec.get("time", 0.0))
    if single_dir:
        hb = check_heartbeats(
            hb_dir, max_age_s=max_age_s if max_age_s is not None else 1e18,
            expected=list(range(expected)) if expected is not None
            else None, now=now)
        step_skew = hb["step_skew"]
        stale = hb["stale"]
        missing = hb["missing"]
    else:
        step_skew = (max(steps.values()) - min(steps.values())
                     if steps else 0)
        stale = sorted(idx for idx, age in ages.items()
                       if max_age_s is not None and age > max_age_s)
        missing = (sorted(set(range(expected)) - set(steps))
                   if expected is not None else [])
    reporting = sorted(steps)
    roster = sorted(set(reporting) | set(missing)
                    | set(range(expected or 0)))
    if not reporting:
        partial_reasons.append("no heartbeat reported by any process")
    for idx in missing:
        partial_reasons.append(f"process {idx} missing (no heartbeat)")
    for idx in stale:
        partial_reasons.append(
            f"process {idx} heartbeat stale ({ages[idx]:.0f}s old)")

    # -- per-process proms ---------------------------------------------------
    counters: Dict[str, float] = {}
    gauges: Dict[str, dict] = {}
    summaries: Dict[str, dict] = {}
    prom_reporting: List[int] = []
    for p in procs:
        path = p["prom_path"]
        p["prom"] = os.path.basename(path) if path else None
        p["prom_issues"] = 0
        if path is None:
            continue
        if not os.path.exists(path):
            partial_reasons.append(
                f"process {p['idx']}: prom file missing ({path})")
            continue
        types, values, issues = _parse_prom_typed(path)
        if issues:
            p["prom_issues"] = len(issues)
            partial_reasons.append(
                f"process {p['idx']}: partially-written prom "
                f"({len(issues)} unparsable line(s))")
        if not values:
            continue
        prom_reporting.append(p["idx"])
        for name, v in values.items():
            fam, kind = _family_of(name, types)
            if kind == "counter":
                counters[name] = counters.get(name, 0.0) + v
            elif kind == "summary":
                s = summaries.setdefault(fam, {})
                member = name[len(fam) + 1:] if name != fam else "value"
                if member in ("count", "sum"):
                    s[member] = s.get(member, 0.0) + v
                elif member == "min":
                    s[member] = min(s.get(member, v), v)
                elif member == "max":
                    s[member] = max(s.get(member, v), v)
            else:                       # gauge / untyped: spread stats
                g = gauges.setdefault(name, {"per_process": {}})
                g["per_process"][p["idx"]] = v
    for g in gauges.values():
        vs = list(g["per_process"].values())
        g["min"], g["max"] = min(vs), max(vs)
        g["spread"] = g["max"] - g["min"]
        g["per_process"] = {str(k): v
                            for k, v in sorted(g["per_process"].items())}

    # conflicting gauge timestamps: gauges merged from artifacts whose
    # heartbeat times straddle more than gauge_skew_s cannot describe
    # one instant — the spread numbers are flagged, not trusted
    gauge_ts_conflict = (len(prom_reporting) > 1 and len(hb_times) > 1
                         and max(hb_times) - min(hb_times) > gauge_skew_s)
    if gauge_ts_conflict:
        partial_reasons.append(
            "conflicting gauge timestamps: per-process artifacts span "
            f"{max(hb_times) - min(hb_times):.0f}s > {gauge_skew_s:.0f}s "
            "— merged gauges are not simultaneous")

    # -- restart asymmetry ---------------------------------------------------
    restart_dirs = sorted({p["dir"] for p in procs})
    restarts: Dict[str, int] = {}
    for d in restart_dirs:
        n = _count_restarts(d)
        if n is not None:
            restarts[d] = n
    restart_counts = list(restarts.values())
    restart_spread = (max(restart_counts) - min(restart_counts)
                      if len(restart_counts) > 1 else 0)

    mfu = gauges.get("device_mfu", {})
    return {
        "generated_at": now,
        "processes": {
            str(p["idx"]): {
                "step": steps.get(p["idx"]),
                "age_s": (round(ages[p["idx"]], 3)
                          if p["idx"] in ages else None),
                "heartbeat": p["heartbeat"] is not None,
                "prom": p["prom"],
                "prom_issues": p["prom_issues"],
            } for p in procs},
        "expected": expected, "roster": roster,
        "reporting": reporting, "missing": missing, "stale": stale,
        "prom_reporting": sorted(prom_reporting),
        "partial": bool(partial_reasons),
        "partial_reasons": partial_reasons,
        "steps": {str(k): v for k, v in sorted(steps.items())},
        "step_skew": step_skew,
        "heartbeat_age_max_s": (round(max(ages.values()), 3)
                                if ages else None),
        "gauge_ts_conflict": gauge_ts_conflict,
        "counters": dict(sorted(counters.items())),
        "gauges": dict(sorted(gauges.items())),
        "histograms": dict(sorted(summaries.items())),
        "mfu_spread": mfu.get("spread"),
        "mfu_per_process": mfu.get("per_process"),
        "restarts": restarts,
        "restarts_total": sum(restart_counts),
        "restart_spread": restart_spread,
    }


def fleet_prom_text(fleet: dict) -> str:
    """The fleet view as Prometheus text: the ``fleet_*`` meta family
    (partial marker first — the one value a reader must never miss),
    then merged counters, gauge spread triples, and summary families.
    Every sample is TYPE-declared so ``check_prom`` passes."""
    def fmt(v) -> str:
        return repr(float(v))

    lines = []

    def g(name: str, v) -> None:
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {fmt(v)}")

    g("fleet_partial", 1.0 if fleet["partial"] else 0.0)
    g("fleet_processes", len(fleet["roster"]))
    g("fleet_processes_reporting", len(fleet["reporting"]))
    g("fleet_processes_missing", len(fleet["missing"]))
    g("fleet_processes_stale", len(fleet["stale"]))
    g("fleet_step_skew", fleet["step_skew"])
    g("fleet_heartbeat_age_max_s", fleet["heartbeat_age_max_s"] or 0.0)
    g("fleet_gauge_ts_conflict",
      1.0 if fleet["gauge_ts_conflict"] else 0.0)
    g("fleet_restart_spread", fleet["restart_spread"])
    if fleet["mfu_spread"] is not None:
        g("fleet_mfu_spread", fleet["mfu_spread"])
    lines.append("# TYPE fleet_restarts_total counter")
    lines.append(f"fleet_restarts_total {fmt(fleet['restarts_total'])}")
    for name, v in fleet["counters"].items():
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name} {fmt(v)}")
    for name, gd in fleet["gauges"].items():
        for stat in ("max", "min", "spread"):
            lines.append(f"# TYPE {name}_{stat} gauge")
            lines.append(f"{name}_{stat} {fmt(gd[stat])}")
    for fam, s in fleet["histograms"].items():
        lines.append(f"# TYPE {fam} summary")
        for member in ("count", "sum", "min", "max"):
            if member in s:
                lines.append(f"{fam}_{member} {fmt(s[member])}")
    return "\n".join(lines) + "\n" if lines else ""


def write_fleet(fleet: dict, out_dir: str) -> Tuple[str, str]:
    """Write ``fleet.json`` + ``fleet.prom`` (atomic — a scraper never
    sees a torn fleet view); returns the two paths."""
    os.makedirs(out_dir, exist_ok=True)
    json_path = os.path.join(out_dir, "fleet.json")
    prom_path = os.path.join(out_dir, "fleet.prom")
    atomic_write_text(json_path,
                      json.dumps(fleet, indent=1, sort_keys=True) + "\n")
    atomic_write_text(prom_path, fleet_prom_text(fleet))
    return json_path, prom_path
