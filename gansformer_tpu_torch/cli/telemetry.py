"""Telemetry CLI of the port: read a run's, a service's or a fleet's files.

The port's copy of ``gansformer_tpu/cli/telemetry.py``.  It imports
neither torch nor CUDA, so it runs on a host without the card's stack.

  trace       events.jsonl → Chrome-trace JSON (chrome://tracing or
              https://ui.perfetto.dev)
  heartbeats  staleness + step-skew probe over heartbeat-p*.json; exit 1
              when any process is stale, missing or straggling
  summary     per-phase totals from events.jsonl + the telemetry.prom
  requests    the request ledger: per-outcome summary, the p99 exemplar
              (the ``# EXEMPLAR`` line of telemetry.prom names the
              request behind the worst latency), ``--id <rid>`` for one
              request's timeline, ``--worst N`` for the N slowest
  slo         error budgets over the declared objectives (p99 latency,
              availability, shed rate); exit 1 when a budget is spent
  fleet       N processes' telemetry → fleet.json / fleet.prom (counters
              sum, gauges spread, histograms merge; a partial-view marker
              on degraded inputs)
  doctor      one run-health report over all of it: device time against
              the wall clock, MFU, data wait, queues, the data plane,
              numerics, compiles, memory, heartbeats and step skew,
              restarts, the availability section where a supervisor
              ledger exists, the serving, fleet and chaos sections where
              serve telemetry exists, the slo section where served
              traffic is visible.  PASS / WARN / FAIL lines; --json for
              the machine-readable form; exit 0 iff no FAIL.

The doctor grades a run dir of JAX's loop exactly as JAX's doctor does.
One section differs on the port's own run dirs: the port's eager loop
makes no XLA compiles and writes no ``compile/*`` family, so where JAX's
doctor would WARN that the retrace watch never armed, the ``compiles``
check is graded PASS "no counterpart".  A port run dir is told apart by
what it holds: its ``log.txt`` has the loop's ``device: <device>
(<name>), one process`` line (``is_port_run_dir``); JAX's loop writes
its mesh there instead.  The ``hbm`` section reads the gauges the port's
heartbeat writes (``hbm/peak_bytes``, ``hbm/bytes_limit``,
``hbm/unavailable`` on the host) and is graded as JAX's; ``mfu`` reports
"no MFU bookkeeping": the port has no FLOP count.

Examples
--------
  python -m gansformer_tpu_torch.cli.telemetry trace results/00003-run
  python -m gansformer_tpu_torch.cli.telemetry heartbeats \\
      results/00003-run --max-age 120 --expected 4
  python -m gansformer_tpu_torch.cli.telemetry summary results/00003-run
  python -m gansformer_tpu_torch.cli.telemetry requests results/serve \\
      --worst 3
  python -m gansformer_tpu_torch.cli.telemetry slo results/serve \\
      --window 900
  python -m gansformer_tpu_torch.cli.telemetry fleet results/r0 \\
      results/r1 --out-dir results/fleet
  python -m gansformer_tpu_torch.cli.telemetry doctor results/00003-run
  python -m gansformer_tpu_torch.cli.telemetry doctor results \\
      --json-out doctor.json          # picks the latest numbered run
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Dict, List, Optional


def read_events(run_dir: str) -> List[dict]:
    path = os.path.join(run_dir, "events.jsonl")
    if not os.path.exists(path):
        raise SystemExit(f"no events.jsonl under {run_dir} — was the run "
                         f"started with this framework's train loop?")
    out: List[dict] = []
    dropped = 0
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                # a SIGKILL mid-append leaves a torn line; the crashed
                # runs are exactly the ones worth inspecting, so skip it
                dropped += 1
    if dropped:
        print(f"warning: skipped {dropped} torn line(s) in {path}",
              file=sys.stderr)
    return out


def write_chrome_trace(run_dir: str, out: Optional[str] = None) -> str:
    """events.jsonl lines ARE Chrome trace events; the conversion is just
    the enclosing ``{"traceEvents": [...]}`` object."""
    events = read_events(run_dir)
    out = out or os.path.join(run_dir, "trace.json")
    with open(out, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return out


def summarize_events(events: List[dict]) -> List[dict]:
    """Per-phase {name, count, total_ms, mean_ms}, heaviest first."""
    agg: dict = {}
    for ev in events:
        a = agg.setdefault(ev["name"], {"count": 0, "total_ms": 0.0})
        a["count"] += 1
        a["total_ms"] += ev.get("dur", 0.0) / 1000.0
    return sorted(
        ({"name": n, "count": a["count"],
          "total_ms": round(a["total_ms"], 3),
          "mean_ms": round(a["total_ms"] / a["count"], 3)}
         for n, a in agg.items()),
        key=lambda r: -r["total_ms"])


# --- requests -----------------------------------------


def run_requests(run_dir: str, rid: Optional[str] = None,
                 worst: Optional[int] = None) -> int:
    """The ``requests`` subcommand body (returns the exit code).

    Jax-free by construction: everything here reads artifacts through
    ``obs.reqtrace.read_requests`` / ``obs.registry`` parsers — the CLI
    runs on a laptop against an rsync'd run dir."""
    from gansformer_tpu_torch.obs.registry import parse_prom_exemplars
    from gansformer_tpu_torch.obs.reqtrace import (read_requests,
                                                   render_timeline)

    path = os.path.join(run_dir, "requests.jsonl")
    rows = read_requests(path)
    if not rows:
        print(f"no request ledger rows under {run_dir} — was the "
              f"service started with a requests.jsonl ledger "
              f"(configure_reqtrace)?", file=sys.stderr)
        return 1
    if rid is not None:
        hits = [r for r in rows if r.get("rid") == rid]
        if not hits:
            print(f"request {rid!r} not in {path} ({len(rows)} rows) — "
                  f"evicted by the ledger bound, or a different run?",
                  file=sys.stderr)
            return 1
        for row in hits:
            print(render_timeline(row))
        return 0
    if worst is not None:
        ranked = sorted(rows, key=lambda r: -(r.get("e2e_ms") or 0.0))
        for row in ranked[:worst]:
            print(render_timeline(row))
            print()
        return 0
    # default: per-outcome summary + p99 exemplar resolution
    by_outcome: Dict[str, int] = {}
    for r in rows:
        by_outcome[r.get("outcome", "?")] = \
            by_outcome.get(r.get("outcome", "?"), 0) + 1
    done = sorted(float(r.get("e2e_ms") or 0.0) for r in rows
                  if r.get("outcome") == "fulfilled")
    print(f"{len(rows)} request(s): " + ", ".join(
        f"{k}={v}" for k, v in sorted(by_outcome.items())))
    if done:
        p50 = done[len(done) // 2]
        p99 = done[min(int(len(done) * 0.99), len(done) - 1)]
        print(f"fulfilled e2e: p50 {p50:.1f} ms, p99 {p99:.1f} ms, "
              f"max {done[-1]:.1f} ms")
    prom = os.path.join(run_dir, "telemetry.prom")
    if os.path.exists(prom):
        ex = parse_prom_exemplars(prom).get("serve_e2e_ms_max")
        if ex:
            hits = [r for r in rows if r.get("rid") == ex]
            print(f"\np99 exemplar {ex} (serve_e2e_ms_max):")
            if hits:
                print(render_timeline(hits[0]))
            else:
                print(f"  not in the ledger (evicted by the row bound "
                      f"or traced before the ledger was wired)")
    return 0


# --- doctor --------------------------------------------


def read_stats_records(run_dir: str) -> List[dict]:
    """stats.jsonl tick records, torn-line-tolerant (same rationale as
    read_events: crashed runs are the interesting ones)."""
    path = os.path.join(run_dir, "stats.jsonl")
    out: List[dict] = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out


def read_prom_values(run_dir: str) -> Dict[str, float]:
    """A run dir's telemetry.prom → {prom name: value}, empty when the
    file is absent (the parser itself lives with the format's writer,
    ``obs/registry.parse_prom_values``)."""
    path = os.path.join(run_dir, "telemetry.prom")
    if not os.path.exists(path):
        return {}
    from gansformer_tpu_torch.obs.registry import parse_prom_values

    return parse_prom_values(path)


_PORT_DEVICE_LINE = re.compile(r"^device: \S+ \(.*\), one process$")


def is_port_run_dir(run_dir: str) -> bool:
    """A run dir this package's loop wrote: its ``log.txt`` holds the
    loop's ``device: <device> (<name>), one process`` line, which JAX's
    loop never writes (its first line is the mesh)."""
    try:
        with open(os.path.join(run_dir, "log.txt"),
                  errors="replace") as f:
            return any(_PORT_DEVICE_LINE.match(line.rstrip("\n"))
                       for line in f)
    except OSError:
        return False


def resolve_run_dir(path: str) -> str:
    """Accept either a run dir or a results root: when ``path`` has no
    telemetry artifacts but contains numbered run dirs, descend to the
    latest one."""
    if os.path.exists(os.path.join(path, "stats.jsonl")) or \
            os.path.exists(os.path.join(path, "telemetry.prom")):
        return path
    from gansformer_tpu_torch.utils.logging import list_run_dirs

    runs = list_run_dirs(path)
    return runs[-1] if runs else path


class _Tele:
    """Unified accessor over the LAST tick's registry snapshot (from
    stats.jsonl, the rich source) with a telemetry.prom fallback for run
    dirs that died before a full tick record landed.  Lookups use the
    registry's slash names; the prom fallback translates through
    ``prom_name``."""

    def __init__(self, run_dir: str):
        records = read_stats_records(run_dir)
        self.last = records[-1] if records else {}
        self.n_ticks = sum(1 for r in records
                           if "timing/sec_per_tick" in r)
        snap = self.last.get("telemetry", {})
        self.counters = dict(snap.get("counters", {}))
        self.gauges = dict(snap.get("gauges", {}))
        self.histograms = dict(snap.get("histograms", {}))
        self._prom = read_prom_values(run_dir)
        self.have_any = bool(snap) or bool(self._prom)

    def _get(self, table: dict, name: str):
        if name in table:
            return table[name]
        from gansformer_tpu_torch.obs.registry import prom_name

        return self._prom.get(prom_name(name))

    def counter(self, name: str):
        return self._get(self.counters, name)

    def gauge(self, name: str):
        return self._get(self.gauges, name)

    def stat(self, name: str):
        return self.last.get(name)


def _fmt_bytes(n) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} TiB"


def run_doctor(run_dir: str, max_age_s: Optional[float] = None,
               expected: Optional[int] = None,
               max_step_skew: Optional[int] = None,
               now: Optional[float] = None,
               max_restarts_per_hour: float = 6.0,
               max_shed_rate: float = 0.01,
               slo_window_s: float = 3600.0) -> dict:
    """The run-health report as a pure-ish dict (rendered by
    ``render_doctor``; archived verbatim by ``--json``).

    Levels: PASS (healthy / informational), WARN (suspicious — the run
    may still be fine, a human should look), FAIL (the run dir cannot be
    trusted or a liveness contract is broken).  ``ok`` is True iff no
    FAIL — WARNs never fail the doctor, so it is safe in gates that only
    guard against hard breakage (``--json-out`` archives the JSON
    either way)."""
    checks: List[dict] = []

    def check(name: str, level: str, detail: str) -> None:
        checks.append({"name": name, "level": level, "detail": detail})

    # -- artifacts ----------------------------------------------------------
    present = [f for f in ("stats.jsonl", "telemetry.prom", "events.jsonl",
                           "config.json")
               if os.path.exists(os.path.join(run_dir, f))]
    import glob as _glob

    beats_files = _glob.glob(os.path.join(run_dir, "heartbeat-p*.json"))
    if beats_files:
        present.append(f"heartbeat-p*.json x{len(beats_files)}")
    if "stats.jsonl" not in present and "telemetry.prom" not in present:
        check("artifacts", "FAIL",
              f"neither stats.jsonl nor telemetry.prom under {run_dir} — "
              f"not a run dir this framework's loop wrote")
        return {"run_dir": run_dir, "ok": False, "n_warn": 0, "n_fail": 1,
                "checks": checks}
    check("artifacts", "PASS", "found " + ", ".join(present))

    tele = _Tele(run_dir)

    # -- progress -----------------------------------------------------------
    if tele.n_ticks:
        check("progress", "PASS",
              "{} tick(s), kimg {:.1f}, {:.1f} img/s/chip, "
              "sec/tick {:.1f}".format(
                  tele.n_ticks, tele.stat("Progress/kimg") or 0.0,
                  tele.stat("timing/img_per_sec_per_chip") or 0.0,
                  tele.stat("timing/sec_per_tick") or 0.0))
    else:
        check("progress", "WARN",
              "no tick records in stats.jsonl — the run died before its "
              "first tick boundary")

    # -- device truth (wall-vs-device divergence) ---------------------------
    sampler_off = tele.gauge("device/sampler_off")
    samples = tele.counter("device/samples_total") or 0.0
    ratio = tele.gauge("device/wall_busy_ratio")
    if sampler_off == 1.0:
        check("device_truth", "WARN",
              "device-time sampler OFF — wall-clock numbers are "
              "unverified (enable with --device-time-ticks N)")
    elif sampler_off is None and ratio is None:
        check("device_truth", "WARN",
              "no device/* telemetry — run predates the device-truth "
              "layer or never wrote a tick")
    elif not samples or ratio is None:
        unavailable = tele.gauge("device/unavailable")
        check("device_truth", "WARN",
              "sampler on but no device sample landed"
              + (" (no trace parser available)"
                 if unavailable == 1.0 else
                 " yet (run shorter than the sampling cadence?)"))
    elif ratio > 1.1:
        check("device_truth", "WARN",
              f"device busy exceeds sampled wall (ratio {ratio:.2f}) — "
              f"the wall clock is NOT covering device execution (the "
              f"retracted-r3 failure mode); distrust wall-clock numbers")
    elif ratio < 0.25:
        check("device_truth", "WARN",
              f"device busy only {ratio:.0%} of the sampled tick — the "
              f"device is mostly idle (host-bound run); check data_wait "
              f"and dispatch overhead")
    else:
        check("device_truth", "PASS",
              "device busy/wall ratio {:.2f} over {} sample(s) (busy "
              "{:.0f} ms / wall {:.0f} ms)".format(
                  ratio, int(samples), tele.gauge("device/busy_ms") or 0,
                  tele.gauge("device/wall_ms") or 0))

    # -- MFU: device-time beside wall-clock ---------------------------------
    wall_mfu = tele.stat("timing/mfu")
    dev_mfu = tele.gauge("device/mfu")
    if wall_mfu is None and dev_mfu is None:
        check("mfu", "PASS",
              "no MFU bookkeeping (off-TPU or FLOPs unavailable)")
    elif dev_mfu is None:
        check("mfu", "WARN",
              f"wall-clock MFU {wall_mfu:.3f} with NO device-time MFU to "
              f"check it against — the number of record is device-time "
              f"MFU (PERF.md measurement discipline)")
    elif wall_mfu is None:
        check("mfu", "PASS", f"device-time MFU {dev_mfu:.3f}")
    elif abs(wall_mfu - dev_mfu) > 0.25 * max(dev_mfu, 1e-9):
        check("mfu", "WARN",
              f"wall-clock MFU {wall_mfu:.3f} diverges from device-time "
              f"MFU {dev_mfu:.3f} (>25%) — trust the device number")
    else:
        check("mfu", "PASS",
              f"device-time MFU {dev_mfu:.3f} agrees with wall-clock "
              f"{wall_mfu:.3f}")

    # -- input pipeline -----------------------------------------------------
    wait_frac = tele.stat("timing/data_wait_frac")
    if wait_frac is None:
        check("data_wait", "WARN", "no timing/data_wait_frac stat")
    elif wait_frac > 0.25:
        check("data_wait", "WARN",
              f"loop blocked on input {wait_frac:.0%} of the last tick — "
              f"input-bound (decode or transfer, see queue depths)")
    else:
        check("data_wait", "PASS",
              f"data wait {wait_frac:.1%} of the last tick")
    starved = tele.counter("data/starved_total") or 0.0
    depth = tele.gauge("data/prefetch_queue_depth")
    dev_depth = tele.gauge("data/device_queue_depth")
    qdetail = "host queue depth {}, device ring depth {}".format(
        "?" if depth is None else int(depth),
        "?" if dev_depth is None else int(dev_depth))
    if starved > 0:
        check("queues", "WARN",
              f"data/starved_total = {int(starved)} (consumer beat the "
              f"producer); {qdetail}")
    else:
        check("queues", "PASS", f"no starvation; {qdetail}")

    # -- data-plane robustness -----------------------------------
    # Graded only when the data/* robustness family is present (run dirs
    # predating the fault-tolerant data plane just skip the section):
    # FAIL on a stall-kill or a corrupt-frac budget breach, WARN on any
    # quarantines/retries (the run survived, a human should know), PASS
    # on clean counters.
    # Counters reset per PROCESS (a resumed run starts a fresh
    # registry), so the last tick's snapshot under-reports anything that
    # happened before a restart — e.g. a read retry absorbed just
    # before a crash.  The stats.jsonl records are append-only across
    # restarts: take the max over every tick's snapshot, falling back
    # to the live accessor for dirs that died before a tick landed.
    _data_records = read_stats_records(run_dir)   # one read for all three

    def _max_counter(name):
        seen = [r["telemetry"]["counters"][name]
                for r in _data_records
                if name in r.get("telemetry", {}).get("counters", {})]
        live = tele.counter(name)
        if live is not None:
            seen.append(live)
        return max(seen) if seen else None

    d_corrupt = _max_counter("data/corrupt_records_total")
    d_retries = _max_counter("data/read_retries_total")
    d_stalls = _max_counter("data/stalls_total")
    d_frac = tele.gauge("data/corrupt_frac")
    d_budget = tele.gauge("data/corrupt_budget_frac")
    if any(v is not None for v in (d_corrupt, d_retries, d_stalls)):
        n_ledger = 0
        ledger = os.path.join(run_dir, "data_quarantine.jsonl")
        if os.path.exists(ledger):
            with open(ledger) as f:
                n_ledger = sum(1 for line in f if line.strip())
        dbits = ("{} quarantined record(s) ({} ledger line(s)), {} read "
                 "retr{}, corrupt frac {}".format(
                     int(d_corrupt or 0), n_ledger, int(d_retries or 0),
                     "y" if int(d_retries or 0) == 1 else "ies",
                     "?" if d_frac is None else f"{d_frac:.2%}"
                     + ("" if d_budget is None
                        else f" of {d_budget:.2%} budget")))
        if d_stalls:
            check("data_plane", "FAIL",
                  f"data stall watchdog fired {int(d_stalls)} time(s) — "
                  f"the input pipeline wedged (DataStalled); {dbits}")
        elif d_frac is not None and d_budget is not None and \
                d_frac > d_budget:
            check("data_plane", "FAIL",
                  f"corrupt-record fraction {d_frac:.2%} exceeds the "
                  f"{d_budget:.2%} budget — the run exits typed "
                  f"data-corrupt (static defect; fix the dataset, not "
                  f"the restart count); {dbits}")
        elif (d_corrupt or 0) > 0 or (d_retries or 0) > 0:
            check("data_plane", "WARN",
                  f"data plane degraded but within budget — {dbits}")
        else:
            check("data_plane", "PASS",
                  f"no quarantines, retries, or stalls; {dbits}")

    # -- numerics cross-check ------------------------------------
    # The runtime twin of graftnum's static fp32-island audit: the loop
    # classifies any non-finite tick stat by cause (loss/grad/param) on
    # already-fetched host values.  Graded only when the family is
    # present (older run dirs skip); nonzero is a WARN, never a FAIL —
    # the loop kept running, a human decides whether the run is dead.
    nf_total = _max_counter("train/nonfinite_total")
    if nf_total is not None:
        if nf_total > 0:
            causes = ", ".join(
                f"{c}={int(_max_counter(f'train/nonfinite_{c}_total') or 0)}"
                for c in ("loss", "grad", "param"))
            check("numerics", "WARN",
                  f"{int(nf_total)} non-finite tick stat(s) reached the "
                  f"host ({causes}) — cross-check the fp32-island audit "
                  f"(gansformer-lint --trace) and consider "
                  f"train.debug_nans for op-level localization")
        else:
            check("numerics", "PASS",
                  "no non-finite tick stats (loss/grad/param all clean)")

    # -- compiles / retraces ------------------------------------------------
    compiles = tele.counter("compile/compiles_total")
    retraces = tele.counter("compile/retraces_total")
    if retraces is None and is_port_run_dir(run_dir):
        check("compiles", "PASS",
              "no counterpart: the port's eager loop makes no XLA "
              "compiles and writes no compile/* family (a port run dir: "
              "log.txt holds its device line)")
    elif retraces is None:
        check("compiles", "WARN",
              "no compile/retraces_total — the retrace watch never "
              "armed (run died before its first tick boundary?)")
    elif retraces > 0:
        check("compiles", "WARN",
              f"{int(retraces)} post-warm-up compile(s) (retraces) — "
              f"equivalent work re-entering the compiler mid-run "
              f"(caveat: the first in-loop metric sweep compiles lazily "
              f"and shows as a one-time jump)")
    else:
        check("compiles", "PASS",
              "0 retraces ({} warm-up compile(s))".format(
                  "?" if compiles is None else int(compiles)))

    # -- HBM ----------------------------------------------------------------
    hbm_unavail = tele.gauge("hbm/unavailable")
    peak = tele.gauge("hbm/peak_bytes")
    limit = tele.gauge("hbm/bytes_limit")
    if hbm_unavail == 1.0:
        check("hbm", "PASS",
              "backend reports no memory stats (CPU) — hbm/* marked "
              "unavailable")
    elif peak is None:
        check("hbm", "WARN", "no hbm/* telemetry in the run dir")
    elif limit and peak / limit > 0.92:
        check("hbm", "WARN",
              f"peak HBM {_fmt_bytes(peak)} is {peak / limit:.0%} of the "
              f"{_fmt_bytes(limit)} limit — one allocation from OOM")
    else:
        check("hbm", "PASS",
              f"peak HBM {_fmt_bytes(peak)}"
              + (f" of {_fmt_bytes(limit)} ({peak / limit:.0%})"
                 if limit else ""))

    # -- heartbeats: staleness + step skew ----------------------------------
    from gansformer_tpu_torch.obs.heartbeat import check_heartbeats

    hb = check_heartbeats(
        run_dir, max_age_s=max_age_s if max_age_s is not None else 1e18,
        expected=list(range(expected)) if expected is not None else None,
        now=now, max_step_skew=max_step_skew)
    if hb["stale"] or hb["missing"]:
        # missing peers (via --expected) must outrank the softer
        # "no files" verdict: a fully-dead run is worse, not better,
        # than a partially-dead one
        check("heartbeats", "FAIL",
              "stale processes {}, missing {}{} — babysitter should "
              "restart".format(
                  hb["stale"], hb["missing"],
                  f" (max age {max_age_s}s)"
                  if max_age_s is not None else ""))
    elif not hb["ages"]:
        check("heartbeats", "WARN", "no heartbeat files")
    else:
        age = max(hb["ages"].values())
        check("heartbeats", "PASS",
              f"{len(hb['ages'])} process(es), last beat {age:.0f}s ago"
              + ("" if max_age_s is not None
                 else " (no --max-age given: staleness not judged)"))
    if len(hb.get("steps", {})) > 1:
        if hb["skew_exceeded"]:
            check("step_skew", "WARN",
                  f"inter-process step skew {hb['step_skew']} > "
                  f"{max_step_skew} — straggler (one process lags the "
                  f"collectives); steps: {hb['steps']}")
        else:
            check("step_skew", "PASS",
                  f"inter-process step skew {hb['step_skew']}"
                  + ("" if max_step_skew is not None
                     else " (no --max-skew given: not judged)"))

    # -- restarts / availability (supervisor ledger) ------------------------
    # supervisor_events.jsonl (supervise/events.py) supersedes the bare
    # resumes.jsonl: exit CAUSES, downtime, and restart counts.  When the
    # ledger exists the availability section grades it — restart storms,
    # unclassified exits, a give-up verdict, the availability ratio;
    # otherwise the legacy resumes.jsonl count is reported as before.
    from gansformer_tpu_torch.supervise import events as sup_events
    from gansformer_tpu_torch.utils.logging import read_resume_records

    sup = sup_events.read_events(run_dir)
    if sup:
        s = sup_events.availability(sup, now=now)
        ratio = ("" if s["ratio"] is None
                 else f", availability {s['ratio']:.1%} "
                      f"(up {s['uptime_s']:.0f}s / down "
                      f"{s['downtime_s']:.0f}s)")
        causes = ", ".join(f"{k}x{v}" for k, v in
                           sorted(s["causes"].items())) or "none"
        summary = (f"{s['restarts']} restart(s), exits: {causes}{ratio}")
        if s["gave_up"]:
            nr = sorted(set(s["causes"])
                        & set(sup_events.NON_RETRYABLE_CAUSES))
            check("availability", "FAIL",
                  (f"supervisor gave up on non-retryable cause(s) "
                   f"{', '.join(nr)} (static defect — fix the dataset, "
                   f"not the restart count) — {summary}" if nr else
                   f"supervisor GAVE UP (restart budget exhausted) — "
                   f"{summary}; the run needs a human"))
        elif s["unclassified"]:
            check("availability", "WARN",
                  f"unclassified exit cause(s) {s['unclassified']} in "
                  f"the ledger — the supervisor's vocabulary rotted or "
                  f"the file was hand-edited; {summary}")
        elif s["restarts_last_hour"] > max_restarts_per_hour:
            check("availability", "WARN",
                  f"restart storm: {s['restarts_last_hour']} restart(s) "
                  f"in the last hour (> {max_restarts_per_hour:g}) — "
                  f"the run is thrashing, not training; {summary}")
        else:
            check("availability", "PASS", summary)
    resumes = read_resume_records(run_dir)
    if resumes:
        check("restarts", "PASS",
              f"{len(resumes)} restart(s); last resumed at step "
              f"{resumes[-1].get('step', '?')}")
    else:
        check("restarts", "PASS", "no restarts recorded")

    # -- serving -------------------------------------------------
    # Graded only when serve/* telemetry is present (a service's
    # telemetry.prom, or a run dir a load test wrote into): FAIL on a
    # tripped circuit breaker or a dispatcher dead with work queued,
    # WARN on shed rate > max_shed_rate or a saturated admission queue.
    from gansformer_tpu_torch.cli.serve import (
        serve_dead_with_work, serve_fleet_dead_with_work,
        serve_replica_ordinals)
    from gansformer_tpu_torch.obs.registry import prom_name

    serve_health = tele.gauge("serve/health_state")
    serve_reqs = tele.counter("serve/requests_total")
    chaos_path = os.path.join(run_dir, "serve_chaos.json")
    chaos_present = os.path.exists(chaos_path)
    if serve_health is not None or serve_reqs is not None:
        alive = tele.gauge("serve/dispatcher_alive")
        depth = tele.gauge("serve/queue_depth_now") or 0.0
        bound = tele.gauge("serve/queue_bound")
        s_restarts = tele.counter("serve/dispatcher_restarts_total") or 0.0
        shed = tele.counter("serve/shed_total") or 0.0
        reqs = serve_reqs or 0.0
        shed_rate = shed / max(shed + reqs, 1.0)
        bits = ("{} request(s), shed {} ({:.1%}), {} dispatcher "
                "restart(s), queue {}/{}".format(
                    int(reqs), int(shed), shed_rate, int(s_restarts),
                    int(depth), "?" if bound is None else int(bound)))
        if serve_health == 2.0:
            check("serving", "FAIL",
                  f"service UNHEALTHY (circuit breaker tripped or "
                  f"failed drain) — needs a restart; {bits}")
        elif serve_dead_with_work(alive, depth):
            check("serving", "FAIL",
                  f"dispatcher dead with {int(depth)} request(s) still "
                  f"queued — tickets are hung; {bits}")
        elif shed_rate > max_shed_rate and not chaos_present:
            # a serve_chaos.json beside the telemetry means the
            # overload was DELIBERATELY driven — shedding is the drill
            # working, not a capacity alarm
            check("serving", "WARN",
                  f"shed rate {shed_rate:.1%} > {max_shed_rate:.0%} — "
                  f"sustained overload (scale out or raise the queue "
                  f"bound); {bits}")
        elif bound and depth >= bound:
            check("serving", "WARN",
                  f"admission queue saturated — the next submit sheds; "
                  f"{bits}")
        else:
            check("serving", "PASS",
                  bits
                  + (" (overload deliberately driven — chaos drill)"
                     if chaos_present and shed_rate > max_shed_rate
                     else "")
                  + (" (degraded)" if serve_health == 1.0 else "")
                  + (" (closed cleanly)" if serve_health == 3.0
                     else ""))

    # -- serve fleet ---------------------------------------------
    # Graded only when the replica-per-device layer is visible
    # (serve/replicas gauge): the fleet families — per-replica health
    # gauges, scale-out/in counters — must be PRESENT (their absence
    # means replica attribution rotted while the fleet gauge survived),
    # and a replica's traffic must come with its latency samples
    # (images without batch_ms is half-wired attribution).  FAIL only
    # when the whole fleet is dead with work queued — everything else
    # is WARN: the fleet serves as long as SOME replica can.
    n_replicas = tele.gauge("serve/replicas")
    if n_replicas is not None:
        vals = dict(tele._prom)
        for k, v in list(tele.counters.items()) + list(tele.gauges.items()):
            vals.setdefault(prom_name(k), v)
        for k, h in tele.histograms.items():
            if isinstance(h, dict) and "count" in h:
                vals.setdefault(prom_name(k) + "_count", h["count"])
        ordinals = serve_replica_ordinals(vals)
        outs = vals.get("serve_scale_out_total")
        ins = vals.get("serve_scale_in_total")
        alive_n = sum(
            1 for i in ordinals
            if vals.get(f"serve_replica{i}_dispatcher_alive", 0.0) > 0)
        fbits = ("{} active replica(s) (ordinals {}), {} alive, "
                 "scale-out {} / scale-in {}".format(
                     int(n_replicas), ordinals or "none", alive_n,
                     "?" if outs is None else int(outs),
                     "?" if ins is None else int(ins)))
        missing = [f"serve_replica{i}_{fam}" for i in ordinals
                   for fam in ("health_state", "dispatcher_alive",
                               "queue_depth_now", "requests_total")
                   if f"serve_replica{i}_{fam}" not in vals]
        unsampled = [i for i in ordinals
                     if vals.get(f"serve_replica{i}_images_total", 0.0) > 0
                     and vals.get(f"serve_replica{i}_batch_ms_count",
                                  0.0) <= 0]
        if serve_fleet_dead_with_work(vals):
            check("serve_fleet", "FAIL",
                  f"every replica's dispatcher is dead with work still "
                  f"queued — the fleet hangs its tickets; {fbits}")
        elif not ordinals:
            check("serve_fleet", "WARN",
                  f"serve/replicas present but no serve/replica<i>/* "
                  f"member families — per-replica attribution rotted; "
                  f"{fbits}")
        elif missing or outs is None or ins is None:
            check("serve_fleet", "WARN",
                  f"fleet families incomplete — missing "
                  f"{missing or 'scale counters'}; {fbits}")
        elif unsampled:
            check("serve_fleet", "WARN",
                  f"replica(s) {unsampled} served images with ZERO "
                  f"batch_ms samples — traffic without latency "
                  f"attribution; {fbits}")
        else:
            check("serve_fleet", "PASS", fbits)

    # chaos/loadtest artifacts beside the telemetry, when present
    if chaos_present:
        try:
            with open(chaos_path) as f:
                chaos = json.load(f)
        except ValueError:
            chaos = None
        if not isinstance(chaos, dict):
            check("serve_chaos", "WARN",
                  "serve_chaos.json present but not a JSON object")
        else:
            cbits = ("shed {:.1%}, expired {:.1%}, p99-under-overload "
                     "{} ms, {} restart(s), recovery {} ms".format(
                         chaos.get("shed_rate", 0.0),
                         chaos.get("expired_rate", 0.0),
                         chaos.get("p99_ms_under_overload"),
                         int(chaos.get("dispatcher_restarts", 0)),
                         chaos.get("recovery_ms")))
            chaos_state = (chaos.get("health") or {}).get("state")
            if chaos.get("hung_tickets", 0):
                check("serve_chaos", "FAIL",
                      f"{chaos['hung_tickets']} HUNG ticket(s) in the "
                      f"chaos drill — a recovery path leaks requests; "
                      f"{cbits}")
            elif chaos_state == "unhealthy":
                # the drill's own health snapshot (its prom may live in
                # a separate file the telemetry accessor never reads)
                check("serve_chaos", "FAIL",
                      f"chaos drill left the service UNHEALTHY "
                      f"(breaker tripped / failed drain) — "
                      f"{(chaos.get('health') or {}).get('reasons')}; "
                      f"{cbits}")
            elif chaos.get("crash_at_batch") and \
                    chaos.get("dispatcher_restarts", 0) < 1:
                check("serve_chaos", "WARN",
                      f"chaos drill recorded no dispatcher restart — "
                      f"the injected crash never fired; {cbits}")
            else:
                check("serve_chaos", "PASS", cbits)
            # the autoscaler drill's ordering evidence:
            # scale-out (the LEADING saturation signal) must beat any
            # breaker trip (the trailing one), and scale-in must follow
            # recovery.  A controller that misbehaves under a DRILL is
            # a WARN, never a FAIL — the floor still served (hung
            # tickets and health already graded above).
            asc = chaos.get("autoscale")
            if isinstance(asc, dict) and asc.get("enabled"):
                abits = ("scale-out x{} / scale-in x{}, breaker "
                         "trip(s) {}, peak {} replica(s)".format(
                             asc.get("scale_out_fired", 0),
                             asc.get("scale_in_fired", 0),
                             asc.get("breaker_trips", 0),
                             asc.get("peak_replicas")))
                if not asc.get("scale_out_fired"):
                    check("serve_autoscale", "WARN",
                          f"controller never scaled out under the "
                          f"burst — saturation threshold or tick "
                          f"cadence miscalibrated for the drill; "
                          f"{abits}")
                elif not asc.get("scale_out_before_breaker"):
                    check("serve_autoscale", "WARN",
                          f"breaker tripped BEFORE the first scale-out "
                          f"— the controller reacted on the trailing "
                          f"signal, not the leading one; {abits}")
                elif not asc.get("scaled_in_after_load"):
                    check("serve_autoscale", "WARN",
                          f"no scale-in after recovery — the fleet "
                          f"stays scaled out (cost leak, not an "
                          f"outage); {abits}")
                else:
                    check("serve_autoscale", "PASS", abits)

    # -- SLO error budgets ---------------------------------------
    # Graded only when served traffic is visible (a requests.jsonl
    # ledger or serve/* counters) — train-only run dirs skip the
    # section.  FAIL on an exhausted error budget; under a chaos drill
    # the spend is deliberate, so the section reports informationally
    # instead of failing the doctor on its own fault injection.
    from gansformer_tpu_torch.obs.slo import evaluate_slos

    slo_rep = evaluate_slos(run_dir, window_s=slo_window_s, now=now)
    slo_graded = [o for o in slo_rep["objectives"]
                  if o["status"] != "no_data"]
    if slo_graded:
        sbits = "; ".join(
            "{}: {:.2%} of target {:.1%} (burn {:g})".format(
                o["name"], o["compliance"], o["target"], o["burn_rate"])
            for o in slo_graded)
        sbits += (f" [{slo_rep['source']}"
                  + (f", {slo_rep['rows']} row(s) in "
                     f"{slo_rep['window_s']:g}s window"
                     if slo_rep["source"] == "ledger" else "")
                  + "]")
        if slo_rep["exhausted"] and chaos_present:
            check("slo", "PASS",
                  f"budget(s) {slo_rep['exhausted']} spent under a "
                  f"DELIBERATE chaos drill — not a capacity verdict; "
                  f"{sbits}")
        elif slo_rep["exhausted"]:
            check("slo", "FAIL",
                  f"error budget EXHAUSTED for "
                  f"{', '.join(slo_rep['exhausted'])} — the service is "
                  f"out of its declared objective; {sbits}")
        else:
            check("slo", "PASS", sbits)

    # -- device phase table (informational) ---------------------------------
    phase_ms = sorted(((k.split("/", 2)[2], v)
                       for k, v in tele.gauges.items()
                       if k.startswith("device/phase_ms/")),
                      key=lambda kv: -kv[1])
    if phase_ms:
        check("device_phases", "PASS",
              "device ms (last sampled tick): " + ", ".join(
                  f"{n}={v:.0f}" for n, v in phase_ms[:8]))

    n_warn = sum(1 for c in checks if c["level"] == "WARN")
    n_fail = sum(1 for c in checks if c["level"] == "FAIL")
    return {"run_dir": run_dir, "ok": n_fail == 0,
            "n_warn": n_warn, "n_fail": n_fail, "checks": checks}


def render_doctor(report: dict) -> str:
    lines = [f"run doctor: {report['run_dir']}"]
    for c in report["checks"]:
        lines.append(f"  {c['level']:<4s} {c['name']}: {c['detail']}")
    lines.append("verdict: {} ({} warn, {} fail)".format(
        "OK" if report["ok"] else "NOT OK",
        report["n_warn"], report["n_fail"]))
    return "\n".join(lines)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("trace", help="events.jsonl → Chrome trace JSON")
    t.add_argument("run_dir")
    t.add_argument("--out", default=None,
                   help="output path (default <run_dir>/trace.json)")

    h = sub.add_parser("heartbeats", help="multi-host staleness probe")
    h.add_argument("run_dir")
    h.add_argument("--max-age", type=float, default=300.0,
                   help="seconds before a heartbeat counts as stale")
    h.add_argument("--expected", type=int, default=None,
                   help="expected process count (detects missing peers)")
    h.add_argument("--max-skew", type=int, default=None,
                   help="max inter-process step skew before the probe "
                        "fails (straggler detection)")

    s = sub.add_parser("summary", help="phase totals + current telemetry")
    s.add_argument("run_dir")

    r = sub.add_parser("requests",
                       help="request ledger: summary / timelines / p99 "
                            "exemplar resolution")
    r.add_argument("run_dir")
    r.add_argument("--id", dest="rid", default=None, metavar="RID",
                   help="render one request's full timeline")
    r.add_argument("--worst", type=int, default=None, metavar="N",
                   help="render the N slowest requests' timelines")

    o = sub.add_parser("slo", help="error budgets over the declared "
                                   "objectives (exit 1 when a budget "
                                   "is exhausted)")
    o.add_argument("run_dir")
    o.add_argument("--window", type=float, default=3600.0,
                   help="rolling window in seconds over the request "
                        "ledger (default 3600)")
    o.add_argument("--json", action="store_true",
                   help="print the machine-readable report")

    fl = sub.add_parser("fleet",
                        help="aggregate N processes' telemetry into "
                             "fleet.json / fleet.prom")
    fl.add_argument("run_dirs", nargs="+",
                    help="ONE shared run dir (heartbeat-p*.json roster) "
                         "or several per-process run dirs")
    fl.add_argument("--expected", type=int, default=None,
                    help="expected process count (missing processes "
                         "mark the view partial)")
    fl.add_argument("--max-age", type=float, default=None,
                    help="heartbeats older than this many seconds mark "
                         "the view partial")
    fl.add_argument("--out-dir", default=None, metavar="DIR",
                    help="write fleet.json + fleet.prom under DIR "
                         "(default: print the JSON to stdout only)")

    d = sub.add_parser("doctor", help="one-shot run-health report "
                                      "(PASS/WARN/FAIL; exit 0 iff no "
                                      "FAIL)")
    d.add_argument("run_dir",
                   help="run dir, or a results root (picks the latest "
                        "numbered run)")
    d.add_argument("--json", action="store_true",
                   help="print the machine-readable report instead of "
                        "the rendered one")
    d.add_argument("--json-out", default=None, metavar="PATH",
                   help="also write the JSON report to PATH (the "
                        "run's record)")
    d.add_argument("--max-age", type=float, default=None,
                   help="judge heartbeat staleness against this many "
                        "seconds (stale → FAIL); default: report only")
    d.add_argument("--expected", type=int, default=None,
                   help="expected process count (missing peers → FAIL)")
    d.add_argument("--max-skew", type=int, default=None,
                   help="judge inter-process step skew against this "
                        "threshold (exceeded → WARN); default: report "
                        "only")
    d.add_argument("--max-restarts-hour", type=float, default=6.0,
                   help="restart-storm threshold for the availability "
                        "section (supervisor ledger restarts in the "
                        "last hour above this → WARN)")
    d.add_argument("--max-shed-rate", type=float, default=0.01,
                   help="serving-section shed-rate threshold (above "
                        "this → WARN)")
    d.add_argument("--slo-window", type=float, default=3600.0,
                   help="rolling window in seconds for the slo "
                        "section's ledger-based budgets")

    args = p.parse_args(argv)

    if args.cmd == "trace":
        out = write_chrome_trace(args.run_dir, args.out)
        print(f"wrote {out} — open in chrome://tracing or "
              f"https://ui.perfetto.dev")
    elif args.cmd == "heartbeats":
        from gansformer_tpu_torch.obs.heartbeat import check_heartbeats

        expected = (list(range(args.expected))
                    if args.expected is not None else None)
        result = check_heartbeats(args.run_dir, max_age_s=args.max_age,
                                  expected=expected,
                                  max_step_skew=args.max_skew)
        print(json.dumps(result))
        if not result["ok"]:
            sys.exit(1)
    elif args.cmd == "doctor":
        run_dir = resolve_run_dir(args.run_dir)
        report = run_doctor(run_dir, max_age_s=args.max_age,
                            expected=args.expected,
                            max_step_skew=args.max_skew,
                            max_restarts_per_hour=args.max_restarts_hour,
                            max_shed_rate=args.max_shed_rate,
                            slo_window_s=args.slo_window)
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump(report, f, indent=1, sort_keys=True)
                f.write("\n")
        if args.json:
            print(json.dumps(report, indent=1, sort_keys=True))
        else:
            print(render_doctor(report))
        if not report["ok"]:
            sys.exit(1)
    elif args.cmd == "requests":
        sys.exit(run_requests(args.run_dir, rid=args.rid,
                              worst=args.worst))
    elif args.cmd == "slo":
        from gansformer_tpu_torch.obs.slo import evaluate_slos, render_slos

        report = evaluate_slos(args.run_dir, window_s=args.window)
        if args.json:
            print(json.dumps(report, indent=1, sort_keys=True))
        else:
            print(render_slos(report))
        if report["exhausted"]:
            sys.exit(1)
    elif args.cmd == "fleet":
        from gansformer_tpu_torch.obs.aggregate import (aggregate_fleet,
                                                        write_fleet)

        target = (args.run_dirs[0] if len(args.run_dirs) == 1
                  else args.run_dirs)
        fleet = aggregate_fleet(target, expected=args.expected,
                                max_age_s=args.max_age)
        if args.out_dir:
            json_path, prom_path = write_fleet(fleet, args.out_dir)
            print(f"wrote {json_path} and {prom_path}"
                  + (" (PARTIAL view: "
                     + "; ".join(fleet["partial_reasons"]) + ")"
                     if fleet["partial"] else ""))
        else:
            print(json.dumps(fleet, indent=1, sort_keys=True))
    elif args.cmd == "summary":
        for row in summarize_events(read_events(args.run_dir)):
            print("{name:<28s} n={count:<6d} total {total_ms:>10.1f} ms  "
                  "mean {mean_ms:>8.2f} ms".format(**row))
        prom = os.path.join(args.run_dir, "telemetry.prom")
        if os.path.exists(prom):
            print("\n-- telemetry.prom --")
            sys.stdout.write(open(prom).read())


if __name__ == "__main__":
    main()
