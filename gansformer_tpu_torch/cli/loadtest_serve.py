"""Load and chaos tests of the generation service (the port's
counterpart of ``scripts/loadtest_serve.py``).

The load run draws seeds from a bounded Zipf distribution (a few hot
seeds and a long tail, the w cache's prey) and psi from a small Zipf-
weighted menu, with open-loop Poisson arrivals at ``--rate``.  It
reports p50 / p90 / p99 end-to-end latency, images/s, batch fill, the w
cache's hit rate, the queue depth and the cold and warm first-image
times.  The chaos run (``--chaos``) bursts ``--burst-factor`` ×
``--queue-depth`` requests back to back into the bounded queue with one
injected dispatcher crash (``raise@serve_dispatch`` at
``--crash-at-batch``), then sends a recovery wave one request at a time
(JAX's drill paces it 2 ms apart, which on a slow batch can put every
request after the crash into the crashed batch); it reports the
shed and expired rates, p50 / p99 under overload, the dispatcher
restarts, the recovery time and the hung tickets (which must be 0).

The script exits 0 whenever the JSON artifact is written: verdicts live
in the artifact (``prom_ok``, ``hung_tickets``, ``trace_coverage``),
never in the exit code.  Counts and means of the registry are taken as
differences over the run, since the registry is process-global.

    python -m gansformer_tpu_torch.cli.loadtest_serve --tiny --device cpu \\
        --requests 64 --json-out out.json
    python -m gansformer_tpu_torch.cli.loadtest_serve --preset \\
        ffhq256-duplex --requests 300 --rate 100 --json-out load.json
    python -m gansformer_tpu_torch.cli.loadtest_serve --tiny --device cpu \\
        --chaos --queue-depth 8 --json-out chaos.json

``--replicas`` above 1, ``--max-replicas`` and ``--autoscale`` come with
the replica fleet (ROADMAP A.4c) and are refused with words.  Runs on
the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time
from typing import List, Optional


def percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile of an already sorted list."""
    if not sorted_vals:
        return float("nan")
    i = max(0, min(len(sorted_vals) - 1,
                   int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return float(sorted_vals[i])


def zipf_choice(rng, universe, size, s: float):
    """Bounded ranked-Zipf draw: p(rank i) ∝ 1 / (i + 1)^s."""
    import numpy as np

    p = 1.0 / np.arange(1, len(universe) + 1, dtype=np.float64) ** s
    return rng.choice(universe, size=size, p=p / p.sum())


def trace_coverage_of(tickets):
    """Terminal trace coverage of a ticket list: (coverage, rid → its
    terminal row)."""
    from gansformer_tpu_torch.obs import reqtrace

    rt = reqtrace.get_reqtracer()
    rids = [t.rid for t in tickets if getattr(t, "rid", None)]
    terminal_rows = {r["rid"]: r for r in rt.recent()}
    missing = [r for r in rids if r not in terminal_rows]
    return ({"enabled": rt.enabled, "tickets": len(rids),
             "terminal": sum(1 for r in rids if r in terminal_rows),
             "missing_terminal_rids": missing,
             "ok": not rt.enabled or not missing}, terminal_rows)


def device_info(programs) -> dict:
    import torch

    dev = programs.device
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": torch.cuda.device_count()}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def _delta(snap0, snap1, kind: str, name: str, key: str = None) -> float:
    a, b = snap0[kind].get(name, {}), snap1[kind].get(name, {})
    if key is None:
        return (b or 0.0) - (a or 0.0)
    return (b.get(key) or 0.0) - (a.get(key) or 0.0)


def run_chaos(bundle, buckets, queue_depth=8, burst_factor=4,
              crash_at_batch=2, deadline_s=None, zipf_s=1.1,
              seed_universe=64, manifest_dir=None, fill_wait_ms=0.0,
              wcache=4096, seed=0, restart_backoff_s=0.05,
              grace_s=60.0, serve_precision="f32"):
    """The overload drill: ``burst_factor × queue_depth`` requests back
    to back into a bounded queue, with one injected dispatcher crash at
    batch ``crash_at_batch``, then a recovery wave of ``queue_depth``
    requests, each sent when the one before it has settled.  Returns the artifact (shed / expired /
    cancelled counts and rates, p50 / p99 of the burst's served tickets,
    restarts, recovery time, hung tickets, trace coverage, health)."""
    import numpy as np

    from gansformer_tpu_torch.obs import registry as telemetry
    from gansformer_tpu_torch.serve import (Cancelled, Expired,
                                            GenerationService, Overloaded,
                                            ServeError, ServePrograms)
    from gansformer_tpu_torch.supervise import faults

    rng = np.random.RandomState(seed)
    programs = ServePrograms(bundle, buckets=buckets,
                             manifest_dir=manifest_dir,
                             serve_precision=serve_precision)
    warm = programs.warm_start()
    n_req = int(burst_factor * queue_depth)
    seeds = zipf_choice(rng, np.arange(1, seed_universe + 1), n_req,
                        zipf_s)
    reg = telemetry.get_registry()
    restarts0 = reg.counter("serve/dispatcher_restarts_total").value
    tickets, shed, refused = [], 0, 0
    outcomes = {"served": 0, "failed": 0, "expired": 0, "cancelled": 0,
                "hung": 0}

    def settle(wave, deadline):
        # one wall-clock budget per wave, not grace_s per ticket
        for t in wave:
            try:
                t.result(timeout=max(0.1, deadline - time.perf_counter()))
                outcomes["served"] += 1
            except Expired:
                outcomes["expired"] += 1
            except Cancelled:
                outcomes["cancelled"] += 1
            except TimeoutError:
                outcomes["hung"] += 1
            except RuntimeError:
                outcomes["failed"] += 1

    t0 = time.perf_counter()
    svc = None
    try:
        # armed inside the try that disarms it
        if crash_at_batch:
            faults.arm(faults.parse_specs(
                f"raise@serve_dispatch:batch={int(crash_at_batch)}"))
        svc = GenerationService(
            programs, max_fill_wait_ms=fill_wait_ms,
            wcache_capacity=wcache, max_queue_depth=queue_depth,
            default_deadline_s=deadline_s,
            restart_backoff_base_s=restart_backoff_s)
        for i in range(n_req):
            try:
                tickets.append(svc.submit(int(seeds[i])))
            except Overloaded:
                shed += 1
            except ServeError:
                refused += 1
        settle(tickets, time.perf_counter() + grace_s)
        # the recovery wave, one request at a time: every request is a
        # batch of its own, so the crash fires even when the burst fits
        # one bucket, and requests follow it to measure the service after
        # it (requests paced a few ms apart would queue behind a slow
        # batch and could all land in the crashed one)
        recovery_wave = []
        n_wave2 = max(2, int(queue_depth))
        deadline = time.perf_counter() + grace_s
        for i in range(n_wave2):
            try:
                recovery_wave.append(
                    svc.submit(int(seeds[i % n_req]) + seed_universe))
            except Overloaded:
                shed += 1
            except ServeError:
                refused += 1
            else:
                settle(recovery_wave[-1:], deadline)
        burst_tickets = list(tickets)
        tickets += recovery_wave
        recovered = sum(1 for t in recovery_wave if t.state == "done")
        health = svc.health()
    finally:
        if svc is not None:
            svc.close(timeout=grace_s)
        faults.disarm()
    wall_s = time.perf_counter() - t0
    trace_coverage, terminal_rows = trace_coverage_of(tickets)
    non_fulfilled = [
        {"rid": t.rid, "state": t.state,
         "outcome": (terminal_rows.get(t.rid) or {}).get("outcome"),
         "cause": (terminal_rows.get(t.rid) or {}).get("cause")}
        for t in tickets if getattr(t, "rid", None) and t.state != "done"]
    # recovery: the first completion after the first failure
    fails = [t.t_done for t in tickets
             if t.state == "failed" and t.t_done is not None]
    servs = sorted(t.t_done for t in tickets
                   if t.state == "done" and t.t_done is not None)
    recovery_ms = None
    if fails:
        after = [s for s in servs if s > min(fails)]
        if after:
            recovery_ms = round((after[0] - min(fails)) * 1000.0, 1)
    # the burst's served tickets only: "under overload"
    lats = sorted(t.latency_ms for t in burst_tickets if t.state == "done")
    submitted = n_req + n_wave2
    return {
        "mode": "chaos", "buckets": list(buckets),
        "queue_bound": queue_depth, "burst_factor": burst_factor,
        "crash_at_batch": crash_at_batch, "deadline_s": deadline_s,
        "serve_precision": serve_precision, "replicas": 1,
        "submitted": submitted, "burst": n_req,
        "accepted": len(tickets), "shed": shed,
        "refused_unhealthy": refused,
        "shed_rate": round(shed / max(submitted, 1), 4),
        "recovery_wave_served": recovered,
        "served": outcomes["served"], "failed": outcomes["failed"],
        "expired": outcomes["expired"],
        "expired_rate": round(outcomes["expired"] / max(submitted, 1), 4),
        "cancelled": outcomes["cancelled"],
        "hung_tickets": outcomes["hung"],
        "p50_ms_under_overload":
            round(percentile(lats, 50), 2) if lats else None,
        "p99_ms_under_overload":
            round(percentile(lats, 99), 2) if lats else None,
        "dispatcher_restarts":
            reg.counter("serve/dispatcher_restarts_total").value
            - restarts0,
        "trace_coverage": trace_coverage,
        "non_fulfilled_requests": non_fulfilled,
        "recovery_ms": recovery_ms,
        "health": health,
        "warm_start": {k: (round(v, 3) if k == "seconds" else v)
                       for k, v in warm.items()},
        "duration_s": round(wall_s, 3),
        "device": device_info(programs),
    }


def run_loadtest(bundle, buckets, requests, rate, duration_s,
                 zipf_s=1.1, seed_universe=512, manifest_dir=None,
                 psis=(0.7, 0.5, 1.0, 0.8), fill_wait_ms=2.0,
                 wcache=4096, seed=0, measure_cold=True,
                 serve_precision="f32", quant_report=False):
    """The load run; returns the artifact.  ``measure_cold`` first readies
    a fresh ``ServePrograms`` on ``manifest_dir`` (on the card: the kernel
    library's build when the manifest is empty and this process has not
    loaded it) and times its first image; ``quant_report`` attaches the
    cost / fidelity report of bf16 and int8w against f32."""
    import numpy as np

    from gansformer_tpu_torch.obs import registry as telemetry
    from gansformer_tpu_torch.serve import GenerationService, ServePrograms

    rng = np.random.RandomState(seed)
    result = {"buckets": list(buckets), "zipf_s": zipf_s,
              "seed_universe": seed_universe, "psi_menu": list(psis),
              "rate_rps": rate, "serve_precision": serve_precision,
              "replicas": 1, "autoscale": False}

    def first_image_ms(programs) -> float:
        with GenerationService(programs, max_fill_wait_ms=0.0,
                               wcache_capacity=0) as svc:
            t0 = time.perf_counter()
            svc.submit(int(rng.randint(1 << 20)), psi=0.7).result(
                timeout=1200)
            return (time.perf_counter() - t0) * 1000.0

    if measure_cold:
        cold = ServePrograms(bundle, buckets=buckets,
                             manifest_dir=manifest_dir,
                             serve_precision=serve_precision)
        t0 = time.perf_counter()
        cold_warmup = cold.warm_start()
        result["cold_build_s"] = round(time.perf_counter() - t0, 3)
        result["cold_first_image_ms"] = round(first_image_ms(cold), 1)
        result["cold_compiles"] = cold_warmup["compiled"]
    programs = ServePrograms(bundle, buckets=buckets,
                             manifest_dir=manifest_dir,
                             serve_precision=serve_precision)
    result["device"] = device_info(programs)
    t0 = time.perf_counter()
    warm_stats = programs.warm_start()
    result["warm_build_s"] = round(time.perf_counter() - t0, 3)
    result["warm_first_image_ms"] = round(first_image_ms(programs), 1)
    result["warm_start"] = {k: (round(v, 3) if k == "seconds" else v)
                            for k, v in warm_stats.items()}
    if measure_cold:
        result["cold_first_image_total_ms"] = round(
            result["cold_build_s"] * 1000.0
            + result["cold_first_image_ms"], 1)
    result["warm_first_image_total_ms"] = round(
        result["warm_build_s"] * 1000.0 + result["warm_first_image_ms"], 1)

    if quant_report:
        from gansformer_tpu_torch.serve.quant import (cost_report,
                                                      fidelity_report)

        result["quant"] = {
            "cost": cost_report(bundle, bucket=max(buckets)),
            "fidelity": {
                prec: fidelity_report(bundle, prec, bucket=max(buckets))
                for prec in ("bf16", "int8w")},
        }

    seeds = zipf_choice(rng, np.arange(1, seed_universe + 1), requests,
                        zipf_s)
    psi_mix = zipf_choice(rng, np.asarray(psis, np.float64), requests, 1.0)
    gaps = rng.exponential(1.0 / max(rate, 1e-9), size=requests) \
        if rate > 0 else np.zeros(requests)

    tickets = []
    snap0 = telemetry.get_registry().snapshot()
    t_start = time.perf_counter()
    # latency under admission, not shedding: the bound holds every
    # request (overload is run_chaos's)
    svc = GenerationService(programs, max_fill_wait_ms=fill_wait_ms,
                            wcache_capacity=wcache,
                            max_queue_depth=requests + 8)
    try:
        # open loop: arrival i is due at the sum of the gaps before it
        due = t_start
        for i in range(requests):
            if time.perf_counter() - t_start > duration_s:
                break
            tickets.append(svc.submit(int(seeds[i]),
                                      psi=float(psi_mix[i])))
            if rate > 0:
                due += float(gaps[i])
                time.sleep(max(0.0, due - time.perf_counter()))
        images = [t.result(timeout=max(60.0, duration_s)) for t in tickets]
        wall_s = time.perf_counter() - t_start
    finally:
        svc.close(timeout=max(60.0, duration_s))

    lats = sorted(t.latency_ms for t in tickets)
    snap = telemetry.get_registry().snapshot()

    def mean(name):
        n = _delta(snap0, snap, "histograms", name, "count")
        return _delta(snap0, snap, "histograms", name, "sum") / n if n \
            else 0.0

    hits = _delta(snap0, snap, "counters", "serve/wcache_hits_total")
    misses = _delta(snap0, snap, "counters", "serve/wcache_misses_total")
    result.update({
        "requests": len(tickets),
        "images": len(images),
        "duration_s": round(wall_s, 3),
        "p50_ms": round(percentile(lats, 50), 2),
        "p90_ms": round(percentile(lats, 90), 2),
        "p99_ms": round(percentile(lats, 99), 2),
        "mean_ms": round(float(sum(lats)) / max(len(lats), 1), 2),
        "img_per_s": round(len(images) / max(wall_s, 1e-9), 2),
        "chips_used": 1,
        "img_s_per_chip": round(len(images) / max(wall_s, 1e-9), 2),
        "img_per_s_per_chip": round(
            len(images) / max(wall_s, 1e-9) / result["device"]["count"], 2),
        "batch_fill_mean": round(mean("serve/batch_fill"), 4),
        "queue_depth_mean": round(mean("serve/queue_depth"), 2),
        "queue_depth_max": snap["histograms"].get(
            "serve/queue_depth", {}).get("max"),
        "wcache_hit_rate": round(hits / max(hits + misses, 1.0), 4),
        "map_dispatch_total": _delta(snap0, snap, "counters",
                                     "serve/map_dispatch_total"),
        "synth_dispatch_total": _delta(snap0, snap, "counters",
                                       "serve/synth_dispatch_total"),
    })
    coverage, _ = trace_coverage_of(tickets)
    result["trace_coverage"] = coverage
    ranked = sorted((t for t in tickets if t.state == "done"),
                    key=lambda t: -t.latency_ms)
    result["worst_requests"] = [
        {"rid": t.rid, "latency_ms": round(t.latency_ms, 2)}
        for t in ranked[:5]]
    result["non_fulfilled_rids"] = [t.rid for t in tickets
                                    if t.state != "done"]
    return result


# -- the artifact's checks (the JAX package's telemetry_schema, in part) ---

_PROM_NAME = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_PROM_TYPES = {"counter", "gauge", "summary", "histogram", "untyped"}
SERVE_FAMILIES = (
    "serve_queue_depth_count", "serve_batch_fill_count",
    "serve_e2e_ms_count", "serve_requests_total", "serve_images_total",
    "serve_map_dispatch_total", "serve_synth_dispatch_total",
    "serve_wcache_hits_total", "serve_wcache_misses_total",
    "serve_shed_total", "serve_expired_total", "serve_cancelled_total",
    "serve_dispatcher_restarts_total", "serve_health_state",
    "serve_dispatcher_alive", "serve_queue_bound", "serve_queue_depth_now",
    "reqtrace_requests_total", "reqtrace_events_total",
    "reqtrace_terminal_total", "reqtrace_dropped_total",
    "reqtrace_ledger_rows_total", "reqtrace_ledger_dropped_total",
    "reqtrace_enabled")


def check_prom(path: str) -> List[str]:
    """Prometheus text: TYPE lines, names, numeric values."""
    errors, declared = [], set()
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.rstrip("\n")
            if not line.strip():
                continue
            if line.startswith("#"):
                parts = line.split()
                if len(parts) >= 2 and parts[1] == "TYPE":
                    if len(parts) != 4 or not _PROM_NAME.match(parts[2]) \
                            or parts[3] not in _PROM_TYPES:
                        errors.append(f"{path}:{i}: malformed TYPE line")
                    else:
                        declared.add(parts[2])
                continue
            parts = line.split()
            if len(parts) != 2:
                errors.append(f"{path}:{i}: expected '<name> <value>'")
                continue
            name, value = parts
            base = name.split("{")[0]
            if not _PROM_NAME.match(base):
                errors.append(f"{path}:{i}: illegal metric name {base!r}")
            try:
                float(value)
            except ValueError:
                errors.append(f"{path}:{i}: non-numeric value {value!r}")
            family = re.sub(r"_(count|sum|min|max)$", "", base)
            if base not in declared and family not in declared:
                errors.append(f"{path}:{i}: sample {base!r} has no "
                              f"preceding # TYPE declaration")
    return errors


def check_serve_metric_families(path: str,
                                expect_overload: bool = False) -> List[str]:
    """A single service's prom: every serving and tracing family present;
    served traffic left latency samples; traces opened and reached
    terminals; driven overload moved ``serve_shed_total``."""
    from gansformer_tpu_torch.obs.registry import parse_prom_values

    vals = parse_prom_values(path)
    errors = [f"{path}: missing serve/* family member {name} (is the "
              f"serving telemetry wired?)"
              for name in SERVE_FAMILIES if name not in vals]
    if vals.get("serve_requests_total", 0.0) > 0 and \
            vals.get("serve_e2e_ms_count", 0.0) <= 0:
        errors.append(f"{path}: requests were served but no "
                      f"serve_e2e_ms latency samples landed")
    if vals.get("reqtrace_enabled", 0.0) > 0 and \
            vals.get("serve_requests_total", 0.0) > 0:
        if vals.get("reqtrace_requests_total", 0.0) <= 0:
            errors.append(f"{path}: tracing enabled and requests "
                          f"admitted but reqtrace_requests_total never "
                          f"moved — request tracing rotted")
        elif vals.get("reqtrace_terminal_total", 0.0) <= 0:
            errors.append(f"{path}: traces opened but none reached a "
                          f"terminal event — ticket lifecycles leak")
    if expect_overload and vals.get("serve_shed_total", 0.0) <= 0:
        errors.append(f"{path}: overload traffic was driven (bound "
                      f"{vals.get('serve_queue_bound', 0.0):g}) but "
                      f"serve_shed_total never moved — is admission "
                      f"control wired?")
    return errors


def check_requests(path: str, prom_path: Optional[str] = None
                   ) -> List[str]:
    """A ``requests.jsonl``: every row a terminal request with its cause
    and a monotone lifecycle from ``submitted`` to its outcome, no rid
    twice, a torn last line allowed; against ``prom_path``, as many rows
    as ``reqtrace_ledger_rows_total`` when nothing overflowed."""
    from gansformer_tpu_torch.obs.reqtrace import (EVENT_KINDS,
                                                   TERMINAL_KINDS)

    errors = []
    with open(path) as f:
        lines = [(i, line) for i, line in enumerate(f, 1) if line.strip()]
    rows = []
    for n, (i, line) in enumerate(lines):
        try:
            row = json.loads(line)
        except ValueError as e:
            if n == len(lines) - 1:
                continue           # a torn last append
            errors.append(f"{path}:{i}: not JSON ({e})")
            continue
        if not isinstance(row, dict):
            errors.append(f"{path}:{i}: not a JSON object")
            continue
        rows.append(row)
        outcome = row.get("outcome")
        if not isinstance(row.get("rid"), str):
            errors.append(f"{path}:{i}: rid={row.get('rid')!r} "
                          f"is not a string")
        if outcome not in TERMINAL_KINDS:
            errors.append(f"{path}:{i}: outcome={outcome!r} outside "
                          f"the terminal vocabulary {TERMINAL_KINDS}")
        elif outcome != "fulfilled" and not row.get("cause"):
            errors.append(f"{path}:{i}: {outcome} row without a cause")
        e2e = row.get("e2e_ms")
        if not isinstance(e2e, (int, float)) or isinstance(e2e, bool) \
                or e2e < 0:
            errors.append(f"{path}:{i}: e2e_ms={e2e!r} is not a "
                          f"non-negative number")
        events = row.get("events")
        if not isinstance(events, list) or not events:
            errors.append(f"{path}:{i}: events is not a non-empty list")
            continue
        if not all(isinstance(ev, dict) for ev in events):
            errors.append(f"{path}:{i}: non-object event entry")
            continue
        kinds = [ev.get("kind") for ev in events]
        errors += [f"{path}:{i}: event kind {k!r} outside the lifecycle "
                   f"vocabulary" for k in kinds if k not in EVENT_KINDS]
        if kinds[0] != "submitted":
            errors.append(f"{path}:{i}: first event {kinds[0]!r} "
                          f"(expected 'submitted')")
        if outcome in TERMINAL_KINDS and kinds[-1] != outcome:
            errors.append(f"{path}:{i}: last event {kinds[-1]!r} "
                          f"does not match outcome {outcome!r}")
        ts = [ev.get("t_ms") for ev in events]
        if any(not isinstance(t, (int, float)) or isinstance(t, bool)
               or t < 0 for t in ts):
            errors.append(f"{path}:{i}: non-numeric or negative t_ms")
        elif any(b < a for a, b in zip(ts, ts[1:])):
            errors.append(f"{path}:{i}: event timeline not monotone")
    seen = set()
    for row in rows:
        rid = row.get("rid")
        if isinstance(rid, str):
            if rid in seen:
                errors.append(f"{path}: duplicate terminal row for "
                              f"request {rid!r}")
            seen.add(rid)
    if prom_path is not None and os.path.exists(prom_path):
        from gansformer_tpu_torch.obs.registry import parse_prom_values

        vals = parse_prom_values(prom_path)
        ledgered = vals.get("reqtrace_ledger_rows_total")
        if ledgered is not None and \
                vals.get("reqtrace_ledger_dropped_total", 0.0) == 0.0 \
                and len(rows) != int(ledgered):
            errors.append(
                f"{path}: {len(rows)} ledger rows but "
                f"reqtrace_ledger_rows_total is {ledgered:g} with no "
                f"overflow recorded — rows were lost outside the "
                f"declared bound")
        fulfilled = sum(1 for r in rows if r.get("outcome") == "fulfilled")
        if fulfilled > 0 and vals.get("serve_requests_total", 0.0) <= 0:
            errors.append(f"{path}: {fulfilled} fulfilled rows but "
                          f"serve_requests_total never moved — ledger "
                          f"and prom describe different runs")
    return errors


# -- the CLI -----------------------------------------------------------------

TINY = dict(resolution=16, components=2, latent_dim=16, w_dim=16,
            mapping_dim=16, mapping_layers=2, fmap_base=64, fmap_max=32,
            attention="simplex", attn_start_res=8, attn_max_res=8,
            mbstd_group_size=2)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Zipfian load test of the generation service "
                    "(PyTorch port)")
    p.add_argument("--run-dir", default=None,
                   help="serve a real checkpoint (G-only restore)")
    p.add_argument("--preset", default=None)
    p.add_argument("--init", default="random",
                   choices=("checkpoint", "random"))
    p.add_argument("--tiny", action="store_true",
                   help="a 16x16 model of the JAX package's trace "
                        "config: the host's proxy")
    p.add_argument("--buckets", default="1,4,8")
    p.add_argument("--requests", type=int, default=200)
    p.add_argument("--rate", type=float, default=20.0,
                   help="Poisson arrival rate, req/s (0 = back-to-back)")
    p.add_argument("--duration-s", type=float, default=300.0,
                   help="hard wall bound on the submit window")
    p.add_argument("--zipf-s", type=float, default=1.1)
    p.add_argument("--seed-universe", type=int, default=512)
    p.add_argument("--fill-wait-ms", type=float, default=2.0)
    p.add_argument("--wcache", type=int, default=4096)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--replicas", type=int, default=1,
                   help="serving replicas (1; more come with the fleet)")
    p.add_argument("--serve-precision", default="f32",
                   choices=("f32", "bf16", "int8w"))
    p.add_argument("--quant-report", action="store_true",
                   help="attach the bf16 / int8w cost and fidelity report")
    p.add_argument("--chaos", action="store_true",
                   help="the overload drill: burst past the queue bound "
                        "with one injected dispatcher crash")
    p.add_argument("--queue-depth", type=int, default=8,
                   help="chaos: admission queue bound")
    p.add_argument("--burst-factor", type=float, default=4.0,
                   help="chaos: submit burst-factor x queue-depth "
                        "requests back to back")
    p.add_argument("--crash-at-batch", type=int, default=2,
                   help="chaos: inject raise@serve_dispatch at this "
                        "batch (0 = no crash)")
    p.add_argument("--deadline-s", type=float, default=None,
                   help="chaos: per-request deadline")
    p.add_argument("--manifest-dir", default=None,
                   help="the kernel library's manifest dir ('' builds "
                        "where the kernels' first use does; default: a "
                        "fresh temporary dir, so cold and warm are "
                        "honest)")
    p.add_argument("--json-out", default=None)
    p.add_argument("--prom-out", default=None,
                   help="also write telemetry.prom here (default: next "
                        "to --json-out)")
    p.add_argument("--requests-out", default=None,
                   help="the request ledger (default: requests.jsonl "
                        "next to --json-out; '' keeps tracing in memory)")
    p.add_argument("--no-reqtrace", action="store_true",
                   help="turn request tracing off (its overhead A/B)")
    p.add_argument("--device", default=None,
                   help="'cpu' for the plain path on the host (default: "
                        "the card)")
    return p


def main(argv=None) -> int:
    import sys

    from gansformer_tpu_torch.cli.serve import refuse_later_flags

    argv = sys.argv[1:] if argv is None else list(argv)
    refuse_later_flags(argv)
    args = build_parser().parse_args(argv)

    from gansformer_tpu_torch.core.config import ModelConfig, get_preset
    from gansformer_tpu_torch.core.device import resolve_device
    from gansformer_tpu_torch.obs import registry as telemetry
    from gansformer_tpu_torch.obs import reqtrace
    from gansformer_tpu_torch.serve import init_generator, load_generator

    dev = resolve_device(args.device)
    if args.tiny:
        bundle = init_generator(ModelConfig(**TINY), seed=args.seed,
                                device=dev)
    elif args.init == "checkpoint":
        if not args.run_dir:
            raise SystemExit("--init checkpoint needs --run-dir")
        from gansformer_tpu_torch.utils.runarchive import resolve_run_dir

        bundle = load_generator(resolve_run_dir(args.run_dir), device=dev)
    else:
        if not args.preset:
            raise SystemExit("--init random needs --preset (or --tiny)")
        bundle = init_generator(get_preset(args.preset), seed=args.seed,
                                device=dev)

    if args.manifest_dir == "":
        manifest_dir = None
    elif args.manifest_dir is None:
        import tempfile

        manifest_dir = tempfile.mkdtemp(prefix="serve_manifest_")
    else:
        manifest_dir = args.manifest_dir

    out_dir = (os.path.dirname(os.path.abspath(args.json_out))
               if args.json_out else None)
    if args.requests_out == "":
        requests_out = None
    elif args.requests_out is None:
        requests_out = (os.path.join(out_dir, "requests.jsonl")
                        if out_dir else None)
    else:
        requests_out = args.requests_out
    reqtrace.configure_reqtrace(requests_out, enabled=not args.no_reqtrace)

    buckets = tuple(int(b) for b in args.buckets.split(","))
    if args.chaos:
        result = run_chaos(
            bundle, buckets, queue_depth=args.queue_depth,
            burst_factor=args.burst_factor,
            crash_at_batch=args.crash_at_batch,
            deadline_s=args.deadline_s, zipf_s=args.zipf_s,
            seed_universe=args.seed_universe, manifest_dir=manifest_dir,
            fill_wait_ms=args.fill_wait_ms, wcache=args.wcache,
            seed=args.seed, serve_precision=args.serve_precision)
    else:
        result = run_loadtest(
            bundle, buckets, requests=args.requests, rate=args.rate,
            duration_s=args.duration_s, zipf_s=args.zipf_s,
            seed_universe=args.seed_universe, manifest_dir=manifest_dir,
            fill_wait_ms=args.fill_wait_ms, wcache=args.wcache,
            seed=args.seed, serve_precision=args.serve_precision,
            quant_report=args.quant_report)

    prom_path = args.prom_out or (os.path.join(out_dir, "telemetry.prom")
                                  if out_dir else None)
    reqtrace.get_reqtracer().flush()
    result["reqtrace_enabled"] = not args.no_reqtrace
    if prom_path:
        telemetry.get_registry().write_prom(prom_path)
        errors = check_prom(prom_path) + check_serve_metric_families(
            prom_path, expect_overload=args.chaos)
        if requests_out and not args.no_reqtrace:
            errors += check_requests(requests_out, prom_path=prom_path)
            result["requests_out"] = requests_out
        result["prom"] = prom_path
        result["prom_ok"] = not errors
        result["prom_errors"] = errors

    blob = json.dumps(result, indent=1, sort_keys=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(blob + "\n")
    print(blob)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
