"""SLO error budgets: declared objectives, burn rates, exhaustion (the
port's copy of ``gansformer_tpu/obs/slo.py``).

An SLO is a declared objective over served traffic: "99 % of fulfilled
requests complete under 2000 ms", "99.9 % of admitted requests are
fulfilled", "at most 1 % of submissions are shed".  The error budget is
the allowance the target leaves open (a 99.9 % target over 10k requests
budgets 10 bad ones); the **burn rate** is how fast the window spends
it::

    burn_rate = (bad / total) / (1 - target)

Burn rate 1.0 spends exactly the budget over the window; 10 spends it in
a tenth of the window.  ``exhausted`` means more bad requests than the
budget in the evaluated window.

Sources, in order of preference:

* ``requests.jsonl``, the request tracer's ledger (``obs/reqtrace``):
  row-level outcomes and latencies, so every objective is evaluated
  exactly over a rolling window (``window_s`` back from ``now`` by each
  row's ``t_wall``).
* ``telemetry.prom``, the lifetime ``serve_*`` counters: the window is
  the service's life, and the latency objective reports ``no_data``
  (counters carry no per-request latency).

Standard library only: it reads artifacts and touches no device.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

from gansformer_tpu_torch.obs.reqtrace import read_requests

# The declared objectives.  ``kind`` picks the good/bad classifier,
# ``target`` is the good fraction the budget is written against and
# ``threshold_ms`` parameterizes the latency classifier.
DEFAULT_OBJECTIVES: List[dict] = [
    {"name": "latency_p99", "kind": "latency", "target": 0.99,
     "threshold_ms": 2000.0,
     "description": "fulfilled requests complete under threshold_ms"},
    {"name": "availability", "kind": "availability", "target": 0.999,
     "description": "admitted requests are fulfilled "
                    "(failed/expired spend budget; client cancels don't)"},
    {"name": "shed_rate", "kind": "shed", "target": 0.99,
     "description": "submissions are admitted rather than shed"},
]


def _classify_ledger(rows: List[dict], obj: dict) -> Optional[dict]:
    """(good, bad, total) of one objective over ledger rows; None when no
    row qualifies."""
    kind = obj["kind"]
    if kind == "latency":
        done = [r for r in rows if r.get("outcome") == "fulfilled"]
        if not done:
            return None
        thresh = float(obj.get("threshold_ms", 2000.0))
        good = sum(1 for r in done
                   if float(r.get("e2e_ms", 0.0)) <= thresh)
        return {"good": good, "bad": len(done) - good, "total": len(done)}
    if kind == "availability":
        admitted = [r for r in rows
                    if r.get("outcome") in ("fulfilled", "failed",
                                            "expired")]
        if not admitted:
            return None
        good = sum(1 for r in admitted if r["outcome"] == "fulfilled")
        return {"good": good, "bad": len(admitted) - good,
                "total": len(admitted)}
    if kind == "shed":
        submitted = [r for r in rows if r.get("outcome") != "cancelled"]
        if not submitted:
            return None
        bad = sum(1 for r in submitted if r["outcome"] == "shed")
        return {"good": len(submitted) - bad, "bad": bad,
                "total": len(submitted)}
    raise ValueError(f"unknown SLO kind {kind!r}")


def _classify_prom(vals: Dict[str, float], obj: dict) -> Optional[dict]:
    """One objective from the lifetime counters (what each can and cannot
    see: the module docstring)."""
    kind = obj["kind"]
    requests = vals.get("serve_requests_total", 0.0)
    shed = vals.get("serve_shed_total", 0.0)
    expired = vals.get("serve_expired_total", 0.0)
    cancelled = vals.get("serve_cancelled_total", 0.0)
    if kind == "latency":
        return None
    if kind == "availability":
        # admitted less client cancels; failures other than expiry have
        # no counter, so expiry is the spend the counters show
        total = requests - cancelled
        if total <= 0:
            return None
        bad = min(expired, total)
        return {"good": total - bad, "bad": bad, "total": total}
    if kind == "shed":
        total = requests + shed
        if total <= 0:
            return None
        return {"good": requests, "bad": shed, "total": total}
    raise ValueError(f"unknown SLO kind {kind!r}")


def _budget(obj: dict, counts: Optional[dict], source: str,
            window_s: Optional[float]) -> dict:
    out = {"name": obj["name"], "kind": obj["kind"],
           "target": obj["target"],
           "description": obj.get("description", ""),
           "source": source, "window_s": window_s}
    if obj["kind"] == "latency":
        out["threshold_ms"] = float(obj.get("threshold_ms", 2000.0))
    if counts is None:
        out.update({"status": "no_data", "good": 0, "bad": 0, "total": 0,
                    "compliance": None, "budget_total": 0.0,
                    "budget_spent": 0.0, "budget_remaining": 0.0,
                    "burn_rate": 0.0, "exhausted": False})
        return out
    good, bad, total = counts["good"], counts["bad"], counts["total"]
    target = float(obj["target"])
    allowed = (1.0 - target) * total
    burn = (bad / total) / (1.0 - target) if target < 1.0 else (
        float("inf") if bad else 0.0)
    exhausted = bad > allowed
    out.update({
        "status": "exhausted" if exhausted else "ok",
        "good": good, "bad": bad, "total": total,
        "compliance": round(good / total, 6),
        "budget_total": round(allowed, 3),
        "budget_spent": float(bad),
        "budget_remaining": round(max(allowed - bad, 0.0), 3),
        "burn_rate": round(burn, 4) if burn != float("inf") else burn,
        "exhausted": exhausted,
    })
    return out


def evaluate_slos(run_dir: str,
                  objectives: Optional[List[dict]] = None,
                  window_s: float = 3600.0,
                  now: Optional[float] = None) -> dict:
    """Grade every objective over a run dir's artifacts: the ledger's rows
    of the last ``window_s`` before ``now`` (by ``t_wall``), else the
    prom's lifetime counters.  Missing or torn artifacts give ``no_data``,
    never an exception.  Returns ``{source, window_s, rows, objectives,
    exhausted, worst_burn_rate}``; ``exhausted`` names the objectives
    whose budget is spent."""
    objectives = DEFAULT_OBJECTIVES if objectives is None else objectives
    now = time.time() if now is None else now

    rows = read_requests(os.path.join(run_dir, "requests.jsonl"))
    windowed = [r for r in rows
                if isinstance(r.get("t_wall"), (int, float))
                and now - r["t_wall"] <= window_s]
    vals: Dict[str, float] = {}
    source = "ledger" if windowed else "prom"
    if not windowed:
        prom = os.path.join(run_dir, "telemetry.prom")
        if os.path.exists(prom):
            from gansformer_tpu_torch.obs.registry import parse_prom_values

            try:
                vals = parse_prom_values(prom)
            except OSError:
                vals = {}
        if not vals:
            source = "none"

    graded = []
    for obj in objectives:
        if source == "ledger":
            graded.append(_budget(obj, _classify_ledger(windowed, obj),
                                  "ledger", window_s))
        elif source == "prom":
            graded.append(_budget(obj, _classify_prom(vals, obj), "prom",
                                  None))
        else:
            graded.append(_budget(obj, None, "none", None))
    burns = [o["burn_rate"] for o in graded if o["status"] != "no_data"]
    return {"source": source, "window_s": window_s,
            "rows": len(windowed), "objectives": graded,
            "exhausted": [o["name"] for o in graded if o["exhausted"]],
            "worst_burn_rate": max(burns) if burns else 0.0}


def render_slos(report: dict) -> str:
    """The report as text, one line per objective."""
    lines = [f"source={report['source']} "
             f"window_s={report['window_s']:g} rows={report['rows']}"]
    for o in report["objectives"]:
        if o["status"] == "no_data":
            lines.append(f"  {o['name']:<14s} target={o['target']:g}  "
                         f"no data")
            continue
        lines.append(
            f"  {o['name']:<14s} target={o['target']:g}  "
            f"compliance={o['compliance']:.4f}  "
            f"bad={o['bad']}/{o['total']}  "
            f"budget={o['budget_spent']:g}/{o['budget_total']:g}  "
            f"burn={o['burn_rate']:g}  "
            f"{'EXHAUSTED' if o['exhausted'] else 'ok'}")
    return "\n".join(lines)
