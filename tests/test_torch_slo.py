"""The port's SLO error budgets (``gansformer_tpu_torch/obs/slo.py``)
against the JAX package's ``obs/slo.py``: the same ``requests.jsonl`` and
``telemetry.prom`` fixtures through both give equal reports and equal
text.  One case for each library test of ``tests/test_slo.py``: the
budget and burn-rate math, latency over fulfilled requests only, cancels
that spend no availability budget, the rolling window, the prom fallback
(and what it cannot see), no data, the rendering of an exhausted budget,
and custom objectives; each with that test's own numbers held too."""

import json
import os

import pytest

from gansformer_tpu.obs import slo as jax_slo
from gansformer_tpu_torch import obs as port_obs
from gansformer_tpu_torch.obs import slo as port_slo
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

NOW = 1_000_000.0


def write_ledger(d, rows):
    with open(os.path.join(d, "requests.jsonl"), "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def row(rid, outcome, e2e_ms=10.0, t_wall=NOW - 10.0, cause=None):
    return {"rid": rid, "outcome": outcome, "cause": cause,
            "e2e_ms": e2e_ms, "t_wall": t_wall,
            "events": [{"kind": "submitted", "t_ms": 0.0},
                       {"kind": outcome, "t_ms": e2e_ms}]}


def by_name(report):
    return {o["name"]: o for o in report["objectives"]}


def budget_math(d):
    rows = [row(f"r1-{i}", "fulfilled") for i in range(995)]
    rows += [row(f"r1-e{i}", "expired", cause="deadline")
             for i in range(5)]
    write_ledger(d, rows)

    def check(report):
        assert report["source"] == "ledger" and report["rows"] == 1000
        av = by_name(report)["availability"]
        assert av["total"] == 1000 and av["bad"] == 5
        assert av["budget_total"] == pytest.approx(1.0)
        assert av["budget_spent"] == 5.0 and av["budget_remaining"] == 0.0
        assert av["burn_rate"] == pytest.approx(5.0)
        assert av["exhausted"] and av["status"] == "exhausted"
        assert report["exhausted"] == ["availability"]
        assert report["worst_burn_rate"] == pytest.approx(5.0)
        lat = by_name(report)["latency_p99"]
        assert lat["total"] == 995 and lat["bad"] == 0
        assert lat["burn_rate"] == 0.0 and not lat["exhausted"]
        shed = by_name(report)["shed_rate"]
        assert shed["total"] == 1000 and shed["bad"] == 0
    return {}, check


def latency_fulfilled_only(d):
    rows = [row(f"r1-{i}", "fulfilled", e2e_ms=100.0) for i in range(90)]
    rows += [row(f"r1-s{i}", "fulfilled", e2e_ms=5000.0)
             for i in range(10)]
    rows += [row("r1-x", "shed", e2e_ms=0.1, cause="overloaded")]
    write_ledger(d, rows)

    def check(report):
        lat = by_name(report)["latency_p99"]
        assert lat["total"] == 100 and lat["bad"] == 10
        assert lat["burn_rate"] == pytest.approx(10.0) and lat["exhausted"]
    return {}, check


def cancels_spend_nothing(d):
    rows = [row(f"r1-{i}", "fulfilled") for i in range(50)]
    rows += [row(f"r1-c{i}", "cancelled", cause="client")
             for i in range(50)]
    write_ledger(d, rows)

    def check(report):
        av = by_name(report)["availability"]
        assert av["total"] == 50 and av["bad"] == 0 and not av["exhausted"]
    return {}, check


def rolling_window(d):
    rows = [row(f"r1-{i}", "expired", cause="deadline",
                t_wall=NOW - 10_000.0) for i in range(20)]
    rows += [row("r1-new", "fulfilled", t_wall=NOW - 5.0)]
    write_ledger(d, rows)

    def check(report):
        assert report["rows"] == 1 and report["exhausted"] == []
    return {}, check


def prom_fallback(d):
    with open(os.path.join(d, "telemetry.prom"), "w") as f:
        f.write("serve_requests_total 200.0\n"
                "serve_shed_total 50.0\n"
                "serve_expired_total 1.0\n"
                "serve_cancelled_total 0.0\n")

    def check(report):
        assert report["source"] == "prom"
        objs = by_name(report)
        assert objs["latency_p99"]["status"] == "no_data"
        av = objs["availability"]
        assert av["total"] == 200 and av["bad"] == 1
        shed = objs["shed_rate"]
        assert shed["total"] == 250 and shed["bad"] == 50
        assert shed["exhausted"] and "shed_rate" in report["exhausted"]
    return {}, check


def no_data(d):
    def check(report):
        assert report["source"] == "none"
        assert all(o["status"] == "no_data" for o in report["objectives"])
        assert report["exhausted"] == [] and report["worst_burn_rate"] == 0
        assert "no data" in port_slo.render_slos(report)
    return {}, check


def render_exhausted(d):
    write_ledger(d, [row(f"r1-{i}", "expired", cause="deadline")
                     for i in range(10)])

    def check(report):
        text = port_slo.render_slos(report)
        assert "EXHAUSTED" in text and "availability" in text
    return {}, check


def custom_objectives(d):
    write_ledger(d, [row("r1-1", "fulfilled", e2e_ms=900.0),
                     row("r1-2", "fulfilled", e2e_ms=1100.0)])
    strict = [{"name": "latency_strict", "kind": "latency",
               "target": 0.99, "threshold_ms": 1000.0}]

    def check(report):
        lat = by_name(report)["latency_strict"]
        assert lat["bad"] == 1 and lat["exhausted"]
        assert [o["name"] for o in report["objectives"]] == \
            ["latency_strict"]
        assert len(port_slo.DEFAULT_OBJECTIVES) == 3
    return {"objectives": strict}, check


CASES = {f.__name__: f for f in (
    budget_math, latency_fulfilled_only, cancels_spend_nothing,
    rolling_window, prom_fallback, no_data, render_exhausted,
    custom_objectives)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reports_and_text_equal_jax(case, tmp_path):
    d = str(tmp_path)
    kw, check = CASES[case](d)
    got = port_slo.evaluate_slos(d, window_s=3600.0, now=NOW, **kw)
    want = jax_slo.evaluate_slos(d, window_s=3600.0, now=NOW, **kw)
    assert got == want
    assert port_slo.render_slos(got) == jax_slo.render_slos(want)
    check(got)


def test_defaults_and_exports_equal_jax():
    """The declared objectives are JAX's, and ``obs`` exports what JAX's
    ``obs`` exports of them."""
    assert port_slo.DEFAULT_OBJECTIVES == jax_slo.DEFAULT_OBJECTIVES
    for name in ("DEFAULT_OBJECTIVES", "evaluate_slos", "render_slos"):
        assert getattr(port_obs, name) is getattr(port_slo, name)
