"""The port's load and chaos tests (``gansformer_tpu_torch/cli/
loadtest_serve.py``) on the CPU at the serve tests' micro width, against
the JAX package's ``scripts/loadtest_serve.py``.

JAX's load tests run its real ``GenerationService`` over stand-in programs
(``tests/test_torch_serve_service.JaxStandIn``: numpy, nothing
compiles), so what is compared is the load tests' artifacts: the same keys,
and the chaos drill's invariants on both.  The port's artifact checks
(prom text, the serve families, the request ledger) are held to JAX's
``telemetry_schema`` on the same files, good and broken."""

import json
import os
import signal
import threading

import numpy as np
import pytest

import gansformer_tpu.serve.replicas as jax_replicas
from gansformer_tpu.analysis import telemetry_schema as jax_schema
from gansformer_tpu_torch.cli import loadtest_serve as port_lt
from gansformer_tpu_torch.obs import registry as port_registry
from gansformer_tpu_torch.serve import init_generator
from tests.test_torch_serve import TINY
from tests.test_torch_serve_service import JaxStandIn
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

LIMIT = 25


@pytest.fixture(autouse=True)
def time_limit():
    """SIGALRM after ``LIMIT`` s fails the test instead of the run."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def on_alarm(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT} s limit")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(LIMIT)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def bundle():
    return init_generator(TINY, seed=2, device="cpu")


@pytest.fixture
def jax_loadtest(monkeypatch):
    """JAX's load test over stand-in programs."""
    import gansformer_tpu.serve as jserve
    from scripts import loadtest_serve

    class Programs(JaxStandIn):
        def __init__(self, bundle, buckets, **kw):
            super().__init__(buckets)

        def warm_start(self):
            return {"loaded": 0, "compiled": 0, "seconds": 0.0}

    monkeypatch.setattr(jserve, "ServePrograms", Programs)
    monkeypatch.setattr(jax_replicas, "ServePrograms", Programs)
    return loadtest_serve


def chaos_asserts(r):
    """The chaos artifact's contract (JAX's ``_chaos_asserts``)."""
    assert r["hung_tickets"] == 0, "a recovery path leaked requests"
    assert r["shed"] > 0 and r["shed_rate"] > 0
    assert r["dispatcher_restarts"] >= 1, "injected crash never fired"
    assert r["recovery_wave_served"] > 0, "no post-crash service"
    assert r["served"] > 0
    assert r["served"] + r["failed"] + r["expired"] + r["cancelled"] \
        == r["accepted"]
    assert r["health"]["state"] in ("ready", "degraded")
    assert r["trace_coverage"]["ok"]


def test_run_chaos_keys_and_invariants_equal_jax(bundle, jax_loadtest):
    kw = dict(queue_depth=4, burst_factor=4, crash_at_batch=2,
              manifest_dir=None, wcache=64, seed_universe=16,
              restart_backoff_s=0.01)
    want = jax_loadtest.run_chaos(None, (1, 2), **kw)
    got = port_lt.run_chaos(bundle, (1, 2), **kw)
    assert set(got) == set(want)
    for r in (want, got):
        chaos_asserts(r)
        assert r["burst"] == 16 and r["submitted"] == 20
        assert r["queue_bound"] == 4 and r["accepted"] <= r["submitted"]
        assert r["p50_ms_under_overload"] <= r["p99_ms_under_overload"]
        assert r["dispatcher_restarts"] == 1
        # the crashed batch fails with the injected fault, typed in the
        # trace; nothing else fails
        assert {x["cause"] for x in r["non_fulfilled_requests"]} == \
            {"FaultInjected"}
    assert got["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}


def test_run_loadtest_keys_equal_jax(bundle, jax_loadtest):
    kw = dict(requests=12, rate=0.0, duration_s=60.0, manifest_dir=None,
              wcache=64, seed_universe=8, measure_cold=False)
    want = jax_loadtest.run_loadtest(None, (1, 2), **kw)
    got = port_lt.run_loadtest(bundle, (1, 2), **kw)
    assert set(got) == set(want)
    assert got["requests"] == got["images"] == 12
    for k in ("p50_ms", "p90_ms", "p99_ms", "img_per_s",
              "img_per_s_per_chip", "batch_fill_mean",
              "warm_first_image_total_ms", "wcache_hit_rate"):
        assert np.isfinite(got[k]), (k, got[k])
    assert got["p50_ms"] <= got["p99_ms"]
    assert 0.0 < got["wcache_hit_rate"] <= 1.0   # 12 draws of 8 seeds
    assert 0.0 < got["batch_fill_mean"] <= 1.0
    assert got["synth_dispatch_total"] >= 6 and got["non_fulfilled_rids"] \
        == [] and got["trace_coverage"]["ok"]
    cold = port_lt.run_loadtest(bundle, (1, 2), **dict(
        kw, requests=3, measure_cold=True))
    assert cold["cold_compiles"] == 0 and "cold_first_image_total_ms" in \
        cold                                    # the host builds nothing


@pytest.mark.parametrize("chaos", [False, True])
def test_main_writes_a_checked_artifact(tmp_path, capsys, chaos):
    """The CLI writes the JSON artifact, telemetry.prom and the request
    ledger; the port's checks pass them, and JAX's agree."""
    out = str(tmp_path / "art.json")
    argv = ["--tiny", "--device", "cpu", "--json-out", out,
            "--buckets", "1,2", "--manifest-dir", ""]
    argv += (["--chaos", "--queue-depth", "4", "--crash-at-batch", "2"]
             if chaos else ["--requests", "10", "--rate", "0"])
    port_registry.get_registry().reset()
    assert port_lt.main(argv) == 0
    with open(out) as f:
        r = json.load(f)
    assert json.loads(capsys.readouterr().out) == r
    assert r["prom_ok"], r["prom_errors"]
    prom, ledger = r["prom"], r["requests_out"]
    assert jax_schema.check_prom(prom) == []
    assert jax_schema.check_serve_metric_families(
        prom, expect_overload=chaos) == []
    assert jax_schema.check_requests(ledger, prom_path=prom) == []
    with open(ledger) as f:       # + the cold and warm first images
        assert sum(1 for _ in f) == (r["accepted"] + r["shed"] if chaos
                                     else 10 + 2)
    args = port_lt.build_parser().parse_args(
        argv + ["--autoscale", "--replicas", "2", "--max-replicas", "3"])
    assert (args.autoscale, args.replicas, args.max_replicas) == (True, 2,
                                                                  3)


def write_prom(path, vals):
    with open(path, "w") as f:
        for k, v in vals.items():
            f.write(f"# TYPE {k} gauge\n{k} {v}\n")
    return path


def test_artifact_checks_equal_jax(tmp_path):
    """The same good and broken artifacts through the port's checks and
    JAX's give the same errors."""
    base = {n: 1 for n in port_lt.SERVE_FAMILIES}
    base.update(serve_shed_total=0, reqtrace_enabled=1)
    proms = {
        "ok": base,
        "missing": {k: v for k, v in base.items()
                    if k != "serve_expired_total"},
        "no_latency": dict(base, serve_e2e_ms_count=0),
        "no_traces": dict(base, reqtrace_requests_total=0),
        "no_terminals": dict(base, reqtrace_terminal_total=0),
    }
    for name, vals in proms.items():
        path = write_prom(str(tmp_path / f"{name}.prom"), vals)
        for overload in (False, True):
            assert port_lt.check_serve_metric_families(path, overload) == \
                jax_schema.check_serve_metric_families(path, overload), \
                (name, overload)
    bad = str(tmp_path / "bad.prom")
    with open(bad, "w") as f:
        f.write("# TYPE a gauge\na 1\nb 2\n# TYPE 9x gauge\nc x\nd\n")
    assert port_lt.check_prom(bad) == jax_schema.check_prom(bad)
    assert len(port_lt.check_prom(bad)) == 5

    good = {"rid": "r1-1", "outcome": "fulfilled", "cause": None,
            "e2e_ms": 5.0, "events": [{"kind": "submitted", "t_ms": 0.0},
                                      {"kind": "fulfilled", "t_ms": 5.0}]}
    rows = [good,
            dict(good, rid="r1-2", outcome="shed",
                 events=[{"kind": "submitted", "t_ms": 0.0},
                         {"kind": "shed", "t_ms": 1.0}]),
            dict(good, rid="r1-3", outcome="vanished"),
            dict(good, rid="r1-4",
                 events=[{"kind": "submitted", "t_ms": 3.0},
                         {"kind": "fulfilled", "t_ms": 1.0}]),
            dict(good, rid="r1-5", e2e_ms=-1,
                 events=[{"kind": "popped", "t_ms": 0.0},
                         {"kind": "oops", "t_ms": 1.0}]),
            dict(good, rid="r1-6", events=[]),
            dict(good, rid="r1-8", events=[{"kind": "submitted",
                                            "t_ms": 0.0}, 3]),
            dict(good, rid=7),
            good]
    ledger = str(tmp_path / "requests.jsonl")
    with open(ledger, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
        f.write("[1]\n{torn mid\n" + json.dumps(good) + "\n{torn")
    prom = write_prom(str(tmp_path / "t.prom"), {
        "reqtrace_ledger_rows_total": 3, "reqtrace_ledger_dropped_total": 0,
        "serve_requests_total": 0})
    for p in (None, prom, str(tmp_path / "absent.prom")):
        want = jax_schema.check_requests(ledger, prom_path=p)
        assert port_lt.check_requests(ledger, prom_path=p) == want
        assert len(want) >= 9
    assert port_lt.percentile([], 50) != port_lt.percentile([], 50)
    assert os.path.exists(ledger)


def test_autoscale_drill_keys_and_order_equal_jax(bundle, jax_loadtest,
                                                 monkeypatch):
    """The autoscale drill (one replica, at most two, JAX's twitchy
    controller and pressure window) on the port's fleet of two host
    members and on JAX's over stand-ins that take 10 ms a batch (an
    instant batch never lets a queue fill): the same artifact keys and
    ``autoscale`` keys, and on both the scale-out before any breaker
    trip, a scale-in after recovery and nothing hung."""
    import time

    base = jax_replicas.ServePrograms

    class Slow(base):
        def synthesize(self, *a, **k):
            time.sleep(0.01)
            return super().synthesize(*a, **k)

    monkeypatch.setattr(jax_replicas, "ServePrograms", Slow)
    kw = dict(queue_depth=4, burst_factor=4, crash_at_batch=2,
              manifest_dir=None, wcache=64, seed_universe=16,
              restart_backoff_s=0.01, replicas=1, max_replicas=2,
              autoscale=True, pressure_s=0.3)
    want = jax_loadtest.run_chaos(None, (1, 2), **kw)
    got = port_lt.run_chaos(bundle, (1, 2), devices=["cpu", "cpu"], **kw)
    assert set(got) == set(want)
    assert set(got["autoscale"]) == set(want["autoscale"])
    for r in (want, got):
        a = r["autoscale"]
        assert a["enabled"] and a["scale_out_fired"] >= 1
        assert a["scale_out_before_breaker"] and a["peak_replicas"] == 2
        assert a["scaled_in_after_load"]
        assert r["hung_tickets"] == 0 and r["replicas"] == 1
        assert r["served"] + r["failed"] + r["expired"] + r["cancelled"] \
            == r["accepted"]
        assert r["burst"] >= 16 and r["trace_coverage"]["ok"]
    assert [e["kind"] for e in got["autoscale"]["events"]][0] == "scale_out"


def test_fleet_load_run_keys_equal_jax(bundle, jax_loadtest):
    """The load run through two members: JAX's keys, the fleet's
    ``peak_replicas`` and ``per_replica``, and ``chips_used`` counting
    the devices that served (two members on the one host: one)."""
    kw = dict(requests=12, rate=0.0, duration_s=60.0, manifest_dir=None,
              wcache=64, seed_universe=8, measure_cold=False, replicas=2)
    want = jax_loadtest.run_loadtest(None, (1, 2), **kw)
    got = port_lt.run_loadtest(bundle, (1, 2), devices=["cpu", "cpu"], **kw)
    assert set(got) == set(want)
    assert set(got["per_replica"]) == set(want["per_replica"]) == {"0", "1"}
    assert got["peak_replicas"] == want["peak_replicas"] == 2
    assert got["chips_used"] == 1 and want["chips_used"] == 2
    per = got["per_replica"]
    assert sum(p["requests"] for p in per.values()) == 12
    assert sum(p["images"] for p in per.values()) == got["images"] == 12
    assert sum(p["dispatch_share"] for p in per.values()) == \
        pytest.approx(1.0)


SNAPSHOTS = (
    {"counters": {"serve/replica0/requests_total": 3.0,
                  "serve/replica0/images_total": 2.0},
     "histograms": {"serve/replica0/batch_fill": {"count": 1, "sum": 0.5}}},
    {"counters": {"serve/replica0/requests_total": 10.0,
                  "serve/replica0/images_total": 9.0,
                  "serve/replica1/requests_total": 4.0,
                  "serve/replica1/images_total": 4.0},
     "histograms": {"serve/replica0/batch_fill": {"count": 4, "sum": 2.5},
                    "serve/replica0/batch_ms": {"count": 3, "sum": 30.0},
                    "serve/replica1/batch_fill": {"count": 1, "sum": 1.0},
                    "serve/replica1/batch_ms": {"count": 0, "sum": 0.0}}},
)


@pytest.mark.parametrize("ordinals", [[0], [0, 1], [0, 1, 2], []])
def test_per_replica_report_equals_jax(ordinals, jax_loadtest):
    snap0, snap1 = SNAPSHOTS
    for wall_s in (2.0, 0.0):
        assert port_lt.per_replica_report(snap0, snap1, wall_s, ordinals) \
            == jax_loadtest.per_replica_report(snap0, snap1, wall_s,
                                               ordinals)


def _fleet_base():
    base = {n: 1 for n in port_lt.SERVE_FAMILIES}
    base.update(serve_shed_total=0, reqtrace_enabled=1, serve_replicas=2,
                serve_scale_out_total=1, serve_scale_in_total=0)
    for i in (0, 1):
        base.update({f"serve_replica{i}_{m}": 1
                     for m in port_lt.FLEET_MEMBER_FAMILIES})
    return base


FLEET_PROMS = {
    "ok": lambda b: b,
    "no_scale_in": lambda b: b.pop("serve_scale_in_total"),
    "no_members": lambda b: [b.pop(k) for k in list(b)
                             if k.startswith("serve_replica")
                             and k != "serve_replicas"],
    "member_missing": lambda b: b.pop("serve_replica1_queue_bound"),
    "no_batch_samples": lambda b: b.update(serve_replica0_batch_ms_count=0),
    "single_service": lambda b: [b.pop(k) for k in list(b)
                                 if k.startswith(("serve_replica",
                                                  "serve_scale"))],
}


@pytest.mark.parametrize("case", sorted(FLEET_PROMS))
def test_fleet_families_equal_jax(case, tmp_path):
    """The fleet families of ``check_serve_metric_families``: the same
    errors as JAX's on a good fleet prom and on broken ones."""
    vals = _fleet_base()
    FLEET_PROMS[case](vals)
    path = write_prom(str(tmp_path / "fleet.prom"), vals)
    got = port_lt.check_serve_metric_families(path)
    assert got == jax_schema.check_serve_metric_families(path)
    assert bool(got) == (case not in ("ok", "single_service"))
