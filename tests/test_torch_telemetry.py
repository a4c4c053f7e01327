"""The port's telemetry CLI (``cli/telemetry.py``) against the JAX
package's: the doctor over JAX's fixtures (``tests/test_doctor.py``'s
``synth_run_dir`` and the cases of its goldens, the supervisor's
availability cases, the serving, fleet, chaos and SLO sections) with the
same check names, levels and details; ``trace``, ``summary``,
``heartbeats``, ``requests``, ``slo``, ``fleet`` and ``doctor`` with the
same output and exit code on the same dirs; and a port run dir from a
micro CPU loop, where only the ``compiles`` section differs: JAX's
doctor WARNs that the retrace watch never armed, the port's grades it
"no counterpart", and every other check is JAX's."""

import dataclasses
import json
import os
import time

import pytest

from gansformer_tpu.cli import telemetry as jax_tele
from gansformer_tpu.supervise import events as jax_events
from gansformer_tpu_torch.cli import telemetry as port_tele
from gansformer_tpu_torch.core import config as port_config
from gansformer_tpu_torch.train import loop
from tests.test_doctor import NOW, synth_run_dir
from tests.test_train import micro_cfg
from tests.torch_threads import one_thread  # noqa: F401  (autouse)


def _serve(health=0.0, alive=1.0, depth=1.0, bound=256.0, requests=100.0,
           shed=0.0, restarts=0.0):
    return dict(gauges={"serve/health_state": health,
                        "serve/dispatcher_alive": alive,
                        "serve/queue_depth_now": depth,
                        "serve/queue_bound": bound},
                counters={"serve/requests_total": requests,
                          "serve/shed_total": shed,
                          "serve/dispatcher_restarts_total": restarts})


def _fleet(n=2, alive=(1.0, 1.0), depth=(0.0, 0.0), drop=(), scale=True,
           batches=True):
    g = {"serve/replicas": float(n)}
    c = {}
    for i in range(n):
        g.update({f"serve/replica{i}/health_state": 0.0,
                  f"serve/replica{i}/dispatcher_alive": alive[i],
                  f"serve/replica{i}/queue_depth_now": depth[i]})
        c.update({f"serve/replica{i}/requests_total": 10.0,
                  f"serve/replica{i}/images_total": 40.0})
    for name in drop:
        g.pop(name, None)
    if scale:
        c.update({"serve/scale_out_total": 1.0, "serve/scale_in_total": 0.0})
    hist = {f"serve/replica{i}/batch_ms": {"count": 5.0 if batches else 0.0,
                                            "sum": 50.0}
            for i in range(n)}
    return dict(gauges=g, counters=c), hist


CHAOS = {"shed_rate": 0.6, "expired_rate": 0.0,
         "p99_ms_under_overload": 42.0, "dispatcher_restarts": 1,
         "recovery_ms": 55.0, "crash_at_batch": 2, "hung_tickets": 0}
AUTOSCALE = {"enabled": True, "scale_out_fired": 1, "scale_in_fired": 1,
             "breaker_trips": 0, "peak_replicas": 2,
             "scale_out_before_breaker": True, "scaled_in_after_load": True}


def _ledger(*recs):
    def write(d):
        for kind, fields in recs:
            jax_events.append_event(d, kind, **fields)
    return write


def _storm(d):
    for i in range(8):
        jax_events.append_event(d, "start", restart_index=i + 1,
                                downtime_s=1.0, time=NOW - 10 * i)
        jax_events.append_event(d, "exit", cause="crash", exit_code=1,
                                uptime_s=1.0, step=0, time=NOW - 10 * i)


def _file(name, blob):
    def write(d):
        with open(os.path.join(d, name), "w") as f:
            f.write(blob if isinstance(blob, str) else json.dumps(blob))
    return write


def _requests(rows):
    return _file("requests.jsonl", "".join(json.dumps(r) + "\n"
                                           for r in rows))


def _rows(n_ok=50, n_failed=0, slow=0):
    rows = []
    for i in range(n_ok + n_failed):
        ok = i < n_ok
        rows.append({"rid": f"r{i}", "seed": i, "psi": 0.7,
                     "outcome": "fulfilled" if ok else "failed",
                     "e2e_ms": 5000.0 if i < slow else 10.0 + i,
                     "t_wall": NOW - 60 + i * 0.1,
                     "events": [{"kind": "admit", "t_ms": 0.0},
                                {"kind": "done", "t_ms": 10.0 + i}]})
    return rows


def _strip(*keys):
    def write(d):
        p = os.path.join(d, "stats.jsonl")
        rec = json.loads(open(p).read())
        for k in keys:
            del rec["telemetry"]["counters"][k]
        open(p, "w").write(json.dumps(rec) + "\n")
    return write


def _histograms(hist):
    def write(d):
        p = os.path.join(d, "stats.jsonl")
        rec = json.loads(open(p).read())
        rec["telemetry"]["histograms"] = hist
        open(p, "w").write(json.dumps(rec) + "\n")
    return write


_FLEET_OK, _FLEET_H = _fleet()
_FLEET_DEAD, _ = _fleet(alive=(0.0, 0.0), depth=(2.0, 0.0))
_FLEET_MISSING, _ = _fleet(drop=("serve/replica1/queue_depth_now",))
_FLEET_NOSCALE, _ = _fleet(scale=False)
_FLEET_UNSAMPLED, _FLEET_HU = _fleet(batches=False)

# name -> (synth_run_dir kwargs, run_doctor kwargs, writers)
DOCTOR_CASES = {
    "healthy": ({}, {}, ()),
    "sampler_off": ({"gauges": {"device/sampler_off": 1.0}}, {}, ()),
    "wall_lies": ({"gauges": {"device/wall_busy_ratio": 1.4}}, {}, ()),
    "host_bound": ({"gauges": {"device/wall_busy_ratio": 0.1}}, {}, ()),
    "no_sample": ({"counters": {"device/samples_total": 0.0},
                   "gauges": {"device/unavailable": 1.0}}, {}, ()),
    "mfu_diverges": ({"gauges": {"device/mfu": 0.20},
                      "stats": {"timing/mfu": 0.35}}, {}, ()),
    "mfu_agrees": ({"gauges": {"device/mfu": 0.31}}, {}, ()),
    "no_mfu": ({"stats": {"timing/mfu": None}}, {}, ()),
    "input_bound": ({"stats": {"timing/data_wait_frac": 0.6},
                     "counters": {"data/starved_total": 7.0}}, {}, ()),
    "retraces_hbm": ({"counters": {"compile/retraces_total": 3.0},
                      "gauges": {"hbm/peak_bytes": 15.5e9}}, {}, ()),
    "hbm_cpu": ({"gauges": {"hbm/unavailable": 1.0}}, {}, ()),
    "no_retrace_watch": ({}, {}, (_strip("compile/retraces_total",
                                         "compile/compiles_total"),)),
    "stale_judged": ({"beats": {0: {"time": NOW - 5.0, "step": 4000},
                                1: {"time": NOW - 500.0, "step": 4000}}},
                     {"max_age_s": 120.0}, ()),
    "stale_unjudged": ({"beats": {0: {"time": NOW - 5.0, "step": 4000},
                                  1: {"time": NOW - 500.0, "step": 4000}}},
                       {}, ()),
    "all_missing": ({"beats": {}}, {"expected": 2}, ()),
    "no_beats": ({"beats": {}}, {}, ()),
    "straggler": ({"beats": {0: {"time": NOW - 5.0, "step": 4000},
                             1: {"time": NOW - 5.0, "step": 2400}}},
                  {"max_step_skew": 1000}, ()),
    "skew_unjudged": ({"beats": {0: {"time": NOW - 5.0, "step": 4000},
                                 1: {"time": NOW - 5.0, "step": 2400}}},
                      {}, ()),
    "resumes": ({"resumes": 2}, {}, ()),
    "serve_ok": (_serve(), {}, ()),
    "serve_tripped": (_serve(health=2.0, alive=0.0), {}, ()),
    "serve_dead": (_serve(health=1.0, alive=0.0, depth=3.0), {}, ()),
    "serve_shed": (_serve(requests=95.0, shed=5.0), {}, ()),
    "serve_saturated": (_serve(depth=256.0), {}, ()),
    "serve_closed": (_serve(health=3.0, depth=0.0), {}, ()),
    "chaos_drill": (_serve(requests=30.0, shed=70.0, restarts=1.0), {},
                    (_file("serve_chaos.json", CHAOS),)),
    "chaos_hung": (_serve(restarts=1.0), {},
                   (_file("serve_chaos.json", dict(CHAOS, hung_tickets=2)),)),
    "chaos_dud": (_serve(restarts=1.0), {},
                  (_file("serve_chaos.json",
                         dict(CHAOS, dispatcher_restarts=0)),)),
    "chaos_sick": (_serve(restarts=1.0), {},
                   (_file("serve_chaos.json", dict(CHAOS, health={
                       "state": "unhealthy",
                       "reasons": ["circuit breaker open"]})),)),
    "chaos_garbage": (_serve(), {}, (_file("serve_chaos.json", "[1, 2]"),)),
    "autoscale_ok": (_serve(restarts=1.0), {},
                     (_file("serve_chaos.json",
                            dict(CHAOS, autoscale=AUTOSCALE)),)),
    "autoscale_late": (_serve(restarts=1.0), {},
                       (_file("serve_chaos.json", dict(CHAOS, autoscale=dict(
                           AUTOSCALE, scale_out_before_breaker=False))),)),
    "fleet_ok": (_FLEET_OK, {}, (_histograms(_FLEET_H),)),
    "fleet_dead": (_FLEET_DEAD, {}, (_histograms(_FLEET_H),)),
    "fleet_missing": (_FLEET_MISSING, {}, (_histograms(_FLEET_H),)),
    "fleet_noscale": (_FLEET_NOSCALE, {}, (_histograms(_FLEET_H),)),
    "fleet_unsampled": (_FLEET_UNSAMPLED, {}, (_histograms(_FLEET_HU),)),
    "fleet_no_members": ({"gauges": {"serve/replicas": 1.0}}, {}, ()),
    "slo_ok": (_serve(), {}, (_requests(_rows()),)),
    "slo_exhausted": (_serve(), {}, (_requests(_rows(40, 10)),)),
    "slo_under_chaos": (_serve(), {}, (_requests(_rows(40, 10, slow=5)),
                                       _file("serve_chaos.json", CHAOS))),
    "data_legacy": ({}, {}, (_strip("data/corrupt_records_total",
                                    "data/read_retries_total",
                                    "data/stalls_total"),)),
    "data_degraded": ({"counters": {"data/corrupt_records_total": 2.0,
                                    "data/read_retries_total": 3.0},
                       "gauges": {"data/corrupt_frac": 0.002}}, {},
                      (_file("data_quarantine.jsonl",
                             '{"file": "x", "offset": 1}\n' * 2),)),
    "data_stalled": ({"counters": {"data/stalls_total": 1.0}}, {}, ()),
    "data_over_budget": ({"counters": {"data/corrupt_records_total": 40.0},
                          "gauges": {"data/corrupt_frac": 0.04,
                                     "data/corrupt_budget_frac": 0.01}},
                         {}, ()),
    "numerics": ({"counters": {"train/nonfinite_total": 3.0,
                               "train/nonfinite_loss_total": 2.0,
                               "train/nonfinite_grad_total": 1.0}}, {}, ()),
    "numerics_legacy": ({}, {}, (_strip(
        "train/nonfinite_total", "train/nonfinite_loss_total",
        "train/nonfinite_grad_total", "train/nonfinite_param_total"),)),
    "availability_ok": ({}, {}, (_ledger(
        ("start", {"restart_index": 0, "downtime_s": 0.0,
                   "time": NOW - 100}),
        ("exit", {"cause": "preemption", "exit_code": 75,
                  "uptime_s": 90.0, "step": 1000, "time": NOW - 10}),
        ("start", {"restart_index": 1, "downtime_s": 10.0,
                   "time": NOW})),)),
    "availability_gave_up": ({}, {}, (_ledger(
        ("exit", {"cause": "crash", "exit_code": 1, "uptime_s": 5.0,
                  "step": 0, "time": NOW}),
        ("give_up", {"restarts": 8, "cause": "crash", "time": NOW})),)),
    "availability_non_retryable": ({}, {}, (_ledger(
        ("exit", {"cause": "data-corrupt", "exit_code": 65,
                  "uptime_s": 5.0, "step": 0, "time": NOW}),
        ("give_up", {"restarts": 0, "cause": "data-corrupt",
                     "non_retryable": True, "time": NOW})),)),
    "availability_storm": ({}, {}, (_storm,)),
    "availability_storm_loose": ({}, {"max_restarts_per_hour": 10.0},
                                 (_storm,)),
    "availability_unclassified": ({}, {}, (_ledger(
        ("exit", {"cause": "gremlins", "exit_code": 1, "uptime_s": 1.0,
                  "step": 0, "time": NOW})),)),
}


def _doctors(d, kw):
    return (port_tele.run_doctor(d, now=NOW, **kw),
            jax_tele.run_doctor(d, now=NOW, **kw))


@pytest.mark.parametrize("case", sorted(DOCTOR_CASES))
def test_doctor_grades_jaxs_fixtures_as_jax(tmp_path, case):
    synth, kw, writers = DOCTOR_CASES[case]
    synth = dict(synth)
    stats = synth.pop("stats", None)
    if stats and any(v is None for v in stats.values()):
        d = synth_run_dir(tmp_path, **synth)
        p = os.path.join(d, "stats.jsonl")
        rec = json.loads(open(p).read())
        for k in stats:
            rec.pop(k)
        open(p, "w").write(json.dumps(rec) + "\n")
    else:
        d = synth_run_dir(tmp_path, stats=stats, **synth)
    for write in writers:
        write(d)
    port, ref = _doctors(d, kw)
    assert port == ref
    assert port_tele.render_doctor(port) == jax_tele.render_doctor(ref)
    assert not port_tele.is_port_run_dir(d)


def test_doctor_of_a_dir_that_is_no_run(tmp_path):
    port, ref = _doctors(str(tmp_path), {})
    assert port == ref and not port["ok"]


def test_resolve_run_dir_as_jax(tmp_path):
    root = tmp_path / "results"
    root.mkdir()
    for name in ("00000-a", "00001-b"):
        synth_run_dir(root, name=name)
    for path in (str(root), str(root / "00000-a"), str(tmp_path)):
        assert port_tele.resolve_run_dir(path) == \
            jax_tele.resolve_run_dir(path)


# --- the subcommands on the same dirs ------------------------------------------

def _main(main, argv, capsys):
    try:
        main(argv)
        code = 0
    except SystemExit as e:
        code = e.code or 0
    out = capsys.readouterr()
    return code, out.out, out.err


@pytest.fixture
def service_dir(tmp_path, monkeypatch):
    """A served dir: events.jsonl (a torn tail), a telemetry.prom with
    serve counters and the p99 exemplar, a request ledger, heartbeats of
    two processes; the clock fixed at ``NOW``."""
    monkeypatch.setattr(time, "time", lambda: NOW)
    d = tmp_path / "serve"
    d.mkdir()
    with open(d / "events.jsonl", "w") as f:
        for i, name in enumerate(["map", "synth", "synth", "dispatch"]):
            f.write(json.dumps({"name": name, "ph": "X", "ts": 1000.0 * i,
                                "dur": 250.0 * (i + 1), "pid": 1,
                                "tid": 1}) + "\n")
        f.write('{"name": "syn')
    with open(d / "telemetry.prom", "w") as f:
        f.write("# TYPE serve_requests_total counter\n"
                "serve_requests_total 50.0\n"
                "# TYPE serve_shed_total counter\nserve_shed_total 2.0\n"
                "# TYPE serve_e2e_ms summary\nserve_e2e_ms_count 50.0\n"
                "serve_e2e_ms_sum 900.0\nserve_e2e_ms_max 59.0\n"
                "# EXEMPLAR serve_e2e_ms_max r49\n")
    _requests(_rows(50, 3, slow=2))(str(d))
    for idx, (age, step) in enumerate(((5.0, 4000), (400.0, 2000))):
        with open(d / f"heartbeat-p{idx}.json", "w") as f:
            json.dump({"process": idx, "pid": 1, "host": "h",
                       "time": NOW - age, "step": step, "kimg": 4.0}, f)
    return str(d)


COMMANDS = [
    ["summary"], ["heartbeats"], ["heartbeats", "--max-age", "60"],
    ["heartbeats", "--expected", "3"], ["heartbeats", "--max-skew", "100"],
    ["requests"], ["requests", "--worst", "3"], ["requests", "--id", "r49"],
    ["requests", "--id", "nope"], ["slo"], ["slo", "--json"],
    ["slo", "--window", "1"], ["fleet"], ["fleet", "--expected", "3"],
    ["doctor"], ["doctor", "--json"], ["doctor", "--max-age", "60"],
]


@pytest.mark.parametrize("argv", COMMANDS, ids=" ".join)
def test_subcommands_match_jax(service_dir, capsys, argv):
    cmd, rest = argv[0], argv[1:]
    port = _main(port_tele.main, [cmd, service_dir] + rest, capsys)
    ref = _main(jax_tele.main, [cmd, service_dir] + rest, capsys)
    assert port == ref


def test_trace_matches_jax(service_dir, capsys):
    out = os.path.join(service_dir, "trace.json")
    ref = _main(jax_tele.main, ["trace", service_dir], capsys)
    ref_doc = open(out).read()
    os.remove(out)
    port = _main(port_tele.main, ["trace", service_dir], capsys)
    assert port == ref and open(out).read() == ref_doc
    assert len(json.loads(ref_doc)["traceEvents"]) == 4


def test_requests_without_a_ledger_fails_as_jax(tmp_path, capsys):
    port = _main(port_tele.main, ["requests", str(tmp_path)], capsys)
    ref = _main(jax_tele.main, ["requests", str(tmp_path)], capsys)
    assert port == ref and port[0] == 1


def test_fleet_over_run_dirs_and_out_dir_match_jax(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.setattr(time, "time", lambda: NOW)
    dirs = [synth_run_dir(tmp_path, name=f"r{i}", beats={
        0: {"time": NOW - 5.0 - i, "step": 4000 - 100 * i}})
        for i in range(3)]
    port = _main(port_tele.main, ["fleet"] + dirs, capsys)
    ref = _main(jax_tele.main, ["fleet"] + dirs, capsys)
    assert port == ref
    files = {}
    for pkg, main in (("port", port_tele.main), ("jax", jax_tele.main)):
        out = str(tmp_path / f"out_{pkg}")
        code, text, _ = _main(main, ["fleet"] + dirs + [
            "--expected", "4", "--out-dir", out], capsys)
        assert code == 0 and "PARTIAL view" in text
        files[pkg] = [open(os.path.join(out, n)).read()
                      for n in ("fleet.json", "fleet.prom")]
    assert files["port"] == files["jax"]


# --- a run dir of the port's own loop -----------------------------------------

@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    cfg = micro_cfg(attention="simplex", batch=8)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, total_kimg=6 * 8 / 1000, kimg_per_tick=2 * 8 / 1000,
        snapshot_ticks=0, image_snapshot_ticks=0, device_time_ticks=1))
    run = str(tmp_path_factory.mktemp("port") / "run")
    loop.train(port_config.ExperimentConfig.from_json(cfg.to_json()), run,
               device="cpu")
    return run


def test_port_run_dir_gets_no_warn_from_a_family_it_lacks(port_run):
    assert port_tele.is_port_run_dir(port_run)
    port, ref = _doctors(port_run, {})
    pl = {c["name"]: c for c in port["checks"]}
    rl = {c["name"]: c for c in ref["checks"]}
    assert pl["compiles"]["level"] == "PASS"
    assert pl["compiles"]["detail"].startswith("no counterpart")
    assert rl["compiles"]["level"] == "WARN"
    assert "retrace watch never armed" in rl["compiles"]["detail"]
    # a WARN left is the run's own signal (a starved first batch on a
    # loaded host), never a family the port lacks
    assert {c["name"] for c in port["checks"] if c["level"] == "WARN"} <= {
        "queues", "data_wait"}
    # every other section is graded as JAX's doctor grades it
    del pl["compiles"], rl["compiles"]
    assert pl == rl
    assert pl["device_truth"]["level"] == "PASS"
    assert pl["hbm"]["detail"].startswith("backend reports no memory")
    assert pl["mfu"]["detail"].startswith("no MFU bookkeeping")
