"""The port's run supervisor (``supervise/supervisor.py``) and
``cli/supervise.py`` against the JAX package's: exit classification and
the hang probe over one table of cases, the same scripted children
(which import neither torch nor JAX) under both supervisors giving the
same ledger (kinds, causes, restart indices, resume flags) and the same
``supervisor.prom`` apart from its time-derived values, JAX's ledger and
metric-family checks on the port's files, the CLI's child argv and its
``--fault`` validation, and the CLIs running without importing torch."""

import dataclasses
import json
import os
import signal
import subprocess
import sys

import pytest

from gansformer_tpu.analysis.telemetry_schema import (
    check_prom, check_supervise_metric_families, check_supervisor_events)
from gansformer_tpu.cli import supervise as jax_cli
from gansformer_tpu.obs.registry import parse_prom_values
from gansformer_tpu.supervise import events as jax_events
from gansformer_tpu.supervise import supervisor as jax_sup
from gansformer_tpu_torch.cli import supervise as port_cli
from gansformer_tpu_torch.supervise import events
from gansformer_tpu_torch.supervise import supervisor as port_sup
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAST = dict(max_restarts=3, backoff_base_s=0.05, backoff_max_s=0.2,
            poll_interval_s=0.05, startup_grace_s=60.0,
            hang_kill_grace_s=0.5)


def test_config_and_vocabulary_are_jaxs():
    assert dataclasses.asdict(port_sup.SupervisorConfig()) == \
        dataclasses.asdict(jax_sup.SupervisorConfig())
    for name in ("EXIT_PREEMPTED", "EXIT_DATA_CORRUPT", "EXIT_DATA_STALLED",
                 "CAUSES", "NON_RETRYABLE_CAUSES", "KINDS", "EVENTS_FILE"):
        assert getattr(events, name) == getattr(jax_events, name), name
    assert port_sup.SUPERVISOR_PROM == jax_sup.SUPERVISOR_PROM


EXITS = [(0, False), (75, False), (65, False), (74, False), (1, False),
         (2, False), (139, False), (-signal.SIGTERM, False),
         (-signal.SIGKILL, False), (0, True), (-signal.SIGKILL, True),
         (75, True)]


@pytest.mark.parametrize("rc,hang", EXITS)
def test_classify_exit_matches_jax(rc, hang):
    assert port_sup.classify_exit(rc, killed_for_hang=hang) == \
        jax_sup.classify_exit(rc, killed_for_hang=hang)


def _beat(run_dir, idx, t, step=0, phase=None):
    rec = {"process": idx, "pid": 1, "host": "h", "time": t, "step": step,
           "kimg": step / 1000}
    if phase:
        rec["phase"] = phase
    with open(os.path.join(run_dir, f"heartbeat-p{idx}.json"), "w") as f:
        json.dump(rec, f)


T0 = 1000.0
# (beats written: [(idx, time, step, phase)], seconds after T0)
PROBES = [
    ([], 20), ([], 31), ([(0, T0 - 50, 0, None)], 31),
    ([(0, T0 + 5, 0, None)], 10), ([(0, T0 + 5, 0, None)], 16),
    ([(0, T0 + 20, 100, None), (1, T0 + 20, 200, None)], 21),
    ([(0, T0 + 20, 100, None), (1, T0 + 20, 103, None)], 21),
    ([(0, T0 + 1, 0, "setup")], 26), ([(0, T0 + 1, 0, "setup")], 40),
    ([(0, T0 + 41, 0, None)], 52), ([(0, T0 + 60, 0, "finalize")], 85),
    ([(0, T0 + 60, 0, "finalize")], 95),
]


@pytest.mark.parametrize("case", range(len(PROBES)))
def test_probe_hang_matches_jax(tmp_path, case):
    beats, after = PROBES[case]
    for idx, t, step, phase in beats:
        _beat(str(tmp_path), idx, t, step, phase)
    kw = dict(heartbeat_max_age_s=10.0, startup_grace_s=30.0,
              max_step_skew=5)
    port = port_sup.probe_hang(str(tmp_path), T0,
                               port_sup.SupervisorConfig(**kw),
                               now=T0 + after)
    ref = jax_sup.probe_hang(str(tmp_path), T0,
                             jax_sup.SupervisorConfig(**kw), now=T0 + after)
    assert port == ref
    assert port_sup.last_heartbeat_step(str(tmp_path)) == \
        jax_sup.last_heartbeat_step(str(tmp_path))


def _child(run_dir, marker, first_exit, then=0):
    """A child that makes ``<run_dir>/checkpoints`` (so a restart
    resumes), exits ``first_exit`` on its first run and ``then`` after."""
    return [sys.executable, "-c",
            "import os, sys\n"
            f"os.makedirs(os.path.join({run_dir!r}, 'checkpoints'), "
            "exist_ok=True)\n"
            f"m = {marker!r}\n"
            "if not os.path.exists(m):\n"
            f"    open(m, 'w').close(); sys.exit({first_exit})\n"
            f"sys.exit({then})"]


# name -> (argv maker(run_dir, marker), config overrides, raise SIGTERM
# at the first "restart #" log line)
SCRIPTS = {
    "crash_then_clean": (lambda d, m: _child(d, m, 2), {}, False),
    "preemption_code": (lambda d, m: _child(d, m, 75), {}, False),
    "data_corrupt_gives_up": (lambda d, m: _child(d, m, 65, 65), {}, False),
    "data_stall_retries": (lambda d, m: _child(d, m, 74), {}, False),
    "budget_exhausted": (lambda d, m: _child(d, m, 3, 3),
                         {"max_restarts": 1}, False),
    "hang_killed": (lambda d, m: [sys.executable, "-c",
                                  "import time; time.sleep(60)"],
                    {"max_restarts": 0, "startup_grace_s": 0.3}, False),
    "preempted_in_backoff": (lambda d, m: _child(d, m, 2, 2), {}, True),
}

# ledger fields that are not time-derived
LEDGER_KEYS = ("kind", "cause", "exit_code", "restart_index", "resume",
               "step", "restarts", "non_retryable", "max_restarts",
               "hang_reason")
TIME_GAUGES = ("supervise_uptime_s_total", "supervise_downtime_s_total",
               "supervise_availability_ratio")


def _run(pkg, sup, tmp_path, name):
    make, over, preempt = SCRIPTS[name]
    base = tmp_path / pkg
    base.mkdir()
    run_dir = str(base / "run")
    argv = make(run_dir, str(base / "marker"))

    def log(msg):
        if preempt and msg.startswith("restart #"):
            signal.raise_signal(signal.SIGTERM)

    cfg = sup.SupervisorConfig(**{**FAST, **over})
    res = sup.supervise(lambda resume, i: argv, run_dir, cfg, log=log)
    ledger = [{k: e[k] for k in LEDGER_KEYS if k in e}
              for e in events.read_events(run_dir)]
    prom = parse_prom_values(os.path.join(run_dir, "supervisor.prom"))
    return run_dir, res, ledger, prom


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_scripted_children_give_jaxs_ledger_and_prom(tmp_path, name):
    jd, jres, jledger, jprom = _run("jax", jax_sup, tmp_path, name)
    pd, pres, pledger, pprom = _run("port", port_sup, tmp_path, name)
    assert pres == jres
    assert pledger == jledger
    assert {k: v for k, v in pprom.items() if k not in TIME_GAUGES} == \
        {k: v for k, v in jprom.items() if k not in TIME_GAUGES}
    assert set(pprom) == set(jprom)
    for ratio in (pprom.get("supervise_availability_ratio"),):
        assert ratio is None or 0.0 <= ratio <= 1.0
    prom = os.path.join(pd, "supervisor.prom")
    assert check_prom(prom) == []
    assert check_supervise_metric_families(prom) == []
    assert check_supervisor_events(events.events_path(pd)) == []
    starts = [e for e in pledger if e["kind"] == "start"]
    assert [e["resume"] for e in starts] == [False] + [True] * (
        len(starts) - 1)
    assert [e["restart_index"] for e in starts] == list(range(len(starts)))


def _capture(monkeypatch, sup):
    seen = {}

    def fake(build_argv, run_dir, cfg, child_env=None, log=None):
        seen.update(argv0=build_argv(False, 0), argv1=build_argv(True, 1),
                    run_dir=run_dir, cfg=dataclasses.asdict(cfg),
                    env=dict(child_env or {}))
        return {"exit_code": 0}
    monkeypatch.setattr(sup, "supervise", fake)
    return seen


def test_cli_builds_jaxs_child_argv_and_config(tmp_path, monkeypatch):
    run_dir = str(tmp_path / "r")
    argv = ["--run-dir", run_dir, "--max-restarts", "2", "--backoff-base",
            "0.5", "--heartbeat-max-age", "40", "--hang-grace", "5",
            "--fault", "sigkill@tick:step=64", "--fault",
            "hang@tick:step=128", "--", "--preset", "ffhq256-duplex",
            "--device-time-ticks", "1"]
    jseen = _capture(monkeypatch, jax_sup)
    pseen = _capture(monkeypatch, port_sup)
    for cli in (jax_cli, port_cli):
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert e.value.code == 0
    for key in ("argv0", "argv1"):
        assert pseen[key] == [
            a.replace("gansformer_tpu.cli.train",
                      "gansformer_tpu_torch.cli.train")
            for a in jseen[key]]
    assert pseen["argv0"][1:3] == ["-m", "gansformer_tpu_torch.cli.train"]
    assert pseen["argv1"][-1] == "--resume"
    for key in ("run_dir", "cfg", "env"):
        assert pseen[key] == jseen[key], key
    assert pseen["env"]["GANSFORMER_TPU_FAULTS"] == \
        "sigkill@tick:step=64,hang@tick:step=128"


def test_cli_validates_fault_specs_before_launch(tmp_path, monkeypatch):
    jseen = _capture(monkeypatch, jax_sup)
    pseen = _capture(monkeypatch, port_sup)
    argv = ["--run-dir", str(tmp_path / "r"), "--fault", "explode@tick"]
    errors = []
    for cli in (jax_cli, port_cli):
        with pytest.raises(Exception) as e:
            cli.main(argv)
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]
    assert jseen == pseen == {}


def test_the_clis_run_without_torch(tmp_path):
    """``cli.supervise`` (over a child that fails at once) and each
    ``cli.telemetry`` command, in one fresh interpreter, leave torch out
    of sys.modules."""
    run = str(tmp_path / "run")
    code = (
        "import json, sys\n"
        "from gansformer_tpu_torch.cli import supervise, telemetry\n"
        "rcs = []\n"
        f"for mod, argv in ((supervise, ['--run-dir', {run!r}, "
        "'--max-restarts', '0', '--poll-interval', '0.05', '--', "
        "'--no-such-flag']),\n"
        f"                  (telemetry, ['doctor', {run!r}]),\n"
        f"                  (telemetry, ['heartbeats', {run!r}]),\n"
        f"                  (telemetry, ['slo', {run!r}]),\n"
        f"                  (telemetry, ['fleet', {run!r}])):\n"
        "    try:\n"
        "        mod.main(argv)\n"
        "        rcs.append(0)\n"
        "    except SystemExit as e:\n"
        "        rcs.append(e.code)\n"
        "print('RESULT', json.dumps({'rcs': rcs, "
        "'torch': 'torch' in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.split("RESULT", 1)[1])
    assert res["torch"] is False
    # the child dies at its argument parse: a crash, no budget left
    assert res["rcs"][0] == 1
    causes = [e["cause"] for e in events.read_events(run)
              if e["kind"] == "exit"]
    assert causes == ["crash"]
