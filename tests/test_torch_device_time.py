"""The port's ``DeviceTimeSampler`` against the JAX package's: with the
trace report stubbed to the same dict on both sides (and each profiler's
start and stop stubbed), the two fold the same gauges and counters, take
the same ticks over 0-17 at every 1, 3 and 8, and count failed and
unavailable samples the same way.  Then the loop: a micro CPU run with
``device_time_ticks=1`` whose ``telemetry.prom`` device family passes
JAX's ``check_metric_families``, ``profile_dir`` writing a Chrome trace
of tick 1, and ``--profile-dir`` / ``--device-time-ticks`` parsed as
JAX's train CLI parses them."""

import glob
import os

import pytest

import gansformer_tpu.obs.device_time as jax_dt
import gansformer_tpu.utils.profparse as jax_pp
from gansformer_tpu.analysis.telemetry_schema import check_metric_families
from gansformer_tpu.cli import train as jax_train_cli
from gansformer_tpu.obs import registry as jax_registry
from gansformer_tpu_torch.cli import train as train_cli
from gansformer_tpu_torch.core import config as port_config
from gansformer_tpu_torch.obs import device_time as port_dt
from gansformer_tpu_torch.obs import registry as port_registry
from gansformer_tpu_torch.obs.registry import parse_prom_values
from gansformer_tpu_torch.train import loop
from gansformer_tpu_torch.utils.profparse import device_time_report
from tests.test_train import micro_cfg
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

OK_REPORT = {"status": "ok", "source": "chrome-trace", "plane": "/x",
             "busy_s": 0.75, "span_s": 0.9, "events": 1234,
             "program_busy_s": {f"p{i:02d}": 0.01 * (i + 1)
                                for i in range(14)}}
UNAVAILABLE = {"status": "unavailable", "reason": "no parseable trace"}


class _Prof:
    def __init__(self, fail_stop):
        self.fail_stop = fail_stop

    def stop(self):
        if self.fail_stop:
            raise RuntimeError("stop failed")


@pytest.fixture
def stubbed(monkeypatch):
    """Both samplers over stub profilers and one stub report; ``state``
    scripts the next start's and stop's failures and the report."""
    import jax

    state = {"report": OK_REPORT, "fail_start": False, "fail_stop": False}

    def jax_start(d):
        if state["fail_start"]:
            raise RuntimeError("busy")

    def jax_stop():
        if state["fail_stop"]:
            raise RuntimeError("stop failed")

    def port_start(device=None):
        if state["fail_start"]:
            raise RuntimeError("busy")
        return _Prof(state["fail_stop"])

    monkeypatch.setattr(jax.profiler, "start_trace", jax_start)
    monkeypatch.setattr(jax.profiler, "stop_trace", jax_stop)
    monkeypatch.setattr(port_dt, "start_profiler", port_start)
    monkeypatch.setattr(jax_pp, "device_time_report",
                        lambda d: dict(state["report"]))
    monkeypatch.setattr(port_dt, "profile_report",
                        lambda prof, host_ops=True: dict(state["report"]))
    jax_registry.get_registry().reset()
    port_registry.get_registry().reset()
    yield state
    jax_registry.get_registry().reset()
    port_registry.get_registry().reset()


def _snapshots():
    return (jax_registry.get_registry().snapshot(),
            port_registry.get_registry().snapshot())


@pytest.mark.parametrize("every", [0, 1, 3, 8])
def test_cadence_and_folds_match_jax(stubbed, every):
    js = jax_dt.DeviceTimeSampler(every_ticks=every)
    ps = port_dt.DeviceTimeSampler(every_ticks=every, device="cpu")
    assert ps.enabled == js.enabled
    j, p = _snapshots()
    assert p == j
    started = []
    for tick in range(18):
        a, b = js.maybe_start(tick), ps.maybe_start(tick)
        assert a == b, tick
        if a:
            started.append(tick)
            rj = js.stop_and_fold(wall_s=1.5, iters=4)
            rp = ps.stop_and_fold(wall_s=1.5, iters=4)
            assert {k: v for k, v in rp.items() if k not in (
                "stop_s", "fold_s")} == rj
    assert started == [t for t in range(18) if every and
                       t % every == 1 % every]
    j, p = _snapshots()
    assert p == j
    if every:
        assert p["counters"]["device/samples_total"] == len(started)
        assert p["gauges"]["device/wall_busy_ratio"] == 0.75 / 1.5
        assert len([k for k in p["gauges"]
                    if k.startswith("device/phase_ms/")]) == 12
    assert p["gauges"]["device/sampler_off"] == (0.0 if every else 1.0)


@pytest.mark.parametrize("fault", ["start", "stop", "unavailable"])
def test_failed_samples_count_as_in_jax(stubbed, fault):
    js = jax_dt.DeviceTimeSampler(every_ticks=1)
    ps = port_dt.DeviceTimeSampler(every_ticks=1, device="cpu")
    stubbed["fail_start"] = fault == "start"
    stubbed["fail_stop"] = fault == "stop"
    if fault == "unavailable":
        stubbed["report"] = UNAVAILABLE
    for s in (js, ps):
        if s.maybe_start(1):
            s.stop_and_fold(wall_s=1.0, iters=2)
    j, p = _snapshots()
    assert p == j
    assert p["counters"]["device/sample_failed_total"] == 1.0
    # a failed sample leaves the sampler ready for the next window
    stubbed.update(fail_start=False, fail_stop=False, report=OK_REPORT)
    for s in (js, ps):
        assert s.maybe_start(2)
        s.stop_and_fold(wall_s=1.0, iters=2)
        s.close()
    j, p = _snapshots()
    assert p == j and p["counters"]["device/samples_total"] == 1.0


def test_close_releases_an_open_sample(stubbed):
    ps = port_dt.DeviceTimeSampler(every_ticks=1, device="cpu")
    assert ps.maybe_start(5) and ps.sampling
    ps.close()
    assert not ps.sampling and ps.stop_and_fold() is None


BATCH = 8


def micro_exp(ticks, **train):
    import dataclasses

    cfg = micro_cfg(attention="simplex", batch=BATCH)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, total_kimg=2 * ticks * BATCH / 1000,
        kimg_per_tick=2 * BATCH / 1000, snapshot_ticks=0,
        image_snapshot_ticks=0, **train))
    return port_config.ExperimentConfig.from_json(cfg.to_json())


def test_loop_samples_every_tick_and_its_prom_passes_jax_checks(tmp_path):
    """A micro CPU run at ``device_time_ticks=1``: ticks 1 and 2 are
    sampled (tick 0's window starts at setup), each sample's line is in
    log.txt, and the device family of telemetry.prom passes JAX's
    check_metric_families."""
    run = str(tmp_path / "run")
    loop.train(micro_exp(3, device_time_ticks=1), run, device="cpu")
    vals = parse_prom_values(os.path.join(run, "telemetry.prom"))
    assert vals["device_samples_total"] == 2.0
    assert vals["device_sampler_off"] == 0.0
    assert vals.get("device_sample_failed_total", 0.0) == 0.0
    assert 0 < vals["device_wall_busy_ratio"] <= 1.1
    phases = {k for k in vals if k.startswith("device_phase_ms_")}
    assert phases == {f"device_phase_ms_{k}" for k in (
        "d_step", "d_step_r1", "g_step", "g_step_pl")}
    assert sum(vals[k] for k in phases) <= vals["device_busy_ms"] * (
        1 + 1e-9)
    errs = check_metric_families(os.path.join(run, "telemetry.prom"))
    assert [e for e in errs if "device" in e] == []
    log = open(os.path.join(run, "log.txt")).read()
    assert log.count("device sample: busy") == 2
    assert "not in the port yet" not in log


def test_profile_dir_traces_tick_one_and_turns_the_sampler_off(tmp_path):
    run, prof = str(tmp_path / "run"), str(tmp_path / "prof")
    loop.train(micro_exp(3, profile_dir=prof), run, device="cpu")
    traces = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    assert len(traces) == 1
    rep = device_time_report(prof)
    assert rep["status"] == "ok"
    # tick 1 runs iterations 2 and 3: regularized (every 2), then not
    assert set(rep["program_busy_s"]) == {"d_step", "d_step_r1", "g_step",
                                          "g_step_pl"}
    vals = parse_prom_values(os.path.join(run, "telemetry.prom"))
    assert vals["device_sampler_off"] == 1.0
    log = open(os.path.join(run, "log.txt")).read()
    assert "profiler: tracing the window logged as Progress/tick=1" in log
    assert "profiler: trace complete" in log


@pytest.mark.parametrize("argv", [
    [], ["--device-time-ticks", "0"], ["--device-time-ticks", "3"],
    ["--profile-dir", "prof"],
    ["--profile-dir", "p", "--device-time-ticks", "1"]])
def test_cli_flags_parse_as_in_jax(argv):
    base = ["--preset", "ffhq256-duplex"]
    port = train_cli.config_from_args(train_cli.build_parser().parse_args(
        base + argv)).train
    train_cli.refuse_later_flags(argv)          # no longer refused
    ref = jax_train_cli.config_from_args(
        jax_train_cli.build_parser().parse_args(base + argv)).train
    assert (port.device_time_ticks, port.profile_dir) == (
        ref.device_time_ticks, ref.profile_dir)


def test_negative_cadence_is_refused_as_in_jax():
    argv = ["--preset", "ffhq256-duplex", "--device-time-ticks", "-1"]
    with pytest.raises(ValueError) as port:
        train_cli.config_from_args(train_cli.build_parser().parse_args(argv))
    with pytest.raises(ValueError) as ref:
        jax_train_cli.config_from_args(
            jax_train_cli.build_parser().parse_args(argv))
    line = "device_time_ticks must be ≥ 0 (0 = off), got -1"
    assert line in str(port.value) and line in str(ref.value)
