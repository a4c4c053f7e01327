"""The port's serve CLI (``gansformer_tpu_torch/cli/serve.py``) on the CPU,
against the JAX package's serve CLI.

The JAX CLI runs with ``--no-warm-start`` over stand-ins for its bundle,
programs and service (the stand-in service records the seeds submitted
to it), so it compiles nothing and writes nothing under
``.jax_compile_cache/``: what is compared is the CLI itself, its demo
mix and its summary line.  The port's CLI serves a micro duplex run dir
(``tests/test_torch_serve_programs``) with ``--device cpu``.
"""

import dataclasses
import json
import os
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gansformer_tpu.core.config import ExperimentConfig as JaxExperiment
from gansformer_tpu_torch.cli import serve as port_serve
from gansformer_tpu_torch.obs import registry as telemetry
from gansformer_tpu_torch.obs.registry import parse_prom_values
from gansformer_tpu_torch.utils.image import decode_png
from tests.test_torch_generate import _exp
from tests.test_torch_serve_programs import _port_run

ARGS = ["--images", "11", "--seed", "3", "--buckets", "1,4", "--psi", "0.6"]


def _run_jax_cli(argv, monkeypatch, capsys):
    """The JAX serve CLI over stand-ins; (seeds submitted, summary)."""
    import gansformer_tpu.serve as jserve
    from gansformer_tpu.cli import serve as jax_serve
    from gansformer_tpu.utils import hostenv

    submitted = []

    class Programs:
        def __init__(self, bundle, **kw):
            assert kw["manifest_dir"] is None

        def warm_start(self):
            return {"loaded": 0, "compiled": 0, "seconds": 0.0}

    class Service:
        def __init__(self, programs, **kw):
            pass

        def install_signal_drain(self, grace_s):
            pass

        def submit(self, seed, psi):
            submitted.append(seed)
            return SimpleNamespace(
                result=lambda timeout=None: np.zeros((4, 4, 3), np.float32))

        def health(self):
            return {"state": "ready"}

        def close(self, timeout=None):
            pass

    bundle = SimpleNamespace(cfg=SimpleNamespace(
        model=SimpleNamespace(label_dim=0)))
    monkeypatch.setattr(jserve, "ServePrograms", Programs)
    monkeypatch.setattr(jserve, "GenerationService", Service)
    monkeypatch.setattr(jserve, "init_generator", lambda cfg, seed: bundle)
    monkeypatch.setattr(hostenv, "enable_compile_cache", lambda: None)
    capsys.readouterr()
    assert jax_serve.main(argv) == 0
    return submitted, json.loads(capsys.readouterr().out.splitlines()[-1])


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("serve_cli"))
    return _port_run(root, JaxExperiment.from_json(_exp().to_json()))


def _run_port(argv, capsys):
    capsys.readouterr()
    assert port_serve.main(argv) == 0
    return json.loads(capsys.readouterr().out.splitlines()[-1])


def test_demo_mix_and_summary_match_the_jax_cli(run_dir, tmp_path,
                                                 monkeypatch, capsys):
    """The port serves the JAX CLI's seeds (its Zipfian draw) through its
    service and prints the JAX CLI's summary keys, ``health``,
    ``replicas`` and ``autoscale`` included; the grid holds every
    request, ``telemetry.prom`` the counters; the first request alone,
    then the rest, batched by the service."""
    seeds, jsum = _run_jax_cli(
        ["--init", "random", "--preset", "ffhq256-duplex", "--no-warm-start",
         "--out", str(tmp_path / "jax")] + ARGS, monkeypatch, capsys)
    monkeypatch.undo()
    served = []
    orig = port_serve.demo_seeds

    def spy(seed, n):
        out = orig(seed, n)
        served.extend(int(s) for s in out)
        return out

    monkeypatch.setattr(port_serve, "demo_seeds", spy)
    telemetry.get_registry().reset()
    out = str(tmp_path / "port")
    psum = _run_port(["--run-dir", run_dir, "--device", "cpu", "--out", out,
                      "--no-warm-start"] + ARGS, capsys)
    assert served == [int(s) for s in seeds] and len(served) == 11
    assert len(set(served)) < len(served)           # hot seeds repeat
    assert set(psum) == set(jsum)
    assert psum["replicas"] == jsum["replicas"] == 1
    assert psum["autoscale"] is jsum["autoscale"] is False
    assert psum["health"]["state"] == "ready" and \
        psum["health"]["dispatcher_restarts"] == 0
    assert psum["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    assert psum["warm_start"] == {"loaded": 0, "compiled": 0, "seconds": 0.0}
    assert psum["manifest_dir"] is None and psum["buckets"] == [1, 4]
    assert psum["serve_precision"] == "f32" and psum["restore_ms"] >= 0
    assert psum["e2e_ms"]["count"] == 11            # one per ticket
    assert psum["first_image_ms"] > 0 and psum["out"] == out
    c = psum["counters"]
    assert c["requests_total"] == c["images_total"] == 11
    assert c["shed_total"] == c["expired_total"] == 0
    # the first alone, then the other 10 in batches of at most 4
    assert 1 + 3 <= c["synth_dispatch_total"] <= 11
    assert c["map_dispatch_total"] <= c["synth_dispatch_total"]
    assert c["wcache_hits_total"] + c["wcache_misses_total"] == 11
    # a hit is a seed some earlier batch mapped; the first is a miss
    assert c["wcache_misses_total"] >= len(set(served))
    with open(os.path.join(out, "served_grid.png"), "rb") as f:
        grid = decode_png(f.read())
    assert grid.shape[2] == 3 and grid.size >= 11 * 16 * 16 * 3
    prom = parse_prom_values(os.path.join(out, "telemetry.prom"))
    assert prom["serve_synth_dispatch_total"] == 4


@pytest.mark.parametrize("precision", ["bf16", "int8w"])
def test_precisions_serve_on_the_cpu(run_dir, tmp_path, capsys, precision):
    psum = _run_port(["--run-dir", run_dir, "--device", "cpu", "--out",
                      str(tmp_path), "--serve-precision", precision,
                      "--images", "3", "--no-warm-start"], capsys)
    assert psum["serve_precision"] == precision
    assert os.path.exists(tmp_path / "served_grid.png")


def test_warm_only_serves_nothing(run_dir, tmp_path, capsys):
    psum = _run_port(["--run-dir", run_dir, "--device", "cpu", "--out",
                      str(tmp_path / "o"), "--warm-only", "--manifest-dir",
                      str(tmp_path / "m")], capsys)
    assert psum["manifest_dir"] == str(tmp_path / "m")
    assert "first_image_ms" not in psum and "counters" not in psum
    assert not os.path.exists(tmp_path / "o")


def test_no_warm_start_removes_its_build_dir(run_dir, tmp_path, capsys,
                                             monkeypatch):
    made = []
    orig = tempfile.mkdtemp

    def mkdtemp(*a, **k):
        made.append(orig(*a, **k))
        return made[-1]

    monkeypatch.setattr(tempfile, "mkdtemp", mkdtemp)
    _run_port(["--run-dir", run_dir, "--device", "cpu", "--warm-only",
               "--no-warm-start"], capsys)
    assert len(made) == 1 and not os.path.exists(made[0])


# the JAX serve CLI's flags of the service and the fleet
JAX_SERVICE_FLAGS = ("--autoscale", "--deadline-s", "--grace-s",
                     "--health-max-age", "--healthcheck", "--max-replicas",
                     "--queue-depth", "--replicas")


@pytest.mark.parametrize("flag", JAX_SERVICE_FLAGS)
def test_service_flags_are_refused_with_words(flag):
    """The replica fleet's flags are refused (``--replicas`` above 1),
    with words that name it; the service's flags are taken."""
    assert set(port_serve.LATER_FLAGS) == {"--replicas", "--max-replicas",
                                           "--autoscale"}
    if flag in port_serve.LATER_FLAGS:
        with pytest.raises(SystemExit,
                           match=r"replica fleet \(ROADMAP A.4c\)"):
            port_serve.main([flag, "2"])
        with pytest.raises(SystemExit, match="replica fleet"):
            port_serve.main([f"{flag}=3", "--device", "cpu"])
        return
    args = port_serve.build_parser().parse_args([flag, "2"])
    assert getattr(args, flag[2:].replace("-", "_")) in (2, 2.0, "2")
    if flag == "--healthcheck":
        return
    args = port_serve.build_parser().parse_args(
        ["--replicas", "1", "--queue-depth", "5", "--deadline-s", "2",
         "--grace-s", "3", "--healthcheck", "p", "--health-max-age", "9"])
    assert (args.replicas, args.queue_depth, args.deadline_s, args.grace_s,
            args.healthcheck, args.health_max_age) == (1, 5, 2.0, 3.0, "p",
                                                       9.0)


def test_without_a_card_it_raises_unless_asked_for_the_cpu(run_dir,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_serve.main(["--run-dir", run_dir, "--warm-only"])
    with pytest.raises(SystemExit, match="needs --preset"):
        port_serve.main(["--init", "random", "--device", "cpu"])
    with pytest.raises(SystemExit, match="needs --run-dir"):
        port_serve.main(["--device", "cpu"])


def test_conditional_demo_is_refused_with_the_jax_words(tmp_path, capsys):
    exp = _exp()
    exp = dataclasses.replace(exp, model=dataclasses.replace(
        exp.model, label_dim=3))
    run = _port_run(str(tmp_path), JaxExperiment.from_json(exp.to_json()))
    with pytest.raises(SystemExit, match="model has label_dim=3: the demo "
                       "traffic can't supply labels"):
        port_serve.main(["--run-dir", run, "--device", "cpu",
                         "--no-warm-start"])
    psum = _run_port(["--run-dir", run, "--device", "cpu", "--warm-only",
                      "--no-warm-start"], capsys)
    assert psum["warm_start"]["compiled"] == 0


HEALTH_BASE = {"serve_health_state": 0, "serve_dispatcher_alive": 1,
               "serve_queue_depth_now": 0, "serve_queue_bound": 8,
               "serve_dispatcher_restarts_total": 0, "serve_shed_total": 2,
               "serve_expired_total": 1, "serve_cancelled_total": 0}
HEALTH_CASES = {
    "ready": ({}, None),
    "degraded": ({"serve_health_state": 1,
                  "serve_dispatcher_restarts_total": 1}, None),
    "unhealthy": ({"serve_health_state": 2, "serve_dispatcher_alive": 0},
                  None),
    "closed": ({"serve_health_state": 3, "serve_dispatcher_alive": 0},
               None),
    "dead_with_work": ({"serve_dispatcher_alive": 0,
                        "serve_queue_depth_now": 3}, None),
    "stale": ({}, 60.0),
    "fresh_with_max_age": ({}, 1e9),
    "fleet_one_dead_with_work": ({
        "serve_replicas": 2, "serve_replica0_dispatcher_alive": 1,
        "serve_replica1_dispatcher_alive": 0,
        "serve_replica1_queue_depth_now": 2, "serve_scale_out_total": 1,
        "serve_scale_in_total": 0}, None),
    "fleet_all_dead_with_work": ({
        "serve_replicas": 2, "serve_replica0_dispatcher_alive": 0,
        "serve_replica1_dispatcher_alive": 0,
        "serve_replica1_queue_depth_now": 2}, None),
    "not_serving": (None, None),
    "missing": ("missing", None),
}


@pytest.mark.parametrize("case", sorted(HEALTH_CASES))
def test_healthcheck_verdicts_equal_the_jax_cli(case, tmp_path, capsys):
    """``--healthcheck`` of the port and ``healthcheck`` of the JAX CLI on
    the same prom give the same exit code and the same JSON (the
    snapshot's age within 0.2 s); the port's run touches no device."""
    from gansformer_tpu.cli import serve as jax_serve

    vals, max_age = HEALTH_CASES[case]
    path = str(tmp_path / "telemetry.prom")
    if vals != "missing":
        with open(path, "w") as f:
            for k, v in ({"train_step": 1} if vals is None
                         else dict(HEALTH_BASE, **vals)).items():
                f.write(f"# TYPE {k} gauge\n{k} {v}\n")
        old = time.time() - 3600.0
        os.utime(path, (old, old))
    capsys.readouterr()
    want = jax_serve.healthcheck(str(tmp_path) if case == "ready" else path,
                                 max_age_s=max_age)
    jout = json.loads(capsys.readouterr().out.strip())
    argv = ["--healthcheck", str(tmp_path) if case == "ready" else path]
    if max_age is not None:
        argv += ["--health-max-age", str(max_age)]
    got = port_serve.main(argv)
    pout = json.loads(capsys.readouterr().out.strip())
    assert got == want
    age_j, age_p = jout.pop("snapshot_age_s", 0.0), pout.pop(
        "snapshot_age_s", 0.0)
    assert abs(age_j - age_p) <= 0.2
    assert pout == jout
    expect_ok = case in ("ready", "degraded", "closed", "fresh_with_max_age",
                         "fleet_one_dead_with_work")
    assert got == (0 if expect_ok else 1), (case, pout)


def test_health_vocabulary_equals_jax():
    """The probe's copy of the health names, the service's and JAX's
    agree, and so do the health codes."""
    import gansformer_tpu.serve.service as jax_service
    from gansformer_tpu.analysis.telemetry_schema import SERVE_HEALTH_NAMES

    from gansformer_tpu_torch.serve import service as port_service

    assert port_serve.SERVE_HEALTH_NAMES == SERVE_HEALTH_NAMES == \
        port_service.HEALTH_NAMES
    for name in ("HEALTH_READY", "HEALTH_DEGRADED", "HEALTH_UNHEALTHY",
                 "HEALTH_CLOSED"):
        assert getattr(port_service, name) == getattr(jax_service, name)
