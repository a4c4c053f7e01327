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
    """The port serves the JAX CLI's seeds (its Zipfian draw) and prints
    its summary keys, less the service's ``health``, ``replicas`` and
    ``autoscale``; the grid holds every request, ``telemetry.prom`` the
    counters; the first request alone, then chunks of the largest
    bucket."""
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
    assert set(psum) == set(jsum) - {"health", "replicas", "autoscale"}
    assert psum["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    assert psum["warm_start"] == {"loaded": 0, "compiled": 0, "seconds": 0.0}
    assert psum["manifest_dir"] is None and psum["buckets"] == [1, 4]
    assert psum["serve_precision"] == "f32" and psum["restore_ms"] >= 0
    assert psum["e2e_ms"]["count"] == 1 + 3         # 1, then 4 + 4 + 2
    assert psum["first_image_ms"] > 0 and psum["out"] == out
    c = psum["counters"]
    assert c["synth_dispatch_total"] == 4
    assert c["map_dispatch_total"] <= 4
    assert c["wcache_hits_total"] + c["wcache_misses_total"] == 11
    # a row is cached once its chunk has mapped it: a hit is a seed
    # served by an earlier chunk
    chunks = [served[:1]] + [served[i:i + 4] for i in range(1, 11, 4)]
    assert c["wcache_hits_total"] == sum(
        s in set().union(*chunks[:i]) for i, ch in enumerate(chunks)
        for s in ch)
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


@pytest.mark.parametrize("flag", sorted(port_serve.LATER_FLAGS))
def test_service_flags_are_refused_with_words(flag):
    with pytest.raises(SystemExit, match="serving service"):
        port_serve.main([flag, "2"])


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
