"""The port's metric entry points on the CPU: ``cli/evaluate.py`` on a
micro run dir, the in-loop metric hook of ``train/loop.py`` and
``cli/experiment.py``, each writing its files in the JAX package's
formats (the lines are held byte for byte to what JAX's own writers make
of the same values).

Every run loads one random npz in JAX's layout (``$GANSFORMER_TPU_
INCEPTION_NPZ`` or ``--inception-npz``), so the extractor is calibrated
and builds no probe; the sweeps are a few images each.  16 or fewer
samples of 2048-dim features make low-rank covariances, so scipy's
``sqrtm`` (20 s a call at 2048² here) is replaced by the low-rank
stand-in of ``test_torch_metrics`` in these processes.
"""

import dataclasses
import json
import os
import re

import pytest
import scipy.linalg

from gansformer_tpu.utils import logging as jax_logging
from gansformer_tpu_torch.cli import evaluate, experiment
from gansformer_tpu_torch.core import config as port_config
from gansformer_tpu_torch.train import loop
from tests.test_torch_metrics import lowrank_sqrtm
from tests.test_torch_metrics_inception import write_inception_npz
from tests.test_train import micro_cfg
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

BATCH = 4


def micro_exp(ticks=1, **train):
    """The JAX micro configuration, two iterations a tick."""
    cfg = micro_cfg(attention="simplex", batch=BATCH)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, total_kimg=ticks * 2 * BATCH / 1000,
        kimg_per_tick=2 * BATCH / 1000, snapshot_ticks=1,
        image_snapshot_ticks=1, **train))
    return port_config.ExperimentConfig.from_json(cfg.to_json())


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    return write_inception_npz(tmp_path_factory.mktemp("inc") / "w.npz")


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("run"))
    loop.train(micro_exp(), d, device="cpu")
    return d


@pytest.fixture(autouse=True)
def fast_sqrtm(monkeypatch):
    monkeypatch.setattr(scipy.linalg, "sqrtm", lowrank_sqrtm)


def _jax_lines(tmp_path, rows):
    """What JAX's writers make of the same (name, value, kimg) rows."""
    d = tmp_path / "jax_lines"
    d.mkdir(exist_ok=True)
    for name, value, kimg in rows:
        jax_logging.append_metric_line(str(d), name, value, kimg)
    return d


def test_evaluate_writes_jax_formats(run_dir, npz, capsys, tmp_path):
    payload = evaluate.main([
        "--run-dir", run_dir, "--metrics", "fid,is,pr,ppl",
        "--num-images", "8", "--batch-size", str(BATCH),
        "--inception-npz", npz, "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == payload
    assert payload["kimg"] == 0.008 and payload["calibrated"] == 1.0
    names = {"fid8", "is8_mean", "is8_std", "pr8_3_precision",
             "pr8_3_recall", "ppl8_wfull"}
    assert set(payload) == names | {"kimg", "calibrated"}
    assert re.match(r"sweep: generator [\d.]+ images/s, extractor [\d.]+ "
                    r"images/s \(8 fakes\); real sweep [\d.]+ images/s "
                    r"\(8 reals\); ppl [\d.]+ pairs/s$", out[0]), out[0]
    jd = _jax_lines(tmp_path, [(n, payload[n], payload["kimg"])
                               for n in names])
    for n in names:
        got = open(os.path.join(run_dir, f"metric-{n}.txt")).read()
        assert got == open(jd / f"metric-{n}.txt").read(), n
    jax_logging.write_flag(str(jd), "calibrated", 1.0)
    assert open(os.path.join(run_dir, "flag-calibrated.txt")).read() == \
        open(jd / "flag-calibrated.txt").read() == "calibrated 1\n"
    assert not os.path.exists(os.path.join(run_dir,
                                           "metric-calibrated.txt"))
    cache = os.listdir(os.path.join(run_dir, "metric-cache"))
    assert len(cache) == 1 and cache[0].startswith("real-stats-")


def test_evaluate_psi_sweep(run_dir, npz, capsys):
    payload = evaluate.main([
        "--run-dir", run_dir, "--metrics", "is", "--num-images", "4",
        "--batch-size", str(BATCH), "--psi-sweep", "0.5,1.0",
        "--inception-npz", npz, "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == payload
    assert [r["psi"] for r in payload["psi_sweep"]] == [0.5, 1.0]
    lines = open(os.path.join(run_dir, "metric-psi-sweep.txt")).read(
        ).splitlines()
    assert len(lines) == 2
    for line, row in zip(lines, payload["psi_sweep"]):
        want = (f"kimg {0.008:<10.1f} psi {row['psi']:<5.2f} "
                f"is4_mean {row['is4_mean']:.6f}  "
                f"is4_std {row['is4_std']:.6f}")
        assert line == want
    assert open(os.path.join(run_dir, "flag-calibrated.txt")).read() == \
        "calibrated 1\n"


@pytest.mark.parametrize("argv,words", [
    (["--attention-backend", "pallas"],
     "--attention-backend: not in the PyTorch port; it has no counterpart"),
    (["--conv-backend=xla"],
     "--conv-backend: not in the PyTorch port; it has no counterpart"),
    (["--psi-sweep", "0.5,1.0", "--truncation-psi", "0.7"],
     "--truncation-psi conflicts with --psi-sweep"),
    (["--psi-sweep", "0.5,x"], "not a comma-separated float list"),
])
def test_evaluate_refusals_come_first(argv, words, capsys, tmp_path):
    """Refused flags and a bad sweep fail with words, before the run dir
    is read (it does not exist here)."""
    with pytest.raises(SystemExit) as e:
        evaluate.main(["--run-dir", str(tmp_path / "missing")] + argv)
    said = e.value.code if isinstance(e.value.code, str) \
        else capsys.readouterr().err
    assert words in said


def test_in_loop_metric_hook(tmp_path, npz, monkeypatch):
    """metric_ticks 1 on a two-tick run: each tick boundary runs the
    group (built once) and writes its lines, the flag and the log line;
    the spans and the counter reach events.jsonl and telemetry.prom."""
    from gansformer_tpu_torch.metrics import metric_base

    monkeypatch.setenv("GANSFORMER_TPU_INCEPTION_NPZ", npz)
    built = []
    real_group = metric_base.MetricGroup

    def counting_group(*a, **k):
        built.append(1)
        return real_group(*a, **k)

    monkeypatch.setattr(metric_base, "MetricGroup", counting_group)
    exp = micro_exp(ticks=2, metrics="fid4,is4", metric_ticks=1)
    d = str(tmp_path)
    loop.train(exp, d, device="cpu")
    assert len(built) == 1
    kimgs = (0.008, 0.016)
    jd = _jax_lines(tmp_path, [])
    for n in ("fid4", "is4_mean", "is4_std"):
        lines = open(os.path.join(d, f"metric-{n}.txt")).read().splitlines()
        assert [ln.split()[1] for ln in lines] == [f"{k:.1f}" for k in kimgs]
        for ln, k in zip(lines, kimgs):
            val = float(ln.split()[-1])
            jax_logging.append_metric_line(str(jd), n, val, k)
        assert open(os.path.join(d, f"metric-{n}.txt")).read() == \
            open(jd / f"metric-{n}.txt").read()
    assert open(os.path.join(d, "flag-calibrated.txt")).read() == \
        "calibrated 1\n"
    log = open(os.path.join(d, "log.txt")).read()
    assert len(re.findall(r"metrics @ 0\.0 kimg: \{'fid4': [\d.]+, "
                          r"'is4_mean': [\d.]+, 'is4_std': [\d.]+\}  "
                          r"\[calibrated=1\]", log)) == 2
    events = [json.loads(ln) for ln in open(os.path.join(d, "events.jsonl"))]
    spans = [e.get("name") for e in events]
    assert spans.count("metric") == 2 and spans.count("metric/fid4") == 2
    prom = open(os.path.join(d, "telemetry.prom")).read()
    assert re.search(r"metric_runs_total\S* 4(\.0)?$", prom, re.M), prom


def test_experiment_two_arms(tmp_path, npz, monkeypatch):
    """Two arms at micro size: each a run dir, with its metrics;
    experiment.json and report.md in JAX's layout."""
    monkeypatch.setenv("GANSFORMER_TPU_INCEPTION_NPZ", npz)
    cfg_path = tmp_path / "micro.json"
    cfg_path.write_text(micro_exp().to_json())
    out = str(tmp_path / "exp")
    summary = experiment.main([
        "--config", str(cfg_path), "--archs", "none,simplex", "--out", out,
        "--metrics", "is4", "--device", "cpu"])
    got = json.load(open(os.path.join(out, "experiment.json")))
    assert got == json.loads(json.dumps(summary))
    assert got["archs"] == ["none", "simplex"]
    assert got["base_preset"] == "micro"
    for arch in ("none", "simplex"):
        arm = got["arms"][arch]
        assert set(arm) == {"run_dir", "g_params", "d_params", "kimg",
                            "loss_g", "loss_d", "img_per_sec", "metrics"}
        assert arm["kimg"] == 0.008
        assert set(arm["metrics"]) == {"is4_mean", "is4_std", "calibrated"}
        cfg = json.load(open(os.path.join(out, arch, "config.json")))
        assert cfg["model"]["attention"] == arch
        assert cfg["name"] == f"micro-{arch}"
    assert got["arms"]["none"]["g_params"] < got["arms"]["simplex"][
        "g_params"]
    report = open(os.path.join(out, "report.md")).read().splitlines()
    assert report[0] == "# Replication-matrix report"
    assert report[4] == \
        "| arch | G params | D params | kimg | Loss/G | Loss/D | img/s |"
    rows = [ln for ln in report if ln.startswith("| none ")
            or ln.startswith("| simplex ")]
    assert len(rows) == 2
    assert sum("↳ is4_mean" in ln for ln in report) == 2
