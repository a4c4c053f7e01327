"""The port's tick loop and train CLI on the CPU, on the JAX package's
micro configuration (``tests/test_train.py`` ``micro_cfg``): the run
dir's artifacts and their JAX readers, the stats' keys and phases, the
step kinds by iteration, the reals as JAX's ``seed + 1`` stream at the
resumed batch, kill -> ``--resume`` tick for tick equal to the
uninterrupted run, resuming from a JAX checkpoint, the CLI's typed
exits, no host sync of the loop's own inside a tick on the card's route,
and the smoke's launch plan of a loop run."""

import dataclasses
import glob
import json
import math
import os

import numpy as np
import pytest
import torch

import chip_smoke
from gansformer_tpu.core.config import ExperimentConfig as JaxExperiment
from gansformer_tpu.data.dataset import SyntheticDataset as JaxSynthetic
from gansformer_tpu.obs.heartbeat import read_heartbeats
from gansformer_tpu.obs.registry import parse_prom_values
from gansformer_tpu.supervise.events import read_events
from gansformer_tpu.utils.logging import read_resume_records
from gansformer_tpu_torch import obs, ops
from gansformer_tpu_torch.cli import train as train_cli
from gansformer_tpu_torch.core import config as port_config
from gansformer_tpu_torch.data.errors import DataCorrupt, DataStalled
from gansformer_tpu_torch.supervise import events, faults
from gansformer_tpu_torch.train import checkpoint as ckpt
from gansformer_tpu_torch.train import create_train_state, loop
from tests.test_torch_grads import patch_card_route
from tests.test_train import micro_cfg
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

BATCH = 8
ITERS = 6                     # three ticks of two iterations


def micro_exp(total_iters=ITERS, tick_iters=2, **train):
    """The JAX micro configuration as the port reads it, with ticks of
    ``tick_iters`` iterations and a snapshot and a checkpoint every
    tick."""
    cfg = micro_cfg(attention="simplex", batch=BATCH)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, total_kimg=total_iters * BATCH / 1000,
        kimg_per_tick=tick_iters * BATCH / 1000, snapshot_ticks=1,
        image_snapshot_ticks=1, **train))
    return port_config.ExperimentConfig.from_json(cfg.to_json())


def _ticks(run_dir):
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def _npz(run_dir, step):
    with np.load(os.path.join(run_dir, "checkpoints", str(step),
                              "state.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The micro run uninterrupted (A), and the same run preempted by a
    ``sigterm@tick:tick=0`` fault and resumed with ``resume=True`` (B)."""
    root = tmp_path_factory.mktemp("loop")
    exp = micro_exp()
    a, b = str(root / "a"), str(root / "b")
    state_a = loop.train(exp, a, device="cpu")
    faults.arm(faults.parse_specs("sigterm@tick:tick=0"),
               str(root / "faults.jsonl"))
    try:
        with pytest.raises(events.PreemptionExit) as e:
            loop.train(exp, b, device="cpu")
    finally:
        faults.disarm()
    state_b = loop.train(exp, b, device="cpu", resume=True)
    return dict(a=a, b=b, state_a=state_a, state_b=state_b,
                preempted_at=e.value.step, exp=exp)


def test_loop_artifacts(runs):
    d = runs["a"]
    for name in ("config.json", "log.txt", "stats.jsonl", "events.jsonl",
                 "telemetry.prom", "heartbeat-p0.json"):
        assert os.path.exists(os.path.join(d, name)), name
    assert glob.glob(os.path.join(d, "fakes*.png"))
    assert glob.glob(os.path.join(d, "tensorboard", "events.out.tfevents.*"))
    ticks = _ticks(d)
    assert len(ticks) == 3
    last = ticks[-1]
    assert last["Progress/kimg"] == ITERS * BATCH / 1000
    assert np.isfinite(last["Loss/G"]) and np.isfinite(last["Loss/D"])
    assert last["timing/img_per_sec_per_chip"] > 0
    assert ckpt._all_steps(os.path.join(d, "checkpoints")) == [16, 32, 48]
    assert runs["state_a"].step == 48


# The per-tick stats of the JAX loop (gansformer_tpu/train/loop.py, tick
# boundary) on this configuration, less what the port does not have: the
# gate stats (no attention-styling gates in the micro simplex generator)
# and timing/mfu (TPU only).
JAX_TICK_KEYS = {
    "time", "telemetry", "Progress/tick", "Progress/kimg",
    "timing/sec_per_tick", "timing/img_per_sec",
    "timing/img_per_sec_per_chip", "timing/data_wait_s",
    "timing/data_wait_frac", "Loss/D", "Loss/D/r1", "Loss/G", "Loss/G/pl",
    "Loss/scores/real", "Loss/scores/fake"}
JAX_PHASES = {"data_wait", "h2d", "step", "tick_fetch", "snapshot",
              "checkpoint", "ckpt/save"}


def test_stats_keys_are_jax_keys_and_phases_sum_to_the_tick(runs):
    for i, rec in enumerate(_ticks(runs["a"])):
        phases = {k[len("timing/phase/"):]: v for k, v in rec.items()
                  if k.startswith("timing/phase/")}
        assert set(rec) - {f"timing/phase/{p}" for p in phases} == \
            JAX_TICK_KEYS
        assert set(phases) <= JAX_PHASES
        assert {"data_wait", "h2d", "step", "tick_fetch"} <= set(phases)
        if i:                    # the previous boundary's writes
            assert {"snapshot", "checkpoint"} <= set(phases)
        ratio = sum(phases.values()) / rec["timing/sec_per_tick"]
        assert 0.8 <= ratio <= 1.2, (ratio, phases)
        # stats.jsonl rounds each value to 6 decimals
        assert rec["timing/data_wait_frac"] == pytest.approx(
            rec["timing/data_wait_s"] / rec["timing/sec_per_tick"],
            rel=1e-3, abs=1e-5)
        tel = rec["telemetry"]
        for c in ("data/read_retries_total", "data/corrupt_records_total",
                  "data/stalls_total", "train/nonfinite_total"):
            assert tel["counters"][c] == 0.0


def test_kill_resume_is_tick_for_tick_identical(runs):
    """Preempted after tick 0 and resumed: every later tick's losses and
    the final checkpoint bit-equal to the uninterrupted run's."""
    a, b = runs["a"], runs["b"]
    assert runs["preempted_at"] == 16
    assert "preemption checkpoint @ step 16" in open(
        os.path.join(b, "log.txt")).read()
    ta, tb = _ticks(a), _ticks(b)
    assert len(tb) == len(ta)
    losses = [{k: v for k, v in t.items() if k.startswith("Loss/")}
              for t in ta]
    assert [{k: v for k, v in t.items() if k.startswith("Loss/")}
            for t in tb] == losses
    assert [t["Progress/kimg"] for t in tb] == \
        [t["Progress/kimg"] for t in ta]
    za, zb = _npz(a, 48), _npz(b, 48)
    assert sorted(za) == sorted(zb)
    for k in za:
        assert za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k]), k
    log = open(os.path.join(b, "log.txt")).read()
    assert "resumed from step 16" in log and "from batch 2" in log


def test_jax_readers_read_the_port_run_dir(runs):
    from PIL import Image

    d = runs["b"]
    assert [r["step"] for r in read_resume_records(d)] == [16]
    evs = read_events(d)
    assert [e["kind"] for e in evs] == ["resume"] and evs[0]["step"] == 16
    beats = read_heartbeats(d)
    assert beats[0]["step"] == 48 and beats[0]["phase"] == "finalize"
    vals = parse_prom_values(os.path.join(d, "telemetry.prom"))
    assert vals["ckpt_save_total"] >= 1.0
    assert vals["hbm_unavailable"] == 1.0
    cfg = JaxExperiment.from_json(open(os.path.join(d, "config.json")).read())
    assert cfg.to_json() == runs["exp"].to_json()
    for path in glob.glob(os.path.join(d, "fakes*.png")):
        img = np.asarray(Image.open(path))
        assert img.shape == (4 * 16, 4 * 16, 3)
    with open(os.path.join(d, "events.jsonl")) as f:
        names = {json.loads(ln)["name"] for ln in f}
    assert {"step", "data_wait", "checkpoint", "ckpt/restore"} <= names


def _stub_steps(monkeypatch, record):
    zero = torch.zeros(())

    def d_fn(kind):
        def step(state, reals, it, mirror_augment=False, label=None):
            record.append((it, kind, reals.clone()))
            return {"Loss/D": zero, "Loss/scores/real": zero,
                    "Loss/scores/fake": zero}
        return step

    def g_fn(kind):
        def step(state, it, n, label=None):
            record.append((it, kind, None))
            state.step += n
            return {"Loss/G": zero}
        return step

    monkeypatch.setattr(loop, "d_step", d_fn("d_step"))
    monkeypatch.setattr(loop, "d_step_r1", d_fn("d_step_r1"))
    monkeypatch.setattr(loop, "g_step", g_fn("g_step"))
    monkeypatch.setattr(loop, "g_step_pl", g_fn("g_step_pl"))


@pytest.mark.parametrize("d_reg,g_reg", [(4, 2), (3, 5)])
def test_step_kinds_follow_the_intervals(tmp_path, monkeypatch, d_reg,
                                         g_reg):
    record = []
    _stub_steps(monkeypatch, record)
    exp = micro_exp(total_iters=10, tick_iters=10, d_reg_interval=d_reg,
                    g_reg_interval=g_reg)
    loop.train(exp, str(tmp_path), device="cpu")
    kinds = [(it, kind) for it, kind, _ in record]
    want = []
    for it in range(10):
        want += [(it, "d_step_r1" if it % d_reg == 0 else "d_step"),
                 (it, "g_step_pl" if it % g_reg == 0 else "g_step")]
    assert kinds == want
    assert chip_smoke.loop_step_kinds(exp.train, 0, 10) == {
        k: sum(kd == k for _, kd in want)
        for k in ("d_step", "d_step_r1", "g_step", "g_step_pl")}


@pytest.mark.parametrize("resume_step", [0, 24])
def test_loop_reals_are_jax_seed_plus_one_stream(tmp_path, monkeypatch,
                                                 resume_step):
    """The reals of iteration ``it`` are batch ``it`` of JAX's stream of
    seed ``train.seed + 1`` (ROADMAP C.17), from a fresh start and from a
    checkpoint at step ``resume_step``."""
    exp = micro_exp(total_iters=6, tick_iters=6, seed=5)
    run = str(tmp_path)
    if resume_step:
        st = create_train_state(exp.model, exp.train, 5, "cpu")
        st.step = resume_step
        ckpt.save(os.path.join(run, "checkpoints"), st, block=True)
    record = []
    _stub_steps(monkeypatch, record)
    loop.train(exp, run, device="cpu", resume=bool(resume_step))
    first = resume_step // BATCH
    reals = [r for _, kind, r in record if kind.startswith("d_step")]
    assert [it for it, kind, _ in record if kind.startswith("d_step")] == \
        list(range(first, 6))
    want = JaxSynthetic(16).batches(BATCH, seed=6, start_batch=first)
    for got in reals:
        np.testing.assert_array_equal(got.numpy(), next(want)["image"])


def test_steps_cap_ends_with_a_tick_and_a_checkpoint(tmp_path):
    exp = micro_exp(total_iters=100, tick_iters=50)
    st = loop.train(exp, str(tmp_path), device="cpu", steps=3)
    assert st.step == 24
    ticks = _ticks(str(tmp_path))
    assert [t["Progress/kimg"] for t in ticks] == [0.024]
    assert ckpt.latest_step(os.path.join(str(tmp_path), "checkpoints")) == 24


def test_resumes_from_a_jax_checkpoint(tmp_path):
    """A JAX run's checkpoints/ (``ckpt.save`` of a JAX state at step 16)
    resumes in the port at that step and continues to the end."""
    from gansformer_tpu.train import checkpoint as jck
    from tests.test_torch_checkpoint import (jax_state_from_flat,
                                             perturbed_flat)

    exp = micro_exp(total_iters=4, tick_iters=4)
    jexp = JaxExperiment.from_json(exp.to_json())
    flat = dict(perturbed_flat(jexp), step=16)
    jck.save(os.path.join(str(tmp_path), "checkpoints"),
             jax_state_from_flat(jexp, flat), jexp, block=True)
    st = loop.train(exp, str(tmp_path), device="cpu", resume=True)
    assert st.step == 32
    assert "resumed from step 16" in open(
        os.path.join(str(tmp_path), "log.txt")).read()
    assert {int(s["step"]) for s in st.g_opt.state.values()} == {5}


def test_ignored_keys_are_said_in_the_log(tmp_path):
    """No key of the JAX config is left that the port does not act on
    (the list of such keys went with the device-time sampler): the metric
    keys run the in-loop hook, the sampler and ``profile_dir`` are acted
    on (``tests/test_torch_device_time.py``), so log.txt says nothing of
    any of them as ignored."""
    prof = os.path.join(str(tmp_path), "prof")
    exp = micro_exp(total_iters=1, tick_iters=1, profile_dir=prof,
                    metrics="fid", device_time_ticks=3)
    loop.train(exp, str(tmp_path / "run"), device="cpu")
    log = open(os.path.join(str(tmp_path / "run"), "log.txt")).read()
    assert "is not in the port yet" not in log


def test_debug_nans_turns_on_anomaly_detection_for_the_run(tmp_path,
                                                           monkeypatch):
    seen = []
    orig = loop.d_step

    def spy(*a, **k):
        seen.append(torch.is_anomaly_enabled())
        return orig(*a, **k)

    monkeypatch.setattr(loop, "d_step", spy)
    exp = micro_exp(total_iters=2, tick_iters=2, debug_nans=True)
    loop.train(exp, str(tmp_path), device="cpu")
    assert seen == [True] and not torch.is_anomaly_enabled()
    from gansformer_tpu_torch.utils.debug import check_finite_stats

    with pytest.raises(FloatingPointError, match="Loss/G"):
        check_finite_stats({"Loss/D": 1.0, "Loss/G": float("nan")})


@pytest.mark.parametrize("exc,code", [
    (DataCorrupt("budget"), events.EXIT_DATA_CORRUPT),
    (DataStalled("wedged"), events.EXIT_DATA_STALLED),
    (events.PreemptionExit(8), events.EXIT_PREEMPTED)])
def test_cli_maps_typed_exits(tmp_path, monkeypatch, exc, code):
    def raising_train(*a, **k):
        raise exc

    monkeypatch.setattr(loop, "train", raising_train)
    with pytest.raises(SystemExit) as e:
        train_cli.main(["--preset", "clevr64-simplex", "--device", "cpu",
                        "--run-dir", str(tmp_path / f"r{code}")])
    assert e.value.code == code
    assert (code, events.EXIT_PREEMPTED, events.EXIT_DATA_CORRUPT,
            events.EXIT_DATA_STALLED) == (code, 75, 65, 74)


@pytest.mark.parametrize("flag", ["--device-time-ticks", "--mesh-data=2",
                                  "--profile-dir", "--selfcheck"])
def test_cli_refuses_later_flags_with_words(flag):
    """A flag of a later part of the port is refused with its part named;
    the device-time sampler's flags came with A.6 and are taken now, with
    JAX's types (``tests/test_torch_device_time.py`` holds their values
    to JAX's CLI)."""
    if flag in ("--device-time-ticks", "--profile-dir"):
        train_cli.refuse_later_flags([flag, "3"])
        args = train_cli.build_parser().parse_args([flag, "3"])
        assert getattr(args, flag[2:].replace("-", "_")) == (
            3 if flag == "--device-time-ticks" else "3")
        with pytest.raises(SystemExit):    # argparse's refusal of a word
            train_cli.build_parser().parse_args(["--device-time-ticks", "x"])
        return
    with pytest.raises(SystemExit, match="not in the PyTorch port yet"):
        train_cli.main([flag, "x"] if "=" not in flag else [flag])


def test_cli_resume_continues_the_runs_config(tmp_path):
    """``--run-dir R --resume`` reads R's config.json and checkpoint;
    without a checkpoint it starts fresh in place."""
    exp = micro_exp(total_iters=2, tick_iters=2)
    path = tmp_path / "cfg.json"
    path.write_text(exp.to_json())
    run = str(tmp_path / "run")
    assert train_cli.main(["--config", str(path), "--run-dir", run,
                           "--resume", "--device", "cpu"]) == 0
    assert not os.path.exists(os.path.join(run, "resumes.jsonl"))
    more = json.loads(path.read_text())
    more["train"]["total_kimg"] = 4 * BATCH / 1000
    (tmp_path / "run" / "config.json").write_text(json.dumps(more))
    assert train_cli.main(["--run-dir", run, "--resume", "--device",
                           "cpu"]) == 0
    assert [r["step"] for r in read_resume_records(run)] == [16]
    assert ckpt.latest_step(os.path.join(run, "checkpoints")) == 32


def test_no_host_sync_of_the_loop_inside_a_tick(tmp_path, monkeypatch):
    """On the card's route (stubbed kernels), no code of the port (the
    loop, the steps, the ops) fetches a tensor to the host (``item``,
    ``float``, ``tolist``, ``cpu``, ``numpy``) or calls
    ``torch.cuda.synchronize`` inside the ``data_wait`` / ``h2d`` /
    ``step`` spans: the tick boundary is the loop's only sync.  (torch's
    own Adam reads its CPU step counters, which are no device sync.)"""
    import sys

    patch_card_route(monkeypatch)
    tracer = obs.get_tracer()
    pkg = os.sep + "gansformer_tpu_torch" + os.sep
    calls = []

    def watch(name, fn):
        def wrapped(*a, **k):
            caller = sys._getframe(1).f_code.co_filename
            if pkg in caller:
                calls.append((name, os.path.basename(caller),
                              [f[0] for f in tracer._stack()]))
            return fn(*a, **k)
        return wrapped

    for name in ("item", "__float__", "tolist", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name,
                            watch(name, getattr(torch.Tensor, name)))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        watch("synchronize", torch.cuda.synchronize))
    exp = micro_exp(total_iters=4, tick_iters=2)
    loop.train(exp, str(tmp_path), device="cpu")
    inside = [c for c in calls if {"data_wait", "h2d", "step"} & set(c[2])]
    assert not inside, inside[:5]
    assert any("tick_fetch" in c[2] and c[1] == "loop.py" for c in calls)


def test_loop_launches_match_the_smokes_plan(tmp_path, monkeypatch):
    """A loop run on the card's route (stubbed kernels, the micro duplex
    generator) launches what ``chip_smoke.loop_plan`` gives for its
    iterations and snapshots: the plan the smoke holds run C to."""
    patch_card_route(monkeypatch)
    model = port_config.ModelConfig(
        resolution=16, components=2, latent_dim=16, w_dim=16,
        mapping_dim=16, mapping_layers=2, fmap_base=64, fmap_max=32,
        attention="duplex", attn_start_res=8, attn_max_res=8,
        mbstd_group_size=4, style_mode="attention")
    train = port_config.TrainConfig(
        batch_size=4, total_kimg=0.02, kimg_per_tick=0.012,
        d_reg_interval=4, g_reg_interval=2, snapshot_ticks=1,
        image_snapshot_ticks=1, ema_kimg=0.01, style_mixing_prob=0.5)
    exp = port_config.ExperimentConfig(
        name="m", model=model, train=train,
        data=port_config.DataConfig(resolution=16))
    ops.reset_launch_counts()
    loop.train(exp, str(tmp_path), device="cpu")
    kinds = chip_smoke.loop_step_kinds(train, 0, 5)
    # two ticks: a snapshot at the start, after each tick, and the final
    want = chip_smoke.loop_plan(model, train, kinds, 4, 8)
    got = (ops.launch_counts(), ops.lse_launch_counts(),
           ops.second_order_counts())
    assert got == want[:3]
    assert all(math.isfinite(v) for t in _ticks(str(tmp_path))
               for k, v in t.items() if k.startswith("Loss/"))


def test_fused_cycle_and_device_prefetch_are_taken(tmp_path):
    """A config with ``train.fused_cycle`` (JAX's, at d_reg_interval 4 and
    g_reg_interval 2) and ``data.device_prefetch`` (JAX's default) is
    taken, not ignored: log.txt says that no iteration makes a host round
    trip, and the run takes the loop's own steps."""
    exp = micro_exp(total_iters=8, tick_iters=4, d_reg_interval=4,
                    g_reg_interval=2, fused_cycle=True)
    assert exp.data.device_prefetch
    st = loop.train(exp, str(tmp_path), device="cpu")
    assert "is not in the port yet" not in open(
        os.path.join(str(tmp_path), "log.txt")).read()
    assert st.step == 64
    ticks = _ticks(str(tmp_path))
    assert [t["Progress/kimg"] for t in ticks] == [0.032, 0.064]
    assert all(math.isfinite(t["Loss/D/r1"]) and math.isfinite(
        t["Loss/G/pl"]) for t in ticks)
    log = open(os.path.join(str(tmp_path), "log.txt")).read()
    assert "fused cycle: 4 iterations make no host round trip" in log
    assert "device prefetch: each batch is copied from pinned memory" in log
    assert "is not in the port yet" not in log
