"""Checkpoints of the port in the JAX package's format, both ways, bit for
bit: a JAX ``ckpt.save`` of a micro ``TrainState`` restores in the port
equal to ``bridge.load_train_state``, and a port ``save`` restores in the
JAX ``ckpt.restore(template)`` equal to the bridged state; the leaf order
is ``jax.tree_util.tree_flatten``'s.  The JAX checkpoint tests that carry
over run on the port: walk-back and quarantine, an explicit step failing
hard, the ``torn`` and ``ckpt_mid_write`` faults, concurrent same-step
saves, async saves and their sticky errors, retention."""

import dataclasses
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gansformer_tpu.train import checkpoint as jck
from gansformer_tpu.train import state as jax_state
from gansformer_tpu_torch import bridge
from gansformer_tpu_torch.core import config as port_config
from gansformer_tpu_torch.obs import registry as telemetry
from gansformer_tpu_torch.supervise import faults
from gansformer_tpu_torch.train import checkpoint as ckpt
from gansformer_tpu_torch.train import create_train_state, d_step, g_step
from gansformer_tpu_torch.utils.background import (BackgroundWriteError,
                                                   LoopWorker,
                                                   SingleSlotWriter)
from tests.test_train import micro_cfg
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

VARIANTS = {
    "simplex": {},
    "duplex": dict(attention="duplex", style_mode="attention"),
    "d_attention": dict(attention="duplex", d_attention=True,
                        d_components=3),
}


def _jax_exp(variant="simplex"):
    cfg = micro_cfg(attention="simplex", batch=4)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, **VARIANTS[variant]))


def _port_state(exp, seed=0):
    pc = port_config.ExperimentConfig.from_json(exp.to_json())
    return create_train_state(pc.model, pc.train, seed, "cpu")


def _trained_port_state(exp, seed=0):
    """A port state after one d_step + g_step: Adam counts 1, moments,
    EMA and w_avg moved."""
    st = _port_state(exp, seed)
    m = st.model
    reals = torch.from_numpy(np.random.RandomState(seed).randint(
        0, 255, (4, m.resolution, m.resolution, 3), dtype=np.uint8))
    d_step(st, reals, 0)
    g_step(st, 0, 4)
    return st


def _flat_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.shape == y.shape and np.array_equal(x, y), k


def _port_flat(st):
    return {k: (v if isinstance(v, int) else v.numpy().copy())
            for k, v in bridge.port_train_state_flat(st).items()}


def jax_template(exp):
    """The JAX ``TrainState``'s structure, shapes and dtypes
    (``jax.eval_shape``: no initialisation run)."""
    return jax.eval_shape(
        lambda: jax_state.create_train_state(exp, jax.random.PRNGKey(0)))


def _path_key(path) -> str:
    """A ``tree_flatten_with_path`` path of the JAX state as the bridge's
    flat key (``g_opt``'s Adam entry is ``(count, mu, nu)``)."""
    parts = []
    for entry in path:
        if isinstance(entry, jax.tree_util.SequenceKey):
            continue
        parts.append(str(getattr(entry, "name", getattr(entry, "key",
                                                         entry))))
    return "/".join(parts)


def jax_state_from_flat(exp, flat):
    """A JAX ``TrainState`` holding ``flat`` (the bridge's flat dict)."""
    leaves, treedef = jax.tree_util.tree_flatten(jax_template(exp))
    keys = [_path_key(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(jax_template(exp))[0]]
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(np.asarray(flat[k], t.dtype)) for k, t in
        zip(keys, leaves)])


def perturbed_flat(exp, seed=9):
    """The flat state of a fresh port state with Adam count 3, moments,
    an EMA apart from G, a non-zero w_avg, pl_mean and step 40."""
    rs = np.random.RandomState(seed)
    flat = _port_flat(_port_state(exp))
    for k, v in flat.items():
        if k in bridge.INT_KEYS:
            flat[k] = 40 if k == "step" else 3
        else:
            r = np.asarray(rs.randn(*np.shape(v)), np.float32)
            if k.startswith(("g_opt/nu/", "d_opt/nu/")):
                flat[k] = np.abs(r) * np.float32(1e-4)
            elif k.startswith(("g_opt/mu/", "d_opt/mu/")):
                flat[k] = r * np.float32(1e-2)
            else:
                flat[k] = v + r * np.float32(0.05)
    return flat


@pytest.fixture
def no_faults():
    faults.disarm()
    yield
    faults.disarm()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_leaf_order_is_tree_flatten(variant):
    """``bridge.jax_leaf_keys`` is the path of each leaf of
    ``tree_flatten`` of the JAX ``TrainState``, with its dtype."""
    exp = _jax_exp(variant)
    with_paths = jax.tree_util.tree_flatten_with_path(jax_template(exp))[0]
    keys = bridge.jax_leaf_keys(_port_state(exp))
    assert keys == [_path_key(p) for p, _ in with_paths]
    for k, (_, leaf) in zip(keys, with_paths):
        assert leaf.dtype == ckpt.leaf_dtype(k), k
    flat = _port_flat(_port_state(exp))
    for k, (_, leaf) in zip(keys, with_paths):
        assert tuple(leaf.shape) == np.shape(flat[k]), k


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_jax_checkpoint_restores_in_the_port(tmp_path, variant):
    """A JAX ``ckpt.save`` (Adam count 3, moments, EMA, w_avg, step 40)
    restores in the port equal to ``bridge.load_train_state``."""
    exp = _jax_exp(variant)
    js = jax_state_from_flat(exp, perturbed_flat(exp))
    jck.save(str(tmp_path), js, exp, block=True)
    got = ckpt.restore(str(tmp_path), _port_state(exp, seed=5))
    want = bridge.load_train_state(
        _port_state(exp, seed=6), bridge.flatten_train_state(
            jax.device_get(js)))
    assert got.step == want.step == 40
    _flat_equal(_port_flat(got), _port_flat(want))
    for opt in (got.g_opt, got.d_opt):
        assert {int(s["step"]) for s in opt.state.values()} == {3}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("block", [True, False])
def test_port_checkpoint_restores_in_jax(tmp_path, variant, block):
    """A port ``save`` (sync or async) restores in JAX's
    ``ckpt.restore(template)`` equal to the port's state bridged, and its
    config.json is JAX's ``to_json``."""
    exp = _jax_exp(variant)
    st = _trained_port_state(exp)
    pc = port_config.ExperimentConfig.from_json(exp.to_json())
    ckpt.save(str(tmp_path), st, pc, block=block)
    ckpt.wait(str(tmp_path))
    assert ckpt.latest_step(str(tmp_path)) == jck.latest_step(
        str(tmp_path)) == 4
    js = jck.restore(str(tmp_path), jax_template(exp))
    _flat_equal(bridge.flatten_train_state(jax.device_get(js)),
                _port_flat(st))
    with open(os.path.join(str(tmp_path), "config.json")) as f:
        assert f.read() == exp.to_json()


def test_round_trip_is_bit_exact(tmp_path):
    exp = _jax_exp()
    st = _trained_port_state(exp)
    ckpt.save(str(tmp_path), st, block=True)
    back = ckpt.restore(str(tmp_path), _port_state(exp, seed=3))
    _flat_equal(_port_flat(back), _port_flat(st))
    with np.load(os.path.join(str(tmp_path), "4", "state.npz")) as z:
        assert int(z["__step"]) == 4
        assert z["leaf_00000"].dtype == np.int32


def test_unequal_adam_steps_raise():
    st = _trained_port_state(_jax_exp())
    p = next(iter(st.generator.parameters()))
    st.g_opt.state[p]["step"] += 1
    with pytest.raises(ValueError, match="Adam steps differ"):
        ckpt.save("/nonexistent-never-written", st)


def test_restore_generator_reads_only_the_generator(tmp_path):
    """The G-only restore: the EMA generator's leaves and ``w_avg`` of a
    saved state, bit for bit, read against a bare generator."""
    from gansformer_tpu_torch.models import Generator

    exp = _jax_exp()
    st = _trained_port_state(exp)
    ckpt.save(str(tmp_path), st, block=True)
    pc = port_config.ExperimentConfig.from_json(exp.to_json())
    got = ckpt.restore_generator(str(tmp_path), Generator(pc.model))
    flat = _port_flat(st)
    assert sorted(got) == sorted(k for k in flat
                                 if k.startswith("ema_params/")
                                 or k == "w_avg")
    for k, v in got.items():
        assert np.array_equal(v, flat[k]), k


# --- walk-back, quarantine, hard failure ---------------------------------------

def _two_steps(d, exp):
    good = _trained_port_state(exp)
    ckpt.save(d, good, block=True)
    later = _trained_port_state(exp, seed=1)
    later.step = 8
    ckpt.save(d, later, block=True)
    return good


def test_restore_walks_back_and_quarantines(tmp_path):
    exp, d = _jax_exp(), str(tmp_path / "ck")
    good = _two_steps(d, exp)
    p = os.path.join(d, "8", "state.npz")
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) // 2)
    before = telemetry.counter("ckpt/restore_fallback_total").value
    back = ckpt.restore(d, _port_state(exp))
    _flat_equal(_port_flat(back), _port_flat(good))
    assert os.path.isdir(os.path.join(d, "8.corrupt"))
    assert ckpt.latest_step(d) == 4
    assert telemetry.counter("ckpt/restore_fallback_total").value == \
        before + 1


def test_restore_explicit_step_still_hard_fails(tmp_path):
    exp, d = _jax_exp(), str(tmp_path / "ck")
    _two_steps(d, exp)
    with open(os.path.join(d, "8", "state.npz"), "r+b") as f:
        f.truncate(10)
    with pytest.raises(Exception):
        ckpt.restore(d, _port_state(exp), step=8)
    assert os.path.isdir(os.path.join(d, "8"))


def test_restore_all_corrupt_raises_with_words(tmp_path):
    exp, d = _jax_exp(), str(tmp_path / "ck")
    ckpt.save(d, _port_state(exp), block=True)
    with open(os.path.join(d, "0", "state.npz"), "r+b") as f:
        f.truncate(5)
    with pytest.raises(ValueError, match="decodes cleanly"):
        ckpt.restore(d, _port_state(exp))


def test_mismatched_model_walks_back_too(tmp_path):
    """A latest step whose leaves are another model's walks back like a
    torn one."""
    exp, d = _jax_exp(), str(tmp_path / "ck")
    good = _trained_port_state(exp)
    ckpt.save(d, good, block=True)
    other = _port_state(_jax_exp("duplex"))
    other.step = 8
    ckpt.save(d, other, block=True)
    back = ckpt.restore(d, _port_state(exp))
    _flat_equal(_port_flat(back), _port_flat(good))
    assert os.path.isdir(os.path.join(d, "8.corrupt"))


def test_torn_fault_walks_back(tmp_path, no_faults):
    exp, d = _jax_exp(), str(tmp_path / "ck")
    good = _trained_port_state(exp)
    ckpt.save(d, good, block=True)
    faults.arm(faults.parse_specs("torn@ckpt_after_write:step=8"))
    later = _trained_port_state(exp, seed=1)
    later.step = 8
    ckpt.save(d, later, block=True)
    back = ckpt.restore(d, _port_state(exp))
    _flat_equal(_port_flat(back), _port_flat(good))
    assert os.path.isdir(os.path.join(d, "8.corrupt"))


def test_mid_write_failure_never_replaces_last_good(tmp_path, no_faults):
    exp, d = _jax_exp(), str(tmp_path / "ck")
    good = _trained_port_state(exp)
    ckpt.save(d, good, block=True)
    faults.arm(faults.parse_specs("raise@ckpt_mid_write:step=4"))
    again = _trained_port_state(exp, seed=1)
    with pytest.raises(faults.FaultInjected):
        ckpt.save(d, again, block=True)
    assert sorted(os.listdir(d)) == ["4"]
    back = ckpt.restore(d, _port_state(exp))
    _flat_equal(_port_flat(back), _port_flat(good))


def test_concurrent_same_step_saves_use_distinct_tmp_dirs(tmp_path):
    exp, d = _jax_exp(), str(tmp_path / "ck")
    st = _trained_port_state(exp)
    gate = threading.Event()
    seen = []

    def hook(step):
        seen.append(sorted(p for p in os.listdir(d) if p.startswith(".tmp")))
        if len(seen) == 1:
            t = threading.Thread(target=lambda: ckpt.save(d, st, block=True))
            t.start()
            t.join()
            gate.set()

    try:
        ckpt._WRITE_HOOK = hook
        ckpt.save(d, st, block=False)
        ckpt.wait(d)
    finally:
        ckpt._WRITE_HOOK = None
    assert gate.is_set()
    assert len(seen[1]) == 2 and len(set(seen[1])) == 2, seen
    back = ckpt.restore(d, _port_state(exp))
    _flat_equal(_port_flat(back), _port_flat(st))


def test_async_error_is_sticky_until_checked_and_reset(tmp_path):
    exp, d = _jax_exp(), str(tmp_path / "ck")
    st = _trained_port_state(exp)

    def boom(step):
        raise OSError("disk full")

    try:
        ckpt._WRITE_HOOK = boom
        ckpt.save(d, st, block=False)
        ckpt.wait(d, reraise=False)
    finally:
        ckpt._WRITE_HOOK = None
    with pytest.raises(BackgroundWriteError, match="disk full"):
        ckpt.check_error(d)
    ckpt.check_error(d)                       # delivered once
    try:
        ckpt._WRITE_HOOK = boom
        ckpt.save(d, st, block=False)
        ckpt.wait(d, reraise=False)
    finally:
        ckpt._WRITE_HOOK = None
    ckpt.reset_errors(d)                      # a new run starts clean
    ckpt.check_error(d)
    assert ckpt.latest_step(d) is None


def test_async_save_copies_before_the_state_moves(tmp_path):
    """The async save holds the state as it was at the call, though the
    next step changes the parameters while the writer runs."""
    exp, d = _jax_exp(), str(tmp_path / "ck")
    st = _trained_port_state(exp)
    want = _port_flat(st)
    gate = threading.Event()
    ckpt._WRITE_HOOK = lambda step: gate.wait(10.0)
    try:
        ckpt.save(d, st, block=False)
        with torch.no_grad():
            for p in st.generator.parameters():
                p.add_(1.0)
        gate.set()
        ckpt.wait(d)
    finally:
        ckpt._WRITE_HOOK = None
    _flat_equal(_port_flat(ckpt.restore(d, _port_state(exp))), want)


def test_retention_keeps_newest_and_config_written_once(tmp_path):
    exp, d = _jax_exp(), str(tmp_path / "ck")
    st = _port_state(exp)
    pc = port_config.ExperimentConfig.from_json(exp.to_json())
    for step in range(0, 7):
        st.step = step
        ckpt.save(d, st, pc, max_to_keep=3, block=True)
    assert ckpt._all_steps(d) == [4, 5, 6]
    other = dataclasses.replace(pc, name="other")
    ckpt.save(d, st, other, block=True)
    with open(os.path.join(d, "config.json")) as f:
        assert f.read() == pc.to_json()


# --- the background writers ---------------------------------------------------

def test_single_slot_writer_bounded_and_sticky():
    w = SingleSlotWriter("test/port")
    order, gate = [], threading.Event()
    w.submit(lambda: (gate.wait(5.0), order.append("first")))
    assert w.busy and w.wait(timeout=0.1) is False
    gate.set()
    w.submit(lambda: order.append("second"))
    w.wait()
    assert order == ["first", "second"]

    def fail():
        raise OSError("late failure")

    w.submit(fail)
    assert w.close(timeout=5.0) is True
    with pytest.raises(BackgroundWriteError, match="late failure"):
        w.poll()
    w.poll()


def test_loop_worker_error_is_sticky_forever():
    def body():
        time.sleep(0.05)
        raise RuntimeError("dispatcher died")

    lw = LoopWorker(body, "test/port_loop").start()
    assert lw.wait(reraise=False, timeout=5.0) is True
    for _ in range(2):
        with pytest.raises(BackgroundWriteError, match="dispatcher died"):
            lw.poll()
    assert isinstance(lw.error, RuntimeError)
