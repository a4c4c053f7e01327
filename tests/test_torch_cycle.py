"""One lazy-regularization cycle of the port's steps on the CPU, as its
tick loop runs them (iteration ``it`` runs ``d_step_r1`` where ``it %
d_reg_interval == 0``, else ``d_step``, then ``g_step_pl`` where ``it %
g_reg_interval == 0``, else ``g_step``), against the JAX package's fused
``make_train_steps(...).cycle`` over the same iterations.  The port has no
fused cycle of its own: no iteration of it makes a host round trip, which
is what JAX's cycle is for.

The micro configuration (``tests/test_train.py``) at
``d_reg_interval`` 4 and ``g_reg_interval`` 2 (a cycle of 4 iterations:
d_step_r1 + g_step_pl, d_step + g_step, d_step + g_step_pl, d_step +
g_step), batch 4, noise and style mixing off, mirror off, from a
perturbed JAX ``TrainState`` carried over by the bridge.  Every draw of
the port's steps is injected from JAX's keys (``fold_in(rng, it0 + i)``,
then 0 / 1 for D / G, 0 / 5 for their latents and 3 for path length's,
as ``gansformer_tpu/train/steps.py`` derives them).  Held: the aux sums
(``MODEL``, 1e-4 of each value's scale) and their counts (JAX's
``cycle_counts``), and every leaf of the state after the cycle at the
classes the one-step tests use (``tests/test_torch_train.py``): the
parameters at 1e-5 of their scale, or ``MODEL`` where a leaf was zero
before (its value is its updates alone), each EMA leaf at its
parameter's class (the EMA mixes the parameter in), Adam's first
moment (the last step's gradient: beta1 is 0) at ``MODEL``, its second
moment at 1e-4, ``w_avg`` at 1e-5 and ``pl_mean`` at ``MODEL``.

With the generator's attention on (duplex), path length's second order
runs through a saturated softmax that fp32 cannot resolve (ROADMAP
hazard 16): there the reference is JAX's cycle in float64 (x64, the
attention's fp32 cast lifted, as ``tests/test_torch_pl.py`` builds its
step).  The port's float64 cycle meets it at the classes above on every
leaf; its fp32 steps at those classes or no further than JAX's own fp32
cycle lies from it (the hazard-16 clause; ``pytest -s`` prints the
leaves that need it).  Without attention the reference is JAX's fp32
cycle and no clause applies.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gansformer_tpu.train import steps as jax_steps
from gansformer_tpu_torch import bridge
from gansformer_tpu_torch.core import config as port_config
from gansformer_tpu_torch.train import create_train_state, d_step, g_step
from tests.test_torch_pl import _attention_float64
from tests.test_torch_train import (BATCH, MODEL, STEP_MODELS,
                                    _NoNoiseGenerator, _jax_cfg,
                                    _key_bias, _perturbed_state, _t)

D_REG, G_REG = 4, 2
K = D_REG
PL_MEAN0 = 0.75


def _cfg(model):
    cfg = _jax_cfg(model)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, d_reg_interval=D_REG, g_reg_interval=G_REG))


def _port_train():
    return port_config.TrainConfig(
        batch_size=BATCH, style_mixing_prob=0.0, ema_kimg=0.01,
        d_reg_interval=D_REG, g_reg_interval=G_REG)


def _jax_draws(cfg, rng, it0):
    """Each iteration's draws from the JAX cycle's keys: the latents of
    its D and G steps, and path length's where it runs."""
    m = cfg.model
    shape = (BATCH, m.num_ws, m.latent_dim)
    pl_batch = BATCH // cfg.train.pl_batch_shrink
    out = []
    for i in range(K):
        r = jax.random.fold_in(rng, it0 + i)
        rd, rg = jax.random.fold_in(r, 0), jax.random.fold_in(r, 1)
        d = {"d": {"z": _t(jax.random.normal(jax.random.fold_in(rd, 0),
                                             shape))},
             "g": {"z": _t(jax.random.normal(jax.random.fold_in(rg, 5),
                                             shape))}}
        if (it0 + i) % G_REG == 0:
            k_pl, k_noise = jax.random.split(jax.random.fold_in(rg, 3))
            d["pl"] = {
                "z_pl": _t(jax.random.normal(k_pl, (pl_batch,) + shape[1:])),
                "pl_noise": _t(jax.random.normal(
                    k_noise, (pl_batch, m.resolution, m.resolution, 3)))}
        out.append(d)
    return out


def _jax_cycle(cfg, st0, imgs, rng, it0, x64=False):
    """JAX's fused cycle from ``st0``: (flat state after it, aux sums,
    cycle_counts); in float64 where ``x64``."""
    from gansformer_tpu.models import attention as jax_attention

    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(x64):
        mp.setattr(jax_steps, "Generator", _NoNoiseGenerator)
        st = jax.device_get(st0)
        if x64:
            mp.setattr(jax_attention, "multihead_attention",
                       _attention_float64)
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, dtype="float64"))
            st = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64)
                if jnp.asarray(a).dtype == jnp.float32 else jnp.asarray(a),
                st)
        fns = jax_steps.make_train_steps(cfg, None, batch_size=BATCH)
        st1, sums = fns.cycle(st, jnp.asarray(imgs), rng, it0)
        flat = {k: np.asarray(v, np.float64) for k, v in
                bridge.flatten_train_state(jax.device_get(st1)).items()}
        return flat, {k: float(v) for k, v in sums.items()}, \
            dict(fns.cycle_counts)


def _port_flat(st):
    return {k: np.asarray(v if isinstance(v, int) else v.double().numpy(),
                          np.float64)
            for k, v in bridge.port_train_state_flat(st).items()}


def _port_cycle(model, flat0, imgs, draws, it0):
    """The port's steps over iterations ``it0 .. it0 + K - 1`` at the tick
    loop's cadence, with the draws injected: (flat state after them, aux
    sums, their counts)."""
    port = create_train_state(port_config.ModelConfig(**model),
                              _port_train(), seed=0, device="cpu")
    bridge.load_train_state(port, flat0)
    sums, counts = {}, {}
    for i in range(K):
        it = it0 + i
        d_aux = d_step(port, torch.from_numpy(imgs[i]), it,
                       z=draws[i]["d"]["z"], noise_mode="none",
                       do_r1=it % D_REG == 0)
        g_aux = g_step(port, it, BATCH, z=draws[i]["g"]["z"],
                       noise_mode="none", do_pl=it % G_REG == 0,
                       **draws[i].get("pl", {}))
        for k, v in {**d_aux, **g_aux}.items():
            sums[k] = v if k not in sums else sums[k] + v
            counts[k] = counts.get(k, 0) + 1
    return (_port_flat(port), {k: float(v) for k, v in sums.items()},
            counts)


def _leaf_tol(key, before):
    """The one-step tests' class of a state leaf after the cycle."""
    if key.startswith(("g_opt/mu/", "d_opt/mu/")) or key == "pl_mean":
        return MODEL
    if key.startswith(("g_opt/nu/", "d_opt/nu/")):
        return 1e-4
    if key.startswith("ema_params/"):
        # the EMA mixes the generator's parameter into itself every
        # iteration, so it takes that parameter's class
        key = "g_params/" + key[len("ema_params/"):]
    if key.startswith(("g_params/", "d_params/")):
        return MODEL if not np.any(before[key]) else 1e-5
    return 1e-5


def _scale(key, ref):
    """A leaf's scale; a key bias takes its weight's (softmax ignores a
    bias added to every key, so its own value is rounding noise)."""
    name = key.split("/", 2)[-1] if "_opt/" in key else key
    if _key_bias(name):
        return float(np.abs(ref[key[:-1] + "w"]).max())
    return float(np.abs(ref[key]).max())


def _hold(got, ref, before, ref32=None):
    """Every leaf of ``got`` against ``ref`` at its class of its scale,
    or (given ``ref32``, JAX's fp32 cycle beside its float64 ``ref``) no
    further than ``ref32`` lies.  Returns the leaves that took the
    clause: (key, error, allowance) relative to the scale."""
    assert set(got) == set(ref)
    by_clause, bad = [], []
    for key in sorted(ref):
        if key.endswith("/count") or key == "step":
            assert got[key] == ref[key], key
            continue
        scale = _scale(key, ref)
        err = float(np.abs(got[key] - ref[key]).max())
        allow = _leaf_tol(key, before) * scale + 1e-12
        own = (float(np.abs(ref32[key] - ref[key]).max())
               if ref32 is not None else 0.0)
        if err > max(allow, own):
            bad.append((key, err / max(scale, 1e-30),
                        allow / max(scale, 1e-30)))
        elif err > allow:
            by_clause.append((key, err / scale, own / scale))
    assert not bad, bad[:10]
    return by_clause


def _hold_sums(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=MODEL,
                                   atol=MODEL * abs(v) + 1e-12, err_msg=k)


def cycle_setup(request):
    """One model's cycle on both sides (the fixture ``cycle_vs_jax`` of
    this file and of ``test_torch_cycle_duplex.py`` and
    ``test_torch_cycle_fusedkv.py``, one model each)."""
    model = STEP_MODELS[request.param]
    cfg = _cfg(model)
    st0 = _perturbed_state(cfg)
    st0 = st0.replace(pl_mean=jnp.asarray(PL_MEAN0, st0.pl_mean.dtype))
    flat0 = bridge.flatten_train_state(jax.device_get(st0))
    before = {k: np.asarray(v) for k, v in flat0.items()}
    imgs = np.random.RandomState(1).randint(
        0, 255, (K, BATCH, 16, 16, 3), dtype=np.uint8)
    rng, it0 = jax.random.PRNGKey(4), 4
    jax32 = _jax_cycle(cfg, st0, imgs, rng, it0)
    draws = _jax_draws(cfg, rng, it0)
    runs = {"fp32": _port_cycle(model, flat0, imgs, draws, it0)}
    out = dict(name=request.param, jax32=jax32, runs=runs, before=before)
    if request.param != "none":
        out["jax64"] = _jax_cycle(cfg, st0, imgs, rng, it0, x64=True)
        runs["float64"] = _port_cycle(dict(model, dtype="float64"), flat0,
                                      imgs, draws, it0)
    return out


# Each model of STEP_MODELS has its cycle in a file of its own: this one,
# ``test_torch_cycle_duplex.py`` and ``test_torch_cycle_fusedkv.py``
# (``--dist loadfile`` runs a file on one worker, and a model's JAX
# cycles take minutes to compile there).  Unlike the port's other test
# files, these keep torch's default thread pool (no
# ``tests.torch_threads.one_thread``): on one thread the float64 cycle of
# duplex_fusedkv puts two attention biases' Adam moments at 1.03e-4 of
# their scale from JAX's, over the MODEL class they pass at here.
cycle_vs_jax = pytest.fixture(scope="module", params=["none"])(cycle_setup)


def test_cycle_counts_are_jaxs(cycle_vs_jax):
    counts = cycle_vs_jax["jax32"][2]
    assert cycle_vs_jax["runs"]["fp32"][2] == counts
    assert counts["Loss/D"] == K


def test_cycle_aux_sums_match_jax(cycle_vs_jax):
    r = cycle_vs_jax
    _hold_sums(r["runs"]["fp32"][1], r["jax32"][1])
    if "jax64" in r:
        _hold_sums(r["runs"]["float64"][1], r["jax64"][1])


def test_cycle_state_matches_jax(cycle_vs_jax):
    """Every leaf after the K iterations: the parameters, the EMA, Adam's
    moments and counts, ``w_avg``, ``pl_mean`` and ``step``."""
    r = cycle_vs_jax
    got = r["runs"]["fp32"][0]
    if "jax64" not in r:
        assert not _hold(got, r["jax32"][0], r["before"])
        return
    assert not _hold(r["runs"]["float64"][0], r["jax64"][0], r["before"])
    by_clause = _hold(got, r["jax64"][0], r["before"], r["jax32"][0])
    for key, err, own in by_clause:
        print(f"{key}: port fp32 {err:.3e}, JAX fp32 {own:.3e} of the "
              f"scale from JAX float64")


def test_cycle_refuses_what_jax_cannot_cycle():
    """``train.fused_cycle`` where ``d_reg_interval`` is no multiple of
    ``g_reg_interval`` fails validation, with JAX's reason."""
    exp = port_config.ExperimentConfig(
        model=port_config.ModelConfig(**STEP_MODELS["none"]),
        train=port_config.TrainConfig(batch_size=BATCH, d_reg_interval=4,
                                      g_reg_interval=3, fused_cycle=True))
    with pytest.raises(ValueError, match="multiple of g_reg_interval"):
        exp.validate()
    dataclasses.replace(exp, train=dataclasses.replace(
        exp.train, fused_cycle=False)).validate()
