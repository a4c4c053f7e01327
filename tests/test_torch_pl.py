"""Path length of the PyTorch port (``g_step_pl``) against the JAX package,
on the CPU.

One ``g_step_pl`` runs on both sides from the same JAX ``TrainState``
(carried by the bridge) with the same latents ``z``, PL latents ``z_pl``
and projection noise (drawn by the JAX side from its own keys and
injected into the port; conv noise and style mixing off), for the micro
configurations of ``tests/test_torch_train.py`` with and without the
generator's attention, at ``pl_batch_shrink`` 1 and 2.  The port runs
twice: on the plain path, and on the card's route with every launch
stubbed by its plain version with no graph attached (the ``card_route``
stubs), so every kernel call the second order needs must sit inside a
Function.  There the launch, lse and second-order counts are held to
``chip_smoke.pl_step_calls``' plan, and a planted fault (one
``ModconvGradsFunction`` run bare, its second order silently lost, as a
ctypes launch would lose it) must fail the comparison.  Then the
op-level second order of the modconv core on its kernels' plain versions
against ``jax.grad`` of ``jax.grad`` of ``pallas_modconv._ref_full`` (the
function the JAX package's own second order goes through; the Pallas op
cannot run in interpret mode here), the penalty alone, the config keys
and the CLI's schedule.

Tolerances: whole networks at ``MODEL`` (1e-4 of each leaf's scale, as
``tests/test_torch_train.py``: fp32 forward, backward and double backward
through ~20 layers, summation order apart); single ops at
``GRAD["float32"]`` (``tests/tolerances.py``, 1e-5).  With the
generator's attention, where fp32 cannot resolve the step (see
``_jax_g_step_pl_64``), the reference is JAX's step in float64.
"""

import contextlib
import dataclasses
import json
from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gansformer_tpu.core import config as jax_config
from gansformer_tpu.losses import gan as jax_losses
from gansformer_tpu.ops.pallas_modconv import _ref_full
from gansformer_tpu.train import steps as jax_steps
from gansformer_tpu_torch import bridge, ops
from gansformer_tpu_torch.cli import train as port_cli
from gansformer_tpu_torch.core import config as port_config
from gansformer_tpu_torch.losses import path_length_penalty
from gansformer_tpu_torch.train import create_train_state, steps
from tests.test_torch_grads import card_route  # noqa: F401  (fixture)
from tests.test_torch_grads import patch_card_route
from tests.test_torch_train import (BATCH, MICRO, MODEL, STEP_MODELS,
                                    _NoNoiseGenerator, _close, _close_leaf,
                                    _close_param, _jax_cfg, _key_bias,
                                    _perturbed_state)
from tests.tolerances import GRAD
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

port_mc = import_module("gansformer_tpu_torch.ops.modulated_conv")


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


# --------------------------------------------------------------------------
# The modconv core's second order on its kernels
# --------------------------------------------------------------------------

# Each input's gradient at GRAD["float32"] (1e-5) of its own scale: the
# second order sums products over pixels and channels, so its entries
# span three decades and an entry near zero carries the summation-order
# error of the largest.
OP_TOL = GRAD["float32"]["rtol"]
# kind, epilogue, and which first-order gradients the outer loss reads:
# "x" alone (as path length reads G's gradient: gds and gdw arrive as
# None where the core's input is not on the path) or "xws" (all three,
# so the gdw terms run too)
OP_CASES = [(kind, act, wrt) for kind in ("same3", "same1", "poly")
            for act in (None, "lrelu") for wrt in ("x", "xws")]


@pytest.mark.parametrize("kind,act,wrt", OP_CASES,
                         ids=[f"{k}-{a}-{w}" for k, a, w in OP_CASES])
def test_modconv_double_backward_matches_jax(rng, card_route, kind, act,
                                             wrt):
    """A loss linear in the core's first-order gradients (dx, or dx, dw
    and ds) of a loss nonlinear in its output, differentiated wrt x, w,
    s, d and the bias, on the card's route (opaque stubs), against
    ``jax.grad`` of ``jax.grad`` of ``_ref_full``, each gradient within
    ``OP_TOL`` of its scale.  ``same1`` without
    demodulation (the tRGB: d = 1, no gradient).  The second order
    launches kernels 1, 5 and 6, counted as ``modconv_second_order``:
    three launches with gdx alone, five with gdw too (kernels 1 and 5
    once more on gdw)."""
    ks = 1 if kind == "same1" else 3
    up = 2 if kind == "poly" else 1
    n, h, w_, ci, co = 2, 5, 4, 6, 5
    x = rng.randn(n, h, w_, ci).astype(np.float32)
    w = (rng.randn(ks, ks, ci, co) * 0.3).astype(np.float32)
    s = (rng.randn(n, ci) * 0.3 + 1.0).astype(np.float32)
    demod = kind != "same1"
    d = ((rng.rand(n, co) + 0.5) if demod else np.ones((n, co))).astype(
        np.float32)
    b = (rng.randn(co) * 0.5).astype(np.float32)
    t = rng.randn(n, up * h, up * w_, co).astype(np.float32)
    firsts = (0,) if wrt == "x" else (0, 1, 2)
    r = [rng.randn(*a.shape).astype(np.float32) for a in (x, w, s)]
    gain = ops.ACTIVATIONS[act][1] if act else 1.0

    def l2_jax(xj, wj, sj, dj, bj):
        def l1(*a):
            y = _ref_full(*a, dj, bj, kind, act, 0.2, gain)
            return jnp.sum(jnp.cos(y) * t)
        gs = jax.grad(l1, argnums=firsts)(xj, wj, sj)
        return sum(jnp.sum(g * r[i]) for g, i in zip(gs, firsts))

    argnums = (0, 1, 2) + ((3,) if demod else ()) + ((4,) if act else ())
    refs = jax.grad(l2_jax, argnums=argnums)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), jnp.asarray(d),
        jnp.asarray(b))
    ins = [_t(x, True), _t(w, True), _t(s, True), _t(d, demod),
           _t(b, True) if act else None]
    y = port_mc.ModconvCore.apply(*ins, kind, act, 0.2, gain)
    gs = torch.autograd.grad((torch.cos(y) * _t(t)).sum(),
                             [ins[i] for i in firsts], create_graph=True)
    ops.reset_launch_counts()
    l2 = sum((g * _t(r[i])).sum() for g, i in zip(gs, firsts))
    got = torch.autograd.grad(l2, [ins[i] for i in argnums])
    for i, g, ref in zip(argnums, got, refs):
        _close(g.numpy(), np.asarray(ref), "xwsdb"[i], tol=OP_TOL)
    second = ops.second_order_counts()["modconv_second_order"]
    assert second == (3 if wrt == "x" else 5)
    counts = ops.launch_counts()
    # and the forward graph's backward: kernels 5 and 6 once each
    assert counts["modconv"] + counts["modconv_dx"] + counts[
        "modconv_dw"] == second + 2


# --------------------------------------------------------------------------
# One g_step_pl against JAX
# --------------------------------------------------------------------------

# (generator configuration, pl_batch_shrink)
PL_CASES = {"none-shrink1": (MICRO, 1), "none-shrink2": (MICRO, 2),
            "duplex-shrink1": (STEP_MODELS["duplex"], 1),
            "duplex-shrink2": (STEP_MODELS["duplex"], 2)}
PL_MEAN0 = 0.75


# With the generator's attention on, a few rows of the micro model's
# grid->latent softmax saturate (two latents at b16: 1 - max p rounds to
# 0 in fp32), and fp32 cannot resolve path length's second order through
# them: JAX's own fp32 step lies up to 3.6e-2 of a leaf's scale from
# JAX's float64 step there.  So with the attention the reference is JAX's
# step in float64 (``_jax_g_step_pl_64``), which the port's float64 path
# meets at MODEL on every leaf, and a leaf of the port's fp32 step passes
# within MODEL of its scale or no further from JAX's float64 step than
# JAX's own fp32 step lies.


def _attention_float64(q, k, v, num_heads=1):
    """``gansformer_tpu.ops.attention.multihead_attention`` with its
    logits and softmax in the inputs' dtype (it casts q and k to fp32)."""
    n, lq, d = q.shape
    _, lk, dv = v.shape
    dh = d // num_heads
    qh = q.reshape(n, lq, num_heads, dh)
    kh = k.reshape(n, lk, num_heads, dh)
    vh = v.reshape(n, lk, num_heads, dv // num_heads)
    probs = jax.nn.softmax(
        jnp.einsum("nqhd,nkhd->nhqk", qh, kh) / np.sqrt(dh), axis=-1)
    out = jnp.einsum("nhqk,nkhd->nqhd", probs, vh)
    return out.reshape(n, lq, dv), probs


def _jax_g_step_pl_64(cfg, st0, rng_g):
    """JAX's ``fns.g_step_pl`` in float64 (x64 on, compute dtype float64,
    the attention's fp32 cast lifted) from ``st0`` cast up, with the same
    keys: its draws are fp32 draws as in the fp32 step.  Returns the flat
    state after the step and the aux."""
    from gansformer_tpu.models import attention as jax_attention

    cfg64 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="float64"))
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_steps, "Generator", _NoNoiseGenerator)
        mp.setattr(jax_attention, "multihead_attention", _attention_float64)
        st64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64)
            if jnp.asarray(a).dtype == jnp.float32 else jnp.asarray(a),
            jax.device_get(st0))
        fns = jax_steps.make_train_steps(cfg64, None, batch_size=BATCH)
        st1, gaux = fns.g_step_pl(st64, rng_g)
        return bridge.flatten_train_state(jax.device_get(st1)), gaux


def _jax_ref(flat1, gaux):
    return dict(flat1=flat1, gaux={k: float(v) for k, v in gaux.items()},
                mu={k[len("g_opt/mu/"):]: np.asarray(v, np.float64)
                    for k, v in flat1.items() if k.startswith("g_opt/mu/")})


def _port_pl(model, shrink, flat0, z, z_pl, noise, route, plant=False):
    """One ``g_step_pl`` of the port from the JAX state ``flat0`` with the
    JAX side's draws: its aux, G's gradients, G and the EMA after the
    update, ``pl_mean`` and, on the card's route, the counters.  ``plant``
    runs the first ``ModconvGradsFunction`` bare
    (``chip_smoke.planted_modconv_second_order_drop``)."""
    train = port_config.TrainConfig(batch_size=BATCH, style_mixing_prob=0.0,
                                    ema_kimg=0.01, pl_batch_shrink=shrink)
    port = create_train_state(port_config.ModelConfig(**model), train,
                              seed=0, device="cpu")
    bridge.load_train_state(port, flat0)
    with pytest.MonkeyPatch.context() as mp:
        if route == "card":
            patch_card_route(mp)
        with (chip_smoke.planted_modconv_second_order_drop() if plant
              else contextlib.nullcontext([1])) as done:
            ops.reset_launch_counts()
            aux = steps.g_step_pl(port, 0, BATCH, z=_t(z), z_pl=_t(z_pl),
                                  pl_noise=_t(noise), noise_mode="none")
            counts = (ops.launch_counts(), ops.lse_launch_counts(),
                      ops.second_order_counts())
            ops.reset_launch_counts()
        assert done
    g = port.generator
    return dict(
        aux={k: float(v) for k, v in aux.items()},
        grads={k.replace(".", "/"): p.grad.double().numpy()
               for k, p in g.named_parameters()},
        after={f"{tree}/{k.replace('.', '/')}": p.detach().double().numpy()
               for tree, module in (("g_params", g), ("ema_params",
                                                      port.ema))
               for k, p in module.named_parameters()},
        pl_mean=float(port.pl_mean), counts=counts)


def pl_setup(request):
    """One case of ``PL_CASES`` on both sides (the fixture ``pl_vs_jax``
    of this file, with the cases without the attention, and of
    ``test_torch_pl_duplex1.py`` and ``test_torch_pl_duplex2.py``, one
    duplex case each: ``--dist loadfile`` runs a file on one worker)."""
    model, shrink = PL_CASES[request.param]
    cfg = _jax_cfg(model)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, pl_batch_shrink=shrink))
    st0 = _perturbed_state(cfg)
    st0 = st0.replace(pl_mean=jnp.asarray(PL_MEAN0, st0.pl_mean.dtype))
    flat0 = bridge.flatten_train_state(jax.device_get(st0))
    rng_g = jax.random.PRNGKey(21)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_steps, "Generator", _NoNoiseGenerator)
        fns = jax_steps.make_train_steps(cfg, None, batch_size=BATCH)
        st1, gaux = fns.g_step_pl(st0, rng_g)
        jax32 = _jax_ref(bridge.flatten_train_state(jax.device_get(st1)),
                         gaux)
    attention = model.get("attention", "none")
    jax64 = (_jax_ref(*_jax_g_step_pl_64(cfg, st0, rng_g))
             if attention != "none" else None)
    m = cfg.model
    z = np.asarray(jax.random.normal(jax.random.fold_in(rng_g, 5),
                                     (BATCH, m.num_ws, m.latent_dim)))
    pl_batch = BATCH // shrink
    k_pl, k_noise = jax.random.split(jax.random.fold_in(rng_g, 3))
    z_pl = np.asarray(jax.random.normal(k_pl, (pl_batch, m.num_ws,
                                               m.latent_dim)))
    noise = np.asarray(jax.random.normal(k_noise, (pl_batch, m.resolution,
                                                   m.resolution, 3)))
    args = (flat0, z, z_pl, noise)
    ref = dict(model, dtype="float64")
    runs = {"plain": _port_pl(model, shrink, *args, "plain"),
            "float64": _port_pl(ref, shrink, *args, "plain"),
            "card": _port_pl(ref, shrink, *args, "card"),
            "planted": _port_pl(ref, shrink, *args, "card", plant=True)}
    return dict(model=model, shrink=shrink, flat0=flat0, jax32=jax32,
                jax64=jax64, runs=runs, attention=attention)


pl_vs_jax = pytest.fixture(scope="module", params=[
    "none-shrink1", "none-shrink2"])(pl_setup)


def _hold_grads(run, refs, fp32=None):
    """G's gradients of ``run`` against ``refs`` at MODEL of each leaf's
    scale, or, given JAX's fp32 gradients ``fp32`` (``refs`` being JAX's
    float64 ones), no further from ``refs`` than ``fp32`` lies where that
    is larger; returns (leaf, error, allowance) of the leaves that passed
    by that clause, errors and allowances relative to the leaf's scale."""
    assert set(run["grads"]) == set(refs)
    by_clause = []
    for name, g in run["grads"].items():
        if fp32 is None:
            _close_leaf(g, name, refs, f"grad {name}")
            continue
        r = refs[name]
        scale = float(np.abs(
            refs[name[:-1] + "w"] if _key_bias(name) else r).max())
        own = float(np.abs(np.asarray(fp32[name], np.float64) - r).max())
        err = float(np.abs(g - r).max())
        allow = max(MODEL * scale, own)
        assert err <= allow, (name, err, allow)
        if err > MODEL * scale:
            by_clause.append((name, err / scale, own / scale))
    return by_clause


def _hold_to_jax(r, run, ref="jax32", clause=False):
    """The port's losses, ``pl_mean``, G's gradients (JAX's new Adam first
    moment, its beta1 being 0) and G and the EMA after the update against
    the JAX step ``ref`` ("jax32" or "jax64").  ``clause``: the gradients
    by ``_hold_grads``' rule, JAX's fp32 step giving the allowance, and
    the parameters after the update not held.  Returns the leaves that
    passed by that clause."""
    j = r[ref]
    assert set(run["aux"]) == set(j["gaux"]) and "Loss/G/pl" in run["aux"]
    for k, v in j["gaux"].items():
        _close(run["aux"][k], v, k)
    _close(run["pl_mean"], float(j["flat1"]["pl_mean"]), "pl_mean")
    assert run["pl_mean"] != PL_MEAN0
    by_clause = _hold_grads(run, j["mu"], r["jax32"]["mu"] if clause
                            else None)
    if not clause:
        for key, v in run["after"].items():
            _close_param(v, key, j["flat1"], r["flat0"], MODEL)
    return by_clause


def test_g_step_pl_matches_jax(pl_vs_jax):
    """``Loss/G`` (the non-saturating loss alone, as in JAX),
    ``Loss/G/pl``, ``pl_mean``, every gradient of G, and G and the EMA
    after the update.  Without the attention the port's fp32 and float64
    paths against JAX's fp32 step at MODEL.  With it, against JAX's
    float64 step: the float64 path at MODEL, the fp32 path at MODEL or,
    at the leaves fp32 cannot resolve, no further than JAX's own fp32
    step lies (printed with ``-s``); the losses and ``pl_mean`` of the
    fp32 path are held to JAX's fp32 step too."""
    r = pl_vs_jax
    runs = r["runs"]
    if r["attention"] == "none":
        _hold_to_jax(r, runs["plain"])
        _hold_to_jax(r, runs["float64"])
        return
    _hold_to_jax(r, runs["float64"], "jax64")
    by_clause = _hold_to_jax(r, runs["plain"], "jax64", clause=True)
    for name, err, allow in by_clause:
        print(f"{r['shrink']} {name}: port fp32 {err:.3e}, "
              f"JAX fp32 {allow:.3e} of the scale from JAX float64")
    assert by_clause
    for k, v in r["jax32"]["gaux"].items():
        _close(runs["plain"]["aux"][k], v, k)
    _close(runs["plain"]["pl_mean"], float(r["jax32"]["flat1"]["pl_mean"]),
           "pl_mean")


def test_g_step_pl_on_the_cards_route_matches_and_launches_the_plan(
        pl_vs_jax):
    """The card's route with opaque launch stubs, in the float64 mode,
    against the plain float64 path (a second formulation of every
    second-order term) and against JAX (its fp32 step without the
    attention, its float64 step with it) at MODEL; the kernel launches,
    the forward attention launches that wrote lse and the second-order
    passes (kernels 1, 5 and 6 for the modconv core, kernel 2 for
    upfirdn, torch ops for the attention) as the smoke's plan has
    them."""
    r = pl_vs_jax
    run, ref = r["runs"]["card"], r["runs"]["float64"]
    _hold_grads(run, ref["grads"])
    for k, v in ref["aux"].items():
        _close(run["aux"][k], v, k)
    _hold_to_jax(r, run, "jax32" if r["attention"] == "none" else "jax64")
    model = port_config.ModelConfig(**r["model"])
    plan = chip_smoke.pl_step_calls(model, BATCH, r["shrink"])
    launches, lse, second = run["counts"]
    assert launches == chip_smoke.plan_counts(plan, "g_step_pl")
    assert lse == chip_smoke.plan_lse_counts(plan, "g_step_pl")
    assert second == chip_smoke.plan_pl_second_order_counts(
        model, BATCH, r["shrink"])
    assert second["modconv_second_order"] > 0
    assert second["upfirdn_second_order"] > 0
    if model.attention != "none":
        assert second["grid_to_latent_second_order"] > 0
        assert second["latent_to_grid_second_order"] > 0


def test_planted_modconv_second_order_drop_fails_the_comparison(pl_vs_jax):
    """The last tRGB's gradient in path length's first backward run bare,
    outside ``ModconvGradsFunction`` (a ctypes launch's output has no
    graph, so its second order is silently dropped): G's gradients on
    the card's route move outside MODEL of the float64 path's and of
    JAX's (its fp32 step without the attention, its float64 step with
    it)."""
    r = pl_vs_jax
    planted = r["runs"]["planted"]
    jax_ref = r["jax32"] if r["attention"] == "none" else r["jax64"]
    for refs in (r["runs"]["float64"]["grads"], jax_ref["mu"]):
        with pytest.raises(AssertionError):
            _hold_grads(planted, refs)


# --------------------------------------------------------------------------
# The penalty alone, the draws, the config and the CLI
# --------------------------------------------------------------------------


def test_path_length_penalty_matches_jax(rng):
    """The penalty, the new ``pl_mean`` and the penalty's gradient wrt a
    parameter of a closed-form synthesis with a nonlinear ws -> image
    map, the noise drawn by JAX from its key and handed to the port."""
    ws = rng.randn(3, 4, 5).astype(np.float32)
    a = (rng.randn(5, 6 * 6 * 3) * 0.3).astype(np.float32)
    key = jax.random.PRNGKey(4)

    def synth_jax(w, aj):
        return jnp.tanh(jnp.einsum("nkd,dp->np", w, aj)).reshape(3, 6, 6, 3)

    def pen_jax(aj):
        return jax_losses.path_length_penalty(
            lambda w: synth_jax(w, aj), jnp.asarray(ws), jnp.asarray(0.5),
            key, 0.01)

    (ref, ref_mean), ref_g = jax.value_and_grad(pen_jax, has_aux=True)(
        jnp.asarray(a))
    noise = np.asarray(jax.random.normal(key, (3, 6, 6, 3)))
    ta = _t(a, True)
    got, got_mean = path_length_penalty(
        lambda w: torch.tanh(torch.einsum("nkd,dp->np", w, ta)).reshape(
            3, 6, 6, 3), _t(ws, True), torch.tensor(0.5), _t(noise), 0.01)
    (got_g,) = torch.autograd.grad(got, [ta])
    for g, r in ((got, ref), (got_mean, ref_mean), (got_g, ref_g)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   **GRAD["float32"])
    assert not got_mean.requires_grad


def test_pl_draws_follow_the_seed_and_the_shrink():
    """The PL latents come from ``derive_seed(seed, it, "g", "pl")`` on the
    CPU, ``batch // pl_batch_shrink`` of them, apart from the step's own
    z; each row's conv noise has its own device generator."""
    model = port_config.ModelConfig(**MICRO)
    for shrink, rows in ((1, 4), (2, 2), (4, 1)):
        train = port_config.TrainConfig(batch_size=4, pl_batch_shrink=shrink)
        st = create_train_state(model, train, seed=5, device="cpu")
        z_pl, gens = steps.pl_draws(st, 3, 4)
        assert z_pl.shape == (rows, model.num_ws, model.latent_dim)
        assert len(gens) == rows
        again, _ = steps.pl_draws(st, 3, 4)
        torch.testing.assert_close(z_pl, again)
        assert not torch.equal(z_pl, steps.pl_draws(st, 4, 4)[0])
        assert not torch.equal(z_pl[:1], steps.draw_step(st, 3, "g",
                                                         4).z[:1])
        assert steps.pl_draws(st, 3, 4, noise_mode="none")[1] is None


def test_pl_config_keys_are_read_and_validated_as_in_jax():
    """``pl_weight``, ``pl_decay`` and ``pl_batch_shrink`` carry the JAX
    names and defaults, are read from a JAX config.json (no longer
    ignored), and ``pl_batch_shrink`` is validated with JAX's
    messages."""
    for name in ("pl_weight", "pl_decay", "pl_batch_shrink"):
        assert getattr(port_config.TrainConfig(), name) == getattr(
            jax_config.TrainConfig(), name)
        assert name not in port_config.IGNORED_TRAIN_KEYS
    cfg = _jax_cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, pl_weight=3.0, pl_decay=0.02, pl_batch_shrink=4))
    train = port_config.train_config_from_json(cfg.to_json())
    assert (train.pl_weight, train.pl_decay, train.pl_batch_shrink) == (
        3.0, 0.02, 4)
    model = port_config.ModelConfig(**MICRO)
    for shrink, msg in ((0, "pl_batch_shrink must be ≥ 1"),
                        (3, "must divide batch_size")):
        bad = dataclasses.replace(cfg.train, pl_batch_shrink=shrink)
        with pytest.raises(ValueError, match=msg):
            jax_config.ExperimentConfig.validate(dataclasses.replace(
                cfg, train=bad))
        with pytest.raises(ValueError, match=msg):
            port_config.validate(model, dataclasses.replace(
                train, pl_batch_shrink=shrink))


def test_train_cli_runs_g_step_pl_every_g_reg_interval(tmp_path,
                                                      monkeypatch):
    """``cli.train`` over 5 iterations at ``g_reg_interval`` 4 runs
    ``g_step_pl`` at iterations 0 and 4 and ``g_step`` at the others (the
    steps stubbed), and the ticks of those iterations (one iteration a
    tick) carry ``Loss/G/pl``."""
    from gansformer_tpu_torch.train import loop

    cfg = _jax_cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, kimg_per_tick=cfg.train.batch_size / 1000))
    path = tmp_path / "config.json"
    path.write_text(cfg.to_json())
    calls = []
    zero = torch.zeros(())

    def fake_d(state, reals, it, mirror_augment=False, label=None):
        return {"Loss/D": zero, "Loss/scores/real": zero,
                "Loss/scores/fake": zero}

    def fake_g(pl):
        def step(state, it, n, label=None):
            calls.append((it, pl))
            return {"Loss/G": zero,
                    **({"Loss/G/pl": torch.tensor(1.5)} if pl else {})}
        return step

    monkeypatch.setattr(loop, "d_step", fake_d)
    monkeypatch.setattr(loop, "d_step_r1", fake_d)
    monkeypatch.setattr(loop, "g_step", fake_g(False))
    monkeypatch.setattr(loop, "g_step_pl", fake_g(True))
    assert cfg.train.g_reg_interval == 4
    run = tmp_path / "run"
    assert port_cli.main(["--config", str(path), "--steps", "5",
                          "--device", "cpu", "--run-dir", str(run)]) == 0
    assert calls == [(0, True), (1, False), (2, False), (3, False),
                     (4, True)]
    ticks = [json.loads(ln) for ln in (run / "stats.jsonl").open()]
    assert [t.get("Loss/G/pl") for t in ticks] == [
        1.5, None, None, None, 1.5]
    assert "path length" in port_cli.build_parser().description
    assert "first-order" not in (port_cli.__doc__ or "")
