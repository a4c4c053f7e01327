"""R1 of the PyTorch port (``d_step_r1``) against the JAX package, on the
CPU.

One ``d_step_r1`` runs on both sides from the same JAX ``TrainState``
(carried by the bridge), the same reals, latents and mirror flips (drawn
by the JAX side and injected into the port; noise and style mixing off),
for the micro configurations of ``tests/test_torch_train.py`` and a
``d_attention`` one, at ``r1_batch_shrink`` 1 and 2.  The port runs twice:
on the plain path, and on the card's route with every launch stubbed by
its plain version with no graph attached (the ``card_route`` stubs), so
every kernel call the second order needs must sit inside a Function.
There the launch, lse and second-order counts are held to
``chip_smoke.r1_step_calls``' plan, and a planted fault (the second-order
output of one upfirdn launch detached: the silent drop a ctypes launch
would give) must fail the comparison.  Then the op-level second order
(upfirdn's, with a ramp filter, against ``jax.grad`` of ``jax.grad``
through the XLA reference), the float64 reference mode, and the CLI's R1
schedule.

Tolerances: whole networks at ``MODEL`` (1e-4 of each leaf's scale, as
``tests/test_torch_train.py``: fp32 forward, backward and double backward
through ~20 layers, summation order apart); single ops at
``GRAD["float32"]`` (``tests/tolerances.py``, 1e-5); float64 against
fp32 at ``MODEL``, fp32 rounding being the only difference.
"""

import dataclasses
import json
import os
import subprocess
import sys
import types
from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gansformer_tpu.core import config as jax_config
from gansformer_tpu.losses import gan as jax_losses
from gansformer_tpu.train import steps as jax_steps
from gansformer_tpu_torch import bridge, ops
from gansformer_tpu_torch.core import config as port_config
from gansformer_tpu_torch.core import device as port_device
from gansformer_tpu_torch.data import SyntheticDataset
from gansformer_tpu_torch.losses import r1_penalty, r1_slice
from gansformer_tpu_torch.models import Generator
from gansformer_tpu_torch.models.discriminator import Discriminator
from gansformer_tpu_torch.models.generator import init_weights
from gansformer_tpu_torch.ops import cuda_attention
from gansformer_tpu_torch.train import create_train_state, steps
from tests.test_torch_grads import card_route  # noqa: F401  (fixture)
from tests.test_torch_grads import patch_card_route
from tests.test_torch_train import (BATCH, MICRO, MODEL, STEP_MODELS,
                                    _NoNoiseGenerator, _close, _close_leaf,
                                    _close_param, _jax_cfg, _perturbed_state)
from tests.tolerances import GRAD

jax_fba = import_module("gansformer_tpu.ops.fused_bias_act")
jax_ufd = import_module("gansformer_tpu.ops.upfirdn2d")
port_ufd = import_module("gansformer_tpu_torch.ops.upfirdn2d")
port_mc = import_module("gansformer_tpu_torch.ops.modulated_conv")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

D_ATTENTION = dict(STEP_MODELS["duplex"], d_attention=True, d_components=3)
# (generator / discriminator configuration, r1_batch_shrink)
R1_CASES = {"none-shrink1": (MICRO, 1), "none-shrink2": (MICRO, 2),
            "duplex-shrink1": (STEP_MODELS["duplex"], 1),
            "d_attention-shrink1": (D_ATTENTION, 1),
            "d_attention-shrink2": (D_ATTENTION, 2)}


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _port_r1(model, shrink, flat0, imgs, z, flip, route, plant=False):
    """One ``d_step_r1`` of the port from the JAX state ``flat0``: its aux,
    D's gradients, D's parameters after the update and, on the card's
    route, the counters.  ``plant`` makes the first adjoint launch of the
    image gradient a bare launch, outside ``UpfirdnAdjointFunction``: its
    value is right, and the second order through it is silently lost."""
    train = port_config.TrainConfig(batch_size=BATCH, style_mixing_prob=0.0,
                                    ema_kimg=0.01, r1_batch_shrink=shrink)
    port = create_train_state(port_config.ModelConfig(**model), train,
                              seed=0, device="cpu")
    bridge.load_train_state(port, flat0)
    draw = steps.draw_step

    def draw_with_flip(*a, **kw):
        return dataclasses.replace(draw(*a, **kw), flip=flip)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(steps, "draw_step", draw_with_flip)
        if route == "card":
            patch_card_route(mp)
        if plant:
            adj = port_ufd.UpfirdnAdjointFunction
            apply, planted = adj.apply, []

            def bare_once(*a):
                if planted:
                    return apply(*a)
                planted.append(1)
                return port_ufd.upfirdn2d_adjoint(*a)
            mp.setattr(adj, "apply", staticmethod(bare_once))
        ops.reset_launch_counts()
        aux = steps.d_step_r1(port, torch.from_numpy(imgs), 0, z=_t(z),
                              noise_mode="none", mirror_augment=True)
        counts = (ops.launch_counts(), ops.lse_launch_counts(),
                  ops.second_order_counts())
        ops.reset_launch_counts()
    d = port.discriminator
    return dict(
        aux={k: float(v) for k, v in aux.items()},
        grads={k.replace(".", "/"): p.grad.double().numpy()
               for k, p in d.named_parameters()},
        after={f"d_params/{k.replace('.', '/')}": p.detach().double().numpy()
               for k, p in d.named_parameters()},
        counts=counts)


@pytest.fixture(scope="module", params=sorted(R1_CASES))
def r1_vs_jax(request):
    model, shrink = R1_CASES[request.param]
    cfg = _jax_cfg(model)
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, r1_batch_shrink=shrink),
        data=dataclasses.replace(cfg.data, mirror_augment=True))
    st0 = _perturbed_state(cfg)
    flat0 = bridge.flatten_train_state(jax.device_get(st0))
    imgs = np.random.RandomState(1).randint(0, 255, (BATCH, 16, 16, 3),
                                            dtype=np.uint8)
    rng_d = jax.random.PRNGKey(13)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_steps, "Generator", _NoNoiseGenerator)
        fns = jax_steps.make_train_steps(cfg, None, batch_size=BATCH)
        st1, daux = fns.d_step_r1(st0, jnp.asarray(imgs), rng_d)
        flat1 = bridge.flatten_train_state(jax.device_get(st1))
    shape = (BATCH, cfg.model.num_ws, cfg.model.latent_dim)
    z = np.asarray(jax.random.normal(jax.random.fold_in(rng_d, 0), shape))
    flip = np.array(jax.random.bernoulli(jax.random.fold_in(rng_d, 7), 0.5,
                                         (BATCH, 1, 1, 1))).reshape(-1)
    assert 0 < flip.sum() < BATCH          # some reals mirrored, some not
    flip = torch.from_numpy(flip)
    ref = dict(model, dtype="float64")
    runs = {"plain": _port_r1(model, shrink, flat0, imgs, z, flip, "plain"),
            "card": _port_r1(ref, shrink, flat0, imgs, z, flip, "card")}
    planted = _port_r1(ref, shrink, flat0, imgs, z, flip, "card",
                       plant=True)
    mu = {k[len("d_opt/mu/"):]: v for k, v in flat1.items()
          if k.startswith("d_opt/mu/")}
    return dict(model=model, shrink=shrink, flat0=flat0, flat1=flat1,
                daux={k: float(v) for k, v in daux.items()}, mu=mu,
                runs=runs, planted=planted)


def _hold_to_jax(r, run):
    """The port's losses, D's gradients (JAX's new Adam first moment, its
    beta1 being 0) and D after the update against the JAX step."""
    assert set(run["aux"]) == set(r["daux"]) and "Loss/D/r1" in run["aux"]
    for k, v in r["daux"].items():
        _close(run["aux"][k], v, k)
    assert set(run["grads"]) == set(r["mu"])
    for name, g in run["grads"].items():
        _close_leaf(g, name, r["mu"], f"grad {name}")
    for key, v in run["after"].items():
        _close_param(v, key, r["flat1"], r["flat0"], MODEL)


def test_d_step_r1_matches_jax(r1_vs_jax):
    """The plain path: ``Loss/D`` (the logistic loss alone, as in JAX),
    ``Loss/D/r1``, the scores, every gradient of D and D after the
    update."""
    _hold_to_jax(r1_vs_jax, r1_vs_jax["runs"]["plain"])


def test_d_step_r1_on_the_cards_route_matches_jax_and_the_plan(r1_vs_jax):
    """The card's route with opaque launch stubs, in the float64 mode: the
    same step within the same tolerance, with the kernel launches, the
    forward attention launches that wrote lse and the second-order passes
    as the smoke's plan has them.  float64, because the stubs are the
    plain versions in the kernels' own form: the grid->latent backward
    rebuilds P from lse, which at fp32 rounds away from autograd of the
    softmax by ~ulp(|logit|) per probability, and R1 differentiates that
    once more: with ``d_attention`` the fp32 route lands 1.3e-3 of a
    leaf's scale from a float64 run, the fp32 plain path 2e-5 (measured
    on these inputs).  The card's fp32 kernels are held to the float64
    reference on the card by ``chip_smoke.py``."""
    r = r1_vs_jax
    run = r["runs"]["card"]
    _hold_to_jax(r, run)
    model = port_config.ModelConfig(**r["model"])
    plan = chip_smoke.r1_step_calls(model, BATCH, r["shrink"])
    launches, lse, second = run["counts"]
    assert launches == chip_smoke.plan_counts(plan, "d_step_r1")
    assert lse == chip_smoke.plan_lse_counts(plan, "d_step_r1")
    assert second == chip_smoke.plan_second_order_counts(model, BATCH,
                                                         r["shrink"])
    assert second["upfirdn_second_order"] > 0
    if model.d_attention:
        assert second["grid_to_latent_second_order"] > 0
        assert second["latent_to_grid_second_order"] > 0


def test_planted_second_order_drop_fails_the_comparison(r1_vs_jax):
    """One adjoint launch of the image gradient outside its Function (a
    ctypes launch's output has no graph, so the second order through it
    is silently dropped) moves D's gradients outside the tolerance."""
    with pytest.raises(AssertionError):
        _hold_to_jax(r1_vs_jax, r1_vs_jax["planted"])


def test_r1_penalty_and_slice_match_jax(rng):
    """The penalty on a closed-form score with a nonlinear image gradient,
    its parameter gradient, and the slice."""
    x = rng.randn(4, 5, 5, 3).astype(np.float32)
    w = rng.randn(5, 5, 3).astype(np.float32)

    def score_np(img, wj):
        return jnp.sum(jnp.tanh(img * wj), axis=(1, 2, 3))

    ref, ref_g = jax.value_and_grad(lambda wj: jax_losses.r1_penalty(
        lambda img: score_np(img, wj), jnp.asarray(x)))(jnp.asarray(w))
    tw = _t(w, True)
    got = r1_penalty(lambda img: torch.tanh(img * tw).sum(dim=(1, 2, 3)),
                     _t(x))
    (got_g,) = torch.autograd.grad(got, [tw])
    np.testing.assert_allclose(float(got.detach()), float(ref),
                               **GRAD["float32"])
    np.testing.assert_allclose(got_g.numpy(), np.asarray(ref_g),
                               **GRAD["float32"])
    for shrink in (1, 2, 4):
        np.testing.assert_array_equal(
            r1_slice(_t(x), shrink).numpy(),
            np.asarray(jax_losses.r1_slice(jnp.asarray(x), shrink)))


# --------------------------------------------------------------------------
# upfirdn's second order: the adjoint of the adjoint
# --------------------------------------------------------------------------

# (up, down, pad, act): the blur, D's decimated skip, G's up-conv blur
# with the lrelu epilogue
UFD_SECOND = {"same3": (1, 1, (2, 1), None),
              "skip-down2": (1, 2, (1, 1), None),
              "up2-lrelu": (2, 1, (2, 1), "lrelu")}
RAMP = (1, 2, 3, 4)


@pytest.mark.parametrize("case", sorted(UFD_SECOND))
def test_upfirdn_double_backward_matches_jax(rng, card_route, case):
    """R1's shape on one upfirdn: the gradient wrt the input x of a loss
    nonlinear in the output, squared and summed, differentiated wrt x,
    an input scale a and the bias, on the card's route (opaque stubs),
    against ``jax.grad`` of ``jax.grad`` through the XLA upfirdn and
    ``fused_bias_act``.  A ramp filter, so a missing flip shows.  One
    forward launch and one second-order launch of kernel 2, two adjoint
    launches (the image gradient's and the forward graph's)."""
    up, down, pad, act = UFD_SECOND[case]
    f = ops.setup_filter(RAMP, gain=float(up * up))
    x = rng.randn(2, 8, 9, 4).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    pads = port_ufd.pad4(pad)
    oh, ow = port_ufd.out_hw(8, 9, 4, 4, up, down, pads)
    t = rng.randn(2, oh, ow, 4).astype(np.float32)

    def r1_jax(xj, a, bj):
        def loss(xx):
            y = jax_ufd.upfirdn2d(xx * a, f, up=up, down=down, pad=pads)
            if act:
                y = jax_fba.fused_bias_act(y, bj, act=act)
            return jnp.sum(jnp.cos(y) * t)
        return jnp.sum(jax.grad(loss)(xj) ** 2)

    refs = jax.grad(r1_jax, argnums=(0, 1, 2))(jnp.asarray(x), 1.3,
                                                jnp.asarray(b))
    tx, ta, tb = _t(x, True), _t(1.3, True), _t(b, True)
    y = port_ufd.upfirdn2d(tx * ta, f, up=up, down=down, pad=pads,
                           bias=tb if act else None, act=act)
    (gx,) = torch.autograd.grad((torch.cos(y) * _t(t)).sum(), [tx],
                                create_graph=True)
    got = torch.autograd.grad(gx.square().sum(), [tx, ta, tb],
                              allow_unused=True)
    for name, g, r in zip(("x", "a", "b"), got, refs):
        if not act and name == "b":
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name,
                                   **GRAD["float32"])
    counts = ops.launch_counts()
    assert (counts["upfirdn"], counts["upfirdn_adjoint"]) == (2, 2)
    assert ops.second_order_counts()["upfirdn_second_order"] == 1


# --------------------------------------------------------------------------
# The float64 reference mode
# --------------------------------------------------------------------------

F64_MODELS = {"none": MICRO, "d_attention": D_ATTENTION}


@pytest.mark.parametrize("name", sorted(F64_MODELS))
def test_float64_mode_agrees_with_fp32_plain_path(rng, name):
    """``ModelConfig(dtype="float64")`` on the host: G's images, D's
    logits and D's R1 gradients agree with the fp32 plain path to fp32
    rounding, and are float64 (the gradients fp32, the parameters'
    dtype)."""
    out = {}
    z = rng.randn(2, 3, 16).astype(np.float32)
    reals = rng.randn(4, 16, 16, 3).astype(np.float32)
    for dtype in ("float64", "float32"):
        model = port_config.ModelConfig(**dict(F64_MODELS[name],
                                               dtype=dtype))
        g = init_weights(Generator(model), 5)
        d = init_weights(Discriminator(model), 6)
        with torch.no_grad():
            img = g(_t(z).to(getattr(torch, dtype)), noise_mode="none")
        logits = d(img)
        r1 = r1_penalty(d, _t(reals).to(getattr(torch, dtype)))
        grads = torch.autograd.grad(r1, list(d.parameters()),
                                    allow_unused=True)
        out[dtype] = (img, logits, r1, grads)
        assert img.dtype == logits.dtype == r1.dtype == getattr(torch,
                                                                dtype)
        assert all(gr.dtype == torch.float32 for gr in grads
                   if gr is not None)
    for a, b in zip(out["float64"][:3], out["float32"][:3]):
        _close(a.detach().double(), b.detach().double(), tol=MODEL)
    names = [n for n, _ in Discriminator(model).named_parameters()]
    for n, a, b in zip(names, out["float64"][3], out["float32"][3]):
        assert (a is None) == (b is None), n    # the head's bias: unused
        if a is not None and not n.endswith(("_k_x.b", ".k_y.b")):
            _close(a, b, n, tol=MODEL)


def test_float64_mode_raises_on_the_cards_route(rng, monkeypatch):
    """A float64 tensor on the card raises where the route is taken: in
    ``kernel_route`` itself (a stand-in for a card tensor), and in a D
    forward whose ops are told the card holds their tensors."""
    def on_card(t):
        return types.SimpleNamespace(device=torch.device("cuda"),
                                     dtype=t.dtype)

    with pytest.raises(ValueError, match="float64"):
        port_device.kernel_route(on_card(torch.zeros(1, dtype=torch.float64)))
    assert port_device.kernel_route(on_card(torch.zeros(1))) is True
    for mod in (port_mc, port_ufd, cuda_attention):
        monkeypatch.setattr(
            mod, "kernel_route",
            lambda t: port_device.kernel_route(on_card(t)))
    d = init_weights(Discriminator(port_config.ModelConfig(
        **dict(MICRO, dtype="float64"))), 6)
    with pytest.raises(ValueError, match="float64"):
        d(_t(rng.randn(4, 16, 16, 3)).double())
    with pytest.raises(ValueError, match="model.dtype"):
        port_config.validate(port_config.ModelConfig(dtype="float64"),
                             port_config.TrainConfig())


# --------------------------------------------------------------------------
# Config and CLI
# --------------------------------------------------------------------------


def test_r1_batch_shrink_is_read_and_validated_as_in_jax():
    cfg = _jax_cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, r1_batch_shrink=2))
    train = port_config.train_config_from_json(cfg.to_json())
    assert train.r1_batch_shrink == 2 and port_config.TrainConfig(
    ).r1_batch_shrink == jax_config.TrainConfig().r1_batch_shrink == 1
    model = port_config.ModelConfig(**MICRO)
    for shrink, msg in ((0, "must be ≥ 1"), (3, "must divide")):
        bad = dataclasses.replace(cfg.train, r1_batch_shrink=shrink)
        with pytest.raises(ValueError, match=msg):
            jax_config.ExperimentConfig.validate(dataclasses.replace(
                cfg, train=bad))
        with pytest.raises(ValueError, match=msg):
            port_config.validate(model, dataclasses.replace(
                train, r1_batch_shrink=shrink))


def test_train_cli_runs_r1_every_d_reg_interval(tmp_path):
    """``cli.train --device cpu`` at ``d_reg_interval`` 1 runs
    ``d_step_r1`` at both iterations; at 2, at iteration 0 only (one
    iteration per tick, so each tick's stats show its iteration's
    step)."""
    for interval, want in ((1, [True, True]), (2, [True, False])):
        cfg = _jax_cfg()
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, d_reg_interval=interval, kimg_per_tick=0.004))
        path = tmp_path / f"config{interval}.json"
        path.write_text(cfg.to_json())
        run = tmp_path / f"run{interval}"
        out = subprocess.run(
            [sys.executable, "-m", "gansformer_tpu_torch.cli.train",
             "--config", str(path), "--steps", "2", "--batch-size", "4",
             "--device", "cpu", "--run-dir", str(run)], cwd=ROOT,
            capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        ticks = [json.loads(ln) for ln in (run / "stats.jsonl").open()]
        assert ["Loss/D/r1" in t for t in ticks] == want, ticks
        assert json.loads((run / "config.json").read_text())["train"][
            "d_reg_interval"] == interval


def test_d_step_r1_reaches_every_leaf_of_d(card_route):
    """Every parameter of D (with ``d_attention``) takes a finite, nonzero
    gradient from one ``d_step_r1`` on the card's route."""
    model = port_config.ModelConfig(**D_ATTENTION)
    st = create_train_state(model, port_config.TrainConfig(batch_size=4),
                            seed=2, device="cpu")
    reals = torch.from_numpy(next(SyntheticDataset(16).batches(4))["image"])
    aux = steps.d_step_r1(st, reals, 0)
    assert np.isfinite(float(aux["Loss/D/r1"])) and float(aux["Loss/D/r1"])
    for name, p in st.discriminator.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert (p.grad != 0).any(), name
