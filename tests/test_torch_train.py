"""The PyTorch port's discriminator and first-order train steps against
the JAX package, on the CPU.

JAX weights and a whole JAX ``TrainState`` (with non-zero Adam moments
and an EMA apart from the generator) are carried into the port by the
bridge.  One ``d_step`` and one ``g_step`` then run on both sides on the
same reals and latents, with noise and style mixing off (``jax.random``
streams cannot be reproduced in torch).  With the preset's Adam beta1 of
0, optax's new first moment is exactly the gradient, so the JAX step's
own state holds every leaf's gradient.  Tolerances: ``GRAD["float32"]``
(1e-5) for single ops; ``MODEL`` (1e-4 of each leaf's scale) for whole
networks, whose fp32 forward and backward chain ~20 layers of summation
order differences.
"""

import dataclasses
import json
import os
import subprocess
import sys
from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from gansformer_tpu.core import config as jax_config
from gansformer_tpu.data.dataset import SyntheticDataset as JaxSynthetic
from gansformer_tpu.data.dataset import normalize_images as jax_normalize
from gansformer_tpu.losses import gan as jax_losses
from gansformer_tpu.models.discriminator import Discriminator as JaxD
from gansformer_tpu.models.generator import Generator as JaxG
from gansformer_tpu.models.layers import minibatch_stddev as jax_mbstd
from gansformer_tpu.train import state as jax_state
from gansformer_tpu.train import steps as jax_steps
from gansformer_tpu_torch import bridge
from gansformer_tpu_torch.core import config as port_config
from gansformer_tpu_torch.data import SyntheticDataset, normalize_images
from gansformer_tpu_torch.losses import (d_logistic_loss,
                                         g_nonsaturating_loss)
from gansformer_tpu_torch.models.discriminator import Discriminator
from gansformer_tpu_torch.models.layers import minibatch_stddev
from gansformer_tpu_torch.ops import conv2d
from gansformer_tpu_torch.train import (create_train_state, d_step, g_step,
                                        lazy_adam)
from tests.test_torch_grads import card_route  # noqa: F401  (fixture)
from tests.tolerances import GRAD

jax_mc = import_module("gansformer_tpu.ops.modulated_conv")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = 1e-4

MICRO = dict(resolution=16, components=2, latent_dim=16, w_dim=16,
             mapping_dim=16, mapping_layers=2, fmap_base=64, fmap_max=32,
             attention="none", mbstd_group_size=4)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _close(got, ref, err_msg="", tol=MODEL):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale + 1e-12,
                               err_msg=err_msg)


def _key_bias(name: str) -> bool:
    """A bias added to every key of an attention (``k_x``, ``k_y``):
    softmax over the keys is invariant to it, so its exact gradient is
    zero and both sides hold rounding noise only."""
    return name.endswith(("_k_x/b", "/k_y/b"))


def _close_leaf(got, name, refs, err_msg="", tol=MODEL):
    """A leaf (a gradient, or a parameter after the update it drives)
    against ``refs[name]`` at ``tol`` of the leaf's own scale; a key bias
    at ``tol`` of its weight's scale, since its own is noise."""
    ref = refs[name]
    if _key_bias(name):
        scale = float(np.abs(np.asarray(refs[name[:-1] + "w"])).max())
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(ref, np.float64), rtol=0,
                                   atol=tol * scale, err_msg=err_msg)
    else:
        _close(got, ref, err_msg, tol)


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(tree, sep="/").items()}


# --------------------------------------------------------------------------
# Layers, losses, data
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,group", [(8, 4), (6, 4), (2, 4), (5, 5)])
def test_minibatch_stddev_matches_jax(rng, n, group):
    """Groups of consecutive samples, ``g`` shrinking until it divides n,
    population statistics; gradient too."""
    x = rng.randn(n, 4, 4, 6).astype(np.float32)
    tx = _t(x, True)
    y = minibatch_stddev(tx, group, 2)
    ref, vjp = jax.vjp(lambda a: jax_mbstd(a, group, 2), jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref),
                               **GRAD["float32"])
    ct = rng.randn(*y.shape).astype(np.float32)
    (g,) = torch.autograd.grad(y, [tx], _t(ct))
    np.testing.assert_allclose(g.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]),
                               **GRAD["float32"])


@pytest.mark.parametrize("k", [1, 3])
def test_conv2d_down_paths_match_jax(rng, k):
    """The discriminator's resampling convs: 1x1 decimating inside the
    blur, 3x3 blurring with its padding folded in then striding."""
    x = rng.randn(2, 8, 8, 5).astype(np.float32)
    w = (rng.randn(k, k, 5, 7) * 0.3).astype(np.float32)
    tx, tw = _t(x, True), _t(w, True)
    y = conv2d(tx, tw, down=2)
    ref, vjp = jax.vjp(lambda a, b: jax_mc.conv2d(a, b, down=2),
                       jnp.asarray(x), jnp.asarray(w))
    assert tuple(y.shape) == ref.shape == (2, 4, 4, 7)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref),
                               **GRAD["float32"])
    ct = rng.randn(*y.shape).astype(np.float32)
    for g, r in zip(torch.autograd.grad(y, [tx, tw], _t(ct)),
                    vjp(jnp.asarray(ct))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   **GRAD["float32"])


def test_losses_match_jax(rng):
    real = rng.randn(6, 1).astype(np.float32) * 3
    fake = rng.randn(6, 1).astype(np.float32) * 3
    np.testing.assert_allclose(
        float(d_logistic_loss(_t(real), _t(fake))),
        float(jax_losses.d_logistic_loss(jnp.asarray(real),
                                         jnp.asarray(fake))), rtol=1e-6)
    np.testing.assert_allclose(
        float(g_nonsaturating_loss(_t(fake))),
        float(jax_losses.g_nonsaturating_loss(jnp.asarray(fake))),
        rtol=1e-6)


def test_synthetic_reals_and_normalize_match_jax():
    idx = np.array([0, 7, 12345])
    ours = SyntheticDataset(24)._make(idx)
    np.testing.assert_array_equal(ours, JaxSynthetic(24)._make(idx))
    np.testing.assert_allclose(
        normalize_images(torch.from_numpy(ours)).numpy(),
        np.asarray(jax_normalize(jnp.asarray(ours))), rtol=0, atol=1e-7)
    batch = next(SyntheticDataset(8).batches(3, seed=2))
    assert batch.shape == (3, 8, 8, 3) and batch.dtype == np.uint8


@pytest.mark.parametrize("name", sorted(jax_config.PRESETS))
def test_train_presets_and_config_json_match_jax(name):
    jexp = jax_config.get_preset(name)
    ours = port_config.get_train_preset(name)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(jexp.train, f.name), f.name
    assert port_config.train_config_from_json(jexp.to_json()) == ours
    with pytest.raises(ValueError, match="unknown"):
        port_config.train_config_from_dict({"bogus": 1})


def test_lazy_adam_matches_optax(rng):
    """lr, beta1 and beta2 corrected by c = I / (I + 1), three updates with
    non-zero beta1, against optax's Adam of the JAX ``lazy_adam``."""
    w0 = rng.randn(5, 3).astype(np.float32)
    p = torch.nn.Parameter(_t(w0))
    opt = lazy_adam([p], 2e-3, 0.5, 0.99, 1e-8, 4)
    tx = jax_state.lazy_adam(2e-3, 0.5, 0.99, 1e-8, 4)
    jw = jnp.asarray(w0)
    st = tx.init(jw)
    for _ in range(3):
        g = rng.randn(5, 3).astype(np.float32)
        p.grad = _t(g)
        opt.step()
        upd, st = tx.update(jnp.asarray(g), st, jw)
        jw = jw + upd
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jw),
                               rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------
# Discriminator
# --------------------------------------------------------------------------


@pytest.mark.parametrize("variant", [
    dict(), dict(label_dim=3), dict(resolution=32, mbstd_group_size=3,
                                    mbstd_num_features=2),
    dict(d_attention=True, d_components=3)],
    ids=["uncond", "label", "res32-mbstd3x2", "d_attention"])
def test_discriminator_matches_jax(rng, variant):
    """Forward logits and the gradients wrt every parameter and the
    image, with JAX's random parameters carried by the bridge.  With
    ``d_attention`` the learned queries and a duplex attention block
    before each residual block (here 16 and 8) join the tree."""
    mcfg = dict(MICRO, **variant)
    jcfg = jax_config.ModelConfig(**mcfg)
    r, n = mcfg["resolution"], 6
    img = rng.randn(n, r, r, 3).astype(np.float32)
    label = (rng.randn(n, 3).astype(np.float32) if variant.get("label_dim")
             else None)
    jd = JaxD(jcfg)
    params = jd.init(jax.random.PRNGKey(3), jnp.asarray(img),
                     None if label is None else jnp.asarray(label))["params"]
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(4),
                                              p.shape), params)
    d = Discriminator(port_config.ModelConfig(**mcfg))
    bridge.load_flax_params(d, _flat(params))
    timg = _t(img, True)
    tlab = None if label is None else _t(label)
    logits = d(timg, tlab)
    ct = rng.randn(n, 1).astype(np.float32)
    names = [k.replace(".", "/") for k, _ in d.named_parameters()]
    grads = torch.autograd.grad(logits, [timg] + list(d.parameters()),
                                _t(ct))

    def fwd(p, x):
        return jd.apply({"params": p}, x,
                        None if label is None else jnp.asarray(label))

    ref, vjp = jax.vjp(fwd, params, jnp.asarray(img))
    _close(logits.detach(), ref, "logits")
    gp, gx = vjp(jnp.asarray(ct))
    _close(grads[0], gx, "d/dimage")
    flat = _flat(gp)
    assert set(flat) == set(names)
    if variant.get("d_attention"):
        assert {"d_queries", "b16_attn/q_x/w", "b8_attn/dup0_k_x/w"} \
            <= set(names)
    for name, g in zip(names, grads[1:]):
        _close_leaf(g, name, flat, name)


# --------------------------------------------------------------------------
# One d_step and one g_step against JAX
# --------------------------------------------------------------------------

BATCH = 4


class _NoNoiseGenerator(JaxG):
    """The JAX generator with synthesis noise off (the port runs
    ``noise_mode='none'`` on the same weights)."""

    def synthesize(self, ws, noise_mode="random"):
        return super().synthesize(ws, noise_mode="none")


# The steps are compared with the generator's attention off and on (the
# duplex preset's block with attention-routed styles).
STEP_MODELS = {"none": MICRO,
               "duplex": dict(MICRO, attention="duplex",
                              style_mode="attention")}
# Parameters after the update are held at 1e-5 of their scale.  A leaf
# that was zero before the update (a bias at init) is its update alone,
# which carries the gradient's relative error: with attention on, the
# gradient of the centroid queries' bias (``dup0_q_y/b``) is a sum over
# the grid whose cancellation leaves 2.5e-5 of relative agreement, so
# there such a leaf takes the gradient's tolerance, MODEL.
ZERO_INIT_PARAM_TOL = {"none": 1e-5, "duplex": MODEL}


def _jax_cfg(model=MICRO):
    return jax_config.ExperimentConfig(
        name="t", model=jax_config.ModelConfig(**model),
        train=jax_config.TrainConfig(batch_size=BATCH, style_mixing_prob=0.0,
                                     ema_kimg=0.01, device_time_ticks=0),
        data=jax_config.DataConfig(resolution=16), mesh=jax_config.MeshConfig())


def _perturbed_state(cfg):
    """A JAX TrainState with non-zero Adam moments (count 3), an EMA apart
    from the generator, a non-zero w_avg and step."""
    st = jax_state.create_train_state(cfg, jax.random.PRNGKey(0))
    keys = iter(jax.random.split(jax.random.PRNGKey(9), 1000))

    def noisy(tree, scale, positive=False):
        def f(p):
            r = jax.random.normal(next(keys), p.shape) * scale
            return jnp.abs(r) + scale if positive else p + r
        return jax.tree_util.tree_map(f, tree)

    def opt(o, params):
        adam = o[0]._replace(count=jnp.asarray(3, adam_count_dtype(o)),
                             mu=noisy(jax.tree_util.tree_map(
                                 jnp.zeros_like, params), 1e-2),
                             nu=noisy(params, 1e-4, positive=True))
        return (adam,) + tuple(o[1:])

    def adam_count_dtype(o):
        return o[0].count.dtype

    return st.replace(g_opt=opt(st.g_opt, st.g_params),
                      d_opt=opt(st.d_opt, st.d_params),
                      ema_params=noisy(st.g_params, 0.05),
                      w_avg=jax.random.normal(next(keys), st.w_avg.shape),
                      step=jnp.asarray(40, st.step.dtype))


@pytest.fixture(scope="module", params=sorted(STEP_MODELS))
def steps_vs_jax(request):
    model = STEP_MODELS[request.param]
    cfg = _jax_cfg(model)
    st0 = _perturbed_state(cfg)
    flat0 = bridge.flatten_train_state(jax.device_get(st0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_steps, "Generator", _NoNoiseGenerator)
        fns = jax_steps.make_train_steps(cfg, None, batch_size=BATCH)
        imgs = np.random.RandomState(0).randint(
            0, 255, (BATCH, 16, 16, 3), dtype=np.uint8)
        rng_d, rng_g = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
        st1, daux = fns.d_step(st0, jnp.asarray(imgs), rng_d)
        flat1 = bridge.flatten_train_state(jax.device_get(st1))
        st2, gaux = fns.g_step(st1, rng_g)
        flat2 = bridge.flatten_train_state(jax.device_get(st2))
    shape = (BATCH, cfg.model.num_ws, cfg.model.latent_dim)
    z_d = np.asarray(jax.random.normal(jax.random.fold_in(rng_d, 0), shape))
    z_g = np.asarray(jax.random.normal(jax.random.fold_in(rng_g, 5), shape))

    port = create_train_state(
        port_config.ModelConfig(**model),
        port_config.TrainConfig(batch_size=BATCH, style_mixing_prob=0.0,
                                ema_kimg=0.01), seed=0, device="cpu")
    bridge.load_train_state(port, flat0)
    paux = d_step(port, torch.from_numpy(imgs), 0, z=_t(z_d),
                  noise_mode="none")
    d_grads = {k.replace(".", "/"): p.grad.numpy().copy()
               for k, p in port.discriminator.named_parameters()}
    after_d = {f"d_params/{k.replace('.', '/')}": p.detach().numpy().copy()
               for k, p in port.discriminator.named_parameters()}
    paux.update(g_step(port, 0, BATCH, z=_t(z_g), noise_mode="none"))
    g_grads = {k.replace(".", "/"): p.grad.numpy().copy()
               for k, p in port.generator.named_parameters()}
    return dict(flat0=flat0, flat1=flat1, flat2=flat2, daux=daux, gaux=gaux,
                port=port, paux=paux, d_grads=d_grads, g_grads=g_grads,
                after_d=after_d,
                zero_init_tol=ZERO_INIT_PARAM_TOL[request.param])


def _close_param(got, key, after, before, zero_init_tol):
    """A parameter after the update against JAX's, at 1e-5 of its scale,
    or ``zero_init_tol`` where it was zero before the update."""
    zero = not np.any(np.asarray(before[key]))
    _close_leaf(got, key, after, key, tol=zero_init_tol if zero else 1e-5)


def test_d_step_gradients_and_update_match_jax(steps_vs_jax):
    r = steps_vs_jax
    flat1 = r["flat1"]
    for k in ("Loss/D", "Loss/scores/real", "Loss/scores/fake"):
        _close(float(r["paux"][k]), float(r["daux"][k]), k)
    assert r["d_grads"]
    mu = {k[len("d_opt/mu/"):]: v for k, v in flat1.items()
          if k.startswith("d_opt/mu/")}
    for name, g in r["d_grads"].items():
        _close_leaf(g, name, mu, f"grad {name}")
    for key, v in r["after_d"].items():
        _close_param(v, key, flat1, r["flat0"], r["zero_init_tol"])
    nu = {k.replace(".", "/"): r["port"].d_opt.state[p]["exp_avg_sq"]
          for k, p in r["port"].discriminator.named_parameters()}
    for name, v in nu.items():
        _close(v, r["flat2"][f"d_opt/nu/{name}"], f"nu {name}", tol=1e-4)


def test_g_step_gradients_update_ema_and_w_avg_match_jax(steps_vs_jax):
    r = steps_vs_jax
    flat2, port = r["flat2"], r["port"]
    _close(float(r["paux"]["Loss/G"]), float(r["gaux"]["Loss/G"]), "Loss/G")
    mu = {k[len("g_opt/mu/"):]: v for k, v in flat2.items()
          if k.startswith("g_opt/mu/")}
    for name, g in r["g_grads"].items():
        _close_leaf(g, name, mu, f"grad {name}")
    for tree, module in (("g_params", port.generator), ("ema_params",
                                                        port.ema)):
        for k, p in module.named_parameters():
            key = f"{tree}/{k.replace('.', '/')}"
            _close_param(p.detach().numpy(), key, flat2, r["flat1"],
                         r["zero_init_tol"])
    _close(port.w_avg.numpy(), flat2["w_avg"], "w_avg", tol=1e-5)
    assert port.step == int(flat2["step"]) == 40 + BATCH
    for k, p in port.generator.named_parameters():
        st = port.g_opt.state[p]
        assert int(st["step"]) == int(flat2["g_opt/count"]) == 4, k
        _close(st["exp_avg_sq"], flat2[f"g_opt/nu/{k.replace('.', '/')}"],
               f"nu {k}")


def test_train_state_bridge_round_trip_and_errors(steps_vs_jax, tmp_path):
    flat = steps_vs_jax["flat2"]
    path = str(tmp_path / "state.npz")
    bridge.save_train_state_npz(path, flat)
    back = bridge.load_train_state_npz(path)
    assert set(back) == set(flat)
    port = steps_vs_jax["port"]
    assert bridge.train_state_keys(port) == set(flat)
    missing = dict(back)
    missing.pop("d_opt/nu/head_out/b")
    with pytest.raises(ValueError, match="missing"):
        bridge.load_train_state(port, missing)
    with pytest.raises(ValueError, match="extra"):
        bridge.load_train_state(port, {**back, "g_opt/mu/extra": np.ones(1)})
    bad = {**back, "g_params/mapping/fc0/w": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="shape"):
        bridge.load_train_state(port, bad)


# --------------------------------------------------------------------------
# Port-only behaviour: the card's route, the draws, the CLI
# --------------------------------------------------------------------------


@pytest.mark.parametrize("variant", [
    dict(), dict(attention="duplex", style_mode="attention"),
    dict(attention="duplex", style_mode="attention", d_attention=True,
         d_components=3)], ids=["none", "duplex", "duplex-d_attention"])
def test_training_on_the_cards_route_launches_the_plan(card_route, variant):
    """With every launch stubbed on the card's route, one d_step and one
    g_step of a tiny config launch exactly what ``chip_smoke``'s plan says
    (the plan the smoke holds the card's counters to), the forward
    attention launches that write lse included, and every leaf gets a
    finite nonzero gradient."""
    import chip_smoke
    from gansformer_tpu_torch import ops

    model = port_config.ModelConfig(**dict(MICRO, resolution=32, **variant))
    train = port_config.TrainConfig(batch_size=2)
    st = create_train_state(model, train, seed=1, device="cpu")
    chip_smoke.perturb(st.generator)
    reals = torch.from_numpy(next(SyntheticDataset(32).batches(2)))
    plan = chip_smoke.train_path_calls(model, 2)
    for phase, step in (("d_step", lambda: d_step(st, reals, 0)),
                        ("g_step", lambda: g_step(st, 0, 2))):
        ops.reset_launch_counts()
        step()
        assert ops.launch_counts() == chip_smoke.plan_counts(plan, phase)
        assert ops.lse_launch_counts() == chip_smoke.plan_lse_counts(plan,
                                                                     phase)
    if variant:
        assert ops.launch_counts()["latent_to_grid_bwd"] > 0
    for module in (st.generator, st.discriminator):
        for name, p in module.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), name
            assert (p.grad != 0).any(), name
    for module in (st.generator, st.discriminator):
        for name, p in module.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), name
            assert (p.grad != 0).any(), name


def test_step_draws_follow_the_seed():
    model = port_config.ModelConfig(**MICRO)
    train = port_config.TrainConfig(batch_size=2, style_mixing_prob=0.5)
    a = create_train_state(model, train, seed=5, device="cpu")
    b = create_train_state(model, train, seed=5, device="cpu")
    for p, q in zip(a.generator.parameters(), b.generator.parameters()):
        assert torch.equal(p, q)
    reals = torch.from_numpy(next(SyntheticDataset(16).batches(2)))
    la = d_step(a, reals, 3, mirror_augment=True)
    lb = d_step(b, reals, 3, mirror_augment=True)
    assert float(la["Loss/D"]) == float(lb["Loss/D"])
    ga, gb = g_step(a, 3, 2), g_step(b, 3, 2)
    assert float(ga["Loss/G"]) == float(gb["Loss/G"])
    assert a.step == 2
    lc = g_step(a, 4, 2)
    assert float(lc["Loss/G"]) != float(gb["Loss/G"])


def test_train_cli_with_attention_imports_no_jax(tmp_path):
    """``cli.train --device cpu`` with the generator's attention and D
    attention on (a config.json written by the port's own dataclasses)
    leaves jax, flax and the JAX package out of sys.modules."""
    model = port_config.ModelConfig(**dict(
        MICRO, attention="duplex", style_mode="attention", d_attention=True,
        d_components=3))
    path = tmp_path / "config.json"
    path.write_text(json.dumps({
        "model": dataclasses.asdict(model),
        "train": dataclasses.asdict(port_config.TrainConfig())}))
    code = (
        "import sys\n"
        "from gansformer_tpu_torch.cli import train\n"
        f"assert train.main(['--config', {str(path)!r}, '--steps', '1', "
        "'--batch-size', '2', '--device', 'cpu']) == 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'gansformer_tpu')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Loss/G" in out.stdout


def test_train_cli_runs_two_steps_on_cpu(tmp_path):
    cfg = _jax_cfg()
    path = tmp_path / "config.json"
    path.write_text(cfg.to_json())
    out = subprocess.run(
        [sys.executable, "-m", "gansformer_tpu_torch.cli.train", "--config",
         str(path), "--steps", "2", "--batch-size", "2", "--seed", "1",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    head = json.loads(lines[0])
    assert head["model"]["resolution"] == 16 and head["device"] == "cpu"
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert len(steps) == 2 and "Loss/D" in steps[0] and "g_ms" in steps[1]
