"""The port's metric samplers against the JAX package's on the CPU:
``sample_images`` and ``ppl_pairs`` against JAX's ``_sample`` and
``_ppl_pairs`` (``make_train_steps``' ``sample`` and ``ppl_pairs``) on
the micro duplex generator, its JAX weights bridged into a port state,
noise strengths at 0 so JAX's noise draws add nothing, z injected;
images at 1e-4 of their scale (the generator tests' class).  Then
``make_metric_samplers``' draws, and the shared-noise control: with noise
on, a pair with ``z0 == z1`` gives two identical images (PPL distances
exactly 0), and the same pair with unshared noise does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from gansformer_tpu.models.generator import Generator as JaxGenerator
from gansformer_tpu.train.steps import make_train_steps
from gansformer_tpu_torch.bridge import load_flax_params
from gansformer_tpu_torch.core import config as port_config
from gansformer_tpu_torch.data.dataset import SyntheticDataset
from gansformer_tpu_torch.metrics.ppl import sample_ppl_distances
from gansformer_tpu_torch.train import (create_train_state, derive_seed,
                                        make_metric_samplers, ppl_pairs,
                                        sample_images)
from tests.test_train import micro_cfg
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

EPS = 1e-2
IMG_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def bridged():
    """The micro duplex generator's JAX weights (noise strengths 0) in
    JAX's step fns and in a port train state."""
    jcfg = micro_cfg(attention="duplex", batch=4)
    pcfg = port_config.ExperimentConfig.from_json(jcfg.to_json())
    m = jcfg.model
    z = jnp.zeros((2, m.num_ws, m.latent_dim), jnp.float32)
    variables = JaxGenerator(m).init({"params": jax.random.PRNGKey(0),
                                      "noise": jax.random.PRNGKey(1)}, z)
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        variables["params"], sep="/").items()}
    strengths = [k for k in flat if k.endswith("noise_strength")]
    assert strengths
    for k in strengths:
        flat[k] = np.zeros_like(flat[k])
    w_avg = (np.random.RandomState(5).randn(m.w_dim) * 0.5).astype(
        np.float32)
    state = create_train_state(pcfg.model, pcfg.train, 0, "cpu")
    load_flax_params(state.ema, flat)
    state.w_avg.copy_(torch.from_numpy(w_avg))
    jparams = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    return dict(fns=make_train_steps(jcfg, batch_size=4), jparams=jparams,
                w_avg=w_avg, state=state, cfg=pcfg, flat=flat,
                strengths=strengths)


def _close(got, want):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy() / scale, want / scale, **IMG_TOL)


def test_samplers_match_jax(bridged):
    b = bridged
    m = b["cfg"].model
    rs = np.random.RandomState(0)
    z0, z1 = rs.randn(2, 4, m.num_ws, m.latent_dim).astype(np.float32)
    t = rs.rand(4).astype(np.float32)
    key = jax.random.PRNGKey(9)
    for psi in (1.0, 0.7):
        want = b["fns"].sample(b["jparams"], jnp.asarray(b["w_avg"]),
                               jnp.asarray(z0), key, truncation_psi=psi)
        got = sample_images(b["state"], torch.from_numpy(z0), psi,
                            noise_mode="none")
        assert tuple(got.shape) == (4, 16, 16, 3)
        _close(got, want)
    wa, wb = b["fns"].ppl_pairs(b["jparams"], jnp.asarray(z0),
                                jnp.asarray(z1), jnp.asarray(t), key, EPS)
    ga, gb = ppl_pairs(b["state"], torch.from_numpy(z0),
                       torch.from_numpy(z1), torch.from_numpy(t), EPS,
                       noise_mode="none")
    _close(ga, wa)
    _close(gb, wb)
    # the pair's images differ by the ε step alone (no truncation)
    assert float((ga - gb).abs().max()) > 0


def test_metric_samplers_draws(bridged):
    """sample_fn's k-th call is a function of (seed, k); pair_fn's of the
    pair seed; the batches have the model's shape."""
    b = bridged
    ds = SyntheticDataset(resolution=16, num_images=16)
    s1, p1 = make_metric_samplers(b["state"], b["cfg"], ds, seed=11)
    s2, p2 = make_metric_samplers(b["state"], b["cfg"], ds, seed=11)
    first, second = s1(3), s1(3)
    assert tuple(first.shape) == (3, 16, 16, 3)
    assert torch.isfinite(first).all()
    assert torch.equal(first, s2(3)) and torch.equal(second, s2(3))
    assert not torch.equal(first, second)
    t = np.linspace(0.1, 0.9, 3).astype(np.float32)
    a1, b1 = p1(3, t, 123, EPS)
    a2, b2 = p2(3, t, 123, EPS)
    assert torch.equal(a1, a2) and torch.equal(b1, b2)
    with pytest.raises(ValueError, match="lies on"):
        make_metric_samplers(b["state"], b["cfg"], ds, device="meta")


def test_ppl_pairs_share_their_noise(bridged):
    """Noise on (strengths 0.3): a pair of equal latents, each image with
    generators built from the same seeds, gives equal images and PPL
    distances of exactly 0; the same pair with the second image's noise
    from other seeds does not."""
    b = bridged
    flat = dict(b["flat"])
    for k in b["strengths"]:
        flat[k] = np.full_like(flat[k], 0.3)
    state = b["state"]
    load_flax_params(state.ema, flat)
    m = b["cfg"].model
    try:
        def pairs(shared):
            def pair_fn(n, t, seed, epsilon):
                z = torch.randn((n, m.num_ws, m.latent_dim),
                                generator=torch.Generator().manual_seed(seed))
                seeds = [derive_seed(seed, "ppl", "noise", r)
                         for r in range(n)]
                if shared:
                    return ppl_pairs(state, z, z, torch.from_numpy(t),
                                     epsilon, noise_seeds=seeds)
                a, _ = ppl_pairs(state, z, z, torch.from_numpy(t), epsilon,
                                 noise_seeds=seeds)
                _, bb = ppl_pairs(state, z, z, torch.from_numpy(t), epsilon,
                                  noise_seeds=[s + 1 for s in seeds])
                return a, bb
            return pair_fn

        def flat_features(x):
            return x.reshape(len(x), -1), None

        same = sample_ppl_distances(pairs(True), flat_features, 8, 4,
                                    epsilon=1e-4)
        assert same.shape == (8,) and (same == 0).all()
        other = sample_ppl_distances(pairs(False), flat_features, 8, 4,
                                     epsilon=1e-4)
        assert (other > 1e4).all()
    finally:
        load_flax_params(state.ema, b["flat"])
