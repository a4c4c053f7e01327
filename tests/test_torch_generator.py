"""Whole-slice parity: JAX ``Generator`` weights bridged into the PyTorch
port give the same mapping output, truncation and images on the CPU.

Config: ``TINY`` of tests/test_models.py (res 32, duplex) in both style
modes, plus variants covering the other attention options.  Every
``noise_strength`` and ``*_wattn_gate`` is set non-zero so neither is
trivially off; both sides run ``noise_mode='none'`` in fp32 (the noise
streams of ``jax.random`` and torch cannot be matched).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from gansformer_tpu.models.generator import Generator as JaxGenerator
from gansformer_tpu.train.steps import apply_truncation as jax_truncation
from gansformer_tpu_torch.bridge import load_flax_params
from gansformer_tpu_torch.core.config import ModelConfig
from gansformer_tpu_torch.models import Generator, apply_truncation
from tests.test_models import TINY
from tests.tolerances import GRAD

VARIANTS = {
    "attention": dict(style_mode="attention"),
    "global": dict(style_mode="global"),
    "simplex_add_learned_fusedkv": dict(
        attention="simplex", integration="add", pos_encoding="learned",
        attn_fused_kv=True, style_mode="attention"),
    "duplex_mul_nopos_2heads_2iters": dict(
        integration="mul", pos_encoding="none", num_heads=2, kmeans_iters=2,
        use_global=False),
}

# Images pass ~20 layers of fp32 convs, attention and instance norms;
# summation-order differences between XLA and torch compound to ~1e-5 of
# the image scale, so the image tolerance is one order above GRAD.
IMG_TOL = dict(atol=1e-4, rtol=1e-4)


def _jax_params(cfg, seed=0):
    z = jnp.zeros((2, cfg.num_ws, cfg.latent_dim), jnp.float32)
    variables = JaxGenerator(cfg).init(
        {"params": jax.random.PRNGKey(seed),
         "noise": jax.random.PRNGKey(seed + 1)}, z)
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        variables["params"], sep="/").items()}
    gates = sorted(k for k in flat if k.endswith("noise_strength")
                   or k.endswith("_wattn_gate"))
    for i, k in enumerate(gates):
        flat[k] = np.asarray(0.2 + 0.05 * i, np.float32)
    return flat, gates


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_generator_matches_jax(rng, variant):
    jcfg = dataclasses.replace(TINY, **VARIANTS[variant])
    pcfg = ModelConfig.from_dict(dataclasses.asdict(jcfg))
    flat, gates = _jax_params(jcfg)
    assert any(k.endswith("noise_strength") for k in gates)
    if jcfg.style_mode == "attention":
        assert any(k.endswith("_wattn_gate") for k in gates)
    jparams = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    g = load_flax_params(Generator(pcfg), flat).eval()

    z = rng.randn(2, jcfg.num_ws, jcfg.latent_dim).astype(np.float32)
    w_avg = (rng.randn(jcfg.w_dim) * 0.5).astype(np.float32)
    jg = JaxGenerator(jcfg)
    ws_j = jg.apply({"params": jparams}, jnp.asarray(z),
                    method=JaxGenerator.map)
    with torch.no_grad():
        ws_p = g.map(torch.from_numpy(z))
        np.testing.assert_allclose(ws_p.numpy(), np.asarray(ws_j),
                                   **GRAD["float32"])
        tr_p = apply_truncation(ws_p, torch.from_numpy(w_avg), 0.7)
        tr_j = jax_truncation(ws_j, jnp.asarray(w_avg), 0.7)
        np.testing.assert_allclose(tr_p.numpy(), np.asarray(tr_j),
                                   **GRAD["float32"])
        img_p = g(torch.from_numpy(z), noise_mode="none",
                  truncation_psi=0.7, w_avg=torch.from_numpy(w_avg))
    img_j = jg.apply({"params": jparams}, jnp.asarray(z), noise_mode="none",
                     truncation_psi=0.7, w_avg=jnp.asarray(w_avg))
    assert tuple(img_p.shape) == (2, 32, 32, 3)
    scale = float(np.abs(np.asarray(img_j)).max())
    np.testing.assert_allclose(img_p.numpy() / scale,
                               np.asarray(img_j) / scale, **IMG_TOL)
