"""The weight bridge and the config copy of the PyTorch port, on the CPU.

The bridge is checked at full structure: the ffhq256-duplex generator's
flax tree comes from ``jax.eval_shape`` (no compute) and the port's
modules are built on the ``meta`` device (no memory), so every leaf is
held to its name and shape at the real width.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from gansformer_tpu.core import config as jax_config
from gansformer_tpu.models.generator import Generator as JaxGenerator
from gansformer_tpu_torch.bridge import (check_structure, flatten_params,
                                         load_flax_params, load_params_npz,
                                         param_shapes)
from gansformer_tpu_torch.core import config as port_config
from gansformer_tpu_torch.models import Generator
from tests.torch_threads import one_thread  # noqa: F401  (autouse)


def _abstract_params(cfg):
    z = jnp.zeros((2, cfg.num_ws, cfg.latent_dim), jnp.float32)
    variables = jax.eval_shape(
        lambda k: JaxGenerator(cfg).init({"params": k, "noise": k}, z),
        jax.random.PRNGKey(0))
    return traverse_util.flatten_dict(variables["params"], sep="/")


def test_bridge_covers_every_ffhq256_duplex_leaf():
    jcfg = jax_config.get_preset("ffhq256-duplex").model
    flat = _abstract_params(jcfg)
    with torch.device("meta"):
        g = Generator(port_config.get_preset("ffhq256-duplex"))
    check_structure(g, flat)              # raises on any difference
    shapes = param_shapes(g)
    assert set(shapes) == set(flat)
    for name in ("synthesis/b8_conv_up/affine/w", "synthesis/b16_attn/"
                 "dup0_k_x/w", "synthesis/b16_wattn_gate", "mapping/fc7/b",
                 "synthesis/b256_trgb/w"):
        assert shapes[name] == tuple(flat[name].shape), name
    n_params = sum(int(np.prod(s)) for s in shapes.values())
    assert n_params > 20_000_000          # the real width, not a toy


def test_bridge_raises_on_missing_extra_or_misshapen_leaf(rng):
    cfg = port_config.ModelConfig(
        resolution=8, components=2, latent_dim=8, w_dim=8, mapping_dim=8,
        mapping_layers=1, fmap_base=64, fmap_max=16, attn_max_res=4)
    g = Generator(cfg)
    flat = {k: np.asarray(rng.randn(*s), np.float32)
            for k, s in param_shapes(g).items()}
    load_flax_params(g, flat)
    np.testing.assert_array_equal(g.mapping.fc0.w.detach().numpy(),
                                  flat["mapping/fc0/w"])
    nested = traverse_util.unflatten_dict(flat, sep="/")
    assert flatten_params({"params": nested}).keys() == flat.keys()
    missing = dict(flat)
    missing.pop("mapping/fc0/b")
    with pytest.raises(ValueError, match="missing"):
        load_flax_params(g, missing)
    with pytest.raises(ValueError, match="extra"):
        load_flax_params(g, {**flat, "mapping/fc9/w": np.zeros((8, 8))})
    bad = {**flat, "mapping/fc0/w": np.zeros((3, 3), np.float32)}
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(g, bad)


def test_params_npz_round_trip(tmp_path, rng):
    flat = {"mapping/fc0/w": rng.randn(4, 3).astype(np.float32),
            "w_avg": rng.randn(3).astype(np.float32)}
    path = tmp_path / "g.npz"
    np.savez(path, **flat)
    params, w_avg = load_params_npz(str(path))
    assert set(params) == {"mapping/fc0/w"}
    np.testing.assert_array_equal(w_avg, flat["w_avg"])


@pytest.mark.parametrize("name", sorted(jax_config.PRESETS))
def test_presets_and_config_json_match_jax(name):
    jexp = jax_config.get_preset(name)
    assert dataclasses.asdict(port_config.get_preset(name)) == \
        dataclasses.asdict(jexp.model)
    pcfg = port_config.model_config_from_json(jexp.to_json())
    assert pcfg == port_config.get_preset(name)
    for res in (4, 32, 256):
        assert pcfg.nf(res) == jexp.model.nf(res)
    assert pcfg.block_resolutions == jexp.model.block_resolutions
    assert pcfg.attn_resolutions() == jexp.model.attn_resolutions()
    assert pcfg.num_ws == jexp.model.num_ws
    with pytest.raises(ValueError, match="unknown"):
        port_config.ModelConfig.from_dict(
            {**json.loads(jexp.to_json())["model"], "bogus": 1})
