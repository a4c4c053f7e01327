"""The serving precisions at full depth, on the CPU: the port's bf16 and
int8w synth programs err against its own f32 program no more than the JAX
package's programs err against theirs.

The depth and attention layout are ffhq256-duplex's (resolution 256,
duplex attention at 4-128, 16 components, ``style_mode='attention'``),
the widths narrow (at most 32 feature maps, w_dim 32).  The weights are
the port's random init with every noise strength and attention gate 0.1
(as the card's precision phase sets them, ``chip_smoke.perturb``) and a
non-zero ``w_avg``, carried into JAX by name.  Both sides synthesize the
same ws at psi 0.7 and 1.0 (four rows each) with the same noise: each side's
draws are replaced by one numpy table, as in
``tests/test_torch_serve_quant.py``.  JAX's programs run with
``manifest_dir=None``.

Held: f32 against JAX's f32 at ``chip_smoke.MODEL_TOL["float32"]`` (the
smoke's f32 gate: summation order through the full depth); for bf16 and int8w, at each
psi, the mean error against its own side's f32 (mean |err| / mean |f32|
over the psi's rows) at most ``chip_smoke.WITNESS_RATIO`` times JAX's.
The mean is the measure because the max is not stable at this depth: a
row's max |err| / max |row| moves by 2x between the two sides and between
rows on either side, and reaches 0.68 in JAX's own bf16 at psi 1.0.  The
card's precision phase takes the host's plain path at a precision as the
witness of what the precision itself costs; this test holds that plain
path to JAX's programs at the same depth.  ``-s`` prints both measures
of both sides; the max (``fidelity_report``'s rel_err) beside the
declared ``FIDELITY_TOLERANCES``, which hold at micro width
(``tests/test_torch_serve_quant.py``) but not for JAX's own programs
here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import chip_smoke
from gansformer_tpu.core import config as jax_config
from gansformer_tpu.serve import ServePrograms as JaxPrograms
from gansformer_tpu.serve.programs import GeneratorBundle as JaxBundle
from gansformer_tpu_torch.core import config as port_config
from gansformer_tpu_torch.models import Generator, synthesis
from gansformer_tpu_torch.models.generator import init_weights
from gansformer_tpu_torch.serve import FIDELITY_TOLERANCES, ServePrograms
from gansformer_tpu_torch.serve.programs import bundle_from_generator
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

MODEL = dict(resolution=256, components=16, latent_dim=32, w_dim=32,
             mapping_dim=32, mapping_layers=2, fmap_base=1024, fmap_max=32,
             attention="duplex", attn_max_res=128, style_mode="attention")
PSI = np.array([0.7, 1.0] * 4, np.float32)
SEEDS = np.arange(300, 308, dtype=np.int32)


@pytest.fixture(scope="module")
def bundles():
    g = init_weights(Generator(port_config.ModelConfig(**MODEL)), seed=0)
    chip_smoke.perturb(g)
    w_avg = np.random.RandomState(1).randn(32).astype(np.float32) * 0.5
    flat = {name.replace(".", "/"): p.detach().numpy().copy()
            for name, p in g.named_parameters()}
    cfg = jax_config.ExperimentConfig(
        name="t", model=jax_config.ModelConfig(**MODEL),
        train=jax_config.TrainConfig(),
        data=jax_config.DataConfig(resolution=256),
        mesh=jax_config.MeshConfig())
    jb = JaxBundle(cfg=cfg, ema_params=traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/"),
        w_avg=jnp.asarray(w_avg))
    pb = bundle_from_generator(g, torch.from_numpy(w_avg), device="cpu")
    return jb, pb


def _noise_table():
    """The draws of one forward in layer order: b4_conv, then each
    resolution's conv_up and conv."""
    rng = np.random.RandomState(5)
    res = [4] + [r for r in (8, 16, 32, 64, 128, 256) for _ in (0, 1)]
    return [rng.randn(1, r, r, 1).astype(np.float32) for r in res]


def _jax_images(jb, precision, ws):
    table, calls = _noise_table(), []

    def normal(key, shape=(), dtype=jnp.float32):
        i = len(calls)
        calls.append(shape)
        assert tuple(shape[1:]) == table[i].shape[1:], (shape, i)
        return jnp.broadcast_to(jnp.asarray(table[i], dtype), shape)

    progs = JaxPrograms(jb, buckets=(len(PSI),), manifest_dir=None,
                        serve_precision=precision)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", normal)
        out = progs.synthesize(ws, PSI, np.array([7, 11], np.uint32),
                               SEEDS.astype(np.uint32))
    assert len(calls) == len(table)
    return np.asarray(out, np.float64)


def _port_images(pb, precision, ws):
    table, seen = _noise_table(), []

    def draw(gens, res, device, dtype):
        i = len(seen)
        seen.append(res)
        assert table[i].shape[1] == res
        return torch.from_numpy(table[i]).expand(len(gens), -1, -1,
                                                 -1).to(device, dtype)

    progs = ServePrograms(pb, buckets=(len(PSI),),
                          serve_precision=precision)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(synthesis, "draw_noise", draw)
        out = progs.synthesize(torch.from_numpy(ws), PSI, seed=0)
    assert len(seen) == len(_noise_table())
    return out.double().numpy()


def test_precisions_at_full_depth_err_no_more_than_jax(bundles):
    jb, pb = bundles
    ws = np.array(JaxPrograms(jb, buckets=(len(PSI),),
                              manifest_dir=None).map_seeds(SEEDS))
    jax_img = {p: _jax_images(jb, p, ws) for p in ("f32", "bf16", "int8w")}
    port_img = {p: _port_images(pb, p, ws) for p in ("f32", "bf16", "int8w")}
    scale = float(np.abs(jax_img["f32"]).max())
    assert float(np.abs(port_img["f32"] - jax_img["f32"]).max()) <= \
        chip_smoke.MODEL_TOL["float32"] * scale
    for prec in ("bf16", "int8w"):
        for psi in (0.7, 1.0):
            rows = np.isclose(PSI, psi)
            errs = {}
            for side, img in (("JAX", jax_img), ("port", port_img)):
                err = np.abs(img[prec][rows] - img["f32"][rows])
                ref = np.abs(img["f32"][rows])
                errs[side] = (float(err.mean() / ref.mean()),
                              float(err.max() / ref.max()))
            print(f"{prec} psi {psi}: mean |err| / mean |f32| JAX "
                  f"{errs['JAX'][0]:.4e}, port {errs['port'][0]:.4e}; max "
                  f"|err| / max |f32| JAX {errs['JAX'][1]:.4e}, port "
                  f"{errs['port'][1]:.4e} (declared "
                  f"{FIDELITY_TOLERANCES[prec]})")
            assert 0.0 < errs["port"][0] <= \
                chip_smoke.WITNESS_RATIO * errs["JAX"][0], (prec, psi, errs)
