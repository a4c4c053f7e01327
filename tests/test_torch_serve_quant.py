"""The serving precisions of the PyTorch port against the JAX package, on
the CPU: int8 weight-only quantization (``serve/quant.py``), the
``resolve_weight`` seam, and the f32 / bf16 / int8w synth programs.

The JAX generator's random weights (noise strengths, attention gates and
``w_avg`` made non-zero) are carried into the port by the bridge.  Both
sides synthesize the same numpy ws and psi with the same noise: each
side's draws are replaced by one numpy table, the i-th draw of a forward
taking its i-th entry (``jax.random`` cannot be reproduced in torch).
JAX's programs run with ``manifest_dir=None``: nothing is written under
``.jax_compile_cache/``.

Tolerances, each relative to max |image| of the JAX side: f32 at
``IMG_TOL`` of ``tests/test_torch_generator.py`` (1e-4: ~20 fp32 layers of
summation order); bf16 and int8w at ``TRAIN_REORDER["bfloat16"]``
(``tests/tolerances.py``), the bf16 class: both sides round every
activation to bf16, at places that differ between XLA and torch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from gansformer_tpu.core import config as jax_config
from gansformer_tpu.serve import ServePrograms as JaxPrograms
from gansformer_tpu.serve.programs import GeneratorBundle as JaxBundle
from gansformer_tpu.serve import quant as jax_quant
from gansformer_tpu_torch import ops
from gansformer_tpu_torch.bridge import load_flax_params
from gansformer_tpu_torch.core import config as port_config
from gansformer_tpu_torch.models import Generator, synthesis
from gansformer_tpu_torch.models.layers import EqualDense, ModulatedConv
from gansformer_tpu_torch.serve import (FIDELITY_TOLERANCES,
                                        SERVE_PRECISIONS, ServePrograms,
                                        cost_report, fidelity_report,
                                        param_tree_bytes, quantize_params)
from gansformer_tpu_torch.serve import quant
from gansformer_tpu_torch.serve.programs import bundle_from_generator
from tests.test_torch_generator import IMG_TOL
from tests.tolerances import TRAIN_REORDER
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

MODEL = dict(resolution=16, components=3, latent_dim=16, w_dim=16,
             mapping_dim=16, mapping_layers=2, fmap_base=256, fmap_max=32,
             attention="duplex", attn_start_res=4, attn_max_res=8,
             style_mode="attention")
BUCKET = 4
SYNTH_TOL = {"f32": IMG_TOL["rtol"],
             "bf16": TRAIN_REORDER["bfloat16"]["rtol"],
             "int8w": TRAIN_REORDER["bfloat16"]["rtol"]}


def _jax_init_generator(cfg):
    """JAX's ``serve.init_generator(cfg, seed=0)`` with its ``G.init``
    jitted: the same random tree up to XLA's fusion of the initializers
    (about 6 s here against about 30 s op by op).  Only its weights
    matter, and both sides take them from this tree."""
    from gansformer_tpu.models.generator import Generator as JaxGenerator

    m = cfg.model
    k_g, k_noise = jax.random.split(jax.random.PRNGKey(0))
    z = jnp.zeros((2, m.num_ws, m.latent_dim), jnp.float32)
    params = jax.jit(JaxGenerator(m).init)(
        {"params": k_g, "noise": k_noise}, z)["params"]
    return JaxBundle(cfg=cfg, ema_params=params,
                     w_avg=jnp.zeros((m.w_dim,), jnp.float32))


def _jax_bundle():
    cfg = jax_config.ExperimentConfig(
        name="t", model=jax_config.ModelConfig(**MODEL),
        train=jax_config.TrainConfig(),
        data=jax_config.DataConfig(resolution=16),
        mesh=jax_config.MeshConfig())
    b = _jax_init_generator(cfg)
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        b.ema_params, sep="/").items()}
    for i, k in enumerate(sorted(flat)):
        if k.endswith(("noise_strength", "_wattn_gate")):
            flat[k] = np.asarray(0.2 + 0.05 * i, np.float32)
    w_avg = np.random.RandomState(1).randn(16).astype(np.float32) * 0.5
    params = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    return dataclasses.replace(b, ema_params=params,
                               w_avg=jnp.asarray(w_avg)), flat, w_avg


@pytest.fixture(scope="module")
def bundles():
    jb, flat, w_avg = _jax_bundle()
    g = load_flax_params(Generator(port_config.ModelConfig(**MODEL)), flat)
    return jb, flat, bundle_from_generator(g, torch.from_numpy(w_avg),
                                           device="cpu")


def _noise_table():
    """The draws of one forward at res 16 in layer order: b4_conv, then
    b8 and b16 (conv_up, conv)."""
    rng = np.random.RandomState(5)
    return [rng.randn(1, r, r, 1).astype(np.float32)
            for r in (4, 8, 8, 16, 16)]


def _jax_images(jb, precision, ws, psi):
    table = _noise_table()
    calls = []

    def normal(key, shape=(), dtype=jnp.float32):
        i = len(calls)
        calls.append(shape)
        assert tuple(shape) == table[i].shape, (shape, i)
        return jnp.asarray(table[i], dtype)

    progs = JaxPrograms(jb, buckets=(BUCKET,), manifest_dir=None,
                        serve_precision=precision)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", normal)
        out = progs.synthesize(ws, psi, np.array([7, 11], np.uint32),
                               np.arange(BUCKET, dtype=np.uint32))
    assert len(calls) == len(table)      # traced once, every draw taken
    return np.asarray(out, np.float64)


def _port_images(pb, precision, ws, psi):
    table = _noise_table()
    seen = []

    def draw(gens, res, device, dtype):
        i = len(seen) % len(table)
        seen.append(res)
        assert table[i].shape[1] == res
        return torch.from_numpy(table[i]).expand(len(gens), -1, -1,
                                                 -1).to(device, dtype)

    progs = ServePrograms(pb, buckets=(BUCKET,), serve_precision=precision)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(synthesis, "draw_noise", draw)
        out = progs.synthesize(torch.from_numpy(ws), psi, seed=0)
    assert len(seen) == len(table)
    return out.double().numpy()


def test_quantize_params_equals_jax_bit_for_bit(bundles):
    """Codes and scales of every kernel, and the untouched leaves, equal
    the JAX package's; the predicate picks the same leaves."""
    jb, flat, _ = bundles
    jq = traverse_util.flatten_dict(
        jax_quant.quantize_params(jax.device_get(jb.ema_params)), sep="/")
    pq = quantize_params(flat)
    assert set(jq) == set(pq)
    kernels = [k for k, v in pq.items() if isinstance(v, ops.QuantizedWeight)]
    assert kernels and all(k.endswith("/w") for k in kernels)
    assert "synthesis/b8_attn/dup0_k_x/w" in kernels
    assert not any(k.endswith(("/b", "const", "pos_emb", "_gate"))
                   for k in kernels)
    for k, v in pq.items():
        ref = jq[k]
        if isinstance(v, ops.QuantizedWeight):
            assert v.q.dtype == torch.int8 and v.scale.dtype == torch.float32
            assert np.array_equal(v.q.numpy(), np.asarray(ref.q)), k
            assert np.asarray(ref.q).dtype == np.int8
            assert np.array_equal(v.scale.numpy(), np.asarray(ref.scale)), k
        else:
            assert np.array_equal(np.asarray(v), np.asarray(ref)), k
    assert param_tree_bytes(pq) == jax_quant.param_tree_bytes(
        jax_quant.quantize_params(jb.ema_params))


def test_dequant_round_trip_within_half_a_step_and_deterministic(rng):
    """|dequant(q) - w| <= scale / 2 per output channel, exact at the
    channel's extreme; an all-zero channel dequantizes to zero exactly
    (scale 1); quantizing twice gives the same bits."""
    w = rng.randn(3, 3, 8, 6).astype(np.float32)
    w[..., 2] = 0.0
    qw = quant.quantize_leaf(w)
    again = quant.quantize_leaf(w)
    assert torch.equal(qw.q, again.q) and torch.equal(qw.scale, again.scale)
    assert tuple(qw.scale.shape) == (1, 1, 1, 6)
    deq = ops.resolve_weight(qw).numpy()
    step = qw.scale.numpy()
    assert np.all(np.abs(deq - w) <= step / 2 + 1e-7)
    assert qw.scale[..., 2].item() == 1.0 and not deq[..., 2].any()
    amax = np.abs(w).max(axis=(0, 1, 2))
    np.testing.assert_allclose(np.abs(deq).max(axis=(0, 1, 2)), amax,
                               rtol=1e-6)
    dense = quant.quantize_leaf(rng.randn(5, 7).astype(np.float32))
    assert tuple(dense.scale.shape) == (1, 7)


def test_resolve_weight_is_an_fp32_island_in_a_bf16_layer(rng):
    """A bf16 layer's int8 kernel dequantizes in fp32 (codes times scales
    are not rounded to bf16 first), then takes the coefficient and the
    cast, as JAX orders it; a plain kernel passes through."""
    layer = EqualDense(8, 4, dtype=torch.bfloat16)
    w = torch.from_numpy(rng.randn(8, 4).astype(np.float32))
    with torch.no_grad():
        layer.w.copy_(w)
        layer.b.zero_()
    assert ops.resolve_weight(layer.w) is layer.w
    quant.quantize_module(layer)
    assert isinstance(layer.w, ops.QuantizedWeight)
    assert "w" not in dict(layer.named_parameters())
    deq = ops.resolve_weight(layer.w)
    assert deq.dtype == torch.float32
    exact = layer.w.q.double() * layer.w.scale.double()
    assert torch.equal(deq, exact.float())     # one rounding, to fp32
    rounded_first = (layer.w.q.to(torch.bfloat16)
                     * layer.w.scale.to(torch.bfloat16)).float()
    assert not torch.equal(deq, rounded_first)
    x = torch.from_numpy(rng.randn(2, 8).astype(np.float32))
    want = ops.fused_bias_act(
        x.to(torch.bfloat16) @ (deq / np.sqrt(8)).to(torch.bfloat16),
        layer.b, act="linear")
    assert torch.equal(layer(x), want)


@pytest.mark.parametrize("precision", SERVE_PRECISIONS)
def test_synth_matches_jax_programs(bundles, precision):
    """The port's synth program of each precision against JAX's
    ``ServePrograms(serve_precision=...)``: the same ws, psi and noise."""
    jb, _, pb = bundles
    rng = np.random.RandomState(3)
    ws = rng.randn(BUCKET, jb.cfg.model.num_ws, 16).astype(np.float32)
    psi = np.array([0.7, 1.0, 0.5, 0.3], np.float32)
    ref = _jax_images(jb, precision, ws, psi)
    got = _port_images(pb, precision, ws, psi)
    assert got.shape == ref.shape == (BUCKET, 16, 16, 3)
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max()) / scale
    assert err <= SYNTH_TOL[precision], (precision, err)
    if precision != "f32":
        # the precision is live: its images differ from f32's
        f32 = _port_images(pb, "f32", ws, psi)
        assert float(np.abs(got - f32).max()) > 1e-4 * scale


def test_precisions_launch_and_run_what_they_say(bundles):
    """f32 is the bundle's own generator; bf16 a bf16 copy on the same
    fp32 weights; int8w that copy with every kernel quantized; the
    mapping runs on the bundle's weights at every precision."""
    _, _, pb = bundles
    f32 = ServePrograms(pb, serve_precision="f32")
    bf16 = ServePrograms(pb, serve_precision="bf16")
    int8w = ServePrograms(pb, serve_precision="int8w")
    assert f32.synth_module is pb.generator
    assert bf16.synth_module.synthesis.dtype == torch.bfloat16
    layers = [m for m in int8w.synth_module.modules()
              if isinstance(m, (EqualDense, ModulatedConv))]
    assert layers and {type(m.w) for m in layers} == {ops.QuantizedWeight}
    assert torch.equal(f32.map_seeds([3, 4]), int8w.map_seeds([3, 4]))
    with pytest.raises(ValueError, match="serve_precision"):
        ServePrograms(pb, serve_precision="fp8")


def test_int8w_bytes_at_least_3x_lower_and_as_jax_counts(bundles):
    jb, _, pb = bundles
    got = {p: param_tree_bytes(ServePrograms(
        pb, serve_precision=p).synth_module) for p in SERVE_PRECISIONS}
    want = jax_quant.param_tree_bytes(jb.ema_params)
    assert got["f32"] == got["bf16"] == want
    assert got["int8w"] == jax_quant.param_tree_bytes(
        jax_quant.quantize_params(jb.ema_params))
    assert got["f32"] >= 3 * got["int8w"]
    rep = cost_report(pb, bucket=2)["per_precision"]
    assert rep["int8w"]["tree_bytes_ratio_vs_f32"] >= 3.0
    assert rep["f32"]["params_tree_bytes"] == got["f32"]
    for rec in rep.values():      # no torch counterpart / off the card
        assert rec["flops_per_image"] is None and rec["peak_bytes"] is None


@pytest.mark.parametrize("precision", SERVE_PRECISIONS)
def test_fidelity_report_within_tolerance(bundles, precision):
    _, _, pb = bundles
    rep = fidelity_report(pb, precision, bucket=BUCKET)
    assert rep["tolerance"] == FIDELITY_TOLERANCES[precision]
    assert rep["ok"], rep
    if precision == "f32":
        assert rep["rel_err"] == 0.0
    else:
        assert rep["rel_err"] > 0.0
    assert FIDELITY_TOLERANCES == jax_quant.FIDELITY_TOLERANCES
