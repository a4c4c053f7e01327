"""Op-level parity of the PyTorch port against the JAX package, on the CPU.

The same numpy inputs go through the JAX op (the XLA composite, and the
Pallas kernel in interpret mode, whole-image) and through the port's
op, which on a CPU tensor runs its kernel's plain version.  Tolerances are
``tests/tolerances.py`` ``GRAD["float32"]`` (1e-5): both sides compute in
fp32 and differ only by summation order.
"""

import jax.numpy as jnp
from jax.experimental import pallas as pl
import numpy as np
import pytest
import torch

from importlib import import_module

from gansformer_tpu.models.attention import _instance_norm as jax_instance_norm
from gansformer_tpu.ops.pallas_attention import multihead_attention_pallas
from gansformer_tpu.ops.pallas_modconv import (_poly_w4, _ref_core,
                                               _ref_full,
                                               modulated_conv2d_pallas)
from gansformer_tpu.ops.pallas_upfirdn import upfirdn2d_pallas
from gansformer_tpu_torch import ops
from gansformer_tpu_torch.models.attention import _instance_norm
from gansformer_tpu_torch.ops import modulated_conv as port_mc
from tests.reference_ops import upfirdn2d_ref
from tests.tolerances import GRAD
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

# gansformer_tpu.ops re-exports functions under its submodules' names
jax_attention = import_module("gansformer_tpu.ops.attention")
jax_fba = import_module("gansformer_tpu.ops.fused_bias_act")
jax_mc = import_module("gansformer_tpu.ops.modulated_conv")
jax_ufd = import_module("gansformer_tpu.ops.upfirdn2d")

TOL = GRAD["float32"]

UFD_CASES = [
    (1, 1, 1),
    (2, 1, (2, 1)),
    (1, 2, (1, 1)),
    (2, 2, (2, 1, 0, 3)),
    (1, 1, (-1, 2, 1, -1)),           # negative pads crop
]
# (1,3,3,1) and (1,2,1) are symmetric and would hide a missing flip; the
# last two are not.
FILTERS = {"even4": (1, 3, 3, 1), "odd3": (1, 2, 1), "ramp4": (1, 2, 3, 4),
           "asym2d": ((1, 2, 0), (0, 3, 1), (4, 0, 2))}


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, ref, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), **(tol or TOL))


@pytest.mark.parametrize("ftaps", sorted(FILTERS))
@pytest.mark.parametrize("case", UFD_CASES,
                         ids=[f"u{u}d{d}p{p}" for u, d, p in UFD_CASES])
def test_upfirdn_matches_jax(rng, case, ftaps):
    up, down, pad = case
    f = ops.setup_filter(FILTERS[ftaps])
    x = rng.randn(2, 9, 11, 5).astype(np.float32)
    got = ops.upfirdn2d(_t(x), f, up=up, down=down, pad=pad)
    ref = jax_ufd.upfirdn2d(jnp.asarray(x), f, up=up, down=down, pad=pad)
    _close(got, ref)
    _close(got, upfirdn2d_ref(x.astype(np.float64), f, up=up, down=down,
                              pad=jax_ufd._pad4(pad)))
    if ftaps == "even4":   # the Pallas kernel too (whole image, interpret)
        pal = upfirdn2d_pallas(jnp.asarray(x), f, up=up, down=down, pad=pad,
                               interpret=True)
        _close(got, pal)


@pytest.mark.parametrize("ftaps", ["even4", "asym2d"])
def test_upfirdn_crop_then_decimate_matches_oracle(rng, ftaps):
    """A negative top crop followed by down=2 against the numpy oracle
    only: JAX's XLA upfirdn2d returns unbounded values for this geometry
    on the CPU backend, so it cannot serve as the reference here."""
    f = ops.setup_filter(FILTERS[ftaps])
    x = rng.randn(2, 9, 11, 5).astype(np.float32)
    pad = (-2, 1, 0, -1)
    got = ops.upfirdn2d(_t(x), f, up=1, down=2, pad=pad)
    _close(got, upfirdn2d_ref(x.astype(np.float64), f, up=1, down=2,
                              pad=pad))


@pytest.mark.parametrize("act", ["linear", "lrelu"])
def test_upfirdn_epilogue_matches_pallas(rng, act):
    f = ops.setup_filter((1, 3, 3, 1), gain=4.0)
    x = rng.randn(2, 8, 8, 6).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    got = ops.upfirdn2d(_t(x), f, pad=(2, 1), bias=_t(b), act=act)
    ref = upfirdn2d_pallas(jnp.asarray(x), f, pad=(2, 1), bias=jnp.asarray(b),
                           act=act, interpret=True)
    _close(got, ref)


@pytest.mark.parametrize("factor", [2, 4])
def test_upsample_2d_exact_size(rng, factor):
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    got = ops.upsample_2d(_t(x), (1, 3, 3, 1), factor=factor)
    assert tuple(got.shape) == (2, 5 * factor, 7 * factor, 3)
    _close(got, jax_ufd.upsample_2d(jnp.asarray(x), (1, 3, 3, 1),
                                    factor=factor))
    _close(ops.downsample_2d(_t(x), (1, 3, 3, 1)),
           jax_ufd.downsample_2d(jnp.asarray(x), (1, 3, 3, 1)))


def test_poly_w4_layout_matches_pallas(rng):
    w = rng.randn(3, 3, 4, 5).astype(np.float32)
    np.testing.assert_array_equal(ops.poly_w4(_t(w)).numpy(),
                                  np.asarray(_poly_w4(jnp.asarray(w))))


def test_conv2d_up_path_matches_jax(rng):
    """The plain phase-major up-conv (``_conv_transpose_poly`` + blur)."""
    x = rng.randn(2, 6, 5, 4).astype(np.float32)
    w = (rng.randn(3, 3, 4, 7) * 0.3).astype(np.float32)
    _close(ops.conv2d(_t(x), _t(w), up=2),
           jax_mc.conv2d(jnp.asarray(x), jnp.asarray(w), up=2))
    _close(ops.conv2d(_t(x), _t(w)),
           jax_mc.conv2d(jnp.asarray(x), jnp.asarray(w)))


MODCONV_CASES = {
    # kind: (kernel, up, demodulate, act)
    "same3": (3, 1, True, None),
    "same3_lrelu": (3, 1, True, "lrelu"),
    "same1_linear": (1, 1, False, "linear"),
    "up2": (3, 2, True, None),
    "up2_lrelu": (3, 2, True, "lrelu"),
}


@pytest.mark.parametrize("case", sorted(MODCONV_CASES))
def test_modulated_conv_matches_jax(rng, case):
    """Whole images (the <=2-px up-conv border and the two polyphase
    layouts are where a relayout error hides) against the XLA composite
    (+ fused_bias_act) and the Pallas kernel in interpret mode."""
    k, up, demod, act = MODCONV_CASES[case]
    x = rng.randn(2, 7, 6, 8).astype(np.float32)
    w = (rng.randn(k, k, 8, 5) * 0.3).astype(np.float32)
    s = (rng.randn(2, 8) * 0.3 + 1.0).astype(np.float32)
    b = (rng.randn(5) * 0.5).astype(np.float32) if act else None
    got = ops.modulated_conv2d(_t(x), _t(w), _t(s), demodulate=demod, up=up,
                               bias=None if b is None else _t(b), act=act)
    xj, wj, sj = jnp.asarray(x), jnp.asarray(w), jnp.asarray(s)
    bj = None if b is None else jnp.asarray(b)
    ref = jax_mc.modulated_conv2d(xj, wj, sj, demodulate=demod, up=up)
    if act is not None:
        ref = jax_fba.fused_bias_act(ref, bj, act=act)
    _close(got, ref)
    # the Pallas kernel's own jnp reference on its own inputs (d computed
    # outside, poly core then the blur + epilogue)
    d = (jax_mc._demod_coeffs(wj, sj, 1e-8) if demod
         else jnp.ones((2, 5), jnp.float32))
    if up == 1:
        kind = "same3" if k == 3 else "same1"
        pref = _ref_full(xj, wj, sj, d, bj, kind, act, 0.2,
                         ops.ACTIVATIONS[act][1] if act else 1.0)
    else:
        pref = jax_mc.filter_2d(_ref_core(xj, wj, sj, d, "poly"),
                                (1, 3, 3, 1), gain=4.0)
        if act is not None:
            pref = jax_fba.fused_bias_act(pref, bj, act=act)
    _close(got, pref)
    if hasattr(pl, "Unblocked"):   # the kernel itself, in interpret mode
        pal = modulated_conv2d_pallas(xj, wj, sj, demodulate=demod, up=up,
                                      bias=bj, act=act, interpret=True)
        _close(got, pal)


def test_modconv_plain_matches_phase_major_oracle(rng):
    """The kernel-layout plain version (co-major poly weights, depth-to-
    space in the kernel) equals the independent phase-major up-conv."""
    x = rng.randn(2, 5, 4, 6).astype(np.float32)
    w = (rng.randn(3, 3, 6, 3) * 0.3).astype(np.float32)
    s = np.ones((2, 6), np.float32)
    post = np.ones((2, 12), np.float32)
    got = ops.modconv_plain(_t(x), ops.poly_w4(_t(w)), _t(s), _t(post), None,
                            "poly", None, 0.2, 1.0)
    _close(got, port_mc._conv_transpose_poly(_t(x), _t(w)))


def _heads_inputs(rng, lq, lk, d=8, dv=12):
    q = rng.randn(2, lq, d).astype(np.float32)
    k = rng.randn(2, lk, d).astype(np.float32)
    v = rng.randn(2, lk, dv).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("direction", ["grid_to_latent", "latent_to_grid"])
def test_attention_matches_jax(rng, direction, heads):
    """n = 60 is not a multiple of the Pallas block (16 here)."""
    lq, lk = (60, 5) if direction == "grid_to_latent" else (5, 60)
    q, k, v = _heads_inputs(rng, lq, lk)
    got = ops.fused_multihead_attention(_t(q), _t(k), _t(v), heads)
    ref, _ = jax_attention.multihead_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads)
    _close(got, ref)
    pal = multihead_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), heads, block_n=16,
                                     interpret=True)
    _close(got, pal)
    out, probs = ops.multihead_attention(_t(q), _t(k), _t(v), heads)
    _close(out, ref)
    _close(probs.sum(-1), np.ones(probs.shape[:-1]))


@pytest.mark.parametrize("act", sorted(ops.ACTIVATIONS))
def test_fused_bias_act_table_matches_jax(rng, act):
    x = rng.randn(3, 4, 6).astype(np.float32)
    x[0, 0, :2] = 0.0                       # lrelu/relu at exactly 0
    b = rng.randn(6).astype(np.float32)
    _close(ops.fused_bias_act(_t(x), _t(b), act=act),
           jax_fba.fused_bias_act(jnp.asarray(x), jnp.asarray(b), act=act))


def test_sinusoidal_encoding_and_instance_norm_match_jax(rng):
    np.testing.assert_array_equal(
        ops.sinusoidal_grid_encoding(5, 3, 8),
        jax_attention.sinusoidal_grid_encoding(5, 3, 8))
    x = (rng.randn(2, 30, 6) * 3.0 + 1.0).astype(np.float32)
    _close(_instance_norm(_t(x), dim=1), jax_instance_norm(jnp.asarray(x)))
