"""Backward of the PyTorch port's kernel ops against the JAX package, on
the CPU.

``ModconvCore`` and ``UpfirdnFunction`` run their plain backward here (a
CPU tensor routes every launch to its plain version).  The same numpy
inputs and cotangent go through ``jax.vjp`` of the JAX op: the modconv
Pallas kernel's jnp reference (``_ref_full``; ``pl.Unblocked`` is missing
from the installed Pallas, so the kernel cannot run in interpret mode)
and the XLA composite, and the upfirdn Pallas kernel in interpret mode.
Tolerance: ``tests/tolerances.py`` ``GRAD["float32"]`` (1e-5), both
sides fp32 and differing only by summation order.  The plain backward is
also held to autograd of the plain forward, so the card's oracle is
itself right.  Last, the repair of the graph-less launch: with
``kernel_route`` made to report the card and the launches stubbed, a
grad-requiring input goes through the Functions, the attention ops
included.
"""

from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gansformer_tpu.ops.pallas_modconv import (_POLY_ROW_SRC as JAX_ROW_SRC,
                                               _poly_dw_fold as jax_dw_fold,
                                               _prep_adjoint as jax_adjoint,
                                               _ref_full,
                                               _space_to_depth as jax_s2d)
from gansformer_tpu.ops.pallas_upfirdn import grad_pad4 as jax_grad_pad4
from gansformer_tpu.ops.pallas_upfirdn import upfirdn2d_pallas
from gansformer_tpu_torch import ops
from gansformer_tpu_torch.ops import cuda_attention, cuda_modconv, \
    cuda_upfirdn
from gansformer_tpu_torch.ops import modulated_conv as port_mc
from gansformer_tpu_torch.ops.attention import (attention_bwd_own_lse_plain,
                                                attention_bwd_plain,
                                                attention_fwd_stats_plain,
                                                attention_plain)
from tests.tolerances import GRAD
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

jax_mc = import_module("gansformer_tpu.ops.modulated_conv")
jax_fba = import_module("gansformer_tpu.ops.fused_bias_act")
port_ufd = import_module("gansformer_tpu_torch.ops.upfirdn2d")

TOL = GRAD["float32"]


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a, np.float32))
    return t.requires_grad_(grad)


def _close(got, ref, err_msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), err_msg=err_msg,
                               **TOL)


# kind, activation: the three kernel kinds, bare and with the epilogue
MC_CASES = [("same3", None), ("same3", "lrelu"), ("same3", "linear"),
            ("same1", None), ("same1", "linear"), ("poly", None)]


def _mc_inputs(rng, kind, act, n=2, h=6, w=5, ci=8, co=6):
    ks = 1 if kind == "same1" else 3
    up = 2 if kind == "poly" else 1
    x = rng.randn(n, h, w, ci).astype(np.float32)
    wt = (rng.randn(ks, ks, ci, co) * 0.3).astype(np.float32)
    s = (rng.randn(n, ci) * 0.3 + 1.0).astype(np.float32)
    d = (rng.rand(n, co) + 0.5).astype(np.float32)
    b = (rng.randn(co) * 0.5).astype(np.float32) if act else None
    ct = rng.randn(n, up * h, up * w, co).astype(np.float32)
    return x, wt, s, d, b, ct


@pytest.mark.parametrize("kind,act", MC_CASES,
                         ids=[f"{k}-{a}" for k, a in MC_CASES])
def test_modconv_core_grads_match_pallas_reference(rng, kind, act):
    """dx, dw, ds, dd, db of ``ModconvCore`` (act' recovered from the
    saved output, dd from the recovered pre-demod conv, dx/ds and dw by
    the kernels' plain versions) against ``jax.vjp`` of ``_ref_full``."""
    x, w, s, d, b, ct = _mc_inputs(rng, kind, act)
    gain = ops.ACTIVATIONS[act][1] if act else 1.0
    ins = [_t(x, True), _t(w, True), _t(s, True), _t(d, True)]
    tb = _t(b, True) if act else None
    y = port_mc.ModconvCore.apply(*ins, tb, kind, act, 0.2, gain)
    assert type(y.grad_fn).__name__ == "ModconvCoreBackward"
    grads = torch.autograd.grad(y, ins + ([tb] if act else []), _t(ct))
    bj = jnp.asarray(b if act else np.zeros(w.shape[3], np.float32))
    ref, vjp = jax.vjp(
        lambda *a: _ref_full(*a, kind, act, 0.2, gain),
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), jnp.asarray(d), bj)
    _close(y.detach(), ref, "y")
    refs = vjp(jnp.asarray(ct))
    for name, g, r in zip(("dx", "dw", "ds", "dd", "db"), grads, refs):
        _close(g, r, name)


UP_CASES = {"same3": (3, 1, None), "same3_lrelu": (3, 1, "lrelu"),
            "same1_linear": (1, 1, "linear"), "up2": (3, 2, None),
            "up2_lrelu": (3, 2, "lrelu")}


def _opaque(fn):
    """A launch stub's body: the plain version's result with no graph
    attached, as a ctypes launch returns it, so a term autograd could
    only reach through the stub's own graph is lost here as it would be
    on the card."""
    def run(*a, **kw):
        with torch.no_grad():
            return fn(*a, **kw)
    return run


class _Stubs:
    """Launch stubs: the plain versions, counted on the real counters, so
    CPU tensors take the card's route.  Their results carry no graph
    (``_opaque``)."""

    @staticmethod
    @_opaque
    def modconv(x, ws, s, post, bias, kind, act, alpha, gain,
                second_order=False):
        cuda_modconv.launches += 1
        cuda_modconv.launches_second_order += second_order
        return port_mc.modconv_plain(x, ws, s, post, bias, kind, act, alpha,
                                     gain)

    @staticmethod
    @_opaque
    def dx(du4, wT, pre, post, x, taps, second_order=False):
        cuda_modconv.launches_dx += 1
        cuda_modconv.launches_second_order += second_order
        return port_mc.modconv_dx_plain(du4, wT, pre, post, x, taps)

    @staticmethod
    @_opaque
    def dw(x, du4, s, pre, taps, second_order=False):
        cuda_modconv.launches_dw += 1
        cuda_modconv.launches_second_order += second_order
        return port_mc.modconv_dw_plain(x, du4, s, pre, taps)

    @staticmethod
    @_opaque
    def upfirdn(x, f, up, down, pads, bias, act, alpha, gain,
                second_order=False):
        cuda_upfirdn.launches += 1
        cuda_upfirdn.launches_second_order += second_order
        return port_ufd.upfirdn2d_plain(x, f, up, down, pads, bias, act,
                                        alpha, gain)

    @staticmethod
    @_opaque
    def adjoint(ct, f, up, down, pads):
        cuda_upfirdn.launches_adjoint += 1
        return port_ufd.upfirdn2d_plain(ct, f, up, down, pads)

    @staticmethod
    @_opaque
    def _attention(q, k, v, with_stats, direction):
        setattr(cuda_attention, f"launches_{direction}",
                getattr(cuda_attention, f"launches_{direction}") + 1)
        if not with_stats:
            return attention_plain(q, k, v)
        setattr(cuda_attention, f"launches_{direction}_lse",
                getattr(cuda_attention, f"launches_{direction}_lse") + 1)
        return attention_fwd_stats_plain(q, k, v)

    @staticmethod
    def g2l(q, k, v, with_stats=False):
        return _Stubs._attention(q, k, v, with_stats, "g2l")

    @staticmethod
    def l2g(q, k, v, with_stats=False):
        return _Stubs._attention(q, k, v, with_stats, "l2g")

    @staticmethod
    @_opaque
    def g2l_bwd(q, k, v, do):
        cuda_attention.launches_g2l_bwd += 1
        return attention_bwd_own_lse_plain(q, k, v, do)

    @staticmethod
    @_opaque
    def l2g_bwd(q, k, v, lse, do, delta):
        cuda_attention.launches_l2g_bwd += 1
        return attention_bwd_plain(q, k, v, lse, do, delta)


def patch_card_route(monkeypatch):
    """Make ``kernel_route`` report the card and stub every launch."""
    for mod in (port_mc, port_ufd, cuda_attention):
        monkeypatch.setattr(mod, "kernel_route", lambda t: True)
    monkeypatch.setattr(cuda_modconv, "modconv_cuda", _Stubs.modconv)
    monkeypatch.setattr(cuda_modconv, "modconv_dx_cuda", _Stubs.dx)
    monkeypatch.setattr(cuda_modconv, "modconv_dw_cuda", _Stubs.dw)
    monkeypatch.setattr(cuda_upfirdn, "upfirdn2d_cuda", _Stubs.upfirdn)
    monkeypatch.setattr(cuda_upfirdn, "upfirdn2d_adjoint_cuda",
                        _Stubs.adjoint)
    monkeypatch.setattr(cuda_attention, "grid_to_latent_cuda", _Stubs.g2l)
    monkeypatch.setattr(cuda_attention, "latent_to_grid_cuda", _Stubs.l2g)
    monkeypatch.setattr(cuda_attention, "grid_to_latent_bwd_cuda",
                        _Stubs.g2l_bwd)
    monkeypatch.setattr(cuda_attention, "latent_to_grid_bwd_cuda",
                        _Stubs.l2g_bwd)


@pytest.fixture
def card_route(monkeypatch):
    """``kernel_route`` reports the card and every launch is a stub."""
    patch_card_route(monkeypatch)
    ops.reset_launch_counts()
    yield
    ops.reset_launch_counts()


@pytest.mark.parametrize("case", sorted(UP_CASES))
def test_modulated_conv_function_route_matches_xla_grads(rng, card_route,
                                                         case):
    """The whole op on the card's route (demod einsum by autograd, core
    and blur through the Functions) against ``jax.vjp`` of the XLA
    ``modulated_conv2d`` + ``fused_bias_act``, wrt x, w, styles, bias."""
    k, up, act = UP_CASES[case]
    x = rng.randn(2, 6, 5, 8).astype(np.float32)
    w = (rng.randn(k, k, 8, 6) * 0.3).astype(np.float32)
    s = (rng.randn(2, 8) * 0.3 + 1.0).astype(np.float32)
    b = (rng.randn(6) * 0.5).astype(np.float32)
    demod = k == 3
    ins = [_t(x, True), _t(w, True), _t(s, True)] + ([_t(b, True)]
                                                     if act else [])
    y = ops.modulated_conv2d(*ins[:3], demodulate=demod, up=up,
                             bias=ins[3] if act else None, act=act)
    ct = rng.randn(*y.shape).astype(np.float32)
    grads = torch.autograd.grad(y, ins, _t(ct))

    def ref_fn(xj, wj, sj, bj):
        r = jax_mc.modulated_conv2d(xj, wj, sj, demodulate=demod, up=up)
        return jax_fba.fused_bias_act(r, bj, act=act) if act else r

    ref, vjp = jax.vjp(ref_fn, jnp.asarray(x), jnp.asarray(w),
                       jnp.asarray(s), jnp.asarray(b))
    _close(y.detach(), ref, "y")
    refs = vjp(jnp.asarray(ct))
    for name, g, r in zip(("dx", "dw", "ds", "db"), grads, refs):
        _close(g, r, name)
    counts = ops.launch_counts()
    assert counts["modconv"] == 1 and counts["modconv_dx"] == 1 \
        and counts["modconv_dw"] == 1
    assert counts["upfirdn"] == counts["upfirdn_adjoint"] == (up == 2)


# (up, down, pad): the path's blur (pad 2/1), the skip upsample, the
# decimated skip and D's pad-2 blur-pool
UFD_CASES = {"blur": (1, 1, (2, 1)), "up2": (2, 1, (2, 1)),
             "down2": (1, 2, (1, 1)), "blurpool": (1, 1, (2, 2))}


@pytest.mark.parametrize("act", [None, "linear", "lrelu"])
@pytest.mark.parametrize("case", sorted(UFD_CASES))
def test_upfirdn_function_grads_match_pallas(rng, case, act):
    """dx (and db with the epilogue) of ``UpfirdnFunction`` against
    ``jax.vjp`` of ``upfirdn2d_pallas`` in interpret mode, whole image."""
    up, down, pad = UFD_CASES[case]
    f = ops.setup_filter((1, 3, 3, 1), gain=float(up * up))
    x = rng.randn(2, 9, 11, 4).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    pads = port_ufd.pad4(pad)
    gain = ops.ACTIVATIONS[act][1] if act else 1.0
    ins = [_t(x, True)] + ([_t(b, True)] if act else [])
    y = port_ufd.UpfirdnFunction.apply(ins[0], ins[1] if act else None, f,
                                       up, down, pads, act, 0.2, gain)
    ct = rng.randn(*y.shape).astype(np.float32)
    grads = torch.autograd.grad(y, ins, _t(ct))
    if act:
        ref, vjp = jax.vjp(lambda xj, bj: upfirdn2d_pallas(
            xj, f, up=up, down=down, pad=pad, bias=bj, act=act,
            interpret=True), jnp.asarray(x), jnp.asarray(b))
    else:
        ref, vjp = jax.vjp(lambda xj: upfirdn2d_pallas(
            xj, f, up=up, down=down, pad=pad, interpret=True),
            jnp.asarray(x))
    _close(y.detach(), ref, "y")
    for name, g, r in zip(("dx", "db"), grads, vjp(jnp.asarray(ct))):
        _close(g, r, name)
    assert tuple(grads[0].shape) == x.shape


def _finds(fn, name: str) -> bool:
    """True when the graph below ``fn`` holds a node of type ``name``."""
    seen, todo = set(), [fn]
    while todo:
        f = todo.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        if type(f).__name__ == name:
            return True
        todo += [g for g, _ in f.next_functions]
    return False


@pytest.mark.parametrize("case", sorted(UFD_CASES))
def test_grad_pad4_matches_jax(case):
    up, down, pad = UFD_CASES[case]
    pads = port_ufd.pad4(pad)
    for h, w in ((9, 11), (8, 8), (4, 4)):
        assert port_ufd.grad_pad4(h, w, 4, 4, up, down, pads) == \
            jax_grad_pad4(h, w, 4, 4, up, down, pads)


def test_backward_layouts_match_jax(rng):
    """``_space_to_depth``, ``_poly_dw_fold`` (+ its row map) and
    ``_prep_adjoint`` are copies of the JAX functions, element for
    element."""
    du = rng.randn(2, 6, 8, 5).astype(np.float32)
    np.testing.assert_array_equal(port_mc._space_to_depth(_t(du)).numpy(),
                                  np.asarray(jax_s2d(jnp.asarray(du))))
    dw4 = rng.randn(4, 3, 5 * 4).astype(np.float32)
    np.testing.assert_array_equal(
        port_mc._poly_dw_fold(_t(dw4), 3, 5).numpy(),
        np.asarray(jax_dw_fold(jnp.asarray(dw4), 3, 5)))
    assert port_mc._POLY_ROW_SRC == JAX_ROW_SRC
    for kind, k in (("same3", 3), ("same1", 1), ("poly", 3)):
        w = rng.randn(k, k, 3, 5).astype(np.float32)
        offs, pads, wT = port_mc._prep_adjoint(kind, _t(w))
        joffs, jpads, jwT = jax_adjoint(kind, jnp.asarray(w))
        assert offs == tuple(joffs) and pads == tuple(jpads), kind
        np.testing.assert_array_equal(wT.numpy(), np.asarray(jwT))


@pytest.mark.parametrize("kind", ["same3", "same1", "poly"])
def test_plain_backward_is_autograd_of_plain_forward(rng, kind):
    """The oracle of kernels 5 and 6: ``modconv_dx_plain`` and
    ``modconv_dw_plain`` (taps, the adjoint's flip, the phase fold) give
    autograd's gradient of ``modconv_plain``, the forward kernel's plain
    version, on the kernels' own stacked inputs."""
    x, w, s, d, _, ct = _mc_inputs(rng, kind, None)
    tx, ts = _t(x, True), _t(s, True)
    tw = _t(w, True)
    post = port_mc._post(kind, _t(d))
    y = port_mc.modconv_plain(tx, port_mc.stack_weights(kind, tw), ts, post,
                              None, kind, None, 0.2, 1.0)
    gx, gw, gs = torch.autograd.grad(y, [tx, tw, ts], _t(ct))
    du4 = port_mc._space_to_depth(_t(ct)) if kind == "poly" else _t(ct)
    _, _, wT = port_mc._prep_adjoint(kind, _t(w))
    dx, ds = port_mc.modconv_dx_plain(du4, wT, post, _t(s), _t(x),
                                      port_mc.adjoint_taps(kind))
    dwt = port_mc.modconv_dw_plain(_t(x), du4, _t(s), post,
                                   cuda_modconv.TAPS[kind])
    dw = (port_mc._poly_dw_fold(dwt, 8, 6) if kind == "poly"
          else dwt.reshape(w.shape))
    for name, got, ref in (("dx", dx, gx), ("ds", ds, gs), ("dw", dw, gw)):
        _close(got, ref, name)
    per = port_mc.modconv_dw_per_sample(_t(x), du4, _t(s), post,
                                        cuda_modconv.TAPS[kind])
    _close(per.sum(0), dwt, "per-sample terms")


@pytest.mark.parametrize("act", [None, "lrelu"])
def test_upfirdn_adjoint_plain_is_autograd(rng, act):
    f = ops.setup_filter((1, 2, 3, 4))               # asymmetric
    for up, down, pad in UFD_CASES.values():
        pads = port_ufd.pad4(pad)
        x = _t(rng.randn(2, 8, 7, 3), True)
        y = port_ufd.upfirdn2d_plain(x, f, up, down, pads)
        ct = _t(rng.randn(*y.shape))
        (gx,) = torch.autograd.grad(y, [x], ct)
        got = port_ufd.upfirdn2d_adjoint_plain(ct, f, up, down, pads, (8, 7))
        _close(got, gx, f"{up}/{down}/{pad}")
        bad = port_ufd.upfirdn2d_adjoint_plain(ct, f, up, down, pads, (8, 7),
                                               flip=False)
        assert float((bad - gx).abs().max()) > 1e-2   # the planted fault


def test_graph_repair_kernel_ops_build_their_graph(rng, card_route):
    """On the card's route a grad-requiring input gets a ``grad_fn`` from
    the Functions (never a bare launch), the backward launches the dx/ds,
    dw and adjoint kernels, a second derivative through ``ModconvCore``
    launches kernels 1, 5 and 6 as its second order, and the attention
    ops, in both directions, build their graph through their Functions
    and launch their backward."""
    x = _t(rng.randn(2, 4, 4, 8), True)
    w = _t(rng.randn(3, 3, 8, 8) * 0.3, True)
    s = _t(rng.randn(2, 8) * 0.3 + 1.0, True)
    y = ops.modulated_conv2d(x, w, s, up=2, bias=_t(np.zeros(8)),
                             act="lrelu")
    assert type(y.grad_fn).__name__ == "UpfirdnFunctionBackward"
    z = ops.modulated_conv2d(x, w, s)
    assert type(z.grad_fn).__name__ == "ModconvCoreBackward"
    torch.autograd.grad((y.sum() + z.sum()), [x, w, s])
    assert ops.launch_counts() == {
        "modconv": 2, "upfirdn": 1, "grid_to_latent": 0,
        "latent_to_grid": 0, "modconv_dx": 2, "modconv_dw": 2,
        "upfirdn_adjoint": 1, "grid_to_latent_bwd": 0,
        "latent_to_grid_bwd": 0}
    z = ops.modulated_conv2d(x, w, s)
    (gx,) = torch.autograd.grad(z.square().sum(), [x], create_graph=True)
    assert _finds(gx.grad_fn, "ModconvGradsFunctionBackward")
    ops.reset_launch_counts()
    gx.sum().backward()
    counts = ops.launch_counts()
    # the second order (gdx alone reaches it): kernel 1 for du and d,
    # kernel 5 for s, kernel 6 for w; then the forward graph's backward
    # (kernels 5 and 6 once each)
    assert ops.second_order_counts()["modconv_second_order"] == 3
    assert (counts["modconv"], counts["modconv_dx"],
            counts["modconv_dw"]) == (1, 2, 2)
    with torch.no_grad():                    # no graph wanted: bare launch
        assert ops.modulated_conv2d(x, w, s).grad_fn is None
    q = _t(rng.randn(2, 16, 8), True)
    kv = _t(rng.randn(2, 3, 8))
    for (lq, lk), node, key in (
            ((q, kv), "GridToLatentFunctionBackward", "grid_to_latent"),
            ((kv, q), "LatentToGridFunctionBackward", "latent_to_grid")):
        ops.reset_launch_counts()
        o = ops.fused_multihead_attention(lq, lk, lk)
        assert _finds(o.grad_fn, node)
        torch.autograd.grad(o.sum(), [q])
        counts = ops.launch_counts()
        assert counts[key] == counts[key + "_bwd"] == 1
        assert ops.lse_launch_counts()[key] == 1
