"""Style-modulated convolution, NHWC activations and HWIO weights.

The counterpart of ``gansformer_tpu/ops/modulated_conv.py`` (the XLA
composite) and of the Pallas entry ``modulated_conv2d_pallas``
(``ops/pallas_modconv.py``), whose structure ``modulated_conv2d`` keeps:

* the demod coefficients ``d = rsqrt(sum((w * s)^2) + eps)`` are an fp32
  einsum outside the kernel;
* ``up=1`` is one modconv kernel (``same3``/``same1``) with an optional
  fused ``act(y + bias) * gain`` epilogue;
* ``up=2`` is the ``poly`` kernel (phases from ``poly_w4``, interleaved in
  the kernel) followed by the upfirdn blur kernel, which carries the
  epilogue.

A CUDA tensor launches the kernels; a CPU tensor runs ``modconv_plain``,
which takes the same stacked weights as the kernel and which autograd
differentiates.  On the card, when autograd records, the core is
``ModconvCore`` (the counterpart of ``_mc_core``'s custom VJP): its
backward recovers ``act'``, ``db`` and ``dd`` from the saved output in
differentiable torch glue (``_mc_core_bwd``) and hands the cotangent of
the bare core to ``ModconvGradsFunction`` (``_mc_grads``), which launches
the dx/ds kernel (``_bwd_call``) and the dw kernel (``_dw_call``);
``modconv_dx_plain`` and ``modconv_dw_plain`` are their plain versions.

The second order (path length differentiates G's gradient once more) is
``ModconvGradsFunction.backward``.  The JAX package takes it through
``jax.jvp`` of its jnp references (``_mc_grads_jvp``, ``_ref_core_grads``),
outside Pallas.  The port re-enters its kernels instead, because the
core is multilinear: with u = d * du (per output channel),

    dx = s * convT(u, w),   ds = sum_hw x * convT(u, w),
    dw = sum_{n,hw} (s * x) (*) u,

so for cotangents (gdx, gds, gdw), with a = s * gdx + gds * x and
q = conv(a, w) + conv(s * x, gdw):

    g_du = d * q,    g_d = sum_hw du * q
          (kernel 1 with post = d gives d * q; g_d divides it by d, as
          dd divides the saved output),
    g_x = gds * convT(u, w) + s * convT(u, gdw),
    g_s = sum_hw gdx * convT(u, w) + sum_hw x * convT(u, gdw)
          (kernel 5: post = gds on x = gdx; post = s with gdw's taps),
    g_w = sum a (*) u (kernel 6 with unit styles, folded by
          ``_poly_dw_fold`` for ``poly``).

A term whose cotangent is None is skipped; in path length gdw is None,
so a layer takes one launch of each kernel.  These launches count as
``modconv_second_order`` too.  With no graph wanted (a first-order
step), ``ModconvGradsFunction`` runs its forward alone: the same
launches as before.

``conv2d`` is the plain conv with the up path (``_conv_transpose_poly``,
the phase-major XLA formulation, kept as an independent oracle) and the
down paths of the discriminator: the 1x1 skip decimates inside the blur,
the 3x3 conv blurs with its padding folded in and then strides.  Their
FIR legs run through ``upfirdn2d`` (the kernel on the card); the dense
convs stay ``F.conv2d``, as they are plain XLA contractions in the JAX
package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from gansformer_tpu_torch.core.device import kernel_route, wants_graph
from gansformer_tpu_torch.core.precision import widen
from gansformer_tpu_torch.ops import cuda_modconv
from gansformer_tpu_torch.ops.cuda_modconv import TAPS
from gansformer_tpu_torch.ops.fused_bias_act import (ACTIVATIONS,
                                                     default_gain,
                                                     fused_bias_act)
from gansformer_tpu_torch.ops.upfirdn2d import (FUSED_ACTS, act_grad,
                                                filter_2d, setup_filter,
                                                upfirdn2d)


class QuantizedWeight(torch.nn.Module):
    """An int8 weight-only kernel (``serve_precision='int8w'``), the
    counterpart of ``QuantizedWeight`` in
    ``gansformer_tpu/ops/modulated_conv.py``.

    ``q`` keeps the kernel's shape in int8; ``scale`` is the fp32 scale of
    each output channel over the last axis (keepdims, so it broadcasts
    over the dense [fan_in, Cout] and the conv [kh, kw, Cin, Cout]
    layouts).  Both are buffers, so the module moves with ``.to()`` and
    its ``state_dict`` holds the codes and the scales.  It takes the place
    of a layer's ``w`` parameter; the layers fetch every kernel through
    ``resolve_weight``."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        if q.dtype != torch.int8 or scale.dtype != torch.float32:
            raise TypeError(f"QuantizedWeight takes int8 codes and fp32 "
                            f"scales, got {q.dtype} and {scale.dtype}")
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.ndim

    def extra_repr(self) -> str:
        return f"q={tuple(self.q.shape)}:int8, scale={tuple(self.scale.shape)}"


def _dequant_int8w(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8w dequantization, an fp32 island: the codes span +-127, so a
    bf16 product would round the mantissa a second time."""
    return q.float() * scale.float()


def resolve_weight(w):
    """The kernel fetch of every equalized-LR layer: an fp32 kernel passes
    through; a ``QuantizedWeight`` dequantizes here, ahead of the
    equalized-LR coefficient and the dtype cast, so the plain versions and
    the kernels take the same dequantized weights."""
    if isinstance(w, QuantizedWeight):
        return _dequant_int8w(w.q, w.scale)
    return w


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int,
          padding) -> torch.Tensor:
    """NHWC x HWIO convolution (correlation) in x's dtype (fp32
    accumulation on the card), output NHWC."""
    wo = _oihw(w.to(x.dtype)).contiguous(memory_format=torch.channels_last)
    y = F.conv2d(_nchw(x), wo, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def _phase_taps(w: torch.Tensor) -> torch.Tensor:
    """[3,3,Ci,Co] -> [dh, dw, a, b, Ci, Co]: the tap of w that output
    phase (a, b) reads at offset (dh, dw), ``w_pad[2dh+1-a, 2dw+1-b]`` of
    w padded to 4x4 with zeros.  Taken by reshape and flip, with no index
    tensor: a CPU index on a CUDA weight is a host-to-device copy that
    syncs the host."""
    ci, co = w.shape[2], w.shape[3]
    w_pad = F.pad(w, (0, 0, 0, 0, 0, 1, 0, 1))            # [4, 4, Ci, Co]
    w6 = w_pad.reshape(2, 2, 2, 2, ci, co).flip(1).flip(3)  # [dh,a,dw,b,..]
    return w6.permute(0, 2, 1, 3, 4, 5)


def _conv_transpose_poly(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-2 transposed 3x3 conv as one 2x2 conv with 4*Co phase outputs
    (phase-MAJOR columns: a*2*Co + b*Co + co), then depth-to-space.  Output
    pixel (2m+a, 2n+b) reads x[m+dh, n+dw] with weight w[2dh+1-a, 2dw+1-b];
    taps outside w are structural zeros."""
    kh, kw = w.shape[0], w.shape[1]
    assert kh == kw == 3, "polyphase path is derived for 3x3 kernels"
    n, h, wd, ci = x.shape
    co = w.shape[3]
    w4 = _phase_taps(w)                                    # [dh,dw,a,b,..]
    w4 = w4.permute(0, 1, 4, 2, 3, 5).reshape(2, 2, ci, 4 * co)
    xp = F.pad(x, (0, 0, 0, 1, 0, 1))                      # right/bottom 1
    y = _conv(xp, w4, 1, 0)                                # [N, H, W, 4Co]
    y = y.reshape(n, h, wd, 2, 2, co).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, 2 * h, 2 * wd, co)


def conv2d(x: torch.Tensor, w: torch.Tensor, up: int = 1, down: int = 1,
           resample_filter: Sequence[float] = (1, 3, 3, 1)) -> torch.Tensor:
    """Plain conv (SAME) with FIR-filtered resampling.  ``up=2`` is the
    polyphase transposed conv then the anti-imaging blur (gain up^2), the
    reference's order.  ``down > 1``: a 1x1 kernel decimates inside the
    blur (``upfirdn(down, pad ((p+1)//2, p//2))``) and then convolves; a
    larger kernel blurs with its VALID padding folded in and then strides
    the conv."""
    assert x.ndim == 4 and w.ndim == 4
    kh, kw = w.shape[0], w.shape[1]
    if down > 1:
        if up != 1 or kh != kw:
            raise NotImplementedError(f"up={up} down={down} with a "
                                      f"{kh}x{kw} kernel")
        f = setup_filter(resample_filter)
        if kh == 1:
            p = f.shape[0] - down
            x = upfirdn2d(x, f, down=down, pad=((p + 1) // 2, p // 2))
            return _conv(x, w, 1, 0)
        p = (f.shape[0] - down) + (kh - 1)
        x = upfirdn2d(x, f, pad=((p + 1) // 2, p // 2))
        return _conv(x, w, down, 0)
    if up == 2 and kh == kw == 3:
        return filter_2d(_conv_transpose_poly(x, w), resample_filter,
                         gain=float(up * up))
    if up != 1:
        raise NotImplementedError(f"up={up} with a {kh}x{kw} kernel")
    return _conv(x, w, 1, (kh // 2, kw // 2))


def _demod_coeffs(w32: torch.Tensor, s32: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Per-sample demod coefficients 1/||w*s||_2, an fp32 island."""
    sigma = torch.einsum("hwio,ni->no", w32.square(), s32.square())
    return torch.rsqrt(sigma + eps)                        # [N, Cout]


def poly_w4(w: torch.Tensor) -> torch.Tensor:
    """[3,3,Ci,Co] -> [4, Ci, Co*4] phase sub-kernels, tap-major (t = dh*2
    + dw), columns co-OUTER / phase-INNER (co*4 + a*2 + b): the Pallas
    kernel's ``_poly_w4`` layout, which the CUDA kernel reads."""
    ci, co = w.shape[2], w.shape[3]
    w4 = _phase_taps(w)                                    # [dh,dw,a,b,..]
    w4 = w4.permute(0, 1, 4, 5, 2, 3)                      # [dh,dw,Ci,Co,a,b]
    return w4.reshape(4, ci, co * 4).contiguous()


def stack_weights(kind: str, w: torch.Tensor) -> torch.Tensor:
    """The kernel's stacked weights [T, Ci, Co*phases] for ``kind``."""
    if kind == "poly":
        return poly_w4(w)
    return w.reshape(-1, w.shape[2], w.shape[3]).contiguous()


def modconv_plain(x: torch.Tensor, wstack: torch.Tensor, s: torch.Tensor,
                  post: torch.Tensor, bias: Optional[torch.Tensor],
                  kind: str, act: Optional[str], alpha: float,
                  gain: float) -> torch.Tensor:
    """The plain PyTorch version of the modconv kernel, on the kernel's own
    inputs: fp32 ``post * conv(x * s, w)`` (+ epilogue), output in x's
    dtype."""
    n, h, w, ci = x.shape
    cok = wstack.shape[2]
    xs = widen(x) * widen(s)[:, None, None, :]
    w32 = widen(wstack)
    if kind == "same3":
        y = _conv(xs, w32.reshape(3, 3, ci, cok), 1, 1)
    elif kind == "same1":
        y = _conv(xs, w32.reshape(1, 1, ci, cok), 1, 0)
    elif kind == "poly":
        xp = F.pad(xs, (0, 0, 0, 1, 0, 1))
        y = _conv(xp, w32.reshape(2, 2, ci, cok), 1, 0)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    y = y * widen(post)[:, None, None, :]
    if kind == "poly":                       # co-major depth-to-space
        co = cok // 4
        y = (y.reshape(n, h, w, co, 2, 2).permute(0, 1, 4, 2, 5, 3)
             .reshape(n, 2 * h, 2 * w, co))
    if act is not None:
        fn, _ = ACTIVATIONS[act]
        if bias is not None:
            y = y + widen(bias)
        y = fn(y, alpha) * gain
    return y.to(x.dtype).contiguous()


# --------------------------------------------------------------------------
# Layouts of the backward (copies of pallas_modconv.py's)
# --------------------------------------------------------------------------

# The (row, (dh, a)) inverse of the polyphase tap map for k = 3: each real
# weight row r is read by exactly one (dh, a) pair (row 3 is the
# structural-zero pad).
_POLY_ROW_SRC = {0: (0, 1), 1: (0, 0), 2: (1, 1)}


def _poly_dw_fold(dw4: torch.Tensor, ci: int, co: int) -> torch.Tensor:
    """[4, Ci, Co*4] tap-major phase grads -> [3,3,Ci,Co]: the inverse
    gather of the ``poly_w4`` tap map; the pad row's grads are dropped
    (those taps are structural zeros)."""
    g = dw4.reshape(2, 2, ci, co, 2, 2)                    # [dh,dw,Ci,Co,a,b]
    rows = []
    for r1 in range(3):
        dh1, a1 = _POLY_ROW_SRC[r1]
        rows.append(torch.stack([g[dh1, _POLY_ROW_SRC[r2][0], :, :, a1,
                                   _POLY_ROW_SRC[r2][1]]
                                 for r2 in range(3)]))
    return torch.stack(rows)                               # [3,3,Ci,Co]


def _space_to_depth(du: torch.Tensor) -> torch.Tensor:
    """[N,2H,2W,Co] -> [N,H,W,Co*4], co-outer / phase-inner as
    ``poly_w4``."""
    n, h2, w2, co = du.shape
    h, w = h2 // 2, w2 // 2
    return (du.reshape(n, h, 2, w, 2, co).permute(0, 1, 3, 5, 2, 4)
            .reshape(n, h, w, co * 4))


def _adjoint_geom(kind: str):
    """(offs, pads) of the adjoint: tap offsets into the cotangent padded
    by ``pads``, as in ``pallas_modconv._prep_adjoint``."""
    if kind == "same3":
        return (tuple((a, b) for a in range(3) for b in range(3)),
                ((1, 1), (1, 1)))
    if kind == "same1":
        return ((0, 0),), ((0, 0), (0, 0))
    assert kind == "poly", kind
    return (tuple((1 - dh, 1 - dw_) for dh in range(2) for dw_ in range(2)),
            ((1, 0), (1, 0)))


def _prep_adjoint(kind: str, w: torch.Tensor):
    """(offs, pads, wT [T, CoutK, Cin]) of the transposed conv the dx/ds
    kernel runs (spatial flip + channel transpose); a copy of
    ``pallas_modconv._prep_adjoint``."""
    ci, co = w.shape[2], w.shape[3]
    offs, pads = _adjoint_geom(kind)
    if kind == "same3":
        wf = torch.flip(w, (0, 1)).permute(0, 1, 3, 2)     # [3,3,Co,Ci]
        return offs, pads, wf.reshape(9, co, ci)
    if kind == "same1":
        return offs, pads, w.permute(0, 1, 3, 2).reshape(1, co, ci)
    w4 = poly_w4(w).reshape(2, 2, ci, co * 4)               # tap [dh, dw]
    return offs, pads, torch.stack([w4[dh, dw_].t() for dh in range(2)
                                    for dw_ in range(2)])   # [4, Co*4, Ci]


def adjoint_taps(kind: str) -> Tuple[Tuple[int, int], ...]:
    """The adjoint's tap offsets relative to the output pixel (the
    kernels' convention): ``_adjoint_geom``'s offsets less its leading
    pads."""
    offs, pads = _adjoint_geom(kind)
    return tuple((oy - pads[0][0], ox - pads[1][0]) for oy, ox in offs)


def _shift(t: torch.Tensor, oy: int, ox: int) -> torch.Tensor:
    """``t[:, h + oy, w + ox, :]`` on the same grid, zero outside."""
    n, h, w, _ = t.shape
    py0, px0 = max(-oy, 0), max(-ox, 0)
    tp = F.pad(t, (0, 0, px0, max(ox, 0), py0, max(oy, 0)))
    return tp[:, py0 + oy:py0 + oy + h, px0 + ox:px0 + ox + w, :]


def adjoint_u_plain(du4: torch.Tensor, wT: torch.Tensor, pre: torch.Tensor,
                    taps) -> torch.Tensor:
    """u = sum_t shift_t(du) . (wT_t * d), fp32 [N, H, W, Ci]; the demod
    ``pre`` is folded into the weights in fp32 and rounded to the compute
    dtype, as the kernel (and ``_bwd_body``) do."""
    d32 = widen(du4)
    wn = widen((widen(wT)[None] * widen(pre)[:, None, :, None]).to(
        du4.dtype))                                  # [N,T,CoK,Ci]
    u = None
    for t, (oy, ox) in enumerate(taps):
        ut = torch.einsum("nhwk,nkc->nhwc", _shift(d32, oy, ox), wn[:, t])
        u = ut if u is None else u + ut
    return u


def modconv_dx_plain(du4: torch.Tensor, wT: torch.Tensor, pre: torch.Tensor,
                     post: torch.Tensor, x: torch.Tensor, taps
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the dx/ds kernel: ``dx = s * u`` in x's dtype
    and ``ds = sum_hw x * u`` in fp32, with ``u`` from
    ``adjoint_u_plain``."""
    u = adjoint_u_plain(du4, wT, pre, taps)
    dx = (u * widen(post)[:, None, None, :]).to(x.dtype)
    return dx, (widen(x) * u).sum(dim=(1, 2))


def modconv_dw_per_sample(x: torch.Tensor, du4: torch.Tensor,
                          s: torch.Tensor, pre: torch.Tensor, taps
                          ) -> torch.Tensor:
    """[N, T, Ci, CoK] fp32: each sample's term of dw, the rank-1 scale
    ``s_n (x) d_n`` applied to the tap product ``shift_t(x)^T du``."""
    x32, d32 = widen(x), widen(du4)
    scale = widen(s)[:, :, None] * widen(pre)[:, None, :]
    return torch.stack([
        torch.einsum("nhwc,nhwk->nck", _shift(x32, oy, ox), d32) * scale
        for oy, ox in taps], dim=1)


def modconv_dw_plain(x: torch.Tensor, du4: torch.Tensor, s: torch.Tensor,
                     pre: torch.Tensor, taps) -> torch.Tensor:
    """The plain version of the dw kernel: [T, Ci, CoK] in fp32."""
    return modconv_dw_per_sample(x, du4, s, pre, taps).sum(dim=0)


def _act_inv(y32: torch.Tensor, act: str, alpha: float,
             gain: float) -> torch.Tensor:
    """u = act^-1(y / gain)."""
    y32 = y32 / gain
    if act == "linear":
        return y32
    return torch.where(y32 >= 0, y32, y32 / alpha)


# --------------------------------------------------------------------------
# Launch routing and the core's autograd Function
# --------------------------------------------------------------------------


def _core_launch(x, wstack, s, post, bias, kind, act, alpha, gain,
                 second_order=False):
    if kernel_route(x):
        return cuda_modconv.modconv_cuda(x, wstack, s, post, bias, kind, act,
                                         alpha, gain, second_order)
    return modconv_plain(x, wstack, s, post, bias, kind, act, alpha, gain)


def modconv_dx(du4, wT, pre, post, x, taps, second_order=False):
    """dx/ds: the kernel for CUDA tensors, the plain version on the CPU."""
    if kernel_route(du4):
        return cuda_modconv.modconv_dx_cuda(du4, wT, pre, post, x, taps,
                                            second_order)
    return modconv_dx_plain(du4, wT, pre, post, x, taps)


def modconv_dw(x, du4, s, pre, taps, second_order=False):
    """dw: the kernel for CUDA tensors, the plain version on the CPU."""
    if kernel_route(du4):
        return cuda_modconv.modconv_dw_cuda(x, du4, s, pre, taps,
                                            second_order)
    return modconv_dw_plain(x, du4, s, pre, taps)


def _post(kind: str, d: torch.Tensor) -> torch.Tensor:
    return d.repeat_interleave(4, dim=1) if kind == "poly" else d


def _du4(kind: str, du: torch.Tensor) -> torch.Tensor:
    return (_space_to_depth(du) if kind == "poly" else du).contiguous()


def _fold_dw(kind: str, dwt: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The dw kernel's [T, Ci, CoK] as w's [kh, kw, Ci, Co], in w's
    dtype."""
    return (_poly_dw_fold(dwt, w.shape[2], w.shape[3]) if kind == "poly"
            else dwt.reshape(w.shape)).to(w.dtype)


def _sum(a: Optional[torch.Tensor], b: torch.Tensor) -> torch.Tensor:
    return b if a is None else (widen(a) + widen(b)).to(a.dtype)


def modconv_core_grads(x, w, s, d, du, kind, want_xs=True, want_w=True):
    """(dx, ds, dw) of the core ``d * conv(s * x, w)`` at its cotangent
    ``du`` (the output's layout): the dx/ds kernel where ``want_xs``, the
    dw kernel where ``want_w``, None for the others."""
    du4, pre = _du4(kind, du), _post(kind, d)
    dx = ds = dw = None
    if want_xs:
        _, _, wT = _prep_adjoint(kind, w)
        dx, ds = modconv_dx(du4, wT, pre, s, x, adjoint_taps(kind))
        ds = ds.to(s.dtype)
    if want_w:
        dw = _fold_dw(kind, modconv_dw(x, du4, s, pre, TAPS[kind]), w)
    return dx, ds, dw


def modconv_second_order(x, w, s, d, du, gdx, gds, gdw, kind, need):
    """The gradients wrt (x, w, s, d, du) of <(gdx, gds, gdw), (dx, ds,
    dw)> with (dx, ds, dw) = ``modconv_core_grads``: the formulas of the
    module's docstring, each term on its kernel.  ``need`` flags the
    inputs wanted; a cotangent may be None.  Returns None where an input
    is not wanted or no cotangent reaches it."""
    need_x, need_w, need_s, need_d, need_du = need
    du4, pre = _du4(kind, du), _post(kind, d)
    # a = s * gdx + gds * x, as one input of unit styles where both exist
    if gdx is None and gds is None:
        a = sa = None
    elif gds is None:
        a, sa = gdx, s
    elif gdx is None:
        a, sa = x, gds
    else:
        a = (widen(gdx) * widen(s)[:, None, None, :]
             + widen(x) * widen(gds)[:, None, None, :]).to(x.dtype)
        sa = torch.ones_like(s)
    g_x = g_w = g_s = g_d = g_du = None
    if need_du or need_d:
        q = None                    # d * (conv(a, w) + conv(s * x, gdw))
        if a is not None:
            q = _core_launch(a, stack_weights(kind, w), sa, pre, None, kind,
                             None, 0.2, 1.0, True)
        if gdw is not None:
            q = _sum(q, _core_launch(x, stack_weights(kind, gdw.to(x.dtype)),
                                     s, pre, None, kind, None, 0.2, 1.0,
                                     True))
        if q is not None:
            g_du = q.to(du.dtype) if need_du else None
            g_d = ((widen(du) * widen(q)).sum(dim=(1, 2))
                   / widen(d)).to(d.dtype) if need_d else None
    want_x, want_s = need_x and gds is not None, need_s and gdx is not None
    taps = adjoint_taps(kind)
    if want_x or want_s:
        _, _, wT = _prep_adjoint(kind, w)
        ux, us = modconv_dx(du4, wT, pre, gds if want_x else s,
                            gdx if want_s else x, taps, True)
        g_x = ux if want_x else None
        g_s = us if want_s else None
    if gdw is not None and (need_x or need_s):
        _, _, wT = _prep_adjoint(kind, gdw.to(x.dtype))
        vx, vs = modconv_dx(du4, wT, pre, s, x, taps, True)
        g_x = _sum(g_x, vx) if need_x else None
        g_s = _sum(g_s, vs) if need_s else None
    if need_w and a is not None:
        g_w = _fold_dw(kind, modconv_dw(a, du4, sa, pre, TAPS[kind], True),
                       w)
    return (g_x, g_w, None if g_s is None else g_s.to(s.dtype), g_d, g_du)


class ModconvGradsFunction(torch.autograd.Function):
    """x, w, s, d, du -> (dx, ds, dw) of the bare core at its cotangent du
    (``modconv_core_grads``; ``_mc_grads``).  Its backward is the second
    order on the kernels (``modconv_second_order``); a third derivative
    raises."""

    @staticmethod
    def forward(ctx, x, w, s, d, du, kind, want_xs, want_w):
        ctx.set_materialize_grads(False)
        ctx.kind = kind
        ctx.save_for_backward(x, w, s, d, du)
        return modconv_core_grads(x, w, s, d, du, kind, want_xs, want_w)

    @staticmethod
    @once_differentiable
    def backward(ctx, gdx, gds, gdw):
        x, w, s, d, du = ctx.saved_tensors
        return modconv_second_order(x, w, s, d, du, gdx, gds, gdw, ctx.kind,
                                    ctx.needs_input_grad[:5]) + (None,) * 3


class ModconvCore(torch.autograd.Function):
    """x, w, s, d, b -> y = act(d * conv(x * s, w) + b) * gain (or the
    bare core when ``act`` is None), with w the [kh,kw,Ci,Co] weight in
    x's dtype and s, d fp32.  The backward follows ``_mc_core_bwd``: the
    glue in torch ops, the core's gradients through
    ``ModconvGradsFunction``, so it differentiates again."""

    @staticmethod
    def forward(ctx, x, w, s, d, bias, kind, act, alpha, gain):
        y = _core_launch(x, stack_weights(kind, w), s, _post(kind, d), bias,
                         kind, act, alpha, gain)
        ctx.spec = (kind, act, alpha, gain)
        ctx.save_for_backward(x, w, s, d, bias, y)
        return y

    @staticmethod
    def backward(ctx, ct):
        kind, act, alpha, gain = ctx.spec
        x, w, s, d, bias, y = ctx.saved_tensors
        need_x, need_w, need_s, need_d, need_b = ctx.needs_input_grad[:5]
        y32, ct32 = widen(y), widen(ct)
        if act is None:
            du32, c = ct32, y32
        else:
            du32 = ct32 * act_grad(y32, act, alpha) * gain
            c = _act_inv(y32, act, alpha, gain)
            if bias is not None:
                c = c - widen(bias)
        db = du32.sum(dim=(0, 1, 2)) if bias is not None and need_b else None
        # dd = sum_hw du * conv(s x, w): the pre-demod conv recovered from
        # the saved output (c = d * conv), so no recompute pass
        dd = ((du32 * c).sum(dim=(1, 2)) / widen(d)).to(d.dtype) \
            if need_d else None
        dx, ds, dw = ModconvGradsFunction.apply(
            x, w, s, d, du32.to(ct.dtype), kind, need_x or need_s, need_w)
        return (dx if need_x else None, dw, ds if need_s else None, dd, db,
                None, None, None, None)


def _modconv(x, w, s, d, bias, kind, act, alpha, gain):
    """The core on the kernel's inputs: ``ModconvCore`` when autograd
    records on the card, else a direct launch (card) or the plain version
    (CPU, differentiated by autograd)."""
    if kernel_route(x) and wants_graph(x, w, s, d, bias):
        return ModconvCore.apply(x, w, s, d, bias, kind, act, alpha, gain)
    return _core_launch(x, stack_weights(kind, w), s, _post(kind, d), bias,
                        kind, act, alpha, gain)


def modulated_conv2d(
    x: torch.Tensor,                 # [N, H, W, Cin]
    w: torch.Tensor,                 # [kh, kw, Cin, Cout]
    styles: torch.Tensor,            # [N, Cin]
    demodulate: bool = True,
    up: int = 1,
    down: int = 1,
    resample_filter: Sequence[float] = (1, 3, 3, 1),
    eps: float = 1e-8,
    *,
    bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
    alpha: float = 0.2,
    gain: Optional[float] = None,
) -> torch.Tensor:
    """Modulate -> conv -> demodulate, with an optional fused
    ``act(y + bias) * gain`` epilogue (linear/lrelu; any other activation
    runs after the kernels)."""
    assert x.ndim == 4 and w.ndim == 4 and styles.ndim == 2
    n, _, _, cin = x.shape
    kh, kw, _, co = w.shape
    assert w.shape[2] == cin and styles.shape == (n, cin)
    assert act is not None or bias is None, \
        "bias without act: pass act='linear'"
    if act is not None and act not in FUSED_ACTS:
        y = modulated_conv2d(x, w, styles, demodulate, up, down,
                             resample_filter, eps)
        return fused_bias_act(y, bias, act=act, alpha=alpha, gain=gain)
    if down != 1 or not ((up == 1 and kh == kw and kh in (1, 3))
                         or (up == 2 and kh == kw == 3)):
        raise NotImplementedError(
            f"modulated_conv2d: up={up} down={down} kernel {kh}x{kw} is not "
            f"on the generator's path")
    s32 = widen(styles)
    if demodulate:
        d = _demod_coeffs(widen(w), s32, eps)
    else:
        d = torch.ones((n, co), dtype=s32.dtype, device=x.device)
    w = w.to(x.dtype)
    g = default_gain(act, gain) if act is not None else 1.0
    if up == 1:
        kind = "same1" if kh == 1 else "same3"
        return _modconv(x, w, s32, d, bias, kind, act, alpha, g)
    y = _modconv(x, w, s32, d, None, "poly", None, alpha, 1.0)
    f = setup_filter(resample_filter, gain=float(up * up))
    p = f.shape[0] - 1
    return upfirdn2d(y, f, pad=((p + 1) // 2, p // 2), bias=bias, act=act,
                     alpha=alpha, gain=gain)
