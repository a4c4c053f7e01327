"""Bipartite-attention primitives (plain PyTorch).

The counterpart of ``gansformer_tpu/ops/attention.py``: multi-head
dot-product attention over pre-projected q/k/v with fp32 softmax
statistics, and the 2D sinusoidal grid encoding.  ``attention_plain`` is
the plain version of both attention kernels (``cuda_attention``) on
head-folded inputs; the sharded variants wait for a later slice.

The plain versions of the kernels' training outputs follow the JAX
package's oracles in ``gansformer_tpu/ops/pallas_attention.py``:
``attention_fwd_stats_plain`` (``_ref_fwd_stats``: the output and the
per-row ``lse``), ``attention_bwd_plain`` (``_ref_bwd``: dq, dk, dv with
P rebuilt from ``lse`` and the row delta ``rowsum(dP * P)``, the
grid->latent backward kernel's form) and ``attention_bwd_with_o_plain``
(delta ``rowsum(do * o)``, the latent->grid backward kernel's form).  On
the card they are the kernels' oracles; on the CPU autograd of
``attention_plain`` is the route.

``attention_bwd_vjp_plain`` is the second order on the card: the VJP of
that backward as a function of (q, k, v, do), with lse (and o) rebuilt
from q, k and v, as ``_g2l_grads_jvp``/``_l2g_grads_jvp`` take it through
``jax.jvp`` of ``_ref_bwd``/``_ref_bwd_with_o``.  No Pallas kernel
computes it in the JAX package, so it is torch ops by design.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from gansformer_tpu_torch.core.precision import widen


def _logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bnd,bld->bnl", widen(q), widen(k)) / math.sqrt(
        q.shape[-1])


def attention_plain(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v on [B, Lq, D] x [B, Lk, D] x [B, Lk, Dv],
    fp32 logits and softmax, probabilities cast to v's dtype before the
    mix (as the reference does), output in v's dtype."""
    p = torch.softmax(_logits(q, k), dim=-1).to(v.dtype)
    return torch.einsum("bnl,bld->bnd", widen(p), widen(v)).to(v.dtype)


def attention_fwd_stats_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): ``attention_plain``'s output, bit for bit, and the fp32
    row statistic lse = max + log(sum exp(s - max)) [B, Lq]."""
    s = _logits(q, k)
    m = s.amax(dim=-1, keepdim=True)
    den = torch.exp(s - m).sum(dim=-1, keepdim=True)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bnl,bld->bnd", widen(p), widen(v)).to(v.dtype)
    return o, (m + torch.log(den))[..., 0]


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor,
                        delta: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of softmax attention at the cotangent ``do``, in fp32,
    P = exp(s - lse) rebuilt from the forward's statistic; returned in q's,
    k's and v's dtypes.  ``delta`` [B, Lq] is the row correction
    rowsum(dP * P); when None it is computed here from P and dP."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    q32, k32, v32, do32 = widen(q), widen(k), widen(v), widen(do)
    p = torch.exp(torch.einsum("bnd,bld->bnl", q32, k32) * scale
                  - widen(lse)[..., None])
    dv = torch.einsum("bnl,bnd->bld", p, do32)
    dp = torch.einsum("bnd,bld->bnl", do32, v32)
    if delta is None:
        delta = (dp * p).sum(dim=-1)
    ds = p * (dp - widen(delta)[..., None])
    dq = torch.einsum("bnl,bld->bnd", ds, k32) * scale
    dk = torch.einsum("bnl,bnd->bld", ds, q32) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(do * o) [B, Lq] in fp32: the FlashAttention identity for
    rowsum(dP * P), computed once outside the latent->grid backward
    kernel as the JAX package computes it outside its ``pallas_call``."""
    return (widen(do) * widen(o)).sum(dim=-1)


def attention_bwd_with_o_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, o: torch.Tensor,
                               lse: torch.Tensor, do: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """``attention_bwd_plain`` with delta = rowsum(do * o) from the saved
    output: the latent->grid backward kernel's form."""
    return attention_bwd_plain(q, k, v, lse, do, attention_delta(o, do))


def attention_bwd_vjp_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor,
                            gdq: torch.Tensor, gdk: torch.Tensor,
                            gdv: torch.Tensor, delta_from_o: bool
                            ) -> Tuple[torch.Tensor, ...]:
    """The gradients wrt (q, k, v, do) of <(gdq, gdk, gdv), backward(q, k,
    v, do)>, where backward is ``attention_bwd_plain`` (``delta_from_o``
    False: grid->latent) or ``attention_bwd_with_o_plain`` (True:
    latent->grid) with lse and o rebuilt from q, k and v, so their own
    dependence on q, k and v is in the result.  Each gradient in its
    input's dtype; ``do`` takes one because in R1 the cotangent itself
    depends on the parameters."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (q, k, v, do)]
        o, lse = attention_fwd_stats_plain(*ins[:3])
        if delta_from_o:
            grads = attention_bwd_with_o_plain(*ins[:3], o, lse, ins[3])
        else:
            grads = attention_bwd_plain(*ins[:3], lse, ins[3])
        return torch.autograd.grad(grads, ins, (gdq, gdk, gdv))


def multihead_attention(
    q: torch.Tensor,           # [N, Lq, D]
    k: torch.Tensor,           # [N, Lk, D]
    v: torch.Tensor,           # [N, Lk, Dv]
    num_heads: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain multi-head attention returning (out [N, Lq, Dv],
    probs [N, heads, Lq, Lk]); the probabilities are for diagnostics."""
    n, lq, d = q.shape
    _, lk, dv = v.shape
    assert d % num_heads == 0 and dv % num_heads == 0
    dh = d // num_heads
    qh = widen(q.reshape(n, lq, num_heads, dh))
    kh = widen(k.reshape(n, lk, num_heads, dh))
    vh = v.reshape(n, lk, num_heads, dv // num_heads)
    logits = torch.einsum("nqhd,nkhd->nhqk", qh, kh) / math.sqrt(dh)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("nhqk,nkhd->nqhd", widen(probs.to(vh.dtype)),
                       widen(vh)).to(v.dtype)
    return out.reshape(n, lq, dv), probs


def sinusoidal_grid_encoding(height: int, width: int, dim: int) -> np.ndarray:
    """2D sinusoidal positional encoding, a static [H*W, dim] fp32 array
    (computed in float64 like the reference)."""
    assert dim % 4 == 0, "positional dim must be divisible by 4"
    quarter = dim // 4
    freqs = 1.0 / (10000.0 ** (np.arange(quarter, dtype=np.float64)
                               / quarter))
    ys = np.arange(height, dtype=np.float64)[:, None] * freqs[None, :]
    xs = np.arange(width, dtype=np.float64)[:, None] * freqs[None, :]
    enc_y = np.concatenate([np.sin(ys), np.cos(ys)], axis=-1)
    enc_x = np.concatenate([np.sin(xs), np.cos(xs)], axis=-1)
    grid = np.concatenate(
        [np.broadcast_to(enc_y[:, None, :], (height, width, dim // 2)),
         np.broadcast_to(enc_x[None, :, :], (height, width, dim // 2))],
        axis=-1)
    return grid.reshape(height * width, dim).astype(np.float32)
