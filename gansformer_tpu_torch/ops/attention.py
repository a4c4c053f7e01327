"""Bipartite-attention primitives (plain PyTorch).

The counterpart of ``gansformer_tpu/ops/attention.py``: multi-head
dot-product attention over pre-projected q/k/v with fp32 softmax
statistics, and the 2D sinusoidal grid encoding.  ``attention_plain`` is
the plain version of both attention kernels (``cuda_attention``) on
head-folded inputs; the sharded variants wait for a later slice.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def attention_plain(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v on [B, Lq, D] x [B, Lk, D] x [B, Lk, Dv],
    fp32 logits and softmax, probabilities cast to v's dtype before the
    mix (as the reference does), output in v's dtype."""
    s = torch.einsum("bnd,bld->bnl", q.float(), k.float()) / math.sqrt(
        q.shape[-1])
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bnl,bld->bnd", p.float(), v.float()).to(v.dtype)


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
    qh = q.reshape(n, lq, num_heads, dh).float()
    kh = k.reshape(n, lk, num_heads, dh).float()
    vh = v.reshape(n, lk, num_heads, dv // num_heads)
    logits = torch.einsum("nqhd,nkhd->nhqk", qh, kh) / math.sqrt(dh)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("nhqk,nkhd->nqhd", probs.to(vh.dtype).float(),
                       vh.float()).to(v.dtype)
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
