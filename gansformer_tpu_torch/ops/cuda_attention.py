"""The attention kernels (``csrc/attention.cu``, ``csrc/attention_bwd.cu``),
their ``autograd.Function``s, and the head-folding wrapper that picks
between the two directions.

Replaces ``gansformer_tpu/ops/pallas_attention.py``:

* ``grid_to_latent`` <- ``_grid_to_latent_fwd`` -> ``pl.pallas_call``
  (body ``_grid_to_latent_kernel``): grid rows attend to the k <= 64
  latents; softmax over the tiny axis, every row independent.
* ``latent_to_grid`` <- ``_latent_to_grid_fwd`` -> ``pl.pallas_call``
  (bodies ``_latent_to_grid_kernel``/``_nostats``): latents attend over the
  n grid positions; the TPU's sequential online-softmax carry becomes a
  split over n (fp32 partials per chunk) and a combine kernel, because
  Hopper blocks run in no order.
* ``grid_to_latent_bwd_cuda`` <- ``_grid_to_latent_bwd`` ->
  ``pl.pallas_call`` (body ``_grid_to_latent_bwd_kernel``): P rebuilt from
  ``lse``, dq per row, dk/dv summed over n through per-chunk fp32
  partials and a fixed-order reduce.
* ``latent_to_grid_bwd_cuda`` <- ``_latent_to_grid_bwd`` ->
  ``pl.pallas_call`` (body ``_latent_to_grid_bwd_kernel``): the
  FlashAttention backward with delta = rowsum(do * o) computed here, in
  torch, outside the kernel (as the JAX package computes it outside its
  ``pallas_call``); dk/dv per key, dq summed over n the same way.

The forwards write the fp32 row statistic ``lse`` only when asked
(``with_stats``): the Functions ask, the serving path (no graph wanted)
does not, as the TPU's no-grad path declares no ``lse`` output.  All
four are bound by bytes on the card: the flops per byte are a few dozen
at most.  The backward is first order (``once_differentiable``), as the
conv family's.  ``fused_multihead_attention`` keeps the Pallas wrapper's
rule: ``lq >= lk`` takes grid_to_latent, so at res 4 (n = 16 = k) both
duplex phases do, forward and backward.
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from gansformer_tpu_torch.core.device import kernel_route, wants_graph
from gansformer_tpu_torch.ops import _build
from gansformer_tpu_torch.ops.attention import (attention_delta,
                                                attention_plain)

# Launches since the last reset: one per grid_to_latent call, one per
# latent_to_grid call (its partial and combine kernels together), one per
# backward call of each (its main and reduce kernels together).
launches_g2l = 0
launches_l2g = 0
launches_g2l_bwd = 0
launches_l2g_bwd = 0
# Of the forward launches, those that wrote ``lse`` (a graph was wanted).
launches_g2l_lse = 0
launches_l2g_lse = 0

MAX_LATENTS = 64
SMEM_LIMIT = 232448        # bytes a Hopper block may opt in to


def _check(q, k, v):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("attention kernels take CUDA tensors")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    b, _, d = q.shape
    if k.shape[0] != b or v.shape[0] != b or k.shape[2] != d \
            or k.shape[1] != v.shape[1]:
        raise ValueError(f"shapes {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)} do not fit")
    return q.contiguous(), k.contiguous(), v.contiguous()


def _check_latents(l: int, what: str) -> None:
    if l > MAX_LATENTS:
        raise ValueError(f"{what} takes at most {MAX_LATENTS} latents, "
                         f"got {l}")


def _check_smem(nbytes: int, what: str) -> None:
    if nbytes > SMEM_LIMIT:
        raise ValueError(f"{what} needs {nbytes} bytes of shared memory, "
                         f"more than the {SMEM_LIMIT} a block may use")


def _stats(q: torch.Tensor, rows: int, with_stats: bool):
    return (torch.empty((q.shape[0], rows), dtype=torch.float32,
                        device=q.device) if with_stats else None)


def _ptr(t):
    return None if t is None else t.data_ptr()


def grid_to_latent_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        with_stats: bool = False):
    """softmax over the latent axis: q [B, n, D], k [B, L, D], v [B, L, Dv]
    -> o [B, n, Dv], or (o, lse [B, n] fp32) ``with_stats``."""
    global launches_g2l, launches_g2l_lse
    q, k, v = _check(q, k, v)
    b, n, d = q.shape
    l, dv = v.shape[1], v.shape[2]
    _check_latents(l, "grid_to_latent")
    lib = _build.load_library()
    _check_smem(lib.gt_g2l_smem(l, d, dv), f"grid_to_latent K/V of "
                f"{l}x({d}+{dv})")
    o = torch.empty((b, n, dv), dtype=v.dtype, device=v.device)
    lse = _stats(q, n, with_stats)
    rc = lib.gt_grid_to_latent(
        _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), _ptr(lse), b, n, l, d, dv, 1.0 / math.sqrt(d),
        _build.stream_ptr(q))
    _build.check(rc, "grid_to_latent kernel")
    launches_g2l += 1
    if with_stats:
        launches_g2l_lse += 1
        return o, lse
    return o


def latent_to_grid_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        with_stats: bool = False):
    """softmax over the grid axis: q [B, L, D], k [B, n, D], v [B, n, Dv]
    -> o [B, L, Dv], or (o, lse [B, L] fp32) ``with_stats``."""
    global launches_l2g, launches_l2g_lse
    q, k, v = _check(q, k, v)
    b, l, d = q.shape
    n, dv = v.shape[1], v.shape[2]
    _check_latents(l, "latent_to_grid")
    lib = _build.load_library()
    _check_smem(lib.gt_l2g_smem(l, d), f"latent_to_grid Q of {l}x{d}")
    chunks = -(-n // lib.gt_attn_chunk())
    f32 = dict(dtype=torch.float32, device=q.device)
    m_part = torch.empty((b, chunks, l), **f32)
    s_part = torch.empty((b, chunks, l), **f32)
    acc_part = torch.empty((b, chunks, l, dv), **f32)
    o = torch.empty((b, l, dv), dtype=v.dtype, device=v.device)
    lse = _stats(q, l, with_stats)
    rc = lib.gt_latent_to_grid(
        _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), _ptr(lse), m_part.data_ptr(), s_part.data_ptr(),
        acc_part.data_ptr(), b, n, l, d, dv, 1.0 / math.sqrt(d),
        _build.stream_ptr(q))
    _build.check(rc, "latent_to_grid kernel")
    launches_l2g += 1
    if with_stats:
        launches_l2g_lse += 1
        return o, lse
    return o


def _check_bwd(q, k, v, lse, do, rows_q):
    q, k, v = _check(q, k, v)
    if do.dtype != q.dtype or not do.is_cuda:
        raise TypeError(f"the cotangent must be a CUDA {q.dtype} tensor, "
                        f"got {do.dtype} on {do.device}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (q.shape[0],
                                                          rows_q):
        raise ValueError(f"lse must be fp32 {(q.shape[0], rows_q)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if tuple(do.shape) != (q.shape[0], q.shape[1], v.shape[2]):
        raise ValueError(f"cotangent {tuple(do.shape)} does not fit")
    return q, k, v, lse.contiguous(), do.contiguous()


def grid_to_latent_bwd_cuda(q, k, v, lse, do):
    """(dq, dk, dv) of grid_to_latent at the cotangent ``do`` [B, n, Dv],
    P rebuilt from the forward's ``lse`` [B, n]; in q's dtype."""
    global launches_g2l_bwd
    q, k, v, lse, do = _check_bwd(q, k, v, lse, do, q.shape[1])
    b, n, d = q.shape
    l, dv = v.shape[1], v.shape[2]
    _check_latents(l, "grid_to_latent backward")
    lib = _build.load_library()
    _check_smem(lib.gt_g2l_bwd_smem(l, d, dv), f"grid_to_latent backward "
                f"of {l}x({d}+{dv})")
    chunks = -(-n // lib.gt_attn_bwd_rows())
    f32 = dict(dtype=torch.float32, device=q.device)
    dk_part = torch.empty((b, chunks, l, d), **f32)
    dv_part = torch.empty((b, chunks, l, dv), **f32)
    dq, dk, dvv = (torch.empty_like(q), torch.empty_like(k),
                   torch.empty_like(v))
    rc = lib.gt_grid_to_latent_bwd(
        _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dvv.data_ptr(), dk_part.data_ptr(), dv_part.data_ptr(), b, n, l, d,
        dv, 1.0 / math.sqrt(d), _build.stream_ptr(q))
    _build.check(rc, "grid_to_latent backward kernel")
    launches_g2l_bwd += 1
    return dq, dk, dvv


def latent_to_grid_bwd_cuda(q, k, v, lse, do, delta):
    """(dq, dk, dv) of latent_to_grid at the cotangent ``do`` [B, L, Dv],
    P rebuilt from ``lse`` [B, L], with the row correction ``delta``
    [B, L] = rowsum(do * o) given; in q's dtype."""
    global launches_l2g_bwd
    q, k, v, lse, do = _check_bwd(q, k, v, lse, do, q.shape[1])
    b, l, d = q.shape
    n, dv = v.shape[1], v.shape[2]
    if delta.dtype != torch.float32 or tuple(delta.shape) != (b, l):
        raise ValueError(f"delta must be fp32 {(b, l)}, got {delta.dtype} "
                         f"{tuple(delta.shape)}")
    delta = delta.contiguous()
    _check_latents(l, "latent_to_grid backward")
    lib = _build.load_library()
    _check_smem(lib.gt_l2g_bwd_smem(l, d, dv), f"latent_to_grid backward "
                f"of {l}x({d}+{dv})")
    chunks = -(-n // lib.gt_attn_bwd_rows())
    dq_part = torch.empty((b, chunks, l, d), dtype=torch.float32,
                          device=q.device)
    dq, dk, dvv = (torch.empty_like(q), torch.empty_like(k),
                   torch.empty_like(v))
    rc = lib.gt_latent_to_grid_bwd(
        _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), do.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dvv.data_ptr(), dq_part.data_ptr(), b, n, l, d, dv,
        1.0 / math.sqrt(d), _build.stream_ptr(q))
    _build.check(rc, "latent_to_grid backward kernel")
    launches_l2g_bwd += 1
    return dq, dk, dvv


class GridToLatentFunction(torch.autograd.Function):
    """grid_to_latent with its backward kernel: the forward writes ``lse``
    and saves (q, k, v, lse), as ``_g2l_attend_fwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = grid_to_latent_cuda(q, k, v, with_stats=True)
        ctx.save_for_backward(q, k, v, lse)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        return grid_to_latent_bwd_cuda(q, k, v, lse, do)


class LatentToGridFunction(torch.autograd.Function):
    """latent_to_grid with its backward kernel: the forward writes ``lse``
    and saves (q, k, v, o, lse), as ``_l2g_attend_fwd`` does; delta =
    rowsum(do * o) is formed in the backward, outside the kernel."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = latent_to_grid_cuda(q, k, v, with_stats=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return latent_to_grid_bwd_cuda(q, k, v, lse, do,
                                       attention_delta(o, do))


def grid_to_latent(q, k, v):
    """On a CUDA tensor: the Function when autograd records, else the
    stats-free launch.  On a CPU tensor: the plain version."""
    if kernel_route(q):
        if wants_graph(q, k, v):
            return GridToLatentFunction.apply(q, k, v)
        return grid_to_latent_cuda(q, k, v)
    return attention_plain(q, k, v)


def latent_to_grid(q, k, v):
    """On a CUDA tensor: the Function when autograd records, else the
    stats-free launch.  On a CPU tensor: the plain version."""
    if kernel_route(q):
        if wants_graph(q, k, v):
            return LatentToGridFunction.apply(q, k, v)
        return latent_to_grid_cuda(q, k, v)
    return attention_plain(q, k, v)


def fused_multihead_attention(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              num_heads: int = 1) -> torch.Tensor:
    """Head-folding wrapper: [N, Lq, D] x [N, Lk, D] x [N, Lk, Dv] ->
    [N, Lq, Dv], picking the kernel by which side is the grid."""
    n, lq, d = q.shape
    _, lk, dv = v.shape
    assert d % num_heads == 0 and dv % num_heads == 0
    dh, dvh = d // num_heads, dv // num_heads

    def fold(t, dim):
        return (t.reshape(n, t.shape[1], num_heads, dim).transpose(1, 2)
                .reshape(n * num_heads, t.shape[1], dim))

    qf, kf, vf = fold(q, dh), fold(k, dh), fold(v, dvh)
    if lq >= lk:       # grid queries, latent keys: softmax over tiny Lk
        of = grid_to_latent(qf, kf, vf)
    else:              # latent queries, grid keys: softmax over long Lk
        of = latent_to_grid(qf, kf, vf)
    return of.reshape(n, num_heads, lq, dvh).transpose(1, 2).reshape(
        n, lq, dv)
