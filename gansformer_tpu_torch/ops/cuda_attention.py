"""The two attention kernels (``csrc/attention.cu``) and the head-folding
wrapper that picks between them.

Replaces ``gansformer_tpu/ops/pallas_attention.py``:

* ``grid_to_latent`` <- ``_grid_to_latent_fwd`` -> ``pl.pallas_call``
  (body ``_grid_to_latent_kernel``): grid rows attend to the k <= 64
  latents; softmax over the tiny axis, every row independent.
* ``latent_to_grid`` <- ``_latent_to_grid_fwd`` -> ``pl.pallas_call``
  (bodies ``_latent_to_grid_kernel``/``_nostats``): latents attend over the
  n grid positions; the TPU's sequential online-softmax carry becomes a
  split over n (fp32 partials per chunk) and a combine kernel, because
  Hopper blocks run in no order.

The serving path declares no ``lse`` output (as the TPU's no-grad path).
Both are bound by bytes on the card: q (or k and v) is read once, the
output written once, and the flops per byte are a few dozen at most.
``fused_multihead_attention`` keeps the Pallas wrapper's rule: ``lq >= lk``
takes grid_to_latent, so at res 4 (n = 16 = k) both duplex phases do.
"""

from __future__ import annotations

import math

import torch

from gansformer_tpu_torch.core.device import kernel_route
from gansformer_tpu_torch.ops import _build
from gansformer_tpu_torch.ops.attention import attention_plain

# Launches since the last reset: one per grid_to_latent call, one per
# latent_to_grid call (its partial and combine kernels together).
launches_g2l = 0
launches_l2g = 0

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


def grid_to_latent_cuda(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """softmax over the latent axis: q [B, n, D], k [B, L, D], v [B, L, Dv]."""
    global launches_g2l
    q, k, v = _check(q, k, v)
    b, n, d = q.shape
    l, dv = v.shape[1], v.shape[2]
    if l > MAX_LATENTS:
        raise ValueError(f"grid_to_latent takes at most {MAX_LATENTS} keys, "
                         f"got {l}")
    lib = _build.load_library()
    if lib.gt_g2l_smem(l, d, dv) > SMEM_LIMIT:
        raise ValueError(f"K/V of {l}x({d}+{dv}) exceed shared memory")
    o = torch.empty((b, n, dv), dtype=v.dtype, device=v.device)
    rc = lib.gt_grid_to_latent(
        _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), b, n, l, d, dv, 1.0 / math.sqrt(d),
        _build.stream_ptr(q))
    _build.check(rc, "grid_to_latent kernel")
    launches_g2l += 1
    return o


def latent_to_grid_cuda(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """softmax over the grid axis: q [B, L, D], k [B, n, D], v [B, n, Dv]."""
    global launches_l2g
    q, k, v = _check(q, k, v)
    b, l, d = q.shape
    n, dv = v.shape[1], v.shape[2]
    if l > MAX_LATENTS:
        raise ValueError(f"latent_to_grid takes at most {MAX_LATENTS} "
                         f"queries, got {l}")
    lib = _build.load_library()
    if lib.gt_l2g_smem(l, d) > SMEM_LIMIT:
        raise ValueError(f"Q of {l}x{d} exceeds shared memory")
    chunks = -(-n // lib.gt_attn_chunk())
    f32 = dict(dtype=torch.float32, device=q.device)
    m_part = torch.empty((b, chunks, l), **f32)
    s_part = torch.empty((b, chunks, l), **f32)
    acc_part = torch.empty((b, chunks, l, dv), **f32)
    o = torch.empty((b, l, dv), dtype=v.dtype, device=v.device)
    rc = lib.gt_latent_to_grid(
        _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), m_part.data_ptr(), s_part.data_ptr(),
        acc_part.data_ptr(), b, n, l, d, dv, 1.0 / math.sqrt(d),
        _build.stream_ptr(q))
    _build.check(rc, "latent_to_grid kernel")
    launches_l2g += 1
    return o


def grid_to_latent(q, k, v):
    """Kernel on a CUDA tensor, plain version on a CPU tensor."""
    if kernel_route(q):
        return grid_to_latent_cuda(q, k, v)
    return attention_plain(q, k, v)


def latent_to_grid(q, k, v):
    """Kernel on a CUDA tensor, plain version on a CPU tensor."""
    if kernel_route(q):
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
