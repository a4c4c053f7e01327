"""The attention kernels (``csrc/attention.cu``, ``csrc/attention_bwd.cu``),
their ``autograd.Function``s, and the head-folding wrapper that picks
between the two directions.

Replaces ``gansformer_tpu/ops/pallas_attention.py``:

* ``grid_to_latent`` <- ``_grid_to_latent_fwd`` -> ``pl.pallas_call``
  (body ``_grid_to_latent_kernel``): grid rows attend to the k <= 64
  latents; softmax over the tiny axis, every row independent.  In bf16
  with D and Dv multiples of 64 (every preset launch) a tensor-core
  kernel (``g2l_path``: K and V resident in shared memory, 16 query rows
  a warp, mma.sync); else the CUDA-core kernel.
* ``latent_to_grid`` <- ``_latent_to_grid_fwd`` -> ``pl.pallas_call``
  (bodies ``_latent_to_grid_kernel``/``_nostats``): latents attend over the
  n grid positions; the TPU's sequential online-softmax carry becomes a
  split over n into spans (fp32 partials per span, a fixed-order combine
  kernel; one span writes o itself), because Hopper blocks run in no
  order.  In bf16 with L <= 32 and D, Dv multiples of 64 up to 512 (every
  preset launch) a tensor-core kernel (``l2g_plan``: K and V tiles
  through a cp.async ring, logits and the mix on mma.sync, the online
  softmax per block in fp32); else the CUDA-core kernels on 256-key
  chunks.
* ``grid_to_latent_bwd_cuda`` <- ``_grid_to_latent_bwd`` ->
  ``pl.pallas_call`` (body ``_grid_to_latent_bwd_kernel``): P rebuilt from
  ``lse``, delta = rowsum(dP * P) inside the kernel, dq per row, dk/dv
  summed over n.  In bf16 with L <= 32 and D, Dv multiples of 64 up to
  512 (every preset launch) a tensor-core kernel (``g2l_bwd_plan``: K and
  V resident, q and do tiles through a cp.async ring, read once; dK and
  dV in registers across a span of tiles, fp32 partials and a
  fixed-order reduce only where n splits into spans); else the CUDA-core
  kernel on 64-row chunks, each writing partials.
* ``latent_to_grid_bwd_cuda`` <- ``_latent_to_grid_bwd`` ->
  ``pl.pallas_call`` (body ``_latent_to_grid_bwd_kernel``): the
  FlashAttention backward with delta = rowsum(do * o) computed here, in
  torch, outside the kernel (as the JAX package computes it outside its
  ``pallas_call``); dk/dv per key, dq summed over n the same way.  The
  same routes as the forward (``l2g_plan(..., bwd=True)``): on the
  tensor cores K and V are read once, S, dP, dV, dK and dq on mma.sync.

The latent->grid kernels and the backward of both are bound by bytes
(16-26 operations a byte at L = 16, against the card's ~295), so
``mma.sync`` serves where ``wgmma`` would buy nothing.  The TPU kernels
keep P (and dS) in fp32 in their products; the tensor cores round
operands to bf16, so P and dS enter them as hi + lo bf16 terms (two
products): one rounding would move o by ~1e-4 and dq, dk, dv by ~2e-3 of
their max, a rounding point the TPU kernels lack
(``tests/test_torch_l2g_plan.py`` and ``tests/test_torch_g2l_bwd_plan.py``
pin it).

The forwards write the fp32 row statistic ``lse`` only when asked
(``with_stats``): the Functions ask, the serving path (no graph wanted)
does not, as the TPU's no-grad path declares no ``lse`` output.  All
four are bound by bytes on the card: the flops per byte are a few dozen
at most.

Where the backward is itself differentiated (R1 through D's attention),
the backward launch is ``GridToLatentGradsFunction`` /
``LatentToGridGradsFunction``: kernel 8 / 9 as a function of (q, k, v,
do), whose own backward is the second order.  The JAX package takes that
through its jnp references (``_g2l_grads_jvp``, ``_l2g_grads_jvp``), no
Pallas kernel, so here it is torch ops by design
(``attention_bwd_vjp_plain``), counted per direction in
``second_order_g2l`` / ``second_order_l2g``; a third derivative raises.
With no graph wanted they run their forward alone: the same launch.
``fused_multihead_attention`` keeps the Pallas wrapper's rule: ``lq >=
lk`` takes grid_to_latent, so at res 4 (n = 16 = k) both duplex phases
do, forward and backward.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.autograd.function import once_differentiable

from gansformer_tpu_torch.core.device import kernel_route, wants_graph
from gansformer_tpu_torch.ops import _build
from gansformer_tpu_torch.ops.attention import (attention_bwd_vjp_plain,
                                                attention_delta,
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
# Second-order passes (torch ops, no launch) since the last reset.
second_order_g2l = 0
second_order_l2g = 0

MAX_LATENTS = 64

# grid_to_latent's routes (csrc/attention.cu g2l_path), and launches by
# route since the last reset.  The tensor-core route's shape: 4 warps of
# 16 query rows, q streamed in 64-column chunks through 3 ring slots of
# 2 KB a warp plus a 2 KB output slot, the latents padded to 16, 32 or
# 64.  These mirror the kernel's constants (kMmaWarps, kQStages, kQChunk,
# kSms); tests/test_torch_g2l_plan.py holds them to the source, and
# chip_smoke.py the built library's plan to this one.
G2L_SIMT, G2L_MMA = 0, 1
G2L_NAMES = {G2L_SIMT: "simt", G2L_MMA: "mma"}
g2l_path_launches = dict.fromkeys(G2L_NAMES, 0)
G2L_WARPS = 4
G2L_STAGES = 3
G2L_CHUNK = 64
G2L_SLOT = 16 * G2L_CHUNK * 2
G2L_SIMT_ROWS = 128
G2L_SIMT_WARPS = 8
SMS = 132


def g2l_lp(l: int) -> int:
    """The latents padded to the tensor-core route's bucket."""
    return 16 if l <= 16 else (32 if l <= 32 else 64)


def _g2l_mma_smem(l: int, d: int, dv: int) -> int:
    return g2l_lp(l) * (d + dv) * 2 + G2L_WARPS * (G2L_STAGES + 1) * G2L_SLOT


def g2l_path(dtype: torch.dtype, l: int, d: int, dv: int) -> int:
    """The tensor-core route for bf16 with D and Dv multiples of 64 whose
    K, V and ring fit in shared memory; else the CUDA-core route."""
    if (dtype == torch.bfloat16 and 1 <= l <= MAX_LATENTS and d > 0
            and dv > 0 and d % G2L_CHUNK == 0 and dv % G2L_CHUNK == 0
            and _g2l_mma_smem(l, d, dv) <= _build.SMEM_LIMIT):
        return G2L_MMA
    return G2L_SIMT


def g2l_smem(path: int, l: int, d: int, dv: int) -> int:
    """Dynamic shared memory of a launch: K and V in bf16 padded to the
    bucket, and the warps' ring and output slots (tensor cores); K, V, a
    q row a warp and a probability row a warp in fp32 (CUDA cores)."""
    if path == G2L_MMA:
        return _g2l_mma_smem(l, d, dv)
    return 4 * (l * d + l * dv + G2L_SIMT_WARPS * d
                + G2L_SIMT_WARPS * MAX_LATENTS)


def g2l_tiles_per_warp(b: int, n: int) -> int:
    """16-row tiles each warp of a tensor-core block takes in turn: 1
    while the grid has fewer than two blocks an SM, up to 4."""
    blocks = b * -(-n // (16 * G2L_WARPS))
    return max(1, min(4, blocks // (2 * SMS)))


@functools.lru_cache(maxsize=None)
def _g2l_route(dtype: torch.dtype, l: int, d: int, dv: int) -> int:
    """The route of a launch, its shared memory checked (a launch shape
    repeats every call: worked out once)."""
    path = g2l_path(dtype, l, d, dv)
    _build.check_smem(g2l_smem(path, l, d, dv),
                      f"grid_to_latent K/V of {l}x({d}+{dv})")
    return path


def g2l_rows_per_block(path: int, b: int, n: int) -> int:
    if path == G2L_MMA:
        return 16 * G2L_WARPS * g2l_tiles_per_warp(b, n)
    return G2L_SIMT_ROWS


# latent_to_grid's routes, forward and backward (csrc/attention.cu
# l2g_path, csrc/attention_bwd.cu l2g_bwd_path), grid_to_latent
# backward's (attention_bwd.cu g2l_bwd_path), and launches by route since
# the last reset.  The tensor-core kernels' tiling of the grid side (keys
# of latent->grid, rows of the grid->latent backward) mirrors
# csrc/hopper.cuh key_tiling (kKeyWarps, kKeyMinStages, kKeyMaxStages,
# kKeySpanBytes, kKeyOneSpanTiles, kKeyPad, kKeyMaxLp, kKeyMaxCols,
# kKeySms); the CUDA-core routes' chunks are csrc/attention.cu kChunk and
# attention_bwd.cu kRows (both backward directions).
# tests/test_torch_l2g_plan.py and tests/test_torch_g2l_bwd_plan.py hold
# these to the sources, and chip_smoke.py the built library's plans to
# these.
L2G_SIMT, L2G_MMA = 0, 1
L2G_NAMES = {L2G_SIMT: "simt", L2G_MMA: "mma"}
l2g_path_launches = dict.fromkeys(L2G_NAMES, 0)
l2g_bwd_path_launches = dict.fromkeys(L2G_NAMES, 0)
g2l_bwd_path_launches = dict.fromkeys(G2L_NAMES, 0)
KEY_WARPS = 8
KEY_MIN_STAGES = 3
KEY_MAX_STAGES = 4
KEY_SPAN_BYTES = 262144
KEY_ONE_SPAN_TILES = 8
KEY_PAD = 8
KEY_MAX_LP = 32
KEY_MAX_COLS = 512
L2G_SIMT_CHUNK = 256
L2G_BWD_SIMT_ROWS = 64
L2G_SIMT_WARPS = 8


def key_lp(l: int) -> int:
    """The latents padded to the tensor-core kernels' bucket."""
    return 16 if l <= 16 else 32


def _l2g_mma_fixed(lp: int, kt: int, d: int) -> int:
    """Forward shared memory beside the ring: Q, the logits, P as hi +
    lo, three per-latent rows."""
    return lp * d * 2 + lp * kt * 4 + 2 * lp * (kt + KEY_PAD) * 2 + 3 * lp * 4


def _l2g_bwd_mma_fixed(lp: int, kt: int, d: int, dv: int) -> int:
    """Backward shared memory beside the ring: Q and dO, the warps'
    staging tiles, P^T and dS^T hi + lo, dS hi + lo, lse and delta."""
    return (lp * (d + dv) * 2 + KEY_WARPS * 2048
            + 4 * kt * (lp + KEY_PAD) * 2 + 2 * lp * (kt + KEY_PAD) * 2
            + 2 * lp * 4)


def _g2l_bwd_mma_fixed(lp: int, kt: int, d: int, dv: int) -> int:
    """grid->latent backward shared memory beside the ring: K and V, the
    warps' S and dP parts (the dq staging tiles reuse them), P and dS hi
    + lo."""
    return (lp * (d + dv) * 2 + KEY_WARPS * 128 * lp
            + 4 * kt * (lp + KEY_PAD) * 2)


def key_shape_ok(dtype: torch.dtype, l: int, d: int, dv: int) -> bool:
    """The launches the tensor-core kernels of the grid side take: bf16,
    L <= 32, D and Dv multiples of 64 up to 512."""
    return (dtype == torch.bfloat16 and 1 <= l <= KEY_MAX_LP and d > 0
            and dv > 0 and d % 64 == 0 and dv % 64 == 0
            and d <= KEY_MAX_COLS and dv <= KEY_MAX_COLS)


def key_tiling(fixed, key_bytes: int, b: int, n: int):
    """(keys a tile, tiles a span, spans, ring stages, shared memory), or
    None where no tile size leaves KEY_MIN_STAGES slots: the largest of
    64, 32, 16 keys whose ring fits beside ``fixed(kt)`` bytes with at
    least KEY_MIN_STAGES (at most KEY_MAX_STAGES) slots; spans fill the
    card at one block an SM, each at least KEY_SPAN_BYTES of K and V, and
    a batch entry of at most KEY_ONE_SPAN_TILES tiles is one span."""
    for kt in (64, 32, 16):
        stage, f = kt * key_bytes, fixed(kt)
        if f >= _build.SMEM_LIMIT:
            continue
        stages = min(KEY_MAX_STAGES, (_build.SMEM_LIMIT - f) // stage)
        if stages >= KEY_MIN_STAGES:
            break
    else:
        return None
    tiles = -(-n // kt)
    spans_max = max(1, SMS // b)
    tps = min(tiles, max(-(-tiles // spans_max),
                         -(-KEY_SPAN_BYTES // stage)))
    if tiles <= KEY_ONE_SPAN_TILES:
        tps = tiles
    return kt, tps, -(-tiles // tps), stages, f + stages * stage


def l2g_plan(dtype: torch.dtype, b: int, n: int, l: int, d: int, dv: int,
             bwd: bool = False):
    """(path, LP, keys a tile, tiles a span, spans, ring stages, shared
    memory) of a latent_to_grid launch, forward or backward: the
    tensor-core kernel for bf16 with L <= 32 and D, Dv multiples of 64 up
    to 512, else the CUDA-core kernel (its chunk as the tile, one tile a
    span, LP and stages 0)."""
    if key_shape_ok(dtype, l, d, dv):
        lp = key_lp(l)
        fixed = ((lambda kt: _l2g_bwd_mma_fixed(lp, kt, d, dv)) if bwd
                 else (lambda kt: _l2g_mma_fixed(lp, kt, d)))
        t = key_tiling(fixed, (d + dv) * 2, b, n)
        if t is not None:
            return (L2G_MMA, lp) + t
    if bwd:
        smem = 4 * (l * (d + dv) + l * L2G_BWD_SIMT_ROWS
                    + L2G_SIMT_WARPS * (d + dv)
                    + L2G_SIMT_WARPS * 2 * MAX_LATENTS)
        return (L2G_SIMT, 0, L2G_BWD_SIMT_ROWS, 1,
                -(-n // L2G_BWD_SIMT_ROWS), 0, smem)
    smem = 4 * (l * d + l * L2G_SIMT_CHUNK + L2G_SIMT_WARPS * d)
    return (L2G_SIMT, 0, L2G_SIMT_CHUNK, 1, -(-n // L2G_SIMT_CHUNK), 0, smem)


def g2l_bwd_plan(dtype: torch.dtype, b: int, n: int, l: int, d: int,
                 dv: int):
    """(path, LP, rows a tile, tiles a span, spans, ring stages, shared
    memory) of a grid_to_latent backward launch: the tensor-core kernel
    at ``key_shape_ok`` (the n grid rows tiled as latent->grid tiles its
    keys), else the CUDA-core kernel (its 64-row chunk as the tile, one
    tile a span, LP and stages 0)."""
    if key_shape_ok(dtype, l, d, dv):
        lp = key_lp(l)
        t = key_tiling(lambda kt: _g2l_bwd_mma_fixed(lp, kt, d, dv),
                       (d + dv) * 2 + 4, b, n)
        if t is not None:
            return (G2L_MMA, lp) + t
    rows = L2G_BWD_SIMT_ROWS
    smem = 4 * (l * (d + dv) + 2 * rows * l + L2G_SIMT_WARPS * (d + dv))
    return (G2L_SIMT, 0, rows, 1, -(-n // rows), 0, smem)


@functools.lru_cache(maxsize=None)
def _g2l_bwd_route(dtype: torch.dtype, b: int, n: int, l: int, d: int,
                   dv: int):
    """The plan of a grid_to_latent backward launch, its shared memory
    checked (worked out once per launch shape)."""
    plan = g2l_bwd_plan(dtype, b, n, l, d, dv)
    _build.check_smem(plan[6], f"grid_to_latent backward of {l}x({d}+{dv})")
    return plan


@functools.lru_cache(maxsize=None)
def _l2g_route(dtype: torch.dtype, b: int, n: int, l: int, d: int, dv: int,
               bwd: bool):
    """The plan of a launch, its shared memory checked (worked out once
    per launch shape)."""
    plan = l2g_plan(dtype, b, n, l, d, dv, bwd)
    _build.check_smem(plan[6], f"latent_to_grid{' backward' if bwd else ''}"
                      f" of {l}x({d}+{dv})")
    return plan


def _aligned(*ts):
    """The tensors, each cloned where its address is not a multiple of
    16 bytes (the tensor-core kernels copy 16 bytes at a time)."""
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in ts)


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
    path = _g2l_route(q.dtype, l, d, dv)
    if path == G2L_MMA:
        q, k, v = _aligned(q, k, v)
    lib = _build.load_library()
    o = torch.empty((b, n, dv), dtype=v.dtype, device=v.device)
    lse = _stats(q, n, with_stats)
    rc = lib.gt_grid_to_latent(
        path, _build.dtype_code(q), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), _ptr(lse), b, n, l, d, dv,
        1.0 / math.sqrt(d), _build.stream_ptr(q))
    if rc:
        _build.check(rc, f"grid_to_latent kernel ({G2L_NAMES[path]})")
    launches_g2l += 1
    g2l_path_launches[path] += 1
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
    path, _, _, _, spans, _, _ = _l2g_route(q.dtype, b, n, l, d, dv, False)
    if path == L2G_MMA:
        q, k, v = _aligned(q, k, v)
    lib = _build.load_library()
    o = torch.empty((b, l, dv), dtype=v.dtype, device=v.device)
    lse = _stats(q, l, with_stats)
    m_part = s_part = acc_part = None
    if path == L2G_SIMT or spans > 1:
        f32 = dict(dtype=torch.float32, device=q.device)
        m_part = torch.empty((b, spans, l), **f32)
        s_part = torch.empty((b, spans, l), **f32)
        acc_part = torch.empty((b, spans, l, dv), **f32)
    rc = lib.gt_latent_to_grid(
        path, _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), _ptr(lse), _ptr(m_part), _ptr(s_part), _ptr(acc_part),
        b, n, l, d, dv, 1.0 / math.sqrt(d), _build.stream_ptr(q))
    if rc:
        _build.check(rc, f"latent_to_grid kernel ({L2G_NAMES[path]})")
    launches_l2g += 1
    l2g_path_launches[path] += 1
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
    path, _, _, _, spans, _, _ = _g2l_bwd_route(q.dtype, b, n, l, d, dv)
    if path == G2L_MMA:
        q, k, v, do = _aligned(q, k, v, do)
    lib = _build.load_library()
    dk_part = dv_part = None
    if path == G2L_SIMT or spans > 1:
        f32 = dict(dtype=torch.float32, device=q.device)
        dk_part = torch.empty((b, spans, l, d), **f32)
        dv_part = torch.empty((b, spans, l, dv), **f32)
    dq, dk, dvv = (torch.empty_like(q), torch.empty_like(k),
                   torch.empty_like(v))
    rc = lib.gt_grid_to_latent_bwd(
        path, _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dvv.data_ptr(), _ptr(dk_part), _ptr(dv_part), b, n, l, d, dv,
        1.0 / math.sqrt(d), _build.stream_ptr(q))
    if rc:
        _build.check(rc, f"grid_to_latent backward kernel "
                     f"({G2L_NAMES[path]})")
    launches_g2l_bwd += 1
    g2l_bwd_path_launches[path] += 1
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
    path, _, _, _, spans, _, _ = _l2g_route(q.dtype, b, n, l, d, dv, True)
    if path == L2G_MMA:
        q, k, v, do = _aligned(q, k, v, do)
    lib = _build.load_library()
    dq_part = (torch.empty((b, spans, l, d), dtype=torch.float32,
                           device=q.device)
               if path == L2G_SIMT or spans > 1 else None)
    dq, dk, dvv = (torch.empty_like(q), torch.empty_like(k),
                   torch.empty_like(v))
    rc = lib.gt_latent_to_grid_bwd(
        path, _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), do.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dvv.data_ptr(), _ptr(dq_part), b, n, l, d, dv,
        1.0 / math.sqrt(d), _build.stream_ptr(q))
    if rc:
        _build.check(rc, f"latent_to_grid backward kernel "
                     f"({L2G_NAMES[path]})")
    launches_l2g_bwd += 1
    l2g_bwd_path_launches[path] += 1
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
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        return GridToLatentGradsFunction.apply(q, k, v, do, lse)


class GridToLatentGradsFunction(torch.autograd.Function):
    """(dq, dk, dv) of grid_to_latent by kernel 8, differentiable in (q,
    k, v, do): the backward is the plain second order, lse rebuilt from q
    and k (the saved ``lse`` enters the launch only)."""

    @staticmethod
    def forward(ctx, q, k, v, do, lse):
        ctx.save_for_backward(q, k, v, do)
        return grid_to_latent_bwd_cuda(q, k, v, lse, do)

    @staticmethod
    @once_differentiable
    def backward(ctx, gdq, gdk, gdv):
        global second_order_g2l
        second_order_g2l += 1
        return attention_bwd_vjp_plain(*ctx.saved_tensors, gdq, gdk, gdv,
                                       delta_from_o=False) + (None,)


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
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return LatentToGridGradsFunction.apply(q, k, v, do, o.detach(), lse)


class LatentToGridGradsFunction(torch.autograd.Function):
    """(dq, dk, dv) of latent_to_grid by kernel 9, differentiable in (q,
    k, v, do): the backward is the plain second order, o and lse rebuilt
    from q, k and v (the saved ones enter the launch and delta only)."""

    @staticmethod
    def forward(ctx, q, k, v, do, o, lse):
        ctx.save_for_backward(q, k, v, do)
        return latent_to_grid_bwd_cuda(q, k, v, lse, do,
                                       attention_delta(o, do))

    @staticmethod
    @once_differentiable
    def backward(ctx, gdq, gdk, gdv):
        global second_order_l2g
        second_order_l2g += 1
        return attention_bwd_vjp_plain(*ctx.saved_tensors, gdq, gdk, gdv,
                                       delta_from_o=True) + (None, None)


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
