"""Launch wrappers of the modulated-conv kernels: the forward
(``csrc/modconv.cu``) and the two backward kernels
(``csrc/modconv_bwd.cu``).

``modconv_cuda`` replaces ``gansformer_tpu/ops/pallas_modconv.py``
``_fwd_call`` -> ``pl.pallas_call`` (kernel body ``_fwd_body``), kinds
``same3`` (every synthesis 3x3 conv), ``same1`` (tRGB) and ``poly``
(every up-conv, weights from ``_poly_w4``, phases interleaved inside the
kernel).  Bound on the card: operations for the 3x3 convs and up-convs
(hundreds of flops per byte at 128-512 channels, above Hopper's ~295
flops/byte ridge in bf16), the bytes of x for the 3-channel tRGB.  Each
launch takes one of three paths (``fwd_path``).  bf16 3x3 and up-convs:
wgmma with A from registers, fed by TMA through a ring of 7-9
shared-memory slots (a producer thread fills it, two consumer
warpgroups drain it, one wgmma group in flight); the style scales each
pixel row's channels (its own sample's s, so a tile may span samples)
and rounds to bf16 where ``_ref_core`` rounds, one weight tile serves
the batch, d and the epilogue are applied in fp32; tiles of 128 pixels
x 64 or 128 columns (``fwd_tile``), the contraction in stages of 64
channels x one tap, chunk-major, split over blocks where the tiles alone
would leave the card half idle (``fwd_split``: fp32 partials and a
fixed-order reduce).  bf16 tRGB (CoK <= 4): a small-K kernel that reads
x once, 16 bytes a thread.  fp32 (and any other shape): FMA kernels with
64 x 64 tiles.

``modconv_dx_cuda`` replaces ``_bwd_call`` -> ``pl.pallas_call`` (body
``_bwd_body``): dx = s * u and ds = sum_hw x * u with u the transposed
conv of the cotangent, d folded into the weights once per sample and
rounded where ``_bwd_body`` rounds it; ds goes through per-tile fp32
partials and a fixed-order second pass.  ``modconv_dw_cuda`` replaces
``_dw_call`` -> ``pl.pallas_call`` (body ``_dw_body``): the per-tap
weight gradient, split along (sample, pixel) units cut at sample
boundaries (``dw_split``) so the long contraction fills the card, with
the rank-1 scale s_n (x) d_n applied in fp32 to each sample's product and
a fixed-order reduce of the fp32 partials.  Bound: the forward's
multiply-adds (dw, and dx/ds at 512 channels) or the bytes of du, x and
dx (dx/ds at 64-128 channels).  Each launch takes one of three paths
(``bwd_path``).  bf16 3x3 and up-convs: wgmma fed by TMA through a ring
of 3-5 shared-memory slots (a producer warp fills it, two consumer
warpgroups drain it), 128 x 128 tiles where the channels reach 128
(``dx_tile``, ``dw_tile``), the dynamic shared memory of ``bwd_smem``
opted in per kernel.  bf16 tRGB (CoK = 3): small-K kernels bound by the
bytes of x and dx.  fp32: FMA kernels with 64 x 64 tiles.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from gansformer_tpu_torch.ops import _build

# Launches since the last reset: forward, dx/ds and dw calls, and of
# them those made for the core's second order (``second_order``).
launches = 0
launches_dx = 0
launches_dw = 0
launches_second_order = 0

# The backward kernels' tiles (csrc/modconv_bwd.cu): pixels per dx tile
# and per ds partial on the wgmma path and the cotangent channels of one
# dx stage, 64 x 64 FMA tiles, the pixels of one dw stage (128 on the
# wgmma path but for its 64 x 64 tile), the rows of the image a dw stage
# must tile, and the ring's slots; the small-K path's bounds and tiles.
DX_TILE = 128
DX_STAGE_K = 64
FMA_TILE = 64
DW_STAGE_PIXELS = 64
DW_WIDE_STAGE_PIXELS = 128
DW_ROWS = 128
# ring slots by (kernel, tile[, dw stage pixels]): within 227 KB; the
# 64-wide dx tile takes three so that more blocks share an SM
STAGES = {("dx", 64): 3, ("dx", 128): 5, ("dw", 64, 64, 64): 4,
          ("dw", 64, 128, 64): 5, ("dw", 128, 64, 64): 5,
          ("dw", 128, 128, 64): 5, ("dw", 64, 128, 128): 4,
          ("dw", 128, 64, 128): 4, ("dw", 128, 128, 128): 3}
SMALL_K = 4               # cotangent channels of the small-K path, at most
SMALL_TILE = 256          # pixels per small-K dx tile
# dw split-K: the blocks per SM the split aims for (wgmma; the FMA and
# small-K kernels, on the CUDA cores), and the least number of pixels a
# wgmma split keeps.
DW_BLOCKS_PER_SM = 2
SIMT_BLOCKS_PER_SM = 4
DW_MIN_PIXELS = 1024

# Tap offsets (dy, dx) relative to the output pixel, in input coordinates;
# tap t reads weight slab t of the stacked [T, Ci, Co*phases] weights.
TAPS = {
    "same3": tuple((a - 1, b - 1) for a in range(3) for b in range(3)),
    "same1": ((0, 0),),
    "poly": ((0, 0), (0, 1), (1, 0), (1, 1)),
}
PHASES = {"same3": 1, "same1": 1, "poly": 4}

_ACT_CODES = {None: 0, "linear": 1, "lrelu": 2}


# The forward's paths (csrc/modconv.cu), numbered as the backward's.
PATH_FMA, PATH_WGMMA, PATH_SMALLK = 0, 1, 2
# The forward kernels' tiles: 128 pixels of the flattened [N * H * W] on
# the wgmma path (64 or 128 columns), in stages of 64 input channels x one
# tap through a ring of 9 slots (7 for the 128-wide tile), which the
# epilogue's fp32 tile reuses; 256 pixels a small-K block; 64 x 64 FMA
# tiles.  A split keeps at least FWD_MIN_SPLIT_STAGES stages.  These and
# fwd_tile_fits / fwd_path are the kernel's own plan (csrc/modconv.cu:
# kFwdBM, kFwdBK, fwd_stages, kSmall*, tile_fits, path_fits) and change
# with it: tests/test_torch_modconv_fwd_plan.py holds the constants to
# the source, chip_smoke.py the built library's tile and shared memory.
FWD_TILE = 128
FWD_STAGE_K = 64
FWD_STAGES = {64: 9, 128: 7}    # ring slots by tile width
FWD_SMALL_TILE = 256
FWD_SMALL_PER = 2         # 16-byte chunks of x per small-K thread, at most
FWD_MIN_SPLIT_STAGES = 2
FWD_TILE_PIXELS = {PATH_FMA: FMA_TILE, PATH_WGMMA: FWD_TILE,
                   PATH_SMALLK: FWD_SMALL_TILE}


def fwd_tile_fits(h: int, w: int) -> bool:
    """True when 128 consecutive pixels of the flattened [N * H * W],
    starting at a multiple of 128, are one TMA box: a run of one row (W a
    multiple of 128), whole rows of one sample, or whole samples (W
    dividing 128 and H * W a multiple or a divisor of 128)."""
    if w <= 0 or h <= 0:
        return False
    if w >= FWD_TILE:
        return w % FWD_TILE == 0
    return FWD_TILE % w == 0 and (h * w % FWD_TILE == 0
                                  or FWD_TILE % (h * w) == 0)


def fwd_path(dtype: torch.dtype, h: int, w: int, ci: int, cok: int,
             phases: int, taps) -> int:
    """The path of a forward launch: wgmma for bf16 with ``ci`` a multiple
    of 8, 16-byte output rows (``cok`` a multiple of 8 x ``phases``) and a
    geometry whose 128-pixel tiles are TMA boxes (``fwd_tile_fits``); the
    small-K kernel for bf16 with at most ``SMALL_K`` output columns, one
    tap at offset 0 and ``ci`` read in whole 16-byte chunks by up to 32
    threads a pixel; else the FMA kernel."""
    if dtype == torch.bfloat16 and ci % 8 == 0:
        if cok % (8 * phases) == 0 and fwd_tile_fits(h, w):
            return PATH_WGMMA
        chunks = ci // 8
        if (phases == 1 and cok <= SMALL_K
                and ci <= 8 * 32 * FWD_SMALL_PER
                and (32 % chunks == 0 or chunks % 32 == 0)
                and tuple(map(tuple, taps)) == ((0, 0),)):
            return PATH_SMALLK
    return PATH_FMA


def fwd_tile(path: int, cok: int):
    """(pixels, columns) of one forward output tile on ``path``."""
    if path == PATH_WGMMA:
        return FWD_TILE, 128 if cok >= 128 else 64
    if path == PATH_SMALLK:
        return FWD_SMALL_TILE, cok
    return FMA_TILE, FMA_TILE


def fwd_smem(path: int, cok: int) -> int:
    """Dynamic shared memory of a forward launch: the ring's slots (the x
    tile of 128 pixels x 64 channels and the columns / 64 weight blocks of
    64 x 64, as 128-byte swizzled rows; the epilogue's fp32 tile of 128 x
    (columns + 4) reuses them) and 1 KB of slack to align the ring.  0 off
    the wgmma path, whose kernels' tiles are static."""
    if path != PATH_WGMMA:
        return 0
    _, bn = fwd_tile(path, cok)
    block = 64 * 128
    return FWD_STAGES[bn] * (FWD_TILE * FWD_STAGE_K * 2
                             + (bn // 64) * block) + 1024


def fwd_split(n: int, h: int, w: int, ci: int, cok: int, ntaps: int,
              sms: int, path: int = PATH_WGMMA) -> int:
    """P, the blocks each wgmma tile's contraction is split over: 1 where
    the tiles give at least half as many blocks as ``sms``; else enough
    splits for a block per SM, each keeping ``FWD_MIN_SPLIT_STAGES``
    stages of the taps x ceil(ci / 64) stages.  Split b takes stages
    [b * T / P, (b + 1) * T / P)."""
    if path != PATH_WGMMA:
        return 1
    bm, bn = fwd_tile(path, cok)
    tiles = -(-(n * h * w) // bm) * -(-cok // bn)
    stages = ntaps * -(-ci // FWD_STAGE_K)
    if 2 * tiles >= sms:
        return 1
    return max(1, min(-(-sms // tiles), stages // FWD_MIN_SPLIT_STAGES))


def fwd_split_stages(ci: int, ntaps: int, p: int, b: int):
    """(tap, first channel) of each stage of split ``b`` of ``p``, in the
    kernel's order."""
    kchunks = -(-ci // FWD_STAGE_K)
    stages = ntaps * kchunks
    return [(j % ntaps, (j // ntaps) * FWD_STAGE_K)
            for j in range(stages * b // p, stages * (b + 1) // p)]


@functools.lru_cache(maxsize=None)
def _fwd_plan(dtype: torch.dtype, n: int, h: int, w: int, ci: int,
              cok: int, phases: int, taps, sms: int):
    """(path, P) of a forward launch, its shared memory checked (a launch
    shape repeats every call: worked out once)."""
    path = fwd_path(dtype, h, w, ci, cok, phases, taps)
    _build.check_smem(fwd_smem(path, cok), "modconv forward")
    return path, fwd_split(n, h, w, ci, cok, len(taps), sms, path)


def modconv_cuda(x: torch.Tensor, wstack: torch.Tensor, s: torch.Tensor,
                 post: torch.Tensor, bias: Optional[torch.Tensor],
                 kind: str, act: Optional[str], alpha: float,
                 gain: float, second_order: bool = False) -> torch.Tensor:
    """Launch the kernel: ``post * conv(x * s, w)`` (+ epilogue) on CUDA
    NHWC ``x`` (fp32 or bf16) with stacked weights ``wstack`` [T, Ci, CoK],
    styles ``s`` [N, Ci] and per-column scales ``post`` [N, CoK] (fp32).
    ``second_order``: a launch of the core's second order (counted apart
    too)."""
    global launches, launches_second_order
    if not x.is_cuda:
        raise ValueError("modconv_cuda takes a CUDA tensor")
    if kind not in TAPS or act not in _ACT_CODES:
        raise ValueError(f"unsupported kind/epilogue {kind!r}/{act!r}")
    taps, phases = TAPS[kind], PHASES[kind]
    x = _aligned(x.contiguous())
    n, h, w, ci = x.shape
    t, wci, cok = wstack.shape
    if t != len(taps) or wci != ci or cok % phases:
        raise ValueError(f"weights {tuple(wstack.shape)} do not fit {kind} "
                         f"on input {tuple(x.shape)}")
    co = cok // phases
    up = 2 if phases == 4 else 1
    if wstack.dtype != x.dtype or wstack.device != x.device:
        wstack = wstack.to(device=x.device, dtype=x.dtype)
    wstack, s, post = _aligned(wstack.contiguous()), _f32(s, x), \
        _f32(post, x)
    if s.shape != (n, ci) or post.shape != (n, cok):
        raise ValueError(f"s {tuple(s.shape)} / post {tuple(post.shape)} "
                         f"!= ({n}, {ci}) / ({n}, {cok})")
    b = None
    if act is not None:
        b = (torch.zeros(co, device=x.device, dtype=torch.float32)
             if bias is None else _f32(bias, x))
        if b.shape != (co,):
            raise ValueError(f"bias {tuple(b.shape)} != ({co},)")
    path, p = _fwd_plan(x.dtype, n, h, w, ci, cok, phases, taps,
                        _sms(x.device.index))
    y = torch.empty((n, up * h, up * w, co), dtype=x.dtype, device=x.device)
    part = (torch.empty((p, n * h * w, cok), dtype=torch.float32,
                        device=x.device) if p > 1 else None)
    oy, ox = _taps_arrays(taps)
    with _build.on_device(x):
        rc = _build.load_library().gt_modconv(
            path, _build.dtype_code(x), x.data_ptr(), wstack.data_ptr(),
            s.data_ptr(), post.data_ptr(),
            b.data_ptr() if b is not None else None, y.data_ptr(),
            part.data_ptr() if part is not None else None, n, h, w, ci, cok,
            phases, len(taps), oy.ctypes.data, ox.ctypes.data, p,
            _ACT_CODES[act], float(alpha), float(gain), _build.stream_ptr(x))
    _build.check(rc, f"modconv kernel ({kind})")
    launches += 1
    launches_second_order += second_order
    return y


# The backward kernels' paths (csrc/modconv_bwd.cu) have the forward's
# numbers: the FMA kernels (fp32, or any shape), the wgmma kernels, and
# the small-K kernels of the 3-channel tRGB.
TILE_PIXELS = {PATH_FMA: FMA_TILE, PATH_WGMMA: DX_TILE,
               PATH_SMALLK: SMALL_TILE}


def bwd_path(which: str, dtype: torch.dtype, cok: int, ci: int, w: int,
             taps) -> int:
    """The path of a dx/ds (``which='dx'``) or dw launch: wgmma for bf16
    with channel counts ``cok`` and ``ci`` that are multiples of 8 and an
    image width ``w`` whose rows tile the pixels of one TMA box (whole
    rows of the image, or a run of one row); the small-K kernels for bf16
    at most ``SMALL_K`` cotangent channels and one tap at offset 0; else
    the FMA kernels."""
    if dtype == torch.bfloat16 and ci % 8 == 0:
        rows = DX_TILE if which == "dx" else DW_ROWS
        if cok % 8 == 0 and w > 0 and (w % rows == 0 if w >= rows
                                       else rows % w == 0):
            return PATH_WGMMA
        if cok <= SMALL_K and 256 % (ci // 8) == 0 and \
                tuple(map(tuple, taps)) == ((0, 0),):
            return PATH_SMALLK
    return PATH_FMA


def dx_tile(path: int, ci: int):
    """(pixels, channels) of one dx/ds output tile on ``path``; the pixels
    are also those one ds partial sums."""
    if path == PATH_WGMMA:
        return DX_TILE, 128 if ci >= 128 else 64
    return TILE_PIXELS[path], FMA_TILE if path == PATH_FMA else ci


def dw_tile(path: int, ci: int, cok: int):
    """(ci, CoK) of one dw output tile on ``path``."""
    if path == PATH_WGMMA:
        return 128 if ci >= 128 else 64, 128 if cok >= 128 else 64
    if path == PATH_SMALLK:
        return ci, cok
    return FMA_TILE, FMA_TILE


def bwd_smem(which: str, path: int, cok: int, ci: int, hw: int) -> int:
    """Dynamic shared memory of a dx/ds (``which='dx'``) or dw launch: the
    ring's slots of 128-byte swizzled tiles (blocks of 64 rows of 128
    bytes; dx's pixel tile is 128 rows of its 64 cotangent channels), and
    1 KB of slack to align the ring to its 1 KB atoms; 0 off the wgmma
    path, whose kernels' tiles are static."""
    if path != PATH_WGMMA:
        return 0
    block = 64 * 128
    if which == "dx":
        _, bn = dx_tile(path, ci)
        return (STAGES["dx", bn]
                * (DX_TILE * DX_STAGE_K * 2 + (bn // 64) * block) + 1024)
    bm, bn = dw_tile(path, ci, cok)
    bp = dw_stage_pixels(path, ci, cok, hw)
    return STAGES["dw", bm, bn, bp] * (bm // 64 + bn // 64) * bp * 128 + 1024


def dw_stage_pixels(path: int, ci: int, cok: int, hw: int) -> int:
    """Pixels of one dw stage: 128 on the wgmma path (half the ring round
    trips) where a sample has 128 pixels, but for the 64 x 64 tile; else
    64."""
    if path == PATH_WGMMA and dw_tile(path, ci, cok) != (64, 64) \
            and hw >= DW_WIDE_STAGE_PIXELS:
        return DW_WIDE_STAGE_PIXELS
    return DW_STAGE_PIXELS


def dx_tile_pixels(path: int) -> int:
    """Pixels each ds partial of a dx/ds launch on ``path`` sums (one dx
    tile), as the built library reports it."""
    return int(_build.load_library().gt_modconv_dx_tile(path))


@functools.lru_cache(maxsize=None)
def _taps_arrays(taps):
    """(dy, dx) int32 arrays of a tuple of tap offsets, for the library."""
    return (np.asarray([o[0] for o in taps], np.int32),
            np.asarray([o[1] for o in taps], np.int32))


@functools.lru_cache(maxsize=None)
def _dx_plan(dtype: torch.dtype, h: int, w: int, cok: int, ci: int, taps):
    """(path, pixel tiles) of a dx/ds launch, its shared memory checked
    (a launch shape repeats every step: worked out once)."""
    path = bwd_path("dx", dtype, cok, ci, w, taps)
    _build.check_smem(bwd_smem("dx", path, cok, ci, h * w),
                      "modconv dx/ds")
    return path, -(-(h * w) // TILE_PIXELS[path])


@functools.lru_cache(maxsize=None)
def _dw_plan(dtype: torch.dtype, n: int, h: int, w: int, ci: int, cok: int,
             taps, sms: int):
    """(path, S, R, P) of a dw launch, its shared memory checked."""
    path = bwd_path("dw", dtype, cok, ci, w, taps)
    _build.check_smem(bwd_smem("dw", path, cok, ci, h * w), "modconv dw")
    return (path,) + dw_split(n, h, w, ci, cok, len(taps), sms, path)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _f32(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if t.dtype != torch.float32 or t.device != like.device:
        t = t.to(device=like.device, dtype=torch.float32)
    return _aligned(t.contiguous())


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` at a 16-byte aligned address (what TMA and the 16-byte loads
    need; a view into a larger tensor may start anywhere)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def modconv_dx_cuda(du4: torch.Tensor, wT: torch.Tensor, pre: torch.Tensor,
                    post: torch.Tensor, x: torch.Tensor, taps,
                    second_order: bool = False):
    """Launch the dx/ds kernel: cotangent ``du4`` [N,H,W,CoK], adjoint
    weights ``wT`` [T,CoK,Ci], ``pre`` = d [N,CoK] and ``post`` = s
    [N,Ci] (fp32), ``x`` [N,H,W,Ci]; ``taps`` are the adjoint's offsets
    relative to the output pixel.  Returns (dx in x's dtype, ds fp32).
    ``second_order``: a launch of the core's second order."""
    global launches_dx, launches_second_order
    if not (du4.is_cuda and x.is_cuda):
        raise ValueError("modconv_dx_cuda takes CUDA tensors")
    du4, x = _aligned(du4.contiguous()), _aligned(x.contiguous())
    if du4.dtype != x.dtype:
        raise TypeError(f"dtypes differ: {du4.dtype} {x.dtype}")
    n, h, w, cok = du4.shape
    t, wk, ci = wT.shape
    if x.shape != (n, h, w, ci) or wk != cok or t != len(taps):
        raise ValueError(f"du {tuple(du4.shape)}, wT {tuple(wT.shape)}, x "
                         f"{tuple(x.shape)} and {len(taps)} taps do not fit")
    if wT.dtype != x.dtype or wT.device != x.device:
        wT = wT.to(device=x.device, dtype=x.dtype)
    wT, pre, post = _aligned(wT.contiguous()), _f32(pre, x), _f32(post, x)
    if pre.shape != (n, cok) or post.shape != (n, ci):
        raise ValueError(f"pre {tuple(pre.shape)} / post {tuple(post.shape)} "
                         f"!= ({n}, {cok}) / ({n}, {ci})")
    taps = tuple(map(tuple, taps))
    path, tiles = _dx_plan(x.dtype, h, w, cok, ci, taps)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    ds = torch.empty((n, ci), **f32)
    ds_part = torch.empty(n * tiles * ci, **f32)
    # the wgmma path's weights with d folded in, per sample [N, T, CoK, Ci]
    wtd = (torch.empty((n, t, cok, ci), dtype=x.dtype, device=x.device)
           if path == PATH_WGMMA else None)
    oy, ox = _taps_arrays(taps)
    with _build.on_device(x):
        rc = _build.load_library().gt_modconv_dx(
            path, _build.dtype_code(x), du4.data_ptr(), wT.data_ptr(),
            pre.data_ptr(), post.data_ptr(), x.data_ptr(), dx.data_ptr(),
            wtd.data_ptr() if wtd is not None else None, ds_part.data_ptr(),
            ds.data_ptr(), n, h, w, cok, ci, len(taps), oy.ctypes.data,
            ox.ctypes.data, _build.stream_ptr(x))
    _build.check(rc, "modconv dx/ds kernel")
    launches_dx += 1
    launches_second_order += second_order
    return dx, ds


def dw_split(n: int, h: int, w: int, ci: int, cok: int, ntaps: int,
             sms: int, path: int = PATH_WGMMA):
    """(S, R, P) of the dw launch: each sample's H * W pixels are cut into
    S units of R pixels (whole stages, ``dw_stage_pixels``) and split b
    of P takes units [b * N*S / P, (b + 1) * N*S / P).  The cut falls on
    sample boundaries: a split is one unit of one sample (S > 1) or a run
    of whole samples (S = 1, P dividing N), so each sample's scale s_n (x)
    d_n is applied once per split that sees it.  P is the least such count
    whose blocks (``dw_tile`` tiles x taps x P) fill ``sms`` SMs
    ``DW_BLOCKS_PER_SM`` (FMA: ``SIMT_BLOCKS_PER_SM``) times over, and no
    wgmma split keeps fewer than ``DW_MIN_PIXELS`` pixels where P > 1.
    The small-K path takes one unit per block, units of whole stages cut
    so that the blocks fill the SMs ``SIMT_BLOCKS_PER_SM`` times over."""
    hw = h * w
    if path == PATH_SMALLK:
        per = -(-(SIMT_BLOCKS_PER_SM * sms) // n)   # units per sample
        r = -(-hw // per)
        r = min(hw, -(-r // DW_STAGE_PIXELS) * DW_STAGE_PIXELS)
        s = -(-hw // r)
        return s, r, n * s
    bm, bn = dw_tile(path, ci, cok)
    tiles = -(-ci // bm) * -(-cok // bn) * ntaps
    stage = dw_stage_pixels(path, ci, cok, hw)
    stages = -(-hw // stage)
    per_sm = DW_BLOCKS_PER_SM if path == PATH_WGMMA else SIMT_BLOCKS_PER_SM
    want = max(1, -(-(per_sm * sms) // tiles))
    if path == PATH_WGMMA:
        want = max(1, min(want, n * hw // DW_MIN_PIXELS))
    if want <= n:
        p = min(d for d in range(1, n + 1) if n % d == 0 and d >= want)
        return 1, hw, p
    per = min(-(-want // n), stages)
    r = -(-stages // per) * stage
    s = -(-hw // r)
    return s, r, n * s


def modconv_dw_cuda(x: torch.Tensor, du4: torch.Tensor, s: torch.Tensor,
                    pre: torch.Tensor, taps,
                    second_order: bool = False) -> torch.Tensor:
    """Launch the dw kernel: ``x`` [N,H,W,Ci], cotangent ``du4``
    [N,H,W,CoK], ``s`` [N,Ci] and ``pre`` = d [N,CoK] (fp32); ``taps``
    are the forward's offsets.  Returns dw [T, Ci, CoK] in fp32.
    ``second_order``: a launch of the core's second order."""
    global launches_dw, launches_second_order
    if not (du4.is_cuda and x.is_cuda):
        raise ValueError("modconv_dw_cuda takes CUDA tensors")
    du4, x = _aligned(du4.contiguous()), _aligned(x.contiguous())
    if du4.dtype != x.dtype:
        raise TypeError(f"dtypes differ: {du4.dtype} {x.dtype}")
    n, h, w, ci = x.shape
    cok = du4.shape[3]
    if du4.shape != (n, h, w, cok):
        raise ValueError(f"du {tuple(du4.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    s, pre = _f32(s, x), _f32(pre, x)
    if s.shape != (n, ci) or pre.shape != (n, cok):
        raise ValueError(f"s {tuple(s.shape)} / pre {tuple(pre.shape)} != "
                         f"({n}, {ci}) / ({n}, {cok})")
    taps = tuple(map(tuple, taps))
    path, units, r, p = _dw_plan(x.dtype, n, h, w, ci, cok, taps,
                                 _sms(x.device.index))
    f32 = dict(dtype=torch.float32, device=x.device)
    out = torch.empty((len(taps), ci, cok), **f32)
    part = torch.empty((p, len(taps), ci, cok), **f32) if p > 1 else out
    oy, ox = _taps_arrays(taps)
    with _build.on_device(x):
        rc = _build.load_library().gt_modconv_dw(
            path, _build.dtype_code(x), x.data_ptr(), du4.data_ptr(),
            s.data_ptr(), pre.data_ptr(), part.data_ptr(), out.data_ptr(), n,
            h, w, ci, cok, len(taps), oy.ctypes.data, ox.ctypes.data, units,
            r, p, _build.stream_ptr(x))
    _build.check(rc, "modconv dw kernel")
    launches_dw += 1
    launches_second_order += second_order
    return out
