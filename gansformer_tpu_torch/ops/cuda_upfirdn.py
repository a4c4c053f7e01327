"""Launch wrapper of the upfirdn kernels (``csrc/upfirdn.cu``).

Replaces ``gansformer_tpu/ops/pallas_upfirdn.py`` ``_ufd_call`` ->
``pl.pallas_call`` (kernel body ``_upfirdn_body``).  On the synthesis path
it runs the up-conv's anti-imaging blur (4x4 filter, gain 4, pad 2/1,
optionally with the bias/lrelu epilogue) and the tRGB skip upsample
(up = 2); the discriminator's blur-pool (pad 2) and decimated skip
(down = 2) run through it too.

The same kernels are the adjoint of every upfirdn (the backward of
``_ufd_bwd_rule``/``_ufd_ba_bwd_rule``, which re-enter ``_ufd_call``):
flipped filter, up and down swapped, ``grad_pad4`` padding.
``upfirdn2d_adjoint_cuda`` launches them for that and counts those
launches apart (``launches_adjoint``), so the backward has its own
launches, time and bound.  The factor pairs 1/1, 2/1 and 1/2 cover the
adjoints of the path too: the blurs adjoin to 1/1, G's skip upsample (up
2) to down 2, D's decimated skip (down 2) to up 2.

Bound on the card: bytes (a 4x4 FIR does 16 multiply-adds per output
element).  Routes (``ufd_path``, the kernel's own ``ufd_path`` mirrored):
the tile kernel for a 4x4 filter, those factor pairs and channels in
whole 16-byte vectors (each block stages its input window in shared
memory; each thread slides along a row, 16 bytes of channels at a time);
the small-channel kernel for at most ``SMALL_C`` channels otherwise (the
3-channel tRGB skip and its adjoint); the general kernel for any other
filter or factors.  The tile plan (``ufd_tile``) and ``ufd_smem`` mirror
the kernel's ``tile_plan``: ``tests/test_torch_upfirdn_plan.py`` holds
them to every launch of every preset, ``chip_smoke.py`` to the built
library.  ``ufd_taps`` builds the tap table the tile and small-channel
kernels apply (per output phase for up = 2), so no phase arithmetic runs
on the card.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gansformer_tpu_torch.ops import _build

# Launches of the kernels since the last reset: forward calls, and the
# adjoint calls of the backward; and both by route.  Of the forward
# calls, those made as the adjoint's adjoint (a second derivative, e.g.
# R1's) are also counted apart.
launches = 0
launches_adjoint = 0
launches_second_order = 0
PATH_GENERAL, PATH_TILE, PATH_SMALLC = 0, 1, 2
PATH_NAMES = {PATH_GENERAL: "general", PATH_TILE: "tile",
              PATH_SMALLC: "smallc"}
path_launches = dict.fromkeys(PATH_NAMES, 0)

_ACT_CODES = {None: 0, "linear": 1, "lrelu": 2}

THREADS = 256         # threads of a tile or small-channel block
SMALL_C = 4           # channels of the small-channel route, at most
FACTORS = ((1, 1), (2, 1), (1, 2))


class UfdPlan(NamedTuple):
    """A launch's route and, on the tile route, its tile: ``nv`` 16-byte
    channel vectors a pixel, threads as nv x ``tr`` rows x ``gx`` column
    groups, ``p`` output columns a thread row (p / 2 pairs with up = 2)
    over ``ry`` rows, the output tile ``th`` x ``tw``, the input window
    ``wh`` x ``ww`` pixels at a row pitch of ``pitch`` 16-byte units, and
    the window's shared memory (bytes).  The tile fields are 0 off it."""
    path: int
    nv: int = 0
    tr: int = 0
    gx: int = 0
    ry: int = 0
    p: int = 0
    th: int = 0
    tw: int = 0
    wh: int = 0
    ww: int = 0
    pitch: int = 0
    smem: int = 0


def _vec(dtype: torch.dtype) -> int:
    return 8 if dtype == torch.bfloat16 else 4


def ufd_tile(dtype: torch.dtype, c: int, up: int, down: int) -> UfdPlan:
    """The tile plan of a tile-route launch (``tile_plan`` of the
    kernel): the largest channel block of up to 8 vectors that divides
    C; 256 threads; 4 output columns a thread row (2 with down = 2);
    the window rows padded so that the rows a quarter warp reads start
    in distinct banks."""
    vec = _vec(dtype)
    nv = 8
    while nv > 1 and (c // vec) % nv:
        nv //= 2
    gx = 4 if nv >= 4 else 8
    tr = THREADS // nv // gx
    p = 2 if down == 2 else 4
    ry = 2 if up == 2 else (1 if down == 2 else (2 if nv == 8 else 1))
    th, tw = tr * ry, gx * p
    if up == 2:
        wh, ww = th // 2 + 2, tw // 2 + 2
    else:
        wh, ww = (th - 1) * down + 4, (tw - 1) * down + 4
    skew = {8: 0, 4: 4 if (up, down) == (1, 1) else 2,
            2: 1 if down == 2 else 2, 1: 1}[nv]
    pitch = ww * nv + (skew - ww * nv) % 8
    return UfdPlan(PATH_TILE, nv, tr, gx, ry, p, th, tw, wh, ww, pitch,
                   wh * pitch * 16)


def ufd_path(dtype: torch.dtype, c: int, up: int, down: int, fh: int,
             fw: int) -> int:
    """The route of a launch: tile for a 4x4 filter, factors 1/1, 2/1 or
    1/2 and C a multiple of the 16-byte vector (8 bf16, 4 fp32) whose
    window fits; small-channel for those filters and factors with at
    most ``SMALL_C`` channels; else general."""
    if (fh, fw) != (4, 4) or (up, down) not in FACTORS:
        return PATH_GENERAL
    if c % _vec(dtype) == 0 and \
            ufd_tile(dtype, c, up, down).smem <= _build.SMEM_LIMIT:
        return PATH_TILE
    if c <= SMALL_C:
        return PATH_SMALLC
    return PATH_GENERAL


@functools.lru_cache(maxsize=None)
def ufd_plan(dtype: torch.dtype, c: int, up: int, down: int, fh: int,
             fw: int) -> UfdPlan:
    """Route and tile of a launch (a launch shape repeats every step:
    worked out once)."""
    path = ufd_path(dtype, c, up, down, fh, fw)
    if path == PATH_TILE:
        return ufd_tile(dtype, c, up, down)
    return UfdPlan(path)


def ufd_smem(dtype: torch.dtype, c: int, up: int, down: int, fh: int = 4,
             fw: int = 4) -> int:
    """Dynamic shared memory of a launch: the tile route's input window,
    0 on the other routes."""
    return ufd_plan(dtype, c, up, down, fh, fw).smem


def ufd_taps(f: np.ndarray, up: int, pads: Tuple[int, int, int, int]
             ) -> np.ndarray:
    """The taps the tile and small-channel kernels apply, flat fp32.

    up = 1: g[ty, tx] = f[3 - ty, 3 - tx] at window offset (ty, tx) of the
    output's window origin (a true convolution meets the filter flipped).
    up = 2: g[ay, ax, oy, ox], the tap that output phase (ay, ax) of a 2 x
    2 output quad applies to window offset (oy, ox) in 0..2 of the quad's
    origin (floor((2 m - pad0) / 2) per axis): tap j = 2 o - a - (pad0 %
    2) of the zero-inserted grid, so each phase uses its own 2 x 2 taps
    and the other 5 of its 9 entries are 0."""
    f = np.asarray(f, np.float32)
    if up == 1:
        return np.ascontiguousarray(f[::-1, ::-1]).reshape(-1)
    g = np.zeros((2, 2, 3, 3), np.float32)
    sy, sx = pads[0] % 2, pads[2] % 2
    for ay in range(2):
        for ax in range(2):
            for oy in range(3):
                for ox in range(3):
                    jy, jx = 2 * oy - ay - sy, 2 * ox - ax - sx
                    if 0 <= jy < 4 and 0 <= jx < 4:
                        g[ay, ax, oy, ox] = f[3 - jy, 3 - jx]
    return g.reshape(-1)


@functools.lru_cache(maxsize=64)
def _taps(key: bytes, shape: Tuple[int, int], path: int, up: int,
          sy: int, sx: int):
    """(array, address, count) of the taps a launch hands the kernel:
    the raw filter on the general route, else ``ufd_taps``'s table (the
    array is kept alive by the cache while its address is in use)."""
    f = np.frombuffer(key, np.float32).reshape(shape)
    taps = (np.ascontiguousarray(f).reshape(-1) if path == PATH_GENERAL
            else ufd_taps(f, up, (sy, 0, sx, 0)))
    return taps, taps.ctypes.data, taps.size


def upfirdn2d_cuda(x: torch.Tensor, f: np.ndarray, up: int, down: int,
                   pads: Tuple[int, int, int, int],
                   bias: Optional[torch.Tensor], act: Optional[str],
                   alpha: float, gain: float,
                   second_order: bool = False) -> torch.Tensor:
    """Launch the kernel on a CUDA NHWC tensor (fp32 or bf16);
    ``second_order``: the launch is the adjoint's adjoint."""
    global launches, launches_second_order
    y = _launch(x, f, up, down, pads, bias, act, alpha, gain)
    launches += 1
    launches_second_order += second_order
    return y


def upfirdn2d_adjoint_cuda(ct: torch.Tensor, f_adj: np.ndarray, up: int,
                           down: int, pads: Tuple[int, int, int, int]
                           ) -> torch.Tensor:
    """Launch the kernel as an adjoint: ``f_adj``, ``up``, ``down`` and
    ``pads`` are already the adjoint's (flipped filter, factors swapped,
    ``grad_pad4``); no epilogue."""
    global launches_adjoint
    dx = _launch(ct, f_adj, up, down, pads, None, None, 0.0, 1.0)
    launches_adjoint += 1
    return dx


def _launch(x, f, up, down, pads, bias, act, alpha, gain):
    if not x.is_cuda:
        raise ValueError("upfirdn2d_cuda takes a CUDA tensor")
    if act not in _ACT_CODES:
        raise ValueError(f"unsupported epilogue {act!r}")
    f = np.ascontiguousarray(f, np.float32)
    fh, fw = f.shape
    if fh * fw > 64:
        raise ValueError(f"filter {f.shape} exceeds 64 taps")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()          # 16-byte aligned, for the 16-byte copies
    n, h, w, c = x.shape
    py0, py1, px0, px1 = pads
    oh = (h * up + py0 + py1 - fh) // down + 1
    ow = (w * up + px0 + px1 - fw) // down + 1
    if oh <= 0 or ow <= 0:
        raise ValueError(f"empty output for {x.shape}, {pads}")
    if max(x.numel(), n * oh * ow * c) >= 2**31:
        raise ValueError("upfirdn kernel indexes with 32 bits; split the "
                         "batch")
    plan = ufd_plan(x.dtype, c, up, down, fh, fw)
    if plan.path == PATH_TILE and (n > 65535 or c // (plan.nv
                                                      * _vec(x.dtype))
                                   > 65535):
        raise ValueError(f"upfirdn tile grid too large for {tuple(x.shape)}")
    y = torch.empty((n, oh, ow, c), dtype=x.dtype, device=x.device)
    b = None
    if bias is not None and act is not None:
        b = bias.to(device=x.device, dtype=torch.float32).contiguous()
        if b.shape != (c,):
            raise ValueError(f"bias {tuple(b.shape)} != ({c},)")
    taps, taps_ptr, ntaps = _taps(f.tobytes(), (fh, fw), plan.path, up,
                                  py0 % 2, px0 % 2)
    lib = _build.load_library()
    with _build.on_device(x):
        rc = lib.gt_upfirdn(
            plan.path, _build.dtype_code(x), x.data_ptr(),
            b.data_ptr() if b is not None else None, y.data_ptr(), n, h, w, c,
            oh, ow, up, down, py0, px0, fh, fw, taps_ptr, ntaps,
            _ACT_CODES[act], float(alpha), float(gain), _build.stream_ptr(x))
    if rc:
        _build.check(rc, f"upfirdn kernel ({PATH_NAMES[plan.path]})")
    path_launches[plan.path] += 1
    return y
