"""Launch wrappers of the modulated-conv kernels: the forward
(``csrc/modconv.cu``) and the two backward kernels
(``csrc/modconv_bwd.cu``).

Replaces ``gansformer_tpu/ops/pallas_modconv.py`` ``_fwd_call`` ->
``pl.pallas_call`` (kernel body ``_fwd_body``), kinds ``same3`` (every
synthesis 3x3 conv), ``same1`` (tRGB) and ``poly`` (every up-conv, weights
from ``_poly_w4``, phases interleaved inside the kernel).

Bound on the card: operations.  The 3x3 convs at 128-512 channels do
hundreds of flops per byte moved, above Hopper's ~295 flops/byte ridge in
bf16, so the least time is the multiply-adds over the tensor-core peak.
The kernel is an implicit GEMM with 64x64 output tiles in shared memory:
bf16 convs run on the tensor cores through WMMA, fp32 and the 3-channel
tRGB on the fp32 FMA units.  Its loads are not pipelined (no cp.async,
TMA or wgmma yet), so it sits well above the bound; its design (style
folded into the activation load, demod into the epilogue, one weight
tile for the whole batch) is what a wgmma version keeps.

``modconv_dx_cuda`` replaces ``_bwd_call`` -> ``pl.pallas_call`` (body
``_bwd_body``): dx = s * u and ds = sum_hw x * u with u the transposed
conv of the cotangent, d folded into the weight-tile load; ds goes through
per-tile fp32 partials and a fixed-order second pass.
``modconv_dw_cuda`` replaces ``_dw_call`` -> ``pl.pallas_call`` (body
``_dw_body``): the per-tap weight gradient, split over (sample,
row-strip) chunks so the long contraction fills the card, with the
rank-1 scale s_n (x) d_n applied to each sample's tap product and a
fixed-order reduce of the fp32 partials.  Both are bound by operations
(the forward's multiply-adds) and share the forward's design: WMMA for
bf16, FMA for fp32 and the tRGB, no load pipelining yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gansformer_tpu_torch.ops import _build

# Launches since the last reset: forward, dx/ds and dw calls.
launches = 0
launches_dx = 0
launches_dw = 0

# dw split-K: pixels per chunk, and the blocks per SM the split aims for.
DW_CHUNK_PIXELS = 256
DW_BLOCKS_PER_SM = 4

# Tap offsets (dy, dx) relative to the output pixel, in input coordinates;
# tap t reads weight slab t of the stacked [T, Ci, Co*phases] weights.
TAPS = {
    "same3": tuple((a - 1, b - 1) for a in range(3) for b in range(3)),
    "same1": ((0, 0),),
    "poly": ((0, 0), (0, 1), (1, 0), (1, 1)),
}
PHASES = {"same3": 1, "same1": 1, "poly": 4}

_ACT_CODES = {None: 0, "linear": 1, "lrelu": 2}


def modconv_cuda(x: torch.Tensor, wstack: torch.Tensor, s: torch.Tensor,
                 post: torch.Tensor, bias: Optional[torch.Tensor],
                 kind: str, act: Optional[str], alpha: float,
                 gain: float) -> torch.Tensor:
    """Launch the kernel: ``post * conv(x * s, w)`` (+ epilogue) on CUDA
    NHWC ``x`` (fp32 or bf16) with stacked weights ``wstack`` [T, Ci, CoK],
    styles ``s`` [N, Ci] and per-column scales ``post`` [N, CoK] (fp32)."""
    global launches
    if not x.is_cuda:
        raise ValueError("modconv_cuda takes a CUDA tensor")
    if kind not in TAPS or act not in _ACT_CODES:
        raise ValueError(f"unsupported kind/epilogue {kind!r}/{act!r}")
    taps, phases = TAPS[kind], PHASES[kind]
    x = x.contiguous()
    n, h, w, ci = x.shape
    t, wci, cok = wstack.shape
    if t != len(taps) or wci != ci or cok % phases:
        raise ValueError(f"weights {tuple(wstack.shape)} do not fit {kind} "
                         f"on input {tuple(x.shape)}")
    co = cok // phases
    up = 2 if phases == 4 else 1
    wstack = wstack.to(device=x.device, dtype=x.dtype).contiguous()
    s = s.to(device=x.device, dtype=torch.float32).contiguous()
    post = post.to(device=x.device, dtype=torch.float32).contiguous()
    if s.shape != (n, ci) or post.shape != (n, cok):
        raise ValueError(f"s {tuple(s.shape)} / post {tuple(post.shape)} "
                         f"!= ({n}, {ci}) / ({n}, {cok})")
    b = None
    if act is not None:
        b = (torch.zeros(co, device=x.device, dtype=torch.float32)
             if bias is None else
             bias.to(device=x.device, dtype=torch.float32).contiguous())
        if b.shape != (co,):
            raise ValueError(f"bias {tuple(b.shape)} != ({co},)")
    y = torch.empty((n, up * h, up * w, co), dtype=x.dtype, device=x.device)
    oy = np.asarray([o[0] for o in taps], np.int32)
    ox = np.asarray([o[1] for o in taps], np.int32)
    lib = _build.load_library()
    rc = lib.gt_modconv(
        _build.dtype_code(x), x.data_ptr(), wstack.data_ptr(), s.data_ptr(),
        post.data_ptr(), b.data_ptr() if b is not None else None,
        y.data_ptr(), n, h, w, ci, cok, phases, len(taps), oy.ctypes.data,
        ox.ctypes.data, _ACT_CODES[act], float(alpha), float(gain),
        _build.stream_ptr(x))
    _build.check(rc, f"modconv kernel ({kind})")
    launches += 1
    return y


def _taps_arrays(taps):
    oy = np.asarray([o[0] for o in taps], np.int32)
    ox = np.asarray([o[1] for o in taps], np.int32)
    return oy, ox


def dx_tile_pixels() -> int:
    """Pixels each ds partial of the dx/ds kernel sums (one dx tile)."""
    return int(_build.load_library().gt_modconv_dx_tile())


def modconv_dx_cuda(du4: torch.Tensor, wT: torch.Tensor, pre: torch.Tensor,
                    post: torch.Tensor, x: torch.Tensor, taps):
    """Launch the dx/ds kernel: cotangent ``du4`` [N,H,W,CoK], adjoint
    weights ``wT`` [T,CoK,Ci], ``pre`` = d [N,CoK] and ``post`` = s
    [N,Ci] (fp32), ``x`` [N,H,W,Ci]; ``taps`` are the adjoint's offsets
    relative to the output pixel.  Returns (dx in x's dtype, ds fp32)."""
    global launches_dx
    if not (du4.is_cuda and x.is_cuda):
        raise ValueError("modconv_dx_cuda takes CUDA tensors")
    du4, x = du4.contiguous(), x.contiguous()
    if du4.dtype != x.dtype:
        raise TypeError(f"dtypes differ: {du4.dtype} {x.dtype}")
    n, h, w, cok = du4.shape
    t, wk, ci = wT.shape
    if x.shape != (n, h, w, ci) or wk != cok or t != len(taps):
        raise ValueError(f"du {tuple(du4.shape)}, wT {tuple(wT.shape)}, x "
                         f"{tuple(x.shape)} and {len(taps)} taps do not fit")
    wT = wT.to(device=x.device, dtype=x.dtype).contiguous()
    pre = pre.to(device=x.device, dtype=torch.float32).contiguous()
    post = post.to(device=x.device, dtype=torch.float32).contiguous()
    if pre.shape != (n, cok) or post.shape != (n, ci):
        raise ValueError(f"pre {tuple(pre.shape)} / post {tuple(post.shape)} "
                         f"!= ({n}, {cok}) / ({n}, {ci})")
    lib = _build.load_library()
    tiles = -(-(h * w) // lib.gt_modconv_dx_tile())
    dx = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    ds_part = torch.empty((n, tiles, ci), **f32)
    ds = torch.empty((n, ci), **f32)
    oy, ox = _taps_arrays(taps)
    rc = lib.gt_modconv_dx(
        _build.dtype_code(x), du4.data_ptr(), wT.data_ptr(), pre.data_ptr(),
        post.data_ptr(), x.data_ptr(), dx.data_ptr(), ds_part.data_ptr(),
        ds.data_ptr(), n, h, w, cok, ci, len(taps), oy.ctypes.data,
        ox.ctypes.data, _build.stream_ptr(x))
    _build.check(rc, "modconv dx/ds kernel")
    launches_dx += 1
    return dx, ds


def dw_split(n: int, h: int, w: int, ci: int, cok: int, ntaps: int,
             sms: int):
    """(S, R, P): chunks per sample, pixels per chunk and the number of
    blocks the dw contraction splits into, so that tiles * taps * P blocks
    fill ``sms`` SMs ``DW_BLOCKS_PER_SM`` times over where the chunks
    allow."""
    r = DW_CHUNK_PIXELS
    s = -(-(h * w) // r)
    tiles = -(-ci // 64) * -(-cok // 64) * ntaps
    p = -(-(DW_BLOCKS_PER_SM * sms) // tiles)
    return s, r, max(1, min(p, n * s))


def modconv_dw_cuda(x: torch.Tensor, du4: torch.Tensor, s: torch.Tensor,
                    pre: torch.Tensor, taps) -> torch.Tensor:
    """Launch the dw kernel: ``x`` [N,H,W,Ci], cotangent ``du4``
    [N,H,W,CoK], ``s`` [N,Ci] and ``pre`` = d [N,CoK] (fp32); ``taps``
    are the forward's offsets.  Returns dw [T, Ci, CoK] in fp32."""
    global launches_dw
    if not (du4.is_cuda and x.is_cuda):
        raise ValueError("modconv_dw_cuda takes CUDA tensors")
    du4, x = du4.contiguous(), x.contiguous()
    if du4.dtype != x.dtype:
        raise TypeError(f"dtypes differ: {du4.dtype} {x.dtype}")
    n, h, w, ci = x.shape
    cok = du4.shape[3]
    if du4.shape != (n, h, w, cok):
        raise ValueError(f"du {tuple(du4.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    s = s.to(device=x.device, dtype=torch.float32).contiguous()
    pre = pre.to(device=x.device, dtype=torch.float32).contiguous()
    if s.shape != (n, ci) or pre.shape != (n, cok):
        raise ValueError(f"s {tuple(s.shape)} / pre {tuple(pre.shape)} != "
                         f"({n}, {ci}) / ({n}, {cok})")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    chunks, r, p = dw_split(n, h, w, ci, cok, len(taps), sms)
    f32 = dict(dtype=torch.float32, device=x.device)
    part = torch.empty((p, len(taps), ci, cok), **f32)
    out = torch.empty((len(taps), ci, cok), **f32)
    oy, ox = _taps_arrays(taps)
    lib = _build.load_library()
    rc = lib.gt_modconv_dw(
        _build.dtype_code(x), x.data_ptr(), du4.data_ptr(), s.data_ptr(),
        pre.data_ptr(), part.data_ptr(), out.data_ptr(), n, h, w, ci, cok,
        len(taps), oy.ctypes.data, ox.ctypes.data, chunks, r, p,
        _build.stream_ptr(x))
    _build.check(rc, "modconv dw kernel")
    launches_dw += 1
    return out
