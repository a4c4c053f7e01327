"""Launch wrapper of the modulated-conv kernel (``csrc/modconv.cu``).

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
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gansformer_tpu_torch.ops import _build

# Launches of the kernel since the last reset (one per call below).
launches = 0

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
