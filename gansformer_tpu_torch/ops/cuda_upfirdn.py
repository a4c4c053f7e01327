"""Launch wrapper of the upfirdn kernel (``csrc/upfirdn.cu``).

Replaces ``gansformer_tpu/ops/pallas_upfirdn.py`` ``_ufd_call`` ->
``pl.pallas_call`` (kernel body ``_upfirdn_body``).  On the synthesis path
it runs the up-conv's anti-imaging blur (4x4 filter, gain 4, pad 2/1,
optionally with the bias/lrelu epilogue) and the tRGB skip upsample
(up = 2); any up/down/pad that ``upfirdn2d`` takes works, because the
discriminator reuses it.

Bound on the card: bytes.  A 4x4 FIR does 16 multiply-adds per output
element, far below the ~295 flops per byte where Hopper's compute would
become the limit, so the least time is one read of the input and one
write of the output.  The design keeps that: one thread per output
element, channel fastest (coalesced), the zero-inserted and padded grids
computed as index arithmetic instead of stored.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gansformer_tpu_torch.ops import _build

# Launches of the kernel since the last reset (one per call below).
launches = 0

_ACT_CODES = {None: 0, "linear": 1, "lrelu": 2}


def upfirdn2d_cuda(x: torch.Tensor, f: np.ndarray, up: int, down: int,
                   pads: Tuple[int, int, int, int],
                   bias: Optional[torch.Tensor], act: Optional[str],
                   alpha: float, gain: float) -> torch.Tensor:
    """Launch the kernel on a CUDA NHWC tensor (fp32 or bf16)."""
    global launches
    if not x.is_cuda:
        raise ValueError("upfirdn2d_cuda takes a CUDA tensor")
    if act not in _ACT_CODES:
        raise ValueError(f"unsupported epilogue {act!r}")
    f = np.ascontiguousarray(f, np.float32)
    fh, fw = f.shape
    if fh * fw > 64:
        raise ValueError(f"filter {f.shape} exceeds 64 taps")
    x = x.contiguous()
    n, h, w, c = x.shape
    py0, py1, px0, px1 = pads
    oh = (h * up + py0 + py1 - fh) // down + 1
    ow = (w * up + px0 + px1 - fw) // down + 1
    if oh <= 0 or ow <= 0:
        raise ValueError(f"empty output for {x.shape}, {pads}")
    if max(x.numel(), n * oh * ow * c) >= 2**31:
        raise ValueError("upfirdn kernel indexes with 32 bits; split the "
                         "batch")
    y = torch.empty((n, oh, ow, c), dtype=x.dtype, device=x.device)
    b = None
    if bias is not None and act is not None:
        b = bias.to(device=x.device, dtype=torch.float32).contiguous()
        if b.shape != (c,):
            raise ValueError(f"bias {tuple(b.shape)} != ({c},)")
    taps = f.reshape(-1)            # host array, copied into the launch
    lib = _build.load_library()
    rc = lib.gt_upfirdn(
        _build.dtype_code(x), x.data_ptr(), b.data_ptr() if b is not None
        else None, y.data_ptr(), n, h, w, c, oh, ow, up, down, py0, px0, fh,
        fw, taps.ctypes.data, _ACT_CODES[act], float(alpha), float(gain),
        _build.stream_ptr(x))
    _build.check(rc, "upfirdn kernel")
    launches += 1
    return y
