"""Launch wrapper of the upfirdn kernel (``csrc/upfirdn.cu``).

Replaces ``gansformer_tpu/ops/pallas_upfirdn.py`` ``_ufd_call`` ->
``pl.pallas_call`` (kernel body ``_upfirdn_body``).  On the synthesis path
it runs the up-conv's anti-imaging blur (4x4 filter, gain 4, pad 2/1,
optionally with the bias/lrelu epilogue) and the tRGB skip upsample
(up = 2); the discriminator's blur-pool (pad 2) and decimated skip
(down = 2) run through it too.

The same kernel is the adjoint of every upfirdn (the backward of
``_ufd_bwd_rule``/``_ufd_ba_bwd_rule``, which re-enter ``_ufd_call``):
flipped filter, up and down swapped, ``grad_pad4`` padding.
``upfirdn2d_adjoint_cuda`` launches it for that and counts those launches
apart (``launches_adjoint``), so the backward has its own launches, time
and bound.  The kernel's compile-time factor pairs 1/1, 2/1 and 1/2 cover
the adjoints of the path too: the blurs adjoin to 1/1, G's skip upsample
(up 2) to down 2, D's decimated skip (down 2) to up 2.

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

# Launches of the kernel since the last reset: forward calls, and the
# adjoint calls of the backward.
launches = 0
launches_adjoint = 0

_ACT_CODES = {None: 0, "linear": 1, "lrelu": 2}


def upfirdn2d_cuda(x: torch.Tensor, f: np.ndarray, up: int, down: int,
                   pads: Tuple[int, int, int, int],
                   bias: Optional[torch.Tensor], act: Optional[str],
                   alpha: float, gain: float) -> torch.Tensor:
    """Launch the kernel on a CUDA NHWC tensor (fp32 or bf16)."""
    global launches
    y = _launch(x, f, up, down, pads, bias, act, alpha, gain)
    launches += 1
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
    return y
