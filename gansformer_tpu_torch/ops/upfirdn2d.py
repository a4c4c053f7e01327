"""upfirdn2d: zero-insert upsample -> pad/crop -> FIR -> downsample, NHWC.

The counterpart of ``gansformer_tpu/ops/upfirdn2d.py`` (the XLA op) and of
the Pallas kernel's optional ``act(y + bias) * gain`` epilogue
(``ops/pallas_upfirdn.py``).  ``upfirdn2d`` routes by device: a CUDA
tensor launches the hand-written kernel (``cuda_upfirdn``), a CPU tensor
runs ``upfirdn2d_plain``.  The plain version is also the kernel's oracle
on the card.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from gansformer_tpu_torch.core.device import kernel_route
from gansformer_tpu_torch.ops import cuda_upfirdn
from gansformer_tpu_torch.ops.fused_bias_act import ACTIVATIONS, default_gain

Pad = Union[int, Tuple[int, int], Tuple[int, int, int, int]]

# Epilogues the kernel fuses; any other activation runs after it.
FUSED_ACTS = ("linear", "lrelu")


def setup_filter(f: Sequence[float], normalize: bool = True,
                 gain: float = 1.0) -> np.ndarray:
    """2D FIR filter from a 1D (separable) or 2D tap list, normalized to
    unit sum, then scaled by ``gain``."""
    f = np.asarray(f, dtype=np.float32)
    if f.ndim == 1:
        f = np.outer(f, f)
    assert f.ndim == 2
    if normalize:
        f = f / f.sum()
    return f * gain


def pad4(pad: Pad) -> Tuple[int, int, int, int]:
    """(pady0, pady1, padx0, padx1) from an int, a pair, or a 4-tuple."""
    if isinstance(pad, int):
        return (pad, pad, pad, pad)
    if len(pad) == 2:
        return (pad[0], pad[1], pad[0], pad[1])
    assert len(pad) == 4
    return tuple(pad)


def out_hw(h: int, w: int, fh: int, fw: int, up: int, down: int,
           pads: Tuple[int, int, int, int]) -> Tuple[int, int]:
    py0, py1, px0, px1 = pads
    oh = (h * up + py0 + py1 - fh) // down + 1
    ow = (w * up + px0 + px1 - fw) // down + 1
    assert oh > 0 and ow > 0, (h, w, fh, fw, up, down, pads)
    return oh, ow


def upfirdn2d_plain(x: torch.Tensor, f: np.ndarray, up: int, down: int,
                    pads: Tuple[int, int, int, int],
                    bias: Optional[torch.Tensor] = None,
                    act: Optional[str] = None, alpha: float = 0.2,
                    gain: float = 1.0) -> torch.Tensor:
    """The plain PyTorch version of the upfirdn kernel: fp32 arithmetic,
    output in ``x``'s dtype."""
    n, h, w, c = x.shape
    fh, fw = f.shape
    x32 = x.float()
    if up > 1:
        z = x32.new_zeros(n, h, up, w, up, c)
        z[:, :, 0, :, 0, :] = x32
        x32 = z.reshape(n, h * up, w * up, c)
    py0, py1, px0, px1 = pads
    z = F.pad(x32.permute(0, 3, 1, 2), (px0, px1, py0, py1))  # <0 crops
    # true convolution: correlate with the flipped filter, depthwise
    k = torch.from_numpy(np.ascontiguousarray(f[::-1, ::-1])).to(z.device)
    k = k[None, None].expand(c, 1, fh, fw)
    y = F.conv2d(z, k, stride=down, groups=c).permute(0, 2, 3, 1)
    if act is not None:
        fn, _ = ACTIVATIONS[act]
        if bias is not None:
            y = y + bias.float()
        y = fn(y, alpha) * gain
    return y.to(x.dtype).contiguous()


def upfirdn2d(x: torch.Tensor, f, up: int = 1, down: int = 1, pad: Pad = 0,
              bias: Optional[torch.Tensor] = None, act: Optional[str] = None,
              alpha: float = 0.2, gain: Optional[float] = None
              ) -> torch.Tensor:
    """Upsample, pad, FIR-filter and downsample a batch of NHWC images,
    optionally followed by ``act(y + bias) * gain`` (linear/lrelu).

    ``f`` is a static 2D filter (``setup_filter`` output).  A CUDA tensor
    runs the kernel; a CPU tensor runs the plain version.
    """
    assert x.ndim == 4, "expected NHWC"
    f = np.asarray(f, np.float32)
    if f.ndim == 1:
        f = np.outer(f, f)
    pads = pad4(pad)
    if act is None:
        assert bias is None, "bias without act: pass act='linear'"
        g = 1.0
    else:
        assert act in FUSED_ACTS, (
            f"fused epilogue supports {FUSED_ACTS}, got {act!r}")
        g = default_gain(act, gain)
    if kernel_route(x):
        return cuda_upfirdn.upfirdn2d_cuda(x, f, up, down, pads, bias, act,
                                           alpha, g)
    return upfirdn2d_plain(x, f, up, down, pads, bias, act, alpha, g)


def upsample_2d(x: torch.Tensor, f, factor: int = 2,
                gain: float = 1.0) -> torch.Tensor:
    """Upsample with an FIR anti-imaging filter; output exactly H*factor."""
    f = setup_filter(f, gain=gain * (factor**2))
    p = f.shape[0] - factor
    return upfirdn2d(x, f, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample_2d(x: torch.Tensor, f, factor: int = 2,
                  gain: float = 1.0) -> torch.Tensor:
    """Blur-pool downsample."""
    f = setup_filter(f, gain=gain)
    p = f.shape[0] - factor
    return upfirdn2d(x, f, down=factor, pad=((p + 1) // 2, p // 2))


def filter_2d(x: torch.Tensor, f, gain: float = 1.0,
              extra_pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Same-resolution blur; ``extra_pad`` folds a following VALID conv's
    padding into the blur."""
    f = setup_filter(f, gain=gain)
    p = f.shape[0] - 1
    return upfirdn2d(x, f, pad=((p + 1) // 2 + extra_pad[0],
                                p // 2 + extra_pad[1]))
