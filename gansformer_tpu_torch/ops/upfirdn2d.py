"""upfirdn2d: zero-insert upsample -> pad/crop -> FIR -> downsample, NHWC.

The counterpart of ``gansformer_tpu/ops/upfirdn2d.py`` (the XLA op) and of
the Pallas kernel's optional ``act(y + bias) * gain`` epilogue
(``ops/pallas_upfirdn.py``).  ``upfirdn2d`` routes by device: a CUDA
tensor launches the hand-written kernel (``cuda_upfirdn``), a CPU tensor
runs ``upfirdn2d_plain``, which autograd differentiates.  The plain
version is also the kernel's oracle on the card.

On the card, when autograd records, the op is ``UpfirdnFunction``: the
counterpart of ``_ufd_bwd_rule``/``_ufd_ba_bwd_rule``, whose backward
recovers ``act'`` from the saved output, sums ``db`` in fp32 and runs the
adjoint (flipped filter, up and down swapped, ``grad_pad4``) through the
same kernel.  It is first-order only.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from torch.autograd.function import once_differentiable

from gansformer_tpu_torch.core.device import kernel_route, wants_graph
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


def grad_pad4(in_h: int, in_w: int, fh: int, fw: int, up: int, down: int,
              pads: Tuple[int, int, int, int]) -> Tuple[int, int, int, int]:
    """Padding of the adjoint upfirdn (flipped filter, up and down
    swapped); a copy of ``pallas_upfirdn.grad_pad4``."""
    py0, py1, px0, px1 = pads
    oh, ow = out_hw(in_h, in_w, fh, fw, up, down, pads)
    return (fh - py0 - 1, in_h * up - oh * down + py0 - up + 1,
            fw - px0 - 1, in_w * up - ow * down + px0 - up + 1)


def adjoint_geometry(in_h: int, in_w: int, f: np.ndarray, up: int,
                     down: int, pads: Tuple[int, int, int, int],
                     flip: bool = True):
    """(filter, up, down, pads) of the adjoint of the upfirdn that took an
    ``in_h`` x ``in_w`` input.  ``flip=False`` gives what an adjoint that
    forgot the flip would run: a planted fault for the smoke's control."""
    fa = np.ascontiguousarray(f[::-1, ::-1] if flip else f, np.float32)
    return fa, down, up, grad_pad4(in_h, in_w, f.shape[0], f.shape[1], up,
                                   down, pads)


def act_grad(y32: torch.Tensor, act: str, alpha: float) -> torch.Tensor:
    """act'(u) recovered from the post-act output y (the gain is
    positive, so lrelu keeps the sign): slope 1 at 0, as ``where(u >=
    0)`` defines it."""
    if act == "linear":
        return torch.ones_like(y32)
    return torch.where(y32 >= 0, 1.0, alpha).to(y32.dtype)


def upfirdn2d_adjoint_plain(ct: torch.Tensor, f: np.ndarray, up: int,
                            down: int, pads: Tuple[int, int, int, int],
                            in_hw: Tuple[int, int], flip: bool = True
                            ) -> torch.Tensor:
    """The plain version of the adjoint launch: the input-gradient of the
    forward upfirdn(f, up, down, pads) on an ``in_hw`` input."""
    fa, up_a, down_a, gp = adjoint_geometry(in_hw[0], in_hw[1], f, up, down,
                                            pads, flip)
    return upfirdn2d_plain(ct, fa, up_a, down_a, gp)


def upfirdn2d_adjoint(ct: torch.Tensor, f: np.ndarray, up: int, down: int,
                      pads: Tuple[int, int, int, int],
                      in_hw: Tuple[int, int]) -> torch.Tensor:
    """Adjoint launch on the card, plain version on the CPU; the result
    has exactly the forward input's spatial shape."""
    if kernel_route(ct):
        fa, up_a, down_a, gp = adjoint_geometry(in_hw[0], in_hw[1], f, up,
                                                down, pads)
        dx = cuda_upfirdn.upfirdn2d_adjoint_cuda(ct, fa, up_a, down_a, gp)
    else:
        dx = upfirdn2d_adjoint_plain(ct, f, up, down, pads, in_hw)
    if tuple(dx.shape[1:3]) != tuple(in_hw):
        raise RuntimeError(f"upfirdn adjoint gave {tuple(dx.shape)} for an "
                           f"input of {tuple(in_hw)}")
    return dx


def _upfirdn_launch(x, f, up, down, pads, bias, act, alpha, gain):
    if kernel_route(x):
        return cuda_upfirdn.upfirdn2d_cuda(x, f, up, down, pads, bias, act,
                                           alpha, gain)
    return upfirdn2d_plain(x, f, up, down, pads, bias, act, alpha, gain)


class UpfirdnFunction(torch.autograd.Function):
    """upfirdn (+ optional ``act(y + bias) * gain``) with the adjoint
    backward.  Forward and backward launch kernels for CUDA tensors and
    run the plain versions for CPU tensors."""

    @staticmethod
    def forward(ctx, x, bias, f, up, down, pads, act, alpha, gain):
        y = _upfirdn_launch(x, f, up, down, pads, bias, act, alpha, gain)
        ctx.geom = (f, up, down, pads, tuple(x.shape[1:3]))
        ctx.epilogue = (act, alpha, gain, bias is not None)
        if act is not None:
            ctx.save_for_backward(y)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        f, up, down, pads, in_hw = ctx.geom
        act, alpha, gain, has_bias = ctx.epilogue
        db = None
        if act is not None:
            (y,) = ctx.saved_tensors
            du32 = ct.float() * act_grad(y.float(), act, alpha) * gain
            if has_bias and ctx.needs_input_grad[1]:
                db = du32.sum(dim=(0, 1, 2))
            ct = du32.to(ct.dtype)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = upfirdn2d_adjoint(ct.contiguous(), f, up, down, pads, in_hw)
        return dx, db, None, None, None, None, None, None, None


def upfirdn2d(x: torch.Tensor, f, up: int = 1, down: int = 1, pad: Pad = 0,
              bias: Optional[torch.Tensor] = None, act: Optional[str] = None,
              alpha: float = 0.2, gain: Optional[float] = None
              ) -> torch.Tensor:
    """Upsample, pad, FIR-filter and downsample a batch of NHWC images,
    optionally followed by ``act(y + bias) * gain`` (linear/lrelu).

    ``f`` is a static 2D filter (``setup_filter`` output).  A CUDA tensor
    runs the kernel (inside ``UpfirdnFunction`` when autograd records); a
    CPU tensor runs the plain version.
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
    if kernel_route(x) and wants_graph(x, bias):
        return UpfirdnFunction.apply(x, bias, f, up, down, pads, act, alpha,
                                     g)
    return _upfirdn_launch(x, f, up, down, pads, bias, act, alpha, g)


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
