"""Style-modulated convolution, NHWC activations and HWIO weights.

The counterpart of ``gansformer_tpu/ops/modulated_conv.py`` (the XLA
composite) and of the Pallas entry ``modulated_conv2d_pallas``
(``ops/pallas_modconv.py``), whose structure ``modulated_conv2d`` keeps:

* the demod coefficients ``d = rsqrt(sum((w * s)^2) + eps)`` are an fp32
  einsum outside the kernel;
* ``up=1`` is one modconv kernel (``same3``/``same1``) with an optional
  fused ``act(y + bias) * gain`` epilogue;
* ``up=2`` is the ``poly`` kernel (phases from ``poly_w4``, interleaved in
  the kernel) followed by the upfirdn blur kernel, which carries the
  epilogue.

A CUDA tensor launches the kernels; a CPU tensor runs ``modconv_plain``,
which takes the same stacked weights as the kernel.  ``conv2d`` and
``_conv_transpose_poly`` are the plain (phase-major) up-conv of the XLA
path, kept as an independent oracle.  Down-sampling convs wait for the
discriminator.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from gansformer_tpu_torch.core.device import kernel_route
from gansformer_tpu_torch.ops import cuda_modconv
from gansformer_tpu_torch.ops.fused_bias_act import (ACTIVATIONS,
                                                     default_gain,
                                                     fused_bias_act)
from gansformer_tpu_torch.ops.upfirdn2d import (FUSED_ACTS, filter_2d,
                                                setup_filter, upfirdn2d)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)


def _conv(x: torch.Tensor, w: torch.Tensor, padding) -> torch.Tensor:
    """NHWC x HWIO convolution (correlation) in fp32, output in x's dtype."""
    y = F.conv2d(_nchw(x.float()), _oihw(w.float()), padding=padding)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _conv_transpose_poly(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-2 transposed 3x3 conv as one 2x2 conv with 4*Co phase outputs
    (phase-MAJOR columns: a*2*Co + b*Co + co), then depth-to-space.  Output
    pixel (2m+a, 2n+b) reads x[m+dh, n+dw] with weight w[2dh+1-a, 2dw+1-b];
    taps outside w are structural zeros."""
    kh, kw = w.shape[0], w.shape[1]
    assert kh == kw == 3, "polyphase path is derived for 3x3 kernels"
    n, h, wd, ci = x.shape
    co = w.shape[3]
    w_pad = F.pad(w, (0, 0, 0, 0, 0, 1, 0, 1))            # [4, 4, Ci, Co]
    idx = torch.tensor([[1, 0], [3, 2]])                   # rh[dh, a]
    w4 = w_pad[idx[:, None, :, None], idx[None, :, None, :]]  # [dh,dw,a,b,..]
    w4 = w4.permute(0, 1, 4, 2, 3, 5).reshape(2, 2, ci, 4 * co)
    xp = F.pad(x, (0, 0, 0, 1, 0, 1))                      # right/bottom 1
    y = _conv(xp, w4.to(x.dtype), padding=0)               # [N, H, W, 4Co]
    y = y.reshape(n, h, wd, 2, 2, co).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, 2 * h, 2 * wd, co)


def conv2d(x: torch.Tensor, w: torch.Tensor, up: int = 1, down: int = 1,
           resample_filter: Sequence[float] = (1, 3, 3, 1)) -> torch.Tensor:
    """Plain conv (SAME) with the polyphase ``up=2`` path: transposed conv
    then the anti-imaging blur (gain up^2), the reference's order."""
    assert x.ndim == 4 and w.ndim == 4
    if down != 1:
        raise NotImplementedError("down-sampling convs come with the "
                                  "discriminator")
    kh, kw = w.shape[0], w.shape[1]
    if up == 2 and kh == kw == 3:
        return filter_2d(_conv_transpose_poly(x, w), resample_filter,
                         gain=float(up * up))
    if up != 1:
        raise NotImplementedError(f"up={up} with a {kh}x{kw} kernel")
    return _conv(x, w, padding=(kh // 2, kw // 2))


def _demod_coeffs(w32: torch.Tensor, s32: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Per-sample demod coefficients 1/||w*s||_2, an fp32 island."""
    sigma = torch.einsum("hwio,ni->no", w32.square(), s32.square())
    return torch.rsqrt(sigma + eps)                        # [N, Cout]


def poly_w4(w: torch.Tensor) -> torch.Tensor:
    """[3,3,Ci,Co] -> [4, Ci, Co*4] phase sub-kernels, tap-major (t = dh*2
    + dw), columns co-OUTER / phase-INNER (co*4 + a*2 + b): the Pallas
    kernel's ``_poly_w4`` layout, which the CUDA kernel reads."""
    ci, co = w.shape[2], w.shape[3]
    w_pad = F.pad(w, (0, 0, 0, 0, 0, 1, 0, 1))
    idx = torch.tensor([[1, 0], [3, 2]])                   # rh[dh, a]
    w4 = w_pad[idx[:, None, :, None], idx[None, :, None, :]]  # [dh,dw,a,b,..]
    w4 = w4.permute(0, 1, 4, 5, 2, 3)                      # [dh,dw,Ci,Co,a,b]
    return w4.reshape(4, ci, co * 4).contiguous()


def stack_weights(kind: str, w: torch.Tensor) -> torch.Tensor:
    """The kernel's stacked weights [T, Ci, Co*phases] for ``kind``."""
    if kind == "poly":
        return poly_w4(w)
    return w.reshape(-1, w.shape[2], w.shape[3]).contiguous()


def modconv_plain(x: torch.Tensor, wstack: torch.Tensor, s: torch.Tensor,
                  post: torch.Tensor, bias: Optional[torch.Tensor],
                  kind: str, act: Optional[str], alpha: float,
                  gain: float) -> torch.Tensor:
    """The plain PyTorch version of the modconv kernel, on the kernel's own
    inputs: fp32 ``post * conv(x * s, w)`` (+ epilogue), output in x's
    dtype."""
    n, h, w, ci = x.shape
    cok = wstack.shape[2]
    xs = x.float() * s.float()[:, None, None, :]
    w32 = wstack.float()
    if kind == "same3":
        y = _conv(xs, w32.reshape(3, 3, ci, cok), padding=1)
    elif kind == "same1":
        y = _conv(xs, w32.reshape(1, 1, ci, cok), padding=0)
    elif kind == "poly":
        xp = F.pad(xs, (0, 0, 0, 1, 0, 1))
        y = _conv(xp, w32.reshape(2, 2, ci, cok), padding=0)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    y = y * post.float()[:, None, None, :]
    if kind == "poly":                       # co-major depth-to-space
        co = cok // 4
        y = (y.reshape(n, h, w, co, 2, 2).permute(0, 1, 4, 2, 5, 3)
             .reshape(n, 2 * h, 2 * w, co))
    if act is not None:
        fn, _ = ACTIVATIONS[act]
        if bias is not None:
            y = y + bias.float()
        y = fn(y, alpha) * gain
    return y.to(x.dtype).contiguous()


def _modconv(x, wstack, s, post, bias, kind, act, alpha, gain):
    if kernel_route(x):
        return cuda_modconv.modconv_cuda(x, wstack, s, post, bias, kind, act,
                                         alpha, gain)
    return modconv_plain(x, wstack, s, post, bias, kind, act, alpha, gain)


def modulated_conv2d(
    x: torch.Tensor,                 # [N, H, W, Cin]
    w: torch.Tensor,                 # [kh, kw, Cin, Cout]
    styles: torch.Tensor,            # [N, Cin]
    demodulate: bool = True,
    up: int = 1,
    down: int = 1,
    resample_filter: Sequence[float] = (1, 3, 3, 1),
    eps: float = 1e-8,
    *,
    bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
    alpha: float = 0.2,
    gain: Optional[float] = None,
) -> torch.Tensor:
    """Modulate -> conv -> demodulate, with an optional fused
    ``act(y + bias) * gain`` epilogue (linear/lrelu; any other activation
    runs after the kernels)."""
    assert x.ndim == 4 and w.ndim == 4 and styles.ndim == 2
    n, _, _, cin = x.shape
    kh, kw, _, co = w.shape
    assert w.shape[2] == cin and styles.shape == (n, cin)
    assert act is not None or bias is None, \
        "bias without act: pass act='linear'"
    if act is not None and act not in FUSED_ACTS:
        y = modulated_conv2d(x, w, styles, demodulate, up, down,
                             resample_filter, eps)
        return fused_bias_act(y, bias, act=act, alpha=alpha, gain=gain)
    if down != 1 or not ((up == 1 and kh == kw and kh in (1, 3))
                         or (up == 2 and kh == kw == 3)):
        raise NotImplementedError(
            f"modulated_conv2d: up={up} down={down} kernel {kh}x{kw} is not "
            f"on the generator's path")
    s32 = styles.float()
    if demodulate:
        d = _demod_coeffs(w.float(), s32, eps)
    else:
        d = torch.ones((n, co), dtype=torch.float32, device=x.device)
    w = w.to(x.dtype)
    g = default_gain(act, gain) if act is not None else 1.0
    if up == 1:
        kind = "same1" if kh == 1 else "same3"
        return _modconv(x, stack_weights(kind, w), s32, d, bias, kind, act,
                        alpha, g)
    y = _modconv(x, stack_weights("poly", w), s32,
                 d.repeat_interleave(4, dim=1), None, "poly", None, alpha,
                 1.0)
    f = setup_filter(resample_filter, gain=float(up * up))
    p = f.shape[0] - 1
    return upfirdn2d(y, f, pad=((p + 1) // 2, p // 2), bias=bias, act=act,
                     alpha=alpha, gain=gain)
