"""Equalized-learning-rate layers (PyTorch).

The counterparts of ``EqualDense``, ``EqualConv``, ``ModulatedConv`` and
``minibatch_stddev`` in ``gansformer_tpu/models/layers.py``.  Parameters
are stored at unit scale in fp32 under the flax names (``w``, ``b``,
``noise_strength``, ``affine``) and scaled by ``gain / sqrt(fan_in) *
lrmul`` at use, so bridging JAX weights is a pure copy.  Compute may run
in bf16 (``dtype``).  A ``ModulatedConv``'s noise is drawn by the caller
from explicit ``torch.Generator``s (``synthesis.draw_noise``), in serving
and in training alike.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from gansformer_tpu_torch.core.precision import island_dtype, widen
from gansformer_tpu_torch.ops.fused_bias_act import fused_bias_act
from gansformer_tpu_torch.ops.modulated_conv import conv2d, modulated_conv2d


class EqualDense(nn.Module):
    """Dense layer on the last axis; ``w`` is [fan_in, features]."""

    def __init__(self, in_features: int, features: int, gain: float = 1.0,
                 lrmul: float = 1.0, bias_init: float = 0.0,
                 act: str = "linear",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gain, self.lrmul, self.act, self.dtype = gain, lrmul, act, dtype
        self.bias_init = bias_init
        self.w = nn.Parameter(torch.empty(in_features, features))
        self.b = nn.Parameter(torch.empty(features))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.w.normal_(0.0, 1.0 / self.lrmul, generator=gen)
            self.b.fill_(self.bias_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        coef = self.gain / math.sqrt(self.w.shape[0]) * self.lrmul
        dt = island_dtype(x, self.dtype)
        y = x.to(dt) @ (self.w * coef).to(dt)
        return fused_bias_act(y, self.b * self.lrmul, act=self.act)


class EqualConv(nn.Module):
    """Conv layer (HWIO ``w`` [k, k, in, features]) with optional
    FIR-filtered up/down-sampling (``ops.conv2d``), then bias + act."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 up: int = 1, down: int = 1, gain: float = 1.0,
                 lrmul: float = 1.0, use_bias: bool = True,
                 act: str = "linear", resample_filter: tuple = (1, 3, 3, 1),
                 dtype: torch.dtype = torch.float32,
                 conv_backend: str = "xla"):
        super().__init__()
        del conv_backend               # accepted, ignored: the device decides
        self.kernel, self.up, self.down = kernel, up, down
        self.gain, self.lrmul, self.act, self.dtype = gain, lrmul, act, dtype
        self.resample_filter = tuple(resample_filter)
        self.w = nn.Parameter(torch.empty(kernel, kernel, in_channels,
                                          features))
        self.b = nn.Parameter(torch.empty(features)) if use_bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.w.normal_(0.0, 1.0 / self.lrmul, generator=gen)
            if self.b is not None:
                self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        coef = self.gain / math.sqrt(self.w.shape[2] * self.kernel**2) \
            * self.lrmul
        y = conv2d(x.to(self.dtype), (self.w * coef).to(self.dtype),
                   up=self.up, down=self.down,
                   resample_filter=self.resample_filter)
        b = None if self.b is None else self.b * self.lrmul
        return fused_bias_act(y, b, act=self.act)


def minibatch_stddev(x: torch.Tensor, group_size: int = 4,
                     num_features: int = 1) -> torch.Tensor:
    """Append cross-sample stddev statistics as extra channels: groups of
    ``g = min(group_size, n)`` consecutive samples (``g`` shrinks until it
    divides n), population statistics in fp32."""
    n, h, w, c = x.shape
    g = min(group_size, n)
    while n % g != 0:
        g -= 1
    f = num_features
    y = widen(x.reshape(n // g, g, h, w, f, c // f))
    y = y - y.mean(dim=1, keepdim=True)
    y = torch.sqrt(y.square().mean(dim=1) + 1e-8)      # [n/g, h, w, f, c/f]
    y = y.mean(dim=(1, 2, 4))                           # [n/g, f]
    y = y.repeat_interleave(g, dim=0).reshape(n, 1, 1, f)
    y = y.expand(n, h, w, f).to(x.dtype)
    return torch.cat([x, y], dim=-1)


class ModulatedConv(nn.Module):
    """affine(w_style) -> modulated conv -> noise -> bias + act.

    Noise sits between demod and bias/act, so the bias/act epilogue fuses
    into the last kernel only when ``noise`` is None (tRGB always, every
    layer at ``noise_mode='none'``)."""

    def __init__(self, w_dim: int, in_channels: int, features: int,
                 kernel: int = 3, up: int = 1, demodulate: bool = True,
                 use_noise: bool = True, act: str = "lrelu",
                 resample_filter: tuple = (1, 3, 3, 1),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel, self.up, self.demodulate = kernel, up, demodulate
        self.use_noise, self.act, self.dtype = use_noise, act, dtype
        self.resample_filter = tuple(resample_filter)
        # style affine "A": bias 1 so styles start at identity
        self.affine = EqualDense(w_dim, in_channels, bias_init=1.0)
        self.w = nn.Parameter(torch.empty(kernel, kernel, in_channels,
                                          features))
        self.b = nn.Parameter(torch.empty(features))
        self.noise_strength = (nn.Parameter(torch.empty(()))
                               if use_noise else None)

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.w.normal_(0.0, 1.0, generator=gen)
            self.b.zero_()
            if self.noise_strength is not None:
                self.noise_strength.zero_()

    def forward(self, x: torch.Tensor, w_style: torch.Tensor,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [N,H,W,Cin], w_style [N,w_dim]; ``noise`` [N,H',W',1] at the
        output resolution, or None for no noise."""
        styles = self.affine(w_style)
        coef = 1.0 / math.sqrt(self.w.shape[2] * self.kernel**2)
        weight = (self.w * coef).to(self.dtype)
        x = x.to(self.dtype)
        if noise is None:
            return modulated_conv2d(
                x, weight, styles, demodulate=self.demodulate, up=self.up,
                resample_filter=self.resample_filter, bias=self.b,
                act=self.act)
        if self.noise_strength is None:
            raise ValueError("noise passed to a layer built without noise")
        y = modulated_conv2d(x, weight, styles, demodulate=self.demodulate,
                             up=self.up,
                             resample_filter=self.resample_filter)
        y = y + noise.to(self.dtype) * self.noise_strength.to(self.dtype)
        return fused_bias_act(y, self.b, act=self.act)
