"""Equalized-learning-rate layers (PyTorch).

The counterparts of ``EqualDense`` and ``ModulatedConv`` in
``gansformer_tpu/models/layers.py``.  Parameters are stored at unit scale
in fp32 under the flax names (``w``, ``b``, ``noise_strength``,
``affine``) and scaled by ``gain / sqrt(fan_in) * lrmul`` at use, so
bridging JAX weights is a pure copy.  Compute may run in bf16 (``dtype``).
``EqualConv`` and ``minibatch_stddev`` belong to the discriminator and
wait for its slice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from gansformer_tpu_torch.ops.fused_bias_act import fused_bias_act
from gansformer_tpu_torch.ops.modulated_conv import modulated_conv2d


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
        y = x.to(self.dtype) @ (self.w * coef).to(self.dtype)
        return fused_bias_act(y, self.b * self.lrmul, act=self.act)


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
