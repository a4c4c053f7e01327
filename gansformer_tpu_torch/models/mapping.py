"""Mapping network z -> w, shared across the latent components (PyTorch
counterpart of ``gansformer_tpu/models/mapping.py``): per-component pixel
norm, then an lrelu MLP with lr-multiplier 0.01, in fp32."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gansformer_tpu_torch.core.precision import widen
from gansformer_tpu_torch.models.layers import EqualDense


def _pixel_norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + 1e-8)


class MappingNetwork(nn.Module):
    def __init__(self, latent_dim: int = 512, w_dim: int = 512,
                 hidden_dim: int = 512, num_layers: int = 8,
                 lrmul: float = 0.01, label_dim: int = 0):
        super().__init__()
        self.num_layers, self.label_dim = num_layers, label_dim
        if label_dim > 0:
            self.label_embed = EqualDense(label_dim, latent_dim)
        width = latent_dim * (2 if label_dim > 0 else 1)
        for i in range(num_layers):
            out = w_dim if i == num_layers - 1 else hidden_dim
            setattr(self, f"fc{i}", EqualDense(width, out, lrmul=lrmul,
                                               act="lrelu"))
            width = out

    def forward(self, z: torch.Tensor,
                label: Optional[torch.Tensor] = None) -> torch.Tensor:
        """z [N, num_ws, latent_dim] (+ label [N, label_dim]) ->
        w [N, num_ws, w_dim] in fp32."""
        assert z.ndim == 3
        x = _pixel_norm(widen(z))
        if self.label_dim > 0:
            if label is None:
                raise ValueError("conditional mapping needs a label")
            y = _pixel_norm(self.label_embed(widen(label)))
            x = torch.cat([x, y[:, None, :].expand(x.shape[0], x.shape[1],
                                                   y.shape[-1])], dim=-1)
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
        return x
