"""Discriminator (PyTorch counterpart of
``gansformer_tpu/models/discriminator.py``): fromRGB at full resolution,
residual blocks {3x3 conv, blur-pool 3x3 down conv, 1x1 decimated skip,
sum / sqrt 2} down to 4x4, minibatch stddev, 3x3 head conv, dense head,
an fp32 logit (or the label projection head when ``label_dim > 0``).

The blur-pool and decimated-skip FIR legs run through ``upfirdn2d`` (the
kernel on the card); the dense convs are ``F.conv2d``.  D attention
(``d_attention``) waits for the attention backward kernels.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from gansformer_tpu_torch.core.config import ModelConfig
from gansformer_tpu_torch.models.layers import (EqualConv, EqualDense,
                                                minibatch_stddev)


class Discriminator(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.d_attention:
            raise NotImplementedError(
                "d_attention needs the attention backward kernels, which "
                "the port does not have yet")
        self.cfg = cfg
        self.dtype = dt = getattr(torch, cfg.dtype)
        f = cfg.blur_filter
        self.from_rgb = EqualConv(cfg.img_channels, cfg.nf(cfg.resolution),
                                  kernel=1, act="lrelu", dtype=dt)
        cin = cfg.nf(cfg.resolution)
        for res in reversed(cfg.block_resolutions[1:]):      # R, ..., 8
            nf_out = cfg.nf(res // 2)
            setattr(self, f"b{res}_conv0", EqualConv(
                cin, cin, act="lrelu", resample_filter=f, dtype=dt))
            setattr(self, f"b{res}_conv1", EqualConv(
                cin, nf_out, down=2, act="lrelu", resample_filter=f,
                dtype=dt))
            setattr(self, f"b{res}_skip", EqualConv(
                cin, nf_out, kernel=1, down=2, use_bias=False,
                resample_filter=f, dtype=dt))
            cin = nf_out
        nf4 = cfg.nf(4)
        self.head_conv = EqualConv(cin + cfg.mbstd_num_features, nf4,
                                   act="lrelu", dtype=dt)
        self.head_fc = EqualDense(4 * 4 * nf4, cfg.nf(2), act="lrelu",
                                  dtype=dt)
        if cfg.label_dim > 0:
            self.head_out = EqualDense(cfg.nf(2), cfg.nf(2))
            self.label_embed = EqualDense(cfg.label_dim, cfg.nf(2))
        else:
            self.head_out = EqualDense(cfg.nf(2), 1)

    def forward(self, img: torch.Tensor,
                label: Optional[torch.Tensor] = None) -> torch.Tensor:
        """img [N, R, R, C] (+ label [N, label_dim]) -> logits [N, 1]
        (fp32)."""
        cfg = self.cfg
        n = img.shape[0]
        x = self.from_rgb(img.to(self.dtype))
        for res in reversed(cfg.block_resolutions[1:]):
            t = getattr(self, f"b{res}_conv0")(x)
            t = getattr(self, f"b{res}_conv1")(t)
            skip = getattr(self, f"b{res}_skip")(x)
            x = (t + skip) * (1.0 / math.sqrt(2.0))
        x = minibatch_stddev(x, cfg.mbstd_group_size, cfg.mbstd_num_features)
        x = self.head_conv(x)
        x = self.head_fc(x.reshape(n, -1))
        if cfg.label_dim > 0:
            if label is None:
                raise ValueError("conditional discriminator needs a label")
            feat = self.head_out(x.float())
            cmap = self.label_embed(label.float())
            cmap = cmap * torch.rsqrt(cmap.square().mean(dim=-1, keepdim=True)
                                      + 1e-8)
            return (feat * cmap).sum(dim=-1, keepdim=True) / math.sqrt(
                cfg.nf(2))
        return self.head_out(x.float())
