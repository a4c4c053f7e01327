"""Synthesis network (PyTorch counterpart of
``gansformer_tpu/models/synthesis.py``): const 4x4 -> modulated-conv blocks
with bipartite attention -> tRGB skip accumulation through ``upsample_2d``.

Style routing: 'global' styles every conv by the global latent;
'attention' adds a ReZero-gated projection of the refined latents after
each attention block (``b{res}_wattn`` + ``b{res}_wattn_gate``).

Noise is drawn per row from the caller's ``torch.Generator``s (one per
batch row), so a row's noise depends only on its own generator.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from gansformer_tpu_torch.core.config import ModelConfig
from gansformer_tpu_torch.models.attention import BipartiteAttention
from gansformer_tpu_torch.models.layers import EqualDense, ModulatedConv
from gansformer_tpu_torch.ops.upfirdn2d import upsample_2d

NOISE_MODES = ("random", "none")


def draw_noise(gens: Sequence[torch.Generator], res: int,
               device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """[N, res, res, 1] standard normal noise, row i from ``gens[i]``."""
    rows = [torch.randn((res, res, 1), generator=g, device=g.device)
            for g in gens]
    return torch.stack(rows).to(device=device, dtype=dtype)


class SynthesisNetwork(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.sequence_parallel:
            raise NotImplementedError("sequence_parallel waits for the "
                                      "data-parallel slice of the port")
        assert cfg.style_mode in ("global", "attention"), cfg.style_mode
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        dt, f = self.dtype, cfg.blur_filter
        self.const = nn.Parameter(torch.empty(1, 4, 4, cfg.nf(4)))
        attn_res = set(cfg.attn_resolutions())
        cin = cfg.nf(4)
        for res in cfg.block_resolutions:
            nf = cfg.nf(res)
            if res > 4:
                setattr(self, f"b{res}_conv_up", ModulatedConv(
                    cfg.w_dim, cin, nf, up=2, resample_filter=f, dtype=dt))
            setattr(self, f"b{res}_conv", ModulatedConv(
                cfg.w_dim, nf, nf, resample_filter=f, dtype=dt))
            if res in attn_res:
                setattr(self, f"b{res}_attn", BipartiteAttention(
                    grid_dim=nf, latent_dim=cfg.w_dim, resolution=res,
                    num_heads=cfg.num_heads,
                    duplex=(cfg.attention == "duplex"),
                    integration=cfg.integration,
                    kmeans_iters=cfg.kmeans_iters,
                    pos_encoding=cfg.pos_encoding, dtype=dt,
                    fused_kv=cfg.attn_fused_kv))
                if cfg.style_mode == "attention":
                    setattr(self, f"b{res}_wattn",
                            EqualDense(cfg.w_dim, cfg.w_dim))
                    self.register_parameter(f"b{res}_wattn_gate",
                                            nn.Parameter(torch.empty(())))
            setattr(self, f"b{res}_trgb", ModulatedConv(
                cfg.w_dim, nf, cfg.img_channels, kernel=1, demodulate=False,
                use_noise=False, act="linear", dtype=dt))
            cin = nf

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.const.normal_(0.0, 1.0, generator=gen)
            for name, p in self.named_parameters(recurse=False):
                if name.endswith("_wattn_gate"):
                    p.zero_()

    def forward(self, ws: torch.Tensor, noise_mode: str = "random",
                noise_gens: Optional[Sequence[torch.Generator]] = None
                ) -> torch.Tensor:
        """ws [N, num_ws, w_dim] -> images [N, R, R, C] (fp32).

        ``noise_mode='random'`` needs ``noise_gens``: one generator per
        row, drawn from in layer order."""
        cfg, dt = self.cfg, self.dtype
        n = ws.shape[0]
        assert ws.shape[1] == cfg.num_ws
        assert noise_mode in NOISE_MODES, f"bad noise_mode {noise_mode!r}"
        if noise_mode == "random" and (noise_gens is None
                                       or len(noise_gens) != n):
            raise ValueError("noise_mode='random' needs one torch.Generator "
                             "per row (noise_gens)")
        if cfg.use_global:
            w_global, y = ws[:, -1], ws[:, :cfg.components]
        else:
            w_global, y = ws.mean(dim=1), ws
        y = y.to(dt)

        def noise(res):
            if noise_mode == "none":
                return None
            return draw_noise(noise_gens, res, ws.device, dt)

        attn_res = set(cfg.attn_resolutions())
        x = self.const.expand(n, -1, -1, -1).to(dt)
        w_style = w_global
        rgb: Optional[torch.Tensor] = None
        for res in cfg.block_resolutions:
            if res > 4:
                x = getattr(self, f"b{res}_conv_up")(x, w_style, noise(res))
            x = getattr(self, f"b{res}_conv")(x, w_style, noise(res))
            if res in attn_res:
                x, y = getattr(self, f"b{res}_attn")(x, y)
                if cfg.style_mode == "attention":
                    w_attn = getattr(self, f"b{res}_wattn")(
                        y.mean(dim=1).float())
                    gate = getattr(self, f"b{res}_wattn_gate")
                    w_style = w_global + gate * w_attn
            t = getattr(self, f"b{res}_trgb")(x, w_style)
            rgb = t if rgb is None else upsample_2d(rgb, cfg.blur_filter) + t
        return rgb.float()
