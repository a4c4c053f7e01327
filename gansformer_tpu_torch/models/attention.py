"""Bipartite attention block (PyTorch counterpart of
``gansformer_tpu/models/attention.py``).

Simplex: the grid attends to the k latents and the result updates the
grid ('add' | 'mul' | 'both').  Duplex: first the latents attend over the
grid (a soft k-means centroid step, ``kmeans_iters`` rounds), then the
grid attends back.  Both directions run through
``fused_multihead_attention``: the kernels on the card, the plain version
on the CPU.  Grid sharding waits for the data-parallel slice.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from gansformer_tpu_torch.models.layers import EqualDense
from gansformer_tpu_torch.ops.attention import sinusoidal_grid_encoding
from gansformer_tpu_torch.ops.cuda_attention import fused_multihead_attention


def _instance_norm(x: torch.Tensor, dim: int = 1,
                   eps: float = 1e-8) -> torch.Tensor:
    """Non-affine instance norm over grid positions, an fp32 island with the
    population variance (``torch.var`` defaults to the unbiased one)."""
    x32 = x.float()
    mu = x32.mean(dim=dim, keepdim=True)
    var = x32.var(dim=dim, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


class BipartiteAttention(nn.Module):
    def __init__(self, grid_dim: int, latent_dim: int, resolution: int,
                 num_heads: int = 1, duplex: bool = False,
                 integration: str = "both", kmeans_iters: int = 1,
                 pos_encoding: str = "sinusoidal",
                 dtype: torch.dtype = torch.float32, fused_kv: bool = False):
        super().__init__()
        att = grid_dim                  # attention width
        c = grid_dim
        assert att % num_heads == 0
        assert integration in ("add", "mul", "both"), integration
        self.att, self.num_heads, self.duplex = att, num_heads, duplex
        self.integration, self.kmeans_iters = integration, kmeans_iters
        self.pos_encoding, self.dtype, self.fused_kv = (pos_encoding, dtype,
                                                        fused_kv)
        n = resolution * resolution
        dense = lambda i, o: EqualDense(i, o, dtype=dtype)  # noqa: E731
        if pos_encoding == "sinusoidal":
            pe_dim = max(4, (att // 4) * 4)
            self.register_buffer("pos_enc", torch.from_numpy(
                sinusoidal_grid_encoding(resolution, resolution, pe_dim)),
                persistent=False)
            self.pos_proj = dense(pe_dim, att)
        elif pos_encoding == "learned":
            self.pos_emb = nn.Parameter(torch.empty(1, n, att))
        elif pos_encoding != "none":
            raise ValueError(f"bad pos_encoding {pos_encoding!r}")
        if duplex:
            for it in range(kmeans_iters):
                setattr(self, f"dup{it}_q_y", dense(latent_dim, att))
                if fused_kv:
                    setattr(self, f"dup{it}_kv_x",
                            dense(c, att + latent_dim))
                else:
                    setattr(self, f"dup{it}_k_x", dense(c, att))
                    setattr(self, f"dup{it}_v_x", dense(c, latent_dim))
                setattr(self, f"dup{it}_gate", dense(latent_dim, latent_dim))
                setattr(self, f"dup{it}_proj", dense(latent_dim, latent_dim))
        self.q_x = dense(c, att)
        if fused_kv:
            self.kv_y = dense(latent_dim, 2 * att)
        else:
            self.k_y = dense(latent_dim, att)
            self.v_y = dense(latent_dim, att)
        if integration == "add":
            self.o_proj = dense(att, c)
        else:
            self.o_scale = dense(att, c)
            if integration == "both":
                self.o_shift = dense(att, c)

    def reset_parameters(self, gen: torch.Generator) -> None:
        if self.pos_encoding == "learned":
            with torch.no_grad():
                self.pos_emb.normal_(0.0, 0.02, generator=gen)

    def _attend(self, q, k, v):
        return fused_multihead_attention(q, k, v, self.num_heads)

    def forward(self, x: torch.Tensor,
                y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [N,H,W,C] grid, y [N,k,D] latents -> (updated x, updated y)."""
        n, h, w, c = x.shape
        att, dt = self.att, self.dtype
        grid = x.reshape(n, h * w, c)
        # position enters the grid's queries/keys only
        if self.pos_encoding == "sinusoidal":
            pos = self.pos_proj(self.pos_enc.to(dt))[None]
        elif self.pos_encoding == "learned":
            pos = self.pos_emb.to(dt)
        else:
            pos = torch.zeros((1, 1, att), dtype=dt, device=x.device)
        grid_qk = grid.to(dt)

        if self.duplex:
            for it in range(self.kmeans_iters):
                q_y = getattr(self, f"dup{it}_q_y")(y.to(dt))
                if self.fused_kv:
                    kv_x = getattr(self, f"dup{it}_kv_x")(grid_qk)
                    k_x, v_x = kv_x[..., :att] + pos, kv_x[..., att:]
                else:
                    k_x = getattr(self, f"dup{it}_k_x")(grid_qk) + pos
                    v_x = getattr(self, f"dup{it}_v_x")(grid.to(dt))
                upd = self._attend(q_y, k_x, v_x)
                gate = getattr(self, f"dup{it}_gate")(upd)
                y = y + torch.sigmoid(gate.float()).to(y.dtype) \
                    * getattr(self, f"dup{it}_proj")(upd).to(y.dtype)

        q_x = self.q_x(grid_qk) + pos
        if self.fused_kv:
            kv_y = self.kv_y(y.to(dt))
            k_y, v_y = kv_y[..., :att], kv_y[..., att:]
        else:
            k_y, v_y = self.k_y(y.to(dt)), self.v_y(y.to(dt))
        out = self._attend(q_x, k_y, v_y)

        if self.integration == "add":
            grid = grid + self.o_proj(out)
        else:
            grid = _instance_norm(grid, dim=1) * (1.0 + self.o_scale(out))
            if self.integration == "both":
                grid = grid + self.o_shift(out)
        return grid.reshape(n, h, w, c).to(x.dtype), y
