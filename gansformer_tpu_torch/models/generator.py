"""Generator = mapping + synthesis, with truncation (PyTorch counterpart
of ``gansformer_tpu/models/generator.py`` and ``apply_truncation`` of
``gansformer_tpu/train/steps.py``)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from gansformer_tpu_torch.core.config import ModelConfig
from gansformer_tpu_torch.models.mapping import MappingNetwork
from gansformer_tpu_torch.models.synthesis import SynthesisNetwork


def apply_truncation(ws: torch.Tensor, w_avg: torch.Tensor,
                     truncation_psi) -> torch.Tensor:
    """ws' = w_avg + psi * (ws - w_avg).  ``truncation_psi`` is a float or
    a per-row [N] tensor."""
    if isinstance(truncation_psi, (int, float)):
        if truncation_psi == 1.0:
            return ws
        psi = truncation_psi
    else:
        psi = truncation_psi.to(ws.dtype)[:, None, None]
    wa = w_avg.to(ws.dtype)[None, None, :]
    return wa + psi * (ws - wa)


class Generator(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.mapping = MappingNetwork(
            latent_dim=cfg.latent_dim, w_dim=cfg.w_dim,
            hidden_dim=cfg.mapping_dim, num_layers=cfg.mapping_layers,
            lrmul=cfg.mapping_lrmul, label_dim=cfg.label_dim)
        self.synthesis = SynthesisNetwork(cfg)

    def forward(self, z: torch.Tensor, noise_mode: str = "random",
                truncation_psi=1.0, w_avg: Optional[torch.Tensor] = None,
                label: Optional[torch.Tensor] = None,
                noise_gens: Optional[Sequence[torch.Generator]] = None
                ) -> torch.Tensor:
        """z [N, num_ws, latent_dim] -> images [N, R, R, C]."""
        ws = self.mapping(z, label)
        if not (isinstance(truncation_psi, (int, float))
                and truncation_psi == 1.0):
            assert w_avg is not None, "truncation needs the w_avg EMA"
            ws = apply_truncation(ws, w_avg, truncation_psi)
        return self.synthesis(ws, noise_mode=noise_mode,
                              noise_gens=noise_gens)

    def map(self, z: torch.Tensor,
            label: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.mapping(z, label)

    def synthesize(self, ws: torch.Tensor, noise_mode: str = "random",
                   noise_gens: Optional[Sequence[torch.Generator]] = None
                   ) -> torch.Tensor:
        return self.synthesis(ws, noise_mode=noise_mode,
                              noise_gens=noise_gens)


def init_weights(module: nn.Module, seed: int) -> nn.Module:
    """Random init with the flax initializers' distributions, from one CPU
    ``torch.Generator`` walked in module order (so a seed gives the same
    weights on every device)."""
    gen = torch.Generator().manual_seed(int(seed))
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(gen)
    return module
