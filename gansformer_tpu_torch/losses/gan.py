"""GAN losses (PyTorch counterpart of ``gansformer_tpu/losses/gan.py``):
the non-saturating logistic G loss and the logistic D loss, reduced in
fp32.  R1 and the path-length penalty come with the second-order steps."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def g_nonsaturating_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    """-log sigmoid(D(G(z))), the reference's ``G_logistic_ns``."""
    return F.softplus(-fake_logits.float()).mean()


def d_logistic_loss(real_logits: torch.Tensor,
                    fake_logits: torch.Tensor) -> torch.Tensor:
    """softplus(D(fake)) + softplus(-D(real)), the reference's
    ``D_logistic``."""
    return (F.softplus(fake_logits.float()).mean()
            + F.softplus(-real_logits.float()).mean())
