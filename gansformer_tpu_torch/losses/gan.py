"""GAN losses (PyTorch counterpart of ``gansformer_tpu/losses/gan.py``):
the non-saturating logistic G loss, the logistic D loss, reduced in fp32,
and the R1 penalty with its batch slice.  The path-length penalty comes
with G's second-order step."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from gansformer_tpu_torch.core.precision import widen


def g_nonsaturating_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    """-log sigmoid(D(G(z))), the reference's ``G_logistic_ns``."""
    return F.softplus(-widen(fake_logits)).mean()


def d_logistic_loss(real_logits: torch.Tensor,
                    fake_logits: torch.Tensor) -> torch.Tensor:
    """softplus(D(fake)) + softplus(-D(real)), the reference's
    ``D_logistic``."""
    return (F.softplus(widen(fake_logits)).mean()
            + F.softplus(-widen(real_logits)).mean())


def r1_penalty(d_score: Callable[[torch.Tensor], torch.Tensor],
               reals: torch.Tensor) -> torch.Tensor:
    """R1 = E[ ||grad_x D(x)||^2 ] on real images: the gradient of the
    summed scores wrt the fp32 reals, squared and summed over the
    non-batch dimensions, averaged over the batch.  ``d_score`` closes
    over D's parameters; the gradient keeps its graph
    (``create_graph``), so the penalty differentiates wrt them."""
    x = widen(reals.detach()).requires_grad_(True)
    (g,) = torch.autograd.grad(d_score(x).sum(), [x], create_graph=True)
    return g.square().sum(dim=tuple(range(1, g.ndim))).mean()


def r1_slice(reals: torch.Tensor, batch_shrink: int) -> torch.Tensor:
    """The first ``N // batch_shrink`` reals, the batch R1 is taken on
    (the ``r1_batch_shrink`` lever).  A prefix of a shuffled batch is an
    exchangeable subsample, so the lazy-regularization weight stays as
    it is; ``batch_shrink`` must divide N (``core.config.validate``).
    The caller slices a label the same way."""
    assert batch_shrink >= 1
    if batch_shrink == 1:
        return reals
    n = reals.shape[0]
    assert n % batch_shrink == 0, (n, batch_shrink)
    return reals[: n // batch_shrink]
