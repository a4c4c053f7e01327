"""GAN losses (PyTorch counterpart of ``gansformer_tpu/losses/gan.py``):
the non-saturating logistic G loss, the logistic D loss, reduced in fp32,
the R1 penalty with its batch slice, and the path-length penalty."""

from __future__ import annotations

from typing import Callable, Tuple

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


def path_length_penalty(synthesize: Callable[[torch.Tensor], torch.Tensor],
                        ws: torch.Tensor, pl_mean: torch.Tensor,
                        noise: torch.Tensor, pl_decay: float = 0.01
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The path-length regularizer: ``(penalty, new_pl_mean)``.

    ``synthesize`` maps ``ws`` [N, num_ws, D] (which requires grad) to
    images [N, H, W, C] with G's parameters closed over.  ``noise`` is a
    standard normal draw of the images' shape; it is cast to the images'
    dtype and divided by sqrt(H * W) in that dtype, as the JAX package
    draws it.  The projection sum(img * noise) is taken in fp32, its
    gradient wrt ``ws`` keeps its graph (``create_graph``), and each
    sample's length is sqrt(mean over ws of the sum over D of its
    square), in fp32.  ``new_pl_mean`` is the EMA of the detached lengths;
    the penalty is mean((length - new_pl_mean)^2)."""
    img = synthesize(ws)
    h, w = img.shape[1], img.shape[2]
    noise = noise.to(img.dtype) / torch.sqrt(
        torch.tensor(h * w, dtype=img.dtype, device=img.device))
    proj = (widen(img) * widen(noise)).sum()
    (g,) = torch.autograd.grad(proj, [ws], create_graph=True)
    lengths = widen(g).square().sum(dim=2).mean(dim=1).sqrt()
    new_pl_mean = pl_mean + pl_decay * (lengths.detach().mean() - pl_mean)
    penalty = (lengths - new_pl_mean).square().mean()
    return penalty, new_pl_mean
