"""First-order train steps of the port (counterparts of ``_d_step`` at
``do_r1=False`` and ``_g_step`` at ``do_pl=False`` in
``gansformer_tpu/train/steps.py``), run eagerly.

* ``d_step``: fakes from G under ``no_grad``, D on reals (optionally
  mirrored) and fakes, the logistic loss, one lazy-Adam update of D.
* ``g_step``: G with style mixing, D on the fakes (D's parameters frozen),
  the non-saturating loss, one lazy-Adam update of G, then the EMA
  (``ema_beta_at`` of the step before the update) and ``w_avg`` (beta
  0.995 over the mixed ``ws``); ``step`` grows by the batch.

Randomness is the port's own (``jax.random`` streams cannot be
reproduced): every draw of iteration ``it`` comes from generators seeded
by ``derive_seed(state.seed, it, phase, ...)``.  z, the mixing draws and
the mirror flips come from one CPU ``torch.Generator`` (so they are the
same on every device); each row's conv noise comes from its own generator
on the device.  Callers may pass ``z`` to use their own latents.

On the card the ops build their graphs through the kernels'
``autograd.Function``s (the conv family's and both attention
directions'), so every forward launch that autograd records has its
backward kernel; G's forward under ``no_grad`` in ``d_step`` launches the
forward kernels alone.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from gansformer_tpu_torch.data.dataset import normalize_images
from gansformer_tpu_torch.losses.gan import (d_logistic_loss,
                                             g_nonsaturating_loss)
from gansformer_tpu_torch.train.state import TrainState, derive_seed

W_AVG_BETA = 0.995


@dataclasses.dataclass
class StepDraws:
    """The random inputs of one step."""

    z: torch.Tensor                        # [N, num_ws, latent_dim]
    z2: Optional[torch.Tensor]             # style mixing's second latents
    cut: Optional[torch.Tensor]            # [N, 1] crossover component
    do_mix: Optional[torch.Tensor]         # [N, 1] bool
    flip: torch.Tensor                     # [N] bool (mirror augment)
    noise_gens: Optional[List[torch.Generator]]


def draw_step(state: TrainState, it: int, phase: str, batch: int,
              z: Optional[torch.Tensor] = None, noise_mode: str = "random"
              ) -> StepDraws:
    """The draws of iteration ``it`` of ``phase`` ('d' or 'g')."""
    m, t, dev = state.model, state.train, state.device
    gen = torch.Generator().manual_seed(derive_seed(state.seed, it, phase))
    shape = (batch, m.num_ws, m.latent_dim)
    drawn = torch.randn(shape, generator=gen)
    z = drawn if z is None else z
    z2 = cut = do_mix = None
    if t.style_mixing_prob > 0:
        z2 = torch.randn(shape, generator=gen).to(dev)
        cut = torch.randint(1, m.num_ws, (batch, 1), generator=gen).to(dev)
        do_mix = (torch.rand((batch, 1), generator=gen)
                  < t.style_mixing_prob).to(dev)
    flip = (torch.rand(batch, generator=gen) < 0.5).to(dev)
    gens = None
    if noise_mode == "random":
        gens = [torch.Generator(device=dev).manual_seed(
            derive_seed(state.seed, it, phase, "noise", row))
            for row in range(batch)]
    return StepDraws(z=z.to(dev, torch.float32), z2=z2, cut=cut,
                     do_mix=do_mix, flip=flip, noise_gens=gens)


def g_forward(generator, draws: StepDraws, noise_mode: str = "random",
              label: Optional[torch.Tensor] = None):
    """Mapping (+ style mixing) + synthesis; returns (images, ws)."""
    ws = generator.map(draws.z, label)
    if draws.z2 is not None:
        ws2 = generator.map(draws.z2, label)
        comp = torch.arange(ws.shape[1], device=ws.device)[None, :]
        mask = (comp >= draws.cut) & draws.do_mix           # [N, num_ws]
        ws = torch.where(mask[..., None], ws2, ws)
    imgs = generator.synthesize(ws, noise_mode=noise_mode,
                                noise_gens=draws.noise_gens)
    return imgs, ws


def ema_beta_at(state: TrainState, batch: int) -> float:
    """Per-step EMA decay from the half-life in kimg, with the optional
    ramp-up cap, at the state's current ``step``."""
    t = state.train
    ema_nimg = t.ema_kimg * 1000.0
    if t.ema_rampup is not None:
        ema_nimg = min(ema_nimg, state.step * t.ema_rampup)
    return 0.5 ** (batch / max(ema_nimg, 1e-8))


def _backward(loss: torch.Tensor, module: torch.nn.Module) -> None:
    """loss.backward(), then a zero gradient for every parameter the loss
    did not reach (the generator's noise strengths at noise_mode='none'),
    so Adam steps every leaf as optax does."""
    loss.backward()
    for p in module.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def d_step(state: TrainState, images: torch.Tensor, it: int, *,
           z: Optional[torch.Tensor] = None, noise_mode: str = "random",
           mirror_augment: bool = False,
           label: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One D update on uint8 reals ``images`` [N, R, R, C].  Leaves D's
    gradients in ``.grad``; returns the loss and mean scores (device
    scalars, no host sync)."""
    reals = normalize_images(images.to(state.device))
    draws = draw_step(state, it, "d", reals.shape[0], z, noise_mode)
    if mirror_augment:
        reals = torch.where(draws.flip[:, None, None, None],
                            reals.flip(2), reals)
    with torch.no_grad():
        fakes, _ = g_forward(state.generator, draws, noise_mode, label)
    d = state.discriminator
    real_logits = d(reals, label)
    fake_logits = d(fakes, label)
    loss = d_logistic_loss(real_logits, fake_logits)
    state.d_opt.zero_grad(set_to_none=True)
    _backward(loss, d)
    state.d_opt.step()
    return {"Loss/D": loss.detach(),
            "Loss/scores/real": real_logits.detach().float().mean(),
            "Loss/scores/fake": fake_logits.detach().float().mean()}


def g_step(state: TrainState, it: int, batch: int, *,
           z: Optional[torch.Tensor] = None, noise_mode: str = "random",
           label: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One G update, then the EMA and ``w_avg``.  Leaves G's gradients in
    ``.grad``; D's parameters take no gradient."""
    draws = draw_step(state, it, "g", batch, z, noise_mode)
    d = state.discriminator
    d.requires_grad_(False)
    try:
        fakes, ws = g_forward(state.generator, draws, noise_mode, label)
        loss = g_nonsaturating_loss(d(fakes, label))
        state.g_opt.zero_grad(set_to_none=True)
        _backward(loss, state.generator)
    finally:
        d.requires_grad_(True)
    state.g_opt.step()
    beta = ema_beta_at(state, batch)
    with torch.no_grad():
        for e, p in zip(state.ema.parameters(),
                        state.generator.parameters()):
            e.copy_(e * beta + p * (1.0 - beta))
        w_batch_avg = ws.detach().float().mean(dim=(0, 1))
        state.w_avg.copy_(state.w_avg * W_AVG_BETA
                          + w_batch_avg * (1.0 - W_AVG_BETA))
    state.step += batch
    return {"Loss/G": loss.detach()}
