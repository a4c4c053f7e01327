"""Train steps of the port (counterparts of ``_d_step`` and ``_g_step``
at ``do_pl=False`` in ``gansformer_tpu/train/steps.py``), run eagerly.

* ``d_step``: fakes from G under ``no_grad``, D on reals (optionally
  mirrored) and fakes, the logistic loss, one lazy-Adam update of D.
* ``d_step_r1``: ``d_step`` with the lazy R1 penalty (``do_r1``): a third
  D forward on the first ``N // r1_batch_shrink`` (mirrored) reals, their
  image gradient with its graph, and ``(r1_gamma / 2) * r1 *
  d_reg_interval`` added to the loss; ``Loss/D`` stays the logistic
  loss, as in JAX, and ``Loss/D/r1`` is the penalty.
* ``g_step``: G with style mixing, D on the fakes (D's parameters frozen),
  the non-saturating loss, one lazy-Adam update of G, then the EMA
  (``ema_beta_at`` of the step before the update) and ``w_avg`` (beta
  0.995 over the mixed ``ws``); ``step`` grows by the batch.
* ``g_step_pl``: ``g_step`` with the lazy path-length penalty
  (``do_pl``): fresh latents for ``N // pl_batch_shrink`` samples through
  the mapping (with its graph, no mixing) and the synthesis with its own
  conv noise, the penalty (``losses.path_length_penalty``: the gradient
  of a noise projection wrt ``ws`` with its graph) and ``pl_weight * pl
  * g_reg_interval`` added to the loss; ``Loss/G/pl`` is the penalty and
  ``pl_mean`` takes its new EMA after the update.

The metric samplers (``sample_images``, ``ppl_pairs`` and
``make_metric_samplers``: JAX's ``_sample``, ``_ppl_pairs`` and
``make_metric_samplers``) drive the EMA generator without a graph for
the metric sweeps.

Randomness is the port's own (``jax.random`` streams cannot be
reproduced): every draw of iteration ``it`` comes from generators seeded
by ``derive_seed(state.seed, it, phase, ...)``.  z, the mixing draws and
the mirror flips come from one CPU ``torch.Generator`` (so they are the
same on every device); each row's conv noise comes from its own generator
on the device.  Callers may pass ``z`` to use their own latents.  The
path-length draws are tagged ``"pl"``: its latents from a CPU generator,
its projection noise and conv noise from the device's; ``z_pl`` and
``pl_noise`` stand in for them.  Host draws reach the card from pinned
memory without a host sync (``core.device.to_device``), so a run of
iterations makes no host round trip.

On the card the ops build their graphs through the kernels'
``autograd.Function``s (the conv family's and both attention
directions'), so every forward launch that autograd records has its
backward kernel; G's forward under ``no_grad`` in ``d_step`` launches the
forward kernels alone.  In ``d_step_r1`` D's backward is differentiated
once more, in ``g_step_pl`` G's: the modconv, upfirdn and attention
Functions build that graph too (``ops/modulated_conv.py``,
``ops/upfirdn2d.py``, ``ops/cuda_attention.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from gansformer_tpu_torch.core.device import to_device
from gansformer_tpu_torch.core.precision import input_dtype, widen
from gansformer_tpu_torch.data.dataset import normalize_images
from gansformer_tpu_torch.losses.gan import (d_logistic_loss,
                                             g_nonsaturating_loss,
                                             path_length_penalty,
                                             r1_penalty, r1_slice)
from gansformer_tpu_torch.models.generator import apply_truncation
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
        z2 = to_device(torch.randn(shape, generator=gen), dev)
        cut = to_device(torch.randint(1, m.num_ws, (batch, 1),
                                      generator=gen), dev)
        do_mix = to_device(torch.rand((batch, 1), generator=gen)
                           < t.style_mixing_prob, dev)
    flip = to_device(torch.rand(batch, generator=gen) < 0.5, dev)
    gens = None
    if noise_mode == "random":
        gens = [torch.Generator(device=dev).manual_seed(
            derive_seed(state.seed, it, phase, "noise", row))
            for row in range(batch)]
    return StepDraws(z=to_device(z, dev).to(input_dtype(m.dtype)), z2=z2,
                     cut=cut, do_mix=do_mix, flip=flip, noise_gens=gens)


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
           label: Optional[torch.Tensor] = None,
           do_r1: bool = False) -> Dict[str, torch.Tensor]:
    """One D update on uint8 reals ``images`` [N, R, R, C], with the R1
    penalty when ``do_r1``.  Leaves D's gradients in ``.grad``; returns
    the loss and mean scores (and ``Loss/D/r1``) as device scalars, no
    host sync."""
    reals = normalize_images(to_device(images, state.device)).to(
        input_dtype(state.model.dtype))
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
    aux = {"Loss/D": loss.detach(),
           "Loss/scores/real": widen(real_logits.detach()).mean(),
           "Loss/scores/fake": widen(fake_logits.detach()).mean()}
    if do_r1:
        t = state.train
        reals_r1 = r1_slice(reals, t.r1_batch_shrink)
        label_r1 = None if label is None else label[:reals_r1.shape[0]]
        r1 = r1_penalty(lambda x: d(x, label_r1), reals_r1)
        aux["Loss/D/r1"] = r1.detach()
        loss = loss + (t.r1_gamma * 0.5) * r1 * t.d_reg_interval
    state.d_opt.zero_grad(set_to_none=True)
    _backward(loss, d)
    state.d_opt.step()
    return aux


def d_step_r1(state: TrainState, images: torch.Tensor, it: int,
              **kwargs) -> Dict[str, torch.Tensor]:
    """``d_step`` with the R1 penalty, the step the training loop runs
    every ``d_reg_interval`` iterations."""
    return d_step(state, images, it, do_r1=True, **kwargs)


def pl_draws(state: TrainState, it: int, batch: int,
             z_pl: Optional[torch.Tensor] = None,
             noise_mode: str = "random"):
    """The path-length draws of iteration ``it``: (latents for ``batch //
    pl_batch_shrink`` samples, their conv noise generators or None)."""
    pl_batch = max(1, batch // max(1, state.train.pl_batch_shrink))
    m, dev = state.model, state.device
    gen = torch.Generator().manual_seed(derive_seed(state.seed, it, "g",
                                                    "pl"))
    drawn = torch.randn((pl_batch, m.num_ws, m.latent_dim), generator=gen)
    z_pl = drawn if z_pl is None else z_pl
    gens = None
    if noise_mode == "random":
        gens = [torch.Generator(device=dev).manual_seed(
            derive_seed(state.seed, it, "g", "pl", "noise", row))
            for row in range(pl_batch)]
    return to_device(z_pl, dev).to(input_dtype(m.dtype)), gens


def pl_term(state: TrainState, it: int, batch: int,
            z_pl: Optional[torch.Tensor] = None,
            pl_noise: Optional[torch.Tensor] = None,
            noise_mode: str = "random",
            label: Optional[torch.Tensor] = None):
    """(penalty, new pl_mean) of iteration ``it`` of a step at ``batch``;
    ``pl_noise`` (a standard normal draw of the PL images' shape) stands
    in for the projection noise."""
    m, dev, gen = state.model, state.device, state.generator
    z_pl, noise_gens = pl_draws(state, it, batch, z_pl, noise_mode)
    pl_batch = z_pl.shape[0]
    shape = (pl_batch, m.resolution, m.resolution, m.img_channels)
    if pl_noise is None:
        pl_noise = torch.randn(shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(derive_seed(state.seed, it, "g", "pl",
                                                "projection")))
    ws = gen.map(z_pl, None if label is None else label[:pl_batch])
    return path_length_penalty(
        lambda w: gen.synthesize(w, noise_mode=noise_mode,
                                 noise_gens=noise_gens),
        ws, state.pl_mean, to_device(pl_noise, dev), state.train.pl_decay)


def g_step(state: TrainState, it: int, batch: int, *,
           z: Optional[torch.Tensor] = None, noise_mode: str = "random",
           label: Optional[torch.Tensor] = None, do_pl: bool = False,
           z_pl: Optional[torch.Tensor] = None,
           pl_noise: Optional[torch.Tensor] = None
           ) -> Dict[str, torch.Tensor]:
    """One G update, then the EMA and ``w_avg``, with the path-length
    penalty when ``do_pl`` (then ``pl_mean`` takes its new EMA too).
    Leaves G's gradients in ``.grad``; D's parameters take no
    gradient."""
    draws = draw_step(state, it, "g", batch, z, noise_mode)
    d = state.discriminator
    d.requires_grad_(False)
    try:
        fakes, ws = g_forward(state.generator, draws, noise_mode, label)
        loss = g_nonsaturating_loss(d(fakes, label))
        aux = {"Loss/G": loss.detach()}
        if do_pl:
            t = state.train
            pl, new_pl_mean = pl_term(state, it, batch, z_pl, pl_noise,
                                      noise_mode, label)
            aux["Loss/G/pl"] = pl.detach()
            loss = loss + t.pl_weight * pl * t.g_reg_interval
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
        w_batch_avg = widen(ws.detach()).mean(dim=(0, 1))
        state.w_avg.copy_(state.w_avg * W_AVG_BETA
                          + w_batch_avg * (1.0 - W_AVG_BETA))
        if do_pl:
            state.pl_mean.copy_(new_pl_mean)
    state.step += batch
    return aux


def g_step_pl(state: TrainState, it: int, batch: int,
              **kwargs) -> Dict[str, torch.Tensor]:
    """``g_step`` with the path-length penalty, the step the training loop
    runs every ``g_reg_interval`` iterations."""
    return g_step(state, it, batch, do_pl=True, **kwargs)


# ---------------- metric samplers ----------------

def sample_images(state: TrainState, z: torch.Tensor, truncation_psi=1.0,
                  label: Optional[torch.Tensor] = None,
                  noise_mode: str = "random",
                  noise_gens: Optional[List[torch.Generator]] = None
                  ) -> torch.Tensor:
    """The EMA generator's images of latents ``z`` (JAX's ``_sample``):
    map, truncate toward ``w_avg`` by psi, synthesize."""
    ema = state.ema
    with torch.no_grad():
        ws = apply_truncation(ema.map(z, label), state.w_avg, truncation_psi)
        return ema.synthesize(ws, noise_mode=noise_mode,
                              noise_gens=noise_gens)


def ppl_pairs(state: TrainState, z0: torch.Tensor, z1: torch.Tensor,
              t: torch.Tensor, epsilon: float,
              label: Optional[torch.Tensor] = None,
              noise_mode: str = "random",
              noise_seeds: Optional[List[int]] = None):
    """The w-space lerp endpoints of PPL (JAX's ``_ppl_pairs``): the EMA
    generator's images at ``t`` and ``t + epsilon`` between the mapped
    ``z0`` and ``z1``, without truncation.  The pair shares its synthesis
    noise: a generator is consumed as it draws, so each image gets its
    own generators, built from the same ``noise_seeds`` (one per row)."""
    ema = state.ema

    def gens():
        if noise_seeds is None:
            return None
        return [torch.Generator(device=z0.device).manual_seed(s)
                for s in noise_seeds]

    with torch.no_grad():
        w0 = ema.map(z0, label)
        w1 = ema.map(z1, label)
        tt = t.to(w0.device, w0.dtype)[:, None, None]
        wa = w0 + (w1 - w0) * tt
        wb = w0 + (w1 - w0) * (tt + epsilon)
        img_a = ema.synthesize(wa, noise_mode=noise_mode, noise_gens=gens())
        img_b = ema.synthesize(wb, noise_mode=noise_mode, noise_gens=gens())
    return img_a, img_b


def make_metric_samplers(state: TrainState, cfg, dataset,
                         truncation_psi: float = 1.0, seed: int = 7,
                         device=None):
    """(sample_fn, pair_fn) for ``MetricGroup.run``, on the state's
    device (``device`` must name the same one).  ``sample_fn(n)``: the
    k-th call draws z from a CPU generator seeded ``derive_seed(seed,
    "sample", k)``, its labels (conditional models) through
    ``dataset.random_labels`` and row i's conv noise from a generator
    seeded ``derive_seed(seed, "sample", k, "noise", i)`` on the device.
    ``pair_fn(n, t, pair_seed, epsilon)``: z0 and z1 from
    ``derive_seed(pair_seed, "ppl")``, labels from ``pair_seed``, the
    noise of row i from ``derive_seed(pair_seed, "ppl", "noise", i)``
    for both images (JAX's pair probe depends on ``pair_seed`` alone
    too)."""
    import numpy as np

    dev = state.device
    if device is not None and torch.device(device) != dev:
        raise ValueError(f"the state lies on {dev}, not {device}")
    m = cfg.model
    dt = input_dtype(m.dtype)
    calls = [0]

    def labels(n: int, label_seed: int):
        if not m.label_dim:
            return None
        return to_device(torch.from_numpy(np.ascontiguousarray(
            dataset.random_labels(n, seed=label_seed))), dev)

    def sample_fn(n: int) -> torch.Tensor:
        k = calls[0]
        calls[0] += 1
        gen = torch.Generator().manual_seed(derive_seed(seed, "sample", k))
        z = torch.randn((n, m.num_ws, m.latent_dim), generator=gen)
        gens = [torch.Generator(device=dev).manual_seed(
            derive_seed(seed, "sample", k, "noise", row))
            for row in range(n)]
        return sample_images(
            state, to_device(z, dev).to(dt), truncation_psi,
            labels(n, derive_seed(seed, "sample", k, "label") % 2**30),
            noise_gens=gens)

    def pair_fn(n: int, ts, pair_seed: int, epsilon: float):
        gen = torch.Generator().manual_seed(derive_seed(pair_seed, "ppl"))
        shape = (n, m.num_ws, m.latent_dim)
        z0 = torch.randn(shape, generator=gen)
        z1 = torch.randn(shape, generator=gen)
        t = torch.as_tensor(np.asarray(ts, np.float32))
        return ppl_pairs(
            state, to_device(z0, dev).to(dt), to_device(z1, dev).to(dt),
            to_device(t, dev), epsilon, labels(n, int(pair_seed)),
            noise_seeds=[derive_seed(pair_seed, "ppl", "noise", row)
                         for row in range(n)])

    return sample_fn, pair_fn
