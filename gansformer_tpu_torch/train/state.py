"""Train state of the port (counterpart of ``gansformer_tpu/train/state.py``):
the generator, the discriminator, their lazy-regularization Adam
optimizers, the EMA generator, ``w_avg`` and ``pl_mean``.

Parameters stay fp32 whatever the compute dtype.  ``step`` counts images,
as in the JAX state.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
from typing import Iterable, Union

import torch

from gansformer_tpu_torch.core.config import ModelConfig, TrainConfig
from gansformer_tpu_torch.core.device import resolve_device
from gansformer_tpu_torch.models.discriminator import Discriminator
from gansformer_tpu_torch.models.generator import Generator, init_weights


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit seed that depends only on ``seed`` and ``tags``."""
    key = ":".join(str(t) for t in (int(seed),) + tags)
    h = hashlib.blake2b(key.encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def lazy_adam(params: Iterable[torch.nn.Parameter], lr: float, beta1: float,
              beta2: float, eps: float, reg_interval: int
              ) -> torch.optim.Adam:
    """Adam with the lazy-regularization correction ``c = I / (I + 1)``
    applied to lr, beta1 and beta2.  The JAX trainer applies it at every
    step, whether or not a regularizer fires, and so does the port."""
    c = reg_interval / (reg_interval + 1.0)
    return torch.optim.Adam(params, lr=lr * c, betas=(beta1**c, beta2**c),
                            eps=eps)


@dataclasses.dataclass
class TrainState:
    model: ModelConfig
    train: TrainConfig
    seed: int
    step: int                          # images seen (cur_nimg)
    generator: Generator
    discriminator: Discriminator
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    ema: Generator                     # EMA of the generator (eval weights)
    w_avg: torch.Tensor                # [w_dim] fp32 mapping-output EMA
    pl_mean: torch.Tensor              # scalar path-length EMA

    @property
    def device(self) -> torch.device:
        return self.w_avg.device


def create_train_state(model: ModelConfig, train: TrainConfig, seed: int = 0,
                       device: Union[str, torch.device, None] = None
                       ) -> TrainState:
    """Random init from ``seed`` (weights drawn on the CPU, so a seed gives
    the same state on every device); ``device=None`` is the card."""
    dev = resolve_device(device)
    g = init_weights(Generator(model), derive_seed(seed, "generator")).to(dev)
    d = init_weights(Discriminator(model),
                     derive_seed(seed, "discriminator")).to(dev)
    ema = copy.deepcopy(g).requires_grad_(False)
    t = train
    return TrainState(
        model=model, train=train, seed=int(seed), step=0, generator=g,
        discriminator=d,
        g_opt=lazy_adam(g.parameters(), t.g_lr, t.adam_beta1, t.adam_beta2,
                        t.adam_eps, t.g_reg_interval),
        d_opt=lazy_adam(d.parameters(), t.d_lr, t.adam_beta1, t.adam_beta2,
                        t.adam_eps, t.d_reg_interval),
        ema=ema,
        w_avg=torch.zeros(model.w_dim, device=dev),
        pl_mean=torch.zeros((), device=dev))
