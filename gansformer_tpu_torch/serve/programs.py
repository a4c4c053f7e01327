"""Generation programs: the serving half of the generator (PyTorch
counterpart of ``gansformer_tpu/serve/programs.py``).

* ``map_seeds``  - seeds [B] -> ws: z_i from a CPU ``torch.Generator``
  seeded by seed_i (so z is the same on every device), then mapping.
* ``map_z``      - explicit latents -> ws.
* ``synthesize`` - (ws, psi [B], seed, tags [B]) -> images: per-row
  truncation, then synthesis.  Row i's noise comes from its own
  generator seeded by ``noise_seed(seed, tags[i])``, so a row's image
  never depends on the bucket it was padded into or on its neighbours.

The seed -> z and per-row noise rules are the port's own: ``jax.random``
streams cannot be reproduced in torch.  Programs run eagerly; the AOT
executables, warm-start manifest, cache and service thread of the JAX
package wait for later slices.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from gansformer_tpu_torch.core.config import ModelConfig
from gansformer_tpu_torch.core.device import resolve_device
from gansformer_tpu_torch.models.generator import (Generator,
                                                   apply_truncation,
                                                   init_weights)

DEFAULT_BUCKETS = (1, 2, 4, 8)


@dataclasses.dataclass(frozen=True)
class GeneratorBundle:
    """Everything generation needs, on one device."""

    cfg: ModelConfig
    generator: Generator             # eval mode, no grads
    w_avg: torch.Tensor              # [w_dim] fp32 truncation anchor

    @property
    def device(self) -> torch.device:
        return self.w_avg.device


def sorted_buckets(buckets: Iterable[int]) -> Tuple[int, ...]:
    out = tuple(sorted({int(b) for b in buckets}))
    if not out or out[0] < 1:
        raise ValueError(f"batch buckets must be positive ints, got "
                         f"{buckets!r}")
    return out


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; larger requests are the caller's to chunk."""
    if n < 1:
        raise ValueError(f"bucket_for: need n >= 1, got {n}")
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"batch of {n} exceeds the largest bucket "
                     f"{buckets[-1]}; chunk the request batch first")


def seeds_to_z(seeds: Sequence[int], cfg: ModelConfig) -> torch.Tensor:
    """z [B, num_ws, latent_dim] fp32 on the CPU; row i depends on seed_i
    only."""
    rows = [torch.randn((cfg.num_ws, cfg.latent_dim),
                        generator=torch.Generator().manual_seed(int(s)))
            for s in seeds]
    return torch.stack(rows)


def noise_seed(seed: int, tag: int) -> int:
    """The 63-bit seed of the noise generator of a row tagged ``tag``."""
    h = hashlib.blake2b(f"{int(seed)}:{int(tag)}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def noise_generators(seed: int, tags: Sequence[int],
                     device: torch.device) -> list:
    return [torch.Generator(device=device).manual_seed(noise_seed(seed, t))
            for t in tags]


def bundle_from_generator(generator: Generator,
                          w_avg: Optional[torch.Tensor] = None,
                          device: Union[str, torch.device, None] = None
                          ) -> GeneratorBundle:
    dev = resolve_device(device)
    generator = generator.to(dev).eval().requires_grad_(False)
    if w_avg is None:
        w_avg = torch.zeros(generator.cfg.w_dim)
    return GeneratorBundle(cfg=generator.cfg, generator=generator,
                           w_avg=w_avg.to(device=dev, dtype=torch.float32))


def init_generator(cfg: ModelConfig, seed: int = 0,
                   device: Union[str, torch.device, None] = None
                   ) -> GeneratorBundle:
    """Randomly initialized bundle (no checkpoint): the path that measures
    serving on the real architecture without trained weights.  Weights
    come from a CPU generator, so a seed gives the same weights on every
    device."""
    dev = resolve_device(device)
    return bundle_from_generator(init_weights(Generator(cfg), seed),
                                 device=dev)


class ServePrograms:
    """map / synthesize over padded batch buckets, on the bundle's device."""

    def __init__(self, bundle: GeneratorBundle,
                 buckets: Iterable[int] = DEFAULT_BUCKETS):
        self.bundle = bundle
        self.buckets = sorted_buckets(buckets)
        self.device = bundle.device

    def _full_bucket(self, n: int, what: str) -> int:
        bucket = bucket_for(n, self.buckets)
        if n != bucket:
            raise ValueError(f"{what} takes a full bucket ({self.buckets}); "
                             f"pad {n} rows to {bucket} first")
        return bucket

    def _label(self, bucket: int, label) -> Optional[torch.Tensor]:
        m = self.bundle.cfg
        if not m.label_dim:
            if label is not None:
                raise ValueError("label passed to an unconditional model")
            return None
        if label is None:
            raise ValueError(f"model has label_dim={m.label_dim}; requests "
                             f"must carry a label vector")
        label = torch.as_tensor(np.asarray(label, np.float32))
        if tuple(label.shape) != (bucket, m.label_dim):
            raise ValueError(f"label shape {tuple(label.shape)} != "
                             f"({bucket}, {m.label_dim})")
        return label.to(self.device)

    @torch.inference_mode()
    def map_seeds(self, seeds, label=None) -> torch.Tensor:
        """seeds [bucket] -> ws [bucket, num_ws, w_dim] (fp32, device)."""
        seeds = [int(s) for s in np.asarray(seeds).reshape(-1)]
        bucket = self._full_bucket(len(seeds), "map_seeds")
        z = seeds_to_z(seeds, self.bundle.cfg).to(self.device)
        return self.bundle.generator.map(z, self._label(bucket, label))

    @torch.inference_mode()
    def map_z(self, z, label=None) -> torch.Tensor:
        z = torch.as_tensor(np.asarray(z, np.float32)) \
            if not isinstance(z, torch.Tensor) else z
        bucket = self._full_bucket(z.shape[0], "map_z")
        return self.bundle.generator.map(z.to(self.device, torch.float32),
                                         self._label(bucket, label))

    @torch.inference_mode()
    def synthesize(self, ws: torch.Tensor, psi, seed: int = 0,
                   tags=None, noise_mode: str = "random") -> torch.Tensor:
        """ws [bucket, num_ws, w_dim], psi [bucket] (per row), tags [bucket]
        (per-row noise identities; default: row positions) ->
        images [bucket, R, R, C] fp32 on the device."""
        psi = torch.as_tensor(np.asarray(psi, np.float32)).reshape(-1)
        bucket = self._full_bucket(psi.shape[0], "synthesize")
        if ws.shape[0] != bucket:
            raise ValueError(f"ws has {ws.shape[0]} rows, psi {bucket}")
        tags = (list(range(bucket)) if tags is None
                else [int(t) for t in np.asarray(tags).reshape(-1)])
        if len(tags) != bucket:
            raise ValueError(f"{len(tags)} tags for {bucket} rows")
        ws = apply_truncation(ws.to(self.device, torch.float32),
                              self.bundle.w_avg, psi.to(self.device))
        gens = (noise_generators(seed, tags, self.device)
                if noise_mode == "random" else None)
        return self.bundle.generator.synthesize(ws, noise_mode=noise_mode,
                                                noise_gens=gens)
