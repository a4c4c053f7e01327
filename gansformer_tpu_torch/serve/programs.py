"""Generation programs: the serving half of the generator (PyTorch
counterpart of ``gansformer_tpu/serve/programs.py``).

* ``map_seeds``  - seeds [B] -> ws: z_i from a CPU ``torch.Generator``
  seeded by seed_i (so z is the same on every device), then mapping.
* ``map_z``      - explicit latents -> ws.
* ``synthesize`` - (ws, psi [B], seed, tags [B]) -> images: per-row
  truncation, then synthesis.  Row i's noise comes from its own
  generator seeded by ``noise_seed(seed, tags[i])``, so a row's image
  never depends on the bucket it was padded into or on its neighbours.

The serving precision (``SERVE_PRECISIONS``) applies to the synth
program only: ``f32`` is the model as configured, ``bf16`` a copy of it
computing in bf16 on the fp32 weights (the fp32 islands stay fp32), and
``int8w`` that bf16 copy with every kernel replaced by its int8 codes and
fp32 scales (``serve/quant.py``).  The mapping always runs on the
original weights, so one cached w row serves every precision.

Programs run eagerly, so nothing is compiled per (kind, bucket): the
port's cold cost is the build of the kernel library, and ``warm_start``
loads it from the manifest of ``serve/warmstart.py`` or builds it.
Telemetry: ``serve/map_dispatch_total``, ``serve/synth_dispatch_total``,
``serve/compiles_total`` (library builds), and ``serve/restore_ms`` of
``load_generator``, the G-only checkpoint restore.

The seed -> z and per-row noise rules are the port's own: ``jax.random``
streams cannot be reproduced in torch.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from gansformer_tpu_torch.core.config import ExperimentConfig, ModelConfig
from gansformer_tpu_torch.core.device import resolve_device
from gansformer_tpu_torch.models.generator import (Generator,
                                                   apply_truncation,
                                                   init_weights)
from gansformer_tpu_torch.obs import registry as telemetry

DEFAULT_BUCKETS = (1, 2, 4, 8)

# The serving precision axis, synth program only: f32 (the model as
# configured), bf16 (bf16 activations, fp32 weights and islands), int8w
# (bf16 activations on int8 weight-only kernels, serve/quant.py).
SERVE_PRECISIONS = ("f32", "bf16", "int8w")

# The programs a warm start readies (JAX's constant).  Every program runs
# on the one kernel library, so the warm start is that library's and
# readies them all.
WARM_KINDS = ("map_seeds", "synthesize")


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


def synth_generator(generator: Generator, precision: str) -> Generator:
    """The generator the synth program of ``precision`` runs: the bundle's
    own for f32; for bf16 a copy built with ``dtype='bfloat16'`` on the
    same fp32 weights; for int8w that copy with its kernels quantized."""
    if precision not in SERVE_PRECISIONS:
        raise ValueError(f"serve_precision must be one of "
                         f"{SERVE_PRECISIONS}, got {precision!r}")
    if precision == "f32":
        return generator
    from gansformer_tpu_torch.serve.quant import quantize_module

    dev = next(generator.parameters()).device
    copy = Generator(dataclasses.replace(generator.cfg, dtype="bfloat16"))
    copy.load_state_dict(generator.state_dict())
    if precision == "int8w":
        quantize_module(copy)
    return copy.to(dev).eval().requires_grad_(False)


class ServePrograms:
    """map / synthesize over padded batch buckets, on the bundle's device.

    ``manifest_dir`` is where ``warm_start`` keeps the kernel library:
    with ``warm_start`` on, a checked ``manifest.json`` there lets a new
    process load it without a build (``serve/warmstart.py``); with it
    off, the library is built there and nothing is recorded.  Without a
    ``manifest_dir`` the library builds at first use in the package's
    ``_build/``."""

    def __init__(self, bundle: GeneratorBundle,
                 buckets: Iterable[int] = DEFAULT_BUCKETS,
                 manifest_dir: Optional[str] = None,
                 warm_start: bool = True,
                 serve_precision: str = "f32"):
        self.bundle = bundle
        self.buckets = sorted_buckets(buckets)
        self.device = bundle.device
        self.manifest_dir = manifest_dir
        self.warm_start_enabled = warm_start and manifest_dir is not None
        self.serve_precision = serve_precision
        self.synth_module = synth_generator(bundle.generator,
                                            serve_precision)
        # this instance's warm starts (the service's health reads them)
        self.warm_hits = 0
        self.manifest_stale = 0
        # explicit zeros: an idle service still exports the families
        telemetry.counter("serve/map_dispatch_total")
        telemetry.counter("serve/synth_dispatch_total")
        telemetry.counter("serve/compiles_total")

    # -- warm start ----------------------------------------------------------

    def warm_start(self) -> Dict[str, Any]:
        """Ready the programs of ``WARM_KINDS``: on the card, load the
        kernel library they all run on (from the manifest when its entry
        is valid, else build it).  Returns {loaded, compiled, seconds},
        where the counts are of libraries, 0 or 1; on the CPU the plain
        versions need none and both are 0."""
        if self.device.type != "cuda":
            return {"loaded": 0, "compiled": 0, "seconds": 0.0}
        from gansformer_tpu_torch.serve import warmstart

        if self.warm_start_enabled:
            stale0 = telemetry.counter("serve/manifest_stale_total").value
            out = warmstart.warm_start(self.manifest_dir)
            self.manifest_stale += int(telemetry.counter(
                "serve/manifest_stale_total").value - stale0)
            self.warm_hits += out["loaded"]
        else:
            out = warmstart.cold_start(self.manifest_dir)
        return {k: out[k] for k in ("loaded", "compiled", "seconds")}

    # -- dispatch ------------------------------------------------------------

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
        telemetry.counter("serve/map_dispatch_total").inc()
        return self.bundle.generator.map(z, self._label(bucket, label))

    @torch.inference_mode()
    def map_z(self, z, label=None) -> torch.Tensor:
        z = torch.as_tensor(np.asarray(z, np.float32)) \
            if not isinstance(z, torch.Tensor) else z
        bucket = self._full_bucket(z.shape[0], "map_z")
        telemetry.counter("serve/map_dispatch_total").inc()
        return self.bundle.generator.map(z.to(self.device, torch.float32),
                                         self._label(bucket, label))

    @torch.inference_mode()
    def synthesize(self, ws: torch.Tensor, psi, seed: int = 0,
                   tags=None, noise_mode: str = "random",
                   noise_device: Union[str, torch.device, None] = None
                   ) -> torch.Tensor:
        """ws [bucket, num_ws, w_dim], psi [bucket] (per row), tags [bucket]
        (per-row noise identities; default: row positions) ->
        images [bucket, R, R, C] fp32 on the device.  The noise is drawn
        on ``noise_device`` (default: the program's) and moved to the
        program's: drawn on the CPU, it is the same on every device."""
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
        gens = (noise_generators(seed, tags, torch.device(
            noise_device) if noise_device is not None else self.device)
                if noise_mode == "random" else None)
        telemetry.counter("serve/synth_dispatch_total").inc()
        return self.synth_module.synthesize(ws, noise_mode=noise_mode,
                                            noise_gens=gens)


# -- checkpoint surface ------------------------------------------------------

def load_generator(run_dir: str, cfg: Optional[ExperimentConfig] = None,
                   step: Optional[int] = None,
                   device: Union[str, torch.device, None] = None
                   ) -> GeneratorBundle:
    """The G-only restore of a run dir (the port's or the JAX package's):
    ``ema_params`` and ``w_avg`` of its newest checkpoint (or ``step``),
    read without building the discriminator or any optimizer state
    (``checkpoint.restore_generator``); the time goes to the
    ``serve/restore_ms`` gauge.  ``cfg`` defaults to the run's
    ``config.json``."""
    from gansformer_tpu_torch.bridge import load_flax_params
    from gansformer_tpu_torch.train import checkpoint as ckpt

    if cfg is None:
        with open(os.path.join(run_dir, "config.json")) as f:
            cfg = ExperimentConfig.from_json(f.read())
    t0 = time.perf_counter()
    g = Generator(cfg.model)
    got = ckpt.restore_generator(os.path.join(run_dir, "checkpoints"), g,
                                 step=step)
    params = {k[len("ema_params/"):]: v for k, v in got.items()
              if k.startswith("ema_params/")}
    bundle = bundle_from_generator(load_flax_params(g, params),
                                   torch.from_numpy(got["w_avg"]),
                                   device=device)
    telemetry.gauge("serve/restore_ms").set(
        (time.perf_counter() - t0) * 1000.0)
    return bundle
