"""Model and training configuration of the PyTorch port.

A copy of ``gansformer_tpu/core/config.py``'s ``ModelConfig`` (the same
fields with the same defaults, the same fmap schedule) and of the part of
its ``TrainConfig`` that the port's training steps use, with the
model and train parts of the named presets.  It reads the ``model`` and
``train`` sections of a ``config.json`` written by the JAX trainer, and
its ``data.mirror_augment``; ``validate`` runs the checks of the JAX
``ExperimentConfig.validate()`` that these fields reach.
``conv_backend`` and ``attention_backend`` are accepted and ignored: in
the port the device of the tensor picks the path (kernel on the card,
plain version on the CPU).  The attention-free configuration of a preset
is ``dataclasses.replace(get_preset(name), attention="none")``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Generator + discriminator architecture (field-for-field the JAX
    ``ModelConfig``, so a JAX ``config.json`` loads unchanged)."""

    resolution: int = 256
    img_channels: int = 3

    # latents: k components attend to the grid, one optional global
    # component drives the conv styles
    components: int = 16
    latent_dim: int = 512
    w_dim: int = 512
    use_global: bool = True
    label_dim: int = 0

    # mapping network
    mapping_layers: int = 8
    mapping_dim: int = 512
    mapping_lrmul: float = 0.01

    # synthesis
    fmap_base: int = 16384
    fmap_max: int = 512
    fmap_min: int = 1
    attention: str = "duplex"          # 'none' | 'simplex' | 'duplex'
    attn_start_res: int = 4
    attn_max_res: int = 128
    num_heads: int = 1
    integration: str = "both"          # 'add' | 'mul' | 'both'
    style_mode: str = "global"         # 'global' | 'attention'
    pos_encoding: str = "sinusoidal"   # 'sinusoidal' | 'learned' | 'none'
    kmeans_iters: int = 1
    sequence_parallel: bool = False
    attention_backend: str = "xla"     # accepted, ignored (device decides)
    conv_backend: str = "xla"          # accepted, ignored (device decides)
    attn_fused_kv: bool = False

    # discriminator
    mbstd_group_size: int = 4
    mbstd_num_features: int = 1
    d_attention: bool = False
    d_components: int = 16

    # numerics: compute dtype of the conv/matmul paths; params stay fp32.
    # 'float64' is the port's host-only reference mode (core/precision.py),
    # which ``validate`` refuses as the JAX package does.
    dtype: str = "float32"             # 'float32' | 'bfloat16'
    blur_filter: Tuple[int, ...] = (1, 3, 3, 1)

    @property
    def resolution_log2(self) -> int:
        r = self.resolution.bit_length() - 1
        assert self.resolution == 2**r and self.resolution >= 4
        return r

    @property
    def num_ws(self) -> int:
        """Latent components fed to mapping (k + optional global)."""
        return self.components + (1 if self.use_global else 0)

    def nf(self, res: int) -> int:
        """Feature maps at a block resolution (StyleGAN2 fmap schedule)."""
        stage = res.bit_length() - 1
        return int(min(max(self.fmap_base // (2**stage), self.fmap_min),
                       self.fmap_max))

    @property
    def block_resolutions(self) -> Tuple[int, ...]:
        return tuple(2**i for i in range(2, self.resolution_log2 + 1))

    def attn_resolutions(self) -> Tuple[int, ...]:
        if self.attention == "none":
            return ()
        return tuple(r for r in self.block_resolutions
                     if self.attn_start_res <= r <= self.attn_max_res)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ModelConfig":
        """From the ``model`` section of a JAX ``config.json`` (lists
        become tuples, as the JAX loader does).  Unknown keys raise."""
        names = {f.name for f in dataclasses.fields(ModelConfig)}
        extra = sorted(set(d) - names)
        if extra:
            raise ValueError(f"unknown ModelConfig keys: {extra}")
        return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in d.items()})


def model_config_from_json(text: str) -> ModelConfig:
    """The ``model`` section of a JAX run's ``config.json``."""
    return ModelConfig.from_dict(json.loads(text)["model"])


# The model part of the JAX presets (gansformer_tpu/core/config.py PRESETS).
PRESETS: Dict[str, ModelConfig] = {
    "clevr64-simplex": ModelConfig(
        resolution=64, components=8, attention="simplex", attn_max_res=32,
        fmap_base=2048, fmap_max=256, latent_dim=128, w_dim=128,
        mapping_dim=128, mapping_layers=4),
    "ffhq256-duplex": ModelConfig(
        resolution=256, components=16, attention="duplex", attn_max_res=128,
        dtype="bfloat16", style_mode="attention"),
    "bedroom256-duplex": ModelConfig(
        resolution=256, components=16, attention="duplex", attn_max_res=128,
        dtype="bfloat16", style_mode="attention"),
    "cityscapes256-duplex": ModelConfig(
        resolution=256, components=32, attention="duplex", attn_max_res=128,
        dtype="bfloat16", style_mode="attention"),
    "ffhq1024-duplex": ModelConfig(
        resolution=1024, components=16, attention="duplex", attn_max_res=128,
        dtype="bfloat16", style_mode="attention"),
}


def get_preset(name: str) -> ModelConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Two-timescale G/D Adam training with lazy regularization: the
    fields of the JAX ``TrainConfig`` that the port's steps read (same
    names and defaults).  R1 (``d_step_r1``) runs every
    ``d_reg_interval`` iterations on the first ``batch_size //
    r1_batch_shrink`` reals, weighted by ``r1_gamma``; path length
    (``g_step_pl``) every ``g_reg_interval`` iterations on ``batch_size
    // pl_batch_shrink`` fresh latents, weighted by ``pl_weight``, its
    mean length an EMA of rate ``pl_decay``."""

    batch_size: int = 32
    g_lr: float = 2e-3
    d_lr: float = 2e-3
    adam_beta1: float = 0.0
    adam_beta2: float = 0.99
    adam_eps: float = 1e-8
    r1_gamma: float = 10.0
    d_reg_interval: int = 16
    r1_batch_shrink: int = 1
    g_reg_interval: int = 4
    pl_weight: float = 2.0
    pl_decay: float = 0.01
    pl_batch_shrink: int = 2
    style_mixing_prob: float = 0.9
    ema_kimg: float = 10.0
    ema_rampup: Optional[float] = None
    seed: int = 0


# Keys of the JAX ``TrainConfig`` that the port reads and does not use yet
# (the tick loop, checkpoints, telemetry).
IGNORED_TRAIN_KEYS = frozenset({
    "total_kimg", "fused_cycle", "async_checkpoint", "kimg_per_tick",
    "snapshot_ticks", "image_snapshot_ticks", "metric_ticks", "metrics",
    "debug_nans", "profile_dir", "device_time_ticks"})


def train_config_from_dict(d: Dict[str, Any]) -> TrainConfig:
    """From the ``train`` section of a JAX ``config.json``.  Keys the port
    does not use yet are dropped; any other unknown key raises."""
    names = {f.name for f in dataclasses.fields(TrainConfig)}
    extra = sorted(set(d) - names - IGNORED_TRAIN_KEYS)
    if extra:
        raise ValueError(f"unknown TrainConfig keys: {extra}")
    return TrainConfig(**{k: v for k, v in d.items() if k in names})


def train_config_from_json(text: str) -> TrainConfig:
    """The ``train`` section of a JAX run's ``config.json``."""
    return train_config_from_dict(json.loads(text)["train"])


def mirror_augment_from_json(text: str) -> bool:
    """``data.mirror_augment`` of a JAX run's ``config.json`` (False
    where the section or the key is missing, the JAX default)."""
    return bool(json.loads(text).get("data", {}).get("mirror_augment",
                                                      False))


def validate(model: ModelConfig, train: TrainConfig) -> None:
    """The checks of the JAX ``ExperimentConfig.validate()`` that the
    port's model and train fields reach; raises ``ValueError`` listing
    every failure, with the JAX messages."""
    m, t = model, train
    errs = []
    if m.resolution < 8 or m.resolution & (m.resolution - 1):
        errs.append(f"model.resolution must be a power of two ≥ 8, "
                    f"got {m.resolution}")
    for name, allowed in (("attention", ("none", "simplex", "duplex")),
                          ("style_mode", ("global", "attention")),
                          ("integration", ("add", "mul", "both")),
                          ("attention_backend", ("xla", "pallas")),
                          ("conv_backend", ("xla", "pallas")),
                          ("dtype", ("float32", "bfloat16"))):
        if getattr(m, name) not in allowed:
            errs.append(f"model.{name} must be {'|'.join(allowed)}, "
                        f"got {getattr(m, name)!r}")
    if m.attention != "none" and m.attn_start_res > m.attn_max_res:
        errs.append(f"attn_start_res ({m.attn_start_res}) > "
                    f"attn_max_res ({m.attn_max_res})")
    if m.components < 1:
        errs.append(f"model.components must be ≥ 1, got {m.components}")
    if t.batch_size < 1:
        errs.append(f"train.batch_size must be ≥ 1, got {t.batch_size}")
    if m.mbstd_group_size > 1 and t.batch_size % m.mbstd_group_size:
        errs.append(
            f"train.batch_size ({t.batch_size}) must be divisible by "
            f"model.mbstd_group_size ({m.mbstd_group_size}) — the "
            f"stddev layer would silently use a smaller group")
    if t.pl_batch_shrink < 1:
        errs.append(f"pl_batch_shrink must be ≥ 1, got "
                    f"{t.pl_batch_shrink} (1 = full-batch probe)")
    elif t.batch_size % t.pl_batch_shrink:
        errs.append(f"pl_batch_shrink ({t.pl_batch_shrink}) must divide "
                    f"batch_size ({t.batch_size})")
    if t.r1_batch_shrink < 1:
        errs.append(f"r1_batch_shrink must be ≥ 1, got "
                    f"{t.r1_batch_shrink}")
    elif t.batch_size % t.r1_batch_shrink:
        errs.append(f"r1_batch_shrink ({t.r1_batch_shrink}) must divide "
                    f"batch_size ({t.batch_size}) — the R1 slice would "
                    f"silently truncate")
    if errs:
        raise ValueError("invalid config:\n  - " + "\n  - ".join(errs))


# The train part of the JAX presets.
TRAIN_PRESETS: Dict[str, TrainConfig] = {
    "clevr64-simplex": TrainConfig(batch_size=4, r1_gamma=1.0),
    "ffhq256-duplex": TrainConfig(batch_size=32, r1_gamma=10.0),
    "bedroom256-duplex": TrainConfig(batch_size=32, r1_gamma=100.0),
    "cityscapes256-duplex": TrainConfig(batch_size=32, r1_gamma=20.0),
    "ffhq1024-duplex": TrainConfig(batch_size=32, r1_gamma=32.0),
}


def get_train_preset(name: str) -> TrainConfig:
    if name not in TRAIN_PRESETS:
        raise KeyError(f"unknown preset {name!r}; have "
                       f"{sorted(TRAIN_PRESETS)}")
    return TRAIN_PRESETS[name]
