"""Configuration of the PyTorch port.

A copy of ``gansformer_tpu/core/config.py``: ``ModelConfig``,
``TrainConfig``, ``DataConfig`` and ``MeshConfig`` with the JAX fields and
defaults, ``ExperimentConfig`` with JAX's ``to_json`` layout (a port run's
``config.json`` is byte for byte what the JAX trainer writes for the same
configuration, and each package reads the other's), and the named
presets (``PRESETS`` / ``TRAIN_PRESETS`` / ``DATA_PRESETS`` hold their
parts, ``get_experiment_preset`` the whole).  ``validate`` and
``ExperimentConfig.validate`` run the checks of the JAX
``ExperimentConfig.validate()`` that the port reaches.
``conv_backend`` and ``attention_backend`` are accepted and ignored: in
the port the device of the tensor picks the path (kernel on the card,
plain version on the CPU).  The keys of ``IGNORED_TRAIN_KEYS`` are
carried (so a config round-trips) and not acted on yet (the device-time
sampler and the profiler).  The attention-free configuration of a
preset is ``dataclasses.replace(get_preset(name), attention="none")``.
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
    """Two-timescale G/D Adam training with lazy regularization, and the
    tick loop's cadence: field for field the JAX ``TrainConfig`` (same
    names and defaults).  R1 (``d_step_r1``) runs every
    ``d_reg_interval`` iterations on the first ``batch_size //
    r1_batch_shrink`` reals, weighted by ``r1_gamma``; path length
    (``g_step_pl``) every ``g_reg_interval`` iterations on ``batch_size
    // pl_batch_shrink`` fresh latents, weighted by ``pl_weight``, its
    mean length an EMA of rate ``pl_decay``.  The loop runs to
    ``total_kimg``, logs a tick every ``kimg_per_tick``, writes an image
    grid every ``image_snapshot_ticks`` and a checkpoint every
    ``snapshot_ticks`` ticks (on a writer thread when
    ``async_checkpoint``); ``debug_nans`` turns on anomaly detection and
    the per-tick finite checks.  ``fused_cycle`` is JAX's one dispatch
    per lazy-reg cycle of ``d_reg_interval`` iterations (a multiple of
    ``g_reg_interval``); the port's steps make no host round trip inside
    a cycle either way, so the loop only says it in ``log.txt``."""

    batch_size: int = 32
    total_kimg: int = 25000
    g_lr: float = 2e-3
    d_lr: float = 2e-3
    adam_beta1: float = 0.0
    adam_beta2: float = 0.99
    adam_eps: float = 1e-8
    r1_gamma: float = 10.0
    d_reg_interval: int = 16
    g_reg_interval: int = 4
    r1_batch_shrink: int = 1
    pl_weight: float = 2.0
    pl_decay: float = 0.01
    pl_batch_shrink: int = 2
    style_mixing_prob: float = 0.9
    ema_kimg: float = 10.0
    ema_rampup: Optional[float] = None
    fused_cycle: bool = False
    async_checkpoint: bool = True
    kimg_per_tick: int = 4
    snapshot_ticks: int = 10
    image_snapshot_ticks: int = 10
    metric_ticks: int = 50
    metrics: str = ""
    seed: int = 0
    debug_nans: bool = False
    profile_dir: Optional[str] = None  # ignored: device sampling is later
    device_time_ticks: int = 8         # ignored


# Keys of the JAX ``TrainConfig`` that the port carries and does not act on
# yet: the device-time sampler and profiler.  The loop says so in log.txt
# when one is set.
IGNORED_TRAIN_KEYS = frozenset({"profile_dir", "device_time_ticks"})


def _from_dict(cls, d: Dict[str, Any], what: str):
    names = {f.name for f in dataclasses.fields(cls)}
    extra = sorted(set(d) - names)
    if extra:
        raise ValueError(f"unknown {what} keys: {extra}")
    return cls(**d)


def train_config_from_dict(d: Dict[str, Any]) -> TrainConfig:
    """From the ``train`` section of a JAX ``config.json``; an unknown
    key raises."""
    return _from_dict(TrainConfig, d, "TrainConfig")


def train_config_from_json(text: str) -> TrainConfig:
    """The ``train`` section of a JAX run's ``config.json``."""
    return train_config_from_dict(json.loads(text)["train"])


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """The dataset pipeline, field for field the JAX ``DataConfig``.
    ``source``: 'synthetic' (procedural images), 'npz', 'tfrecord' (the
    reference's multi-resolution records) or 'folder' (decoded with
    Pillow, on a host that has it).  ``prefetch`` is the depth of the
    host prefetch queue.  ``device_prefetch`` (JAX's copies off the
    critical path, ``device_prefetch_depth`` batches ahead) is taken and
    said in ``log.txt``: the port's loop copies each batch from pinned
    memory without a host sync either way.  Corrupt records are
    quarantined until more than ``max_corrupt_frac`` of them are (then
    ``DataCorrupt``), transient reads retry ``io_retries`` times from
    ``io_retry_base_s``, and a producer that makes no progress for
    ``stall_after_s`` (0: never) raises ``DataStalled``."""

    name: str = "synthetic"
    path: Optional[str] = None
    resolution: int = 256
    channels: int = 3
    source: str = "synthetic"
    shuffle_buffer: int = 4096         # accepted; the record index shuffles
    prefetch: int = 2
    device_prefetch: bool = True
    device_prefetch_depth: int = 2     # JAX's device ring size, in batches
    mirror_augment: bool = False
    max_corrupt_frac: float = 0.01
    io_retries: int = 3
    io_retry_base_s: float = 0.05
    stall_after_s: float = 120.0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The JAX ``MeshConfig``, carried so a config round-trips.  The port
    trains on one device: a mesh of more than one device raises in
    ``ExperimentConfig.validate``."""

    data: int = -1
    model: int = 1
    fsdp: bool = False
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str = "default"
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def validate(self) -> "ExperimentConfig":
        """``validate(model, train)`` plus the data checks of the JAX
        ``validate()`` and the port's one-device rule; raises
        ``ValueError`` listing every failure.  Returns self."""
        errs = []
        try:
            validate(self.model, self.train)
        except ValueError as e:
            errs += [ln.strip()[2:] for ln in str(e).splitlines()[1:]]
        d, m, t = self.data, self.mesh, self.train
        if t.fused_cycle and (t.g_reg_interval < 1 or t.d_reg_interval
                              % t.g_reg_interval):
            errs.append(
                f"train.fused_cycle needs d_reg_interval "
                f"({t.d_reg_interval}) to be a multiple of g_reg_interval "
                f"({t.g_reg_interval})")
        if d.device_prefetch and d.device_prefetch_depth < 1:
            errs.append(f"data.device_prefetch_depth must be ≥ 1, got "
                        f"{d.device_prefetch_depth}")
        if not 0.0 <= d.max_corrupt_frac <= 1.0:
            errs.append(f"data.max_corrupt_frac must be in [0, 1], got "
                        f"{d.max_corrupt_frac}")
        if d.io_retries < 0:
            errs.append(f"data.io_retries must be ≥ 0, got {d.io_retries}")
        if d.io_retry_base_s <= 0:
            errs.append(f"data.io_retry_base_s must be > 0, got "
                        f"{d.io_retry_base_s}")
        if d.stall_after_s < 0:
            errs.append(f"data.stall_after_s must be ≥ 0 (0 = watchdog "
                        f"off), got {d.stall_after_s}")
        if d.source not in ("synthetic", "npz", "tfrecord", "folder"):
            errs.append(f"data.source must be synthetic|npz|tfrecord|"
                        f"folder, got {d.source!r}")
        if (m.data > 1 or m.model > 1 or m.fsdp
                or (m.num_processes or 1) > 1
                or m.coordinator_address is not None):
            errs.append(
                f"the port trains on one device; this mesh asks for more "
                f"(data={m.data}, model={m.model}, fsdp={m.fsdp}, "
                f"num_processes={m.num_processes}): data parallelism over "
                f"several cards comes with its own slice")
        if errs:
            raise ValueError("invalid config:\n  - " + "\n  - ".join(errs))
        return self

    def to_json(self) -> str:
        """The JAX ``ExperimentConfig.to_json`` layout."""
        return json.dumps(dataclasses.asdict(self), indent=2,
                          sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "ExperimentConfig":
        """A JAX (or port) ``config.json``; ``name``, ``train`` and
        ``mesh`` take their defaults where missing, ``data`` its defaults
        at the model's resolution.  Unknown keys raise."""
        d = json.loads(s)
        model = ModelConfig.from_dict(d["model"])
        return ExperimentConfig(
            name=d.get("name", "default"), model=model,
            train=train_config_from_dict(d.get("train", {})),
            data=_from_dict(DataConfig, d.get(
                "data", {"resolution": model.resolution}), "DataConfig"),
            mesh=_from_dict(MeshConfig, d.get("mesh", {}), "MeshConfig"))


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
    "clevr64-simplex": TrainConfig(batch_size=4, total_kimg=100,
                                   kimg_per_tick=1, r1_gamma=1.0),
    "ffhq256-duplex": TrainConfig(batch_size=32, total_kimg=25000,
                                  r1_gamma=10.0),
    "bedroom256-duplex": TrainConfig(batch_size=32, total_kimg=25000,
                                     r1_gamma=100.0),
    "cityscapes256-duplex": TrainConfig(batch_size=32, total_kimg=25000,
                                        r1_gamma=20.0),
    "ffhq1024-duplex": TrainConfig(batch_size=32, total_kimg=25000,
                                   r1_gamma=32.0),
}

# The data part and the names of the JAX presets.
DATA_PRESETS: Dict[str, DataConfig] = {
    "clevr64-simplex": DataConfig(name="clevr", resolution=64,
                                  source="synthetic"),
    "ffhq256-duplex": DataConfig(name="ffhq", resolution=256,
                                 source="tfrecord"),
    "bedroom256-duplex": DataConfig(name="lsun-bedroom", resolution=256,
                                    source="tfrecord"),
    "cityscapes256-duplex": DataConfig(name="cityscapes", resolution=256,
                                       source="tfrecord"),
    "ffhq1024-duplex": DataConfig(name="ffhq", resolution=1024,
                                  source="tfrecord"),
}


def get_train_preset(name: str) -> TrainConfig:
    if name not in TRAIN_PRESETS:
        raise KeyError(f"unknown preset {name!r}; have "
                       f"{sorted(TRAIN_PRESETS)}")
    return TRAIN_PRESETS[name]


def get_experiment_preset(name: str) -> ExperimentConfig:
    """The whole JAX preset: name, model, train and data parts."""
    return ExperimentConfig(name=name, model=get_preset(name),
                            train=get_train_preset(name),
                            data=DATA_PRESETS[name])
