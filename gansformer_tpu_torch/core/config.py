"""Model configuration of the PyTorch port.

A copy of the model half of ``gansformer_tpu/core/config.py``: the same
``ModelConfig`` fields with the same defaults, the same fmap schedule, and
the model part of the named presets.  It reads the ``model`` section of a
``config.json`` written by the JAX trainer.  ``conv_backend`` and
``attention_backend`` are accepted and ignored: in the port the device of
the tensor picks the path (kernel on the card, plain version on the CPU).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Tuple


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

    # numerics: compute dtype of the conv/matmul paths; params stay fp32
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
