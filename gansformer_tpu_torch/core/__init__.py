from gansformer_tpu_torch.core.config import (PRESETS, ModelConfig,
                                              get_preset,
                                              model_config_from_json)
from gansformer_tpu_torch.core.device import kernel_route, resolve_device

__all__ = ["PRESETS", "ModelConfig", "get_preset", "model_config_from_json",
           "kernel_route", "resolve_device"]
