from gansformer_tpu_torch.core.config import (PRESETS, TRAIN_PRESETS,
                                              ModelConfig, TrainConfig,
                                              get_preset, get_train_preset,
                                              model_config_from_json,
                                              train_config_from_json)
from gansformer_tpu_torch.core.device import (kernel_route, resolve_device,
                                              wants_graph)

__all__ = ["PRESETS", "TRAIN_PRESETS", "ModelConfig", "TrainConfig",
           "get_preset", "get_train_preset", "model_config_from_json",
           "train_config_from_json", "kernel_route", "resolve_device",
           "wants_graph"]
