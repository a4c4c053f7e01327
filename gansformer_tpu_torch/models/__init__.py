from gansformer_tpu_torch.models.attention import BipartiteAttention
from gansformer_tpu_torch.models.generator import (Generator,
                                                   apply_truncation,
                                                   init_weights)
from gansformer_tpu_torch.models.layers import EqualDense, ModulatedConv
from gansformer_tpu_torch.models.mapping import MappingNetwork
from gansformer_tpu_torch.models.synthesis import SynthesisNetwork

__all__ = ["BipartiteAttention", "EqualDense", "Generator", "MappingNetwork",
           "ModulatedConv", "SynthesisNetwork", "apply_truncation",
           "init_weights"]
