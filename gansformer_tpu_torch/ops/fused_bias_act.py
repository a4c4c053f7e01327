"""fused_bias_act: ``act(x + b) * gain``, plain PyTorch.

The counterpart of ``gansformer_tpu/ops/fused_bias_act.py``.  On the JAX
side it is an XLA composite that fuses into the neighbouring op; here it
is elementwise torch code, and the linear/lrelu cases also run as the
epilogue of the modconv and upfirdn kernels.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

_SQRT2 = math.sqrt(2.0)

# name -> (fn(x, alpha), default_gain); the reference's activation table.
# lrelu is where(x >= 0, x, a*x): slope 1 at 0, unlike torch's leaky_relu
# backward.
ACTIVATIONS = {
    "linear": (lambda x, a: x, 1.0),
    "relu": (lambda x, a: torch.clamp_min(x, 0.0), _SQRT2),
    "lrelu": (lambda x, a: torch.where(x >= 0, x, x * a), _SQRT2),
    "tanh": (lambda x, a: torch.tanh(x), 1.0),
    "sigmoid": (lambda x, a: torch.sigmoid(x), 1.0),
    "elu": (lambda x, a: F.elu(x), 1.0),
    "selu": (lambda x, a: F.selu(x), 1.0),
    "softplus": (lambda x, a: F.softplus(x), 1.0),
    "swish": (lambda x, a: F.silu(x), _SQRT2),
}


def default_gain(act: str, gain: Optional[float] = None) -> float:
    return ACTIVATIONS[act][1] if gain is None else float(gain)


def fused_bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None,
                   act: str = "linear", alpha: float = 0.2,
                   gain: Optional[float] = None) -> torch.Tensor:
    """``act(x + b) * gain`` with the bias broadcast over the last (channel)
    axis."""
    fn, _ = ACTIVATIONS[act]
    if b is not None:
        assert b.ndim == 1 and b.shape[0] == x.shape[-1]
        x = x + b.to(x.dtype)
    x = fn(x, alpha)
    g = default_gain(act, gain)
    if g != 1.0:
        # a Python scalar keeps x's dtype and, unlike a tensor made on the
        # host, costs no host-to-device copy (which would sync the stream)
        x = x * g
    return x
