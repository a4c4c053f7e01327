"""JAX generator params -> the port's modules.

The JAX package's flax tree (``ema_params`` as nested dicts of numpy
arrays, e.g. from ``jax.device_get``) maps 1:1 onto the port's parameter
names with ``/`` for ``.``: ``synthesis/b8_conv_up/affine/w``,
``synthesis/b16_attn/dup0_k_x/w``, ``synthesis/b16_wattn_gate``,
``mapping/fc7/b``.  Both sides store parameters at unit scale in the same
NHWC/HWIO layouts (equalized-LR scaling happens at use), so loading is a
pure copy.  Any missing, extra or misshapen leaf raises.

The on-disk exchange format read by ``--params-npz`` is one ``.npz`` whose
keys are those ``/``-joined names, plus an optional ``w_avg``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

W_AVG_KEY = "w_avg"


def flatten_params(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested mapping -> {'a/b/c': leaf}.  A single top-level ``params``
    collection (flax ``variables``) is unwrapped."""
    if not prefix and set(tree.keys()) == {"params"}:
        tree = tree["params"]
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_params(v, name))
        else:
            out[name] = v
    return out


def param_shapes(module: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """{flax-style name: shape} of the module's parameters."""
    return {name.replace(".", "/"): tuple(p.shape)
            for name, p in module.named_parameters()}


def check_structure(module: nn.Module, flat: Mapping[str, Any]) -> None:
    """Raise unless ``flat`` has exactly the module's leaves, shape for
    shape."""
    want = param_shapes(module)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    bad = sorted(f"{k}: {tuple(np.shape(flat[k]))} != {want[k]}"
                 for k in set(want) & set(flat)
                 if tuple(np.shape(flat[k])) != want[k])
    if missing or extra or bad:
        raise ValueError(f"param trees differ: missing {missing}, extra "
                         f"{extra}, shape mismatches {bad}")


def load_flax_params(module: nn.Module, params: Mapping[str, Any]
                     ) -> nn.Module:
    """Copy a flax param tree (nested or already flattened) into
    ``module``; raises on any missing or extra leaf."""
    flat = flatten_params(params)
    check_structure(module, flat)
    with torch.no_grad():
        for name, p in module.named_parameters():
            src = np.array(flat[name.replace(".", "/")], np.float32)  # copy
            p.copy_(torch.from_numpy(src).reshape(p.shape))
    return module


def load_params_npz(path: str) -> Tuple[Dict[str, np.ndarray],
                                        Optional[np.ndarray]]:
    """(flat generator params, w_avg or None) from an exported ``.npz``."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return flat, flat.pop(W_AVG_KEY, None)
