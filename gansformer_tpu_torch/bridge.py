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

A whole JAX ``TrainState`` (leaves as numpy arrays, e.g. from
``jax.device_get``) crosses the same way: ``flatten_train_state`` gives
one flat dict (``g_params/...``, ``d_params/...``, ``ema_params/...``,
``g_opt/count``, ``g_opt/mu/...``, ``g_opt/nu/...``, the same for
``d_opt``, ``w_avg``, ``step``, ``pl_mean``), which may be saved as an
``.npz``; ``load_train_state`` copies it into the port's ``TrainState``.
optax's Adam state ``(ScaleByAdamState(count, mu, nu), ...)`` becomes each
torch parameter's ``step``/``exp_avg``/``exp_avg_sq``.  Any missing, extra
or misshapen leaf raises.  ``port_train_state_flat`` is the way back (the
port's state as that flat dict), and ``jax_leaf_keys`` lists its keys in
the order ``jax.tree_util.tree_flatten`` gives the JAX ``TrainState``'s
leaves (its fields in declared order, dict keys sorted level by level,
Adam's ``count, mu, nu``), which is the leaf order of the JAX checkpoint
format (``train/checkpoint.py``).
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


_PARAM_TREES = (("g_params", "generator"), ("d_params", "discriminator"),
                ("ema_params", "ema"))
_OPT_TREES = (("g_opt", "generator", "g_opt"),
              ("d_opt", "discriminator", "d_opt"))
_SCALARS = ("w_avg", "step", "pl_mean")


def _adam_state(opt_state: Any):
    """The one ``(count, mu, nu)`` entry of an optax chain state."""
    found = [s for s in (opt_state if isinstance(opt_state, (tuple, list))
                         else (opt_state,))
             if all(hasattr(s, a) for a in ("count", "mu", "nu"))]
    if len(found) != 1:
        raise ValueError(f"expected one Adam state (count, mu, nu) in the "
                         f"optimizer state, found {len(found)}")
    return found[0]


def flatten_train_state(state: Any) -> Dict[str, np.ndarray]:
    """A JAX ``TrainState`` with numpy leaves -> one flat dict of arrays."""
    flat: Dict[str, np.ndarray] = {}
    for tree, _ in _PARAM_TREES:
        for k, v in flatten_params(getattr(state, tree)).items():
            flat[f"{tree}/{k}"] = np.asarray(v)
    for tree, _, _ in _OPT_TREES:
        adam = _adam_state(getattr(state, tree))
        flat[f"{tree}/count"] = np.asarray(adam.count)
        for part in ("mu", "nu"):
            for k, v in flatten_params(getattr(adam, part)).items():
                flat[f"{tree}/{part}/{k}"] = np.asarray(v)
    for name in _SCALARS:
        flat[name] = np.asarray(getattr(state, name))
    return flat


def _subtree(flat: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in flat.items() if k.startswith(prefix + "/")}


def train_state_keys(state) -> set:
    """Every key ``load_train_state`` needs for the port's ``state``."""
    keys = set(_SCALARS)
    for tree, attr in _PARAM_TREES:
        keys |= {f"{tree}/{k}" for k in param_shapes(getattr(state, attr))}
    for tree, attr, _ in _OPT_TREES:
        names = param_shapes(getattr(state, attr))
        keys.add(f"{tree}/count")
        keys |= {f"{tree}/{p}/{k}" for p in ("mu", "nu") for k in names}
    return keys


def load_train_state(state, flat: Mapping[str, Any]):
    """Copy a flat JAX train state into the port's ``TrainState`` (params,
    EMA, both Adam states, ``w_avg``, ``step``, ``pl_mean``); raises on
    any missing or extra leaf."""
    want = train_state_keys(state)
    missing, extra = sorted(want - set(flat)), sorted(set(flat) - want)
    if missing or extra:
        raise ValueError(f"train states differ: missing {missing}, extra "
                         f"{extra}")
    for tree, attr in _PARAM_TREES:
        load_flax_params(getattr(state, attr), _subtree(flat, tree))
    for tree, attr, opt_attr in _OPT_TREES:
        module, opt = getattr(state, attr), getattr(state, opt_attr)
        count = float(np.asarray(flat[f"{tree}/count"]))
        mu, nu = _subtree(flat, f"{tree}/mu"), _subtree(flat, f"{tree}/nu")
        check_structure(module, mu)
        check_structure(module, nu)
        for name, p in module.named_parameters():
            key = name.replace(".", "/")

            def like(a, p=p):
                return torch.from_numpy(np.array(a, np.float32)).reshape(
                    p.shape).to(p.device)

            opt.state[p] = {"step": torch.tensor(count),
                            "exp_avg": like(mu[key]),
                            "exp_avg_sq": like(nu[key])}
    with torch.no_grad():
        state.w_avg.copy_(torch.from_numpy(
            np.array(flat["w_avg"], np.float32)))
        state.pl_mean.copy_(torch.tensor(float(np.asarray(flat["pl_mean"]))))
    state.step = int(np.asarray(flat["step"]))
    return state


def save_train_state_npz(path: str, flat: Mapping[str, Any]) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})


def load_train_state_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# The JAX ``TrainState``'s fields in declared order
# (gansformer_tpu/train/state.py): leaf order of its checkpoints.
_JAX_FIELDS = ("step", "g_params", "d_params", "g_opt", "d_opt",
               "ema_params", "w_avg", "pl_mean")
# Leaves the JAX state holds as int32; every other leaf is fp32.
INT_KEYS = ("step", "g_opt/count", "d_opt/count")


def _tree_order(names) -> list:
    """Flax names in ``tree_flatten`` order: dict keys sorted at every
    level, i.e. the ``/``-split paths sorted as tuples."""
    return sorted(names, key=lambda k: tuple(k.split("/")))


def jax_leaf_keys(state) -> list:
    """The flat keys of the port's ``state`` (``train_state_keys``) in the
    JAX ``TrainState``'s leaf order."""
    names = {tree: _tree_order(param_shapes(getattr(state, attr)))
             for tree, attr in _PARAM_TREES}
    opt_names = {tree: names[{"g_opt": "g_params",
                              "d_opt": "d_params"}[tree]]
                 for tree, _, _ in _OPT_TREES}
    keys = []
    for field in _JAX_FIELDS:
        if field in names:
            keys += [f"{field}/{k}" for k in names[field]]
        elif field in opt_names:
            keys.append(f"{field}/count")
            for part in ("mu", "nu"):
                keys += [f"{field}/{part}/{k}" for k in opt_names[field]]
        else:
            keys.append(field)
    return keys


def adam_count(opt: torch.optim.Optimizer, module: nn.Module) -> int:
    """optax's one ``count`` from torch's per-parameter ``step``: equal
    for every parameter because every leaf steps (zero gradients where a
    loss does not reach), 0 before the first update.  Unequal steps
    raise."""
    steps = {int(opt.state[p]["step"]) if "step" in opt.state[p] else 0
             for p in module.parameters()}
    if len(steps) != 1:
        raise ValueError(f"Adam steps differ between parameters "
                         f"({sorted(steps)}): one optax count cannot hold "
                         f"them")
    return steps.pop()


def port_train_state_flat(state) -> Dict[str, Any]:
    """The port's ``TrainState`` as the flat dict of
    ``flatten_train_state``: torch tensors (detached, on the state's
    device) for the parameters, moments, ``w_avg`` and ``pl_mean``, ints
    for ``step`` and the counts.  Moments not yet created are zeros."""
    flat: Dict[str, Any] = {}
    for tree, attr in _PARAM_TREES:
        for name, p in getattr(state, attr).named_parameters():
            flat[f"{tree}/{name.replace('.', '/')}"] = p.detach()
    for tree, attr, opt_attr in _OPT_TREES:
        module, opt = getattr(state, attr), getattr(state, opt_attr)
        flat[f"{tree}/count"] = adam_count(opt, module)
        for name, p in module.named_parameters():
            key = name.replace(".", "/")
            st = opt.state[p]
            for part, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                flat[f"{tree}/{part}/{key}"] = (
                    st[slot].detach() if slot in st
                    else torch.zeros_like(p.detach()))
    flat["w_avg"] = state.w_avg.detach()
    flat["step"] = int(state.step)
    flat["pl_mean"] = state.pl_mean.detach()
    return flat
