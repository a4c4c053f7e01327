"""Train with the PyTorch port: alternating D and G steps on the
procedural dataset, with D's lazy R1 penalty (``d_step_r1``) every
``d_reg_interval`` iterations and G's lazy path-length penalty
(``g_step_pl``) every ``g_reg_interval`` iterations, each from iteration
0, as the JAX loop runs them.

    python -m gansformer_tpu_torch.cli.train --preset ffhq256-duplex \\
        --steps 4 --batch-size 8 --seed 0 [--device cpu]

Prints one line per iteration: the losses (``Loss/D/r1`` on the R1
iterations, ``Loss/G/pl`` on the path-length ones) and the milliseconds
of the d and g steps (host clock around synchronized work).  ``--config`` reads
the ``model`` and ``train`` sections and ``data.mirror_augment`` of a
JAX run's ``config.json`` instead of a preset (the way to
``d_attention``, which has no flag, as in the JAX CLI); the flags apply
on top, and ``--seed`` replaces ``train.seed`` only when given.  The
result is validated as the JAX CLI validates it (a batch that
``mbstd_group_size`` does not divide is refused).  Runs on the card
unless ``--device cpu``.  The tick loop, checkpoints and ``--resume``
come later.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import List, Optional

import torch

from gansformer_tpu_torch.core.config import (PRESETS,
                                              get_preset, get_train_preset,
                                              mirror_augment_from_json,
                                              model_config_from_json,
                                              train_config_from_json,
                                              validate)
from gansformer_tpu_torch.core.device import resolve_device
from gansformer_tpu_torch.data.dataset import SyntheticDataset
from gansformer_tpu_torch.train.state import create_train_state
from gansformer_tpu_torch.train.steps import (d_step, d_step_r1, g_step,
                                              g_step_pl)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GANsformer training, PyTorch "
                                            "port (R1 every d_reg_interval "
                                            "iterations, path length every "
                                            "g_reg_interval)")
    p.add_argument("--preset", default="ffhq256-duplex",
                   choices=sorted(PRESETS))
    p.add_argument("--config", default=None,
                   help="a JAX run's config.json (overrides --preset)")
    p.add_argument("--attention", choices=["none", "simplex", "duplex"])
    p.add_argument("--resolution", type=int)
    p.add_argument("--dtype", choices=["float32", "bfloat16"])
    p.add_argument("--batch-size", type=int)
    p.add_argument("--steps", type=int, default=4,
                   help="alternating d/g iterations")
    p.add_argument("--seed", type=int,
                   help="overrides train.seed (default: the config's)")
    p.add_argument("--mirror-augment", action="store_true")
    p.add_argument("--device", default=None,
                   help="'cpu' for the plain path on the host (default: "
                        "the card)")
    return p


def configs(args):
    """(model, train, mirror_augment) from the preset or ``--config`` with
    the flags on top, validated."""
    mirror = args.mirror_augment
    if args.config:
        with open(args.config) as f:
            text = f.read()
        model, train = model_config_from_json(text), \
            train_config_from_json(text)
        mirror = mirror or mirror_augment_from_json(text)
    else:
        model, train = get_preset(args.preset), \
            get_train_preset(args.preset)
    over = {k: getattr(args, k) for k in ("attention", "resolution", "dtype")
            if getattr(args, k) is not None}
    model = dataclasses.replace(model, **over)
    tover = {k: v for k, v in (("batch_size", args.batch_size),
                               ("seed", args.seed)) if v is not None}
    train = dataclasses.replace(train, **tover)
    validate(model, train)
    return model, train, mirror


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    model, train, mirror = configs(args)
    if model.label_dim:
        raise SystemExit("conditional training needs a labelled dataset, "
                         "which the port does not read yet")
    dev = resolve_device(args.device)
    state = create_train_state(model, train, train.seed, dev)
    data = SyntheticDataset(model.resolution, model.img_channels).batches(
        train.batch_size, seed=train.seed)
    print(json.dumps({"model": dataclasses.asdict(model),
                      "train": dataclasses.asdict(train),
                      "mirror_augment": mirror, "device": str(dev)},
                     default=str), flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for it in range(args.steps):
        reals = torch.from_numpy(next(data))
        sync()
        t0 = time.perf_counter()
        step = d_step_r1 if it % train.d_reg_interval == 0 else d_step
        d_aux = step(state, reals, it, mirror_augment=mirror)
        sync()
        t1 = time.perf_counter()
        gstep = g_step_pl if it % train.g_reg_interval == 0 else g_step
        g_aux = gstep(state, it, train.batch_size)
        sync()
        t2 = time.perf_counter()
        losses = {k: float(v) for k, v in {**d_aux, **g_aux}.items()}
        r1 = (f" Loss/D/r1 {losses['Loss/D/r1']:.4f}"
              if "Loss/D/r1" in losses else "")
        pl = (f" Loss/G/pl {losses['Loss/G/pl']:.4f}"
              if "Loss/G/pl" in losses else "")
        print(f"step {it}: kimg {state.step / 1000:.3f} "
              f"Loss/D {losses['Loss/D']:.4f}{r1} Loss/G "
              f"{losses['Loss/G']:.4f}{pl} real "
              f"{losses['Loss/scores/real']:.4f} fake "
              f"{losses['Loss/scores/fake']:.4f} d_ms "
              f"{(t1 - t0) * 1e3:.2f} g_ms {(t2 - t1) * 1e3:.2f}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
