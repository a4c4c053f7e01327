"""Train with the PyTorch port: alternating first-order D and G steps on
the procedural dataset.

    python -m gansformer_tpu_torch.cli.train --preset ffhq256-duplex \\
        --steps 4 --batch-size 8 --seed 0 [--device cpu]

Prints one line per iteration: the losses and the milliseconds of the d
and g steps (host clock around synchronized work).  ``--config`` reads
the ``model`` and ``train`` sections of a JAX run's ``config.json``
instead of a preset (the way to ``d_attention``, which has no flag, as
in the JAX CLI); the flags apply on top.  Runs on the card unless
``--device cpu``.  The tick loop, checkpoints and ``--resume`` come
later.
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
                                              model_config_from_json,
                                              train_config_from_json)
from gansformer_tpu_torch.core.device import resolve_device
from gansformer_tpu_torch.data.dataset import SyntheticDataset
from gansformer_tpu_torch.train.state import create_train_state
from gansformer_tpu_torch.train.steps import d_step, g_step


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GANsformer training, PyTorch "
                                            "port (first-order steps)")
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
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mirror-augment", action="store_true")
    p.add_argument("--device", default=None,
                   help="'cpu' for the plain path on the host (default: "
                        "the card)")
    return p


def configs(args):
    if args.config:
        with open(args.config) as f:
            text = f.read()
        model, train = model_config_from_json(text), \
            train_config_from_json(text)
    else:
        model, train = get_preset(args.preset), \
            get_train_preset(args.preset)
    over = {k: getattr(args, k) for k in ("attention", "resolution", "dtype")
            if getattr(args, k) is not None}
    model = dataclasses.replace(model, **over)
    if args.batch_size is not None:
        train = dataclasses.replace(train, batch_size=args.batch_size)
    return model, train


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    model, train = configs(args)
    if model.label_dim:
        raise SystemExit("conditional training needs a labelled dataset, "
                         "which the port does not read yet")
    dev = resolve_device(args.device)
    state = create_train_state(model, train, args.seed, dev)
    data = SyntheticDataset(model.resolution, model.img_channels).batches(
        train.batch_size, seed=args.seed)
    print(json.dumps({"model": dataclasses.asdict(model),
                      "train": dataclasses.asdict(train),
                      "device": str(dev)}, default=str), flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for it in range(args.steps):
        reals = torch.from_numpy(next(data))
        sync()
        t0 = time.perf_counter()
        d_aux = d_step(state, reals, it, mirror_augment=args.mirror_augment)
        sync()
        t1 = time.perf_counter()
        g_aux = g_step(state, it, train.batch_size)
        sync()
        t2 = time.perf_counter()
        losses = {k: float(v) for k, v in {**d_aux, **g_aux}.items()}
        print(f"step {it}: kimg {state.step / 1000:.3f} "
              f"Loss/D {losses['Loss/D']:.4f} Loss/G {losses['Loss/G']:.4f} "
              f"real {losses['Loss/scores/real']:.4f} fake "
              f"{losses['Loss/scores/fake']:.4f} d_ms "
              f"{(t1 - t0) * 1e3:.2f} g_ms {(t2 - t1) * 1e3:.2f}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
