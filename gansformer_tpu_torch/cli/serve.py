"""Serve images with the PyTorch port: the JAX serve CLI's surface
(``gansformer_tpu/cli/serve.py``) over the port's serving core.

    python -m gansformer_tpu_torch.cli.serve --run-dir R \\
        [--serve-precision f32|bf16|int8w] [--buckets 1,4,8] [--images 8]
    python -m gansformer_tpu_torch.cli.serve --init random \\
        --preset ffhq256-duplex --images 16 --serve-precision bf16
    python -m gansformer_tpu_torch.cli.serve --warm-only [--manifest-dir D]

Cold start: the G-only restore of ``--run-dir`` (a run dir of either
package, or a ``pack_run`` archive; ``restore_ms``), or a random init of
``--preset`` with ``--init random``; then the warm start of the kernel
library from ``--manifest-dir`` (default ``gansformer_tpu_torch/_build/``;
``--no-warm-start`` builds into a temporary directory, records nothing
and removes it at exit).  ``--warm-only`` stops there: the deploy-time
pre-build.

The default mode serves ``--images`` demo requests, seeds drawn from the
JAX CLI's Zipfian mix (the same seeds for the same ``--seed``),
synchronously: the first request alone (``first_image_ms`` covers the
library's load or build and that request), then the rest in chunks of
the largest bucket, each through ``serve.map_rows`` (the w cache,
``--wcache`` rows) and one ``synthesize`` (``e2e_ms`` per chunk).  It
writes ``served_grid.png`` and ``telemetry.prom`` into ``--out`` and
prints one JSON summary line with the JAX CLI's keys (the service's
``health``, ``replicas`` and ``autoscale`` belong to the service, ROADMAP
A.4b, whose flags are refused here with words).

Runs on the card unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np

# JAX serve flags of the service, which this CLI does not take yet.
_A4B = "comes with the serving service (ROADMAP A.4b)"
LATER_FLAGS = dict.fromkeys(
    ("--replicas", "--max-replicas", "--autoscale", "--queue-depth",
     "--deadline-s", "--grace-s", "--healthcheck", "--health-max-age"),
    _A4B)


def demo_seeds(seed: int, n: int) -> np.ndarray:
    """The JAX CLI's Zipfian demo mix: a few hot seeds and a long tail,
    so the demo exercises the w cache as real traffic would."""
    rng = np.random.RandomState(seed)
    universe = np.arange(1, 64)
    pz = 1.0 / universe ** 1.1
    return rng.choice(universe, size=n, p=pz / pz.sum())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Serve images (PyTorch port): G-only restore, kernel "
                    "library warm start, bucketed synthesis")
    p.add_argument("--run-dir", default=None,
                   help="run dir or packed run archive with checkpoints + "
                        "config.json (EMA generator and w_avg only)")
    p.add_argument("--preset", default=None,
                   help="with --init random: serve a randomly initialized "
                        "G of this preset")
    p.add_argument("--init", default="checkpoint",
                   choices=("checkpoint", "random"))
    p.add_argument("--buckets", default="1,4,8",
                   help="comma list of padded batch buckets")
    p.add_argument("--psi", type=float, default=0.7)
    p.add_argument("--images", type=int, default=8,
                   help="demo requests to serve (0 = none)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None,
                   help="output dir (default: run dir /served or ./served)")
    p.add_argument("--manifest-dir", default=None,
                   help="where the kernel library and its manifest live "
                        "(default: gansformer_tpu_torch/_build/)")
    p.add_argument("--no-warm-start", action="store_true",
                   help="build the library into a temporary directory, "
                        "record nothing, remove it at exit")
    p.add_argument("--warm-only", action="store_true",
                   help="load or build the library and exit")
    p.add_argument("--serve-precision", default="f32",
                   choices=("f32", "bf16", "int8w"),
                   help="synthesis precision: the model as configured, "
                        "bf16 activations, or int8 weight-only kernels "
                        "(mapping and w cache always f32)")
    p.add_argument("--wcache", type=int, default=4096,
                   help="w-cache capacity (rows)")
    p.add_argument("--device", default=None,
                   help="'cpu' for the plain path on the host (default: "
                        "the card)")
    return p


def _serve(args, programs, summary, out_dir, t_first0) -> None:
    """The demo requests: the first alone, then chunks of the largest
    bucket; writes the grid and telemetry.prom, fills ``summary``."""
    import torch

    from gansformer_tpu_torch.obs import registry as telemetry
    from gansformer_tpu_torch.serve import WCache, bucket_for, map_rows
    from gansformer_tpu_torch.utils.image import save_image_grid

    os.makedirs(out_dir, exist_ok=True)
    seeds = [int(s) for s in demo_seeds(args.seed, args.images)]
    cache = WCache(args.wcache)
    top = programs.buckets[-1]
    chunks = [seeds[:1]] + [seeds[i:i + top]
                            for i in range(1, len(seeds), top)]
    imgs = []
    for i, chunk in enumerate(chunks):
        t0 = time.perf_counter()
        n = len(chunk)
        bucket = bucket_for(n, programs.buckets)
        ws = map_rows(programs, cache, chunk)
        if bucket > n:
            ws = torch.cat([ws, ws[-1:].expand(bucket - n, *ws.shape[1:])])
        tags = chunk + [chunk[-1]] * (bucket - n)
        out = programs.synthesize(ws, [args.psi] * bucket, tags=tags)
        imgs.append(out[:n].float().cpu().numpy())
        done = time.perf_counter()
        telemetry.histogram("serve/e2e_ms").observe((done - t0) * 1000.0)
        if i == 0:
            summary["first_image_ms"] = round((done - t_first0) * 1000.0, 1)
    save_image_grid(np.concatenate(imgs),
                    os.path.join(out_dir, "served_grid.png"))
    snap = telemetry.get_registry().snapshot()
    summary["counters"] = {k.replace("serve/", ""): v for k, v in
                           snap["counters"].items() if k.startswith("serve/")}
    lat = snap["histograms"].get("serve/e2e_ms", {})
    summary["e2e_ms"] = {k: lat.get(k) for k in ("count", "mean", "min",
                                                 "max")}
    telemetry.get_registry().write_prom(os.path.join(out_dir,
                                                     "telemetry.prom"))
    summary["out"] = out_dir


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    for a in argv:
        flag = a.split("=", 1)[0]
        if flag in LATER_FLAGS:
            raise SystemExit(f"{flag}: not in the PyTorch port yet; it "
                             f"{LATER_FLAGS[flag]}")
    args = build_parser().parse_args(argv)

    import torch

    from gansformer_tpu_torch.core.config import get_preset
    from gansformer_tpu_torch.core.device import resolve_device
    from gansformer_tpu_torch.serve import (ServePrograms,
                                            default_manifest_dir,
                                            init_generator, load_generator,
                                            sorted_buckets)
    from gansformer_tpu_torch.utils.runarchive import resolve_run_dir

    dev = resolve_device(args.device)
    buckets = sorted_buckets(int(b) for b in args.buckets.split(","))
    t_load0 = time.perf_counter()
    if args.init == "random":
        if not args.preset:
            raise SystemExit("--init random needs --preset")
        bundle = init_generator(get_preset(args.preset), seed=args.seed,
                                device=dev)
        out_dir = args.out or "served"
    else:
        if not args.run_dir:
            raise SystemExit("--init checkpoint needs --run-dir")
        run_dir = resolve_run_dir(args.run_dir)
        bundle = load_generator(run_dir, device=dev)
        out_dir = args.out or os.path.join(run_dir, "served")
    load_ms = (time.perf_counter() - t_load0) * 1000.0

    build_dir = (tempfile.mkdtemp(prefix="gansformer_serve_build_")
                 if args.no_warm_start else None)
    manifest_dir = None if args.no_warm_start else (
        args.manifest_dir or default_manifest_dir())
    try:
        programs = ServePrograms(bundle, buckets=buckets,
                                 manifest_dir=manifest_dir or build_dir,
                                 warm_start=not args.no_warm_start,
                                 serve_precision=args.serve_precision)
        t_first0 = time.perf_counter()
        warm = programs.warm_start()
        summary = {
            "buckets": list(buckets),
            "serve_precision": args.serve_precision,
            "restore_ms": round(load_ms, 1),
            "warm_start": {"loaded": warm["loaded"],
                           "compiled": warm["compiled"],
                           "seconds": round(warm["seconds"], 3)},
            "manifest_dir": manifest_dir,
            "device": ({"platform": "gpu",
                        "kind": torch.cuda.get_device_name(dev),
                        "count": 1} if dev.type == "cuda" else
                       {"platform": "cpu", "kind": "cpu", "count": 1}),
        }
        if not args.warm_only and args.images > 0:
            if bundle.cfg.label_dim:
                raise SystemExit(
                    f"model has label_dim={bundle.cfg.label_dim}: the demo "
                    f"traffic can't supply labels — use --warm-only to "
                    f"pre-bake the manifest, and drive conditional "
                    f"requests through serve.map_rows(programs, cache, "
                    f"seeds, labels=...)")
            _serve(args, programs, summary, out_dir, t_first0)
    finally:
        if build_dir is not None:
            shutil.rmtree(build_dir, ignore_errors=True)
    print(json.dumps(summary, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
