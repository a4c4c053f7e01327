"""Serve images with the PyTorch port: the JAX serve CLI's surface
(``gansformer_tpu/cli/serve.py``) over the port's serving core.

    python -m gansformer_tpu_torch.cli.serve --run-dir R \\
        [--serve-precision f32|bf16|int8w] [--buckets 1,4,8] [--images 8]
    python -m gansformer_tpu_torch.cli.serve --init random \\
        --preset ffhq256-duplex --images 16 --serve-precision bf16
    python -m gansformer_tpu_torch.cli.serve --init random \\
        --preset ffhq256-duplex --images 16 --replicas 2 --autoscale
    python -m gansformer_tpu_torch.cli.serve --warm-only [--manifest-dir D]

Cold start: the G-only restore of ``--run-dir`` (a run dir of either
package, or a ``pack_run`` archive; ``restore_ms``), or a random init of
``--preset`` with ``--init random``; then the warm start of the kernel
library from ``--manifest-dir`` (default ``gansformer_tpu_torch/_build/``;
``--no-warm-start`` builds into a temporary directory, records nothing
and removes it at exit).  ``--warm-only`` stops there: the deploy-time
pre-build.

The default mode serves ``--images`` demo requests, seeds drawn from the
JAX CLI's Zipfian mix (the same seeds for the same ``--seed``), through
one ``serve.GenerationService`` (bounded admission ``--queue-depth``,
raised to hold the demo's own burst; deadlines ``--deadline-s``; the
SIGTERM drain and ``close`` within ``--grace-s``): the first request
alone (``first_image_ms`` covers the library's load or build and that
request), then the rest at once, each ticket waited on for up to 600 s.
With ``--replicas`` above 1 or ``--autoscale`` they go through a
``serve.ReplicaSet`` instead: a replica per visible card (the CPU with
``--device cpu``), least-loaded routing, and with ``--autoscale`` the
controller between 1 (or ``--replicas``) and ``--max-replicas`` (default:
every card); a ``--warm-only`` fleet drains before it exits.  It writes
``served_grid.png`` and ``telemetry.prom`` into ``--out`` and prints one
JSON line with the JAX CLI's keys: the service's (or fleet's)
``health``, ``replicas`` (the fleet's active members) and ``autoscale``,
the ``serve/*`` counters and ``e2e_ms`` (count, mean, min, max of
``serve/e2e_ms``).

``--healthcheck PROM`` grades a service's ``telemetry.prom`` (a file, or
a directory holding one) without touching the card: it prints the
verdict as JSON and exits 0 unless the service is unhealthy, its
dispatcher is dead with work queued, or (``--health-max-age``) the file
is older than that many seconds.

Runs on the card unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import tempfile
import time
from typing import List, Optional

import numpy as np

# The JAX package's serving health vocabulary and fleet readers
# (``gansformer_tpu/analysis/telemetry_schema.py``), kept here so the
# probe imports neither JAX, the JAX package nor torch (``serve.service``
# holds the same names as ``HEALTH_NAMES``).  The doctor of
# ``cli/telemetry.py`` and the load driver read them from here.
SERVE_HEALTH_NAMES = {0: "ready", 1: "degraded", 2: "unhealthy",
                      3: "closed"}
_REPLICA_METRIC = re.compile(r"^serve_replica(\d+)_")


def serve_dead_with_work(alive, queue_depth) -> bool:
    """A dispatcher that is down while requests sit queued: those tickets
    hang, the one liveness verdict that outranks a "degraded" state."""
    return alive == 0.0 and (queue_depth or 0.0) > 0


def serve_replica_ordinals(vals: dict) -> List[int]:
    """The replica ordinals of a parsed prom (its ``serve_replica<i>_*``
    families); empty for a single service."""
    return sorted({int(m.group(1)) for name in vals
                   if (m := _REPLICA_METRIC.match(name))})


def serve_fleet_alive(vals: dict) -> bool:
    """Any dispatcher alive (a single service: its own)."""
    ords = serve_replica_ordinals(vals)
    if not ords:
        return vals.get("serve_dispatcher_alive", 0.0) > 0
    return any(vals.get(f"serve_replica{i}_dispatcher_alive", 0.0) > 0
               for i in ords)


def serve_fleet_dead_with_work(vals: dict) -> bool:
    """Tickets hang: some queue holds work while every dispatcher is
    dead."""
    ords = serve_replica_ordinals(vals)
    if not ords:
        return serve_dead_with_work(vals.get("serve_dispatcher_alive", 0.0),
                                    vals.get("serve_queue_depth_now", 0.0))
    any_queued = any(
        vals.get(f"serve_replica{i}_queue_depth_now", 0.0) > 0
        for i in ords)
    return any_queued and not serve_fleet_alive(vals)


def healthcheck(path: str, max_age_s=None) -> int:
    """Grade an exported ``telemetry.prom``: 0 for ready, degraded or
    closed with no dispatcher dead with work; 1 for unhealthy, missing,
    not a serving prom, or stale (older than ``max_age_s``).  Prints the
    verdict as one JSON line; touches no device."""
    from gansformer_tpu_torch.obs.registry import parse_prom_values

    if os.path.isdir(path):
        path = os.path.join(path, "telemetry.prom")
    if not os.path.exists(path):
        print(json.dumps({"state": "unknown", "ok": False,
                          "error": f"{path}: missing"}))
        return 1
    vals = parse_prom_values(path)
    code = vals.get("serve_health_state")
    if code is None:
        print(json.dumps({"state": "unknown", "ok": False, "prom": path,
                          "error": "no serve_health_state gauge — not a "
                                   "serving telemetry.prom"}))
        return 1
    snapshot_age = time.time() - os.path.getmtime(path)
    ords = serve_replica_ordinals(vals)
    dead_with_work = serve_fleet_dead_with_work(vals)
    state = SERVE_HEALTH_NAMES.get(int(code), "unknown")
    if max_age_s is not None and snapshot_age > max_age_s:
        state = "stale"
    out = {"state": state, "prom": path,
           "snapshot_age_s": round(snapshot_age, 1), "ok":
           state in ("ready", "degraded", "closed")
           and not dead_with_work,
           "dispatcher_alive": 1.0 if serve_fleet_alive(vals) else 0.0,
           "queue_depth": vals.get("serve_queue_depth_now", 0.0),
           "queue_bound": vals.get("serve_queue_bound"),
           "dispatcher_restarts":
               vals.get("serve_dispatcher_restarts_total"),
           "shed_total": vals.get("serve_shed_total"),
           "expired_total": vals.get("serve_expired_total"),
           "cancelled_total": vals.get("serve_cancelled_total")}
    if ords:
        out["replicas"] = vals.get("serve_replicas")
        out["replicas_alive"] = sum(
            1 for i in ords
            if vals.get(f"serve_replica{i}_dispatcher_alive", 0.0) > 0)
        out["scale_out_total"] = vals.get("serve_scale_out_total")
        out["scale_in_total"] = vals.get("serve_scale_in_total")
    print(json.dumps(out, sort_keys=True))
    return 0 if out["ok"] else 1


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
    p.add_argument("--replicas", type=int, default=1,
                   help="serving replicas, one per visible card (>1 "
                        "routes through serve.ReplicaSet)")
    p.add_argument("--max-replicas", type=int, default=None,
                   help="autoscaler ceiling (default: every visible "
                        "card)")
    p.add_argument("--autoscale", action="store_true",
                   help="scale replicas out on sustained queue "
                        "saturation, in on batch-fill collapse")
    p.add_argument("--queue-depth", type=int, default=256,
                   help="admission queue bound (over-depth submits shed "
                        "with a typed Overloaded)")
    p.add_argument("--deadline-s", type=float, default=None,
                   help="per-request deadline; expired requests drop "
                        "before dispatch")
    p.add_argument("--grace-s", type=float, default=30.0,
                   help="drain grace window for close() and SIGTERM")
    p.add_argument("--healthcheck", default=None, metavar="PROM",
                   help="grade a service telemetry.prom (file or dir) "
                        "and exit; no device touched")
    p.add_argument("--health-max-age", type=float, default=None,
                   help="with --healthcheck: fail when the prom is older "
                        "than this many seconds")
    p.add_argument("--device", default=None,
                   help="'cpu' for the plain path on the host (default: "
                        "the card)")
    return p


def _serve(args, svc, summary, out_dir, t_first0) -> None:
    """The demo requests through ``svc`` (a ``GenerationService`` or a
    ``ReplicaSet``): the first alone, then the rest; writes the grid and
    telemetry.prom, fills ``summary``."""
    from gansformer_tpu_torch.obs import registry as telemetry
    from gansformer_tpu_torch.utils.image import save_image_grid

    os.makedirs(out_dir, exist_ok=True)
    seeds = [int(s) for s in demo_seeds(args.seed, args.images)]
    svc.install_signal_drain(grace_s=args.grace_s)
    try:
        first = svc.submit(seeds[0], psi=args.psi)
        first.result(timeout=600)
        summary["first_image_ms"] = round(
            (time.perf_counter() - t_first0) * 1000.0, 1)
        tickets = [svc.submit(s, psi=args.psi) for s in seeds[1:]]
        imgs = [first.result()] + [t.result(timeout=600) for t in tickets]
        summary["health"] = svc.health()
    finally:
        svc.close(timeout=args.grace_s)
    save_image_grid(np.stack(imgs), os.path.join(out_dir,
                                                 "served_grid.png"))
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
    args = build_parser().parse_args(argv)
    if args.healthcheck:
        return healthcheck(args.healthcheck, max_age_s=args.health_max_age)

    import torch

    from gansformer_tpu_torch.core.config import get_preset
    from gansformer_tpu_torch.core.device import resolve_device
    from gansformer_tpu_torch.serve import (GenerationService, ReplicaSet,
                                            ServePrograms,
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
    # fleet mode: more than one replica, or the autoscaler, routes
    # through a ReplicaSet; one replica keeps the single service
    fleet = args.replicas > 1 or args.autoscale
    # the demo submits its whole list at once: the bound sits above it
    service_kwargs = dict(
        wcache_capacity=args.wcache,
        max_queue_depth=max(args.queue_depth, args.images + 1),
        default_deadline_s=args.deadline_s)
    programs_kwargs = dict(buckets=buckets,
                           manifest_dir=manifest_dir or build_dir,
                           warm_start=not args.no_warm_start,
                           serve_precision=args.serve_precision)
    rs = None
    try:
        if fleet:
            try:
                rs = ReplicaSet(bundle, replicas=args.replicas,
                                max_replicas=args.max_replicas,
                                autoscale=args.autoscale,
                                service_kwargs=service_kwargs,
                                **programs_kwargs)
            except ValueError as e:
                raise SystemExit(str(e))
            t_first0 = time.perf_counter()
            warm = rs.warm_start()
        else:
            programs = ServePrograms(bundle, **programs_kwargs)
            t_first0 = time.perf_counter()
            warm = programs.warm_start()
        summary = {
            "buckets": list(buckets),
            "serve_precision": args.serve_precision,
            "replicas": rs.n_active if fleet else 1,
            "autoscale": bool(args.autoscale),
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
                    f"requests through serve.GenerationService.submit("
                    f"label=...)")
            svc = rs if fleet else GenerationService(programs,
                                                     **service_kwargs)
            _serve(args, svc, summary, out_dir, t_first0)
    finally:
        if rs is not None:
            # a --warm-only fleet (or one that failed) drains here
            rs.close(timeout=args.grace_s)
        if build_dir is not None:
            shutil.rmtree(build_dir, ignore_errors=True)
    print(json.dumps(summary, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
