"""Train with the PyTorch port: the JAX train CLI's surface
(``gansformer_tpu/cli/train.py``) over the port's tick loop.

    python -m gansformer_tpu_torch.cli.train --preset ffhq256-duplex \\
        --data-path /data/ffhq-tfrecords --run-dir runs/ffhq [--resume]

It picks a preset or ``--config`` (a JAX or port run's ``config.json``),
applies the flags on top, validates as the JAX CLI does, and trains into a
numbered run dir under ``--results-dir`` (or the pinned ``--run-dir``):
ticks of ``kimg_per_tick``, R1 every ``d_reg_interval`` iterations and
path length every ``g_reg_interval``, image grids and checkpoints at their
tick intervals, ``stats.jsonl``, ``log.txt``, TensorBoard events,
``events.jsonl``, ``telemetry.prom`` and the heartbeat.
``--device-time-ticks N`` traces one whole tick in every N with
``torch.profiler`` into the ``device/*`` gauges (0 turns it off);
``--profile-dir D`` writes a Chrome trace of tick 1 under D.
``--fused-cycle`` and ``--device-prefetch`` are JAX's, taken and said in
``log.txt``: no iteration of the port makes a host round trip, so they
select the same loop.  ``--resume`` continues the run's own
``config.json`` from its latest checkpoint (a JAX run's included: the
format is shared).  ``--steps N`` caps this invocation at N iterations,
which then end with their final tick and checkpoint.

The exits are the JAX CLI's: ``EXIT_PREEMPTED`` (75) after a graceful
SIGTERM checkpoint, ``EXIT_DATA_CORRUPT`` (65), ``EXIT_DATA_STALLED``
(74).  Flags of the JAX CLI that belong to later parts of the port are
refused with the part named.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional

from gansformer_tpu_torch.core.config import (PRESETS, ExperimentConfig,
                                              get_experiment_preset)

# JAX flags this port does not take, and why: the slice that brings each
# (ROADMAP queue A), or why it has no counterpart.
_A7 = "comes with data parallelism over several cards (A.7)"
_DEVICE = "has no counterpart: the device picks the path"
LATER_FLAGS = {
    "--attention-backend": _DEVICE, "--conv-backend": _DEVICE,
    "--selfcheck": "has no counterpart: graftlint reads jaxprs",
    **dict.fromkeys(("--mesh-data", "--mesh-model", "--sequence-parallel",
                     "--no-sequence-parallel", "--fsdp", "--no-fsdp",
                     "--coordinator", "--num-processes", "--process-id"),
                    _A7),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="GANsformer training, PyTorch port: the tick loop with "
                    "R1 every d_reg_interval iterations and path length "
                    "every g_reg_interval, checkpoints and --resume")
    p.add_argument("--preset", default="ffhq256-duplex",
                   choices=sorted(PRESETS))
    p.add_argument("--config", default=None,
                   help="a run's config.json (overrides --preset; flags "
                        "still apply on top)")
    p.add_argument("--results-dir", default="results")
    p.add_argument("--desc", default=None, help="run dir description suffix")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint of --resume-dir "
                        "(default: the latest run dir in --results-dir)")
    p.add_argument("--resume-dir", default=None)
    p.add_argument("--run-dir", default=None,
                   help="pin the run dir; with --resume the run continues "
                        "if it has checkpoints, else starts fresh in place")
    p.add_argument("--attention", choices=["none", "simplex", "duplex"])
    p.add_argument("--components", type=int, help="k latent components")
    p.add_argument("--resolution", type=int)
    p.add_argument("--dtype", choices=["float32", "bfloat16"])
    p.add_argument("--batch-size", type=int)
    p.add_argument("--total-kimg", type=float)
    p.add_argument("--g-lr", type=float)
    p.add_argument("--d-lr", type=float)
    p.add_argument("--r1-gamma", type=float)
    p.add_argument("--seed", type=int)
    p.add_argument("--pl-batch-shrink", type=int, default=None,
                   help="path-length probe batch divisor")
    p.add_argument("--r1-batch-shrink", type=int, default=None,
                   help="compute R1 on the first batch/N reals")
    p.add_argument("--attn-fused-kv", action="store_const", const=True,
                   dest="attn_fused_kv", default=None,
                   help="fuse each attention direction's K/V projections "
                        "into one matmul (exact math, different param "
                        "tree; default off)")
    p.add_argument("--no-attn-fused-kv", action="store_const", const=False,
                   dest="attn_fused_kv",
                   help="clear model.attn_fused_kv of a loaded config")
    p.add_argument("--async-checkpoint", action="store_const", const=True,
                   dest="async_checkpoint", default=None,
                   help="checkpoint and snapshot writes on a writer thread "
                        "(the default)")
    p.add_argument("--no-async-checkpoint", action="store_const",
                   const=False, dest="async_checkpoint",
                   help="write them on the loop thread")
    p.add_argument("--fused-cycle", action="store_const", const=True,
                   dest="fused_cycle", default=None,
                   help="JAX's one dispatch per lazy-reg cycle; taken and "
                        "said in log.txt: the port's steps already make no "
                        "host round trip inside a cycle")
    p.add_argument("--no-fused-cycle", action="store_const", const=False,
                   dest="fused_cycle",
                   help="clear train.fused_cycle of a loaded config")
    p.add_argument("--device-prefetch", action="store_const", const=True,
                   dest="device_prefetch", default=None,
                   help="JAX's device-resident prefetch (the default); "
                        "taken and said in log.txt: the port copies each "
                        "batch from pinned memory without a host sync")
    p.add_argument("--no-device-prefetch", action="store_const",
                   const=False, dest="device_prefetch",
                   help="clear data.device_prefetch of a loaded config")
    p.add_argument("--debug-nans", action="store_true",
                   help="anomaly detection + per-tick finite checks")
    p.add_argument("--profile-dir", default=None,
                   help="torch.profiler trace of tick 1 -> this dir (a "
                        "Chrome trace, *.pt.trace.json)")
    p.add_argument("--device-time-ticks", type=int, default=None,
                   help="device-time sampling cadence: every N ticks, "
                        "trace one whole tick with torch.profiler and fold "
                        "the device/* gauges (per-program device ms, the "
                        "wall-vs-device ratio) into telemetry.prom; 0 = off "
                        "(default: the config's, 8)")
    p.add_argument("--data-path", default=None)
    p.add_argument("--data-source",
                   choices=["synthetic", "npz", "tfrecord", "folder"])
    p.add_argument("--mirror-augment", action="store_true")
    p.add_argument("--max-corrupt-frac", type=float, default=None,
                   help="quarantined/total record fraction above which "
                        "the run fails as data-corrupt (default 0.01)")
    p.add_argument("--io-retries", type=int, default=None,
                   help="retries of a transient record read (default 3)")
    p.add_argument("--stall-after-s", type=float, default=None,
                   help="seconds without producer progress before the run "
                        "fails as data-stalled (0 = off; default 120)")
    p.add_argument("--steps", type=int, default=None,
                   help="stop after this many iterations (the port's cap; "
                        "the run ends with its final tick and checkpoint)")
    p.add_argument("--device", default=None,
                   help="'cpu' for the plain path on the host (default: "
                        "the card)")
    return p


def refuse_later_flags(argv: List[str]) -> None:
    for a in argv:
        flag = a.split("=", 1)[0]
        if flag in LATER_FLAGS:
            raise SystemExit(f"{flag}: not in the PyTorch port yet; it "
                             f"{LATER_FLAGS[flag]}")


def config_from_args(args) -> ExperimentConfig:
    """The preset or ``--config`` with the flags on top, validated."""
    if args.config:
        with open(args.config) as f:
            cfg = ExperimentConfig.from_json(f.read())
    else:
        cfg = get_experiment_preset(args.preset)

    def override(obj, **kv):
        kv = {k: v for k, v in kv.items() if v is not None}
        return dataclasses.replace(obj, **kv) if kv else obj

    model = override(cfg.model, attention=args.attention,
                     components=args.components, resolution=args.resolution,
                     dtype=args.dtype, attn_fused_kv=args.attn_fused_kv)
    train = override(cfg.train, batch_size=args.batch_size,
                     total_kimg=args.total_kimg, g_lr=args.g_lr,
                     d_lr=args.d_lr, r1_gamma=args.r1_gamma, seed=args.seed,
                     pl_batch_shrink=args.pl_batch_shrink,
                     r1_batch_shrink=args.r1_batch_shrink,
                     async_checkpoint=args.async_checkpoint,
                     fused_cycle=args.fused_cycle,
                     device_time_ticks=args.device_time_ticks,
                     profile_dir=args.profile_dir)
    if args.debug_nans:
        train = dataclasses.replace(train, debug_nans=True)
    data = override(cfg.data, path=args.data_path, source=args.data_source,
                    resolution=args.resolution,
                    max_corrupt_frac=args.max_corrupt_frac,
                    io_retries=args.io_retries,
                    stall_after_s=args.stall_after_s,
                    device_prefetch=args.device_prefetch)
    if args.mirror_augment:
        data = dataclasses.replace(data, mirror_augment=True)
    return dataclasses.replace(cfg, model=model, train=train,
                               data=data).validate()


def main(argv: Optional[List[str]] = None) -> int:
    import sys

    argv = sys.argv[1:] if argv is None else list(argv)
    refuse_later_flags(argv)
    args = build_parser().parse_args(argv)

    from gansformer_tpu_torch.core.device import resolve_device
    from gansformer_tpu_torch.data.errors import DataCorrupt, DataStalled
    from gansformer_tpu_torch.supervise.events import (
        EXIT_DATA_CORRUPT, EXIT_DATA_STALLED, EXIT_PREEMPTED,
        PreemptionExit)
    from gansformer_tpu_torch.train import loop
    from gansformer_tpu_torch.utils.logging import (RunLogger,
                                                    create_run_dir,
                                                    list_run_dirs)

    run_dir = None
    if args.run_dir:
        run_dir = args.run_dir
        os.makedirs(run_dir, exist_ok=True)
        if args.resume and not os.path.isdir(
                os.path.join(run_dir, "checkpoints")):
            args.resume = False
    elif args.resume:
        runs = list_run_dirs(args.results_dir)
        run_dir = args.resume_dir or (runs[-1] if runs else None)
        if run_dir is None or not os.path.isdir(
                os.path.join(run_dir, "checkpoints")):
            raise SystemExit(
                f"--resume: no run dir with checkpoints found (looked in "
                f"{args.resume_dir or args.results_dir}); pass --resume-dir "
                f"explicitly")
    if args.resume and not args.config:
        saved = os.path.join(run_dir, "config.json")
        if os.path.exists(saved):
            args.config = saved
    cfg = config_from_args(args)
    dev = resolve_device(args.device)
    if run_dir is None:
        desc = args.desc or (f"{cfg.name}-{cfg.model.attention}-"
                             f"k{cfg.model.components}")
        run_dir = create_run_dir(args.results_dir, desc)
    if not args.resume:
        with open(os.path.join(run_dir, "config.json"), "w") as f:
            f.write(cfg.to_json())
    logger = RunLogger(run_dir)
    logger.write(f"run dir: {run_dir}")
    try:
        loop.train(cfg, run_dir, resume=args.resume, logger=logger,
                   device=dev, steps=args.steps)
    except PreemptionExit as e:
        logger.write(f"preempted cleanly at step {e.step}; "
                     f"exit code {EXIT_PREEMPTED}")
        raise SystemExit(EXIT_PREEMPTED)
    except DataCorrupt as e:
        logger.write(f"data corrupt (budget exhausted): {e}; "
                     f"exit code {EXIT_DATA_CORRUPT}")
        raise SystemExit(EXIT_DATA_CORRUPT)
    except DataStalled as e:
        logger.write(f"data stalled: {e}; exit code {EXIT_DATA_STALLED}")
        raise SystemExit(EXIT_DATA_STALLED)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
