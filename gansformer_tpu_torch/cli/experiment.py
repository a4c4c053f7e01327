"""The replication-study harness with the PyTorch port (the JAX
``gansformer_tpu/cli/experiment.py`` over the port's ``train``): one
training arm per architecture under an otherwise identical config (the
"Investigating GANsformer" study, arXiv 2303.08577: the StyleGAN2
baseline against GANsformer-Simplex and -Duplex), then a comparison
report.

    python -m gansformer_tpu_torch.cli.experiment --preset clevr64-simplex \\
        --archs none,simplex,duplex --total-kimg 100 --out results/repro

Each arm is an ordinary run dir ``<out>/<arch>/`` (stats.jsonl,
checkpoints, grids), so ``generate``, ``evaluate`` and ``--resume`` work
on it.  ``--metrics`` runs ``metrics/sweep.py`` on each arm after its
training.  The summary goes to ``<out>/experiment.json`` and
``<out>/report.md`` in JAX's formats.  Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import List, Optional

ARCH_CHOICES = ("none", "simplex", "duplex")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="GANsformer replication matrix (PyTorch port)")
    p.add_argument("--preset", default="clevr64-simplex",
                   help="base config preset; arms override `attention` only")
    p.add_argument("--archs", default="none,simplex,duplex",
                   help="comma list from {none,simplex,duplex} "
                        "(none = StyleGAN2 baseline)")
    p.add_argument("--out", required=True, help="experiment root dir")
    p.add_argument("--total-kimg", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--resolution", type=int, default=None)
    p.add_argument("--components", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--data-path", default=None)
    p.add_argument("--data-source",
                   choices=["synthetic", "npz", "tfrecord", "folder"])
    p.add_argument("--metrics", default=None,
                   help="optional metric names to run per arm after "
                        "training (e.g. fid10k)")
    p.add_argument("--config", default=None,
                   help="JSON base config instead of --preset")
    p.add_argument("--device", default=None,
                   help="'cpu' runs the plain path on the host; default: "
                        "the card")
    return p


def _arm_config(base, arch: str):
    """One matrix arm: the base config with only the architecture swapped
    (and the global style mode for the baseline: attention-driven styling
    means nothing without attention)."""
    model = dataclasses.replace(
        base.model, attention=arch,
        style_mode=("global" if arch == "none" else base.model.style_mode))
    return dataclasses.replace(base, name=f"{base.name}-{arch}", model=model)


def _last_stats(run_dir: str) -> dict:
    last = {}
    path = os.path.join(run_dir, "stats.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    last = json.loads(line)
    return last


def run_experiment(base, archs: List[str], out: str,
                   metrics: Optional[str] = None, device=None) -> dict:
    from gansformer_tpu_torch.train.loop import param_count, train
    from gansformer_tpu_torch.utils.logging import RunLogger

    # train() writes each arm's resolved config.json itself
    os.makedirs(out, exist_ok=True)
    results = {}
    for arch in archs:
        cfg = _arm_config(base, arch)
        run_dir = os.path.join(out, arch)
        os.makedirs(run_dir, exist_ok=True)
        logger = RunLogger(run_dir)
        logger.write(f"=== arm {arch}: {cfg.name} ===")
        state = train(cfg, run_dir, logger=logger, device=device)
        stats = _last_stats(run_dir)
        arm = {
            "run_dir": run_dir,
            "g_params": param_count(state.generator),
            "d_params": param_count(state.discriminator),
            "kimg": stats.get("Progress/kimg"),
            "loss_g": stats.get("Loss/G"),
            "loss_d": stats.get("Loss/D"),
            "img_per_sec": stats.get("timing/img_per_sec"),
        }
        if metrics:
            from gansformer_tpu_torch.metrics.sweep import run_metric_sweep

            try:
                arm["metrics"] = run_metric_sweep(cfg, state, run_dir,
                                                  metrics)
            except Exception as e:  # an arm's metrics must not end the rest
                arm["metrics_error"] = f"{type(e).__name__}: {e}"
        results[arch] = arm
        logger.close()

    summary = {"base_preset": base.name, "archs": archs, "arms": results}
    with open(os.path.join(out, "experiment.json"), "w") as f:
        json.dump(summary, f, indent=2)
    _write_report(out, summary)
    return summary


def _write_report(out: str, summary: dict) -> None:
    lines = [
        "# Replication-matrix report",
        "",
        f"Base preset: `{summary['base_preset']}` — one arm per architecture "
        "(the arXiv 2303.08577 study design: StyleGAN2 baseline vs "
        "GANsformer simplex vs duplex under an identical budget).",
        "",
        "| arch | G params | D params | kimg | Loss/G | Loss/D | img/s |",
        "|---|---|---|---|---|---|---|",
    ]

    def fmt(v, spec=".3f"):
        return format(v, spec) if isinstance(v, (int, float)) else "—"

    for arch in summary["archs"]:
        a = summary["arms"][arch]
        lines.append(
            f"| {arch} | {a['g_params']:,} | {a['d_params']:,} "
            f"| {fmt(a.get('kimg'), '.1f')} | {fmt(a.get('loss_g'))} "
            f"| {fmt(a.get('loss_d'))} "
            f"| {fmt(a.get('img_per_sec'), '.1f')} |")
        if a.get("metrics"):
            for name, value in a["metrics"].items():
                lines.append(f"|   ↳ {name} | {value:.4f} | | | | | |")
    lines.append("")
    with open(os.path.join(out, "report.md"), "w") as f:
        f.write("\n".join(lines))


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    archs = [a.strip() for a in args.archs.split(",") if a.strip()]
    for a in archs:
        if a not in ARCH_CHOICES:
            raise SystemExit(f"unknown arch {a!r}; choose from {ARCH_CHOICES}")

    from gansformer_tpu_torch.core.config import (ExperimentConfig,
                                                  get_experiment_preset)

    if args.config:
        with open(args.config) as f:
            base = ExperimentConfig.from_json(f.read())
    else:
        base = get_experiment_preset(args.preset)

    def override(obj, **kv):
        kv = {k: v for k, v in kv.items() if v is not None}
        return dataclasses.replace(obj, **kv) if kv else obj

    base = dataclasses.replace(
        base,
        model=override(base.model, resolution=args.resolution,
                       components=args.components),
        train=override(base.train, total_kimg=args.total_kimg,
                       batch_size=args.batch_size, seed=args.seed),
        data=override(base.data, path=args.data_path,
                      source=args.data_source,
                      resolution=args.resolution),
    )
    return run_experiment(base, archs, args.out, metrics=args.metrics,
                          device=args.device)


if __name__ == "__main__":
    main()
