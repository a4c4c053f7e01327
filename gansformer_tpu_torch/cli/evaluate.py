"""Evaluate a run's snapshot with the PyTorch port: the JAX evaluate CLI's
surface (``gansformer_tpu/cli/evaluate.py``) over ``metrics/sweep.py``.

    python -m gansformer_tpu_torch.cli.evaluate --run-dir runs/ffhq \\
        --metrics fid50k,is50k [--inception-npz inception.npz]

``--run-dir`` is a run dir of either package or a ``pack_run`` archive
(``.tar.gz``).  The latest checkpoint is restored into a train state
(``train/checkpoint.py restore``) and its EMA generator sampled; the
extractor is the npz's (``--inception-npz``, then
``$GANSFORMER_TPU_INCEPTION_NPZ``, then ``.weights/inception-imagenet.npz``)
or the uncalibrated network, whose metric names end in ``_uncal``.  Each
result is appended to ``<run_dir>/metric-<name>.txt``, the ``calibrated``
flag written to ``flag-calibrated.txt``, and one JSON line printed.
``--psi-sweep 0.5,0.7,1.0`` runs the metrics once per truncation psi and
appends the table to ``metric-psi-sweep.txt``.  Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

# JAX flags with no counterpart in the port, and why
REFUSED_FLAGS = {
    "--attention-backend": "has no counterpart: the device picks the path",
    "--conv-backend": "has no counterpart: the device picks the path",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Run FID/IS/PR/PPL on a checkpoint (PyTorch port)")
    p.add_argument("--run-dir", required=True,
                   help="run dir or packed run archive (.tar.gz)")
    p.add_argument("--metrics", default="fid50k,is50k")
    p.add_argument("--num-images", type=int, default=None,
                   help="override metric sample count (e.g. 1000 for smoke)")
    p.add_argument("--batch-size", type=int, default=32)
    # None by default: any explicit value, 1.0 included, conflicts with
    # --psi-sweep; unset means 1.0
    p.add_argument("--truncation-psi", type=float, default=None)
    p.add_argument("--psi-sweep", default=None,
                   help="comma-separated truncation values (e.g. "
                        "'0.5,0.7,1.0'): run the metrics once per psi and "
                        "append the table to metric-psi-sweep.txt; the real "
                        "statistics are disk-cached across psis")
    p.add_argument("--inception-npz", default=None)
    p.add_argument("--cache-dir", default=None)
    p.add_argument("--device", default=None,
                   help="'cpu' runs the plain path on the host; default: "
                        "the card")
    return p


def _sweep_line(group) -> Optional[str]:
    """The generator half's and the extractor half's images/s of the
    fake sweep, the real sweep's, and PPL's pairs/s."""
    t = group.timings
    parts = []
    if t.get("fake_images"):
        parts.append(f"generator {t['fake_images'] / t['generator_s']:.2f} "
                     f"images/s, extractor "
                     f"{t['fake_images'] / t['extractor_s']:.2f} images/s "
                     f"({t['fake_images']} fakes)")
    if t.get("real_images"):
        parts.append(f"real sweep {t['real_images'] / t['real_s']:.2f} "
                     f"images/s ({t['real_images']} reals)")
    if t.get("ppl_pairs"):
        parts.append(f"ppl {t['ppl_pairs'] / t['ppl_s']:.2f} pairs/s")
    return "sweep: " + "; ".join(parts) if parts else None


def main(argv: Optional[List[str]] = None) -> dict:
    """Returns the printed JSON line's payload."""
    argv = sys.argv[1:] if argv is None else list(argv)
    for a in argv:
        flag = a.split("=", 1)[0]
        if flag in REFUSED_FLAGS:
            raise SystemExit(f"{flag}: not in the PyTorch port; it "
                             f"{REFUSED_FLAGS[flag]}")
    p = build_parser()
    args = p.parse_args(argv)

    psis = None
    if args.psi_sweep is not None:
        # validated before the run dir and the restore: a typo fails fast
        try:
            psis = [float(s) for s in args.psi_sweep.split(",") if s.strip()]
        except ValueError:
            p.error(f"--psi-sweep: not a comma-separated float list: "
                    f"{args.psi_sweep!r}")
        if not psis:
            p.error("--psi-sweep: no values given")
        if args.truncation_psi is not None:
            p.error("--truncation-psi conflicts with --psi-sweep; put the "
                    "value in the sweep list instead")
    if args.truncation_psi is None:
        args.truncation_psi = 1.0

    from gansformer_tpu_torch.core.config import ExperimentConfig
    from gansformer_tpu_torch.metrics.metric_base import FLAG_KEYS
    from gansformer_tpu_torch.metrics.sweep import run_metric_sweep
    from gansformer_tpu_torch.train import checkpoint as ckpt
    from gansformer_tpu_torch.train.state import create_train_state
    from gansformer_tpu_torch.utils.logging import (append_metric_line,
                                                    write_flag)
    from gansformer_tpu_torch.utils.runarchive import resolve_run_dir

    run_dir = resolve_run_dir(args.run_dir)
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = ExperimentConfig.from_json(f.read())
    state = create_train_state(cfg.model, cfg.train, cfg.train.seed,
                               args.device)
    state = ckpt.restore(os.path.join(run_dir, "checkpoints"), state)
    kimg = state.step / 1000

    def sweep(psi: float) -> dict:
        groups: list = []
        res = run_metric_sweep(
            cfg, state, run_dir, args.metrics, batch_size=args.batch_size,
            num_images=args.num_images, truncation_psi=psi,
            inception_npz=args.inception_npz, cache_dir=args.cache_dir,
            group_out=groups)
        line = _sweep_line(groups[0])
        if line:
            print(line)
        return res

    if psis:
        table = []
        for psi in psis:
            res = sweep(psi)
            table.append({"psi": psi, **res})
            print(f"psi {psi:<5.2f} " + "  ".join(
                f"{k} {v:.4f}" for k, v in res.items()))
        with open(os.path.join(run_dir, "metric-psi-sweep.txt"), "a") as f:
            for row in table:
                f.write(f"kimg {kimg:<10.1f} psi {row['psi']:<5.2f} "
                        + "  ".join(f"{k} {v:.6f}" for k, v in row.items()
                                    if k != "psi" and k not in FLAG_KEYS)
                        + "\n")
        # flags are the run's state, the same for every psi
        for k in FLAG_KEYS:
            if table and k in table[-1]:
                write_flag(run_dir, k, table[-1][k])
        payload = {"kimg": kimg, "psi_sweep": table}
        print(json.dumps(payload))
        return payload

    results = sweep(args.truncation_psi)
    for name, val in results.items():
        print(f"{name}: {val:.4f}")
        if name in FLAG_KEYS:
            write_flag(run_dir, name, val)
        else:
            append_metric_line(run_dir, name, val, kimg)
    payload = {"kimg": kimg, **results}
    print(json.dumps(payload))
    return payload


if __name__ == "__main__":
    main()
