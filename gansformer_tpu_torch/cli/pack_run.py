"""Pack a run dir into a distributable archive (the port's copy of
``gansformer_tpu/cli/pack_run.py``): ``config.json`` and one checkpoint,
which ``generate --run-dir <archive>`` of either package reads.

    python -m gansformer_tpu_torch.cli.pack_run --run-dir results/00003-ffhq \\
        [--step 25000] [--out ffhq-duplex.tar.gz]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Pack a run dir for distribution")
    p.add_argument("--run-dir", required=True)
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: latest)")
    p.add_argument("--out", default=None,
                   help="output .tar.gz (default: <run>-step<N>.tar.gz)")
    args = p.parse_args(argv)

    from gansformer_tpu_torch.utils.runarchive import pack_run

    print(pack_run(args.run_dir, out_path=args.out, step=args.step))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
