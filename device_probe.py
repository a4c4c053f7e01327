#!/usr/bin/env python3
"""The modconv forward on a second card, in two checkouts: the
shared-memory opt-in (ROADMAP C.21) and the launch's device (C.22).

    python3 device_probe.py                 # two cards or more
    python3 device_probe.py TREE [TREE...]  # other checkouts first

For each checkout (by default this one; a parent's unpacked with ``git
archive`` under a git-ignored directory), a process of its own per mode
runs one bf16 modconv forward at the flagship shape of ffhq256-duplex
serving (``b256_conv same3`` at batch 8, the ``fwd_wgmma_kernel`` path)
on cuda:0 and then on cuda:1, each against its plain version:

* ``current``: cuda:1 current for its launch, so only the opt-in, made
  on cuda:0 by the first launch, is in question;
* ``other``: cuda:0 current throughout, so the launch on cuda:1 tensors
  asks where a launch goes.

Prints the card's name and power limit, then one line per launch.
"""

import os
import subprocess
import sys

MODES = ("current", "other")


def child(mode: str) -> None:
    """One mode in the checkout that is the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke
    from gansformer_tpu_torch.core import get_preset
    from gansformer_tpu_torch.ops import _build

    _build.load_library()
    cfg = get_preset("ffhq256-duplex")
    call = next(c for c in chip_smoke.main_path_calls(cfg, 8)
                if c["kernel"] == "modconv"
                and c["label"] == "b256_conv same3")
    tree = os.path.basename(os.getcwd())
    for dev in ("cuda:0", "cuda:1"):
        gen = torch.Generator(device=dev).manual_seed(1234)
        current = int(dev[-1]) if mode == "current" else 0
        with torch.cuda.device(current):
            case = chip_smoke.build_case(call, torch.bfloat16, gen, dev=dev)
            try:
                got = case["kernel"]()
                torch.cuda.synchronize(dev)
                ref = case["plain"]()
                err = float((got.float() - ref.float()).abs().max())
                print(f"{tree} {mode}: {dev} launch ok, max|err| "
                      f"{err:.3e}, current device during launch "
                      f"{torch.cuda.current_device()}", flush=True)
            except Exception as e:
                print(f"{tree} {mode}: {dev} launch failed: "
                      f"{type(e).__name__}: {e}", flush=True)


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return 0
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), torch.cuda.device_count(), flush=True)
    if torch.cuda.device_count() < 2:
        print("needs two cards", flush=True)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    for tree in [os.path.abspath(t) for t in sys.argv[1:]] + [here]:
        for mode in MODES:
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--child", mode], cwd=tree,
                               capture_output=True, text=True, timeout=300)
            print(r.stdout.strip(), flush=True)
            if r.returncode:
                print(f"  exit {r.returncode}: {r.stderr.strip()[-800:]}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
