#!/usr/bin/env python3
"""Time the modconv forward kernel at every launch of one synthesize of
each named preset at batch 8, in the preset's dtype, on one NVIDIA GPU,
beside the library call (cuDNN): one method for two trees of the port.
The launches and their inputs come from that tree's ``chip_smoke.py``;
the timer is this file's own, so a copy of this script in an older tree
times the older kernel the same way.  Correctness is ``chip_smoke.py``'s
job and is not checked here.

To compare a change with its parent on one card, put a copy of this
script in each tree's root and run it there in turns (parent, change,
change, parent):

    python3 time_modconv_fwd.py TAG PRESET [PRESET ...]

Prints one line per launch and a sum per preset, each prefixed with TAG.
"""

import sys
import time

import torch

import chip_smoke
from gansformer_tpu_torch.core import get_preset

BATCH = 8


def median_ms(fn) -> float:
    """Device time of one call: the mean over a run of calls by CUDA
    events, the median of three runs (``chip_smoke.time_ms`` of the tree
    that added this script)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = max(time.perf_counter() - t0, 1e-6)
    reps = max(3, min(50, int(0.03 / once)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(3):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / reps)
    return sorted(runs)[len(runs) // 2]


def main() -> int:
    if len(sys.argv) < 3:
        chip_smoke.fail("usage: time_modconv_fwd.py TAG PRESET [PRESET ...]")
    if not torch.cuda.is_available():
        chip_smoke.fail("CUDA is not available")
    tag = sys.argv[1]
    for name in sys.argv[2:]:
        cfg = get_preset(name)
        dtype = getattr(torch, cfg.dtype)
        gen = torch.Generator(device="cuda").manual_seed(0)
        kernel_sum = library_sum = 0.0
        for c in chip_smoke.main_path_calls(cfg, BATCH):
            if c["kernel"] != "modconv":
                continue
            case = chip_smoke.build_case(c, dtype, gen)
            ms, lib = median_ms(case["kernel"]), median_ms(case["library"])
            kernel_sum, library_sum = kernel_sum + ms, library_sum + lib
            print(f"{tag} {name} {c['label']:22s} kernel {ms:.4f} ms "
                  f"library {lib:.4f} ms", flush=True)
            del case
            torch.cuda.empty_cache()
        print(f"{tag} {name} sum kernel {kernel_sum:.4f} ms library "
              f"{library_sum:.4f} ms ({cfg.dtype}, batch {BATCH})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
