#!/usr/bin/env python3
"""Time one kernel's launches of each named preset at batch 8, in the
preset's dtype, on one NVIDIA GPU, beside the library call computing the
same function and the least time the card could take (the bound): one
method for two trees of the port.  The launches and their inputs come
from that tree's ``chip_smoke.py``; the timer is this file's own, so a
copy of this script in an older tree times the older kernel the same
way.  Correctness is ``chip_smoke.py``'s job and is not checked here.

Kernels (comma-separated for several in one process):
  modconv             the 20 forward launches of one synthesize (cuDNN)
  upfirdn             the forward launches of one synthesize (depthwise
                      conv2d / conv_transpose2d)
  upfirdn_adjoint     the adjoint launches of one d_step + one g_step
  grid_to_latent      the launches of one synthesize (SDPA)
  grid_to_latent_lse  the same launches writing lse (a g_step's)
  latent_to_grid      the launches of one synthesize (SDPA)
  latent_to_grid_lse  the same launches writing lse (a g_step's)
  grid_to_latent_bwd  the backward launches of one d_step + one g_step
                      (the backward alone of SDPA)
  latent_to_grid_bwd  the same for latent_to_grid

To compare a change with its parent on one card, put a copy of this
script in each tree's root and run it there in turns (parent, change,
change, parent):

    python3 time_kernels.py TAG KERNEL[,KERNEL...] PRESET [PRESET ...]

Prints one line per launch and a sum per preset and kernel, each
prefixed with TAG: the timer's time of one call (the host's time where
the wrapper takes longer than the card), and the device time of one call
by the profiler (the summed time of the kernels the call launches).
"""

import sys
import time
import warnings

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from gansformer_tpu_torch.core import get_preset

BATCH = 8
KERNELS = ("modconv", "upfirdn", "upfirdn_adjoint", "grid_to_latent",
           "grid_to_latent_lse", "latent_to_grid", "latent_to_grid_lse",
           "grid_to_latent_bwd", "latent_to_grid_bwd")


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


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call: the summed time of the kernels that
    ``reps`` calls launch, by the profiler, over ``reps``."""
    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
    us = sum(getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
             for ev in events)
    return us / reps / 1e3


def launches(cfg, kernel):
    """The launches of ``kernel`` that the sums cover, from the tree's
    own plans."""
    if kernel in ("upfirdn_adjoint", "grid_to_latent_bwd",
                  "latent_to_grid_bwd"):
        calls = chip_smoke.train_path_calls(cfg, BATCH)
    else:
        calls = chip_smoke.main_path_calls(cfg, BATCH,
                                           lse=kernel.endswith("_lse"))
    name = kernel[:-len("_lse")] if kernel.endswith("_lse") else kernel
    return [c for c in calls if c["kernel"] == name]


def main() -> int:
    if len(sys.argv) < 4:
        chip_smoke.fail("usage: time_kernels.py TAG KERNEL[,KERNEL...] "
                        "PRESET [PRESET ...]")
    if not torch.cuda.is_available():
        chip_smoke.fail("CUDA is not available")
    tag, kernels = sys.argv[1], sys.argv[2].split(",")
    for kernel in kernels:
        if kernel not in KERNELS:
            chip_smoke.fail(f"unknown kernel {kernel!r}; one of {KERNELS}")
    peaks = chip_smoke.card_peaks(torch.cuda.get_device_name(0))
    for name in sys.argv[3:]:
        cfg = get_preset(name)
        dtype = getattr(torch, cfg.dtype)
        rate = peaks[1] if cfg.dtype == "bfloat16" else peaks[2]
        for kernel in kernels:
            gen = torch.Generator(device="cuda").manual_seed(0)
            sums = [0.0] * 5
            calls = launches(cfg, kernel)
            for c in calls:
                case = chip_smoke.build_case(c, dtype, gen)
                ms, lib = median_ms(case["kernel"]), median_ms(case["library"])
                dev, lib_dev = (device_ms(case["kernel"]),
                                device_ms(case["library"]))
                bound = max(case["bytes"] / peaks[0],
                            case["ops"] / rate) * 1e3
                sums = [x + y for x, y in zip(sums, (ms, lib, bound, dev,
                                                     lib_dev))]
                print(f"{tag} {name} {kernel} {c['label']:28s} kernel "
                      f"{ms:.4f} ms library {lib:.4f} ms bound {bound:.4f} "
                      f"ms; device: kernel {dev:.4f} ms library "
                      f"{lib_dev:.4f} ms", flush=True)
                del case
                torch.cuda.empty_cache()
            print(f"{tag} {name} {kernel} sum of {len(calls)} kernel "
                  f"{sums[0]:.4f} ms library {sums[1]:.4f} ms bound "
                  f"{sums[2]:.4f} ms; device: kernel {sums[3]:.4f} ms "
                  f"library {sums[4]:.4f} ms ({cfg.dtype}, batch {BATCH})",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
