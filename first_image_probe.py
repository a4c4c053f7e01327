#!/usr/bin/env python3
"""The first image of a fresh process on the card, by the thread that
serves it: the main thread, a new thread (with and without
``torch.cuda.set_device``), or a ``GenerationService`` (whose dispatcher
is a thread of its own).

    python3 first_image_probe.py            # one card, no arguments

Builds the kernel library into a temporary manifest directory with
``cli/serve.py --warm-only``, then runs each mode in a process of its own,
in the order main, thread, thread_noset, service, service, thread_noset,
thread, main.  Each process restores a random ffhq256-duplex (bf16
programs, buckets 1/4/8), warm-starts from the manifest and times one
request at bucket 1 (``map_rows`` + ``synthesize`` + fetch, seed 5, psi
0.7) from the end of the warm start to the image on the host
(``first_ms``; ``marks_ms`` splits it, ``thread_trivial`` first runs one
trivial op on the new thread), then a second one on a new thread
(``second_ms``).
Prints the card's name and power limit, then one JSON line per process.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

MODES = ("main", "thread", "thread_noset", "thread_trivial", "service",
         "service", "thread_trivial", "thread_noset", "thread", "main")


def child(mode: str, manifest: str) -> None:
    t_start = time.perf_counter()
    import torch

    from gansformer_tpu_torch.core import get_preset
    from gansformer_tpu_torch.serve import (GenerationService, ServePrograms,
                                            WCache, init_generator, map_rows)

    b = init_generator(get_preset("ffhq256-duplex"), seed=0, device="cuda")
    p = ServePrograms(b, buckets=(1, 4, 8), manifest_dir=manifest,
                      serve_precision="bf16")
    t0 = time.perf_counter()
    p.warm_start()
    t_warm = time.perf_counter() - t0
    marks = {}

    def mark(name, t0):
        marks.setdefault(name, time.perf_counter() - t0)   # the first call

    def request(set_dev=True, trivial=False):
        if set_dev:
            torch.cuda.set_device(p.device)
        with torch.inference_mode():
            if trivial:
                a = time.perf_counter()
                torch.ones(1, device=p.device).add_(1)
                torch.cuda.synchronize()
                mark("trivial", a)
            a = time.perf_counter()
            ws = map_rows(p, WCache(), [5])
            torch.cuda.synchronize()
            mark("map", a)
            a = time.perf_counter()
            out = p.synthesize(ws, [0.7], seed=0, tags=[5])
            torch.cuda.synchronize()
            mark("synth", a)
            a = time.perf_counter()
            out.float().cpu().numpy()
            mark("fetch", a)

    def on_thread(**kw):
        th = threading.Thread(target=request, kwargs=kw)
        th.start()
        th.join()

    t0 = time.perf_counter()
    if mode == "main":
        request()
    elif mode == "service":
        with GenerationService(p) as svc:
            svc.submit(5, psi=0.7).result(timeout=600)
    else:
        on_thread(set_dev=mode != "thread_noset",
                  trivial=mode == "thread_trivial")
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    request() if mode == "main" else on_thread()
    second = time.perf_counter() - t0
    print(json.dumps({"mode": mode, "warm_s": round(t_warm, 3),
                      "first_ms": round(first * 1e3, 1),
                      "second_ms": round(second * 1e3, 1),
                      "marks_ms": {k: round(v * 1e3, 1)
                                   for k, v in marks.items()},
                      "since_start_s": round(time.perf_counter() - t_start,
                                             2)}), flush=True)


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    manifest = tempfile.mkdtemp(prefix="first_image_probe_")
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        r = subprocess.run(
            [sys.executable, "-m", "gansformer_tpu_torch.cli.serve",
             "--warm-only", "--init", "random", "--preset", "ffhq256-duplex",
             "--manifest-dir", manifest], cwd=here, capture_output=True,
            text=True, timeout=600)
        print("warm-only rc", r.returncode, r.stdout.strip()[-300:],
              flush=True)
        if r.returncode:
            return 1
        for mode in MODES:
            r = subprocess.run([sys.executable, __file__, mode, manifest],
                               cwd=here, capture_output=True, text=True,
                               timeout=600)
            print(r.stdout.strip() or r.stderr[-800:], flush=True)
    finally:
        shutil.rmtree(manifest, ignore_errors=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        child(sys.argv[1], sys.argv[2])
        sys.exit(0)
    sys.exit(main())
