#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # one card, no arguments

In order:
1. prints the card's name and power limit (nvidia-smi);
2. builds the four kernels from ``gansformer_tpu_torch/csrc``;
3. for every kernel launch of the serve run below (one ``synthesize`` of
   ffhq256-duplex at each of batch 1, 2, 4 and 8, bf16), and for the
   flagship shapes in fp32 too: runs the kernel and its plain PyTorch
   version on the same inputs on the card and holds them to the stated
   tolerance; times the kernel, the plain version and one library call
   computing the same function (the yardstick), and computes the least
   time the card could take (the bound).  Where latent_to_grid splits n
   into chunks, it also shows the tolerance rejects the output of a
   kernel that dropped one chunk;
4. serves ffhq256-duplex at full width from a random init (bf16):
   ``map_seeds`` + ``synthesize`` over buckets 1, 2, 4 and 8 with mixed
   psi, with the launch counters reset just before and read just after;
   checks the images are finite and the counters moved by exactly the
   launches the path makes per synthesize; measures images/s;
5. compares the card's images (fp32 and bf16 kernels) with the plain path
   on the host CPU (fp32) at batch 2 and noise off: a wrapper never routes
   a CUDA tensor to its plain version, so the host run is the plain path;
6. prints the kernels' JSON line, then ``{"ok": true, "device": ...}``.
   Every number of a kernel in the JSON line covers the same launches:
   those of the serve run (``launches``), so ``ms`` is their total kernel
   time, measured in phase 3 on the same shapes.

Exits non-zero, printing no result, on any failure, without CUDA, or
without the ``gansformer_tpu_torch`` package beside it.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

REPLACES = {
    "modconv": "gansformer_tpu/ops/pallas_modconv.py:378",
    "upfirdn": "gansformer_tpu/ops/pallas_upfirdn.py:327",
    "grid_to_latent": "gansformer_tpu/ops/pallas_attention.py:175",
    "latent_to_grid": "gansformer_tpu/ops/pallas_attention.py:372",
}
SOURCES = {
    "modconv": "gansformer_tpu_torch/csrc/modconv.cu",
    "upfirdn": "gansformer_tpu_torch/csrc/upfirdn.cu",
    "grid_to_latent": "gansformer_tpu_torch/csrc/attention.cu",
    "latent_to_grid": "gansformer_tpu_torch/csrc/attention.cu",
}
# Kernel-vs-plain tolerance on max |err|, relative to max |plain| of the
# same launch (no floor: latent_to_grid's outputs are averages over
# thousands of keys and peak near 0.1): fp32 differs only by summation
# order over <= 4608 terms; bf16 outputs are rounded to 8 mantissa bits in
# both versions (2^-8 of the largest value is 0.4 %), and latent_to_grid
# keeps fp32 probabilities where the plain version casts them to bf16.
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# The serve run's buckets: one synthesize at each batch size.
BUCKETS = (1, 2, 4, 8)
# Whole-generator tolerance (max |err| relative to max |host plain fp32|):
# fp32 accumulates summation-order differences over ~40 layers; bf16
# rounds every layer's activations (2^-8 relative) on top.
MODEL_TOL = {"float32": 2e-3, "bfloat16": 1e-1}
# Published dense peaks by card (bytes/s, bf16 tensor flop/s, fp32 flop/s).
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100 NVL": (3.9e12, 835e12, 60e12),
    "H100": (3.35e12, 989e12, 67e12),          # SXM
    "H200": (4.8e12, 989e12, 67e12),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    return PEAKS["H100"]


# --------------------------------------------------------------------------
# The kernel launches one synthesize makes, and their cases
# --------------------------------------------------------------------------


def main_path_calls(cfg, batch: int):
    """Every kernel launch of one ``synthesize`` at ``cfg``, in order."""
    calls = []
    k = cfg.components
    attn = set(cfg.attn_resolutions())
    cin = cfg.nf(4)
    for res in cfg.block_resolutions:
        nf = cfg.nf(res)
        if res > 4:
            calls.append(dict(kernel="modconv", label=f"b{res}_conv_up poly",
                              kind="poly", B=batch, H=res // 2, Ci=cin,
                              Co=nf, act=None))
            calls.append(dict(kernel="upfirdn", label=f"b{res} blur",
                              B=batch, H=res, C=nf, up=1,
                              pads=(2, 1, 2, 1)))
        calls.append(dict(kernel="modconv", label=f"b{res}_conv same3",
                          kind="same3", B=batch, H=res, Ci=nf, Co=nf,
                          act=None))
        if res in attn:
            n = res * res
            if cfg.attention == "duplex":
                for _ in range(cfg.kmeans_iters):
                    calls.append(dict(
                        kernel="grid_to_latent" if k >= n
                        else "latent_to_grid",
                        label=f"b{res} centroid", B=batch * cfg.num_heads,
                        Lq=k, Lk=n, D=nf // cfg.num_heads,
                        Dv=cfg.w_dim // cfg.num_heads))
            calls.append(dict(
                kernel="grid_to_latent" if n >= k else "latent_to_grid",
                label=f"b{res} main", B=batch * cfg.num_heads, Lq=n, Lk=k,
                D=nf // cfg.num_heads, Dv=nf // cfg.num_heads))
        calls.append(dict(kernel="modconv", label=f"b{res}_trgb same1",
                          kind="same1", B=batch, H=res, Ci=nf,
                          Co=cfg.img_channels, act="linear"))
        if res > 4:
            calls.append(dict(kernel="upfirdn", label=f"b{res} skip up",
                              B=batch, H=res // 2, C=cfg.img_channels, up=2,
                              pads=(2, 1, 2, 1)))
        cin = nf
    return calls


def library_modconv(xs, w, kind):
    """One library call computing the modulated conv on pre-modulated
    NHWC ``xs`` (the yardstick; the port never calls it).  Returns the
    call; layouts are prepared outside it."""
    import torch
    import torch.nn.functional as F

    x = xs.permute(0, 3, 1, 2)                  # NHWC memory = channels_last
    if kind == "poly":
        wt = torch.flip(w, (0, 1)).permute(2, 3, 0, 1).contiguous(
            memory_format=torch.channels_last)  # [Ci, Co, 3, 3]
        return lambda: F.conv_transpose2d(x, wt, stride=2, padding=1,
                                          output_padding=1)
    wo = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return lambda: F.conv2d(x, wo, padding=w.shape[0] // 2)


def library_upfirdn(x, f, up, pads):
    """One library call computing upfirdn2d for the path's two cases: the
    blur (up=1, on the pre-padded input) and the skip upsample (up=2)."""
    import torch
    import torch.nn.functional as F

    c = x.shape[-1]
    k = torch.as_tensor(f, dtype=x.dtype, device=x.device)
    xc = x.permute(0, 3, 1, 2)
    if up == 1:
        py0, py1, px0, px1 = pads
        xp = F.pad(xc, (px0, px1, py0, py1))
        kf = torch.flip(k, (0, 1))[None, None].expand(c, 1, *k.shape)
        kf = kf.contiguous()
        return lambda: F.conv2d(xp, kf, groups=c)
    assert up == 2 and pads == (2, 1, 2, 1) and k.shape == (4, 4)
    kt = k[None, None].expand(c, 1, 4, 4).contiguous()
    return lambda: F.conv_transpose2d(xc, kt, stride=2, padding=1, groups=c)


def library_attention(q, k, v):
    """One library call: scaled_dot_product_attention, one head."""
    import torch.nn.functional as F

    return lambda: F.scaled_dot_product_attention(q[:, None], k[:, None],
                                                  v[:, None])[:, 0]


def build_case(call, dtype, gen, dev="cuda", chunk=None):
    """One launch on inputs made on ``dev`` from ``gen``: a dict of the
    kernel, plain and library calls, the bytes and operations the bound
    counts, and ``fault``: a call giving what a broken kernel would give
    (latent_to_grid with one of its ``chunk``-key chunks dropped; the
    kernel's own chunk unless given), or None."""
    import torch

    from gansformer_tpu_torch.ops import _build, cuda_attention, \
        cuda_modconv, cuda_upfirdn
    from gansformer_tpu_torch.ops.attention import attention_plain
    from gansformer_tpu_torch.ops.modulated_conv import (_demod_coeffs,
                                                         modconv_plain,
                                                         stack_weights)
    from gansformer_tpu_torch.ops.upfirdn2d import (setup_filter,
                                                    upfirdn2d_plain)

    it = torch.tensor([], dtype=dtype).element_size()

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    if call["kernel"] == "modconv":
        kind, b, h, ci, co = (call["kind"], call["B"], call["H"], call["Ci"],
                              call["Co"])
        ks = 1 if kind == "same1" else 3
        x = randn(b, h, h, ci).to(dtype)
        w = (randn(ks, ks, ci, co) / math.sqrt(ci * ks * ks)).to(dtype)
        s = randn(b, ci) * 0.2 + 1.0
        d = (_demod_coeffs(w.float(), s, 1e-8) if kind != "same1"
             else torch.ones(b, co, device=dev))
        post = d.repeat_interleave(4, dim=1) if kind == "poly" else d
        ws = stack_weights(kind, w)
        bias = randn(co) * 0.1 if call["act"] else None
        args = (x, ws, s, post, bias, kind, call["act"], 0.2, 1.0)
        xs = (x.float() * s[:, None, None, :]).to(dtype)
        up = 2 if kind == "poly" else 1
        nbytes = ((x.numel() + w.numel() + b * up * h * up * h * co) * it
                  + (s.numel() + d.numel()) * 4
                  + (co * 4 if bias is not None else 0))
        # every tap of w once per input pixel: the stride-2 transposed
        # conv's four phases take 4 + 2 + 2 + 1 = 9 taps, not the 16 of
        # the zero-padded 2x2 phase weights the kernel stores
        ops = 2.0 * b * h * h * ks * ks * ci * co
        return dict(kernel=lambda: cuda_modconv.modconv_cuda(*args),
                    plain=lambda: modconv_plain(*args),
                    library=library_modconv(xs, w, kind), bytes=nbytes,
                    ops=ops, fault=None)
    if call["kernel"] == "upfirdn":
        b, h, c, up, pads = (call["B"], call["H"], call["C"], call["up"],
                             call["pads"])
        f = setup_filter((1, 3, 3, 1), gain=4.0)
        x = randn(b, h, h, c).to(dtype)
        args = (x, f, up, 1, pads, None, None, 0.2, 1.0)
        oh = h * up
        nbytes = (x.numel() + b * oh * oh * c) * it
        ops = 2.0 * b * oh * oh * c * f.size / (up * up)
        return dict(kernel=lambda: cuda_upfirdn.upfirdn2d_cuda(*args),
                    plain=lambda: upfirdn2d_plain(*args),
                    library=library_upfirdn(x, f, up, pads), bytes=nbytes,
                    ops=ops, fault=None)
    b, lq, lk, d, dv = call["B"], call["Lq"], call["Lk"], call["D"], \
        call["Dv"]
    q = randn(b, lq, d).to(dtype)
    k = randn(b, lk, d).to(dtype)
    v = randn(b, lk, dv).to(dtype)
    fn = (cuda_attention.grid_to_latent_cuda
          if call["kernel"] == "grid_to_latent"
          else cuda_attention.latent_to_grid_cuda)
    nbytes = (q.numel() + k.numel() + v.numel() + b * lq * dv) * it
    ops = 2.0 * b * lq * lk * (d + dv)
    fault = None
    if call["kernel"] == "latent_to_grid":
        chunk = chunk or _build.load_library().gt_attn_chunk()
    if call["kernel"] == "latent_to_grid" and lk > chunk:
        c0 = (-(-lk // chunk) // 2) * chunk       # the middle chunk
        keep = torch.cat([torch.arange(0, c0, device=dev),
                          torch.arange(c0 + chunk, lk, device=dev)])
        fault = lambda: attention_plain(q, k[:, keep], v[:, keep])  # noqa
    return dict(kernel=lambda: fn(q, k, v),
                plain=lambda: attention_plain(q, k, v),
                library=library_attention(q, k, v), bytes=nbytes, ops=ops,
                fault=fault)


def time_ms(fn) -> float:
    """Mean device time of one call, by CUDA events over a run of calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = max(time.perf_counter() - t0, 1e-6)
    reps = max(3, min(50, int(0.03 / once)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernels(calls, dtype_name, peaks, show: bool = True):
    """Run every call's kernel against its plain version, and time both
    and the library call; returns per-call rows.  Fails the script on a
    mismatch, or where a planted fault would pass the tolerance."""
    import torch

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = []
    for call in calls:
        case = build_case(call, dtype, gen)
        got = case["kernel"]()
        ref = case["plain"]().float()
        torch.cuda.synchronize()
        what = f"{call['kernel']} {call['label']} B={call['B']} {dtype_name}"
        if got.shape != ref.shape:
            fail(f"{what}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
        err = float((got.float() - ref).abs().max())
        tol = KERNEL_TOL[dtype_name] * float(ref.abs().max())
        if not (math.isfinite(err) and err <= tol):
            fail(f"{what}: max|err| {err:.3e} > tol {tol:.3e}")
        control = ""
        if case["fault"] is not None:
            ferr = float((case["fault"]().float() - ref).abs().max())
            if not ferr > tol:
                fail(f"{what}: a kernel that drops one chunk would pass "
                     f"(max|err| {ferr:.3e} <= tol {tol:.3e})")
            control = f" drop-one-chunk control {ferr:.3e} > tol"
        rate = peaks[1] if dtype_name == "bfloat16" else peaks[2]
        row = dict(call, dtype=dtype_name, max_abs_err=err, tol=tol,
                   bytes_ms=case["bytes"] / peaks[0] * 1e3,
                   ops_ms=case["ops"] / rate * 1e3,
                   ms=time_ms(case["kernel"]),
                   plain_ms=time_ms(case["plain"]),
                   library_ms=time_ms(case["library"]))
        rows.append(row)
        if show:
            print(f"  {call['kernel']:15s} {call['label']:22s} "
                  f"{dtype_name:9s} max|err| {err:.3e} (tol {tol:.1e}) ok"
                  f"{control} kernel {row['ms']:.4f} ms plain "
                  f"{row['plain_ms']:.4f} library {row['library_ms']:.4f} "
                  f"bound {max(row['bytes_ms'], row['ops_ms']):.4f} ms",
                  flush=True)
        del case
    return rows


def kernel_sums(rows):
    """Per kernel: the launches and the sums of times and bounds."""
    out = {}
    for kname in REPLACES:
        rs = [r for r in rows if r["kernel"] == kname]
        bytes_ms = sum(r["bytes_ms"] for r in rs)
        ops_ms = sum(r["ops_ms"] for r in rs)
        out[kname] = {
            "launches": len(rs),
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "worst_err_over_tol": max(r["max_abs_err"] / r["tol"]
                                      for r in rs),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(max(r["bytes_ms"], r["ops_ms"]) for r in rs),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": sum(r["library_ms"] for r in rs),
        }
    return out


def print_sums(title, sums):
    print(title, flush=True)
    for kname, s in sums.items():
        print(f"    {kname:15s} {s['launches']:3d} launches  kernel "
              f"{s['ms']:8.4f} ms  plain {s['plain_ms']:8.4f}  library "
              f"{s['library_ms']:8.4f}  bound {s['bound_ms']:.4f} "
              f"({s['bound_by']})  worst err/tol "
              f"{s['worst_err_over_tol']:.3f}", flush=True)


FLAGSHIP = ("b256_conv same3", "b256 blur", "b128_conv_up poly",
            "b256_trgb same1", "b256 skip up", "b128 centroid", "b128 main",
            "b4 centroid", "b4 main")


# --------------------------------------------------------------------------
# Main path: serving ffhq256-duplex
# --------------------------------------------------------------------------


def perturb(generator):
    """Make the ReZero gates and noise strengths non-zero so neither path
    is trivially off in a random init."""
    import torch

    with torch.no_grad():
        for name, p in generator.named_parameters():
            if name.endswith("_wattn_gate") or name.endswith(
                    "noise_strength"):
                p.fill_(0.1)


def serve_run(cfg, expected):
    import torch

    from gansformer_tpu_torch import ops
    from gansformer_tpu_torch.serve import ServePrograms, init_generator

    bundle = init_generator(cfg, seed=0, device="cuda")
    perturb(bundle.generator)
    progs = ServePrograms(bundle)
    psis = {1: [0.7], 2: [0.5, 1.0], 4: [0.7, 0.7, 1.0, 0.3],
            8: [0.7, 1.0] * 4}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for bucket in BUCKETS:
        seeds = list(range(100 * bucket, 101 * bucket))
        before = ops.launch_counts()
        ws = progs.map_seeds(seeds)
        img = progs.synthesize(ws, psis[bucket], seed=7, tags=seeds)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        if tuple(img.shape) != (bucket, cfg.resolution, cfg.resolution,
                                cfg.img_channels):
            fail(f"bucket {bucket}: image shape {tuple(img.shape)}")
        if not bool(torch.isfinite(img).all()):
            fail(f"bucket {bucket}: non-finite pixels")
        print(f"  bucket {bucket}: images {tuple(img.shape)} finite, "
              f"range [{float(img.min()):.3f}, {float(img.max()):.3f}], "
              f"launches {delta}", flush=True)
        if delta != expected:
            fail(f"bucket {bucket}: launches {delta} != {expected}")
    counts = ops.launch_counts()
    for name, c in counts.items():
        if c == 0:
            fail(f"kernel {name} was not launched on the main path")
    # throughput at the largest bucket (host clock around synchronized
    # work; excludes the first call, which the loop above already warmed)
    seeds = list(range(200, 208))
    ws = progs.map_seeds(seeds)
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        progs.synthesize(ws, [0.7] * 8, seed=7, tags=seeds)
    torch.cuda.synchronize()
    synth_s = (time.perf_counter() - t0) / reps
    profile_synth(progs, seeds)
    return bundle, counts, synth_s


KERNEL_GROUPS = (("modconv", "modconv_"), ("upfirdn", "upfirdn_kernel"),
                 ("grid_to_latent", "g2l_kernel"),
                 ("latent_to_grid", "l2g_"), ("matmul", "gemm"),
                 ("matmul", "cutlass"), ("noise draw", "distribution"))


def profile_synth(progs, seeds):
    """Device time of one bucket-8 synthesize by kernel group (the
    profiler's CUDA activity), and the device-busy share of its wall
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ws = progs.map_seeds(seeds)
    progs.synthesize(ws, [0.7] * len(seeds), seed=7, tags=seeds)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        progs.synthesize(ws, [0.7] * len(seeds), seed=7, tags=seeds)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, launches, others = {}, {}, []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us <= 0:
            continue
        group = next((g for g, key in KERNEL_GROUPS if key in ev.key),
                     "other elementwise/copy")
        groups[group] = groups.get(group, 0.0) + us / 1e3
        launches[group] = launches.get(group, 0) + ev.count
        if group == "other elementwise/copy":
            others.append((us / 1e3, ev.count, ev.key))
    device_ms = sum(groups.values())
    if device_ms == 0:
        print("  profiler recorded no device time: not measured")
        return
    print(f"  one synthesize at bucket {len(seeds)}: wall {wall_ms:.2f} ms "
          f"(profiled), device busy {device_ms:.2f} ms "
          f"({100 * device_ms / wall_ms:.1f} % of wall)")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"    {g:24s} {ms:8.3f} ms  {launches[g]:5d} launches  "
              f"{100 * ms / device_ms:5.1f} % of device time")
    print("  largest of the other ops:")
    for ms, count, key in sorted(others, reverse=True)[:8]:
        print(f"    {key[:56]:56s} {ms:8.3f} ms  {count:5d} calls")


def model_compare(cfg, bundle):
    """Card kernels (fp32 and bf16) vs the host plain path (fp32)."""
    import dataclasses

    import torch

    from gansformer_tpu_torch.models import Generator
    from gansformer_tpu_torch.serve import ServePrograms
    from gansformer_tpu_torch.serve.programs import bundle_from_generator

    state = {k: v.detach().cpu() for k, v in
             bundle.generator.state_dict().items()}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    seeds, psi = [21, 22], [0.7, 1.0]

    def images(model_cfg, device):
        g = Generator(model_cfg)
        g.load_state_dict(state)
        progs = ServePrograms(bundle_from_generator(g, device=device))
        return progs.synthesize(progs.map_seeds(seeds), psi,
                                noise_mode="none").float().cpu()

    t0 = time.perf_counter()
    ref = images(cfg32, "cpu")
    host_s = time.perf_counter() - t0
    scale = float(ref.abs().max())
    out = {}
    for name, mcfg in (("float32", cfg32), ("bfloat16", cfg)):
        got = images(mcfg, "cuda")
        err = (got - ref).abs()
        out[name] = (float(err.max()), float(err.mean()))
        tol = MODEL_TOL[name] * scale
        print(f"  {name:9s} card kernels vs host plain fp32: max|err| "
              f"{out[name][0]:.3e} mean|err| {out[name][1]:.3e} "
              f"(tol {tol:.3e}, image max|x| {scale:.3f}; host "
              f"{host_s:.1f} s)", flush=True)
        if not math.isfinite(out[name][0]) or out[name][0] > tol:
            fail(f"generator {name}: max|err| {out[name][0]:.3e} > {tol:.3e}")
    return out


def main() -> int:
    if len(sys.argv) > 1:
        fail(f"takes no arguments, got {sys.argv[1:]}")

    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    try:
        from gansformer_tpu_torch import ops
        from gansformer_tpu_torch.core import get_preset
        from gansformer_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"the gansformer_tpu_torch package is not importable: {e}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi gave no card: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)             # exactly as nvidia-smi prints it
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{name}; peaks used for bounds: {peaks[0] / 1e12:.2f} TB/s, "
          f"{peaks[1] / 1e12:.0f} TFLOP/s bf16, {peaks[2] / 1e12:.0f} "
          f"TFLOP/s fp32", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    _build.load_library()
    print(f"built {[os.path.relpath(s) for s in _build.sources()]} -> "
          f"{os.path.relpath(_build.build_info['path'])} in "
          f"{time.perf_counter() - t0:.1f} s "
          f"(compiled: {_build.build_info['built']})", flush=True)

    cfg = get_preset("ffhq256-duplex")
    calls = {b: main_path_calls(cfg, b) for b in BUCKETS}
    expected = {k: sum(c["kernel"] == k for c in calls[8]) for k in REPLACES}
    print(f"launches per synthesize at ffhq256-duplex: {expected}",
          flush=True)
    if expected != {"modconv": 20, "upfirdn": 12, "grid_to_latent": 7,
                    "latent_to_grid": 5}:
        fail(f"unexpected launch plan {expected}")

    flagship = [c for c in calls[8] if c["label"] in FLAGSHIP]
    print("kernels vs plain, fp32, flagship shapes at batch 8:", flush=True)
    check_kernels(flagship, "float32", peaks)
    rows = []
    for b in BUCKETS:
        print(f"kernels vs plain, bf16, every launch of one synthesize at "
              f"batch {b}:", flush=True)
        bucket_rows = check_kernels(calls[b], "bfloat16", peaks,
                                    show=b == BUCKETS[-1])
        print_sums(f"  sums over the {len(bucket_rows)} launches of one "
                   f"synthesize at batch {b}:", kernel_sums(bucket_rows))
        rows += bucket_rows
    run_sums = kernel_sums(rows)
    print_sums(f"  sums over the serve run's {len(rows)} launches "
               f"(batches {'+'.join(map(str, BUCKETS))}):", run_sums)

    print("serve ffhq256-duplex (bf16, random init, buckets "
          f"{'/'.join(map(str, BUCKETS))}):", flush=True)
    bundle, counts, synth_s = serve_run(cfg, expected)
    print(f"  launches over {len(BUCKETS)} synthesize calls: {counts}")
    for kname, s in run_sums.items():
        if counts[kname] != s["launches"]:
            fail(f"{kname}: the serve run launched it {counts[kname]} "
                 f"times, the checks timed {s['launches']} launches")
    print(f"  synthesize at bucket 8: {synth_s * 1e3:.2f} ms, "
          f"{8 / synth_s:.2f} images/s on {card}", flush=True)
    print("generator vs plain path, batch 2, noise off:", flush=True)
    model_compare(cfg, bundle)

    kernels = [{
        "name": kname, "route": "cuda", "source": SOURCES[kname],
        "replaces": REPLACES[kname], "launches": counts[kname],
        **{key: s[key] for key in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
    } for kname, s in run_sums.items()]
    print("kernels over the serve run's launches (bf16; ms, plain_ms, "
          f"bound_ms and library_ms are sums over them):", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
