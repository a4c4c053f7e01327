#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # one card, no arguments

In order:
1. prints the card's name and power limit (nvidia-smi);
2. builds the kernels from ``gansformer_tpu_torch/csrc``, prints each
   kernel's registers and spills (ptxas; it fails where a kernel of
   ``NO_SPILL`` spills) and fails unless the SASS of the modconv wgmma
   kernels, forward and backward, holds HGMMA and that of the attention
   tensor-core kernels (grid->latent and latent->grid, forward and
   backward each) HMMA (``cuobjdump -sass``); then ROADMAP C.16: the
   attention kernels, forward writing lse and backward, in fp32 and bf16
   at D's b8 shape as the largest logit grows from 1e1 to 1e4, against
   float64 autograd of the softmax beside the plain pair's error
   (``logit_scaling``): grid->latent's fp32 dq and dk at 1e3 and 1e4
   must be within ``LOGIT_FACTOR`` of the plain pair's;
3. serving.  First the library's tile and shared memory of each modconv
   forward launch against the wrapper's, and its route, tile and shared
   memory of each upfirdn and grid->latent launch, and its route, tile,
   spans and ring of each latent->grid launch.  For every kernel
   launch of the
   serve run below (one ``synthesize`` of ffhq256-duplex at each of batch
   1, 2, 4 and 8, bf16), and for the flagship shapes in fp32 too: runs
   the kernel and its plain PyTorch version on the same inputs on the
   card and holds them to the stated tolerance; times the kernel, the
   plain version and one library call computing the same function (the
   yardstick), each the median of three runs, and computes the least
   time the card could take (the bound).  Planted faults the tolerance
   must reject: latent_to_grid with one span of keys dropped where the
   tensor-core launch splits n into spans and one tile where n spans
   several (one 256-key chunk on the fp32 route); grid_to_latent with the
   last latent dropped and with the
   keys and values of samples 0 and 1 swapped; upfirdn with one tap
   dropped and, on a ramp filter the kernel also runs, with the filter
   not flipped; the modconv forward with the styles of samples 0 and 1
   swapped, with its middle tap dropped and, where the launch splits its
   contraction, with one split's partial dropped.  Then every blur launch
   of the synthesize at batch 8 once more with the fused bias + lrelu
   epilogue, upfirdn's general route once at a 3x3 filter, and the
   attention tensor-core kernels once each at a ragged shape no preset
   makes (grid->latent at n 200, L 20; latent->grid forward with lse and
   backward, and grid->latent backward, at n 1000, L 20, three spans, a
   ragged last tile; grid->latent backward at n 200 too);
4. serves ffhq256-duplex at full width from a random init (bf16):
   ``map_seeds`` + ``synthesize`` over buckets 1, 2, 4 and 8 with mixed
   psi, with the launch counters reset just before and read just after;
   checks the images are finite and the counters moved by exactly the
   launches the path makes per synthesize (and the upfirdn,
   grid->latent and latent->grid launches by the routes the plan gives:
   tile or small channel, tensor cores in bf16); measures images/s;
5. compares the card's images (fp32 and bf16 kernels) with the plain path
   on the host CPU (fp32) at batch 2 and noise off: a wrapper never routes
   a CUDA tensor to its plain version, so the host run is the plain path;
   then the serving precisions (``precision_phase``): the serve weights in
   the fp32 configuration at buckets 1 and 8 in f32, bf16 and int8w, the
   launches of each synthesize held to the plan (int8w launches the bf16
   kernels), the images held to the host's fp32 plain path at psi 0.7 and
   1.0, noise on (drawn on the CPU, so both sides add the same) and off,
   at ``precision_tolerance`` with the host's plain path at the same
   precision as the witness, the JAX package's ``fidelity_report`` fixture
   gated the same way, each synth program's bytes, peak memory, ms and
   images/s at bucket 8, a planted int8w scale fault the gate must
   reject, and the w cache on the card (a repeated seed maps 0 times, a
   hit-and-miss batch once); then ``cli/serve.py`` in processes
   of its own on one fresh manifest directory (``serve_cli_phase``):
   ``--warm-only`` cold (the library builds), then bf16 and int8w warm
   (it loads), then bf16 cold with ``--no-warm-start``, each
   first_image_ms and restore_ms printed, each JSON line and grid
   checked (the default mode serves through the service: its line holds
   ``health`` and ``replicas`` 1, and ``--healthcheck`` on its
   ``telemetry.prom`` exits 0); then the generation service
   (``service_phase``) at buckets 1, 4 and 8: 24 Zipfian requests in f32
   held to each request alone through ``map_rows`` + ``synthesize`` (a
   planted fault, tags from the batch position, rejected), the load
   test in bf16 (256 Poisson requests at half the serve run's
   images/s, its launches held to the plan per synthesize, every request
   at one terminal event) and the chaos drill (a burst past a queue of 8
   with one injected dispatcher crash: shed, one restart, 0 hung,
   serving again); then the replica fleet (``fleet_phase``) on every
   visible card, or on cuda:0 twice with one card: the same 24 requests
   in f32 through a ``ReplicaSet`` held to each request alone on cuda:0,
   its launches counted (every serve kernel launched) and every member
   serving (a planted router that always picks member 0 rejected); with
   two cards or more, a bf16 fleet on cuda:0 and cuda:1 held to cuda:0
   alone and one modconv forward on a cuda:1 tensor launched while
   cuda:0 is current, against its plain version; the autoscale drill
   (scale-out before any breaker trip, 0 hung, every ticket settled
   typed); the SLO report over the phase's ``requests.jsonl`` and
   ``telemetry.prom``; ``cli/serve.py --autoscale`` once, its prom held
   to the fleet families and ``--healthcheck`` on it;
6. training (the ffhq256-duplex preset itself: full width and depth,
   attention on, batch 8, bf16, random init from seed 0, noise on, style
   mixing 0.9, procedural reals).  For every backward launch of one
   d_step and one g_step (modconv dx/ds, modconv dw, upfirdn adjoint,
   grid->latent and latent->grid backward; first the library's dx tile
   and shared memory of each modconv launch against the wrapper's),
   every forward attention
   launch that writes ``lse`` (G's in the g_step; G's forward in the
   d_step runs under no_grad and writes none), and the discriminator's
   forward upfirdn launches: the kernel against its plain version (bf16;
   fp32 too at the flagship shapes), timed like phase 3 (the attention
   backward's yardstick is the backward alone of
   ``scaled_dot_product_attention``, with the backend PyTorch picked),
   with planted-fault controls the tolerance must reject: dw with one
   sample's term dropped, ds with one tile's partial dropped (the
   launch's own dx tile, as the library reports it),
   the adjoint with its filter not flipped (at the path's symmetric
   filter that changes nothing, so each adjoint geometry also runs with
   an asymmetric filter), the attention backward with one chunk's
   partial dropped (dk/dv of grid->latent, dq of latent->grid: one
   span's partial and one tile on the tensor cores, one 64-row chunk in
   fp32) and with its row correction delta left out, and lse without
   log(den);
7. drives ``d_step`` + ``g_step`` with the counters reset just before and
   read just after each, and checks them (and the launches that wrote
   lse) against the launch plan; then 3 more alternating iterations:
   finite losses, every gradient leaf finite and nonzero, parameters and
   EMA moved; ms per step by CUDA events and the profiler's breakdown;
   then the preset with ``d_attention`` (one d_step + one g_step): its
   counters against its plan, finite losses and gradients, and any
   attention launch shape the preset's run did not hold against its
   plain version; the same with ``attn_fused_kv`` too (ROADMAP C.18: k
   and v are views of one projection's output in G and D); then R1: one ``d_step_r1`` of the preset and one with
   ``d_attention`` (batch 8, bf16; R1 on the whole batch at the preset's
   ``r1_batch_shrink``), each with its counters (kernel launches, lse,
   routes and the second-order passes: kernel 2 as the adjoint's
   adjoint, the attention's torch-op passes) reset just before and held
   to ``r1_step_calls``' plan, any launch shape no earlier phase held
   against its plain version (none is expected: the second order
   re-enters known geometries), finite losses with ``Loss/D/r1``, every
   leaf of D finite and nonzero, and the step's peak device memory; the
   preset's then 3 more iterations of d_step_r1, d_step and g_step by
   CUDA events and the profiler's breakdown of one d_step_r1; then path
   length: one ``g_step_pl`` of the preset (batch 8, the penalty on 4
   fresh latents, bf16), any launch shape of it no earlier phase held
   against its plain version (those of the path-length batch; its second
   order re-enters the first order's shapes), its counters (launches,
   lse, routes and the second-order passes: kernels 1, 5 and 6 for the
   modconv core, kernel 2 for upfirdn, the attention's torch-op passes)
   held to ``pl_step_calls``' plan, finite losses with ``Loss/G/pl``,
   every leaf of G finite and nonzero, the step's peak device memory, 3
   iterations of g_step_pl, g_step and d_step by CUDA events, a run's
   mean g step, and the profiler's breakdown of one g_step_pl; then each
   other preset (cityscapes256-duplex at L = 32,
   ffhq1024-duplex at 512^2 and 1024^2, clevr64-simplex in fp32; the
   ModelConfig of bedroom256-duplex is ffhq256-duplex's, which the
   script asserts), at batch 8: every launch of one synthesize and one
   d_step + g_step at a shape no earlier phase held, kernel against
   plain, then the synthesize and the two steps with their counters held
   to the plans, finite losses and gradients, and the phase's seconds;
8. one d_step and one g_step in fp32 at batch 2 (noise off, mixing off)
   on the card and on the host: every gradient leaf held to the host's,
   D's and G's apart, the attention leaves printed apart; then G alone,
   both sides given the host's gradient of the loss wrt the images (D's
   cuDNN convolutions out of the chain); then the card's and the host's
   fp32 gradients against the host's float64 plain path (ROADMAP C.2):
   one d_step_r1 with and without ``d_attention`` (D's leaves) and one
   d_step + g_step at ReZero gates 0.1 (D's and G's), a leaf passing
   within ``GRAD_TOL`` of its scale or within ``REF_HOST_FACTOR`` times
   the host fp32's error on it (the larger of two host samples: on the
   inputs, and on the inputs at another fp32 rounding), every side given
   the same reals and G's images from the host's float64 path in the
   reals' range; the R1 penalty's own gradient, with and without
   ``d_attention``, held the same way, every card side through the
   kernels; each R1 check again with one adjoint launch of the image
   gradient outside its Function (its second order silently lost), which
   the rule must reject where R1 is not a negligible part of the
   gradient; then path length: the penalty's gradient (G's second order)
   and one g_step_pl (G's leaves), the same rule, batch 2 (the penalty on
   1), each again with the first ``ModconvGradsFunction`` run bare (its
   second order lost), which the rule must reject;
9. the tick loop (``loop_phase``): it requires the port's native host
   ops to load (CRC32C, the TFRecord scan and parse, built by g++) and
   prints their build, writes 256 procedural 256^2 images as TFRecords
   with the port's writer, then runs ffhq256-duplex as the preset has it
   (batch 32, bf16, R1 gamma 10 every 16 iterations, path length every
   4) from those records with 1-kimg ticks and a snapshot and a
   checkpoint every tick: run B, a process of the train CLI armed with
   ``GANSFORMER_TPU_FAULTS=sigterm@tick:tick=0``, must exit with
   EXIT_PREEMPTED after its tick-0 checkpoint; that checkpoint restores
   on the card bit-equal to the file and a synchronous save of it writes
   the same leaves; run C, the CLI's ``--resume`` in this process with
   the counters reset just before and read just after and
   ``--fused-cycle`` (JAX's key, taken and said in ``log.txt``), must
   resume at B's step and data position and run to 2 kimg, its launches
   (with lse, second order, by route) equal to the plans' counts times
   its iterations of each step kind plus its snapshots, every stat of
   every tick finite, its phases summing to the tick, and every
   ``fakes*.png`` decoding (zlib) to the grid's shape; run D, 4
   iterations resumed from C (with R1 and path length), counts the host
   syncs (``torch.cuda.set_sync_debug_mode``) by the loop's span.  It
   prints sec_per_tick, img_per_sec, data_wait_frac, the phases' self
   times with ``timing/phase/h2d``, the checkpoints' times and size and
   the run's peak device memory;
10. one lazy-reg cycle (``sync_phase``): the loop's steps over the 16
   iterations of one cycle of the preset from a fresh state, on batches
   of the TFRecords, under ``torch.cuda.set_sync_debug_mode("error")``
   (a host sync fails it; a planted ``.item()`` must), launches held to
   the plan; ``prepare_data --synthetic --to tfrecord`` at 256^2 read
   back image for image; ``generate --run-dir`` on the loop's run in
   each of
   ``GENERATE_MODES``, launches held to the plan of its synthesize
   calls, every PNG decoded (zlib) to its size;
11. metrics and evaluation (``metrics_phase``) on the loop's run dir:
   ``cli/evaluate.py --metrics fid1k,is1k,pr1k,ppl1k --batch-size 32``
   with the uncalibrated extractor and the TF32 flags at torch's
   defaults, its launches of kernels 1-4 held to the plan (one synthesize
   per fake batch, two per PPL batch), its files and JSON line checked;
   the card's Inception features of 8 sweep images held to the host's
   (fp32) within ``FEATURE_TOL`` of their largest magnitude, an average
   pool that counts its padding planted and rejected; FID, IS and P&R of
   the card's features of 32 fakes and 32 reals held to the host's; the
   PPL control (z0 == z1: 0 with shared noise, or within ``PPL_CONTROL``
   of the median distance; the median's order with unshared noise); and
   the loop's in-loop metric hook once (one tick, ``metric_ticks`` 1,
   fid256: ``metric-fid256_uncal.txt`` and ``flag-calibrated.txt``);
12. prints the kernels' JSON line, then ``{"ok": true, "device": ...}``.
   Every number of a kernel in the JSON line covers that kernel's
   ``span``: the serve run's launches for the forward kernels (and, in a
   second entry with ``"lse": true``, the forward attention launches of
   one d_step + one g_step that write lse), one d_step + one g_step for
   the backward kernels, one d_step_r1 (a third entry per kernel it
   launches: every launch of the step, the second order's included) and
   one g_step_pl (a fourth, likewise).

Exits non-zero, printing no result, on any failure, without CUDA, or
without the ``gansformer_tpu_torch`` package beside it.
"""

from __future__ import annotations

import dataclasses
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
    "modconv_dx": "gansformer_tpu/ops/pallas_modconv.py:424",
    "modconv_dw": "gansformer_tpu/ops/pallas_modconv.py:472",
    "upfirdn_adjoint": "gansformer_tpu/ops/pallas_upfirdn.py:423",
    "grid_to_latent_bwd": "gansformer_tpu/ops/pallas_attention.py:253",
    "latent_to_grid_bwd": "gansformer_tpu/ops/pallas_attention.py:450",
}
SOURCES = {
    "modconv": "gansformer_tpu_torch/csrc/modconv.cu",
    "upfirdn": "gansformer_tpu_torch/csrc/upfirdn.cu",
    "grid_to_latent": "gansformer_tpu_torch/csrc/attention.cu",
    "latent_to_grid": "gansformer_tpu_torch/csrc/attention.cu",
    "modconv_dx": "gansformer_tpu_torch/csrc/modconv_bwd.cu",
    "modconv_dw": "gansformer_tpu_torch/csrc/modconv_bwd.cu",
    "upfirdn_adjoint": "gansformer_tpu_torch/csrc/upfirdn.cu",
    "grid_to_latent_bwd": "gansformer_tpu_torch/csrc/attention_bwd.cu",
    "latent_to_grid_bwd": "gansformer_tpu_torch/csrc/attention_bwd.cu",
}
SERVE_KERNELS = ("modconv", "upfirdn", "grid_to_latent", "latent_to_grid")
TRAIN_KERNELS = ("modconv_dx", "modconv_dw", "upfirdn_adjoint",
                 "grid_to_latent_bwd", "latent_to_grid_bwd")
ATTENTION_KERNELS = ("grid_to_latent", "latent_to_grid")
# Kernel-vs-plain tolerance on max |err|, relative to max |plain| of the
# same launch and output (no floor).  "out": outputs in the compute dtype:
# fp32 differs only by summation order over <= 4608 terms; bf16 outputs
# are rounded to 8 mantissa bits in both versions (2^-8 of the largest
# value is 0.4 %), and latent_to_grid keeps fp32 probabilities where the
# plain version casts them to bf16.  "acc": the fp32 outputs of the
# backward (ds, dw), whose kernels and plain versions form the same
# products (bf16 x bf16 is exact in fp32, the demod is folded and rounded
# at the same place) and differ only in the order of fp32 sums over up to
# 8 * 65536 terms, tensor-core accumulation included.  "stat": the
# attention forward's fp32 row statistic lse, computed in fp32 from the
# same inputs on both sides whatever the storage dtype, so it takes the
# fp32 tolerance in bf16 too.  The attention backward's dq, dk, dv are
# "out": fp32 inside, rounded to the dtype once at the end on both sides.
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
ACC_TOL = {"float32": 1e-4, "bfloat16": 1e-3}
STAT_TOL = {"float32": 1e-4, "bfloat16": 1e-4}
TOLS = {"out": KERNEL_TOL, "acc": ACC_TOL, "stat": STAT_TOL}
# The serve run's buckets: one synthesize at each batch size.
BUCKETS = (1, 2, 4, 8)
TRAIN_BATCH = 8
# Whole-generator tolerance (max |err| relative to max |host plain fp32|):
# fp32 accumulates summation-order differences over ~40 layers; bf16
# rounds every layer's activations (2^-8 relative) on top.
MODEL_TOL = {"float32": 2e-3, "bfloat16": 1e-1}
# Card-vs-host gradients, fp32, per leaf relative to the leaf's max |ref|
# (TF32 off on both sides): summation-order differences of ~1e-5 in the
# upstream gradients, through ~40 layers of G and ~20 of D, are amplified
# where a leaf's gradient is a sum of mixed-sign terms over batch and
# pixels (the style affines' biases); an H100 gave up to 1.952e-3 there.
# A kernel fault (a dropped tile, sample or tap; a wrong flip) moves a
# leaf by tens of percent.  The attention's key biases have an exact
# gradient of zero (``_key_bias``) and are held at their weight's scale.
GRAD_TOL = 1e-2
# Published dense peaks by card (bytes/s, bf16 tensor flop/s, fp32 flop/s).
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100 NVL": (3.9e12, 835e12, 60e12),
    "H100": (3.35e12, 989e12, 67e12),          # SXM
    "H200": (4.8e12, 989e12, 67e12),
}
# An asymmetric filter for the adjoint's flip control.
RAMP = (1, 2, 3, 4)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    return PEAKS["H100"]


# --------------------------------------------------------------------------
# The kernel launches of the main paths, and their cases
# --------------------------------------------------------------------------


def main_path_calls(cfg, batch: int, lse: bool = False):
    """Every kernel launch of one ``synthesize`` at ``cfg``, in order; the
    attention launches write ``lse`` when a graph is wanted (``lse``)."""
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
                        Dv=cfg.w_dim // cfg.num_heads, lse=lse))
            calls.append(dict(
                kernel="grid_to_latent" if n >= k else "latent_to_grid",
                label=f"b{res} main", B=batch * cfg.num_heads, Lq=n, Lk=k,
                D=nf // cfg.num_heads, Dv=nf // cfg.num_heads, lse=lse))
        calls.append(dict(kernel="modconv", label=f"b{res}_trgb same1",
                          kind="same1", B=batch, H=res, Ci=nf,
                          Co=cfg.img_channels, act="linear"))
        if res > 4:
            calls.append(dict(kernel="upfirdn", label=f"b{res} skip up",
                              B=batch, H=res // 2, C=cfg.img_channels, up=2,
                              pads=(2, 1, 2, 1)))
        cin = nf
    return calls


def d_forward_calls(cfg, batch: int, tag: str):
    """The kernel launches of one discriminator forward: per residual
    block, with ``d_attention`` and the block in the attention window,
    the duplex attention's two launches (the d_components queries over
    the grid, then the grid over the queries; both write ``lse``, since
    D's parameters always want a graph), then the blur-pool before the
    stride-2 3x3 conv (pad 2, output r + 1) and the decimated 1x1 skip
    (down 2, pad 1)."""
    calls = []
    cin = cfg.nf(cfg.resolution)
    k, h = cfg.d_components, cfg.num_heads
    for res in reversed(cfg.block_resolutions[1:]):
        if cfg.d_attention and cfg.attn_start_res <= res <= cfg.attn_max_res:
            n = res * res
            calls.append(dict(
                kernel="grid_to_latent" if k >= n else "latent_to_grid",
                label=f"D{tag} b{res} centroid", B=batch * h, Lq=k, Lk=n,
                D=cin // h, Dv=cfg.w_dim // h, lse=True))
            calls.append(dict(
                kernel="grid_to_latent" if n >= k else "latent_to_grid",
                label=f"D{tag} b{res} main", B=batch * h, Lq=n, Lk=k,
                D=cin // h, Dv=cin // h, lse=True))
        calls.append(dict(kernel="upfirdn", label=f"D{tag} b{res} blur-pool",
                          B=batch, H=res, C=cin, up=1, down=1,
                          pads=(2, 2, 2, 2), gain=1.0))
        calls.append(dict(kernel="upfirdn", label=f"D{tag} b{res} skip down",
                          B=batch, H=res, C=cin, up=1, down=2,
                          pads=(1, 1, 1, 1), gain=1.0))
        cin = cfg.nf(res // 2)
    return calls


def backward_calls(fwd):
    """The backward launches of forward launches ``fwd`` (whose inputs all
    require grad), in reverse order."""
    calls = []
    for c in reversed(fwd):
        if c["kernel"] == "upfirdn":
            calls.append(dict(c, kernel="upfirdn_adjoint",
                              label=c["label"] + " adjoint"))
        elif c["kernel"] == "modconv":
            calls.append(dict(c, kernel="modconv_dx",
                              label=c["label"] + " dx/ds"))
            calls.append(dict(c, kernel="modconv_dw",
                              label=c["label"] + " dw"))
        elif c["kernel"] in ATTENTION_KERNELS:
            calls.append(dict(c, kernel=c["kernel"] + "_bwd", lse=False,
                              label=c["label"] + " backward"))
    return calls


def train_path_calls(cfg, batch: int):
    """Every kernel launch of one d_step and one g_step at ``cfg``, forward
    and backward, each tagged with its ``phase``.  d_step: G's forward
    under no_grad (its attention launches write no ``lse``), D on reals
    and on fakes, D's backward through both.  g_step: G's forward (its
    attention launches write ``lse``), D on the fakes, the backward
    through D's activations and all of G."""
    g_fwd = main_path_calls(cfg, batch, lse=True)
    d_real, d_fake = d_forward_calls(cfg, batch, "r"), \
        d_forward_calls(cfg, batch, "f")
    d_step = main_path_calls(cfg, batch) + d_real + d_fake \
        + backward_calls(d_fake) + backward_calls(d_real)
    g_step = g_fwd + d_fake + backward_calls(g_fwd + d_fake)
    return ([dict(c, phase="d_step") for c in d_step]
            + [dict(c, phase="g_step") for c in g_step])


def r1_step_calls(cfg, batch: int, shrink: int = 1):
    """Every kernel launch of one d_step_r1 at ``cfg``, tagged with its
    phase: G's forward under no_grad; D on the reals, on the fakes and on
    the R1 slice (the first ``batch // shrink`` reals); the R1 slice's
    image gradient, whose graph is kept (its adjoint and attention
    backward launches); then the backward of the loss: the backward
    launches of all three D graphs (the R1 graph's forward is reached
    through D's nonlinear backward ops, the stddev and the attention) and,
    for each upfirdn launch of the R1 graph, kernel 2 at its own geometry
    as the adjoint's adjoint (``second order`` in the label).  The
    attention's second order launches nothing (torch ops); its passes
    are counted by ``plan_second_order_counts``."""
    d_real, d_fake = d_forward_calls(cfg, batch, "r"), \
        d_forward_calls(cfg, batch, "f")
    d_r1 = d_forward_calls(cfg, batch // shrink, "r1")
    image_grad = [dict(c, label=c["label"] + " (image gradient)")
                  for c in backward_calls(d_r1)]
    second = [dict(c, label=c["label"] + " second order") for c in d_r1
              if c["kernel"] == "upfirdn"]
    calls = (main_path_calls(cfg, batch) + d_real + d_fake + d_r1
             + image_grad + backward_calls(d_fake) + backward_calls(d_real)
             + backward_calls(d_r1) + second)
    return [dict(c, phase="d_step_r1") for c in calls]


def plan_second_order_counts(cfg, batch: int, shrink: int = 1):
    """``ops.second_order_counts`` of one d_step_r1: one pass per upfirdn
    and per attention launch of D's forward on the R1 slice (G runs under
    no_grad: no modconv second order)."""
    d_r1 = d_forward_calls(cfg, batch // shrink, "r1")
    return {"modconv_second_order": 0,
            **{f"{k}_second_order": sum(c["kernel"] == k for c in d_r1)
               for k in ("upfirdn",) + ATTENTION_KERNELS}}


def _pl_linear_tail(call) -> bool:
    """A launch of G's forward that path length's penalty reaches only
    linearly: the tRGB convs and the skip upsampling carry the projection
    noise to the images unchanged, so their cotangents in the penalty's
    gradient are constants and no first-backward op saves their
    outputs."""
    return call["label"].endswith(("_trgb same1", " skip up"))


def pl_step_calls(cfg, batch: int, shrink: int = 2):
    """Every kernel launch of one g_step_pl at ``cfg``, tagged with its
    phase: the g_step's (``train_path_calls``), then path length on
    ``batch // shrink`` fresh latents: G's forward (its attention
    launches write lse); the gradient of the noise projection wrt ws
    with its graph kept (every backward launch of that forward: a
    Function's backward computes the gradient of every input it was
    built with, so the modconv dw launches too, though ws needs none);
    the second order through that gradient: per modconv launch kernels
    1, 5 and 6 (the tRGB's without kernel 1, its cotangent being the
    projection noise carried linearly) and per blur upfirdn launch
    kernel 2 as the adjoint's adjoint (the skip upsampling's adjoint
    takes a constant cotangent: no graph); then the backward of the
    forward launches whose outputs the gradient's graph saved (all but
    ``_pl_linear_tail``).  The attention's second order launches
    nothing (torch ops); ``plan_pl_second_order_counts`` counts it."""
    g_step = [c for c in train_path_calls(cfg, batch)
              if c["phase"] == "g_step"]
    fwd = main_path_calls(cfg, batch // shrink, lse=True)
    grad = [dict(c, label=c["label"] + " (path-length gradient)")
            for c in backward_calls(fwd)]
    second = []
    for c in fwd:
        tag = dict(label=c["label"] + " second order")
        if c["kernel"] == "modconv":
            if not _pl_linear_tail(c):
                second.append(dict(c, **tag))
            second += [dict(c, kernel="modconv_dx", **tag),
                       dict(c, kernel="modconv_dw", **tag)]
        elif c["kernel"] == "upfirdn" and not _pl_linear_tail(c):
            second.append(dict(c, **tag))
    outer = backward_calls([c for c in fwd if not _pl_linear_tail(c)])
    return [dict(c, phase="g_step_pl")
            for c in g_step + fwd + grad + second + outer]


def plan_pl_second_order_counts(cfg, batch: int, shrink: int = 2):
    """``ops.second_order_counts`` of one g_step_pl: the modconv and
    upfirdn launches ``pl_step_calls`` labels second order, and one
    torch-op pass per attention launch of the path-length forward."""
    calls = pl_step_calls(cfg, batch, shrink)
    second = [c for c in calls if c["label"].endswith(" second order")]
    fwd = main_path_calls(cfg, batch // shrink, lse=True)
    return {"modconv_second_order": sum(c["kernel"].startswith("modconv")
                                        for c in second),
            "upfirdn_second_order": sum(c["kernel"] == "upfirdn"
                                        for c in second),
            **{f"{k}_second_order": sum(c["kernel"] == k for c in fwd)
               for k in ATTENTION_KERNELS}}


def loop_step_kinds(train, first_it: int, iterations: int):
    """How many of each step the tick loop runs over ``iterations``
    iterations from ``first_it``: ``d_step_r1`` where ``it %
    d_reg_interval == 0``, else ``d_step``; ``g_step_pl`` where ``it %
    g_reg_interval == 0``, else ``g_step``."""
    kinds = dict.fromkeys(("d_step", "d_step_r1", "g_step", "g_step_pl"), 0)
    for it in range(first_it, first_it + iterations):
        kinds["d_step_r1" if it % train.d_reg_interval == 0
              else "d_step"] += 1
        kinds["g_step_pl" if it % train.g_reg_interval == 0
              else "g_step"] += 1
    return kinds


def loop_parts(cfg, train, grid_n: int):
    """{phase: its launches} of the steps the loop runs and of one image
    snapshot (the EMA generator's forward at the grid's batch under
    no_grad: ``main_path_calls``)."""
    batch = train.batch_size
    tcalls = train_path_calls(cfg, batch)
    return {
        "d_step": [c for c in tcalls if c["phase"] == "d_step"],
        "g_step": [c for c in tcalls if c["phase"] == "g_step"],
        "d_step_r1": r1_step_calls(cfg, batch, train.r1_batch_shrink),
        "g_step_pl": pl_step_calls(cfg, batch, train.pl_batch_shrink),
        "snapshot": [dict(c, phase="snapshot")
                     for c in main_path_calls(cfg, grid_n)]}


def loop_plan(cfg, train, kinds, snapshots: int, grid_n: int,
              dtype_name=None):
    """The counters of a loop run of ``kinds`` steps (``loop_step_kinds``)
    and ``snapshots`` image snapshots: (launches, launches with lse,
    second-order passes, launches by route in ``dtype_name`` or None)."""
    parts = loop_parts(cfg, train, grid_n)
    times = dict(kinds, snapshot=snapshots)
    launches = dict.fromkeys(REPLACES, 0)
    lse = dict.fromkeys(ATTENTION_KERNELS, 0)
    second = {f"{k}_second_order": 0
              for k in ("modconv", "upfirdn") + ATTENTION_KERNELS}
    paths = None
    per_second = {
        "d_step_r1": plan_second_order_counts(cfg, train.batch_size,
                                              train.r1_batch_shrink),
        "g_step_pl": plan_pl_second_order_counts(cfg, train.batch_size,
                                                 train.pl_batch_shrink)}
    for phase, calls in parts.items():
        n = times[phase]
        for k, v in plan_counts(calls, phase).items():
            launches[k] += n * v
        for k, v in plan_lse_counts(calls, phase).items():
            lse[k] += n * v
        for k, v in per_second.get(phase, {}).items():
            second[k] += n * v
        if dtype_name is not None:
            got = plan_path_counts(calls, dtype_name)
            paths = {k: (paths or {}).get(k, 0) + n * v
                     for k, v in got.items()}
    return launches, lse, second, paths


def attention_cost(call, itemsize: int):
    """(bytes, operations) of one attention launch in a dtype of
    ``itemsize`` bytes, each input read once and each output written
    once.  Forward: q, k, v read, o written (+ the fp32 lse when written);
    2 Lq Lk (D + Dv) operations.  Backward: q, k, v, do read
    (latent_to_grid also reads its fp32 lse and delta; grid_to_latent
    rebuilds each row's lse from its own logits), dq, dk, dv written; the
    five products of a flash-attention backward (S recomputed, dV, dP,
    dQ, dK), 2 Lq Lk (3 D + 2 Dv) operations."""
    b, lq, lk, d, dv = call["B"], call["Lq"], call["Lk"], call["D"], \
        call["Dv"]
    if call["kernel"] in ATTENTION_KERNELS:
        nbytes = (b * lq * d + b * lk * d + b * lk * dv + b * lq * dv) \
            * itemsize + (4 * b * lq if call.get("lse") else 0)
        return nbytes, 2.0 * b * lq * lk * (d + dv)
    stats = 2 if call["kernel"] == "latent_to_grid_bwd" else 0
    nbytes = (2 * (b * lq * d + b * lk * d + b * lk * dv) + b * lq * dv) \
        * itemsize + 4 * b * lq * stats
    return nbytes, 2.0 * b * lq * lk * (3 * d + 2 * dv)


def attention_backward_bounds(cfg, batch: int, peaks, itemsize: int = 2):
    """Launches per g_step and bound (ms) of the two attention backward
    kernels (PERF.md section 6, rows 8 and 9) at the attention launches
    of one synthesize of ``cfg``: each forward launch has one backward
    launch; bytes and operations by ``attention_cost``."""
    out = {}
    for c in backward_calls(main_path_calls(cfg, batch, lse=True)):
        if c["kernel"] not in ("grid_to_latent_bwd", "latent_to_grid_bwd"):
            continue
        nbytes, ops = attention_cost(c, itemsize)
        row = out.setdefault(c["kernel"], dict(launches=0, bound_ms=0.0,
                                               bytes_ms=0.0, ops_ms=0.0))
        row["launches"] += 1
        row["bytes_ms"] += nbytes / peaks[0] * 1e3
        row["ops_ms"] += ops / peaks[1] * 1e3
        row["bound_ms"] += max(nbytes / peaks[0], ops / peaks[1]) * 1e3
    return out


def plan_counts(calls, phase):
    return {k: sum(c["kernel"] == k and c["phase"] == phase for c in calls)
            for k in REPLACES}


def plan_lse_counts(calls, phase):
    """Of the plan's forward attention launches in ``phase``, those that
    write ``lse``."""
    return {k: sum(c["kernel"] == k and c["phase"] == phase
                   and bool(c.get("lse")) for c in calls)
            for k in ATTENTION_KERNELS}


def plan_path_counts(calls, dtype_name):
    """Of the plan's upfirdn launches (forward and adjoint),
    grid->latent launches and latent->grid launches (forward and
    backward each), how many each route takes in ``dtype_name`` (the keys
    of ``ops.path_launch_counts``)."""
    import torch

    from gansformer_tpu_torch.ops import cuda_attention, cuda_upfirdn

    dtype = getattr(torch, dtype_name)
    out = {f"upfirdn_{n}": 0 for n in cuda_upfirdn.PATH_NAMES.values()}
    for kname in ("grid_to_latent", "grid_to_latent_bwd"):
        out.update({f"{kname}_{n}": 0
                    for n in cuda_attention.G2L_NAMES.values()})
    for kname in ("latent_to_grid", "latent_to_grid_bwd"):
        out.update({f"{kname}_{n}": 0
                    for n in cuda_attention.L2G_NAMES.values()})
    for c in calls:
        if c["kernel"] in ("latent_to_grid", "latent_to_grid_bwd"):
            path = l2g_call_plan(c, dtype)[0]
            out[f"{c['kernel']}_{cuda_attention.L2G_NAMES[path]}"] += 1
            continue
        if c["kernel"] == "grid_to_latent_bwd":
            path = g2l_bwd_call_plan(c, dtype)[0]
            out[f"grid_to_latent_bwd_{cuda_attention.G2L_NAMES[path]}"] += 1
            continue
        if c["kernel"] in ("upfirdn", "upfirdn_adjoint"):
            up, down = c["up"], c.get("down", 1)
            if c["kernel"] == "upfirdn_adjoint":
                up, down = down, up
            path = cuda_upfirdn.ufd_path(dtype, c["C"], up, down, 4, 4)
            out[f"upfirdn_{cuda_upfirdn.PATH_NAMES[path]}"] += 1
        elif c["kernel"] == "grid_to_latent":
            path = cuda_attention.g2l_path(dtype, c["Lk"], c["D"], c["Dv"])
            out[f"grid_to_latent_{cuda_attention.G2L_NAMES[path]}"] += 1
    return out


def l2g_call_plan(call, dtype):
    """The wrapper's plan (``cuda_attention.l2g_plan``) of a latent->grid
    launch, forward or backward."""
    from gansformer_tpu_torch.ops import cuda_attention

    return cuda_attention.l2g_plan(dtype, call["B"], call["Lk"], call["Lq"],
                                   call["D"], call["Dv"],
                                   bwd=call["kernel"] == "latent_to_grid_bwd")


def g2l_bwd_call_plan(call, dtype):
    """The wrapper's plan (``cuda_attention.g2l_bwd_plan``) of a
    grid->latent backward launch."""
    from gansformer_tpu_torch.ops import cuda_attention

    return cuda_attention.g2l_bwd_plan(dtype, call["B"], call["Lq"],
                                       call["Lk"], call["D"], call["Dv"])


def check_path_counts(got, calls, dtype_name, what):
    """The routes the run's upfirdn and grid->latent launches took, held
    to the plan's; no preset launch may take upfirdn's general route."""
    want = plan_path_counts(calls, dtype_name)
    if got != want:
        fail(f"{what}: launches by route {got} != the plan's {want}")
    if got["upfirdn_general"]:
        fail(f"{what}: {got['upfirdn_general']} upfirdn launches took the "
             f"general route")


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


def library_conv_grad(x, w, du, kind, which):
    """One library call (cuDNN through ``convolution_backward``, as
    ``torch.nn.grad.conv2d_input``/``conv2d_weight`` do) computing the
    input (``which='dx'``) or weight (``'dw'``) gradient of the plain
    conv at these shapes, s = d = 1: the yardstick of the backward
    kernels, never called by the port."""
    import torch

    xc = x.permute(0, 3, 1, 2)
    dc = du.permute(0, 3, 1, 2)
    mask = [which == "dx", which == "dw", False]
    if kind == "poly":
        wt = torch.flip(w, (0, 1)).permute(2, 3, 0, 1).contiguous(
            memory_format=torch.channels_last)
        geo = ([2, 2], [1, 1], [1, 1], True, [1, 1])
    else:
        wt = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        p = w.shape[0] // 2
        geo = ([1, 1], [p, p], [1, 1], False, [0, 0])
    stride, pad, dil, transposed, opad = geo
    return lambda: torch.ops.aten.convolution_backward(
        dc, xc, wt, None, stride, pad, dil, transposed, opad, 1, mask)


def library_upfirdn(x, f, up, pads, down=1, bias=None, act=None,
                    gain=1.0):
    """One library call computing upfirdn2d for the path's cases: a
    (decimating) blur on the pre-padded input (up = 1), and the zero-insert
    upsample by 2 with pads (2, 1) (G's skip upsample, D's skip adjoint);
    with ``act`` the epilogue lrelu(y + bias) * gain follows in torch."""
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
        conv = lambda: F.conv2d(xp, kf, stride=down, groups=c)  # noqa: E731
    else:
        assert up == 2 and down == 1 and pads == (2, 1, 2, 1) \
            and k.shape == (4, 4)
        kt = k[None, None].expand(c, 1, 4, 4).contiguous()
        conv = lambda: F.conv_transpose2d(  # noqa: E731
            xc, kt, stride=2, padding=1, groups=c)
    if act is None:
        return conv
    b = bias.to(x.dtype)[None, :, None, None]
    return lambda: F.leaky_relu(conv() + b, 0.2) * gain


def library_attention(q, k, v):
    """One library call: scaled_dot_product_attention, one head."""
    import torch.nn.functional as F

    return lambda: F.scaled_dot_product_attention(q[:, None], k[:, None],
                                                  v[:, None])[:, 0]


def library_attention_bwd(q, k, v, do):
    """The backward alone of scaled_dot_product_attention on one head: the
    graph is built here, the call is ``torch.autograd.grad`` with
    ``retain_graph``.  Returns (call, backend): the backend that PyTorch
    picked (flash, efficient, cudnn or math), read from the graph."""
    import torch
    import torch.nn.functional as F

    qg, kg, vg = (t.detach()[:, None].requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg)
    node = type(out.grad_fn).__name__
    backend = next((name for key, name in (("Flash", "flash"),
                                           ("Efficient", "efficient"),
                                           ("Cudnn", "cudnn"))
                    if key in node), "math")
    ct = do[:, None]
    return (lambda: tuple(g[:, 0] for g in torch.autograd.grad(
        out, (qg, kg, vg), ct, retain_graph=True))), backend


def _modconv_inputs(call, dtype, randn):
    """x, w, s, d, the cotangent ``du`` of the core's output, and what the
    backward kernels take (du4, pre, wT) for one modconv launch."""
    from gansformer_tpu_torch.ops import modulated_conv as mc

    kind, b, h, ci, co = (call["kind"], call["B"], call["H"], call["Ci"],
                          call["Co"])
    ks = 1 if kind == "same1" else 3
    up = 2 if kind == "poly" else 1
    x = randn(b, h, h, ci).to(dtype)
    w = (randn(ks, ks, ci, co) / math.sqrt(ci * ks * ks)).to(dtype)
    s = randn(b, ci) * 0.2 + 1.0
    d = (mc._demod_coeffs(w.float(), s, 1e-8) if kind != "same1"
         else randn(b, co) * 0.2 + 1.0)
    du = randn(b, up * h, up * h, co).to(dtype)
    du4 = (mc._space_to_depth(du) if kind == "poly" else du).contiguous()
    _, _, wT = mc._prep_adjoint(kind, w)
    return dict(x=x, w=w, s=s, d=d, du=du, du4=du4, pre=mc._post(kind, d),
                wT=wT, ks=ks, up=up)


def build_case(call, dtype, gen, dev="cuda", chunk=None):
    """One launch on inputs made on ``dev`` from ``gen``: a dict of the
    kernel, plain and library calls (a tensor or a tuple of tensors
    each), ``outputs`` (the tolerance class of each output), the bytes and
    operations the bound counts, and ``controls``: planted faults, each a
    dict with ``desc``, the output index ``out`` it perturbs and ``fault``
    (what a broken kernel would give), and optionally its own ``kernel``
    and ``plain`` (a control on other inputs of the same launch).
    latent_to_grid's faults, forward and backward, drop keys at each level
    of the route's reduction (``l2g_key_drops``: a span and a tile on the
    tensor cores, a ``chunk``-key chunk on the CUDA cores), and
    grid_to_latent's backward drops rows at each level of its sums of dk
    and dv (``g2l_bwd_row_drops``).  The attention backward's case also
    names the SDPA backend of its library call (``library_backend``)."""
    import numpy as np
    import torch

    from gansformer_tpu_torch.ops import cuda_modconv, cuda_upfirdn
    from gansformer_tpu_torch.ops import modulated_conv as mc
    from gansformer_tpu_torch.ops.upfirdn2d import (adjoint_geometry,
                                                    out_hw, setup_filter,
                                                    upfirdn2d_adjoint_plain,
                                                    upfirdn2d_plain)

    it = torch.tensor([], dtype=dtype).element_size()

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    kname = call["kernel"]
    if kname == "modconv":
        kind, b, h, ci, co = (call["kind"], call["B"], call["H"], call["Ci"],
                              call["Co"])
        ks = 1 if kind == "same1" else 3
        x = randn(b, h, h, ci).to(dtype)
        w = (randn(ks, ks, ci, co) / math.sqrt(ci * ks * ks)).to(dtype)
        s = randn(b, ci) * 0.2 + 1.0
        d = (mc._demod_coeffs(w.float(), s, 1e-8) if kind != "same1"
             else torch.ones(b, co, device=dev))
        post = d.repeat_interleave(4, dim=1) if kind == "poly" else d
        ws = mc.stack_weights(kind, w)
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
                    plain=lambda: mc.modconv_plain(*args),
                    library=library_modconv(xs, w, kind), bytes=nbytes,
                    ops=ops, outputs=("out",),
                    controls=_modconv_controls(call, dtype, args, dev))
    if kname in ("modconv_dx", "modconv_dw"):
        m = _modconv_inputs(call, dtype, randn)
        b, h, ci, co = call["B"], call["H"], call["Ci"], call["Co"]
        ops = 2.0 * b * h * h * m["ks"] ** 2 * ci * co     # the forward's
        sd_bytes = (m["s"].numel() + m["pre"].numel()) * 4
        if kname == "modconv_dx":
            taps = mc.adjoint_taps(call["kind"])
            args = (m["du4"], m["wT"], m["pre"], m["s"], m["x"], taps)
            # du, w and x read once; dx in the dtype and ds in fp32 written
            nbytes = ((m["du"].numel() + m["w"].numel() + 2 * m["x"].numel())
                      * it + sd_bytes + b * ci * 4)
            path = cuda_modconv.bwd_path("dx", dtype, m["du4"].shape[3], ci,
                                         h, taps)
            tile = (cuda_modconv.dx_tile_pixels(path) if dev == "cuda"
                    else cuda_modconv.TILE_PIXELS[path])

            def drop_tile():
                u = mc.adjoint_u_plain(m["du4"], m["wT"], m["pre"], taps)
                xu = (m["x"].float() * u).reshape(b, h * h, ci)
                t0 = ((h * h // tile) // 2) * tile          # the middle tile
                return xu.sum(1) - xu[:, t0:t0 + tile].sum(1)

            return dict(
                kernel=lambda: cuda_modconv.modconv_dx_cuda(*args),
                plain=lambda: mc.modconv_dx_plain(*args),
                library=library_conv_grad(m["x"], m["w"], m["du"],
                                          call["kind"], "dx"),
                bytes=nbytes, ops=ops, outputs=("out", "acc"),
                controls=[dict(desc="ds without one tile's partial", out=1,
                               fault=drop_tile)])
        taps = cuda_modconv.TAPS[call["kind"]]
        args = (m["x"], m["du4"], m["s"], m["pre"], taps)
        nbytes = ((m["du"].numel() + m["x"].numel()) * it + sd_bytes
                  + m["wT"].numel() * 4)

        def drop_sample():
            per = mc.modconv_dw_per_sample(*args)
            n0 = b // 2
            return per.sum(0) - per[n0]

        return dict(
            kernel=lambda: cuda_modconv.modconv_dw_cuda(*args),
            plain=lambda: mc.modconv_dw_plain(*args),
            library=library_conv_grad(m["x"], m["w"], m["du"], call["kind"],
                                      "dw"),
            bytes=nbytes, ops=ops, outputs=("acc",),
            controls=[dict(desc="dw without one sample's term", out=0,
                           fault=drop_sample)])
    if kname in ("upfirdn", "upfirdn_adjoint"):
        b, h, c, up, pads = (call["B"], call["H"], call["C"], call["up"],
                             call["pads"])
        down = call.get("down", 1)
        f = setup_filter(call.get("taps", (1, 3, 3, 1)),
                         gain=call.get("gain", 4.0))
        fh, fw = f.shape
        if kname == "upfirdn":
            x = randn(b, h, h, c).to(dtype)
            act = call.get("act")
            bias = randn(c) * 0.5 if act else None
            gain = math.sqrt(2.0) if act else 1.0

            def forward(filt):
                args = (x, filt, up, down, pads, bias, act, 0.2, gain)
                return (lambda: cuda_upfirdn.upfirdn2d_cuda(*args),
                        lambda: upfirdn2d_plain(*args))

            oh = out_hw(h, h, fh, fw, up, down, pads)[0]
            kern, plain = forward(f)
            lib = library_upfirdn(x, f, up, pads, down, bias, act, gain)
            no_tap = f.copy()
            no_tap[fh // 2 - 1, fw // 2 - 1] = 0.0
            ramp = setup_filter(RAMP, gain=call.get("gain", 4.0))
            rk, rp = forward(ramp)
            controls = [
                dict(desc=f"tap ({fh // 2 - 1}, {fw // 2 - 1}) dropped",
                     out=0, fault=forward(no_tap)[1]),
                dict(desc="ramp filter not flipped", out=0,
                     fault=forward(np.ascontiguousarray(ramp[::-1, ::-1]))[1],
                     kernel=rk, plain=rp)]
            in_elems, out_elems, eff_up = x.numel(), b * oh * oh * c, up
        else:
            oh = out_hw(h, h, fh, fw, up, down, pads)[0]
            ct = randn(b, oh, oh, c).to(dtype)

            def adjoint(filt, flip=True):
                fa, ua, da, gp = adjoint_geometry(h, h, filt, up, down, pads,
                                                  flip)
                return (lambda: cuda_upfirdn.upfirdn2d_adjoint_cuda(
                    ct, fa, ua, da, gp),
                    lambda: upfirdn2d_adjoint_plain(ct, filt, up, down, pads,
                                                    (h, h), flip),
                    library_upfirdn(ct, fa, ua, gp, da))

            kern, plain, lib = adjoint(f)
            ramp = setup_filter(RAMP)
            rk, rp, _ = adjoint(ramp)
            controls = [
                dict(desc="adjoint with the filter not flipped", out=0,
                     fault=adjoint(f, flip=False)[1]),
                dict(desc="adjoint with the ramp filter not flipped", out=0,
                     fault=adjoint(ramp, flip=False)[1], kernel=rk,
                     plain=rp)]
            in_elems, out_elems, eff_up = ct.numel(), b * h * h * c, down
        nbytes = (in_elems + out_elems) * it + (4 * c if call.get("act")
                                                else 0)
        ops = 2.0 * out_elems * f.size / (eff_up * eff_up)
        return dict(kernel=kern, plain=plain, library=lib, bytes=nbytes,
                    ops=ops, outputs=("out",), controls=controls)
    return _attention_case(call, dtype, randn, dev, chunk)


def fwd_plan(call, dtype, dev="cuda"):
    """(path, P) of the forward launch ``call``: the wrapper's path and
    split (on the host, split as for a card of 132 SMs)."""
    import torch

    from gansformer_tpu_torch.ops import cuda_modconv

    kind, phases = call["kind"], cuda_modconv.PHASES[call["kind"]]
    cok = call["Co"] * phases
    taps = cuda_modconv.TAPS[kind]
    path = cuda_modconv.fwd_path(dtype, call["H"], call["H"], call["Ci"],
                                 cok, phases, taps)
    sms = (cuda_modconv._sms(torch.cuda.current_device()) if dev == "cuda"
           else 132)
    return path, cuda_modconv.fwd_split(call["B"], call["H"], call["H"],
                                        call["Ci"], cok, len(taps), sms,
                                        path)


def _modconv_controls(call, dtype, args, dev):
    """The forward's planted faults: the styles of samples 0 and 1
    swapped (a tile that spans samples scaling a row by another sample's
    s; batch >= 2), the middle tap's contribution dropped, and, where the
    launch splits its stages, the middle split's partial dropped (its
    taps x 64-channel slabs of the weights zeroed)."""
    from gansformer_tpu_torch.ops import cuda_modconv
    from gansformer_tpu_torch.ops import modulated_conv as mc

    x, ws, s = args[:3]
    rest = args[3:]
    controls = []
    if call["B"] >= 2:
        swapped = s.clone()
        swapped[[0, 1]] = s[[1, 0]]
        controls.append(dict(desc="styles of samples 0 and 1 swapped", out=0,
                             fault=lambda: mc.modconv_plain(x, ws, swapped,
                                                            *rest)))
    tap = ws.shape[0] // 2
    no_tap = ws.clone()
    no_tap[tap] = 0
    controls.append(dict(desc=f"tap {tap} dropped", out=0,
                         fault=lambda: mc.modconv_plain(x, no_tap, s, *rest)))
    _, p = fwd_plan(call, dtype, dev)
    if p > 1:
        mid = p // 2
        no_split = ws.clone()
        for t, c0 in cuda_modconv.fwd_split_stages(call["Ci"], ws.shape[0], p,
                                                   mid):
            no_split[t, c0:c0 + cuda_modconv.FWD_STAGE_K] = 0
        controls.append(dict(desc=f"split {mid} of {p} dropped", out=0,
                             fault=lambda: mc.modconv_plain(x, no_split, s,
                                                            *rest)))
    return controls


def _without_middle_chunk(n: int, chunk: int, dev):
    """Indices 0..n-1 without the middle ``chunk``-row chunk, or None when
    n fits in one chunk."""
    import torch

    if n <= chunk:
        return None
    c0 = (-(-n // chunk) // 2) * chunk
    return torch.cat([torch.arange(0, c0, device=dev),
                      torch.arange(min(n, c0 + chunk), n, device=dev)])


def l2g_key_drops(call, dtype, dev, chunk=None):
    """(desc, kept key indices) of the planted faults of a latent->grid
    launch, forward or backward, at each level of its reduction over the
    keys.  Tensor-core route (the wrapper's plan): the middle span
    dropped where the launch splits n into spans, and the middle tile
    where n spans more than one tile.  CUDA-core route: the middle
    ``chunk``-key chunk (the library's own chunk unless given) where n
    spans more than one."""
    from gansformer_tpu_torch.ops import _build, cuda_attention

    bwd = call["kernel"] == "latent_to_grid_bwd"
    n = call["Lk"]
    path, _, kt, tps, spans, _, _ = l2g_call_plan(call, dtype)
    if path == cuda_attention.L2G_SIMT:
        if not chunk:
            lib = _build.load_library()
            chunk = lib.gt_attn_bwd_rows() if bwd else lib.gt_attn_chunk()
        keep = _without_middle_chunk(n, chunk, dev)
        desc = ("dq without one key chunk's partial" if bwd
                else "drop-one-chunk")
        return [] if keep is None else [(desc, keep)]
    drops = []
    if spans > 1:
        span = tps * kt
        keep = _without_middle_chunk(n, span, dev)
        drops.append((f"dq without one span's partial ({span} keys)" if bwd
                       else f"one span of {span} keys dropped", keep))
    keep = _without_middle_chunk(n, kt, dev)
    if keep is not None:
        drops.append((f"dq without one {kt}-key tile" if bwd
                      else f"one {kt}-key tile dropped", keep))
    return drops


def g2l_bwd_row_drops(call, dtype, dev, chunk=None):
    """(what, kept row indices) of the planted faults of a grid->latent
    backward launch at each level of its sums of dk and dv over the grid
    rows.  Tensor-core route (the wrapper's plan): the middle span dropped
    where the launch splits n into spans, and the middle tile where n
    spans more than one tile.  CUDA-core route: the middle ``chunk``-row
    chunk (the library's own kRows unless given) where n spans more than
    one."""
    from gansformer_tpu_torch.ops import _build, cuda_attention

    n = call["Lq"]
    path, _, kt, tps, spans, _, _ = g2l_bwd_call_plan(call, dtype)
    if path == cuda_attention.G2L_SIMT:
        chunk = chunk or _build.load_library().gt_attn_bwd_rows()
        keep = _without_middle_chunk(n, chunk, dev)
        return [] if keep is None else [("one row chunk's partial", keep)]
    drops = []
    if spans > 1:
        drops.append((f"one span's partial ({tps * kt} rows)",
                      _without_middle_chunk(n, tps * kt, dev)))
    keep = _without_middle_chunk(n, kt, dev)
    if keep is not None:
        drops.append((f"one {kt}-row tile", keep))
    return drops


def _attention_case(call, dtype, randn, dev, chunk):
    """``build_case`` for the four attention kernels.  Forward: o (and
    lse when the call writes it).  Backward: dq, dk, dv; latent_to_grid's
    on the forward's lse and delta = rowsum(do * o) computed by the plain
    version on the same inputs, grid_to_latent's with each row's lse
    from its own logits, in the kernel as in its plain version."""
    import torch

    from gansformer_tpu_torch.ops import cuda_attention
    from gansformer_tpu_torch.ops.attention import (
        attention_bwd_own_lse_plain, attention_bwd_plain, attention_delta,
        attention_fwd_stats_plain, attention_plain)

    kname = call["kernel"]
    b, lq, lk, d, dv = call["B"], call["Lq"], call["Lk"], call["D"], \
        call["Dv"]
    it = torch.tensor([], dtype=dtype).element_size()
    nbytes, ops = attention_cost(call, it)
    q = randn(b, lq, d).to(dtype)
    k = randn(b, lk, d).to(dtype)
    v = randn(b, lk, dv)
    if kname == "latent_to_grid_bwd":
        # values with a mean of 1, as real features have: zero-mean values
        # average to o ~ 0 over thousands of keys, delta = rowsum(do * o)
        # would be ~0 and the kernel's delta path would go untested
        v = v + 1.0
    v = v.to(dtype)
    controls = []
    if kname in ATTENTION_KERNELS:
        fn = (cuda_attention.grid_to_latent_cuda
              if kname == "grid_to_latent"
              else cuda_attention.latent_to_grid_cuda)
        lse = bool(call.get("lse"))
        if kname == "grid_to_latent" and lk >= 2:
            controls.append(dict(
                desc="the last latent dropped", out=0,
                fault=lambda: attention_plain(q, k[:, :-1], v[:, :-1])))
        if kname == "grid_to_latent" and b >= 2:
            swap = torch.arange(b, device=dev)
            swap[[0, 1]] = swap[[1, 0]]
            controls.append(dict(
                desc="K/V of samples 0 and 1 swapped", out=0,
                fault=lambda: attention_plain(q, k[swap], v[swap])))
        if kname == "latent_to_grid":
            controls += [dict(desc=desc, out=0,
                              fault=lambda keep=keep: attention_plain(
                                  q, k[:, keep], v[:, keep]))
                         for desc, keep in l2g_key_drops(call, dtype, dev,
                                                         chunk)]
        if lse:
            def max_alone():
                s = torch.einsum("bnd,bld->bnl", q.float(), k.float())
                return s.amax(dim=-1) / math.sqrt(d)

            controls.append(dict(desc="lse = max without log(den)", out=1,
                                 fault=max_alone))
        return dict(
            kernel=lambda: fn(q, k, v, with_stats=lse),
            plain=((lambda: attention_fwd_stats_plain(q, k, v)) if lse
                   else (lambda: attention_plain(q, k, v))),
            library=library_attention(q, k, v), bytes=nbytes, ops=ops,
            outputs=("out", "stat") if lse else ("out",), controls=controls)
    do = randn(b, lq, dv).to(dtype)
    o, lse = attention_fwd_stats_plain(q, k, v)
    library, backend = library_attention_bwd(q, k, v, do)
    if kname == "grid_to_latent_bwd":
        args = (q, k, v, lse, do)
        # the kernel and its plain version each rebuild P from the lse of
        # their own logits (ROADMAP C.16)
        kern = lambda: cuda_attention.grid_to_latent_bwd_cuda(  # noqa: E731
            q, k, v, do)
        plain = lambda: attention_bwd_own_lse_plain(q, k, v, do)  # noqa
        def drop(keep, i):
            return lambda: attention_bwd_plain(
                q[:, keep], k, v, lse[:, keep], do[:, keep])[i]

        for what, keep in g2l_bwd_row_drops(call, dtype, dev, chunk):
            controls += [dict(desc=f"dk without {what}", out=1,
                              fault=drop(keep, 1)),
                         dict(desc=f"dv without {what}", out=2,
                              fault=drop(keep, 2))]
        zero = torch.zeros_like(lse)
        controls += [dict(desc=f"{name} with dS = P dP (no delta)", out=i,
                          fault=lambda i=i: attention_bwd_plain(
                              *args, delta=zero)[i])
                     for i, name in ((0, "dq"), (1, "dk"))]
    else:
        delta = attention_delta(o, do)
        args = (q, k, v, lse, do, delta)
        kern = lambda: cuda_attention.latent_to_grid_bwd_cuda(*args)  # noqa
        plain = lambda: attention_bwd_plain(*args)  # noqa: E731
        controls += [dict(desc=desc, out=0,
                          fault=lambda keep=keep: attention_bwd_plain(
                              q, k[:, keep], v[:, keep], lse, do, delta)[0])
                     for desc, keep in l2g_key_drops(call, dtype, dev,
                                                     chunk)]
        zero = torch.zeros_like(delta)
        controls += [dict(desc=f"{name} with delta = 0", out=i,
                          fault=lambda i=i: attention_bwd_plain(
                              q, k, v, lse, do, zero)[i])
                     for i, name in ((0, "dq"), (1, "dk"))]
    return dict(kernel=kern, plain=plain,
                library=library, library_backend=backend, bytes=nbytes,
                ops=ops, outputs=("out", "out", "out"), controls=controls)


def time_ms(fn) -> float:
    """Device time of one call: the mean over a run of calls by CUDA
    events, the median of three runs (a host stall inside one run, a
    collection or an allocation, shows as idle device time there)."""
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
    runs = []
    for _ in range(3):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / reps)
    return sorted(runs)[len(runs) // 2]


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def compare(got, ref, kinds, dtype_name, what):
    """max |err| and tolerance of each output; fails on a mismatch."""
    errs, tols = [], []
    for i, (g, r) in enumerate(zip(_tuple(got), _tuple(ref))):
        r = r.float()
        if g.shape != r.shape:
            fail(f"{what} output {i}: shape {tuple(g.shape)} != "
                 f"{tuple(r.shape)}")
        err = float((g.float() - r).abs().max())
        tol = TOLS[kinds[i]][dtype_name] * float(r.abs().max())
        if not (math.isfinite(err) and err <= tol):
            fail(f"{what} output {i}: max|err| {err:.3e} > tol {tol:.3e}")
        errs.append(err)
        tols.append(tol)
    return errs, tols


def run_controls(case, ref, dtype_name, what):
    """Each planted fault must exceed the tolerance wherever it changes
    the output at all; returns a note per control."""
    import torch

    notes = []
    for ctl in case["controls"]:
        i = ctl["out"]
        base = _tuple(ref)[i].float()
        kinds = case["outputs"]
        if "kernel" in ctl:          # the control's own inputs: the kernel
            got = ctl["kernel"]()    # must pass there before the fault
            base = _tuple(ctl["plain"]())[i].float()
            torch.cuda.synchronize()
            compare(got, base, kinds[i:i + 1], dtype_name,
                    f"{what} ({ctl['desc']}: its kernel)")
        tol = TOLS[kinds[i]][dtype_name] * float(base.abs().max())
        ferr = float((_tuple(ctl["fault"]())[0].float() - base).abs().max())
        if ferr == 0.0:
            notes.append(f"{ctl['desc']}: changes nothing here")
            continue
        if not ferr > tol:
            fail(f"{what}: planted fault '{ctl['desc']}' would pass "
                 f"(max|err| {ferr:.3e} <= tol {tol:.3e})")
        notes.append(f"{ctl['desc']}: {ferr:.3e} > tol {tol:.3e}")
    return notes


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
        ref = case["plain"]()
        torch.cuda.synchronize()
        what = f"{call['kernel']} {call['label']} B={call['B']} {dtype_name}"
        errs, tols = compare(got, ref, case["outputs"], dtype_name, what)
        notes = run_controls(case, ref, dtype_name, what)
        del got, ref
        rate = peaks[1] if dtype_name == "bfloat16" else peaks[2]
        row = dict(call, dtype=dtype_name, max_abs_err=max(errs),
                   err_over_tol=max(e / t for e, t in zip(errs, tols)),
                   bytes_ms=case["bytes"] / peaks[0] * 1e3,
                   ops_ms=case["ops"] / rate * 1e3,
                   ms=time_ms(case["kernel"]),
                   plain_ms=time_ms(case["plain"]),
                   library_ms=time_ms(case["library"]),
                   library_backend=case.get("library_backend"))
        rows.append(row)
        if show:
            errs_s = "/".join(f"{e:.3e}" for e in errs)
            tols_s = "/".join(f"{t:.1e}" for t in tols)
            backend = (f" (sdpa {row['library_backend']})"
                       if row["library_backend"] else "")
            print(f"  {call['kernel']:18s} {call['label']:28s} "
                  f"{dtype_name:9s}{' lse' if call.get('lse') else ''} "
                  f"max|err| {errs_s} (tol {tols_s}) ok "
                  f"kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} "
                  f"library {row['library_ms']:.4f}{backend} bound "
                  f"{max(row['bytes_ms'], row['ops_ms']):.4f} ms"
                  + "".join(f"; {n}" for n in notes), flush=True)
        del case
    return rows


def kernel_sums(rows, names):
    """Per kernel of ``names``: the launches and the sums of times and
    bounds."""
    out = {}
    for kname in names:
        rs = [r for r in rows if r["kernel"] == kname]
        bytes_ms = sum(r["bytes_ms"] for r in rs)
        ops_ms = sum(r["ops_ms"] for r in rs)
        out[kname] = {
            "launches": len(rs),
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "worst_err_over_tol": max(r["err_over_tol"] for r in rs),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(max(r["bytes_ms"], r["ops_ms"]) for r in rs),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": sum(r["library_ms"] for r in rs),
            "library_backends": sorted({r["library_backend"] for r in rs
                                        if r["library_backend"]}),
        }
    return out


def print_sums(title, sums):
    print(title, flush=True)
    for kname, s in sums.items():
        backends = (f" (sdpa {'/'.join(s['library_backends'])})"
                    if s["library_backends"] else "")
        print(f"    {kname:18s} {s['launches']:3d} launches  kernel "
              f"{s['ms']:8.4f} ms  plain {s['plain_ms']:8.4f}  library "
              f"{s['library_ms']:8.4f}{backends}  bound {s['bound_ms']:.4f} "
              f"({s['bound_by']})  worst err/tol "
              f"{s['worst_err_over_tol']:.3f}", flush=True)


FLAGSHIP = ("b256_conv same3", "b256 blur", "b128_conv_up poly",
            "b256_trgb same1", "b256 skip up", "b128 centroid", "b128 main",
            "b4 centroid", "b4 main")
# The largest same3, poly and same1 launches and the largest D blur-pool,
# backward.
TRAIN_FLAGSHIP = ("b256_conv same3 dx/ds", "b256_conv same3 dw",
                  "b256_conv_up poly dx/ds", "b256_conv_up poly dw",
                  "b256_trgb same1 dx/ds", "b256_trgb same1 dw",
                  "Df b256 blur-pool adjoint", "b128 main backward",
                  "b128 centroid backward", "b8 main backward",
                  "b128 main", "b128 centroid", "b8 main")


# --------------------------------------------------------------------------
# ROADMAP C.16: the attention kernels as the logits grow
# --------------------------------------------------------------------------

LOGIT_TARGETS = (1e1, 1e2, 1e3, 3e3, 1e4)
# Where C.16 was measured (kernels 3 + 8 in fp32: dq / dk 4-6x the plain
# pair's error against float64 at 1e3, ~770x at 1e4): since the repair
# the kernels' dq and dk errors there are at most LOGIT_FACTOR times the
# plain pair's on the same inputs.  At 1e4 the plain pair itself misses
# dq and dk by 4-5x the largest float64 entry, so the gate there admits
# any error up to ~10x that scale and only catches a C.16-sized fault;
# 1e3 and 3e3, where the plain pair still resolves dq and dk, are the
# points that tell a right kernel from a wrong one.
LOGIT_GATE = (1e3, 3e3, 1e4)
LOGIT_FACTOR = 2.0


def logit_scaling(gate: bool = True):
    """Kernels 3 + 8 (grid->latent, forward writing lse and backward) and
    4 + 9 (latent->grid) at D's b8 attention shape (batch 2, 64 grid rows,
    16 latents, width 512), q and k drawn from N(0, 1) (seed 11) and
    scaled so the largest logit is each of ``LOGIT_TARGETS``, in fp32 and
    bf16, against float64 autograd of the softmax form on the same
    (rounded) inputs: the largest error of o, dq, dk and dv relative to
    the largest |float64| entry, the kernels' beside the plain pair's
    (``attention_fwd_stats_plain`` and ``attention_bwd_plain`` on its
    lse, in the same dtype on the card) and, for grid->latent, beside
    kernel 8's own plain version (``attention_bwd_own_lse_plain``).
    ``gate``: fails unless grid->latent's fp32 dq and dk errors at
    ``LOGIT_GATE`` are within ``LOGIT_FACTOR`` of the plain pair's."""
    import torch

    from gansformer_tpu_torch.ops import attention as att
    from gansformer_tpu_torch.ops import cuda_attention as ca

    def rel(got, refs):
        return [float((g.double().cpu() - r).abs().max())
                / float(r.abs().max()) for g, r in zip(got, refs)]

    def fmt(errs):
        return "/".join(f"{e:.2e}" for e in errs)

    gen = torch.Generator().manual_seed(11)
    n, lat, width = 64, 16, 512
    for direction, rows, cols in (("grid_to_latent", n, lat),
                                  ("latent_to_grid", lat, n)):
        q0 = torch.randn(2, rows, width, generator=gen, dtype=torch.float64)
        k0 = torch.randn(2, cols, width, generator=gen, dtype=torch.float64)
        v0 = torch.randn(2, cols, width, generator=gen, dtype=torch.float64)
        do0 = torch.randn(2, rows, width, generator=gen, dtype=torch.float64)
        base = float((torch.einsum("bnd,bld->bnl", q0, k0)
                      / width ** 0.5).abs().max())
        for target in LOGIT_TARGETS:
            c = (target / base) ** 0.5
            for dtype_name in ("float32", "bfloat16"):
                dt = getattr(torch, dtype_name)
                q, k, v, do = (t.to(dt).cuda() for t in (q0 * c, k0 * c, v0,
                                                         do0))
                ins = [t.double().cpu().requires_grad_() for t in (q, k, v)]
                o_ref = att.attention_plain(*ins)
                refs = (o_ref.detach(),) + torch.autograd.grad(
                    o_ref, ins, do.double().cpu())
                o, lse = getattr(ca, f"{direction}_cuda")(q, k, v,
                                                          with_stats=True)
                o_p, lse_p = att.attention_fwd_stats_plain(q, k, v)
                if direction == "grid_to_latent":
                    kern = (o,) + ca.grid_to_latent_bwd_cuda(q, k, v, do)
                    pair = (o_p,) + att.attention_bwd_plain(q, k, v, lse_p,
                                                            do)
                    own = (o_p,) + att.attention_bwd_own_lse_plain(q, k, v,
                                                                   do)
                else:
                    kern = (o,) + ca.latent_to_grid_bwd_cuda(
                        q, k, v, lse, do, att.attention_delta(o, do))
                    pair = (o_p,) + att.attention_bwd_plain(
                        q, k, v, lse_p, do, att.attention_delta(o_p, do))
                    own = None
                torch.cuda.synchronize()
                ek, ep = rel(kern, refs), rel(pair, refs)
                print(f"  {direction:14s} {dtype_name:8s} max |logit| "
                      f"{target:.0e}: (o, dq, dk, dv) kernels {fmt(ek)}; "
                      f"plain pair {fmt(ep)}"
                      + (f"; kernel 8's plain {fmt(rel(own, refs))}"
                         if own else ""), flush=True)
                if not all(math.isfinite(e) for e in ek):
                    fail(f"{direction} {dtype_name} at {target:.0e}: "
                         f"non-finite kernel output")
                if (gate and direction == "grid_to_latent"
                        and dtype_name == "float32" and target in LOGIT_GATE):
                    for i, name in ((1, "dq"), (2, "dk")):
                        if not ek[i] <= LOGIT_FACTOR * ep[i]:
                            fail(f"C.16: kernels 3 + 8 fp32 {name} at max "
                                 f"|logit| {target:.0e}: {ek[i]:.3e} > "
                                 f"{LOGIT_FACTOR} x the plain pair's "
                                 f"{ep[i]:.3e}")


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


def serve_run(cfg, expected, calls):
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
        paths_before = ops.path_launch_counts()
        ws = progs.map_seeds(seeds)
        img = progs.synthesize(ws, psis[bucket], seed=7, tags=seeds)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        paths = {k: v - paths_before[k]
                 for k, v in ops.path_launch_counts().items()}
        check_path_counts(paths, calls[bucket], cfg.dtype,
                          f"bucket {bucket}")
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
    for name in SERVE_KERNELS:
        if counts[name] == 0:
            fail(f"kernel {name} was not launched on the main path")
    if any(ops.lse_launch_counts().values()):
        fail(f"the serve path wrote lse: {ops.lse_launch_counts()}")
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
    ws = progs.map_seeds(seeds)
    profile(lambda: progs.synthesize(ws, [0.7] * len(seeds), seed=7,
                                     tags=seeds),
            f"one synthesize at bucket {len(seeds)}")
    return bundle, counts, synth_s


KERNEL_GROUPS = (("grid_to_latent bwd", "g2l_bwd"),
                 ("latent_to_grid bwd", "l2g_bwd"),
                 ("modconv dx/ds", "dx_"), ("modconv dx/ds", "ds_reduce"),
                 ("modconv dw", "dw_"), ("modconv", "modconv_"),
                 ("modconv", "fwd_wgmma"), ("modconv", "fwd_smallk"),
                 ("modconv", "fwd_reduce"),
                 ("upfirdn", "upfirdn_kernel"), ("upfirdn", "ufd_"),
                 ("grid_to_latent", "g2l_kernel"),
                 ("grid_to_latent", "g2l_mma"),
                 ("latent_to_grid", "l2g_"), ("matmul", "gemm"),
                 ("matmul", "cutlass"), ("cudnn conv", "conv"),
                 ("cudnn conv", "cudnn"), ("noise draw", "distribution"))


def profile(fn, title):
    """Device time of one call of ``fn`` by kernel group (the profiler's
    CUDA activity), the device-busy share of its wall time and the number
    of device activities."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    # the launches by group mix operator entries with kernel entries; the
    # device activities (kernels and copies) are counted apart
    activities = sum(1 for ev in prof.events()
                     if ev.device_type == torch.autograd.DeviceType.CUDA)
    print(f"  {title}: wall {wall_ms:.2f} ms (profiled), device busy "
          f"{device_ms:.2f} ms ({100 * device_ms / wall_ms:.1f} % of wall), "
          f"{activities} device activities")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"    {g:24s} {ms:8.3f} ms  {launches[g]:5d} launches  "
              f"{100 * ms / device_ms:5.1f} % of device time")
    print("  largest of the other ops:")
    for ms, count, key in sorted(others, reverse=True)[:8]:
        print(f"    {key[:56]:56s} {ms:8.3f} ms  {count:5d} calls")


def model_compare(cfg, bundle):
    """Card kernels (fp32 and bf16) vs the host plain path (fp32)."""
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


# --------------------------------------------------------------------------
# Serving precisions, the w cache and the serve CLI
# --------------------------------------------------------------------------

PRECISION_BUCKETS = (1, 8)
PRECISION_SEEDS = tuple(range(300, 308))
# The psi of the JAX package's fidelity fixture (``fidelity_report``) and
# of the serve CLI's default.
PRECISION_PSI = 0.7
# The inputs each precision is held on: (bucket, psi, noise_mode).  The
# noise is drawn on the CPU (``noise_device``), so the card and the host
# add the same noise to the same layers.
PRECISION_CASES = ((8, 0.7, "random"), (8, 1.0, "random"),
                   (8, 0.7, "none"), (8, 1.0, "none"), (1, 0.7, "random"))
PRECISION_NOISE_SEED = 7
# How far the card's error may exceed the host plain path's own error at
# the same precision on the same inputs, where that error is above the
# declared tolerance: the excess over the declared figure is then the
# precision's rounding at this depth, not the kernels'.
WITNESS_RATIO = 1.5
# The serve CLI's runs: (title, arguments, (loaded, compiled)); each a
# process of its own on one manifest directory, cold first; the last
# builds into a temporary directory of its own, so its first image is a
# cold one.
SERVE_CLI_PRESET = "ffhq256-duplex"
SERVE_CLI_RUNS = (
    ("--warm-only (cold)", ["--warm-only"], (0, 1)),
    ("bf16 (warm)", ["--images", "16", "--serve-precision", "bf16"], (1, 0)),
    ("int8w (warm)", ["--images", "16", "--serve-precision", "int8w"],
     (1, 0)),
    ("bf16 --no-warm-start (cold)", ["--images", "16", "--serve-precision",
                                     "bf16", "--no-warm-start"], (0, 1)),
)


def precision_tolerance(precision: str, witness: float = None) -> float:
    """A serving precision's images against the host's fp32 plain path on
    the same weights, ws, psi and noise (max |err| / max |host|).  f32
    runs the fp32 kernels, whose difference from the host is summation
    order: ``MODEL_TOL["float32"]`` (the declared 0 of
    ``FIDELITY_TOLERANCES`` holds the f32 program against itself on one
    device).  bf16 and int8w: the declared ``FIDELITY_TOLERANCES``, or,
    where the host's plain path at the same precision on the same inputs
    already errs by ``witness`` > that, ``WITNESS_RATIO * witness``."""
    from gansformer_tpu_torch.serve import FIDELITY_TOLERANCES

    if precision == "f32":
        return MODEL_TOL["float32"]
    declared = FIDELITY_TOLERANCES[precision]
    return declared if witness is None else max(declared,
                                                WITNESS_RATIO * witness)


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref| on the host."""
    return float((got.float().cpu() - ref).abs().max()) / float(
        ref.abs().max())


def plant_scale_fault(synth_module, cfg) -> None:
    """Double the int8 scales of the full-resolution tRGB layer of an int8w
    synth program: not demodulated, so its scale reaches the image (a
    demodulated conv would normalize a uniform scale away)."""
    getattr(synth_module.synthesis,
            f"b{cfg.resolution}_trgb").w.scale.mul_(2.0)


def fp32_bundle(cfg, bundle, device):
    """The bundle's weights in the fp32 configuration on ``device``."""
    from gansformer_tpu_torch.models import Generator
    from gansformer_tpu_torch.serve.programs import bundle_from_generator

    g = Generator(dataclasses.replace(cfg, dtype="float32"))
    g.load_state_dict({k: v.detach().cpu() for k, v in
                       bundle.generator.state_dict().items()})
    return bundle_from_generator(g, bundle.w_avg.cpu(), device=device)


def precision_case(progs, rows, case):
    """One synthesize of ``case`` (bucket, psi, noise_mode) on ``rows``,
    the noise drawn on the CPU; the images on the host."""
    b, psi, noise = case
    return progs.synthesize(
        rows[b].to(progs.device), [psi] * b, seed=PRECISION_NOISE_SEED,
        tags=PRECISION_SEEDS[:b], noise_mode=noise,
        noise_device="cpu").float().cpu()


def case_name(case) -> str:
    b, psi, noise = case
    return f"bucket {b} psi {psi} noise {'on' if noise == 'random' else 'off'}"


def precision_gate(prec, what, err, witness) -> None:
    tol = precision_tolerance(prec, witness)
    if not math.isfinite(err) or err > tol:
        fail(f"{prec} {what}: rel_err {err:.4e} against the host's fp32 > "
             f"{tol:.4e} (the host's plain {prec}: {witness})")


def precision_phase(cfg, bundle, card: str) -> dict:
    """ffhq256-duplex's serve bundle (``serve_run``'s weights, noise
    strengths and gates 0.1, in the fp32 configuration, so f32 runs the
    fp32 kernels) in each serving precision on ``PRECISION_CASES``:
    launches per synthesize at buckets 1 and 8 held to ``main_path_calls``
    (routes by the compute dtype: int8w launches the bf16 kernels); the
    images held to the host's fp32 plain path on the same weights, ws,
    psi and noise at ``precision_tolerance``, with the host's plain path
    at the same precision as the witness; the same for the JAX package's
    ``fidelity_report`` fixture (bucket 4, seeds 1-4, psi 0.7, noise on),
    on the card against the report on the host; the bytes of each synth
    program, its peak device memory, ms and images/s at bucket 8; a
    planted fault (int8w with one layer's scales doubled) that the gate
    must reject; then the w cache on the card."""
    import torch

    from gansformer_tpu_torch import ops
    from gansformer_tpu_torch.serve import (SERVE_PRECISIONS, ServePrograms,
                                            fidelity_report,
                                            param_tree_bytes)

    card32, host = (fp32_bundle(cfg, bundle, d) for d in ("cuda", "cpu"))
    mapper = ServePrograms(card32, buckets=PRECISION_BUCKETS)
    rows = {b: mapper.map_seeds(list(PRECISION_SEEDS[:b]))
            for b in PRECISION_BUCKETS}
    t0 = time.perf_counter()
    hosts = {}
    for prec in SERVE_PRECISIONS:
        hp = ServePrograms(host, buckets=PRECISION_BUCKETS,
                           serve_precision=prec)
        for case in PRECISION_CASES:
            hosts[prec, case] = precision_case(hp, rows, case)
    refs = {case: hosts["f32", case] for case in PRECISION_CASES}
    witness = {(prec, case): rel_err(hosts[prec, case], refs[case])
               for prec in SERVE_PRECISIONS if prec != "f32"
               for case in PRECISION_CASES}
    print(f"  the host's plain path (fp32 reference, bf16 and int8w "
          f"witnesses) on {len(PRECISION_CASES)} cases: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    out = {}
    seeds8 = list(PRECISION_SEEDS)
    for prec in SERVE_PRECISIONS:
        progs = ServePrograms(card32, buckets=PRECISION_BUCKETS,
                              serve_precision=prec)
        dtype_name = "float32" if prec == "f32" else "bfloat16"
        pcfg = dataclasses.replace(cfg, dtype=dtype_name)
        errs = {}
        for case in PRECISION_CASES:
            b = case[0]
            calls = main_path_calls(pcfg, b)
            want = {k: sum(c["kernel"] == k for c in calls) for k in REPLACES}
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            img = precision_case(progs, rows, case)
            got = ops.launch_counts()
            if got != want:
                fail(f"{prec} {case_name(case)}: launches {got} != the "
                     f"plan's {want}")
            check_path_counts(ops.path_launch_counts(), calls, dtype_name,
                              f"{prec} {case_name(case)}")
            errs[case] = rel_err(img, refs[case])
            wit = witness.get((prec, case))
            print(f"  {prec} {case_name(case)}: rel_err vs the host's fp32 "
                  f"{errs[case]:.4e}"
                  + ("" if wit is None else
                     f", the host's plain {prec} {wit:.4e}; gate "
                     f"{precision_tolerance(prec, wit):.4e}"), flush=True)
            precision_gate(prec, case_name(case), errs[case], wit)
        psi8 = [PRECISION_PSI] * 8
        progs.synthesize(rows[8], psi8, seed=7, tags=seeds8)
        torch.cuda.synchronize()
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            progs.synthesize(rows[8], psi8, seed=7, tags=seeds8)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / reps
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        progs.synthesize(rows[8], psi8, seed=7, tags=seeds8)
        torch.cuda.synchronize()
        peak = torch.cuda.memory_stats()["allocated_bytes.all.peak"] - base
        tree = param_tree_bytes(progs.synth_module)
        out[prec] = dict(rel_err=errs, tree_bytes=tree, peak_bytes=peak,
                         ms=ms)
        print(f"  {prec}: launches a synthesize = the plan ({dtype_name} "
              f"routes) on every case; synth program {tree} bytes "
              f"({tree / 2**20:.2f} MiB); peak device memory of one "
              f"synthesize at bucket 8 {peak / 2**20:.1f} MiB above its "
              f"inputs; {ms:.2f} ms a synthesize at bucket 8, "
              f"{8e3 / ms:.2f} images/s (host clock, mean of {reps}) "
              f"({card})", flush=True)
        if prec == "int8w":
            case = PRECISION_CASES[0]
            plant_scale_fault(progs.synth_module, cfg)
            bad = rel_err(precision_case(progs, rows, case), refs[case])
            tol = precision_tolerance(prec, witness[prec, case])
            print(f"  int8w with the b{cfg.resolution}_trgb scales doubled, "
                  f"{case_name(case)}: rel_err {bad:.4e} (must exceed "
                  f"{tol:.4e})", flush=True)
            if not bad > tol:
                fail(f"the planted scale fault passed the gate: {bad:.4e}")
        del progs
        torch.cuda.empty_cache()
    ratio = out["f32"]["tree_bytes"] / out["int8w"]["tree_bytes"]
    print(f"  synth program bytes f32 / int8w: {ratio:.3f}", flush=True)
    if not ratio >= 3.0:
        fail(f"int8w holds {ratio:.3f}x fewer bytes than f32, not >= 3")
    for prec in ("bf16", "int8w"):
        rep = fidelity_report(card32, prec)
        wit = fidelity_report(host, prec)["rel_err"]
        print(f"  fidelity_report({prec}) on the card (bucket "
              f"{rep['bucket']}, psi {rep['psi']}, noise on, against the "
              f"card's f32): rel_err {rep['rel_err']:.4e} (declared "
              f"{rep['tolerance']}; on the host {wit:.4e}; gate "
              f"{precision_tolerance(prec, wit):.4e})", flush=True)
        precision_gate(prec, "fidelity_report", rep["rel_err"], wit)
    wcache_check(mapper)
    return out


def wcache_check(progs) -> None:
    """On the card: a repeated seed maps 0 times, at another psi too; a
    batch of a hit and a miss maps once."""
    import torch

    from gansformer_tpu_torch.obs import registry as telemetry
    from gansformer_tpu_torch.serve import WCache, map_rows

    def maps():
        return telemetry.counter("serve/map_dispatch_total").value

    cache = WCache()
    first = map_rows(progs, cache, [991])
    m0 = maps()
    again = map_rows(progs, cache, [991])
    a = progs.synthesize(again, [0.7], seed=1, tags=[991])
    b = progs.synthesize(map_rows(progs, cache, [991]), [0.4], seed=1,
                         tags=[991])
    if maps() != m0 or not torch.equal(first, again):
        fail(f"w cache: a repeated seed mapped {maps() - m0} times")
    if torch.equal(a, b):
        fail("w cache: psi 0.4 and 0.7 gave the same image")
    m0 = maps()
    rows = map_rows(progs, cache, [991, 992])
    if maps() != m0 + 1 or tuple(rows.shape[:1]) != (2,):
        fail(f"w cache: a hit and a miss mapped {maps() - m0} times")
    print("  w cache on the card: a repeated seed mapped 0 times (psi 0.7 "
          "and 0.4), a batch of a hit and a miss mapped once", flush=True)


def serve_cli_phase(card: str) -> None:
    """``cli/serve.py`` in processes of its own on one fresh manifest
    directory (``SERVE_CLI_RUNS``): ``--warm-only`` cold (it builds the
    kernel library: compiled 1), then the default mode in bf16 and in
    int8w (warm: loaded 1, compiled 0), then bf16 with
    ``--no-warm-start`` (a cold first image), each with ``--init random
    --preset ffhq256-duplex``; every JSON line parsed, the grids decoded
    (zlib) to 16 images, not constant."""
    import shutil
    import tempfile

    import numpy as np

    from gansformer_tpu_torch.utils.image import decode_png

    root = tempfile.mkdtemp(prefix="gansformer_smoke_serve_")
    manifest = os.path.join(root, "manifest")
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        for i, (title, extra, (loaded, compiled)) in enumerate(
                SERVE_CLI_RUNS):
            out_dir = os.path.join(root, f"out{i}")
            cmd = [sys.executable, "-m", "gansformer_tpu_torch.cli.serve",
                   "--init", "random", "--preset", SERVE_CLI_PRESET,
                   "--manifest-dir", manifest, "--out", out_dir] + extra
            t0 = time.perf_counter()
            run = subprocess.run(cmd, cwd=here, capture_output=True,
                                 text=True, timeout=600)
            took = time.perf_counter() - t0
            if run.returncode != 0:
                fail(f"serve {title} exited {run.returncode}: "
                     f"{run.stderr.strip()[-2000:]}")
            try:
                summary = json.loads(run.stdout.strip().splitlines()[-1])
            except (ValueError, IndexError):
                fail(f"serve {title} printed no JSON line: "
                     f"{run.stdout[-500:]}")
            warm = summary["warm_start"]
            if (warm["loaded"], warm["compiled"]) != (loaded, compiled):
                fail(f"serve {title}: warm start {warm}, expected loaded "
                     f"{loaded}, compiled {compiled}")
            if summary["device"]["platform"] != "gpu":
                fail(f"serve {title}: device {summary['device']}")
            line = (f"  serve {title}: {took:.1f} s in all; restore_ms "
                    f"{summary['restore_ms']}; warm start {warm}")
            if "--warm-only" in extra:
                if os.path.exists(out_dir):
                    fail(f"serve {title} wrote {out_dir}")
                print(f"{line}: the library built in {warm['seconds']} s "
                      f"({card})", flush=True)
                continue
            with open(os.path.join(out_dir, "served_grid.png"), "rb") as f:
                grid = decode_png(f.read())
            r = 256
            if grid.shape != (4 * r, 4 * r, 3) or not float(
                    np.asarray(grid, np.float64).std()) > 0:
                fail(f"serve {title}: served_grid.png {grid.shape}")
            prom = os.path.join(out_dir, "telemetry.prom")
            if not os.path.exists(prom):
                fail(f"serve {title}: no telemetry.prom")
            health = summary.get("health", {})
            if health.get("state") not in ("ready", "degraded") or \
                    summary.get("replicas") != 1:
                fail(f"serve {title}: health {health}, replicas "
                     f"{summary.get('replicas')}")
            probe = subprocess.run(
                [sys.executable, "-m", "gansformer_tpu_torch.cli.serve",
                 "--healthcheck", prom], cwd=here, capture_output=True,
                text=True, timeout=120)
            if probe.returncode != 0:
                fail(f"serve {title}: --healthcheck exited "
                     f"{probe.returncode}: {probe.stdout.strip()[-500:]}")
            verdict = json.loads(probe.stdout.strip().splitlines()[-1])
            print(f"{line}; first_image_ms {summary['first_image_ms']}; "
                  f"e2e_ms {summary['e2e_ms']}; counters "
                  f"{summary['counters']}; health {health['state']}, "
                  f"replicas 1; --healthcheck exit 0, state "
                  f"{verdict['state']}; served_grid.png decodes to 16 "
                  f"images ({card})", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------------------------
# The generation service
# --------------------------------------------------------------------------

SERVICE_PRESET = "ffhq256-duplex"
SERVICE_BUCKETS = (1, 4, 8)
SERVICE_NOISE_SEED = 7
SERVICE_PSIS = (0.5, 0.7, 1.0)
SERVICE_PARITY_REQUESTS = 24
SERVICE_LOAD_REQUESTS = 256
# the load run's Poisson rate, as a share of the synchronous bf16
# images/s the serve run measured in this process
SERVICE_RATE_SHARE = 0.5
SERVICE_CHAOS = {"queue_depth": 8, "burst_factor": 4, "crash_at_batch": 3}
# what a request of the chaos drill may end with besides an image: the
# typed refusals of the service, a cancel, a deadline and the planted
# crash of its batch (``raise@serve_dispatch``)
CHAOS_CAUSES = ("FaultInjected", "Overloaded", "Expired", "Cancelled",
                "ServiceUnhealthy", "ServiceClosed", "client_cancelled",
                "deadline")


def service_requests(n: int, seed: int = 0):
    """n Zipfian seeds (the load test's draw over 64 seeds) and psi
    drawn from ``SERVICE_PSIS``."""
    import numpy as np

    from gansformer_tpu_torch.cli.loadtest_serve import zipf_choice

    rng = np.random.RandomState(seed)
    seeds = zipf_choice(rng, np.arange(1, 65), n, 1.1)
    psis = rng.choice(SERVICE_PSIS, size=n)
    return [int(s) for s in seeds], [float(p) for p in psis]


class PositionTags:
    """Programs whose ``synthesize`` takes each row's noise tag from its
    position in the batch instead of the request seed: the planted fault
    the service parity must reject."""

    def __init__(self, programs):
        self._programs = programs

    def __getattr__(self, name):
        return getattr(self._programs, name)

    def synthesize(self, ws, psi, seed=0, tags=None, **kw):
        return self._programs.synthesize(ws, psi, seed=seed,
                                         tags=list(range(ws.shape[0])),
                                         **kw)


def service_parity(progs, seeds, psis, programs=None):
    """The requests through one ``GenerationService`` over ``programs``
    (default ``progs``), each image held to the same (seed, psi,
    noise_seed) run alone through ``map_rows`` + ``synthesize`` of
    ``progs``: (largest rel_err, every image bit-identical)."""
    from gansformer_tpu_torch.serve import GenerationService

    with GenerationService(programs or progs, max_fill_wait_ms=2.0,
                           noise_seed=SERVICE_NOISE_SEED) as svc:
        tickets = [svc.submit(s, psi=p) for s, p in zip(seeds, psis)]
        images = [t.result(timeout=600) for t in tickets]
    return hold_alone(progs, seeds, psis, images)


def load_gate(r, moved, counts, want):
    """What fails the load run: an image short or a request unfulfilled;
    a request without a terminal trace, or more terminal events than
    traces; launches off the plan per synthesize.  None when it
    passes."""
    cov = r["trace_coverage"]
    if r["images"] != r["requests"] or r["non_fulfilled_rids"]:
        return (f"{r['images']} images of {r['requests']}, not fulfilled "
                f"{r['non_fulfilled_rids'][:5]}")
    # every request has a terminal row, and there are as many terminal
    # events as traces (the load's and its first image's): one each
    if not cov["ok"] or cov["tickets"] != r["requests"] or \
            moved["reqtrace/terminal_total"] != \
            moved["reqtrace/requests_total"]:
        return f"trace coverage {cov}, {moved}"
    if counts != want:
        return f"launches {counts} != {want}"
    return None


def chaos_gate(c):
    """What fails the chaos drill: no shed, not exactly one restart, a
    hung ticket, a ticket unsettled or ending on an untyped cause, a
    trace missing; then the service not serving again (the breaker
    tripped, the dispatcher down, a reason besides the restart, no
    recovery).  None when it passes."""
    h = c["health"]
    causes = {x["cause"] for x in c["non_fulfilled_requests"]}
    settled = c["served"] + c["failed"] + c["expired"] + c["cancelled"]
    if (c["shed"] <= 0 or c["dispatcher_restarts"] != 1
            or c["hung_tickets"] != 0 or settled != c["accepted"]
            or not causes <= set(CHAOS_CAUSES)
            or not c["trace_coverage"]["ok"]):
        return (f"shed {c['shed']}, restarts {c['dispatcher_restarts']}, "
                f"hung {c['hung_tickets']}, settled {settled} of "
                f"{c['accepted']}, causes {sorted(causes)}, trace "
                f"coverage {c['trace_coverage']}")
    if (h["state"] not in ("ready", "degraded") or not h["dispatcher_alive"]
            or h["dispatcher_restarts"] != 1 or len(h["reasons"]) != 1
            or c["recovery_wave_served"] <= 0):
        return f"not serving again afterwards: {h}"
    return None


def service_phase(card: str, sync_ips: float, cfg=None,
                  device: str = "cuda") -> dict:
    """The port's ``GenerationService`` on ffhq256-duplex (random init,
    noise strengths and gates 0.1), buckets 1, 4 and 8, in this process
    with the kernel library loaded:

    * parity: ``SERVICE_PARITY_REQUESTS`` Zipfian requests in f32 (the
      fp32 configuration), each image held to the same request alone
      through ``map_rows`` + ``synthesize`` at ``precision_tolerance
      ("f32")``; a planted fault (tags from the batch position, not the
      request seed) must fail that gate;
    * load: ``run_loadtest`` in bf16, ``SERVICE_LOAD_REQUESTS`` requests
      at a Poisson rate of ``SERVICE_RATE_SHARE`` × ``sync_ips``, with the
      launch counters reset just before and read just after, held by
      ``load_gate`` (each kernel launched as ``main_path_calls`` plans
      per synthesize; every request at exactly one terminal event);
    * chaos: ``run_chaos`` in bf16 (``SERVICE_CHAOS``), held by
      ``chaos_gate``.

    ``cfg`` and ``device`` are for the host's test of the phase."""
    import torch

    from gansformer_tpu_torch import ops
    from gansformer_tpu_torch.cli.loadtest_serve import run_chaos, run_loadtest
    from gansformer_tpu_torch.core import get_preset
    from gansformer_tpu_torch.obs import registry as telemetry
    from gansformer_tpu_torch.serve import ServePrograms, init_generator

    def settle():
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    cfg = cfg or get_preset(SERVICE_PRESET)
    bundle = init_generator(cfg, seed=0, device=device)
    perturb(bundle.generator)
    out = {}

    # parity, f32
    t0 = time.perf_counter()
    progs = ServePrograms(fp32_bundle(cfg, bundle, device),
                          buckets=SERVICE_BUCKETS)
    seeds, psis = service_requests(SERVICE_PARITY_REQUESTS)
    tol = precision_tolerance("f32")
    err, same = service_parity(progs, seeds, psis)
    bad, _ = service_parity(progs, seeds, psis, PositionTags(progs))
    print(f"  parity (f32, {len(seeds)} requests, {len(set(seeds))} "
          f"seeds, psi {SERVICE_PSIS}): largest rel_err against each "
          f"request alone {err:.4e} (gate {tol:.1e}); bit-identical: "
          f"{same}; planted fault (tags from the batch position) "
          f"{bad:.4e}; {time.perf_counter() - t0:.1f} s ({card})",
          flush=True)
    if not math.isfinite(err) or err > tol:
        fail(f"service parity: rel_err {err:.4e} > {tol:.1e}")
    if not bad > tol:
        fail(f"service parity: the planted tag fault gave {bad:.4e}, "
             f"within the gate {tol:.1e}")
    out["parity"] = {"rel_err": err, "bit_identical": same,
                     "planted": bad}
    del progs
    settle()

    # load, bf16
    rate = SERVICE_RATE_SHARE * sync_ips
    calls = main_path_calls(cfg, SERVICE_BUCKETS[-1])
    per_synth = {k: sum(c["kernel"] == k for c in calls) for k in REPLACES}
    names = ("serve/synth_dispatch_total", "reqtrace/requests_total",
             "reqtrace/terminal_total")
    before = {k: telemetry.counter(k).value for k in names}
    settle()
    ops.reset_launch_counts()
    r = run_loadtest(bundle, SERVICE_BUCKETS, SERVICE_LOAD_REQUESTS, rate,
                     duration_s=120.0, serve_precision="bf16",
                     measure_cold=False, seed=0)
    settle()
    counts = ops.launch_counts()
    moved = {k: telemetry.counter(k).value - before[k] for k in names}
    synths = moved["serve/synth_dispatch_total"]
    want = {k: int(v * synths) for k, v in per_synth.items()}
    cov = r["trace_coverage"]
    print(f"  load (bf16, {r['requests']} requests at {rate:.1f}/s, half "
          f"the synchronous {sync_ips:.2f} images/s): e2e_ms p50 "
          f"{r['p50_ms']} p90 {r['p90_ms']} p99 {r['p99_ms']}; "
          f"{r['img_per_s']} images/s; batch fill {r['batch_fill_mean']}; "
          f"w cache hit rate {r['wcache_hit_rate']}; queue depth mean "
          f"{r['queue_depth_mean']}; trace coverage {cov['terminal']}/"
          f"{cov['tickets']} (traces opened "
          f"{moved['reqtrace/requests_total']:.0f}, terminal events "
          f"{moved['reqtrace/terminal_total']:.0f}); {int(synths)} "
          f"synthesize calls, launches {counts}; worst "
          f"{r['worst_requests'][:2]} ({card})", flush=True)
    why = load_gate(r, moved, counts, want)
    if why:
        fail(f"service load: {why}")
    out["load"] = r

    # chaos, bf16
    c = run_chaos(bundle, SERVICE_BUCKETS, serve_precision="bf16",
                  **SERVICE_CHAOS)
    h = c["health"]
    print(f"  chaos (bf16, queue depth {c['queue_bound']}, burst "
          f"{c['burst']}, raise@serve_dispatch at batch "
          f"{c['crash_at_batch']}): shed {c['shed']} (rate "
          f"{c['shed_rate']}), served {c['served']}, failed "
          f"{c['failed']} "
          f"({sorted({x['cause'] for x in c['non_fulfilled_requests']})}), "
          f"expired {c['expired']}, hung {c['hung_tickets']}, restarts "
          f"{c['dispatcher_restarts']}, recovery_ms {c['recovery_ms']}, "
          f"recovery wave served {c['recovery_wave_served']}, p50/p99 "
          f"under overload {c['p50_ms_under_overload']}/"
          f"{c['p99_ms_under_overload']} ms; health after {h['state']} "
          f"{h['reasons']}; {c['duration_s']} s ({card})", flush=True)
    why = chaos_gate(c)
    if why:
        fail(f"service chaos: {why}")
    out["chaos"] = c
    return out


# --------------------------------------------------------------------------
# The replica fleet
# --------------------------------------------------------------------------

FLEET_PLACEMENT_REQUESTS = 8
FLEET_DRILL = {"queue_depth": 8, "burst_factor": 4, "crash_at_batch": 3}
FLEET_CLI_IMAGES = 16


def fleet_members(device: str = "cuda"):
    """Every visible card when there are two or more, else the first card
    twice: two members that rehearse routing on one card."""
    import torch

    if device != "cuda":
        return [torch.device(device)] * 2
    n = torch.cuda.device_count()
    if n >= 2:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * 2


def first_replica_router():
    """A ``ReplicaSet`` whose router always picks member 0: the planted
    fault the share gate must reject."""
    from gansformer_tpu_torch.obs import registry as telemetry
    from gansformer_tpu_torch.serve import ReplicaSet

    class FirstReplica(ReplicaSet):
        def submit(self, seed, psi=0.7, label=None, deadline_s=None):
            r = self.active_replicas[0]
            t = r.service.submit(seed, psi, label, deadline_s)
            telemetry.counter(
                f"serve/replica{r.ordinal}/requests_total").inc()
            return t

    return FirstReplica


def fleet_serve(bundle, members, seeds, psis, fleet_cls=None,
                precision="f32", wave=None):
    """The requests through a ``ReplicaSet`` of one replica per member in
    ``precision`` (warmed first), all at once, or in waves of ``wave``
    requests, each wave waited on (with ``wave`` = the members, each
    member serves one request of a wave alone, at bucket 1): (images,
    requests each member took)."""
    from gansformer_tpu_torch.obs import registry as telemetry
    from gansformer_tpu_torch.serve import ReplicaSet

    fleet_cls = fleet_cls or ReplicaSet
    names = [f"serve/replica{i}/requests_total"
             for i in range(len(members))]
    before = [telemetry.counter(n).value for n in names]
    with fleet_cls(bundle, buckets=SERVICE_BUCKETS, devices=members,
                   replicas=len(members), serve_precision=precision,
                   service_kwargs=dict(max_fill_wait_ms=2.0,
                                       noise_seed=SERVICE_NOISE_SEED)) as rs:
        rs.warm_start()
        step = wave or len(seeds)
        images = []
        for i in range(0, len(seeds), step):
            tickets = [rs.submit(s, psi=p) for s, p in
                       zip(seeds[i:i + step], psis[i:i + step])]
            images += [t.result(timeout=600) for t in tickets]
    return images, [telemetry.counter(n).value - b
                    for n, b in zip(names, before)]


def hold_alone(progs, seeds, psis, images):
    """Each image against the same (seed, psi, noise_seed) alone through
    ``map_rows`` + ``synthesize`` of ``progs``: (largest rel_err, every
    image bit-identical)."""
    import torch

    from gansformer_tpu_torch.serve import WCache, map_rows

    cache, worst, same = WCache(), 0.0, True
    for s, p, img in zip(seeds, psis, images):
        ref = progs.synthesize(map_rows(progs, cache, [s]), [p],
                               seed=SERVICE_NOISE_SEED,
                               tags=[s])[0].float().cpu()
        got = torch.from_numpy(img)
        worst = max(worst, rel_err(got, ref))
        same = same and torch.equal(got, ref)
    return worst, same


def share_gate(shares):
    """What fails a fleet run's routing: a member that took no request."""
    if not shares or min(shares) <= 0:
        return f"a member served no request: requests per member {shares}"
    return None


def autoscale_gate(c):
    """What fails the autoscale drill: no scale-out, or one after the
    first breaker trip; a hung ticket; a ticket unsettled or ending on an
    untyped cause; the fleet not ready or degraded afterwards."""
    a = c.get("autoscale") or {}
    causes = {x["cause"] for x in c["non_fulfilled_requests"]}
    settled = c["served"] + c["failed"] + c["expired"] + c["cancelled"]
    if not a.get("scale_out_fired") or not a.get("scale_out_before_breaker"):
        return f"no scale-out before a breaker trip: {a}"
    if (c["hung_tickets"] != 0 or settled != c["accepted"]
            or not causes <= set(CHAOS_CAUSES)):
        return (f"hung {c['hung_tickets']}, settled {settled} of "
                f"{c['accepted']}, causes {sorted(causes)}")
    if c["health"]["state"] not in ("ready", "degraded"):
        return f"fleet health afterwards {c['health']['state']}"
    return None


def slo_gate(report):
    """What fails the SLO report: a default objective missing, or one
    without data where the ledger had rows."""
    from gansformer_tpu_torch.obs import DEFAULT_OBJECTIVES

    names = [o["name"] for o in report["objectives"]]
    if names != [o["name"] for o in DEFAULT_OBJECTIVES]:
        return f"objectives {names}"
    if report["source"] != "ledger" or report["rows"] <= 0:
        return f"no ledger rows: source {report['source']}"
    empty = [o["name"] for o in report["objectives"]
             if o["status"] == "no_data"]
    return f"no data for {empty}" if empty else None


def fleet_cli(card: str) -> dict:
    """``cli/serve.py --autoscale`` in a process of its own (on the
    default manifest directory, which adopts the library this process
    built): its JSON line, its prom held to the fleet families, and
    ``--healthcheck`` on it."""
    import tempfile

    from gansformer_tpu_torch.cli import serve as serve_cli
    from gansformer_tpu_torch.cli.loadtest_serve import \
        check_serve_metric_families
    from gansformer_tpu_torch.obs.registry import parse_prom_values

    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="gansformer_smoke_fleet_") as d:
        cmd = [sys.executable, "-m", "gansformer_tpu_torch.cli.serve",
               "--init", "random", "--preset", SERVICE_PRESET, "--images",
               str(FLEET_CLI_IMAGES), "--autoscale", "--out", d]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=here, capture_output=True, text=True,
                             timeout=600)
        took = time.perf_counter() - t0
        if run.returncode != 0:
            fail(f"serve --autoscale exited {run.returncode}: "
                 f"{run.stderr.strip()[-2000:]}")
        try:
            summary = json.loads(run.stdout.strip().splitlines()[-1])
        except (ValueError, IndexError):
            fail(f"serve --autoscale printed no JSON line: "
                 f"{run.stdout[-500:]}")
        if summary.get("autoscale") is not True or \
                not summary.get("replicas", 0) >= 1:
            fail(f"serve --autoscale: autoscale "
                 f"{summary.get('autoscale')}, replicas "
                 f"{summary.get('replicas')}")
        prom = os.path.join(d, "telemetry.prom")
        errors = check_serve_metric_families(prom) \
            if os.path.exists(prom) else [f"{prom}: missing"]
        if not errors and "serve_replicas" not in parse_prom_values(prom):
            errors = [f"{prom}: no serve_replicas (not a fleet's prom)"]
        if errors:
            fail(f"serve --autoscale: its prom fails the fleet families: "
                 f"{errors[:5]}")
        rc = serve_cli.main(["--healthcheck", prom])
        if rc != 0:
            fail(f"serve --autoscale: --healthcheck exited {rc}")
    print(f"  serve --autoscale ({FLEET_CLI_IMAGES} images): {took:.1f} s "
          f"in all; replicas {summary['replicas']}, autoscale true; warm "
          f"start {summary['warm_start']}; first_image_ms "
          f"{summary['first_image_ms']}; e2e_ms {summary['e2e_ms']}; "
          f"health {summary['health']['state']}; its prom passes the "
          f"fleet families; --healthcheck exit 0 ({card})", flush=True)
    return summary


def fleet_phase(card: str, cfg=None, device: str = "cuda") -> dict:
    """The port's ``ReplicaSet`` on ffhq256-duplex (random init, noise
    strengths and gates 0.1), buckets 1, 4 and 8, its members
    ``fleet_members``:

    * parity: ``service_phase``'s 24 Zipfian requests in f32 through a
      replica per member, with the launch counters reset just before and
      read just after (each serve kernel launched), each image held to
      the same request alone on the first member at
      ``precision_tolerance("f32")``, and every member serving
      (``share_gate``); a planted router that always picks member 0 must
      fail that gate;
    * placement (two cards or more): ``FLEET_PLACEMENT_REQUESTS`` bf16
      requests through a fleet on cuda:0 and cuda:1 in pairs (each card
      serves one of a pair alone), held to each request alone on cuda:0
      (the same program at the same bucket on a like card), then one
      modconv forward on a cuda:1 tensor launched while cuda:0 is
      current, against its plain version;
    * autoscale: ``run_chaos`` with the autoscaler (one replica, at most
      two; ``FLEET_DRILL``), held by ``autoscale_gate``;
    * SLO: ``evaluate_slos`` over the phase's ``requests.jsonl`` and
      ``telemetry.prom``, printed, held by ``slo_gate``.

    ``cfg`` and ``device`` are for the host's test of the phase."""
    import shutil
    import tempfile

    import torch

    from gansformer_tpu_torch import ops
    from gansformer_tpu_torch.cli.loadtest_serve import run_chaos
    from gansformer_tpu_torch.core import get_preset
    from gansformer_tpu_torch.obs import (evaluate_slos, registry,
                                          render_slos, reqtrace)
    from gansformer_tpu_torch.serve import ServePrograms, init_generator

    members = fleet_members(device)
    n_cards = len(set(members))
    which = ("every visible card" if n_cards > 1 else
             "one card twice: a rehearsal of routing on one card")
    print(f"  members: {[str(d) for d in members]} ({which})", flush=True)
    cfg = cfg or get_preset(SERVICE_PRESET)
    root = tempfile.mkdtemp(prefix="gansformer_smoke_fleet_")
    reqtrace.configure_reqtrace(os.path.join(root, "requests.jsonl"))
    out = {"members": [str(d) for d in members]}
    try:
        bundle = init_generator(cfg, seed=0, device=members[0])
        perturb(bundle.generator)
        f32 = fp32_bundle(cfg, bundle, members[0])

        # parity, f32
        t0 = time.perf_counter()
        seeds, psis = service_requests(SERVICE_PARITY_REQUESTS)
        calls = main_path_calls(cfg, SERVICE_BUCKETS[-1])
        per_synth = {k: sum(c["kernel"] == k for c in calls)
                     for k in SERVE_KERNELS}
        synth0 = registry.counter("serve/synth_dispatch_total").value
        ops.reset_launch_counts()
        images, shares = fleet_serve(f32, members, seeds, psis)
        counts = {k: ops.launch_counts()[k] for k in SERVE_KERNELS}
        synths = registry.counter("serve/synth_dispatch_total").value - \
            synth0
        tol = precision_tolerance("f32")
        progs = ServePrograms(f32, buckets=SERVICE_BUCKETS)
        err, same = hold_alone(progs, seeds, psis, images)
        _, planted = fleet_serve(f32, members, seeds, psis,
                                 first_replica_router())
        plan = {k: int(v * synths) for k, v in per_synth.items()}
        print(f"  parity (f32, {len(seeds)} requests through "
              f"{len(members)} replicas): largest rel_err against each "
              f"request alone on {members[0]} {err:.4e} (gate "
              f"{tol:.1e}); bit-identical: {same}; requests per member "
              f"{shares}; launches {counts} over {int(synths)} "
              f"synthesize calls (the plan: {plan}); "
              f"planted fault (a router that always picks member 0): "
              f"requests per member {planted}; "
              f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)
        if not math.isfinite(err) or err > tol:
            fail(f"fleet parity: rel_err {err:.4e} > {tol:.1e}")
        why = share_gate(shares)
        if why:
            fail(f"fleet parity: {why}")
        if not share_gate(planted):
            fail(f"fleet parity: the planted router (member 0 only) "
                 f"passed the share gate: {planted}")
        idle = [k for k in SERVE_KERNELS if counts[k] <= 0]
        if idle:
            fail(f"fleet parity: {idle} never launched in the fleet run")
        out["parity"] = {"rel_err": err, "bit_identical": same,
                         "shares": shares, "planted": planted,
                         "launches": counts,
                         "plan": plan}
        del progs, images
        if device == "cuda":
            torch.cuda.empty_cache()

        # placement, bf16, on two cards
        if n_cards > 1:
            t0 = time.perf_counter()
            two = [torch.device("cuda", 0), torch.device("cuda", 1)]
            pseeds, ppsis = (seeds[:FLEET_PLACEMENT_REQUESTS],
                             psis[:FLEET_PLACEMENT_REQUESTS])
            images, pshares = fleet_serve(bundle, two, pseeds, ppsis,
                                          precision="bf16", wave=2)
            alone = ServePrograms(bundle, buckets=SERVICE_BUCKETS,
                                  serve_precision="bf16")
            perr, psame = hold_alone(alone, pseeds, ppsis, images)
            kerr, ktol = modconv_on_second_card(cfg)
            print(f"  placement (bf16, {len(pseeds)} requests through "
                  f"cuda:0 and cuda:1 in pairs): largest rel_err against "
                  f"each alone on cuda:0 {perr:.4e} (gate {tol:.1e}); "
                  f"bit-identical: {psame}; requests per card {pshares}; "
                  f"one modconv forward (the wgmma path) on a cuda:1 "
                  f"tensor launched from the main thread with cuda:0 "
                  f"current: max|err| "
                  f"{kerr:.3e} (tol {ktol:.1e}); "
                  f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)
            if not math.isfinite(perr) or perr > tol:
                fail(f"fleet placement: rel_err {perr:.4e} > {tol:.1e}")
            why = share_gate(pshares)
            if why:
                fail(f"fleet placement: {why}")
            out["placement"] = {"rel_err": perr, "bit_identical": psame,
                                "shares": pshares, "modconv_err": kerr}
            del alone, images
        else:
            print("  placement: not exercised (one card; the four-card "
                  "run holds it)", flush=True)

        # autoscale drill, bf16
        c = run_chaos(bundle, SERVICE_BUCKETS, serve_precision="bf16",
                      replicas=1, max_replicas=2, autoscale=True,
                      devices=members, **FLEET_DRILL)
        a = c["autoscale"]
        print(f"  autoscale drill (bf16, 1 to 2 replicas, queue depth "
              f"{c['queue_bound']} each, burst {c['burst']} over the "
              f"pressure window, raise@serve_dispatch at batch "
              f"{c['crash_at_batch']}): scale-out {a['scale_out_fired']}, "
              f"scale-in {a['scale_in_fired']}, breaker trips "
              f"{a['breaker_trips']}, scale-out before any trip "
              f"{a['scale_out_before_breaker']}, peak replicas "
              f"{a['peak_replicas']}; shed {c['shed']}, served "
              f"{c['served']}, failed {c['failed']}, hung "
              f"{c['hung_tickets']}, restarts {c['dispatcher_restarts']}; "
              f"p50/p99 under overload {c['p50_ms_under_overload']}/"
              f"{c['p99_ms_under_overload']} ms; health after "
              f"{c['health']['state']}; {c['duration_s']} s ({card})",
              flush=True)
        why = autoscale_gate(c)
        if why:
            fail(f"fleet autoscale drill: {why}")
        out["autoscale"] = c

        # SLO budgets over what the phase wrote
        reqtrace.get_reqtracer().flush()
        registry.get_registry().write_prom(os.path.join(root,
                                                        "telemetry.prom"))
        report = evaluate_slos(root)
        print("  SLO budgets over the phase's requests.jsonl ("
              f"{report['rows']} rows):", flush=True)
        for line in render_slos(report).splitlines():
            print(f"    {line}", flush=True)
        why = slo_gate(report)
        if why:
            fail(f"fleet SLO report: {why}")
        out["slo"] = report
    finally:
        reqtrace.configure_reqtrace(None)
        shutil.rmtree(root, ignore_errors=True)
    return out


def modconv_on_second_card(cfg):
    """One bf16 modconv forward of the serve path (the flagship 3x3 at
    batch 8) on cuda:1 tensors, launched while cuda:0 is current, against
    its plain version: (max|err|, tolerance).  The launch runs
    ``fwd_wgmma_kernel``, whose shared-memory opt-in must hold on
    cuda:1."""
    import torch

    from gansformer_tpu_torch.ops import cuda_modconv

    call = next(c for c in main_path_calls(cfg, 8)
                if c["kernel"] == "modconv" and c["label"] == FLAGSHIP[0])
    path, _ = fwd_plan(call, torch.bfloat16, "cuda:1")
    if path != cuda_modconv.PATH_WGMMA:
        fail(f"the placement check's modconv forward takes path {path}, "
             f"not the wgmma path")
    gen = torch.Generator(device="cuda:1").manual_seed(1234)
    with torch.cuda.device(0):
        case = build_case(call, torch.bfloat16, gen, dev="cuda:1")
        got = case["kernel"]()
        ref = case["plain"]()
        torch.cuda.synchronize(1)
        (err,), (tol,) = compare(got, ref, case["outputs"], "bfloat16",
                                 "modconv forward on cuda:1")
        if got.device != torch.device("cuda", 1):
            fail(f"modconv forward on cuda:1 gave a tensor on {got.device}")
    return err, tol


# --------------------------------------------------------------------------
# Main path: training ffhq256 (attention none)
# --------------------------------------------------------------------------


def _named_grads(state):
    out = {}
    for tag, module in (("G", state.generator), ("D", state.discriminator)):
        for name, p in module.named_parameters():
            out[f"{tag}/{name}"] = p.grad
    return out


def train_state_on_card(model, train):
    """A random train state on the card (seed 0) with the noise strengths
    and the ReZero gates of the generator's attention styles made
    non-zero, so no path is trivially off."""
    from gansformer_tpu_torch.train import create_train_state

    state = create_train_state(model, train, seed=0, device="cuda")
    perturb(state.generator)
    return state


def counted_steps(state, reals, calls, dtype_name):
    """One d_step and one g_step with the counters reset just before and
    read just after each, held to the plan (kernel launches, the
    attention launches that wrote lse, and the routes of the upfirdn and
    grid->latent launches in ``dtype_name``); returns the counts per
    phase and the lse counts over both steps."""
    import torch

    from gansformer_tpu_torch import ops
    from gansformer_tpu_torch.train import d_step, g_step

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    aux = d_step(state, reals, 0)
    torch.cuda.synchronize()
    after_d, lse_d = ops.launch_counts(), ops.lse_launch_counts()
    paths_d = ops.path_launch_counts()
    aux.update(g_step(state, 0, TRAIN_BATCH))
    torch.cuda.synchronize()
    after_g, lse_g = ops.launch_counts(), ops.lse_launch_counts()
    paths_g = {k: v - paths_d[k]
               for k, v in ops.path_launch_counts().items()}
    for phase, paths in (("d_step", paths_d), ("g_step", paths_g)):
        check_path_counts(paths, [c for c in calls if c["phase"] == phase],
                          dtype_name, phase)
    deltas = {"d_step": (after_d, lse_d),
              "g_step": ({k: after_g[k] - after_d[k] for k in after_g},
                         {k: lse_g[k] - lse_d[k] for k in lse_g})}
    for phase, (got, got_lse) in deltas.items():
        want, want_lse = plan_counts(calls, phase), plan_lse_counts(calls,
                                                                    phase)
        print(f"  {phase}: launches {got}; with lse {got_lse}", flush=True)
        if got != want:
            fail(f"{phase}: launches {got} != the plan's {want}")
        if got_lse != want_lse:
            fail(f"{phase}: launches with lse {got_lse} != the plan's "
                 f"{want_lse}")
    losses = {k: float(v) for k, v in aux.items()}
    if not all(math.isfinite(v) for v in losses.values()):
        fail(f"non-finite loss {losses}")
    return {p: d[0] for p, d in deltas.items()}, lse_g, losses


def check_grads(state, nets=("G", "D")):
    """Every gradient leaf of ``nets`` present, finite and nonzero."""
    import torch

    grads = {k: g for k, g in _named_grads(state).items()
             if k.split("/")[0] in nets}
    for name, g in grads.items():
        if g is None:
            fail(f"{name}: no gradient")
        if not bool(torch.isfinite(g).all()):
            fail(f"{name}: non-finite gradient")
        if not bool((g != 0).any()):
            fail(f"{name}: gradient is zero everywhere")
    attn = sum(_is_attention_leaf(n) for n in grads)
    print(f"  {len(grads)} gradient leaves finite and nonzero ({attn} of "
          f"them attention leaves)", flush=True)


def train_run(model, train, calls):
    """One d_step + one g_step with the counters read around each, then
    3 more iterations; returns the launch counts of the first d_step +
    g_step, their lse counts and the step times."""
    import torch

    from gansformer_tpu_torch.data import SyntheticDataset
    from gansformer_tpu_torch.train import d_step, g_step

    state = train_state_on_card(model, train)
    start = {k: v.detach().clone() for k, v in
             state.generator.state_dict().items()}
    start_d = {k: v.detach().clone() for k, v in
               state.discriminator.state_dict().items()}
    start_ema = {k: v.detach().clone() for k, v in
                 state.ema.state_dict().items()}
    data = SyntheticDataset(model.resolution, model.img_channels).batches(
        TRAIN_BATCH, seed=0)
    batches = [torch.from_numpy(next(data)["image"]).cuda() for _ in range(4)]
    deltas, lse_counts, _ = counted_steps(state, batches[0], calls,
                                          model.dtype)
    for name in TRAIN_KERNELS:
        if deltas["d_step"][name] + deltas["g_step"][name] == 0:
            fail(f"kernel {name} was not launched on the training path")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    d_ms, g_ms, host_ms, losses = [], [], [], []
    for it in range(1, 4):
        t0 = time.perf_counter()
        ev[0].record()
        d_aux = d_step(state, batches[it], it)
        ev[1].record()
        g_aux = g_step(state, it, TRAIN_BATCH)
        ev[2].record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        d_ms.append(ev[0].elapsed_time(ev[1]))
        g_ms.append(ev[1].elapsed_time(ev[2]))
        losses.append({k: float(v) for k, v in {**d_aux, **g_aux}.items()})
        print(f"  iteration {it}: {losses[-1]}  d_step {d_ms[-1]:.2f} ms "
              f"g_step {g_ms[-1]:.2f} ms (CUDA events), iteration "
              f"{host_ms[-1]:.2f} ms (host clock)", flush=True)
    for row in losses:
        if not all(math.isfinite(v) for v in row.values()):
            fail(f"non-finite loss {row}")
    check_grads(state)
    for label, before, module in (("G", start, state.generator),
                                  ("D", start_d, state.discriminator),
                                  ("EMA", start_ema, state.ema)):
        now = module.state_dict()
        moved = sum(not torch.equal(before[k], now[k]) for k in before)
        print(f"  {label}: {moved} of {len(before)} tensors moved",
              flush=True)
        if moved != len(before):
            fail(f"{label}: {len(before) - moved} tensors did not move")
    profile(lambda: d_step(state, batches[0], 9), "one d_step")
    profile(lambda: g_step(state, 9, TRAIN_BATCH), "one g_step")
    mean = lambda xs: sum(xs) / len(xs)                    # noqa: E731
    return deltas, lse_counts, dict(d_ms=mean(d_ms), g_ms=mean(g_ms),
                                    iter_host_ms=mean(host_ms))


def d_attention_run(model, train, calls):
    """One d_step + one g_step of ``model`` (a configuration with
    ``d_attention``) at the training batch: counters against its plan,
    finite losses, every gradient leaf finite and nonzero."""
    import torch

    from gansformer_tpu_torch.data import SyntheticDataset

    state = train_state_on_card(model, train)
    reals = torch.from_numpy(next(SyntheticDataset(
        model.resolution, model.img_channels).batches(TRAIN_BATCH,
                                                      seed=1))["image"]).cuda()
    _, _, losses = counted_steps(state, reals, calls, model.dtype)
    print(f"  losses {losses}", flush=True)
    check_grads(state)


def reg_counted_step(run, phase, calls, second, dtype_name, loss_key):
    """One regularized step (``run``) with the counters reset just before
    and read just after, held to the plan of ``phase``: kernel launches,
    forward attention launches that wrote lse, the routes of the upfirdn
    and attention launches, and the second-order passes (``second``);
    finite losses, ``loss_key`` among them.  Returns the launch counts,
    the lse counts and the losses."""
    import torch

    from gansformer_tpu_torch import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    aux = run()
    torch.cuda.synchronize()
    got, lse = ops.launch_counts(), ops.lse_launch_counts()
    got_second = ops.second_order_counts()
    check_path_counts(ops.path_launch_counts(), calls, dtype_name, phase)
    want = plan_counts(calls, phase)
    want_lse = plan_lse_counts(calls, phase)
    print(f"  {phase}: launches {got}; with lse {lse}; second order "
          f"{got_second}", flush=True)
    if got != want:
        fail(f"{phase}: launches {got} != the plan's {want}")
    if lse != want_lse:
        fail(f"{phase}: launches with lse {lse} != the plan's {want_lse}")
    if got_second != second:
        fail(f"{phase}: second-order passes {got_second} != the plan's "
             f"{second}")
    losses = {k: float(v) for k, v in aux.items()}
    if loss_key not in losses or not all(
            math.isfinite(v) for v in losses.values()):
        fail(f"{phase}: losses {losses}")
    return got, lse, losses


def r1_run(model, train, calls, second, timed: bool):
    """One d_step_r1 of ``model`` at the training batch with its counters
    held to the plan, then every gradient leaf of D finite and nonzero,
    and the peak device memory of that step.  ``timed``: 3 more
    iterations of d_step_r1, d_step and g_step by CUDA events, and the
    profiler's breakdown of one d_step_r1.  Returns the launch counts,
    the peak bytes and the mean ms of each step (None untimed)."""
    import torch

    from gansformer_tpu_torch.data import SyntheticDataset
    from gansformer_tpu_torch.train import d_step, d_step_r1, g_step

    state = train_state_on_card(model, train)
    data = SyntheticDataset(model.resolution, model.img_channels).batches(
        TRAIN_BATCH, seed=3)
    batches = [torch.from_numpy(next(data)["image"]).cuda() for _ in range(4)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts, _, losses = reg_counted_step(
        lambda: d_step_r1(state, batches[0], 0), "d_step_r1", calls, second,
        model.dtype, "Loss/D/r1")
    peak = torch.cuda.max_memory_allocated()
    print(f"  losses {losses}; peak device memory of the step "
          f"{peak / 2**30:.2f} GiB", flush=True)
    check_grads(state, ("D",))
    if not timed:
        return counts, peak, None
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ms = {"d_step_r1": [], "d_step": [], "g_step": []}
    for it in range(1, 4):
        ev[0].record()
        d_step_r1(state, batches[it], it)
        ev[1].record()
        d_step(state, batches[it], it)
        ev[2].record()
        g_step(state, it, TRAIN_BATCH)
        ev[3].record()
        torch.cuda.synchronize()
        for i, name in enumerate(ms):
            ms[name].append(ev[i].elapsed_time(ev[i + 1]))
        print(f"  iteration {it}: " + ", ".join(
            f"{k} {v[-1]:.2f} ms" for k, v in ms.items())
            + " (CUDA events)", flush=True)
    profile(lambda: d_step_r1(state, batches[0], 9), "one d_step_r1")
    return counts, peak, {k: sum(v) / len(v) for k, v in ms.items()}


def pl_run(model, train, calls, second):
    """One g_step_pl of ``model`` at the training batch with its counters
    held to the plan, every gradient leaf of G finite and nonzero, and
    the peak device memory of that step; then 3 iterations of g_step_pl,
    g_step and d_step by CUDA events, and the profiler's breakdown of
    one g_step_pl.  Returns the launch counts, the peak bytes and the
    mean ms of each step."""
    import torch

    from gansformer_tpu_torch.data import SyntheticDataset
    from gansformer_tpu_torch.train import d_step, g_step, g_step_pl

    state = train_state_on_card(model, train)
    data = SyntheticDataset(model.resolution, model.img_channels).batches(
        TRAIN_BATCH, seed=4)
    batches = [torch.from_numpy(next(data)["image"]).cuda() for _ in range(4)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts, _, losses = reg_counted_step(
        lambda: g_step_pl(state, 0, TRAIN_BATCH), "g_step_pl", calls, second,
        model.dtype, "Loss/G/pl")
    peak = torch.cuda.max_memory_allocated()
    print(f"  losses {losses}; pl_mean {float(state.pl_mean):.4f}; peak "
          f"device memory of the step {peak / 2**30:.2f} GiB", flush=True)
    check_grads(state, ("G",))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ms = {"g_step_pl": [], "g_step": [], "d_step": []}
    for it in range(1, 4):
        ev[0].record()
        g_step_pl(state, it, TRAIN_BATCH)
        ev[1].record()
        g_step(state, it, TRAIN_BATCH)
        ev[2].record()
        d_step(state, batches[it], it)
        ev[3].record()
        torch.cuda.synchronize()
        for i, name in enumerate(ms):
            ms[name].append(ev[i].elapsed_time(ev[i + 1]))
        print(f"  iteration {it}: " + ", ".join(
            f"{k} {v[-1]:.2f} ms" for k, v in ms.items())
            + " (CUDA events)", flush=True)
    profile(lambda: g_step_pl(state, 9, TRAIN_BATCH), "one g_step_pl")
    return counts, peak, {k: sum(v) / len(v) for k, v in ms.items()}


def _is_attention_leaf(name: str) -> bool:
    return "_attn." in name or "_wattn" in name or "d_queries" in name


def _key_bias(name: str) -> bool:
    """A bias added to every key of an attention: softmax over the keys is
    invariant to it, so its exact gradient is zero and both sides hold
    rounding noise; it is held at the scale of its weight's gradient."""
    return name.endswith(("_k_x.b", ".k_y.b"))


def _hold_leaves(title, got, ref):
    """Each leaf's max |err| relative to its max |host|, held to
    GRAD_TOL; prints the median and the five worst, of all leaves and of
    the attention leaves apart."""
    rel, unused = [], []
    for name, r in ref.items():
        g = got[name]
        scale = float((ref[name[:-1] + "w"] if _key_bias(name) else r)
                      .abs().max())
        err = float((g - r).abs().max())
        if scale == 0.0 and err == 0.0:
            unused.append(name)      # noise off: the strengths are unused
            continue
        if not (math.isfinite(err) and err <= GRAD_TOL * scale):
            fail(f"{title}: gradient {name}: card vs host max|err| "
                 f"{err:.3e} > tol {GRAD_TOL * scale:.3e}")
        rel.append((err / scale, name))
    rel.sort(reverse=True)
    print(f"  {title}: {len(rel)} leaves within {GRAD_TOL} of the leaf's "
          f"max |host| ({len(unused)} zero on both sides: noise strengths, "
          f"unused with noise off); median {rel[len(rel) // 2][0]:.3e}, "
          f"worst " + ", ".join(f"{r:.3e} ({n})" for r, n in rel[:5]),
          flush=True)
    attn = [(r, n) for r, n in rel if _is_attention_leaf(n)]
    if attn:
        print(f"    of them {len(attn)} attention leaves: median "
              f"{attn[len(attn) // 2][0]:.3e}, worst "
              + ", ".join(f"{r:.3e} ({n})" for r, n in attn[:5]),
              flush=True)


def grads_compare(model, train):
    """fp32 at batch 2, noise and mixing off, the card (kernels) against
    the host (plain path), every gradient leaf: one d_step and one g_step
    end to end, from the model's own init (the ReZero gates of the
    attention styles at 0); then G alone, both sides given the host's
    gradient of the g_step loss wrt the images, which takes D's
    convolutions out of the comparison, with the gates at 0.1 so the
    attention styles' weights take a gradient too.  The image gradient
    through D at random init is ill-conditioned (its lrelu kinks: the host
    alone, at 1 thread against 8, moves it by up to 2.6 % of its max), and
    with the gates at 0.1 G's end-to-end leaves inherit up to 1.3e-2 from
    it on an H100, with or without the attention kernels; G alone is
    well-conditioned at either gate value."""
    import torch

    from gansformer_tpu_torch.data import SyntheticDataset
    from gansformer_tpu_torch.losses import g_nonsaturating_loss
    from gansformer_tpu_torch.train import create_train_state, d_step, \
        draw_step, g_forward, g_step

    model = dataclasses.replace(model, dtype="float32")
    train = dataclasses.replace(train, style_mixing_prob=0.0)
    reals = torch.from_numpy(next(SyntheticDataset(
        model.resolution, model.img_channels).batches(2, seed=5))["image"])
    grads, g_only, times, ct = {}, {}, {}, None
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        state = create_train_state(model, train, seed=0, device=dev)
        d_step(state, reals, 0, noise_mode="none")
        g_step(state, 0, 2, noise_mode="none")
        grads[dev] = {k: g.detach().float().cpu()
                      for k, g in _named_grads(state).items()}
        times[dev] = time.perf_counter() - t0
        state = create_train_state(model, train, seed=0, device=dev)
        perturb(state.generator)
        gen = state.generator
        imgs, _ = g_forward(gen, draw_step(state, 0, "g", 2,
                                           noise_mode="none"), "none")
        if ct is None:                               # the host's gradient
            loss = g_nonsaturating_loss(state.discriminator(imgs))
            (ct,) = torch.autograd.grad(loss, [imgs], retain_graph=True)
        names = [n for n, _ in gen.named_parameters()]
        gs = torch.autograd.grad(imgs, list(gen.parameters()), ct.to(dev),
                                 allow_unused=True)
        g_only[dev] = {f"G/{n}": (torch.zeros(p.shape) if g is None
                                  else g.detach().float().cpu())
                       for n, p, g in zip(names, gen.parameters(), gs)}
    for net in ("D", "G"):
        keep = [k for k in grads["cpu"] if k.startswith(net + "/")]
        _hold_leaves(f"d_step + g_step, {net}",
                     {k: grads["cuda"][k] for k in keep},
                     {k: grads["cpu"][k] for k in keep})
    _hold_leaves("G alone given the host's image gradient", g_only["cuda"],
                 g_only["cpu"])
    print(f"  one d_step + one g_step: card {times['cuda']:.1f} s, host "
          f"{times['cpu']:.1f} s", flush=True)


# The card's fp32 gradient of a leaf against the host's float64 reference
# (ROADMAP C.2): it passes within GRAD_TOL of the leaf's max |reference|,
# or within REF_HOST_FACTOR times the host fp32's own error on that leaf.
# At random init an lrelu input within fp32 rounding of zero takes either
# slope, so a leaf's fp32 error depends on the rounding a run lands on:
# the host's error is the larger of two fp32 samples, on the inputs and
# on the same inputs at another fp32 rounding (``perturbed``).  On the
# ffhq256-duplex D with attention the R1 penalty's D/b8_conv0.b reads
# 1.03e-2 of its scale in the first sample and 6.83e-2 in the second,
# where float64 moves 1.29e-5 for the same change of its inputs, and the
# card read 3.31e-3 and 3.56e-2 of it in two runs (r1_reference.py and
# chip_smoke.py on an H100).
REF_HOST_FACTOR = 2.0
REF_ROUNDOFF = 2.0 ** -24
REF_SEED = 7


def perturbed(x, seed: int = REF_SEED):
    """``x`` at another fp32 rounding: each entry scaled by 1 +
    REF_ROUNDOFF e, e ~ N(0, 1) from ``seed``, in float64, then cast back
    to ``x``'s dtype."""
    import torch

    e = torch.randn(x.shape, generator=torch.Generator().manual_seed(seed),
                    dtype=torch.float64)
    return (x.double() * (1.0 + REF_ROUNDOFF * e)).to(x.dtype)


def _bare_once(cls, bare):
    """A context in which the first ``cls.apply`` runs ``bare`` instead,
    outside the Function: its value is right and the second order through
    it is silently lost, as a ctypes launch in a backward would lose it.
    Yields a list that holds one entry once the fault was planted."""
    import contextlib

    @contextlib.contextmanager
    def planted():
        apply, done = cls.apply, []

        def bare_once(*a):
            if done:
                return apply(*a)
            done.append(1)
            return bare(*a)

        cls.apply = staticmethod(bare_once)
        try:
            yield done
        finally:
            del cls.apply                  # the inherited classmethod again
    return planted()


def planted_second_order_drop():
    """The first adjoint launch of an image gradient runs bare, outside
    ``UpfirdnAdjointFunction`` (``_bare_once``)."""
    import importlib

    ufd = importlib.import_module("gansformer_tpu_torch.ops.upfirdn2d")
    return _bare_once(ufd.UpfirdnAdjointFunction, ufd.upfirdn2d_adjoint)


def planted_modconv_second_order_drop():
    """The first modconv gradient of a backward (in a g_step_pl the last
    tRGB's, in path length's gradient) runs bare, outside
    ``ModconvGradsFunction`` (``_bare_once``): kernels 5 and 6 give the
    right first order, and that layer's second order is lost."""
    import importlib

    mc = importlib.import_module("gansformer_tpu_torch.ops.modulated_conv")
    return _bare_once(mc.ModconvGradsFunction, mc.modconv_core_grads)


def host_fakes(model, train):
    """G's images of a d_step at iteration 0 (batch 2, noise off, the
    gates at 0.1, seed 0) by the host's float64 path."""
    import torch

    from gansformer_tpu_torch.train import create_train_state, draw_step, \
        g_forward

    state = create_train_state(dataclasses.replace(model, dtype="float64"),
                               train, seed=0, device="cpu")
    perturb(state.generator)
    with torch.no_grad():
        return g_forward(state.generator, draw_step(
            state, 0, "d", 2, noise_mode="none"), "none")[0]


def reference_inputs(model, train):
    """The inputs every side of the float64-referenced checks sees: the
    reals (seed 5, batch 2, uint8) normalized in fp32 as a step does, and
    ``host_fakes`` divided by their largest |value|, so they lie in the
    reals' range.  G's raw images at this init reach |x| 33.5; on them
    D's attention logits reach 3.0e4 and float64 itself moves leaves of
    D's gradient by up to 0.2 of their scale when the images take
    another fp32 rounding (r1_reference.py), so no fp32 route can be held
    to it there.  In the reals' range the logits stay below 14 and
    float64 moves by 2e-7."""
    import torch

    from gansformer_tpu_torch.data import SyntheticDataset, normalize_images

    reals = torch.from_numpy(next(SyntheticDataset(
        model.resolution, model.img_channels).batches(2, seed=5))["image"])
    fakes = host_fakes(model, train)
    print(f"  G's images by the host's float64 path: max |x| "
          f"{float(fakes.abs().max()):.3f}, divided by it", flush=True)
    return normalize_images(reals), fakes / fakes.abs().max()


def host_branches(model, train, dtype, x, fakes):
    """D's gradient leaves of each branch of a d_step_r1's loss by the
    host's plain path in ``dtype``: the logistic loss on the reals ``x``
    ("reals") and on ``fakes`` ("fakes"), and the R1 penalty on ``x``
    ("R1", unweighted)."""
    import torch
    import torch.nn.functional as F

    from gansformer_tpu_torch.core.precision import input_dtype
    from gansformer_tpu_torch.losses import r1_penalty
    from gansformer_tpu_torch.train import create_train_state

    d = create_train_state(dataclasses.replace(model, dtype=dtype), train,
                           seed=0, device="cpu").discriminator
    x, fakes = (t.to(input_dtype(dtype)) for t in (x, fakes))
    out = {}
    for branch, loss in (("reals", lambda: F.softplus(-d(x)).mean()),
                         ("fakes", lambda: F.softplus(d(fakes)).mean()),
                         ("R1", lambda: r1_penalty(d, x))):
        grads = torch.autograd.grad(loss(), list(d.parameters()),
                                    allow_unused=True)
        out[branch] = {f"D/{n}": (torch.zeros(p.shape, dtype=torch.float64)
                                  if g is None else g.detach().double())
                       for (n, p), g in zip(d.named_parameters(), grads)}
    return out


def _reference_grads(model, train, kind, dev, dtype, plant=False,
                     fakes=None, perturb_reals=False):
    """The gradient leaves of one ``kind`` at batch 2, noise and mixing
    off, the ReZero gates at 0.1 (``perturb``), from seed 0, in ``dtype``
    on ``dev``, through the entry points: "d_step_r1" (D's), "R1 penalty"
    (D's gradient of the penalty alone: the second-order term),
    "d_step + g_step" (D's and G's).  ``fakes`` stand in for G's images
    in the d_step_r1; ``plant`` runs one image-gradient adjoint launch
    outside its Function; ``perturb_reals`` gives the step the
    normalized reals at another fp32 rounding (``perturbed``)."""
    import contextlib

    import torch

    from gansformer_tpu_torch.core.precision import input_dtype
    from gansformer_tpu_torch.data import SyntheticDataset, normalize_images
    from gansformer_tpu_torch.losses import r1_penalty
    from gansformer_tpu_torch.train import create_train_state, d_step, \
        d_step_r1, g_step, steps

    reals = torch.from_numpy(next(SyntheticDataset(
        model.resolution, model.img_channels).batches(2, seed=5))["image"])
    state = create_train_state(dataclasses.replace(model, dtype=dtype),
                               train, seed=0, device=dev)
    perturb(state.generator)
    d = state.discriminator
    saved = steps.g_forward, steps.normalize_images
    if fakes is not None:
        steps.g_forward = lambda *a: (fakes.to(dev, input_dtype(dtype)),
                                      None)
    if perturb_reals:
        steps.normalize_images = lambda u: perturbed(saved[1](u))
    try:
        with (planted_second_order_drop() if plant
              else contextlib.nullcontext([1])) as done:
            if kind == "d_step_r1":
                d_step_r1(state, reals, 0, noise_mode="none")
            elif kind == "R1 penalty":
                x = normalize_images(reals.to(dev)).to(input_dtype(dtype))
                for p, g in zip(d.parameters(), torch.autograd.grad(
                        r1_penalty(d, x), list(d.parameters()),
                        allow_unused=True)):
                    p.grad = torch.zeros_like(p) if g is None else g
            elif kind == "d_step + g_step":
                d_step(state, reals, 0, noise_mode="none")
                g_step(state, 0, 2, noise_mode="none")
            else:
                fail(f"unknown gradient kind {kind!r}")
    finally:
        steps.g_forward, steps.normalize_images = saved
    if not done:
        fail(f"{kind}: the planted fault found no adjoint launch")
    nets = ("D", "G") if kind == "d_step + g_step" else ("D",)
    return {k: g.detach().double().cpu()
            for k, g in _named_grads(state).items()
            if k.split("/")[0] in nets}


def pl_reference_inputs(model, train):
    """z (batch 2), the PL latents (batch 2 // pl_batch_shrink) and the
    projection noise of the float64-referenced path-length checks, drawn
    on the host (seed 9), so every side sees the same."""
    import torch

    gen = torch.Generator().manual_seed(9)
    pl_batch = max(1, 2 // train.pl_batch_shrink)
    shape = (model.num_ws, model.latent_dim)
    return (torch.randn((2,) + shape, generator=gen),
            torch.randn((pl_batch,) + shape, generator=gen),
            torch.randn((pl_batch, model.resolution, model.resolution,
                         model.img_channels), generator=gen))


def _pl_grads(model, train, kind, dev, dtype, inputs, plant=False):
    """G's gradient leaves of one ``kind`` at batch 2, noise and mixing
    off, the ReZero gates at 0.1, from seed 0, in ``dtype`` on ``dev``, on
    ``inputs`` (``pl_reference_inputs``): "G loss" (the non-saturating
    loss alone), "PL" (the path-length penalty alone, unweighted: G's
    second order), "g_step_pl" (the entry point).  ``plant`` runs the
    first ``ModconvGradsFunction`` bare
    (``planted_modconv_second_order_drop``)."""
    import contextlib

    import torch

    from gansformer_tpu_torch.losses import g_nonsaturating_loss
    from gansformer_tpu_torch.train import (create_train_state, draw_step,
                                            g_forward, g_step_pl, pl_term)

    state = create_train_state(dataclasses.replace(model, dtype=dtype),
                               train, seed=0, device=dev)
    perturb(state.generator)
    gen, d = state.generator, state.discriminator
    z, z_pl, noise = inputs
    with (planted_modconv_second_order_drop() if plant
          else contextlib.nullcontext([1])) as done:
        if kind == "g_step_pl":
            g_step_pl(state, 0, 2, z=z, z_pl=z_pl, pl_noise=noise,
                      noise_mode="none")
            grads = [p.grad for p in gen.parameters()]
        elif kind in ("PL", "G loss"):
            if kind == "PL":
                loss = pl_term(state, 0, 2, z_pl, noise, "none")[0]
            else:
                d.requires_grad_(False)
                fakes, _ = g_forward(gen, draw_step(state, 0, "g", 2, z,
                                                    "none"), "none")
                loss = g_nonsaturating_loss(d(fakes))
            grads = torch.autograd.grad(loss, list(gen.parameters()),
                                        allow_unused=True)
        else:
            fail(f"unknown gradient kind {kind!r}")
    if not done:
        fail(f"{kind}: the planted fault found no modconv gradient")
    return {f"G/{n}": (torch.zeros(p.shape, dtype=torch.float64)
                       if g is None else g.detach().double().cpu())
            for (n, p), g in zip(gen.named_parameters(), grads)}


def hold_to_reference(title, ref, hosts, card):
    """Each leaf of ``card`` (fp32 on the card) against ``ref`` (float64 on
    the host) by the REF_HOST_FACTOR rule, the largest error of the
    ``hosts`` runs (fp32 on the host) giving the leaf's own fp32 error;
    key biases at their weight's scale.  Prints the worst leaves of
    both; returns the leaves that fail as (name, card error,
    allowance)."""
    rows, failed, unused = [], [], 0
    for name, r in ref.items():
        scale = float((ref[name[:-1] + "w"] if _key_bias(name) else r)
                      .abs().max())
        cerr = float((card[name] - r).abs().max())
        herr = max(float((h[name] - r).abs().max()) for h in hosts)
        if scale == 0.0 and cerr == 0.0 and herr == 0.0:
            unused += 1          # noise off: the strengths are unused
            continue
        allow = max(GRAD_TOL * scale, REF_HOST_FACTOR * herr)
        ok = math.isfinite(cerr) and cerr <= allow
        if not ok:
            failed.append((name, cerr, allow))
        by_host_error = ok and cerr > GRAD_TOL * scale
        scale = max(scale, 1e-30)
        rows.append((cerr / scale, herr / scale, by_host_error, name))
    by_card = sorted(rows, reverse=True)
    by_host = sorted(rows, key=lambda r: -r[1])
    print(f"  {title}: {len(rows)} leaves ({unused} zero everywhere); "
          f"{len(rows) - len(failed)} pass, "
          f"{sum(r[2] for r in rows)} of them by the host-error clause; "
          f"card vs float64 median {by_card[len(rows) // 2][0]:.3e}, "
          "worst " + ", ".join(f"{c:.3e} ({n}; host {h:.3e})"
                               for c, h, _, n in by_card[:4])
          + "; host fp32 vs float64 worst "
          + ", ".join(f"{h:.3e} ({n})" for _, h, _, n in by_host[:3]),
          flush=True)
    return failed


def reference_compare(model, train):
    """The card's fp32 gradients against the host's float64 plain path
    (ROADMAP C.2), the host's two fp32 samples beside them:
    the R1 penalty's gradient and one d_step_r1 (D's leaves), with and
    without ``d_attention``, all through the kernels, each also with its
    planted fault (one image-gradient adjoint launch outside its
    Function), which the rule must reject wherever the penalty is held
    alone and in the d_step_r1 with ``d_attention``, whose loss R1
    dominates at this init; then one d_step + g_step end to end at
    ReZero gates 0.1 (D's and G's leaves).  fp32, batch 2, noise and
    mixing off, the inputs of ``reference_inputs``.

    The host computes each branch of the d_step_r1 loss once per model
    and side (``host_branches``): the R1 penalty's reference is its R1
    branch, the d_step_r1's the sum of the logistic branches and the
    weighted R1 branch; the card runs the entry points."""
    model = dataclasses.replace(model, dtype="float32")
    train = dataclasses.replace(train, style_mixing_prob=0.0)
    x, fakes = reference_inputs(model, train)
    weight = train.r1_gamma * 0.5 * train.d_reg_interval

    def step(br):
        return {n: br["reals"][n] + br["fakes"][n] + weight * br["R1"][n]
                for n in br["R1"]}

    def hold(title, ref, hosts, card, planted, must_reject):
        failed = hold_to_reference(title, ref, hosts, card)
        if failed:
            fail(f"{title}: card vs float64 reference: "
                 + ", ".join(f"{n} {e:.3e} > {a:.3e}" for n, e, a in
                             failed[:5]))
        if planted is None:
            return
        caught = hold_to_reference(f"{title}, planted fault", ref, hosts,
                                   planted)
        if caught:
            worst = max(caught, key=lambda c: c[1] / c[2])
            print(f"  {title}: planted second-order drop rejected at "
                  f"{len(caught)} leaves, worst {worst[0]} {worst[1]:.3e} > "
                  f"{worst[2]:.3e}", flush=True)
        elif must_reject:
            fail(f"{title}: the planted second-order drop passes the rule")
        else:
            print(f"  {title}: the planted second-order drop stays within "
                  "the rule here: the regularizer is a small part of this "
                  "step's gradient at this init (the penalty's own "
                  "gradient is held above)", flush=True)

    for m, tag in ((model, ""),
                   (dataclasses.replace(model, d_attention=True),
                    " with d_attention")):
        t0 = time.perf_counter()
        ref = host_branches(m, train, "float64", x, fakes)
        t1 = time.perf_counter()
        hosts = [host_branches(m, train, "float32", x, fakes),
                 host_branches(m, train, "float32", perturbed(x),
                               perturbed(fakes.float()))]
        t2 = time.perf_counter()
        cards = {(kind, plant): _reference_grads(
            m, train, kind, "cuda", "float32", plant=plant, fakes=fakes)
            for kind in ("R1 penalty", "d_step_r1") for plant in (False,
                                                                  True)}
        print(f"  D{tag}: host float64 {t1 - t0:.1f} s, host fp32 (two "
              f"samples) {t2 - t1:.1f} s, card (four runs) "
              f"{time.perf_counter() - t2:.1f} s", flush=True)
        hold(f"R1 penalty{tag}", ref["R1"], [h["R1"] for h in hosts],
             cards["R1 penalty", False], cards["R1 penalty", True], True)
        hold(f"d_step_r1{tag}", step(ref), [step(h) for h in hosts],
             cards["d_step_r1", False], cards["d_step_r1", True],
             bool(tag))
    pl_reference_compare(model, train, hold)
    kind = "d_step + g_step"
    title = f"{kind}, gates 0.1"
    t0 = time.perf_counter()
    ref = _reference_grads(model, train, kind, "cpu", "float64")
    t1 = time.perf_counter()
    hosts = [_reference_grads(model, train, kind, "cpu", "float32",
                              perturb_reals=p) for p in (False, True)]
    t2 = time.perf_counter()
    card = _reference_grads(model, train, kind, "cuda", "float32")
    print(f"  {title}: host float64 {t1 - t0:.1f} s, host fp32 (two "
          f"samples) {t2 - t1:.1f} s, card {time.perf_counter() - t2:.1f} "
          "s", flush=True)
    hold(title, ref, hosts, card, None, False)


def pl_reference_compare(model, train, hold):
    """Path length against the host's float64 plain path (fp32, batch 2,
    the PL batch 2 // pl_batch_shrink, noise and mixing off, the gates at
    0.1): the penalty's own gradient (G's second order) and one g_step_pl
    (the non-saturating loss plus pl_weight * g_reg_interval times the
    penalty), every card side through the kernels, the host computing
    each branch once per side, the host's fp32 error the larger of two
    samples (on the inputs and on them at another fp32 rounding); each
    with its planted fault (one ``ModconvGradsFunction`` run bare), which
    the rule must reject, the penalty being a large part of the step's
    gradient at this init.  ``hold`` is ``reference_compare``'s."""
    inputs = pl_reference_inputs(model, train)
    weight = train.pl_weight * train.g_reg_interval

    def branches(dtype, ins):
        return {k: _pl_grads(model, train, k, "cpu", dtype, ins)
                for k in ("G loss", "PL")}

    def step(br):
        return {n: br["G loss"][n] + weight * br["PL"][n] for n in br["PL"]}

    t0 = time.perf_counter()
    ref = branches("float64", inputs)
    t1 = time.perf_counter()
    hosts = [branches("float32", inputs),
             branches("float32", tuple(perturbed(t) for t in inputs))]
    t2 = time.perf_counter()
    cards = {(kind, plant): _pl_grads(model, train, kind, "cuda", "float32",
                                      inputs, plant=plant)
             for kind in ("PL", "g_step_pl") for plant in (False, True)}
    print(f"  path length (res {model.resolution}, PL batch "
          f"{inputs[1].shape[0]}): host float64 {t1 - t0:.1f} s, host fp32 "
          f"(two samples) {t2 - t1:.1f} s, card (four runs) "
          f"{time.perf_counter() - t2:.1f} s", flush=True)
    hold("path-length penalty", ref["PL"], [h["PL"] for h in hosts],
         cards["PL", False], cards["PL", True], True)
    hold("g_step_pl", step(ref), [step(h) for h in hosts],
         cards["g_step_pl", False], cards["g_step_pl", True], True)


def _demangled_name(mangled: str) -> str:
    """The function name of an Itanium-mangled kernel symbol (the last
    length-prefixed name of its nested name), with its bf16/float
    template argument."""
    i, name = (3 if mangled.startswith("_ZN") else 2), mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    rest = mangled[i:]
    if rest.startswith("I13__nv_bfloat16"):
        name += "<bf16>"
    elif rest.startswith("If"):
        name += "<float>"
    else:
        import re

        ints = re.match(r"I((?:Li\d+E)+)E", rest)
        if ints:
            name += "<" + ",".join(re.findall(r"Li(\d+)E", ints.group(1))) \
                + ">"
    return name


def ptxas_summary(log: str):
    """(kernel, registers, spill-store bytes) of each kernel in an nvcc
    log built with ``-Xptxas -v``."""
    import re

    out, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = _demangled_name(m.group(1)), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def sass_counts(lib_path: str, opcode: str):
    """{kernel: instructions of ``opcode``} of each kernel in the built
    library's SASS (``cuobjdump -sass``): HGMMA is the proof that a kernel
    issues wgmma, HMMA that it issues mma.sync."""
    import re

    from gansformer_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump -sass failed: {out.stderr.strip()[-500:]}")
    counts, name = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _demangled_name(m.group(1))
            counts.setdefault(name, 0)
        elif name and re.search(rf"\b{opcode}\.", line):
            counts[name] += 1
    return counts


def check_bwd_configs(calls):
    """The built library's dx tile and dynamic shared memory of every
    modconv backward launch agree with the wrapper's (which sizes the ds
    partials and refuses a launch above the card's limit)."""
    import torch

    from gansformer_tpu_torch.ops import _build, cuda_modconv
    from gansformer_tpu_torch.ops import modulated_conv as mc

    lib = _build.load_library()
    for c in calls:
        if c["kernel"] not in ("modconv_dx", "modconv_dw"):
            continue
        cok = c["Co"] * (4 if c["kind"] == "poly" else 1)
        which = "dx" if c["kernel"] == "modconv_dx" else "dw"
        taps = (mc.adjoint_taps(c["kind"]) if which == "dx"
                else cuda_modconv.TAPS[c["kind"]])
        for dtype in (torch.float32, torch.bfloat16):
            path = cuda_modconv.bwd_path(which, dtype, cok, c["Ci"], c["H"],
                                         taps)
            hw = c["H"] * c["H"]
            got = (lib.gt_modconv_bwd_smem(which == "dw", path, cok,
                                           c["Ci"], hw),
                   lib.gt_modconv_dx_tile(path))
            want = (cuda_modconv.bwd_smem(which, path, cok, c["Ci"], hw),
                    cuda_modconv.TILE_PIXELS[path])
            if got != want:
                fail(f"{c['label']} {which} {dtype}: the library's (smem, "
                     f"dx tile) {got} != the wrapper's {want}")


def check_fwd_configs(calls):
    """The built library's tile and dynamic shared memory of every modconv
    forward launch agree with the wrapper's (which sizes the split's
    partials and refuses a launch above the card's limit), in both
    dtypes."""
    import torch

    from gansformer_tpu_torch.ops import _build, cuda_modconv

    lib = _build.load_library()
    for c in calls:
        if c["kernel"] != "modconv":
            continue
        cok = c["Co"] * cuda_modconv.PHASES[c["kind"]]
        for dtype in (torch.float32, torch.bfloat16):
            path, _ = fwd_plan(c, dtype)
            got = (lib.gt_modconv_fwd_smem(path, cok),
                   lib.gt_modconv_fwd_tile(path))
            want = (cuda_modconv.fwd_smem(path, cok),
                    cuda_modconv.FWD_TILE_PIXELS[path])
            if got != want:
                fail(f"{c['label']} forward {dtype}: the library's (smem, "
                     f"tile) {got} != the wrapper's {want}")


def check_attn_ufd_configs(calls):
    """The built library's plan (route, tile, shared memory; for
    latent->grid and the grid->latent backward also the tiles a span, the
    spans and the ring's stages) of every upfirdn launch (forward and
    adjoint), every grid->latent launch and every latent->grid launch
    (forward and backward each) of ``calls`` agrees with the wrapper's,
    in both dtypes."""
    import ctypes

    import torch

    from gansformer_tpu_torch.ops import _build, cuda_attention, cuda_upfirdn

    lib = _build.load_library()
    ca = cuda_attention
    for c in calls:
        for dtype in (torch.float32, torch.bfloat16):
            code = _build.DTYPE_CODES[str(dtype)[6:]]
            if c["kernel"] in ("upfirdn", "upfirdn_adjoint"):
                up, down = c["up"], c.get("down", 1)
                if c["kernel"] == "upfirdn_adjoint":
                    up, down = down, up
                got = (ctypes.c_int * 12)()
                lib.gt_ufd_plan(code, c["C"], up, down, 4, 4, got)
                want = tuple(cuda_upfirdn.ufd_plan(dtype, c["C"], up, down,
                                                   4, 4))
            elif c["kernel"] == "grid_to_latent":
                b, n, l, d, dv = c["B"], c["Lq"], c["Lk"], c["D"], c["Dv"]
                got = (ctypes.c_int * 5)()
                lib.gt_g2l_plan(code, b, n, l, d, dv, got)
                path = ca.g2l_path(dtype, l, d, dv)
                mma = path == ca.G2L_MMA
                want = (path, ca.g2l_lp(l) if mma else 0,
                        ca.g2l_tiles_per_warp(b, n) if mma else 0,
                        ca.g2l_rows_per_block(path, b, n),
                        ca.g2l_smem(path, l, d, dv))
            elif c["kernel"] in ("latent_to_grid", "latent_to_grid_bwd"):
                got = (ctypes.c_int * 7)()
                fn = (lib.gt_l2g_plan if c["kernel"] == "latent_to_grid"
                      else lib.gt_l2g_bwd_plan)
                fn(code, c["B"], c["Lk"], c["Lq"], c["D"], c["Dv"], got)
                want = l2g_call_plan(c, dtype)
            elif c["kernel"] == "grid_to_latent_bwd":
                got = (ctypes.c_int * 7)()
                lib.gt_g2l_bwd_plan(code, c["B"], c["Lq"], c["Lk"], c["D"],
                                    c["Dv"], got)
                want = g2l_bwd_call_plan(c, dtype)
            else:
                continue
            if tuple(got) != want:
                fail(f"{c['label']} {c['kernel']} {dtype}: the library's "
                     f"plan {tuple(got)} != the wrapper's {want}")


# The kernels of this round's redesigns: ptxas must report no spill in
# them, those that run wgmma must show HGMMA in their SASS, and those
# that run mma.sync HMMA.
NO_SPILL = ("fwd_wgmma_kernel", "fwd_reduce_kernel", "fwd_smallk_kernel",
            "dx_wgmma_kernel", "dw_wgmma_kernel", "dx_smallk_kernel",
            "dw_smallk_kernel", "g2l_mma_kernel", "ufd_tile_kernel",
            "ufd_smallc_kernel", "l2g_mma_kernel", "l2g_bwd_mma_kernel",
            "g2l_bwd_mma_kernel", "g2l_bwd_kernel")
WGMMA_KERNELS = ("fwd_wgmma_kernel", "dx_wgmma_kernel", "dw_wgmma_kernel")
MMA_KERNELS = ("g2l_mma_kernel", "l2g_mma_kernel", "l2g_bwd_mma_kernel",
               "g2l_bwd_mma_kernel")
# The presets beside ffhq256-duplex, each driven once at its new launch
# shapes; bedroom256-duplex is ffhq256-duplex's ModelConfig field for
# field.
PRESET_PHASES = ("cityscapes256-duplex", "ffhq1024-duplex",
                 "clevr64-simplex")


def call_key(call, dtype_name: str):
    """What defines a launch's shape (every field but its label and
    phase), in a dtype."""
    return (dtype_name,) + tuple(sorted(
        (k, v) for k, v in call.items() if k not in ("label", "phase")))


def checked_train_calls(calls):
    """Of a d_step + g_step plan, the launches the smoke holds against
    their plain versions: every backward launch, every forward attention
    launch that writes lse, and D's forward upfirdn launches."""
    return [c for c in calls if c["kernel"] in TRAIN_KERNELS
            or c["label"].startswith("D") or c.get("lse")]


def synthesize_once(cfg, calls):
    """One ``synthesize`` of ``cfg`` from a random init (seed 0) at the
    batch of ``calls``, the counters reset just before and held to the
    plan just after; finite images of the right shape."""
    import torch

    from gansformer_tpu_torch import ops
    from gansformer_tpu_torch.serve import ServePrograms, init_generator

    batch = calls[0]["B"]
    bundle = init_generator(cfg, seed=0, device="cuda")
    perturb(bundle.generator)
    progs = ServePrograms(bundle)
    seeds = list(range(300, 300 + batch))
    ws = progs.map_seeds(seeds)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    img = progs.synthesize(ws, [0.7, 1.0] * (batch // 2), seed=7, tags=seeds)
    torch.cuda.synchronize()
    got = ops.launch_counts()
    check_path_counts(ops.path_launch_counts(), calls, cfg.dtype,
                      "synthesize")
    want = {k: sum(c["kernel"] == k for c in calls) for k in REPLACES}
    if tuple(img.shape) != (batch, cfg.resolution, cfg.resolution,
                            cfg.img_channels):
        fail(f"synthesize: image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        fail("synthesize: non-finite pixels")
    if got != want:
        fail(f"synthesize: launches {got} != the plan's {want}")
    print(f"  synthesize at batch {batch}: images {tuple(img.shape)} finite, "
          f"launches {got}", flush=True)
    del bundle, progs


def check_general_route(peaks):
    """upfirdn's general route, which no preset launch takes, held once at
    a shape only it takes (a 3x3 filter), with its routes counted; and
    the attention tensor-core kernels once each at a shape no preset
    makes: grid->latent at n not a multiple of 16, L padded from 20 to
    32; latent->grid, forward and backward, at n 1000 (a ragged last
    tile, three spans at batch 3) with L padded from 20 to 32; the
    grid->latent backward at both (n 200 in one span, n 1000 in three)."""
    from gansformer_tpu_torch import ops

    call = dict(kernel="upfirdn", label="b64 3x3 filter (general route)",
                B=8, H=64, C=64, up=1, pads=(1, 1, 1, 1), taps=(1, 2, 1),
                gain=1.0)
    import torch

    print("upfirdn's general route, bf16:", flush=True)
    case = build_case(call, torch.bfloat16,
                      torch.Generator(device="cuda").manual_seed(0))
    ops.reset_launch_counts()
    case["kernel"]()
    got = {k: v for k, v in ops.path_launch_counts().items()
           if k.startswith("upfirdn")}
    if got != dict(upfirdn_general=1, upfirdn_tile=0, upfirdn_smallc=0):
        fail(f"the 3x3 filter took the routes {got}")
    del case
    check_kernels([call], "bfloat16", peaks)
    tail = dict(kernel="grid_to_latent", label="n 200, L 20 (tails)", B=3,
                Lq=200, Lk=20, D=64, Dv=128, lse=True)
    print("grid->latent's tensor-core kernel at a row tail and a latent "
          "count off its buckets, bf16:", flush=True)
    check_kernels([tail], "bfloat16", peaks)
    l2g = dict(kernel="latent_to_grid", label="n 1000, L 20 (tails)", B=3,
               Lq=20, Lk=1000, D=128, Dv=256, lse=True)
    l2g_bwd = dict(l2g, kernel="latent_to_grid_bwd", lse=False)
    print("latent->grid's tensor-core kernels, forward and backward, at a "
          "ragged last tile, several spans and a latent count off its buckets "
          f"(plans {l2g_call_plan(l2g, torch.bfloat16)}, "
          f"{l2g_call_plan(l2g_bwd, torch.bfloat16)}), bf16:", flush=True)
    check_attn_ufd_configs([l2g, l2g_bwd])
    ops.reset_launch_counts()
    check_kernels([l2g, l2g_bwd], "bfloat16", peaks)
    got = {k: v for k, v in ops.path_launch_counts().items()
           if k.startswith("latent_to_grid")}
    if got["latent_to_grid_simt"] or got["latent_to_grid_bwd_simt"] or \
            not (got["latent_to_grid_mma"] and got["latent_to_grid_bwd_mma"]):
        fail(f"the ragged latent->grid launches took the routes {got}")
    g2l_bwd = [dict(tail, kernel="grid_to_latent_bwd", lse=False),
               dict(l2g, kernel="grid_to_latent_bwd", Lq=1000, Lk=20,
                    lse=False)]
    print("grid->latent's backward tensor-core kernel at a row tail, a "
          "ragged last tile, several spans and a latent count off its "
          f"buckets (plans {[g2l_bwd_call_plan(c, torch.bfloat16) for c in g2l_bwd]}"
          "), bf16:", flush=True)
    check_attn_ufd_configs(g2l_bwd)
    ops.reset_launch_counts()
    check_kernels(g2l_bwd, "bfloat16", peaks)
    got = ops.path_launch_counts()
    if got["grid_to_latent_bwd_simt"] or not got["grid_to_latent_bwd_mma"]:
        fail(f"the ragged grid->latent backward launches took the routes "
             f"{got}")


def preset_phase(name, peaks, held):
    """One preset beside ffhq256-duplex at batch ``TRAIN_BATCH`` in its
    own dtype: every launch of one synthesize and of one d_step + g_step
    at a shape no earlier phase held, kernel against plain; then the
    synthesize and the two steps with the counters held to their plans,
    finite losses and every gradient leaf finite and nonzero.  Adds the
    shapes it held to ``held``."""
    import torch

    from gansformer_tpu_torch.core import get_preset, get_train_preset
    from gansformer_tpu_torch.data import SyntheticDataset

    t0 = time.perf_counter()
    model = get_preset(name)
    train = dataclasses.replace(get_train_preset(name),
                                batch_size=TRAIN_BATCH)
    serve = main_path_calls(model, TRAIN_BATCH)
    tcalls = train_path_calls(model, TRAIN_BATCH)
    plan = {p: plan_counts(tcalls, p) for p in ("d_step", "g_step")}
    per_synth = {k: sum(c["kernel"] == k for c in serve)
                 for k in SERVE_KERNELS}
    print(f"{name} ({model.dtype}, batch {TRAIN_BATCH}, {model.attention} "
          f"attention, {model.components} components, res "
          f"{model.resolution}): launches per synthesize {per_synth}; "
          f"d_step + g_step plan {plan}", flush=True)
    check_fwd_configs(serve)
    check_bwd_configs(tcalls)
    check_attn_ufd_configs(serve + tcalls)
    new, seen = [], set()
    for c in serve + checked_train_calls(tcalls):
        key = call_key(c, model.dtype)
        if key not in held and key not in seen:
            seen.add(key)
            new.append(c)
    print(f"  {len(new)} launch shapes no earlier phase held, kernel vs "
          f"plain, {model.dtype}:", flush=True)
    check_kernels(new, model.dtype, peaks)
    held |= seen
    torch.cuda.empty_cache()
    synthesize_once(model, serve)
    state = train_state_on_card(model, train)
    reals = torch.from_numpy(next(SyntheticDataset(
        model.resolution, model.img_channels).batches(TRAIN_BATCH,
                                                      seed=2))["image"]).cuda()
    _, _, losses = counted_steps(state, reals, tcalls, model.dtype)
    print(f"  losses {losses}", flush=True)
    check_grads(state)
    del state, reals
    torch.cuda.empty_cache()
    print(f"  {name} phase took {time.perf_counter() - t0:.1f} s",
          flush=True)


LOOP_PRESET = "ffhq256-duplex"
LOOP_IMAGES = 256            # procedural 256^2 images written as TFRecords
LOOP_KIMG = 2                # run C resumes run B's tick 0 to this
LOOP_SPANS = ("data_wait", "h2d", "step", "tick_fetch", "snapshot",
              "checkpoint", "ckpt/save")


def write_loop_dataset(root: str, resolution: int) -> str:
    """``LOOP_IMAGES`` procedural images (the port's ``SyntheticDataset``)
    written as the reference's multi-resolution TFRecords by the port's
    writer; returns the directory."""
    import numpy as np

    from gansformer_tpu_torch.data import SyntheticDataset, export_images

    out = os.path.join(root, "tfrecords")
    t0 = time.perf_counter()
    imgs = SyntheticDataset(resolution)._make(np.arange(LOOP_IMAGES))
    t1 = time.perf_counter()
    export_images(imgs, out, "smoke", resolution)
    size = sum(os.path.getsize(os.path.join(out, f))
               for f in os.listdir(out))
    print(f"  {LOOP_IMAGES} images made in {t1 - t0:.2f} s, written as "
          f"TFRecords ({size / 2**20:.1f} MiB, every level of detail) in "
          f"{time.perf_counter() - t1:.2f} s", flush=True)
    return out


def read_ticks(run_dir: str):
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def check_ticks(ticks, what: str):
    """Every numeric stat of every tick finite, the phases summing to the
    tick."""
    for rec in ticks:
        bad = {k: v for k, v in rec.items() if isinstance(v, (int, float))
               and not math.isfinite(v)}
        if bad:
            fail(f"{what}: non-finite stats {bad}")
        phases = sum(v for k, v in rec.items()
                     if k.startswith("timing/phase/"))
        if abs(phases - rec["timing/sec_per_tick"]) > \
                0.05 * rec["timing/sec_per_tick"] + 0.05:
            fail(f"{what}: phases sum to {phases:.3f} s, the tick took "
                 f"{rec['timing/sec_per_tick']:.3f} s")


def print_tick(rec, label: str, card: str):
    phases = {k.split("/")[-1]: v for k, v in rec.items()
              if k.startswith("timing/phase/")}
    print(f"  {label}: tick {int(rec['Progress/tick'])} to kimg "
          f"{rec['Progress/kimg']}: sec_per_tick "
          f"{rec['timing/sec_per_tick']:.3f}, img_per_sec "
          f"{rec['timing/img_per_sec']:.2f} "
          f"({rec['timing/img_per_sec'] / 1000:.5f} kimg/s), data_wait_s "
          f"{rec['timing/data_wait_s']:.4f}, data_wait_frac "
          f"{rec['timing/data_wait_frac']:.5f} ({card})", flush=True)
    print("    phase self times (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(phases.items(),
                                          key=lambda kv: -kv[1])),
        flush=True)
    print("    losses: " + ", ".join(f"{k} {v:.4f}" for k, v in rec.items()
                                     if k.startswith("Loss/")), flush=True)


class SyncRecorder:
    """The host syncs of a stretch of the run, from
    ``torch.cuda.set_sync_debug_mode('warn')``: each warning is kept with
    the loop's span open on the thread at that moment."""

    def __init__(self):
        self.events = []

    def __enter__(self):
        import threading
        import warnings

        import torch

        from gansformer_tpu_torch.obs import get_tracer

        tracer = get_tracer()
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.simplefilter("always")

        main = threading.main_thread()

        def show(message, category, filename, lineno, file=None,
                 line=None):
            stack = tracer._stack()
            if threading.current_thread() is not main:
                where = "backward"    # autograd's device thread
            else:
                where = stack[0][0] if stack else "(outside)"
            self.events.append((where,
                                f"{os.path.relpath(filename)}:{lineno}",
                                str(message)[:80]))
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode("default")
        self._warnings.__exit__(*exc)

    def syncs(self):
        """The events that are syncs (not the mode's own notice that it
        is a prototype, which it gives when it is turned on)."""
        return [e for e in self.events
                if "debug mode is a prototype" not in e[2]]

    def by_span(self):
        out = {}
        for top, _, _ in self.syncs():
            out[top] = out.get(top, 0) + 1
        return out

    def sites(self):
        out = {}
        for top, where, _ in self.syncs():
            out[f"{top} {where}"] = out.get(f"{top} {where}", 0) + 1
        return out


def start_run_b():
    """The loop phase's setup and run B, started in the background: the
    native host ops must load; ``LOOP_IMAGES`` images are written as
    TFRecords; then a process of the train CLI on ``LOOP_PRESET`` from
    them, armed with ``sigterm@tick:tick=0``.  Returns what
    ``loop_phase`` needs to finish it; the process and the temporary
    directory go at exit whatever happens."""
    import atexit
    import shutil
    import tempfile

    from gansformer_tpu_torch import native
    from gansformer_tpu_torch.core.config import get_experiment_preset

    lib = native.get_lib()
    if lib is None:
        fail(f"the native host ops did not load: {native.build_info}")
    info = native.build_info
    how = (f"built in {info['seconds']:.2f} s" if info["built"]
           else "cached")
    print(f"  native host ops: {os.path.relpath(info['path'])} ({how}; g++ "
          f"{' '.join(native.CXX_FLAGS)})", flush=True)
    exp = get_experiment_preset(LOOP_PRESET)
    root = tempfile.mkdtemp(prefix="gansformer_smoke_loop_")
    atexit.register(shutil.rmtree, root, ignore_errors=True)
    data = write_loop_dataset(root, exp.model.resolution)
    exp = dataclasses.replace(
        exp, data=dataclasses.replace(exp.data, path=data),
        train=dataclasses.replace(exp.train, total_kimg=LOOP_KIMG,
                                  kimg_per_tick=1, snapshot_ticks=1,
                                  image_snapshot_ticks=1))
    t = exp.train
    cfg_path = os.path.join(root, "config.json")
    with open(cfg_path, "w") as f:
        f.write(exp.to_json())
    run = os.path.join(root, "run")
    env = dict(os.environ, GANSFORMER_TPU_FAULTS="sigterm@tick:tick=0",
               GANSFORMER_TPU_FAULT_LEDGER=os.path.join(
                   root, "faults_fired.jsonl"))
    print(f"  run B: {LOOP_PRESET}, batch {t.batch_size}, "
          f"{exp.model.dtype}, r1_gamma {t.r1_gamma} every "
          f"{t.d_reg_interval}, path length every {t.g_reg_interval}, "
          f"1-kimg ticks, armed with {env['GANSFORMER_TPU_FAULTS']}; "
          f"started beside the host's float64 reference phases (its "
          f"times share the host's cores with them)", flush=True)
    log = open(os.path.join(root, "run_b.out"), "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gansformer_tpu_torch.cli.train",
         "--config", cfg_path, "--run-dir", run], env=env, stdout=log,
        stderr=subprocess.STDOUT, text=True)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    atexit.register(stop)
    return dict(exp=exp, root=root, run=run, proc=proc, log=log,
                t0=time.time())


def print_h2d(rec, peak):
    """The tick's h2d (the batches' copies from pinned memory, on the
    loop thread) and the run's peak memory."""
    print(f"    h2d: timing/phase/h2d {rec['timing/phase/h2d']:.4f} s; "
          f"peak device memory {peak / 2**30:.2f} GiB", flush=True)


def loop_phase(card: str, b: dict):
    """The tick loop of ffhq256-duplex as the preset has it (batch 32,
    bf16, R1 every 16 iterations, path length every 4) on TFRecords, with
    1-kimg ticks and a snapshot and a checkpoint every tick.  Run B
    (``start_run_b``) must exit with EXIT_PREEMPTED after its tick-0
    checkpoint; its checkpoint round-trips bit for bit; run C (the CLI's
    ``--resume`` in this process, counters reset just before and read
    just after) resumes at B's step and data position and runs to
    ``LOOP_KIMG``, its launches held to the plan of its iterations and
    snapshots; run D resumes C for 4 iterations under
    ``torch.cuda.set_sync_debug_mode``.  Prints the ticks' timing, the
    checkpoints' times and size, C's peak memory and D's host syncs."""
    import numpy as np
    import torch

    from gansformer_tpu_torch import ops
    from gansformer_tpu_torch.cli import train as train_cli
    from gansformer_tpu_torch.supervise.events import EXIT_PREEMPTED
    from gansformer_tpu_torch.train import checkpoint as ckpt
    from gansformer_tpu_torch.train import create_train_state
    from gansformer_tpu_torch.utils.image import decode_png

    exp, root, run = b["exp"], b["root"], b["run"]
    t = exp.train
    ckpt_dir = os.path.join(run, "checkpoints")
    try:
        rc = b["proc"].wait(timeout=600)
    except subprocess.TimeoutExpired:
        b["proc"].kill()
        fail("run B did not end within 600 s")
    if rc != EXIT_PREEMPTED:
        b["log"].seek(0)
        print(b["log"].read()[-6000:])
        fail(f"run B exited {rc}, not EXIT_PREEMPTED "
             f"({EXIT_PREEMPTED})")
    b_step = ckpt.latest_step(ckpt_dir)
    b_ticks = read_ticks(run)
    check_ticks(b_ticks, "run B")
    b_log = open(os.path.join(run, "log.txt")).read()
    if "preemption checkpoint @ step" not in b_log:
        fail("run B wrote no preemption line in log.txt")
    per_tick = -(-1000 // t.batch_size) * t.batch_size
    if b_step != per_tick or len(b_ticks) != 1:
        fail(f"run B: checkpoint at step {b_step}, {len(b_ticks)} "
             f"ticks; expected step {per_tick} after one tick")
    with open(os.path.join(run, "heartbeat-p0.json")) as f:
        b_s = json.load(f)["time"] - b["t0"]      # its last beat
    print(f"  run B exited {rc} (EXIT_PREEMPTED), its last heartbeat "
          f"{b_s:.1f} s after its start (process start, setup, one tick, "
          f"the preemption), checkpoint at step {b_step}", flush=True)
    print_tick(b_ticks[0], "run B", card)

    # the checkpoint round trip: B's file -> a state on the card ->
    # leaves equal to the file's; a synchronous save of that state
    # writes the same leaves again
    model = exp.model
    npz = os.path.join(ckpt_dir, str(b_step), ckpt.STATE_FILE)
    size = os.path.getsize(npz)
    state = create_train_state(model, t, t.seed + 1, "cuda")
    t0 = time.perf_counter()
    ckpt.restore(ckpt_dir, state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0

    def npz_leaves(path):
        with np.load(path) as z:
            return [z[k] for k in sorted(z.files)
                    if k.startswith("leaf_")]
    saved = npz_leaves(npz)
    leaves = [ckpt._host(l) for l in ckpt.state_leaves(state)]
    diff = sum(not np.array_equal(a, b) or a.dtype != b.dtype
               for a, b in zip(saved, leaves))
    if state.step != b_step or len(saved) != len(leaves) or diff:
        fail(f"restore of step {b_step}: step {state.step}, "
             f"{len(saved)} vs {len(leaves)} leaves, {diff} differ")
    again = os.path.join(root, "again")
    t0 = time.perf_counter()
    ckpt.save(again, state, block=True)
    sync_s = time.perf_counter() - t0
    diff = sum(not np.array_equal(a, b) or a.dtype != b.dtype for a, b
               in zip(saved, npz_leaves(os.path.join(
                   again, str(b_step), ckpt.STATE_FILE))))
    if diff:
        fail(f"restore -> save round trip: {diff} leaves differ")
    print(f"  checkpoint: state.npz {size / 2**20:.1f} MiB, "
          f"{len(saved)} leaves; restore {restore_s:.3f} s, bit-equal "
          f"to the file; synchronous save {sync_s:.3f} s, its leaves "
          f"bit-equal to the restored file's ({card})", flush=True)
    del state
    torch.cuda.empty_cache()

    # run C: --resume --fused-cycle to LOOP_KIMG, counters reset just
    # before; the key is taken and the loop's steps run as without it
    start_it = b_step // t.batch_size
    iters = -(-(LOOP_KIMG * 1000 - b_step) // t.batch_size)
    kinds = loop_step_kinds(t, start_it, iters)
    grid_n = min(16, t.batch_size * 2)
    snapshots = 3          # at start, after the tick, final
    want, want_lse, want_second, want_paths = loop_plan(
        model, t, kinds, snapshots, grid_n, model.dtype)
    print(f"  run C: --resume --fused-cycle from step {b_step} to "
          f"{LOOP_KIMG} kimg: {iters} iterations from {start_it} ({kinds})"
          f" and {snapshots} snapshots of {grid_n}; launch plan {want}",
          flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc = train_cli.main(["--run-dir", run, "--resume", "--fused-cycle"])
    torch.cuda.synchronize()
    c_s = time.perf_counter() - t0
    got, lse = ops.launch_counts(), ops.lse_launch_counts()
    second, paths = ops.second_order_counts(), ops.path_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        fail(f"run C returned {rc}")
    print(f"  run C launches {got}; with lse {lse}; second order "
          f"{second}", flush=True)
    for what, g, w in (("launches", got, want), ("lse", lse, want_lse),
                       ("second order", second, want_second),
                       ("routes", paths, want_paths)):
        if g != w:
            fail(f"run C {what} {g} != the plan's {w}")
    c_log = open(os.path.join(run, "log.txt")).read()
    for line in (f"resumed from step {b_step} ",
                 f"from batch {start_it}",
                 f"fused cycle: {t.d_reg_interval} iterations make no host "
                 f"round trip"):
        if line not in c_log:
            fail(f"run C: log.txt lacks {line!r}")
    from gansformer_tpu_torch.utils.logging import read_resume_records

    if [r["step"] for r in read_resume_records(run)] != [b_step]:
        fail(f"resumes.jsonl: {read_resume_records(run)}")
    ticks = read_ticks(run)
    check_ticks(ticks, "run C")
    c_ticks = ticks[len(b_ticks):]
    if ckpt.latest_step(ckpt_dir) != b_step + iters * t.batch_size:
        fail(f"run C ended at checkpoint {ckpt.latest_step(ckpt_dir)}")
    for rec in c_ticks:
        print_tick(rec, "run C", card)
        print_h2d(rec, peak)
    from gansformer_tpu_torch.obs.registry import parse_prom_values

    prom = parse_prom_values(os.path.join(run, "telemetry.prom"))
    loop_ms = prom["ckpt_write_ms"]
    writer_ms = prom["ckpt_async_write_ms_sum"] / max(
        prom["ckpt_async_write_ms_count"], 1.0)
    print(f"  async checkpoint: {loop_ms:.1f} ms on the loop thread, "
          f"{writer_ms:.1f} ms on the writer thread; restore "
          f"{prom['ckpt_restore_ms']:.1f} ms; run C "
          f"{c_s:.1f} s (setup, restore, "
          f"{len(c_ticks)} tick, snapshots, final checkpoint); peak "
          f"device memory {peak / 2**30:.2f} GiB ({card})", flush=True)
    # run D: 4 more iterations, unfused, one tick with R1 and path length,
    # under torch.cuda.set_sync_debug_mode, which C ran without
    d_first = ckpt.latest_step(ckpt_dir) // t.batch_size
    d_kinds = loop_step_kinds(t, d_first, 4)
    with SyncRecorder() as syncs:
        rc = train_cli.main(["--run-dir", run, "--resume", "--total-kimg",
                             str(LOOP_KIMG + 1), "--steps", "4"])
    if rc != 0:
        fail(f"run D returned {rc}")
    top = syncs.by_span()
    in_tick = sum(v for k, v in top.items() if k in (
        "data_wait", "h2d", "step", "backward", "tick_fetch"))
    print(f"  host syncs of run D (--resume --steps 4, iterations "
          f"{d_first}-{d_first + 3}: {d_kinds}; "
          f"torch.cuda.set_sync_debug_mode): {len(syncs.syncs())}, by the "
          f"loop's span open on the main thread at the time (backward: "
          f"autograd's thread): "
          f"{top}; in the tick's iterations and boundary {in_tick}, "
          f"{in_tick / 4:.1f} an iteration, "
          f"{top.get('tick_fetch', 0)} of them at the boundary",
          flush=True)
    for where, n in sorted(syncs.sites().items(),
                           key=lambda kv: -kv[1])[:8]:
        print(f"    {n:6d}  {where}", flush=True)
    pngs = sorted(f for f in os.listdir(run) if f.startswith("fakes"))
    side = int(math.sqrt(grid_n)) * model.resolution
    for f in pngs:
        with open(os.path.join(run, f), "rb") as fh:
            img = decode_png(fh.read())
        if img.shape != (side, side, model.img_channels):
            fail(f"{f}: decoded {img.shape}, not the grid's "
                 f"{(side, side, model.img_channels)}")
    print(f"  {pngs} decode (zlib) to {side}x{side}x"
          f"{model.img_channels}", flush=True)


GENERATE_MODES = (
    # (mode, extra arguments, batch, synthesize calls, PNGs and shapes in
    # units of the resolution: (rows, columns))
    ("singles", ["--images-num", "4", "--batch-size", "4"], 4, 1,
     {f"img{i:04d}.png": (1, 1) for i in range(4)}),
    ("grid", ["--grid", "--images-num", "8", "--batch-size", "8"], 8, 1,
     {"grid.png": (4, 2)}),
    ("interpolate 2 5", ["--grid", "--images-num", "8", "--batch-size", "8",
                         "--interpolate", "2", "5"], 8, 6,
     {"grid.png": (4, 2), "interp.png": (2, 5)}),
    ("style-mix 2 3", ["--grid", "--images-num", "8", "--batch-size", "8",
                       "--style-mix", "2", "3"], 8, 2,
     {"grid.png": (4, 2), "mix.png": (2, 3)}),
)


def sync_phase(card: str, data: str):
    """ffhq256-duplex as the preset has it (batch 32, bf16, R1 every 16,
    path length every 4): one lazy-reg cycle, the loop's steps over
    iterations 0-15 from a fresh state of seed 0 on 16 batches of the
    smoke's TFRecords, under ``torch.cuda.set_sync_debug_mode("error")``,
    so that a host sync fails it (JAX's fused cycle is one dispatch for
    these iterations; the port's make no host round trip).  Its launches
    are held to the plan of the 16 iterations, its aux counts to the
    schedule's, its sums must be finite; a planted ``.item()`` under the
    same mode must raise, so the mode is armed in this build."""
    import numpy as np
    import torch

    from gansformer_tpu_torch import ops
    from gansformer_tpu_torch.core.config import get_experiment_preset
    from gansformer_tpu_torch.core.device import to_device
    from gansformer_tpu_torch.data import TFRecordDataset
    from gansformer_tpu_torch.train import create_train_state, d_step, g_step

    exp = get_experiment_preset(LOOP_PRESET)
    model, t = exp.model, exp.train
    k = t.d_reg_interval
    ds = TFRecordDataset(data, resolution=model.resolution)
    stream = ds.batches(t.batch_size, seed=t.seed + 1)
    try:
        host = np.stack([next(stream)["image"] for _ in range(k)])
    finally:
        ds.close()
    imgs = to_device(torch.from_numpy(host), torch.device("cuda"))
    kinds = loop_step_kinds(t, 0, k)
    want = loop_plan(model, t, kinds, 0, 1, model.dtype)
    want_counts = {"Loss/D": k, "Loss/scores/real": k,
                   "Loss/scores/fake": k, "Loss/G": k,
                   "Loss/D/r1": -(-k // t.d_reg_interval),
                   "Loss/G/pl": -(-k // t.g_reg_interval)}
    print(f"  {k} batches of {t.batch_size} from the TFRecords; the "
          f"cycle's iterations: {kinds}; launch plan {want[0]}", flush=True)
    mirror = exp.data.mirror_augment
    st = create_train_state(model, t, t.seed, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    sums, counts = {}, {}
    torch.cuda.set_sync_debug_mode("error")
    try:
        for it in range(k):
            aux = d_step(st, imgs[it], it, mirror_augment=mirror,
                         do_r1=it % t.d_reg_interval == 0)
            aux.update(g_step(st, it, t.batch_size,
                              do_pl=it % t.g_reg_interval == 0))
            for n, v in aux.items():
                sums[n] = v if n not in sums else sums[n] + v
                counts[n] = counts.get(n, 0) + 1
    except RuntimeError as e:
        fail(f"a host sync inside the cycle's iterations: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    t1.record()
    torch.cuda.synchronize()
    got = (ops.launch_counts(), ops.lse_launch_counts(),
           ops.second_order_counts(), ops.path_launch_counts())
    for name, g, w in zip(("launches", "lse", "second order", "routes"),
                          got, want):
        if g != w:
            fail(f"the cycle's iterations: {name} {g} != the plan's {w}")
    if counts != want_counts:
        fail(f"the cycle's aux counts {counts} != {want_counts}")
    if not all(math.isfinite(float(v)) for v in sums.values()):
        fail(f"the cycle's aux sums are not finite: {sums}")
    torch.cuda.set_sync_debug_mode("error")
    try:
        sums["Loss/G"].item()
        fail("a planted .item() passed the sync debug mode 'error'")
    except RuntimeError:
        pass
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"  {k} iterations: {t0.elapsed_time(t1):.1f} ms by CUDA events, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, 0 "
          f"host syncs under the sync debug mode 'error' (a planted "
          f".item() raised); launches equal the plan ({card})", flush=True)
    print("    sums: " + ", ".join(
        f"{n} {float(v):.4f}" for n, v in sums.items()), flush=True)
    del st
    torch.cuda.empty_cache()


def prepare_data_phase(card: str) -> None:
    """``prepare_data --synthetic --to tfrecord`` at 256^2 into a
    temporary directory; the records read back through the port's
    TFRecord dataset image for image; timed."""
    import shutil
    import tempfile

    import numpy as np

    from gansformer_tpu_torch.cli import prepare_data
    from gansformer_tpu_torch.data import SyntheticDataset, TFRecordDataset

    root = tempfile.mkdtemp(prefix="gansformer_smoke_prep_")
    try:
        n, out = 64, os.path.join(root, "synthetic")
        t0 = time.perf_counter()
        rc = prepare_data.main(["--synthetic", "--resolution", "256",
                                "--max-images", str(n), "--to", "tfrecord",
                                "--out", out])
        took = time.perf_counter() - t0
        if rc != 0:
            fail(f"prepare_data returned {rc}")
        size = sum(os.path.getsize(os.path.join(out, f))
                   for f in os.listdir(out))
        ds = TFRecordDataset(out, resolution=256)
        got = ds._emit(range(ds.num_images))["image"]
        ds.close()
        want = SyntheticDataset(256, num_images=n)._make(np.arange(n))
        if ds.num_images != n or not np.array_equal(got, want):
            fail(f"prepare_data's records read back {ds.num_images} "
                 f"images, not the {n} it wrote")
        print(f"  prepare_data --synthetic --to tfrecord: {n} images at "
              f"256^2, {len(os.listdir(out))} files ({size / 2**20:.1f} "
              f"MiB, every level of detail) in {took:.2f} s; read back "
              f"image for image ({card})", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def generate_phase(card: str, run: str) -> None:
    """``generate --run-dir`` on the loop's run dir on the card, one
    invocation for each of ``GENERATE_MODES``: counters reset just before
    and held to the plan of its synthesize calls just after; every PNG
    decoded (zlib) to its expected size, not constant."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from gansformer_tpu_torch import ops
    from gansformer_tpu_torch.cli import generate
    from gansformer_tpu_torch.core.config import ExperimentConfig
    from gansformer_tpu_torch.utils.image import decode_png

    with open(os.path.join(run, "config.json")) as f:
        model = ExperimentConfig.from_json(f.read()).model
    r = model.resolution
    root = tempfile.mkdtemp(prefix="gansformer_smoke_gen_")
    try:
        for mode, extra, batch, synths, pngs in GENERATE_MODES:
            out = os.path.join(root, mode.split()[0])
            calls = main_path_calls(model, batch)
            want = {kname: synths * sum(c["kernel"] == kname for c in calls)
                    for kname in REPLACES}
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            rc = generate.main(["--run-dir", run, "--out", out] + extra)
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
            got = ops.launch_counts()
            if rc != 0:
                fail(f"generate {mode} returned {rc}")
            if got != want:
                fail(f"generate {mode}: launches {got} != the plan's "
                     f"{want} ({synths} synthesize at {batch})")
            if sorted(os.listdir(out)) != sorted(pngs):
                fail(f"generate {mode} wrote {sorted(os.listdir(out))}")
            for name, (rows, cols) in pngs.items():
                with open(os.path.join(out, name), "rb") as f:
                    img = decode_png(f.read())
                if img.shape != (rows * r, cols * r, model.img_channels):
                    fail(f"generate {mode}: {name} decoded {img.shape}")
                if not float(np.asarray(img, np.float64).std()) > 0:
                    fail(f"generate {mode}: {name} is constant")
            print(f"  generate --run-dir {mode}: {took:.2f} s (restore "
                  f"included), {synths} synthesize at batch {batch}, "
                  f"launches {got} = the plan; {sorted(pngs)} decode "
                  f"(zlib) to their sizes, not constant ({card})",
                  flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


METRICS = "fid1k,is1k,pr1k,ppl1k"
METRICS_IMAGES = 1000
METRICS_BATCH = 32
METRICS_HELD = 8          # images whose card features are held to the host's
METRICS_STATS = 32        # fakes and reals whose FID, IS and P&R are held
FEATURE_TOL = 1e-4        # of max |feature|: fp32, TF32 off on both sides
METRIC_STAT_TOL = {"fid": 1e-3, "is": 1e-4}
PPL_CONTROL = 1e-6        # of the sweep's median PPL distance
HOOK_METRICS = "fid256"


def metrics_sweep_synths(n: int, batch: int) -> int:
    """The synthesize calls of an evaluate sweep with FID/IS/P&R and PPL
    over ``n`` images: one fake sweep (shared), two per PPL batch."""
    batches = -(-n // batch)
    return batches + 2 * batches


def frechet_low_rank(real: "np.ndarray", fake: "np.ndarray") -> float:
    """FID of two feature sets with fewer samples than dimensions, by the
    low-rank identity: the nonzero eigenvalues of Σ₁Σ₂ are the squared
    singular values of A₁A₂ᵀ (Aᵢ the centered features over √(nᵢ-1)), so
    Tr √(Σ₁Σ₂) is that product's nuclear norm; no 2048² square root."""
    import numpy as np

    a1 = (real - real.mean(0)) / np.sqrt(len(real) - 1)
    a2 = (fake - fake.mean(0)) / np.sqrt(len(fake) - 1)
    diff = real.mean(0) - fake.mean(0)
    tr_sqrt = np.linalg.svd(a1 @ a2.T, compute_uv=False).sum()
    return float(diff @ diff + (a1 * a1).sum() + (a2 * a2).sum()
                 - 2.0 * tr_sqrt)


def metrics_phase(card: str, run: str) -> None:
    """Metrics and evaluation on the loop's run dir (ffhq256-duplex, full
    width, bf16): ``cli/evaluate.py`` with ``METRICS`` at batch 32 and the
    uncalibrated extractor, TF32 flags at torch's defaults, its launches
    held to the plan of its synthesize calls; the card's features of
    ``METRICS_HELD`` sweep images held to the host's (and a planted
    average pool that counts its padding rejected); FID, IS and P&R of
    the card's features of ``METRICS_STATS`` fakes and reals held to the
    host's; the PPL control (a pair with z0 == z1 and shared noise: 0, or
    within ``PPL_CONTROL`` of the median distance; unshared noise: of the
    median's order); then the in-loop hook once (a one-tick run with
    ``metric_ticks`` 1 and ``HOOK_METRICS``)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from gansformer_tpu_torch import ops
    from gansformer_tpu_torch.cli import evaluate
    from gansformer_tpu_torch.core.config import ExperimentConfig
    from gansformer_tpu_torch.data.dataset import (make_dataset,
                                                   normalize_images)
    from gansformer_tpu_torch.metrics import inception as inc
    from gansformer_tpu_torch.metrics.inception_score import inception_score
    from gansformer_tpu_torch.metrics.precision_recall import \
        precision_recall
    from gansformer_tpu_torch.train import (create_train_state, derive_seed,
                                            loop, make_metric_samplers,
                                            ppl_pairs)
    from gansformer_tpu_torch.train import checkpoint as ckpt

    with open(os.path.join(run, "config.json")) as f:
        cfg = ExperimentConfig.from_json(f.read())
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = (cudnn.allow_tf32, matmul.allow_tf32)
    env_npz = os.environ.pop("GANSFORMER_TPU_INCEPTION_NPZ", None)
    if inc.resolve_weights() is not None:
        fail(f"the metrics phase wants the uncalibrated extractor; "
             f"{inc.resolve_weights()} would be loaded")
    root = tempfile.mkdtemp(prefix="gansformer_smoke_metrics_")
    try:
        cudnn.allow_tf32, matmul.allow_tf32 = True, False   # torch's defaults
        synths = metrics_sweep_synths(METRICS_IMAGES, METRICS_BATCH)
        calls = main_path_calls(cfg.model, METRICS_BATCH)
        want = {k: synths * sum(c["kernel"] == k for c in calls)
                for k in REPLACES}
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = evaluate.main(["--run-dir", run, "--metrics", METRICS,
                             "--batch-size", str(METRICS_BATCH)])
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        got = ops.launch_counts()
        if got != want:
            fail(f"evaluate: launches {got} != the plan's {want} ({synths} "
                 f"synthesize at batch {METRICS_BATCH})")
        names = ("fid1k_uncal", "is1k_uncal_mean", "is1k_uncal_std",
                 "pr1k_3_uncal_precision", "pr1k_3_uncal_recall",
                 "ppl1k_wfull_uncal")
        bad = [n for n in names
               if not (n in res and math.isfinite(res[n]))]
        if bad or res.get("calibrated") != 0.0:
            fail(f"evaluate: results {res} (missing or non-finite: {bad})")
        for n in names:
            if not os.path.exists(os.path.join(run, f"metric-{n}.txt")):
                fail(f"evaluate wrote no metric-{n}.txt")
        with open(os.path.join(run, "flag-calibrated.txt")) as f:
            if f.read() != "calibrated 0\n":
                fail("evaluate: flag-calibrated.txt is not 'calibrated 0'")
        print(f"  evaluate {METRICS} at batch {METRICS_BATCH}: "
              + ", ".join(f"{n} {res[n]:.6g}" for n in names)
              + f"; {took:.2f} s (restore included); launches {got} = the "
              f"plan ({synths} synthesize at batch {METRICS_BATCH}); TF32 "
              f"flags at torch's defaults ({card})", flush=True)

        # the card's features of sweep images against the host's
        state = create_train_state(cfg.model, cfg.train, cfg.train.seed)
        state = ckpt.restore(os.path.join(run, "checkpoints"), state)
        dataset = make_dataset(cfg.data)
        try:
            sample_fn, pair_fn = make_metric_samplers(state, cfg, dataset)
            fakes = sample_fn(METRICS_BATCH)         # the sweep's first batch
            batch = next(dataset.batches(METRICS_STATS, seed=123))
        finally:
            dataset.close()
        reals = normalize_images(torch.from_numpy(batch["image"]))
        card_ex = inc.make_extractor()
        host_ex = inc.FeatureExtractor(None, device="cpu")
        t0 = time.perf_counter()
        held = fakes[:METRICS_HELD]
        fc, lc = card_ex(held)
        fh, lh = host_ex(held.cpu())
        err = max(rel_err(fc, fh), rel_err(lc, lh))
        if not err <= FEATURE_TOL:
            fail(f"card features vs host: {err:.3e} > {FEATURE_TOL}")
        inc.TFAvgPool.count_include_pad = True
        try:
            planted = rel_err(card_ex(held)[0], fh)
        finally:
            inc.TFAvgPool.count_include_pad = False
        if not planted > FEATURE_TOL:
            fail(f"the planted pool fault ({planted:.3e}) passes the "
                 f"feature gate")
        print(f"  card vs host features of {METRICS_HELD} sweep images "
              f"(uncalibrated, fp32; TF32 flags at torch's defaults on the "
              f"card): max error {err:.3e} of max |value| (gate "
              f"{FEATURE_TOL}); planted average pool counting its padding: "
              f"{planted:.3e}, rejected", flush=True)

        sides = {}
        for side, ex, dev in (("card", card_ex, "cuda"),
                              ("host", host_ex, "cpu")):
            f_fake, l_fake = ex(fakes[:METRICS_STATS].to(dev))
            f_real, _ = ex(reals.to(dev))
            ff, fr = (t.double().cpu().numpy() for t in (f_fake, f_real))
            sides[side] = {
                "fid": frechet_low_rank(fr, ff),
                "is": inception_score(l_fake.double().cpu().numpy())[0],
                "pr": precision_recall(fr, ff, k=3)}
        c, h = sides["card"], sides["host"]
        for key, tol in METRIC_STAT_TOL.items():
            if not abs(c[key] - h[key]) <= tol * abs(h[key]):
                fail(f"{key} of the card's features {c[key]:.6g} vs the "
                     f"host's {h[key]:.6g}: beyond {tol} relative")
        if max(abs(x - y) for x, y in zip(c["pr"], h["pr"])) > \
                1.0 / METRICS_STATS:
            fail(f"P&R of the card's features {c['pr']} vs the host's "
                 f"{h['pr']}: beyond one sample")
        print(f"  statistics of {METRICS_STATS} fakes and {METRICS_STATS} "
              f"reals, card's features vs host's: FID {c['fid']:.6g} / "
              f"{h['fid']:.6g} (gate {METRIC_STAT_TOL['fid']} relative), IS "
              f"{c['is']:.6g} / {h['is']:.6g} (gate "
              f"{METRIC_STAT_TOL['is']}), P&R {c['pr']} / {h['pr']} (gate: "
              f"one sample); {time.perf_counter() - t0:.2f} s", flush=True)

        # the PPL control on the sweep's first pair batch
        eps = 1e-4
        rs = np.random.RandomState(0)        # sample_ppl_distances' draws
        t = rs.rand(METRICS_BATCH).astype(np.float32)
        pair_seed = rs.randint(2**31)

        def dist(a, b):
            fa, fb = card_ex(a)[0].double(), card_ex(b)[0].double()
            return (((fa - fb) ** 2).sum(-1) / eps**2).cpu().numpy()

        median = float(np.median(dist(*pair_fn(METRICS_BATCH, t, pair_seed,
                                               eps))))
        z = torch.randn((METRICS_BATCH, cfg.model.num_ws,
                         cfg.model.latent_dim),
                        generator=torch.Generator().manual_seed(
                            derive_seed(pair_seed, "ppl"))).cuda()
        seeds = [derive_seed(pair_seed, "ppl", "noise", r)
                 for r in range(METRICS_BATCH)]
        tt = torch.from_numpy(t).cuda()
        same = dist(*ppl_pairs(state, z, z, tt, eps, noise_seeds=seeds))
        a, _ = ppl_pairs(state, z, z, tt, eps, noise_seeds=seeds)
        _, b = ppl_pairs(state, z, z, tt, eps,
                         noise_seeds=[s + 1 for s in seeds])
        unshared = float(np.median(dist(a, b)))
        if not float(same.max()) <= PPL_CONTROL * median:
            fail(f"PPL control: z0 == z1 with shared noise gives distances "
                 f"up to {same.max():.4g}, beyond {PPL_CONTROL} of the "
                 f"median {median:.4g}")
        print(f"  PPL control (z0 == z1, the sweep's first pair batch): "
              f"shared noise max distance {float(same.max()):.4g} "
              f"({'exactly 0' if not same.any() else 'not 0'}; gate "
              f"{PPL_CONTROL} of the median {median:.6g}); unshared noise "
              f"median {unshared:.6g}", flush=True)
        del state, card_ex, host_ex
        torch.cuda.empty_cache()

        # the in-loop hook: a one-tick run of two iterations
        hook = os.path.join(root, "hook")
        hook_train = dataclasses.replace(
            cfg.train, kimg_per_tick=2 * cfg.train.batch_size / 1000,
            total_kimg=1, metric_ticks=1, metrics=HOOK_METRICS,
            snapshot_ticks=1, image_snapshot_ticks=1)
        t0 = time.perf_counter()
        loop.train(dataclasses.replace(cfg, train=hook_train), hook,
                   steps=2)
        took = time.perf_counter() - t0
        line = open(os.path.join(hook, "metric-fid256_uncal.txt")).read()
        flag = open(os.path.join(hook, "flag-calibrated.txt")).read()
        if len(line.splitlines()) != 1 or flag != "calibrated 0\n":
            fail(f"in-loop hook: metric-fid256_uncal.txt {line!r}, "
                 f"flag-calibrated.txt {flag!r}")
        print(f"  in-loop hook (2 iterations, one tick, metric_ticks 1, "
              f"{HOOK_METRICS}): metric-fid256_uncal.txt "
              f"{line.strip()!r}, flag-calibrated.txt {flag.strip()!r}; "
              f"{took:.2f} s ({card})", flush=True)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev
        if env_npz is not None:
            os.environ["GANSFORMER_TPU_INCEPTION_NPZ"] = env_npz
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    if len(sys.argv) > 1:
        fail(f"takes no arguments, got {sys.argv[1:]}")

    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    try:
        from gansformer_tpu_torch.core import get_preset, get_train_preset
        from gansformer_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"the gansformer_tpu_torch package is not importable: {e}")

    t_start = time.perf_counter()
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
    log = _build.build_info.get("log", "")
    summary = ptxas_summary(log)
    for kname, regs, spill in summary:
        print(f"  ptxas: {kname} {regs} registers, {spill} bytes spilled",
              flush=True)
        if spill and kname.startswith(NO_SPILL):
            fail(f"{kname} spills {spill} bytes")
    unreported = [k for k in NO_SPILL
                  if not any(n.startswith(k) for n, _, _ in summary)]
    if unreported:
        fail(f"the build's ptxas report has no entry for {unreported}")
    for line in log.splitlines():
        if "serialized" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    for opcode, knames in (("HGMMA", WGMMA_KERNELS), ("HMMA", MMA_KERNELS)):
        counts = sass_counts(_build.build_info["path"], opcode)
        for kname in knames:
            found = {k: v for k, v in counts.items() if k.startswith(kname)}
            if not found or not all(found.values()):
                fail(f"{kname}: no {opcode} in the SASS ({found})")
            print(f"  sass: {opcode} instructions {found}", flush=True)

    # ---- ROADMAP C.16: the attention kernels at large logits ---------------
    print("the attention kernels against float64 autograd of the softmax "
          "as the logits grow (batch 2, 64 grid rows, 16 latents, width "
          f"512; relative to max |float64|; gate: kernels 3 + 8 fp32 dq, dk "
          f"<= {LOGIT_FACTOR} x the plain pair's at "
          f"{', '.join(f'{t:.0e}' for t in LOGIT_GATE)}):", flush=True)
    t0 = time.perf_counter()
    logit_scaling()
    print(f"  took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- serving ----------------------------------------------------------
    cfg = get_preset("ffhq256-duplex")
    calls = {b: main_path_calls(cfg, b) for b in BUCKETS}
    expected = {k: sum(c["kernel"] == k for c in calls[8]) for k in REPLACES}
    print(f"launches per synthesize at ffhq256-duplex: {expected}",
          flush=True)
    if expected != dict(dict.fromkeys(REPLACES, 0), modconv=20, upfirdn=12,
                        grid_to_latent=7, latent_to_grid=5):
        fail(f"unexpected launch plan {expected}")

    for b in BUCKETS:
        check_fwd_configs(calls[b])
        check_attn_ufd_configs(calls[b])
    flagship = [c for c in calls[8] if c["label"] in FLAGSHIP]
    print("kernels vs plain, fp32, flagship shapes at batch 8:", flush=True)
    check_kernels(flagship, "float32", peaks)
    held = {call_key(c, "float32") for c in flagship}
    held |= {call_key(c, "bfloat16") for b in BUCKETS for c in calls[b]}
    rows, row_of = [], {}
    for b in BUCKETS:
        print(f"kernels vs plain, bf16, every launch of one synthesize at "
              f"batch {b}:", flush=True)
        bucket_rows = check_kernels(calls[b], "bfloat16", peaks,
                                    show=b == BUCKETS[-1])
        row_of.update((call_key(c, "bfloat16"), r)
                      for c, r in zip(calls[b], bucket_rows))
        print_sums(f"  sums over the {len(bucket_rows)} launches of one "
                   f"synthesize at batch {b}:",
                   kernel_sums(bucket_rows, SERVE_KERNELS))
        rows += bucket_rows
    run_sums = kernel_sums(rows, SERVE_KERNELS)
    print_sums(f"  sums over the serve run's {len(rows)} launches "
               f"(batches {'+'.join(map(str, BUCKETS))}):", run_sums)
    blur = [dict(c, act="lrelu", label=c["label"] + " +bias lrelu")
            for c in calls[8] if c["label"].endswith(" blur")]
    print("upfirdn's fused epilogue (bias, lrelu, gain sqrt 2) at every "
          "blur launch of one synthesize at batch 8, bf16:", flush=True)
    check_kernels(blur, "bfloat16", peaks)
    check_general_route(peaks)

    print("serve ffhq256-duplex (bf16, random init, buckets "
          f"{'/'.join(map(str, BUCKETS))}):", flush=True)
    bundle, counts, synth_s = serve_run(cfg, expected, calls)
    print(f"  launches over {len(BUCKETS)} synthesize calls: {counts}")
    for kname, s in run_sums.items():
        if counts[kname] != s["launches"]:
            fail(f"{kname}: the serve run launched it {counts[kname]} "
                 f"times, the checks timed {s['launches']} launches")
    print(f"  synthesize at bucket 8: {synth_s * 1e3:.2f} ms, "
          f"{8 / synth_s:.2f} images/s on {card}", flush=True)
    print("generator vs plain path, batch 2, noise off:", flush=True)
    model_compare(cfg, bundle)
    print(f"serving precisions of ffhq256-duplex (its serve weights, fp32 "
          f"configuration; buckets {'/'.join(map(str, PRECISION_BUCKETS))}, "
          f"psi 0.7 and 1.0, noise on and off):", flush=True)
    t0 = time.perf_counter()
    precision_phase(cfg, bundle, card)
    print(f"  took {time.perf_counter() - t0:.1f} s", flush=True)
    del bundle
    torch.cuda.empty_cache()
    print(f"the serve CLI ({SERVE_CLI_PRESET}, random init), a process per "
          f"run on one fresh manifest directory:", flush=True)
    t0 = time.perf_counter()
    serve_cli_phase(card)
    print(f"  took {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    print(f"the generation service ({SERVICE_PRESET}, random init, buckets "
          f"{'/'.join(map(str, SERVICE_BUCKETS))}):", flush=True)
    t0 = time.perf_counter()
    service_phase(card, 8 / synth_s)
    print(f"  took {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    print(f"the replica fleet ({SERVICE_PRESET}, random init, buckets "
          f"{'/'.join(map(str, SERVICE_BUCKETS))}):", flush=True)
    t0 = time.perf_counter()
    fleet_phase(card)
    fleet_cli(card)
    print(f"  took {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    print(f"serve phases took {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # ---- training ---------------------------------------------------------
    t_train = time.perf_counter()
    tcfg = dataclasses.replace(get_train_preset("ffhq256-duplex"),
                               batch_size=TRAIN_BATCH)
    tcalls = train_path_calls(cfg, TRAIN_BATCH)
    plan = {p: plan_counts(tcalls, p) for p in ("d_step", "g_step")}
    print(f"training ffhq256-duplex, batch {TRAIN_BATCH}, bf16; launch "
          f"plan: {plan}; with lse: "
          f"{ {p: plan_lse_counts(tcalls, p) for p in plan} }", flush=True)
    for kname, row in attention_backward_bounds(cfg, TRAIN_BATCH,
                                                peaks).items():
        print(f"  {kname}: {row['launches']} launches per g_step, bound "
              f"{row['bound_ms']:.4f} ms (bytes {row['bytes_ms']:.4f}, "
              f"operations {row['ops_ms']:.4f})", flush=True)
    check_bwd_configs(tcalls)
    check_attn_ufd_configs(tcalls)
    checked = checked_train_calls(tcalls)
    print("train kernels vs plain, fp32, flagship shapes at batch "
          f"{TRAIN_BATCH}:", flush=True)
    seen, flag = set(), []
    for c in checked:
        if c["label"] in TRAIN_FLAGSHIP and c["label"] not in seen:
            seen.add(c["label"])
            flag.append(c)
    check_kernels(flag, "float32", peaks)
    held |= {call_key(c, "float32") for c in flag}
    held |= {call_key(c, "bfloat16") for c in checked}
    print("kernels vs plain, bf16, every backward launch of one d_step + "
          "one g_step, every forward attention launch that writes lse, and "
          "D's forward upfirdn launches:", flush=True)
    train_rows = check_kernels(checked, "bfloat16", peaks)
    row_of.update((call_key(c, "bfloat16"), r)
                  for c, r in zip(checked, train_rows))
    train_sums = kernel_sums(train_rows, TRAIN_KERNELS)
    lse_rows = [r for r in train_rows if r.get("lse")]
    lse_sums = kernel_sums(lse_rows, ATTENTION_KERNELS)
    print_sums(f"  sums over the backward launches of one d_step + one "
               f"g_step:", train_sums)
    print_sums("  sums over the forward attention launches with lse (one "
               "d_step + one g_step):", lse_sums)
    print_sums("  D's forward upfirdn launches (one d_step + one g_step):",
               kernel_sums([r for r in train_rows
                            if r["kernel"] == "upfirdn"], ("upfirdn",)))
    print("train ffhq256-duplex (bf16, random init, batch "
          f"{TRAIN_BATCH}, noise on, style mixing "
          f"{tcfg.style_mixing_prob}):", flush=True)
    deltas, lse_counts, times = train_run(cfg, tcfg, tcalls)
    for kname, s in train_sums.items():
        if s["launches"] != plan["d_step"][kname] + plan["g_step"][kname]:
            fail(f"{kname}: the checks timed {s['launches']} launches, the "
                 f"plan has {plan['d_step'][kname] + plan['g_step'][kname]}")
    for kname, s in lse_sums.items():
        if s["launches"] != lse_counts[kname]:
            fail(f"{kname}: the checks timed {s['launches']} launches with "
                 f"lse, the run made {lse_counts[kname]}")
    print(f"  d_step {times['d_ms']:.2f} ms, g_step {times['g_ms']:.2f} ms "
          f"(CUDA events), iteration {times['iter_host_ms']:.2f} ms (host "
          f"clock): {TRAIN_BATCH * 1e3 / times['iter_host_ms']:.2f} "
          f"images/s on {card}", flush=True)
    torch.cuda.empty_cache()

    dmodel = dataclasses.replace(cfg, d_attention=True)
    dcalls = train_path_calls(dmodel, TRAIN_BATCH)
    dplan = {p: plan_counts(dcalls, p) for p in ("d_step", "g_step")}
    print(f"ffhq256-duplex with d_attention, batch {TRAIN_BATCH}, bf16; "
          f"launch plan: {dplan}", flush=True)
    check_attn_ufd_configs(dcalls)

    new, seen = [], set()
    for c in dcalls:
        key = call_key(c, "bfloat16")
        if c["kernel"].startswith(ATTENTION_KERNELS) and \
                (c.get("lse") or c["kernel"] not in ATTENTION_KERNELS) \
                and key not in held | seen:
            seen.add(key)
            new.append(c)
    if new:
        print("  its attention launch shapes that the preset's run does not "
              "hold, kernel vs plain, bf16:", flush=True)
        row_of.update((call_key(c, "bfloat16"), r) for c, r in zip(
            new, check_kernels(new, "bfloat16", peaks)))
        held |= seen
    else:
        print("  every attention launch shape of its d_step + g_step is "
              "one the preset's run already held", flush=True)
    d_attention_run(dmodel, tcfg, dcalls)
    torch.cuda.empty_cache()
    fmodel = dataclasses.replace(dmodel, attn_fused_kv=True)
    print(f"ffhq256-duplex with d_attention and attn_fused_kv (one K/V "
          f"projection per attention direction in G and D; ROADMAP C.18), "
          f"batch {TRAIN_BATCH}, bf16; the launch plan is d_attention's",
          flush=True)
    d_attention_run(fmodel, tcfg, dcalls)
    torch.cuda.empty_cache()

    # ---- R1: d_step_r1, with and without d_attention ----------------------
    r1_out = {}
    for title, rmodel in (("ffhq256-duplex", cfg),
                          ("ffhq256-duplex with d_attention", dmodel)):
        shrink = tcfg.r1_batch_shrink
        rcalls = r1_step_calls(rmodel, TRAIN_BATCH, shrink)
        second = plan_second_order_counts(rmodel, TRAIN_BATCH, shrink)
        print(f"d_step_r1 of {title}, batch {TRAIN_BATCH} (R1 on "
              f"{TRAIN_BATCH // shrink}), bf16, r1_gamma {tcfg.r1_gamma}, "
              f"d_reg_interval {tcfg.d_reg_interval}; launch plan "
              f"{plan_counts(rcalls, 'd_step_r1')}; with lse "
              f"{plan_lse_counts(rcalls, 'd_step_r1')}; second order "
              f"{second}", flush=True)
        check_attn_ufd_configs(rcalls)
        new = [c for c in rcalls if call_key(c, "bfloat16") not in row_of]
        if new:
            print(f"  {len(new)} of its launch shapes no earlier phase "
                  "held, kernel vs plain, bf16:", flush=True)
            row_of.update((call_key(c, "bfloat16"), r) for c, r in zip(
                new, check_kernels(new, "bfloat16", peaks)))
        else:
            print("  every launch shape of its d_step_r1 (the second order "
                  "included) is one an earlier phase held", flush=True)
        r1_out[title] = (rcalls,) + r1_run(rmodel, tcfg, rcalls, second,
                                           timed=rmodel is cfg)
        torch.cuda.empty_cache()
    r1_calls, r1_counts, r1_peak, r1_ms = r1_out["ffhq256-duplex"]
    r1_kernels = tuple(k for k in REPLACES if r1_counts[k])
    r1_sums = kernel_sums([row_of[call_key(c, "bfloat16")]
                           for c in r1_calls], r1_kernels)
    print_sums("  sums over the launches of one d_step_r1 (bf16, batch "
               f"{TRAIN_BATCH}):", r1_sums)
    for kname, s in r1_sums.items():
        if s["launches"] != r1_counts[kname]:
            fail(f"{kname}: the d_step_r1 made {r1_counts[kname]} launches, "
                 f"the sums cover {s['launches']}")
    print(f"  d_step_r1 {r1_ms['d_step_r1']:.2f} ms, d_step "
          f"{r1_ms['d_step']:.2f} ms, g_step {r1_ms['g_step']:.2f} ms (CUDA "
          f"events, mean of 3); peak device memory of one d_step_r1 "
          f"{r1_peak / 2**30:.2f} GiB ({card})", flush=True)

    # ---- path length: g_step_pl --------------------------------------------
    shrink = tcfg.pl_batch_shrink
    pcalls = pl_step_calls(cfg, TRAIN_BATCH, shrink)
    psecond = plan_pl_second_order_counts(cfg, TRAIN_BATCH, shrink)
    print(f"g_step_pl of ffhq256-duplex, batch {TRAIN_BATCH} (path length "
          f"on {TRAIN_BATCH // shrink}), bf16, pl_weight {tcfg.pl_weight}, "
          f"pl_decay {tcfg.pl_decay}, g_reg_interval "
          f"{tcfg.g_reg_interval}; launch plan "
          f"{plan_counts(pcalls, 'g_step_pl')}; with lse "
          f"{plan_lse_counts(pcalls, 'g_step_pl')}; second order "
          f"{psecond}", flush=True)
    check_fwd_configs(pcalls)
    check_bwd_configs(pcalls)
    check_attn_ufd_configs(pcalls)
    new, seen = [], set()
    for c in pcalls:
        key = call_key(c, "bfloat16")
        if key not in row_of and key not in seen:
            seen.add(key)
            new.append(c)
    print(f"  {len(new)} of its launch shapes no earlier phase held (the "
          "path-length batch's; the second order's are shapes of the "
          "first), kernel vs plain, bf16:", flush=True)
    row_of.update((call_key(c, "bfloat16"), r) for c, r in zip(
        new, check_kernels(new, "bfloat16", peaks)))
    torch.cuda.empty_cache()
    pl_counts, pl_peak, pl_ms = pl_run(cfg, tcfg, pcalls, psecond)
    pl_kernels = tuple(k for k in REPLACES if pl_counts[k])
    pl_sums = kernel_sums([row_of[call_key(c, "bfloat16")]
                           for c in pcalls], pl_kernels)
    print_sums("  sums over the launches of one g_step_pl (bf16, batch "
               f"{TRAIN_BATCH}):", pl_sums)
    for kname, s in pl_sums.items():
        if s["launches"] != pl_counts[kname]:
            fail(f"{kname}: the g_step_pl made {pl_counts[kname]} launches, "
                 f"the sums cover {s['launches']}")
    every = tcfg.g_reg_interval
    print(f"  g_step_pl {pl_ms['g_step_pl']:.2f} ms, g_step "
          f"{pl_ms['g_step']:.2f} ms, d_step {pl_ms['d_step']:.2f} ms (CUDA "
          f"events, mean of 3); a run's mean g step ({every - 1} g_step + "
          f"g_step_pl) / {every}: "
          f"{((every - 1) * pl_ms['g_step'] + pl_ms['g_step_pl']) / every:.2f}"
          f" ms; peak device memory of one g_step_pl "
          f"{pl_peak / 2**30:.2f} GiB ({card})", flush=True)
    torch.cuda.empty_cache()

    # ---- the other presets ------------------------------------------------
    if get_preset("bedroom256-duplex") != cfg:
        fail("bedroom256-duplex is no longer ffhq256-duplex's ModelConfig")
    print("bedroom256-duplex: the ModelConfig of ffhq256-duplex field for "
          "field, so its launches are the ones above", flush=True)
    for preset in PRESET_PHASES:
        preset_phase(preset, peaks, held)

    print(f"the tick loop of {LOOP_PRESET} on TFRecords, preempted after "
          f"tick 0 and resumed to {LOOP_KIMG} kimg (setup and run B):",
          flush=True)
    t_loop = time.perf_counter()
    run_b = start_run_b()
    t_loop = time.perf_counter() - t_loop
    print("card vs host gradients, fp32, batch 2, noise and mixing off:",
          flush=True)
    grads_compare(cfg, tcfg)
    print("card and host fp32 gradients against the host's float64 plain "
          f"path, batch 2, noise and mixing off (rule: within {GRAD_TOL} of "
          f"the leaf's max |float64|, or within {REF_HOST_FACTOR}x the host "
          "fp32's error on the leaf, the larger of two samples: on the "
          "inputs and on them at another fp32 rounding):", flush=True)
    reference_compare(cfg, tcfg)
    print(f"training phases took {time.perf_counter() - t_train:.1f} s",
          flush=True)
    torch.cuda.empty_cache()

    # ---- the tick loop: TFRecords, preemption, resume ----------------------
    t0 = time.perf_counter()
    print(f"the tick loop of {LOOP_PRESET} (run B's end, the checkpoint "
          f"round trip, run C):", flush=True)
    loop_phase(card, run_b)
    print(f"the loop phase took {t_loop + time.perf_counter() - t0:.1f} s "
          f"besides run B's time beside the reference phases", flush=True)

    # ---- one cycle's host syncs, prepare_data, generate -------------------
    t0 = time.perf_counter()
    print(f"one lazy-reg cycle of {LOOP_PRESET} under the sync debug "
          f"mode (batch 32, bf16, the smoke's TFRecords):", flush=True)
    sync_phase(card, run_b["exp"].data.path)
    print("prepare_data:", flush=True)
    prepare_data_phase(card)
    print("generate --run-dir on the loop's run:", flush=True)
    generate_phase(card, run_b["run"])
    print(f"the cycle, prepare_data and generate phases took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- metrics and evaluation -------------------------------------------
    t0 = time.perf_counter()
    print(f"metrics on the loop's run ({LOOP_PRESET}, bf16, "
          f"{LOOP_IMAGES} procedural reals):", flush=True)
    metrics_phase(card, run_b["run"])
    print(f"the metrics phase took {time.perf_counter() - t0:.1f} s; the "
          f"smoke {time.perf_counter() - t_start:.1f} s", flush=True)

    train_counts = {k: deltas["d_step"][k] + deltas["g_step"][k]
                    for k in TRAIN_KERNELS}
    span_train = f"one d_step + one g_step at batch {TRAIN_BATCH} (bf16)"
    span_r1 = f"one d_step_r1 at batch {TRAIN_BATCH} (bf16)"
    span_pl = f"one g_step_pl at batch {TRAIN_BATCH} (bf16)"
    kernels = [{
        "name": kname, "route": "cuda", "source": SOURCES[kname],
        "replaces": REPLACES[kname], "launches": launches,
        **{key: s[key] for key in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
        "span": span, **extra,
    } for sums, cnt, span, extra in (
        (run_sums, counts, "serve run: one synthesize at each of batch "
         "1, 2, 4, 8 (bf16)", {}),
        (lse_sums, lse_counts, span_train + ", forward launches that write "
         "lse", {"lse": True}),
        (train_sums, train_counts, span_train, {}),
        (r1_sums, r1_counts, span_r1, {}),
        (pl_sums, pl_counts, span_pl, {}))
        for kname, s in sums.items() for launches in (cnt[kname],)]
    print("kernels over each span's launches (ms, plain_ms, bound_ms and "
          "library_ms are sums over them):", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
