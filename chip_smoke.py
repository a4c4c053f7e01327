#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # one card, no arguments

In order:
1. prints the card's name and power limit (nvidia-smi);
2. builds the kernels from ``gansformer_tpu_torch/csrc``;
3. serving.  For every kernel launch of the serve run below (one
   ``synthesize`` of ffhq256-duplex at each of batch 1, 2, 4 and 8,
   bf16), and for the flagship shapes in fp32 too: runs the kernel and
   its plain PyTorch version on the same inputs on the card and holds
   them to the stated tolerance; times the kernel, the plain version and
   one library call computing the same function (the yardstick), and
   computes the least time the card could take (the bound).  Where
   latent_to_grid splits n into chunks, it also shows the tolerance
   rejects the output of a kernel that dropped one chunk;
4. serves ffhq256-duplex at full width from a random init (bf16):
   ``map_seeds`` + ``synthesize`` over buckets 1, 2, 4 and 8 with mixed
   psi, with the launch counters reset just before and read just after;
   checks the images are finite and the counters moved by exactly the
   launches the path makes per synthesize; measures images/s;
5. compares the card's images (fp32 and bf16 kernels) with the plain path
   on the host CPU (fp32) at batch 2 and noise off: a wrapper never routes
   a CUDA tensor to its plain version, so the host run is the plain path;
6. training (the ffhq256-duplex preset itself: full width and depth,
   attention on, batch 8, bf16, random init from seed 0, noise on, style
   mixing 0.9, procedural reals).  For every backward launch of one
   d_step and one g_step (modconv dx/ds, modconv dw, upfirdn adjoint,
   grid->latent and latent->grid backward), every forward attention
   launch that writes ``lse`` (G's in the g_step; G's forward in the
   d_step runs under no_grad and writes none), and the discriminator's
   forward upfirdn launches: the kernel against its plain version (bf16;
   fp32 too at the flagship shapes), timed like phase 3 (the attention
   backward's yardstick is the backward alone of
   ``scaled_dot_product_attention``, with the backend PyTorch picked),
   with planted-fault controls the tolerance must reject: dw with one
   sample's term dropped, ds with one 64-pixel tile's partial dropped,
   the adjoint with its filter not flipped (at the path's symmetric
   filter that changes nothing, so each adjoint geometry also runs with
   an asymmetric filter), the attention backward with one chunk's
   partial dropped (dk/dv of grid->latent, dq of latent->grid) and with
   its row correction delta left out, and lse without log(den);
7. drives ``d_step`` + ``g_step`` with the counters reset just before and
   read just after each, and checks them (and the launches that wrote
   lse) against the launch plan; then 3 more alternating iterations:
   finite losses, every gradient leaf finite and nonzero, parameters and
   EMA moved; ms per step by CUDA events and the profiler's breakdown;
   then the preset with ``d_attention`` (one d_step + one g_step): its
   counters against its plan, finite losses and gradients, and any
   attention launch shape the preset's run did not hold against its
   plain version;
8. one d_step and one g_step in fp32 at batch 2 (noise off, mixing off)
   on the card and on the host: every gradient leaf held to the host's,
   D's and G's apart, the attention leaves printed apart; then G alone,
   both sides given the host's gradient of the loss wrt the images (D's
   cuDNN convolutions out of the chain);
9. prints the kernels' JSON line, then ``{"ok": true, "device": ...}``.
   Every number of a kernel in the JSON line covers that kernel's
   ``span``: the serve run's launches for the forward kernels (and, in a
   second entry with ``"lse": true``, the forward attention launches of
   one d_step + one g_step that write lse), one d_step + one g_step for
   the backward kernels.

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


def attention_cost(call, itemsize: int):
    """(bytes, operations) of one attention launch in a dtype of
    ``itemsize`` bytes, each input read once and each output written
    once.  Forward: q, k, v read, o written (+ the fp32 lse when written);
    2 Lq Lk (D + Dv) operations.  Backward: q, k, v, do and the fp32 lse
    read (latent_to_grid also reads its fp32 delta), dq, dk, dv written;
    the five products of a flash-attention backward (S recomputed, dV, dP,
    dQ, dK), 2 Lq Lk (3 D + 2 Dv) operations."""
    b, lq, lk, d, dv = call["B"], call["Lq"], call["Lk"], call["D"], \
        call["Dv"]
    if call["kernel"] in ATTENTION_KERNELS:
        nbytes = (b * lq * d + b * lk * d + b * lk * dv + b * lq * dv) \
            * itemsize + (4 * b * lq if call.get("lse") else 0)
        return nbytes, 2.0 * b * lq * lk * (d + dv)
    stats = 2 if call["kernel"] == "latent_to_grid_bwd" else 1
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


def library_upfirdn(x, f, up, pads, down=1):
    """One library call computing upfirdn2d for the path's cases: a
    (decimating) blur on the pre-padded input (up = 1), and the zero-insert
    upsample by 2 with pads (2, 1) (G's skip upsample, D's skip adjoint)."""
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
        return lambda: F.conv2d(xp, kf, stride=down, groups=c)
    assert up == 2 and down == 1 and pads == (2, 1, 2, 1) \
        and k.shape == (4, 4)
    kt = k[None, None].expand(c, 1, 4, 4).contiguous()
    return lambda: F.conv_transpose2d(xc, kt, stride=2, padding=1, groups=c)


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
    latent_to_grid's fault drops one of its ``chunk``-key chunks, and the
    attention backward's faults one of their ``chunk``-row chunks (the
    kernel's own chunk unless given).  The attention backward's case also
    names the SDPA backend of its library call (``library_backend``)."""
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
                    ops=ops, outputs=("out",), controls=[])
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
            tile = cuda_modconv.dx_tile_pixels() if dev == "cuda" else 64

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
        f = setup_filter((1, 3, 3, 1), gain=call.get("gain", 4.0))
        if kname == "upfirdn":
            x = randn(b, h, h, c).to(dtype)
            args = (x, f, up, down, pads, None, None, 0.2, 1.0)
            oh = out_hw(h, h, 4, 4, up, down, pads)[0]
            kern = lambda: cuda_upfirdn.upfirdn2d_cuda(*args)  # noqa: E731
            plain = lambda: upfirdn2d_plain(*args)             # noqa: E731
            lib = library_upfirdn(x, f, up, pads, down)
            controls = []
            in_elems, out_elems, eff_up = x.numel(), b * oh * oh * c, up
        else:
            oh = out_hw(h, h, 4, 4, up, down, pads)[0]
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
        nbytes = (in_elems + out_elems) * it
        ops = 2.0 * out_elems * f.size / (eff_up * eff_up)
        return dict(kernel=kern, plain=plain, library=lib, bytes=nbytes,
                    ops=ops, outputs=("out",), controls=controls)
    return _attention_case(call, dtype, randn, dev, chunk)


def _without_middle_chunk(n: int, chunk: int, dev):
    """Indices 0..n-1 without the middle ``chunk``-row chunk, or None when
    n fits in one chunk."""
    import torch

    if n <= chunk:
        return None
    c0 = (-(-n // chunk) // 2) * chunk
    return torch.cat([torch.arange(0, c0, device=dev),
                      torch.arange(c0 + chunk, n, device=dev)])


def _attention_case(call, dtype, randn, dev, chunk):
    """``build_case`` for the four attention kernels.  Forward: o (and
    lse when the call writes it).  Backward: dq, dk, dv on the forward's
    lse (and, for latent_to_grid, delta = rowsum(do * o)) computed by the
    plain version on the same inputs."""
    import torch

    from gansformer_tpu_torch.ops import _build, cuda_attention
    from gansformer_tpu_torch.ops.attention import (attention_bwd_plain,
                                                    attention_delta,
                                                    attention_fwd_stats_plain,
                                                    attention_plain)

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
        if kname == "latent_to_grid":
            keep = _without_middle_chunk(
                lk, chunk or _build.load_library().gt_attn_chunk(), dev)
            if keep is not None:
                controls.append(dict(
                    desc="drop-one-chunk", out=0,
                    fault=lambda: attention_plain(q, k[:, keep], v[:, keep])))
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
    chunk = chunk or _build.load_library().gt_attn_bwd_rows()
    library, backend = library_attention_bwd(q, k, v, do)
    if kname == "grid_to_latent_bwd":
        args = (q, k, v, lse, do)
        kern = lambda: cuda_attention.grid_to_latent_bwd_cuda(*args)  # noqa
        keep = _without_middle_chunk(lq, chunk, dev)
        if keep is not None:
            def drop(i):
                return lambda: attention_bwd_plain(
                    q[:, keep], k, v, lse[:, keep], do[:, keep])[i]

            controls += [dict(desc="dk without one row chunk's partial",
                              out=1, fault=drop(1)),
                         dict(desc="dv without one row chunk's partial",
                              out=2, fault=drop(2))]
        zero = torch.zeros_like(lse)
        controls += [dict(desc=f"{name} with dS = P dP (no delta)", out=i,
                          fault=lambda i=i: attention_bwd_plain(
                              *args, delta=zero)[i])
                     for i, name in ((0, "dq"), (1, "dk"))]
    else:
        delta = attention_delta(o, do)
        args = (q, k, v, lse, do, delta)
        kern = lambda: cuda_attention.latent_to_grid_bwd_cuda(*args)  # noqa
        keep = _without_middle_chunk(lk, chunk, dev)
        if keep is not None:
            controls.append(dict(
                desc="dq without one key chunk's partial", out=0,
                fault=lambda: attention_bwd_plain(
                    q, k[:, keep], v[:, keep], lse, do, delta)[0]))
        zero = torch.zeros_like(delta)
        controls += [dict(desc=f"{name} with delta = 0", out=i,
                          fault=lambda i=i: attention_bwd_plain(
                              q, k, v, lse, do, zero)[i])
                     for i, name in ((0, "dq"), (1, "dk"))]
    return dict(kernel=kern, plain=lambda: attention_bwd_plain(*args),
                library=library, library_backend=backend, bytes=nbytes,
                ops=ops, outputs=("out", "out", "out"), controls=controls)


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
                 ("upfirdn", "upfirdn_kernel"),
                 ("grid_to_latent", "g2l_kernel"),
                 ("latent_to_grid", "l2g_"), ("matmul", "gemm"),
                 ("matmul", "cutlass"), ("cudnn conv", "conv"),
                 ("cudnn conv", "cudnn"), ("noise draw", "distribution"))


def profile(fn, title):
    """Device time of one call of ``fn`` by kernel group (the profiler's
    CUDA activity), and the device-busy share of its wall time."""
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
    print(f"  {title}: wall {wall_ms:.2f} ms (profiled), device busy "
          f"{device_ms:.2f} ms ({100 * device_ms / wall_ms:.1f} % of wall)")
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


def counted_steps(state, reals, calls):
    """One d_step and one g_step with the counters reset just before and
    read just after each, held to the plan (kernel launches and the
    attention launches that wrote lse); returns the counts per phase and
    the lse counts over both steps."""
    import torch

    from gansformer_tpu_torch import ops
    from gansformer_tpu_torch.train import d_step, g_step

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    aux = d_step(state, reals, 0)
    torch.cuda.synchronize()
    after_d, lse_d = ops.launch_counts(), ops.lse_launch_counts()
    aux.update(g_step(state, 0, TRAIN_BATCH))
    torch.cuda.synchronize()
    after_g, lse_g = ops.launch_counts(), ops.lse_launch_counts()
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
    for name in TRAIN_KERNELS:
        if after_g[name] == 0:
            fail(f"kernel {name} was not launched on the training path")
    losses = {k: float(v) for k, v in aux.items()}
    if not all(math.isfinite(v) for v in losses.values()):
        fail(f"non-finite loss {losses}")
    return {p: d[0] for p, d in deltas.items()}, lse_g, losses


def check_grads(state):
    """Every gradient leaf of G and D present, finite and nonzero."""
    import torch

    grads = _named_grads(state)
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
    batches = [torch.from_numpy(next(data)).cuda() for _ in range(4)]
    deltas, lse_counts, _ = counted_steps(state, batches[0], calls)
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
                                                      seed=1))).cuda()
    _, _, losses = counted_steps(state, reals, calls)
    print(f"  losses {losses}", flush=True)
    check_grads(state)


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
        model.resolution, model.img_channels).batches(2, seed=5)))
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
    for kname, regs, spill in ptxas_summary(_build.build_info.get("log",
                                                                  "")):
        print(f"  ptxas: {kname} {regs} registers, {spill} bytes spilled",
              flush=True)

    # ---- serving ----------------------------------------------------------
    cfg = get_preset("ffhq256-duplex")
    calls = {b: main_path_calls(cfg, b) for b in BUCKETS}
    expected = {k: sum(c["kernel"] == k for c in calls[8]) for k in REPLACES}
    print(f"launches per synthesize at ffhq256-duplex: {expected}",
          flush=True)
    if expected != dict(dict.fromkeys(REPLACES, 0), modconv=20, upfirdn=12,
                        grid_to_latent=7, latent_to_grid=5):
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
                   f"synthesize at batch {b}:",
                   kernel_sums(bucket_rows, SERVE_KERNELS))
        rows += bucket_rows
    run_sums = kernel_sums(rows, SERVE_KERNELS)
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
    del bundle
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
    checked = [c for c in tcalls if c["kernel"] in TRAIN_KERNELS
               or c["label"].startswith("D") or c.get("lse")]
    print("train kernels vs plain, fp32, flagship shapes at batch "
          f"{TRAIN_BATCH}:", flush=True)
    seen, flag = set(), []
    for c in checked:
        if c["label"] in TRAIN_FLAGSHIP and c["label"] not in seen:
            seen.add(c["label"])
            flag.append(c)
    check_kernels(flag, "float32", peaks)
    print("kernels vs plain, bf16, every backward launch of one d_step + "
          "one g_step, every forward attention launch that writes lse, and "
          "D's forward upfirdn launches:", flush=True)
    train_rows = check_kernels(checked, "bfloat16", peaks)
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

    def shape(c):
        return tuple(c.get(key) for key in ("kernel", "B", "Lq", "Lk", "D",
                                            "Dv", "lse"))

    held = {shape(c) for c in checked}
    new, seen = [], set()
    for c in dcalls:
        if c["kernel"].startswith(ATTENTION_KERNELS) and \
                (c.get("lse") or c["kernel"] not in ATTENTION_KERNELS) \
                and shape(c) not in held | seen:
            seen.add(shape(c))
            new.append(c)
    if new:
        print("  its attention launch shapes that the preset's run does not "
              "hold, kernel vs plain, bf16:", flush=True)
        check_kernels(new, "bfloat16", peaks)
    else:
        print("  every attention launch shape of its d_step + g_step is "
              "one the preset's run already held", flush=True)
    d_attention_run(dmodel, tcfg, dcalls)
    torch.cuda.empty_cache()

    print("card vs host gradients, fp32, batch 2, noise and mixing off:",
          flush=True)
    grads_compare(cfg, tcfg)
    print(f"training phases took {time.perf_counter() - t_train:.1f} s; "
          f"the smoke {time.perf_counter() - t_start:.1f} s", flush=True)

    train_counts = {k: deltas["d_step"][k] + deltas["g_step"][k]
                    for k in TRAIN_KERNELS}
    span_train = f"one d_step + one g_step at batch {TRAIN_BATCH} (bf16)"
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
        (train_sums, train_counts, span_train, {}))
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
