#!/usr/bin/env python3
"""Where the fp32 gradient of a d_step_r1 with ``d_attention`` leaves the
host's float64 plain path, at ffhq256-duplex width (batch 2, fp32, noise
off, the generator's ReZero gates at 0.1, seed 0), on the reals and G's
float64 images of ``chip_smoke.py``'s ``reference_compare``, taken
apart, with G's images both raw and in the reals' range (the smoke's).

1. The float64 path's own conditioning: D in float64 on the reals, on
   G's images and on G's images divided by their largest |value| (in the
   reals' range), and on the same inputs each scaled by (1 + u e) with u the
   fp32 unit roundoff (2^-24) and e drawn from N(0, 1): the logits and the
   largest relative change of each block's output, and the largest
   attention logit |q k / sqrt(d)| of each block on the unperturbed input.
2. The step's D gradient by branch (the logistic loss on the reals, on
   G's images, on G's images in the reals' range, and the weighted R1
   penalty; a step is the sum of three), each in float64 (the
   reference), in float64 on the perturbed inputs (what the reference
   itself moves by for an fp32 rounding of its inputs), in fp32 on the
   host (all threads, one thread: another summation order, and all
   threads on the perturbed inputs), and in fp32 on the card by four
   routes:
     kernels        kernels 2/7 and 3/4/8/9 as ``d_step_r1`` runs them
     flash plain    the same Functions, each attention launch replaced by
                    its plain version (flash form: P = exp(s - lse))
     softmax 2nd    the kernels, the second order differentiating the
                    softmax form (``attention_plain``) instead
     attention plain  both attention directions as ``attention_plain``
                    under autograd (no attention Function)
   For each, and for the step on either fakes: the median and
   largest error per leaf relative to the leaf's largest float64 entry
   (a key bias at its weight's scale), and the number of leaves beyond
   1e-2 of it.

Run from the repository root on a machine with one CUDA card:

    python3 r1_reference.py            # all of it (about 5 minutes)
    python3 r1_reference.py --kernels  # 3 alone

3. (on the card, printed first) ``chip_smoke.logit_scaling``: the
   attention kernels' error against float64 as the logits grow, in fp32
   and bf16.
"""

import argparse
import contextlib
import dataclasses
import sys
import time

import torch
import torch.nn.functional as F

import chip_smoke as cs

perturbed = cs.perturbed


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| over max |ref|."""
    return float((got - ref).abs().max() / ref.abs().max())


def inputs(model, train):
    from gansformer_tpu_torch.data import SyntheticDataset, normalize_images

    reals = normalize_images(torch.from_numpy(next(SyntheticDataset(
        model.resolution, model.img_channels).batches(2, seed=5))))
    return reals.double(), cs.host_fakes(model, train)


def conditioning(model, train, images):
    from gansformer_tpu_torch.models import attention as mattn
    from gansformer_tpu_torch.train import create_train_state

    state = create_train_state(dataclasses.replace(model, dtype="float64"),
                               train, seed=0, device="cpu")
    d = state.discriminator
    outs = []
    hooks = [m.register_forward_hook(
        lambda m, i, o, n=n: outs.append((n, o[0] if isinstance(o, tuple)
                                          else o)))
        for n, m in d.named_children()]
    fused, logits = mattn.fused_multihead_attention, []

    def logged(q, k, v, heads):
        qh = q.reshape(*q.shape[:2], heads, -1)
        kh = k.reshape(*k.shape[:2], heads, -1)
        logits.append(float(torch.einsum("nqhd,nkhd->nhqk", qh, kh).abs()
                            .max()) / qh.shape[-1] ** 0.5)
        return fused(q, k, v, heads)

    for title, x in images.items():
        with torch.no_grad():
            outs.clear()
            mattn.fused_multihead_attention = logged
            try:
                a = d(x)
            finally:
                mattn.fused_multihead_attention = fused
            base = list(outs)
            outs.clear()
            b = d(perturbed(x, 1))
        print(f"  D in float64 on the {title} (max |x| "
              f"{float(x.abs().max()):.3f}): logits {a.flatten().tolist()}, "
              f"on them scaled by (1 + 2^-24 e): "
              f"{b.flatten().tolist()}", flush=True)
        print("    largest relative change of each block's output: "
              + ", ".join(f"{n} {_rel(v, u):.2e}"
                          for (n, u), (_, v) in zip(base, outs)
                          if n.endswith(("_attn", "_conv1", "head_out"))),
              flush=True)
        print("    largest |logit| of each attention (in D's order): "
              + ", ".join(f"{v:.3e}" for v in logits), flush=True)
        logits.clear()
    for h in hooks:
        h.remove()


def softmax_second_order(q, k, v, do, gdq, gdk, gdv, delta_from_o):
    """The VJP of the attention backward by autograd of the softmax form
    (``attention_plain``), in place of the flash form's."""
    from gansformer_tpu_torch.ops.attention import attention_plain

    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (q, k, v, do)]
        o = attention_plain(*ins[:3])
        grads = torch.autograd.grad(o, ins[:3], ins[3], create_graph=True)
        return torch.autograd.grad(grads, ins, (gdq, gdk, gdv))


@contextlib.contextmanager
def route(name):
    from gansformer_tpu_torch.ops import attention as att
    from gansformer_tpu_torch.ops import cuda_attention as ca

    saved = {k: getattr(ca, k) for k in (
        "grid_to_latent", "latent_to_grid", "grid_to_latent_cuda",
        "latent_to_grid_cuda", "grid_to_latent_bwd_cuda",
        "latent_to_grid_bwd_cuda", "attention_bwd_vjp_plain")}

    def fwd(q, k, v, with_stats=False):
        with torch.no_grad():
            return (att.attention_fwd_stats_plain(q, k, v) if with_stats
                    else att.attention_plain(q, k, v))

    def bwd(q, k, v, lse, do, delta=None):
        with torch.no_grad():
            return att.attention_bwd_plain(q, k, v, lse, do, delta)

    def g2l_bwd(q, k, v, do):
        with torch.no_grad():
            return att.attention_bwd_own_lse_plain(q, k, v, do)

    if name == "flash plain":
        ca.grid_to_latent_cuda = ca.latent_to_grid_cuda = fwd
        ca.grid_to_latent_bwd_cuda, ca.latent_to_grid_bwd_cuda = g2l_bwd, bwd
    elif name == "softmax 2nd":
        ca.attention_bwd_vjp_plain = softmax_second_order
    elif name == "attention plain":
        ca.grid_to_latent = ca.latent_to_grid = att.attention_plain
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(ca, k, v)


def branch_grads(model, train, branch, dev, dtype, x):
    """D's gradient of one branch of the d_step_r1 loss on images ``x``:
    "reals" softplus(-D(x)), "fakes" softplus(D(x)), "R1" the weighted
    penalty."""
    from gansformer_tpu_torch.core.precision import input_dtype
    from gansformer_tpu_torch.losses import r1_penalty
    from gansformer_tpu_torch.train import create_train_state

    state = create_train_state(dataclasses.replace(model, dtype=dtype),
                               train, seed=0, device=dev)
    d = state.discriminator
    x = x.to(dev, input_dtype(dtype))
    if branch == "reals":
        loss = F.softplus(-d(x)).mean()
    elif branch == "fakes":
        loss = F.softplus(d(x)).mean()
    else:
        t = state.train
        loss = (t.r1_gamma * 0.5) * r1_penalty(d, x) * t.d_reg_interval
    grads = torch.autograd.grad(loss, list(d.parameters()),
                                allow_unused=True)
    return {n: (torch.zeros_like(p) if g is None else g).detach().double()
            .cpu() for (n, p), g in zip(d.named_parameters(), grads)}


def errors(ref, got):
    rows = []
    for n, r in ref.items():
        scale = float((ref[n[:-1] + "w"] if cs._key_bias(n) else r)
                      .abs().max())
        err = float((got[n] - r).abs().max())
        if scale == 0.0 and err == 0.0:
            continue
        rows.append((err / max(scale, 1e-30), n))
    rows.sort(reverse=True)
    return rows


def misses(ref, card, hosts):
    """The leaves of ``card`` beyond the rule of ``chip_smoke.py``'s
    reference check with ``hosts`` as the host's fp32 samples."""
    out = []
    for n, r in ref.items():
        scale = float((ref[n[:-1] + "w"] if cs._key_bias(n) else r)
                      .abs().max())
        herr = max(float((h[n] - r).abs().max()) for h in hosts)
        if float((card[n] - r).abs().max()) > max(
                cs.GRAD_TOL * scale, cs.REF_HOST_FACTOR * herr):
            out.append(n)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", action="store_true",
                    help="section 3 alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("CUDA is not available")
    from gansformer_tpu_torch.core import get_preset, get_train_preset

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    print("3. the attention kernels' error as the logits grow:",
          flush=True)
    cs.logit_scaling(gate=False)
    if args.kernels:
        return 0
    model = dataclasses.replace(get_preset("ffhq256-duplex"),
                                dtype="float32", d_attention=True)
    train = dataclasses.replace(get_train_preset("ffhq256-duplex"),
                                style_mixing_prob=0.0)
    reals, fakes = inputs(model, train)
    scaled = fakes / fakes.abs().max()
    print("1. conditioning of the float64 path:", flush=True)
    conditioning(model, train, {"reals": reals, "G's images": fakes,
                                "G's images in the reals' range": scaled})
    print("2. D's gradient by branch, against float64 (error relative to "
          "the leaf's max |float64|):", flush=True)
    threads = torch.get_num_threads()
    sides = [("float64 on perturbed inputs", "cpu", "float64", None),
             (f"host fp32 {threads} threads", "cpu", "float32", None),
             ("host fp32 1 thread", "cpu", "float32", None),
             ("host fp32 perturbed inputs", "cpu", "float32", None)]
    sides += [(f"card {r}", "cuda", "float32", r) for r in (
        "kernels", "flash plain", "softmax 2nd", "attention plain")]

    def show(side, ref, got, secs):
        rows = errors(ref, got)
        beyond = sum(e > cs.GRAD_TOL for e, _ in rows)
        print(f"    {side:28s} median {rows[len(rows) // 2][0]:.3e}, "
              f"{beyond} of {len(rows)} beyond {cs.GRAD_TOL}, worst "
              + ", ".join(f"{e:.3e} ({n})" for e, n in rows[:3])
              + (f"  [{secs:.1f} s]" if secs is not None else ""),
              flush=True)

    branches = (("reals", "reals", reals), ("G's images", "fakes", fakes),
                ("G's images in the reals' range", "fakes", scaled),
                ("R1", "R1", reals))
    got = {}
    for title, branch, x in branches:
        t0 = time.perf_counter()
        got[title, "float64"] = branch_grads(model, train, branch, "cpu",
                                             "float64", x)
        print(f"  {title}: float64 {time.perf_counter() - t0:.1f} s",
              flush=True)
        for seed, (side, dev, dtype, r) in enumerate(sides):
            t0 = time.perf_counter()
            torch.set_num_threads(1 if side.endswith("1 thread")
                                  else threads)
            xs = perturbed(x, seed) if "perturbed" in side else x
            try:
                with route(r) if r else contextlib.nullcontext():
                    got[title, side] = branch_grads(model, train, branch,
                                                    dev, dtype, xs)
            finally:
                torch.set_num_threads(threads)
            show(side, got[title, "float64"], got[title, side],
                 time.perf_counter() - t0)
    cases = {"the R1 penalty": ("R1",),
             "the step on G's images": ("reals", "G's images", "R1"),
             "the step on G's images in the reals' range": (
                 "reals", "G's images in the reals' range", "R1")}
    for case, parts in cases.items():
        print(f"  {case} (the sum of {', '.join(parts)}):", flush=True)
        total = {side: {n: sum(got[t, side][n] for t in parts)
                        for n in got["R1", "float64"]}
                 for side in ["float64"] + [s[0] for s in sides]}
        for side, *_ in sides:
            show(side, total["float64"], total[side], None)
        every, one, pert = (total[h] for h, *_ in sides[1:4])
        rules = {"the all-thread host": [every],
                 "it and the one-thread host": [every, one],
                 "it and the host on perturbed inputs": [every, pert]}
        for side, *_ in sides[1:]:
            for rule, hosts in rules.items():
                miss = misses(total["float64"], total[side], hosts)
                print(f"    {side}: {len(miss)} leaves miss the rule with "
                      f"{rule} {miss[:4]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
