#!/usr/bin/env python3
"""Whether the losses grow from random init (ROADMAP C.19), and where.

Runs ffhq256-duplex's training iterations at the tick loop's cadence
(``d_step_r1`` every ``d_reg_interval`` iterations, else ``d_step``; then
``g_step_pl`` every ``g_reg_interval``, else ``g_step``) from a fresh
state, in fp32 unless a run says otherwise, and prints Loss/G/pl and
``pl_mean`` at every path-length iteration, Loss/G and D's fake score at
every iteration.

    python3 c19_probe.py card ROUTE:BATCH:DTYPE:ITERS:SEED[:RES:FMAP_MAX] ...
    python3 c19_probe.py steps BATCH ITERS SEED
    python3 c19_probe.py host RES FMAP_MAX BATCH ITERS SEED[,SEED...]

``card``: on the GPU, each run from a fresh state of its seed.  ROUTE
``cuda`` launches the kernels; ``plain`` runs every kernel's plain
PyTorch version on the card's tensors (the wrappers' ``kernel_route``
set off: a diagnostic route, never the port's).  Every draw comes from a
CPU generator (the conv noise and the path-length projection too), so
both routes see the same draws; the reals are 256 procedural 256² images
written as TFRecords (``chip_smoke.write_loop_dataset``), or the
procedural set at RES when the run gives RES and FMAP_MAX (the preset
cut to that resolution and width).  A run stops after 120 s.

``steps``: on the GPU, the kernel route's run of one seed (fp32, the
TFRecords), and at every step the same step from a copy of its state on
the plain route: both steps' losses, and the largest difference of the
two routes' gradients relative to the leaf's largest gradient (the
attention key biases apart: their exact gradient is zero, so both
routes hold rounding noise there); at each path-length step the penalty
alone too.

``host``: on the CPU, the preset cut to RES and FMAP_MAX, the procedural
reals at RES: the port's plain path from its seed's state with its own
draws, then the JAX package's steps (``make_train_steps``, JAX's own
draws, as JAX's loop folds them) from the same state, carried over in
the checkpoint format both packages read.  This mode imports JAX: run it
where JAX is installed (``JAX_PLATFORMS=cpu``), never on the card.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
import time
import types

import torch

CAP_S = 120
DEVICE = "cuda"


def _preset(res=None, fmap_max=None, dtype="float32"):
    from gansformer_tpu_torch.core.config import get_experiment_preset

    exp = get_experiment_preset("ffhq256-duplex")
    model = dataclasses.replace(exp.model, dtype=dtype)
    if res:
        model = dataclasses.replace(
            model, resolution=res, fmap_max=fmap_max,
            attn_max_res=min(model.attn_max_res, res))
        exp = dataclasses.replace(exp, data=dataclasses.replace(
            exp.data, resolution=res, source="synthetic", path=None))
    return dataclasses.replace(exp, model=model)


def _line(label, pls, gs=None, fakes=None, seconds=None):
    peak = max(p for _, p, _ in pls)
    print(f"{label}: {seconds:.1f} s; Loss/G/pl first {pls[0][1]:.4g}, max "
          f"{peak:.4g} ({peak / pls[0][1]:.3g}x)", flush=True)
    print("  pl (pl_mean): " + ", ".join(
        f"it{i} {p:.4g} ({m:.4g})" for i, p, m in pls), flush=True)
    if gs:
        print("  Loss/G: " + ", ".join(f"{g:.3g}" for g in gs), flush=True)
        print("  D fake score: " + ", ".join(f"{f:.3g}" for f in fakes),
              flush=True)


def _port_run(exp, seed, batch, iters, dev, batches, cap_s=None):
    """The loop's iterations of the port's steps; every draw from CPU
    generators where ``dev`` is the card."""
    from gansformer_tpu_torch.train import create_train_state, derive_seed
    from gansformer_tpu_torch.train import steps

    t = dataclasses.replace(exp.train, batch_size=batch, seed=seed)
    m = exp.model
    state = create_train_state(m, t, seed, dev)
    pls, gs, fakes = [], [], []
    t0 = time.time()
    for it in range(iters):
        imgs = torch.from_numpy(next(batches)["image"]).to(dev)
        d_fn = steps.d_step_r1 if it % t.d_reg_interval == 0 \
            else steps.d_step
        d_aux = d_fn(state, imgs, it, mirror_augment=exp.data.mirror_augment)
        if it % t.g_reg_interval == 0:
            pb = max(1, batch // t.pl_batch_shrink)
            noise = torch.randn(
                (pb, m.resolution, m.resolution, m.img_channels),
                generator=torch.Generator().manual_seed(
                    derive_seed(seed, it, "g", "pl", "projection")))
            g_aux = steps.g_step_pl(state, it, batch, pl_noise=noise)
            pls.append((it, float(g_aux["Loss/G/pl"]),
                        float(state.pl_mean)))
        else:
            g_aux = steps.g_step(state, it, batch)
        gs.append(float(g_aux["Loss/G"]))
        fakes.append(float(d_aux["Loss/scores/fake"]))
        if cap_s is not None and time.time() - t0 > cap_s:
            break
    return pls, gs, fakes, time.time() - t0


def _card_setup():
    """fp32 without TF32, CPU generators for every draw of the steps (the
    same draws on either route), run B's TFRecords; returns (a route
    setter, the records' directory)."""
    import chip_smoke
    import gansformer_tpu_torch.core.device as device
    import gansformer_tpu_torch.ops.cuda_attention as ca
    import gansformer_tpu_torch.ops.modulated_conv as mc
    import gansformer_tpu_torch.ops.upfirdn2d as uf
    from gansformer_tpu_torch.train import steps

    if not torch.cuda.is_available():
        sys.exit("c19_probe.py card / steps need a GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_gens = types.ModuleType("torch_cpu_generators")
    cpu_gens.__dict__.update(torch.__dict__)
    cpu_gens.Generator = lambda device=None: torch.Generator()
    steps.torch = cpu_gens

    def route(kernels: bool):
        for m in (mc, uf, ca):
            m.kernel_route = device.kernel_route if kernels \
                else (lambda t: False)

    root = tempfile.mkdtemp(prefix="c19_")
    return route, chip_smoke.write_loop_dataset(root, 256)


def card(specs):
    """Each spec ROUTE:BATCH:DTYPE:ITERS:SEED[:RES:FMAP_MAX] on the GPU."""
    from gansformer_tpu_torch.data.dataset import (SyntheticDataset,
                                                   make_dataset)

    route, records = _card_setup()
    for spec in specs:
        kind, batch, dtype, iters, seed, *cut = spec.split(":")
        batch, iters, seed = int(batch), int(iters), int(seed)
        res, fmap_max = (int(v) for v in cut) if cut else (None, None)
        route(kind == "cuda")
        exp = _preset(res, fmap_max, dtype)
        ds = (SyntheticDataset(res, num_images=256) if res else make_dataset(
            dataclasses.replace(exp.data, path=records)))
        try:
            out = _port_run(exp, seed, batch, iters, DEVICE,
                            ds.batches(batch, seed=seed + 1), CAP_S)
        finally:
            ds.close()
        _line(f"{kind} res {exp.model.resolution} fmap_max "
              f"{exp.model.fmap_max} batch {batch} {dtype} seed {seed}, "
              f"{len(out[1])} iterations", out[0], out[1], out[2], out[3])
        if DEVICE == "cuda":
            torch.cuda.empty_cache()


def steps_compare(batch, iters, seed):
    """The kernel route's trajectory, each step also run on the plain
    route from a copy of the state before it."""
    import copy

    from chip_smoke import _key_bias
    from gansformer_tpu_torch.data.dataset import make_dataset
    from gansformer_tpu_torch.train import create_train_state, derive_seed
    from gansformer_tpu_torch.train import steps

    route, records = _card_setup()
    exp = _preset()
    t = dataclasses.replace(exp.train, batch_size=batch, seed=seed)
    m = exp.model
    state = create_train_state(m, t, seed, DEVICE)
    ds = make_dataset(dataclasses.replace(exp.data, path=records))
    reals = ds.batches(batch, seed=seed + 1)

    def grads(module):
        return {n: p.grad.detach().clone()
                for n, p in module.named_parameters() if p.grad is not None}

    def worst(got, ref):
        return max((float((got[n] - r).abs().max()
                          / r.abs().max().clamp_min(1e-30)), n)
                   for n, r in ref.items() if not _key_bias(n))

    def pl_noise(it):
        pb = max(1, batch // t.pl_batch_shrink)
        return torch.randn(
            (pb, m.resolution, m.resolution, m.img_channels),
            generator=torch.Generator().manual_seed(
                derive_seed(seed, it, "g", "pl", "projection")))

    def step(st, kind, it, imgs):
        if kind.startswith("d"):
            fn = steps.d_step_r1 if kind == "d_step_r1" else steps.d_step
            aux = fn(st, imgs, it, mirror_augment=exp.data.mirror_augment)
            return aux, grads(st.discriminator)
        aux = steps.g_step_pl(st, it, batch, pl_noise=pl_noise(it)) \
            if kind == "g_step_pl" else steps.g_step(st, it, batch)
        return aux, grads(st.generator)

    def penalty(st, it, kernels):
        route(kernels)
        st = copy.deepcopy(st)
        st.generator.zero_grad(set_to_none=True)
        pl, _ = steps.pl_term(st, it, batch, pl_noise=pl_noise(it))
        pl.backward()
        route(True)
        return float(pl.detach()), grads(st.generator)

    try:
        for it in range(iters):
            imgs = torch.from_numpy(next(reals)["image"]).to(DEVICE)
            for kind in ("d_step_r1" if it % t.d_reg_interval == 0
                         else "d_step",
                         "g_step_pl" if it % t.g_reg_interval == 0
                         else "g_step"):
                before = copy.deepcopy(state)
                extra = ""
                if kind == "g_step_pl":
                    (pk, gk), (pp, gp) = (penalty(before, it, True),
                                          penalty(before, it, False))
                    d, n = worst(gk, gp)
                    extra = (f"; the penalty alone {pk:.4g} / {pp:.4g}, "
                             f"gradients {d:.3e} at {n}")
                route(True)
                aux_k, gk = step(state, kind, it, imgs)
                route(False)
                aux_p, gp = step(before, kind, it, imgs)
                route(True)
                d, n = worst(gk, gp)
                print(f"it {it:2d} {kind:9s} kernels / plain: " + ", ".join(
                    f"{k} {float(aux_k[k]):.4g} / {float(aux_p[k]):.4g}"
                    for k in aux_k) + f"; gradients {d:.3e} at {n}" + extra,
                    flush=True)
                del before
    finally:
        ds.close()


def host(res, fmap_max, batch, iters, seeds):
    """The port's plain path, then JAX's steps from the same state."""
    import jax
    import jax.numpy as jnp

    from gansformer_tpu.core.config import ExperimentConfig as JaxConfig
    from gansformer_tpu.data.dataset import SyntheticDataset as JaxSynthetic
    from gansformer_tpu.train import checkpoint as jax_ckpt
    from gansformer_tpu.train.state import create_train_state as jax_state
    from gansformer_tpu.train.steps import make_train_steps
    from gansformer_tpu_torch.data.dataset import SyntheticDataset
    from gansformer_tpu_torch.train import checkpoint as ckpt
    from gansformer_tpu_torch.train import create_train_state

    exp = _preset(res, fmap_max)
    for seed in seeds:
        t = dataclasses.replace(exp.train, batch_size=batch, seed=seed)
        exp_s = dataclasses.replace(exp, train=t)
        pls, _, _, s = _port_run(
            exp_s, seed, batch, iters, "cpu",
            SyntheticDataset(res, num_images=256).batches(batch,
                                                          seed=seed + 1))
        _line(f"port (plain path, CPU) res {res} fmap_max {fmap_max} batch "
              f"{batch} seed {seed}, {iters} iterations", pls, seconds=s)

        cfg = JaxConfig.from_json(exp_s.to_json())
        d = tempfile.mkdtemp(prefix="c19_")
        ckpt.save(d, create_train_state(exp.model, t, seed, "cpu"), exp_s,
                  block=True)
        state = jax_ckpt.restore(d, jax_state(cfg, jax.random.PRNGKey(seed)))
        fns = make_train_steps(cfg, batch_size=batch)
        reals = JaxSynthetic(res, num_images=256).batches(batch,
                                                          seed=seed + 1)
        base = jax.random.PRNGKey(seed + 4)
        pls = []
        t0 = time.time()
        for it in range(iters):
            imgs = jnp.asarray(next(reals)["image"])
            key = jax.random.fold_in(base, it)
            d_fn = fns.d_step_r1 if it % t.d_reg_interval == 0 \
                else fns.d_step
            state, _ = d_fn(state, imgs, jax.random.fold_in(key, 0), None)
            g_fn = fns.g_step_pl if it % t.g_reg_interval == 0 \
                else fns.g_step
            state, g_aux = g_fn(state, jax.random.fold_in(key, 1), None)
            if it % t.g_reg_interval == 0:
                pls.append((it, float(g_aux["Loss/G/pl"]),
                            float(state.pl_mean)))
        _line(f"JAX (the port's initial state) res {res} fmap_max "
              f"{fmap_max} batch {batch} seed {seed}, {iters} iterations",
              pls, seconds=time.time() - t0)


def main(argv):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if argv[:1] == ["card"] and len(argv) > 1:
        card(argv[1:])
    elif argv[:1] == ["steps"] and len(argv) == 4:
        steps_compare(*(int(a) for a in argv[1:]))
    elif argv[:1] == ["host"] and len(argv) == 6:
        res, fmap_max, batch, iters = (int(a) for a in argv[1:5])
        host(res, fmap_max, batch, iters,
             [int(s) for s in argv[5].split(",")])
    else:
        sys.exit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
