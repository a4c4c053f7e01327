"""The host side of the latent->grid kernels, forward and backward
(``ops/cuda_attention.py``), on the CPU: the route of every latent->grid
launch of every preset (bf16: the tensor-core kernels; fp32: the
CUDA-core ones), with and without D attention; the tensor-core plan's
spans and tiles, which must cover every key of every batch entry exactly
once, ragged tails and the one-span case included; its shared memory
against the card's limit; its constants against the kernel sources.

Emulations of the tensor-core decomposition (tiles of the plan's keys,
the online softmax per block with its rescale, P and dS as hi + lo bf16
terms, the fixed-order sum over spans, lse = m + log(den)) are held to
the JAX package's Pallas kernels in interpret mode on the same
bf16-valued inputs: the forward within 1e-5 of max |o| (and lse within
1e-5), the backward within 2e-5 of each output's max, since both sides
sum fp32 products of the same values in another order.  The same
emulations with P (and dS) rounded once to bf16 must fall outside those
tolerances, so the tests tell the split from one rounding.  The kernels
themselves run on the card only (``chip_smoke.py`` holds them to their
plain versions and the built library's plans to these)."""

import dataclasses
import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gansformer_tpu.ops.pallas_attention import (_latent_to_grid_bwd,
                                                 _latent_to_grid_fwd)
from gansformer_tpu_torch.core import config as port_config
from gansformer_tpu_torch.ops import _build
from gansformer_tpu_torch.ops import cuda_attention as ca
from gansformer_tpu_torch.ops.attention import attention_fwd_stats_plain
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

KERNELS = ("latent_to_grid", "latent_to_grid_bwd")
FWD_TOL = 1e-5           # of max |o|, and lse absolute
BWD_TOL = 2e-5           # of each output's max


def _launches():
    """(preset, kernel, dtype, B, n, L, D, Dv) of every distinct
    latent->grid launch, forward and backward, of one synthesize at every
    serve bucket and at batch 8 and of one d_step + g_step at batch 8 of
    every preset (and with d_attention), in the preset's dtype and in
    fp32."""
    out = {}
    for name in sorted(port_config.PRESETS):
        cfg = port_config.get_preset(name)
        calls = []
        for model in (cfg, dataclasses.replace(cfg, d_attention=True)):
            calls += chip_smoke.train_path_calls(model, 8)
        for b in chip_smoke.BUCKETS + (8,):
            calls += chip_smoke.main_path_calls(cfg, b)
        for c in calls:
            if c["kernel"] not in KERNELS:
                continue
            for dtype in {cfg.dtype, "float32"}:
                key = (c["kernel"], dtype, c["B"], c["Lk"], c["Lq"], c["D"],
                       c["Dv"])
                out.setdefault(key, name)
    return [(name,) + key for key, name in sorted(out.items())]


LAUNCHES = _launches()
# Shapes no preset makes: ragged n, a latent count off the buckets, the
# one-span case, a split at batch 1.
EXTRA = [("extra", kname, "bfloat16") + shape
         for kname in KERNELS
         for shape in ((3, 200, 20, 64, 128), (8, 1000, 16, 512, 512),
                       (2, 1000, 20, 128, 256), (8, 64, 16, 512, 512),
                       (1, 16384, 16, 128, 512), (5, 33, 32, 512, 512))]


def _ids(launch):
    return "{}-{}-{}-b{}-n{}-l{}-d{}x{}".format(*launch)


def _plan(launch):
    _, kname, dtype, b, n, l, d, dv = launch
    return ca.l2g_plan(getattr(torch, dtype), b, n, l, d, dv,
                       bwd=kname == "latent_to_grid_bwd")


def test_launches_of_every_preset_are_enumerated():
    assert {launch[0] for launch in LAUNCHES} <= set(port_config.PRESETS)
    assert {launch[1] for launch in LAUNCHES} == set(KERNELS)
    assert {launch[5] for launch in LAUNCHES} == {16, 32}
    assert {launch[6] for launch in LAUNCHES} >= {128, 256, 512}
    assert {launch[4] for launch in LAUNCHES} >= {32, 64, 16384}


@pytest.mark.parametrize("launch", LAUNCHES, ids=_ids)
def test_every_launch_takes_its_route(launch):
    """bf16 launches (every preset's but clevr64-simplex's) take the
    tensor-core kernels, fp32 launches the CUDA-core ones; shared memory
    within the card's limit; a tensor-core tile of 16, 32 or 64 keys with
    3 or 4 ring stages."""
    _, kname, dtype, b, n, l, d, dv = launch
    path, lp, kt, tps, spans, stages, smem = _plan(launch)
    assert path == (ca.L2G_MMA if dtype == "bfloat16" else ca.L2G_SIMT)
    assert smem <= _build.SMEM_LIMIT
    if path == ca.L2G_MMA:
        assert lp in (16, 32) and lp >= l
        assert kt in (16, 32, 64)
        assert ca.KEY_MIN_STAGES <= stages <= ca.KEY_MAX_STAGES
        assert spans * b <= max(b, ca.SMS)
    else:
        want = (ca.L2G_BWD_SIMT_ROWS if kname == "latent_to_grid_bwd"
                else ca.L2G_SIMT_CHUNK)
        assert (lp, kt, tps, stages) == (0, want, 1, 0)


def _cover(plan, n):
    """How often each key 0 .. n - 1 is visited by the plan's blocks: span
    s takes tiles s * tps .. of kt keys, masked past n."""
    _, _, kt, tps, spans, _, _ = plan
    tiles = -(-n // kt)
    cover = np.zeros(n, np.int64)
    for sp in range(spans):
        ntiles = min(tps, tiles - sp * tps)
        assert ntiles >= 1                       # no span is empty
        for j in range(ntiles):
            k0 = (sp * tps + j) * kt
            assert k0 < n                        # every tile starts inside
            cover[k0:min(n, k0 + kt)] += 1
    return cover


@pytest.mark.parametrize("launch", LAUNCHES + EXTRA, ids=_ids)
def test_spans_and_tiles_cover_every_key_once(launch):
    n = launch[4]
    assert (_cover(_plan(launch), n) == 1).all()


def test_small_grids_run_in_one_span_and_large_ones_split():
    """ffhq256's b8 and b16 forward launches (n 64, 256: at most 8 tiles
    a batch entry) need no combine, its b32 launch splits, and so do the
    b16 launches of 16-key tiles (L 32, or the backward); its b128
    launch (n 16384) fills the card with one block an SM at batch 8; the
    smoke's ragged launch (n 1000, L 20, D 128, Dv 256 at batch 3) splits
    into three spans, the last tile 40 keys."""
    bf16 = torch.bfloat16
    for bwd in (False, True):
        assert ca.l2g_plan(bf16, 8, 64, 16, 512, 512, bwd)[4] == 1
        assert ca.l2g_plan(bf16, 8, 64, 32, 512, 512, bwd)[4] == 1
        assert ca.l2g_plan(bf16, 8, 256, 32, 512, 512, bwd)[4] == 2
        assert ca.l2g_plan(bf16, 8, 1024, 16, 512, 512, bwd)[4] > 1
    assert ca.l2g_plan(bf16, 8, 256, 16, 512, 512)[4] == 1
    assert ca.l2g_plan(bf16, 8, 256, 16, 512, 512, bwd=True)[4] == 2
    for bwd in (False, True):
        _, _, kt, tps, spans, _, _ = ca.l2g_plan(bf16, 8, 16384, 16, 128,
                                                 512, bwd=bwd)
        assert spans * 8 == 128 and spans * tps * kt == 16384
        _, _, kt, tps, spans, _, _ = ca.l2g_plan(bf16, 3, 1000, 20, 128,
                                                 256, bwd=bwd)
        assert (kt, spans, 1000 % kt) == (64, 3, 40)


def test_other_shapes_take_the_cuda_core_route():
    """fp32, L past 32, D or Dv not a multiple of 64 or past 512: the
    CUDA-core kernels."""
    bf16 = torch.bfloat16
    for bwd in (False, True):
        assert ca.l2g_plan(bf16, 8, 1024, 16, 512, 512, bwd)[0] == ca.L2G_MMA
        assert ca.l2g_plan(bf16, 8, 1024, 32, 512, 512, bwd)[0] == ca.L2G_MMA
        for shape in ((33, 512, 512), (16, 48, 512), (16, 512, 96),
                      (16, 1024, 512), (16, 512, 1024)):
            assert ca.l2g_plan(bf16, 8, 1024, *shape, bwd)[0] == ca.L2G_SIMT
        assert ca.l2g_plan(torch.float32, 8, 1024, 16, 512, 512,
                           bwd)[0] == ca.L2G_SIMT


def _source_constants(name):
    src = (pathlib.Path(_build.CSRC) / name).read_text()
    return {key: int(val) for key, val in
            re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def test_plan_constants_match_the_kernel_source():
    """The wrapper's copy of the key tiling (hopper.cuh), of the CUDA-core
    route's chunks (attention.cu kChunk, attention_bwd.cu kRows) and of
    the card's limits is the sources'."""
    hop = _source_constants("hopper.cuh")
    assert hop["kKeyWarps"] == ca.KEY_WARPS
    assert hop["kKeyMinStages"] == ca.KEY_MIN_STAGES
    assert hop["kKeyMaxStages"] == ca.KEY_MAX_STAGES
    assert hop["kKeySpanBytes"] == ca.KEY_SPAN_BYTES
    assert hop["kKeyOneSpanTiles"] == ca.KEY_ONE_SPAN_TILES
    assert hop["kKeyPad"] == ca.KEY_PAD
    assert hop["kKeyMaxLp"] == ca.KEY_MAX_LP
    assert hop["kKeyMaxCols"] == ca.KEY_MAX_COLS
    assert hop["kKeySms"] == ca.SMS
    assert hop["kMaxSmem"] == _build.SMEM_LIMIT
    fwd = _source_constants("attention.cu")
    assert fwd["kChunk"] == ca.L2G_SIMT_CHUNK
    assert fwd["kWarps"] == ca.L2G_SIMT_WARPS
    bwd = _source_constants("attention_bwd.cu")
    assert bwd["kRows"] == ca.L2G_BWD_SIMT_ROWS
    assert bwd["kWarps"] == ca.L2G_SIMT_WARPS
    assert bwd["kMaxL"] == fwd["kMaxL"] == ca.MAX_LATENTS


def test_plan_path_counts_follow_the_plans():
    """chip_smoke's expected routes of one synthesize and one d_step +
    g_step at ffhq256-duplex: every latent->grid launch, forward and
    backward, on the tensor cores in bf16 and on the CUDA cores in
    fp32."""
    cfg = port_config.get_preset("ffhq256-duplex")
    calls = (chip_smoke.main_path_calls(cfg, 8)
             + chip_smoke.train_path_calls(cfg, 8))
    n_fwd = sum(c["kernel"] == "latent_to_grid" for c in calls)
    n_bwd = sum(c["kernel"] == "latent_to_grid_bwd" for c in calls)
    assert (n_fwd, n_bwd) == (15, 5)
    for dtype, route in (("bfloat16", "mma"), ("float32", "simt")):
        got = chip_smoke.plan_path_counts(calls, dtype)
        other = "simt" if route == "mma" else "mma"
        assert got[f"latent_to_grid_{route}"] == n_fwd
        assert got[f"latent_to_grid_bwd_{route}"] == n_bwd
        assert got[f"latent_to_grid_{other}"] == 0
        assert got[f"latent_to_grid_bwd_{other}"] == 0


# --------------------------------------------------------------------------
# Emulations of the tensor-core decomposition against the Pallas kernels
# --------------------------------------------------------------------------


def _split(x, once=False):
    """x as hi + lo bf16 terms (the kernels' split_bf16), or rounded once
    (lo = 0)."""
    hi = x.to(torch.bfloat16).float()
    lo = torch.zeros_like(x) if once else (x - hi).to(torch.bfloat16).float()
    return hi, lo


def _tiles(plan, n, sp):
    """(k0, k1) of the tiles of span ``sp``."""
    _, _, kt, tps, _, _, _ = plan
    tiles = -(-n // kt)
    return [(t * kt, min(n, t * kt + kt))
            for t in range(sp * tps, min(tiles, (sp + 1) * tps))]


def emulate_fwd(q, k, v, plan, once=False):
    """o [B, L, Dv] and lse [B, L] in fp32 as l2g_mma_kernel computes
    them: per span the online softmax over its tiles (fp32 m, s and acc,
    acc rescaled by exp(m_prev - m_new)), P V as P_hi V + P_lo V; then the
    fixed-order combine over spans (l2g_combine_kernel), o = num / den,
    lse = M + log(den)."""
    b, l, d = q.shape
    n = k.shape[1]
    spans = plan[4]
    scale = 1.0 / math.sqrt(d)
    ms, ss, accs = [], [], []
    for sp in range(spans):
        m = torch.full((b, l), -math.inf)
        s = torch.zeros(b, l)
        acc = torch.zeros(b, l, v.shape[2])
        for k0, k1 in _tiles(plan, n, sp):
            logits = torch.einsum("bld,bnd->bln", q, k[:, k0:k1]) * scale
            m_new = torch.maximum(m, logits.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            s = s * corr + p.sum(-1)
            hi, lo = _split(p, once)
            acc = (acc * corr[..., None]
                   + torch.einsum("bln,bnd->bld", hi, v[:, k0:k1])
                   + torch.einsum("bln,bnd->bld", lo, v[:, k0:k1]))
            m = m_new
        ms.append(m)
        ss.append(s)
        accs.append(acc)
    big = torch.stack(ms).amax(0)
    den, num = torch.zeros(b, l), torch.zeros_like(accs[0])
    for m, s, acc in zip(ms, ss, accs):
        w = torch.exp(m - big)
        den = den + s * w
        num = num + acc * w[..., None]
    return num / den[..., None], big + torch.log(den)


def emulate_bwd(q, k, v, lse, do, delta, plan, once=False):
    """(dq, dk, dv) in fp32 as l2g_bwd_mma_kernel computes them: per tile
    P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta), dV = P^T dO and
    dK = scale dS^T Q with P^T and dS^T as hi + lo; dq of each span summed
    over its tiles (dS_hi K + dS_lo K), scaled once, and the spans summed
    in order (l2g_bwd_reduce_kernel)."""
    b, l, d = q.shape
    n = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    dq = torch.zeros_like(q)
    for sp in range(plan[4]):
        part = torch.zeros_like(q)
        for k0, k1 in _tiles(plan, n, sp):
            kk, vv = k[:, k0:k1], v[:, k0:k1]
            p = torch.exp(torch.einsum("bld,bnd->bln", q, kk) * scale
                          - lse[..., None])
            dp = torch.einsum("bld,bnd->bln", do, vv)
            ds = p * (dp - delta[..., None])
            ph, pl = _split(p, once)
            dh, dl = _split(ds, once)
            dv[:, k0:k1] = (torch.einsum("bln,bld->bnd", ph, do)
                            + torch.einsum("bln,bld->bnd", pl, do))
            dk[:, k0:k1] = (torch.einsum("bln,bld->bnd", dh, q)
                            + torch.einsum("bln,bld->bnd", dl, q)) * scale
            part = part + (torch.einsum("bln,bnd->bld", dh, kk)
                           + torch.einsum("bln,bnd->bld", dl, kk))
        dq = dq + part * scale
    return dq, dk, dv


# (B, n, L, D, Dv): ffhq256's b32 launch (n 1024 at D = Dv = 512, split
# into spans at B = 2) and a ragged grid at L off the buckets.
EMULATED = [(2, 1024, 16, 512, 512), (2, 1000, 20, 128, 256)]


def _bf16_inputs(rng, b, n, l, d, dv):
    """q, k, v, do as fp32 tensors holding bf16 values; v with a mean of
    1, as features have (zero-mean values average o to ~0 over thousands
    of keys)."""
    def t(*shape, mean=0.0):
        x = rng.randn(*shape).astype(np.float32) + mean
        return torch.from_numpy(x).to(torch.bfloat16).float()

    return t(b, l, d), t(b, n, d), t(b, n, dv, mean=1.0), t(b, l, dv)


def _rel(got, ref):
    ref = torch.from_numpy(np.array(ref))
    return float((got - ref).abs().max()) / float(ref.abs().max())


@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_forward_emulation_matches_the_pallas_kernel(rng, shape):
    """The hi + lo decomposition against ``_latent_to_grid_fwd`` in
    interpret mode (block_n 512, fp32 throughout): o within 1e-5 of max
    |o|, lse within 1e-5; P rounded once to bf16 falls outside."""
    b, n, l, d, dv = shape
    q, k, v, _ = _bf16_inputs(rng, b, n, l, d, dv)
    plan = ca.l2g_plan(torch.bfloat16, b, n, l, d, dv)
    assert plan[0] == ca.L2G_MMA and plan[4] > 1
    jo, jlse = _latent_to_grid_fwd(jnp.asarray(q.numpy()),
                                   jnp.asarray(k.numpy()),
                                   jnp.asarray(v.numpy()), interpret=True)
    o, lse = emulate_fwd(q, k, v, plan)
    assert _rel(o, jo) <= FWD_TOL
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=0,
                               atol=FWD_TOL)
    once, _ = emulate_fwd(q, k, v, plan, once=True)
    assert _rel(once, jo) > FWD_TOL


@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_forward_emulation_matches_the_plain_version(rng, shape):
    """In the card's types (bf16 in and out), the emulation is held to
    ``attention_fwd_stats_plain`` at the smoke's tolerance classes: o at
    KERNEL_TOL (the plain version rounds P to bf16 before the mix, the
    kernel keeps it), lse at STAT_TOL."""
    b, n, l, d, dv = shape
    q, k, v, _ = _bf16_inputs(rng, b, n, l, d, dv)
    plan = ca.l2g_plan(torch.bfloat16, b, n, l, d, dv)
    o, lse = emulate_fwd(q, k, v, plan)
    ro, rlse = attention_fwd_stats_plain(q.bfloat16(), k.bfloat16(),
                                         v.bfloat16())
    ro = ro.float()
    err = float((o.bfloat16().float() - ro).abs().max())
    assert err <= chip_smoke.KERNEL_TOL["bfloat16"] * float(ro.abs().max())
    assert float((lse - rlse).abs().max()) <= \
        chip_smoke.STAT_TOL["bfloat16"] * float(rlse.abs().max())


@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_backward_emulation_matches_the_pallas_kernel(rng, shape):
    """The hi + lo decomposition against ``_latent_to_grid_bwd`` in
    interpret mode, on the Pallas forward's o and lse (delta = rowsum(do
    * o) from the same o): dq, dk, dv each within 2e-5 of its max; P and
    dS rounded once to bf16 fall outside."""
    b, n, l, d, dv = shape
    q, k, v, do = _bf16_inputs(rng, b, n, l, d, dv)
    plan = ca.l2g_plan(torch.bfloat16, b, n, l, d, dv, bwd=True)
    assert plan[0] == ca.L2G_MMA and plan[4] > 1
    jq, jk, jv, jdo = (jnp.asarray(t.numpy()) for t in (q, k, v, do))
    jo, jlse = _latent_to_grid_fwd(jq, jk, jv, interpret=True)
    refs = _latent_to_grid_bwd(jq, jk, jv, jo, jlse, jdo, interpret=True)
    o = torch.from_numpy(np.array(jo))
    lse = torch.from_numpy(np.array(jlse))
    delta = (do * o).sum(-1)
    got = emulate_bwd(q, k, v, lse, do, delta, plan)
    for name, g, r in zip(("dq", "dk", "dv"), got, refs):
        assert _rel(g, r) <= BWD_TOL, name
    once = emulate_bwd(q, k, v, lse, do, delta, plan, once=True)
    assert max(_rel(g, r) for g, r in zip(once, refs)) > BWD_TOL


# Launches of the smoke whose planted faults drop few keys of many: the
# b128 and b64 launches of ffhq256 and cityscapes256 (at batch 2 here).
CONTROL_LAUNCHES = [("latent_to_grid", 16, 16384, 128),
                    ("latent_to_grid_bwd", 16, 16384, 128),
                    ("latent_to_grid", 32, 4096, 256),
                    ("latent_to_grid_bwd", 32, 4096, 256),
                    ("latent_to_grid_bwd", 16, 1024, 512)]


@pytest.mark.parametrize("launch", CONTROL_LAUNCHES, ids=str)
def test_tile_and_span_controls_exceed_the_bf16_tolerance(launch):
    """On the tensor-core route the smoke's planted faults follow the
    reduction: one span of keys and one tile dropped (dq of the backward
    without one span's partial and without one tile); each lies outside
    the bf16 tolerance on the plain outputs."""
    kname, l, n, d = launch
    call = dict(kernel=kname, label="t", B=2, Lq=l, Lk=n, D=d, Dv=512,
                lse=kname == "latent_to_grid")
    plan = chip_smoke.l2g_call_plan(call, torch.bfloat16)
    case = chip_smoke.build_case(call, torch.bfloat16,
                                 torch.Generator().manual_seed(0), dev="cpu")
    descs = [c["desc"] for c in case["controls"]]
    kt, span = plan[2], plan[2] * plan[3]
    if kname == "latent_to_grid":
        want = [f"one span of {span} keys dropped",
                f"one {kt}-key tile dropped", "lse = max without log(den)"]
    else:
        want = [f"dq without one span's partial ({span} keys)",
                f"dq without one {kt}-key tile", "dq with delta = 0",
                "dk with delta = 0"]
    assert descs == want
    ref = chip_smoke._tuple(case["plain"]())
    for ctl in case["controls"]:
        base = ref[ctl["out"]].float()
        kind = case["outputs"][ctl["out"]]
        tol = chip_smoke.TOLS[kind]["bfloat16"] * float(base.abs().max())
        err = float((chip_smoke._tuple(ctl["fault"]())[0].float()
                     - base).abs().max())
        assert err > tol, (ctl["desc"], err, tol)


def test_cuda_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 16, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ca.latent_to_grid_cuda(q, k, k)
    lse = torch.zeros(1, 16)
    with pytest.raises(ValueError):
        ca.latent_to_grid_bwd_cuda(q, k, k, lse, q, lse)
