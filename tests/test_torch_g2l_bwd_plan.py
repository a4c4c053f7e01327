"""The host side of the grid->latent backward kernels
(``ops/cuda_attention.py`` ``g2l_bwd_plan``), on the CPU: the route of
every grid->latent backward launch of every preset (bf16: the tensor-core
kernel; fp32: the CUDA-core one), with and without D attention; the
tensor-core plan's spans and tiles, which must cover every grid row of
every batch entry exactly once, ragged tails and the one-span case
included; its shared memory against the card's limit; its constants
against the kernel sources.

An emulation of the tensor-core decomposition (tiles of the plan's rows,
S and dP from bf16 operands in fp32, each row's lse from its own S and
P = exp(S scale - lse), the row's delta inside, P and dS as hi + lo bf16 terms, dK and dV summed per span
and the spans summed in order) is held to the JAX package's Pallas kernel
in interpret mode on the same bf16-valued inputs, within 2e-5 of each
output's max, since both sides sum fp32 products of the same values in
another order.  The same emulation with P and dS rounded once to bf16
must fall outside that tolerance, so the test tells the split from one
rounding.  The kernel itself runs on the card only (``chip_smoke.py``
holds it to its plain version and the built library's plan to this
one)."""

import ctypes
import dataclasses
import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gansformer_tpu.ops.pallas_attention import (_grid_to_latent_bwd,
                                                 _grid_to_latent_fwd)
from gansformer_tpu_torch.core import config as port_config
from gansformer_tpu_torch.ops import _build
from gansformer_tpu_torch.ops import cuda_attention as ca
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

KERNEL = "grid_to_latent_bwd"
BWD_TOL = 2e-5           # of each output's max


def _launches():
    """(preset, dtype, B, n, L, D, Dv) of every distinct grid->latent
    backward launch of one d_step + g_step at batch 8 of every preset
    (and with d_attention), in the preset's dtype and in fp32."""
    out = {}
    for name in sorted(port_config.PRESETS):
        cfg = port_config.get_preset(name)
        for model in (cfg, dataclasses.replace(cfg, d_attention=True)):
            for c in chip_smoke.train_path_calls(model, 8):
                if c["kernel"] != KERNEL:
                    continue
                for dtype in {cfg.dtype, "float32"}:
                    key = (dtype, c["B"], c["Lq"], c["Lk"], c["D"], c["Dv"])
                    out.setdefault(key, name)
    return [(name,) + key for key, name in sorted(out.items())]


LAUNCHES = _launches()
# Shapes no preset makes: ragged n, a latent count off the buckets, the
# one-span case, a split at batch 1, D and Dv apart.
EXTRA = [("extra", "bfloat16") + shape
         for shape in ((3, 200, 20, 64, 128), (3, 1000, 20, 128, 256),
                       (8, 1000, 16, 512, 512), (8, 16, 16, 512, 512),
                       (1, 16384, 16, 128, 512), (5, 33, 32, 512, 512),
                       (2, 1000, 32, 512, 64))]


def _ids(launch):
    return "{}-{}-b{}-n{}-l{}-d{}x{}".format(*launch)


def _plan(launch):
    _, dtype, b, n, l, d, dv = launch
    return ca.g2l_bwd_plan(getattr(torch, dtype), b, n, l, d, dv)


def test_launches_of_every_preset_are_enumerated():
    assert {launch[0] for launch in LAUNCHES} <= set(port_config.PRESETS)
    assert {launch[1] for launch in LAUNCHES} == {"bfloat16", "float32"}
    assert {launch[4] for launch in LAUNCHES} >= {8, 16, 32}
    assert {launch[5] for launch in LAUNCHES} >= {64, 128, 256, 512}
    assert {launch[3] for launch in LAUNCHES} >= {16, 32, 64, 16384}


@pytest.mark.parametrize("launch", LAUNCHES, ids=_ids)
def test_every_launch_takes_its_route(launch):
    """bf16 launches (every preset's but clevr64-simplex's) take the
    tensor-core kernel, fp32 launches the CUDA-core one; shared memory
    within the card's limit; a tensor-core tile of 16, 32 or 64 rows with
    3 or 4 ring stages, at most one block an SM over the batch."""
    _, dtype, b, n, l, d, dv = launch
    path, lp, kt, tps, spans, stages, smem = _plan(launch)
    assert path == (ca.G2L_MMA if dtype == "bfloat16" else ca.G2L_SIMT)
    assert smem <= _build.SMEM_LIMIT
    if path == ca.G2L_MMA:
        assert lp in (16, 32) and lp >= l
        assert kt in (16, 32, 64)
        assert ca.KEY_MIN_STAGES <= stages <= ca.KEY_MAX_STAGES
        assert spans * b <= max(b, ca.SMS)
    else:
        assert (lp, kt, tps, stages) == (0, ca.L2G_BWD_SIMT_ROWS, 1, 0)
        assert spans == -(-n // ca.L2G_BWD_SIMT_ROWS)


def _cover(plan, n):
    """How often each grid row 0 .. n - 1 is visited by the plan's
    blocks: span s takes tiles s * tps .. of kt rows, masked past n."""
    _, _, kt, tps, spans, _, _ = plan
    tiles = -(-n // kt)
    cover = np.zeros(n, np.int64)
    for sp in range(spans):
        ntiles = min(tps, tiles - sp * tps)
        assert ntiles >= 1                       # no span is empty
        for j in range(ntiles):
            r0 = (sp * tps + j) * kt
            assert r0 < n                        # every tile starts inside
            cover[r0:min(n, r0 + kt)] += 1
    return cover


@pytest.mark.parametrize("launch", LAUNCHES + EXTRA, ids=_ids)
def test_spans_and_tiles_cover_every_row_once(launch):
    n = launch[3]
    assert (_cover(_plan(launch), n) == 1).all()


def test_small_grids_run_in_one_span_and_large_ones_split():
    """ffhq256's b4 and b8 launches (n 16 and 64 at D = Dv = 512: at most
    8 tiles of 16 rows a batch entry) write dk and dv themselves, with no
    partial and no reduce; its b16 launch splits in two, its b128 launch
    (n 16384) fills the card with one block an SM at batch 8 (16 spans of
    16 64-row tiles); the smoke's ragged launch (n 1000, L 20, D 128, Dv
    256 at batch 3) splits into three spans, the last tile 40 rows."""
    bf16 = torch.bfloat16
    assert ca.g2l_bwd_plan(bf16, 8, 16, 16, 512, 512)[4] == 1
    assert ca.g2l_bwd_plan(bf16, 8, 64, 16, 512, 512)[4] == 1
    assert ca.g2l_bwd_plan(bf16, 8, 64, 32, 512, 512)[4] == 1
    assert ca.g2l_bwd_plan(bf16, 8, 32, 16, 512, 512)[4] == 1
    assert ca.g2l_bwd_plan(bf16, 8, 256, 16, 512, 512)[4] == 2
    assert ca.g2l_bwd_plan(bf16, 8, 1024, 16, 512, 512)[4] > 1
    _, _, kt, tps, spans, _, _ = ca.g2l_bwd_plan(bf16, 8, 16384, 16, 128,
                                                 128)
    assert (kt, tps, spans) == (64, 16, 16)
    _, _, kt, tps, spans, _, _ = ca.g2l_bwd_plan(bf16, 3, 1000, 20, 128, 256)
    assert (kt, spans, 1000 % kt) == (64, 3, 40)


def test_other_shapes_take_the_cuda_core_route():
    """fp32, L past 32, D or Dv not a multiple of 64 or past 512: the
    CUDA-core kernel."""
    bf16 = torch.bfloat16
    assert ca.g2l_bwd_plan(bf16, 8, 1024, 16, 512, 512)[0] == ca.G2L_MMA
    assert ca.g2l_bwd_plan(bf16, 8, 1024, 32, 512, 512)[0] == ca.G2L_MMA
    for shape in ((33, 512, 512), (64, 64, 64), (16, 48, 512),
                  (16, 512, 96), (16, 1024, 512), (16, 512, 1024)):
        assert ca.g2l_bwd_plan(bf16, 8, 1024, *shape)[0] == ca.G2L_SIMT
    assert ca.g2l_bwd_plan(torch.float32, 8, 1024, 16, 512,
                           512)[0] == ca.G2L_SIMT


def _source(name):
    return (pathlib.Path(_build.CSRC) / name).read_text()


def _source_constants(name):
    return {key: int(val) for key, val in
            re.findall(r"constexpr int (k\w+) = (\d+);", _source(name))}


def test_plan_constants_match_the_kernel_source():
    """The wrapper's copy of the tiling (hopper.cuh), of the CUDA-core
    route's chunk and warps (attention_bwd.cu kRows, kWarps) and of the
    card's limits is the sources'; the kernel's routes are numbered as
    the wrapper's; the library exports the plan the smoke holds to the
    wrapper's, with seven fields."""
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
    bwd = _source_constants("attention_bwd.cu")
    assert bwd["kRows"] == ca.L2G_BWD_SIMT_ROWS
    assert bwd["kWarps"] == ca.L2G_SIMT_WARPS
    assert bwd["kMaxL"] == ca.MAX_LATENTS
    src = _source("attention_bwd.cu")
    assert "enum { kBwdSimt = 0, kBwdMma = 1 };" in src
    assert (ca.G2L_SIMT, ca.G2L_MMA) == (0, 1)
    assert 'extern "C" void gt_g2l_bwd_plan(' in src
    assert _build._SIGNATURES["gt_g2l_bwd_plan"] == (
        None, [ctypes.c_int] * 6 + [ctypes.c_void_p])


def test_plan_path_counts_follow_the_plans():
    """chip_smoke's expected routes of one d_step + g_step at
    ffhq256-duplex, with and without D attention: every grid->latent
    backward launch on the tensor cores in bf16 and on the CUDA cores in
    fp32."""
    cfg = port_config.get_preset("ffhq256-duplex")
    # D attention: 5 launches per D forward, two in the d_step, one in
    # the g_step beside G's 7
    for model, want in ((cfg, 7), (dataclasses.replace(cfg, d_attention=True),
                                   10 + 12)):
        calls = chip_smoke.train_path_calls(model, 8)
        n_bwd = sum(c["kernel"] == KERNEL for c in calls)
        assert n_bwd == want
        for dtype, route in (("bfloat16", "mma"), ("float32", "simt")):
            got = chip_smoke.plan_path_counts(calls, dtype)
            other = "simt" if route == "mma" else "mma"
            assert got[f"{KERNEL}_{route}"] == n_bwd
            assert got[f"{KERNEL}_{other}"] == 0


# --------------------------------------------------------------------------
# An emulation of the tensor-core decomposition against the Pallas kernel
# --------------------------------------------------------------------------


def _split(x, once=False):
    """x as hi + lo bf16 terms (the kernel's split_bf16), or rounded once
    (lo = 0)."""
    hi = x.to(torch.bfloat16).float()
    lo = torch.zeros_like(x) if once else (x - hi).to(torch.bfloat16).float()
    return hi, lo


def _tiles(plan, n, sp):
    """(r0, r1) of the row tiles of span ``sp``."""
    _, _, kt, tps, _, _, _ = plan
    tiles = -(-n // kt)
    return [(t * kt, min(n, t * kt + kt))
            for t in range(sp * tps, min(tiles, (sp + 1) * tps))]


def emulate_bwd(q, k, v, do, plan, once=False, drop=None):
    """(dq, dk, dv) in fp32 as g2l_bwd_mma_kernel computes them: per tile
    S scale, each row's lse from it, P = exp(S scale - lse), delta =
    rowsum(P dP) of each row, dS = P (dP -
    delta), dq = scale (dS_hi K + dS_lo K) per row; dV += P^T dO and dK +=
    dS^T q with P and dS as hi + lo, per span over its tiles; dK scaled
    once, and the spans summed in order (g2l_bwd_reduce_kernel).  ``drop``
    = (span, tile within it or None) leaves that tile, or the whole span,
    out of dk and dv."""
    b, n, d = q.shape
    scale = 1.0 / math.sqrt(d)
    dq = torch.zeros_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for sp in range(plan[4]):
        dk_acc, dv_acc = torch.zeros_like(k), torch.zeros_like(v)
        for j, (r0, r1) in enumerate(_tiles(plan, n, sp)):
            qq, dd = q[:, r0:r1], do[:, r0:r1]
            s = torch.einsum("bnd,bld->bnl", qq, k) * scale
            p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
            dp = torch.einsum("bnd,bld->bnl", dd, v)
            ds = p * (dp - (p * dp).sum(-1, keepdim=True))
            ph, pl = _split(p, once)
            dh, dl = _split(ds, once)
            dq[:, r0:r1] = (torch.einsum("bnl,bld->bnd", dh, k)
                            + torch.einsum("bnl,bld->bnd", dl, k)) * scale
            if drop is not None and drop[0] == sp and drop[1] in (None, j):
                continue
            dv_acc += (torch.einsum("bnl,bnd->bld", ph, dd)
                       + torch.einsum("bnl,bnd->bld", pl, dd))
            dk_acc += (torch.einsum("bnl,bnd->bld", dh, qq)
                       + torch.einsum("bnl,bnd->bld", dl, qq))
        dk = dk + dk_acc * scale
        dv = dv + dv_acc
    return dq, dk, dv


# (B, n, L, D, Dv): ffhq256's b32 launch (n 1024 at D = Dv = 512, 16-row
# tiles, split into 8 spans at B = 2) and a ragged grid at L off the
# buckets with D and Dv apart (three spans, a 40-row last tile).
EMULATED = [(2, 1024, 16, 512, 512), (2, 1000, 20, 128, 256)]


def _bf16_inputs(rng, b, n, l, d, dv):
    """q, k, v, do as fp32 tensors holding bf16 values."""
    def t(*shape):
        x = rng.randn(*shape).astype(np.float32)
        return torch.from_numpy(x).to(torch.bfloat16).float()

    return t(b, n, d), t(b, l, d), t(b, l, dv), t(b, n, dv)


def _rel(got, ref):
    ref = torch.from_numpy(np.array(ref))
    return float((got - ref).abs().max()) / float(ref.abs().max())


def _pallas(q, k, v, do):
    """(dq, dk, dv) of the Pallas backward on the Pallas forward's lse,
    both in interpret mode (block_n 512, fp32 throughout)."""
    jq, jk, jv, jdo = (jnp.asarray(t.numpy()) for t in (q, k, v, do))
    _, jlse = _grid_to_latent_fwd(jq, jk, jv, interpret=True)
    return _grid_to_latent_bwd(jq, jk, jv, jlse, jdo, interpret=True)


@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_backward_emulation_matches_the_pallas_kernel(rng, shape):
    """The hi + lo decomposition against ``_grid_to_latent_bwd`` in
    interpret mode, on the Pallas forward's lse (the emulation takes each
    row's from its own logits, as the kernel does): dq, dk, dv each
    within 2e-5 of its max; P and dS rounded once to bf16 fall
    outside."""
    b, n, l, d, dv = shape
    q, k, v, do = _bf16_inputs(rng, b, n, l, d, dv)
    plan = ca.g2l_bwd_plan(torch.bfloat16, b, n, l, d, dv)
    assert plan[0] == ca.G2L_MMA and plan[4] > 1
    refs = _pallas(q, k, v, do)
    got = emulate_bwd(q, k, v, do, plan)
    for name, g, r in zip(("dq", "dk", "dv"), got, refs):
        assert _rel(g, r) <= BWD_TOL, name
    once = emulate_bwd(q, k, v, do, plan, once=True)
    assert max(_rel(g, r) for g, r in zip(once, refs)) > BWD_TOL


@pytest.mark.parametrize("shape", EMULATED, ids=str)
def test_emulated_span_and_tile_drops_exceed_the_bf16_tolerance(rng, shape):
    """The decomposition with the middle span, or the middle tile of the
    middle span, left out of dk and dv: each moves dk and dv past the
    smoke's bf16 tolerance on the Pallas outputs, so a kernel that lost
    one would fail it."""
    b, n, l, d, dv = shape
    q, k, v, do = _bf16_inputs(rng, b, n, l, d, dv)
    plan = ca.g2l_bwd_plan(torch.bfloat16, b, n, l, d, dv)
    refs = _pallas(q, k, v, do)
    tol = chip_smoke.KERNEL_TOL["bfloat16"]
    mid = plan[4] // 2
    for drop in ((mid, None), (mid, len(_tiles(plan, n, mid)) // 2)):
        _, dk, dvv = emulate_bwd(q, k, v, do, plan, drop=drop)
        assert _rel(dk, refs[1]) > tol, drop
        assert _rel(dvv, refs[2]) > tol, drop


# Launches of the smoke whose planted faults drop few rows of many: the
# b128, b64 and b32 launches of ffhq256 and cityscapes256 (at batch 2
# here), and ffhq256's one-span b8 launch.
CONTROL_LAUNCHES = [(16, 16384, 128), (32, 16384, 128), (16, 4096, 256),
                    (32, 4096, 256), (16, 1024, 512), (16, 64, 512)]


@pytest.mark.parametrize("launch", CONTROL_LAUNCHES, ids=str)
def test_tile_and_span_controls_exceed_the_bf16_tolerance(launch):
    """On the tensor-core route the smoke's planted faults follow the
    reduction: dk and dv without one span's partial where the launch
    splits, and without one tile; each lies outside the bf16 tolerance on
    the plain outputs, as do the delta controls."""
    l, n, d = launch
    call = dict(kernel=KERNEL, label="t", B=2, Lq=n, Lk=l, D=d, Dv=d,
                lse=False)
    plan = chip_smoke.g2l_bwd_call_plan(call, torch.bfloat16)
    case = chip_smoke.build_case(call, torch.bfloat16,
                                 torch.Generator().manual_seed(0), dev="cpu")
    descs = [c["desc"] for c in case["controls"]]
    kt, span = plan[2], plan[2] * plan[3]
    want = []
    if plan[4] > 1:
        want += [f"dk without one span's partial ({span} rows)",
                 f"dv without one span's partial ({span} rows)"]
    want += [f"dk without one {kt}-row tile", f"dv without one {kt}-row tile",
             "dq with dS = P dP (no delta)", "dk with dS = P dP (no delta)"]
    assert descs == want
    ref = chip_smoke._tuple(case["plain"]())
    for ctl in case["controls"]:
        base = ref[ctl["out"]].float()
        kind = case["outputs"][ctl["out"]]
        tol = chip_smoke.TOLS[kind]["bfloat16"] * float(base.abs().max())
        err = float((chip_smoke._tuple(ctl["fault"]())[0].float()
                     - base).abs().max())
        assert err > tol, (ctl["desc"], err, tol)


def test_cuda_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 64, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 16, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ca.grid_to_latent_bwd_cuda(q, k, k, q)
