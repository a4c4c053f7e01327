"""The host side of the grid->latent forward kernels
(``ops/cuda_attention.py``), on the CPU: the route of every grid->latent
launch of every preset (bf16: the tensor-core kernel; fp32: the
CUDA-core one), with and without D attention; the tensor-core kernel's
blocks, warps and 16-row tiles, which must cover every query row of
every batch entry exactly once, tails included; its shared memory
against the card's limit.  An emulation of its decomposition (logits of
16-row tiles over the latents padded to the bucket, padded keys at -inf,
the fp32 softmax, P rounded to the value dtype before P V, lse in
natural-log units) is held to ``attention_fwd_stats_plain``, which the
JAX package's reference is held to elsewhere.  The kernel itself runs
on the card only (``chip_smoke.py`` holds it to its plain version and
the built library's plan to this one)."""

import dataclasses
import math
import pathlib
import re

import numpy as np
import pytest
import torch

import chip_smoke
from gansformer_tpu_torch.core import config as port_config
from gansformer_tpu_torch.ops import _build
from gansformer_tpu_torch.ops import cuda_attention as ca
from gansformer_tpu_torch.ops.attention import attention_fwd_stats_plain
from tests.torch_threads import one_thread  # noqa: F401  (autouse)


def _launches():
    """(preset, dtype, B, n, L, D, Dv) of every distinct grid->latent
    launch of one synthesize and one d_step + g_step of every preset (and
    with d_attention), in the preset's dtype and in fp32."""
    out = {}
    for name in sorted(port_config.PRESETS):
        cfg = port_config.get_preset(name)
        calls = chip_smoke.main_path_calls(cfg, 8)
        for model in (cfg, dataclasses.replace(cfg, d_attention=True)):
            calls = calls + chip_smoke.train_path_calls(model, 8)
        for b in chip_smoke.BUCKETS:
            calls = calls + chip_smoke.main_path_calls(cfg, b)
        for c in calls:
            if c["kernel"] != "grid_to_latent":
                continue
            for dtype in {cfg.dtype, "float32"}:
                key = (dtype, c["B"], c["Lq"], c["Lk"], c["D"], c["Dv"])
                out.setdefault(key, name)
    return [(name,) + key for key, name in sorted(out.items())]


LAUNCHES = _launches()


def _ids(launch):
    return "{}-{}-b{}-n{}-l{}-d{}x{}".format(*launch)


def test_launches_of_every_preset_are_enumerated():
    assert {launch[0] for launch in LAUNCHES} <= set(port_config.PRESETS)
    assert {launch[4] for launch in LAUNCHES} >= {8, 16, 32}
    assert {launch[5] for launch in LAUNCHES} >= {64, 128, 256, 512}
    assert {launch[3] for launch in LAUNCHES} >= {16, 16384}


@pytest.mark.parametrize("launch", LAUNCHES, ids=_ids)
def test_every_launch_takes_its_route(launch):
    """bf16 launches (every preset's but clevr64-simplex's) take the
    tensor-core kernel, fp32 launches the CUDA-core one; shared memory
    within the card's limit."""
    _, dtype, b, n, l, d, dv = launch
    path = ca.g2l_path(getattr(torch, dtype), l, d, dv)
    assert path == (ca.G2L_MMA if dtype == "bfloat16" else ca.G2L_SIMT)
    assert ca.g2l_smem(path, l, d, dv) <= _build.SMEM_LIMIT
    if path == ca.G2L_MMA:
        assert ca.g2l_lp(l) >= l and ca.g2l_lp(l) % 16 == 0


@pytest.mark.parametrize("launch", LAUNCHES, ids=_ids)
def test_tiles_cover_every_row_once(launch):
    """The tensor-core grid: blocks of rows_per_block rows per batch
    entry, each warp taking the 16-row tiles t * 4 + warp of its block;
    the tiles that start inside n cover rows 0 .. n - 1 exactly once
    (rows past n masked)."""
    _, dtype, b, n, l, d, dv = launch
    tpw = ca.g2l_tiles_per_warp(b, n)
    rows = ca.g2l_rows_per_block(ca.G2L_MMA, b, n)
    assert rows == 16 * ca.G2L_WARPS * tpw and 1 <= tpw <= 4
    cover = np.zeros(n, np.int64)
    for blk in range(-(-n // rows)):
        for warp in range(ca.G2L_WARPS):
            for t in range(tpw):
                r0 = blk * rows + (t * ca.G2L_WARPS + warp) * 16
                if r0 < n:
                    cover[r0:min(n, r0 + 16)] += 1
    assert (cover == 1).all()


def _emulate(q, k, v):
    """The tensor-core kernel's decomposition on the host: 16-row tiles,
    latents padded to the bucket with zero K and V rows and -inf logits,
    fp32 logits times the scale, row max and sum, lse = m + log(den),
    P = e * (1 / den) rounded to v's dtype, O in fp32 rounded once."""
    b, n, d = q.shape
    l = k.shape[1]
    lp = ca.g2l_lp(l)
    kp = torch.zeros(b, lp, d, dtype=k.dtype)
    vp = torch.zeros(b, lp, v.shape[2], dtype=v.dtype)
    kp[:, :l], vp[:, :l] = k, v
    o = torch.empty(b, n, v.shape[2], dtype=v.dtype)
    lse = torch.empty(b, n)
    for r0 in range(0, n, 16):
        s = torch.einsum("bnd,bld->bnl", q[:, r0:r0 + 16].float(),
                         kp.float()) * (1.0 / math.sqrt(d))
        s[..., l:] = -math.inf
        m = s.amax(-1, keepdim=True)
        e = torch.exp(s - m)
        den = e.sum(-1, keepdim=True)
        p = (e * (1.0 / den)).to(v.dtype)
        o[:, r0:r0 + 16] = torch.einsum("bnl,bld->bnd", p.float(),
                                        vp.float()).to(v.dtype)
        lse[:, r0:r0 + 16] = (m + torch.log(den))[..., 0]
    return o, lse


@pytest.mark.parametrize("l", [3, 16, 20, 32, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_emulated_kernel_matches_plain(rng, l, dtype):
    """Padding the latents to the bucket changes nothing (zero V rows,
    -inf logits), and the per-tile softmax and P rounding are the plain
    version's: o within the smoke's tolerance class of its dtype (P may
    round differently by one ulp where e / den and e * (1 / den) differ),
    lse to fp32 rounding."""
    q = torch.from_numpy(rng.randn(2, 40, 64).astype(np.float32)).to(dtype)
    k = torch.from_numpy(rng.randn(2, l, 64).astype(np.float32)).to(dtype)
    v = torch.from_numpy(rng.randn(2, l, 64).astype(np.float32)).to(dtype)
    o, lse = _emulate(q, k, v)
    ro, rlse = attention_fwd_stats_plain(q, k, v)
    tol = chip_smoke.KERNEL_TOL[str(dtype)[6:]] * float(ro.float().abs().max())
    assert float((o.float() - ro.float()).abs().max()) <= tol
    np.testing.assert_allclose(lse.numpy(), rlse.numpy(), rtol=1e-6,
                               atol=1e-6)


def _source_constants():
    src = (pathlib.Path(_build.CSRC) / "attention.cu").read_text()
    return {name: int(val) for name, val in
            re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def test_plan_constants_match_the_kernel_source():
    """The wrapper's copy of the kernel's constants (warps, ring slots,
    q chunk, SMs, the CUDA-core route's rows and warps, the latents at
    most) is the source's."""
    const = _source_constants()
    assert const["kMmaWarps"] == ca.G2L_WARPS
    assert const["kQStages"] == ca.G2L_STAGES
    assert const["kQChunk"] == ca.G2L_CHUNK
    assert const["kSms"] == ca.SMS
    assert const["kG2LRows"] == ca.G2L_SIMT_ROWS
    assert const["kWarps"] == ca.G2L_SIMT_WARPS
    assert const["kMaxL"] == ca.MAX_LATENTS


def test_other_shapes_take_the_cuda_core_route():
    """fp32, D or Dv not a multiple of 64, or K and V too large for
    shared memory: the CUDA-core kernel (where its own shared memory
    fits)."""
    bf16 = torch.bfloat16
    assert ca.g2l_path(bf16, 16, 512, 512) == ca.G2L_MMA
    assert ca.g2l_path(bf16, 16, 48, 64) == ca.G2L_SIMT
    assert ca.g2l_path(bf16, 16, 64, 96) == ca.G2L_SIMT
    assert ca.g2l_path(bf16, 64, 1024, 1024) == ca.G2L_SIMT
    assert ca.g2l_path(torch.float32, 16, 512, 512) == ca.G2L_SIMT


def test_cuda_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 16, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ca.grid_to_latent_cuda(q, q, q)
