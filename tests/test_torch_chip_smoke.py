"""What of ``chip_smoke.py`` can be checked on the CPU: its launch plans,
that its library yardsticks compute the kernels' functions, that its
planted faults lie outside the tolerances, and that it fails without a
card (here) and without the package beside it."""

import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
import dataclasses

from gansformer_tpu_torch.core import config as port_config
from gansformer_tpu_torch.ops import modulated_conv as port_mc
from gansformer_tpu_torch.ops.cuda_modconv import TAPS
from gansformer_tpu_torch.ops.attention import attention_plain
from gansformer_tpu_torch.ops.upfirdn2d import setup_filter, upfirdn2d_plain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_launch_plan_of_ffhq256_duplex():
    calls = chip_smoke.main_path_calls(
        port_config.get_preset("ffhq256-duplex"), 8)
    counts = {k: sum(c["kernel"] == k for c in calls)
              for k in chip_smoke.SERVE_KERNELS}
    assert counts == {"modconv": 20, "upfirdn": 12, "grid_to_latent": 7,
                      "latent_to_grid": 5}


def _t(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("kind", ["same3", "same1", "poly"])
def test_library_modconv_computes_the_kernel_function(rng, kind):
    k = 1 if kind == "same1" else 3
    x, s = _t(rng, 2, 6, 5, 4), _t(rng, 2, 4) * 0.2 + 1.0
    w = _t(rng, k, k, 4, 3) * 0.3
    cok = 3 * (4 if kind == "poly" else 1)
    ref = port_mc.modconv_plain(x, port_mc.stack_weights(kind, w), s,
                                torch.ones(2, cok), None, kind, None, 0.2,
                                1.0)
    lib = chip_smoke.library_modconv(x * s[:, None, None, :], w, kind)()
    np.testing.assert_allclose(lib.permute(0, 2, 3, 1).numpy(), ref.numpy(),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("up", [1, 2])
def test_library_upfirdn_computes_the_kernel_function(rng, up):
    f = setup_filter((1, 3, 3, 1), gain=4.0)
    x = _t(rng, 2, 6, 5, 3)
    pads = (2, 1, 2, 1)
    ref = upfirdn2d_plain(x, f, up, 1, pads)
    lib = chip_smoke.library_upfirdn(x, f, up, pads)()
    np.testing.assert_allclose(lib.permute(0, 2, 3, 1).numpy(), ref.numpy(),
                               atol=1e-5, rtol=1e-5)


def test_library_attention_computes_the_kernel_function(rng):
    q, k, v = _t(rng, 3, 7, 8), _t(rng, 3, 5, 8), _t(rng, 3, 5, 6)
    np.testing.assert_allclose(
        chip_smoke.library_attention(q, k, v)().numpy(),
        attention_plain(q, k, v).numpy(), atol=1e-5, rtol=1e-5)


def test_bound_counts_bytes_and_operations(rng):
    call = dict(kernel="grid_to_latent", label="t", B=2, Lq=16, Lk=4, D=8,
                Dv=8)
    case = chip_smoke.build_case(
        call, torch.float32, torch.Generator().manual_seed(0), dev="cpu")
    assert case["bytes"] == 4 * (2 * 16 * 8 + 2 * 4 * 8 * 2 + 2 * 16 * 8)
    assert math.isclose(case["ops"], 2.0 * 2 * 16 * 4 * 16)
    assert case["controls"] == []


def test_bound_counts_nine_taps_for_the_up_conv():
    """The stride-2 transposed 3x3 conv does 9 taps per input pixel over
    its four phases (4 + 2 + 2 + 1): the zeros of the stored 2x2 phase
    weights are not work, nor bytes the function must read."""
    call = dict(kernel="modconv", label="t", kind="poly", B=2, H=4, Ci=8,
                Co=6, act=None)
    case = chip_smoke.build_case(
        call, torch.float32, torch.Generator().manual_seed(0), dev="cpu")
    assert math.isclose(case["ops"], 2.0 * 2 * 4 * 4 * 9 * 8 * 6)
    x, w, out, s_and_d = 2 * 4 * 4 * 8, 9 * 8 * 6, 2 * 8 * 8 * 6, 2 * 8 + 2 * 6
    assert case["bytes"] == 4 * (x + w + out + s_and_d)


def test_dropped_chunk_control_exceeds_the_bf16_tolerance():
    """The planted fault of latent_to_grid (one key chunk of four left
    out) lies outside the bf16 tolerance the smoke holds the kernel to,
    and a grid small enough for one chunk has no such control."""
    call = dict(kernel="latent_to_grid", label="t", B=2, Lq=4, Lk=64,
                D=16, Dv=8)
    case = chip_smoke.build_case(
        call, torch.float32, torch.Generator().manual_seed(0), dev="cpu",
        chunk=16)
    ref = case["plain"]()
    tol = chip_smoke.KERNEL_TOL["bfloat16"] * float(ref.abs().max())
    (control,) = case["controls"]
    assert float((control["fault"]() - ref).abs().max()) > tol
    case = chip_smoke.build_case(
        call, torch.float32, torch.Generator().manual_seed(0), dev="cpu",
        chunk=64)
    assert case["controls"] == []


def test_fails_without_cuda_or_without_the_package(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           capture_output=True, text=True, timeout=120)
    assert alone.returncode != 0 and '"ok"' not in alone.stdout


# Per configuration: the attention launches per d_step and per g_step
# (forward, of them with lse, backward) on top of the conv family's.
TRAIN_PLANS = {
    # PERF.md section 6, rows 5-7: no attention launch at all
    "attention-none": (dict(attention="none"), (0, 0, 0, 0, 0, 0),
                       (0, 0, 0, 0, 0, 0)),
    # the preset: G's 7 grid->latent and 5 latent->grid launches, without
    # lse under no_grad in the d_step, with lse and a backward in the
    # g_step (rows 8-9)
    "preset": (dict(), (7, 5, 0, 0, 0, 0), (7, 5, 7, 5, 7, 5)),
    # + D attention at 128, 64, 32, 16, 8: 5 + 5 launches with lse and
    # their backward per D forward, two D forwards in the d_step
    "preset-d_attention": (dict(d_attention=True), (17, 15, 10, 10, 10, 10),
                           (12, 10, 12, 10, 12, 10)),
}


@pytest.mark.parametrize("name", sorted(TRAIN_PLANS))
def test_train_launch_plan_of_ffhq256_attention_none(name):
    """One d_step: G's forward (no graph), D on reals and fakes, D's
    backward through both; one g_step: G's forward, D on the fakes, the
    backward of both.  Pinned for attention none (the conv family's
    counts), the ffhq256-duplex preset and the preset with d_attention."""
    over, d_attn, g_attn = TRAIN_PLANS[name]
    cfg = dataclasses.replace(port_config.get_preset("ffhq256-duplex"),
                              **over)
    calls = chip_smoke.train_path_calls(cfg, 8)
    zero = dict.fromkeys(chip_smoke.REPLACES, 0)
    for phase, conv, attn in (
            ("d_step", dict(modconv=20, upfirdn=36, upfirdn_adjoint=24),
             d_attn),
            ("g_step", dict(modconv=20, upfirdn=24, modconv_dx=20,
                            modconv_dw=20, upfirdn_adjoint=24), g_attn)):
        g2l, l2g, g2l_lse, l2g_lse, g2l_bwd, l2g_bwd = attn
        assert chip_smoke.plan_counts(calls, phase) == dict(
            zero, **conv, grid_to_latent=g2l, latent_to_grid=l2g,
            grid_to_latent_bwd=g2l_bwd, latent_to_grid_bwd=l2g_bwd), phase
        assert chip_smoke.plan_lse_counts(calls, phase) == dict(
            grid_to_latent=g2l_lse, latent_to_grid=l2g_lse), phase
    labels = {c["label"] for c in calls}
    flagship = set(chip_smoke.TRAIN_FLAGSHIP)
    if name == "attention-none":
        flagship = {f for f in flagship if "main" not in f
                    and "centroid" not in f}
    assert flagship <= labels


@pytest.mark.parametrize("kind", ["same3", "same1", "poly"])
@pytest.mark.parametrize("which", ["dx", "dw"])
def test_library_conv_grad_computes_the_backward(rng, kind, which):
    """The cuDNN yardstick of kernels 5 and 6 (s = d = 1) is the plain
    backward on the same inputs."""
    k = 1 if kind == "same1" else 3
    up = 2 if kind == "poly" else 1
    x, w = _t(rng, 2, 5, 4, 6), _t(rng, k, k, 6, 3) * 0.3
    du = _t(rng, 2, 5 * up, 4 * up, 3)
    s, d = torch.ones(2, 6), torch.ones(2, 3)
    du4 = port_mc._space_to_depth(du) if kind == "poly" else du
    pre = port_mc._post(kind, d)
    lib = chip_smoke.library_conv_grad(x, w, du, kind, which)()
    if which == "dx":
        _, _, wT = port_mc._prep_adjoint(kind, w)
        ref, _ = port_mc.modconv_dx_plain(du4, wT, pre, s, x,
                                          port_mc.adjoint_taps(kind))
        got = lib[0].permute(0, 2, 3, 1)
    else:
        dwt = port_mc.modconv_dw_plain(x, du4, s, pre, TAPS[kind])
        ref = (port_mc._poly_dw_fold(dwt, 6, 3) if kind == "poly"
               else dwt.reshape(w.shape))
        got = lib[1].permute(2, 3, 1, 0)
        if kind == "poly":                 # [Ci, Co, kh, kw], flipped
            got = torch.flip(lib[1].permute(2, 3, 0, 1), (0, 1))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("kname", ["modconv_dx", "modconv_dw",
                                   "upfirdn_adjoint"])
def test_backward_controls_exceed_the_tolerances(kname):
    """Each planted fault of the backward kernels lies outside its output's
    bf16 tolerance wherever it changes anything (the symmetric blur filter
    makes the unflipped adjoint exact), and the bound counts the
    forward's multiply-adds for the modconv backward."""
    call = dict(kernel=kname, label="t", kind="same3", B=4, H=16, Ci=8,
                Co=8, act=None, C=8, up=1, down=1, pads=(2, 1, 2, 1))
    case = chip_smoke.build_case(
        call, torch.float32, torch.Generator().manual_seed(0), dev="cpu")
    ref = chip_smoke._tuple(case["plain"]())
    assert case["controls"]
    changed = 0
    for ctl in case["controls"]:
        base = (chip_smoke._tuple(ctl["plain"]()) if "plain" in ctl
                else ref)[ctl["out"]]
        kind = case["outputs"][ctl["out"]]
        tol = chip_smoke.TOLS[kind]["bfloat16"] * float(base.abs().max())
        err = float((chip_smoke._tuple(ctl["fault"]())[0] - base)
                    .abs().max())
        assert err == 0.0 or err > tol, ctl["desc"]
        changed += err > 0
    assert changed >= 1
    if kname != "upfirdn_adjoint":
        assert math.isclose(case["ops"], 2.0 * 4 * 16 * 16 * 9 * 8 * 8)


def test_ptxas_summary_reads_registers_and_spills():
    """The smoke reports each kernel's registers and spills from the
    build's ``-Xptxas -v`` log, by demangled name."""
    ns = "_GLOBAL__N__b9f88356_14_modconv_bwd_cu_b3b38dcb"

    def sym(name, rest):
        return f"_ZN{len(ns)}{ns}{len(name)}{name}{rest}"

    log = "\n".join([
        f"ptxas info    : Compiling entry function "
        f"'{sym('dw_fma_kernel', 'I13__nv_bfloat16EEvPKT_')}' for 'sm_90a'",
        "    80 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers, 8704 bytes smem",
        f"ptxas info    : Compiling entry function "
        f"'{sym('dw_wmma_kernel', 'EPK13__nv_bfloat16')}' for 'sm_90a'",
        "    208 bytes stack frame, 124 bytes spill stores, 132 bytes spill "
        "loads",
        "ptxas info    : Used 255 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function "
        f"'{sym('dx_fma_kernel', 'IfEEvPKT_')}' for 'sm_90a'",
        "ptxas info    : Used 63 registers, used 1 barriers"])
    assert chip_smoke.ptxas_summary(log) == [
        ("dw_fma_kernel<bf16>", 64, 0), ("dw_wmma_kernel", 255, 124),
        ("dx_fma_kernel<float>", 63, 0)]


# kernel, call shape, the controls each case must carry
ATTENTION_CONTROLS = {
    "grid_to_latent": (dict(B=2, Lq=64, Lk=4, D=16, Dv=8),
                       ["lse = max without log(den)"]),
    "latent_to_grid": (dict(B=2, Lq=4, Lk=64, D=16, Dv=8),
                       ["drop-one-chunk", "lse = max without log(den)"]),
    "grid_to_latent_bwd": (dict(B=2, Lq=64, Lk=4, D=16, Dv=8),
                           ["dk without one row chunk's partial",
                            "dv without one row chunk's partial",
                            "dq with dS = P dP (no delta)",
                            "dk with dS = P dP (no delta)"]),
    "latent_to_grid_bwd": (dict(B=2, Lq=4, Lk=64, D=16, Dv=8),
                           ["dq without one key chunk's partial",
                            "dq with delta = 0", "dk with delta = 0"]),
}


@pytest.mark.parametrize("kname", sorted(ATTENTION_CONTROLS))
def test_attention_controls_exceed_the_bf16_tolerance(kname):
    """Each planted fault of the attention kernels (a dropped chunk of the
    split sums, the row correction delta left out, lse without its
    log-denominator) lies outside its output's bf16 tolerance on the
    plain outputs; with one chunk the dropped-chunk controls vanish."""
    shape, want = ATTENTION_CONTROLS[kname]
    call = dict(kernel=kname, label="t", lse=True, **shape)
    case = chip_smoke.build_case(
        call, torch.float32, torch.Generator().manual_seed(0), dev="cpu",
        chunk=16)
    assert [c["desc"] for c in case["controls"]] == want
    ref = chip_smoke._tuple(case["plain"]())
    assert len(ref) == len(case["outputs"]) == (2 if "bwd" not in kname
                                                else 3)
    for ctl in case["controls"]:
        base = ref[ctl["out"]]
        kind = case["outputs"][ctl["out"]]
        tol = chip_smoke.TOLS[kind]["bfloat16"] * float(base.abs().max())
        err = float((ctl["fault"]() - base).abs().max())
        assert err > tol, (ctl["desc"], err, tol)
    one = chip_smoke.build_case(
        call, torch.float32, torch.Generator().manual_seed(0), dev="cpu",
        chunk=64)
    assert not any("chunk" in c["desc"] for c in one["controls"])


@pytest.mark.parametrize("direction", ["grid_to_latent", "latent_to_grid"])
def test_library_attention_bwd_computes_the_backward(rng, direction):
    """The SDPA yardstick of kernels 8 and 9 is the plain backward on the
    same inputs, and names the backend PyTorch picked."""
    from gansformer_tpu_torch.ops.attention import (attention_bwd_plain,
                                                    attention_fwd_stats_plain)

    lq, lk = (12, 3) if direction == "grid_to_latent" else (3, 12)
    q, k, v = _t(rng, 2, lq, 8), _t(rng, 2, lk, 8), _t(rng, 2, lk, 6)
    do = _t(rng, 2, lq, 6)
    fn, backend = chip_smoke.library_attention_bwd(q, k, v, do)
    assert backend in ("flash", "efficient", "cudnn", "math")
    _, lse = attention_fwd_stats_plain(q, k, v)
    for got, ref in zip(fn(), attention_bwd_plain(q, k, v, lse, do)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_attention_backward_bound_counts_bytes_and_operations():
    """Backward: q, k, v, do and the fp32 lse read (latent_to_grid also
    its fp32 delta), dq, dk, dv written; five products.  At ffhq256-duplex
    one g_step makes 7 grid->latent and 5 latent->grid backward
    launches, both bound by bytes."""
    b, lq, lk, d, dv = 2, 16, 4, 8, 6
    for kname, stats in (("grid_to_latent_bwd", 1),
                         ("latent_to_grid_bwd", 2)):
        nbytes, ops = chip_smoke.attention_cost(
            dict(kernel=kname, B=b, Lq=lq, Lk=lk, D=d, Dv=dv), 2)
        assert nbytes == 2 * (2 * (b * lq * d + b * lk * d + b * lk * dv)
                              + b * lq * dv) + 4 * b * lq * stats
        assert math.isclose(ops, 2.0 * b * lq * lk * (3 * d + 2 * dv))
    bounds = chip_smoke.attention_backward_bounds(
        port_config.get_preset("ffhq256-duplex"), 8, chip_smoke.PEAKS["H100"])
    assert {k: r["launches"] for k, r in bounds.items()} == {
        "grid_to_latent_bwd": 7, "latent_to_grid_bwd": 5}
    for r in bounds.values():
        assert r["bytes_ms"] > r["ops_ms"]
