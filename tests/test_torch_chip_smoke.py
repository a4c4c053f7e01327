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
from tests.test_torch_grads import card_route  # noqa: F401  (fixture)
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

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
    assert [c["desc"] for c in case["controls"]] == [
        "the last latent dropped", "K/V of samples 0 and 1 swapped"]


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


# The forward upfirdn launches of the path, by label: G's blur (with and
# without the fused bias + lrelu epilogue), G's 3-channel skip upsample,
# D's blur-pool and decimated skip.
UPFIRDN_FORWARDS = {
    "blur": dict(H=16, C=8, up=1, pads=(2, 1, 2, 1)),
    "blur +bias lrelu": dict(H=16, C=8, up=1, pads=(2, 1, 2, 1),
                             act="lrelu"),
    "skip up": dict(H=8, C=3, up=2, pads=(2, 1, 2, 1)),
    "blur-pool": dict(H=16, C=8, up=1, down=1, pads=(2, 2, 2, 2), gain=1.0),
    "skip down": dict(H=16, C=8, up=1, down=2, pads=(1, 1, 1, 1), gain=1.0),
}


@pytest.mark.parametrize("label", sorted(UPFIRDN_FORWARDS))
def test_forward_upfirdn_controls_exceed_the_tolerances(label):
    """The upfirdn forward's planted faults (one tap dropped; the ramp
    filter not flipped, on the ramp case the kernel also runs) lie
    outside the bf16 tolerance on the plain outputs of every path
    geometry, the fused epilogue's too; the epilogue case's plain version
    applies lrelu(y + bias) * sqrt(2), and its library yardstick computes
    the same."""
    call = dict(kernel="upfirdn", label=label, B=4,
                **UPFIRDN_FORWARDS[label])
    case = chip_smoke.build_case(
        call, torch.float32, torch.Generator().manual_seed(0), dev="cpu")
    assert [c["desc"] for c in case["controls"]] == [
        "tap (1, 1) dropped", "ramp filter not flipped"]
    ref = case["plain"]()
    for ctl in case["controls"]:
        base = ctl["plain"]() if "plain" in ctl else ref
        tol = chip_smoke.KERNEL_TOL["bfloat16"] * float(base.abs().max())
        err = float((ctl["fault"]() - base).abs().max())
        assert err > tol, (ctl["desc"], err, tol)
    lib = case["library"]().permute(0, 2, 3, 1)
    np.testing.assert_allclose(lib.numpy(), ref.numpy(), atol=1e-5,
                               rtol=1e-5)
    if "act" in call:
        assert float(ref.min()) < 0 < float(ref.max())
        bare = chip_smoke.build_case(
            dict(call, act=None), torch.float32,
            torch.Generator().manual_seed(0), dev="cpu")
        assert case["bytes"] == bare["bytes"] + 4 * call["C"]


@pytest.mark.parametrize("lk", [16, 32])
def test_grid_to_latent_forward_controls_exceed_the_bf16_tolerance(lk):
    """The grid->latent forward's planted faults (the last latent dropped;
    the keys and values of samples 0 and 1 swapped, a fault batch 1
    cannot show) lie outside the bf16 tolerance at the path's latent
    counts; batch 1 carries no swap control."""
    call = dict(kernel="grid_to_latent", label="t", B=8, Lq=256, Lk=lk,
                D=64, Dv=64, lse=True)
    case = chip_smoke.build_case(
        call, torch.float32, torch.Generator().manual_seed(0), dev="cpu")
    ref = case["plain"]()[0]
    tol = chip_smoke.KERNEL_TOL["bfloat16"] * float(ref.abs().max())
    descs = [c["desc"] for c in case["controls"]]
    assert descs[:2] == ["the last latent dropped",
                         "K/V of samples 0 and 1 swapped"]
    for ctl in case["controls"][:2]:
        err = float((ctl["fault"]() - ref).abs().max())
        assert err > tol, (ctl["desc"], err, tol)
    one = chip_smoke.build_case(dict(call, B=1), torch.float32,
                                torch.Generator().manual_seed(0), dev="cpu")
    assert not any("swapped" in c["desc"] for c in one["controls"])


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


def test_demangled_name_keeps_integer_template_arguments():
    """The wgmma kernels are templates on tile sizes: the ptxas and SASS
    reports name each instantiation apart."""
    ns = "_GLOBAL__N__b9f88356_14_modconv_bwd_cu_b3b38dcb"
    pre = f"_ZN{len(ns)}{ns}"
    assert chip_smoke._demangled_name(
        pre + "15dw_wgmma_kernelILi2ELi128EEEv14CUtensorMap_stS1_PKf") \
        == "dw_wgmma_kernel<2,128>"
    assert chip_smoke._demangled_name(
        pre + "15dx_wgmma_kernelILi64EEEv14CUtensorMap_st") \
        == "dx_wgmma_kernel<64>"
    assert chip_smoke._demangled_name(pre + "16dw_reduce_kernelEPKfPfxi") \
        == "dw_reduce_kernel"


# kernel, call shape, the controls each case must carry
ATTENTION_CONTROLS = {
    "grid_to_latent": (dict(B=2, Lq=64, Lk=4, D=16, Dv=8),
                       ["the last latent dropped",
                        "K/V of samples 0 and 1 swapped",
                        "lse = max without log(den)"]),
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
    """Backward: q, k, v, do read (latent_to_grid also its fp32 lse and
    delta; grid_to_latent takes each row's lse from its own logits), dq,
    dk, dv written; five products.  At ffhq256-duplex one g_step makes 7
    grid->latent and 5 latent->grid backward launches, both bound by
    bytes."""
    b, lq, lk, d, dv = 2, 16, 4, 8, 6
    for kname, stats in (("grid_to_latent_bwd", 0),
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


@pytest.mark.parametrize("kind", ["same3", "same1", "poly"])
def test_forward_controls_exceed_the_tolerances(kind):
    """The modconv forward's planted faults (the styles of samples 0 and 1
    swapped, the middle tap dropped, and, where the launch splits its
    contraction, one split's partial dropped) each lie outside the bf16
    tolerance on the plain outputs; batch 1 has no pair of samples to
    swap, and an unsplit launch no split to drop."""
    co = 3 if kind == "same1" else 64
    call = dict(kernel="modconv", label="t", kind=kind, B=4, H=4, Ci=64,
                Co=co, act="linear" if kind == "same1" else None)
    case = chip_smoke.build_case(
        call, torch.bfloat16, torch.Generator().manual_seed(0), dev="cpu")
    _, p = chip_smoke.fwd_plan(call, torch.bfloat16, dev="cpu")
    descs = [c["desc"] for c in case["controls"]]
    tap = 0 if kind == "same1" else len(TAPS[kind]) // 2
    assert descs[:2] == ["styles of samples 0 and 1 swapped",
                         f"tap {tap} dropped"]
    assert (p > 1) == (kind != "same1")      # the tRGB's small-K path
    assert len(descs) == (3 if p > 1 else 2)
    if p > 1:
        assert descs[2] == f"split {p // 2} of {p} dropped"
    ref = case["plain"]().float()
    tol = chip_smoke.KERNEL_TOL["bfloat16"] * float(ref.abs().max())
    for ctl in case["controls"]:
        err = float((ctl["fault"]().float() - ref).abs().max())
        assert err > tol, (ctl["desc"], err, tol)
    one = chip_smoke.build_case(dict(call, B=1), torch.bfloat16,
                                torch.Generator().manual_seed(0), dev="cpu")
    assert not any("swapped" in c["desc"] for c in one["controls"])
    wide = chip_smoke.build_case(dict(call, B=8, H=64), torch.bfloat16,
                                 torch.Generator().manual_seed(0), dev="cpu")
    assert not any("split" in c["desc"] for c in wide["controls"])


@pytest.mark.parametrize("name", chip_smoke.PRESET_PHASES)
def test_launch_plan_of_each_preset_phase(name):
    """The presets the smoke drives beside ffhq256-duplex: per synthesize
    3 modconv launches a block but the first (2 + 1 at res 4), 2 upfirdn
    launches a block above res 4, per attention resolution a centroid and
    a main launch (duplex) or a main launch alone (simplex); a d_step and
    a g_step as for ffhq256 (G's launches, D's 2 upfirdn launches a block
    above res 4 per D forward, and the backward of what takes a
    gradient).  cityscapes256-duplex's 32 components outnumber res 4's
    16 pixels, so its main launch there is latent->grid with 32 keys (the
    L <= 32 instantiations); clevr64-simplex never launches latent->grid;
    ffhq1024-duplex adds 512^2 and 1024^2 launches at 32 and 16 channels."""
    cfg = port_config.get_preset(name)
    nb = len(cfg.block_resolutions)
    attn = len(cfg.attn_resolutions())
    duplex = cfg.attention == "duplex"
    serve = chip_smoke.main_path_calls(cfg, 8)
    count = {k: sum(c["kernel"] == k for c in serve)
             for k in chip_smoke.SERVE_KERNELS}
    assert count["modconv"] == 3 * nb - 1
    assert count["upfirdn"] == 2 * (nb - 1)
    assert count["grid_to_latent"] + count["latent_to_grid"] == \
        attn * (1 + cfg.kmeans_iters * duplex)
    calls = chip_smoke.train_path_calls(cfg, 8)
    zero = dict.fromkeys(chip_smoke.REPLACES, 0)
    d_plan = chip_smoke.plan_counts(calls, "d_step")
    g_plan = chip_smoke.plan_counts(calls, "g_step")
    d_up = 2 * (nb - 1)
    assert d_plan == dict(zero, modconv=count["modconv"],
                          upfirdn=count["upfirdn"] + 2 * d_up,
                          upfirdn_adjoint=2 * d_up,
                          grid_to_latent=count["grid_to_latent"],
                          latent_to_grid=count["latent_to_grid"])
    assert g_plan == dict(zero, modconv=count["modconv"],
                          upfirdn=count["upfirdn"] + d_up,
                          modconv_dx=count["modconv"],
                          modconv_dw=count["modconv"],
                          upfirdn_adjoint=count["upfirdn"] + d_up,
                          grid_to_latent=count["grid_to_latent"],
                          latent_to_grid=count["latent_to_grid"],
                          grid_to_latent_bwd=count["grid_to_latent"],
                          latent_to_grid_bwd=count["latent_to_grid"])
    mains = [c for c in serve if c["label"].endswith(" main")]
    if name == "cityscapes256-duplex":
        assert (count["grid_to_latent"], count["latent_to_grid"]) == (6, 6)
        first = mains[0]
        assert (first["kernel"], first["Lq"], first["Lk"]) == \
            ("latent_to_grid", 16, 32)
    if name == "clevr64-simplex":
        assert cfg.dtype == "float32" and count["latent_to_grid"] == 0
        assert [c["label"] for c in serve if "centroid" in c["label"]] == []
    if name == "ffhq1024-duplex":
        conv = {(c["H"], c["Ci"]) for c in serve if c.get("kind") == "same3"}
        assert {(512, 32), (1024, 16)} <= conv


# Micro configurations with the preset phases' structural features: simplex
# attention (clevr64-simplex), and more components than the 16 pixels of
# res 4 (cityscapes256-duplex's 32), so the main launch there is
# latent->grid.
PHASE_VARIANTS = {
    "simplex": dict(attention="simplex", components=3),
    "components-over-res4": dict(attention="duplex", style_mode="attention",
                                 components=20),
}


@pytest.mark.parametrize("variant", sorted(PHASE_VARIANTS))
def test_preset_phase_plans_match_the_cards_route(card_route, variant):
    """With every launch stubbed on the card's route, one synthesize and
    one d_step + g_step of a micro configuration with a preset phase's
    structure launch what ``chip_smoke``'s plans say, the launches that
    write lse included (the counters the smoke holds the card to)."""
    from gansformer_tpu_torch import ops
    from gansformer_tpu_torch.data import SyntheticDataset
    from gansformer_tpu_torch.serve import ServePrograms, init_generator
    from gansformer_tpu_torch.train import create_train_state, d_step, \
        g_step

    model = port_config.ModelConfig(
        resolution=16, latent_dim=16, w_dim=16, mapping_dim=16,
        mapping_layers=2, fmap_base=64, fmap_max=32, mbstd_group_size=4,
        **PHASE_VARIANTS[variant])
    progs = ServePrograms(init_generator(model, seed=0, device="cpu"))
    ops.reset_launch_counts()
    progs.synthesize(progs.map_seeds([1, 2, 3, 4]), [0.7, 1.0, 0.7, 1.0])
    serve = chip_smoke.main_path_calls(model, 4)
    assert ops.launch_counts() == {
        k: sum(c["kernel"] == k for c in serve) for k in chip_smoke.REPLACES}
    main4 = [c["kernel"] for c in serve if c["label"] == "b4 main"]
    assert main4 == ["grid_to_latent" if variant == "simplex"
                     else "latent_to_grid"]
    if variant == "simplex":
        assert ops.launch_counts()["latent_to_grid"] == 0
    st = create_train_state(model, port_config.TrainConfig(batch_size=4),
                            seed=1, device="cpu")
    chip_smoke.perturb(st.generator)
    reals = torch.from_numpy(next(SyntheticDataset(16).batches(4))["image"])
    plan = chip_smoke.train_path_calls(model, 4)
    for phase, step in (("d_step", lambda: d_step(st, reals, 0)),
                        ("g_step", lambda: g_step(st, 0, 4))):
        ops.reset_launch_counts()
        step()
        assert ops.launch_counts() == chip_smoke.plan_counts(plan, phase)
        assert ops.lse_launch_counts() == chip_smoke.plan_lse_counts(plan,
                                                                     phase)


@pytest.mark.parametrize("d_attention", [False, True],
                         ids=["no-d_attention", "d_attention"])
def test_d_step_r1_plan_matches_the_cards_route(card_route, d_attention):
    """With every launch stubbed on the card's route, one d_step_r1 of a
    micro configuration (res 32, duplex, with and without D attention)
    launches what ``chip_smoke.r1_step_calls`` says, lse and second-order
    passes included: the counters the smoke holds the card to."""
    from gansformer_tpu_torch import ops
    from gansformer_tpu_torch.data import SyntheticDataset
    from gansformer_tpu_torch.train import create_train_state, d_step_r1

    model = port_config.ModelConfig(
        resolution=32, latent_dim=16, w_dim=16, mapping_dim=16,
        mapping_layers=2, fmap_base=64, fmap_max=32, mbstd_group_size=4,
        components=2, attention="duplex", style_mode="attention",
        d_attention=d_attention, d_components=3)
    st = create_train_state(model, port_config.TrainConfig(batch_size=4),
                            seed=1, device="cpu")
    reals = torch.from_numpy(next(SyntheticDataset(32).batches(4))["image"])
    plan = chip_smoke.r1_step_calls(model, 4)
    ops.reset_launch_counts()
    aux = d_step_r1(st, reals, 0)
    assert ops.launch_counts() == chip_smoke.plan_counts(plan, "d_step_r1")
    assert ops.lse_launch_counts() == chip_smoke.plan_lse_counts(
        plan, "d_step_r1")
    second = chip_smoke.plan_second_order_counts(model, 4)
    assert ops.second_order_counts() == second
    assert second["upfirdn_second_order"] == 6     # 3 blocks, 2 legs each
    assert bool(second["grid_to_latent_second_order"]) == d_attention
    assert math.isfinite(float(aux["Loss/D/r1"]))


@pytest.mark.parametrize("d_attention", [False, True],
                         ids=["no-d_attention", "d_attention"])
def test_reference_rule_passes_the_route_and_rejects_the_planted_drop(
        d_attention):
    """The smoke's float64-referenced check on a micro configuration: the
    R1 penalty's gradient on the card's route (launches stubbed) passes
    ``hold_to_reference`` against the plain path's float64 run (its fp32
    run giving each leaf's own error), and the same with one adjoint
    launch of the image gradient outside its Function (the planted
    second-order drop) fails it."""
    from gansformer_tpu_torch import ops
    from tests.test_torch_grads import patch_card_route

    model = port_config.ModelConfig(
        resolution=32, latent_dim=16, w_dim=16, mapping_dim=16,
        mapping_layers=2, fmap_base=128, fmap_max=32, mbstd_group_size=4,
        components=2, attention="duplex", style_mode="attention",
        d_attention=d_attention, d_components=3)
    train = port_config.TrainConfig(batch_size=2, style_mixing_prob=0.0)
    ref, host = (chip_smoke._reference_grads(model, train, "R1 penalty",
                                             "cpu", dtype)
                 for dtype in ("float64", "float32"))
    with pytest.MonkeyPatch.context() as mp:
        patch_card_route(mp)
        ops.reset_launch_counts()
        route, planted = (chip_smoke._reference_grads(
            model, train, "R1 penalty", "cpu", "float32", plant=plant)
            for plant in (False, True))
        # 3 blocks of 2 legs, less the planted launch's second order
        second = ops.second_order_counts()["upfirdn_second_order"]
        ops.reset_launch_counts()
    assert second == 6 + 5
    assert chip_smoke.hold_to_reference("route", ref, [host], route) == []
    assert chip_smoke.hold_to_reference("planted", ref, [host], planted)


@pytest.mark.parametrize("d_attention", [False, True],
                         ids=["no-d_attention", "d_attention"])
def test_host_branches_sum_to_the_d_step_r1(d_attention):
    """The smoke's host reference is built by branch: the logistic loss on
    the reals, on G's images, and the R1 penalty, weighted by
    ``r1_gamma / 2 * d_reg_interval``.  In float64 on a micro
    configuration their sum is D's gradient of one d_step_r1 through the
    entry point, and the R1 branch is the penalty's own, to the fp32
    rounding of the entry points' gradients, which land in the fp32
    parameters' ``.grad`` (1e-6 of a leaf's scale; a key bias, whose
    exact gradient is zero, at its weight's scale as the smoke holds
    it)."""
    model = port_config.ModelConfig(
        resolution=32, latent_dim=16, w_dim=16, mapping_dim=16,
        mapping_layers=2, fmap_base=128, fmap_max=32, mbstd_group_size=4,
        components=2, attention="duplex", style_mode="attention",
        d_attention=d_attention, d_components=3, dtype="float32")
    train = port_config.TrainConfig(batch_size=2, style_mixing_prob=0.0)
    x, fakes = chip_smoke.reference_inputs(model, train)
    assert float(fakes.abs().max()) == 1.0
    br = chip_smoke.host_branches(model, train, "float64", x, fakes)
    weight = train.r1_gamma * 0.5 * train.d_reg_interval
    step = chip_smoke._reference_grads(model, train, "d_step_r1", "cpu",
                                       "float64", fakes=fakes)
    r1 = chip_smoke._reference_grads(model, train, "R1 penalty", "cpu",
                                     "float64")
    assert set(step) == set(br["R1"])
    for name, g in step.items():
        total = br["reals"][name] + br["fakes"][name] + weight * br["R1"][
            name]
        w = name[:-1] + "w" if chip_smoke._key_bias(name) else name
        assert float((total - g).abs().max()) <= 1e-6 * float(
            step[w].abs().max()), name
        assert float((br["R1"][name] - r1[name]).abs().max()) <= 1e-6 * (
            float(r1[w].abs().max()) or 1.0), name


def _pl_micro(attention):
    return port_config.ModelConfig(
        resolution=32, latent_dim=16, w_dim=16, mapping_dim=16,
        mapping_layers=2, fmap_base=128, fmap_max=32, mbstd_group_size=4,
        components=2, attention=attention, style_mode="attention",
        dtype="float32")


def test_pl_step_plan_of_ffhq256_duplex():
    """One g_step_pl at batch 8 (path length on 4): the g_step's launches,
    then G's forward at 4, its gradient wrt ws (every backward launch),
    the second order (kernels 1, 5, 6 for each of the 13 modconv launches
    that are not a tRGB, kernels 5 and 6 for the 7 tRGBs; kernel 2 for
    the 6 blurs) and the backward of the forward launches the gradient's
    graph saved (all but the tRGBs and the skip upsamplings)."""
    cfg = port_config.get_preset("ffhq256-duplex")
    plan = chip_smoke.pl_step_calls(cfg, 8, 2)
    g_step = chip_smoke.plan_counts(chip_smoke.train_path_calls(cfg, 8),
                                    "g_step")
    got = chip_smoke.plan_counts(plan, "g_step_pl")
    pl = {k: got[k] - g_step[k] for k in got}
    assert pl == {"modconv": 20 + 13, "upfirdn": 12 + 6,
                  "grid_to_latent": 7, "latent_to_grid": 5,
                  "modconv_dx": 20 + 20 + 13, "modconv_dw": 20 + 20 + 13,
                  "upfirdn_adjoint": 12 + 6, "grid_to_latent_bwd": 7 + 7,
                  "latent_to_grid_bwd": 5 + 5}
    assert chip_smoke.plan_pl_second_order_counts(cfg, 8, 2) == {
        "modconv_second_order": 13 * 3 + 7 * 2, "upfirdn_second_order": 6,
        "grid_to_latent_second_order": 7, "latent_to_grid_second_order": 5}
    assert {c["B"] for c in plan if c["label"].endswith("second order")} \
        == {4}


@pytest.mark.parametrize("attention", ["none", "duplex"])
def test_pl_branches_sum_to_the_g_step_pl(attention):
    """The smoke's path-length reference is built by branch: the
    non-saturating loss and the penalty, weighted by ``pl_weight *
    g_reg_interval``.  In float64 on a micro configuration their sum is
    G's gradient of one g_step_pl through the entry point, to the fp32
    rounding of its ``.grad`` (1e-6 of a leaf's scale; a key bias at its
    weight's scale)."""
    model = _pl_micro(attention)
    train = port_config.TrainConfig(batch_size=2, style_mixing_prob=0.0)
    ins = chip_smoke.pl_reference_inputs(model, train)
    assert ins[1].shape[0] == 1 and ins[2].shape == (1, 32, 32, 3)
    br = {k: chip_smoke._pl_grads(model, train, k, "cpu", "float64", ins)
          for k in ("G loss", "PL", "g_step_pl")}
    weight = train.pl_weight * train.g_reg_interval
    for name, g in br["g_step_pl"].items():
        total = br["G loss"][name] + weight * br["PL"][name]
        w = name[:-1] + "w" if chip_smoke._key_bias(name) else name
        assert float((total - g).abs().max()) <= 1e-6 * (
            float(br["g_step_pl"][w].abs().max()) or 1.0), name


@pytest.mark.parametrize("attention", ["none", "duplex"])
def test_pl_reference_rule_passes_the_route_and_rejects_the_planted_drop(
        attention):
    """The smoke's float64-referenced path-length check on a micro
    configuration: the penalty's gradient on the card's route (launches
    stubbed) passes ``hold_to_reference`` against the plain path's
    float64 run (its fp32 run giving each leaf's own error), and the
    same with the first ``ModconvGradsFunction`` run bare (the planted
    second-order drop) fails it."""
    from gansformer_tpu_torch import ops
    from tests.test_torch_grads import patch_card_route

    model = _pl_micro(attention)
    train = port_config.TrainConfig(batch_size=2, style_mixing_prob=0.0)
    ins = chip_smoke.pl_reference_inputs(model, train)
    ref, host = (chip_smoke._pl_grads(model, train, "PL", "cpu", dtype, ins)
                 for dtype in ("float64", "float32"))
    with pytest.MonkeyPatch.context() as mp:
        patch_card_route(mp)
        ops.reset_launch_counts()
        route, planted = (chip_smoke._pl_grads(
            model, train, "PL", "cpu", "float32", ins, plant=plant)
            for plant in (False, True))
        second = ops.second_order_counts()["modconv_second_order"]
        ops.reset_launch_counts()
    # 4 blocks: 7 modconv launches that are not a tRGB (3 launches each)
    # and 4 tRGBs (2 each), twice, less the planted tRGB's 2
    assert second == 2 * (7 * 3 + 4 * 2) - 2
    assert chip_smoke.hold_to_reference("route", ref, [host], route) == []
    assert chip_smoke.hold_to_reference("planted", ref, [host], planted)


def test_perturbed_is_another_fp32_rounding():
    """``perturbed`` moves fp32 entries by a few units of rounding (|e|
    2^-24 and one rounding: below 2^-21 at these 384 draws), moves some
    of them, and is the same for the same seed."""
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 8, 8, 3)
                         .astype(np.float32))
    a, b = chip_smoke.perturbed(x), chip_smoke.perturbed(x)
    assert a.dtype == torch.float32 and torch.equal(a, b)
    rel = ((a - x).abs() / x.abs()).max()
    assert 0 < float(rel) <= 2.0 ** -21
    assert not torch.equal(chip_smoke.perturbed(x, seed=1), a)


# --------------------------------------------------------------------------
# The generate phase
# --------------------------------------------------------------------------

def test_generate_modes_plan_their_synthesize_calls(tmp_path, monkeypatch):
    """``GENERATE_MODES``: each mode's synthesize calls at its batch and
    its PNGs, against the generate CLI on the CPU (a micro run)."""
    from gansformer_tpu_torch.cli import generate
    from gansformer_tpu_torch.serve.programs import ServePrograms
    from gansformer_tpu_torch.train import checkpoint as ckpt
    from gansformer_tpu_torch.train import create_train_state
    from gansformer_tpu_torch.utils.image import decode_png
    from tests.test_torch_loop import micro_exp

    exp = micro_exp()
    run = str(tmp_path / "run")
    st = create_train_state(exp.model, exp.train, 0, "cpu")
    ckpt.save(os.path.join(run, "checkpoints"), st, block=True)
    with open(os.path.join(run, "config.json"), "w") as f:
        f.write(exp.to_json())
    seen = []
    orig = ServePrograms.synthesize

    def spy(self, ws, *a, **k):
        seen.append(ws.shape[0])
        return orig(self, ws, *a, **k)

    monkeypatch.setattr(ServePrograms, "synthesize", spy)
    r = exp.model.resolution
    for mode, extra, batch, synths, pngs in chip_smoke.GENERATE_MODES:
        seen.clear()
        out = str(tmp_path / mode.split()[0])
        assert generate.main(["--run-dir", run, "--out", out, "--device",
                              "cpu"] + extra) == 0
        assert seen == [batch] * synths, mode
        assert sorted(os.listdir(out)) == sorted(pngs)
        for name, (rows, cols) in pngs.items():
            with open(os.path.join(out, name), "rb") as f:
                assert decode_png(f.read()).shape == (rows * r, cols * r, 3)


# --------------------------------------------------------------------------
# The precision and serve-CLI phases
# --------------------------------------------------------------------------

PRECISION_MODEL = dict(resolution=16, components=3, latent_dim=16, w_dim=16,
                       mapping_dim=16, mapping_layers=2, fmap_base=256,
                       fmap_max=32, attention="duplex", attn_start_res=4,
                       attn_max_res=8, style_mode="attention",
                       dtype="bfloat16")


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8w"])
def test_precision_plan_matches_the_cards_route(card_route, monkeypatch,
                                                precision):
    """Each precision's synthesize on the card's route launches
    ``main_path_calls``' plan; f32 of the fp32 configuration hands the
    modconv kernel fp32, bf16 and int8w hand it bf16 (int8w launches the
    bf16 kernels on dequantized weights)."""
    from gansformer_tpu_torch import ops
    from gansformer_tpu_torch.ops import cuda_modconv
    from gansformer_tpu_torch.serve import ServePrograms, init_generator

    cfg = port_config.ModelConfig(**PRECISION_MODEL)
    b32 = chip_smoke.fp32_bundle(cfg, init_generator(cfg, seed=0,
                                                     device="cpu"), "cpu")
    progs = ServePrograms(b32, buckets=chip_smoke.PRECISION_BUCKETS,
                          serve_precision=precision)
    seen = set()
    stub = cuda_modconv.modconv_cuda

    def spy(x, ws, *a, **k):
        seen.add((x.dtype, ws.dtype))
        return stub(x, ws, *a, **k)

    monkeypatch.setattr(cuda_modconv, "modconv_cuda", spy)
    dtype = torch.float32 if precision == "f32" else torch.bfloat16
    for b in chip_smoke.PRECISION_BUCKETS:
        ops.reset_launch_counts()
        ws = progs.map_seeds(list(chip_smoke.PRECISION_SEEDS[:b]))
        progs.synthesize(ws, [chip_smoke.PRECISION_PSI] * b,
                         noise_mode="none")
        calls = chip_smoke.main_path_calls(
            dataclasses.replace(cfg, dtype=str(dtype)[6:]), b)
        assert ops.launch_counts() == {
            k: sum(c["kernel"] == k for c in calls)
            for k in chip_smoke.REPLACES}
    assert seen == {(dtype, dtype)}


def test_precision_gate_passes_and_rejects_the_planted_scale_fault():
    """On the host at micro width, on every case of the phase (psi 0.7 and
    1.0, noise on and off, buckets 8 and 1): every precision within the
    declared tolerance of the fp32 plain path, with no witness clause; the
    witness clause only widens the gate to ``WITNESS_RATIO`` times an
    error above the declared figure; and the int8w program with the
    full-resolution tRGB scales doubled outside the gate that its clean
    program's error as the witness gives."""
    from gansformer_tpu_torch.serve import ServePrograms, init_generator

    cfg = port_config.ModelConfig(**PRECISION_MODEL)
    bundle = init_generator(cfg, seed=0, device="cpu")
    chip_smoke.perturb(bundle.generator)
    b32 = chip_smoke.fp32_bundle(cfg, bundle, "cpu")
    rows = {b: ServePrograms(b32, buckets=(b,)).map_seeds(
        list(chip_smoke.PRECISION_SEEDS[:b]))
        for b in chip_smoke.PRECISION_BUCKETS}
    progs = {p: ServePrograms(b32, buckets=chip_smoke.PRECISION_BUCKETS,
                              serve_precision=p)
             for p in ("f32", "bf16", "int8w")}
    first = chip_smoke.PRECISION_CASES[0]
    assert first[2] == "random"
    for case in chip_smoke.PRECISION_CASES:
        ref = chip_smoke.precision_case(progs["f32"], rows, case)
        for prec, p in progs.items():
            err = chip_smoke.rel_err(
                chip_smoke.precision_case(p, rows, case), ref)
            assert err <= chip_smoke.precision_tolerance(prec), (prec, case,
                                                                 err)
    assert chip_smoke.precision_tolerance("f32") == \
        chip_smoke.MODEL_TOL["float32"]
    assert chip_smoke.precision_tolerance("int8w") == 0.20
    assert chip_smoke.precision_tolerance("bf16", 0.01) == 0.05
    assert chip_smoke.precision_tolerance("bf16", 0.06) == pytest.approx(
        chip_smoke.WITNESS_RATIO * 0.06)
    ref = chip_smoke.precision_case(progs["f32"], rows, first)
    witness = chip_smoke.rel_err(
        chip_smoke.precision_case(progs["int8w"], rows, first), ref)
    chip_smoke.plant_scale_fault(progs["int8w"].synth_module, cfg)
    bad = chip_smoke.rel_err(
        chip_smoke.precision_case(progs["int8w"], rows, first), ref)
    assert bad > chip_smoke.precision_tolerance("int8w", witness)


def test_serve_cli_runs_parse_and_expect_a_cold_then_warm_manifest(
        tmp_path):
    """Each run's arguments parse with the serve CLI's parser, and
    processes on one fresh manifest directory see what the runs expect:
    the first builds, the others load, and one with ``--no-warm-start``
    builds in a directory of its own (the g++ stand-in library of
    ``tests/test_torch_serve_warmstart``)."""
    if shutil.which("g++") is None:
        pytest.skip("the stand-in library is built by g++")
    from gansformer_tpu_torch.cli import serve as serve_cli
    from gansformer_tpu_torch.serve import warmstart
    from tests.test_torch_serve_warmstart import GppLibrary

    d = str(tmp_path / "manifest")
    for title, extra, want in chip_smoke.SERVE_CLI_RUNS:
        args = serve_cli.build_parser().parse_args(
            ["--init", "random", "--preset", chip_smoke.SERVE_CLI_PRESET,
             "--manifest-dir", d] + extra)
        assert args.warm_only == ("--warm-only" in extra)
        lib = GppLibrary(str(tmp_path))
        got = (warmstart.cold_start(str(tmp_path / title), lib)
               if args.no_warm_start else warmstart.warm_start(d, lib))
        assert (got["loaded"], got["compiled"]) == want, title


def test_service_phase_passes_on_the_cards_route(card_route, capsys):
    """``service_phase`` on the host at micro width, every launch a stub
    of the card's route: parity within the f32 gate with the planted tag
    fault outside it, the load run's launches equal to the plan per
    synthesize and one terminal event a request, the chaos drill's gate
    passed."""
    cfg = port_config.ModelConfig(**PRECISION_MODEL)
    out = chip_smoke.service_phase("host", 2000.0, cfg=cfg, device="cpu")
    tol = chip_smoke.precision_tolerance("f32")
    assert out["parity"]["rel_err"] <= tol < out["parity"]["planted"]
    load, chaos = out["load"], out["chaos"]
    assert load["requests"] == chip_smoke.SERVICE_LOAD_REQUESTS
    assert load["buckets"] == list(chip_smoke.SERVICE_BUCKETS)
    assert chaos["queue_bound"] == chip_smoke.SERVICE_CHAOS["queue_depth"]
    assert chaos["crash_at_batch"] == 3 and chaos["burst"] == 32
    text = capsys.readouterr().out
    assert "planted fault (tags from the batch position)" in text


def _load_artifact():
    return {"requests": 4, "images": 4, "non_fulfilled_rids": [],
            "trace_coverage": {"ok": True, "tickets": 4}}


def _chaos_artifact():
    return {"shed": 20, "dispatcher_restarts": 1, "hung_tickets": 0,
            "served": 11, "failed": 1, "expired": 0, "cancelled": 0,
            "accepted": 12, "recovery_wave_served": 7,
            "trace_coverage": {"ok": True},
            "non_fulfilled_requests": [{"cause": "FaultInjected"}],
            "health": {"state": "degraded", "dispatcher_alive": True,
                       "dispatcher_restarts": 1,
                       "reasons": ["dispatcher restarted 1 time(s)"]}}


LOAD_FAULTS = {
    "short": lambda r, m, c: r.update(images=3),
    "unfulfilled": lambda r, m, c: r.update(non_fulfilled_rids=["r1-2"]),
    "untraced": lambda r, m, c: r["trace_coverage"].update(ok=False),
    "two_terminals": lambda r, m, c: m.update(
        {"reqtrace/terminal_total": 6}),
    "launches": lambda r, m, c: c.update(modconv=19),
}
CHAOS_FAULTS = {
    "no_shed": lambda c: c.update(shed=0),
    "two_restarts": lambda c: c.update(dispatcher_restarts=2),
    "hung": lambda c: c.update(hung_tickets=1, served=10),
    "unsettled": lambda c: c.update(served=10),
    "untyped": lambda c: c["non_fulfilled_requests"].append(
        {"cause": "ValueError"}),
    "tripped": lambda c: c["health"].update(state="unhealthy"),
    "down": lambda c: c["health"].update(dispatcher_alive=False),
    "other_reason": lambda c: c["health"]["reasons"].append("saturated"),
    "no_recovery": lambda c: c.update(recovery_wave_served=0),
}


@pytest.mark.parametrize("fault", sorted(LOAD_FAULTS) + sorted(CHAOS_FAULTS))
def test_service_gates_reject_what_they_name(fault):
    moved = {"reqtrace/requests_total": 5, "reqtrace/terminal_total": 5}
    counts = {"modconv": 20, "upfirdn": 12}
    assert chip_smoke.load_gate(_load_artifact(), dict(moved), counts,
                                dict(counts)) is None
    assert chip_smoke.chaos_gate(_chaos_artifact()) is None
    if fault in LOAD_FAULTS:
        r, m, c = _load_artifact(), dict(moved), dict(counts)
        LOAD_FAULTS[fault](r, m, c)
        assert chip_smoke.load_gate(r, m, c, counts)
    else:
        c = _chaos_artifact()
        CHAOS_FAULTS[fault](c)
        assert chip_smoke.chaos_gate(c)


def test_fleet_phase_passes_on_the_cards_route(card_route, capsys):
    """``fleet_phase`` on the host at micro width, every launch a stub of
    the card's route, its two members on the host: parity within the f32
    gate with both members serving and every serve kernel launched as the
    plan says per synthesize, the planted router (member 0 only) caught
    by the share gate, the autoscale drill's gate passed, and the SLO
    report over the phase's own ledger; placement is not exercised with
    one device."""
    cfg = port_config.ModelConfig(**PRECISION_MODEL)
    out = chip_smoke.fleet_phase("host", cfg=cfg, device="cpu")
    p = out["parity"]
    assert out["members"] == ["cpu", "cpu"]
    assert p["rel_err"] <= chip_smoke.precision_tolerance("f32")
    assert min(p["shares"]) > 0 and sum(p["shares"]) == \
        chip_smoke.SERVICE_PARITY_REQUESTS
    assert p["planted"][1] == 0 and chip_smoke.share_gate(p["planted"])
    assert p["launches"] == p["plan"] and all(p["launches"].values())
    assert chip_smoke.autoscale_gate(out["autoscale"]) is None
    assert out["autoscale"]["autoscale"]["peak_replicas"] == 2
    assert chip_smoke.slo_gate(out["slo"]) is None
    assert "placement" not in out
    text = capsys.readouterr().out
    assert "placement: not exercised" in text and "EXHAUSTED" in text


def test_fleet_phase_fails_on_a_router_that_skips_a_member(card_route,
                                                           monkeypatch):
    """A fleet whose router never picks member 1 fails the phase."""
    from gansformer_tpu_torch.serve import ReplicaSet

    def first_only(self, seed, psi=0.7, label=None, deadline_s=None):
        return self.active_replicas[0].service.submit(seed, psi, label,
                                                      deadline_s)

    monkeypatch.setattr(ReplicaSet, "submit", first_only)
    cfg = port_config.ModelConfig(**PRECISION_MODEL)
    with pytest.raises(SystemExit):
        chip_smoke.fleet_phase("host", cfg=cfg, device="cpu")


def _drill_artifact():
    return {"served": 30, "failed": 4, "expired": 0, "cancelled": 0,
            "accepted": 34, "hung_tickets": 0,
            "non_fulfilled_requests": [{"cause": "FaultInjected"}] * 4,
            "health": {"state": "degraded"},
            "autoscale": {"scale_out_fired": 1, "scale_in_fired": 1,
                          "scale_out_before_breaker": True}}


def _slo_report():
    from gansformer_tpu_torch.obs import DEFAULT_OBJECTIVES

    return {"source": "ledger", "rows": 9, "objectives": [
        {"name": o["name"], "status": "ok"} for o in DEFAULT_OBJECTIVES]}


FLEET_FAULTS = {
    "share_idle_member": ("share", lambda x: x.__setitem__(1, 0.0)),
    "share_no_members": ("share", lambda x: x.clear()),
    "drill_no_scale_out": ("drill", lambda c: c["autoscale"].update(
        scale_out_fired=0)),
    "drill_after_breaker": ("drill", lambda c: c["autoscale"].update(
        scale_out_before_breaker=False)),
    "drill_hung": ("drill", lambda c: c.update(hung_tickets=1, served=29)),
    "drill_unsettled": ("drill", lambda c: c.update(served=29)),
    "drill_untyped": ("drill", lambda c: c["non_fulfilled_requests"].append(
        {"cause": "ValueError"})),
    "drill_unhealthy": ("drill", lambda c: c["health"].update(
        state="unhealthy")),
    "slo_missing": ("slo", lambda r: r["objectives"].pop()),
    "slo_no_data": ("slo", lambda r: r["objectives"][0].update(
        status="no_data")),
    "slo_no_ledger": ("slo", lambda r: r.update(source="prom")),
}


@pytest.mark.parametrize("fault", sorted(FLEET_FAULTS))
def test_fleet_gates_reject_what_they_name(fault):
    gates = {"share": (chip_smoke.share_gate, lambda: [12.0, 12.0]),
             "drill": (chip_smoke.autoscale_gate, _drill_artifact),
             "slo": (chip_smoke.slo_gate, _slo_report)}
    which, plant = FLEET_FAULTS[fault]
    gate, make = gates[which]
    assert gate(make()) is None
    x = make()
    plant(x)
    assert gate(x)


def test_fleet_members_rehearse_on_one_device():
    assert chip_smoke.fleet_members("cpu") == [torch.device("cpu")] * 2


def test_metrics_phase_plan_and_low_rank_fid(rng):
    """The metrics phase's launch plan (one synthesize per fake batch,
    two per PPL batch, each ffhq256-duplex's 20 / 12 / 7 / 5 forward
    launches at batch 32) and its low-rank FID against the FID formula
    with scipy's square root (32 samples in 96 dimensions)."""
    from gansformer_tpu_torch.metrics.fid import fid_from_features

    assert chip_smoke.metrics_sweep_synths(1000, 32) == 32 + 2 * 32
    assert chip_smoke.metrics_sweep_synths(256, 32) == 8 + 2 * 8
    cfg = port_config.get_preset("ffhq256-duplex")
    calls = chip_smoke.main_path_calls(cfg, chip_smoke.METRICS_BATCH)
    assert {k: sum(c["kernel"] == k for c in calls)
            for k in chip_smoke.SERVE_KERNELS} == {
        "modconv": 20, "upfirdn": 12, "grid_to_latent": 7,
        "latent_to_grid": 5}
    real = rng.randn(32, 96)
    fake = rng.randn(32, 96) * 1.3 + 0.2
    assert chip_smoke.frechet_low_rank(real, fake) == pytest.approx(
        fid_from_features(real, fake), rel=1e-6)


# -- the supervision and telemetry phases ------------------------------------

def test_supervise_plan_faults_each_child_after_a_checkpoint():
    """Child 1 is killed as the first checkpoint's write ends (before any
    later tick boundary) and child 2 hangs at its first boundary, both
    after that checkpoint; child 3 resumes from it and runs two ticks to
    the plan's last step, the second sampled with an R1 iteration in it;
    the fault specs parse as the train CLI's."""
    from gansformer_tpu_torch.supervise import faults

    train = port_config.get_train_preset("ffhq256-duplex")
    plan = chip_smoke.supervise_plan(train)
    per_tick = train.batch_size * chip_smoke.SUPERVISE_TICK_ITERS
    assert plan["kimg_per_tick"] * 1000 == per_tick
    kill, hang = faults.parse_specs(",".join(plan["faults"]))
    assert (kill.action, kill.point, kill.cond) == (
        "sigkill", "ckpt_after_write", (("step", float(per_tick)),))
    assert (hang.action, hang.point, hang.cond) == (
        "hang", "tick", (("step", 2.0 * per_tick),))
    # the hang is past child 1's first boundary, the kill at its first
    # checkpoint; child 2's first boundary is the hang's
    assert hang.matches({"tick": 0, "step": 2 * per_tick})
    assert not hang.matches({"tick": 0, "step": per_tick})
    assert plan["resumed_at"] == [0, per_tick, per_tick]
    assert plan["final_step"] == 3 * per_tick == \
        round(plan["total_kimg"] * 1000)
    kinds = plan["sampled_kinds"]
    assert sum(kinds[k] for k in ("d_step", "d_step_r1")) == \
        chip_smoke.SUPERVISE_TICK_ITERS
    assert kinds["d_step_r1"] == 1 and kinds["g_step_pl"] == 2


def _good_supervised_run(plan):
    ledger = [{"kind": "supervisor_start"},
              {"kind": "start", "restart_index": 0, "resume": False},
              {"kind": "exit", "cause": "crash"},
              {"kind": "start", "restart_index": 1, "resume": True},
              {"kind": "exit", "cause": "hang"},
              {"kind": "start", "restart_index": 2, "resume": True},
              {"kind": "exit", "cause": "clean"}, {"kind": "complete"}]
    sup = {"supervise_restarts_total": 2.0, "supervise_crashes_total": 1.0,
           "supervise_hangs_total": 1.0, "supervise_clean_exits_total": 1.0,
           "supervise_availability_ratio": 0.8}
    tele = {"device_samples_total": 1.0, "device_unavailable": 0.0,
            "device_wall_busy_ratio": 0.4, "device_busy_ms": 900.0}
    sample = dict({f"device/phase_ms/{k}": 100.0
                   for k, n in plan["sampled_kinds"].items() if n},
                  **{"device/busy_ms": 900.0})
    return dict(plan=plan, result_rc=0, ledger=ledger, sup=sup,
                last_step=plan["final_step"],
                resumes=plan["resumed_at"][1:], tele=tele,
                samples=[sample], torch_seen=[], maps_read=12)


def _break(run, fault):
    if fault == "rc":
        run["result_rc"] = 1
    elif fault == "causes":
        run["ledger"][4]["cause"] = "crash"
    elif fault == "no_complete":
        run["ledger"].pop()
    elif fault == "prom":
        run["sup"]["supervise_hangs_total"] = 0.0
    elif fault == "availability":
        run["sup"]["supervise_availability_ratio"] = 0.0
    elif fault == "checkpoint":
        run["last_step"] -= 256
    elif fault == "resumes":
        run["resumes"] = [0, 256]
    elif fault == "no_sample":
        run["tele"]["device_samples_total"] = 0.0
    elif fault == "failed_sample":
        run["tele"]["device_sample_failed_total"] = 1.0
    elif fault == "ratio":
        run["tele"]["device_wall_busy_ratio"] = 1.5
    elif fault == "sample_count":
        run["samples"].append(dict(run["samples"][0]))
    elif fault == "phases":
        run["samples"][0].pop("device/phase_ms/d_step_r1")
    elif fault == "phase_sum":
        run["samples"][0]["device/busy_ms"] = 10.0
    elif fault == "torch":
        run["torch_seen"] = ["/x/libtorch_cpu.so"]
    elif fault == "maps":
        run["maps_read"] = 0
    return run


@pytest.mark.parametrize("fault", [
    None, "rc", "causes", "no_complete", "prom", "availability",
    "checkpoint", "resumes", "no_sample", "failed_sample", "ratio",
    "sample_count", "phases", "phase_sum", "torch", "maps"])
def test_supervise_gate_rejects_what_it_names(fault):
    plan = chip_smoke.supervise_plan(
        port_config.get_train_preset("ffhq256-duplex"))
    run = _break(_good_supervised_run(plan), fault)
    why = chip_smoke.supervise_gate(**run)
    assert (why is None) == (fault is None), why


def test_sampled_ticks_start_again_in_each_process():
    recs = [{"Progress/tick": t, "telemetry": {"counters": {
        "device/samples_total": n}}}
        for t, n in ((0, 0.0), (1, 1.0), (0, 0.0), (1, 1.0), (2, 1.0),
                     (0, 0.0), (1, 0.0))]
    assert [s for _, s in chip_smoke.sampled_ticks(recs)] == [
        False, True, False, True, False, False, False]


def test_trace_kernel_counts_map_each_launch_to_its_counter():
    names = ["void fwd_wgmma_kernel<128>(CUtensorMap_st, float const*)",
             "void fwd_reduce_kernel(float const*, float*, int)",
             "void (anonymous namespace)::ds_reduce_kernel(float const*)",
             "void dx_prescale_kernel(float const*)",
             "void dw_fma_kernel<__nv_bfloat16>(x)",
             "void ufd_tile_kernel<__nv_bfloat16, 2, 1>(x)",
             "void upfirdn_kernel<float, 1, 1>(x)",
             "void g2l_mma_kernel<32>(x)", "void l2g_partial_kernel<float, 16>(x)",
             "void l2g_combine_kernel<float>(x)",
             "void g2l_bwd_kernel<float, 16>(x)",
             "void l2g_bwd_mma_kernel<16>(x)",
             "void at::native::vectorized_elementwise_kernel<4>(int)",
             "Memcpy HtoD (Pinned -> Device)"]
    counts = chip_smoke.trace_kernel_counts(names)
    assert counts == {"modconv": 1, "modconv_dx": 1, "modconv_dw": 1,
                      "upfirdn+upfirdn_adjoint": 2, "grid_to_latent": 1,
                      "latent_to_grid": 1, "grid_to_latent_bwd": 1,
                      "latent_to_grid_bwd": 1}
    launches = {"modconv": 1, "upfirdn": 1, "grid_to_latent": 1,
                "latent_to_grid": 1, "modconv_dx": 1, "modconv_dw": 1,
                "upfirdn_adjoint": 1, "grid_to_latent_bwd": 1,
                "latent_to_grid_bwd": 1}
    assert chip_smoke.counter_totals(launches) == counts
    # every kernel function of the sources is one the table counts or one
    # that runs beside a counted one in the same launch (a dx launch ends
    # with the ds_reduce the table counts)
    helpers = {"fwd_reduce_kernel", "dx_prescale_kernel", "dx_wgmma_kernel",
               "dx_smallk_kernel", "dx_fma_kernel", "dw_reduce_kernel",
               "l2g_combine_kernel", "l2g_bwd_reduce_kernel",
               "g2l_bwd_reduce_kernel"}
    import re

    known = {f for fns in chip_smoke.PROFILE_KERNELS.values() for f in fns}
    csrc = os.path.join(ROOT, "gansformer_tpu_torch", "csrc")
    defined = set()
    for name in os.listdir(csrc):
        if name.endswith(".cu"):
            text = open(os.path.join(csrc, name)).read()
            defined |= set(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                r"(\w+)", text))
    assert defined == known | helpers


@pytest.mark.parametrize("fault", [None, "count", "missing", "busy",
                                   "programs", "unattributed"])
def test_profile_window_gate_rejects_what_it_names(fault):
    counted = dict.fromkeys(chip_smoke.PROFILE_KERNELS, 3)
    parsed = dict(counted)
    busy, window = 50.0, 300.0
    progs, unattributed = {"d_step": 0.02, "g_step": 0.03}, 0
    if fault == "count":
        parsed["modconv_dw"] += 1
    elif fault == "missing":
        counted["latent_to_grid_bwd"] = parsed["latent_to_grid_bwd"] = 0
    elif fault == "busy":
        busy = 301.0
    elif fault == "programs":
        progs.pop("g_step")
    elif fault == "unattributed":
        unattributed = 2
    why = chip_smoke.profile_window_gate(parsed, counted, busy, window, progs,
                                         ("d_step", "g_step"), unattributed)
    assert (why is None) == (fault is None), why
