"""What of ``chip_smoke.py`` can be checked on the CPU: its launch plan,
that its library yardsticks compute the kernels' functions, and that it
fails without a card (here) and without the package beside it."""

import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from gansformer_tpu_torch.core import config as port_config
from gansformer_tpu_torch.ops import modulated_conv as port_mc
from gansformer_tpu_torch.ops.attention import attention_plain
from gansformer_tpu_torch.ops.upfirdn2d import setup_filter, upfirdn2d_plain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_launch_plan_of_ffhq256_duplex():
    calls = chip_smoke.main_path_calls(
        port_config.get_preset("ffhq256-duplex"), 8)
    counts = {k: sum(c["kernel"] == k for c in calls)
              for k in chip_smoke.REPLACES}
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
    assert case["fault"] is None


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
    assert float((case["fault"]() - ref).abs().max()) > tol
    case = chip_smoke.build_case(
        call, torch.float32, torch.Generator().manual_seed(0), dev="cpu",
        chunk=64)
    assert case["fault"] is None


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
