"""Port-only behaviour of the PyTorch port on the CPU: the injected-noise
formula, row independence under bucket padding, device selection, launch
counters on CPU tensors, the import boundary, and the generate CLI."""

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from gansformer_tpu_torch import ops
from gansformer_tpu_torch.core import config as port_config
from gansformer_tpu_torch.core.device import resolve_device
from gansformer_tpu_torch.models import init_weights
from gansformer_tpu_torch.models.layers import ModulatedConv
from gansformer_tpu_torch.serve import ServePrograms, init_generator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = port_config.ModelConfig(
    resolution=16, components=3, latent_dim=16, w_dim=16, mapping_dim=16,
    mapping_layers=2, fmap_base=256, fmap_max=32, attention="duplex",
    attn_start_res=4, attn_max_res=8, style_mode="attention")


@pytest.fixture(scope="module")
def progs():
    bundle = init_generator(TINY, seed=3, device="cpu")
    with torch.no_grad():
        for name, p in bundle.generator.named_parameters():
            if name.endswith("noise_strength") or name.endswith("_gate"):
                p.fill_(0.3)
    return ServePrograms(bundle)


def test_injected_noise_formula(rng):
    layer = init_weights(ModulatedConv(6, 4, 5), seed=0)
    with torch.no_grad():
        layer.noise_strength.fill_(0.5)
        layer.b.copy_(torch.linspace(-1, 1, 5))
        x = torch.from_numpy(rng.randn(2, 5, 5, 4).astype(np.float32))
        w_style = torch.from_numpy(rng.randn(2, 6).astype(np.float32))
        noise = torch.from_numpy(rng.randn(2, 5, 5, 1).astype(np.float32))
        styles = layer.affine(w_style)
        weight = layer.w / np.sqrt(4 * 9)
        core = ops.modulated_conv2d(x, weight, styles)
        want = ops.fused_bias_act(core + noise * 0.5, layer.b, act="lrelu")
        np.testing.assert_allclose(layer(x, w_style, noise).numpy(),
                                   want.numpy(), atol=1e-6, rtol=1e-6)
        # without noise the bias/act epilogue is fused into the op
        fused = ops.fused_bias_act(core, layer.b, act="lrelu")
        np.testing.assert_allclose(layer(x, w_style).numpy(), fused.numpy(),
                                   atol=1e-6, rtol=1e-6)


def test_rows_do_not_depend_on_bucket(progs):
    """Row 0 of bucket 1 equals row 0 of bucket 4 (same seed, psi, tag):
    z and noise are per-row streams.  The tolerance (1e-6) only absorbs
    CPU matmul blocking that may differ with the batch size."""
    ws1 = progs.map_seeds([5])
    ws4 = progs.map_seeds([5, 6, 7, 8])
    np.testing.assert_allclose(ws1[0].numpy(), ws4[0].numpy(), atol=1e-6,
                               rtol=1e-6)
    img1 = progs.synthesize(ws1, [0.7], seed=9, tags=[5])
    img4 = progs.synthesize(ws4, [0.7, 1.0, 0.5, 0.3], seed=9,
                            tags=[5, 6, 7, 8])
    np.testing.assert_allclose(img1[0].numpy(), img4[0].numpy(), atol=1e-5,
                               rtol=1e-5)
    other = progs.synthesize(ws1, [0.7], seed=9, tags=[6])
    assert float((other - img1).abs().max()) > 1e-3   # noise is live
    with pytest.raises(ValueError, match="full bucket"):
        progs.map_seeds([1, 2, 3])


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_generator(TINY, seed=0)
    assert resolve_device("cpu").type == "cpu"


def test_cpu_tensors_never_launch_a_kernel(progs):
    ops.reset_launch_counts()
    ws = progs.map_seeds([1, 2])
    img = progs.synthesize(ws, [0.7, 0.7], seed=1, tags=[1, 2])
    assert torch.isfinite(img).all()
    assert ops.launch_counts() == {"modconv": 0, "upfirdn": 0,
                                   "grid_to_latent": 0, "latent_to_grid": 0,
                                   "modconv_dx": 0, "modconv_dw": 0,
                                   "upfirdn_adjoint": 0,
                                   "grid_to_latent_bwd": 0,
                                   "latent_to_grid_bwd": 0}
    assert ops.lse_launch_counts() == {"grid_to_latent": 0,
                                       "latent_to_grid": 0}


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke, imported in a fresh
    interpreter, leave jax, flax and the JAX package out of sys.modules."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import gansformer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'gansformer_tpu')]\n"
        "print('LOADED', len([m for m in sys.modules "
        "if m.startswith('gansformer_tpu_torch')]))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split("LOADED")[1]) >= 15


def _png_size(data: bytes):
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    (length,) = struct.unpack(">I", data[8:12])
    assert data[12:16] == b"IHDR"
    w, h, depth, color = struct.unpack(">IIBB", data[16:26])
    return w, h, depth, color


def test_generate_cli_writes_png_on_cpu(tmp_path):
    from gansformer_tpu_torch.cli import generate

    cfg_path = tmp_path / "config.json"
    import dataclasses
    import json

    cfg_path.write_text(json.dumps({"model": dataclasses.asdict(TINY)}))
    out = tmp_path / "grid.png"
    assert generate.main(["--config", str(cfg_path), "--seeds", "0-2",
                          "--device", "cpu", "--out", str(out)]) == 0
    data = out.read_bytes()
    w, h, depth, color = _png_size(data)
    assert (w, h, depth, color) == (16, 48, 8, 2)     # 1 x 3 grid, RGB
    idat = data.index(b"IDAT")
    (n,) = struct.unpack(">I", data[idat - 4:idat])
    raw = zlib.decompress(data[idat + 4:idat + 4 + n])
    assert len(raw) == h * (1 + w * 3)
    assert generate.parse_seeds("0-3,9") == [0, 1, 2, 3, 9]
