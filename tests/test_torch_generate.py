"""The port's generate CLI on a run (``--run-dir``) against the JAX
package's generate CLI, on the CPU, on the same checkpoint with the same
latents.

Checkpoints: a port run of the micro duplex configuration (the port's
loop, one iteration), and a JAX checkpoint (``checkpoint.save`` of the
JAX package, perturbed weights), each read by both CLIs; then the port's
``pack_run`` archive of the port run, and the JAX package's archive of
the JAX run, read by the port.  The conv noise strengths of the saved
generators are zero (the port run's set to zero after it trained):
``jax.random`` noise cannot be reproduced, so neither side's noise may
reach the images.  The port's latents are injected as the JAX CLI's
(``jax.random.normal(fold_in(PRNGKey(seed), tag))`` for each of its
tags) through ``generate.draw_z``.

Held: every mode's images (singles, ``--grid``, ``--interpolate``,
``--style-mix``) and the overlay's images and attention maps
(``--save-attention``), as the floats each CLI hands to its PNG writer,
at ``MODEL`` (1e-4 of the scale) as the step tests hold images; the PNGs
decoded: the JAX CLI writes them with Pillow and the port with zlib, so
they are not the same bytes, and their pixels agree within one level
(the floats' agreement, rounded to 8 bits).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from gansformer_tpu.core.config import ExperimentConfig as JaxExperiment
from gansformer_tpu.train import checkpoint as jck
from gansformer_tpu_torch.cli import generate as port_generate
from gansformer_tpu_torch.cli import pack_run as port_pack_run
from gansformer_tpu_torch.core import config as port_config
from gansformer_tpu_torch.train import checkpoint as ckpt
from gansformer_tpu_torch.train import create_train_state, loop
from gansformer_tpu_torch.utils import image as port_image
from gansformer_tpu_torch.utils import runarchive
from tests.test_torch_checkpoint import jax_state_from_flat, perturbed_flat
from tests.test_torch_train import MODEL, _close
from tests.test_train import micro_cfg
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

SEED = 5
ARGS = ["--images-num", "5", "--batch-size", "4", "--seed", str(SEED),
        "--truncation-psi", "0.6"]
MODES = ["--grid", "--interpolate", "2", "3", "--style-mix", "2", "3",
         "--save-attention"]


def _exp():
    cfg = micro_cfg(attention="duplex", batch=4)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, total_kimg=0.004, kimg_per_tick=0.004, snapshot_ticks=1,
        image_snapshot_ticks=0))


def _zero_noise(flat):
    return {k: (np.zeros_like(v) if "noise_strength" in k else v)
            for k, v in flat.items()}


def _port_run(root, jexp):
    """One iteration of the port's loop, then the noise strengths of G
    and the EMA set to zero in a checkpoint one step on."""
    run = os.path.join(root, "port_run")
    exp = port_config.ExperimentConfig.from_json(jexp.to_json())
    st = loop.train(exp, run, device="cpu")
    with torch.no_grad():
        for mod in (st.generator, st.ema):
            for name, p in mod.named_parameters():
                if "noise_strength" in name:
                    p.zero_()
    st.step += exp.train.batch_size
    ckpt.save(os.path.join(run, "checkpoints"), st, block=True)
    return run


def _jax_run(root, jexp):
    run = os.path.join(root, "jax_run")
    flat = _zero_noise(perturbed_flat(jexp))
    jck.save(os.path.join(run, "checkpoints"), jax_state_from_flat(
        jexp, flat), jexp, block=True)
    with open(os.path.join(run, "config.json"), "w") as f:
        f.write(jexp.to_json())
    return run


def _jax_z(seed, tag, n, cfg):
    return np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(seed), tag),
        (n, cfg.num_ws, cfg.latent_dim)), np.float32)


class _Recorder:
    """The floats each CLI hands to its PNG writers, by file name."""

    def __init__(self):
        self.images = {}

    def grid(self, orig):
        def save(images, path, *a, **k):
            self.images[os.path.basename(path)] = np.asarray(
                images, np.float64)
            return orig(images, path, *a, **k)
        return save

    def attention(self, orig):
        def save(images, probs, path, *a, **k):
            self.images["attn.png:images"] = np.asarray(images, np.float64)
            self.images["attn.png:probs"] = np.asarray(probs, np.float64)
            return orig(images, probs, path, *a, **k)
        return save


def _run_jax(run, out, extra):
    from gansformer_tpu.cli.generate import main
    from gansformer_tpu.utils import image as jax_image

    rec = _Recorder()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_image, "save_image_grid",
                   rec.grid(jax_image.save_image_grid))
        mp.setattr(jax_image, "save_attention_grid",
                   rec.attention(jax_image.save_attention_grid))
        main(["--run-dir", run, "--out", out, "--no-warm-start"] + ARGS
             + extra)
    return rec.images


def _run_port(run, out, extra):
    rec = _Recorder()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_generate, "draw_z", _jax_z)
        mp.setattr(port_generate, "save_image_grid",
                   rec.grid(port_image.save_image_grid))
        mp.setattr(port_generate, "save_attention_grid",
                   rec.attention(port_image.save_attention_grid))
        assert port_generate.main(["--run-dir", run, "--out", out,
                                   "--device", "cpu"] + ARGS + extra) == 0
    return rec.images


def _pngs(d):
    from PIL import Image

    return {f: np.asarray(Image.open(os.path.join(d, f)))
            for f in sorted(os.listdir(d)) if f.endswith(".png")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("generate"))
    jexp = JaxExperiment.from_json(_exp().to_json())
    out = dict(root=root, port=_port_run(root, jexp),
               jax=_jax_run(root, jexp))
    for src in ("port", "jax"):
        for mode, extra in (("modes", MODES), ("singles", [])):
            d = os.path.join(root, f"{src}-{mode}")
            out[(src, mode, "jax")] = (_run_jax(out[src], d + "-jax", extra),
                                       _pngs(d + "-jax"))
            out[(src, mode, "port")] = (_run_port(out[src], d + "-port",
                                                  extra),
                                        _pngs(d + "-port"))
    return out


@pytest.mark.parametrize("src", ["port", "jax"])
@pytest.mark.parametrize("mode", ["modes", "singles"])
def test_generate_matches_the_jax_cli(runs, src, mode):
    """The same files, their floats at MODEL, their pixels within one
    level; the images finite and not constant."""
    jf, jpng = runs[(src, mode, "jax")]
    pf, ppng = runs[(src, mode, "port")]
    assert sorted(ppng) == sorted(jpng)
    want = ({"grid.png", "interp.png", "mix.png", "attn.png"}
            if mode == "modes" else {f"img{i:04d}.png" for i in range(5)})
    assert set(ppng) == want
    assert set(pf) == set(jf)
    for k, ref in jf.items():
        _close(pf[k], ref, k, tol=MODEL)
    for f, ref in jpng.items():
        got = ppng[f]
        assert got.shape == ref.shape, f
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1, f
        assert got.std() > 0, f
    if mode == "modes":
        # 2 x 3 strips, 2 x 3 mixing cells, a 2 x 3 grid of 5 at 16^2
        assert ppng["interp.png"].shape == (2 * 16, 3 * 16, 3)
        assert ppng["mix.png"].shape == (2 * 16, 3 * 16, 3)
        assert ppng["attn.png"].shape == (2 * 16, 2 * 16, 3)
        probs = pf["attn.png:probs"]
        np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("src", ["port", "jax"])
def test_generate_reads_packed_archives(runs, src, tmp_path):
    """A run packed by either package's ``pack_run`` gives the port the
    images of the run dir itself, bit for bit."""
    if src == "port":
        archive = str(tmp_path / "port.tar.gz")
        assert port_pack_run.main(["--run-dir", runs["port"], "--out",
                                   archive]) == 0
    else:
        from gansformer_tpu.utils.runarchive import pack_run as jax_pack

        archive = jax_pack(runs["jax"], out_path=str(tmp_path / "jax.tgz"))
    d = str(tmp_path / "out")
    got = _run_port(archive, d, MODES)
    ref = runs[(src, "modes", "port")][0]
    assert set(got) == set(ref)
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k
    assert runarchive.resolve_run_dir(archive) == runarchive.resolve_run_dir(
        archive)                            # the extraction is cached


def test_generate_refuses_urls_and_later_flags(tmp_path):
    with pytest.raises(ValueError, match="needs the network"):
        runarchive.resolve_run_dir("https://example.invalid/run.tar.gz")
    with pytest.raises(FileNotFoundError, match="neither a run dir"):
        runarchive.resolve_run_dir(str(tmp_path / "missing.tar.gz"))
    for flag in ("--attention-backend", "--conv-backend", "--no-warm-start"):
        with pytest.raises(SystemExit, match="not in the PyTorch port"):
            port_generate.main(["--run-dir", str(tmp_path), flag, "x"])


def test_save_attention_refuses_the_card_and_attention_free_models(
        tmp_path, monkeypatch):
    """The maps come from the plain path: the CLI takes
    ``--save-attention`` only with ``--device cpu``, asking a block for
    them on a CUDA tensor raises (checked by a stand-in for ``is_cuda``),
    and a model without attention has none."""
    from gansformer_tpu_torch.models.attention import BipartiteAttention

    from gansformer_tpu_torch.models.generator import init_weights

    block = init_weights(BipartiteAttention(8, 8, 4, duplex=True), 0)
    block.probs_sink = []
    x, y = torch.randn(2, 4, 4, 8), torch.randn(2, 3, 8)
    block(x, y)
    (probs,) = block.probs_sink
    assert probs.shape == (2, 1, 4, 4, 3)
    torch.testing.assert_close(probs.sum(-1), torch.ones(2, 1, 4, 4))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    with pytest.raises(RuntimeError, match="plain path on the host"):
        block(x, y)
    monkeypatch.undo()
    exp = dataclasses.replace(_exp(), model=dataclasses.replace(
        _exp().model, attention="none"))
    pexp = port_config.ExperimentConfig.from_json(exp.to_json())
    st = create_train_state(pexp.model, pexp.train, 0, "cpu")
    run = str(tmp_path / "run")
    ckpt.save(os.path.join(run, "checkpoints"), st, block=True)
    with open(os.path.join(run, "config.json"), "w") as f:
        f.write(pexp.to_json())
    for device in ([], ["--device", "cuda"]):
        with pytest.raises(SystemExit, match="needs --device cpu"):
            port_generate.main(["--run-dir", run, *device,
                                "--save-attention"])
    with pytest.raises(SystemExit, match="needs an attention model"):
        port_generate.main(["--run-dir", run, "--device", "cpu",
                            "--save-attention", "--images-num", "1",
                            "--batch-size", "1"])
