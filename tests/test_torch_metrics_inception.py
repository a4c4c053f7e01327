"""The port's Inception extractor against the JAX package's on the CPU.

Both load one flat npz in JAX's layout (random weights drawn here with
numpy into the shapes of ``jax.eval_shape`` of JAX's ``InceptionV3``, so
no Flax init or probe runs), so both take the calibrated path and compute
the same network: features and logits are held at 1e-4 of their largest
magnitude (the resize's tolerance in JAX's own golden test; the two agree
to ~1e-6 here), at inputs of 64², 256², 299² and 1024².  A planted fault,
the average pool counting its padding (torch's default), must fail that
gate.  Then the port's own uncalibrated network: its draw follows Flax's
``lecun_normal`` ×√2, it is deterministic per seed, and it discriminates
distributions as JAX's regression test asks of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gansformer_tpu.metrics import inception as jinc
from gansformer_tpu_torch.metrics import inception as pinc
from gansformer_tpu_torch.metrics.fid import (compute_activation_stats,
                                              frechet_distance)
from tests.test_torch_metrics import lowrank_sqrtm
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

FEATURE_TOL = 1e-4        # of max |feature| (and of max |logit|)


def write_inception_npz(path, seed=0):
    """Random weights in JAX's flat layout: He-scaled normal kernels,
    BN statistics near identity, small biases."""
    shapes = jax.eval_shape(lambda: jinc.InceptionV3().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 299, 299, 3))))["params"]
    rs = np.random.RandomState(seed)
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
                continue
            if k == "kernel":
                a = rs.randn(*v.shape) * np.sqrt(2.0 / np.prod(v.shape[:-1]))
            elif k == "var":
                a = 1.0 + 0.1 * rs.rand(*v.shape)
            else:
                a = 0.05 * rs.randn(*v.shape)
            flat[prefix + k] = a.astype(np.float32)

    walk(shapes, "")
    np.savez(path, **flat)
    return str(path)


@pytest.fixture(scope="module")
def extractors(tmp_path_factory):
    path = write_inception_npz(tmp_path_factory.mktemp("inc") / "w.npz")
    return (jinc.FeatureExtractor(jinc.load_params_npz(path)),
            pinc.make_extractor(path, device="cpu"))


def _hold(got, want, what):
    for g, w, name in zip(got, want, ("features", "logits")):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, (what, name)
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= FEATURE_TOL * scale, (what, name, err, scale)


@pytest.mark.parametrize("res,batch", [(64, 2), (256, 2), (299, 2),
                                       (1024, 1)])
def test_features_match_jax(extractors, res, batch):
    jex, pex = extractors
    assert pex.calibrated and pex.net.fc.weight.shape == (1008, 2048)
    x = (np.random.RandomState(res).rand(batch, res, res, 3) * 2.2 - 1.1
         ).astype(np.float32)
    _hold(pex(x), jex(jnp.asarray(x)), f"{res}^2")


def test_planted_pool_fault_is_caught(extractors, monkeypatch):
    """The average pool with its padding in the divisor shifts the border
    features past the gate."""
    jex, pex = extractors
    x = (np.random.RandomState(1).rand(2, 64, 64, 3) * 2 - 1
         ).astype(np.float32)
    want = jex(jnp.asarray(x))
    monkeypatch.setattr(pinc.TFAvgPool, "count_include_pad", True)
    with pytest.raises(AssertionError):
        _hold(pex(x), want, "planted")


def test_tf32_flags_are_restored(extractors):
    """The forward turns TF32 off for its convolutions and matmuls and
    gives the caller's flags back."""
    _, pex = extractors
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = (cudnn.allow_tf32, matmul.allow_tf32)
    seen = []
    hook = pex.net.Conv2d_1a.register_forward_hook(
        lambda *a: seen.append((cudnn.allow_tf32, matmul.allow_tf32)))
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        pex(np.zeros((1, 32, 32, 3), np.float32))
        assert seen == [(False, False)]
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        hook.remove()
        cudnn.allow_tf32, matmul.allow_tf32 = prev


def test_uncalibrated_draw_follows_flax():
    """lecun_normal ×√2: a normal cut at ±2 std, std sqrt(2/fan_in) /
    .8796 before the cut; zero biases, BN at identity; the same draw
    for the same seed, another for another seed."""
    sd = pinc.uncalibrated_params(3)
    w = sd["Mixed_7c.b3x3dbl_2.conv.weight"]          # 384 x 448 x 3 x 3
    fan_in = 448 * 9
    std = np.sqrt(2.0 / fan_in) / pinc.LECUN_TRUNC
    assert float(w.abs().max()) <= 2 * std * (1 + 1e-6)
    # the std of a unit normal truncated at ±2 is .8796: the draw's std
    # lands on sqrt(2 / fan_in)
    assert float(w.std()) == pytest.approx(np.sqrt(2.0 / fan_in), rel=0.01)
    assert sd["fc.weight"].shape == (1008, 2048)
    assert float(sd["fc.bias"].abs().max()) == 0.0
    assert float(sd["Conv2d_1a.var"].min()) == 1.0
    assert float(sd["Conv2d_1a.mean"].abs().max()) == 0.0
    again = pinc.uncalibrated_params(3)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    other = pinc.uncalibrated_params(4)
    assert not torch.equal(sd["fc.weight"], other["fc.weight"])


def test_uncalibrated_extractor_discriminates(monkeypatch):
    """The port's counterpart of ``tests/test_metrics.py``'s
    ``test_uncalibrated_extractor_discriminates``: with the He rescale
    and the probe standardization, features have O(1) per-dim spread and
    the Fréchet distance between clearly different distributions dwarfs
    the same-distribution floor (16 samples: the low-rank square root
    stands in for scipy's)."""
    import scipy.linalg

    monkeypatch.setattr(scipy.linalg, "sqrtm", lowrank_sqrtm)
    ex = pinc.make_extractor("/nonexistent.npz", device="cpu")
    assert not ex.calibrated and ex.scales is not None
    rs = np.random.RandomState(0)
    noise_a = (rs.rand(16, 64, 64, 3) * 2 - 1).astype(np.float32)
    noise_b = (rs.rand(16, 64, 64, 3) * 2 - 1).astype(np.float32)
    yy, xx = np.mgrid[0:64, 0:64] / 64.0
    grads = (np.stack([np.stack([yy * s, xx, yy * xx], -1)
                       for s in np.linspace(0.2, 1.0, 16)]) * 2 - 1
             ).astype(np.float32)
    fa, fb, fc = (ex(x)[0].numpy() for x in (noise_a, noise_b, grads))
    assert fa.std(0).mean() > 0.01, "features collapsed"
    fid_same = frechet_distance(*compute_activation_stats(fa),
                                *compute_activation_stats(fb))
    fid_diff = frechet_distance(*compute_activation_stats(fa),
                                *compute_activation_stats(fc))
    assert fid_diff > 20 * fid_same, (fid_same, fid_diff)
