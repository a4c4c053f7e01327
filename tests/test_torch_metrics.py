"""The port's metric statistics against the JAX package's on the CPU: FID
(scipy and Newton–Schulz), IS, improved precision & recall, PPL's tail
filter and its draw order, the extractor's resize against the TF golden
fixture and ``jax.image.resize`` at 1024², the uncalibrated regime's
probe-scale formula against JAX's own, the real-statistics cache keys,
the metric names, and the new modules importing no JAX.

Tolerances: the statistics run the same float64 numpy on both sides, so
FID and IS agree to 1e-8 relative and the P&R fractions exactly;
Newton–Schulz runs in fp32 on both sides (JAX states ~1e-4 relative);
the resize is held at JAX's own golden tolerance (1e-4 absolute).
"""

import importlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gansformer_tpu.metrics import fid as jfid
from gansformer_tpu.metrics import inception as jinc
from gansformer_tpu.metrics import metric_base as jmb
from gansformer_tpu.metrics import ppl as jppl
from gansformer_tpu_torch.metrics import fid as pfid
from gansformer_tpu_torch.metrics import inception as pinc
from gansformer_tpu_torch.metrics import metric_base as pmb
from gansformer_tpu_torch.metrics import ppl as pppl
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

# the packages export functions of these modules' names
jis = importlib.import_module("gansformer_tpu.metrics.inception_score")
jpr = importlib.import_module("gansformer_tpu.metrics.precision_recall")
pis = importlib.import_module("gansformer_tpu_torch.metrics.inception_score")
ppr = importlib.import_module("gansformer_tpu_torch.metrics.precision_recall")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAT_RTOL = 1e-8


def _stats(rs, n, d, shift=0.0):
    feats = rs.randn(n, d) @ rs.randn(d, d) * 0.3 + shift
    return pfid.compute_activation_stats(feats)


def test_frechet_distance_matches_jax(rng):
    mu1, s1 = _stats(rng, 400, 24)
    mu2, s2 = _stats(rng, 400, 24, shift=0.5)
    got = pfid.frechet_distance(mu1, s1, mu2, s2)
    want = jfid.frechet_distance(mu1, s1, mu2, s2)
    assert got == pytest.approx(want, rel=STAT_RTOL)
    a = rng.randn(300, 16)
    b = rng.randn(300, 16) + 1.0
    assert pfid.fid_from_features(a, b) == pytest.approx(
        jfid.fid_from_features(a, b), rel=STAT_RTOL)
    ja, jb = jfid.compute_activation_stats(a)
    pa, pb = pfid.compute_activation_stats(a)
    np.testing.assert_array_equal(pa, ja)
    np.testing.assert_array_equal(pb, jb)


def test_newton_schulz_matches_jax(rng):
    """The torch square root against JAX's (both fp32, same iteration),
    and FID through it against scipy's, at JAX's stated ~1e-4."""
    a = rng.randn(32, 32)
    psd = (a @ a.T + 32 * np.eye(32)).astype(np.float32)
    got = pfid.sqrtm_newton_schulz(torch.from_numpy(psd)).numpy()
    want = np.asarray(jfid.sqrtm_newton_schulz(jnp.asarray(psd)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got @ got, psd, rtol=2e-3, atol=2e-3)
    mu1, s1 = _stats(rng, 400, 24)
    mu2, s2 = _stats(rng, 400, 24, shift=0.5)
    ns = pfid.frechet_distance(mu1, s1, mu2, s2, method="newton_schulz")
    assert ns == pytest.approx(
        jfid.frechet_distance(mu1, s1, mu2, s2, method="newton_schulz"),
        rel=1e-4)
    assert ns == pytest.approx(
        pfid.frechet_distance(mu1, s1, mu2, s2, method="scipy"), rel=1e-3)


def lowrank_sqrtm(m, disp=None):
    """A stand-in for ``scipy.linalg.sqrtm`` where only the trace is read
    (``frechet_distance``) and ``m`` = Σ₁Σ₂ has low rank (covariances of
    fewer samples than dimensions): the nonzero eigenvalues of ``m`` are
    those of ``QᵀmQ`` for an orthonormal basis Q of its range, so the
    returned ``diag(√λ)`` has the trace of √m at a fraction of scipy's
    cost (20 s at 2048² on one thread).  Tests that sweep 2048-dim
    features patch it into both packages alike."""
    rank_cap = min(m.shape[0], 64)
    omega = np.random.RandomState(0).randn(m.shape[0], rank_cap)
    q, _ = np.linalg.qr(m @ omega)
    lam = np.linalg.eigvals(q.T @ m @ q)
    root = np.diag(np.sqrt(lam.astype(complex)))
    return root if disp is None else (root, 0.0)   # JAX passes disp=False


def test_lowrank_sqrtm_trace_matches_scipy(rng):
    """The stand-in's trace against scipy's on rank-deficient Σ₁Σ₂ of
    15 samples in 128 dimensions, through ``frechet_distance``."""
    import scipy.linalg

    mu1, s1 = pfid.compute_activation_stats(rng.randn(16, 128))
    mu2, s2 = pfid.compute_activation_stats(rng.randn(16, 128) * 1.5 + .2)
    want = np.trace(np.real(scipy.linalg.sqrtm(s1 @ s2)))
    got = np.trace(np.real(lowrank_sqrtm(s1 @ s2)))
    assert got == pytest.approx(want, rel=1e-6)


def test_inception_score_matches_jax(rng):
    logits = rng.randn(103, 17) * 3
    for splits in (1, 4, 10):
        got = pis.inception_score(logits, splits)
        want = jis.inception_score(logits, splits)
        np.testing.assert_allclose(got, want, rtol=STAT_RTOL)


@pytest.mark.parametrize("case", ["random", "identical", "disjoint",
                                  "mode_drop"])
def test_precision_recall_matches_jax(rng, case):
    """Equal fractions on the same fp32 features, through several row
    blocks (self-matches excluded by index in every block)."""
    a = rng.randn(256, 16).astype(np.float32)
    reals, fakes = {
        "random": (a, rng.randn(192, 16).astype(np.float32) * 1.2 + 0.3),
        "identical": (a, a.copy()),
        "disjoint": (a, a + 1000.0),
        "mode_drop": (np.concatenate([rng.randn(200, 8),
                                      rng.randn(200, 8) + 50.0]
                                     ).astype(np.float32),
                      (rng.randn(400, 8) * 0.5).astype(np.float32)),
    }[case]
    got = ppr.precision_recall(reals, fakes, k=3, block=64)
    want = jpr.precision_recall(reals, fakes, k=3, block=64)
    assert got == want
    if case == "identical":
        assert got == (1.0, 1.0)
    if case == "disjoint":
        assert got == (0.0, 0.0)


def test_ppl_filter_and_draw_order_match_jax(rng):
    """The tail filter, and ``sample_ppl_distances``: JAX's draw order
    (one RandomState, rand(batch) then randint(2**31) per full batch),
    the surplus trimmed, the same distances from the same features."""
    d = np.abs(rng.randn(1000)) * 10
    d[0] = 1e9
    assert pppl.ppl_from_distances(d) == pytest.approx(
        jppl.ppl_from_distances(d), rel=STAT_RTOL)

    def recorder(calls):
        def pair_fn(n, t, seed, epsilon):
            calls.append((n, np.asarray(t).tolist(), int(seed), epsilon))
            r = np.random.RandomState(seed)
            a = r.randn(n, 6).astype(np.float32)
            return a, a + r.randn(n, 6).astype(np.float32) * epsilon
        return pair_fn

    def extractor(x):
        return x, None

    def torch_extractor(x):
        return torch.from_numpy(x), None

    cj, cp = [], []
    want = jppl.sample_ppl_distances(recorder(cj), extractor, 10, 4,
                                     epsilon=1e-2, seed=3)
    got = pppl.sample_ppl_distances(recorder(cp), torch_extractor, 10, 4,
                                    epsilon=1e-2, seed=3)
    assert cp == cj and len(cj) == 3
    assert got.shape == (10,)
    np.testing.assert_allclose(got, want, rtol=STAT_RTOL)


def test_preprocess_matches_tf_golden_and_jax():
    """The port's resize against the TF golden fixture (the inputs of
    ``tests/test_metrics.py``'s golden test, RandomState(42)), and
    against ``jax.image.resize`` where it downsamples (1024²) and on a
    single channel."""
    golden = np.load(os.path.join(ROOT, "tests", "data",
                                  "resize_golden_tf.npz"))
    rs = np.random.RandomState(42)
    for res in (64, 256):
        x = (rs.rand(2, res, res, 3).astype(np.float32) * 2 - 1)
        got = pinc.preprocess(torch.from_numpy(x)).numpy()
        assert got.shape == (2, 299, 299, 3)
        np.testing.assert_allclose(got[:, ::13, ::13, :],
                                   golden[f"sample_{res}"], atol=1e-4,
                                   rtol=0)
        assert abs(got.mean() - golden[f"mean_{res}"]) < 1e-5
        assert abs(got.std() - golden[f"std_{res}"]) < 1e-5
    for shape in ((1, 1024, 1024, 3), (2, 32, 32, 1)):
        x = (rs.rand(*shape).astype(np.float32) * 2.4 - 1.2)
        got = pinc.preprocess(torch.from_numpy(x)).numpy()
        want = np.asarray(jinc.preprocess(jnp.asarray(x)))
        assert got.shape == want.shape == shape[:1] + (299, 299, 3)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_probe_scale_matches_jax(rng, monkeypatch):
    """``probe_scale`` against JAX's ``scale()`` inside ``_probe_scales``,
    fed the same injected features and logits (an even count of
    dimensions: the median of the middle two; one dead dimension: the
    floor)."""
    feats = rng.randn(16, 2048).astype(np.float32) * rng.rand(2048) * 3
    feats[:, 7] = 0.5
    logits = rng.randn(16, 1008).astype(np.float32)
    seed = 987654
    monkeypatch.setattr(jinc.FeatureExtractor, "_PROBE_MEMO", {})
    fj, lj = jinc.FeatureExtractor._probe_scales(
        lambda p, x: (jnp.asarray(feats), jnp.asarray(logits)), None, seed)
    fp = pinc.probe_scale(torch.from_numpy(feats)).numpy()
    lp = pinc.probe_scale(torch.from_numpy(logits)).numpy()
    np.testing.assert_allclose(fp, np.asarray(fj), rtol=1e-5)
    np.testing.assert_allclose(lp, np.asarray(lj), rtol=1e-5)


class _StubExtractor:
    """Fixed random features for any images; ``calibrated`` as given."""

    def __init__(self, calibrated):
        self.calibrated = calibrated
        self.device = torch.device("cpu")
        self.rs = np.random.RandomState(0)

    def __call__(self, images):
        return self.rs.randn(len(images), 8).astype(np.float32), None


def test_real_stats_cache_keys_against_jax(tmp_path):
    """The port's uncalibrated cache key differs from JAX's for the same
    dataset (the port's random network is not JAX's); its calibrated key
    equals JAX's (one npz gives both the same features)."""
    from gansformer_tpu.data.dataset import SyntheticDataset as JaxSynthetic
    from gansformer_tpu_torch.data.dataset import SyntheticDataset

    for calibrated in (False, True):
        jdir, pdir = tmp_path / f"j{calibrated}", tmp_path / f"p{calibrated}"
        jmb._real_stats(JaxSynthetic(resolution=8, num_images=16),
                        _StubExtractor(calibrated), 4, 4, str(jdir))
        pmb._real_stats(SyntheticDataset(resolution=8, num_images=16),
                        _StubExtractor(calibrated), 4, 4, str(pdir))
        (jname,), (pname,) = os.listdir(jdir), os.listdir(pdir)
        assert pname == os.path.basename(pmb.real_stats_path(
            SyntheticDataset(resolution=8, num_images=16),
            _StubExtractor(calibrated), 4, str(pdir)))
        assert (pname == jname) == calibrated, (calibrated, pname, jname)
        with np.load(pdir / pname) as z:
            assert z["mu"].shape == (8,) and z["sigma"].shape == (8, 8)


def test_metric_names_match_jax():
    for names, n in (("fid50k,is1k,pr500,ppl2k", None),
                     ("fid1k,is1k,pr1k,ppl1k", None),
                     ("fid,is,pr,ppl", 256)):
        got = pmb.parse_metric_names(names, num_images=n, batch_size=8)
        want = jmb.parse_metric_names(names, num_images=n, batch_size=8)
        assert [type(m).__name__ for m in got] == \
            [type(m).__name__ for m in want]
        assert [m.name for m in got] == [m.name for m in want]
        assert [vars(m) for m in got] == [vars(m) for m in want]
    assert pmb.FLAG_KEYS == jmb.FLAG_KEYS
    with pytest.raises(ValueError, match="unknown metric"):
        pmb.parse_metric_names("kid1k")


def test_metrics_modules_import_no_jax():
    """The metrics package and the two CLIs, in a fresh interpreter,
    leave jax, flax and the JAX package out of sys.modules; resolving
    the weights reads the disk only (no network, no subprocess)."""
    code = (
        "import sys, subprocess, socket\n"
        "def no(*a, **k): raise AssertionError('no subprocess/network')\n"
        "subprocess.Popen = no\n"
        "socket.socket.connect = no\n"
        "import gansformer_tpu_torch.metrics as m\n"
        "import gansformer_tpu_torch.metrics.sweep\n"
        "import gansformer_tpu_torch.cli.evaluate\n"
        "import gansformer_tpu_torch.cli.experiment\n"
        "from gansformer_tpu_torch.metrics.inception import "
        "resolve_weights\n"
        "assert resolve_weights('/nonexistent.npz') is None\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'gansformer_tpu')]\n"
        "assert not bad, bad\n"
        "print('OK')\n")
    env = {k: v for k, v in os.environ.items()
           if k != "GANSFORMER_TPU_INCEPTION_NPZ"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr
