"""The whole metric slice against the JAX package on the CPU: JAX's
``MetricGroup`` and the port's on the same injected images.

The group: both sides get a ``sample_fn`` and a ``pair_fn`` that return
the same numpy batches, the same synthetic dataset, and extractors of the
same npz (``test_torch_metrics_inception.write_inception_npz``).  Every
key of the results must agree: the P&R fractions and the ``calibrated``
flag exactly, IS at 1e-4 relative (logits agree to ~1e-6), FID at 1e-3
relative and PPL at 1e-3 relative (its distances are feature differences
at ε = 1e-2, so the features' ~1e-6 agreement becomes ~1e-4 of a
distance).  16 samples of 2048-dim features make rank-15 covariances:
both packages' ``scipy.linalg.sqrtm`` is replaced by the low-rank
stand-in (its trace held to scipy's in ``test_torch_metrics``), since
scipy's costs 20 s a call at 2048² here.

The samplers are held to JAX's in ``test_torch_metrics_samplers``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

from gansformer_tpu.data.dataset import SyntheticDataset as JaxSynthetic
from gansformer_tpu.metrics import inception as jinc
from gansformer_tpu.metrics import metric_base as jmb
from gansformer_tpu_torch.data.dataset import SyntheticDataset
from gansformer_tpu_torch.metrics import inception as pinc
from gansformer_tpu_torch.metrics import metric_base as pmb
from tests.test_torch_metrics import lowrank_sqrtm
from tests.test_torch_metrics_inception import write_inception_npz
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

RES = 32
N = 16
BATCH = 8
EPS = 1e-2
RTOL = {"fid": 1e-3, "is": 1e-4, "ppl": 1e-3}


def _metrics(mb):
    return [mb.FIDMetric(N, BATCH), mb.ISMetric(N, BATCH, splits=2),
            mb.PRMetric(N, BATCH), mb.PPLMetric(BATCH, BATCH, epsilon=EPS)]


def _samplers():
    """The same numpy batches for every caller: fakes from one
    RandomState, pairs as a function of the pair seed."""
    rs = np.random.RandomState(3)

    def sample_fn(n):
        return (rs.rand(n, RES, RES, 3) * 2 - 1).astype(np.float32)

    def pair_fn(n, t, seed, epsilon):
        r = np.random.RandomState(seed)
        a, b = r.rand(2, n, RES, RES, 3) * 2 - 1
        t = np.asarray(t)[:, None, None, None]
        return ((a + (b - a) * t).astype(np.float32),
                (a + (b - a) * (t + epsilon)).astype(np.float32))

    return sample_fn, pair_fn


def _key_class(key):
    for cls in ("fid", "is", "ppl"):
        if key.startswith(cls):
            return cls
    return "exact"


def test_metric_group_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(scipy.linalg, "sqrtm", lowrank_sqrtm)
    npz = write_inception_npz(tmp_path / "w.npz")
    jgroup = jmb.MetricGroup(
        _metrics(jmb), jinc.FeatureExtractor(jinc.load_params_npz(npz)),
        cache_dir=str(tmp_path / "jax"))
    pgroup = pmb.MetricGroup(_metrics(pmb),
                             pinc.make_extractor(npz, device="cpu"),
                             cache_dir=str(tmp_path / "port"))
    s, p = _samplers()
    want = jgroup.run(lambda n: jnp.asarray(s(n)),
                      JaxSynthetic(resolution=RES, num_images=64),
                      pair_fn=p)
    s, p = _samplers()
    dataset = SyntheticDataset(resolution=RES, num_images=64)
    got = pgroup.run(s, dataset, pair_fn=p)
    assert set(got) == set(want) == {
        "fid16", "is16_mean", "is16_std", "pr16_3_precision",
        "pr16_3_recall", "ppl8_wfull", "calibrated"}
    for k, w in want.items():
        cls = _key_class(k)
        if cls == "exact":
            assert got[k] == w, k
        else:
            assert got[k] == pytest.approx(w, rel=RTOL[cls]), (k, got[k], w)
    # the group's sweeps: 16 fakes once (FID, IS and P&R share them), 16
    # reals once, 8 pairs
    t = pgroup.timings
    assert (t["fake_images"], t["real_images"], t["ppl_pairs"]) == (16, 16, 8)
    # the real statistics come back from the cache the first run wrote
    s, p = _samplers()
    again = pmb.MetricGroup(_metrics(pmb)[:1], pgroup.extractor,
                            cache_dir=str(tmp_path / "port")).run(s, dataset)
    assert again["fid16"] == got["fid16"]


