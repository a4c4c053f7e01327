"""Perceptual Path Length (the port's copy of
``gansformer_tpu/metrics/ppl.py``): the mean perceptual distance between
images at w-space lerp positions t and t+ε, scaled by 1/ε², with both 1%
tails filtered out.  The distance is the squared L2 of the shared
extractor's pool features (not the lineage's VGG16 LPIPS), so numbers
compare between checkpoints of one run, not with published PPL."""

from __future__ import annotations

import numpy as np


def ppl_from_distances(d: np.ndarray, lo_pct: float = 1.0,
                       hi_pct: float = 99.0) -> float:
    """Filtered mean (both 1% tails dropped before averaging)."""
    d = np.asarray(d, np.float64)
    lo, hi = np.percentile(d, [lo_pct, hi_pct])
    mask = (d >= lo) & (d <= hi)
    return float(d[mask].mean()) if mask.any() else float(d.mean())


def _host64(x) -> np.ndarray:
    """A tensor or array as a float64 host array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().double().numpy()
    return np.asarray(x, np.float64)


def sample_ppl_distances(pair_fn, extractor, num_samples: int,
                         batch_size: int, epsilon: float = 1e-4,
                         seed: int = 0) -> np.ndarray:
    """Drive the ``pair_fn(n, t, pair_seed, epsilon)`` probe
    (``train/steps.py make_metric_samplers``) and return per-sample
    ε-normalized squared feature distances.  The draws are JAX's: one
    ``RandomState(seed)``, then per full batch one ``rand(batch)`` for t
    and one ``randint(2**31)`` for the pair seed; the surplus of the last
    batch is trimmed."""
    rs = np.random.RandomState(seed)
    out = []
    seen = 0
    while seen < num_samples:
        t = rs.rand(batch_size).astype(np.float32)   # sampling='full'
        img_a, img_b = pair_fn(batch_size, t, rs.randint(2**31), epsilon)
        fa, _ = extractor(img_a)
        fb, _ = extractor(img_b)
        diff = _host64(fa) - _host64(fb)
        out.append((diff ** 2).sum(axis=-1) / (epsilon ** 2))
        seen += batch_size
    return np.concatenate(out)[:num_samples]
