"""Fréchet Inception Distance (the port's copy of
``gansformer_tpu/metrics/fid.py``).

The statistics stay numpy: μ and Σ of the features in float64, then
``d² = |μ₁-μ₂|² + Tr(Σ₁+Σ₂-2√(Σ₁Σ₂))`` with ``scipy.linalg.sqrtm``.
``sqrtm_newton_schulz`` is the scipy-free square root, a torch function
that runs on the device of the matrix it is given; ``frechet_distance``
uses it only where scipy is missing (``method="auto"``) or when asked
(``method="newton_schulz"``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def compute_activation_stats(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """features [N, D] → (mu [D], sigma [D, D])."""
    feats = np.asarray(feats, dtype=np.float64)
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def sqrtm_newton_schulz(a: torch.Tensor, iters: int = 30) -> torch.Tensor:
    """Matrix square root of a PSD matrix by Newton–Schulz iteration, in
    fp32 with a norm pre-scale, on ``a``'s device.  Accurate to ~1e-4
    relative for well-conditioned covariance products: adequate for FID
    (differences of interest are >0.1)."""
    a = torch.as_tensor(a).to(torch.float32)
    n = a.shape[0]
    norm = torch.sqrt(torch.sum(a * a))
    y = a / norm
    z = torch.eye(n, dtype=torch.float32, device=a.device)
    eye3 = 3.0 * torch.eye(n, dtype=torch.float32, device=a.device)
    for _ in range(iters):
        t = 0.5 * (eye3 - z @ y)
        y, z = y @ t, t @ z
    return y * torch.sqrt(norm)


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray,
                     mu2: np.ndarray, sigma2: np.ndarray,
                     method: str = "auto") -> float:
    """d²((μ₁,Σ₁), (μ₂,Σ₂)) — the FID formula.  ``method``: 'auto'
    (scipy where it imports, else Newton–Schulz), 'scipy' or
    'newton_schulz'."""
    mu1 = np.asarray(mu1, np.float64)
    mu2 = np.asarray(mu2, np.float64)
    sigma1 = np.asarray(sigma1, np.float64)
    sigma2 = np.asarray(sigma2, np.float64)
    diff = mu1 - mu2

    covmean = None
    if method in ("auto", "scipy"):
        try:
            import scipy.linalg

            # no `disp`: newer scipy has dropped it; the matrix alone
            # comes back either way
            covmean = np.real(scipy.linalg.sqrtm(sigma1 @ sigma2))
        except ImportError:
            if method == "scipy":
                raise
    if covmean is None:
        covmean = sqrtm_newton_schulz(
            torch.from_numpy(sigma1 @ sigma2)).double().cpu().numpy()

    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def fid_from_features(real_feats: np.ndarray, fake_feats: np.ndarray,
                      method: str = "auto") -> float:
    mu_r, s_r = compute_activation_stats(real_feats)
    mu_f, s_f = compute_activation_stats(fake_feats)
    return frechet_distance(mu_r, s_r, mu_f, s_f, method=method)
