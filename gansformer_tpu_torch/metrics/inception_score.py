"""Inception Score (the port's copy of
``gansformer_tpu/metrics/inception_score.py``):
exp(E_x[KL(p(y|x) || p(y))]) over generated images' logits, mean and std
over splits."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def inception_score(logits: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """logits [N, num_classes] → (mean IS, std IS over splits)."""
    logits = np.asarray(logits, np.float64)
    logits = logits - logits.max(axis=1, keepdims=True)
    probs = np.exp(logits)
    probs /= probs.sum(axis=1, keepdims=True)

    scores = []
    n = len(probs)
    for i in range(splits):
        part = probs[i * n // splits:(i + 1) * n // splits]
        if len(part) == 0:
            continue
        py = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-16) - np.log(py + 1e-16))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))
