"""Improved Precision & Recall (the port's counterpart of
``gansformer_tpu/metrics/precision_recall.py``), the kNN-manifold
estimator of Kynkäänniemi et al. 2019:

* each feature set defines a manifold = union of hyperspheres around every
  point with radius = distance to its k-th nearest neighbour (k=3);
* precision = fraction of fakes inside the REAL manifold;
* recall    = fraction of reals inside the FAKE manifold.

Distances are blocked ``|a|²+|b|²-2ab`` tiles in fp32 on the features'
device (``torch.matmul`` with TF32 off, ``torch.topk``), so a 50k×50k
sweep never materializes: peak memory is one [block × N] tile.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gansformer_tpu_torch.core.precision import exact_fp32


def _kth_nn_tile(rows: torch.Tensor, first: int, feats: torch.Tensor,
                 k: int) -> torch.Tensor:
    """k-th-NN squared distance of rows ``first..first+len(rows)`` against
    the whole set, self-matches excluded by index."""
    d2 = ((rows ** 2).sum(-1)[:, None] + (feats ** 2).sum(-1)[None, :]
          - 2.0 * rows @ feats.T)
    d2 = d2.clamp_min(0.0)
    idx = torch.arange(first, first + rows.shape[0], device=rows.device)
    d2[torch.arange(rows.shape[0], device=rows.device), idx] = float("inf")
    return torch.topk(d2, k, dim=-1, largest=False).values[:, k - 1]


def _kth_nn_sq(feats: torch.Tensor, k: int, block: int) -> torch.Tensor:
    """Blocked k-th-NN radii: one [block × N] tile at a time."""
    return torch.cat([_kth_nn_tile(feats[i:i + block], i, feats, k)
                      for i in range(0, feats.shape[0], block)])


def _in_manifold(queries: torch.Tensor, refs: torch.Tensor,
                 ref_radii_sq: torch.Tensor, block: int) -> torch.Tensor:
    """query ∈ manifold(refs) ⇔ ∃j: ||q-r_j||² ≤ radius_j²."""
    ref_sq = (refs ** 2).sum(-1)[None, :]
    hits = []
    for i in range(0, queries.shape[0], block):
        q = queries[i:i + block]
        d2 = (q ** 2).sum(-1)[:, None] + ref_sq - 2.0 * q @ refs.T
        hits.append((d2.clamp_min(0.0) <= ref_radii_sq[None, :]).any(-1))
    return torch.cat(hits)


def _fp32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(device or x.device, torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def precision_recall(real_feats, fake_feats, k: int = 3, block: int = 4096,
                     device: Optional[torch.device] = None
                     ) -> Tuple[float, float]:
    """Improved precision/recall between two feature sets (arrays or
    tensors), on ``device`` (default: the tensors' own, the CPU for
    arrays)."""
    real = _fp32(real_feats, device)
    fake = _fp32(fake_feats, device or real.device)
    with torch.no_grad(), exact_fp32():
        real_r = _kth_nn_sq(real, k, block)
        fake_r = _kth_nn_sq(fake, k, block)
        precision = _in_manifold(fake, real, real_r, block).double().mean()
        recall = _in_manifold(real, fake, fake_r, block).double().mean()
    return float(precision), float(recall)
