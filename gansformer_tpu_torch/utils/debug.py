"""NaN/Inf debugging (the port's copy of ``gansformer_tpu/utils/debug.py``).

* ``enable_nan_debug()`` turns on ``torch.autograd.set_detect_anomaly``,
  the counterpart of ``jax_debug_nans``: a backward that produces NaN
  raises at the op, naming the forward that made it.  Costly, so it is
  a flag (``TrainConfig.debug_nans``).
* ``check_finite_stats()`` raises ``FloatingPointError`` naming the first
  non-finite tick statistic.
"""

from __future__ import annotations

import math
from typing import Dict


def enable_nan_debug() -> None:
    import torch

    torch.autograd.set_detect_anomaly(True, check_nan=True)


def check_finite_stats(stats: Dict[str, float], where: str = "") -> None:
    """Raise FloatingPointError on the first non-finite scalar in a
    fetched tick-stats dict."""
    for k, v in stats.items():
        if isinstance(v, (int, float)) and not math.isfinite(v):
            raise FloatingPointError(
                f"non-finite training statistic {k!r} = {v}"
                + (f" at {where}" if where else "")
                + "; re-run with --debug-nans to locate the producing op")
