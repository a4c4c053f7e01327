"""The one metric-sweep entry point of the port, shared by
``cli/evaluate.py`` and ``cli/experiment.py`` (the counterpart of
``gansformer_tpu/metrics/sweep.py``, without the mesh: one device).

It builds the dataset of the run's config, the metric group over the
extractor (``make_extractor``: an npz, or the uncalibrated network), and
the EMA generator's samplers, then runs the group.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from gansformer_tpu_torch.core.config import ExperimentConfig


def run_metric_sweep(cfg: ExperimentConfig, state, run_dir: str,
                     metrics: str, *,
                     batch_size: Optional[int] = None,
                     num_images: Optional[int] = None,
                     truncation_psi: float = 1.0,
                     seed: int = 7,
                     inception_npz: Optional[str] = None,
                     cache_dir: Optional[str] = None,
                     device=None,
                     group_out: Optional[list] = None) -> Dict[str, float]:
    """Metric names → results (``{'fid50k_uncal': …, 'calibrated':
    0.0}``) of ``state``'s EMA generator, on the state's device
    (``device`` must name the same one).  Real-image statistics cache
    under ``<run_dir>/metric-cache`` unless ``cache_dir`` says otherwise.
    ``group_out``: a list that receives the ``MetricGroup`` (its
    ``timings``)."""
    from gansformer_tpu_torch.data.dataset import make_dataset
    from gansformer_tpu_torch.metrics.inception import make_extractor
    from gansformer_tpu_torch.metrics.metric_base import (MetricGroup,
                                                          parse_metric_names)
    from gansformer_tpu_torch.train.steps import make_metric_samplers

    batch_size = batch_size or cfg.train.batch_size
    dataset = make_dataset(cfg.data)
    try:
        # --num-images overrides the count at construction, so the metric
        # name (and the metric-<name>.txt it lands in) stays honest
        group = MetricGroup(
            parse_metric_names(metrics, batch_size=batch_size,
                               num_images=num_images),
            make_extractor(inception_npz, device=device or state.device),
            cache_dir=cache_dir or os.path.join(run_dir, "metric-cache"))
        if group_out is not None:
            group_out.append(group)
        sample_fn, pair_fn = make_metric_samplers(
            state, cfg, dataset, truncation_psi=truncation_psi, seed=seed,
            device=device)
        return group.run(sample_fn, dataset, pair_fn=pair_fn)
    finally:
        dataset.close()
