"""Metrics of the port: the Inception extractor (``inception``), FID, IS,
improved precision & recall and PPL, the metric group with its cached
real statistics (``metric_base``) and the sweep entry point (``sweep``).
Counterparts of ``gansformer_tpu/metrics``; the converter and the
download stay the JAX package's."""

from gansformer_tpu_torch.metrics.fid import (compute_activation_stats,
                                              fid_from_features,
                                              frechet_distance,
                                              sqrtm_newton_schulz)
from gansformer_tpu_torch.metrics.inception import (FeatureExtractor,
                                                    InceptionV3,
                                                    load_params_npz,
                                                    make_extractor)
from gansformer_tpu_torch.metrics.inception_score import inception_score
from gansformer_tpu_torch.metrics.metric_base import (FLAG_KEYS, FIDMetric,
                                                      ISMetric, MetricGroup,
                                                      PPLMetric, PRMetric,
                                                      parse_metric_names)
from gansformer_tpu_torch.metrics.ppl import ppl_from_distances
from gansformer_tpu_torch.metrics.precision_recall import precision_recall

__all__ = ["FIDMetric", "FLAG_KEYS", "FeatureExtractor", "ISMetric",
           "InceptionV3", "MetricGroup", "PPLMetric", "PRMetric",
           "compute_activation_stats", "fid_from_features",
           "frechet_distance", "inception_score", "load_params_npz",
           "make_extractor", "parse_metric_names", "ppl_from_distances",
           "precision_recall", "sqrtm_newton_schulz"]
