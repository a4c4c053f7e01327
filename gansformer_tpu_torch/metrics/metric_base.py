"""Metric registry and the real-statistics cache (the port's counterpart
of ``gansformer_tpu/metrics/metric_base.py``): metrics run per snapshot;
the Inception activations of the real dataset are computed once and
cached on disk, keyed by the dataset.

One group run shares one fake sweep (FID, IS and P&R read the same
features) and one real sweep.  The sweeps keep the seconds and images of
their generator half and their extractor half in ``MetricGroup.timings``
(on the card each half ends in a device sync, so the split is the
device's).
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from gansformer_tpu_torch.data.dataset import Dataset, normalize_images
from gansformer_tpu_torch.metrics.fid import (compute_activation_stats,
                                              frechet_distance)
from gansformer_tpu_torch.metrics.inception import (FeatureExtractor,
                                                    make_extractor)
from gansformer_tpu_torch.metrics.inception_score import inception_score
from gansformer_tpu_torch.obs import registry as telemetry
from gansformer_tpu_torch.obs.spans import get_tracer, span

# Keys of MetricGroup.run's output that are flags, not metrics: callers
# write them to flag-<name>.txt and never as metric-<name>.txt series.
FLAG_KEYS = ("calibrated",)

# The real-statistics cache's regime tags.  The port's uncalibrated
# network is not JAX's ('rand2'), so its tag differs: a run dir that both
# packages evaluate must not read the other's μ/Σ.  One npz gives both
# packages the same calibrated features, so 'cal' is shared.
CAL_TAG = "cal"
UNCAL_TAG = "rand2-torch"


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _sync(extractor: FeatureExtractor) -> None:
    if extractor.device.type == "cuda":
        torch.cuda.synchronize(extractor.device)


def _add(timings: Optional[dict], **kv) -> None:
    if timings is not None:
        for k, v in kv.items():
            timings[k] = timings.get(k, 0) + v


class Metric:
    name: str = "metric"

    def run(self, sample_fn: Callable[[int], torch.Tensor], dataset: Dataset,
            extractor: FeatureExtractor, cache_dir: Optional[str],
            pair_fn: Optional[Callable] = None,
            sweep_cache: Optional[Dict] = None) -> Dict[str, float]:
        """pair_fn(n, t, seed, epsilon) → (img_a, img_b): the generator's
        PPL probe (``train/steps.py make_metric_samplers``); None for
        callers that run image-level metrics only.  sweep_cache: the
        group run's memo, so FID, IS and P&R share one fake sweep."""
        raise NotImplementedError


def _real_features(dataset: Dataset, extractor: FeatureExtractor,
                   num_images: int, batch_size: int,
                   cache: Optional[dict] = None) -> np.ndarray:
    """The one real-image feature sweep (FID statistics and P&R share
    it), memoized per group run like the fake sweep."""
    key = ("real", num_images, batch_size)
    if cache is not None and key in cache:
        return cache[key]
    feats = []
    seen = 0
    t0 = time.perf_counter()
    for batch in dataset.batches(batch_size, seed=123):
        imgs = normalize_images(torch.from_numpy(
            np.ascontiguousarray(batch["image"])))
        f, _ = extractor(imgs)
        take = min(len(f), num_images - seen)
        feats.append(_host(f[:take]))
        seen += take
        if seen >= num_images:
            break
    out = np.concatenate(feats)
    if cache is not None:
        _add(cache.get("timings"), real_s=time.perf_counter() - t0,
             real_images=len(out))
        cache[key] = out
    return out


def real_stats_path(dataset: Dataset, extractor: FeatureExtractor,
                    num_images: int, cache_dir: str) -> str:
    """``<cache_dir>/real-stats-<md5>.npz`` of the dataset, the image
    count and the extractor's regime."""
    regime = CAL_TAG if extractor.calibrated else UNCAL_TAG
    tag = f"{dataset.cache_tag()}-{num_images}-{regime}"
    return os.path.join(cache_dir, "real-stats-"
                        + hashlib.md5(tag.encode()).hexdigest()[:16]
                        + ".npz")


def _real_stats(dataset: Dataset, extractor: FeatureExtractor,
                num_images: int, batch_size: int,
                cache_dir: Optional[str], cache: Optional[dict] = None):
    """(μ, Σ) of real-image features, disk-cached like the reference's
    per-dataset activation pickles (written to a temporary file, then
    renamed into place)."""
    key = None
    if cache_dir:
        key = real_stats_path(dataset, extractor, num_images, cache_dir)
        if os.path.exists(key):
            with np.load(key) as z:
                return z["mu"], z["sigma"]
    mu, sigma = compute_activation_stats(
        _real_features(dataset, extractor, num_images, batch_size, cache))
    if key:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{key}.tmp{os.getpid()}.npz"
        np.savez(tmp, mu=mu, sigma=sigma)
        os.replace(tmp, key)
    return mu, sigma


def _fake_features(sample_fn, extractor: FeatureExtractor, num_images: int,
                   batch_size: int, cache: Optional[dict] = None):
    """The fake sweep: generation + extraction in full batches, the
    surplus trimmed; memoized per group run."""
    key = ("fake", num_images, batch_size)
    if cache is not None and key in cache:
        return cache[key]
    timings = cache.get("timings") if cache is not None else None
    feats, logits = [], []
    seen = 0
    while seen < num_images:
        t0 = time.perf_counter()
        imgs = sample_fn(batch_size)
        _sync(extractor)
        t1 = time.perf_counter()
        f, lg = extractor(imgs)
        take = min(batch_size, num_images - seen)
        feats.append(_host(f[:take]))
        logits.append(_host(lg[:take]))
        t2 = time.perf_counter()
        _add(timings, generator_s=t1 - t0, extractor_s=t2 - t1,
             fake_images=len(imgs))
        seen += take
    out = (np.concatenate(feats), np.concatenate(logits))
    if cache is not None:
        cache[key] = out
    return out


def _count_tag(n: int) -> str:
    return f"{n // 1000}k" if n >= 1000 and n % 1000 == 0 else str(n)


def _named(name: str, extractor: FeatureExtractor) -> str:
    """Random Inception weights give a valid two-sample discrepancy that
    is NOT comparable to published numbers: the name says so."""
    return name if extractor.calibrated else f"{name}_uncal"


class FIDMetric(Metric):
    """FID@N, the north-star metric."""

    def __init__(self, num_images: int = 50000, batch_size: int = 32):
        self.name = f"fid{_count_tag(num_images)}"
        self.num_images = num_images
        self.batch_size = batch_size

    def run(self, sample_fn, dataset, extractor, cache_dir, pair_fn=None,
            sweep_cache=None):
        mu_r, s_r = _real_stats(dataset, extractor,
                                min(self.num_images,
                                    dataset.num_images or self.num_images),
                                self.batch_size, cache_dir, sweep_cache)
        feats, _ = _fake_features(sample_fn, extractor, self.num_images,
                                  self.batch_size, cache=sweep_cache)
        mu_f, s_f = compute_activation_stats(feats)
        return {_named(self.name, extractor):
                frechet_distance(mu_r, s_r, mu_f, s_f)}


class ISMetric(Metric):
    def __init__(self, num_images: int = 50000, batch_size: int = 32,
                 splits: int = 10):
        self.name = f"is{_count_tag(num_images)}"
        self.num_images = num_images
        self.batch_size = batch_size
        self.splits = splits

    def run(self, sample_fn, dataset, extractor, cache_dir, pair_fn=None,
            sweep_cache=None):
        _, logits = _fake_features(sample_fn, extractor, self.num_images,
                                   self.batch_size, cache=sweep_cache)
        mean, std = inception_score(logits, self.splits)
        name = _named(self.name, extractor)
        return {f"{name}_mean": mean, f"{name}_std": std}


class PPLMetric(Metric):
    """Perceptual path length over the generator's w-space lerp probe;
    needs ``pair_fn``."""

    def __init__(self, num_samples: int = 50000, batch_size: int = 32,
                 epsilon: float = 1e-4):
        self.name = f"ppl{_count_tag(num_samples)}_wfull"
        self.num_samples = num_samples
        self.batch_size = batch_size
        self.epsilon = epsilon

    def run(self, sample_fn, dataset, extractor, cache_dir, pair_fn=None,
            sweep_cache=None):
        if pair_fn is None:
            raise ValueError(
                "PPL needs the generator's pair probe; pass pair_fn "
                "(train/steps.py make_metric_samplers) into "
                "MetricGroup.run")
        from gansformer_tpu_torch.metrics.ppl import (ppl_from_distances,
                                                      sample_ppl_distances)

        t0 = time.perf_counter()
        d = sample_ppl_distances(pair_fn, extractor, self.num_samples,
                                 self.batch_size, self.epsilon)
        if sweep_cache is not None:
            _add(sweep_cache.get("timings"),
                 ppl_s=time.perf_counter() - t0, ppl_pairs=len(d))
        return {_named(self.name, extractor): ppl_from_distances(d)}


class PRMetric(Metric):
    """Improved precision & recall."""

    def __init__(self, num_images: int = 50000, batch_size: int = 32,
                 k: int = 3):
        self.name = f"pr{_count_tag(num_images)}_{k}"
        self.num_images = num_images
        self.batch_size = batch_size
        self.k = k

    def run(self, sample_fn, dataset, extractor, cache_dir, pair_fn=None,
            sweep_cache=None):
        from gansformer_tpu_torch.metrics.precision_recall import \
            precision_recall

        # P&R needs the raw real features (not μ/Σ): the shared real
        # sweep; the fakes come from the group's memo
        n_real = min(self.num_images,
                     dataset.num_images or self.num_images)
        feats_r = _real_features(dataset, extractor, n_real,
                                 self.batch_size, cache=sweep_cache)
        feats_f, _ = _fake_features(sample_fn, extractor, self.num_images,
                                    self.batch_size, cache=sweep_cache)
        p, r = precision_recall(feats_r, feats_f, k=self.k,
                                device=extractor.device)
        name = _named(self.name, extractor)
        return {f"{name}_precision": p, f"{name}_recall": r}


class MetricGroup:
    """A set of metrics against one generator snapshot (the reference's
    ``MetricGroup.run(snapshot_pkl, dataset)``)."""

    def __init__(self, metrics: List[Metric],
                 extractor: Optional[FeatureExtractor] = None,
                 cache_dir: Optional[str] = None):
        self.metrics = metrics
        self.extractor = extractor or make_extractor()
        self.cache_dir = cache_dir
        self.timings: Dict[str, float] = {}
        self.sweep_cache: Dict = {}

    def run(self, sample_fn: Callable[[int], torch.Tensor],
            dataset: Dataset,
            pair_fn: Optional[Callable] = None) -> Dict[str, float]:
        out: Dict[str, float] = {}
        self.timings = {}
        self.sweep_cache = {"timings": self.timings}
        for m in self.metrics:
            # a span per metric (events.jsonl, under the loop's `metric`
            # phase) and a duration gauge: a slow sweep is attributable
            with span(f"metric/{m.name}") as sp:
                out.update(m.run(sample_fn, dataset, self.extractor,
                                 self.cache_dir, pair_fn=pair_fn,
                                 sweep_cache=self.sweep_cache))
            telemetry.gauge(f"metric/{m.name}/duration_s").set(sp.duration_s)
            telemetry.counter("metric/runs_total").inc()
        # sweeps also run outside the loop's flush points (evaluate,
        # experiment): push the span events to events.jsonl now
        get_tracer().flush()
        out["calibrated"] = float(self.extractor.calibrated)
        return out


def parse_metric_names(names: str, num_images: Optional[int] = None,
                       batch_size: int = 32) -> List[Metric]:
    """'fid50k,is50k' → metric objects.  An explicit ``num_images``
    overrides the count in the name, and the metric renames itself, so a
    1k-sample FID is never logged as fid50k."""
    def parse_count(suffix: str) -> int:
        if not suffix:
            return 50000
        return (int(suffix[:-1]) * 1000 if suffix.endswith("k")
                else int(suffix))

    out: List[Metric] = []
    for n in filter(None, names.split(",")):
        if n.startswith("fid"):
            out.append(FIDMetric(num_images or parse_count(n[3:]), batch_size))
        elif n.startswith("is"):
            out.append(ISMetric(num_images or parse_count(n[2:]), batch_size))
        elif n.startswith("ppl"):
            out.append(PPLMetric(num_images or parse_count(n[3:]), batch_size))
        elif n.startswith("pr"):
            out.append(PRMetric(num_images or parse_count(n[2:]), batch_size))
        else:
            raise ValueError(f"unknown metric {n!r}")
    return out
