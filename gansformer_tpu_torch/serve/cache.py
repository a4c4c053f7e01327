"""The w cache: mapped latents by content address (the counterpart of
``gansformer_tpu/serve/cache.py``), and ``map_rows``, the assembly of a
batch's rows from it that the JAX package keeps inside its service
(``gansformer_tpu/serve/service.py`` ``map_misses``, ``cache_fill``).

``map_seeds`` makes z_i a function of (seed_i, label_i) alone, so that
pair addresses the mapped row.  The cache holds the row after the
mapping and before truncation, which runs in the synth program: a
repeated seed maps no more, at any psi.  Rows are host fp32 arrays
[num_ws, w_dim].  Telemetry: ``serve/wcache_hits_total``,
``serve/wcache_misses_total`` and the ``serve/wcache_size`` gauge.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gansformer_tpu_torch.core.device import to_device
from gansformer_tpu_torch.obs import registry as telemetry
from gansformer_tpu_torch.serve.programs import bucket_for


def wcache_key(seed: int, label: Optional[np.ndarray]) -> Tuple:
    """(seed, label bytes): the content address of one mapped row."""
    if label is None:
        return (int(seed), None)
    return (int(seed), np.ascontiguousarray(label, np.float32).tobytes())


class WCache:
    """Thread-safe LRU of mapped-latent rows (capacity 0: off)."""

    def __init__(self, capacity: int = 4096):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._rows: "OrderedDict[Tuple, np.ndarray]" = OrderedDict()
        # explicit zeros: all-miss traffic still exports the families
        telemetry.counter("serve/wcache_hits_total")
        telemetry.counter("serve/wcache_misses_total")
        telemetry.gauge("serve/wcache_size").set(0)

    def get(self, key: Tuple) -> Optional[np.ndarray]:
        with self._lock:
            row = self._rows.get(key)
            if row is not None:
                self._rows.move_to_end(key)
        telemetry.counter("serve/wcache_hits_total" if row is not None
                          else "serve/wcache_misses_total").inc()
        return row

    def put(self, key: Tuple, row: np.ndarray) -> None:
        if self.capacity == 0:
            return
        with self._lock:
            self._rows[key] = row
            self._rows.move_to_end(key)
            while len(self._rows) > self.capacity:
                self._rows.popitem(last=False)
            telemetry.gauge("serve/wcache_size").set(len(self._rows))

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)


def map_rows(programs, cache: WCache, seeds: Sequence[int],
             labels: Optional[np.ndarray] = None,
             on_map: Optional[Callable[[List[int], int], None]] = None,
             select_bucket: Optional[Callable[[int], int]] = None
             ) -> torch.Tensor:
    """The mapped rows of ``seeds`` (labels [n, label_dim] for a
    conditional model): ws [n, num_ws, w_dim] fp32 on the programs'
    device.  Hits come from ``cache``; every miss of the batch is mapped
    in one ``map_seeds`` dispatch, padded to its bucket by repeating the
    last miss, and put in the cache.  ``on_map(miss, bucket)`` is called
    with the misses' positions and the mapping bucket just before that
    dispatch (the service traces and attributes it there);
    ``select_bucket(n)`` picks the mapping bucket (default: the smallest
    of ``programs.buckets`` that holds n)."""
    keys = [wcache_key(s, None if labels is None else labels[i])
            for i, s in enumerate(seeds)]
    rows = [cache.get(k) for k in keys]
    miss = [i for i, r in enumerate(rows) if r is None]
    if miss:
        mb = (bucket_for(len(miss), programs.buckets)
              if select_bucket is None else select_bucket(len(miss)))
        if on_map is not None:
            on_map(miss, mb)
        pad = [miss[-1]] * (mb - len(miss))
        mseeds = [int(seeds[i]) for i in miss + pad]
        mlabel = (None if labels is None else
                  np.stack([np.asarray(labels[i], np.float32)
                            for i in miss + pad]))
        ws = programs.map_seeds(mseeds, mlabel)
        host = ws[:len(miss)].float().cpu().numpy()
        for j, i in enumerate(miss):
            rows[i] = host[j]
            cache.put(keys[i], host[j])
    return to_device(torch.from_numpy(np.stack(rows)), programs.device)
