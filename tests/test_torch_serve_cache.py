"""The port's w cache and ``map_rows`` on the CPU: the LRU and its keys,
and the two acceptance counters of ``tests/test_serve.py`` (the JAX
package's service tests) on the port's counters: a repeated seed maps 0
times, at another psi too, and a batch that mixes hits and misses maps
once.  The port's programs run at TINY width (``tests/test_torch_serve``)."""

import numpy as np
import pytest
import torch

from gansformer_tpu_torch.obs import registry as telemetry
from gansformer_tpu_torch.serve import (ServePrograms, WCache, map_rows,
                                        wcache_key)
from tests.test_torch_serve import progs  # noqa: F401  (fixture)
from tests.torch_threads import one_thread  # noqa: F401  (autouse)


def _count(name):
    return telemetry.counter(name).value


def test_wcache_lru_eviction_and_keys():
    c = WCache(capacity=2)
    k1, k2, k3 = (wcache_key(i, None) for i in (1, 2, 3))
    c.put(k1, np.zeros(1)), c.put(k2, np.ones(1))
    assert c.get(k1) is not None          # touch 1 -> 2 becomes LRU
    c.put(k3, np.full(1, 3.0))
    assert len(c) == 2 and c.get(k2) is None and c.get(k3) is not None
    assert telemetry.gauge("serve/wcache_size").value == 2
    la = wcache_key(7, np.array([1.0, 0.0], np.float32))
    assert la == wcache_key(7, np.array([1.0, 0.0], np.float32))
    assert la != wcache_key(7, np.array([0.0, 1.0], np.float32))
    off = WCache(0)
    off.put(k1, np.zeros(1))
    assert off.get(k1) is None and len(off) == 0
    with pytest.raises(ValueError, match="capacity"):
        WCache(-1)


def test_repeat_seed_maps_zero_times_at_any_psi(progs):  # noqa: F811
    cache = WCache()
    first = map_rows(progs, cache, [991])
    maps = _count("serve/map_dispatch_total")
    hits = _count("serve/wcache_hits_total")
    again = map_rows(progs, cache, [991])
    img_a = progs.synthesize(again, [0.7], seed=0, tags=[991])
    img_b = progs.synthesize(map_rows(progs, cache, [991]), [0.4], seed=0,
                             tags=[991])
    assert _count("serve/map_dispatch_total") == maps
    assert _count("serve/wcache_hits_total") == hits + 2
    assert torch.equal(first, again)
    ref = progs.synthesize(first, [0.7], seed=0, tags=[991])
    assert torch.equal(img_a, ref)
    assert not torch.equal(img_a, img_b)       # psi is live, after the cache


def test_partial_miss_batch_maps_once(progs):  # noqa: F811
    """A batch of hits and misses takes one padded mapping dispatch for
    its misses; the assembled rows equal each seed's own mapping."""
    cache = WCache()
    map_rows(progs, cache, [700])
    maps = _count("serve/map_dispatch_total")
    misses = _count("serve/wcache_misses_total")
    rows = map_rows(progs, cache, [700, 701, 702])     # 1 hit, 2 misses
    assert _count("serve/map_dispatch_total") == maps + 1
    assert _count("serve/wcache_misses_total") == misses + 2
    assert rows.shape == (3, progs.bundle.cfg.num_ws, progs.bundle.cfg.w_dim)
    solo = torch.cat([progs.map_seeds([s]) for s in (700, 701, 702)])
    torch.testing.assert_close(rows, solo, rtol=1e-6, atol=1e-6)
    assert len(cache) == 3


def test_map_rows_keys_labels(progs):  # noqa: F811
    """A conditional model's rows are keyed by seed and label: the same
    seed under another label maps again."""
    import dataclasses

    from gansformer_tpu_torch.serve import init_generator

    cfg = dataclasses.replace(progs.bundle.cfg, label_dim=2)
    p = ServePrograms(init_generator(cfg, seed=1, device="cpu"),
                      buckets=(1, 2))
    cache = WCache()
    la = np.array([[1.0, 0.0]], np.float32)
    lb = np.array([[0.0, 1.0]], np.float32)
    ra = map_rows(p, cache, [5], la)
    maps = _count("serve/map_dispatch_total")
    rb = map_rows(p, cache, [5], lb)
    assert _count("serve/map_dispatch_total") == maps + 1
    assert not torch.equal(ra, rb)
    map_rows(p, cache, [5, 5], np.concatenate([la, lb]))
    assert _count("serve/map_dispatch_total") == maps + 1
    with pytest.raises(ValueError, match="label"):
        map_rows(p, cache, [6])
