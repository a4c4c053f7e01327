"""The port's generation service (``gansformer_tpu_torch/serve/service.py``)
on the CPU, at the serve tests' micro width.

* **Images.**  A stream served through the service equals, bit for bit,
  its batches replayed through ``map_rows`` + ``synthesize`` (the same
  rows, bucket, psi, tags and w cache), whatever the fill wait and the
  buckets.  Across buckets the host's GEMM is not bit-stable (a row of
  bucket 1 and the same row of bucket 4 differ in the last bits, shown
  below), so a request's image is held to the request alone at bucket 1
  within ``CROSS_BUCKET_TOL``.
* **Robustness.**  One scenario for each of the JAX package's service
  tests in ``tests/test_serve.py`` (crash and breaker, self-healing, the
  breaker's count, a hung dispatcher, overload, deadlines, client
  timeouts, dead slots, quarantine, the drain, ``close`` past its grace
  and after the dispatcher's death).  Each scenario runs on the port's
  service over its real programs and on JAX's ``GenerationService`` over
  stand-in programs (numpy: nothing compiles), with the same faults
  armed in each package; the tickets' outcomes and the counter deltas
  must be equal, and each scenario's own assertions hold on both.

Waits are events and timeouts of at most ``WAIT`` seconds, and every
test has an alarm of ``LIMIT`` seconds, so a hang fails its test.
"""

import signal
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX's dispatcher imports it on its thread)
import gansformer_tpu.serve as jax_serve
from gansformer_tpu.obs import registry as jax_registry
from gansformer_tpu.obs import reqtrace as jax_reqtrace
from gansformer_tpu.supervise import faults as jax_faults
import gansformer_tpu_torch.serve as port_serve
from gansformer_tpu_torch.obs import registry as port_registry
from gansformer_tpu_torch.obs import reqtrace as port_reqtrace
from gansformer_tpu_torch.supervise import faults as port_faults
from gansformer_tpu_torch.serve import (GenerationService, ServePrograms,
                                        WCache, init_generator, map_rows)
from tests.test_torch_serve import TINY

WAIT = 2.0
LIMIT = 20
# a row's image at bucket 1 against the same row at another bucket: the
# host GEMM's blocking follows the batch size (max |diff| 6.7e-6 at this
# width, images in [-1, 1] scale)
CROSS_BUCKET_TOL = 5e-5
COUNTERS = ("serve/requests_total", "serve/images_total",
            "serve/shed_total", "serve/expired_total",
            "serve/cancelled_total", "serve/dispatcher_restarts_total",
            "serve/bucket_quarantined_total", "serve/map_dispatch_total",
            "serve/synth_dispatch_total", "serve/wcache_hits_total",
            "serve/wcache_misses_total")


@pytest.fixture(autouse=True)
def time_limit():
    """SIGALRM after ``LIMIT`` s fails the test instead of the run."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def on_alarm(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT} s limit")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(LIMIT)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Micro-width ops gain nothing from torch's thread pool, and six
    test workers sharing the host's cores make it a cost."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bundle():
    """TINY with live noise and a real truncation anchor (a random init
    zeroes noise strengths, which would make noise parity trivial)."""
    b = init_generator(TINY, seed=5, device="cpu")
    with torch.no_grad():
        for name, p in b.generator.named_parameters():
            if name.endswith("noise_strength") or name.endswith("_gate"):
                p.fill_(0.3)
        b.w_avg.copy_(torch.from_numpy(
            np.random.RandomState(0).normal(size=TINY.w_dim)
            .astype(np.float32)))
    p = ServePrograms(b, buckets=(1, 2, 4))
    p.synthesize(p.map_seeds([1]), [0.7])          # the first call's cost
    return b


def wait_until(cond, what):
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


# -- the two packages --------------------------------------------------------

class JaxStandIn:
    """JAX ``ServePrograms``' surface in numpy: counts its dispatches as
    the real one does, compiles nothing."""

    def __init__(self, buckets):
        self.buckets = tuple(buckets)
        self.bundle = SimpleNamespace(cfg=SimpleNamespace(
            model=SimpleNamespace(label_dim=0)))
        self.manifest_stale = self.warm_hits = 0

    def is_compiled(self, kind, bucket):
        return True

    def map_seeds(self, seeds, label=None):
        jax_registry.counter("serve/map_dispatch_total").inc()
        return np.asarray(seeds, np.float32)[:, None, None] * np.ones(
            (1, 2, 4), np.float32)

    def synthesize(self, ws, psi, rng, tags=None):
        jax_registry.counter("serve/synth_dispatch_total").inc()
        v = np.asarray(ws)[:, 0, 0] * np.asarray(psi, np.float32)
        return np.broadcast_to(v[:, None, None, None],
                               (len(v), 4, 4, 3)).copy()


class Hooked:
    """Programs of either package with the tests' hooks: synthesis held
    on a gate, a mapping that raises, a poisoned synthesis bucket."""

    def __init__(self, inner, gate=None, boom_map=False, poison=None):
        self._inner = inner
        self._gate, self._boom, self._poison = gate, boom_map, poison

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def map_seeds(self, *a, **k):
        if self._boom:
            raise RuntimeError("device on fire")
        return self._inner.map_seeds(*a, **k)

    def synthesize(self, ws, *a, **k):
        if self._gate is not None:
            self._gate.wait(WAIT)
        if ws.shape[0] == self._poison:
            raise RuntimeError(f"bucket-{self._poison} program poisoned")
        return self._inner.synthesize(ws, *a, **k)


def packages(bundle):
    return {
        "jax": SimpleNamespace(
            serve=jax_serve, faults=jax_faults, registry=jax_registry,
            programs=lambda buckets, **kw: Hooked(JaxStandIn(buckets), **kw)),
        "port": SimpleNamespace(
            serve=port_serve, faults=port_faults, registry=port_registry,
            programs=lambda buckets, **kw: Hooked(
                ServePrograms(bundle, buckets=buckets), **kw)),
    }


def outcome(t):
    """A ticket's state and what ``result`` gives (without waiting)."""
    try:
        t.result(timeout=0)
        got = "image"
    except BaseException as e:  # noqa: BLE001
        got = type(e).__name__ + (f"<{type(e.__cause__).__name__}"
                                  if e.__cause__ is not None else "")
    return (t.state, got)


class Run:
    """One scenario on one package: its service, faults and counters."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.before = {c: pkg.registry.counter(c).value for c in COUNTERS}
        self.svc = None

    def service(self, programs, **kw):
        self.svc = self.pkg.serve.GenerationService(programs, **kw)
        return self.svc

    def arm(self, spec):
        self.pkg.faults.arm(self.pkg.faults.parse_specs(spec))

    def deltas(self):
        return {c: self.pkg.registry.counter(c).value - self.before[c]
                for c in COUNTERS}


def scenario(name, bundle):
    """Run ``name`` on both packages; the port's and JAX's records."""
    out = {}
    for pkg_name, pkg in packages(bundle).items():
        run = Run(pkg)
        try:
            record = SCENARIOS[name](run, pkg)
        finally:
            pkg.faults.disarm()
            if run.svc is not None and name != "close_past_grace":
                run.svc.close(timeout=WAIT)
        out[pkg_name] = (record, run.deltas())
    return out


def busy(svc):
    wait_until(lambda: not svc._pending and svc._busy_since is not None,
               "the first batch in flight")


# -- the scenarios (tests/test_serve.py's, one each) -------------------------

def crash_trips_breaker(run, pkg):
    s = pkg.serve
    svc = run.service(pkg.programs((1,), boom_map=True),
                      max_fill_wait_ms=0.0, max_dispatcher_restarts=0,
                      restart_backoff_base_s=0.01)
    t = svc.submit(1)
    with pytest.raises(RuntimeError, match="generation request failed"):
        t.result(timeout=WAIT)
    wait_until(lambda: svc.health()["state"] == "unhealthy", "the trip")
    for _ in range(2):
        with pytest.raises(s.ServiceUnhealthy, match="circuit breaker"):
            svc.submit(2)
    assert pkg.registry.gauge("serve/health_state").value == 2
    assert not svc.health()["dispatcher_alive"]
    return [outcome(t)]


def self_heals(run, pkg):
    run.arm("raise@serve_dispatch:batch=2")
    svc = run.service(pkg.programs((1, 2, 4)), max_fill_wait_ms=0.0,
                      restart_backoff_base_s=0.01)
    t1 = svc.submit(881)
    t1.result(timeout=WAIT)
    t2 = svc.submit(882)
    with pytest.raises(RuntimeError, match="generation request failed"):
        t2.result(timeout=WAIT)
    t3 = svc.submit(883)
    t3.result(timeout=WAIT)
    h = svc.health()
    assert h["state"] == "degraded" and h["dispatcher_restarts"] == 1
    assert any("restart" in r for r in h["reasons"])
    return [outcome(t) for t in (t1, t2, t3)]


def breaker_budget(run, pkg):
    s = pkg.serve
    svc = run.service(pkg.programs((1,), boom_map=True),
                      max_fill_wait_ms=0.0, max_dispatcher_restarts=2,
                      restart_backoff_base_s=0.01)
    tickets = []
    for seed in range(1, 4):
        try:
            tickets.append(svc.submit(seed))
        except s.ServiceUnhealthy:
            break
        with pytest.raises(RuntimeError):
            tickets[-1].result(timeout=WAIT)
    wait_until(lambda: svc.health()["state"] == "unhealthy", "the trip")
    with pytest.raises(s.ServiceUnhealthy, match="circuit breaker"):
        svc.submit(9)
    return [outcome(t) for t in tickets]


def back_to_back(run, pkg):
    run.arm("raise@serve_dispatch:batch=2,raise@serve_dispatch:batch=4")
    svc = run.service(pkg.programs((1, 2, 4)), max_fill_wait_ms=0.0,
                      max_dispatcher_restarts=1,
                      restart_backoff_base_s=0.01)
    tickets = []
    for seed in (771, 772, 773, 774, 775):
        tickets.append(svc.submit(seed))
        try:
            tickets[-1].result(timeout=WAIT)
        except RuntimeError:
            pass
    h = svc.health()
    assert h["state"] == "degraded" and h["dispatcher_restarts"] == 2, h
    tickets.append(svc.submit(776))
    assert np.isfinite(np.float32(tickets[-1].result(timeout=WAIT))).all()
    return [outcome(t) for t in tickets]


def hung(run, pkg):
    s = pkg.serve
    run.arm("hang@serve_dispatch:batch=1")
    svc = run.service(pkg.programs((1, 2, 4)), max_fill_wait_ms=0.0,
                      restart_backoff_base_s=0.01, hang_after_s=0.3,
                      hang_startup_grace_s=0.3)
    t1 = svc.submit(771)
    with pytest.raises(s.ServiceUnhealthy, match="hung"):
        t1.result(timeout=WAIT)
    t2 = svc.submit(772)
    assert np.isfinite(np.float32(t2.result(timeout=WAIT))).all()
    assert svc.health()["dispatcher_restarts"] == 1
    return [outcome(t) for t in (t1, t2)]


def overload(run, pkg):
    s = pkg.serve
    gate = threading.Event()
    svc = run.service(pkg.programs((1, 2, 4), gate=gate),
                      max_fill_wait_ms=0.0, max_queue_depth=4)
    try:
        first = svc.submit(10)
        busy(svc)
        accepted = [svc.submit(11 + i) for i in range(4)]
        for i in range(12):
            with pytest.raises(s.Overloaded, match="shed"):
                svc.submit(100 + i)
        h = svc.health()
        assert h["state"] == "degraded"
        assert any("saturated" in r for r in h["reasons"])
        gate.set()
        for t in [first] + accepted:
            t.result(timeout=WAIT)
    finally:
        gate.set()
    svc.close(timeout=WAIT)
    assert svc.health()["queue_depth"] == 0
    return [outcome(t) for t in [first] + accepted]


def expired(run, pkg):
    s = pkg.serve
    gate = threading.Event()
    svc = run.service(pkg.programs((1, 2), gate=gate),
                      max_fill_wait_ms=0.0)
    try:
        t1 = svc.submit(331)
        busy(svc)
        t2 = svc.submit(332, deadline_s=0.02)
        time.sleep(0.1)                    # t2 expires in the queue
        gate.set()
        t1.result(timeout=WAIT)
        with pytest.raises(s.Expired, match="deadline"):
            t2.result(timeout=WAIT)
    finally:
        gate.set()
    return [outcome(t) for t in (t1, t2)]


def client_timeout(run, pkg):
    s = pkg.serve
    gate = threading.Event()
    svc = run.service(pkg.programs((1, 2), gate=gate),
                      max_fill_wait_ms=0.0)
    try:
        t1 = svc.submit(441)
        busy(svc)
        t2 = svc.submit(442)
        with pytest.raises(TimeoutError):
            t2.result(timeout=0.05)
        assert t2.state == "cancelled"
        gate.set()
        t1.result(timeout=WAIT)
        t3 = svc.submit(443)               # drives the queue past t2
        t3.result(timeout=WAIT)
        with pytest.raises(s.Cancelled):
            t2.result(timeout=WAIT)
    finally:
        gate.set()
    return [outcome(t) for t in (t1, t2, t3)]


def dead_slots(run, pkg):
    gate = threading.Event()
    svc = run.service(pkg.programs((1, 2), gate=gate),
                      max_fill_wait_ms=0.0, max_queue_depth=3)
    try:
        t1 = svc.submit(901)
        busy(svc)
        queued = [svc.submit(902 + i) for i in range(3)]
        for t in queued:
            with pytest.raises(TimeoutError):
                t.result(timeout=0.01)
        t_live = svc.submit(909)          # compaction frees the slots
        gate.set()
        t_live.result(timeout=WAIT)
        t1.result(timeout=WAIT)
    finally:
        gate.set()
    return [outcome(t) for t in [t1] + queued + [t_live]]


def quarantine(run, pkg):
    svc = run.service(pkg.programs((1, 2), poison=1),
                      max_fill_wait_ms=0.0, max_dispatcher_restarts=5,
                      restart_backoff_base_s=0.01, quarantine_after=2)
    tickets = []
    for seed in (551, 552):
        tickets.append(svc.submit(seed))
        with pytest.raises(RuntimeError, match="generation request failed"):
            tickets[-1].result(timeout=WAIT)
    tickets.append(svc.submit(553))       # rerouted to bucket 2
    assert np.isfinite(np.float32(tickets[-1].result(timeout=WAIT))).all()
    h = svc.health()
    assert h["quarantined_buckets"] == [1]
    assert any("quarantined" in r for r in h["reasons"])
    return [outcome(t) for t in tickets]


def drain(run, pkg):
    svc = run.service(pkg.programs((1, 2, 4)), max_fill_wait_ms=0.0)
    tickets = [svc.submit(600 + i) for i in range(8)]
    svc.close(timeout=WAIT)
    assert all(t.state == "done" for t in tickets)
    assert not svc._worker.alive and not svc._monitor.is_alive()
    assert pkg.registry.gauge("serve/queue_depth_now").value == 0
    assert svc.health()["state"] == "closed"
    assert pkg.registry.gauge("serve/health_state").value == 3
    with pytest.raises(pkg.serve.ServiceClosed, match="closed"):
        svc.submit(1)
    return [outcome(t) for t in tickets]


def close_past_grace(run, pkg):
    gate = threading.Event()
    svc = run.service(pkg.programs((1, 2), gate=gate),
                      max_fill_wait_ms=0.0)
    try:
        t1 = svc.submit(661)
        busy(svc)
        queued = [svc.submit(662 + i) for i in range(3)]
        svc.close(timeout=0.3)             # the gate is shut: no drain
        with pytest.raises(pkg.serve.ServiceClosed):
            queued[-1].result(timeout=WAIT)
        assert svc.health()["state"] == "unhealthy"
    finally:
        gate.set()
    return [outcome(t) for t in [t1] + queued]


def close_after_death(run, pkg):
    svc = run.service(pkg.programs((1,), boom_map=True),
                      max_fill_wait_ms=0.0, max_dispatcher_restarts=5,
                      restart_backoff_base_s=60.0)
    t1 = svc.submit(1)
    with pytest.raises(RuntimeError, match="generation request failed"):
        t1.result(timeout=WAIT)
    queued = [svc.submit(2), svc.submit(3)]
    svc.close(timeout=0.5)
    for t in queued:
        with pytest.raises(pkg.serve.ServiceClosed, match="closed"):
            t.result(timeout=WAIT)
    return [outcome(t) for t in [t1] + queued]


def close_refuses(run, pkg):
    svc = run.service(pkg.programs((1, 2, 4)), max_fill_wait_ms=0.0)
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(1)
    return [svc.health()["state"]]


SCENARIOS = {f.__name__: f for f in (
    crash_trips_breaker, self_heals, breaker_budget, back_to_back, hung,
    overload, expired, client_timeout, dead_slots, quarantine, drain,
    close_past_grace, close_after_death, close_refuses)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_robustness_equals_jax(name, bundle):
    got = scenario(name, bundle)
    (port_record, port_deltas), (jax_record, jax_deltas) = \
        got["port"], got["jax"]
    assert port_record == jax_record
    # the w cache's pair counts rows the way JAX's service does
    assert port_deltas == jax_deltas


# -- images ------------------------------------------------------------------

def serve_stream(bundle, buckets, fill_wait_ms, seeds, psis):
    """The stream through one service; each ticket's image and batch."""
    programs = ServePrograms(bundle, buckets=buckets)
    with GenerationService(programs, max_fill_wait_ms=fill_wait_ms,
                           noise_seed=11) as svc:
        tickets = [svc.submit(s, psi=p) for s, p in zip(seeds, psis)]
        images = [t.result(timeout=WAIT) for t in tickets]
    rows = {r["rid"]: r for r in port_reqtrace.get_reqtracer().recent()}
    batches = {}
    for t, img in zip(tickets, images):
        batches.setdefault(rows[t.rid]["batch"], []).append((t, img))
    return programs, [batches[b] for b in sorted(batches)]


@pytest.mark.parametrize("buckets,fill_wait_ms", [((1, 2, 4), 0.0),
                                                  ((1, 2, 4), 30.0),
                                                  ((4,), 10.0)])
def test_stream_equals_its_batches_through_map_rows(bundle, buckets,
                                                    fill_wait_ms):
    """Every batch the service formed, replayed through ``map_rows`` (one
    w cache across the replay, as the service's) and ``synthesize`` at
    its bucket with the request seeds as tags, gives the service's images
    bit for bit; and each image is the request alone at bucket 1 within
    ``CROSS_BUCKET_TOL``."""
    rng = np.random.RandomState(len(buckets) + int(fill_wait_ms))
    seeds = [int(s) for s in rng.choice([3, 5, 8, 13, 21, 34], size=14)]
    psis = [float(p) for p in rng.choice([0.5, 0.7, 1.0], size=14)]
    programs, batches = serve_stream(bundle, buckets, fill_wait_ms, seeds,
                                     psis)
    assert sum(len(b) for b in batches) == 14
    if fill_wait_ms:
        assert any(len(b) > 1 for b in batches)
    cache = WCache()
    for batch in batches:
        n = len(batch)
        bucket = min(b for b in programs.buckets if b >= n)
        ws = map_rows(programs, cache, [t.seed for t, _ in batch])
        ws = torch.cat([ws, ws[-1:].expand(bucket - n, *ws.shape[1:])])
        tags = [t.seed for t, _ in batch] + [batch[-1][0].seed] * (
            bucket - n)
        ref = programs.synthesize(
            ws, [t.psi for t, _ in batch] + [1.0] * (bucket - n), seed=11,
            tags=tags)[:n].numpy()
        for i, (t, img) in enumerate(batch):
            assert img.dtype == np.float32 and img.shape == (16, 16, 3)
            np.testing.assert_array_equal(img, ref[i])
    solo = ServePrograms(bundle, buckets=(1,))
    for batch in batches:
        for t, img in batch:
            one = solo.synthesize(solo.map_seeds([t.seed]), [t.psi],
                                  seed=11, tags=[t.seed])[0].numpy()
            np.testing.assert_allclose(img, one, rtol=0,
                                       atol=CROSS_BUCKET_TOL)


def test_rows_of_two_buckets_differ_only_in_the_last_bits(bundle):
    """The reason for ``CROSS_BUCKET_TOL``: the same row (seed, psi, tag)
    at bucket 1 and at bucket 4 on this host, with the largest
    difference printed (``-s``)."""
    p = ServePrograms(bundle, buckets=(1, 4))
    ws = p.map_seeds([7, 8, 9, 10])
    four = p.synthesize(ws, [0.7, 0.5, 1.0, 0.7], seed=11,
                        tags=[7, 8, 9, 10])
    one = p.synthesize(p.map_seeds([7]), [0.7], seed=11, tags=[7])
    assert torch.equal(ws[:1], p.map_seeds([7]))      # mapping: bit-stable
    diff = float((four[0] - one[0]).abs().max())
    print(f"bucket 1 vs 4, row 0: max |diff| {diff:.3e}")
    assert diff <= CROSS_BUCKET_TOL
    other = p.synthesize(p.map_seeds([7]), [0.7], seed=11, tags=[8])
    assert float((other - one).abs().max()) > 100 * CROSS_BUCKET_TOL


def test_the_dispatcher_thread_infers_without_autograd(bundle):
    """The dispatcher enters inference mode on its own thread: the
    programs it calls see it, even called from a thread that has grad
    on."""
    seen = []
    programs = ServePrograms(bundle, buckets=(1, 2))
    inner = programs.synthesize

    def spy(*a, **k):
        seen.append((torch.is_inference_mode_enabled(),
                     threading.current_thread().name))
        return inner(*a, **k)

    programs.synthesize = spy
    with torch.enable_grad(), GenerationService(programs) as svc:
        svc.submit(4).result(timeout=WAIT)
    assert seen == [(True, "serve/dispatch-loop")]


def test_gauges_of_a_replica_member_and_the_signal_drain(bundle):
    """``replica_id`` moves the liveness gauges to ``serve/replica<i>/``;
    the SIGTERM drain installs only on the main thread."""
    programs = ServePrograms(bundle, buckets=(1, 2))
    svc = GenerationService(programs, replica_id=3, max_queue_depth=5)
    try:
        svc.submit(2).result(timeout=WAIT)
        assert port_registry.gauge(
            "serve/replica3/queue_bound").value == 5
        assert port_registry.counter(
            "serve/replica3/images_total").value >= 1
        assert svc.health()["replica_id"] == 3
        res = []
        th = threading.Thread(
            target=lambda: res.append(svc.install_signal_drain(1.0)))
        th.start()
        th.join(WAIT)
        assert res == [False]
    finally:
        svc.close(timeout=WAIT)
    assert port_registry.gauge("serve/replica3/health_state").value == 3


def test_trace_lifecycle_of_served_requests(bundle):
    """Every served request's trace runs submitted → fulfilled through the
    dispatch events, a hit carrying ``wcache_hit`` and a miss
    ``map_dispatch``, as JAX's service emits them."""
    programs = ServePrograms(bundle, buckets=(1, 2))
    with GenerationService(programs, max_fill_wait_ms=0.0) as svc:
        t1 = svc.submit(61)
        t1.result(timeout=WAIT)
        t2 = svc.submit(61)
        t2.result(timeout=WAIT)
    rows = {r["rid"]: r for r in port_reqtrace.get_reqtracer().recent()}
    kinds = [[e["kind"] for e in rows[t.rid]["events"]] for t in (t1, t2)]
    assert kinds[0] == ["submitted", "admitted", "popped", "batched",
                        "map_dispatch", "synth", "fetch", "fulfilled"]
    assert kinds[1] == ["submitted", "admitted", "popped", "batched",
                        "wcache_hit", "synth", "fetch", "fulfilled"]
    assert jax_reqtrace.EVENT_KINDS == port_reqtrace.EVENT_KINDS


class PortStandIn:
    """The port's programs' surface on tensors of a few numbers: the
    service's bookkeeping without the generator's cost."""

    def __init__(self, buckets):
        self.buckets = tuple(buckets)
        self.device = torch.device("cpu")
        self.bundle = SimpleNamespace(cfg=SimpleNamespace(label_dim=0))

    def map_seeds(self, seeds, label=None):
        port_registry.counter("serve/map_dispatch_total").inc()
        return torch.tensor(seeds, dtype=torch.float32)[:, None, None] \
            .expand(-1, 2, 4).clone()

    def synthesize(self, ws, psi, seed=0, tags=None):
        port_registry.counter("serve/synth_dispatch_total").inc()
        time.sleep(0.001)
        v = ws[:, 0, 0] * torch.tensor(psi, dtype=torch.float32)
        return v[:, None, None, None].expand(-1, 4, 4, 3).clone()


def test_concurrent_clients_lose_no_update():
    """Sixteen client threads (more than the host's cores) submit, cancel
    and let deadlines lapse against one service while the interpreter
    switches threads every microsecond: every ticket resolves exactly
    once, its image is its own seed's, and the counters add up."""
    import sys

    svc = GenerationService(PortStandIn((1, 2, 4, 8)), max_fill_wait_ms=0.5,
                            max_queue_depth=12)
    before = {c: port_registry.counter(c).value for c in COUNTERS}
    tickets, shed, lock = [], [0], threading.Lock()

    def client(k):
        for i in range(12):
            seed = 1000 * k + i
            time.sleep(0.002)
            try:
                t = svc.submit(seed, psi=1.0,
                               deadline_s=0.0 if i % 5 == 4 else None)
            except port_serve.Overloaded:
                with lock:
                    shed[0] += 1
                continue
            if i % 7 == 3:
                t.cancel()
            with lock:
                tickets.append(t)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(WAIT * 5)
        assert not any(th.is_alive() for th in threads)
        svc.close(timeout=WAIT * 5)
    finally:
        sys.setswitchinterval(old)
    assert not svc._worker.alive and not svc._monitor.is_alive()
    d = {c: port_registry.counter(c).value - before[c] for c in COUNTERS}
    states = {}
    for t in tickets:
        assert t.state in ("done", "failed", "cancelled"), t.state
        states[t.state] = states.get(t.state, 0) + 1
        if t.state == "done":
            assert float(t.result(timeout=0)[0, 0, 0]) == t.seed
    assert len(tickets) + shed[0] == 16 * 12
    assert d["serve/requests_total"] == len(tickets)
    assert d["serve/shed_total"] == shed[0] > 0
    assert d["serve/images_total"] == states.get("done", 0) > 0
    assert d["serve/expired_total"] == states.get("failed", 0)
    assert d["serve/cancelled_total"] == states.get("cancelled", 0)
    assert port_registry.gauge("serve/queue_depth_now").value == 0
