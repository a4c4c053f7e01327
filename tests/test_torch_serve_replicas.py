"""The port's replica fleet (``gansformer_tpu_torch/serve/replicas.py``) on
the CPU, at the serve tests' micro width, with its members placed by
``devices=[cpu] * N``.  One test for each of the JAX package's tests in
``tests/test_serve_replicas.py``, and the port's own:

* **Placement never enters the random path.**  A stream through one
  replica and through two: every batch a member formed, replayed through
  ``map_rows`` + ``synthesize`` with that member's w cache, gives its
  images bit for bit, and every image is its request alone at bucket 1
  within ``CROSS_BUCKET_TOL`` (``tests/test_torch_serve_service.py``
  shows why a bucket's GEMM differs in the last bits).
* **Routing.**  The router walks past a tripped member and counts each
  routed request on that member's ``requests_total``.
* **The autoscaler.**  One tick script (``_autoscale_tick(now=…)`` over
  synthesis held on a gate) through the port's ``ReplicaSet`` and JAX's,
  the programs stand-ins in each package (numpy on JAX's side: nothing
  compiles; JAX's members are the conftest's virtual devices): the same
  actions, event kinds and counter deltas.
* **Telemetry.**  A fleet's prom passes the port's and JAX's fleet
  schema and both healthchecks alike; the liveness helpers equal JAX's.
* **Copies of the bundle.**  A member on another device gets its own
  deep copy: the caller's bundle stays where it was, unchanged, and
  members on one device share one copy (the meta device stands in for a
  second card).

Waits are events and timeouts of at most ``WAIT`` seconds, under an
alarm of ``LIMIT`` seconds per test.
"""

import json
import signal
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import gansformer_tpu.serve.replicas as jax_replicas
from gansformer_tpu.obs import registry as jax_registry
from gansformer_tpu_torch.cli import serve as port_cli
from gansformer_tpu_torch.cli.loadtest_serve import \
    check_serve_metric_families
from gansformer_tpu_torch.obs import registry as port_registry
from gansformer_tpu_torch.obs import reqtrace as port_reqtrace
from gansformer_tpu_torch.serve import (Overloaded, ReplicaSet,
                                        ServePrograms, ServiceUnhealthy,
                                        WCache, init_generator, map_rows)
import gansformer_tpu_torch.serve.replicas as port_replicas
from tests.test_torch_serve import TINY
from tests.test_torch_serve_service import (CROSS_BUCKET_TOL, Hooked,
                                            JaxStandIn, PortStandIn)
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

WAIT = 2.0
LIMIT = 20
CPU = torch.device("cpu")


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


@pytest.fixture(scope="module")
def bundle():
    """TINY with live noise (a random init zeroes noise strengths, which
    would make the noise's placement trivially right)."""
    b = init_generator(TINY, seed=5, device="cpu")
    with torch.no_grad():
        for name, p in b.generator.named_parameters():
            if name.endswith("noise_strength") or name.endswith("_gate"):
                p.fill_(0.3)
    return b


def wait_until(cond, what):
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


# -- placement never enters the random path ---------------------------------

def serve_stream(bundle, n, seeds, psis):
    """The stream through ``n`` replicas on the host: (request IDs, image
    by request ID, programs by member, [(member, its batch of (ticket,
    image))] in batch order)."""
    routed = {}
    with ReplicaSet(bundle, buckets=(1, 2, 4), devices=[CPU] * n,
                    replicas=n, service_kwargs=dict(max_fill_wait_ms=5.0,
                                                    noise_seed=11)) as rs:
        for r in rs.active_replicas:
            got = routed[r.ordinal] = []
            submit = r.service.submit

            def spy(*a, _submit=submit, _got=got, **k):
                t = _submit(*a, **k)
                _got.append(t)
                return t

            r.service.submit = spy
        tickets = [rs.submit(s, psi=p) for s, p in zip(seeds, psis)]
        images = {t.rid: t.result(timeout=WAIT) for t in tickets}
        programs = {r.ordinal: r.programs for r in rs.active_replicas}
    rows = {r["rid"]: r for r in port_reqtrace.get_reqtracer().recent()}
    batches = {}
    for ordinal, got in routed.items():
        for t in got:
            batches.setdefault((ordinal, rows[t.rid]["batch"]), []).append(
                (t, images[t.rid]))
    return ([t.rid for t in tickets], images, programs,
            [(k[0], batches[k]) for k in sorted(batches)])


@pytest.mark.parametrize("n", [1, 2])
def test_one_vs_two_replica_streams_match(bundle, n):
    """The same stream through 1 and 2 replicas: every member's batches,
    replayed through its own w cache and programs, give its images bit
    for bit, and each image is its request alone within
    ``CROSS_BUCKET_TOL`` (JAX holds the two placements bit for bit; the
    host's GEMM is not bit-stable across buckets)."""
    rng = np.random.RandomState(7)
    seeds = [int(s) for s in rng.choice([3, 5, 8, 13, 21], size=12)]
    psis = [float(p) for p in rng.choice([0.5, 0.7, 1.0], size=12)]
    rids, images, programs, batches = serve_stream(bundle, n, seeds, psis)
    assert sum(len(b) for _, b in batches) == 12
    assert {o for o, _ in batches} == set(range(n))
    caches = {o: WCache() for o in programs}
    for ordinal, batch in batches:
        progs = programs[ordinal]
        m = len(batch)
        bucket = min(b for b in progs.buckets if b >= m)
        ws = map_rows(progs, caches[ordinal], [t.seed for t, _ in batch])
        ws = torch.cat([ws, ws[-1:].expand(bucket - m, *ws.shape[1:])])
        tags = [t.seed for t, _ in batch] + [batch[-1][0].seed] * (
            bucket - m)
        ref = progs.synthesize(
            ws, [t.psi for t, _ in batch] + [1.0] * (bucket - m), seed=11,
            tags=tags)[:m].numpy()
        for i, (t, img) in enumerate(batch):
            np.testing.assert_array_equal(img, ref[i])
    solo = ServePrograms(bundle, buckets=(1,))
    for rid, s, p in zip(rids, seeds, psis):
        one = solo.synthesize(solo.map_seeds([s]), [p], seed=11,
                              tags=[s])[0].numpy()
        np.testing.assert_allclose(images[rid], one, rtol=0,
                                   atol=CROSS_BUCKET_TOL)


# -- routing -----------------------------------------------------------------

def test_router_skips_tripped_replica_and_counts_dispatch(bundle):
    with ReplicaSet(bundle, buckets=(1, 2), devices=[CPU] * 2,
                    replicas=2) as rs:
        r0, r1 = rs.active_replicas
        c1 = port_registry.counter("serve/replica1/requests_total").value
        with r0.service._cv:
            r0.service._tripped = True     # member 0's breaker is open
        assert rs.submit(77).result(timeout=WAIT) is not None
        assert port_registry.counter(
            "serve/replica1/requests_total").value == c1 + 1
        assert rs.health()["state"] == "ready", \
            "the fleet's health is its healthiest member's"
        with r1.service._cv:
            r1.service._tripped = True
        with pytest.raises(ServiceUnhealthy):
            rs.submit(78)
        for r in (r0, r1):                 # so that close() drains
            with r.service._cv:
                r.service._tripped = False


def test_a_refusal_walks_on_and_the_last_one_propagates():
    """A member that sheds is walked past; when every member refuses, the
    last typed refusal propagates."""
    gate = threading.Event()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_replicas, "ServePrograms",
                   lambda bundle, buckets, **kw: Hooked(
                       PortStandIn(buckets), gate=gate))
        rs = ReplicaSet(_stand_in_bundle(), buckets=(1,),
                        devices=[CPU] * 2, replicas=2,
                        service_kwargs=dict(max_fill_wait_ms=0.0,
                                            max_queue_depth=1))
    try:
        tickets = [rs.submit(1, psi=1.0)]
        wait_until(lambda: rs.active_replicas[0].service._inflight,
                   "member 0 busy")
        tickets.append(rs.submit(2, psi=1.0))       # member 1, least loaded
        wait_until(lambda: rs.active_replicas[1].service._inflight,
                   "member 1 busy")
        tickets += [rs.submit(3, psi=1.0), rs.submit(4, psi=1.0)]
        with pytest.raises(Overloaded):
            rs.submit(5)
        gate.set()
        assert [float(t.result(timeout=WAIT)[0, 0, 0]) for t in tickets] \
            == [1.0, 2.0, 3.0, 4.0]
    finally:
        gate.set()
        rs.close(timeout=WAIT)


# -- the autoscaler, against JAX's -------------------------------------------

def _stand_in_bundle():
    return SimpleNamespace(device=CPU, cfg=SimpleNamespace(label_dim=0))


def tick_script(pkg):
    """One deterministic controller drill: member 0 held on a gate with
    its queue at the bound scales out after two saturated ticks; a
    request then goes to the new member; with the gate open and the
    queues drained, two idle ticks after the cooldown scale back in, and
    ticks at the floor do nothing.  Returns (actions, event kinds, counter
    deltas)."""
    gate = threading.Event()
    names = ("serve/scale_out_total", "serve/scale_in_total",
             "serve/replica0/requests_total", "serve/replica1/requests_total",
             "serve/shed_total", "serve/images_total")
    before = {n: pkg.registry.counter(n).value for n in names}
    with pytest.MonkeyPatch.context() as mp:
        # members made at a scale-out take the stand-ins too
        mp.setattr(pkg.replicas, "ServePrograms",
                   lambda bundle, buckets, **kw: Hooked(
                       pkg.stand_in(buckets), gate=gate))
        rs = pkg.replicas.ReplicaSet(
            pkg.bundle, buckets=(1, 2), manifest_dir=None, replicas=1,
            min_replicas=1, max_replicas=2, autoscale=False,
            scale_out_saturation=0.8, scale_out_ticks=2, scale_in_fill=0.5,
            scale_in_ticks=2, cooldown_s=1.5,
            service_kwargs=dict(max_fill_wait_ms=0.0, max_queue_depth=2),
            **pkg.placement)
        actions = []
        try:
            tickets = [rs.submit(101)]
            wait_until(lambda: rs.active_replicas[0].service._inflight,
                       "member 0 busy")
            tickets += [rs.submit(102), rs.submit(103)]   # at the bound
            with pytest.raises(pkg.Overloaded):
                rs.submit(104)
            for now in (1.0, 2.0, 2.5):
                actions.append(rs._autoscale_tick(now=now))
            tickets.append(rs.submit(105))                # the new member
            gate.set()
            for t in tickets:
                t.result(timeout=WAIT)
            for r in rs.active_replicas:
                wait_until(lambda r=r: not r.service.load(), "drained")
            for now in (3.0, 4.0, 5.0, 6.0, 7.0):
                actions.append(rs._autoscale_tick(now=now))
            n_active = rs.n_active
            kinds = [e["kind"] for e in rs.events]
        finally:
            gate.set()
            rs.close(timeout=WAIT)
    return (actions, kinds, n_active,
            {n: pkg.registry.counter(n).value - before[n] for n in names})


def test_autoscaler_scales_out_on_saturation_then_in_on_idle():
    """The tick script through the port's ``ReplicaSet`` and through
    JAX's: the same actions, event kinds, members and counter deltas."""
    import gansformer_tpu.serve as jax_serve
    import gansformer_tpu_torch.serve as port_serve

    got = {
        "port": tick_script(SimpleNamespace(
            replicas=port_replicas, registry=port_registry,
            Overloaded=port_serve.Overloaded, stand_in=PortStandIn,
            bundle=_stand_in_bundle(),
            placement=dict(devices=[CPU] * 2))),
        "jax": tick_script(SimpleNamespace(
            replicas=jax_replicas, registry=jax_registry,
            Overloaded=jax_serve.Overloaded, stand_in=JaxStandIn,
            bundle=None, placement={})),
    }
    assert got["port"] == got["jax"]
    actions, kinds, n_active, deltas = got["port"]
    assert actions == [None, "out", None, None, None, "in", None, None]
    assert kinds == ["scale_out", "scale_in"] and n_active == 1
    assert deltas == {"serve/scale_out_total": 1, "serve/scale_in_total": 1,
                      "serve/replica0/requests_total": 3,
                      "serve/replica1/requests_total": 1,
                      "serve/shed_total": 1, "serve/images_total": 4}


# -- telemetry ---------------------------------------------------------------

def test_fleet_prom_passes_schema_and_healthcheck(bundle, tmp_path,
                                                  capsys):
    """A two-member fleet's prom passes the port's fleet schema and JAX's;
    the port's ``--healthcheck`` grades it as JAX's does."""
    from gansformer_tpu.analysis.telemetry_schema import \
        check_serve_metric_families as jax_check
    from gansformer_tpu.cli.serve import healthcheck as jax_healthcheck

    with ReplicaSet(bundle, buckets=(1, 2), devices=[CPU] * 2,
                    replicas=2) as rs:
        tickets = [rs.submit(s) for s in (21, 22, 23, 24)]
        for t in tickets:
            t.result(timeout=WAIT)
        rs.health()
    prom = str(tmp_path / "telemetry.prom")
    port_registry.get_registry().write_prom(prom)
    assert check_serve_metric_families(prom) == [] == jax_check(prom)
    capsys.readouterr()
    assert port_cli.main(["--healthcheck", str(tmp_path)]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_healthcheck(str(tmp_path)) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got.pop("snapshot_age_s")
    want.pop("snapshot_age_s")
    assert got == want
    assert got["ok"] and got["replicas"] == 0.0 and \
        got["scale_out_total"] is not None


FLEETS = {
    "one_dead_with_work": {"serve_replicas": 2.0,
                           "serve_replica0_dispatcher_alive": 0.0,
                           "serve_replica0_queue_depth_now": 3.0,
                           "serve_replica1_dispatcher_alive": 1.0,
                           "serve_replica1_queue_depth_now": 0.0},
    "all_dead_with_work": {"serve_replicas": 2.0,
                           "serve_replica0_dispatcher_alive": 0.0,
                           "serve_replica0_queue_depth_now": 3.0,
                           "serve_replica1_dispatcher_alive": 0.0},
    "all_dead_idle": {"serve_replicas": 2.0,
                      "serve_replica0_dispatcher_alive": 0.0,
                      "serve_replica1_dispatcher_alive": 0.0},
    "solo_dead_with_work": {"serve_dispatcher_alive": 0.0,
                            "serve_queue_depth_now": 2.0},
    "solo_alive": {"serve_dispatcher_alive": 1.0},
}


@pytest.mark.parametrize("case", sorted(FLEETS))
def test_fleet_liveness_helpers_are_value_level(case):
    """Any member alive, and dead with work (every dispatcher dead while
    some queue holds work), on plain dicts, as JAX's helpers grade them."""
    from gansformer_tpu.analysis import telemetry_schema as jax_schema

    vals = FLEETS[case]
    for name in ("serve_replica_ordinals", "serve_fleet_alive",
                 "serve_fleet_dead_with_work"):
        assert getattr(port_cli, name)(vals) == \
            getattr(jax_schema, name)(vals), (case, name)
    assert port_cli.serve_fleet_dead_with_work(vals) == (
        case in ("all_dead_with_work", "solo_dead_with_work"))
    # the one-dispatcher verdict the doctor grades, on this case's solo
    # gauges
    alive = vals.get("serve_dispatcher_alive", 0.0)
    depth = vals.get("serve_queue_depth_now")
    assert port_cli.serve_dead_with_work(alive, depth) == \
        jax_schema.serve_dead_with_work(alive, depth)


# -- the port's own: copies of the bundle, placement defaults ----------------

def test_members_get_a_copy_per_device_and_the_bundle_stays(bundle):
    """Members on another device than the bundle's get one deep copy per
    device, shared by that device's members; the caller's bundle stays on
    its device with its values."""
    before = {k: v.clone() for k, v in bundle.generator.state_dict().items()}
    meta = torch.device("meta")
    with ReplicaSet(bundle, buckets=(1,), devices=[CPU, meta, CPU, meta],
                    replicas=4) as rs:
        r = rs.active_replicas
        assert [m.device for m in r] == [CPU, meta, CPU, meta]
        assert r[0].programs.bundle is bundle is r[2].programs.bundle
        copy = r[1].programs.bundle
        assert copy is r[3].programs.bundle and copy is not bundle
        assert copy.generator is not bundle.generator
        assert {p.device for p in copy.generator.parameters()} == {meta}
        assert copy.w_avg.device == meta
        assert {p.device for p in bundle.generator.parameters()} == {CPU}
        for k, v in bundle.generator.state_dict().items():
            assert torch.equal(v, before[k]), k
        assert rs.submit(3).result(timeout=WAIT).shape == (16, 16, 3)
        assert rs.warm_start() == {"loaded": 0, "compiled": 0,
                                   "seconds": 0.0}


def test_placement_defaults_and_bounds(bundle):
    """A bundle on the host: one member there by default; more replicas
    than members fail with JAX's words."""
    with ReplicaSet(bundle, buckets=(1,)) as rs:
        assert [r.device for r in rs.active_replicas] == [CPU]
        assert rs.max_replicas == 1 and rs.health()["n_devices"] == 1
    with pytest.raises(ValueError, match=r"replicas=2 out of range \[1, 1\] "
                       r"\(1 local device\(s\)\)"):
        ReplicaSet(bundle, buckets=(1,), replicas=2)
