"""The port's request tracer (``gansformer_tpu_torch/obs/reqtrace.py``)
against the JAX package's (``gansformer_tpu/obs/reqtrace.py``): the same
scripted calls, on the same fake clock and wall clock, go into both
tracers, each with a span tracer of its own package on that clock as
the sink of its Chrome events.  The ledger rows, the recent rings, the
Chrome events, the active tables and the ``reqtrace/*`` counter deltas
must be equal; so must ``read_requests`` of torn ledgers and
``render_timeline``."""

import json
import os

import pytest

from gansformer_tpu.obs import registry as jax_registry
from gansformer_tpu.obs import reqtrace as jax_reqtrace
from gansformer_tpu.obs import spans as jax_spans
from gansformer_tpu_torch.obs import registry as port_registry
from gansformer_tpu_torch.obs import reqtrace as port_reqtrace
from gansformer_tpu_torch.obs import spans as port_spans
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

PACKAGES = {"jax": (jax_reqtrace, jax_spans, jax_registry),
            "port": (port_reqtrace, port_spans, port_registry)}
COUNTERS = ("reqtrace/requests_total", "reqtrace/events_total",
            "reqtrace/terminal_total", "reqtrace/dropped_total",
            "reqtrace/ledger_rows_total", "reqtrace/ledger_dropped_total")


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def lifecycle(rt, clk):
    rid = rt.begin(seed=7, psi=0.8)
    clk.advance(0.010)
    rt.event(rid, "admitted", depth=1)
    clk.advance(0.005)
    rt.event(rid, "popped", depth=1)
    rt.event(rid, "batched", batch=3, bucket=4)
    rt.event(rid, "map_dispatch", bucket=4)
    rt.event(rid, "synth", bucket=4)
    clk.advance(0.020)
    rt.event(rid, "fetch")
    rt.event(rid, "fulfilled")
    rt.batch_span(batch=3, bucket=4, rids=[rid, None], t0=clk.t - 0.02,
                  dur_s=0.02)


def outcomes(rt, clk):
    for kind, cause in (("shed", "overloaded"), ("expired", "deadline"),
                        ("cancelled", "client_cancelled"),
                        ("failed", "FaultInjected")):
        rid = rt.begin(seed=1, psi=0.5)
        clk.advance(0.001)
        rt.event(rid, kind, cause=cause)


def eviction(rt, clk):
    r1, r2, r3 = rt.begin(), rt.begin(), rt.begin()  # r1 evicted
    rt.event(r1, "fulfilled")                        # ignored
    clk.advance(0.002)
    rt.event(r2, "wcache_hit")
    rt.event(r2, "fulfilled")
    rt.event(r3, "failed", cause="Boom")
    rt.event(None, "fulfilled")
    rt.event("r0-0", "fulfilled")


def ledger_cap(rt, clk):
    for i in range(3):
        rid = rt.begin(seed=i)
        clk.advance(0.001)
        rt.event(rid, "fulfilled")


def many(rt, clk):
    # past the 64-row buffer: an append before the flush
    for i in range(70):
        rid = rt.begin(seed=i, psi=0.7)
        clk.advance(0.0005)
        rt.event(rid, "fulfilled" if i % 3 else "expired",
                 **({} if i % 3 else {"cause": "deadline"}))
    rt.reset()
    rt.begin(seed=99)                   # active after the reset


def disabled(rt, clk):
    assert rt.begin(seed=1) is None
    rt.event(None, "fulfilled")
    rt.batch_span(1, 1, ["x"], clk.t, 0.1)


SCRIPTS = {
    "lifecycle": (lifecycle, {}),
    "outcomes": (outcomes, {"chrome_events": False}),
    "eviction": (eviction, {"max_active": 2}),
    "ledger_cap": (ledger_cap, {"max_ledger_rows": 2}),
    "many": (many, {}),
    "disabled": (disabled, {"enabled": False}),
}


def run_script(pkg, name, root, monkeypatch):
    """One script through ``pkg``'s tracer; what it left behind."""
    reqtrace, spans, registry = PACKAGES[pkg]
    script, kw = SCRIPTS[name]
    clk = FakeClock()
    tracer = spans.Tracer(time_fn=clk)
    events_path = os.path.join(root, f"{pkg}-events.jsonl")
    tracer.configure(events_path, process_index=0)
    monkeypatch.setattr(reqtrace, "get_tracer", lambda: tracer)
    rt = reqtrace.ReqTracer(time_fn=clk, wall_fn=lambda: 1e6 + clk.t)
    ledger = os.path.join(root, f"{pkg}-requests.jsonl")
    before = {c: registry.counter(c).value for c in COUNTERS}
    rt.configure(ledger, **kw)
    enabled = registry.gauge("reqtrace/enabled").value
    script(rt, clk)
    rt.flush()
    tracer.flush()
    with open(events_path) as f:
        events = [json.loads(line) for line in f if line.strip()]
    return {"rows": reqtrace.read_requests(ledger), "recent": rt.recent(),
            "active": rt.active_rids(), "events": events,
            "enabled_gauge": enabled,
            "counters": {c: registry.counter(c).value - before[c]
                         for c in COUNTERS}}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_tracer_equals_jax(name, tmp_path, monkeypatch):
    jax_out = run_script("jax", name, str(tmp_path), monkeypatch)
    port_out = run_script("port", name, str(tmp_path), monkeypatch)
    assert port_out == jax_out
    # and what the script is about
    c = port_out["counters"]
    if name == "eviction":
        assert c["reqtrace/dropped_total"] == 1
        assert [r["outcome"] for r in port_out["recent"]] == ["fulfilled",
                                                              "failed"]
    elif name == "ledger_cap":
        assert len(port_out["rows"]) == 2 and len(port_out["recent"]) == 3
        assert c["reqtrace/ledger_dropped_total"] == 1
    elif name == "lifecycle":
        row, = port_out["rows"]
        assert row["e2e_ms"] == pytest.approx(35.0) and row["batch"] == 3
        assert [e["ph"] for e in port_out["events"]] == \
            ["b"] + ["n"] * 6 + ["e", "X"]
        assert port_out["events"][-1]["args"]["rids"] == [row["rid"]]
    elif name == "many":
        # the reset drops the 6 rows still buffered after the append
        assert len(port_out["rows"]) == 64 and port_out["recent"] == []
        assert len(port_out["active"]) == 1
    elif name == "disabled":
        assert port_out["enabled_gauge"] == 0.0 and not any(c.values())
        assert port_out["events"] == [] and port_out["rows"] == []


def test_constants_equal_jax():
    assert port_reqtrace.TERMINAL_KINDS == jax_reqtrace.TERMINAL_KINDS
    assert port_reqtrace.EVENT_KINDS == jax_reqtrace.EVENT_KINDS


def test_read_requests_and_render_timeline_equal_jax(tmp_path):
    """Torn lines (mid-file and a last append cut short), blank lines and
    a non-object line read alike; every row renders alike."""
    path = str(tmp_path / "requests.jsonl")
    row = {"rid": "r1-1", "seed": 4, "psi": 0.7, "batch": 2,
           "outcome": "failed", "cause": "Boom", "e2e_ms": 12.5,
           "t_wall": 1.0,
           "events": [{"kind": "submitted", "t_ms": 0.0},
                      {"kind": "batched", "t_ms": 3.0, "bucket": 4,
                       "batch": 2},
                      {"kind": "failed", "t_ms": 12.5, "cause": "Boom"}]}
    plain = {"rid": "r1-3", "outcome": "fulfilled", "cause": None,
             "e2e_ms": 5.0, "events": [{"kind": "submitted", "t_ms": 0.0},
                                       {"kind": "fulfilled", "t_ms": 5.0}]}
    with open(path, "w") as f:
        f.write(json.dumps(row) + "\n\n")
        f.write('{"torn mid\n')
        f.write("[1, 2]\n")
        f.write(json.dumps(plain) + "\n")
        f.write('{"rid": "r1-4", "outco')
    rows = port_reqtrace.read_requests(path)
    assert rows == jax_reqtrace.read_requests(path)
    assert [r["rid"] for r in rows] == ["r1-1", "r1-3"]
    assert port_reqtrace.read_requests(str(tmp_path / "none")) == []
    for r in rows + [{}]:
        assert port_reqtrace.render_timeline(r) == \
            jax_reqtrace.render_timeline(r)
    lines = port_reqtrace.render_timeline(rows[0]).splitlines()
    assert "cause=Boom" in lines[0] and "bucket=4" in lines[2]


def test_process_global_tracer_and_span_sink(tmp_path):
    """``configure_reqtrace`` drives the process-global tracer, whose
    Chrome events land in the process-global span tracer's sink."""
    sink = str(tmp_path / "events.jsonl")
    port_spans.configure_tracer(sink)
    try:
        rt = port_reqtrace.configure_reqtrace(None)
        assert rt is port_reqtrace.get_reqtracer()
        rid = rt.begin(seed=3)
        rt.event(rid, "fulfilled")
        port_spans.get_tracer().flush()
    finally:
        port_spans.configure_tracer(None)
    with open(sink) as f:
        events = [json.loads(line) for line in f]
    assert [(e["ph"], e["id"]) for e in events] == [("b", rid), ("e", rid)]
    assert all(e["ts"] >= 0 for e in events)
