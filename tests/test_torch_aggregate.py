"""The port's fleet aggregation (``obs/aggregate.py``) against the JAX
package's on the same artifacts, over both input shapes (one shared run
dir with its per-process proms, or a list of run dirs) and every
partial-view rule: a missing process, a stale heartbeat, a torn prom,
a missing prom, gauge timestamps too far apart; the merged families,
``fleet.prom`` and ``write_fleet``'s files."""

import json
import os

import pytest

from gansformer_tpu.obs import aggregate as jax_agg
from gansformer_tpu_torch.obs import aggregate as port_agg
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

NOW = 1_000_000.0


def _prom(path, counters=(), gauges=(), summaries=(), torn=False):
    lines = []
    for name, v in counters:
        lines += [f"# TYPE {name} counter", f"{name} {v!r}"]
    for name, v in gauges:
        lines += [f"# TYPE {name} gauge", f"{name} {v!r}"]
    for name, members in summaries:
        lines.append(f"# TYPE {name} summary")
        lines += [f"{name}_{m} {v!r}" for m, v in members.items()]
    if torn:
        lines.append("data_wait_ms_cou")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _beat(d, idx, age, step):
    with open(os.path.join(d, f"heartbeat-p{idx}.json"), "w") as f:
        json.dump({"process": idx, "pid": 1, "host": "h",
                   "time": NOW - age, "step": step, "kimg": step / 1000}, f)


def _ledger(d, kinds):
    with open(os.path.join(d, "supervisor_events.jsonl"), "w") as f:
        for k in kinds:
            f.write(json.dumps({"schema": 1, "kind": k, "time": NOW}) + "\n")
        f.write('{"kind": "rest')               # a torn tail


def _proc_prom(path, i, torn=False):
    _prom(path, counters=[("data_starved_total", 1.0 + i),
                          ("device_samples_total", 2.0)],
          gauges=[("device_mfu", 0.3 + 0.05 * i),
                  ("device_wall_busy_ratio", 0.5 + 0.1 * i)],
          summaries=[("data_wait_ms", {"count": 4.0 + i, "sum": 10.0 * i,
                                       "min": 0.5 + i, "max": 3.0 + i})],
          torn=torn)


def shared_dir(root, n=2, ages=(5, 5), single_writer=False):
    d = str(root / "shared")
    os.makedirs(d)
    for i in range(n):
        _beat(d, i, ages[i], 1000 * (i + 1))
        if not single_writer:
            _proc_prom(os.path.join(d, f"telemetry-p{i}.prom"), i)
    if single_writer:
        _proc_prom(os.path.join(d, "telemetry.prom"), 0)
    _ledger(d, ["start", "restart", "exit", "restart"])
    return d


def run_dirs(root, spec):
    """One dir per entry of ``spec``: (heartbeat age or None, prom kind:
    'ok' | 'torn' | None, restarts)."""
    out = []
    for i, (age, prom, restarts) in enumerate(spec):
        d = str(root / f"p{i}")
        os.makedirs(d)
        if age is not None:
            _beat(d, i, age, 500 * (i + 1))
        if prom:
            _proc_prom(os.path.join(d, "telemetry.prom"), i,
                       torn=prom == "torn")
        if restarts is not None:
            _ledger(d, ["restart"] * restarts)
        out.append(d)
    return out


CASES = {
    "shared": (lambda r: shared_dir(r), {}),
    "shared_single_writer": (lambda r: shared_dir(r, single_writer=True),
                             {}),
    "shared_missing_process": (lambda r: shared_dir(r), {"expected": 3}),
    "shared_stale": (lambda r: shared_dir(r, ages=(5, 900)),
                     {"max_age_s": 60.0}),
    "shared_gauge_skew": (lambda r: shared_dir(r, ages=(5, 700)),
                          {"gauge_skew_s": 300.0}),
    "list": (lambda r: run_dirs(r, [(5, "ok", 0), (7, "ok", 2)]), {}),
    "list_partial": (lambda r: run_dirs(
        r, [(5, "ok", 1), (800, "torn", None), (None, None, 3)]),
        {"expected": 4, "max_age_s": 120.0}),
    "list_empty": (lambda r: run_dirs(r, [(None, None, None)]), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fleet_view_matches_jax(tmp_path, case):
    make, kw = CASES[case]
    target = make(tmp_path)
    port = port_agg.aggregate_fleet(target, now=NOW, **kw)
    ref = jax_agg.aggregate_fleet(target, now=NOW, **kw)
    assert port == ref
    assert port_agg.fleet_prom_text(port) == jax_agg.fleet_prom_text(ref)
    out = str(tmp_path / "out")
    paths = port_agg.write_fleet(port, out)
    for path, text in zip(paths, (
            json.dumps(ref, indent=1, sort_keys=True) + "\n",
            jax_agg.fleet_prom_text(ref))):
        assert open(path).read() == text
    assert port["partial"] == (case not in (
        "shared", "shared_single_writer", "list"))
