"""The port's ``utils/profparse.py`` against the JAX package's on the same
inputs: interval merging and program names where the two name forms
overlap, a fixture in kineto's Chrome-trace format (kernels, a memcpy
and a memset, ``cuda_runtime`` launches with ``correlation``, program
``user_annotation`` ranges, a launch from another thread, a kernel with
no launch under a ``gpu_user_annotation``, a torn trailing record, gzip),
the missing-trace sentinel and the report's keys, the in-memory fold of
the same events (the sampler's route) against the Chrome trace's, and a
live CPU ``torch.profiler`` trace of a micro d_step + g_step through
both routes."""

import gzip
import json

import numpy as np
import pytest
import torch

from gansformer_tpu.utils import profparse as jax_pp
from gansformer_tpu_torch.core import config as port_config
from gansformer_tpu_torch.obs.device_time import (export_trace,
                                                  profile_report,
                                                  start_profiler)
from gansformer_tpu_torch.train import create_train_state
from gansformer_tpu_torch.train.steps import d_step, g_step
from gansformer_tpu_torch.utils import profparse as pp
from tests.test_train import micro_cfg
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

MERGE_CASES = [
    [],
    [(0, 10)],
    [(0, 10), (5, 15)],
    [(0, 10), (10, 20)],
    [(0, 10), (11, 20)],
    [(5, 8), (0, 10), (2, 3)],
    [(0, 100), (10, 20), (30, 40), (90, 120), (200, 201)],
]


@pytest.mark.parametrize("intervals", MERGE_CASES)
def test_merge_busy_matches_jax(intervals):
    assert pp._merge_busy(intervals) == jax_pp._merge_busy(intervals)


# names of both packages' forms: JAX's dispatch and module events, the
# port's ranges, and names no program owns
NAMES = ["PjitFunction(d_step)", "PjitFunction(g_step_pl)", "jit_d_step",
         "jit_d_step.42", "jit__g_step(foo)", "jit_Cycle-2", "fusion.3",
         "$loop.py:12 train", "aten::mm", "program:d_step",
         "program:g_step_pl", "program:Odd Name!", "program:",
         "ProfilerStep#3"]


@pytest.mark.parametrize("name", NAMES)
def test_program_name_matches_jax_where_the_forms_overlap(name):
    port, ref = pp.program_name(name), jax_pp.program_name(name)
    if name.startswith(pp.PROGRAM_PREFIX):
        assert ref is None
        assert port == jax_pp.program_name(
            "jit_" + name[len(pp.PROGRAM_PREFIX):])
    else:
        assert port == ref


US = 1e6            # picoseconds in a microsecond


def kineto_records():
    """A trace as ``torch.profiler`` exports it on the card (the record
    shapes of its Chrome trace): thread 11 runs d_step then g_step; a
    d_step kernel is launched from thread 12 (autograd's), a g_step
    kernel has no launch event but lies under the card's g_step range,
    one kernel lies under no range."""
    def x(cat, name, ts, dur, pid, tid, **args):
        return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
                "ts": ts, "dur": dur, "args": args}
    recs = [
        {"name": "process_name", "ph": "M", "pid": 7, "tid": 0,
         "args": {"name": "python3"}},
        {"name": "process_labels", "ph": "M", "pid": 0, "tid": 0,
         "args": {"labels": "GPU 0"}},
        x("user_annotation", "program:d_step", 100.0, 50.0, 7, 11),
        x("user_annotation", "program:g_step", 200.0, 60.0, 7, 11),
        x("user_annotation", "Optimizer.step#Adam.step", 140.0, 5.0, 7, 11),
        x("cpu_op", "aten::mm", 101.0, 4.0, 7, 11),
        x("cuda_runtime", "cudaLaunchKernel", 102.0, 1.0, 7, 11,
          correlation=1),
        x("cuda_runtime", "cudaMemcpyAsync", 110.0, 1.0, 7, 11,
          correlation=2),
        x("cuda_runtime", "cudaLaunchKernel", 120.0, 1.0, 7, 12,
          correlation=3),
        x("cuda_runtime", "cudaMemsetAsync", 205.0, 1.0, 7, 11,
          correlation=4),
        x("cuda_driver", "cuLaunchKernel", 210.0, 1.0, 7, 11,
          correlation=5),
        x("kernel", "fwd_wgmma_kernel", 300.0, 20.0, 0, 7, device=0,
          correlation=1, stream=7),
        x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 315.0, 10.0, 0, 8,
          device=0, correlation=2),
        x("kernel", "dx_wgmma_kernel", 330.0, 5.0, 0, 7, device=0,
          correlation=3),
        x("gpu_memset", "Memset (Device)", 400.0, 2.0, 0, 7, device=0,
          correlation=4),
        x("kernel", "g2l_mma_kernel", 410.0, 8.0, 0, 7, device=0,
          correlation=5),
        x("gpu_user_annotation", "program:g_step", 395.0, 40.0, 0, 7,
          device=0),
        x("kernel", "l2g_mma_kernel", 425.0, 6.0, 0, 7, device=0,
          correlation=99),
        x("kernel", "stray_kernel", 500.0, 3.0, 0, 7, device=0,
          correlation=98),
        x("overhead", "Activity Buffer Request", 90.0, 5.0, -1, 0),
        {"ph": "f", "id": 1, "pid": 7, "tid": 11, "ts": 102.0,
         "cat": "ac2g", "name": "ac2g", "bp": "e"},
    ]
    return recs


# merged: 300-325 (the memcpy overlaps the first kernel), 330-335,
# 400-402, 410-418, 425-431, 500-503
FIXTURE_BUSY_US = 25 + 5 + 2 + 8 + 6 + 3
FIXTURE_PROGRAMS_US = {"d_step": 25 + 5, "g_step": 2 + 8 + 6}


def write_trace(path, records, torn=False, gz=False):
    text = json.dumps({"schemaVersion": 1, "traceEvents": records,
                       "traceName": str(path)}, indent=1)
    if torn:
        # cut the document inside its last record: what a kill mid-write
        # leaves
        text = text[:text.rindex('"bp"')]
    data = text.encode()
    with open(path, "wb") as f:
        f.write(gzip.compress(data) if gz else data)


@pytest.mark.parametrize("torn", [False, True])
@pytest.mark.parametrize("gz", [False, True])
def test_kineto_fixture_parses(tmp_path, torn, gz):
    recs = kineto_records()
    name = "host_1.123.pt.trace.json" + (".gz" if gz else "")
    write_trace(tmp_path / name, recs, torn=torn, gz=gz)
    trace, source = pp.parse_trace(str(tmp_path))
    assert source == "chrome-trace"
    gpu = trace.events["/device:GPU:0"]
    assert [n for n, _, _ in gpu] == [
        "fwd_wgmma_kernel", "Memcpy HtoD (Pinned -> Device)",
        "dx_wgmma_kernel", "Memset (Device)", "g2l_mma_kernel",
        "l2g_mma_kernel", "stray_kernel"]
    assert trace.events[pp.HOST_PLANE] == [("aten::mm", 101 * US, 4 * US)]
    assert trace.unattributed == {"/device:GPU:0": 1, pp.HOST_PLANE: 0}
    rep = pp.device_time_report(str(tmp_path))
    assert rep["status"] == "ok" and rep["plane"] == "/device:GPU:0"
    assert rep["busy_s"] == FIXTURE_BUSY_US * US / 1e12
    assert rep["span_s"] == (503 - 300) * US / 1e12
    assert rep["events"] == 7
    assert rep["program_busy_s"] == {
        k: v * US / 1e12 for k, v in FIXTURE_PROGRAMS_US.items()}
    assert sum(rep["program_busy_s"].values()) <= rep["busy_s"]
    assert pp.device_busy_span(str(tmp_path)) == (
        rep["busy_s"], rep["span_s"], "/device:GPU:0")


class FakeKinetoEvent:
    """The accessors of ``torch.profiler``'s in-memory events, over one
    Chrome trace record (the card's: a launch links to its operator
    unless no operator encloses it)."""

    def __init__(self, rec, external_id):
        self.rec, self.args = rec, rec.get("args", {})
        self.cat = rec["cat"]
        self.external_id = external_id

    def name(self):
        return self.rec["name"]

    def device_type(self):
        return "DeviceType.CUDA" if self.cat in (
            "kernel", "gpu_memcpy", "gpu_memset",
            "gpu_user_annotation") else "DeviceType.CPU"

    def is_user_annotation(self):
        return self.cat.endswith("user_annotation")

    def start_ns(self):
        return int(round(self.rec["ts"] * 1e3))

    def duration_ns(self):
        return int(round(self.rec["dur"] * 1e3))

    def correlation_id(self):
        return self.args.get("correlation", self.external_id)

    def linked_correlation_id(self):
        # the driver call below is enclosed by no operator: no link
        return self.external_id if self.cat == "cuda_runtime" else 0

    def start_thread_id(self):
        return self.rec["tid"]

    def device_index(self):
        return self.args.get("device", self.rec["pid"])


def test_the_in_memory_fold_gives_the_chrome_traces_result(tmp_path):
    recs = [r for r in kineto_records() if r.get("ph") == "X"
            and r["cat"] != "overhead"]
    write_trace(tmp_path / "t.pt.trace.json", recs)
    chrome, _ = pp.parse_trace(str(tmp_path))
    fakes = [FakeKinetoEvent(r, i + 1) for i, r in enumerate(recs)]
    memory = pp.trace_from_kineto(fakes)
    assert memory.events == chrome.events
    assert memory.programs == chrome.programs
    assert memory.unattributed == chrome.unattributed
    assert pp.trace_report(memory, "m") == pp.trace_report(chrome, "m")
    # without the host's operators: the card's plane and report unchanged
    card = pp.trace_from_kineto(fakes, host_ops=False)
    assert pp.HOST_PLANE not in card.events
    assert card.events["/device:GPU:0"] == chrome.events["/device:GPU:0"]
    assert pp.trace_report(card, "m") == pp.trace_report(chrome, "m")


def test_a_host_trace_picks_the_host_plane_and_attributes_by_range(
        tmp_path):
    recs = [r for r in kineto_records() if r.get("cat") in (
        "user_annotation", "cpu_op", None)]
    recs.append({"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 7,
                 "tid": 12, "ts": 210.0, "dur": 10.0, "args": {}})
    write_trace(tmp_path / "t.pt.trace.json", recs)
    rep = pp.device_time_report(str(tmp_path))
    assert rep["plane"] == pp.HOST_PLANE
    assert rep["busy_s"] == 14 * US / 1e12
    # the op on thread 12 falls in thread 11's g_step range
    assert rep["program_busy_s"] == {"d_step": 4 * US / 1e12,
                                     "g_step": 10 * US / 1e12}


def test_missing_trace_gives_the_sentinel_with_jax_keys(tmp_path):
    rep = pp.device_time_report(str(tmp_path))
    ref = jax_pp.device_time_report(str(tmp_path))
    assert rep["status"] == ref["status"] == "unavailable"
    assert set(rep) == set(ref) == {"status", "reason"}
    assert pp.parse_planes(str(tmp_path)) is None
    assert pp.device_busy_span(str(tmp_path)) is None
    (tmp_path / "x.pt.trace.json").write_text("not a trace")
    assert pp.device_time_report(str(tmp_path))["status"] == "unavailable"


def test_report_keys_equal_jaxs(tmp_path):
    """The port's report on its fixture and JAX's on a Chrome trace of its
    own (a TPU plane with a ``jit_d_step`` module event) carry the same
    keys."""
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    write_trace(tmp_path / "port" / "t.pt.trace.json", kineto_records())
    write_trace(tmp_path / "jax" / "t.trace.json", [
        {"name": "process_name", "ph": "M", "pid": 1,
         "args": {"name": "/device:TPU:0"}},
        {"ph": "X", "name": "jit_d_step", "pid": 1, "tid": 1, "ts": 10.0,
         "dur": 5.0}])
    rep = pp.device_time_report(str(tmp_path / "port"))
    ref = jax_pp.device_time_report(str(tmp_path / "jax"))
    assert ref["status"] == rep["status"] == "ok"
    assert set(rep) == set(ref)


BATCH = 4


def micro_state():
    cfg = micro_cfg(attention="simplex", batch=BATCH)
    exp = port_config.ExperimentConfig.from_json(cfg.to_json())
    return exp, create_train_state(exp.model, exp.train, 0, "cpu")


def test_live_cpu_trace_attributes_d_step_and_g_step(tmp_path):
    """One micro d_step and g_step under the loop's trace path (the
    profiler of ``obs/device_time.py`` and its export) on the CPU: both
    programs are attributed, and their busy time is inside the
    plane's."""
    exp, state = micro_state()
    r = exp.model.resolution
    reals = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (BATCH, r, r, exp.model.img_channels), dtype=np.uint8))
    prof = start_profiler("cpu")
    try:
        d_step(state, reals, 0)
        g_step(state, 0, BATCH)
    finally:
        prof.stop()
    path = export_trace(prof, str(tmp_path))
    assert path.endswith(".pt.trace.json")
    rep = pp.device_time_report(str(tmp_path))
    assert rep["status"] == "ok" and rep["plane"] == pp.HOST_PLANE
    progs = rep["program_busy_s"]
    assert set(progs) == {"d_step", "g_step"}
    assert all(v > 0 for v in progs.values())
    assert sum(progs.values()) <= rep["busy_s"] * (1 + 1e-12)
    # the sampler's fold of the same profile from memory
    mem = profile_report(prof)
    assert mem["status"] == "ok" and mem["plane"] == rep["plane"]
    for key in ("busy_s", "span_s", "events", "program_busy_s"):
        assert mem[key] == rep[key], key
