"""Run-dir logging (the port's copy of ``gansformer_tpu/utils/logging.py``):
one per-tick dict goes to the console in the reference's one-line format,
to ``stats.jsonl``, and to a TensorBoard event file under
``<run_dir>/tensorboard/``, with the reference's scalar names
(``Loss/G``, ``Progress/kimg``, ``timing/img_per_sec_per_chip``).  Also
the metric series (``metric-<name>.txt``) and run flags
(``flag-<name>.txt``), the resume records (``resumes.jsonl``) and the
numbered run dirs.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional


def append_metric_line(run_dir: str, name: str, value: float,
                       kimg: float) -> None:
    """One line of ``metric-<name>.txt``, the reference's format."""
    with open(os.path.join(run_dir, f"metric-{name}.txt"), "a") as f:
        f.write(f"kimg {kimg:<10.1f} {name} {value:.6f}\n")


def write_flag(run_dir: str, name: str, value) -> None:
    """A run flag (the metric sweep's ``calibrated`` regime) is state, not
    a series: one ``flag-<name>.txt``, overwritten in place, never a
    ``metric-<name>.txt``."""
    v = int(value) if isinstance(value, (bool, int, float)) else value
    with open(os.path.join(run_dir, f"flag-{name}.txt"), "w") as f:
        f.write(f"{name} {v}\n")


def append_resume_record(run_dir: str, step: int) -> None:
    """One JSON line per ``--resume`` restart → ``resumes.jsonl``.  The
    run doctor counts these as the restart/availability evidence: a run
    dir with N lines survived N preemptions or crashes, and the last line
    says where it picked back up.

    The richer ``supervisor_events.jsonl`` schema (supervise/events.py)
    supersedes this file; it is kept for back-compat readers.  An
    UNSUPERVISED ``--resume`` also mirrors its record into the
    supervisor ledger (kind ``resume``) so the doctor's availability
    section sees manual re-arms too; under ``gansformer-supervise`` the
    supervisor owns the ledger and the mirror is skipped (it would
    double-count the restart the supervisor already logged)."""
    rec = {"time": time.time(), "step": int(step), "pid": os.getpid()}
    with open(os.path.join(run_dir, "resumes.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")
    if not os.environ.get("GANSFORMER_TPU_SUPERVISED"):
        from gansformer_tpu_torch.supervise import events

        events.append_event(run_dir, "resume", step=int(step),
                            source="train")


def read_resume_records(run_dir: str):
    """Resume records, torn-line-tolerant (a SIGKILL mid-append is the
    normal ending for exactly the runs the doctor inspects)."""
    path = os.path.join(run_dir, "resumes.jsonl")
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out


class RunLogger:
    """Run-dir writer (one process owns the run dir)."""

    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        self._closed = False
        os.makedirs(run_dir, exist_ok=True)
        self.jsonl = open(os.path.join(run_dir, "stats.jsonl"), "a")
        self.log_file = open(os.path.join(run_dir, "log.txt"), "a")
        from gansformer_tpu_torch.utils.tensorboard import EventWriter

        self.tb = EventWriter(os.path.join(run_dir, "tensorboard"))
        self.t0 = time.time()

    def log_tick(self, stats: Dict[str, float],
                 telemetry: Optional[dict] = None) -> None:
        """One tick record.  ``stats`` holds flat scalars (including the
        tracer's ``timing/phase/*`` breakdown, which therefore reaches
        TensorBoard for free); ``telemetry`` is the registry snapshot
        (counters/gauges/histograms), embedded as a nested section of
        the jsonl record only — TensorBoard gets scalars, the machine
        record gets everything."""
        rec = {"time": round(time.time() - self.t0, 2), **{
            k: (round(float(v), 6) if isinstance(v, (int, float)) else v)
            for k, v in stats.items()}}
        if telemetry is not None:
            rec["telemetry"] = telemetry
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        # global step = images seen (the lineage's x-axis convention)
        self.tb.scalars(stats, step=int(stats.get("Progress/kimg", 0.0)
                                        * 1000))
        line = ("tick {tick:<5d} kimg {kimg:<8.1f} "
                "time {time:<8.1f} sec/tick {sec_tick:<7.1f} "
                "img/s {imgs:<8.1f} G {g:<6.3f} D {d:<6.3f}").format(
            tick=int(stats.get("Progress/tick", 0)),
            kimg=stats.get("Progress/kimg", 0.0),
            time=rec["time"],
            sec_tick=stats.get("timing/sec_per_tick", 0.0),
            imgs=stats.get("timing/img_per_sec", 0.0),
            g=stats.get("Loss/G", float("nan")),
            d=stats.get("Loss/D", float("nan")))
        self.write(line)

    def metric(self, name: str, value: float, kimg: float) -> None:
        """A metric result: ``metric-<name>.txt`` and the TensorBoard
        scalar ``Metrics/<name>`` at the kimg's image count."""
        append_metric_line(self.run_dir, name, value, kimg)
        self.tb.scalars({f"Metrics/{name}": value}, step=int(kimg * 1000))

    def flag(self, name: str, value) -> None:
        """A run flag → ``flag-<name>.txt``."""
        write_flag(self.run_dir, name, value)

    def write(self, msg: str) -> None:
        print(msg)
        sys.stdout.flush()
        if self._closed:
            # post-close writes (the CLI's preemption farewell runs after
            # train()'s context manager released the files) still reach
            # the console; writing to the closed file would raise and
            # turn a clean preemption exit into a crash code.
            return
        self.log_file.write(msg + "\n")
        self.log_file.flush()

    def close(self) -> None:
        """Idempotent — the context-manager exit and an explicit caller
        close may both run (train() owns the logger's lifetime even when
        the caller constructed it)."""
        if not self._closed:
            self._closed = True
            self.jsonl.close()
            self.log_file.close()
            self.tb.close()

    def __enter__(self) -> "RunLogger":
        return self

    def __exit__(self, *exc) -> None:
        # never swallow the training exception; just release the files
        self.close()


def list_run_dirs(results_root: str):
    """Numbered run dirs under results_root, sorted by run id."""
    if not os.path.isdir(results_root):
        return []
    return sorted(
        os.path.join(results_root, d) for d in os.listdir(results_root)
        if os.path.isdir(os.path.join(results_root, d))
        and d.split("-")[0].isdigit())


def next_run_id(results_root: str) -> int:
    existing = [int(os.path.basename(d).split("-")[0])
                for d in list_run_dirs(results_root)]
    return max(existing, default=-1) + 1


def create_run_dir(results_root: str, desc: str) -> str:
    """The next numbered run dir, the reference's
    ``results/00012-<desc>/`` convention."""
    os.makedirs(results_root, exist_ok=True)
    run_dir = os.path.join(results_root,
                           f"{next_run_id(results_root):05d}-{desc}")
    os.makedirs(run_dir, exist_ok=True)
    return run_dir
