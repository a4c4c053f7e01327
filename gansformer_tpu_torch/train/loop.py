"""The tick loop of the port (``train()``/``_train()`` of
``gansformer_tpu/train/loop.py``, on one device, eager).

Per iteration: ``d_step_r1`` when ``it % d_reg_interval == 0``, else
``d_step``; then ``g_step_pl`` when ``it % g_reg_interval == 0``, else
``g_step``, inside the ``data_wait`` / ``h2d`` / ``step`` spans.  No
iteration makes a host round trip: batches and draws reach the card from
pinned memory with ``non_blocking``.  That is what JAX's
``train.fused_cycle`` (one dispatch per lazy-reg cycle) and
``data.device_prefetch`` (copies off the critical path) ask for, so both
keys are taken, said in ``log.txt``, and the loop runs the same
iterations either way.  The
steps' aux scalars are summed on the device; the tick boundary is the
loop's only host sync (one synchronize, one fetch of the sums and the
attention gates).  There it writes the tick's stats (``stats.jsonl``,
TensorBoard, ``log.txt``), the heartbeat and ``telemetry.prom``,
surfaces writer errors, fires the ``tick`` fault point, writes
``fakes<kimg>.png`` every ``image_snapshot_ticks`` and a checkpoint every
``snapshot_ticks`` ticks (on a writer thread when ``async_checkpoint``).

Resume: the state comes back from ``<run_dir>/checkpoints`` (JAX's
format; either package's checkpoints), the reals' stream restarts at
batch ``step // batch_size`` of seed ``seed + 1`` and every draw of
iteration ``it`` comes from ``(seed, it)``, so a killed and resumed run
is tick for tick the uninterrupted one.  SIGTERM leads to one
synchronous checkpoint within the grace window, then ``PreemptionExit``.
The snapshot grid's latents come from the port's own generator seeded
with ``seed + 2`` (``grid_z`` stands in for them), their noise from
``seed + 3``.

Every ``metric_ticks`` ticks, where ``train.metrics`` names metrics, the
tick boundary runs the metric group (built once, at its first use) on
the EMA generator inside the ``metric`` span: the results go to
``metric-<name>.txt`` and TensorBoard, the ``calibrated`` flag to
``flag-calibrated.txt``, and a ``metrics @ … kimg`` line to ``log.txt``.
The samplers' seed is ``seed + 5``, as in JAX.

Not in the port, and said so in ``log.txt`` where a config asks: the
mesh, FSDP and multi-host branches (a mesh of more than one device fails
``ExperimentConfig.validate``), the device-time sampler and
``profile_dir``.  The compile listener, the
retrace watch and the TPU-only MFU bookkeeping count XLA compiles and
TPU FLOPs and have no counterpart.  The ``--steps`` cap of the CLI
(``steps``) ends the run after that many iterations, with its final tick
and checkpoint.
"""

from __future__ import annotations

import dataclasses
import math
import os
import signal
import threading
import time
from typing import Optional

import numpy as np
import torch

from gansformer_tpu_torch import obs
from gansformer_tpu_torch.core.config import (IGNORED_TRAIN_KEYS,
                                              ExperimentConfig)
from gansformer_tpu_torch.core.device import resolve_device, to_device
from gansformer_tpu_torch.core.precision import input_dtype
from gansformer_tpu_torch.data.dataset import PrefetchIterator, make_dataset
from gansformer_tpu_torch.obs.spans import span
from gansformer_tpu_torch.serve.programs import noise_generators
from gansformer_tpu_torch.supervise import faults
from gansformer_tpu_torch.supervise.events import PreemptionExit
from gansformer_tpu_torch.train import checkpoint as ckpt
from gansformer_tpu_torch.train.state import TrainState, create_train_state
from gansformer_tpu_torch.train.steps import (d_step, d_step_r1, g_step,
                                              g_step_pl)
from gansformer_tpu_torch.utils.background import SingleSlotWriter
from gansformer_tpu_torch.utils.image import save_image_grid
from gansformer_tpu_torch.utils.logging import RunLogger, append_resume_record

SNAPSHOT_PSI = 0.7


def param_count(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def wattn_gate_stats(generator: torch.nn.Module) -> Optional[dict]:
    """max/mean |gate| over the generator's ``*wattn_gate`` scalars (the
    attention-styling gates), or None without them.  One fetch: call it
    at the tick boundary."""
    gates = [p.detach().reshape(-1) for n, p in generator.named_parameters()
             if "wattn_gate" in n]
    if not gates:
        return None
    mags = torch.cat(gates).abs().float().cpu().numpy()
    return {"gates/wattn_max": float(mags.max()),
            "gates/wattn_mean": float(mags.mean())}


def resolve_conditional(cfg: ExperimentConfig, dataset) -> ExperimentConfig:
    """A labelled dataset turns G and D conditional."""
    if dataset.has_labels and cfg.model.label_dim == 0:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, label_dim=dataset.label_dim))
    return cfg


def ignored_notes(cfg: ExperimentConfig) -> list:
    """One line for each key the config turns on that the port does not
    act on yet (JAX's defaults turn one on: the device-time sampler)."""
    out = []
    for k in sorted(IGNORED_TRAIN_KEYS):
        v = getattr(cfg.train, k)
        if v:
            out.append(f"train.{k}={v!r} is not in the port yet: it runs "
                       f"the plain loop without it")
    return out


class _PreemptNotice:
    """SIGTERM -> a graceful-checkpoint request: the handler sets a flag
    the loop polls between iterations.  ``shutdown_timeout_s`` bounds the
    writer joins of the shutdown once it has begun."""

    def __init__(self):
        self.requested = False
        self.shutdown_timeout_s: Optional[float] = None

    def _handler(self, signum, frame):
        self.requested = True

    def install(self):
        """On SIGTERM, from the main thread only; returns a restore
        callable."""
        if threading.current_thread() is not threading.main_thread():
            return lambda: None
        try:
            prev = signal.signal(signal.SIGTERM, self._handler)
        except (ValueError, OSError):
            return lambda: None
        return lambda: signal.signal(signal.SIGTERM, prev)


def preempt_grace_s() -> float:
    """The SIGTERM-to-exit budget (``GANSFORMER_TPU_PREEMPT_GRACE_S``,
    default 30 s)."""
    try:
        return float(os.environ.get("GANSFORMER_TPU_PREEMPT_GRACE_S", "30"))
    except ValueError:
        return 30.0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _preemption_checkpoint(state: TrainState, ckpt_dir: str,
                           cfg: ExperimentConfig, grace: float) -> int:
    """Settle the device, bound the async writer's join to the grace
    window, and write one synchronous checkpoint unless this step is
    already on disk.  Returns the step."""
    _sync(state.device)
    ckpt.wait(ckpt_dir, reraise=False, timeout=max(1.0, grace / 2))
    if ckpt.latest_step(ckpt_dir) != state.step:
        with span("checkpoint"):
            ckpt.save(ckpt_dir, state, cfg, block=True)
    return state.step


def train(cfg: ExperimentConfig, run_dir: str, resume: bool = False,
          total_kimg: Optional[float] = None,
          logger: Optional[RunLogger] = None, device=None,
          steps: Optional[int] = None,
          grid_z: Optional[torch.Tensor] = None) -> TrainState:
    """Train ``cfg`` into ``run_dir`` (resuming from its checkpoints when
    ``resume``) until ``total_kimg`` (default ``cfg.train.total_kimg``)
    or ``steps`` iterations of this call.  ``device=None`` is the card."""
    cfg.validate()
    dev = resolve_device(device)
    preempt = _PreemptNotice()
    restore_handler = preempt.install()
    try:
        with (logger or RunLogger(run_dir)) as log:
            return _train(cfg, run_dir, dev, resume, total_kimg, log,
                          preempt, steps, grid_z)
    finally:
        restore_handler()


def _train(cfg: ExperimentConfig, run_dir: str, dev: torch.device,
           resume: bool, total_kimg: Optional[float], log: RunLogger,
           preempt: _PreemptNotice, max_steps: Optional[int],
           grid_z: Optional[torch.Tensor]) -> TrainState:
    t = cfg.train
    total_kimg = total_kimg if total_kimg is not None else t.total_kimg

    # --- telemetry: one run's spans and instruments -------------------------
    tracer = obs.get_tracer()
    tracer.reset()
    obs.get_registry().reset()
    tracer.configure(os.path.join(run_dir, "events.jsonl"),
                     truncate=not resume)
    heartbeat = obs.Heartbeat(run_dir)
    prom_path = os.path.join(run_dir, "telemetry.prom")
    anomaly = torch.is_anomaly_enabled()
    if t.debug_nans:
        from gansformer_tpu_torch.utils.debug import enable_nan_debug

        enable_nan_debug()
        log.write("debug: torch.autograd anomaly detection ON (op-by-op "
                  "NaN localization)")
    reg = obs.get_registry()
    for c in ("data/read_retries_total", "data/corrupt_records_total",
              "data/stalls_total", "train/nonfinite_total",
              "train/nonfinite_loss_total", "train/nonfinite_grad_total",
              "train/nonfinite_param_total"):
        reg.counter(c)
    reg.gauge("data/corrupt_frac").set(0.0)
    reg.gauge("data/corrupt_budget_frac").set(cfg.data.max_corrupt_frac)

    dataset = make_dataset(cfg.data)
    dataset.set_quarantine_ledger(
        os.path.join(run_dir, "data_quarantine.jsonl"))
    cfg = resolve_conditional(cfg, dataset)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())

    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "host CPU")
    log.write(f"device: {dev} ({name}), one process")
    log.write(f"config: {cfg.name}  resolution {cfg.model.resolution}  "
              f"attention {cfg.model.attention}  k={cfg.model.components}"
              + (f"  label_dim={cfg.model.label_dim}"
                 if cfg.model.label_dim else ""))
    for note in ignored_notes(cfg):
        log.write(note)

    # --- state ---------------------------------------------------------------
    state = create_train_state(cfg.model, t, t.seed, dev)
    log.write(f"G params: {param_count(state.generator):,}  "
              f"D params: {param_count(state.discriminator):,}")
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    ckpt.reset_errors(ckpt_dir)
    resumed = False
    if resume and ckpt.latest_step(ckpt_dir) is not None:
        state = ckpt.restore(ckpt_dir, state)
        resumed = True
    # one step read feeds the resume log, the data stream and the counters
    start_step = state.step
    if resumed:
        log.write(f"resumed from step {start_step} "
                  f"({start_step / 1000:.1f} kimg)")
        append_resume_record(run_dir, step=start_step)
    if t.async_checkpoint and t.snapshot_ticks:
        ckpt.warm_async(state, ckpt_dir)

    # --- data: the stream an uninterrupted run reads at this iteration ------
    start_it = start_step // t.batch_size
    batch_iter = dataset.batches(t.batch_size, seed=t.seed + 1,
                                 shard=(0, 1), start_batch=start_it)
    log.write(f"data: {cfg.data.source} {cfg.data.path or ''} "
              f"({dataset.num_images} images), stream seed {t.seed + 1} "
              f"from batch {start_it}")
    conditional = bool(cfg.model.label_dim)

    def put_batch(arr: np.ndarray) -> torch.Tensor:
        """A host batch on the device: from pinned memory on the card
        (the copy does not hold up the host), as is on the CPU."""
        return to_device(torch.from_numpy(arr), dev)

    if t.fused_cycle:
        log.write(f"fused cycle: {t.d_reg_interval} iterations make no host "
                  f"round trip, as every iteration of the port; they run "
                  f"one by one")
    if cfg.data.device_prefetch:
        log.write("device prefetch: each batch is copied from pinned "
                  "memory without a host sync, on the loop thread")

    # --- fixed grid latents for snapshots ------------------------------------
    grid_n = min(16, t.batch_size * 2)
    if grid_z is None:
        grid_z = torch.randn(
            (grid_n, cfg.model.num_ws, cfg.model.latent_dim),
            generator=torch.Generator().manual_seed(t.seed + 2))
    grid_z = grid_z.to(dev, input_dtype(cfg.model.dtype))
    grid_n = grid_z.shape[0]
    grid_labels = dataset.random_labels(grid_n, seed=t.seed + 2) \
        if conditional else None
    if grid_labels is not None:
        grid_labels = torch.from_numpy(grid_labels).to(dev)
    snap_writer = SingleSlotWriter("snapshot/async") \
        if t.async_checkpoint else None

    def snapshot_images(st: TrainState, kimg: float) -> None:
        path = os.path.join(run_dir, f"fakes{int(kimg):06d}.png")
        with span("snapshot"):
            with torch.no_grad():
                imgs = st.ema(grid_z, truncation_psi=SNAPSHOT_PSI,
                              w_avg=st.w_avg, label=grid_labels,
                              noise_gens=noise_generators(
                                  t.seed + 3, range(grid_n), dev))
                imgs = imgs.float()
            if snap_writer is not None:
                if dev.type == "cuda":
                    host = torch.empty(imgs.shape, pin_memory=True)
                    host.copy_(imgs, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record()
                else:
                    host, done = imgs, None

                def job():
                    if done is not None:
                        done.synchronize()
                    save_image_grid(host.numpy(), path)
                snap_writer.submit(job, label=os.path.basename(path))
            else:
                save_image_grid(imgs.cpu().numpy(), path)

    metric_group = None      # built at its first use: the extractor's setup

    def run_metrics(st: TrainState) -> dict:
        """The metric group on the EMA generator (the reference training
        loop's periodic metric runs)."""
        nonlocal metric_group
        from gansformer_tpu_torch.metrics.inception import make_extractor
        from gansformer_tpu_torch.metrics.metric_base import (
            MetricGroup, parse_metric_names)
        from gansformer_tpu_torch.train.steps import make_metric_samplers

        if metric_group is None:
            metric_group = MetricGroup(
                parse_metric_names(t.metrics, batch_size=t.batch_size),
                extractor=make_extractor(device=dev),
                cache_dir=os.path.join(run_dir, "metric-cache"))
        sample_fn, pair_fn = make_metric_samplers(
            st, cfg, dataset, truncation_psi=1.0, seed=t.seed + 5)
        return metric_group.run(sample_fn, dataset, pair_fn=pair_fn)

    # --- loop ----------------------------------------------------------------
    cur_nimg = start_step
    heartbeat.beat(step=cur_nimg, kimg=cur_nimg / 1000,
                   extra={"phase": "setup"})
    it = start_it
    tick = 0
    tick_start_nimg = cur_nimg
    tracer.drain()           # setup spans stay out of tick 0's phases
    tick_start_time = time.time()
    # tick-averaged scalars: per-key sums on the device, counts on the host
    acc_sum: dict = {}
    acc_cnt: dict = {}
    snapshot_images(state, cur_nimg / 1000)

    def done_iterating() -> bool:
        return cur_nimg >= total_kimg * 1000 or (
            max_steps is not None and it - start_it >= max_steps)

    # built directly before the try, so its thread cannot leak
    batches = PrefetchIterator(batch_iter, depth=cfg.data.prefetch,
                               stall_after_s=cfg.data.stall_after_s)
    try:
        while not done_iterating():
            if preempt.requested:
                grace = preempt_grace_s()
                preempt.shutdown_timeout_s = max(1.0, grace / 4)
                log.write(f"preemption notice (SIGTERM): final "
                          f"checkpoint within {grace:.0f}s grace")
                step_now = _preemption_checkpoint(state, ckpt_dir, cfg,
                                                  grace)
                log.write(f"preemption checkpoint @ step {step_now}; "
                          f"exiting for resume")
                raise PreemptionExit(step_now)
            with span("data_wait"):
                batch = next(batches)
            with span("h2d"):
                imgs = put_batch(batch["image"])
                label = (put_batch(batch["label"])
                         if conditional and "label" in batch else None)
            with span("step"):
                d_fn = d_step_r1 if it % t.d_reg_interval == 0 else d_step
                d_aux = d_fn(state, imgs, it,
                             mirror_augment=cfg.data.mirror_augment,
                             label=label)
                g_fn = g_step_pl if it % t.g_reg_interval == 0 else g_step
                g_aux = g_fn(state, it, t.batch_size, label=label)
                it += 1
                cur_nimg += t.batch_size
                for k, v in {**d_aux, **g_aux}.items():
                    acc_sum[k] = v if k not in acc_sum else acc_sum[k] + v
                    acc_cnt[k] = acc_cnt.get(k, 0) + 1

            # --- tick boundary (the ONLY host sync) -------------------------
            if cur_nimg >= tick_start_nimg + t.kimg_per_tick * 1000 or \
                    done_iterating():
                with span("tick_fetch"):
                    _sync(dev)
                    now = time.time()
                    sec_per_tick = now - tick_start_time
                    imgs_done = cur_nimg - tick_start_nimg
                    keys = list(acc_sum)
                    sums = (torch.stack([acc_sum[k].float() for k in keys])
                            .cpu().tolist() if keys else [])
                    fetched = {k: s / acc_cnt[k] for k, s in zip(keys, sums)}
                    gate_stats = wattn_gate_stats(state.generator)
                acc_sum, acc_cnt = {}, {}
                # non-finite values that reached the host, by cause: the
                # regularizers' penalties ride the gradient path, other
                # scalars the loss path, the gates are parameters
                nonfinite = {"loss": 0, "grad": 0, "param": 0}
                for k, v in fetched.items():
                    if not math.isfinite(v):
                        cause = ("grad" if k.endswith(("/r1", "/pl"))
                                 else "loss")
                        nonfinite[cause] += 1
                for k, v in (gate_stats or {}).items():
                    if not math.isfinite(v):
                        nonfinite["param"] += 1
                if any(nonfinite.values()):
                    for cause, n in nonfinite.items():
                        if n:
                            reg.counter(
                                f"train/nonfinite_{cause}_total").inc(n)
                    reg.counter("train/nonfinite_total").inc(
                        sum(nonfinite.values()))
                    log.write(
                        "WARNING: non-finite tick stats "
                        f"(kimg {cur_nimg / 1000:.1f}): "
                        + ", ".join(f"{c}={n}" for c, n
                                    in nonfinite.items() if n))
                if t.debug_nans:
                    from gansformer_tpu_torch.utils.debug import (
                        check_finite_stats)

                    check_finite_stats(
                        fetched, where=f"kimg {cur_nimg / 1000:.1f}")
                # self times partition the tick: timing/phase/* sums to
                # sec_per_tick
                phases = tracer.drain()
                data_wait_s = phases.get("data_wait", {}).get("total_s", 0.0)
                stats = {
                    "Progress/tick": tick,
                    "Progress/kimg": cur_nimg / 1000,
                    "timing/sec_per_tick": sec_per_tick,
                    "timing/img_per_sec": imgs_done / max(sec_per_tick, 1e-9),
                    "timing/img_per_sec_per_chip":
                        imgs_done / max(sec_per_tick, 1e-9),
                    "timing/data_wait_s": data_wait_s,
                    "timing/data_wait_frac":
                        data_wait_s / max(sec_per_tick, 1e-9),
                    **{f"timing/phase/{n}": v["self_s"]
                       for n, v in phases.items()},
                    **(gate_stats or {}),
                    **fetched,
                }
                log.log_tick(stats, telemetry=reg.snapshot())
                heartbeat.beat(step=cur_nimg, kimg=cur_nimg / 1000)
                reg.write_prom(prom_path)
                ckpt.check_error(ckpt_dir)
                if snap_writer is not None:
                    snap_writer.poll()
                faults.fire("tick", tick=tick, step=cur_nimg)
                tick += 1
                tick_start_nimg = cur_nimg
                tick_start_time = time.time()

                if t.image_snapshot_ticks and \
                        tick % t.image_snapshot_ticks == 0:
                    snapshot_images(state, cur_nimg / 1000)
                if t.snapshot_ticks and tick % t.snapshot_ticks == 0:
                    with span("checkpoint"):
                        ckpt.save(ckpt_dir, state, cfg,
                                  block=not t.async_checkpoint)
                    log.write(f"checkpoint @ {cur_nimg / 1000:.1f} kimg")
                if t.metric_ticks > 0 and t.metrics and \
                        tick % t.metric_ticks == 0:
                    from gansformer_tpu_torch.metrics.metric_base import \
                        FLAG_KEYS

                    with span("metric"):
                        results = run_metrics(state)
                    # flags are state, not series: flag-<name>.txt
                    flags = {k: results.pop(k) for k in FLAG_KEYS
                             if k in results}
                    for name, val in results.items():
                        log.metric(name, val, cur_nimg / 1000)
                    for name, val in flags.items():
                        log.flag(name, val)
                    log.write("metrics @ {:.1f} kimg: {}{}".format(
                        cur_nimg / 1000,
                        {k: round(v, 3) for k, v in results.items()},
                        "".join(f"  [{k}={int(v)}]"
                                for k, v in flags.items())))
    finally:
        batches.close()
        dataset.close()
        if snap_writer is not None:
            snap_writer.wait(reraise=False,
                             timeout=preempt.shutdown_timeout_s)
        ckpt.wait(ckpt_dir, reraise=False,
                  timeout=preempt.shutdown_timeout_s)
        tracer.flush()
        heartbeat.beat(step=cur_nimg, kimg=cur_nimg / 1000,
                       extra={"phase": "finalize"})
        reg.write_prom(prom_path)
        if t.debug_nans:
            torch.autograd.set_detect_anomaly(anomaly)

    # final snapshot + checkpoint (no re-save of a saved step)
    snapshot_images(state, cur_nimg / 1000)
    if snap_writer is not None:
        snap_writer.wait()
    ckpt.wait(ckpt_dir)
    if ckpt.latest_step(ckpt_dir) != state.step:
        with span("checkpoint"):
            ckpt.save(ckpt_dir, state, cfg)
    log.write(f"done: {cur_nimg / 1000:.1f} kimg")
    tracer.flush()
    return state
