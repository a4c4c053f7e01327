"""The replica fleet: placement, routing and autoscaled dispatch (the
counterpart of ``gansformer_tpu/serve/replicas.py``).

One ``GenerationService`` keeps one card busy.  A ``ReplicaSet`` serves
across cards with one whole replica per card, not one model sharded over
them:

* **Placement.**  Each ``Replica`` owns a ``ServePrograms`` over a bundle
  on its device.  The default is one replica per visible card
  (``cuda:0 … cuda:{n-1}``) for a bundle on the card, or one on the host
  for a bundle on the CPU; ``devices=`` names the members (repeats
  allowed: ``[cuda:0, cuda:0]`` rehearses routing on one card,
  ``[cpu] * N`` does on the host).
* **Routing.**  ``submit`` gives each request to the least-loaded
  accepting replica (queued and in-flight tickets, ``service.load()``).
  A replica whose breaker tripped, or that is draining, stops accepting
  and the router walks past it; a refusal between the load sample and
  the submit walks on to the next replica, and the last typed refusal
  propagates when all refused.
* **Autoscaling.**  An optional controller thread samples the fleet
  every ``autoscale_interval_s``: it scales OUT on sustained queue
  saturation (a leading signal, ticks before a breaker could trip) and
  IN on batch-fill collapse with empty queues, under hysteresis
  (consecutive ticks, a cooldown) and the ``min_replicas`` /
  ``max_replicas`` bounds.  A deactivated replica drains; its programs
  stay, so reactivating it builds nothing.

An image is a pure function of ``(seed, psi, noise_seed)`` wherever it
is served: row noise comes from ``noise_generators(seed, tags, device)``
with the request seeds as tags, and a CUDA ``torch.Generator`` seeded
alike draws the same stream on every card, so placement never enters
the random path.

Where the port differs from JAX here:

* **Copies of the bundle.**  ``bundle_from_generator`` moves a module in
  place (``generator.to(dev)``), so building replica 1 from replica 0's
  bundle would drag replica 0's weights to replica 1's card.  Each device
  gets its own deep copy, made once, and members on one device share it.
* **int8w.**  The quantized codes and scales (``serve/quant.py``) are
  made by each replica's ``ServePrograms`` from the bundle on its own
  device, so no replica reads another card's weights.
* **One kernel library a process.**  JAX fingerprints each replica's
  warm-start manifest with its device ordinal, since its executables
  belong to a device.  The port's manifest holds one ``sm_90a`` library
  that every card loads, so ``warm_start`` builds or adopts it once.
  Each card still loads the library's module at its first launch, so
  ``warm_start`` also runs one smallest-bucket ``map_seeds`` +
  ``synthesize`` per active replica on its card; a replica the
  autoscaler activates later pays that under the service's
  ``hang_startup_grace_s``.
* **The current device.**  The dispatcher thread of each member makes
  its programs' device current; the kernels' wrappers launch under their
  input's device (``ops/_build.on_device``), so a launch from any other
  thread reaches the right card too.

Telemetry (fleet level; members export ``serve/replica<i>/...``):
``serve/replicas`` (active count), ``serve/health_state``,
``serve/dispatcher_alive`` (any alive), ``serve/queue_depth_now`` and
``serve/queue_bound`` (sums), the counters ``serve/scale_out_total`` and
``serve/scale_in_total``, and the router's
``serve/replica<i>/requests_total`` (dispatch share).  Scale and breaker
events carry monotonic timestamps in ``ReplicaSet.events``, so a drill
can show that the scale-out came before the first breaker trip.
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from gansformer_tpu_torch.obs import registry as telemetry
from gansformer_tpu_torch.serve.programs import (DEFAULT_BUCKETS,
                                                 SERVE_PRECISIONS,
                                                 GeneratorBundle,
                                                 ServePrograms)
from gansformer_tpu_torch.serve.service import (HEALTH_CLOSED,
                                                HEALTH_NAMES,
                                                HEALTH_UNHEALTHY,
                                                GenerationService,
                                                ServiceClosed,
                                                ServiceUnhealthy, Ticket)


def fleet_devices(device: torch.device) -> List[torch.device]:
    """The default members for a bundle on ``device``: every visible card,
    or the host."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the card it means now (``cuda:<current>``), so that a
    device compares equal to the device of a tensor on it."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Replica:
    """One serving member: ordinal, device, programs and a service that
    is re-created at each activation.  ``programs`` survives
    deactivation."""

    def __init__(self, ordinal: int, device: torch.device,
                 programs: ServePrograms) -> None:
        self.ordinal = int(ordinal)
        self.device = device
        self.programs = programs
        self.service: Optional[GenerationService] = None

    @property
    def active(self) -> bool:
        return self.service is not None


class ReplicaSet:
    """The fleet: a replica per device, least-loaded routing and an
    optional autoscaler, with ``GenerationService``'s verbs (``submit``,
    ``health``, ``close``)."""

    def __init__(self, bundle: GeneratorBundle,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 manifest_dir: Optional[str] = None,
                 warm_start: bool = True,
                 serve_precision: str = "f32",
                 replicas: Optional[int] = None,
                 min_replicas: int = 1,
                 max_replicas: Optional[int] = None,
                 autoscale: bool = False,
                 autoscale_interval_s: float = 0.25,
                 scale_out_saturation: float = 0.8,
                 scale_out_ticks: int = 3,
                 scale_in_fill: float = 0.25,
                 scale_in_ticks: int = 8,
                 cooldown_s: float = 2.0,
                 service_kwargs: Optional[Dict[str, Any]] = None,
                 devices: Optional[Sequence[Any]] = None) -> None:
        if serve_precision not in SERVE_PRECISIONS:
            raise ValueError(f"serve_precision must be one of "
                             f"{SERVE_PRECISIONS}, got {serve_precision!r}")
        self._devices = ([_indexed(torch.device(d)) for d in devices]
                         if devices is not None
                         else fleet_devices(bundle.device))
        n_dev = len(self._devices)
        self.max_replicas = min(int(max_replicas or n_dev), n_dev)
        self.min_replicas = max(1, min(int(min_replicas),
                                       self.max_replicas))
        start = int(replicas) if replicas is not None else self.min_replicas
        if not (1 <= start <= self.max_replicas):
            raise ValueError(
                f"replicas={start} out of range [1, {self.max_replicas}] "
                f"({n_dev} local device(s))")
        self._bundle = bundle
        self._bundles: Dict[torch.device, GeneratorBundle] = {
            bundle.device: bundle}
        self._program_kwargs = dict(buckets=buckets,
                                    manifest_dir=manifest_dir,
                                    warm_start=warm_start,
                                    serve_precision=serve_precision)
        self.serve_precision = serve_precision
        self._service_kwargs = dict(service_kwargs or {})
        self._lock = threading.RLock()
        self._replicas: List[Replica] = []
        self._closed = False
        # scale and breaker events on the monotonic clock (compare their
        # t's with each other, never with a wall clock)
        self.events: List[Dict[str, Any]] = []
        self._tripped_seen: set = set()
        self._sat_ticks = 0
        self._idle_ticks = 0
        self._last_scale_t = -float("inf")
        self._fill_marks: Dict[int, tuple] = {}
        self._autoscale_cfg = {
            "interval_s": float(autoscale_interval_s),
            "out_saturation": float(scale_out_saturation),
            "out_ticks": int(scale_out_ticks),
            "in_fill": float(scale_in_fill),
            "in_ticks": int(scale_in_ticks),
            "cooldown_s": float(cooldown_s),
        }
        for name in ("serve/scale_out_total", "serve/scale_in_total"):
            telemetry.counter(name)
        for _ in range(start):
            self._activate_one(record_event=False)
        self._update_fleet_gauges()
        self._scaler: Optional[threading.Thread] = None
        self._scaler_stop = threading.Event()
        if autoscale:
            self._scaler = threading.Thread(
                target=self._autoscale_loop, name="serve-autoscaler",
                daemon=True)
            self._scaler.start()

    # -- membership ----------------------------------------------------------

    @property
    def active_replicas(self) -> List[Replica]:
        with self._lock:
            return [r for r in self._replicas if r.active]

    @property
    def n_active(self) -> int:
        return len(self.active_replicas)

    def _bundle_on(self, device: torch.device) -> GeneratorBundle:
        """The bundle on ``device``: the caller's where it lies, else one
        deep copy per device, shared by its members (the caller's bundle
        stays where it is)."""
        if device not in self._bundles:
            b = self._bundle
            gen = copy.deepcopy(b.generator).to(device)
            self._bundles[device] = GeneratorBundle(
                cfg=b.cfg, generator=gen.eval().requires_grad_(False),
                w_avg=b.w_avg.to(device))
        return self._bundles[device]

    def _activate_one(self, record_event: bool = True) -> Optional[Replica]:
        """Bring up the lowest inactive ordinal: its Replica and programs
        are made at its first activation and reused after."""
        with self._lock:
            if self._closed:
                return None
            target = next((r for r in self._replicas if not r.active), None)
            if target is None:
                if len(self._replicas) >= self.max_replicas:
                    return None
                ordinal = len(self._replicas)
                dev = self._devices[ordinal]
                target = Replica(ordinal, dev, ServePrograms(
                    self._bundle_on(dev), **self._program_kwargs))
                self._replicas.append(target)
            target.service = GenerationService(
                target.programs, replica_id=target.ordinal,
                **self._service_kwargs)
            # the router's dispatch-share counter, an explicit zero first
            telemetry.counter(
                f"serve/replica{target.ordinal}/requests_total")
            if record_event:
                telemetry.counter("serve/scale_out_total").inc()
                self.events.append({"kind": "scale_out",
                                    "replica": target.ordinal,
                                    "n_active": self.n_active,
                                    "t": time.monotonic()})
            self._update_fleet_gauges()
            return target

    def _deactivate_one(self, timeout: float = 30.0) -> Optional[int]:
        """Drain and retire the highest active ordinal (its programs
        stay for a later activation)."""
        with self._lock:
            candidates = [r for r in self._replicas if r.active]
            if len(candidates) <= self.min_replicas:
                return None
            target = candidates[-1]
            svc, target.service = target.service, None
            telemetry.counter("serve/scale_in_total").inc()
            self.events.append({"kind": "scale_in",
                                "replica": target.ordinal,
                                "n_active": self.n_active,
                                "t": time.monotonic()})
            self._update_fleet_gauges()
        svc.close(timeout=timeout)
        return target.ordinal

    scale_out = _activate_one
    scale_in = _deactivate_one

    def warm_start(self) -> Dict[str, Any]:
        """Ready the active replicas: the kernel library once for the
        process (from the manifest, else built), then one smallest-bucket
        map + synthesize on each active replica's card, which loads the
        library's module there.  Returns {loaded, compiled, seconds}."""
        active = self.active_replicas
        out = {"loaded": 0, "compiled": 0, "seconds": 0.0}
        if not active:
            return out
        stats = active[0].programs.warm_start()
        for k in out:
            out[k] += stats[k]
        for r in active:
            if r.device.type != "cuda":
                continue
            t0 = time.perf_counter()
            p = r.programs
            b = p.buckets[0]
            p.synthesize(p.map_seeds([0] * b), [1.0] * b)
            torch.cuda.synchronize(r.device)
            out["seconds"] += time.perf_counter() - t0
        return out

    # -- routing -------------------------------------------------------------

    def submit(self, seed: int, psi: float = 0.7, label=None,
               deadline_s: Optional[float] = None) -> Ticket:
        """Route one request to the least-loaded accepting replica.  A
        replica that refuses (sheds, or tripped since the load sample) is
        skipped for the next; the last refusal propagates, typed, when
        every replica refused."""
        with self._lock:
            if self._closed:
                raise ServiceClosed("replica set is closed")
            ranked = sorted(
                (r for r in self._replicas
                 if r.active and r.service.accepting()),
                key=lambda r: r.service.load())
        if not ranked:
            raise ServiceUnhealthy(
                "no accepting replica (all tripped, draining, or closed)")
        last_err: Optional[Exception] = None
        for r in ranked:
            try:
                t = r.service.submit(seed, psi, label, deadline_s)
            except Exception as e:       # the service's typed refusals
                last_err = e
                continue
            telemetry.counter(
                f"serve/replica{r.ordinal}/requests_total").inc()
            self._update_fleet_gauges()
            return t
        raise last_err

    # -- fleet health --------------------------------------------------------

    def _update_fleet_gauges(self) -> None:
        with self._lock:
            active = [r for r in self._replicas if r.active]
            telemetry.gauge("serve/replicas").set(len(active))
            if not active:
                telemetry.gauge("serve/dispatcher_alive").set(0)
                telemetry.gauge("serve/queue_depth_now").set(0)
                telemetry.gauge("serve/health_state").set(
                    HEALTH_CLOSED if self._closed else HEALTH_UNHEALTHY)
                return
            depth = bound = 0
            any_alive = False
            for r in active:
                svc = r.service
                with svc._cv:
                    depth += len(svc._pending)
                bound += svc._max_queue_depth
                any_alive = any_alive or svc._worker.alive
            telemetry.gauge("serve/dispatcher_alive").set(
                1 if any_alive else 0)
            telemetry.gauge("serve/queue_depth_now").set(depth)
            telemetry.gauge("serve/queue_bound").set(bound)

    def health(self) -> dict:
        """The fleet's state is its healthiest member's (the fleet serves
        while some replica can), with every member's report and the tail
        of the scale events; sets the fleet gauges, as
        ``GenerationService.health`` sets its own."""
        with self._lock:
            members = list(self._replicas)
            closed = self._closed
        reports = []
        for r in members:
            if r.active:
                reports.append(r.service.health())
            else:
                reports.append({"state": "inactive", "state_code": None,
                                "replica_id": r.ordinal, "reasons": [],
                                "queue_depth": 0})
        codes = [rep["state_code"] for rep in reports
                 if rep["state_code"] is not None]
        state = min(codes) if codes else (
            HEALTH_CLOSED if closed else HEALTH_UNHEALTHY)
        reasons = [f"replica {rep['replica_id']}: {why}"
                   for rep in reports for why in rep.get("reasons", [])]
        self._update_fleet_gauges()
        telemetry.gauge("serve/health_state").set(state)
        return {"state": HEALTH_NAMES[state], "state_code": state,
                "replicas": reports, "n_active": self.n_active,
                "n_devices": len(self._devices),
                "reasons": reasons,
                "scale_events": list(self.events[-16:])}

    # -- autoscaler ----------------------------------------------------------

    def _autoscale_tick(self, now: Optional[float] = None) -> Optional[str]:
        """One controller step (the thread loops it; tests drive it with
        their own ``now``).  Returns 'out' or 'in' when it scaled."""
        cfg = self._autoscale_cfg
        now = time.monotonic() if now is None else now
        with self._lock:
            active = [r for r in self._replicas if r.active]
            depth = bound = 0
            batches = 0
            fills: List[float] = []
            for r in active:
                svc = r.service
                if svc._tripped and r.ordinal not in self._tripped_seen:
                    # the trailing failure signal, logged for the drill's
                    # scale-out-before-breaker order
                    self._tripped_seen.add(r.ordinal)
                    self.events.append({"kind": "breaker_trip",
                                        "replica": r.ordinal,
                                        "n_active": len(active),
                                        "t": now})
                with svc._cv:
                    depth += len(svc._pending)
                bound += svc._max_queue_depth
                h = telemetry.histogram(svc._g("serve/batch_fill"))
                prev_n, prev_sum = self._fill_marks.get(r.ordinal, (0, 0.0))
                dn, ds = h.count - prev_n, h.sum - prev_sum
                self._fill_marks[r.ordinal] = (h.count, h.sum)
                batches += dn
                if dn > 0:
                    fills.append(ds / dn)
        saturation = (depth / bound) if bound else 0.0
        recent_fill = (sum(fills) / len(fills)) if fills else None
        # out: sustained saturation, the leading signal
        if saturation >= cfg["out_saturation"]:
            self._sat_ticks += 1
        else:
            self._sat_ticks = 0
        # in: batches mostly padding, or none, with empty queues
        collapsed = (depth == 0
                     and (batches == 0
                          or (recent_fill is not None
                              and recent_fill < cfg["in_fill"])))
        self._idle_ticks = self._idle_ticks + 1 if collapsed else 0
        in_cooldown = (now - self._last_scale_t) < cfg["cooldown_s"]
        if (self._sat_ticks >= cfg["out_ticks"] and not in_cooldown
                and self.n_active < self.max_replicas):
            if self._activate_one() is not None:
                self._sat_ticks = 0
                self._last_scale_t = now
                return "out"
        if (self._idle_ticks >= cfg["in_ticks"] and not in_cooldown
                and self.n_active > self.min_replicas):
            if self._deactivate_one() is not None:
                self._idle_ticks = 0
                self._last_scale_t = now
                return "in"
        return None

    def _autoscale_loop(self) -> None:
        interval = self._autoscale_cfg["interval_s"]
        while not self._scaler_stop.wait(interval):
            try:
                self._autoscale_tick()
            except Exception:
                # the controller never takes the fleet down: a failed
                # tick is dropped and the next one samples afresh
                pass

    # -- lifecycle -----------------------------------------------------------

    def install_signal_drain(self, grace_s: float = 30.0) -> bool:
        """SIGTERM → ``close(grace_s)`` on a thread of its own; only the
        main thread may install it (returns whether it did)."""
        import signal

        if threading.current_thread() is not threading.main_thread():
            return False

        def _on_term(signum, frame):
            threading.Thread(target=self.close,
                             kwargs={"timeout": grace_s},
                             name="serve-fleet-sigterm-drain",
                             daemon=True).start()

        try:
            signal.signal(signal.SIGTERM, _on_term)
        except (ValueError, OSError):
            return False
        return True

    def close(self, timeout: float = 30.0) -> None:
        """Stop the controller, then drain every active member within
        ``timeout``."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            members = [r for r in self._replicas if r.active]
        self._scaler_stop.set()
        if self._scaler is not None:
            self._scaler.join(timeout=max(1.0, timeout))
        for r in members:
            svc, r.service = r.service, None
            svc.close(timeout=timeout)
        with self._lock:
            self._update_fleet_gauges()
            telemetry.gauge("serve/health_state").set(HEALTH_CLOSED)

    def __enter__(self) -> "ReplicaSet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
