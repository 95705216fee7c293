"""The replica fleet: N shared-nothing replicas behind a router
(counterpart of ``paddlebox_tpu/serving/fleet.py``).

A :class:`ReplicaSet` owns N replicas, each with its own predictor (its
own weights and table on the device) and its own deadline batcher, behind
a least-outstanding :class:`Router`. Around them:

- health probes: a monitor thread evaluates every replica each
  ``serve_probe_interval`` seconds and publishes per-replica gauges;
- restarts: a replica whose worker died is rebuilt in its slot
  (``serving.replica_restarts``) under a
  :class:`~serving.supervisor.RestartSupervisor` (budget, backoff,
  circuit breaker);
- rerouting: a request that meets a dead or full replica is retried on
  the next one (``serving.rerouted``), within ``serve_retry_budget``
  attempts;
- drain on stop: ``stop()`` refuses new work and lets queued requests
  finish within ``serve_drain_timeout``;
- admission: ``attach_slo`` sheds load before parsing while an
  ``action=shed`` alert fires;
- ``start(metrics_port=...)`` serves the fleet's ``/metrics`` and
  ``/healthz`` (``obs/http.py``).

Scope (``serve_replica_scope``): replicas are threads of this process
(:class:`Replica`, each predictor a ``CTRPredictor`` on the card, built
by a factory), or each runs in its own spawned child
(``scope="process"``, :class:`~serving.proc.ProcReplica`, built from a
picklable worker spec). A hot reload swaps one replica at a time
(``serving/reload.py``).

The flags are read from their ``PBOX_FLAGS_*`` variables at
construction.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from paddlebox_tpu_torch.config import flag
from paddlebox_tpu_torch.data.parser import SlotParser
from paddlebox_tpu_torch.obs import heartbeat, trace
from paddlebox_tpu_torch.obs.http import ObsHttpServer
from paddlebox_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from paddlebox_tpu_torch.obs.slo import Rule, SloEngine
from paddlebox_tpu_torch.serving.batcher import (AdmissionController,
                                                 DeadlineBatcher, Overloaded,
                                                 ReplicaDead, RequestExpired,
                                                 ServingError)
from paddlebox_tpu_torch.serving.proc import ProcReplica, _mirror_launches
from paddlebox_tpu_torch.serving.supervisor import RestartSupervisor

#: () -> predictor. Each call returns a fresh predictor (``CTRPredictor``,
#: or anything with ``feed_conf``, ``predict_records`` and
#: ``model_version``): replicas share no mutable state. In process scope
#: the contract is a picklable worker spec (``serving/proc.py``).
PredictorFactory = Callable[[], object]


class NoHealthyReplica(ServingError):
    """Every replica was dead or full after rerouting."""


class RetryBudgetExhausted(ServingError):
    """The request spent its ``serve_retry_budget`` replica attempts."""


class Replica:
    """One thread-scope replica: predictor, deadline batcher and worker
    thread. ``swap_predictor`` is the hot-reload point: the reference is
    replaced under a lock between dispatches, so a batch in flight
    finishes on the old version and the next scores on the new."""

    scope = "thread"
    _death_counted = False           # the monitor's one count a death

    def __init__(self, name: str, factory: PredictorFactory,
                 max_pending: Optional[int] = None,
                 margin_ms: Optional[float] = None,
                 registry: MetricsRegistry = REGISTRY):
        self.name = name
        self.factory = factory
        self.registry = registry
        self._pred_lock = threading.Lock()
        self._predictor = factory()
        self.batcher = DeadlineBatcher(
            self._score, max_batch=self._predictor.feed_conf.batch_size,
            margin_ms=margin_ms, max_pending=max_pending, name=name,
            registry=registry)
        self._t_start: Optional[float] = None

    # -- model ---------------------------------------------------------------

    @property
    def predictor(self):
        with self._pred_lock:
            return self._predictor

    @property
    def feed_conf(self):
        """The surface :class:`~serving.proc.ProcReplica` shares."""
        return self.predictor.feed_conf

    def swap_predictor(self, predictor) -> None:
        """The atomic per-replica model swap (``serving/reload.py``)."""
        with self._pred_lock:
            self._predictor = predictor

    @property
    def model_version(self) -> Optional[str]:
        return getattr(self.predictor, "model_version", None)

    def _score(self, records):
        # one read a batch: a swap lands between dispatches
        pred = self.predictor
        t0 = time.perf_counter()
        scores = pred.predict_records(records)
        self.registry.observe(f"serving.replica.{self.name}.dispatch_ms",
                              (time.perf_counter() - t0) * 1e3)
        # the process's kernel launches as serve.launches.* gauges, as a
        # process child reports them (a serving host's /metrics reads them)
        _mirror_launches()
        return scores

    # -- lifecycle / health --------------------------------------------------

    def start(self) -> None:
        self._t_start = time.monotonic()
        self.batcher.start()

    def stop(self, drain_timeout: Optional[float] = None) -> None:
        self.batcher.stop(drain_timeout=drain_timeout)

    def kill(self) -> None:
        """Drill hook: the worker dies (the monitor restarts it)."""
        self.batcher.die()

    def alive(self) -> bool:
        return self.batcher.alive()

    def outstanding(self) -> int:
        return self.batcher.outstanding()

    def submit(self, records, deadline: float):
        return self.batcher.submit(records, deadline)

    def health(self) -> Tuple[bool, Dict]:
        """The probe the fleet monitor runs."""
        ok = self.alive()
        stats_fn = getattr(self.predictor, "cache_stats", None)
        return ok, {
            "name": self.name,
            "alive": ok,
            "outstanding": self.outstanding(),
            "model_version": self.model_version,
            "cache": stats_fn() if callable(stats_fn) else None,
            "uptime_s": round(time.monotonic() - self._t_start, 3)
            if self._t_start is not None else 0.0,
        }


class Router:
    """Least-outstanding dispatch over the live replicas."""

    def __init__(self, registry: MetricsRegistry = REGISTRY):
        self.registry = registry

    def pick(self, replicas: Sequence[Replica],
             exclude: Optional[set] = None) -> Optional[Replica]:
        """The live replica with the fewest queued and in-flight requests
        (ties by list order); ``exclude`` names the replicas a rerouted
        request already failed on."""
        best: Optional[Replica] = None
        best_depth = 0
        total = 0
        for r in replicas:
            if not r.alive():
                continue
            depth = r.outstanding()
            total += depth
            if exclude and r.name in exclude:
                continue
            if best is None or depth < best_depth:
                best, best_depth = r, depth
        self.registry.gauge("serving.router_queue_depth").set(total)
        return best


class ReplicaSet:
    """N replicas, router, monitor, admission and the fleet endpoint."""

    def __init__(self, factory: Optional[PredictorFactory],
                 replicas: Optional[int] = None,
                 max_pending: Optional[int] = None,
                 margin_ms: Optional[float] = None,
                 probe_interval: Optional[float] = None,
                 registry: MetricsRegistry = REGISTRY,
                 scope: Optional[str] = None,
                 worker_spec: Optional[Dict] = None,
                 supervisor: Optional[RestartSupervisor] = None):
        n = int(flag("serve_replicas")) if replicas is None \
            else int(replicas)
        if n < 1:
            raise ValueError(f"need at least one replica, got {n}")
        scope = str(flag("serve_replica_scope")) if scope is None \
            else str(scope)
        if scope not in ("thread", "process"):
            raise ValueError(
                f"serve_replica_scope must be 'thread' or 'process', "
                f"got {scope!r}")
        if scope == "process":
            # a closure cannot cross the process boundary: a spec can
            if worker_spec is None and isinstance(factory, dict):
                worker_spec, factory = factory, None
            if worker_spec is None:
                raise ValueError(
                    "scope='process' needs a worker_spec dict "
                    "(serving/proc.py); a predictor factory closure "
                    "cannot cross the process boundary")
        elif not callable(factory):
            raise ValueError(
                "scope='thread' needs a callable predictor factory"
                + (" — a worker_spec dict only applies to "
                   "scope='process'"
                   if worker_spec is not None or isinstance(factory, dict)
                   else f", got {factory!r}"))
        self._scope = scope
        self._worker_spec = dict(worker_spec) if worker_spec else None
        self.factory = factory
        self.registry = registry
        self.supervisor = supervisor if supervisor is not None \
            else RestartSupervisor(registry=registry)
        self._max_pending = max_pending
        self._margin_ms = margin_ms
        self._probe_s = (float(flag("serve_probe_interval"))
                         if probe_interval is None
                         else float(probe_interval))
        # the monitor replaces entries on restart
        self._replicas: List[Replica] = (   # guarded-by: _lock
            self._build_initial(n))
        self._lock = threading.Lock()
        self.router = Router(registry=registry)
        self.admission = AdmissionController(registry=registry)
        self.parser = SlotParser(self._replicas[0].feed_conf)
        self._closed = threading.Event()
        self._started = False
        self._monitor: Optional[threading.Thread] = None
        self._obs_http: Optional[ObsHttpServer] = None
        self.metrics_address: Optional[Tuple[str, int]] = None

    @classmethod
    def from_bundle(cls, bundle_path: str, replicas: Optional[int] = None,
                    scope: Optional[str] = None,
                    ps_endpoints: Optional[List[str]] = None,
                    ps_table: str = "embedding", device=None,
                    **kw) -> "ReplicaSet":
        """Each replica loads its own ``CTRPredictor`` over one bundle on
        ``device`` (default ``cuda``): in this process (``scope='thread'``)
        or in its own child (``scope='process'``). ``ps_endpoints`` points
        every replica at a PS service (``ps/service/``) instead of the
        bundle's table: the replicas pull rows on demand and load no table
        each."""
        scope = str(flag("serve_replica_scope")) if scope is None \
            else str(scope)
        if scope == "process":
            spec = {"bundle": bundle_path}
            if device is not None:
                spec["device"] = str(device)
            if ps_endpoints:
                spec["ps_endpoints"] = list(ps_endpoints)
                spec["ps_table"] = ps_table
            return cls(None, replicas=replicas, scope="process",
                       worker_spec=spec, **kw)
        from paddlebox_tpu_torch.inference.predictor import CTRPredictor

        return cls(lambda: CTRPredictor(bundle_path, device=device,
                                        ps_endpoints=ps_endpoints,
                                        ps_table=ps_table),
                   replicas=replicas, scope=scope, **kw)

    @property
    def scope(self) -> str:
        return self._scope

    def _build_initial(self, n: int) -> List[Replica]:
        """Build the fleet: process-scope replicas spawn at once (each pays
        an interpreter, a CUDA context and a bundle load); thread scope is
        serial, a factory need not be reentrant."""
        if self._scope != "process" or n == 1:
            return [self._new_replica(f"r{i}") for i in range(n)]
        out: List[Optional[Replica]] = [None] * n
        errs: List[Exception] = []

        def build(i: int) -> None:
            try:
                out[i] = self._new_replica(f"r{i}")
            except Exception as e:  # noqa: BLE001 - raised below
                errs.append(e)

        threads = [threading.Thread(target=build, args=(i,),
                                    name=f"serve-spawn-r{i}")
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            for r in out:
                if r is not None:
                    r.stop(drain_timeout=0.0)
            raise errs[0]
        return list(out)

    def _new_replica(self, name: str):
        if self._scope == "process":
            return ProcReplica(name, self._worker_spec,
                               max_pending=self._max_pending,
                               margin_ms=self._margin_ms,
                               registry=self.registry)
        return Replica(name, self.factory, max_pending=self._max_pending,
                       margin_ms=self._margin_ms, registry=self.registry)

    def retarget(self, bundle_path: str, plan) -> None:
        """Point monitor restarts at a newer committed plan: the reload
        calls this before swapping live replicas, so a restart mid-rollout
        rebuilds on the version being rolled out."""
        if self._scope == "process":
            spec = dict(self._worker_spec or {})
            spec["bundle"] = bundle_path
            spec["plan"] = tuple(plan)
            self._worker_spec = spec        # a fresh spec, published whole
        else:
            from paddlebox_tpu_torch.serving.reload import \
                load_predictor_from_plan

            device = getattr(self.replicas[0].predictor, "device", None)
            self.factory = (lambda: load_predictor_from_plan(
                bundle_path, plan, device=device))

    # -- lifecycle -----------------------------------------------------------

    @property
    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas)

    def start(self, metrics_port: Optional[int] = None) -> "ReplicaSet":
        """Start every replica and the monitor; ``metrics_port`` also
        serves the fleet's ``/metrics`` and ``/healthz`` (0 = free port,
        in ``.metrics_address``)."""
        if self._closed.is_set():
            raise RuntimeError("fleet already stopped")
        self._started = True
        for r in self.replicas:
            r.start()
        # published before the monitor runs: a racing stop() sees it
        if metrics_port is not None:
            self._obs_http = ObsHttpServer(
                registry=self.registry, health_fn=self.health,
                port=metrics_port)
            self.metrics_address = self._obs_http.start()
        th = threading.Thread(target=self._monitor_loop, daemon=True,
                              name="serve-monitor")
        self._monitor = th
        th.start()
        return self

    def stop(self, drain_timeout: Optional[float] = None) -> None:
        """Drain on stop: admission closes, queued work finishes
        (bounded), then replicas, monitor and endpoint come down."""
        self._closed.set()
        self.admission.detach()
        mon = self._monitor
        if mon is not None and mon.is_alive():
            mon.join(timeout=self._probe_s * 4 + 1.0)
        for r in self.replicas:
            r.stop(drain_timeout=drain_timeout)
        if self._obs_http is not None:
            self._obs_http.stop()

    def __enter__(self) -> "ReplicaSet":
        if not self._started:
            self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- monitor -------------------------------------------------------------

    def _monitor_loop(self) -> None:
        while not self._closed.wait(self._probe_s):
            self._probe_once()

    def _probe_once(self) -> int:
        """One monitor tick: probe, and restart dead replicas under the
        supervisor. Returns how many it restarted (tests call it
        directly)."""
        restarted = 0
        with self._lock:
            entries = list(enumerate(self._replicas))
        for i, r in entries:
            ok, detail = r.health()
            self.registry.gauge(
                f"serving.replica.{r.name}.healthy").set(1.0 if ok else 0.0)
            self.registry.gauge(
                f"serving.replica.{r.name}.outstanding").set(
                    detail["outstanding"])
            if ok:
                self.supervisor.note_healthy(r.name)
                continue
            if self._closed.is_set():
                continue
            with self._lock:
                # one budget event a death, however many ticks (racing
                # ones included) see it
                counted, r._death_counted = r._death_counted, True
            if not counted:
                self.supervisor.record_death(r.name)
            if not self.supervisor.allow_restart(r.name):
                continue             # backing off or quarantined
            try:
                fresh = self._new_replica(r.name)
            except Exception:
                # the slot stays dead; the supervisor decides when to try
                self.registry.add("serving.replica_restart_failures")
                self.supervisor.record_restart_failure(r.name)
                continue
            fresh.start()
            with self._lock:
                # install over the same dead replica of a running fleet
                # only: else the fresh one would leak its worker
                installed = (not self._closed.is_set()
                             and self._replicas[i] is r)
                if installed:
                    self._replicas[i] = fresh
                    restarted += 1
            if not installed:
                fresh.stop(drain_timeout=0.0)
        if restarted:
            self.registry.add("serving.replica_restarts", restarted)
        return restarted

    # -- admission / SLO -----------------------------------------------------

    def attach_slo(self, engine: SloEngine,
                   rules: Optional[Sequence[Rule]] = None) -> SloEngine:
        """Shed load fleet-wide, before parsing, while ``engine``'s
        ``action=shed`` alerts fire."""
        return self.admission.attach(engine, rules=rules)

    # -- request path --------------------------------------------------------

    def predict_lines(self, lines: Sequence[str],
                      deadline_ms: Optional[float] = None) -> np.ndarray:
        """Text lines in, scores out; admission is checked before
        parsing."""
        self.admission.check()
        records = [self.parser.parse_line(ln) for ln in lines]
        return self.predict_records(records, deadline_ms=deadline_ms)

    def predict_records(self, records: Sequence,
                        deadline_ms: Optional[float] = None,
                        idempotent: bool = True) -> np.ndarray:
        """Route one request: the least-outstanding replica, rerouted on
        dead or full ones within ``serve_retry_budget`` attempts, failed
        when every live replica refused, the budget ran out or the
        deadline (``serve_deadline_ms`` by default) passed.

        ``idempotent=False``: a request whose replica dies while it is in
        flight fails with ``ReplicaDead`` instead of running again
        (scoring is pure, so the default retries it, counted in
        ``serving.retried_inflight``)."""
        t0 = time.perf_counter()
        self.admission.check()
        adm_ms = (time.perf_counter() - t0) * 1e3
        self.registry.observe("serve.hop.admission_ms", adm_ms)
        if deadline_ms is None:
            deadline_ms = float(flag("serve_deadline_ms"))
        deadline = time.monotonic() + deadline_ms / 1e3
        self.registry.add("serving.requests")
        try:
            with trace.span("fleet.route", rows=len(records)):
                scores = self._route(records, deadline,
                                     idempotent=idempotent)
        except Exception:
            self.registry.add("serving.errors")
            raise
        lat_ms = (time.perf_counter() - t0) * 1e3
        # serve.request_ms feeds the shipped p99 shed rule
        self.registry.observe("serve.request_ms", lat_ms)
        self.registry.observe("serving.request_ms", lat_ms)
        self.registry.add("serving.rows", len(scores))
        exemplar_ms = float(flag("obs_exemplar_ms"))
        if exemplar_ms > 0 and lat_ms > exemplar_ms:
            # a slow request's exemplar: its trace id and hop split
            ctx = trace.current()
            heartbeat.emit(
                "slow_request",
                trace_id=ctx.trace_id if ctx is not None else None,
                hop=ctx.hop if ctx is not None else None,
                total_ms=round(lat_ms, 3),
                admission_ms=round(adm_ms, 3),
                route_ms=round(lat_ms - adm_ms, 3),
                rows=len(scores))
        return scores

    def _route(self, records, deadline: float,
               idempotent: bool = True) -> np.ndarray:
        tried: set = set()
        last_err: Optional[Exception] = None
        budget = max(1, int(flag("serve_retry_budget")))
        attempts = 0
        while time.monotonic() < deadline:
            if attempts >= budget:
                raise RetryBudgetExhausted(
                    f"request spent its serve_retry_budget ({budget} "
                    f"replica attempts)") from last_err
            rep = self.router.pick(self.replicas, exclude=tried)
            if rep is None:
                if not tried:
                    raise NoHealthyReplica("no live replica in the fleet")
                raise last_err if last_err is not None else \
                    NoHealthyReplica("all replicas refused")
            try:
                fut = rep.submit(records, deadline)
            except (ReplicaDead, Overloaded) as e:
                # refused at the queue, never dispatched: safe to reroute
                attempts += 1
                tried.add(rep.name)
                last_err = e
                self.registry.add("serving.rerouted")
                continue
            attempts += 1
            try:
                return fut.result(
                    timeout=max(0.0, deadline - time.monotonic()) + 0.25)
            except ReplicaDead as e:
                # the replica died under the request, maybe mid-dispatch
                if not idempotent:
                    raise
                tried.add(rep.name)
                last_err = e
                self.registry.add("serving.rerouted")
                self.registry.add("serving.retried_inflight")
                continue
            except FuturesTimeout:
                self.registry.add("serving.deadline_misses")
                raise RequestExpired(
                    "admission deadline passed awaiting dispatch"
                ) from None
        raise last_err if last_err is not None else ServingError(
            "request deadline passed before any replica accepted it")

    def warm(self, lines: Sequence[str],
             deadline_ms: float = 60000.0) -> None:
        """One request through every replica, so each pays its first
        dispatch before traffic with deadlines."""
        records = [self.parser.parse_line(ln) for ln in lines]
        budget = deadline_ms / 1e3
        for rep in self.replicas:
            fut = rep.submit(records, time.monotonic() + budget)
            fut.result(timeout=budget)

    # -- introspection -------------------------------------------------------

    def versions(self) -> List[Optional[str]]:
        return [r.model_version for r in self.replicas]

    def healthy_count(self) -> int:
        return sum(1 for r in self.replicas if r.alive())

    def health(self) -> Tuple[bool, Dict]:
        """The fleet's ``/healthz``: healthy when every replica is alive
        and no attached shed alert fires."""
        reps = [r.health()[1] for r in self.replicas]
        healthy = sum(1 for d in reps if d["alive"])
        firing = self.admission.firing()
        quarantined = self.supervisor.quarantined_names()
        ok = (self._started and not self._closed.is_set()
              and healthy == len(reps) and not firing)
        return ok, {
            "replicas": reps,
            "healthy": healthy,
            "size": len(reps),
            "scope": self._scope,
            "router_queue_depth": sum(d["outstanding"] for d in reps),
            "shedding": self.admission.shedding,
            "versions": [d["model_version"] for d in reps],
            "quarantined": quarantined,
            "alerts": {"firing_count": len(firing),
                       "firing": [{"rule": a["rule"],
                                   "metric": a["metric"]}
                                  for a in firing]},
        }
