"""Deadline-driven dynamic batching and admission control (counterpart of
``paddlebox_tpu/serving/batcher.py``).

Every request carries an admission deadline, and a forming batch closes
on the first of

    max_batch reached
    earliest deadline in the batch - margin     (the deadline bound)
    first arrival + batch_wait                  (the fill cap)

so a tight-deadline request drags its batch forward instead of expiring
while it waits, and relaxed traffic still fills batches but never trades
more than ``batch_wait`` of latency for fill.

- :class:`DeadlineBatcher`: one bounded queue and worker thread per
  replica. A full queue rejects at once (``Overloaded``); a request whose
  deadline passed in the queue fails (``RequestExpired``) instead of
  taking a dispatch; a dead worker fails its stranded queue with
  ``ReplicaDead`` so the router reroutes.
- :class:`AdmissionController`: fleet-wide load shedding from the SLO
  engine: while an alert labelled ``action=shed`` fires, ``check()``
  raises ``SheddingLoad`` before any parsing.

The knobs are the reference's flags, read from their ``PBOX_FLAGS_*``
variables at construction: ``serve_batch_margin_ms``,
``serve_batch_wait_ms``, ``serve_max_pending``, ``serve_drain_timeout``.

Imports neither torch nor numpy (a replica child imports it before its
predictor).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence

from paddlebox_tpu_torch.config import flag
from paddlebox_tpu_torch.obs import postmortem, trace
from paddlebox_tpu_torch.obs import slo as obs_slo
from paddlebox_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from paddlebox_tpu_torch.obs.slo import Rule, SloEngine


class ServingError(RuntimeError):
    """Base error of the serving tier."""


class Overloaded(ServingError):
    """Bounded queue full: the replica rejected instead of buffering."""


class RequestExpired(ServingError):
    """The admission deadline passed while the request sat queued."""


class ReplicaDead(ServingError):
    """The batcher worker died (or was stopped) under this request; the
    router reroutes it to another replica."""


class SheddingLoad(ServingError):
    """Admission control rejected before parsing: a shed-labelled SLO
    alert is firing."""


class _Pending:
    __slots__ = ("records", "future", "deadline", "ctx", "enq_t")

    def __init__(self, records, future: Future, deadline: float,
                 ctx=None, enq_t: float = 0.0):
        self.records = records
        self.future = future
        self.deadline = deadline
        # the submitting thread's trace context: score_fn runs on the
        # worker thread, where the contextvar does not follow
        self.ctx = ctx
        self.enq_t = enq_t


class DeadlineBatcher:
    """Merge submitted requests into ``score_fn`` dispatches, each batch
    closing on ``min(max_batch, earliest deadline - margin, first arrival
    + batch_wait)``.

    ``score_fn(records) -> scores`` runs on the worker thread; a raising
    ``score_fn`` fails that batch's futures and the loop goes on. ``die()``
    makes the worker die on its next iteration (a drill), failing the
    stranded queue with ``ReplicaDead``."""

    def __init__(self, score_fn: Callable, max_batch: int,
                 margin_ms: Optional[float] = None,
                 batch_wait_ms: Optional[float] = None,
                 max_pending: Optional[int] = None,
                 name: str = "batcher",
                 registry: MetricsRegistry = REGISTRY):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.score_fn = score_fn
        self.max_batch = int(max_batch)
        self.margin_s = (float(flag("serve_batch_margin_ms"))
                         if margin_ms is None else float(margin_ms)) / 1e3
        self.batch_wait_s = (float(flag("serve_batch_wait_ms"))
                             if batch_wait_ms is None
                             else float(batch_wait_ms)) / 1e3
        depth = (int(flag("serve_max_pending"))
                 if max_pending is None else int(max_pending))
        self.name = name
        self.registry = registry
        self._q: "queue.Queue[_Pending]" = queue.Queue(maxsize=depth)
        self._closed = threading.Event()
        self._dead = threading.Event()     # set before the dying drain
        self._die_exc: Optional[BaseException] = None
        self._force_stop = False           # drain budget spent: just exit
        self._inflight = 0                 # guarded-by: _stat_lock
        self._stat_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"serve-{name}")
        self._started = False

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._started = True          # published before the loop runs
        self._thread.start()

    def stop(self, drain_timeout: Optional[float] = None) -> None:
        """Drain on stop: refuse new submissions, give queued and
        in-flight work ``drain_timeout`` seconds, then end the loop and
        fail what is left with ``ReplicaDead``."""
        if drain_timeout is None:
            drain_timeout = float(flag("serve_drain_timeout"))
        self._closed.set()
        deadline = time.monotonic() + max(0.0, drain_timeout)
        while time.monotonic() < deadline and self.outstanding() > 0 \
                and self._thread.is_alive():
            time.sleep(0.005)
        self._force_stop = True       # the loop exits without the fatal path
        if self._started and self._thread.is_alive():
            self._thread.join(timeout=1.0)
        self._fail_queue(ReplicaDead(f"replica {self.name} stopped"))

    def die(self, exc: Optional[BaseException] = None) -> None:
        """Drill hook: the worker dies on its next iteration (the fleet
        monitor brings the replica back)."""
        self._die_exc = exc or RuntimeError(
            f"replica {self.name}: injected worker death")

    def retire(self) -> None:
        """Mark the batcher dead without the fatal path: the fault domain
        (a replica child, ``serving/proc.py``) already died. ``alive()``
        turns False at once and the queue fails with ``ReplicaDead``;
        ``_dead`` is set first, closing the submit-vs-drain race as
        ``die()`` does."""
        self._dead.set()
        self._force_stop = True
        self._fail_queue(ReplicaDead(f"replica {self.name} worker died"))

    def alive(self) -> bool:
        return self._started and self._thread.is_alive() \
            and not self._closed.is_set() and not self._dead.is_set()

    # -- request side --------------------------------------------------------

    def submit(self, records: Sequence, deadline: float) -> Future:
        """Enqueue one request (``deadline`` on the ``time.monotonic``
        clock). Raises ``ReplicaDead``, ``RequestExpired`` or
        ``Overloaded`` instead of blocking: the router decides where to go
        next."""
        if not self.alive():
            raise ReplicaDead(f"replica {self.name} is not serving")
        if deadline <= time.monotonic():
            # a retry whose deadline already passed would only take a
            # dispatch nobody reads
            self.registry.add("serving.expired")
            raise RequestExpired(
                f"replica {self.name}: deadline already passed "
                f"at admission")
        fut: Future = Future()
        try:
            self._q.put_nowait(_Pending(records, fut, deadline,
                                        ctx=trace.current(),
                                        enq_t=time.monotonic()))
        except queue.Full:
            self.registry.add("serving.overloaded")
            raise Overloaded(
                f"replica {self.name} overloaded (queue full)") from None
        # the dying worker sets _dead before draining: a put that lands
        # after its drain sees _dead here and fails the queue itself
        if self._dead.is_set():
            self._fail_queue(ReplicaDead(f"replica {self.name} worker died"))
        return fut

    def outstanding(self) -> int:
        """Queued and in-dispatch requests: the router's dispatch key."""
        with self._stat_lock:
            return self._q.qsize() + self._inflight

    # -- worker --------------------------------------------------------------

    def _fail_queue(self, exc: Exception) -> None:
        while True:
            try:
                p = self._q.get_nowait()
            except queue.Empty:
                return
            if not p.future.done():
                p.future.set_exception(exc)

    def _loop(self) -> None:
        try:
            self._loop_impl()
        except Exception as e:
            postmortem.maybe_dump(f"serving.replica {self.name} died", exc=e)
            raise
        finally:
            # _dead first: submit() re-checks it after every put, so a
            # request racing this drain is failed by one side or the other
            self._dead.set()
            self._fail_queue(ReplicaDead(f"replica {self.name} worker died"))

    def _loop_impl(self) -> None:
        while not self._closed.is_set() or not self._q.empty():
            if self._die_exc is not None:
                raise self._die_exc
            if self._force_stop:
                return
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            self._dispatch(self._gather(first))

    def _gather(self, first: _Pending) -> List[_Pending]:
        """One batch: take from the queue until a full batch, the fill cap
        or the earliest deadline minus the margin, whichever is first."""
        batch = [first]
        rows = len(first.records)
        close_at = min(first.deadline - self.margin_s,
                       time.monotonic() + self.batch_wait_s)
        while rows < self.max_batch:
            wait = close_at - time.monotonic()
            if wait <= 0:
                break
            try:
                p = self._q.get(timeout=wait)
            except queue.Empty:
                break
            batch.append(p)
            rows += len(p.records)
            # a tighter deadline joining can only pull the close forward
            close_at = min(close_at, p.deadline - self.margin_s)
        return batch

    def _dispatch(self, batch: List[_Pending]) -> None:
        now = time.monotonic()
        live: List[_Pending] = []
        for p in batch:
            if p.deadline <= now:
                self.registry.add("serving.expired")
                p.future.set_exception(RequestExpired(
                    f"replica {self.name}: deadline passed in queue"))
            else:
                live.append(p)
        if not live:
            return
        with self._stat_lock:
            self._inflight += len(live)
        try:
            records = [r for p in live for r in p.records]
            self.registry.observe("serving.batch_rows", len(records))
            self.registry.observe("serving.batch_requests", len(live))
            for p in live:
                if p.enq_t:
                    self.registry.observe(
                        "serve.hop.queue_ms", (now - p.enq_t) * 1e3)
            # the dispatch is attributed to the request that opened it
            ctx = next((p.ctx for p in live if p.ctx is not None), None)
            t_score = time.perf_counter()
            try:
                with trace.activate(ctx), \
                        trace.span("batcher.dispatch", rows=len(records),
                                   requests=len(live)):
                    scores = self.score_fn(records)
            except Exception as e:
                for p in live:
                    p.future.set_exception(e)
                return
            self.registry.observe(
                "serve.hop.score_ms", (time.perf_counter() - t_score) * 1e3)
            o = 0
            for p in live:
                n = len(p.records)
                p.future.set_result(scores[o:o + n])
                o += n
        finally:
            with self._stat_lock:
                self._inflight -= len(live)


class AdmissionController:
    """Fleet-wide load shedding from an SLO engine: while any attached
    alert labelled ``action=shed`` fires, ``check()`` raises. Callers put
    it before parsing, so a degraded fleet answers cheaply."""

    def __init__(self, registry: MetricsRegistry = REGISTRY):
        self.registry = registry
        self._shedding = threading.Event()
        self._engine: Optional[SloEngine] = None

    def attach(self, engine: SloEngine,
               rules: Optional[Sequence[Rule]] = None) -> SloEngine:
        self._engine = engine
        if rules:
            engine.add_rules(rules)
        engine.add_callback(self._on_alert)
        # adopt the engine's state both ways: a shed alert already firing
        # (callbacks see only later transitions) sheds now, and shedding
        # left from an engine detached mid-incident clears
        if any(a["labels"].get("action") == "shed"
               for a in engine.firing()):
            self._shedding.set()
        else:
            self._shedding.clear()
        return engine

    def detach(self) -> None:
        """Unhook from the engine; with none left to resolve it, shedding
        clears too."""
        if self._engine is not None:
            self._engine.remove_callback(self._on_alert)
            self._engine = None
        self._shedding.clear()

    def _on_alert(self, alert, old: str, new: str) -> None:
        if alert.rule.labels.get("action") != "shed":
            return
        if new == obs_slo.FIRING:
            if not self._shedding.is_set():
                self.registry.add("serving.shed_entered")
            self._shedding.set()
        elif new == obs_slo.RESOLVED and self._engine is not None \
                and not any(a["labels"].get("action") == "shed"
                            for a in self._engine.firing()):
            if self._shedding.is_set():
                self.registry.add("serving.shed_exited")
            self._shedding.clear()

    @property
    def shedding(self) -> bool:
        return self._shedding.is_set()

    def firing(self) -> List[dict]:
        return self._engine.firing() if self._engine is not None else []

    def check(self) -> None:
        """Raise ``SheddingLoad`` while shedding."""
        if self._shedding.is_set():
            self.registry.add("serving.shed")
            raise SheddingLoad(
                "serving fleet shedding load (SLO alert firing)")
