"""Self-healing training loop: sentinel polling, anomaly detection and
automatic rollback to the last committed checkpoint (counterpart of
``paddlebox_tpu/trainer/guard.py``: the same policy, detectors, trip
records, counters and heartbeat events).

Three layers:

1. **The numeric sentinel.** ``fused_step.numeric_sentinel`` computes one
   device bool a step (any NaN/Inf across the loss, the dense grads and
   the embedding grads). Every dispatch hands ``(k, bad, loss)`` to
   :meth:`TrainGuard._on_step_outputs` on the training thread, which only
   enqueues the two tensors (each step makes them anew; nothing writes
   them in place), and wakes the poller thread once ``guard_sentinel_lag``
   steps have gone by since its last wake. The poller takes every entry
   that ``guard_sentinel_lag`` more steps have been dispatched past,
   queues one non-blocking copy of their flags and losses into a pinned
   buffer and an event behind it on the step's stream, waits on that
   event (a blocking one: never ``torch.cuda.synchronize()``, and no spin
   in the driver beside the training thread's launches) and reads the
   buffer, so the training thread makes no CUDA call and never waits for
   the device on the guard's behalf. The poller's CUDA calls, and its
   release of an entry's tensors, hold the run graphs' capture lock
   (``trainer/step_graph.py``): torch's global capture mode forbids CUDA
   calls on other threads while a run is captured.
2. **Windowed detectors** over what the poller reads: NaN/Inf (the
   sentinel), EWMA/z-score loss spikes, the pass AUC's collapse against a
   trailing baseline, and embedding-gradient blowup from the host table's
   non-finite clamp counter (``ps.nonfinite_grad_rows``).
3. **The recovery policy** (:class:`GuardPolicy`), an action a detector:
   ``skip`` (quarantine the window to the ingest sidecar and go on),
   ``rollback`` (quarantine, restore the tables and the dense state from
   the last committed checkpoint through ``ckpt/discovery.py``, and replay
   the pass past the window), ``abort`` (postmortem bundle, then
   :class:`GuardAbort`) and ``off`` (record only). A transient step error
   is retried (``utils/faults.with_retries``); more than
   ``guard_max_rollbacks`` rollbacks in one pass escalate to an abort.

``PBOX_FLAGS_check_nan_inf`` forces the NaN action to ``abort`` and
attaches a guard to every fused trainer (:func:`maybe_auto_guard`).

The rollback restores in place: ``apply_plan`` loads the tables into
their live arenas and mirrors, ``load_dense`` copies into the live
params and optimizer state, and the AUC state is zeroed in place, so a
captured run graph, which bakes in those addresses, replays the restored
state (a load that has to grow an arena moves it, and the graph's
``run_key`` then captures anew).

Kept apart from the reference on purpose: the transient set is ``OSError``
only. The reference also retries XLA's runtime error; a CUDA error leaves
the context unusable, so the port does not retry one.

:class:`GuardTripped` is a ``BaseException``: it is control flow from the
guard to :meth:`TrainGuard.run_pass`, and it passes through every
``except Exception`` (retry wrappers, fatal-site postmortems, the feeds'
cleanup) untouched.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch.ckpt import discovery as ckpt_discovery
from paddlebox_tpu_torch.config import flag
from paddlebox_tpu_torch.metrics.auc import reset_auc_state_
from paddlebox_tpu_torch.obs import heartbeat, postmortem
from paddlebox_tpu_torch.obs.metrics import REGISTRY
from paddlebox_tpu_torch.utils import faults

#: detector kinds, each with the policy field that names its action
KINDS = ("nan", "loss_spike", "auc_collapse", "emb_blowup")
ACTIONS = ("rollback", "skip", "abort", "off")


class GuardError(RuntimeError):
    """Base of the guard's failures."""


class GuardAbort(GuardError):
    """Hard stop: an abort-policy trip or a rollback escalation. A
    postmortem bundle (when armed) is committed before this raises."""

    def __init__(self, msg: str, trip: Optional["TripInfo"] = None):
        super().__init__(msg)
        self.trip = trip


class GuardTripped(BaseException):
    """A detector fired and :meth:`TrainGuard.run_pass` must interrupt the
    pass; raised only while ``run_pass`` drives.

    ``retrain_last``: True when the interruption precedes the training of
    the last batch yielded (the per-batch guarded step checks before it
    steps), so the replay must include that batch; False at segment and
    pass boundaries, where every yielded batch has trained."""

    def __init__(self, trip: "TripInfo", retrain_last: bool = False):
        super().__init__(f"guard tripped: {trip.kind} at step "
                         f"{trip.step} ({trip.detail})")
        self.trip = trip
        self.retrain_last = retrain_last


@dataclasses.dataclass(frozen=True)
class TripInfo:
    """One detector firing, in source batch indices (stable across replays
    of the same pass)."""

    kind: str                 # one of KINDS
    action: str               # the resolved policy action
    step: int                 # source batch index of the offending step
    window: Tuple[int, int]   # the window [lo, hi) to quarantine
    value: float              # loss, z-score, AUC or rows
    detail: str

    def to_dict(self) -> Dict:
        """The fields for a heartbeat record (``detector`` for ``kind``,
        which the heartbeat keeps for the record type)."""
        d = dataclasses.asdict(self)
        d["detector"] = d.pop("kind")
        d["window"] = list(d["window"])
        return d


@dataclasses.dataclass
class GuardPolicy:
    """The detector -> action map and the detectors' tuning. Defaults come
    from the ``guard_*`` flags (:meth:`from_flags`)."""

    on_nan: str = "rollback"
    on_loss_spike: str = "skip"
    on_auc_collapse: str = "rollback"
    on_emb_blowup: str = "skip"
    max_rollbacks: int = 2        # a run_pass; beyond: escalate
    step_retries: int = 3         # transient step errors (with_retries)
    lag: int = 8                  # the sentinel poll's lag, in steps
    quarantine_window: int = 16   # steps quarantined from a trip on
    loss_z: float = 6.0           # z-score threshold of the spike detector
    loss_ewma: float = 0.05       # EWMA smoothing of mean and variance
    loss_warmup: int = 32         # steps before the spike detector judges
    auc_window: int = 5           # trailing passes in the AUC baseline
    auc_min_history: int = 2      # baseline passes needed to judge
    auc_drop: float = 0.05        # baseline - auc beyond this trips
    nonfinite_rows: int = 0       # clamped rows a pass; 0 = detector off

    def __post_init__(self):
        for kind in KINDS:
            action = getattr(self, f"on_{kind}")
            if action not in ACTIONS:
                raise ValueError(
                    f"guard policy on_{kind}: unknown action {action!r} "
                    f"(choose from {ACTIONS})")
        if self.lag < 0 or self.quarantine_window < 1:
            raise ValueError("guard policy needs lag >= 0 and "
                             "quarantine_window >= 1")
        if self.max_rollbacks < 0 or self.step_retries < 1:
            raise ValueError("guard policy needs max_rollbacks >= 0 and "
                             "step_retries >= 1")

    @classmethod
    def from_flags(cls) -> "GuardPolicy":
        return cls(
            on_nan=str(flag("guard_on_nan")),
            on_loss_spike=str(flag("guard_on_loss_spike")),
            on_auc_collapse=str(flag("guard_on_auc_collapse")),
            on_emb_blowup=str(flag("guard_on_emb_blowup")),
            max_rollbacks=int(flag("guard_max_rollbacks")),
            step_retries=int(flag("guard_step_retries")),
            lag=int(flag("guard_sentinel_lag")),
            quarantine_window=int(flag("guard_quarantine_window")),
            loss_z=float(flag("guard_loss_z")),
            loss_warmup=int(flag("guard_loss_warmup")),
            auc_window=int(flag("guard_auc_window")),
            auc_drop=float(flag("guard_auc_drop")),
            nonfinite_rows=int(flag("guard_nonfinite_rows")))

    def action_for(self, kind: str) -> str:
        """The resolved action: under ``check_nan_inf`` a NaN/Inf always
        aborts, whatever the policy says."""
        if kind == "nan" and flag("check_nan_inf"):
            return "abort"
        return getattr(self, f"on_{kind}")


class _EwmaSpike:
    """EWMA mean/variance loss-spike detector. A sample is judged before
    it updates the statistics, so a spike cannot absorb itself into the
    baseline; a non-finite sample is the NaN detector's and is skipped."""

    def __init__(self, alpha: float, z: float, warmup: int):
        self.alpha, self.z, self.warmup = alpha, z, max(1, warmup)
        self.mean = 0.0
        self.var = 0.0
        self.n = 0

    def observe(self, x: float) -> Optional[float]:
        """The z-score when it breaches the threshold, else None."""
        if not math.isfinite(x):
            return None
        breach: Optional[float] = None
        if self.n >= self.warmup:
            sd = math.sqrt(self.var)
            if sd > 0.0:
                score = (x - self.mean) / sd
                if score > self.z:
                    breach = score
        if breach is None:        # a spike must not drag the baseline up
            d = x - self.mean
            self.mean += self.alpha * d
            self.var = (1.0 - self.alpha) * (self.var
                                             + self.alpha * d * d)
            self.n += 1
        return breach


class TrainGuard:
    """Wires a ``CTRTrainer`` (``step``, ``params``, ``opt_state``,
    ``auc_state``, ``train_from_dataset``, ``reset_metrics``) to the
    sentinel, the detectors and the recovery executor.

    On the training thread the guard runs :meth:`_on_step_outputs` (an
    enqueue) and :meth:`check_trip` (an attribute read under a lock);
    everything that reads a device value runs on the poller thread.
    ``lags`` keeps the poll lag of the last entries read, in steps
    dispatched past each entry's last step when the poller took it."""

    def __init__(self, trainer, pass_manager=None, ps=None,
                 save_root: Optional[str] = None,
                 policy: Optional[GuardPolicy] = None):
        self.trainer = trainer
        self.pass_manager = pass_manager
        self.ps = ps if ps is not None else getattr(pass_manager, "ps",
                                                    None)
        self.save_root = (save_root if save_root is not None
                          else getattr(pass_manager, "save_root", None))
        self.policy = policy or GuardPolicy.from_flags()
        self._attached = False
        # sentinel entries: (epoch, ordinal_start, k, bad, loss)
        self._pending: Deque[Tuple[int, int, int, Any, Any]] = deque()
        self._cond = threading.Condition()
        self._poller: Optional[threading.Thread] = None
        self._stop = False
        self._flush_req = 0           # guarded-by: _cond
        self._flush_done = 0          # guarded-by: _cond
        self._examining = False       # guarded-by: _cond
        self._dispatched = 0          # ordinals handed to the sentinel
        self._woken = 0               # _dispatched at the last wake
        self._epoch = 0               # attempt epoch: stale polls dropped
        self._trip: Optional[TripInfo] = None
        self._spike = self._new_spike()
        self._auc_hist: Deque[float] = deque(
            maxlen=max(1, self.policy.auc_window))
        self._yield_log: Optional[List[int]] = None
        self._nonfinite_mark = 0.0
        self._has_sentinel = False    # set at attach(): the engine's
        self._host_steps = 0          # guarded batches this attempt
        self._executing = False       # True while run_pass drives
        self._sidecar_lock = threading.Lock()
        self._cuda_lock = contextlib.nullcontext()
        # the poller's pinned buffer and event (on the card)
        self._host: Optional[torch.Tensor] = None
        self._event = None
        self.lags: Deque[int] = deque(maxlen=4096)

    # -- lifecycle -----------------------------------------------------------

    def attach(self) -> "TrainGuard":
        """Install the sentinel hook on the trainer's step engine and
        register as the trainer's guard (idempotent)."""
        if self._attached:
            return self
        step = self.trainer.step
        self._has_sentinel = hasattr(step, "set_sentinel")
        if self._has_sentinel:
            step.set_sentinel(self._on_step_outputs)
            graphs = getattr(step, "run_graphs", None)
            if graphs is not None:
                self._cuda_lock = graphs.capture_lock
        self.trainer._guard = self
        self._attached = True
        # the emb_blowup detector judges this guard's own delta of the
        # process-wide clamp counter, re-armed at each pass
        self._nonfinite_mark = REGISTRY.counter(
            "ps.nonfinite_grad_rows").get()
        REGISTRY.gauge("guard.armed").set(1.0)
        return self

    def detach(self) -> None:
        if not self._attached:
            return
        step = self.trainer.step
        if hasattr(step, "set_sentinel"):
            step.set_sentinel(None)
        if getattr(self.trainer, "_guard", None) is self:
            self.trainer._guard = None
        self._attached = False
        with self._cond:
            self._stop = True
            self._cond.notify_all()
            poller, self._poller = self._poller, None
        if poller is not None:
            poller.join(timeout=5.0)
        # re-attachable: a later attach() spawns a fresh poller
        with self._cond:
            self._stop = False
            self._pending.clear()
        REGISTRY.gauge("guard.armed").set(0.0)

    def _new_spike(self) -> _EwmaSpike:
        return _EwmaSpike(self.policy.loss_ewma, self.policy.loss_z,
                          self.policy.loss_warmup)

    # -- the training thread's half (no device reads) -------------------------

    def _on_step_outputs(self, k: int, bad, loss) -> None:
        """The sentinel hook, after every dispatch: enqueue the flags and
        losses (device tensors) for the poller; no CUDA call, no wait. It
        never raises: trips surface at consistent points only, through
        :meth:`check_trip`."""
        with self._cond:
            self._pending.append((self._epoch, self._dispatched, k, bad,
                                  loss))
            self._dispatched += k
            if self._poller is None and not self._stop:
                self._poller = threading.Thread(
                    target=self._poll_loop, daemon=True,
                    name="guard-poller")
                self._poller.start()
            # wake the poller once ``lag`` steps have gone by since its
            # last wake: it then reads every ready entry in one go (each
            # wake takes the GIL from the training thread)
            if self._dispatched - self._woken >= self.policy.lag:
                self._woken = self._dispatched
                self._cond.notify_all()

    def check_trip(self, retrain_last: bool = False) -> None:
        """Surface the pending trip, if any. Call sites are consistent
        points only: the guarded per-batch step before it steps
        (``retrain_last=True``), the trainer's segment and pass ends
        (everything yielded has trained).

        An abort trip escalates to :class:`GuardAbort` (postmortem, hard
        stop), also without the executor (the ``check_nan_inf`` guard). A
        recoverable trip raises :class:`GuardTripped` only while
        ``run_pass`` drives; without it the trip is consumed as a record
        (counted and in the heartbeat at detection)."""
        with self._cond:
            trip = self._trip
            if trip is None:
                return
            executing = self._executing
            if trip.action == "abort" or not executing:
                self._trip = None
        if trip.action == "abort":
            self._quarantine(trip)
            self._escalate(trip, f"{trip.kind} trip under abort policy: "
                                 f"{trip.detail}")
        if not executing:
            heartbeat.emit("guard", event="unhandled_trip",
                           **trip.to_dict())
            return
        raise GuardTripped(trip, retrain_last=retrain_last)

    def finalize_pass(self) -> None:
        """The pass end: read every pending sentinel entry (the last
        ``lag`` dispatches would otherwise go unexamined), re-arm the
        clamp mark and surface any trip."""
        self.flush()
        if not self._has_sentinel:
            # an engine without a sentinel has no poller to run the clamp
            # detector: judge the pass's delta here
            self._check_nonfinite_counter(self._epoch,
                                          max(0, self._host_steps - 1))
        self._nonfinite_mark = REGISTRY.counter(
            "ps.nonfinite_grad_rows").get()
        self.check_trip()

    # -- the poller's half (the only device reads) ---------------------------

    def _poll_loop(self) -> None:
        while True:
            with self._cond:
                self._examining = False
                self._cond.notify_all()
                while True:
                    if self._stop:
                        return
                    flushing = self._flush_done < self._flush_req
                    if self._pending and (flushing or self._ready_locked()):
                        # every ready entry at once: one copy, one wait
                        batch = []
                        while self._pending and (flushing or
                                                 self._ready_locked()):
                            entry = self._pending.popleft()
                            self.lags.append(self._dispatched
                                             - (entry[1] + entry[2]))
                            batch.append(entry)
                        entry = None
                        self._examining = True
                        break
                    if flushing and not self._pending:
                        self._flush_done = self._flush_req
                        self._cond.notify_all()
                    self._cond.wait()
            try:
                self._examine(batch)
            except Exception:  # noqa: BLE001 - the poller must not die
                import logging
                logging.getLogger("paddlebox_tpu_torch.trainer").exception(
                    "guard sentinel poll failed")
            # the entries' tensors go back to the allocator under the lock
            with self._cuda_lock:
                batch = None

    def _ready_locked(self) -> bool:
        """The lag rule: an entry is read once ``lag`` more steps have
        been dispatched past it."""
        _e, o, k, _b, _l = self._pending[0]
        return self._dispatched - (o + k) >= self.policy.lag

    def _read(self, entries) -> List[Tuple[np.ndarray, np.ndarray]]:
        """The entries' flags and losses on the host, an array pair an
        entry. On the card, under the capture lock: one ``cat`` of them
        all, a non-blocking copy into the pinned buffer, an event behind it
        on the stream, a wait on the event."""
        if not entries[0][3].is_cuda:
            return [(np.atleast_1d(b.detach().cpu().numpy()),
                     np.atleast_1d(lo.detach().cpu().numpy()))
                    for _e, _o, _k, b, lo in entries]
        with self._cuda_lock:
            vals = torch.cat([t.reshape(-1) for e in entries
                              for t in (e[3], e[4])]).float()
            n = vals.numel()
            if self._host is None or self._host.numel() < n:
                self._host = torch.empty(max(n, 1024), dtype=torch.float32,
                                         pin_memory=True)
                self._event = torch.cuda.Event(blocking=True)
            self._host[:n].copy_(vals, non_blocking=True)
            self._event.record()
            self._event.synchronize()
            del vals
        flat = self._host[:n].numpy().copy()
        out, at = [], 0
        for _e, _o, k, _b, _l in entries:
            out.append((flat[at:at + k] != 0, flat[at + k:at + 2 * k]))
            at += 2 * k
        return out

    def _examine(self, entries) -> None:
        """Read a batch of entries (the poller thread) and run the
        detectors over each in order; entries of an earlier attempt are
        dropped unread."""
        live = [e for e in entries if e[0] == self._epoch]
        if not live:
            return
        for (epoch, ordinal, k, _b, _l), (bad_np, loss_np) in zip(
                live, self._read(live)):
            self._judge(epoch, ordinal, k, bad_np, loss_np)

    def _judge(self, epoch: int, ordinal: int, k: int, bad_np: np.ndarray,
               loss_np: np.ndarray) -> None:
        """The detectors over one entry's flags and losses."""
        if bad_np.any():
            i = int(np.argmax(bad_np))
            self._detect(epoch, "nan", ordinal + i,
                         float(loss_np[min(i, loss_np.size - 1)]),
                         f"sentinel bad_flag at step offset {i} of a "
                         f"{k}-step dispatch")
            return
        for i, x in enumerate(loss_np):
            z = self._spike.observe(float(x))
            if z is not None:
                self._detect(epoch, "loss_spike", ordinal + i, float(z),
                             f"loss {float(x):.4g} z-score {z:.1f} over "
                             f"EWMA baseline {self._spike.mean:.4g}")
                return
        self._check_nonfinite_counter(epoch, ordinal + k - 1)

    def _check_nonfinite_counter(self, epoch: int, ordinal: int) -> None:
        if self.policy.nonfinite_rows <= 0:
            return
        cur = REGISTRY.counter("ps.nonfinite_grad_rows").get()
        if cur - self._nonfinite_mark > self.policy.nonfinite_rows:
            self._detect(epoch, "emb_blowup", ordinal,
                         cur - self._nonfinite_mark,
                         f"{cur - self._nonfinite_mark:.0f} non-finite "
                         f"gradient rows clamped by the PS this pass "
                         f"(> {self.policy.nonfinite_rows})")

    def _detect(self, epoch: int, kind: str, ordinal: int, value: float,
                detail: str) -> None:
        with self._cond:              # an attempt may have been retired
            if epoch != self._epoch:  # while this entry was examined
                return
            if self._trip is not None:
                return                # the first trip wins until handled
        action = self.policy.action_for(kind)
        src = self._source_index(ordinal)
        hi = src + (self.policy.quarantine_window if kind != "auc_collapse"
                    else 0)
        trip = TripInfo(kind=kind, action=action, step=src,
                        window=(src, hi), value=value, detail=detail)
        REGISTRY.add("guard.trips")
        REGISTRY.add(f"guard.trips_{kind}")
        REGISTRY.gauge("guard.last_trip_step").set(float(src))
        heartbeat.emit("guard", event="trip", **trip.to_dict())
        if action != "off":
            with self._cond:
                if epoch == self._epoch and self._trip is None:
                    self._trip = trip

    def _source_index(self, ordinal: int) -> int:
        with self._cond:
            log = self._yield_log
        if log is not None and ordinal < len(log):
            return log[ordinal]
        return ordinal

    # -- pass plumbing -------------------------------------------------------

    def _arm_pass(self, yield_log: Optional[List[int]]) -> None:
        """Reset the attempt's state: ordinals, pending entries, the
        pending trip; the spike baseline carries over a skip and is reset
        after a rollback (:meth:`_reset_detectors`)."""
        with self._cond:
            self._pending.clear()
            self._dispatched = 0
            self._woken = 0
            self._host_steps = 0
            self._trip = None
            self._epoch += 1          # retire in-flight stale examines
            self._yield_log = yield_log
        self._nonfinite_mark = REGISTRY.counter(
            "ps.nonfinite_grad_rows").get()

    def _reset_detectors(self) -> None:
        self._spike = self._new_spike()

    def flush(self) -> None:
        """Read every pending sentinel entry (the pass end). Off the hot
        path."""
        with self._cond:
            if self._poller is None:
                self._pending.clear()
                return
            self._flush_req += 1
            target = self._flush_req
            self._cond.notify_all()
            # drained and the entry in hand examined: a trip the last
            # entry found is visible when flush returns
            while (self._flush_done < target or self._examining) \
                    and not self._stop:
                self._cond.wait(timeout=0.05)

    def take_trip(self) -> Optional[TripInfo]:
        with self._cond:
            trip, self._trip = self._trip, None
            return trip

    # -- the guarded per-batch step ------------------------------------------

    #: the errors a step retries: ``OSError`` only (module docstring)
    _TRANSIENT: Tuple[type, ...] = (OSError,)

    def guarded_train_one(self, trainer, batch):
        """One batch through ``trainer._train_one``, a transient error
        retried (``utils/faults.with_retries``) at the ``trainer.step``
        io_point, where a drill's seeded injector fails it. A retry runs
        the whole batch again: exact for an error raised before the step
        changed state (the injection point), best effort after."""
        self.check_trip(retrain_last=True)   # the batch has not trained

        def call():
            faults.io_point("trainer.step")
            return trainer._train_one(batch)

        def on_retry(attempt, exc):
            REGISTRY.add("guard.retries")
            heartbeat.emit("guard", event="retry", attempt=attempt,
                           error=repr(exc))

        out = faults.with_retries(call,
                                  attempts=self.policy.step_retries,
                                  retry_on=self._TRANSIENT,
                                  on_retry=on_retry)
        if not self._has_sentinel:
            # the host-table engine pushes (and clamps) synchronously and
            # has no poller: judge the clamp counter a step (a registry
            # read, no device sync)
            self._host_steps += 1
            self._check_nonfinite_counter(self._epoch,
                                          self._host_steps - 1)
        return out

    # -- the recovery executor -----------------------------------------------

    def run_pass(self, data, fetch_handler=None) -> Dict[str, float]:
        """One guarded training pass over ``data`` (anything with
        deterministic ``.batches()``: a ``SlotDataset``, a list view),
        executing the policy on every trip; returns the pass metrics of
        the attempt that survived. Raises :class:`GuardAbort` on an abort
        trip or once rollbacks exceed ``max_rollbacks`` (after the
        postmortem bundle, when armed)."""
        if not self._attached:
            self.attach()
        self._executing = True
        try:
            return self._run_pass_loop(data, fetch_handler, set(), 0, 0,
                                       time.perf_counter())
        finally:
            self._executing = False

    def _run_pass_loop(self, data, fetch_handler, skip: Set[int],
                       resume_at: int, rollbacks: int,
                       t0: float) -> Dict[str, float]:
        while True:
            view = _GuardedBatches(data, skip, resume_at)
            self._arm_pass(view.yield_log)
            trip: Optional[TripInfo] = None
            retrain_last = False
            out: Optional[Dict[str, float]] = None
            try:
                out = self.trainer.train_from_dataset(
                    view, fetch_handler=fetch_handler)
                self.flush()
                trip = self.take_trip()
                if trip is None:
                    trip = self._auc_check(out)
            except GuardTripped as t:
                trip = t.trip
                retrain_last = t.retrain_last
            if trip is None:
                auc = (out or {}).get("auc")
                if auc is not None and math.isfinite(float(auc)):
                    self._auc_hist.append(float(auc))
                heartbeat.emit(
                    "guard", event="pass", rollbacks=rollbacks,
                    skipped=len(skip), wall_s=round(
                        time.perf_counter() - t0, 3))
                return out if out is not None else {}
            # a detector fired: execute the policy
            self._quarantine(trip)
            if trip.action == "abort":
                self._escalate(trip, f"{trip.kind} trip under abort "
                                     f"policy: {trip.detail}")
            if trip.action == "skip":
                if out is not None:
                    # the lagged poll surfaced the trip after the pass had
                    # trained every batch: the window goes to the sidecar
                    # and the pass stands
                    heartbeat.emit("guard", event="quarantine_only",
                                   **trip.to_dict())
                    return out
                skip.update(range(*trip.window))
                REGISTRY.add("guard.skipped_steps",
                             trip.window[1] - trip.window[0])
                heartbeat.emit("guard", event="skip", **trip.to_dict())
                # go on from the interruption: the per-batch check raises
                # before the last yielded batch trained (train it), the
                # boundary checks after it did (training it again would
                # step it twice)
                resume_at = max(resume_at,
                                view.last_yielded + (0 if retrain_last
                                                     else 1))
                continue
            # rollback (auc_collapse replays the whole pass, its window
            # empty: bad data trips again and escalates through
            # max_rollbacks)
            rollbacks += 1
            if rollbacks > self.policy.max_rollbacks:
                self._escalate(trip, f"{rollbacks - 1} rollbacks "
                                     f"exhausted guard_max_rollbacks="
                                     f"{self.policy.max_rollbacks}")
            skip.update(range(*trip.window))
            self._rollback(trip)
            resume_at = 0
            self._reset_detectors()

    def _auc_check(self, out: Optional[Dict[str, float]]
                   ) -> Optional[TripInfo]:
        """The AUC-collapse detector: the pass AUC against the mean of the
        last clean passes."""
        auc = (out or {}).get("auc")
        if auc is None or not self._auc_hist \
                or len(self._auc_hist) < self.policy.auc_min_history:
            return None
        baseline = sum(self._auc_hist) / len(self._auc_hist)
        if baseline - float(auc) <= self.policy.auc_drop:
            return None
        action = self.policy.action_for("auc_collapse")
        trip = TripInfo(
            kind="auc_collapse", action=action, step=0, window=(0, 0),
            value=float(auc),
            detail=f"pass auc {float(auc):.4f} vs trailing baseline "
                   f"{baseline:.4f} (drop > {self.policy.auc_drop})")
        REGISTRY.add("guard.trips")
        REGISTRY.add("guard.trips_auc_collapse")
        heartbeat.emit("guard", event="trip", **trip.to_dict())
        return trip if action != "off" else None

    def _quarantine(self, trip: TripInfo) -> None:
        """Record the window to the ingest quarantine sidecar
        (``ingest_quarantine_dir``), beside the quarantined bad lines."""
        lo, hi = trip.window
        REGISTRY.add("guard.quarantined_steps", max(0, hi - lo))
        qdir = flag("ingest_quarantine_dir")
        if not qdir:
            return
        rec = dict(kind="guard_" + trip.kind, ts=round(time.time(), 3),
                   step=trip.step, window=[lo, hi], value=trip.value,
                   action=trip.action, detail=trip.detail)
        try:
            with self._sidecar_lock:
                os.makedirs(qdir, exist_ok=True)
                path = os.path.join(
                    qdir, f"quarantine-guard-{os.getpid()}.jsonl")
                with open(path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
        except OSError:               # telemetry never blocks recovery
            pass

    def _rollback(self, trip: TripInfo) -> None:
        """Restore the tables and the dense state from the last committed
        checkpoint, in place (module docstring), and reset the trainer's
        pass state."""
        if self.ps is None or not self.save_root:
            self._escalate(trip, "rollback requested but the guard has "
                                 "no ps/save_root to restore from")
        pm = self.pass_manager
        if pm is not None:
            pm.barrier()              # queued commits land first
        plan = ckpt_discovery.latest_committed(self.save_root)
        if plan is None:
            self._escalate(trip, f"no committed checkpoint under "
                                 f"{self.save_root} to roll back to")
        ckpt_discovery.apply_plan(self.ps, plan)
        tr = self.trainer
        if ckpt_discovery.load_dense(plan, (tr.params,
                                            tr.opt_state)) is None:
            # a table-only base cannot restore the model: the rewound
            # tables under the live dense params repair nothing
            self._escalate(trip, f"committed base {plan[0]['path']} has "
                                 f"no dense snapshot "
                                 f"(save_base(dense_state=...)): refusing "
                                 f"a table-only half-restore")
        reset_auc_state_(tr.auc_state)
        tr.reset_metrics()
        day, pass_id = ckpt_discovery.plan_version(plan)
        REGISTRY.add("guard.rollbacks")
        heartbeat.emit("guard", event="rollback", detector=trip.kind,
                       step=trip.step, window=list(trip.window),
                       restored_day=day, restored_pass=pass_id)

    def _escalate(self, trip: TripInfo, why: str) -> None:
        REGISTRY.add("guard.escalations")
        heartbeat.emit("guard", event="escalate", why=why,
                       **trip.to_dict())
        err = GuardAbort(f"train guard hard stop: {why}", trip)
        postmortem.maybe_dump("trainer.guard", exc=err)
        raise err


class _GuardedBatches:
    """Replay view over a deterministic batch source: ``data.batches()``
    without the quarantined and already-trained source indices, logging
    each yield's source index so the poller maps dispatch ordinals back
    to batches."""

    def __init__(self, data, skip: Set[int], resume_at: int):
        self._data = data
        self._skip = skip
        self._resume_at = resume_at
        self.yield_log: List[int] = []
        self.last_yielded = resume_at

    def batches(self):
        for i, b in enumerate(self._data.batches()):
            if i < self._resume_at or i in self._skip:
                continue
            self.yield_log.append(i)
            self.last_yielded = i
            yield b


def maybe_auto_guard(trainer) -> Optional[TrainGuard]:
    """``check_nan_inf`` at trainer construction: a fused trainer gets a
    sentinel-backed guard whose NaN action is ``abort``. Returns the guard,
    or None when the flag is off or the engine has no sentinel."""
    if not flag("check_nan_inf"):
        return None
    if not hasattr(trainer.step, "set_sentinel"):
        return None                   # the host table's push scans instead
    return TrainGuard(trainer).attach()
