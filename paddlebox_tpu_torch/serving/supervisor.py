"""Restart supervision for the replica fleet: budget, backoff, circuit
breaker and quarantine (counterpart of
``paddlebox_tpu/serving/supervisor.py``, the same states for the same
deaths and clock).

:class:`RestartSupervisor` sits between the fleet monitor and a restart,
so a replica whose bundle kills it on every start does not hot-loop:

- budget: deaths and failed restarts are events in a sliding
  ``serve_restart_window``; more than ``serve_restart_budget`` opens the
  circuit: the slot is quarantined (no more restarts),
  ``serving.replica.<name>.quarantined`` is 1, the fleet-wide
  ``serving.quarantined_replicas`` gauge feeds the shipped quarantine rule
  (``obs/slo.py``), and one postmortem bundle records the events;
- backoff: in the budget, the first two recoveries are immediate, then the
  supervisor waits ``serve_restart_backoff * 2^k`` (capped) between
  attempts;
- half-open: with ``serve_circuit_reset > 0`` an open circuit allows one
  probe restart after that many seconds (its success closes the circuit,
  another death opens it again); the default 0 holds the quarantine until
  :meth:`reset`.

The flags are read from their ``PBOX_FLAGS_*`` variables at construction.
The clock is injectable; the monitor thread (or a test driving
``_probe_once``) makes every mutating call, and a lock guards the slots
for the health readers.

Imports neither torch nor numpy.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from paddlebox_tpu_torch.config import flag
from paddlebox_tpu_torch.obs import postmortem
from paddlebox_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry

#: Cap on one backoff delay: past it the budget and circuit contain a
#: crash loop, not longer sleeps.
BACKOFF_CAP_S = 30.0

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class _Slot:
    __slots__ = ("events", "state", "opened_at", "last_event")

    def __init__(self):
        self.events: List[float] = []   # death / restart-failure times
        self.state = CLOSED
        self.opened_at: Optional[float] = None
        self.last_event: Optional[float] = None


class RestartSupervisor:
    """Per-replica restart budget, exponential backoff and circuit
    breaker; one per :class:`~serving.fleet.ReplicaSet`."""

    def __init__(self, budget: Optional[int] = None,
                 window: Optional[float] = None,
                 backoff_base: Optional[float] = None,
                 circuit_reset: Optional[float] = None,
                 registry: MetricsRegistry = REGISTRY,
                 clock: Callable[[], float] = time.monotonic):
        self.budget = (int(flag("serve_restart_budget"))
                       if budget is None else int(budget))
        self.window = (float(flag("serve_restart_window"))
                       if window is None else float(window))
        self.backoff_base = (float(flag("serve_restart_backoff"))
                             if backoff_base is None
                             else float(backoff_base))
        self.circuit_reset = (float(flag("serve_circuit_reset"))
                              if circuit_reset is None
                              else float(circuit_reset))
        if self.budget < 1:
            raise ValueError(f"restart budget must be >= 1, "
                             f"got {self.budget}")
        self.registry = registry
        self.clock = clock
        self._slots: Dict[str, _Slot] = {}
        self._lock = threading.Lock()

    # -- events --------------------------------------------------------------

    def _slot(self, name: str) -> _Slot:
        s = self._slots.get(name)
        if s is None:
            s = self._slots[name] = _Slot()
        return s

    def _prune(self, s: _Slot, now: float) -> None:
        cutoff = now - self.window
        s.events = [t for t in s.events if t >= cutoff]

    def _record_event(self, name: str, kind: str) -> bool:
        """One death or restart failure; True when it opened the
        circuit."""
        now = self.clock()
        dump_extra = None
        with self._lock:
            s = self._slot(name)
            self._prune(s, now)
            s.events.append(now)
            s.last_event = now
            if s.state == HALF_OPEN:
                # the probe restart died too
                dump_extra = self._open(name, s, now, kind)
            elif s.state == CLOSED and len(s.events) > self.budget:
                dump_extra = self._open(name, s, now, kind)
        if dump_extra is None:
            return False
        # one bundle a circuit opening, written with the lock released so
        # a slow disk stalls no health reader
        postmortem.maybe_dump(
            f"serving.replica {name} quarantined (crash loop)",
            extra=dump_extra)
        return True

    def record_death(self, name: str) -> bool:
        """A running replica died (worker escape, child SIGKILL or
        exit)."""
        self.registry.add("serving.replica_deaths")
        return self._record_event(name, "death")

    def record_restart_failure(self, name: str) -> bool:
        """A restart attempt failed (factory raise, spawn error,
        handshake timeout): a bad bundle's crash loop."""
        return self._record_event(name, "restart_failure")

    def note_healthy(self, name: str) -> None:
        """The probe saw the replica alive: a half-open circuit closes,
        and a quiet window clears the history (backoff re-arms)."""
        now = self.clock()
        with self._lock:
            s = self._slots.get(name)
            if s is None:
                return
            if s.state == HALF_OPEN:
                self._close(name, s)
            if s.state == CLOSED and s.events \
                    and now - s.events[-1] >= self.window:
                s.events = []

    # -- the monitor's gate --------------------------------------------------

    def allow_restart(self, name: str) -> bool:
        """May the monitor restart ``name`` now?"""
        now = self.clock()
        with self._lock:
            s = self._slot(name)
            if s.state == OPEN:
                if self.circuit_reset > 0 and s.opened_at is not None \
                        and now - s.opened_at >= self.circuit_reset:
                    s.state = HALF_OPEN
                    self.registry.add("serving.circuit_half_opens")
                    return True
                self.registry.add("serving.restart_denied")
                return False
            if s.state == HALF_OPEN:
                # one probe restart is out already
                self.registry.add("serving.restart_denied")
                return False
            self._prune(s, now)
            n = len(s.events)
            if n <= 2:
                return True          # the first two recoveries: at once
            delay = min(BACKOFF_CAP_S,
                        self.backoff_base * (2.0 ** (n - 3)))
            if s.last_event is not None and now - s.last_event < delay:
                self.registry.add("serving.restart_denied")
                return False
            return True

    # -- circuit transitions (under self._lock) ------------------------------

    def _open(self, name: str, s: _Slot, now: float, kind: str) -> Dict:
        """Open the circuit; returns the postmortem payload, dumped by the
        caller once the lock is released."""
        s.state = OPEN
        s.opened_at = now
        timeline = list(s.events)
        self.registry.gauge(f"serving.replica.{name}.quarantined").set(1.0)
        self.registry.add("serving.quarantines")
        self._publish_total_locked()
        return {"replica": name, "trigger": kind,
                "budget": self.budget, "window_s": self.window,
                "events_in_window": len(timeline),
                "event_ages_s": [round(now - t, 3) for t in timeline]}

    def _close(self, name: str, s: _Slot) -> None:
        s.state = CLOSED
        s.opened_at = None
        s.events = []
        self.registry.gauge(f"serving.replica.{name}.quarantined").set(0.0)
        self._publish_total_locked()

    def _publish_total_locked(self) -> None:
        # half-open still counts: the probe has healed nothing yet
        total = sum(1 for s in self._slots.values()
                    if s.state in (OPEN, HALF_OPEN))
        self.registry.gauge("serving.quarantined_replicas").set(total)

    # -- the operator's surface ----------------------------------------------

    def reset(self, name: str) -> None:
        """Close the circuit and clear the history (after the bad bundle
        was replaced); the next monitor tick may restart the slot."""
        with self._lock:
            s = self._slots.get(name)
            if s is None:
                return
            self._close(name, s)
            self.registry.add("serving.quarantine_resets")

    def quarantined(self, name: str) -> bool:
        """True while the slot is open or half-open (as the gauges say)."""
        with self._lock:
            s = self._slots.get(name)
            return s is not None and s.state in (OPEN, HALF_OPEN)

    def quarantined_names(self) -> List[str]:
        with self._lock:
            return sorted(n for n, s in self._slots.items()
                          if s.state in (OPEN, HALF_OPEN))

    def state(self, name: str) -> Dict:
        """The health document's fragment for one slot."""
        now = self.clock()
        with self._lock:
            s = self._slots.get(name)
            if s is None:
                return {"circuit": CLOSED, "events_in_window": 0}
            self._prune(s, now)
            return {
                "circuit": s.state,
                "events_in_window": len(s.events),
                "open_for_s": (round(now - s.opened_at, 3)
                               if s.opened_at is not None else None),
            }
