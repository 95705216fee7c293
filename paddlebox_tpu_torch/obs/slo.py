"""Declarative SLO and alert engine (counterpart of
``paddlebox_tpu/obs/slo.py``, the same rules, lifecycle and sinks).

A :class:`Rule` declares an objective over one registry metric::

    Rule("serve_p99_ms", metric="serve.request_ms", agg="p99",
         op=">", threshold=250.0, for_seconds=2.0,
         labels={"action": "shed"})

and :class:`SloEngine` evaluates every rule on windowed views of the
registry: per tick, only the metrics the rules name. Aggregations:

- ``value``: the metric's scalar now (gauges, counters);
- ``p50`` / ``p95`` / ``p99`` / ``max``: a quantile of the observations
  made during the window (histograms), so an alert resolves when the
  breach stops;
- ``rate``: change per second over the window (counters, or a
  histogram's count).

An alert goes ``pending -> firing -> resolved``: a breaching rule is
pending, fires once the breach has held ``for_seconds``, resolves when it
clears, and may fire again. A metric never written keeps its rule pending:
no data is no breach. Each transition sets the ``alert.firing.<rule>``
gauge, counts ``obs.slo.fired``/``resolved``, emits a heartbeat ``alert``
record and calls the registered callbacks (a raising one is counted in
``obs.slo.callback_errors`` and the rest still run): ``PredictServer`` and
``AdmissionController`` shed load while an ``action=shed`` alert fires.

With zero rules the engine is a no-op: ``start()`` spawns no thread and
``evaluate()`` reads nothing. The background interval is the
``obs_slo_interval`` flag (``PBOX_FLAGS_obs_slo_interval``). Tests tick
``evaluate(now=...)`` by hand.

Imports neither torch nor numpy.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
import weakref
from typing import Callable, Dict, List, Mapping, Optional, Sequence

from paddlebox_tpu_torch.config import flag
from paddlebox_tpu_torch.obs import heartbeat
from paddlebox_tpu_torch.obs.metrics import (REGISTRY, Histogram,
                                             MetricsRegistry,
                                             percentile_from_counts)

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
}

_QUANTILES = {"p50": 0.5, "p95": 0.95, "p99": 0.99, "max": 1.0}

#: Alert lifecycle states.
PENDING, FIRING, RESOLVED = "pending", "firing", "resolved"


@dataclasses.dataclass(frozen=True)
class Rule:
    """One declarative objective over one registry metric."""

    name: str
    metric: str                      # registry name, e.g. "serve.request_ms"
    op: str                          # ">", ">=", "<", "<="
    threshold: float
    agg: str = "value"               # value | p50 | p95 | p99 | max | rate
    for_seconds: float = 0.0         # the breach must hold this long to fire
    severity: str = "page"
    labels: Mapping[str, str] = dataclasses.field(default_factory=dict)
    min_count: int = 1               # window observations a quantile needs

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"rule {self.name!r}: unknown op {self.op!r}")
        if self.agg != "value" and self.agg != "rate" \
                and self.agg not in _QUANTILES:
            raise ValueError(
                f"rule {self.name!r}: unknown agg {self.agg!r}")


class Alert:
    """A rule's evaluation state, and the record handed to the sinks."""

    __slots__ = ("rule", "state", "value", "breach_since", "fired_at",
                 "resolved_at")

    def __init__(self, rule: Rule):
        self.rule = rule
        self.state = PENDING
        self.value: Optional[float] = None     # last evaluated value
        self.breach_since: Optional[float] = None
        self.fired_at: Optional[float] = None
        self.resolved_at: Optional[float] = None

    def to_dict(self) -> Dict:
        return {
            "rule": self.rule.name, "metric": self.rule.metric,
            "agg": self.rule.agg, "op": self.rule.op,
            "threshold": self.rule.threshold, "state": self.state,
            "value": self.value, "severity": self.rule.severity,
            "labels": dict(self.rule.labels),
            "fired_at": self.fired_at, "resolved_at": self.resolved_at,
        }


#: callback contract: (alert, old_state, new_state) on every transition
AlertCallback = Callable[[Alert, str, str], None]

# every live engine, for the postmortem bundle's alerts.json; weak, so an
# abandoned engine is not pinned
_ENGINES: "weakref.WeakSet[SloEngine]" = weakref.WeakSet()


class SloEngine:
    """Evaluate rules on a background thread (or by explicit
    ``evaluate()`` ticks) and drive the alert lifecycle and its sinks."""

    def __init__(self, registry: MetricsRegistry = REGISTRY,
                 interval: Optional[float] = None):
        self.registry = registry
        self._interval = interval
        self._rules: Dict[str, Alert] = {}     # guarded-by: _lock
        self._callbacks: List[AlertCallback] = []
        self._lock = threading.Lock()
        # each evaluator thread owns the stop event it watches, so a stop
        # racing a restart ends only its own thread
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None
        self._started = False                  # guarded-by: _lock
        # the window state: the previous tick's cumulative histogram
        # counts and scalar samples
        self._prev_hist: Dict[str, tuple] = {}      # guarded-by: _lock
        self._prev_scalar: Dict[str, float] = {}    # guarded-by: _lock
        self._prev_time: Optional[float] = None     # guarded-by: _lock
        _ENGINES.add(self)

    # -- configuration -------------------------------------------------------

    def add_rule(self, rule: Rule) -> None:
        with self._lock:
            if rule.name in self._rules:
                raise ValueError(f"duplicate rule {rule.name!r}")
            self._rules[rule.name] = Alert(rule)
            # the first rule of a started engine starts its evaluator,
            # under the lock so that two adds cannot start two
            if self._started and self._thread is None:
                self._spawn_locked()

    def add_rules(self, rules: Sequence[Rule]) -> None:
        for r in rules:
            self.add_rule(r)

    def add_callback(self, fn: AlertCallback) -> None:
        with self._lock:
            self._callbacks.append(fn)

    def remove_callback(self, fn: AlertCallback) -> None:
        """Detach a hook (no-op when absent): a consumer that lives
        shorter than the engine must, or the bound method pins it."""
        with self._lock:
            try:
                self._callbacks.remove(fn)
            except ValueError:
                pass

    # -- lifecycle -----------------------------------------------------------

    def _spawn_locked(self) -> None:
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        args=(self._stop,), daemon=True,
                                        name="slo-eval")
        self._thread.start()

    def start(self) -> None:
        """Begin background evaluation; with zero rules no thread starts
        until the first rule arrives."""
        with self._lock:
            if self._started:
                return
            self._started = True
            if self._rules and self._thread is None:
                self._spawn_locked()

    def stop(self, join_timeout: float = 5.0) -> None:
        with self._lock:
            self._started = False
            th, self._thread = self._thread, None
            stop_evt, self._stop = self._stop, None
        # outside the lock: the evaluator takes it inside evaluate()
        if stop_evt is not None:
            stop_evt.set()
        if th is not None:
            th.join(timeout=join_timeout)

    def _run(self, stop_evt: threading.Event) -> None:
        interval = self._interval
        if interval is None:
            interval = float(flag("obs_slo_interval"))
        while not stop_evt.wait(interval):
            try:
                self.evaluate()
            except Exception:        # a bad tick never ends the evaluator
                logging.getLogger("paddlebox_tpu_torch.obs").exception(
                    "SLO evaluation tick failed")

    # -- evaluation ----------------------------------------------------------

    def _hist_windows(self, names: List[str], metrics: Dict
                      ) -> Dict[str, tuple]:
        """Each named histogram's bucket counts since the previous tick
        (diffed once a metric: a name named twice must not diff against
        itself into an empty window)."""
        out: Dict[str, tuple] = {}
        with self._lock:
            for name in set(names):
                m = metrics.get(name)
                if not isinstance(m, Histogram):
                    continue         # never written (or not a histogram)
                counts, _total, n, vmax = m.state()
                prev = self._prev_hist.get(name)
                self._prev_hist[name] = (counts, n)
                if prev is None:
                    continue         # first sighting: no window yet
                pcounts, pn = prev
                wcounts = [c - p for c, p in zip(counts, pcounts)]
                out[name] = (wcounts, n - pn, vmax)
        return out

    def evaluate(self, now: Optional[float] = None) -> None:
        """One evaluation tick; ``now`` (monotonic seconds) is injectable
        so tests walk the hysteresis deterministically."""
        with self._lock:
            if not self._rules:
                return               # the zero-rule no-op
            alerts = list(self._rules.values())
            callbacks = list(self._callbacks)
        if now is None:
            now = time.monotonic()
        metrics = dict(self.registry.items())
        with self._lock:
            prev_time, self._prev_time = self._prev_time, now
        dt = (now - prev_time) if prev_time is not None else None
        windows = self._hist_windows(
            [a.rule.metric for a in alerts if a.rule.agg in _QUANTILES],
            metrics)
        rates = self._scalar_rates(
            {a.rule.metric for a in alerts if a.rule.agg == "rate"},
            metrics, dt)
        transitions: List[tuple] = []
        for a in alerts:
            value = self._value_for(a.rule, metrics, windows, rates)
            self._step_alert(a, value, now, transitions)
        for a, old, new in transitions:
            self._sink(a, old, new, callbacks)

    def _scalar_rates(self, names, metrics: Dict,
                      dt: Optional[float]) -> Dict[str, float]:
        """Change per second since the previous tick of each named
        scalar (a histogram's observation count)."""
        out: Dict[str, float] = {}
        with self._lock:
            for name in names:
                m = metrics.get(name)
                if m is None:
                    # a counter is born at 0: one that appears later grew
                    # inside the window
                    self._prev_scalar.setdefault(name, 0.0)
                    continue
                cur = (float(m.state()[2]) if isinstance(m, Histogram)
                       else float(m.get()))
                prev = self._prev_scalar.get(name)
                self._prev_scalar[name] = cur
                if prev is not None and dt:
                    out[name] = (cur - prev) / dt
        return out

    def _value_for(self, rule: Rule, metrics: Dict,
                   windows: Dict[str, tuple],
                   rates: Dict[str, float]) -> Optional[float]:
        if rule.agg == "value":
            m = metrics.get(rule.metric)
            if m is None or isinstance(m, Histogram):
                return None          # no data, or not a scalar
            return float(m.get())
        if rule.agg == "rate":
            return rates.get(rule.metric)
        win = windows.get(rule.metric)
        if win is None:
            return None
        wcounts, wn, vmax = win
        if wn < rule.min_count:
            return None              # too little data to judge
        return percentile_from_counts(wcounts, wn, vmax,
                                      _QUANTILES[rule.agg])

    def _step_alert(self, a: Alert, value: Optional[float], now: float,
                    transitions: List[tuple]) -> None:
        a.value = value
        breaching = (value is not None
                     and _OPS[a.rule.op](value, a.rule.threshold))
        if breaching:
            if a.breach_since is None:
                a.breach_since = now
                if a.state == RESOLVED:
                    a.state = PENDING    # resolved is not terminal
            if a.state != FIRING and \
                    now - a.breach_since >= a.rule.for_seconds:
                old, a.state = a.state, FIRING
                a.fired_at = now
                transitions.append((a, old, FIRING))
        else:
            a.breach_since = None
            if a.state == FIRING:
                a.state = RESOLVED
                a.resolved_at = now
                transitions.append((a, FIRING, RESOLVED))

    def _sink(self, a: Alert, old: str, new: str,
              callbacks: List[AlertCallback]) -> None:
        # into the registry the rules read: an engine on a private
        # registry shows its alerts on that registry's page
        reg = self.registry
        reg.gauge(f"alert.firing.{a.rule.name}").set(
            1.0 if new == FIRING else 0.0)
        reg.add(f"obs.slo.{'fired' if new == FIRING else 'resolved'}")
        heartbeat.emit("alert", **a.to_dict())
        for fn in callbacks:
            try:
                fn(a, old, new)
            except Exception:
                reg.add("obs.slo.callback_errors")

    # -- introspection -------------------------------------------------------

    def alerts(self) -> List[Dict]:
        with self._lock:
            return [a.to_dict() for a in self._rules.values()]

    def firing(self) -> List[Dict]:
        with self._lock:
            return [a.to_dict() for a in self._rules.values()
                    if a.state == FIRING]

    def summary(self) -> Dict:
        """Rule count and the firing alerts."""
        alerts = self.alerts()
        firing = [a for a in alerts if a["state"] == FIRING]
        return {"rules": len(alerts), "firing_count": len(firing),
                "firing": firing}


def default_rules(serve_p99_ms: float = 250.0,
                  host_share: float = 0.5,
                  channel_timeout_rate: float = 0.5,
                  ckpt_lag_jobs: float = 3.0,
                  ckpt_queue_depth: float = 2.0,
                  guard_rollback_rate: float = 1.0 / 30.0,
                  for_seconds: float = 5.0) -> List[Rule]:
    """The reference's shipped rule set, thresholds as parameters."""
    return [
        Rule("serve_p99_ms", metric="serve.request_ms", agg="p99",
             op=">", threshold=serve_p99_ms, for_seconds=for_seconds,
             labels={"action": "shed", "subsystem": "serve"}),
        Rule("trainer_host_share", metric="trainer.host_share",
             agg="value", op=">", threshold=host_share,
             for_seconds=for_seconds,
             severity="warn", labels={"subsystem": "trainer"}),
        Rule("ingest_channel_timeout_rate",
             metric="ingest.channel_timeouts", agg="rate", op=">",
             threshold=channel_timeout_rate, for_seconds=for_seconds,
             labels={"subsystem": "ingest"}),
        Rule("ckpt_commit_lag", metric="ckpt.lag_jobs", agg="value",
             op=">=", threshold=ckpt_lag_jobs, for_seconds=for_seconds,
             labels={"subsystem": "ckpt"}),
        Rule("ckpt_queue_depth", metric="ckpt.queue_depth", agg="value",
             op=">=", threshold=ckpt_queue_depth,
             for_seconds=for_seconds, severity="warn",
             labels={"subsystem": "ckpt"}),
        # repeated rollbacks: shed live traffic while the model churns
        Rule("guard_rollback_rate", metric="guard.rollbacks", agg="rate",
             op=">", threshold=guard_rollback_rate,
             for_seconds=for_seconds,
             labels={"action": "shed", "subsystem": "guard"}),
        # a quarantined replica does not heal by itself: page at once
        # (the supervisor's restart budget already debounced it)
        Rule("serving_replica_quarantined",
             metric="serving.quarantined_replicas", agg="value", op=">",
             threshold=0.0, labels={"subsystem": "serving"}),
        Rule("ps_shard_unavailable",
             metric="ps.remote.shard_unavailable", agg="value", op=">",
             threshold=0.0, labels={"subsystem": "ps"}),
        Rule("serving_host_down",
             metric="serving.hosts_down", agg="value", op=">",
             threshold=0.0, labels={"subsystem": "serving"}),
    ]


def all_alerts() -> List[Dict]:
    """Alert state across every live engine (the postmortem bundle's
    ``alerts.json``)."""
    out: List[Dict] = []
    for eng in list(_ENGINES):
        out.extend(eng.alerts())
    return out


#: Process-global engine, inert until rules arrive.
ENGINE = SloEngine()
