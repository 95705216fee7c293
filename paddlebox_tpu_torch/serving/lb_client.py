"""Client-side load balancer over a fleet of serving hosts (counterpart of
``paddlebox_tpu/serving/lb_client.py``, the same wire and contracts).

:class:`LBClient` spreads requests over the front doors an
:class:`~serving.resolver.EndpointResolver` names, speaking the
newline-JSON line protocol of ``PredictServer`` and ``FrontDoor``
(``{"lines": [...], "deadline_ms": ...}`` -> ``{"scores": [...]}``). The
replica tier's contracts, one rung up:

- least-outstanding pick: the reachable, non-ejected host with the fewest
  requests in flight (``serving.lb.picks``);
- failover within ``serve_retry_budget``: a connect failure or a torn
  reply goes to a different host, never the same host twice in one
  request; a death after the request was sent is retried only for a
  request the caller marks idempotent (``serving.failover_retries``);
- the caller's ``deadline_ms`` shrinks with the time spent at each hop and
  rides in the wire request;
- outlier ejection: a host's failures feed a
  :class:`~serving.supervisor.RestartSupervisor`; one that keeps failing
  opens its circuit (``serving.lb.ejections``), gets one half-open probe
  (``{"ping": true}``) after ``serve_lb_eject_reset`` seconds, and is
  readmitted when it answers healthy;
- a host absent from the resolver's newest set is dropped (its pooled
  connections closed) and never picked again; the others keep their pools
  and their circuit history.

Flags (``PBOX_FLAGS_*``, read at construction): ``serve_lb_probe_interval``,
``serve_retry_budget``, ``serve_lb_eject_reset``.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from paddlebox_tpu_torch.config import flag
from paddlebox_tpu_torch.obs import trace
from paddlebox_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from paddlebox_tpu_torch.serving.batcher import RequestExpired, ServingError
from paddlebox_tpu_torch.serving.fleet import RetryBudgetExhausted
from paddlebox_tpu_torch.serving.resolver import EndpointResolver
from paddlebox_tpu_torch.serving.supervisor import RestartSupervisor

#: pooled connections kept a host
POOL_SIZE = 4


class HostUnavailable(ServingError):
    """No reachable, non-ejected host could serve the request."""


def _parse_endpoint(ep: str) -> Tuple[str, int]:
    host, _, port = ep.rpartition(":")
    return host, int(port)


def _close(conn) -> None:
    try:
        conn[0].close()
    except OSError:
        pass


class _HostState:
    """One endpoint's outstanding count and pool of line-protocol
    connections ``(socket, file)``."""

    __slots__ = ("endpoint", "outstanding", "pool", "lock")

    def __init__(self, endpoint: str):
        self.endpoint = endpoint
        self.outstanding = 0         # guarded-by: LBClient._lock
        self.pool: List[Tuple[socket.socket, object]] = []  # guarded-by: lock
        self.lock = threading.Lock()

    def close(self) -> None:
        with self.lock:
            conns, self.pool = self.pool, []
        for conn in conns:
            _close(conn)


class LBClient:
    """``predict_lines`` load-balanced across the resolved front doors."""

    def __init__(self, resolver: EndpointResolver,
                 connect_timeout_s: float = 2.0,
                 probe_interval: Optional[float] = None,
                 retry_budget: Optional[int] = None,
                 supervisor: Optional[RestartSupervisor] = None,
                 registry: MetricsRegistry = REGISTRY,
                 clock=time.monotonic):
        self.resolver = resolver
        self.registry = registry
        self.clock = clock
        self.connect_timeout_s = float(connect_timeout_s)
        self.probe_interval = float(flag("serve_lb_probe_interval")
                                    if probe_interval is None
                                    else probe_interval)
        self.retry_budget = max(1, int(flag("serve_retry_budget")
                                       if retry_budget is None
                                       else retry_budget))
        # the replica supervisor's circuit is the ejection policy; only its
        # reset differs: an ejection heals on its own
        self.supervisor = supervisor or RestartSupervisor(
            circuit_reset=float(flag("serve_lb_eject_reset")),
            registry=registry, clock=clock)
        self._lock = threading.Lock()
        self._hosts: Dict[str, _HostState] = {}   # guarded-by: _lock
        self._stop = threading.Event()
        self._prober: Optional[threading.Thread] = None
        self._sync(*resolver.snapshot())
        resolver.subscribe(self._sync)

    # -- topology ------------------------------------------------------------

    def _sync(self, generation: int, endpoints: Tuple[str, ...]) -> None:
        """Adopt a resolver snapshot: new hosts join, removed ones are
        dropped and their pools closed."""
        with self._lock:
            for ep in endpoints:
                if ep not in self._hosts:
                    self._hosts[ep] = _HostState(ep)
            dropped = [self._hosts.pop(ep) for ep in list(self._hosts)
                       if ep not in endpoints]
            n = len(self._hosts)
        for st in dropped:
            st.close()
        self.registry.gauge("serving.lb.hosts").set(n)

    def hosts(self) -> List[str]:
        with self._lock:
            return sorted(self._hosts)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "LBClient":
        self.resolver.start()
        if self._prober is None:
            self._stop.clear()
            self._prober = threading.Thread(target=self._probe_loop,
                                            daemon=True, name="lb-probe")
            self._prober.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._prober = self._prober, None
        if t is not None:
            t.join(timeout=5.0)
        with self._lock:
            states = list(self._hosts.values())
        for st in states:
            st.close()

    def __enter__(self) -> "LBClient":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- connections ---------------------------------------------------------

    def _checkout(self, st: _HostState):
        """``(conn, fresh)``. A failure on a pooled connection (``fresh``
        False) is ambiguous, the host's idle guard may have closed it, so
        it does not count against the host."""
        with st.lock:
            if st.pool:
                return st.pool.pop(), False
        sock = socket.create_connection(_parse_endpoint(st.endpoint),
                                        timeout=self.connect_timeout_s)
        return (sock, sock.makefile("rwb")), True

    def _checkin(self, st: _HostState, conn) -> None:
        with st.lock:
            if len(st.pool) < POOL_SIZE:
                st.pool.append(conn)
                return
        _close(conn)

    # -- request path --------------------------------------------------------

    def _pick(self, exclude) -> Optional[_HostState]:
        ejected = set(self.supervisor.quarantined_names())
        with self._lock:
            candidates = [st for ep, st in self._hosts.items()
                          if ep not in exclude and ep not in ejected]
            if not candidates:
                return None
            st = min(candidates, key=lambda s: s.outstanding)
            st.outstanding += 1      # under the lock: racing picks see it
            return st

    def _release(self, st: _HostState) -> None:
        with self._lock:
            st.outstanding = max(0, st.outstanding - 1)

    def predict_lines(self, lines: Sequence[str],
                      deadline_ms: Optional[float] = None,
                      idempotent: bool = True) -> List[float]:
        """Score ``lines`` on some live host, failing over within the retry
        budget and the deadline. ``idempotent=False`` forbids a retry once
        the request was sent (the dead host may have run it)."""
        # a trace entry point: the caller's context, or a root one
        ctx = trace.current()
        if ctx is None and trace.enabled():
            ctx = trace.mint()
        with trace.activate(ctx), trace.span("lb.request", lines=len(lines)):
            return self._predict(lines, deadline_ms, idempotent)

    def _predict(self, lines, deadline_ms, idempotent) -> List[float]:
        t_deadline = (self.clock() + deadline_ms / 1e3
                      if deadline_ms is not None else None)
        tried: set = set()
        attempts = 0
        last_err: Optional[Exception] = None
        while True:
            remaining_ms = None
            if t_deadline is not None:
                remaining_ms = (t_deadline - self.clock()) * 1e3
                if remaining_ms <= 0:
                    raise RequestExpired(
                        f"deadline exhausted after {attempts} attempt(s)"
                        + (f": {last_err}" if last_err else ""))
            if attempts >= self.retry_budget:
                raise RetryBudgetExhausted(
                    f"retry budget ({self.retry_budget}) exhausted "
                    f"across hosts {sorted(tried)}: {last_err}")
            st = self._pick(tried)
            if st is None:
                raise HostUnavailable(
                    f"no live host (tried {sorted(tried)}, ejected "
                    f"{sorted(self.supervisor.quarantined_names())}): "
                    f"{last_err}")
            attempts += 1
            if attempts > 1:
                self.registry.add("serving.failover_retries")
            self.registry.add("serving.lb.picks")
            tried.add(st.endpoint)
            try:
                scores, last_err = self._attempt(st, lines, remaining_ms,
                                                 idempotent)
            finally:
                self._release(st)
            if scores is not None:
                return scores

    def _attempt(self, st: _HostState, lines, remaining_ms, idempotent):
        """One try on one host: ``(scores, None)``, or ``(None, error)``
        when the caller may fail over; raises when it may not."""
        sent = False
        try:
            conn, fresh = self._checkout(st)
        except OSError as e:
            self._host_event(st)
            return None, e
        try:
            req = {"lines": list(lines)}
            if remaining_ms is not None:
                req["deadline_ms"] = remaining_ms
            ctx = trace.current()
            if ctx is not None:
                # each attempt is a hop of its own on the wire
                req["trace"] = ctx.child().to_wire()
            sock, f = conn
            if remaining_ms is not None:
                # a stalled host must not hold the client past its deadline
                sock.settimeout(remaining_ms / 1e3 + 1.0)
            with trace.span("lb.hop", host=st.endpoint):
                f.write((json.dumps(req) + "\n").encode())
                f.flush()
                sent = True
                raw = f.readline()
                if not raw:
                    raise OSError("connection closed mid-request")
            reply = json.loads(raw)
        except (OSError, ValueError) as e:
            _close(conn)
            if fresh:
                self._host_event(st)
            if sent and not idempotent:
                raise HostUnavailable(
                    f"host {st.endpoint} died mid-request and the request "
                    "is not idempotent") from e
            return None, e
        self._checkin(st, conn)
        self.supervisor.note_healthy(st.endpoint)
        if "error" in reply:
            # a healthy host answered: the request failed, not the host
            raise RuntimeError(f"server error: {reply['error']}")
        return [float(s) for s in reply["scores"]], None

    def _host_event(self, st: _HostState) -> None:
        if self.supervisor.record_death(st.endpoint):
            self.registry.add("serving.lb.ejections")

    # -- health probing ------------------------------------------------------

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval):
            try:
                self.probe_once()
            except Exception:  # noqa: BLE001 - the prober outlives a host
                pass

    def probe_once(self) -> None:
        """Ping every known host; an ejected one only when its circuit
        grants the half-open attempt (one a reset window)."""
        with self._lock:
            states = list(self._hosts.values())
        for st in states:
            if self.supervisor.quarantined(st.endpoint) and \
                    not self.supervisor.allow_restart(st.endpoint):
                continue
            self._ping(st)

    def _ping(self, st: _HostState) -> bool:
        try:
            conn, fresh = self._checkout(st)
        except OSError:
            self._host_event(st)
            return False
        try:
            sock, f = conn
            sock.settimeout(self.connect_timeout_s)
            f.write(b'{"ping": true}\n')
            f.flush()
            raw = f.readline()
            if not raw:
                raise OSError("connection closed on ping")
            healthy = int(json.loads(raw).get("healthy", 0)) > 0
        except (OSError, ValueError):
            _close(conn)
            if fresh:
                self._host_event(st)
            return False
        self._checkin(st, conn)
        if healthy:
            self.supervisor.note_healthy(st.endpoint)
        return healthy


__all__ = ["LBClient", "HostUnavailable"]
