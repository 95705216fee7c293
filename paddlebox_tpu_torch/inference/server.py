"""The prediction server: a micro-batching TCP server over an exported
bundle (counterpart of ``paddlebox_tpu/inference/server.py``, the same
protocol).

Protocol: newline-delimited JSON over TCP. A request
``{"lines": ["<MultiSlot text line>", ...]}`` (optionally with
``"deadline_ms"`` and a ``"trace"`` context) gets ``{"scores": [...]}`` or
``{"error": "..."}``; one request a line, connections persist.

:class:`PredictServer` merges the requests of concurrent connections on
one batch thread (up to the predictor's batch size or ``batch_wait_ms``)
and scores them in one ``predict_records`` call on its predictor's device
(``device=``, default ``cuda``): on the card each batch of the call runs
the table pull, the seqpool+CVM kernel and the model there.
``metrics_port`` starts ``/metrics`` and ``/healthz`` beside it
(``obs/http.py``); an SLO engine's firing ``action=shed`` alerts make it
shed load and answer 503 on ``/healthz``. :func:`serve_line_protocol` is
the connection loop it shares with the fleet's ``serving/frontdoor.py``,
and :func:`predict_lines` the client.

The request timeout defaults to the ``serve_request_timeout`` flag
(``PBOX_FLAGS_serve_request_timeout``).
"""

from __future__ import annotations

import json
import queue
import socket
import socketserver
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence, Tuple

import numpy as np

from paddlebox_tpu_torch.config import flag
from paddlebox_tpu_torch.data.parser import SlotParser
from paddlebox_tpu_torch.obs import postmortem, slo, trace
from paddlebox_tpu_torch.obs.http import ObsHttpServer
from paddlebox_tpu_torch.obs.metrics import REGISTRY
from paddlebox_tpu_torch.obs.slo import Rule, SloEngine


def serve_line_protocol(handler: socketserver.StreamRequestHandler,
                        handle_line, timeout_s: Optional[float],
                        registry=REGISTRY) -> None:
    """The newline-JSON connection loop of :class:`PredictServer` and the
    fleet's front door: read a request line, write a reply line, until the
    peer leaves.

    ``timeout_s`` guards against a slow peer: the connection gets a socket
    timeout, so a client that connects and sends nothing, stalls mid-line
    or stops reading is disconnected (``serve.idle_disconnects``) instead
    of holding a handler thread. 0 or None disables it."""
    if timeout_s and timeout_s > 0:
        handler.connection.settimeout(float(timeout_s))
    while True:
        try:
            raw = handler.rfile.readline()
        except OSError:              # socket.timeout too: an idle peer
            registry.add("serve.idle_disconnects")
            return
        if not raw:
            return                   # clean EOF
        try:
            reply = handle_line(raw)
        except Exception as e:       # a malformed request keeps the
            reply = {"error": str(e)}  # connection
        try:
            handler.wfile.write((json.dumps(reply) + "\n").encode())
            handler.wfile.flush()
        except OSError:              # the peer left or stopped reading
            registry.add("serve.idle_disconnects")
            return


class _Request:
    __slots__ = ("records", "future", "deadline")

    def __init__(self, records, future, deadline):
        self.records = records
        self.future = future
        self.deadline = deadline


class PredictServer:
    """Serve an exported bundle on ``host:port`` (port 0 picks a free
    one)."""

    def __init__(self, bundle_path: str, host: str = "127.0.0.1",
                 port: int = 0, batch_wait_ms: float = 2.0,
                 predictor=None,
                 max_pending: int = 64,
                 request_timeout_s: Optional[float] = None,
                 metrics_port: Optional[int] = None,
                 slo_engine: Optional[SloEngine] = None,
                 slo_rules: Optional[Sequence[Rule]] = None,
                 device=None):
        """``predictor`` serves instead of a ``CTRPredictor`` built over
        ``bundle_path`` on ``device``. ``metrics_port``: an HTTP endpoint
        (``/metrics``, ``/healthz``) on that port (0 = free; its address
        in ``.metrics_address`` after ``start()``).

        ``slo_engine``/``slo_rules``: admission control. The engine's
        ``action=shed`` alerts make the server shed load while they fire,
        and any firing alert turns ``/healthz`` to 503. ``slo_rules``
        alone builds a private engine whose evaluator starts and stops
        with the server."""
        if predictor is None:
            # imported here: the line protocol and the client need no torch
            from paddlebox_tpu_torch.inference.predictor import CTRPredictor
            predictor = CTRPredictor(bundle_path, device=device)
        self.predictor = predictor
        self.parser = SlotParser(self.predictor.feed_conf)
        trace.maybe_enable()
        postmortem.maybe_install()
        self.batch_wait_s = batch_wait_ms / 1e3
        if request_timeout_s is None:
            request_timeout_s = float(flag("serve_request_timeout"))
        # here the timeout is also each request's queue deadline, so 0
        # (which disables the front door's idle guard) would expire all
        if request_timeout_s <= 0:
            raise ValueError(
                "PredictServer request_timeout_s must be > 0 (it is "
                "also the per-request deadline); the 0-disables idle "
                "guard applies only to the fleet FrontDoor")
        self.request_timeout_s = float(request_timeout_s)
        # bounded: under overload a request fails at once instead of
        # joining a backlog that misses its deadlines anyway
        self._q: "queue.Queue[_Request]" = queue.Queue(maxsize=max_pending)
        self._closed = threading.Event()
        self._started = False
        # serializes start() and stop()
        self._lifecycle_lock = threading.Lock()
        srv_self = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                serve_line_protocol(self, srv_self._handle_line,
                                    srv_self.request_timeout_s)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address[:2]
        self._serve_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="predict-accept")
        self._batch_thread = threading.Thread(
            target=self._batch_loop, daemon=True, name="predict-batch")
        self._obs_http: Optional[ObsHttpServer] = None
        if metrics_port is not None:
            self._obs_http = ObsHttpServer(
                health_fn=self._health, host=host, port=metrics_port)
        self.metrics_address: Optional[Tuple[str, int]] = None
        self._shedding = threading.Event()
        self._slo: Optional[SloEngine] = None
        self._owns_slo = False
        self._t_start: Optional[float] = None
        if slo_engine is None and slo_rules is not None:
            slo_engine = SloEngine()
            self._owns_slo = True
        if slo_engine is not None:
            self.attach_slo(slo_engine, rules=slo_rules)

    # -- SLO / load shedding -------------------------------------------------

    def attach_slo(self, engine: SloEngine,
                   rules: Optional[Sequence[Rule]] = None) -> SloEngine:
        """Shed load while ``engine``'s ``action=shed`` alerts fire (and
        answer 503 on ``/healthz``)."""
        self._slo = engine
        if rules:
            engine.add_rules(rules)
        engine.add_callback(self._on_alert)
        # a shed alert already firing: callbacks see only later changes
        if any(a["labels"].get("action") == "shed"
               for a in engine.firing()):
            self._shedding.set()
        return engine

    def _on_alert(self, alert, old: str, new: str) -> None:
        if alert.rule.labels.get("action") != "shed":
            return
        if new == slo.FIRING:
            if not self._shedding.is_set():
                REGISTRY.add("serve.shed_entered")
            self._shedding.set()
        elif new == slo.RESOLVED and self._slo is not None and not any(
                a["labels"].get("action") == "shed"
                for a in self._slo.firing()):
            if self._shedding.is_set():
                REGISTRY.add("serve.shed_exited")
            self._shedding.clear()

    @property
    def shedding(self) -> bool:
        return self._shedding.is_set()

    def _health(self) -> Tuple[bool, dict]:
        """``/healthz``: unhealthy when the batch thread died, the server
        stopped or an attached alert fires."""
        alive = self._batch_thread.is_alive()
        firing = self._slo.firing() if self._slo is not None else []
        ok = (self._started and not self._closed.is_set() and alive
              and not firing)
        uptime = (time.monotonic() - self._t_start
                  if self._t_start is not None else 0.0)
        return ok, {
            "uptime_s": round(uptime, 3),
            "model_version": getattr(self.predictor, "model_version", None),
            "queue_depth": self._q.qsize(),
            "batch_thread_alive": alive,
            "started": self._started,
            "stopped": self._closed.is_set(),
            "shedding": self._shedding.is_set(),
            "alerts": {"firing_count": len(firing),
                       "firing": [{"rule": a["rule"],
                                   "metric": a["metric"],
                                   "value": a["value"],
                                   "threshold": a["threshold"]}
                                  for a in firing]},
        }

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> Tuple[str, int]:
        with self._lifecycle_lock:
            if self._closed.is_set():
                raise RuntimeError("server already stopped")
            self._started = True      # published before the threads run
            self._t_start = time.monotonic()
            self._serve_thread.start()
            self._batch_thread.start()
            if self._obs_http is not None:
                self.metrics_address = self._obs_http.start()
            if self._owns_slo and self._slo is not None:
                self._slo.start()
        return self.host, self.port

    def stop(self) -> None:
        with self._lifecycle_lock:
            self._closed.set()
            if self._slo is not None:
                # a shared engine must not keep this server alive
                self._slo.remove_callback(self._on_alert)
                if self._owns_slo:
                    self._slo.stop()
            # shutdown() waits for serve_forever's loop: only when it runs
            if self._started and self._serve_thread.is_alive():
                self._server.shutdown()
            self._server.server_close()
            if self._obs_http is not None:
                self._obs_http.stop()
        # fail what is queued so handlers do not sit out their timeout
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            r.future.set_exception(RuntimeError("server stopped"))
        if self._serve_thread.is_alive():
            self._serve_thread.join(timeout=2.0)
        if self._batch_thread.is_alive():
            self._batch_thread.join(timeout=2.0)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- request path --------------------------------------------------------

    def _handle_line(self, raw: bytes):
        t0 = time.perf_counter()
        REGISTRY.add("serve.requests")
        try:
            # shedding rejects before parse or enqueue
            if self._shedding.is_set():
                REGISTRY.add("serve.shed")
                raise RuntimeError(
                    "server shedding load (SLO alert firing)")
            req = json.loads(raw)
            lines = req.get("lines")
            if not isinstance(lines, list) or not lines:
                raise ValueError(
                    "request must carry a non-empty 'lines' list")
            if trace.enabled():
                ctx = trace.from_wire(req.get("trace")) or trace.mint()
                with trace.activate(ctx):
                    trace.instant("serve.request_admitted",
                                  lines=len(lines))
            records = [self.parser.parse_line(ln) for ln in lines]
            fut: Future = Future()
            t = self.request_timeout_s
            # the client's deadline caps the server's: a request the
            # client gave up on fails at admission
            deadline_ms = req.get("deadline_ms")
            if deadline_ms is not None:
                t = min(t, float(deadline_ms) / 1e3)
                if t <= 0:
                    REGISTRY.add("serve.expired")
                    raise RuntimeError(
                        "request deadline already expired at admission")
            try:
                self._q.put(_Request(records, fut, time.monotonic() + t),
                            timeout=0.5)
            except queue.Full:
                REGISTRY.add("serve.overloaded")
                raise RuntimeError(
                    "server overloaded (queue full)") from None
            scores = fut.result(timeout=t)
        except Exception:
            REGISTRY.add("serve.errors")
            raise
        REGISTRY.add("serve.rows", len(scores))
        REGISTRY.observe("serve.request_ms",
                         (time.perf_counter() - t0) * 1e3)
        return {"scores": [float(s) for s in scores]}

    def _batch_loop(self) -> None:
        """Merge queued requests into one predictor call; a fatal escape
        ends the thread (``/healthz`` turns 503) after a postmortem
        bundle."""
        try:
            self._batch_loop_impl()
        except Exception as e:
            postmortem.maybe_dump("serve.batch_loop died", exc=e)
            raise

    def _batch_loop_impl(self) -> None:
        B = self.predictor.feed_conf.batch_size
        while not self._closed.is_set():
            try:
                first = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            batch: List[_Request] = [first]
            rows = len(first.records)
            wait = None if rows >= B else self.batch_wait_s
            while rows < B:
                try:
                    r = self._q.get(timeout=wait)
                except queue.Empty:
                    break
                batch.append(r)
                rows += len(r.records)
                wait = 0.0           # then take what is already queued
            # a request whose client timed out is not scored
            now = time.monotonic()
            live, expired = [], []
            for r in batch:
                (live if r.deadline > now else expired).append(r)
            for r in expired:
                REGISTRY.add("serve.expired")
                r.future.set_exception(
                    RuntimeError("request expired in queue"))
            batch = live
            if not batch:
                continue
            all_records = [rec for r in batch for rec in r.records]
            REGISTRY.observe("serve.batch_rows", len(all_records))
            try:
                with trace.span("serve.dispatch", rows=len(all_records)):
                    preds = self.predictor.predict_records(all_records)
            except Exception as e:
                for r in batch:
                    r.future.set_exception(e)
                continue
            o = 0
            for r in batch:
                n = len(r.records)
                r.future.set_result(preds[o:o + n])
                o += n


def predict_lines(host: str, port: int, lines: Sequence[str],
                  timeout: float = 30.0,
                  deadline_ms: Optional[float] = None) -> np.ndarray:
    """Client: one request, its scores (raises on an ``error`` reply).
    ``deadline_ms`` rides in the request, so the server stops working on
    it once the caller would have given up."""
    req = {"lines": list(lines)}
    if deadline_ms is not None:
        req["deadline_ms"] = float(deadline_ms)
    ctx = trace.current()
    if ctx is None and trace.enabled():
        ctx = trace.mint()
    if ctx is not None:
        req["trace"] = ctx.child().to_wire()
    with socket.create_connection((host, port), timeout=timeout) as s:
        f = s.makefile("rwb")
        f.write((json.dumps(req) + "\n").encode())
        f.flush()
        reply = json.loads(f.readline())
    if "error" in reply:
        raise RuntimeError(f"server error: {reply['error']}")
    return np.asarray(reply["scores"], dtype=np.float32)
