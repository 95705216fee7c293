"""The fleet's TCP front door (counterpart of
``paddlebox_tpu/serving/frontdoor.py``).

:class:`FrontDoor` makes a :class:`~serving.fleet.ReplicaSet` listen with
``PredictServer``'s line protocol (newline-delimited JSON,
``{"lines": [...]}`` -> ``{"scores": [...]}`` or ``{"error": ...}``; an
optional ``"deadline_ms"`` overrides ``serve_deadline_ms``), so its
clients, ``inference.server.predict_lines`` among them, work unchanged.
Each request goes to ``ReplicaSet.predict_lines``: admission before
parsing, least-outstanding routing, deadline batching, rerouting. A
``{"ping": true}`` line answers from the fleet's health document without
touching a replica.

Each connection runs under the idle guard ``serve_request_timeout`` (0
disables it here).
"""

from __future__ import annotations

import json
import socketserver
import threading
from typing import Optional, Tuple

from paddlebox_tpu_torch.config import flag
from paddlebox_tpu_torch.inference.server import serve_line_protocol
from paddlebox_tpu_torch.obs import trace
from paddlebox_tpu_torch.serving.fleet import ReplicaSet


class FrontDoor:
    """Serve a :class:`~serving.fleet.ReplicaSet` on ``host:port`` (port
    0 picks a free one; ``.address`` after construction)."""

    def __init__(self, fleet: ReplicaSet, host: str = "127.0.0.1",
                 port: int = 0,
                 request_timeout_s: Optional[float] = None):
        self.fleet = fleet
        self.request_timeout_s = (
            float(flag("serve_request_timeout"))
            if request_timeout_s is None else float(request_timeout_s))
        door_self = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                door_self.fleet.registry.add("serving.frontdoor_conns")
                serve_line_protocol(self, door_self._handle_line,
                                    door_self.request_timeout_s,
                                    registry=door_self.fleet.registry)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="serve-frontdoor")
        self._started = False
        self._stopped = False        # guarded-by: _stop_lock
        self._stop_lock = threading.Lock()

    @property
    def address(self) -> Tuple[str, int]:
        return self.host, self.port

    def _handle_line(self, raw: bytes):
        req = json.loads(raw)
        if req.get("ping"):
            ok, doc = self.fleet.health()
            return {"ok": bool(ok), "healthy": int(doc["healthy"]),
                    "size": int(doc["size"])}
        lines = req.get("lines")
        if not isinstance(lines, list) or not lines:
            raise ValueError(
                "request must carry a non-empty 'lines' list")
        deadline_ms = req.get("deadline_ms")
        # the caller's wire context, or a root when tracing is on
        ctx = None
        if trace.enabled():
            ctx = trace.from_wire(req.get("trace")) or trace.mint()
        with trace.activate(ctx):
            with trace.span("frontdoor.request", lines=len(lines)):
                scores = self.fleet.predict_lines(
                    lines, deadline_ms=float(deadline_ms)
                    if deadline_ms is not None else None)
        return {"scores": [float(s) for s in scores]}

    # -- lifecycle (idempotent stop, as ObsHttpServer's) ----------------------

    def start(self) -> Tuple[str, int]:
        self._started = True         # published before the loop runs
        self._thread.start()
        return self.host, self.port

    def stop(self, join_timeout: float = 5.0) -> None:
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
        if self._started and self._thread.is_alive():
            self._server.shutdown()
            self._thread.join(timeout=join_timeout)
        self._server.server_close()

    def __enter__(self) -> "FrontDoor":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
