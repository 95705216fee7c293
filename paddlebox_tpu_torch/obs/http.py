"""The observability HTTP endpoint: ``/metrics`` and ``/healthz``
(counterpart of ``paddlebox_tpu/obs/http.py``).

A stdlib ``ThreadingHTTPServer`` with two routes:

- ``GET /metrics``: the registry as Prometheus text (``obs/prometheus.py``);
- ``GET /healthz``: the owner's ``health_fn`` document as JSON, 200 when
  healthy, 503 when not.

``PredictServer(metrics_port=0)`` and ``ReplicaSet.start(metrics_port=0)``
start one beside themselves; port 0 binds an ephemeral port at
construction (``.address``). Handlers are daemon threads that only read.

Imports neither torch nor numpy.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from paddlebox_tpu_torch.obs import prometheus
from paddlebox_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry

#: health_fn contract: () -> (healthy, detail dict)
HealthFn = Callable[[], Tuple[bool, Dict]]


def _default_health() -> Tuple[bool, Dict]:
    return True, {}


class ObsHttpServer:
    """Serve ``/metrics`` and ``/healthz`` on ``host:port``."""

    def __init__(self, registry: MetricsRegistry = REGISTRY,
                 health_fn: Optional[HealthFn] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.registry = registry
        self.health_fn = health_fn or _default_health
        srv_self = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = prometheus.render(srv_self.registry).encode()
                    self._reply(200, prometheus.CONTENT_TYPE, body)
                elif path == "/healthz":
                    try:
                        ok, detail = srv_self.health_fn()
                    except Exception as e:   # the probe itself broke
                        ok, detail = False, {"error": str(e)}
                    doc = {"status": "ok" if ok else "unhealthy", **detail}
                    self._reply(200 if ok else 503, "application/json",
                                (json.dumps(doc) + "\n").encode())
                else:
                    self._reply(404, "text/plain", b"not found\n")

            def _reply(self, code: int, ctype: str, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):   # scrapes stay silent
                pass

        class Server(ThreadingHTTPServer):
            # endpoints restart on the same port while the old socket
            # lingers in TIME_WAIT
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="obs-http")
        self._started = False
        self._stopped = False        # guarded-by: _stop_lock
        self._stop_lock = threading.Lock()

    @property
    def address(self) -> Tuple[str, int]:
        """The bound ``(host, port)``, known from construction on."""
        return self.host, self.port

    def start(self) -> Tuple[str, int]:
        self._started = True         # published before the loop runs
        self._thread.start()
        return self.host, self.port

    def stop(self, join_timeout: float = 5.0) -> None:
        """Idempotent and bounded: safe twice or without ``start``."""
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
        if self._started and self._thread.is_alive():
            self._server.shutdown()
            self._thread.join(timeout=join_timeout)
        self._server.server_close()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
