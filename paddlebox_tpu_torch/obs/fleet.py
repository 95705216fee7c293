"""The fleet's telemetry plane: every process's metrics behind one
``/metrics`` (counterpart of ``paddlebox_tpu/obs/fleet.py``).

Each piece of the serving fleet exports its telemetry somewhere: a
serving host's child runs its own ``/metrics`` (``obs/http.py``), a shard
service answers ``stats``, a local registry is in memory.
:class:`FleetMetrics` scrapes such sources on demand (``scrape_once``) or
every ``obs_fleet_interval`` seconds on a thread, lands every sample in one
registry as a ``fleet.<source>.<metric>`` gauge, and ``serve()`` exposes
it at one ``/metrics`` (Prometheus text).

Scrapes are best effort: a dead host or a host mid-restart gives nothing
that tick (``fleet.scrape_errors`` counts it) and never fails the plane.
A host's samples carry their Prometheus names
(``fleet.hosts.h0.pbx_serve_launches_seqpool_cvm_cuda``).

Imports neither torch nor numpy.
"""

from __future__ import annotations

import threading
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from paddlebox_tpu_torch.config import flag
from paddlebox_tpu_torch.obs.http import ObsHttpServer
from paddlebox_tpu_torch.obs.metrics import MetricsRegistry

#: a source: () -> flat {metric: number}
SourceFn = Callable[[], Dict[str, float]]


def _numeric_items(doc: Dict, prefix: str = "") -> Dict[str, float]:
    """The numeric leaves of a (nested) dict, flattened with dots."""
    out: Dict[str, float] = {}
    for k, v in doc.items():
        key = f"{prefix}{k}"
        if isinstance(v, (bool, int, float)):
            out[key] = float(v)
        elif isinstance(v, dict):
            out.update(_numeric_items(v, prefix=f"{key}."))
    return out


def _parse_prometheus(text: str) -> Dict[str, float]:
    """The unlabeled ``name value`` samples of a Prometheus page (the
    labeled histogram buckets are skipped: ``_sum`` and ``_count`` carry
    what the fleet view needs)."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "{" in line:
            continue
        name, _, value = line.partition(" ")
        if not name or not value:
            continue
        try:
            out[name] = float(value)
        except ValueError:
            continue
    return out


class FleetMetrics:
    """One registry scraped from N sources, served at one ``/metrics``."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 interval: Optional[float] = None,
                 timeout_s: float = 2.0):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.interval = float(flag("obs_fleet_interval") if interval is None
                              else interval)
        self.timeout_s = float(timeout_s)
        self._lock = threading.Lock()
        self._sources: List[Tuple[str, SourceFn]] = []  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._server: Optional[ObsHttpServer] = None

    # -- sources -------------------------------------------------------------

    def add_source(self, name: str, fn: SourceFn) -> "FleetMetrics":
        """A source: ``fn()`` returns a flat ``{metric: number}`` each
        tick; a raise skips the tick."""
        with self._lock:
            self._sources.append((str(name), fn))
        return self

    def add_registry(self, name: str,
                     registry: MetricsRegistry) -> "FleetMetrics":
        """A local registry (this process's) as a source."""
        return self.add_source(
            name, lambda: _numeric_items(registry.snapshot()))

    def add_shard_service(self, service, name: str = "ps") -> "FleetMetrics":
        """Every shard of a shard service through its ``stats()`` (one dict
        a shard, duck-typed)."""
        def scrape() -> Dict[str, float]:
            out: Dict[str, float] = {}
            for i, doc in enumerate(service.stats()):
                if isinstance(doc, dict):
                    out.update(_numeric_items(doc, f"shard{i}."))
            return out
        return self.add_source(name, scrape)

    def add_host_fleet(self, fleet, name: str = "hosts") -> "FleetMetrics":
        """Every live host of a :class:`~serving.host.HostFleet` through
        the ``/metrics`` its ready document names (``ServingHost.metrics``).
        """
        def scrape() -> Dict[str, float]:
            out: Dict[str, float] = {}
            for h in list(fleet.hosts):
                if h is None or h.metrics is None or not h.alive():
                    continue
                host, port = h.metrics
                out.update(_numeric_items(self._scrape_http(host, int(port)),
                                          prefix=f"{h.name}."))
            return out
        return self.add_source(name, scrape)

    def _scrape_http(self, host: str, port: int) -> Dict[str, float]:
        url = f"http://{host}:{port}/metrics"
        with urllib.request.urlopen(url, timeout=self.timeout_s) as resp:
            return _parse_prometheus(resp.read().decode(errors="replace"))

    # -- scraping ------------------------------------------------------------

    def scrape_once(self) -> int:
        """Pull every source into the registry; the samples landed. A
        failing source counts in ``fleet.scrape_errors`` and is skipped."""
        with self._lock:
            sources = list(self._sources)
        landed = 0
        for name, fn in sources:
            try:
                doc = fn()
            except Exception:  # noqa: BLE001 - the plane outlives a source
                self.registry.add("fleet.scrape_errors")
                continue
            for metric, value in doc.items():
                self.registry.gauge(f"fleet.{name}.{metric}").set(value)
                landed += 1
        self.registry.add("fleet.scrapes")
        self.registry.gauge("fleet.sources").set(len(sources))
        return landed

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001 - the plane outlives a source
                self.registry.add("fleet.scrape_errors")

    # -- lifecycle -----------------------------------------------------------

    def serve(self, host: str = "127.0.0.1",
              port: int = 0) -> Tuple[str, int]:
        """Start the scraper thread and the one ``/metrics``; returns its
        address."""
        if self._server is None:
            self._server = ObsHttpServer(registry=self.registry,
                                         health_fn=self._health,
                                         host=host, port=port)
            self._server.start()
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="obs-fleet")
            self._thread.start()
        return self._server.address

    def _health(self) -> Tuple[bool, Dict]:
        with self._lock:
            n = len(self._sources)
        return True, {"sources": n,
                      "scrapes": self.registry.counter("fleet.scrapes").get()}

    @property
    def address(self) -> Optional[Tuple[str, int]]:
        return self._server.address if self._server is not None else None

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=max(5.0, self.interval + 1.0))
        if self._server is not None:
            self._server.stop()
            self._server = None

    def __enter__(self) -> "FleetMetrics":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


__all__ = ["FleetMetrics"]
