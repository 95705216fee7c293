"""Endpoint resolution for the serving host tier (counterpart of
``paddlebox_tpu/serving/resolver.py``, the same file contract).

A resolver answers one question for LB clients: which front-door
endpoints are live now? The answer is a generation-stamped snapshot, so a
topology change (hosts added, drained, killed) replaces the whole set at
once instead of flapping clients host by host.

- :class:`StaticResolver`: a fixed list (tests, one host).
- :class:`FileResolver`: watches an endpoints file that publishers
  rewrite atomically (tmp + fsync + rename, :func:`write_endpoints`). A
  missing file, a torn or undecodable one, a bad schema, an empty set or
  a generation that goes backwards is ignored and the last good snapshot
  stays in force, so a poll racing a rewrite sees the complete old set or
  the complete new one, never a mix.

The file (JSON)::

    {"generation": 7,
     "endpoints": ["127.0.0.1:9001", "127.0.0.1:9002"],
     "updated_at": 1723000000.0}

``generation`` strictly increases; ``endpoints`` is a non-empty list of
``"host:port"`` strings (a duplicate is dropped, the first kept);
``updated_at`` is informational. Either package's ``write_endpoints``
writes a file the other's ``FileResolver`` reads.

Counters: ``serving.resolver.missing``, ``serving.resolver.torn_reads``,
``serving.resolver.rejected``; gauge ``serving.resolver.generation``. The
watcher's interval is ``serve_resolver_poll`` (``PBOX_FLAGS_*``).
"""

from __future__ import annotations

import json
import threading
from typing import Callable, List, Optional, Tuple

from paddlebox_tpu_torch.ckpt.atomic import write_json
from paddlebox_tpu_torch.config import flag
from paddlebox_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry

Snapshot = Tuple[int, Tuple[str, ...]]          # (generation, endpoints)


def write_endpoints(path: str, endpoints: List[str], generation: int,
                    updated_at: Optional[float] = None) -> None:
    """Atomically publish ``endpoints`` at ``generation`` to ``path``
    (the checkpoint commit's tmp + fsync + rename)."""
    doc = {"generation": int(generation),
           "endpoints": [str(e) for e in endpoints]}
    if updated_at is not None:
        doc["updated_at"] = float(updated_at)
    write_json(path, doc)


def _valid_endpoint(e) -> bool:
    if not isinstance(e, str) or ":" not in e:
        return False
    host, _, port = e.rpartition(":")
    return bool(host) and port.isdigit()


def _dedup(endpoints) -> Tuple[str, ...]:
    return tuple(dict.fromkeys(str(e) for e in endpoints))


class EndpointResolver:
    """Generation-stamped endpoint snapshots and their subscribers.
    Subclasses call :meth:`_adopt` with a candidate snapshot; subscribers
    are called outside the lock."""

    def __init__(self, registry: MetricsRegistry = REGISTRY):
        self.registry = registry
        self._lock = threading.Lock()
        self._generation = 0                       # guarded-by: _lock
        self._endpoints: Tuple[str, ...] = ()      # guarded-by: _lock
        self._subs: List[Callable[[int, Tuple[str, ...]], None]] = []

    def snapshot(self) -> Snapshot:
        with self._lock:
            return self._generation, self._endpoints

    def endpoints(self) -> Tuple[str, ...]:
        return self.snapshot()[1]

    @property
    def generation(self) -> int:
        return self.snapshot()[0]

    def subscribe(self, fn: Callable[[int, Tuple[str, ...]], None]) -> None:
        """Call ``fn(generation, endpoints)`` on every adopted change, and
        once now with the standing snapshot when it is not empty."""
        with self._lock:
            self._subs.append(fn)
            gen, eps = self._generation, self._endpoints
        if eps:
            fn(gen, eps)

    def _adopt(self, generation: int, endpoints: Tuple[str, ...]) -> bool:
        """Install a snapshot if its generation is newer; True when the set
        changed. An older generation counts as rejected; the same set under
        a newer generation advances the generation without waking
        subscribers."""
        with self._lock:
            if generation <= self._generation:
                if generation < self._generation:
                    self.registry.add("serving.resolver.rejected")
                return False
            self._generation = generation
            if endpoints == self._endpoints:
                self.registry.gauge("serving.resolver.generation").set(
                    generation)
                return False
            self._endpoints = endpoints
            subs = list(self._subs)
        self.registry.gauge("serving.resolver.generation").set(generation)
        for fn in subs:
            fn(generation, endpoints)
        return True

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass


class StaticResolver(EndpointResolver):
    """A fixed endpoint list at generation 1."""

    def __init__(self, endpoints: List[str],
                 registry: MetricsRegistry = REGISTRY):
        super().__init__(registry=registry)
        self._adopt(1, _dedup(endpoints))

    def set_endpoints(self, endpoints: List[str]) -> None:
        """Republish a new set under the next generation (tests)."""
        self._adopt(self.generation + 1, _dedup(endpoints))


class FileResolver(EndpointResolver):
    """Watches an atomically rewritten endpoints file: ``poll()`` directly,
    or every ``poll_s`` seconds (default ``serve_resolver_poll``) on the
    watcher thread of ``start()``. Every file-level fault keeps the last
    good snapshot:

    - missing file, ``OSError``: ``serving.resolver.missing``;
    - undecodable JSON (a torn write): ``serving.resolver.torn_reads``;
    - bad schema, an empty set, a generation going back:
      ``serving.resolver.rejected``.
    """

    def __init__(self, path: str, poll_s: Optional[float] = None,
                 registry: MetricsRegistry = REGISTRY):
        super().__init__(registry=registry)
        self.path = str(path)
        self.poll_s = float(flag("serve_resolver_poll") if poll_s is None
                            else poll_s)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.poll()

    def poll(self) -> bool:
        """Re-read the file; True when the live set changed. Never raises
        on trouble with the file."""
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
        except OSError:
            self.registry.add("serving.resolver.missing")
            return False
        try:
            doc = json.loads(raw.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            self.registry.add("serving.resolver.torn_reads")
            return False
        gen = doc.get("generation") if isinstance(doc, dict) else None
        eps = doc.get("endpoints") if isinstance(doc, dict) else None
        if not isinstance(gen, int) or not isinstance(eps, list):
            self.registry.add("serving.resolver.rejected")
            return False
        good = _dedup(e for e in eps if _valid_endpoint(e))
        if not good:
            # an outage of the publisher must not read as an outage of
            # every host: clients keep the last known endpoints
            self.registry.add("serving.resolver.rejected")
            return False
        return self._adopt(gen, good)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="resolver-watch")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.poll()


__all__ = ["EndpointResolver", "StaticResolver", "FileResolver",
           "write_endpoints", "Snapshot"]
