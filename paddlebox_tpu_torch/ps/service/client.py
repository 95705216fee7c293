"""PS service client: ``RemoteTable`` and ``RemotePS`` over the shard
servers (counterpart of ``paddlebox_tpu/ps/service/client.py``).

A :class:`RemoteTable` has the host ``EmbeddingTable``'s pull and push
against N shard servers (``shard_server.py``), so the host-table engine of
``CTRTrainer`` and ``CTRPredictor`` take it as their table:

- keys partition by ``ps/sharded.py``'s ``shard_of``, the one definition
  of ownership;
- each shard's keys are deduplicated before the wire and the reply fans
  back out by the inverse index; a push pre-merges duplicate keys' grads
  with ``np.add.at``, and the shard's merge of merged rows is exact, so
  training through the service gives the local table's bits;
- a fan-out is pipelined: every shard's request goes out before any reply
  is read, so a pull costs the slowest shard, not the sum;
- transient failures (torn frames, resets, a request's deadline) retry
  with backoff under ``utils.faults.with_retries``, failed shards in
  parallel; a spent budget raises :class:`ShardUnavailable` naming the
  shard and its endpoint, and counts ``ps.remote.shard_unavailable`` (the
  ``ps_shard_unavailable`` SLO rule's metric).

The optional ``HotKeyCache`` (``ps/replica_cache.py``) sits in front of
``pull``: a push drops its keys and a pass end clears it, so a cached
training pull never serves a stale row. The ``ps.remote.*`` counters and
histograms go to the client's registry; ``PassManager`` reports their
deltas in its heartbeat.
"""

from __future__ import annotations

import socket
import threading
import time
import uuid
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from paddlebox_tpu_torch.config import TableConfig, ps_service_conf
from paddlebox_tpu_torch.obs import trace
from paddlebox_tpu_torch.obs.metrics import REGISTRY
from paddlebox_tpu_torch.ps.sharded import partition_dedup, shard_of
from paddlebox_tpu_torch.serving import transport
from paddlebox_tpu_torch.utils import faults


class ShardUnavailable(RuntimeError):
    """A shard stayed unreachable through the whole retry budget; names
    the fault domain that is down."""

    def __init__(self, shard: int, endpoint: str, op: str,
                 attempts: int, cause: BaseException):
        super().__init__(
            f"PS shard {shard} at {endpoint} unavailable after "
            f"{attempts} attempt(s) of {op!r}: "
            f"{type(cause).__name__}: {cause}")
        self.shard = shard
        self.endpoint = endpoint
        self.op = op


class RemoteError(RuntimeError):
    """The shard answered with an application error (bad shapes, a
    lifecycle misuse): the request failed, the shard is fine. Never
    retried, never counted against the shard."""


class ServiceClient:
    """Connections and retries to N shard servers. One client for each
    consumer (the trainer, each serving replica); its lock only serializes
    accidental use from several threads."""

    #: ops on the data-path deadline; the others (lifecycle and saves,
    #: fsync-paced dir commits, whole-slice snapshots) get the control one
    _DATA_OPS = frozenset(("pull", "push"))

    def __init__(self, endpoints: List[str],
                 deadline_s: Optional[float] = None,
                 retries: Optional[int] = None,
                 control_deadline_s: Optional[float] = None,
                 registry=REGISTRY):
        if not endpoints:
            raise ValueError("ServiceClient needs at least one endpoint")
        conf = ps_service_conf()
        self.endpoints = list(endpoints)
        self.num_shards = len(self.endpoints)
        self.deadline_s = (conf.deadline_s if deadline_s is None
                           else float(deadline_s))
        self.retries = conf.retries if retries is None else int(retries)
        # a tight pull deadline (the slow-shard knob) must not time out a
        # save_base
        self.control_deadline_s = (max(self.deadline_s, 30.0)
                                   if control_deadline_s is None
                                   else float(control_deadline_s))
        if self.deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be > 0, got {self.deadline_s}")
        if self.control_deadline_s <= 0:
            raise ValueError(f"control_deadline_s must be > 0, got "
                             f"{self.control_deadline_s}")
        if self.retries < 0:
            raise ValueError(f"retries must be >= 0, got {self.retries}")
        self.registry = registry
        self._socks: List[Optional[socket.socket]] = \
            [None] * self.num_shards
        self._lock = threading.Lock()
        # the at-most-once envelope: each request carries (client id,
        # seq), and a retry re-sends the same seq
        self._cid = uuid.uuid4().hex
        self._seq = 0

    def _wrap(self, msg: Tuple) -> Tuple:
        self._seq += 1
        ctx = trace.current()
        if ctx is not None:
            # the trace context rides as a fifth element; untraced, the
            # tuple is the four-element envelope
            return ("req", self._cid, self._seq, msg,
                    ctx.child().to_wire())
        return ("req", self._cid, self._seq, msg)

    @staticmethod
    def _inner(wire: Tuple) -> Tuple:
        return wire[3] if wire[0] == "req" else wire

    def _deadline_for(self, wire: Tuple) -> float:
        return (self.deadline_s
                if self._inner(wire)[0] in self._DATA_OPS
                else self.control_deadline_s)

    # -- wire primitives (callers hold _lock) --------------------------------

    def _sock(self, shard: int) -> socket.socket:
        # the retry workers of _retry_many each touch only their own
        # shard's slot
        s = self._socks[shard]
        if s is None:
            host, port = self.endpoints[shard].rsplit(":", 1)
            s = socket.create_connection((host, int(port)),
                                         timeout=self.deadline_s)
            # a frame is a header and a payload write: without NODELAY
            # Nagle holds the second for the first's delayed ACK
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.settimeout(self.deadline_s)
            self._socks[shard] = s
        return s

    def _drop(self, shard: int) -> None:
        """After any failure the connection's state is unknown (a late
        reply would answer the wrong call): close it; the next attempt
        reconnects."""
        s = self._socks[shard]
        self._socks[shard] = None
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def _call(self, shard: int, msg: Tuple) -> Any:
        """One request and reply. Transport trouble (a clean EOF too: the
        shard died between request and reply) raises for the retry layer;
        an ``("err", ...)`` reply raises :class:`RemoteError`, final."""
        try:
            sock = self._sock(shard)
            sock.settimeout(self._deadline_for(msg))
            payload = transport.pack_obj(msg)
            transport.send_frame(sock, payload)
            self.registry.add("ps.remote.bytes_out", len(payload))
            raw = transport.recv_frame(sock)
            if raw is None:
                raise transport.TornFrame(
                    "shard closed while a reply was owed")
            self.registry.add("ps.remote.bytes_in", len(raw))
            status, body = transport.unpack_obj(raw)
        except Exception:
            # a transport failure, or a reply that does not unpickle: the
            # connection's state is unknowable either way
            self._drop(shard)
            raise
        if status != "ok":
            raise RemoteError(f"shard {shard}: {body}")
        return body

    def _unavailable(self, shard: int, msg: Tuple, attempts: int,
                     cause: BaseException) -> ShardUnavailable:
        self.registry.add("ps.remote.shard_unavailable")
        return ShardUnavailable(shard, self.endpoints[shard],
                                str(self._inner(msg)[0]), attempts,
                                cause)

    def _retry(self, shard: int, msg: Tuple,
               first_exc: BaseException) -> Any:
        """Re-attempt a failed call under the remaining budget; a
        ``WireVersionMismatch`` is permanent (mixed builds do not heal)
        and gives up at once."""
        if self.retries < 1 or isinstance(
                first_exc, transport.WireVersionMismatch):
            raise self._unavailable(shard, msg, 1, first_exc) \
                from first_exc

        def attempt():
            self.registry.add("ps.remote.retries")
            return self._call(shard, msg)

        try:
            return faults.with_retries(
                attempt, attempts=self.retries, base_delay=0.02,
                max_delay=0.5,
                retry_on=(transport.TransportError, OSError),
                giveup=lambda e: isinstance(
                    e, transport.WireVersionMismatch))
        except (transport.TransportError, OSError) as e:
            raise self._unavailable(shard, msg, self.retries + 1, e) \
                from e

    # -- public request surface ----------------------------------------------

    def request(self, shard: int, msg: Tuple) -> Any:
        """One retried request to one shard."""
        with self._lock:
            wire = self._wrap(msg)
            try:
                return self._call(shard, wire)
            except (transport.TransportError, OSError) as e:
                return self._retry(shard, wire, e)

    def exchange(self, msgs: Mapping[int, Tuple]) -> Dict[int, Any]:
        """Pipelined fan-out: every shard's request is sent before any
        reply is read, then the replies are read in turn; the shards that
        failed either phase go through the retry budget."""
        out: Dict[int, Any] = {}
        failed: Dict[int, BaseException] = {}
        remote_err: Optional[RemoteError] = None
        with self._lock:
            wires = {shard: self._wrap(msg)
                     for shard, msg in msgs.items()}
            sent = []
            for shard, wire in wires.items():
                try:
                    sock = self._sock(shard)
                    sock.settimeout(self._deadline_for(wire))
                    payload = transport.pack_obj(wire)
                    transport.send_frame(sock, payload)
                    self.registry.add("ps.remote.bytes_out",
                                      len(payload))
                    sent.append(shard)
                except (transport.TransportError, OSError) as e:
                    self._drop(shard)
                    failed[shard] = e
            # every sent shard's reply is read (or its connection dropped)
            # before an error propagates: an unread reply would answer the
            # next request on that socket
            hard_err: Optional[BaseException] = None
            for shard in sent:
                try:
                    raw = transport.recv_frame(self._socks[shard])
                    if raw is None:
                        raise transport.TornFrame(
                            "shard closed while a reply was owed")
                    self.registry.add("ps.remote.bytes_in", len(raw))
                    status, body = transport.unpack_obj(raw)
                except (transport.TransportError, OSError) as e:
                    self._drop(shard)
                    failed[shard] = e
                    continue
                except Exception as e:  # noqa: BLE001 - raised after
                    # a reply that does not unpickle: drop its connection,
                    # read the others clean, raise after
                    self._drop(shard)
                    if hard_err is None:
                        hard_err = e
                    continue
                if status != "ok":
                    if remote_err is None:
                        remote_err = RemoteError(
                            f"shard {shard}: {body}")
                    continue
                out[shard] = body
            if hard_err is not None:
                raise hard_err
            if remote_err is not None:
                # the request fails whatever a retry does: spend none
                raise remote_err
            out.update(self._retry_many(failed, wires))
        return out

    def _retry_many(self, failed: Mapping[int, BaseException],
                    wires: Mapping[int, Tuple]) -> Dict[int, Any]:
        """Every failed shard through its retry budget, in parallel, so
        two dead shards cost about one budget of wall clock; each worker
        touches only its own shard's connection. The lowest-numbered
        failed shard's exception is the one raised."""
        if not failed:
            return {}
        if len(failed) == 1:
            (shard, exc), = failed.items()
            return {shard: self._retry(shard, wires[shard], exc)}
        results: Dict[int, Any] = {}
        errors: Dict[int, BaseException] = {}

        def _run(shard: int, exc: BaseException) -> None:
            try:
                results[shard] = self._retry(shard, wires[shard], exc)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors[shard] = e

        threads = [threading.Thread(
            target=_run, args=(shard, exc), daemon=True,
            name=f"ps-client-retry-{shard}")
            for shard, exc in failed.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[min(errors)]
        return results

    def broadcast(self, msg: Tuple) -> List[Any]:
        """The same request to every shard; replies in shard order."""
        replies = self.exchange({s: msg for s in range(self.num_shards)})
        return [replies[s] for s in range(self.num_shards)]

    def health(self) -> List[Any]:
        """Each shard's {ok, shard, pid}, in shard order."""
        return self.broadcast(("health",))

    def repoint(self, shard: int, endpoint: str) -> None:
        """Adopt a restarted shard's endpoint (``ShardService.restart``
        returns it); the next request reconnects."""
        with self._lock:
            self.endpoints[shard] = endpoint
            self._drop(shard)

    def close(self) -> None:
        with self._lock:
            for shard in range(self.num_shards):
                self._drop(shard)

    def __enter__(self) -> "ServiceClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class RemoteTable:
    """The ``EmbeddingTable`` pull and push against the shard service:
    the table of the trainer's host-table engine and of the serving
    predictor. ``cache_rows`` None = the ``ps_service_cache_rows``
    flag's."""

    def __init__(self, conf: TableConfig, client: ServiceClient,
                 name: str = "embedding",
                 cache_rows: Optional[int] = None):
        self.conf = conf
        self.client = client
        self.name = name
        self.registry = client.registry
        rows = (ps_service_conf().cache_rows if cache_rows is None
                else int(cache_rows))
        if rows:
            # a cache-less consumer does not load the cache's module
            from paddlebox_tpu_torch.ps.replica_cache import HotKeyCache
            self._cache: Optional[object] = HotKeyCache(
                rows, conf.pull_dim)
        else:
            self._cache = None

    def _partition(self, keys: np.ndarray
                   ) -> Tuple[List[np.ndarray], np.ndarray]:
        """Per-shard deduplicated key buckets and the reassembly index."""
        return partition_dedup(keys, self.client.num_shards)

    # -- pull/push -----------------------------------------------------------

    def _wire_pull(self, keys: np.ndarray, create: bool) -> np.ndarray:
        """Deduplicated, pipelined pull of nonempty ``keys``."""
        buckets, inverse = self._partition(keys)
        msgs = {s: ("pull", self.name, b, create)
                for s, b in enumerate(buckets) if b.size}
        replies = self.client.exchange(msgs)
        parts = [replies[s] if b.size else
                 np.zeros((0, self.conf.pull_dim), np.float32)
                 for s, b in enumerate(buckets)]
        return np.concatenate(parts, axis=0)[inverse]

    def pull(self, keys: np.ndarray, create: bool = True) -> np.ndarray:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        t0 = time.perf_counter()
        with trace.span("ps.pull", table=self.name,
                        keys=int(keys.size)):
            cache = self._cache
            if cache is None:
                out = self._wire_pull(keys, create) if keys.size else \
                    np.zeros((0, self.conf.pull_dim), np.float32)
            else:
                vals, hit = cache.lookup(keys)
                n_hit = int(hit.sum())
                self.registry.add("ps.remote.cache_hit", n_hit)
                self.registry.add("ps.remote.cache_miss",
                                  int(keys.size - n_hit))
                if n_hit < keys.size:
                    miss = ~hit
                    miss_keys = np.ascontiguousarray(keys[miss],
                                                     dtype=np.uint64)
                    uniq, inverse = np.unique(miss_keys,
                                              return_inverse=True)
                    uniq_vals = self._wire_pull(uniq, create)
                    cache.insert(uniq, uniq_vals)
                    vals[miss] = uniq_vals[inverse]
                out = vals
        lat_ms = (time.perf_counter() - t0) * 1e3
        self.registry.observe("ps.remote.pull_ms", lat_ms)
        # the serving tier's per-hop breakdown reads its PS leg here
        self.registry.observe("serve.hop.ps_pull_ms", lat_ms)
        return out

    def push(self, keys: np.ndarray, grads: np.ndarray) -> None:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        grads = np.asarray(grads, dtype=np.float32)
        if grads.shape != (keys.size, self.conf.pull_dim):
            raise ValueError(f"push grads shape {grads.shape} != "
                             f"({keys.size}, {self.conf.pull_dim})")
        if not keys.size:
            return
        t0 = time.perf_counter()
        buckets, inverse = self._partition(keys)
        # duplicate keys' grads merged here: the shard applies one merged
        # row a key, what its own merge would give, for fewer bytes
        merged = np.zeros((sum(b.size for b in buckets),
                           self.conf.pull_dim), np.float32)
        np.add.at(merged, inverse, grads)
        msgs = {}
        base = 0
        for s, b in enumerate(buckets):
            if b.size:
                msgs[s] = ("push", self.name, b,
                           merged[base:base + b.size])
            base += b.size
        try:
            self.client.exchange(msgs)
        finally:
            if self._cache is not None:
                # the pushed rows changed on their shards, also on a
                # partial failure (one shard applied, another raised)
                self._cache.drop(np.unique(keys))
        self.registry.observe("ps.remote.push_ms",
                              (time.perf_counter() - t0) * 1e3)

    # -- lifecycle (this table's; RemotePS drives the PS-wide ops) -----------

    def feed_pass(self, keys: np.ndarray) -> None:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        buckets, _ = self._partition(keys)
        try:
            self.client.exchange({s: ("feed", {self.name: b})
                                  for s, b in enumerate(buckets)
                                  if b.size})
        finally:
            if self._cache is not None:
                # the feed creates absent keys: a create=False pull before
                # it may have cached their zeros
                self._cache.drop(np.unique(keys))

    def end_pass(self) -> None:
        self.client.broadcast(("table_end_pass", self.name))
        if self._cache is not None:
            # end_pass decays every row's show/clk
            self._cache.clear()

    def import_rows(self, keys: np.ndarray, values: np.ndarray,
                    state: np.ndarray, mode: str = "set") -> None:
        """Bulk-load rows onto their owning shards (a serving handoff, a
        migration)."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        if not keys.size:
            return
        sid = shard_of(keys, self.client.num_shards)
        msgs = {}
        for s in range(self.client.num_shards):
            sel = np.flatnonzero(sid == s)
            if sel.size:
                msgs[s] = ("import", self.name, keys[sel], values[sel],
                           state[sel], mode)
        try:
            self.client.exchange(msgs)
        finally:
            if self._cache is not None:
                self._cache.drop(np.unique(keys))

    def merged_snapshot(self) -> Dict[str, np.ndarray]:
        """The whole table across shards, sorted by key (the parity view);
        the shards' dirty marks are left as they are."""
        snaps = self.client.broadcast(("snapshot", self.name))
        merged = {k: np.concatenate([s[k] for s in snaps], axis=0)
                  for k in snaps[0]}
        order = np.argsort(merged["keys"], kind="stable")
        return {k: v[order] for k, v in merged.items()}

    def cache_stats(self) -> Optional[Dict[str, int]]:
        c = self._cache
        if c is None:
            return None
        return {"rows": c.size, "capacity": c.capacity, "hits": c.hits,
                "misses": c.misses, "evictions": c.evictions}

    def __len__(self) -> int:
        return sum(st["num_features"].get(self.name, 0)
                   for st in self.client.broadcast(("stats",)))

    def memory_bytes(self) -> int:
        """The owning shards' bytes (all tables of their slices)."""
        return sum(st["memory_bytes"]
                   for st in self.client.broadcast(("stats",)))


class RemotePS:
    """``SparsePS`` over the shard service: the trainer's handle of the
    pass lifecycle and the saves across every shard (each commits its own
    slice under its own root and donefile)."""

    def __init__(self, client: ServiceClient,
                 table_confs: Mapping[str, TableConfig],
                 cache_rows: Optional[int] = None):
        if not table_confs:
            raise ValueError("RemotePS needs at least one table")
        self.client = client
        self.tables: Dict[str, RemoteTable] = {
            name: RemoteTable(conf, client, name=name,
                              cache_rows=cache_rows)
            for name, conf in table_confs.items()}
        self.current_pass: Optional[int] = None

    def __getitem__(self, name: str) -> RemoteTable:
        return self.tables[name]

    def begin_pass(self, pass_id: int) -> None:
        if self.current_pass is not None:
            raise RuntimeError(
                f"pass {self.current_pass} still open; call end_pass "
                "first")
        self.client.broadcast(("begin_pass", int(pass_id)))
        self.current_pass = int(pass_id)

    def feed_pass(self, keys_by_table: Mapping[str, np.ndarray]) -> None:
        """One ``feed`` a shard carrying every table's bucket."""
        per_shard: Dict[int, Dict[str, np.ndarray]] = {}
        for name, keys in keys_by_table.items():
            table = self.tables[name]
            buckets, _ = table._partition(
                np.ascontiguousarray(keys, dtype=np.uint64))
            for s, b in enumerate(buckets):
                if b.size:
                    per_shard.setdefault(s, {})[name] = b
        try:
            self.client.exchange({s: ("feed", tables)
                                  for s, tables in per_shard.items()})
        finally:
            for name, keys in keys_by_table.items():
                cache = self.tables[name]._cache
                if cache is not None:
                    cache.drop(np.unique(
                        np.ascontiguousarray(keys, dtype=np.uint64)))

    def prefetch_pass(self, keys_by_table) -> None:
        """Host tables stage at ``feed_pass``."""

    def end_pass(self) -> None:
        self.client.broadcast(("end_pass",))
        for t in self.tables.values():
            if t._cache is not None:
                t._cache.clear()
        self.current_pass = None

    def shrink(self) -> int:
        return sum(self.client.broadcast(("shrink",)))

    def save_base(self, day: str, pass_id: int) -> List[str]:
        """Every shard commits its slice (an atomic dir and a donefile
        line under ``<root>/shard-NNN/``); returns their paths."""
        return self.client.broadcast(("save_base", str(day),
                                      int(pass_id)))

    def save_delta(self, day: str, pass_id: int) -> List[str]:
        return self.client.broadcast(("save_delta", str(day),
                                      int(pass_id)))

    def num_features(self) -> Dict[str, int]:
        out: Dict[str, int] = {name: 0 for name in self.tables}
        for st in self.client.broadcast(("stats",)):
            for name, n in st["num_features"].items():
                out[name] = out.get(name, 0) + n
        return out

    def memory_bytes(self) -> int:
        return sum(st["memory_bytes"]
                   for st in self.client.broadcast(("stats",)))
