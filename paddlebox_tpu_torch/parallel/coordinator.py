"""The host transport between training processes (counterpart of
``paddlebox_tpu/parallel/coordinator.py``): the dataset exchange, the
cross-host PS's key routing, pass barriers and the dense sync's sums ride
it, outside the device collectives.

Full-mesh TCP. Every rank listens on its endpoint; a message is a frame
``(src, tag, payload)`` (a ``<iiI`` header: source rank, tag length,
payload length; then the tag in UTF-8, then the payload), routed on
arrival into a queue of its ``(src, tag)``. The collectives (``barrier``,
``all_gather``, ``alltoall``, ``allreduce_sum``) are built from ``send``
and ``recv`` and must be entered by every rank. Arrays travel as
``np_to_bytes`` blobs (``np.save`` without pickle). The wire is the
reference's byte for byte, so a rank of either package talks to a rank of
the other.

Failure detection: ``start_heartbeat`` pings every peer each ``interval``;
``dead_ranks`` names the peers silent longer than a timeout, and with
``abort_timeout`` the heartbeat closes the coordinator when one is, which
makes every blocked and every later ``recv`` raise (naming the dead ranks)
instead of waiting out its timeout. Recovery is pass-grained: the process
exits through the error and restarts from the last base and deltas.

``dense_mean_hook(coord)`` is the dense sync of a multi-host trainer
(``CTRTrainer(dense_sync_hook=)``): the mean of the ranks' dense params in
float64 through ``allreduce_sum``, as the reference's multi-host tests
average theirs.

Imports numpy and the standard library only (torch inside the hook).
"""

from __future__ import annotations

import io
import queue
import socket
import struct
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_HDR = struct.Struct("<iiI")  # src, tag length, payload length


def np_to_bytes(*arrays: np.ndarray) -> bytes:
    """A count (``<i``), then each array as ``np.save`` writes it."""
    buf = io.BytesIO()
    buf.write(struct.pack("<i", len(arrays)))
    for a in arrays:
        np.save(buf, np.ascontiguousarray(a), allow_pickle=False)
    return buf.getvalue()


def np_from_bytes(blob: bytes) -> List[np.ndarray]:
    buf = io.BytesIO(blob)
    (n,) = struct.unpack("<i", buf.read(4))
    return [np.load(buf, allow_pickle=False) for _ in range(n)]


def _read_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise ConnectionError("peer closed")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


class Coordinator:
    """Rank ``rank`` of ``len(endpoints)``; ``endpoints[r]`` is rank
    ``r``'s ``"host:port"`` (the ``PADDLE_TRAINER_ENDPOINTS``
    convention). Listens at once; connects to a peer at its first send,
    retrying for ``connect_timeout`` seconds."""

    _POISON = b"\x00__coordinator_closed__"

    def __init__(self, rank: int, endpoints: Sequence[str],
                 connect_timeout: float = 30.0):
        self.rank = rank
        self.endpoints = list(endpoints)
        self.world = len(endpoints)
        self._queues: Dict[Tuple[int, str], "queue.Queue[bytes]"] = \
            defaultdict(queue.Queue)
        self._qlock = threading.Lock()
        self._peers: Dict[int, socket.socket] = {}
        self._peer_locks: Dict[int, threading.Lock] = {}
        self._peers_lock = threading.Lock()
        self._closed = False
        self._connect_timeout = connect_timeout
        self.aborted_dead: List[int] = []
        host, port = endpoints[rank].rsplit(":", 1)
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((host, int(port)))
        self._server.listen(self.world + 4)
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    # -- wiring --------------------------------------------------------------

    def _queue(self, src: int, tag: str) -> "queue.Queue[bytes]":
        with self._qlock:
            key = (src, tag)
            created = key not in self._queues
            q = self._queues[key]
            if created and self._closed:
                # close() poisoned the queues of its moment; one made
                # after (a recv racing the abort) is born poisoned
                q.put_nowait(self._POISON)
            return q

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _addr = self._server.accept()
            except OSError:
                return
            threading.Thread(target=self._reader, args=(conn,),
                             daemon=True).start()

    def _reader(self, conn: socket.socket) -> None:
        try:
            while True:
                src, tag_len, n = _HDR.unpack(_read_exact(conn, _HDR.size))
                tag = _read_exact(conn, tag_len).decode()
                payload = _read_exact(conn, n) if n else b""
                self._queue(src, tag).put(payload)
        except (ConnectionError, OSError):
            return

    def _peer(self, to: int, connect_timeout: Optional[float] = None
              ) -> Tuple[socket.socket, threading.Lock]:
        """The socket to ``to`` (connected on first use) and its send
        lock. The connect runs outside ``_peers_lock`` (it may block for
        its budget); a second connection that lost the race is closed."""
        with self._peers_lock:
            if to in self._peers:
                return self._peers[to], self._peer_locks[to]
        host, port = self.endpoints[to].rsplit(":", 1)
        deadline = time.monotonic() + (
            connect_timeout if connect_timeout is not None
            else self._connect_timeout)
        while True:
            try:
                # each attempt bounded by what is left of the budget, so a
                # peer that drops SYNs cannot hold a heartbeat for 5 s
                att = min(5.0, max(deadline - time.monotonic(), 0.05))
                s = socket.create_connection((host, int(port)),
                                             timeout=att)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
        with self._peers_lock:
            if self._closed:
                # close() ran while this connect was in flight
                try:
                    s.close()
                except OSError:
                    pass
                raise RuntimeError("coordinator is closed")
            if to in self._peers:
                try:
                    s.close()
                except OSError:
                    pass
            else:
                self._peers[to] = s
                self._peer_locks[to] = threading.Lock()
            return self._peers[to], self._peer_locks[to]

    # -- point to point ------------------------------------------------------

    def send(self, to: int, tag: str, payload: bytes = b"",
             connect_timeout: Optional[float] = None) -> None:
        if to == self.rank:
            self._queue(self.rank, tag).put(payload)
            return
        sock, lock = self._peer(to, connect_timeout)
        tb = tag.encode()
        with lock:
            sock.sendall(_HDR.pack(self.rank, len(tb), len(payload)))
            sock.sendall(tb)
            if payload:
                sock.sendall(payload)

    def recv(self, frm: int, tag: str,
             timeout: Optional[float] = 60.0) -> bytes:
        """The next payload from ``frm`` under ``tag``; raises
        ``queue.Empty`` after ``timeout`` seconds, ``RuntimeError`` once
        the coordinator is closed."""
        out = self._queue(frm, tag).get(timeout=timeout)
        if out == self._POISON:
            raise RuntimeError(
                f"coordinator closed while waiting on rank {frm} tag "
                f"{tag!r}" + (f" (dead ranks: {self.aborted_dead})"
                              if self.aborted_dead else ""))
        return out

    # -- collectives (every rank enters) -------------------------------------

    def barrier(self, name: str = "b") -> None:
        tag = f"__bar:{name}"
        if self.rank == 0:
            for r in range(1, self.world):
                self.recv(r, tag)
            for r in range(1, self.world):
                self.send(r, tag + ":go")
        else:
            self.send(0, tag)
            self.recv(0, tag + ":go")

    def all_gather(self, payload: bytes, name: str = "ag") -> List[bytes]:
        tag = f"__ag:{name}"
        for r in range(self.world):
            self.send(r, tag, payload)
        return [self.recv(r, tag) for r in range(self.world)]

    def alltoall(self, blobs: Sequence[bytes], name: str = "a2a",
                 timeout: Optional[float] = 60.0) -> List[bytes]:
        """``blobs[j]`` goes to rank ``j``; returns one blob from each
        rank. ``timeout`` bounds each recv (a dataset exchange passes a
        long one: a peer may still be parsing its shard)."""
        if len(blobs) != self.world:
            raise ValueError(f"need {self.world} blobs, got {len(blobs)}")
        tag = f"__a2a:{name}"
        for r in range(self.world):
            self.send(r, tag, blobs[r])
        return [self.recv(r, tag, timeout=timeout)
                for r in range(self.world)]

    def allreduce_sum(self, arr: np.ndarray, name: str = "ar") -> np.ndarray:
        """The ranks' arrays added in rank order 0..world-1 (one
        ``all_gather``), the same sum on every rank."""
        parts = self.all_gather(np_to_bytes(np.asarray(arr)), name)
        out = None
        for p in parts:
            a = np_from_bytes(p)[0]
            out = a if out is None else out + a
        return out

    # -- failure detection ---------------------------------------------------

    def start_heartbeat(self, interval: float = 2.0,
                        abort_timeout: Optional[float] = None) -> None:
        """Ping every peer each ``interval`` seconds on a thread of its
        own. With ``abort_timeout``, a peer silent that long closes this
        coordinator (``aborted_dead`` names it). Every peer starts with
        the full timeout from now."""
        now = time.monotonic()
        self._beats: Dict[int, float] = {r: now for r in range(self.world)}
        self._hb_interval = interval
        self._abort_timeout = abort_timeout
        self.aborted_dead = []

        def loop():
            while not self._closed:
                for r in range(self.world):
                    if r != self.rank:
                        try:
                            # a short connect budget: a dead peer must not
                            # hold this thread past the abort check
                            self.send(r, "__hb",
                                      connect_timeout=interval / 2)
                        except (OSError, RuntimeError):
                            pass
                self._drain_beats()
                if self._abort_timeout is not None:
                    dead = self.dead_ranks(self._abort_timeout)
                    if dead:
                        self.aborted_dead = dead
                        self.close()
                        return
                time.sleep(interval)

        self._hb_thread = threading.Thread(target=loop, daemon=True)
        self._hb_thread.start()

    def _drain_beats(self) -> None:
        now = time.monotonic()
        for r in range(self.world):
            if r == self.rank:
                self._beats[r] = now
                continue
            q = self._queue(r, "__hb")
            seen = False
            try:
                while True:
                    q.get_nowait()
                    seen = True
            except queue.Empty:
                pass
            if seen:
                self._beats[r] = now

    def dead_ranks(self, timeout: Optional[float] = None) -> List[int]:
        """The ranks whose last beat is older than ``timeout`` (default 5
        intervals); [] before ``start_heartbeat``."""
        if not hasattr(self, "_beats"):
            return []
        self._drain_beats()
        t = timeout if timeout is not None else 5 * self._hb_interval
        now = time.monotonic()
        return [r for r in range(self.world)
                if now - self._beats.get(r, 0.0) > t]

    def close(self) -> None:
        """Stop listening, close the peers' sockets and poison every
        queue, so a blocked ``recv`` raises. Joins the accept and
        heartbeat threads (never the calling one)."""
        self._closed = True
        # a blocked accept() does not wake when its fd closes: poke it
        try:
            poke = socket.create_connection(self._server.getsockname(),
                                            timeout=0.2)
            poke.close()
        except OSError:
            pass
        try:
            self._server.close()
        except OSError:
            pass
        with self._peers_lock:
            peers = list(self._peers.values())
        for s in peers:
            try:
                s.close()
            except OSError:
                pass
        with self._qlock:
            qs = list(self._queues.values())
        for q in qs:
            q.put_nowait(self._POISON)
        me = threading.current_thread()
        if self._accept_thread is not me and self._accept_thread.is_alive():
            self._accept_thread.join(timeout=1.0)
        hb = getattr(self, "_hb_thread", None)
        if hb is not None and hb is not me and hb.is_alive():
            hb.join(timeout=1.0)


def dense_mean_hook(coord: Coordinator):
    """A ``sync_hook(params) -> params`` for a model (an ``nn.Module``,
    or a list of them): every rank's parameters flattened in
    ``parameters()`` order into one float64 vector, summed over the ranks
    (``allreduce_sum``, rank order), divided by the world and written back
    in place, rounded to each parameter's dtype. A collective: every rank
    calls it at the same step. Its rounds are tagged ``dsync<n>``."""
    rounds = [0]

    def hook(params):
        import torch
        models = params if isinstance(params, (list, tuple)) else [params]
        ps = [p for m in models for p in m.parameters()]
        flat = torch.cat([p.detach().reshape(-1).double() for p in ps])
        rounds[0] += 1
        total = coord.allreduce_sum(flat.cpu().numpy(),
                                    f"dsync{rounds[0]}") / coord.world
        off = 0
        with torch.no_grad():
            for p in ps:
                n = p.numel()
                p.copy_(torch.from_numpy(
                    total[off:off + n].astype(np.float32)).reshape(p.shape))
                off += n
        return params

    return hook


def local_endpoints(world: int) -> List[str]:
    """``world`` free ``127.0.0.1`` endpoints (ports the kernel hands
    out)."""
    socks = []
    eps = []
    for _ in range(world):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        eps.append(f"127.0.0.1:{s.getsockname()[1]}")
    for s in socks:
        s.close()
    return eps
