"""Shard server: one child process owning a hash-slice of the PS
(counterpart of ``paddlebox_tpu/ps/service/shard_server.py``).

Topology::

    parent (trainer / drill)                 shard child i
    ────────────────────────                 ──────────────────────────
    ShardService ── spawn + handshake ────►  build its SparsePS slice
      ShardHandle.ctrl  ◄── lifeline ─────►  (resume from its last
    ServiceClient ── pull/push/feed/... ──►   committed base + deltas),
    serving replicas ── pull ─────────────►  listen, serve N client
                                             connections at once

Each child owns a ``SparsePS`` of host ``EmbeddingTable``s, one a table
name, holding only the keys ``shard_of`` routes to it; clients partition
before the wire. Requests are version-stamped pickled tuples of builtins
and numpy arrays over the serving transport's length-prefixed frames
(``serving/transport.py``), so either package's client talks to either
package's shard; a child that dies mid-reply leaves a torn frame, which
the client reads as a dead shard.

The child is a fresh ``python -c`` interpreter (as the data feed's parse
workers are), its spec pickled on its stdin: it imports no torch (its
chain is numpy, the host table and the checkpoint code) and does not
re-import the parent's main module, so it starts in well under a second.
The handshake is bounded by ``ps_service_spawn_timeout`` and fails fast on
a child that exits first; a stop escalates SIGTERM to SIGKILL; a shard
found dead gets a postmortem bundle; and the handshake connection is the
child's lifeline: the child exits on EOF there, so an abandoned parent
leaks no shard servers.

Durability: ``save_base``/``save_delta`` commit through the atomic dir
protocol into ``<root>/<day>/<pass>/{base,delta}`` under the shard's own
root and append to its donefile, so a restarted shard resumes from
``ckpt.discovery.latest_committed``: the base, then every verified delta.
The files are the reference's, so a shard root resumes in either package.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import threading
import time
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Tuple

import numpy as np

from paddlebox_tpu_torch.config import TableConfig, ps_service_conf
from paddlebox_tpu_torch.obs import trace
from paddlebox_tpu_torch.serving import transport
from paddlebox_tpu_torch.utils import faults

if TYPE_CHECKING:
    from paddlebox_tpu_torch.ps.service.client import ServiceClient


class ShardSpawnError(RuntimeError):
    """A shard server child failed to spawn, build or handshake in
    time."""


# =========================================================================
# child side
# =========================================================================

class _ShardState:
    """Child-side state shared by the connection threads."""

    def __init__(self, spec: Dict[str, Any]):
        from paddlebox_tpu_torch.ps.server import SparsePS
        from paddlebox_tpu_torch.ps.table import EmbeddingTable

        self.shard = int(spec["shard"])
        self.num_shards = int(spec["num_shards"])
        self.root: Optional[str] = spec.get("root")
        self.delay_s = float(spec.get("delay_s") or 0.0)
        tables = {name: EmbeddingTable(TableConfig(**conf))
                  for name, conf in spec["tables"].items()}
        self.ps = SparsePS(tables)
        self.resumed: Optional[str] = None
        # lifecycle ops (begin/end pass, save, shrink, feed) serialize;
        # pull and push run concurrently on the tables' own locks
        self.life_lock = threading.Lock()
        # at-most-once retries: the last (seq, reply) of each client id. A
        # client that timed out a request reconnects and re-sends it under
        # the same seq; when the stalled original completed, its reply is
        # replayed instead of applying a push twice
        self.dedup: Dict[str, Tuple[int, Tuple]] = {}
        self.cid_locks: Dict[str, threading.Lock] = {}
        self.dedup_lock = threading.Lock()
        if self.root and spec.get("resume"):
            from paddlebox_tpu_torch.ckpt import discovery
            plan = discovery.latest_committed(self.root)
            if plan is not None:
                discovery.apply_plan(self.ps, plan)
                day, pass_id = discovery.plan_version(plan)
                self.resumed = f"{day}/{pass_id:05d}"

    def _save(self, kind: str, day: str, pass_id: int) -> str:
        if not self.root:
            raise RuntimeError(
                f"shard {self.shard} has no checkpoint root "
                "(spawn the service with root=...)")
        from paddlebox_tpu_torch.trainer import donefile
        with self.life_lock:
            if kind == "base":
                path = self.ps.save_base(self.root, day, pass_id)
            else:
                path = self.ps.save_delta(self.root, day, pass_id)
            donefile.write_done(self.root, day, pass_id, kind, path)
        return path

    def dispatch(self, msg: Tuple) -> Any:
        op = msg[0]
        if op == "pull":
            _op, table, keys, create = msg
            if self.delay_s:
                time.sleep(self.delay_s)   # the drill's slow shard
            return self.ps[table].pull(np.asarray(keys, np.uint64),
                                       create=create)
        if op == "push":
            _op, table, keys, grads = msg
            if self.delay_s:
                time.sleep(self.delay_s)
            keys = np.asarray(keys, np.uint64)
            self.ps[table].push(keys, np.asarray(grads, np.float32))
            return int(keys.size)
        if op == "feed":
            with self.life_lock:
                self.ps.feed_pass({name: np.asarray(k, np.uint64)
                                   for name, k in msg[1].items()})
            return None
        if op == "begin_pass":
            with self.life_lock:
                self.ps.begin_pass(int(msg[1]))
            return None
        if op == "end_pass":
            with self.life_lock:
                self.ps.end_pass()
            return None
        if op == "table_end_pass":
            with self.life_lock:
                self.ps[msg[1]].end_pass()
            return None
        if op == "save_base":
            return self._save("base", str(msg[1]), int(msg[2]))
        if op == "save_delta":
            return self._save("delta", str(msg[1]), int(msg[2]))
        if op == "snapshot":
            return self.ps[msg[1]].snapshot(reset_dirty=False)
        if op == "import":
            _op, table, keys, values, state, mode = msg
            self.ps[table].import_rows(np.asarray(keys, np.uint64),
                                       np.asarray(values, np.float32),
                                       np.asarray(state, np.float32),
                                       mode=mode)
            return None
        if op == "shrink":
            with self.life_lock:
                return self.ps.shrink()
        if op == "stats":
            return {
                "shard": self.shard,
                "num_shards": self.num_shards,
                "pid": os.getpid(),
                "pass": self.ps.current_pass,
                "resumed": self.resumed,
                "num_features": self.ps.num_features(),
                "memory_bytes": self.ps.memory_bytes(),
            }
        if op == "health":
            return {"ok": True, "shard": self.shard, "pid": os.getpid()}
        raise RuntimeError(f"unknown op {op!r}")


def _execute(state: _ShardState, msg: Tuple) -> Tuple:
    """One request to its reply tuple. A ``("req", cid, seq, inner[,
    trace])`` envelope runs under the client's lock with at-most-once
    dedup: a re-sent seq replays the stored reply, and a retry racing the
    stalled original waits on the lock instead of running twice. The
    control path (``ShardHandle``) sends bare idempotent ops."""
    if msg[0] != "req":
        try:
            return ("ok", state.dispatch(msg))
        except Exception as e:  # noqa: BLE001 - crosses the wire
            return ("err", f"{type(e).__name__}: {e}")
    # slot 5, the trace context, is optional: without it this hop is a
    # root span
    cid, seq, inner = msg[1], msg[2], msg[3]
    ctx = trace.from_wire(msg[4]) if len(msg) > 4 else None
    with state.dedup_lock:
        lock = state.cid_locks.setdefault(cid, threading.Lock())
    with lock:
        last = state.dedup.get(cid)
        if last is not None and last[0] == seq:
            return last[1]
        try:
            with trace.activate(ctx), \
                    trace.span("shard.request", op=str(inner[0]),
                               shard=state.shard):
                reply = ("ok", state.dispatch(inner))
        except Exception as e:  # noqa: BLE001 - crosses the wire
            reply = ("err", f"{type(e).__name__}: {e}")
        state.dedup[cid] = (seq, reply)
        return reply


def _serve_conn(state: _ShardState, conn: socket.socket) -> None:
    """One client connection's request loop. An application error fails
    the request (the client re-raises it); only a transport failure ends
    the connection."""
    try:
        while True:
            try:
                msg = transport.recv_obj(conn)
            except (transport.TransportError, OSError):
                return
            if msg is None or msg[0] == "exit":
                return
            reply = _execute(state, msg)
            try:
                transport.send_obj(conn, reply)
            except transport.TornFrame:
                return
            except transport.TransportError as e:
                # a frame-size refusal comes before any byte is sent:
                # answer with an error, since a silent close reads as a
                # dead shard and spends the client's retries on a healthy
                # one
                try:
                    transport.send_obj(conn, (
                        "err", f"TransportError: reply undeliverable "
                               f"({e})"))
                except (transport.TransportError, OSError):
                    return
            except OSError:
                return
    finally:
        try:
            conn.close()
        except OSError:
            pass


def _accept_loop(state: _ShardState, server: socket.socket) -> None:
    while True:
        try:
            conn, _ = server.accept()
        except OSError:
            return                       # the listener closed: shutting down
        # a reply is a header and a payload write: without NODELAY the
        # client waits out Nagle and the delayed ACK on every small reply
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        threading.Thread(target=_serve_conn, args=(state, conn),
                         daemon=True,
                         name=f"ps-shard-{state.shard}-conn").start()


def _shard_main(spec: Dict[str, Any], parent_addr: Tuple[str, int]) -> None:
    """The child's body: flags, its own fault injector, the slice, the
    listener, the ready document, then the lifeline on this thread."""
    for fname, value in (spec.get("flags") or {}).items():
        os.environ["PBOX_FLAGS_" + fname] = str(value)
    trace.maybe_enable()         # an inherited obs_trace_dir: a child dump
    inj = spec.get("fault_injector")
    if inj is not None:
        faults.install_injector(faults.FaultInjector(**inj))
    state = _ShardState(spec)
    server = socket.create_server(("127.0.0.1", 0))
    ctrl = socket.create_connection(tuple(parent_addr), timeout=30.0)
    ctrl.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    transport.send_obj(ctrl, {
        "ready": {
            "port": server.getsockname()[1],
            "pid": os.getpid(),
            "shard": state.shard,
            "tables": sorted(spec["tables"]),
            "resumed": state.resumed,
        },
    })
    ctrl.settimeout(None)
    threading.Thread(target=_accept_loop, args=(state, server),
                     daemon=True, name=f"ps-shard-{state.shard}-accept")\
        .start()
    try:
        # the control connection is the lifeline: served on the main
        # thread, its EOF (the exit op, a dead parent) ends the process,
        # and the daemon client threads with it
        _serve_conn(state, ctrl)
    finally:
        try:
            server.close()
        except OSError:
            pass


def _child_main() -> None:
    """``python -c`` entry of a shard child: (spec, parent address)
    pickled on stdin."""
    spec, parent_addr = pickle.load(sys.stdin.buffer)
    sys.stdin.close()
    _shard_main(spec, parent_addr)


# =========================================================================
# parent side
# =========================================================================

class _ChildProcess:
    """A ``subprocess.Popen`` shard child behind the ``multiprocessing.
    Process`` surface the handle uses (``is_alive``, ``join``,
    ``terminate``, ``kill``, ``exitcode``, ``pid``)."""

    def __init__(self, spec: Dict[str, Any], parent_addr: Tuple[str, int]):
        env = dict(os.environ)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        env["PYTHONPATH"] = os.pathsep.join(
            [pkg_root] + [p for p in sys.path if p]
            + [x for x in [env.get("PYTHONPATH")] if x])
        self._popen = subprocess.Popen(
            [sys.executable, "-c",
             "from paddlebox_tpu_torch.ps.service.shard_server import "
             "_child_main; _child_main()"],
            stdin=subprocess.PIPE, stdout=subprocess.DEVNULL, env=env)
        try:
            pickle.dump((spec, parent_addr), self._popen.stdin,
                        protocol=pickle.HIGHEST_PROTOCOL)
            self._popen.stdin.close()
        except BrokenPipeError:
            pass                         # died at import: the handshake says

    @property
    def pid(self) -> int:
        return self._popen.pid

    @property
    def exitcode(self) -> Optional[int]:
        return self._popen.poll()

    def is_alive(self) -> bool:
        return self._popen.poll() is None

    def join(self, timeout: Optional[float] = None) -> None:
        try:
            self._popen.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass

    def terminate(self) -> None:
        if self.is_alive():
            self._popen.terminate()

    def kill(self) -> None:
        if self.is_alive():
            self._popen.kill()


class ShardHandle:
    """The parent's handle of one shard server child: spawn, bounded
    handshake, control requests, reap."""

    def __init__(self, spec: Dict[str, Any],
                 spawn_timeout: Optional[float] = None):
        self.spec = dict(spec)
        self.shard = int(spec["shard"])
        self._spawn_timeout = (ps_service_conf().spawn_timeout_s
                               if spawn_timeout is None
                               else float(spawn_timeout))
        self._dead = threading.Event()
        self._ctrl_lock = threading.Lock()
        faults.io_point("ps.shard_spawn")
        listener = socket.create_server(("127.0.0.1", 0))
        try:
            self._proc = _ChildProcess(self.spec, listener.getsockname())
            try:
                self._ctrl, ready = self._handshake(listener)
            except BaseException:
                self._reap(force=True)
                raise
        finally:
            listener.close()
        self.child_pid: int = ready["pid"]
        self.port: int = ready["port"]
        self.resumed: Optional[str] = ready.get("resumed")

    def _handshake(self, listener: socket.socket):
        """Accept the child's control connection and ready document within
        the spawn deadline; a child that exits first (a bad spec, a
        raising resume) fails at once with its exit code."""
        deadline = time.monotonic() + self._spawn_timeout
        while True:
            now = time.monotonic()
            if now > deadline:
                raise ShardSpawnError(
                    f"shard {self.shard}: handshake timeout after "
                    f"{self._spawn_timeout:g}s")
            if not self._proc.is_alive():
                raise ShardSpawnError(
                    f"shard {self.shard}: child exited rc="
                    f"{self._proc.exitcode} before handshake")
            listener.settimeout(0.1)
            try:
                conn, _ = listener.accept()
            except socket.timeout:
                continue
            conn.settimeout(max(0.1, deadline - time.monotonic()))
            try:
                hello = transport.recv_obj(conn)
            except (transport.TransportError, OSError) as e:
                conn.close()
                raise ShardSpawnError(
                    f"shard {self.shard}: child died mid-handshake: "
                    f"{e}") from e
            if not isinstance(hello, dict) or "ready" not in hello:
                conn.close()
                raise ShardSpawnError(
                    f"shard {self.shard}: bad hello {hello!r}")
            conn.settimeout(None)
            return conn, hello["ready"]

    @property
    def endpoint(self) -> str:
        return f"127.0.0.1:{self.port}"

    def request(self, msg: Tuple, deadline: Optional[float] = None) -> Any:
        """One control request (health, stats); a transport failure marks
        the shard dead and raises."""
        with self._ctrl_lock:
            if self._dead.is_set():
                raise ShardSpawnError(
                    f"shard {self.shard} child process is dead")
            try:
                self._ctrl.settimeout(deadline)
                transport.send_obj(self._ctrl, msg)
                reply = transport.recv_obj(self._ctrl)
            except (transport.TransportError, OSError) as e:
                self._dead.set()
                raise ShardSpawnError(
                    f"shard {self.shard} child died mid-request: {e}"
                ) from e
        if reply is None:
            self._dead.set()
            raise ShardSpawnError(
                f"shard {self.shard} child closed mid-request")
        status, payload = reply
        if status != "ok":
            raise RuntimeError(f"shard {self.shard}: {payload}")
        return payload

    def alive(self) -> bool:
        return self._proc.is_alive() and not self._dead.is_set()

    def kill(self) -> None:
        """SIGKILL the child: clients find out as in production, from torn
        frames and resets."""
        self._proc.kill()

    def stop(self) -> None:
        self._dead.set()
        with self._ctrl_lock:
            try:
                transport.send_obj(self._ctrl, ("exit",))
            except (transport.TransportError, OSError):
                pass
            try:
                self._ctrl.close()
            except OSError:
                pass
        self._reap(force=True)

    def _reap(self, force: bool) -> Optional[int]:
        self._proc.join(timeout=2.0)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=1.0)
        if force and self._proc.is_alive():
            self._proc.kill()
            self._proc.join(timeout=1.0)
        return self._proc.exitcode


class ShardService:
    """N shard server children and their handles: bring the service up,
    kill shards, restart them onto their last committed state."""

    def __init__(self, table_confs: Dict[str, TableConfig],
                 num_shards: Optional[int] = None,
                 root: Optional[str] = None,
                 flags_for_children: Optional[Dict[str, Any]] = None,
                 spec_overrides: Optional[Dict[int, Dict]] = None,
                 spawn_timeout: Optional[float] = None,
                 registry=None):
        from paddlebox_tpu_torch.obs.metrics import REGISTRY
        conf = ps_service_conf()
        self.num_shards = int(num_shards if num_shards is not None
                              else conf.shards)
        if self.num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, "
                             f"got {self.num_shards}")
        self.root = root
        self.registry = registry if registry is not None else REGISTRY
        self._spawn_timeout = spawn_timeout
        self._table_confs = {name: _conf_dict(c)
                             for name, c in table_confs.items()}
        self._flags = dict(flags_for_children or {})
        self._overrides = {int(k): dict(v)
                           for k, v in (spec_overrides or {}).items()}
        self.handles = self._spawn_all()

    def _spawn_all(self) -> List[ShardHandle]:
        """Spawn the children at once (each pays an interpreter, its table
        build and its resume), each handshaking on its own listener; a
        failure stops the others and re-raises."""
        n = self.num_shards
        if n == 1:
            return [ShardHandle(self._spec(0, resume=False),
                                spawn_timeout=self._spawn_timeout)]
        out: List[Optional[ShardHandle]] = [None] * n
        errs: List[Exception] = []

        def build(i: int) -> None:
            try:
                out[i] = ShardHandle(self._spec(i, resume=False),
                                     spawn_timeout=self._spawn_timeout)
            except Exception as e:  # noqa: BLE001 - re-raised below
                errs.append(e)

        threads = [threading.Thread(target=build, args=(i,),
                                    name=f"ps-spawn-{i}")
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            for h in out:
                if h is not None:
                    h.stop()
            raise errs[0]
        return [h for h in out if h is not None]

    def _spec(self, shard: int, resume: bool) -> Dict[str, Any]:
        child_flags = dict(self._flags or {})
        child_flags.setdefault("obs_role", f"shard{shard}")
        spec: Dict[str, Any] = {
            "shard": shard,
            "num_shards": self.num_shards,
            "tables": self._table_confs,
            "root": (os.path.join(self.root, f"shard-{shard:03d}")
                     if self.root else None),
            "resume": resume,
            "flags": child_flags,
        }
        spec.update(self._overrides.get(shard, {}))
        return spec

    def endpoints(self) -> List[str]:
        return [h.endpoint for h in self.handles]

    def client(self, **kw) -> "ServiceClient":
        from paddlebox_tpu_torch.ps.service.client import ServiceClient
        kw.setdefault("registry", self.registry)
        return ServiceClient(self.endpoints(), **kw)

    def kill(self, shard: int) -> None:
        self.handles[shard].kill()

    def restart(self, shard: int, resume: bool = True) -> str:
        """Respawn a dead shard onto its last committed base and deltas;
        returns the new endpoint (clients ``repoint`` to it). The dead
        child gets a postmortem bundle."""
        old = self.handles[shard]
        exitcode = old._reap(force=True)
        from paddlebox_tpu_torch.obs import postmortem
        postmortem.maybe_dump(
            f"ps.service shard {shard} restarted",
            extra={"shard": shard, "pid": old.child_pid,
                   "exitcode": exitcode, "endpoint": old.endpoint})
        self.handles[shard] = ShardHandle(
            self._spec(shard, resume=resume),
            spawn_timeout=self._spawn_timeout)
        self.registry.add("ps.remote.shard_restarts")
        return self.handles[shard].endpoint

    def stats(self) -> List[Dict]:
        return [h.request(("stats",), deadline=10.0)
                for h in self.handles]

    def stop(self) -> None:
        for h in self.handles:
            h.stop()

    def __enter__(self) -> "ShardService":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def _conf_dict(conf: TableConfig) -> Dict[str, Any]:
    """A table config as builtins: the spec and the wire carry no class
    of either package."""
    return dataclasses.asdict(conf)
