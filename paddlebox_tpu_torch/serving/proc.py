"""Process-scope serving replicas: a fault domain each (counterpart of
``paddlebox_tpu/serving/proc.py``).

:class:`ProcReplica` runs a replica's predictor in its own child process
and keeps the thread-scope surface (``submit``, ``outstanding``,
``alive``, ``health``, ``kill``), so ``ReplicaSet``, ``Router`` and
``ReloadWatcher`` take either scope::

    parent                                   child (spawned)
    DeadlineBatcher -- score_fn --> req  --> recv -> predict -> reply
    (queueing, deadlines, batching)  sock    (its own predictor, built in
    side-reader thread        <-- side sock  the child from the worker
    (health and metric snapshots             spec: a bundle, a checkpoint
     merged into the parent registry)        plan, or a factory)

The child is started by ``multiprocessing.get_context("spawn")``, never
by fork (a forked child cannot use CUDA): it imports the package afresh,
opens its own CUDA context and builds its own predictor, so one card
holds one context and one table a child. The kernels are built before
the fleet spawns (``ops/_build.py`` renames each library into place); a
child loads them and never compiles. Replies are pickled numpy scores:
the parent holds no CUDA handle of a child's, and a killed child's
context and memory go with it.

The worker spec is a picklable dict:

- ``{"bundle": path}``: a ``CTRPredictor`` over the bundle on
  ``"device"`` (default ``cuda``; with no card the child fails its
  spawn, there is no fallback), and with ``"plan": (base, deltas)`` from
  ``ckpt/discovery.py`` over a committed checkpoint
  (``serving/reload.py``);
- ``{"module": m, "qualname": q, "kwargs": {...}, "sys_path": [...]}``:
  the child imports ``m`` and calls the named factory (tests and drills
  build stand-in predictors so);
- ``"flags"``: reference flags set in the child as ``PBOX_FLAGS_*``
  environment variables before the build (the port reads its flags at
  each call, so the parent's own variables reach the child too), and
  ``"fault_injector"``: seeded :class:`~utils.faults.FaultInjector`
  arguments installed as the child's injector.

A child death (SIGKILL, ``os._exit``, a segfault) reaches the parent as
EOF or a torn frame on both sockets: the replica is marked dead at once
(the router reroutes, the batch in flight fails with the retriable
``ReplicaDead``), the child is reaped, a postmortem bundle records it, and
the fleet monitor restarts it under the restart supervisor.

The child reports its kernel launches on the side channel: after each
predict it sets ``serve.launches.seqpool_cvm_cuda`` to its seqpool
wrapper's count, which the parent mirrors as
``serving.replica.<name>.child.serve.launches.seqpool_cvm_cuda``;
``ProcReplica.launch_counts`` reads the counts on the request channel and
can set them to 0 before a counted run. Its ready document carries the spawn's split: when the child's main ran, the
seconds its CUDA context took, and the predictor's build.

The timeouts are the ``serve_spawn_timeout`` and
``serve_heartbeat_timeout`` flags (``PBOX_FLAGS_*``).
"""

from __future__ import annotations

import importlib
import json
import multiprocessing
import os
import signal
import socket
import sys
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from paddlebox_tpu_torch.config import DataFeedConfig, flag
from paddlebox_tpu_torch.obs import postmortem, trace
from paddlebox_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from paddlebox_tpu_torch.serving import transport
from paddlebox_tpu_torch.serving.batcher import (DeadlineBatcher, ReplicaDead,
                                                 ServingError)
from paddlebox_tpu_torch.utils import faults

#: the serving path's kernel wrappers whose launch counts a child reports:
#: (module, wrapper)
_COUNTED = (("paddlebox_tpu_torch.ops.seqpool_kernel", "seqpool_cvm_cuda"),)


class SpawnError(ServingError):
    """A replica child failed to spawn, build or handshake in time."""


# =========================================================================
# child side
# =========================================================================

def _env_value(value: Any) -> str:
    if isinstance(value, bool):
        return "1" if value else "0"
    return str(value)


def _open_context(spec: Dict[str, Any]) -> float:
    """Open the child's CUDA context ahead of the build, for a bundle or
    plan spec on the card; the seconds it took (0 on the CPU or for a
    factory spec)."""
    if "module" in spec and spec.get("plan") is None:
        return 0.0
    from paddlebox_tpu_torch._device import resolve_device
    dev = resolve_device(spec.get("device"))
    if dev.type != "cuda":
        return 0.0
    import torch
    t0 = time.perf_counter()
    torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def _build_predictor(spec: Dict[str, Any]):
    """The child's predictor from the worker spec (in the child; a raise
    exits it before the handshake, the crash-loop signature the supervisor
    contains)."""
    if spec.get("plan") is not None:
        # first: a retargeted spec keeps its factory, but a restart after
        # a rollout must rebuild on the plan
        from paddlebox_tpu_torch.serving.reload import \
            load_predictor_from_plan
        return load_predictor_from_plan(
            spec["bundle"], tuple(spec["plan"]),
            ps_endpoints=spec.get("ps_endpoints"),
            ps_table=spec.get("ps_table"), device=spec.get("device"))
    if "module" in spec:
        for p in spec.get("sys_path") or []:
            if p not in sys.path:
                sys.path.insert(0, p)
        factory = importlib.import_module(spec["module"])
        for part in spec["qualname"].split("."):
            factory = getattr(factory, part)
        return factory(**(spec.get("kwargs") or {}))
    from paddlebox_tpu_torch.inference.predictor import CTRPredictor
    return CTRPredictor(spec["bundle"], device=spec.get("device"),
                        batch_size=spec.get("batch_size"),
                        ps_endpoints=spec.get("ps_endpoints"),
                        ps_table=spec.get("ps_table", "embedding"))


def _counted_wrappers():
    """(name, wrapper) of each counted kernel wrapper this child imported."""
    for mod_name, fn_name in _COUNTED:
        mod = sys.modules.get(mod_name)
        if mod is not None:
            yield fn_name, getattr(mod, fn_name)


def _mirror_launches() -> None:
    """The kernel wrappers' launch counts (of those this child imported)
    as ``serve.launches.<wrapper>`` gauges."""
    for fn_name, fn in _counted_wrappers():
        REGISTRY.gauge(f"serve.launches.{fn_name}").set(fn.launches)


def read_launches(reset: bool) -> Dict[str, int]:
    """This process's counted wrappers' launches as read now; ``reset``
    then sets them (and their mirrored gauges) to 0."""
    counts = {n: fn.launches for n, fn in _counted_wrappers()}
    if reset:
        for _n, fn in _counted_wrappers():
            fn.launches = 0
        _mirror_launches()
    return counts


class _WorkerState:
    """What the child's request loop and side thread share."""

    def __init__(self, predictor):
        self.lock = threading.Lock()
        self.predictor = predictor
        self.stop = threading.Event()
        self.reload_gen = 0          # guarded-by: lock
        self.reloading = False       # guarded-by: lock
        self.reload_error: Optional[str] = None   # guarded-by: lock

    def snapshot(self) -> Dict[str, Any]:
        with self.lock:
            pred = self.predictor
            gen, err = self.reload_gen, self.reload_error
        return {
            "model_version": getattr(pred, "model_version", None),
            "pid": os.getpid(),
            "reload_gen": gen,
            "reload_error": err,
            "metrics": REGISTRY.snapshot(prefix="serve"),
        }


def _side_loop(state: _WorkerState, side: socket.socket,
               interval: float) -> None:
    while not state.stop.wait(interval):
        try:
            faults.io_point("serve.side_write")
        except OSError:
            # health skips a beat, the replica keeps serving
            REGISTRY.add("serve.side_write_failures")
            continue
        try:
            transport.send_obj(side, state.snapshot())
        except Exception:
            return                   # the parent is gone


def _reload_build(state: _WorkerState, bundle_path: str, plan) -> None:
    """The child's background rebuild: the request loop serves the old
    predictor meanwhile, then the swap lands between dispatches; the
    outcome reaches the parent on the side channel."""
    from paddlebox_tpu_torch.serving.reload import load_predictor_from_plan
    try:
        with state.lock:
            old = state.predictor
        new = load_predictor_from_plan(bundle_path, tuple(plan),
                                       reload_of=old)
        with state.lock:
            state.predictor = new
            state.reloading = False
    except Exception as e:
        with state.lock:
            state.reload_error = f"{type(e).__name__}: {e}"
            state.reloading = False


def _send_reply(req: socket.socket, reply: Any) -> None:
    """Send a reply; a reply too large for a frame (refused before any
    byte goes out) becomes an error reply on the still-framed connection.
    A torn frame or a socket error propagates: that connection is gone."""
    try:
        transport.send_obj(req, reply)
    except transport.TornFrame:
        raise
    except transport.TransportError as e:
        transport.send_obj(
            req, ("err", f"TransportError: reply undeliverable ({e})"))


def _serve_requests(state: _WorkerState, req: socket.socket) -> None:
    while True:
        msg = transport.recv_obj(req)
        if msg is None:
            return                   # the parent closed: clean exit
        op = msg[0]
        if op == "predict":
            t0 = time.perf_counter()
            # the trace context rides as an optional third element
            ctx = trace.from_wire(msg[2]) if len(msg) > 2 else None
            try:
                with state.lock:
                    pred = state.predictor
                with trace.activate(ctx), \
                        trace.span("replica.predict", rows=len(msg[1])):
                    scores = np.asarray(pred.predict_records(msg[1]))
                reply = ("ok", scores)
                REGISTRY.observe("serve.predict_ms",
                                 (time.perf_counter() - t0) * 1e3)
                _mirror_launches()
            except Exception as e:   # a bad batch does not kill the child
                reply = ("err", f"{type(e).__name__}: {e}")
            _send_reply(req, reply)
        elif op == "reload":
            # acknowledged at once; the build runs on its own thread so
            # requests keep flowing meanwhile
            with state.lock:
                busy = state.reloading
                if not busy:
                    state.reloading = True
                    state.reload_error = None
                    state.reload_gen += 1
                    gen = state.reload_gen
            if busy:
                reply = ("err", "reload already in progress")
            else:
                threading.Thread(
                    target=_reload_build, args=(state, msg[1], msg[2]),
                    daemon=True, name="serve-reload-build").start()
                reply = ("ok", gen)
            _send_reply(req, reply)
        elif op == "launches":
            _send_reply(req, ("ok", read_launches(bool(msg[1]))))
        elif op == "crash":
            # drill hooks: die exactly as the failure drilled
            if msg[1] == "segv":
                signal.raise_signal(signal.SIGSEGV)
            os._exit(13)
        elif op == "exit":
            return                   # no reply: the parent is closing
        else:
            _send_reply(req, ("err", f"unknown op {op!r}"))


def _worker_main(spec: Dict[str, Any], addr: Tuple[str, int],
                 name: str) -> None:
    """The child's entry point (the ``multiprocessing`` spawn target)."""
    main_at = time.time()
    for fname, value in (spec.get("flags") or {}).items():
        os.environ["PBOX_FLAGS_" + fname] = _env_value(value)
    trace.maybe_enable()         # obs_trace_dir: a dump here at exit
    inj = spec.get("fault_injector")
    if inj is not None:
        faults.install_injector(faults.FaultInjector(**inj))
    context_s = _open_context(spec)
    t0 = time.perf_counter()
    predictor = _build_predictor(spec)
    build_s = time.perf_counter() - t0
    req = socket.create_connection(addr, timeout=30.0)
    transport.send_obj(req, {"role": "req"})
    side = socket.create_connection(addr, timeout=30.0)
    state = _WorkerState(predictor)
    transport.send_obj(side, {
        "role": "side",
        "ready": {
            "feed": predictor.feed_conf.to_json(),
            "model_version": getattr(predictor, "model_version", None),
            "pid": os.getpid(),
            "timing": {"main_at": main_at, "context_s": context_s,
                       "build_s": build_s},
        },
    })
    req.settimeout(None)
    side.settimeout(None)
    th = threading.Thread(
        target=_side_loop,
        args=(state, side, float(spec.get("side_interval", 0.2))),
        daemon=True, name="serve-side")
    th.start()
    try:
        _serve_requests(state, req)
    except (transport.TransportError, OSError):
        pass                         # the parent vanished
    finally:
        state.stop.set()


# =========================================================================
# parent side
# =========================================================================

class ProcReplica:
    """The parent's handle of one replica child, with the thread-scope
    ``Replica``'s surface; the predictor lives in the child."""

    scope = "process"
    _death_counted = False           # the fleet monitor's one count a death

    def __init__(self, name: str, spec: Dict[str, Any],
                 max_pending: Optional[int] = None,
                 margin_ms: Optional[float] = None,
                 registry: MetricsRegistry = REGISTRY,
                 spawn_timeout: Optional[float] = None,
                 heartbeat_timeout: Optional[float] = None):
        self.name = name
        self.spec = dict(spec)
        # the child's role in its telemetry nests under the parent's
        child_flags = dict(self.spec.get("flags") or {})
        if not child_flags.get("obs_role"):
            parent_role = str(flag("obs_role") or "")
            child_flags["obs_role"] = (f"{parent_role}.{name}"
                                       if parent_role else name)
        self.spec["flags"] = child_flags
        self.registry = registry
        self._spawn_timeout = (float(flag("serve_spawn_timeout"))
                               if spawn_timeout is None
                               else float(spawn_timeout))
        self._hb_timeout = (float(flag("serve_heartbeat_timeout"))
                            if heartbeat_timeout is None
                            else float(heartbeat_timeout))
        self._last_side_at: Optional[float] = None
        self._dead = threading.Event()
        self._stopping = threading.Event()
        self._exit_lock = threading.Lock()
        self._exit_reported = False  # guarded-by: _exit_lock
        self._reap_lock = threading.Lock()
        self._rpc_lock = threading.Lock()
        self._last_health: Optional[Dict] = None
        self._t_start: Optional[float] = None
        faults.io_point("serve.spawn")
        # the child unpickles this module: the package root must be on
        # its path (it inherits the parent's)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        if pkg_root not in sys.path:
            sys.path.insert(0, pkg_root)
        listener = socket.create_server(("127.0.0.1", 0))
        t_spawn = time.time()
        t0 = time.perf_counter()
        try:
            ctx = multiprocessing.get_context("spawn")
            self._proc = ctx.Process(
                target=_worker_main,
                args=(self.spec, listener.getsockname(), name),
                daemon=True, name=f"serve-proc-{name}")
            self._proc.start()
            try:
                self._req, self._side, ready = self._handshake(listener)
            except BaseException:
                self._reap(force=True)
                raise
        finally:
            listener.close()
        total_s = time.perf_counter() - t0
        self.feed_conf = DataFeedConfig.from_dict(json.loads(ready["feed"]))
        self._model_version: Optional[str] = ready.get("model_version")
        self.child_pid: int = ready["pid"]
        timing = ready.get("timing") or {}
        start_s = max(0.0, float(timing.get("main_at", t_spawn)) - t_spawn)
        context_s = float(timing.get("context_s", 0.0))
        build_s = float(timing.get("build_s", 0.0))
        #: the spawn's seconds: interpreter start and imports up to the
        #: child's main, its CUDA context, its predictor's build, and the
        #: rest (connections, handshake)
        self.spawn_timing = {
            "total_s": total_s, "start_s": start_s, "context_s": context_s,
            "build_s": build_s,
            "handshake_s": max(0.0, total_s - start_s - context_s
                               - build_s)}
        self.batcher = DeadlineBatcher(
            self._score, max_batch=self.feed_conf.batch_size,
            margin_ms=margin_ms, max_pending=max_pending, name=name,
            registry=registry)
        self._side_thread = threading.Thread(
            target=self._side_reader, daemon=True,
            name=f"serve-side-{name}")

    # -- spawn / handshake ---------------------------------------------------

    def _handshake(self, listener: socket.socket):
        """Accept the child's request and side connections and its ready
        document within the spawn deadline; a child that exits first
        fails at once with its exit code."""
        deadline = time.monotonic() + self._spawn_timeout
        conns: Dict[str, Tuple[socket.socket, Dict]] = {}
        died_at: Optional[float] = None
        try:
            while len(conns) < 2:
                now = time.monotonic()
                if now > deadline:
                    raise SpawnError(
                        f"replica {self.name}: handshake timeout after "
                        f"{self._spawn_timeout:g}s")
                if not self._proc.is_alive():
                    # a short grace for a connection already in the backlog
                    if died_at is None:
                        died_at = now
                    elif now - died_at > 2.0 or not conns:
                        raise SpawnError(
                            f"replica {self.name}: child exited rc="
                            f"{self._proc.exitcode} before handshake "
                            f"(crash-looping bundle?)")
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
                    raise SpawnError(
                        f"replica {self.name}: child died mid-"
                        f"handshake: {e}") from e
                if not isinstance(hello, dict) or "role" not in hello:
                    conn.close()
                    raise SpawnError(
                        f"replica {self.name}: bad hello {hello!r}")
                conns[hello["role"]] = (conn, hello)
        except BaseException:
            for conn, _ in conns.values():
                conn.close()
            raise
        req = conns["req"][0]
        side, side_hello = conns["side"]
        req.settimeout(None)
        side.settimeout(None)
        return req, side, side_hello["ready"]

    # -- model ---------------------------------------------------------------

    @property
    def model_version(self) -> Optional[str]:
        return self._model_version

    def reload_from_plan(self, bundle_path: str, plan) -> None:
        """The hot-reload point: the child rebuilds its predictor from the
        committed plan on its own thread (serving the old one meanwhile)
        and swaps it between dispatches. Blocks until the new version
        shows on the side channel, the child reports a build error, or the
        spawn deadline passes."""
        from paddlebox_tpu_torch.ckpt import discovery
        plan = tuple(plan)
        day, pass_id = discovery.plan_version(plan)
        target = f"{day}/{pass_id:05d}"
        gen = self._rpc(("reload", bundle_path, plan))
        deadline = time.monotonic() + self._spawn_timeout
        while True:
            if self._model_version == target:
                return
            if not self.alive():
                raise ReplicaDead(f"replica {self.name} died mid-reload")
            health = self._last_health or {}
            # this attempt's error only, not an earlier attempt's
            if (health.get("reload_gen") == gen
                    and health.get("reload_error")):
                raise ServingError(
                    f"replica {self.name} child reload: "
                    f"{health['reload_error']}")
            if time.monotonic() > deadline:
                raise ServingError(
                    f"replica {self.name}: reload to {target} not "
                    f"confirmed within {self._spawn_timeout:g}s")
            time.sleep(0.02)

    # -- request path --------------------------------------------------------

    def _rpc(self, msg) -> Any:
        """One exchange on the request channel. A transport failure means
        the fault domain died: mark the replica dead and raise the
        retriable ``ReplicaDead``."""
        with self._rpc_lock:
            if self._dead.is_set():
                raise ReplicaDead(
                    f"replica {self.name} child process is dead")
            try:
                transport.send_obj(self._req, msg)
                reply = transport.recv_obj(self._req)
            except (transport.TransportError, OSError) as e:
                self._mark_dead(f"request channel: {e}")
                raise ReplicaDead(
                    f"replica {self.name} child died mid-request") from e
            if reply is None:
                self._mark_dead("request channel EOF")
                raise ReplicaDead(
                    f"replica {self.name} child closed mid-request")
        status, payload = reply
        if status != "ok":
            # the child's scoring error fails this batch, not the child
            raise RuntimeError(
                f"replica {self.name} child scorer: {payload}")
        return payload

    def _score(self, records):
        t0 = time.perf_counter()
        ctx = trace.current()
        if ctx is not None:
            msg = ("predict", records, ctx.child().to_wire())
        else:
            msg = ("predict", records)
        with trace.span("replica.dispatch", replica=self.name):
            scores = self._rpc(msg)
        self.registry.observe(f"serving.replica.{self.name}.dispatch_ms",
                              (time.perf_counter() - t0) * 1e3)
        return scores

    def submit(self, records, deadline: float):
        return self.batcher.submit(records, deadline)

    def outstanding(self) -> int:
        return self.batcher.outstanding()

    # -- death detection -----------------------------------------------------

    def _mark_dead(self, reason: str) -> bool:
        """Idempotent: the first caller (an rpc failure, the side
        channel's EOF, a heartbeat expiry) retires the batcher and counts
        the death, and only it returns True. The reap and the postmortem
        dump run on a thread of their own: the caller is a routed request
        or the scoring worker, neither of which may wait on them."""
        with self._exit_lock:
            if self._exit_reported or self._dead.is_set():
                return False
            self._exit_reported = True
        self._dead.set()
        self.batcher.retire()
        try:
            # wakes an rpc blocked in recv on a wedged, open socket
            self._req.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.registry.add("serving.proc_child_deaths")
        threading.Thread(target=self._finish_death, args=(reason,),
                         daemon=True,
                         name=f"serve-reap-{self.name}").start()
        return True

    def _finish_death(self, reason: str) -> None:
        # forced: a wedged child ignores SIGTERM
        exitcode = self._reap(force=True)
        self.registry.gauge(
            f"serving.replica.{self.name}.child_exitcode").set(
                float(exitcode) if exitcode is not None else -1.0)
        if not self._stopping.is_set():
            postmortem.maybe_dump(
                f"serving.proc replica {self.name} child died",
                extra={"replica": self.name, "pid": getattr(
                    self, "child_pid", None),
                    "exitcode": exitcode, "reason": reason,
                    "last_health": self._last_health})

    def _reap(self, force: bool) -> Optional[int]:
        # serialized: stop() and _finish_death may overlap
        with self._reap_lock:
            self._proc.join(timeout=2.0)
            if self._proc.is_alive():
                self._proc.terminate()
                self._proc.join(timeout=1.0)
            if force and self._proc.is_alive():
                self._proc.kill()
                self._proc.join(timeout=1.0)
            return self._proc.exitcode

    def _side_reader(self) -> None:
        """Merge the child's snapshots into the parent registry; EOF here
        detects an idle child's death without traffic."""
        while True:
            try:
                msg = transport.recv_obj(self._side)
            except (transport.TransportError, OSError):
                msg = None
            if msg is None:
                if not self._stopping.is_set():
                    self._mark_dead("side channel closed")
                return
            self._last_side_at = time.monotonic()
            self._last_health = msg          # published whole
            version = msg.get("model_version")
            if version:
                self._model_version = version
            for key, value in (msg.get("metrics") or {}).items():
                try:
                    self.registry.gauge(
                        f"serving.replica.{self.name}.child.{key}"
                    ).set(float(value))
                except (TypeError, ValueError):
                    continue

    # -- lifecycle / health --------------------------------------------------

    def start(self) -> None:
        self._t_start = time.monotonic()
        self._last_side_at = time.monotonic()
        self.batcher.start()
        self._side_thread.start()

    def stop(self, drain_timeout: Optional[float] = None) -> None:
        self._stopping.set()
        self.batcher.stop(drain_timeout=drain_timeout)
        # a worker wedged in recv (a stopped or deadlocked child) still
        # holds _rpc_lock: wake it before waiting on the lock
        if not self._rpc_lock.acquire(timeout=1.0):
            try:
                self._req.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._rpc_lock.acquire()
        try:
            if not self._dead.is_set():
                try:
                    transport.send_obj(self._req, ("exit",))
                except (transport.TransportError, OSError):
                    pass
            self._dead.set()
            try:
                self._req.close()
            except OSError:
                pass
        finally:
            self._rpc_lock.release()
        try:
            self._side.close()
        except OSError:
            pass
        if self._side_thread.is_alive():
            self._side_thread.join(timeout=2.0)
        self._reap(force=True)

    def launch_counts(self, reset: bool = False) -> Dict[str, int]:
        """The child's kernel wrappers' launch counts, read on the request
        channel; ``reset`` sets them (and their mirrored gauges) to 0
        after the read."""
        return self._rpc(("launches", bool(reset)))

    def kill(self) -> None:
        """Drill hook, a real one: SIGKILL the child. The parent finds out
        as in production (the sockets reach EOF)."""
        self._proc.kill()

    def crash(self, mode: str = "exit") -> None:
        """Drill hook: the child kills itself (``os._exit``, or a raised
        SIGSEGV with ``mode="segv"``)."""
        with self._rpc_lock:
            if self._dead.is_set():
                return
            try:
                transport.send_obj(self._req, ("crash", mode))
            except (transport.TransportError, OSError):
                pass

    def _heartbeat_age(self) -> Optional[float]:
        t = self._last_side_at
        return None if t is None else time.monotonic() - t

    def alive(self) -> bool:
        if not self.batcher.alive() or self._dead.is_set():
            return False
        age = self._heartbeat_age()
        if self._hb_timeout > 0 and age is not None \
                and age > self._hb_timeout:
            # a wedged but living child: neither socket reaches EOF
            if self._mark_dead(
                    f"no heartbeat for {age:.1f}s "
                    f"(> serve_heartbeat_timeout={self._hb_timeout:g}s)"):
                self.registry.add("serving.proc_heartbeat_timeouts")
            return False
        return True

    def health(self) -> Tuple[bool, Dict]:
        ok = self.alive()
        age = self._heartbeat_age()
        return ok, {
            "name": self.name,
            "alive": ok,
            "scope": self.scope,
            "outstanding": self.outstanding(),
            "model_version": self.model_version,
            "child_pid": self.child_pid,
            "child_alive": self._proc.is_alive(),
            "heartbeat_age_s": round(age, 3) if age is not None else None,
            "uptime_s": round(time.monotonic() - self._t_start, 3)
            if self._t_start is not None else 0.0,
        }
