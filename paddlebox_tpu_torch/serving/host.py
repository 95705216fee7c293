"""The serving host: one spawned process group, one fault domain
(counterpart of ``paddlebox_tpu/serving/host.py``).

A :class:`ServingHost` child carries a whole serving stack: a
:class:`~serving.frontdoor.FrontDoor`, a thread- or process-scope
:class:`~serving.fleet.ReplicaSet` behind it, and the fleet's ``/metrics``
endpoint, in a process group of its own (``os.setpgrp()``), so a SIGKILL
of the group takes the front door and every replica child at once, as the
loss of a machine would. On the card each host holds its own CUDA context
(thread scope) or its children hold theirs (process scope).

Parent and child meet as the process replicas do: spawn, a bounded
handshake over a control socket, whose ready document carries the front
door's port, the pid, the pgid and the metrics address; then the control
connection is the child's lifeline, served on its main thread (ops
``health``, ``drain``, ``launches``, ``exit``): EOF from the parent ends
the child, so a host never outlives its supervisor, and its replica
children follow through their own lifelines.

:class:`HostFleet` supervises N hosts: it spawns them at once, publishes
the live endpoints through the resolver file (``resolver.write_endpoints``,
a new generation at each change, never an empty set), and its monitor
probes each host: a death is counted in a
:class:`~serving.supervisor.RestartSupervisor`, the shrunken set is
republished at once, and the host restarts while the budget holds or its
slot is quarantined. ``decommission`` is the planned path: unpublish,
grace for clients to adopt the new generation, drain, stop.

The ``launches`` op is the port's: the host's seqpool launch counts (its
own wrappers' in thread scope, its children's in process scope), read and
optionally set to 0. A thread-scope replica mirrors them as
``serve.launches.<wrapper>`` gauges after each batch, so the host's
``/metrics`` carries them, as a process child's side channel does.

Flags (``PBOX_FLAGS_*``): ``serve_hosts``, ``serve_probe_interval``,
``serve_spawn_timeout``, ``serve_drain_timeout``,
``serve_lb_eject_reset``; a spec's ``flags`` become the child's
variables. Fault point: ``serve.host_spawn`` (``utils/faults.py``).
"""

from __future__ import annotations

import multiprocessing
import os
import signal
import socket
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from paddlebox_tpu_torch.config import flag
from paddlebox_tpu_torch.obs import trace
from paddlebox_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from paddlebox_tpu_torch.serving import transport
from paddlebox_tpu_torch.serving.resolver import write_endpoints
from paddlebox_tpu_torch.serving.supervisor import RestartSupervisor
from paddlebox_tpu_torch.utils import faults


class HostSpawnError(RuntimeError):
    """A serving-host child failed to spawn, handshake or answer."""


# =========================================================================
# child side
# =========================================================================

def _build_fleet(spec: Dict[str, Any]):
    """The child's ReplicaSet from the host spec (in the child; a raise
    exits it before the handshake, the crash-loop signature the parent's
    supervisor contains)."""
    from paddlebox_tpu_torch.serving.fleet import ReplicaSet
    from paddlebox_tpu_torch.serving.proc import _build_predictor
    scope = str(spec.get("scope") or flag("serve_replica_scope"))
    common = dict(replicas=spec.get("replicas"),
                  max_pending=spec.get("max_pending"),
                  probe_interval=spec.get("probe_interval"))
    worker_spec = spec["worker_spec"]
    if scope == "process":
        return ReplicaSet(None, scope="process", worker_spec=worker_spec,
                          **common)
    return ReplicaSet(lambda: _build_predictor(worker_spec), scope="thread",
                      **common)


def _launch_counts(fleet, reset: bool) -> Dict[str, int]:
    """The host's kernel launch counts (its children's summed in process
    scope); ``reset`` sets them to 0 after the read."""
    from paddlebox_tpu_torch.serving.proc import read_launches
    if fleet.scope != "process":
        return read_launches(reset)
    counts: Dict[str, int] = {}
    for r in fleet.replicas:
        for name, n in r.launch_counts(reset=reset).items():
            counts[name] = counts.get(name, 0) + int(n)
    return counts


def _host_main(spec: Dict[str, Any], parent_addr: Tuple[str, int]) -> None:
    """The child's entry point (the ``multiprocessing`` spawn target)."""
    # its own group first: killpg must take the front door and the replica
    # children spawned below, never the parent
    os.setpgrp()
    from paddlebox_tpu_torch.serving.proc import _env_value
    for fname, value in (spec.get("flags") or {}).items():
        os.environ["PBOX_FLAGS_" + fname] = _env_value(value)
    trace.maybe_enable()
    inj = spec.get("fault_injector")
    if inj is not None:
        faults.install_injector(faults.FaultInjector(**inj))
    from paddlebox_tpu_torch.serving.frontdoor import FrontDoor
    fleet = _build_fleet(spec)
    fleet.start(metrics_port=0 if spec.get("metrics", True) else None)
    door = FrontDoor(fleet, port=int(spec.get("port", 0)))
    door.start()
    ctrl = socket.create_connection(parent_addr, timeout=30.0)
    ctrl.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    transport.send_obj(ctrl, {"ready": {
        "port": door.port,
        "pid": os.getpid(),
        "pgid": os.getpgrp(),
        "name": spec.get("name", "host"),
        "metrics": list(fleet.metrics_address)
        if fleet.metrics_address else None,
    }})
    ctrl.settimeout(None)
    stopped = False

    def shutdown(drain_timeout: Optional[float]) -> None:
        nonlocal stopped
        if not stopped:
            stopped = True
            door.stop()
            fleet.stop(drain_timeout=drain_timeout)

    try:
        # the lifeline: EOF (an exit op, a dead parent) ends the process
        while True:
            try:
                msg = transport.recv_obj(ctrl)
            except (transport.TransportError, OSError):
                return
            if msg is None or msg[0] == "exit":
                return
            try:
                if msg[0] == "health":
                    ok, doc = fleet.health()
                    reply = ("ok", {"ok": ok, "healthy": doc["healthy"],
                                    "size": doc["size"],
                                    "versions": doc["versions"],
                                    "quarantined": doc["quarantined"]})
                elif msg[0] == "drain":
                    shutdown(None if msg[1] is None else float(msg[1]))
                    reply = ("ok", "drained")
                elif msg[0] == "launches":
                    reply = ("ok", _launch_counts(fleet, bool(msg[1])))
                else:
                    reply = ("err", f"unknown op {msg[0]!r}")
            except Exception as e:  # noqa: BLE001 - crosses the wire
                reply = ("err", f"{type(e).__name__}: {e}")
            try:
                transport.send_obj(ctrl, reply)
            except (transport.TransportError, OSError):
                return
            if msg[0] == "drain":
                return
    finally:
        shutdown(None if stopped else 0.0)


# =========================================================================
# parent side
# =========================================================================

class ServingHost:
    """The parent's handle of one host child: spawn, bounded handshake,
    control requests, group kill, reap."""

    def __init__(self, name: str, spec: Dict[str, Any],
                 spawn_timeout: Optional[float] = None,
                 registry: MetricsRegistry = REGISTRY):
        self.name = name
        self.spec = dict(spec)
        self.spec["name"] = name
        # the child's telemetry names it; its replicas nest under it
        child_flags = dict(self.spec.get("flags") or {})
        if not child_flags.get("obs_role"):
            child_flags["obs_role"] = name
        self.spec["flags"] = child_flags
        self.registry = registry
        self._spawn_timeout = float(flag("serve_spawn_timeout")
                                    if spawn_timeout is None
                                    else spawn_timeout)
        self._dead = threading.Event()
        self._ctrl_lock = threading.Lock()
        self.draining = False
        self._death_counted = False    # guarded-by: HostFleet._lock
        faults.io_point("serve.host_spawn")
        # the child unpickles this module: the package root on its path
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        if pkg_root not in sys.path:
            sys.path.insert(0, pkg_root)
        listener = socket.create_server(("127.0.0.1", 0))
        t0 = time.perf_counter()
        try:
            ctx = multiprocessing.get_context("spawn")
            # not a daemon: a daemonic process may have no children, and a
            # host's replicas are its children; the lifeline ends it instead
            self._proc = ctx.Process(
                target=_host_main,
                args=(self.spec, listener.getsockname()),
                daemon=False, name=f"serve-host-{name}")
            self._proc.start()
            try:
                self._ctrl, ready = self._handshake(listener)
            except BaseException:
                self._reap()
                raise
        finally:
            listener.close()
        #: seconds from the spawn to the ready document
        self.spawn_s = time.perf_counter() - t0
        self.child_pid: int = ready["pid"]
        self.pgid: int = ready["pgid"]
        self.port: int = ready["port"]
        self.metrics: Optional[Tuple[str, int]] = (
            tuple(ready["metrics"]) if ready.get("metrics") else None)

    def _handshake(self, listener: socket.socket):
        deadline = time.monotonic() + self._spawn_timeout
        listener.settimeout(0.1)
        while True:
            if time.monotonic() > deadline:
                raise HostSpawnError(
                    f"host {self.name}: handshake timeout after "
                    f"{self._spawn_timeout:g}s")
            if not self._proc.is_alive():
                raise HostSpawnError(
                    f"host {self.name}: child exited rc="
                    f"{self._proc.exitcode} before handshake")
            try:
                conn, _ = listener.accept()
            except socket.timeout:
                continue
            conn.settimeout(max(0.1, deadline - time.monotonic()))
            try:
                hello = transport.recv_obj(conn)
            except (transport.TransportError, OSError) as e:
                conn.close()
                raise HostSpawnError(
                    f"host {self.name}: child died mid-handshake: {e}"
                ) from e
            if not isinstance(hello, dict) or "ready" not in hello:
                conn.close()
                raise HostSpawnError(f"host {self.name}: bad hello "
                                     f"{hello!r}")
            conn.settimeout(None)
            return conn, hello["ready"]

    # -- control channel -----------------------------------------------------

    @property
    def endpoint(self) -> str:
        return f"127.0.0.1:{self.port}"

    def request(self, msg: Tuple, deadline: Optional[float] = None) -> Any:
        with self._ctrl_lock:
            if self._dead.is_set():
                raise HostSpawnError(f"host {self.name} child process is "
                                     "dead")
            try:
                self._ctrl.settimeout(deadline)
                transport.send_obj(self._ctrl, msg)
                reply = transport.recv_obj(self._ctrl)
            except (transport.TransportError, OSError) as e:
                self._dead.set()
                raise HostSpawnError(
                    f"host {self.name} child died mid-request: {e}") from e
        if reply is None:
            self._dead.set()
            raise HostSpawnError(f"host {self.name} child closed "
                                 "mid-request")
        status, payload = reply
        if status != "ok":
            raise RuntimeError(f"host {self.name}: {payload}")
        return payload

    def health(self, deadline: float = 5.0) -> Dict:
        return self.request(("health",), deadline=deadline)

    def launch_counts(self, reset: bool = False) -> Dict[str, int]:
        """The host's kernel launch counts; ``reset`` sets them to 0 after
        the read."""
        return self.request(("launches", bool(reset)), deadline=30.0)

    # -- lifecycle -----------------------------------------------------------

    def alive(self) -> bool:
        return self._proc.is_alive() and not self._dead.is_set()

    def kill_group(self) -> None:
        """Drill hook, a real one: SIGKILL the whole process group (front
        door and every replica child), as a dead machine looks."""
        try:
            os.killpg(self.pgid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            self._proc.kill()

    def drain(self, timeout: Optional[float] = None) -> None:
        """Finish queued work, then stop (the planned restart): the child
        replies once its front door is closed and its fleet drained, then
        exits."""
        self.draining = True
        t = float(flag("serve_drain_timeout") if timeout is None
                  else timeout)
        self.request(("drain", t), deadline=t + 10.0)

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
        self._reap()
        # a killed or wedged child may leave replica children in its group
        try:
            os.killpg(self.pgid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass

    def _reap(self) -> Optional[int]:
        self._proc.join(timeout=5.0)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=2.0)
        if self._proc.is_alive():
            self._proc.kill()
            self._proc.join(timeout=2.0)
        return self._proc.exitcode


class HostFleet:
    """N serving hosts, their resolver publication and the host monitor."""

    def __init__(self, host_spec: Dict[str, Any],
                 hosts: Optional[int] = None,
                 resolver_path: Optional[str] = None,
                 supervisor: Optional[RestartSupervisor] = None,
                 probe_interval: Optional[float] = None,
                 spawn_timeout: Optional[float] = None,
                 registry: MetricsRegistry = REGISTRY):
        n = int(flag("serve_hosts") if hosts is None else hosts)
        if n < 1:
            raise ValueError(f"need at least one host, got {n}")
        self.host_spec = dict(host_spec)
        self.resolver_path = resolver_path
        self.registry = registry
        self.supervisor = supervisor if supervisor is not None \
            else RestartSupervisor(
                circuit_reset=float(flag("serve_lb_eject_reset")),
                registry=registry)
        self._spawn_timeout = spawn_timeout
        self._probe_s = float(flag("serve_probe_interval")
                              if probe_interval is None else probe_interval)
        self._lock = threading.Lock()
        self._generation = 0                  # guarded-by: _lock
        self._next_id = n                     # guarded-by: _lock
        self._decommissioned: set = set()     # guarded-by: _lock
        self._closed = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        # spawned at once: each host pays an interpreter, its imports and
        # its replicas' build
        self.hosts: List[Optional[ServingHost]] = [None] * n
        errs: List[BaseException] = []

        def spawn(i: int) -> None:
            try:
                h = self._new_host(f"h{i}")
            except BaseException as e:  # noqa: BLE001 - raised below
                errs.append(e)
                return
            with self._lock:
                self.hosts[i] = h

        threads = [threading.Thread(target=spawn, args=(i,),
                                    name=f"host-spawn-{i}")
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            for h in self.hosts:
                if h is not None:
                    h.stop()
            raise errs[0]
        self.publish()
        self._update_gauges()

    def _new_host(self, name: str) -> ServingHost:
        return ServingHost(name, self.host_spec,
                           spawn_timeout=self._spawn_timeout,
                           registry=self.registry)

    # -- resolver publication ------------------------------------------------

    def endpoints(self) -> List[str]:
        """The live set: hosts up and not draining."""
        with self._lock:
            return [h.endpoint for h in self.hosts
                    if h is not None and h.alive() and not h.draining]

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    def publish(self) -> int:
        """Rewrite the endpoints file under the next generation (nothing
        without a ``resolver_path``). An empty set is never written: a
        total outage must read as a stale file, whose last set clients keep
        trying, not as no hosts at all."""
        eps = self.endpoints()
        with self._lock:
            self._generation += 1
            gen = self._generation
        if self.resolver_path and eps:
            write_endpoints(self.resolver_path, eps, gen,
                            updated_at=time.time())
        return gen

    # -- monitor -------------------------------------------------------------

    def start(self) -> "HostFleet":
        with self._lock:
            if self._monitor is not None:
                return self
            self._closed.clear()
            self._monitor = threading.Thread(target=self._monitor_loop,
                                             daemon=True,
                                             name="host-monitor")
            mon = self._monitor
        mon.start()
        return self

    def _monitor_loop(self) -> None:
        while not self._closed.wait(self._probe_s):
            try:
                self._probe_once()
            except Exception:  # noqa: BLE001 - the monitor outlives a host
                pass

    def _probe_once(self) -> int:
        """One monitor pass; returns the restarts it made (tests and
        drills call it directly)."""
        restarts = 0
        with self._lock:
            n = len(self.hosts)
        for i in range(n):
            with self._lock:
                h = self.hosts[i]
                if (h is None and i in self._decommissioned) or \
                        self._closed.is_set():
                    continue
            if h is not None and h.draining:
                continue
            if h is not None and h.alive():
                try:
                    doc = h.health(deadline=self._probe_s * 4 + 1.0)
                    if doc.get("healthy", 0) > 0:
                        self.supervisor.note_healthy(h.name)
                    continue
                except (HostSpawnError, RuntimeError):
                    pass               # the death path below
            name = f"h{i}" if h is None else h.name
            if h is not None:
                with self._lock:
                    counted = not h._death_counted
                    h._death_counted = True
                if counted:
                    self.supervisor.record_death(name)
                    # republish at once: clients stop picking the dead
                    # endpoint at their next poll, before their probes trip
                    self.publish()
                    h.stop()           # reap, sweep the group
            if not self.supervisor.allow_restart(name):
                with self._lock:
                    if h is not None and not h.alive():
                        self.hosts[i] = None
                self._update_gauges()
                continue
            try:
                nh = self._new_host(name)
            except Exception:  # noqa: BLE001 - counted, retried next pass
                self.supervisor.record_restart_failure(name)
                with self._lock:
                    self.hosts[i] = None
                self._update_gauges()
                continue
            with self._lock:
                self.hosts[i] = nh
            self.registry.add("serving.host_restarts")
            restarts += 1
            self.supervisor.note_healthy(name)
            self.publish()
        self._update_gauges()
        return restarts

    def _update_gauges(self) -> None:
        with self._lock:
            total = sum(1 for i in range(len(self.hosts))
                        if i not in self._decommissioned)
            up = sum(1 for h in self.hosts if h is not None and h.alive())
        self.registry.gauge("serving.hosts").set(total)
        self.registry.gauge("serving.hosts_down").set(max(0, total - up))

    # -- operations ----------------------------------------------------------

    def kill_host(self, i: int) -> None:
        """Drill hook: SIGKILL host ``i``'s whole process group."""
        with self._lock:
            h = self.hosts[i]
        if h is None:
            raise ValueError(f"host slot {i} is empty")
        h.kill_group()

    def decommission(self, i: int, grace: float = 1.0,
                     drain_timeout: Optional[float] = None) -> None:
        """Planned removal, invisible to traffic: unpublish first, give
        clients ``grace`` seconds to adopt the new generation, then drain
        and stop. The slot stays empty (the monitor does not respawn it)."""
        with self._lock:
            h = self.hosts[i]
            if h is None:
                raise ValueError(f"host slot {i} is empty")
            h.draining = True
            self._decommissioned.add(i)
        self.publish()
        time.sleep(grace)
        try:
            h.drain(timeout=drain_timeout)
        except (HostSpawnError, RuntimeError):
            pass                       # it died mid-drain: stop() reaps
        h.stop()
        with self._lock:
            self.hosts[i] = None
        self._update_gauges()

    def add_host(self) -> int:
        """Grow the fleet by one host; returns its slot."""
        with self._lock:
            name = f"h{self._next_id}"
            self._next_id += 1
        nh = self._new_host(name)
        with self._lock:
            self.hosts.append(nh)
            slot = len(self.hosts) - 1
        self.publish()
        self._update_gauges()
        return slot

    def health(self) -> Dict:
        with self._lock:
            hosts = list(self.hosts)
        docs = [{"slot": i, "up": False} if h is None else
                {"slot": i, "name": h.name, "up": h.alive(),
                 "endpoint": h.endpoint, "draining": h.draining}
                for i, h in enumerate(hosts)]
        return {"hosts": docs, "generation": self.generation,
                "quarantined": self.supervisor.quarantined_names()}

    def stop(self) -> None:
        self._closed.set()
        with self._lock:
            mon, self._monitor = self._monitor, None
        if mon is not None and mon.is_alive():
            mon.join(timeout=self._probe_s * 4 + 1.0)
        with self._lock:
            hosts = [h for h in self.hosts if h is not None]
            self.hosts = [None] * len(self.hosts)
        for h in hosts:
            h.stop()

    def __enter__(self) -> "HostFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


__all__ = ["ServingHost", "HostFleet", "HostSpawnError"]
