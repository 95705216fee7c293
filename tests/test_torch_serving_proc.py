"""The port's process-scope serving on the CPU: ``serving/transport.py``
(the reference's bytes for the same objects, torn frames, the fault
points), ``serving/supervisor.py`` (the reference's states for the same
deaths and clock), ``serving/proc.py`` replicas behind a ``ReplicaSet``
(real spawned children: SIGKILL mid-flight, retry budget, self exit, spawn
faults, a poisoned spec, side-channel faults, a wedged child, heartbeat
expiry), crash-loop quarantine through the fleet, and a process fleet of
``CTRPredictor`` children on the CPU scoring a bundle the JAX package
exports as the reference's fleet does (within 1e-5).

Stand-in children come from ``torch_serving_fakes`` (no torch import);
the flags the reference sets with ``flags.set`` are ``PBOX_FLAGS_*``
variables here."""

import os
import signal
import socket
import threading
import time

import numpy as np
import pytest

from paddlebox_tpu.obs.metrics import MetricsRegistry as RefRegistry
from paddlebox_tpu.serving import ReplicaSet as JaxReplicaSet
from paddlebox_tpu.serving import supervisor as ref_supervisor
from paddlebox_tpu.serving import transport as ref_transport
from paddlebox_tpu_torch.inference.server import predict_lines
from paddlebox_tpu_torch.obs.metrics import MetricsRegistry
from paddlebox_tpu_torch.obs.slo import SloEngine, default_rules
from paddlebox_tpu_torch.serving import (FrontDoor, ReplicaDead, ReplicaSet,
                                         RestartSupervisor, SpawnError,
                                         TornFrame, TransportError,
                                         WireVersionMismatch)
from paddlebox_tpu_torch.serving import supervisor, transport
from paddlebox_tpu_torch.serving.fleet import RetryBudgetExhausted
from paddlebox_tpu_torch.serving.proc import ProcReplica
from paddlebox_tpu_torch.utils import faults
from torch_serving_fakes import FakePredictor, fake_spec, feed_conf, lines
import torch_serving_world as W

ATOL = 1e-5


def wait(pred, timeout=5.0, step=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


@pytest.fixture
def clean_injector():
    yield
    faults.install_injector(None)


# -- the transport -----------------------------------------------------------

def wire_objects():
    """Messages of the replica protocol whose classes both packages share
    (a ``SlotRecord`` pickles under its own package's module path)."""
    return [{"x": 1, "arr": [1.5, 2.5]}, ("ok", b"payload"),
            ("ok", np.arange(5, dtype=np.float32)), ("exit",),
            ("reload", "/b", ({"day": "1", "pass_id": 2}, [])),
            {"role": "side", "ready": {"pid": 7, "model_version": None}}]


def test_pack_obj_gives_the_reference_bytes():
    for obj in wire_objects():
        assert transport.pack_obj(obj) == ref_transport.pack_obj(obj)
        assert transport.unpack_obj(ref_transport.pack_obj(obj)).__repr__() \
            == obj.__repr__()
    assert transport.WIRE_VERSION == ref_transport.WIRE_VERSION
    assert transport.MAX_FRAME == ref_transport.MAX_FRAME
    a, b = socket.socketpair()
    try:
        ref_transport.send_obj(a, ("ok", [0.25]))
        transport.send_obj(a, ("ok", [0.5]))
        assert transport.recv_obj(b) == ("ok", [0.25])
        assert ref_transport.recv_obj(b) == ("ok", [0.5])
    finally:
        a.close()
        b.close()


def test_roundtrip_torn_frames_and_versions():
    a, b = socket.socketpair()
    try:
        for obj in wire_objects()[:2]:
            transport.send_obj(a, obj)
        assert transport.recv_obj(b) == {"x": 1, "arr": [1.5, 2.5]}
        assert transport.recv_obj(b) == ("ok", b"payload")
        a.close()
        assert transport.recv_obj(b) is None       # clean EOF
    finally:
        b.close()
    for partial in (transport._HEADER.pack(100) + b"only-part", b"\x00\x00"):
        a, b = socket.socketpair()
        a.sendall(partial)
        a.close()
        with pytest.raises(TornFrame):
            transport.recv_frame(b)
        b.close()
    a, b = socket.socketpair()
    try:
        a.sendall(transport._HEADER.pack(transport.MAX_FRAME + 1))
        with pytest.raises(TornFrame, match="impossible frame"):
            transport.recv_frame(b)
        with pytest.raises(TransportError, match="too large"):
            transport.send_frame(a, b"x" * (transport.MAX_FRAME + 1))
    finally:
        a.close()
        b.close()
    with pytest.raises(WireVersionMismatch, match="mixed-build"):
        transport.unpack_obj(b"\x00\x02" + b"rest")
    with pytest.raises(WireVersionMismatch, match="unversioned"):
        import pickle
        transport.unpack_obj(pickle.dumps({"x": 1}, protocol=5))
    with pytest.raises(WireVersionMismatch, match="runt"):
        transport.unpack_obj(b"\x00")


@pytest.mark.parametrize("op", ["serve.frame_mid", "serve.frame_send"])
def test_fault_points_tear_or_spare_the_wire(op, clean_injector):
    """``serve.frame_mid`` leaves a torn frame, ``serve.frame_send``
    nothing (a clean EOF)."""
    a, b = socket.socketpair()
    faults.install_injector(faults.FaultInjector(
        seed=3, fail_rate=1.0, ops=[op], max_failures=1))
    try:
        with pytest.raises(OSError):
            transport.send_obj(a, {"x": 1})
        a.close()
        if op == "serve.frame_mid":
            with pytest.raises(TornFrame):
                transport.recv_obj(b)
        else:
            assert transport.recv_obj(b) is None
    finally:
        b.close()
    assert faults.SERVE_FAULT_OPS == (
        "serve.spawn", "serve.frame_send", "serve.frame_mid",
        "serve.side_write")


# -- the restart supervisor: scripts run on both packages --------------------

SCRIPTS = {
    "budget": (dict(budget=2), [
        ("death", "r0"), ("allow", "r0"), ("fail", "r0"), ("death", "r0"),
        ("allow", "r0"), ("allow", "r1"), ("state", "r0")]),
    "window": (dict(budget=2, window=10.0), [
        ("death", "r0"), ("death", "r0"), ("tick", 20.0), ("death", "r0"),
        ("state", "r0")]),
    "backoff": (dict(budget=10, backoff_base=1.0), [
        ("death", "r0"), ("allow", "r0"), ("death", "r0"),
        ("allow", "r0"), ("death", "r0"), ("allow", "r0"), ("tick", 1.0),
        ("allow", "r0"), ("death", "r0"), ("tick", 2.0), ("allow", "r0"),
        ("tick", 3.0), ("allow", "r0"), ("tick", 100.0), ("allow", "r0")]),
    "quiet": (dict(budget=10), [
        ("death", "r0"), ("death", "r0"), ("death", "r0"), ("allow", "r0"),
        ("tick", 10.0), ("healthy", "r0"), ("death", "r0"),
        ("allow", "r0")]),
    "half_open_closes": (dict(budget=1, circuit_reset=5.0), [
        ("death", "r0"), ("death", "r0"), ("allow", "r0"), ("tick", 5.0),
        ("allow", "r0"), ("state", "r0"), ("allow", "r0"),
        ("healthy", "r0"), ("state", "r0")]),
    "half_open_reopens": (dict(budget=1, circuit_reset=5.0), [
        ("death", "r0"), ("death", "r0"), ("tick", 5.0), ("allow", "r0"),
        ("fail", "r0"), ("state", "r0"), ("allow", "r0")]),
    "reset": (dict(budget=1, circuit_reset=0.0), [
        ("death", "r0"), ("death", "r1"), ("death", "r0"), ("death", "r1"),
        ("tick", 1e9), ("allow", "r0"), ("reset", "r0"), ("state", "r0"),
        ("allow", "r0"), ("reset", "r9"), ("state", "r9")]),
}


def run_script(mod, reg_cls, conf, script):
    now = [0.0]
    kw = dict(budget=2, window=10.0, backoff_base=1.0, circuit_reset=0.0)
    kw.update(conf)
    reg = reg_cls()
    sup = mod.RestartSupervisor(clock=lambda: now[0], registry=reg, **kw)
    log = []
    for op, arg in script:
        if op == "tick":
            now[0] = arg
            continue
        out = {"death": sup.record_death, "fail": sup.record_restart_failure,
               "allow": sup.allow_restart, "healthy": sup.note_healthy,
               "reset": sup.reset, "state": sup.state}[op](arg)
        log.append((op, arg, out, sup.quarantined(arg),
                    sup.quarantined_names()))
    log.append(sorted((k, m.get()) for k, m in reg.items()))
    return log


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_supervisor_matches_reference(name):
    conf, script = SCRIPTS[name]
    got = run_script(supervisor, MetricsRegistry, conf, script)
    assert got == run_script(ref_supervisor, RefRegistry, conf, script)
    if name == "budget":
        assert got[3][2] is True and got[3][4] == ["r0"]
        assert got[4][2] is False and got[5][2] is True


def test_supervisor_dumps_outside_its_lock(tmp_path, monkeypatch):
    with pytest.raises(ValueError):
        RestartSupervisor(budget=0)
    monkeypatch.setenv("PBOX_FLAGS_obs_postmortem_dir", str(tmp_path))
    sup = RestartSupervisor(budget=1, window=10.0,
                            registry=MetricsRegistry())
    held = []
    real = supervisor.postmortem.maybe_dump

    def dump(reason, extra=None):
        free = sup._lock.acquire(timeout=0)
        if free:
            sup._lock.release()
        held.append(not free)
        return real(reason, extra=extra)

    monkeypatch.setattr(supervisor.postmortem, "maybe_dump", dump)
    sup.record_death("r0")
    assert sup.record_death("r0") is True
    assert held == [False]
    assert len([d for d in os.listdir(tmp_path)
                if d.startswith("postmortem-")]) == 1
    assert sup.state("r0")["circuit"] == supervisor.OPEN
    assert sup.state("r0")["open_for_s"] is not None


def test_supervisor_defaults_read_the_flags(monkeypatch):
    monkeypatch.setenv("PBOX_FLAGS_serve_restart_budget", "7")
    monkeypatch.setenv("PBOX_FLAGS_serve_circuit_reset", "2.5")
    sup = RestartSupervisor(registry=MetricsRegistry())
    assert (sup.budget, sup.window, sup.backoff_base, sup.circuit_reset) \
        == (7, 30.0, 0.5, 2.5)


# -- process-scope replicas --------------------------------------------------

def proc_fleet(reg, replicas=2, spec_kw=None, **kw):
    spec = fake_spec(**(spec_kw or {"delay_s": 0.001}))
    kw.setdefault("probe_interval", 60.0)
    return ReplicaSet(None, worker_spec=spec, scope="process",
                      replicas=replicas, registry=reg, **kw)


def test_serves_with_real_fault_domains():
    reg = MetricsRegistry()
    with proc_fleet(reg) as fs:
        assert fs.scope == "process"
        pids = {r.child_pid for r in fs.replicas}
        assert len(pids) == 2 and os.getpid() not in pids
        out = fs.predict_lines(lines(np.random.default_rng(0), 3),
                               deadline_ms=15000.0)
        assert out.shape == (3,) and np.all(out == 0.5)
        ok, doc = fs.health()
        assert ok and doc["scope"] == "process"
        assert all(d["scope"] == "process" and d["child_alive"]
                   for d in doc["replicas"])
        assert doc["versions"] == ["drill/00001"] * 2
        t = fs.replicas[0].spawn_timing
        assert t["total_s"] >= t["start_s"] + t["build_s"] > 0
        assert t["context_s"] == 0.0          # a stand-in: no card
        assert wait(lambda: reg.gauge(
            "serving.replica.r0.child.serve.predict_ms.count").get()
            + reg.gauge("serving.replica.r1.child.serve.predict_ms.count"
                        ).get() >= 1, 10.0)


def test_launch_counts_read_and_reset_in_the_child():
    """``launch_counts`` reads the child's wrapper counts on the request
    channel; ``reset=True`` sets them, and the side channel's mirrored
    gauge, to 0, so a run after it counts only its own batches."""
    reg = MetricsRegistry()
    gauge = "serving.replica.r0.child.serve.launches.seqpool_cvm_cuda"
    with proc_fleet(reg, replicas=1,
                    spec_kw={"delay_s": 0.0, "count_launches": True}) as fs:
        rep = fs.replicas[0]
        rng = np.random.default_rng(3)
        fs.warm(lines(rng, 2))
        assert rep.launch_counts() == {"seqpool_cvm_cuda": 1}
        assert rep.launch_counts(reset=True) == {"seqpool_cvm_cuda": 1}
        assert wait(lambda: reg.gauge(gauge).get() == 0.0, 10.0)
        for _ in range(3):
            fs.predict_lines(lines(rng, 2), deadline_ms=15000.0)
        assert rep.launch_counts() == {"seqpool_cvm_cuda": 3}
        assert wait(lambda: reg.gauge(gauge).get() == 3.0, 10.0)


def inflight_kill(fs, client):
    errors, result = [], []

    def run():
        try:
            result.append(client())
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    th = threading.Thread(target=run)
    th.start()
    assert wait(lambda: fs.replicas[0].outstanding() > 0)
    time.sleep(0.15)
    fs.replicas[0].kill()
    th.join(timeout=20.0)
    return result, errors


def test_sigkill_mid_flight_retries_invisibly():
    reg = MetricsRegistry()
    with proc_fleet(reg, spec_kw={"delay_s": 0.6}) as fs:
        result, errors = inflight_kill(fs, lambda: fs.predict_lines(
            lines(np.random.default_rng(0), 2), deadline_ms=20000.0))
        assert errors == [] and result[0].shape == (2,)
        assert reg.counter("serving.retried_inflight").get() == 1
        assert reg.counter("serving.proc_child_deaths").get() == 1
        assert fs._probe_once() == 1 and fs.healthy_count() == 2


def test_non_idempotent_and_retry_budget(monkeypatch):
    """``idempotent=False`` surfaces an in-flight death; a retry budget
    of one attempt ends a rerouted request."""
    reg = MetricsRegistry()
    with proc_fleet(reg, spec_kw={"delay_s": 0.6}) as fs:
        records = [fs.parser.parse_line(ln)
                   for ln in lines(np.random.default_rng(0), 2)]
        _, errors = inflight_kill(fs, lambda: fs.predict_records(
            records, deadline_ms=20000.0, idempotent=False))
        assert len(errors) == 1 and isinstance(errors[0], ReplicaDead)
        assert reg.counter("serving.retried_inflight").get() == 0
        assert fs._probe_once() == 1
        monkeypatch.setenv("PBOX_FLAGS_serve_retry_budget", "1")
        _, errors = inflight_kill(fs, lambda: fs.predict_records(
            records, deadline_ms=20000.0))
        assert len(errors) == 1
        assert isinstance(errors[0], RetryBudgetExhausted)


def test_child_self_exit_detected_idle_and_spawn_faults(clean_injector):
    """An idle child's exit is seen on the side channel; a spawn fault on
    the restart path is a supervisor event; the slot heals with a fresh
    pid when the fault clears."""
    reg = MetricsRegistry()
    with proc_fleet(reg) as fs:
        pid0 = fs.replicas[0].child_pid
        fs.replicas[0].crash("exit")
        assert wait(lambda: not fs.replicas[0].alive(), 10.0)
        faults.install_injector(faults.FaultInjector(
            seed=0, fail_rate=1.0, ops=["serve.spawn"]))
        assert fs._probe_once() == 0
        assert reg.counter("serving.replica_restart_failures").get() == 1
        faults.install_injector(None)
        assert fs._probe_once() == 1 and fs.healthy_count() == 2
        assert fs.replicas[0].child_pid != pid0
        assert wait(lambda: reg.gauge(
            "serving.replica.r0.child_exitcode").get() == 13.0, 10.0)
        assert fs.predict_lines(lines(np.random.default_rng(1), 2),
                                deadline_ms=15000.0).shape == (2,)
    faults.install_injector(faults.FaultInjector(
        seed=0, fail_rate=1.0, ops=["serve.spawn"]))
    with pytest.raises(OSError):
        proc_fleet(MetricsRegistry(), replicas=1)


def test_poisoned_spec_fails_spawn_loudly(tmp_path):
    poison = str(tmp_path / "poison.marker")
    with open(poison, "w") as f:
        f.write("bad\n")
    with pytest.raises(SpawnError, match="before handshake"):
        proc_fleet(MetricsRegistry(), replicas=1,
                   spec_kw={"delay_s": 0.001, "poison_path": poison})


def test_side_write_fault_counted_and_flags_reach_the_child(tmp_path):
    """The child's injector (from the spec) skips health beats but never
    serving; the spec's flags become the child's ``PBOX_FLAGS_*`` (its
    trace dump lands beside the parent's, under the replica's role)."""
    reg = MetricsRegistry()
    spec = fake_spec(delay_s=0.001)
    spec["side_interval"] = 0.05
    spec["fault_injector"] = {"seed": 7, "fail_rate": 1.0,
                              "ops": ["serve.side_write"],
                              "max_failures": 2}
    spec["flags"] = {"obs_trace_dir": str(tmp_path)}
    with ReplicaSet(None, worker_spec=spec, scope="process", replicas=1,
                    probe_interval=60.0, registry=reg) as fs:
        assert fs.predict_lines(lines(np.random.default_rng(0), 2),
                                deadline_ms=15000.0).shape == (2,)
        gname = "serving.replica.r0.child.serve.side_write_failures"
        assert wait(lambda: reg.gauge(gname).get() >= 2.0, 10.0)
        assert fs.replicas[0].alive()
    dumps = [f for f in os.listdir(tmp_path) if f.startswith("pbx_trace_")]
    assert len(dumps) == 1
    import json
    doc = json.load(open(os.path.join(tmp_path, dumps[0])))
    assert doc["otherData"]["role"] == "r0"
    assert any(e.get("name") == "replica.predict"
               for e in doc["traceEvents"])


def test_wedged_child_stop_and_heartbeat_expiry():
    """A SIGSTOPped child: ``stop()`` does not deadlock on the rpc lock,
    and a heartbeat expiry is detected cheaply, the reap off the
    caller's thread."""
    reg = MetricsRegistry()
    fs = proc_fleet(reg, replicas=1, spec_kw={"delay_s": 30.0})
    fs.start()
    r = fs.replicas[0]
    try:
        threading.Thread(target=lambda: fs.predict_lines(
            lines(np.random.default_rng(0), 2), deadline_ms=60000.0),
            daemon=True).start()
        assert wait(lambda: r.outstanding() > 0)
        time.sleep(0.2)
        os.kill(r.child_pid, signal.SIGSTOP)
        stopper = threading.Thread(target=lambda: fs.stop(
            drain_timeout=0.2), daemon=True)
        stopper.start()
        stopper.join(timeout=25.0)
        assert not stopper.is_alive(), "fleet stop deadlocked"
        assert not r._proc.is_alive()
    finally:
        try:
            os.kill(r.child_pid, signal.SIGKILL)
        except OSError:
            pass
    spec = fake_spec(delay_s=0.001)
    spec["side_interval"] = 0.05
    r = ProcReplica("rw", spec, registry=reg, heartbeat_timeout=0.3)
    r.start()
    try:
        os.kill(r.child_pid, signal.SIGSTOP)
        assert wait(lambda: (r._heartbeat_age() or 0.0) > 0.4, 10.0)
        t0 = time.monotonic()
        assert r.alive() is False
        assert time.monotonic() - t0 < 1.5
        assert reg.counter("serving.proc_heartbeat_timeouts").get() == 1
        assert wait(lambda: not r._proc.is_alive(), 10.0)
    finally:
        try:
            os.kill(r.child_pid, signal.SIGKILL)
        except OSError:
            pass
        r.stop(drain_timeout=0.1)


def test_frontdoor_survives_child_death():
    reg = MetricsRegistry()
    with proc_fleet(reg) as fs, FrontDoor(fs) as door:
        ls = lines(np.random.default_rng(3), 3)
        assert predict_lines(*door.address, ls).shape == (3,)
        fs.replicas[0].kill()
        assert wait(lambda: not fs.replicas[0].alive(), 10.0)
        for _ in range(3):
            assert predict_lines(*door.address, ls,
                                 deadline_ms=10000.0).shape == (3,)


def test_crash_loop_quarantined_fleet_degrades_and_heals():
    """Thread replicas whose factory fails every restart: the circuit
    opens within its budget, the shipped quarantine rule fires, probes
    stop restarting, the fleet serves off the survivor, a reset heals."""
    reg = MetricsRegistry()
    sup = RestartSupervisor(budget=2, window=60.0, backoff_base=0.001,
                            registry=reg)
    state = {"fail": False}

    def factory():
        if state["fail"]:
            raise RuntimeError("poisoned bundle")
        return FakePredictor(feed_conf(), 0.001)

    engine = SloEngine(registry=reg, interval=3600.0)
    qrules = [r for r in default_rules()
              if r.name == "serving_replica_quarantined"]
    with ReplicaSet(factory, replicas=2, probe_interval=60.0, registry=reg,
                    supervisor=sup) as fs:
        fs.attach_slo(engine, rules=qrules)
        fs.replicas[0].kill()
        assert wait(lambda: not fs.replicas[0].alive())
        state["fail"] = True
        deadline = time.monotonic() + 10.0
        while not sup.quarantined("r0") and time.monotonic() < deadline:
            fs._probe_once()
            time.sleep(0.005)
        assert sup.quarantined("r0")
        fails = reg.counter("serving.replica_restart_failures").get()
        for _ in range(3):
            fs._probe_once()
        assert reg.counter("serving.replica_restart_failures").get() \
            == fails >= 2
        engine.evaluate(now=1.0)
        assert [a["rule"] for a in engine.firing()] == \
            ["serving_replica_quarantined"]
        assert fs.predict_lines(lines(np.random.default_rng(0), 2),
                                deadline_ms=2000.0).shape == (2,)
        assert fs.health()[1]["quarantined"] == ["r0"]
        state["fail"] = False
        sup.reset("r0")
        assert fs._probe_once() == 1 and fs.healthy_count() == 2
        engine.evaluate(now=2.0)
        assert engine.firing() == []


def test_stop_racing_restart_leaks_nothing():
    """A restart whose slow build outlives ``stop()`` is stopped, not
    installed; two concurrent probes install one replacement."""
    reg = MetricsRegistry()
    gate = threading.Event()
    made = []

    def factory():
        if made:
            gate.wait(5.0)
        p = FakePredictor(feed_conf(), 0.001)
        made.append(p)
        return p

    fs = ReplicaSet(factory, replicas=1, probe_interval=60.0, registry=reg)
    fs.start()
    fs.replicas[0].kill()
    assert wait(lambda: not fs.replicas[0].alive())
    probe = threading.Thread(target=fs._probe_once)
    probe.start()
    time.sleep(0.1)
    fs.stop(drain_timeout=0.1)
    gate.set()
    probe.join(timeout=10.0)
    assert fs.healthy_count() == 0
    assert reg.counter("serving.replica_restarts").get() == 0
    with ReplicaSet(lambda: FakePredictor(feed_conf(), 0.001), replicas=2,
                    probe_interval=60.0, registry=MetricsRegistry()) as fs:
        fs.replicas[1].kill()
        assert wait(lambda: not fs.replicas[1].alive())
        counts = []
        ts = [threading.Thread(target=lambda: counts.append(
            fs._probe_once())) for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert sum(counts) == 1 and fs.healthy_count() == 2
        assert fs.registry.counter("serving.replica_deaths").get() == 1


# -- CTRPredictor children against the reference ------------------------------

def test_process_fleet_scores_match_reference(tmp_path):
    """Two spawned ``CTRPredictor`` children on the CPU (worker spec
    ``device="cpu"``) score a bundle the JAX package exports as the
    reference's process fleet of two scores it."""
    path, _, _ = W.jax_bundle(str(tmp_path))
    ls = lines(np.random.default_rng(5), 24)
    reg = MetricsRegistry()
    fleet = ReplicaSet.from_bundle(path, replicas=2, scope="process",
                                   device="cpu", probe_interval=60.0,
                                   registry=reg)
    with fleet:
        assert fleet.versions() == ["19700101/00000"] * 2
        got = np.concatenate([fleet.predict_lines(
            ls[i:i + 6], deadline_ms=30000.0) for i in range(0, 24, 6)])
        # the children mirror their kernel wrapper's count (the plain
        # pool runs on the CPU, so it stays 0) on the side channel
        assert wait(lambda: any(
            n.endswith("child.serve.launches.seqpool_cvm_cuda")
            for n, _ in reg.items()), 10.0)
        assert all(m.get() == 0.0 for n, m in reg.items()
                   if n.endswith("child.serve.launches.seqpool_cvm_cuda"))
    ref = JaxReplicaSet.from_bundle(path, replicas=2, scope="thread",
                                    probe_interval=60.0,
                                    registry=RefRegistry())
    with ref:
        want = np.concatenate([ref.predict_lines(
            ls[i:i + 6], deadline_ms=30000.0) for i in range(0, 24, 6)])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
