"""The port's host tier on the CPU: ``serving/resolver.py`` (the
reference's ``TestResolver`` cases, and endpoints files crossing between
the packages), ``serving/lb_client.py`` (the reference's ``TestLBClient``
cases over its scripted raw host, and each package's LB against the other
package's front door), ``serving/host.py`` (spawned hosts: serve and drain,
a group kill that takes a replica grandchild, the lifeline, spawn
failures; a ``HostFleet`` of two ``CTRPredictor`` hosts scoring a bundle
the JAX package exports as the reference's predictor does, through a host
kill under traffic; a rolling drain; the reference drill's resolver chaos)
and ``obs/fleet.py``.

Stand-in hosts serve ``torch_serving_fakes``' predictors; the flags the
reference sets with ``flags.set`` are ``PBOX_FLAGS_*`` variables here."""

import importlib.util
import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from paddlebox_tpu.inference.predictor import CTRPredictor as JaxPredictor
from paddlebox_tpu.obs.metrics import MetricsRegistry as RefRegistry
from paddlebox_tpu.serving import FrontDoor as RefFrontDoor
from paddlebox_tpu.serving import ReplicaSet as RefReplicaSet
from paddlebox_tpu.serving.lb_client import LBClient as RefLBClient
from paddlebox_tpu.serving.resolver import FileResolver as RefFileResolver
from paddlebox_tpu.serving.resolver import \
    StaticResolver as RefStaticResolver
from paddlebox_tpu.serving.resolver import \
    write_endpoints as ref_write_endpoints
from paddlebox_tpu_torch.obs.fleet import FleetMetrics
from paddlebox_tpu_torch.obs.metrics import MetricsRegistry
from paddlebox_tpu_torch.serving import (FileResolver, FrontDoor, HostFleet,
                                         HostSpawnError, HostUnavailable,
                                         LBClient, ReplicaSet,
                                         RestartSupervisor,
                                         RetryBudgetExhausted, ServingHost,
                                         StaticResolver, write_endpoints)
from paddlebox_tpu_torch.serving.batcher import RequestExpired
from paddlebox_tpu_torch.utils import faults
from torch_serving_fakes import FakePredictor, fake_spec, feed_conf, lines
import torch_serving_world as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


serving_drill = _load_tool("serving_drill")


def _lines(n=2, seed=0):
    return lines(np.random.default_rng(seed), n)


def wait(pred, timeout=5.0, step=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


class Clock:
    """An injectable monotonic clock."""

    def __init__(self, t=1000.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def pgid_alive(pgid: int) -> bool:
    try:
        os.killpg(pgid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


def host_spec(scope="thread", replicas=1, **fake_kwargs):
    return {"scope": scope, "replicas": replicas,
            "worker_spec": fake_spec(**fake_kwargs)}


@pytest.fixture
def clean_injector():
    yield
    faults.install_injector(None)


# -- the resolver -------------------------------------------------------------

class TestResolver:
    def test_missing_file_keeps_empty_set(self, tmp_path):
        reg = MetricsRegistry()
        res = FileResolver(str(tmp_path / "eps.json"), poll_s=10.0,
                           registry=reg)
        assert res.endpoints() == ()
        assert res.generation == 0
        assert reg.counter("serving.resolver.missing").get() >= 1

    def test_adopt_and_dedup(self, tmp_path):
        path = str(tmp_path / "eps.json")
        write_endpoints(path, ["127.0.0.1:9001", "127.0.0.1:9002",
                               "127.0.0.1:9001"], generation=3)
        res = FileResolver(path, poll_s=10.0, registry=MetricsRegistry())
        assert res.snapshot() == (3, ("127.0.0.1:9001", "127.0.0.1:9002"))

    def test_torn_write_keeps_last_good(self, tmp_path):
        path = str(tmp_path / "eps.json")
        write_endpoints(path, ["127.0.0.1:9001"], generation=1)
        reg = MetricsRegistry()
        res = FileResolver(path, poll_s=10.0, registry=reg)
        with open(path, "wb") as f:
            f.write(b'{"generation": 2, "endpoints": ["127.0')
        assert res.poll() is False
        assert res.snapshot() == (1, ("127.0.0.1:9001",))
        assert reg.counter("serving.resolver.torn_reads").get() == 1

    def test_empty_set_never_adopted(self, tmp_path):
        path = str(tmp_path / "eps.json")
        write_endpoints(path, ["127.0.0.1:9001"], generation=1)
        reg = MetricsRegistry()
        res = FileResolver(path, poll_s=10.0, registry=reg)
        write_endpoints(path, [], generation=2)
        assert res.poll() is False
        assert res.endpoints() == ("127.0.0.1:9001",)
        assert reg.counter("serving.resolver.rejected").get() == 1

    def test_generation_rollback_rejected(self, tmp_path):
        path = str(tmp_path / "eps.json")
        write_endpoints(path, ["127.0.0.1:9001"], generation=5)
        reg = MetricsRegistry()
        res = FileResolver(path, poll_s=10.0, registry=reg)
        write_endpoints(path, ["127.0.0.1:6666"], generation=4)
        assert res.poll() is False
        assert res.snapshot() == (5, ("127.0.0.1:9001",))
        assert reg.counter("serving.resolver.rejected").get() == 1
        # the same generation again: no change, no rejection
        write_endpoints(path, ["127.0.0.1:6666"], generation=5)
        assert res.poll() is False
        assert reg.counter("serving.resolver.rejected").get() == 1

    def test_garbage_schema_rejected(self, tmp_path):
        path = str(tmp_path / "eps.json")
        reg = MetricsRegistry()
        res = FileResolver(path, poll_s=10.0, registry=reg)
        for doc in ([1, 2, 3],
                    {"generation": "7", "endpoints": ["a:1"]},
                    {"generation": 7},
                    {"generation": 7, "endpoints": ["nocolon",
                                                    "host:notaport",
                                                    ":1", 42]}):
            with open(path, "w") as f:
                json.dump(doc, f)
            assert res.poll() is False
        assert res.endpoints() == ()
        assert reg.counter("serving.resolver.rejected").get() == 4

    def test_same_set_republished_advances_gen_silently(self, tmp_path):
        path = str(tmp_path / "eps.json")
        write_endpoints(path, ["127.0.0.1:9001"], generation=1)
        res = FileResolver(path, poll_s=10.0, registry=MetricsRegistry())
        fired = []
        res.subscribe(lambda gen, eps: fired.append((gen, eps)))
        assert fired == [(1, ("127.0.0.1:9001",))]
        write_endpoints(path, ["127.0.0.1:9001"], generation=2)
        assert res.poll() is False
        assert res.snapshot() == (2, ("127.0.0.1:9001",))
        assert fired == [(1, ("127.0.0.1:9001",))]

    def test_subscriber_sees_every_change(self, tmp_path):
        path = str(tmp_path / "eps.json")
        res = FileResolver(path, poll_s=10.0, registry=MetricsRegistry())
        fired = []
        res.subscribe(lambda gen, eps: fired.append((gen, eps)))
        assert fired == []
        write_endpoints(path, ["127.0.0.1:9001"], generation=1)
        res.poll()
        write_endpoints(path, ["127.0.0.1:9002"], generation=2)
        res.poll()
        assert fired == [(1, ("127.0.0.1:9001",)),
                         (2, ("127.0.0.1:9002",))]

    def test_watcher_thread_picks_up_rewrite(self, tmp_path):
        path = str(tmp_path / "eps.json")
        write_endpoints(path, ["127.0.0.1:9001"], generation=1)
        res = FileResolver(path, poll_s=0.02, registry=MetricsRegistry())
        res.start()
        try:
            write_endpoints(path, ["127.0.0.1:9002"], generation=2)
            assert wait(lambda: res.endpoints() == ("127.0.0.1:9002",))
        finally:
            res.stop()

    def test_poll_racing_atomic_rewrites_never_sees_hybrid(self, tmp_path):
        path = str(tmp_path / "eps.json")
        set_a = ["127.0.0.1:9001", "127.0.0.1:9002"]
        set_b = ["127.0.0.1:9003", "127.0.0.1:9004"]
        write_endpoints(path, set_a, generation=1)
        reg = MetricsRegistry()
        res = FileResolver(path, poll_s=10.0, registry=reg)
        adopted = []
        res.subscribe(lambda gen, eps: adopted.append((gen, eps)))
        stop = threading.Event()

        def writer():
            for gen in range(2, 202):
                write_endpoints(path, set_b if gen % 2 else set_a, gen)
            stop.set()

        w = threading.Thread(target=writer, daemon=True)
        w.start()
        while not stop.is_set():
            res.poll()
        w.join(timeout=10.0)
        res.poll()
        gens = [g for g, _ in adopted]
        assert gens == sorted(set(gens))
        assert all(eps in {tuple(set_a), tuple(set_b)} for _, eps in adopted)
        assert reg.counter("serving.resolver.torn_reads").get() == 0

    def test_static_resolver(self):
        res = StaticResolver(["127.0.0.1:9001", "127.0.0.1:9001"],
                             registry=MetricsRegistry())
        assert res.snapshot() == (1, ("127.0.0.1:9001",))
        fired = []
        res.subscribe(lambda gen, eps: fired.append(gen))
        res.set_endpoints(["127.0.0.1:9002"])
        assert res.snapshot() == (2, ("127.0.0.1:9002",))
        assert fired == [1, 2]

    @pytest.mark.parametrize("writer", ["reference", "port"])
    def test_endpoints_file_crosses_packages(self, tmp_path, writer):
        """A file either package's ``write_endpoints`` writes is read the
        same by both packages' ``FileResolver``; each file is the other's
        byte for byte."""
        path = str(tmp_path / "eps.json")
        write = ref_write_endpoints if writer == "reference" \
            else write_endpoints
        write(path, ["127.0.0.1:9001", "127.0.0.1:9002", "127.0.0.1:9001"],
              generation=4, updated_at=1723000000.5)
        port = FileResolver(path, poll_s=10.0, registry=MetricsRegistry())
        ref = RefFileResolver(path, poll_s=10.0, registry=RefRegistry())
        assert port.snapshot() == ref.snapshot() == (
            4, ("127.0.0.1:9001", "127.0.0.1:9002"))
        other = str(tmp_path / "other.json")
        (write_endpoints if writer == "reference" else ref_write_endpoints)(
            other, ["127.0.0.1:9001", "127.0.0.1:9002", "127.0.0.1:9001"],
            generation=4, updated_at=1723000000.5)
        assert open(path, "rb").read() == open(other, "rb").read()


# -- the LB client over in-process front doors --------------------------------

def _door(reg):
    fleet = ReplicaSet(lambda: FakePredictor(feed_conf(), 0.001), replicas=1,
                       registry=reg)
    fleet.start(metrics_port=None)
    door = FrontDoor(fleet)
    door.start()
    return fleet, door


class ScriptedHost:
    """A raw line-protocol host scripted a connection: ``ok`` answers,
    ``capture`` records, ``close_after_read`` drops the connection once a
    request arrived (a death in flight), ``garbage`` answers unparsable
    bytes."""

    def __init__(self, behavior="ok"):
        self.behavior = behavior
        self.requests = []
        self._srv = socket.create_server(("127.0.0.1", 0))
        self.port = self._srv.getsockname()[1]
        self.endpoint = f"127.0.0.1:{self.port}"
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._serve, daemon=True)
        self._t.start()

    def _serve(self):
        self._srv.settimeout(0.1)
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                continue
            with conn:
                f = conn.makefile("rwb")
                raw = f.readline()
                if not raw:
                    continue
                self.requests.append(json.loads(raw))
                if self.behavior == "close_after_read":
                    continue
                if self.behavior == "garbage":
                    f.write(b"!!not-json!!\n")
                else:
                    n = len(self.requests[-1].get("lines", []))
                    f.write((json.dumps({"scores": [0.5] * n})
                             + "\n").encode())
                f.flush()

    def stop(self):
        self._stop.set()
        self._t.join(timeout=5.0)
        self._srv.close()


class TestLBClient:
    def test_scores_and_least_outstanding_pick(self):
        reg = MetricsRegistry()
        fleet, door = _door(reg)
        try:
            lb = LBClient(StaticResolver([f"127.0.0.1:{door.port}"],
                                         registry=reg), registry=reg)
            try:
                assert len(lb.predict_lines(_lines(3))) == 3
                assert reg.counter("serving.lb.picks").get() == 1
                assert reg.counter("serving.failover_retries").get() == 0
            finally:
                lb.stop()
        finally:
            door.stop()
            fleet.stop()

    def test_failover_onto_live_host_zero_client_failures(self):
        reg = MetricsRegistry()
        fleet, door = _door(reg)
        try:
            # the dead endpoint first: tied counts pick in insertion order
            res = StaticResolver(["127.0.0.1:1", f"127.0.0.1:{door.port}"],
                                 registry=reg)
            sup = RestartSupervisor(budget=100, window=60.0,
                                    circuit_reset=60.0, registry=reg)
            lb = LBClient(res, supervisor=sup, retry_budget=3, registry=reg)
            try:
                for seed in range(3):
                    assert len(lb.predict_lines(_lines(2, seed=seed))) == 2
                assert reg.counter("serving.failover_retries").get() == 3
            finally:
                lb.stop()
        finally:
            door.stop()
            fleet.stop()

    def test_all_dead_exhausts_budget_or_hosts(self):
        reg = MetricsRegistry()
        res = StaticResolver(["127.0.0.1:1", "127.0.0.1:2"], registry=reg)
        sup = RestartSupervisor(budget=100, window=60.0, circuit_reset=60.0,
                                registry=reg)
        lb = LBClient(res, supervisor=sup, retry_budget=5, registry=reg)
        try:
            # a budget of 5 over 2 hosts: each once, never one twice
            with pytest.raises(HostUnavailable):
                lb.predict_lines(_lines())
            assert reg.counter("serving.lb.picks").get() == 2
            lb.retry_budget = 1
            with pytest.raises(RetryBudgetExhausted):
                lb.predict_lines(_lines())
        finally:
            lb.stop()

    def test_deadline_ms_rides_in_the_wire_request(self):
        host = ScriptedHost("ok")
        reg = MetricsRegistry()
        try:
            lb = LBClient(StaticResolver([host.endpoint], registry=reg),
                          registry=reg)
            try:
                lb.predict_lines(_lines(2), deadline_ms=250.0)
                assert len(host.requests) == 1
                assert 0 < host.requests[0]["deadline_ms"] <= 250.0
            finally:
                lb.stop()
        finally:
            host.stop()

    def test_expired_deadline_is_never_requeued(self):
        reg = MetricsRegistry()
        clock = Clock()
        res = StaticResolver(["127.0.0.1:1", "127.0.0.1:2"], registry=reg)
        sup = RestartSupervisor(budget=100, window=60.0, circuit_reset=60.0,
                                registry=reg, clock=clock)
        lb = LBClient(res, supervisor=sup, retry_budget=5, registry=reg,
                      clock=clock)
        try:
            real_attempt = lb._attempt

            def attempt_then_tick(*a, **kw):
                out = real_attempt(*a, **kw)
                clock.advance(0.2)
                return out

            lb._attempt = attempt_then_tick
            with pytest.raises(RequestExpired):
                lb.predict_lines(_lines(), deadline_ms=100.0)
            assert reg.counter("serving.lb.picks").get() == 1
            assert reg.counter("serving.failover_retries").get() == 0
        finally:
            lb.stop()

    def test_already_expired_deadline_sends_nothing(self):
        host = ScriptedHost("capture")
        reg = MetricsRegistry()
        try:
            lb = LBClient(StaticResolver([host.endpoint], registry=reg),
                          registry=reg)
            try:
                with pytest.raises(RequestExpired):
                    lb.predict_lines(_lines(), deadline_ms=0.0)
                assert host.requests == []
                assert reg.counter("serving.lb.picks").get() == 0
            finally:
                lb.stop()
        finally:
            host.stop()

    def test_in_flight_death_not_retried_when_not_idempotent(self):
        dying = ScriptedHost("close_after_read")
        reg = MetricsRegistry()
        fleet, door = _door(reg)
        try:
            res = StaticResolver([dying.endpoint, f"127.0.0.1:{door.port}"],
                                 registry=reg)
            sup = RestartSupervisor(budget=100, window=60.0,
                                    circuit_reset=60.0, registry=reg)
            lb = LBClient(res, supervisor=sup, retry_budget=3, registry=reg)
            try:
                with pytest.raises(HostUnavailable, match="not idempotent"):
                    lb.predict_lines(_lines(), idempotent=False)
                assert len(dying.requests) == 1
                assert len(lb.predict_lines(_lines(), idempotent=True)) == 2
                assert reg.counter("serving.failover_retries").get() == 1
            finally:
                lb.stop()
        finally:
            door.stop()
            fleet.stop()
            dying.stop()

    def test_torn_reply_fails_over(self):
        garbage = ScriptedHost("garbage")
        reg = MetricsRegistry()
        fleet, door = _door(reg)
        try:
            res = StaticResolver([garbage.endpoint,
                                  f"127.0.0.1:{door.port}"], registry=reg)
            sup = RestartSupervisor(budget=100, window=60.0,
                                    circuit_reset=60.0, registry=reg)
            lb = LBClient(res, supervisor=sup, retry_budget=3, registry=reg)
            try:
                assert len(lb.predict_lines(_lines(2))) == 2
                assert reg.counter("serving.failover_retries").get() == 1
            finally:
                lb.stop()
        finally:
            door.stop()
            fleet.stop()
            garbage.stop()

    def test_server_error_reply_is_final(self):
        reg = MetricsRegistry()
        fleet, door = _door(reg)
        try:
            lb = LBClient(StaticResolver([f"127.0.0.1:{door.port}"],
                                         registry=reg), registry=reg)
            try:
                with pytest.raises(RuntimeError, match="server error"):
                    lb.predict_lines(["not a parseable slot line"])
                assert reg.counter("serving.lb.picks").get() == 1
                assert reg.counter("serving.lb.ejections").get() == 0
            finally:
                lb.stop()
        finally:
            door.stop()
            fleet.stop()

    def test_ejection_and_half_open_readmission(self):
        reg = MetricsRegistry()
        clock = Clock()
        fleet, door = _door(reg)
        placeholder = socket.create_server(("127.0.0.1", 0))
        dead_port = placeholder.getsockname()[1]
        placeholder.close()
        dead_ep = f"127.0.0.1:{dead_port}"
        try:
            res = StaticResolver([dead_ep, f"127.0.0.1:{door.port}"],
                                 registry=reg)
            sup = RestartSupervisor(budget=2, window=60.0, circuit_reset=5.0,
                                    registry=reg, clock=clock)
            lb = LBClient(res, supervisor=sup, retry_budget=3, registry=reg)
            try:
                for _ in range(3):
                    lb.predict_lines(_lines())
                assert sup.quarantined(dead_ep)
                assert reg.counter("serving.lb.ejections").get() == 1
                before = reg.counter("serving.failover_retries").get()
                lb.predict_lines(_lines())
                assert reg.counter("serving.failover_retries").get() == before
                # inside the reset window a probe skips the ejected host
                lb.probe_once()
                assert sup.quarantined(dead_ep)
                fleet2 = ReplicaSet(lambda: FakePredictor(feed_conf(), 0.001),
                                    replicas=1, registry=reg)
                fleet2.start(metrics_port=None)
                door2 = FrontDoor(fleet2, port=dead_port)
                door2.start()
                try:
                    clock.advance(6.0)
                    lb.probe_once()          # the one half-open probe
                    assert not sup.quarantined(dead_ep)
                    before = reg.counter("serving.lb.picks").get()
                    assert len(lb.predict_lines(_lines())) == 2
                    assert reg.counter("serving.lb.picks").get() == before + 1
                finally:
                    door2.stop()
                    fleet2.stop()
            finally:
                lb.stop()
        finally:
            door.stop()
            fleet.stop()

    def test_removed_endpoint_is_dropped_and_never_picked(self):
        host = ScriptedHost("ok")
        reg = MetricsRegistry()
        fleet, door = _door(reg)
        try:
            live_ep = f"127.0.0.1:{door.port}"
            res = StaticResolver([host.endpoint, live_ep], registry=reg)
            lb = LBClient(res, registry=reg)
            try:
                assert lb.hosts() == sorted([host.endpoint, live_ep])
                res.set_endpoints([live_ep])
                assert lb.hosts() == [live_ep]
                n0 = len(host.requests)
                for seed in range(3):
                    lb.predict_lines(_lines(seed=seed))
                assert len(host.requests) == n0
                assert int(reg.gauge("serving.lb.hosts").get()) == 1
            finally:
                lb.stop()
        finally:
            door.stop()
            fleet.stop()
            host.stop()

    def test_port_lb_against_reference_front_door(self):
        """The same wire: the port's LB scores through the reference's
        front door, deadline and ping included."""
        ref_reg = RefRegistry()
        fleet = RefReplicaSet(
            lambda: serving_drill._FakePredictor(serving_drill._feed_conf(),
                                                 0.001),
            replicas=1, registry=ref_reg)
        fleet.start(metrics_port=None)
        door = RefFrontDoor(fleet)
        door.start()
        reg = MetricsRegistry()
        sup = RestartSupervisor(budget=100, window=60.0, circuit_reset=60.0,
                                registry=reg)
        lb = LBClient(StaticResolver(["127.0.0.1:1",
                                      f"127.0.0.1:{door.port}"],
                                     registry=reg),
                      supervisor=sup, registry=reg)
        try:
            assert lb.predict_lines(_lines(3), deadline_ms=5000.0) == \
                [0.5] * 3
            assert reg.counter("serving.failover_retries").get() == 1
            assert lb._ping(lb._hosts[f"127.0.0.1:{door.port}"])
            with pytest.raises(RuntimeError, match="server error"):
                lb.predict_lines(["not a parseable slot line"])
        finally:
            lb.stop()
            door.stop()
            fleet.stop()

    def test_reference_lb_against_port_front_door(self):
        reg = MetricsRegistry()
        fleet, door = _door(reg)
        ref_reg = RefRegistry()
        lb = RefLBClient(RefStaticResolver([f"127.0.0.1:{door.port}"],
                                           registry=ref_reg),
                         registry=ref_reg)
        try:
            assert lb.predict_lines(_lines(3), deadline_ms=5000.0) == \
                [0.5] * 3
            assert lb._ping(lb._hosts[f"127.0.0.1:{door.port}"])
            with pytest.raises(RuntimeError, match="server error"):
                lb.predict_lines(["not a parseable slot line"])
            assert ref_reg.counter("serving.lb.picks").get() == 2
        finally:
            lb.stop()
            door.stop()
            fleet.stop()


# -- spawned hosts ------------------------------------------------------------

class TestServingHost:
    def test_spawn_serve_launches_drain(self):
        host = ServingHost("h-unit", host_spec(count_launches=True),
                           registry=MetricsRegistry())
        try:
            assert host.alive() and host.pgid == host.child_pid
            assert host.pgid != os.getpgrp()
            doc = host.health()
            assert doc["ok"] and doc["healthy"] == 1
            with socket.create_connection(("127.0.0.1", host.port),
                                          timeout=10.0) as s:
                f = s.makefile("rwb")
                for _ in range(2):
                    f.write((json.dumps({"lines": _lines(2)})
                             + "\n").encode())
                    f.flush()
                    assert len(json.loads(f.readline())["scores"]) == 2
            # each batch counted; reset to 0 after the read
            assert host.launch_counts(reset=True) == {"seqpool_cvm_cuda": 2}
            assert host.launch_counts() == {"seqpool_cvm_cuda": 0}
            host.drain(timeout=5.0)
            assert host.draining
            assert wait(lambda: not host.alive(), timeout=15.0)
        finally:
            host.stop()

    def test_kill_group_takes_the_replica_grandchild(self):
        """A process-scope host: SIGKILL of its group takes the host and
        its replica child, the parent survives."""
        host = ServingHost("h-kill", host_spec(scope="process"),
                           registry=MetricsRegistry())
        try:
            pgid = host.pgid
            assert host.launch_counts() == {}
            host.kill_group()
            assert wait(lambda: not host.alive(), timeout=15.0)
            assert wait(lambda: not pgid_alive(pgid), timeout=15.0)
        finally:
            host.stop()

    def test_lifeline_ends_the_host_when_its_parent_dies(self, tmp_path):
        res = subprocess.run([sys.executable, "-c", textwrap.dedent(f"""
            import os, sys
            sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, "tests")!r}]
            from torch_serving_fakes import fake_spec
            from paddlebox_tpu_torch.serving import ServingHost
            if __name__ == "__main__":
                h = ServingHost("h-orphan", {{"scope": "thread",
                                "worker_spec": fake_spec()}})
                print(h.pgid, flush=True)
                os._exit(0)
        """)], capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        pgid = int(res.stdout.split()[0])
        assert wait(lambda: not pgid_alive(pgid), timeout=30.0)

    def test_spawn_failures_raise_host_spawn_error(self, tmp_path,
                                                   clean_injector):
        poison = tmp_path / "poison"
        poison.write_text("x")
        with pytest.raises(HostSpawnError, match="before handshake"):
            ServingHost("h-bad", host_spec(poison_path=str(poison)),
                        registry=MetricsRegistry())
        faults.install_injector(faults.FaultInjector(
            seed=0, fail_rate=1.0, ops={"serve.host_spawn"}))
        with pytest.raises(OSError, match="serve.host_spawn"):
            ServingHost("h-fault", host_spec(), registry=MetricsRegistry())


# -- fleets of hosts behind a resolver and an LB -------------------------------

def stack(root, reg, spec, hosts=2, probe=0.2):
    path = os.path.join(str(root), "endpoints.json")
    hf = HostFleet(spec, hosts=hosts, resolver_path=path, registry=reg,
                   probe_interval=probe).start()
    res = FileResolver(path, poll_s=0.1, registry=reg)
    lb = LBClient(res, registry=reg, probe_interval=probe).start()
    return hf, res, lb


class Traffic:
    """``clients`` threads, each sending ``chunks`` through the LB."""

    def __init__(self, lb, chunks, clients=4, pause_s=0.0):
        self.scores = [None] * len(chunks)
        self.failures = []
        self.done = 0
        self._lock = threading.Lock()

        def client(c):
            for i in range(c, len(chunks), clients):
                try:
                    s = lb.predict_lines(chunks[i], deadline_ms=20000.0)
                except Exception as e:  # noqa: BLE001 - asserted on
                    with self._lock:
                        self.failures.append(f"{type(e).__name__}: {e}")
                    continue
                with self._lock:
                    self.scores[i] = s
                    self.done += 1
                time.sleep(pause_s)

        self.threads = [threading.Thread(target=client, args=(c,),
                                         daemon=True)
                        for c in range(clients)]
        for t in self.threads:
            t.start()

    def join(self):
        for t in self.threads:
            t.join(timeout=120.0)


def test_host_fleet_scores_match_reference_through_a_host_kill(tmp_path):
    """Two hosts of a thread-scope ``CTRPredictor`` on the CPU over a
    DeepFM(hidden=(16,)) bundle the JAX package exports: the LB's scores
    equal the reference predictor's (rtol 1e-5); a killpg of one host under
    traffic fails no request, the monitor republishes a newer generation
    and restarts the host; the fleet view scrapes both hosts' launches."""
    bundle, _table, _leaves = W.jax_bundle(str(tmp_path), hidden=(16,))
    ls = _lines(96, seed=3)
    # a request of B=8 lines is one batch: no two requests share one
    chunks = [ls[i:i + W.B] for i in range(0, len(ls), W.B)]
    jp = JaxPredictor(bundle)
    from paddlebox_tpu.data.parser import SlotParser as JaxParser
    jparser = JaxParser(jp.feed_conf)
    want = [jp.predict_records([jparser.parse_line(ln) for ln in c])
            for c in chunks]
    reg = MetricsRegistry()
    spec = {"scope": "thread", "replicas": 1,
            "worker_spec": {"bundle": bundle, "device": "cpu"}}
    hf, res, lb = stack(tmp_path, reg, spec)
    try:
        assert len(hf.endpoints()) == 2 and hf.generation == 1
        first = Traffic(lb, chunks[:6])
        first.join()
        assert not first.failures, first.failures
        fm = FleetMetrics(interval=60.0)
        fm.add_host_fleet(hf)
        assert fm.scrape_once() > 0
        served = [fm.registry.gauge(
            f"fleet.hosts.{h.name}.pbx_serving_requests").get()
            for h in hf.hosts]
        assert sum(served) == 6
        # on the CPU the pool is the plain version: no kernel launch
        assert [fm.registry.gauge(
            f"fleet.hosts.{h.name}.pbx_serve_launches_seqpool_cvm_cuda"
        ).get() for h in hf.hosts if h.name in
            {n for n, v in zip(("h0", "h1"), served) if v}] == \
            [0.0] * sum(1 for v in served if v)
        gen0, victim = hf.generation, hf.hosts[0]
        restarts0 = reg.counter("serving.host_restarts").get()
        second = Traffic(lb, chunks[6:], pause_s=0.05)
        assert wait(lambda: second.done >= 2, timeout=30.0)
        hf.kill_host(0)
        assert wait(lambda: reg.counter("serving.host_restarts").get()
                    > restarts0 and len(hf.endpoints()) == 2, timeout=60.0)
        second.join()
        assert not second.failures, second.failures
        assert hf.generation > gen0 + 1          # unpublished, republished
        assert hf.hosts[0].pgid != victim.pgid
        assert wait(lambda: not pgid_alive(victim.pgid), timeout=15.0)
        got = first.scores + second.scores
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)
    finally:
        lb.stop()
        res.stop()
        hf.stop()


def test_rolling_drain_is_invisible_then_add_host(tmp_path):
    reg = MetricsRegistry()
    hf, res, lb = stack(tmp_path, reg, host_spec())
    try:
        traffic = Traffic(lb, [_lines(4, seed=s) for s in range(60)],
                          clients=3, pause_s=0.01)
        assert wait(lambda: traffic.done >= 5, timeout=30.0)
        gen0 = hf.generation
        hf.decommission(0, grace=0.4)
        assert wait(lambda: len(lb.hosts()) == 1, timeout=10.0)
        assert hf.generation == gen0 + 1
        slot = hf.add_host()
        assert slot == 2 and hf.hosts[2].name == "h2"
        assert wait(lambda: len(lb.hosts()) == 2, timeout=10.0)
        traffic.join()
        assert not traffic.failures, traffic.failures
        assert len(hf.endpoints()) == 2
        # the monitor does not respawn a decommissioned slot
        assert hf._probe_once() == 0 and hf.hosts[0] is None
        doc = hf.health()
        assert [h["up"] for h in doc["hosts"]] == [False, True, True]
        assert reg.gauge("serving.hosts").get() == 2
        assert reg.gauge("serving.hosts_down").get() == 0
    finally:
        lb.stop()
        res.stop()
        hf.stop()


def test_resolver_chaos_never_flaps_or_admits_garbage(tmp_path):
    """The reference drill's ``resolver_chaos``: torn writes, rollbacks
    naming a bogus endpoint, empty sets and duplicates race a live LB's
    watcher; no failure, no flap, no bogus endpoint, generations only
    increase."""
    reg = MetricsRegistry()
    hf, res, lb = stack(tmp_path, reg, host_spec())
    path = os.path.join(str(tmp_path), "endpoints.json")
    bogus = "127.0.0.1:1"
    seen = []
    res.subscribe(lambda gen, eps: seen.append((gen, eps)))
    stop = threading.Event()

    def chaos_writer():
        rng = np.random.default_rng(15)
        good = list(hf.endpoints())
        gen = hf.generation
        while not stop.is_set():
            roll = int(rng.integers(0, 4))
            if roll == 0:
                with open(path, "wb") as f:
                    f.write(b'{"generation": 999, "endpo')
            elif roll == 1:
                write_endpoints(path, [bogus], 0)
            elif roll == 2:
                write_endpoints(path, [], gen + 1000)
            else:
                gen += 1
                write_endpoints(path, good + good, gen)
            time.sleep(0.01)
        write_endpoints(path, good, gen + 1)

    try:
        traffic = Traffic(lb, [_lines(4, seed=s) for s in range(90)],
                          clients=3, pause_s=0.005)
        w = threading.Thread(target=chaos_writer, daemon=True)
        w.start()
        traffic.join()
        # the watcher polls every 0.1 s: let it meet each kind of garbage
        assert wait(lambda: reg.counter(
            "serving.resolver.torn_reads").get() >= 1 and reg.counter(
            "serving.resolver.rejected").get() >= 1, timeout=20.0)
        stop.set()
        w.join(timeout=10.0)
        res.poll()
        assert not traffic.failures, traffic.failures
        gens = [g for g, _ in seen]
        assert all(a < b for a, b in zip(gens, gens[1:]))
        assert not any(bogus in eps for _, eps in seen)
        assert all(len(eps) == 2 for _, eps in seen)
        assert len(lb.hosts()) == 2
        assert reg.counter("serving.resolver.torn_reads").get() >= 1
        assert reg.counter("serving.resolver.rejected").get() >= 1
    finally:
        lb.stop()
        res.stop()
        hf.stop()


# -- the fleet view -----------------------------------------------------------

class StandInShards:
    """A shard service's ``stats()`` surface (one dict a shard)."""

    def stats(self):
        return [{"rows": 10, "pulls": {"keys": 7}, "ok": True},
                {"rows": 12, "pulls": {"keys": 9}, "ok": False},
                "not a dict"]


def test_fleet_metrics_over_registry_shards_and_hosts(tmp_path):
    import urllib.request
    local = MetricsRegistry()
    local.add("trainer.steps", 5)
    local.observe("trainer.step_ms", 2.0)
    reg = MetricsRegistry()
    hf = HostFleet(host_spec(count_launches=True), hosts=2, registry=reg,
                   probe_interval=60.0)
    fm = FleetMetrics(interval=0.05)
    try:
        for h in hf.hosts:
            with socket.create_connection(("127.0.0.1", h.port),
                                          timeout=10.0) as s:
                f = s.makefile("rwb")
                f.write((json.dumps({"lines": _lines(2)}) + "\n").encode())
                f.flush()
                assert len(json.loads(f.readline())["scores"]) == 2
        fm.add_registry("local", local).add_shard_service(StandInShards())
        fm.add_host_fleet(hf)
        fm.add_source("broken", lambda: 1 / 0)
        assert fm.scrape_once() > 0
        g = fm.registry.gauge
        assert g("fleet.local.trainer.steps").get() == 5
        assert g("fleet.local.trainer.step_ms.count").get() == 1
        assert g("fleet.ps.shard0.rows").get() == 10
        assert g("fleet.ps.shard1.pulls.keys").get() == 9
        assert g("fleet.ps.shard1.ok").get() == 0.0
        for h in hf.hosts:
            assert g(f"fleet.hosts.{h.name}.pbx_serve_launches_"
                     "seqpool_cvm_cuda").get() == 1
        errors = fm.registry.counter("fleet.scrape_errors")
        assert errors.get() == 1
        # a dead host contributes nothing and fails nothing
        hf.kill_host(1)
        assert wait(lambda: not hf.hosts[1].alive(), timeout=15.0)
        fm.scrape_once()
        assert errors.get() == 2                 # the broken source only
        addr = fm.serve()
        assert wait(lambda: fm.registry.counter("fleet.scrapes").get() >= 4,
                    timeout=10.0)
        page = urllib.request.urlopen(
            f"http://{addr[0]}:{addr[1]}/metrics", timeout=10).read().decode()
        assert "pbx_fleet_local_trainer_steps 5" in page
        assert "pbx_fleet_hosts_h0_pbx_serve_launches_seqpool_cvm_cuda" \
            in page
    finally:
        fm.stop()
        hf.stop()


def test_host_tier_flags_and_spec_flags(tmp_path, monkeypatch):
    """The flags' reference defaults, read from ``PBOX_FLAGS_*``; a spec's
    ``flags`` reach the host child."""
    from paddlebox_tpu import flags as ref_flags
    from paddlebox_tpu_torch.config import FLAG_DEFAULTS, flag
    for name in ("serve_hosts", "serve_resolver_poll",
                 "serve_lb_probe_interval", "serve_lb_eject_reset",
                 "obs_fleet_interval"):
        assert FLAG_DEFAULTS[name] == ref_flags.get(name)
    monkeypatch.setenv("PBOX_FLAGS_serve_resolver_poll", "0.25")
    monkeypatch.setenv("PBOX_FLAGS_serve_lb_eject_reset", "7.5")
    assert flag("serve_resolver_poll") == 0.25
    assert FileResolver(str(tmp_path / "e.json"),
                        registry=MetricsRegistry()).poll_s == 0.25
    lb = LBClient(StaticResolver(["127.0.0.1:1"], registry=MetricsRegistry()),
                  registry=MetricsRegistry())
    assert lb.supervisor.circuit_reset == 7.5
    monkeypatch.setenv("PBOX_FLAGS_serve_hosts", "0")
    with pytest.raises(ValueError, match="at least one host"):
        HostFleet(host_spec(), registry=MetricsRegistry())
