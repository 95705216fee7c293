"""The port's single-host serving tier in thread scope, on the CPU:
``serving/batcher.py`` (the deadline close rules, bounded queue, death and
drain), the router, ``ReplicaSet`` (spread, kill and restart, drain,
``/healthz``, shedding), ``inference/server.py`` ``PredictServer`` (its
line protocol, idle guard, SLO shedding) and ``serving/frontdoor.py``; the
reference's behavioural cases of ``tests/test_serving.py``,
``test_serving_proc.py`` and ``test_obs_closed_loop.py`` run on the port,
with stand-in predictors.

Against the reference, over a bundle the JAX package exports: the same
lines through the reference's ``PredictServer`` and ``ReplicaSet`` and the
port's (``device="cpu"``, and the port's ``FrontDoor``) score within 1e-5
(float32 GEMMs in another order); ``fwd_fingerprint`` is equal and unequal
on the same bundle pairs as the reference's."""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddlebox_tpu.data.parser import SlotParser as JaxParser
from paddlebox_tpu.inference.predictor import CTRPredictor as JaxPredictor
from paddlebox_tpu.inference.server import PredictServer as JaxServer
from paddlebox_tpu.obs.metrics import REGISTRY as REF_REGISTRY
from paddlebox_tpu.serving import ReplicaSet as JaxReplicaSet
from paddlebox_tpu_torch.data.parser import SlotParser
from paddlebox_tpu_torch.data.record import SlotRecord
from paddlebox_tpu_torch.inference.predictor import CTRPredictor
from paddlebox_tpu_torch.inference.server import (PredictServer,
                                                  predict_lines)
from paddlebox_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from paddlebox_tpu_torch.obs.slo import Rule, SloEngine
from paddlebox_tpu_torch.serving import (DeadlineBatcher, FrontDoor,
                                         Overloaded, ReplicaDead,
                                         ReplicaSet, RequestExpired, Router,
                                         SheddingLoad)
from torch_serving_fakes import FakePredictor, feed_conf, lines
import torch_serving_world as W

ATOL = 1e-5


def fake(delay=0.001, version="t/00001"):
    return FakePredictor(feed_conf(), delay, version=version)


def rec():
    return SlotRecord()


def wait_dead(replica, timeout=5.0):
    deadline = time.monotonic() + timeout
    while replica.alive() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not replica.alive()


# -- the deadline batcher ----------------------------------------------------

def batcher(score, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("margin_ms", 20.0)
    kw.setdefault("max_pending", 16)
    kw.setdefault("registry", MetricsRegistry())
    b = DeadlineBatcher(score, **kw)
    b.start()
    return b


def sizing():
    sizes = []

    def score(records):
        sizes.append(len(records))
        return np.zeros(len(records), np.float32)
    return sizes, score


def test_deadline_closes_batch_before_fill_wait():
    sizes, score = sizing()
    b = batcher(score, batch_wait_ms=30_000.0)
    try:
        t0 = time.perf_counter()
        b.submit([rec()], time.monotonic() + 0.3).result(timeout=5.0)
        elapsed = time.perf_counter() - t0
    finally:
        b.stop(drain_timeout=0.5)
    assert elapsed < 2.0 and sizes == [1]


def test_full_batch_closes_on_size():
    sizes, score = sizing()
    b = batcher(score, max_batch=4, batch_wait_ms=30_000.0)
    try:
        t0 = time.perf_counter()
        b.submit([rec() for _ in range(4)],
                 time.monotonic() + 60.0).result(timeout=5.0)
        elapsed = time.perf_counter() - t0
    finally:
        b.stop(drain_timeout=0.5)
    assert elapsed < 1.0 and sizes == [4]


def test_tight_deadline_drags_shared_batch_forward():
    sizes, score = sizing()
    b = batcher(score, batch_wait_ms=30_000.0)
    try:
        relaxed = b.submit([rec()], time.monotonic() + 30.0)
        time.sleep(0.02)
        tight = b.submit([rec()], time.monotonic() + 0.3)
        relaxed.result(timeout=5.0)
        tight.result(timeout=1.0)
    finally:
        b.stop(drain_timeout=0.5)
    assert sizes == [2]


def test_expired_request_refused_at_admission():
    sizes, score = sizing()
    reg = MetricsRegistry()
    b = batcher(score, registry=reg)
    try:
        with pytest.raises(RequestExpired):
            b.submit([rec()], time.monotonic() - 0.01)
    finally:
        b.stop(drain_timeout=0.5)
    assert sizes == [] and reg.counter("serving.expired").get() == 1


def test_bounded_queue_rejects_fast():
    release = threading.Event()

    def score(records):
        release.wait(5.0)
        return np.zeros(len(records), np.float32)

    reg = MetricsRegistry()
    b = batcher(score, max_pending=1, registry=reg)
    try:
        deadline = time.monotonic() + 10.0
        b.submit([rec()], deadline)
        time.sleep(0.1)
        b.submit([rec()], deadline)
        with pytest.raises(Overloaded):
            b.submit([rec()], deadline)
        assert reg.counter("serving.overloaded").get() == 1
    finally:
        release.set()
        b.stop(drain_timeout=1.0)


def test_die_fails_stranded_queue_and_later_submits():
    release = threading.Event()

    def score(records):
        release.wait(5.0)
        return np.zeros(len(records), np.float32)

    b = batcher(score)
    inflight = b.submit([rec()], time.monotonic() + 30.0)
    time.sleep(0.1)
    stranded = b.submit([rec()], time.monotonic() + 30.0)
    b.die()
    release.set()
    assert len(inflight.result(timeout=5.0)) == 1
    with pytest.raises(ReplicaDead):
        stranded.result(timeout=5.0)
    for _ in range(200):
        if not b.alive():
            break
        time.sleep(0.01)
    with pytest.raises(ReplicaDead):
        b.submit([rec()], time.monotonic() + 30.0)


def test_stop_drains_pending_work_and_scorer_errors_fail_the_batch():
    def score(records):
        time.sleep(0.02)
        if len(records) == 3:
            raise ValueError("bad batch")
        return np.zeros(len(records), np.float32)

    b = batcher(score, max_batch=1)
    futs = [b.submit([rec()], time.monotonic() + 10.0) for _ in range(3)]
    bad = b.submit([rec(), rec(), rec()], time.monotonic() + 10.0)
    b.stop(drain_timeout=5.0)
    for f in futs:
        assert len(f.result(timeout=0.1)) == 1
    with pytest.raises(ValueError, match="bad batch"):
        bad.result(timeout=0.1)


# -- the router --------------------------------------------------------------

class Stub:
    def __init__(self, name, depth, alive=True):
        self.name, self._depth, self._alive = name, depth, alive

    def alive(self):
        return self._alive

    def outstanding(self):
        return self._depth


def test_router_least_outstanding_dead_and_excluded():
    reg = MetricsRegistry()
    r = Router(registry=reg)
    assert r.pick([Stub("a", 5), Stub("b", 1), Stub("c", 3)]).name == "b"
    reps = [Stub("a", 0, alive=False), Stub("b", 9), Stub("c", 2)]
    assert r.pick(reps).name == "c"
    assert r.pick(reps, exclude={"c"}).name == "b"
    assert r.pick(reps, exclude={"b", "c"}) is None
    assert reg.gauge("serving.router_queue_depth").get() == 11


# -- the thread-scope fleet --------------------------------------------------

def test_fleet_spreads_over_replicas():
    reg = MetricsRegistry()
    errors = []
    with ReplicaSet(lambda: fake(delay=0.02), replicas=2,
                    probe_interval=5.0, registry=reg) as fs:
        def client(i):
            try:
                out = fs.predict_lines(lines(np.random.default_rng(i), 2),
                                       deadline_ms=5000.0)
                assert out.shape == (2,)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    served = [reg.histogram(f"serving.replica.r{i}.dispatch_ms").count
              for i in range(2)]
    assert errors == [] and all(c > 0 for c in served), served
    assert reg.counter("serving.requests").get() == 12
    assert reg.histogram("serve.request_ms").count == 12


def test_kill_reroutes_and_probe_restarts():
    reg = MetricsRegistry()
    with ReplicaSet(lambda: fake(), replicas=2, probe_interval=60.0,
                    registry=reg) as fs:
        fs.replicas[0].kill()
        wait_dead(fs.replicas[0])
        for i in range(4):
            fs.predict_lines(lines(np.random.default_rng(i), 2),
                             deadline_ms=2000.0)
        assert fs.healthy_count() == 1
        assert fs._probe_once() == 1
        assert fs.healthy_count() == 2
        assert reg.counter("serving.replica_restarts").get() == 1
        assert reg.counter("serving.replica_deaths").get() == 1


def test_restart_failure_leaves_slot_for_next_tick():
    reg = MetricsRegistry()
    state = {"fail": False}

    def factory():
        if state["fail"]:
            raise RuntimeError("bundle mid-rewrite")
        return fake()

    with ReplicaSet(factory, replicas=2, probe_interval=60.0,
                    registry=reg) as fs:
        fs.replicas[0].kill()
        wait_dead(fs.replicas[0])
        state["fail"] = True
        assert fs._probe_once() == 0
        assert reg.counter("serving.replica_restart_failures").get() == 1
        state["fail"] = False
        assert fs._probe_once() == 1 and fs.healthy_count() == 2


def test_no_healthy_replica_is_loud_and_drain_on_stop():
    with ReplicaSet(lambda: fake(), replicas=1, probe_interval=60.0) as fs:
        fs.replicas[0].kill()
        wait_dead(fs.replicas[0])
        with pytest.raises(Exception) as ei:
            fs.predict_lines(lines(np.random.default_rng(0), 2),
                             deadline_ms=300.0)
        assert "replica" in str(ei.value).lower()
    fs = ReplicaSet(lambda: fake(delay=0.03), replicas=1,
                    probe_interval=60.0)
    fs.start()
    futs = [fs.replicas[0].submit([rec()], time.monotonic() + 10.0)
            for _ in range(3)]
    fs.stop(drain_timeout=5.0)
    for f in futs:
        assert len(f.result(timeout=0.1)) == 1


def test_fleet_healthz_endpoint_and_ephemeral_ports():
    a = ReplicaSet(lambda: fake(), replicas=2, probe_interval=60.0,
                   registry=MetricsRegistry())
    b = ReplicaSet(lambda: fake(), replicas=1, probe_interval=60.0,
                   registry=MetricsRegistry())
    try:
        a.start(metrics_port=0)
        b.start(metrics_port=0)
        assert a.metrics_address[1] != b.metrics_address[1]
        docs = {}
        for name, fs in (("a", a), ("b", b)):
            host, port = fs.metrics_address
            rep = urllib.request.urlopen(f"http://{host}:{port}/healthz",
                                         timeout=5)
            assert rep.status == 200
            docs[name] = json.loads(rep.read())
        assert docs["a"]["size"] == 2 and docs["b"]["size"] == 1
        assert docs["a"]["versions"] == ["t/00001"] * 2
        assert docs["a"]["scope"] == "thread"
        assert a._probe_once() == 0
        host, port = a.metrics_address
        body = urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                      timeout=5).read().decode()
        assert "pbx_serving_replica_r1_healthy 1" in body.splitlines()
        a.replicas[0].kill()
        wait_dead(a.replicas[0])
        host, port = a.metrics_address
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://{host}:{port}/healthz",
                                   timeout=5)
        assert ei.value.code == 503
        assert json.loads(ei.value.read())["healthy"] == 1
    finally:
        a.stop(drain_timeout=0.5)
        b.stop(drain_timeout=0.5)


def test_shed_admission_rejects_pre_parse():
    reg = MetricsRegistry()
    engine = SloEngine(registry=reg, interval=3600.0)
    rule = Rule("depth", metric="probe.depth", agg="value", op=">",
                threshold=1.0, labels={"action": "shed"})
    with ReplicaSet(lambda: fake(), replicas=1, probe_interval=60.0,
                    registry=reg) as fs:
        fs.attach_slo(engine, rules=[rule])
        g = reg.gauge("probe.depth")
        g.set(5.0)
        engine.evaluate(now=0.0)
        assert fs.admission.shedding
        with pytest.raises(SheddingLoad):
            fs.predict_lines(["not a parseable line"])
        with pytest.raises(SheddingLoad):
            fs.predict_records([rec()])
        assert reg.counter("serving.shed").get() == 2
        ok, doc = fs.health()
        assert not ok and doc["shedding"]
        assert doc["alerts"]["firing"] == [{"rule": "depth",
                                            "metric": "probe.depth"}]
        g.set(0.0)
        engine.evaluate(now=1.0)
        assert not fs.admission.shedding
        assert fs.predict_lines(lines(np.random.default_rng(0), 2),
                                deadline_ms=2000.0).shape == (2,)
    assert reg.counter("serving.shed_entered").get() == 1
    assert reg.counter("serving.shed_exited").get() == 1


def test_scope_and_factory_validation():
    with pytest.raises(ValueError, match="thread' or 'process"):
        ReplicaSet(lambda: fake(), replicas=1, scope="cluster")
    with pytest.raises(ValueError, match="worker_spec"):
        ReplicaSet(lambda: fake(), replicas=1, scope="process")
    with pytest.raises(ValueError, match="only applies"):
        ReplicaSet(None, replicas=1, scope="thread",
                   worker_spec={"bundle": "x"})
    with pytest.raises(ValueError, match="at least one"):
        ReplicaSet(lambda: fake(), replicas=0)
    with pytest.raises(NotImplementedError, match="A.9"):
        ReplicaSet.from_bundle("x", ps_endpoints=["localhost:1"])


# -- PredictServer -----------------------------------------------------------

def fake_server(**kw):
    return PredictServer("", predictor=fake(), metrics_port=0, **kw)


def test_predict_server_healthz_and_owned_engine():
    srv = fake_server(slo_rules=[Rule("own", metric="some.gauge",
                                      agg="value", op=">", threshold=1.0)])
    assert srv._owns_slo
    with srv:
        host, port = srv.metrics_address
        rep = urllib.request.urlopen(f"http://{host}:{port}/healthz",
                                     timeout=5)
        doc = json.loads(rep.read())
        assert srv._slo._thread is not None
    assert rep.status == 200 and doc["status"] == "ok"
    assert doc["model_version"] == "t/00001"
    assert doc["alerts"] == {"firing_count": 0, "firing": []}
    assert doc["batch_thread_alive"] is True and doc["shedding"] is False
    assert srv._slo._thread is None


def test_predict_server_sheds_on_a_firing_shed_alert():
    eng = SloEngine(registry=MetricsRegistry(), interval=3600.0)
    eng.add_rule(Rule("shed_me", metric="depth", agg="value", op=">",
                      threshold=1.0, labels={"action": "shed"}))
    eng.registry.gauge("depth").set(9.0)
    eng.evaluate(now=0.0)
    srv = fake_server()
    srv.attach_slo(eng)
    assert srv.shedding                     # attached mid-incident
    with srv:
        with pytest.raises(RuntimeError, match="shedding"):
            predict_lines(srv.host, srv.port, ["1 0 1 5 1 7"])
        host, port = srv.metrics_address
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://{host}:{port}/healthz",
                                   timeout=5)
        assert ei.value.code == 503
        eng.registry.gauge("depth").set(0.0)
        eng.evaluate(now=1.0)
        assert not srv.shedding
        assert len(predict_lines(srv.host, srv.port,
                                 ["1 0 1 5 1 7"])) == 1
    assert srv._on_alert not in eng._callbacks    # detached on stop


def test_predict_server_idle_guard_and_timeouts(monkeypatch):
    srv = PredictServer("", predictor=fake(), request_timeout_s=0.3)
    with srv:
        idle = socket.create_connection((srv.host, srv.port))
        stall = socket.create_connection((srv.host, srv.port))
        stall.sendall(b'{"lines": ["1 0 1 5')        # no newline
        before = REGISTRY.counter("serve.idle_disconnects").get()
        time.sleep(0.8)
        for s in (idle, stall):
            s.settimeout(2.0)
            assert s.recv(10) == b""                 # server hung up
            s.close()
        assert REGISTRY.counter("serve.idle_disconnects").get() \
            >= before + 2
        assert len(predict_lines(srv.host, srv.port, ["1 0 1 5 1 7"])) == 1
        with pytest.raises(RuntimeError, match="expired"):
            predict_lines(srv.host, srv.port, ["1 0 1 5 1 7"],
                          deadline_ms=0.0)
        with pytest.raises(RuntimeError, match="non-empty"):
            predict_lines(srv.host, srv.port, [])
    with pytest.raises(ValueError, match="must be > 0"):
        PredictServer("", predictor=fake(), request_timeout_s=0.0)
    monkeypatch.setenv("PBOX_FLAGS_serve_request_timeout", "12.5")
    assert PredictServer("", predictor=fake()).request_timeout_s == 12.5


def test_frontdoor_protocol_ping_errors_and_stop():
    reg = MetricsRegistry()
    with ReplicaSet(lambda: fake(), replicas=2, probe_interval=60.0,
                    registry=reg) as fs:
        door = FrontDoor(fs, request_timeout_s=0.0)   # 0: no idle guard
        with door:
            out = predict_lines(*door.address,
                                lines(np.random.default_rng(1), 5),
                                deadline_ms=5000.0)
            assert out.shape == (5,) and np.all(out == 0.5)
            with socket.create_connection(door.address) as s:
                f = s.makefile("rwb")
                for req in (b'{"ping": true}\n', b"not json\n",
                            b'{"lines": []}\n',
                            json.dumps({"lines": lines(
                                np.random.default_rng(2), 1)}).encode()
                            + b"\n"):
                    f.write(req)
                    f.flush()
                    time.sleep(0.35)          # past a would-be guard
                    reply = json.loads(f.readline())
                    if req.startswith(b'{"ping'):
                        assert reply == {"ok": True, "healthy": 2,
                                         "size": 2}
                    elif b'"lines": []' in req or req.startswith(b"not"):
                        assert "error" in reply
                    else:
                        assert reply == {"scores": [0.5]}
        door.stop()                                   # idempotent
    assert reg.counter("serving.frontdoor_conns").get() == 2


# -- against the reference, over a bundle the JAX package exports -------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("serving"))
    path, _table, _leaves = W.jax_bundle(root)
    other, _, _ = W.jax_bundle(root, "other_weights", seed=5)
    wider, _, _ = W.jax_bundle(root, "wider", seed=1, hidden=(16,))
    return dict(root=root, bundle=path, other=other, wider=wider,
                lines=lines(np.random.default_rng(7), 40))


def concurrent_lines(host, port, chunks):
    out = [None] * len(chunks)

    def client(i):
        out[i] = predict_lines(host, port, chunks[i], deadline_ms=20000.0)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(chunks))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return np.concatenate(out)


def test_predict_server_scores_match_reference(world):
    """Four connections at once through each package's server; the
    port's server also equals a direct ``predict_records`` of the same
    lines."""
    chunks = [world["lines"][i::4] for i in range(4)]
    with JaxServer(world["bundle"]) as ref:
        want = concurrent_lines(ref.host, ref.port, chunks)
    srv = PredictServer(world["bundle"], device="cpu")
    assert str(srv.predictor.device) == "cpu"
    with srv:
        got = concurrent_lines(srv.host, srv.port, chunks)
    assert got.shape == (40,)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    parser = SlotParser(srv.predictor.feed_conf)
    direct = srv.predictor.predict_records(
        [parser.parse_line(ln) for c in chunks for ln in c])
    np.testing.assert_array_equal(got, direct)


def test_replica_set_scores_match_reference(world):
    """The same lines through the reference's thread fleet, the port's
    (``from_bundle`` on the CPU) and the port's front door."""
    ls = world["lines"]
    ref_fleet = JaxReplicaSet.from_bundle(world["bundle"], replicas=2,
                                          probe_interval=60.0)
    with ref_fleet:
        want = np.concatenate([ref_fleet.predict_lines(
            ls[i:i + 5], deadline_ms=20000.0) for i in range(0, 40, 5)])
    reg = MetricsRegistry()
    fleet = ReplicaSet.from_bundle(world["bundle"], replicas=2,
                                   scope="thread", device="cpu",
                                   probe_interval=60.0, registry=reg)
    with fleet:
        fleet.warm(ls[:2])
        got = np.concatenate([fleet.predict_lines(
            ls[i:i + 5], deadline_ms=20000.0) for i in range(0, 40, 5)])
        with FrontDoor(fleet) as door:
            chunks = [ls[i::4] for i in range(4)]
            door_got = concurrent_lines(*door.address, chunks)
        assert fleet.versions() == ["19700101/00000"] * 2
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    direct = CTRPredictor(world["bundle"], device="cpu")
    parser = SlotParser(direct.feed_conf)
    np.testing.assert_array_equal(door_got, direct.predict_records(
        [parser.parse_line(ln) for c in chunks for ln in c]))
    jp = JaxPredictor(world["bundle"])
    jparser = JaxParser(jp.feed_conf)
    np.testing.assert_allclose(
        door_got, jp.predict_records([jparser.parse_line(ln)
                                      for c in chunks for ln in c]),
        rtol=0, atol=ATOL)


def test_fingerprints_match_reference(world):
    """Equal and unequal on the same pairs as the reference's: the same
    bundle, other weights of the same shape, a wider model, another batch
    size; ``reload_of`` counts ``serving.reload_recompiled`` exactly when
    they differ, in both packages."""
    pairs = [(world["bundle"], {}, world["bundle"], {}),
             (world["bundle"], {}, world["other"], {}),
             (world["bundle"], {}, world["wider"], {}),
             (world["bundle"], {}, world["bundle"], {"batch_size": 4})]
    for a_path, a_kw, b_path, b_kw in pairs:
        ja = JaxPredictor(a_path, **a_kw)
        ref_before = REF_REGISTRY.counter("serving.reload_recompiled").get()
        jb = JaxPredictor(b_path, reload_of=ja, **b_kw)
        ref_counted = REF_REGISTRY.counter(
            "serving.reload_recompiled").get() - ref_before
        pa = CTRPredictor(a_path, device="cpu", **a_kw)
        before = REGISTRY.counter("serving.reload_recompiled").get()
        pb = CTRPredictor(b_path, device="cpu", reload_of=pa, **b_kw)
        counted = REGISTRY.counter("serving.reload_recompiled").get() \
            - before
        same = pa.fwd_fingerprint() == pb.fwd_fingerprint()
        assert same == (ja.fwd_fingerprint() == jb.fwd_fingerprint()), \
            (b_path, b_kw)
        assert counted == ref_counted == (0 if same else 1)
    assert CTRPredictor(world["bundle"], device="cpu").fwd_fingerprint() \
        == CTRPredictor(world["other"], device="cpu").fwd_fingerprint()
