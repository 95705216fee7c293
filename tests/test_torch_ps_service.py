"""The port's networked PS service (``ps/sharded.py``, ``ps/service/``,
``config.ps_service_conf``, the ``ps_endpoints`` wiring of serving and the
host-table engine over a ``RemoteTable``, ``tools/ps_drill.py``) against
the JAX package's, on the CPU.

Held to the reference: ``shard_of`` and ``partition_dedup`` on keys with
the high bits set; the flags' validation messages; pulls and pushes bit
for bit against a local ``EmbeddingTable`` of either package; the
reference's service cases (dedup, empty calls, application errors,
at-most-once retries, the cache, retries and the wire version, dead
shards, two dead shards in one retry wall, the lifeline, save, restart and
resume); the port's client driving a reference shard, whose committed
files equal the port shard's array for array and resume in the other
package; ``CTRTrainer`` over a 2-shard ``RemoteTable`` bit for bit against
the local table, its metrics within the trainer tests' 1e-5 of the
reference trainer's; ``CTRPredictor(ps_endpoints=)`` scoring the bundle's
scores exactly; the drill's scenarios and the chaos drill's ``campaign``
over the port's host tier. A shard child's import chain holds no torch."""

import dataclasses
import glob
import multiprocessing
import os
import pickle
import socket
import struct
import subprocess
import sys
import textwrap
import threading
import time

import jax
import numpy as np
import pytest
import torch

from conftest import make_slot_file
from paddlebox_tpu import flags as ref_flags
from paddlebox_tpu.config import DataFeedConfig as JaxFeedConfig
from paddlebox_tpu.config import SlotConfig as JaxSlotConfig
from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.config import TrainerConfig as JaxTrainerConfig
from paddlebox_tpu.config import ps_service_conf as ref_ps_service_conf
from paddlebox_tpu.data.dataset import SlotDataset as JaxSlotDataset
from paddlebox_tpu.inference.predictor import CTRPredictor as JaxPredictor
from paddlebox_tpu.models import DeepFM as FlaxDeepFM
from paddlebox_tpu.obs.metrics import MetricsRegistry as RefRegistry
from paddlebox_tpu.ps import sharded as ref_sharded
from paddlebox_tpu.ps.service import ShardService as RefShardService
from paddlebox_tpu.ps.table import EmbeddingTable as JaxTable
from paddlebox_tpu.trainer import trainer as ref_trainer
from paddlebox_tpu_torch.config import (DataFeedConfig, TableConfig,
                                        TrainerConfig, ps_service_conf)
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.data.parser import SlotParser
from paddlebox_tpu_torch.inference.predictor import CTRPredictor
from paddlebox_tpu_torch.models.convert import deepfm_from_flax_leaves
from paddlebox_tpu_torch.obs.fleet import FleetMetrics
from paddlebox_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from paddlebox_tpu_torch.ps import sharded
from paddlebox_tpu_torch.ps.server import SparsePS
from paddlebox_tpu_torch.ps.service import (RemotePS, RemoteTable,
                                            ServiceClient, ShardService,
                                            ShardUnavailable)
from paddlebox_tpu_torch.ps.service.client import RemoteError
from paddlebox_tpu_torch.ps.service.shard_server import ShardSpawnError
from paddlebox_tpu_torch.ps.sharded import ShardedTable, shard_of
from paddlebox_tpu_torch.ps.table import EmbeddingTable
from paddlebox_tpu_torch.serving import transport
from paddlebox_tpu_torch.tools import ps_drill
from paddlebox_tpu_torch.trainer.trainer import CTRTrainer
from paddlebox_tpu_torch.utils import faults
import torch_serving_world as W
from torch_serving_fakes import fake_spec, lines

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLE = dict(embedx_dim=4, cvm_offset=3, optimizer="adam",
             learning_rate=0.05, embedx_threshold=0.0, seed=3)
TABLE_CONF = TableConfig(**TABLE)


@pytest.fixture(scope="module")
def svc():
    """One 2-shard service for the unit cases (disjoint key ranges)."""
    service = ShardService({"embedding": TABLE_CONF}, num_shards=2,
                           registry=MetricsRegistry())
    yield service
    service.stop()


def _client(endpoints, **kw):
    kw.setdefault("deadline_s", 15.0)
    kw.setdefault("retries", 1)
    kw.setdefault("registry", MetricsRegistry())
    return ServiceClient(list(endpoints), **kw)


def _grads(rng, n, dim=TABLE_CONF.pull_dim):
    g = rng.normal(0, 0.1, (n, dim)).astype(np.float32)
    g[:, 0] = 1.0
    return g


def _sorted_snapshot(table):
    snap = table.snapshot(reset_dirty=False)
    order = np.argsort(snap["keys"], kind="stable")
    return {k: v[order] for k, v in snap.items()}


def _assert_snapshots_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype


# -- ownership and routing ---------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2, 3, 4, 7])
def test_shard_of_and_partition_match_reference(shards):
    rng = np.random.default_rng(shards)
    keys = np.concatenate([
        rng.integers(0, 1 << 63, 500, dtype=np.uint64) | np.uint64(1 << 63),
        rng.integers(1, 3000, 500).astype(np.uint64),
        np.array([0, 1, (1 << 64) - 1, 1 << 63, 5, 5], np.uint64)])
    np.testing.assert_array_equal(sharded.shard_of(keys, shards),
                                  ref_sharded.shard_of(keys, shards))
    b, inv = sharded.partition_dedup(keys, shards)
    rb, rinv = ref_sharded.partition_dedup(keys, shards)
    assert len(b) == len(rb) == shards
    for x, y in zip(b, rb):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(inv, rinv)
    np.testing.assert_array_equal(np.concatenate(b)[inv], keys)


def test_sharded_table_matches_one_table_and_sparse_ps_saves_it(tmp_path):
    """In process, the sharded table trains like one table; a
    ``SparsePS`` saves and loads it shard by shard as the reference's
    (``<table>.npz.shard-NNNNN.npz``)."""
    conf = dataclasses.replace(TABLE_CONF, num_shards=3)
    rng = np.random.default_rng(1)
    st, one = ShardedTable(conf), EmbeddingTable(TABLE_CONF)
    for _ in range(3):
        keys = rng.integers(1, 400, 256).astype(np.uint64)
        np.testing.assert_array_equal(st.pull(keys), one.pull(keys))
        g = _grads(rng, keys.size)
        st.push(keys, g)
        one.push(keys, g)
    assert len(st) == len(one)
    ps = SparsePS({"embedding": st})
    path = ps.save_base(str(tmp_path), "d", 1)
    assert sorted(f for f in os.listdir(path) if f.endswith(".npz")) == \
        [f"embedding.npz.shard-{i:05d}.npz" for i in range(3)]
    st2 = ShardedTable(conf)
    SparsePS({"embedding": st2}).load_base(path)
    keys = np.unique(rng.integers(1, 400, 300).astype(np.uint64))
    np.testing.assert_array_equal(st2.pull(keys, create=False),
                                  one.pull(keys, create=False))


# -- flags -------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"ps_service_shards": 0}, {"ps_service_deadline": 0.0},
    {"ps_service_deadline": -1.0}, {"ps_service_retries": -1},
    {"ps_service_cache_rows": -4}, {"ps_service_cache_rows": 8},
    {"ps_service_spawn_timeout": 0.0}, {"ps_service_cache_rows": 64},
    {"ps_service_cache_rows": 64, "enable_pull_padding_zero": False},
])
def test_ps_service_conf_matches_reference(kw, monkeypatch):
    old = {k: ref_flags.get(k) for k in kw}
    outs = []
    try:
        for k, v in kw.items():
            ref_flags.set(k, v)
            monkeypatch.setenv("PBOX_FLAGS_" + k, str(v))
        for fn in (ref_ps_service_conf, ps_service_conf):
            try:
                outs.append(dataclasses.astuple(fn()))
            except ValueError as e:
                outs.append(str(e))
    finally:
        for k, v in old.items():
            ref_flags.set(k, v)
    assert outs[0] == outs[1]
    if not kw:
        assert outs[1] == (2, 5.0, 3, 0, 60.0)


# -- the service --------------------------------------------------------------

def test_pull_push_bit_for_bit_with_local_tables(svc):
    rng = np.random.default_rng(0)
    client = _client(svc.endpoints())
    remote = RemoteTable(TABLE_CONF, client, cache_rows=0)
    local = EmbeddingTable(TABLE_CONF)
    ref = JaxTable(JaxTableConfig(**TABLE))
    keys = rng.integers(1000, 2000, 600).astype(np.uint64)
    for _ in range(2):
        v = remote.pull(keys)
        np.testing.assert_array_equal(v, local.pull(keys))
        np.testing.assert_array_equal(v, ref.pull(keys))
        g = _grads(rng, keys.size)
        for t in (remote, local, ref):
            t.push(keys, g)
    np.testing.assert_array_equal(remote.pull(keys), local.pull(keys))
    np.testing.assert_array_equal(remote.pull(keys), ref.pull(keys))
    reg = client.registry
    assert reg.counter("ps.remote.bytes_out").get() > 0
    assert reg.counter("ps.remote.bytes_in").get() > 0
    client.close()


def test_partition_dedup_empty_calls_and_errors(svc):
    client = _client(svc.endpoints())
    remote = RemoteTable(TABLE_CONF, client, cache_rows=0)
    keys = np.array([5, 5, 9, 9, 9, 12, 5], dtype=np.uint64)
    buckets, inverse = remote._partition(keys)
    assert sum(b.size for b in buckets) == 3
    np.testing.assert_array_equal(np.concatenate(buckets)[inverse], keys)
    assert remote.pull(np.empty(0, np.uint64)).shape == \
        (0, TABLE_CONF.pull_dim)
    remote.push(np.empty(0, np.uint64),
                np.empty((0, TABLE_CONF.pull_dim), np.float32))
    with pytest.raises(ValueError, match="push grads shape"):
        remote.push(keys, np.zeros((2, 2), np.float32))
    # an application error: RemoteError, no retry, the shard is fine
    with pytest.raises(RemoteError, match="nosuch"):
        client.request(0, ("pull", "nosuch", np.array([1], np.uint64),
                           True))
    assert client.request(0, ("health",))["ok"] is True
    assert client.registry.counter("ps.remote.shard_unavailable").get() \
        == 0
    # an error mid-exchange leaves the other shard's connection clean
    with pytest.raises(RemoteError, match="nosuch"):
        client.exchange({0: ("pull", "nosuch", np.array([1], np.uint64),
                             True), 1: ("health",)})
    out = client.request(1, ("stats",))
    assert "num_features" in out and out["shard"] == 1
    assert [h["shard"] for h in client.health()] == [0, 1]
    client.close()


def test_retry_of_executed_push_is_deduped(svc):
    """A re-sent (cid, seq) on a fresh connection replays the stored reply
    and does not apply the push twice."""
    keys = np.arange(6700, 6750, dtype=np.uint64)
    g = np.zeros((keys.size, TABLE_CONF.pull_dim), np.float32)
    g[:, 0] = 1.0
    host, port = svc.endpoints()[0].rsplit(":", 1)
    wire = ("req", "dedup-test-cid", 1, ("push", "embedding", keys, g))

    def send_on_fresh_conn(msg):
        s = socket.create_connection((host, int(port)), timeout=10)
        try:
            transport.send_obj(s, msg)
            return transport.recv_obj(s)
        finally:
            s.close()

    first = send_on_fresh_conn(wire)
    assert first == ("ok", keys.size)
    assert send_on_fresh_conn(wire) == first
    status, vals = send_on_fresh_conn(
        ("req", "dedup-test-cid", 2, ("pull", "embedding", keys, False)))
    assert status == "ok"
    np.testing.assert_array_equal(vals[:, 0],
                                  np.ones(keys.size, np.float32))


def test_feed_stats_import_snapshot_and_lifecycle(svc):
    rng = np.random.default_rng(1)
    client = _client(svc.endpoints())
    remote = RemoteTable(TABLE_CONF, client, cache_rows=0)
    before = len(remote)
    remote.feed_pass(np.arange(3000, 3400, dtype=np.uint64))
    assert len(remote) == before + 400
    remote.pull(np.arange(4000, 4050, dtype=np.uint64), create=False)
    assert len(remote) == before + 400
    stats = svc.stats()
    assert {s["shard"] for s in stats} == {0, 1}
    assert all(s["pid"] > 0 for s in stats) and remote.memory_bytes() > 0
    src = EmbeddingTable(TABLE_CONF)
    keys = np.arange(5000, 5200, dtype=np.uint64)
    src.feed_pass(keys)
    src.push(keys, _grads(rng, keys.size))
    vals, state = src.export_rows(keys, create=False)
    remote.import_rows(keys, vals, state, mode="set")
    np.testing.assert_array_equal(remote.pull(keys, create=False),
                                  src.pull(keys, create=False))
    snap = remote.merged_snapshot()
    assert np.all(np.diff(snap["keys"].astype(np.uint64)) > 0)
    assert set(snap) == {"keys", "values", "state", "embedx_ok"}
    ps = RemotePS(client, {"embedding": TABLE_CONF}, cache_rows=0)
    ps.begin_pass(7)
    with pytest.raises(RuntimeError, match="still open"):
        ps.begin_pass(8)
    assert {s["pass"] for s in svc.stats()} == {7}
    ps.end_pass()
    assert ps.current_pass is None
    assert set(ps.num_features()) == {"embedding"}
    assert ps.memory_bytes() == remote.memory_bytes()
    client.close()


def test_cache_in_front_of_pull(svc):
    """Hits skip the wire and stay exact; a push drops its keys (also on a
    partial failure, below); a pass end clears the cache."""
    rng = np.random.default_rng(4)
    client = _client(svc.endpoints())
    plain = RemoteTable(TABLE_CONF, client, cache_rows=0)
    cached = RemoteTable(TABLE_CONF, client, cache_rows=2048)
    keys = rng.integers(6000, 6100, 200).astype(np.uint64)
    plain.feed_pass(keys)
    first = cached.pull(keys, create=False)
    cached.pull(keys, create=False)
    mark = client.registry.counter("ps.remote.bytes_in").get()
    second = cached.pull(keys, create=False)
    assert client.registry.counter("ps.remote.bytes_in").get() == mark
    np.testing.assert_array_equal(first, second)
    np.testing.assert_array_equal(second, plain.pull(keys, create=False))
    assert client.registry.counter("ps.remote.cache_hit").get() >= keys.size
    cached.push(keys, _grads(rng, keys.size))
    np.testing.assert_array_equal(cached.pull(keys), plain.pull(keys))
    assert cached.cache_stats()["rows"] > 0
    cached.end_pass()
    assert cached._cache.size == 0
    client.close()


def test_transient_fault_retried_and_wire_version_gives_up(svc):
    client = _client(svc.endpoints(), retries=2)
    faults.install_injector(faults.FaultInjector(
        seed=3, fail_rate=1.0, ops=("serve.frame_send",), max_failures=1))
    try:
        assert client.request(0, ("health",))["ok"] is True
    finally:
        faults.install_injector(None)
    assert client.registry.counter("ps.remote.retries").get() >= 1
    assert client.registry.counter("ps.remote.shard_unavailable").get() \
        == 0
    client.close()
    # a peer speaking another wire version: ShardUnavailable at once,
    # no retry spent
    server = socket.create_server(("127.0.0.1", 0))

    def serve():
        server.settimeout(5.0)
        try:
            conn, _ = server.accept()
        except socket.timeout:
            return
        with conn:
            while transport.recv_frame(conn) is not None:
                transport.send_frame(conn, struct.pack(">H", 99)
                                     + pickle.dumps(("ok", None)))

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    reg = MetricsRegistry()
    client = ServiceClient([f"127.0.0.1:{server.getsockname()[1]}"],
                           deadline_s=5.0, retries=3, registry=reg)
    try:
        with pytest.raises(ShardUnavailable, match="WireVersionMismatch"):
            client.request(0, ("health",))
    finally:
        client.close()
        server.close()
    assert reg.counter("ps.remote.retries").get() == 0
    assert reg.counter("ps.remote.shard_unavailable").get() == 1


def test_dead_shards_partial_push_and_lifeline():
    """A killed shard: ShardUnavailable with its context, counted once; a
    push through a dead and a live shard still drops the applied keys from
    the cache; two dead shards cost about one retry wall; a child exits
    when its lifeline closes, and at ``stop``."""
    with ShardService({"embedding": TABLE_CONF}, num_shards=2,
                      registry=MetricsRegistry()) as service:
        reg = MetricsRegistry()
        client = service.client(deadline_s=2.0, retries=1, registry=reg)
        cached = RemoteTable(TABLE_CONF, client, cache_rows=256)
        keys = np.arange(6500, 6600, dtype=np.uint64)
        cached.pull(keys)
        service.kill(0)
        time.sleep(0.2)
        with pytest.raises(ShardUnavailable):
            cached.push(keys, np.ones((keys.size, TABLE_CONF.pull_dim),
                                      np.float32))
        _vals, hit = cached._cache.lookup(keys[shard_of(keys, 2) == 1])
        assert not hit.any()
        with pytest.raises(ShardUnavailable) as ei:
            RemoteTable(TABLE_CONF, client, cache_rows=0).pull(
                keys[shard_of(keys, 2) == 0])
        assert ei.value.shard == 0 and "127.0.0.1" in ei.value.endpoint
        assert "pull" in str(ei.value)
        assert reg.counter("ps.remote.shard_unavailable").get() == 2
        # the lifeline: the parent's control connection closes without
        # the exit op (as when the parent dies), the child exits
        h1 = service.handles[1]
        h1._ctrl.close()
        h1._proc.join(timeout=10.0)
        assert not h1._proc.is_alive()
        with pytest.raises(ShardSpawnError):
            h1.request(("health",), deadline=2.0)
        client.close()

    def wall(endpoints, msgs):
        reg = MetricsRegistry()
        client = ServiceClient(endpoints, deadline_s=2.0, retries=5,
                               registry=reg)
        try:
            t0 = time.perf_counter()
            with pytest.raises(ShardUnavailable) as ei:
                client.exchange(msgs)
            return time.perf_counter() - t0, ei.value, reg
        finally:
            client.close()

    t1, _, _ = wall(["127.0.0.1:1"], {0: ("health",)})
    t2, err, reg = wall(["127.0.0.1:1", "127.0.0.1:2"],
                        {0: ("health",), 1: ("health",)})
    assert err.shard == 0
    assert reg.counter("ps.remote.shard_unavailable").get() == 2
    assert t2 <= t1 * 1.5 + 0.15, (t1, t2)
    service = ShardService({"embedding": TABLE_CONF}, num_shards=1,
                           registry=MetricsRegistry())
    proc = service.handles[0]._proc
    assert proc.is_alive()
    service.stop()
    proc.join(timeout=10.0)
    assert not proc.is_alive()


def test_spawn_failure_is_fast_and_named(monkeypatch):
    """A child that dies before its handshake (a bad table config) fails
    the spawn at once with its exit code; the spawn fault point raises
    before any child starts."""
    t0 = time.monotonic()
    with pytest.raises(ShardSpawnError, match="before handshake"):
        ShardService({"embedding": TABLE_CONF}, num_shards=1,
                     spec_overrides={0: {"tables": {"e": {"bogus": 1}}}},
                     spawn_timeout=30.0, registry=MetricsRegistry())
    assert time.monotonic() - t0 < 20.0
    faults.install_injector(faults.FaultInjector(
        seed=1, fail_rate=1.0, ops=faults.PS_FAULT_OPS))
    try:
        with pytest.raises(OSError, match="ps.shard_spawn"):
            ShardService({"embedding": TABLE_CONF}, num_shards=1,
                         registry=MetricsRegistry())
    finally:
        faults.install_injector(None)


# -- durability, across the packages -----------------------------------------

def _drive(ps, rng, keys):
    ps.begin_pass(1)
    ps.feed_pass({"embedding": keys})
    ps["embedding"].push(keys, _grads(rng, keys.size))
    ps.save_base("d1", 1)
    ps["embedding"].push(keys[::3], _grads(rng, keys[::3].size))
    ps.save_delta("d1", 1)
    committed = ps["embedding"].merged_snapshot()
    ps.end_pass()
    return committed


def _files(root):
    out = {}
    for p in sorted(glob.glob(os.path.join(root, "**", "*.npz"),
                              recursive=True)):
        with np.load(p) as z:
            out[os.path.relpath(p, root)] = {k: z[k] for k in z.files}
    return out


def test_port_client_on_reference_shard_and_roots_cross(tmp_path):
    """The port's ``RemotePS`` drives a reference shard and a port shard
    through the same passes: every pull equal, the committed npz files the
    same names and arrays, the donefile trail the same records; then each
    package's shard restarts onto the other package's root."""
    rng_keys = np.random.default_rng(2)
    keys = np.unique(rng_keys.integers(1, 500, 300).astype(np.uint64))
    ref_root, port_root = str(tmp_path / "ref"), str(tmp_path / "port")
    jconf = JaxTableConfig(**TABLE)
    ref_svc = RefShardService({"embedding": jconf}, num_shards=1,
                              root=ref_root, registry=RefRegistry())
    port_svc = ShardService({"embedding": TABLE_CONF}, num_shards=1,
                            root=port_root, registry=MetricsRegistry())
    try:
        clients = [_client(s.endpoints()) for s in (ref_svc, port_svc)]
        pss = [RemotePS(c, {"embedding": TABLE_CONF}, cache_rows=0)
               for c in clients]
        committed = [_drive(ps, np.random.default_rng(3), keys)
                     for ps in pss]
        _assert_snapshots_equal(committed[0], committed[1])
        snaps = [ps["embedding"].merged_snapshot() for ps in pss]
        _assert_snapshots_equal(snaps[0], snaps[1])
        np.testing.assert_array_equal(pss[0]["embedding"].pull(keys),
                                      pss[1]["embedding"].pull(keys))
        fr, fp = _files(ref_root), _files(port_root)
        assert sorted(fr) == sorted(fp) and len(fr) == 2
        for name in fr:
            _assert_snapshots_equal(fr[name], fp[name])
        from paddlebox_tpu.trainer import donefile as ref_donefile
        from paddlebox_tpu_torch.trainer import donefile
        want = ref_donefile.read_done(os.path.join(ref_root, "shard-000"))
        got = donefile.read_done(os.path.join(port_root, "shard-000"))
        assert [(r["day"], r["pass_id"], r["kind"]) for r in got] == \
            [(r["day"], r["pass_id"], r["kind"]) for r in want]
        for c in clients:
            c.close()
    finally:
        ref_svc.stop()
        port_svc.stop()
    # each package resumes the other's root
    resume = {0: {"resume": True}}
    port_on_ref = ShardService({"embedding": TABLE_CONF}, num_shards=1,
                               root=ref_root, spec_overrides=resume,
                               registry=MetricsRegistry())
    ref_on_port = RefShardService({"embedding": jconf}, num_shards=1,
                                  root=port_root, spec_overrides=resume,
                                  registry=RefRegistry())
    try:
        for service in (port_on_ref, ref_on_port):
            assert service.handles[0].resumed == "d1/00001"
            c = _client(service.endpoints())
            _assert_snapshots_equal(
                RemoteTable(TABLE_CONF, c, cache_rows=0).merged_snapshot(),
                committed[1])
            c.close()
    finally:
        port_on_ref.stop()
        ref_on_port.stop()


def test_save_restart_resume_roundtrip(tmp_path):
    rng = np.random.default_rng(2)
    reg = MetricsRegistry()
    with ShardService({"embedding": TABLE_CONF}, num_shards=2,
                      root=str(tmp_path), registry=reg) as service:
        client = service.client(deadline_s=15.0, retries=1,
                                registry=MetricsRegistry())
        ps = RemotePS(client, {"embedding": TABLE_CONF}, cache_rows=0)
        keys = rng.integers(1, 500, 300).astype(np.uint64)
        ps.begin_pass(1)
        ps.feed_pass({"embedding": keys})
        g = _grads(rng, keys.size)
        ps["embedding"].push(keys, g)
        assert len(ps.save_base("d1", 1)) == 2
        ps["embedding"].push(keys, g)
        ps.save_delta("d1", 1)
        before = ps["embedding"].merged_snapshot()
        service.kill(1)
        client.repoint(1, service.restart(1))
        assert service.handles[1].resumed == "d1/00001"
        assert service.handles[0].resumed is None
        _assert_snapshots_equal(before, ps["embedding"].merged_snapshot())
        assert reg.counter("ps.remote.shard_restarts").get() == 1
        # the fleet view scrapes the live service
        fm = FleetMetrics(interval=60.0)
        fm.add_shard_service(service)
        assert fm.scrape_once() > 0
        n = [fm.registry.gauge(
            f"fleet.ps.shard{i}.num_features.embedding").get()
            for i in range(2)]
        assert sum(n) == before["keys"].size and min(n) > 0
        client.close()


def test_shard_child_imports_no_torch(tmp_path):
    """The child's entry module, its slice with a resume, and every op's
    lazy imports (saves, snapshot, stats) import no torch."""
    root = str(tmp_path)
    spec = {"shard": 0, "num_shards": 1, "root": root, "resume": True,
            "tables": {"embedding": dataclasses.asdict(TABLE_CONF)},
            "flags": {}}
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        from paddlebox_tpu_torch.ps.service import shard_server as s
        st = s._ShardState({spec!r})
        keys = np.arange(1, 50, dtype=np.uint64)
        st.dispatch(("feed", {{"embedding": keys}}))
        st.dispatch(("push", "embedding", keys,
                     np.ones((keys.size, {TABLE_CONF.pull_dim}), np.float32)))
        st.dispatch(("save_base", "d", 1))
        st.dispatch(("save_delta", "d", 1))
        st.dispatch(("snapshot", "embedding"))
        st.dispatch(("stats",))
        s._ShardState({spec!r})             # a resume
        assert 'torch' not in sys.modules, 'torch imported'
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# -- training and serving through the service --------------------------------

def jax_feed_conf():
    return JaxFeedConfig(slots=[
        JaxSlotConfig("label", type="float", is_dense=True, dim=1),
        JaxSlotConfig("slot_a"), JaxSlotConfig("slot_b"),
        JaxSlotConfig("slot_c"),
        JaxSlotConfig("dense_x", type="float", is_dense=True, dim=3),
    ], batch_size=8, label_slot="label", thread_num=2)


def test_trainer_over_remote_table(tmp_path):
    """``CTRTrainer(table=RemoteTable(2 shards), use_device_table=False)``
    trains bit for bit like the port's local ``EmbeddingTable`` (losses,
    preds, every row, the dense weights), with the reference trainer's
    metrics within 1e-5; evaluation creates no rows."""
    torch.set_num_threads(1)
    files = [make_slot_file(str(tmp_path / f"part-{i}"), jax_feed_conf(),
                            48, seed=i) for i in range(2)]
    hidden = (8,)
    jtr = ref_trainer.CTRTrainer(
        FlaxDeepFM(hidden=hidden), jax_feed_conf(),
        JaxTableConfig(**TABLE), JaxTrainerConfig(),
        table=JaxTable(JaxTableConfig(**TABLE), backend="numpy"))
    jds = JaxSlotDataset(jax_feed_conf())
    jds.set_filelist(files)
    jds.load_into_memory()
    pconf = DataFeedConfig.from_dict(dataclasses.asdict(jax_feed_conf()))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jtr.params)]
    want = jtr.train_from_dataset(jds)
    runs = []
    with ShardService({"embedding": TABLE_CONF}, num_shards=2,
                      registry=MetricsRegistry()) as service:
        client = service.client(deadline_s=15.0, retries=1,
                                registry=MetricsRegistry())
        for table in (EmbeddingTable(TABLE_CONF),
                      RemoteTable(TABLE_CONF, client, cache_rows=0)):
            tr = CTRTrainer(deepfm_from_flax_leaves(leaves, hidden), pconf,
                            TABLE_CONF, TrainerConfig(), table=table,
                            use_device_table=False, device="cpu")
            assert not tr.fused and tr.table is table
            ds = SlotDataset(pconf)
            ds.set_filelist(files)
            ds.load_into_memory()
            fetched = []
            metrics = tr.train_from_dataset(
                ds, fetch_handler=lambda s, l, p: fetched.append(
                    (float(l), np.asarray(p).copy())))
            rows = (_sorted_snapshot(table) if isinstance(
                table, EmbeddingTable) else table.merged_snapshot())
            size = len(table)
            ev = tr.evaluate(ds)
            assert len(table) == size
            runs.append((metrics, fetched, rows,
                         [p.detach().numpy().copy()
                          for p in tr.model.parameters()], ev))
        assert client.registry.counter("ps.remote.bytes_in").get() > 0
        client.close()
    (m0, f0, r0, p0, e0), (m1, f1, r1, p1, e1) = runs
    assert len(f0) == len(f1) == 12
    for (l0, q0), (l1, q1) in zip(f0, f1):
        assert l0 == l1
        np.testing.assert_array_equal(q0, q1)
    _assert_snapshots_equal(r0, r1)
    for a, b in zip(p0, p1):
        np.testing.assert_array_equal(a, b)
    assert m0 == m1 and e0 == e1
    assert set(m1) == set(want) and m1["ins_num"] == want["ins_num"]
    for k in want:
        np.testing.assert_allclose(m1[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)


@pytest.fixture(scope="module")
def bundle_env(tmp_path_factory):
    """A bundle the JAX package exports and a 1-shard service holding the
    same rows (``import_rows``)."""
    top = str(tmp_path_factory.mktemp("ps_serving"))
    bundle, table, _leaves = W.jax_bundle(top)
    service = ShardService({"embedding": TableConfig(**W.TABLE)},
                           num_shards=1, registry=MetricsRegistry())
    client = service.client(registry=MetricsRegistry())
    snap = table.snapshot(reset_dirty=False)
    RemoteTable(TableConfig(**W.TABLE), client, cache_rows=0).import_rows(
        snap["keys"], snap["values"], snap["state"], mode="set")
    client.close()
    yield {"bundle": bundle, "endpoints": service.endpoints()}
    service.stop()


def _records(n, seed):
    parser = SlotParser(DataFeedConfig.from_dict(
        dataclasses.asdict(W.jax_feed())))
    return [parser.parse_line(ln)
            for ln in lines(np.random.default_rng(seed), n)]


def test_predictor_through_service(bundle_env, monkeypatch):
    """Scores through the service equal the bundle's exactly (and the
    reference predictor's within 1e-5); no table is loaded; the hot-key
    cache in front answers repeats with the same bits."""
    recs = _records(24, seed=1)
    local = CTRPredictor(bundle_env["bundle"], device="cpu")
    remote = CTRPredictor(bundle_env["bundle"], device="cpu",
                          ps_endpoints=bundle_env["endpoints"])
    assert isinstance(remote.table, RemoteTable)
    assert remote.table._cache is None and not remote.serves_quantized
    want = local.predict_records(recs)
    np.testing.assert_array_equal(remote.predict_records(recs), want)
    from paddlebox_tpu.data.parser import SlotParser as JaxSlotParser
    jp = JaxPredictor(bundle_env["bundle"])
    jparser = JaxSlotParser(jp.feed_conf)
    jrecs = [jparser.parse_line(ln)
             for ln in lines(np.random.default_rng(1), 24)]
    np.testing.assert_allclose(want, jp.predict_records(jrecs), rtol=1e-5,
                               atol=1e-7)
    monkeypatch.setenv("PBOX_FLAGS_serve_cache_rows", "512")
    monkeypatch.setenv("PBOX_FLAGS_serve_quantized", "1")
    pred = CTRPredictor(bundle_env["bundle"], device="cpu",
                        ps_endpoints=bundle_env["endpoints"])
    assert not pred.serves_quantized
    first = pred.predict_records(recs)
    hits0 = pred._cache.hits
    np.testing.assert_array_equal(pred.predict_records(recs), first)
    assert pred._cache.hits > hits0
    np.testing.assert_array_equal(first, want)


def test_serving_tier_keeps_ps_wiring(bundle_env, tmp_path):
    """The worker spec, a hot reload and a thread-scope fleet all serve
    through the service."""
    from paddlebox_tpu_torch.ckpt import atomic
    from paddlebox_tpu_torch.serving import ReplicaSet
    from paddlebox_tpu_torch.serving.proc import _build_predictor
    from paddlebox_tpu_torch.serving.reload import load_predictor_from_plan
    eps = bundle_env["endpoints"]
    pred = _build_predictor({"bundle": bundle_env["bundle"],
                             "ps_endpoints": eps, "device": "cpu"})
    assert isinstance(pred.table, RemoteTable)
    committed = str(tmp_path / "base")
    atomic.commit_dir(atomic.stage_dir(committed), committed)
    plan = ({"path": committed, "day": "d", "pass_id": 2}, [])
    new = load_predictor_from_plan(bundle_env["bundle"], plan,
                                   reload_of=pred)
    assert isinstance(new.table, RemoteTable)
    assert new.ps_endpoints == pred.ps_endpoints == eps
    assert new.model_version == "d/00002"
    recs = _records(8, seed=3)
    np.testing.assert_array_equal(pred.predict_records(recs),
                                  new.predict_records(recs))
    fleet = ReplicaSet.from_bundle(bundle_env["bundle"], replicas=1,
                                   scope="thread", ps_endpoints=eps,
                                   device="cpu",
                                   registry=MetricsRegistry())
    try:
        assert isinstance(fleet._replicas[0].predictor.table, RemoteTable)
    finally:
        fleet.stop()


# -- the drills ----------------------------------------------------------------

@pytest.mark.parametrize("scenario", ["parity", "shard_kill"])
def test_drill_scenario(scenario, tmp_path):
    seed = 5 + list(ps_drill.SCENARIOS).index(scenario)
    rep = ps_drill.run_scenario(scenario, seed=seed, root=str(tmp_path))
    assert rep["ok"], rep


def test_drill_cli_slow_shard(capsys):
    rc = ps_drill.main(["--scenario", "slow_shard", "--seed", "2"])
    out = capsys.readouterr().out
    assert rc == 0 and "[OK  ] slow_shard" in out
    assert "1/1 scenarios ok" in out


def test_campaign(tmp_path):
    """The chaos drill's ``campaign`` over the port's host tier: train
    against two shards (bit for bit with an in-process oracle) while two
    stand-in hosts serve an LB's traffic, lose a host and a shard together
    (after a ``save_delta``), append a torn donefile line, hold slowloris
    idlers on a front door, run an shm ingest leg; then no client failure,
    no lost update, versions monotone, the host restored within the
    bound, the idlers shed, and no leaked child, segment or thread."""
    from paddlebox_tpu_torch.serving import FileResolver, HostFleet, LBClient
    threads0 = threading.active_count()
    shm0 = REGISTRY.counter("ingest.shm.leaked_segments").get()
    reg = MetricsRegistry()
    rng = np.random.default_rng(11)
    conf = ps_drill._table_conf(11)
    oracle = SparsePS({"embedding": EmbeddingTable(conf)})
    path = str(tmp_path / "endpoints.json")
    hf = HostFleet({"scope": "process", "replicas": 1, "metrics": False,
                    "worker_spec": fake_spec(delay_s=0.001),
                    "flags": {"serve_request_timeout": 1.0}},
                   hosts=2, resolver_path=path, registry=reg,
                   probe_interval=0.2).start()
    res = FileResolver(path, poll_s=0.1, registry=reg)
    lb = LBClient(res, registry=reg, probe_interval=0.2).start()
    svc = ShardService({"embedding": conf}, num_shards=2,
                       root=str(tmp_path / "ckpt"), registry=reg)
    idlers = []
    results = []
    try:
        client = svc.client(deadline_s=2.0, retries=1)
        remote = RemotePS(client, {"embedding": conf}, cache_rows=0)
        pool = rng.integers(1, 2500, 1500).astype(np.uint64)
        remote.begin_pass(1)
        oracle.begin_pass(1)
        remote.feed_pass({"embedding": pool})
        oracle.feed_pass({"embedding": pool})

        def train_step(kb=None):
            kb = rng.choice(pool, 192).astype(np.uint64) if kb is None \
                else kb
            np.testing.assert_array_equal(remote["embedding"].pull(kb),
                                          oracle["embedding"].pull(kb))
            g = ps_drill._grads(rng, kb, conf.pull_dim)
            remote["embedding"].push(kb, g)
            oracle["embedding"].push(kb, g)

        def traffic(seed):
            r = np.random.default_rng(seed)
            for _ in range(30):
                ls = lines(r, 4)
                try:
                    ok = len(lb.predict_lines(ls, deadline_ms=5000.0)) == 4
                    results.append("" if ok else "short reply")
                except Exception as e:  # noqa: BLE001 - judged below
                    results.append(f"{type(e).__name__}: {e}")
                time.sleep(0.01)

        v0 = hf.hosts[1].health()["versions"]
        clients = [threading.Thread(target=traffic, args=(s,), daemon=True)
                   for s in range(3)]
        for c in clients:
            c.start()
        h1, p1 = hf.hosts[1].endpoint.rsplit(":", 1)
        idlers = [socket.create_connection((h1, int(p1)), timeout=5.0)
                  for _ in range(3)]
        for _ in range(3):
            train_step()
        remote.save_base("d0", 1)
        for _ in range(2):
            train_step()
        remote.save_delta("d0", 1)
        restarts0 = reg.counter("serving.host_restarts").get()
        t_kill = time.monotonic()
        hf.kill_host(0)
        svc.kill(0)
        time.sleep(0.2)
        kb = rng.choice(pool, 192).astype(np.uint64)
        with pytest.raises(ShardUnavailable):
            remote["embedding"].pull(kb)
        for done in glob.glob(str(tmp_path / "ckpt" / "**" /
                                  "donefile.jsonl"), recursive=True):
            with open(done, "a") as f:
                f.write('{"torn": "lin')
        client.repoint(0, svc.restart(0))
        assert svc.handles[0].resumed == "d0/00001"
        train_step(kb)
        for _ in range(2):
            train_step()
        remote.end_pass()
        oracle.end_pass()
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and not (
                reg.counter("serving.host_restarts").get() > restarts0
                and len(hf.endpoints()) == 2):
            time.sleep(0.05)
        mttr = time.monotonic() - t_kill
        for c in clients:
            c.join(timeout=60.0)
        _assert_snapshots_equal(remote["embedding"].merged_snapshot(),
                                _sorted_snapshot(oracle["embedding"]))
        versions = hf.hosts[1].health()["versions"]
        shed = 0
        for s in idlers:
            s.settimeout(10.0)
            try:
                shed += s.recv(1) == b""
            except OSError:
                shed += 1
        rows = _shm_leg(str(tmp_path / "shm"))
        client.close()
    finally:
        for s in idlers:
            s.close()
        lb.stop()
        res.stop()
        hf.stop()
        svc.stop()
    assert len(results) == 90 and not [r for r in results if r], results
    assert mttr < 60.0
    assert all(b >= a for a, b in zip(v0, versions))
    assert shed == 3
    assert rows == 80
    assert not [p for p in multiprocessing.active_children()
                if p.is_alive()]
    assert REGISTRY.counter("ingest.shm.leaked_segments").get() == shm0
    assert threading.active_count() <= threads0 + 10


def _shm_leg(root):
    """A small two-worker read over the shm fabric (the campaign's ingest
    leg); returns the rows read."""
    from paddlebox_tpu_torch.config import SlotConfig
    from paddlebox_tpu_torch.data.fast_feed import MultiProcessReader
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(5)
    files = []
    for i in range(2):
        p = os.path.join(root, f"part-{i}.txt")
        with open(p, "w") as f:
            f.write("\n".join(lines(rng, 40)) + "\n")
        files.append(p)
    conf = DataFeedConfig(
        slots=[SlotConfig("label", type="float", is_dense=True, dim=1),
               SlotConfig("slot_a"), SlotConfig("slot_b")],
        batch_size=16)
    r = MultiProcessReader(conf, workers=2, use_shm=True)
    try:
        return sum(b.num_rows for b in r.batches(files))
    finally:
        r.close()
