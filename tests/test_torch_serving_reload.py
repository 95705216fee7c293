"""The port's checkpoint hot reload on the CPU, against the reference:
``ServingTable.load_delta`` pulls the rows the reference's
``EmbeddingTable.load_delta`` pulls (new, overwritten and gated keys; bit
for bit); ``load_predictor_from_plan`` over a trail the JAX
``PassManager`` committed, and over one the port's committed, scores as
the reference's does (within 1e-5), float32 and quantized; the
``ReloadWatcher`` swaps a thread fleet under traffic with no failed
request, monotone versions, no ``serving.reload_recompiled`` and the
scores of a fresh predictor of the plan; restarts and a replica dead
mid-rollout come back on the rolled-out plan; a process-scope child
reloads in its own process."""

import os
import threading
import time

import numpy as np
import pytest

from paddlebox_tpu import flags as ref_flags
from paddlebox_tpu.ckpt import discovery as ref_discovery
from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.data.parser import SlotParser as JaxParser
from paddlebox_tpu.ps.table import EmbeddingTable as JaxTable
from paddlebox_tpu.serving.reload import \
    load_predictor_from_plan as ref_load
from paddlebox_tpu_torch.ckpt import discovery
from paddlebox_tpu_torch.config import TableConfig
from paddlebox_tpu_torch.data.parser import SlotParser
from paddlebox_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from paddlebox_tpu_torch.ps.quant_table import QuantServingTable
from paddlebox_tpu_torch.ps.serving_table import ServingTable
from paddlebox_tpu_torch.serving import (ReloadError, ReloadWatcher,
                                         ReplicaSet)
from paddlebox_tpu_torch.serving.reload import load_predictor_from_plan
from torch_serving_fakes import FakePredictor, feed_conf, lines
import torch_serving_world as W

ATOL = 1e-5


def wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


# -- the delta upsert --------------------------------------------------------

def snap_file(path, keys, values, ok):
    np.savez(path, keys=np.asarray(keys, np.uint64),
             values=np.asarray(values, np.float32),
             state=np.zeros((len(keys), 2), np.float32),
             embedx_ok=np.asarray(ok, bool))
    return path


@pytest.mark.parametrize("base_rows", [0, 300])
def test_load_delta_pulls_as_the_reference(tmp_path, base_rows):
    """A base, then two deltas: keys rewritten in place (gated and
    ungated both ways), new keys (high-bit ones among them, so the merge
    crosses the int64 sign), a delta of no keys; then every pull of the
    reference's table, bit for bit."""
    rng = np.random.default_rng(base_rows)
    kw = dict(embedx_dim=4, cvm_offset=3, embedx_threshold=5.0, seed=7)
    conf = TableConfig(**kw)
    D = conf.pull_dim
    high = np.uint64(1) << np.uint64(63)
    base_keys = rng.permutation(np.concatenate([
        np.arange(1, base_rows + 1, dtype=np.uint64),
        high + np.arange(1, 4, dtype=np.uint64) if base_rows else
        np.zeros(0, np.uint64)]))
    n = base_keys.size
    ref = JaxTable(JaxTableConfig(**kw))
    port = ServingTable(conf, device="cpu")
    if n:
        base = snap_file(str(tmp_path / "base.npz"), base_keys,
                         rng.normal(size=(n, D)),
                         rng.uniform(size=n) < 0.5)
        ref.load(base)
        port.load(base)
    deltas = []
    for i in range(2):
        known = rng.choice(base_keys, size=min(n, 40), replace=False)
        fresh = np.concatenate([
            np.arange(1000 + 100 * i, 1030 + 100 * i, dtype=np.uint64),
            high + np.arange(50 + i * 10, 55 + i * 10, dtype=np.uint64)])
        keys = rng.permutation(np.concatenate([known, fresh]))
        deltas.append(snap_file(str(tmp_path / f"d{i}.npz"), keys,
                                rng.normal(size=(keys.size, D)),
                                rng.uniform(size=keys.size) < 0.5))
    deltas.append(snap_file(str(tmp_path / "empty.npz"), [],
                            np.zeros((0, D)), []))
    for d in deltas:
        ref.load_delta(d)
        port.load_delta(d)
    assert len(port) == len(ref)
    query = np.concatenate([base_keys, np.arange(990, 1240,
                                                 dtype=np.uint64),
                            high + np.arange(0, 80, dtype=np.uint64),
                            np.zeros(3, np.uint64)])
    want = ref.pull(query, create=False)
    got = port.pull(query).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    keys = port._keys.numpy()
    assert np.all(keys[1:] > keys[:-1])       # sorted in the int64 view
    with pytest.raises(ValueError, match="duplicate"):
        port.load_delta(snap_file(str(tmp_path / "dup.npz"), [7, 7],
                                  np.zeros((2, D)), [True, True]))


# -- load_predictor_from_plan ------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("reload"))
    path, table, leaves = W.jax_bundle(root)
    jroot = os.path.join(root, "jax_ckpt")
    W.jax_trail(jroot, table, W.flax_params(9)[2], [1, 2, 3])
    proot = os.path.join(root, "port_ckpt")
    W.port_trail(proot, [1, 2])
    return dict(root=root, bundle=path, jroot=jroot, proot=proot,
                lines=lines(np.random.default_rng(11), 30))


def scores_both(bundle, root, ls):
    want = ref_load(bundle, ref_discovery.latest_committed(root))
    got = load_predictor_from_plan(bundle, discovery.latest_committed(root),
                                   device="cpu")
    w = want.predict_records([JaxParser(want.feed_conf).parse_line(ln)
                              for ln in ls])
    g = got.predict_records([SlotParser(got.feed_conf).parse_line(ln)
                             for ln in ls])
    return got, g, want, w


@pytest.mark.parametrize("trail", ["jroot", "proot"])
def test_load_predictor_from_plan_matches_reference(world, trail):
    got, g, want, w = scores_both(world["bundle"], world[trail],
                                  world["lines"])
    np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    assert got.model_version == want.model_version == (
        "20260803/00003" if trail == "jroot" else "20260803/00002")
    assert len(got.table) == len(want.table.snapshot(reset_dirty=False)
                                 ["keys"])
    # the base's dense leaves were taken, not the bundle's
    from paddlebox_tpu_torch.inference.predictor import CTRPredictor
    plain = CTRPredictor(world["bundle"], device="cpu")
    assert not np.allclose(
        plain.predict_records([SlotParser(plain.feed_conf).parse_line(ln)
                               for ln in world["lines"]]), g)


def test_quantized_plan_matches_reference(world, monkeypatch):
    """Under ``serve_quantized`` the records quantize on load (no ``.q8``
    siblings: ``serving.quant_fallbacks``) as the reference's do."""
    old = ref_flags.get("serve_quantized")
    ref_flags.set("serve_quantized", True)
    monkeypatch.setenv("PBOX_FLAGS_serve_quantized", "1")
    try:
        before = REGISTRY.counter("serving.quant_fallbacks").get()
        got, g, _want, w = scores_both(world["bundle"], world["jroot"],
                                       world["lines"])
    finally:
        ref_flags.set("serve_quantized", old)
    assert isinstance(got.table, QuantServingTable)
    assert REGISTRY.counter("serving.quant_fallbacks").get() - before == 3
    np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


def test_plan_errors(world, tmp_path):
    base, deltas = discovery.latest_committed(world["jroot"])
    two = tmp_path / "two"
    two.mkdir()
    for f in ("embedding.npz", "other.npz"):
        os.link(os.path.join(base["path"], "embedding.npz"), two / f)
    with pytest.raises(ReloadError, match="ONE table"):
        load_predictor_from_plan(world["bundle"],
                                 (dict(base, path=str(two)), []),
                                 device="cpu")
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ReloadError, match="no table artifacts"):
        load_predictor_from_plan(world["bundle"],
                                 (dict(base, path=str(empty)), []),
                                 device="cpu")
    with pytest.raises(NotImplementedError, match="A.9"):
        load_predictor_from_plan(world["bundle"], (base, deltas),
                                 ps_endpoints=["localhost:1"], device="cpu")


# -- the watcher over a thread fleet -----------------------------------------

def commit(world, root, pass_ids, table_seed=0):
    """A JAX trail under ``root``: a base at the first pass, deltas after."""
    _, table, _ = W.jax_bundle(os.path.join(root, "_b"),
                               f"b{pass_ids[0]}", seed=table_seed)
    W.jax_trail(root, table, W.flax_params(9)[2], pass_ids)


def test_hammer_during_swap(world, tmp_path):
    root = str(tmp_path / "ckpt")
    commit(world, root, [1])
    reg = MetricsRegistry()
    failures, seen = [], []
    stop = threading.Event()
    fleet = ReplicaSet.from_bundle(world["bundle"], replicas=2,
                                   scope="thread", device="cpu",
                                   probe_interval=60.0, registry=reg)
    with fleet:
        fleet.warm(world["lines"][:2])
        watcher = ReloadWatcher(fleet, world["bundle"], root, poll_s=60.0,
                                registry=reg)
        assert watcher.current == ("19700101", 0)   # the bundle's tag

        def hammer(seed):
            r = np.random.default_rng(seed)
            while not stop.is_set():
                try:
                    out = fleet.predict_lines(lines(r, 2),
                                              deadline_ms=10000.0)
                    assert len(out) == 2
                except Exception as e:  # noqa: BLE001
                    failures.append(f"{type(e).__name__}: {e}")
                seen.append(fleet.versions())

        threads = [threading.Thread(target=hammer, args=(i,), daemon=True)
                   for i in range(3)]
        for t in threads:
            t.start()
        recompiled = REGISTRY.counter("serving.reload_recompiled").get()
        time.sleep(0.1)
        assert watcher.poll_once() is True
        time.sleep(0.1)
        commit(world, root, [2, 3], table_seed=1)
        assert watcher.poll_once() is True
        time.sleep(0.1)
        stop.set()
        for t in threads:
            t.join(timeout=10.0)
        final = fleet.versions()
        plan = discovery.latest_committed(root)
        fresh = load_predictor_from_plan(world["bundle"], plan,
                                         device="cpu")
        recs = [fleet.parser.parse_line(ln) for ln in world["lines"]]
        got = fleet.predict_records(recs, deadline_ms=10000.0)
        assert watcher.status()["current"] == "20260803/00003"
    assert failures == []
    assert final == ["20260803/00003"] * 2
    for i in range(2):
        vs = [v[i] for v in seen if v[i] is not None]
        assert all(a <= b for a, b in zip(vs, vs[1:]))
    assert reg.counter("serving.reloads").get() == 2
    assert REGISTRY.counter("serving.reload_recompiled").get() == recompiled
    assert reg.histogram("serving.reload_ms").count == 4
    assert reg.gauge("serving.model_pass").get() == 3
    np.testing.assert_array_equal(got, fresh.predict_records(recs))


def test_restart_dead_skip_and_stale_polls(world, tmp_path):
    """A replica dead at the rollout is skipped and comes back on the
    rolled-out plan, as does a later restart; a poll of the same pass
    swaps nothing; a replacement watcher seeds from the fleet; a missing
    root is no error."""
    root = str(tmp_path / "ckpt")
    commit(world, root, [1])
    reg = MetricsRegistry()
    fleet = ReplicaSet.from_bundle(world["bundle"], replicas=2,
                                   scope="thread", device="cpu",
                                   probe_interval=60.0, registry=reg)
    with fleet:
        fleet.replicas[1].kill()
        assert wait(lambda: not fleet.replicas[1].alive())
        w = ReloadWatcher(fleet, world["bundle"], root, poll_s=60.0,
                          registry=reg)
        assert w.poll_once() is True
        assert fleet.versions() == ["20260803/00001", "19700101/00000"]
        assert fleet._probe_once() == 1
        assert fleet.versions() == ["20260803/00001"] * 2
        fleet.replicas[0].kill()
        assert wait(lambda: not fleet.replicas[0].alive())
        assert fleet._probe_once() == 1
        assert fleet.versions() == ["20260803/00001"] * 2
        assert w.poll_once() is False
        assert reg.counter("serving.reloads").get() == 1
        w3 = ReloadWatcher(fleet, world["bundle"], root, poll_s=60.0,
                           registry=reg)
        assert w3.current == ("20260803", 1) and w3.poll_once() is False
        w2 = ReloadWatcher(fleet, world["bundle"],
                           str(tmp_path / "nowhere"), poll_s=60.0,
                           registry=reg)
        assert w2.poll_once() is False


def test_watcher_thread_survives_a_bad_poll(tmp_path):
    """The background loop counts a failing poll and keeps polling."""
    reg = MetricsRegistry()
    with ReplicaSet(lambda: FakePredictor(feed_conf(), 0.001), replicas=1,
                    probe_interval=60.0, registry=reg) as fleet:
        w = ReloadWatcher(fleet, "/no/bundle", str(tmp_path), poll_s=0.02,
                          registry=reg)
        w.poll_once = lambda: 1 / 0
        with w:
            assert wait(lambda: reg.counter(
                "serving.reload_errors").get() >= 2)
        assert w.status()["last_error"].startswith("ZeroDivisionError")
        with pytest.raises(RuntimeError, match="already stopped"):
            w.start()


# -- process scope -------------------------------------------------------------

def test_process_scope_reload(world, tmp_path):
    """One ``CTRPredictor`` child on the CPU: the watcher's reload runs
    in the child (its version on the side channel, its scores those of a
    fresh predictor of the plan), and its restart after a SIGKILL builds
    on the retargeted plan."""
    root = str(tmp_path / "ckpt")
    commit(world, root, [1, 2])
    reg = MetricsRegistry()
    fleet = ReplicaSet.from_bundle(world["bundle"], replicas=1,
                                   scope="process", device="cpu",
                                   probe_interval=60.0, registry=reg)
    recs = [fleet.parser.parse_line(ln) for ln in world["lines"]]
    with fleet:
        w = ReloadWatcher(fleet, world["bundle"], root, poll_s=60.0,
                          registry=reg)
        assert w.poll_once() is True
        assert fleet.versions() == ["20260803/00002"]
        fresh = load_predictor_from_plan(
            world["bundle"], discovery.latest_committed(root),
            device="cpu").predict_records(recs)
        np.testing.assert_array_equal(
            fleet.predict_records(recs, deadline_ms=30000.0), fresh)
        assert fleet._worker_spec["plan"][0]["pass_id"] == 1
        fleet.replicas[0].kill()
        assert wait(lambda: not fleet.replicas[0].alive())
        assert fleet._probe_once() == 1
        assert fleet.versions() == ["20260803/00002"]
        np.testing.assert_array_equal(
            fleet.predict_records(recs, deadline_ms=30000.0), fresh)
    assert reg.histogram("serving.reload_ms").count == 1
