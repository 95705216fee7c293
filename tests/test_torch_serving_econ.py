"""Port's serving economics against the reference's, on the CPU: the
replica caches (``ps/replica_cache.py``), the int8 serving snapshot
(``ps/quant_table.py``), its export beside each checkpoint (``<dir>.q8``:
``trainer/pass_manager.py``, ``ckpt/discovery.py``, ``ckpt/retention.py``,
``ckpt/faults.py``), the knobs (``config.serving_econ_conf``) and
``CTRPredictor`` under them; each case of the reference's
``tests/test_serving_econ.py``, run on the port and held to the reference.

Tolerances: quantized arrays, pulls and the cache's counters exact; a
quantized weight within one quantization step (its group's row maximum /
127) of its float32 source; predictor scores within 1e-5 of the
reference's; scores with the cache and coalescing on and off bit for bit.
The reference reads its flags from its registry (``flags.set``), the port
from ``PBOX_FLAGS_*`` at each call."""

import dataclasses
import os
import threading

import jax
import numpy as np
import pytest
import torch

from paddlebox_tpu import flags as ref_flags
from paddlebox_tpu.config import DataFeedConfig as JaxFeedConfig
from paddlebox_tpu.config import SlotConfig as JaxSlotConfig
from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.config import serving_econ_conf as ref_econ_conf
from paddlebox_tpu.inference.predictor import CTRPredictor as JaxPredictor
from paddlebox_tpu.models import DeepFM as FlaxDeepFM
from paddlebox_tpu.ps import quant_table as ref_quant
from paddlebox_tpu.ps import replica_cache as ref_cache
from paddlebox_tpu.ps.server import SparsePS as RefSparsePS
from paddlebox_tpu.ps.table import EmbeddingTable as RefTable
from paddlebox_tpu.trainer.pass_manager import PassManager as RefPassManager
from paddlebox_tpu_torch.ckpt import atomic, discovery, faults
from paddlebox_tpu_torch.config import (DataFeedConfig, TableConfig,
                                        serving_econ_conf)
from paddlebox_tpu_torch.data.parser import SlotParser
from paddlebox_tpu_torch.inference.predictor import (CTRPredictor,
                                                     save_inference_model)
from paddlebox_tpu_torch.models.convert import deepfm_from_flax_leaves
from paddlebox_tpu_torch.ps.quant_table import (QUANT_FIELDS,
                                                QuantServingTable,
                                                quantize_snapshot,
                                                value_groups)
from paddlebox_tpu_torch.ps.replica_cache import (HotKeyCache, InputTable,
                                                  ReplicaCache)
from paddlebox_tpu_torch.ps.serving_table import ServingTable
from paddlebox_tpu_torch.ps.server import SparsePS
from paddlebox_tpu_torch.ps.table import EmbeddingTable
from paddlebox_tpu_torch.trainer import donefile
from paddlebox_tpu_torch.trainer.pass_manager import PassManager

ECON_FLAGS = ("serve_quantized", "serve_cache_rows", "serve_coalesce",
              "enable_pull_padding_zero", "enable_pullpush_dedup_keys")


@pytest.fixture(autouse=True)
def econ_flags(monkeypatch):
    """Both packages' knobs, set together; restored after each test."""
    old = {f: ref_flags.get(f) for f in ECON_FLAGS}
    for f in ECON_FLAGS:
        monkeypatch.delenv("PBOX_FLAGS_" + f, raising=False)

    def setf(name, value):
        ref_flags.set(name, value)
        monkeypatch.setenv("PBOX_FLAGS_" + name, str(int(value))
                           if isinstance(value, bool) else str(value))

    yield setf
    for f, v in old.items():
        ref_flags.set(f, v)


def conf_kw(**kw):
    base = dict(embedx_dim=8, cvm_offset=3, embedx_threshold=2.0, seed=7)
    base.update(kw)
    return base


def filled_tables(n=600, seed=0, **kw):
    """The port's and the reference's host tables after the same feed and
    push (the init is a function of the key, so they agree bit for bit)."""
    out = []
    for table_cls, conf_cls in ((EmbeddingTable, TableConfig),
                                (RefTable, JaxTableConfig)):
        conf = conf_cls(**conf_kw(**kw))
        rng = np.random.default_rng(seed)
        t = table_cls(conf, backend="numpy")
        keys = np.arange(1, n + 1, dtype=np.uint64)
        t.feed_pass(keys)
        g = np.zeros((n, conf.pull_dim), np.float32)
        g[: n // 2, 0] = 5.0          # half the rows cross the threshold
        g[:, 2:] = rng.normal(0.0, 0.1, (n, conf.pull_dim - 2))
        t.push(keys, g)
        out.append((t, conf))
    return out


# -- the replica caches --------------------------------------------------------

def test_replica_cache_matches_reference():
    """Sequential ids, dim check, the frozen device copy (kept until the
    next append; one zero row when empty) and the pull by id."""
    for cls in (ReplicaCache, ref_cache.ReplicaCache):
        c = cls(dim=3)
        assert c.add_items([1.0, 2.0, 3.0]) == 0
        assert c.add_items(np.arange(3)) == 1
        assert len(c) == 2 and c.memory_bytes() == 2 * 3 * 4
        with pytest.raises(ValueError):
            c.add_items([1.0, 2.0])
    c, r = ReplicaCache(dim=2), ref_cache.ReplicaCache(dim=2)
    assert c.to_device("cpu").shape == (1, 2)
    assert not c.to_device("cpu").any()
    for x in (c, r):
        x.add_items([1.0, 2.0])
        x.add_items([3.0, 4.0])
    d1 = c.to_device("cpu")
    assert c.to_device("cpu") is d1
    ids = np.array([1, 0, 1])
    out = ReplicaCache.pull(d1, torch.from_numpy(ids))
    want = jax.jit(ref_cache.ReplicaCache.pull)(r.to_device(), ids)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    c.add_items([5.0, 6.0])
    assert c.to_device("cpu") is not d1 and c.to_device("cpu").shape == (3,
                                                                          2)


def test_input_table_matches_reference():
    """Offset 0 is the miss row; the stacked lookup cache is invalidated
    by an add; the miss counter and the rows equal the reference's."""
    got = []
    for cls in (InputTable, ref_cache.InputTable):
        t = cls(dim=2)
        t.add_index_data("hot", [1.0, 2.0])
        offs = t.get_index_offsets(["hot", "never-seen", "hot"])
        first = t.lookup_input(offs)
        t.add_index_data("b", [9.0, 8.0])
        got.append((offs, first, t.lookup_input(np.array([2, 0])), t.miss,
                    len(t), np.asarray(t.to_device() if cls is
                                       ref_cache.InputTable
                                       else t.to_device("cpu"))))
    (po, pf, pl, pm, pn, pd), (jo, jf, jl, jm, jn, jd) = got
    assert po.tolist() == jo.tolist() == [1, 0, 1]
    np.testing.assert_array_equal(pf, jf)
    np.testing.assert_array_equal(pl, jl)
    assert pm == jm == 1 and pn == jn == 3
    np.testing.assert_array_equal(pd, jd)


# -- the hot-key cache ---------------------------------------------------------

def cache_trace(cls, seed):
    """A fixed sequence of lookups, inserts, drops and version changes
    over a Zipf-ish key stream; returns every lookup's values and hits and
    the counters after each step."""
    c = cls(64, dim=3)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(60):
        keys = (rng.zipf(1.3, size=40) % 500).astype(np.uint64)
        vals, hit = c.lookup(keys)
        out.append((vals.copy(), hit.copy()))
        miss = np.unique(keys[~hit])
        c.insert(miss, np.stack([miss.astype(np.float32),
                                 -miss.astype(np.float32),
                                 np.full(miss.size, i, np.float32)], 1))
        if i % 17 == 5:
            out.append(c.drop(keys[:5]))
        if i % 23 == 7:
            c.set_version(f"d/{i}")
        out.append((c.hits, c.misses, c.evictions, c.size, c.version))
    return out, c


def test_hot_key_cache_counts_match_reference():
    """The same lookups in both packages: values, hits, drops and every
    counter equal after each step (the hash, probe window, window LRU and
    version contract are the reference's)."""
    got, c = cache_trace(HotKeyCache, 3)
    want, r = cache_trace(ref_cache.HotKeyCache, 3)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(a, tuple) and isinstance(a[0], np.ndarray):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
        else:
            assert a == b
    assert c.evictions > 0 and c.hits > 0
    assert c.capacity == r.capacity and c.memory_bytes() == \
        r.memory_bytes() == c.capacity * (8 + 1 + 3 * 4 + 8)
    for cls in (HotKeyCache, ref_cache.HotKeyCache):
        with pytest.raises(ValueError):
            cls(8, dim=4)


def test_hot_key_cache_version_and_eviction():
    """The reference's cases: a version change clears the cache (the same
    version does not); a flood of one-shot keys stays within capacity and
    the hot rows that survive answer with their values."""
    c = HotKeyCache(64, dim=2)
    c.set_version("d/00001")
    c.insert(np.array([5], np.uint64), np.ones((1, 2), np.float32))
    assert c.lookup(np.array([5], np.uint64))[1].all()
    c.set_version("d/00002")
    assert not c.lookup(np.array([5], np.uint64))[1].any()
    c.set_version("d/00002")
    c.insert(np.array([5], np.uint64), np.ones((1, 2), np.float32))
    assert c.lookup(np.array([5], np.uint64))[1].all()
    c = HotKeyCache(64, dim=2)
    hot = np.arange(1, 9, dtype=np.uint64)
    c.insert(hot, np.ones((8, 2), np.float32))
    for lo in range(100, 4100, 200):
        c.lookup(hot)
        flood = np.arange(lo, lo + 200, dtype=np.uint64)
        c.insert(flood, np.zeros((flood.size, 2), np.float32))
    assert c.size <= c.capacity and c.evictions > 0
    vals, hit = c.lookup(hot)
    assert np.all(vals[hit] == 1.0)


def test_hot_key_cache_concurrent_churn():
    """Lookups, inserts, version changes and drops from four threads:
    every hit row is one some thread wrote whole, and the occupancy stays
    within capacity."""
    c = HotKeyCache(256, dim=2)
    errors = []
    go = threading.Event()

    def churn(seed):
        rng = np.random.default_rng(seed)
        go.wait()
        try:
            for i in range(100):
                keys = rng.integers(1, 500, size=8).astype(np.uint64)
                c.insert(keys, np.full((8, 2), float(seed), np.float32))
                vals, hit = c.lookup(keys)
                for row in vals[hit]:
                    assert row[0] == row[1], row
                if i % 50 == 0:
                    c.set_version(f"d/{seed}.{i}")
                if i % 70 == 0:
                    c.drop(keys[:4])
        except Exception as exc:  # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=churn, args=(s,)) for s in range(1, 5)]
    for t in threads:
        t.start()
    go.set()
    for t in threads:
        t.join()
    assert not errors and 0 <= c.size <= c.capacity
    assert c.hits + c.misses > 0


# -- the quantized serving table -----------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(expand_dim=4), dict(cvm_offset=2)])
def test_quantized_snapshot_and_pull_match_reference(kw):
    """``quantize_snapshot`` bit for bit, and the device table's pull (key
    0, absent keys, gated rows) bit for bit against the reference's numpy
    pull; within one step of the float32 table, stats exact."""
    (pt, pconf), (jt, jconf) = filled_tables(**kw)
    assert value_groups(pconf) == ref_quant.value_groups(jconf)
    snap = pt.snapshot(reset_dirty=False)
    got = quantize_snapshot(snap, pconf)
    want = ref_quant.quantize_snapshot(jt.snapshot(reset_dirty=False), jconf)
    assert list(got) == list(want) == list(QUANT_FIELDS)
    for k in QUANT_FIELDS:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    q = QuantServingTable(pconf, device="cpu")
    q._install(got)
    r = ref_quant.QuantServingTable(jconf)
    r._install(want)
    probe = np.concatenate([[0], np.arange(1, 640, 3), [999999,
                                                        2 ** 63 + 5]]
                           ).astype(np.uint64)
    pq = q.pull(probe).numpy()
    np.testing.assert_array_equal(pq, r.pull(probe))
    pf = pt.pull(probe, create=False)
    np.testing.assert_array_equal(pf[:, :2], pq[:, :2])
    step = np.abs(pf[:, 2:]).max(axis=1, keepdims=True) / 127.0
    assert np.all(np.abs(pf[:, 2:] - pq[:, 2:]) <= step + 1e-7)
    assert not pq[0].any() and not pq[-2:].any()
    assert not q.pull(np.arange(400, 500, dtype=np.uint64))[:, 3:].any()
    assert len(q) == len(r) == 600
    assert q.memory_bytes() == r.memory_bytes()
    assert q.memory_bytes() <= 0.35 * pt.memory_bytes() or kw


def test_quantized_loads_match_reference(tmp_path):
    """``load``, ``load_delta`` (new and replaced rows), ``load_f32`` and
    ``load_delta_f32`` over files either package wrote: pulls bit for bit
    against the reference's table fed the same files; the pull-only and
    variable-layout refusals."""
    (pt, pconf), (jt, jconf) = filled_tables()
    base_f32 = str(tmp_path / "table.npz")
    pt.save(base_f32)
    base_q8 = str(tmp_path / "base.q8.npz")
    atomic.write_npz(base_q8, quantize_snapshot(pt.snapshot(), pconf))
    rng = np.random.default_rng(3)
    keys = np.concatenate([np.arange(1, 50),
                           np.arange(9000, 9030)]).astype(np.uint64)
    pt.feed_pass(keys)
    g = np.zeros((keys.size, pconf.pull_dim), np.float32)
    g[:, 0] = 4.0
    g[:, 2:] = rng.normal(0, 0.2, (keys.size, pconf.pull_dim - 2))
    pt.push(keys, g)
    delta_f32 = str(tmp_path / "delta.npz")
    pt.save_delta(delta_f32)
    delta_q8 = str(tmp_path / "delta.q8.npz")
    atomic.write_npz(delta_q8, quantize_snapshot(
        dict(np.load(delta_f32)), pconf))
    probe = np.concatenate([keys, np.arange(1, 700, 3)]).astype(np.uint64)
    outs = []
    for q in (QuantServingTable(pconf, device="cpu"),
              ref_quant.QuantServingTable(jconf)):
        q.load(base_q8)
        q.load_delta(delta_q8)
        a = np.asarray(q.pull(probe))
        q.load_f32(base_f32)
        q.load_delta_f32(delta_f32)
        outs.append((a, np.asarray(q.pull(probe)), len(q)))
    (pa, pb, pn), (ja, jb, jn) = outs
    np.testing.assert_array_equal(pa, ja)
    np.testing.assert_array_equal(pb, jb)
    np.testing.assert_array_equal(pa, pb)
    assert pn == jn == 630
    pf = pt.pull(probe, create=False)
    np.testing.assert_array_equal(pf[:, :2], pa[:, :2])
    q = QuantServingTable(pconf, device="cpu")
    with pytest.raises(ValueError):
        q.pull(np.array([1], np.uint64), create=True)
    with pytest.raises(ValueError):
        value_groups(dataclasses.replace(pconf, expand_dim=4,
                                         variable_embedding=True))


# -- the export beside each checkpoint -----------------------------------------

class _NullDataset:
    def release_memory(self):
        pass


def pm_worlds(root, n=1):
    """A PassManager over a host table in each package, roots
    ``root/port`` and ``root/ref``, keeping ``n`` bases."""
    out = []
    for name, tcls, ccls, pcls, scls in (
            ("port", EmbeddingTable, TableConfig, PassManager, SparsePS),
            ("ref", RefTable, JaxTableConfig, RefPassManager,
             RefSparsePS)):
        conf = ccls(**conf_kw(embedx_threshold=0.0))
        t = tcls(conf, backend="numpy")
        pm = pcls(scls({"embedding": t}), str(root / name), [_NullDataset()],
                  keep_bases=n)
        pm.set_date("20260803")
        out.append((t, conf, pm))
    return out


def mutate(t, conf, seed, n=128):
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, 5000, n).astype(np.uint64)
    g = np.zeros((n, conf.pull_dim), np.float32)
    g[:, 0] = 3.0
    g[:, 2:] = rng.normal(0, 0.1, (n, conf.pull_dim - 2))
    t.feed_pass(keys)
    t.push(keys, g)


def test_q8_export_crosses_packages(tmp_path, econ_flags):
    """Under ``serve_quantized`` both managers commit a ``.q8`` sibling of
    each base and delta, with a manifest, named by no donefile record; the
    siblings' arrays are the same in both packages, and each package's
    sibling loads in the other's quantized table to the same pulls."""
    econ_flags("serve_quantized", True)
    worlds = pm_worlds(tmp_path)
    sib = {}
    for name, (t, conf, pm) in zip(("port", "ref"), worlds):
        pm.pass_id = 1
        mutate(t, conf, 0)
        pm.save_base(wait=True)
        pm.pass_id = 2
        mutate(t, conf, 1)
        pm.save_delta(wait=True)
        root = str(tmp_path / name)
        base, deltas = discovery.latest_committed(root)
        q8b = discovery.quantized_sibling(base["path"])
        q8d = discovery.quantized_sibling(deltas[0]["path"])
        assert (q8b, q8d) == (base["path"] + ".q8",
                              deltas[0]["path"] + ".q8")
        atomic.verify(q8b, require_manifest=True)
        recorded = {r["path"] for r in donefile.read_done(root)}
        assert q8b not in recorded and q8d not in recorded
        sib[name] = (q8b, q8d)
        pm.close()
    for i in range(2):
        with np.load(os.path.join(sib["port"][i], "embedding.npz")) as a, \
                np.load(os.path.join(sib["ref"][i], "embedding.npz")) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
    probe = np.arange(1, 5000, 13, dtype=np.uint64)
    pconf, jconf = worlds[0][1], worlds[1][1]
    for src in ("port", "ref"):
        q = QuantServingTable(pconf, device="cpu")
        r = ref_quant.QuantServingTable(jconf)
        for x in (q, r):
            x.load(os.path.join(sib[src][0], "embedding.npz"))
            x.load_delta(os.path.join(sib[src][1], "embedding.npz"))
        np.testing.assert_array_equal(q.pull(probe).numpy(), r.pull(probe))


def test_q8_export_off_corrupt_and_retention(tmp_path, econ_flags):
    """The flag off exports nothing; a torn sibling is ignored with a
    warning; retention prunes a sibling with its parent."""
    (t, conf, pm), _ = pm_worlds(tmp_path, n=1)
    root = str(tmp_path / "port")
    pm.pass_id = 1
    mutate(t, conf, 0)
    pm.save_base(wait=True)
    base1, _ = discovery.latest_committed(root)
    assert discovery.quantized_sibling(base1["path"]) is None
    assert not os.path.isdir(base1["path"] + ".q8")
    econ_flags("serve_quantized", True)
    pm.pass_id = 2
    mutate(t, conf, 1)
    pm.save_base(wait=True)
    base2, _ = discovery.latest_committed(root)
    assert not os.path.isdir(base1["path"])       # keep_bases=1
    q8 = discovery.quantized_sibling(base2["path"])
    assert q8 is not None
    pm.pass_id = 3
    mutate(t, conf, 2)
    pm.save_base(wait=True)
    assert not os.path.isdir(base2["path"]) and not os.path.isdir(q8)
    base3, _ = discovery.latest_committed(root)
    with open(os.path.join(base3["path"] + ".q8", "embedding.npz"),
              "wb") as f:
        f.write(b"torn")
    with pytest.warns(UserWarning, match="quantized"):
        assert discovery.quantized_sibling(base3["path"]) is None
    pm.close()


@pytest.mark.parametrize("point", ["base.before_q8",
                                   "base.q8.before_manifest",
                                   "base.q8.after_manifest"])
def test_crash_mid_export_leaves_trail_whole(tmp_path, econ_flags, point):
    """A crash at each point of the ``.q8`` commit: the float32 trail
    stays whole (the crashed save never reaches the donefile), a fresh
    manager sweeps the staging spill and resumes, and the earlier base
    keeps its sibling."""
    econ_flags("serve_quantized", True)
    (t, conf, pm), _ = pm_worlds(tmp_path)
    root = str(tmp_path / "port")
    pm.pass_id = 1
    mutate(t, conf, 0)
    pm.save_base(wait=True)
    pm.pass_id = 2
    mutate(t, conf, 1)
    faults.arm(point)
    try:
        with pytest.raises(faults.InjectedCrash):
            pm.save_base(wait=True)
    finally:
        faults.disarm_all()
    t2 = EmbeddingTable(conf, backend="numpy")
    pm2 = PassManager(SparsePS({"embedding": t2}), root, [_NullDataset()],
                      keep_bases=1)
    assert pm2.resume() is not None
    leftovers = [d for _c, dirs, _f in os.walk(root) for d in dirs
                 if ".tmp-" in d]
    assert not leftovers
    base, _ = discovery.latest_committed(root)
    assert base["pass_id"] == 1
    assert discovery.quantized_sibling(base["path"]) is not None
    pm.close()
    pm2.close()


# -- the knobs -----------------------------------------------------------------

@pytest.mark.parametrize("setting,match", [
    ({}, None),
    ({"serve_cache_rows": -1}, ">= 0"),
    ({"serve_cache_rows": 1}, "smaller"),
    ({"serve_cache_rows": 15}, "smaller"),
    ({"serve_cache_rows": 64, "enable_pull_padding_zero": False}, "padding"),
    ({"serve_coalesce": True, "enable_pullpush_dedup_keys": False},
     "dedup"),
    ({"serve_quantized": True, "serve_cache_rows": 16,
      "serve_coalesce": True}, None),
])
def test_econ_flags_match_reference(setting, match, econ_flags):
    """Defaults off; the same validation and messages as the reference."""
    for k, v in setting.items():
        econ_flags(k, v)
    if match is None:
        got = serving_econ_conf()
        want = ref_econ_conf()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        return
    with pytest.raises(ValueError, match=match) as got:
        serving_econ_conf()
    with pytest.raises(ValueError) as want:
        ref_econ_conf()
    assert str(got.value) == str(want.value)


# -- the predictor -------------------------------------------------------------

def feed_confs():
    jconf = JaxFeedConfig(
        slots=[JaxSlotConfig("label", type="float", is_dense=True, dim=1),
               JaxSlotConfig("slot_a"), JaxSlotConfig("slot_b")],
        batch_size=8)
    return jconf, DataFeedConfig.from_dict(dataclasses.asdict(jconf))


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A DeepFM bundle (the reference's flax params converted) over a
    filled host table, with ``table.q8.npz``, and records to score."""
    root = tmp_path_factory.mktemp("econ")
    jfeed, pfeed = feed_confs()
    (pt, pconf), _ = filled_tables(n=200, embedx_dim=4)
    flax = FlaxDeepFM(hidden=(8,))
    params = flax.init(jax.random.PRNGKey(4), np.zeros((2, 2, 7), np.float32),
                       np.zeros((2, 0), np.float32))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]
    model = deepfm_from_flax_leaves(leaves, (8,))
    os.environ["PBOX_FLAGS_serve_quantized"] = "1"
    try:
        path = save_inference_model(str(root / "export"), model,
                                    pt.snapshot(reset_dirty=False), pfeed,
                                    pconf, version="19700101/00003")
    finally:
        del os.environ["PBOX_FLAGS_serve_quantized"]
    rng = np.random.default_rng(11)
    lines = []
    for _ in range(100):
        label = int(rng.integers(0, 2))
        ka = rng.integers(1, 260, 3)            # some keys absent
        kb = rng.integers(1, 120, 2)
        lines.append(f"1 {label} 3 " + " ".join(map(str, ka)) + " 2 "
                     + " ".join(map(str, kb)))
    parser = SlotParser(pfeed)
    records = [parser.parse_line(ln) for ln in lines]
    from paddlebox_tpu.data.parser import SlotParser as JaxParser
    jparser = JaxParser(jfeed)
    jrecords = [jparser.parse_line(ln) for ln in lines]
    return path, pt, pconf, records, jrecords


def test_bundle_q8_equals_reference_quantizer(bundle):
    """``save_inference_model`` under ``serve_quantized`` writes
    ``table.q8.npz``: the reference's quantizer over the bundle's
    ``table.npz``, array for array."""
    path, _pt, pconf, _r, _j = bundle
    jconf = JaxTableConfig(**dataclasses.asdict(pconf))
    with np.load(os.path.join(path, "table.q8.npz")) as q8, \
            np.load(os.path.join(path, "table.npz")) as f32:
        want = ref_quant.quantize_snapshot(f32, jconf)
        assert sorted(q8.files) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(q8[k], want[k])


@pytest.mark.parametrize("quantized", [True, False])
def test_predictor_scores_match_reference(bundle, econ_flags, quantized):
    """Scores of the quantized (and the float32) table against the
    reference predictor's over the same bundle within 1e-5; the quantized
    scores near the float32 ones."""
    path, _pt, _c, records, jrecords = bundle
    econ_flags("serve_quantized", quantized)
    pred = CTRPredictor(path, device="cpu")
    assert isinstance(pred.table, QuantServingTable if quantized
                      else ServingTable)
    assert pred.serves_quantized == quantized and pred.cache_stats() is None
    got = pred.predict_records(records)
    want = JaxPredictor(path).predict_records(jrecords)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    econ_flags("serve_quantized", False)
    f32 = CTRPredictor(path, device="cpu").predict_records(records)
    assert np.abs(got - f32).max() < 0.02


def test_cache_and_coalesce_bit_identical(bundle, econ_flags):
    """With the hot-key cache and coalescing on, cold and warm, the scores
    are the bits of the plain quantized predictor's; the cache's counters
    equal the reference predictor's over the same calls; coalescing
    counted the pulls it saved; a bundle holding only ``table.q8.npz``
    serves the same scores, and quantizing ``table.npz`` on load too."""
    path, _pt, _c, records, jrecords = bundle
    econ_flags("serve_quantized", True)
    base = CTRPredictor(path, device="cpu").predict_records(records)
    econ_flags("serve_cache_rows", 256)
    econ_flags("serve_coalesce", True)
    pred = CTRPredictor(path, device="cpu")
    jpred = JaxPredictor(path)
    for _ in range(2):                       # cold, then warm
        np.testing.assert_array_equal(pred.predict_records(records), base)
        jpred.predict_records(jrecords)
        assert pred.cache_stats() == jpred.cache_stats()
    assert pred.cache_stats()["hits"] > 0 and pred.coalesced_keys > 0
    econ_flags("serve_coalesce", False)
    pred = CTRPredictor(path, device="cpu")
    np.testing.assert_array_equal(pred.predict_records(records), base)
    np.testing.assert_array_equal(pred.predict_batch(
        pred.assembler.assemble(records[:8])), base[:8])
    q8_only = os.path.join(os.path.dirname(path), "q8_only")
    os.makedirs(q8_only, exist_ok=True)
    for f in ("model.json", "dense.npz", "table.q8.npz"):
        with open(os.path.join(path, f), "rb") as src, \
                open(os.path.join(q8_only, f), "wb") as dst:
            dst.write(src.read())
    econ_flags("serve_cache_rows", 0)
    np.testing.assert_array_equal(
        CTRPredictor(q8_only, device="cpu").predict_records(records), base)
    f32_only = os.path.join(os.path.dirname(path), "f32_only")
    os.makedirs(f32_only, exist_ok=True)
    for f in ("model.json", "dense.npz", "table.npz"):
        with open(os.path.join(path, f), "rb") as src, \
                open(os.path.join(f32_only, f), "wb") as dst:
            dst.write(src.read())
    np.testing.assert_array_equal(
        CTRPredictor(f32_only, device="cpu").predict_records(records), base)


def test_predictor_validates_and_refuses(bundle, econ_flags):
    """A bad knob fails at construction; a predictor over a remote PS
    loads no table and serves no quantized one; the reload fingerprint is
    ported: a reload of the same bundle, quantized or not, lands on the
    same forward and counts no ``serving.reload_recompiled``."""
    from paddlebox_tpu_torch.obs.metrics import REGISTRY
    path = bundle[0]
    econ_flags("serve_cache_rows", 3)
    with pytest.raises(ValueError):
        CTRPredictor(path, device="cpu")
    econ_flags("serve_cache_rows", 0)
    remote = CTRPredictor(path, device="cpu", ps_endpoints=["localhost:1"])
    assert remote.ps_endpoints == ["localhost:1"]
    assert type(remote.table).__name__ == "RemoteTable"
    pred = CTRPredictor(path, device="cpu")
    before = REGISTRY.counter("serving.reload_recompiled").get()
    econ_flags("serve_quantized", True)
    assert not CTRPredictor(path, device="cpu",
                            ps_endpoints=["localhost:1"]).serves_quantized
    again = CTRPredictor(path, device="cpu", reload_of=pred)
    assert again.fwd_fingerprint() == pred.fwd_fingerprint()
    assert REGISTRY.counter("serving.reload_recompiled").get() == before
