"""Port's disk ladder (``paddlebox_tpu_torch/ps/bloom.py``,
``ps/admission.py``, ``ps/ssd_tier.py``, ``utils/faults.py`` and the disk,
admission and deferred-demote paths of ``ps/tiered_table.py``) against the
JAX package's, on the CPU.

Held exactly (the same arithmetic in the same order, no float reduction
across packages): the bloom filter's bit array; the count-min sketch's
counts, epochs and decisions; a disk root's chunk files byte for byte when
both packages run the same spills and compactions, and a root written by
either package resumed by the other (index, ``read_rows``, ``stage``,
``evict_cold``, ``compact``, ``consume_read``); the tiered table over a
disk tier, synchronous, with prefetch and the deferred demote, and with
admission, against the reference's over the same passes (each pass's W,
the backing and the disk by key, the mid-pass gate). The port's own fault
cases mirror ``tests/test_disk_cold_path.py``'s (``ssd.spill``,
``ssd.read``, ``ssd.compact``, a failed deferred demote)."""

import os
import shutil

import numpy as np
import pytest
import torch

from paddlebox_tpu import flags as ref_flags
from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.ps import admission as ref_admission
from paddlebox_tpu.ps import bloom as ref_bloom
from paddlebox_tpu.ps.ssd_tier import DiskTier as RefDiskTier
from paddlebox_tpu.ps.table import EmbeddingTable as RefTable
from paddlebox_tpu.ps.tiered_table import TieredDeviceTable as RefTiered
from paddlebox_tpu.utils import faults as ref_faults
from paddlebox_tpu_torch.config import TableConfig
from paddlebox_tpu_torch.ps import admission, bloom
from paddlebox_tpu_torch.ps.ssd_tier import DiskTier
from paddlebox_tpu_torch.ps.table import EmbeddingTable
from paddlebox_tpu_torch.ps.tiered_table import TieredDeviceTable
from paddlebox_tpu_torch.utils.faults import (FaultInjector,
                                              install_injector, io_point,
                                              with_retries)

TABLE = dict(embedx_dim=4, cvm_offset=3, optimizer="adagrad",
             learning_rate=0.1, embedx_threshold=0.0, seed=9,
             show_clk_decay=0.5)
PKG = {"ref": (RefTable, RefDiskTier, JaxTableConfig),
       "port": (EmbeddingTable, DiskTier, TableConfig)}


def push_shows(table, keys, show):
    g = np.zeros((keys.size, table.conf.pull_dim), np.float32)
    g[:, 0] = show
    g[:, 3:] = 0.01 * show
    table.push(keys, g)


def table_rows(t):
    n = t._size
    keys = t._index.dump_keys(n)
    order = np.argsort(keys)
    return (keys[order], t._values[:n][order], t._state[:n][order],
            t._embedx_ok[:n][order])


def assert_rows_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def chunk_files(root):
    return {f: open(os.path.join(root, f), "rb").read()
            for f in sorted(os.listdir(root)) if f.endswith(".pbxd")}


# -- the bloom filter and the admission sketch --------------------------------

@pytest.mark.parametrize("bits_per_key", [4, 10])
def test_bloom_bits_match_reference(bits_per_key):
    rng = np.random.default_rng(1)
    keys = rng.integers(1, 1 << 63, size=5000, dtype=np.uint64)
    keys[:3] = [1, np.uint64(2 ** 64 - 1), np.uint64(2 ** 63)]
    got, want = (bloom.BlockedBloom(3000, bits_per_key),
                 ref_bloom.BlockedBloom(3000, bits_per_key))
    for chunk in np.array_split(keys, 3):
        got.add_bulk(chunk)
        want.add_bulk(chunk)
    assert (got.k, got.n_blocks, got.n_added) == \
        (want.k, want.n_blocks, want.n_added)
    np.testing.assert_array_equal(got._words, want._words)
    probe = np.concatenate([keys[::7], rng.integers(
        1, 1 << 63, size=4000, dtype=np.uint64)])
    hit = got.contains_bulk(probe)
    np.testing.assert_array_equal(hit, want.contains_bulk(probe))
    assert hit[:keys[::7].size].all()          # no false negative
    assert got.saturated == want.saturated
    for salt in (1, 11, 13):
        np.testing.assert_array_equal(bloom._mix(probe, salt),
                                      ref_bloom._mix(probe, salt))


@pytest.mark.parametrize("decay", [1.0, 0.7])
def test_admission_decisions_match_reference(decay):
    """Five passes of keys with repeats: the observed decisions, the
    read-only estimates (this epoch and one ahead), an off-step observe
    pinned to the next epoch, the counts and block epochs, exactly."""
    rng = np.random.default_rng(2)
    got = admission.CountMinAdmission(3.0, decay=decay, width=1 << 10)
    want = ref_admission.CountMinAdmission(3.0, decay=decay, width=1 << 10)
    for p in range(5):
        keys = rng.integers(1, 400, size=900).astype(np.uint64)
        uniq, counts = np.unique(keys, return_counts=True)
        if p == 3:      # the tier worker's decision for the next pass
            a = got.observe_and_admit(uniq, counts, at_epoch=got.epoch + 1)
            b = want.observe_and_admit(uniq, counts,
                                       at_epoch=want.epoch + 1)
        else:
            a = got.observe_and_admit(uniq, counts)
            b = want.observe_and_admit(uniq, counts)
        np.testing.assert_array_equal(a, b)
        probe = np.arange(1, 500, dtype=np.uint64)
        for ahead in (0, 1):
            np.testing.assert_array_equal(got.estimate(probe, ahead),
                                          want.estimate(probe, ahead))
            np.testing.assert_array_equal(got.admitted(probe, ahead),
                                          want.admitted(probe, ahead))
        got.advance_epoch()
        want.advance_epoch()
    np.testing.assert_array_equal(got._counts, want._counts)
    np.testing.assert_array_equal(got._block_epoch, want._block_epoch)
    assert got.memory_bytes() == want.memory_bytes()


def test_admission_from_flags_and_pass_decision(monkeypatch, tmp_path):
    """``from_flags`` over the reference's flag names; ``admit_pass_keys``
    over a backing and a disk tier: known keys always stage, new ones go
    through the sketch, in both packages alike."""
    assert admission.from_flags() is None
    monkeypatch.setenv("PBOX_FLAGS_ps_admit_shows", "2")
    monkeypatch.setenv("PBOX_FLAGS_ps_admit_decay", "0.5")
    monkeypatch.setenv("PBOX_FLAGS_ps_admit_width", "4096")
    a = admission.from_flags()
    assert (a.threshold, a.decay_factor, a.width) == (2.0, 0.5, 4096)
    assert admission.resolve(admission.DISABLED) is None
    assert admission.resolve(a) is a
    out = {}
    for name, (tcls, dcls, ccls) in PKG.items():
        t = tcls(ccls(**TABLE), backend="numpy")
        t.feed_pass(np.arange(1, 50, dtype=np.uint64))
        disk = dcls(t, str(tmp_path / name), bloom_bits_per_key=10)
        disk.evict_cold(show_threshold=np.inf)
        t.feed_pass(np.arange(50, 80, dtype=np.uint64))
        mod = admission if name == "port" else ref_admission
        sketch = mod.CountMinAdmission(2.0, width=4096)
        keys = np.concatenate([np.arange(1, 200, dtype=np.uint64),
                               np.arange(150, 200, dtype=np.uint64)])
        uniq, counts = np.unique(keys, return_counts=True)
        out[name] = (mod.known_keys(uniq, t, disk),
                     mod.admit_pass_keys(uniq, counts, t, disk, sketch))
    np.testing.assert_array_equal(out["port"][0], out["ref"][0])
    np.testing.assert_array_equal(out["port"][1][0], out["ref"][1][0])
    assert out["port"][1][1:] == out["ref"][1][1:]
    assert out["port"][1][2] > 0 and out["port"][0][:79].all()


# -- the disk tier across the packages ------------------------------------------

def disk_run(name, root):
    """The same spills, stages and compactions in package ``name``: three
    spill generations (a row spilled twice: the latest wins), a restage of
    a trained copy, a compaction, a spill after it."""
    tcls, dcls, ccls = PKG[name]
    t = tcls(ccls(**TABLE), backend="numpy")
    tier = dcls(t, root, bloom_bits_per_key=10)
    push_shows(t, np.arange(1, 301, dtype=np.uint64), 1.0)
    assert tier.evict_cold(show_threshold=np.inf) == 300
    push_shows(t, np.arange(200, 501, dtype=np.uint64), 2.0)
    assert tier.evict_cold(show_threshold=2.5) == 301
    # stage 250..349 (trained copies win over nothing: all from disk)
    assert tier.stage(np.arange(250, 350, dtype=np.uint64)) == 100
    push_shows(t, np.arange(250, 300, dtype=np.uint64), 3.0)
    tier.compact()
    push_shows(t, np.arange(600, 650, dtype=np.uint64), 0.5)
    assert tier.evict_cold(show_threshold=1.0) == 50
    return t, tier


def test_disk_runs_write_the_same_chunks(tmp_path):
    """Both packages through ``disk_run``: chunk files byte for byte, the
    table rows, ``len``, ``io_stats`` byte counts and ``disk_bytes``."""
    (rt, rtier), (pt, ptier) = (disk_run(n, str(tmp_path / n))
                                for n in ("ref", "port"))
    assert chunk_files(str(tmp_path / "port")) == \
        chunk_files(str(tmp_path / "ref"))
    assert_rows_equal(table_rows(pt), table_rows(rt))
    assert len(ptier) == len(rtier) > 0
    for k in ("spill_bytes", "stage_bytes"):
        assert ptier.io_stats[k] == rtier.io_stats[k] > 0
    assert ptier.disk_bytes() == rtier.disk_bytes()
    bw = ptier.bandwidth()
    assert set(bw) == set(rtier.bandwidth())
    assert bw["spill_mb_per_s"] > 0 and bw["stage_mb_per_s"] > 0


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_disk_root_resumes_across_packages(writer, tmp_path):
    """A root written by ``writer``, reopened by each package over a fresh
    table (``resume=True``): the same index, the same ``read_rows``; then
    the same ``stage``, ``consume_read`` (a row a push trained supersedes
    its disk copy), ``evict_cold`` and ``compact`` in both, which leave
    the same tables and byte-identical roots."""
    src = str(tmp_path / "written")
    disk_run(writer, src)
    worlds = {}
    for name, (tcls, dcls, ccls) in PKG.items():
        root = str(tmp_path / f"resumed_{name}")
        shutil.copytree(src, root)
        t = tcls(ccls(**TABLE), backend="numpy")
        worlds[name] = (t, dcls(t, root, resume=True), root)
    (rt, rtier, rroot), (pt, ptier, proot) = worlds["ref"], worlds["port"]
    rk, pk = (np.sort(x._index.live_items()[0]) for x in (rtier, ptier))
    np.testing.assert_array_equal(pk, rk)
    probe = np.arange(1, 700, dtype=np.uint64)
    for a, b in zip(ptier.read_rows(probe), rtier.read_rows(probe)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ptier.contains_bulk(probe),
                                  rtier.contains_bulk(probe))
    out = {}
    for name, (t, tier, root) in worlds.items():
        # a memory row trained after the read: consume_read drops the
        # disk copy and reports it
        read = tier.read_rows(np.arange(1, 120, dtype=np.uint64))
        t.feed_pass(np.arange(100, 110, dtype=np.uint64))
        push_shows(t, np.arange(100, 110, dtype=np.uint64), 4.0)
        stale = tier.consume_read(*read)
        staged = tier.stage(np.arange(120, 260, dtype=np.uint64))
        spilled = tier.evict_cold(show_threshold=3.0)
        tier.compact()
        out[name] = (np.sort(stale), staged, spilled)
    np.testing.assert_array_equal(out["port"][0], out["ref"][0])
    assert out["port"][0].size == 10
    assert out["port"][1:] == out["ref"][1:]
    assert_rows_equal(table_rows(pt), table_rows(rt))
    assert chunk_files(proot) == chunk_files(rroot)


# -- the tiered table over the disk tier ----------------------------------------

def tiered_stream(name, root, mode, monkeypatch):
    """Four passes through package ``name``'s ``TieredDeviceTable`` over a
    numpy backing and a ``DiskTier`` at ``root``: a persistent head of
    keys and a new slab each pass (its keys repeated so admission sees
    counts), the staged rows "trained" by a deterministic write (show +
    p + 1, every row dirty), then after each ``end_pass`` every row
    spilled (``evict_cold(inf)``) and the root compacted, so each pass
    restages from disk. ``mode``: "sync"; "async" (the next pass
    prefetched after the first write, the deferred demote on); "admit"
    (a count-min threshold of 2 shows)."""
    tcls, dcls, ccls = PKG[name]
    conf = ccls(**TABLE)
    backing = tcls(conf, backend="numpy")
    disk = dcls(backing, root, bloom_bits_per_key=10)
    kw = {}
    if mode == "admit":
        mod = admission if name == "port" else ref_admission
        kw["admit"] = mod.CountMinAdmission(2.0, decay=0.5, width=4096)
    if name == "port":
        table = TieredDeviceTable(conf, backing=backing, capacity=1 << 11,
                                  disk=disk, backend="numpy", device="cpu",
                                  **kw)
    else:
        table = RefTiered(conf, backing=backing, capacity=1 << 11,
                          disk=disk, backend="numpy", **kw)
    demote = mode == "async"
    if name == "port":
        monkeypatch.setenv("PBOX_FLAGS_ps_tier_demote", "1" if demote
                           else "0")
    else:
        ref_flags.set("ps_tier_demote", demote)
    rng = np.random.default_rng(5)
    passes = []
    for p in range(4):
        head = np.arange(1, 150, dtype=np.uint64)
        slab = rng.integers(1000, 1000 + 600 * (p + 1), size=500,
                            dtype=np.uint64)
        passes.append(np.concatenate([head, slab, slab[:200]]))
    ws, gates = [], []
    try:
        for p, keys in enumerate(passes):
            w = table.begin_feed_pass(keys)
            ws.append(w)
            rows = np.arange(1, w + 1)
            if name == "port":
                table.values[torch.from_numpy(rows), 0] += p + 1
            else:
                import jax.numpy as jnp
                vals = np.asarray(table.values).copy()
                vals[rows, 0] += p + 1
                table.values = jnp.asarray(vals)
            table._dirty[rows] = True
            if mode == "async" and p + 1 < len(passes):
                table.prefetch_feed_pass(passes[p + 1])
            if mode == "admit":
                probe = np.arange(1000, 1000 + 600 * (p + 2), 7,
                                  dtype=np.uint64)
                gates.append(table._gate_new_keys(probe))
            table.end_pass()
            disk.evict_cold(show_threshold=np.inf)
            disk.compact()
    finally:
        if name == "ref":
            ref_flags.set("ps_tier_demote", False)
    n_disk = len(disk)
    lk = np.sort(disk._index.live_items()[0])
    disk_rows = disk.read_rows(lk)
    disk.stage(lk)
    return ws, gates, n_disk, disk_rows, table_rows(backing), \
        chunk_files(root)


@pytest.mark.parametrize("mode", ["sync", "async", "admit"])
def test_tiered_over_disk_matches_reference(mode, tmp_path, monkeypatch):
    """``TieredDeviceTable(disk=...)`` in each package over the same
    passes: each pass's W, the mid-pass gate (admission), the disk's
    rows and the backing by key after the passes, and the chunk files,
    exactly."""
    got = tiered_stream("port", str(tmp_path / "port"), mode, monkeypatch)
    want = tiered_stream("ref", str(tmp_path / "ref"), mode, monkeypatch)
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    assert got[2] == want[2] > 0
    for a, b in zip(got[3], want[3]):
        np.testing.assert_array_equal(a, b)
    assert_rows_equal(got[4], want[4])
    assert got[5] == want[5]
    if mode == "admit":
        # one-shot slab keys never got a backing or disk row
        assert got[0][0] < 149 + 500
        assert any((g == 0).any() for g in got[1])


def test_prefetch_and_demote_equal_sync(tmp_path, monkeypatch):
    """Within the port: the prefetching, deferred-demote stream (its
    prefetches consumed, not dropped) against the synchronous one, bit
    for bit (the FIFO argument), and the admission stream's rejected keys
    absent from every tier."""
    sync = tiered_stream("port", str(tmp_path / "s"), "sync", monkeypatch)
    consume, taken = TieredDeviceTable._consume_prefetch, []

    def spy(self, raw_uniq):
        out = consume(self, raw_uniq)
        taken.append(out is not None)
        return out

    monkeypatch.setattr(TieredDeviceTable, "_consume_prefetch", spy)
    asyn = tiered_stream("port", str(tmp_path / "a"), "async", monkeypatch)
    # passes 2-4 took their prefetched buffers (disk reads, restages)
    assert taken == [False, True, True, True]
    assert sync[0] == asyn[0] and sync[2] == asyn[2]
    assert_rows_equal(sync[4], asyn[4])
    assert sync[5] == asyn[5]
    adm = tiered_stream("port", str(tmp_path / "m"), "admit", monkeypatch)
    assert sum(adm[0]) < sum(sync[0])
    assert adm[4][0].size < sync[4][0].size
    assert np.isin(adm[4][0], sync[4][0]).all()


def test_evict_cold_skips_the_open_pass(tmp_path):
    conf = TableConfig(**TABLE)
    t = EmbeddingTable(conf, backend="numpy")
    tier = DiskTier(t, str(tmp_path / "ssd"))
    table = TieredDeviceTable(conf, backing=t, capacity=256, disk=tier,
                              device="cpu")
    staged = np.arange(1, 40, dtype=np.uint64)
    other = np.arange(100, 160, dtype=np.uint64)
    t.feed_pass(other)
    table.begin_feed_pass(staged)
    assert tier.evict_cold(show_threshold=np.inf) == other.size
    assert not tier.contains_bulk(staged).any()
    table.end_pass()
    assert tier.evict_cold(show_threshold=np.inf) == staged.size


# -- faults -------------------------------------------------------------------

@pytest.fixture
def built(tmp_path):
    t = EmbeddingTable(TableConfig(**TABLE), backend="numpy")
    tier = DiskTier(t, str(tmp_path / "ssd"))
    expect = {}
    for c in range(2):
        ks = np.arange(c * 300 + 1, (c + 1) * 300 + 1, dtype=np.uint64)
        push_shows(t, ks, 1.0 + c)
        expect.update((int(k), 1.0 + c) for k in ks)
        tier.evict_cold(show_threshold=np.inf)
    yield t, tier, np.array(sorted(expect), np.uint64), expect
    install_injector(None)


def test_failed_compact_write_leaves_tier_intact(built):
    t, tier, keys, expect = built
    install_injector(FaultInjector(seed=3, fail_rate=1.0, ops=("ssd.spill",)))
    with pytest.raises(OSError, match="ssd.spill"):
        tier.compact()
    install_injector(None)
    assert len(tier) == keys.size
    ks, vals, *_ = tier.read_rows(keys)
    assert [float(v) for v in vals[:, 0]] == [expect[int(k)] for k in ks]
    tier.compact()
    assert len(tier) == keys.size and len(tier._disk_cids()) == 1


def test_read_fault_releases_chunk_pins(built):
    t, tier, keys, _ = built
    install_injector(FaultInjector(seed=1, fail_rate=1.0, ops=("ssd.read",)))
    with pytest.raises(OSError, match="ssd.read"):
        tier.read_rows(keys)
    install_injector(None)
    tier.compact()
    assert tier._guards.pending_deletes() == 0
    assert len(tier._disk_cids()) == 1


def test_compact_fault_changes_nothing(built):
    t, tier, keys, _ = built
    before = chunk_files(tier.root)
    install_injector(FaultInjector(seed=2, fail_rate=1.0,
                                   ops=("ssd.compact",)))
    with pytest.raises(OSError, match="ssd.compact"):
        tier.compact()
    install_injector(None)
    assert chunk_files(tier.root) == before and len(tier) == keys.size


def test_spill_fault_keeps_rows_in_memory(built):
    """A failed spill leaves its rows in the table and the index without
    them; the next eviction spills them."""
    t, tier, keys, _ = built
    fresh = np.arange(5000, 5100, dtype=np.uint64)
    push_shows(t, fresh, 1.0)
    n_mem, n_disk = len(t), len(tier)
    install_injector(FaultInjector(seed=4, fail_rate=1.0, ops=("ssd.spill",)))
    with pytest.raises(OSError):
        tier.evict_cold(show_threshold=np.inf)
    install_injector(None)
    assert len(t) == n_mem and len(tier) == n_disk
    assert not tier.contains_bulk(fresh).any()
    assert tier.evict_cold(show_threshold=np.inf) == fresh.size
    assert tier.contains_bulk(fresh).all()


def test_injector_and_retries_match_reference():
    """A seeded injector fails the same calls in both packages;
    ``with_retries`` backs off, honours ``giveup`` and re-raises at the
    last attempt."""
    got, want = [], []
    for mod, out in ((None, got), (ref_faults, want)):
        inj = (FaultInjector if mod is None else mod.FaultInjector)(
            seed=7, fail_rate=0.4, ops=("ssd.read",), max_failures=5)
        (install_injector if mod is None else mod.install_injector)(inj)
        point = io_point if mod is None else mod.io_point
        for op in ("ssd.read", "ssd.spill") * 10:
            try:
                point(op)
                out.append(0)
            except OSError:
                out.append(1)
        (install_injector if mod is None else mod.install_injector)(None)
    assert got == want and sum(got) == 5
    calls, sleeps = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert with_retries(flaky, attempts=3, sleep=sleeps.append) == "ok"
    assert sleeps == [0.01, 0.02]
    with pytest.raises(FileNotFoundError):
        with_retries(lambda: open("/nonexistent/x"), sleep=sleeps.append,
                     giveup=lambda e: isinstance(e, FileNotFoundError))
    with pytest.raises(OSError):
        with_retries(lambda: (_ for _ in ()).throw(OSError("x")),
                     attempts=2, sleep=lambda s: None)


def test_deferred_demote_failure_surfaces_next_pass(monkeypatch):
    conf = TableConfig(**TABLE)
    table = TieredDeviceTable(conf, capacity=256, device="cpu",
                              backend="numpy")
    keys = np.arange(1, 20, dtype=np.uint64)
    table.begin_feed_pass(keys)
    table._dirty[1:keys.size + 1] = True

    def full(*a, **k):
        raise RuntimeError("disk full")

    monkeypatch.setattr(table.backing, "import_rows", full)
    monkeypatch.setenv("PBOX_FLAGS_ps_tier_demote", "1")
    table.end_pass()
    with pytest.raises(RuntimeError, match="disk full"):
        table.begin_feed_pass(keys)


def test_len_and_saves_fence_the_deferred_demote(monkeypatch, tmp_path):
    conf = TableConfig(**TABLE)
    table = TieredDeviceTable(conf, capacity=256, device="cpu",
                              backend="numpy")
    keys = np.arange(1, 50, dtype=np.uint64)
    monkeypatch.setenv("PBOX_FLAGS_ps_tier_demote", "1")
    table.begin_feed_pass(keys)
    table._dirty[1:keys.size + 1] = True
    table.end_pass()
    assert table._pending_demote
    assert len(table) == keys.size and not table._pending_demote
    table.begin_feed_pass(keys)
    table._dirty[1:keys.size + 1] = True
    table.end_pass()
    table.save(str(tmp_path / "base.npz"))
    assert not table._pending_demote
    with np.load(str(tmp_path / "base.npz")) as z:
        assert z["keys"].size == keys.size
