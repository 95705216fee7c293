"""The port's native host index (``paddlebox_tpu_torch/ps/native.py`` over
``csrc/pbx_index.cpp``) against the reference's (``paddlebox_tpu/ps/
native.py`` over ``csrc/pbx_ps.cpp``) on the same keys: every array bit for
bit. ``MtIndex`` numbers rows in thread-timing order, so it is held to its
contract instead. Then the port's ``DeviceTable(backend="native")`` against
the reference's, and the backend resolution.

Every test needs both packages' index cores (g++)."""

import numpy as np
import pytest

from paddlebox_tpu.config import BucketSpec as JaxBucketSpec
from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.ps import native as ref
from paddlebox_tpu.ps.device_table import DeviceTable as JaxDeviceTable
from paddlebox_tpu_torch.config import BucketSpec, TableConfig
from paddlebox_tpu_torch.ps import device_table as port_table
from paddlebox_tpu_torch.ps import native
from paddlebox_tpu_torch.ps.device_table import DeviceTable, SortedIndex

pytestmark = pytest.mark.skipif(
    not ref.available(), reason="native backend unavailable")

HIGH = np.uint64(1) << np.uint64(63)


def batch_keys(rng, n, lo=1, hi=1 << 64):
    """Keys over the whole uint64 range, with key 0, duplicates and keys at
    or above 2^63."""
    keys = rng.integers(lo, hi, size=n, dtype=np.uint64)
    keys[::9] = 0
    keys[3::11] |= HIGH
    keys[rng.integers(0, n, size=n // 7)] = keys[rng.integers(0, n,
                                                              size=n // 7)]
    return keys


@pytest.mark.parametrize("create,skip_zero", [(True, True), (True, False),
                                              (False, True)])
def test_lookup_matches_reference(create, skip_zero):
    rng = np.random.default_rng(0)
    a, b = ref.NativeIndex(), native.NativeIndex()
    for step in range(4):
        keys = batch_keys(rng, 3000, hi=1 << 14 if step % 2 else 1 << 64)
        ra = a.lookup(keys, create, skip_zero, 1 + len(a))
        rb = b.lookup(keys, create, skip_zero, 1 + len(b))
        np.testing.assert_array_equal(rb[0], ra[0])
        assert rb[0].dtype == ra[0].dtype and rb[1] == ra[1]
        assert len(a) == len(b)


@pytest.mark.parametrize("method", ["prepare", "prepare_dev"])
def test_prepare_matches_reference(method):
    """Uniques in first-occurrence order, new keys at next_row + i, and
    (prepare_dev) the slot of each insert, across a growth."""
    rng = np.random.default_rng(1)
    a, b = ref.NativeIndex(), native.NativeIndex()
    for step in range(6):
        keys = batch_keys(rng, 4000)
        create = step != 3
        ra = getattr(a, method)(keys, create, True, 1 + len(a))
        rb = getattr(b, method)(keys, create, True, 1 + len(b))
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            np.testing.assert_array_equal(y, x)
            assert np.asarray(y).dtype == np.asarray(x).dtype
    assert b.generation > 0 and b.generation == a.generation


def test_missing_and_export_match_reference():
    rng = np.random.default_rng(2)
    a, b = ref.NativeIndex(), native.NativeIndex()
    keys = batch_keys(rng, 5000)
    a.prepare(keys, True, True, 1)
    b.prepare(keys, True, True, 1)
    probe = np.concatenate([batch_keys(rng, 2000), keys[:500]])
    np.testing.assert_array_equal(b.missing(probe), a.missing(probe))
    np.testing.assert_array_equal(b.export_slots(), a.export_slots())
    assert b.export_slots().shape == (b.capacity + b.guard, 4)
    assert (b.guard, b.max_run) == (a.guard, a.max_run) == (64, 64)


def test_dump_and_rebuild_round_trip():
    rng = np.random.default_rng(3)
    a, b = ref.NativeIndex(), native.NativeIndex()
    keys = np.unique(batch_keys(rng, 3000))
    keys = rng.permutation(keys[keys != 0])
    a.rebuild(keys)
    b.rebuild(keys)
    np.testing.assert_array_equal(b.dump_keys(keys.size), keys)
    np.testing.assert_array_equal(b.dump_keys(keys.size + 5),
                                  a.dump_keys(keys.size + 5))
    np.testing.assert_array_equal(b.export_slots(), a.export_slots())
    rows, n_new = b.lookup(keys, False, True, 0)
    np.testing.assert_array_equal(rows, np.arange(keys.size))
    assert n_new == 0 and keys[5] in b and 0 not in b


def test_capacity_and_generation_across_growth():
    a, b = ref.NativeIndex(), native.NativeIndex()
    cap0, gen0 = b.capacity, b.generation
    assert (cap0, gen0) == (a.capacity, a.generation)
    for step in range(5):
        keys = np.arange(1 + 1000 * step, 1 + 1000 * (step + 1),
                         dtype=np.uint64)
        a.prepare(keys, True, True, 1 + len(a))
        b.prepare(keys, True, True, 1 + len(b))
        assert (b.capacity, b.generation) == (a.capacity, a.generation)
    assert b.capacity > cap0 and b.generation > gen0
    b.rebuild(np.arange(1, 10, dtype=np.uint64))
    a.rebuild(np.arange(1, 10, dtype=np.uint64))
    assert (b.capacity, b.generation) == (a.capacity, a.generation)


@pytest.mark.parametrize("threads", [2, 4])
def test_mt_index_contract(threads):
    """Rows stable across batches, distinct, counted from 1; the same keys
    as a NativeIndex; dump/rebuild round trips."""
    rng = np.random.default_rng(4)
    mt = native.MtIndex(threads)
    single = native.NativeIndex()
    seen = {}
    for _ in range(4):
        keys = batch_keys(rng, 3000, hi=1 << 13)
        rows, inverse, urows, n_new = mt.prepare(keys, True, True)
        np.testing.assert_array_equal(rows, urows[inverse])
        assert (rows[keys == 0] == 0).all() and (rows[keys != 0] > 0).all()
        for k, r in zip(keys.tolist(), rows.tolist()):
            assert seen.setdefault(k, r) == r
        single.prepare(keys, True, True, 1 + len(single))
        assert len(mt) == len(single)
        assert mt.next_row == len(mt) + 1
    live = {k: r for k, r in seen.items() if k}
    assert sorted(live.values()) == list(range(1, len(live) + 1))
    dump = mt.dump_keys(mt.next_row)
    for k, r in live.items():
        assert dump[r] == k
    again = native.MtIndex(threads)
    again.rebuild(dump)
    rows, _ = again.lookup(dump[1:], False, True)
    np.testing.assert_array_equal(rows, np.arange(1, dump.size))
    assert again.next_row == dump.size


def tables(capacity=64, **kw):
    """The reference's and the port's native tables (one map), same
    config."""
    jt = JaxDeviceTable(JaxTableConfig(**kw), capacity=capacity,
                        uniq_buckets=JaxBucketSpec(min_size=8),
                        backend="native", index_threads=1)
    pt = DeviceTable(TableConfig(**kw), capacity=capacity,
                     uniq_buckets=BucketSpec(min_size=8), device="cpu",
                     backend="native", index_threads=1)
    return jt, pt


@pytest.mark.parametrize("prepopulate", [0, 300])
def test_device_table_native_matches_reference(prepopulate):
    """prepare_batch's arrays bit for bit, with growth of the arena and of
    the map, lookups without create, and the rows' keys."""
    rng = np.random.default_rng(5)
    jt, pt = tables(capacity=512, embedx_dim=4)
    if prepopulate:
        jt.prepopulate(prepopulate)
        pt.prepopulate(prepopulate)
    for step in range(6):
        keys = batch_keys(rng, 600, hi=2000 if step % 2 else 1 << 64)
        create = step != 4
        a, b = jt.prepare_batch(keys, create), pt.prepare_batch(keys, create)
        for f in ("rows", "inverse", "uniq_rows", "uniq_mask"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
            assert getattr(b, f).dtype == getattr(a, f).dtype
        assert a.num_uniq == b.num_uniq
        assert (len(jt), jt.capacity) == (len(pt), pt.capacity)
    want = jt._index.dump_keys(jt._size)
    want[0] = 0
    np.testing.assert_array_equal(pt.row_keys(), want)


def test_native_snapshot_load_round_trip(tmp_path):
    rng = np.random.default_rng(6)
    jt, pt = tables(embedx_dim=4)
    keys = batch_keys(rng, 200)
    jt.prepare_batch(keys)
    pt.load_arena(np.asarray(jt.values), np.asarray(jt.state),
                  jt._index.dump_keys(jt._size))
    jt.save(str(tmp_path / "jax.npz"))
    back = DeviceTable(TableConfig(embedx_dim=4), capacity=8, device="cpu",
                       backend="native", index_threads=1)
    back.load(str(tmp_path / "jax.npz"))
    for got, want in zip(back.snapshot().values(), jt.snapshot().values()):
        np.testing.assert_array_equal(got, want)
    idx = back.prepare_batch(keys, create=False)
    np.testing.assert_array_equal(idx.rows,
                                  jt.prepare_batch(keys, False).rows)


def test_backend_resolution(monkeypatch):
    conf = TableConfig(embedx_dim=4)
    assert DeviceTable(conf, capacity=8, device="cpu").backend == "native"
    t = DeviceTable(conf, capacity=8, device="cpu", index_threads=3)
    assert isinstance(t._index, native.MtIndex) and t._index.threads == 3
    with pytest.raises(RuntimeError, match="index_threads<=1"):
        t.enable_device_index()
    with pytest.raises(RuntimeError, match="enable_device_index"):
        t.ensure_keys(np.arange(4, dtype=np.uint64))
    t = DeviceTable(conf, capacity=8, device="cpu", backend="numpy")
    assert isinstance(t._index, SortedIndex)
    with pytest.raises(RuntimeError, match="backend='native'"):
        t.enable_device_index()
    with pytest.raises(ValueError, match="unknown index backend"):
        DeviceTable(conf, capacity=8, device="cpu", backend="rocksdb")
    monkeypatch.setattr(port_table.native, "available", lambda: False)
    assert DeviceTable(conf, capacity=8, device="cpu").backend == "numpy"
    with pytest.raises(RuntimeError, match="unavailable"):
        DeviceTable(conf, capacity=8, device="cpu", backend="native")


def test_sorted_index_contract():
    """The numpy backend: new non-zero keys in ascending key order, sorted
    unique keys only, duplicates keep their first row on rebuild."""
    idx = SortedIndex()
    rows, n_new = idx.lookup(np.array([0, 4, 9, HIGH], np.uint64), True,
                             True, 1)
    np.testing.assert_array_equal(rows, [-1, 1, 2, 3])
    assert n_new == 3 and len(idx) == 3
    rows, n_new = idx.lookup(np.array([2, 4, 7], np.uint64), True, True, 4)
    np.testing.assert_array_equal(rows, [4, 1, 5])
    np.testing.assert_array_equal(idx.dump_keys(6), [0, 4, 9, HIGH, 2, 7])
    with pytest.raises(ValueError, match="strictly increasing"):
        idx.lookup(np.array([9, 4], np.uint64), False, True, 0)
    idx.rebuild(np.array([5, 6, 5], np.uint64))
    np.testing.assert_array_equal(idx.lookup(np.array([5, 6], np.uint64),
                                             False, True, 0)[0], [0, 1])
