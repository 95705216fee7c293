"""Port's DeviceTable (on the CPU) vs the JAX package's
``DeviceTable(conf, backend="numpy")``: index arrays bit for bit, pull
exactly, push within float32 rounding, snapshots across the packages.

The port's arena init cannot reproduce ``jax.random`` bits, so the tests
carry the reference's arena across with ``load_arena`` before comparing
rows. Push tolerance rtol=1e-6, atol=1e-7 (the same float32 formulas; a
pow, a sqrt or a mean may round differently in the last bit); show/clk
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.config import BucketSpec as JaxBucketSpec
from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.ps.device_table import DeviceTable as JaxDeviceTable
from paddlebox_tpu_torch.config import BucketSpec, TableConfig
from paddlebox_tpu_torch.ps.device_table import DeviceTable

TOL = dict(rtol=1e-6, atol=1e-7)
HIGH = np.uint64(1) << np.uint64(63)


def pair(capacity=64, upad_min=8, **kw):
    """The reference's numpy-backend table and the port's, same config."""
    jt = JaxDeviceTable(JaxTableConfig(**kw), capacity=capacity,
                        uniq_buckets=JaxBucketSpec(min_size=upad_min),
                        backend="numpy")
    pt = DeviceTable(TableConfig(**kw), capacity=capacity,
                     uniq_buckets=BucketSpec(min_size=upad_min),
                     device="cpu", backend="numpy")
    return jt, pt


def carry(jt, pt):
    pt.load_arena(np.asarray(jt.values), np.asarray(jt.state),
                  jt._index.dump_keys(jt._size))


def assert_same_index(a, b):
    for f in ("rows", "inverse", "uniq_rows", "uniq_mask"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.num_uniq == b.num_uniq


def test_prepare_batch_bit_identical_to_numpy_backend():
    """Key 0, duplicates, keys above 2^63, growth past the capacity, and
    lookups without create of keys the table never saw."""
    rng = np.random.default_rng(0)
    jt, pt = pair(capacity=8, embedx_dim=4)
    for step in range(6):
        keys = rng.integers(1, 60, size=40).astype(np.uint64)
        keys[::7] = 0
        keys[3] = keys[5]
        keys[10:13] = HIGH + rng.integers(0, 5, size=3).astype(np.uint64)
        create = step != 4
        assert_same_index(jt.prepare_batch(keys, create),
                          pt.prepare_batch(keys, create))
        assert len(jt) == len(pt)
        assert jt.capacity == pt.capacity
    assert pt.capacity > 8
    np.testing.assert_array_equal(jt._index.dump_keys(jt._size),
                                  pt.row_keys())


def test_rows_follow_ascending_unsigned_key_order():
    """Hazard (c): new keys take rows in ascending uint64 order, not in
    their signed-int64 order, or pre-randomized rows would differ."""
    _, pt = pair(embedx_dim=4)
    keys = np.array([HIGH + np.uint64(1), 7, 0, 3, HIGH], dtype=np.uint64)
    idx = pt.prepare_batch(keys)
    np.testing.assert_array_equal(idx.rows, [4, 2, 0, 1, 3])


def set_shows(jt, pt, shows):
    vals = np.asarray(jt.values).copy()
    vals[1:1 + shows.size, 0] = shows
    vals[1:1 + shows.size, 1] = np.floor(shows * 0.3)
    jt.values = jnp.asarray(vals)
    carry(jt, pt)


def test_device_pull_matches_jax_with_embedx_gate():
    rng = np.random.default_rng(1)
    jt, pt = pair(embedx_dim=4, embedx_threshold=10.0, initial_range=0.1)
    keys = rng.integers(1, 30, size=48).astype(np.uint64)
    keys[::5] = 0
    jidx = jt.prepare_batch(keys)
    set_shows(jt, pt, rng.integers(0, 20, size=len(jt)).astype(np.float32))
    idx = pt.prepare_batch(keys, create=False)
    got = pt.device_pull(pt.values, torch.from_numpy(idx.rows)).numpy()
    want = np.asarray(jt.device_pull(jt.values, jidx.rows))
    np.testing.assert_array_equal(got, want)
    gated = got[:, 0] < 10.0
    assert gated.any() and (~gated).any()
    assert not got[gated, 3:].any()


def push_both(jt, pt, keys, grads):
    jidx = jt.prepare_batch(keys)
    idx = pt.prepare_batch(keys)
    assert_same_index(jidx, idx)
    jv, js = jt.device_push(jt.values, jt.state, jnp.asarray(grads),
                            jnp.asarray(jidx.inverse),
                            jnp.asarray(jidx.uniq_rows),
                            jnp.asarray(jidx.uniq_mask))
    pv, ps = pt.device_push(pt.values, pt.state, torch.from_numpy(grads),
                            torch.from_numpy(idx.inverse),
                            torch.from_numpy(idx.uniq_rows),
                            torch.from_numpy(idx.uniq_mask))
    return (np.asarray(jv), np.asarray(js)), (pv.numpy(), ps.numpy())


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
def test_device_push_matches_jax(optimizer):
    """Duplicates, key 0 and rows whose show crosses the embedx threshold
    inside the batch."""
    rng = np.random.default_rng(2)
    kw = dict(embedx_dim=4, embedx_threshold=10.0, optimizer=optimizer,
              learning_rate=0.05, initial_range=0.1)
    jt, pt = pair(capacity=128, **kw)
    warm = np.arange(1, 41, dtype=np.uint64)
    jt.prepare_batch(warm)
    st = rng.uniform(0.0, 1.0, size=np.asarray(jt.state).shape)
    jt.state = jnp.asarray(st.astype(np.float32))
    set_shows(jt, pt, rng.integers(5, 15, size=40).astype(np.float32))
    keys = rng.integers(1, 50, size=96).astype(np.uint64)
    keys[::9] = 0
    grads = (rng.normal(size=(96, 7)) * 0.1).astype(np.float32)
    grads[:, 0] = 1.0
    grads[:, 1] = rng.integers(0, 2, size=96)
    old_show = np.asarray(jt.values)[:, 0].copy()
    (jv, js), (pv, ps) = push_both(jt, pt, keys, grads)
    np.testing.assert_array_equal(pv[:, :2], jv[:, :2])
    np.testing.assert_allclose(pv, jv, **TOL)
    np.testing.assert_allclose(ps, js, **TOL)
    crossed = (old_show < 10.0) & (jv[:, 0] >= 10.0)
    assert crossed.any()


def test_embedx_gate_uses_the_show_after_this_batch():
    """Hazard (f): a row at show 9 that gets 1 more show in this batch
    trains its embedx now (``device_table.py:220``)."""
    jt, pt = pair(embedx_dim=4, embedx_threshold=10.0, initial_range=0.1)
    keys = np.array([5], dtype=np.uint64)
    jt.prepare_batch(keys)
    set_shows(jt, pt, np.array([9.0], np.float32))
    grads = np.full((1, 7), 0.5, np.float32)
    grads[0, :2] = [1.0, 0.0]
    before = pt.values[1].clone()
    (jv, _), (pv, _) = push_both(jt, pt, keys, grads)
    assert pv[1, 0] == 10.0
    assert (pv[1, 3:] != before[3:].numpy()).all()
    np.testing.assert_allclose(pv, jv, **TOL)


def test_null_row_never_trains():
    """Mirror of tests/test_device_table.py::test_null_row_never_trains."""
    pt = DeviceTable(TableConfig(embedx_dim=4, embedx_threshold=0.0),
                     capacity=32, device="cpu")
    keys = np.zeros(16, dtype=np.uint64)
    idx = pt.prepare_batch(keys)
    grads = torch.ones((16, pt.dim))
    vals, state = pt.device_push(pt.values, pt.state, grads,
                                 torch.from_numpy(idx.inverse),
                                 torch.from_numpy(idx.uniq_rows),
                                 torch.from_numpy(idx.uniq_mask))
    assert (vals[0] == 0).all() and (state[0] == 0).all()


def test_snapshots_cross_between_packages(tmp_path):
    rng = np.random.default_rng(3)
    jt, pt = pair(embedx_dim=4)
    keys = np.concatenate([rng.integers(1, 100, size=30).astype(np.uint64),
                           [HIGH + np.uint64(9)]])
    jt.prepare_batch(keys)
    jt.state = jnp.asarray(rng.uniform(size=np.asarray(jt.state).shape)
                           .astype(np.float32))
    jt.save(str(tmp_path / "jax.npz"))
    port = DeviceTable(TableConfig(embedx_dim=4), capacity=16, device="cpu")
    port.load(str(tmp_path / "jax.npz"))

    def by_key(snap):
        order = np.argsort(snap["keys"])
        return (snap["keys"][order], snap["values"][order],
                snap["state"][order])

    want = by_key(jt.snapshot())
    for a, b in zip(by_key(port.snapshot()), want):
        np.testing.assert_array_equal(a, b)
    port.save(str(tmp_path / "port.npz"))
    back = JaxDeviceTable(JaxTableConfig(embedx_dim=4), capacity=16,
                          backend="numpy")
    back.load(str(tmp_path / "port.npz"))
    for a, b in zip(by_key(back.snapshot()), want):
        np.testing.assert_array_equal(a, b)
    idx = port.prepare_batch(keys, create=False)
    assert (idx.rows > 0).all()


def test_growth_keeps_rows_and_randomizes_new_ones():
    """Hazard (e): ``_grow_to`` draws new rows from the port's generator,
    so parity runs carry an arena that never grows."""
    conf = TableConfig(embedx_dim=4, initial_range=0.01, seed=5)
    pt = DeviceTable(conf, capacity=4, device="cpu")
    pt.prepare_batch(np.array([1, 2], np.uint64))
    head = pt.values[:3].clone()
    pt.prepare_batch(np.arange(3, 20, dtype=np.uint64))
    assert pt.capacity == 32 and len(pt) == 19
    assert torch.equal(pt.values[:3], head)
    tail = pt.values[4:]
    assert (tail[:, :2] == 0).all()
    assert (tail[:, 2:].abs() <= 0.01).all() and tail[:, 2:].abs().sum() > 0
    assert (pt.values[0] == 0).all()


def test_end_pass_decay_matches_jax():
    jt, pt = pair(embedx_dim=4, show_clk_decay=0.9)
    jt.prepare_batch(np.arange(1, 9, dtype=np.uint64))
    set_shows(jt, pt, np.arange(1, 9, dtype=np.float32) * 3)
    jt.end_pass()
    pt.end_pass()
    np.testing.assert_array_equal(pt.values.numpy(), np.asarray(jt.values))


def test_memory_bytes_and_len():
    jt, pt = pair(capacity=64, embedx_dim=8, optimizer="adam")
    assert pt.memory_bytes() == jt.memory_bytes()
    assert len(pt) == 0


def test_unported_modes_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DeviceTable(TableConfig(), device="cpu", value_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DeviceTable(TableConfig(embedx_dim=4, expand_dim=4,
                                variable_embedding=True), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DeviceTable(TableConfig())
