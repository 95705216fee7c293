"""The push's host side on the CPU: the merge order's plain version against
numpy, the kernel's lane geometry, and the CPU ``sparse_push`` against the
JAX package's ``ArenaLayout.push`` at the flagship's width (D=11).

The push kernel itself runs only on the card (``chip_smoke.py`` holds it
against ``sparse_push_plain``). Push tolerance rtol=1e-6, atol=1e-7 (the
same float32 formulas; a pow, a sqrt or a mean may round differently in
the last bit); show/clk exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.config import BucketSpec as JaxBucketSpec
from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.ps.device_table import DeviceTable as JaxDeviceTable
from paddlebox_tpu_torch.config import BucketSpec, TableConfig
from paddlebox_tpu_torch.ops.sparse_push import (MAX_DIM, merge_order,
                                                 merge_order_plain,
                                                 push_geometry,
                                                 sparse_push_cuda)
from paddlebox_tpu_torch.ps.device_table import DeviceTable

TOL = dict(rtol=1e-6, atol=1e-7)


def numpy_merge_order(inverse: np.ndarray, upad: int):
    order = np.argsort(inverse, kind="stable")
    offsets = np.concatenate(
        [[0], np.cumsum(np.bincount(inverse, minlength=upad))])
    return order, offsets


def merge_cases():
    rng = np.random.default_rng(0)
    # uniques 0..49 hold keys, 50..63 are padding; some interior uniques
    # hold none either
    gaps = rng.integers(0, 50, size=700)
    gaps = gaps[(gaps % 7) != 3]
    return {
        "padding-uniques": (rng.integers(0, 50, size=300), 64),
        "interior-gaps": (gaps, 64),
        "one-unique-all-keys": (np.full(257, 7), 16),
        "upad-above-max": (rng.integers(0, 10, size=40), 100),
        "no-keys": (np.zeros(0, np.int64), 8),
        "last-unique": (np.full(5, 31), 32),
    }


@pytest.mark.parametrize("case", sorted(merge_cases()))
def test_merge_order_plain_matches_numpy(case):
    inv, upad = merge_cases()[case]
    t = torch.from_numpy(inv.astype(np.int32))
    order, offsets = merge_order_plain(t, upad)
    assert order.dtype == torch.int64 and offsets.dtype == torch.int32
    want_order, want_offsets = numpy_merge_order(inv, upad)
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(offsets.numpy(), want_offsets)
    # each unique's keys, ascending, and nothing else
    for u in range(upad):
        keys = order[offsets[u]:offsets[u + 1]].numpy()
        assert (inv[keys] == u).all() and (np.diff(keys) > 0).all()
    # the CPU route of merge_order is the plain version
    got = merge_order(t, upad)
    assert torch.equal(got[0], order) and torch.equal(got[1], offsets)


def test_merge_order_plain_refuses_a_unique_past_upad():
    with pytest.raises(ValueError, match="upad"):
        merge_order_plain(torch.tensor([0, 3, 9], dtype=torch.int32), 8)


def test_push_geometry_covers_every_width():
    """Every width the kernel takes: G a power of two <= 32 and the least
    with 4 G >= D below the cap, G C >= D, C <= 8, and the interleaved map
    (lane l holds columns l, l + G, ...) gives each column one lane."""
    for dim in range(2, MAX_DIM + 1):
        lanes, cols = push_geometry(dim)
        assert lanes in (1, 2, 4, 8, 16, 32), dim
        assert lanes * cols >= dim and 2 <= cols <= 8, dim
        assert lanes == 32 or (4 * lanes >= dim and
                               (lanes == 1 or 2 * lanes < dim)), dim
        held = sorted(l + c * lanes for l in range(lanes)
                      for c in range(cols) if l + c * lanes < dim)
        assert held == list(range(dim)), dim


@pytest.mark.parametrize("dim,lanes,cols", [
    (4, 1, 4), (5, 2, 3), (11, 4, 3), (16, 4, 4), (33, 16, 3), (67, 32, 3),
    (129, 32, 5), (256, 32, 8)])
def test_push_geometry_values(dim, lanes, cols):
    assert push_geometry(dim) == (lanes, cols)


@pytest.mark.parametrize("dim", [1, MAX_DIM + 1])
def test_push_geometry_refuses_other_widths(dim):
    with pytest.raises(ValueError, match="columns"):
        push_geometry(dim)


def test_cuda_push_refuses_cpu_tensors():
    """No fallback: the kernel's wrapper never runs the plain version."""
    t = DeviceTable(TableConfig(embedx_dim=8), capacity=8, device="cpu")
    idx = t.prepare_batch(np.arange(1, 5, dtype=np.uint64))
    with pytest.raises(ValueError, match="CUDA"):
        sparse_push_cuda(t.layout, t.values, t.state,
                         torch.zeros((4, t.dim)),
                         torch.from_numpy(idx.inverse),
                         torch.from_numpy(idx.uniq_rows),
                         torch.from_numpy(idx.uniq_mask))
    assert sparse_push_cuda.launches == 0


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
def test_push_matches_jax_at_flagship_width(optimizer):
    """D=11 (cvm_offset 3, embedx 8): a key repeated over 500 times, unknown
    keys (row 0, not live), padding keys with garbage grads, and rows whose
    show crosses the embedx threshold inside the batch."""
    rng = np.random.default_rng(11)
    kw = dict(embedx_dim=8, cvm_offset=3, embedx_threshold=10.0,
              optimizer=optimizer, learning_rate=0.05, initial_range=0.1)
    jt = JaxDeviceTable(JaxTableConfig(**kw), capacity=256,
                        uniq_buckets=JaxBucketSpec(min_size=64),
                        backend="numpy")
    pt = DeviceTable(TableConfig(**kw), capacity=256,
                     uniq_buckets=BucketSpec(min_size=64), device="cpu",
                     backend="numpy")
    jt.prepare_batch(np.arange(1, 201, dtype=np.uint64))
    vals = np.asarray(jt.values).copy()
    shows = rng.integers(5, 15, size=200).astype(np.float32)
    vals[1:201, 0] = shows
    vals[1:201, 1] = np.floor(shows * 0.3)
    jt.values = jnp.asarray(vals)
    jt.state = jnp.asarray(rng.uniform(0.0, 1.0, size=np.asarray(
        jt.state).shape).astype(np.float32))
    pt.load_arena(np.asarray(jt.values), np.asarray(jt.state),
                  jt._index.dump_keys(jt._size))

    npad, hot = 1536, 77
    keys = np.zeros(npad, np.uint64)
    keys[:900] = rng.integers(1, 201, size=900)
    keys[900:1400] = hot
    keys[1400:1450] = 10_000 + rng.integers(0, 20, size=50)
    keys[:1450] = rng.permutation(keys[:1450])
    grads = (rng.normal(size=(npad, 11)) * 0.1).astype(np.float32)
    grads[:, 0] = 1.0
    grads[:, 1] = rng.integers(0, 2, size=npad)

    jidx = jt.prepare_batch(keys, create=False)
    idx = pt.prepare_batch(keys, create=False)
    for f in ("inverse", "uniq_rows", "uniq_mask"):
        np.testing.assert_array_equal(getattr(jidx, f), getattr(idx, f))
    assert (idx.uniq_mask[:idx.num_uniq] == 0).sum() > 1  # key 0, unknowns
    old = np.asarray(jt.values).copy()
    jv, js = jt.device_push(jt.values, jt.state, jnp.asarray(grads),
                            jnp.asarray(jidx.inverse),
                            jnp.asarray(jidx.uniq_rows),
                            jnp.asarray(jidx.uniq_mask))
    pv, ps = pt.device_push(pt.values, pt.state, torch.from_numpy(grads),
                            torch.from_numpy(idx.inverse),
                            torch.from_numpy(idx.uniq_rows),
                            torch.from_numpy(idx.uniq_mask))
    jv, js, pv, ps = (np.asarray(jv), np.asarray(js), pv.numpy(), ps.numpy())
    np.testing.assert_array_equal(pv[:, :2], jv[:, :2])
    np.testing.assert_allclose(pv, jv, **TOL)
    np.testing.assert_allclose(ps, js, **TOL)
    hot_row = int(idx.rows[np.flatnonzero(keys == hot)[0]])
    copies = int((keys == hot).sum())
    assert copies >= 500 and pv[hot_row, 0] == old[hot_row, 0] + copies
    crossed = (old[:, 0] < 10.0) & (jv[:, 0] >= 10.0)
    assert crossed.any()
    np.testing.assert_array_equal(pv[0], old[0])


def test_push_marks_dirty_rows_as_the_reference_step():
    """With a bitmap, the CPU push (``mark_dirty_plain`` beside the plain
    push) marks every unique's row, padding's row 0 included, as the
    reference's ``dirty.at[uniq_rows].set(True)``; the rows it writes are
    those of the push without one. A wrong bitmap is refused by the
    kernel's wrapper before anything launches."""
    rng = np.random.default_rng(4)
    t = DeviceTable(TableConfig(embedx_dim=8, embedx_threshold=0.0),
                    capacity=64, uniq_buckets=BucketSpec(min_size=32),
                    device="cpu", backend="numpy")
    keys = np.zeros(96, np.uint64)
    keys[:70] = rng.integers(1, 40, size=70)
    idx = t.prepare_batch(keys)
    grads = torch.from_numpy(
        (rng.normal(size=(96, t.dim)) * 0.1).astype(np.float32))
    args = [torch.from_numpy(x) for x in (idx.inverse, idx.uniq_rows,
                                          idx.uniq_mask)]
    plain = (t.values.clone(), t.state.clone())
    t.device_push(*plain, grads, *args)
    dirty = torch.zeros(64, dtype=torch.bool)
    t.device_push(t.values, t.state, grads, *args, dirty=dirty)
    assert torch.equal(t.values, plain[0]) and torch.equal(t.state, plain[1])
    want = jnp.zeros(64, jnp.bool_).at[jnp.asarray(idx.uniq_rows)].set(True)
    np.testing.assert_array_equal(dirty.numpy(), np.asarray(want))
    assert bool(dirty[0]) and int(dirty.sum()) == idx.num_uniq  # key 0 too
    with pytest.raises(ValueError, match="CUDA"):
        sparse_push_cuda(t.layout, t.values, t.state, grads, *args,
                         dirty=dirty)
