"""The port's ``ShardedDeviceTable`` (``paddlebox_tpu_torch/ps/
sharded_device_table.py``, its shards on ``make_mesh(ndev, device="cpu")``)
against the reference's on the JAX package's CPU mesh, at ndev 2 and 8:
the routing plans of both backends, each against the reference's of the
same backend, exactly; growth; the snapshots, written byte for byte as the
reference's where the rows are equal, read across packages both ways and
into a ``DeviceTable``; dirty tracking through ``save_delta``; the
variable layout on the mesh engine. Trained rows: show/clk exact, the rest
within 1e-5 (float32 sums in another order over a few steps)."""

import numpy as np
import pytest
import torch

from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.parallel import make_mesh as jax_make_mesh
from paddlebox_tpu.ps import native as ref_native
from paddlebox_tpu.ps.device_table import DeviceTable as JaxDeviceTable
from paddlebox_tpu.ps.sharded_device_table import \
    ShardedDeviceTable as JaxShardedTable
from paddlebox_tpu_torch.config import TableConfig
from paddlebox_tpu_torch.parallel.mesh import make_mesh
from paddlebox_tpu_torch.ps import native
from paddlebox_tpu_torch.ps.device_table import DeviceTable
from paddlebox_tpu_torch.ps.sharded_device_table import (MeshBatchIndex,
                                                         ShardedDeviceTable,
                                                         shard_of)
from torch_mesh_worlds import (TABLE, assert_tables_match, make_batch,
                               rows_by_key, step_both, worlds)

PLAN_FIELDS = ("req_rows", "inverse", "serve_uniq", "serve_mask",
               "serve_inverse", "num_uniq")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def need_native():
    if not (native.available() and ref_native.available()):
        pytest.skip("the native index core does not build here")


def tables(ndev, backend, cap=64, **kw):
    conf = dict(TABLE, initial_range=0.1, **kw)
    return (JaxShardedTable(JaxTableConfig(**conf), jax_make_mesh(ndev),
                            capacity_per_shard=cap, backend=backend),
            ShardedDeviceTable(TableConfig(**conf),
                               make_mesh(ndev, device="cpu"),
                               capacity_per_shard=cap, backend=backend))


@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("ndev", [2, 8])
def test_routing_plans_equal_reference(ndev, backend):
    """Both backends' plans equal the reference's of the same backend
    field for field, over batches that insert, find and miss keys (one
    with every bit), padding and a duplicate-heavy row; the shards fill
    and grow alike."""
    if backend == "native":
        need_native()
    jt, pt = tables(ndev, backend)
    rng = np.random.default_rng(ndev)
    for step in range(3):
        keys = rng.integers(1, 3000, size=(ndev, 256)).astype(np.uint64)
        keys[:, 3] = np.uint64(2 ** 64 - 5)
        keys[0, 10:60] = keys[0, 9]
        keys[:, 200 + step:] = 0
        for create in (True, False):
            want = jt.prepare_batch(keys, create=create)
            got = pt.prepare_batch(keys, create=create)
            assert isinstance(got, MeshBatchIndex)
            assert (got.R, got.Upad) == (want.R, want.Upad)
            for f in PLAN_FIELDS:
                a, b = getattr(got, f), getattr(want, f)
                assert a.dtype == b.dtype, f
                np.testing.assert_array_equal(a, b, err_msg=f)
        absent = keys + np.uint64(10_000)
        for f in PLAN_FIELDS:
            np.testing.assert_array_equal(
                getattr(pt.prepare_batch(absent, create=False), f),
                getattr(jt.prepare_batch(absent, create=False), f))
    assert pt._sizes == list(jt._sizes)
    assert pt.capacity == jt.capacity > 64
    assert len(pt) == len(jt)
    for s in range(ndev):
        np.testing.assert_array_equal(pt._indexes[s].dump_keys(pt._sizes[s]),
                                      jt._indexes[s].dump_keys(jt._sizes[s]))
    np.testing.assert_array_equal(pt._dirty, jt._dirty)


@pytest.mark.parametrize("ndev", [2, 8])
def test_growth_keeps_rows(ndev):
    """Growth reallocates every shard at the doubled capacity and keeps
    each shard's rows."""
    conf = TableConfig(**dict(TABLE, initial_range=0.1))
    t = ShardedDeviceTable(conf, make_mesh(ndev, device="cpu"),
                           capacity_per_shard=16, backend="numpy")
    first = np.arange(1, 1 + ndev * 4, dtype=np.uint64).reshape(ndev, 4)
    t.prepare_batch(first)
    before = [v[:t._sizes[s]].clone() for s, v in enumerate(t.values)]
    keys = np.arange(1, 1 + ndev * 64, dtype=np.uint64).reshape(ndev, 64)
    t.prepare_batch(keys)
    assert len(t) == ndev * 64 and t.capacity > 16
    for s in range(ndev):
        assert t.values[s].shape == (t.capacity, t.dim)
        assert t.state[s].shape[0] == t.capacity
        torch.testing.assert_close(t.values[s][:before[s].shape[0]],
                                   before[s], rtol=0, atol=0)
    assert t._dirty.shape == (ndev, t.capacity)


@pytest.mark.parametrize("ndev", [2, 8])
def test_snapshots_cross_packages(ndev, tmp_path):
    """Untrained, the port's save and save_delta files equal the
    reference's byte for byte; after 4 host-plan steps of the same
    engines and a pass end's decay (0.5), the port's sharded table and
    DeviceTable load the reference's save, and (at ndev 2) the reference's
    load the port's, the rows by key agreeing within 1e-5; the stats and
    device bytes are the reference's."""
    need_native()
    B, S = 8, 4
    ref, port = worlds(ndev, False, B, S, cap=512,
                       table_kw=dict(show_clk_decay=0.5))
    jt, pt = ref[1], port[1]
    rng = np.random.default_rng(ndev)
    batches = [make_batch(rng, ndev, B, S, 128, 700) for _ in range(4)]
    jt.prepare_batch(batches[0][0])
    pt.prepare_batch(batches[0][0])
    for name, save in (("base", "save"), ("delta", "save_delta")):
        pa, pb = str(tmp_path / f"j_{name}.npz"), str(tmp_path / f"p_{name}")
        getattr(jt, save)(pa)
        getattr(pt, save)(pb + ".npz")
        with open(pa, "rb") as a, open(pb + ".npz", "rb") as b:
            assert a.read() == b.read(), name
    for args in batches:
        jl, pl = step_both(ref, port, args, False)
        np.testing.assert_allclose(pl, jl, rtol=1e-5)
    # the pass end's decay of show/clk, on every shard
    for t in (jt, pt):
        t.end_pass()
    assert pt.stats() == dict(jt.stats())
    assert pt.memory_bytes() == int(jt.memory_bytes())
    jpath, ppath = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jt.save(jpath)
    pt.save(ppath)
    jk, jv, js = rows_by_key(dict(np.load(jpath)))
    # each package's tables read the other's file (the reference's reads,
    # seconds of its compiles a table, at ndev 2)
    readers = [(jpath, ShardedDeviceTable(TableConfig(**TABLE),
                                          make_mesh(ndev, device="cpu"),
                                          capacity_per_shard=64,
                                          backend="native")),
               (jpath, DeviceTable(TableConfig(**TABLE), capacity=64,
                                   device="cpu", backend="native",
                                   index_threads=1))]
    if ndev == 2:
        readers += [(ppath, JaxShardedTable(JaxTableConfig(**TABLE),
                                            jax_make_mesh(ndev),
                                            capacity_per_shard=64,
                                            backend="native")),
                    (ppath, JaxDeviceTable(JaxTableConfig(**TABLE),
                                           capacity=64, backend="native"))]
    for path, table in readers:
        table.load(path)
        assert len(table) == jk.size
        k, v, st = rows_by_key(table.snapshot())
        np.testing.assert_array_equal(k, jk)
        np.testing.assert_array_equal(v[:, :2], jv[:, :2])
        np.testing.assert_allclose(v, jv, rtol=0, atol=1e-5)
        np.testing.assert_allclose(st, js, rtol=0, atol=1e-5)
    # a loaded sharded table numbers its rows as the reference's does
    a = ShardedDeviceTable(TableConfig(**TABLE), make_mesh(ndev, device="cpu"),
                           capacity_per_shard=64, backend="numpy")
    b = JaxShardedTable(JaxTableConfig(**TABLE), jax_make_mesh(ndev),
                        capacity_per_shard=64, backend="numpy")
    a.load(jpath)
    b.load(jpath)
    assert a._sizes == list(b._sizes)
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(
            getattr(a.prepare_batch(batches[-1][0], create=False), f),
            getattr(b.prepare_batch(batches[-1][0], create=False), f))


@pytest.mark.parametrize("ndev", [2, 8])
def test_save_delta_tracks_dirty_and_loads(ndev, tmp_path):
    """save_delta writes the rows planned since the last save, then none;
    a delta loads into a DeviceTable of either package and into a sharded
    table over a base (load_delta), as the reference's does."""
    jt, pt = tables(ndev, "numpy", cap=512)
    keys = np.arange(1, 1 + ndev * 8, dtype=np.uint64).reshape(ndev, 8)
    for t in (jt, pt):
        t.prepare_batch(keys)
    for tag, t in (("j", jt), ("d", pt)):
        assert t.save_delta(str(tmp_path / f"{tag}1.npz")) == ndev * 8
        assert t.save_delta(str(tmp_path / f"{tag}2.npz")) == 0
    for t in (jt, pt):
        t.prepare_batch(keys[:, :2])
    assert pt.save_delta(str(tmp_path / "d3.npz")) == ndev * 2
    assert jt.save_delta(str(tmp_path / "j3.npz")) == ndev * 2
    pk, pv, _ = rows_by_key(dict(np.load(str(tmp_path / "d3.npz"))))
    jk, _, _ = rows_by_key(dict(np.load(str(tmp_path / "j3.npz"))))
    np.testing.assert_array_equal(pk, jk)
    for single in (DeviceTable(TableConfig(**TABLE), capacity=64,
                               device="cpu", backend="numpy"),
                   JaxDeviceTable(JaxTableConfig(**TABLE), capacity=64,
                                  backend="numpy")):
        single.load_delta(str(tmp_path / "d3.npz"))
        assert len(single) == ndev * 2
    base = str(tmp_path / "base.npz")
    pt.save(base)
    fresh = ShardedDeviceTable(TableConfig(**TABLE),
                               make_mesh(ndev, device="cpu"),
                               capacity_per_shard=16, backend="numpy")
    fresh.load_delta(str(tmp_path / "d1.npz"))
    assert len(fresh) == ndev * 8
    k, v, _ = rows_by_key(fresh.snapshot())
    bk, bv, _ = rows_by_key(dict(np.load(base)))
    np.testing.assert_array_equal(k, bk)
    np.testing.assert_array_equal(v, bv)
    assert fresh.save_delta(str(tmp_path / "d4.npz")) == 0


@pytest.mark.parametrize("ndev", [2, 8])
def test_variable_layout_on_mesh_engine(ndev):
    """The variable arena on the device-prep mesh engine: union storage a
    shard, losses and rows within 1e-5 of the reference's, every trained
    row claimed the base size (its seqpool grads flow through it), the
    size codes equal."""
    need_native()
    B, S = 8, 4
    ref, port = worlds(ndev, True, B, S, cap=2048, table_kw=dict(
        expand_dim=6, variable_embedding=True, initial_range=0.01))
    pt = port[1]
    assert pt.dim == 3 + 6
    rng = np.random.default_rng(7)
    for _ in range(3):
        jl, pl = step_both(ref, port, make_batch(rng, ndev, B, S, 128, 600),
                           True)
        np.testing.assert_allclose(pl, jl, rtol=1e-5)
    # the arenas start from the same rows only where both are zero: the
    # trained rows' change is held by key through the claimed codes
    codes = np.concatenate([st[:n, pt.layout.size_col].numpy()
                            for st, n in zip(pt.state, pt._sizes)])
    claimed = codes[codes != 0]
    assert claimed.size > 0 and (claimed == 1).all()
    jcodes = np.asarray(ref[1].state)[:, :, ref[1].layout.size_col]
    for s in range(ndev):
        n = pt._sizes[s]
        np.testing.assert_array_equal(pt.state[s][:n, pt.layout.size_col]
                                      .numpy(), jcodes[s, :n])
