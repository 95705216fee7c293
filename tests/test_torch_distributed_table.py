"""The port's cross-host PS (``paddlebox_tpu_torch/ps/distributed.py``
``DistributedTable``) against the reference's at world 2, ranks as
threads, each case the reference's ``tests/test_coordinator.py::
TestDistributedTable``: every pull, export and length bit for bit, and each
rank's shard by key (its local ``EmbeddingTable``, numpy backend) bit for
bit; the saves under ``.rank-NNNNN`` load across the packages."""

import os

import numpy as np
import pytest

from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.ps import EmbeddingTable as JaxEmbeddingTable
from paddlebox_tpu.ps.distributed import DistributedTable as JaxDistTable
from paddlebox_tpu_torch.config import TableConfig
from paddlebox_tpu_torch.ps.distributed import DistributedTable
from paddlebox_tpu_torch.ps.sharded import shard_of
from paddlebox_tpu_torch.ps.table import EmbeddingTable
from torch_coord_world import run_ranks, world

WORLD = 2
CONF = dict(embedx_dim=4, cvm_offset=3, optimizer="adagrad",
            learning_rate=0.1, embedx_threshold=0.0, seed=7)
PACKAGES = {"ref": (JaxTableConfig, JaxEmbeddingTable, JaxDistTable),
            "port": (TableConfig, EmbeddingTable, DistributedTable)}


def ranks(pkg, fn):
    """``fn(rank, dist_table, coord)`` on two ranks of ``pkg`` ("ref" or
    "port"), each over a fresh numpy-backed shard."""
    conf_cls, table_cls, dist_cls = PACKAGES[pkg]
    conf = conf_cls(**CONF)
    return run_ranks(lambda r, c: fn(r, dist_cls(
        conf, c, local_table=table_cls(conf, backend="numpy")), c),
        world(pkg, WORLD))


def both(fn):
    """``ranks`` of each package: {package: per-rank results}."""
    return {pkg: ranks(pkg, fn) for pkg in PACKAGES}


def shard(dt):
    """The rank's shard by key: keys, values, state, embedx_ok."""
    snap = dt.local.snapshot(reset_dirty=False)
    order = np.argsort(snap["keys"])
    return tuple(snap[k][order] for k in ("keys", "values", "state",
                                          "embedx_ok"))


def assert_same(got, want):
    """Nested results of both packages, arrays bit for bit."""
    if isinstance(got, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    elif isinstance(got, np.ndarray):
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def steps(seed=0, n=3, vocab=500):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = rng.integers(1, vocab, size=64).astype(np.uint64)
        g = (rng.normal(size=(64, 7)) * 0.1).astype(np.float32)
        g[:, 0] = 1.0
        out.append((k, g))
    return out


def test_pull_push_matches_reference():
    """Each rank pulls and pushes its own stream (duplicate keys, keys of
    both owners) for 3 steps: every pull and each shard by key bit for
    bit; each shard holds only its own keys."""
    streams = [steps(seed=r) for r in range(WORLD)]

    def fn(r, dt, c):
        pulls = []
        for k, g in streams[r]:
            pulls.append(dt.pull(k))
            dt.push(k, g)
        c.barrier("done")
        return pulls, shard(dt), len(dt)

    res = both(fn)
    assert_same(res["port"], res["ref"])
    for r, (_pulls, (keys, _v, _s, _ok), total) in enumerate(res["port"]):
        assert (shard_of(keys, WORLD) == r).all()
        assert total == sum(x[1][0].size for x in res["port"])


def test_pull_create_false_and_feed_pass():
    """``create=False`` pulls zeros and creates nothing; ``feed_pass``
    stages each key on its owner once."""
    keys = np.arange(1, 200, dtype=np.uint64)

    def fn(r, dt, c):
        out = dt.pull(np.array([111, 222], np.uint64), create=False)
        n0 = len(dt)
        dt.feed_pass(keys[r::2])
        c.barrier("fed")
        return out, n0, shard(dt), len(dt)

    res = both(fn)
    assert_same(res["port"], res["ref"])
    for out, n0, _s, n in res["port"]:
        assert not out.any() and n0 == 0 and n == 199


@pytest.mark.parametrize("mode", ["set", "add"])
def test_export_import_rows_match_reference(mode):
    """``export_rows`` creates and fetches rows from their owners;
    ``import_rows`` writes edited rows back: "set" from rank 0 alone (an
    empty call on rank 1), "add" a delta from each rank, which the owners
    sum."""
    keys = np.arange(1, 160, dtype=np.uint64)

    def fn(r, dt, c):
        vals, state = dt.export_rows(keys, create=True)
        c.barrier("exported")
        if mode == "add":
            dt.import_rows(keys, np.full_like(vals, 0.25 * (r + 1)),
                           np.full_like(state, 0.5), mode="add")
        elif r == 0:
            dt.import_rows(keys, vals + 0.5, state, mode="set")
        else:
            dt.import_rows(np.empty(0, np.uint64),
                           np.zeros((0, vals.shape[1]), np.float32),
                           np.zeros((0, state.shape[1]), np.float32))
        c.barrier("imported")
        back, bstate = dt.export_rows(keys, create=False)
        return vals, state, back, bstate, shard(dt)

    res = both(fn)
    assert_same(res["port"], res["ref"])
    for vals, state, back, bstate, _s in res["port"]:
        if mode == "add":
            np.testing.assert_allclose(back, vals + 0.75, rtol=1e-6)
            np.testing.assert_allclose(bstate, state + 1.0, rtol=1e-6)
        else:
            np.testing.assert_array_equal(back, vals + 0.5)


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port"),
                                           ("port", "port")])
def test_save_load_and_deltas_across_packages(tmp_path, writer, reader):
    """The global ``len``; ``save`` and ``save_delta`` (one file a rank,
    ``.rank-NNNNN``) by ``writer``'s ranks, whose counts and pulls are the
    other package's bit for bit; ``load`` and ``load_delta`` into fresh
    tables of ``reader``'s ranks: every pull bit for bit."""
    keys = np.arange(1, 120, dtype=np.uint64)
    base = str(tmp_path / "dt.npz")
    delta = str(tmp_path / "dt.d1.npz")

    def write(r, dt, c):
        dt.feed_pass(keys)
        k, g = steps(seed=5 + r, n=1, vocab=120)[0]
        dt.push(k, g)
        c.barrier("fed")
        total = len(dt)
        dt.save(base)
        dt.push(k[:10], g[:10])
        rows = dt.save_delta(delta)
        probe = dt.pull(keys, create=False)
        dt.end_pass()
        return total, rows, probe

    other = "ref" if writer == "port" else "port"
    want = ranks(other, write)
    wrote = ranks(writer, write)
    assert_same(wrote, want)
    for r in range(WORLD):
        assert os.path.exists(f"{base}.rank-{r:05d}")
        assert os.path.exists(f"{delta}.rank-{r:05d}")
    assert wrote[0][0] == 119 and sum(w[1] for w in wrote) > 0

    def read(r, dt, c):
        dt.load(base)
        dt.load_delta(delta)
        c.barrier("loaded")
        return len(dt), dt.pull(keys, create=False)

    for (n, probe), (_t, _rows, pulled) in zip(ranks(reader, read), wrote):
        assert n == 119
        np.testing.assert_array_equal(probe, pulled)


def test_shrink_and_local_surface():
    """``shrink`` and ``memory_bytes`` act on the local shard only (no
    collective), as the reference's."""
    def fn(r, dt, c):
        dt.feed_pass(np.arange(1, 50, dtype=np.uint64))
        c.barrier("fed")
        return dt.shrink(), dt.memory_bytes() == dt.local.memory_bytes()

    res = both(fn)
    assert_same(res["port"], res["ref"])
