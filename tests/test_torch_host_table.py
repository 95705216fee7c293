"""Port's host ``EmbeddingTable`` (``paddlebox_tpu_torch/ps/table.py``, the
DRAM tier) and its sparse optimizers against the JAX package's, on the same
seeded inputs, for both backends (numpy over a dict index, native over
``csrc/pbx_index.cpp``) and for sgd, adagrad and adam. Exact: both run the
same numpy or C++ arithmetic, so every array is compared bit for bit —
the index, values, state, ``embedx_ok`` and dirty marks after each step,
every pull, export and snapshot, and the npz files crossing between the
packages both ways. ``key_init_uniform`` and ``DeviceTable.to_host_table``
are held to the reference's too."""

import numpy as np
import pytest

from paddlebox_tpu import flags as ref_flags
from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.ps import native as ref_native
from paddlebox_tpu.ps.device_table import DeviceTable as JaxDeviceTable
from paddlebox_tpu.ps.table import EmbeddingTable as JaxTable
from paddlebox_tpu.ps.table import key_init_uniform as ref_key_init
from paddlebox_tpu_torch.config import TableConfig
from paddlebox_tpu_torch.ps import native
from paddlebox_tpu_torch.ps.device_table import DeviceTable
from paddlebox_tpu_torch.ps.optimizer import (SparseAdaGrad, SparseAdam,
                                              SparseSGD,
                                              make_sparse_optimizer)
from paddlebox_tpu_torch.ps.table import EmbeddingTable, key_init_uniform

BACKENDS = ["numpy", "native"]
OPTIMIZERS = ["sgd", "adagrad", "adam"]


def confs(optimizer, **kw):
    base = dict(embedx_dim=4, expand_dim=2, cvm_offset=3,
                optimizer=optimizer, learning_rate=0.1, embedx_threshold=3.0,
                initial_range=0.05, show_clk_decay=0.8, delete_threshold=1.5,
                seed=7)
    base.update(kw)
    return JaxTableConfig(**base), TableConfig(**base)


def need(backend):
    if backend == "native" and not (native.available() and
                                    ref_native.available()):
        pytest.skip("native backend unavailable")


def tables(backend, optimizer, **kw):
    need(backend)
    jc, pc = confs(optimizer, **kw)
    return JaxTable(jc, backend=backend), EmbeddingTable(pc, backend=backend)


def state_of(t):
    """Every array of a table's state, in its row order."""
    n = t._size
    return [t._index.dump_keys(n), t._values[:n], t._state[:n],
            t._embedx_ok[:n], t._dirty[:n], np.array([len(t._index)])]


def assert_same(got, want, what=""):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (what, i)
        assert np.array_equal(g, w), (what, i)


def pushes(rng, dim, n=6, vocab=120):
    """Pushes with duplicate keys and key 0; show increments cross the
    embedx threshold after a few pushes."""
    out = []
    for _ in range(n):
        keys = rng.integers(0, vocab, size=60).astype(np.uint64)
        keys[:5] = 0
        grads = rng.normal(scale=0.3, size=(keys.size, dim)).astype(
            np.float32)
        grads[:, 0] = 1.0
        grads[:, 1] = (rng.uniform(size=keys.size) < 0.3).astype(np.float32)
        out.append((keys, grads))
    return out


def test_key_init_uniform_matches_reference():
    rng = np.random.default_rng(0)
    keys = np.concatenate([rng.integers(0, 1 << 63, size=300,
                                        dtype=np.uint64),
                           np.array([0, 1, (1 << 64) - 1, 1 << 63],
                                    np.uint64)])
    for seed, col, width, r in ((42, 2, 1, 1e-4), (7, 3, 8, 0.05),
                                (0, 11, 3, 1.0)):
        got = key_init_uniform(keys, seed, col, width, r)
        want = ref_key_init(keys, seed, col, width, r)
        assert got.dtype == np.float32
        assert np.array_equal(got, want)
        assert np.all(np.abs(got) <= r)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_optimizers_match_reference(optimizer):
    from paddlebox_tpu.ps.optimizer import \
        make_sparse_optimizer as ref_make
    jc, pc = confs(optimizer)
    rng = np.random.default_rng(1)
    ref, port = ref_make(jc, 4), make_sparse_optimizer(pc, 4)
    assert ref.state_width == port.state_width
    assert type(port) is {"sgd": SparseSGD, "adagrad": SparseAdaGrad,
                          "adam": SparseAdam}[optimizer]
    w0 = rng.normal(size=(9, 4)).astype(np.float32)
    st0 = np.abs(rng.normal(size=(9, max(port.state_width, 0)))).astype(
        np.float32)
    if optimizer == "adam":
        st0[:, 0] = np.arange(9)
    wr, sr, wp, sp = w0.copy(), st0.copy(), w0.copy(), st0.copy()
    for _ in range(3):
        g = rng.normal(size=(9, 4)).astype(np.float32)
        ref.update(wr, g, sr)
        port.update(wp, g, sp)
    assert np.array_equal(wp, wr) and np.array_equal(sp, sr)
    with pytest.raises(ValueError, match="unknown sparse optimizer"):
        make_sparse_optimizer(TableConfig(optimizer="lamb"), 4)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_training_half_matches_reference(backend, optimizer):
    """pull(create), push (duplicates, key 0, the threshold crossing, the
    non-finite clamp), end_pass, shrink, export_rows, import_rows set and
    add: every array after every step, bit for bit."""
    jt, pt = tables(backend, optimizer)
    rng = np.random.default_rng(2)
    dim = pt.dim
    trail = []

    def both(fn, what):
        a, b = fn(pt), fn(jt)
        if a is not None:
            assert_same(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,), what)
        assert_same(state_of(pt), state_of(jt), what)
        trail.append(what)

    first = np.array([5, 3, 0, 5, 9, 3], np.uint64)
    both(lambda t: t.pull(first, create=True), "pull create")
    both(lambda t: t.pull(np.array([5, 77, 0], np.uint64), create=False),
         "pull no create")
    for i, (keys, grads) in enumerate(pushes(rng, dim)):
        both(lambda t: t.push(keys, grads), f"push {i}")
        both(lambda t: t.pull(keys[:20], create=False), f"pull {i}")
    # the threshold crossed for some rows, not all
    assert pt._embedx_ok[:len(pt)].any() and \
        not pt._embedx_ok[:len(pt)].all()
    # a non-finite grad is clamped to 0 and counted
    keys = np.array([3, 3, 12, 0], np.uint64)
    grads = np.ones((4, dim), np.float32)
    grads[0, 3], grads[2, 4] = np.nan, np.inf
    both(lambda t: t.push(keys, grads), "push non-finite")
    assert pt.nonfinite_grad_rows == 2
    both(lambda t: t.end_pass(), "end_pass")
    n_before = len(pt)
    both(lambda t: t.shrink(), "shrink")
    assert 0 < len(pt) < n_before
    ex = np.array([1, 2, 3, 50, 60, 1 << 62], np.uint64)
    both(lambda t: t.export_rows(ex, create=True), "export create")
    both(lambda t: t.export_rows(np.array([3, 999], np.uint64),
                                 create=False), "export no create")
    vals = rng.normal(size=(3, dim)).astype(np.float32)
    vals[:, 0] = [0.5, 4.0, 9.0]
    st = rng.normal(size=(3, pt._state.shape[1])).astype(np.float32)
    imp = np.array([2, 50, 70], np.uint64)
    both(lambda t: t.import_rows(imp, vals, st), "import set")
    both(lambda t: t.import_rows(imp, vals, st, mode="add"), "import add")
    both(lambda t: t.contains_bulk(np.array([2, 70, 71, 0], np.uint64)),
         "contains_bulk")
    both(lambda t: t.feed_pass(np.array([0, 80, 81, 80, 2], np.uint64)),
         "feed_pass")
    both(lambda t: t.pull(np.arange(0, 90, dtype=np.uint64), create=False),
         "pull all")
    both(lambda t: t.memory_bytes(), "memory_bytes")
    assert len(trail) == 25


@pytest.mark.parametrize("backend", BACKENDS)
def test_check_nan_inf_raises(backend, monkeypatch):
    jt, pt = tables(backend, "adagrad")
    keys = np.array([4, 5], np.uint64)
    grads = np.ones((2, pt.dim), np.float32)
    grads[1, 2] = np.inf
    monkeypatch.setenv("PBOX_FLAGS_check_nan_inf", "1")
    old = ref_flags.get("check_nan_inf")
    ref_flags.set("check_nan_inf", True)
    try:
        for t in (pt, jt):
            with pytest.raises(FloatingPointError, match="1 keys"):
                t.push(keys, grads)
    finally:
        ref_flags.set("check_nan_inf", old)
    assert len(pt) == len(jt) == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_persistence_matches_reference(backend, tmp_path):
    """snapshot, snapshot_delta, mark_dirty, save, load, save_delta,
    load_delta, and each package's files loaded by the other."""
    jt, pt = tables(backend, "adam")
    rng = np.random.default_rng(3)
    for keys, grads in pushes(rng, pt.dim, n=3):
        jt.push(keys, grads)
        pt.push(keys, grads)
    for reset in (False, True):
        a, b = pt.snapshot(reset_dirty=reset), jt.snapshot(reset_dirty=reset)
        assert sorted(a) == sorted(b)
        assert_same([a[k] for k in sorted(a)], [b[k] for k in sorted(b)])
        assert_same(state_of(pt), state_of(jt), "snapshot")
    keys, grads = pushes(rng, pt.dim, n=1)[0]
    for t in (jt, pt):
        t.push(keys[:20], grads[:20])
        t.mark_dirty(np.array([1, 2, 999], np.uint64))
    a, b = pt.snapshot_parts(delta=True), jt.snapshot_parts(delta=True)
    assert list(a) == list(b) == [""]
    assert_same([a[""][k] for k in sorted(a[""])],
                [b[""][k] for k in sorted(b[""])], "delta")
    assert_same(state_of(pt), state_of(jt), "after delta")
    # base and delta files, each package's read by the other
    for t in (jt, pt):
        t.push(keys[20:], grads[20:])
    paths = {}
    for name, t in (("port", pt), ("ref", jt)):
        paths[name] = (str(tmp_path / f"{name}.npz"),
                       str(tmp_path / f"{name}-delta.npz"))
        t.save(paths[name][0])
    for name, t in (("port", pt), ("ref", jt)):
        t.push(keys[:30], grads[:30])
        assert t.save_delta(paths[name][1]) > 0
    for writer in ("port", "ref"):
        for reader in (EmbeddingTable, JaxTable):
            conf = confs("adam")[1 if reader is EmbeddingTable else 0]
            t = reader(conf, backend=backend)
            t.load(paths[writer][0])
            t.load_delta(paths[writer][1])
            fresh = [t._index.dump_keys(t._size), t._values[:t._size],
                     t._state[:t._size], t._embedx_ok[:t._size]]
            assert_same(fresh, state_of(jt)[:4], f"{writer} file")
    with np.load(paths["port"][0]) as got, np.load(paths["ref"][0]) as want:
        assert sorted(got.files) == sorted(want.files)
        assert_same([got[k] for k in sorted(got.files)],
                    [want[k] for k in sorted(want.files)], "base npz")


@pytest.mark.parametrize("backend", BACKENDS)
def test_to_host_table_matches_reference(backend):
    """``DeviceTable.to_host_table``: the same arena gives the same host
    table as the reference's."""
    need(backend)
    jc, pc = confs("adagrad", expand_dim=0)
    jt = JaxDeviceTable(jc, capacity=256, backend=backend,
                        **({"index_threads": 1} if backend == "native"
                           else {}))
    rng = np.random.default_rng(4)
    keys = rng.integers(1, 1 << 40, size=90).astype(np.uint64)
    jt.prepare_batch(keys, create=True)
    values = np.asarray(jt.values).copy()
    values[:, 0] = rng.uniform(0, 6, size=values.shape[0])
    state = np.abs(rng.normal(size=np.asarray(jt.state).shape)).astype(
        np.float32)
    jt.values, jt.state = jt.values.at[:].set(values), \
        jt.state.at[:].set(state)
    pt = DeviceTable(pc, capacity=1, device="cpu", backend=backend,
                     index_threads=1)
    pt.load_arena(values, state, jt._index.dump_keys(jt._size))
    got, want = pt.to_host_table(), jt.to_host_table()
    assert got.backend == want.backend == backend
    assert_same(state_of(got), state_of(want), "to_host_table")
    assert got._embedx_ok[:len(got)].any() and \
        not got._embedx_ok[:len(got)].all()


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_row_helpers_match_reference(path, monkeypatch):
    """``unique_inverse``, ``merge_add``, ``gather_rows``, ``scatter_rows``
    and ``expand_rows`` (the C++ of ``csrc/pbx_index.cpp``, and the numpy
    they fall back to where it does not build) against the reference's
    C++ helpers, bit for bit."""
    need("native")
    if path == "numpy":
        monkeypatch.setattr(native, "_load", lambda: None)
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 60, size=500).astype(np.uint64)
    keys[:3] = [(1 << 64) - 1, 1 << 63, 0]
    got, want = native.unique_inverse(keys), ref_native.unique_inverse(keys)
    assert_same(got, want, "unique_inverse")
    grads = rng.normal(size=(keys.size, 7)).astype(np.float32)
    assert_same([native.merge_add(got[1], grads, got[0].size)],
                [ref_native.merge_add(want[1], grads, want[0].size)],
                "merge_add")
    arena = rng.normal(size=(40, 7)).astype(np.float32)
    rows = rng.integers(-3, 40, size=90)
    assert_same([native.gather_rows(arena, rows)],
                [ref_native.gather_rows(arena, rows)], "gather_rows")
    assert_same([native.expand_rows(arena[:10], got[1] % 10)],
                [ref_native.expand_rows(arena[:10], want[1] % 10)],
                "expand_rows")
    a, b = arena.copy(), arena.copy()
    rows = rng.permutation(40)[:25]
    vals = rng.normal(size=(25, 7)).astype(np.float32)
    native.scatter_rows(a, rows, vals)
    ref_native.scatter_rows(b, rows, vals)
    assert_same([a], [b], "scatter_rows")
    assert np.array_equal(a[rows], vals)
