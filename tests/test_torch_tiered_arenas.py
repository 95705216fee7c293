"""Port's tiered table over bfloat16 and int8 arenas
(``TieredDeviceTable(value_dtype=...)``) against the reference's, on the
CPU: passes under each package's ``FusedTrainStep`` (device prep and host
prep), the disk ladder with the prefetch and the deferred demote, the
variable layout's refusal, and the arena's in-place refill.

What is held bit for bit, and why the rest is not. Staging and writeback
are host numpy in both packages (``ArenaLayout.arena_from_canonical``,
``canonical_from_arena``), so the staged rows (scales included, the padding
repeat of the last row too), the backing by key and the delta snapshots are
compared bit for bit: each pass carries the reference's fresh arena into
the port's in place after ``begin_feed_pass`` (the two inits are different
generators) and its trained arena before ``end_pass``. Training itself is
held within tolerance, as ``tests/test_torch_arenas.py`` holds it: losses
atol 1e-5, show/clk exact, int8 values within one quantum of the
reference's group scale plus 1e-5 (XLA divides by 127 as a multiply by its
reciprocal, so a code at a rounding tie may flip), bf16 values within one
bfloat16 spacing plus 1e-5, the optimizer state within 1e-5."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu import flags as ref_flags
from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.config import TrainerConfig as JaxTrainerConfig
from paddlebox_tpu.models import DeepFM as FlaxDeepFM
from paddlebox_tpu.ps import native as ref_native
from paddlebox_tpu.ps.ssd_tier import DiskTier as RefDiskTier
from paddlebox_tpu.ps.table import EmbeddingTable as RefTable
from paddlebox_tpu.ps.tiered_table import TieredDeviceTable as JaxTiered
from paddlebox_tpu.trainer.fused_step import FusedTrainStep as JaxStep
from paddlebox_tpu_torch.config import TableConfig, TrainerConfig
from paddlebox_tpu_torch.models.convert import deepfm_from_flax_leaves
from paddlebox_tpu_torch.ps.ssd_tier import DiskTier
from paddlebox_tpu_torch.ps.table import EmbeddingTable
from paddlebox_tpu_torch.ps.tiered_table import TieredDeviceTable
from paddlebox_tpu_torch.trainer.fused_step import FusedTrainStep

pytestmark = pytest.mark.skipif(not ref_native.available(),
                                reason="native backend unavailable")

B, S, NPAD = 16, 4, 256
HIDDEN = (16,)
TABLE = dict(embedx_dim=8, cvm_offset=3, optimizer="adagrad",
             learning_rate=0.15, embedx_threshold=0.0, initial_range=0.01,
             show_clk_decay=0.9, seed=3)
DTYPES = {"int8": (jnp.int8, torch.int8), "bf16": (jnp.bfloat16,
                                                   torch.bfloat16)}
NATIVE = dict(backend="native", index_threads=1)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """JAX's CPU thread pools spin beside torch's intra-op threads and slow
    these small torch ops several times over; one thread is enough."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def leaves_of(params):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]


def synth_batches(seed, n, vocab):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lengths = rng.integers(1, 4, size=B * S)
        k = int(lengths.sum())
        keys = np.zeros(NPAD, np.uint64)
        keys[:k] = rng.integers(1, vocab, size=k)
        segs = np.full(NPAD, B * S, np.int32)
        segs[:k] = np.repeat(np.arange(B * S, dtype=np.int32), lengths)
        labels = (rng.uniform(size=B) < 0.4).astype(np.float32)
        cvm = np.stack([np.ones(B, np.float32), labels], axis=1)
        out.append((keys, segs, cvm, labels, np.zeros((B, 0), np.float32),
                    np.ones(B, np.float32)))
    return out


def arena_np(t, ref: bool):
    """(values as float32, state) of a table's whole arena, host copies."""
    if ref:
        return (np.asarray(jnp.asarray(t.values, jnp.float32)).copy(),
                np.asarray(t.state).copy())
    return t.values.float().numpy().copy(), t.state.numpy().copy()


def carry(jt, pt):
    """The reference's arena into the port's, in place (the addresses, and
    so a captured run, stay)."""
    ptrs = (pt.values.data_ptr(), pt.state.data_ptr())
    vals, st = arena_np(jt, True)
    pt.values.copy_(torch.from_numpy(vals).to(pt.values.dtype))
    pt.state.copy_(torch.from_numpy(st))
    assert (pt.values.data_ptr(), pt.state.data_ptr()) == ptrs


def assert_trained_close(pt, jt, n):
    """Rows 0..n-1 of two trained arenas in the canonical layout: show/clk
    exact, values within one int8 quantum or bf16 spacing plus 1e-5, the
    optimizer state within 1e-5."""
    lay = pt.layout
    (pv, ps), (jv, js) = arena_np(pt, False), arena_np(jt, True)
    pc, pst = lay.canonical_from_arena(pv[:n], ps[:n])
    jc, jst = lay.canonical_from_arena(jv[:n], js[:n])
    np.testing.assert_array_equal(pc[:, :2], jc[:, :2])
    tol = np.full(jc.shape, 1e-5, np.float32)
    for gi, (start, width, _) in enumerate(lay.groups):
        if lay.quantized:
            tol[:, start:start + width] += js[:n, 2 + gi:3 + gi] * 1.001
        else:
            tol[:, start:start + width] += \
                np.abs(jc[:, start:start + width]) * 2.0 ** -7
    assert np.all(np.abs(pc - jc) <= tol)
    np.testing.assert_allclose(pst, jst, rtol=0, atol=1e-5)


def backing_rows(t):
    snap = t.backing.snapshot(reset_dirty=False)
    order = np.argsort(snap["keys"])
    return [snap[k][order] for k in ("keys", "values", "state",
                                     "embedx_ok")]


def npz_by_key(path):
    with np.load(path) as z:
        order = np.argsort(z["keys"])
        return {k: z[k][order] for k in z.files}


@pytest.mark.parametrize("device_prep", [True, False])
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_passes_match_reference(dtype, device_prep, tmp_path):
    """Three passes of four batches, each pass staging its batches' keys
    (a third of them new each pass): the staged rows bit for bit, training
    within tolerance, the dirty rows, then the backing and each pass's
    delta bit for bit by key; ``end_pass`` refills the arena in place."""
    jdt, pdt = DTYPES[dtype]
    jt = JaxTiered(JaxTableConfig(**TABLE), capacity=1 << 10,
                   value_dtype=jdt, **NATIVE)
    pt = TieredDeviceTable(TableConfig(**TABLE), capacity=1 << 10,
                           value_dtype=pdt, device="cpu", **NATIVE)
    jfs = JaxStep(FlaxDeepFM(hidden=HIDDEN), jt, JaxTrainerConfig(), B, S,
                  device_prep=device_prep)
    jp, jo = jfs.init(jax.random.PRNGKey(1))
    pfs = FusedTrainStep(deepfm_from_flax_leaves(leaves_of(jp), HIDDEN), pt,
                         TrainerConfig(), B, S, device_prep=device_prep)
    js = [jp, jo, jfs.init_auc_state()]
    ps = [*pfs.init(), pfs.init_auc_state()]
    jentry = jfs.step_device if device_prep else jfs
    pentry = pfs.step_device if device_prep else pfs
    ptrs = (pt.values.data_ptr(), pt.state.data_ptr())
    for p in range(3):
        batches = synth_batches(10 + p, 4, 150 * (p + 2))
        keys = np.concatenate([b[0] for b in batches])
        w = jt.begin_feed_pass(keys)
        assert pt.begin_feed_pass(keys) == w > 0
        (pv, pst), (jv, jst) = arena_np(pt, False), arena_np(jt, True)
        np.testing.assert_array_equal(pv[:w + 1], jv[:w + 1])
        np.testing.assert_array_equal(pst[:w + 1], jst[:w + 1])
        carry(jt, pt)
        for batch in batches:
            *js, jloss, _ = jentry(*js, *batch)
            *ps, loss, _ = pentry(*ps, *batch)
            np.testing.assert_allclose(float(loss), float(jloss), rtol=0,
                                       atol=1e-5)
        assert pt._size == jt._size == w + 1
        assert_trained_close(pt, jt, w + 1)
        np.testing.assert_array_equal(pt.fetch_dirty_rows(),
                                      jt.fetch_dirty_rows())
        carry(jt, pt)
        pt.end_pass()
        jt.end_pass()
        for a, b in zip(backing_rows(pt), backing_rows(jt)):
            np.testing.assert_array_equal(a, b)
        pt.save_delta(str(tmp_path / f"p{p}.npz"))
        jt.save_delta(str(tmp_path / f"j{p}.npz"))
        pd, jd = (npz_by_key(str(tmp_path / f"{x}{p}.npz"))
                  for x in "pj")
        assert sorted(pd) == sorted(jd) and pd["keys"].size > 0
        for k in jd:
            np.testing.assert_array_equal(pd[k], jd[k])
        # the refill is in place: fresh stats, the shared init scale
        assert (pt.values.data_ptr(), pt.state.data_ptr()) == ptrs
        so = pt.layout.stat_off
        assert not pt.state[:, :2].any()
        if dtype == "int8":
            scale = TABLE["initial_range"] / 127.0
            np.testing.assert_array_equal(
                pt.state[:, 2:so].numpy(),
                np.float32(scale) * np.ones((pt.capacity, so - 2),
                                            np.float32))
    assert len(pt) == len(jt) > 300


def disk_stream(name, root, dtype, mode, monkeypatch):
    """Three passes through package ``name``'s tiered table of ``dtype``
    over a numpy backing and a ``DiskTier``: a persistent head and a new
    slab each pass, the staged rows "trained" by one deterministic write
    (the show column of the state, one value column, every row dirty), and
    after each ``end_pass`` every row spilled and the root compacted, so
    each pass restages from disk. ``mode`` "async": the next pass
    prefetched, the deferred demote on."""
    conf = dict(TABLE, embedx_dim=4, show_clk_decay=0.5)
    if name == "port":
        backing = EmbeddingTable(TableConfig(**conf), backend="numpy")
        disk = DiskTier(backing, root)
        table = TieredDeviceTable(TableConfig(**conf), backing=backing,
                                  capacity=1 << 11, disk=disk,
                                  value_dtype=DTYPES[dtype][1],
                                  backend="numpy", device="cpu")
        monkeypatch.setenv("PBOX_FLAGS_ps_tier_demote",
                           "1" if mode == "async" else "0")
    else:
        backing = RefTable(JaxTableConfig(**conf), backend="numpy")
        disk = RefDiskTier(backing, root)
        table = JaxTiered(JaxTableConfig(**conf), backing=backing,
                          capacity=1 << 11, disk=disk,
                          value_dtype=DTYPES[dtype][0], backend="numpy")
        ref_flags.set("ps_tier_demote", mode == "async")
    rng = np.random.default_rng(5)
    passes = []
    for p in range(3):
        slab = rng.integers(1000, 1000 + 600 * (p + 1), size=400,
                            dtype=np.uint64)
        passes.append(np.concatenate([np.arange(1, 150, dtype=np.uint64),
                                      slab]))
    ws = []
    try:
        for p, keys in enumerate(passes):
            w = table.begin_feed_pass(keys)
            ws.append(w)
            vals, st = arena_np(table, name == "ref")
            st[1:w + 1, 0] += p + 1
            vals[1:w + 1, 3] = (p + 1) * (-1.0) ** p
            if name == "port":
                table.values.copy_(torch.from_numpy(vals).to(
                    table.values.dtype))
                table.state.copy_(torch.from_numpy(st))
            else:
                table.values = jnp.asarray(vals).astype(table.values.dtype)
                table.state = jnp.asarray(st)
            table._dirty[1:w + 1] = True
            if mode == "async" and p + 1 < len(passes):
                table.prefetch_feed_pass(passes[p + 1])
            table.end_pass()
            disk.evict_cold(show_threshold=np.inf)
            disk.compact()
    finally:
        if name == "ref":
            ref_flags.set("ps_tier_demote", False)
    lk = np.sort(disk._index.live_items()[0])
    rows = disk.read_rows(lk)
    files = {f: open(os.path.join(root, f), "rb").read()
             for f in sorted(os.listdir(root))}
    return ws, lk, rows[:3], files


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_disk_ladder_matches_reference(dtype, mode, tmp_path, monkeypatch):
    """The disk ladder under a low-precision arena: the prefetch's consume,
    the disk reads and the deferred demote carry canonical float32 rows, so
    each pass's W, the disk's rows and the chunk files equal the
    reference's byte for byte."""
    got = disk_stream("port", str(tmp_path / "p"), dtype, mode, monkeypatch)
    want = disk_stream("ref", str(tmp_path / "r"), dtype, mode, monkeypatch)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].size > 400
    for a, b in zip(got[2], want[2]):
        np.testing.assert_array_equal(a, b)
    assert got[3] == want[3]


def test_variable_arena_behaves_as_reference():
    """A variable arena needs a backing of its layout, which no host table
    stores: without a backing both packages raise the host table's
    ``ValueError``; over a backing of the fixed layout both build and
    refuse the staging with a ``ValueError`` (rows 13 wide, the arena 9)."""
    kw = dict(embedx_dim=4, expand_dim=6, cvm_offset=3)
    pconf = TableConfig(**kw, variable_embedding=True)
    jconf = JaxTableConfig(**kw, variable_embedding=True)
    with pytest.raises(ValueError, match="variable_embedding"):
        JaxTiered(jconf, capacity=64)
    with pytest.raises(ValueError, match="variable_embedding"):
        TieredDeviceTable(pconf, capacity=64, device="cpu")
    jt = JaxTiered(jconf, backing=RefTable(JaxTableConfig(**kw)),
                   capacity=64)
    pt = TieredDeviceTable(pconf, backing=EmbeddingTable(TableConfig(**kw)),
                           capacity=64, device="cpu")
    assert (pt.dim, pt.backing.dim) == (jt.dim, jt.backing.dim) == (9, 13)
    keys = np.arange(1, 20, dtype=np.uint64)
    with pytest.raises(ValueError):
        jt.begin_feed_pass(keys)
    with pytest.raises(ValueError, match="13 value columns"):
        pt.begin_feed_pass(keys)
