"""Port's tiered table (``paddlebox_tpu_torch/ps/tiered_table.py``: a
bounded device arena staging each pass's working set from a host
``EmbeddingTable``) on the CPU: the reference's
``tests/test_tiered_table.py`` cases that need no disk tier, run on the
port, and each package's tiered table under its ``FusedTrainStep`` over
the same passes, from converted params.

Tolerances. Within the port: the pass split and the prefetch against
synchronous staging bit for bit (the same arithmetic in the same order),
device prep against host prep bit for bit (the reference holds them within
1e-5, its device prep deferring inserts). Across the packages: losses rtol
1e-5, the backing by key with show/clk exact (counts) and the rest within
1e-5 (float32 GEMMs and reductions in another order over 8 steps). Passes
draw their keys from the staged ones, as ``examples/07_beyond_hbm_and_
multihost.py`` does, except the mid-pass-key case: a key that was not
staged takes an arena row whose random init comes from jax's PRNG in one
package and a ``torch.Generator`` in the other, so that case holds the
staged rows, the key sets and show/clk."""

import dataclasses
import os
import threading

import jax
import numpy as np
import pytest
import torch

from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.config import TrainerConfig as JaxTrainerConfig
from paddlebox_tpu.models import DeepFM as FlaxDeepFM
from paddlebox_tpu.ps import native as ref_native
from paddlebox_tpu.ps.tiered_table import TieredDeviceTable as JaxTiered
from paddlebox_tpu.trainer.fused_step import FusedTrainStep as JaxStep
from paddlebox_tpu_torch.config import BucketSpec, TableConfig, TrainerConfig
from paddlebox_tpu_torch.models import DeepFM
from paddlebox_tpu_torch.models.convert import deepfm_from_flax_leaves
from paddlebox_tpu_torch.parallel.mesh import make_mesh
from paddlebox_tpu_torch.ps.device_table import DeviceTable
from paddlebox_tpu_torch.ps.sharded_device_table import ShardedDeviceTable
from paddlebox_tpu_torch.ps.table import EmbeddingTable
from paddlebox_tpu_torch.ps.tiered_table import (TieredDeviceTable,
                                                TieredShardedDeviceTable)
from paddlebox_tpu_torch.trainer.fused_step import FusedTrainStep

B, S, NPAD = 32, 4, 512
HIDDEN = (16,)
TABLE = dict(embedx_dim=8, cvm_offset=3, optimizer="adagrad",
             learning_rate=0.15, embedx_threshold=0.0, initial_range=0.01,
             show_clk_decay=1.0, seed=3)
NATIVE = dict(backend="native", index_threads=1)

pytestmark = pytest.mark.skipif(not ref_native.available(),
                                reason="native backend unavailable")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """JAX's CPU thread pools spin beside torch's intra-op threads and slow
    these small torch ops several times over; one thread is enough."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def synth_batches(seed, n_batches, vocab):
    rng = np.random.default_rng(seed)
    kw = rng.normal(scale=1.2, size=vocab)
    out = []
    for _ in range(n_batches):
        lengths = rng.integers(1, 4, size=(B, S))
        n = int(lengths.sum())
        keys = np.zeros(NPAD, np.uint64)
        keys[:n] = rng.integers(1, vocab, size=n)
        segs = np.full(NPAD, B * S, np.int32)
        segs[:n] = np.repeat(np.arange(B * S), lengths.reshape(-1))[:n]
        score = np.zeros(B)
        np.add.at(score, segs[:n] // S, kw[keys[:n].astype(np.int64)])
        labels = (rng.uniform(size=B) <
                  1 / (1 + np.exp(-score))).astype(np.float32)
        out.append((keys, segs, labels))
    return out


def step_args(segs, labels):
    cvm = np.stack([np.ones(B, np.float32), labels], axis=1)
    return (segs, cvm, labels, np.zeros((B, 0), np.float32),
            np.ones(B, np.float32))


def port_step(table, device_prep=False, model=None, seed=0):
    if model is None:
        torch.manual_seed(seed)
        model = DeepFM(S * table.dim, HIDDEN)
    fs = FusedTrainStep(model, table, TrainerConfig(), B, S,
                        device_prep=device_prep)
    return fs, [*fs.init(), fs.init_auc_state()]


def train_passes(table, batches, passes, device_prep=False, seed=0,
                 model=None, prefetch=False, pass_keys=None):
    """Split ``batches`` into ``passes`` feed passes and train them through
    the port's step; returns the losses. ``prefetch``: the next pass's
    staging starts after each pass's first step. ``pass_keys`` (a function
    of the pass's batches) picks the keys staged."""
    fs, st = port_step(table, device_prep, model, seed)
    entry = fs.step_device if device_prep else fs
    per = len(batches) // passes
    chunks = [batches[p * per:(p + 1) * per] for p in range(passes)]
    keys_of = pass_keys or (lambda ch: np.concatenate([b[0] for b in ch]))
    losses = []
    for p, chunk in enumerate(chunks):
        table.begin_feed_pass(keys_of(chunk))
        for i, (keys, segs, labels) in enumerate(chunk):
            *st[:3], loss, _ = entry(*st, keys, *step_args(segs, labels))
            losses.append(float(loss))
            if prefetch and i == 0 and p + 1 < passes:
                table.prefetch_feed_pass(keys_of(chunks[p + 1]))
        table.end_pass()
    return np.array(losses)


def backing_rows(table):
    """(keys, values, state, embedx_ok) of the backing, key-sorted."""
    snap = table.backing.snapshot(reset_dirty=False)
    order = np.argsort(snap["keys"])
    return tuple(snap[k][order] for k in ("keys", "values", "state",
                                          "embedx_ok"))


def assert_rows_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def tiered(capacity, **kw):
    conf = TableConfig(**dict(TABLE, **kw.pop("conf", {})))
    return TieredDeviceTable(conf, capacity=capacity, device="cpu", **kw)


def test_pass_split_parity():
    """One pass against eight: the same backing bit for bit (staging and
    writeback are lossless, optimizer state included), in an arena that
    holds only one eighth of the keys' rows."""
    batches = synth_batches(1, 16, 400)
    t_one = tiered(1 << 10)
    l1 = train_passes(t_one, batches, passes=1, seed=7)
    t_many = tiered(1 << 9)
    l2 = train_passes(t_many, batches, passes=8, seed=7)
    assert len(t_one) > 0 and len(t_many.backing) == len(t_one.backing)
    assert_rows_equal(backing_rows(t_one), backing_rows(t_many))
    np.testing.assert_array_equal(l1, l2)


def test_device_prep_matches_host_prep():
    """Device prep probes the pass-local mirror (as large as the working
    set): with every key staged, the same backing and losses as host prep
    over the same native index, bit for bit."""
    batches = synth_batches(2, 16, 600)
    t_host = tiered(1 << 10, **NATIVE)
    lh = train_passes(t_host, batches, passes=4, seed=5)
    t_dev = tiered(1 << 10, **NATIVE)
    ld = train_passes(t_dev, batches, passes=4, device_prep=True, seed=5)
    assert t_dev.mirror is not None and t_host.mirror is None
    assert_rows_equal(backing_rows(t_host), backing_rows(t_dev))
    np.testing.assert_array_equal(lh, ld)


def test_mirror_follows_the_working_set():
    """The mirror's slots follow W, not the backing; end_pass empties it
    in place (its address stays) and re-randomizes the arena in place."""
    t = tiered(1 << 12, **NATIVE)
    t.enable_device_index()
    t.begin_feed_pass(np.arange(1, 3001, dtype=np.uint64))
    t.end_pass()
    tab, values = t.mirror.tab.data_ptr(), t.values.data_ptr()
    before = t.values.clone()
    w = t.begin_feed_pass(np.arange(5000, 5300, dtype=np.uint64))
    assert w == 300 and len(t.backing) == 3300
    assert t.mirror.memory_bytes() == (1024 + 64) * 16
    t.end_pass()
    assert t.mirror.tab.data_ptr() != tab   # W shrank: a smaller table
    tab = t.mirror.tab.data_ptr()
    assert not t.mirror.tab[:, :2].ne(-1).any()
    assert t.values.data_ptr() == values and not torch.equal(t.values,
                                                             before)
    t.begin_feed_pass(np.arange(6000, 6300, dtype=np.uint64))
    assert t.mirror.tab.data_ptr() == tab   # same capacity: in place
    rows, found = t.mirror.probe(torch.tensor([6000, 6299, 5000]))
    assert rows.tolist()[:2] == [1, 300] and found.tolist() == [
        True, True, False]


def test_oversized_pass_raises():
    table = tiered(64)
    with pytest.raises(RuntimeError, match="working set"):
        table.begin_feed_pass(np.arange(1, 200, dtype=np.uint64))
    table = tiered(64)
    table.begin_feed_pass(np.arange(1, 60, dtype=np.uint64))
    with pytest.raises(RuntimeError, match="working set"):
        table.prepare_batch(np.arange(100, 110, dtype=np.uint64))


def test_save_midpass_flushes_and_resumes(tmp_path):
    batches = synth_batches(3, 8, 300)
    table = tiered(1 << 10)
    fs, st = port_step(table)
    table.begin_feed_pass(np.concatenate([b[0] for b in batches]))
    for keys, segs, labels in batches[:4]:
        *st[:3], _, _ = fs(*st, keys, *step_args(segs, labels))
    path = os.path.join(tmp_path, "mid.npz")
    table.save(path)            # mid-pass: the staged rows flush first
    t2 = tiered(1 << 10)
    t2.load(path)
    assert len(t2) == len(table) > 0
    assert_rows_equal(backing_rows(table), backing_rows(t2))
    assert backing_rows(t2)[1][:, 0].max() > 0
    # training goes on after the save, and the pass still writes back
    for keys, segs, labels in batches[4:]:
        *st[:3], _, _ = fs(*st, keys, *step_args(segs, labels))
    assert table.writeback() > 0
    table.end_pass()
    with pytest.raises(RuntimeError, match="open pass"):
        table.begin_feed_pass(batches[0][0])
        table.load(path)


def prefetch_run(conf_kw, batches, prefetch, passes=4):
    t = tiered(1 << 10, conf=conf_kw)
    losses = train_passes(t, batches, passes=passes, seed=7,
                          prefetch=prefetch)
    return t, losses


def test_prefetch_exact_vs_sync_with_decay_overlap():
    """The prefetch starts after each pass's first step, so its export
    misses that pass's writeback and the pass-end decay: the consume
    re-exports the one and replays the other, bit for bit."""
    conf = dict(embedx_dim=8, show_clk_decay=0.9, embedx_threshold=2.0)
    batches = synth_batches(5, 16, 500)
    t_sync, l_sync = prefetch_run(conf, batches, prefetch=False)
    t_pre, l_pre = prefetch_run(conf, batches, prefetch=True)
    assert_rows_equal(backing_rows(t_sync), backing_rows(t_pre))
    np.testing.assert_array_equal(l_sync, l_pre)


def test_consume_takes_the_buffers():
    """begin_feed_pass consumes a matching prefetch (a spy sees the
    buffers taken), and W is the same."""
    t = tiered(256, conf=dict(show_clk_decay=0.8))
    keys = np.arange(1, 60, dtype=np.uint64)
    t.begin_feed_pass(keys)
    t.prefetch_feed_pass(keys)
    taken = []
    orig = t._consume_prefetch
    t._consume_prefetch = lambda u: taken.append(orig(u)) or taken[-1]
    t.end_pass()
    assert t.begin_feed_pass(keys) == 59
    assert taken[0] is not None and t._prefetch is None
    t.end_pass()
    t2 = tiered(256, conf=dict(show_clk_decay=0.8))
    for _ in range(2):
        t2.begin_feed_pass(keys)
        t2.end_pass()
    assert_rows_equal(backing_rows(t), backing_rows(t2))


def test_mismatched_prefetch_falls_back():
    t = tiered(256, conf=dict(embedx_dim=4))
    t.prefetch_feed_pass(np.arange(1, 50, dtype=np.uint64))
    w = t.begin_feed_pass(np.arange(100, 180, dtype=np.uint64))
    assert w == 80 and t._prefetch is None
    t.end_pass()


def test_failed_worker_start_publishes_nothing(monkeypatch):
    """A worker thread that fails to start raises once; the table is not
    wedged (sync staging works) and a later prefetch starts it again."""
    t = tiered(256, conf=dict(embedx_dim=4))
    keys = np.arange(1, 50, dtype=np.uint64)
    monkeypatch.setattr(threading.Thread, "start",
                        lambda self: (_ for _ in ()).throw(
                            RuntimeError("can't start new thread")))
    with pytest.raises(RuntimeError, match="can't start new thread"):
        t.prefetch_feed_pass(keys)
    monkeypatch.undo()
    assert t._prefetch is None
    assert t.begin_feed_pass(keys) == 49
    t.end_pass()
    t.prefetch_feed_pass(keys)
    assert t._prefetch is not None
    assert t.begin_feed_pass(keys) == 49
    t.end_pass()


def test_failed_prefetch_stages_synchronously(monkeypatch, tmp_path):
    """A prefetch whose export raised on the tier worker is dropped, as in
    the reference: the begin_feed_pass that would consume it stages
    synchronously, nothing raises, and the pass trains like a synchronous
    twin, bit for bit (staged arena, trained backing, written delta)."""
    batches = synth_batches(4, 8, 300)
    keys = np.concatenate([b[0] for b in batches])
    worlds = []
    for fail in (False, True):
        t = tiered(1 << 10)
        if fail:
            export, calls = t.backing.export_rows, []

            def broken_once(*a, **k):
                calls.append(threading.current_thread().name)
                if len(calls) == 1:
                    raise OSError("export failed")
                return export(*a, **k)

            monkeypatch.setattr(t.backing, "export_rows", broken_once)
            t.prefetch_feed_pass(keys)
            t._join_prefetch()
            assert isinstance(t._prefetch[1]["error"], OSError)
        w = t.begin_feed_pass(keys)
        if fail:
            # the worker's export failed, the synchronous one staged
            assert calls[0] == "pbx-tier-worker" and len(calls) == 2
            assert t._prefetch is None and t.in_pass
        staged = (t.values[:w + 1].clone(), t.state[:w + 1].clone())
        fs, st = port_step(t, seed=7)
        losses = []
        for k, segs, labels in batches:
            *st[:3], loss, _ = fs(*st, k, *step_args(segs, labels))
            losses.append(float(loss))
        t.end_pass()
        path = os.path.join(tmp_path, f"delta_{fail}.npz")
        t.save_delta(path)
        with np.load(path) as z:
            delta = {name: z[name] for name in z.files}
        worlds.append((w, staged, losses, backing_rows(t), delta))
    (w0, st0, l0, rows0, d0), (w1, st1, l1, rows1, d1) = worlds
    assert w0 == w1 > 0
    for a, b in zip(st0, st1):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(l0, l1)
    assert_rows_equal(rows0, rows1)
    assert sorted(d0) == sorted(d1) and d0["keys"].size > 0
    for name in d0:
        np.testing.assert_array_equal(d0[name], d1[name])


def test_refusals(monkeypatch):
    """Nothing is refused now. The mesh-sharded tiered table (ROADMAP
    A.9b3) builds; the low-precision arenas, once refused here, build
    (``tests/test_torch_tiered_arenas.py`` holds them to the reference); a
    variable arena without a backing raises the host table's
    ``ValueError``, as the reference's does. The disk tier, admission,
    staging buckets and the deferred demote build
    (``tests/test_torch_disk_tier.py``)."""
    conf = TableConfig(**TABLE)
    for dtype in (torch.int8, torch.bfloat16):
        t = TieredDeviceTable(conf, capacity=64, device="cpu",
                              value_dtype=dtype)
        assert t.values.dtype == dtype and t.layout.stats_in_state
    with pytest.raises(ValueError, match="variable_embedding"):
        TieredDeviceTable(dataclasses.replace(
            conf, expand_dim=2, variable_embedding=True), capacity=64,
            device="cpu")
    ported = TieredDeviceTable(
        conf, capacity=64, device="cpu",
        stage_buckets=BucketSpec(min_size=512))
    assert ported._stage_buckets == BucketSpec(min_size=512)
    for flag in ("ps_admit_shows", "ps_tier_demote"):
        monkeypatch.setenv(f"PBOX_FLAGS_{flag}", "1")
        t = TieredDeviceTable(conf, capacity=64, device="cpu")
        assert (t._admit is not None) == (flag == "ps_admit_shows")
        monkeypatch.delenv(f"PBOX_FLAGS_{flag}")
    # the tiered table over a mesh builds (tests/test_torch_multihost.py
    # holds it to the reference), its shards empty until a pass stages
    sharded = TieredShardedDeviceTable(conf, make_mesh(2, device="cpu"),
                                       capacity_per_shard=64,
                                       backend="numpy")
    assert isinstance(sharded, ShardedDeviceTable) and not sharded.in_pass
    assert sharded.shard_sizes() == [0, 0] and len(sharded) == 0
    monkeypatch.setenv("PBOX_FLAGS_ps_admit_shows", "0.0")
    t = TieredDeviceTable(conf, capacity=64, device="cpu",
                          backing=EmbeddingTable(conf, backend="numpy"))
    assert isinstance(t, DeviceTable) and t.backing.backend == "numpy"
    assert t.backing_bytes() == t.backing.memory_bytes() > 0


# -- across the packages ------------------------------------------------------

def ref_train(jt, batches, passes, device_prep, params, opt, pass_keys=None):
    fs = JaxStep(FlaxDeepFM(hidden=HIDDEN), jt, JaxTrainerConfig(), B, S,
                 device_prep=device_prep)
    entry = fs.step_device if device_prep else fs
    st = [params, opt, fs.init_auc_state()]
    per = len(batches) // passes
    keys_of = pass_keys or (lambda ch: np.concatenate([b[0] for b in ch]))
    losses, staged = [], []
    for p in range(passes):
        chunk = batches[p * per:(p + 1) * per]
        w = jt.begin_feed_pass(keys_of(chunk))
        staged.append((np.asarray(jt.values)[1:w + 1].copy(),
                       np.asarray(jt.state)[1:w + 1].copy()))
        for keys, segs, labels in chunk:
            *st[:3], loss, _ = entry(*st, keys, *step_args(segs, labels))
            losses.append(float(loss))
        jt.end_pass()
    return np.array(losses), staged


def port_train_staged(pt, batches, passes, device_prep, model,
                      pass_keys=None):
    fs, st = port_step(pt, device_prep, model)
    entry = fs.step_device if device_prep else fs
    per = len(batches) // passes
    keys_of = pass_keys or (lambda ch: np.concatenate([b[0] for b in ch]))
    losses, staged = [], []
    for p in range(passes):
        chunk = batches[p * per:(p + 1) * per]
        w = pt.begin_feed_pass(keys_of(chunk))
        staged.append((pt.values[1:w + 1].numpy().copy(),
                       pt.state[1:w + 1].numpy().copy()))
        for keys, segs, labels in chunk:
            *st[:3], loss, _ = entry(*st, keys, *step_args(segs, labels))
            losses.append(float(loss))
        pt.end_pass()
    return np.array(losses), staged


def both_packages(engine, optimizer, batches, passes, pass_keys=None):
    kw = dict(TABLE, optimizer=optimizer, show_clk_decay=0.95)
    ekw = NATIVE if engine == "device" else dict(backend="numpy")
    jt = JaxTiered(JaxTableConfig(**kw), capacity=1 << 10, **ekw)
    jfs = JaxStep(FlaxDeepFM(hidden=HIDDEN), jt, JaxTrainerConfig(), B, S)
    jp, jo = jfs.init(jax.random.PRNGKey(11))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)]
    dp = engine == "device"
    ref = ref_train(jt, batches, passes, dp, jp, jo, pass_keys)
    pt = TieredDeviceTable(TableConfig(**kw), capacity=1 << 10, device="cpu",
                           **ekw)
    port = port_train_staged(pt, batches, passes, dp,
                             deepfm_from_flax_leaves(leaves, HIDDEN),
                             pass_keys)
    bt = jt.backing
    order = np.argsort(bt._index.dump_keys(bt._size))
    want = (bt._index.dump_keys(bt._size)[order], bt._values[:bt._size][
        order], bt._state[:bt._size][order], bt._embedx_ok[:bt._size][order])
    return ref, port, want, backing_rows(pt)


@pytest.mark.parametrize("optimizer", ["adagrad", "adam"])
@pytest.mark.parametrize("engine", ["host", "device"])
def test_matches_reference_tiered_table(engine, optimizer):
    """4 passes of 2 batches, each pass's keys staged: staged rows bit for
    bit, losses rtol 1e-5, the backing by key (show/clk exact, the rest
    within 1e-5)."""
    batches = synth_batches(6, 8, 700)
    (rl, rstaged), (pl, pstaged), want, got = both_packages(
        engine, optimizer, batches, 4)
    np.testing.assert_allclose(pl, rl, rtol=1e-5)
    # pass 1 stages fresh rows: bit for bit; later passes carry training
    for a, b in zip(pstaged[0], rstaged[0]):
        np.testing.assert_array_equal(a, b)
    for (pv, ps), (rv, rs) in zip(pstaged, rstaged):
        np.testing.assert_array_equal(pv[:, :2], rv[:, :2])
        np.testing.assert_allclose(pv, rv, rtol=0, atol=1e-5)
        np.testing.assert_allclose(ps, rs, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1][:, :2], want[1][:, :2])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[3], want[3])


def test_mid_pass_keys_match_reference_by_key_set():
    """Keys that come mid-pass without being staged take arena rows past W
    (their init differs between the packages) and join the backing at
    writeback: the staged rows of pass 1 bit for bit, the backing's keys
    and show/clk exact."""
    batches = synth_batches(8, 8, 500)
    only_low = lambda ch: np.concatenate([b[0][b[0] < 300] for b in ch])
    (rl, rstaged), (pl, pstaged), want, got = both_packages(
        "host", "adagrad", batches, 4, pass_keys=only_low)
    for a, b in zip(pstaged[0], rstaged[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0], want[0])
    assert (got[0] >= 300).sum() > 100
    np.testing.assert_array_equal(got[1][:, :2], want[1][:, :2])
    np.testing.assert_allclose(pl, rl, rtol=1e-2)
