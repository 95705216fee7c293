"""The port's ``FusedShardedTrainStep`` (``paddlebox_tpu_torch/parallel/
fused_dp_step.py``) on ``make_mesh(ndev, device="cpu")`` (every kernel's
plain version) against the reference's on the JAX package's CPU mesh, from
the same flax params and arenas: both engines (host plan and device prep)
at ndev 2 and 8; a one-shard mesh against the port's ``FusedTrainStep``;
the chunked stream against the per-batch entries (a short tail, mixed key
buckets); request-bucket overflow to null and the req_cap actuator's
recovery; the miss ring and deferred insert; ``CTRTrainer(mesh=)`` against
the reference trainer; the segment merge's plain version against
``np.add.at``; the trainer's refusals, the reference's own.

Tolerances: per-step loss rtol 1e-5; rows by key show/clk exact, the rest
atol 1e-5 (float32 sums in another order: the reference's psum over eight
devices, its segment sums); the AUC counts exact. The stream against the
per-batch entries, and the merge against ``np.add.at``, bit for bit."""

import copy
import warnings

import jax
import numpy as np
import pytest
import torch

from conftest import make_slot_file
from paddlebox_tpu.config import DataFeedConfig as JaxFeedConfig
from paddlebox_tpu.config import SlotConfig as JaxSlotConfig
from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.config import TrainerConfig as JaxTrainerConfig
from paddlebox_tpu.data.dataset import SlotDataset as JaxSlotDataset
from paddlebox_tpu.models import WideDeep as FlaxWideDeep
from paddlebox_tpu.parallel import make_mesh as jax_make_mesh
from paddlebox_tpu.ps import native as ref_native
from paddlebox_tpu.trainer.trainer import CTRTrainer as JaxTrainer
from paddlebox_tpu_torch.config import (DataFeedConfig, SlotConfig,
                                        TableConfig, TrainerConfig)
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.models import DeepFM, WideDeep
from paddlebox_tpu_torch.models.convert import widedeep_from_flax_leaves
from paddlebox_tpu_torch.ops.sparse_push import (merge_order,
                                                 segment_merge,
                                                 segment_merge_cuda,
                                                 segment_merge_plain)
from paddlebox_tpu_torch.parallel.fused_dp_step import FusedShardedTrainStep
from paddlebox_tpu_torch.parallel.mesh import make_mesh
from paddlebox_tpu_torch.ps import native
from paddlebox_tpu_torch.ps.device_table import DeviceTable
from paddlebox_tpu_torch.ps.sharded_device_table import ShardedDeviceTable
from paddlebox_tpu_torch.trainer.fused_step import FusedTrainStep
from paddlebox_tpu_torch.trainer.trainer import CTRTrainer
from torch_mesh_worlds import (HIDDEN, TABLE, assert_tables_match,
                               make_batch, rows_by_key, step_both, worlds)

B, S, NPAD = 8, 4, 128


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def need_native():
    if not (native.available() and ref_native.available()):
        pytest.skip("the native index core does not build here")


@pytest.mark.parametrize("engine", ["host_plan", "device_prep"])
@pytest.mark.parametrize("ndev", [2, 8])
def test_engines_match_reference(ndev, engine):
    """8 steps with new keys each, over random arenas: losses, rows by
    key and the AUC state against the reference's."""
    dp = engine == "device_prep"
    ref, port = worlds(ndev, dp, B, S, table_kw=dict(initial_range=0.05))
    rng = np.random.default_rng(ndev)
    for step in range(8):
        args = make_batch(rng, ndev, B, S, NPAD, 300 + 100 * step)
        jl, pl = step_both(ref, port, args, dp)
        np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert_tables_match(ref[1], port[1])
    pa, ja = port[2][2], ref[2][2]
    for f in ("count", "label_sum"):
        assert float(pa[f]) == float(np.asarray(ja[f]))
    for f in ("pos", "neg"):
        assert float(pa[f].sum()) == float(np.asarray(ja[f]).sum())
    np.testing.assert_allclose(float(pa["pred_sum"]),
                               float(np.asarray(ja["pred_sum"])), rtol=1e-5)


def one_shard_worlds(dp):
    conf = TableConfig(**dict(TABLE, initial_range=0.05))
    model = DeepFM(S * 7, HIDDEN)
    single = DeviceTable(conf, capacity=2048, device="cpu", backend="native",
                         index_threads=1)
    fs = FusedTrainStep(model, single, TrainerConfig(dense_learning_rate=1e-2),
                        B, S, device_prep=dp)
    sharded = ShardedDeviceTable(conf, make_mesh(1, device="cpu"),
                                 capacity_per_shard=2048, backend="native")
    ms = FusedShardedTrainStep(copy.deepcopy(model), sharded,
                               TrainerConfig(dense_learning_rate=1e-2), B, S,
                               device_prep=dp)
    torch.testing.assert_close(sharded.values[0], single.values, rtol=0,
                               atol=0)
    return (fs, single, [*fs.init(), fs.init_auc_state()]), \
        (ms, sharded, [*ms.init(), ms.init_auc_state()])


@pytest.mark.parametrize("engine", ["host_plan", "device_prep"])
def test_one_shard_matches_fused_train_step(engine):
    """A one-shard mesh computes the single-device step: losses, preds,
    dense params and rows by key within 1e-5 of ``FusedTrainStep``'s over
    the same arena and weights."""
    dp = engine == "device_prep"
    (fs, single, fst), (ms, sharded, mst) = one_shard_worlds(dp)
    rng = np.random.default_rng(5)
    for step in range(6):
        keys, segs, cvm, labels, dense, mask = make_batch(
            rng, 1, B, S, NPAD, 200 + 50 * step)
        if dp:
            *fst[:], fl, fp = fs.step_device(*fst, keys[0], segs[0], cvm[0],
                                             labels[0], dense[0], mask[0])
            *mst[:], ml, mp = ms.step_device(*mst, keys, segs, cvm, labels,
                                             dense, mask)
        else:
            *fst[:], fl, fp = fs(*fst, keys[0], segs[0], cvm[0], labels[0],
                                 dense[0], mask[0])
            *mst[:], ml, mp = ms(*mst, sharded.prepare_batch(keys), segs,
                                 cvm, labels, dense, mask)
        np.testing.assert_allclose(float(ml), float(fl), rtol=1e-5)
        np.testing.assert_allclose(mp[0].numpy(), fp.numpy(), atol=1e-6)
    for a, b in zip(mst[0].parameters(), fst[0].parameters()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    fk, fv, fst_ = rows_by_key(single.snapshot())
    mk, mv, mst_ = rows_by_key(sharded.snapshot())
    np.testing.assert_array_equal(mk, fk)
    np.testing.assert_array_equal(mv[:, :2], fv[:, :2])
    np.testing.assert_allclose(mv, fv, rtol=0, atol=1e-5)
    np.testing.assert_allclose(mst_, fst_, rtol=0, atol=1e-5)


def port_world(ndev, dp, **kw):
    """The port's engine alone, its weights from a seeded torch init."""
    torch.manual_seed(0)
    t = ShardedDeviceTable(TableConfig(**TABLE),
                           make_mesh(ndev, device="cpu"),
                           capacity_per_shard=4096, backend="native")
    step = FusedShardedTrainStep(WideDeep(S * 7, HIDDEN), t,
                                 TrainerConfig(dense_learning_rate=1e-2), B,
                                 S, device_prep=dp, **kw)
    return step, t, [*step.init(), step.init_auc_state()]


def stream_batches(seed, ndev, n, npads=None):
    rng = np.random.default_rng(seed)
    npads = npads or [NPAD] * n
    return [make_batch(rng, ndev, B, S, p, 500) for p in npads]


def run_per_batch(port, batches, dp):
    """The per-batch entries over ``batches``; returns the losses."""
    ps, pt, st = port
    losses = []
    for args in batches:
        if dp:
            *st[:], loss, _ = ps.step_device(*st, *args)
        else:
            *st[:], loss, _ = ps(*st, pt.prepare_batch(args[0]), *args[1:])
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("case", ["full_runs", "short_tail",
                                  "mixed_buckets"])
@pytest.mark.parametrize("engine", ["host_plan", "device_prep"])
def test_chunked_stream_matches_per_batch(engine, case):
    """train_stream (runs of ``chunk`` same-shape batches) equals the
    per-batch entries bit for bit: each step's loss (``on_step``), the
    arenas, the dense params; a stream shorter than a run and a key-bucket change mid-stream
    go through too (the reference's ``TestChunkedMeshStream``)."""
    dp = engine == "device_prep"
    ndev = 2
    npads, chunk = {"full_runs": ([NPAD] * 8, 4),
                    "short_tail": ([NPAD] * 3, 8),
                    "mixed_buckets": ([64] * 5 + [128] * 4 + [64] * 2,
                                      4)}[case]
    batches = stream_batches(3, ndev, len(npads), npads)
    a = port_world(ndev, dp)
    want = run_per_batch(a, batches, dp)
    b = port_world(ndev, dp)
    ps, pt, st = b
    got = []
    *st[:], loss, steps = ps.train_stream(
        *st, iter(batches), chunk=chunk,
        on_step=lambda i, l: got.append((i, float(l))))
    assert steps == len(batches)
    assert float(loss) == want[-1]
    assert got == list(enumerate(want, 1))
    assert a[1]._sizes == pt._sizes
    for s in range(ndev):
        torch.testing.assert_close(pt.values[s], a[1].values[s], rtol=0,
                                   atol=0)
        torch.testing.assert_close(pt.state[s], a[1].state[s], rtol=0,
                                   atol=0)
    for x, y in zip(st[0].parameters(), a[2][0].parameters()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    *st[:], loss, steps = ps.train_stream(*st, iter([]))
    assert loss is None and steps == 0


def test_skewed_ownership_overflows_to_null_as_reference():
    """Every key owned by shard 0 and req_cap 16: keys past the bucket
    route to null this step (zero pull, grads dropped), the overflow count
    and the losses equal the reference's, nothing misses, and only shard 0
    fills."""
    ndev = 8
    ref, port = worlds(ndev, True, B, S, req_cap=16)
    rng = np.random.default_rng(9)
    for _ in range(2):
        args = make_batch(rng, ndev, B, S, NPAD, 5000, skew_owner=0)
        jl, pl = step_both(ref, port, args, True)
        np.testing.assert_allclose(pl, jl, rtol=1e-5)
    want = ref[1].poll_misses()
    got = port[1].poll_misses()
    assert got == tuple(want) and got[0] == 0 and got[1] > 0
    sizes = port[1].shard_sizes()
    assert sizes[0] > 0 and sum(sizes[1:]) == 0
    assert_tables_match(ref[1], port[1])


def test_sustained_skew_recovers_via_req_cap_boost():
    """The overflow actuator: a stream whose keys all hash to one shard
    overflows the small buckets every run; the cadenced poll surfaces
    ``overflow_total``, the engine warns and doubles R, and at the boosted
    R a fresh skewed batch overflows nothing."""
    ndev = 8
    ps, pt, st = port_world(ndev, True, req_cap=16, overflow_poll_chunks=1)
    rng = np.random.default_rng(21)
    batches = [make_batch(rng, ndev, B, S, NPAD, 5000, skew_owner=0)
               for _ in range(16)]
    with pytest.warns(RuntimeWarning, match="req_cap"):
        *st[:], loss, steps = ps.train_stream(*st, iter(batches), chunk=2)
    assert steps == 16 and np.isfinite(float(loss))
    assert pt.overflow_total > 0
    assert pt.stats()["overflow_total"] == pt.overflow_total
    assert ps.stats()["req_boost"] >= 8
    pt.poll_misses()
    before = pt.overflow_total
    args = make_batch(rng, ndev, B, S, NPAD, 5000, skew_owner=0)
    *st[:], loss, _ = ps.step_device(*st, *args)
    assert np.isfinite(float(loss))
    assert pt.poll_misses() == (0, 0) and pt.overflow_total == before
    # clean polls decay the boost again
    boost = ps._req_boost
    for _ in range(ps.boost_decay_polls):
        ps._overflow_check()
    assert ps._req_boost == boost // 2


def test_miss_ring_catches_uninserted_keys():
    """Without the host insert, unresolved keys ride the null row and land
    in their owners' rings; the drain inserts every one."""
    ndev = 8
    ps, pt, st = port_world(ndev, True)
    args = make_batch(np.random.default_rng(3), ndev, B, S, 64, 400)
    real = pt.ensure_keys
    pt.ensure_keys = lambda keys: 0
    try:
        *st[:], loss, _ = ps.step_device(*st, *args)
    finally:
        pt.ensure_keys = real
    assert np.isfinite(float(loss)) and len(pt) == 0
    uniq = np.unique(args[0][args[0] != 0])
    drained, overflow = pt.poll_misses()
    assert (drained, overflow) == (uniq.size, 0)
    assert len(pt) == uniq.size
    assert pt.poll_misses() == (0, 0)


def test_deferred_insert_matches_reference():
    """``insert_mode="deferred"``: new keys ride null rows, report through
    the rings, and the lagged drain inserts them so their next occurrence
    trains; losses and rows by key as the reference's, every key in its
    owner's index after the stream's final poll."""
    ndev = 2
    ref, port = worlds(ndev, True, B, S, insert_mode="deferred")
    rng = np.random.default_rng(7)
    pool_a = np.arange(1, 301, dtype=np.uint64)
    pool_b = np.arange(301, 601, dtype=np.uint64)

    def mk(pool):
        b = make_batch(rng, ndev, B, S, 64, 2)
        keys = b[0].copy()
        live = keys != 0
        keys[live] = rng.choice(pool, size=int(live.sum()))
        return (keys,) + b[1:]

    batches = ([mk(pool_a) for _ in range(2)]
               + [mk(np.concatenate([pool_a, pool_b])) for _ in range(4)])
    (js, jt, jst), (ps, pt, pst) = ref, port
    *jst[:], jl, _ = js.train_stream(*jst, iter(batches), chunk=2)
    *pst[:], pl, steps = ps.train_stream(*pst, iter(batches), chunk=2)
    assert steps == 6
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    seen = np.unique(np.concatenate([b[0] for b in batches]))
    seen = seen[seen != 0]
    assert len(pt) == seen.size
    # later occurrences trained: the device dirty bits are the reference's
    jbits = np.asarray(jt.dirty_dev)
    marked = [int(bits[:n].sum()) for bits, n in zip(pt.dirty_dev, pt._sizes)]
    assert marked == [int(jbits[s, :n].sum())
                      for s, n in enumerate(pt._sizes)]
    assert sum(marked) > 50
    assert_tables_match(jt, pt)


def feed_confs():
    def conf(fc, sc):
        return fc(slots=[sc("label", type="float", is_dense=True, dim=1),
                         sc("slot_a"), sc("slot_b"), sc("slot_c"),
                         sc("dense_x", type="float", is_dense=True, dim=3)],
                  batch_size=8, label_slot="label", thread_num=2)
    return conf(JaxFeedConfig, JaxSlotConfig), conf(DataFeedConfig,
                                                    SlotConfig)


def test_trainer_over_mesh_matches_reference(tmp_path):
    """``CTRTrainer(mesh=)`` on 2 shards against the reference trainer on
    the same files: 3 passes' metrics (``ins_num`` exact, the AUC within
    1e-6), ``evaluate``, the table by key; then its save loads into a
    fresh mesh trainer's table, and its delta into a ``DeviceTable``."""
    ndev = 2
    jconf, pconf = feed_confs()
    files = [make_slot_file(str(tmp_path / f"part-{i}"), jconf, 64, seed=i)
             for i in range(2)]
    jds = JaxSlotDataset(jconf)
    pds = SlotDataset(pconf)
    for ds in (jds, pds):
        ds.set_filelist(files)
        ds.load_into_memory()
    jtr = JaxTrainer(FlaxWideDeep(hidden=HIDDEN), jconf,
                     JaxTableConfig(**TABLE), JaxTrainerConfig(),
                     mesh=jax_make_mesh(ndev), device_capacity=2048)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jtr.params)]
    ptr = CTRTrainer(widedeep_from_flax_leaves(leaves, HIDDEN), pconf,
                     TableConfig(**TABLE), TrainerConfig(),
                     mesh=make_mesh(ndev, device="cpu"),
                     device_capacity=2048)
    assert isinstance(ptr.table, ShardedDeviceTable)
    assert ptr.step.device_prep == jtr.step.device_prep
    for _ in range(3):
        for tr in (jtr, ptr):
            tr.reset_metrics()
        jm, pm = jtr.train_from_dataset(jds), ptr.train_from_dataset(pds)
        assert pm["ins_num"] == jm["ins_num"] == 128.0
        assert abs(pm["auc"] - jm["auc"]) < 1e-6
    assert pm["auc"] > 0.8
    assert ptr.last_heartbeat["steps"] == 16
    je, pe = jtr.evaluate(jds), ptr.evaluate(pds)
    assert pe["ins_num"] == je["ins_num"] == 128.0
    assert abs(pe["auc"] - je["auc"]) < 1e-6
    assert_tables_match(jtr.table, ptr.table)
    # a fetch handler takes the per-batch path: the same numbers
    got = []
    ptr.train_from_dataset(pds, fetch_handler=lambda i, loss, p: got.append(
        (loss, p.shape)))
    assert len(got) == 16 and got[0][1] == (8, 1)
    base = str(tmp_path / "base.npz")
    ptr.table.save(base)
    assert ptr.table.save_delta(str(tmp_path / "d.npz")) == 0
    ptr.train_from_dataset(pds)
    n = ptr.table.save_delta(str(tmp_path / "d.npz"))
    assert 0 < n <= len(ptr.table)
    fresh = CTRTrainer(DeepFM(3 * 7 + 3, (8,)), pconf, TableConfig(**TABLE),
                       TrainerConfig(), mesh=make_mesh(ndev, device="cpu"),
                       device_capacity=64)
    fresh.table.load(base)
    bk, bv, _ = rows_by_key(dict(np.load(base)))
    k, v, _ = rows_by_key(fresh.table.snapshot())
    np.testing.assert_array_equal(k, bk)
    np.testing.assert_array_equal(v, bv)
    single = DeviceTable(TableConfig(**TABLE), capacity=64, device="cpu")
    single.load_delta(str(tmp_path / "d.npz"))
    assert len(single) == n


@pytest.mark.parametrize("n,n_seg", [(0, 5), (1, 1), (64, 64), (500, 7),
                                     (3000, 2000)])
def test_segment_merge_plain_matches_add_at(n, n_seg):
    """The merge's plain version, ``np.add.at``'s bits: each segment's
    sum in key order from 0, empty segments zero, keys of segment n_seg
    dropped (as ``jax.ops.segment_sum`` drops ids past its segments); CPU
    tensors never reach the kernel's wrapper."""
    rng = np.random.default_rng(n)
    seg = rng.integers(0, n_seg + 1, size=n).astype(np.int32)
    seg[:n // 3] = 0          # one long segment
    seg[seg == n_seg - 1] = 0  # one empty (or all at 0)
    demb = rng.normal(size=(n, 11)).astype(np.float32)
    want = np.zeros((n_seg + 1, 11), np.float32)
    np.add.at(want, seg, demb)
    want = want[:n_seg]
    got = segment_merge(torch.from_numpy(demb), torch.from_numpy(seg), n_seg)
    np.testing.assert_array_equal(got.numpy(), want)
    order, offsets = merge_order(torch.from_numpy(seg), n_seg + 1)
    np.testing.assert_array_equal(
        segment_merge_plain(torch.from_numpy(demb), order,
                            offsets[:n_seg + 1]).numpy(), want)
    with pytest.raises(ValueError, match="CUDA"):
        segment_merge_cuda(torch.from_numpy(demb), order, offsets)
    assert segment_merge_cuda.launches == 0


@pytest.mark.parametrize("ndev,R,case", [(1, 257, "padded"),
                                         (2, 16, "overflow"),
                                         (4, 128, "no_padding"),
                                         (2, 128, "hot")])
def test_device_prep_merge_matches_position_merge(ndev, R, case):
    """Device prep's requester merge, by unique over K5's order with key
    0's segment emptied (``_merge_routed``), equals the merge by request
    position (``_merge_requests``) bit for bit: with padding (key 0), with
    uniques past a small R routed to null, with no key 0 at all, and with
    a key repeated past the short kernel's 32; keys with the high bit set
    among them (K5 sorts them as unsigned, after key 0)."""
    rng = np.random.default_rng(R + ndev)
    table = ShardedDeviceTable(TableConfig(**TABLE),
                               make_mesh(ndev, device="cpu"),
                               capacity_per_shard=64)
    step = FusedShardedTrainStep(DeepFM(3 * 7 + 3, (8,)), table,
                                 TrainerConfig(), batch_size=B, num_slots=3,
                                 device_prep=True)
    npad = 256
    n = npad if case == "no_padding" else 200
    keys = np.zeros(npad, np.uint64)
    keys[:n] = rng.integers(1, 1 << 62, size=n).astype(np.uint64) | \
        (rng.integers(0, 2, size=n).astype(np.uint64) << np.uint64(63))
    keys[:n] = keys[rng.integers(0, n, size=n)]  # repeats
    if case == "hot":
        keys[rng.permutation(n)[:80]] = keys[0]
    keys_t = torch.from_numpy(keys.view(np.int64))
    _, seg, n_over, dd, flat = step._route(keys_t, R)
    assert (int(n_over) > 0) == (case == "overflow")
    demb = torch.from_numpy(rng.normal(size=(npad, 7)).astype(np.float32))
    got = step._merge_routed(demb, dd, flat, R)
    want = step._merge_requests(demb, seg, R)
    assert torch.equal(got, want)
    order, offsets = step._unique_merge_order(dd)
    lens = offsets[1:] - offsets[:-1]
    if case == "hot":
        assert int(lens.max()) > 32
    # key 0's padding merged nowhere: segment 0 is empty where it is key 0
    assert (int(lens[0]) == 0) == (case != "no_padding")
    assert order is dd.order


def _trainer(**kw):
    jconf, pconf = feed_confs()
    kw.setdefault("mesh", make_mesh(2, device="cpu"))
    return CTRTrainer(DeepFM(3 * 7 + 3, (8,)), pconf, TableConfig(**TABLE),
                      kw.pop("trainer_conf", TrainerConfig()), **kw)


@pytest.mark.parametrize("what,exc,match", [
    ("device_table", ValueError, "single-chip"),
    ("sharded_without_mesh", ValueError, "needs its mesh"),
    ("train_from_files", ValueError, "mesh"),
    ("batch_size", ValueError, "not divisible"),
])
def test_trainer_refusals(what, exc, match):
    """The reference's own refusals of the mesh trainer (a single-chip
    table, a sharded table without its mesh, files, a batch the shards
    cannot split evenly among them). The multi-host options once refused
    here train (tests/test_torch_multihost.py)."""
    build = {
        "device_table": lambda: _trainer(table=DeviceTable(
            TableConfig(**TABLE), capacity=64, device="cpu")),
        "sharded_without_mesh": lambda: _trainer(
            mesh=None, table=ShardedDeviceTable(
                TableConfig(**TABLE), make_mesh(2, device="cpu"))),
        "train_from_files": lambda: _trainer().train_from_files(["x"]),
        "batch_size": lambda: _trainer(mesh=make_mesh(3, device="cpu")),
    }[what]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(exc, match=match):
            build()


@pytest.mark.parametrize("what", ["host_table", "dense_sync_steps",
                                  "embedding_table"])
def test_trainer_builds_the_host_table_mesh_engine(what):
    """A host table over a mesh (``use_device_table=False``, a host table,
    or ``dense_sync_steps`` > 0, which the reference trains on the host
    table) builds ``ShardedTrainStep`` (test_torch_trainer_mesh.py holds
    it to the reference)."""
    from paddlebox_tpu_torch.parallel.dp_step import ShardedTrainStep
    from paddlebox_tpu_torch.ps.table import EmbeddingTable
    tr = {"host_table": lambda: _trainer(use_device_table=False),
          "dense_sync_steps": lambda: _trainer(
              trainer_conf=TrainerConfig(dense_sync_steps=4)),
          "embedding_table": lambda: _trainer(
              table=EmbeddingTable(TableConfig(**TABLE)))}[what]()
    assert isinstance(tr.step, ShardedTrainStep) and not tr.fused
    assert isinstance(tr.table, EmbeddingTable)
    assert tr.step.k_sync == (4 if what == "dense_sync_steps" else 0)
    assert int(tr._step_counter) == 0
