"""The port's multi-host layer against the reference's, ranks as threads:
``TieredShardedDeviceTable`` in one process over 3 passes, and its saves
and loads; a ``TieredDeviceTable`` over a ``DistributedTable``; two ranks
of 4
CPU shards each over a ``DistributedTable`` (the reference's
``tests/test_multihost_multichip.py`` loop: SGD, the dense params averaged
every step, ``sparse_grad_scale = 1/2``, writeback "delta") against the
reference's two ranks and against the port's one process over an 8-shard
mesh on the union of the data (ROADMAP C.6); the chunked stream's
``sync_hook`` against the per-batch LocalSGD-k loop; ``CTRTrainer(mesh=,
table=TieredShardedDeviceTable(DistributedTable), dense_sync_hook=)`` and
``CTRTrainer(table=DistributedTable, use_device_table=False)`` against the
reference's trainers; the reference's mesh step's dense step against the
port's at 1, 2 and 4 devices (C.6's cause).

Tolerances: rows by key, show/clk exact and the rest within 1e-5 (the
fused-sharded tolerance); losses within rtol 1e-5; the chunked stream
against its oracle bit for bit.

The reference's mesh step takes ``ndev`` times the mean dense gradient
(ROADMAP C.6): its ranks over 4 shards are held against the port's ranks
at 4 times the reference's dense learning rate, the reference's own SGD
step; its 1-shard trainers need no factor."""

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
from paddlebox_tpu.models import DeepFM as FlaxDeepFM
from paddlebox_tpu.parallel import FusedShardedTrainStep as JaxShardedStep
from paddlebox_tpu.parallel import make_mesh as jax_make_mesh
from paddlebox_tpu.ps import native as ref_native
from paddlebox_tpu.ps.distributed import DistributedTable as JaxDistTable
from paddlebox_tpu.ps.sharded_device_table import \
    ShardedDeviceTable as JaxShardedTable
from paddlebox_tpu.ps.tiered_table import \
    TieredShardedDeviceTable as JaxTieredSharded
from paddlebox_tpu.trainer.trainer import CTRTrainer as JaxTrainer
from paddlebox_tpu_torch.config import (DataFeedConfig, SlotConfig,
                                        TableConfig, TrainerConfig)
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.models.convert import (deepfm_from_flax_leaves,
                                                flax_leaves_from_model,
                                                widedeep_from_flax_leaves)
from paddlebox_tpu_torch.parallel.coordinator import dense_mean_hook
from paddlebox_tpu_torch.parallel.fused_dp_step import FusedShardedTrainStep
from paddlebox_tpu_torch.parallel.mesh import make_mesh
from paddlebox_tpu_torch.ps import native
from paddlebox_tpu_torch.ps.distributed import DistributedTable
from paddlebox_tpu_torch.ps.sharded_device_table import ShardedDeviceTable
from paddlebox_tpu_torch.ps.tiered_table import TieredShardedDeviceTable
from paddlebox_tpu_torch.trainer.trainer import CTRTrainer
from test_multihost_multichip import (BL, NDEV, PASSES, S, STEPS_PER_PASS,
                                      WORLD, sync_params_mean)
from torch_coord_world import run_ranks, world
from torch_mesh_worlds import carry_arenas, make_batch
from torch_multihost_worlds import (HIDDEN, SGD, TABLE, assert_rows_close,
                                    data, flax_leaves, local_rows,
                                    port_ranks, ref_ranks)

ENGINES = {"host_plan": (False, "ensure"), "device_prep": (True, "ensure"),
           "deferred": (True, "deferred")}


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


def by_key(snap):
    order = np.argsort(snap["keys"])
    return snap["keys"][order], snap["values"][order], snap["state"][order]


# -- one process --------------------------------------------------------------

@pytest.mark.parametrize("engine,mode", [("device_prep", "set"),
                                         ("host_plan", "delta")])
def test_tiered_sharded_matches_reference(engine, mode):
    """3 passes of 4 batches over a 2-shard mesh, each pass's keys a
    range of their own (a stale mirror would resolve an old key to a
    reused row), staged by ``begin_feed_pass``, trained through the
    chunked stream, written back: each pass's loss, its writeback count
    and every key's row in the backing against the reference's; the
    mirror rebuilt over each pass's indexes, no ring miss."""
    ndev, B, Sl, npad = 2, 8, 4, 128
    dp = engine == "device_prep"
    kw = dict(embedx_dim=4, cvm_offset=3, embedx_threshold=0.0,
              initial_range=0.0, learning_rate=0.1, seed=3)
    jt = JaxTieredSharded(JaxTableConfig(**kw), jax_make_mesh(ndev),
                          capacity_per_shard=2048, backend="native",
                          writeback_mode=mode)
    js = JaxShardedStep(FlaxWideDeep(hidden=HIDDEN), jt,
                        JaxTrainerConfig(dense_learning_rate=1e-2),
                        batch_size=B, num_slots=Sl, device_prep=dp)
    jp, jo = js.init(jax.random.PRNGKey(0))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)]
    pt = TieredShardedDeviceTable(TableConfig(**kw),
                                  make_mesh(ndev, device="cpu"),
                                  capacity_per_shard=2048, backend="native",
                                  writeback_mode=mode)
    ps = FusedShardedTrainStep(widedeep_from_flax_leaves(leaves, HIDDEN), pt,
                               TrainerConfig(dense_learning_rate=1e-2),
                               batch_size=B, num_slots=Sl, device_prep=dp)
    jst = [jp, jo, js.init_auc_state()]
    pst = [*ps.init(), ps.init_auc_state()]
    rng = np.random.default_rng(8)
    mirrors = set()
    for pi in range(3):
        batches = []
        for _ in range(4):
            b = make_batch(rng, ndev, B, Sl, npad, 3000)
            keys = b[0].copy()
            keys[keys != 0] += np.uint64(pi * 10_000)
            batches.append((keys,) + b[1:])
        pass_keys = np.concatenate([b[0].ravel() for b in batches])
        w = pt.begin_feed_pass(pass_keys)
        assert w == jt.begin_feed_pass(pass_keys) > 0
        assert pt.shard_sizes() == [n - 1 for n in jt._sizes]
        if dp:
            mirrors.add(id(pt.mirror))
        *jst[:], jl, _ = js.train_stream(*jst, iter(batches), chunk=2)
        *pst[:], pl, steps = ps.train_stream(*pst, iter(batches), chunk=2)
        assert steps == 4
        np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
        wb = pt.writeback()
        assert wb == jt.writeback() > 0
        pt.end_pass()
        jt.end_pass()
        assert not pt.in_pass and pt.staged_keys is None
        assert len(pt) == len(jt.backing)
        assert_rows_close(by_key(pt.backing.snapshot(reset_dirty=False)),
                          by_key(jt.backing.snapshot(reset_dirty=False)))
    assert len(pt) > 1000
    if dp:
        assert len(mirrors) == 3 and pt.poll_misses()[0] == 0


# -- two ranks ----------------------------------------------------------------

@pytest.fixture(scope="module")
def rank_data():
    return data(1500, 11)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_two_ranks_match_reference(rank_data, engine):
    """The reference's two ranks (``train_rank``, ``sync_params_mean``)
    against the port's, each rank over its own half of the keys: every
    rank's losses, dense params and its shard of the PS by key."""
    dp, mode = ENGINES[engine]
    want = ref_ranks(rank_data, dp, mode)
    got = port_ranks(rank_data, dp, mode, lr_scale=NDEV)
    for (grows, gdense, gloss), (wrows, wdense, wloss) in zip(got, want):
        assert grows[0].size > 100
        assert_rows_close(grows, wrows)
        np.testing.assert_allclose(gloss, wloss, rtol=1e-5)
        for a, b in zip(gdense, wdense):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def one_process(batches, device_prep, insert_mode="ensure"):
    """The port's one process over an 8-shard mesh on the union of the
    ranks' data (each step the ranks' batches stacked): (rows by key,
    dense leaves, losses)."""
    conf = TableConfig(**TABLE)
    t = TieredShardedDeviceTable(conf, make_mesh(WORLD * NDEV, device="cpu"),
                                 capacity_per_shard=1 << 12)
    fs = FusedShardedTrainStep(deepfm_from_flax_leaves(flax_leaves(),
                                                       HIDDEN),
                               t, TrainerConfig(**SGD), batch_size=BL,
                               num_slots=S, device_prep=device_prep,
                               insert_mode=insert_mode)
    st = [*fs.init(), fs.init_auc_state()]
    per, losses = STEPS_PER_PASS, []
    for p in range(PASSES):
        chunks = [b[p * per:(p + 1) * per] for b in batches]
        t.begin_feed_pass(np.concatenate([x[0].ravel() for c in chunks
                                          for x in c]))
        for i in range(per):
            keys, segs, labels = (np.concatenate([c[i][j] for c in chunks])
                                  for j in range(3))
            n = keys.shape[0]
            args = (segs, np.stack([np.ones((n, BL), np.float32), labels],
                                   axis=2), labels,
                    np.zeros((n, BL, 0), np.float32),
                    np.ones((n, BL), np.float32))
            if device_prep:
                out = fs.step_device(*st, keys, *args)
            else:
                out = fs(*st, t.prepare_batch(keys), *args)
            st = list(out[:3])
            losses.append(float(out[3]))
        t.end_pass()
    return local_rows(t.backing), flax_leaves_from_model(st[0]), losses


@pytest.mark.parametrize("engine", ["host_plan", "device_prep"])
def test_two_ranks_match_one_process(rank_data, engine):
    """ROADMAP C.6: the port's two ranks of 4 shards against its one
    process of 8 shards over the union of the data (disjoint keys a rank,
    so the delta writeback is the trained row; SGD, so the mean of the
    ranks' steps is the global step): every key's row, the dense params
    and the mean of the ranks' losses, within float32 rounding (the delta
    writeback's, and the dense mean in float64 against the mesh's float32
    sum)."""
    dp, mode = ENGINES[engine]
    ranks = port_ranks(rank_data, dp, mode)
    rows, dense, losses = one_process(rank_data, dp, mode)
    merged = [np.concatenate([r[0][j] for r in ranks]) for j in range(3)]
    order = np.argsort(merged[0])
    assert_rows_close([m[order] for m in merged], rows)
    for r in ranks:
        for a, b in zip(r[1], dense):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        (np.asarray(ranks[0][2]) + np.asarray(ranks[1][2])) / 2, losses,
        rtol=1e-5)


@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_reference_mesh_step_scales_dense_by_ndev(ndev):
    """C.6's cause, pinned: one SGD step of the reference's
    ``FusedShardedTrainStep`` over ``ndev`` devices moves the dense params
    ``ndev`` times as far as the port's (the single-device step), from the
    same params, arenas and batch, at the same loss."""
    B, Sl = 8, 3
    jt = JaxShardedTable(JaxTableConfig(**TABLE), jax_make_mesh(ndev),
                         capacity_per_shard=4096, backend="numpy")
    js = JaxShardedStep(FlaxDeepFM(hidden=HIDDEN), jt,
                        JaxTrainerConfig(**SGD), batch_size=B, num_slots=Sl)
    jp, jo = js.init(jax.random.PRNGKey(0))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)]
    pt = ShardedDeviceTable(TableConfig(**TABLE),
                            make_mesh(ndev, device="cpu"),
                            capacity_per_shard=4096, backend="numpy")
    carry_arenas(jt, pt)
    ps = FusedShardedTrainStep(deepfm_from_flax_leaves(leaves, HIDDEN), pt,
                               TrainerConfig(**SGD), batch_size=B,
                               num_slots=Sl)
    args = make_batch(np.random.default_rng(0), ndev, B, Sl, 128, 300)
    jp, _, _, jl, _ = js(jp, jo, js.init_auc_state(),
                         jt.prepare_batch(args[0]), *args[1:])
    pp, _, _, pl, _ = ps(*ps.init(), ps.init_auc_state(),
                         pt.prepare_batch(args[0]), *args[1:])
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6)
    ref_move = np.concatenate([(np.asarray(a) - b).ravel() for a, b in zip(
        jax.tree_util.tree_leaves(jp), leaves)])
    port_move = np.concatenate([(a - b).ravel() for a, b in zip(
        flax_leaves_from_model(pp), leaves)])
    np.testing.assert_allclose(ref_move, ndev * port_move, rtol=0,
                               atol=2e-7 * ndev)
    assert np.abs(port_move).max() > 1e-3


K = 4   # the chunk and the sync period


def chunked_or_oracle(batches, device_prep, chunked):
    """Two ranks over 10 batches: ``train_stream(chunk=K, sync_hook=)``, or
    the per-batch entries with the dense mean every K steps (the tail of
    2 steps unsynced in both). Returns per rank (rows, dense leaves)."""
    conf = TableConfig(**TABLE)
    leaves = flax_leaves()

    def rank(r, coord):
        backing = DistributedTable(conf, coord)
        table = TieredShardedDeviceTable(
            conf, make_mesh(NDEV, device="cpu"), backing=backing,
            capacity_per_shard=1 << 12, writeback_mode="delta")
        fs = FusedShardedTrainStep(
            deepfm_from_flax_leaves(leaves, HIDDEN), table,
            TrainerConfig(**SGD), batch_size=BL, num_slots=S,
            sparse_grad_scale=1.0 / WORLD, device_prep=device_prep)
        hook = dense_mean_hook(coord)
        st = [*fs.init(), fs.init_auc_state()]
        table.begin_feed_pass(np.concatenate([b[0].ravel()
                                              for b in batches[r]]))
        tuples = [(keys, segs, np.stack([np.ones((NDEV, BL), np.float32),
                                         labels], axis=2), labels,
                   np.zeros((NDEV, BL, 0), np.float32),
                   np.ones((NDEV, BL), np.float32))
                  for keys, segs, labels in batches[r]]
        if chunked:
            *st[:], _loss, steps = fs.train_stream(*st, iter(tuples),
                                                   chunk=K, sync_hook=hook)
            assert steps == len(tuples)
        else:
            for i, args in enumerate(tuples):
                if device_prep:
                    out = fs.step_device(*st, *args)
                else:
                    out = fs(*st, table.prepare_batch(args[0]), *args[1:])
                st = list(out[:3])
                if (i + 1) % K == 0:
                    st[0] = hook(st[0])
        table.end_pass()
        return local_rows(backing.local), flax_leaves_from_model(st[0])

    return run_ranks(rank, world("port", WORLD))


@pytest.mark.parametrize("engine", ["host_plan", "device_prep"])
def test_chunked_stream_sync_matches_localsgd(rank_data, engine):
    """The chunked stream syncs the dense params every K steps: bit for
    bit the per-batch loop that syncs every K (the reference's green
    ``TestChunkedStreamMultiHostSync``); the trailing partial chunk ends
    unsynced, so the ranks' params differ at the end."""
    dp = engine == "device_prep"
    batches = [b + b[:2] for b in rank_data]
    got = chunked_or_oracle(batches, dp, chunked=True)
    want = chunked_or_oracle(batches, dp, chunked=False)
    assert any(not np.array_equal(a, b) for a, b in zip(got[0][1],
                                                         got[1][1]))
    for (grows, gdense), (wrows, wdense) in zip(got, want):
        assert grows[0].size > 100
        for a, b in zip(grows + tuple(gdense), wrows + tuple(wdense)):
            np.testing.assert_array_equal(a, b)


# -- the trainers -------------------------------------------------------------

def feed_confs():
    def conf(fc, sc):
        return fc(slots=[sc("label", type="float", is_dense=True, dim=1),
                         sc("slot_a"), sc("slot_b"), sc("slot_c")],
                  batch_size=8, label_slot="label", thread_num=1)
    return conf(JaxFeedConfig, JaxSlotConfig), conf(DataFeedConfig,
                                                    SlotConfig)


@pytest.fixture(scope="module")
def trainer_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("mh_files")
    jconf, _ = feed_confs()
    return [make_slot_file(str(d / f"part-{i}"), jconf, 64, seed=20 + i,
                           vocab=400) for i in range(WORLD)]


def rank_datasets(cls, conf, files):
    """Each rank's shard of the files (one file a rank)."""
    out = []
    for r in range(WORLD):
        ds = cls(conf, shard_id=r, num_shards=WORLD)
        ds.set_filelist(files)
        ds.load_into_memory()
        out.append(ds)
    return out


def pass_keys(ds):
    return np.concatenate([r.uint64_feas for r in ds.records])


def train_passes(tr, ds, passes=2, fetch=False):
    """``passes`` passes of one rank: stage, train, end; returns each
    pass's metrics (and with ``fetch`` the per-batch losses)."""
    out = []
    for _ in range(passes):
        tr.reset_metrics()
        tr.table.begin_feed_pass(pass_keys(ds))
        losses = []
        handler = (lambda i, loss, p: losses.append(float(loss))) \
            if fetch else None
        out.append((tr.train_from_dataset(ds, fetch_handler=handler),
                    losses))
        tr.table.end_pass()
    return out


@pytest.mark.parametrize("device_prep", [True, False])
def test_trainer_dense_sync_hook_matches_reference(trainer_files,
                                                   device_prep):
    """``CTRTrainer(mesh=make_mesh(1), table=TieredShardedDeviceTable(
    DistributedTable), dense_sync_hook=)`` on each of two ranks, SGD with
    ``dense_sync_steps=2``: two passes of the chunked stream (the hook
    every 2 steps), then one per-batch pass (a fetch handler: the hook
    after every step), against the reference's trainers with
    ``sync_params_mean``: each pass's metrics (``ins_num`` exact, the AUC
    within 1e-6), the per-batch losses, the dense params and each rank's
    shard by key."""
    jconf, pconf = feed_confs()
    jds = rank_datasets(JaxSlotDataset, jconf, trainer_files)
    pds = rank_datasets(SlotDataset, pconf, trainer_files)
    tkw = dict(SGD, dense_sync_steps=2)
    jcoords, pcoords = world("ref", WORLD), world("port", WORLD)
    jtrs, ptrs = [], []
    devs = jax.devices()
    for r in range(WORLD):
        jt = JaxTieredSharded(
            JaxTableConfig(**TABLE), jax_make_mesh(devices=[devs[r]]),
            backing=JaxDistTable(JaxTableConfig(**TABLE), jcoords[r]),
            capacity_per_shard=2048, writeback_mode="delta")
        jtrs.append(JaxTrainer(
            FlaxDeepFM(hidden=HIDDEN), jconf, JaxTableConfig(**TABLE),
            JaxTrainerConfig(**tkw), table=jt, mesh=jt.mesh,
            device_prep=device_prep,
            dense_sync_hook=lambda p, c=jcoords[r]: sync_params_mean(p, c)))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jtrs[0].params)]
    for r in range(WORLD):
        mesh = make_mesh(1, device="cpu")
        pt = TieredShardedDeviceTable(
            TableConfig(**TABLE), mesh,
            backing=DistributedTable(TableConfig(**TABLE), pcoords[r]),
            capacity_per_shard=2048, writeback_mode="delta")
        ptrs.append(CTRTrainer(
            deepfm_from_flax_leaves(leaves, HIDDEN), pconf,
            TableConfig(**TABLE), TrainerConfig(**tkw), table=pt,
            mesh=mesh, device_prep=device_prep,
            dense_sync_hook=dense_mean_hook(pcoords[r])))
        assert ptrs[r].fused and ptrs[r].step.device_prep == device_prep

    def rank(trs, dss):
        def fn(r, c):
            out = train_passes(trs[r], dss[r])
            out += train_passes(trs[r], dss[r], passes=1, fetch=True)
            return out, local_rows(trs[r].table.backing.local)
        return fn

    want = run_ranks(rank(jtrs, jds), jcoords)
    got = run_ranks(rank(ptrs, pds), pcoords)
    for r in range(WORLD):
        (gpasses, grows), (wpasses, wrows) = got[r], want[r]
        for (gm, gl), (wm, wl) in zip(gpasses, wpasses):
            assert gm["ins_num"] == wm["ins_num"] == 64.0
            assert abs(gm["auc"] - wm["auc"]) < 1e-6
            np.testing.assert_allclose(gl, wl, rtol=1e-5)
        assert len(gpasses[-1][1]) == 8
        assert_rows_close(grows, wrows)
        for a, b in zip(flax_leaves_from_model(ptrs[r].params),
                        jax.tree_util.tree_leaves(jtrs[r].params)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)
    # the last pass synced after its last step: the ranks agree
    for a, b in zip(flax_leaves_from_model(ptrs[0].params),
                    flax_leaves_from_model(ptrs[1].params)):
        np.testing.assert_array_equal(a, b)


def test_host_table_trainer_over_distributed_table(trainer_files):
    """The path of the reference's ``examples/05``: ``CTRTrainer(table=
    DistributedTable, use_device_table=False)`` on two ranks (the
    host-table engine, each batch's pull and push collectives), no dense
    sync: a pass's per-batch losses and each rank's shard by key against
    the reference's."""
    jconf, pconf = feed_confs()
    jds = rank_datasets(JaxSlotDataset, jconf, trainer_files)
    pds = rank_datasets(SlotDataset, pconf, trainer_files)
    jcoords, pcoords = world("ref", WORLD), world("port", WORLD)
    jtrs = [JaxTrainer(FlaxDeepFM(hidden=HIDDEN), jconf,
                       JaxTableConfig(**TABLE), JaxTrainerConfig(**SGD),
                       table=JaxDistTable(JaxTableConfig(**TABLE), c),
                       use_device_table=False) for c in jcoords]
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jtrs[0].params)]
    ptrs = [CTRTrainer(deepfm_from_flax_leaves(leaves, HIDDEN), pconf,
                       TableConfig(**TABLE), TrainerConfig(**SGD),
                       table=DistributedTable(TableConfig(**TABLE), c),
                       use_device_table=False, device="cpu")
            for c in pcoords]
    assert not ptrs[0].fused

    def rank(trs, dss):
        def fn(r, c):
            losses = []
            m = trs[r].train_from_dataset(
                dss[r], fetch_handler=lambda i, loss, p: losses.append(
                    float(loss)))
            return m, losses, local_rows(trs[r].table.local)
        return fn

    want = run_ranks(rank(jtrs, jds), jcoords)
    got = run_ranks(rank(ptrs, pds), pcoords)
    for (gm, gl, grows), (wm, wl, wrows) in zip(got, want):
        assert gm["ins_num"] == wm["ins_num"] == 64.0
        np.testing.assert_allclose(gl, wl, rtol=1e-5)
        assert_rows_close(grows, wrows)
    assert sum(g[2][0].size for g in got) > 100


def test_tiered_sharded_saves_match_reference(tmp_path):
    """The persistence surface of ``TieredShardedDeviceTable`` (writeback
    "delta", 2 shards, host plan) against the reference's: a mid-pass
    ``save_delta`` and ``snapshot_parts`` (each writes the pass back and
    re-baselines the staged copy, so ``end_pass`` adds nothing twice), a
    ``save`` after the pass, ``mark_dirty``, ``len`` and a ``load`` of
    the other package's file: every file's rows by key."""
    ndev, B, Sl, npad = 2, 8, 4, 128
    kw = dict(embedx_dim=4, cvm_offset=3, embedx_threshold=0.0,
              initial_range=0.01, learning_rate=0.1, seed=3)
    jt = JaxTieredSharded(JaxTableConfig(**kw), jax_make_mesh(ndev),
                          capacity_per_shard=2048, backend="numpy",
                          writeback_mode="delta")
    js = JaxShardedStep(FlaxWideDeep(hidden=HIDDEN), jt,
                        JaxTrainerConfig(dense_learning_rate=1e-2),
                        batch_size=B, num_slots=Sl)
    jp, jo = js.init(jax.random.PRNGKey(0))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)]
    pt = TieredShardedDeviceTable(TableConfig(**kw),
                                  make_mesh(ndev, device="cpu"),
                                  capacity_per_shard=2048, backend="numpy",
                                  writeback_mode="delta")
    ps = FusedShardedTrainStep(widedeep_from_flax_leaves(leaves, HIDDEN), pt,
                               TrainerConfig(dense_learning_rate=1e-2),
                               batch_size=B, num_slots=Sl)
    jst, pst = [jp, jo, js.init_auc_state()], [*ps.init(),
                                              ps.init_auc_state()]
    rng = np.random.default_rng(3)
    batches = [make_batch(rng, ndev, B, Sl, npad, 900) for _ in range(4)]
    files = {}
    for tag, t, step, st in (("ref", jt, js, jst), ("port", pt, ps, pst)):
        t.begin_feed_pass(np.concatenate([b[0].ravel() for b in batches]))
        for i, b in enumerate(batches):
            *st[:3], _, _ = step(*st, t.prepare_batch(b[0]), *b[1:])
            if i == 1:
                n = t.save_delta(str(tmp_path / f"{tag}-mid.npz"))
                parts = t.snapshot_parts(delta=True)
        t.end_pass()
        t.save(str(tmp_path / f"{tag}-base.npz"))
        t.mark_dirty(batches[0][0][0][:5])
        files[tag] = (n, {k: {f: np.asarray(v) for f, v in p.items()}
                          for k, p in parts.items()}, len(t),
                      t.save_delta(str(tmp_path / f"{tag}-d2.npz")))
    (jn, jparts, jlen, jd2), (pn, pparts, plen, pd2) = \
        files["ref"], files["port"]
    assert pn == jn > 0 and plen == jlen and pd2 == jd2 == 5
    assert sorted(pparts) == sorted(jparts)
    for k in pparts:
        assert_rows_close(by_key(pparts[k]), by_key(jparts[k]))
    for name in ("mid", "base", "d2"):
        with np.load(tmp_path / f"port-{name}.npz") as p, \
                np.load(tmp_path / f"ref-{name}.npz") as j:
            assert_rows_close(by_key(dict(p)), by_key(dict(j)))
    # each package loads the other's base
    for tag, t in (("ref", pt), ("port", jt)):
        t.load(str(tmp_path / f"{tag}-base.npz"))
    assert_rows_close(by_key(pt.backing.snapshot(reset_dirty=False)),
                      by_key(jt.backing.snapshot(reset_dirty=False)))


def test_tiered_table_over_distributed_table_matches_reference():
    """A single-device ``TieredDeviceTable`` over a ``DistributedTable``
    backing (the refusal is gone, as the reference accepts it), two ranks
    with keys of their own: 2 passes of 2 host-prep steps each, every
    rank's losses and shard of the PS by key against the reference's."""
    from paddlebox_tpu.ps.tiered_table import TieredDeviceTable as JaxTiered
    from paddlebox_tpu.trainer.fused_step import FusedTrainStep as JaxStep
    from paddlebox_tpu_torch.ps.tiered_table import TieredDeviceTable
    from paddlebox_tpu_torch.trainer.fused_step import FusedTrainStep
    B, Sl, npad = 8, 3, 128
    rng = np.random.default_rng(4)
    batches = []
    for r in range(WORLD):
        rb = []
        for _ in range(4):
            b = make_batch(rng, 1, B, Sl, npad, 400)
            keys = b[0][0].copy()
            keys[keys != 0] = keys[keys != 0] * np.uint64(WORLD) + \
                np.uint64(r)
            rb.append((keys,) + tuple(x[0] for x in b[1:]))
        batches.append(rb)
    jstep0 = JaxStep(FlaxDeepFM(hidden=HIDDEN), JaxTiered(JaxTableConfig(
        **TABLE), capacity=256, backend="numpy"), JaxTrainerConfig(**SGD), B,
        Sl)
    jp, jo = jstep0.init(jax.random.PRNGKey(1))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)]

    def rank(pkg):
        def fn(r, c):
            if pkg == "ref":
                t = JaxTiered(JaxTableConfig(**TABLE), capacity=256,
                              backend="numpy",
                              backing=JaxDistTable(JaxTableConfig(**TABLE), c))
                fs = JaxStep(FlaxDeepFM(hidden=HIDDEN), t,
                             JaxTrainerConfig(**SGD), B, Sl)
                st = [jp, fs.optimizer.init(jp), fs.init_auc_state()]
            else:
                t = TieredDeviceTable(
                    TableConfig(**TABLE), capacity=256, backend="numpy",
                    device="cpu",
                    backing=DistributedTable(TableConfig(**TABLE), c))
                fs = FusedTrainStep(deepfm_from_flax_leaves(leaves, HIDDEN),
                                    t, TrainerConfig(**SGD), B, Sl)
                st = [*fs.init(), fs.init_auc_state()]
            losses = []
            for p in range(2):
                chunk = batches[r][2 * p:2 * p + 2]
                t.begin_feed_pass(np.concatenate([b[0] for b in chunk]))
                for b in chunk:
                    *st[:3], loss, _ = fs(*st, *b)
                    losses.append(float(loss))
                t.end_pass()
            return losses, local_rows(t.backing.local)
        return fn

    want = run_ranks(rank("ref"), world("ref", WORLD))
    got = run_ranks(rank("port"), world("port", WORLD))
    for (gl, grows), (wl, wrows) in zip(got, want):
        np.testing.assert_allclose(gl, wl, rtol=1e-5)
        assert grows[0].size > 20
        assert_rows_close(grows, wrows)
