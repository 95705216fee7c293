"""Port's deferred insert (``insert_mode="deferred"``: the device miss ring
of ``ps/device_table.py``, appended in ``FusedTrainStep.
step_device_tensors``, drained by ``poll_misses`` and the lagged
``poll_misses_async``) against the reference's, on the CPU, over native
one-thread tables carrying the same arena and from the same flax params:
``step_device`` with new keys mid-stream, ``train_stream`` (runs of 16 and a
tail, with and without the final poll) and ``train_chunk``, an overflowing
ring (``MISS_RING`` = 8 in both packages), ``CTRTrainer.
train_from_dataset(insert_mode="deferred")`` and two passes of a tiered
table.

Tolerances: the ring's count and entries, the inserted keys' row numbers
(the index dump) and the dirty rows exact; losses and preds atol 1e-5, dense
params rtol 1e-4 atol 1e-6, rows with show/clk exact and the rest atol
1e-5 (float32 GEMMs and reductions in another order). The null row, which
every miss rides, stays bit-unchanged."""

import dataclasses

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
from paddlebox_tpu.models import DeepFM as FlaxDeepFM
from paddlebox_tpu.ps import native as ref_native
from paddlebox_tpu.ps.device_table import DeviceTable as JaxDeviceTable
from paddlebox_tpu.ps.tiered_table import TieredDeviceTable as JaxTiered
from paddlebox_tpu.trainer import trainer as ref_trainer
from paddlebox_tpu.trainer.fused_step import FusedTrainStep as JaxStep
from paddlebox_tpu_torch.config import (DataFeedConfig, TableConfig,
                                        TrainerConfig)
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.models.convert import (deepfm_from_flax_leaves,
                                                flax_leaves_from_deepfm)
from paddlebox_tpu_torch.ps.device_table import DeviceTable
from paddlebox_tpu_torch.ps.tiered_table import TieredDeviceTable
from paddlebox_tpu_torch.trainer.fused_step import FusedTrainStep
from paddlebox_tpu_torch.trainer.trainer import CTRTrainer

pytestmark = pytest.mark.skipif(not ref_native.available(),
                                reason="native backend unavailable")

B, S, DD, NPAD = 16, 4, 3, 256
HIDDEN = (16,)
TABLE = dict(embedx_dim=4, cvm_offset=3, embedx_threshold=0.0,
             initial_range=0.05, seed=11)
TCONF = dict(dense_optimizer="adam", dense_learning_rate=1e-3)
PREPOP = 300     # keys 1..300 resident; the batches draw up to VOCAB
VOCAB = 420
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


def make_batches(seed, n, lo=1, vocab=VOCAB):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lengths = rng.integers(1, 4, size=B * S)
        k = int(lengths.sum())
        keys = np.zeros(NPAD, np.uint64)
        keys[:k] = rng.integers(lo, vocab, size=k)
        segs = np.full(NPAD, B * S, np.int32)
        segs[:k] = np.repeat(np.arange(B * S, dtype=np.int32), lengths)
        labels = (rng.uniform(size=B) < 0.4).astype(np.float32)
        cvm = np.stack([np.ones(B, np.float32), labels], axis=1)
        dense = rng.normal(size=(B, DD)).astype(np.float32)
        out.append((keys, segs, cvm, labels, dense, np.ones(B, np.float32)))
    return out


def worlds(prepop=PREPOP):
    """The reference's deferred device-prep step over a native table of
    ``prepop`` resident rows, and the port's over a table carrying the
    same arena and index, from the same weights."""
    jt = JaxDeviceTable(JaxTableConfig(**TABLE), capacity=1 << 11, **NATIVE)
    if prepop:
        jt.prepopulate(prepop)
    jfs = JaxStep(FlaxDeepFM(hidden=HIDDEN), jt, JaxTrainerConfig(**TCONF),
                  B, S, dense_dim=DD, device_prep=True,
                  insert_mode="deferred")
    jp, jo = jfs.init(jax.random.PRNGKey(5))
    pt = DeviceTable(TableConfig(**TABLE), capacity=1, device="cpu",
                     **NATIVE)
    pt.load_arena(np.asarray(jt.values), np.asarray(jt.state),
                  jt._index.dump_keys(jt._size))
    pfs = FusedTrainStep(deepfm_from_flax_leaves(leaves_of(jp), HIDDEN), pt,
                         TrainerConfig(**TCONF), B, S, dense_dim=DD,
                         device_prep=True, insert_mode="deferred")
    return (jfs, jt, [jp, jo, jfs.init_auc_state()]), \
        (pfs, pt, [*pfs.init(), pfs.init_auc_state()])


def ring_of(t, ref: bool):
    """(count, the ring's first ``count`` keys as uint64)."""
    if ref:
        n = int(np.asarray(t.miss_cnt)[0])
        buf = np.asarray(t.miss_buf)[:n]
        return n, ((buf[:, 0].astype(np.uint64) << np.uint64(32))
                   | buf[:, 1].astype(np.uint64))
    n = int(t.miss_cnt[0])
    return n, t.miss_ring[:n].numpy().view(np.uint64).copy()


def assert_same_ring(pt, jt):
    (n, keys), (jn, jkeys) = ring_of(pt, False), ring_of(jt, True)
    assert n == jn
    np.testing.assert_array_equal(keys, jkeys)
    return n


def assert_same_tables(pt, jt, atol=1e-5):
    """The index dump (row numbering) and the dirty rows exact, the rows
    with show/clk exact and the rest within ``atol``."""
    assert len(pt) == len(jt)
    n = len(pt) + 1
    np.testing.assert_array_equal(pt.row_keys()[1:],
                                  jt._index.dump_keys(jt._size)[1:])
    np.testing.assert_array_equal(pt.fetch_dirty_rows(),
                                  jt.fetch_dirty_rows())
    pv, jv = pt.values[:n].numpy(), np.asarray(jt.values)[:n]
    np.testing.assert_array_equal(pv[:, :2], jv[:, :2])
    np.testing.assert_allclose(pv, jv, rtol=0, atol=atol)
    np.testing.assert_allclose(pt.state[:n].numpy(),
                               np.asarray(jt.state)[:n], rtol=0, atol=atol)


def assert_same_dense(pparams, jparams):
    for got, want in zip(flax_leaves_from_deepfm(pparams),
                         leaves_of(jparams)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_step_device_matches_reference():
    """Eight ``step_device`` calls whose batches hold new keys: a step's
    misses ride row 0 and go to the ring in unique order, the lagged poll
    inserts them two steps later (numbered in ring order), and everything
    equals the reference after each step; row 0 never changes."""
    (jfs, jt, js), (pfs, pt, ps) = worlds()
    row0 = (pt.values[0].clone(), pt.state[0].clone())
    sizes = []
    for batch in make_batches(7, 8):
        *js, jloss, jpreds = jfs.step_device(*js, *batch)
        *ps, loss, preds = pfs.step_device(*ps, *batch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(preds.numpy(), np.asarray(jpreds),
                                   rtol=0, atol=1e-5)
        assert assert_same_ring(pt, jt) > 0
        assert len(pt) == len(jt)
        sizes.append(len(pt))
    # the lagged drain: step 3's poll reads the count snapshot step 2's
    # took, which holds step 1's misses
    assert sizes[1] == PREPOP < sizes[2] < sizes[-1]
    assert torch.equal(pt.values[0], row0[0])
    assert torch.equal(pt.state[0], row0[1])
    assert_same_dense(ps[0], js[0])
    assert_same_tables(pt, jt)
    assert pt.poll_misses() == jt.poll_misses() > 0
    assert int(pt.miss_cnt[0]) == 0 and pt._miss_snapshot is None
    assert_same_tables(pt, jt)


@pytest.mark.parametrize("final_poll", [True, False])
def test_train_stream_matches_reference(final_poll):
    """Two full runs of 16 and a tail of 3 through ``train_stream``, new
    keys throughout: the same losses, the same ring before the final poll,
    and after it (or an explicit ``poll_misses``) the same table; then a
    host-prep ``train_chunk`` of two batches on both."""
    (jfs, jt, js), (pfs, pt, ps) = worlds()
    batches = make_batches(11, 2 * FusedTrainStep.DEV_CHUNK + 3, vocab=1500)
    jl, pl = [], []
    *js, _jloss, jsteps = jfs.train_stream(
        *js, iter(batches), on_step=lambda s, l: jl.append(
            np.asarray(l).reshape(-1)), final_poll=final_poll)
    *ps, _loss, steps = pfs.train_stream(
        *ps, iter(batches), on_step=lambda s, l: pl.append(float(l)),
        final_poll=final_poll)
    assert steps == jsteps == len(batches)
    np.testing.assert_allclose(pl, np.concatenate(jl), rtol=0, atol=1e-5)
    n = assert_same_ring(pt, jt)
    assert (n == 0) == final_poll
    if not final_poll:
        assert pt.poll_misses() == jt.poll_misses() == n
    assert_same_tables(pt, jt)
    assert_same_dense(ps[0], js[0])
    chunk = make_batches(12, 2)
    *js, jlosses, _ = jfs.train_chunk(*js, *map(list, zip(*chunk)))
    *ps, losses, _ = pfs.train_chunk(*ps, *map(list, zip(*chunk)))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=0,
                               atol=1e-5)
    assert_same_tables(pt, jt)


def test_overflowing_ring_matches_reference(monkeypatch):
    """A ring of 8 entries (``MISS_RING`` patched in both packages): the
    count stops at 8, the misses past it land in the sink and recur at
    their key's next occurrence, so both tables insert the same keys in
    the same order."""
    monkeypatch.setattr(JaxDeviceTable, "MISS_RING", 8)
    monkeypatch.setattr(DeviceTable, "MISS_RING", 8)
    (jfs, jt, js), (pfs, pt, ps) = worlds()
    assert pt.miss_ring.shape == (9,)
    for i, batch in enumerate(make_batches(13, 6)):
        *js, jloss, _ = jfs.step_device(*js, *batch)
        *ps, loss, _ = pfs.step_device(*ps, *batch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=0,
                                   atol=1e-5)
        assert assert_same_ring(pt, jt) == 8
        assert len(pt) == len(jt)
    assert PREPOP < len(pt) <= PREPOP + 6 * 8
    assert pt.poll_misses() == jt.poll_misses() == 8
    assert_same_tables(pt, jt)


def feed_confs():
    jconf = JaxFeedConfig(slots=[
        JaxSlotConfig("label", type="float", is_dense=True, dim=1),
        JaxSlotConfig("slot_a"), JaxSlotConfig("slot_b"),
        JaxSlotConfig("slot_c"),
        JaxSlotConfig("dense_x", type="float", is_dense=True, dim=3),
    ], batch_size=8, label_slot="label", thread_num=2)
    return jconf, DataFeedConfig.from_dict(dataclasses.asdict(jconf))


def test_trainer_pass_matches_reference(tmp_path):
    """``CTRTrainer.train_from_dataset(insert_mode="deferred")`` from an
    empty table: every key of the first batches misses, the lagged polls
    insert them, the pass end drains the ring (``_drain_miss_ring``); the
    losses, metrics, rows and the index dump equal the reference's."""
    jconf, pconf = feed_confs()
    files = [make_slot_file(str(tmp_path / f"part-{i}"), jconf, 48, seed=i,
                            vocab=200) for i in range(2)]
    jt = JaxDeviceTable(JaxTableConfig(**TABLE), capacity=1 << 11, **NATIVE)
    arena = (np.asarray(jt.values).copy(), np.asarray(jt.state).copy(),
             jt._index.dump_keys(jt._size))
    jtr = ref_trainer.CTRTrainer(
        FlaxDeepFM(hidden=HIDDEN), jconf, JaxTableConfig(**TABLE),
        JaxTrainerConfig(), table=jt, insert_mode="deferred")
    assert jtr.step.insert_mode == "deferred"
    pt = DeviceTable(TableConfig(**TABLE), capacity=1, device="cpu",
                     **NATIVE)
    pt.load_arena(*arena)
    ptr = CTRTrainer(deepfm_from_flax_leaves(leaves_of(jtr.params), HIDDEN),
                     pconf, TableConfig(**TABLE), TrainerConfig(), table=pt,
                     insert_mode="deferred")
    assert ptr.step.device_prep and ptr.step.insert_mode == "deferred"
    jds = JaxSlotDataset(jconf)
    pds = SlotDataset(pconf)
    for ds in (jds, pds):
        ds.set_filelist(files)
        ds.load_into_memory()
    jf, pf = [], []
    jm = jtr.train_from_dataset(jds, fetch_handler=lambda s, l, p:
                                jf.append((s, l, np.asarray(p).copy())))
    pm = ptr.train_from_dataset(pds, fetch_handler=lambda s, l, p:
                                pf.append((s, l, p.copy())))
    assert [s for s, _, _ in pf] == [s for s, _, _ in jf] and len(pf) == 12
    for (_, loss, preds), (_, jloss, jpreds) in zip(pf, jf):
        np.testing.assert_allclose(loss, jloss, rtol=0, atol=1e-5)
        np.testing.assert_allclose(preds, jpreds, rtol=0, atol=1e-5)
    assert set(pm) == set(jm) and pm["ins_num"] == jm["ins_num"]
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], rtol=0, atol=1e-5)
    # the pass end drained the ring: every key of the files has a row
    assert int(pt.miss_cnt[0]) == 0 and len(pt) > 100
    assert_same_tables(pt, jt)
    assert_same_dense(ptr.params, jtr.params)


def test_tiered_passes_match_reference():
    """Two passes of a tiered table in deferred mode, each staging only the
    keys of its first half: the second half's new keys miss, the polls
    give them rows past W (their init carried from the reference's fresh
    arena), the pass end drains the ring and writes back, and
    ``begin_feed_pass`` zeroes the count. The backing by key, show/clk
    exact and the rest within 1e-5."""
    conf = dict(TABLE, show_clk_decay=0.9)
    jt = JaxTiered(JaxTableConfig(**conf), capacity=1 << 10, **NATIVE)
    pt = TieredDeviceTable(TableConfig(**conf), capacity=1 << 10,
                           device="cpu", **NATIVE)
    jfs = JaxStep(FlaxDeepFM(hidden=HIDDEN), jt, JaxTrainerConfig(**TCONF),
                  B, S, dense_dim=DD, device_prep=True,
                  insert_mode="deferred")
    jp, jo = jfs.init(jax.random.PRNGKey(3))
    pfs = FusedTrainStep(deepfm_from_flax_leaves(leaves_of(jp), HIDDEN), pt,
                         TrainerConfig(**TCONF), B, S, dense_dim=DD,
                         device_prep=True, insert_mode="deferred")
    js, ps = [jp, jo, jfs.init_auc_state()], [*pfs.init(),
                                             pfs.init_auc_state()]
    for p, batches in enumerate((make_batches(21, 6, vocab=500),
                                 make_batches(22, 6, vocab=700))):
        staged = np.concatenate([b[0] for b in batches[:3]])
        w = jt.begin_feed_pass(staged)
        assert pt.begin_feed_pass(staged) == w
        assert int(pt.miss_cnt[0]) == 0 and pt._miss_snapshot is None
        # staged from the backings: bit for bit before any training,
        # within the trained rows' tolerance after
        np.testing.assert_allclose(pt.values[1:w + 1].numpy(),
                                   np.asarray(jt.values)[1:w + 1], rtol=0,
                                   atol=1e-5 if p else 0.0)
        # the rows past W: the reference's fresh init, carried in place
        pt.values.copy_(torch.from_numpy(np.array(jt.values)))
        pt.state.copy_(torch.from_numpy(np.array(jt.state)))
        for batch in batches:
            *js, jloss, _ = jfs.step_device(*js, *batch)
            *ps, loss, _ = pfs.step_device(*ps, *batch)
            np.testing.assert_allclose(float(loss), float(jloss), rtol=0,
                                       atol=1e-5)
            assert_same_ring(pt, jt)
        assert pt.poll_misses() == jt.poll_misses()
        assert pt._size == jt._size > w + 1
        pt.end_pass()
        jt.end_pass()
    psnap = pt.backing.snapshot(reset_dirty=False)
    jsnap = jt.backing.snapshot(reset_dirty=False)
    po, jo_ = np.argsort(psnap["keys"]), np.argsort(jsnap["keys"])
    np.testing.assert_array_equal(psnap["keys"][po], jsnap["keys"][jo_])
    pv, jv = psnap["values"][po], jsnap["values"][jo_]
    np.testing.assert_array_equal(pv[:, :2], jv[:, :2])
    np.testing.assert_allclose(pv, jv, rtol=0, atol=1e-5)
    np.testing.assert_allclose(psnap["state"][po], jsnap["state"][jo_],
                               rtol=0, atol=1e-5)


def test_ensure_mode_ring_matches_reference():
    """"ensure" mode: over a table that admits every key no step misses,
    and the port skips the append (the ring stays empty, as the
    reference's does); over a tiered table with frequency admission the
    keys the gate keeps out miss, and both packages append the same ring
    (the reference appends in either mode)."""
    from paddlebox_tpu.ps import admission as ref_admission
    from paddlebox_tpu_torch.ps import admission

    (jfs, jt, js), (pfs, pt, ps) = worlds()
    port_ens = FusedTrainStep(pfs.model, pt, TrainerConfig(**TCONF), B, S,
                              dense_dim=DD, device_prep=True)
    assert pt.admits_every_key() and not port_ens._record_misses
    calls = []
    pt.record_misses = lambda *a: calls.append(a)
    st = [ps[0], ps[1], port_ens.init_auc_state()]
    for batch in make_batches(31, 2):
        *st[:3], _, _ = port_ens.step_device(*st, *batch)
    assert not calls and int(pt.miss_cnt[0]) == 0
    assert len(pt) > PREPOP
    conf = dict(TABLE)
    jt = JaxTiered(JaxTableConfig(**conf), capacity=1 << 10,
                   admit=ref_admission.CountMinAdmission(2.0, width=4096),
                   **NATIVE)
    pt = TieredDeviceTable(TableConfig(**conf), capacity=1 << 10,
                           device="cpu",
                           admit=admission.CountMinAdmission(2.0,
                                                             width=4096),
                           **NATIVE)
    assert not pt.admits_every_key()
    jfs = JaxStep(FlaxDeepFM(hidden=HIDDEN), jt, JaxTrainerConfig(**TCONF),
                  B, S, dense_dim=DD, device_prep=True)
    jp, jo = jfs.init(jax.random.PRNGKey(3))
    pfs = FusedTrainStep(deepfm_from_flax_leaves(leaves_of(jp), HIDDEN), pt,
                         TrainerConfig(**TCONF), B, S, dense_dim=DD,
                         device_prep=True)
    assert pfs._record_misses
    js, ps = [jp, jo, jfs.init_auc_state()], [*pfs.init(),
                                             pfs.init_auc_state()]
    batches = make_batches(32, 3, vocab=500)
    keys = np.concatenate([b[0] for b in batches])
    assert jt.begin_feed_pass(keys) == pt.begin_feed_pass(keys)
    pt.values.copy_(torch.from_numpy(np.array(jt.values)))
    pt.state.copy_(torch.from_numpy(np.array(jt.state)))
    for batch in batches:
        *js, jloss, _ = jfs.step_device(*js, *batch)
        *ps, loss, _ = pfs.step_device(*ps, *batch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=0,
                                   atol=1e-5)
    assert assert_same_ring(pt, jt) > 0
