"""Port's day/pass loop (``trainer/pass_manager.py`` ``PassManager`` over
``ps/server.py`` ``SparsePS`` and a ``DeviceTable``) against the JAX
package's, on the CPU, driven as ``examples/02_deepfm_stream.py`` drives
it: day 1 of two passes (the second preloaded, its keys prefetched), each
ended with a delta save, then a base save with the dense state; day 2 of
one pass with a delta. Both engines: host prep over the numpy index and
device prep over the native one-thread index (the push's plain mark on the
CPU), both tables prepopulated so that a device-prep step inserts no key
and its rows are marked by the step alone.

The reference trainer is built first; the port starts from its converted
params and its arena (``load_arena``). Held to the reference:
- the donefile records (kind, day, pass, path relative to the root) and
  the files of each checkpoint dir;
- every npz: keys exact, values, state and dense leaves rtol 1e-5, atol
  1e-6 (three passes of float32 training, summed in another order: the
  tolerance of ``test_torch_trainer.py``'s rows, tightened);
- the dirty rows by key after the steps of a pass with no feed pass, and
  after a resume (``load`` clears, ``load_delta`` marks);
- resume across the packages both ways, exactly: the same trail resumed
  by either package gives the same rows by key and the same dense leaves.
A crash at ``delta.mid_write`` is run through both packages and their
trails compared; retention and the CPU-view hazard (a save's arrays are
copies of the live arena) are checked on the port. A ``TieredDeviceTable``
under the loop (the reference's ``TestTieredPassFlow``): the prefetched
staging is consumed and equals the synchronous flow bit for bit, trained
by ``CTRTrainer`` on either engine, also over a disk tier whose rows the
pass end spilled, and the untrained flow equals the reference's; a host
``EmbeddingTable`` is a table of ``SparsePS``."""

import dataclasses
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from conftest import make_slot_file
from paddlebox_tpu.ckpt import faults as ref_faults
from paddlebox_tpu.ckpt.writer import AsyncCheckpointWriter as RefWriter
from paddlebox_tpu.config import DataFeedConfig as JaxFeedConfig
from paddlebox_tpu.config import SlotConfig as JaxSlotConfig
from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.config import TrainerConfig as JaxTrainerConfig
from paddlebox_tpu.data.dataset import SlotDataset as JaxSlotDataset
from paddlebox_tpu.models import DeepFM as FlaxDeepFM
from paddlebox_tpu.ps import native as ref_native
from paddlebox_tpu.ps.device_table import DeviceTable as JaxDeviceTable
from paddlebox_tpu.ps.server import SparsePS as RefSparsePS
from paddlebox_tpu.trainer import donefile as ref_donefile
from paddlebox_tpu.trainer import trainer as ref_trainer
from paddlebox_tpu.trainer.pass_manager import PassManager as RefPassManager
from paddlebox_tpu.utils.checkpoint import pytree_arrays
from paddlebox_tpu_torch.ckpt import faults
from paddlebox_tpu_torch.ckpt.writer import AsyncCheckpointWriter
from paddlebox_tpu_torch.config import (DataFeedConfig, TableConfig,
                                        TrainerConfig)
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.models import DeepFM
from paddlebox_tpu_torch.models.convert import deepfm_from_flax_leaves
from paddlebox_tpu_torch.ps.device_table import DeviceTable
from paddlebox_tpu_torch.ps.server import SparsePS
from paddlebox_tpu_torch.ps.ssd_tier import DiskTier
from paddlebox_tpu_torch.ps.table import EmbeddingTable
from paddlebox_tpu_torch.ps.tiered_table import TieredDeviceTable
from paddlebox_tpu_torch.trainer import donefile
from paddlebox_tpu_torch.trainer.pass_manager import PassManager
from paddlebox_tpu_torch.trainer.train_step import make_dense_optimizer
from paddlebox_tpu_torch.trainer.trainer import CTRTrainer
from paddlebox_tpu_torch.utils.checkpoint import dense_arrays

pytestmark = pytest.mark.skipif(not ref_native.available(),
                                reason="native backend unavailable")

HIDDEN = (16,)
TABLE = dict(embedx_dim=4, cvm_offset=3, optimizer="adagrad",
             learning_rate=0.05, embedx_threshold=0.0, seed=2)
CAPACITY = 2048
PREPOP = 400        # keys 1..400 exist before any pass
TOL = dict(rtol=1e-5, atol=1e-6)
ENGINES = {"host": dict(backend="numpy"),
           "device": dict(backend="native", index_threads=1)}
DAY1, DAY2 = "20260101", "20260102"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """JAX's CPU thread pools spin beside torch's intra-op threads and slow
    these small torch ops several times over; one thread is enough."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def disarmed():
    yield
    faults.disarm_all()
    ref_faults.disarm_all()


def jax_feed_conf():
    """The reference tests' ``feed_conf`` (tests/conftest.py)."""
    return JaxFeedConfig(slots=[
        JaxSlotConfig("label", type="float", is_dense=True, dim=1),
        JaxSlotConfig("slot_a"), JaxSlotConfig("slot_b"),
        JaxSlotConfig("slot_c"),
        JaxSlotConfig("dense_x", type="float", is_dense=True, dim=3),
    ], batch_size=8, label_slot="label", thread_num=2)


def port_feed_conf():
    return DataFeedConfig.from_dict(dataclasses.asdict(jax_feed_conf()))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Pass 0 (the steps without a feed pass), passes 1 and 2 of day 1
    within the prepopulated keys, pass 3 of day 2 with new keys."""
    d = tmp_path_factory.mktemp("pass_slots")
    return [make_slot_file(str(d / f"part-{i}"), jax_feed_conf(), 24,
                           seed=10 + i, vocab=vocab)
            for i, vocab in enumerate((PREPOP, PREPOP, PREPOP, 900))]


def dirty_keys(table):
    return np.sort(table._index.dump_keys(table._size)[
        table.fetch_dirty_rows()])


def drive(pm, tr, files):
    """The loop of ``examples/02_deepfm_stream.py``: returns the dirty keys
    after a pass of steps with no feed pass (``files[0]``)."""
    ds0 = pm.next_buffer
    ds0.set_filelist(files[:1])
    ds0.load_into_memory()
    tr.train_from_dataset(ds0)
    after_steps = dirty_keys(tr.table)
    ds0.release_memory()
    tr.reset_metrics()
    pm.set_date(DAY1)
    ds = pm.begin_pass(files[1:2])
    pm.preload_next(files[2:3])
    pm.prefetch_feed_next()
    tr.train_from_dataset(ds)
    pm.end_pass(save_delta=True)
    tr.reset_metrics()
    ds = pm.begin_pass([], preloaded=True)
    tr.train_from_dataset(ds)
    pm.end_pass(save_delta=True)
    pm.save_base(dense_state=(tr.params, tr.opt_state))
    pm.set_date(DAY2)
    ds = pm.begin_pass(files[3:4])
    tr.train_from_dataset(ds)
    pm.end_pass(save_delta=True)
    pm.barrier()
    return after_steps


def run_reference(engine, files, root):
    jt = JaxDeviceTable(JaxTableConfig(**TABLE), capacity=CAPACITY,
                        **ENGINES[engine])
    jt.prepopulate(PREPOP)
    arena = (np.asarray(jt.values).copy(), np.asarray(jt.state).copy(),
             jt._index.dump_keys(jt._size))
    tr = ref_trainer.CTRTrainer(
        FlaxDeepFM(hidden=HIDDEN), jax_feed_conf(), JaxTableConfig(**TABLE),
        JaxTrainerConfig(), table=jt)
    assert tr.step.device_prep == (engine == "device")
    init = [np.asarray(x) for x in jax.tree_util.tree_leaves(tr.params)]
    pm = RefPassManager(RefSparsePS({"embedding": jt}), root,
                        [JaxSlotDataset(jax_feed_conf()),
                         JaxSlotDataset(jax_feed_conf())])
    after_steps = drive(pm, tr, files)
    pm.close()
    return dict(root=root, arena=arena, init=init, after_steps=after_steps,
                template=(tr.params, tr.opt_state))


def port_world(ref):
    t = DeviceTable(TableConfig(**TABLE), capacity=1, device="cpu",
                    **ENGINES[ref["engine"]])
    t.load_arena(*ref["arena"])
    return CTRTrainer(deepfm_from_flax_leaves(ref["init"], HIDDEN),
                      port_feed_conf(), TableConfig(**TABLE),
                      TrainerConfig(), table=t)


def port_pm(table, root, **kw):
    return PassManager(SparsePS({"embedding": table}), root,
                       [SlotDataset(port_feed_conf()),
                        SlotDataset(port_feed_conf())], **kw)


@pytest.fixture(scope="module")
def loops(tmp_path_factory, files):
    """Each engine's loop, run once through both packages."""
    runs = {}

    def get(engine):
        if engine not in runs:
            d = tmp_path_factory.mktemp(f"loop_{engine}")
            ref = run_reference(engine, files, str(d / "ref"))
            ref["engine"] = engine
            tr = port_world(ref)
            assert tr.step.device_prep == (engine == "device")
            pm = port_pm(tr.table, str(d / "port"))
            after_steps = drive(pm, tr, files)
            pm.close()
            runs[engine] = dict(ref=ref, files=files, port=dict(
                root=str(d / "port"), after_steps=after_steps))
        return runs[engine]
    return get


def records(root):
    return [(r["kind"], r["day"], r["pass_id"],
             os.path.relpath(r["path"], root))
            for r in donefile.read_done(root)]


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_trail_matches_reference(engine, loops):
    """Donefile records, each dir's files, every npz."""
    run = loops(engine)
    ref_root, port_root = run["ref"]["root"], run["port"]["root"]
    want = [("delta", DAY1, 1, f"{DAY1}/00001/delta"),
            ("delta", DAY1, 2, f"{DAY1}/00002/delta"),
            ("base", DAY1, 2, f"{DAY1}/00002/base"),
            ("delta", DAY2, 3, f"{DAY2}/00003/delta")]
    assert records(port_root) == records(ref_root) == want
    assert [(r["kind"], r["pass_id"]) for r in
            ref_donefile.read_done(port_root)] == \
        [(k, p) for k, _, p, _ in want]
    for _, _, _, rel in want:
        a, b = os.path.join(port_root, rel), os.path.join(ref_root, rel)
        assert sorted(os.listdir(a)) == sorted(os.listdir(b))
        for name in os.listdir(a):
            if not name.endswith(".npz"):
                continue
            with np.load(os.path.join(a, name)) as got, \
                    np.load(os.path.join(b, name)) as exp:
                assert sorted(got.files) == sorted(exp.files), name
                for k in exp.files:
                    assert got[k].dtype == exp[k].dtype, (rel, name, k)
                    if k == "keys":
                        np.testing.assert_array_equal(got[k], exp[k])
                    else:
                        np.testing.assert_allclose(
                            got[k], exp[k], err_msg=f"{rel}/{name}:{k}",
                            **TOL)
    with np.load(os.path.join(port_root, f"{DAY1}/00002/base/dense.npz")) \
            as dense:
        assert len(dense.files) == 5 + 1 + 5 + 5   # params, count, mu, nu
    # the delta of each pass holds exactly its working set's keys (the
    # feed pass marks them; pass 1's also the steps before it)
    for i, rel in ((2, f"{DAY1}/00002/delta"), (3, f"{DAY2}/00003/delta")):
        ds = SlotDataset(port_feed_conf())
        ds.set_filelist([run["files"][i]])
        ds.load_into_memory()
        with np.load(os.path.join(port_root, rel, "embedding.npz")) as d:
            np.testing.assert_array_equal(np.sort(d["keys"]),
                                          ds.extract_keys())


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_dirty_rows_after_steps_match_reference(engine, loops):
    """A pass of steps with no feed pass: host prep marks in
    ``prepare_batch``, device prep in the step (the reference's
    ``dirty.at[uniq_rows].set(True)``, the port's push); the same keys,
    and they are the pass's keys."""
    run = loops(engine)
    got, want = run["port"]["after_steps"], run["ref"]["after_steps"]
    np.testing.assert_array_equal(got, want)
    ds = SlotDataset(port_feed_conf())
    ds.set_filelist(run["files"][:1])
    ds.load_into_memory()
    np.testing.assert_array_equal(got, ds.extract_keys())


def rows_by_key(keys, values, state):
    order = np.argsort(keys)
    return keys[order], values[order], state[order]


def port_rows(t):
    keys = t.row_keys()[1:]
    return rows_by_key(keys, t.values[1:t._size].numpy(),
                       t.state[1:t._size].numpy())


def ref_rows(jt):
    keys = jt._index.dump_keys(jt._size)[1:]
    return rows_by_key(keys, np.asarray(jt.values)[1:jt._size],
                       np.asarray(jt.state)[1:jt._size])


def port_resume(root, engine):
    t = DeviceTable(TableConfig(**TABLE), capacity=1, device="cpu",
                    **ENGINES[engine])
    model = DeepFM(3 * 7 + 3, HIDDEN)
    template = (model, make_dense_optimizer(TrainerConfig()).init(model))
    pm = port_pm(t, root)
    day, pass_id, dense = pm.resume(dense_template=template)
    pm.close()
    assert dense is template
    return (day, pass_id), t, dense_arrays(dense)


def ref_resume(root, engine, template):
    jt = JaxDeviceTable(JaxTableConfig(**TABLE), capacity=CAPACITY,
                        **ENGINES[engine])
    pm = RefPassManager(RefSparsePS({"embedding": jt}), root,
                        [JaxSlotDataset(jax_feed_conf())])
    day, pass_id, dense = pm.resume(dense_template=template)
    pm.close()
    return (day, pass_id), jt, pytree_arrays(dense)


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("trail", ["ref", "port"])
def test_resume_across_packages(engine, trail, loops):
    """The same trail resumed by each package: the version, the rows by
    key and the dense leaves exact, and the dirty rows (the last delta's
    keys, marked by ``load_delta`` after ``load`` cleared) the same."""
    run = loops(engine)
    root = run[trail]["root"]
    pv, pt, pdense = port_resume(root, engine)
    rv, jt, rdense = ref_resume(root, engine, run["ref"]["template"])
    assert pv == rv == (DAY2, 3)
    for a, b in zip(port_rows(pt), ref_rows(jt)):
        np.testing.assert_array_equal(a, b)
    assert list(pdense) == list(rdense)
    for k in rdense:
        np.testing.assert_array_equal(pdense[k], rdense[k], err_msg=k)
    with np.load(os.path.join(root, f"{DAY2}/00003/delta/embedding.npz")) \
            as d:
        np.testing.assert_array_equal(dirty_keys(pt), np.sort(d["keys"]))
    np.testing.assert_array_equal(dirty_keys(pt), dirty_keys(jt))
    if trail == "port":
        # the base's dense leaves are the live trainer's at the base save
        # (the port's base holds the port trainer's dense state)
        with np.load(os.path.join(root, f"{DAY1}/00002/base/dense.npz")) \
                as d:
            for k in d.files:
                np.testing.assert_array_equal(pdense[k], d[k])


def crash_trail(root, ps, pm_cls, writer_cls, flt, datasets, files):
    """One pass whose delta commit crashes mid-write: the writer dies, the
    next ``end_pass`` raises the crash, no record and no committed dir
    are left; a new manager sweeps the staging spill."""
    writer = writer_cls()
    pm = pm_cls(ps, root, datasets, writer=writer)
    pm.set_date(DAY1)
    pm.begin_pass(files[1:2])
    flt.arm("delta.mid_write")
    pm.end_pass(save_delta=True)
    deadline = time.monotonic() + 30
    while writer.alive() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not writer.alive()
    pm.begin_pass(files[2:3])
    with pytest.raises(flt.InjectedCrash):
        pm.end_pass(save_delta=True)
    day_dir = os.path.join(root, DAY1, "00001")
    (spill,) = os.listdir(day_dir)
    assert spill.startswith("delta.tmp-")
    assert os.listdir(os.path.join(day_dir, spill)) == ["embedding.npz"]
    writer.close(drain=False)
    pm_cls(ps, root, datasets).close()
    listing = sorted(os.path.relpath(os.path.join(d, f), root)
                     for d, dirs, fs in os.walk(root) for f in dirs + fs)
    return listing


def test_crash_mid_write_leaves_the_same_trail(tmp_path, files):
    conf = dict(TABLE, seed=5)
    jt = JaxDeviceTable(JaxTableConfig(**conf), capacity=CAPACITY,
                        backend="numpy")
    pt = DeviceTable(TableConfig(**conf), capacity=CAPACITY, device="cpu",
                     backend="numpy")
    got = crash_trail(str(tmp_path / "port"), SparsePS({"embedding": pt}),
                      PassManager, AsyncCheckpointWriter, faults,
                      [SlotDataset(port_feed_conf())], files)
    want = crash_trail(str(tmp_path / "ref"),
                       RefSparsePS({"embedding": jt}), RefPassManager,
                       RefWriter, ref_faults,
                       [JaxSlotDataset(jax_feed_conf())], files)
    assert got == want == [DAY1, f"{DAY1}/00001"]
    assert donefile.read_done(str(tmp_path / "port")) == []


def port_only_world(root, **kw):
    torch.manual_seed(0)
    t = DeviceTable(TableConfig(**TABLE), capacity=CAPACITY, device="cpu",
                    backend="numpy")
    tr = CTRTrainer(DeepFM(3 * 7 + 3, HIDDEN), port_feed_conf(),
                    TableConfig(**TABLE), TrainerConfig(), table=t)
    return tr, port_pm(t, root, **kw)


def test_retention_keeps_one_base(tmp_path, files):
    tr, pm = port_only_world(str(tmp_path), keep_bases=1)
    bases = []
    for day, f in ((DAY1, files[1]), (DAY2, files[2])):
        pm.set_date(day)
        tr.train_from_dataset(pm.begin_pass([f]))
        pm.end_pass(save_delta=True)
        bases.append(pm.save_base(dense_state=(tr.params, tr.opt_state),
                                  wait=True))
    pm.close()
    assert not os.path.exists(bases[0]) and os.path.isdir(bases[1])
    assert sorted(os.listdir(tmp_path)) == [DAY2, donefile.DONEFILE]
    assert [r["kind"] for r in donefile.read_done(str(tmp_path))] == \
        ["delta", "base", "delta", "base"]
    (base, deltas), = donefile.resume_candidates(str(tmp_path))
    assert base["path"] == bases[1] and deltas == []


def test_training_after_a_save_leaves_its_files_unchanged(tmp_path, files):
    """The writer is held while another pass trains: the delta and the
    base (with its dense state) it then writes are the state at the save,
    not the live arena or module."""
    writer = AsyncCheckpointWriter()
    tr, pm = port_only_world(str(tmp_path), writer=writer)
    gate = threading.Event()
    writer.submit("hold", gate.wait)
    pm.set_date(DAY1)
    tr.train_from_dataset(pm.begin_pass(files[1:2]))
    pm.end_pass(save_delta=True)
    t = tr.table
    at_save = (t.row_keys(), t.values.clone(), t.state.clone())
    dense_at_save = dense_arrays((tr.params, tr.opt_state))
    base = pm.save_base(dense_state=(tr.params, tr.opt_state))
    tr.train_from_dataset(pm.begin_pass(files[2:3]))
    pm.end_pass()
    assert writer.pending() == 3 and not gate.is_set()
    gate.set()
    pm.barrier()
    keys, values, state = at_save
    pos = {int(k): i for i, k in enumerate(keys)}
    for rel in (f"{DAY1}/00001/delta", f"{DAY1}/00001/base"):
        with np.load(os.path.join(tmp_path, rel, "embedding.npz")) as d:
            rows = [pos[int(k)] for k in d["keys"]]
            np.testing.assert_array_equal(d["values"], values[rows].numpy())
            np.testing.assert_array_equal(d["state"], state[rows].numpy())
            assert not np.array_equal(d["values"], t.values[rows].numpy())
    with np.load(os.path.join(base, "dense.npz")) as d:
        for k, v in dense_at_save.items():
            np.testing.assert_array_equal(d[k], v)
    pm.close()


def test_refusals(tmp_path, monkeypatch):
    # a host EmbeddingTable is a table of the PS (its training half is
    # ported): the feed pass creates the keys, end_pass decays, shrink
    # evicts, and its snapshot is a file of the dir
    host = EmbeddingTable(TableConfig(**dict(TABLE, show_clk_decay=0.5)),
                          backend="numpy")
    hps = SparsePS({"h": host})
    hps.feed_pass({"h": np.array([0, 3, 7, 3], np.uint64)})
    assert hps.num_features() == {"h": 2}
    hps.prefetch_pass({"h": np.array([9], np.uint64)})   # stages at feed
    host.push(np.array([3], np.uint64), np.ones((1, host.dim), np.float32))
    hps.end_pass()
    np.testing.assert_array_equal(host.pull(np.array([3], np.uint64))[:, :2],
                                  [[0.5, 0.5]])
    (name, snap), = hps.snapshot_files("base").items()
    assert name == "h.npz" and snap["keys"].tolist() == [3, 7]
    assert hps.shrink() == 1 and len(host) == 1      # key 7 never showed
    with pytest.raises(TypeError, match="SparsePS takes"):
        SparsePS({"e": object()})
    t = DeviceTable(TableConfig(**TABLE), capacity=8, device="cpu",
                    backend="numpy")
    ps = SparsePS({"e": t})
    # fix_dayid, once refused, pins the day
    # (tests/test_torch_compat.py holds it to the reference)
    monkeypatch.setenv("PBOX_FLAGS_fix_dayid", "20260101")
    pm = PassManager(ps, str(tmp_path), [SlotDataset(port_feed_conf())])
    pm.set_date("20990909")
    assert pm.day == "20260101"
    pm.close()
    monkeypatch.delenv("PBOX_FLAGS_fix_dayid")
    # the int8 serving export, once refused, builds
    # (tests/test_torch_serving_econ.py holds it to the reference)
    monkeypatch.setenv("PBOX_FLAGS_serve_quantized", "1")
    pm = PassManager(ps, str(tmp_path), [SlotDataset(port_feed_conf())])
    pm.begin_pass([])
    with pytest.raises(RuntimeError, match="still open"):
        ps.begin_pass(2)
    assert pm.resume() is None
    assert ps.num_features() == {"e": 0} and ps.shrink() == 0
    ps.prefetch_pass({"e": np.zeros(1, np.uint64)})     # stages at feed
    assert ps.memory_bytes() == t.memory_bytes()
    with pytest.raises(KeyError):
        ps.prefetch_pass({"nope": np.zeros(1, np.uint64)})
    pm.close()


# -- a tiered table under the pass loop ---------------------------------------

def tiered_flow(files, root, prefetch, trainer=None, engine="device",
                disk=False):
    """The reference's ``TestTieredPassFlow`` loop over a port
    ``TieredDeviceTable``: pass 1 stages, the next file preloads (and, with
    ``prefetch``, its staging starts), pass 1 ends and writes back, pass 2
    takes the preloaded buffer. ``trainer``: (model) trains each pass
    through ``CTRTrainer.train_from_dataset``. ``disk``: the backing over
    a ``DiskTier``, every row spilled and the disk compacted after pass 1
    (pass 2 then restages from disk, its prefetch reading on the tier
    worker), and the disk's rows staged back into the backing at the end.
    Returns the backing by key, W of pass 2, whether the consume took the
    buffers and the losses."""
    conf = TableConfig(**dict(TABLE, show_clk_decay=0.9))
    backing = EmbeddingTable(conf, backend=ENGINES[engine]["backend"])
    tier = DiskTier(backing, root + "-ssd") if disk else None
    table = TieredDeviceTable(conf, backing=backing, capacity=1 << 12,
                              device="cpu", disk=tier, **ENGINES[engine])
    tr = None
    if trainer is not None:
        tr = CTRTrainer(trainer, port_feed_conf(), conf, TrainerConfig(),
                        table=table)
        assert tr.step.device_prep == (engine == "device")
    pm = port_pm(table, root)
    pm.set_date(DAY1)
    losses = []
    handler = lambda step, loss, preds: losses.append(loss)
    ds = pm.begin_pass(files[1:2])
    assert table.in_pass and table.staged_keys.size > 0
    pm.preload_next(files[3:4])
    consumed = []
    if prefetch:
        orig = table._consume_prefetch

        def spy(uniq):
            out = orig(uniq)
            consumed.append(out is not None)
            return out

        table._consume_prefetch = spy
        pm.prefetch_feed_next()
    if tr is not None:
        tr.train_from_dataset(ds, fetch_handler=handler)
    pm.end_pass(save_delta=True)
    if tier is not None:
        assert tier.evict_cold(show_threshold=np.inf) > 0
        tier.compact()
    ds = pm.begin_pass([], preloaded=True)
    assert table.in_pass
    w2 = table.staged_keys.size
    if tr is not None:
        tr.train_from_dataset(ds, fetch_handler=handler)
    pm.end_pass(save_delta=True)
    pm.save_base(wait=True)
    pm.close()
    if tier is not None:
        assert len(tier) > 0
        tier.stage(np.sort(tier._index.live_items()[0]))
    snap = table.backing.snapshot(reset_dirty=False)
    order = np.argsort(snap["keys"])
    rows = tuple(snap[k][order] for k in ("keys", "values", "state",
                                          "embedx_ok"))
    return rows, w2, consumed, losses


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_tiered_pass_flow_prefetch_equals_sync(engine, files, tmp_path):
    """``prefetch_feed_next`` over a tiered table: the staging of pass 2
    runs on the tier worker while pass 1 trains, ``begin_pass(preloaded=
    True)`` consumes it (a spy on ``_consume_prefetch``), and the backing
    equals the synchronous flow's bit for bit, as do the losses."""
    model = DeepFM(3 * 7 + 3, HIDDEN)
    twin = DeepFM(3 * 7 + 3, HIDDEN)
    twin.load_state_dict(model.state_dict())
    a, wa, ca, la = tiered_flow(files, str(tmp_path / "sync"), False,
                                trainer=model, engine=engine)
    b, wb, cb, lb = tiered_flow(files, str(tmp_path / "pre"), True,
                                trainer=twin, engine=engine)
    assert ca == [] and cb == [True]
    assert wa == wb > 0 and len(la) == len(lb) > 0
    assert np.array_equal(la, lb)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    # the file pass 2 drew from holds new keys, created in the backing
    assert a[0].size > wa


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_tiered_disk_pass_flow_prefetch_equals_sync(engine, files,
                                                    tmp_path):
    """The same loop over a disk tier (``SparsePS.prefetch_pass`` and
    ``PassManager.prefetch_feed_next`` down to the disk path: pass 2's
    earlier keys read from disk on the tier worker, the rows pass 1's end
    spilled after the export restaged at consume): the prefetch consumed,
    and the losses and the backing with the disk's rows folded back equal
    the synchronous flow's bit for bit."""
    model = DeepFM(3 * 7 + 3, HIDDEN)
    twin = DeepFM(3 * 7 + 3, HIDDEN)
    twin.load_state_dict(model.state_dict())
    a, wa, ca, la = tiered_flow(files, str(tmp_path / "sync"), False,
                                trainer=model, engine=engine, disk=True)
    b, wb, cb, lb = tiered_flow(files, str(tmp_path / "pre"), True,
                                trainer=twin, engine=engine, disk=True)
    assert ca == [] and cb == [True]
    assert wa == wb > 0 and np.array_equal(la, lb)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_tiered_pass_flow_matches_reference(files, tmp_path):
    """The reference's own ``TestTieredPassFlow`` loop (no training) in
    both packages: the same W, the same backing bit for bit (staging is
    the host table's numpy, the init ``key_init_uniform``)."""
    from paddlebox_tpu.ps.tiered_table import TieredDeviceTable as JaxTiered
    got, w, consumed, _ = tiered_flow(files, str(tmp_path / "port"), True)
    jt = JaxTiered(JaxTableConfig(**dict(TABLE, show_clk_decay=0.9)),
                   capacity=1 << 12, **ENGINES["device"])
    pm = RefPassManager(RefSparsePS({"embedding": jt}), str(tmp_path / "r"),
                        [JaxSlotDataset(jax_feed_conf()),
                         JaxSlotDataset(jax_feed_conf())])
    pm.set_date(DAY1)
    pm.begin_pass(files[1:2])
    pm.preload_next(files[3:4])
    pm.prefetch_feed_next()
    pm.end_pass(save_delta=True)
    pm.begin_pass([], preloaded=True)
    assert jt.staged_keys.size == w and consumed == [True]
    pm.end_pass(save_delta=True)
    pm.save_base(wait=True)
    pm.close()
    bt = jt.backing
    keys = bt._index.dump_keys(bt._size)
    order = np.argsort(keys)
    want = (keys[order], bt._values[:bt._size][order],
            bt._state[:bt._size][order], bt._embedx_ok[:bt._size][order])
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    # each package's trail resumes into the other's tiered table
    for root in (str(tmp_path / "port"), str(tmp_path / "r")):
        t = TieredDeviceTable(TableConfig(**TABLE), capacity=64,
                              device="cpu", backend="numpy")
        rpm = port_pm(t, root)
        assert rpm.resume() == (DAY1, 2, None)
        rpm.close()
        snap = t.backing.snapshot(reset_dirty=False)
        order = np.argsort(snap["keys"])
        np.testing.assert_array_equal(snap["keys"][order], want[0])
        np.testing.assert_array_equal(snap["values"][order], want[1])
