"""Port's chunked and streamed entries (``FusedTrainStep.train_chunk``,
``train_stream``) and ``CTRTrainer.train_from_files``, on the CPU with the
kernels' plain versions, against the JAX package's on the same batches and
files, from the same dense weights (converted) and the same arena (carried
by ``load_arena``). Every table is native with one index thread, so rows
are numbered alike and arenas compare array for array; capacities outlast
the streams, so no arena grows (a port-only test grows one inside a run).

The stream: 16 batches of one key shape, 4 more, 2 of another shape (the
shape change ends a run), 16 of the first, then a short last batch whose
padding rows are masked: two full runs of ``DEV_CHUNK`` = 16 and three
short ones. Vocabulary past the prepopulated rows brings new keys into
every batch.

Tolerances: losses per step, dense params and the AUC's float sums rtol
1e-5 (dense params also atol 1e-6, for weights near 0); rows show/clk,
keys, the AUC's bucket counts, ``count`` and ``label_sum`` exact, the rest
of the rows atol 1e-5; ``train_from_files`` pass metrics ``ins_num``
exact, the rest rtol 1e-5 (with ``workers=2`` and with ``pipe_command``
too). Port against port (the run path against the
per-batch path, ``train_from_files`` against ``train_from_dataset``) is
exact, by key."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import make_slot_file
from paddlebox_tpu.config import BucketSpec as JaxBucketSpec
from paddlebox_tpu.config import DataFeedConfig as JaxFeedConfig
from paddlebox_tpu.config import SlotConfig as JaxSlotConfig
from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.config import TrainerConfig as JaxTrainerConfig
from paddlebox_tpu.models import DeepFM as FlaxDeepFM
from paddlebox_tpu.ps import native as ref_native
from paddlebox_tpu.ps.device_table import DeviceTable as JaxDeviceTable
from paddlebox_tpu.trainer import fused_step as ref_fused_step
from paddlebox_tpu.trainer import trainer as ref_trainer
from paddlebox_tpu.trainer.fused_step import FusedTrainStep as JaxStep
from paddlebox_tpu_torch.config import (BucketSpec, DataFeedConfig,
                                        TableConfig, TrainerConfig)
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.data.device_feed import DeviceFeed
from paddlebox_tpu_torch.data.fast_feed import FastSlotReader
from paddlebox_tpu_torch.models.convert import (deepfm_from_flax_leaves,
                                                flax_leaves_from_deepfm)
from paddlebox_tpu_torch.ps.device_table import DeviceTable
from paddlebox_tpu_torch.trainer import fused_step as port_fused_step
from paddlebox_tpu_torch.trainer import trainer as port_trainer
from paddlebox_tpu_torch.trainer.fused_step import FusedTrainStep
from paddlebox_tpu_torch.trainer.trainer import CTRTrainer

pytestmark = pytest.mark.skipif(not ref_native.available(),
                                reason="native backend unavailable")

B, S, DD, EDIM = 8, 3, 2, 4
HIDDEN = (16,)
AUC_BUCKETS = 1 << 10
TABLE = dict(embedx_dim=EDIM, cvm_offset=3, embedx_threshold=0.0,
             initial_range=0.05, learning_rate=0.05, seed=11)
TRAIN = dict(dense_optimizer="adam", dense_learning_rate=1e-3)
PREPOP = 300
VOCAB = 420          # keys above the prepopulated rows are new
CAPACITY = 4096
NPAD_A, NPAD_B = 64, 128
# (batches, key shape) in stream order; the last batch is short
STREAM = ((16, NPAD_A), (4, NPAD_A), (2, NPAD_B), (16, NPAD_A), (1, NPAD_A))


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


def make_stream(seed=0, vocab=VOCAB):
    """The module's stream as (keys, segment_ids, cvm_in, labels, dense,
    row_mask) tuples: shape A holds 1-2 keys a slot, shape B 3-5, keys
    below ``vocab``."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (n, npad) in enumerate(STREAM):
        for _ in range(n):
            rows = 5 if i == len(STREAM) - 1 else B
            lengths = np.zeros((B, S), np.int64)
            lengths[:rows] = (rng.integers(1, 3, size=(rows, S))
                              if npad == NPAD_A else
                              rng.integers(3, 6, size=(rows, S)))
            k = int(lengths.sum())
            keys = np.zeros(npad, np.uint64)
            keys[:k] = rng.integers(1, vocab, size=k)
            segs = np.full(npad, B * S, np.int32)
            segs[:k] = np.repeat(np.arange(B * S, dtype=np.int32),
                                 lengths.ravel())
            labels = np.zeros(B, np.float32)
            labels[:rows] = rng.integers(0, 2, size=rows)
            cvm = np.stack([np.ones(B, np.float32), labels], axis=1)
            dense = np.zeros((B, DD), np.float32)
            dense[:rows] = rng.normal(size=(rows, DD))
            mask = np.zeros(B, np.float32)
            mask[:rows] = 1.0
            out.append((keys, segs, cvm, labels, dense, mask))
    return out


def jax_table():
    jt = JaxDeviceTable(JaxTableConfig(**TABLE), capacity=CAPACITY,
                        backend="native", index_threads=1)
    jt.prepopulate(PREPOP)
    return jt


def port_table(jt):
    pt = DeviceTable(TableConfig(**TABLE), capacity=1, device="cpu",
                     backend="native", index_threads=1)
    pt.load_arena(np.asarray(jt.values), np.asarray(jt.state),
                  jt._index.dump_keys(jt._size))
    return pt


def worlds(device_prep):
    """The reference's step and the port's over tables holding the same
    arena and rows, from the same weights."""
    jt = jax_table()
    jfs = JaxStep(FlaxDeepFM(hidden=HIDDEN), jt, JaxTrainerConfig(**TRAIN),
                  B, S, dense_dim=DD, num_auc_buckets=AUC_BUCKETS,
                  device_prep=device_prep)
    jp, jo = jfs.init(jax.random.PRNGKey(3))
    pt = port_table(jt)
    pfs = FusedTrainStep(deepfm_from_flax_leaves(leaves_of(jp), HIDDEN), pt,
                         TrainerConfig(**TRAIN), B, S, dense_dim=DD,
                         num_auc_buckets=AUC_BUCKETS,
                         device_prep=device_prep)
    return ((jfs, jt, [jp, jo, jfs.init_auc_state()]),
            (pfs, pt, [*pfs.init(), pfs.init_auc_state()]))


def assert_arena_equal(pt, jt):
    """Array for array: the same keys at the same rows, show/clk exact,
    the rest atol 1e-5."""
    assert len(pt) == len(jt)
    n = len(pt) + 1
    np.testing.assert_array_equal(pt.row_keys()[1:],
                                  jt._index.dump_keys(n)[1:])
    pv, jv = pt.values[:n].numpy(), np.asarray(jt.values)[:n]
    np.testing.assert_array_equal(pv[:, :2], jv[:, :2])
    np.testing.assert_allclose(pv, jv, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pt.state[:n].numpy(),
                               np.asarray(jt.state)[:n], rtol=0, atol=1e-5)


def assert_state_matches(ps, js):
    """Dense params rtol 1e-5; the AUC state: bucket counts, count and
    label_sum exact, the float sums rtol 1e-5."""
    for got, want in zip(flax_leaves_from_deepfm(ps[0]), leaves_of(js[0])):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    pa, ja = ps[2], js[2]
    assert set(pa) == set(ja)
    for f in ("pos", "neg", "count", "label_sum"):
        np.testing.assert_array_equal(pa[f].numpy(), np.asarray(ja[f]),
                                      err_msg=f)
    for f in ("abs_err", "sq_err", "pred_sum"):
        np.testing.assert_allclose(pa[f].numpy(), np.asarray(ja[f]),
                                   rtol=1e-5, err_msg=f)


def flat_losses(calls):
    """``on_step`` calls -> one loss a step (the reference's chunk path
    reports a run's [K] losses at once)."""
    out = []
    for _, loss in calls:
        out.extend(np.atleast_1d(np.asarray(loss)).tolist())
    return out


def test_collect_same_shape_run_matches_reference():
    stream = make_stream()
    shape = [b[0].shape for b in stream]
    for k in (1, 3, 16):
        got, want = [], []
        for fn, out in ((port_fused_step.collect_same_shape_run, got),
                        (ref_fused_step.collect_same_shape_run, want)):
            it, pending = iter(range(len(stream))), None
            items = ((stream[i][0], i) for i in it)
            while True:
                run, pending = fn(items, pending, k)
                if not run:
                    break
                out.append([i for _, i in run])
        assert got == want
        assert all(len({shape[i] for i in run}) == 1 for run in got)
    assert [len(r) for r in got] == [16, 4, 2, 16, 1]


@pytest.mark.parametrize("device_prep", [True, False],
                         ids=["device_prep", "host_prep"])
def test_train_stream_matches_reference(device_prep):
    """The whole stream through ``train_stream``: losses step by step, the
    step count, dense params, the AUC state and the arena."""
    (jfs, jt, js), (pfs, pt, ps) = worlds(device_prep)
    stream = make_stream()
    jcalls, pcalls = [], []
    per_batch = []
    step_device = pfs.step_device
    pfs.step_device = lambda *a: (per_batch.append(a[3].shape),
                                  step_device(*a))[1]
    *js, jloss, jsteps = jfs.train_stream(
        *js, iter(stream), on_step=lambda s, l: jcalls.append((s, l)))
    *ps, loss, steps = pfs.train_stream(
        *ps, iter(stream), on_step=lambda s, l: pcalls.append((s, l)))
    assert steps == jsteps == len(stream)
    # the two full runs step over the run's views; the short runs (4, 2
    # and the last batch) go batch by batch
    assert per_batch == ([(NPAD_A,)] * 4 + [(NPAD_B,)] * 2 + [(NPAD_A,)]
                         if device_prep else [])
    assert [s for s, _ in pcalls] == list(range(1, len(stream) + 1))
    assert all(l.dim() == 0 for _, l in pcalls)
    np.testing.assert_allclose(flat_losses(pcalls), flat_losses(jcalls),
                               rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert_state_matches(ps, js)
    assert_arena_equal(pt, jt)
    assert len(pt) > PREPOP
    assert not bool(pfs.bad_flag)


def test_train_chunk_matches_reference():
    """Host prep, each same-shape run of the stream as one ``train_chunk``
    (which prepares all its batches' rows before its first step)."""
    (jfs, jt, js), (pfs, pt, ps) = worlds(False)
    it, pending = iter(make_stream()), None
    while True:
        run, pending = port_fused_step.collect_same_shape_run(it, pending,
                                                              16)
        if not run:
            break
        cols = list(zip(*run))
        *js, jlosses, jpreds = jfs.train_chunk(*js, *cols)
        *ps, losses, preds = pfs.train_chunk(*ps, *cols)
        assert losses.shape == (len(run),) and preds.shape == (len(run), B)
        np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                                   rtol=1e-5)
        np.testing.assert_allclose(preds.numpy(), np.asarray(jpreds),
                                   rtol=1e-5, atol=1e-6)
    assert_state_matches(ps, js)
    assert_arena_equal(pt, jt)


def test_stream_run_sees_arena_growth_and_index_rehash():
    """A run whose ``ensure_keys`` grows the arena and rehashes the host
    map (a new mirror table) before its first step: the steps read the
    new tensors. Against the per-batch ``step_device`` on a twin table,
    exact, by key. Both tables grow once, to the same capacity, so new
    rows start from the same init."""
    def world():
        t = DeviceTable(TableConfig(**TABLE), capacity=500, device="cpu",
                        backend="native", index_threads=1)
        t.prepopulate(PREPOP)
        fs = FusedTrainStep(deepfm_from_flax_leaves(init, HIDDEN), t,
                            TrainerConfig(**TRAIN), B, S, dense_dim=DD,
                            num_auc_buckets=AUC_BUCKETS, device_prep=True)
        return fs, t, [*fs.init(), fs.init_auc_state()]

    init = leaves_of(JaxStep(FlaxDeepFM(hidden=HIDDEN), jax_table(),
                             JaxTrainerConfig(**TRAIN), B, S,
                             dense_dim=DD).init(jax.random.PRNGKey(3))[0])
    stream = make_stream(seed=5, vocab=4000)[:16]
    rfs, rt, rs = world()
    gen, tab = rt.mirror.generation, rt.mirror.tab
    *rs, _, steps = rfs.train_stream(*rs, iter(stream))
    assert steps == 16 and rt.capacity == 1000
    assert rt.mirror.generation > gen and rt.mirror.tab is not tab
    bfs, bt, bs = world()
    for batch in stream:
        *bs, _, _ = bfs.step_device(*bs, *batch)
    assert bt.capacity == 1000
    for got, want in zip(flax_leaves_from_deepfm(rs[0]),
                         flax_leaves_from_deepfm(bs[0])):
        np.testing.assert_array_equal(got, want)
    for f in rs[2]:
        np.testing.assert_array_equal(rs[2][f].numpy(), bs[2][f].numpy())
    assert_same_rows_by_key(rt, bt)


def assert_same_rows_by_key(a, b):
    sa, sb = a.snapshot(), b.snapshot()
    oa, ob = np.argsort(sa["keys"]), np.argsort(sb["keys"])
    np.testing.assert_array_equal(sa["keys"][oa], sb["keys"][ob])
    np.testing.assert_array_equal(sa["values"][oa], sb["values"][ob])
    np.testing.assert_array_equal(sa["state"][oa], sb["state"][ob])


def test_train_stream_refusals():
    """``feed=`` (the staged device feed) on host prep raises the
    reference's ``ValueError``; ``final_poll`` is accepted and does
    nothing; an empty stream takes no step, staged or not."""
    _, (hfs, _, hs) = worlds(False)
    with pytest.raises(ValueError, match="device-prep fused engine"):
        hfs.train_stream(*hs, iter([]), feed=object())
    _, (pfs, _, ps) = worlds(True)
    *_, loss, steps = pfs.train_stream(*ps, iter([]), final_poll=False)
    assert loss is None and steps == 0
    feed = DeviceFeed(pfs, depth=2)
    *_, loss, steps = pfs.train_stream(*ps, iter([]), feed=feed)
    assert loss is None and steps == 0 and feed.ring.held == 0
    with pytest.raises(RuntimeError, match="device_prep=True"):
        worlds(False)[1][0].step_device_tensors(*ps, *([None] * 6))


# -- CTRTrainer.train_from_files -------------------------------------------

FILE_BUCKETS = dict(min_size=NPAD_A, max_size=1 << 12)


def jax_feed_conf():
    """The reference tests' ``feed_conf`` (tests/conftest.py)."""
    return JaxFeedConfig(slots=[
        JaxSlotConfig("label", type="float", is_dense=True, dim=1),
        JaxSlotConfig("slot_a"), JaxSlotConfig("slot_b"),
        JaxSlotConfig("slot_c"),
        JaxSlotConfig("dense_x", type="float", is_dense=True, dim=DD),
    ], batch_size=B, label_slot="label", thread_num=2)


def port_feed_conf(**kw):
    return DataFeedConfig.from_dict({**dataclasses.asdict(jax_feed_conf()),
                                     **kw})


def write_file(path, rows, lo, hi, seed):
    """MultiSlot lines of the feed: 1 label, ``lo``..``hi`` keys a slot
    below VOCAB, DD dense values."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(rows):
            parts = [f"1 {int(rng.integers(0, 2))}"]
            for _ in range(S):
                n = int(rng.integers(lo, hi + 1))
                parts.append(f"{n} " + " ".join(
                    map(str, rng.integers(1, VOCAB, size=n))))
            parts.append(f"{DD} " + " ".join(
                map(str, rng.normal(size=DD).round(4))))
            f.write(" ".join(parts) + "\n")
    return path


@pytest.fixture(scope="module")
def stream_files(tmp_path_factory):
    """16 batches of 1-2 keys a slot (Npad 64), 3 of 4-5 (Npad 256), then
    16 of the first shape and a last batch of 5 rows, in files of 100,
    28, 24 and 133 rows (the first two split a batch)."""
    d = tmp_path_factory.mktemp("stream_files")
    paths = []
    for i, (rows, lo, hi) in enumerate(((100, 1, 2), (28, 1, 2),
                                        (24, 4, 5), (133, 1, 2))):
        paths.append(write_file(str(d / f"part-{i}"), rows, lo, hi, i))
    return paths


def reference_files_run(files, drain):
    """The reference trainer over a native one-thread table: one
    ``train_from_files`` pass with ``AUC_DRAIN_STEPS`` = ``drain``.
    Returns its initial weights and arena and what the pass gave."""
    jt = jax_table()
    arena = (np.asarray(jt.values).copy(), np.asarray(jt.state).copy(),
             jt._index.dump_keys(jt._size))
    tr = ref_trainer.CTRTrainer(
        FlaxDeepFM(hidden=HIDDEN), jax_feed_conf(), JaxTableConfig(**TABLE),
        JaxTrainerConfig(**TRAIN), table=jt,
        buckets=JaxBucketSpec(**FILE_BUCKETS))
    assert tr.step.device_prep
    init = leaves_of(tr.params)
    saved, ref_trainer.AUC_DRAIN_STEPS = ref_trainer.AUC_DRAIN_STEPS, drain
    try:
        metrics = tr.train_from_files(files, prefetch=2)
    finally:
        ref_trainer.AUC_DRAIN_STEPS = saved
    return dict(init=init, arena=arena, metrics=metrics,
                params=leaves_of(tr.params), table=jt,
                main=tr.timer.count["main"])


def port_files_trainer(ref, trainer_conf=None, **feed_kw):
    table = DeviceTable(TableConfig(**TABLE), capacity=1, device="cpu",
                        backend="native", index_threads=1)
    table.load_arena(*ref["arena"])
    return CTRTrainer(deepfm_from_flax_leaves(ref["init"], HIDDEN),
                      port_feed_conf(**feed_kw), TableConfig(**TABLE),
                      trainer_conf or TrainerConfig(**TRAIN), table=table,
                      buckets=BucketSpec(**FILE_BUCKETS))


@pytest.fixture(scope="module")
def reference_files(stream_files):
    runs = {}

    def get(drain):
        if drain not in runs:
            runs[drain] = reference_files_run(stream_files, drain)
        return runs[drain]
    return get


@pytest.mark.parametrize("drain", [512, 4])
def test_train_from_files_matches_reference(stream_files, reference_files,
                                            monkeypatch, drain):
    """One pass of 36 batches (two full runs, a shape change, a masked
    last batch) with the AUC drained at the pass end, and with
    ``AUC_DRAIN_STEPS`` = 4 in both packages (nine segments of 4, no full
    run): pass metrics, dense params, the arena and the "main" spans."""
    ref = reference_files(drain)
    tr = port_files_trainer(ref)
    drained = []
    drain_auc = tr._drain_auc
    monkeypatch.setattr(tr, "_drain_auc",
                        lambda: (drained.append(tr._step_count), drain_auc()))
    monkeypatch.setattr(port_trainer, "AUC_DRAIN_STEPS", drain)
    metrics = tr.train_from_files(stream_files, prefetch=2)
    assert set(metrics) == set(ref["metrics"])
    assert metrics["ins_num"] == ref["metrics"]["ins_num"] == 285
    for k, want in ref["metrics"].items():
        np.testing.assert_allclose(metrics[k], want, rtol=1e-5, err_msg=k)
    for got, want in zip(flax_leaves_from_deepfm(tr.params), ref["params"]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert_arena_equal(tr.table, ref["table"])
    assert tr.timer.count["main"] == ref["main"] == len(drained)
    assert drained == ([36] if drain == 512 else
                       [4, 8, 12, 16, 20, 24, 28, 32, 36, 36])


def test_train_from_files_equals_train_from_dataset_by_key(
        stream_files, reference_files, capfd):
    """The same files through ``train_from_dataset`` (the record pipeline,
    one batch a step) and ``train_from_files`` (the tokenizer, runs of 16)
    from one init: the same batches, and then the same pass metrics, rows
    by key and dense params, exactly; the profile line as in
    ``train_from_dataset``."""
    ref = reference_files(512)
    conf = TrainerConfig(profile=True, **TRAIN)
    files_tr = port_files_trainer(ref, conf)
    ds_tr = port_files_trainer(ref, conf)
    ds = SlotDataset(port_feed_conf(), buckets=BucketSpec(**FILE_BUCKETS))
    ds.set_filelist(stream_files)
    ds.load_into_memory()
    reader = FastSlotReader(port_feed_conf(),
                            buckets=BucketSpec(**FILE_BUCKETS))
    for a, b in zip(ds.batches(), reader.batches(stream_files), strict=True):
        for f in ("keys", "segment_ids", "lengths", "labels", "dense"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    got = files_tr.train_from_files(stream_files)
    err = capfd.readouterr().err.strip().splitlines()
    assert err[-1] == (f"log_for_profile pass_steps=36 "
                       f"{files_tr.timer.report()}")
    want = ds_tr.train_from_dataset(ds)
    assert got == want
    assert_same_rows_by_key(files_tr.table, ds_tr.table)
    for a, b in zip(files_tr.params.parameters(), ds_tr.params.parameters()):
        assert torch.equal(a, b)


def _files_trainer(tmp_path, **feed_kw):
    t = DeviceTable(TableConfig(**TABLE), capacity=64, device="cpu",
                    backend="native", index_threads=1)
    return CTRTrainer(torch.nn.Linear(1, 1), port_feed_conf(**feed_kw),
                      TableConfig(**TABLE), TrainerConfig(), table=t)


FILE_REFUSALS = {
    "logkey": (dict(parse_logkey=True), {}, ValueError, "logkey"),
    "ins_id": (dict(parse_ins_id=True), {}, ValueError, "ins_id"),
    "sample_rate": (dict(sample_rate=0.5), {}, ValueError, "sample_rate"),
}
# options once refused here (ROADMAP A.2d, ported): each case trains the
# stream's files as the reference's pass does (workers=1, no pipe) and as
# the port's plain pass does, bit for bit
FILE_PORTED = {"workers": ({}, dict(workers=2)),
               "pipe_command": (dict(pipe_command="cat"), {})}


@pytest.mark.parametrize("what", sorted(FILE_REFUSALS) + sorted(FILE_PORTED))
def test_train_from_files_refusals(tmp_path, what, stream_files,
                                   reference_files):
    if what in FILE_PORTED:
        feed_kw, call_kw = FILE_PORTED[what]
        ref = reference_files(512)
        tr = port_files_trainer(ref, **feed_kw)
        metrics = tr.train_from_files(stream_files, **call_kw)
        assert metrics["ins_num"] == ref["metrics"]["ins_num"] == 285
        for k, want in ref["metrics"].items():
            np.testing.assert_allclose(metrics[k], want, rtol=1e-5,
                                       err_msg=k)
        for got, want in zip(flax_leaves_from_deepfm(tr.params),
                             ref["params"]):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        plain = port_files_trainer(ref)
        assert plain.train_from_files(stream_files) == metrics
        assert_same_rows_by_key(tr.table, plain.table)
        for a, b in zip(tr.params.parameters(), plain.params.parameters()):
            assert torch.equal(a, b)
        return
    feed_kw, call_kw, err, match = FILE_REFUSALS[what]
    path = make_slot_file(str(tmp_path / "part-0"), jax_feed_conf(), 8)
    tr = _files_trainer(tmp_path, **feed_kw)
    with pytest.raises(err, match=match):
        tr.train_from_files([path], **call_kw)
    assert tr._step_count == 0
