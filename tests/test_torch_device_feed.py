"""Port's staged device feed (``data/device_feed.py``, the staged consumer
``FusedTrainStep._train_stream_staged`` and ``step_cols_tensors``) on the
CPU, with the kernels' plain versions, against the JAX package's feed and
against the port's unstaged stream.

- The wire: rows packed by the port (its C pass and its numpy twin) equal
  the reference's ``pack_cols_row`` byte for byte, and ``unpack_cols_row``
  the reference's, on seeded slices (a short last batch, dense on and
  off).
- The ring and the feed as the reference's tests hold them: backpressure,
  ``close``/``stop`` waking a blocked producer, failure poisoning, pins
  released with their slot and not before, depth and buffer validation,
  the refusal of host prep.
- The staged stream against the unstaged one, bit for bit (losses, dense
  params, adam's state, the AUC state, rows by key), at depths 1, 2 and 3
  over a bucket switch and a short last batch, through the run graphs'
  stand-in (``test_torch_step_graph.py``), and in "deferred" mode.
- ``CTRTrainer.train_from_files`` under ``PBOX_FLAGS_feed_device_prefetch``
  against the reference's staged pass on the same files from converted
  params: pass metrics (``ins_num`` exact), dense params rtol 1e-5 (atol
  1e-6), the arena array for array (show/clk exact, the rest atol 1e-5),
  as ``test_torch_stream.py`` holds the unstaged pass; and against the
  port's unstaged pass bit for bit.
"""

import threading
import time

import numpy as np
import pytest
import torch

from paddlebox_tpu import flags as ref_flags
from paddlebox_tpu.config import BucketSpec as JaxBucketSpec
from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.config import TrainerConfig as JaxTrainerConfig
from paddlebox_tpu.data import device_feed as ref_feed
from paddlebox_tpu.data.fast_feed import ColumnarSlice as JaxSlice
from paddlebox_tpu.models import DeepFM as FlaxDeepFM
from paddlebox_tpu.ps import native as ref_native
from paddlebox_tpu.trainer import trainer as ref_trainer
from paddlebox_tpu_torch.config import feed_prefetch_conf
from paddlebox_tpu_torch.data.device_feed import (DeviceFeed, FeedStopped,
                                                  StagedChunk, StagingRing,
                                                  TailBatches, pack_cols_row,
                                                  pack_cols_row_numpy,
                                                  unpack_cols_row, wire_len)
from paddlebox_tpu_torch.data.fast_feed import ColumnarSlice
from paddlebox_tpu_torch.models.convert import flax_leaves_from_deepfm
from paddlebox_tpu_torch.ps import native
from paddlebox_tpu_torch.trainer import step_graph
from test_torch_step_graph import ReplayingRunGraph, world
from test_torch_stream import (B, DD, FILE_BUCKETS, PREPOP,
                               TABLE, TRAIN, assert_arena_equal,
                               assert_same_rows_by_key, jax_feed_conf,
                               jax_table, leaves_of, port_files_trainer,
                               stream_files)

pytestmark = pytest.mark.skipif(not ref_native.available(),
                                reason="native backend unavailable")

S = 3                 # the slots of test_torch_step_graph's world
NPAD_A, NPAD_B = 64, 128


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_slices(rng, n, npad=NPAD_A, partial_last=0, dense_dim=DD,
                key_hi=PREPOP + 1, batch=B, slots=S, lo=1, hi=3):
    """``n`` seeded ``ColumnarSlice``s of ``lo``..``hi`` - 1 keys a slot
    below ``key_hi``; the last has ``partial_last`` rows when given."""
    out = []
    for i in range(n):
        rows = partial_last if partial_last and i == n - 1 else batch
        lengths = rng.integers(lo, hi, size=(rows, slots)).astype(np.int32)
        nk = int(lengths.sum())
        out.append(ColumnarSlice(
            keys=rng.integers(1, key_hi, size=nk).astype(np.uint64),
            lengths=lengths,
            labels=rng.integers(0, 2, size=rows).astype(np.float32),
            dense=rng.normal(size=(rows, dense_dim)).astype(np.float32),
            num_rows=rows, num_keys=nk, npad=npad))
    return out


def as_ref(sl):
    return JaxSlice(keys=sl.keys, lengths=sl.lengths, labels=sl.labels,
                    dense=sl.dense, num_rows=sl.num_rows,
                    num_keys=sl.num_keys, npad=sl.npad)


def legacy_tuple(sl, batch=B, slots=S, dense_dim=DD):
    """The unstaged stream's (keys, segs, cvm, labels, dense, mask) for a
    slice, as ``FastSlotReader.stream`` pads it."""
    BS = batch * slots
    keys = np.zeros(sl.npad, np.uint64)
    keys[:sl.num_keys] = sl.keys
    segs = np.full(sl.npad, BS, np.int32)
    segs[:sl.num_keys] = np.repeat(
        np.arange(BS, dtype=np.int32),
        np.pad(sl.lengths, ((0, batch - sl.num_rows), (0, 0))).reshape(-1))
    labels = np.zeros(batch, np.float32)
    labels[:sl.num_rows] = sl.labels
    dense = np.zeros((batch, dense_dim), np.float32)
    dense[:sl.num_rows] = sl.dense
    mask = np.zeros(batch, np.float32)
    mask[:sl.num_rows] = 1.0
    cvm = np.stack([np.ones(batch, np.float32), labels], axis=1)
    return keys, segs, cvm, labels, dense, mask


class _FakeStep:
    """Just enough of an engine for the feed's own tests."""

    device_prep = True
    DEV_CHUNK = 4
    batch_size = B
    num_slots = S
    dense_dim = DD
    device = torch.device("cpu")


class _FakeLease:
    def __init__(self, pinnable=True):
        self.pinnable = pinnable
        self.pins = 0
        self.releases = 0

    def pin(self):
        if not self.pinnable:
            return False
        self.pins += 1
        return True

    def release(self):
        self.releases += 1


# -- the wire -----------------------------------------------------------------

@pytest.mark.parametrize("dense_dim", [0, 3])
def test_rows_equal_the_references_byte_for_byte(dense_dim):
    """Each slice's row from the port's C pass and from its numpy twin
    equals the reference's, byte for byte, into a reused row (a full row
    first, so stale words must be zeroed); ``unpack_cols_row`` equals the
    reference's and the unstaged stream's tuple."""
    rng = np.random.default_rng(10 + dense_dim)
    slices = (make_slices(rng, 3, dense_dim=dense_dim, key_hi=1 << 62)
              + make_slices(rng, 2, partial_last=5, dense_dim=dense_dim,
                            key_hi=1 << 62))
    slices[1].keys[:4] = np.array([2**64 - 1, 2**63, 2**32, 2**32 - 1],
                                  np.uint64)
    L = wire_len(NPAD_A, B, S, dense_dim)
    assert L == ref_feed.wire_len(NPAD_A, B, S, dense_dim)
    rows = [np.full(L, 0xABCDEF, np.uint32) for _ in range(3)]
    for sl in slices:
        pack_cols_row(sl, B, S, dense_dim, rows[0])
        pack_cols_row_numpy(sl, B, S, dense_dim, rows[1])
        ref_feed.pack_cols_row(as_ref(sl), B, S, dense_dim, rows[2])
        assert rows[0].tobytes() == rows[2].tobytes()
        assert rows[1].tobytes() == rows[2].tobytes()
        got = unpack_cols_row(rows[0], NPAD_A, B, S, dense_dim)
        want = ref_feed.unpack_cols_row(rows[2], NPAD_A, B, S, dense_dim)
        legacy = legacy_tuple(sl, dense_dim=dense_dim)
        for g, w, o in zip(got, want, legacy):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, o)


def test_native_pack_refuses_shapes_it_would_overrun():
    rng = np.random.default_rng(3)
    (sl,) = make_slices(rng, 1)
    row = np.zeros(wire_len(NPAD_A, B, S, DD), np.uint32)
    with pytest.raises(ValueError, match="out size"):
        native.pack_cols(sl.keys, sl.lengths, sl.labels, sl.dense, B, S,
                         DD, NPAD_A, row[:-1])
    with pytest.raises(ValueError, match="exceeds"):
        native.pack_cols(sl.keys, sl.lengths, sl.labels, sl.dense, B, S,
                         DD, 4, np.zeros(wire_len(4, B, S, DD), np.uint32))
    with pytest.raises(ValueError, match="uint32"):
        native.pack_cols(sl.keys, sl.lengths, sl.labels, sl.dense, B, S,
                         DD, NPAD_A, row.view(np.int32))


def test_step_cols_tensors_builds_the_unstaged_inputs(monkeypatch):
    """The device half of a staged batch hands ``step_device_tensors``
    the unstaged stream's inputs exactly (keys with the high bit set,
    padding keys 0 on the discard segment, a short batch's mask)."""
    fs, _, st = world()
    rng = np.random.default_rng(4)
    (sl,) = make_slices(rng, 1, partial_last=5, key_hi=1 << 62)
    sl.keys[0] = np.uint64(2**64 - 1)
    row = np.zeros(fs.wire_len(NPAD_A), np.uint32)
    pack_cols_row(sl, B, S, DD, row)
    seen = []
    monkeypatch.setattr(fs, "step_device_tensors",
                        lambda *a: seen.append(a[3:]))
    fs.step_cols_tensors(*st, torch.from_numpy(row.view(np.int32)), NPAD_A)
    keys, segs, cvm, labels, dense, mask = seen[0]
    want = legacy_tuple(sl)
    assert keys.dtype == torch.int64 and segs.dtype == torch.int32
    np.testing.assert_array_equal(keys.numpy(), want[0].view(np.int64))
    for got, w in zip((segs, cvm, labels, dense, mask), want[1:]):
        assert got.dtype == torch.from_numpy(w).dtype
        np.testing.assert_array_equal(got.numpy(), w)


# -- the ring and the feed ----------------------------------------------------

def test_ring_backpressure_blocks_at_the_cap():
    ring = StagingRing(2)
    s1 = ring.acquire((4, 8), 16)
    s2 = ring.acquire((4, 8), 16)
    got = []
    th = threading.Thread(target=lambda: got.append(
        ring.acquire((4, 8), 16)), daemon=True)
    th.start()
    time.sleep(0.2)
    assert not got and ring.held == 2
    ring.release(s1)
    th.join(timeout=5)
    assert got == [s1] and ring.held == 2
    ring.release(s2)
    ring.release(got[0])
    assert ring.held == 0


def test_ring_reshapes_a_free_slot_at_the_cap():
    """At the cap, a bucket switch takes a free slot of the other shape's
    place (counted in ``reshaped``) instead of waiting; with none free it
    blocks."""
    ring = StagingRing(2)
    s1 = ring.acquire((4, 8), 16)
    s2 = ring.acquire((4, 8), 16)
    ring.release(s2)
    s3 = ring.acquire((4, 12), 24)
    assert tuple(s3.host.shape) == (4, 12) and s3.keys.size == 24
    assert ring.reshaped == 1 and ring.held == 2
    got = []
    th = threading.Thread(target=lambda: got.append(
        ring.acquire((2, 2), 4)), daemon=True)
    th.start()
    time.sleep(0.2)
    assert not got and ring.reshaped == 1
    ring.release(s1)
    th.join(timeout=5)
    assert tuple(got[0].host.shape) == (2, 2) and ring.reshaped == 2
    for s in (s3, got[0]):
        ring.release(s)
    assert ring.held == 0


def test_ring_close_and_stop_wake_the_producer():
    ring = StagingRing(2)
    ring.acquire((2, 2), 4)
    ring.acquire((2, 2), 4)
    err = []

    def blocked():
        try:
            ring.acquire((2, 2), 4)
        except FeedStopped as e:
            err.append(e)

    th = threading.Thread(target=blocked, daemon=True)
    th.start()
    time.sleep(0.1)
    ring.close()
    th.join(timeout=5)
    assert err
    # stop() wakes a producer blocked on the full channel and the ring
    rng = np.random.default_rng(9)
    feed = DeviceFeed(_FakeStep(), depth=1, buffers=2)
    feed.start(iter(make_slices(rng, 40)))
    time.sleep(0.3)
    t0 = time.time()
    feed.stop()
    assert time.time() - t0 < 5.0
    assert feed._thread is None and feed.ring.held == 0


def test_producer_stays_within_ring_and_channel():
    """depth 1, buffers 2 and a stalled consumer: the producer takes at
    most 2 chunks' worth of slices, then the stream completes."""
    rng = np.random.default_rng(3)
    feed = DeviceFeed(_FakeStep(), depth=1, buffers=2)
    K = feed.chunk
    consumed = []

    def counting():
        for sl in make_slices(rng, 10 * K):
            consumed.append(1)
            yield sl

    ch = feed.start(counting())
    time.sleep(0.5)
    assert len(consumed) <= 2 * K + 1
    chunks = 0
    while True:
        item = ch.get(timeout=10)
        if item is None:
            break
        assert isinstance(item, StagedChunk) and item.event is None
        chunks += 1
        feed.retire(item)
    assert chunks == 10
    feed.stop()
    assert feed.ring.held == 0


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_staged_items_decode_to_the_unstaged_batches(depth):
    """The chunks (their device rows decoded) and the tails carry exactly
    the unstaged stream's batches, over a bucket switch and a short last
    batch; each chunk's ``keys`` are its batches' padded keys."""
    rng = np.random.default_rng(4 + depth)
    slices = (make_slices(rng, 9) + make_slices(rng, 3, npad=NPAD_B)
              + make_slices(rng, 5, partial_last=3))
    feed = DeviceFeed(_FakeStep(), depth=depth, buffers=depth + 1)
    got = []
    ch = feed.start(iter(slices))
    while True:
        item = ch.get(timeout=30)
        if item is None:
            break
        if isinstance(item, TailBatches):
            got.extend(item.batches)
            continue
        rows = item.dev.numpy().view(np.uint32)
        batches = [unpack_cols_row(rows[j], item.npad, B, S, DD)
                   for j in range(item.k)]
        np.testing.assert_array_equal(
            item.keys, np.concatenate([b[0] for b in batches]))
        got.extend(batches)
        feed.retire(item)
    feed.stop()
    want = [legacy_tuple(sl) for sl in slices]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for ga, wa in zip(g, w):
            np.testing.assert_array_equal(ga, wa)


def test_producer_failure_poisons_the_channel():
    rng = np.random.default_rng(7)
    good = make_slices(rng, 4)

    def exploding():
        yield from good
        raise RuntimeError("parse exploded mid-stream")

    feed = DeviceFeed(_FakeStep(), depth=2, buffers=3)
    ch = feed.start(exploding())
    seen = 0
    with pytest.raises(RuntimeError, match="parse exploded"):
        while True:
            item = ch.get(timeout=30)
            if item is None:
                break
            seen += item.k
            feed.retire(item)
    assert seen == 4
    feed.stop()
    assert feed.ring.held == 0


def test_pins_go_with_their_slot_and_not_before():
    """A pinned lease is released when the consumer retires its slot, not
    when it is staged; a tail's slot returns at once with its pins; an
    owner that refuses the pin is owed nothing; an aborted producer
    returns its slot's pins."""
    rng = np.random.default_rng(21)
    slices = make_slices(rng, 4)
    lease = _FakeLease()
    for sl in slices:
        sl.owner = lease
    feed = DeviceFeed(_FakeStep(), depth=2, buffers=3)
    ch = feed.start(iter(slices))
    item = ch.get(timeout=30)
    assert ch.get(timeout=30) is None
    assert (lease.pins, lease.releases) == (4, 0)
    feed.retire(item)
    assert lease.releases == 4
    feed.stop()
    # a tail
    tail = make_slices(rng, 2)
    lease = _FakeLease()
    for sl in tail:
        sl.owner = lease
    ch = feed.start(iter(tail))
    assert isinstance(ch.get(timeout=30), TailBatches)
    assert ch.get(timeout=30) is None
    assert lease.pins == lease.releases == 2
    feed.stop()
    # unpinnable
    lease = _FakeLease(pinnable=False)
    for sl in slices:
        sl.owner = lease
    ch = feed.start(iter(slices))
    feed.retire(ch.get(timeout=30))
    assert lease.releases == 0
    feed.stop()
    # an abort mid-stream
    lease = _FakeLease()

    def endless():
        while True:
            (sl,) = make_slices(rng, 1)
            sl.owner = lease
            yield sl

    feed = DeviceFeed(_FakeStep(), depth=1, buffers=2)
    feed.start(endless())
    time.sleep(0.4)
    feed.stop()
    assert lease.pins == lease.releases > 0
    assert feed.ring.held == 0


@pytest.mark.parametrize("depth,buffers,want", [
    ("2", "0", (2, 5)), ("0", "0", (0, 3)), ("3", "4", (3, 4)),
    ("-1", "0", "feed_device_prefetch"), ("3", "3", "feed_staging_buffers")])
def test_flags_resolve_like_the_reference(monkeypatch, depth, buffers,
                                          want):
    from paddlebox_tpu.config import feed_prefetch_conf as ref_conf
    old = (ref_flags.get("feed_device_prefetch"),
           ref_flags.get("feed_staging_buffers"))
    ref_flags.set("feed_device_prefetch", int(depth))
    ref_flags.set("feed_staging_buffers", int(buffers))
    monkeypatch.setenv("PBOX_FLAGS_feed_device_prefetch", depth)
    monkeypatch.setenv("PBOX_FLAGS_feed_staging_buffers", buffers)
    try:
        if isinstance(want, tuple):
            assert feed_prefetch_conf() == ref_conf() == want
        else:
            for fn in (feed_prefetch_conf, ref_conf):
                with pytest.raises(ValueError, match=want):
                    fn()
    finally:
        ref_flags.set("feed_device_prefetch", old[0])
        ref_flags.set("feed_staging_buffers", old[1])


def test_feed_validates_depth_buffers_and_engine():
    with pytest.raises(ValueError, match="depth >= 1"):
        DeviceFeed(_FakeStep(), depth=0)
    with pytest.raises(ValueError, match="depth \\+ 1"):
        DeviceFeed(_FakeStep(), depth=3, buffers=3)
    assert DeviceFeed(_FakeStep(), depth=2).buffers == 5

    class HostStep(_FakeStep):
        device_prep = False

    with pytest.raises(ValueError, match="device-prep"):
        DeviceFeed(HostStep(), depth=2)


# -- the staged stream against the unstaged one -------------------------------

def staged_stream(seed=0):
    """Two full runs at Npad A (new keys in the second), 3 batches at
    Npad B (a short run), a full run at A and a short last batch."""
    rng = np.random.default_rng(seed)
    return (make_slices(rng, 16) + make_slices(rng, 16, key_hi=2000)
            + make_slices(rng, 3, npad=NPAD_B, lo=3, hi=6)
            + make_slices(rng, 17, partial_last=5))


def train_worlds(monkeypatch, graphs, insert_mode="ensure"):
    if graphs:
        monkeypatch.setattr(step_graph, "RunGraph", ReplayingRunGraph)
    out = []
    for _ in range(2):
        fs, t, st = world(graphs=graphs)
        fs.insert_mode = insert_mode
        fs._record_misses = insert_mode == "deferred"
        out.append((fs, t, st))
    return out


def assert_same_worlds(a, b):
    (afs, at, ast), (bfs, bt, bst) = a, b
    for x, y in zip(ast[0].parameters(), bst[0].parameters()):
        assert torch.equal(x, y)
    for f in ("count", "mu", "nu"):
        xs, ys = ast[1][f], bst[1][f]
        xs, ys = ([xs], [ys]) if isinstance(xs, torch.Tensor) else (xs, ys)
        assert all(torch.equal(x, y) for x, y in zip(xs, ys)), f
    for f in ast[2]:
        assert torch.equal(ast[2][f], bst[2][f]), f
    assert_same_rows_by_key(at, bt)
    assert torch.equal(afs.bad_flag, bfs.bad_flag)


@pytest.mark.parametrize("depth,graphs,mode", [
    (1, True, "ensure"), (2, True, "ensure"), (3, True, "ensure"),
    (2, False, "ensure"), (2, True, "deferred")])
def test_staged_stream_bit_for_bit_with_unstaged(monkeypatch, depth,
                                                 graphs, mode):
    """``train_stream(feed=DeviceFeed(...))`` over the slices against
    ``train_stream`` over the unstaged tuples of the same batches, on
    twin worlds: every step's loss, the last loss, the step count, dense
    params, adam's state, the AUC state and every row by key, exactly.
    With run graphs (their stand-in) the first full run at Npad A goes
    eagerly and the next two replay, captured where the unstaged stream
    captures (again after a growth); the feed's slots all come back."""
    slices = staged_stream()
    (sfs, st, sst), (ufs, ut, ust) = train_worlds(monkeypatch, graphs,
                                                  mode)
    feed = DeviceFeed(sfs, depth=depth)
    scalls, ucalls = [], []
    *sst, sloss, ssteps = sfs.train_stream(
        *sst, iter(slices), feed=feed,
        on_step=lambda s, l: scalls.append((s, l)))
    *ust, uloss, usteps = ufs.train_stream(
        *ust, iter([legacy_tuple(sl) for sl in slices]),
        on_step=lambda s, l: ucalls.append((s, l)))
    assert ssteps == usteps == len(slices) == 52
    assert [s for s, _ in scalls] == [s for s, _ in ucalls] == \
        list(range(1, 53))
    assert torch.equal(torch.stack([l for _, l in scalls]),
                       torch.stack([l for _, l in ucalls]))
    assert torch.equal(sloss, uloss)
    assert_same_worlds((sfs, st, sst), (ufs, ut, ust))
    assert len(st) > PREPOP
    if graphs:
        g, u = sfs.run_graphs, ufs.run_graphs
        assert g.warm == {("cols", NPAD_A)}
        assert (g.captures, g.replays) == (u.captures, u.replays)
        assert g.captures >= 1 and g.replays == 2
        assert len(feed.captures) == g.captures
    assert feed.ring.held == 0 and not feed.producing


def test_consumer_failure_returns_every_slot(monkeypatch):
    """A step that raises mid-pass: the error reaches the caller, every
    slot is back in the ring, the producer is gone, and the next pass
    over the same feed trains."""
    (fs, _, st), _ = train_worlds(monkeypatch, False)
    feed = DeviceFeed(fs, depth=2)
    step = fs.step_cols_tensors
    calls = []

    def failing(*a):
        calls.append(1)
        if len(calls) == 20:
            raise RuntimeError("step failed")
        return step(*a)

    monkeypatch.setattr(fs, "step_cols_tensors", failing)
    with pytest.raises(RuntimeError, match="step failed"):
        fs.train_stream(*st, iter(staged_stream()), feed=feed)
    assert feed.ring.held == 0 and not feed.producing
    monkeypatch.setattr(fs, "step_cols_tensors", step)
    *_, steps = fs.train_stream(*st, iter(staged_stream(1)), feed=feed)
    assert steps == 52 and feed.ring.held == 0


# -- CTRTrainer.train_from_files, staged --------------------------------------

@pytest.fixture(scope="module")
def reference_staged(stream_files):
    """The reference trainer's staged pass (``feed_device_prefetch`` 2)
    over the stream's files, from a native one-thread table."""
    jt = jax_table()
    arena = (np.asarray(jt.values).copy(), np.asarray(jt.state).copy(),
             jt._index.dump_keys(jt._size))
    old = ref_flags.get("feed_device_prefetch")
    ref_flags.set("feed_device_prefetch", 2)
    try:
        tr = ref_trainer.CTRTrainer(
            FlaxDeepFM(hidden=(16,)), jax_feed_conf(),
            JaxTableConfig(**TABLE), JaxTrainerConfig(**TRAIN), table=jt,
            buckets=JaxBucketSpec(**FILE_BUCKETS))
        init = leaves_of(tr.params)
        metrics = tr.train_from_files(stream_files, prefetch=2)
    finally:
        ref_flags.set("feed_device_prefetch", old)
    return dict(init=init, arena=arena, metrics=metrics,
                params=leaves_of(tr.params), table=jt)


def test_staged_train_from_files_matches_reference(
        stream_files, reference_staged, monkeypatch):
    """The port's staged pass against the reference's staged pass: pass
    metrics, dense params and the arena; then against the port's unstaged
    pass from the same init, bit for bit by key; and a second staged pass
    reuses the trainer's feed, every slot back."""
    ref = reference_staged
    monkeypatch.setenv("PBOX_FLAGS_feed_device_prefetch", "2")
    tr = port_files_trainer(ref)
    metrics = tr.train_from_files(stream_files, prefetch=2)
    feed = tr._feed
    assert feed is not None and feed.ring.held == 0
    assert metrics["ins_num"] == ref["metrics"]["ins_num"] == 285
    for k, want in ref["metrics"].items():
        np.testing.assert_allclose(metrics[k], want, rtol=1e-5, err_msg=k)
    for got, want in zip(flax_leaves_from_deepfm(tr.params), ref["params"]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert_arena_equal(tr.table, ref["table"])
    assert 0.0 < tr.last_heartbeat["host_share"] <= 1.0
    monkeypatch.delenv("PBOX_FLAGS_feed_device_prefetch")
    plain = port_files_trainer(ref)
    assert plain.train_from_files(stream_files, prefetch=2) == metrics
    assert plain._feed is None
    assert_same_rows_by_key(tr.table, plain.table)
    for a, b in zip(tr.params.parameters(), plain.params.parameters()):
        assert torch.equal(a, b)
    monkeypatch.setenv("PBOX_FLAGS_feed_device_prefetch", "2")
    tr.reset_metrics()
    assert tr.train_from_files(stream_files)["ins_num"] == 285
    assert tr._feed is feed and feed.ring.held == 0


def test_staged_pass_with_workers_over_defer_recycle(
        stream_files, reference_staged, monkeypatch):
    """``workers=2`` over the fabric under
    ``PBOX_FLAGS_ingest_shm_defer_recycle=1``, staged: bit for bit against
    the single reader's staged pass, no segment left."""
    ref = reference_staged
    monkeypatch.setenv("PBOX_FLAGS_feed_device_prefetch", "2")
    one = port_files_trainer(ref)
    want = one.train_from_files(stream_files)
    monkeypatch.setenv("PBOX_FLAGS_ingest_shm_defer_recycle", "1")
    two = port_files_trainer(ref)
    assert two.train_from_files(stream_files, workers=2) == want
    assert_same_rows_by_key(one.table, two.table)
    for a, b in zip(one.params.parameters(), two.params.parameters()):
        assert torch.equal(a, b)
    assert two._feed.ring.held == 0


def test_staged_needs_device_prep(stream_files, reference_staged,
                                  monkeypatch):
    monkeypatch.setenv("PBOX_FLAGS_feed_device_prefetch", "2")
    tr = port_files_trainer(reference_staged)
    tr.step.device_prep = False
    with pytest.raises(ValueError, match="device-prep"):
        tr.train_from_files(stream_files)
    assert tr._step_count == 0
