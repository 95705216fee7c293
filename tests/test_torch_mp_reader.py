"""Port's multi-process file reader (``data/fast_feed.py``
``MultiProcessReader``) over both hand-off protocols, the shared-memory
fabric (``data/shm_fabric.py``) and the pipe, against the JAX package's
reader on the same files; and ``CTRTrainer.train_from_files(workers=2)``
against ``workers=1``.

Exact: every batch array and count, array for array, against the
reference's single reader and its multi-process reader of the same
protocol; error types and messages; ``ingest_shm_conf``'s validation. No
segment of the port's may outlive its reader (``shm_counters``
``leaked_segments`` 0, no ``pbxt_shm_<pid>_*`` left in /dev/shm). Each
reader spawns its workers (a fresh interpreter each, which imports no
torch), so the cases share their readers' files and keep worker counts
small."""

import copy
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddlebox_tpu import flags as ref_flags
from paddlebox_tpu.config import DataFeedConfig as JaxFeedConfig
from paddlebox_tpu.config import SlotConfig as JaxSlotConfig
from paddlebox_tpu.config import ingest_shm_conf as ref_shm_conf
from paddlebox_tpu.data.fast_feed import FastSlotReader as JaxReader
from paddlebox_tpu.data.fast_feed import \
    MultiProcessReader as JaxMultiProcessReader
from paddlebox_tpu.ps import native as ref_native
from paddlebox_tpu_torch.config import (BucketSpec, DataFeedConfig,
                                        TableConfig, TrainerConfig,
                                        ingest_shm_conf)
from paddlebox_tpu_torch.data import ingest, shm_fabric
from paddlebox_tpu_torch.data.fast_feed import (FastSlotReader,
                                                MultiProcessReader)
from paddlebox_tpu_torch.models import DeepFM
from paddlebox_tpu_torch.ps.device_table import DeviceTable
from paddlebox_tpu_torch.trainer.trainer import CTRTrainer

pytestmark = pytest.mark.skipif(not ref_native.available(),
                                reason="native backend unavailable")

BATCH_FIELDS = ("keys", "segment_ids", "lengths", "labels", "dense")
SHM_FLAGS = {"ingest_shm": True, "ingest_shm_blocks": 4,
             "ingest_shm_block_bytes": 16 << 20}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mixed_conf(batch_size=32):
    """The reference tests' ``mixed_conf``: a label, six sparse slots, a
    3-wide float slot, a skipped sparse slot and one more sparse
    slot."""
    slots = ([JaxSlotConfig(name="label", type="float")] +
             [JaxSlotConfig(name=f"s{i}") for i in range(6)] +
             [JaxSlotConfig(name="d0", type="float", dim=3)] +
             [JaxSlotConfig(name="skipped", is_used=False)] +
             [JaxSlotConfig(name="s6")])
    return JaxFeedConfig(slots=slots, batch_size=batch_size)


def port_conf(jconf):
    return DataFeedConfig.from_dict(dataclasses.asdict(jconf))


def write_file(path, conf, rows, seed=0, max_keys=4):
    """Seeded MultiSlot lines for ``conf``: 0 to ``max_keys`` - 1 keys a
    slot below 2^64, normal floats."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(rows):
            parts = []
            for s in conf.slots:
                if s.name == conf.label_slot:
                    parts.append(f"1 {int(rng.integers(0, 2))}")
                elif s.type == "uint64":
                    k = rng.integers(1, np.iinfo(np.uint64).max,
                                     size=int(rng.integers(0, max_keys)),
                                     dtype=np.uint64)
                    parts.append(" ".join([str(k.size), *map(str, k)]))
                else:
                    v = rng.normal(size=s.dim).round(4)
                    parts.append(" ".join([str(s.dim), *map(str, v)]))
            f.write(" ".join(parts) + "\n")
    return path


def shm_names():
    return sorted(n for n in os.listdir("/dev/shm")
                  if n.startswith(f"{shm_fabric.PREFIX}{os.getpid()}_"))


@pytest.fixture
def set_flag(monkeypatch):
    """``set_flag(name, value)`` in both packages; the reference's
    registry is restored after the test."""
    def set_(name, value):
        ref_flags.set(name, value)
        monkeypatch.setenv(f"PBOX_FLAGS_{name}",
                           str(int(value) if isinstance(value, bool)
                               else value))
    yield set_
    for name, value in SHM_FLAGS.items():
        ref_flags.set(name, value)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Five files of 57 rows (batches carried across files, a 29-row
    last batch), one of 3 rows and one empty."""
    d = tmp_path_factory.mktemp("mp")
    conf = mixed_conf()
    out = [write_file(str(d / f"p{i}"), conf, 57, seed=i) for i in range(5)]
    out.insert(2, write_file(str(d / "tiny"), conf, 3, seed=9))
    out.insert(4, write_file(str(d / "empty"), conf, 0))
    return out


@pytest.fixture(scope="module")
def reference(files):
    """The reference's streams: the single reader's batches, and its
    multi-process reader's over each protocol (2 workers)."""
    conf = mixed_conf()
    out = {"single": list(JaxReader(conf).batches(files))}
    for use_shm in (True, False):
        out[use_shm] = list(JaxMultiProcessReader(
            conf, workers=2, use_shm=use_shm).batches(files))
    return out


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in BATCH_FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert (g.num_keys, g.num_rows) == (w.num_keys, w.num_rows)


@pytest.mark.parametrize("workers", [2, 3])
@pytest.mark.parametrize("use_shm", [True, False])
def test_stream_matches_reference(files, reference, use_shm, workers):
    """``batches`` and ``stream`` of 2 and 3 workers, each protocol:
    the reference's batches (its single reader and its multi-process
    reader), the stream's tuples the single reader's; no segment
    left."""
    conf = port_conf(mixed_conf())
    reader = MultiProcessReader(conf, workers=workers, use_shm=use_shm)
    assert reader.use_shm is use_shm
    got = list(reader.batches(files))
    assert_batches_equal(got, reference["single"])
    assert_batches_equal(got, reference[use_shm])
    if workers == 2:
        tuples = list(reader.stream(files, drop_remainder=False))
        want = list(FastSlotReader(conf).stream(files, drop_remainder=False))
        assert len(tuples) == len(want) == 9
        for a, b in zip(tuples, want):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    if use_shm:
        assert reader.shm_counters["blocks"] == len(files) * (
            1 + (workers == 2))
        assert reader.shm_counters["leaked_segments"] == 0
    assert shm_names() == []


def test_more_workers_than_files(files, reference):
    """Four workers over one file: one worker spawns; the reference's
    batches."""
    conf = mixed_conf()
    got = list(MultiProcessReader(port_conf(conf), workers=4,
                                  use_shm=True).batches(files[:1]))
    assert_batches_equal(got, list(JaxReader(conf).batches(files[:1])))


@pytest.mark.parametrize("use_shm", [True, False])
def test_worker_error_propagates_like_reference(files, tmp_path, use_shm):
    """A missing file in worker 1's shard: the reference's
    ``RuntimeError`` naming the shard and the file; every worker killed,
    no segment left."""
    shard = [files[0], str(tmp_path / "missing")]
    errs = []
    for cls, conf in ((JaxMultiProcessReader, mixed_conf()),
                      (MultiProcessReader, port_conf(mixed_conf()))):
        reader = cls(conf, workers=2, use_shm=use_shm)
        with pytest.raises(RuntimeError) as e:
            list(reader.batches(shard))
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    assert "parse worker failed on shard 1: FileNotFoundError" in errs[1]
    assert reader._procs == [] and shm_names() == []


def test_torn_block_killed_and_named_like_reference(files):
    """A worker that corrupts a key after its crc, announces the block
    and dies: the reference's ``IngestError`` (worker, seq, file, the
    crcs), counted as a torn block."""
    errs = []
    for cls, conf, mod in (
            (JaxMultiProcessReader, mixed_conf(), None),
            (MultiProcessReader, port_conf(mixed_conf()), ingest)):
        reader = cls(conf, workers=2, use_shm=True)
        reader._worker_fault = {"op": "torn_block", "file_index": 1,
                                "worker": 0}
        before = ingest.INGEST_STATS.get("torn_blocks")
        with pytest.raises(Exception) as e:
            list(reader.batches(files))
        errs.append((type(e.value).__name__, str(e.value)))
        if mod is not None:
            assert ingest.INGEST_STATS.get("torn_blocks") == before + 1
            assert reader.shm_counters["crc_failures"] == 1
    assert errs[0] == errs[1]
    assert "torn shm block (seq 1" in errs[1][1]
    assert errs[1][0] == "IngestError" and shm_names() == []


def test_block_splitting_keeps_the_stream(tmp_path, set_flag):
    """700-row files in 64 KiB blocks: several blocks a file, the same
    batches; ``iter_blocks`` still gives one owned block a file."""
    conf = mixed_conf()
    big = [write_file(str(tmp_path / f"b{i}"), conf, 700, seed=i)
           for i in range(2)]
    set_flag("ingest_shm_block_bytes", 1 << 16)
    reader = MultiProcessReader(port_conf(conf), workers=2, use_shm=True)
    got = list(reader.batches(big))
    assert reader.shm_counters["blocks"] > len(big)
    assert_batches_equal(got, list(JaxReader(conf).batches(big)))
    blocks = list(reader.iter_blocks(big))
    assert [b.rows for b in blocks] == [700, 700]
    assert all(b.owner is None for b in blocks)
    want = JaxReader(conf).parse_file(big[1])
    for f in ("keys", "lengths", "labels", "dense"):
        np.testing.assert_array_equal(getattr(blocks[1], f),
                                      getattr(want, f))


def test_tiny_files_within_two_blocks(tmp_path, set_flag):
    """24 files of 3 rows through pools of 2 blocks (the minimum): the
    slicer copies sub-batch blocks out at once, so no worker waits
    forever for a block; the reference's batches."""
    conf = mixed_conf(batch_size=64)
    tiny = [write_file(str(tmp_path / f"t{i}"), conf, 3, seed=100 + i)
            for i in range(24)]
    set_flag("ingest_shm_blocks", 2)
    got = list(MultiProcessReader(port_conf(conf), workers=2,
                                  use_shm=True).batches(tiny))
    assert_batches_equal(got, list(JaxReader(conf).batches(tiny)))


def test_row_too_big_fails_naming_the_flag(tmp_path, set_flag):
    conf = mixed_conf(batch_size=8)
    p = str(tmp_path / "wide")
    with open(p, "w") as f:
        keys = " ".join(str(k) for k in range(1, 20000))
        f.write(f"1 1 19999 {keys} 1 2 1 3 1 4 1 5 1 6 "
                "3 0.1 0.2 0.3 1 7 1 8\n")
    set_flag("ingest_shm_block_bytes", 1 << 16)
    with pytest.raises(RuntimeError, match="ingest_shm_block_bytes"):
        list(MultiProcessReader(port_conf(conf), workers=1,
                                use_shm=True).batches([p]))
    assert shm_names() == []


@pytest.mark.parametrize("flag,value", [
    ("ingest_shm_blocks", 1), ("ingest_shm_block_bytes", 1024),
    ("ingest_shm", False)])
def test_shm_conf_validated_like_reference(set_flag, flag, value):
    """``ingest_shm_conf``: the reference's tuple, or its ``ValueError``
    (a pipe reader skips the fabric's knobs)."""
    set_flag(flag, value)
    outs = []
    for fn in (ref_shm_conf, ingest_shm_conf):
        try:
            outs.append(fn())
        except ValueError as e:
            outs.append(str(e))
    assert outs[0] == outs[1]
    if flag != "ingest_shm":
        assert flag in outs[1]
        assert ingest_shm_conf(False)[0] is False
        with pytest.raises(ValueError, match=flag):
            MultiProcessReader(port_conf(mixed_conf()), use_shm=True)
    else:
        assert outs[1] == (False, 4, 16 << 20, True, False)
        assert MultiProcessReader(port_conf(mixed_conf())).use_shm is False


def test_worker_imports_no_torch():
    """The parse worker's import chain (``data.fast_feed`` with the
    tokenizer's loader, the fabric, and the trace and registry it reports
    to) imports no torch, so a worker never pays torch's import nor
    touches a card; the package's top-level names still resolve
    lazily."""
    code = ("import sys\n"
            "import paddlebox_tpu_torch.data.fast_feed\n"
            "import paddlebox_tpu_torch.data.shm_fabric\n"
            "import paddlebox_tpu_torch.data.channel\n"
            "import paddlebox_tpu_torch.obs.heartbeat\n"
            "import paddlebox_tpu_torch.utils.monitor\n"
            "from paddlebox_tpu_torch.obs import REGISTRY, trace\n"
            "assert REGISTRY is paddlebox_tpu_torch.utils.monitor.STATS\n"
            "from paddlebox_tpu_torch.ps import native\n"
            "native._load_feed()\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n"
            "import paddlebox_tpu_torch as p\n"
            "assert p.TrainStep.__name__ == 'TrainStep'\n"
            "from paddlebox_tpu_torch import ops\n"
            "from paddlebox_tpu_torch.ops import cvm\n"
            "import paddlebox_tpu_torch.ops.cvm\n"
            "assert callable(cvm) and ops.cvm is cvm\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_defer_recycle_holds_a_pinned_block(tmp_path, set_flag,
                                            monkeypatch):
    """``PBOX_FLAGS_ingest_shm_defer_recycle=1`` reaches the fabric: a
    pinned lease's block does not go back to its worker when the slicer
    advances past it, only when the pin is released; without the flag a
    pin is refused and the block recycles at the slicer's release. One
    worker, files of exactly one batch, so each block is one slice."""
    conf = mixed_conf()
    paths = [write_file(str(tmp_path / f"b{i}"), conf, conf.batch_size,
                        seed=40 + i) for i in range(4)]
    recycled = []
    recycle = shm_fabric.ShmFabric._recycle

    def spy(self, worker, block):
        recycled.append((worker, block))
        recycle(self, worker, block)

    monkeypatch.setattr(shm_fabric.ShmFabric, "_recycle", spy)
    for defer in (True, False):
        set_flag("ingest_shm_defer_recycle", defer)
        recycled.clear()
        reader = MultiProcessReader(port_conf(conf), workers=1)
        it = reader.stream_columnar(paths)
        first = next(it)
        lease = first.owner
        assert isinstance(lease, shm_fabric.BlockLease)
        assert reader._fabric.defer_recycle is defer
        assert lease.pin() is defer
        second = next(it)            # the slicer released the first
        assert second.owner is not lease
        held = (lease.worker, lease.block)
        assert (held in recycled) is not defer
        if defer:
            lease.release()          # the pin, the last holder
            assert recycled.count(held) == 1
        rest = list(it)
        assert len(rest) == 2 and recycled.count(held) >= 1
        assert reader.shm_counters["leaked_segments"] == 0
    assert not shm_names()


# -- train_from_files(workers=2) ---------------------------------------------

B, S, EDIM = 8, 3, 4
TABLE = dict(embedx_dim=EDIM, embedx_threshold=0.0, initial_range=0.05,
             seed=11)


def trainer_conf():
    return JaxFeedConfig(slots=[
        JaxSlotConfig("label", type="float", is_dense=True, dim=1),
        JaxSlotConfig("slot_a"), JaxSlotConfig("slot_b"),
        JaxSlotConfig("slot_c"),
        JaxSlotConfig("dense_x", type="float", is_dense=True, dim=2),
    ], batch_size=B, label_slot="label")


def twins(n):
    """``n`` trainers over tables with the same arena and the same
    weights (device prep over a native one-thread index)."""
    torch.manual_seed(0)
    model = DeepFM(S * (3 + EDIM) + 2, (16,))
    base = DeviceTable(TableConfig(**TABLE), capacity=4096, device="cpu",
                       backend="native", index_threads=1)
    base.prepopulate(300)
    out = []
    for _ in range(n):
        t = DeviceTable(TableConfig(**TABLE), capacity=1, device="cpu",
                        backend="native", index_threads=1)
        t.load_arena(base.values.numpy().copy(), base.state.numpy().copy(),
                     base.row_keys())
        out.append(CTRTrainer(copy.deepcopy(model),
                              port_conf(trainer_conf()),
                              TableConfig(**TABLE), TrainerConfig(),
                              table=t, buckets=BucketSpec(min_size=64,
                                                          max_size=4096)))
    return out


def test_train_from_files_workers_bit_for_bit(tmp_path, set_flag):
    """``train_from_files`` over four files (a batch split between
    files, new keys in each) with ``workers=2`` over the fabric and over
    the pipe, and ``workers=1``: the same pass metrics, rows by key and
    dense params, bit for bit; no worker or segment left."""
    conf = trainer_conf()
    paths = [write_file(str(tmp_path / f"part-{i}"), conf, rows, seed=i)
             for i, rows in enumerate((37, 20, 51, 12))]
    one, shm, pipe = twins(3)
    want = one.train_from_files(paths)
    got_shm = shm.train_from_files(paths, workers=2)
    set_flag("ingest_shm", False)
    got_pipe = pipe.train_from_files(paths, workers=2)
    assert got_shm == want and got_pipe == want
    assert want["ins_num"] == 120
    keys = one.table.row_keys()
    order = np.argsort(keys[1:]) + 1
    for tr in (shm, pipe):
        k = tr.table.row_keys()
        o = np.argsort(k[1:]) + 1
        np.testing.assert_array_equal(k[o], keys[order])
        assert torch.equal(tr.table.values[torch.from_numpy(o)],
                           one.table.values[torch.from_numpy(order)])
        assert torch.equal(tr.table.state[torch.from_numpy(o)],
                           one.table.state[torch.from_numpy(order)])
        for a, b in zip(tr.params.parameters(), one.params.parameters()):
            assert torch.equal(a, b)
        assert tr._step_count == one._step_count == 15
    assert shm_names() == []
