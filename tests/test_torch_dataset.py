"""Port's slot parser, batch assembly and in-memory ``SlotDataset`` against
the JAX package's, on the same MultiSlot files (``conftest.make_slot_file``
at the reference tests' ``feed_conf``: 3 sparse slots, a 3-wide dense slot,
batch 8). Records and batch arrays must be equal, array for array: the
parse and the assembly are the same host arithmetic in both packages. The
``sample_rate`` subsample hashes with Python's per-process salted ``hash``,
so both packages run in this one process."""

import dataclasses

import numpy as np
import pytest

from conftest import make_slot_file
from paddlebox_tpu.config import DataFeedConfig as JaxFeedConfig
from paddlebox_tpu.config import SlotConfig as JaxSlotConfig
from paddlebox_tpu.data import dataset as ref_dataset
from paddlebox_tpu.data import parser as ref_parser
from paddlebox_tpu.data.dataset import SlotDataset as JaxSlotDataset
from paddlebox_tpu.data.ingest import IngestError as JaxIngestError
from paddlebox_tpu.data.parser import SlotParser as JaxSlotParser
from paddlebox_tpu_torch.config import DataFeedConfig
from paddlebox_tpu_torch.data import dataset as port_dataset
from paddlebox_tpu_torch.data.batch import BatchAssembler
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.data.parser import (IngestError, SlotParser,
                                             pack_logkey, unpack_logkey)
from torch_coord_world import exchange

BATCH_FIELDS = ("keys", "segment_ids", "lengths", "labels", "dense",
                "search_ids")
INT_FIELDS = ("batch_size", "num_slots", "num_keys", "num_rows",
              "padded_keys")
RECORD_FIELDS = ("uint64_feas", "uint64_offsets", "float_feas",
                 "float_offsets")
RECORD_SCALARS = ("label", "search_id", "cmatch", "rank", "ins_id")


def jax_conf(**kw):
    """The reference tests' ``feed_conf`` (tests/conftest.py)."""
    base = dict(slots=[
        JaxSlotConfig("label", type="float", is_dense=True, dim=1),
        JaxSlotConfig("slot_a"),
        JaxSlotConfig("slot_b"),
        JaxSlotConfig("slot_c"),
        JaxSlotConfig("dense_x", type="float", is_dense=True, dim=3),
    ], batch_size=8, label_slot="label", thread_num=2)
    base.update(kw)
    return JaxFeedConfig(**base)


def port_conf(jconf):
    return DataFeedConfig.from_dict(dataclasses.asdict(jconf))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Two files of 48 rows and one of 45 (a ragged last batch)."""
    d = tmp_path_factory.mktemp("slots")
    conf = jax_conf()
    return [make_slot_file(str(d / f"part-{i}"), conf, rows, seed=i)
            for i, rows in enumerate((48, 48, 45))]


def assert_records_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in RECORD_FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        for f in RECORD_SCALARS:
            assert getattr(g, f) == getattr(w, f), f


def assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in BATCH_FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        for f in INT_FIELDS:
            assert getattr(g, f) == getattr(w, f), f
        np.testing.assert_array_equal(g.key_mask(), w.key_mask())
        np.testing.assert_array_equal(g.row_mask(), w.row_mask())


def loaded(files, jconf=None, **ds_kw):
    """The reference's dataset and the port's, each loaded from
    ``files``."""
    jconf = jconf or jax_conf()
    jds = JaxSlotDataset(jconf, **ds_kw)
    pds = SlotDataset(port_conf(jconf), **ds_kw)
    for ds in (jds, pds):
        ds.set_filelist(files)
        ds.load_into_memory()
    return jds, pds


LINES = {
    "plain": ({}, "1 1 2 11 22 1 33 3 44 55 66 3 0.5 -1.5 2.0"),
    "ins_id": ({"parse_ins_id": True},
               "1 ins-7 1 0 1 5 0 3 7 8 9 3 1 2 3"),
    "logkey": ({"parse_logkey": True},
               f"1 {pack_logkey(12345, 2, 7)} 1 1 1 5 1 6 1 7 3 1 2 3"),
    "both": ({"parse_ins_id": True, "parse_logkey": True},
             f"1 abc 1 {pack_logkey(0x1702F830EEE, 3, 9)} 1 0 2 5 6 "
             "1 6 1 7 3 1 2 3"),
    "short_logkey": ({"parse_logkey": True}, "1 1f 1 1 1 5 1 6 1 7 3 1 2 3"),
}


@pytest.mark.parametrize("case", sorted(LINES))
def test_parse_line_matches_reference(case):
    kw, line = LINES[case]
    jconf = jax_conf(**kw)
    want = JaxSlotParser(jconf).parse_line(line)
    got = SlotParser(port_conf(jconf)).parse_line(line)
    assert_records_equal([got], [want])


def test_unused_slot_skipped_like_reference():
    jconf = JaxFeedConfig(slots=[
        JaxSlotConfig("label", type="float", is_dense=True, dim=1),
        JaxSlotConfig("a"), JaxSlotConfig("skip", is_used=False),
        JaxSlotConfig("b"),
        JaxSlotConfig("d", type="float", is_dense=True, dim=2,
                      is_used=False)])
    line = "1 1 2 10 20 3 7 8 9 1 30 2 0.5 0.25"
    got = SlotParser(port_conf(jconf)).parse_line(line)
    assert_records_equal([got], [JaxSlotParser(jconf).parse_line(line)])
    assert got.uint64_offsets.tolist() == [0, 2, 3]
    np.testing.assert_array_equal(got.slot_uint64(1), [30])


def test_logkey_round_trip_matches_reference():
    for sid, cm, rk in ((0x1702F830EEE, 3, 9), (0, 0, 0), (1, 4095, 255)):
        key = pack_logkey(sid, cm, rk)
        assert key == ref_parser.pack_logkey(sid, cm, rk)
        assert unpack_logkey(key) == ref_parser.unpack_logkey(key) == \
            (sid, cm, rk)
    assert unpack_logkey(" 1f ") == ref_parser.unpack_logkey(" 1f ")


@pytest.mark.parametrize("bad", ["truncated_slot", "truncated_line",
                                 "bad_token"])
def test_bad_line_raises_with_path_and_lineno(tmp_path, bad):
    """The first bad line raises ``<path>:<lineno>: <text!r>: <error>``,
    the reference's fail-fast message, word for word."""
    jconf = jax_conf()
    path = make_slot_file(str(tmp_path / "f"), jconf, 6, seed=3)
    lines = open(path).read().splitlines()
    lines[3] = {"truncated_slot": lines[3].rsplit(" ", 2)[0],
                "truncated_line": " ".join(lines[3].split()[:5]),
                "bad_token": lines[3].replace("1 ", "x ", 1)}[bad]
    lines.insert(1, "")   # blank lines are skipped but counted
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with pytest.raises(JaxIngestError) as want:
        JaxSlotParser(jconf).parse_file(path)
    with pytest.raises(IngestError) as got:
        SlotParser(port_conf(jconf)).parse_file(path)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith(f"{path}:5: ")
    # through the dataset, the same error
    ds = SlotDataset(port_conf(jconf))
    ds.set_filelist([path])
    with pytest.raises(IngestError, match=f"{path}:5: "):
        ds.load_into_memory()


def test_missing_file_raises_naming_it(tmp_path, files):
    missing = str(tmp_path / "nope")
    jds = JaxSlotDataset(jax_conf())
    pds = SlotDataset(port_conf(jax_conf()))
    errors = []
    for ds, err in ((jds, JaxIngestError), (pds, IngestError)):
        ds.set_filelist([files[0], missing])
        with pytest.raises(err) as e:
            ds.load_into_memory()
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert errors[1].startswith(f"{missing}: FileNotFoundError")


def test_parse_file_matches_reference(files):
    jconf = jax_conf()
    assert_records_equal(SlotParser(port_conf(jconf)).parse_file(files[2]),
                         JaxSlotParser(jconf).parse_file(files[2]))


@pytest.mark.parametrize("drop_remainder", [False, True])
def test_load_and_batches_match_reference(files, drop_remainder):
    jds, pds = loaded(files)
    assert pds.num_instances() == jds.num_instances() == 141
    assert_records_equal(pds.records, jds.records)
    n = len(list(pds.batches(drop_remainder)))
    assert n == (17 if drop_remainder else 18)
    assert_batches_equal(pds.batches(drop_remainder),
                         jds.batches(drop_remainder))


def test_assembler_batches_match_reference(files):
    """``BatchAssembler.batches`` over records, with a small bucket so the
    key padding varies from batch to batch."""
    from paddlebox_tpu.config import BucketSpec as JaxBucketSpec
    from paddlebox_tpu.data.batch import BatchAssembler as JaxAssembler
    from paddlebox_tpu_torch.config import BucketSpec
    jconf = jax_conf()
    recs = JaxSlotParser(jconf).parse_file(files[1])
    precs = SlotParser(port_conf(jconf)).parse_file(files[1])
    for drop in (False, True):
        want = JaxAssembler(jconf, JaxBucketSpec(min_size=16, max_size=256),
                            drop_remainder=drop).batches(recs[:45])
        got = BatchAssembler(port_conf(jconf),
                             BucketSpec(min_size=16, max_size=256),
                             drop_remainder=drop).batches(precs[:45])
        assert_batches_equal(got, want)


def test_local_shuffle_and_extract_keys_match_reference(files):
    jds, pds = loaded(files, shard_id=1)
    for _ in range(2):
        jds.local_shuffle()
        pds.local_shuffle()
    assert_records_equal(pds.records, jds.records)
    assert_batches_equal(pds.batches(), jds.batches())
    got, want = pds.extract_keys(), jds.extract_keys()
    assert got.dtype == want.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    pds.release_memory()
    assert pds.num_instances() == 0 and pds.extract_keys().size == 0


def test_sample_rate_matches_reference(files):
    jds, pds = loaded(files, jconf=jax_conf(sample_rate=0.5))
    assert 0 < pds.num_instances() < 141
    assert_records_equal(pds.records, jds.records)


def test_shard_split_matches_reference(files):
    for shard in (0, 1):
        jds, pds = loaded(files, shard_id=shard, num_shards=2)
        assert pds.filelist == jds.filelist
        assert_records_equal(pds.records, jds.records)


def test_preload_equals_load(files, tmp_path):
    _, pds = loaded(files)
    pre = SlotDataset(port_conf(jax_conf()))
    pre.set_filelist(files)
    pre.preload_into_memory()
    pre.wait_preload_done()
    assert_records_equal(pre.records, pds.records)
    pre.wait_preload_done()   # nothing pending: keeps the records
    assert pre.num_instances() == 141
    # a failed preload raises at the wait, naming the shard's file
    pre.set_filelist([str(tmp_path / "gone")])
    pre.preload_into_memory()
    with pytest.raises(IngestError, match="gone: FileNotFoundError"):
        pre.wait_preload_done()
    with pytest.raises(IngestError):
        pre.wait_preload_done()
    pre.close()


def both_datasets(files, jconf=None, n=1, merge=None):
    """The reference's and the port's datasets (``n`` shards each, each
    loaded from ``files``; ``merge``: ``set_merge_by_insid(merge)``)."""
    out = []
    for cls, conf in ((JaxSlotDataset, jconf or jax_conf()),
                      (SlotDataset, port_conf(jconf or jax_conf()))):
        shards = []
        for i in range(n):
            ds = cls(conf, shard_id=i, num_shards=n)
            if merge:
                ds.set_merge_by_insid(merge)
            ds.set_filelist(files)
            ds.load_into_memory()
            shards.append(ds)
        out.append(shards)
    return out


def ins_id_files(files, tmp_path):
    """Each line of ``files`` as two parts of one instance (``1 <id>``
    first): the label and slot_a with a zero dense slot, then the label,
    slot_b, slot_c and the dense slot; the parts in reverse order every
    third line."""
    out = []
    for fi, path in enumerate(files):
        lines = []
        with open(path) as f:
            for li, line in enumerate(f):
                toks, groups, pos = line.split(), [], 0
                while pos < len(toks):
                    n = int(toks[pos])
                    groups.append(" ".join(toks[pos:pos + n + 1]))
                    pos += n + 1
                label, a, b, c, dense = groups
                ins = f"1 f{fi}-{li}"
                parts = [f"{ins} {label} {a} 0 0 3 0 0 0",
                         f"{ins} {label} 0 {b} {c} {dense}"]
                lines += parts[::-1] if li % 3 == 0 else parts
        out.append(str(tmp_path / f"ins-{fi}"))
        with open(out[-1], "w") as f:
            f.write("\n".join(lines) + "\n")
    return out


def _pipe_command(files, tmp_path):
    want = JaxSlotParser(jax_conf(pipe_command="cat")).parse_file(files[0])
    got = SlotParser(port_conf(jax_conf(pipe_command="cat"))).parse_file(
        files[0])
    assert_records_equal(got, want)
    assert_records_equal(got, SlotParser(port_conf(jax_conf())).parse_file(
        files[0]))


def _string_slot(files, tmp_path):
    jconf = jax_conf()
    jconf.slots[2] = dataclasses.replace(jconf.slots[2], type="string")

    def lookup(key):
        return len(key) * 1000 + int(key) % 7
    want = JaxSlotParser(jconf, string_lookup=lookup).parse_file(files[0])
    got = SlotParser(port_conf(jconf), string_lookup=lookup).parse_file(
        files[0])
    assert_records_equal(got, want)


def _error_budget(files, tmp_path):
    from paddlebox_tpu.data.ingest import ErrorBudget as JaxBudget
    from paddlebox_tpu_torch.data.ingest import ErrorBudget
    path = str(tmp_path / "bad")
    with open(files[0]) as f:
        lines = f.readlines()
    lines[7:7] = ["1 1 x\n", "2 bogus\n"]
    with open(path, "w") as f:
        f.writelines(lines)
    jb, pb = JaxBudget(max_bad_lines=2), ErrorBudget(max_bad_lines=2)
    want = JaxSlotParser(jax_conf()).parse_file(path, budget=jb)
    got = SlotParser(port_conf(jax_conf())).parse_file(path, budget=pb)
    assert_records_equal(got, want)
    assert [vars(b) for b in pb.bad_lines] == [vars(b) for b in jb.bad_lines]
    assert [b.lineno for b in pb.bad_lines] == [8, 9]


def _set_merge_by_insid(files, tmp_path):
    (jds,), (pds,) = both_datasets(ins_id_files(files, tmp_path),
                                   jax_conf(parse_ins_id=True), merge=2)
    assert_records_equal(pds.records, jds.records)
    assert pds.merge_dropped == jds.merge_dropped == 0
    assert len(pds.records) == 141


def _shuffle_partition(files, tmp_path):
    (jds,), (pds,) = both_datasets(files)
    for g, w in zip(pds.shuffle_partition(3), jds.shuffle_partition(3)):
        assert_records_equal(g, w)


def _global_shuffle(files, tmp_path):
    jshards, pshards = both_datasets(files, n=3)
    ref_dataset.global_shuffle(jshards)
    port_dataset.global_shuffle(pshards)
    for g, w in zip(pshards, jshards):
        assert_records_equal(g.records, w.records)


def _global_merge_by_insid(files, tmp_path):
    jshards, pshards = both_datasets(ins_id_files(files, tmp_path),
                                     jax_conf(parse_ins_id=True), n=2)
    assert port_dataset.global_merge_by_insid(pshards, 2) == \
        ref_dataset.global_merge_by_insid(jshards, 2) == 0
    for g, w in zip(pshards, jshards):
        assert_records_equal(g.records, w.records)


def _slots_shuffle(files, tmp_path):
    (jds,), (pds,) = both_datasets(files)
    np.testing.assert_array_equal(pds.slots_shuffle([0, 2], seed=3),
                                  jds.slots_shuffle([0, 2], seed=3))
    assert_records_equal(pds.records, jds.records)


def _unshuffle(files, tmp_path):
    (jds,), (pds,) = both_datasets(files)
    want = [r.uint64_feas.copy() for r in pds.records]
    perm = pds.slots_shuffle([1], seed=5)
    jds.unshuffle([1], jds.slots_shuffle([1], seed=5))
    pds.unshuffle([1], perm)
    assert_records_equal(pds.records, jds.records)
    for r, w in zip(pds.records, want):
        np.testing.assert_array_equal(r.uint64_feas, w)


def _spill_to_disk(files, tmp_path):
    (jds,), (pds,) = both_datasets(files)
    n = [ds.spill_to_disk(str(tmp_path / name))
         for ds, name in ((jds, "ref.pbxa"), (pds, "port.pbxa"))]
    assert n == [141, 141] and pds.records == []
    assert (tmp_path / "ref.pbxa").read_bytes() == \
        (tmp_path / "port.pbxa").read_bytes()


def _load_from_archive(files, tmp_path):
    (jds,), (pds,) = both_datasets(files)
    want = [(r.uint64_feas.copy(), r.float_feas.copy()) for r in pds.records]
    jds.spill_to_disk(str(tmp_path / "ref.pbxa"))
    pds.load_from_archive(str(tmp_path / "ref.pbxa"))
    jds.load_from_archive(str(tmp_path / "ref.pbxa"))
    assert_records_equal(pds.records, jds.records)
    for r, (u, f) in zip(pds.records, want):
        np.testing.assert_array_equal(r.uint64_feas, u)
        np.testing.assert_array_equal(r.float_feas, f)


def _coordinator_global_shuffle(files, tmp_path):
    """Two ranks (threads over coordinators), a shard each: the cross-host
    shuffle's records on each rank, in order."""
    jshards, pshards = both_datasets(files, n=2)
    exchange("ref", "shuffle", jshards)
    exchange("port", "shuffle", pshards)
    for g, w in zip(pshards, jshards):
        assert_records_equal(g.records, w.records)
    assert min(len(g.records) for g in pshards) > 0


def _coordinator_global_merge_by_insid(files, tmp_path):
    """Two ranks, a shard each: the cross-host merge's records on each
    rank and its dropped count."""
    jshards, pshards = both_datasets(ins_id_files(files, tmp_path),
                                     jax_conf(parse_ins_id=True), n=2)
    assert exchange("port", "merge", pshards) == \
        exchange("ref", "merge", jshards) == [0, 0]
    for g, w in zip(pshards, jshards):
        assert_records_equal(g.records, w.records)


# options once refused here (ROADMAP A.2d and A.9b3, ported): each case
# holds the feature against the reference
PORTED = {"pipe_command": _pipe_command, "string_slot": _string_slot,
          "error_budget": _error_budget,
          "set_merge_by_insid": _set_merge_by_insid,
          "shuffle_partition": _shuffle_partition,
          "global_shuffle": _global_shuffle,
          "global_merge_by_insid": _global_merge_by_insid,
          "slots_shuffle": _slots_shuffle, "unshuffle": _unshuffle,
          "spill_to_disk": _spill_to_disk,
          "load_from_archive": _load_from_archive,
          "coordinator_global_shuffle": _coordinator_global_shuffle,
          "coordinator_global_merge_by_insid":
              _coordinator_global_merge_by_insid}
# none is refused now; the ids keep the order they had
ONCE_REFUSED = ("coordinator_global_merge_by_insid",
                "coordinator_global_shuffle")


@pytest.mark.parametrize("what", list(ONCE_REFUSED) + sorted(
    set(PORTED) - set(ONCE_REFUSED)))
def test_unported_options_refused(files, tmp_path, what):
    PORTED[what](files, tmp_path)


# label | slot_a | slot_b | slot_c | dense_x (dim 3), one line a record
ASSEMBLE_LINES = {
    "empty_slots": ["1 1 0 2 5 6 0 3 0.5 1 2", "1 0 3 1 2 3 0 0 3 1 1 1",
                    "1 1 0 0 1 9 3 0 0 0"],
    "no_keys": ["1 1 0 0 0 3 0.5 1 2", "1 0 1 4 0 0 3 1 1 1",
                "1 1 0 0 0 3 2 2 2"],
    "dense_wrong_width": ["1 1 1 5 1 6 1 7 2 0.5 1",
                          "1 0 1 5 1 6 1 7 4 1 2 3 4",
                          "1 1 1 5 1 6 1 7 0",
                          "1 0 1 5 1 6 1 7 3 7 8 9"],
}


def _assemble_records(case, rng):
    """The case's records (the lines, cycled to fill the batch), or for
    ``short_batch`` / ``full_batch`` 5 / 8 rows of a slot file."""
    if case in ASSEMBLE_LINES:
        lines = ASSEMBLE_LINES[case]
        return [lines[i % len(lines)] for i in range(8)]
    n = 5 if case == "short_batch" else 8
    out = []
    for _ in range(n):
        parts = [f"1 {int(rng.integers(0, 2))}"]
        for _ in range(3):
            k = int(rng.integers(0, 4))
            parts.append(" ".join(map(str, [k, *rng.integers(1, 99, k)])))
        parts.append("3 " + " ".join(map(str, rng.normal(size=3).round(3))))
        out.append(" ".join(parts))
    return out


@pytest.mark.parametrize("case", sorted(ASSEMBLE_LINES) +
                         ["full_batch", "short_batch"])
def test_assemble_matches_reference(case):
    """The vectorized assembly against the reference's loop, array for
    array: empty slots, records with no keys, dense slots narrower and
    wider than configured (truncated and zero-padded per slot) beside
    exact ones, a short batch and a batch of exactly B records; with
    logkeys, so that search_ids carry values."""
    from paddlebox_tpu.data.batch import BatchAssembler as JaxAssembler
    jconf = jax_conf(parse_logkey=True)
    rng = np.random.default_rng(len(case))
    lines = [f"1 {pack_logkey(1000 + i, 1, 2)} {line}"
             for i, line in enumerate(_assemble_records(case, rng))]
    jrecs = [JaxSlotParser(jconf).parse_line(x) for x in lines]
    precs = [SlotParser(port_conf(jconf)).parse_line(x) for x in lines]
    assert_records_equal(precs, jrecs)
    want = JaxAssembler(jconf).assemble(jrecs)
    got = BatchAssembler(port_conf(jconf)).assemble(precs)
    assert_batches_equal([got], [want])
    assert got.num_rows == len(lines)
    np.testing.assert_array_equal(got.search_ids[:len(lines)],
                                  1000 + np.arange(len(lines)))
    with pytest.raises(ValueError, match="assemble got 0 records"):
        BatchAssembler(port_conf(jconf)).assemble([])
