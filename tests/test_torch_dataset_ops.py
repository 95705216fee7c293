"""Port's record operations and dataset features (``data/record.py``
``merge_by_insid``, ``replace_sparse_slots``, ``SlotRecordPool``;
``data/archive.py``; ``data/dataset.py`` ``set_merge_by_insid``, the
in-process ``global_shuffle`` and ``global_merge_by_insid`` and their
cross-host forms over two coordinator ranks, ``slots_shuffle`` / ``unshuffle``, ``spill_to_disk`` /
``load_from_archive``, ``InputTableDataset``) against the JAX package's,
on the same seeded records and files.

Exact throughout: records field for field and in order (per dataset),
dropped counts, permutations, archive bytes (and each package's archive
loads in the other), side-input rows. Records of a shuffle carry keys, so
the partition hash never falls back to ``id`` (which differs between the
packages' objects)."""

import dataclasses
import os
import zlib

import numpy as np
import pytest

from paddlebox_tpu.config import DataFeedConfig as JaxFeedConfig
from paddlebox_tpu.config import SlotConfig as JaxSlotConfig
from paddlebox_tpu.data import archive as ref_archive
from paddlebox_tpu.data import dataset as ref_dataset
from paddlebox_tpu.data import record as ref_record
from paddlebox_tpu_torch.config import DataFeedConfig
from paddlebox_tpu_torch.data import archive, dataset, record
from paddlebox_tpu_torch.data.parser import SlotParser
from torch_coord_world import exchange

RECORD_FIELDS = ("uint64_feas", "uint64_offsets", "float_feas",
                 "float_offsets")
RECORD_SCALARS = ("label", "search_id", "cmatch", "rank", "ins_id")
PKGS = {"ref": (ref_record, ref_archive, ref_dataset),
        "port": (record, archive, dataset)}


def jax_conf(ins_id=False, thread_num=2, **kw):
    """A label, three sparse slots and a dense slot of 2."""
    return JaxFeedConfig(slots=[
        JaxSlotConfig("label", type="float", is_dense=True, dim=1),
        JaxSlotConfig("slot_a"), JaxSlotConfig("slot_b"),
        JaxSlotConfig("slot_c"),
        JaxSlotConfig("dense_x", type="float", is_dense=True, dim=2),
    ], batch_size=8, label_slot="label", parse_ins_id=ins_id,
        thread_num=thread_num, **kw)


def port_conf(jconf):
    return DataFeedConfig.from_dict(dataclasses.asdict(jconf))


def assert_records_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in RECORD_FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        for f in RECORD_SCALARS:
            assert getattr(g, f) == getattr(w, f), f


def record_fields(r):
    """Copies of a record's arrays and scalars (``ins_id`` last)."""
    return tuple([getattr(r, f).copy() for f in RECORD_FIELDS]
                 + [getattr(r, f) for f in RECORD_SCALARS])


def make_record(mod, slots, dense=None, label=0.0, ins_id="", search_id=0,
                num_float=1):
    """A record of ``mod`` (either package's ``record``): ``slots`` one
    key list a sparse slot, ``dense`` one value list a float slot."""
    r = mod.SlotRecord()
    vals = [np.asarray(v, np.uint64) for v in slots]
    r.uint64_feas = (np.concatenate(vals) if vals else
                     np.empty(0, np.uint64)).astype(np.uint64)
    r.uint64_offsets = np.concatenate(
        [[0], np.cumsum([v.size for v in vals])]).astype(np.int64)
    fl = [np.asarray(v, np.float32) for v in (dense or [[]] * num_float)]
    r.float_feas = (np.concatenate(fl) if fl else
                    np.empty(0, np.float32)).astype(np.float32)
    r.float_offsets = np.concatenate(
        [[0], np.cumsum([v.size for v in fl])]).astype(np.int64)
    r.label, r.ins_id, r.search_id = label, ins_id, search_id
    return r


def seeded_records(mod, n, seed, ins_ids=None, n_slots=3):
    """``n`` seeded records (1-3 keys in each slot, two dense values);
    ``ins_ids`` names them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        slots = [rng.integers(1, 1 << 62, size=int(rng.integers(1, 4)))
                 for _ in range(n_slots)]
        out.append(make_record(
            mod, slots, [rng.normal(size=2).round(3)],
            label=float(rng.integers(0, 2)),
            ins_id=ins_ids[i] if ins_ids else "",
            search_id=int(rng.integers(0, 1 << 40))))
    return out


def write_ins_file(path, rng, ids, parts):
    """MultiSlot lines with ``1 <ins_id>`` groups: each id of ``ids`` in
    ``parts[id]`` parts (sparse slots split between them, the dense slot
    in the last part, an all-zero dense slot in the others)."""
    lines = []
    for ins in ids:
        n = parts[ins]
        owner = rng.integers(0, n, size=3)
        for p in range(n):
            toks = [f"1 {ins}", f"1 {int(rng.integers(0, 2))}"]
            for s in range(3):
                if owner[s] == p:
                    k = rng.integers(1, 1 << 40,
                                     size=int(rng.integers(1, 3)))
                    toks.append(f"{k.size} " + " ".join(map(str, k)))
                else:
                    toks.append("0")
            d = (rng.normal(size=2).round(3) if p == n - 1
                 else np.zeros(2))
            toks.append("2 " + " ".join(map(str, d)))
            lines.append(" ".join(toks))
    rng.shuffle(lines)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


@pytest.fixture(scope="module")
def ins_files(tmp_path_factory):
    """Two files of two-part instances (an instance's parts may sit in
    either file), a few of one or three parts (dropped at merge size 2)
    and one whose slot_a is in both parts (a conflict)."""
    d = tmp_path_factory.mktemp("ins")
    rng = np.random.default_rng(5)
    ids = [f"ins-{i:03d}" for i in range(40)]
    parts = {ins: (1 if i % 13 == 0 else 3 if i % 17 == 5 else 2)
             for i, ins in enumerate(ids)}
    p0 = write_ins_file(str(d / "ins-0"), rng, ids[:24], parts)
    p1 = write_ins_file(str(d / "ins-1"), rng, ids[24:], parts)
    with open(p1, "a") as f:
        f.write("1 clash 1 1 1 5 0 0 2 0 0\n1 clash 1 0 1 6 1 7 0 "
                "2 1 2\n")
    return [p0, p1]


# -- merge_by_insid ----------------------------------------------------------

MERGES = {
    # parts (slots, dense) of each instance, float_is_dense, merge_size
    "two_parts": ([("a", [[1, 2], [], []], [[0.0, 0.0]]),
                   ("a", [[], [3], [4, 5]], [[1.0, 2.0]])], None, 2),
    "sparse_conflict_drops": ([("a", [[1], [], []], [[0.0, 0.0]]),
                               ("a", [[2], [3], []], [[0.0, 0.0]])], None, 2),
    "last_nonzero_dense_wins": ([("a", [[1], [], []], [[1.0, 0.0]]),
                                 ("a", [[], [2], []], [[0.0, 0.0]]),
                                 ("a", [[], [], [3]], [[5.0, 6.0]])],
                                None, 3),
    "zero_dense_claims_when_unclaimed": (
        [("a", [[1], [], []], [[0.0, 0.0]]),
         ("a", [[], [2], []], [[]])], None, 2),
    "sparse_float_conflict": ([("a", [[1], [], []], [[1.0, 1.0]]),
                               ("a", [[], [2], []], [[2.0, 2.0]])],
                              [False], 2),
    "wrong_part_count_drops": ([("a", [[1], [], []], [[0.0, 0.0]]),
                                ("b", [[2], [], []], [[0.0, 0.0]]),
                                ("b", [[], [3], []], [[1.0, 1.0]])],
                               None, 2),
    "merge_size_0_any_count": ([("a", [[1], [], []], [[0.0, 0.0]]),
                                ("b", [[2], [], []], [[0.0, 0.0]]),
                                ("b", [[], [3], []], [[1.0, 1.0]]),
                                ("b", [[], [], [4]], [[0.0, 0.0]])],
                               None, 0),
}


@pytest.mark.parametrize("case", sorted(MERGES))
def test_merge_by_insid_matches_reference(case):
    """Each conflict and drop rule: the merged records (order, fields)
    and the dropped count; dropped and merged parts go back to the
    pool."""
    parts, dense, size = MERGES[case]
    outs = []
    for pkg in ("ref", "port"):
        mod = PKGS[pkg][0]
        recs = [make_record(mod, s, d, label=float(i), ins_id=ins,
                            search_id=i)
                for i, (ins, s, d) in enumerate(parts)]
        pool = mod.SlotRecordPool(max_size=100)
        merged, dropped = mod.merge_by_insid(recs, 3, 1, size, pool=pool,
                                             float_is_dense=dense)
        outs.append((merged, dropped, len(pool)))
    (wm, wd, wp), (gm, gd, gp) = outs
    assert_records_equal(gm, wm)
    assert (gd, gp) == (wd, wp)
    assert gd == {"two_parts": 0, "sparse_conflict_drops": 2,
                  "last_nonzero_dense_wins": 0,
                  "zero_dense_claims_when_unclaimed": 0,
                  "sparse_float_conflict": 2, "wrong_part_count_drops": 1,
                  "merge_size_0_any_count": 0}[case]


def test_replace_sparse_slots_and_pool_match_reference():
    """``replace_sparse_slots`` (a slot emptied, one grown) and the
    pool's recycling: fields reset, capacity honoured."""
    outs = []
    for pkg in ("ref", "port"):
        mod = PKGS[pkg][0]
        r = seeded_records(mod, 1, 3)[0]
        mod.replace_sparse_slots(r, {0: np.empty(0, np.uint64),
                                     2: np.arange(5, dtype=np.uint64)})
        pool = mod.SlotRecordPool(max_size=3)
        pool.put(seeded_records(mod, 5, 4))
        got = pool.get(4)
        outs.append((r, len(pool), [x.uint64_feas for x in got],
                     [x.search_id for x in got]))
    assert_records_equal([outs[1][0]], [outs[0][0]])
    assert outs[0][1:] == outs[1][1:] == (0, [None] * 4, [0] * 4)


def test_merge_over_files_matches_reference(ins_files):
    """``set_merge_by_insid(2)`` over the files: the reference's merged
    records and dropped count (the one- and three-part instances and the
    conflict)."""
    outs = []
    for pkg in ("ref", "port"):
        ds_mod = PKGS[pkg][2]
        conf = jax_conf(ins_id=True)
        ds = ds_mod.SlotDataset(conf if pkg == "ref" else port_conf(conf))
        ds.set_merge_by_insid(2)
        ds.set_filelist(ins_files)
        ds.load_into_memory()
        outs.append((ds.records, ds.merge_dropped))
    assert_records_equal(outs[1][0], outs[0][0])
    assert outs[1][1] == outs[0][1] > 0
    assert all(len(r.slot_float(0)) == 2 for r in outs[1][0])


def test_set_merge_by_insid_refusals_match_reference():
    for pkg in ("ref", "port"):
        ds_mod = PKGS[pkg][2]
        conf = jax_conf()
        conf = conf if pkg == "ref" else port_conf(conf)
        with pytest.raises(ValueError, match="parse_ins_id"):
            ds_mod.SlotDataset(conf).set_merge_by_insid(2)
        ins = dataclasses.replace(conf, parse_ins_id=True)
        with pytest.raises(ValueError, match="global_merge_by_insid"):
            ds_mod.SlotDataset(ins, shard_id=0,
                               num_shards=2).set_merge_by_insid(2)


# -- global shuffles ---------------------------------------------------------

def shards_of(pkg, n, rows=(30, 17, 41), seed=0):
    """``n`` in-memory datasets of seeded records (keys always present),
    each with its own ``seeded_records``."""
    rec_mod, _, ds_mod = PKGS[pkg]
    conf = jax_conf()
    out = []
    for i in range(n):
        ds = ds_mod.SlotDataset(conf if pkg == "ref" else port_conf(conf),
                                shard_id=i, num_shards=n)
        ds.records = seeded_records(rec_mod, rows[i % len(rows)], seed + i)
        out.append(ds)
    return out


@pytest.mark.parametrize("n", [1, 2, 3])
def test_global_shuffle_matches_reference(n):
    """``shuffle_partition`` of each shard and ``global_shuffle``: every
    dataset's records in the reference's order; nothing lost, and each
    shard's records hash to it."""
    parts, shards = [], []
    for pkg in ("ref", "port"):
        ds = shards_of(pkg, n)
        parts.append([d.shuffle_partition(n) for d in ds])
        PKGS[pkg][2].global_shuffle(ds)
        shards.append(ds)
    for wp, gp in zip(*parts):
        for w, g in zip(wp, gp):
            assert_records_equal(g, w)
    for w, g in zip(*shards):
        assert_records_equal(g.records, w.records)
    got = shards[1]
    assert sum(d.num_instances() for d in got) == sum(
        (30, 17, 41)[i % 3] for i in range(n))
    for i, d in enumerate(got):
        assert len(d.shuffle_partition(n)[i]) == d.num_instances()


@pytest.mark.parametrize("n", [2, 3])
def test_global_merge_by_insid_matches_reference(ins_files, n):
    """Shards loaded from the instance files (round-robin by file, so an
    instance's parts sit on different shards): each shard's merged
    records in the reference's order, the total dropped count; each
    instance lands on shard ``crc32(ins_id) % n``."""
    outs = []
    for pkg in ("ref", "port"):
        ds_mod = PKGS[pkg][2]
        conf = jax_conf(ins_id=True)
        conf = conf if pkg == "ref" else port_conf(conf)
        shards = []
        for i in range(n):
            ds = ds_mod.SlotDataset(conf, shard_id=i, num_shards=n)
            ds.set_filelist(ins_files)
            ds.load_into_memory()
            shards.append(ds)
        dropped = ds_mod.global_merge_by_insid(shards, 2)
        outs.append((shards, dropped))
    (ws, wd), (gs, gd) = outs
    assert gd == wd > 0
    for w, g in zip(ws, gs):
        assert_records_equal(g.records, w.records)
        assert g.merge_dropped == w.merge_dropped
    for i, d in enumerate(gs):
        assert all(zlib.crc32(r.ins_id.encode()) % n == i
                   for r in d.records)


def test_slots_shuffle_and_unshuffle_match_reference():
    """``slots_shuffle`` of slots 0 and 2 (seed 7): the same permutation
    and records; ``unshuffle`` restores the originals exactly."""
    outs = []
    for pkg in ("ref", "port"):
        (ds,) = shards_of(pkg, 1)
        before = [(r.uint64_feas.copy(), r.uint64_offsets.copy())
                  for r in ds.records]
        perm = ds.slots_shuffle([0, 2], seed=7)
        shuffled = [(r.uint64_feas.copy(), r.uint64_offsets.copy())
                    for r in ds.records]
        ds.unshuffle([0, 2], perm)
        outs.append((perm, shuffled, ds.records, before))
    (wp, ws, wr, _), (gp, gs, gr, gb) = outs
    np.testing.assert_array_equal(gp, wp)
    for (a, b), (c, d) in zip(gs, ws):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    assert_records_equal(gr, wr)
    for r, (feas, offs) in zip(gr, gb):
        np.testing.assert_array_equal(r.uint64_feas, feas)
        np.testing.assert_array_equal(r.uint64_offsets, offs)


def coordinator_exchanges(ins_files, pkg):
    """Two ranks as threads, each holding one of the instance files (an
    instance's parts on both): ``coordinator_global_merge_by_insid``
    (merge size 2), then ``coordinator_global_shuffle`` of the merged
    records. Returns (the ranks' datasets, merged records, dropped)."""
    ds_mod = PKGS[pkg][2]
    conf = jax_conf(ins_id=True)
    conf = conf if pkg == "ref" else port_conf(conf)
    shards = []
    for path in ins_files:
        ds = ds_mod.SlotDataset(conf)
        ds.set_filelist([path])
        ds.load_into_memory()
        shards.append(ds)
    dropped = exchange(pkg, "merge", shards)
    # the shuffle recycles the records it sends: copies of the merge's
    merged = [[record_fields(x) for x in d.records] for d in shards]
    exchange(pkg, "shuffle", shards)
    return shards, merged, dropped


def test_coordinator_shuffles_refused(ins_files):
    """The cross-host merge and shuffle (once refused here) at 2 ranks
    against the reference's (``tests/test_data_pipeline.py``): each rank's
    merged records in order and its dropped count, then its shuffled
    records in order; each merged instance lands on rank ``crc32(ins_id)
    % 2``, and the shuffle loses nothing."""
    (ws, wm, wd), (gs, gm, gd) = (coordinator_exchanges(ins_files, pkg)
                                  for pkg in ("ref", "port"))
    assert gd == wd and sum(gd) > 0
    for r in range(2):
        assert len(gm[r]) == len(wm[r])
        for g, w in zip(gm[r], wm[r]):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        assert gs[r].merge_dropped == ws[r].merge_dropped == gd[r]
        assert all(zlib.crc32(x[-1].encode()) % 2 == r for x in gm[r])
        assert_records_equal(gs[r].records, ws[r].records)
    assert sorted(x.ins_id for d in gs for x in d.records) == \
        sorted(x[-1] for m in gm for x in m)


# -- archives ------------------------------------------------------------------

@pytest.mark.parametrize("chunk_size", [1, 7, 4096])
def test_archive_bytes_match_reference(tmp_path, chunk_size):
    """The same records (ins_ids, logkey fields, empty slots) written by
    each package: identical bytes on disk and through ``BytesIO``
    (``records_to_bytes``); each package reads the other's archive back
    to the same records."""
    ids = [f"id-{i}" for i in range(23)]
    recs = {pkg: seeded_records(PKGS[pkg][0], 23, 9, ids)
            for pkg in PKGS}
    for pkg in PKGS:
        recs[pkg][4].uint64_feas = np.empty(0, np.uint64)
        recs[pkg][4].uint64_offsets = np.zeros(4, np.int64)
    blobs, paths = {}, {}
    for pkg, (_, arc, _) in PKGS.items():
        paths[pkg] = str(tmp_path / f"{pkg}.pbxa")
        with arc.ArchiveWriter(paths[pkg], chunk_size=chunk_size) as w:
            w.write_all(recs[pkg])
        blobs[pkg] = arc.records_to_bytes(recs[pkg])
    with open(paths["ref"], "rb") as a, open(paths["port"], "rb") as b:
        ref_bytes, port_bytes = a.read(), b.read()
    assert port_bytes == ref_bytes
    assert blobs["port"] == blobs["ref"]
    if chunk_size == 4096:       # records_to_bytes's chunk size
        assert ref_bytes == blobs["ref"]
    for reader, writer in (("port", "ref"), ("ref", "port")):
        back = PKGS[reader][1].ArchiveReader(paths[writer]).read_all()
        assert_records_equal(back, recs[reader])
        assert_records_equal(
            PKGS[reader][1].records_from_bytes(blobs[writer]), back)
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_archive_errors_match_reference(tmp_path):
    """Not an archive: the same ``ValueError``; an error mid-spill
    leaves no archive at the path (nor a tmp file)."""
    bad = tmp_path / "bad"
    bad.write_bytes(b"nope")
    msgs = []
    for pkg in PKGS:
        with pytest.raises(ValueError) as e:
            PKGS[pkg][1].ArchiveReader(str(bad)).read_all()
        msgs.append(str(e.value))
        dst = str(tmp_path / f"{pkg}-aborted.pbxa")
        with pytest.raises(RuntimeError):
            with PKGS[pkg][1].ArchiveWriter(dst) as w:
                w.write_all(seeded_records(PKGS[pkg][0], 3, 1))
                raise RuntimeError("mid-spill")
        assert not os.path.exists(dst)
    assert msgs[0] == msgs[1]
    assert [f for f in os.listdir(tmp_path)] == ["bad"]


def test_spill_and_load_from_archive_match_reference(tmp_path, ins_files):
    """``spill_to_disk`` of the loaded instance files (identical bytes,
    the count written), then ``load_from_archive`` with
    ``set_merge_by_insid(2)``: the same merged records as a merge at
    load."""
    outs = []
    for pkg in ("ref", "port"):
        ds_mod = PKGS[pkg][2]
        conf = jax_conf(ins_id=True)
        conf = conf if pkg == "ref" else port_conf(conf)
        ds = ds_mod.SlotDataset(conf)
        ds.set_filelist(ins_files)
        ds.load_into_memory()
        path = str(tmp_path / f"{pkg}.pbxa")
        n = ds.spill_to_disk(path)
        assert ds.records == []
        ds.set_merge_by_insid(2)
        ds.load_from_archive(path)
        with open(path, "rb") as f:
            outs.append((n, f.read(), ds.records, ds.merge_dropped))
    (wn, wb, wr, wd), (gn, gb, gr, gd) = outs
    assert (gn, gd) == (wn, wd) and gb == wb
    assert_records_equal(gr, wr)


# -- string slots and InputTableDataset --------------------------------------

def string_conf():
    return JaxFeedConfig(slots=[
        JaxSlotConfig(name="label", type="float"), JaxSlotConfig(name="f1"),
        JaxSlotConfig(name="city", type="string"),
        JaxSlotConfig(name="d", type="float", is_dense=True, dim=2),
    ], batch_size=4)


@pytest.fixture(scope="module")
def table_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("input_table")
    rng = np.random.default_rng(2)
    cities = [f"city{i}" for i in range(12)]
    idx = d / "index"
    idx.write_text("".join(
        f"{c} {rng.normal():.4f} {rng.normal():.4f}\n" for c in cities[:9]))
    lines = []
    for _ in range(21):
        n = int(rng.integers(0, 3))
        toks = rng.choice(cities + ["unknown"], size=n)
        lines.append(f"1 {int(rng.integers(0, 2))} 1 "
                     f"{int(rng.integers(1, 1000))} {n} " + " ".join(toks)
                     + f" 2 {rng.normal():.3f} {rng.normal():.3f}")
    data = d / "part-0"
    data.write_text("\n".join(lines) + "\n")
    return str(idx), str(data)


@pytest.mark.parametrize("preload", [False, True])
def test_input_table_dataset_matches_reference(table_files, preload):
    """Salted side-table offsets in the key stream (misses on offset
    0), the batches, ``side_input`` of each batch and the table's miss
    count; the index loads before a background preload too."""
    idx, data = table_files
    outs = []
    for pkg in ("ref", "port"):
        ds_mod = PKGS[pkg][2]
        conf = string_conf() if pkg == "ref" else port_conf(string_conf())
        ds = ds_mod.InputTableDataset(conf, table_dim=2)
        ds.set_index_filelist([idx])
        ds.set_filelist([data])
        if preload:
            ds.preload_into_memory()
            ds.wait_preload_done()
        else:
            ds.load_into_memory()
        batches = list(ds.batches())
        outs.append((ds.records, batches,
                     [ds.side_input(b, slot_index=1) for b in batches],
                     ds.input_table.miss, len(ds.input_table)))
    (wr, wb, ws, wm, wl), (gr, gb, gs, gm, gl) = outs
    assert_records_equal(gr, wr)
    assert len(gb) == len(wb) == 6
    for g, w in zip(gb, wb):
        np.testing.assert_array_equal(g.keys, w.keys)
        np.testing.assert_array_equal(g.lengths, w.lengths)
    for g, w in zip(gs, ws):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (gm, gl) == (wm, wl) and gm > 0 and gl == 10
    salt = int(dataset.InputTableDataset.KEY_SALT)
    offs = {int(k) ^ salt for r in gr for k in r.slot_uint64(1)}
    assert 0 in offs and offs <= set(range(10))


def test_string_slot_without_lookup_rejected():
    with pytest.raises(ValueError, match="string_lookup"):
        SlotParser(port_conf(string_conf()))
