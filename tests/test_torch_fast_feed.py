"""Port's columnar file feed (``ps/native.py::parse_block`` over
``csrc/pbx_feed.cpp``, ``data/fast_feed.py`` ``FastSlotReader``) against
the JAX package's on the same bytes and files: the tokenizer's outputs,
the batches (remainder carried across files, prefetch 0 and 2, scratch
buffers on and off) and the stream's tuples, all exact; the reference's
error cases (``tests/test_fast_feed.py::TestErrors``) with the same
exception types and messages; and the options once refused, among them
``stream_columnar``'s views against the reference's."""

import dataclasses

import numpy as np
import pytest

from paddlebox_tpu.config import BucketSpec as JaxBucketSpec
from paddlebox_tpu.config import DataFeedConfig as JaxFeedConfig
from paddlebox_tpu.config import SlotConfig as JaxSlotConfig
from paddlebox_tpu.data.fast_feed import FastSlotReader as JaxReader
from paddlebox_tpu.ps import native as ref_native
from paddlebox_tpu_torch.config import BucketSpec, DataFeedConfig
from paddlebox_tpu_torch.data import fast_feed
from paddlebox_tpu_torch.data.fast_feed import FastSlotReader
from paddlebox_tpu_torch.ps import native

pytestmark = pytest.mark.skipif(not ref_native.available(),
                                reason="native backend unavailable")

BATCH_FIELDS = ("keys", "segment_ids", "lengths", "labels", "dense")
INT_FIELDS = ("batch_size", "num_slots", "num_keys", "num_rows")


def mixed_conf(batch_size=64):
    """The reference tests' ``mixed_conf``: a label, six sparse slots, a
    3-wide float slot, a skipped sparse slot and one more sparse slot."""
    slots = ([JaxSlotConfig(name="label", type="float")] +
             [JaxSlotConfig(name=f"s{i}") for i in range(6)] +
             [JaxSlotConfig(name="d0", type="float", dim=3)] +
             [JaxSlotConfig(name="skipped", is_used=False)] +
             [JaxSlotConfig(name="s6")])
    return JaxFeedConfig(slots=slots, batch_size=batch_size)


def port_conf(jconf):
    return DataFeedConfig.from_dict(dataclasses.asdict(jconf))


def write_file(path, conf, rows, seed=0):
    """MultiSlot lines for ``conf``: keys up to 2^64 - 1, 0-3 keys a slot
    (a slot may be empty), normal floats."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(rows):
            parts = []
            for s in conf.slots:
                if s.name == conf.label_slot:
                    parts.append(f"1 {int(rng.integers(0, 2))}")
                elif s.type == "uint64":
                    n = int(rng.integers(0, 4))
                    parts.append(" ".join([str(n)] + [
                        str(v) for v in rng.integers(
                            1, np.iinfo(np.uint64).max, size=n,
                            dtype=np.uint64, endpoint=True)]))
                else:
                    vals = rng.normal(size=s.dim).round(4)
                    parts.append(f"{s.dim} " + " ".join(map(str, vals)))
            f.write(" ".join(parts) + "\n")
    return path


def kinds_of(conf):
    return JaxReader(conf).kinds


BLOCKS = {
    "file": None,   # a written file's bytes
    "whitespace": b"\n\n 1 1\t2 5 6 1 7 0 0 0 0 3 0.5 -1.5 2e3 1 9 1 8 \r\n"
                  b"1 0 1 1 0 0 0 0 0 3 1 2 3 0 0\n\n",
    "no_newline_at_end": b"1 1 1 5 0 0 0 0 0 3 1 2 3 0 0",
    "u64_limits": b"1 1 2 18446744073709551615 0 1 1 1 2 0 0 0 "
                  b"3 0 -0 1e-41 0 1 123456789012345678901234\n",
    "special_floats": b"1 0.25 1 5 0 0 0 0 0 3 inf -inf nan 0 0\n"
                      b"1 1e-45 1 6 0 0 0 0 0 3 3.4e38 -3.4e38 1.5e-7 0 0\n",
    "empty": b"",
}


@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_parse_block_matches_reference(tmp_path, case):
    """Every output of the tokenizer, dtype and value, on the same bytes
    (nan compared as nan)."""
    conf = mixed_conf()
    data = BLOCKS[case]
    if data is None:
        with open(write_file(str(tmp_path / "f"), conf, 150), "rb") as f:
            data = f.read()
    args = (kinds_of(conf), 7, 1)
    got = native.parse_block(data, *args)
    want = ref_native.parse_block(data, *args)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


BAD_BLOCKS = {
    "not_a_number": b"1 0 1 5 0 0 0 0 0 3 1 2 3 0 0\n1 0 2 11 notanumber\n",
    "hex_float": b"1 0x10 1 11 1 12 1 13 1 14 1 15 1 16 3 0.1 0.2 0.3 1 17 "
                 b"1 18\n",
    "float_overflow": b"1 0 1 5 0 0 0 0 0 3 1 2 3 0 0\n1 0 1 11 1 12 1 13 "
                      b"1 14 1 15 1 16 3 0.1 1e39 0.3 1 17 1 18\n",
    "float_underflow": b"1 0 1 5 0 0 0 0 0 3 1 1e-50 3 0 0\n",
    "plus_sign": b"1 +1 1 5 0 0 0 0 0 3 1 2 3 0 0\n",
    "trailing_token": b"1 0 1 5 0 0 0 0 0 3 1 2 3 0 0 7\n",
    "truncated": b"1 0 1 5 0 0 0 0 0 3 1 2 3 0 0\n1 0 1 5 0 0\n",
    "negative_key": b"1 0 1 -5 0 0 0 0 0 3 1 2 3 0 0\n",
}


@pytest.mark.parametrize("case", sorted(BAD_BLOCKS))
def test_parse_block_errors_match_reference(case):
    conf = mixed_conf()
    args = (BAD_BLOCKS[case], kinds_of(conf), 7, 1)
    with pytest.raises(RuntimeError) as want:
        ref_native.parse_block(*args)
    with pytest.raises(RuntimeError) as got:
        native.parse_block(*args)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("malformed slot record at row ")


def assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in BATCH_FIELDS:
            a, b = g[f], w[f]
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        for f in INT_FIELDS:
            assert g[f] == w[f], f


def batch_copies(batches):
    """Each batch's arrays copied as it comes (scratch batches are valid
    only until the next one)."""
    for b in batches:
        yield {**{f: getattr(b, f).copy() for f in BATCH_FIELDS},
               **{f: getattr(b, f) for f in INT_FIELDS}}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Files of 50, 20 (shorter than a batch), 0, 70 and 33 rows: the
    remainder carries across files, through an empty one."""
    d = tmp_path_factory.mktemp("fast_feed")
    conf = mixed_conf()
    return [write_file(str(d / f"part-{i}"), conf, rows, seed=i)
            for i, rows in enumerate((50, 20, 0, 70, 33))]


@pytest.mark.parametrize("scratch", [False, True], ids=["fresh", "scratch"])
@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("drop_remainder", [False, True],
                         ids=["remainder", "drop"])
def test_batches_match_reference(files, prefetch, scratch, drop_remainder):
    """173 rows in batches of 64 (two full, 45 rows carried to the end),
    key padding from a small bucket so it varies by batch."""
    conf = mixed_conf()
    jbuckets = dict(min_size=16, max_size=4096)
    want = JaxReader(conf, JaxBucketSpec(**jbuckets)).batches(
        files, drop_remainder=drop_remainder, prefetch=prefetch,
        scratch=scratch)
    got = FastSlotReader(port_conf(conf), BucketSpec(**jbuckets)).batches(
        files, drop_remainder=drop_remainder, prefetch=prefetch,
        scratch=scratch)
    got, want = list(batch_copies(got)), list(batch_copies(want))
    assert_batches_equal(got, want)
    assert [b["num_rows"] for b in got] == \
        ([64, 64] if drop_remainder else [64, 64, 45])


def test_batches_reused_reader_matches_reference(files):
    """A reader reused over passes (its arenas keep their buffers) gives
    the reference's batches each time."""
    conf = mixed_conf(batch_size=32)
    reader = FastSlotReader(port_conf(conf))
    want = list(batch_copies(JaxReader(conf).batches(files, scratch=True)))
    for _ in range(2):
        assert_batches_equal(batch_copies(reader.batches(files,
                                                         scratch=True)),
                             want)


@pytest.mark.parametrize("drop_remainder", [False, True],
                         ids=["remainder", "drop"])
def test_stream_matches_reference(files, drop_remainder):
    """The (keys, segment_ids, cvm_in, labels, dense, row_mask) tuples
    ``train_stream`` consumes, exact."""
    conf = mixed_conf(batch_size=48)
    got = list(FastSlotReader(port_conf(conf)).stream(
        files, drop_remainder=drop_remainder, prefetch=2))
    want = list(JaxReader(conf).stream(files, drop_remainder=drop_remainder,
                                       prefetch=2))
    assert len(got) == len(want) == (3 if drop_remainder else 4)
    for g, w in zip(got, want):
        assert len(g) == len(w) == 6
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert got[-1][5].sum() == (48 if drop_remainder else 173 - 3 * 48)


def test_parse_file_matches_reference(files):
    conf = mixed_conf()
    got = FastSlotReader(port_conf(conf)).parse_file(files[0])
    want = JaxReader(conf).parse_file(files[0])
    assert got.rows == want.rows == 50
    for f in ("keys", "lengths", "labels", "dense"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_prefetched_parse_error_raises_in_order(files, tmp_path):
    """A malformed file parsed ahead on the prefetch thread raises when
    the consumer reaches it, after the batches before it."""
    bad = str(tmp_path / "bad")
    with open(bad, "w") as f:
        f.write("1 0 2 11 notanumber\n")
    conf = mixed_conf(batch_size=50)
    it = FastSlotReader(port_conf(conf)).batches([files[0], bad],
                                                 prefetch=2)
    assert next(it).num_rows == 50
    with pytest.raises(RuntimeError, match="row 0"):
        next(it)


# -- the reference's TestErrors ------------------------------------------

def _append(path, line):
    with open(path, "a") as f:
        f.write(line)
    return path


ERRORS = {
    "malformed_row": (lambda d, c: _append(write_file(d, c, 3),
                                           "1 0 2 11 notanumber\n"),
                      "row 3"),
    "out_of_range_float": (lambda d, c: _append(
        write_file(d, c, 2), "1 0 1 11 1 12 1 13 1 14 1 15 1 16 "
                             "3 0.1 1e39 0.3 1 17 1 18\n"), "row 2"),
    "hex_float": (lambda d, c: _append(
        write_file(d, c, 2), "1 0x10 1 11 1 12 1 13 1 14 1 15 1 16 "
                             "3 0.1 0.2 0.3 1 17 1 18\n"), "row 2"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_parse_file_errors_match_reference(tmp_path, case):
    conf = mixed_conf()
    make, row = ERRORS[case]
    path = make(str(tmp_path / "bad"), conf)
    with pytest.raises(RuntimeError) as want:
        JaxReader(conf).parse_file(path)
    with pytest.raises(RuntimeError) as got:
        FastSlotReader(port_conf(conf)).parse_file(path)
    assert str(got.value) == str(want.value)
    assert row in str(got.value)


def test_subnormal_float_accepted(tmp_path):
    conf = mixed_conf()
    p = str(tmp_path / "sub")
    with open(p, "w") as f:
        f.write("1 0 1 11 1 12 1 13 1 14 1 15 1 16 "
                "3 0.1 1e-41 0.3 1 17 1 18\n")
    blk = FastSlotReader(port_conf(conf)).parse_file(p)
    assert blk.rows == 1
    assert 0.0 < blk.dense[0, 1] < 1e-40
    assert blk.dense[0, 1] == JaxReader(conf).parse_file(p).dense[0, 1]


def test_wrong_dense_dim_rejected(tmp_path):
    conf = JaxFeedConfig(slots=[
        JaxSlotConfig(name="label", type="float"),
        JaxSlotConfig(name="s0"),
        JaxSlotConfig(name="d0", type="float", dim=3)], batch_size=4)
    p = str(tmp_path / "bad")
    with open(p, "w") as f:
        f.write("1 1 1 5 3 0.5 0.5 0.5\n1 1 1 5 2 0.5 0.5\n")
    with pytest.raises(ValueError) as want:
        JaxReader(conf).parse_file(p)
    with pytest.raises(ValueError) as got:
        FastSlotReader(port_conf(conf)).parse_file(p)
    assert str(got.value) == str(want.value)
    assert "row 1 dense slot width" in str(got.value)


@pytest.mark.parametrize("field,value,match", [
    ("parse_logkey", True, "logkey"), ("parse_ins_id", True, "ins_id"),
    ("sample_rate", 0.5, "sample_rate")])
def test_record_pipeline_options_refused_like_reference(field, value,
                                                        match):
    conf = dataclasses.replace(mixed_conf(), **{field: value})
    with pytest.raises(ValueError) as want:
        JaxReader(conf)
    with pytest.raises(ValueError) as got:
        FastSlotReader(port_conf(conf))
    assert str(got.value) == str(want.value)
    assert match in str(got.value)


def _pipe_command(files):
    conf = dataclasses.replace(mixed_conf(), pipe_command="cat")
    assert_batches_equal(
        batch_copies(FastSlotReader(port_conf(conf)).batches(files)),
        batch_copies(JaxReader(conf).batches(files)))


def _string_slot(files):
    """A used "string" slot: a ``ValueError`` naming InputTableDataset
    (the record pipeline maps string keys). The reference's reader takes
    the slot and passes the tokenizer more float slots than its buffers
    hold, so it is not run here."""
    conf = mixed_conf()
    conf.slots[3] = dataclasses.replace(conf.slots[3], type="string")
    with pytest.raises(ValueError, match="InputTableDataset"):
        FastSlotReader(port_conf(conf))
    with pytest.raises(ValueError, match="InputTableDataset"):
        fast_feed.MultiProcessReader(port_conf(conf))


def _multi_process_reader(files):
    reader = fast_feed.MultiProcessReader(port_conf(mixed_conf()),
                                          workers=2)
    assert_batches_equal(batch_copies(reader.batches(files)),
                         batch_copies(JaxReader(mixed_conf()).batches(files)))
    assert reader.shm_counters["leaked_segments"] == 0


def _stream_columnar(files):
    """``ColumnarSlice`` views equal the reference's, slice for slice (a
    remainder carried across files, the last batch short), with prefetch
    0 and 2; on the single reader ``owner`` is None."""
    for prefetch in (0, 2):
        got = FastSlotReader(port_conf(mixed_conf())).stream_columnar(
            files, prefetch=prefetch)
        want = JaxReader(mixed_conf()).stream_columnar(files,
                                                       prefetch=prefetch)
        n = 0
        for g, w in zip(got, want, strict=True):
            for f in ("keys", "lengths", "labels", "dense"):
                a, b = getattr(g, f), getattr(w, f)
                assert a.dtype == b.dtype and np.array_equal(a, b), f
            assert (g.num_rows, g.num_keys, g.npad, g.owner) == \
                (w.num_rows, w.num_keys, w.npad, None)
            n += 1
        assert n > 1


# options once refused here, each held against the reference: A.2d's, and
# stream_columnar (A.4); the reader refuses none now
PORTED = {"pipe_command": _pipe_command, "string_slot": _string_slot,
          "multi_process_reader": _multi_process_reader,
          "stream_columnar": _stream_columnar}


@pytest.mark.parametrize("what", sorted(PORTED))
def test_unported_refused(files, what):
    PORTED[what](files)


def test_tokenizer_raises_its_build_error(monkeypatch):
    """No Python fallback: where the tokenizer cannot build,
    ``parse_block`` raises with the build error."""
    from paddlebox_tpu_torch.ops import _build

    def broken(name):
        raise RuntimeError(f"build failed: {name}: g++ exited 1")
    monkeypatch.setattr(native, "_feed_lib", None)
    monkeypatch.setattr(_build, "load", broken)
    with pytest.raises(RuntimeError, match="build failed: pbx_feed"):
        native.parse_block(b"1 0\n", np.array([3], np.int32), 0, 0)
