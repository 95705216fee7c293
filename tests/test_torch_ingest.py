"""Port's ingestion fault tolerance (``data/ingest.py``: ``ErrorBudget``,
``IngestStats``, the transient-I/O retries, the ``pipe_command``
watchdog) and ``data/criteo.py``'s budgeted ``CriteoReader`` and
``to_multislot``, against the JAX package's on the same files.

Exact: records, batches, error types and messages (paths included),
quarantine sidecars byte for byte, the stats' snapshots, converted files
byte for byte. A flag is set in both packages: the reference's registry
(``flags.set``) and the port's ``PBOX_FLAGS_<name>`` variable. A wedged
``pipe_command`` runs under a 1 s stall timeout."""

import os
import re
import time

import numpy as np
import pytest

from paddlebox_tpu import flags as ref_flags
from paddlebox_tpu.config import DataFeedConfig as JaxFeedConfig
from paddlebox_tpu.config import SlotConfig as JaxSlotConfig
from paddlebox_tpu.data import criteo as ref_criteo
from paddlebox_tpu.data import ingest as ref_ingest
from paddlebox_tpu.data.dataset import SlotDataset as JaxSlotDataset
from paddlebox_tpu.data.fast_feed import FastSlotReader as JaxReader
from paddlebox_tpu.data.parser import SlotParser as JaxSlotParser
from paddlebox_tpu.ps import native as ref_native
from paddlebox_tpu.utils import faults as ref_faults
from paddlebox_tpu_torch.config import DataFeedConfig
from paddlebox_tpu_torch.data import criteo, ingest
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.data.fast_feed import FastSlotReader
from paddlebox_tpu_torch.data.parser import SlotParser
from paddlebox_tpu_torch.utils import faults

INGEST_FLAGS = {"ingest_max_bad_lines": 0, "ingest_max_bad_frac": 0.0,
                "ingest_max_bad_files": 0, "ingest_retries": 3,
                "ingest_stall_timeout": 300.0, "ingest_quarantine_dir": ""}
RECORD_FIELDS = ("uint64_feas", "uint64_offsets", "float_feas",
                 "float_offsets")


@pytest.fixture
def set_flag(monkeypatch):
    """``set_flag(name, value)`` in both packages; the reference's
    registry is restored to its defaults after the test."""
    def set_(name, value):
        ref_flags.set(name, value)
        monkeypatch.setenv(f"PBOX_FLAGS_{name}", str(value))
    yield set_
    for name, value in INGEST_FLAGS.items():
        ref_flags.set(name, value)


@pytest.fixture(autouse=True)
def no_injectors():
    yield
    faults.install_injector(None)
    ref_faults.install_injector(None)


def jax_conf(pipe_command="", thread_num=2):
    """The reference ingest tests' ``two_slot_conf``."""
    return JaxFeedConfig(
        slots=[JaxSlotConfig("label", type="float", is_dense=True, dim=1),
               JaxSlotConfig("slot_a"), JaxSlotConfig("slot_b")],
        batch_size=8, pipe_command=pipe_command, thread_num=thread_num)


def port_conf(jconf):
    import dataclasses
    return DataFeedConfig.from_dict(dataclasses.asdict(jconf))


def write_mixed(path, good_rows, bad_rows=(), seed=0):
    """``good_rows`` seeded parseable lines with ``bad_rows`` ((position,
    text) pairs) inserted."""
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(good_rows):
        a = rng.integers(1, 1 << 40, size=int(rng.integers(1, 4)))
        b = rng.integers(1, 1 << 40, size=int(rng.integers(0, 3)))
        lines.append(f"1 {int(rng.integers(0, 2))} {a.size} "
                     + " ".join(map(str, a)) + f" {b.size} "
                     + " ".join(map(str, b)))
    for pos, text in bad_rows:
        lines.insert(pos, text)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def assert_records_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in RECORD_FIELDS:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        assert (g.label, g.ins_id) == (w.label, w.ins_id)


def both(fn):
    """``fn(pkg)`` for the reference then the port: each result, or the
    exception it raised."""
    out = []
    for pkg in ("ref", "port"):
        try:
            out.append(fn(pkg))
        except Exception as e:  # noqa: BLE001 - compared by the caller
            out.append(e)
    return out


def parse_budgeted(path, pkg, **budget_kw):
    """Parse ``path`` under an ``ErrorBudget(**budget_kw)`` of a fresh
    ``IngestStats``: (records, budget, stats), or the error raised."""
    mod, parser = ((ref_ingest, JaxSlotParser(jax_conf())) if pkg == "ref"
                   else (ingest, SlotParser(port_conf(jax_conf()))))
    stats = mod.IngestStats()
    budget = mod.ErrorBudget(stats=stats, **budget_kw)
    try:
        recs = parser.parse_file(path, budget=budget, stats=stats)
    finally:
        budget.close()
    return recs, budget, stats


BUDGETS = {
    # (good rows, bad (position, text), budget kwargs)
    "zero_fails_fast": (4, [(2, "2 bogus bad")], {}),
    "absolute": (10, [(1, "junk"), (5, "more junk")],
                 dict(max_bad_lines=2)),
    "overspend": (10, [(0, "a bad"), (4, "b bad"), (8, "c bad")],
                  dict(max_bad_lines=2)),
    "fraction": (100, [(50, "junk")], dict(max_bad_frac=0.05)),
    "fraction_overspent": (0, [(i, "junk") for i in range(50)],
                           dict(max_bad_frac=0.05)),
    "long_line": (6, [(3, "9 " + "x" * 300)], dict(max_bad_lines=1)),
    "summary_of_25": (5, [(i, f"bad {i}") for i in range(25)],
                      dict(max_bad_lines=3)),
}


@pytest.mark.parametrize("case", sorted(BUDGETS))
def test_error_budget_matches_reference(tmp_path, case):
    """The same records and quarantined lines, or the same error type
    and text; the sidecar's bytes and the stats' snapshot equal."""
    good, bad, kw = BUDGETS[case]
    path = write_mixed(str(tmp_path / "f.txt"), good, bad)
    want, got = both(lambda pkg: parse_budgeted(
        path, pkg, quarantine_dir=str(tmp_path / f"q-{pkg}"), **kw))
    if isinstance(want, Exception):
        assert type(got).__name__ == type(want).__name__
        assert isinstance(got, ingest.IngestError)
        assert str(got) == str(want)
        assert [str(b) for b in got.bad_lines] == \
            [str(b) for b in want.bad_lines]
        assert isinstance(got.__cause__, ValueError)
    else:
        (wrecs, wbudget, wstats), (grecs, gbudget, gstats) = want, got
        assert_records_equal(grecs, wrecs)
        assert [vars(b) for b in gbudget.bad_lines] == \
            [vars(b) for b in wbudget.bad_lines]
        assert gbudget.lines_seen == wbudget.lines_seen
        assert gstats.snapshot() == wstats.snapshot()
        assert gstats.report() == wstats.report()
    sides = [sorted(os.listdir(tmp_path / f"q-{pkg}"))
             if os.path.isdir(tmp_path / f"q-{pkg}") else []
             for pkg in ("ref", "port")]
    assert sides[0] == sides[1] == ([f"quarantine-{os.getpid()}.jsonl"]
                                    if bad else [])
    for name in sides[0]:
        with open(tmp_path / "q-ref" / name, "rb") as f:
            want_bytes = f.read()
        with open(tmp_path / "q-port" / name, "rb") as f:
            assert f.read() == want_bytes


@pytest.mark.parametrize("bad_lines,budget", [(3, 5), (3, 2)])
def test_dataset_budget_from_flags(tmp_path, set_flag, bad_lines, budget):
    """Four files through ``SlotDataset`` (three parse threads) under
    ``ingest_max_bad_lines`` and ``ingest_quarantine_dir`` set as flags:
    within the budget the same records, the sidecar holding exactly the
    bad lines; over it the same ``IngestBudgetError`` (its text names
    every bad line)."""
    files = [write_mixed(str(tmp_path / f"f{i}.txt"), 10,
                         [(3, f"junk {i}")] if i < bad_lines else [],
                         seed=i) for i in range(4)]
    set_flag("ingest_max_bad_lines", budget)

    def load(pkg):
        set_flag("ingest_quarantine_dir", str(tmp_path / f"q-{pkg}"))
        ds = (JaxSlotDataset(jax_conf(thread_num=3)) if pkg == "ref" else
              SlotDataset(port_conf(jax_conf(thread_num=3))))
        ds.set_filelist(files)
        ds.load_into_memory()
        return ds.records
    want, got = both(load)
    if bad_lines <= budget:
        assert_records_equal(got, want)
        side = tmp_path / "q-port" / f"quarantine-{os.getpid()}.jsonl"
        lines = side.read_text().splitlines()
        assert len(lines) == bad_lines
        assert sorted(lines) == sorted(
            (tmp_path / "q-ref" / side.name).read_text().splitlines())
    else:
        assert isinstance(got, ingest.IngestBudgetError)
        assert type(want).__name__ == "IngestBudgetError"
        # the threads' timing orders the lines and sets lines_seen
        assert sorted(str(got).splitlines()[1:]) == \
            sorted(str(want).splitlines()[1:])
        head = [re.sub(r"lines_seen=\d+", "", str(e).splitlines()[0])
                for e in (got, want)]
        assert head[0] == head[1]


@pytest.mark.parametrize("max_bad_files", [0, 1])
def test_file_budget_matches_reference(tmp_path, set_flag, max_bad_files):
    """A missing file: with no file budget the load raises naming it;
    with one it is skipped and the good file's records load."""
    good = write_mixed(str(tmp_path / "good.txt"), 5)
    set_flag("ingest_max_bad_files", max_bad_files)

    def load(pkg):
        ds = (JaxSlotDataset(jax_conf()) if pkg == "ref" else
              SlotDataset(port_conf(jax_conf())))
        ds.set_filelist([good, str(tmp_path / "missing.txt")])
        ds.load_into_memory()
        return ds.records
    want, got = both(load)
    if max_bad_files:
        assert_records_equal(got, want)
        assert len(got) == 5
    else:
        assert type(got).__name__ == type(want).__name__ == "IngestError"
        assert str(got) == str(want)
        assert "missing.txt: FileNotFoundError" in str(got)


def test_stats_delta_and_report():
    """``consume_delta`` and ``report`` of the same adds."""
    outs = []
    for mod in (ref_ingest, ingest):
        st = mod.IngestStats()
        st.add("lines_ok", 7)
        st.add("io_retries")
        first = st.consume_delta()
        st.add("lines_ok", 2)
        st.add("files_failed", 0)
        outs.append((first, st.consume_delta(), st.consume_delta(),
                     st.report(), st.snapshot()))
        st.reset()
        assert st.snapshot() == {f: 0 for f in mod.IngestStats.FIELDS}
    assert outs[0] == outs[1]
    assert outs[1][0] == {"lines_ok": 7, "io_retries": 1}


def test_transient_retries_match_reference(tmp_path, set_flag):
    """Two injected open failures recover (2 retries counted); with every
    open failing, the retries run out; a missing file is never
    retried."""
    path = write_mixed(str(tmp_path / "f.txt"), 8)
    runs = []
    for mod, fmod, parser in (
            (ref_ingest, ref_faults, JaxSlotParser(jax_conf())),
            (ingest, faults, SlotParser(port_conf(jax_conf())))):
        set_flag("ingest_retries", 3)
        st = mod.IngestStats()
        fmod.install_injector(fmod.FaultInjector(
            3, fail_rate=1.0, ops={"ingest.open"}, max_failures=2))
        recs = parser.parse_file(path, stats=st)
        runs.append((recs, st.get("io_retries")))
        fmod.install_injector(fmod.FaultInjector(
            3, fail_rate=1.0, ops={"ingest.open"}))
        set_flag("ingest_retries", 2)
        with pytest.raises(OSError, match="injected transient"):
            parser.parse_file(path)
        fmod.install_injector(None)
        st = mod.IngestStats()
        with pytest.raises(FileNotFoundError):
            mod.open_with_retries(str(tmp_path / "nope"), stats=st)
        assert st.get("io_retries") == 0
    assert_records_equal(runs[1][0], runs[0][0])
    assert runs[0][1] == runs[1][1] == 2


# -- pipe_command ------------------------------------------------------------

PIPES = {"cat": "cat", "head": "head -5",
         "awk": "awk '{print $0}'", "reversed": "tac"}


@pytest.mark.parametrize("case", sorted(PIPES))
def test_pipe_command_records_match_reference(tmp_path, case):
    """``SlotParser`` through a ``pipe_command``: the reference's
    records."""
    path = write_mixed(str(tmp_path / "f.txt"), 12)
    jconf = jax_conf(pipe_command=PIPES[case])
    want = JaxSlotParser(jconf).parse_file(path)
    got = SlotParser(port_conf(jconf)).parse_file(path)
    assert_records_equal(got, want)
    assert len(got) == (5 if case == "head" else 12)


WEDGED = {
    "stall": ("echo pipe-oops >&2; sleep 30", "produced no output"),
    "eof_without_exit": ("cat; exec 1>&-; sleep 30", "did not exit"),
    "nonzero_exit": ("echo doom-tail >&2; exit 9", "exit code 9"),
}


@pytest.mark.parametrize("reader", ["parser", "fast_feed"])
@pytest.mark.parametrize("case", sorted(WEDGED))
def test_pipe_command_watchdog_matches_reference(tmp_path, set_flag, case,
                                                 reader):
    """A wedged command is killed (its process group) within the 1 s
    stall timeout, and the error, its stderr tail included, is the
    reference's; a nonzero exit raises with its tail."""
    if reader == "fast_feed" and not ref_native.available():
        pytest.skip("native backend unavailable")
    cmd, match = WEDGED[case]
    path = write_mixed(str(tmp_path / "f.txt"), 3)
    set_flag("ingest_stall_timeout", 1.0)
    jconf = jax_conf(pipe_command=cmd)

    def run(pkg):
        if reader == "parser":
            p = (JaxSlotParser(jconf) if pkg == "ref"
                 else SlotParser(port_conf(jconf)))
        else:
            p = (JaxReader(jconf) if pkg == "ref"
                 else FastSlotReader(port_conf(jconf)))
        t0 = time.monotonic()
        try:
            p.parse_file(path)
        finally:
            assert time.monotonic() - t0 < 10
    want, got = both(run)
    assert type(got).__name__ == type(want).__name__
    assert str(got) == str(want)
    assert match in str(got) and path in str(got)
    if case != "eof_without_exit":
        tail = "pipe-oops" if case == "stall" else "doom-tail"
        assert tail in str(got)


def test_fast_feed_pipe_bytes_match_reference(tmp_path, set_flag):
    """``FastSlotReader`` through ``cat``: the reference's block; a slow
    command that writes a chunk every 0.3 s outlives a 0.5 s stall
    timeout (the deadline re-arms with each chunk)."""
    if not ref_native.available():
        pytest.skip("native backend unavailable")
    path = write_mixed(str(tmp_path / "f.txt"), 20)
    want = JaxReader(jax_conf(pipe_command="cat")).parse_file(path)
    got = FastSlotReader(port_conf(jax_conf(pipe_command="cat"))
                         ).parse_file(path)
    for f in ("keys", "lengths", "labels", "dense"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    set_flag("ingest_stall_timeout", 0.5)
    slow = FastSlotReader(port_conf(jax_conf(
        pipe_command="for i in 1 2 3 4; do echo line$i; sleep 0.3; "
                     "done")))
    assert slow._pipe_bytes(os.devnull) == \
        b"line1\nline2\nline3\nline4\n"


# -- CriteoReader's budget and to_multislot -----------------------------------

def criteo_files(tmp_path, bad):
    """Two seeded Criteo files of 30 and 17 rows; ``bad`` (file, line
    index, text) replaced."""
    paths = []
    for i, rows in enumerate((30, 17)):
        p = str(tmp_path / f"criteo-{i}.txt")
        criteo.make_synthetic_criteo(p, rows, seed=i)
        with open(p) as f:
            lines = f.readlines()
        for fi, li, text in bad:
            if fi == i:
                lines[li] = text + "\n"
        with open(p, "w") as f:
            f.writelines(lines)
        paths.append(p)
    return paths


CRITEO = {
    "clean": ([], {}),
    "quarantined": ([(0, 29, "1\t2\t3"), (1, 0, "x" * 200),
                     (1, 5, "1\t" * 39 + "zz")], dict(max_bad_lines=3)),
    "fail_fast": ([(1, 3, "1\t2")], {}),
    "overspent": ([(0, 2, "a"), (0, 3, "b")], dict(max_bad_lines=1)),
}


@pytest.mark.parametrize("case", sorted(CRITEO))
def test_criteo_budget_matches_reference(tmp_path, case):
    """``CriteoReader(16).stream`` under a budget, a batch spanning the
    two files: the same batches, quarantined lines (file and line of
    each) and stats, or the same error."""
    bad, kw = CRITEO[case]
    files = criteo_files(tmp_path, bad)

    def run(pkg):
        mod, rd = ((ref_ingest, ref_criteo) if pkg == "ref"
                   else (ingest, criteo))
        st = mod.IngestStats()
        budget = mod.ErrorBudget(stats=st, **kw)
        batches = list(rd.CriteoReader(16).stream(files, budget=budget))
        return batches, budget, st
    want, got = both(run)
    if isinstance(want, Exception):
        assert type(got).__name__ == type(want).__name__
        assert str(got) == str(want)
        return
    (wb, wbud, wst), (gb, gbud, gst) = want, got
    assert len(gb) == len(wb)
    for g, w in zip(gb, wb):
        for f in ("keys", "segment_ids", "lengths", "labels", "dense"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        assert (g.num_keys, g.num_rows) == (w.num_keys, w.num_rows)
    assert [vars(b) for b in gbud.bad_lines] == \
        [vars(b) for b in wbud.bad_lines]
    assert gst.snapshot() == wst.snapshot()
    assert sum(b.num_rows for b in gb) == 47 - len(bad)


@pytest.mark.parametrize("case", ["clean", "bad_field_count"])
def test_to_multislot_matches_reference(tmp_path, case):
    """The converted file's bytes and row count, or the same error; the
    C++ fast feed reads the converted file as the Criteo reader's
    batches."""
    (src,) = criteo_files(tmp_path, [(0, 7, "1\t2")]
                          if case != "clean" else [])[:1]
    outs = []
    for pkg, mod in (("ref", ref_criteo), ("port", criteo)):
        dst = str(tmp_path / f"multislot-{pkg}.txt")
        try:
            outs.append((mod.to_multislot(src, dst), dst))
        except ValueError as e:
            outs.append(e)
    want, got = outs
    if isinstance(want, Exception):
        assert type(got) is type(want) and str(got) == str(want)
        assert f"{src}:8: bad field count" in str(got)
        return
    assert got[0] == want[0] == 30
    with open(want[1], "rb") as a, open(got[1], "rb") as b:
        assert a.read() == b.read()
    if ref_native.available():
        conf = criteo.criteo_feed_config(16)
        fast = list(FastSlotReader(conf).batches([got[1]]))
        direct = list(criteo.CriteoReader(16).stream([src]))
        assert len(fast) == len(direct)
        for a, b in zip(fast, direct):
            np.testing.assert_array_equal(a.keys[:a.num_keys],
                                          b.keys[:b.num_keys])
            np.testing.assert_array_equal(a.labels, b.labels)
