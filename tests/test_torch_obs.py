"""Port's observability (``obs/metrics.py``, ``obs/trace.py``,
``obs/heartbeat.py``, ``utils/monitor.py``, ``utils/timer.py``) against
the JAX package's ``obs`` on the same inputs.

- The registry: seeded observations (lognormal latencies, zeros,
  negatives and NaNs that must be dropped, values past both ends of the
  buckets) give the same ``snapshot()`` (counts, sums, p50/p95/p99, max)
  exactly, the same bucket geometry, and the same ``delta``.
- The trace: the reference's event schema (complete and instant events,
  thread metadata, the dump's document), the no-op singleton when
  disabled, the ring's drops counted; and one tiny staged
  ``train_from_files`` pass under ``obs_trace_dir`` in each package
  records the same span names.
- The heartbeat: that pass's ``pass`` record and a ``PassManager`` pass's
  ``end_pass`` record carry the reference's keys, with ``steps``,
  ``batch_size``, ``ins_num``, ``day``, ``pass_id`` and ``table_rows``
  equal and ``auc`` within rtol 1e-5 (the pass metrics' tolerance in
  ``test_torch_stream.py``); rotation keeps ``obs_heartbeat_keep``
  segments.
"""

import dataclasses
import json
import math
import os
import threading

import numpy as np
import pytest

from paddlebox_tpu import flags as ref_flags
from paddlebox_tpu.config import BucketSpec as JaxBucketSpec
from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.config import TrainerConfig as JaxTrainerConfig
from paddlebox_tpu.data.dataset import SlotDataset as JaxSlotDataset
from paddlebox_tpu.models import DeepFM as FlaxDeepFM
from paddlebox_tpu.obs import heartbeat as ref_heartbeat
from paddlebox_tpu.obs import metrics as ref_metrics
from paddlebox_tpu.obs import trace as ref_trace
from paddlebox_tpu.ps import native as ref_native
from paddlebox_tpu.ps.server import SparsePS as JaxSparsePS
from paddlebox_tpu.ps.table import EmbeddingTable as JaxTable
from paddlebox_tpu.trainer import trainer as ref_trainer
from paddlebox_tpu.trainer.pass_manager import PassManager as JaxPassManager
from paddlebox_tpu_torch.config import DataFeedConfig, TableConfig
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.obs import heartbeat, metrics, trace
from paddlebox_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry, delta
from paddlebox_tpu_torch.ps.server import SparsePS
from paddlebox_tpu_torch.ps.table import EmbeddingTable
from paddlebox_tpu_torch.trainer.pass_manager import PassManager
from paddlebox_tpu_torch.utils.monitor import STATS
from paddlebox_tpu_torch.utils.timer import SpanTimer
from test_torch_stream import (FILE_BUCKETS, TABLE, TRAIN, jax_feed_conf,
                               jax_table, leaves_of, port_files_trainer,
                               stream_files)

pytestmark = pytest.mark.skipif(not ref_native.available(),
                                reason="native backend unavailable")

HB_COMMON = {"hb", "ts", "pid"}


def observations(seed):
    rng = np.random.default_rng(seed)
    vals = list(rng.lognormal(1.0, 1.2, size=3000))
    vals += [0.0, 1e-9, 1e-6, 2e-6, 5e9, -1.0, float("nan"), 1e300]
    vals += list(rng.uniform(0, 100, size=500))
    return [float(v) for v in rng.permutation(np.array(vals, object))]


def fill(reg, seed):
    """The same seeded writes into a registry of either package."""
    rng = np.random.default_rng(seed + 100)
    for i, v in enumerate(observations(seed)):
        reg.observe(f"h{i % 3}_ms", v)
    for _ in range(50):
        reg.add(f"c{int(rng.integers(0, 4))}", int(rng.integers(1, 9)))
        reg.gauge(f"g{int(rng.integers(0, 2))}").set(float(rng.normal()))
    reg.gauge("g_acc").add(2.5)
    reg.get("legacy").set(7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshot_and_delta_equal_reference(seed):
    got, want = MetricsRegistry(), ref_metrics.MetricsRegistry()
    fill(got, seed)
    fill(want, seed)
    assert got.snapshot() == want.snapshot()
    assert got.snapshot("h1") == want.snapshot("h1")
    h, rh = got.histogram("h0_ms"), want.histogram("h0_ms")
    for q in (0.0, 0.01, 0.5, 0.9, 0.999, 1.0):
        assert h.percentile(q) == rh.percentile(q)
    assert h.state() == rh.state()
    assert h.cumulative_buckets() == rh.cumulative_buckets()
    prev, rprev = got.snapshot(), want.snapshot()
    fill(got, seed + 7)
    fill(want, seed + 7)
    assert delta(got.snapshot(), prev) == \
        ref_metrics.delta(want.snapshot(), rprev)
    with pytest.raises(TypeError):
        got.gauge("c0")


def test_bucket_geometry_equals_reference():
    vals = [0.0, 1e-7, 1e-6, 1.0000001e-6, 0.5, 1.0, 3.3, 1e5, 1e9, 1e12]
    vals += list(np.random.default_rng(5).lognormal(0, 5, size=2000))
    for v in vals:
        assert metrics.bucket_index(v) == ref_metrics.bucket_index(v)
    for i in range(256):
        assert metrics.bucket_bound(i) == ref_metrics.bucket_bound(i)
    counts = [0] * 256
    for v in vals:
        counts[metrics.bucket_index(v)] += 1
    for q in (0.1, 0.5, 0.99):
        assert metrics.percentile_from_counts(counts, len(vals), 7.0, q) \
            == ref_metrics.percentile_from_counts(counts, len(vals), 7.0, q)


def test_stats_is_the_registry_and_histograms_stripe():
    assert STATS is REGISTRY
    h = metrics.Histogram()

    def work():
        for i in range(500):
            h.observe(1.0 + i % 5)

    ts = [threading.Thread(target=work) for _ in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert h.count == 3000 and h.sum == pytest.approx(9000.0)


# -- the trace ----------------------------------------------------------------

def spans_of(tracer):
    t = tracer.Tracer(ring=64)

    def work():
        with t.span("bg"):
            pass

    assert t.span("off") is t.span("off2", k=1)   # disabled: the singleton
    t._enabled = True
    with t.span("outer", phase="p1"):
        with t.span("inner"):
            t.instant("mark", note="hi")
    th = threading.Thread(target=work, name="bg-worker")
    th.start()
    th.join()
    return t


def test_trace_schema_equals_reference(tmp_path):
    """The same spans in each package's tracer: the same events but for
    their clocks, in the same order, and a dump of the same document
    layout; nesting within a thread, the background thread named."""
    got, want = spans_of(trace), spans_of(ref_trace)

    def shape(events):
        return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                for e in events]

    ge, we = got.events(), want.events()
    assert shape(ge) == shape(we)
    by = {e["name"]: e for e in ge if e["ph"] != "M"}
    assert by["inner"]["ts"] >= by["outer"]["ts"]
    assert by["inner"]["ts"] + by["inner"]["dur"] <= \
        by["outer"]["ts"] + by["outer"]["dur"] + 1e-3
    assert by["bg"]["tid"] != by["outer"]["tid"]
    assert {e["args"]["name"] for e in ge if e["ph"] == "M"} >= \
        {"bg-worker"}
    got.enable(str(tmp_path / "p"))
    want.enable(str(tmp_path / "r"))
    gdoc = json.load(open(got.dump()))
    wdoc = json.load(open(want.dump()))
    assert set(gdoc) == set(wdoc)
    assert set(gdoc["otherData"]) == set(wdoc["otherData"])
    assert shape(gdoc["traceEvents"]) == shape(wdoc["traceEvents"])
    assert got.dump() == got.dump()      # one current file, overwritten


def test_trace_ring_drops_oldest_and_counts():
    before = REGISTRY.counter("obs.trace.dropped_events").get()
    t = trace.Tracer(ring=16)
    t._enabled = True
    for i in range(50):
        with t.span(f"s{i}"):
            pass
    evs = [e for e in t.events() if e["ph"] == "X"]
    assert len(evs) == 16 and evs[-1]["name"] == "s49"
    assert REGISTRY.counter("obs.trace.dropped_events").get() - before == 34


def test_maybe_enable_reads_the_flag(tmp_path, monkeypatch):
    t = trace.Tracer()
    monkeypatch.setenv("PBOX_FLAGS_obs_trace_dir", "")
    assert t.maybe_enable() is False
    monkeypatch.setenv("PBOX_FLAGS_obs_trace_dir", str(tmp_path / "tr"))
    monkeypatch.setenv("PBOX_FLAGS_obs_trace_ring", "32")
    assert t.maybe_enable() is True and t._ring == 32


def test_span_timer_observes_and_traces(tmp_path):
    timer = SpanTimer(metric_prefix="t_obs_port")
    was = trace.TRACE.enabled
    try:
        trace.enable(str(tmp_path))
        with timer.span("traced_step"):
            pass
    finally:
        if not was:
            trace.disable()
    assert REGISTRY.histogram("t_obs_port.traced_step_ms").count >= 1
    assert "traced_step" in {e["name"] for e in trace.TRACE.events()}


# -- a staged pass and a PassManager pass, traced and heartbeat --------------

@pytest.fixture
def obs_flags(tmp_path, monkeypatch):
    """Trace, heartbeat and the staged feed on in both packages, each into
    its own files; the tracers' previous state restored."""
    saved = {k: ref_flags.get(k) for k in ("obs_trace_dir",
                                           "obs_heartbeat_path",
                                           "feed_device_prefetch")}
    was = (trace.TRACE.enabled, ref_trace.TRACE.enabled)
    paths = {}

    def on(pkg, **kw):
        hb = str(tmp_path / f"{pkg}.hb.jsonl")
        tdir = str(tmp_path / f"{pkg}.trace")
        paths[pkg] = (hb, tdir)
        values = dict(obs_trace_dir=tdir, obs_heartbeat_path=hb, **kw)
        if pkg == "ref":
            for k, v in values.items():
                ref_flags.set(k, v)
            ref_trace.TRACE.clear()
        else:
            for k, v in values.items():
                monkeypatch.setenv(f"PBOX_FLAGS_{k}", str(v))
            trace.TRACE.clear()
        return hb

    yield on
    for k, v in saved.items():
        ref_flags.set(k, v)
    for tr, w in ((trace.TRACE, was[0]), (ref_trace.TRACE, was[1])):
        if not w:
            tr.disable()


def records(path, kind):
    return [r for r in map(json.loads, open(path)) if r["hb"] == kind]


def span_names(tracer):
    return {e["name"] for e in tracer.events() if e["ph"] == "X"}


def test_staged_pass_spans_and_pass_record_match_reference(
        obs_flags, stream_files):
    """One staged ``train_from_files`` pass in each package: the trace's
    span names (the reader's parse, the feed's pack and upload, the
    trainer's segment) and the ``pass`` record's keys are the
    reference's; its deterministic fields equal."""
    hb = obs_flags("ref", feed_device_prefetch=2)
    jt = jax_table()
    arena = (np.asarray(jt.values).copy(), np.asarray(jt.state).copy(),
             jt._index.dump_keys(jt._size))
    tr = ref_trainer.CTRTrainer(
        FlaxDeepFM(hidden=(16,)), jax_feed_conf(), JaxTableConfig(**TABLE),
        JaxTrainerConfig(**TRAIN), table=jt,
        buckets=JaxBucketSpec(**FILE_BUCKETS))
    ref = dict(init=leaves_of(tr.params), arena=arena)
    tr.train_from_files(stream_files)
    want_names = span_names(ref_trace.TRACE)
    (want,) = records(hb, "pass")
    hb = obs_flags("port", feed_device_prefetch=2)
    port = port_files_trainer(ref)
    port.train_from_files(stream_files)
    assert span_names(trace.TRACE) == want_names >= {
        "main", "ingest.fast_parse", "feed.pack", "feed.h2d"}
    (got,) = records(hb, "pass")
    assert set(got) == set(want) >= HB_COMMON | {"host_share"}
    for k in ("steps", "batch_size", "ins_num"):
        assert got[k] == want[k], k
    assert got["steps"] == 36
    assert got["auc"] == pytest.approx(want["auc"], rel=1e-5)
    assert set(got["spans"]) == set(want["spans"])
    assert got["spans"]["main"]["count"] == want["spans"]["main"]["count"]
    assert 0.0 < got["host_share"] <= 1.0
    assert got == port.last_heartbeat
    assert REGISTRY.gauge("trainer.host_share").get() == \
        pytest.approx(got["host_share"], abs=1e-4)
    assert REGISTRY.histogram("feed.pack_ms").count >= 36
    assert REGISTRY.histogram("feed.stage_wait_ms").count >= 1


def test_end_pass_record_matches_reference(obs_flags, tmp_path):
    """One ``PassManager`` pass over a host table in each package
    (``begin_pass``, ``end_pass(save_delta=True)``): the ``end_pass``
    record's keys (and those of its ``disk`` and ``remote`` parts), day,
    pass and table rows equal the reference's; the trace is dumped at the
    pass end."""
    from conftest import make_slot_file
    jconf = jax_feed_conf()
    files = [make_slot_file(str(tmp_path / f"f{i}"), jconf, 16, seed=i)
             for i in range(2)]
    table = dict(embedx_dim=4, cvm_offset=3, embedx_threshold=0.0)
    out = {}
    for pkg in ("ref", "port"):
        hb = obs_flags(pkg)
        if pkg == "ref":
            ps = JaxSparsePS({"embedding": JaxTable(JaxTableConfig(**table))})
            pm = JaxPassManager(ps, str(tmp_path / "ref_model"),
                                [JaxSlotDataset(jconf)])
        else:
            ps = SparsePS({"embedding": EmbeddingTable(TableConfig(**table))})
            pm = PassManager(ps, str(tmp_path / "port_model"), [SlotDataset(
                DataFeedConfig.from_dict(dataclasses.asdict(jconf)))])
        pm.set_date("20260801")
        pm.begin_pass(files)
        pm.end_pass(save_delta=True)
        pm.barrier()
        pm.close()
        (out[pkg],) = records(hb, "end_pass")
    got, want = out["port"], out["ref"]
    assert set(got) == set(want)
    for part in ("disk", "remote"):
        assert set(got[part]) == set(want[part]), part
    for k in ("day", "pass_id", "table_rows", "ckpt_writer_alive",
              "nonfinite_grad_rows"):
        assert got[k] == want[k], k
    assert got["table_rows"]["embedding"] > 0
    assert set(got["spans"]) == set(want["spans"])
    dumps = os.listdir(str(tmp_path / "port.trace"))
    assert len(dumps) == 1 and dumps[0].startswith(f"pbx_trace_{os.getpid()}")
    doc = json.load(open(tmp_path / "port.trace" / dumps[0]))
    assert {"feed_pass", "end_pass"} <= {e["name"] for e in
                                         doc["traceEvents"]}


def test_heartbeat_rotation_and_schema(tmp_path, monkeypatch):
    """Records carry ``hb``, ``ts``, ``pid`` (and ``role``, whose records
    go to a sidecar), numpy values made plain; past
    ``obs_heartbeat_max_bytes`` the file rotates, keeping
    ``obs_heartbeat_keep`` segments; a failing sink never raises."""
    path = str(tmp_path / "hb.jsonl")
    monkeypatch.setenv("PBOX_FLAGS_obs_heartbeat_path", path)
    rec = heartbeat.emit("pass", steps=np.int64(3), auc=np.float32(0.5),
                         arr=np.arange(2), nested={"a": np.float64(1.5)})
    assert set(rec) >= HB_COMMON and rec["hb"] == "pass"
    line = json.loads(open(path).read())
    assert line == rec and line["steps"] == 3 and line["arr"] == [0, 1]
    before = REGISTRY.counter("heartbeat.lines_written").get()
    monkeypatch.setenv("PBOX_FLAGS_obs_heartbeat_max_bytes", "200")
    monkeypatch.setenv("PBOX_FLAGS_obs_heartbeat_keep", "2")
    for i in range(12):
        heartbeat.emit("tick", i=i, pad="x" * 80)
    assert REGISTRY.counter("heartbeat.lines_written").get() - before == 12
    segs = sorted(os.listdir(tmp_path))
    assert segs == ["hb.jsonl", "hb.jsonl.1", "hb.jsonl.2"]
    kept = [json.loads(x)["i"] for s in ("hb.jsonl.2", "hb.jsonl.1",
                                         "hb.jsonl")
            for x in open(tmp_path / s)]
    assert kept == sorted(kept) and kept[-1] == 11
    monkeypatch.setenv("PBOX_FLAGS_obs_role", "host0")
    assert heartbeat.sink_path() == path + ".host0"
    assert heartbeat.emit("tick")["role"] == "host0"
    monkeypatch.setenv("PBOX_FLAGS_obs_heartbeat_path",
                       str(tmp_path / "missing" / "hb.jsonl"))
    heartbeat.emit("tick")
    assert math.isfinite(rec["ts"])
    assert ref_heartbeat.sink_path() == ""   # the reference's untouched
