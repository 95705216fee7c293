"""The port's counter mirrors into ``obs/metrics.REGISTRY`` and its
``io_point`` call sites, held against the reference's: after the same
ingest, fabric, disk-tier, admission and checkpoint-writer work each
registry holds the same names with the same values (times aside), the
same saves hit the same io_point names in the same order, and
``PassManager``'s ``end_pass`` record reports the registry's deltas."""

import threading

import numpy as np
import pytest

from conftest import make_slot_file
from paddlebox_tpu import flags as ref_flags
from paddlebox_tpu.ckpt.writer import AsyncCheckpointWriter as RefWriter
from paddlebox_tpu.config import DataFeedConfig as JaxFeedConfig
from paddlebox_tpu.config import SlotConfig as JaxSlotConfig
from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.data import shm_fabric as ref_fabric
from paddlebox_tpu.data.dataset import SlotDataset as JaxSlotDataset
from paddlebox_tpu.obs.metrics import REGISTRY as REF_REGISTRY
from paddlebox_tpu.ps.server import SparsePS as RefSparsePS
from paddlebox_tpu.ps.table import EmbeddingTable as RefTable
from paddlebox_tpu.trainer.pass_manager import PassManager as RefPassManager
from paddlebox_tpu.utils import faults as ref_faults
from paddlebox_tpu_torch.ckpt.writer import AsyncCheckpointWriter
from paddlebox_tpu_torch.config import (DataFeedConfig, SlotConfig,
                                        TableConfig)
from paddlebox_tpu_torch.data import shm_fabric
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.obs.metrics import REGISTRY
from paddlebox_tpu_torch.ps import admission
from paddlebox_tpu_torch.ps.server import SparsePS
from paddlebox_tpu_torch.ps.ssd_tier import DiskTier
from paddlebox_tpu_torch.ps.table import EmbeddingTable
from paddlebox_tpu_torch.ps.tiered_table import TieredDeviceTable
from paddlebox_tpu_torch.trainer.pass_manager import PassManager
from paddlebox_tpu_torch.utils import faults
from test_torch_disk_tier import disk_run, tiered_stream

SLOTS = [("label", "float", True, 1), ("a", "uint64", False, 1),
         ("b", "uint64", False, 1)]
TIMING = (".sum", ".p50", ".p95", ".p99", ".max")
# gauges hold a level, not a count: each test reads them directly
GAUGES = ("ingest.records_in_memory", "ckpt.queue_depth",
          "ps.disk.worker_queue")


def counted(registry, prefixes):
    """The registry's counters and histogram counts under ``prefixes``
    (times and gauges left out)."""
    return {k: v for k, v in registry.snapshot().items()
            if k.startswith(prefixes) and not k.endswith(TIMING)
            and k not in GAUGES}


def deltas(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def both(prefixes, ref_fn, port_fn):
    """Each package's work with its registry's deltas under ``prefixes``."""
    out = {}
    for name, reg, fn in (("ref", REF_REGISTRY, ref_fn),
                          ("port", REGISTRY, port_fn)):
        before = counted(reg, prefixes)
        fn()
        out[name] = deltas(before, counted(reg, prefixes))
    return out


def test_ingest_mirrors_match_reference(tmp_path, monkeypatch):
    """``IngestStats.add`` mirrors into the registry as ``ingest.<name>``;
    a load sets ``ingest.records_in_memory``."""
    jconf = JaxFeedConfig(slots=[JaxSlotConfig(n, type=t, is_dense=d,
                                               dim=k)
                                 for n, t, d, k in SLOTS], batch_size=4)
    pconf = DataFeedConfig(slots=[SlotConfig(n, type=t, is_dense=d, dim=k)
                                  for n, t, d, k in SLOTS], batch_size=4)
    files = [make_slot_file(str(tmp_path / f"p{i}"), jconf, 20, seed=i)
             for i in range(2)]
    with open(files[1], "a") as f:
        f.write("1 1 x\n")
    ref_flags.set("ingest_max_bad_lines", 3)
    monkeypatch.setenv("PBOX_FLAGS_ingest_max_bad_lines", "3")

    def load(cls, conf):
        ds = cls(conf)
        ds.set_filelist(files)
        ds.load_into_memory()

    try:
        out = both(("ingest.",), lambda: load(JaxSlotDataset, jconf),
                   lambda: load(SlotDataset, pconf))
    finally:
        ref_flags.set("ingest_max_bad_lines", 0)
    assert out["port"] == out["ref"]
    assert out["port"]["ingest.lines_ok"] == 40
    assert out["port"]["ingest.lines_quarantined"] == 1
    assert REGISTRY.gauge("ingest.records_in_memory").get() == \
        REF_REGISTRY.gauge("ingest.records_in_memory").get() == 40


def test_fabric_mirrors_match_reference():
    """The fabric's ``ingest.shm.*`` counts: leased blocks and bytes, the
    copies the pipe protocol would have made, a crc mismatch; a clean
    close counts no leaked segment."""
    def work(mod):
        def run():
            fab = mod.ShmFabric(1, 2, 1 << 16)
            try:
                need = mod.block_nbytes(10, 30, 2, 1)
                _, lease = fab.lease(0, 0, 10, 30, 2, 1)
                lease.release()
                crc = mod.block_crc(fab._shms[0][1].buf, 10, 30, 2, 1)
                with pytest.raises(mod.TornBlock):
                    fab.lease(0, 1, 10, 30, 2, 1, crc=crc ^ 1)
                assert need > 0
            finally:
                assert fab.close() == 0
        return run

    out = both(("ingest.shm.",), work(ref_fabric), work(shm_fabric))
    assert out["port"] == out["ref"]
    assert out["port"] == {"ingest.shm.blocks": 1,
                           "ingest.shm.bytes":
                               shm_fabric.block_nbytes(10, 30, 2, 1),
                           "ingest.shm.copies_elided": 2,
                           "ingest.shm.crc_failures": 1}


def test_disk_tier_mirrors_match_reference(tmp_path):
    """Spills, stages and a compaction: ``ps.disk.bloom_*``, the stage
    and stall histograms' counts, ``ps.ssd.*`` bytes, rows, chunk
    histograms' counts and compactions."""
    out = both(("ps.disk.", "ps.ssd."),
               lambda: disk_run("ref", str(tmp_path / "ref")),
               lambda: disk_run("port", str(tmp_path / "port")))
    assert out["port"] == out["ref"]
    for name in ("ps.disk.bloom_hit", "ps.disk.stage_ms.count",
                 "ps.ssd.spill_bytes", "ps.ssd.spill_rows",
                 "ps.ssd.spill_chunk_ms.count",
                 "ps.ssd.stage_bytes", "ps.ssd.stage_chunk_ms.count",
                 "ps.ssd.compactions"):
        assert out["port"][name] > 0, name


@pytest.mark.parametrize("mode", ["admit", "async"])
def test_tiered_mirrors_match_reference(mode, tmp_path, monkeypatch):
    """The tiered table over a disk tier: admission's
    ``ps.disk.admit_*`` (the feed pass's and the mid-pass gate's), and
    the tier worker's queue gauge under the deferred demote."""
    out = both(("ps.disk.admit", "ps.ssd.compactions"),
               lambda: tiered_stream("ref", str(tmp_path / "ref"), mode,
                                     monkeypatch),
               lambda: tiered_stream("port", str(tmp_path / "port"), mode,
                                     monkeypatch))
    assert out["port"] == out["ref"]
    if mode == "admit":
        assert out["port"]["ps.disk.admit_rejected"] > 0
        assert out["port"]["ps.disk.admit_admitted"] > 0
    else:
        assert "ps.disk.worker_queue" in REGISTRY.snapshot()
        assert REGISTRY.gauge("ps.disk.worker_queue").get() == 0


def test_writer_mirrors_match_reference():
    """``ckpt.jobs_ok``, ``ckpt.jobs_failed``, ``ckpt.retries``, the
    ``ckpt.commit_ms`` count and the ``ckpt.queue_depth`` gauge."""
    def work(cls):
        def run():
            w = cls(max_queue=2, retries=3, retry_delay=0.0)
            flaky = iter([OSError("once")])

            def once():
                e = next(flaky, None)
                if e is not None:
                    raise e

            def never():
                raise OSError("always")

            w.submit("ok", lambda: None)
            w.submit("flaky", once)
            w.submit("bad", never)
            with pytest.raises(Exception, match="'bad' failed"):
                w.barrier()
            w.close()
        return run

    out = both(("ckpt.",), work(RefWriter), work(AsyncCheckpointWriter))
    assert out["port"] == out["ref"]
    assert out["port"] == {"ckpt.jobs_ok": 2, "ckpt.jobs_failed": 1,
                           "ckpt.retries": 3, "ckpt.commit_ms.count": 2}
    assert REGISTRY.gauge("ckpt.queue_depth").get() == \
        REF_REGISTRY.gauge("ckpt.queue_depth").get() == 0


class _Null:
    def release_memory(self):
        pass


def test_io_points_match_reference(tmp_path):
    """The same base and delta saves through each package's
    ``PassManager`` over a host table hit the same io_point names in the
    same order (``open``, ``rename``, ``commit_dir``,
    ``donefile.append``)."""
    seen = {}
    keys = np.arange(1, 40, dtype=np.uint64)
    for name, fmod, tcls, ccls, scls, pmcls in (
            ("ref", ref_faults, RefTable, JaxTableConfig, RefSparsePS,
             RefPassManager),
            ("port", faults, EmbeddingTable, TableConfig, SparsePS,
             PassManager)):
        ops = []
        lock = threading.Lock()

        class Recorder(fmod.FaultInjector):
            def maybe_fail(self, op):
                with lock:
                    ops.append(op)

        t = tcls(ccls(embedx_dim=4), backend="numpy")
        t.feed_pass(keys)
        pm = pmcls(scls({"e": t}), str(tmp_path / name), [_Null()])
        pm.set_date("20260401")
        fmod.install_injector(Recorder(0))
        try:
            pm.pass_id = 1
            pm.save_base(wait=True)
            pm.save_delta(wait=True)
        finally:
            fmod.install_injector(None)
            pm.close()
        seen[name] = ops
    assert seen["port"] == seen["ref"]
    assert seen["port"][:4] == ["open", "rename", "commit_dir", "open"]
    assert seen["port"].count("donefile.append") == 2


def test_end_pass_reports_registry_deltas(tmp_path, monkeypatch):
    """A pass over a tiered table on a disk tier with admission: the
    ``end_pass`` record's disk deltas equal the registry's over the
    pass, nonzero where the pass counted."""
    monkeypatch.setenv("PBOX_FLAGS_ps_admit_shows", "2")
    conf = TableConfig(embedx_dim=4, cvm_offset=3, embedx_threshold=0.0)
    backing = EmbeddingTable(conf, backend="numpy")
    disk = DiskTier(backing, str(tmp_path / "disk"))
    table = TieredDeviceTable(conf, backing=backing, capacity=1 << 10,
                              disk=disk, backend="numpy", device="cpu",
                              admit=admission.from_flags())
    feed = DataFeedConfig(slots=[SlotConfig(n, type=t, is_dense=d, dim=k)
                                 for n, t, d, k in SLOTS], batch_size=4)
    jfeed = JaxFeedConfig(slots=[JaxSlotConfig(n, type=t, is_dense=d,
                                               dim=k)
                                 for n, t, d, k in SLOTS], batch_size=4)
    files = [make_slot_file(str(tmp_path / f"p{i}"), jfeed, 30, seed=i)
             for i in range(2)]
    pm = PassManager(SparsePS({"e": table}), str(tmp_path / "root"),
                     [SlotDataset(feed)])
    names = [f"ps.disk.{k}" for k in ("bloom_hit", "bloom_miss",
                                      "admit_admitted", "admit_rejected")]
    try:
        for f in files:
            before = {n: REGISTRY.counter(n).get() for n in names}
            pm.begin_pass([f])
            pm.end_pass()
            disk.evict_cold(show_threshold=np.inf)
            got = pm.last_heartbeat["disk"]
            want = {n.rsplit(".", 1)[-1]: REGISTRY.counter(n).get()
                    - before[n] for n in names}
            assert {k: got[k] for k in want} == want
            assert "worker_queue" in got
        assert got["bloom_miss"] > 0 and got["admit_rejected"] > 0
    finally:
        pm.close()
