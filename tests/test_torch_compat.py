"""The port's ``compat.BoxPSDataset`` and ``utils/fs.FileMgr`` held against
the reference's (``paddlebox_tpu/compat.py``, ``paddlebox_tpu/utils/
fs.py``), and ``PBOX_FLAGS_fix_dayid`` through both packages'
``PassManager.set_date`` and ``BoxPSDataset.set_date``. ``FileMgr`` is
held on local paths only: the ``hdfs:``/``afs:`` forms need a ``hadoop``
client."""

import os

import numpy as np
import pytest

from conftest import make_slot_file
from paddlebox_tpu import flags as ref_flags
from paddlebox_tpu.compat import BoxPSDataset as RefBoxPSDataset
from paddlebox_tpu.config import DataFeedConfig as JaxFeedConfig
from paddlebox_tpu.config import SlotConfig as JaxSlotConfig
from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.ps.server import SparsePS as RefSparsePS
from paddlebox_tpu.ps.table import EmbeddingTable as RefTable
from paddlebox_tpu.trainer.pass_manager import PassManager as RefPassManager
from paddlebox_tpu.utils.fs import FileMgr as RefFileMgr
from paddlebox_tpu_torch.compat import BoxPSDataset
from paddlebox_tpu_torch.config import (DataFeedConfig, SlotConfig,
                                        TableConfig, resolve_day)
from paddlebox_tpu_torch.ps.server import SparsePS
from paddlebox_tpu_torch.ps.table import EmbeddingTable
from paddlebox_tpu_torch.trainer.pass_manager import PassManager
from paddlebox_tpu_torch.utils.fs import FileMgr

SLOTS = [("label", "float", True, 1), ("a", "uint64", False, 1),
         ("b", "uint64", False, 1), ("d", "float", True, 2)]
TABLE = dict(embedx_dim=4, cvm_offset=3, embedx_threshold=0.0,
             show_clk_decay=0.5)


def confs(batch_size=8):
    return (JaxFeedConfig(slots=[JaxSlotConfig(n, type=t, is_dense=d,
                                               dim=k)
                                 for n, t, d, k in SLOTS],
                          batch_size=batch_size, thread_num=2),
            DataFeedConfig(slots=[SlotConfig(n, type=t, is_dense=d, dim=k)
                                  for n, t, d, k in SLOTS],
                           batch_size=batch_size, thread_num=2))


class _Null:
    def release_memory(self):
        pass


def test_boxps_dataset_matches_reference(tmp_path):
    jconf, pconf = confs()
    files = [make_slot_file(str(tmp_path / f"part-{i}"), jconf, 37, seed=i)
             for i in range(2)]
    ref_t = RefTable(JaxTableConfig(**TABLE), backend="numpy")
    port_t = EmbeddingTable(TableConfig(**TABLE), backend="numpy")
    ref = RefBoxPSDataset(jconf, RefSparsePS({"e": ref_t}))
    port = BoxPSDataset(pconf, SparsePS({"e": port_t}))
    for ds in (ref, port):
        ds.set_date("20260201")
        ds.set_filelist(files)
        ds.set_batch_size(16)
        ds.set_thread(1)
        ds.begin_pass()
        ds.load_into_memory()
    assert port.get_memory_data_size() == ref.get_memory_data_size() == 74
    # the keys fed to the table at the load (the feed pass)
    assert len(port_t) == len(ref_t) > 0
    np.testing.assert_array_equal(
        np.sort(port_t._index.dump_keys(len(port_t))),
        np.sort(ref_t._index.dump_keys(len(ref_t))))
    rb, pb = list(ref.batches()), list(port.batches())
    assert len(pb) == len(rb) == 5
    for a, b in zip(pb, rb):
        for f in ("keys", "segment_ids", "lengths", "labels", "dense"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (a.batch_size, a.num_keys, a.num_rows) == \
            (b.batch_size, b.num_keys, b.num_rows)
    # a trained row, then the pass end with a delta save
    keys = np.unique(np.concatenate([b.keys for b in pb]))[1:4]
    for t in (ref_t, port_t):
        t.push(keys, np.ones((keys.size, t.dim), np.float32))
    for ds, root in ((ref, tmp_path / "ref"), (port, tmp_path / "port")):
        ds.end_pass(need_save_delta=True, save_root=str(root))
        assert ds.get_memory_data_size() == 0
    rel = os.path.join("20260201", "00001", "delta", "e.npz")
    with np.load(tmp_path / "ref" / rel) as r, \
            np.load(tmp_path / "port" / rel) as p:
        assert sorted(p.files) == sorted(r.files)
        for k in r.files:
            np.testing.assert_allclose(p[k], r[k], rtol=1e-6)
    # the preload path feeds the same keys
    for ds in (ref, port):
        ds.begin_pass()
        ds.preload_into_memory()
        ds.wait_preload_done()
        ds.local_shuffle()
        ds.slots_shuffle([1])
    assert port.get_memory_data_size() == ref.get_memory_data_size()
    assert port.dataset is port._ds


@pytest.mark.parametrize("fixed", ["", "0", "20250505"])
def test_fix_dayid_matches_reference(fixed, tmp_path, monkeypatch):
    old = ref_flags.get("fix_dayid")
    ref_flags.set("fix_dayid", int(fixed or 0))
    monkeypatch.setenv("PBOX_FLAGS_fix_dayid", fixed)
    try:
        jconf, pconf = confs()
        ref_pm = RefPassManager(RefSparsePS({"e": RefTable(
            JaxTableConfig(**TABLE), backend="numpy")}),
            str(tmp_path / "ref"), [_Null()])
        port_pm = PassManager(SparsePS({"e": EmbeddingTable(
            TableConfig(**TABLE), backend="numpy")}),
            str(tmp_path / "port"), [_Null()])
        ref_ds, port_ds = RefBoxPSDataset(jconf), BoxPSDataset(pconf)
        for obj in (ref_pm, port_pm, ref_ds, port_ds):
            obj.set_date("20260301")
        want = fixed if int(fixed or 0) else "20260301"
        assert port_pm.day == ref_pm.day == want
        assert port_ds._date == ref_ds._date == want
        assert resolve_day(20260302) == (want if int(fixed or 0)
                                         else "20260302")
        ref_pm.close()
        port_pm.close()
    finally:
        ref_flags.set("fix_dayid", old)


def test_file_mgr_matches_reference_on_local_paths(tmp_path):
    out = {}
    for name, fm in (("ref", RefFileMgr()), ("port", FileMgr())):
        root = tmp_path / name
        fm.mkdir(str(root / "a" / "b"))
        fm.touch(str(root / "a" / "x.txt"))
        (root / "src.txt").write_text("payload")
        fm.upload(str(root / "src.txt"), str(root / "up" / "dst.txt"))
        got = fm.download(str(root / "up" / "dst.txt"),
                          str(root / "down.txt"))
        fm.upload(str(root / "src.txt"), str(root / "src.txt"))  # no-op
        listed = [os.path.relpath(p, root) for p in fm.ls(str(root))]
        globbed = [os.path.relpath(p, root)
                   for p in fm.ls(str(root / "*.txt"))]
        exists = [fm.exists(str(root / p)) for p in ("a/x.txt", "nope")]
        fm.remove(str(root / "a"))
        fm.remove(str(root / "down.txt"))
        fm.remove(str(root / "nope"))
        out[name] = dict(listed=listed, globbed=globbed, exists=exists,
                         got=os.path.relpath(got, root),
                         text=(root / "up" / "dst.txt").read_text(),
                         after=sorted(os.listdir(root)))
    assert out["port"] == out["ref"]
    assert out["port"]["listed"] == ["a", "down.txt", "src.txt", "up"]
    assert out["port"]["after"] == ["src.txt", "up"]
