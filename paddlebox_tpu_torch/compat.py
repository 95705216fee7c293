"""The reference user's ``BoxPSDataset`` method surface (counterpart of
``paddlebox_tpu/compat.py``, after ``python/paddle/fluid/dataset.py``'s
``BoxPSDataset``: set_date / begin_pass / end_pass(need_save_delta) /
load_into_memory / preload_into_memory / wait_preload_done /
slots_shuffle / set_filelist / ...), mapped onto the port's
``SlotDataset`` and ``SparsePS`` so that a migrated script keeps its
shape. New code should call those directly. ``set_date`` goes through
``config.resolve_day``: ``PBOX_FLAGS_fix_dayid`` pins the day here as in
``PassManager.set_date``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from paddlebox_tpu_torch.config import BucketSpec, DataFeedConfig, resolve_day
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.ps.server import SparsePS


class BoxPSDataset:
    def __init__(self, feed_conf: DataFeedConfig,
                 ps: Optional[SparsePS] = None,
                 table_name: Optional[str] = None,
                 buckets: Optional[BucketSpec] = None):
        self._ds = SlotDataset(feed_conf, buckets)
        self._ps = ps
        self._table = (table_name or (list(ps.tables)[0] if ps else None))
        self._date = "19700101"
        self._pass_id = 0

    # -- the reference's method surface ---------------------------------------

    def set_date(self, date: str) -> None:
        self._date = resolve_day(date)

    def set_filelist(self, files: Sequence[str]) -> None:
        self._ds.set_filelist(files)

    def set_batch_size(self, batch_size: int) -> None:
        self._ds.conf.batch_size = batch_size

    def set_thread(self, thread_num: int) -> None:
        self._ds.conf.thread_num = thread_num

    def set_merge_by_lineid(self, merge_size: int = 2) -> None:
        """The reference's name for merge by instance id."""
        self._ds.set_merge_by_insid(merge_size)

    def begin_pass(self) -> None:
        self._pass_id += 1
        if self._ps is not None:
            self._ps.begin_pass(self._pass_id)

    def end_pass(self, need_save_delta: bool = False,
                 save_root: Optional[str] = None) -> None:
        if self._ps is not None:
            self._ps.end_pass()
            if need_save_delta and save_root:
                self._ps.save_delta(save_root, self._date, self._pass_id)
        self._ds.release_memory()

    def load_into_memory(self) -> None:
        self._ds.load_into_memory()
        self._feed_keys()

    def preload_into_memory(self) -> None:
        self._ds.preload_into_memory()

    def wait_preload_done(self) -> None:
        self._ds.wait_preload_done()
        self._feed_keys()

    def release_memory(self) -> None:
        self._ds.release_memory()

    def local_shuffle(self) -> None:
        self._ds.local_shuffle()

    def slots_shuffle(self, slots: Sequence[int]) -> None:
        self._ds.slots_shuffle(list(slots))

    def get_memory_data_size(self) -> int:
        return self._ds.num_instances()

    # -- plumbing ------------------------------------------------------------

    def _feed_keys(self) -> None:
        """The feed pass: the pass's keys staged into the PS."""
        if self._ps is not None and self._table is not None:
            self._ps.feed_pass({self._table: self._ds.extract_keys()})

    @property
    def dataset(self) -> SlotDataset:
        return self._ds

    def batches(self):
        return self._ds.batches()
