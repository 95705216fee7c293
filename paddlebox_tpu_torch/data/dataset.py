"""In-memory slot dataset (counterpart of the in-memory part of
``paddlebox_tpu/data/dataset.py::SlotDataset``).

Files are split round-robin between shards, parsed on a thread pool of
``conf.thread_num`` workers and kept in file order; a pass can be
preloaded in the background (``preload_into_memory`` /
``wait_preload_done``) while the previous one trains. Records are
shuffled in memory with the reference's seed, and batched by
``BatchAssembler``.

Not ported (ROADMAP A.2d), and refused: ``set_merge_by_insid``, the
global shuffles (``shuffle_partition``, ``global_shuffle``,
``global_merge_by_insid``; their cross-host forms ride A.9),
``slots_shuffle`` / ``unshuffle``, ``spill_to_disk`` /
``load_from_archive``, and ``InputTableDataset``.
"""

from __future__ import annotations

import concurrent.futures as futures
from typing import Iterator, List, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch.config import BucketSpec, DataFeedConfig
from paddlebox_tpu_torch.data.batch import BatchAssembler, CsrBatch
from paddlebox_tpu_torch.data.parser import IngestError, SlotParser
from paddlebox_tpu_torch.data.record import SlotRecord


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP A.2d)")


class SlotDataset:
    def __init__(self, conf: DataFeedConfig,
                 buckets: Optional[BucketSpec] = None,
                 shard_id: int = 0, num_shards: int = 1):
        self.conf = conf
        self.parser = SlotParser(conf)
        self.assembler = BatchAssembler(conf, buckets)
        self.filelist: List[str] = []
        self.records: List[SlotRecord] = []
        self.pass_id = 0
        self.shard_id = shard_id
        self.num_shards = num_shards
        self._preload: Optional[futures.Future] = None
        self._pool = futures.ThreadPoolExecutor(
            max_workers=max(1, conf.thread_num),
            thread_name_prefix="dataset-read")
        # one worker drives background preloads, reused across passes
        self._preload_pool = futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="dataset-preload")
        self._rng = np.random.default_rng(1234 + shard_id)

    def close(self) -> None:
        """Stop the parse and preload workers (after any running load)."""
        self._preload_pool.shutdown()
        self._pool.shutdown()

    # -- file list ----------------------------------------------------------

    def set_filelist(self, files: Sequence[str]) -> None:
        """Keep the files whose index is ``shard_id`` modulo
        ``num_shards``."""
        self.filelist = [f for i, f in enumerate(files)
                         if i % self.num_shards == self.shard_id]

    # -- load ---------------------------------------------------------------

    def _load_one(self, path: str) -> List[SlotRecord]:
        """Parse one file; a failure of the whole file (unreadable, not
        text) raises naming the file, as the reference's default file
        budget does."""
        try:
            return self.parser.parse_file(path)
        except IngestError:
            raise
        except Exception as e:  # noqa: BLE001 - named and re-raised
            raise IngestError(f"{path}: {type(e).__name__}: {e}") from e

    def _load(self, files: Sequence[str]) -> List[SlotRecord]:
        """Every file's records, in file order; the first failure (in
        file order) aborts the load once no parse is left running."""
        futs = [self._pool.submit(self._load_one, f) for f in files]
        out: List[SlotRecord] = []
        try:
            for f in futs:
                out.extend(f.result())
        except BaseException:
            for f in futs:
                f.cancel()
            # the first error wins; the stragglers' results are dropped
            futures.wait(futs)
            raise
        return out

    def load_into_memory(self) -> None:
        self.records = self._load(self.filelist)

    def preload_into_memory(self) -> None:
        """Start loading the file list in the background."""
        self._preload = self._preload_pool.submit(self._load,
                                                  list(self.filelist))

    def wait_preload_done(self) -> None:
        """Adopt the background load; its failure raises here as an
        :class:`IngestError` naming the shard."""
        if self._preload is None:
            return
        try:
            records = self._preload.result()
        except IngestError:
            raise
        except Exception as e:
            raise IngestError(
                f"preload failed on shard {self.shard_id}/"
                f"{self.num_shards} ({len(self.filelist)} file(s)): "
                f"{type(e).__name__}: {e}") from e
        # cleared only on success: a retried wait after a failed preload
        # raises again instead of adopting the previous pass's records
        self._preload = None
        self.records = records

    def release_memory(self) -> None:
        self.records = []

    # -- shuffle ------------------------------------------------------------

    def local_shuffle(self) -> None:
        self._rng.shuffle(self.records)

    def shuffle_partition(self, n: int):
        raise _unported("the inter-shard (global) shuffle")

    def set_merge_by_insid(self, merge_size: int = 2) -> None:
        raise _unported("merge by instance id (set_merge_by_insid)")

    def slots_shuffle(self, slot_indices: Sequence[int], seed: int = 0):
        raise _unported("slots_shuffle")

    def unshuffle(self, slot_indices: Sequence[int], perm) -> None:
        raise _unported("unshuffle")

    # -- keys / batches -----------------------------------------------------

    def extract_keys(self) -> np.ndarray:
        """All distinct feature ids in memory (the pass's working set)."""
        parts = [r.uint64_feas for r in self.records
                 if r.uint64_feas is not None and r.uint64_feas.size]
        if not parts:
            return np.empty(0, dtype=np.uint64)
        return np.unique(np.concatenate(parts))

    def num_instances(self) -> int:
        return len(self.records)

    def batches(self, drop_remainder: bool = False) -> Iterator[CsrBatch]:
        self.assembler.drop_remainder = drop_remainder
        yield from self.assembler.batches(self.records)

    # -- disk spill (archive mode) ------------------------------------------

    def spill_to_disk(self, path: str) -> int:
        raise _unported("spill_to_disk (the record archive)")

    def load_from_archive(self, path: str) -> None:
        raise _unported("load_from_archive (the record archive)")


def global_shuffle(datasets: Sequence[SlotDataset]) -> None:
    raise _unported("the inter-shard (global) shuffle")


def global_merge_by_insid(datasets: Sequence[SlotDataset],
                          merge_size: int = 2) -> int:
    raise _unported("the sharded merge by instance id")
