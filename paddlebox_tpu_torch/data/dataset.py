"""In-memory slot dataset (counterpart of
``paddlebox_tpu/data/dataset.py``).

Files are split round-robin between shards, parsed on a thread pool of
``conf.thread_num`` workers under one ``ErrorBudget`` a load and kept in
file order; a pass can be preloaded in the background
(``preload_into_memory`` / ``wait_preload_done``) while the previous one
trains. Records are shuffled in memory with the reference's seed, and
batched by ``BatchAssembler``. Also: merge by instance id
(``set_merge_by_insid``, ``global_merge_by_insid``), the in-process
global shuffle (``shuffle_partition``, ``global_shuffle``), its
cross-host form and the cross-host merge over a coordinator
(``coordinator_global_shuffle``, ``coordinator_global_merge_by_insid``:
one ``alltoall`` of archive blobs a call), ``slots_shuffle`` /
``unshuffle``, the archive spill (``spill_to_disk`` /
``load_from_archive``) and ``InputTableDataset``'s string slots. A load
sets the registry's ``ingest.records_in_memory`` gauge.
"""

from __future__ import annotations

import concurrent.futures as futures
import zlib
from typing import Iterator, List, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch.config import BucketSpec, DataFeedConfig, env_flag
from paddlebox_tpu_torch.data import ingest
from paddlebox_tpu_torch.data.archive import ArchiveReader, ArchiveWriter
from paddlebox_tpu_torch.data.batch import BatchAssembler, CsrBatch
from paddlebox_tpu_torch.data.ingest import (ErrorBudget, IngestBudgetError,
                                             IngestError)
from paddlebox_tpu_torch.data.parser import SlotParser
from paddlebox_tpu_torch.data.record import (GLOBAL_POOL, SlotRecord,
                                             merge_by_insid,
                                             replace_sparse_slots)
from paddlebox_tpu_torch.obs.metrics import REGISTRY


class SlotDataset:
    def __init__(self, conf: DataFeedConfig,
                 buckets: Optional[BucketSpec] = None,
                 shard_id: int = 0, num_shards: int = 1,
                 string_lookup=None):
        self.conf = conf
        self.parser = SlotParser(conf, string_lookup=string_lookup)
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

    def _load_one(self, path: str, budget: ErrorBudget) -> List[SlotRecord]:
        """Parse one file under the pass's shared budget. A file that
        fails whole (unreadable after the retries, killed by the
        watchdog) spends the file budget instead of ending the pass; an
        overspent budget raises."""
        try:
            return self.parser.parse_file(path, budget=budget)
        except IngestBudgetError:
            raise                    # the PASS budget is gone: abort
        except Exception as e:       # noqa: BLE001 - file budget decides
            # other IngestErrors (a pipe the watchdog killed) are this
            # file's failures
            budget.spend_file(path, e)
            return []

    def _load(self, files: Sequence[str]) -> List[SlotRecord]:
        """Every file's records, in file order, under one budget; the
        first failure (in file order) aborts the load and its records
        (the stragglers' too) go back to the pool."""
        budget = ErrorBudget()
        futs = [self._pool.submit(self._load_one, f, budget)
                for f in files]
        out: List[SlotRecord] = []
        err: Optional[BaseException] = None
        for f in futs:
            if err is None:
                try:
                    out.extend(f.result())
                except BaseException as e:  # noqa: BLE001 - first error wins
                    err = e
            else:
                # the pass is aborting: recycle what the stragglers
                # parsed
                f.cancel()
                try:
                    GLOBAL_POOL.put(f.result())
                except BaseException:  # noqa: BLE001 - the first error wins
                    pass
        budget.close()
        if err is not None:
            GLOBAL_POOL.put(out)     # partial pass: nothing escapes
            raise err
        return out

    def set_merge_by_insid(self, merge_size: int = 2) -> None:
        """Merge the parts of an instance (records sharing an ins_id) at
        each load, by ``data/record.py::merge_by_insid``'s rules; needs
        ``parse_ins_id=True``. One shard only: with a round-robin file
        split an instance's parts can land on different shards, where a
        merge would drop them; sharded datasets call
        :func:`global_merge_by_insid` after loading, which brings each
        instance's parts to one shard first."""
        if not self.conf.parse_ins_id:
            raise ValueError("set_merge_by_insid needs parse_ins_id=True")
        if self.num_shards > 1:
            raise ValueError(
                "per-shard merge would drop instances whose parts landed "
                "on other shards; use global_merge_by_insid(datasets) "
                "after load_into_memory")
        self._merge_size = merge_size

    _merge_size: Optional[int] = None
    merge_dropped = 0

    def _post_load(self, records: List[SlotRecord]) -> List[SlotRecord]:
        if self._merge_size is not None:
            records, self.merge_dropped = merge_by_insid(
                records, len(self.parser.sparse_slots),
                len(self.parser.float_slots), self._merge_size,
                pool=GLOBAL_POOL,
                float_is_dense=[s.is_dense
                                for s in self.parser.float_slots])
        return records

    def load_into_memory(self) -> None:
        self.records = self._post_load(self._load(self.filelist))
        REGISTRY.gauge("ingest.records_in_memory").set(len(self.records))

    def preload_into_memory(self) -> None:
        """Start loading the file list in the background."""
        files = list(self.filelist)
        self._preload = self._preload_pool.submit(self._load, files)

    def wait_preload_done(self) -> None:
        """Adopt the background load; its failure raises here as an
        :class:`IngestError` naming the shard."""
        if self._preload is not None:
            fut = self._preload
            try:
                records = fut.result()
            except IngestError:
                ingest.INGEST_STATS.add("preload_failures")
                raise
            except Exception as e:
                ingest.INGEST_STATS.add("preload_failures")
                raise IngestError(
                    f"preload failed on shard {self.shard_id}/"
                    f"{self.num_shards} ({len(self.filelist)} file(s)): "
                    f"{type(e).__name__}: {e}") from e
            # cleared only on success: a retried wait after a failed
            # preload raises again instead of adopting the previous
            # pass's records
            self._preload = None
            self.records = self._post_load(records)
            REGISTRY.gauge("ingest.records_in_memory").set(
                len(self.records))

    def release_memory(self) -> None:
        # slotpool_auto_clear drops the free list at the pass end (the
        # records skip the pool: put() would reset fields clear() drops)
        if env_flag("slotpool_auto_clear", False):
            self.records = []
            GLOBAL_POOL.clear()
            return
        GLOBAL_POOL.put(self.records)
        self.records = []

    # -- shuffle ------------------------------------------------------------

    def local_shuffle(self) -> None:
        self._rng.shuffle(self.records)

    def shuffle_partition(self, n: int) -> List[List[SlotRecord]]:
        """Hash-partition the records into ``n`` buckets (the global
        shuffle's). A record without keys hashes by its ``search_id``,
        else by ``id``, which differs between runs."""
        parts: List[List[SlotRecord]] = [[] for _ in range(n)]
        for r in self.records:
            if r.uint64_feas is not None and r.uint64_feas.size:
                h = int(r.uint64_feas[0]) * 2654435761 + r.uint64_feas.size
            else:
                h = r.search_id or id(r)
            parts[h % n].append(r)
        return parts

    def receive_shuffled(self, records: List[SlotRecord]) -> None:
        self.records = records

    def slots_shuffle(self, slot_indices: Sequence[int],
                      seed: int = 0) -> np.ndarray:
        """Shuffle the listed sparse slots' values across instances (a
        slot's AUC contribution shows when its alignment is destroyed).
        Returns the permutation; ``unshuffle`` with the same
        ``slot_indices`` restores the records."""
        n = len(self.records)
        rng = np.random.default_rng(seed)
        perm = rng.permutation(n)
        self._apply_slot_perm(slot_indices, perm)
        return perm

    def unshuffle(self, slot_indices: Sequence[int],
                  perm: np.ndarray) -> None:
        self._apply_slot_perm(slot_indices, np.argsort(perm))

    def _apply_slot_perm(self, slot_indices: Sequence[int],
                         perm: np.ndarray) -> None:
        donors = [[self.records[int(p)].slot_uint64(s).copy() for p in perm]
                  for s in slot_indices]
        for i, r in enumerate(self.records):
            replace_sparse_slots(
                r, {s: donors[j][i] for j, s in enumerate(slot_indices)})

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
        """Write the records to a binary archive (``data/archive.py``)
        and release them. Returns the count written."""
        with ArchiveWriter(path) as w:
            w.write_all(self.records)
            n = w.count + len(w._buf)
        self.release_memory()
        return n

    def load_from_archive(self, path: str) -> None:
        """The records of an archive, merged by instance id if set."""
        self.records = self._post_load(ArchiveReader(path).read_all())


class InputTableDataset(SlotDataset):
    """SlotDataset whose "string" slots map through an ``InputTable``
    (``ps/replica_cache.py``) of side-input float rows at parse: string
    keys become table offsets as the files load; the index loads from
    its own file list first. A miss maps to offset 0, the zero row.

    The stored key is ``offset XOR KEY_SALT``: keys are global across
    slots, so raw offsets 0, 1, 2, ... would alias real features with
    small ids; the salt moves them to a keyspace of their own, and
    ``side_input`` unsalts. The salted ids get embedding rows of their
    own, beside the dense ``side_input`` features.

    Index file format: one ``<key> <v1> ... <vdim>`` a line.
    """

    KEY_SALT = np.uint64(0x9E3779B97F4A7C15)

    def __init__(self, conf: DataFeedConfig, table_dim: int,
                 buckets: Optional[BucketSpec] = None,
                 shard_id: int = 0, num_shards: int = 1):
        from paddlebox_tpu_torch.ps.replica_cache import InputTable
        self.input_table = InputTable(table_dim)
        salt = int(self.KEY_SALT)
        super().__init__(
            conf, buckets, shard_id, num_shards,
            string_lookup=lambda k:
                self.input_table.get_index_offset(k) ^ salt)
        self.index_filelist: List[str] = []

    def set_index_filelist(self, files: Sequence[str]) -> None:
        self.index_filelist = list(files)

    def load_index_into_memory(self) -> None:
        """Load the side table (before the data files)."""
        for path in self.index_filelist:
            with open(path) as f:
                for line in f:
                    toks = line.split()
                    if not toks:
                        continue
                    self.input_table.add_index_data(
                        toks[0], np.array(toks[1:], dtype=np.float32))

    def _ensure_index(self) -> None:
        if self.index_filelist and len(self.input_table) <= 1:
            self.load_index_into_memory()

    def load_into_memory(self) -> None:
        self._ensure_index()
        super().load_into_memory()

    def preload_into_memory(self) -> None:
        # the index must exist before the background parse starts, or
        # every string key would resolve to the default row
        self._ensure_index()
        super().preload_into_memory()

    def side_input(self, batch: CsrBatch, slot_index: int) -> np.ndarray:
        """[B, dim] side-input rows of a string slot's first offset in
        each instance (none: the default row), to concatenate onto the
        model's dense input."""
        B = batch.batch_size
        offs = np.zeros(B, dtype=np.uint64)
        lens = batch.lengths[:, slot_index]
        starts = np.concatenate([[0], np.cumsum(
            batch.lengths.reshape(-1))])[
            np.arange(B) * batch.num_slots + slot_index]
        has = lens > 0
        offs[has] = batch.keys[starts[has]] ^ self.KEY_SALT
        return self.input_table.lookup_input(offs.astype(np.int64))


def global_shuffle(datasets: Sequence["SlotDataset"]) -> None:
    """Exchange instances between the shards of one process by hash:
    each shard partitions its records (``shuffle_partition``) and shard
    i keeps bucket i of every partition, in shard order."""
    n = len(datasets)
    if not n:
        return
    # the partitions are independent: threads (the result does not
    # depend on their count; the GIL bounds the speedup)
    workers = max(1, int(env_flag("dataset_shuffle_thread_num", 4)))
    with futures.ThreadPoolExecutor(
            max_workers=min(workers, n),
            thread_name_prefix="dataset-shuffle") as ex:
        parts = list(ex.map(lambda ds: ds.shuffle_partition(n), datasets))
    for i, ds in enumerate(datasets):
        merged: List[SlotRecord] = []
        for j in range(n):
            merged.extend(parts[j][i])
        ds.receive_shuffled(merged)


def _exchange_buckets(parts: List[List[SlotRecord]], coord, name: str,
                      timeout: Optional[float]) -> List[SlotRecord]:
    """One ``Coordinator.alltoall`` of the rank's record buckets
    (``parts[j]`` goes to rank ``j``), each an archive blob
    (``data/archive.py`` ``records_to_bytes``); returns what came, in
    rank order. The rank's own bucket never serializes (it joins as it
    is); the sent records go back to the pool, the received ones are
    decoded from it."""
    from paddlebox_tpu_torch.data.archive import (records_from_bytes,
                                                  records_to_bytes)
    blobs = [b"" if j == coord.rank else records_to_bytes(p)
             for j, p in enumerate(parts)]
    recv = coord.alltoall(blobs, name=name, timeout=timeout)
    out: List[SlotRecord] = []
    for j, blob in enumerate(recv):
        if j == coord.rank:
            out.extend(parts[j])
        else:
            out.extend(records_from_bytes(blob, pool=GLOBAL_POOL))
    GLOBAL_POOL.put([r for j, p in enumerate(parts)
                     if j != coord.rank for r in p])
    return out


def coordinator_global_shuffle(ds: "SlotDataset", coord,
                               timeout: Optional[float] = 600.0) -> None:
    """The cross-host shuffle: each rank holds one shard of the dataset,
    partitions its records by hash into ``coord.world`` buckets
    (``shuffle_partition``) and keeps what the ranks' one ``alltoall``
    brings it, so instances of one hash meet on one rank and a skewed
    load evens out. A collective; ``timeout`` bounds each receive."""
    parts = ds.shuffle_partition(coord.world)
    ds.receive_shuffled(_exchange_buckets(parts, coord, "gshuffle",
                                          timeout))


def coordinator_global_merge_by_insid(ds: "SlotDataset", coord,
                                      merge_size: int = 2,
                                      timeout: Optional[float] = 600.0
                                      ) -> int:
    """The cross-host merge by instance id: each record goes to rank
    ``crc32(ins_id) % world`` in one ``alltoall``, so an instance's parts
    meet on one rank, which merges them (``merge_by_insid``). A
    collective. Returns this rank's dropped count."""
    buckets: List[List[SlotRecord]] = [[] for _ in range(coord.world)]
    for r in ds.records:
        buckets[zlib.crc32(r.ins_id.encode()) % coord.world].append(r)
    recs = _exchange_buckets(buckets, coord, "gmerge", timeout)
    merged, dropped = merge_by_insid(
        recs, len(ds.parser.sparse_slots), len(ds.parser.float_slots),
        merge_size, pool=GLOBAL_POOL,
        float_is_dense=[s.is_dense for s in ds.parser.float_slots])
    ds.records = merged
    ds.merge_dropped = dropped
    return dropped


def global_merge_by_insid(datasets: Sequence["SlotDataset"],
                          merge_size: int = 2) -> int:
    """Merge by instance id across shards: bring each instance's parts
    to one shard (``crc32(ins_id) % n``), then merge each shard's. Call
    after each shard's ``load_into_memory``. Returns the dropped count
    over the shards."""
    n = len(datasets)
    if not n:
        return 0
    buckets: List[List[List[SlotRecord]]] = [
        [[] for _ in range(n)] for _ in range(n)]
    for i, ds in enumerate(datasets):
        for r in ds.records:
            buckets[i][zlib.crc32(r.ins_id.encode()) % n].append(r)
    def _merge_one(j_ds):
        j, ds = j_ds
        recs: List[SlotRecord] = []
        for i in range(n):
            recs.extend(buckets[i][j])
        merged, dropped = merge_by_insid(
            recs, len(ds.parser.sparse_slots), len(ds.parser.float_slots),
            merge_size, pool=GLOBAL_POOL,
            float_is_dense=[s.is_dense for s in ds.parser.float_slots])
        ds.records = merged
        ds.merge_dropped = dropped
        return dropped

    # the shards' merges are independent (the pool has its lock)
    workers = max(1, int(env_flag("dataset_merge_thread_num", 4)))
    with futures.ThreadPoolExecutor(
            max_workers=min(workers, n),
            thread_name_prefix="dataset-merge") as ex:
        return sum(ex.map(_merge_one, enumerate(datasets)))
