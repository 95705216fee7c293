"""Hash-sharded host embedding table (counterpart of
``paddlebox_tpu/ps/sharded.py``).

``shard_of`` is the one definition of shard ownership: the in-process
``ShardedTable`` here, the networked ``RemoteTable`` and its shard servers
(``ps/service/``) all route by it, and it gives the reference's shard for
every key, so a shard root written by one package resumes in the other.
``partition_dedup`` is the routing layout a remote pull or push sends.
"""

from __future__ import annotations

import concurrent.futures as futures
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from paddlebox_tpu_torch.config import TableConfig
from paddlebox_tpu_torch.ps.table import EmbeddingTable


def shard_of(keys: np.ndarray, num_shards: int) -> np.ndarray:
    """Stable multiplicative hash -> shard id (no modulo bias for
    sequential ids)."""
    k = keys.astype(np.uint64, copy=False)
    h = (k * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(40)
    return (h % np.uint64(max(1, num_shards))).astype(np.int64)


def partition_dedup(keys: np.ndarray, num_shards: int
                    ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Per-shard sorted unique key buckets and the reassembly index:
    ``concatenate(buckets)[inverse] == keys``."""
    sid = shard_of(keys, num_shards)
    buckets: List[np.ndarray] = []
    inverse = np.empty(keys.size, dtype=np.int64)
    base = 0
    for s in range(num_shards):
        mask = sid == s
        uniq, inv = np.unique(keys[mask], return_inverse=True)
        buckets.append(uniq)
        inverse[mask] = base + inv
        base += uniq.size
    return buckets, inverse


class ShardedTable:
    """``conf.num_shards`` host ``EmbeddingTable`` shards behind one
    table's surface; a pull or push of several shards runs them on a
    thread pool. Its save files are one a shard,
    ``<prefix>.shard-NNNNN.npz``."""

    def __init__(self, conf: TableConfig,
                 tables: Optional[Sequence[EmbeddingTable]] = None):
        self.conf = conf
        self.num_shards = max(1, conf.num_shards)
        self.shards: List[EmbeddingTable] = (
            list(tables) if tables is not None
            else [EmbeddingTable(conf) for _ in range(self.num_shards)])
        if len(self.shards) != self.num_shards:
            raise ValueError("tables count != num_shards")
        self._pool = (futures.ThreadPoolExecutor(
            max_workers=self.num_shards, thread_name_prefix="ps-shard")
            if self.num_shards > 1 else None)

    def __len__(self) -> int:
        return sum(len(t) for t in self.shards)

    def _partition(self, keys: np.ndarray):
        sid = shard_of(keys, self.num_shards)
        order = np.argsort(sid, kind="stable")
        bounds = np.searchsorted(sid[order], np.arange(self.num_shards + 1))
        return sid, order, bounds

    def pull(self, keys: np.ndarray, create: bool = True) -> np.ndarray:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        if self.num_shards == 1:
            return self.shards[0].pull(keys, create)
        _sid, order, bounds = self._partition(keys)
        out = np.empty((keys.size, self.conf.pull_dim), dtype=np.float32)

        def one(i):
            part = order[bounds[i]:bounds[i + 1]]
            if part.size:
                out[part] = self.shards[i].pull(keys[part], create)
        list(self._pool.map(one, range(self.num_shards)))
        return out

    def push(self, keys: np.ndarray, grads: np.ndarray) -> None:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        if self.num_shards == 1:
            return self.shards[0].push(keys, grads)
        _sid, order, bounds = self._partition(keys)

        def one(i):
            part = order[bounds[i]:bounds[i + 1]]
            if part.size:
                self.shards[i].push(keys[part], grads[part])
        list(self._pool.map(one, range(self.num_shards)))

    def feed_pass(self, keys: np.ndarray) -> None:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        sid = shard_of(keys, self.num_shards)
        for i, t in enumerate(self.shards):
            t.feed_pass(keys[sid == i])

    def end_pass(self) -> None:
        for t in self.shards:
            t.end_pass()

    def shrink(self) -> int:
        return sum(t.shrink() for t in self.shards)

    # -- persistence ---------------------------------------------------------

    @staticmethod
    def _suffix(i: int) -> str:
        return f".shard-{i:05d}.npz"

    def snapshot_parts(self, delta: bool = False
                       ) -> Dict[str, Dict[str, np.ndarray]]:
        """``SparsePS``'s save protocol: {file suffix: host arrays}."""
        return {self._suffix(i): (t.snapshot_delta() if delta
                                  else t.snapshot())
                for i, t in enumerate(self.shards)}

    def mark_dirty(self, keys: np.ndarray) -> None:
        """Re-mark rows dirty on their shards (a failed commit's
        rollback)."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        if not keys.size:
            return
        sid = shard_of(keys, self.num_shards)
        for i, t in enumerate(self.shards):
            t.mark_dirty(keys[sid == i])

    def save(self, prefix: str) -> None:
        for i, t in enumerate(self.shards):
            t.save(prefix + self._suffix(i))

    def save_delta(self, prefix: str) -> int:
        """Each shard's rows dirty since its last save; returns the rows
        written."""
        return sum(t.save_delta(prefix + self._suffix(i))
                   for i, t in enumerate(self.shards))

    def load(self, prefix: str) -> None:
        for i, t in enumerate(self.shards):
            t.load(prefix + self._suffix(i))

    def load_delta(self, prefix: str) -> None:
        for i, t in enumerate(self.shards):
            t.load_delta(prefix + self._suffix(i))

    def memory_bytes(self) -> int:
        return sum(t.memory_bytes() for t in self.shards)
