"""The cross-host PS (counterpart of ``paddlebox_tpu/ps/distributed.py``):
each rank owns one hash shard of the feature space in a local host
``EmbeddingTable``, and pulls, pushes and row staging route keys to their
owners over the coordinator.

``pull``, ``push``, ``feed_pass``, ``export_rows``, ``import_rows``,
``end_pass`` and ``len`` are collectives: every rank enters each one, in
the same order. Keys are routed by ``ps/sharded.py`` ``shard_of`` (the
rank hash, which differs from the mesh's device-shard hash) and
deduplicated a destination (``partition_dedup``) before one ``alltoall``;
the owner answers from its local table and a second ``alltoall`` brings
the rows back. A pull is two exchanges, a push one (each rank's grads
merged by key with ``np.add.at`` first). ``shrink``, the saves and loads
(one file a rank, ``<path>.rank-NNNNN``) and ``memory_bytes`` act on the
local shard only.

Imports numpy and no torch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from paddlebox_tpu_torch.config import TableConfig
from paddlebox_tpu_torch.parallel.coordinator import (Coordinator,
                                                      np_from_bytes,
                                                      np_to_bytes)
from paddlebox_tpu_torch.ps.sharded import partition_dedup, shard_of
from paddlebox_tpu_torch.ps.table import EmbeddingTable


class DistributedTable:
    """Rank ``coord.rank``'s shard (``local_table``, or a fresh
    ``EmbeddingTable(conf)``) of a table spread over ``coord.world``
    ranks."""

    def __init__(self, conf: TableConfig, coord: Coordinator,
                 local_table: Optional[EmbeddingTable] = None):
        self.conf = conf
        self.coord = coord
        self.world = coord.world
        self.rank = coord.rank
        self.local = local_table or EmbeddingTable(conf)
        # the collectives' sequence number: each round's tags are its own
        self._step = 0

    def _next(self, what: str) -> str:
        self._step += 1
        return f"{what}{self._step}"

    # -- collectives ---------------------------------------------------------

    def pull(self, keys: np.ndarray, create: bool = True) -> np.ndarray:
        """``[N]`` keys -> ``[N, pull_dim]`` rows."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        name = self._next("pull")
        buckets, inverse = partition_dedup(keys, self.world)
        reqs = self.coord.alltoall([np_to_bytes(b) for b in buckets],
                                   name + ":k")
        answers = []
        for blob in reqs:
            req_keys = np_from_bytes(blob)[0].astype(np.uint64)
            vals = (self.local.pull(req_keys, create=create)
                    if req_keys.size else
                    np.zeros((0, self.conf.pull_dim), np.float32))
            answers.append(np_to_bytes(vals))
        resp = self.coord.alltoall(answers, name + ":v")
        flat = np.concatenate([np_from_bytes(b)[0] for b in resp], axis=0)
        return flat[inverse]

    def push(self, keys: np.ndarray, grads: np.ndarray) -> None:
        """Merge this rank's grads by key, send each owner its keys'
        sums, and push what arrives into the local shard in rank order."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        name = self._next("push")
        buckets, inverse = partition_dedup(keys, self.world)
        merged = np.zeros((sum(b.size for b in buckets),
                           self.conf.pull_dim), np.float32)
        np.add.at(merged, inverse, np.asarray(grads, np.float32))
        blobs, base = [], 0
        for b in buckets:
            blobs.append(np_to_bytes(b, merged[base:base + b.size]))
            base += b.size
        for blob in self.coord.alltoall(blobs, name + ":g"):
            k, g = np_from_bytes(blob)
            if k.size:
                self.local.push(k.astype(np.uint64), g)

    def feed_pass(self, keys: np.ndarray) -> None:
        """Stage the pass's keys on their owners (``EmbeddingTable.
        feed_pass``)."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        sid = shard_of(keys, self.world)
        blobs = [np_to_bytes(np.unique(keys[sid == r]))
                 for r in range(self.world)]
        for blob in self.coord.alltoall(blobs, self._next("feed")):
            k = np_from_bytes(blob)[0].astype(np.uint64)
            if k.size:
                self.local.feed_pass(k)

    # -- bulk rows: a pass's working set staged across hosts ----------------

    def export_rows(self, keys: np.ndarray, create: bool = True):
        """``(values [N, pull_dim], state [N, state_dim])`` of ``keys``,
        fetched from their owners (new keys created there with
        ``create``)."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        name = self._next("exp")
        buckets, inverse = partition_dedup(keys, self.world)
        reqs = self.coord.alltoall([np_to_bytes(b) for b in buckets],
                                   name + ":k")
        answers = []
        sd = self.local._state.shape[1]
        for blob in reqs:
            req_keys = np_from_bytes(blob)[0].astype(np.uint64)
            if req_keys.size:
                vals, state = self.local.export_rows(req_keys, create)
            else:
                vals = np.zeros((0, self.conf.pull_dim), np.float32)
                state = np.zeros((0, sd), np.float32)
            answers.append(np_to_bytes(vals, state))
        resp = self.coord.alltoall(answers, name + ":v")
        vparts, sparts = zip(*(np_from_bytes(b) for b in resp))
        vals = np.concatenate(vparts, axis=0)
        state = np.concatenate(sparts, axis=0)
        return vals[inverse], state[inverse]

    def import_rows(self, keys: np.ndarray, values: np.ndarray,
                    state: np.ndarray, mode: str = "set") -> None:
        """Write rows back to their owners. ``mode="set"``: the last
        writer wins (each key staged by one rank a pass); ``"add"``: the
        callers send deltas and the owners add them up (working sets that
        overlap across ranks)."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        name = self._next("imp")
        sid = shard_of(keys, self.world)
        blobs = []
        for r in range(self.world):
            sel = np.flatnonzero(sid == r)
            blobs.append(np_to_bytes(keys[sel], values[sel], state[sel]))
        for blob in self.coord.alltoall(blobs, name + ":w"):
            k, v, s = np_from_bytes(blob)
            if k.size:
                self.local.import_rows(k.astype(np.uint64), v, s,
                                       mode=mode)

    def end_pass(self) -> None:
        """The local shard's pass end (its decay), then a barrier."""
        self.local.end_pass()
        self.coord.barrier(f"endpass{self._step}")

    def __len__(self) -> int:
        """The global feature count (a collective)."""
        total = self.coord.allreduce_sum(
            np.array([len(self.local)], np.int64), self._next("len"))
        return int(total[0])

    # -- the local shard -----------------------------------------------------

    def _path(self, path: str) -> str:
        return f"{path}.rank-{self.rank:05d}"

    def shrink(self) -> int:
        return self.local.shrink()

    def save(self, path: str) -> None:
        self.local.save(self._path(path))

    def save_delta(self, path: str) -> int:
        return self.local.save_delta(self._path(path))

    def load(self, path: str) -> None:
        self.local.load(self._path(path))

    def load_delta(self, path: str) -> None:
        self.local.load_delta(self._path(path))

    def memory_bytes(self) -> int:
        return self.local.memory_bytes()
