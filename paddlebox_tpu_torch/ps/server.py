"""Sparse parameter-server facade: named tables and their pass and save
lifecycle (counterpart of ``paddlebox_tpu/ps/server.py::SparsePS``).

A ``SparsePS`` owns one table per feature space, any mix of the port's
three kinds: the host ``EmbeddingTable`` (``ps/table.py``), the
device-resident ``DeviceTable`` and the ``TieredDeviceTable`` over a host
backing (``ps/tiered_table.py``). It drives their shared lifecycle:

    begin_pass -> feed_pass(keys)   stage the pass's working set
    prefetch_pass(keys)             start the next pass's staging early
    end_pass                        writeback, show/clk decay
    save_base / save_delta          full and incremental snapshots
    shrink                          evict cold features

Snapshot layout under ``root`` (the donefile protocol is
``trainer/donefile.py``), the reference's:

    <root>/<day>/<pass:05d>/base/<table>.npz     the whole table
    <root>/<day>/<pass:05d>/delta/<table>.npz    rows dirty since the last save

Dirs commit atomically (``ckpt/atomic.py``: a staging dir, a manifest,
fsyncs, a rename) and loads verify the manifest first.

The reference's host ``ShardedTable`` is not ported (ROADMAP A.9).
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Union

import numpy as np

from paddlebox_tpu_torch.ckpt import atomic
from paddlebox_tpu_torch.ps.device_table import DeviceTable
from paddlebox_tpu_torch.ps.table import EmbeddingTable

Table = Union[EmbeddingTable, DeviceTable]


class SparsePS:
    def __init__(self, tables: Mapping[str, Table]):
        if not tables:
            raise ValueError("SparsePS needs at least one table")
        for name, t in tables.items():
            if not isinstance(t, (EmbeddingTable, DeviceTable)):
                raise TypeError(
                    f"table {name!r} is a {type(t).__name__}: SparsePS takes "
                    "EmbeddingTable, DeviceTable and TieredDeviceTable")
        self.tables: Dict[str, Table] = dict(tables)
        self.current_pass: Optional[int] = None

    def __getitem__(self, name: str) -> Table:
        return self.tables[name]

    # -- pass lifecycle ------------------------------------------------------

    def begin_pass(self, pass_id: int) -> None:
        if self.current_pass is not None:
            raise RuntimeError(
                f"pass {self.current_pass} still open; call end_pass first")
        self.current_pass = pass_id

    def feed_pass(self, keys_by_table: Mapping[str, np.ndarray]) -> None:
        """Stage the pass's working set, so that no training step inserts:
        a tiered table stages its arena (``begin_feed_pass``, which
        consumes a matching ``prefetch_pass``), a host table creates the
        keys (``feed_pass``), a ``DeviceTable`` inserts them
        (``prepare_batch(create=True)``, which also keeps a device-prep
        table's mirror in step and marks the keys dirty)."""
        for name, keys in keys_by_table.items():
            table = self.tables[name]
            keys = np.asarray(keys, dtype=np.uint64)
            if hasattr(table, "begin_feed_pass"):
                table.begin_feed_pass(keys)
            elif hasattr(table, "feed_pass"):
                table.feed_pass(keys)
            else:
                table.prepare_batch(keys, create=True)

    def prefetch_pass(self, keys_by_table: Mapping[str, np.ndarray]
                      ) -> None:
        """Start the asynchronous half of the next feed pass on the tables
        that stage in the background (``TieredDeviceTable.
        prefetch_feed_pass``); the others stage at ``feed_pass``."""
        for name, keys in keys_by_table.items():
            table = self.tables[name]
            if hasattr(table, "prefetch_feed_pass"):
                table.prefetch_feed_pass(np.asarray(keys, dtype=np.uint64))

    def end_pass(self) -> None:
        """End the pass in every table: a tiered table writes back, then
        the host tables decay show/clk (the tiered table's backing, not
        its arena)."""
        for t in self.tables.values():
            t.end_pass()
        self.current_pass = None

    def shrink(self) -> int:
        """Evict cold features; returns the count evicted. A
        ``DeviceTable`` has no eviction, in the reference either."""
        return sum(t.shrink() for t in self.tables.values()
                   if hasattr(t, "shrink"))

    # -- persistence ---------------------------------------------------------
    # ``PassManager`` splits a save: ``snapshot_files`` (host copies, on the
    # training thread) and the serialize-and-commit job (on the writer).

    def ckpt_dir(self, root: str, day: str, pass_id: int, kind: str) -> str:
        return os.path.join(root, str(day), f"{pass_id:05d}", kind)

    def snapshot_files(self, kind: str = "base"
                       ) -> Dict[str, Dict[str, np.ndarray]]:
        """The files of a ``kind`` ("base" or "delta") checkpoint dir, each
        a dict of host numpy copies, by file name; taking them clears the
        tables' dirty marks."""
        files: Dict[str, Dict[str, np.ndarray]] = {}
        for name, t in self.tables.items():
            for suffix, arrays in t.snapshot_parts(
                    delta=kind == "delta").items():
                files[f"{name}.npz{suffix}"] = arrays
        return files

    def _save(self, root: str, day: str, pass_id: int, kind: str) -> str:
        final = self.ckpt_dir(root, day, pass_id, kind)
        files = self.snapshot_files(kind)
        staging = atomic.stage_dir(final)
        for fname, arrays in files.items():
            atomic.write_npz(os.path.join(staging, fname), arrays)
        atomic.commit_dir(staging, final)
        return final

    def save_base(self, root: str, day: str, pass_id: int) -> str:
        return self._save(root, day, pass_id, "base")

    def save_delta(self, root: str, day: str, pass_id: int) -> str:
        return self._save(root, day, pass_id, "delta")

    def load_base(self, path: str) -> None:
        atomic.verify(path)
        for name, t in self.tables.items():
            t.load(os.path.join(path, f"{name}.npz"))

    def load_delta(self, path: str) -> None:
        atomic.verify(path)
        for name, t in self.tables.items():
            t.load_delta(os.path.join(path, f"{name}.npz"))

    # -- stats ---------------------------------------------------------------

    def num_features(self) -> Dict[str, int]:
        return {name: len(t) for name, t in self.tables.items()}

    def memory_bytes(self) -> int:
        return sum(t.memory_bytes() for t in self.tables.values())
