"""Disk tier for embedding tables: cold features spill to disk, pass
working sets stage back to memory (counterpart of
``paddlebox_tpu/ps/ssd_tier.py``: the same chunk format, file names and
resume scan, so a disk root written by either package reopens in the
other).

Counterpart of the reference PS's memory hierarchy (libbox_ps HBM /
CPU-mem / SSD tiers, SURVEY.md §2.1): ``BeginFeedPass`` stages the coming
pass's keys from SSD into memory (box_wrapper.cc:585-621), ``EndPass``
flushes deltas down, ``LoadSSD2Mem`` preloads a day (box_wrapper.cc:1424).

Design: an append-only chunk log per table in a RAW STREAMING format —
one fixed header plus contiguous column regions (keys u64 | embedx_ok u8
| values f32 | state f32), written with ``ndarray.tofile`` and read back
through ``np.memmap`` so staging a pass's rows touches only the pages
those rows live on (row-gather against the mapped region; no whole-chunk
decompress, no pickle). ``evict_cold`` moves features whose show count
fell below a threshold out of the in-memory table into the log (keeping
a key -> (chunk, row) host index); ``stage`` pulls any staged keys of
the incoming pass back into memory before training. Compaction rewrites
live entries and drops superseded ones. ``io_stats`` accounts
spill/stage bytes and wall seconds so the spill/stage bandwidth is a
measured, reportable number.

Cold-path machinery:

- A **blocked bloom filter** (ps/bloom.py) fronts the key index: probes
  for keys never spilled — the ENTIRE all-new-keys cold pass — return
  at the bloom, touching neither the index nor any lock beyond one
  filter read.  No false negatives by construction; the filter is
  append-only between rebuilds and is rebuilt from the live index at
  compact/resume.  ``ps_bloom_bits_per_key=0`` disables it (the
  pre-filter-free path).
- **Concurrent compaction**: no coarse I/O lock. Readers pin the chunks they gather from through per-chunk REFCOUNTED
  guards (``_ChunkGuards``); ``compact()`` copies live rows into a fresh
  chunk (committed with the ckpt.atomic tmp->fsync->rename protocol),
  atomically swaps index entries that still point at their snapshot
  location (a newer mid-compact spill wins the CAS), then RETIRES the
  old chunks — files are deleted when their last reader releases, so an
  in-flight ``read_rows`` never hits a vanished file and never waits out
  a compaction.  A reader that loses the race to a retiring chunk
  re-resolves through the (already swapped) index; that bounded retry is
  the only "stall" left.
- ``evict_cold`` skips keys in the live feed pass (the owner tiered
  table publishes them via ``live_keys_fn``): spilling a row that the
  open pass staged into the device arena just forces an immediate restage of a copy
  that is about to be superseded by the pass's writeback anyway.

Lock order (``_LOCK_ORDER``): the backing table's ``_lock`` is
outermost; the tier's own locks — compact serialization, chunk-id
allocation, bloom+index registration, spill-journal mark — nest strictly
after it and never nest inside the chunk guards' internal lock.

``io_point`` (``utils/faults.py``) fronts the three filesystem touches:
``ssd.spill``, ``ssd.read`` and ``ssd.compact``. ``read_rows`` and
``compact`` are ``ps.ssd.read_rows`` and ``ps.ssd.compact`` spans of the
trace (``obs/trace.py``). Beside its own ``io_stats`` the tier counts into
the global registry under the reference's names: ``ps.disk.bloom_hit``
and ``bloom_miss``, the ``ps.disk.stage_ms`` and ``compact_stall_ms``
histograms, ``ps.ssd.spill_bytes``, ``spill_rows``, ``stage_bytes`` and
``compactions``, and the ``ps.ssd.spill_chunk_ms`` and
``stage_chunk_ms`` histograms.
"""

from __future__ import annotations

import os
import struct
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from paddlebox_tpu_torch.ckpt import atomic as ckpt_atomic
from paddlebox_tpu_torch.config import env_flag
from paddlebox_tpu_torch.obs import trace
from paddlebox_tpu_torch.obs.metrics import REGISTRY
from paddlebox_tpu_torch.ps import native
from paddlebox_tpu_torch.ps.bloom import BlockedBloom
from paddlebox_tpu_torch.ps.table import EmbeddingTable
from paddlebox_tpu_torch.utils.faults import io_point

_MAGIC = b"PBXD\x01"
_HDR = struct.Struct("<qqq")  # n_rows, value_dim, state_dim
# the reference's flag default (PBOX_FLAGS_ps_bloom_bits_per_key)
BLOOM_BITS_PER_KEY = 10

# Acquisition order of the locks in this module, outermost first:
# nothing acquires an earlier lock while holding a later one. No coarse
# I/O lock serializes read_rows against compact.
_LOCK_ORDER = ("_lock", "_compact_lock", "_alloc_lock", "_bloom_lock",
               "_mark_lock", "_glock", "_stats_lock")


class _DiskIndex:
    """key -> (chunk, row) map for the chunk log, with BULK operations.

    Spills register up to 10^8 keys per chunk and staging probes whole
    pass working sets; a python dict pays an interpreter loop per key —
    minutes of metadata time per 100M-row spill, all of it on the pass
    boundary (or the prefetch thread). Native path: the open-addressing
    Map64 assigns each key a dense SLOT and a numpy array carries the
    packed location (chunk << 40 | row); deletion tombstones the slot
    (rebuilt away by clear/compact). The dict remains as the fallback
    when no compiler is available."""

    _ROW_BITS = 40
    _ROW_MASK = (1 << 40) - 1

    def __init__(self):
        # ctypes releases the GIL during the Map64 calls, so a prefetch
        # thread's get_bulk could race a training-thread spill's
        # set_bulk rehash (the dict ops this replaces were GIL-atomic);
        # every map/loc access holds this lock — bulk granularity keeps
        # contention negligible. The dict fallback holds it too: dict
        # ITERATION (live_items/__iter__) is not GIL-atomic against a
        # concurrent set_bulk resize.
        self._lock = threading.Lock()
        self._use_native = native.available()
        if self._use_native:
            self._map = native.NativeIndex()
            self._loc = np.full(1024, -1, np.int64)     # guarded-by: _lock
            self._n_slots = 0                           # guarded-by: _lock
            self._live = 0
        else:
            self._d: Dict[int, Tuple[int, int]] = {}    # guarded-by: _lock

    def __len__(self) -> int:
        with self._lock:
            return self._live if self._use_native else len(self._d)

    def __contains__(self, key) -> bool:
        if not self._use_native:
            with self._lock:
                return int(key) in self._d
        _c, _r, found = self.get_bulk(np.array([key], np.uint64))
        return bool(found[0])

    def __iter__(self):
        keys, _c, _r = self.live_items()
        return iter(keys.tolist())

    def set_bulk(self, keys: np.ndarray, cid: int,
                 rows: np.ndarray) -> None:
        """Register keys[i] -> (cid, rows[i]); latest registration wins.
        ``keys`` must be duplicate-free (chunk rows are)."""
        keys = np.ascontiguousarray(keys, np.uint64)
        rows = np.asarray(rows, np.int64)
        if not self._use_native:
            with self._lock:
                for i, k in enumerate(keys):
                    self._d[int(k)] = (cid, int(rows[i]))
            return
        with self._lock:
            slots, n_new = self._map.lookup(keys, create=True,
                                            skip_zero=False,
                                            next_row=self._n_slots)
            need = self._n_slots + n_new
            if need > self._loc.size:
                grown = np.full(max(need, self._loc.size * 2), -1,
                                np.int64)
                grown[:self._n_slots] = self._loc[:self._n_slots]
                self._loc = grown
            old = slots < self._n_slots
            revived = int((self._loc[slots[old]] < 0).sum()) \
                if old.any() else 0
            self._n_slots = need
            self._loc[slots] = ((np.int64(cid)
                                 << np.int64(self._ROW_BITS)) | rows)
            self._live += n_new + revived

    def get_bulk(self, keys: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(cids, rows, found) for keys; cids/rows are valid only where
        ``found``."""
        keys = np.ascontiguousarray(keys, np.uint64)
        if not self._use_native:
            cids = np.full(keys.size, -1, np.int64)
            rows = np.full(keys.size, -1, np.int64)
            found = np.zeros(keys.size, bool)
            with self._lock:
                for i, k in enumerate(keys):
                    e = self._d.get(int(k))
                    if e is not None:
                        found[i] = True
                        cids[i], rows[i] = e
            return cids, rows, found
        with self._lock:
            slots, _ = self._map.lookup(keys, create=False,
                                        skip_zero=False, next_row=0)
            loc = np.full(keys.size, -1, np.int64)
            ok = slots >= 0
            loc[ok] = self._loc[slots[ok]]
        found = loc >= 0
        return loc >> self._ROW_BITS, loc & self._ROW_MASK, found

    def replace_where(self, keys: np.ndarray, exp_cids: np.ndarray,
                      exp_rows: np.ndarray, new_cid: int,
                      new_rows: np.ndarray) -> int:
        """Bulk compare-and-swap: entries still at their expected
        (cid, row) snapshot location move to (new_cid, new_rows[i]);
        entries that changed since the snapshot — a newer spill landed
        mid-compact — or vanished keep their current state.  The atomic
        swap half of concurrent compaction.  Returns #moved."""
        keys = np.ascontiguousarray(keys, np.uint64)
        exp_cids = np.asarray(exp_cids, np.int64)
        exp_rows = np.asarray(exp_rows, np.int64)
        new_rows = np.asarray(new_rows, np.int64)
        if not self._use_native:
            moved = 0
            with self._lock:
                for i, k in enumerate(keys):
                    e = self._d.get(int(k))
                    if e is not None and e == (int(exp_cids[i]),
                                               int(exp_rows[i])):
                        self._d[int(k)] = (new_cid, int(new_rows[i]))
                        moved += 1
            return moved
        with self._lock:
            slots, _ = self._map.lookup(keys, create=False,
                                        skip_zero=False, next_row=0)
            ok = slots >= 0
            cur = np.full(keys.size, -1, np.int64)
            cur[ok] = self._loc[slots[ok]]
            expected = ((exp_cids << np.int64(self._ROW_BITS))
                        | exp_rows)
            match = ok & (cur >= 0) & (cur == expected)
            self._loc[slots[match]] = \
                ((np.int64(new_cid) << np.int64(self._ROW_BITS))
                 | new_rows[match])
            return int(match.sum())

    def delete_bulk(self, keys: np.ndarray) -> None:
        keys = np.ascontiguousarray(keys, np.uint64)
        if not self._use_native:
            with self._lock:
                for k in keys:
                    self._d.pop(int(k), None)
            return
        with self._lock:
            slots, _ = self._map.lookup(keys, create=False,
                                        skip_zero=False, next_row=0)
            s = slots[slots >= 0]
            lv = self._loc[s] >= 0
            self._loc[s[lv]] = -1
            self._live -= int(lv.sum())

    def live_items(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(keys, cids, rows) of every live entry."""
        if not self._use_native:
            with self._lock:       # dict iteration vs concurrent spill
                n = len(self._d)
                keys = np.fromiter(self._d.keys(), np.uint64, n)
                cids = np.fromiter((e[0] for e in self._d.values()),
                                   np.int64, n)
                rows = np.fromiter((e[1] for e in self._d.values()),
                                   np.int64, n)
            return keys, cids, rows
        with self._lock:
            keys = self._map.dump_keys(self._n_slots)
            loc = self._loc[:self._n_slots].copy()
        m = loc >= 0
        return (keys[m], loc[m] >> self._ROW_BITS,
                loc[m] & self._ROW_MASK)

    def clear(self) -> None:
        with self._lock:
            if self._use_native:
                self._map = native.NativeIndex()
                self._loc = np.full(1024, -1, np.int64)
                self._n_slots = 0
                self._live = 0
            else:
                self._d.clear()


class _ChunkGuards:
    """Per-chunk refcounts with deferred deletion — what lets
    ``read_rows`` proceed against chunks a concurrent ``compact()`` is
    retiring.  A reader ``acquire``s every chunk it gathers from (False
    = the chunk was retired; re-resolve through the index, which the
    compaction already swapped); ``retire`` marks a chunk dead and
    deletes its file immediately when unreferenced, else at the last
    ``release``.  Retired chunk ids stay dead forever (ids are
    monotonic, so the set is bounded by compaction history)."""

    def __init__(self):
        self._glock = threading.Lock()
        self._refs: Dict[int, int] = {}        # guarded-by: _glock
        self._pending: Dict[int, str] = {}     # guarded-by: _glock
        self._dead: set = set()                # guarded-by: _glock

    def acquire(self, cid: int) -> bool:
        with self._glock:
            if cid in self._dead:
                return False
            self._refs[cid] = self._refs.get(cid, 0) + 1
            return True

    def release(self, cid: int) -> None:
        path = None
        with self._glock:
            n = self._refs.get(cid, 0) - 1
            if n > 0:
                self._refs[cid] = n
            else:
                self._refs.pop(cid, None)
                path = self._pending.pop(cid, None)
        if path is not None:
            try:
                os.remove(path)
            except OSError:
                pass                     # already gone / racing cleanup

    def retire(self, cid: int, path: str) -> None:
        delete_now = False
        with self._glock:
            if cid in self._dead:
                return
            self._dead.add(cid)
            if self._refs.get(cid, 0) > 0:
                self._pending[cid] = path
            else:
                delete_now = True
        if delete_now:
            try:
                os.remove(path)
            except OSError:
                pass

    def pending_deletes(self) -> int:
        with self._glock:
            return len(self._pending)


class DiskTier:
    def __init__(self, table: EmbeddingTable, root: str,
                 chunk_rows: int = 65536, resume: bool = False,
                 bloom_bits_per_key: Optional[int] = None):
        self.table = table
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.chunk_rows = chunk_rows
        # key -> (chunk_id, row_in_chunk); latest wins; bulk-vectorized
        self._index = _DiskIndex()
        self.io_stats = {   # guarded-by: _stats_lock
                         "spill_bytes": 0, "spill_seconds": 0.0,
                         "stage_bytes": 0, "stage_seconds": 0.0,
                         "stage_insert_seconds": 0.0}
        # leaf lock (last in _LOCK_ORDER) guarding the io_stats
        # accumulators: with _io_lock retired, concurrent read_rows /
        # compact / evict_cold spills would lose += updates and inflate
        # the reported bandwidth
        self._stats_lock = threading.Lock()
        # one compact at a time; spills and reads run CONCURRENTLY with
        # it (the per-chunk guards + index CAS make that safe)
        self._compact_lock = threading.Lock()
        # chunk-id allocation + the in-flight-write set: a chunk in
        # ``_writing`` is visible on disk but its index entries may not
        # be registered yet, so compact's garbage collection must not
        # touch it
        self._alloc_lock = threading.Lock()
        self._next_chunk = 0               # guarded-by: _alloc_lock
        self._writing: set = set()         # guarded-by: _alloc_lock
        # existence filter + the lock that makes (bloom add, index
        # set_bulk) atomic against the compact-time rebuild — the pairing
        # is what guarantees NO FALSE NEGATIVES across a rebuild
        self._bloom_lock = threading.Lock()
        if bloom_bits_per_key is None:
            bloom_bits_per_key = int(env_flag("ps_bloom_bits_per_key",
                                              BLOOM_BITS_PER_KEY))
        self._bloom_bits = int(bloom_bits_per_key)
        self._bloom: Optional[BlockedBloom] = (   # guarded-by: _bloom_lock
            BlockedBloom(1 << 16, self._bloom_bits)
            if self._bloom_bits > 0 else None)
        self._guards = _ChunkGuards()
        # spill journal for the (single) outstanding prefetch mark: keys
        # written to chunks while a mark is active (consumers ask "what
        # moved to disk since I exported?" without a per-key dict walk).
        # mark_spills rides the prefetch thread, _write_chunk the
        # training thread's evict_cold — hence the lock.
        self._mark_lock = threading.Lock()
        self._marking = False          # guarded-by: _mark_lock
        self._spill_log: list = []     # guarded-by: _mark_lock
        # keys of the OPEN feed pass (the owner tiered table publishes a
        # callable); evict_cold skips them — spilling a row the pass just
        # staged into HBM is write-then-immediately-restage churn, and
        # the pass's writeback supersedes the spilled copy anyway
        self.live_keys_fn: Optional[Callable[[], Optional[np.ndarray]]] \
            = None
        # fence deferred demote IO (ps_tier_demote) before an eviction
        # reads the backing table: without it evict_cold could spill
        # rows the worker has not yet imported/decayed — a silent
        # divergence from the synchronous path (owner table wires this
        # to its _join_demote)
        self.demote_fence_fn: Optional[Callable[[], None]] = None
        if resume:
            self._scan_existing()

    def _scan_existing(self) -> None:
        """Rebuild the key index (and the bloom filter) from chunk files
        already in ``root`` — the log IS the durable state, so a fresh
        process (per-pass bench isolation, crash recovery) reopens the
        tier by scanning key columns in chunk order; latest chunk wins,
        matching the append-order semantics of ``_write_chunk``."""
        for f in os.listdir(self.root):
            # atomic-commit debris from a crashed compact: only the
            # committed .pbxd name is ever referenced
            if f.startswith("chunk-") and ".tmp" in f:
                try:
                    os.remove(os.path.join(self.root, f))
                except OSError:
                    pass
        cids = self._disk_cids()
        for cid in cids:           # ascending: latest chunk wins
            keys, _ok, _v, _s = self._map_chunk(cid)
            ks = np.asarray(keys)
            self._index.set_bulk(ks, cid,
                                 np.arange(ks.size, dtype=np.int64))
        with self._alloc_lock:
            self._next_chunk = cids[-1] + 1 if cids else 0
        self._rebuild_bloom()

    # -- internals -----------------------------------------------------------

    def _chunk_path(self, cid: int) -> str:
        return os.path.join(self.root, f"chunk-{cid:06d}.pbxd")

    def _disk_cids(self) -> list:
        return sorted(
            int(f[len("chunk-"):-len(".pbxd")])
            for f in os.listdir(self.root)
            if f.startswith("chunk-") and f.endswith(".pbxd"))

    def _alloc_cid(self) -> int:
        with self._alloc_lock:
            cid = self._next_chunk
            self._next_chunk += 1
            self._writing.add(cid)
            return cid

    def _end_write(self, cid: int) -> None:
        with self._alloc_lock:
            self._writing.discard(cid)

    def _rebuild_bloom(self) -> None:
        """Fresh filter over exactly the live key set — run at
        compact/resume, when deletion tombstones (which a bloom cannot
        represent) are purged anyway.  Holding ``_bloom_lock`` across
        the live_items read AND the swap pairs with ``_write_chunk``
        registering (bloom, index) under the same lock: a concurrent
        spill's keys land either in the snapshot or in the new filter,
        never in neither."""
        with self._bloom_lock:
            if self._bloom is None:
                return
            lk, _c, _r = self._index.live_items()
            nb = BlockedBloom(max(int(lk.size) * 2, 1 << 16),
                              self._bloom_bits)
            nb.add_bulk(lk)
            self._bloom = nb

    def _bloom_probe(self, keys: np.ndarray) -> np.ndarray:
        """bool[N] "possibly on disk" mask (all-True when the filter is
        disabled); counts hits and misses."""
        with self._bloom_lock:
            if self._bloom is None:
                return np.ones(keys.size, bool)
            hit = self._bloom.contains_bulk(keys)
        n_hit = int(hit.sum())
        REGISTRY.add("ps.disk.bloom_hit", n_hit)
        REGISTRY.add("ps.disk.bloom_miss", int(keys.size) - n_hit)
        return hit

    def _write_chunk_file(self, cid: int, keys: np.ndarray,
                          values: np.ndarray, state: np.ndarray,
                          embedx_ok: np.ndarray,
                          atomic: bool = False) -> None:
        io_point("ssd.spill")
        n = int(keys.size)
        t0 = time.perf_counter()
        path = self._chunk_path(cid)

        def body(f):
            f.write(_MAGIC)
            f.write(_HDR.pack(n, values.shape[1], state.shape[1]))
            np.ascontiguousarray(keys, dtype=np.uint64).tofile(f)
            np.ascontiguousarray(embedx_ok, dtype=np.uint8).tofile(f)
            np.ascontiguousarray(values, dtype=np.float32).tofile(f)
            np.ascontiguousarray(state, dtype=np.float32).tofile(f)

        if atomic:
            # compact's replacement chunk commits via the ckpt protocol
            # (tmp -> fsync -> rename): a crash mid-rewrite leaves the
            # old chunks + index intact, never a torn half-compact
            with ckpt_atomic.atomic_file(path, "wb") as f:
                body(f)
        else:
            with open(path, "wb") as f:
                body(f)
        spill_s = time.perf_counter() - t0
        spill_b = n * (8 + 1 + 4 * values.shape[1] + 4 * state.shape[1])
        with self._stats_lock:
            self.io_stats["spill_seconds"] += spill_s
            self.io_stats["spill_bytes"] += spill_b
        REGISTRY.add("ps.ssd.spill_bytes", spill_b)
        REGISTRY.add("ps.ssd.spill_rows", n)
        REGISTRY.observe("ps.ssd.spill_chunk_ms", spill_s * 1e3)

    def _write_chunk(self, keys: np.ndarray, values: np.ndarray,
                     state: np.ndarray, embedx_ok: np.ndarray) -> int:
        cid = self._alloc_cid()
        try:
            self._write_chunk_file(cid, keys, values, state, embedx_ok)
            ks = np.ascontiguousarray(keys, np.uint64)
            n = int(ks.size)
            with self._bloom_lock:
                # bloom BEFORE index, atomically vs rebuild: a reader
                # must never see an indexed key the filter denies
                if self._bloom is not None:
                    self._bloom.add_bulk(ks)
                self._index.set_bulk(ks, cid,
                                     np.arange(n, dtype=np.int64))
            with self._mark_lock:
                if self._marking:
                    self._spill_log.append(ks.copy())
        finally:
            # only now may compact's GC consider this cid: its index
            # entries are registered (or the write failed and the file,
            # if any, is unreferenced garbage)
            self._end_write(cid)
        return cid

    def _map_chunk(self, cid: int):
        """Memory-map a chunk's column regions (read touches only the
        pages the gathered rows live on)."""
        path = self._chunk_path(cid)
        with open(path, "rb") as f:
            if f.read(len(_MAGIC)) != _MAGIC:
                raise ValueError(f"{path}: not a pbx disk chunk")
            n, d, sd = _HDR.unpack(f.read(_HDR.size))
        base = len(_MAGIC) + _HDR.size
        keys = np.memmap(path, dtype=np.uint64, mode="r", offset=base,
                         shape=(n,))
        off = base + 8 * n
        ok = np.memmap(path, dtype=np.uint8, mode="r", offset=off,
                       shape=(n,))
        off += n
        vals = np.memmap(path, dtype=np.float32, mode="r", offset=off,
                         shape=(n, d))
        off += 4 * n * d
        st = np.memmap(path, dtype=np.float32, mode="r", offset=off,
                       shape=(n, sd))
        return keys, ok, vals, st

    # -- public --------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._index)

    def contains_bulk(self, keys: np.ndarray) -> np.ndarray:
        """bool[N]: key has a live disk entry.  Bloom-gated — an
        all-new-keys probe costs one vectorized filter pass and never
        touches the index."""
        keys = np.ascontiguousarray(keys, np.uint64)
        out = np.zeros(keys.size, bool)
        if not keys.size:
            return out
        maybe = self._bloom_probe(keys)
        if maybe.any():
            _c, _r, found = self._index.get_bulk(keys[maybe])
            out[np.flatnonzero(maybe)] = found
        return out

    def evict_cold(self, show_threshold: Optional[float] = None) -> int:
        """Move features below the show threshold from memory to disk (the
        shrink-to-SSD path; ref ShrinkTable + SSD flush). Keys staged by
        the OPEN feed pass (``live_keys_fn``) are skipped: their spilled
        copy would be restaged/superseded immediately. Returns count."""
        t = self.table
        thr = (show_threshold if show_threshold is not None
               else t.conf.delete_threshold)
        if self.demote_fence_fn is not None:
            # before t._lock: the deferred import the fence joins takes
            # that lock itself (lock order _lock -> tier locks holds)
            self.demote_fence_fn()
        live = self.live_keys_fn() if self.live_keys_fn is not None \
            else None
        with t._lock:
            n = t._size
            if not n:
                return 0
            cold = t._values[:n, 0] < thr
            if not cold.any():
                return 0
            keys = t._index.dump_keys(n)
            if live is not None and np.asarray(live).size:
                cold &= ~np.isin(keys, live)
            n_cold = int(cold.sum())
            if not n_cold:
                return 0
            rows = np.flatnonzero(cold)
            # the spill's fresh chunk registers itself with the
            # allocation watermark + in-flight-write set, so a
            # concurrent compact's garbage collection cannot touch it
            # (the old coarse _io_lock serialization is gone).  Lock
            # order is t._lock -> tier locks everywhere; nothing
            # acquires them in reverse.
            self._write_chunk(keys[rows], t._values[rows],
                              t._state[rows], t._embedx_ok[rows])
            # compact memory in place, dropping exactly the spilled rows
            keep = ~cold
            kept = int(keep.sum())
            t._values[:kept] = t._values[:n][keep]
            t._state[:kept] = t._state[:n][keep]
            t._embedx_ok[:kept] = t._embedx_ok[:n][keep]
            t._dirty[:kept] = t._dirty[:n][keep]
            t._values[kept:n] = 0.0
            t._embedx_ok[kept:n] = False
            t._dirty[kept:n] = False
            t._index.rebuild(keys[keep])
            t._size = kept
        return n_cold

    def mark_spills(self) -> None:
        """Start journaling spilled keys (one outstanding mark — the
        prefetch singleton): ``spilled_since_mark`` later answers "what
        moved to disk since my export?" without walking the index."""
        with self._mark_lock:
            self._spill_log = []
            self._marking = True

    def spilled_since_mark(self) -> np.ndarray:
        """Keys spilled since ``mark_spills``; clears the mark."""
        with self._mark_lock:
            out = (np.concatenate(self._spill_log) if self._spill_log
                   else np.empty(0, np.uint64))
            self._marking = False
            self._spill_log = []
        return np.unique(out)

    def stage(self, keys: np.ndarray) -> int:
        """Bring any disk-resident keys of the coming pass back into memory
        (ref BeginFeedPass SSD->mem staging). Returns rows restored.

        A key evicted then re-created in memory is restored only while its
        in-memory row is still untrained (show == 0, i.e. fresh feed_pass /
        pull(create=True) random init); once a push has trained the row
        (show > 0) memory is fresher and the stale disk snapshot is dropped
        instead of clobbering it."""
        t0 = time.perf_counter()
        try:
            ks, vals, st, ok, meta = self.read_rows(keys)
            if not ks.size:
                return 0
            stale = self.consume_read(ks, vals, st, ok, meta)
            return int(ks.size - stale.size)
        finally:
            REGISTRY.observe("ps.disk.stage_ms",
                             (time.perf_counter() - t0) * 1e3)

    def read_rows(self, keys: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                             np.ndarray, np.ndarray]:
        """Gather disk-resident rows WITHOUT mutating the table or the
        tier index — the overlap half of prefetch staging: the chunk-log
        reads ride a background thread while the current pass trains;
        ``consume_read`` later does the insert + index drop at the pass
        boundary. Returns (keys_sorted, vals, state, embedx_ok,
        meta[N, 2]) where meta holds each key's (chunk, row) snapshot —
        consume compares it against the live index so a NEWER spill
        written mid-prefetch is never clobbered by this read.

        Keys the bloom filter denies — the whole pass, on cold all-new
        traffic — return without touching the index.  Chunks are pinned
        through refcounted guards while gathered, so a concurrent
        ``compact()`` retiring them defers file deletion; losing the
        pin race just re-resolves through the already-swapped index."""
        keys = np.unique(np.ascontiguousarray(keys, dtype=np.uint64))
        if keys.size:
            keys = keys[self._bloom_probe(keys)]
        if not keys.size:
            return self._no_rows()
        with trace.span("ps.ssd.read_rows", n=int(keys.size)):
            return self._read_resolved(keys)

    def _no_rows(self):
        d = self.table.dim
        sd = self.table._state.shape[1]
        return (np.empty(0, np.uint64), np.empty((0, d), np.float32),
                np.empty((0, sd), np.float32), np.empty(0, bool),
                np.empty((0, 2), np.int64))

    def _read_resolved(self, keys: np.ndarray):
        ks_l, vals_l, st_l, ok_l, meta_l = [], [], [], [], []
        pending = keys
        stall_t0 = None
        for attempt in range(16):
            if not pending.size:
                break
            cids, rows, found = self._index.get_bulk(pending)
            if not found.any():
                break
            fk, fc, fr = pending[found], cids[found], rows[found]
            order = np.argsort(fc, kind="stable")
            fk, fc, fr = fk[order], fc[order], fr[order]
            uc, starts = np.unique(fc, return_index=True)
            bounds = np.append(starts, fc.size)
            retry = []
            for ci, cid in enumerate(uc):
                sl = slice(int(bounds[ci]), int(bounds[ci + 1]))
                cid = int(cid)
                if not self._guards.acquire(cid):
                    # chunk retired mid-resolution: the compaction that
                    # retired it already swapped the index — re-resolve
                    retry.append(fk[sl])
                    if stall_t0 is None:
                        stall_t0 = time.perf_counter()
                    continue
                try:
                    rs = fr[sl]
                    # row-gather straight off the map: only touched
                    # pages read. The timer covers ONLY this disk read —
                    # table insertion at consume is DRAM/hash cost, not
                    # tier bandwidth
                    io_point("ssd.read")
                    t0 = time.perf_counter()
                    _k, okm, valsm, stm = self._map_chunk(cid)
                    vals = np.asarray(valsm[rs])
                    st = np.asarray(stm[rs])
                    ok = np.asarray(okm[rs]).astype(bool)
                finally:
                    self._guards.release(cid)
                stage_s = time.perf_counter() - t0
                stage_b = vals.nbytes + st.nbytes + ok.size
                with self._stats_lock:
                    self.io_stats["stage_seconds"] += stage_s
                    self.io_stats["stage_bytes"] += stage_b
                REGISTRY.add("ps.ssd.stage_bytes", stage_b)
                REGISTRY.observe("ps.ssd.stage_chunk_ms", stage_s * 1e3)
                ks_l.append(fk[sl])
                vals_l.append(vals)
                st_l.append(st)
                ok_l.append(ok)
                meta_l.append(np.stack(
                    [np.full(rs.size, cid, np.int64), rs], axis=1))
            pending = (np.concatenate(retry) if retry
                       else np.empty(0, np.uint64))
        else:
            # attempts exhausted — but only an actually-unresolved
            # remainder is an error: a final attempt that pinned and
            # read everything leaves pending empty and succeeded
            if pending.size:
                raise RuntimeError(
                    "read_rows could not pin chunks after "
                    f"{attempt + 1} compactions "
                    f"({pending.size} keys left)")
        if stall_t0 is not None:
            REGISTRY.observe("ps.disk.compact_stall_ms",
                             (time.perf_counter() - stall_t0) * 1e3)
        if not ks_l:
            return self._no_rows()
        ks = np.concatenate(ks_l)
        order = np.argsort(ks)
        return (ks[order], np.concatenate(vals_l)[order],
                np.concatenate(st_l)[order], np.concatenate(ok_l)[order],
                np.concatenate(meta_l)[order])

    def consume_read(self, keys: np.ndarray, vals: np.ndarray,
                     st: np.ndarray, ok: np.ndarray,
                     meta: np.ndarray) -> np.ndarray:
        """Second half of (prefetch) staging: insert ``read_rows``
        buffers into the table and drop them from the tier. Two
        freshness guards, both favoring the newer copy:

        - trained-guard (same as the old synchronous stage): a memory
          row that TRAINED since the spill wins; the stale disk snapshot
          is dropped.
        - snapshot-guard: an index entry that CHANGED since the read
          (a newer spill landed mid-prefetch) wins; the newer chunk is
          staged fresh instead of the read buffers.

        Returns the keys whose buffered values are NOT what the table
        now holds (the caller re-exports those)."""
        if not keys.size:
            return keys
        cids, rows, found = self._index.get_bulk(keys)
        cur_cid = np.where(found, cids, -1)
        cur_row = np.where(found, rows, -1)
        changed = (cur_cid != meta[:, 0]) | (cur_row != meta[:, 1])
        changed_keys = keys[changed]
        if changed.any():
            keep = ~changed
            keys, vals, st, ok = (keys[keep], vals[keep], st[keep],
                                  ok[keep])
            # stage the newer entries (guard + index drop inside); gone
            # entries (already staged back by someone else) no-op
            self.stage(changed_keys)
            if not keys.size:
                return changed_keys
        t = self.table
        with t._lock:
            mem_rows, _ = t._index.lookup(keys, False, True, 0)
            trained = np.zeros(keys.size, dtype=bool)
            present = mem_rows >= 0
            if present.any():
                trained[present] = t._values[mem_rows[present], 0] > 0.0
        # staged OR superseded: either way these entries leave the tier
        # (bloom bits stay behind as harmless false positives until the
        # next compact/resume rebuild)
        self._index.delete_bulk(keys)
        dropped = keys[trained]
        if trained.any():
            keep = ~trained
            keys, vals, st, ok = (keys[keep], vals[keep], st[keep],
                                  ok[keep])
        if keys.size:
            # insert span timed apart so BOTH the disk read and the
            # composed "working set ready" latency are reportable (the
            # reference's BeginFeedPass bounds the composed number)
            t0 = time.perf_counter()
            with t._lock:
                trows = t._lookup(keys, create=True)
                t._values[trows] = vals
                t._state[trows] = st
                t._embedx_ok[trows] = ok
            with self._stats_lock:
                self.io_stats["stage_insert_seconds"] += \
                    time.perf_counter() - t0
        return np.concatenate([dropped, changed_keys])

    def compact(self) -> None:
        """Rewrite live entries into one fresh chunk, drop superseded
        data, rebuild the bloom filter — WITHOUT stalling readers.

        Copy-then-atomic-swap: live rows are copied into a new chunk
        (committed via the ckpt.atomic protocol), the index entries that
        still match their snapshot location are CAS-swapped to it
        (``_DiskIndex.replace_where`` — a newer mid-compact spill keeps
        its newer location), and the old chunks are RETIRED through the
        per-chunk guards: any in-flight ``read_rows`` holding a pin
        finishes against the old file, which is deleted at its last
        release.  ``evict_cold`` spills land in fresh chunks above the
        compaction's allocation watermark and are never touched."""
        with self._compact_lock, trace.span("ps.ssd.compact"):
            self._compact_impl()
        REGISTRY.add("ps.ssd.compactions")

    def _compact_impl(self) -> None:
        io_point("ssd.compact")
        # allocation watermark + in-flight writes FIRST: any spill
        # completing after this snapshot either has cid >= wm or was in
        # ``writing`` — both excluded from retirement below
        with self._alloc_lock:
            wm = self._next_chunk
            writing = set(self._writing)
        lkeys, lcids, lrows = self._index.live_items()
        if lkeys.size:
            order = np.argsort(lcids, kind="stable")
            lkeys, lcids, lrows = (lkeys[order], lcids[order],
                                   lrows[order])
            uc, starts = np.unique(lcids, return_index=True)
            bounds = np.append(starts, lcids.size)
            keys_l, vals_l, st_l, ok_l = [], [], [], []
            for ci, cid in enumerate(uc):
                sl = slice(int(bounds[ci]), int(bounds[ci + 1]))
                rs = lrows[sl]
                cid = int(cid)
                if not self._guards.acquire(cid):
                    # only a previous compact retires chunks and we hold
                    # _compact_lock — a dead cid cannot be referenced
                    raise RuntimeError(
                        f"live index references retired chunk {cid}")
                try:
                    _k, okm, valsm, stm = self._map_chunk(cid)
                    keys_l.append(lkeys[sl])
                    vals_l.append(np.asarray(valsm[rs]))
                    st_l.append(np.asarray(stm[rs]))
                    ok_l.append(np.asarray(okm[rs]).astype(bool))
                finally:
                    self._guards.release(cid)
            new_cid = self._alloc_cid()
            try:
                nkeys = np.concatenate(keys_l)
                nrows = np.arange(nkeys.size, dtype=np.int64)
                self._write_chunk_file(new_cid, nkeys,
                                       np.concatenate(vals_l),
                                       np.concatenate(st_l),
                                       np.concatenate(ok_l), atomic=True)
                # atomic swap: entries unchanged since the snapshot move
                # to the new chunk; changed/vanished entries (newer
                # spill, concurrent consume) keep their state — their
                # copied rows in the new chunk are dead weight reclaimed
                # by the NEXT compact
                self._index.replace_where(nkeys, lcids, lrows, new_cid,
                                          nrows)
            finally:
                self._end_write(new_cid)
        self._rebuild_bloom()
        # retire everything below the watermark that was not mid-write:
        # after the swap no index entry references these chunks; readers
        # still pinning them defer the file deletion to their release
        for cid in self._disk_cids():
            if cid < wm and cid not in writing:
                self._guards.retire(cid, self._chunk_path(cid))

    def disk_bytes(self) -> int:
        return sum(os.path.getsize(os.path.join(self.root, f))
                   for f in os.listdir(self.root))

    def bandwidth(self) -> Dict[str, float]:
        """Measured spill/stage MB/s since construction (0 when unused).
        ``stage_composed_mb_per_s`` divides by read + table-insert time —
        the end-to-end "pass working set ready" rate that the reference's
        BeginFeedPass actually bounds; ``stage_mb_per_s`` remains the
        disk-read-only tier bandwidth."""
        with self._stats_lock:
            s = dict(self.io_stats)
        composed = s["stage_seconds"] + s["stage_insert_seconds"]
        return {
            "spill_mb_per_s": (s["spill_bytes"] / 2**20
                               / s["spill_seconds"]
                               if s["spill_seconds"] else 0.0),
            "stage_mb_per_s": (s["stage_bytes"] / 2**20
                               / s["stage_seconds"]
                               if s["stage_seconds"] else 0.0),
            "stage_composed_mb_per_s": (s["stage_bytes"] / 2**20
                                        / composed if composed else 0.0),
            "stage_insert_seconds": round(s["stage_insert_seconds"], 3),
        }
