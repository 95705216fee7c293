"""Replica-side caches (counterpart of ``paddlebox_tpu/ps/replica_cache.py``):
the device replica cache, the string-keyed input table, and the hot-key
embedding cache in front of a serving table.

- ``ReplicaCache`` (the reference's ``GpuReplicaCache``): append-only
  host rows, frozen by ``to_device`` into one [n, dim] float32 tensor on a
  device and pulled by row id (``pull``, an ``index_select``).
- ``InputTable``: string key -> row of side-input floats; a key it lacks
  maps to the zero row at offset 0.
- ``HotKeyCache``: a small per-replica cache of pulled rows, host numpy,
  open-addressed with a bounded probe window and window-local LRU
  eviction, versioned against the model it serves. CTR traffic is
  Zipf-distributed, so the cache answers the head and the table sees the
  tail. Its hash (``_mix64``), probe window, eviction, ``set_version`` and
  counters are the reference's, so the same lookups give the same counts.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch._device import DeviceLike, resolve_device


class ReplicaCache:
    """Append-only [n, dim] float32 rows, frozen to a device."""

    def __init__(self, dim: int):
        self.dim = int(dim)
        self._rows: List[np.ndarray] = []
        self._lock = threading.Lock()
        self._device: Optional[torch.Tensor] = None

    def add_items(self, emb) -> int:
        """Append one row; returns its id."""
        v = np.asarray(emb, dtype=np.float32).reshape(-1)
        if v.size != self.dim:
            raise ValueError(f"row has dim {v.size}, want {self.dim}")
        with self._lock:
            self._rows.append(v)
            self._device = None  # stale
            return len(self._rows) - 1

    def __len__(self) -> int:
        return len(self._rows)

    def to_device(self, device: DeviceLike = None) -> torch.Tensor:
        """The rows as one [n, dim] tensor on ``device`` (default ``cuda``),
        kept until the next ``add_items`` or another device; an empty cache
        freezes one zero row."""
        dev = resolve_device(device)
        with self._lock:
            if self._device is None or self._device.device != dev:
                host = (np.stack(self._rows) if self._rows
                        else np.zeros((1, self.dim), np.float32))
                self._device = torch.from_numpy(host).to(dev)
            return self._device

    @staticmethod
    def pull(cache: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Rows by id, on the cache's device."""
        return cache.index_select(0, ids.long())

    def memory_bytes(self) -> int:
        return len(self._rows) * self.dim * 4


class InputTable:
    """String key -> row of side-input floats; a missing key maps to the
    zero row at offset 0."""

    def __init__(self, dim: int):
        self.dim = int(dim)
        self._offsets: Dict[str, int] = {}
        self._rows: List[np.ndarray] = []
        self._lock = threading.Lock()
        self._miss = 0
        self._stacked: Optional[np.ndarray] = None
        self.add_index_data("-", np.zeros(dim, np.float32))

    def add_index_data(self, key: str, vec) -> None:
        v = np.asarray(vec, dtype=np.float32).reshape(-1)
        if v.size != self.dim:
            raise ValueError(f"row has dim {v.size}, want {self.dim}")
        with self._lock:
            self._offsets[key] = len(self._rows)
            self._rows.append(v)
            self._stacked = None  # the lookup cache is stale

    def get_index_offset(self, key: str) -> int:
        off = self._offsets.get(key)
        if off is None:
            with self._lock:  # parse pools call this from many threads
                self._miss += 1
            return 0
        return off

    def get_index_offsets(self, keys: Sequence[str]) -> np.ndarray:
        """Offsets of a batch of string keys (at feed time)."""
        return np.fromiter((self.get_index_offset(k) for k in keys),
                           dtype=np.int64, count=len(keys))

    def lookup_input(self, offsets: np.ndarray) -> np.ndarray:
        """Rows by offset; the stacked table is cached until the next
        ``add_index_data``, so a batch costs a gather of its rows."""
        with self._lock:
            if self._stacked is None:
                self._stacked = np.stack(self._rows)
            table = self._stacked
        return table[np.asarray(offsets, dtype=np.int64)]

    def to_device(self, device: DeviceLike = None) -> torch.Tensor:
        with self._lock:
            return torch.from_numpy(np.stack(self._rows)).to(
                resolve_device(device))

    @property
    def miss(self) -> int:
        return self._miss

    def __len__(self) -> int:
        return len(self._offsets)


def _mix64(keys: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over u64 keys (feature hashes may be
    low-entropy in the high bits; probe slots must not be)."""
    x = keys.astype(np.uint64, copy=True)
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xFF51AFD7ED558CCD)
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xC4CEB9FE1A85EC53)
    x ^= x >> np.uint64(33)
    return x


class HotKeyCache:
    """Per-replica LRU cache of pulled embedding rows.

    Open-addressed (power-of-two capacity, linear probing bounded by
    ``PROBES``) so the hot path — :meth:`lookup` over a whole batch of
    keys — is a handful of vectorized gathers with no per-key Python
    and no hashtable allocation.  Recency is a per-slot ``tick`` stamp
    advanced once per lookup; when an insert finds its probe window
    full, the least-recently-used slot IN THE WINDOW is evicted
    (window-local LRU: exact enough for a cache, and it keeps eviction
    O(PROBES) instead of a global scan).

    Version contract (the hot-reload invalidation): the cache carries
    the ``model_version`` of the table its rows came from;
    :meth:`set_version` with a different version CLEARS it atomically,
    so a swapped-in model can never serve a stale row.  The cache is
    internally locked: the batcher worker owns the pull-through hot
    path, but ``set_version`` (reload apply), ``drop`` (write-through
    invalidation from the PS client) and the stats/size probes arrive
    from other threads, so every method takes ``self._lock``.  The
    lock bounds a few vectorized numpy ops, never a pull.
    """

    PROBES = 4

    def __init__(self, rows: int, dim: int):
        if rows < 16:
            raise ValueError(f"HotKeyCache needs >= 16 rows, got {rows}")
        cap = 1
        while cap < rows:
            cap <<= 1
        self.capacity = cap
        self.dim = int(dim)
        self._lock = threading.Lock()
        self._mask = np.uint64(cap - 1)
        self._keys = np.zeros(cap, dtype=np.uint64)
        self._occ = np.zeros(cap, dtype=bool)
        self._vals = np.zeros((cap, dim), dtype=np.float32)
        self._stamp = np.zeros(cap, dtype=np.int64)
        self._tick = 0                       # guarded-by: _lock
        self._size = 0                       # guarded-by: _lock
        self._version: Optional[object] = None   # guarded-by: _lock
        self.hits = 0                        # guarded-by: _lock
        self.misses = 0                      # guarded-by: _lock
        self.evictions = 0                   # guarded-by: _lock

    # -- lifecycle -----------------------------------------------------------

    def clear(self) -> None:
        with self._lock:
            self._occ[:] = False
            self._size = 0

    def set_version(self, version) -> None:
        """Adopt the owning model version; a CHANGE invalidates every
        cached row (rows quantize/gate against one snapshot — serving
        a pass-N row under a pass-N+1 model is a silent skew bug)."""
        with self._lock:
            if version != self._version:
                self._occ[:] = False
                self._size = 0
                self._version = version

    @property
    def version(self):
        with self._lock:
            return self._version

    @property
    def size(self) -> int:
        """Occupied rows (<= capacity)."""
        with self._lock:
            return self._size

    def memory_bytes(self) -> int:
        with self._lock:
            return int(self._keys.nbytes + self._occ.nbytes +
                       self._vals.nbytes + self._stamp.nbytes)

    # -- hot path ------------------------------------------------------------

    def _probe(self, keys: np.ndarray) -> np.ndarray:
        """Slot per key, -1 for misses.  Vectorized probe rounds: every
        still-unresolved key advances one slot per round; a key is
        resolved by a key match (hit) or an empty slot (definitive
        miss — inserts never leapfrog an empty slot in their window)."""
        idx = (_mix64(keys) & self._mask).astype(np.int64)
        out = np.full(keys.size, -1, dtype=np.int64)
        pending = np.arange(keys.size)
        for _ in range(self.PROBES):
            slots = idx[pending]
            k_at = self._keys[slots]
            occ = self._occ[slots]
            found = occ & (k_at == keys[pending])
            out[pending[found]] = slots[found]
            done = found | ~occ
            pending = pending[~done]
            if not pending.size:
                break
            idx[pending] = (idx[pending] + 1) & np.int64(self._mask)
        return out

    def lookup(self, keys: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(values [N, dim], hit [N] bool); miss rows are zeros.  Hits
        refresh their recency stamp."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        with self._lock:
            self._tick += 1
            idx = self._probe(keys)
            hit = idx >= 0
            # one integer gather, then zero the (few) miss rows — much
            # cheaper than a boolean scatter of the (many) hit rows
            vals = self._vals[np.maximum(idx, 0)]
            n_hit = int(np.count_nonzero(hit))
            if n_hit < keys.size:
                vals[~hit] = 0.0
            if n_hit:
                self._stamp[idx[hit]] = self._tick
            self.hits += n_hit
            self.misses += int(keys.size - n_hit)
            return vals, hit

    def insert(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Install pulled rows (the miss half of a pull-through) — fully
        vectorized like :meth:`lookup`: every key probes its window for
        its own slot or an empty one; keys whose window is full evict
        the window's LRU slot.  Two keys racing for one slot in a batch
        collapse to the last write — the loser simply stays uncached
        and re-misses later, which is cache-correct by construction."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        vals = np.asarray(vals, dtype=np.float32)
        n = keys.size
        if not n:
            return
        with self._lock:
            cur = (_mix64(keys) & self._mask).astype(np.int64)
            target = np.full(n, -1, dtype=np.int64)
            vict = cur.copy()                     # window-LRU fallback
            vstamp = np.full(n, np.iinfo(np.int64).max)
            pending = np.arange(n)
            for _ in range(self.PROBES):
                slots = cur[pending]
                occ = self._occ[slots]
                done = ~occ | (self._keys[slots] == keys[pending])
                target[pending[done]] = slots[done]
                pending = pending[~done]
                if not pending.size:
                    break
                st = self._stamp[cur[pending]]
                older = st < vstamp[pending]
                upd = pending[older]
                vict[upd] = cur[upd]
                vstamp[upd] = st[older]
                cur[pending] = (cur[pending] + 1) & np.int64(self._mask)
            evicting = target < 0
            self.evictions += int(evicting.sum())
            target[evicting] = vict[evicting]
            if self._size < self.capacity:   # a full cache stays full
                newly = np.unique(target)
                self._size += int((~self._occ[newly]).sum())
            self._keys[target] = keys             # duplicate slots: last
            self._vals[target] = vals             # write wins (same key =
            self._occ[target] = True              # same pulled value)
            self._stamp[target] = self._tick

    def drop(self, keys: np.ndarray) -> int:
        """Invalidate specific keys (a write-through consumer — the
        remote-PS client — pushed new values for them server-side, so
        their cached rows are stale).  Returns slots dropped; absent
        keys are a no-op.

        Scans the FULL probe window of every key — it neither stops at
        the first match nor at an empty slot.  Dropping creates holes,
        and a later insert of the same key can land in its hole ahead
        of a surviving duplicate; clearing only the first match would
        leave that duplicate to resurface (and serve a stale row) once
        the earlier slot is reused by another key."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        if not keys.size:
            return 0
        with self._lock:
            idx = (_mix64(keys) & self._mask).astype(np.int64)
            dropped = 0
            for _ in range(self.PROBES):
                hit = self._occ[idx] & (self._keys[idx] == keys)
                slots = np.unique(idx[hit])
                self._occ[slots] = False
                dropped += int(slots.size)
                idx = (idx + 1) & np.int64(self._mask)
            self._size -= dropped
            return dropped

