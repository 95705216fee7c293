"""Blocked bloom filter over u64 feature keys — the existence filter in
front of the disk tier's key index (a copy of
``paddlebox_tpu/ps/bloom.py``: the same hash, numpy's uint64 wraparound
included, so the same keys set the same bits in both packages).

The cold path's defining property is that almost every probe MISSES: a
streaming CTR pass brings ad/user ids the table has never seen, and the
old path paid a full ``_DiskIndex`` probe (native hashtable walk under a
lock) per key just to learn "not on disk".  A bloom filter answers the
same question with a handful of vectorized gathers against a bit array
that fits in cache — and it can never answer a false "absent", so the
disk tier stays lossless: a negative skips the index entirely, a
positive (rare false positives included) falls through to the real
probe.

Blocked layout (Putze/Sanders/Singler "Cache-, Hash- and Space-Efficient
Bloom Filters"): each key hashes to ONE 512-bit block (8 u64 words, a
cache line) and sets/tests its k bits inside that block, so a query
touches one line instead of k random ones.  All operations are
numpy-vectorized over key arrays; there is no per-key python.

Deletions are not supported (the tier's ``delete_bulk`` leaves stale
bits behind, which only ever ADDS false positives); the owner rebuilds
the filter from the live index at compact/load, which is also when the
filter resizes to the live population.
"""

from __future__ import annotations

import numpy as np

_BLOCK_WORDS = 8            # 8 x 64 = 512-bit blocks (one cache line)
_BLOCK_BITS = _BLOCK_WORDS * 64

# splitmix64 constants — same mixer family as ps/table.key_init_uniform
_C1 = np.uint64(0x9E3779B97F4A7C15)
_C2 = np.uint64(0xBF58476D1CE4E5B9)
_C3 = np.uint64(0x94D049BB133111EB)


def _mix(x: np.ndarray, salt: int) -> np.ndarray:
    """splitmix64 finalizer over u64 keys (vectorized, wraps silently)."""
    x = x + np.uint64((salt * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF)
    x = (x ^ (x >> np.uint64(30))) * _C2
    x = (x ^ (x >> np.uint64(27))) * _C3
    return x ^ (x >> np.uint64(31))


class BlockedBloom:
    """Fixed-size blocked bloom filter for ``capacity`` expected keys at
    ``bits_per_key`` bits each.  ``add_bulk`` is append-only; rebuild by
    constructing a fresh filter (cheap: one allocation + one add_bulk).

    No false negatives, ever: every bit ``add_bulk`` sets is tested by
    ``contains_bulk`` with the same hash chain."""

    def __init__(self, capacity: int, bits_per_key: int = 10):
        if bits_per_key < 1:
            raise ValueError(f"bits_per_key must be >= 1: {bits_per_key}")
        capacity = max(int(capacity), 1)
        self.bits_per_key = int(bits_per_key)
        # k = ln2 * bits/key is FP-optimal for a classic bloom, but each
        # probe is a gather+mask over the whole key array — cap at 4:
        # at 10 bits/key that trades ~0.8% -> ~1.5% false positives
        # (every one just falls through to the real index probe, still
        # bounded by the tests) for nearly half the probe cost on the
        # all-miss cold path this filter exists for
        self.k = max(1, min(4, int(round(0.693 * bits_per_key))))
        n_blocks = max(1, -(-capacity * bits_per_key // _BLOCK_BITS))
        self.n_blocks = int(n_blocks)
        self.capacity = capacity
        self._words = np.zeros(self.n_blocks * _BLOCK_WORDS, np.uint64)
        self.n_added = 0

    def _addr(self, keys: np.ndarray):
        """(word_idx[k, N], mask[k, N]) for each key's k bits in its
        block."""
        keys = np.ascontiguousarray(keys, np.uint64)
        h1 = _mix(keys, 1)
        # Lemire multiply-shift instead of u64 modulo (no SIMD division
        # in numpy); the block size itself is a power of two, so the
        # in-block bit index is a mask
        block = (((h1 >> np.uint64(32)) * np.uint64(self.n_blocks))
                 >> np.uint64(32)) * np.uint64(_BLOCK_WORDS)
        h2 = _mix(keys, 2)
        h3 = _mix(keys, 3) | np.uint64(1)       # odd stride: full cycle
        widx = np.empty((self.k, keys.size), np.int64)
        mask = np.empty((self.k, keys.size), np.uint64)
        bmask = np.uint64(_BLOCK_BITS - 1)
        for i in range(self.k):
            bit = (h2 + np.uint64(i) * h3) & bmask
            widx[i] = (block + (bit >> np.uint64(6))).astype(np.int64)
            mask[i] = np.uint64(1) << (bit & np.uint64(63))
        return widx, mask

    def add_bulk(self, keys: np.ndarray) -> None:
        keys = np.ascontiguousarray(keys, np.uint64)
        if not keys.size:
            return
        widx, mask = self._addr(keys)
        np.bitwise_or.at(self._words, widx.ravel(), mask.ravel())
        self.n_added += int(keys.size)

    def contains_bulk(self, keys: np.ndarray) -> np.ndarray:
        """bool[N]: False = definitely absent; True = probably present."""
        keys = np.ascontiguousarray(keys, np.uint64)
        if not keys.size:
            return np.zeros(0, bool)
        widx, mask = self._addr(keys)
        hit = (self._words[widx[0]] & mask[0]) == mask[0]
        for i in range(1, self.k):
            hit &= (self._words[widx[i]] & mask[i]) == mask[i]
        return hit

    @property
    def saturated(self) -> bool:
        """True once more keys were added than the filter was sized for —
        false-positive rate is degrading; the owner should rebuild at the
        next compact/load."""
        return self.n_added > self.capacity

    def memory_bytes(self) -> int:
        return int(self._words.nbytes)
