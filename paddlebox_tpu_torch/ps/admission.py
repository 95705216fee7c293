"""Frequency-based feature admission — the reference's show/click
thresholds for the beyond-HBM tier (a copy of
``paddlebox_tpu/ps/admission.py``: the same sketch, hash and decay, so
both packages make the same decisions).

The source system only gives a feature a parameter slot once its show
count crosses a threshold (CTR feature admission; PAPER.md "100 billions
of features"): the long tail of one-shot ad/user ids — most of every
streaming pass — never earns HBM arena rows, hashtable inserts, spill
chunks or eviction churn.  Until admitted, a key trains against the
shared null row (row 0: pulls zeros, pushes dropped — the padding-key
contract the table already has), so the step function is oblivious.

The candidate buffer is a count-min sketch, not a hashtable: unadmitted
keys are exactly the keys we refuse to spend per-key state on, so their
show counts live in a fixed O(MB) array with per-pass decay
(``ps_admit_decay``).  Count-min never under-counts, so a key that truly
crossed ``ps_admit_shows`` is always admitted; over-counts (hash
collisions) admit a few keys early — the benign direction.

The sketch is BLOCKED, the same cache discipline as ps/bloom.py: all
``depth`` cells of a key live in one 64-byte block (16 f32 cells) picked
by the block hash, at in-block offsets from an odd-stride hash (odd is
coprime to 16, so a key's cells never alias).  A classic count-min
gathers ``depth`` independent rows — 4+ random cache lines per key over
a sketch that can be 100s of MB — which made the observe pass
memory-bound; the blocked layout touches ~1 line per key.  The price is
correlated rows (all cells share a block), slightly raising the
overcount rate at equal size — the benign direction again, bounded in
the tests.

Decay is LAZY: ``advance_epoch`` is O(1) and each cell remembers the
epoch it was last touched; reads age the cell virtually by
``decay^(epoch - cell_epoch)``.  That makes estimates a pure function of
(sketch contents, epoch), which is what lets ``prefetch_feed_pass``
predict the NEXT pass's admission (estimate at epoch+1, no observation)
while ``begin_feed_pass`` keeps the one authoritative observe-per-pass —
the prediction is always a subset of the decision, so a stale guess can
only under-stage (topped up at consume), never create a key early.

Admission is OFF by default (``ps_admit_shows=0``): every key is
admitted immediately, which is bit-for-bit the pre-admission behavior.
The flags are the reference's environment variables
(``PBOX_FLAGS_ps_admit_shows``, ``_decay``, ``_width``), read at each
``from_flags``. ``admit_pass_keys`` counts its decisions into the global
registry as ``ps.disk.admit_admitted`` and ``ps.disk.admit_rejected``, as
the reference's does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from paddlebox_tpu_torch.config import env_flag
from paddlebox_tpu_torch.obs.metrics import REGISTRY
from paddlebox_tpu_torch.ps.bloom import _mix

# the reference's flag defaults
ADMIT_SHOWS, ADMIT_DECAY, ADMIT_WIDTH = 0.0, 1.0, 1 << 18

_BLOCK_CELLS = 16          # 16 x f32 = one 64-byte cache line


class CountMinAdmission:
    """Blocked count-min candidate buffer + threshold gate.

    ``observe_and_admit(keys, shows)`` adds each key's show count to the
    sketch and returns the admit mask (estimate >= threshold) — called
    once per feed pass with the pass's unique keys and occurrence
    counts.  ``admitted(keys)`` is the read-only probe (mid-pass gate;
    ``epoch_ahead=1`` for prefetch prediction).  ``advance_epoch()`` is
    the per-pass decay tick; cells age lazily via a per-BLOCK epoch.

    ``depth`` defaults to 2: inside one cache line the rows are
    correlated (they share the block), so extra rows buy far less
    accuracy than in a classic sketch while costing a full gather +
    scatter-add each — width is the operative accuracy knob, and the
    failure direction of a lost collision (early admit) is benign."""

    def __init__(self, threshold: float, decay: float = 1.0,
                 width: int = 1 << 18, depth: int = 2):
        if threshold <= 0:
            raise ValueError(f"admission threshold must be > 0: "
                             f"{threshold}")
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"ps_admit_decay must be in (0, 1]: {decay}")
        if depth < 1 or depth > _BLOCK_CELLS // 2:
            raise ValueError(
                f"depth must be 1..{_BLOCK_CELLS // 2}: {depth}")
        self.threshold = float(threshold)
        self.decay_factor = float(decay)
        self.width = int(width)
        self.depth = int(depth)
        self.epoch = 0
        # width * depth total cells, grouped into cache-line blocks
        self.n_blocks = max(1, (self.width * self.depth) // _BLOCK_CELLS)
        self._counts = np.zeros(self.n_blocks * _BLOCK_CELLS, np.float32)
        # epoch each BLOCK was last brought current (lazy decay); one
        # epoch per line instead of per cell keeps the aging metadata
        # inside the same cache traffic as the counts
        self._block_epoch = np.zeros(self.n_blocks, np.int32)

    def _cells(self, keys: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(blocks[N], offs[depth, N]): each key's block plus its
        ``depth`` flat cell offsets inside that block.  The in-block
        stride is odd — coprime to the block size, so a key's cells
        never alias each other."""
        keys = np.ascontiguousarray(keys, np.uint64)
        # Lemire multiply-shift instead of u64 modulo (numpy's u64 div
        # has no SIMD path and dominates the hash cost at volume)
        b = (((_mix(keys, 11) >> np.uint64(32))
              * np.uint64(self.n_blocks)) >> np.uint64(32)).astype(
                  np.int64)
        h2 = _mix(keys, 12)
        h3 = _mix(keys, 13) | np.uint64(1)
        # one broadcast over [depth, N] instead of a python loop per row
        d_col = np.arange(self.depth, dtype=np.uint64)[:, None]
        cells = (h2[None, :] + d_col * h3[None, :]) \
            & np.uint64(_BLOCK_CELLS - 1)       # power-of-2 block
        offs = (b * _BLOCK_CELLS)[None, :] + cells.astype(np.int64)
        return b, offs

    def _decay_pow(self, age: np.ndarray) -> np.ndarray:
        return np.power(np.float32(self.decay_factor),
                        age.astype(np.float32))

    def _bring_current(self, blocks: np.ndarray, epoch: int) -> None:
        """Age every touched block to ``epoch`` in place (the write half
        of lazy decay; a no-op for already-current or empty blocks)."""
        if self.decay_factor >= 1.0:
            return
        ub = np.unique(blocks)
        age = epoch - self._block_epoch[ub]
        stale = age > 0
        if stale.any():
            sb = ub[stale]
            view = self._counts.reshape(self.n_blocks, _BLOCK_CELLS)
            view[sb] *= self._decay_pow(age[stale])[:, None]
        # never REGRESS a block's epoch: a prior at_epoch observe may
        # have pinned it to a future pass already — stamping it back
        # would decay those counts a second time when the real epoch
        # catches up (an undercount, the direction admission must
        # never err in)
        self._block_epoch[ub] = np.maximum(self._block_epoch[ub], epoch)

    def estimate(self, keys: np.ndarray,
                 epoch_ahead: int = 0) -> np.ndarray:
        """float32[N] count-min estimates at ``epoch + epoch_ahead``
        (never an undercount of the true decayed show total).  Read-only:
        blocks age VIRTUALLY — all of a key's cells share one block
        epoch, so min-over-cells commutes with the aging multiply."""
        if not keys.size:
            return np.zeros(0, np.float32)
        blocks, offs = self._cells(keys)
        est = self._counts[offs[0]]
        for d in range(1, self.depth):
            est = np.minimum(est, self._counts[offs[d]])
        if self.decay_factor < 1.0:
            e = self.epoch + int(epoch_ahead)
            nz = est != 0
            if nz.any():
                # clamped at 0: a block an off-step observe already
                # brought current for the NEXT pass must not be
                # decay-amplified by a reader still at this epoch
                age = np.maximum(e - self._block_epoch[blocks[nz]], 0)
                est[nz] *= self._decay_pow(age)
        return est

    def observe_and_admit(self, keys: np.ndarray, shows: np.ndarray,
                          at_epoch: Optional[int] = None) -> np.ndarray:
        """Add ``shows[i]`` to key i's counters, return admit mask.
        ``keys`` must be unique (pass-level np.unique output).

        ``at_epoch`` lets an OFF-STEP observe (the tier worker deciding
        the next pass during the current one, tiered_table.py) make the
        exact decision the synchronous path would make at that future
        epoch: blocks are aged to ``at_epoch`` before the adds, so the
        result is bit-identical to observing after the intervening
        ``advance_epoch`` ticks."""
        if not keys.size:
            return np.zeros(0, bool)
        e = self.epoch if at_epoch is None else int(at_epoch)
        shows = np.asarray(shows, np.float32)
        blocks, offs = self._cells(keys)
        # bring touched blocks current FIRST (idempotent under block
        # collisions), then accumulate: keys are unique but blocks/cells
        # can collide across keys — add.at accumulates, the count-min
        # overestimate, which only ever admits early
        self._bring_current(blocks, e)
        est: Optional[np.ndarray] = None
        for d in range(self.depth):
            np.add.at(self._counts, offs[d], shows)
        for d in range(self.depth):
            # post-add reads ARE the estimates: the blocks are current
            cur = self._counts[offs[d]]
            est = cur if est is None else np.minimum(est, cur)
        return est >= self.threshold

    def admitted(self, keys: np.ndarray,
                 epoch_ahead: int = 0) -> np.ndarray:
        """Read-only admit mask (mid-pass gate, prefetch prediction)."""
        return self.estimate(keys, epoch_ahead) >= self.threshold

    def advance_epoch(self) -> None:
        """Per-pass decay tick — O(1), blocks age lazily on next touch."""
        self.epoch += 1

    def memory_bytes(self) -> int:
        return int(self._counts.nbytes + self._block_epoch.nbytes)


#: Sentinel for table constructors: ``admit=DISABLED`` means "no
#: admission, regardless of the ps_admit_* flags" (admit=None defers to
#: the flags) — bit-identity baselines and benches need the guarantee
#: without reaching into private table state.
DISABLED = object()


def known_keys(uniq: np.ndarray, backing, disk) -> np.ndarray:
    """bool[N]: key already earned a slot (backing or disk row) — THE
    membership composition shared by the pass-boundary decision
    (``admit_pass_keys``) and the mid-pass gate
    (``TieredDeviceTable._known_keys``)."""
    known = backing.contains_bulk(uniq)
    fresh = ~known
    if disk is not None and fresh.any():
        on_disk = disk.contains_bulk(uniq[fresh])
        known[np.flatnonzero(fresh)[on_disk]] = True
    return known


def resolve(admit) -> Optional[CountMinAdmission]:
    """Constructor-arg resolution: None -> flags, DISABLED -> off,
    instance -> itself."""
    if admit is DISABLED:
        return None
    return admit if admit is not None else from_flags()


def from_flags() -> Optional[CountMinAdmission]:
    """Admission instance per the ``ps_admit_*`` flags, or None when
    disabled (``ps_admit_shows <= 0`` — every key admits immediately)."""
    thr = float(env_flag("ps_admit_shows", ADMIT_SHOWS))
    if thr <= 0:
        return None
    return CountMinAdmission(
        thr, decay=float(env_flag("ps_admit_decay", ADMIT_DECAY)),
        width=int(env_flag("ps_admit_width", ADMIT_WIDTH)))


def admit_pass_keys(uniq: np.ndarray, counts: np.ndarray, backing,
                    disk, sketch: CountMinAdmission,
                    at_epoch: Optional[int] = None
                    ) -> Tuple[np.ndarray, int, int]:
    """The feed-pass admission decision of the tiered table.

    ``uniq``/``counts`` are the pass's unique keys and occurrence counts
    (one occurrence = one show).  Keys the backing table or the disk
    tier already hold earned their slot in an earlier pass and stage
    unconditionally; only brand-new keys go through the sketch.  Returns
    (admitted_uniq, n_admitted_new, n_rejected)."""
    known = known_keys(uniq, backing, disk)
    fresh = ~known
    if not fresh.any():
        return uniq, 0, 0
    ok = sketch.observe_and_admit(uniq[fresh], counts[fresh],
                                  at_epoch=at_epoch)
    n_adm, n_rej = int(ok.sum()), int((~ok).sum())
    REGISTRY.add("ps.disk.admit_admitted", n_adm)
    REGISTRY.add("ps.disk.admit_rejected", n_rej)
    if n_rej == 0:
        return uniq, n_adm, 0
    keep = known.copy()
    keep[np.flatnonzero(fresh)[ok]] = True
    return uniq[keep], n_adm, n_rej
