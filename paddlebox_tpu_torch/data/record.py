"""Instance data model (counterpart of ``paddlebox_tpu/data/record.py``).

One training instance: per-slot uint64 feature ids and float values in CSR
form, the label, and the fields a logkey or an instance id carries
(search_id, cmatch, rank, ins_id). Records are recycled through
``SlotRecordPool`` (``GLOBAL_POOL``); ``merge_by_insid`` joins the parts
of one instance, ``replace_sparse_slots`` swaps a record's sparse slots.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import numpy as np

from paddlebox_tpu_torch.config import env_flag

# the reference's ``record_pool_max_size`` flag default
RECORD_POOL_MAX_SIZE = 2_000_000


class SlotRecord:
    __slots__ = ("uint64_feas", "uint64_offsets", "float_feas",
                 "float_offsets", "label", "search_id", "rank", "cmatch",
                 "ins_id")

    def __init__(self):
        # concatenated sparse ids for all sparse slots + CSR offsets [S+1]
        self.uint64_feas: Optional[np.ndarray] = None
        self.uint64_offsets: Optional[np.ndarray] = None
        # concatenated float values for all dense slots + CSR offsets [D+1]
        self.float_feas: Optional[np.ndarray] = None
        self.float_offsets: Optional[np.ndarray] = None
        self.label: float = 0.0
        self.search_id: int = 0
        self.rank: int = 0
        self.cmatch: int = 0
        self.ins_id: str = ""

    def slot_uint64(self, slot_idx: int) -> np.ndarray:
        o = self.uint64_offsets
        return self.uint64_feas[o[slot_idx]:o[slot_idx + 1]]

    def slot_float(self, slot_idx: int) -> np.ndarray:
        o = self.float_offsets
        return self.float_feas[o[slot_idx]:o[slot_idx + 1]]


def merge_by_insid(records: List["SlotRecord"], num_sparse: int,
                   num_float: int, merge_size: int = 2,
                   pool: "Optional[SlotRecordPool]" = None,
                   float_is_dense: "Optional[List[bool]]" = None
                   ) -> "Tuple[List[SlotRecord], int]":
    """Join the records that share an instance id into one (multi-part
    logs land as one record a part; training wants their union), with
    the reference's conflict rules: a group must have exactly
    ``merge_size`` parts (when > 0) or it is dropped; a sparse slot
    (every uint64 slot, and a float slot with ``is_dense=False``) present
    in two parts is a conflict that drops the group; a dense float slot
    never drops: the last part with a non-zero value wins, and an
    all-zero part claims the slot only while no part has. Label and
    logkey fields come from the first part. ``float_is_dense`` maps each
    float slot to its denseness (None: all dense). The parts, merged or
    dropped, go back to ``pool`` (the merged record holds copies).
    Returns (merged, dropped_instances)."""
    if float_is_dense is None:
        float_is_dense = [True] * num_float
    groups: dict = {}
    for r in records:
        groups.setdefault(r.ins_id, []).append(r)
    out: List[SlotRecord] = []
    recycle: List[SlotRecord] = []
    dropped = 0
    for ins_id, grp in groups.items():
        if merge_size > 0 and len(grp) != merge_size:
            dropped += len(grp)
            recycle.extend(grp)
            continue
        first = grp[0]
        if len(grp) == 1:
            out.append(first)
            continue
        u_vals: List[Optional[np.ndarray]] = [None] * num_sparse
        f_owner = [-1] * num_float
        conflict = False
        for pi, r in enumerate(grp):
            for s in range(num_sparse):
                v = r.slot_uint64(s)
                if v.size:
                    if u_vals[s] is not None:
                        conflict = True
                        break
                    u_vals[s] = v
            if conflict:
                break
            for s in range(num_float):
                v = r.slot_float(s)
                if not v.size:
                    continue
                if float_is_dense[s]:
                    nonzero = bool(np.any(np.abs(v) >= 1e-6))
                    if nonzero:
                        f_owner[s] = pi
                    elif f_owner[s] < 0:
                        f_owner[s] = pi
                elif f_owner[s] >= 0:
                    conflict = True
                    break
                else:
                    f_owner[s] = pi
            if conflict:
                break
        if conflict:
            dropped += len(grp)
            recycle.extend(grp)
            continue
        merged = SlotRecord()
        merged.ins_id = ins_id
        merged.label = first.label
        merged.search_id = first.search_id
        merged.rank = first.rank
        merged.cmatch = first.cmatch
        u_offs = np.zeros(num_sparse + 1, dtype=np.int64)
        flat_u: List[np.ndarray] = []
        total = 0
        for s in range(num_sparse):
            v = u_vals[s]
            if v is not None:
                flat_u.append(v)
                total += v.size
            u_offs[s + 1] = total
        merged.uint64_feas = (np.concatenate(flat_u) if flat_u
                              else np.empty(0, np.uint64))
        merged.uint64_offsets = u_offs
        f_offs = np.zeros(num_float + 1, dtype=np.int64)
        flat_f: List[np.ndarray] = []
        total = 0
        for s in range(num_float):
            if f_owner[s] >= 0:
                v = grp[f_owner[s]].slot_float(s)
                flat_f.append(v)
                total += v.size
            f_offs[s + 1] = total
        merged.float_feas = (np.concatenate(flat_f) if flat_f
                             else np.empty(0, np.float32))
        merged.float_offsets = f_offs
        out.append(merged)
        recycle.extend(grp)
    if pool is not None and recycle:
        pool.put(recycle)
    return out, dropped


def replace_sparse_slots(rec: SlotRecord,
                         repl: "dict[int, np.ndarray]") -> None:
    """Rebuild ``rec``'s sparse CSR arrays with the slots in ``repl``
    swapped for the given value arrays (lengths may change); what
    ``SlotDataset.slots_shuffle`` applies to each record."""
    n_slots = rec.uint64_offsets.size - 1
    parts: List[np.ndarray] = []
    offs = np.zeros(n_slots + 1, dtype=np.int64)
    total = 0
    for s in range(n_slots):
        v = repl.get(s)
        if v is None:
            v = rec.slot_uint64(s)
        if v.size:
            parts.append(v)
        total += v.size
        offs[s + 1] = total
    rec.uint64_feas = (np.concatenate(parts) if parts
                       else np.empty(0, dtype=np.uint64))
    rec.uint64_offsets = offs


class SlotRecordPool:
    """Free list recycling SlotRecords across passes (the reference's
    ``SlotRecordPool``); at most ``max_size`` records, else the
    ``record_pool_max_size`` flag's."""

    def __init__(self, max_size: Optional[int] = None):
        self._free: List[SlotRecord] = []
        self._lock = threading.Lock()
        self._max = (max_size if max_size is not None
                     else int(env_flag("record_pool_max_size",
                                       RECORD_POOL_MAX_SIZE)))

    def get(self, n: int = 1) -> List[SlotRecord]:
        with self._lock:
            take = min(n, len(self._free))
            out = self._free[len(self._free) - take:]
            del self._free[len(self._free) - take:]
        out.extend(SlotRecord() for _ in range(n - take))
        return out

    def put(self, records: List[SlotRecord]) -> None:
        for r in records:
            r.uint64_feas = r.float_feas = None
            r.uint64_offsets = r.float_offsets = None
            # scalars too: the parser only writes these fields when the feed
            # config asks for them, so stale values must not leak across reuse
            r.label = 0.0
            r.search_id = r.rank = r.cmatch = 0
            r.ins_id = ""
        with self._lock:
            room = self._max - len(self._free)
            if room > 0:
                self._free.extend(records[:room])

    def clear(self) -> None:
        with self._lock:
            self._free.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._free)


GLOBAL_POOL = SlotRecordPool()
