"""Instance data model (counterpart of ``paddlebox_tpu/data/record.py``).

One training instance: per-slot uint64 feature ids and float values in CSR
form, the label, and the fields a logkey or an instance id carries
(search_id, cmatch, rank, ins_id). Records are allocated plainly: the
reference's ``SlotRecordPool`` free list is not ported, nor are
``merge_by_insid`` and ``replace_sparse_slots`` (ROADMAP A.2d).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


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
