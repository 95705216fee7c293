"""Instance data model (counterpart of ``paddlebox_tpu/data/record.py``).

The subset of ``SlotRecord`` that ``BatchAssembler`` reads: per-slot uint64
feature ids and float values in CSR form, the label and the search id.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class SlotRecord:
    __slots__ = ("uint64_feas", "uint64_offsets", "float_feas",
                 "float_offsets", "label", "search_id")

    def __init__(self):
        # concatenated sparse ids for all sparse slots + CSR offsets [S+1]
        self.uint64_feas: Optional[np.ndarray] = None
        self.uint64_offsets: Optional[np.ndarray] = None
        # concatenated float values for all dense slots + CSR offsets [D+1]
        self.float_feas: Optional[np.ndarray] = None
        self.float_offsets: Optional[np.ndarray] = None
        self.label: float = 0.0
        self.search_id: int = 0
