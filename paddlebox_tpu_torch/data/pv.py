"""Page-view (PV) grouping and rank-offset batching (counterpart of
``paddlebox_tpu/data/pv.py``).

The records of one search page view (one ``search_id``) are one PV group;
batches hold whole PVs (``pv_batch_size`` of them), so each instance's
same-page neighbors are in its batch and the ``rank_offset`` row indices
that ``ops.ctr_ops.rank_attention`` reads stay batch-local.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch.config import BucketSpec, DataFeedConfig
from paddlebox_tpu_torch.data.batch import BatchAssembler, CsrBatch
from paddlebox_tpu_torch.data.record import SlotRecord
from paddlebox_tpu_torch.ops.ctr_ops import build_rank_offset


def group_by_pv(records: Sequence[SlotRecord]) -> List[List[SlotRecord]]:
    """Records grouped by ``search_id``, groups in order of first
    appearance, records in their order within a group (the log's ad rank
    order)."""
    groups: List[List[SlotRecord]] = []
    by_id: Dict[int, int] = {}
    for r in records:
        sid = r.search_id
        if sid in by_id:
            groups[by_id[sid]].append(r)
        else:
            by_id[sid] = len(groups)
            groups.append([r])
    return groups


@dataclasses.dataclass
class PvBatch:
    """A CsrBatch plus the PV side channel of rank_attention."""

    batch: CsrBatch
    rank_offset: np.ndarray   # [B, 2*max_rank+1] int32
    pv_offsets: np.ndarray    # [npv+1]
    pv_num: int


class PvBatchAssembler:
    """Batches of ``pv_batch_size`` whole PVs, rows padded to the feed's
    ``batch_size``; a chunk of more instances than that raises
    ``ValueError``."""

    def __init__(self, conf: DataFeedConfig, pv_batch_size: int,
                 max_rank: int = 3, buckets: Optional[BucketSpec] = None):
        self.conf = conf
        self.pv_batch_size = pv_batch_size
        self.max_rank = max_rank
        self.assembler = BatchAssembler(conf, buckets)

    def batches(self, records: Sequence[SlotRecord],
                drop_remainder: bool = False) -> Iterator[PvBatch]:
        groups = group_by_pv(records)
        B = self.conf.batch_size
        for g0 in range(0, len(groups), self.pv_batch_size):
            chunk = groups[g0:g0 + self.pv_batch_size]
            if drop_remainder and len(chunk) < self.pv_batch_size:
                return
            flat: List[SlotRecord] = []
            offsets = [0]
            for g in chunk:
                flat.extend(g)
                offsets.append(len(flat))
            if len(flat) > B:
                raise ValueError(
                    f"pv chunk holds {len(flat)} instances > batch_size {B};"
                    " raise batch_size or lower pv_batch_size")
            batch = self.assembler.assemble(flat)
            ranks = np.array([r.rank for r in flat], dtype=np.int64)
            ro = build_rank_offset(ranks, np.array(offsets), self.max_rank)
            ro_pad = np.zeros((B, 2 * self.max_rank + 1), dtype=np.int32)
            ro_pad[:len(flat)] = ro
            batch.rank_offset = ro_pad
            yield PvBatch(batch=batch, rank_offset=ro_pad,
                          pv_offsets=np.array(offsets, dtype=np.int64),
                          pv_num=len(chunk))
