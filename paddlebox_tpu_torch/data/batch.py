"""CSR minibatch assembly (counterpart of ``paddlebox_tpu/data/batch.py``).

A batch packs ragged slot records into flat arrays whose key dimension is
padded up to a geometric bucket (``config.BucketSpec``):

- ``keys[Npad]``        uint64 feature ids (host-side, for the table pull)
- ``segment_ids[Npad]`` int32, ``row * num_slots + slot``; padding keys get
                        segment ``B*S``, which the pool discards. The ids are
                        non-decreasing, which the seqpool kernel relies on.
- ``lengths[B, S]``     keys per (row, slot)
- ``labels[B]``, ``dense[B, Dd]``
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch.config import (BucketSpec, DataFeedConfig,
                                        batch_bucket_spec)
from paddlebox_tpu_torch.data.record import SlotRecord


@dataclasses.dataclass
class CsrBatch:
    keys: np.ndarray          # [Npad] uint64 (zero-padded past num_keys)
    segment_ids: np.ndarray   # [Npad] int32 in [0, B*S]; B*S = padding segment
    lengths: np.ndarray       # [B, S] int32
    labels: np.ndarray        # [B] float32
    dense: np.ndarray         # [B, Dd] float32 (Dd may be 0)
    batch_size: int
    num_slots: int
    num_keys: int             # valid prefix length of keys/segment_ids
    num_rows: int             # real instances (<= batch_size; rest is padding)
    search_ids: Optional[np.ndarray] = None

    @property
    def padded_keys(self) -> int:
        return int(self.keys.shape[0])

    def key_mask(self) -> np.ndarray:
        """[Npad] float32: 1.0 for the valid keys, 0.0 for padding."""
        m = np.zeros(self.padded_keys, dtype=np.float32)
        m[:self.num_keys] = 1.0
        return m

    def row_mask(self) -> np.ndarray:
        """[B] float32: 1.0 for the real instances, 0.0 for padding rows."""
        m = np.zeros(self.batch_size, dtype=np.float32)
        m[:self.num_rows] = 1.0
        return m


class BatchAssembler:
    """Builds fixed-shape CsrBatches from SlotRecords."""

    def __init__(self, conf: DataFeedConfig,
                 buckets: Optional[BucketSpec] = None,
                 drop_remainder: bool = False):
        self.conf = conf
        self.buckets = buckets or batch_bucket_spec()
        self.drop_remainder = drop_remainder
        self.num_slots = len(conf.used_sparse_slots)
        self.dense_dims = [s.dim for s in conf.used_dense_slots]
        self.total_dense = sum(self.dense_dims)

    def assemble(self, records: Sequence[SlotRecord]) -> CsrBatch:
        """Pack ``records`` (one full minibatch, possibly short) into a batch
        padded to ``conf.batch_size`` rows and a bucketed key count."""
        B = self.conf.batch_size
        S = self.num_slots
        n = len(records)
        if n == 0 or n > B:
            raise ValueError(f"assemble got {n} records for batch_size {B}")
        lengths = np.zeros((B, S), dtype=np.int32)
        key_parts: List[np.ndarray] = []
        seg_parts: List[np.ndarray] = []
        labels = np.zeros(B, dtype=np.float32)
        dense = np.zeros((B, self.total_dense), dtype=np.float32)
        search_ids = np.zeros(B, dtype=np.int64)
        slot_base = np.arange(S, dtype=np.int32)
        for i, r in enumerate(records):
            per_slot = np.diff(r.uint64_offsets).astype(np.int32)
            lengths[i] = per_slot
            if r.uint64_feas.size:
                key_parts.append(r.uint64_feas)
                seg_parts.append(np.repeat(i * S + slot_base, per_slot))
            labels[i] = r.label
            search_ids[i] = r.search_id
            if (self.total_dense and r.float_feas is not None
                    and r.float_feas.size):
                fo = r.float_offsets
                col = 0
                for d_idx, dim in enumerate(self.dense_dims):
                    vals = r.float_feas[fo[d_idx]:fo[d_idx + 1]]
                    dense[i, col:col + min(dim, vals.size)] = vals[:dim]
                    col += dim
        num_keys = int(lengths.sum())
        npad = self.buckets.bucket(max(num_keys, 1))
        keys = np.zeros(npad, dtype=np.uint64)
        segs = np.full(npad, B * S, dtype=np.int32)
        if num_keys:
            keys[:num_keys] = np.concatenate(key_parts)
            segs[:num_keys] = np.concatenate(seg_parts)
        return CsrBatch(keys=keys, segment_ids=segs, lengths=lengths,
                        labels=labels, dense=dense, batch_size=B,
                        num_slots=S, num_keys=num_keys, num_rows=n,
                        search_ids=search_ids)

    def batches(self, records: Sequence[SlotRecord]) -> Iterator[CsrBatch]:
        """``records`` in minibatches of ``conf.batch_size``, in order; a
        short last batch is padded, or dropped with ``drop_remainder``."""
        B = self.conf.batch_size
        for i in range(0, len(records), B):
            chunk = records[i:i + B]
            if len(chunk) < B and self.drop_remainder:
                return
            yield self.assemble(chunk)
