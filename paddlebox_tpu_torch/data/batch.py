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
from typing import Iterator, Optional, Sequence

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
    # [B, 2*max_rank+1] int32 of a page-view batch (data/pv.py), else None
    rank_offset: Optional[np.ndarray] = None
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


def pad_batch(lengths: np.ndarray, keys: np.ndarray, labels: np.ndarray,
              dense: np.ndarray, batch_size: int, buckets: BucketSpec,
              scratch=None) -> CsrBatch:
    """Pad ``n`` rows (``lengths`` [n, S], their ``keys`` in row-major slot
    order, ``labels`` [n], ``dense`` [n, Dd]) into a batch of
    ``batch_size`` rows and a bucketed key count; the segment ids are one
    ``np.repeat`` over the padded lengths. With ``scratch`` (an object with
    ``take(name, shape, dtype)``, ``data/fast_feed.py``'s arena) the arrays
    are views into its reused buffers, valid until the next call; else
    they are fresh."""
    B = batch_size
    n, S = lengths.shape
    num_keys = int(keys.size)
    npad = buckets.bucket(max(num_keys, 1))
    Dd = dense.shape[1]
    if scratch is None:
        out_lengths = np.zeros((B, S), dtype=np.int32)
        out_labels = np.zeros(B, dtype=np.float32)
        out_dense = np.zeros((B, Dd), dtype=np.float32)
        out_keys = np.zeros(npad, dtype=np.uint64)
        segs = np.full(npad, B * S, dtype=np.int32)
    else:
        out_lengths = scratch.take("b.lengths", (B, S), np.int32)
        out_labels = scratch.take("b.labels", (B,), np.float32)
        out_dense = scratch.take("b.dense", (B, Dd), np.float32)
        out_keys = scratch.take(f"b.keys.{npad}", (npad,), np.uint64)
        segs = scratch.take(f"b.segs.{npad}", (npad,), np.int32)
        out_lengths[n:] = 0
        out_labels[n:] = 0.0
        out_dense[n:] = 0.0
        out_keys[num_keys:] = 0
        segs[num_keys:] = B * S
    out_lengths[:n] = lengths
    out_labels[:n] = labels
    out_dense[:n] = dense
    out_keys[:num_keys] = keys
    segs[:num_keys] = np.repeat(np.arange(B * S, dtype=np.int32),
                                out_lengths.reshape(-1))
    return CsrBatch(keys=out_keys, segment_ids=segs, lengths=out_lengths,
                    labels=out_labels, dense=out_dense, batch_size=B,
                    num_slots=S, num_keys=num_keys, num_rows=n)


class BatchAssembler:
    """Builds fixed-shape CsrBatches from SlotRecords, with no numpy call
    per record except for the dense values of a record whose float slot
    widths differ from the configured dims."""

    def __init__(self, conf: DataFeedConfig,
                 buckets: Optional[BucketSpec] = None,
                 drop_remainder: bool = False):
        self.conf = conf
        self.buckets = buckets or batch_bucket_spec()
        self.drop_remainder = drop_remainder
        self.num_slots = len(conf.used_sparse_slots)
        self.dense_dims = [s.dim for s in conf.used_dense_slots]
        self.total_dense = sum(self.dense_dims)
        self._no_floats = np.zeros(len(self.dense_dims) + 1, dtype=np.int64)

    def _dense(self, records: Sequence[SlotRecord]) -> np.ndarray:
        """[n, Dd] dense values: a record whose float slots have the
        configured widths is copied whole; any other is truncated or
        zero-padded slot by slot, as the reference does."""
        dense = np.zeros((len(records), self.total_dense), dtype=np.float32)
        if not self.total_dense:
            return dense
        offsets = np.stack([self._no_floats if r.float_feas is None
                            else r.float_offsets for r in records])
        exact = (np.diff(offsets, axis=1) == self.dense_dims).all(axis=1)
        rows = np.flatnonzero(exact)
        if rows.size:
            dense[rows] = np.concatenate(
                [records[i].float_feas for i in rows]).reshape(rows.size, -1)
        for i in np.flatnonzero(~exact):
            r = records[i]
            if r.float_feas is None or not r.float_feas.size:
                continue
            fo = r.float_offsets
            col = 0
            for d_idx, dim in enumerate(self.dense_dims):
                vals = r.float_feas[fo[d_idx]:fo[d_idx + 1]]
                dense[i, col:col + min(dim, vals.size)] = vals[:dim]
                col += dim
        return dense

    def assemble(self, records: Sequence[SlotRecord]) -> CsrBatch:
        """Pack ``records`` (one full minibatch, possibly short) into a batch
        padded to ``conf.batch_size`` rows and a bucketed key count."""
        B = self.conf.batch_size
        n = len(records)
        if n == 0 or n > B:
            raise ValueError(f"assemble got {n} records for batch_size {B}")
        lengths = np.diff(np.stack([r.uint64_offsets for r in records]),
                          axis=1).astype(np.int32)
        keys = np.concatenate([r.uint64_feas for r in records])
        labels = np.array([r.label for r in records], dtype=np.float32)
        batch = pad_batch(lengths, keys, labels, self._dense(records), B,
                          self.buckets)
        batch.search_ids = np.zeros(B, dtype=np.int64)
        batch.search_ids[:n] = [r.search_id for r in records]
        return batch

    def batches(self, records: Sequence[SlotRecord]) -> Iterator[CsrBatch]:
        """``records`` in minibatches of ``conf.batch_size``, in order; a
        short last batch is padded, or dropped with ``drop_remainder``."""
        B = self.conf.batch_size
        for i in range(0, len(records), B):
            chunk = records[i:i + B]
            if len(chunk) < B and self.drop_remainder:
                return
            yield self.assemble(chunk)
