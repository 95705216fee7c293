"""A minibatch split over the shards of a mesh (counterpart of
``paddlebox_tpu/parallel/dp_step.py``'s ``ShardedBatch`` and
``split_batch``). The host-table engine ``ShardedTrainStep`` is not ported
here (ROADMAP A.9b2)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from paddlebox_tpu_torch.config import BucketSpec, batch_bucket_spec
from paddlebox_tpu_torch.data.batch import CsrBatch


@dataclasses.dataclass
class ShardedBatch:
    """A minibatch split across ``ndev`` data-parallel shards."""

    keys: np.ndarray         # [ndev, Npad] uint64
    segment_ids: np.ndarray  # [ndev, Npad] int32 (local: row*S+slot, pad=Bl*S)
    labels: np.ndarray       # [ndev, Bl] float32
    dense: np.ndarray        # [ndev, Bl, Dd]
    row_mask: np.ndarray     # [ndev, Bl]
    num_keys: np.ndarray     # [ndev] valid key prefix per shard
    batch_size: int          # Bl, per shard
    num_slots: int

    @property
    def ndev(self) -> int:
        return int(self.keys.shape[0])

    def flat_keys(self) -> np.ndarray:
        return self.keys.reshape(-1)


def split_batch(batch: CsrBatch, ndev: int,
                buckets: Optional[BucketSpec] = None) -> ShardedBatch:
    """Split one ``CsrBatch`` row-wise into ``ndev`` equal shards. Its keys
    are laid out row-major, so each shard's keys are one contiguous slice;
    every shard is padded to one bucket, so the stacked array is
    rectangular."""
    buckets = buckets or batch_bucket_spec()
    B, S = batch.batch_size, batch.num_slots
    if B % ndev:
        raise ValueError(f"batch_size {B} not divisible by {ndev} devices")
    Bl = B // ndev
    row_keys = batch.lengths.sum(axis=1)
    row_off = np.concatenate([[0], np.cumsum(row_keys)]).astype(np.int64)
    starts = row_off[np.arange(ndev) * Bl]
    stops = row_off[(np.arange(ndev) + 1) * Bl]
    npad = buckets.bucket(max(int((stops - starts).max()), 1))
    keys = np.zeros((ndev, npad), dtype=np.uint64)
    segs = np.full((ndev, npad), Bl * S, dtype=np.int32)
    for d in range(ndev):
        n = int(stops[d] - starts[d])
        keys[d, :n] = batch.keys[starts[d]:stops[d]]
        segs[d, :n] = batch.segment_ids[starts[d]:stops[d]] - d * Bl * S
    labels = batch.labels.reshape(ndev, Bl)
    dense = batch.dense.reshape(ndev, Bl, -1)
    row_mask = batch.row_mask().reshape(ndev, Bl)
    return ShardedBatch(keys=keys, segment_ids=segs, labels=labels,
                        dense=dense, row_mask=row_mask,
                        num_keys=(stops - starts).astype(np.int64),
                        batch_size=Bl, num_slots=S)
