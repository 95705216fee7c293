"""AucRunner: per-slot feature importance (counterpart of
``paddlebox_tpu/metrics/auc_runner.py``).

A slot's importance is the AUC drop when its feature-label alignment is
destroyed while its marginal value distribution is kept. Two probes:

- :meth:`AucRunner.slot_importance` permutes the slot's values across
  instances (``SlotDataset.slots_shuffle``), then restores them;
- :meth:`AucRunner.slot_importance_pool`, the reference's candidate pool:
  a reservoir sample of records' slot values (:class:`CandidatePool`); in
  each phase every record's phase slots are replaced by a random
  candidate's (:func:`record_replace`) and restored after it
  (:func:`record_replace_back`).

Every evaluation is ``CTRTrainer.evaluate``, the forward only; the pools
and draws are numpy ``default_rng`` streams seeded as in the reference,
so both packages replace the same values.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.data.record import SlotRecord, replace_sparse_slots


class CandidatePool:
    """Reservoir-sampled pool of per-record values of ``slots``:
    ``capacity`` candidates, each a uniform sample of the records
    pushed."""

    def __init__(self, capacity: int, slots: Sequence[int], seed: int = 0):
        if capacity < 1:
            raise ValueError("pool capacity must be >= 1")
        self.capacity = int(capacity)
        self.slots = sorted(int(s) for s in slots)
        self._rng = np.random.default_rng(seed)
        self._cands: List[Dict[int, np.ndarray]] = []
        self._seen = 0

    def push(self, records: Sequence[SlotRecord]) -> None:
        """Reservoir-add each record's values of the pool's slots."""
        for r in records:
            self._seen += 1
            if len(self._cands) < self.capacity:
                self._cands.append(
                    {s: r.slot_uint64(s).copy() for s in self.slots})
            else:
                j = int(self._rng.integers(0, self._seen))
                if j < self.capacity:
                    self._cands[j] = {s: r.slot_uint64(s).copy()
                                      for s in self.slots}

    def __len__(self) -> int:
        return len(self._cands)

    def candidate(self, i: int) -> Dict[int, np.ndarray]:
        return self._cands[i]


def record_replace(records: Sequence[SlotRecord], slots: Sequence[int],
                   pool: CandidatePool, seed: int = 0
                   ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Replace each record's ``slots`` values with those of one random
    pool candidate (a draw a record). Returns the records' original
    arrays for :func:`record_replace_back`."""
    if not len(pool):
        raise ValueError("empty candidate pool (push records first)")
    slot_set = {int(s) for s in slots}
    missing = slot_set - set(pool.slots)
    if missing:
        raise ValueError(f"pool has no candidates for slots {missing}")
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, len(pool), size=len(records))
    originals: List[Tuple[np.ndarray, np.ndarray]] = []
    for r, cid in zip(records, ids):
        originals.append((r.uint64_feas, r.uint64_offsets))
        cand = pool.candidate(int(cid))
        replace_sparse_slots(r, {s: cand[s] for s in slot_set})
    return originals


def record_replace_back(records: Sequence[SlotRecord],
                        originals: List[Tuple[np.ndarray, np.ndarray]]
                        ) -> None:
    """Restore the records bit for bit: the original arrays were set
    aside untouched."""
    for r, (feas, offs) in zip(records, originals):
        r.uint64_feas = feas
        r.uint64_offsets = offs


class AucRunner:
    def __init__(self, trainer, seed: int = 0):
        """``trainer``: a ``CTRTrainer`` (its forward-only ``evaluate``)."""
        self.trainer = trainer
        self.seed = seed

    def slot_importance(self, dataset: SlotDataset,
                        slot_indices: Optional[Sequence[int]] = None
                        ) -> Dict[int, float]:
        """AUC(baseline) - AUC(slot shuffled), a slot; the dataset is
        restored after each probe."""
        if slot_indices is None:
            slot_indices = range(
                len(self.trainer.feed_conf.used_sparse_slots))
        base = self.trainer.evaluate(dataset)["auc"]
        out: Dict[int, float] = {}
        for s in slot_indices:
            perm = dataset.slots_shuffle([s], seed=self.seed + s)
            shuffled = self.trainer.evaluate(dataset)["auc"]
            dataset.unshuffle([s], perm)
            out[int(s)] = base - shuffled
        return out

    def slot_importance_pool(self, dataset: SlotDataset,
                             phases: Optional[Sequence[Sequence[int]]]
                             = None,
                             pool_size: int = 2048) -> Dict[int, float]:
        """AUC(baseline) - AUC(the phase's slots replaced from the pool),
        restored between phases. ``phases`` groups the slots (one
        evaluation a group, all its slots replaced together; default one
        phase a used sparse slot) and must be disjoint. Returns {slot:
        importance}."""
        if phases is None:
            phases = [[s] for s in range(
                len(self.trainer.feed_conf.used_sparse_slots))]
        flat = [int(s) for ph in phases for s in ph]
        if len(flat) != len(set(flat)):
            raise ValueError(
                "phases must be disjoint slot groups (a slot in two "
                "phases would report only the LAST phase's group "
                "measurement under its name)")
        all_slots = sorted(set(flat))
        pool = CandidatePool(pool_size, all_slots, seed=self.seed)
        pool.push(dataset.records)
        base = self.trainer.evaluate(dataset)["auc"]
        out: Dict[int, float] = {}
        for pi, ph in enumerate(phases):
            originals = record_replace(dataset.records, ph, pool,
                                       seed=self.seed + 1 + pi)
            replaced = self.trainer.evaluate(dataset)["auc"]
            record_replace_back(dataset.records, originals)
            for s in ph:
                out[int(s)] = base - replaced
        return out
