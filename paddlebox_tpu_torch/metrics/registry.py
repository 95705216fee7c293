"""Named metric registry (counterpart of
``paddlebox_tpu/metrics/registry.py``).

Metrics are registered by name with a label/pred pairing, an optional
(cmatch, rank) filter and a phase tag; each owns an ``AucCalculator``.
Host numpy: the caller adds host predictions and labels a batch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from paddlebox_tpu_torch.metrics.auc import AucCalculator


class MetricEntry:
    def __init__(self, name: str, label: str = "label", pred: str = "pred",
                 phase: int = -1,
                 cmatch_rank: Optional[Sequence[Tuple[int, int]]] = None,
                 ignore_rank: bool = False,
                 num_buckets: int = 0):
        self.name = name
        self.label = label
        self.pred = pred
        self.phase = phase
        # the accepted (cmatch, rank) pairs; None accepts every instance
        self.cmatch_rank = list(cmatch_rank) if cmatch_rank else None
        self.ignore_rank = ignore_rank
        self.calc = AucCalculator(num_buckets)

    def select_mask(self, cmatch: Optional[np.ndarray],
                    rank: Optional[np.ndarray],
                    base_mask: Optional[np.ndarray],
                    n: int) -> np.ndarray:
        """float32 [n]: ``base_mask`` (ones when None), zeroed where the
        instance's (cmatch, rank) is not an accepted pair (cmatch alone
        with ``ignore_rank`` or without ``rank``)."""
        mask = (np.ones(n, dtype=np.float32) if base_mask is None
                else np.asarray(base_mask, dtype=np.float32))
        if self.cmatch_rank is not None and cmatch is not None:
            ok = np.zeros(n, dtype=bool)
            for cm, rk in self.cmatch_rank:
                hit = cmatch == cm
                if not self.ignore_rank and rank is not None:
                    hit = hit & (rank == rk)
                ok |= hit
            mask = mask * ok.astype(np.float32)
        return mask

    def add(self, preds, labels, cmatch=None, rank=None, mask=None) -> None:
        m = self.select_mask(cmatch, rank, mask, len(np.asarray(preds)))
        self.calc.add_batch(preds, labels, m)


class MetricRegistry:
    def __init__(self):
        self._metrics: Dict[str, MetricEntry] = {}

    def init_metric(self, name: str, **kwargs) -> MetricEntry:
        entry = MetricEntry(name, **kwargs)
        self._metrics[name] = entry
        return entry

    def __getitem__(self, name: str) -> MetricEntry:
        return self._metrics[name]

    def names(self, phase: int = -1) -> List[str]:
        """The metrics of ``phase`` (all with a negative phase); a metric
        of phase -1 belongs to every phase."""
        return [n for n, e in self._metrics.items()
                if phase < 0 or e.phase < 0 or e.phase == phase]

    def get_metric_msg(self, name: str) -> Dict[str, float]:
        """The metric's AUC, bucket_error, MAE, RMSE, actual and predicted
        CTR and instance count."""
        return self._metrics[name].calc.compute()

    def reset(self, phase: int = -1) -> None:
        for n in self.names(phase):
            self._metrics[n].calc.reset()
