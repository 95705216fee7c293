"""Bucketed AUC and error metrics (counterpart of
``paddlebox_tpu/metrics/auc.py``).

Predictions land in ``num_buckets`` histogram buckets per class; AUC, MAE,
RMSE, actual/predicted CTR and bucket_error come from the histograms and
running sums. Two tiers, as in the reference:

- device tier: ``auc_update`` accumulates float32 tensors on the step's
  device. Float32 stops counting at 2^24, so the state MUST be drained into
  a host calculator (``AucCalculator.absorb``) well before any bucket
  reaches 2^24 instances (a pass of training, or every few thousand steps
  of B=2048).
- host tier: ``AucCalculator`` holds numpy float64 and is exact.

The histogram adds go through ``index_put_(..., accumulate=True)``: in
order on the CPU and through a sort on the card, so no float atomics run
on the card's main path.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from paddlebox_tpu_torch._device import DeviceLike, resolve_device

# default of the reference's ``auc_num_buckets`` flag
AUC_NUM_BUCKETS = 1 << 20

# statistical bounds for bucket_error
_RELATIVE_ERROR_BOUND = 0.05
_MAX_SPAN = 0.01

_SCALAR_FIELDS = ("abs_err", "sq_err", "pred_sum", "label_sum", "count")


def new_auc_state(num_buckets: int = 0,
                  device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    n = num_buckets or AUC_NUM_BUCKETS
    dev = resolve_device(device)
    state = {"pos": torch.zeros(n, dtype=torch.float32, device=dev),
             "neg": torch.zeros(n, dtype=torch.float32, device=dev)}
    for f in _SCALAR_FIELDS:
        state[f] = torch.zeros((), dtype=torch.float32, device=dev)
    return state


def reset_auc_state_(state: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Zero ``state`` in place after a drain; returns it. Its tensors keep
    their storage, which a captured run (``trainer/step_graph.py``) writes
    into."""
    for t in state.values():
        t.zero_()
    return state


def auc_update(state: Dict[str, torch.Tensor], preds: torch.Tensor,
               labels: torch.Tensor,
               mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One accumulation step, in place (the reference's step donates the
    state); returns ``state``. ``mask``: 1.0 for real rows. Float32: drain
    into an ``AucCalculator`` before counts approach 2^24."""
    n = state["pos"].shape[0]
    p = torch.clamp(preds, 0.0, 1.0)
    # a NaN prediction counts in bucket 0, as XLA converts NaN to 0 in the
    # reference (cast as it is, it indexes out of bounds)
    idx = torch.clamp((torch.nan_to_num(p, nan=0.0) * n).int(),
                      max=n - 1).long()
    err = (p - labels) * mask
    state["pos"].index_put_((idx,), labels * mask, accumulate=True)
    state["neg"].index_put_((idx,), (1.0 - labels) * mask, accumulate=True)
    state["abs_err"] += torch.sum(torch.abs(err))
    state["sq_err"] += torch.sum(torch.square(err))
    state["pred_sum"] += torch.sum(p * mask)
    state["label_sum"] += torch.sum(labels * mask)
    state["count"] += torch.sum(mask)
    return state


class AucCalculator:
    """Host-side float64 accumulator and the final metrics."""

    def __init__(self, num_buckets: int = 0):
        self.num_buckets = num_buckets or AUC_NUM_BUCKETS
        self.reset()

    def reset(self) -> None:
        self.pos = np.zeros(self.num_buckets, dtype=np.float64)
        self.neg = np.zeros(self.num_buckets, dtype=np.float64)
        self.sums = {f: 0.0 for f in _SCALAR_FIELDS}

    def add_batch(self, preds, labels, mask: Optional[np.ndarray] = None
                  ) -> None:
        """Accumulate one batch of host predictions (float32 increments,
        as the device tier computes them)."""
        preds = torch.as_tensor(np.asarray(preds, dtype=np.float32))
        labels = torch.as_tensor(np.asarray(labels, dtype=np.float32))
        mask = (torch.ones_like(preds) if mask is None else
                torch.as_tensor(np.asarray(mask, dtype=np.float32)))
        self.absorb(auc_update(new_auc_state(self.num_buckets, "cpu"),
                               preds, labels, mask))

    def absorb(self, device_state: Mapping[str, torch.Tensor]) -> None:
        """Drain a device-tier ``auc_update`` state into float64."""
        self.pos += device_state["pos"].cpu().numpy().astype(np.float64)
        self.neg += device_state["neg"].cpu().numpy().astype(np.float64)
        for f in _SCALAR_FIELDS:
            self.sums[f] += float(device_state[f])

    def _bucket_error(self) -> float:
        """Group consecutive buckets until the binomial relative error of
        the group's expected CTR falls below 0.05 (or the CTR span exceeds
        0.01), then accumulate |actual/expected - 1| weighted by
        impressions."""
        n = self.num_buckets
        last_ctr, impression_sum, ctr_sum, click_sum = -1.0, 0.0, 0.0, 0.0
        error_sum, error_count = 0.0, 0.0
        nonzero = np.flatnonzero((self.pos + self.neg) > 0)
        for i in nonzero:
            click = self.pos[i]
            show = self.pos[i] + self.neg[i]
            ctr = i / n
            if abs(ctr - last_ctr) > _MAX_SPAN:
                last_ctr = ctr
                impression_sum = ctr_sum = click_sum = 0.0
            impression_sum += show
            ctr_sum += ctr * show
            click_sum += click
            adjust_ctr = ctr_sum / impression_sum
            if adjust_ctr <= 0:
                continue
            relative_error = np.sqrt(
                (1 - adjust_ctr) / (adjust_ctr * impression_sum))
            if relative_error < _RELATIVE_ERROR_BOUND:
                actual_ctr = click_sum / impression_sum
                error_sum += abs(actual_ctr / adjust_ctr - 1) * impression_sum
                error_count += impression_sum
                last_ctr = -1.0
        return error_sum / error_count if error_count > 0 else 0.0

    def compute(self) -> Dict[str, float]:
        total_pos, total_neg = self.pos.sum(), self.neg.sum()
        # trapezoid area walking the buckets upwards
        cum_neg = np.cumsum(self.neg) - self.neg
        area = np.sum(self.pos * (cum_neg + self.neg * 0.5))
        auc = (float(area / (total_pos * total_neg))
               if total_pos > 0 and total_neg > 0 else 0.5)
        count = self.sums["count"]
        return {
            "auc": auc,
            "mae": self.sums["abs_err"] / max(count, 1.0),
            "rmse": float(np.sqrt(self.sums["sq_err"] / max(count, 1.0))),
            "actual_ctr": self.sums["label_sum"] / max(count, 1.0),
            "predicted_ctr": self.sums["pred_sum"] / max(count, 1.0),
            "bucket_error": self._bucket_error(),
            "ins_num": count,
        }
