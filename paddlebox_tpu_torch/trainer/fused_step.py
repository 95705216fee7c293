"""The fused train step over a device-resident table (counterpart of
``paddlebox_tpu/trainer/fused_step.py::FusedTrainStep``).

Two entries share one step body, in the reference's order: pull (gather +
embedx gating) -> seqpool+CVM (CUDA kernel) -> model -> masked BCE loss ->
backward (the seqpool's gather backward is a CUDA kernel) -> dense
optimizer -> push (merge + in-table optimizer, a CUDA kernel) -> AUC
update. The arenas never leave the device and are updated in place.

- ``__call__``, host prep (``device_prep=False``): the host's
  ``prepare_batch`` dedups the keys and maps them to rows, and the host
  ships two packed arrays, as the reference's wire does:

      int32   [Npad + Npad + Upad]: segment_ids | inverse | uniq_rows
      float32 [B * (cvm + T + Dd + 1)]: cvm_in | labels | dense | row_mask

- ``step_device``, device prep (``device_prep=True``, the reference's
  flagship engine, ``insert_mode="ensure"``): the host inserts the batch's
  new keys into its index and the index's device mirror
  (``DeviceTable.ensure_keys``), then ships the raw keys (uint64 viewed as
  int64) beside the int32 segment ids and the float32 block. On the device
  the dedup (K5) numbers the uniques, in ascending key order with Upad =
  Npad, and its write pass probes the mirror for their rows (K6 folded
  in); the dedup's sorted positions and offsets are the push's merge
  order, so the push sorts nothing itself.

Both rebuild ``rows = uniq_rows[inverse]`` and ``uniq_mask = uniq_rows > 0``
on the device. Each phase runs in a ``torch.profiler.record_function`` span
named ``train_step.<phase>``, so a profile splits the step's host time by
phase.

``trainer/trainer.py::CTRTrainer`` drives both entries from a dataset and
reads the ``TrainerConfig`` fields of the trainer loop
(``dense_sync_steps``, ``metrics``, ``num_devices``, ``profile``); the step
reads none of them, as the reference's does not.

``params`` is the ``nn.Module`` that holds the dense weights; the dense
optimizer updates it in place, and ``opt_state`` is the optimizer's state
(``trainer.train_step.DenseOptimizer``). Not ported yet: the "deferred"
insert mode with its device miss ring (ROADMAP A.3b), bf16 dense compute,
recompute, and the chunked and streamed entry points (``train_chunk``,
``train_stream``).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from paddlebox_tpu_torch.config import TrainerConfig
from paddlebox_tpu_torch.metrics.auc import auc_update, new_auc_state
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm
from paddlebox_tpu_torch.ps.device_table import DeviceTable
from paddlebox_tpu_torch.trainer.train_step import (full_float32_matmuls,
                                                    make_dense_optimizer,
                                                    masked_bce_loss)


def numeric_sentinel(loss: torch.Tensor, dparams: Iterable[torch.Tensor],
                     demb: torch.Tensor) -> torch.Tensor:
    """One device bool: any NaN/Inf across the step's loss, dense grads and
    embedding grads. Computed on the device every step, never read by the
    step itself, so the hot path does not synchronize for it."""
    bad = ~torch.isfinite(loss).all()
    for g in dparams:
        bad = bad | ~torch.isfinite(g).all()
    return bad | ~torch.isfinite(demb).all()


class FusedTrainStep:
    """Train step fused with a ``DeviceTable`` (the flagship single-device
    path). Runs on the table's device."""

    def __init__(self, model: nn.Module, table: DeviceTable,
                 trainer_conf: TrainerConfig, batch_size: int,
                 num_slots: int, dense_dim: int = 0, use_cvm: bool = True,
                 num_auc_buckets: int = 0,
                 seqpool_kwargs: Optional[Dict[str, Any]] = None,
                 device_prep: bool = False, insert_mode: str = "ensure"):
        if insert_mode not in ("ensure", "deferred"):
            raise ValueError(f"unknown insert_mode {insert_mode!r}")
        if insert_mode == "deferred":
            raise NotImplementedError(
                "insert_mode='deferred' (the device miss ring, poll_misses) "
                "is not ported yet (ROADMAP A.3b)")
        if trainer_conf.bf16:
            raise NotImplementedError(
                "bf16 dense compute is not ported yet (ROADMAP A.2)")
        if trainer_conf.recompute:
            raise NotImplementedError(
                "recompute is not ported yet (ROADMAP A.2: lars, lamb, "
                "MultiSteps, recompute)")
        full_float32_matmuls()
        self.model = model
        self.table = table
        self.table_conf = table.conf
        self.trainer_conf = trainer_conf
        self.device = table.device
        self.batch_size = batch_size
        self.num_slots = num_slots
        self.dense_dim = dense_dim
        self.use_cvm = use_cvm
        self.num_auc_buckets = num_auc_buckets
        self.seqpool_kwargs = dict(seqpool_kwargs or {})
        # width of the per-instance CVM input = the seqpool op's cvm_offset
        # (show, clk by default), not the table's cvm_offset
        self.cvm_dim = self.seqpool_kwargs.get("cvm_offset", 2)
        self.optimizer = make_dense_optimizer(trainer_conf)
        # the last step's numeric sentinel (a device bool)
        self.bad_flag: Optional[torch.Tensor] = None
        self.device_prep = device_prep
        self.insert_mode = insert_mode
        if device_prep:
            table.enable_device_index()

    def init(self) -> Tuple[nn.Module, Dict[str, Any]]:
        """The model, moved to the table's device, and a fresh optimizer
        state. The weights are the model's own (for parity runs: converted
        from the reference's flax params)."""
        params = self.model.to(self.device)
        return params, self.optimizer.init(params)

    def init_auc_state(self) -> Dict[str, torch.Tensor]:
        return new_auc_state(self.num_auc_buckets, self.device)

    # -- internals -----------------------------------------------------------

    def _upload(self, ints, cvm_in, labels, dense, row_mask):
        """Two host->device copies: the int32 arrays ``ints``, packed, and
        the float32 block. Returns the arrays of ``ints`` on the device,
        then cvm_in, labels, dense and row_mask."""
        B = self.batch_size
        ints = [np.asarray(x, dtype=np.int32) for x in ints]
        labels = np.asarray(labels, dtype=np.float32)
        labels_t = 1 if labels.ndim == 1 else labels.shape[1]
        pi = torch.from_numpy(np.concatenate(ints)).to(self.device)
        pf = torch.from_numpy(np.concatenate([
            np.asarray(cvm_in, np.float32).ravel(), labels.ravel(),
            np.asarray(dense, np.float32).ravel(),
            np.asarray(row_mask, np.float32).ravel()])).to(self.device)
        sizes = [B * self.cvm_dim, B * labels_t, B * self.dense_dim, B]
        cvm, lab, dns, mask = torch.split(pf, sizes)
        lab = lab if labels_t == 1 else lab.reshape(B, labels_t)
        return (torch.split(pi, [x.size for x in ints]),
                cvm.reshape(B, self.cvm_dim), lab,
                dns.reshape(B, self.dense_dim), mask)

    def _forward(self, params: nn.Module, emb: torch.Tensor,
                 segment_ids: torch.Tensor, cvm_in: torch.Tensor,
                 dense: torch.Tensor) -> torch.Tensor:
        sparse = fused_seqpool_cvm(
            emb, segment_ids, cvm_in, self.batch_size, self.num_slots,
            self.use_cvm, **self.seqpool_kwargs)
        return params(sparse, dense).float()

    # -- public --------------------------------------------------------------

    def _step(self, params: nn.Module, opt_state: Dict[str, Any],
              auc_state: Dict[str, torch.Tensor], segs: torch.Tensor,
              inverse: torch.Tensor, uniq_rows: torch.Tensor,
              cvm: torch.Tensor, labels: torch.Tensor, dense: torch.Tensor,
              mask: torch.Tensor, merge=None):
        """The step body both entries share, from the device index arrays
        on: pull, forward, backward, dense update, push (with ``merge`` as
        its merge order when given), metrics."""
        t = self.table
        with record_function("train_step.forward"):
            uniq_mask = (uniq_rows > 0).float()
            rows = uniq_rows[inverse.long()]
            # grads are taken against the pulled rows, not through the pull
            emb = t.device_pull(t.values, rows).requires_grad_(True)
            params.zero_grad(set_to_none=True)
            logits = self._forward(params, emb, segs, cvm, dense)
            loss, preds = masked_bce_loss(logits, labels, mask)
        with record_function("train_step.backward"):
            loss.backward()
            demb = emb.grad
        with record_function("train_step.dense_update"):
            opt_state = self.optimizer.update(params, opt_state)
        with record_function("train_step.push"):
            t.device_push(t.values, t.state, demb, inverse, uniq_rows,
                          uniq_mask, merge)
        with record_function("train_step.metrics"):
            preds = preds.detach()
            p0 = preds if preds.dim() == 1 else preds[:, 0]
            l0 = labels if labels.dim() == 1 else labels[:, 0]
            auc_state = auc_update(auc_state, p0, l0, mask)
            loss = loss.detach()
            self.bad_flag = numeric_sentinel(
                loss, (p.grad for p in params.parameters()
                       if p.grad is not None), demb)
        return params, opt_state, auc_state, loss, preds

    # -- public --------------------------------------------------------------

    def __call__(self, params: nn.Module, opt_state: Dict[str, Any],
                 auc_state: Dict[str, torch.Tensor], keys: np.ndarray,
                 segment_ids, cvm_in, labels, dense, row_mask):
        """Host-prep entry: prepares the batch index against the table's
        key map, runs the step on the table's device and updates the
        arenas. ``keys`` is the padded [Npad] uint64 array (padding = key
        0). Returns ``(params, opt_state, auc_state, loss, preds)``, the
        last two as device tensors."""
        with record_function("train_step.prepare_batch"):
            idx = self.table.prepare_batch(keys)
        with record_function("train_step.upload"):
            ((segs, inverse, uniq_rows), cvm, labels_d, dense_d,
             mask) = self._upload([segment_ids, idx.inverse, idx.uniq_rows],
                                  cvm_in, labels, dense, row_mask)
        return self._step(params, opt_state, auc_state, segs, inverse,
                          uniq_rows, cvm, labels_d, dense_d, mask)

    def step_device(self, params: nn.Module, opt_state: Dict[str, Any],
                    auc_state: Dict[str, torch.Tensor], keys: np.ndarray,
                    segment_ids, cvm_in, labels, dense, row_mask):
        """Device-prep entry ("ensure" mode): inserts the batch's new keys
        on the host, ships the raw keys, and dedups and resolves them on
        the device (K5 with K6 folded in) before the shared step body.
        Arguments and result as ``__call__``'s."""
        if not self.device_prep:
            raise RuntimeError("step_device needs FusedTrainStep("
                               "device_prep=True)")
        t = self.table
        with record_function("train_step.ensure_keys"):
            t.ensure_keys(keys)
        with record_function("train_step.upload"):
            keys_d = torch.from_numpy(np.ascontiguousarray(
                keys, dtype=np.uint64).view(np.int64)).to(self.device)
            (segs,), cvm, labels_d, dense_d, mask = self._upload(
                [segment_ids], cvm_in, labels, dense, row_mask)
        with record_function("train_step.dedup_probe"):
            dd, uniq_rows, _ = t.mirror.dedup_probe(keys_d)
        return self._step(params, opt_state, auc_state, segs, dd.inverse,
                          uniq_rows, cvm, labels_d, dense_d, mask,
                          merge=(dd.order, dd.offsets))

    @torch.inference_mode()
    def predict(self, params: nn.Module, keys: np.ndarray, segment_ids,
                cvm_in, dense) -> torch.Tensor:
        """Scores of one batch against the table; creates no rows."""
        t = self.table
        idx = t.prepare_batch(keys, create=False)
        dev = self.device
        emb = t.device_pull(t.values, torch.from_numpy(idx.rows).to(dev))
        logits = self._forward(
            params, emb,
            torch.from_numpy(np.asarray(segment_ids, np.int32)).to(dev),
            torch.from_numpy(np.asarray(cvm_in, np.float32)).to(dev),
            torch.from_numpy(np.asarray(dense, np.float32)).to(dev))
        return torch.sigmoid(logits)
