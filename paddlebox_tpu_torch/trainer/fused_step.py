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
  flagship engine): in "ensure" mode the host inserts the batch's
  new keys into its index and the index's device mirror
  (``DeviceTable.ensure_keys``; "deferred" mode polls the miss ring
  instead), then ships the raw keys (uint64 viewed as
  int64) beside the int32 segment ids and the float32 block. On the device
  the dedup (K5) numbers the uniques, in ascending key order with Upad =
  Npad, and its write pass probes the mirror for their rows (K6 folded
  in); the dedup's sorted positions and offsets are the push's merge
  order, so the push sorts nothing itself, and the push kernel marks the
  step's rows in the table's device dirty bitmap (``dirty_dev``), as the
  reference's step sets ``dirty`` (host prep's rows are marked on the
  host, in ``prepare_batch``).

Both rebuild ``rows = uniq_rows[inverse]`` and ``uniq_mask = uniq_rows > 0``
on the device. Each phase runs in a ``torch.profiler.record_function`` span
named ``train_step.<phase>``, so a profile splits the step's host time by
phase.

``trainer/trainer.py::CTRTrainer`` drives both entries from a dataset and
reads the ``TrainerConfig`` fields of the trainer loop
(``dense_sync_steps``, ``metrics``, ``num_devices``, ``profile``); the step
reads none of them, as the reference's does not.

``step_device`` is a host half (``ensure_keys``, one upload) and a device
half, ``step_device_tensors``, which takes device tensors. Each entry makes
one host->device copy of all its inputs, packed into one byte buffer.

The chunked and streamed entries run several batches an upload:

- ``train_chunk`` (host prep): ``prepare_batch`` for all K batches first,
  then one upload of the stacked arrays, then K steps over views of it.
- ``train_stream`` over an iterator of batches (``data/fast_feed.py``
  ``FastSlotReader.stream``). Device prep takes runs of up to
  ``DEV_CHUNK`` batches of one key shape (``collect_same_shape_run``): one
  ``ensure_keys`` over the run's keys, one upload of the run, then
  ``step_device_tensors`` over each batch's views; a shorter run goes
  through ``step_device`` batch by batch. On the card every full run after
  its shape's first is one CUDA graph replay (``trainer/step_graph.py``,
  the counterpart of the reference's one-dispatch ``_step_dev_chunk``).
  Host prep prepares and uploads the next batch on a worker thread while
  the current one steps.

``params`` is the ``nn.Module`` that holds the dense weights; the dense
optimizer updates it in place, and ``opt_state`` is the optimizer's state
(``trainer.train_step.DenseOptimizer``). ``TrainerConfig.bf16`` casts the
pooled sparse features and the dense inputs to bfloat16 before the model
and its logits back to float32, as the reference's ``compute_dtype`` does;
a model built with ``dtype=torch.bfloat16`` then computes in bfloat16 over
its float32 master weights (``models/base.py``). The table may hold
float32, bfloat16 or int8 values, in the variable layout or not
(``ps/device_table.py``): the pull takes the state beside the values.

The numeric-sentinel hook: ``set_sentinel(cb)`` installs ``cb(k, bad,
loss)``, called once a dispatch (a step, a chunk, an eager run of
``DEV_CHUNK`` steps or a run graph's replay) with that dispatch's step
count and its sentinels and losses as device tensors, read by nobody on
the way: the callback must not synchronize.

``TrainerConfig.recompute`` runs the model's forward again inside the
backward (``train_step.apply_model``), in the run graphs too.

``insert_mode`` picks device prep's new-key policy, as in the reference:

- ``"ensure"`` (default): the host inserts a batch's (a run's) new keys
  before it ships (``ensure_keys``), so a new key trains on its first
  occurrence.
- ``"deferred"``, the reference's own: no host key work before a step. A
  key the probe does not find rides the null row (pulls zeros, its push
  dropped, row 0 unchanged) and is appended to the table's device miss
  ring; ``poll_misses_async`` before each ``step_device`` and each run of
  ``train_stream`` drains the ring with a lag (a step's misses insert at
  the second poll after it), so the key trains from a later occurrence
  on. ``train_stream(final_poll=True)`` drains it at the
  end with ``poll_misses``.

A device-prep step appends its misses to the ring
(``DeviceTable.record_misses``, after the dedup and probe) in "deferred"
mode, and in "ensure" mode over a table with an admission gate, whose
rejected keys miss; "ensure" over a table that admits every key misses
none, and skips the append (its ring stays empty, as the reference's
does).

``train_stream(feed=DeviceFeed(...))`` runs the staged device feed
(``data/device_feed.py``), the reference's ``_train_stream_staged``:
``batch_iter`` then yields ``ColumnarSlice`` views, the feed's producer
thread packs runs of ``DEV_CHUNK`` batches into pinned ring slots and
uploads them on a copy stream ahead of the step, and each run is
``step_cols_tensors`` over the rows of its wire: the segment ids, the
row mask and the cvm input rebuilt on the device from the lengths and
the row count, as the reference's ``_step_cols`` does. On the card a run
shape's first run goes eagerly over the staged chunk, and each later one
is one device-to-device copy into its graph's static buffer and one
replay. A short run arrives decoded and goes through ``step_device``.

The streams add their host feed work (collecting batches, key work,
packing and uploading, or waiting for the staged feed) to the global
registry's ``feed.host_ms`` counter, which ``CTRTrainer`` turns into the
pass heartbeat's ``host_share`` (``obs/heartbeat.py``).
"""

from __future__ import annotations

import concurrent.futures as futures
import contextlib
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from paddlebox_tpu_torch.config import TrainerConfig
from paddlebox_tpu_torch.metrics.auc import auc_update, new_auc_state
from paddlebox_tpu_torch.obs.metrics import REGISTRY
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm
from paddlebox_tpu_torch.ps.device_table import DeviceTable
from paddlebox_tpu_torch.ps.native import wire_len, wire_offsets
from paddlebox_tpu_torch.trainer.step_graph import RunGraphs
from paddlebox_tpu_torch.trainer.train_step import (apply_model,
                                                    compute_dtype,
                                                    full_float32_matmuls,
                                                    make_dense_optimizer,
                                                    masked_bce_loss)


_TORCH_DTYPES = {np.dtype(np.int64): torch.int64,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(np.float32): torch.float32}


def collect_same_shape_run(it, pending, k: int):
    """Collect up to ``k`` batches whose key arrays share one shape (a run
    is uploaded stacked). A shape change ends the run and carries the odd
    batch over as ``pending``. Returns (run, pending)."""
    run = []
    if pending is not None:
        run.append(pending)
        pending = None
    for b in it:
        if run and b[0].shape != run[0][0].shape:
            pending = b
            break
        run.append(b)
        if len(run) == k:
            break
    return run, pending


def _keys_i64(keys) -> np.ndarray:
    """The padded uint64 keys as the int64 the device index takes."""
    return np.ascontiguousarray(keys, dtype=np.uint64).view(np.int64)


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
        self.compute_dtype = compute_dtype(trainer_conf)
        self.recompute = bool(trainer_conf.recompute)
        # the last step's numeric sentinel (a device bool), and the hook
        # each dispatch hands its sentinels to
        self.bad_flag: Optional[torch.Tensor] = None
        self._sentinel_cb = None
        self.device_prep = device_prep
        self.insert_mode = insert_mode
        # whether a step can miss a key, and so appends to the miss ring
        self._record_misses = (insert_mode == "deferred" or
                               not table.admits_every_key())
        if device_prep:
            table.enable_device_index()
        # on the card, full device-prep runs of train_stream replay CUDA
        # graphs; the CPU runs them eagerly
        self.run_graphs = (RunGraphs(self) if device_prep and
                           self.device.type == "cuda" else None)

    def init(self) -> Tuple[nn.Module, Dict[str, Any]]:
        """The model, moved to the table's device, and a fresh optimizer
        state. The weights are the model's own (for parity runs: converted
        from the reference's flax params)."""
        params = self.model.to(self.device)
        return params, self.optimizer.init(params)

    def init_auc_state(self) -> Dict[str, torch.Tensor]:
        return new_auc_state(self.num_auc_buckets, self.device)

    def set_sentinel(self, cb) -> None:
        """Install (or clear, ``cb=None``) the numeric-sentinel hook:
        ``cb(k_steps, bad, loss)`` after every dispatch, ``bad`` and
        ``loss`` device tensors (a scalar each for one step, [k] for a
        chunk or a run). The hook must not synchronize."""
        self._sentinel_cb = cb

    def _emit_sentinel(self, k: int, bad, loss) -> None:
        """The hook's call for a dispatch of ``k`` steps: ``bad`` and
        ``loss`` tensors, or lists of the steps' scalars (stacked only
        when a hook is installed)."""
        cb = self._sentinel_cb
        if cb is not None:
            if isinstance(bad, list):
                bad, loss = torch.stack(bad), torch.stack(loss)
            cb(k, bad, loss)

    # -- internals -----------------------------------------------------------

    @staticmethod
    def _pack(parts) -> Tuple[np.ndarray, tuple]:
        """``parts``, each an int64, int32 or float32 numpy array or a list
        of same-shape ones (stacked on a new first axis), packed at 8-byte
        offsets of one host byte buffer. Returns the buffer and its layout,
        ``(shape, dtype, offset, nbytes)`` a part."""
        metas, total = [], 0
        for p in parts:
            stacked = isinstance(p, list)
            rows = p if stacked else [p]
            shape = ((len(rows),) if stacked else ()) + rows[0].shape
            nbytes = sum(r.nbytes for r in rows)
            metas.append((rows, (shape, rows[0].dtype, total, nbytes)))
            total += -(-nbytes // 8) * 8
        buf = np.empty(total, dtype=np.uint8)
        for rows, (_, _, off, _) in metas:
            for r in rows:
                buf[off:off + r.nbytes] = \
                    np.ascontiguousarray(r).reshape(-1).view(np.uint8)
                off += r.nbytes
        return buf, tuple(m for _, m in metas)

    @staticmethod
    def _views(dev: torch.Tensor, layout) -> List[torch.Tensor]:
        """Each part of ``_pack``'s ``layout`` as a view of ``dev``, the
        packed buffer on the device."""
        return [dev[off:off + n].view(_TORCH_DTYPES[dtype]).reshape(shape)
                for shape, dtype, off, n in layout]

    def _to_device(self, parts) -> List[torch.Tensor]:
        """One host->device copy of ``parts`` (as ``_pack`` takes them) into
        one fresh byte buffer; returns each part's view on the device. The
        copy is synchronous from pageable memory, so the caller may reuse
        its arrays at once."""
        buf, layout = self._pack(parts)
        return self._views(torch.from_numpy(buf).to(self.device), layout)

    @staticmethod
    def _float_block(cvm_in, labels, dense, row_mask) -> Tuple[np.ndarray,
                                                               int]:
        """The float32 inputs as one array, cvm_in | labels | dense |
        row_mask, and the label count a row."""
        labels = np.asarray(labels, dtype=np.float32)
        return (np.concatenate([
            np.asarray(cvm_in, np.float32).ravel(), labels.ravel(),
            np.asarray(dense, np.float32).ravel(),
            np.asarray(row_mask, np.float32).ravel()]),
            1 if labels.ndim == 1 else labels.shape[1])

    def _split_floats(self, pf: torch.Tensor, labels_t: int):
        """``_float_block``'s array on the device -> cvm_in, labels, dense
        and row_mask (views)."""
        B = self.batch_size
        cvm, lab, dns, mask = torch.split(
            pf, [B * self.cvm_dim, B * labels_t, B * self.dense_dim, B])
        lab = lab if labels_t == 1 else lab.reshape(B, labels_t)
        return (cvm.reshape(B, self.cvm_dim), lab,
                dns.reshape(B, self.dense_dim), mask)

    def _upload(self, arrays, cvm_in, labels, dense, row_mask):
        """One host->device copy of ``arrays`` (int64 or int32) and the
        float32 block. Returns the arrays on the device, then cvm_in,
        labels, dense and row_mask."""
        pf, labels_t = self._float_block(cvm_in, labels, dense, row_mask)
        *arrays, pf = self._to_device([*arrays, pf])
        return (arrays, *self._split_floats(pf, labels_t))

    def _forward(self, params: nn.Module, emb: torch.Tensor,
                 segment_ids: torch.Tensor, cvm_in: torch.Tensor,
                 dense: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
        sparse = fused_seqpool_cvm(
            emb, segment_ids, cvm_in, self.batch_size, self.num_slots,
            self.use_cvm, **self.seqpool_kwargs)
        return apply_model(params, sparse.to(dtype), dense.to(dtype),
                           self.recompute).float()

    # -- public --------------------------------------------------------------

    def _step(self, params: nn.Module, opt_state: Dict[str, Any],
              auc_state: Dict[str, torch.Tensor], segs: torch.Tensor,
              inverse: torch.Tensor, uniq_rows: torch.Tensor,
              cvm: torch.Tensor, labels: torch.Tensor, dense: torch.Tensor,
              mask: torch.Tensor, merge=None, dirty=None):
        """The step body both entries share, from the device index arrays
        on: pull, forward, backward, dense update, push (with ``merge`` as
        its merge order and ``dirty`` as the bitmap it marks, when given),
        metrics."""
        t = self.table
        with record_function("train_step.forward"):
            uniq_mask = (uniq_rows > 0).float()
            rows = uniq_rows[inverse.long()]
            # grads are taken against the pulled rows, not through the pull
            emb = t.device_pull(t.values, rows,
                                t.state).requires_grad_(True)
            params.zero_grad(set_to_none=True)
            logits = self._forward(params, emb, segs, cvm, dense,
                                   self.compute_dtype)
            loss, preds = masked_bce_loss(logits, labels, mask)
        with record_function("train_step.backward"):
            loss.backward()
            demb = emb.grad
        with record_function("train_step.dense_update"):
            opt_state = self.optimizer.update(params, opt_state)
        with record_function("train_step.push"):
            t.device_push(t.values, t.state, demb, inverse, uniq_rows,
                          uniq_mask, merge, dirty)
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
             mask) = self._upload(
                [np.asarray(segment_ids, np.int32), idx.inverse,
                 idx.uniq_rows], cvm_in, labels, dense, row_mask)
        out = self._step(params, opt_state, auc_state, segs, inverse,
                         uniq_rows, cvm, labels_d, dense_d, mask)
        self._emit_sentinel(1, self.bad_flag, out[3])
        return out

    def _need_device_prep(self) -> None:
        if not self.device_prep:
            raise RuntimeError("step_device needs FusedTrainStep("
                               "device_prep=True)")

    def step_device(self, params: nn.Module, opt_state: Dict[str, Any],
                    auc_state: Dict[str, torch.Tensor], keys: np.ndarray,
                    segment_ids, cvm_in, labels, dense, row_mask):
        """Device-prep entry: inserts the batch's new keys on the host
        ("ensure") or polls the miss ring ("deferred"), ships the raw keys,
        and dedups and resolves them on the device (K5 with K6 folded in)
        before the shared step body. Arguments and result as
        ``__call__``'s."""
        self._need_device_prep()
        self._insert_before([keys])
        with record_function("train_step.upload"):
            (keys_d, segs), cvm, labels_d, dense_d, mask = self._upload(
                [_keys_i64(keys), np.asarray(segment_ids, np.int32)],
                cvm_in, labels, dense, row_mask)
        out = self.step_device_tensors(params, opt_state, auc_state, keys_d,
                                       segs, cvm, labels_d, dense_d, mask)
        self._emit_sentinel(1, self.bad_flag, out[3])
        return out

    def step_device_tensors(self, params: nn.Module,
                            opt_state: Dict[str, Any],
                            auc_state: Dict[str, torch.Tensor],
                            keys: torch.Tensor, segment_ids: torch.Tensor,
                            cvm_in: torch.Tensor, labels: torch.Tensor,
                            dense: torch.Tensor, row_mask: torch.Tensor):
        """The device half of ``step_device``: every input already on the
        table's device (``keys``, the padded uint64 keys viewed as int64).
        A key not in the index and its mirror rides the null row and is
        appended to the miss ring (where a step can miss one). The arenas, the dirty bitmap, the mirror
        and the ring are read at the call, so a growth or a resync before
        it is seen. Result as ``step_device``'s."""
        self._need_device_prep()
        t = self.table
        with record_function("train_step.dedup_probe"):
            dd, uniq_rows, found = t.mirror.dedup_probe(keys)
        out = self._step(params, opt_state, auc_state, segment_ids,
                         dd.inverse, uniq_rows, cvm_in, labels, dense,
                         row_mask, merge=(dd.order, dd.offsets),
                         dirty=t.dirty_dev)
        if self._record_misses:
            with record_function("train_step.record_misses"):
                t.record_misses(dd.uniq_keys, found, dd.n_uniq)
        return out

    def wire_len(self, npad: int) -> int:
        """32-bit words of a staged batch's wire row at ``npad`` keys
        (``ps/native.py`` ``wire_len``)."""
        return wire_len(npad, self.batch_size, self.num_slots,
                        self.dense_dim)

    def step_cols_tensors(self, params: nn.Module,
                          opt_state: Dict[str, Any],
                          auc_state: Dict[str, torch.Tensor],
                          row: torch.Tensor, npad: int):
        """The staged feed's step over one wire row (int32, on the
        table's device; ``data/device_feed.py``): the keys from their
        halves, the segment ids expanded from the lengths (the padding
        positions on the discard segment B*S, their keys 0), the row mask
        from the row count and the cvm input (1, label), all on the device
        and read back by nothing, then ``step_device_tensors``. The
        counterpart of the reference's ``_step_cols``; the inputs equal
        the unstaged stream's bit for bit. Result as ``step_device``'s."""
        B, Dd = self.batch_size, self.dense_dim
        o_len, o_lab, o_den, o_n = wire_offsets(npad, B, self.num_slots, Dd)
        with record_function("train_step.unpack_cols"):
            keys = ((row[:npad].long() << 32)
                    | (row[npad:o_len].long() & 0xFFFFFFFF))
            lengths = row[o_len:o_lab]
            labels = row[o_lab:o_den].view(torch.float32)
            dense = row[o_den:o_n].view(torch.float32).reshape(B, Dd)
            nrows = row[o_n]
            # a position's segment: how many segments end at or before it
            segs = torch.searchsorted(
                torch.cumsum(lengths, 0),
                torch.arange(npad, device=row.device),
                right=True).to(torch.int32)
            mask = (torch.arange(B, device=row.device) < nrows).float()
            cvm = torch.stack([torch.ones_like(labels), labels], dim=1)
        return self.step_device_tensors(params, opt_state, auc_state, keys,
                                        segs, cvm, labels, dense, mask)

    def _insert_before(self, keys_list: List[np.ndarray]) -> None:
        """The host's key work before a device-prep dispatch over the
        batches of ``keys_list``: one ``ensure_keys`` over their keys, or
        in "deferred" mode one lagged drain of the miss ring."""
        if self.insert_mode == "deferred":
            with record_function("train_step.poll_misses"):
                self.table.poll_misses_async()
        else:
            with record_function("train_step.ensure_keys"):
                self.table.ensure_keys(np.concatenate(keys_list))

    # -- chunked and streamed entries ----------------------------------------

    DEV_CHUNK = 16

    def train_chunk(self, params: nn.Module, opt_state: Dict[str, Any],
                    auc_state: Dict[str, torch.Tensor], keys_list,
                    segment_ids_list, cvm_list, labels_list, dense_list,
                    row_mask_list):
        """Host-prep entry over K batches of one shape: ``prepare_batch``
        for all K first (every new row of the K batches exists before the
        first step), one upload of the stacked arrays (the uniques padded
        to the widest batch's), then K steps over views of it. Returns
        ``(params, opt_state, auc_state, losses [K], preds [K, ...])``."""
        t = self.table
        with record_function("train_step.prepare_batch"):
            idxs = [t.prepare_batch(k) for k in keys_list]
        with record_function("train_step.upload"):
            uniq = np.zeros((len(idxs),
                             max(i.uniq_rows.shape[0] for i in idxs)),
                            dtype=np.int32)
            for j, i in enumerate(idxs):
                uniq[j, :i.uniq_rows.shape[0]] = i.uniq_rows
            floats = [self._float_block(*f) for f in zip(
                cvm_list, labels_list, dense_list, row_mask_list)]
            segs, inverse, uniq_rows, pf = self._to_device([
                [np.asarray(x, np.int32) for x in segment_ids_list],
                [i.inverse for i in idxs], uniq, [f for f, _ in floats]])
        losses, preds, bads = [], [], []
        for j in range(len(idxs)):
            params, opt_state, auc_state, loss, p = self._step(
                params, opt_state, auc_state, segs[j], inverse[j],
                uniq_rows[j], *self._split_floats(pf[j], floats[0][1]))
            losses.append(loss)
            preds.append(p)
            bads.append(self.bad_flag)
        self._emit_sentinel(len(idxs), bads, losses)
        return (params, opt_state, auc_state, torch.stack(losses),
                torch.stack(preds))

    def train_stream(self, params: nn.Module, opt_state: Dict[str, Any],
                     auc_state: Dict[str, torch.Tensor], batch_iter,
                     on_step=None, final_poll: bool = True, feed=None):
        """Train every batch of ``batch_iter``, which yields (keys,
        segment_ids, cvm_in, labels, dense, row_mask), or with ``feed``
        (a ``data/device_feed.py`` ``DeviceFeed``, device prep only)
        ``ColumnarSlice`` views for the staged feed; calls
        ``on_step(steps, loss)`` after each step, ``loss`` a device scalar
        (nothing is read back). Device prep runs same-shape runs of
        ``DEV_CHUNK`` batches an upload, on the card as CUDA graph
        replays; host prep overlaps the next batch's ``prepare_batch``
        and upload with the current step.
        With device prep, ``final_poll`` drains the miss ring at the end
        (``poll_misses``, one blocking read), as the reference does in
        either mode; host prep has no ring. Returns ``(params, opt_state,
        auc_state, last_loss, steps)``."""
        if feed is not None and not self.device_prep:
            raise ValueError(
                "the device feed needs the device-prep fused engine "
                "(feed_device_prefetch > 0 with host-side prep is a "
                "config error)")
        if not self.device_prep:
            return self._train_stream_host(params, opt_state, auc_state,
                                           batch_iter, on_step)
        if feed is not None:
            out = self._train_stream_staged(params, opt_state, auc_state,
                                            batch_iter, feed, on_step)
        else:
            out = self._train_stream_dev(params, opt_state, auc_state,
                                         batch_iter, on_step)
        if final_poll:
            with record_function("train_step.poll_misses"):
                self.table.poll_misses()
        return out

    def _train_stream_host(self, params, opt_state, auc_state, batch_iter,
                           on_step):
        """One worker thread prepares and uploads the next batch while the
        current one steps. The lock keeps ``prepare_batch``, which may
        grow the arenas, out of a running step, which reads them."""
        t = self.table
        lock = threading.Lock()

        def prep(args):
            keys, segment_ids, cvm_in, labels, dense, row_mask = args
            with lock:
                idx = t.prepare_batch(keys)
            return self._upload([np.asarray(segment_ids, np.int32),
                                 idx.inverse, idx.uniq_rows],
                                cvm_in, labels, dense, row_mask)

        it = iter(batch_iter)
        loss, steps = None, 0
        host_c = REGISTRY.counter("feed.host_ms")
        ex = futures.ThreadPoolExecutor(1, thread_name_prefix="fused-prep")
        try:
            nxt = next(it, None)
            fut = None if nxt is None else ex.submit(prep, nxt)
            while fut is not None:
                t_h = time.perf_counter()
                (segs, inverse, uniq_rows), cvm, labels, dense, mask = \
                    fut.result()
                # the wait for the prep thread is host-bound time
                host_c.add((time.perf_counter() - t_h) * 1e3)
                nxt = next(it, None)
                fut = None if nxt is None else ex.submit(prep, nxt)
                with lock:
                    params, opt_state, auc_state, loss, _ = self._step(
                        params, opt_state, auc_state, segs, inverse,
                        uniq_rows, cvm, labels, dense, mask)
                self._emit_sentinel(1, self.bad_flag, loss)
                steps += 1
                if on_step is not None:
                    on_step(steps, loss)
        finally:
            ex.shutdown(wait=True, cancel_futures=True)
        return params, opt_state, auc_state, loss, steps

    def _train_stream_dev(self, params, opt_state, auc_state, batch_iter,
                          on_step):
        """Runs of ``DEV_CHUNK`` same-shape batches: one ``ensure_keys``
        over the run's keys ("deferred": one lagged poll of the miss ring),
        one upload of its keys, segment ids and float blocks, then
        ``step_device_tensors`` over each batch's views. On
        the card a run shape's first full run goes so, eagerly, and each
        later one is one replay of its CUDA graph (``run_graphs``,
        ``trainer/step_graph.py``). A shorter run (a shape change, the
        stream's tail) steps batch by batch through ``step_device``."""
        K = self.DEV_CHUNK
        graphs = self.run_graphs
        it = iter(batch_iter)
        pending, loss, steps = None, None, 0
        host_c = REGISTRY.counter("feed.host_ms")
        while True:
            t_h = time.perf_counter()
            run, pending = collect_same_shape_run(it, pending, K)
            host_c.add((time.perf_counter() - t_h) * 1e3)
            if not run:
                break
            if len(run) < K:
                for args in run:
                    t_h = time.perf_counter()
                    params, opt_state, auc_state, loss, _ = \
                        self.step_device(params, opt_state, auc_state, *args)
                    host_c.add((time.perf_counter() - t_h) * 1e3)
                    steps += 1
                    if on_step is not None:
                        on_step(steps, loss)
                continue
            t_h = time.perf_counter()
            self._insert_before([a[0] for a in run])
            with record_function("train_step.pack"):
                floats = [self._float_block(*a[2:]) for a in run]
                host, layout = self._pack([
                    [_keys_i64(a[0]) for a in run],
                    [np.asarray(a[1], np.int32) for a in run],
                    [f for f, _ in floats]])
            host_c.add((time.perf_counter() - t_h) * 1e3)
            shape = (layout, floats[0][1])
            if graphs is not None and shape in graphs.warm:
                # the replay's own host time is its synchronous upload
                t_h = time.perf_counter()
                with record_function("train_step.replay"):
                    losses, bads = graphs.replay(
                        params, opt_state, auc_state, host, shape)
                host_c.add((time.perf_counter() - t_h) * 1e3)
                self.bad_flag = bads[-1]
                self._emit_sentinel(K, bads, losses)
                for j in range(K):
                    steps += 1
                    if on_step is not None:
                        on_step(steps, losses[j])
                loss = losses[-1]
                continue
            t_h = time.perf_counter()
            with record_function("train_step.upload"):
                keys, segs, pf = self._views(
                    torch.from_numpy(host).to(self.device), layout)
            host_c.add((time.perf_counter() - t_h) * 1e3)
            losses, bads = [], []
            for j in range(K):
                params, opt_state, auc_state, loss, _ = \
                    self.step_device_tensors(
                        params, opt_state, auc_state, keys[j], segs[j],
                        *self._split_floats(pf[j], shape[1]))
                losses.append(loss)
                bads.append(self.bad_flag)
                steps += 1
                if on_step is not None:
                    on_step(steps, loss)
            self._emit_sentinel(K, bads, losses)
            if graphs is not None:
                graphs.warm.add(shape)
        return params, opt_state, auc_state, loss, steps

    def _train_stream_staged(self, params, opt_state, auc_state, col_iter,
                             feed, on_step):
        """The consumer half of the staged feed (``data/device_feed.py``):
        the feed's producer packs ``col_iter``'s slices into ring slots
        and uploads them on its copy stream while this loop runs the
        staged runs, the counterpart of the reference's
        ``_train_stream_staged``. Each run: its key work ("ensure": one
        ``ensure_keys`` over its keys; "deferred": one lagged poll), then
        on the step's stream a wait on the upload's event, and the run:
        eagerly over the staged chunk when its shape is new, else one copy
        into its graph's static buffer and one replay. An event recorded
        after the run retires the slot once it has completed; at most
        ``min(2, buffers - 1)`` slots are in runs, so one always serves
        the producer. A short run arrives decoded (``TailBatches``) and
        goes through ``step_device``. Every exit retires every slot and
        stops the feed; a producer's failure re-raises here, after the
        runs staged before it."""
        from paddlebox_tpu_torch.data.device_feed import TailBatches

        K = self.DEV_CHUNK
        cuda = self.device.type == "cuda"
        graphs = self.run_graphs
        host_c = REGISTRY.counter("feed.host_ms")
        ch = feed.start(col_iter)
        inflight = deque()    # (event after the run or None, chunk)
        win = min(2, feed.buffers - 1)
        loss, steps = None, 0
        cur = None            # the chunk taken and not yet in flight

        def retire_one():
            done, item = inflight.popleft()
            try:
                if done is not None:
                    done.synchronize()
            finally:
                # the slot returns even when its run failed: a slot left
                # out would wedge the producer
                feed.retire(item)

        try:
            while True:
                t_h = time.perf_counter()
                item = ch.get()
                waited = (time.perf_counter() - t_h) * 1e3
                REGISTRY.observe("feed.stage_wait_ms", waited)
                host_c.add(waited)
                if item is None:
                    break
                if isinstance(item, TailBatches):
                    for args in item.batches:
                        t_h = time.perf_counter()
                        params, opt_state, auc_state, loss, _ = \
                            self.step_device(params, opt_state, auc_state,
                                             *args)
                        host_c.add((time.perf_counter() - t_h) * 1e3)
                        steps += 1
                        if on_step is not None:
                            on_step(steps, loss)
                    continue
                cur = item
                t_h = time.perf_counter()
                if self.insert_mode == "deferred":
                    with record_function("train_step.poll_misses"):
                        self.table.poll_misses_async()
                else:
                    with record_function("train_step.ensure_keys"):
                        self.table.ensure_keys(item.keys)
                host_c.add((time.perf_counter() - t_h) * 1e3)
                while len(inflight) >= win:
                    retire_one()
                if cuda:
                    torch.cuda.current_stream().wait_event(item.event)
                shape = ("cols", item.npad)
                if graphs is not None and shape in graphs.warm:
                    before = graphs.captures
                    with record_function("train_step.replay"):
                        losses, bads = graphs.replay(
                            params, opt_state, auc_state, item.dev, shape,
                            gate=feed.gate)
                    if graphs.captures != before:
                        feed.captures.append(
                            {"staged": feed.staged(),
                             "producing": feed.producing})
                    self.bad_flag = bads[-1]
                    self._emit_sentinel(K, bads, losses)
                    losses = list(losses)
                else:
                    losses, bads = [], []
                    for j in range(item.k):
                        params, opt_state, auc_state, l, _ = \
                            self.step_cols_tensors(params, opt_state,
                                                   auc_state, item.dev[j],
                                                   item.npad)
                        losses.append(l)
                        bads.append(self.bad_flag)
                    self._emit_sentinel(item.k, bads, losses)
                    if graphs is not None:
                        graphs.warm.add(shape)
                inflight.append((self._stream_event() if cuda else None,
                                 item))
                cur = None
                for j in range(item.k):
                    steps += 1
                    if on_step is not None:
                        on_step(steps, losses[j])
                loss = losses[-1]
        finally:
            # every slot back to the ring and the producer gone, on every
            # exit
            if cur is not None:
                # a run that failed part-way: what it queued on the card
                # may still read the chunk
                done = None
                if cuda:
                    with contextlib.suppress(Exception):
                        done = self._stream_event()
                inflight.append((done, cur))
            while inflight:
                try:
                    retire_one()
                except Exception:  # noqa: BLE001 - the unwind goes on
                    pass
            feed.stop()
        return params, opt_state, auc_state, loss, steps

    @staticmethod
    def _stream_event() -> torch.cuda.Event:
        """An event recorded now on the current stream: done once the
        work queued before it is."""
        ev = torch.cuda.Event()
        ev.record()
        return ev

    @torch.inference_mode()
    def predict(self, params: nn.Module, keys: np.ndarray, segment_ids,
                cvm_in, dense) -> torch.Tensor:
        """Scores of one batch against the table; creates no rows. The
        model takes the float32 features, as the reference's ``predict``
        gives them (a model of ``dtype`` bfloat16 casts them itself)."""
        t = self.table
        idx = t.prepare_batch(keys, create=False)
        dev = self.device
        emb = t.device_pull(t.values, torch.from_numpy(idx.rows).to(dev),
                            t.state)
        logits = self._forward(
            params, emb,
            torch.from_numpy(np.asarray(segment_ids, np.int32)).to(dev),
            torch.from_numpy(np.asarray(cvm_in, np.float32)).to(dev),
            torch.from_numpy(np.asarray(dense, np.float32)).to(dev))
        return torch.sigmoid(logits)
