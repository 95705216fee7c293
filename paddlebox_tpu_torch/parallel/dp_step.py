"""The data-parallel train step over a host table (counterpart of
``paddlebox_tpu/parallel/dp_step.py``): ``ShardedTrainStep``, the batch
split (``ShardedBatch``, ``split_batch``, ``stack_batches``) and the
shard bodies both mesh steps run (``ShardBodies``).

The caller pulls every shard's rows from a host table with one flat
``pull`` (a ``ShardedBatch``'s keys are ``[ndev, Npad]``, shard d's keys
its row d) and pushes the returned per-shard embedding grads with one
flat ``push``, as the reference's trainer does. One controller drives
every shard of the ``Mesh``; each shard's tensors live on its own device.
A step, shard by shard: the pooled rows through seqpool+CVM
(``ops/seqpool_cvm.py``: the CUDA kernels forward and backward on the
card), the model, the masked BCE over the global denominator (the shards'
mask sums summed before the backward), the backward; then by the mode:

- sync (``dense_sync_steps == 0``): the dense grads summed over the
  shards in shard order (``reduce_gradients``), one dense update of the
  one module on shard 0's device (a shard on another device runs a copy,
  refreshed before each step);
- LocalSGD (``dense_sync_steps == k > 0``): one replica of the dense
  module a shard, on its device, each with its own optimizer state and
  updated by its own local gradient; every k steps (by the step counter,
  ``init_step_counter``) the replicas' params are averaged, ``pmean`` in
  shard order.

The AUC increments of every shard are added in shard order; the loss is
the shards' local losses summed. ``predict`` is the forward alone.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from paddlebox_tpu_torch.config import (BucketSpec, TableConfig,
                                        TrainerConfig, batch_bucket_spec)
from paddlebox_tpu_torch.data.batch import CsrBatch
from paddlebox_tpu_torch.metrics.auc import auc_update, new_auc_state
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm
from paddlebox_tpu_torch.parallel.mesh import AXIS_DP, Mesh
from paddlebox_tpu_torch.parallel.plan import (Plan, global_denominator,
                                               reduce_gradients, reduce_loss)
from paddlebox_tpu_torch.trainer.fused_step import FusedTrainStep
from paddlebox_tpu_torch.trainer.train_step import (
    apply_model, compute_dtype, full_float32_matmuls, make_dense_optimizer,
    masked_bce_loss)


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


def stack_batches(batches: Sequence[CsrBatch],
                  buckets: Optional[BucketSpec] = None) -> ShardedBatch:
    """Per-shard ``CsrBatch``es (one reader a shard, as the reference's
    per-GPU data feeds) stacked into a ``ShardedBatch``, each re-padded to
    one key bucket."""
    buckets = buckets or batch_bucket_spec()
    ndev = len(batches)
    b0 = batches[0]
    Bl, S = b0.batch_size, b0.num_slots
    for b in batches:
        if (b.batch_size, b.num_slots) != (Bl, S):
            raise ValueError("batches have mismatched shapes")
    npad = buckets.bucket(max(max(b.num_keys for b in batches), 1))
    keys = np.zeros((ndev, npad), dtype=np.uint64)
    segs = np.full((ndev, npad), Bl * S, dtype=np.int32)
    for d, b in enumerate(batches):
        keys[d, :b.num_keys] = b.keys[:b.num_keys]
        segs[d, :b.num_keys] = b.segment_ids[:b.num_keys]
    return ShardedBatch(
        keys=keys, segment_ids=segs,
        labels=np.stack([b.labels for b in batches]),
        dense=np.stack([b.dense for b in batches]),
        row_mask=np.stack([b.row_mask() for b in batches]),
        num_keys=np.array([b.num_keys for b in batches], dtype=np.int64),
        batch_size=Bl, num_slots=S)


class ShardBodies:
    """The per-shard bodies of the mesh steps (``ShardedTrainStep`` here,
    ``FusedShardedTrainStep`` over a device-sharded table, and the upload,
    pool and metrics of ``ZeroShardedTrainStep``): the inputs' upload, the
    dense module each shard runs, a shard's local loss, and the sync dense
    step. The step sets ``mesh``, ``devices``, ``device`` (shard 0's),
    ``batch_size`` (a shard's), ``num_slots``, ``use_cvm``,
    ``seqpool_kwargs``, ``cvm_dim``, ``dense_dim``, ``compute_dtype``,
    ``recompute``, ``optimizer``, and for the dense step
    ``sparse_grad_scale`` and ``_replicas`` (an empty dict)."""

    # the single-device step's packing: one host buffer, one copy a shard
    _pack = staticmethod(FusedTrainStep._pack)
    _views = staticmethod(FusedTrainStep._views)
    _float_block = staticmethod(FusedTrainStep._float_block)
    _split_floats = FusedTrainStep._split_floats

    def _upload(self, arrays_of, cvm_in, labels, dense, row_mask):
        """Each shard's inputs in one host->device copy: ``arrays_of(d)``,
        the shard's int64, int32 or float32 arrays, then its cvm_in,
        labels, dense and row_mask. Returns a list over the shards of
        (arrays, cvm, labels, dense, mask) on each shard's device."""
        out = []
        for d, dev in enumerate(self.devices):
            pf, labels_t = self._float_block(cvm_in[d], labels[d], dense[d],
                                             row_mask[d])
            buf, layout = self._pack([*arrays_of(d), pf])
            *arrays, pf = self._views(torch.from_numpy(buf).to(dev), layout)
            out.append((arrays, *self._split_floats(pf, labels_t)))
        return out

    def _dense_models(self, params: nn.Module) -> List[nn.Module]:
        """The dense module each shard's body runs: ``params`` on its own
        device, else a copy on the shard's device, refreshed from it."""
        out = []
        for dev in self.devices:
            if dev == self.device:
                out.append(params)
                continue
            rep = self._replicas.get(dev)
            if rep is None:
                rep = self._replicas[dev] = copy.deepcopy(params).to(dev)
            else:
                with torch.no_grad():
                    for a, b in zip(rep.parameters(), params.parameters()):
                        a.copy_(b)
                    for a, b in zip(rep.buffers(), params.buffers()):
                        a.copy_(b)
            out.append(rep)
        return out

    def _features(self, emb, segs, cvm) -> torch.Tensor:
        return fused_seqpool_cvm(emb, segs, cvm, self.batch_size,
                                 self.num_slots, self.use_cvm,
                                 **self.seqpool_kwargs)

    def _local_loss(self, model, emb, segs, cvm, labels, dense, mask, den):
        """A shard's loss over the global denominator ``den`` (local: no
        cross-shard sum inside it) and its predictions."""
        sparse = self._features(emb, segs, cvm)
        logits = apply_model(model, sparse.to(self.compute_dtype),
                             dense.to(self.compute_dtype),
                             self.recompute).float()
        return masked_bce_loss(logits, labels, mask, den)

    def _shard_grads(self, models, embs, inputs):
        """Each shard's local loss over the global denominator and its
        backward. ``embs[d]``, shard d's pulled rows (a leaf that requires
        grad); ``inputs[d]`` its (segs, cvm, labels, dense, mask). Returns
        (losses, preds, dembs, dparams), one entry a shard."""
        den = global_denominator([inp[4].sum() for inp in inputs], self.mesh)
        losses, preds, dembs, dparams = [], [], [], []
        for d, (emb, (segs, cvm, labels, dense, mask)) in enumerate(
                zip(embs, inputs)):
            ps = list(models[d].parameters())
            loss, p = self._local_loss(models[d], emb, segs, cvm, labels,
                                       dense, mask, den)
            grads = torch.autograd.grad(loss, [emb, *ps], allow_unused=True)
            demb = grads[0]
            if self.sparse_grad_scale != 1.0:
                demb = torch.cat([demb[:, :2],
                                  demb[:, 2:] * self.sparse_grad_scale], 1)
            dembs.append(demb)
            dparams.append(grads[1:])
            losses.append(loss.detach())
            preds.append(p.detach())
        return losses, preds, dembs, dparams

    def _metrics(self, auc_state, inputs, losses, preds):
        """The AUC increments of every shard, added in shard order; the
        summed loss and the predictions [ndev, ...] on shard 0's device."""
        for (segs, cvm, labels, dense, mask), p in zip(inputs, preds):
            p0 = p if p.dim() == 1 else p[:, 0]
            l0 = labels if labels.dim() == 1 else labels[:, 0]
            auc_state = auc_update(auc_state, p0.to(self.device),
                                   l0.to(self.device), mask.to(self.device))
        return (auc_state, reduce_loss(losses, self.mesh),
                torch.stack([p.to(self.device) for p in preds]))

    def _dense_step(self, params, opt_state, auc_state, embs, inputs):
        """Sync DP: forward and backward on each shard, the dense grads
        summed in shard order, the dense update once, the AUC. Returns
        (opt_state, auc_state, loss, preds [ndev, ...], dembs)."""
        losses, preds, dembs, dparams = self._shard_grads(
            self._dense_models(params), embs, inputs)
        for p, g in zip(params.parameters(),
                        reduce_gradients(dparams, self.mesh)):
            p.grad = g
        opt_state = self.optimizer.update(params, opt_state)
        auc_state, loss, preds = self._metrics(auc_state, inputs, losses,
                                               preds)
        return opt_state, auc_state, loss, preds, dembs


Params = Union[nn.Module, List[nn.Module]]


class ShardedTrainStep(ShardBodies):
    """The data-parallel step over a host table (the reference's
    ``ShardedTrainStep``); ``batch_size`` is a shard's. ``plan`` defaults
    to ``Plan.data_parallel(mesh, axis, local=dense_sync_steps > 0)``.
    Under LocalSGD ``params`` and ``opt_state`` are lists, a replica and
    its state a shard."""

    def __init__(self, model: nn.Module, table_conf: TableConfig,
                 trainer_conf: TrainerConfig, mesh: Mesh, batch_size: int,
                 num_slots: int, dense_dim: int = 0, use_cvm: bool = True,
                 num_auc_buckets: int = 0, axis: str = AXIS_DP,
                 seqpool_kwargs: Optional[Dict[str, Any]] = None,
                 plan: Optional[Plan] = None):
        full_float32_matmuls()
        self.model = model
        self.table_conf = table_conf
        self.trainer_conf = trainer_conf
        self.k_sync = int(trainer_conf.dense_sync_steps)
        self.plan = plan if plan is not None else Plan.data_parallel(
            mesh, axis=axis, local=self.k_sync > 0)
        self.mesh = self.plan.mesh
        self.axis = self.plan.data_axis
        self.ndev = self.mesh.size
        self.devices = list(self.mesh.devices)
        self.device = self.devices[0]
        self.batch_size = batch_size
        self.num_slots = num_slots
        self.dense_dim = dense_dim
        self.use_cvm = use_cvm
        self.num_auc_buckets = num_auc_buckets
        self.seqpool_kwargs = dict(seqpool_kwargs or {})
        self.cvm_dim = self.seqpool_kwargs.get("cvm_offset", 2)
        self.optimizer = make_dense_optimizer(trainer_conf)
        self.compute_dtype = compute_dtype(trainer_conf)
        self.recompute = bool(trainer_conf.recompute)
        self.sparse_grad_scale = 1.0
        self._replicas: Dict[torch.device, nn.Module] = {}
        if self.k_sync == 0:
            self.plan.param_specs(model)   # the rules resolve, or raise

    # -- init ----------------------------------------------------------------

    def init(self) -> Tuple[Params, Any]:
        """Sync: the model on shard 0's device and its optimizer state.
        LocalSGD: a copy of the model on each shard's device (shard 0's
        the model itself), each with a fresh optimizer state."""
        params = self.model.to(self.device)
        if self.k_sync == 0:
            return params, self.optimizer.init(params)
        reps = [params] + [copy.deepcopy(params).to(dev)
                           for dev in self.devices[1:]]
        return reps, [self.optimizer.init(r) for r in reps]

    def init_auc_state(self) -> Dict[str, torch.Tensor]:
        return new_auc_state(self.num_auc_buckets, self.device)

    def init_step_counter(self) -> torch.Tensor:
        """The step counter (an int32 scalar on shard 0's device) that
        paces LocalSGD's averaging."""
        return torch.zeros((), dtype=torch.int32, device=self.device)

    # -- the step ------------------------------------------------------------

    def _inputs(self, emb, segment_ids, cvm_in, labels, dense, row_mask):
        """Each shard's rows (a leaf that requires grad) and its (segs,
        cvm, labels, dense, mask), on its device."""
        segs = np.asarray(segment_ids, np.int32)
        emb = np.asarray(emb, np.float32)
        up = self._upload(lambda d: [emb[d], segs[d]], cvm_in, labels,
                          dense, row_mask)
        embs = [arrs[0].requires_grad_(True) for arrs, *_ in up]
        return embs, [(arrs[1], *rest) for arrs, *rest in up]

    def _local_step(self, params, opt_state, auc_state, embs, inputs):
        """LocalSGD: each replica's forward and backward on its shard over
        the global denominator, its own update; the AUC."""
        losses, preds, dembs, dparams = self._shard_grads(params, embs,
                                                          inputs)
        for rep, state, grads in zip(params, opt_state, dparams):
            for p, g in zip(rep.parameters(), grads):
                p.grad = g
            self.optimizer.update(rep, state)
        auc_state, loss, preds = self._metrics(auc_state, inputs, losses,
                                               preds)
        return opt_state, auc_state, loss, preds, dembs

    @torch.no_grad()
    def _average(self, params: List[nn.Module]) -> None:
        """The replicas' params averaged (``pmean``, in shard order), each
        replica's set in place."""
        for ps in zip(*[r.parameters() for r in params]):
            for p, m in zip(ps, self.mesh.pmean(list(ps))):
                p.copy_(m)

    def __call__(self, params: Params, opt_state, auc_state,
                 step: torch.Tensor, emb, segment_ids, cvm_in, labels,
                 dense, row_mask):
        """One step. The batch arrays lead with [ndev] (a
        ``ShardedBatch``'s), ``emb`` [ndev, Npad, pull_dim] the pulled rows
        (host float32). Returns ``(params, opt_state, auc_state, step,
        demb, loss, preds)``: ``demb`` the host float32 [ndev, Npad,
        pull_dim] grads for the flat push, ``loss`` a device scalar,
        ``preds`` [ndev, Bl(, T)] on shard 0's device."""
        embs, inputs = self._inputs(emb, segment_ids, cvm_in, labels, dense,
                                    row_mask)
        if self.k_sync > 0:
            opt_state, auc_state, loss, preds, dembs = self._local_step(
                params, opt_state, auc_state, embs, inputs)
        else:
            opt_state, auc_state, loss, preds, dembs = self._dense_step(
                params, opt_state, auc_state, embs, inputs)
        step = step + 1
        if self.k_sync > 0 and int(step) % self.k_sync == 0:
            self._average(params)
        demb = np.stack([g.detach().cpu().numpy() for g in dembs])
        return params, opt_state, auc_state, step, demb, loss, preds

    @torch.no_grad()
    def predict(self, params: Params, emb, segment_ids, cvm_in,
                dense) -> torch.Tensor:
        """Scores of one batch ([ndev, ...] arrays, ``emb`` the pulled
        rows): [ndev, Bl(, T)] on shard 0's device."""
        B = self.batch_size
        embs, inputs = self._inputs(
            emb, segment_ids, cvm_in, np.zeros((self.ndev, B), np.float32),
            dense, np.ones((self.ndev, B), np.float32))
        models = params if self.k_sync > 0 else self._dense_models(params)
        out = []
        for d, (e, (segs, cvm, _, dns, _)) in enumerate(zip(embs, inputs)):
            sparse = self._features(e.detach(), segs, cvm)
            logits = apply_model(models[d], sparse, dns, False).float()
            out.append(torch.sigmoid(logits).to(self.device))
        return torch.stack(out)
