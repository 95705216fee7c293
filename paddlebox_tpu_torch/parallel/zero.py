"""ZeRO-style sharded data parallelism over a host table (counterpart of
``paddlebox_tpu/parallel/zero.py``): the dense params and the optimizer
state live as flat chunks, one a shard, on the shards' devices.

- At rest: every parameter is flattened into one float32 vector (in
  ``model.parameters()`` order, the port's own), zero-padded to ``ndev *
  chunk`` and kept as ``ndev`` chunks, chunk ``s`` on shard ``s``'s device;
  shard ``s`` holds the optimizer state of its chunk only.
- A step: ``Mesh.all_gather`` rebuilds the full vector on every shard;
  each shard runs its local loss (seqpool+CVM: the CUDA kernels forward
  and backward on the card; the model through ``functional_call`` over
  views of the vector; the masked BCE over the global denominator) and
  its backward; ``Mesh.reduce_scatter`` sums the flat gradients, in shard
  order, straight into each owner's chunk; each shard updates its chunk.

The optimizer must be elementwise (adam, adamw, sgd, adagrad): the flat
layout severs the per-tensor norms of lars and lamb, which are refused at
construction. ``materialize`` gives the ``nn.Module`` back (for predict,
export, comparison). Storage: each shard holds ``chunk`` params and its
state (``shard_bytes``) where a replicated layout holds every param and
its whole state on each device.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from paddlebox_tpu_torch.config import TableConfig, TrainerConfig
from paddlebox_tpu_torch.metrics.auc import new_auc_state
from paddlebox_tpu_torch.parallel.dp_step import ShardBodies
from paddlebox_tpu_torch.parallel.mesh import AXIS_DP, Mesh
from paddlebox_tpu_torch.parallel.plan import Plan, global_denominator
from paddlebox_tpu_torch.trainer.train_step import (
    apply_model, compute_dtype, full_float32_matmuls, make_dense_optimizer,
    masked_bce_loss)

_ELEMENTWISE = ("adam", "adamw", "sgd", "adagrad")


@dataclasses.dataclass(frozen=True)
class _FlatSpec:
    """The flat layout of a module's parameters: their names, shapes and
    dtypes in ``parameters()`` order, the total, the chunk a shard."""

    names: Tuple[str, ...]
    shapes: Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]
    total: int
    chunk: int
    ndev: int

    @classmethod
    def of(cls, model: nn.Module, ndev: int) -> "_FlatSpec":
        named = list(model.named_parameters())
        shapes = tuple((tuple(p.shape), p.dtype) for _, p in named)
        total = int(sum(int(np.prod(s)) for s, _ in shapes))
        return cls(tuple(n for n, _ in named), shapes, total,
                   -(-total // ndev), ndev)

    def to_flat(self, tensors) -> torch.Tensor:
        """The tensors as one float32 vector, zero-padded to ``ndev *
        chunk``."""
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        pad = self.ndev * self.chunk - self.total
        return torch.nn.functional.pad(flat, (0, pad))

    def from_flat(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Each parameter as a view (a cast where its dtype is not float32)
        of ``flat``, by name."""
        out, off = {}, 0
        for name, (shape, dtype) in zip(self.names, self.shapes):
            n = int(np.prod(shape))
            out[name] = flat[off:off + n].reshape(shape).to(dtype)
            off += n
        return out


class _Chunk(nn.Module):
    """One shard's chunk of the flat params, as the module the dense
    optimizer updates (its ``flat.grad`` the reduce-scattered gradient)."""

    def __init__(self, flat: torch.Tensor):
        super().__init__()
        self.flat = nn.Parameter(flat)


class ZeroShardedTrainStep(ShardBodies):
    """The data-parallel step with ZeRO-sharded params and optimizer state
    (the reference's ``ZeroShardedTrainStep``); the batch contract is
    ``ShardedTrainStep``'s (``batch_size`` a shard's, arrays leading with
    [ndev]). ``init`` returns the flat chunks (a ``_Chunk`` module a
    shard) and their optimizer states; ``materialize`` the module."""

    def __init__(self, model: nn.Module, table_conf: TableConfig,
                 trainer_conf: TrainerConfig, mesh: Mesh, batch_size: int,
                 num_slots: int, dense_dim: int = 0, use_cvm: bool = True,
                 num_auc_buckets: int = 0, axis: str = AXIS_DP,
                 seqpool_kwargs: Optional[Dict[str, Any]] = None,
                 plan: Optional[Plan] = None):
        if trainer_conf.dense_optimizer not in _ELEMENTWISE:
            raise ValueError(
                f"ZeRO sharding needs an elementwise optimizer "
                f"{_ELEMENTWISE}, got {trainer_conf.dense_optimizer!r} "
                "(per-layer trust ratios don't survive the flat layout)")
        full_float32_matmuls()
        self.model = model
        self.table_conf = table_conf
        self.trainer_conf = trainer_conf
        self.plan = plan if plan is not None else Plan.zero(mesh, axis=axis)
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
        self._spec = _FlatSpec.of(model, self.ndev)
        # the module whose structure each shard's forward runs, one a
        # device (its weights come from the gathered vector)
        self._skeletons: Dict[torch.device, nn.Module] = {}

    # -- init ----------------------------------------------------------------

    def init(self) -> Tuple[List[_Chunk], List[Dict[str, Any]]]:
        """The model's weights as ``ndev`` flat chunks, chunk ``s`` on shard
        ``s``'s device, and each chunk's fresh optimizer state."""
        spec = self._spec
        with torch.no_grad():
            flat = spec.to_flat(list(self.model.parameters()))
        # the zero plan's flat rule, resolved against [ndev, chunk]
        # (the axis must divide its leading dim)
        stacked = flat.reshape(self.ndev, spec.chunk)
        specs = self.plan.param_specs({"flat": stacked})
        chunks = [_Chunk(c.reshape(-1).clone())
                  for c in self.plan.place(stacked, specs["flat"])]
        return chunks, [self.optimizer.init(c) for c in chunks]

    def init_auc_state(self) -> Dict[str, torch.Tensor]:
        return new_auc_state(self.num_auc_buckets, self.device)

    def _skeleton(self, dev: torch.device) -> nn.Module:
        sk = self._skeletons.get(dev)
        if sk is None:
            sk = self._skeletons[dev] = copy.deepcopy(self.model).to(dev)
        return sk

    def materialize(self, chunks: List[_Chunk]) -> nn.Module:
        """The flat chunks as a copy of the model, on shard 0's device."""
        flat = torch.cat([c.flat.detach().to(self.device) for c in chunks])
        model = copy.deepcopy(self.model).to(self.device)
        with torch.no_grad():
            for p, t in zip(model.parameters(),
                            self._spec.from_flat(flat).values()):
                p.copy_(t)
        return model

    def shard_bytes(self, chunks: List[_Chunk],
                    opt_state: List[Dict[str, Any]]) -> List[int]:
        """Bytes of params and optimizer state each shard holds."""
        out = []
        for c, st in zip(chunks, opt_state):
            n = c.flat.numel() * c.flat.element_size()
            for t in _tensors(st):
                n += t.numel() * t.element_size()
            out.append(n)
        return out

    # -- the step ------------------------------------------------------------

    def _shard_model(self, d: int, flat: torch.Tensor):
        """Shard ``d``'s forward over the gathered vector ``flat``: a
        callable ``(sparse, dense) -> logits``."""
        sk = self._skeleton(self.devices[d])
        params = self._spec.from_flat(flat)
        return lambda sparse, dense: functional_call(sk, params,
                                                     (sparse, dense))

    def _inputs(self, emb, segment_ids, cvm_in, labels, dense, row_mask):
        segs = np.asarray(segment_ids, np.int32)
        emb = np.asarray(emb, np.float32)
        up = self._upload(lambda d: [emb[d], segs[d]], cvm_in, labels,
                          dense, row_mask)
        embs = [arrs[0].requires_grad_(True) for arrs, *_ in up]
        return embs, [(arrs[1], *rest) for arrs, *rest in up]

    def __call__(self, chunks: List[_Chunk], opt_state, auc_state, emb,
                 segment_ids, cvm_in, labels, dense, row_mask):
        """One step over the pulled rows ``emb`` [ndev, Npad, pull_dim].
        Returns ``(chunks, opt_state, auc_state, demb, loss, preds)``:
        ``demb`` host float32 [ndev, Npad, pull_dim] for the flat push."""
        embs, inputs = self._inputs(emb, segment_ids, cvm_in, labels, dense,
                                    row_mask)
        gathered = self.mesh.all_gather([c.flat.detach() for c in chunks])
        den = global_denominator([inp[4].sum() for inp in inputs], self.mesh)
        losses, preds, dembs, gflats = [], [], [], []
        for d, (e, (segs, cvm, lab, dns, mask)) in enumerate(
                zip(embs, inputs)):
            flat = gathered[d].requires_grad_(True)
            sparse = self._features(e, segs, cvm)
            logits = apply_model(self._shard_model(d, flat),
                                 sparse.to(self.compute_dtype),
                                 dns.to(self.compute_dtype),
                                 self.recompute).float()
            loss, p = masked_bce_loss(logits, lab, mask, den)
            demb, gflat = torch.autograd.grad(loss, [e, flat])
            dembs.append(demb)
            gflats.append(gflat)
            losses.append(loss.detach())
            preds.append(p.detach())
        for c, st, g in zip(chunks, opt_state,
                            self.mesh.reduce_scatter(gflats)):
            c.flat.grad = g
            self.optimizer.update(c, st)
        auc_state, loss, preds = self._metrics(auc_state, inputs, losses,
                                               preds)
        demb = np.stack([g.detach().cpu().numpy() for g in dembs])
        return chunks, opt_state, auc_state, demb, loss, preds

    @torch.no_grad()
    def predict(self, chunks: List[_Chunk], emb, segment_ids, cvm_in,
                dense) -> torch.Tensor:
        """Scores of one batch: [ndev, Bl(, T)] on shard 0's device."""
        B = self.batch_size
        embs, inputs = self._inputs(
            emb, segment_ids, cvm_in, np.zeros((self.ndev, B), np.float32),
            dense, np.ones((self.ndev, B), np.float32))
        gathered = self.mesh.all_gather([c.flat for c in chunks])
        out = []
        for d, (e, (segs, cvm, _, dns, _)) in enumerate(zip(embs, inputs)):
            sparse = self._features(e.detach(), segs, cvm)
            logits = self._shard_model(d, gathered[d])(sparse, dns).float()
            out.append(torch.sigmoid(logits).to(self.device))
        return torch.stack(out)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
