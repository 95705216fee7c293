"""The fused data-parallel train step over a device-sharded embedding table
(counterpart of ``paddlebox_tpu/parallel/fused_dp_step.py``
``FusedShardedTrainStep``): the flagship multi-device path. The embedding
pull, the key routing, the dense forward and backward, the gradient
routing and the in-table sparse optimizer run over the shards of a
``Mesh`` (``parallel/mesh.py``), one controller driving every shard, each
shard's work on its own device; the exchanges go through
``Mesh.all_to_all`` and the cross-shard sums through ``Mesh.psum``, in
shard order.

Each shard ``s`` is a requester (its slice of the batch) and an owner (its
arena shard). A step, phase by phase over the shards:

    serve:  gather+gate the owner's served rows once   [Upad, D]
            expand to per-requester layout             [ndev, R, D]
    route:  all_to_all                                 -> my requests
    emb:    flatten + inverse-gather                   [Npad, D]
    dense:  fwd/bwd on a local loss; dparams summed over the shards
    route': merge grads by request position, all_to_all back
    push:   merge by served row, in-table optimizer on the owner's shard

Two ways to get the routing, as in the reference:

- host plan (``__call__``, ``device_prep=False``): the table's
  ``prepare_batch`` builds the plan on the host (``MeshBatchIndex``);
- device prep (``step_device``, ``device_prep=True``): the step routes raw
  keys on the devices. The requester dedups its keys (K5,
  ``device_dedup``), computes each unique's owner (``device_owner_hash``,
  the host's ``shard_of`` bit for bit) and its slot in a capped [ndev, R]
  request bucket: slot 0 of every bucket is the null slot, and a key past
  slot R - 1 routes to null for this step (it pulls zeros, its grads drop,
  it trains at its next occurrence) and is counted in the requester's
  ``miss_cnt[1]``. Each owner dedups and probes what it received against
  its own index mirror (K5 with K6 folded in, ``device_dedup_probe``),
  appends the keys it did not find to its miss ring, serves the rows, and
  later pushes with K5's order as the merge order, marking its rows in its
  device dirty bitmap inside the push kernel. ``insert_mode`` "ensure"
  inserts a run's new keys on the host before it ships (``ensure_keys``);
  "deferred" polls the miss rings with a lag instead. R comes from
  ``_req_cap`` (``npad + 1`` at one shard, else 2x the mean share plus the
  null slot, rounded to 128), widened by the overflow actuator
  (``_overflow_check``) when the table's ``overflow_total`` grows.

The requester's merge of its per-key grads by request position (the
reference's ``jax.ops.segment_sum``) is a merge kernel of its own on the
card (``ops/sparse_push.py`` ``merge_segments``), summing in key order,
and a segment of more than ``SEGMENT_CHUNK`` keys (a hot key) by chunks of
that many, whose sums add in chunk order: a fixed order, the same on the
card and the CPU.
Device prep merges by unique over the order its K5 already gave (a routed
unique has one request position) and copies each routed unique's sum to
its position; the host plan merges by position (``segment_merge``: a
stable sort of the positions and the boundary kernel first). Keys at the
null position are dropped before it (the reference sums them into slot 0,
whose grad every owner drops): the owners' updates are the same.

The gradient contract (``parallel/plan.py``): the loss denominator is
summed over the shards before the backward, each shard differentiates a
local loss, and the losses and the dense grads are summed over the shards
in shard order after it; ``sparse_grad_scale`` scales the embedding grads'
columns 2: only (0, 1 are show/clk counts); the AUC increments of every
shard are added to the one AUC state. The dense params are one
``nn.Module`` on shard 0's device, updated once a step; a shard on another
device runs a copy of it, refreshed from it before each step.

``train_stream`` keeps the reference's chunked stream's semantics, batch
by batch: runs of same-shape batches (``CHUNK``, or ``DEV_CHUNK`` with
device prep, or ``chunk``), the host's key work once a run (host plan:
every batch's plan before the run's first step; device prep: one
``ensure_keys`` over the run, or one lagged poll, and in "ensure" mode an
overflow poll every ``overflow_poll_chunks`` runs), a shorter run batch by
batch through the per-batch entries, and ``sync_hook`` every K steps. Its
results equal the per-batch entries'.

Batch arrays lead with [ndev] (a ``ShardedBatch``'s); ``batch_size`` is
per shard. The stats ``compiled_execs`` of the reference has no
counterpart (nothing compiles); ``stats()`` reports the rest.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from paddlebox_tpu_torch.config import TrainerConfig
from paddlebox_tpu_torch.metrics.auc import new_auc_state
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm
from paddlebox_tpu_torch.ops.sparse_push import (merge_segments,
                                                  segment_merge)
from paddlebox_tpu_torch.parallel.dp_step import ShardBodies
from paddlebox_tpu_torch.parallel.plan import Plan
from paddlebox_tpu_torch.ps.device_index import (device_dedup,
                                                 device_owner_hash,
                                                 key_halves)
from paddlebox_tpu_torch.ps.sharded_device_table import (MeshBatchIndex,
                                                         ShardedDeviceTable)
from paddlebox_tpu_torch.trainer.fused_step import (_keys_i64,
                                                    collect_same_shape_run)
from paddlebox_tpu_torch.trainer.train_step import (
    apply_model, compute_dtype, full_float32_matmuls, make_dense_optimizer)


class FusedShardedTrainStep(ShardBodies):
    """Train step fused with a ``ShardedDeviceTable``. Sync data
    parallelism only (dense params replicated, grads summed over the
    shards)."""

    CHUNK = 8
    DEV_CHUNK = 16

    def __init__(self, model: nn.Module, table: ShardedDeviceTable,
                 trainer_conf: TrainerConfig, batch_size: int,
                 num_slots: int, dense_dim: int = 0, use_cvm: bool = True,
                 num_auc_buckets: int = 0,
                 seqpool_kwargs: Optional[Dict[str, Any]] = None,
                 sparse_grad_scale: float = 1.0,
                 device_prep: bool = False,
                 req_cap: Optional[int] = None,
                 insert_mode: str = "ensure",
                 overflow_poll_chunks: int = 8,
                 boost_decay_polls: int = 8,
                 plan: Optional[Plan] = None):
        """``sparse_grad_scale``: multiplier on the embedding grads'
        columns 2: before the in-table optimizer (a multi-host job's
        1/world)."""
        if insert_mode not in ("ensure", "deferred"):
            raise ValueError(f"unknown insert_mode {insert_mode!r}")
        if insert_mode == "deferred" and not device_prep:
            raise ValueError(
                "insert_mode='deferred' needs device_prep=True (the "
                "host-plan path inserts through the planner and would "
                "silently ignore the deferred policy)")
        full_float32_matmuls()
        self.sparse_grad_scale = float(sparse_grad_scale)
        self.model = model
        self.table = table
        self.table_conf = table.conf
        self.trainer_conf = trainer_conf
        self.plan = (plan if plan is not None
                     else Plan.data_parallel(table.mesh, axis=table.axis))
        self.mesh = self.plan.mesh
        self.axis = self.plan.data_axis
        self.ndev = table.ndev
        self.devices = list(self.mesh.devices)
        # the dense params', the AUC state's and the results' device
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
        self.device_prep = device_prep
        self.insert_mode = insert_mode
        self._req_cap_hint = req_cap
        self.overflow_poll_chunks = max(1, int(overflow_poll_chunks))
        self._init_overflow_actuator(boost_decay_polls)
        # the dense module of each device other than self.device
        self._replicas: Dict[torch.device, nn.Module] = {}
        if device_prep:
            table.enable_device_index()

    # -- the request-bucket overflow actuator --------------------------------

    def _init_overflow_actuator(self, boost_decay_polls: int) -> None:
        """The actuator's state: the boost of R (1 = none), the overflow
        seen, and the decay of the boost after ``boost_decay_polls`` clean
        polls in a row (a threshold that doubles, up to 1024, each time
        the skew returns after a decay)."""
        self._req_boost = 1
        self._overflow_seen = 0
        self.boost_decay_polls = max(1, int(boost_decay_polls))
        self._decay_polls_eff = self.boost_decay_polls
        self._decayed_since_boost = False
        self._clean_polls = 0

    def _req_cap(self, npad: int) -> int:
        """The request-bucket width R: uniform owners put ~U/ndev uniques
        on each owner; 2x slack and the null slot absorb ordinary skew, and
        R never needs more than npad + 1. Rounded to 128. The actuator's
        boost widens it, past an explicit ``req_cap=`` too."""
        if self._req_cap_hint is not None:
            return min(npad + 1, self._req_cap_hint * self._req_boost)
        if self.ndev == 1:
            return npad + 1
        r = min(npad + 1,
                self._req_boost
                * (2 * ((npad + self.ndev - 1) // self.ndev) + 1))
        return min(npad + 1, ((r + 127) // 128) * 128)

    def _overflow_check(self) -> None:
        """When the table's ``overflow_total`` grew since the last check:
        warn and double R's boost (up to 64); after enough clean checks,
        halve it."""
        total = int(self.table.overflow_total)
        if total <= self._overflow_seen:
            if self._req_boost > 1:
                self._clean_polls += 1
                if self._clean_polls >= self._decay_polls_eff:
                    self._req_boost //= 2
                    self._clean_polls = 0
                    self._decayed_since_boost = True
            return
        delta = total - self._overflow_seen
        self._overflow_seen = total
        self._clean_polls = 0
        if self._decayed_since_boost:
            self._decay_polls_eff = min(self._decay_polls_eff * 2, 1024)
            self._decayed_since_boost = False
        boosted = self._req_boost < 64
        if boosted:
            self._req_boost *= 2
        action = (f"widening req_cap x{self._req_boost}" if boosted else
                  f"already at max boost x{self._req_boost}, keys are "
                  "being DROPPED every step")
        warnings.warn(
            f"request buckets overflowed {delta} key slots (cumulative "
            f"{total}): ownership skew past req_cap — {action}. "
            "Persistent warnings mean a few shards own most keys; check "
            "table.stats()['shard_sizes'] and engine stats()['req_boost']",
            RuntimeWarning, stacklevel=3)

    def stats(self) -> Dict[str, Any]:
        """The actuator's state, for an operator."""
        return {"req_boost": self._req_boost,
                "overflow_total": int(self.table.overflow_total),
                "clean_polls": self._clean_polls,
                "boost_decay_polls": self.boost_decay_polls,
                "decay_polls_eff": self._decay_polls_eff,
                "req_cap_hint": self._req_cap_hint,
                "insert_mode": self.insert_mode}

    # -- init ----------------------------------------------------------------

    def init(self) -> Tuple[nn.Module, Dict[str, Any]]:
        """The model, moved to shard 0's device, and a fresh optimizer
        state (for parity runs the weights are converted from the
        reference's flax params)."""
        params = self.model.to(self.device)
        return params, self.optimizer.init(params)

    def init_auc_state(self) -> Dict[str, torch.Tensor]:
        return new_auc_state(self.num_auc_buckets, self.device)

    def _merge_requests(self, demb: torch.Tensor, seg: torch.Tensor,
                        R: int) -> torch.Tensor:
        """The requester's per-key grads merged by request position
        (``seg``, int32 flat positions) into its send buffer [ndev, R, D].
        A key at the null position 0 (padding, an absent key, a key routed
        to null) is dropped before the merge, as the owner drops that
        slot's grad: row 0 stays zero, and the null slot's thousands of
        padding keys cost no merge."""
        M = self.ndev * R
        seg = torch.where(seg > 0, seg, M).to(torch.int32)
        return segment_merge(demb, seg, M).view(self.ndev, R, -1)

    @staticmethod
    def _unique_merge_order(dd) -> Tuple[torch.Tensor, torch.Tensor]:
        """K5's merge order of the requester's keys by unique with key 0's
        segment emptied: its padding keys route to null, whose grads the
        owner drops. K5 sorts the keys as unsigned, so key 0, where
        present, is unique 0; emptying segment 0 moves only its start."""
        offsets = dd.offsets.clone()
        offsets[0] = torch.where(dd.uniq_keys[0] == 0, offsets[1],
                                 offsets[0])
        return dd.order, offsets

    def _merge_routed(self, demb: torch.Tensor, dd, flat: torch.Tensor,
                      R: int) -> torch.Tensor:
        """Device prep's requester merge into its send buffer [ndev, R,
        D]: each unique's grads summed in the merge's fixed order over
        K5's order (``_unique_merge_order``), then each routed unique's sum
        copied to its request position ``flat`` (distinct; ``M`` for a
        unique not routed, a sink dropped here). The same sums as
        ``_merge_requests`` over the positions, bit for bit."""
        M = self.ndev * R
        g = merge_segments(demb, *self._unique_merge_order(dd))
        send = torch.zeros((M + 1, g.shape[1]), dtype=g.dtype,
                           device=g.device)
        send[flat] = g
        return send[:M].view(self.ndev, R, -1)

    def _route(self, keys: torch.Tensor, R: int):
        """The requester's routing of its [Npad] int64 keys: K5's dedup,
        each unique's owner and its slot in the capped [ndev, R] buckets
        (slot 0 of every bucket null). Returns (send [ndev, R] int64 keys,
        seg [Npad] int32 flat request position of each key (0 = null),
        n_over: uniques routed to null because their bucket was full, the
        dedup, flat [Npad] int64 each unique's request position (M: not
        routed))."""
        ndev = self.ndev
        M = ndev * R
        npad = keys.shape[0]
        dd = device_dedup(keys)
        uniq = dd.uniq_keys
        iota = torch.arange(npad, device=keys.device)
        valid = (uniq != 0) & (iota < dd.n_uniq)
        owner = device_owner_hash(*key_halves(uniq)) % ndev
        owner_k = torch.where(valid, owner, ndev)
        # a unique's rank among the uniques of its owner, in unique order
        onehot = owner_k[:, None] == torch.arange(ndev + 1,
                                                  device=keys.device)
        rank = onehot.cumsum(0).gather(1, owner_k[:, None])[:, 0] - 1
        slot = rank + 1
        ok = valid & (slot < R)
        flat = torch.where(ok, owner_k * R + slot, M)
        send = torch.zeros(M + 1, dtype=torch.int64, device=keys.device)
        send[flat] = uniq  # the non-routed ones all land on the sink M
        flatpos = torch.where(ok, flat, 0)
        n_over = (valid & ~ok).sum()
        seg = flatpos[dd.inverse.long()].to(torch.int32)
        return send[:M].view(ndev, R), seg, n_over, dd, flat

    def _serve(self, s: int, recv_keys: torch.Tensor):
        """The owner's side on shard ``s`` of the keys it received ([ndev,
        R]): K5 with K6 folded in against its mirror, the pull of the
        found rows, the misses into its ring. Returns (send [ndev, R, D],
        the dedup, rows, mask)."""
        t = self.table
        ndev, R = recv_keys.shape
        dd, rows, found = t.mirror.shards[s].dedup_probe(
            recv_keys.reshape(-1))
        vals = t.layout.pull(t.values[s], rows, t.state[s])
        back = vals[dd.inverse.long()].view(ndev, R, -1)
        self._record_misses(s, dd.uniq_keys, found)
        return back, dd, rows, (rows > 0).float()

    def _record_misses(self, s: int, uniq: torch.Tensor,
                       found: torch.Tensor) -> None:
        """Append the non-zero uniques the probe did not find to shard
        ``s``'s miss ring, in place and on the device: to ``count + i`` in
        unique order, past the ring into its sink; the count stops at the
        ring's size."""
        ring, cnt = self.table.miss_ring[s], self.table.miss_cnt[s]
        cap = ring.shape[0] - 1
        miss = ~found & (uniq != 0)
        m = miss.long()
        idx = cnt[0] + torch.cumsum(m, 0) - 1
        ring[torch.where(miss & (idx < cap), idx, cap)] = uniq
        cnt[0] = torch.clamp(cnt[0] + m.sum(), max=cap)

    def _step_device_tensors(self, params, opt_state, auc_state, inputs,
                             R: int):
        """One device-prep step over each shard's tensors: ``inputs[d]`` =
        (keys [Npad] int64, segs, cvm, labels, dense, mask) on shard d's
        device; R the bucket width."""
        t = self.table
        ndev, M = self.ndev, self.ndev * R
        routed = [self._route(inp[0], R) for inp in inputs]
        for d, (_, _, n_over, _, _) in enumerate(routed):
            t.miss_cnt[d][1] += n_over
        recv = self.mesh.all_to_all([r[0] for r in routed])
        served = [self._serve(s, recv[s]) for s in range(ndev)]
        back = self.mesh.all_to_all([sv[0] for sv in served])
        embs = [back[d].reshape(M, -1)[routed[d][1].long()]
                .requires_grad_(True) for d in range(ndev)]
        opt_state, auc_state, loss, preds, dembs = self._dense_step(
            params, opt_state, auc_state, embs, [inp[1:] for inp in inputs])
        D = dembs[0].shape[1]
        grecv = self.mesh.all_to_all([
            self._merge_routed(dembs[d], routed[d][3], routed[d][4], R)
            for d in range(ndev)])
        for s, (_, dd, rows, mask) in enumerate(served):
            t.layout.push(t.values[s], t.state[s], grecv[s].reshape(M, D),
                          dd.inverse, rows, mask, (dd.order, dd.offsets),
                          t.dirty_dev[s])
        return params, opt_state, auc_state, loss, preds

    def _step_plan_tensors(self, params, opt_state, auc_state,
                           idx: MeshBatchIndex, inputs):
        """One host-plan step: ``inputs[d]`` = ((inverse, serve_uniq,
        serve_inverse, segs, serve_mask), cvm, labels, dense, mask) on
        shard d's device (``_plan_inputs``); ``idx`` the plan (its R)."""
        t = self.table
        ndev, R = self.ndev, idx.R
        M = ndev * R
        sends = [t.device_serve_pull(s, inp[0][1], inp[0][2])
                 for s, inp in enumerate(inputs)]
        recv = self.mesh.all_to_all(sends)
        embs = [recv[d].reshape(M, -1)[inp[0][0].long()]
                .requires_grad_(True) for d, inp in enumerate(inputs)]
        opt_state, auc_state, loss, preds, dembs = self._dense_step(
            params, opt_state, auc_state, embs,
            [(inp[0][3], *inp[1:]) for inp in inputs])
        grecv = self.mesh.all_to_all([
            self._merge_requests(dembs[d], inp[0][0], R)
            for d, inp in enumerate(inputs)])
        for s, inp in enumerate(inputs):
            t.device_serve_push(s, grecv[s], inp[0][2], inp[0][1],
                                inp[0][4])
        return params, opt_state, auc_state, loss, preds

    # -- public --------------------------------------------------------------

    def _plan_inputs(self, idx: MeshBatchIndex, segment_ids, cvm_in,
                     labels, dense, row_mask):
        """A host plan and a batch on the shards: per shard ((inverse,
        serve_uniq, serve_inverse, segs, serve_mask), cvm, labels, dense,
        mask)."""
        segs = np.asarray(segment_ids, np.int32)
        return [(tuple(arrs), *rest) for arrs, *rest in self._upload(
            lambda d: [idx.inverse[d], idx.serve_uniq[d],
                       idx.serve_inverse[d], segs[d], idx.serve_mask[d]],
            cvm_in, labels, dense, row_mask)]

    def __call__(self, params, opt_state, auc_state, idx: MeshBatchIndex,
                 segment_ids, cvm_in, labels, dense, row_mask):
        """Host-plan entry: batch arrays are [ndev, ...] (a
        ``ShardedBatch``'s), ``idx`` the table's ``prepare_batch`` of its
        keys. Updates the table's arenas in place. Returns ``(params,
        opt_state, auc_state, loss, preds [ndev, Bl(, T)])``, the last two
        device tensors."""
        inputs = self._plan_inputs(idx, segment_ids, cvm_in, labels, dense,
                                   row_mask)
        return self._step_plan_tensors(params, opt_state, auc_state, idx,
                                       inputs)

    def _need_device_prep(self) -> None:
        if not self.device_prep:
            raise RuntimeError("step_device needs FusedShardedTrainStep("
                               "device_prep=True)")

    def _dev_inputs(self, keys, segment_ids, cvm_in, labels, dense,
                    row_mask):
        """A batch on the shards for device prep: per shard (keys int64,
        segs, cvm, labels, dense, mask)."""
        segs = np.asarray(segment_ids, np.int32)
        return [(a[0], a[1], *rest) for a, *rest in self._upload(
            lambda d: [_keys_i64(keys[d]), segs[d]], cvm_in, labels, dense,
            row_mask)]

    def step_device(self, params, opt_state, auc_state, keys, segment_ids,
                    cvm_in, labels, dense, row_mask):
        """Device-prep entry over one batch ([ndev, ...] arrays): "ensure"
        inserts its new keys on the host first, "deferred" polls the miss
        rings with the lag (and checks the overflow). Result as
        ``__call__``'s."""
        self._need_device_prep()
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        if self.insert_mode == "deferred":
            self.table.poll_misses_async()
            self._overflow_check()
        else:
            self.table.ensure_keys(keys)
        inputs = self._dev_inputs(keys, segment_ids, cvm_in, labels, dense,
                                  row_mask)
        return self._step_device_tensors(params, opt_state, auc_state,
                                         inputs, self._req_cap(keys.shape[1]))

    def train_stream(self, params, opt_state, auc_state, batch_iter,
                     chunk: Optional[int] = None, sync_hook=None,
                     final_poll: bool = True, on_step=None):
        """Train every batch of ``batch_iter`` (tuples of keys, segment_ids,
        cvm_in, labels, dense, row_mask, each leading with [ndev]) in runs
        of ``chunk`` same-shape batches (default ``CHUNK``, with device
        prep ``DEV_CHUNK``), the host's key work once a run; a shorter run
        goes batch by batch through the per-batch entries. ``sync_hook(
        params) -> params`` runs every time K steps complete;
        ``on_step(steps, loss)`` after each step, ``loss`` a device scalar
        (the port's addition, as ``FusedTrainStep.train_stream`` has
        it). With device
        prep, ``final_poll`` drains what the lagged polls left ("deferred")
        or what the last snapshot shows ("ensure"). Returns ``(params,
        opt_state, auc_state, last_loss, steps)``; last_loss is None for an
        empty stream."""
        if self.device_prep:
            return self._train_stream_dev(params, opt_state, auc_state,
                                          batch_iter, chunk, sync_hook,
                                          final_poll, on_step)
        K = chunk or self.CHUNK
        t = self.table
        it = iter(batch_iter)
        loss, steps, pending = None, 0, None
        while True:
            block, pending = collect_same_shape_run(it, pending, K)
            if not block:
                break
            if len(block) < K:
                for keys, segs, cvm, labels, dense, mask in block:
                    idx = t.prepare_batch(keys)
                    params, opt_state, auc_state, loss, _ = self(
                        params, opt_state, auc_state, idx, segs, cvm,
                        labels, dense, mask)
                    steps += 1
                    if on_step is not None:
                        on_step(steps, loss)
                    if sync_hook is not None and steps % K == 0:
                        params = sync_hook(params)
                continue
            # every batch's plan (and new row) before the run's first step
            idxs = [t.prepare_batch(b[0]) for b in block]
            for idx, (_, segs, cvm, labels, dense, mask) in zip(idxs, block):
                params, opt_state, auc_state, loss, _ = self(
                    params, opt_state, auc_state, idx, segs, cvm, labels,
                    dense, mask)
                steps += 1
                if on_step is not None:
                    on_step(steps, loss)
            if sync_hook is not None:
                params = sync_hook(params)
        return params, opt_state, auc_state, loss, steps

    def _train_stream_dev(self, params, opt_state, auc_state, batch_iter,
                          chunk, sync_hook, final_poll, on_step):
        K = chunk or self.DEV_CHUNK
        t = self.table
        it = iter(batch_iter)
        loss, steps, pending, chunks_done = None, 0, None, 0
        while True:
            block, pending = collect_same_shape_run(it, pending, K)
            if not block:
                break
            if len(block) < K:
                for args in block:
                    params, opt_state, auc_state, loss, _ = \
                        self.step_device(params, opt_state, auc_state, *args)
                    steps += 1
                    if on_step is not None:
                        on_step(steps, loss)
                    if sync_hook is not None and steps % K == 0:
                        params = sync_hook(params)
                continue
            if self.insert_mode == "deferred":
                t.poll_misses_async()
                self._overflow_check()
            else:
                # one membership scan and insert for the run; the overflow
                # counter polled on a sparse cadence, so sustained skew
                # reaches the actuator
                t.ensure_keys(np.concatenate([
                    np.asarray(b[0], np.uint64).ravel() for b in block]))
                if chunks_done % self.overflow_poll_chunks == 0:
                    t.poll_misses_async()
                    self._overflow_check()
            chunks_done += 1
            npad = np.asarray(block[0][0]).shape[1]
            R = self._req_cap(npad)
            for args in block:
                inputs = self._dev_inputs(*args)
                params, opt_state, auc_state, loss, _ = \
                    self._step_device_tensors(params, opt_state, auc_state,
                                              inputs, R)
                steps += 1
                if on_step is not None:
                    on_step(steps, loss)
            if sync_hook is not None:
                params = sync_hook(params)
        if final_poll:
            if self.insert_mode == "deferred":
                t.poll_misses()
            elif t.snapshot_shows_pending():
                t.poll_misses()
            self._overflow_check()
        return params, opt_state, auc_state, loss, steps

    @torch.no_grad()
    def predict(self, params, idx: MeshBatchIndex, segment_ids, cvm_in,
                dense) -> torch.Tensor:
        """Scores of one batch ([ndev, ...] arrays) through the host plan
        ``idx`` (``prepare_batch(keys, create=False)``): [ndev, Bl(, T)] on
        shard 0's device."""
        t = self.table
        B = self.batch_size
        labels = np.zeros((self.ndev, B), np.float32)
        mask = np.ones((self.ndev, B), np.float32)
        inputs = self._plan_inputs(idx, segment_ids, cvm_in, labels, dense,
                                   mask)
        M = self.ndev * idx.R
        recv = self.mesh.all_to_all([
            t.device_serve_pull(s, inp[0][1], inp[0][2])
            for s, inp in enumerate(inputs)])
        models = self._dense_models(params)
        out = []
        for d, ((inv, _, _, segs, _), cvm, _, dns, _) in enumerate(inputs):
            emb = recv[d].reshape(M, -1)[inv.long()]
            sparse = fused_seqpool_cvm(emb, segs, cvm, B, self.num_slots,
                                       self.use_cvm, **self.seqpool_kwargs)
            logits = apply_model(models[d], sparse, dns, False).float()
            out.append(torch.sigmoid(logits).to(self.device))
        return torch.stack(out)
