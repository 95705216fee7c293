"""The device-sharded embedding table: one arena shard a mesh shard, keys
routed between the shards inside the train step (counterpart of
``paddlebox_tpu/ps/sharded_device_table.py``).

- Shard ``s``'s value and state arenas (``ArenaLayout``, any value dtype,
  the variable layout too) live on ``mesh.devices[s]``. Keys are assigned
  to shards by the owner hash (``shard_of``).
- The host keeps one key -> local-row index a shard (a ``NativeIndex``, or
  under ``backend="numpy"`` the dict index ``ps/table.py`` ``_PyIndex``,
  as the reference's) and, for the host-plan engine, builds each batch's
  routing plan (``prepare_batch``): which local rows each owner serves to
  each requester, and how each requester scatters what it receives back
  into key order. The step (``parallel/fused_dp_step.py``) serves each
  shard with one gather, exchanges with ``Mesh.all_to_all``, and sends the
  grads back the same way into the in-table optimizer on each shard.

Routing plan shapes (bucket-padded):

    req_rows      [ndev_req, ndev_own, R]  local rows d wants from owner s
    inverse       [ndev, Npad]             key j of d -> flat recv pos s*R+i
    serve_uniq    [ndev_own, Upad]         deduped local rows owner serves
    serve_mask    [ndev_own, Upad]         1.0 for real (non-null) rows
    serve_inverse [ndev_own, ndev_req, R]  (requester, slot) -> serve pos

Slot (d, s=0, i=0) is reserved for the null row, so padding keys (key 0)
and absent keys land on a position that pulls zeros and drops grads.

Two plan builders, each numbering a shard's new rows as its counterpart in
the reference does: ``backend="numpy"`` sorted uniques a requester, each
owner looking up all requesters' keys for it in requester order, serve
lists sorted; ``backend="native"`` the C++ planner (``ps/native.py``
``MeshPlanner``), uniques and serve lists in first-occurrence order.

Device prep (``enable_device_index``, native backend): a mirror of each
shard's index on its device (``ps/sharded_device_index.py``), a device
dirty bitmap ``dirty_dev[s]`` that the step's push marks, a miss ring
``miss_ring[s]`` [MISS_RING + 1] int64 (slot MISS_RING the overflow sink)
and its counts ``miss_cnt[s]`` [2] int64: the ring's fill and the keys the
step's requester routed to null because their owner's request bucket was
full (``overflow_total`` accumulates the latter at every drain). All of
them are changed only in place. ``ensure_keys`` inserts a run's new keys
into the right shard's index and mirror before it ships;
``poll_misses`` drains the rings synchronously and ``poll_misses_async``
with the reference's lag.

Persistence writes the canonical ``table.npz`` layout (``ps/device_table.py``),
so a sharded table's snapshot loads into a ``DeviceTable`` and the other
way round, in either package. A row is dirty once a host plan, an
``ensure_keys`` or a device-prep step touched it since the last save.

Growth (``_grow_to``) reallocates every shard at the new capacity: a step
reads the arenas from the table at each call and keeps no address across
it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch.ckpt.atomic import write_npz
from paddlebox_tpu_torch.config import BucketSpec, TableConfig
from paddlebox_tpu_torch.obs.metrics import REGISTRY
from paddlebox_tpu_torch.parallel.mesh import AXIS_DP, Mesh
from paddlebox_tpu_torch.parallel.plan import Plan
from paddlebox_tpu_torch.ps import native
from paddlebox_tpu_torch.ps.device_index import host_owner_hash
from paddlebox_tpu_torch.ps.device_table import (_NULL_SENTINEL, ArenaLayout,
                                                 resolve_backend)
from paddlebox_tpu_torch.ps.sharded_device_index import \
    ShardedDeviceIndexMirror
from paddlebox_tpu_torch.ps.table import _PyIndex, _resolve_backend

# the generator seed of shard s is its allocation's seed plus s times this
# (shard 0 draws what a DeviceTable of the same config draws)
_SHARD_SEED_STRIDE = 1_000_003


def shard_of(keys: np.ndarray, num_shards: int) -> np.ndarray:
    """The owner shard of each uint64 key: the owner hash
    (``ps/device_index.py`` ``host_owner_hash``) mod ``num_shards``, as the
    step's router on the device and the C++ planner compute it."""
    h = host_owner_hash(np.ascontiguousarray(keys, dtype=np.uint64))
    return (h % np.uint32(num_shards)).astype(np.int32)


@dataclasses.dataclass
class MeshBatchIndex:
    """Host-prepared routing plan for one fused sharded step."""

    req_rows: np.ndarray       # [ndev, ndev, R] int32
    inverse: np.ndarray        # [ndev, Npad] int32
    serve_uniq: np.ndarray     # [ndev, Upad] int32
    serve_mask: np.ndarray     # [ndev, Upad] float32
    serve_inverse: np.ndarray  # [ndev, ndev, R] int32
    num_uniq: np.ndarray       # [ndev] int64 valid serve-uniq counts

    @property
    def R(self) -> int:
        return int(self.req_rows.shape[2])

    @property
    def Upad(self) -> int:
        return int(self.serve_uniq.shape[1])


class ShardedDeviceTable:
    """``ndev`` arena shards, one on each shard's device, and the shards'
    host key indexes. ``capacity_per_shard`` rows a shard are
    preallocated; every shard doubles when one fills."""

    GROW = 2.0
    # entries of each shard's miss ring; tests make it smaller
    MISS_RING = 1 << 18

    def __init__(self, conf: TableConfig, mesh: Mesh, axis: str = AXIS_DP,
                 capacity_per_shard: int = 1 << 18,
                 req_buckets: Optional[BucketSpec] = None,
                 uniq_buckets: Optional[BucketSpec] = None,
                 backend: Optional[str] = None,
                 value_dtype: torch.dtype = torch.float32,
                 plan: Optional[Plan] = None):
        self.layout = ArenaLayout(conf, value_dtype)
        self.conf = conf
        self.plan = (plan if plan is not None
                     else Plan(mesh=mesh, data_axis=axis, table_axis=axis,
                               name=f"table-{axis}"))
        self.mesh = self.plan.mesh
        self.axis = self.plan.table_axis
        self.ndev = self.mesh.size
        self.devices = list(self.mesh.devices)
        self.dim = self.layout.dim
        self.value_dtype = value_dtype
        self.backend = (resolve_backend(backend) if backend is not None
                        else _resolve_backend())
        self.capacity = int(capacity_per_shard)
        self.req_buckets = req_buckets or BucketSpec(min_size=512)
        self.uniq_buckets = uniq_buckets or BucketSpec(min_size=512)
        self._indexes = [self._new_index() for _ in range(self.ndev)]
        self._planner = (native.MeshPlanner(self.ndev)
                         if self.backend == "native" else None)
        self._sizes = [1] * self.ndev  # row 0 of each shard = null
        self._dirty = np.zeros((self.ndev, self.capacity), dtype=bool)
        # device prep (enable_device_index)
        self.mirror: Optional[ShardedDeviceIndexMirror] = None
        self.dirty_dev: Optional[List[torch.Tensor]] = None
        self.miss_ring: Optional[List[torch.Tensor]] = None
        self.miss_cnt: Optional[List[torch.Tensor]] = None
        self._miss_snapshot = None
        self._snap_bufs = None
        # request-bucket overflow drained so far: monotonic (the step's
        # req_cap actuator keeps its own watermark)
        self.overflow_total = 0
        self._alloc_seq = 0
        self.values, self.state = self._alloc(self.capacity)

    def _new_index(self):
        return (native.NativeIndex() if self.backend == "native"
                else _PyIndex())

    # -- device arenas -------------------------------------------------------

    def _alloc(self, cap: int) -> Tuple[List[torch.Tensor],
                                        List[torch.Tensor]]:
        """Fresh arenas of ``cap`` rows on each shard's device, each from a
        generator of its own."""
        self._alloc_seq += 1
        seed = (self.conf.seed or 42) * 1009 + self._alloc_seq
        vals, states = [], []
        for s, dev in enumerate(self.devices):
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed + s * _SHARD_SEED_STRIDE)
            v, st = self.layout.alloc(cap, gen, dev)
            vals.append(v)
            states.append(st)
        return vals, states

    def _grow_to(self, need: int) -> None:
        new_cap = self.capacity
        while new_cap < need:
            new_cap = int(new_cap * self.GROW)
        old_v, old_s = self.values, self.state
        self.values = self.state = None  # the old shards go as copied
        vals, state = self._alloc(new_cap)
        for s in range(self.ndev):
            vals[s][:self.capacity] = old_v[s]
            state[s][:self.capacity] = old_s[s]
            old_v[s] = old_s[s] = None
        self.values, self.state = vals, state
        dirty = np.zeros((self.ndev, new_cap), dtype=bool)
        dirty[:, :self.capacity] = self._dirty
        self._dirty = dirty
        if self.dirty_dev is not None:
            for s, dev in enumerate(self.devices):
                bits = torch.zeros(new_cap, dtype=torch.bool, device=dev)
                bits[:self.capacity] = self.dirty_dev[s]
                self.dirty_dev[s] = bits
        self.capacity = new_cap

    # -- batch preparation (host) -------------------------------------------

    def prepare_batch(self, keys: np.ndarray,
                      create: bool = True) -> MeshBatchIndex:
        """The routing plan of a ``[ndev, Npad]`` key array (one row a
        data-parallel shard, padding = key 0); with ``create`` new keys get
        rows and every served row is marked dirty."""
        t0 = time.perf_counter()
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        if keys.ndim != 2 or keys.shape[0] != self.ndev:
            raise ValueError(f"keys must be [{self.ndev}, Npad], got "
                             f"{keys.shape}")
        if self.backend == "native":
            out = self._prepare_batch_native(keys, create)
        else:
            out = self._prepare_batch_numpy(keys, create)
        REGISTRY.observe("ps.mesh_prepare_batch_ms",
                         (time.perf_counter() - t0) * 1e3)
        return out

    def _prepare_batch_numpy(self, keys: np.ndarray,
                             create: bool) -> MeshBatchIndex:
        ndev = self.ndev
        # per-requester dedup
        uniqs, invs, owners = [], [], []
        for d in range(ndev):
            u, inv = native.unique_inverse(keys[d])
            uniqs.append(u)
            invs.append(inv)
            owners.append(shard_of(u, ndev))
        # one index lookup per owner over all requesters' keys for it
        rows_per_d = [np.zeros(u.size, dtype=np.int64) for u in uniqs]
        sels = [[np.flatnonzero(owners[d] == s) for s in range(ndev)]
                for d in range(ndev)]
        grow_need = 0
        for s in range(ndev):
            sel = [sels[d][s] for d in range(ndev)]
            shard_keys = np.concatenate(
                [uniqs[d][sel[d]] for d in range(ndev)])
            if create:
                rows, n_new = self._indexes[s].lookup(
                    shard_keys, True, True, self._sizes[s])
                if n_new:
                    self._sizes[s] += n_new
                    grow_need = max(grow_need, self._sizes[s])
            else:
                rows, _ = self._indexes[s].lookup(shard_keys, False, True, 0)
            rows = np.where(rows < 0, 0, rows)
            o = 0
            for d in range(ndev):
                n = sel[d].size
                rows_per_d[d][sel[d]] = rows[o:o + n]
                o += n
        if grow_need > self.capacity:
            self._grow_to(grow_need)
        # request buckets: count per (d, s); slot (s == 0, i == 0) is null
        counts = np.zeros((ndev, ndev), dtype=np.int64)
        for d in range(ndev):
            counts[d] += np.bincount(owners[d], minlength=ndev)
        counts[:, 0] += 1
        R = self.req_buckets.bucket(max(int(counts.max()), 1))
        req_rows = np.zeros((ndev, ndev, R), dtype=np.int32)
        npad = keys.shape[1]
        inverse = np.zeros((ndev, npad), dtype=np.int32)
        for d in range(ndev):
            flatpos = np.zeros(uniqs[d].size, dtype=np.int32)
            for s in range(ndev):
                idxs = sels[d][s]
                base = 1 if s == 0 else 0
                pos = np.arange(idxs.size, dtype=np.int32) + base
                req_rows[d, s, pos] = rows_per_d[d][idxs]
                flatpos[idxs] = s * R + pos
            # padding and absent keys land on the null slot (flat pos 0)
            flatpos[uniqs[d] == 0] = 0
            flatpos[rows_per_d[d] == 0] = 0
            inverse[d] = flatpos[invs[d]]
        # serve plans: per owner, dedup the rows requested of it
        serve_u = []
        serve_i = np.zeros((ndev, ndev, R), dtype=np.int32)
        for s in range(ndev):
            u, inv = np.unique(req_rows[:, s, :].ravel(),
                               return_inverse=True)
            serve_u.append(u)
            serve_i[s] = inv.reshape(ndev, R).astype(np.int32)
        upad = self.uniq_buckets.bucket(max(max(u.size for u in serve_u), 1))
        serve_uniq = np.zeros((ndev, upad), dtype=np.int32)
        serve_mask = np.zeros((ndev, upad), dtype=np.float32)
        num_uniq = np.zeros(ndev, dtype=np.int64)
        for s in range(ndev):
            u = serve_u[s]
            serve_uniq[s, :u.size] = u
            serve_mask[s, :u.size] = (u > 0).astype(np.float32)
            num_uniq[s] = u.size
            if create:
                self._dirty[s][u] = True
                self._dirty[s][0] = False
        return MeshBatchIndex(req_rows=req_rows, inverse=inverse,
                              serve_uniq=serve_uniq, serve_mask=serve_mask,
                              serve_inverse=serve_i, num_uniq=num_uniq)

    def _prepare_batch_native(self, keys: np.ndarray,
                              create: bool) -> MeshBatchIndex:
        """The C++ planner's plan (``MeshPlanner``): serve lists in
        first-occurrence order, null row first."""
        old_sizes = list(self._sizes)
        (req_rows, inverse, serve_uniq, serve_mask, serve_inverse,
         num_uniq, new_sizes, _n_new) = self._planner.plan(
            self._indexes, keys, create,
            np.asarray(self._sizes, dtype=np.int64),
            self.req_buckets.bucket, self.uniq_buckets.bucket)
        if create:
            self._sizes = [int(s) for s in new_sizes]
            need = max(self._sizes)
            if need > self.capacity:
                self._grow_to(need)
            for s in range(self.ndev):
                u = serve_uniq[s, :int(num_uniq[s])]
                self._dirty[s][u] = True
                self._dirty[s][0] = False
            if self.mirror is not None:
                # the planner inserts without the mirror's records: resync
                # each shard it grew, so the device probe stays in step
                for s in range(self.ndev):
                    if self._sizes[s] != old_sizes[s]:
                        self.mirror.shards[s].sync()
        return MeshBatchIndex(req_rows=req_rows, inverse=inverse,
                              serve_uniq=serve_uniq, serve_mask=serve_mask,
                              serve_inverse=serve_inverse,
                              num_uniq=num_uniq)

    # -- the device index (device prep) --------------------------------------

    def enable_device_index(self) -> ShardedDeviceIndexMirror:
        """Mirror each shard's key index on its device, so that the fused
        sharded step dedups, routes and probes keys on the devices
        (``parallel/fused_dp_step.py`` ``device_prep``), and make each
        shard's dirty bitmap, miss ring and counts. Needs the native
        backend (the slot export)."""
        if self.mirror is not None:
            return self.mirror
        if self.backend != "native":
            raise RuntimeError("the mesh device index needs "
                               f"backend='native' (got {self.backend!r})")
        self.mirror = ShardedDeviceIndexMirror(self._indexes, self.mesh)
        self.dirty_dev = [torch.zeros(self.capacity, dtype=torch.bool,
                                      device=dev) for dev in self.devices]
        self.miss_ring = [torch.zeros(self.MISS_RING + 1, dtype=torch.int64,
                                      device=dev) for dev in self.devices]
        self.miss_cnt = [torch.zeros(2, dtype=torch.int64, device=dev)
                         for dev in self.devices]
        return self.mirror

    def ensure_keys(self, keys: np.ndarray) -> int:
        """Insert the non-zero keys that their owner's index lacks into it
        and into its mirror, before a run ships, so the device probe
        resolves every key and a new key trains on its first occurrence.
        Returns the count of new rows."""
        if self.mirror is None:
            raise RuntimeError("ensure_keys needs enable_device_index()")
        keys = np.ascontiguousarray(keys, dtype=np.uint64).reshape(-1)
        owners = shard_of(keys, self.ndev)
        staged, total_new = [], 0
        for s in range(self.ndev):
            ks = keys[owners == s]
            if not ks.size:
                continue
            missing = self._indexes[s].missing(ks)
            if not missing.size:
                continue
            (_, _, _, n_new, slots, hi, lo,
             rows) = self._indexes[s].prepare_dev(
                missing, True, skip_zero=True, next_row=self._sizes[s])
            self._sizes[s] += int(n_new)
            total_new += int(n_new)
            staged.append((s, slots, hi, lo, rows))
        if total_new:
            need = max(self._sizes)
            if need > self.capacity:
                self._grow_to(need)
            for s, slots, hi, lo, rows in staged:
                self._dirty[s][rows] = True
                self.mirror.shards[s].apply_updates(slots, hi, lo, rows)
        return total_new

    def poll_misses(self) -> Tuple[int, int]:
        """Drain every shard's miss ring synchronously and insert its keys
        (in ascending key order a shard). A drained key its shard's index
        already holds means the mirror missed an insert: that shard
        resyncs. Both counts are zeroed, in place, whenever either was
        non-zero. Returns (ring entries drained, request-bucket overflow
        count); the overflow adds to ``overflow_total``."""
        if self.miss_cnt is None:
            raise RuntimeError("poll_misses needs enable_device_index()")
        cnts = np.stack([c.cpu().numpy() for c in self.miss_cnt])
        drained = int(cnts[:, 0].sum())
        overflow = int(cnts[:, 1].sum())
        if drained:
            for s in range(self.ndev):
                n = int(cnts[s, 0])
                if not n:
                    continue
                ks = np.unique(self.miss_ring[s][:n].cpu().numpy()
                               .view(np.uint64))
                if self._indexes[s].missing(ks).size < ks.size:
                    self.mirror.shards[s].sync()
                self.ensure_keys(ks)
        if drained or overflow:
            for c in self.miss_cnt:
                c.zero_()
        self.overflow_total += overflow
        self._miss_snapshot = None
        return drained, overflow

    def _take_snapshot(self) -> None:
        """The shards' counts copied on the device into a buffer of their
        own and from there, without blocking, to pinned host memory behind
        a CUDA event."""
        dev0 = self.devices[0]
        if self._snap_bufs is None:
            cuda = dev0.type == "cuda"
            self._snap_bufs = (
                torch.empty(2 * self.ndev, dtype=torch.int64, device=dev0),
                torch.empty(2 * self.ndev, dtype=torch.int64,
                            pin_memory=True) if cuda else None,
                torch.cuda.Event() if cuda else None)
        buf, host, event = self._snap_bufs
        buf.copy_(torch.cat([c.to(dev0) for c in self.miss_cnt]))
        if host is None:
            self._miss_snapshot = buf
        else:
            host.copy_(buf, non_blocking=True)
            event.record()
            self._miss_snapshot = host

    def _snapshot_sum(self) -> int:
        event = self._snap_bufs[2]
        if event is not None:
            event.synchronize()
        return int(self._miss_snapshot.sum())

    def snapshot_shows_pending(self) -> bool:
        """Whether the lagged count snapshot shows ring entries or bucket
        overflow, i.e. whether a sync drain has anything to collect."""
        return self._miss_snapshot is not None and self._snapshot_sum() > 0

    def poll_misses_async(self) -> int:
        """The lagged drain: when the count snapshot taken at the previous
        call shows ring entries or overflow, ``poll_misses``; then a new
        snapshot. A step's misses so insert at the second poll after it.
        Returns the ring entries acted on."""
        if self.miss_cnt is None:
            raise RuntimeError("poll_misses_async needs "
                               "enable_device_index()")
        acted = 0
        if self.snapshot_shows_pending():
            acted, _ = self.poll_misses()
        self._take_snapshot()
        return acted

    # -- device-side ops (one owner shard) -----------------------------------

    def device_serve_pull(self, s: int, serve_uniq: torch.Tensor,
                          serve_inverse: torch.Tensor) -> torch.Tensor:
        """Owner side of the pull on shard ``s``: gather and gate its served
        rows once ([Upad, D]), expand to the per-requester layout
        [ndev, R, D] for the exchange."""
        uniq_vals = self.layout.pull(self.values[s], serve_uniq,
                                     self.state[s])
        return uniq_vals[serve_inverse.long()]

    def device_serve_push(self, s: int, grads: torch.Tensor,
                          serve_inverse: torch.Tensor,
                          serve_uniq: torch.Tensor, serve_mask: torch.Tensor,
                          merge=None, dirty: Optional[torch.Tensor] = None
                          ) -> None:
        """Owner side of the push on shard ``s``: merge the [ndev, R, D]
        grads of all requesters by served row and apply the in-table
        optimizer, in place (``ArenaLayout.push``)."""
        D = grads.shape[-1]
        self.layout.push(self.values[s], self.state[s],
                         grads.reshape(-1, D).contiguous(),
                         serve_inverse.reshape(-1), serve_uniq, serve_mask,
                         merge, dirty)

    # -- lifecycle -----------------------------------------------------------

    def __len__(self) -> int:
        return int(sum(self._sizes)) - self.ndev

    def shard_sizes(self) -> List[int]:
        return [s - 1 for s in self._sizes]

    def stats(self) -> Dict[str, Any]:
        """Counters for an operator: the overflow signal and each shard's
        fill, for skew."""
        return {"rows": len(self), "shard_sizes": self.shard_sizes(),
                "overflow_total": int(self.overflow_total),
                "capacity_per_shard": int(self.capacity)}

    def end_pass(self) -> None:
        """Decay show/clk by ``show_clk_decay`` on every shard, in place."""
        d = self.conf.show_clk_decay
        if d < 1.0:
            arenas = self.state if self.layout.stats_in_state else \
                self.values
            for a in arenas:
                a[:, :2] *= d

    def memory_bytes(self) -> int:
        return int(sum(v.nbytes + st.nbytes
                       for v, st in zip(self.values, self.state)))

    # -- persistence (the canonical f32 layout, interops with DeviceTable) --

    def _canonical(self, s: int, rows: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
        r = torch.from_numpy(rows.astype(np.int64)).to(self.devices[s])
        return self.layout.canonical_from_arena(
            self.values[s].index_select(0, r).float().cpu().numpy(),
            self.state[s].index_select(0, r).cpu().numpy())

    def _assemble_snapshot(self, keys_l, vals_l, st_l
                           ) -> Dict[str, np.ndarray]:
        if keys_l:
            return {"keys": np.concatenate(keys_l),
                    "values": np.concatenate(vals_l),
                    "state": np.concatenate(st_l)}
        return {"keys": np.empty(0, np.uint64),
                "values": np.empty((0, self.dim), np.float32),
                "state": np.empty((0, self.layout.canonical_state_dim),
                                  np.float32)}

    def _clear_dirty(self) -> None:
        self._dirty[:] = False
        if self.dirty_dev is not None:
            for bits in self.dirty_dev:
                bits.zero_()

    def _dirty_rows(self, s: int, n: int) -> np.ndarray:
        d = self._dirty[s][:n].copy()
        if self.dirty_dev is not None:
            d |= self.dirty_dev[s][:n].cpu().numpy()
        d[0] = False  # the null row never persists
        return np.flatnonzero(d)

    def snapshot(self) -> Dict[str, np.ndarray]:
        """Host copy of every shard's rows, shard by shard; clears the
        dirty marks."""
        keys_l, vals_l, st_l = [], [], []
        for s in range(self.ndev):
            n = self._sizes[s]
            if n <= 1:
                continue
            keys_l.append(self._indexes[s].dump_keys(n)[1:])
            v, st = self._canonical(s, np.arange(1, n))
            vals_l.append(v)
            st_l.append(st)
        self._clear_dirty()
        return self._assemble_snapshot(keys_l, vals_l, st_l)

    def snapshot_delta(self) -> Dict[str, np.ndarray]:
        """The rows touched since the last save (the host's marks OR each
        shard's device bitmap); clears the dirty marks."""
        keys_l, vals_l, st_l = [], [], []
        for s in range(self.ndev):
            n = self._sizes[s]
            rows = self._dirty_rows(s, n)
            if not rows.size:
                continue
            keys_l.append(self._indexes[s].dump_keys(n)[rows])
            v, st = self._canonical(s, rows)
            vals_l.append(v)
            st_l.append(st)
        self._clear_dirty()
        return self._assemble_snapshot(keys_l, vals_l, st_l)

    def snapshot_parts(self, delta: bool = False
                       ) -> Dict[str, Dict[str, np.ndarray]]:
        return {"": self.snapshot_delta() if delta else self.snapshot()}

    def save(self, path: str) -> None:
        write_npz(path, self.snapshot())

    def save_delta(self, path: str) -> int:
        """Write the delta snapshot; returns its row count."""
        snap = self.snapshot_delta()
        write_npz(path, snap)
        return int(snap["keys"].size)

    def _ingest(self, keys: np.ndarray, vals: np.ndarray,
                st: np.ndarray) -> None:
        # key 0 is the padding key: it never gets a row, and its -1 would
        # write an unrelated row
        if (keys == 0).any():
            live = keys != 0
            keys, vals, st = keys[live], vals[live], st[live]
            if not keys.size:
                return
        owners = shard_of(keys, self.ndev)
        vals, st = self.layout.arena_from_canonical(vals, st)
        # every row resolved (sizes grown) before the arenas are written,
        # so a growth cannot drop a pending write
        sels, rows_l = [], []
        for s in range(self.ndev):
            sel = np.flatnonzero(owners == s)
            rows, n_new = self._indexes[s].lookup(
                keys[sel], True, True, self._sizes[s])
            self._sizes[s] += n_new
            sels.append(sel)
            rows_l.append(rows)
        need = max(self._sizes)
        if need > self.capacity:
            self._grow_to(need)
        for s, dev in enumerate(self.devices):
            if not sels[s].size:
                continue
            r = torch.from_numpy(rows_l[s].astype(np.int64)).to(dev)
            self.values[s].index_copy_(0, r, torch.from_numpy(
                np.ascontiguousarray(vals[sels[s]], dtype=np.float32))
                .to(dev).to(self.value_dtype))
            if self.layout.state_dim:
                width = self.state[s].shape[1]
                self.state[s].index_copy_(0, r, torch.from_numpy(
                    np.ascontiguousarray(st[sels[s]][:, :width],
                                         dtype=np.float32)).to(dev))
        if self.mirror is not None:
            # the lookups wrote no mirror records: resync (a load is rare)
            self.mirror.sync()

    @staticmethod
    def _read(path: str):
        with np.load(path) as data:
            return (np.ascontiguousarray(data["keys"], dtype=np.uint64),
                    np.asarray(data["values"], dtype=np.float32),
                    np.asarray(data["state"], dtype=np.float32))

    def load(self, path: str) -> None:
        """Replace the table with a snapshot (of a sharded table or a
        ``DeviceTable``, of either package): fresh indexes and arenas,
        each key into its owner's; clears the dirty marks and the miss
        rings."""
        keys, vals, st = self._read(path)
        for s in range(self.ndev):
            self._indexes[s] = self._new_index()
            self._indexes[s].rebuild(
                np.array([_NULL_SENTINEL], dtype=np.uint64))
            self._sizes[s] = 1
        if self.mirror is not None:
            self.mirror = ShardedDeviceIndexMirror(self._indexes, self.mesh)
            for ring, cnt in zip(self.miss_ring, self.miss_cnt):
                ring.zero_()
                cnt.zero_()
            self._miss_snapshot = None
        self.values = self.state = None
        self.values, self.state = self._alloc(self.capacity)
        self._dirty[:] = False
        if keys.size:
            self._ingest(keys, vals, st)
        self._clear_dirty()

    def load_delta(self, path: str) -> None:
        """Apply a delta snapshot: new keys get rows in their owner's
        shard and every key's row is overwritten; as in the reference, no
        row is marked dirty."""
        keys, vals, st = self._read(path)
        if keys.size:
            self._ingest(keys, vals, st)
