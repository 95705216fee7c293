"""Embedding table resident in device memory (counterpart of
``paddlebox_tpu/ps/device_table.py``: ``DeviceBatchIndex``, ``ArenaLayout``
and ``DeviceTable``, with float32, bfloat16 and int8 value arenas and the
variable-width layout).

The value and state arenas live on the table's device; the host keeps only
the key -> row index. Row 0 is the null row: key 0 and unknown keys map
there, and it is masked out of every update. New keys take sequential
rows. The arena's trainable columns are randomized when it is allocated,
so inserting a key costs nothing on the device: it starts addressing a row
whose embed_w/embedx already hold their init, while show/clk start at 0.
The embedx columns stay gated (pull returns zeros, grads are dropped) until
the row's show count reaches ``embedx_threshold``.

The host index is one of two backends behind one small contract
(``lookup``, ``rebuild``, ``dump_keys``), resolved as the
reference resolves them (``paddlebox_tpu/ps/table.py:93-102``,
``device_table.py:343-350``):

- ``"native"``, where the C++ index core builds (``ps/native.py``): a
  ``NativeIndex``, or an ``MtIndex`` of ``index_threads`` maps when that is
  above 1. ``prepare_batch`` numbers a batch's uniques in first-occurrence
  order and gives new keys ``next_row + i``, bit for bit as the
  reference's ``DeviceTable(conf, backend="native")``. With
  ``enable_device_index`` the index gets a device mirror
  (``ps/device_index.py``), which device-prep training probes in the step.
- ``"numpy"``: ``SortedIndex``, a sorted ``uint64`` key array beside a row
  array, looked up with ``np.searchsorted``. The batch's keys go through
  ``np.unique``, and the new non-zero uniques take ``next_row + i`` in
  ascending unsigned key order, so ``prepare_batch`` returns the same index
  arrays, bit for bit, as the reference's ``backend="numpy"``.

A rebuilt index (``prepopulate``, ``load``, ``load_arena``) holds the
reserved key ``_NULL_SENTINEL`` at row 0, as the reference's does.

The arenas are updated in place by ``device_push`` (the reference returns
new arenas). Random init comes from a ``torch.Generator`` seeded from
``conf.seed``; it cannot reproduce ``jax.random`` bits, so ``load_arena``
carries a reference table's arena across for parity runs.

Snapshots use the canonical ``table.npz`` layout (``keys``, ``values``,
``state``: float32, show/clk in value columns 0, 1, int8 groups
dequantized, the state without the low-precision arenas' stat prefix),
which loads in either package and into a table of any value dtype.

Delta tracking, as the reference's: a row is dirty once a step or a load
touched it since the last save. The host marks ``_dirty`` [capacity] in
``insert_keys`` and ``prepare_batch(create=True)`` (host prep, a feed pass,
``load_delta``); a device-prep step marks ``dirty_dev``, a bool bitmap on
the table's device that ``enable_device_index`` makes, inside the push
kernel (``ops/sparse_push.py``), reading nothing back. ``fetch_dirty_rows``
ORs the two (one read of the bitmap), ``snapshot_delta`` copies those rows
to the host, and ``snapshot``, ``snapshot_delta`` and ``load`` clear both,
the bitmap in place, so that a captured run (``trainer/step_graph.py``)
goes on marking the same tensor. Row 0 never persists. As in the
reference, there is no ``mark_dirty``: the rows of a commit that fails are
not marked again.

Deferred insert (``insert_mode="deferred"``, the reference's own policy):
``enable_device_index`` also makes the device miss ring, ``miss_ring``
[MISS_RING + 1] int64 (slot ``MISS_RING`` is the overflow sink) and its
count ``miss_cnt`` [1] int64, both changed only in place. A device-prep
step appends the uniques it did not find (``record_misses``, torch ops on
the device that read nothing back), in unique order; ``poll_misses``
drains the ring into the index in ring order (so the ring's order numbers
the new rows), and ``poll_misses_async`` is the reference's lagged drain,
which reads back only a count copied at its previous call.

The tiered table (``ps/tiered_table.py``) stages rows through
``_ingest`` and writes them back through ``_canonical``, bounds the arena
by overriding ``_grow_to`` and re-randomizes it in place between passes
(``_rerandomize``); ``to_host_table`` copies a table into the host
``EmbeddingTable``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch._device import DeviceLike, resolve_device
from paddlebox_tpu_torch.ckpt.atomic import write_npz
from paddlebox_tpu_torch.config import BucketSpec, TableConfig
from paddlebox_tpu_torch.ops import sparse_optim
from paddlebox_tpu_torch.ops.sparse_push import group_desc, sparse_push
from paddlebox_tpu_torch.ps import native
from paddlebox_tpu_torch.ps.device_index import DeviceIndexMirror
from paddlebox_tpu_torch.ps.table import EmbeddingTable

# reserved key of the null row in a rebuilt index (a feature hash of 2^64 - 2
# would collide with it, as in the reference)
_NULL_SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFE)


@dataclasses.dataclass
class DeviceBatchIndex:
    """Host-prepared index arrays for one fused step."""

    rows: np.ndarray        # [Npad] int32 arena row per key (0 = null)
    inverse: np.ndarray     # [Npad] int32 position in uniq_rows
    uniq_rows: np.ndarray   # [Upad] int32 unique arena rows (0-padded)
    uniq_mask: np.ndarray   # [Upad] float32 1.0 for real (non-null) uniques
    num_uniq: int


class ArenaLayout:
    """Value/state column layout and the pull/push math of the arena, for
    ``value_dtype`` float32, bfloat16 or int8 (the reference's
    ``ArenaLayout(conf, value_dtype)``). Column groups ``(start, width,
    gated)``: embed_w (columns ``2:cvm_offset``), embedx and expand (or,
    under ``variable_embedding``, one union group of ``var_width``); each
    group's optimizer state sits at ``stat_off + state_offsets[gi]``.

    - float32: show/clk are value columns 0, 1; the state is the
      optimizer's alone (``stat_off`` 0).
    - bfloat16: show/clk live in float32 state columns 0, 1 (``stat_off``
      2), so counts stay exact; value columns 0, 1 are left as they are.
    - int8: as bfloat16, plus one float32 scale a group in state columns
      ``2 .. 2 + len(groups)`` (``stat_off``); a value is ``q * scale``,
      ``q`` in ``[-QMAX, QMAX]``, requantized to its group's max on every
      push of a live row. Value columns 0, 1 hold 0.
    - ``variable_embedding``: each row's embedx has either ``embedx_dim``
      (code 1) or ``expand_dim`` (code 2) columns, claimed by the first
      group whose merged grad is nonzero and kept in the trailing state
      column ``size_col`` (0 = unclaimed). The arena stores one union
      group, so ``dim`` (``2 + w + var_width``) is narrower than the pull
      and the grads (``grad_dim`` = ``pull_dim``); the pull routes it to
      the matching output group and zeros the other."""

    QMAX = 127.0
    VALUE_DTYPES = (torch.float32, torch.bfloat16, torch.int8)

    def __init__(self, conf: TableConfig,
                 value_dtype: torch.dtype = torch.float32):
        if conf.cvm_offset < 2:
            raise ValueError("cvm_offset must be >= 2 (show, clk)")
        if value_dtype not in self.VALUE_DTYPES:
            raise ValueError(f"value_dtype {value_dtype}: the arena takes "
                             "torch.float32, torch.bfloat16 or torch.int8")
        self.conf = conf
        self.dim = conf.pull_dim
        self.grad_dim = conf.pull_dim
        self.value_dtype = value_dtype
        self.stats_in_state = value_dtype != torch.float32
        self.quantized = value_dtype == torch.int8
        self.variable = bool(conf.variable_embedding)
        if self.variable and not (conf.embedx_dim and conf.expand_dim):
            raise ValueError(
                "variable_embedding needs embedx_dim and expand_dim > 0")
        self.groups = []
        col = 2
        if conf.cvm_offset - 2:
            self.groups.append((col, conf.cvm_offset - 2, False))
            col += conf.cvm_offset - 2
        self.var_width = 0
        if self.variable:
            self.var_width = max(conf.embedx_dim, conf.expand_dim)
            self.groups.append((col, self.var_width, True))
            col += self.var_width
            self.dim = col
        else:
            if conf.embedx_dim:
                self.groups.append((col, conf.embedx_dim, True))
                col += conf.embedx_dim
            if conf.expand_dim:
                self.groups.append((col, conf.expand_dim, True))
        self.state_widths = [sparse_optim.state_width(conf, g[1])
                             for g in self.groups]
        self.state_offsets = np.cumsum([0] + self.state_widths)
        self.stat_off = (2 + len(self.groups) if self.quantized
                         else 2 if self.stats_in_state else 0)
        self.state_dim = int(self.state_offsets[-1]) + self.stat_off
        self.size_col = -1
        if self.variable:
            self.size_col = self.state_dim
            self.state_dim += 1
        # the snapshot's state width: the state without its stat prefix
        self.canonical_state_dim = (self.state_dim - self.stat_off
                                    if self.stats_in_state
                                    else max(self.state_dim, 1))
        self.push_desc = group_desc(self)

    def row_bytes(self) -> Tuple[int, int]:
        """Bytes of one row's values and of its state."""
        return (self.dim * torch.empty((), dtype=self.value_dtype)
                .element_size(), 4 * max(self.state_dim, 1))

    def alloc(self, cap: int, generator: torch.Generator,
              device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fresh arenas on ``device``: trainable columns uniform in
        ±initial_range, show/clk 0, row 0 all 0."""
        vals = torch.zeros((cap, self.dim), dtype=self.value_dtype,
                           device=device)
        state = torch.zeros((cap, max(self.state_dim, 1)),
                            dtype=torch.float32, device=device)
        self.fill_(vals, state, generator)
        return vals, state

    def fill_(self, vals: torch.Tensor, state: torch.Tensor,
              generator: torch.Generator) -> None:
        """``alloc``'s contents written into existing arenas, in place. An
        int8 arena quantizes the uniform init at the shared scale
        ``max(initial_range, 1e-6) / QMAX`` and writes that scale into
        every group's scale column."""
        r = float(self.conf.initial_range)
        init = vals if vals.dtype == torch.float32 else torch.empty(
            vals.shape, dtype=torch.float32, device=vals.device)
        if r > 0.0:
            init.uniform_(-r, r, generator=generator)
        else:
            init.zero_()
        init[:, :2] = 0.0
        init[:1] = 0.0
        state.zero_()
        if self.quantized:
            scale = max(r, 1e-6) / self.QMAX
            state[:, 2:self.stat_off] = scale
            init = torch.clamp(torch.round(init / init.new_full((), scale)),
                               -self.QMAX, self.QMAX)
        if init is not vals:
            vals.copy_(init)

    def pull(self, values: torch.Tensor, rows: torch.Tensor,
             state: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``values[rows]`` as float32 with embedx gating: a gated group
        pulls zeros while the row's show is below ``embedx_threshold``
        ([Npad, pull_dim]). A low-precision arena needs ``state``: show/clk
        come from its float32 columns, an int8 group is dequantized by its
        scale, and a variable row's union group goes to the output group
        its size code names (the other, and an unclaimed row's, pull
        zeros)."""
        rows = rows.long()
        emb = values[rows].float()
        if self.stats_in_state or self.variable:
            if state is None:
                raise ValueError("a low-precision or variable arena needs "
                                 "state for pull")
            srows = state[rows]
        stats = srows[:, :2] if self.stats_in_state else emb[:, :2]
        show = stats[:, 0:1]
        zero = emb.new_zeros(())
        out = [stats]
        for gi, (start, width, gated) in enumerate(self.groups):
            g = emb[:, start:start + width]
            if self.quantized:
                g = g * srows[:, 2 + gi:3 + gi]
            if gated:
                g = torch.where(show >= self.conf.embedx_threshold, g, zero)
            if self.variable and gated:
                code = srows[:, self.size_col:self.size_col + 1]
                out.append(torch.where(code == 1.0,
                                       g[:, :self.conf.embedx_dim], zero))
                out.append(torch.where(code == 2.0,
                                       g[:, :self.conf.expand_dim], zero))
            else:
                out.append(g)
        return torch.cat(out, dim=1)

    def push(self, values: torch.Tensor, state: torch.Tensor,
             demb: torch.Tensor, inverse: torch.Tensor,
             uniq_rows: torch.Tensor, uniq_mask: torch.Tensor,
             merge: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
             dirty: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Merge per-key grads by unique row and apply the in-table
        optimizer, in place (``ops.sparse_push``: the kernel on the card).
        ``merge``, the merge order (``order``, ``offsets``) when the caller
        has it (device-prep's dedup), saves the kernel's own sort;
        ``dirty``, the device dirty bitmap, gets every unique's row
        marked."""
        return sparse_push(self, values, state, demb, inverse, uniq_rows,
                           uniq_mask, merge, dirty)

    # -- the canonical snapshot layout (saves interoperate across dtypes) --

    def canonical_from_arena(self, vals: np.ndarray, st: np.ndarray
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """Arena rows (values as float32) and their state -> the canonical
        float32 snapshot layout: show/clk in value columns 0, 1, int8
        groups dequantized, the state without its stat/scale prefix."""
        vals = np.asarray(vals, dtype=np.float32).copy()
        st = np.asarray(st, dtype=np.float32)
        if self.quantized:
            for gi, (start, width, _) in enumerate(self.groups):
                vals[:, start:start + width] *= st[:, 2 + gi:3 + gi]
        if self.stats_in_state:
            vals[:, :2] = st[:, :2]
            st = st[:, self.stat_off:]
        return vals, st

    def arena_from_canonical(self, vals: np.ndarray, st: np.ndarray
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """Inverse of ``canonical_from_arena``: (arena values as float32,
        the full state). An int8 arena's values come back as the quantized
        integers (each group at the scale of its max), which the caller
        casts."""
        vals = np.asarray(vals, dtype=np.float32)
        st = np.asarray(st, dtype=np.float32)
        if not self.stats_in_state:
            return vals, st
        pre = [vals[:, :2]]
        body = vals.copy()
        body[:, :2] = 0.0
        if self.quantized:
            for start, width, _ in self.groups:
                g = body[:, start:start + width]
                s = (np.maximum(np.abs(g).max(axis=1), np.float32(1e-12))
                     / np.float32(self.QMAX))
                pre.append(s[:, None].astype(np.float32))
                body[:, start:start + width] = np.clip(
                    np.round(g / s[:, None]), -self.QMAX, self.QMAX)
        return body, np.concatenate(pre + [st], axis=1)


def resolve_backend(backend: Optional[str]) -> str:
    """``None`` -> ``"native"`` where the index core builds, else
    ``"numpy"``; an explicit ``"native"`` that cannot build raises."""
    if backend is None:
        return "native" if native.available() else "numpy"
    if backend == "native" and not native.available():
        raise RuntimeError(
            f"backend='native' but the index core is unavailable: "
            f"{native.build_error()}")
    if backend not in ("native", "numpy"):
        raise ValueError(f"unknown index backend {backend!r}")
    return backend


class SortedIndex:
    """The numpy backend: sorted ``uint64`` keys beside their rows (the
    ``NativeIndex`` contract: ``lookup``, ``rebuild``, ``dump_keys``)."""

    def __init__(self):
        self._keys = np.zeros(0, dtype=np.uint64)
        self._rows = np.zeros(0, dtype=np.int64)

    def __len__(self) -> int:
        return int(self._keys.size)

    def lookup(self, keys: np.ndarray, create: bool, skip_zero: bool,
               next_row: int) -> Tuple[np.ndarray, int]:
        """Rows of ``keys``, strictly increasing as ``np.unique`` returns
        them (-1 = absent). With ``create`` the absent keys (not key 0
        under ``skip_zero``) take rows ``next_row + i`` in ascending key
        order. Returns (rows int64, n_new)."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        if keys.size > 1 and not bool((keys[1:] > keys[:-1]).all()):
            raise ValueError("SortedIndex.lookup takes strictly increasing "
                             "keys")
        pos = np.searchsorted(self._keys, keys)
        hit = pos < self._keys.size
        hit[hit] = self._keys[pos[hit]] == keys[hit]
        rows = np.full(keys.size, -1, dtype=np.int64)
        rows[hit] = self._rows[pos[hit]]
        if not create:
            return rows, 0
        new = ~hit & (keys != 0) if skip_zero else ~hit
        n_new = int(new.sum())
        if n_new:
            rows[new] = next_row + np.arange(n_new, dtype=np.int64)
            self._keys = np.insert(self._keys, pos[new], keys[new])
            self._rows = np.insert(self._rows, pos[new], rows[new])
        return rows, n_new

    def rebuild(self, keys: np.ndarray) -> None:
        """``keys[i] -> row i``; a duplicate keeps its first row."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        order = np.argsort(keys, kind="stable")
        sk = keys[order]
        keep = np.ones(sk.size, dtype=bool)
        keep[1:] = sk[1:] != sk[:-1]
        self._keys = sk[keep]
        self._rows = order[keep].astype(np.int64)

    def dump_keys(self, n: int) -> np.ndarray:
        """[n] uint64: the key of each row below ``n`` (0 where none)."""
        out = np.zeros(n, dtype=np.uint64)
        used = self._rows < n
        out[self._rows[used]] = self._keys[used]
        return out


class DeviceTable:
    """Value/state arenas on one device and the host key index.
    ``capacity`` rows are preallocated; the arenas double when they fill.
    ``backend`` and ``index_threads`` pick the index as the reference does
    (``index_threads=0``: ``min(4, os.cpu_count())``)."""

    GROW = 2.0

    def __init__(self, conf: TableConfig, capacity: int = 1 << 20,
                 uniq_buckets: Optional[BucketSpec] = None,
                 device: DeviceLike = None,
                 value_dtype: torch.dtype = torch.float32,
                 backend: Optional[str] = None, index_threads: int = 0):
        self.layout = ArenaLayout(conf, value_dtype)
        self.value_dtype = value_dtype
        self.conf = conf
        self.dim = self.layout.dim
        self.state_dim = self.layout.state_dim
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.uniq_buckets = uniq_buckets or BucketSpec(min_size=1024)
        self._size = 1  # row 0 reserved for padding/null
        self.backend = resolve_backend(backend)
        if self.backend == "native":
            if index_threads == 0:
                index_threads = min(4, os.cpu_count() or 1)
            self._index = (native.MtIndex(index_threads)
                           if index_threads > 1 else native.NativeIndex())
        else:
            self._index = SortedIndex()
        # the index's device mirror and the device dirty bitmap, for
        # device-prep training
        self.mirror: Optional[DeviceIndexMirror] = None
        self.dirty_dev: Optional[torch.Tensor] = None
        # the device miss ring and its count (deferred insert), and the
        # count snapshot of the lagged drain
        self.miss_ring: Optional[torch.Tensor] = None
        self.miss_cnt: Optional[torch.Tensor] = None
        self._miss_snapshot: Optional[torch.Tensor] = None
        self._snap_bufs = None
        # rows touched since the last save (host-side marks)
        self._dirty = np.zeros(self.capacity, dtype=bool)
        self._alloc_seq = 0
        self.values, self.state = self._alloc(self.capacity)

    # -- device arenas -------------------------------------------------------

    def _generator(self) -> torch.Generator:
        """The next arena init's generator (one seed an allocation)."""
        self._alloc_seq += 1
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.conf.seed or 42) * 1009 + self._alloc_seq)
        return gen

    def _alloc(self, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.layout.alloc(cap, self._generator(), self.device)

    def _rerandomize(self) -> None:
        """A fresh init into the arenas, in place (their addresses, and so
        a captured run over them, stay)."""
        self.layout.fill_(self.values, self.state, self._generator())

    def _grow_to(self, need: int) -> None:
        """Double the arenas (and the dirty marks) until ``need`` rows fit.
        Every insert grows through here; a bounded table overrides it."""
        new_cap = self.capacity
        while new_cap < need:
            new_cap = int(new_cap * self.GROW)
        vals, state = self._alloc(new_cap)
        vals[:self.capacity] = self.values
        state[:self.capacity] = self.state
        self.values, self.state = vals, state
        dirty = np.zeros(new_cap, dtype=bool)
        dirty[:self.capacity] = self._dirty
        self._dirty = dirty
        if self.dirty_dev is not None:
            dev = torch.zeros(new_cap, dtype=torch.bool, device=self.device)
            dev[:self.capacity] = self.dirty_dev
            self.dirty_dev = dev
        self.capacity = new_cap

    def _add_rows(self, n_new: int) -> None:
        if n_new:
            if self._size + n_new > self.capacity:
                self._grow_to(self._size + n_new)
            self._size += n_new

    # -- device-resident index (device-prep training) ------------------------

    # entries of the device miss ring; tests make it smaller
    MISS_RING = 1 << 20

    def enable_device_index(self) -> DeviceIndexMirror:
        """Mirror the key index on the table's device, so that a
        device-prep step dedups and resolves keys there
        (``trainer/fused_step.py`` ``device_prep``), and make the device
        dirty bitmap that the step marks and the miss ring with its count.
        Needs the native single-map index (slot export)."""
        if self.mirror is None:
            if not isinstance(self._index, native.NativeIndex):
                raise RuntimeError(
                    "device index needs backend='native' with "
                    f"index_threads<=1 (got {type(self._index).__name__})")
            self.mirror = DeviceIndexMirror(self._index, self.device)
            self.dirty_dev = torch.zeros(self.capacity, dtype=torch.bool,
                                         device=self.device)
            # slot MISS_RING is the overflow sink (a dropped miss recurs
            # at its key's next occurrence)
            self.miss_ring = torch.zeros(self.MISS_RING + 1,
                                         dtype=torch.int64,
                                         device=self.device)
            self.miss_cnt = torch.zeros(1, dtype=torch.int64,
                                        device=self.device)
        return self.mirror

    def record_misses(self, uniq_keys: torch.Tensor, found: torch.Tensor,
                      n_uniq: torch.Tensor) -> None:
        """Append a step's misses to the ring, in place and on the device
        (nothing is read back, so a captured run appends at each replay):
        a miss is a unique below ``n_uniq`` that the probe did not find and
        is not key 0. Misses go in unique order to ``count + i``; those
        past the ring land in the sink, and the count stops at the ring's
        size (the reference's ``fused_step.py`` append)."""
        cap = self.miss_ring.shape[0] - 1
        live = torch.arange(uniq_keys.shape[0],
                            device=uniq_keys.device) < n_uniq
        miss = live & ~found & (uniq_keys != 0)
        m = miss.long()
        idx = self.miss_cnt + torch.cumsum(m, 0) - 1
        pos = torch.where(miss & (idx < cap), idx, cap)
        self.miss_ring.index_put_((pos,), uniq_keys)
        self.miss_cnt.copy_(torch.clamp(self.miss_cnt + m.sum(), max=cap))

    def poll_misses(self) -> int:
        """Drain the ring synchronously (one blocking read of the count):
        insert its first ``n`` entries through ``insert_keys``, admission
        gate included, in ring order, and zero the count in place. Drops
        the lagged snapshot. Returns ``n``, before dedup."""
        if self.miss_cnt is None:
            raise RuntimeError("poll_misses needs enable_device_index()")
        n = int(self.miss_cnt[0])
        if n:
            self.insert_keys(self.miss_ring[:n].cpu().numpy().view(
                np.uint64))
            self.miss_cnt.zero_()
        self._miss_snapshot = None
        return n

    def poll_misses_async(self) -> int:
        """The lagged drain: when the count snapshot taken at the previous
        call (its copy long finished) is non-zero, ``poll_misses``; then
        take a new snapshot: the count copied on the device into a buffer
        of its own, and from there, without blocking, into pinned host
        memory behind a CUDA event. A step's misses so insert at the second
        poll after it. Returns the entries acted on."""
        inserted = 0
        if self._miss_snapshot is not None and self._snapshot_count():
            inserted = self.poll_misses()
        self._take_snapshot()
        return inserted

    def _take_snapshot(self) -> None:
        if self._snap_bufs is None:
            cuda = self.miss_cnt.is_cuda
            self._snap_bufs = (
                torch.empty_like(self.miss_cnt),
                torch.empty(1, dtype=torch.int64, pin_memory=True)
                if cuda else None,
                torch.cuda.Event() if cuda else None)
        dev, host, event = self._snap_bufs
        dev.copy_(self.miss_cnt)
        if host is None:
            self._miss_snapshot = dev
        else:
            host.copy_(dev, non_blocking=True)
            event.record()
            self._miss_snapshot = host

    def _snapshot_count(self) -> int:
        event = self._snap_bufs[2]
        if event is not None:
            event.synchronize()
        return int(self._miss_snapshot[0])

    def _gate_new_keys(self, keys: np.ndarray) -> np.ndarray:
        """Admission hook on the insert paths (``prepare_batch`` with
        ``create``, ``insert_keys``): a table with frequency admission
        (``TieredDeviceTable``) maps new keys not yet admitted to the
        padding key 0, which takes the null row (pulls zeros, its pushes
        dropped, no insert). This table admits every key."""
        return keys

    def admits_every_key(self) -> bool:
        """Whether ``_gate_new_keys`` passes every key: then an "ensure"
        step, whose new keys are all inserted before it, misses none."""
        return True

    def insert_keys(self, keys: np.ndarray) -> int:
        """Insert ``keys`` (non-zero, new ones only) into the host index and
        the device mirror, numbered in first-occurrence order: "ensure"
        mode's insert before a step, and the ring's drain in deferred mode.
        Returns the count of new rows."""
        if self.mirror is None:
            raise RuntimeError("insert_keys needs enable_device_index()")
        keys = self._gate_new_keys(np.ascontiguousarray(keys,
                                                        dtype=np.uint64))
        _, _, _, n_new, slots, hi, lo, rows = self._index.prepare_dev(
            keys, True, skip_zero=True, next_row=self._size)
        self._add_rows(n_new)
        if n_new:
            self._dirty[rows] = True
        self.mirror.apply_updates(slots, hi, lo, rows)
        return int(n_new)

    def fetch_dirty_rows(self) -> np.ndarray:
        """Rows touched since the last save, ascending: the host marks OR
        the device bitmap (one read of it, which waits for the queued
        steps). Row 0 never persists."""
        n = self._size
        dirty = self._dirty[:n].copy()
        if self.dirty_dev is not None:
            dirty |= self.dirty_dev[:n].cpu().numpy()
        dirty[0] = False
        return np.flatnonzero(dirty)

    def _clear_dirty(self) -> None:
        """Clear both marks; the bitmap in place (a captured run keeps
        marking the same tensor)."""
        self._dirty[:] = False
        if self.dirty_dev is not None:
            self.dirty_dev.zero_()

    def ensure_keys(self, keys: np.ndarray) -> int:
        """Insert the batch's non-zero keys that the index lacks before the
        batch ships (a block-prefetched C++ membership scan, then
        ``insert_keys``), so the device probe resolves every key and a new
        key trains on its first occurrence. Returns the count of new
        rows."""
        if self.mirror is None:
            raise RuntimeError("ensure_keys needs enable_device_index()")
        missing = self._index.missing(keys)
        return self.insert_keys(missing) if missing.size else 0

    # -- batch preparation (host) -------------------------------------------

    def prepare_batch(self, keys: np.ndarray,
                      create: bool = True) -> DeviceBatchIndex:
        """Map a padded key array to arena rows + dedup index arrays."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        if create:
            keys = self._gate_new_keys(keys)
        if self.backend == "native":
            if self.mirror is not None and create:
                # keep the device mirror in lockstep with the inserts
                (rows, inverse, urows, n_new, slots, his, los,
                 nrows) = self._index.prepare_dev(
                    keys, True, skip_zero=True, next_row=self._size)
                self.mirror.apply_updates(slots, his, los, nrows)
            else:
                rows, inverse, urows, n_new = self._index.prepare(
                    keys, create, skip_zero=True, next_row=self._size)
        else:
            uniq, inverse = np.unique(keys, return_inverse=True)
            urows, n_new = self._index.lookup(uniq, create, skip_zero=True,
                                              next_row=self._size)
            urows = np.where(urows < 0, 0, urows).astype(np.int32)
            rows = urows[inverse]
        self._add_rows(n_new)
        if create:
            self._dirty[urows] = True
            self._dirty[0] = False
        nu = urows.size
        upad = self.uniq_buckets.bucket(max(int(nu), 1))
        uniq_rows = np.zeros(upad, dtype=np.int32)
        uniq_rows[:nu] = urows
        uniq_mask = np.zeros(upad, dtype=np.float32)
        uniq_mask[:nu] = (urows > 0).astype(np.float32)
        return DeviceBatchIndex(rows=rows.astype(np.int32, copy=False),
                                inverse=inverse.astype(np.int32,
                                                       copy=False),
                                uniq_rows=uniq_rows, uniq_mask=uniq_mask,
                                num_uniq=int(nu))

    # -- device-side ops -----------------------------------------------------

    def device_pull(self, values: torch.Tensor, rows: torch.Tensor,
                    state: Optional[torch.Tensor] = None) -> torch.Tensor:
        """See ``ArenaLayout.pull``."""
        return self.layout.pull(values, rows, state)

    def device_push(self, values: torch.Tensor, state: torch.Tensor,
                    demb: torch.Tensor, inverse: torch.Tensor,
                    uniq_rows: torch.Tensor, uniq_mask: torch.Tensor,
                    merge: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    dirty: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """See ``ArenaLayout.push`` (in place)."""
        return self.layout.push(values, state, demb, inverse, uniq_rows,
                                uniq_mask, merge, dirty)

    # -- lifecycle -----------------------------------------------------------

    def _rebuild(self, keys: np.ndarray) -> None:
        """Index ``keys[i]`` at row ``i + 1``, the sentinel at row 0."""
        self._index.rebuild(np.concatenate([
            np.array([_NULL_SENTINEL], dtype=np.uint64),
            np.ascontiguousarray(keys, dtype=np.uint64)]))
        self._size = int(keys.size) + 1
        if self.mirror is not None:
            self.mirror.sync()

    def prepopulate(self, n_rows: int) -> None:
        """Replace the index with the sequential keys ``1..n_rows`` at rows
        ``1..n_rows`` (rows keep their random init): a table of realistic
        size without replaying history."""
        if n_rows + 1 > self.capacity:
            raise ValueError(
                f"{n_rows} rows exceed capacity {self.capacity}")
        self._rebuild(np.arange(1, n_rows + 1, dtype=np.uint64))

    def __len__(self) -> int:
        return self._size - 1

    def end_pass(self) -> None:
        """Decay show/clk by ``show_clk_decay`` where they live: the value
        columns of a float32 arena, the state's of a low-precision one."""
        d = self.conf.show_clk_decay
        if d < 1.0:
            arena = self.state if self.layout.stats_in_state else self.values
            arena[:, :2] *= d

    def memory_bytes(self) -> int:
        return int(self.values.nbytes + self.state.nbytes)

    def row_keys(self) -> np.ndarray:
        """[size] uint64: the key of each arena row (0 for row 0)."""
        out = self._index.dump_keys(self._size)
        out[0] = 0
        return out

    def load_arena(self, values: np.ndarray, state: np.ndarray,
                   row_keys: np.ndarray) -> None:
        """Take over another table's arena and index: ``values`` [cap, D]
        of the table's value dtype (a bfloat16 or int8 arena goes through
        float32, which holds either exactly), ``state`` [cap, max(state_dim,
        1)] and ``row_keys`` [size], the key of each used row
        (``row_keys[0]``, the null row, is ignored). The reference's
        ``DeviceTable`` gives them as ``values``, ``state`` and
        ``_index.dump_keys(_size)``; this starts both packages from the
        same rows."""
        values = np.asarray(values, dtype=np.float32)
        state = np.asarray(state, dtype=np.float32)
        row_keys = np.ascontiguousarray(row_keys, dtype=np.uint64)
        cap = values.shape[0]
        if values.shape != (cap, self.dim) or \
                state.shape != (cap, max(self.state_dim, 1)):
            raise ValueError(
                f"arena values {values.shape} / state {state.shape} do not "
                f"fit D={self.dim}, state_dim={self.state_dim}")
        if not 1 <= row_keys.size <= cap:
            raise ValueError(f"{row_keys.size} used rows for capacity {cap}")
        self._rebuild(row_keys[1:])
        self.capacity = cap
        self.values = torch.from_numpy(values.copy()).to(self.device).to(
            self.value_dtype)
        self.state = torch.from_numpy(state.copy()).to(self.device)
        self._dirty = np.zeros(cap, dtype=bool)
        if self.dirty_dev is not None:
            self.dirty_dev = torch.zeros(cap, dtype=torch.bool,
                                         device=self.device)

    # -- persistence ---------------------------------------------------------

    def _canonical(self, rows: torch.Tensor
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Host copies of the arena rows ``rows`` (int64 on the table's
        device) in the canonical snapshot layout (``ArenaLayout.
        canonical_from_arena``; a float32 arena already is it): values
        [n, D], state [n, canonical_state_dim]. Copies on the CPU too, so
        later steps do not change them."""
        vals = self.values.index_select(0, rows).float().cpu().numpy()
        st = self.state.index_select(0, rows).cpu().numpy()
        if self.layout.stats_in_state:
            return self.layout.canonical_from_arena(vals, st)
        return vals, st

    def _ingest(self, rows: torch.Tensor, vals: np.ndarray,
                st: np.ndarray) -> None:
        """Write canonical-layout rows into the arenas at ``rows`` (int64 on
        the table's device), in place. A state of the host table's width
        (0 columns under sgd) fills the arena's state columns it has. Rows
        of another width than the arena's raise ``ValueError``, as the
        reference's broadcast does (a variable arena over a host backing
        of the fixed layout)."""
        if vals.shape[1] != self.dim:
            raise ValueError(
                f"rows of {vals.shape[1]} value columns do not fit the "
                f"arena's {self.dim}")
        dev = self.device
        vals, st = self.layout.arena_from_canonical(vals, st)
        self.values.index_copy_(
            0, rows, torch.from_numpy(np.ascontiguousarray(
                vals, dtype=np.float32)).to(dev).to(self.value_dtype))
        if self.state_dim:
            self.state.index_copy_(
                0, rows, torch.from_numpy(np.ascontiguousarray(
                    st[:, :self.state.shape[1]], dtype=np.float32)).to(dev))

    def to_host_table(self):
        """The table as a host ``EmbeddingTable`` (``ps/table.py``) of the
        same backend: every key with its values and state, ``embedx_ok``
        where show has reached the threshold."""
        t = EmbeddingTable(self.conf, backend=self.backend)
        n = self._size
        if n > 1:
            keys = self._index.dump_keys(n)[1:]
            t.feed_pass(keys)
            vals, st = self._canonical(
                torch.arange(1, n, dtype=torch.int64, device=self.device))
            # the host table numbers its rows in its own (sorted) order
            with t._lock:
                hrows = t._index.lookup(keys, False, True, 0)[0]
                t._values[hrows] = vals
                t._state[hrows] = st
                t._embedx_ok[hrows] = \
                    vals[:, 0] >= self.conf.embedx_threshold
        return t

    def snapshot(self) -> Dict[str, np.ndarray]:
        """Host copy of every used row in the canonical layout (a copy on
        the CPU too, so later steps do not change it); clears the dirty
        marks. The copy half of an asynchronous save."""
        vals, st = self._canonical(
            torch.arange(1, self._size, dtype=torch.int64,
                         device=self.device))
        snap = {"keys": self.row_keys()[1:], "values": vals, "state": st}
        self._clear_dirty()
        return snap

    def snapshot_delta(self) -> Dict[str, np.ndarray]:
        """Host copy of the rows touched since the last save (only they
        cross to the host); clears the dirty marks."""
        rows = self.fetch_dirty_rows()
        vals, st = self._canonical(torch.from_numpy(rows).to(self.device))
        snap = {"keys": self.row_keys()[rows], "values": vals, "state": st}
        self._clear_dirty()
        return snap

    def snapshot_parts(self, delta: bool = False
                       ) -> Dict[str, Dict[str, np.ndarray]]:
        """The snapshot files of a save, by name suffix (one here)."""
        return {"": self.snapshot_delta() if delta else self.snapshot()}

    def save(self, path: str) -> None:
        write_npz(path, self.snapshot())

    def save_delta(self, path: str) -> int:
        """Write the delta snapshot; returns its row count."""
        snap = self.snapshot_delta()
        write_npz(path, snap)
        return int(snap["keys"].size)

    def _read_snapshot(self, path: str):
        with np.load(path) as data:
            keys = np.ascontiguousarray(data["keys"], dtype=np.uint64)
            vals = np.asarray(data["values"], dtype=np.float32)
            st = np.asarray(data["state"], dtype=np.float32)
        # a canonical state of no columns (a low-precision arena under sgd)
        # is saved as 0 or 1 columns
        sw = self.layout.canonical_state_dim
        if vals.shape != (keys.size, self.dim) or st.ndim != 2 or \
                st.shape[0] != keys.size or st.shape[1] not in (sw,
                                                                max(sw, 1)):
            raise ValueError(
                f"snapshot of {keys.size} keys has values {vals.shape} and "
                f"state {st.shape}; expected D={self.dim} and {sw} state "
                "columns")
        return keys, vals, st

    def load_delta(self, path: str) -> None:
        """Apply a delta snapshot: its keys go through
        ``prepare_batch(create=True)`` (new ones get rows, all are marked
        dirty, as in the reference), then their rows are overwritten."""
        keys, vals, st = self._read_snapshot(path)
        if not keys.size:
            return
        rows = torch.from_numpy(
            self.prepare_batch(keys, create=True).rows.astype(np.int64))
        self._ingest(rows.to(self.device), vals, st)

    def load(self, path: str) -> None:
        """Replace the table with a snapshot; clears the dirty marks."""
        keys, vals, st = self._read_snapshot(path)
        n = keys.size + 1
        if n > self.capacity:
            self._grow_to(n)
        # a warm table must not leak its old rows into later inserts
        if self._size > 1:
            self.values.zero_()
            self.state.zero_()
        self._rebuild(keys)
        self._ingest(torch.arange(1, n, dtype=torch.int64,
                                  device=self.device), vals, st)
        self._clear_dirty()
        # misses a stream reported before the load would insert keys the
        # loaded index never saw
        if self.miss_ring is not None:
            self.miss_ring.zero_()
            self.miss_cnt.zero_()
        self._miss_snapshot = None
