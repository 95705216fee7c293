"""Embedding table resident in device memory (counterpart of
``paddlebox_tpu/ps/device_table.py``: ``DeviceBatchIndex``, ``ArenaLayout``
for the float32 arena, ``DeviceTable``).

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
``state``), which loads in either package.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch._device import DeviceLike, resolve_device
from paddlebox_tpu_torch.config import BucketSpec, TableConfig
from paddlebox_tpu_torch.ops import sparse_optim
from paddlebox_tpu_torch.ops.sparse_push import group_desc, sparse_push
from paddlebox_tpu_torch.ps import native
from paddlebox_tpu_torch.ps.device_index import DeviceIndexMirror
from paddlebox_tpu_torch.utils.checkpoint import write_npz

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
    """Value/state column layout and the pull/push math of the float32
    arena. Column groups ``(start, width, gated)``: embed_w (columns
    ``2:cvm_offset``), embedx and expand; each group's optimizer state sits
    at ``state_offsets[gi]``."""

    def __init__(self, conf: TableConfig):
        if conf.cvm_offset < 2:
            raise ValueError("cvm_offset must be >= 2 (show, clk)")
        if conf.variable_embedding:
            raise NotImplementedError(
                "variable_embedding arenas are not ported yet (ROADMAP A.2, "
                "bf16/int8/variable arenas)")
        self.conf = conf
        self.dim = conf.pull_dim
        self.groups = []
        col = 2
        if conf.cvm_offset - 2:
            self.groups.append((col, conf.cvm_offset - 2, False))
            col += conf.cvm_offset - 2
        if conf.embedx_dim:
            self.groups.append((col, conf.embedx_dim, True))
            col += conf.embedx_dim
        if conf.expand_dim:
            self.groups.append((col, conf.expand_dim, True))
        self.state_widths = [sparse_optim.state_width(conf, g[1])
                             for g in self.groups]
        self.state_offsets = np.cumsum([0] + self.state_widths)
        self.state_dim = int(self.state_offsets[-1])
        self.push_desc = group_desc(self)

    def alloc(self, cap: int, generator: torch.Generator,
              device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fresh arenas on ``device``: trainable columns uniform in
        ±initial_range, show/clk 0, row 0 all 0."""
        r = float(self.conf.initial_range)
        vals = torch.zeros((cap, self.dim), dtype=torch.float32,
                           device=device)
        if r > 0.0:
            vals.uniform_(-r, r, generator=generator)
        vals[:, :2] = 0.0
        vals[:1] = 0.0
        state = torch.zeros((cap, max(self.state_dim, 1)),
                            dtype=torch.float32, device=device)
        return vals, state

    def pull(self, values: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """``values[rows]`` with embedx gating: a gated group pulls zeros
        while the row's show is below ``embedx_threshold`` ([Npad, D])."""
        emb = values[rows.long()]
        show = emb[:, 0:1]
        out = [emb[:, :2]]
        for start, width, gated in self.groups:
            g = emb[:, start:start + width]
            if gated:
                g = torch.where(show >= self.conf.embedx_threshold, g,
                                g.new_zeros(()))
            out.append(g)
        return torch.cat(out, dim=1)

    def push(self, values: torch.Tensor, state: torch.Tensor,
             demb: torch.Tensor, inverse: torch.Tensor,
             uniq_rows: torch.Tensor, uniq_mask: torch.Tensor,
             merge: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Merge per-key grads by unique row and apply the in-table
        optimizer, in place (``ops.sparse_push``: the kernel on the card).
        ``merge``, the merge order (``order``, ``offsets``) when the caller
        has it (device-prep's dedup), saves the kernel's own sort."""
        return sparse_push(self, values, state, demb, inverse, uniq_rows,
                           uniq_mask, merge)


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
        if value_dtype != torch.float32:
            raise NotImplementedError(
                f"value_dtype {value_dtype}: only float32 arenas are ported "
                "yet (ROADMAP A.2, bf16/int8/variable arenas)")
        self.layout = ArenaLayout(conf)
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
        # the index's device mirror, for device-prep training
        self.mirror: Optional[DeviceIndexMirror] = None
        self._alloc_seq = 0
        self.values, self.state = self._alloc(self.capacity)

    # -- device arenas -------------------------------------------------------

    def _alloc(self, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
        self._alloc_seq += 1
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.conf.seed or 42) * 1009 + self._alloc_seq)
        return self.layout.alloc(cap, gen, self.device)

    def _grow_to(self, need: int) -> None:
        new_cap = self.capacity
        while new_cap < need:
            new_cap = int(new_cap * self.GROW)
        vals, state = self._alloc(new_cap)
        vals[:self.capacity] = self.values
        state[:self.capacity] = self.state
        self.values, self.state = vals, state
        self.capacity = new_cap

    def _add_rows(self, n_new: int) -> None:
        if n_new:
            if self._size + n_new > self.capacity:
                self._grow_to(self._size + n_new)
            self._size += n_new

    # -- device-resident index (device-prep training) ------------------------

    def enable_device_index(self) -> DeviceIndexMirror:
        """Mirror the key index on the table's device, so that a
        device-prep step dedups and resolves keys there
        (``trainer/fused_step.py`` ``device_prep``). Needs the native
        single-map index (slot export)."""
        if self.mirror is None:
            if not isinstance(self._index, native.NativeIndex):
                raise RuntimeError(
                    "device index needs backend='native' with "
                    f"index_threads<=1 (got {type(self._index).__name__})")
            self.mirror = DeviceIndexMirror(self._index, self.device)
        return self.mirror

    def insert_keys(self, keys: np.ndarray) -> int:
        """Insert ``keys`` (non-zero, new ones only) into the host index and
        the device mirror. Returns the count of new rows."""
        if self.mirror is None:
            raise RuntimeError("insert_keys needs enable_device_index()")
        _, _, _, n_new, slots, hi, lo, rows = self._index.prepare_dev(
            keys, True, skip_zero=True, next_row=self._size)
        self._add_rows(n_new)
        self.mirror.apply_updates(slots, hi, lo, rows)
        return int(n_new)

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

    def device_pull(self, values: torch.Tensor,
                    rows: torch.Tensor) -> torch.Tensor:
        """See ``ArenaLayout.pull``."""
        return self.layout.pull(values, rows)

    def device_push(self, values: torch.Tensor, state: torch.Tensor,
                    demb: torch.Tensor, inverse: torch.Tensor,
                    uniq_rows: torch.Tensor, uniq_mask: torch.Tensor,
                    merge: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """See ``ArenaLayout.push`` (in place)."""
        return self.layout.push(values, state, demb, inverse, uniq_rows,
                                uniq_mask, merge)

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
        """Decay show/clk by ``show_clk_decay``."""
        d = self.conf.show_clk_decay
        if d < 1.0:
            self.values[:, :2] *= d

    def memory_bytes(self) -> int:
        return int(self.values.nbytes + self.state.nbytes)

    def row_keys(self) -> np.ndarray:
        """[size] uint64: the key of each arena row (0 for row 0)."""
        out = self._index.dump_keys(self._size)
        out[0] = 0
        return out

    def load_arena(self, values: np.ndarray, state: np.ndarray,
                   row_keys: np.ndarray) -> None:
        """Take over another table's arena and index: ``values`` [cap, D],
        ``state`` [cap, max(state_dim, 1)] and ``row_keys`` [size], the key
        of each used row (``row_keys[0]``, the null row, is ignored). The
        reference's ``DeviceTable`` gives them as ``values``, ``state`` and
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
        self.values = torch.from_numpy(values.copy()).to(self.device)
        self.state = torch.from_numpy(state.copy()).to(self.device)

    # -- persistence ---------------------------------------------------------

    def snapshot(self) -> Dict[str, np.ndarray]:
        """Host copy of every used row in the canonical layout."""
        n = self._size
        return {"keys": self.row_keys()[1:],
                "values": self.values[1:n].cpu().numpy(),
                "state": self.state[1:n].cpu().numpy()}

    def save(self, path: str) -> None:
        write_npz(path, self.snapshot())

    def load(self, path: str) -> None:
        with np.load(path) as data:
            keys = np.ascontiguousarray(data["keys"], dtype=np.uint64)
            vals = np.asarray(data["values"], dtype=np.float32)
            st = np.asarray(data["state"], dtype=np.float32)
        n = keys.size + 1
        if vals.shape != (keys.size, self.dim) or \
                st.shape != (keys.size, max(self.state_dim, 1)):
            raise ValueError(
                f"snapshot of {keys.size} keys has values {vals.shape} and "
                f"state {st.shape}; expected D={self.dim}, "
                f"state_dim={self.state_dim}")
        if n > self.capacity:
            self._grow_to(n)
        # a warm table must not leak its old rows into later inserts
        if self._size > 1:
            self.values.zero_()
            self.state.zero_()
        self._rebuild(keys)
        self.values[1:n] = torch.from_numpy(vals).to(self.device)
        self.state[1:n] = torch.from_numpy(st).to(self.device)
