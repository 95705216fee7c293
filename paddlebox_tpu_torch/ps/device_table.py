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

The host index is a sorted ``uint64`` key array beside a row array, looked
up with ``np.searchsorted``. Rows are numbered exactly as the reference's
numpy backend numbers them: the batch's keys go through ``np.unique``, and
the new non-zero uniques take ``next_row + i`` in ascending unsigned key
order. So ``prepare_batch`` returns the same index arrays, bit for bit, as
``paddlebox_tpu``'s ``DeviceTable(conf, backend="numpy")``.

The arenas are updated in place by ``device_push`` (the reference returns
new arenas). Random init comes from a ``torch.Generator`` seeded from
``conf.seed``; it cannot reproduce ``jax.random`` bits, so ``load_arena``
carries a reference table's arena across for parity runs.

Snapshots use the canonical ``table.npz`` layout (``keys``, ``values``,
``state``), which loads in either package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch._device import DeviceLike, resolve_device
from paddlebox_tpu_torch.config import BucketSpec, TableConfig
from paddlebox_tpu_torch.ops import sparse_optim
from paddlebox_tpu_torch.ops.sparse_push import group_desc, sparse_push
from paddlebox_tpu_torch.utils.checkpoint import write_npz


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
             uniq_rows: torch.Tensor, uniq_mask: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Merge per-key grads by unique row and apply the in-table
        optimizer, in place (``ops.sparse_push``: the kernel on the card)."""
        return sparse_push(self, values, state, demb, inverse, uniq_rows,
                           uniq_mask)


class DeviceTable:
    """Value/state arenas on one device and the host key index.
    ``capacity`` rows are preallocated; the arenas double when they fill."""

    GROW = 2.0

    def __init__(self, conf: TableConfig, capacity: int = 1 << 20,
                 uniq_buckets: Optional[BucketSpec] = None,
                 device: DeviceLike = None,
                 value_dtype: torch.dtype = torch.float32):
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
        # the index: sorted keys and the row of each
        self._keys = np.zeros(0, dtype=np.uint64)
        self._rows = np.zeros(0, dtype=np.int64)
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

    # -- batch preparation (host) -------------------------------------------

    def _lookup(self, uniq: np.ndarray, create: bool
                ) -> Tuple[np.ndarray, int]:
        """Rows of the sorted unique keys ``uniq`` (-1 = absent). With
        ``create``, absent non-zero keys take rows ``_size + i`` in their
        (ascending) order and enter the index."""
        n = self._keys.size
        pos = np.searchsorted(self._keys, uniq)
        hit = pos < n
        hit[hit] = self._keys[pos[hit]] == uniq[hit]
        rows = np.full(uniq.size, -1, dtype=np.int64)
        rows[hit] = self._rows[pos[hit]]
        if not create:
            return rows, 0
        new = ~hit & (uniq != 0)
        n_new = int(new.sum())
        if n_new:
            rows[new] = self._size + np.arange(n_new, dtype=np.int64)
            self._keys = np.insert(self._keys, pos[new], uniq[new])
            self._rows = np.insert(self._rows, pos[new], rows[new])
        return rows, n_new

    def prepare_batch(self, keys: np.ndarray,
                      create: bool = True) -> DeviceBatchIndex:
        """Map a padded key array to arena rows + dedup index arrays."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        uniq, inverse = np.unique(keys, return_inverse=True)
        urows, n_new = self._lookup(uniq, create)
        urows = np.where(urows < 0, 0, urows).astype(np.int32)
        if n_new:
            if self._size + n_new > self.capacity:
                self._grow_to(self._size + n_new)
            self._size += n_new
        nu = uniq.size
        upad = self.uniq_buckets.bucket(max(int(nu), 1))
        uniq_rows = np.zeros(upad, dtype=np.int32)
        uniq_rows[:nu] = urows
        uniq_mask = np.zeros(upad, dtype=np.float32)
        uniq_mask[:nu] = (urows > 0).astype(np.float32)
        return DeviceBatchIndex(rows=urows[inverse],
                                inverse=inverse.astype(np.int32),
                                uniq_rows=uniq_rows, uniq_mask=uniq_mask,
                                num_uniq=int(nu))

    # -- device-side ops -----------------------------------------------------

    def device_pull(self, values: torch.Tensor,
                    rows: torch.Tensor) -> torch.Tensor:
        """See ``ArenaLayout.pull``."""
        return self.layout.pull(values, rows)

    def device_push(self, values: torch.Tensor, state: torch.Tensor,
                    demb: torch.Tensor, inverse: torch.Tensor,
                    uniq_rows: torch.Tensor, uniq_mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """See ``ArenaLayout.push`` (in place)."""
        return self.layout.push(values, state, demb, inverse, uniq_rows,
                                uniq_mask)

    # -- lifecycle -----------------------------------------------------------

    def _index_rows(self, keys: np.ndarray) -> None:
        """Index ``keys[i]`` at row ``i + 1``."""
        order = np.argsort(keys, kind="stable")
        self._keys = keys[order]
        self._rows = order.astype(np.int64) + 1

    def prepopulate(self, n_rows: int) -> None:
        """Replace the index with the sequential keys ``1..n_rows`` at rows
        ``1..n_rows`` (rows keep their random init): a table of realistic
        size without replaying history."""
        if n_rows + 1 > self.capacity:
            raise ValueError(
                f"{n_rows} rows exceed capacity {self.capacity}")
        self._keys = np.arange(1, n_rows + 1, dtype=np.uint64)
        self._rows = np.arange(1, n_rows + 1, dtype=np.int64)
        self._size = n_rows + 1

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
        out = np.zeros(self._size, dtype=np.uint64)
        out[self._rows] = self._keys
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
        self._index_rows(row_keys[1:])
        self._size = int(row_keys.size)
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
        self._index_rows(keys)
        # a warm table must not leak its old rows into later inserts
        if self._size > 1:
            self.values.zero_()
            self.state.zero_()
        self.values[1:n] = torch.from_numpy(vals).to(self.device)
        self.state[1:n] = torch.from_numpy(st).to(self.device)
        self._size = n
