"""The host embedding table, the DRAM tier (counterpart of
``paddlebox_tpu/ps/table.py``: ``_PyIndex``, ``key_init_uniform`` and
``EmbeddingTable``).

One table is one feature space. Its values live in a growable host float32
arena indexed by a key index; the arenas are numpy, as in the reference.
Value layout of a feature:

    [show, clk, embed_w..., embedx(embedx_dim), expand(expand_dim)]

- show/clk (columns 0, 1) are counters: push adds the grad's first two
  columns (the CVM-grad convention, ``ops/seqpool_cvm.py``);
- ``embed_w`` (columns 2:cvm_offset) trains from creation;
- embedx and expand materialize once the show count reaches
  ``embedx_threshold``: until then pull returns zeros for them and push
  drops their grads;
- key 0 is the padding feasign (``PBOX_FLAGS_enable_pull_padding_zero``,
  on by default): pull returns zeros, push skips it.

A feature's initial weights come from ``key_init_uniform``, a function of
its key alone, so every tier (this table, the tiered table's staging, a
later pass) creates a key with the same bits in either package.

Backends, resolved as the reference's ``embedding_backend`` flag resolves
them (``PBOX_FLAGS_embedding_backend`` = auto | native | numpy): the key
index, the dedup, the grad merge and the row gathers run in C++
(``csrc/pbx_index.cpp`` through ``ps/native.py``) where it builds, else in
numpy over a dict index. Both give the same bits: sorted-unique order,
sequential rows, in-order merge adds.

The lock guards the arenas and the index: the tiered table's worker thread
exports rows while the training thread may write rows back.

The host-table engine (``CTRTrainer(use_device_table=False)``,
``trainer/train_step.py`` ``TrainStep``) trains this table directly: each
batch's ``pull``, the step on the device, then ``push`` of its grads.

Serving pulls through ``ps/serving_table.py``, a device-resident lookup of
a snapshot.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np

from paddlebox_tpu_torch.ckpt.atomic import write_npz
from paddlebox_tpu_torch.config import TableConfig, env_flag
from paddlebox_tpu_torch.obs.metrics import REGISTRY
from paddlebox_tpu_torch.ps import native
from paddlebox_tpu_torch.ps.optimizer import make_sparse_optimizer


def state_dim(conf: TableConfig) -> int:
    """Width of a snapshot's ``state``: the sparse optimizer's state for
    each trainable group (embed_w, embedx, expand)."""
    widths = [w for w in (conf.cvm_offset - 2, conf.embedx_dim,
                          conf.expand_dim) if w]
    return sum(make_sparse_optimizer(conf, w).state_width for w in widths)


class _PyIndex:
    """dict key -> row index, ``native.NativeIndex``'s contract."""

    def __init__(self):
        self._d: Dict[int, int] = {}

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: int) -> bool:
        return int(key) in self._d

    def lookup(self, keys: np.ndarray, create: bool, skip_zero: bool,
               next_row: int) -> Tuple[np.ndarray, int]:
        d = self._d
        rows = np.fromiter((d.get(int(k), -1) for k in keys),
                           dtype=np.int64, count=len(keys))
        if not create:
            return rows, 0
        missing = rows < 0
        if skip_zero:
            missing &= keys != 0
        # a key repeated within one call resolves to one row
        nxt = next_row
        for m in np.flatnonzero(missing):
            k = int(keys[m])
            r = d.get(k, -1)
            if r < 0:
                d[k] = r = nxt
                nxt += 1
            rows[m] = r
        return rows, int(nxt - next_row)

    def dump_keys(self, n: int) -> np.ndarray:
        out = np.zeros(n, dtype=np.uint64)
        for k, r in self._d.items():
            if 0 <= r < n:
                out[r] = k
        return out

    def rebuild(self, keys: np.ndarray) -> None:
        self._d = {int(k): i for i, k in enumerate(keys)}


def _resolve_backend() -> str:
    mode = env_flag("embedding_backend", "auto")
    if mode == "numpy":
        return "numpy"
    if mode == "native":
        if not native.available():
            raise RuntimeError(
                f"embedding_backend=native but: {native.build_error()}")
        return "native"
    return "native" if native.available() else "numpy"


def key_init_uniform(keys: np.ndarray, seed: int, col: int, width: int,
                     rng_range: float) -> np.ndarray:
    """Deterministic per-key uniform init in [-rng_range, rng_range):
    splitmix64 over (key, seed, column), so a feature's initial weights
    depend on its key alone, never on when or where it was created."""
    keys = keys.astype(np.uint64, copy=False)
    out = np.empty((keys.size, width), dtype=np.float32)
    c2 = np.uint64(0xBF58476D1CE4E5B9)
    c3 = np.uint64(0x94D049BB133111EB)
    base = (seed * 0x2545F4914F6CDD1D) & 0xFFFFFFFFFFFFFFFF
    for j in range(width):
        # the column offset folds in Python ints (numpy warns on uint64
        # scalar wraparound; arrays wrap silently, as wanted)
        xj = np.uint64((base + (col + j) * 0x9E3779B97F4A7C15)
                       & 0xFFFFFFFFFFFFFFFF)
        x = keys ^ xj
        x = (x ^ (x >> np.uint64(30))) * c2
        x = (x ^ (x >> np.uint64(27))) * c3
        x = x ^ (x >> np.uint64(31))
        u = (x >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))
        out[:, j] = ((u * 2.0 - 1.0) * rng_range).astype(np.float32)
    return out


class EmbeddingTable:
    GROW = 1.5
    INIT_CAP = 1024

    def __init__(self, conf: TableConfig, backend: Optional[str] = None):
        if conf.cvm_offset < 2:
            raise ValueError("cvm_offset must be >= 2 (show, clk)")
        if conf.variable_embedding:
            raise ValueError(
                "variable_embedding is a device-arena mode; the host table "
                "stores the fixed layout")
        self.conf = conf
        self.dim = conf.pull_dim
        self.backend = backend or _resolve_backend()
        if self.backend not in ("native", "numpy"):
            raise ValueError(f"unknown embedding backend {self.backend!r}")
        # trainable groups: (start_col, width, optimizer, gated)
        self._groups = []
        col = 2
        for width, gated in ((conf.cvm_offset - 2, False),
                             (conf.embedx_dim, True),
                             (conf.expand_dim, True)):
            if width:
                self._groups.append(
                    (col, width, make_sparse_optimizer(conf, width), gated))
                col += width
        self._state_offsets = np.cumsum(
            [0] + [g[2].state_width for g in self._groups])
        self._index = (native.NativeIndex() if self.backend == "native"
                       else _PyIndex())
        cap = self.INIT_CAP
        self._values = np.zeros((cap, self.dim), dtype=np.float32)
        self._state = np.zeros((cap, int(self._state_offsets[-1])),
                               dtype=np.float32)
        self._embedx_ok = np.zeros(cap, dtype=bool)
        # rows changed since the last save (the reference's SaveDelta)
        self._dirty = np.zeros(cap, dtype=bool)
        self._size = 0
        # keys whose merged grads held a non-finite value (clamped to 0)
        self.nonfinite_grad_rows = 0
        self._lock = threading.Lock()

    # -- backend dispatch ----------------------------------------------------

    def _unique(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        if self.backend == "native":
            return native.unique_inverse(keys)
        return np.unique(keys, return_inverse=True)

    def _merge(self, inverse: np.ndarray, grads: np.ndarray,
               num_unique: int) -> np.ndarray:
        if self.backend == "native":
            return native.merge_add(inverse, grads, num_unique)
        merged = np.zeros((num_unique, grads.shape[1]), dtype=np.float32)
        np.add.at(merged, inverse, grads.astype(np.float32, copy=False))
        return merged

    def _gather(self, rows: np.ndarray) -> np.ndarray:
        """Value rows; rows < 0 -> zeros."""
        if self.backend == "native":
            return native.gather_rows(self._values, rows)
        out = self._values[np.maximum(rows, 0)].copy()
        out[rows < 0] = 0.0
        return out

    def _expand(self, uniq_vals: np.ndarray,
                inverse: np.ndarray) -> np.ndarray:
        if self.backend == "native":
            return native.expand_rows(uniq_vals, inverse)
        return uniq_vals[inverse]

    # -- internals -----------------------------------------------------------

    def __len__(self) -> int:
        return self._size

    def _grow(self, need: int) -> None:
        cap = self._values.shape[0]
        if self._size + need <= cap:
            return
        new_cap = cap
        while new_cap < self._size + need:
            new_cap = int(new_cap * self.GROW) + 1
        for name in ("_values", "_state"):
            old = getattr(self, name)
            arr = np.zeros((new_cap, old.shape[1]), dtype=old.dtype)
            arr[:cap] = old
            setattr(self, name, arr)
        for name in ("_embedx_ok", "_dirty"):
            old = getattr(self, name)
            arr = np.zeros(new_cap, dtype=bool)
            arr[:cap] = old
            setattr(self, name, arr)

    def _init_gated(self, rows: np.ndarray, keys: np.ndarray) -> None:
        """Write the key-deterministic init of every gated group (embedx,
        expand) into ``rows``."""
        for start, width, _opt, gated in self._groups:
            if gated:
                self._values[np.ix_(rows, range(start, start + width))] = \
                    key_init_uniform(keys, self.conf.seed or 42, start,
                                     width, self.conf.initial_range)

    def _lookup(self, uniq_keys: np.ndarray, create: bool) -> np.ndarray:
        """Rows of unique keys; -1 for absent ones when not creating. New
        keys take sequential rows in the given (sorted-unique) order, with
        zero stats and state and their key's ``embed_w`` init. Key 0 is
        never created while padding-zero is on. Called under the lock."""
        skip_zero = bool(env_flag("enable_pull_padding_zero", True))
        rows, n_new = self._index.lookup(uniq_keys, create, skip_zero,
                                         self._size)
        if n_new:
            self._grow(n_new)
            base = self._size
            new_rows = np.arange(base, base + n_new)
            self._size = base + n_new
            self._values[new_rows] = 0.0
            w_width = self.conf.cvm_offset - 2
            if w_width:
                is_new = rows >= base
                self._values[rows[is_new][:, None],
                             np.arange(2, 2 + w_width)[None, :]] = \
                    key_init_uniform(uniq_keys[is_new],
                                     self.conf.seed or 42, 2, w_width,
                                     self.conf.initial_range)
            self._state[new_rows] = 0.0
            self._embedx_ok[new_rows] = False
            self._dirty[new_rows] = True
        return rows

    # -- public API ----------------------------------------------------------

    def feed_pass(self, keys: np.ndarray) -> None:
        """Create the pass's keys up front (the reference's feed pass)."""
        uniq = np.unique(np.ascontiguousarray(keys, dtype=np.uint64))
        uniq = uniq[uniq != 0]
        with self._lock:
            self._lookup(uniq, create=True)

    def contains_bulk(self, keys: np.ndarray) -> np.ndarray:
        """bool[N]: the key has a row (never creates)."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        with self._lock:
            rows, _ = self._index.lookup(keys, False, True, self._size)
        return rows >= 0

    def pull(self, keys: np.ndarray, create: bool = True) -> np.ndarray:
        """Values of ``keys`` [N] -> [N, pull_dim]: dedup, look up (with
        ``create``, unseen keys get rows), gate embedx, expand back to key
        order. Absent keys and key 0 pull zeros."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        uniq, inverse = self._unique(keys)
        with self._lock:
            rows = self._lookup(uniq, create=create)
            out_u = self._gather(rows)
            gated = ~self._embedx_ok[np.maximum(rows, 0)]
            for start, width, _opt, needs_threshold in self._groups:
                if needs_threshold:
                    out_u[np.ix_(gated, range(start, start + width))] = 0.0
        out_u[rows < 0] = 0.0
        return self._expand(out_u, inverse)

    def push(self, keys: np.ndarray, grads: np.ndarray) -> None:
        """Apply one push: merge the grads of duplicate keys, drop key 0,
        clamp non-finite merged grads to 0 (``FloatingPointError`` instead
        under ``PBOX_FLAGS_check_nan_inf``), add show/clk, materialize
        embedx where show reaches the threshold, then each group's
        optimizer. ``grads[:, 0:2]`` are the show/clk increments."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        if grads.shape != (keys.size, self.dim):
            raise ValueError(f"push grads shape {grads.shape} != "
                             f"({keys.size}, {self.dim})")
        uniq, inverse = self._unique(keys)
        merged = self._merge(inverse, grads, uniq.size)
        if env_flag("enable_pull_padding_zero", True):
            live = uniq != 0
            uniq, merged = uniq[live], merged[live]
        if not uniq.size:
            return
        bad = ~np.isfinite(merged)
        if bad.any():
            n_bad = int(bad.any(axis=1).sum())
            if env_flag("check_nan_inf", False):
                raise FloatingPointError(
                    f"non-finite grads for {n_bad} keys")
            self.nonfinite_grad_rows += n_bad
            REGISTRY.add("ps.nonfinite_grad_rows", n_bad)
            merged[bad] = 0.0
        with self._lock:
            rows = self._lookup(uniq, create=True)
            vals = self._values[rows]
            vals[:, 0] += merged[:, 0]
            vals[:, 1] += merged[:, 1]
            # threshold crossing: embedx takes its key's init
            newly = (~self._embedx_ok[rows]) & \
                (vals[:, 0] >= self.conf.embedx_threshold)
            if newly.any():
                for start, width, _opt, needs_threshold in self._groups:
                    if needs_threshold:
                        vals[np.ix_(newly, range(start, start + width))] = \
                            key_init_uniform(uniq[newly],
                                             self.conf.seed or 42, start,
                                             width,
                                             self.conf.initial_range)
                self._embedx_ok[rows[newly]] = True
            states = self._state[rows]
            active = self._embedx_ok[rows]
            for gi, (start, width, opt, needs_threshold) in \
                    enumerate(self._groups):
                sl = slice(start, start + width)
                st = slice(int(self._state_offsets[gi]),
                           int(self._state_offsets[gi + 1]))
                if needs_threshold:
                    if not active.any():
                        continue
                    w = vals[active, sl]
                    s = states[active, st]
                    opt.update(w, merged[active, sl], s)
                    vals[active, sl] = w
                    states[active, st] = s
                else:
                    w = vals[:, sl]
                    s = states[:, st]
                    opt.update(w, merged[:, sl], s)
                    vals[:, sl] = w
                    states[:, st] = s
            self._values[rows] = vals
            self._state[rows] = states
            self._dirty[rows] = True

    # -- lifecycle -----------------------------------------------------------

    def end_pass(self) -> None:
        """Decay show/clk by ``show_clk_decay``."""
        d = self.conf.show_clk_decay
        if d < 1.0 and self._size:
            with self._lock:
                self._values[:self._size, 0:2] *= d

    def shrink(self) -> int:
        """Evict the features whose show count fell below
        ``delete_threshold``; returns the count evicted."""
        with self._lock:
            if not self._size:
                return 0
            n = self._size
            keep = self._values[:n, 0] >= self.conf.delete_threshold
            kept = int(keep.sum())
            if kept == n:
                return 0
            old_keys = self._index.dump_keys(n)
            self._values[:kept] = self._values[:n][keep]
            self._state[:kept] = self._state[:n][keep]
            self._embedx_ok[:kept] = self._embedx_ok[:n][keep]
            self._dirty[:kept] = self._dirty[:n][keep]
            self._values[kept:n] = 0.0
            self._embedx_ok[kept:n] = False
            self._dirty[kept:n] = False
            self._index.rebuild(old_keys[keep])
            self._size = kept
            return n - kept

    # -- bulk row I/O: the DRAM side of the tiered table's staging -----------
    # Raw (values, state) rows, no optimizer: while a row is staged, the
    # device tier trains it.

    def export_rows(self, keys: np.ndarray, create: bool = True
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """(values [N, dim], state [N, state_dim]) of unique ``keys``,
        creating absent features when ``create``. A row whose embedx has not
        materialized gets its key's init written INTO THE ARENA here, so the
        staged copy and the stored row are the same (``embedx_ok`` stays
        False; the threshold crossing writes the same values)."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        with self._lock:
            rows = self._lookup(keys, create=create)
            pending = (~self._embedx_ok[np.maximum(rows, 0)]) & (rows >= 0)
            if pending.any():
                prow = rows[pending]
                self._init_gated(prow, keys[pending])
                self._dirty[prow] = True
            vals = self._values[np.maximum(rows, 0)].copy()
            state = self._state[np.maximum(rows, 0)].copy()
            vals[rows < 0] = 0.0
            state[rows < 0] = 0.0
        return vals, state

    def import_rows(self, keys: np.ndarray, values: np.ndarray,
                    state: np.ndarray, mode: str = "set") -> None:
        """Store trained rows back (the tiered table's writeback);
        ``embedx_ok`` follows the resulting show count. ``mode="add"`` adds
        deltas instead of overwriting."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        if not keys.size:
            return
        if mode not in ("set", "add"):
            raise ValueError(f"unknown import mode {mode!r}")
        with self._lock:
            rows = self._lookup(keys, create=True)
            if mode == "add":
                self._values[rows] += values
                self._state[rows] += state
            else:
                self._values[rows] = values
                self._state[rows] = state
            self._embedx_ok[rows] = \
                self._values[rows, 0] >= self.conf.embedx_threshold
            self._dirty[rows] = True

    # -- persistence ---------------------------------------------------------
    # snapshot()/snapshot_delta() are the copy half of an asynchronous save
    # (locked, on the training thread); writes go through ckpt.atomic.

    def snapshot(self, reset_dirty: bool = True) -> Dict[str, np.ndarray]:
        """Host copy of the whole table; clears the dirty marks unless
        ``reset_dirty`` is False."""
        with self._lock:
            n = self._size
            out = {"keys": self._index.dump_keys(n),
                   "values": self._values[:n].copy(),
                   "state": self._state[:n].copy(),
                   "embedx_ok": self._embedx_ok[:n].copy()}
            if reset_dirty:
                self._dirty[:n] = False
        return out

    def snapshot_delta(self) -> Dict[str, np.ndarray]:
        """Host copy of the rows touched since the last snapshot or delta;
        clears the dirty marks."""
        with self._lock:
            n = self._size
            rows = np.flatnonzero(self._dirty[:n])
            out = {"keys": self._index.dump_keys(n)[rows],
                   "values": self._values[rows],
                   "state": self._state[rows],
                   "embedx_ok": self._embedx_ok[rows]}
            self._dirty[:n] = False
        return out

    def snapshot_parts(self, delta: bool = False
                       ) -> Dict[str, Dict[str, np.ndarray]]:
        """The snapshot files of a save, by name suffix (one here)."""
        return {"": self.snapshot_delta() if delta else self.snapshot()}

    def mark_dirty(self, keys: np.ndarray) -> None:
        """Mark ``keys``' rows dirty again (the rollback of a save whose
        commit failed)."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        if not keys.size:
            return
        with self._lock:
            rows, _ = self._index.lookup(keys, False, False, self._size)
            self._dirty[rows[rows >= 0]] = True

    def save(self, path: str) -> None:
        write_npz(path, self.snapshot())

    def load(self, path: str) -> None:
        """Replace the table with a snapshot; nothing is dirty after."""
        with np.load(path) as data:
            keys = np.ascontiguousarray(data["keys"], dtype=np.uint64)
            values, state, ok = data["values"], data["state"], \
                data["embedx_ok"]
        n = keys.size
        with self._lock:
            self._index.rebuild(keys)
            cap = max(self.INIT_CAP, n)
            self._values = np.zeros((cap, self.dim), dtype=np.float32)
            self._state = np.zeros((cap, int(self._state_offsets[-1])),
                                   dtype=np.float32)
            self._embedx_ok = np.zeros(cap, dtype=bool)
            self._dirty = np.zeros(cap, dtype=bool)
            self._values[:n] = values
            self._state[:n] = state
            self._embedx_ok[:n] = ok
            self._size = n

    def save_delta(self, path: str) -> int:
        """Write the rows touched since the last save; returns their
        count."""
        snap = self.snapshot_delta()
        write_npz(path, snap)
        return int(snap["keys"].size)

    def load_delta(self, path: str) -> None:
        """Upsert a delta snapshot; the keys it creates are marked dirty
        (by their creation), the rows it overwrites are not."""
        with np.load(path) as data:
            keys = np.ascontiguousarray(data["keys"], dtype=np.uint64)
            values, state, ok = data["values"], data["state"], \
                data["embedx_ok"]
        if not keys.size:
            return
        with self._lock:
            rows = self._lookup(keys, create=True)
            self._values[rows] = values
            self._state[rows] = state
            self._embedx_ok[rows] = ok

    def memory_bytes(self) -> int:
        return int(self._values.nbytes + self._state.nbytes +
                   self._embedx_ok.nbytes)
