"""The port's native host code: ctypes bindings of ``csrc/pbx_index.cpp``,
the key index (counterpart of ``paddlebox_tpu/ps/native.py``'s
``NativeIndex`` and ``MtIndex``) and the host table's row helpers
(``unique_inverse``, ``merge_add``, ``gather_rows``, ``scatter_rows``,
``expand_rows``), the device-sharded table's routing-plan builder
(``MeshPlanner``), and of ``csrc/pbx_feed.cpp``, the file tokenizer
(``parse_block``) and the staged feed's row pack (``pack_cols``).

``NativeIndex`` is one open-addressing map (``Map64``) from uint64 keys to
arena rows; ``MtIndex`` shards keys over T maps and prepares a batch with T
threads. Both return the reference's arrays bit for bit: the same dtypes,
uniques in first-occurrence order, new keys at ``next_row + i`` (``MtIndex``
numbers from an internal counter, so its rows depend on thread timing).

Each library builds with ``g++`` at first use into ``build/``
(``ops/_build.py``). Where the index cannot build, ``available()`` is False
and ``build_error()`` says why; the device table then takes its numpy
index, and the row helpers compute the same arrays with numpy. The
tokenizer has no Python fallback: where it cannot build,
``parse_block`` raises with the build error.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from paddlebox_tpu_torch.ops import _build

_lib = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None
_feed_lib = None

_u64p = ctypes.POINTER(ctypes.c_uint64)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_f32p = ctypes.POINTER(ctypes.c_float)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i64, c_int, u64 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                           ctypes.c_uint64)
    sigs = {
        "pbx_map_create": (vp, [i64]),
        "pbx_map_destroy": (None, [vp]),
        "pbx_map_size": (i64, [vp]),
        "pbx_map_lookup": (i64, [vp, _u64p, i64, _i64p, c_int, c_int, u64,
                                 i64]),
        "pbx_map_dump": (None, [vp, _u64p, i64]),
        "pbx_map_rebuild": (i64, [vp, _u64p, i64]),
        "pbx_map_prepare": (i64, [vp, _u64p, i64, c_int, c_int, u64, i64,
                                  _i32p, _i32p, _i32p, _i64p]),
        "pbx_map_prepare_dev": (i64, [vp, _u64p, i64, c_int, c_int, u64, i64,
                                      _i32p, _i32p, _i32p, _i64p, _i64p,
                                      _u32p, _u32p, _i32p]),
        "pbx_map_missing": (i64, [vp, _u64p, i64, _u64p]),
        "pbx_map_capacity": (i64, [vp]),
        "pbx_map_generation": (i64, [vp]),
        "pbx_map_guard": (i64, []),
        "pbx_map_max_run": (i64, []),
        "pbx_map_export": (None, [vp, _u32p]),
        "pbx_mt_create": (vp, [c_int, i64]),
        "pbx_mt_destroy": (None, [vp]),
        "pbx_mt_size": (i64, [vp]),
        "pbx_mt_next_row": (i64, [vp]),
        "pbx_mt_prepare": (i64, [vp, _u64p, i64, c_int, c_int, u64, _i32p,
                                 _i32p, _i32p, _i64p]),
        "pbx_mt_lookup": (i64, [vp, _u64p, i64, _i64p, c_int, c_int, u64]),
        "pbx_mt_dump": (None, [vp, _u64p, i64]),
        "pbx_mt_rebuild": (i64, [vp, _u64p, i64]),
        "pbx_unique_inverse": (i64, [_u64p, i64, _u64p, _i64p]),
        "pbx_merge_add": (None, [_i64p, i64, _f32p, i64, _f32p]),
        "pbx_gather_rows": (None, [_f32p, _i64p, i64, i64, _f32p]),
        "pbx_scatter_rows": (None, [_f32p, _i64p, i64, i64, _f32p]),
        "pbx_expand_rows": (None, [_f32p, _i64p, i64, i64, _f32p]),
        "pbx_mesh_ctx_create": (vp, [i64]),
        "pbx_mesh_ctx_destroy": (None, [vp]),
        "pbx_mesh_begin": (i64, [vp, ctypes.POINTER(vp), _u64p, i64, c_int,
                                 _i64p, _i64p]),
        "pbx_mesh_fill": (None, [vp, i64, i64, _i32p, _i32p, _i32p, _f32p,
                                 _i32p, _i64p]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def _load():
    global _lib, _build_error
    with _lib_lock:
        if _lib is None and _build_error is None:
            try:
                _lib = _bind(_build.load("pbx_index"))
            except (OSError, RuntimeError) as e:
                _build_error = str(e)
        return _lib


def available() -> bool:
    """Whether the index core builds (or is built) and loads here."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the index core is unavailable, or None."""
    _load()
    return _build_error


def _load_feed() -> ctypes.CDLL:
    """The tokenizer library, built first if needed; raises with the build
    error where it cannot build."""
    global _feed_lib
    with _lib_lock:
        if _feed_lib is None:
            lib = _build.load("pbx_feed")
            lib.pbx_parse_block.restype = ctypes.c_int64
            lib.pbx_parse_block.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, _i32p, ctypes.c_int32,
                ctypes.c_int64, _u64p, ctypes.c_int64, _i32p, _f32p,
                ctypes.c_int64, _i32p, _f32p, _i64p]
            lib.pbx_pack_cols.restype = None
            lib.pbx_pack_cols.argtypes = [
                _u64p, ctypes.c_int64, _i32p, ctypes.c_int64, _f32p, _f32p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, _u32p]
            _feed_lib = lib
        return _feed_lib


def parse_block(data: bytes, kinds: np.ndarray, n_sparse: int,
                n_float: int):
    """One-pass C++ tokenizer over a MultiSlot text block (counterpart of
    ``paddlebox_tpu/ps/native.py::parse_block``). ``kinds``: per configured
    slot 0=sparse used, 1=sparse skip, 2=float used, 3=label, 4=float skip.
    Returns (keys[u64], lengths[rows, n_sparse] i32, floats[f32],
    flengths[rows, n_float] i32, labels[rows] f32).

    Raises RuntimeError naming the bad row on malformed input, and the
    build error where the library cannot build."""
    lib = _load_feed()
    kinds = np.ascontiguousarray(kinds, dtype=np.int32)
    n = len(data)
    max_rows = data.count(b"\n") + 1
    # a uint64/float token needs >= 2 bytes ("1 "), so n // 2 bounds both
    keys = np.empty(n // 2 + 16, dtype=np.uint64)
    floats = np.empty(n // 2 + 16, dtype=np.float32)
    lengths = np.zeros((max_rows, max(n_sparse, 1)), dtype=np.int32)
    flengths = np.zeros((max_rows, max(n_float, 1)), dtype=np.int32)
    labels = np.zeros(max_rows, dtype=np.float32)
    counts = np.zeros(3, dtype=np.int64)
    rc = lib.pbx_parse_block(
        data, n, _ptr(kinds, _i32p), kinds.size, max_rows, _ptr(keys, _u64p),
        keys.size, _ptr(lengths, _i32p), _ptr(floats, _f32p), floats.size,
        _ptr(flengths, _i32p), _ptr(labels, _f32p), _ptr(counts, _i64p))
    if rc < 0:
        raise RuntimeError(f"malformed slot record at row {-rc - 1}")
    rows, nk, nf = (int(c) for c in counts)
    return (keys[:nk].copy(), lengths[:rows], floats[:nf].copy(),
            flengths[:rows], labels[:rows])


def wire_offsets(npad: int, batch: int, n_slots: int,
                 dense_dim: int) -> Tuple[int, int, int, int]:
    """Word offsets of a staged wire row's lengths, labels, dense and
    nrows: ``khi | klo [2*npad] + lengths [B*S] + labels [B] + dense
    [B*Dd] + nrows``, 32-bit words. The layout's one statement in Python
    (``pbx_pack_cols`` writes the same in C)."""
    o_len = 2 * npad
    o_lab = o_len + batch * n_slots
    o_den = o_lab + batch
    return o_len, o_lab, o_den, o_den + batch * dense_dim


def wire_len(npad: int, batch: int, n_slots: int, dense_dim: int) -> int:
    """32-bit words of a staged batch's wire row (``wire_offsets``)."""
    return wire_offsets(npad, batch, n_slots, dense_dim)[3] + 1


def pack_cols(keys: np.ndarray, lengths: np.ndarray, labels: np.ndarray,
              dense: np.ndarray, batch: int, n_slots: int, dense_dim: int,
              npad: int, out: np.ndarray) -> None:
    """One C pass from a batch's columnar views into its staged wire row
    (counterpart of ``paddlebox_tpu/ps/native.py::pack_cols``):
    khi | klo | lengths | labels | dense | nrows, the tails zeroed (ring
    rows are reused). ``out`` is a C-contiguous uint32 row of
    ``wire_len(npad, batch, n_slots, dense_dim)`` words. Raises
    ``ValueError`` on any shape the C side would write past, and the build
    error where the library cannot build."""
    lib = _load_feed()
    k = np.ascontiguousarray(keys, np.uint64)
    ln = np.ascontiguousarray(lengths, np.int32)
    lb = np.ascontiguousarray(labels, np.float32)
    d = np.ascontiguousarray(dense, np.float32)
    num_rows = int(ln.shape[0])
    # checks, not asserts: a wrong buffer would have the C side write past
    # its end
    if out.dtype != np.uint32 or not out.flags.c_contiguous:
        raise ValueError("pack_cols out must be C-contiguous uint32")
    want = wire_len(npad, batch, n_slots, dense_dim)
    if out.size != want:
        raise ValueError(f"pack_cols out size {out.size} != {want}")
    if k.size > npad or num_rows > batch:
        raise ValueError(
            f"pack_cols slice ({k.size} keys, {num_rows} rows) exceeds "
            f"wire shape (npad {npad}, batch {batch})")
    if ln.ndim != 2 or ln.shape[1] != n_slots or lb.size != num_rows \
            or d.size != num_rows * dense_dim:
        raise ValueError("pack_cols column shapes disagree")
    lib.pbx_pack_cols(_ptr(k, _u64p), k.size, _ptr(ln, _i32p), num_rows,
                      _ptr(lb, _f32p), _ptr(d, _f32p), batch, n_slots,
                      dense_dim, npad, _ptr(out, _u32p))


# -- host-table row helpers (ps/table.py, native backend) --------------------

def unique_inverse(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted uniques and the inverse, the contract of ``np.unique(keys,
    return_inverse=True)`` (inverse int64)."""
    lib = _load()
    keys = _u64(keys)
    if lib is None:
        return np.unique(keys, return_inverse=True)
    uniq = np.empty(keys.size, dtype=np.uint64)
    inverse = np.empty(keys.size, dtype=np.int64)
    u = lib.pbx_unique_inverse(_ptr(keys, _u64p), keys.size,
                               _ptr(uniq, _u64p), _ptr(inverse, _i64p))
    return uniq[:u].copy(), inverse


def merge_add(inverse: np.ndarray, grads: np.ndarray,
              num_unique: int) -> np.ndarray:
    """``merged[u]`` = the sum of the grads whose inverse is u, added in
    key order (``np.add.at``'s bits)."""
    lib = _load()
    grads = np.ascontiguousarray(grads, dtype=np.float32)
    merged = np.zeros((num_unique, grads.shape[1]), dtype=np.float32)
    if lib is None:
        np.add.at(merged, np.asarray(inverse), grads)
        return merged
    inverse = np.ascontiguousarray(inverse, dtype=np.int64)
    lib.pbx_merge_add(_ptr(inverse, _i64p), inverse.size, _ptr(grads, _f32p),
                      grads.shape[1], _ptr(merged, _f32p))
    return merged


def gather_rows(arena: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """``arena[rows]`` as a new array, zeros where ``rows`` < 0. ``arena``
    is a C-contiguous float32 [n, d]."""
    lib = _load()
    if lib is None:
        out = arena[np.maximum(rows, 0)].copy()
        out[rows < 0] = 0.0
        return out
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    out = np.empty((rows.size, arena.shape[1]), dtype=np.float32)
    lib.pbx_gather_rows(_ptr(arena, _f32p), _ptr(rows, _i64p), rows.size,
                        arena.shape[1], _ptr(out, _f32p))
    return out


def scatter_rows(arena: np.ndarray, rows: np.ndarray,
                 vals: np.ndarray) -> None:
    """``arena[rows] = vals`` in place, skipping ``rows`` < 0 (the C path;
    numpy writes every row). ``arena`` is a C-contiguous float32 [n, d]."""
    lib = _load()
    if lib is None:
        arena[rows] = vals
        return
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    lib.pbx_scatter_rows(_ptr(arena, _f32p), _ptr(rows, _i64p), rows.size,
                         arena.shape[1], _ptr(vals, _f32p))


def expand_rows(uniq_vals: np.ndarray, inverse: np.ndarray) -> np.ndarray:
    """``uniq_vals[inverse]``: the unique rows back in key order."""
    lib = _load()
    uniq_vals = np.ascontiguousarray(uniq_vals, dtype=np.float32)
    if lib is None:
        return uniq_vals[inverse]
    inverse = np.ascontiguousarray(inverse, dtype=np.int64)
    out = np.empty((inverse.size, uniq_vals.shape[1]), dtype=np.float32)
    lib.pbx_expand_rows(_ptr(uniq_vals, _f32p), _ptr(inverse, _i64p),
                        inverse.size, uniq_vals.shape[1], _ptr(out, _f32p))
    return out


def _lib_or_raise():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native index unavailable: {_build_error}")
    return lib


def _ptr(a: np.ndarray, ty):
    return a.ctypes.data_as(ty)


def _ck(rc: int) -> int:
    """The C side returns -1 when an allocation failed (the map itself
    stays consistent: it allocates before it frees)."""
    if rc < 0:
        raise MemoryError("native index allocation failed (host OOM)")
    return rc


def _u64(keys: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(keys, dtype=np.uint64)


class NativeIndex:
    """uint64 key -> sequential row index (C++ open addressing)."""

    def __init__(self, cap_hint: int = 1024):
        self._lib = _lib_or_raise()
        self._h = self._lib.pbx_map_create(cap_hint)
        if not self._h:
            raise MemoryError("native index allocation failed")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pbx_map_destroy(self._h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.pbx_map_size(self._h))

    def __contains__(self, key: int) -> bool:
        rows, _ = self.lookup(np.array([key], dtype=np.uint64), create=False,
                              skip_zero=False, next_row=0)
        return bool(rows[0] >= 0)

    def lookup(self, keys: np.ndarray, create: bool, skip_zero: bool,
               next_row: int) -> Tuple[np.ndarray, int]:
        """Rows of ``keys`` (-1 = absent); with ``create`` new keys get
        sequential rows from ``next_row``. Returns (rows int64, n_new)."""
        keys = _u64(keys)
        rows = np.empty(keys.size, dtype=np.int64)
        n_new = _ck(self._lib.pbx_map_lookup(
            self._h, _ptr(keys, _u64p), keys.size, _ptr(rows, _i64p),
            int(create), int(skip_zero), 0, next_row))
        return rows, int(n_new)

    def prepare(self, keys: np.ndarray, create: bool, skip_zero: bool,
                next_row: int):
        """Dedup and row mapping in one pass. Returns (rows [n] int32,
        inverse [n] int32, uniq_rows [u] int32, n_new); uniques in
        first-occurrence order, row 0 for absent or skipped keys."""
        keys = _u64(keys)
        n = keys.size
        rows = np.empty(n, dtype=np.int32)
        inverse = np.empty(n, dtype=np.int32)
        uniq_rows = np.empty(n, dtype=np.int32)
        n_new = ctypes.c_int64(0)
        u = _ck(self._lib.pbx_map_prepare(
            self._h, _ptr(keys, _u64p), n, int(create), int(skip_zero), 0,
            next_row, _ptr(rows, _i32p), _ptr(inverse, _i32p),
            _ptr(uniq_rows, _i32p), ctypes.byref(n_new)))
        return rows, inverse, uniq_rows[:u], int(n_new.value)

    def dump_keys(self, n: int) -> np.ndarray:
        """[n] uint64: the key of each row below ``n`` (0 where none)."""
        out = np.zeros(n, dtype=np.uint64)
        self._lib.pbx_map_dump(self._h, _ptr(out, _u64p), n)
        return out

    def rebuild(self, keys: np.ndarray) -> None:
        """Replace the map with ``keys[i] -> row i`` (a duplicate keeps its
        first row). Bumps ``generation``."""
        keys = _u64(keys)
        _ck(self._lib.pbx_map_rebuild(self._h, _ptr(keys, _u64p), keys.size))

    # -- device-mirror support (ps/device_index.py) --------------------------

    @property
    def capacity(self) -> int:
        """Power-of-two slot capacity (the mirror adds ``guard`` on top)."""
        return int(self._lib.pbx_map_capacity(self._h))

    @property
    def generation(self) -> int:
        """Bumped whenever the map rehashes (growth, rebuild): every slot
        exported before is then stale and a mirror must resync."""
        return int(self._lib.pbx_map_generation(self._h))

    @property
    def guard(self) -> int:
        return int(self._lib.pbx_map_guard())

    @property
    def max_run(self) -> int:
        return int(self._lib.pbx_map_max_run())

    def prepare_dev(self, keys: np.ndarray, create: bool, skip_zero: bool,
                    next_row: int):
        """``prepare`` that also reports, for each newly inserted key, the
        (slot, key_hi, key_lo, row) it landed at: the mirror's update.
        Returns (rows, inverse, uniq_rows, n_new, new_slots int64, new_hi
        uint32, new_lo uint32, new_rows int32). If ``generation`` moved
        during the call, the slots are stale (resync)."""
        keys = _u64(keys)
        n = keys.size
        rows = np.empty(n, dtype=np.int32)
        inverse = np.empty(n, dtype=np.int32)
        uniq_rows = np.empty(n, dtype=np.int32)
        new_slots = np.empty(n, dtype=np.int64)
        new_hi = np.empty(n, dtype=np.uint32)
        new_lo = np.empty(n, dtype=np.uint32)
        new_rows = np.empty(n, dtype=np.int32)
        n_new = ctypes.c_int64(0)
        u = _ck(self._lib.pbx_map_prepare_dev(
            self._h, _ptr(keys, _u64p), n, int(create), int(skip_zero), 0,
            next_row, _ptr(rows, _i32p), _ptr(inverse, _i32p),
            _ptr(uniq_rows, _i32p), ctypes.byref(n_new),
            _ptr(new_slots, _i64p), _ptr(new_hi, _u32p),
            _ptr(new_lo, _u32p), _ptr(new_rows, _i32p)))
        nn = int(n_new.value)
        return (rows, inverse, uniq_rows[:u], nn, new_slots[:nn],
                new_hi[:nn], new_lo[:nn], new_rows[:nn])

    def missing(self, keys: np.ndarray) -> np.ndarray:
        """The non-zero keys of ``keys`` absent from the map, duplicates
        kept, in their order (a block-prefetched find-only scan)."""
        keys = _u64(keys)
        out = np.empty(keys.size, dtype=np.uint64)
        n = self._lib.pbx_map_missing(self._h, _ptr(keys, _u64p), keys.size,
                                      _ptr(out, _u64p))
        return out[:n]

    def export_slots(self) -> np.ndarray:
        """The table in slot order as [capacity + guard, 4] uint32 quads
        (key_hi, key_lo, row, 0): the device mirror's layout. Empty slots
        read hi = lo = 0xFFFFFFFF."""
        out = np.empty((self.capacity + self.guard, 4), dtype=np.uint32)
        self._lib.pbx_map_export(self._h, _ptr(out, _u32p))
        return out


class MtIndex:
    """Hash-sharded key -> row index with a parallel prepare (T C++
    threads). Rows come from one internal atomic counter, starting at 1
    (row 0 is the null row) and reset by ``rebuild``; ``next_row``
    arguments are ignored."""

    def __init__(self, threads: int = 4, cap_hint: int = 1024):
        self._lib = _lib_or_raise()
        self.threads = max(1, threads)
        self._h = self._lib.pbx_mt_create(self.threads, cap_hint)
        if not self._h:
            raise MemoryError("native index allocation failed")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pbx_mt_destroy(self._h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.pbx_mt_size(self._h))

    def __contains__(self, key: int) -> bool:
        rows, _ = self.lookup(np.array([key], dtype=np.uint64), create=False,
                              skip_zero=False)
        return bool(rows[0] >= 0)

    @property
    def next_row(self) -> int:
        return int(self._lib.pbx_mt_next_row(self._h))

    def prepare(self, keys: np.ndarray, create: bool, skip_zero: bool,
                next_row: int = 0):
        """``NativeIndex.prepare``'s contract; uniques in (shard,
        first occurrence in the shard) order."""
        keys = _u64(keys)
        n = keys.size
        rows = np.empty(n, dtype=np.int32)
        inverse = np.empty(n, dtype=np.int32)
        uniq_rows = np.empty(n, dtype=np.int32)
        n_new = ctypes.c_int64(0)
        u = _ck(self._lib.pbx_mt_prepare(
            self._h, _ptr(keys, _u64p), n, int(create), int(skip_zero), 0,
            _ptr(rows, _i32p), _ptr(inverse, _i32p), _ptr(uniq_rows, _i32p),
            ctypes.byref(n_new)))
        return rows, inverse, uniq_rows[:u], int(n_new.value)

    def lookup(self, keys: np.ndarray, create: bool, skip_zero: bool,
               next_row: int = 0) -> Tuple[np.ndarray, int]:
        keys = _u64(keys)
        rows = np.empty(keys.size, dtype=np.int64)
        n_new = _ck(self._lib.pbx_mt_lookup(
            self._h, _ptr(keys, _u64p), keys.size, _ptr(rows, _i64p),
            int(create), int(skip_zero), 0))
        return rows, int(n_new)

    def dump_keys(self, n: int) -> np.ndarray:
        out = np.zeros(n, dtype=np.uint64)
        self._lib.pbx_mt_dump(self._h, _ptr(out, _u64p), n)
        return out

    def rebuild(self, keys: np.ndarray) -> None:
        keys = _u64(keys)
        _ck(self._lib.pbx_mt_rebuild(self._h, _ptr(keys, _u64p), keys.size))


class MeshPlanner:
    """The native routing-plan builder of the device-sharded table
    (``ps/sharded_device_table.py``; the reference's ``MeshPlanner`` over
    ``pbx_mesh_*``). One a table: its context keeps the dedup scratch and
    buffers, so the steady state allocates nothing on the C side."""

    def __init__(self, ndev: int):
        self._lib = _lib_or_raise()
        self.ndev = int(ndev)
        self._h = self._lib.pbx_mesh_ctx_create(self.ndev)
        if not self._h:
            raise MemoryError("native mesh context allocation failed")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pbx_mesh_ctx_destroy(self._h)
            self._h = None

    def plan(self, indexes, keys: np.ndarray, create: bool,
             sizes: np.ndarray, req_bucket, uniq_bucket):
        """One batch's plan. ``indexes``, the shards' ``NativeIndex``es;
        ``keys`` [ndev, npad] uint64; ``sizes`` the shards' next free rows
        (int64, updated in place); ``req_bucket`` and ``uniq_bucket`` map a
        raw largest count to its padded size. Returns (req_rows, inverse,
        serve_uniq, serve_mask, serve_inverse, num_uniq, sizes, n_new
        total) with ``MeshBatchIndex``'s dtypes and shapes."""
        lib = self._lib
        keys = _u64(keys)
        ndev, npad = keys.shape
        if ndev != self.ndev:
            raise ValueError(f"planner built for ndev={self.ndev}, "
                             f"got keys for {ndev}")
        handles = (ctypes.c_void_p * ndev)(*[ix._h for ix in indexes])
        sizes = np.ascontiguousarray(sizes, dtype=np.int64)
        out3 = np.zeros(3, dtype=np.int64)
        _ck(lib.pbx_mesh_begin(self._h, handles, _ptr(keys, _u64p), npad,
                               1 if create else 0, _ptr(sizes, _i64p),
                               _ptr(out3, _i64p)))
        R = int(req_bucket(max(int(out3[0]), 1)))
        upad = int(uniq_bucket(max(int(out3[1]), 1)))
        req_rows = np.empty((ndev, ndev, R), dtype=np.int32)
        inverse = np.empty((ndev, npad), dtype=np.int32)
        serve_uniq = np.empty((ndev, upad), dtype=np.int32)
        serve_mask = np.empty((ndev, upad), dtype=np.float32)
        serve_inverse = np.empty((ndev, ndev, R), dtype=np.int32)
        num_uniq = np.empty(ndev, dtype=np.int64)
        lib.pbx_mesh_fill(
            self._h, R, upad, _ptr(req_rows, _i32p), _ptr(inverse, _i32p),
            _ptr(serve_uniq, _i32p), _ptr(serve_mask, _f32p),
            _ptr(serve_inverse, _i32p), _ptr(num_uniq, _i64p))
        return (req_rows, inverse, serve_uniq, serve_mask, serve_inverse,
                num_uniq, sizes, int(out3[2]))
