"""The native host key index: ctypes bindings of ``csrc/pbx_index.cpp``
(counterpart of ``paddlebox_tpu/ps/native.py``'s ``NativeIndex`` and
``MtIndex``).

``NativeIndex`` is one open-addressing map (``Map64``) from uint64 keys to
arena rows; ``MtIndex`` shards keys over T maps and prepares a batch with T
threads. Both return the reference's arrays bit for bit: the same dtypes,
uniques in first-occurrence order, new keys at ``next_row + i`` (``MtIndex``
numbers from an internal counter, so its rows depend on thread timing).

The library builds with ``g++`` at first use into ``build/``
(``ops/_build.py``). Where it cannot build, ``available()`` is False and
``build_error()`` says why; the device table then takes its numpy index.
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

_u64p = ctypes.POINTER(ctypes.c_uint64)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u32p = ctypes.POINTER(ctypes.c_uint32)


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
