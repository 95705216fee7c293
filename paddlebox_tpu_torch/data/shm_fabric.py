"""Shared-memory ingest fabric: the multi-process reader's zero-copy
handoff from parse worker to parent (counterpart of
``paddlebox_tpu/data/shm_fabric.py``).

``data/fast_feed.py`` ``MultiProcessReader`` can hand parsed blocks over
as length-prefixed pickles on the workers' stdout pipes (the legacy
protocol). This module replaces the pipe's payload with parent-owned
POSIX shared-memory blocks in the columnar wire layout; the pipe carries
only small descriptors:

  worker                          parent
  ------                          ------
  parse a file (pbx_parse_block)
  write its columns into a free
  block: keys|lengths|labels|     map the block zero-copy as numpy
         dense (u64/i32/f32)      views -> ColumnarBlock -> batch slicer
  emit a descriptor on stdout --> (shm, version, block, seq, nrows,
                                   nkeys, crc, wait_ms, last)
  wait on stdin for a free    <-- 4-byte block id once the slicer is
  id when the pool is empty       done with the block
  (the bounded pool is the
  backpressure)

Ownership and cleanup:

- The parent creates every segment, so its resource tracker owns them: an
  abnormal parent exit unlinks them. Workers attach and unregister from
  their own tracker.
- ``ShmFabric.close()`` runs after the caller has killed the worker
  process groups: every segment is unlinked, then probed by name; a name
  that still resolves counts into ``counters["leaked_segments"]``.
- Each count of ``counters`` also goes to the global registry as
  ``ingest.shm.<name>``, as the reference counts it.
- A descriptor is written only after its block's body, so a worker killed
  mid-block just closes the pipe; each descriptor also carries a crc32 of
  the body (``ingest_shm_crc``), and a mismatch is a torn block.
- A block recycles when the last holder of its ``BlockLease`` releases
  it. The batch slicer is the only holder unless
  ``ingest_shm_defer_recycle`` is on; then the staged device feed pins
  each lease to the ring slot its rows were packed into, and the block
  recycles once the run that read that slot has retired.

Imported by the parse workers: it imports neither torch nor jax.
"""

from __future__ import annotations

import atexit
import os
import secrets
import threading
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from paddlebox_tpu_torch.obs.metrics import REGISTRY

#: wire-format version stamped into descriptors (protocol integrity).
WIRE_VERSION = 1

#: bytes of the free-id frame the parent writes to a worker's stdin.
FREE_FRAME_BYTES = 4

#: prefix of the port's segment names, ``pbxt_shm_<pid>_<token>_<w>_<b>``
#: (the reference's are ``pbx_shm_...``: both packages may run in one
#: process without their names or their leak probes meeting)
PREFIX = "pbxt_shm_"

#: segments whose close() was deferred because live numpy views still
#: export their mapping (a consumer outliving its reader's close). Held
#: here so ``SharedMemory.__del__`` cannot run while a view lives (it
#: would raise an unraisable BufferError), and closed at interpreter
#: exit.
_LINGERING: List[object] = []


def _drain_lingering() -> None:    # pragma: no cover - interpreter exit
    for shm in _LINGERING:
        try:
            shm.close()
        except Exception:  # noqa: BLE001
            pass


atexit.register(_drain_lingering)


class TornBlock(RuntimeError):
    """A descriptor's crc does not match its block body: the worker died
    (or reordered its writes) mid-block."""


# -- block wire layout --------------------------------------------------------
#
# One parsed block, columnar, in a single segment (nrows/nkeys ride the
# descriptor):
#
#   keys    u64[nkeys]            record-major flattened feature keys
#   lengths i32[nrows, n_slots]   per-record per-slot key counts
#   labels  f32[nrows]
#   dense   f32[nrows, dense_dim]
#
# The layout and the descriptor are the reference's.

def block_nbytes(nrows: int, nkeys: int, n_slots: int,
                 dense_dim: int) -> int:
    """Total bytes of a block with the given shape."""
    return 8 * nkeys + 4 * nrows * n_slots + 4 * nrows \
        + 4 * nrows * dense_dim


def block_views(buf, nrows: int, nkeys: int, n_slots: int,
                dense_dim: int) -> Tuple[np.ndarray, np.ndarray,
                                         np.ndarray, np.ndarray]:
    """(keys, lengths, labels, dense) numpy views over ``buf`` in the
    block wire layout — zero-copy on both sides of the fabric.  Offsets
    stay dtype-aligned by construction (u64 first, then 4-byte types)."""
    o = 0
    keys = np.frombuffer(buf, np.uint64, count=nkeys, offset=o)
    o += 8 * nkeys
    lengths = np.frombuffer(buf, np.int32, count=nrows * n_slots,
                            offset=o).reshape(nrows, n_slots)
    o += 4 * nrows * n_slots
    labels = np.frombuffer(buf, np.float32, count=nrows, offset=o)
    o += 4 * nrows
    dense = np.frombuffer(buf, np.float32, count=nrows * dense_dim,
                          offset=o).reshape(nrows, dense_dim)
    return keys, lengths, labels, dense


def block_crc(buf, nrows: int, nkeys: int, n_slots: int,
              dense_dim: int) -> int:
    """crc32 over the used byte range of a block, read off the mapping
    (no copy); ``ingest_shm_crc=0`` skips it."""
    n = block_nbytes(nrows, nkeys, n_slots, dense_dim)
    return zlib.crc32(memoryview(buf)[:n]) & 0xFFFFFFFF


def split_rows(lengths: np.ndarray, dense_dim: int,
               cap_bytes: int) -> List[Tuple[int, int]]:
    """Row ranges ``[(lo, hi), ...]`` covering a parsed file such that
    every range's block fits ``cap_bytes``. Splits fall on row
    boundaries, so they never change a batch: the batch slicer windows
    the cumulative row stream."""
    nrows, n_slots = lengths.shape
    if nrows == 0:
        return [(0, 0)]
    per_row = (lengths.sum(axis=1, dtype=np.int64) * 8
               + 4 * n_slots + 4 + 4 * dense_dim)
    too_big = per_row > cap_bytes
    if too_big.any():
        r = int(np.argmax(too_big))
        raise ValueError(
            f"row {r} needs {int(per_row[r])} bytes > "
            f"ingest_shm_block_bytes ({cap_bytes}); raise the flag")
    out = []
    lo = 0
    csum = np.cumsum(per_row)
    base = 0
    while lo < nrows:
        hi = int(np.searchsorted(csum, base + cap_bytes,
                                 side="right"))
        hi = max(hi, lo + 1)
        out.append((lo, min(hi, nrows)))
        lo = min(hi, nrows)
        base = csum[lo - 1] if lo > 0 else 0
    return out


# -- segment helpers ----------------------------------------------------------

def _shared_memory():
    from multiprocessing import shared_memory
    return shared_memory


def attach(name: str):
    """Worker-side attach. Python <= 3.12 registers every attach with
    the process's resource tracker, so a worker's exit would unlink
    segments the parent still reads (and warn): unregister, the parent
    cleans up."""
    shm = _shared_memory().SharedMemory(name=name)
    try:
        from multiprocessing import resource_tracker
        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:  # noqa: BLE001 - best effort, version-dependent
        pass
    return shm


def probe_leaks(names: Sequence[str]) -> List[str]:
    """Those of ``names`` that still resolve to a live segment (empty
    after a clean close). On Linux a stat in /dev/shm: attaching would
    register the name with this process's resource tracker again."""
    shm_dir = "/dev/shm"
    if os.path.isdir(shm_dir):
        return [n for n in names
                if os.path.exists(os.path.join(shm_dir, n))]
    leaked = []                      # pragma: no cover - non-/dev/shm
    for name in names:
        try:
            shm = _shared_memory().SharedMemory(name=name)
        except FileNotFoundError:
            continue
        except OSError:
            continue
        # attached only to probe: detach, leaving the name as found
        try:
            from multiprocessing import resource_tracker
            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception:  # noqa: BLE001
            pass
        try:
            shm.close()
        except Exception:  # noqa: BLE001
            pass
        leaked.append(name)
    return leaked


# -- parent-side fabric -------------------------------------------------------

class BlockLease:
    """Refcounted parent-side handle of one block in flight. The batch
    slicer holds the first reference and releases it once the block's
    rows are consumed (sliced, or copied to the carry). In defer-recycle
    mode the staged device feed ``pin()``s the lease onto the ring slot
    its slices were packed into (``data/device_feed.py``), so the block
    goes back to its worker only once the run that read the slot has
    retired. The last reference out sends the free frame; a release past
    it does nothing."""

    __slots__ = ("_fabric", "worker", "block", "_refs", "_lock")

    def __init__(self, fabric: "ShmFabric", worker: int, block: int):
        self._fabric = fabric
        self.worker = worker
        self.block = block
        self._refs = 1
        self._lock = threading.Lock()

    def pin(self) -> bool:
        """One more holder, in defer-recycle mode only (otherwise the
        block recycles at the slicer's release: every consumer copies out
        of it before advancing). Returns whether a matching
        :meth:`release` is owed."""
        if not self._fabric.defer_recycle:
            return False
        with self._lock:
            if self._refs <= 0:
                return False  # already recycled: nothing to extend
            self._refs += 1
        return True

    def release(self) -> None:
        with self._lock:
            if self._refs <= 0:
                return
            self._refs -= 1
            done = self._refs == 0
        if done:
            self._fabric._recycle(self.worker, self.block)


class ShmFabric:
    """Parent-owned segment pool: ``blocks`` segments of ``block_bytes``
    a worker, created before the workers spawn and unlinked on close.
    ``counters`` holds the reference's ``ingest.shm.*`` counts (blocks,
    bytes, copies_elided, crc_failures, leaked_segments).
    ``defer_recycle`` (the ``ingest_shm_defer_recycle`` flag) lets a
    lease be pinned past the slicer's release (``BlockLease.pin``)."""

    def __init__(self, workers: int, blocks: int, block_bytes: int,
                 defer_recycle: bool = False):
        if workers < 1:
            raise ValueError("fabric needs >= 1 worker")
        if blocks < 2:
            raise ValueError(
                f"ingest_shm_blocks must be >= 2 (one block mapping "
                f"parent-side while another parses), got {blocks}")
        self.workers = workers
        self.blocks = blocks
        self.block_bytes = int(block_bytes)
        self.defer_recycle = bool(defer_recycle)
        self._lock = threading.Lock()
        self._closed = False               # guarded-by: _lock
        self._stdin: Dict[int, object] = {}  # worker -> stdin, guarded
        self.counters: Dict[str, int] = {}
        token = secrets.token_hex(4)
        shared_memory = _shared_memory()
        self.names: List[List[str]] = []
        self._shms: List[List[object]] = []
        try:
            for w in range(workers):
                # rows registered before they fill: a create that fails
                # mid-row leaves its predecessors where close() unlinks
                # them
                row_names: List[str] = []
                row_shms: List[object] = []
                self.names.append(row_names)
                self._shms.append(row_shms)
                for b in range(blocks):
                    name = f"{PREFIX}{os.getpid()}_{token}_{w}_{b}"
                    row_shms.append(shared_memory.SharedMemory(
                        name=name, create=True, size=self.block_bytes))
                    row_names.append(name)
        except BaseException:
            self.close()
            raise

    def _count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n
        if n:
            REGISTRY.add(f"ingest.shm.{name}", n)

    # -- wiring ---------------------------------------------------------------

    def attach_sender(self, worker: int, stdin) -> None:
        """Register the worker's stdin as its free-frame channel."""
        with self._lock:
            self._stdin[worker] = stdin

    def worker_meta(self, worker: int) -> dict:
        """The shm half of a worker's startup payload."""
        return {"names": list(self.names[worker]),
                "block_bytes": self.block_bytes}

    # -- data path ------------------------------------------------------------

    def lease(self, worker: int, block: int, nrows: int, nkeys: int,
              n_slots: int, dense_dim: int, crc: Optional[int] = None
              ) -> Tuple[Tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray], BlockLease]:
        """Map one announced block zero-copy; verify its crc when given.
        Returns (views, lease): the views stay valid until the lease's
        last reference is released."""
        need = block_nbytes(nrows, nkeys, n_slots, dense_dim)
        if need > self.block_bytes:
            raise TornBlock(
                f"descriptor claims {need} bytes > block capacity "
                f"{self.block_bytes} (worker {worker} block {block})")
        shm = self._shms[worker][block]
        if crc is not None:
            got = block_crc(shm.buf, nrows, nkeys, n_slots, dense_dim)
            if got != crc:
                self._count("crc_failures")
                raise TornBlock(
                    f"block crc mismatch (worker {worker} block {block}: "
                    f"got {got:#010x}, descriptor {crc:#010x})")
        self._count("blocks")
        self._count("bytes", need)
        # the pipe protocol's pickle and unpickle of this block
        self._count("copies_elided", 2)
        return (block_views(shm.buf, nrows, nkeys, n_slots, dense_dim),
                BlockLease(self, worker, block))

    def _recycle(self, worker: int, block: int) -> None:
        """Send the free frame; a no-op for a dead worker or a closed
        fabric. After close, the last lease out closes the mapping its
        live views had kept open (the name is already unlinked)."""
        with self._lock:
            if self._closed:
                shm = self._shms[worker][block]
                try:
                    shm.close()
                except (BufferError, OSError):
                    pass
                return
            stdin = self._stdin.get(worker)
        if stdin is None:
            return
        try:
            with self._lock:
                stdin.write(int(block).to_bytes(FREE_FRAME_BYTES,
                                                "little"))
                stdin.flush()
        except (OSError, ValueError):
            pass  # worker gone; nothing left to backpressure

    # -- teardown -------------------------------------------------------------

    def close(self) -> int:
        """Unlink every segment and probe the names; leftovers count
        into ``leaked_segments``. Idempotent. Callers kill the worker
        process trees first (``MultiProcessReader.close``), so no
        worker's child can open a name between the unlink and the probe.
        Returns the number of leaked segments (0 on every clean path)."""
        with self._lock:
            if self._closed:
                return 0
            self._closed = True
            self._stdin.clear()
        for row in self._shms:
            for shm in row:
                try:
                    shm.unlink()
                except FileNotFoundError:
                    pass
                except OSError:
                    pass
                try:
                    shm.close()
                except BufferError:
                    # a consumer still holds views: the name is gone;
                    # the mapping closes at the last lease's release or
                    # at exit
                    _LINGERING.append(shm)
                except OSError:
                    pass
        leaked = probe_leaks([n for row in self.names for n in row])
        self._count("leaked_segments", len(leaked))
        return len(leaked)

    def __enter__(self) -> "ShmFabric":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- worker-side allocator ----------------------------------------------------

class WorkerBlockPool:
    """The worker half: the attached segments and the free list.
    ``acquire()`` pops a free block or blocks reading the parent's
    4-byte free frames from stdin: the bounded pool is the backpressure
    that keeps a parser from running ahead of the trainer. Returns
    ``(block_id, buf, wait_seconds)``; the wait rides the next
    descriptor to the parent."""

    def __init__(self, names: Sequence[str], stdin):
        self._shms = [attach(n) for n in names]
        self._free = list(range(len(self._shms)))[::-1]
        self._stdin = stdin

    def acquire(self) -> Tuple[int, object, float]:
        import time
        if self._free:
            bid = self._free.pop()
            return bid, self._shms[bid].buf, 0.0
        t0 = time.perf_counter()
        frame = self._stdin.read(FREE_FRAME_BYTES)
        if len(frame) < FREE_FRAME_BYTES:
            raise EOFError("parent closed the free channel")
        bid = int.from_bytes(frame, "little")
        return bid, self._shms[bid].buf, time.perf_counter() - t0

    def close(self) -> None:
        for shm in self._shms:
            try:
                shm.close()
            except (BufferError, OSError):
                pass
