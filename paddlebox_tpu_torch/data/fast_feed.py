"""The columnar file feed: C++ tokenizer -> vectorized CSR batches
(counterpart of ``paddlebox_tpu/data/fast_feed.py``'s ``FastSlotReader``
and ``MultiProcessReader``).

The record pipeline (``data/parser.py`` ``SlotParser`` -> ``SlotRecord``
-> ``BatchAssembler``) is the flexible path: logkeys, instance ids,
subsampling. This is the throughput path: one C++ pass tokenizes a whole
file into columnar arrays (``csrc/pbx_feed.cpp`` ``pbx_parse_block``,
bound by ``ps/native.py::parse_block``), and a batch is a slice of those
columns padded by ``data/batch.py::pad_batch``: no per-record Python
objects anywhere. ``CTRTrainer.train_from_files`` trains from
``FastSlotReader.stream``, or with ``workers`` > 1 from
``MultiProcessReader.stream``.

A file is read with the transient-I/O retries of ``data/ingest.py``, or
through the shell ``pipe_command`` under its no-progress watchdog.
``MultiProcessReader`` parses the files in worker processes (``python -c``
of ``_mp_worker_main``; each imports this module, which imports no torch)
and hands the blocks over through shared memory (``data/shm_fabric.py``)
or, with ``use_shm=False``, as pickles on the workers' stdout; either way
the batch stream is the single reader's, for any worker count.

``stream_columnar`` yields the batches as ``ColumnarSlice`` views of the
parsed columns, with no padding and no segment expansion: the staged
device feed (``data/device_feed.py``) packs them into its ring and the
step rebuilds the rest on the device. Under the shared-memory fabric a
slice's ``owner`` is its block's lease, which the feed pins in
defer-recycle mode (``ingest_shm_defer_recycle``).

The reader refuses what the record pipeline owns (logkeys, instance ids,
``sample_rate`` < 1) with the reference's ``ValueError``s, and string
slots with one of its own (the reference's reader takes them and writes
past the tokenizer's float buffers). As the reference does, each
``parse_file`` is an ``ingest.fast_parse`` span of the trace and an
observation of the ``ingest.fast_parse_ms`` histogram, and a worker's
wait for a free shared-memory block one of ``ingest.shm.ring_wait_ms``
(``obs/``, which imports no torch either).
"""

from __future__ import annotations

import concurrent.futures as futures
import dataclasses
import os
import subprocess
import time
from collections import deque
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from paddlebox_tpu_torch.config import (BucketSpec, DataFeedConfig,
                                        batch_bucket_spec, ingest_shm_conf)
from paddlebox_tpu_torch.data import ingest
from paddlebox_tpu_torch.data.batch import CsrBatch, pad_batch
from paddlebox_tpu_torch.obs import trace
from paddlebox_tpu_torch.obs.metrics import REGISTRY
from paddlebox_tpu_torch.ps import native


class _FrameStall(TimeoutError):
    """A worker produced no frame bytes within the watchdog deadline."""


def _select_read(fd: int, n: int, deadline: float, what: str) -> bytes:
    """One ``os.read`` of up to ``n`` bytes with a no-progress deadline
    (<= 0: wait forever), on the raw fd so the wait never races a
    buffered prefix. ``poll`` rather than ``select``: a long-running
    trainer can hold fds above FD_SETSIZE, where ``select`` raises."""
    import select

    if deadline > 0:
        if hasattr(select, "poll"):
            p = select.poll()
            p.register(fd, select.POLLIN | select.POLLHUP | select.POLLERR)
            ready = p.poll(deadline * 1000.0)
        else:                       # pragma: no cover - non-poll platforms
            ready, _, _ = select.select([fd], [], [], deadline)
        if not ready:
            raise _FrameStall(f"{what}: no bytes for {deadline:g}s")
    return os.read(fd, n)


def read_exact(stream, n: int, deadline: float, what: str) -> bytes:
    """Read exactly ``n`` bytes from a subprocess pipe, raising
    :class:`_FrameStall` after ``deadline`` seconds without progress. At
    EOF it returns what arrived (the caller reports the dead worker)."""
    fd = stream.fileno()
    buf = bytearray()
    while len(buf) < n:
        chunk = _select_read(fd, n - len(buf), deadline,
                             f"{what} ({len(buf)}/{n} read)")
        if not chunk:
            break
        buf.extend(chunk)
    return bytes(buf)


@dataclasses.dataclass
class ColumnarBlock:
    """One parsed file: record-major flattened keys + per-record lengths.
    ``owner`` is the shared-memory fabric's ``BlockLease`` when the
    arrays are views of a block (released, the block returns to its
    worker), else None (the arrays are owned)."""

    keys: np.ndarray     # [total_keys] uint64, record-major, slot order
    lengths: np.ndarray  # [rows, n_sparse] int32
    labels: np.ndarray   # [rows] float32
    dense: np.ndarray    # [rows, total_dense] float32
    owner: Optional[object] = None

    @property
    def rows(self) -> int:
        return int(self.lengths.shape[0])


class _ConcatArena:
    """Capacity-retaining buffers: block concatenation, the carried tail
    and (with ``scratch``) the batch arrays reuse one set of arrays that
    grow geometrically, instead of a fresh multi-MB allocation per call."""

    __slots__ = ("bufs",)

    def __init__(self):
        self.bufs = {}

    def take(self, name: str, shape, dtype) -> np.ndarray:
        """A [shape]-view of the named buffer, grown as needed (1.5x)."""
        n = int(np.prod(shape))
        buf = self.bufs.get(name)
        if buf is None or buf.size < n:
            cap = max(n, int((buf.size if buf is not None else 0) * 1.5))
            buf = np.empty(cap, dtype=dtype)
            self.bufs[name] = buf
        return buf[:n].reshape(shape)


def _concat_blocks(blocks: Sequence[ColumnarBlock],
                   arena: _ConcatArena) -> ColumnarBlock:
    """Concatenate parsed blocks into views of the arena's reused buffers
    (valid until the arena's next use). Inputs must be disjoint from the
    arena's buffers (the slicer carries tails in separate copies)."""
    rows = sum(b.rows for b in blocks)
    nk = sum(int(b.keys.size) for b in blocks)
    S = blocks[0].lengths.shape[1]
    Dd = blocks[0].dense.shape[1]
    out = ColumnarBlock(
        keys=arena.take("keys", (nk,), np.uint64),
        lengths=arena.take("lengths", (rows, S), np.int32),
        labels=arena.take("labels", (rows,), np.float32),
        dense=arena.take("dense", (rows, Dd), np.float32))
    ko = ro = 0
    for b in blocks:
        out.keys[ko:ko + b.keys.size] = b.keys
        out.lengths[ro:ro + b.rows] = b.lengths
        out.labels[ro:ro + b.rows] = b.labels
        out.dense[ro:ro + b.rows] = b.dense
        ko += b.keys.size
        ro += b.rows
    return out


@dataclasses.dataclass
class ColumnarSlice:
    """One batch as views of the parsed (or concatenated) block, with no
    padding, no segment expansion and no allocation: what the staged
    device feed packs (``data/device_feed.py``). The padded shapes
    (``npad`` keys, the batch's rows) and the segment ids, row mask and
    cvm input are made on the device from ``lengths`` and ``num_rows``
    (``FusedTrainStep.step_cols_tensors``). The views are valid only
    until the iterator advances."""

    keys: np.ndarray      # [num_keys] uint64 view
    lengths: np.ndarray   # [num_rows, S] int32 view
    labels: np.ndarray    # [num_rows] float32 view
    dense: np.ndarray     # [num_rows, Dd] float32 view
    num_rows: int
    num_keys: int
    npad: int             # the key bucket the staged row pads to
    #: the shared-memory block's lease behind the views (None elsewhere);
    #: a consumer that keeps the bytes past the iterator's advance pins it
    owner: object = None


class FastSlotReader:
    def __init__(self, conf: DataFeedConfig,
                 buckets: Optional[BucketSpec] = None):
        if conf.parse_logkey:
            raise ValueError(
                "fast feed has no logkey support; use SlotDataset")
        if conf.parse_ins_id:
            raise ValueError(
                "fast feed has no ins_id support (merge-by-insid is a "
                "record-pipeline feature); use SlotDataset")
        if conf.sample_rate < 1.0:
            raise ValueError(
                "fast feed has no sample_rate support (the flexible "
                "SlotParser subsamples deterministically, "
                "data/parser.py); use SlotDataset or sample_rate=1.0")
        if any(s.type == "string" and s.is_used for s in conf.slots):
            # the reference's reader takes such a slot and hands the
            # tokenizer more float slots than its buffers hold
            raise ValueError(
                "fast feed has no string-slot support (string keys map "
                "to side-table offsets at parse, a record-pipeline "
                "feature); use InputTableDataset")
        self.conf = conf
        self.buckets = buckets or batch_bucket_spec()
        self.num_slots = len(conf.used_sparse_slots)
        self.dense_dims = [s.dim for s in conf.used_dense_slots]
        self.total_dense = sum(self.dense_dims)
        kinds = []
        for s in conf.slots:
            if s.type == "uint64" and not s.is_dense:
                kinds.append(0 if s.is_used else 1)
            elif s.name == conf.label_slot:
                kinds.append(3)
            else:
                kinds.append(2 if s.is_used else 4)
        self.kinds = np.array(kinds, dtype=np.int32)
        # capacity-retaining buffers: the block concatenation (and the
        # scratch batches), and the carried sub-batch tail, apart so that a
        # tail copy never reads the concatenation's own output
        self._concat_arena = _ConcatArena()
        self._tail_arena = _ConcatArena()

    # -- file level ----------------------------------------------------------

    def _read_bytes(self, path: str) -> bytes:
        if self.conf.pipe_command:
            return self._pipe_bytes(path)

        def _read() -> bytes:
            with open(path, "rb") as f:
                return f.read()

        return ingest.with_io_retries(_read, "ingest.read")

    def _pipe_bytes(self, path: str) -> bytes:
        """``pipe_command``'s output under a no-progress watchdog: the
        deadline re-arms with every chunk, so only a command that stops
        writing for ``ingest_stall_timeout`` seconds is killed (its
        process group), with its stderr tail in the error."""
        cmd = self.conf.pipe_command
        stall = ingest.deadline()
        chunks = []
        with ingest.pipe_command_process(cmd, path) as (proc, errf):
            try:
                fd = proc.stdout.fileno()
                while True:
                    try:
                        chunk = _select_read(
                            fd, 1 << 20, stall,
                            f"pipe_command {cmd!r} on {path}")
                    except _FrameStall:
                        raise ingest.kill_and_report(
                            proc, f"pipe_command {cmd!r} produced no "
                            f"output for {stall:g}s on {path}", errf,
                            group=True) from None
                    if not chunk:
                        break
                    chunks.append(chunk)
                ingest.finish_pipe(proc, errf, cmd, path, stall)
            finally:
                proc.stdout.close()
        return b"".join(chunks)

    def parse_file(self, path: str) -> ColumnarBlock:
        """One file's columns: read (with retries, or through
        ``pipe_command``) and tokenized in one C++ pass."""
        t0 = time.perf_counter()
        with trace.span("ingest.fast_parse", path=path):
            data = self._read_bytes(path)
            keys, lengths, floats, flengths, labels = native.parse_block(
                data, self.kinds, self.num_slots, len(self.dense_dims))
        REGISTRY.observe("ingest.fast_parse_ms",
                         (time.perf_counter() - t0) * 1e3)
        rows = lengths.shape[0]
        if self.total_dense:
            dims = np.array(self.dense_dims, dtype=np.int32)
            if not (flengths == dims[None, :]).all():
                bad = int(np.argwhere(flengths != dims[None, :])[0][0])
                raise ValueError(
                    f"{path}: row {bad} dense slot width != configured dim "
                    "(fast feed needs exact dims; use SlotDataset)")
            dense = floats.reshape(rows, self.total_dense)
        else:
            dense = np.zeros((rows, 0), dtype=np.float32)
        return ColumnarBlock(keys=keys, lengths=lengths, labels=labels,
                             dense=dense)

    # -- batch assembly (vectorized) ----------------------------------------

    def _make_batch(self, blk: ColumnarBlock, row_lo: int, row_hi: int,
                    k0: int, k1: int,
                    scratch: Optional[_ConcatArena] = None) -> CsrBatch:
        """Pad one row-slice into a CsrBatch. With ``scratch`` the batch
        arrays are views into reused buffers (the same content as the
        allocating path, valid until the next call); without it they are
        fresh, so a consumer may keep batches."""
        return pad_batch(blk.lengths[row_lo:row_hi], blk.keys[k0:k1],
                         blk.labels[row_lo:row_hi], blk.dense[row_lo:row_hi],
                         self.conf.batch_size, self.buckets, scratch)

    def iter_blocks(self, files: Sequence[str],
                    prefetch: int = 0) -> Iterator[ColumnarBlock]:
        """Parsed file blocks, with ``prefetch`` > 0 parsed that many files
        ahead on a background thread while the caller consumes the current
        one. The tokenizer releases the GIL for the whole pass (a ctypes
        call), so the parse overlaps the caller's packing and launches."""
        if prefetch <= 0:
            for path in files:
                yield self.parse_file(path)
            return
        ex = futures.ThreadPoolExecutor(1,
                                        thread_name_prefix="fast-feed-parse")
        try:
            futs = deque()
            it = iter(files)
            for path in it:
                futs.append(ex.submit(self.parse_file, path))
                if len(futs) >= prefetch:
                    break
            while futs:
                blk = futs.popleft().result()
                path = next(it, None)
                if path is not None:
                    futs.append(ex.submit(self.parse_file, path))
                yield blk
        finally:
            # an abandoned or failing consumer must not leave the worker
            # parsing files nobody reads
            ex.shutdown(wait=False, cancel_futures=True)

    def _iter_owned_blocks(self, files: Sequence[str],
                           prefetch: int) -> Iterator[ColumnarBlock]:
        """The batch slicer's blocks: owned ones here; the shared-memory
        reader yields leased views (the slicer is the one consumer that
        releases leases)."""
        return self.iter_blocks(files, prefetch=prefetch)

    def _batch_slices(self, files: Sequence[str], drop_remainder: bool,
                      prefetch: int):
        """The batch slicer behind ``batches``: yields ``(blk, row_lo,
        row_hi, k0, k1)`` with a short remainder carried across files.
        Concatenation reuses one capacity-retaining arena; the carried
        tail is copied into small buffers of its own, so the next round's
        concatenation never reads its own output and a sub-batch tail
        does not pin a whole parsed block.

        A leased block (the shared-memory reader) is released as soon as
        its rows are copied out (concatenation, a sub-batch block copied
        into the carry, the tail), or, when its batches are sliced from
        it in place, once the consumer has advanced past its last one: a
        corpus of small files must not pin more blocks than a worker's
        pool holds."""
        B = self.conf.batch_size
        arena = self._concat_arena
        tails = self._tail_arena
        carry: List[ColumnarBlock] = []
        carry_rows = 0
        for nb in self._iter_owned_blocks(files, prefetch=prefetch):
            carry.append(nb)
            carry_rows += nb.rows
            if carry_rows < B:
                if nb.owner is not None:
                    carry[-1] = ColumnarBlock(
                        keys=nb.keys.copy(), lengths=nb.lengths.copy(),
                        labels=nb.labels.copy(), dense=nb.dense.copy())
                    nb.owner.release()
                continue
            if len(carry) > 1:
                blk = _concat_blocks(carry, arena)
                for c in carry:
                    if c.owner is not None:
                        c.owner.release()   # copied into the arena
                owner = None
            else:
                blk = carry[0]
                owner = blk.owner           # zero-copy fast path
            key_off = np.concatenate(
                [[0], np.cumsum(blk.lengths.sum(axis=1, dtype=np.int64))])
            full = (blk.rows // B) * B
            for lo in range(0, full, B):
                yield (blk, lo, lo + B, int(key_off[lo]),
                       int(key_off[lo + B]))
            if full < blk.rows:
                t0 = int(key_off[full])
                tail = ColumnarBlock(
                    keys=tails.take("t.keys",
                                    (blk.keys.size - t0,), np.uint64),
                    lengths=tails.take("t.lengths",
                                       (blk.rows - full,
                                        blk.lengths.shape[1]), np.int32),
                    labels=tails.take("t.labels", (blk.rows - full,),
                                      np.float32),
                    dense=tails.take("t.dense",
                                     (blk.rows - full,
                                      blk.dense.shape[1]), np.float32))
                tail.keys[:] = blk.keys[t0:]
                tail.lengths[:] = blk.lengths[full:]
                tail.labels[:] = blk.labels[full:]
                tail.dense[:] = blk.dense[full:]
                carry = [tail]
                carry_rows = blk.rows - full
            else:
                carry, carry_rows = [], 0
            if owner is not None:
                # the consumer advanced past this block's last slice and
                # the tail is copied: recycle the block to its worker
                owner.release()
        if carry_rows and not drop_remainder:
            blk = _concat_blocks(carry, arena) if len(carry) > 1 \
                else carry[0]
            nk = int(blk.lengths.sum())
            yield (blk, 0, blk.rows, 0, nk)
            for c in carry:
                if c.owner is not None:   # pragma: no cover - carries
                    c.owner.release()     # are compacted copies above

    def batches(self, files: Sequence[str],
                drop_remainder: bool = False,
                prefetch: int = 0,
                scratch: bool = False) -> Iterator[CsrBatch]:
        """CsrBatches straight off files; a short remainder is carried
        across files. ``scratch=True`` reuses one set of batch buffers
        (each batch valid only until the next iteration); the default
        allocates fresh arrays per batch."""
        sc = self._concat_arena if scratch else None
        for blk, lo, hi, k0, k1 in self._batch_slices(
                files, drop_remainder, prefetch):
            yield self._make_batch(blk, lo, hi, k0, k1, scratch=sc)

    def stream_columnar(self, files: Sequence[str],
                        drop_remainder: bool = False,
                        prefetch: int = 0) -> Iterator[ColumnarSlice]:
        """The batches of ``batches`` as ``ColumnarSlice`` views for the
        staged device feed: no padding, no segment expansion, no
        allocation a batch. Each slice is valid only until the iterator
        advances; its ``owner`` is the block's lease under the
        shared-memory fabric."""
        for blk, lo, hi, k0, k1 in self._batch_slices(
                files, drop_remainder, prefetch):
            yield ColumnarSlice(
                keys=blk.keys[k0:k1], lengths=blk.lengths[lo:hi],
                labels=blk.labels[lo:hi], dense=blk.dense[lo:hi],
                num_rows=hi - lo, num_keys=k1 - k0,
                npad=self.buckets.bucket(max(k1 - k0, 1)),
                owner=blk.owner)

    def close(self) -> None:
        """Release background resources (none for the thread reader)."""

    def stream(self, files: Sequence[str],
               drop_remainder: bool = True, prefetch: int = 0
               ) -> Iterator[Tuple[np.ndarray, ...]]:
        """The (keys, segment_ids, cvm_in, labels, dense, row_mask) tuples
        ``FusedTrainStep.train_stream`` consumes, each batch's arrays
        fresh. ``prefetch`` > 0 parses that many files ahead on a
        background thread (``iter_blocks``); the batch assembly stays on
        the caller's thread."""
        for b in self.batches(files, drop_remainder=drop_remainder,
                              prefetch=prefetch):
            cvm = np.stack([np.ones(b.batch_size, np.float32), b.labels],
                           axis=1)
            yield (b.keys, b.segment_ids, cvm, b.labels, b.dense,
                   b.row_mask())


def _mp_worker_main() -> None:
    """Parse worker's entry, run as ``python -c``: read the startup
    payload pickled on stdin, then write length-prefixed pickled frames
    on stdout. A payload ``(conf, files)`` picks the pipe protocol (whole
    parsed blocks in the frames); ``(conf, files, shm_meta)`` the
    shared-memory one (blocks in parent-owned segments, descriptors in
    the frames, stdin the free-block channel; ``data/shm_fabric.py``).
    A plain ``subprocess``, not ``multiprocessing``: spawn re-runs the
    parent's ``__main__``, and forking a process that holds a CUDA
    context is unsafe; a fresh interpreter imports only the feed chain,
    which imports no torch."""
    import pickle
    import sys

    out = sys.stdout.buffer

    def emit(msg) -> None:
        payload = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
        out.write(len(payload).to_bytes(8, "little"))
        out.write(payload)
        out.flush()

    try:
        payload = pickle.load(sys.stdin.buffer)
        if len(payload) == 2:
            conf, files = payload
            meta = None
        else:
            conf, files, meta = payload
        reader = FastSlotReader(conf)
        if meta is None:
            for path in files:
                blk = reader.parse_file(path)
                emit(("blk", blk.keys, blk.lengths, blk.labels,
                      blk.dense))
        else:
            _mp_worker_shm(reader, files, meta, emit)
        emit(("end",))
    except BaseException as e:  # noqa: BLE001 - surfaced in the parent
        try:
            emit(("error", f"{type(e).__name__}: {e}"))
        except Exception:  # noqa: BLE001
            pass


def _mp_worker_shm(reader: FastSlotReader, files: Sequence[str],
                   meta: dict, emit) -> None:
    """The shared-memory worker: parse each file of the shard, write its
    columns into a free parent-owned block (split on row boundaries when
    a file outgrows a block) and announce it with a descriptor ``(shm,
    version, block, seq, nrows, nkeys, crc, wait_ms, last)``, written
    only after the block's body. With no free block the worker waits on
    the parent's free channel (the bounded pool's backpressure).
    ``meta["fault"] = {"op": "torn_block", "file_index": i}`` corrupts a
    key after its crc, announces the block and kills the worker (the
    test hook of a worker killed mid-block)."""
    import sys

    from paddlebox_tpu_torch.data import shm_fabric

    pool = shm_fabric.WorkerBlockPool(meta["names"], sys.stdin.buffer)
    cap = int(meta["block_bytes"])
    use_crc = bool(meta.get("crc", True))
    fault = meta.get("fault") or {}
    seq = 0
    try:
        for fi, path in enumerate(files):
            blk = reader.parse_file(path)
            S = blk.lengths.shape[1]
            Dd = blk.dense.shape[1]
            key_off = np.concatenate(
                [[0], np.cumsum(blk.lengths.sum(axis=1, dtype=np.int64))])
            ranges = shm_fabric.split_rows(blk.lengths, Dd, cap)
            for pi, (lo, hi) in enumerate(ranges):
                bid, buf, waited = pool.acquire()
                nrows = hi - lo
                k0, k1 = int(key_off[lo]), int(key_off[hi])
                nkeys = k1 - k0
                keys, lengths, labels, dense = shm_fabric.block_views(
                    buf, nrows, nkeys, S, Dd)
                keys[:] = blk.keys[k0:k1]
                lengths[:] = blk.lengths[lo:hi]
                labels[:] = blk.labels[lo:hi]
                dense[:] = blk.dense[lo:hi]
                crc = shm_fabric.block_crc(buf, nrows, nkeys, S, Dd) \
                    if use_crc else 0
                last = pi == len(ranges) - 1
                ver = shm_fabric.WIRE_VERSION
                if fault.get("op") == "torn_block" \
                        and fault.get("file_index") == fi:
                    import os as _os
                    import signal as _signal
                    if nkeys:
                        keys[0] ^= np.uint64(0xFF)
                    emit(("shm", ver, bid, seq, nrows, nkeys, crc,
                          waited * 1e3, last))
                    _os.kill(_os.getpid(), _signal.SIGKILL)
                emit(("shm", ver, bid, seq, nrows, nkeys, crc,
                      waited * 1e3, last))
                seq += 1
    finally:
        pool.close()


class MultiProcessReader(FastSlotReader):
    """Files parsed in worker processes, batched by the same vectorized
    assembly: processes, because the C++ tokenizer releases the GIL but
    the rest of a file's cost (``pipe_command`` I/O, array fix-ups, the
    hand-off) does not.

    Worker ``w`` parses files ``w, w+W, w+2W, ...``; the parent reads
    them back in file order, so the batch stream is the single reader's
    for any worker count.

    Two hand-off protocols (``use_shm``, else the ``ingest_shm`` flag):

    - **shared memory** (default): workers parse into parent-owned
      shared-memory blocks in the columnar layout, the pipe carries only
      descriptors, and the parent maps each block zero-copy. Each
      worker's pool of ``ingest_shm_blocks`` blocks is the backpressure.
    - **pipe** (``use_shm=False``): length-prefixed pickled blocks on
      each worker's stdout.

    Both give the same stream, bit for bit. ``shm_counters`` sums the
    fabrics' counts over the reader's passes (``blocks``, ``bytes``,
    ``copies_elided``, ``crc_failures``, ``leaked_segments``: the
    segments still named after ``close()`` unlinked them, 0 on every
    clean path; ``ring_wait_ms``: the workers' waits for a free
    block). Under ``ingest_shm_defer_recycle`` a block stays with the
    parent until the staged device feed's run that read it has retired
    (``data/shm_fabric.py`` ``BlockLease.pin``)."""

    def __init__(self, conf: DataFeedConfig, workers: int = 2,
                 buckets: Optional[BucketSpec] = None,
                 use_shm: Optional[bool] = None):
        super().__init__(conf, buckets)
        if workers < 1:
            raise ValueError("workers must be >= 1")
        enabled, blocks, block_bytes, crc, defer = ingest_shm_conf(use_shm)
        self.workers = workers
        self.use_shm = enabled
        self._shm_blocks = blocks
        self._shm_block_bytes = block_bytes
        self._shm_crc = crc
        self._shm_defer = defer
        self._fabric = None
        self._worker_fault: Optional[dict] = None   # test hook
        self.shm_counters: dict = {}
        self._procs: List = []
        self._stdins: List = []
        self._errfiles: List = []

    def close(self) -> None:
        """Tear down in this order: (1) kill every worker's process
        group, so a worker's ``pipe_command`` children die with it and
        hold no pipe open; (2) close the parent's pipe ends; (3) unlink
        every segment and probe the names (``leaked_segments`` counts
        what still resolves). Idempotent; every exit of the iterators
        calls it."""
        for p in getattr(self, "_procs", ()):
            ingest.kill_subprocess(p, group=True)
        self._procs = []
        for s in getattr(self, "_stdins", ()):
            try:
                s.close()
            except Exception:  # noqa: BLE001
                pass
        self._stdins = []
        for f in getattr(self, "_errfiles", ()):
            try:
                f.close()
            except Exception:  # noqa: BLE001
                pass
        self._errfiles = []
        fabric = getattr(self, "_fabric", None)
        if fabric is not None:
            self._fabric = None
            fabric.close()
            self._count_shm(fabric.counters)

    def _count_shm(self, counts: dict) -> None:
        for k, v in counts.items():
            self.shm_counters[k] = self.shm_counters.get(k, 0) + v

    def _worker_died(self, w: int, what: str) -> RuntimeError:
        tail = ingest.stderr_tail(self._errfiles[w])
        return RuntimeError(
            f"parse worker failed on shard {w} ({what}); stderr tail: "
            f"{tail!r}")

    def _read_msg(self, w: int):
        """One length-prefixed frame from worker ``w`` under the
        no-progress deadline: a worker that wedges (a dead one closes the
        pipe) is killed and reported with its stderr tail."""
        import pickle

        p = self._procs[w]
        stall = ingest.deadline()
        try:
            hdr = read_exact(p.stdout, 8, stall, f"worker {w} frame header")
            if len(hdr) < 8:
                raise self._worker_died(w, "died without reporting")
            n = int.from_bytes(hdr, "little")
            payload = read_exact(p.stdout, n, stall, f"worker {w} payload")
            if len(payload) < n:
                raise self._worker_died(w, "died mid-payload")
        except _FrameStall as e:
            raise ingest.kill_and_report(
                p, f"parse worker {w} stalled ({e})", self._errfiles[w],
                group=True) from None
        try:
            return pickle.loads(payload)
        except Exception:  # noqa: BLE001 - corrupt frame == dead worker
            raise self._worker_died(w, "sent a corrupt frame")

    def _spawn_workers(self, n: int) -> None:
        """Start ``n`` workers. The tokenizer is built (or loaded) here
        first, so the workers load it instead of each compiling it."""
        import sys
        import tempfile

        native._load_feed()
        cmd = [sys.executable, "-c",
               "from paddlebox_tpu_torch.data.fast_feed import "
               "_mp_worker_main; _mp_worker_main()"]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [p for p in sys.path if p]
            + [x for x in [env.get("PYTHONPATH")] if x])
        self._errfiles = [tempfile.TemporaryFile() for _ in range(n)]
        self._procs = [
            subprocess.Popen(cmd, stdin=subprocess.PIPE,
                             stdout=subprocess.PIPE,
                             stderr=self._errfiles[w], env=env,
                             start_new_session=True)
            for w in range(n)]

    def _send_payload(self, w: int, payload: tuple) -> None:
        import pickle

        p = self._procs[w]
        try:
            pickle.dump(payload, p.stdin,
                        protocol=pickle.HIGHEST_PROTOCOL)
            p.stdin.flush()
        except BrokenPipeError:
            # the child died at import: its traceback is in the stderr
            # file, not on this pipe
            p.wait(timeout=5)
            raise self._worker_died(w, "exited before reading its shard")

    def iter_blocks(self, files: Sequence[str],
                    prefetch: int = 0) -> Iterator[ColumnarBlock]:
        """One owned block a file (the workers parse ahead; ``prefetch``
        is ignored): a shared-memory file's parts are copied out and
        their leases released at once, so a caller may keep blocks. The
        zero-copy path is :meth:`_iter_owned_blocks`, the batch
        slicer's."""
        if not self.use_shm:
            yield from self._iter_pipe(files)
            return
        parts: List[ColumnarBlock] = []
        for blk, last in self._iter_shm(list(files)):
            # copy and release each part: holding a multi-part file's
            # leases could pin more blocks than the worker's pool holds
            parts.append(ColumnarBlock(
                keys=blk.keys.copy(), lengths=blk.lengths.copy(),
                labels=blk.labels.copy(), dense=blk.dense.copy()))
            if blk.owner is not None:
                blk.owner.release()
            if not last:
                continue
            merged = parts[0] if len(parts) == 1 else ColumnarBlock(
                keys=np.concatenate([b.keys for b in parts]),
                lengths=np.concatenate([b.lengths for b in parts]),
                labels=np.concatenate([b.labels for b in parts]),
                dense=np.concatenate([b.dense for b in parts]))
            parts = []
            yield merged

    def _iter_owned_blocks(self, files: Sequence[str],
                           prefetch: int = 0) -> Iterator[ColumnarBlock]:
        """Leased zero-copy blocks for the batch slicer (shared memory),
        or the pipe's owned blocks."""
        if not self.use_shm:
            yield from self._iter_pipe(files)
            return
        for blk, _last in self._iter_shm(list(files)):
            yield blk

    def _iter_pipe(self, files: Sequence[str]) -> Iterator[ColumnarBlock]:
        """The pipe protocol: whole parsed blocks in the frames."""
        files = list(files)
        W = min(self.workers, max(len(files), 1))
        shards = [files[w::W] for w in range(W)]
        self._spawn_workers(W)
        try:
            for w, p in enumerate(self._procs):
                self._send_payload(w, (self.conf, shards[w]))
                p.stdin.close()
            for i in range(len(files)):
                msg = self._read_msg(i % W)
                if msg[0] == "error":
                    raise RuntimeError(
                        f"parse worker failed on shard {i % W}: {msg[1]}")
                if msg[0] != "blk":
                    raise RuntimeError(
                        f"worker protocol violation: {msg[0]!r}")
                yield ColumnarBlock(keys=msg[1], lengths=msg[2],
                                    labels=msg[3], dense=msg[4])
            for w in range(W):
                end = self._read_msg(w)
                if end[0] == "error":
                    raise RuntimeError(
                        f"parse worker failed on shard {w}: {end[1]}")
        finally:
            self.close()

    def _iter_shm(self, files: List[str]
                  ) -> Iterator[Tuple[ColumnarBlock, bool]]:
        """The shared-memory protocol: spawn the workers over a fresh
        segment pool, read the descriptors in file order, map each block
        zero-copy and yield ``(leased block, last part of its file)``. A
        crc mismatch is a torn block: the worker is killed and the error
        names worker, seq and file."""
        from paddlebox_tpu_torch.data import shm_fabric

        W = min(self.workers, max(len(files), 1))
        shards = [files[w::W] for w in range(W)]
        self._fabric = shm_fabric.ShmFabric(
            W, self._shm_blocks, self._shm_block_bytes,
            defer_recycle=self._shm_defer)
        self._spawn_workers(W)
        try:
            for w, p in enumerate(self._procs):
                meta = self._fabric.worker_meta(w)
                meta["crc"] = self._shm_crc
                if self._worker_fault \
                        and self._worker_fault.get("worker", 0) == w:
                    meta["fault"] = dict(self._worker_fault)
                self._send_payload(w, (self.conf, shards[w], meta))
                # stdin stays open: it is the free-block channel now
                self._fabric.attach_sender(w, p.stdin)
                self._stdins.append(p.stdin)
            S = self.num_slots
            Dd = self.total_dense
            expect_seq = [0] * W
            for i in range(len(files)):
                w = i % W
                last = False
                while not last:
                    msg = self._read_msg(w)
                    if msg[0] == "error":
                        raise RuntimeError(
                            f"parse worker failed on shard {w}: {msg[1]}")
                    if msg[0] != "shm":
                        raise RuntimeError(
                            f"worker protocol violation: {msg[0]!r}")
                    (_tag, ver, bid, seq, nrows, nkeys, crc,
                     wait_ms, last) = msg
                    if ver != shm_fabric.WIRE_VERSION:
                        raise self._worker_died(
                            w, f"descriptor wire version {ver} != "
                               f"{shm_fabric.WIRE_VERSION} (mixed "
                               "parent/worker builds?)")
                    if seq != expect_seq[w]:
                        raise self._worker_died(
                            w, f"descriptor out of order (seq {seq}, "
                               f"expected {expect_seq[w]})")
                    expect_seq[w] += 1
                    self._count_shm({"ring_wait_ms": wait_ms})
                    if wait_ms > 0:
                        REGISTRY.observe("ingest.shm.ring_wait_ms",
                                         wait_ms)
                    try:
                        views, lease = self._fabric.lease(
                            w, int(bid), int(nrows), int(nkeys), S, Dd,
                            int(crc) if self._shm_crc else None)
                    except shm_fabric.TornBlock as e:
                        ingest.INGEST_STATS.add("torn_blocks")
                        raise ingest.kill_and_report(
                            self._procs[w],
                            f"parse worker {w} announced a torn shm "
                            f"block (seq {seq}, file {files[i]}): {e}",
                            self._errfiles[w], group=True) from None
                    keys, lengths, labels, dense = views
                    yield (ColumnarBlock(keys=keys, lengths=lengths,
                                         labels=labels, dense=dense,
                                         owner=lease), bool(last))
            for w in range(W):
                end = self._read_msg(w)
                if end[0] == "error":
                    raise RuntimeError(
                        f"parse worker failed on shard {w}: {end[1]}")
        finally:
            self.close()
