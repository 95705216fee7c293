"""The columnar file feed: C++ tokenizer -> vectorized CSR batches
(counterpart of ``paddlebox_tpu/data/fast_feed.py``'s ``FastSlotReader``).

The record pipeline (``data/parser.py`` ``SlotParser`` -> ``SlotRecord``
-> ``BatchAssembler``) is the flexible path: logkeys, instance ids,
subsampling. This is the throughput path: one C++ pass tokenizes a whole
file into columnar arrays (``csrc/pbx_feed.cpp`` ``pbx_parse_block``,
bound by ``ps/native.py::parse_block``), and a batch is a slice of those
columns padded by ``data/batch.py::pad_batch``: no per-record Python
objects anywhere. ``CTRTrainer.train_from_files`` trains from
``FastSlotReader.stream``.

The reader refuses what the record pipeline owns (logkeys, instance ids,
``sample_rate`` < 1) with the reference's ``ValueError``s. Not ported, and
refused with ``NotImplementedError``: ``pipe_command`` and the
multi-process reader ``MultiProcessReader`` with its shared-memory fabric
(ROADMAP A.2d), and ``stream_columnar`` with its ``ColumnarSlice`` views,
which only the staged device feed reads (A.4). The reference's trace
spans, ingest metrics and transient-I/O retries are not ported (A.6,
A.2d).
"""

from __future__ import annotations

import concurrent.futures as futures
import dataclasses
from collections import deque
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from paddlebox_tpu_torch.config import (BucketSpec, DataFeedConfig,
                                        batch_bucket_spec)
from paddlebox_tpu_torch.data.batch import CsrBatch, pad_batch
from paddlebox_tpu_torch.ps import native


@dataclasses.dataclass
class ColumnarBlock:
    """One parsed file: record-major flattened keys + per-record lengths."""

    keys: np.ndarray     # [total_keys] uint64, record-major, slot order
    lengths: np.ndarray  # [rows, n_sparse] int32
    labels: np.ndarray   # [rows] float32
    dense: np.ndarray    # [rows, total_dense] float32

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
        if conf.pipe_command:
            raise NotImplementedError(
                "DataFeedConfig.pipe_command (with its no-progress watchdog, "
                "data/ingest.py) is not ported yet (ROADMAP A.2d)")
        if any(s.type == "string" and s.is_used for s in conf.slots):
            raise NotImplementedError(
                "string slots (InputTableDataset) are not ported yet "
                "(ROADMAP A.2d)")
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

    def parse_file(self, path: str) -> ColumnarBlock:
        with open(path, "rb") as f:
            data = f.read()
        keys, lengths, floats, flengths, labels = native.parse_block(
            data, self.kinds, self.num_slots, len(self.dense_dims))
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

    def _batch_slices(self, files: Sequence[str], drop_remainder: bool,
                      prefetch: int):
        """The batch slicer behind ``batches``: yields ``(blk, row_lo,
        row_hi, k0, k1)`` with a short remainder carried across files.
        Concatenation reuses one capacity-retaining arena; the carried
        tail is copied into small buffers of its own, so the next round's
        concatenation never reads its own output and a sub-batch tail
        does not pin a whole parsed block."""
        B = self.conf.batch_size
        arena = self._concat_arena
        tails = self._tail_arena
        carry: List[ColumnarBlock] = []
        carry_rows = 0
        for nb in self.iter_blocks(files, prefetch=prefetch):
            carry.append(nb)
            carry_rows += nb.rows
            if carry_rows < B:
                continue
            blk = _concat_blocks(carry, arena) if len(carry) > 1 \
                else carry[0]
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
        if carry_rows and not drop_remainder:
            blk = _concat_blocks(carry, arena) if len(carry) > 1 \
                else carry[0]
            nk = int(blk.lengths.sum())
            yield (blk, 0, blk.rows, 0, nk)

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
                        drop_remainder: bool = False, prefetch: int = 0):
        raise NotImplementedError(
            "stream_columnar (ColumnarSlice views for the staged device "
            "feed, data/device_feed.py) is not ported yet (ROADMAP A.4)")

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


class MultiProcessReader(FastSlotReader):
    """The multi-process reader: not ported."""

    def __init__(self, conf: DataFeedConfig, workers: int = 2,
                 buckets: Optional[BucketSpec] = None,
                 use_shm: Optional[bool] = None):
        raise NotImplementedError(
            "MultiProcessReader (parse worker processes and the shared-"
            "memory block fabric) is not ported yet (ROADMAP A.2d)")
