"""Binary record archive (counterpart of ``paddlebox_tpu/data/archive.py``).

Parse once, spill the parsed records to disk in columnar chunks, then
load a pass from the archive instead of parsing text again
(``SlotDataset.spill_to_disk`` / ``load_from_archive``). A chunk is a
header (``<iq``: records, columns), then each column's name and its
``np.save`` array (no pickle); a zero header ends the file. The bytes are
the reference's, so an archive written by either package loads in the
other.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch.ckpt.atomic import atomic_file
from paddlebox_tpu_torch.data import ingest
from paddlebox_tpu_torch.data.record import (GLOBAL_POOL, SlotRecord,
                                             SlotRecordPool)

MAGIC = b"PBXA\x01"


def _concat(parts: List[np.ndarray], dtype) -> np.ndarray:
    return (np.concatenate(parts) if parts
            else np.empty(0, dtype=dtype))


class _Aborted(Exception):
    """Sentinel thrown into the atomic_file context to discard the tmp."""


class ArchiveWriter:
    def __init__(self, path, chunk_size: int = 4096):
        """``path``: a filesystem path, or any binary file-like (a
        ``BytesIO``: ``records_to_bytes``).

        A path is written through ``ckpt/atomic.py::atomic_file`` (tmp,
        fsync, rename, parent fsync): a crash or error mid-spill leaves a
        ``.tmp-*`` file, never a torn archive at the final path. The
        context stays open for the writer's life: ``close()`` commits,
        ``abort()`` discards."""
        self._ctx = None
        if hasattr(path, "write"):
            self._f = path
            self._owns = False
            self._f.write(MAGIC)
        else:
            self._ctx = atomic_file(path, "wb")
            self._f = self._ctx.__enter__()
            self._owns = True
            try:
                self._f.write(MAGIC)
            except BaseException as e:  # noqa: BLE001 - ctx must settle
                self.abort(e)       # discard tmp (or leave it, on crash)
                raise
        self.chunk_size = chunk_size
        self._buf: List[SlotRecord] = []
        self.count = 0

    def write(self, rec: SlotRecord) -> None:
        self._buf.append(rec)
        if len(self._buf) >= self.chunk_size:
            self._flush()

    def write_all(self, records: Sequence[SlotRecord]) -> None:
        for r in records:
            self.write(r)

    def _flush(self) -> None:
        if not self._buf:
            return
        recs = self._buf
        n = len(recs)
        u_offs = np.stack([r.uint64_offsets for r in recs])
        f_offs = np.stack([r.float_offsets for r in recs])
        cols = {
            "u_feas": _concat([r.uint64_feas for r in recs
                               if r.uint64_feas.size], np.uint64),
            "u_offs": u_offs.astype(np.int64),
            "f_feas": _concat([r.float_feas for r in recs
                               if r.float_feas.size], np.float32),
            "f_offs": f_offs.astype(np.int64),
            "label": np.array([r.label for r in recs], np.float32),
            "search_id": np.array([r.search_id for r in recs], np.int64),
            "cmatch": np.array([r.cmatch for r in recs], np.int32),
            "rank": np.array([r.rank for r in recs], np.int32),
            # unicode column (np.save writes U-dtype without pickle), so
            # merge-by-insid survives a spill and reload
            "ins_id": np.array([r.ins_id for r in recs]),
        }
        self._f.write(struct.pack("<iq", n, len(cols)))
        for name, arr in cols.items():
            nb = name.encode()
            self._f.write(struct.pack("<i", len(nb)))
            self._f.write(nb)
            np.save(self._f, arr, allow_pickle=False)
        self.count += n
        self._buf = []

    def close(self) -> None:
        """Seal and commit: the end marker, then (for a path) the atomic
        commit. A failure while sealing (ENOSPC, say) aborts, discarding
        the tmp file, before it re-raises."""
        try:
            self._flush()
            self._f.write(struct.pack("<iq", 0, 0))  # end marker
        except BaseException as e:
            self.abort(e)
            raise
        if self._owns and self._ctx is not None:
            ctx, self._ctx = self._ctx, None
            ctx.__exit__(None, None, None)

    def abort(self, exc: Optional[BaseException] = None) -> None:
        """Discard an uncommitted archive at a path (its tmp file removed,
        unless ``exc`` is a simulated crash, a non-``Exception``, which
        leaves it as a real crash would). No-op after ``close``."""
        if self._owns and self._ctx is not None:
            ctx, self._ctx = self._ctx, None
            exc = exc or _Aborted()
            try:
                ctx.__exit__(type(exc), exc, None)
            except BaseException as e:  # noqa: BLE001 - re-raised by ctx
                if e is not exc:
                    raise

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        # an error mid-spill discards the tmp file; an InjectedCrash
        # leaves it on disk as a real crash would; either way the final
        # path never holds a torn archive
        if exc_type is None:
            self.close()
        else:
            self.abort(exc)


class ArchiveReader:
    def __init__(self, path: str, pool: Optional[SlotRecordPool] = None):
        self.path = path
        self.pool = pool or GLOBAL_POOL

    def __iter__(self) -> Iterator[SlotRecord]:
        if hasattr(self.path, "read"):
            if hasattr(self.path, "seek"):
                self.path.seek(0)  # re-iterable, matching the path case
            yield from self._iter_file(self.path)
            return
        with ingest.open_with_retries(self.path, "rb") as f:
            yield from self._iter_file(f)

    def _read_chunk(self, f):
        """One (n, cols) chunk, or None at the end marker or EOF. On a
        seekable stream a transient OSError mid-chunk seeks back to the
        chunk's start and retries (op ``archive.read``)."""
        pos = f.tell() if f.seekable() else None

        def attempt():
            if pos is not None:
                f.seek(pos)
            hdr = f.read(12)
            if len(hdr) < 12:
                return None
            n, ncols = struct.unpack("<iq", hdr)
            if n == 0:
                return None
            cols = {}
            for _ in range(ncols):
                (ln,) = struct.unpack("<i", f.read(4))
                name = f.read(ln).decode()
                cols[name] = np.load(f, allow_pickle=False)
            return n, cols

        if pos is None:                 # unseekable: no safe re-read
            return attempt()
        return ingest.with_io_retries(attempt, "archive.read")

    def _iter_file(self, f) -> Iterator[SlotRecord]:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{self.path}: not a pbx archive")
        while True:
            chunk = self._read_chunk(f)
            if chunk is None:
                break
            yield from self._unpack_chunk(*chunk)

    def _unpack_chunk(self, n: int, cols) -> Iterator[SlotRecord]:
        u_offs, f_offs = cols["u_offs"], cols["f_offs"]
        u_base = 0
        f_base = 0
        recs = self.pool.get(n)
        for i in range(n):
            r = recs[i]
            uo = u_offs[i]
            fo = f_offs[i]
            r.uint64_feas = cols["u_feas"][u_base:u_base + uo[-1]]
            r.uint64_offsets = uo
            r.float_feas = cols["f_feas"][f_base:f_base + fo[-1]]
            r.float_offsets = fo
            u_base += int(uo[-1])
            f_base += int(fo[-1])
            r.label = float(cols["label"][i])
            r.search_id = int(cols["search_id"][i])
            r.cmatch = int(cols["cmatch"][i])
            r.rank = int(cols["rank"][i])
            # archives written before the column existed read back as ""
            r.ins_id = (str(cols["ins_id"][i]) if "ins_id" in cols
                        else "")
            yield r

    def read_all(self) -> List[SlotRecord]:
        return list(self)


def records_to_bytes(records: Sequence[SlotRecord]) -> bytes:
    """Records as one in-memory archive (the cross-host shuffle's wire
    format in the reference)."""
    import io
    bio = io.BytesIO()
    with ArchiveWriter(bio) as w:
        w.write_all(records)
    return bio.getvalue()


def records_from_bytes(blob: bytes,
                       pool: Optional[SlotRecordPool] = None
                       ) -> List[SlotRecord]:
    import io
    return ArchiveReader(io.BytesIO(blob), pool=pool).read_all()
