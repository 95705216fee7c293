"""Atomic commit protocol for checkpoint files and directories (counterpart
of ``paddlebox_tpu/ckpt/atomic.py``, the same protocol and layout).

**File commit** (``atomic_file``, ``write_npz``, ``write_json``)::

    write <path>.tmp-<pid>-<nonce>  ->  flush + fsync(file)
    rename(tmp, path)               ->  fsync(parent dir)

A reader sees the complete old content or the complete new content, never
a torn file; ``*.tmp-*`` spill left by a crash is swept by
``retention.prune_tmp``.

**Directory commit** (``stage_dir`` + ``commit_dir``)::

    build artifacts under <dir>.tmp-<nonce>/
    write manifest.json (per-file size + crc)  ->  fsync everything
    rename(staging, dir)                       ->  fsync(parent dir)

``verify`` checks existence, size and checksum of every artifact the
manifest lists, and every load calls it. Checksums are crc32c when a
``crc32c`` module imports, else zlib's crc32; the manifest records which
(``algo``), verification follows the recorded algorithm, and an algorithm
this process cannot compute gets a size check only.
"""

from __future__ import annotations

import json
import os
import shutil
import uuid
import zlib
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

import numpy as np

from paddlebox_tpu_torch.ckpt import faults

MANIFEST = "manifest.json"
_CHUNK = 1 << 20

try:                                    # pragma: no cover - env dependent
    import crc32c as _crc32c_mod

    def _crc(data: bytes, value: int = 0) -> int:
        return _crc32c_mod.crc32c(data, value)

    CRC_ALGO = "crc32c"
except ImportError:
    def _crc(data: bytes, value: int = 0) -> int:
        return zlib.crc32(data, value)

    CRC_ALGO = "crc32"


class CheckpointError(Exception):
    """Base error of the checkpoint subsystem."""


class IntegrityError(CheckpointError):
    """An artifact failed commit-evidence or checksum verification."""


def checksum_file(path: str, algo: str = CRC_ALGO) -> int:
    """Streaming checksum of a file with the given algorithm."""
    if algo == CRC_ALGO:
        crc_fn = _crc
    elif algo == "crc32":
        crc_fn = zlib.crc32
    else:
        raise IntegrityError(f"unsupported checksum algo {algo!r}")
    value = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                return value & 0xFFFFFFFF
            value = crc_fn(chunk, value)


def _tmp_path(path: str) -> str:
    return f"{path.rstrip(os.sep)}.tmp-{os.getpid():x}-{uuid.uuid4().hex[:8]}"


def fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    fd = os.open(path or ".", os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


@contextmanager
def atomic_file(path: str, mode: str = "wb") -> Iterator:
    """Yield a file object on ``<path>.tmp-*``; commit (fsync, rename, dir
    fsync) on a clean exit. On an ``Exception`` the tmp file is removed;
    an ``InjectedCrash`` leaves it on disk, as a real crash would. The
    ``open`` and ``rename`` io_points front the two filesystem touches."""
    faults.io_point("open")
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = _tmp_path(path)
    f = open(tmp, mode)
    try:
        yield f
    except BaseException as e:
        f.close()
        if isinstance(e, Exception):
            try:
                os.unlink(tmp)
            except OSError:
                pass
        raise
    f.flush()
    os.fsync(f.fileno())
    f.close()
    faults.io_point("rename")
    os.replace(tmp, path)
    fsync_dir(parent)


def write_npz(path: str, arrays: Dict[str, np.ndarray],
              compressed: bool = True) -> None:
    """Atomically commit one .npz of named arrays, compressed as the
    reference's (``compressed=False``: a serving bundle's table, whose
    trained floats barely compress)."""
    with atomic_file(path) as f:
        (np.savez_compressed if compressed else np.savez)(f, **arrays)


def write_json(path: str, obj) -> None:
    with atomic_file(path, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)


# -- directory commit --------------------------------------------------------

def stage_dir(final_dir: str) -> str:
    """Create and return the staging dir ``<final_dir>.tmp-<nonce>``."""
    parent = os.path.dirname(final_dir.rstrip(os.sep))
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = _tmp_path(final_dir)
    os.makedirs(tmp)
    return tmp


def _artifact_files(dirpath: str) -> List[str]:
    """Relative paths of every regular file under ``dirpath`` but the
    manifest itself and tmp spill."""
    out = []
    for root, _dirs, files in os.walk(dirpath):
        for fn in files:
            rel = os.path.relpath(os.path.join(root, fn), dirpath)
            if rel == MANIFEST or ".tmp-" in fn:
                continue
            out.append(rel)
    return sorted(out)


def write_manifest(dirpath: str) -> Dict:
    """Checksum every artifact under ``dirpath`` and commit manifest.json."""
    entries = []
    for rel in _artifact_files(dirpath):
        p = os.path.join(dirpath, rel)
        entries.append({"name": rel, "size": os.path.getsize(p),
                        "crc": checksum_file(p)})
    manifest = {"version": 1, "algo": CRC_ALGO, "files": entries}
    write_json(os.path.join(dirpath, MANIFEST), manifest)
    return manifest


def commit_dir(staging: str, final: str,
               scope: Optional[str] = None) -> None:
    """Seal ``staging`` (manifest, fsyncs) and rename it to ``final``.

    ``scope`` names the crash-point family (``base``/``delta``). If
    ``final`` exists it is moved aside first and removed only after the new
    dir is committed, so a crash anywhere in between leaves at least one
    complete dir (and prunable ``.tmp-*`` spill). The ``commit_dir``
    io_point fronts it."""
    faults.io_point("commit_dir")
    if scope:
        faults.crash_point(f"{scope}.before_manifest")
    write_manifest(staging)
    for rel in _artifact_files(staging):
        fsync_file(os.path.join(staging, rel))
    for root, _dirs, _files in os.walk(staging):
        fsync_dir(root)
    if scope:
        faults.crash_point(f"{scope}.after_manifest")
    old = None
    if os.path.isdir(final):
        old = _tmp_path(final)
        os.rename(final, old)
    os.rename(staging, final)
    fsync_dir(os.path.dirname(final.rstrip(os.sep)))
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)


def verify(path: str, require_manifest: bool = False) -> None:
    """Integrity-check a committed checkpoint dir; raise ``IntegrityError``.

    A dir without a manifest passes unless ``require_manifest`` (the
    legacy layout had no commit evidence). With a manifest, every listed
    artifact must exist with the recorded size and checksum."""
    if os.path.isfile(path):
        return                      # bare files carry no manifest
    if not os.path.isdir(path):
        raise IntegrityError(f"checkpoint dir missing: {path}")
    mpath = os.path.join(path, MANIFEST)
    if not os.path.exists(mpath):
        if require_manifest:
            raise IntegrityError(f"no manifest in {path}")
        return
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise IntegrityError(f"unreadable manifest in {path}: {e}") from e
    algo = manifest.get("algo", "crc32")
    for ent in manifest.get("files", ()):
        p = os.path.join(path, ent["name"])
        if not os.path.exists(p):
            raise IntegrityError(f"missing artifact {ent['name']} in {path}")
        size = os.path.getsize(p)
        if size != ent["size"]:
            raise IntegrityError(
                f"size mismatch for {ent['name']} in {path}: "
                f"{size} != {ent['size']}")
        try:
            crc = checksum_file(p, algo)
        except IntegrityError:
            continue                # unknown algo: size check only
        if crc != ent["crc"]:
            raise IntegrityError(
                f"checksum mismatch for {ent['name']} in {path}: "
                f"{crc:#010x} != {ent['crc']:#010x}")


def is_committed(path: str, require_manifest: bool = False) -> bool:
    try:
        verify(path, require_manifest=require_manifest)
        return True
    except IntegrityError:
        return False
