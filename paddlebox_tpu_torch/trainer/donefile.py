"""Donefile protocol: append-only records of saved models, for resume and
for serving (counterpart of ``paddlebox_tpu/trainer/donefile.py``, the
same JSON-lines file, ``donefile.jsonl``, and the same records).

Every base or delta save appends one record ``{day, pass_id, kind, path,
size, ts}``; resume reads the last base and the deltas after it.

- ``write_done`` fsyncs the append: a record in the trail means the bytes
  are on disk. The background writer appends only after the artifact dir
  committed, so the trail is a prefix of what is durable.
- A crash mid-append leaves a torn last line; ``read_done`` drops exactly
  that (with a warning), and ``write_done`` cuts it off before appending.
  A malformed line anywhere else is corruption and raises.
- ``resume_candidates`` and ``resume_plan`` skip records whose path no
  longer exists (pruned by retention, or lost to a crash).
"""

from __future__ import annotations

import json
import os
import time
import warnings
from typing import Dict, List, Optional, Tuple

from paddlebox_tpu_torch.ckpt import faults

DONEFILE = "donefile.jsonl"


def _truncate_torn_tail(p: str) -> None:
    """Cut a crash-torn trail back to its last complete line before an
    append: a new record welded onto the torn bytes would turn a tolerated
    trailing tear into corruption in the middle of the file."""
    try:
        size = os.path.getsize(p)
    except OSError:
        return
    if not size:
        return
    with open(p, "rb+") as f:
        f.seek(-1, os.SEEK_END)
        if f.read(1) == b"\n":
            return
        f.seek(0)
        data = f.read()
        keep = data.rfind(b"\n") + 1     # 0 when no newline at all
        warnings.warn(f"donefile {p}: truncating torn tail "
                      f"({size - keep} bytes) before append")
        f.truncate(keep)
        f.flush()
        os.fsync(f.fileno())


def _dir_size(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total


def write_done(root: str, day: str, pass_id: int, kind: str,
               path: str, extra: Optional[Dict] = None) -> Dict:
    """Append a record (kind: 'base' | 'delta' | 'dense'), fsynced: once
    this returns, the record survives a crash."""
    rec = {"day": str(day), "pass_id": int(pass_id), "kind": kind,
           "path": os.path.abspath(path), "size": _dir_size(path)
           if os.path.isdir(path) else os.path.getsize(path),
           "ts": time.time()}
    if extra:
        rec.update(extra)
    os.makedirs(root, exist_ok=True)
    line = json.dumps(rec) + "\n"
    faults.io_point("donefile.append")
    _truncate_torn_tail(os.path.join(root, DONEFILE))
    with open(os.path.join(root, DONEFILE), "a") as f:
        # two writes with a crash point between: the drill's torn line
        cut = max(1, len(line) // 2)
        f.write(line[:cut])
        faults.crash_point("donefile.mid_append")
        f.write(line[cut:])
        f.flush()
        os.fsync(f.fileno())
    return rec


def read_done(root: str) -> List[Dict]:
    """Parse the trail. A torn last line is dropped with a warning; a
    malformed line followed by further records raises ``ValueError``."""
    p = os.path.join(root, DONEFILE)
    if not os.path.exists(p):
        return []
    with open(p) as f:
        lines = f.read().split("\n")
    out: List[Dict] = []
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except ValueError as e:
            if all(not rest.strip() for rest in lines[i + 1:]):
                warnings.warn(f"donefile {p}: dropping torn trailing "
                              f"line {i + 1} ({e})")
                break
            raise ValueError(
                f"corrupt donefile {p}: malformed line {i + 1} is not "
                f"trailing; manual repair needed") from e
    return out


def last_done(root: str, kind: str) -> Optional[Dict]:
    """The last record of ``kind``, or None."""
    recs = [r for r in read_done(root) if r["kind"] == kind]
    return recs[-1] if recs else None


def resume_candidates(root: str) -> List[Tuple[Dict, List[Dict]]]:
    """Every restore plan, newest base first: (base record, the delta
    records between it and the next base).

    Chains are cut on the whole trail, then pruned: a base whose path
    vanished is no candidate but still ends the chain before it (its
    deltas hold only rows dirty since it); a vanished delta ends its chain
    there (later deltas cannot apply without it)."""
    recs = read_done(root)
    base_idx = [i for i, r in enumerate(recs) if r["kind"] == "base"]
    out: List[Tuple[Dict, List[Dict]]] = []
    for i in reversed(base_idx):
        if not os.path.exists(recs[i].get("path", "")):
            continue
        deltas = []
        for r in recs[i + 1:]:
            if r["kind"] == "base":
                break
            if r["kind"] != "delta":
                continue
            if not os.path.exists(r.get("path", "")):
                break
            deltas.append(r)
        out.append((recs[i], deltas))
    return out


def resume_plan(root: str) -> Optional[Tuple[Dict, List[Dict]]]:
    """(last base record, the delta records after it): load the base, then
    each delta in order."""
    cands = resume_candidates(root)
    return cands[0] if cands else None
