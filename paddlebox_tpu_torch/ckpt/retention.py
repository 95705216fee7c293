"""Checkpoint retention (counterpart of ``paddlebox_tpu/ckpt/retention.py``):
keep the last K bases and the delta chains anchored to them, prune what is
older, and sweep the ``.tmp-*`` staging spill that crashes leave.

GC follows the donefile trail, the record of what was committed, never a
directory listing: a dir no record reaches is staging spill (prunable by
name) or a checkpoint already forgotten. Records whose dirs were pruned
stop resolving; ``donefile.resume_candidates`` skips them, so the trail is
never rewritten. A pruned dir's ``.q8`` quantized serving sibling, which no
record names, is pruned with it.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Dict, List, Sequence, Set, Tuple

# atomic._tmp_path's names: <name>.tmp-<pid hex>-<nonce hex8>
_TMP_RE = re.compile(r"\.tmp-[0-9a-f]+-[0-9a-f]{8}$")


def prune_tmp(root: str) -> List[str]:
    """Remove orphaned ``*.tmp-*`` files and dirs under ``root`` (startup
    cleanup: only while no writer commits under this root)."""
    removed: List[str] = []
    if not os.path.isdir(root):
        return removed
    for cur, dirs, files in os.walk(root, topdown=True):
        doomed = [d for d in dirs if _TMP_RE.search(d)]
        for d in doomed:
            p = os.path.join(cur, d)
            shutil.rmtree(p, ignore_errors=True)
            removed.append(p)
        dirs[:] = [d for d in dirs if d not in doomed]
        for f in files:
            if _TMP_RE.search(f):
                p = os.path.join(cur, f)
                try:
                    os.unlink(p)
                except OSError:
                    continue
                removed.append(p)
    return removed


class RetentionPolicy:
    """Keep the last ``keep_bases`` bases and the delta chains anchored to
    them; everything recorded before the oldest kept base is prunable."""

    def __init__(self, keep_bases: int = 3):
        if keep_bases < 1:
            raise ValueError("keep_bases must be >= 1")
        self.keep_bases = int(keep_bases)

    def plan(self, records: Sequence[Dict]) -> Tuple[Set[str], List[str]]:
        """(paths to keep, paths to drop) from the donefile trail; touches
        no file."""
        base_idx = [i for i, r in enumerate(records)
                    if r.get("kind") == "base"]
        if len(base_idx) <= self.keep_bases:
            return {r["path"] for r in records if "path" in r}, []
        cutoff = base_idx[-self.keep_bases]
        keep = {r["path"] for r in records[cutoff:] if "path" in r}
        # records of an unknown kind are never dropped, wherever they sit
        keep |= {r["path"] for r in records
                 if r.get("kind") not in ("base", "delta") and "path" in r}
        drop, seen = [], set()
        for r in records[:cutoff]:
            p = r.get("path")
            if p and p not in keep and p not in seen:
                seen.add(p)
                drop.append(p)
        return keep, drop

    def sweep(self, root: str, records: Sequence[Dict]) -> List[str]:
        """Apply :meth:`plan` to disk. Only paths inside ``root`` are
        removed; emptied day and pass dirs go too, and so does a pruned
        dir's ``<path>.q8`` sibling (no record would ever reach it)."""
        _keep, drop = self.plan(records)
        removed: List[str] = []
        real_root = os.path.realpath(root)
        for path in drop:
            rp = os.path.realpath(path)
            if not (rp == real_root or
                    rp.startswith(real_root + os.sep)):
                continue            # never follow records outside the root
            if os.path.isdir(rp):
                shutil.rmtree(rp, ignore_errors=True)
                removed.append(path)
            elif os.path.exists(rp):
                try:
                    os.unlink(rp)
                    removed.append(path)
                except OSError:
                    continue
            if os.path.isdir(rp + ".q8"):
                shutil.rmtree(rp + ".q8", ignore_errors=True)
                removed.append(path + ".q8")
            # drop now-empty <day>/<pass> parents up to (not incl.) root
            parent = os.path.dirname(rp)
            while parent.startswith(real_root + os.sep):
                try:
                    os.rmdir(parent)
                except OSError:
                    break
                parent = os.path.dirname(parent)
        return removed
