"""Slot text parser (counterpart of ``paddlebox_tpu/data/parser.py``).

Parses the MultiSlot text format: one instance per line; for each
configured slot in order, ``<count> <v1> ... <vcount>``. With
``parse_ins_id`` a leading ``1 <ins_id>`` group names the instance; with
``parse_logkey`` a ``1 <hex-logkey>`` group after it packs search_id,
cmatch and rank.

A file parses under the reference's default error budget: the first bad
line raises :class:`IngestError` with ``<path>:<lineno>: <text!r>:
<error>`` context. Not ported (ROADMAP A.2d): ``pipe_command`` and its
watchdog, string slots (``InputTableDataset``), other error budgets with
their quarantine, and the transient-I/O retries.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from paddlebox_tpu_torch.config import DataFeedConfig, SlotConfig
from paddlebox_tpu_torch.data.record import SlotRecord

_SNIPPET_LEN = 120


class IngestError(RuntimeError):
    """A data-ingestion failure naming its file (and line)."""


def _bad_line(path: str, lineno: int, line: str,
              exc: BaseException) -> IngestError:
    """The reference's fail-fast message for one bad line."""
    snippet = line if len(line) <= _SNIPPET_LEN else \
        line[:_SNIPPET_LEN] + f"...[{len(line)} chars]"
    return IngestError(f"{path}:{lineno}: {snippet!r}: "
                       f"{type(exc).__name__}: {exc}")


def unpack_logkey(logkey: str) -> Tuple[int, int, int]:
    """Split a packed hex logkey into (search_id, cmatch, rank): search_id
    is all but the last 5 hex chars, then cmatch (3) and rank (2)."""
    logkey = logkey.strip()
    if len(logkey) <= 5:
        return (int(logkey or "0", 16), 0, 0)
    search_id = int(logkey[:-5], 16)
    cmatch = int(logkey[-5:-2], 16)
    rank = int(logkey[-2:], 16)
    return search_id, cmatch, rank


def pack_logkey(search_id: int, cmatch: int, rank: int) -> str:
    return f"{search_id:x}{cmatch:03x}{rank:02x}"


class SlotParser:
    def __init__(self, conf: DataFeedConfig):
        if conf.pipe_command:
            raise NotImplementedError(
                "DataFeedConfig.pipe_command (with its no-progress watchdog, "
                "data/ingest.py) is not ported yet (ROADMAP A.2d)")
        if any(s.type == "string" and s.is_used for s in conf.slots):
            raise NotImplementedError(
                "string slots (InputTableDataset) are not ported yet "
                "(ROADMAP A.2d)")
        self.conf = conf
        self.sparse_slots: List[SlotConfig] = []
        self.float_slots: List[SlotConfig] = []
        # parse order is the configured slot order; each entry:
        # (is_sparse, used, dest_index); dest_index -2 marks the label
        self._plan: List[Tuple[bool, bool, int]] = []
        for s in conf.slots:
            if s.type in ("uint64", "string") and not s.is_dense:
                idx = len(self.sparse_slots)
                if s.is_used:
                    self.sparse_slots.append(s)
                self._plan.append((True, s.is_used,
                                   idx if s.is_used else -1))
            elif s.name == conf.label_slot:
                self._plan.append((False, True, -2))
            else:
                idx = len(self.float_slots)
                if s.is_used:
                    self.float_slots.append(s)
                self._plan.append((False, s.is_used,
                                   idx if s.is_used else -1))

    # -- line level ---------------------------------------------------------

    def parse_line(self, line: str,
                   rec: Optional[SlotRecord] = None) -> SlotRecord:
        toks = line.split()
        pos = 0
        rec = rec or SlotRecord()
        if self.conf.parse_ins_id:
            n = int(toks[0])
            if n != 1:
                raise ValueError(f"ins_id group must have 1 token, got {n}")
            rec.ins_id = toks[1]
            pos = 2
        if self.conf.parse_logkey:
            n = int(toks[pos])
            if n != 1:
                raise ValueError(f"logkey group must have 1 token, got {n}")
            rec.search_id, rec.cmatch, rec.rank = unpack_logkey(
                toks[pos + 1])
            pos += 2
        u_vals: List[str] = []
        u_offs = [0] * (len(self.sparse_slots) + 1)
        f_vals: List[str] = []
        f_offs = [0] * (len(self.float_slots) + 1)
        for sparse, used, idx in self._plan:
            if pos >= len(toks):
                raise ValueError("truncated instance line")
            n = int(toks[pos])
            pos += 1
            vals = toks[pos:pos + n]
            if len(vals) != n:
                raise ValueError("truncated slot values")
            pos += n
            if sparse:
                if used:
                    u_vals.extend(vals)
                    u_offs[idx + 1] = len(u_vals)
            elif idx == -2:
                rec.label = float(vals[0]) if vals else 0.0
            elif used:
                f_vals.extend(vals)
                f_offs[idx + 1] = len(f_vals)
        # offsets are cumulative; fill any unseen slots
        for i in range(1, len(u_offs)):
            u_offs[i] = max(u_offs[i], u_offs[i - 1])
        for i in range(1, len(f_offs)):
            f_offs[i] = max(f_offs[i], f_offs[i - 1])
        rec.uint64_feas = np.array(u_vals, dtype=np.uint64) if u_vals else \
            np.empty(0, dtype=np.uint64)
        rec.uint64_offsets = np.array(u_offs, dtype=np.int64)
        rec.float_feas = np.array(f_vals, dtype=np.float32) if f_vals else \
            np.empty(0, dtype=np.float32)
        rec.float_offsets = np.array(f_offs, dtype=np.int64)
        return rec

    # -- file level ---------------------------------------------------------

    def parse_file(self, path: str, sample_hash_seed: int = 0,
                   budget=None) -> List[SlotRecord]:
        """Parse one file; the first bad line raises :class:`IngestError`.
        With ``sample_rate < 1`` the i-th non-empty line is kept when
        ``hash((sample_hash_seed, path, i)) & 0xFFFF`` is below
        ``sample_rate * 65536``: stable within a process (Python salts
        ``hash`` of a ``str`` per process)."""
        if budget is not None:
            raise NotImplementedError(
                "an ErrorBudget other than the default fail-fast one "
                "(quarantine, max bad lines/files) is not ported yet "
                "(ROADMAP A.2d)")
        rate = self.conf.sample_rate
        out: List[SlotRecord] = []
        i = 0
        with open(path, "r") as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                if rate < 1.0:
                    h = (hash((sample_hash_seed, path, i))
                         & 0xFFFF) / 65536.0
                    i += 1
                    if h >= rate:
                        continue
                try:
                    out.append(self.parse_line(line))
                except Exception as e:  # noqa: BLE001 - any parse failure
                    raise _bad_line(path, lineno, line, e) from e
        return out
