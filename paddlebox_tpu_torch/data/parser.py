"""Slot text parser (counterpart of ``paddlebox_tpu/data/parser.py``).

Parses the MultiSlot text format: one instance per line; for each
configured slot in order, ``<count> <v1> ... <vcount>``. With
``parse_ins_id`` a leading ``1 <ins_id>`` group names the instance; with
``parse_logkey`` a ``1 <hex-logkey>`` group after it packs search_id,
cmatch and rank. A "string" slot's tokens map to side-table offsets
through ``string_lookup`` (``InputTableDataset``).

Files can first go through a shell ``pipe_command`` (the file on its
stdin) under the no-progress watchdog of ``data/ingest.py``; a file
parses under an ``ErrorBudget`` (the default fails fast on the first bad
line, naming path and line) and opens with the transient-I/O retries. A
file's parse is an ``ingest.parse_file`` span of the trace and an
observation of the registry's ``ingest.parse_file_ms``, as in the
reference.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np

from paddlebox_tpu_torch.config import DataFeedConfig, SlotConfig
from paddlebox_tpu_torch.data import ingest
from paddlebox_tpu_torch.data.ingest import (ErrorBudget, IngestError,
                                             IngestStats)
from paddlebox_tpu_torch.data.record import (GLOBAL_POOL, SlotRecord,
                                             SlotRecordPool)
from paddlebox_tpu_torch.obs import trace
from paddlebox_tpu_torch.obs.metrics import REGISTRY

__all__ = ["IngestError", "SlotParser", "pack_logkey", "unpack_logkey"]

_PIPE_EOF = object()


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
    def __init__(self, conf: DataFeedConfig,
                 pool: Optional[SlotRecordPool] = None,
                 string_lookup=None):
        """``string_lookup(key: str) -> int`` maps a "string" slot's
        tokens to side-table offsets at parse (``InputTableDataset``'s
        conversion); required if the config has a used string slot.
        Records come from ``pool`` (default ``GLOBAL_POOL``)."""
        self.conf = conf
        self.pool = pool or GLOBAL_POOL
        self.string_lookup = string_lookup
        self.sparse_slots: List[SlotConfig] = []
        self.float_slots: List[SlotConfig] = []
        # parse order is the configured slot order; each entry:
        # (is_sparse, used, dest_index, is_string)
        self._plan: List[Tuple[bool, bool, int, bool]] = []
        if (string_lookup is None
                and any(s.type == "string" and s.is_used
                        for s in conf.slots)):
            raise ValueError(
                "config has string slots; pass string_lookup (use "
                "InputTableDataset, data/dataset.py)")
        for s in conf.slots:
            sparse = s.type in ("uint64", "string") and not s.is_dense
            if sparse:
                used = s.is_used
                idx = len(self.sparse_slots)
                if used:
                    self.sparse_slots.append(s)
                self._plan.append((True, used, idx if used else -1,
                                   s.type == "string"))
            else:
                if s.name == conf.label_slot:
                    self._plan.append((False, True, -2, False))  # label
                else:
                    used = s.is_used
                    idx = len(self.float_slots)
                    if used:
                        self.float_slots.append(s)
                    self._plan.append((False, used, idx if used else -1,
                                       False))

    # -- line level ---------------------------------------------------------

    def parse_line(self, line: str,
                   rec: Optional[SlotRecord] = None) -> SlotRecord:
        toks = line.split()
        pos = 0
        rec = rec or self.pool.get(1)[0]
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
        for sparse, used, idx, is_str in self._plan:
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
                    if is_str:
                        # side-table offsets (miss -> 0, the default row);
                        # ints go straight into the mixed token list —
                        # np.array(..., uint64) converts both
                        vals = [self.string_lookup(v) for v in vals]
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

    def _open_lines(self, path: str,
                    stats: Optional[IngestStats] = None) -> Iterator[str]:
        if self.conf.pipe_command:
            yield from self._pipe_lines(path, stats)
        else:
            with ingest.open_with_retries(path, "r", stats) as f:
                yield from f

    def _pipe_lines(self, path: str,
                    stats: Optional[IngestStats] = None) -> Iterator[str]:
        """Lines of ``path`` piped through the shell ``pipe_command``
        under a no-progress watchdog: a command that writes no line for
        ``ingest_stall_timeout`` seconds is killed (its process group)
        and reported with its stderr tail; a nonzero exit raises with the
        tail too."""
        cmd = self.conf.pipe_command
        stall = ingest.deadline()
        # feed the file via stdin — never interpolate the path into the
        # shell line (spaces/metacharacters in filenames must be data)
        with ingest.pipe_command_process(cmd, path, stats=stats,
                                         text=True) as (proc, errf):
            assert proc.stdout is not None
            # bounded: the pump must not outrun a slow consumer into
            # memory — the queue replaces the OS pipe's backpressure, it
            # must keep it
            q: "queue.Queue" = queue.Queue(maxsize=4096)

            def pump() -> None:
                # owns proc.stdout: nobody else reads or closes it while
                # this thread lives (a cross-thread close would block on
                # the buffered reader's lock while the pipe stays open)
                try:
                    for line in proc.stdout:
                        q.put(line)
                    q.put(_PIPE_EOF)
                except BaseException as e:  # noqa: BLE001 - relayed
                    q.put(e)

            t = threading.Thread(target=pump, daemon=True,
                                 name="pipe-command-pump")
            t.start()
            try:
                while True:
                    try:
                        item = q.get(timeout=stall if stall > 0 else None)
                    except queue.Empty:
                        raise ingest.kill_and_report(
                            proc, f"pipe_command {cmd!r} produced no "
                            f"output for {stall:g}s on {path}", errf,
                            stats=stats, group=True) from None
                    if item is _PIPE_EOF:
                        break
                    if isinstance(item, BaseException):
                        raise item
                    yield item
                ingest.finish_pipe(proc, errf, cmd, path, stall,
                                   stats=stats)
            finally:
                if proc.poll() is None:  # consumer abandoned mid-stream
                    ingest.kill_subprocess(proc, group=True)
                # pump exits on the pipe's EOF; FULLY drain the queue
                # each round so a pump blocked behind the bounded queue
                # always gets to that EOF within the window
                end = time.monotonic() + 5.0
                while t.is_alive() and time.monotonic() < end:
                    try:
                        while True:
                            q.get_nowait()
                    except queue.Empty:
                        pass
                    t.join(timeout=0.05)
                if not t.is_alive():
                    proc.stdout.close()

    def parse_file(self, path: str, sample_hash_seed: int = 0,
                   budget: Optional[ErrorBudget] = None,
                   stats: Optional[IngestStats] = None) -> List[SlotRecord]:
        """Parse one file under an error budget: a malformed line is
        quarantined into ``budget`` (file, line number, text, error) and
        parsing goes on while the budget lasts; overspending raises one
        :class:`IngestBudgetError` naming everything quarantined. The
        default budget is the ``ingest_max_bad_*`` flags': all 0, the
        first bad line raises with ``<path>:<lineno>: <text!r>: <error>``.
        On abort every parsed record returns to the pool. With
        ``sample_rate < 1`` the i-th non-empty line is kept when
        ``hash((sample_hash_seed, path, i)) & 0xFFFF`` is below
        ``sample_rate * 65536``: stable within a process (Python salts
        ``hash`` of a ``str`` per process)."""
        rate = self.conf.sample_rate
        stats = stats or ingest.INGEST_STATS
        owns_budget = budget is None
        if owns_budget:
            budget = ErrorBudget(stats=stats)
        out: List[SlotRecord] = []
        recs: List[SlotRecord] = []
        i = 0
        lineno = 0
        seen_unflushed = 0
        t_parse0 = time.perf_counter()
        try:
            with trace.span("ingest.parse_file", path=path):
                for line in self._open_lines(path, stats):
                    lineno += 1
                    line = line.strip()
                    if not line:
                        continue
                    if rate < 1.0:
                        h = (hash((sample_hash_seed, path, i))
                             & 0xFFFF) / 65536.0
                        i += 1
                        if h >= rate:
                            continue
                    if not recs:
                        recs = self.pool.get(256)
                    rec = recs.pop()
                    seen_unflushed += 1
                    try:
                        out.append(self.parse_line(line, rec))
                    except Exception as e:  # noqa: BLE001 - budgeted per line
                        recs.append(rec)  # pool.put resets the partial write
                        # hand the unflushed count over before the call: if
                        # spend_line raises, the finally must not add it again
                        delta, seen_unflushed = seen_unflushed, 0
                        budget.spend_line(path, lineno, line, e,
                                          seen_delta=delta)
        except BaseException:
            # abort: the partially-parsed pass must not leak its records
            self.pool.put(out)
            raise
        finally:
            budget.note_lines(seen_unflushed)
            if recs:
                self.pool.put(recs)
            if owns_budget:
                budget.close()
        REGISTRY.observe("ingest.parse_file_ms",
                         (time.perf_counter() - t_parse0) * 1e3)
        stats.add("lines_ok", len(out))
        stats.add("files_ok")
        return out
