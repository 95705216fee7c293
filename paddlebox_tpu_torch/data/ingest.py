"""Ingestion fault tolerance: error budgets, quarantine, retries, stats
(counterpart of ``paddlebox_tpu/data/ingest.py``).

- :class:`ErrorBudget`: a load's budget of quarantined bad lines and
  files. Every malformed line is recorded (file, line number, text,
  error) in the counters and an optional quarantine sidecar; parsing goes
  on while the budget lasts, and overspending raises one
  :class:`IngestBudgetError` naming everything quarantined. The default
  budget (every ``ingest_max_bad_*`` flag 0) fails fast: the first bad
  line raises, with its context.
- :func:`with_io_retries`: exponential backoff on a transient ``OSError``
  of a file open or read, through ``utils/faults.py``'s seeded injector.
  A missing file or a permission error is never retried.
- :class:`IngestStats`: thread-safe health counters (lines ok and
  quarantined, files ok and failed, retries, watchdog kills, ...), with
  the reference's names. Every ``add`` mirrors into ``utils/monitor.py``'s
  ``STATS`` (the global ``obs.metrics.REGISTRY``) as ``ingest.<name>``,
  as the reference's does.
- ``pipe_command`` helpers: the subprocess in its own process group, its
  captured stderr, the watchdog's kill and its error.

Flags are the reference's, read through their ``PBOX_FLAGS_*`` variables
at each call, with the reference's defaults. Imported by the parse
workers: it imports neither torch nor jax.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import math
import os
import subprocess
import tempfile
import threading
from typing import Callable, Dict, List, Optional, TypeVar

from paddlebox_tpu_torch.config import env_flag
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.monitor import STATS

LOG = logging.getLogger("paddlebox_tpu_torch.ingest")

_SNIPPET_LEN = 120
_SUMMARY_LINES = 20          # bad lines spelled out in an overspend error
_T = TypeVar("_T")

# the reference's flag defaults (paddlebox_tpu/flags.py)
MAX_BAD_LINES = 0
MAX_BAD_FRAC = 0.0
MAX_BAD_FILES = 0
RETRIES = 3
STALL_TIMEOUT = 300.0


def _snippet(line: str) -> str:
    return line if len(line) <= _SNIPPET_LEN else \
        line[:_SNIPPET_LEN] + f"...[{len(line)} chars]"


@dataclasses.dataclass
class BadLine:
    """One quarantined line: where it is, its text and its error."""

    path: str
    lineno: int          # 1-based physical line number in ``path``
    snippet: str
    error: str

    def __str__(self) -> str:
        return f"{self.path}:{self.lineno}: {self.snippet!r}: {self.error}"


class IngestError(RuntimeError):
    """A data-ingestion failure naming its file (and line, worker or
    pass): a bad line under the default budget (``<path>:<lineno>:
    <text!r>: <error>``), an overspent budget, a subprocess the watchdog
    killed, or a failed file or preload. ``bad_lines`` holds the
    quarantined lines."""

    def __init__(self, msg: str, bad_lines: Optional[List[BadLine]] = None):
        super().__init__(msg)
        self.bad_lines = list(bad_lines or ())


class IngestBudgetError(IngestError):
    """An :class:`ErrorBudget` was overspent (lines or files): the pass's
    budget is gone, unlike one file's failure."""


class IngestStats:
    """Thread-safe ingestion health counters; ``consume_delta`` reads the
    change since its last call (the pass-end report). Every ``add``
    mirrors into the global ``STATS`` as ``ingest.<name>`` (monotonic,
    for the process's life); the instance's counts reset."""

    FIELDS = ("lines_ok", "lines_quarantined", "files_ok", "files_failed",
              "io_retries", "watchdog_kills", "producer_failures",
              "preload_failures", "torn_blocks")

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {f: 0 for f in self.FIELDS}
        self._mark: Dict[str, int] = dict(self._counts)

    def add(self, name: str, n: int = 1) -> None:
        if n <= 0:
            return
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n
        STATS.add(f"ingest.{name}", n)

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            for k in list(self._counts):
                self._counts[k] = 0
            self._mark = dict(self._counts)

    def consume_delta(self) -> Dict[str, int]:
        """Counters changed since the previous call (for pass-end logs)."""
        with self._lock:
            delta = {k: v - self._mark.get(k, 0)
                     for k, v in self._counts.items()
                     if v != self._mark.get(k, 0)}
            self._mark = dict(self._counts)
            return delta

    def report(self) -> str:
        snap = self.snapshot()
        return "ingest[" + " ".join(
            f"{k}={snap[k]}" for k in self.FIELDS if snap.get(k)) + "]"


#: Process-global stats every feed component reports into by default.
INGEST_STATS = IngestStats()


def log_pass_report(context: str = "") -> None:
    """Log the ingest-health delta since the last report (pass end)."""
    delta = INGEST_STATS.consume_delta()
    if not delta:
        return
    body = " ".join(f"{k}={v}" for k, v in sorted(delta.items()))
    LOG.info("ingest stats%s: %s", f" ({context})" if context else "", body)


# -- error budget ------------------------------------------------------------

class ErrorBudget:
    """Quarantine budget of one load, shared by its files and parser
    threads under one lock.

    The line allowance is ``max(max_bad_lines, ceil(max_bad_frac *
    lines_seen))``. Both 0 (the defaults) mean the first bad line raises.
    A whole file that fails (unreadable, killed by the watchdog, out of
    retries) spends the separate ``max_bad_files`` budget. Arguments left
    None take the ``ingest_max_bad_lines``, ``ingest_max_bad_frac``,
    ``ingest_max_bad_files`` and ``ingest_quarantine_dir`` flags."""

    def __init__(self, max_bad_lines: Optional[int] = None,
                 max_bad_frac: Optional[float] = None,
                 max_bad_files: Optional[int] = None,
                 quarantine_dir: Optional[str] = None,
                 stats: Optional[IngestStats] = None):
        self.max_bad_lines = int(
            env_flag("ingest_max_bad_lines", MAX_BAD_LINES)
            if max_bad_lines is None else max_bad_lines)
        self.max_bad_frac = float(
            env_flag("ingest_max_bad_frac", MAX_BAD_FRAC)
            if max_bad_frac is None else max_bad_frac)
        self.max_bad_files = int(
            env_flag("ingest_max_bad_files", MAX_BAD_FILES)
            if max_bad_files is None else max_bad_files)
        self.quarantine_dir = (env_flag("ingest_quarantine_dir", "")
                               if quarantine_dir is None else quarantine_dir)
        self.stats = stats or INGEST_STATS
        self._lock = threading.Lock()
        self.lines_seen = 0          # parse attempts (good + bad)
        self.bad_lines: List[BadLine] = []
        self.failed_files: List[BadLine] = []
        self._sidecar = None

    # -- bookkeeping ---------------------------------------------------------

    def note_lines(self, n: int) -> None:
        """Record ``n`` parse attempts (the fractional allowance's
        denominator); callers batch them."""
        if n:
            with self._lock:
                self.lines_seen += n

    def _allowance(self) -> int:
        frac = (math.ceil(self.max_bad_frac * self.lines_seen)
                if self.max_bad_frac > 0 else 0)
        return max(self.max_bad_lines, frac)

    def _quarantine(self, bad: BadLine) -> None:
        """Append ``bad`` to ``quarantine-<pid>.jsonl`` in the quarantine
        directory (none: memory only). A failed write only warns."""
        if not self.quarantine_dir:
            return
        try:
            with self._lock:
                if self._sidecar is None:
                    os.makedirs(self.quarantine_dir, exist_ok=True)
                    self._sidecar = open(os.path.join(
                        self.quarantine_dir,
                        f"quarantine-{os.getpid()}.jsonl"), "a")
                json.dump(dataclasses.asdict(bad), self._sidecar)
                self._sidecar.write("\n")
                self._sidecar.flush()
        except OSError as e:
            LOG.warning("quarantine sidecar write failed: %s", e)

    def close(self) -> None:
        with self._lock:
            if self._sidecar is not None:
                try:
                    self._sidecar.close()
                except OSError:
                    pass
                self._sidecar = None

    # -- spending ------------------------------------------------------------

    def spend_line(self, path: str, lineno: int, line: str,
                   exc: BaseException, seen_delta: int = 0) -> None:
        """Quarantine one bad line; raise :class:`IngestBudgetError` when
        the budget is overspent. ``seen_delta``: parse attempts since the
        caller's last ``note_lines`` (this line included)."""
        bad = BadLine(path, lineno, _snippet(line),
                      f"{type(exc).__name__}: {exc}")
        with self._lock:
            self.lines_seen += seen_delta
            self.bad_lines.append(bad)
            overspent = len(self.bad_lines) > self._allowance()
        self.stats.add("lines_quarantined")
        self._quarantine(bad)
        if overspent:
            raise self._overspend_error(bad) from exc

    def spend_file(self, path: str, exc: BaseException) -> None:
        """Quarantine one file that failed whole; raise when over budget:
        with no file budget, the file's own error naming its path (a
        plain :class:`IngestError`), else :class:`IngestBudgetError`."""
        bad = BadLine(path, 0, "<whole file>",
                      f"{type(exc).__name__}: {exc}")
        with self._lock:
            self.failed_files.append(bad)
            n_failed = len(self.failed_files)
        self.stats.add("files_failed")
        if n_failed > self.max_bad_files:
            if self.max_bad_files <= 0:
                if isinstance(exc, IngestError):
                    raise exc
                raise IngestError(
                    f"{path}: {type(exc).__name__}: {exc}",
                    self.bad_lines) from exc
            raise IngestBudgetError(
                f"ingest file budget overspent: {n_failed} failed "
                f"file(s) > budget {self.max_bad_files}; last: {bad}",
                self.bad_lines) from exc

    def _overspend_error(self, last: BadLine) -> IngestError:
        with self._lock:
            bads = list(self.bad_lines)
            seen = self.lines_seen
            allowance = self._allowance()
        if allowance == 0 and len(bads) == 1:
            # fail-fast: the error is the line's context
            return IngestBudgetError(str(last), bads)
        head = "\n  ".join(str(b) for b in bads[:_SUMMARY_LINES])
        more = ("\n  ... and %d more" % (len(bads) - _SUMMARY_LINES)
                if len(bads) > _SUMMARY_LINES else "")
        return IngestBudgetError(
            f"ingest error budget overspent: {len(bads)} bad line(s) > "
            f"allowance {allowance} (max_bad_lines={self.max_bad_lines}, "
            f"max_bad_frac={self.max_bad_frac}, lines_seen={seen}):\n  "
            f"{head}{more}", bads)


# -- transient-I/O retry -----------------------------------------------------

#: OSErrors retrying cannot fix, raised at once.
_PERMANENT = (FileNotFoundError, PermissionError, IsADirectoryError,
              NotADirectoryError)


def _permanent(e: BaseException) -> bool:
    return isinstance(e, _PERMANENT)


def with_io_retries(fn: Callable[[], _T], op: str,
                    stats: Optional[IngestStats] = None,
                    attempts: Optional[int] = None) -> _T:
    """Run an idempotent I/O callable with backoff on a transient
    ``OSError``, at most ``ingest_retries`` attempts. ``op`` names the
    call site for ``utils/faults.py``'s injector, which fires inside each
    attempt; retries count into ``stats.io_retries``."""
    st = stats or INGEST_STATS

    def attempt():
        faults.io_point(op)
        return fn()

    def on_retry(_attempt: int, _e: BaseException) -> None:
        st.add("io_retries")

    return faults.with_retries(
        attempt,
        attempts=(int(env_flag("ingest_retries", RETRIES))
                  if attempts is None else attempts),
        base_delay=0.01, max_delay=0.5, retry_on=(OSError,),
        on_retry=on_retry, giveup=_permanent)


def open_with_retries(path: str, mode: str = "r",
                      stats: Optional[IngestStats] = None):
    """``open`` through :func:`with_io_retries` (op ``ingest.open``)."""
    return with_io_retries(lambda: open(path, mode), "ingest.open", stats)


# -- subprocess forensics ----------------------------------------------------

def stderr_tail(errfile, limit: int = 2000) -> str:
    """The decoded tail of a captured-stderr temp file (best effort)."""
    try:
        errfile.seek(0)
        return errfile.read().decode(errors="replace")[-limit:]
    except (OSError, ValueError):
        return "<stderr unavailable>"


def kill_subprocess(proc, group: bool = False, wait: float = 5.0) -> None:
    """Kill a subprocess; with ``group`` its whole process group (a
    ``start_new_session=True`` child), so a wedged shell's children cannot
    keep its output pipe open."""
    try:
        if proc.poll() is None:
            if group:
                import signal
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except (OSError, AttributeError):
                    proc.kill()
            else:
                proc.kill()
        proc.wait(timeout=wait)
    except Exception:  # noqa: BLE001 - the report matters more
        pass


def kill_and_report(proc, what: str, errfile=None,
                    stats: Optional[IngestStats] = None,
                    group: bool = False) -> IngestError:
    """The watchdog's end: kill a stalled subprocess (tree), count it and
    build the error naming it, with its stderr tail if captured."""
    (stats or INGEST_STATS).add("watchdog_kills")
    kill_subprocess(proc, group=group)
    tail = f"; stderr tail: {stderr_tail(errfile)!r}" \
        if errfile is not None else ""
    return IngestError(f"{what}; killed by watchdog{tail}")


@contextlib.contextmanager
def pipe_command_process(cmd: str, src_path: str,
                         stats: Optional[IngestStats] = None,
                         text: bool = False):
    """Launch a ``pipe_command``: stdin from the file (opened with
    retries; the path is never put in the shell line), stdout piped,
    stderr to a temp file, in a process group of its own. Yields ``(proc,
    errf)``; on exit the group is killed if still running and the stderr
    file closed."""
    src = open_with_retries(src_path, "rb", stats)
    errf = tempfile.TemporaryFile()
    try:
        proc = subprocess.Popen(cmd, shell=True, stdin=src,
                                stdout=subprocess.PIPE, stderr=errf,
                                text=text, start_new_session=True)
    except BaseException:
        src.close()
        errf.close()
        raise
    src.close()                     # the child holds its own fd now
    try:
        yield proc, errf
    finally:
        if proc.poll() is None:
            kill_subprocess(proc, group=True)
        errf.close()


def finish_pipe(proc, errf, cmd: str, path: str, stall: float,
                stats: Optional[IngestStats] = None) -> None:
    """After stdout's EOF: wait for the exit under the watchdog too (a
    command wedged in its cleanup is killed); a nonzero exit raises with
    the stderr tail."""
    try:
        proc.wait(timeout=stall if stall > 0 else None)
    except subprocess.TimeoutExpired:
        raise kill_and_report(
            proc, f"pipe_command {cmd!r} closed its output but did not "
            f"exit within {stall:g}s on {path}", errf, stats=stats,
            group=True) from None
    if proc.returncode != 0:
        raise RuntimeError(
            f"pipe_command {cmd!r} failed with exit code "
            f"{proc.returncode} on {path}; stderr tail: "
            f"{stderr_tail(errf)!r}")


def deadline() -> float:
    """The no-progress watchdog's deadline in seconds, the
    ``ingest_stall_timeout`` flag (<= 0 disables it)."""
    return float(env_flag("ingest_stall_timeout", STALL_TIMEOUT))
