"""Deterministic fault injection and retries for filesystem operations
(counterpart of ``paddlebox_tpu/utils/faults.py``).

Every filesystem touch that wants transient-fault coverage calls
``io_point`` with an operation name; tests and drills install a seeded
:class:`FaultInjector` (``install_injector``) to make those touches fail
reproducibly with ``OSError``. One process-global injector serves every
call site. :func:`with_retries` wraps a callable in exponential backoff;
``giveup`` exempts permanent errors that retrying cannot fix.

The call sites in the port, under the reference's names:

- the disk tier's (``ps/ssd_tier.py``): ``ssd.spill`` (a chunk write),
  ``ssd.read`` (a chunk gather) and ``ssd.compact``;
- the checkpoint commit's (``ckpt/atomic.py``): ``open`` (a tmp file),
  ``rename`` (its commit) and ``commit_dir``; the donefile's
  ``donefile.append`` (``trainer/donefile.py``);
- the data feed's file opens and reads (``data/ingest.py``
  ``with_io_retries``, the operation its caller names);
- the train guard's ``trainer.step`` (``trainer/guard.py``);
- the serving tier's, :data:`SERVE_FAULT_OPS` (``serving/proc.py`` and
  ``serving/transport.py``).

``ps.shard_spawn`` comes with the PS service (ROADMAP A.9) and the host
tier's ``serve.host_spawn`` with ``serving/host.py`` (A.5b). The
checkpoint pipeline's named crash points are ``ckpt/faults.py``.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Iterable, Optional, Tuple

#: The serving tier's operations, in wire order (the reference's names):
#:
#:   serve.spawn       the parent's spawn of a process-scope replica
#:   serve.frame_send  before a frame's header goes out
#:   serve.frame_mid   between header and payload: the peer reads a torn
#:                     frame
#:   serve.side_write  the child's health and metrics snapshot (the child
#:                     counts serve.side_write_failures and keeps serving)
#:
#: A replica child is a fault domain of its own and installs its own
#: injector from its worker spec.
SERVE_FAULT_OPS: Tuple[str, ...] = (
    "serve.spawn",
    "serve.frame_send",
    "serve.frame_mid",
    "serve.side_write",
)


class FaultInjector:
    """Seeded probabilistic ``OSError`` source for fs operations."""

    def __init__(self, seed: int, fail_rate: float = 0.1,
                 ops: Optional[Iterable[str]] = None,
                 max_failures: Optional[int] = None):
        self._rng = random.Random(seed)
        self.fail_rate = float(fail_rate)
        self.ops = frozenset(ops) if ops is not None else None
        self.max_failures = max_failures
        self.failures = 0
        self._ilock = threading.Lock()

    def maybe_fail(self, op: str) -> None:
        with self._ilock:
            if self.ops is not None and op not in self.ops:
                return
            if self.max_failures is not None and \
                    self.failures >= self.max_failures:
                return
            if self._rng.random() >= self.fail_rate:
                return
            self.failures += 1
        raise OSError(f"injected transient failure at '{op}'")


_lock = threading.Lock()
_injector: Optional[FaultInjector] = None


def install_injector(inj: Optional[FaultInjector]) -> None:
    global _injector
    with _lock:
        _injector = inj


def io_point(op: str) -> None:
    """Filesystem-operation call site for the probabilistic injector."""
    with _lock:
        inj = _injector
    if inj is not None:
        inj.maybe_fail(op)


def with_retries(fn: Callable[[], object], *, attempts: int = 3,
                 base_delay: float = 0.01, max_delay: float = 1.0,
                 retry_on: Tuple[type, ...] = (OSError,),
                 sleep: Callable[[float], None] = time.sleep,
                 on_retry: Optional[Callable[[int, BaseException],
                                             None]] = None,
                 giveup: Optional[Callable[[BaseException], bool]] = None):
    """Run ``fn`` with exponential backoff on transient errors.

    ``giveup(exc) -> True`` short-circuits the retry loop for errors that
    are permanent despite matching ``retry_on`` (e.g. ``FileNotFoundError``
    is an ``OSError`` but no amount of retrying conjures the file).

    ``InjectedCrash`` is a ``BaseException`` and therefore never retried —
    a crash is not a transient error."""
    if attempts < 1:
        raise ValueError("attempts must be >= 1")
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on as e:
            if giveup is not None and giveup(e):
                raise
            if attempt == attempts - 1:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(min(max_delay, base_delay * (2 ** attempt)))
