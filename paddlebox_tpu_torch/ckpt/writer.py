"""AsyncCheckpointWriter: decoupled snapshot-then-write persistence
(counterpart of ``paddlebox_tpu/ckpt/writer.py``).

The training thread pays only the host snapshot copy; serialization, fsync
and the atomic rename run on one background worker behind a bounded queue.
Jobs run in FIFO order, so a delta submitted after a base commits after it
and the donefile trail (each record appended only after its dir commits)
is always a prefix of what is durable.

Error contract:

- a transient ``OSError`` inside a job is retried with exponential
  backoff (``utils/faults.py`` ``with_retries``), ``retries`` attempts in
  all, each retry counted in ``ckpt.retries``;
- a job that still fails runs its ``on_fail`` hook, is recorded and is
  re-raised by the next ``submit``, ``barrier`` or ``raise_pending``, so
  callers (``PassManager.end_pass``) see a persistence failure before they
  advance the pass;
- an ``InjectedCrash`` kills the worker for good (the stand-in for process
  death): the queue stops draining, every later call raises, and a
  postmortem bundle names the job (``obs/postmortem.py``, when
  ``obs_postmortem_dir`` arms it).

Each job runs in a ``ckpt.commit`` span of the trace (``obs/trace.py``),
on the writer's thread, and counts into the global registry under the
reference's names: ``ckpt.jobs_ok`` and ``ckpt.jobs_failed``, the
``ckpt.commit_ms`` histogram and the ``ckpt.queue_depth`` gauge.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional

from paddlebox_tpu_torch.ckpt import faults
from paddlebox_tpu_torch.ckpt.atomic import CheckpointError
from paddlebox_tpu_torch.obs import trace
from paddlebox_tpu_torch.obs.metrics import REGISTRY


class _Job:
    __slots__ = ("label", "fn", "on_fail")

    def __init__(self, label: str, fn: Callable[[], None],
                 on_fail: Optional[Callable[[], None]] = None):
        self.label = label
        self.fn = fn
        self.on_fail = on_fail


_STOP = _Job("<stop>", lambda: None)


class AsyncCheckpointWriter:
    def __init__(self, max_queue: int = 2, retries: int = 3,
                 retry_delay: float = 0.05):
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self._retries = max(1, int(retries))
        self._retry_delay = float(retry_delay)
        self._q: "queue.Queue[_Job]" = queue.Queue(maxsize=max_queue)
        self._cv = threading.Condition()
        self._pending = 0                       # guarded-by: _cv
        self._errors: List[BaseException] = []  # guarded-by: _cv
        self._dead = False                      # guarded-by: _cv
        self._closed = False                    # guarded-by: _cv
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ckpt-writer")
        self._thread.start()

    # -- worker --------------------------------------------------------------

    def _run(self) -> None:
        while True:
            job = self._q.get()
            if job is _STOP:
                return
            t0 = time.perf_counter()
            try:
                with trace.span("ckpt.commit", label=job.label):
                    faults.with_retries(
                        job.fn, attempts=self._retries,
                        base_delay=self._retry_delay,
                        on_retry=lambda _a, _e: REGISTRY.add("ckpt.retries"))
            except faults.InjectedCrash as e:
                # process death: stop draining, leave the disk state torn,
                # and leave the bundle naming the job that was in flight
                # (imported here: the postmortem commits through ckpt)
                from paddlebox_tpu_torch.obs import postmortem
                postmortem.maybe_dump(
                    f"ckpt writer died in job '{job.label}'", exc=e)
                with self._cv:
                    self._errors.append(e)
                    self._dead = True
                    self._pending -= 1
                    self._cv.notify_all()
                return
            except Exception as e:  # noqa: BLE001 - recorded, re-raised
                # the submitter's chance to roll back what it advanced at
                # snapshot time
                if job.on_fail is not None:
                    try:
                        job.on_fail()
                    except Exception:  # noqa: BLE001 - the job's error wins
                        pass
                REGISTRY.add("ckpt.jobs_failed")
                with self._cv:
                    self._errors.append(
                        CheckpointError(f"checkpoint job '{job.label}' "
                                        f"failed: {e!r}"))
                    self._pending -= 1
                    depth = self._pending
                    self._cv.notify_all()
            else:
                REGISTRY.add("ckpt.jobs_ok")
                REGISTRY.observe("ckpt.commit_ms",
                                 (time.perf_counter() - t0) * 1e3)
                with self._cv:
                    self._pending -= 1
                    depth = self._pending
                    self._cv.notify_all()
            REGISTRY.gauge("ckpt.queue_depth").set(depth)

    # -- caller surface ------------------------------------------------------

    def raise_pending(self) -> None:
        """Re-raise the oldest recorded job error, if any."""
        with self._cv:
            if self._errors:
                raise self._errors.pop(0)

    def submit(self, label: str, fn: Callable[[], None],
               on_fail: Optional[Callable[[], None]] = None) -> None:
        """Queue a serialize-and-commit job; blocks while the bounded queue
        is full (backpressure). Raises any pending error first. ``on_fail``
        runs on the worker if the job exhausts its retries."""
        self.raise_pending()
        with self._cv:
            if self._closed:
                raise CheckpointError("checkpoint writer is closed")
            self._pending += 1
            REGISTRY.gauge("ckpt.queue_depth").set(self._pending)
        try:
            self._put(_Job(label, fn, on_fail))
        except BaseException:
            with self._cv:
                self._pending -= 1
                self._cv.notify_all()
            raise

    def _put(self, job: _Job) -> None:
        """A blocking put that keeps watching for worker death: a dead
        worker never drains the queue."""
        while True:
            with self._cv:
                if self._dead:
                    raise CheckpointError(
                        "checkpoint writer is dead (earlier crash)")
            try:
                self._q.put(job, timeout=0.2)
                return
            except queue.Full:
                continue

    def barrier(self) -> None:
        """Block until every queued commit finished; re-raise any error.
        After a clean return every submitted checkpoint is durable and
        recorded in the donefile."""
        with self._cv:
            while self._pending > 0 and not self._dead:
                self._cv.wait(timeout=0.5)
            abandoned = self._pending if self._dead else 0
        self.raise_pending()
        if abandoned:
            raise CheckpointError(
                f"checkpoint writer died with {abandoned} job(s) abandoned")

    def pending(self) -> int:
        with self._cv:
            return self._pending

    def alive(self) -> bool:
        with self._cv:
            return not self._dead and not self._closed

    def close(self, drain: bool = True) -> None:
        """Stop the worker; with ``drain`` (the default) wait for queued
        commits first and re-raise their errors."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            dead = self._dead
        if drain and not dead:
            self.barrier()
        if not dead:
            try:
                self._put(_STOP)
            except CheckpointError:
                pass                 # the worker died while closing
        self._thread.join(timeout=10)
