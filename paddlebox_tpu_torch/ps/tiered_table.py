"""A bounded device arena over a host table: tables larger than device
memory (counterpart of ``paddlebox_tpu/ps/tiered_table.py``:
``_TierJob``, ``_TierWorker`` and the single-device ``TieredDeviceTable``).

    TieredDeviceTable (device arena, fixed capacity)   <- trains here
      └─ backing: EmbeddingTable (host DRAM)           <- holds every feature

Each pass's working set is staged from the backing into the arena, trained
there by the unchanged ``FusedTrainStep``, and written back:

- ``begin_feed_pass(pass_keys)``: dedup the pass's keys, export their rows
  from the backing (``export_rows`` creates new features with their
  key-deterministic init), rebuild the index pass-local (the null sentinel
  at row 0, the W keys at rows 1..W), upload the rows in one ``index_copy_``
  and resync the device index mirror, which is then as large as the
  working set, not the table.
- training: ``TieredDeviceTable`` is a ``DeviceTable`` to the step. A key
  that comes mid-pass without having been staged takes a row past W (up to
  the capacity; the arena's random init there) and is created in the
  backing at writeback.
- ``end_pass()``: download the rows the pass touched (the host dirty marks
  OR the device bitmap that the push kernel marks) and ``import_rows``
  them into the backing, reset the index, re-randomize the arena in place
  (its addresses stay, so a captured run survives the pass), then decay
  show/clk in the backing only.

``prefetch_feed_pass`` runs the next pass's export on one FIFO worker
thread (host work only: no CUDA call runs there) while the current pass
trains; ``begin_feed_pass`` with the same keys consumes the buffers and is
bit-exact against staging synchronously: the buffers replay each
pass-end decay that hit the backing after the export, one multiply an
epoch, and the rows an intervening writeback trained are exported again.
``end_pass`` joins an in-flight prefetch before it writes back and decays.
A prefetch for other keys, or one whose export failed on the worker, is
dropped and the pass stages synchronously.

Saves flush a pass's trained rows into the backing first, then save the
backing, the durable tier. Not ported, and refused with
``NotImplementedError``: the disk tier (``disk=``, with its bloom filter)
and frequency admission (``admit=``, ``PBOX_FLAGS_ps_admit_shows`` > 0),
the deferred demote (``PBOX_FLAGS_ps_tier_demote``), other staging
buckets than the default, and bfloat16, int8 or variable arenas (ROADMAP
A.7b); the mesh-sharded tiered table (A.9).
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch._device import DeviceLike
from paddlebox_tpu_torch.config import BucketSpec, TableConfig, refuse_flags
from paddlebox_tpu_torch.ps.device_table import _NULL_SENTINEL, DeviceTable
from paddlebox_tpu_torch.ps.table import EmbeddingTable

# the reference's flags of the tiered table's unported features
_REFUSED_FLAGS = (
    ("ps_admit_shows", "A.7b", "frequency admission (ps/admission.py)"),
    ("ps_tier_demote", "A.7b", "the deferred demote of a pass's writeback"),
)
_STAGE_BUCKETS = BucketSpec(min_size=256, max_size=1 << 26)


class _TierJob:
    """One unit of background tier work; ``error`` carries its failure to
    whoever consumes the job."""

    def __init__(self, fn: Callable[[], None]):
        self.fn = fn
        self.done = threading.Event()
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        try:
            self.fn()
        except BaseException as e:  # the submitter reads it
            self.error = e
        finally:
            self.done.set()

    def wait(self) -> None:
        self.done.wait()


class _TierWorker:
    """One FIFO daemon thread for the tier's host work: jobs run in the
    order the training thread would have run them. The thread starts at the
    first submit and again after it died; a failed start raises to the
    submitter, which the next submit retries."""

    def __init__(self):
        self._cv = threading.Condition()
        self._jobs: collections.deque = collections.deque()
        self._thread: Optional[threading.Thread] = None

    def submit(self, fn: Callable[[], None]) -> _TierJob:
        job = _TierJob(fn)
        with self._cv:
            if self._thread is None or not self._thread.is_alive():
                th = threading.Thread(target=self._run, daemon=True,
                                      name="pbx-tier-worker")
                th.start()          # may raise: nothing was enqueued
                self._thread = th
            self._jobs.append(job)
            self._cv.notify()
        return job

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._jobs:
                    self._cv.wait()
                job = self._jobs.popleft()
            job.run()


class TieredDeviceTable(DeviceTable):
    """A ``DeviceTable`` of fixed ``capacity`` whose contents are a pass's
    working set staged from ``backing`` (a host ``EmbeddingTable``, built
    with ``backend`` when not given): ``capacity`` bounds device memory,
    the backing bounds the feature space."""

    def __init__(self, conf: TableConfig,
                 backing: Optional[EmbeddingTable] = None,
                 capacity: int = 1 << 20,
                 disk=None,
                 uniq_buckets: Optional[BucketSpec] = None,
                 backend: Optional[str] = None,
                 index_threads: int = 0,
                 value_dtype: torch.dtype = torch.float32,
                 admit=None,
                 stage_buckets: Optional[BucketSpec] = None,
                 device: DeviceLike = None):
        if disk is not None:
            raise NotImplementedError(
                "the disk tier (DiskTier, ps/ssd_tier.py, with its bloom "
                "filter) is not ported yet (ROADMAP A.7b)")
        if admit is not None:
            raise NotImplementedError(
                "frequency admission (admit=, ps/admission.py) is not "
                "ported yet (ROADMAP A.7b)")
        if stage_buckets is not None and stage_buckets != _STAGE_BUCKETS:
            raise NotImplementedError(
                f"stage_buckets={stage_buckets}: only the default staging "
                "buckets are ported (ROADMAP A.7b)")
        refuse_flags(_REFUSED_FLAGS)
        if value_dtype != torch.float32 or conf.variable_embedding:
            raise NotImplementedError(
                f"value_dtype {value_dtype}, variable_embedding "
                f"{conf.variable_embedding}: low-precision and variable "
                "arenas under TieredDeviceTable are not ported yet (ROADMAP "
                "A.7b); the tiered table stages float32 arenas")
        if backing is not None and not isinstance(backing, EmbeddingTable):
            raise NotImplementedError(
                f"backing {type(backing).__name__}: only the host "
                "EmbeddingTable backs a tiered table in the port (the "
                "cross-host DistributedTable is ROADMAP A.9)")
        self.backing = backing if backing is not None else \
            EmbeddingTable(conf, backend=backend)
        self._stage_buckets = _STAGE_BUCKETS
        self.in_pass = False
        self.staged_keys: Optional[np.ndarray] = None
        self._worker = _TierWorker()
        # the asynchronous feed pass: one prefetch in flight, the decay
        # epochs since its export and the keys writebacks trained since.
        # prefetch_feed_pass runs on the caller's thread while writeback
        # runs on the training thread: the handoff is under _pf_lock (in
        # the reference, a publish outside the lock lost writeback keys)
        self._pf_lock = threading.Lock()
        self._prefetch: Optional[Tuple] = None      # guarded-by: _pf_lock
        self._decay_epoch = 0
        self._wb_keys_since: list = []              # guarded-by: _pf_lock
        super().__init__(conf, capacity=capacity, uniq_buckets=uniq_buckets,
                         device=device, value_dtype=value_dtype,
                         backend=backend, index_threads=index_threads)

    # the device tier is a bounded cache: a pass too large for it raises
    def _grow_to(self, need: int) -> None:
        raise RuntimeError(
            f"pass working set needs {need} rows but the device arena holds "
            f"{self.capacity}; raise capacity= or split the pass into "
            "smaller feed passes")

    def _check_capacity(self, w: int) -> None:
        if w + 1 > self.capacity:
            raise RuntimeError(
                f"pass working set {w} rows exceeds the device arena "
                f"capacity {self.capacity}; split the pass or raise "
                "capacity=")

    # -- pass staging --------------------------------------------------------

    @staticmethod
    def _pass_uniq(pass_keys: np.ndarray) -> np.ndarray:
        uniq = np.unique(np.ascontiguousarray(pass_keys, dtype=np.uint64))
        return uniq[uniq != 0]

    def prefetch_feed_pass(self, pass_keys: np.ndarray) -> None:
        """Start exporting the NEXT pass's working set on the tier worker
        while the current pass trains; the ``begin_feed_pass`` with the
        same keys consumes it."""
        uniq = self._pass_uniq(pass_keys)
        self._join_prefetch()       # one in flight; replace a stale one
        epoch0 = self._decay_epoch
        holder: dict = {}

        def work():
            holder["out"] = self.backing.export_rows(uniq, create=True)

        # submit and publish in one critical section, publishing after the
        # submit: a failed submit (the worker's thread did not start)
        # publishes nothing, raises once, and staging falls back to sync
        with self._pf_lock:
            try:
                job = self._worker.submit(work)
            except Exception:
                self._prefetch = None
                self._wb_keys_since = []
                raise
            self._wb_keys_since = []
            self._prefetch = (uniq, holder, job, epoch0)

    def _join_prefetch(self) -> None:
        with self._pf_lock:
            pf = self._prefetch
        if pf is not None:
            pf[2].wait()

    def _consume_prefetch(self, uniq: np.ndarray):
        """(vals, state) of the prefetch for ``uniq``, made equal to a
        synchronous export now; None when no prefetch, or one for other
        keys, is there, or when its export failed on the worker (the caller
        then stages synchronously, as the reference does)."""
        with self._pf_lock:
            pf = self._prefetch
            self._prefetch = None
            wb_since = self._wb_keys_since
            self._wb_keys_since = []
        if pf is None:
            return None
        puniq, holder, job, epoch0 = pf
        job.wait()
        if job.error is not None or not np.array_equal(puniq, uniq):
            return None
        vals, state = holder["out"]
        # (1) the pass-end decays that hit the backing after the export:
        # one multiply an epoch, the backing's own op (d**n in one multiply
        # is not bit-equal). end_pass joins the export before it decays,
        # so the count is exact.
        d = self.conf.show_clk_decay
        if d < 1.0:
            for _ in range(self._decay_epoch - epoch0):
                vals[:, 0:2] *= d
        # (2) the rows an intervening writeback trained: export again
        if wb_since and uniq.size:
            wb = np.unique(np.concatenate(wb_since))
            stale = np.isin(uniq, wb, assume_unique=True)
            if stale.any():
                fv, fs = self.backing.export_rows(uniq[stale], create=True)
                vals[stale] = fv
                state[stale] = fs
        return vals, state

    def begin_feed_pass(self, pass_keys: np.ndarray) -> int:
        """Stage the pass's working set into the arena; returns W, the
        staged rows. The previous pass must have ended. Consumes a
        matching ``prefetch_feed_pass``."""
        if self.in_pass:
            raise RuntimeError("previous pass not ended (call end_pass)")
        uniq = self._pass_uniq(pass_keys)
        w = int(uniq.size)
        staged = self._consume_prefetch(uniq)
        self._check_capacity(w)
        if staged is None:
            vals, state = self.backing.export_rows(uniq, create=True)
        else:
            vals, state = staged
        # the pass-local index: key -> arena row 1..W, row 0 the null row
        self._rebuild_index(uniq)
        if w:
            # pad the upload to the staging bucket by repeating the last
            # row (identical writes into row W): rows past W keep their
            # fresh init, row 0 stays null
            wpad = max(w, min(self._stage_buckets.bucket(w),
                              self.capacity - 1))
            rows = np.arange(1, w + 1, dtype=np.int64)
            if wpad > w:
                pad = wpad - w
                vals = np.concatenate(
                    [vals, np.repeat(vals[-1:], pad, axis=0)])
                state = np.concatenate(
                    [state, np.repeat(state[-1:], pad, axis=0)])
                rows = np.concatenate([rows, np.full(pad, w, np.int64)])
            self._ingest(torch.from_numpy(rows).to(self.device), vals, state)
        self._clear_dirty()
        if self.mirror is not None:
            self.mirror.sync()
        self.in_pass = True
        self.staged_keys = uniq
        return w

    def _rebuild_index(self, keys: np.ndarray) -> None:
        self._index.rebuild(np.concatenate(
            [np.array([_NULL_SENTINEL], dtype=np.uint64), keys]))
        self._size = int(keys.size) + 1

    def writeback(self) -> int:
        """Store the rows the pass touched (host marks OR the device
        bitmap) into the backing; untouched staged rows are already there.
        Returns the rows written back."""
        keys, vals, state = self._download_dirty()
        if keys is None:
            return 0
        self.backing.import_rows(keys, vals, state)
        self._record_wb_keys(keys)
        self._clear_dirty()
        return int(keys.size)

    def _download_dirty(self):
        """(keys, vals, state) host copies of the touched rows, or Nones.
        Reading the bitmap waits for the steps queued on the stream."""
        n = self._size
        if n <= 1:
            return None, None, None
        rows = self.fetch_dirty_rows()
        if not rows.size:
            return None, None, None
        keys = self._index.dump_keys(n)[rows]
        vals, state = self._canonical(torch.from_numpy(rows).to(self.device))
        return keys, vals, state

    def _record_wb_keys(self, keys: np.ndarray) -> None:
        # an in-flight prefetch exported these rows before they trained;
        # its consume exports them again (no prefetch: nothing to keep)
        with self._pf_lock:
            if self._prefetch is not None:
                self._wb_keys_since.append(keys)

    def end_pass(self) -> None:
        """Write back, reset the index and the arena, decay the backing."""
        # the export in flight must finish before the writeback and the
        # decay: its consume then replays exactly what it missed
        self._join_prefetch()
        if self.in_pass:
            self.writeback()
            self.in_pass = False
            self.staged_keys = None
            # a mid-pass new key of the next pass takes a row past the
            # staged prefix, which must not hold this pass's trained values
            self._rebuild_index(np.empty(0, dtype=np.uint64))
            self._rerandomize()
            self._clear_dirty()
            if self.mirror is not None:
                self.mirror.clear()
        # decay lives in the backing, which holds every feature between
        # passes (DeviceTable.end_pass would decay the staged rows again)
        self.backing.end_pass()
        self._decay_epoch += 1

    # -- persistence: the backing is the durable tier ------------------------
    # a save mid-pass writes the pass's trained rows back first; training
    # may go on after it

    def _flush_for_save(self) -> None:
        if self.in_pass:
            self.writeback()

    def save(self, path: str) -> None:
        self._flush_for_save()
        self.backing.save(path)

    def save_delta(self, path: str) -> int:
        self._flush_for_save()
        return self.backing.save_delta(path)

    def snapshot_parts(self, delta: bool = False):
        """Flush the device tier, then the backing's snapshot files."""
        self._flush_for_save()
        return self.backing.snapshot_parts(delta=delta)

    def snapshot(self):
        self._flush_for_save()
        return self.backing.snapshot()

    def snapshot_delta(self):
        self._flush_for_save()
        return self.backing.snapshot_delta()

    def mark_dirty(self, keys) -> None:
        self.backing.mark_dirty(keys)

    def load(self, path: str) -> None:
        if self.in_pass:
            raise RuntimeError("load during an open pass")
        self.backing.load(path)

    def load_delta(self, path: str) -> None:
        if self.in_pass:
            raise RuntimeError("load_delta during an open pass")
        self.backing.load_delta(path)

    def shrink(self) -> int:
        if self.in_pass:
            raise RuntimeError("shrink during an open pass")
        return self.backing.shrink()

    def __len__(self) -> int:
        return len(self.backing)

    def backing_bytes(self) -> int:
        return int(self.backing.memory_bytes())


class TieredShardedDeviceTable:
    """The tiered table over a mesh of devices (the reference's
    ``TieredShardedDeviceTable``): not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "TieredShardedDeviceTable, the tiered table over a mesh, is not "
            "ported yet (ROADMAP A.9)")
