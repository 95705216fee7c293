"""A bounded device arena over a host table, over an optional disk tier:
tables larger than device memory, and larger than host memory too
(counterpart of ``paddlebox_tpu/ps/tiered_table.py``: ``_TierJob``,
``_TierWorker``, the single-device ``TieredDeviceTable`` and the mesh's
``TieredShardedDeviceTable``).

    TieredDeviceTable (device arena, fixed capacity)   <- trains here
    | or TieredShardedDeviceTable (one arena a shard)
      └─ backing: EmbeddingTable (host DRAM)           <- holds the features
      |  or DistributedTable (ps/distributed.py: a shard a rank, over TCP)
           └─ optional DiskTier (ps/ssd_tier.py)       <- the cold ones

Each pass's working set is staged from the backing into the arena, trained
there by the unchanged ``FusedTrainStep``, and written back:

- ``begin_feed_pass(pass_keys)``: dedup the pass's keys, decide admission
  (below), fault the keys up — ``DiskTier.stage`` (disk -> DRAM) then
  ``export_rows`` from the backing (which creates new features with their
  key-deterministic init) — rebuild the index pass-local (the null
  sentinel at row 0, the W keys at rows 1..W), upload the rows in one
  ``index_copy_`` (padded to the staging buckets) and resync the device
  index mirror, which is then as large as the working set, not the table.
- training: ``TieredDeviceTable`` is a ``DeviceTable`` to the step. A key
  that comes mid-pass without having been staged takes a row past W (up to
  the capacity; the arena's random init there) and is created in the
  backing at writeback.
- ``end_pass()``: download the rows the pass touched (the host dirty marks
  OR the device bitmap that the push kernel marks) and ``import_rows``
  them into the backing, reset the index, re-randomize the arena in place
  (its addresses stay, so a captured run survives the pass), then decay
  show/clk in the backing only.

Frequency admission (``admit=``, or ``PBOX_FLAGS_ps_admit_shows`` > 0;
``ps/admission.py``): a brand-new key earns an arena row only once its
count-min estimate of shows crosses the threshold; until then it maps to
the null row (pulls zeros, its pushes dropped) and never gets a backing
or disk row. The pass's counts are observed once, at ``begin_feed_pass``;
the mid-pass insert paths (``prepare_batch``, ``insert_keys``, through
``_gate_new_keys``) read the estimate only.

The tier worker: one FIFO thread (host work only: no CUDA call runs
there). ``prefetch_feed_pass`` runs the next pass's admission decision,
disk reads and export on it while the current pass trains;
``begin_feed_pass`` with the same keys consumes the buffers and is
bit-exact against staging synchronously: the DRAM buffers replay each
pass-end decay that hit the backing after the export (disk reads skip
it, as rows still on disk would), the rows an intervening writeback
trained are exported again, rows an intervening ``evict_cold`` spilled
are restaged, and the disk reads are inserted at consume
(``DiskTier.consume_read``: a row a push trained since wins). Under
``PBOX_FLAGS_ps_tier_demote`` ``end_pass`` also hands the worker the
writeback's import and the backing's decay, returning after the device
download; ``_join_demote`` fences them before ``len``, saves, loads,
shrink and ``evict_cold``. FIFO order keeps every result bit-identical
to the synchronous path. A prefetch for other keys, or one whose job
failed on the worker, is dropped and the pass stages synchronously.

Saves flush a pass's trained rows into the backing first, then save the
backing, the durable tier (the disk tier's chunk log is its own durable
state, reopened by ``DiskTier(resume=True)``).

The arena may hold float32, bfloat16 or int8 values (``value_dtype``, as
``DeviceTable``): staging converts the backing's canonical rows through
``ArenaLayout.arena_from_canonical`` (``_ingest``; an int8 group is
quantized at the scale of its own maximum, so the padding repeat of the
last row writes the same bits), the writeback converts back through
``canonical_from_arena`` (``_canonical``, show/clk from the state), and
``end_pass`` refills the arena in place through ``ArenaLayout.fill_``,
int8 scale columns included. The prefetch, the disk tier and the deferred
demote carry canonical float32 rows on the host. ``variable_embedding``
needs a backing that stores its layout, which the host ``EmbeddingTable``
refuses: without a backing the constructor raises its ``ValueError``, as
the reference's does.

Over a ``DistributedTable`` backing the staging export, the writeback's
import (sent empty when the pass touched nothing) and the backing's pass
end are collectives: every rank's table calls them together. Its prefetch
and ``ps_tier_demote`` would run them on the tier worker, beside the
training thread's own collectives, which the reference does not order
either: use neither over a ``DistributedTable``.

The tier worker's queue length is the registry's ``ps.disk.worker_queue``
gauge, and the mid-pass admission gate counts the keys it turns away in
``ps.disk.admit_rejected``, under the reference's names.

In deferred insert mode a pass's misses go to the device miss ring
(``DeviceTable.record_misses``): ``begin_feed_pass`` zeroes its count in
place and drops the lagged snapshot, so a pass never inserts the previous
pass's misses.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch._device import DeviceLike
from paddlebox_tpu_torch.config import BucketSpec, TableConfig, env_flag
from paddlebox_tpu_torch.obs import trace
from paddlebox_tpu_torch.obs.metrics import REGISTRY
from paddlebox_tpu_torch.ps import admission
from paddlebox_tpu_torch.parallel.mesh import AXIS_DP
from paddlebox_tpu_torch.ps.device_table import _NULL_SENTINEL, DeviceTable
from paddlebox_tpu_torch.ps.sharded_device_index import \
    ShardedDeviceIndexMirror
from paddlebox_tpu_torch.ps.sharded_device_table import ShardedDeviceTable
from paddlebox_tpu_torch.ps.sharded_device_table import \
    shard_of as device_shard_of
from paddlebox_tpu_torch.ps.ssd_tier import DiskTier
from paddlebox_tpu_torch.ps.table import EmbeddingTable

_STAGE_BUCKETS = BucketSpec(min_size=256, max_size=1 << 26)


class _TierJob:
    """One unit of background tier work; ``error`` carries its failure
    (a prefetch's surfaces through its holder, a demote's through the
    worker's pending errors)."""

    def __init__(self, fn: Callable[[], None], surface: bool):
        self.fn = fn
        self.surface = surface
        self.done = threading.Event()
        self.error: Optional[BaseException] = None

    def run(self, on_error: Callable[["_TierJob"], None]) -> None:
        try:
            self.fn()
        except BaseException as e:  # surfaced at the barrier
            self.error = e
            # reported before done is set: a barrier woken by it must
            # see the error, or a failed writeback import slips past a
            # save's fence
            on_error(self)
        finally:
            self.done.set()

    def wait(self) -> None:
        self.done.wait()


class _TierWorker:
    """One FIFO daemon thread for the tier's host work: prefetch jobs and,
    under ``ps_tier_demote``, the deferred writeback import and backing
    decay. Jobs run in the order the training thread would have run them,
    so overlap changes when the work happens, never what it computes. The
    thread starts at the first submit and again after it died; a failed
    start raises to the submitter, which the next submit retries."""

    def __init__(self):
        self._cv = threading.Condition()
        self._jobs: collections.deque = collections.deque()  # guarded-by: _cv
        self._thread: Optional[threading.Thread] = None      # guarded-by: _cv
        self._tail: Optional[_TierJob] = None                # guarded-by: _cv
        self._errors: list = []                              # guarded-by: _cv

    def submit(self, fn: Callable[[], None],
               surface_errors: bool = False) -> _TierJob:
        job = _TierJob(fn, surface_errors)
        with self._cv:
            if self._thread is None or not self._thread.is_alive():
                th = threading.Thread(target=self._run, daemon=True,
                                      name="pbx-tier-worker")
                th.start()          # may raise: nothing was enqueued
                self._thread = th
            self._jobs.append(job)
            self._tail = job
            REGISTRY.gauge("ps.disk.worker_queue").set(len(self._jobs))
            self._cv.notify()
        return job

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._jobs:
                    self._cv.wait()
                job = self._jobs.popleft()
                REGISTRY.gauge("ps.disk.worker_queue").set(len(self._jobs))
            job.run(self._on_job_error)

    def _on_job_error(self, job: _TierJob) -> None:
        if job.surface:
            with self._cv:
                self._errors.append(job.error)

    def barrier(self) -> None:
        """Wait for every submitted job; re-raise the first failed demote
        (a lost writeback must not be silent)."""
        while True:
            with self._cv:
                tail = self._tail
            if tail is None or tail.done.is_set():
                break
            tail.wait()
        with self._cv:
            errs, self._errors = self._errors, []
        if errs:
            raise errs[0]


class TieredDeviceTable(DeviceTable):
    """A ``DeviceTable`` of fixed ``capacity`` whose contents are a pass's
    working set staged from ``backing`` (a host ``EmbeddingTable``, built
    with ``backend`` when not given) and its optional ``disk`` tier:
    ``capacity`` bounds device memory, the backing and the disk bound the
    feature space. ``admit``: a ``CountMinAdmission``, None to follow the
    ``ps_admit_*`` flags, or ``admission.DISABLED``. ``stage_buckets``:
    the widths a staging upload is padded to."""

    def __init__(self, conf: TableConfig,
                 backing: Optional[EmbeddingTable] = None,
                 capacity: int = 1 << 20,
                 disk: Optional[DiskTier] = None,
                 uniq_buckets: Optional[BucketSpec] = None,
                 backend: Optional[str] = None,
                 index_threads: int = 0,
                 value_dtype: torch.dtype = torch.float32,
                 admit=None,
                 stage_buckets: Optional[BucketSpec] = None,
                 device: DeviceLike = None):
        self.backing = backing if backing is not None else \
            EmbeddingTable(conf, backend=backend)
        # staging-width buckets: admission makes W swing from pass to
        # pass; the upload is padded to geometric widths
        self._stage_buckets = stage_buckets if stage_buckets is not None \
            else _STAGE_BUCKETS
        self.disk = disk
        self.in_pass = False
        self.staged_keys: Optional[np.ndarray] = None
        self._admit = admission.resolve(admit)
        if disk is not None:
            disk.live_keys_fn = self._live_pass_keys
            disk.demote_fence_fn = self._join_demote
        self._worker = _TierWorker()
        # whether end_pass left demote jobs the next backing access joins
        self._pending_demote = False
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

    # -- admission -----------------------------------------------------------

    def _live_pass_keys(self) -> Optional[np.ndarray]:
        """The open pass's staged keys, which ``DiskTier.evict_cold``
        skips."""
        return self.staged_keys if self.in_pass else None

    def _admit_pass(self, uniq: np.ndarray,
                    counts: np.ndarray) -> np.ndarray:
        """The pass's admission decision (observes its shows)."""
        if self._admit is None:
            return uniq
        adm, _a, _r = admission.admit_pass_keys(
            uniq, counts, self.backing, self.disk, self._admit)
        return adm

    def admits_every_key(self) -> bool:
        return self._admit is None

    def _gate_new_keys(self, keys: np.ndarray) -> np.ndarray:
        """Map the new keys not admitted yet to the padding key 0 (the null
        row); read-only on the sketch."""
        adm = self._admit
        if adm is None:
            return keys
        uniq = np.unique(keys)
        uniq = uniq[uniq != 0]
        if not uniq.size:
            return keys
        rows, _ = self._index.lookup(uniq, False, True, 0)
        missing = rows < 0
        if not missing.any():
            return keys
        cand = uniq[missing]
        ok = admission.known_keys(cand, self.backing, self.disk) | \
            adm.admitted(cand)
        rejected = cand[~ok]
        if not rejected.size:
            return keys
        REGISTRY.add("ps.disk.admit_rejected", int(rejected.size))
        out = keys.copy()
        out[np.isin(keys, rejected)] = 0
        return out

    # -- pass staging --------------------------------------------------------

    @staticmethod
    def _pass_uniq(pass_keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """The pass's non-zero unique keys and their occurrence counts."""
        keys = np.ascontiguousarray(pass_keys, dtype=np.uint64)
        uniq, counts = np.unique(keys, return_counts=True)
        live = uniq != 0
        return uniq[live], counts[live]

    def prefetch_feed_pass(self, pass_keys: np.ndarray) -> None:
        """Start staging the NEXT pass's working set on the tier worker
        while the current pass trains: the admission decision (pinned to
        the epoch the consuming ``begin_feed_pass`` runs at), the disk
        reads and the export from the backing. The ``begin_feed_pass``
        with the same keys consumes it."""
        raw_uniq, counts = self._pass_uniq(pass_keys)
        self._join_prefetch()       # one in flight; replace a stale one
        admit = self._admit
        # the consuming begin_feed_pass runs after this pass's end_pass
        # advanced the sketch's epoch (no pass open: no advance)
        decide_epoch = (admit.epoch + (1 if self.in_pass else 0)) \
            if admit is not None else None
        epoch0 = self._decay_epoch
        holder: dict = {}
        if self.disk is not None:
            self.disk.mark_spills()

        def work():
            try:
                if admit is not None:
                    uniq, _a, _r = admission.admit_pass_keys(
                        raw_uniq, counts, self.backing, self.disk, admit,
                        at_epoch=decide_epoch)
                else:
                    uniq = raw_uniq
                holder["admitted"] = uniq
                if self.disk is not None:
                    dk, dv, ds, dok, dmeta = self.disk.read_rows(uniq)
                else:
                    dk = np.empty(0, np.uint64)
                    dv = ds = dok = dmeta = None
                rest = uniq if not dk.size else \
                    uniq[~np.isin(uniq, dk, assume_unique=True)]
                rv, rs = self.backing.export_rows(rest, create=True)
                holder["out"] = (dk, dv, ds, dok, dmeta, rest, rv, rs)
            except Exception as e:  # the consume stages synchronously
                holder["error"] = e

        # submit and publish in one critical section, publishing after the
        # submit: a failed submit (the worker's thread did not start)
        # publishes nothing, raises once, and staging falls back to sync
        with self._pf_lock:
            try:
                job = self._worker.submit(work)
            except Exception:
                # mark_spills above reset the journal a published
                # predecessor needed: drop it and clear the mark
                self._prefetch = None
                self._wb_keys_since = []
                if self.disk is not None:
                    self.disk.spilled_since_mark()
                raise
            self._wb_keys_since = []
            self._prefetch = (raw_uniq, holder, job, epoch0, decide_epoch)

    def _join_prefetch(self) -> None:
        with self._pf_lock:
            pf = self._prefetch
        if pf is not None:
            pf[2].wait()

    def _consume_prefetch(self, raw_uniq: np.ndarray):
        """(admitted, vals, state) of the prefetch for ``raw_uniq``, made
        equal to a synchronous stage now; None when no prefetch, or one
        for other keys or another epoch, is there, or when its job failed
        (the caller then decides and stages synchronously, as the
        reference does)."""
        with self._pf_lock:
            pf = self._prefetch
            self._prefetch = None
            wb_since = self._wb_keys_since
            self._wb_keys_since = []
        if pf is None:
            return None
        praw, holder, job, epoch0, decide_epoch = pf
        job.wait()
        spilled = (self.disk.spilled_since_mark()
                   if self.disk is not None else np.empty(0, np.uint64))
        if "error" in holder or not np.array_equal(praw, raw_uniq):
            return None
        if self._admit is not None and decide_epoch != self._admit.epoch:
            return None
        admitted = holder["admitted"]
        dk, dv, ds, dok, dmeta, rk, rv, rs = holder["out"]
        # (1) the pass-end decays that hit the backing after the export:
        # the DRAM buffers replay them, one multiply an epoch, the
        # backing's own op (d**n in one multiply is not bit-equal); disk
        # reads skip them, as rows still on disk would. end_pass joins
        # the export before it decays, so the count is exact.
        d = self.conf.show_clk_decay
        if d < 1.0:
            for _ in range(self._decay_epoch - epoch0):
                rv[:, 0:2] *= d
        # (2) the rows an intervening writeback trained: export again
        if wb_since and rk.size:
            wb = np.unique(np.concatenate(wb_since))
            stale = np.isin(rk, wb, assume_unique=True)
            if stale.any():
                fv, fs = self.backing.export_rows(rk[stale], create=True)
                rv[stale] = fv
                rs[stale] = fs
        # (2b) DRAM rows an intervening evict_cold spilled: restage them
        # (the state a synchronous stage would find) and export again
        if spilled.size and rk.size:
            moved = np.isin(rk, spilled, assume_unique=True)
            if moved.any():
                self.disk.stage(rk[moved])
                fv, fs = self.backing.export_rows(rk[moved], create=True)
                rv[moved] = fv
                rs[moved] = fs
        # (3) the disk reads: insert now. Rows the freshness guards
        # rejected (a trained DRAM copy or a newer spill won) and rows
        # whose embedx is not materialized take the export instead
        if dk.size:
            stale_d = self.disk.consume_read(dk, dv, ds, dok, dmeta)
            need = ~dok
            if stale_d.size:
                need |= np.isin(dk, stale_d, assume_unique=True)
            if need.any():
                fv, fs = self.backing.export_rows(dk[need], create=True)
                dv[need] = fv
                ds[need] = fs
        vals = np.empty((admitted.size, rv.shape[1]), np.float32)
        state = np.empty((admitted.size, rs.shape[1]), np.float32)
        if rk.size:
            pos = np.searchsorted(admitted, rk)
            vals[pos] = rv
            state[pos] = rs
        if dk.size:
            pos = np.searchsorted(admitted, dk)
            vals[pos] = dv
            state[pos] = ds
        return admitted, vals, state

    def begin_feed_pass(self, pass_keys: np.ndarray) -> int:
        """Stage the pass's working set into the arena; returns W, the
        staged rows. The previous pass must have ended. Consumes a
        matching ``prefetch_feed_pass``. A ``ps.stage_pass`` span of the
        trace."""
        if self.in_pass:
            raise RuntimeError("previous pass not ended (call end_pass)")
        with trace.span("ps.stage_pass", n=int(pass_keys.size)):
            return self._begin_feed_pass(pass_keys)

    def _begin_feed_pass(self, pass_keys: np.ndarray) -> int:
        raw_uniq, counts = self._pass_uniq(pass_keys)
        # join the previous end_pass's deferred demote (and raise its
        # failure) before any membership read or staging
        self._worker.barrier()
        staged = self._consume_prefetch(raw_uniq)
        if staged is None:
            uniq = self._admit_pass(raw_uniq, counts)
            w = int(uniq.size)
            self._check_capacity(w)
            if self.disk is not None:
                self.disk.stage(uniq)       # disk -> DRAM first
            vals, state = self.backing.export_rows(uniq, create=True)
        else:
            uniq, vals, state = staged
            w = int(uniq.size)
            self._check_capacity(w)
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
            # stale ring entries would insert the previous pass's keys into
            # this pass's index, and a stale snapshot would cost the first
            # deferred poll a spurious drain
            self.miss_cnt.zero_()
            self._miss_snapshot = None
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
            # a collective over a DistributedTable: every rank enters
            self.backing.import_rows(
                np.empty(0, np.uint64),
                np.zeros((0, self.layout.dim), np.float32),
                np.zeros((0, self.layout.canonical_state_dim), np.float32))
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
        with trace.span("ps.writeback", rows=int(rows.size)):
            keys = self._index.dump_keys(n)[rows]
            vals, state = self._canonical(
                torch.from_numpy(rows).to(self.device))
        return keys, vals, state

    def _record_wb_keys(self, keys: np.ndarray) -> None:
        # an in-flight prefetch exported these rows before they trained;
        # its consume exports them again (no prefetch: nothing to keep)
        with self._pf_lock:
            if self._prefetch is not None:
                self._wb_keys_since.append(keys)

    def end_pass(self) -> None:
        """Write back, reset the index and the arena, decay the backing.
        Under ``PBOX_FLAGS_ps_tier_demote`` the backing's import of the
        downloaded rows and its decay run as jobs on the tier worker, and
        the next ``begin_feed_pass`` or backing access joins them."""
        # the export in flight must finish before the writeback and the
        # decay: its consume then replays exactly what it missed
        self._join_prefetch()
        demote_async = bool(env_flag("ps_tier_demote", False))
        if self.in_pass:
            if demote_async:
                keys, vals, state = self._download_dirty()
                if keys is not None:
                    self._worker.submit(
                        lambda: self.backing.import_rows(keys, vals, state),
                        surface_errors=True)
                    self._record_wb_keys(keys)
                    self._clear_dirty()
                    self._pending_demote = True
            else:
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
        if demote_async:
            self._worker.submit(self.backing.end_pass, surface_errors=True)
            self._pending_demote = True
        else:
            self.backing.end_pass()
        if self._admit is not None:
            self._admit.advance_epoch()
        self._decay_epoch += 1

    def _join_demote(self) -> None:
        """Fence the deferred demote before a synchronous backing access;
        raises its failure."""
        if self._pending_demote:
            self._worker.barrier()
            self._pending_demote = False

    # -- persistence: the backing is the durable tier ------------------------
    # a save mid-pass writes the pass's trained rows back first; training
    # may go on after it

    def _flush_for_save(self) -> None:
        self._join_demote()
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
        self._join_demote()
        self.backing.mark_dirty(keys)

    def load(self, path: str) -> None:
        if self.in_pass:
            raise RuntimeError("load during an open pass")
        self._join_demote()
        self.backing.load(path)

    def load_delta(self, path: str) -> None:
        if self.in_pass:
            raise RuntimeError("load_delta during an open pass")
        self._join_demote()
        self.backing.load_delta(path)

    def shrink(self) -> int:
        if self.in_pass:
            raise RuntimeError("shrink during an open pass")
        self._join_demote()
        return self.backing.shrink()

    def __len__(self) -> int:
        self._join_demote()
        return len(self.backing)

    def backing_bytes(self) -> int:
        return int(self.backing.memory_bytes())


class TieredShardedDeviceTable(ShardedDeviceTable):
    """The tiered table over a mesh: a ``ShardedDeviceTable`` whose shards
    hold a pass's working set staged from ``backing`` (a host
    ``EmbeddingTable``, or a ``ps/distributed.py`` ``DistributedTable``
    spread over the ranks of a multi-host job), the device caches over a
    PS sharded across hosts of the reference's flagship deployment.
    ``begin_feed_pass`` stages this process's pass keys into the shards,
    ``FusedShardedTrainStep`` trains them, ``end_pass`` writes the rows
    the pass touched back.

    Over a ``DistributedTable`` ``begin_feed_pass``, ``writeback``,
    ``end_pass``, the saves and ``len`` are collectives: every rank calls
    them together, and each calls the backing's collectives the same
    number of times whatever its own rows (an empty export or import
    where it has none). There is no ``prefetch_feed_pass`` here, as in
    the reference: its export would be a collective on a second thread
    beside the training loop's own coordinator traffic.

    Admission (``admit``) decides at ``begin_feed_pass`` only (no
    mid-pass re-check on the sharded prepare path).

    ``writeback_mode``: ``"set"`` (the staged rows are the only copies:
    overwrite the backing) or ``"delta"`` (send ``trained - staged`` and
    let the owners add the ranks' contributions up: ranks whose working
    sets overlap in a pass; with disjoint keys it gives what "set" gives,
    up to rounding). A key that came mid-pass has no staged base; its
    base is the backing's fresh row (the key's deterministic init)."""

    def __init__(self, conf: TableConfig, mesh, backing=None,
                 axis: str = AXIS_DP, capacity_per_shard: int = 1 << 18,
                 disk: Optional[DiskTier] = None,
                 writeback_mode: str = "set",
                 req_buckets: Optional[BucketSpec] = None,
                 uniq_buckets: Optional[BucketSpec] = None,
                 backend: Optional[str] = None,
                 value_dtype: torch.dtype = torch.float32,
                 admit=None):
        self.backing = backing if backing is not None else \
            EmbeddingTable(conf, backend=backend)
        self.disk = disk
        self.writeback_mode = writeback_mode
        self.in_pass = False
        self.staged_keys: Optional[np.ndarray] = None
        self._admit = admission.resolve(admit)
        if disk is not None:
            disk.live_keys_fn = self._live_pass_keys
        # "delta": the staged (keys, values, state), float32 canonical
        self._staged: Optional[Tuple] = None
        super().__init__(conf, mesh, axis=axis,
                         capacity_per_shard=capacity_per_shard,
                         req_buckets=req_buckets, uniq_buckets=uniq_buckets,
                         backend=backend, value_dtype=value_dtype)

    def _live_pass_keys(self) -> Optional[np.ndarray]:
        return self.staged_keys if self.in_pass else None

    def _reset_arena(self, rebuild_mirror: bool = True) -> None:
        """Fresh indexes and arenas on every shard (rows past a pass's
        staged ones must not hold the last pass's trained values), no
        dirty marks. The mirrors wrap the old indexes: rebuilt over the
        new ones unless ``rebuild_mirror`` is False (``end_pass``: the
        next ``begin_feed_pass`` resets again, and no step may run
        between the two)."""
        for s in range(self.ndev):
            self._indexes[s] = self._new_index()
            self._indexes[s].rebuild(
                np.array([_NULL_SENTINEL], dtype=np.uint64))
            self._sizes[s] = 1
        self.values = self.state = None
        self.values, self.state = self._alloc(self.capacity)
        self._clear_dirty()
        if self.mirror is not None and rebuild_mirror:
            self.mirror = ShardedDeviceIndexMirror(self._indexes, self.mesh)

    def begin_feed_pass(self, pass_keys: np.ndarray) -> int:
        """Stage this process's pass working set into the shards (a
        collective over a ``DistributedTable``); returns W, the staged
        rows. Raises when one shard's share (by the device-shard hash)
        does not fit ``capacity_per_shard``."""
        if self.in_pass:
            raise RuntimeError("previous pass not ended (call end_pass)")
        keys = np.ascontiguousarray(pass_keys, dtype=np.uint64).ravel()
        uniq, counts = np.unique(keys, return_counts=True)
        live = uniq != 0
        uniq, counts = uniq[live], counts[live]
        if self._admit is not None:
            uniq, _a, _r = admission.admit_pass_keys(
                uniq, counts, self.backing, self.disk, self._admit)
        w = int(uniq.size)
        per = np.bincount(device_shard_of(uniq, self.ndev),
                          minlength=self.ndev)
        if per.size and int(per.max()) + 1 > self.capacity:
            raise RuntimeError(
                f"pass working set puts {int(per.max())} rows on one "
                f"shard but capacity_per_shard={self.capacity}; split the "
                "pass or raise capacity_per_shard=")
        with trace.span("ps.stage_pass", n=w):
            if self.disk is not None:
                self.disk.stage(uniq)
            vals, state = self.backing.export_rows(uniq, create=True)
        self._reset_arena()
        if w:
            self._ingest(uniq, vals, state)
            self._dirty[:] = False      # staging, not training
        if self.mirror is not None:
            # the previous pass's ring entries and snapshot must not
            # insert its keys into this pass's indexes
            for cnt in self.miss_cnt:
                cnt.zero_()
            self._miss_snapshot = None
        if self.writeback_mode == "delta":
            self._staged = (uniq, vals.copy(), state.copy())
        self.in_pass = True
        self.staged_keys = uniq
        return w

    def _trained_rows(self):
        """(keys, values, state) host copies of the rows the pass touched
        on every shard (the host marks OR each shard's device bitmap)."""
        keys_l, vals_l, st_l = [], [], []
        for s in range(self.ndev):
            n = self._sizes[s]
            rows = self._dirty_rows(s, n)
            if not rows.size:
                continue
            keys_l.append(self._indexes[s].dump_keys(n)[rows])
            v, st = self._canonical(s, rows)
            vals_l.append(v)
            st_l.append(st)
        snap = self._assemble_snapshot(keys_l, vals_l, st_l)
        return snap["keys"], snap["values"], snap["state"]

    def writeback(self) -> int:
        """Store the touched rows back ("set") or their change since
        staging ("delta"); a collective over a ``DistributedTable``, which
        every rank enters with or without rows. Returns the rows written
        back."""
        keys, vals, st = self._trained_rows()
        if self.writeback_mode == "delta":
            skeys, svals, sstate = self._staged
            # skeys is sorted (np.unique)
            if skeys.size:
                j = np.minimum(np.searchsorted(skeys, keys), skeys.size - 1)
                hit = skeys[j] == keys
            else:
                j = np.zeros(keys.size, dtype=np.int64)
                hit = np.zeros(keys.size, dtype=bool)
            base_v = np.zeros_like(vals)
            base_s = np.zeros_like(st)
            base_v[hit] = svals[j[hit]]
            base_s[hit] = sstate[j[hit]]
            # mid-pass keys: the backing's fresh rows; called on every
            # rank (a collective), with or without such keys
            missing = ~hit
            mv, ms = self.backing.export_rows(keys[missing], create=True)
            if missing.any():
                base_v[missing] = mv
                base_s[missing] = ms
            self.backing.import_rows(keys, vals - base_v, st - base_s,
                                     mode="add")
        else:
            self.backing.import_rows(keys, vals, st)
        self._clear_dirty()
        return int(keys.size)

    def end_pass(self) -> None:
        """Write back and reset the shards (an open pass), then the
        backing's pass end (its decay; a barrier over a
        ``DistributedTable``)."""
        if self.in_pass:
            self.writeback()
            self.in_pass = False
            self._staged = None
            self.staged_keys = None
            self._reset_arena(rebuild_mirror=False)
        self.backing.end_pass()
        if self._admit is not None:
            self._admit.advance_epoch()

    # -- persistence: the backing is the durable tier ------------------------

    def _flush_and_rebaseline(self) -> None:
        """A save mid-pass: write the shards back, then ("delta") take the
        backing's rows as the new staged base, so that ``end_pass`` does
        not add the same change twice."""
        if not self.in_pass:
            return
        self.writeback()
        if self.writeback_mode == "delta":
            keys = self._staged[0]
            nv, ns = self.backing.export_rows(keys, create=True)
            self._staged = (keys, nv, ns)

    def save(self, path: str) -> None:
        self._flush_and_rebaseline()
        self.backing.save(path)

    def save_delta(self, path: str) -> int:
        self._flush_and_rebaseline()
        return self.backing.save_delta(path)

    def snapshot_parts(self, delta: bool = False):
        """Flush the shards, then the backing's snapshot files."""
        self._flush_and_rebaseline()
        return self.backing.snapshot_parts(delta=delta)

    def mark_dirty(self, keys) -> None:
        self.backing.mark_dirty(keys)

    def load(self, path: str) -> None:
        if self.in_pass:
            raise RuntimeError("load during an open pass")
        self.backing.load(path)

    def __len__(self) -> int:
        return len(self.backing)
