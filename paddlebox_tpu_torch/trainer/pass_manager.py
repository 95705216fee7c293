"""The day/pass loop (counterpart of
``paddlebox_tpu/trainer/pass_manager.py::PassManager``):

    set_date(day)
    begin_pass                      load (or adopt the preloaded buffer),
                                    feed the pass's keys to the PS
    preload_next                    parse pass N+1 in the background
    prefetch_feed_next              and start its staging (a tiered
                                    table exports its rows on its worker)
    ... train pass N ...            CTRTrainer.train_from_dataset
    end_pass(save_delta)            writeback (tiered), show/clk decay,
                                    then a delta save
    [at day end] save_base          the whole table, and the dense state
    barrier                         every save durable and recorded

Two datasets double-buffer the passes as in the reference. ``resume()``
restores the tables (the last verified base, then its deltas) and the
dense state from the donefile trail.

A save pays only the host copy on the training thread
(``SparsePS.snapshot_files``, ``utils/checkpoint.py::dense_arrays``);
serialization, the atomic dir commit, the donefile append and retention
run on the ``AsyncCheckpointWriter``. The layout is the reference's
(``<root>/<day>/<pass:05d>/{base,delta}/<table>.npz``, ``manifest.json``,
``donefile.jsonl``, ``dense.npz`` in ``leaf_%05d`` order), so a trail
written by either package resumes in the other.

Under ``PBOX_FLAGS_serve_quantized`` each base and delta also commits a
derived int8 serving snapshot, ``<dir>.q8`` (``ps/quant_table.py``
``quantize_snapshot`` of each table's snapshot, on the writer thread),
after its parent dir and before the donefile append: no record names it,
retention prunes it with its parent, ``ckpt/discovery.py``
``quantized_sibling`` finds it. A table whose layout the quantizer cannot
take (``variable_embedding``) is skipped with a warning.

Each ``end_pass`` emits the reference's ``end_pass`` heartbeat record
(``obs/heartbeat.py``; to a file under ``PBOX_FLAGS_obs_heartbeat_path``):
day and pass, the ingest counters' delta (``data/ingest.py``
``INGEST_STATS``), the writer's queued jobs and whether its thread is
alive, the rows of each table, the pass's ``ps.nonfinite_grad_rows``,
``ps.disk.*`` and ``ps.remote.*`` deltas from the global registry (the
disk tier and admission count into ``ps.disk.*``, the PS service's client
``ps/service/`` ``RemoteTable`` into ``ps.remote.*``), and the pass
timer's spans; then, with the trace on (``obs_trace_dir``, turned on at
construction), it rewrites the Chrome trace's dump.

``set_date`` resolves the day through ``config.resolve_day``: a nonzero
``PBOX_FLAGS_fix_dayid`` pins it, as in the reference. Under
``obs_postmortem_dir`` the manager installs the crash hooks at
construction, and a failed ``begin_pass`` or ``end_pass`` leaves a
postmortem bundle before it raises (``obs/postmortem.py``).

The reference reads its queue depth, retries and kept bases from its flag
registry; the port has none, and takes the flags' defaults as constants.
"""

from __future__ import annotations

import os
import threading
import warnings
from typing import Any, Optional, Sequence, Tuple

from paddlebox_tpu_torch.ckpt import atomic, discovery, faults, retention
from paddlebox_tpu_torch.ckpt.writer import AsyncCheckpointWriter
from paddlebox_tpu_torch.config import env_flag, resolve_day
from paddlebox_tpu_torch.data import ingest
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.data.parser import IngestError
from paddlebox_tpu_torch.obs import heartbeat, postmortem, trace
from paddlebox_tpu_torch.obs.metrics import REGISTRY
from paddlebox_tpu_torch.ps.quant_table import quantize_snapshot
from paddlebox_tpu_torch.ps.server import SparsePS
from paddlebox_tpu_torch.trainer import donefile
from paddlebox_tpu_torch.utils.checkpoint import dense_arrays
from paddlebox_tpu_torch.utils.timer import SpanTimer

# the reference's flag defaults
CKPT_QUEUE_DEPTH = 2
CKPT_RETRIES = 3
CKPT_KEEP_BASES = 3

#: ps.disk.* counters surfaced as per-pass deltas in the heartbeat
_DISK_COUNTERS = ("ps.disk.bloom_hit", "ps.disk.bloom_miss",
                  "ps.disk.admit_admitted", "ps.disk.admit_rejected")

#: ps.remote.* counters surfaced as per-pass deltas in the heartbeat
#: (zeros: training is in-process)
_REMOTE_COUNTERS = ("ps.remote.bytes_in", "ps.remote.bytes_out",
                    "ps.remote.retries", "ps.remote.shard_unavailable",
                    "ps.remote.shard_restarts", "ps.remote.cache_hit",
                    "ps.remote.cache_miss")


class PassManager:
    def __init__(self, ps: SparsePS, save_root: str,
                 datasets: Sequence[SlotDataset],
                 table_for_dataset: Optional[str] = None,
                 writer: Optional[AsyncCheckpointWriter] = None,
                 keep_bases: Optional[int] = None):
        """``datasets``: 1 (simple) or 2 (double-buffered) datasets.
        ``table_for_dataset``: the table fed the datasets' keys (default:
        the PS's first). ``writer``: one writer shared across managers;
        by default the manager builds its own and sweeps the staging spill
        a crashed predecessor left under ``save_root``."""
        self.ps = ps
        self.save_root = save_root
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("need at least one dataset")
        self.table_name = table_for_dataset or next(iter(ps.tables))
        self.day: str = "19700101"
        self.pass_id = 0
        trace.maybe_enable()
        postmortem.maybe_install()
        self.timer = SpanTimer(metric_prefix="pass")
        self._buf = 0  # which dataset holds the current pass
        self._prefetch_thread: Optional[threading.Thread] = None
        self._prefetch_keys = None
        self._writer = writer or AsyncCheckpointWriter(
            max_queue=CKPT_QUEUE_DEPTH, retries=CKPT_RETRIES)
        self.retention = retention.RetentionPolicy(
            keep_bases=CKPT_KEEP_BASES if keep_bases is None
            else int(keep_bases))
        # only when this manager owns its writer: with a shared one,
        # another manager may be committing under this root
        if writer is None:
            retention.prune_tmp(save_root)
        # the registry counters the end_pass record reports by pass
        self._marks = {name: REGISTRY.counter(name).get()
                       for name in ("ps.nonfinite_grad_rows",
                                    *_DISK_COUNTERS, *_REMOTE_COUNTERS)}
        # the last end_pass heartbeat record
        self.last_heartbeat: Optional[dict] = None

    def _counter_delta(self, name: str) -> float:
        """``name``'s change since the previous call (or construction)."""
        cur = REGISTRY.counter(name).get()
        d, self._marks[name] = cur - self._marks[name], cur
        return d

    # -- day/pass ------------------------------------------------------------

    def set_date(self, day: str) -> None:
        """The day of the next passes; ``PBOX_FLAGS_fix_dayid`` pins it
        (the reference's replay knob)."""
        self.day = resolve_day(day)

    @property
    def current(self) -> SlotDataset:
        return self.datasets[self._buf]

    @property
    def next_buffer(self) -> SlotDataset:
        return self.datasets[(self._buf + 1) % len(self.datasets)]

    def _join_prefetch(self) -> None:
        if self._prefetch_thread is not None:
            self._prefetch_thread.join()
            self._prefetch_thread = None

    def begin_pass(self, filelist: Sequence[str],
                   preloaded: bool = False) -> SlotDataset:
        """Open the next pass: load ``filelist`` (or adopt the preloaded
        buffer) and feed the pass's keys to the PS. Returns the pass's
        dataset."""
        self.pass_id += 1
        self.ps.begin_pass(self.pass_id)
        ds = self.current
        self._join_prefetch()
        try:
            if preloaded:
                with self.timer.span("wait_preload"):
                    ds.wait_preload_done()
            else:
                ds.set_filelist(filelist)
                with self.timer.span("load"):
                    ds.load_into_memory()
                # a prefetch targeted the preloaded records, which this
                # load replaced
                self._prefetch_keys = None
        except IngestError as e:
            # the error names its pass; the pass is dead, so the bundle
            # is written while the ingest counters are hot
            err = type(e)(f"pass {self.pass_id} (day {self.day}): {e}",
                          e.bad_lines)
            postmortem.maybe_dump("pass_manager.begin_pass", exc=err)
            raise err from e
        with self.timer.span("feed_pass"):
            keys = self._prefetch_keys
            if keys is None:
                keys = ds.extract_keys()
            self._prefetch_keys = None
            self.ps.feed_pass({self.table_name: keys})
        return ds

    def preload_next(self, filelist: Sequence[str]) -> None:
        """Parse the next pass's files in the background, into the other
        dataset, while this pass trains."""
        ds = self.next_buffer
        ds.set_filelist(filelist)
        ds.preload_into_memory()

    def prefetch_feed_next(self) -> None:
        """After ``preload_next``: once the preload is done, extract its
        keys on a background thread and start the tables' asynchronous
        staging (``SparsePS.prefetch_pass``: a ``TieredDeviceTable``
        exports the rows on its tier worker); ``begin_pass(preloaded=True)``
        then reuses the keys, and the tiered table consumes the export."""
        ds = self.next_buffer

        def work():
            ds.wait_preload_done()
            keys = ds.extract_keys()
            self.ps.prefetch_pass({self.table_name: keys})
            self._prefetch_keys = keys

        self._prefetch_thread = threading.Thread(target=work, daemon=True)
        self._prefetch_thread.start()

    def end_pass(self, save_delta: bool = False) -> None:
        """Close the pass: surface a failed save of an earlier pass, decay
        show/clk, then (``save_delta``) take the delta snapshot and queue
        its commit, and rotate the datasets. A failure raises before the
        datasets rotate (after the postmortem bundle, when armed)."""
        try:
            self._end_pass(save_delta)
        except Exception as e:
            postmortem.maybe_dump("pass_manager.end_pass", exc=e)
            raise

    def _end_pass(self, save_delta: bool) -> None:
        self._join_prefetch()
        self._writer.raise_pending()
        with self.timer.span("end_pass"):
            self.ps.end_pass()
            if save_delta:
                self._submit_save("delta")
            self.current.release_memory()
        self._buf = (self._buf + 1) % len(self.datasets)
        self._end_pass_heartbeat()

    def _end_pass_heartbeat(self) -> None:
        """The pass's ``end_pass`` heartbeat record, then the trace's
        dump when tracing is on."""
        occupancy = {}
        for name, t in self.ps.tables.items():
            try:
                occupancy[name] = len(t)
            except TypeError:
                pass                 # a table without a row count
        REGISTRY.gauge("ckpt.lag_jobs").set(self._writer.pending())
        disk = {name.rsplit(".", 1)[-1]: self._counter_delta(name)
                for name in _DISK_COUNTERS}
        disk["worker_queue"] = REGISTRY.gauge("ps.disk.worker_queue").get()
        self.last_heartbeat = heartbeat.emit(
            "end_pass", day=self.day, pass_id=self.pass_id,
            ingest=ingest.INGEST_STATS.consume_delta(),
            ckpt_lag_jobs=self._writer.pending(),
            ckpt_writer_alive=self._writer.alive(),
            nonfinite_grad_rows=self._counter_delta(
                "ps.nonfinite_grad_rows"),
            table_rows=occupancy, disk=disk,
            remote={name.split(".", 2)[-1]: self._counter_delta(name)
                    for name in _REMOTE_COUNTERS},
            spans=self.timer.snapshot())
        if trace.enabled():
            trace.dump()

    # -- persistence ---------------------------------------------------------

    def _submit_save(self, kind: str,
                     dense_state: Optional[Any] = None) -> str:
        """Snapshot, then write: the host copies are taken here, on the
        training thread (taking them clears the dirty marks); the files,
        the dir commit, the donefile append and retention run on the
        writer. Returns the final dir (committed once the job lands)."""
        day, pass_id = self.day, self.pass_id
        final = self.ps.ckpt_dir(self.save_root, day, pass_id, kind)
        with self.timer.span(f"save_{kind}_snapshot"):
            files = self.ps.snapshot_files(kind)
            staging = atomic.stage_dir(final)
            dense = (dense_arrays(dense_state) if dense_state is not None
                     else None)
        root, policy = self.save_root, self.retention
        # the int8 serving export: the snapshot arrays are host copies, so
        # the quantizing runs on the writer; the tables' configs are read
        # here, so the job touches no live table
        q8_files = {}
        if env_flag("serve_quantized", False) and kind in ("base", "delta"):
            for fname, arrays in files.items():
                t = self.ps.tables.get(fname.split(".npz", 1)[0])
                conf = getattr(t, "conf", None)
                if (conf is None or conf.variable_embedding
                        or not {"keys", "values"} <= set(arrays)):
                    continue
                q8_files[fname] = (arrays, conf)
        final_q8 = final + discovery.QUANT_SUFFIX

        def job() -> None:
            if os.path.isdir(staging):      # not yet committed (retry-safe)
                for fname, arrays in files.items():
                    atomic.write_npz(os.path.join(staging, fname), arrays)
                    faults.crash_point(f"{kind}.mid_write")
                if dense is not None:
                    atomic.write_npz(os.path.join(staging, "dense.npz"),
                                     dense)
                atomic.commit_dir(staging, final, scope=kind)
            if q8_files and not os.path.isdir(final_q8):
                # committed after its parent and before the donefile
                # append: a crash in here leaves prunable .tmp- spill only
                faults.crash_point(f"{kind}.before_q8")
                qstaging = atomic.stage_dir(final_q8)
                for fname, (arrays, conf) in q8_files.items():
                    try:
                        q8 = quantize_snapshot(arrays, conf)
                    except ValueError as e:
                        # that table is quantized on load by its consumer;
                        # it never fails the parent's commit
                        warnings.warn(f"quantized export skipped "
                                      f"{fname}: {e}")
                        continue
                    atomic.write_npz(os.path.join(qstaging, fname), q8)
                atomic.commit_dir(qstaging, final_q8, scope=f"{kind}.q8")
            faults.crash_point(f"{kind}.before_donefile")
            donefile.write_done(root, day, pass_id, kind, final)
            if kind == "base":
                policy.sweep(root, donefile.read_done(root))

        self._writer.submit(f"{kind}:{day}/{pass_id:05d}", job)
        return final

    def save_base(self, dense_state: Optional[Any] = None,
                  wait: bool = False) -> str:
        """Queue a base save, with ``dense_state`` (the pair ``(model,
        opt_state)``) as ``dense.npz`` beside the tables. Returns the
        final dir at once; ``wait`` (or ``barrier()``) blocks until it is
        durable and recorded."""
        self._writer.raise_pending()
        path = self._submit_save("base", dense_state)
        if wait:
            self._writer.barrier()
        return path

    def save_delta(self, wait: bool = False) -> str:
        """Queue a delta save outside ``end_pass``."""
        self._writer.raise_pending()
        path = self._submit_save("delta")
        if wait:
            self._writer.barrier()
        return path

    def barrier(self) -> None:
        """Block until every queued save committed and reached the
        donefile; re-raise any background error."""
        self._writer.barrier()

    def close(self) -> None:
        """Drain the queued saves and stop the writer."""
        self._writer.close()

    def resume(self, dense_template: Optional[Any] = None
               ) -> Optional[Tuple[str, int, Optional[Any]]]:
        """Restore the tables (the last verified base, then its deltas)
        and, given ``dense_template`` (a ``(model, opt_state)`` pair), the
        dense state into it, in place. Returns ``(day, pass_id,
        dense_template or None)``, or None when no verified checkpoint
        exists."""
        plan = discovery.latest_committed(self.save_root)
        if plan is None:
            return None
        discovery.apply_plan(self.ps, plan)
        self.day, self.pass_id = discovery.plan_version(plan)
        dense_state = discovery.load_dense(plan, dense_template)
        return self.day, self.pass_id, dense_state
