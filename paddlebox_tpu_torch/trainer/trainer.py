"""Training orchestration: ``CTRTrainer.train_from_dataset`` and
``train_from_files`` on one device (counterpart of the single-device
branches of ``paddlebox_tpu/trainer/trainer.py``).

Two step engines, as in the reference:

- ``FusedTrainStep`` over a ``DeviceTable`` (``use_device_table=True``,
  the default), or a ``TieredDeviceTable`` whose pass working set
  ``PassManager`` stages from its host backing (``ps/tiered_table.py``);
- ``TrainStep`` over a host table (``use_device_table=False``, or as
  ``table`` an ``EmbeddingTable``, a ``ShardedTable`` or a ``RemoteTable``
  of the PS service, ``ps/service/``): the host pulls the batch's rows,
  the step runs on ``device`` and hands back the embedding grads, the
  host pushes them, each a span (``pull``, ``step``, ``push``).

``train_from_dataset`` drives either one batch at a time:

    for batch in dataset.batches():  [pull] -> step -> [push]
                                     -> [fetch_handler, dump]

``train_from_files`` trains straight off files on the fused engine (the
host-table engine raises ``ValueError``, as the reference's does):
``data/fast_feed.py`` ``FastSlotReader.stream`` (the C++ tokenizer,
vectorized batches), or with ``workers`` > 1 ``MultiProcessReader.stream``
(the parse in worker processes), feeds ``FusedTrainStep.train_stream`` in
segments of ``AUC_DRAIN_STEPS`` steps.

The fused step is device prep (``step_device``: host ``ensure_keys``, the
dedup and probe on the card) when a native single-map index backs the
table, else host prep (``__call__``: host ``prepare_batch``), as the
reference resolves it; ``insert_mode="deferred"`` (device prep only, else
it warns and trains in "ensure" mode) leaves new keys to the device miss
ring, which ``train_from_dataset`` drains at the pass end
(``_drain_miss_ring``) and ``train_from_files`` at the end of each
``train_stream`` segment. The f32 AUC state on the device drains into the host's
float64 calculator every ``AUC_DRAIN_STEPS`` steps and at the pass end,
and is zeroed in place (a captured run writes into its tensors).
``SpanTimer`` times each batch ("main") and its step ("step"; and "pull"
and "push" on the host-table engine) in ``train_from_dataset``, each
segment ("main") in ``train_from_files``;
``TrainerConfig(profile=True)`` (or ``PBOX_FLAGS_profile_trainer``) prints
the reference's ``log_for_profile`` line on stderr at the end of either
pass; in ``train_from_dataset`` on the fused engine the line and the
pass heartbeat also carry the first batch's ``sections[...]`` table
(``trainer/profiler.py``). The dump subsystem writes one
JSON line per instance (search_id, label, pred; task 0's of a multi-task
model). ``metrics`` is the named ``MetricRegistry`` the reference's
trainer carries, for the caller to fill.

The reference's flags, read from their ``PBOX_FLAGS_<name>`` variables:

- ``feed_device_prefetch`` > 0 (with ``feed_staging_buffers``,
  ``config.feed_prefetch_conf``) stages ``train_from_files`` through the
  device feed (``data/device_feed.py``): the reader's
  ``stream_columnar`` views -> ``DeviceFeed`` (one a trainer, its ring
  reused by every pass at that depth) ->
  ``FusedTrainStep.train_stream(feed=)``. It needs the fused engine
  (else ``ValueError`` at construction) with device prep (else at
  ``train_from_files``), as in the reference.
- ``obs_trace_dir`` turns the Chrome trace on at construction
  (``obs/trace.py``), whose spans include ``SpanTimer``'s.
- ``obs_heartbeat_path``: each pass ends with a ``pass`` heartbeat record
  (``obs/heartbeat.py``): steps, wall seconds, examples/s, batch size,
  AUC, ``ins_num``, the timer's spans and ``host_share``, the share of
  the pass the training thread spent on host feed work (the
  ``feed.host_ms`` counter the streams add to). The record goes to the
  logger whether or not the flag names a file.
- ``obs_postmortem_dir`` installs the crash hooks at construction and
  arms the fatal-site dump of either entry (``obs/postmortem.py``).
- ``check_nan_inf`` attaches an abort-policy train guard to a fused
  trainer (``trainer/guard.py`` ``maybe_auto_guard``).

The train guard: a ``TrainGuard`` attached to the trainer (``_guard``)
is asked for a pending trip at each ``AUC_DRAIN_STEPS`` segment of
``train_from_files`` and before each batch of ``train_from_dataset``
(``guarded_train_one``, which also retries a transient step error), and
each pass ends with its ``finalize_pass``; ``TrainGuard.run_pass`` drives
``train_from_dataset`` with rollback and skip.

Not ported, and refused with ``NotImplementedError``: ``mesh=`` and
``dense_sync_hook`` (ROADMAP A.9).
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import time
import warnings
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
from torch import nn

from paddlebox_tpu_torch._device import DeviceLike
from paddlebox_tpu_torch.config import (BucketSpec, DataFeedConfig,
                                        TableConfig, TrainerConfig,
                                        feed_prefetch_conf, flag)
from paddlebox_tpu_torch.data.batch import CsrBatch
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.data import ingest
from paddlebox_tpu_torch.data.fast_feed import (FastSlotReader,
                                                MultiProcessReader)
from paddlebox_tpu_torch.metrics.auc import AucCalculator, reset_auc_state_
from paddlebox_tpu_torch.metrics.registry import MetricRegistry
from paddlebox_tpu_torch.obs import heartbeat, postmortem, trace
from paddlebox_tpu_torch.obs.metrics import REGISTRY
from paddlebox_tpu_torch.ps import native
from paddlebox_tpu_torch.ps.device_table import DeviceTable
from paddlebox_tpu_torch.ps.table import EmbeddingTable
from paddlebox_tpu_torch.trainer.fused_step import FusedTrainStep
from paddlebox_tpu_torch.trainer.train_step import TrainStep
from paddlebox_tpu_torch.utils.timer import SpanTimer

# drain the on-device f32 AUC accumulator into float64 well before any
# bucket count approaches 2^24 (metrics/auc.py); read at run time
AUC_DRAIN_STEPS = 512


def _resolve_device_prep(table: DeviceTable,
                         device_prep: Optional[bool]) -> bool:
    """On when the native single-map index backs the table (the sharded
    ``MtIndex`` has no slot export for the device mirror)."""
    if device_prep is not None:
        return device_prep
    return native.available() and isinstance(table._index,
                                             native.NativeIndex)


class CTRTrainer:
    def __init__(self, model: nn.Module, feed_conf: DataFeedConfig,
                 table_conf: TableConfig, trainer_conf: TrainerConfig,
                 table: Optional[Any] = None,
                 use_device_table: bool = True,
                 device_capacity: int = 1 << 20,
                 buckets: Optional[BucketSpec] = None,
                 use_cvm: bool = True,
                 dump_path: Optional[str] = None,
                 mesh=None,
                 device_prep: Optional[bool] = None,
                 insert_mode: str = "ensure",
                 dense_sync_hook: Optional[Callable] = None,
                 device: DeviceLike = None):
        """``model`` is an ``nn.Module`` holding its dense weights (for a
        parity run: converted from the reference trainer's flax params by
        ``models/convert.py``); the trainer moves it to the step's device.
        ``table`` picks the engine: a ``DeviceTable`` the fused one, any
        other table with ``pull`` and ``push`` (an ``EmbeddingTable``, a
        ``ShardedTable``, the PS service's ``RemoteTable``) the host-table
        one. Without ``table``, a
        ``DeviceTable(table_conf, capacity=device_capacity,
        device=device)`` is built, or with ``use_device_table=False`` an
        ``EmbeddingTable(table_conf)`` (``device`` None = the card: the
        host-table engine's step runs there). ``device_prep`` None = on
        when a native single-map index backs the device table
        (``index_threads=1``); the host-table engine ignores it and
        ``insert_mode``, as the reference's does."""
        if insert_mode not in ("ensure", "deferred"):
            raise ValueError(f"unknown insert_mode {insert_mode!r}")
        if mesh is not None or dense_sync_hook is not None:
            raise NotImplementedError(
                "multi-device training (mesh=, dense_sync_hook) is not "
                "ported yet (ROADMAP A.9)")
        if trainer_conf.num_devices > 1:
            raise NotImplementedError(
                f"TrainerConfig.num_devices={trainer_conf.num_devices}: "
                "multi-device training is not ported yet (ROADMAP A.9)")
        if table is not None and not isinstance(table, DeviceTable) and \
                not (callable(getattr(table, "pull", None))
                     and callable(getattr(table, "push", None))):
            raise TypeError(
                f"table is a {type(table).__name__}: the port trains a "
                "DeviceTable (fused engine) or a host table with pull and "
                "push (host-table engine)")
        # trainer_conf.dense_sync_steps is read only with a mesh and
        # trainer_conf.metrics not at all on one device, as in the
        # reference
        trace.maybe_enable()
        postmortem.maybe_install()
        self.model = model
        self.feed_conf = feed_conf
        self.table_conf = table_conf
        self.trainer_conf = trainer_conf
        self.num_slots = len(feed_conf.used_sparse_slots)
        self.dense_dim = sum(s.dim for s in feed_conf.used_dense_slots)
        self.timer = SpanTimer(metric_prefix="trainer")
        self.metrics = MetricRegistry()
        self.calc = AucCalculator()
        self.buckets = buckets
        self.dump_path = dump_path
        self._dump_f = None
        self._step_count = 0
        if table is not None:
            self.table = table
        elif use_device_table:
            self.table = DeviceTable(table_conf, capacity=device_capacity,
                                     device=device)
        else:
            self.table = EmbeddingTable(table_conf)
        self.fused = isinstance(self.table, DeviceTable)
        if self.fused:
            dp = _resolve_device_prep(self.table, device_prep)
            self.step = FusedTrainStep(
                model, self.table, trainer_conf,
                batch_size=feed_conf.batch_size, num_slots=self.num_slots,
                dense_dim=self.dense_dim, use_cvm=use_cvm, device_prep=dp,
                insert_mode=self._gate_insert_mode(insert_mode, dp))
        else:
            self.step = TrainStep(
                model, table_conf, trainer_conf,
                batch_size=feed_conf.batch_size, num_slots=self.num_slots,
                dense_dim=self.dense_dim, use_cvm=use_cvm, device=device)
        # a device-feed request the engine cannot honor fails here, not
        # as a prefetch flag silently ignored
        if feed_prefetch_conf()[0] > 0 and not self.fused:
            raise ValueError(
                "feed_device_prefetch > 0 needs the fused engine "
                "(use_device_table=True); the host-table TrainStep has "
                "no staged wire to prefetch into")
        self._feed = None
        # the last pass heartbeat record
        self.last_heartbeat: Optional[dict] = None
        self.params, self.opt_state = self.step.init()
        self.auc_state = self.step.init_auc_state()
        # a TrainGuard registers itself here (attach); check_nan_inf
        # attaches an abort-policy one
        self._guard = None
        from paddlebox_tpu_torch.trainer.guard import maybe_auto_guard
        maybe_auto_guard(self)

    # -- dump subsystem ------------------------------------------------------

    def _dump_batch(self, batch: CsrBatch, preds: np.ndarray) -> None:
        if self.dump_path is None:
            return
        if self._dump_f is None:
            os.makedirs(os.path.dirname(self.dump_path) or ".",
                        exist_ok=True)
            self._dump_f = open(self.dump_path, "a")
        n = batch.num_rows
        sids = (batch.search_ids if batch.search_ids is not None
                else np.zeros(n, dtype=np.int64))
        for i in range(n):
            self._dump_f.write(json.dumps({
                "search_id": int(sids[i]),
                "label": float(batch.labels[i]),
                "pred": float(preds[i] if preds.ndim == 1
                              else preds[i, 0])}) + "\n")

    def close_dump(self) -> None:
        if self._dump_f is not None:
            self._dump_f.close()
            self._dump_f = None

    # -- the hot loop --------------------------------------------------------

    @staticmethod
    def _cvm(batch: CsrBatch) -> np.ndarray:
        """Per-instance CVM input (show=1, clk=label), for the train and
        eval paths."""
        return np.stack([np.ones(batch.batch_size, np.float32),
                         batch.labels], axis=1)

    @staticmethod
    def _gate_insert_mode(insert_mode: str, dp: bool) -> str:
        """"deferred" needs device prep; without it the request warns and
        training proceeds in "ensure" mode."""
        if insert_mode == "deferred" and not dp:
            warnings.warn(
                "insert_mode='deferred' ignored: device_prep is off "
                "(native single-map index unavailable or explicitly "
                "disabled) — training proceeds in 'ensure' mode",
                RuntimeWarning, stacklevel=3)
            return "ensure"
        return insert_mode

    def _drain_miss_ring(self) -> None:
        """The pass end's drain of the miss ring on the batch-at-a-time
        device-prep path: deferred keys first seen in the last lagged poll
        interval reach the index before the metrics and a save (the stream
        drains through ``train_stream(final_poll=True)``)."""
        if self.fused and self.step.device_prep and \
                self.step.insert_mode == "deferred":
            self.table.poll_misses()

    def _train_one(self, batch: CsrBatch):
        cvm = self._cvm(batch)
        if not self.fused:
            with self.timer.span("pull"):
                emb = self.table.pull(batch.keys)
            with self.timer.span("step"):
                (self.params, self.opt_state, self.auc_state, demb, loss,
                 preds) = self.step(
                    self.params, self.opt_state, self.auc_state, emb,
                    batch.segment_ids, cvm, batch.labels, batch.dense,
                    batch.row_mask())
            with self.timer.span("push"):
                self.table.push(batch.keys, demb)
            return loss, preds
        entry = self.step.step_device if self.step.device_prep else \
            self.step
        with self.timer.span("step"):
            (self.params, self.opt_state, self.auc_state, loss,
             preds) = entry(
                self.params, self.opt_state, self.auc_state, batch.keys,
                batch.segment_ids, cvm, batch.labels, batch.dense,
                batch.row_mask())
        return loss, preds

    def _drain_auc(self) -> None:
        self.calc.absorb(self.auc_state)
        reset_auc_state_(self.auc_state)

    def train_from_files(self, files: Sequence[str], prefetch: int = 2,
                         buckets: Optional[BucketSpec] = None,
                         workers: int = 1) -> Dict[str, float]:
        """One pass straight off MultiSlot files, with no in-memory
        dataset: ``FastSlotReader`` parses ``prefetch`` files ahead on a
        background thread (with ``workers`` > 1, ``MultiProcessReader``
        parses them in that many processes, the same batches), and
        ``FusedTrainStep.train_stream`` trains the batches as they come,
        in segments of ``AUC_DRAIN_STEPS`` steps, each a "main" span, the
        AUC drained after each. A short last batch is masked, so every
        row trains and counts. Every exit closes the reader (its workers
        and segments). Returns the pass metrics. The fused engine
        only. Under ``feed_device_prefetch`` > 0 the batches go through
        the staged device feed (device prep only)."""
        if not self.fused:
            raise ValueError(
                "train_from_files rides the single-chip fused engine; "
                "use train_from_dataset for host-table training")
        feed = self._device_feed()
        if workers > 1:
            reader = MultiProcessReader(self.feed_conf, workers=workers,
                                        buckets=buckets or self.buckets)
        else:
            reader = FastSlotReader(self.feed_conf,
                                    buckets=buckets or self.buckets)
        self._pass_begin()
        if feed is not None:
            stream = reader.stream_columnar(files, drop_remainder=False,
                                            prefetch=prefetch)
        else:
            stream = reader.stream(files, drop_remainder=False,
                                   prefetch=prefetch)
        try:
            while True:
                seg = itertools.islice(stream, AUC_DRAIN_STEPS)
                with self.timer.span("main"):
                    (self.params, self.opt_state, self.auc_state, _loss,
                     steps) = self.step.train_stream(
                        self.params, self.opt_state, self.auc_state, seg,
                        feed=feed)
                self._step_count += steps
                self._drain_auc()
                if self._guard is not None:
                    # a segment's end is a consistent point: a trip stops
                    # the pass within one segment
                    self._guard.check_trip()
                if steps < AUC_DRAIN_STEPS:
                    break
            if self._guard is not None:
                self._guard.finalize_pass()   # the lagged sentinel tail
        except Exception as e:
            # the pass dies: the evidence bundle first
            postmortem.maybe_dump("trainer.train_from_files", exc=e)
            raise
        finally:
            # a failed pass must not leave the parse thread or the
            # workers working ahead
            stream.close()
            reader.close()
            ingest.log_pass_report("train_from_files")
        return self._pass_end()

    def train_from_dataset(self, dataset: SlotDataset,
                           fetch_handler: Optional[Callable] = None
                           ) -> Dict[str, float]:
        """One pass over the dataset's in-memory records. Calls
        ``fetch_handler(step, loss, preds)`` after each batch (``preds`` a
        host array). Returns the pass metrics."""
        try:
            return self._train_from_dataset(dataset, fetch_handler)
        except Exception as e:
            postmortem.maybe_dump("trainer.train_from_dataset", exc=e)
            raise

    def _train_from_dataset(self, dataset, fetch_handler):
        self._pass_begin()
        profile = self._profiling()
        sections = None
        guard = self._guard
        for batch in dataset.batches():
            if profile and sections is None:
                # () where the engine has no section profiler: tried once
                sections = self._profile_sections(batch) or ()
            with self.timer.span("main"):
                # a guard's step: a transient error retried and a trip
                # surfaced before the batch steps (the same numbers as
                # the bare step on a clean pass)
                loss, preds = (guard.guarded_train_one(self, batch)
                               if guard is not None
                               else self._train_one(batch))
            self._step_count += 1
            if self._step_count % AUC_DRAIN_STEPS == 0:
                self._drain_auc()
            if self.dump_path is not None or fetch_handler is not None:
                p = preds.cpu().numpy()
                self._dump_batch(batch, p)
                if fetch_handler is not None:
                    fetch_handler(self._step_count, float(loss), p)
        self._drain_miss_ring()
        self._drain_auc()
        if guard is not None:
            # the last guard_sentinel_lag steps are read here, so a NaN
            # at the pass's end still trips
            guard.finalize_pass()
        return self._pass_end(sections)

    def _device_feed(self):
        """The staged device feed of ``train_from_files`` under
        ``feed_device_prefetch`` > 0 (None at 0): one a trainer, kept
        while the flags keep their depth and buffers, so its ring's
        pinned slots serve every pass."""
        depth, buffers = feed_prefetch_conf()
        if depth == 0:
            return None
        if not self.step.device_prep:
            raise ValueError(
                "feed_device_prefetch > 0 needs the device-prep fused "
                "engine (native single-map index); this trainer resolved "
                "device_prep=False")
        feed = self._feed
        if feed is None or (feed.depth, feed.buffers) != (depth, buffers):
            from paddlebox_tpu_torch.data.device_feed import DeviceFeed
            feed = self._feed = DeviceFeed(self.step, depth=depth,
                                           buffers=buffers)
        return feed

    def _pass_begin(self) -> None:
        """Marks of the pass heartbeat: the clock, the step count and the
        ``feed.host_ms`` counter at the pass start."""
        self._pass_marks = (time.perf_counter(), self._step_count,
                            REGISTRY.counter("feed.host_ms").get())

    def _profiling(self) -> bool:
        return bool(self.trainer_conf.profile or flag("profile_trainer"))

    def _profile_sections(self, batch: CsrBatch):
        """The batch's section table (``trainer/profiler.py``), on the
        fused engine; None on the host-table engine, which keeps its
        span timers."""
        if not self.fused:
            return None
        from paddlebox_tpu_torch.trainer.profiler import profile_sections
        return profile_sections(
            self.step, self.params, self.opt_state, self.auc_state,
            batch.keys, batch.segment_ids, self._cvm(batch), batch.labels,
            batch.dense, batch.row_mask(), iters=4)

    def _pass_end(self, sections: Optional[Dict[str, float]] = None
                  ) -> Dict[str, float]:
        """The pass metrics, the profile line when asked for (with the
        section table when there is one), and the pass heartbeat."""
        out = self.calc.compute()
        if self._profiling():
            line = (f"log_for_profile pass_steps={self._step_count} "
                    f"{self.timer.report()}")
            if sections:
                from paddlebox_tpu_torch.trainer.profiler import \
                    format_sections
                line += f"  sections[{format_sections(sections)}]"
            print(line, file=sys.stderr)
        self._pass_heartbeat(out, sections)
        return out

    def _pass_heartbeat(self, out: Dict[str, float],
                        sections: Optional[Dict[str, float]] = None
                        ) -> None:
        """One ``pass`` heartbeat record (``obs/heartbeat.py``), as the
        reference's trainer writes it: steps, wall seconds, examples/s,
        batch size, AUC, ``ins_num``, the span timer's snapshot, and
        ``host_share``, the share of the pass's wall time the training
        thread spent on host feed work (the streams' ``feed.host_ms``);
        an engine that adds nothing to that counter gets no
        ``host_share``; under a profile, the ``sections`` table. Also
        the ``trainer.steps`` counter and the ``trainer.examples_per_s``,
        ``trainer.auc`` and ``trainer.host_share`` gauges."""
        t0, steps0, host0 = self._pass_marks
        steps = self._step_count - steps0
        wall = time.perf_counter() - t0
        eps = steps * self.feed_conf.batch_size / wall if wall > 0 else 0.0
        REGISTRY.counter("trainer.steps").add(steps)
        REGISTRY.gauge("trainer.examples_per_s").set(eps)
        if "auc" in out:
            REGISTRY.gauge("trainer.auc").set(out["auc"])
        rec = dict(steps=steps, wall_s=round(wall, 3),
                   examples_per_s=round(eps, 1),
                   batch_size=self.feed_conf.batch_size,
                   auc=out.get("auc"), ins_num=out.get("ins_num"),
                   spans=self.timer.snapshot())
        host_ms = REGISTRY.counter("feed.host_ms").get() - host0
        if host_ms > 0.0 and wall > 0:
            share = min(1.0, host_ms / 1e3 / wall)
            rec["host_share"] = round(share, 4)
            REGISTRY.gauge("trainer.host_share").set(share)
        if sections:
            rec["sections"] = sections
        self.last_heartbeat = heartbeat.emit("pass", **rec)

    def evaluate(self, dataset: SlotDataset) -> Dict[str, float]:
        """Forward-only pass (no table change) with its own calculator,
        on task 0."""
        calc = AucCalculator()
        for batch in dataset.batches():
            # the fused step pulls on the device from the keys; the host
            # table pulls the rows here
            rows = (batch.keys if self.fused else
                    self.table.pull(batch.keys, create=False))
            preds = self.step.predict(self.params, rows, batch.segment_ids,
                                      self._cvm(batch), batch.dense)
            p = preds.cpu().numpy()
            p0 = p if p.ndim == 1 else p[:, 0]
            calc.add_batch(p0, batch.labels, batch.row_mask())
        return calc.compute()

    def reset_metrics(self) -> None:
        self.calc.reset()
        self.timer.reset()
