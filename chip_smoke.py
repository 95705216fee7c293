#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``paddlebox_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed 0]

Phases, each fatal on failure:

1. build   — compile the port's native sources from the repository, one
             process each (the push's source in seven parts, one process
             a part: ``ops/_build.py`` ``SPLIT``), all at once: with
             ``nvcc`` the seqpool+CVM forward, its backward (the gather),
             the push (with its boundary kernel and the mesh step's merge)
             and the in-step key dedup and mirror probe,
             alone and fused (``csrc/device_index.cu``); with ``g++`` the
             host key index (``csrc/pbx_index.cpp``) and the file
             tokenizer (``csrc/pbx_feed.cpp``). Print each kernel's ptxas
             report (registers, spills, shared memory). Then the embedded
             loader (``csrc/pbx_serve.cpp``) starts building on a thread
             of its own, for phase 4s.
2. kernel  — hold each kernel, launched on the card, against its plain
             PyTorch version (the forward's on the host, which sums in the
             kernel's key order). Forward: the serving shape (B=512, S=26,
             D=11, Npad from the bucket), the multi-key shape (B=4096, 1-3
             keys a slot), the training shape (B=2048, S=24, Npad=102,400)
             and edge shapes aimed at its 128-key tiles; show/clk sums
             exact.
             Backward, bit-exact: the training shape (B=2048, S=24, D=11,
             Npad=102,400), the training ids in random order, a warp's
             chunk holding segment 0 and segment B*S-1, every key in the
             first or last segment, Npad % 4 == 3, one key past whole
             blocks, 1, 2, 4 and 8 threads a key (D = 11, 24, 50, 67, 200),
             and g, ids and cvm_in one element into their allocations.
             Push: the training shape with sgd,
             adagrad and adam, duplicate keys, key 0, unknown keys and rows
             crossing the embedx threshold, edge shapes, every lane geometry
             (D = 4, 5, 16, 33, 129, 256, each optimizer), a Upad off the
             uniques a warp holds, warps that mix live, dead and padding
             uniques, one unique with nearly every key; show/clk exact, the
             rest within 1e-6, and 10 launches with the dirty mark
             bit-identical, the bitmap exactly the plain mark's. The boundary
             kernel's offsets (and the sorted order) equal
             ``merge_order_plain``'s.
             Dedup (K5) and probe (K6), bit-exact, and against
             ``np.unique`` and the host index: the training batch over the
             4,194,304-key mirror (2^24 + 64 slots, 268 MB), keys at or
             above 2^63 beside small ones, all padding, one key N times,
             ragged tails, keys absent from the mirror, a cluster whose run
             reaches slot 63 of its window and a run that ends in the guard.
             K5 also on keys that differ in one byte (each of the eight),
             keys straddling 2^63, N = 2047, 2048, 2049, the training batch
             with one key 500 times and 102,400 keys over all 64 bits; its
             radix sort against ``torch.sort``, its plan (the active digits,
             printed) against the plain plan. The fused dedup and probe
             (K5 whose write pass walks the mirror), bit-exact against its
             plain version over the training mirror in every K5 case, 10
             launches each, and on the probe cases; the training batch's
             rows against the host index's.
3. serve   — write a seeded synthetic Criteo file, export a DeepFM
             (hidden 512-256-128) bundle whose table has >= 4M rows, serve
             every batch through ``CTRPredictor(device="cuda")``; the
             forward kernel's launch count must equal the batch count, and
             the scores must match the same predictor with a plain pool,
             and the predictor on the CPU.
   Scoring time per batch and a device profile of the serving loop.
4. train   — the flagship DeepFM (hidden 512-256-128, adam dense, adagrad
             table of 4,194,304 prepopulated rows), 16 steps of B=2048, on
             two paths, each counted from 0:
             host prep over the numpy index (``FusedTrainStep.__call__``):
             the forward, backward, push and boundary kernels launch once a
             step; device prep over the native index and its mirror
             (``FusedTrainStep.step_device``, "ensure" mode): the fused
             dedup and probe (K5's sort, count pass and fused write pass),
             forward, backward and push launch once a step, K6 alone and
             the boundary kernel never (the profile shows the fused pass
             and no ``probe_kernel``). Losses finite, the sentinel untripped;
             the first 2 steps match the CPU (host prep), and the host-prep
             step on the card and the device-prep step on the CPU (device
             prep).
   Time per step and examples/s of device prep, of host prep over each
   index, host time by phase and a device profile; ``ensure_keys`` and
   ``prepare_batch`` on batches with 5% new keys, then each batch's new
   keys looked up in the mirror (``DeviceIndexMirror.probe``, K6 alone)
   against the host index.
4b. trainer — the reference's entry point: two seeded MultiSlot files of
             16 batches of B=2048 (a label and 24 slots of 1-3 keys; the
             first file's keys uniform over the 4,194,304 prepopulated
             rows, 5% of the second's new) -> ``SlotDataset`` (Npad
             102,400) -> ``CTRTrainer.train_from_dataset``, device prep
             over the native index (``index_threads=1``) and its mirror:
             forward, backward, push, K5's sort and the fused dedup and
             probe launch once a batch, the boundary kernel, K5 whole and
             K6 alone never; losses, pass metrics, the whole arena and the
             dense params equal a hand loop of ``step_device`` over the
             same batches on a twin table bit for bit; ``evaluate``
             launches the forward once a batch.
   Seconds of ``load_into_memory``, ms a batch of ``BatchAssembler``, and
   the trainer's ms/step and examples/s beside the hand loop's, in turns,
   with the ``SpanTimer`` report.
   Trainer files: the same files through ``CTRTrainer.train_from_files``
   on a twin of the same arena and weights (the C++ tokenizer,
   ``FastSlotReader``, ``FusedTrainStep.train_stream``'s runs of 16: the
   first eager, the second captured as a CUDA graph and replayed): the
   same kernels launch once a batch, replays counted; pass metrics, every
   row by key and the dense params equal ``train_from_dataset``'s bit for
   bit, and adam's count, mu and nu too those of the eager run loop (the
   run path without its graph) on another twin. The step paths over the
   same batches timed in turns (run graphs, eager run loop, hand loop of
   ``step_device``), the first two profiled; both entries timed in turns
   (dataset, files, files, dataset), with ``FastSlotReader.stream`` ms a
   batch and ``parse_file`` ms a file.
4c. run graphs across a growth — four runs of 16 batches of B=2048
             through ``train_stream`` over a table of 520,000
             prepopulated rows, the third with 15% new keys, which grow
             the arena and move the mirror to a table of twice the slots:
             2 captures (the second run's, and once more after the
             growth), 3 replays; every device-prep kernel once a batch;
             losses, rows by key, dense params, adam's state and the AUC
             state bit for bit against the eager run loop on a twin.
4d. pass loop — the reference's day/pass loop, driven as
             ``examples/02_deepfm_stream.py`` drives it, at the flagship's
             width: two days of two passes, each one seeded MultiSlot file
             of 16 batches of B=2048 (day 2's with 5% new keys), over a
             ``DeviceTable`` of 4,194,304 prepopulated rows on device prep:
             ``PassManager.begin_pass`` (load, feed the pass's keys),
             ``preload_next``, ``CTRTrainer.train_from_dataset``,
             ``end_pass(save_delta=True)``, ``save_base(dense_state=...)``
             at each day end, then ``barrier()``. Every device-prep kernel
             once a batch; the trail ``delta, delta, base`` a day; each
             delta holds exactly its pass's keys and the push kernel
             marked exactly those rows; a resume into a fresh table and
             trainer equals the live one bit for bit (rows by key, dense
             params, adam's count, mu, nu); day 1 over a host-prep twin
             (``MtIndex`` of 4 threads) gives the same deltas by key, bit
             for bit. Trainer files and the growth stream hold their dirty
             rows to the eager paths' by key (``snapshot_delta``).
   The synchronous snapshot ms of each delta and base, rows per delta,
   the writer's commit seconds, the wait in ``barrier()``, ``resume``
   seconds, and the dataset pass with the dirty mark and without it, in
   turns, each beside the card's name and power limit.
4e. tiered loop — tables larger than device memory, as
             ``bench.py:735-802`` measures them: the flagship DeepFM over a
             ``TieredDeviceTable`` of 2^20 arena rows (device prep, a
             one-thread native index) over a native host
             ``EmbeddingTable``, three passes (two days: two, then one,
             ``TIER_DAYS``) of one seeded MultiSlot file
             of 16 batches of B=2048 (the first drawing from 450,000 new
             keys out of a 2^33 space, each later one from 450,000 new and
             150,000 of earlier passes' keys; the backing ends larger than
             the arena): ``PassManager.begin_pass`` (the staging),
             ``preload_next`` + ``prefetch_feed_next`` (the next pass's
             export on the tier worker), ``CTRTrainer.train_from_files``
             (run graphs), ``end_pass(save_delta=True)`` (writeback, decay),
             a base with the dense state a day, ``barrier()``. Every
             device-prep kernel once a batch; each pass stages exactly
             its keys; the consumes take the prefetched buffers (a spy);
             bit for bit by key: the backing against a twin that stages
             synchronously (its passes in turns with the main loop's),
             day 1's deltas and base against a host-prep twin
             (``train_from_dataset``), and a ``resume`` into a fresh world
             (the dense state too).
   Per pass: W, staging s (synchronous and consumed prefetch), training
   ms/step, ``end_pass`` s, delta snapshot ms, captures; the peak device
   memory, the arena's and mirror's bytes beside the backing's, the run
   graphs on the tiered table beside an untiered ``DeviceTable`` of every
   row, and the step idle, then beside a dataset preload, each
   beside the card's name and power limit.
4f. host engine and models — the reference's other engine and the
             models of ``examples/01``, ``03`` and ``04`` at their widths:
             (a) ``CTRTrainer(WideDeep(256-128-64),
             use_device_table=False)`` over a native host
             ``EmbeddingTable``, one seeded MultiSlot file of 16 batches
             of B=512 (26 slots of 1-3 keys, 13 dense): the forward and
             backward once a batch, ``evaluate`` the forward once a batch;
             losses, pass metrics, every row by key and the dense params
             bit for bit against a hand loop of ``TrainStep`` + pull/push
             on a twin, its first 2 steps within 1e-5 of the CPU and the
             rows' change within 1e-3 of its largest entry. (b) MMoE
             (2 tasks, 4 experts 128-64, towers 64) through ``TrainStep``
             over a host table, 16 steps of B=2048 (20 slots), labels [B,
             2] as the example makes them, a ``MetricRegistry`` of
             ``ctr_auc`` and ``cvr_auc``; the first 2 steps as (a)'s
             against the CPU. (c) ``FeedDNN()`` over a ``DeviceTable`` of
             2^20 rows
             on device prep through ``FusedTrainStep.train_stream``, 32
             batches of B=512 (40 slots): a warm-up run and a captured,
             replayed one, every device-prep kernel once a batch; losses,
             rows by key, dense params, adam's and the AUC state bit for
             bit against the eager run loop on a twin; its first 2 steps
             against device prep on the CPU (every kernel's plain
             version) as (a)'s, the touched rows read in the warm-up
             run. (d) MMoE and
             FeedDNN bundles from (b) and (c) served by
             ``CTRPredictor(device="cuda")``, the forward once a batch,
             scores within 1e-5 of the predictor on the CPU.
   ms/step and examples/s of (a)-(c), the pull, step and push spans of
   (a) and (b) and inside the step its upload, device time and download
   (a profile), ms a batch of (d).
4g. arenas — the bf16, int8 and variable arenas (``DeviceTable(...,
             value_dtype=torch.bfloat16 / torch.int8)``,
             ``variable_embedding`` at ``examples/08``'s widths), from
             their own generator: (a) each push variant (bf16, int8,
             variable, variable+int8, variable+bf16) against
             ``sparse_push_plain``: the training batch (a key 500 times, 50
             unknown keys; adagrad and adam) over a warm 4,194,304-row
             arena, all-padding, one-key, threshold-0 (sgd) and mixed
             warps; three launches bit-identical with the dirty mark;
             show/clk and size codes exact, int8 codes within 1, scales
             within rtol 1e-6 + 1e-6 / 127, dequantized values within one
             quantum, bf16 values within one spacing + 1e-6, the rest
             1e-6. (b)
             The flagship over a 4,194,304-row int8 table:
             ``CTRTrainer.train_from_files`` on two seeded files of 16
             batches (one eager run, one replay) bit for bit against the
             eager run loop on a twin; 16 host-prep steps, 2 of them
             against the CPU by ``compare_twin``'s rule over canonical rows:
             int8 codes equal but for at most 1e-4 of them one code apart
             (slack there: one quantum), scales within rtol 1e-6. (c) The
             same over a bf16 arena with ``DeepFM(dtype=torch.bfloat16)``
             and ``bf16=True``, host prep cut to 4 steps; against the CPU
             by the same rule (bf16 values equal but for 1e-4 of them one
             spacing apart), the dense weights within lr / 10. (d) ``FusedTrainStep`` over variable+int8 (16
             steps) and variable float32 (4) tables of 4,194,304 rows, 2
             steps each against the CPU by the same rule, size codes exact.
             (e) The int8 table's bundle served against the CPU predictor.
   Bytes a row of each arena read from the card; ms/step of int8, bf16
   and float32 tables (f32 dense, run graphs) in turns; each variant's
   push at the training shape beside its bound, plain and ``index_add_``
   (the merge only).
4h. dense optimizers — lars, lamb, adam under gradient merging of 4
             (``grad_merge_steps``, ``optax.MultiSteps``) and adam with
             ``recompute``, each over the flagship (a 4,194,304-row
             adagrad table, B=2048): ``CTRTrainer.train_from_files`` over
             two seeded files of 16 batches (device prep, one eager run,
             one captured and replayed), every device-prep kernel once a
             batch, bit for bit against the eager run loop on a twin (rows
             by key, dense params, every optimizer state tensor, metrics);
             then host-prep steps from that twin, 2 (5 under merging),
             counted (the device-prep kernels never), against the CPU by
             ``compare_twin``'s rule, lars's and lamb's dense change held
             as the rows' is (within 1e-3 of its largest entry), the dense
             params checked after each step (under merging unchanged but
             on the emit steps).
   Each world's run graphs ms/step beside plain adam's, in turns.
4i. disk ladder — ``bench.py:735-860``'s tiered cell with its disk
             tier: the flagship (``show_clk_decay=0.5``) over a
             ``TieredDeviceTable`` of 2^20 rows (device prep) over a
             native ``EmbeddingTable`` over a ``DiskTier``, phase 4e's
             first two files (one day: two passes, cut from two days)
             through ``PassManager`` with ``prefetch_feed_next`` and
             ``train_from_files``; after each ``end_pass`` every row spills
             (``evict_cold(show_threshold=inf)``) and the disk compacts,
             so each pass restages from disk. In turns: a synchronous
             twin, a ``PBOX_FLAGS_ps_tier_demote=1`` twin (its deltas and
             bases too) and an admission run
             (``PBOX_FLAGS_ps_admit_shows=2``). Bit for bit by key: W, the
             backing, the disk's rows, the dense state; the admission
             run's staged keys against a replay of the sketch's decisions,
             its rejected keys in no tier; the consumes took the
             prefetched buffers.
   Per pass: W, staging s, disk read and insert s, spilled and restaged
   rows, evict and compact s, ``disk_bytes()``, ``bandwidth()``,
   ``end_pass`` s, ms/step, each beside the card's name and power limit.
4j. the rest — (a) ``fused_seqpool_cvm_with_conv`` (with and without the
             show filter), ``fused_seqpool_cvm_with_pcoc`` and ``cvm`` at
             the training shape, forward and backward on CUDA tensors,
             twice (bit for bit), against the CPU (the pooled and copied
             columns and the grads bit for bit, the log heads within
             tolerance); (b) ``examples/02``'s
             flow on the host-table engine (``use_device_table=False``,
             two days of two passes of 4 batches of B=2048, deltas, bases)
             and a resume into a fresh table and trainer, bit for bit by
             key; (c) phase 4f's host ``TrainStep`` under ``bf16``: float32
             inputs, bit for bit against ``bf16=False``.
4k. tiered arenas — phase 4e's tiered loop over an int8 and over a bf16
             arena (``TieredDeviceTable(value_dtype=...)``), cut in depth
             to its first two passes, in turns with a synchronous twin:
             the backings bit for bit by key; the last pass's keys staged
             again and 2 host-prep steps of that arena's twin against the
             CPU; bytes a row, W, staging, train and ``end_pass`` times.
4l. deferred insert — the flagship through ``train_from_files`` with
             ``insert_mode="deferred"`` over phase 4b's two files (5% new
             keys in the second), one eager run and one replay: bit for
             bit against the eager deferred run loop; the keys the ring's
             polls inserted equal the files' new keys; no ``ensure_keys``
             call or span; 2 deferred steps (misses on row 0) against the
             CPU, the rings equal; run graphs ms/step in turns with
             "ensure".
4m. int8 serving — the flagship bundle exported from 4k's int8 table
             under ``PBOX_FLAGS_serve_quantized`` and served at B=512:
             float32, int8, and int8 with the hot-key cache and
             coalescing (counted); the int8 scores bit for bit with and
             without the cache and coalescing, against the CPU's int8
             predictor, and within 0.02 of float32 serving; ms/batch in
             turns; the tables' device bytes.
4n. data feed — the reference's data feed at the flagship's width: (i)
             four seeded MultiSlot files of 16 batches of B=2048 (the
             trainer's key mix, 5% new keys in the second and fourth)
             through ``CTRTrainer.train_from_files`` with ``workers=4``
             over the shared-memory fabric, over the pipe, and
             ``workers=1``, each on a twin of one arena and one set of
             weights: pass metrics, rows by key, the dense params and
             adam's state bit for bit; forward, backward, push, K5's sort
             and the fused dedup and probe once a batch; ``close()`` leaves
             no segment (``leaked_segments`` 0, none in /dev/shm); (ii)
             the same through ``pipe_command="cat"`` with ``workers=4``,
             bit for bit against (i); (iii) a file with 3 bad lines
             through ``SlotDataset`` under
             ``PBOX_FLAGS_ingest_max_bad_lines=5`` and a quarantine
             directory: its sidecar holds exactly the 3 lines, the
             default budget raises naming the first, the records train;
             (iv) two files of two-part instances (``parse_ins_id``)
             through ``set_merge_by_insid(2)`` (each merged record the
             instance written), ``global_shuffle`` over the 2 datasets,
             ``spill_to_disk`` and ``load_from_archive``, then
             ``train_from_dataset``: bit for bit against the same records
             trained without the spill.
   ``train_from_files`` ms/step at workers 1, 2 and 4 in turns, parse
   MB/s on one thread and with 4 workers, a worker's start seconds (its
   imports load no torch), each beside the card's name and power limit.
4o. staged feed — the staged device feed (``data/device_feed.py``:
             pinned ring slots, uploads on a copy stream, the columnar run
             graph) over 4n's four files at the flagship's width, each
             world a twin of one arena and one set of weights: (i)
             ``train_from_files`` under ``PBOX_FLAGS_feed_device_prefetch``
             2 (5 buffers) and 1 with ``feed_staging_buffers`` 2, then in
             "deferred" mode, each bit for bit against the unstaged pass
             (metrics, rows by key, dense params, adam's state), every
             slot back and no producer left; (ii) ``workers=4`` over the
             fabric under ``ingest_shm_defer_recycle=1`` bit for bit
             against (i), no segment left; (iii) the first capture made
             while the producer stages ahead (the files twice in one
             pass), bit for bit against two unstaged passes, then on the
             same twins a file of 42 batches over two key buckets whose
             runs end short (tails through ``step_device``, the last
             batch partial) at depth 1 with 2 buffers, the ring dropping
             a free slot of one shape for the other at its cap; (iv) a
             malformed line mid-pass re-raises the reader's error, leaves
             no slot held and no producer thread, and the next pass
             trains; (v) forward, backward, push, K5's sort and the fused
             dedup and probe once a batch in every pass; (vii) a
             ``PassManager`` pass under ``obs_trace_dir`` and
             ``obs_heartbeat_path``: the Chrome JSON holds the feed's
             spans, the heartbeat one ``pass`` and one ``end_pass``
             record.
   (vi) ``train_from_files`` ms/step staged and unstaged in turns, the
   feed's histograms (p50/p99 of ``feed.h2d_ms``, ``feed.h2d_device_ms``,
   ``feed.pack_ms``, ``feed.stage_wait_ms``, ``feed.ring_wait_ms``), the
   heartbeat's ``host_share`` of both, and a run's upload GB/s from
   pinned memory against the unstaged pageable copy, in turns, each beside
   the card's name and power limit.
4p. guard  — the lifecycle layer over 4n's first two files at the
             flagship's width: (a) ``train_from_files`` with a
             ``TrainGuard`` attached against a guard-less twin, bit for
             bit; (b) a committed base, then ``TrainGuard.run_pass`` with
             NaN labels in one batch: one ``nan`` trip at its step and
             window, one rollback, every dense leaf and row finite, bit
             for bit with a twin restored from the base and trained
             without the window; (c) under ``check_nan_inf`` and
             ``obs_postmortem_dir`` a new trainer's guard raises
             ``GuardAbort`` and one bundle commits (six files, a manifest
             whose crcs verify); (d) ``profile=True``: the
             ``log_for_profile`` line with every section, printed, the
             pass bit for bit with a ``profile=False`` twin; (e) three
             disk-tier passes whose ``end_pass`` disk deltas equal the
             registry's, ``ps.ssd.*``, ``ingest.*`` and ``ckpt.*`` grown.
   ms/step with the guard on and off in turns, the poller's lag in steps,
   the rollback's seconds and the profile's sections, each beside the
   card's name and power limit.
4q. serving tier — phase 3's flagship bundle (DeepFM 512-256-128, 26
             Criteo slots + 13 dense, B=512, 4,194,304 table rows) behind
             the port's serving tier, 16 requests of 512 of its lines from
             4 connections at once for each of: (a) ``PredictServer``; (b)
             a thread-scope ``ReplicaSet`` of 2 behind a ``FrontDoor``; (c)
             a process-scope ``ReplicaSet`` of 2 spawned children, each
             with its own CUDA context and table, behind a ``FrontDoor``.
             Each: the seqpool kernel once a request (the children's counts
             carried back on their side channels), the scores within 1e-6
             of a direct ``CTRPredictor`` on the card (bits equal or not
             printed). (b) then a ``ReloadWatcher`` over a trail the port's
             ``PassManager`` commits (a base of the whole table with new
             dense weights, a delta rewriting 5% of the rows and adding
             10,000 keys) swaps to the base, then to the delta under
             traffic: no request fails, no ``serving.reload_recompiled``,
             both replicas at the new version, their scores bit for bit a
             fresh ``load_predictor_from_plan``'s. (c) then a SIGKILL of a
             child under traffic: every request answered, the child's
             memory released, the monitor's tick restarts it under the
             supervisor; a reload in the children, bit for bit the same.
             (d) on (c)'s fleet a p99 rule labelled ``action=shed`` makes
             it shed (``SheddingLoad``, ``/healthz`` 503) and a quiet window
             clears it; ``/metrics`` parses and carries the children's
             ``serve.*`` series.
   p50 and p99 ms a request and examples/s of each tier in turns with a
   direct ``predict_records`` of the same records, a child's spawn seconds
   split (start, CUDA context, build, handshake), its device memory, the
   reload's ``serving.reload_ms`` in both scopes and the card's peak
   memory during a thread-scope swap, each beside the card's name and
   power limit.
4r. host tier — phase 3's bundle served by a ``HostFleet`` of 2 spawned
             hosts (each a process group: a thread-scope ``ReplicaSet`` of
             1 ``CTRPredictor`` on the card, a ``FrontDoor``, a
             ``/metrics``) under a ``FileResolver`` and an ``LBClient``:
             (a) 4 clients x 16 requests of 512 lines, the scores within
             1e-6 of a direct ``CTRPredictor``, each host's seqpool
             launches (counted from 0 on its control channel) equal to the
             requests it served, on both hosts, and equal to its
             ``/metrics`` through ``FleetMetrics``; (b) the reference
             drill's ``host_sigkill``: a killpg of one host under traffic,
             no client failure, a newer generation published, the host
             restarted and its group gone, then both hosts serving; (c)
             ``rolling_drain``: a decommission under traffic, no failure,
             then ``add_host``. ``host_failover``'s numbers: steady
             examples/s, examples/s in the kill window, the MTTR.
4s. embedded — ``export_embedded_bundle`` of phase 3's bundle (4,194,304
             rows: key and value files, manifest, layout, the exported
             dense program and its AOTInductor package; on a process of
             its own from phase 3 on, beside phases 4-4p), then the C++
             loader ``pbx_serve`` (``csrc/pbx_serve.cpp``, built by
             ``ops/_build.py`` on a thread since phase 1) scores 16 batches
             of 512 of phase 3's lines with no Python: the key index's
             lookup, the seqpool+CVM kernel, the AOTI dense forward; its
             scores within rtol 2e-5, atol 1e-6 of ``CTRPredictor``, its
             launches equal to its batches, and it exits nonzero on a
             truncated bundle, without a CUDA device and without its
             kernel library. Its ms a batch of lookup, H2D, pool, dense,
             D2H.
4t. ctr ops — every CTR dense op (``ops/ctr_ops.py``: data_norm, its
             stats and summary update, rank_attention, batch_fc, scaled_fc,
             cross_norm_raw and cross_norm_hadamard) on the card against
             the same code on the CPU, outputs and gradients, at the
             flagship's training batch (the pooled input [2048, 24*11]),
             rank_attention's offsets from ``PvBatchAssembler`` over
             seeded PV groups of 1-5 ads (max_rank 3): within 1e-5 of each
             op's largest entry, scaled_fc's bf16 product within 0.05.
             Then ``AucRunner`` over the flagship DeepFM after one trainer
             file: ``slot_importance`` over 4 slots and
             ``slot_importance_pool`` over 2 phases (pool 2048), the
             dataset restored bit for bit, the forward kernel launched
             once a batch of each of the 8 evaluations.
4u. ps service — the networked PS (``ps/service/``, 2 shard servers):
             (a) the flagship DeepFM at B=2048 on the host-table engine
             over a ``RemoteTable``, one trainer file, bit for bit against
             the same over a local ``EmbeddingTable`` (losses, metrics,
             rows by key, dense weights; again after 2 more passes each,
             timed in turns), the wire's bytes and pull and push ms; (b)
             phase 3's 4,194,304-row bundle imported into the service and
             ``CTRPredictor(ps_endpoints=)`` scoring phase 3's 16 batches
             bit for bit against the bundle's predictor, both timed in
             turns, with the device bytes each holds; (c) the drill's
             ``shard_kill`` over one trainer file's keys, a training
             batch's keys a step: no update lost against the never-killed
             oracle; (d) the drill's ``cache_wall``: hit rate, mean pull
             ms with the cache off and on.
4v. mesh   — the device-sharded mesh engine at ``bench.py:280-350``'s
             width (DeepFM 512-256-128, adam 1e-3, B=2048, 24 slots,
             Npad=102,400, ``capacity_per_shard=1 << 22``, native): (a) a
             one-shard mesh on cuda:0 through ``train_stream``, device
             prep and host plan, 32 steps each, losses and the touched
             rows by key within 1e-5 of ``FusedTrainStep`` over the same
             arena and weights, 2 steps against the CPU; then both timed
             in turns with ``FusedTrainStep``'s run graphs and eager run
             loop; (b) a 4-shard mesh on cuda:0 (512 rows a shard, device
             prep), 8 steps against the same mesh on the CPU, which
             takes each step from the card's dense params and adam state
             (the re-synced twin: the summed dense grads equal the
             shards' added in shard order bit for bit, within 1e-5 of the
             twin's in norm, the params within 1e-5 after every step, a
             ReLU pre-activation that rounding alone put across 0 taking
             the card's value); (c)
             ``CTRTrainer(mesh=make_mesh(1))`` over a trainer file,
             ``evaluate``, save, load (bit for bit), a step's delta into a
             ``DeviceTable``; (d) the requester's merge kernel
             (``segment_merge``) against its plain version bit for bit
             (after the timings twice and after CUDA graph replays) at
             (a)'s shape in both engines' forms (device prep by
             unique over K5's order, host plan by position), at (b)'s, at
             (a)'s and (b)'s under a Zipf(1.2) key mix, at (a)'s under
             slot-keyed Criteo traffic with a slot of 3 values (segments
             past the short kernel's 32 keys and past a chunk, the long
             kernel's work items, each kernel's device time) and at edge
             segments (0-33 keys, a
             chunk's C - 1, C, C + 1, 2C + 1, 17,612; D = 1, 11, 64, 256),
             timed beside its bound and ``index_add_``. Every mesh path
             counted:
             each shard's forward, backward, push and merge once a step,
             device prep's two K5 sorts (requester K5, owner K5+K6), host
             plan's two boundary kernels (the requester's merge order, the
             push's).
4w. mesh host — the host-table and dense-sharding mesh engines
             (``parallel/dp_step.py``, ``zero.py``, ``sharding.py``,
             ``pipeline.py``, ``ring_attention.py``), the flagship DeepFM
             over a native ``EmbeddingTable``, one trainer-cell file: (a)
             ``CTRTrainer(mesh=make_mesh(1, device="cuda"),
             use_device_table=False)`` bit for bit with
             ``CTRTrainer(use_device_table=False)`` over 16 steps, timed
             in turns; (b) sync DP over 4 shards on cuda:0, 8 steps,
             against the same mesh on the CPU and the card's
             single-device step on the merged batch, both re-synced as
             4v (b)'s twin; (c) LocalSGD every 4 steps, the replicas
             equal after steps 4 and 8, against the CPU re-synced; (d)
             ZeRO (adam) from (b)'s dense state, each shard's bytes; (e)
             phase 4f's MMoE with its experts over an ``ep`` mesh of 4,
             the forward and 4 host-table steps against the unsharded
             MMoE; (f) a ``PipelinedTower`` (4 stages x 2 blocks) under
             ``FusedTrainStep``, 32 steps through ``train_stream``, the
             second run a captured graph, its forward against
             ``sequential_reference``; (g) ``ring_self_attention`` at
             B=2, T=8192, H=8, D=64 over 4 shards, causal and not, the
             forward and grads against ``dense_attention``. The forward
             and backward kernels' launches counted in every part.
5. timing  — forward at the serving, the multi-key and the training
             shape; backward, push, boundary kernel, dedup and probe at the
             training shape: kernel, plain and library times, per call and
             in a CUDA graph, beside each kernel's bound; the push kernel
             alone beside the push with its merge order, adam beside
             adagrad; the dedup on the training keys and on keys over all
             64 bits, whole, its sort half and its numbering half, beside
             ``torch.sort`` and ``torch.unique``; the fused dedup and probe
             whole and its numbering half beside the pair it replaces (K5
             then K6), in turns, the numbering also with cold caches; and
             the launch floor, the graph time of ``torch.cuda._sleep(0)``.

Prints the card's ``name, power.limit`` line, then one JSON line of
per-kernel numbers, then ``{"ok": true, "device": {...}}`` last. Exits
nonzero, printing no result, without CUDA.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import dataclasses
import functools
import gc
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np
import torch

from paddlebox_tpu_torch.config import (BucketSpec, DataFeedConfig,
                                        SlotConfig, TableConfig,
                                        TrainerConfig, batch_bucket_spec)
from paddlebox_tpu_torch.data.criteo import (CriteoReader, _parse_lines,
                                             criteo_feed_config,
                                             make_synthetic_criteo)
from paddlebox_tpu_torch.data.batch import CsrBatch
from paddlebox_tpu_torch.data import ingest, shm_fabric
from paddlebox_tpu_torch.data.dataset import SlotDataset, global_shuffle
from paddlebox_tpu_torch.data.fast_feed import (FastSlotReader,
                                                MultiProcessReader)
from paddlebox_tpu_torch.data.parser import SlotParser
from paddlebox_tpu_torch.data.pv import PvBatchAssembler
from paddlebox_tpu_torch.ckpt.writer import AsyncCheckpointWriter
from paddlebox_tpu_torch.inference.predictor import (CTRPredictor,
                                                     save_inference_model)
from paddlebox_tpu_torch.inference.server import PredictServer, predict_lines
from paddlebox_tpu_torch.models import MLP, DeepFM, FeedDNN, MMoE, WideDeep
from paddlebox_tpu_torch.models.convert import (deepfm_from_flax_leaves,
                                                flax_leaves_from_model)
from paddlebox_tpu_torch.ops import _build, ctr_ops
from paddlebox_tpu_torch.ops.ctr_ops import build_rank_offset
from paddlebox_tpu_torch.ops import cvm as ops_cvm
from paddlebox_tpu_torch.ops import \
    fused_seqpool_cvm_with_conv as ops_fused_conv
from paddlebox_tpu_torch.ops import \
    fused_seqpool_cvm_with_pcoc as ops_fused_pcoc
from paddlebox_tpu_torch.ops.seqpool_kernel import (bulk_loads, grad_lanes,
                                                    seqpool_cvm_cuda,
                                                    seqpool_cvm_grad_cuda,
                                                    seqpool_cvm_grad_plain,
                                                    seqpool_cvm_plain)
from paddlebox_tpu_torch.ops.sparse_push import (PUSH_VARIANTS,
                                                 mark_dirty_plain,
                                                 merge_offsets,
                                                 merge_offsets_plain,
                                                 merge_order,
                                                 merge_order_plain,
                                                 push_geometry, push_rows,
                                                 SEGMENT_CHUNK,
                                                 segment_merge_cuda,
                                                 segment_merge_plain,
                                                 sparse_push_cuda,
                                                 sparse_push_plain)
from paddlebox_tpu_torch.parallel import fleet
from paddlebox_tpu_torch.parallel.coordinator import (Coordinator,
                                                      dense_mean_hook,
                                                      local_endpoints)
from paddlebox_tpu_torch.parallel.dp_step import (ShardedTrainStep,
                                                  split_batch)
from paddlebox_tpu_torch.parallel.fused_dp_step import FusedShardedTrainStep
from paddlebox_tpu_torch.parallel.mesh import (AXIS_EP, AXIS_PP, AXIS_SP,
                                               make_mesh)
from paddlebox_tpu_torch.parallel.pipeline import (PipelinedTower,
                                                   sequential_reference)
from paddlebox_tpu_torch.parallel.ring_attention import (dense_attention,
                                                         ring_self_attention)
from paddlebox_tpu_torch.parallel.sharding import (expert_shardings,
                                                   unshard_experts)
from paddlebox_tpu_torch.parallel.zero import ZeroShardedTrainStep
from paddlebox_tpu_torch.ops.device_index_kernel import (
    DIGITS, SIGN, dedup_number_cuda, dedup_number_probe_cuda,
    dedup_sort_cuda, device_dedup_cuda, device_dedup_probe_cuda,
    device_probe_cuda)
from paddlebox_tpu_torch.ps.device_index import (DeviceIndexMirror,
                                                 device_dedup_plain,
                                                 device_dedup_probe_plain,
                                                 device_hash,
                                                 device_probe_plain,
                                                 host_hash, key_halves,
                                                 radix_plan_plain)
from paddlebox_tpu_torch.ps.device_table import DeviceTable
from paddlebox_tpu_torch.ps.distributed import DistributedTable
from paddlebox_tpu_torch.ps.native import NativeIndex
from paddlebox_tpu_torch.ps.quant_table import QuantServingTable
from paddlebox_tpu_torch.ps.serving_table import ServingTable
from paddlebox_tpu_torch.ps.sharded_device_table import ShardedDeviceTable
from paddlebox_tpu_torch.ps.admission import CountMinAdmission
from paddlebox_tpu_torch.ps.server import SparsePS
from paddlebox_tpu_torch.ps.service import RemoteTable, ShardService
from paddlebox_tpu_torch.ps.ssd_tier import DiskTier
from paddlebox_tpu_torch.ps.table import (EmbeddingTable, key_init_uniform,
                                         state_dim)
from paddlebox_tpu_torch.ps.tiered_table import (TieredDeviceTable,
                                                 TieredShardedDeviceTable)
from paddlebox_tpu_torch.metrics import AucCalculator, MetricRegistry
from paddlebox_tpu_torch.metrics.auc import reset_auc_state_
from paddlebox_tpu_torch.metrics.auc_runner import AucRunner
from paddlebox_tpu_torch.obs import trace as obs_trace
from paddlebox_tpu_torch.obs.metrics import (REGISTRY, MetricsRegistry,
                                             percentile_from_counts)
from paddlebox_tpu_torch.trainer.fused_step import (FusedTrainStep,
                                                    collect_same_shape_run)
from paddlebox_tpu_torch.trainer import donefile
from paddlebox_tpu_torch.trainer.step_graph import state_tensors
from paddlebox_tpu_torch.trainer.pass_manager import (CKPT_QUEUE_DEPTH,
                                                      CKPT_RETRIES,
                                                      PassManager)
from paddlebox_tpu_torch.trainer.train_step import TrainStep
from paddlebox_tpu_torch.trainer.trainer import CTRTrainer
from paddlebox_tpu_torch.tools import ps_drill
from paddlebox_tpu_torch.utils.timer import SpanTimer

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
# H100 SXM data sheet: HBM3 bandwidth and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# forward kernel vs plain: both sum in float32, the plain version on the
# host, whose index_add_ adds in key order as the kernel does (on the card
# index_add_ adds by atomics in an order that changes from run to run, up
# to ~1.5e-5 away on a 700-key segment); the logs may differ in the last
# bits; show/clk are integer-valued and must be exact before the log
RTOL, ATOL = 1e-6, 1e-5
# scores: float32 GEMMs on the card vs another summation order
SCORE_ATOL = 1e-5
# push kernel vs plain: show/clk exact, the rest summed in another order
PUSH_ATOL = 1e-6
# training on the card vs the CPU, 2 steps: float32 GEMMs and sums in
# another order
TRAIN_RTOL, TRAIN_ATOL = 1e-5, 1e-5
# the steps' change to the touched rows (~1e-6 on values of ~1e-4): card
# vs CPU within this share of the change's largest entry. A push that is
# skipped or has the wrong sign is off by the whole change.
TRAIN_DELTA_RTOL = 1e-3
HIDDEN = (512, 256, 128)
B, S, D = 512, 26, 11
MK_B = 4096                  # batch of the multi-key (training-sized) shape
BATCHES = 16                 # Criteo batches of B served on the main path
TABLE_ROWS = 1 << 22         # rows of the served table snapshot
# training shape (bench.py): B=2048, 24 slots of 1-3 keys, Npad 102,400,
# keys uniform over a prepopulated table of 4,194,304 rows
TB, TS, TNPAD = 2048, 24, 102400
HOT_VOCAB = 1 << 22
TRAIN_STEPS = 16             # counted steps on the main path
CPU_STEPS = 2                # of them, held against the CPU
ITERS = 200                  # calls per timing
DEDUP_REPEATS = 10           # K5 (and fused) launches a check case, all
#                              identical
PUSH_REPEATS = 10            # push launches with the dirty mark a case
KERNEL = "seqpool_cvm"
GRAD = "seqpool_cvm_grad"
PUSH = "sparse_push"
OFFSETS = "merge_offsets"
DEDUP = "device_dedup"
PROBE = "device_probe"
DEDUP_PROBE = "device_dedup_probe"
INDEX = "device_index"      # csrc/device_index.cu: K5, K6 and the fused pass
HOST_INDEX = "pbx_index"    # csrc/pbx_index.cpp: the host key index (g++)
HOST_FEED = "pbx_feed"      # csrc/pbx_feed.cpp: the file tokenizer (g++)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters: int) -> float:
    """Time per call of ``fn`` in ms over ``iters`` back-to-back calls,
    between CUDA events: where the host launches slower than the device
    runs, this is the host's launch rate."""
    for _ in range(10):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps: int = 50) -> float:
    """Device time of ``fn`` in ms: ``reps`` calls captured in one CUDA graph
    and replayed, so no host launch gap sits between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (10 * reps)


def cold_graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn`` in ms with cold caches: the call
    captured in a CUDA graph and replayed ``reps`` times, each replay after
    a write of twice the card's L2 that evicts it. The write also keeps the
    card busy while the host launches the replay, so no launch gap is
    timed."""
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 50 << 20)
    flush = torch.empty(2 * l2 // 4, dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def device_profile(tag: str, fn, kernels=(KERNEL,)) -> dict:
    """Print the device's busy share over one call of ``fn``, its eight
    largest device activities and those of ``kernels``, from a
    torch.profiler trace. Returns the device time (us) by activity name,
    empty if the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    spans: dict = {}
    for e in prof.events():
        # a record_function span shows on the host and, as an annotation
        # over the kernels it launched, on the device: it is not a kernel
        if e.name.startswith("train_step."):
            if e.device_type == DeviceType.CPU:
                spans[e.name] = spans.get(e.name, 0.0) + \
                    e.time_range.elapsed_us()
        elif e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    if spans:
        print(f"profile {tag}: host time by phase: " + ", ".join(
            f"{k[len('train_step.'):]} {v:.0f} us" for k, v in spans.items()))
    busy = sum(by_name.values())
    if not busy:
        print(f"profile {tag}: device time not measured (no device events)")
        return by_name
    print(f"profile {tag}: wall {wall_us:.0f} us, device busy {busy:.0f} us "
          f"({100 * busy / wall_us:.1f}%; overlapping activities counted "
          "twice)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    for name, us in top[:8] + [kv for kv in top[8:]
                               if any(k in kv[0] for k in kernels)]:
        print(f"  {us:10.1f} us  {name[:90]}")
    return by_name


# -- phase 1 -----------------------------------------------------------------

def ptxas_report(log: str) -> list:
    """One entry per kernel in an ``nvcc -Xptxas=-v`` log: its name (with
    its integer template arguments), registers a thread, spill stores and
    loads, stack frame and static shared memory in bytes."""
    out = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = re.search(r"(?<=\d)[a-z][a-z_]*_kernel", m.group(1))
            args = re.findall(r"Li(-?\d+)E", m.group(1))
            out.append({"name": (name.group() if name else m.group(1))
                        + (f"<{','.join(args)}>" if args else ""),
                        "registers": None, "spill_stores": 0,
                        "spill_loads": 0, "stack": 0, "smem": 0})
        elif out:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                out[-1]["stack"], out[-1]["spill_stores"], \
                    out[-1]["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[-1]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                out[-1]["smem"] = int(m.group(1))
    return out


def phase_build() -> dict:
    """One compiler process per source (per part of a source that
    ``_build.SPLIT`` names), all started together. Returns each
    source's ptxas report (empty for a library built by an earlier run)."""
    names = (KERNEL, GRAD, PUSH, INDEX, HOST_INDEX, HOST_FEED)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(_build.build, names))
    reports = {}
    for name, res in zip(names, built):
        require(_build.library_path(name).exists(), f"{name} was not built")
        if res is None:
            print(f"build: {name} already built (no ptxas report)")
            reports[name] = []
            continue
        print(f"build: {name} ({_build.source(name).name}) {res[0]:.2f} s")
        reports[name] = ptxas_report(res[1])
        for r in reports[name]:
            print(f"  ptxas: {r['name']}: {r['registers']} registers, "
                  f"spill stores {r['spill_stores']} B, spill loads "
                  f"{r['spill_loads']} B, stack {r['stack']} B, smem "
                  f"{r['smem']} B")
    print(f"build: all {time.perf_counter() - t0:.2f} s")
    return reports


# -- phase 2 -----------------------------------------------------------------

def segment_layout(batch: int, slots: int, lengths, npad: int):
    """Sorted segment ids [npad] int32 for keys of ``lengths`` a (row,
    slot), padding id ``batch * slots``, and the count of real keys."""
    n = min(int(lengths.sum()), npad)
    segs = np.full(npad, batch * slots, dtype=np.int32)
    segs[:n] = np.repeat(np.arange(batch * slots, dtype=np.int32),
                         lengths)[:n]
    return segs, n


def make_pool_inputs(rng, batch: int, slots: int, dim: int, lengths,
                     npad: int, offset_rows: int = 0):
    """emb [npad, dim] (show/clk integer-valued), sorted segment ids; the
    padding rows hold garbage the pool must ignore. With ``offset_rows``
    emb is a view that many rows into its allocation."""
    segs, n = segment_layout(batch, slots, lengths, npad)
    emb = (rng.normal(size=(npad + offset_rows, dim)) * 0.3).astype(
        np.float32)
    emb[:, 0] = rng.integers(1, 30, size=npad + offset_rows)
    emb[:, 1] = rng.integers(0, 2, size=npad + offset_rows)
    emb[offset_rows + n:] = rng.normal(size=(npad - n, dim)) * 1e3
    emb = torch.from_numpy(emb).cuda()[offset_rows:]
    return emb, torch.from_numpy(segs).cuda(), n


def check_kernel(name: str, emb, segs, batch: int, slots: int,
                 use_cvm: bool, cvm_offset: int, pad_value: float) -> float:
    got = seqpool_cvm_cuda(emb, segs, batch, slots, use_cvm, cvm_offset,
                           pad_value).cpu()
    want = seqpool_cvm_plain(emb.cpu(), segs.cpu(), batch, slots, use_cvm,
                             cvm_offset, pad_value)
    require(got.shape == want.shape,
            f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    require(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
            f"{name}: kernel vs plain max abs err {err}")
    # show/clk sums, before the log: exact against a float64 host sum
    raw = seqpool_cvm_cuda(emb, segs, batch, slots, False, 0, pad_value)
    host = np.zeros((batch * slots + 1, 2))
    np.add.at(host, segs.cpu().numpy(), emb[:, :2].cpu().numpy())
    exact = (host[:batch * slots] + pad_value).astype(np.float32)
    require(np.array_equal(raw.reshape(-1, emb.shape[1])[:, :2].cpu().numpy(),
                           exact), f"{name}: show/clk sums are not exact")
    loads = "tma" if bulk_loads(emb, segs) else "cp.async"
    print(f"kernel check {name}: B={batch} S={slots} D={emb.shape[1]} "
          f"Npad={emb.shape[0]} use_cvm={use_cvm} cvm_offset={cvm_offset} "
          f"pad={pad_value} loads={loads} max_abs_err={err:.3e} ok")
    return err


def phase_kernel(rng):
    """Kernel vs plain at the two timing shapes and at edge shapes. Returns
    the largest error and the inputs of the timing shapes."""
    bucket = batch_bucket_spec()
    # serving shape: Criteo-like, one key per (row, slot) 95% of the time
    lengths = (rng.uniform(size=B * S) > 0.05).astype(np.int64)
    npad = bucket.bucket(int(lengths.sum()))
    serving = make_pool_inputs(rng, B, S, D, lengths, npad)
    err = check_kernel("serving", serving[0], serving[1], B, S, True, 2, 0.0)
    # training-sized shape: 1-3 keys a slot (__graft_entry__._synth)
    mk_lengths = rng.integers(1, 4, size=MK_B * S)
    multikey = make_pool_inputs(rng, MK_B, S, D, mk_lengths,
                                bucket.bucket(int(mk_lengths.sum())))
    err = max(err, check_kernel("multi-key", multikey[0], multikey[1], MK_B,
                                S, True, 2, 0.0))
    # the train phase's shape and options: B=2048, 24 slots of 1-3 keys,
    # Npad 102,400
    tr = make_pool_inputs(rng, TB, TS, D, rng.integers(1, 4, size=TB * TS),
                          TNPAD)
    err = max(err, check_kernel("training", tr[0], tr[1], TB, TS, True, 2,
                                0.0))

    cases = []
    few = rng.integers(0, 4, size=64 * S) * (rng.uniform(size=64 * S) < 0.5)
    cases.append(("empty-segments", 64, S, D, few,
                  bucket.bucket(int(few.sum())), True, 2, 0.0))
    cases.append(("all-padding", 16, S, D, np.zeros(16 * S, np.int64), 1024,
                  True, 2, 0.0))
    odd = rng.integers(0, 4, size=13 * 5)
    cases.append(("ragged-npad", 13, 5, 16, odd, 1000, True, 2, 0.0))
    cases.append(("no-cvm", B, S, D, lengths, npad, False, 3, 0.0))
    cases.append(("pad-value", B, S, D, lengths, npad, True, 2, 0.5))
    cases.append(("no-keys", 4, 3, D, np.zeros(12, np.int64), 0, True, 2,
                  0.0))
    # a 500-key segment (over three 128-key tiles) starting mid-tile
    long = rng.integers(0, 3, size=32)
    long[5] = 500
    cases.append(("long-segment", 8, 4, D, long,
                  bucket.bucket(int(long.sum())), True, 2, 0.0))
    # segment boundaries exactly on tile edges (keys 128, 256, 384, 512)
    edges = np.array([128, 64, 64, 1, 127, 0, 3, 125, 2] + [1] * 23)
    cases.append(("tile-edges", 8, 4, D, edges, 1024, True, 2, 0.0))
    # no padding key (Npad == n, last segment non-empty), n % 4 == 3 so
    # the last tile's TMA copies leave sub-16-byte tails
    full = rng.integers(1, 4, size=64 * S)
    full[0] += (3 - int(full.sum())) % 4
    cases.append(("no-padding", 64, S, D, full, int(full.sum()), True, 2,
                  0.0))
    # every key in the last segment
    tail = np.zeros(16 * S, np.int64)
    tail[-1] = 300
    cases.append(("last-segment", 16, S, D, tail, 1024, True, 2, 0.0))
    cases.append(("d16", 64, S, 16, rng.integers(1, 4, size=64 * S), 8192,
                  True, 3, 0.0))
    # long segments among more tiles than SMs (the kernel's other block
    # size), one of them with rows of 200 columns
    many = rng.integers(1, 4, size=2048 * S)
    many[1000] = 700
    cases.append(("long-segment-many-tiles", 2048, S, D, many,
                  bucket.bucket(int(many.sum())), True, 2, 0.0))
    wide = rng.integers(1, 4, size=512 * S)
    wide[77] = 400
    cases.append(("long-segment-d200", 512, S, 200, wide,
                  bucket.bucket(int(wide.sum())), False, 3, 0.0))
    # rows wide enough to need over 48 KB of shared memory
    cases.append(("d100", 16, S, 100, rng.integers(0, 4, size=16 * S), 1024,
                  False, 3, 0.0))
    for name, b, s, d, lens, npd, use_cvm, off, pad in cases:
        e, sg, _ = make_pool_inputs(rng, b, s, d, lens, npd)
        err = max(err, check_kernel(name, e, sg, b, s, use_cvm, off, pad))
    # emb a view one row into its allocation: not 16-byte aligned, so the
    # kernel loads by cp.async instead of TMA
    e, sg, _ = make_pool_inputs(rng, B, S, D, lengths, npad, offset_rows=1)
    require(not bulk_loads(e, sg), "the offset view is 16-byte aligned")
    err = max(err, check_kernel("misaligned", e, sg, B, S, True, 2, 0.0))
    return err, {"serving": (B, serving), "multikey": (MK_B, multikey),
                 "training": (TB, tr)}


def on_card(x: np.ndarray, offset: int) -> torch.Tensor:
    """``x`` on the card, as a view ``offset`` elements into its
    allocation (not 16-byte aligned for an offset of 1 to 3)."""
    buf = torch.from_numpy(np.concatenate([np.zeros(offset, x.dtype),
                                           x.ravel()])).cuda()
    return buf[offset:].view(x.shape)


def check_grad(rng, name: str, batch: int, slots: int, dim: int, lengths,
               npad: int, use_cvm: bool, cvm_offset: int, shuffle=None,
               offset: int = 0):
    """Backward kernel vs plain, bit for bit, on the sorted segment ids of
    ``lengths`` (reordered by ``shuffle``); with ``offset`` g, the ids and
    cvm_in are views that many elements into their allocations. Returns the
    largest error and the inputs."""
    segs, n = segment_layout(batch, slots, lengths, npad)
    if shuffle is not None:
        segs = shuffle(segs)
    width = dim if use_cvm else dim - cvm_offset
    g = on_card(rng.normal(size=(batch, slots, width)).astype(np.float32),
                offset)
    cvm = on_card(rng.integers(0, 3, size=(batch, cvm_offset)).astype(
        np.float32), offset)
    segs = on_card(segs, offset)
    got = seqpool_cvm_grad_cuda(g, segs, cvm, batch, slots, use_cvm,
                                cvm_offset)
    torch.cuda.synchronize()
    want = seqpool_cvm_grad_plain(g, segs, cvm, batch, slots, use_cvm,
                                  cvm_offset)
    require(got.shape == want.shape == (npad, dim),
            f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    require(torch.equal(got, want),
            f"{name}: backward kernel vs plain max abs err {err}")
    print(f"kernel check {GRAD} {name}: B={batch} S={slots} D={dim} "
          f"Npad={npad} keys={n} use_cvm={use_cvm} cvm_offset={cvm_offset} "
          f"lanes={grad_lanes(dim)} offset={offset} bit-exact ok")
    return err, (g, segs, cvm)


def phase_kernel_grad(rng):
    """Backward kernel vs plain at the training shape and edge shapes.
    Returns the largest error (0: bit-exact) and the training inputs."""
    train_lengths = rng.integers(1, 4, size=TB * TS)
    err, train = check_grad(rng, "training", TB, TS, D, train_lengths, TNPAD,
                            True, 2)
    few = rng.integers(0, 4, size=64 * S) * (rng.uniform(size=64 * S) < 0.5)
    full = rng.integers(1, 4, size=64 * S)
    # every key in the first or the last segment
    ends = np.zeros(TB * TS, np.int64)
    ends[0], ends[-1] = 300, 5000

    def ends_in_one_chunk(segs):
        """The training ids with the last real key's id (n_seg - 1) moved
        to position 1: one warp's chunk holds segment 0 and n_seg - 1."""
        segs = segs.copy()
        last = int(np.flatnonzero(segs < TB * TS)[-1])
        segs[1], segs[last] = segs[last], segs[1]
        return segs

    cases = [
        ("no-cvm", TB, TS, D, rng.integers(1, 4, size=TB * TS), TNPAD,
         False, 3),
        ("cvm-offset-3", 256, TS, D, rng.integers(1, 4, size=256 * TS),
         16384, True, 3),
        ("empty-segments", 64, S, D, few, 1024, True, 2),
        ("no-padding", 64, S, D, full, int(full.sum()), True, 2),
        ("all-padding", 16, S, D, np.zeros(16 * S, np.int64), 1024, True, 2),
        ("no-keys", 4, 3, D, np.zeros(12, np.int64), 0, True, 2),
        ("d67", 64, S, 67, rng.integers(0, 4, size=64 * S), 8192, True, 2),
        ("d200", 512, S, 200, rng.integers(0, 4, size=512 * S), 16384, True,
         3),
        ("d200-no-cvm", 512, S, 200, rng.integers(0, 4, size=512 * S), 16384,
         False, 3),
        # the training ids in random order
        ("unsorted", TB, TS, D, train_lengths, TNPAD, True, 2,
         rng.permutation),
        ("first-and-last-in-a-chunk", TB, TS, D, train_lengths, TNPAD, True,
         2, ends_in_one_chunk),
        ("first-and-last-segment", TB, TS, D, ends, 8192, True, 2),
        # Npad % 4 == 3 (the last warp's chunk is ragged), and one key past
        # 800 whole blocks of 128 keys
        ("npad-mod-4-is-3", TB, TS, D, train_lengths, TNPAD - 1, True, 2),
        ("one-key-past-whole-blocks", TB, TS, D, rng.integers(
            1, 4, size=TB * TS), TNPAD + 1, True, 2),
        # 2 and 4 lanes a key (d67 and d200 take 8), ragged last chunks
        ("d24-lanes-2", 64, S, 24, rng.integers(0, 4, size=64 * S), 4099,
         True, 3),
        ("d50-lanes-4", 64, S, 50, rng.integers(0, 4, size=64 * S), 2050,
         False, 2),
    ]
    for case in cases:
        err = max(err, check_grad(rng, *case)[0])
    # g, the ids and cvm_in one element into their allocations, at the
    # training shape and at D=200
    err = max(err, check_grad(rng, "misaligned", TB, TS, D, train_lengths,
                              TNPAD, True, 2, offset=1)[0])
    err = max(err, check_grad(rng, "misaligned-d200", 512, S, 200,
                              rng.integers(0, 4, size=512 * S), 16384, False,
                              3, offset=1)[0])
    return err, train


def push_table(rng, conf: TableConfig, vocab: int, upad_min: int):
    """A card table of ``vocab`` prepopulated rows whose show/clk straddle
    the embedx threshold and whose optimizer state is warm."""
    table = DeviceTable(conf, capacity=vocab + 1, device="cuda",
                        uniq_buckets=BucketSpec(min_size=upad_min,
                                                max_size=1 << 18))
    table.prepopulate(vocab)
    top = max(2 * conf.embedx_threshold, 4.0)
    show = torch.randint(0, int(top), (vocab,), device="cuda").float()
    table.values[1:, 0] = show
    table.values[1:, 1] = torch.floor(show * 0.3)
    st = table.state[1:]
    if conf.optimizer == "adagrad":
        st.uniform_(0.0, 2.0)
    elif conf.optimizer == "adam":
        st.uniform_(0.0, 0.1)
        for gi in range(len(table.layout.groups)):
            t_col = int(table.layout.state_offsets[gi])
            st[:, t_col] = torch.randint(0, 5, (vocab,),
                                         device="cuda").float()
    return table


def push_batch(rng, conf: TableConfig, vocab: int, npad: int, n_keys: int,
               hot: int = 0, unknown: int = 0, upad_min: int = 1024,
               exact: bool = False):
    """A table (``push_table``) and one batch through ``prepare_batch``:
    ``n_keys`` keys uniform over the table, ``hot`` more copies of one key,
    ``unknown`` keys absent from it (they map to the null row), padding
    keys 0. With ``exact`` the grads lie on a 2^-10 grid, so every order of
    summation gives the same sums. Returns the table and the numpy inputs
    (demb, inverse, uniq_rows, uniq_mask)."""
    table = push_table(rng, conf, vocab, upad_min)
    keys = np.zeros(npad, np.uint64)
    keys[:n_keys] = rng.integers(1, vocab + 1, size=n_keys)
    if hot:
        keys[rng.choice(n_keys, size=hot, replace=False)] = 1 + vocab // 2
    if unknown:
        keys[rng.choice(n_keys, size=unknown, replace=False)] = \
            vocab + 1 + rng.integers(0, 1000, size=unknown)
    idx = table.prepare_batch(keys, create=False)
    return table, (push_grads(rng, npad, table.dim, n_keys, exact),
                   idx.inverse, idx.uniq_rows, idx.uniq_mask)


def push_grads(rng, npad: int, dim: int, n_keys: int, exact: bool = False):
    """Grads at the scale of a training step's (a mean loss over B=2048):
    show 1, clk 0/1, zero past the ``n_keys`` real keys."""
    demb = (rng.normal(size=(npad, dim)) * 0.01).astype(np.float32)
    if exact:
        demb = np.round(demb * 1024) / 1024
    demb[:, 0] = 1.0
    demb[:, 1] = rng.integers(0, 2, size=npad)
    demb[n_keys:] = 0.0
    return demb


def mixed_batch(rng, conf: TableConfig, vocab: int, upad: int):
    """Uniques of three kinds in random order, so that groups of one warp
    diverge: live (a distinct row), dead (row 0, with keys: key 0 or an
    unknown key) and padding (row 0, no keys). Returns the table and the
    numpy inputs."""
    table = push_table(rng, conf, vocab, 1024)
    kind = rng.choice(3, size=upad, p=[0.6, 0.2, 0.2])
    live = kind == 0
    urows = np.zeros(upad, np.int32)
    urows[live] = rng.choice(np.arange(1, vocab + 1), size=int(live.sum()),
                             replace=False)
    umask = live.astype(np.float32)
    with_keys = np.flatnonzero(kind != 2)
    inv = rng.permutation(np.repeat(with_keys, rng.integers(
        1, 4, size=with_keys.size))).astype(np.int32)
    return table, (push_grads(rng, inv.size, table.dim, inv.size), inv,
                   urows, umask)


def check_push(name: str, table, inputs):
    """Push kernel vs plain on one batch, with the dirty mark: PUSH_REPEATS
    launches from the same arena into a zeroed bitmap must give the same
    bits, the bitmap exactly ``mark_dirty_plain``'s; a launch without a
    bitmap the same rows. Returns the largest error off show/clk and the
    card inputs."""
    demb, inv, urows, umask = (torch.from_numpy(np.ascontiguousarray(x))
                               .cuda() for x in inputs)
    layout = table.layout
    cap = table.values.shape[0]
    got, again, want = [(table.values.clone(), table.state.clone())
                        for _ in range(3)]
    sparse_push_cuda(layout, *got, demb, inv, urows, umask)
    dirty = torch.zeros(cap, dtype=torch.bool, device="cuda")
    want_dirty = torch.zeros_like(dirty)
    mark_dirty_plain(want_dirty, urows)
    for rep in range(PUSH_REPEATS):
        again[0].copy_(table.values)
        again[1].copy_(table.state)
        dirty.zero_()
        sparse_push_cuda(layout, *again, demb, inv, urows, umask,
                         dirty=dirty)
        torch.cuda.synchronize()
        require(torch.equal(got[0], again[0]) and
                torch.equal(got[1], again[1]),
                f"{name}: launch {rep + 1} with the dirty mark differs from "
                "the first launch on the same inputs")
        require(torch.equal(dirty, want_dirty),
                f"{name}: launch {rep + 1}: the dirty bitmap differs from "
                f"mark_dirty_plain's ({int(dirty.sum())} rows marked, "
                f"{int(want_dirty.sum())} expected)")
    sparse_push_plain(layout, *want, demb, inv, urows, umask)
    (gv, gs), (wv, ws) = got, want
    require(torch.equal(gv[:, :2], wv[:, :2]),
            f"{name}: show/clk differ between the push kernel and plain")
    require(torch.equal(gv[0], table.values[0]) and
            torch.equal(gs[0], table.state[0]), f"{name}: null row written")
    err = max(float((gv - wv).abs().max()), float((gs - ws).abs().max()))
    require(err <= PUSH_ATOL, f"{name}: push kernel vs plain max abs err "
                              f"{err} > {PUSH_ATOL}")
    conf = layout.conf
    live = umask > 0
    rows = urows[live].long()
    old_show = table.values[rows, 0]
    crossed = int(((old_show < conf.embedx_threshold) &
                   (gv[rows, 0] >= conf.embedx_threshold)).sum())
    changed = int((gv[rows, 2:] != table.values[rows, 2:]).any(1).sum())
    lanes, cols = push_geometry(table.dim)
    print(f"kernel check {PUSH} {name}: {conf.optimizer} D={table.dim} "
          f"G={lanes} C={cols} state={table.state.shape[1]} "
          f"Npad={demb.shape[0]} Upad={urows.shape[0]} "
          f"live={int(live.sum())} rows crossing the threshold={crossed} "
          f"rows trained={changed} max_abs_err={err:.3e}; "
          f"{PUSH_REPEATS} launches with the dirty mark bit-identical, "
          f"bitmap exact ({int(want_dirty.sum())} rows)")
    return err, (layout, table.values, table.state, demb, inv, urows, umask)


# one table config per lane geometry (D = pull_dim): G = 1, 2, 4, 16, 32, 32
GEOMETRY_CASES = {
    4: dict(cvm_offset=2, embedx_dim=2),
    5: dict(cvm_offset=3, embedx_dim=2),
    16: dict(cvm_offset=3, embedx_dim=8, expand_dim=5),
    33: dict(cvm_offset=3, embedx_dim=30),
    129: dict(cvm_offset=3, embedx_dim=64, expand_dim=62),
    256: dict(cvm_offset=3, embedx_dim=125, expand_dim=128),
}


def phase_kernel_push(rng):
    """Push kernel vs plain at the training shape with each optimizer, and
    at edge shapes. Returns the largest error and the adagrad and adam
    training inputs."""
    n_train = TB * TS * 2  # 1-3 keys a slot
    err, train = 0.0, {}
    for opt in ("adagrad", "sgd", "adam"):
        conf = TableConfig(embedx_dim=8, cvm_offset=3, embedx_threshold=10.0,
                           optimizer=opt, seed=7)
        e, inputs = check_push(f"training-{opt}", *push_batch(
            rng, conf, HOT_VOCAB, TNPAD, n_train, hot=500, unknown=50,
            upad_min=TNPAD))
        err = max(err, e)
        if opt != "sgd":
            train[opt] = inputs
    cases = [
        ("all-padding", TableConfig(embedx_threshold=10.0), 4096, 1024, 0),
        ("one-key", TableConfig(embedx_threshold=10.0), 4096, 1024, 1000),
        ("threshold-0", TableConfig(embedx_threshold=0.0), 4096, 2048, 1500),
        ("no-embed-w-expand", TableConfig(cvm_offset=2, expand_dim=4,
                                          optimizer="adam",
                                          embedx_threshold=10.0),
         4096, 2048, 1500),
        ("d67-adagrad", TableConfig(embedx_dim=64, embedx_threshold=10.0),
         4096, 2048, 1500),
        ("d67-adam", TableConfig(embedx_dim=64, optimizer="adam",
                                 embedx_threshold=10.0), 4096, 2048, 1500),
    ]
    for dim, kw in GEOMETRY_CASES.items():
        for opt in ("sgd", "adagrad", "adam"):
            cases.append((f"d{dim}-{opt}", TableConfig(
                optimizer=opt, embedx_threshold=10.0, **kw), 4096, 2048,
                1500))
    for name, conf, vocab, npad, n in cases:
        hot = n - 1 if name == "one-key" else 0
        table, inputs = push_batch(rng, conf, vocab, npad, n, hot=hot,
                                   unknown=20 if n > 1000 else 0)
        err = max(err, check_push(name, table, inputs)[0])
    d11 = TableConfig(embedx_dim=8, cvm_offset=3, embedx_threshold=10.0)
    # Upad off the 8 uniques a warp holds at D=11 (and off a block's 64)
    table, (demb, inv, urows, umask) = push_batch(rng, d11, 4096, 2048, 1500,
                                                  unknown=20)
    upad = int(inv.max()) + 1
    upad += 3 if (upad + 3) % 8 else 5
    err = max(err, check_push("upad-odd", table, (
        demb, inv, urows[:upad], umask[:upad]))[0])
    # warps whose groups are live, dead and padding uniques, G = 4, 16, 2
    for tag, conf, upad in (
            ("d11-adagrad", d11, 1003),
            ("d33-adam", TableConfig(optimizer="adam", embedx_threshold=10.0,
                                     **GEOMETRY_CASES[33]), 1001),
            ("d5-sgd", TableConfig(optimizer="sgd", embedx_threshold=10.0,
                                   **GEOMETRY_CASES[5]), 999)):
        err = max(err, check_push(f"mixed-warps-{tag}", *mixed_batch(
            rng, conf, 4096, upad))[0])
    # one unique holds 100,000 of the batch's 101,000 keys
    n_hot = TNPAD - 1400
    err = max(err, check_push("hot-unique", *push_batch(
        rng, d11, HOT_VOCAB, TNPAD, n_hot, hot=n_hot - 1000, exact=True))[0])
    return err, train


def phase_kernel_offsets(rng, train_inverse: torch.Tensor, upad: int):
    """The merge order on the card (stable sort + boundary kernel) vs
    ``merge_order_plain``, exactly: the training batch's inverse and edge
    cases. Returns the largest absolute difference of order or offsets."""
    gaps = rng.integers(0, 5000, size=20000)
    cases = [
        ("training", train_inverse, upad),
        ("padding-uniques", rng.integers(0, 5000, size=20000), 8192),
        ("interior-gaps", gaps[gaps % 7 != 3], 5000),
        ("one-unique", np.full(50000, 7), 1024),
        ("upad-above-max", rng.integers(0, 10, size=300), 100000),
        ("no-keys", np.zeros(0, np.int64), 64),
        ("last-unique", np.full(300, 4095), 4096),
    ]
    err = 0.0
    for name, inv, upd in cases:
        if isinstance(inv, np.ndarray):
            inv = torch.from_numpy(inv.astype(np.int32)).cuda()
        order, offsets = merge_order(inv, upd)
        torch.cuda.synchronize()
        want_order, want_offsets = merge_order_plain(inv, upd)
        require(torch.equal(offsets, want_offsets),
                f"{OFFSETS} {name}: offsets differ from merge_order_plain")
        require(torch.equal(order, want_order),
                f"{OFFSETS} {name}: order differs from merge_order_plain")
        # "no-keys" has an empty order
        case_err = max(float((got.long() - want.long()).abs().max())
                       for got, want in ((offsets, want_offsets),
                                         (order, want_order)) if got.numel())
        err = max(err, case_err)
        print(f"kernel check {OFFSETS} {name}: Npad={inv.shape[0]} "
              f"Upad={upd} max abs err {case_err} ok")
    return err


def radix_cases(rng) -> dict:
    """Batches aimed at K5's radix sort (the CPU tests hold the plain dedup
    against the reference's on the same ones): keys that differ in one
    byte only, for each of the eight; keys straddling 2^63 whose lowest
    digit is one bin; N one below, at and one above a sort tile."""
    cases = {}
    base = rng.integers(0, 1 << 64, dtype=np.uint64)
    for b in range(DIGITS):
        shift = np.uint64(8 * b)
        vals = rng.integers(0, 256, size=3000).astype(np.uint64)
        cases[f"byte-{b}"] = (base & ~(np.uint64(0xFF) << shift)) | (
            vals << shift)
    offs = rng.integers(-2000, 2000, size=4000) * 256 + 0x5A
    cases["straddle-2^63"] = (np.uint64(1) << np.uint64(63)) + \
        offs.astype(np.uint64)
    for n in (2047, 2048, 2049):
        keys = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
        keys[rng.integers(0, n, n // 4)] = keys[rng.integers(0, n, n // 4)]
        cases[f"n-{n}"] = keys
    return cases


def check_dedup(name: str, keys: np.ndarray):
    """K5 vs its plain version on the card, every output exactly, and both
    against ``np.unique`` of the uint64 keys; its sort half against
    ``torch.sort`` and its plan against the plain plan; DEDUP_REPEATS
    launches bit-identical. Returns the kernel's result."""
    kt = torch.from_numpy(np.ascontiguousarray(keys, np.uint64).view(
        np.int64)).cuda()
    got = device_dedup_cuda(kt)
    srt = dedup_sort_cuda(kt)
    torch.cuda.synchronize()
    want = device_dedup_plain(kt)
    err = 0.0
    for field in got._fields:
        a, b = getattr(got, field), getattr(want, field)
        require(a.shape == b.shape and a.dtype == b.dtype,
                f"{DEDUP} {name}: {field} shape or type differs")
        if a.numel():
            err = max(err, float((a.long() - b.long()).abs().max()))
        require(torch.equal(a, b),
                f"{DEDUP} {name}: {field} differs from the plain version")
    # a race between a pass's threads shows in some launches only
    for _ in range(DEDUP_REPEATS - 1):
        again = device_dedup_cuda(kt)
        require(all(torch.equal(a, b) for a, b in zip(again, got)),
                f"{DEDUP} {name}: two launches differ")
    plan = srt.plan.cpu()
    require(torch.equal(plan, radix_plan_plain(kt.cpu())),
            f"{DEDUP} {name}: the sort's plan {plan.tolist()} differs from "
            "the plain plan")
    sorted_keys, pos = srt.result()
    want_keys, want_pos = torch.sort(kt ^ SIGN, stable=True)
    require(torch.equal(sorted_keys, want_keys) and
            torch.equal(pos.long(), want_pos),
            f"{DEDUP} {name}: the radix sort differs from torch.sort's")
    uniq, inverse = np.unique(keys, return_inverse=True)
    nu = int(got.n_uniq)
    require(nu == uniq.size, f"{DEDUP} {name}: n_uniq {nu} != {uniq.size}")
    host_uniq = got.uniq_keys.cpu().numpy().view(np.uint64)
    require(np.array_equal(host_uniq[:nu], uniq) and not host_uniq[nu:].any(),
            f"{DEDUP} {name}: uniques differ from np.unique's")
    require(np.array_equal(got.inverse.cpu().numpy(), inverse.ravel()),
            f"{DEDUP} {name}: inverse differs from np.unique's")
    require(torch.equal(got.offsets, merge_offsets_plain(got.inverse,
                                                         keys.size)),
            f"{DEDUP} {name}: offsets are not the uniques' boundaries")
    active = [d for d, on in enumerate(plan[:DIGITS].tolist()) if on]
    print(f"kernel check {DEDUP} {name}: N={keys.size} n_uniq={nu} active "
          f"digits {active} bit-exact ok, {DEDUP_REPEATS} launches "
          "identical")
    return got, err


def check_probe(name: str, mirror, keys: torch.Tensor, n_valid=None,
                want_rows=None):
    """K6 vs its plain version on the card, rows and found exactly; with
    ``want_rows`` (numpy) also against the host index's answer."""
    args = (mirror.tab, mirror.mask, mirror.window, keys, n_valid)
    rows, found = device_probe_cuda(*args)
    torch.cuda.synchronize()
    prow, pfound = device_probe_plain(*args)
    err = max(float((rows.long() - prow.long()).abs().max()),
              float((found.long() - pfound.long()).abs().max()))
    require(torch.equal(rows, prow) and torch.equal(found, pfound),
            f"{PROBE} {name}: rows/found differ from the plain version")
    if want_rows is not None:
        require(np.array_equal(rows.cpu().numpy(), want_rows),
                f"{PROBE} {name}: rows differ from the host index's")
    print(f"kernel check {PROBE} {name}: N={keys.shape[0]} slots="
          f"{mirror.tab.shape[0]} found={int(found.sum())} bit-exact ok")
    return err


def dedup_probe_fields(out) -> tuple:
    """``(Dedup, rows, found)`` as one flat tuple, with the field names."""
    return (*out[0], *out[1:]), (*out[0]._fields, "rows", "found")


def check_dedup_probe(name: str, keys: np.ndarray, mirror, want_rows=None):
    """The fused dedup and probe vs its plain version on the card, every
    output exactly, DEDUP_REPEATS launches bit-identical; with
    ``want_rows`` (numpy, by uid) also against the host index's rows.
    Returns the largest error (0: bit-exact)."""
    kt = torch.from_numpy(np.ascontiguousarray(keys, np.uint64).view(
        np.int64)).cuda()
    args = (mirror.tab, mirror.mask, mirror.window)
    got, fields = dedup_probe_fields(device_dedup_probe_cuda(kt, *args))
    torch.cuda.synchronize()
    want, _ = dedup_probe_fields(device_dedup_probe_plain(kt, *args))
    err = 0.0
    for field, a, b in zip(fields, got, want):
        require(a.shape == b.shape and a.dtype == b.dtype,
                f"{DEDUP_PROBE} {name}: {field} shape or type differs")
        if a.numel():
            err = max(err, float((a.long() - b.long()).abs().max()))
        require(torch.equal(a, b),
                f"{DEDUP_PROBE} {name}: {field} differs from the plain "
                "version")
    for _ in range(DEDUP_REPEATS - 1):
        again, _ = dedup_probe_fields(device_dedup_probe_cuda(kt, *args))
        require(all(torch.equal(a, b) for a, b in zip(again, got)),
                f"{DEDUP_PROBE} {name}: two launches differ")
    rows, found = got[-2], got[-1]
    if want_rows is not None:
        require(np.array_equal(rows.cpu().numpy(), want_rows),
                f"{DEDUP_PROBE} {name}: rows differ from the host index's")
    print(f"kernel check {DEDUP_PROBE} {name}: N={keys.size} n_uniq="
          f"{int(got[2])} slots={mirror.tab.shape[0]} found="
          f"{int(found.sum())} bit-exact ok, {DEDUP_REPEATS} launches "
          "identical")
    return err


def colliding_keys(mask: int, home: int, n: int, rng) -> np.ndarray:
    """``n`` distinct non-zero keys whose ``Map64::hash & mask`` is
    ``home``."""
    out = []
    while len(out) < n:
        cand = rng.integers(1, np.iinfo(np.uint64).max, size=1 << 20,
                            dtype=np.uint64)
        out += list(cand[(host_hash(cand) & np.uint32(mask)) == home])
    return np.unique(np.array(out[:n], dtype=np.uint64))


def training_mirror():
    """The host index of the training table, as
    ``DeviceTable.prepopulate(HOT_VOCAB)`` builds it (key k is row k), and
    its mirror on the card (2^24 + 64 slots, 268 MB)."""
    index = NativeIndex()
    index.rebuild(np.concatenate([
        np.array([np.iinfo(np.uint64).max - 1], np.uint64),
        np.arange(1, HOT_VOCAB + 1, dtype=np.uint64)]))
    return index, DeviceIndexMirror(index, "cuda")


def phase_kernel_index(rng, train_keys: np.ndarray, radix_rng):
    """K5, K6 and the fused dedup and probe vs their plain versions at the
    training shape over the 4,194,304-key mirror and at edge cases; K5 and
    the fused pass also on ``radix_cases``, the training batch with one key
    500 times and N keys over all 64 bits (from ``radix_rng``), the fused
    pass also on K6's cases. Returns the largest error (0: bit-exact) of
    each, and the training batch's dedup and mirror and the 64-bit keys for
    timing."""
    index, mirror = training_mirror()
    require(mirror.tab.shape == (index.capacity + index.guard, 4) and
            mirror.window == 64, "mirror layout")
    print(f"kernel check: mirror of {len(index)} keys, "
          f"{mirror.tab.shape[0]} slots, {mirror.memory_bytes()} B on the "
          "card")
    # the training batch: dedup, then its uniques probed (key k is row k)
    dd, dedup_err = check_dedup("training", train_keys)
    want = dd.uniq_keys.cpu().numpy().astype(np.int32)
    probe_err = check_probe("training", mirror, dd.uniq_keys, dd.n_uniq,
                            want)
    fused_err = check_dedup_probe("training", train_keys, mirror, want)
    high = np.uint64(1) << np.uint64(63)
    mixed = rng.integers(0, 1 << 62, size=20000).astype(np.uint64)
    mixed[::3] |= high
    mixed[::7] = 0
    mixed[1::5] = mixed[2::5][:mixed[1::5].size]
    mixed[-1] = np.iinfo(np.uint64).max
    for name, keys in (
            ("high-bit-keys", mixed),
            ("all-padding", np.zeros(TNPAD, np.uint64)),
            ("one-key-repeated", np.full(TNPAD, 12345, np.uint64)),
            ("one-key", np.array([7], np.uint64)),
            ("tile-plus-one", rng.integers(0, 300, size=1025).astype(
                np.uint64)),
            ("ragged", rng.integers(0, 1 << 40, size=5003).astype(
                np.uint64))):
        dedup_err = max(dedup_err, check_dedup(name, keys)[1])
        fused_err = max(fused_err, check_dedup_probe(name, keys, mirror))
    hot = train_keys.copy()
    n_valid = int(np.count_nonzero(hot))
    hot[radix_rng.choice(n_valid, 500, replace=False)] = hot[0]
    keys64 = radix_rng.integers(0, 1 << 64, size=TNPAD, dtype=np.uint64)
    for name, keys in (*radix_cases(radix_rng).items(),
                       ("training-one-key-500-times", hot),
                       ("keys-over-64-bits", keys64)):
        dedup_err = max(dedup_err, check_dedup(name, keys)[1])
        fused_err = max(fused_err, check_dedup_probe(name, keys, mirror))
    # keys absent from the mirror, high keys and key 0 beside present ones
    probe_keys = np.concatenate([
        rng.integers(HOT_VOCAB + 1, 1 << 62, size=4000).astype(np.uint64),
        mixed, rng.integers(1, HOT_VOCAB + 1, size=4000).astype(np.uint64)])
    want = np.where(probe_keys <= HOT_VOCAB, probe_keys, 0).astype(np.int32)
    probe_err = max(probe_err, check_probe(
        "absent-and-present", mirror, torch.from_numpy(
            probe_keys.view(np.int64)).cuda(), want_rows=want))
    uniq = np.unique(probe_keys)
    want = np.zeros(probe_keys.size, np.int32)
    want[:uniq.size] = np.where(uniq <= HOT_VOCAB, uniq, 0)
    fused_err = max(fused_err, check_dedup_probe(
        "absent-and-present", probe_keys, mirror, want))
    # a small map: 64 keys with one home slot (the last lands on slot 63
    # of its window), a run into the guard, high keys, and a 65th
    # colliding key that is absent (its walk ends at the window)
    small = NativeIndex()
    cap = small.capacity
    run = colliding_keys(cap - 1, 100, 65, rng)
    tail = colliding_keys(cap - 1, cap - 3, 10, rng)
    highs = rng.integers(0, 1 << 62, size=50).astype(np.uint64) | high
    present = np.concatenate([run[:64], tail, highs])
    rows, _ = small.lookup(present, True, True, 1)
    require(small.capacity == cap, "the small map grew")
    slots = small.export_slots()
    at = lambda k: int(np.flatnonzero(  # noqa: E731
        (slots[:, 0] == (k >> np.uint64(32))) &
        (slots[:, 1] == (k & np.uint64(0xFFFFFFFF))))[0])
    require(max(at(k) for k in run[:64]) == 100 + 63,
            "the cluster does not reach slot 63 of its window")
    require(max(at(k) for k in tail) >= cap, "no run ends in the guard")
    small_mirror = DeviceIndexMirror(small, "cuda")
    query = np.concatenate([present, run[64:], np.array([0, 5], np.uint64),
                            rng.integers(1, 1 << 63, size=100).astype(
                                np.uint64)])
    want, _ = small.lookup(query, False, True, 0)
    probe_err = max(probe_err, check_probe(
        "cluster-window-and-guard", small_mirror, torch.from_numpy(
            query.view(np.int64)).cuda(), want_rows=np.maximum(
                want, 0).astype(np.int32)))
    uniq = np.unique(query)
    want = np.zeros(query.size, np.int32)
    want[:uniq.size] = np.maximum(small.lookup(uniq, False, True, 0)[0], 0)
    fused_err = max(fused_err, check_dedup_probe(
        "cluster-window-and-guard", query, small_mirror, want))
    return (dedup_err, probe_err, fused_err), {
        "dedup": dd, "mirror": mirror, "keys": train_keys, "keys64": keys64}


# -- phase 3 -----------------------------------------------------------------

def random_deepfm(rng, in_dim: int, hidden=HIDDEN):
    widths = [in_dim, *hidden, 1]
    leaves = []
    for a, b in zip(widths[:-1], widths[1:]):
        leaves.append((rng.normal(size=b) * 0.01).astype(np.float32))
        leaves.append((rng.normal(size=(a, b)) / np.sqrt(a)).astype(
            np.float32))
    leaves.append(np.float32(rng.normal() * 0.1).reshape(()))
    return deepfm_from_flax_leaves(leaves, hidden)


def make_snapshot(rng, file_keys: np.ndarray, rows: int,
                  conf: TableConfig) -> dict:
    need = rows - file_keys.size
    filler = np.unique(rng.integers(1, np.iinfo(np.uint64).max, size=need
                                    + need // 50 + 16, dtype=np.uint64))
    filler = filler[~np.isin(filler, file_keys)]
    require(filler.size >= need, "not enough distinct filler keys")
    keys = rng.permutation(np.concatenate([file_keys, filler[:need]]))
    values = (rng.normal(size=(rows, conf.pull_dim)) * 0.05).astype(
        np.float32)
    show = rng.integers(0, 40, size=rows)
    values[:, 0] = show
    values[:, 1] = np.floor(show * rng.uniform(0, 0.3, size=rows))
    return {"keys": keys, "values": values,
            "state": np.zeros((rows, state_dim(conf)), np.float32),
            "embedx_ok": show >= conf.embedx_threshold}


def reference_scores(pred: CTRPredictor, batch) -> np.ndarray:
    """The predictor's own path with the pool forced to the plain version."""
    with torch.inference_mode():
        emb = pred.table.pull(batch.keys)
        segs = torch.from_numpy(batch.segment_ids).cuda()
        sparse = seqpool_cvm_plain(emb, segs, B, S, True, 2, 0.0)
        dense = torch.from_numpy(batch.dense).cuda()
        p = torch.sigmoid(pred.model(sparse, dense))
    return p.cpu().numpy()[:batch.num_rows]


def phase_serve(rng, seed: int):
    os.makedirs(WORK, exist_ok=True)
    data = os.path.join(WORK, "criteo.txt")
    t0 = time.perf_counter()
    make_synthetic_criteo(data, BATCHES * B, seed=seed)
    batches = list(CriteoReader(B).stream([data]))
    require(len(batches) == BATCHES,
            f"{len(batches)} batches, expected {BATCHES}")
    file_keys = np.unique(np.concatenate([b.keys[:b.num_keys]
                                          for b in batches]))
    table_conf = TableConfig(embedx_dim=8, cvm_offset=3,
                             embedx_threshold=10.0, seed=7)
    snap = make_snapshot(rng, file_keys, TABLE_ROWS, table_conf)
    model = random_deepfm(rng, S * table_conf.pull_dim + 13)
    bundle = save_inference_model(os.path.join(WORK, "bundle"), model, snap,
                                  criteo_feed_config(B), table_conf)
    print(f"serve: data + bundle ({len(batches)} batches, "
          f"{TABLE_ROWS} table rows, {file_keys.size} file keys) "
          f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    pred = CTRPredictor(bundle, device="cuda")
    require(len(pred.table) == TABLE_ROWS, "table row count")
    pred.predict_batch(batches[0])          # warm-up, before the count
    torch.cuda.synchronize()
    print(f"serve: predictor load + warm-up {time.perf_counter() - t0:.2f} s")

    # the main path, counted
    seqpool_cvm_cuda.launches = 0
    scores = [pred.predict_batch(b) for b in batches]
    launches = seqpool_cvm_cuda.launches
    require(launches == len(batches),
            f"seqpool kernel launched {launches} times for {len(batches)} "
            "batches")

    worst = 0.0
    for b, got in zip(batches, scores):
        require(got.shape == (b.num_rows,), f"score shape {got.shape}")
        require(bool(np.isfinite(got).all()) and
                bool(((got >= 0) & (got <= 1)).all()), "scores out of [0, 1]")
        want = reference_scores(pred, b)
        worst = max(worst, float(np.abs(got - want).max()))
    require(worst <= SCORE_ATOL, f"kernel path vs plain pool: {worst}")
    print(f"serve: {len(batches)} batches, {launches} kernel launches, "
          f"max |kernel path - plain pool| = {worst:.3e}")

    cpu = CTRPredictor(bundle, device="cpu")
    cpu_err = max(float(np.abs(cpu.predict_batch(b) - s).max())
                  for b, s in zip(batches[:2], scores[:2]))
    require(cpu_err <= SCORE_ATOL, f"card vs CPU predictor: {cpu_err}")
    print(f"serve: max |card - CPU predictor| over 2 batches = {cpu_err:.3e}")

    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        for b in batches:
            pred.predict_batch(b)
    secs = time.perf_counter() - t0
    n_rows = reps * sum(b.num_rows for b in batches)
    print(f"timing serve: {secs / (reps * len(batches)) * 1e3:.4f} ms/batch, "
          f"{n_rows / secs:.1f} examples/s (B={B}, predict_batch incl. pull, "
          "host copies)")
    device_profile("serve", lambda: [pred.predict_batch(b) for b in batches])
    return launches, bundle, batches


# -- phase 4 -----------------------------------------------------------------

def make_train_batches(rng, n: int):
    """``bench.py``'s batches: B=2048 rows of 24 slots with 1-3 keys each,
    keys uniform over the prepopulated table, random labels."""
    out = []
    for _ in range(n):
        lengths = rng.integers(1, 4, size=TB * TS)
        segs, nk = segment_layout(TB, TS, lengths, TNPAD)
        keys = np.zeros(TNPAD, dtype=np.uint64)
        keys[:nk] = rng.integers(1, HOT_VOCAB, size=nk)
        labels = rng.integers(0, 2, size=TB).astype(np.float32)
        out.append((keys, segs, labels))
    return out


def train_steps(fs, state, batches, step=None):
    """Run ``step`` (``fs`` itself, host prep, by default) over
    ``batches``; returns the new (params, opt, auc) and the losses (device
    scalars)."""
    step = step or fs
    dense = np.zeros((TB, 0), np.float32)
    row_mask = np.ones(TB, np.float32)
    params, opt, auc = state
    losses = []
    for keys, segs, labels in batches:
        cvm = np.stack([np.ones(TB, np.float32), labels], axis=1)
        params, opt, auc, loss, _ = step(params, opt, auc, keys, segs, cvm,
                                         labels, dense, row_mask)
        losses.append(loss)
    return (params, opt, auc), losses


def train_confs():
    """The flagship's table (adagrad), dense optimizer (adam) and the
    uniques' bucket of the host-prep path."""
    return (TableConfig(embedx_dim=8, cvm_offset=3, embedx_threshold=0.0,
                        seed=7),
            TrainerConfig(dense_optimizer="adam", dense_learning_rate=1e-3),
            BucketSpec(min_size=TNPAD, max_size=1 << 18))


def twin_table(table: DeviceTable, device: str, backend: str) -> DeviceTable:
    """A table on ``device`` that starts from ``table``'s arena and rows."""
    conf, _, buckets = train_confs()
    twin = DeviceTable(conf, capacity=1, uniq_buckets=buckets, device=device,
                       backend=backend, index_threads=1)
    twin.load_arena(table.values.cpu().numpy(), table.state.cpu().numpy(),
                    table.row_keys())
    return twin


def touched_rows(table: DeviceTable, batches) -> torch.Tensor:
    touched = np.unique(np.concatenate([
        table.prepare_batch(k, create=False).uniq_rows for k, _, _ in
        batches]))
    return torch.from_numpy(touched[touched > 0].astype(np.int64))


def snapshot_rows(table: DeviceTable, rows: torch.Tensor, model=None):
    """Host copies of ``rows``' values and state (and the dense params)."""
    idx = rows.to(table.device)
    return (table.values[idx].cpu(), table.state[idx].cpu(),
            None if model is None else
            [p.detach().cpu().clone() for p in model.parameters()])


def compare_twin(tag: str, losses, after, twin_losses, twin_after,
                 before, stored: bool = False, layout=None,
                 dense_atol: float = TRAIN_ATOL) -> None:
    """The first steps of the main path vs its twin's (as many as the twin
    took, at least one), from the same init: losses (rtol), the touched
    rows (show/clk exact, the rest and their change from ``before``,
    ``require_change``), the dense params. Rows
    are ``snapshot_rows``'; with the tables' ``layout``, they are compared
    in the canonical float32 layout, a variable table's size codes
    exact, and a low-precision arena's stored values as
    ``stored_steps`` holds them (a value one storage step apart gets
    that step as slack). The dense params within ``dense_atol``."""
    require(1 <= len(twin_losses) <= len(losses),
            f"{tag}: the twin took {len(twin_losses)} steps, the main path "
            f"{len(losses)}")
    twin_losses = [float(x) for x in twin_losses]
    losses = [float(x) for x in losses[:len(twin_losses)]]
    require(np.allclose(losses, twin_losses, rtol=TRAIN_RTOL, atol=0),
            f"{tag}: losses {losses} vs {twin_losses}")
    (vals, st), (cvals, cst), (bvals, bst) = (
        canonical_rows(layout, rows) for rows in (after, twin_after, before))
    require(np.array_equal(vals[:, :2], cvals[:, :2]),
            f"{tag}: show/clk of the touched rows differ")
    slack, note = np.zeros_like(vals), ""
    if layout is not None and layout.variable:
        col = layout.size_col
        require(torch.equal(after[1][:, col], twin_after[1][:, col]),
                f"{tag}: size codes differ")
        require(bool((after[1][:, col] > 0).all()),
                f"{tag}: a touched row is still unclaimed")
    if layout is not None and layout.value_dtype != torch.float32:
        slack, note = stored_steps(tag, layout, after, twin_after, float(
            np.abs(cvals[:, 2:] - bvals[:, 2:]).max()))
    row_err = max(float((np.abs(vals - cvals) - slack).max()),
                  float(np.abs(st - cst).max()))
    params, cparams = after[2], twin_after[2]
    dense_err = max(float((a - b).abs().max())
                    for a, b in zip(params, cparams))
    require(row_err <= TRAIN_ATOL, f"{tag}: table rows {row_err}")
    require(dense_err <= dense_atol, f"{tag}: dense params {dense_err} > "
                                     f"{dense_atol}")
    changes = require_change(tag, (
        ("values", vals[:, 2:], cvals[:, 2:], bvals[:, 2:], slack[:, 2:]),
        ("state", st, cst, bst, 0.0)), stored)
    print(f"{tag} over {len(losses)} steps: losses {losses} vs {twin_losses}, "
          f"{vals.shape[0]} touched rows (show/clk exact{note}, max abs err "
          f"{row_err:.3e} beyond that; their change: {changes}), dense max "
          f"abs err {dense_err:.3e}")


def canonical_rows(layout, rows):
    """``snapshot_rows``' values and state as float32 arrays, in
    ``layout``'s canonical layout (show/clk in values 0, 1, int8
    dequantized, the state without its stat prefix) when one is given."""
    vals, st = rows[0].float().numpy(), rows[1].numpy()
    return (vals, st) if layout is None else \
        layout.canonical_from_arena(vals, st)


def stored_steps(tag: str, layout, after, twin_after, change: float):
    """A low-precision arena's rows as stored, card vs CPU: each int8 code
    or bfloat16 value equal to the CPU's but for at most STEP_SHARE of
    them one storage step apart (float32 sums in another order round the
    other way). An int8 code is one code off, its scale within SCALE_RTOL
    plus TRAIN_DELTA_RTOL of the values' largest ``change`` over 127 (a
    group's max, as a value's change is held); a bfloat16 value is within
    one spacing plus TRAIN_DELTA_RTOL of ``change`` (near 0 a float32
    difference spans many bfloat16 steps). Returns each canonical value's
    slack (its step where the two differ, else 0) and a note for the
    print."""
    (vals, st), (cvals, cst) = after[:2], twin_after[:2]
    near = TRAIN_DELTA_RTOL * change
    if layout.quantized:
        apart = (vals.int() - cvals.int()).abs().numpy()
        so = layout.stat_off
        sc, csc = st[:, 2:so].numpy(), cst[:, 2:so].numpy()
        serr = np.abs(sc - csc)
        require(bool((serr <= SCALE_RTOL * np.abs(csc) +
                      near / layout.QMAX).all()),
                f"{tag}: scales beyond rtol {SCALE_RTOL}: largest "
                f"difference {float(serr.max())} (relative "
                f"{float((serr / np.maximum(np.abs(csc), 1e-30)).max())})")
        step = np.zeros(apart.shape, np.float32)
        for gi, (start, width, _) in enumerate(layout.groups):
            step[:, start:start + width] = np.maximum(sc, csc)[:, gi:gi + 1]
        far = apart > 1
        what = f"int8 scales max abs err {float(serr.max()):.3e}, codes"
    else:
        a, b = vals.float().numpy(), cvals.float().numpy()
        apart = a != b
        step = BF16_SPACING * np.maximum(np.abs(a), np.abs(b))
        far = np.abs(a - b) > step + near
        what = "bfloat16 values"
    n_apart = int((apart > 0).sum())
    require(not far.any() and n_apart <= STEP_SHARE * apart.size,
            f"{tag}: {n_apart} of {apart.size} stored values differ (at "
            f"most {STEP_SHARE} of them by one step), {int(far.sum())} of "
            "them by more")
    return (np.where(apart > 0, step, 0.0).astype(np.float32),
            f"; {what} equal but {n_apart} of {apart.size} one step apart")


def require_change(tag: str, parts, stored: bool = False) -> str:
    """For each (what, got, want, init, slack) of host float32 arrays: the
    steps' change ``got - init`` within TRAIN_DELTA_RTOL of the largest
    entry of ``want - init``, which must be > 0, plus ``slack`` (a number
    or an array of got's shape). With ``stored``, plus one float32
    spacing of the largest value in ``want``: the least step a stored row
    can take, where the change is below a thousand of them (the examples'
    rows near 0.01, spacing 9.3e-10, change by 5e-8 to 3e-5 in 2 steps; a
    state that starts at 0 keeps its full precision). Returns the
    errors, for a print."""
    changes = []
    for what, got, want, init, slack in parts:
        scale = float(np.abs(want - init).max())
        derr = np.abs((got - init) - (want - init)) - slack
        spacing = float(np.spacing(np.abs(want).max())) if stored else 0.0
        require(scale > 0, f"{tag}: the steps left the touched rows' {what} "
                           "unchanged")
        require(float(derr.max()) <= TRAIN_DELTA_RTOL * scale + spacing,
                f"{tag}: change of the touched rows' {what} "
                f"{float(derr.max())} > {TRAIN_DELTA_RTOL} * {scale} + "
                f"{spacing} beyond its slack")
        changes.append(f"{what} max abs err {float(derr.max()):.3e} of a "
                       f"largest change {scale:.3e}" +
                       (f" (+ spacing {spacing:.3e})" if stored else ""))
    return ", ".join(changes)


def run_counted(fs, state, batches, wrappers, step=None):
    """The main path, counted: every wrapper's count set to 0, the steps,
    the counts read. The first CPU_STEPS steps' touched rows and dense
    params are kept for the twins. Returns (state, losses, launches,
    touched rows, their rows after CPU_STEPS steps)."""
    for w in wrappers:
        w.launches = 0
    state, losses = train_steps(fs, state, batches[:CPU_STEPS], step)
    touched = touched_rows(fs.table, batches[:CPU_STEPS])
    after = snapshot_rows(fs.table, touched, state[0])
    state, more = train_steps(fs, state, batches[CPU_STEPS:], step)
    launches = {w.__name__: w.launches for w in wrappers}
    losses = [float(x) for x in losses + more]
    require(all(np.isfinite(losses)), f"train: non-finite loss {losses}")
    require(not bool(fs.bad_flag), "train: the numeric sentinel tripped")
    return state, losses, launches, touched, after


def run_twin(tag: str, table: DeviceTable, model, device_prep: bool,
             batches, touched, losses, after) -> None:
    """CPU_STEPS steps of a twin from the same init, held against the main
    path's."""
    _, tconf, _ = train_confs()
    before = snapshot_rows(table, touched)
    tfs = FusedTrainStep(model, table, tconf, TB, TS,
                         device_prep=device_prep)
    _, twin_losses = train_steps(tfs, (*tfs.init(), tfs.init_auc_state()),
                                 batches[:CPU_STEPS],
                                 tfs.step_device if device_prep else None)
    compare_twin(tag, losses, after, twin_losses,
                 snapshot_rows(table, touched, model), before)


def key_rows(table: DeviceTable, keys: np.ndarray) -> torch.Tensor:
    """The rows of ``keys`` (sorted, unique, every one in the table)."""
    rows, _ = table._index.lookup(keys, False, True, 0)
    require(bool((rows > 0).all()), "a key has no row")
    return torch.from_numpy(rows.astype(np.int64))


def time_steps(fs, state, batches, step=None):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = train_steps(fs, state, batches, step)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return state, secs / len(batches) * 1e3, TB * len(batches) / secs


def with_new_keys(rng, batches, fresh: int, per_20: int = 1):
    """The batches' keys with ``per_20`` twentieths (5% by default) of each
    batch's replaced by keys new to the table, from ``fresh`` on."""
    out = []
    for keys, _, _ in batches:
        keys = keys.copy()
        nk = int((keys > 0).sum())
        pick = rng.choice(nk, size=nk * per_20 // 20, replace=False)
        keys[pick] = np.arange(fresh, fresh + pick.size, dtype=np.uint64)
        fresh += pick.size
        out.append(keys)
    return out


def time_inserts(tag: str, fn, key_sets) -> float:
    """``fn(keys)`` for batches with 5% new keys: the first call (which
    grows the arena) and the mean of the rest, in ms."""
    ms = []
    for keys in key_sets:
        t0 = time.perf_counter()
        fn(keys)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    print(f"timing {tag} with 5% new keys: {ms[0]:.4f} ms the first batch "
          f"(the arena grows), then {np.mean(ms[1:]):.4f} ms/batch over "
          f"{len(ms) - 1} batches")
    return float(np.mean(ms[1:]))


TRAIN_WRAPPERS = (seqpool_cvm_cuda, seqpool_cvm_grad_cuda, sparse_push_cuda,
                  merge_offsets)


def phase_train(rng) -> dict:
    """Host prep over the numpy index, as in earlier slices."""
    conf, tconf, buckets = train_confs()
    t0 = time.perf_counter()
    table = DeviceTable(conf, capacity=HOT_VOCAB + 1, uniq_buckets=buckets,
                        device="cuda", backend="numpy")
    table.prepopulate(HOT_VOCAB)
    model = random_deepfm(rng, TS * conf.pull_dim)
    batches = make_train_batches(rng, TRAIN_STEPS)
    # the CPU twin starts from the same arena and weights, and so does the
    # device-prep phase
    cpu_table = twin_table(table, "cpu", "numpy")
    cpu_model = copy.deepcopy(model)
    init = (copy.deepcopy(model), batches)
    fs = FusedTrainStep(model, table, tconf, TB, TS)
    state = (*fs.init(), fs.init_auc_state())
    torch.cuda.synchronize()
    print(f"train: table of {len(table)} rows ({table.memory_bytes()} B on "
          f"the card, numpy index) + model + {len(batches)} batches + CPU "
          f"twin {time.perf_counter() - t0:.2f} s")

    state, losses, launches, touched, after = run_counted(
        fs, state, batches, TRAIN_WRAPPERS)
    for name, n in launches.items():
        require(n == TRAIN_STEPS, f"train: {name} launched {n} times in "
                                  f"{TRAIN_STEPS} steps")
    print(f"train: {TRAIN_STEPS} steps, launches {launches}, losses "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}")
    # the same 2 steps on the CPU, whose table still holds the initial rows
    run_twin("train: card vs CPU", cpu_table, cpu_model, False, batches,
             touched, losses, after)

    t0 = time.perf_counter()
    for keys, _, _ in batches:
        table.prepare_batch(keys, create=False)
    prep_ms = (time.perf_counter() - t0) / len(batches) * 1e3
    state, ms, eps = time_steps(fs, state, batches)
    print(f"timing train: {ms:.4f} ms/step, {eps:.1f} examples/s (B={TB}, "
          f"FusedTrainStep.__call__ over the numpy index incl. host "
          f"prepare_batch {prep_ms:.4f} ms/step and uploads)")
    device_profile("train, 4 steps",
                   lambda: train_steps(fs, state, batches[:4]),
                   kernels=(KERNEL, PUSH))
    # each batch that inserts keys copies the whole sorted key and row
    # arrays
    new_ms = time_inserts("train: prepare_batch (numpy index)",
                          table.prepare_batch,
                          with_new_keys(rng, batches[:5], HOT_VOCAB + 1))
    return {"launches": launches, "ms_per_step": ms, "examples_per_s": eps,
            "prepare_batch_ms": prep_ms,
            "prepare_batch_new_keys_ms": new_ms}, init


# device prep launches K5's sort (counted by dedup_sort_cuda) and the fused
# numbering and probe (device_dedup_probe_cuda); K5 whole and K6 alone never
DEVICE_PREP_WRAPPERS = TRAIN_WRAPPERS + (
    dedup_sort_cuda, device_dedup_probe_cuda, device_dedup_cuda,
    device_probe_cuda)
DEVICE_PREP_IDLE = (merge_offsets, device_dedup_cuda, device_probe_cuda)
# K6's kernel in a profile's names, not the fused pass's
ALONE_PROBE = re.compile(r"(?<!\w)probe_kernel")


def phase_train_device(rng, init) -> dict:
    """The reference's flagship engine: device prep ("ensure") over the
    native index and its 268 MB mirror, from the host-prep phase's initial
    weights and batches (and, seeded alike, its arena). Twins: host prep on
    the card over the native index, device prep on the CPU."""
    conf, tconf, buckets = train_confs()
    t0 = time.perf_counter()
    table = DeviceTable(conf, capacity=HOT_VOCAB + 1, uniq_buckets=buckets,
                        device="cuda", backend="native", index_threads=1)
    table.prepopulate(HOT_VOCAB)
    model, batches = copy.deepcopy(init[0]), init[1]
    host_table = twin_table(table, "cuda", "native")
    cpu_table = twin_table(table, "cpu", "native")
    host_model, cpu_model = copy.deepcopy(model), copy.deepcopy(model)
    fs = FusedTrainStep(model, table, tconf, TB, TS, device_prep=True)
    state = (*fs.init(), fs.init_auc_state())
    torch.cuda.synchronize()
    print(f"train device-prep: table of {len(table)} rows "
          f"({table.memory_bytes()} B) + index mirror of "
          f"{table.mirror.tab.shape[0]} slots ({table.mirror.memory_bytes()} "
          f"B) on the card + twins {time.perf_counter() - t0:.2f} s")

    state, losses, launches, touched, after = run_counted(
        fs, state, batches, DEVICE_PREP_WRAPPERS, fs.step_device)
    idle = {w.__name__ for w in DEVICE_PREP_IDLE}
    for name, n in launches.items():
        want = 0 if name in idle else TRAIN_STEPS
        require(n == want, f"train device-prep: {name} launched {n} times "
                           f"in {TRAIN_STEPS} steps, expected {want}")
    print(f"train device-prep: {TRAIN_STEPS} steps, launches {launches}, "
          f"losses {losses[0]:.6f} -> {losses[-1]:.6f}")
    run_twin("train device-prep vs host-prep on the card", host_table,
             host_model, False, batches, touched, losses, after)
    run_twin("train device-prep: card vs CPU", cpu_table, cpu_model, True,
             batches, touched, losses, after)
    del cpu_table, cpu_model

    state, ms, eps = time_steps(fs, state, batches, fs.step_device)
    print(f"timing train device-prep: {ms:.4f} ms/step, {eps:.1f} "
          f"examples/s (B={TB}, FusedTrainStep.step_device incl. host "
          f"ensure_keys and uploads)")
    by_name = device_profile("train device-prep, 4 steps",
                             lambda: train_steps(fs, state, batches[:4],
                                                 fs.step_device),
                             kernels=(KERNEL, PUSH, "radix", "dedup",
                                      "probe"))
    if by_name:
        require(any("dedup_write_probe_kernel" in k for k in by_name) and
                not any(ALONE_PROBE.search(k) for k in by_name),
                "train device-prep: the profile does not show the fused "
                "pass in place of probe_kernel")
    host_fs = FusedTrainStep(host_model, host_table, tconf, TB, TS)
    host_state = (*host_fs.init(), host_fs.init_auc_state())
    t0 = time.perf_counter()
    for keys, _, _ in batches:
        host_table.prepare_batch(keys, create=False)
    prep_ms = (time.perf_counter() - t0) / len(batches) * 1e3
    _, host_ms, host_eps = time_steps(host_fs, host_state, batches)
    print(f"timing train host-prep, native index: {host_ms:.4f} ms/step, "
          f"{host_eps:.1f} examples/s (FusedTrainStep.__call__ incl. host "
          f"prepare_batch {prep_ms:.4f} ms/step)")

    # 5% new keys: the host inserts them into its index and the mirror
    fresh = with_new_keys(rng, batches[:5], HOT_VOCAB + 1)
    ensure_ms = time_inserts("train device-prep: ensure_keys",
                             table.ensure_keys, fresh)
    # each batch's new keys looked up in the mirror: K6 alone
    device_probe_cuda.launches = 0
    for keys in fresh:
        new = np.unique(keys[keys > HOT_VOCAB])
        rows, found = table.mirror.probe(torch.from_numpy(new.view(
            np.int64)).cuda())
        want, _ = table._index.lookup(new, False, True, 0)
        require(bool(found.all()) and
                np.array_equal(rows.cpu().numpy(), want),
                "train device-prep: the mirror lacks inserted keys")
    probe_launches = device_probe_cuda.launches
    require(probe_launches == len(fresh),
            f"mirror probe: {probe_launches} launches for {len(fresh)} "
            "batches")
    new_prep_ms = time_inserts(
        "train host-prep: prepare_batch (native index)",
        host_table.prepare_batch,
        with_new_keys(rng, batches[:5], HOT_VOCAB + 1))
    return {"launches": launches, "ms_per_step": ms, "examples_per_s": eps,
            "mirror_probe_launches": probe_launches,
            "host_prep_native_ms_per_step": host_ms,
            "host_prep_native_examples_per_s": host_eps,
            "prepare_batch_native_ms": prep_ms,
            "ensure_keys_new_keys_ms": ensure_ms,
            "prepare_batch_native_new_keys_ms": new_prep_ms}


# -- the trainer entry -------------------------------------------------------

TRAINER_FILES = 2            # MultiSlot files of the trainer's pass
TRAINER_FILE_BATCHES = 16    # batches of TB rows in each file: a run
TRAINER_HEADROOM = 1 << 17   # arena rows beyond the prepopulated ones


def slot_feed_conf(slots: int, batch: int, dense_dim: int = 0):
    """A MultiSlot feed: a label, ``slots`` sparse slots and a dense slot
    of ``dense_dim`` values (none at 0)."""
    conf = [SlotConfig("label", type="float", is_dense=True, dim=1)]
    conf += [SlotConfig(f"s{i}") for i in range(slots)]
    if dense_dim:
        conf.append(SlotConfig("dense", type="float", is_dense=True,
                               dim=dense_dim))
    return DataFeedConfig(slots=conf, batch_size=batch, label_slot="label")


def trainer_feed_conf() -> DataFeedConfig:
    """The training shape as a MultiSlot feed: a label and TS sparse
    slots, batch TB."""
    return slot_feed_conf(TS, TB)


def write_trainer_file(rng, path: str, fresh: int) -> int:
    """TRAINER_FILE_BATCHES * TB MultiSlot lines of TS slots with 1-3 keys
    each, keys uniform over the prepopulated rows; with ``fresh`` > 0, 5%
    of the keys are replaced by new ones from ``fresh`` on. Returns the
    count of new keys."""
    rows = TRAINER_FILE_BATCHES * TB
    lengths = rng.integers(1, 4, size=(rows, TS))
    keys = rng.integers(1, HOT_VOCAB, size=int(lengths.sum()),
                        dtype=np.uint64)
    n_new = 0
    if fresh:
        pick = rng.choice(keys.size, size=keys.size // 20, replace=False)
        keys[pick] = np.arange(fresh, fresh + pick.size, dtype=np.uint64)
        n_new = pick.size
    labels = rng.integers(0, 2, size=rows)
    write_slot_lines(path, lengths, keys, labels)
    return n_new


def write_slot_lines(path: str, lengths, keys, labels, dense=None) -> None:
    """MultiSlot lines: a label, then a slot of ``lengths[r, j]`` keys for
    each column of ``lengths``, taken from ``keys`` in order, then the
    row's ``dense`` values if given."""
    toks = keys.astype(str)
    lens = lengths.astype(str)
    pos = 0
    with open(path, "w") as f:
        for r in range(lengths.shape[0]):
            parts = ["1", str(labels[r])]
            for j in range(lengths.shape[1]):
                n = int(lengths[r, j])
                parts.append(lens[r, j])
                parts.extend(toks[pos:pos + n])
                pos += n
            if dense is not None:
                parts.append(str(dense.shape[1]))
                parts.extend(repr(float(x)) for x in dense[r])
            f.write(" ".join(parts) + "\n")


def hand_loop(fs, state, batches):
    """``FusedTrainStep.step_device`` over assembled ``CsrBatch``es, as
    the trainer calls it; returns the new state and the losses (device
    scalars)."""
    params, opt, auc = state
    losses = []
    for b in batches:
        cvm = np.stack([np.ones(TB, np.float32), b.labels], axis=1)
        params, opt, auc, loss, _ = fs.step_device(
            params, opt, auc, b.keys, b.segment_ids, cvm, b.labels, b.dense,
            b.row_mask())
        losses.append(loss)
    return (params, opt, auc), losses


def eager_run_loop(fs, state, batches):
    """``FusedTrainStep.train_stream``'s device-prep runs without their
    graph, as the run path ran them before: for each run of ``DEV_CHUNK``
    same-shape batches, one ``ensure_keys`` over its keys (in "deferred"
    mode one lagged poll of the miss ring), one upload, then
    ``step_device_tensors`` over each batch's views; a shorter run
    through ``step_device``; at the end the ring's drain
    (``train_stream``'s ``final_poll``). ``batches`` are
    ``train_stream``'s (keys, segment_ids, cvm_in, labels, dense,
    row_mask) tuples. Returns the new state and the losses (device
    scalars)."""
    params, opt, auc = state
    losses = []
    it, pending = iter(batches), None
    while True:
        run, pending = collect_same_shape_run(it, pending, fs.DEV_CHUNK)
        if not run:
            break
        if len(run) < fs.DEV_CHUNK:
            for args in run:
                params, opt, auc, loss, _ = fs.step_device(params, opt, auc,
                                                           *args)
                losses.append(loss)
            continue
        if fs.insert_mode == "deferred":
            fs.table.poll_misses_async()
        else:
            fs.table.ensure_keys(np.concatenate([a[0] for a in run]))
        floats = [fs._float_block(*a[2:]) for a in run]
        keys, segs, pf = fs._to_device([
            [np.ascontiguousarray(a[0], np.uint64).view(np.int64)
             for a in run],
            [np.asarray(a[1], np.int32) for a in run],
            [f for f, _ in floats]])
        for j in range(len(run)):
            params, opt, auc, loss, _ = fs.step_device_tensors(
                params, opt, auc, keys[j], segs[j],
                *fs._split_floats(pf[j], floats[0][1]))
            losses.append(loss)
    fs.table.poll_misses()
    return (params, opt, auc), losses


def require_same_training(tag: str, a, b) -> None:
    """Two device-prep worlds ((table, params, opt_state, auc_state) each)
    bit for bit: every row by key, the dense params, every tensor of the
    optimizer state, and the AUC state (``auc`` None: not compared)."""
    (ta, pa, oa, aa), (tb, pb, ob, ab) = a, b
    ka, va, sa = rows_by_key(ta)
    kb, vb, sb = rows_by_key(tb)
    require(np.array_equal(ka, kb), f"{tag}: the tables hold other keys")
    require(torch.equal(va, vb) and torch.equal(sa, sb),
            f"{tag}: rows by key differ")
    require_same_dense(tag, (pa, oa), (pb, ob))
    if aa is not None:
        require(all(torch.equal(aa[f], ab[f]) for f in aa),
                f"{tag}: the AUC states differ")


def require_same_dense(tag: str, a, b) -> None:
    """Two dense states ((params, opt_state) each) bit for bit: the
    params and every tensor of the optimizer state."""
    (pa, oa), (pb, ob) = a, b
    require(all(torch.equal(x, y) for x, y in zip(pa.parameters(),
                                                   pb.parameters())),
            f"{tag}: the dense params differ")
    sa, sb = list(state_tensors(oa)), list(state_tensors(ob))
    require(len(sa) == len(sb) and
            all(torch.equal(x, y) for x, y in zip(sa, sb)),
            f"{tag}: the optimizer states (adam's count, mu and nu; lars's "
            "trace; gradient merging's steps and sums) differ")


def reader_tuples(batches):
    """``FastSlotReader.stream``'s tuples of assembled ``CsrBatch``es."""
    return [(b.keys, b.segment_ids,
             np.stack([np.ones(b.batch_size, np.float32), b.labels], axis=1),
             b.labels, b.dense, b.row_mask()) for b in batches]


def rows_by_key(table: DeviceTable):
    """Every used row's key, value and state, in ascending key order."""
    keys = table.row_keys()
    order = np.argsort(keys[1:]) + 1
    idx = torch.from_numpy(order).to(table.device)
    return keys[order], table.values[idx], table.state[idx]


def delta_by_key(table: DeviceTable):
    """``snapshot_delta`` (which clears the dirty marks) in ascending key
    order: keys, values, state."""
    snap = table.snapshot_delta()
    order = np.argsort(snap["keys"])
    return tuple(snap[k][order] for k in ("keys", "values", "state"))


def dirty_keys(table: DeviceTable) -> np.ndarray:
    """The keys of the rows ``fetch_dirty_rows`` gives, ascending."""
    return np.sort(table.row_keys()[table.fetch_dirty_rows()])


def counted(fn, expect: dict, tag: str, wrappers=None):
    """``fn()`` with every wrapper's count (``DEVICE_PREP_WRAPPERS``'
    unless ``wrappers`` is given) set to 0 just before it and read just
    after; each count must equal ``expect``'s (0 where it has none).
    Returns (seconds, result, launches)."""
    wrappers = wrappers or DEVICE_PREP_WRAPPERS
    for w in wrappers:
        w.launches = 0
    secs, out = timed_secs(fn)
    launches = {w.__name__: w.launches for w in wrappers}
    for name, n in launches.items():
        require(n == expect.get(name, 0),
                f"{tag}: {name} launched {n} times, expected "
                f"{expect.get(name, 0)}")
    return secs, out, launches


def count_launches(fn, n_batches: int, tag: str):
    """``fn()`` with every device-prep wrapper's count set to 0 just before
    it and read just after; each kernel of the path must have launched
    once a batch, the idle ones never. Returns (seconds, result,
    launches)."""
    idle = {w.__name__ for w in DEVICE_PREP_IDLE}
    return counted(fn, {w.__name__: n_batches for w in DEVICE_PREP_WRAPPERS
                        if w.__name__ not in idle}, tag)


def timed_secs(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def phase_trainer(rng) -> dict:
    """The reference's entry point: MultiSlot files -> ``SlotDataset`` ->
    ``CTRTrainer.train_from_dataset`` (device prep over the native index
    and its mirror, "ensure" mode) -> ``evaluate``. Checked bit for bit
    against a hand loop of ``step_device`` over the same batches on a twin
    table from the same arena and weights; then both timed in turns."""
    conf, tconf, buckets = train_confs()
    feed = trainer_feed_conf()
    t0 = time.perf_counter()
    os.makedirs(WORK, exist_ok=True)
    files = [os.path.join(WORK, f"trainer-part-{i}")
             for i in range(TRAINER_FILES)]
    n_new = [write_trainer_file(rng, path, i * (HOT_VOCAB + 1))
             for i, path in enumerate(files)]
    write_s = time.perf_counter() - t0
    ds = SlotDataset(feed, buckets=BucketSpec(min_size=TNPAD,
                                              max_size=1 << 18))
    ds.set_filelist(files)
    load_s, _ = timed_secs(ds.load_into_memory)
    n_batches = ds.num_instances() // TB
    require(n_batches == TRAINER_FILES * TRAINER_FILE_BATCHES,
            f"trainer: {ds.num_instances()} records loaded")
    asm_s, batches = timed_secs(lambda: list(ds.batches()))
    asm_ms = asm_s / n_batches * 1e3
    require(all(b.padded_keys == TNPAD and b.num_rows == TB
                for b in batches), "trainer: batches not at the training "
                                   "shape")
    print(f"trainer: wrote {TRAINER_FILES} files of "
          f"{TRAINER_FILE_BATCHES * TB} lines ({n_new[-1]} new keys in the "
          f"last) {write_s:.2f} s; load_into_memory {load_s:.4f} s; "
          f"BatchAssembler {asm_ms:.4f} ms/batch over {n_batches} batches "
          f"of {min(b.num_keys for b in batches)}-"
          f"{max(b.num_keys for b in batches)} keys")

    table = DeviceTable(conf, capacity=HOT_VOCAB + 1 + TRAINER_HEADROOM,
                        uniq_buckets=buckets, device="cuda",
                        backend="native", index_threads=1)
    table.prepopulate(HOT_VOCAB)
    model = random_deepfm(rng, TS * conf.pull_dim)
    twin = twin_table(table, "cuda", "native")
    twin_fs = FusedTrainStep(copy.deepcopy(model), twin, tconf, TB, TS,
                             device_prep=True)
    twin_state = (*twin_fs.init(), twin_fs.init_auc_state())
    # the run loop without graphs, the file pass's twin
    run_fs = FusedTrainStep(copy.deepcopy(model),
                            twin_table(table, "cuda", "native"), tconf, TB,
                            TS, device_prep=True)
    run_state = (*run_fs.init(), run_fs.init_auc_state())
    # the file entry's trainer: a twin of the same arena and weights
    files_trainer = CTRTrainer(
        copy.deepcopy(model), feed, conf, tconf,
        table=twin_table(table, "cuda", "native"),
        buckets=BucketSpec(min_size=TNPAD, max_size=1 << 18))
    trainer = CTRTrainer(model, feed, conf, tconf, table=table)
    require(trainer.step.device_prep, "trainer: device prep resolved off "
                                      "over a one-thread native index")

    losses = []
    pass_s, metrics, launches = count_launches(
        lambda: trainer.train_from_dataset(
            ds, fetch_handler=lambda s, loss, p: losses.append(loss)),
        n_batches, "trainer")
    require(np.isfinite(losses).all() and not bool(trainer.step.bad_flag),
            f"trainer: losses {losses}")
    require(metrics["ins_num"] == n_batches * TB,
            f"trainer: ins_num {metrics['ins_num']}")
    print(f"trainer: one pass of {n_batches} batches, launches {launches}, "
          f"losses {losses[0]:.6f} -> {losses[-1]:.6f}, auc "
          f"{metrics['auc']:.6f}; {pass_s / n_batches * 1e3:.4f} ms/step "
          f"with the fetch handler (a sync a batch)")

    twin_state, twin_losses = hand_loop(twin_fs, twin_state, batches)
    calc = AucCalculator()
    calc.absorb(twin_state[2])
    twin_losses = [float(x) for x in twin_losses]
    require(losses == twin_losses,
            f"trainer vs hand loop: losses {losses} vs {twin_losses}")
    require(metrics == calc.compute(), f"trainer vs hand loop: metrics "
                                       f"{metrics} vs {calc.compute()}")
    require(len(table) == len(twin) == HOT_VOCAB + sum(n_new) and
            np.array_equal(table.row_keys(), twin.row_keys()),
            "trainer vs hand loop: the tables hold other keys")
    require(torch.equal(table.values, twin.values) and
            torch.equal(table.state, twin.state),
            "trainer vs hand loop: the arenas differ")
    require(all(torch.equal(a, b) for a, b in zip(
        trainer.params.parameters(), twin_state[0].parameters())),
        "trainer vs hand loop: the dense params differ")
    print(f"trainer vs hand loop of step_device (twin table): losses, "
          f"pass metrics, the whole arena ({len(table)} rows) and the dense "
          f"params bit for bit")

    # the file entry over the same files: the tokenizer, FastSlotReader's
    # batches and train_stream's runs of 16, held against the dataset
    # pass by key (its runs number new rows otherwise)
    files_s, files_metrics, files_launches = count_launches(
        lambda: files_trainer.train_from_files(files), n_batches,
        "trainer files")
    require(files_metrics == metrics, f"trainer files vs dataset: metrics "
                                      f"{files_metrics} vs {metrics}")
    fkeys, fvals, fstate = rows_by_key(files_trainer.table)
    dkeys, dvals, dstate = rows_by_key(table)
    require(np.array_equal(fkeys, dkeys),
            "trainer files vs dataset: the tables hold other keys")
    require(torch.equal(fvals, dvals) and torch.equal(fstate, dstate),
            "trainer files vs dataset: rows by key differ")
    require(all(torch.equal(a, b) for a, b in zip(
        files_trainer.params.parameters(), trainer.params.parameters())),
        "trainer files vs dataset: the dense params differ")
    # the dirty rows too: the file pass marked its rows through the run's
    # eager steps and its graph replay, the dataset pass through eager
    # steps; snapshot_delta of each is the same by key, bit for bit
    fdelta, ddelta = (delta_by_key(t) for t in (files_trainer.table, table))
    require(all(np.array_equal(a, b) for a, b in zip(fdelta, ddelta)),
            "trainer files vs dataset: snapshot_delta differs by key")
    require(fdelta[0].size == np.unique(np.concatenate(
        [b.keys for b in batches])).size - 1,
        f"trainer: the delta holds {fdelta[0].size} keys, not every key the "
        "batches touched")
    print(f"trainer files: train_from_files over the same {TRAINER_FILES} "
          f"files, launches {files_launches}; vs train_from_dataset: pass "
          f"metrics, all {fkeys.size} rows by key and the dense params bit "
          f"for bit, and snapshot_delta ({fdelta[0].size} rows: every key "
          f"the batches touched) by key bit for bit; "
          f"{files_s / n_batches * 1e3:.4f} ms/step (first pass, builds "
          f"the tokenizer if needed)")
    # its first run went eagerly (the warm-up), its second was captured
    # and replayed; the run loop without graphs over the same batches, on
    # a twin from the same arena and weights, equals it bit for bit
    fs = files_trainer.step
    graphs = fs.run_graphs
    runs = n_batches // fs.DEV_CHUNK
    require((graphs.captures, graphs.replays) == (1, runs - 1),
            f"trainer files: {graphs.captures} captures and "
            f"{graphs.replays} replays over {runs} runs")
    print(f"trainer files: run graphs: {graphs.captures} capture "
          f"({graphs.capture_ms[0]:.2f} ms, the capture and the graph's "
          f"instantiation), {graphs.replays} replay over {runs} runs of "
          f"{fs.DEV_CHUNK}; the graph's launches a replay "
          f"{graphs.graphs[next(iter(graphs.graphs))].launches.by_name()}")
    stream = reader_tuples(batches)
    run_state, _ = eager_run_loop(run_fs, run_state, stream)
    require_same_training(
        "trainer files (graphs) vs the eager run loop",
        (files_trainer.table, files_trainer.params, files_trainer.opt_state,
         None), (run_fs.table, *run_state[:2], None))
    calc = AucCalculator()
    calc.absorb(run_state[2])
    require(calc.compute() == files_metrics,
            f"trainer files vs the eager run loop: metrics "
            f"{files_metrics} vs {calc.compute()}")
    print(f"trainer files (run graphs) vs the eager run loop (twin): pass "
          f"metrics, all {fkeys.size} rows by key, the dense params and "
          f"adam's count ({int(run_state[1]['count'])}), mu and nu bit for "
          f"bit")

    seqpool_cvm_cuda.launches = 0
    ev = trainer.evaluate(ds)
    eval_launches = seqpool_cvm_cuda.launches
    require(eval_launches == n_batches, f"evaluate: the forward launched "
                                        f"{eval_launches} times")
    require(ev["ins_num"] == n_batches * TB and 0.0 <= ev["auc"] <= 1.0,
            f"evaluate: {ev}")
    print(f"trainer: evaluate over {n_batches} batches, forward launches "
          f"{eval_launches}, auc {ev['auc']:.6f}")

    # the step paths over the same pre-assembled batches, in turns: the
    # run graphs (train_stream of the file trainer's step: both runs
    # replay), the eager run loop, the hand loop of step_device
    fstate = (files_trainer.params, files_trainer.opt_state,
              files_trainer.auc_state)
    paths = {"graph": [], "eager": [], "hand": []}
    for who in ("graph", "eager", "hand", "hand", "eager", "graph"):
        if who == "graph":
            secs, _ = timed_secs(lambda: fs.train_stream(*fstate,
                                                         iter(stream)))
        elif who == "eager":
            secs, (run_state, _) = timed_secs(
                lambda: eager_run_loop(run_fs, run_state, stream))
        else:
            secs, (twin_state, _) = timed_secs(
                lambda: hand_loop(twin_fs, twin_state, batches))
        paths[who].append(secs / n_batches * 1e3)
    require(graphs.captures == 1, f"trainer: {graphs.captures} captures")
    path_ms = {k: float(np.mean(v)) for k, v in paths.items()}
    print(f"timing trainer step paths over the {n_batches} assembled "
          f"batches, in turns (ms/step; incl. ensure_keys and uploads): "
          f"run graphs {paths['graph']} ({TB * 1e3 / path_ms['graph']:.1f} "
          f"examples/s); eager run loop {paths['eager']} "
          f"({TB * 1e3 / path_ms['eager']:.1f}); hand loop of step_device "
          f"{paths['hand']} ({TB * 1e3 / path_ms['hand']:.1f}); "
          f"{graphs.replays} replays so far")
    kernels = (KERNEL, PUSH, "radix", "dedup")
    device_profile(f"trainer run graphs, {n_batches} batches (replays)",
                   lambda: fs.train_stream(*fstate, iter(stream)), kernels)
    device_profile(f"trainer eager run loop, {n_batches} batches",
                   lambda: eager_run_loop(run_fs, run_state, stream),
                   kernels)
    # the timing passes' counts out of the file trainer's AUC state
    reset_auc_state_(files_trainer.auc_state)

    # the entry point (assembly, step, drain, metrics) and the hand loop
    # over the pre-assembled batches, in turns
    times = {"trainer": [], "hand": []}
    for who in ("trainer", "hand", "hand", "trainer"):
        if who == "trainer":
            trainer.reset_metrics()
            secs, _ = timed_secs(lambda: trainer.train_from_dataset(ds))
        else:
            secs, (twin_state, _) = timed_secs(
                lambda: hand_loop(twin_fs, twin_state, batches))
        times[who].append(secs / n_batches * 1e3)
    ms = float(np.mean(times["trainer"]))
    hand_ms = float(np.mean(times["hand"]))
    print(f"timing trainer: train_from_dataset {times['trainer']} ms/step "
          f"({TB * 1e3 / ms:.1f} examples/s); hand loop of step_device "
          f"{times['hand']} ms/step ({TB * 1e3 / hand_ms:.1f} examples/s); "
          f"BatchAssembler {asm_ms:.4f} ms/batch; load_into_memory "
          f"{load_s:.4f} s for {TRAINER_FILES} files")
    print(f"trainer SpanTimer (last pass): {trainer.timer.report()}")
    # the two entries in turns: (dataset, files, files, dataset) twice
    entry = {"dataset": [], "files": []}
    for who in ("dataset", "files", "files", "dataset") * 2:
        tr = trainer if who == "dataset" else files_trainer
        tr.reset_metrics()
        secs, _ = timed_secs(
            (lambda: trainer.train_from_dataset(ds)) if who == "dataset"
            else (lambda: files_trainer.train_from_files(files)))
        entry[who].append(secs / n_batches * 1e3)
    files_ms = float(np.mean(entry["files"]))
    reader = FastSlotReader(feed, buckets=BucketSpec(min_size=TNPAD,
                                                     max_size=1 << 18))
    parse_ms = [timed_secs(lambda: reader.parse_file(f))[0] * 1e3
                for f in files]
    stream_s, streamed = timed_secs(lambda: sum(1 for _ in reader.stream(
        files, drop_remainder=False, prefetch=2)))
    require(streamed == n_batches, f"FastSlotReader: {streamed} batches")
    reader_ms = stream_s / n_batches * 1e3
    print(f"timing trainer files: train_from_files {entry['files']} "
          f"ms/step ({TB * 1e3 / files_ms:.1f} examples/s); "
          f"train_from_dataset {entry['dataset']} ms/step "
          f"({TB * 1e3 / float(np.mean(entry['dataset'])):.1f} "
          f"examples/s); FastSlotReader.stream {reader_ms:.4f} ms/batch "
          f"(prefetch 2, parse included); parse_file {parse_ms} ms/file "
          f"of {TRAINER_FILE_BATCHES * TB} lines; BatchAssembler "
          f"{asm_ms:.4f} ms/batch; from files to a trained pass: "
          f"train_from_files {files_ms:.4f} ms/step against "
          f"load_into_memory + train_from_dataset "
          f"{load_s * 1e3 / n_batches + np.mean(entry['dataset']):.4f} "
          f"ms/step")
    print(f"trainer files SpanTimer (last pass, a \"main\" span a segment):"
          f" {files_trainer.timer.report()}")
    # two more files passes with the time the trainer waits on the reader
    # (inside the stream's next()) taken where it runs: over the two files
    # (a run collects a file's 16 batches, so its parse is exposed), and
    # over them twice (64 batches: later files parse during earlier runs)
    waits = []
    stream = FastSlotReader.stream

    def timed_stream(self, *args, **kwargs):
        it = stream(self, *args, **kwargs)
        while True:
            t = time.perf_counter()
            batch = next(it, None)
            waits.append(time.perf_counter() - t)
            if batch is None:
                return
            yield batch

    files_split = {}
    FastSlotReader.stream = timed_stream
    try:
        for tag, reps in (("x1", 1), ("x2", 2)):
            waits.clear()
            files_trainer.reset_metrics()
            secs, _ = timed_secs(
                lambda: files_trainer.train_from_files(files * reps))
            n = n_batches * reps
            split = {"pass": secs / n * 1e3,
                     "main": files_trainer.timer.total["main"] / n * 1e3,
                     "reader_first_batch": waits[0] * 1e3,
                     "reader": sum(waits) / n * 1e3}
            split["steps"] = split["main"] - split["reader"]
            split["rest"] = split["pass"] - split["main"]
            files_split[tag] = split
            print(f"timing trainer files, one more pass over the files "
                  f"{tag} ({n} batches) split (ms/step): {split}")
    finally:
        FastSlotReader.stream = stream
    # the pass end's share: the host's AUC metrics over 2^20 buckets
    compute_s, _ = timed_secs(trainer.calc.compute)
    print(f"timing trainer: AucCalculator.compute at the pass end "
          f"{compute_s * 1e3:.4f} ms")
    # one more pass, with the assembly and Python's garbage collections
    # timed where they run, to split the pass beyond the "main" span
    in_pass = {"assemble": [], "gc": []}
    assemble = ds.assembler.assemble

    def timed_assemble(records):
        t = time.perf_counter()
        out = assemble(records)
        in_pass["assemble"].append(time.perf_counter() - t)
        return out

    def on_gc(phase, info):
        in_pass["gc"].append((phase, time.perf_counter()))

    ds.assembler.assemble = timed_assemble
    gc.callbacks.append(on_gc)
    try:
        trainer.reset_metrics()
        secs, _ = timed_secs(lambda: trainer.train_from_dataset(ds))
    finally:
        gc.callbacks.remove(on_gc)
        del ds.assembler.assemble
    marks = in_pass["gc"]
    gc_s = sum(b - a for (pa, a), (pb, b) in zip(marks[::2], marks[1::2])
               if pa == "start" and pb == "stop")
    split = {"pass": secs / n_batches * 1e3,
             "main": trainer.timer.mean_ms("main"),
             "assemble": float(np.mean(in_pass["assemble"])) * 1e3,
             "gc": gc_s / n_batches * 1e3,
             "metrics": compute_s / n_batches * 1e3}
    split["rest"] = (split["pass"] - split["main"] - split["assemble"] -
                     split["metrics"])
    print(f"timing trainer, one more pass split (ms/step): {split}; "
          f"{len(marks) // 2} garbage collections")
    return {"launches": launches, "eval_launches": eval_launches,
            "files_launches": files_launches, "path_ms": path_ms,
            "files": files,
            "captures": graphs.captures, "replays": graphs.replays,
            "ms_per_step": ms, "examples_per_s": TB * 1e3 / ms,
            "hand_ms_per_step": hand_ms, "assemble_ms": asm_ms,
            "files_ms_per_step": files_ms, "reader_ms": reader_ms,
            "parse_ms": parse_ms, "files_split_ms": files_split,
            "load_s": load_s, "compute_ms": compute_s * 1e3,
            "split_ms": split}


# -- run graphs across an arena growth ---------------------------------------

GROWTH_ROWS = 520_000        # prepopulated rows of the growth stream's table
GROWTH_HEADROOM = 1 << 17    # its arena rows beyond them


def phase_graph_growth(rng) -> dict:
    """Four runs of 16 batches at the training shape through
    ``train_stream``'s run graphs, against the eager run loop on a twin
    built alike: run 1 goes eagerly (the warm-up), run 2 is captured and
    replayed, run 3, 15% of whose keys are new, grows the arena and
    rehashes the host map (the mirror moves to a table of twice the
    slots) before its first step and is captured once more, run 4
    replays. Every device-prep kernel launches once a batch; the losses,
    rows by key, dense params, adam's state and the AUC state equal the
    twin's bit for bit."""
    conf, tconf, buckets = train_confs()
    model = random_deepfm(rng, TS * conf.pull_dim)
    K = FusedTrainStep.DEV_CHUNK
    batches = make_train_batches(rng, 4 * K)
    batches = [(np.where(k > 0, (k - 1) % GROWTH_ROWS + 1, 0).astype(
        np.uint64), segs, labels) for k, segs, labels in batches]
    fresh = with_new_keys(rng, batches[2 * K:3 * K], GROWTH_ROWS + 1, 3)
    batches[2 * K:3 * K] = [(k, segs, labels) for k, (_, segs, labels) in
                            zip(fresh, batches[2 * K:3 * K])]
    dense = np.zeros((TB, 0), np.float32)
    mask = np.ones(TB, np.float32)
    stream = [(k, segs, np.stack([np.ones(TB, np.float32), labels], axis=1),
               labels, dense, mask) for k, segs, labels in batches]

    def world():
        t = DeviceTable(conf, capacity=GROWTH_ROWS + 1 + GROWTH_HEADROOM,
                        uniq_buckets=buckets, device="cuda",
                        backend="native", index_threads=1)
        t.prepopulate(GROWTH_ROWS)
        fs = FusedTrainStep(copy.deepcopy(model), t, tconf, TB, TS,
                            device_prep=True)
        return fs, (*fs.init(), fs.init_auc_state())

    gfs, gstate = world()
    efs, estate = world()
    t = gfs.table
    cap, slots, gen = t.capacity, t.mirror.tab.shape[0], \
        t.mirror.generation
    glosses = []
    secs, (*gstate, _, steps), launches = count_launches(
        lambda: gfs.train_stream(*gstate, iter(stream),
                                 on_step=lambda s, l: glosses.append(l)),
        len(stream), "run graphs, growth stream")
    graphs = gfs.run_graphs
    require(steps == len(stream), f"run graphs: {steps} steps")
    require(t.capacity > cap and t.mirror.tab.shape[0] > slots and
            t.mirror.generation > gen,
            f"run graphs: the third run did not grow the arena ({cap} -> "
            f"{t.capacity}) and move the mirror ({slots} -> "
            f"{t.mirror.tab.shape[0]} slots)")
    require((graphs.captures, graphs.replays) == (2, 3),
            f"run graphs: {graphs.captures} captures, {graphs.replays} "
            "replays over 4 runs (expected 2, 3)")
    estate, elosses = eager_run_loop(efs, estate, stream)
    require(torch.equal(torch.stack(glosses), torch.stack(elosses)),
            "run graphs vs the eager run loop: losses differ")
    require(not bool(gfs.bad_flag) and
            bool(torch.isfinite(torch.stack(glosses)).all()),
            "run graphs: the numeric sentinel tripped")
    require_same_training("run graphs vs the eager run loop, growth stream",
                          (t, *gstate), (efs.table, *estate))
    gdirty = dirty_keys(t)
    require(np.array_equal(gdirty, dirty_keys(efs.table)),
            "run graphs vs the eager run loop: the dirty rows differ by key")
    stream_keys = np.unique(np.concatenate([b[0] for b in stream]))
    require(np.array_equal(gdirty, stream_keys[stream_keys > 0]),
            "run graphs: the dirty rows are not the stream's keys (marks "
            "lost across the growth, or marked where nothing trained)")
    print(f"run graphs, growth stream: 4 runs of {K} batches (B={TB}) over "
          f"{GROWTH_ROWS} prepopulated rows, the third with 15% new keys: "
          f"arena {cap} -> {t.capacity} rows, mirror {slots} -> "
          f"{t.mirror.tab.shape[0]} slots; {graphs.captures} captures "
          f"({', '.join(f'{x:.2f}' for x in graphs.capture_ms)} ms), "
          f"{graphs.replays} replays, launches {launches}; losses "
          f"{float(glosses[0]):.6f} -> {float(glosses[-1]):.6f}; vs the "
          f"eager run loop on a twin: losses, all {len(t)} rows by key, "
          f"dense params, adam's count ({int(gstate[1]['count'])}), mu, nu "
          f"and the AUC state bit for bit; the dirty rows ({gdirty.size}, "
          f"the stream's keys: the bitmap grew with the arena, its marks "
          f"kept) by key; {secs / steps * 1e3:.4f} ms/step")
    return {"captures": graphs.captures, "replays": graphs.replays,
            "capture_ms": graphs.capture_ms, "launches": launches}


# -- the day/pass loop --------------------------------------------------------

LOOP_DAYS = (("20260101", 0), ("20260102", 1))   # (day, new keys or not)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip()


class TimedWriter(AsyncCheckpointWriter):
    """The checkpoint writer, timing each job where it runs (serialize,
    commit, donefile, retention)."""

    def __init__(self):
        super().__init__(max_queue=CKPT_QUEUE_DEPTH, retries=CKPT_RETRIES)
        self.commit_s = []

    def submit(self, label, fn, on_fail=None):
        def timed_job():
            t0 = time.perf_counter()
            fn()
            self.commit_s.append((label, time.perf_counter() - t0))
        super().submit(label, timed_job, on_fail)


def loop_world(conf, tconf, model, index_threads: int, root: str,
               rows: int = HOT_VOCAB):
    """A flagship trainer over a DeviceTable of ``rows`` prepopulated rows
    (device prep over a one-thread native index, host prep over an
    ``MtIndex`` of more threads), its ``SparsePS`` and a double-buffered
    ``PassManager`` with a timed writer."""
    table = DeviceTable(conf, capacity=HOT_VOCAB + 1 + TRAINER_HEADROOM,
                        uniq_buckets=BucketSpec(min_size=TNPAD),
                        device="cuda", backend="native",
                        index_threads=index_threads)
    if rows:
        table.prepopulate(rows)
    feed = trainer_feed_conf()
    tr = CTRTrainer(model, feed, conf, tconf, table=table)
    buckets = BucketSpec(min_size=TNPAD, max_size=1 << 18)
    writer = TimedWriter()
    pm = PassManager(SparsePS({"embedding": table}), root,
                     [SlotDataset(feed, buckets=buckets),
                      SlotDataset(feed, buckets=buckets)], writer=writer)
    return tr, pm, writer


def drive_loop(tr, pm, days, tag: str, counted: bool):
    """``examples/02_deepfm_stream.py``'s loop over ``days`` (day, [file,
    file]): per pass the launches (device prep: every kernel of the path
    once a batch), the keys of the pass, the rows the bitmap marked, and
    the delta's synchronous snapshot ms; per day the base's. Returns the
    records and the seconds the training thread waited in ``barrier()``."""
    t = tr.table
    out = {"passes": [], "bases": [], "launches": {}}
    snap_ms = lambda kind: pm.timer.total[f"save_{kind}_snapshot"] * 1e3
    for day, files in days:
        pm.set_date(day)
        ds = pm.begin_pass(files[:1])
        pm.preload_next(files[1:])
        for i in range(len(files)):
            n = ds.num_instances() // TB
            if counted:
                _, m, launches = count_launches(
                    lambda: tr.train_from_dataset(ds), n, f"{tag} pass")
                for k, v in launches.items():
                    out["launches"][k] = out["launches"].get(k, 0) + v
            else:
                m = tr.train_from_dataset(ds)
            keys = ds.extract_keys()
            marked = None
            if t.dirty_dev is not None:
                rows = torch.nonzero(t.dirty_dev[1:t._size]).cpu().numpy()
                marked = np.sort(t.row_keys()[rows[:, 0] + 1])
            before = snap_ms("delta")
            t0 = time.perf_counter()
            pm.end_pass(save_delta=True)
            out["passes"].append(dict(
                day=day, pass_id=pm.pass_id, keys=keys, marked=marked,
                metrics=m, snapshot_ms=snap_ms("delta") - before,
                end_pass_ms=(time.perf_counter() - t0) * 1e3))
            tr.reset_metrics()
            if i + 1 < len(files):
                ds = pm.begin_pass([], preloaded=True)
        before = snap_ms("base")
        pm.save_base(dense_state=(tr.params, tr.opt_state))
        out["bases"].append(dict(day=day, pass_id=pm.pass_id,
                                 snapshot_ms=snap_ms("base") - before))
    barrier_s, _ = timed_secs(pm.barrier)
    out["barrier_s"] = barrier_s
    return out


def trail_kinds(root: str):
    return [(r["day"], r["kind"]) for r in donefile.read_done(root)]


def delta_file(root: str, day: str, pass_id: int) -> str:
    return os.path.join(root, day, f"{pass_id:05d}", "delta",
                        "embedding.npz")


def npz_by_key(path: str):
    with np.load(path) as d:
        order = np.argsort(d["keys"])
        return tuple(d[k][order] for k in ("keys", "values", "state"))


def phase_pass_loop(rng) -> dict:
    """The reference's day/pass loop at the flagship's width: two days of
    two passes, each one seeded MultiSlot file of 16 batches of B=2048
    (day 2's with 5% new keys), over 4,194,304 prepopulated rows on device
    prep, delta saves at each pass end and a base with the dense state at
    each day end, then ``barrier()``; a resume into a fresh table and
    trainer; day 1 over a host-prep twin (``MtIndex``); the dataset pass
    with and without the dirty mark, in turns."""
    card = card_line()
    conf, tconf, _ = train_confs()
    os.makedirs(WORK, exist_ok=True)
    days, fresh = [], HOT_VOCAB + 1
    for day, new in LOOP_DAYS:
        files = []
        for j in range(2):
            path = os.path.join(WORK, f"loop-{day}-{j}")
            write_trainer_file(rng, path, fresh if new else 0)
            fresh += (HOT_VOCAB + 1) if new else 0
            files.append(path)
        days.append((day, files))
    model = random_deepfm(rng, TS * conf.pull_dim)
    twin_model = copy.deepcopy(model)
    root = os.path.join(WORK, "loop-model")
    tr, pm, writer = loop_world(conf, tconf, model, 1, root)
    require(tr.step.device_prep and tr.table.dirty_dev is not None,
            "pass loop: device prep off")
    loop_s, out = timed_secs(lambda: drive_loop(tr, pm, days, "pass loop",
                                                True))
    n_batches = int(sum(p["metrics"]["ins_num"] for p in out["passes"]))
    n_batches //= TB
    require(trail_kinds(root) == [(d, k) for d, _ in LOOP_DAYS
                                  for k in ("delta", "delta", "base")],
            f"pass loop: donefile trail {trail_kinds(root)}")
    rows_per_delta = []
    for p in out["passes"]:
        dkeys = npz_by_key(delta_file(root, p["day"], p["pass_id"]))[0]
        require(np.array_equal(dkeys, p["keys"]),
                f"pass loop: pass {p['pass_id']}'s delta holds "
                f"{dkeys.size} keys, its batches touched {p['keys'].size}")
        require(np.array_equal(p["marked"], p["keys"]),
                f"pass loop: pass {p['pass_id']}: the push kernel marked "
                f"{p['marked'].size} rows, the batches touched "
                f"{p['keys'].size} keys")
        rows_per_delta.append(int(dkeys.size))
    pm.close()
    commit = [(label, round(secs, 4)) for label, secs in writer.commit_s]
    print(f"pass loop: 2 days x 2 passes of {TRAINER_FILE_BATCHES} "
          f"batches (B={TB}, {n_batches} in all) over {HOT_VOCAB} "
          f"prepopulated rows, device prep; launches {out['launches']}; "
          f"trail {[k for _, k in trail_kinds(root)]}; every delta holds "
          f"exactly its pass's keys and the push kernel marked exactly "
          f"those rows; {loop_s:.2f} s in all [{card}]")
    print(f"pass loop: synchronous snapshot ms: deltas "
          f"{[round(p['snapshot_ms'], 4) for p in out['passes']]}, bases "
          f"{[round(b['snapshot_ms'], 4) for b in out['bases']]}; end_pass "
          f"ms (decay, snapshot, submit) "
          f"{[round(p['end_pass_ms'], 4) for p in out['passes']]}; rows "
          f"per delta {rows_per_delta}; rows per base "
          f"{len(tr.table)} [{card}]")
    print(f"pass loop: writer commit s (serialize, compress, manifest, "
          f"rename, donefile) {commit}; the training thread waited "
          f"{out['barrier_s']:.4f} s in barrier() [{card}]")

    # resume into a fresh table and trainer
    fresh_tr, fresh_pm, _ = loop_world(
        conf, tconf, random_deepfm(np.random.default_rng(99),
                                   TS * conf.pull_dim),
        1, root, rows=0)
    resume_s, got = timed_secs(lambda: fresh_pm.resume(
        dense_template=(fresh_tr.params, fresh_tr.opt_state)))
    fresh_pm.close()
    require(got[:2] == (LOOP_DAYS[-1][0], pm.pass_id),
            f"pass loop: resumed version {got[:2]}")
    require_same_training("pass loop: resume vs the live trainer",
                          (fresh_tr.table, fresh_tr.params,
                           fresh_tr.opt_state, None),
                          (tr.table, tr.params, tr.opt_state, None))
    print(f"pass loop: resume (verify, load the base of {len(tr.table)} "
          f"rows, dense state) {resume_s:.4f} s; rows by key, dense params, "
          f"adam's count ({int(fresh_tr.opt_state['count'])}), mu and nu "
          f"bit for bit against the live trainer [{card}]")

    # day 1 over a host-prep twin: its deltas equal device prep's by key
    twin_root = os.path.join(WORK, "loop-host-prep")
    htr, hpm, _ = loop_world(conf, tconf, twin_model, 4, twin_root)
    require(not htr.step.device_prep and
            type(htr.table._index).__name__ == "MtIndex",
            "pass loop: the twin is not host prep over an MtIndex")
    hout = drive_loop(htr, hpm, days[:1], "pass loop, host prep", False)
    hpm.close()
    for p in hout["passes"]:
        a = npz_by_key(delta_file(twin_root, p["day"], p["pass_id"]))
        b = npz_by_key(delta_file(root, p["day"], p["pass_id"]))
        require(all(np.array_equal(x, y) for x, y in zip(a, b)),
                f"pass loop: pass {p['pass_id']}'s delta differs between "
                "host prep and device prep")
    print(f"pass loop, host-prep twin (index_threads=4, MtIndex): day 1's "
          f"deltas ({[int(p['keys'].size) for p in hout['passes']]} rows) "
          f"equal device prep's by key, values and state bit for bit; "
          f"snapshot ms {[round(p['snapshot_ms'], 4) for p in hout['passes']]}"
          f" [{card}]")
    del htr, hpm

    # the dataset pass with the mark and without it (the bitmap detached:
    # the push launches as before the mark), in turns
    ds = SlotDataset(trainer_feed_conf(),
                     buckets=BucketSpec(min_size=TNPAD, max_size=1 << 18))
    ds.set_filelist(days[0][1][:1])
    ds.load_into_memory()
    n = ds.num_instances() // TB
    bitmap = tr.table.dirty_dev
    turns = {"mark": [], "no_mark": []}
    for who in ("mark", "no_mark", "no_mark", "mark") * 2:
        tr.table.dirty_dev = bitmap if who == "mark" else None
        tr.reset_metrics()
        secs, _ = timed_secs(lambda: tr.train_from_dataset(ds))
        turns[who].append(secs / n * 1e3)
    tr.table.dirty_dev = bitmap
    print(f"timing pass loop: train_from_dataset ms/step over {n} batches, "
          f"in turns: with the dirty mark {turns['mark']}, without "
          f"{turns['no_mark']} [{card}]")
    return {"launches": out["launches"], "loop_s": loop_s,
            "delta_snapshot_ms": [p["snapshot_ms"] for p in out["passes"]],
            "base_snapshot_ms": [b["snapshot_ms"] for b in out["bases"]],
            "rows_per_delta": rows_per_delta, "commit_s": commit,
            "barrier_s": out["barrier_s"], "resume_s": resume_s,
            "turns_ms": turns}


# -- phase 4e: the tiered loop -------------------------------------------------

TIER_ARENA = 1 << 20          # rows of the tiered table's device arena
TIER_KEY_SPACE = 1 << 33      # a pass's new keys come from [1, 2^33)
TIER_NEW = 450_000            # new keys a pass draws from (bench.py:751)
TIER_HOT = 150_000            # keys of earlier passes a later pass draws from
# (day, passes): day 2 cut from two passes to one when the mesh phase
# (4v) took the script near its time limit
TIER_DAYS = (("20260301", 2), ("20260302", 1))


def write_pool_file(rng, path: str, pool: np.ndarray) -> np.ndarray:
    """TRAINER_FILE_BATCHES * TB MultiSlot lines of TS slots with 1-3 keys
    each, the keys drawn from ``pool``; returns the keys drawn, unique."""
    rows = TRAINER_FILE_BATCHES * TB
    lengths = rng.integers(1, 4, size=(rows, TS))
    keys = rng.choice(pool, size=int(lengths.sum()))
    labels = rng.integers(0, 2, size=rows)
    write_slot_lines(path, lengths, keys, labels)
    return np.unique(keys)


def tiered_world(conf, tconf, model, root: str, device_prep: bool = True,
                 saves: bool = True, disk_root: str = None,
                 value_dtype: torch.dtype = torch.float32):
    """A flagship trainer over a ``TieredDeviceTable`` of TIER_ARENA rows
    of ``value_dtype`` (a one-thread native index) over a native host
    ``EmbeddingTable`` (with ``disk_root``, over a ``DiskTier`` there), its
    ``SparsePS`` and a double-buffered ``PassManager``; the table's
    staging and pass end timed where they run."""
    buckets = BucketSpec(min_size=TNPAD, max_size=1 << 18)
    backing = EmbeddingTable(conf, backend="native")
    disk = DiskTier(backing, disk_root) if disk_root is not None else None
    table = TieredDeviceTable(conf, backing=backing, capacity=TIER_ARENA,
                              uniq_buckets=buckets, device="cuda",
                              disk=disk, value_dtype=value_dtype,
                              backend="native", index_threads=1)
    feed = trainer_feed_conf()
    tr = CTRTrainer(model, feed, conf, tconf, table=table, buckets=buckets,
                    device_prep=device_prep)
    writer = TimedWriter()
    pm = PassManager(SparsePS({"embedding": table}), root,
                     [SlotDataset(feed, buckets=buckets),
                      SlotDataset(feed, buckets=buckets)], writer=writer)
    world = dict(tr=tr, pm=pm, table=table, writer=writer, saves=saves,
                 disk=disk, consumed=[], t={k: [] for k in TIER_SPANS})
    consume = table._consume_prefetch

    def spy(uniq):
        out = consume(uniq)
        world["consumed"].append(out is not None)
        return out
    table._consume_prefetch = spy
    objs = {"table": table, "backing": backing, "mirror": table.mirror}
    for span, (obj, name, sync) in TIER_SPANS.items():
        if objs[obj] is not None:       # host prep has no mirror
            time_calls(objs[obj], name, world["t"][span], sync)
    return world


# the tiered table's calls timed on the training thread: span -> (object,
# method, between device synchronizations)
TIER_SPANS = {
    "stage": ("table", "begin_feed_pass", True),
    "end_pass": ("table", "end_pass", True),
    "join": ("table", "_join_prefetch", False),
    "consume": ("table", "_consume_prefetch", False),
    "export": ("backing", "export_rows", False),
    "rebuild": ("table", "_rebuild_index", False),
    "ingest": ("table", "_ingest", True),
    "mirror": ("mirror", "sync", True),
}


def time_calls(obj, name: str, log: list, sync: bool) -> None:
    """Wrap ``obj.name`` so that each call on the training thread appends
    its seconds to ``log`` (``sync``: between device synchronizations);
    calls on other threads (the tier worker's exports) pass through."""
    orig = getattr(obj, name)

    def timed(*a, **kw):
        if threading.current_thread() is not threading.main_thread():
            return orig(*a, **kw)
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        if sync:
            torch.cuda.synchronize()
        log.append(time.perf_counter() - t0)
        return out
    setattr(obj, name, timed)


def tiered_passes(world, files, prefetch: bool, entry: str, tag: str,
                  counted: bool = False, stop: int = 0, days=TIER_DAYS):
    """The day/pass loop over ``files`` (one a pass, ``days``), one pass
    per ``next()``: ``begin_pass`` stages the pass's keys, the next file
    preloads and, with ``prefetch``, starts staging
    (``prefetch_feed_next``); ``entry`` ("files": ``train_from_files``, its
    runs graphs; "dataset": ``train_from_dataset``) trains; ``end_pass``
    writes back and decays, with a delta save where the world saves; a
    base with the dense state each day. Yields each pass's record; stops
    after ``stop`` passes (0: all)."""
    tr, pm, table = world["tr"], world["pm"], world["table"]
    graphs = tr.step.run_graphs
    world.setdefault("launches", {})
    p = 0
    for day, n_day in days:
        pm.set_date(day)
        for _ in range(n_day):
            caps = graphs.captures if graphs is not None else 0
            t = world["t"]
            at = {k: len(v) for k, v in t.items()}
            ds = (pm.begin_pass(files[:1]) if p == 0 else
                  pm.begin_pass([], preloaded=True))
            require(len(t["stage"]) == at["stage"] + 1,
                    f"{tag}: pass {p + 1} staged no arena")
            split = {k: sum(t[k][at[k]:]) for k in
                     ("consume", "export", "rebuild", "ingest", "mirror")}
            at = {k: len(v) for k, v in t.items()}
            w = int(table.staged_keys.size)
            if "admitted" in world:     # admission: kept for a replay
                world["admitted"].append((ds.extract_keys(),
                                          table.staged_keys.copy()))
            else:
                require(np.array_equal(table.staged_keys,
                                       ds.extract_keys()),
                        f"{tag}: pass {p + 1} staged other keys than its "
                        "own")
            if p + 1 < len(files):
                pm.preload_next(files[p + 1:p + 2])
                if prefetch:
                    pm.prefetch_feed_next()
            n = ds.num_instances() // TB
            fn = ((lambda: tr.train_from_files(files[p:p + 1]))
                  if entry == "files" else
                  (lambda: tr.train_from_dataset(ds)))
            if counted:
                for c in PUSH_VARIANTS.values():
                    c.launches = 0
                secs, m, launches = count_launches(fn, n,
                                                   f"{tag} pass {p + 1}")
                launches.update({c.__name__: c.launches
                                 for c in PUSH_VARIANTS.values()})
                for k, v in launches.items():
                    world["launches"][k] = world["launches"].get(k, 0) + v
            else:
                secs, m = timed_secs(fn)
            require(m["ins_num"] == n * TB and not bool(tr.step.bad_flag),
                    f"{tag}: pass {p + 1} metrics {m}")
            snap0 = pm.timer.total.get("save_delta_snapshot", 0.0)
            pm.end_pass(save_delta=world["saves"])
            tr.reset_metrics()
            rec = dict(pass_id=pm.pass_id, day=day, w=w, steps=n,
                       stage_s=t["stage"][-1], split=split,
                       train_ms=secs / n * 1e3,
                       end_pass_s=t["end_pass"][-1],
                       join_s=sum(t["join"][at["join"]:]),
                       delta_ms=(pm.timer.total.get("save_delta_snapshot",
                                                    0.0) - snap0) * 1e3,
                       captures=(graphs.captures - caps
                                 if graphs is not None else 0),
                       backing_rows=len(table.backing))
            p += 1
            yield rec
            if p == stop:
                return
        if world["saves"]:
            pm.save_base(dense_state=(tr.params, tr.opt_state))


def quiesce(world) -> None:
    """Wait for a world's background work (the preload's parse, the keys'
    prefetch thread, the export on the tier worker, the writer's commits),
    so that a pass runs beside its own pass's work only."""
    pm = world["pm"]
    pending = pm.current._preload
    if pending is not None:
        pending.result()
    pm._join_prefetch()
    world["table"]._join_prefetch()
    pm.barrier()


def backing_by_key(table):
    """The backing's keys, values, state and embedx_ok in key order."""
    snap = table.backing.snapshot(reset_dirty=False)
    order = np.argsort(snap["keys"])
    return tuple(snap[k][order] for k in ("keys", "values", "state",
                                          "embedx_ok"))


def same_arrays(a, b) -> bool:
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


def npz_rows_by_key(path: str):
    with np.load(path) as d:
        order = np.argsort(d["keys"])
        return tuple(d[k][order] for k in ("keys", "values", "state",
                                           "embedx_ok"))


def phase_tiered_loop(rng) -> dict:
    """Tables larger than device memory (``bench.py:735-802``'s
    configuration): the flagship over a ``TieredDeviceTable`` of 2^20 rows
    on device prep, over a native host ``EmbeddingTable``, through
    ``PassManager`` with the prefetched feed pass, three passes of one
    seeded MultiSlot file of 16 batches (450,000 new keys from a 2^33
    space a pass, and 150,000 of earlier passes' keys from pass 2 on),
    trained by ``CTRTrainer.train_from_files`` (run graphs), delta saves,
    a base with the dense state a day, ``barrier()``, then ``resume`` into
    a fresh world. Held bit for bit by key against a twin that stages
    synchronously (the passes in turns with the main loop), a host-prep
    twin over day 1 (``train_from_dataset``), and the resumed backing;
    then the run graphs on the tiered table beside an untiered
    ``DeviceTable`` holding the whole table, in turns."""
    card = card_line()
    conf, tconf, _ = train_confs()
    os.makedirs(WORK, exist_ok=True)
    t0 = time.perf_counter()
    files, seen = [], np.empty(0, np.uint64)
    for p in range(sum(n for _, n in TIER_DAYS)):
        pool = rng.integers(1, TIER_KEY_SPACE, size=TIER_NEW,
                            dtype=np.uint64)
        if seen.size:
            pool = np.concatenate(
                [pool, rng.choice(seen, size=TIER_HOT, replace=False)])
        path = os.path.join(WORK, f"tiered-part-{p}")
        seen = np.union1d(seen, write_pool_file(rng, path, pool))
        files.append(path)
    write_s = time.perf_counter() - t0
    model = random_deepfm(rng, TS * conf.pull_dim)
    sync_model, host_model = copy.deepcopy(model), copy.deepcopy(model)

    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    root = os.path.join(WORK, "tiered-model")
    main = tiered_world(conf, tconf, model, root)
    sync = tiered_world(conf, tconf, sync_model,
                        os.path.join(WORK, "tiered-sync"), saves=False)
    table = main["table"]
    require(main["tr"].step.device_prep and sync["tr"].step.device_prep,
            "tiered loop: device prep off")
    # the main loop (prefetch) and its synchronous twin, pass by pass in
    # turns (main, twin, twin, main, ...), each pass beside its own pass's
    # background work only (the next file's preload, the prefetch)
    loop_t0 = time.perf_counter()
    gens = {"main": tiered_passes(main, files, True, "files", "tiered loop",
                                  counted=True),
            "sync": tiered_passes(sync, files, False, "files",
                                  "tiered loop, sync twin")}
    recs = {"main": [], "sync": []}
    order = ("main", "sync", "sync", "main")
    for p in range(len(files)):
        for who in (order[:2] if p % 2 == 0 else order[2:]):
            quiesce(main)
            quiesce(sync)
            recs[who].append(next(gens[who]))
    for g in gens.values():
        require(next(g, None) is None, "tiered loop: passes left over")
    main["pm"].barrier()
    loop_s = time.perf_counter() - loop_t0
    peak = torch.cuda.max_memory_allocated()
    n_batches = sum(r["steps"] for r in recs["main"])
    require(main["consumed"] == [False] + [True] * (len(files) - 1),
            f"tiered loop: the consumes took {main['consumed']} (the "
            "prefetched buffers not taken)")
    require(sync["consumed"] == [False] * len(files),
            f"tiered loop, sync twin: consumes {sync['consumed']}")
    rows = len(table.backing)
    require(rows > TIER_ARENA,
            f"tiered loop: the backing holds {rows} rows, not more than "
            f"the arena's {TIER_ARENA}")
    require(same_arrays(backing_by_key(table), backing_by_key(sync["table"])),
            "tiered loop: the backing differs from the sync twin's by key")
    require(trail_kinds(root) == [(d, k) for d, n in TIER_DAYS
                                  for k in ["delta"] * n + ["base"]],
            f"tiered loop: donefile trail {trail_kinds(root)}")
    main["pm"].close()
    sync["pm"].close()
    arena_b, mirror_b = table.memory_bytes(), table.mirror.memory_bytes()
    print(f"tiered loop: {len(files)} passes of {TRAINER_FILE_BATCHES} "
          f"batches (B={TB}, {n_batches} in all; files written in "
          f"{write_s:.2f} s) over a TieredDeviceTable of {TIER_ARENA} rows, "
          f"device prep, run graphs, prefetch_feed_next; launches "
          f"{main['launches']}; the backing holds {rows} rows "
          f"({table.backing_bytes()} B) > the arena's {TIER_ARENA}; "
          f"consumes {main['consumed']}; the backing equals the "
          f"synchronous twin's by key bit for bit; {loop_s:.2f} s for both "
          f"loops in turns [{card}]")
    for who in ("main", "sync"):
        split = [{k: round(v, 4) for k, v in r["split"].items()}
                 for r in recs[who]]
        print(f"tiered loop {'(prefetch)' if who == 'main' else 'sync twin'}"
              f" per pass: W {[r['w'] for r in recs[who]]}; staging s "
              f"{[round(r['stage_s'], 4) for r in recs[who]]}, of which "
              f"{split}; train "
              f"ms/step {[round(r['train_ms'], 4) for r in recs[who]]}; "
              f"end_pass s (the wait for the export in flight, download, "
              f"import, re-randomize, decay) "
              f"{[round(r['end_pass_s'], 4) for r in recs[who]]}, of which "
              f"the wait {[round(r['join_s'], 4) for r in recs[who]]}; delta "
              f"snapshot ms {[round(r['delta_ms'], 4) for r in recs[who]]};"
              f" captures {[r['captures'] for r in recs[who]]}; backing "
              f"rows {[r['backing_rows'] for r in recs[who]]} [{card}]")
    commit = [(label, round(secs, 4)) for label, secs in
              main["writer"].commit_s]
    print(f"tiered loop: device memory: max_memory_allocated {peak} B over "
          f"both loops ({mem0} B before); a world's arena {arena_b} B and "
          f"mirror {mirror_b} B ({table.mirror.tab.shape[0]} slots) against "
          f"its backing's {table.backing_bytes()} B on the host; writer "
          f"commits s {commit} [{card}]")

    # resume into a fresh world: the backing by key and the dense state
    fresh = tiered_world(conf, tconf, random_deepfm(
        np.random.default_rng(98), TS * conf.pull_dim), root)
    ftr = fresh["tr"]
    resume_s, got = timed_secs(lambda: fresh["pm"].resume(
        dense_template=(ftr.params, ftr.opt_state)))
    fresh["pm"].close()
    require(got[:2] == (TIER_DAYS[-1][0], len(files)),
            f"tiered loop: resumed version {got[:2]}")
    require(same_arrays(backing_by_key(fresh["table"]),
                        backing_by_key(table)),
            "tiered loop: the resumed backing differs from the live one")
    tr = main["tr"]
    require(all(torch.equal(a, b) for a, b in zip(
        ftr.params.parameters(), tr.params.parameters())) and
        torch.equal(ftr.opt_state["count"], tr.opt_state["count"]) and
        all(torch.equal(x, y) for f in ("mu", "nu")
            for x, y in zip(ftr.opt_state[f], tr.opt_state[f])),
        "tiered loop: the resumed dense state differs")
    print(f"tiered loop: resume (verify, load the base of {rows} rows into "
          f"the backing, the dense state) {resume_s:.4f} s; the backing by "
          f"key, the dense params and adam's state bit for bit [{card}]")
    del fresh, ftr

    # day 1 over a host-prep twin (train_from_dataset over the same native
    # one-thread index, host prep): its deltas and base equal the main's
    hroot = os.path.join(WORK, "tiered-host-prep")
    host = tiered_world(conf, tconf, host_model, hroot, device_prep=False)
    require(not host["tr"].step.device_prep, "tiered loop: the host-prep "
                                             "twin runs device prep")
    hrecs = list(tiered_passes(host, files, True, "dataset",
                               "tiered loop, host prep",
                               stop=TIER_DAYS[0][1]))
    host["pm"].save_base(dense_state=(host["tr"].params,
                                      host["tr"].opt_state))
    host["pm"].close()
    for kind, pid in [("delta", r["pass_id"]) for r in hrecs] + \
            [("base", hrecs[-1]["pass_id"])]:
        rel = os.path.join(TIER_DAYS[0][0], f"{pid:05d}", kind,
                           "embedding.npz")
        require(same_arrays(npz_rows_by_key(os.path.join(hroot, rel)),
                            npz_rows_by_key(os.path.join(root, rel))),
                f"tiered loop: the host-prep twin's {rel} differs")
    print(f"tiered loop, host-prep twin (train_from_dataset, native "
          f"one-thread index): day 1's deltas and base equal the main "
          f"loop's by key bit for bit; per pass W "
          f"{[r['w'] for r in hrecs]}, train ms/step "
          f"{[round(r['train_ms'], 4) for r in hrecs]} [{card}]")
    del host

    # the run graphs on the tiered table (the last pass's keys staged again)
    # beside an untiered DeviceTable holding the whole table (the last
    # base), over the last pass's batches, in turns
    ds = SlotDataset(trainer_feed_conf(),
                     buckets=BucketSpec(min_size=TNPAD, max_size=1 << 18))
    ds.set_filelist(files[-1:])
    ds.load_into_memory()
    stream = reader_tuples(list(ds.batches()))
    table.begin_feed_pass(ds.extract_keys())
    base = os.path.join(root, TIER_DAYS[-1][0], f"{len(files):05d}",
                        "base", "embedding.npz")
    flat = DeviceTable(conf, capacity=rows + 1, device="cuda",
                       backend="native", index_threads=1)
    flat.load(base)
    flat_fs = FusedTrainStep(copy.deepcopy(tr.params), flat, tconf, TB, TS,
                             device_prep=True)
    worlds = {"tiered": (tr.step, [tr.params, tr.opt_state, tr.auc_state]),
              "untiered": (flat_fs, [*flat_fs.init(),
                                     flat_fs.init_auc_state()])}
    for fs, st in worlds.values():      # warm-up and capture
        for _ in range(2):
            st[:3] = fs.train_stream(*st, iter(stream))[:3]
    turns = {"tiered": [], "untiered": []}
    for who in ("tiered", "untiered", "untiered", "tiered") * 2:
        fs, st = worlds[who]
        secs, out = timed_secs(lambda: fs.train_stream(*st, iter(stream)))
        st[:3] = out[:3]
        turns[who].append(secs / len(stream) * 1e3)
    caps = {k: fs.run_graphs.captures if fs.run_graphs is not None else 0
            for k, (fs, _) in worlds.items()}
    print(f"timing tiered loop: run graphs ms/step over pass "
          f"{len(files)}'s {len(stream)} batches, in turns: tiered "
          f"(arena {TIER_ARENA} rows, W {int(table.staged_keys.size)}, "
          f"mirror {table.mirror.tab.shape[0]} slots) {turns['tiered']}; "
          f"untiered DeviceTable of all {len(flat)} rows (mirror "
          f"{flat.mirror.tab.shape[0]} slots) {turns['untiered']}; "
          f"captures {caps} [{card}]")

    # the step beside a dataset preload (the next pass's parse on the
    # dataset's threads, as PassManager.preload_next runs it) and idle, in
    # turns: the eager run loop and the run graphs over the same batches
    pre = SlotDataset(trainer_feed_conf(),
                      buckets=BucketSpec(min_size=TNPAD, max_size=1 << 18))
    pre.set_filelist(files[:1])
    fs, st = worlds["tiered"]
    beside = {f"{k} {m}": [] for k in ("eager", "graphs")
              for m in ("idle", "preload")}
    parsing = []
    for mode in ("idle", "preload"):
        if mode == "preload":
            pre.preload_into_memory()
        secs, out = timed_secs(lambda: fs.train_stream(*st, iter(stream)))
        st[:3] = out[:3]
        beside[f"graphs {mode}"].append(secs / len(stream) * 1e3)
        secs, (state, _) = timed_secs(
            lambda: eager_run_loop(fs, tuple(st[:3]), stream))
        st[:3] = state
        beside[f"eager {mode}"].append(secs / len(stream) * 1e3)
        if mode == "preload":
            parsing.append(not pre._preload.done())
            pre.wait_preload_done()
            pre.release_memory()
    print(f"timing tiered loop: ms/step over the same {len(stream)} "
          f"batches beside a dataset preload of one pass's file (the parse "
          f"still running after the graphs' and the eager run: {parsing}) "
          f"and idle (idle first): {beside} [{card}]")
    table.end_pass()
    return {"launches": main["launches"], "loop_s": loop_s, "files": files,
            "passes": recs["main"], "sync_passes": recs["sync"],
            "backing_rows": rows, "peak_bytes": peak,
            "resume_s": resume_s, "turns_ms": turns}


# -- phase 4i: the disk ladder ------------------------------------------------

DISK_WORLDS = ("main", "sync", "demote", "admit")
#: the disk ladder's passes: the tiered loop's first day (two passes, a
#: delta each and the day's base), cut from its two days so that the whole
#: script stays near 1000 s of its 1200 with phases 4r and 4s
DISK_DAYS = TIER_DAYS[:1]
DISK_ADMIT_SHOWS = "2"        # PBOX_FLAGS_ps_admit_shows of the admission run


def disk_rows(disk) -> tuple:
    """Every key on ``disk``, ascending, with its rows as ``read_rows``
    gives them (values, state, embedx_ok)."""
    keys = np.sort(disk._index.live_items()[0])
    return disk.read_rows(keys)[:4]


def admission_replay(passes) -> None:
    """The admission run's staged keys against a replay of the decision
    on the host: a count-min sketch of the flags' defaults fed each
    pass's keys (one show each, as ``PassManager`` feeds them), the keys
    of earlier passes known."""
    sketch = CountMinAdmission(float(DISK_ADMIT_SHOWS))
    known = np.empty(0, np.uint64)
    for p, (keys, staged) in enumerate(passes):
        old = np.isin(keys, known, assume_unique=True)
        ok = old.copy()
        ok[~old] = sketch.observe_and_admit(
            keys[~old], np.ones(int((~old).sum()), np.float32))
        require(np.array_equal(staged, keys[ok]),
                f"disk ladder, admission: pass {p + 1} staged "
                f"{staged.size} keys, the replay admits {int(ok.sum())}")
        known = np.union1d(known, staged)
        sketch.advance_epoch()


def phase_disk_ladder(rng, files) -> dict:
    """(4i) ``bench.py:735-860``'s tiered cell with its disk tier: the
    flagship (``show_clk_decay=0.5``) over a ``TieredDeviceTable`` of 2^20
    rows on device prep over a native ``EmbeddingTable`` over a
    ``DiskTier``, through ``PassManager`` with ``prefetch_feed_next`` and
    ``CTRTrainer.train_from_files`` (run graphs), the passes of
    ``DISK_DAYS`` over phase 4e's first files; after each ``end_pass`` every
    row spills
    (``evict_cold(show_threshold=inf)``) and the disk compacts, so each
    pass restages from disk. In turns with it: a synchronous twin, a
    ``PBOX_FLAGS_ps_tier_demote=1`` twin and an admission run
    (``PBOX_FLAGS_ps_admit_shows=2``)."""
    card = card_line()
    files = files[:sum(n for _, n in DISK_DAYS)]
    conf, tconf, _ = train_confs()
    conf = dataclasses.replace(conf, show_clk_decay=0.5)
    model = random_deepfm(rng, TS * conf.pull_dim)
    worlds = {}
    for who in DISK_WORLDS:
        root = os.path.join(WORK, f"disk-{who}")
        if who == "admit":
            os.environ["PBOX_FLAGS_ps_admit_shows"] = DISK_ADMIT_SHOWS
        try:
            worlds[who] = tiered_world(
                conf, tconf, copy.deepcopy(model), os.path.join(root, "model"),
                saves=who in ("main", "demote"),
                disk_root=os.path.join(root, "ssd"))
        finally:
            os.environ.pop("PBOX_FLAGS_ps_admit_shows", None)
        require((worlds[who]["table"]._admit is not None) == (who == "admit"),
                f"disk ladder: admission {who}")
    worlds["admit"]["admitted"] = []
    gens = {who: tiered_passes(w, files, who != "sync", "files",
                               f"disk ladder {who}",
                               counted=who in ("main", "admit"),
                               days=DISK_DAYS)
            for who, w in worlds.items()}
    recs = {who: [] for who in worlds}
    t0 = time.perf_counter()
    for p in range(len(files)):
        order = DISK_WORLDS if p % 2 == 0 else DISK_WORLDS[::-1]
        for who in order:
            for w in worlds.values():
                quiesce(w)
            w = worlds[who]
            disk = w["disk"]
            io0 = dict(disk.io_stats)
            if who == "demote":
                os.environ["PBOX_FLAGS_ps_tier_demote"] = "1"
            try:
                rec = next(gens[who])
            finally:
                os.environ.pop("PBOX_FLAGS_ps_tier_demote", None)
            secs, spilled = timed_secs(
                lambda: disk.evict_cold(show_threshold=float("inf")))
            compact_s, _ = timed_secs(disk.compact)
            io = {k: disk.io_stats[k] - io0[k] for k in io0}
            row_b = 4 * (conf.pull_dim + w["table"].backing._state.shape[1]) \
                + 1
            rec.update(spilled=spilled, evict_s=secs, compact_s=compact_s,
                       read_s=io["stage_seconds"],
                       insert_s=io["stage_insert_seconds"],
                       restaged=int(io["stage_bytes"] // row_b),
                       disk_bytes=disk.disk_bytes(), disk_rows=len(disk),
                       bandwidth=disk.bandwidth())
            recs[who].append(rec)
    for who, g in gens.items():
        require(next(g, None) is None, f"disk ladder {who}: passes left")
    loop_s = time.perf_counter() - t0
    for w in worlds.values():
        quiesce(w)
        len(w["table"])                 # fences a deferred demote
        w["pm"].close()
    main = worlds["main"]
    for who in ("main", "demote", "admit"):
        require(worlds[who]["consumed"] == [False] + [True] *
                (len(files) - 1),
                f"disk ladder {who}: consumes {worlds[who]['consumed']}")
    require(worlds["sync"]["consumed"] == [False] * len(files),
            f"disk ladder sync: consumes {worlds['sync']['consumed']}")
    require(all(r["restaged"] > 0 for r in recs["main"][1:]),
            "disk ladder: a later pass restaged nothing from disk")
    want_b, want_d = backing_by_key(main["table"]), disk_rows(main["disk"])
    for who in ("sync", "demote"):
        w = worlds[who]
        require([r["w"] for r in recs[who]] == [r["w"] for r in
                                                recs["main"]],
                f"disk ladder {who}: W differs from the main loop's")
        require(same_arrays(backing_by_key(w["table"]), want_b),
                f"disk ladder {who}: the backing differs by key")
        require(same_arrays(disk_rows(w["disk"]), want_d),
                f"disk ladder {who}: the disk rows differ by key")
        require_same_training(f"disk ladder {who} vs main", (
            w["table"], w["tr"].params, w["tr"].opt_state, None), (
            main["table"], main["tr"].params, main["tr"].opt_state, None))
    mroot = os.path.join(WORK, "disk-main", "model")
    droot = os.path.join(WORK, "disk-demote", "model")
    require(trail_kinds(mroot) == trail_kinds(droot) and
            len(trail_kinds(mroot)) == len(files) + len(DISK_DAYS),
            f"disk ladder: trails {trail_kinds(mroot)} vs "
            f"{trail_kinds(droot)}")
    for r in donefile.read_done(mroot):
        rel = os.path.relpath(r["path"], mroot)
        require(same_arrays(
            npz_rows_by_key(os.path.join(mroot, rel, "embedding.npz")),
            npz_rows_by_key(os.path.join(droot, rel, "embedding.npz"))),
            f"disk ladder demote: {rel} differs from the main loop's")
    admission_replay(worlds["admit"]["admitted"])
    adm = worlds["admit"]
    tiers = np.union1d(backing_by_key(adm["table"])[0],
                       disk_rows(adm["disk"])[0])
    staged = np.unique(np.concatenate(
        [s for _, s in adm["admitted"]]))
    require(np.array_equal(tiers, staged),
            "disk ladder admission: the backing and the disk hold keys the "
            "passes did not stage (a rejected key got a row)")
    rejected = int(np.unique(np.concatenate(
        [k for k, _ in adm["admitted"]])).size - staged.size)
    require(rejected > 0, "disk ladder admission: no key rejected")
    print(f"disk ladder: {len(files)} passes of {TRAINER_FILE_BATCHES} "
          f"batches (phase 4e's files) over a TieredDeviceTable of "
          f"{TIER_ARENA} rows over a native EmbeddingTable over a DiskTier, "
          f"show_clk_decay 0.5, evict_cold(inf) and compact() after each "
          f"end_pass; launches {main['launches']}; consumes "
          f"{main['consumed']}; the sync and demote twins' W, backing and "
          f"disk rows by key, dense params and optimizer state, and the "
          f"demote twin's deltas and bases, bit for bit; the admission "
          f"run's staged keys equal the replay's, {rejected} keys "
          f"rejected and in no tier ({staged.size} admitted); "
          f"{loop_s:.2f} s for the four worlds in turns [{card}]")
    for who in DISK_WORLDS:
        print(f"disk ladder {who} per pass: W {[r['w'] for r in recs[who]]};"
              f" staging s {[round(r['stage_s'], 4) for r in recs[who]]}; "
              f"disk read s (worker and training thread) "
              f"{[round(r['read_s'], 4) for r in recs[who]]}, insert s "
              f"{[round(r['insert_s'], 4) for r in recs[who]]}; spilled "
              f"rows {[r['spilled'] for r in recs[who]]}, restaged rows "
              f"{[r['restaged'] for r in recs[who]]}; evict s "
              f"{[round(r['evict_s'], 4) for r in recs[who]]}, compact s "
              f"{[round(r['compact_s'], 4) for r in recs[who]]}; "
              f"disk_bytes {[r['disk_bytes'] for r in recs[who]]}; "
              f"bandwidth {recs[who][-1]['bandwidth']}; end_pass s "
              f"{[round(r['end_pass_s'], 4) for r in recs[who]]}; train "
              f"ms/step {[round(r['train_ms'], 4) for r in recs[who]]} "
              f"[{card}]")
    out = {"launches": {"disk_ladder": main["launches"],
                        "disk_ladder_admit": adm["launches"]},
           "loop_s": loop_s, "passes": recs}
    del worlds, main, adm
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 4j: the seqpool variants, cvm, the host-table pass loop ------------

HOSTLOOP_BATCHES = 4          # batches of B=2048 in each pass's file
HOSTLOOP_VOCAB = 200_000      # the host loop's keys: [1, HOSTLOOP_VOCAB)
HOSTLOOP_DAYS = (("20260401", 2), ("20260402", 2))
PCOC_P = 2                    # the pcoc variant's pclk columns


def variant_case(tag: str, fn, inputs, grad_of, exact_from: int) -> float:
    """``fn`` forward and backward (a seeded cotangent) on CUDA tensors,
    twice, against the same call on their CPU copies. The card's two runs
    agree bit for bit (the variants pool in key order, with no atomics).
    The forward's columns from ``exact_from`` on (pooled sums, or copies)
    equal the CPU's bit for bit, the head columns before them (logs of
    them) within the forward kernel's tolerance; the grads, which copy and
    gather, exactly. Returns the forward's max abs error."""
    outs = {}
    for dev in ("cuda", "cuda again", "cpu"):
        ts = [x.to(dev.split()[0]).clone() if isinstance(x, torch.Tensor)
              else x for x in inputs]
        for i in grad_of:
            ts[i].requires_grad_(True)
        y = fn(*ts)
        g = torch.from_numpy(np.random.default_rng(5).normal(
            size=tuple(y.shape)).astype(np.float32)).to(y.device)
        y.backward(g)
        outs[dev] = (y.detach().cpu(), [ts[i].grad.cpu() for i in grad_of])
    (y, gs), (y2, gs2), (cy, cgs) = (
        outs["cuda"], outs["cuda again"], outs["cpu"])
    require(torch.equal(y, y2) and all(torch.equal(a, b)
                                       for a, b in zip(gs, gs2)),
            f"{tag}: two runs on the card differ")
    err = float((y - cy).abs().max())
    require(torch.equal(y[..., exact_from:], cy[..., exact_from:]),
            f"{tag}: forward columns from {exact_from} on, card vs CPU, "
            "differ")
    require(torch.allclose(y, cy, rtol=RTOL, atol=ATOL),
            f"{tag}: forward, card vs CPU, max abs err {err}")
    require(all(torch.equal(a, b) for a, b in zip(gs, cgs)),
            f"{tag}: grads, card vs CPU, differ")
    return err


def check_variants(rng) -> dict:
    """(a) ``fused_seqpool_cvm_with_conv`` (with and without the show
    filter), ``fused_seqpool_cvm_with_pcoc`` and ``cvm`` at the training
    shape (B=2048, S=24, Npad=102,400), forward and backward on the card
    against the CPU."""
    lengths = rng.integers(1, 4, size=TB * TS)
    segs, nk = segment_layout(TB, TS, lengths, TNPAD)
    segs = torch.from_numpy(segs)
    errs = {}
    for name, width, heads in (("conv", 3 + 8, 3), ("pcoc", 4 + PCOC_P + 8,
                                                    4 + PCOC_P)):
        emb = rng.normal(size=(TNPAD, width)).astype(np.float32)
        emb[:, :heads] = rng.integers(0, 5, size=(TNPAD, heads))
        emb = torch.from_numpy(emb)
        if name == "conv":
            cvm_in = torch.from_numpy(rng.integers(
                0, 2, size=(TB, 3)).astype(np.float32))
            for show_filter in (False, True):
                errs[f"conv show_filter={show_filter}"] = variant_case(
                    f"variants conv (show_filter {show_filter})",
                    lambda e, s, c, f=show_filter: ops_fused_conv(
                        e, s, c, TB, TS, show_filter=f),
                    [emb, segs, cvm_in], (0, 2), 2 if show_filter else 3)
        else:
            cvm_in = torch.from_numpy(rng.integers(
                0, 2, size=(TB, 4)).astype(np.float32))
            q = torch.from_numpy(rng.uniform(size=(TB, PCOC_P)).astype(
                np.float32))
            errs["pcoc"] = variant_case(
                "variants pcoc", lambda e, s, c, qv: ops_fused_pcoc(
                    e, s, c, qv, TB, TS, PCOC_P), [emb, segs, cvm_in, q],
                (0, 2, 3), 2 + 2 * PCOC_P)
    x = rng.normal(size=(TB, TS, 11)).astype(np.float32)
    x[..., :2] = rng.integers(0, 9, size=(TB, TS, 2))
    cvm_in = rng.integers(0, 2, size=(TB, TS, 2)).astype(np.float32)
    for use_cvm in (True, False):
        errs[f"cvm use_cvm={use_cvm}"] = variant_case(
            f"variants cvm (use_cvm {use_cvm})",
            lambda a, c, u=use_cvm: ops_cvm(a, c, u),
            [torch.from_numpy(x), torch.from_numpy(cvm_in)], (0, 1),
            2 if use_cvm else 0)
    print(f"variants (a): fused_seqpool_cvm_with_conv, _with_pcoc "
          f"(P={PCOC_P}) and cvm at B={TB}, S={TS}, Npad={TNPAD} ({nk} "
          f"keys): two runs on the card bit for bit; forward on the card "
          f"vs the CPU: the pooled and copied columns bit for bit, the log "
          f"heads within rtol {RTOL}, atol {ATOL} (max abs err {errs}); "
          f"grads bit for bit")
    return errs


def host_loop_drive(tr, pm, files, tag: str):
    """``examples/02``'s loop on the host-table engine over HOSTLOOP_DAYS:
    each pass counted (the forward and backward once a batch), a delta
    save a pass, a base with the dense state a day, ``barrier()``."""
    fwd, bwd = seqpool_cvm_cuda.__name__, seqpool_cvm_grad_cuda.__name__
    launches = {fwd: 0, bwd: 0}
    p = 0
    for day, n_day in HOSTLOOP_DAYS:
        pm.set_date(day)
        for i in range(n_day):
            ds = (pm.begin_pass(files[p:p + 1]) if i == 0 else
                  pm.begin_pass([], preloaded=True))
            if i + 1 < n_day:
                pm.preload_next(files[p + 1:p + 2])
            n = ds.num_instances() // TB
            _, m, got = counted(lambda: tr.train_from_dataset(ds),
                                {fwd: n, bwd: n}, f"{tag} pass {p + 1}")
            require(m["ins_num"] == n * TB, f"{tag}: metrics {m}")
            for k in launches:
                launches[k] += got[k]
            pm.end_pass(save_delta=True)
            tr.reset_metrics()
            p += 1
        pm.save_base(dense_state=(tr.params, tr.opt_state))
    pm.barrier()
    return launches


def phase_rest(rng, seed: int) -> dict:
    """(4j) the seqpool variants and ``cvm`` on the card; the host-table
    ``PassManager`` loop with a resume; the host ``TrainStep`` under
    ``bf16``."""
    card = card_line()
    out = {"launches": {}, "variant_errs": check_variants(rng)}
    conf, tconf, _ = train_confs()
    fwd, bwd = seqpool_cvm_cuda.__name__, seqpool_cvm_grad_cuda.__name__

    # (b) examples/02's flow on the host-table engine, and its resume
    files = []
    for p in range(sum(n for _, n in HOSTLOOP_DAYS)):
        path = os.path.join(WORK, f"hostloop-part-{p}")
        lengths = rng.integers(1, 4, size=(HOSTLOOP_BATCHES * TB, TS))
        write_slot_lines(path, lengths, rng.integers(
            1, HOSTLOOP_VOCAB, size=int(lengths.sum()), dtype=np.uint64),
            rng.integers(0, 2, size=lengths.shape[0]))
        files.append(path)
    feed = trainer_feed_conf()
    root = os.path.join(WORK, "hostloop-model")

    def world(model):
        tr = CTRTrainer(model, feed, conf, tconf, use_device_table=False,
                        device="cuda")
        require(not tr.fused and isinstance(tr.table, EmbeddingTable),
                "host loop: the trainer did not take the host engine")
        pm = PassManager(SparsePS({"embedding": tr.table}), root,
                         [SlotDataset(feed), SlotDataset(feed)],
                         writer=TimedWriter())
        return tr, pm

    tr, pm = world(random_deepfm(rng, TS * conf.pull_dim))
    loop_s, launches = timed_secs(
        lambda: host_loop_drive(tr, pm, files, "host loop"))
    out["launches"]["host_pass_loop"] = launches
    commits = [(k, round(v, 4)) for k, v in pm._writer.commit_s]
    pm.close()
    kinds = trail_kinds(root)
    require(kinds == [(d, k) for d, n in HOSTLOOP_DAYS
                      for k in ["delta"] * n + ["base"]],
            f"host loop: donefile trail {kinds}")
    tr2, pm2 = world(random_deepfm(np.random.default_rng(97),
                                   TS * conf.pull_dim))
    resume_s, got = timed_secs(lambda: pm2.resume(
        dense_template=(tr2.params, tr2.opt_state)))
    pm2.close()
    require(got[:2] == (HOSTLOOP_DAYS[-1][0], len(files)),
            f"host loop: resumed version {got[:2]}")
    require(all(np.array_equal(a, b) for a, b in zip(
        host_rows(tr2.table), host_rows(tr.table))),
            "host loop: the resumed table differs by key")
    require_same_dense("host loop: resume vs the live trainer",
                       (tr2.params, tr2.opt_state), (tr.params, tr.opt_state))
    print(f"host loop (b): examples/02's flow with use_device_table=False, "
          f"{len(files)} passes of {HOSTLOOP_BATCHES} batches (B={TB}, "
          f"keys from [1, {HOSTLOOP_VOCAB})) over a native EmbeddingTable "
          f"of {len(tr.table)} rows: launches {launches}; trail {kinds}; a "
          f"resume into a fresh table and trainer equals the live one by "
          f"key, dense params and adam's state bit for bit; loop "
          f"{loop_s:.2f} s, writer commits s {commits}, resume "
          f"{resume_s:.4f} s [{card}]")
    del tr, tr2, pm, pm2

    # (c) phase 4f's host-table TrainStep under bf16: float32 inputs
    econf, etconf = example_confs()
    batches = csr_batches(rng, CPU_STEPS, WD_B, WD_S, WD_DENSE, HE_VOCAB)
    torch.manual_seed(seed)
    model = WideDeep(WD_S * econf.pull_dim + WD_DENSE, WD_HIDDEN)
    worlds, seen = {}, []
    for bf16 in (True, False):
        m = copy.deepcopy(model)
        m.register_forward_pre_hook(
            lambda mod, args: seen.append(tuple(a.dtype for a in args)))
        step = TrainStep(m, econf, dataclasses.replace(etconf, bf16=bf16),
                         WD_B, WD_S, WD_DENSE, device="cuda")
        table = EmbeddingTable(econf, backend="native")
        _, (state, losses), got = counted(
            lambda: host_hand_loop(step, (*step.init(),
                                          step.init_auc_state()),
                                   table, batches),
            {fwd: CPU_STEPS, bwd: CPU_STEPS}, f"host bf16 (c) bf16={bf16}")
        worlds[bf16] = host_world(losses, table, state[0])
        out["launches"][f"host_bf16_{bf16}"] = got
    require(all(d == (torch.float32, torch.float32) for d in seen),
            f"host bf16 (c): the model took inputs of {set(seen)}")
    require_same_host("host bf16 (c): TrainStep(bf16=True) vs bf16=False",
                      worlds[True], worlds[False])
    print(f"host bf16 (c): TrainStep(WideDeep, bf16=True) on the card "
          f"over {CPU_STEPS} steps of B={WD_B}: the model takes float32 "
          f"inputs ({len(seen)} calls), losses {worlds[True][0]}, rows by "
          f"key and dense params bit for bit against bf16=False")
    return out


# -- phase 4k: the tiered loop over low-precision arenas ----------------------

TIER_LP_PASSES = 2            # phase 4e's passes (day 1), cut in depth
TIER_LP = (("int8", torch.int8), ("bf16", torch.bfloat16))


def phase_tiered_arenas(rng, files) -> dict:
    """Phase 4e's tiered loop over an int8 and over a bfloat16 arena (the
    flagship, f32 dense, device prep, ``train_from_files`` run graphs,
    ``PassManager`` with ``prefetch_feed_next``), cut in depth to its
    first TIER_LP_PASSES passes, in turns with a twin that stages
    synchronously: the backings bit for bit by key. Then the last pass's
    keys staged again, and CPU_STEPS host-prep steps of that arena's twin
    on the card against the CPU. Bytes a row, W and the pass times
    printed. Returns the launches, and the int8 world's trained backing
    and weights (phase 4m serves them)."""
    card = card_line()
    conf, tconf, _ = train_confs()
    files = files[:TIER_LP_PASSES]
    out = {"launches": {}, "passes": {}, "row_bytes": {}}
    t_phase = time.perf_counter()
    for name, dtype in TIER_LP:
        tag = f"tiered {name} (4k)"
        model = random_deepfm(rng, TS * conf.pull_dim)
        main = tiered_world(conf, tconf, model,
                            os.path.join(WORK, f"tiered-{name}"),
                            saves=False, value_dtype=dtype)
        sync = tiered_world(conf, tconf, copy.deepcopy(model),
                            os.path.join(WORK, f"tiered-{name}-sync"),
                            saves=False, value_dtype=dtype)
        table = main["table"]
        require(table.values.dtype == dtype and
                main["tr"].step.device_prep, f"{tag}: the world's arena")
        gens = {"main": tiered_passes(main, files, True, "files", tag,
                                      counted=True, stop=len(files)),
                "sync": tiered_passes(sync, files, False, "files",
                                      f"{tag}, sync twin",
                                      stop=len(files))}
        recs = {"main": [], "sync": []}
        order = ("main", "sync", "sync", "main")
        for p in range(len(files)):
            for who in (order[:2] if p % 2 == 0 else order[2:]):
                quiesce(main)
                quiesce(sync)
                recs[who].append(next(gens[who]))
        for g in gens.values():
            require(next(g, None) is None, f"{tag}: passes left over")
        require(main["consumed"] == [False] + [True] * (len(files) - 1),
                f"{tag}: the consumes took {main['consumed']}")
        require(same_arrays(backing_by_key(table),
                            backing_by_key(sync["table"])),
                f"{tag}: the backing differs from the sync twin's by key")
        main["pm"].close()
        sync["pm"].close()
        variant = PUSH_VARIANTS[name].__name__
        n_steps = sum(r["steps"] for r in recs["main"])
        require(main["launches"][variant] == n_steps,
                f"{tag}: {variant} launched {main['launches'][variant]} "
                f"times in {n_steps} steps")
        out["launches"][f"tiered_{name}"] = main["launches"]
        out["passes"][name] = recs["main"]
        vb, sb = table.layout.row_bytes()
        out["row_bytes"][name] = vb + sb
        print(f"{tag}: {len(files)} passes of {TRAINER_FILE_BATCHES} "
              f"batches (B={TB}) over a TieredDeviceTable of {TIER_ARENA} "
              f"{name} rows ({vb} + {sb} = {vb + sb} B a row, arena "
              f"{table.memory_bytes()} B), device prep, run graphs, "
              f"prefetch_feed_next; launches {main['launches']}; the "
              f"backing ({len(table.backing)} rows) equals the sync twin's "
              f"by key bit for bit [{card}]")
        for who in ("main", "sync"):
            print(f"{tag} {'(prefetch)' if who == 'main' else 'sync twin'} "
                  f"per pass: W {[r['w'] for r in recs[who]]}; staging s "
                  f"{[round(r['stage_s'], 4) for r in recs[who]]}; train "
                  f"ms/step {[round(r['train_ms'], 4) for r in recs[who]]};"
                  f" end_pass s "
                  f"{[round(r['end_pass_s'], 4) for r in recs[who]]}; "
                  f"captures {[r['captures'] for r in recs[who]]} [{card}]")
        # the last pass's keys staged again from the backing; host prep
        # over a twin of that arena on the card, against the CPU
        reader = FastSlotReader(trainer_feed_conf(), buckets=BucketSpec(
            min_size=TNPAD, max_size=1 << 18))
        stream = list(reader.stream(files[-1:], drop_remainder=False))
        reader.close()
        w = table.begin_feed_pass(np.concatenate([b[0] for b in stream]))
        init = arena_of(table)
        _, out["launches"][f"tiered_{name}_host_prep"] = arena_host_prep(
            f"{tag}: host prep over the staged arena (W {w})",
            arena_twin(table, "cuda", "native", init),
            copy.deepcopy(main["tr"].params), tconf,
            [(b[0], b[1], b[3]) for b in stream[:CPU_STEPS]], name, init)
        del init
        table.end_pass()
        if name == "int8":
            out["int8_backing"] = table.backing.snapshot(reset_dirty=False)
            out["int8_model"] = main["tr"].params
        del main, sync, table
        gc.collect()
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# -- phase 4l: deferred insert -------------------------------------------------

def phase_deferred(rng, files) -> dict:
    """The flagship through ``CTRTrainer.train_from_files`` in deferred
    insert mode (``insert_mode="deferred"``: no host key work before a
    run, the device miss ring, its lagged polls and the final drain)
    over phase 4b's two files (5% new keys in the second), under run
    graphs (one eager run, one replay), every device-prep kernel once a
    batch: bit for bit against the eager deferred run loop on a twin; the
    keys the polls inserted equal the files' new keys; no ``ensure_keys``
    call and no ``train_step.ensure_keys`` span; CPU_STEPS deferred
    ``step_device`` steps of the second file (its misses on row 0) against
    the CPU, the rings equal; ms/step of the run graphs in turns with
    "ensure" mode."""
    card = card_line()
    conf, tconf, buckets = train_confs()
    feed = trainer_feed_conf()
    fbuckets = BucketSpec(min_size=TNPAD, max_size=1 << 18)
    t_phase = time.perf_counter()
    reader = FastSlotReader(feed, buckets=fbuckets)
    stream = list(reader.stream(files, drop_remainder=False))
    reader.close()
    n = len(stream)
    seen = np.unique(np.concatenate([b[0] for b in stream]))
    new_keys = seen[seen > HOT_VOCAB]
    require(n == TRAINER_FILES * TRAINER_FILE_BATCHES and new_keys.size,
            f"deferred (4l): {n} batches, {new_keys.size} new keys")
    table = DeviceTable(conf, capacity=HOT_VOCAB + 1 + TRAINER_HEADROOM,
                        uniq_buckets=buckets, device="cuda",
                        backend="native", index_threads=1)
    table.prepopulate(HOT_VOCAB)
    init = arena_of(table)
    model = random_deepfm(rng, TS * conf.pull_dim)
    run_fs = FusedTrainStep(copy.deepcopy(model), arena_twin(
        table, "cuda", "native", init), tconf, TB, TS, device_prep=True,
        insert_mode="deferred")
    run_state = (*run_fs.init(), run_fs.init_auc_state())
    trainer = CTRTrainer(copy.deepcopy(model), feed, conf, tconf,
                         table=table, buckets=fbuckets,
                         insert_mode="deferred")
    fs = trainer.step
    require(fs.device_prep and fs.insert_mode == "deferred",
            "deferred (4l): the trainer's step is not deferred device prep")
    calls = {"ensure_keys": 0, "poll_misses_async": 0, "poll_misses": 0}

    def spy(name):
        orig = getattr(table, name)

        def call(*a, **kw):
            calls[name] += 1
            return orig(*a, **kw)
        setattr(table, name, call)
    for name in calls:
        spy(name)
    row0 = (table.values[0].clone(), table.state[0].clone())
    secs, metrics, launches = count_launches(
        lambda: trainer.train_from_files(files), n, "deferred (4l)")
    require(torch.equal(table.values[0], row0[0]) and
            torch.equal(table.state[0], row0[1]),
            "deferred (4l): the null row, which the misses ride, changed")
    graphs = fs.run_graphs
    require((graphs.captures, graphs.replays) == (1, n // 16 - 1),
            f"deferred (4l): {graphs.captures} captures, {graphs.replays} "
            "replays")
    require(calls["ensure_keys"] == 0 and calls["poll_misses_async"] ==
            n // fs.DEV_CHUNK and calls["poll_misses"] >= 1,
            f"deferred (4l): host key calls {calls}")
    require(int(table.miss_cnt[0]) == 0, "deferred (4l): the ring is not "
                                         "drained")
    inserted = np.sort(table.row_keys()[HOT_VOCAB + 1:])
    require(np.array_equal(inserted, new_keys),
            f"deferred (4l): the polls inserted {inserted.size} keys, the "
            f"files hold {new_keys.size} new ones")
    run_state, _ = eager_run_loop(run_fs, run_state, stream)
    require_same_training("deferred (4l): run graphs vs the eager run loop",
                          (table, trainer.params, trainer.opt_state, None),
                          (run_fs.table, *run_state[:2], None))
    require(np.array_equal(table.row_keys(), run_fs.table.row_keys()),
            "deferred (4l): the eager run loop numbered other rows")
    calc = AucCalculator()
    calc.absorb(run_state[2])
    require(calc.compute() == metrics,
            f"deferred (4l): metrics {metrics} vs the eager run loop's "
            f"{calc.compute()}")
    require(not bool(fs.bad_flag), "deferred (4l): sentinel tripped")
    print(f"deferred (4l): train_from_files over {len(files)} files ({n} "
          f"batches, {graphs.captures} capture, {graphs.replays} replay), "
          f"launches {launches}, host key calls {calls}; row 0 bit-unchanged;"
          f" the polls inserted "
          f"{inserted.size} keys, the files' new keys exactly; rows by key, "
          f"row numbers, the dense params, adam's state and the metrics bit "
          f"for bit vs the eager deferred run loop; {secs / n * 1e3:.4f} "
          f"ms/step (first pass) [{card}]")

    # CPU_STEPS deferred steps of the second file (5% of its keys new: they
    # miss, ride row 0 and fill the ring) on a twin, against the CPU
    batches = [(b[0], b[1], b[3]) for b in
               stream[TRAINER_FILE_BATCHES:TRAINER_FILE_BATCHES + CPU_STEPS]]
    rings = []
    for device in ("cuda", "cpu"):
        twin = arena_twin(table, device, "native", init)
        tfs = FusedTrainStep(copy.deepcopy(model), twin, tconf, TB, TS,
                             device_prep=True, insert_mode="deferred")
        if device == "cuda":
            touched = touched_rows(twin, batches)
            before = snapshot_rows(twin, touched)
            _, card_losses = train_steps(
                tfs, (*tfs.init(), tfs.init_auc_state()), batches,
                tfs.step_device)
            after = snapshot_rows(twin, touched, tfs.model)
        else:
            _, cpu_losses = train_steps(
                tfs, (*tfs.init(), tfs.init_auc_state()), batches,
                tfs.step_device)
            cpu_after = snapshot_rows(twin, touched, tfs.model)
        cnt = int(twin.miss_cnt[0])
        rings.append((cnt, twin.miss_ring[:cnt].cpu().numpy()))
        del twin, tfs
        gc.collect()
    require(rings[0][0] > 0 and rings[0][0] == rings[1][0] and
            np.array_equal(rings[0][1], rings[1][1]),
            f"deferred (4l): rings card {rings[0][0]} vs CPU {rings[1][0]}")
    compare_twin("deferred (4l): card vs CPU", card_losses, after,
                 cpu_losses, cpu_after, before)
    print(f"deferred (4l): the rings after {CPU_STEPS} steps: {rings[0][0]} "
          f"misses on the card and on the CPU, equal entry for entry")
    del init

    # ms/step of the run graphs, deferred against "ensure", in turns over
    # the same batches (every key now in both tables)
    ens_fs = FusedTrainStep(copy.deepcopy(trainer.params), run_fs.table,
                            tconf, TB, TS, device_prep=True)
    worlds = {"deferred": (fs, [trainer.params, trainer.opt_state,
                                trainer.auc_state]),
              "ensure": (ens_fs, [*ens_fs.init(), ens_fs.init_auc_state()])}
    for f, st in worlds.values():          # warm-up and capture
        st[:3] = f.train_stream(*st, iter(stream))[:3]
    turns = {k: [] for k in worlds}
    for who in ("deferred", "ensure", "ensure", "deferred") * 2:
        f, st = worlds[who]
        secs, res = timed_secs(lambda: f.train_stream(*st, iter(stream)))
        st[:3] = res[:3]
        turns[who].append(secs / n * 1e3)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fs.train_stream(*worlds["deferred"][1], iter(stream))
    spans = sorted({e.key for e in prof.key_averages()
                    if e.key.startswith("train_step.")})
    require("train_step.ensure_keys" not in spans and
            "train_step.poll_misses" in spans,
            f"deferred (4l): host spans {spans}")
    print(f"timing deferred (4l): run graphs ms/step over {n} batches, in "
          f"turns: deferred {turns['deferred']}; ensure {turns['ensure']}; "
          f"the deferred pass's host spans {spans} [{card}]")
    reset_auc_state_(trainer.auc_state)
    out = {"launches": {"deferred_files": launches}, "turns_ms": turns,
           "phase_s": time.perf_counter() - t_phase}
    del worlds, trainer, run_fs, ens_fs, table
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 4m: int8 serving ---------------------------------------------------

Q8_B = 512                    # serving batch
Q8_BATCHES = 8                # batches a predict_records call
Q8_CACHE_ROWS = 1 << 16       # PBOX_FLAGS_serve_cache_rows of the cache run
# the int8 table's scores against float32 serving: the reference's pin of
# the quantization's effect (tests/test_serving_econ.py)
Q8_SCORE_TOL = 0.02


def q8_records(rng, keys: np.ndarray, feed: DataFeedConfig):
    """Q8_BATCHES * Q8_B MultiSlot records of TS slots with 1-3 keys each:
    keys drawn by a Zipf law (exponent 1.2) over ``keys`` in a random
    order, so a head repeats, and 5% unknown to the table."""
    rows = Q8_BATCHES * Q8_B
    lengths = rng.integers(1, 4, size=(rows, TS))
    nk = int(lengths.sum())
    ranked = keys[rng.permutation(keys.size)]
    drawn = ranked[np.minimum(rng.zipf(1.2, size=nk) - 1, keys.size - 1)]
    unknown = rng.uniform(size=nk) < 0.05
    drawn[unknown] = rng.integers(1 << 40, 1 << 41, size=int(unknown.sum()),
                                  dtype=np.uint64)
    path = os.path.join(WORK, "q8-serve.txt")
    write_slot_lines(path, lengths, drawn, rng.integers(0, 2, size=rows))
    parser = SlotParser(feed)
    with open(path) as f:
        return [parser.parse_line(line) for line in f]


def phase_int8_serving(rng, backing: dict, model) -> dict:
    """The flagship bundle exported from phase 4k's int8-trained table
    under ``PBOX_FLAGS_serve_quantized`` (``table.npz`` and
    ``table.q8.npz``), served at B=Q8_B through ``CTRPredictor`` three
    ways: float32 (``ServingTable``), int8 (``QuantServingTable``), int8
    with the hot-key cache and coalescing (the main path, counted: the
    forward once a batch). The int8 scores with and without the cache and
    coalescing bit for bit (cold and warm), against the CPU's int8
    predictor within SCORE_ATOL, and within Q8_SCORE_TOL of float32
    serving; ms/batch in turns; the tables' device bytes."""
    card = card_line()
    conf, _, _ = train_confs()
    feed = trainer_feed_conf()
    t_phase = time.perf_counter()
    knobs = ("serve_quantized", "serve_cache_rows", "serve_coalesce")

    def set_knobs(quantized, cache_rows, coalesce):
        for k, v in zip(knobs, (int(quantized), cache_rows, int(coalesce))):
            os.environ["PBOX_FLAGS_" + k] = str(v)
    try:
        set_knobs(True, 0, False)
        bundle = save_inference_model(os.path.join(WORK, "q8_bundle"),
                                      model, backing, feed, conf)
        require(os.path.exists(os.path.join(bundle, "table.q8.npz")),
                "int8 serving (4m): no table.q8.npz in the bundle")
        records = q8_records(rng, backing["keys"], feed)
        preds = {}
        for name, knob in (("f32", (False, 0, False)),
                           ("q8", (True, 0, False)),
                           ("q8_cache_coalesce", (True, Q8_CACHE_ROWS,
                                                  True))):
            set_knobs(*knob)
            preds[name] = CTRPredictor(bundle, device="cuda",
                                       batch_size=Q8_B)
        set_knobs(True, 0, False)
        cpu = CTRPredictor(bundle, device="cpu", batch_size=Q8_B)
    finally:
        for k in knobs:
            os.environ.pop("PBOX_FLAGS_" + k, None)
    main = preds["q8_cache_coalesce"]
    require(isinstance(preds["q8"].table, QuantServingTable) and
            isinstance(preds["f32"].table, ServingTable),
            "int8 serving (4m): the predictors' tables")
    q8 = preds["q8"].predict_records(records)
    secs, cold, launches = counted(
        lambda: main.predict_records(records),
        {seqpool_cvm_cuda.__name__: Q8_BATCHES}, "int8 serving (4m)")
    warm = main.predict_records(records)
    require(np.array_equal(cold, q8) and np.array_equal(warm, q8),
            "int8 serving (4m): the cache and coalescing changed a score")
    f32 = preds["f32"].predict_records(records)
    want = cpu.predict_records(records)
    cpu_err = float(np.abs(q8 - want).max())
    q8_err = float(np.abs(q8 - f32).max())
    require(q8.shape == (Q8_BATCHES * Q8_B,) and np.isfinite(q8).all(),
            f"int8 serving (4m): scores {q8.shape}")
    require(cpu_err <= SCORE_ATOL,
            f"int8 serving (4m): card vs CPU int8 predictor {cpu_err}")
    require(q8_err <= Q8_SCORE_TOL,
            f"int8 serving (4m): int8 vs float32 scores {q8_err}")
    stats = main.cache_stats()
    require(stats["hits"] > 0 and main.coalesced_keys > 0,
            f"int8 serving (4m): cache {stats}, coalesced "
            f"{main.coalesced_keys}")
    ft, qt = preds["f32"].table, main.table
    f32_bytes = int(ft._values.nbytes + ft._keys.nbytes)
    q8_bytes = int(qt.memory_bytes() + qt._keys.nbytes)
    print(f"int8 serving (4m): a bundle of {len(qt)} rows from the int8 "
          f"tiered table, {Q8_BATCHES} batches of {Q8_B} a call; launches "
          f"{launches}; int8 scores with the cache and coalescing, cold "
          f"and warm, bit for bit; max |card - CPU int8 predictor| "
          f"{cpu_err:.3e} (<= {SCORE_ATOL}); max |int8 - float32 serving| "
          f"{q8_err:.3e} (<= {Q8_SCORE_TOL}); cache {stats}, coalesced "
          f"{main.coalesced_keys} keys; device table bytes float32 "
          f"{f32_bytes}, int8 {q8_bytes} ({q8_bytes / f32_bytes:.3f}x) "
          f"[{card}]")
    turns = {k: [] for k in preds}
    for who in list(preds) + list(reversed(preds)):
        secs, _ = timed_secs(lambda: preds[who].predict_records(records))
        turns[who].append(secs / Q8_BATCHES * 1e3)
    print(f"timing int8 serving (4m): predict_records ms/batch (B={Q8_B}), "
          f"in turns: {turns} [{card}]")
    shutil.rmtree(bundle, ignore_errors=True)
    return {"launches": {"serve_q8": launches}, "turns_ms": turns,
            "f32_bytes": f32_bytes, "q8_bytes": q8_bytes,
            "q8_err": q8_err, "phase_s": time.perf_counter() - t_phase}


# -- phase 4n: the data feed ---------------------------------------------------

FEED_FILES = 4               # MultiSlot files of phase 4n's file passes
FEED_WORKERS = 4             # parse workers of its multi-process passes
FEED_HEADROOM = 1 << 18      # arena rows beyond the prepopulated ones
FEED_BAD_BATCHES = 2         # batches of (iii)'s file, 3 bad lines added
FEED_BAD_AT = (10, 2000, 4000)   # (iii): 0-based lines the bad ones take
FEED_INS_BATCHES = 4         # (iv): instances of each file, in batches
FEED_SPLIT = TS // 2         # (iv): slots of an instance's first part


@contextlib.contextmanager
def flag_env(**flags):
    """The reference's flags as their ``PBOX_FLAGS_*`` variables for the
    block, restored after it."""
    old = {k: os.environ.get("PBOX_FLAGS_" + k) for k in flags}
    os.environ.update({"PBOX_FLAGS_" + k: str(v) for k, v in flags.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop("PBOX_FLAGS_" + k, None)
            else:
                os.environ["PBOX_FLAGS_" + k] = v


def port_segments() -> list:
    """This process's shared-memory segments still named in /dev/shm."""
    return [n for n in os.listdir("/dev/shm")
            if n.startswith(f"{shm_fabric.PREFIX}{os.getpid()}_")]


def worker_import_s() -> Tuple[float, float]:
    """A parse worker's start: wall seconds of a fresh interpreter that
    imports ``data.fast_feed`` and loads the tokenizer, and the imports'
    own seconds; it must import no torch (no worker touches the card)."""
    code = ("import sys, time\n"
            "t = time.perf_counter()\n"
            "import paddlebox_tpu_torch.data.fast_feed\n"
            "from paddlebox_tpu_torch.ps import native\n"
            "native._load_feed()\n"
            "print(time.perf_counter() - t, 'torch' in sys.modules)")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    wall = time.perf_counter() - t0
    secs, has_torch = res.stdout.split()
    require(has_torch == "False", "data feed (4n): a parse worker's imports "
                                  "import torch")
    return wall, float(secs)


def write_instance_parts(rng, path: str, first: int, rows: int) -> dict:
    """``rows`` instances of the trainer's key mix (TS slots of 1-3 keys
    over the prepopulated rows), ids ``i<first>``.., each as two MultiSlot
    lines with a leading ``1 <ins_id>``: the label and the first
    FEED_SPLIT slots (the rest empty), then the label and the other
    slots; the lines shuffled. Returns each instance's keys, slot offsets
    and label by id."""
    lengths = rng.integers(1, 4, size=(rows, TS))
    keys = rng.integers(1, HOT_VOCAB, size=int(lengths.sum()),
                        dtype=np.uint64)
    labels = rng.integers(0, 2, size=rows)
    offs = np.concatenate([[0], np.cumsum(lengths.sum(axis=1))])
    toks, lens = keys.astype(str), lengths.astype(str)
    lines, want = [], {}
    for r in range(rows):
        ins = f"i{first + r}"
        pos = int(offs[r])
        slots = []
        for j in range(TS):
            n = int(lengths[r, j])
            slots.append(" ".join([lens[r, j], *toks[pos:pos + n]]))
            pos += n
        head = f"1 {ins} 1 {labels[r]} "
        lines.append(head + " ".join(slots[:FEED_SPLIT]) +
                     " 0" * (TS - FEED_SPLIT))
        lines.append(head + "0 " * FEED_SPLIT +
                     " ".join(slots[FEED_SPLIT:]))
        want[ins] = (keys[offs[r]:offs[r + 1]],
                     np.concatenate([[0], np.cumsum(lengths[r])]),
                     float(labels[r]))
    with open(path, "w") as f:
        f.write("\n".join(lines[i] for i in rng.permutation(len(lines)))
                + "\n")
    return want


def phase_data_feed(rng) -> dict:
    """The reference's data feed at the flagship's width (B=2048, 24
    slots, a 4,194,304-row table on device prep): (i) four seeded
    MultiSlot files of 16 batches (5% new keys in the second and fourth)
    through ``CTRTrainer.train_from_files`` with ``workers=4`` over the
    shared-memory fabric, over the pipe, and ``workers=1``, each on a
    twin of one arena and one set of weights: pass metrics, rows by key,
    the dense params and adam's state bit for bit; forward, backward,
    push, K5's sort and the fused dedup and probe once a batch; no
    segment left; (ii) the same files through ``pipe_command="cat"``
    with ``workers=4``, bit for bit against (i); (iii) a file with 3 bad
    lines trains through ``SlotDataset`` under
    ``PBOX_FLAGS_ingest_max_bad_lines=5`` with a quarantine directory,
    whose sidecar holds exactly those lines, and the default budget
    raises naming the first; (iv) two files of two-part instances
    (``parse_ins_id``) through ``set_merge_by_insid(2)`` (the merged
    records equal the instances written), ``global_shuffle`` over the two
    datasets, ``spill_to_disk`` and ``load_from_archive`` into new
    datasets, ``train_from_dataset``: bit for bit against the same
    records trained without the spill; (v) ``train_from_files`` ms/step
    at workers 1, 2 and 4 in turns, parse MB/s, a worker's start."""
    card = card_line()
    conf, tconf, buckets = train_confs()
    feed = trainer_feed_conf()
    fbuckets = BucketSpec(min_size=TNPAD, max_size=1 << 18)
    t_phase = time.perf_counter()
    os.makedirs(WORK, exist_ok=True)
    files = [os.path.join(WORK, f"feed-part-{i}") for i in range(FEED_FILES)]
    n_new = [write_trainer_file(rng, path, (i % 2) * (
        HOT_VOCAB + 1 + i * (1 << 20))) for i, path in enumerate(files)]
    write_s = time.perf_counter() - t_phase
    n = FEED_FILES * TRAINER_FILE_BATCHES
    mb = sum(os.path.getsize(f) for f in files) / 1e6
    table = DeviceTable(conf, capacity=HOT_VOCAB + 1 + FEED_HEADROOM,
                        uniq_buckets=buckets, device="cuda",
                        backend="native", index_threads=1)
    table.prepopulate(HOT_VOCAB)
    init = arena_of(table)
    model = random_deepfm(rng, TS * conf.pull_dim)

    def world(feed_conf=feed, tbl=None):
        return CTRTrainer(copy.deepcopy(model), feed_conf, conf, tconf,
                          table=tbl or arena_twin(table, "cuda", "native",
                                                  init),
                          buckets=fbuckets)

    # (i), (ii): the file passes, each counted from 0
    worlds = {"w1": world(tbl=table), "shm_w4": world(),
              "pipe_w4": world(),
              "cat_w4": world(dataclasses.replace(feed, pipe_command="cat"))}
    launches, metrics, secs = {}, {}, {}
    for tag, tr in worlds.items():
        kw = {} if tag == "w1" else {"workers": FEED_WORKERS}
        shm = "0" if tag == "pipe_w4" else "1"
        with flag_env(ingest_shm=shm):
            secs[tag], metrics[tag], launches[f"feed_files_{tag}"] = \
                count_launches(lambda: tr.train_from_files(files, **kw), n,
                               f"data feed (4n) {tag}")
        require(not port_segments(), f"data feed (4n) {tag}: segments "
                                     f"{port_segments()} left")
    want = worlds["w1"]
    require(metrics["w1"]["ins_num"] == n * TB,
            f"data feed (4n): ins_num {metrics['w1']['ins_num']}")
    for tag, tr in worlds.items():
        if tag == "w1":
            continue
        require(metrics[tag] == metrics["w1"],
                f"data feed (4n) {tag} vs workers=1: metrics "
                f"{metrics[tag]} vs {metrics['w1']}")
        require_same_training(
            f"data feed (4n) {tag} vs workers=1",
            (tr.table, tr.params, tr.opt_state, None),
            (want.table, want.params, want.opt_state, None))
    print(f"data feed (4n): wrote {FEED_FILES} files of "
          f"{TRAINER_FILE_BATCHES * TB} lines ({mb:.1f} MB; "
          f"{sum(n_new)} new keys) {write_s:.2f} s; train_from_files over "
          f"{n} batches: workers={FEED_WORKERS} over the fabric, over the "
          f"pipe and through pipe_command=\"cat\" vs workers=1: pass "
          f"metrics, all {len(table)} rows by key, the dense params and "
          f"adam's state bit for bit; launches "
          f"{launches['feed_files_shm_w4']}; no segment left; first "
          f"passes {[round(v / n * 1e3, 4) for v in secs.values()]} "
          f"ms/step [{card}]")

    # (iii) the error budget: 3 bad lines, a budget of 5 and a sidecar
    bad_path = os.path.join(WORK, "feed-bad")
    with open(files[0]) as f:
        lines = [next(f) for _ in range(FEED_BAD_BATCHES * TB)]
    bad_lines = ["1 1 x", "3 1 2", "1 0 1 7 garbage"]
    for at, text in zip(FEED_BAD_AT, bad_lines):
        lines.insert(at, text + "\n")
    with open(bad_path, "w") as f:
        f.writelines(lines)
    qdir = os.path.join(WORK, "quarantine")
    ds = SlotDataset(feed, buckets=fbuckets)
    ds.set_filelist([bad_path])
    try:
        ds.load_into_memory()
        raise RuntimeError("data feed (4n): the default budget let 3 bad "
                           "lines through")
    except ingest.IngestBudgetError as e:
        require(str(e).startswith(f"{bad_path}:{FEED_BAD_AT[0] + 1}: "),
                f"data feed (4n): the default budget's error {e}")
        default_err = str(e)
    with flag_env(ingest_max_bad_lines=5, ingest_quarantine_dir=qdir):
        ds.load_into_memory()
    require(ds.num_instances() == FEED_BAD_BATCHES * TB,
            f"data feed (4n): {ds.num_instances()} records under the budget")
    side = os.path.join(qdir, f"quarantine-{os.getpid()}.jsonl")
    with open(side) as f:
        quarantined = [json.loads(line) for line in f]
    require([(q["path"], q["lineno"], q["snippet"]) for q in quarantined]
            == [(bad_path, at + 1, text)
                for at, text in zip(FEED_BAD_AT, bad_lines)],
            f"data feed (4n): the sidecar holds {quarantined}")
    _, budget_metrics, launches["feed_budget_dataset"] = count_launches(
        lambda: want.train_from_dataset(ds), FEED_BAD_BATCHES,
        "data feed (4n) budget")
    ds.close()
    print(f"data feed (4n) budget: {len(bad_lines)} bad lines in "
          f"{FEED_BAD_BATCHES * TB + len(bad_lines)}: under "
          f"ingest_max_bad_lines=5 {ds.num_instances()} records loaded and "
          f"trained ({FEED_BAD_BATCHES} batches, launches "
          f"{launches['feed_budget_dataset']}), the sidecar holding exactly "
          f"the {len(quarantined)} bad lines; the default budget raised "
          f"{default_err.split(': ValueError')[0]!r}")

    # (iv) the dataset path: merge by instance id, the global shuffle, the
    # archive spill, train_from_dataset, against the same without the spill
    ins_feed = dataclasses.replace(feed, parse_ins_id=True)
    rows = FEED_INS_BATCHES * TB
    ins_files = [os.path.join(WORK, f"feed-ins-{i}") for i in range(2)]
    written = {}
    for i, path in enumerate(ins_files):
        written.update(write_instance_parts(rng, path, i * rows, rows))
    t_load = time.perf_counter()
    out = {}
    for mode in ("spill", "memory"):
        shards = []
        for path in ins_files:
            d = SlotDataset(ins_feed, buckets=fbuckets)
            d.set_merge_by_insid(2)
            d.set_filelist([path])
            d.load_into_memory()
            require(d.merge_dropped == 0 and d.num_instances() == rows,
                    f"data feed (4n) {mode}: merged {d.num_instances()}, "
                    f"dropped {d.merge_dropped}")
            shards.append(d)
        if mode == "spill":
            for r in (r for d in shards for r in d.records):
                k, o, label = written[r.ins_id]
                require(np.array_equal(r.uint64_feas, k) and
                        np.array_equal(r.uint64_offsets, o) and
                        r.label == label,
                        f"data feed (4n): merged {r.ins_id} is not the "
                        f"instance written")
        global_shuffle(shards)
        sizes = [d.num_instances() for d in shards]
        if mode == "spill":
            loaded = []
            for k, d in enumerate(shards):
                arc = os.path.join(WORK, f"feed-ins-{k}.pbxa")
                require(d.spill_to_disk(arc) == sizes[k],
                        "data feed (4n): spill count")
                d.close()
                back = SlotDataset(ins_feed, buckets=fbuckets)
                back.load_from_archive(arc)
                loaded.append(back)
            shards = loaded
        out[mode] = shards
    load_s = time.perf_counter() - t_load
    for a, b in zip(out["spill"], out["memory"]):
        require(a.num_instances() == b.num_instances() and all(
            np.array_equal(x.uint64_feas, y.uint64_feas) and
            np.array_equal(x.uint64_offsets, y.uint64_offsets) and
            (x.label, x.ins_id) == (y.label, y.ins_id)
            for x, y in zip(a.records, b.records)),
            "data feed (4n): the spilled records differ")
    n_ds = sum(-(-s // TB) for s in sizes)
    ds_worlds = {"spill": world(), "memory": world()}
    ds_metrics = {}
    for mode, tr in ds_worlds.items():
        _, ds_metrics[mode], launches[f"feed_dataset_{mode}"] = \
            count_launches(lambda: [tr.train_from_dataset(d)
                                    for d in out[mode]], n_ds,
                           f"data feed (4n) {mode}")
    require(ds_metrics["spill"] == ds_metrics["memory"],
            f"data feed (4n): metrics {ds_metrics}")
    a, b = ds_worlds["spill"], ds_worlds["memory"]
    require_same_training("data feed (4n): dataset path, spill vs memory",
                          (a.table, a.params, a.opt_state, None),
                          (b.table, b.params, b.opt_state, None))
    for d in out["spill"] + out["memory"]:
        d.close()
    print(f"data feed (4n) dataset: {len(written)} two-part instances in 2 "
          f"files merged (set_merge_by_insid(2): each the instance "
          f"written), shuffled over 2 datasets {sizes}, spilled and loaded "
          f"from the archive: the records and, over {n_ds} batches "
          f"(launches {launches['feed_dataset_spill']}), the metrics, rows "
          f"by key, dense params and adam's state bit for bit vs the "
          f"same without the spill; both worlds' load, merge, shuffle and "
          f"spill {load_s:.2f} s")
    del ds_worlds, out

    # (v) timing, in turns: train_from_files at workers 1, 2 and 4 (the
    # fabric) on (i)'s worlds; the parse alone; a worker's start
    turns = {1: [], 2: [], 4: []}
    trs = {1: worlds["w1"], 2: worlds["pipe_w4"], 4: worlds["shm_w4"]}
    for w in (1, 2, 4, 4, 2, 1):
        trs[w].reset_metrics()
        t, _ = timed_secs(lambda: trs[w].train_from_files(files, workers=w))
        turns[w].append(t / n * 1e3)
    reader = FastSlotReader(feed, buckets=fbuckets)
    parse_s = sum(timed_secs(lambda: reader.parse_file(f))[0]
                  for f in files)
    mp = MultiProcessReader(feed, workers=FEED_WORKERS, buckets=fbuckets)
    t0 = time.perf_counter()
    first_s = None
    for _ in mp.iter_blocks(files):
        first_s = first_s or time.perf_counter() - t0
    mp_s = time.perf_counter() - t0
    spawn_s, import_s = worker_import_s()
    require(not port_segments(), "data feed (4n): segments left")
    for tr in worlds.values():
        reset_auc_state_(tr.auc_state)
    print(f"timing data feed (4n): train_from_files ms/step over {n} "
          f"batches, in turns: workers=1 {turns[1]}; workers=2 {turns[2]}; "
          f"workers=4 {turns[4]}; parse_file {mb / parse_s:.1f} MB/s on "
          f"one thread ({parse_s:.4f} s for {mb:.1f} MB); "
          f"MultiProcessReader({FEED_WORKERS}).iter_blocks "
          f"{mb / mp_s:.1f} MB/s ({mp_s:.4f} s, the first block after "
          f"{first_s:.4f} s); a worker's start {spawn_s:.4f} s (its imports "
          f"{import_s:.4f} s, no torch) [{card}]")
    result = {"launches": launches, "turns_ms": turns,
              "parse_mb_s": mb / parse_s, "mp_mb_s": mb / mp_s,
              "spawn_s": spawn_s, "phase_s": time.perf_counter() - t_phase,
              "files": files}
    del worlds, trs, table, init
    gc.collect()
    torch.cuda.empty_cache()
    return result


# -- phase 4o: the staged device feed -----------------------------------------

STAGE_DEPTH = 2              # feed_device_prefetch of the main staged pass
STAGE_BAD_AT = 20000         # (iv): 0-based line of the malformed one
H2D_REPS = 20                # (vi): copies of a run each way, a turn
# (iii): a file over two key buckets, ending short: (batches, fewest keys a
# slot) a part; 1-3 keys a slot stay in TNPAD's bucket, 2-3 go to the next
STAGE_MIX = ((19, 1), (18, 2), (4, 1))
STAGE_MIX_ROWS = 1000        # rows of its last, partial batch
FEED_HISTS = ("feed.h2d_ms", "feed.h2d_device_ms", "feed.pack_ms",
              "feed.stage_wait_ms", "feed.ring_wait_ms")


def hist_window(before: dict) -> dict:
    """p50, p99 and count of each feed histogram over what it observed
    since ``before`` (``{name: Histogram.state()}``)."""
    out = {}
    for name in FEED_HISTS:
        counts, _, n, vmax = REGISTRY.histogram(name).state()
        c0, _, n0, _ = before[name]
        diff = [a - b for a, b in zip(counts, c0)]
        out[name] = {"count": n - n0,
                     "p50": percentile_from_counts(diff, n - n0, vmax, 0.5),
                     "p99": percentile_from_counts(diff, n - n0, vmax,
                                                   0.99)}
    return out


def write_mixed_file(rng, path: str) -> int:
    """STAGE_MIX's parts, then a partial batch of STAGE_MIX_ROWS rows, as
    MultiSlot lines of TS slots, keys uniform over the prepopulated rows.
    Returns the count of batches."""
    lengths = np.concatenate(
        [rng.integers(lo, 4, size=(b * TB, TS)) for b, lo in STAGE_MIX]
        + [rng.integers(1, 4, size=(STAGE_MIX_ROWS, TS))])
    keys = rng.integers(1, HOT_VOCAB, size=int(lengths.sum()),
                        dtype=np.uint64)
    write_slot_lines(path, lengths, keys,
                     rng.integers(0, 2, size=lengths.shape[0]))
    return sum(b for b, _ in STAGE_MIX) + 1


def feed_threads() -> list:
    return [t.name for t in threading.enumerate()
            if t.name == "device-feed" and t.is_alive()]


def h2d_turns(fs, npad: int) -> dict:
    """GB/s of one run's upload: the staged wire from pinned memory,
    non-blocking on a stream of its own, against the unstaged run's
    packed upload from pageable numpy memory as the replay copies it, in
    turns, each copy between two events."""
    L = fs.wire_len(npad)
    pinned = torch.zeros((fs.DEV_CHUNK, L), dtype=torch.int32,
                         pin_memory=True)
    dev_wire = torch.empty_like(pinned, device="cuda")
    floats = [np.zeros(TB * 4, np.float32)] * fs.DEV_CHUNK
    pageable, _ = fs._pack([[np.zeros(npad, np.int64)] * fs.DEV_CHUNK,
                            [np.zeros(npad, np.int32)] * fs.DEV_CHUNK,
                            floats])
    dev_run = torch.empty(pageable.nbytes, dtype=torch.uint8, device="cuda")
    side = torch.cuda.Stream()
    ways = {"pinned": (pinned.nbytes, lambda: dev_wire.copy_(
                pinned, non_blocking=True), side),
            "pageable": (pageable.nbytes, lambda: dev_run.copy_(
                torch.from_numpy(pageable)), torch.cuda.current_stream())}
    out = {k: [] for k in ways}
    for way in ("pinned", "pageable", "pageable", "pinned"):
        nbytes, copy, stream = ways[way]
        with torch.cuda.stream(stream):
            t0, t1 = torch.cuda.Event(True), torch.cuda.Event(True)
            t0.record()
            for _ in range(H2D_REPS):
                copy()
            t1.record()
        t1.synchronize()
        out[way].append(nbytes * H2D_REPS / (t0.elapsed_time(t1) * 1e-3)
                        / 1e9)
    return {"gb_s": out, "bytes": {k: v[0] for k, v in ways.items()}}


def phase_staged_feed(rng, files) -> dict:
    """The staged device feed at the flagship's width over phase 4n's four
    files (64 batches of B=2048, 5% new keys in the second and fourth),
    each world a twin of one arena and one set of weights: (i)
    ``train_from_files`` under ``feed_device_prefetch`` 2 (5 buffers) and
    1 with ``feed_staging_buffers`` 2, then in "deferred" mode, each bit
    for bit against the unstaged pass (metrics, rows by key, dense params,
    adam's state); (ii) ``workers=4`` over the fabric under
    ``ingest_shm_defer_recycle``, bit for bit against (i), no segment
    left; (iii) a first capture while the producer stages ahead (the
    files twice), bit for bit against two unstaged passes, then a pass
    over two key buckets ending short (STAGE_MIX) at depth 1 with 2
    buffers, bit for bit against unstaged; (iv) a
    malformed file mid-pass: its parse error re-raised, no slot held, no
    producer alive, and the next pass trains; (v) every device-prep
    kernel once a batch in each pass; (vi) ms/step staged and unstaged in
    turns, the feed's histograms, ``host_share`` of both and the H2D GB/s
    of a run from pinned memory against today's pageable copy; (vii) one
    ``PassManager`` pass under ``obs_trace_dir`` and
    ``obs_heartbeat_path``: the Chrome JSON's feed spans, one ``pass``
    and one ``end_pass`` record."""
    card = card_line()
    conf, tconf, buckets = train_confs()
    feed = trainer_feed_conf()
    fbuckets = BucketSpec(min_size=TNPAD, max_size=1 << 18)
    t_phase = time.perf_counter()
    n = len(files) * TRAINER_FILE_BATCHES
    table = DeviceTable(conf, capacity=HOT_VOCAB + 1 + FEED_HEADROOM,
                        uniq_buckets=buckets, device="cuda",
                        backend="native", index_threads=1)
    table.prepopulate(HOT_VOCAB)
    init = arena_of(table)
    model = random_deepfm(rng, TS * conf.pull_dim)

    def world(insert_mode="ensure", tbl=None):
        return CTRTrainer(copy.deepcopy(model), feed, conf, tconf,
                          table=tbl or arena_twin(table, "cuda", "native",
                                                  init),
                          buckets=fbuckets, insert_mode=insert_mode)

    def same(tag, a, b):
        require_same_training(f"staged feed (4o) {tag}",
                              (a.table, a.params, a.opt_state, None),
                              (b.table, b.params, b.opt_state, None))

    # (i), (v): the staged passes against the unstaged one, counted
    launches, metrics, secs = {}, {}, {}
    flags = {"plain": {}, "d2": dict(feed_device_prefetch=STAGE_DEPTH),
             "d1b2": dict(feed_device_prefetch=1, feed_staging_buffers=2)}
    worlds = {"plain": world(tbl=table), "d2": world(), "d1b2": world()}
    for mode in ("ensure", "deferred"):
        if mode == "deferred":
            worlds.update(plain_deferred=world("deferred"),
                          d2_deferred=world("deferred"))
            flags.update(plain_deferred={}, d2_deferred=flags["d2"])
        for tag in [t for t in worlds if t.endswith("deferred") ==
                    (mode == "deferred")]:
            tr = worlds[tag]
            with flag_env(**flags[tag]):
                secs[tag], metrics[tag], launches[f"staged_{tag}"] = \
                    count_launches(lambda: tr.train_from_files(files), n,
                                   f"staged feed (4o) {tag}")
            if tag.startswith("plain"):
                require(metrics[tag]["ins_num"] == n * TB and
                        tr._feed is None,
                        f"staged feed (4o) {tag}: {metrics[tag]}")
                continue
            f = tr._feed
            want = "plain_deferred" if mode == "deferred" else "plain"
            require(f is not None and f.ring.held == 0 and not f.producing
                    and f.buffers == (2 if tag == "d1b2" else 5),
                    f"staged feed (4o) {tag}: the feed held "
                    f"{f and f.ring.held} slots")
            require(metrics[tag] == metrics[want],
                    f"staged feed (4o) {tag}: metrics {metrics[tag]} vs "
                    f"{metrics[want]}")
            same(f"{tag} vs {want}", tr, worlds[want])
            require(not bool(tr.step.bad_flag),
                    f"staged feed (4o) {tag}: sentinel tripped")
    graphs = worlds["d2"].step.run_graphs
    require((graphs.captures, graphs.replays) == (1, n // 16 - 1),
            f"staged feed (4o): {graphs.captures} captures, "
            f"{graphs.replays} replays")
    print(f"staged feed (4o): train_from_files over {n} batches staged "
          f"(depth {STAGE_DEPTH}, 5 buffers; depth 1, 2 buffers; depth "
          f"{STAGE_DEPTH} deferred) vs unstaged: pass metrics, all "
          f"{len(table)} rows by key, the dense params and adam's state bit "
          f"for bit; every slot back, no producer left; run graphs "
          f"{graphs.captures} capture, {graphs.replays} replays; launches "
          f"{launches['staged_d2']}; first passes "
          f"{ {k: round(v / n * 1e3, 4) for k, v in secs.items()} } "
          f"ms/step [{card}]")
    for tag in ("plain_deferred", "d2_deferred"):
        del worlds[tag]
    gc.collect()

    # (ii) four parse workers over the fabric, blocks pinned to the slots
    w4 = world()
    with flag_env(ingest_shm="1", ingest_shm_defer_recycle="1",
                  **flags["d2"]):
        _, metrics["w4"], launches["staged_w4_defer"] = count_launches(
            lambda: w4.train_from_files(files, workers=FEED_WORKERS), n,
            "staged feed (4o) workers=4")
    require(not port_segments(), f"staged feed (4o) workers=4: segments "
                                 f"{port_segments()} left")
    require(metrics["w4"] == metrics["d2"] and w4._feed.ring.held == 0,
            f"staged feed (4o) workers=4: metrics {metrics['w4']}")
    same("workers=4 defer-recycle vs workers=1", w4, worlds["d2"])
    pins = w4._feed.pins
    del w4
    print(f"staged feed (4o) workers=4: {FEED_WORKERS} parse workers over "
          f"the shared-memory fabric under ingest_shm_defer_recycle=1 "
          f"({pins} block leases pinned to ring slots): bit for bit vs "
          f"workers=1 staged, no segment left, launches "
          f"{launches['staged_w4_defer']}")

    # (iii) a first capture while the producer stages ahead: the files
    # twice in one pass, against the unstaged world's second pass
    cap = world()
    with flag_env(**flags["d2"]):
        _, cap_metrics, _ = count_launches(
            lambda: cap.train_from_files(files + files), 2 * n,
            "staged feed (4o) capture")
    count_launches(lambda: worlds["plain"].train_from_files(files), n,
                   "staged feed (4o) second unstaged pass")
    note = cap._feed.captures
    require(len(note) == 1 and note[0]["staged"] >= 1 and
            note[0]["producing"],
            f"staged feed (4o): the capture's notes {note}")
    same("the files twice vs two unstaged passes", cap, worlds["plain"])
    require(cap_metrics["ins_num"] == 2 * n * TB,
            f"staged feed (4o): {cap_metrics}")
    gate_waits = cap._feed.gate_waits
    print(f"staged feed (4o) capture: the first capture made with "
          f"{note[0]['staged']} chunks staged and the producer running "
          f"(its uploads waited on the gate {gate_waits} times); "
          f"{2 * n} batches bit for bit vs two unstaged passes")

    # (iii) then, on the same twins, warm at TNPAD: a pass over two key
    # buckets whose runs end short (tails through step_device, the last
    # batch partial), at depth 1 with 2 buffers, so the ring drops a free
    # slot of one shape for the other at its cap
    mix = os.path.join(WORK, "staged-mixed")
    n_mix = write_mixed_file(rng, mix)
    mix_metrics = {}
    for tag, tr, fl in (("unstaged", worlds["plain"], {}),
                        ("staged", cap, flags["d1b2"])):
        # the metrics of one pass each: the twins' earlier passes drained
        # their AUC sums at different steps
        tr.reset_metrics()
        with flag_env(**fl):
            _, mix_metrics[tag], launches[f"staged_mixed_{tag}"] = \
                count_launches(lambda: tr.train_from_files([mix]), n_mix,
                               f"staged feed (4o) mixed {tag}")
    f = cap._feed
    require(f.buffers == 2 and f.ring.held == 0 and not f.producing and
            f.ring.reshaped >= 1,
            f"staged feed (4o) mixed: {f.buffers} buffers, "
            f"{f.ring.held} slots held, {f.ring.reshaped} reshaped")
    require(mix_metrics["staged"] == mix_metrics["unstaged"] and
            mix_metrics["staged"]["ins_num"] ==
            (n_mix - 1) * TB + STAGE_MIX_ROWS,
            f"staged feed (4o) mixed: metrics {mix_metrics}")
    same("a pass over two buckets vs unstaged", cap, worlds["plain"])
    warm = sorted(k[1] for k in cap.step.run_graphs.warm)
    reshaped = f.ring.reshaped
    del cap, f
    print(f"staged feed (4o) mixed: {n_mix} batches over two key buckets "
          f"(the run graphs' npad {warm}), the last of "
          f"{STAGE_MIX_ROWS} rows, staged at depth 1 with 2 buffers vs "
          f"unstaged: pass metrics, rows by key, dense params and adam's "
          f"state bit for bit; the ring reshaped {reshaped} slots at its "
          f"cap, every slot back; launches "
          f"{launches['staged_mixed_staged']}")

    # (iv) a producer failure mid-pass: a malformed line, under the
    # reader's budget of 0
    bad = os.path.join(WORK, "staged-bad")
    with open(files[1]) as f:
        lines = f.readlines()
    lines.insert(STAGE_BAD_AT, "1 1 x\n")
    with open(bad, "w") as f:
        f.writelines(lines)
    try:
        FastSlotReader(feed, buckets=fbuckets).parse_file(bad)
        raise RuntimeError("staged feed (4o): the malformed file parsed")
    except RuntimeError as e:
        want_err = str(e)
    fail = worlds["d1b2"]
    with flag_env(**flags["d2"]):
        try:
            fail.train_from_files([files[0], bad, files[2]])
            raise AssertionError("staged feed (4o): the failure passed")
        except RuntimeError as e:
            require(str(e) == want_err and type(e) is RuntimeError,
                    f"staged feed (4o): the pass raised {e!r}")
        f = fail._feed
        require(f.ring.held == 0 and not f.producing and not
                feed_threads(), f"staged feed (4o): after the failure "
                                f"{f.ring.held} slots held, producer "
                                f"{f.producing}, threads {feed_threads()}")
        # the failed pass's steps stay in the AUC state, undrained
        fail.reset_metrics()
        reset_auc_state_(fail.auc_state)
        _, next_metrics, launches["staged_after_failure"] = count_launches(
            lambda: fail.train_from_files(files), n,
            "staged feed (4o) after the failure")
    require(next_metrics["ins_num"] == n * TB and f.ring.held == 0,
            f"staged feed (4o): the next pass {next_metrics}")
    print(f"staged feed (4o) failure: a malformed line in the second file "
          f"re-raised {want_err!r} after the first file's run; no slot "
          f"held, no producer left; the next pass trained {n} batches")
    del worlds["d1b2"], fail

    # (vi) ms/step in turns, the feed's histograms, host_share, H2D
    tr_s, tr_u = worlds["d2"], worlds["plain"]
    before = {k: REGISTRY.histogram(k).state() for k in FEED_HISTS}
    turns = {"staged": [], "unstaged": []}
    shares = {"staged": [], "unstaged": []}
    for who in ("unstaged", "staged", "staged", "unstaged") * 2:
        tr = tr_s if who == "staged" else tr_u
        tr.reset_metrics()
        with flag_env(**(flags["d2"] if who == "staged" else {})):
            t, _ = timed_secs(lambda: tr.train_from_files(files))
        turns[who].append(t / n * 1e3)
        shares[who].append(tr.last_heartbeat.get("host_share"))
    hists = hist_window(before)
    h2d = h2d_turns(tr_s.step, TNPAD)
    print(f"timing staged feed (4o): train_from_files ms/step over {n} "
          f"batches, in turns: staged (depth {STAGE_DEPTH}) "
          f"{turns['staged']}; unstaged {turns['unstaged']}; host_share "
          f"staged {shares['staged']}, unstaged {shares['unstaged']}; feed "
          f"histograms over the staged turns (ms) "
          f"{ {k: {q: round(v, 5) for q, v in d.items()} for k, d in hists.items()} }; "
          f"one run's upload ({h2d['bytes']['pinned']} B staged from "
          f"pinned, {h2d['bytes']['pageable']} B unstaged from pageable) "
          f"GB/s in turns {h2d['gb_s']} [{card}]")

    # (vii) one PassManager pass under the trace and the heartbeat; the
    # pass's keys are fed to the table at once, so its uniques' buckets go
    # past the batch's
    tdir = os.path.join(WORK, "staged-trace")
    hb = os.path.join(WORK, "staged-hb.jsonl")
    pm_table = DeviceTable(conf, capacity=1, uniq_buckets=BucketSpec(
        min_size=TNPAD), device="cuda", backend="native", index_threads=1)
    pm_table.load_arena(*init)
    with flag_env(obs_trace_dir=tdir, obs_heartbeat_path=hb, **flags["d2"]):
        pm_tr = world(tbl=pm_table)
        pm = PassManager(SparsePS({"embedding": pm_table}),
                         os.path.join(WORK, "staged-pm"),
                         [SlotDataset(feed, buckets=fbuckets)])
        pm.set_date("20260104")
        try:
            pm.begin_pass([files[0]])
            pm_tr.train_from_files([files[0]])
            pm.end_pass()
            pm.barrier()
        finally:
            pm.close()
            obs_trace.disable()
    dumps = os.listdir(tdir)
    require(len(dumps) == 1, f"staged feed (4o): trace dumps {dumps}")
    with open(os.path.join(tdir, dumps[0])) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e["ph"] == "X"}
    with open(hb) as f:
        kinds = [json.loads(line)["hb"] for line in f]
    require({"feed.pack", "feed.h2d", "main", "ingest.fast_parse",
             "end_pass"} <= names and sorted(kinds) == ["end_pass", "pass"],
            f"staged feed (4o): trace spans {sorted(names)}, heartbeat "
            f"records {kinds}")
    print(f"staged feed (4o) obs: a PassManager pass (begin_pass, staged "
          f"train_from_files, end_pass) under obs_trace_dir and "
          f"obs_heartbeat_path: {len(events)} trace events, spans "
          f"{sorted(names)}; heartbeat records {kinds}")
    for tr in worlds.values():
        reset_auc_state_(tr.auc_state)
    result = {"launches": launches, "turns_ms": turns,
              "host_share": shares, "hists": hists, "h2d": h2d,
              "phase_s": time.perf_counter() - t_phase}
    print(f"staged feed (4o): {result['phase_s']:.1f} s")
    del worlds, tr_s, tr_u, table, init, pm_tr, pm_table, pm
    gc.collect()
    torch.cuda.empty_cache()
    return result


# -- phase 4p: the train guard, the postmortem and the section profiler -------

GUARD_FILES = 2              # 4n's first two files: 32 batches
GUARD_POISON = 9             # (b): source batch of the run_pass with NaNs
GUARD_WINDOW = 2             # (b): its quarantine window
ABORT_BATCHES = 6            # (c): batches of the aborted pass
ABORT_POISON = 2             # (c): the poisoned one among them
MIRROR_ROWS = 2 * TB         # (e): rows of the disk-tier pass's file
MIRROR_VOCAB = 1 << 19       # (e): its keys, within the tiered arena
MIRROR_PASSES = 3            # (e): reject, admit and spill, restage
BUNDLE_FILES = ["alerts.json", "crash.json", "flags.json",
                "heartbeat_tail.jsonl", "manifest.json", "metrics.json",
                "trace.json"]


class GuardBatches:
    """A fixed batch list as a dataset (``batches()``), the guard's replay
    source; ``poison`` gives the listed batches NaN labels."""

    def __init__(self, batches, poison=()):
        self._batches = [dataclasses.replace(
            b, labels=np.full_like(b.labels, np.nan)) if i in poison else b
            for i, b in enumerate(batches)]

    def batches(self):
        return iter(self._batches)


def count_path(fn, n_batches: int, tag: str, extra=()):
    """``fn()`` with every device-prep wrapper's count set to 0 just
    before it and read just after: forward, backward, push, K5's sort and
    the fused dedup and probe each launched the same count, at least once
    a batch, and the idle ones never (but ``extra``, which a profile's
    host-prep push launches). Returns (seconds, result, launches)."""
    for w in DEVICE_PREP_WRAPPERS:
        w.launches = 0
    secs, out = timed_secs(fn)
    launches = {w.__name__: w.launches for w in DEVICE_PREP_WRAPPERS}
    idle = {w.__name__ for w in DEVICE_PREP_IDLE} - set(extra)
    busy = [launches[w.__name__] for w in DEVICE_PREP_WRAPPERS
            if w.__name__ not in idle and w.__name__ not in extra]
    require(min(busy) >= n_batches and all(launches[k] == 0 for k in idle)
            and all(launches[k] > 0 for k in extra),
            f"{tag}: launches {launches}")
    return secs, out, launches


def guard_records(path: str) -> list:
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["hb"] == "guard"]


def registry_counts(prefixes) -> dict:
    return {k: v for k, v in REGISTRY.snapshot().items()
            if k.startswith(prefixes)}


def phase_guard(rng, files) -> dict:
    """(4p) The lifecycle layer at the flagship's width over phase 4n's
    first two files (32 batches of B=2048, 5% new keys in the second):
    (a) ``train_from_files`` with a ``TrainGuard`` attached (default
    policy, lag 8) against a guard-less twin: bit for bit, ms/step in
    turns, the poller's lag in steps; (b) a committed base of the
    flagship's 4,194,304-row table after one batch, then
    ``TrainGuard.run_pass`` over the 31 other batches with NaN labels in
    one (the flagship has no dense slot to poison): one ``nan`` trip at
    its source step and window, one rollback (timed), every dense leaf and
    touched row finite, and the model bit for bit with a twin restored
    from the same base and trained without the window; also (a) over
    ``train_from_dataset``, a hook call a step; (c) under ``PBOX_FLAGS_check_nan_inf`` and
    ``obs_postmortem_dir`` a new trainer's guard aborts a poisoned pass
    with ``GuardAbort`` and one bundle commits, six files and a manifest
    whose crcs verify; (d) ``profile=True`` on (a)'s twins'
    ``train_from_dataset`` over the files' batches: the
    ``log_for_profile`` line with every section (printed), the pass bit
    for bit with a ``profile=False`` twin; (e) on three short passes of a
    tiered table over a disk tier with admission, ``ps.disk.*`` and
    ``ps.ssd.*``, each ``end_pass`` record's disk deltas equal to the
    registry's, then nonzero ``ingest.*`` and ``ckpt.*`` in the registry
    since the phase began."""
    from paddlebox_tpu_torch.ckpt import atomic, discovery
    from paddlebox_tpu_torch.obs import postmortem
    from paddlebox_tpu_torch.trainer.guard import (GuardAbort, GuardPolicy,
                                                   TrainGuard)
    card = card_line()
    conf, tconf, buckets = train_confs()
    feed = trainer_feed_conf()
    fbuckets = BucketSpec(min_size=TNPAD, max_size=1 << 18)
    t_phase = time.perf_counter()
    files = files[:GUARD_FILES]
    n = GUARD_FILES * TRAINER_FILE_BATCHES
    marks = registry_counts(("ingest.", "ckpt."))
    table = DeviceTable(conf, capacity=HOT_VOCAB + 1 + FEED_HEADROOM,
                        uniq_buckets=buckets, device="cuda",
                        backend="native", index_threads=1)
    table.prepopulate(HOT_VOCAB)
    init = arena_of(table)
    model = random_deepfm(rng, TS * conf.pull_dim)

    def world(tbl=None):
        return CTRTrainer(copy.deepcopy(model), feed, conf, tconf,
                          table=tbl if tbl is not None else arena_twin(
                              table, "cuda", "native", init),
                          buckets=fbuckets)

    def same(tag, a, b):
        require_same_training(f"guard (4p) {tag}",
                              (a.table, a.params, a.opt_state, None),
                              (b.table, b.params, b.opt_state, None))

    # (a) guard on against guard off
    plain, guarded = world(tbl=table), world()
    trips0 = REGISTRY.counter("guard.trips").get()
    guard = TrainGuard(guarded, policy=GuardPolicy()).attach()
    launches, metrics = {}, {}
    for tag, tr in (("guard_off", plain), ("guard_on", guarded)):
        _, metrics[tag], launches[f"guard_{tag}_files"] = count_launches(
            lambda: tr.train_from_files(files), n, f"guard (4p) {tag}")
    require(metrics["guard_on"] == metrics["guard_off"],
            f"guard (4p): metrics {metrics}")
    same("files guard on vs off", guarded, plain)
    # the cost on one world: the guard attached and detached in turns,
    # its hook's host time taken around each call
    turns = {"guard_on": [], "guard_off": []}
    guard.lags.clear()
    hook_us = {"files": [], "dataset": [], "run_pass": []}

    def timed_hook(guard, where):
        def hook(k, bad, loss, hook=guard._on_step_outputs):
            t0 = time.perf_counter()
            hook(k, bad, loss)
            hook_us[where].append((time.perf_counter() - t0) * 1e6)
        return hook
    guard.detach()
    for who in ("guard_off", "guard_on", "guard_on", "guard_off") * 2:
        if who == "guard_on":
            guard.attach()
            guarded.step.set_sentinel(timed_hook(guard, "files"))
        guarded.reset_metrics()
        t, _ = timed_secs(lambda: guarded.train_from_files(files))
        turns[who].append(t / n * 1e3)
        guard.detach()
    lags = sorted(guard.lags)
    guard.lags.clear()
    # the eager entry, where the hook runs every step
    batches = list(FastSlotReader(feed, buckets=fbuckets).batches(files))
    require(len(batches) == n, f"guard (4p): {len(batches)} batches")
    eager = {"guard_on": [], "guard_off": []}
    for who in ("guard_off", "guard_on", "guard_on", "guard_off"):
        if who == "guard_on":
            guard.attach()
            guarded.step.set_sentinel(timed_hook(guard, "dataset"))
        guarded.reset_metrics()
        t, _ = timed_secs(lambda: guarded.train_from_dataset(
            GuardBatches(batches)))
        eager[who].append(t / n * 1e3)
        guard.detach()
    plain.reset_metrics()
    for _ in range(len(turns["guard_on"]) + len(turns["guard_off"])):
        plain.train_from_files(files)
    for _ in range(len(eager["guard_on"]) + len(eager["guard_off"])):
        plain.train_from_dataset(GuardBatches(batches))
    same("guard on vs off, after the turns", guarded, plain)
    eager_lags = sorted(guard.lags)
    trips = REGISTRY.counter("guard.trips").get() - trips0
    require(len(lags) == 4 * (n // FusedTrainStep.DEV_CHUNK) and
            len(eager_lags) == 2 * n and
            trips == 0, f"guard (4p): lags {lags}, trips {trips}")
    print(f"guard (4p) overhead: train_from_files over {n} batches with a "
          f"TrainGuard attached (lag {guard.policy.lag}) vs a guard-less "
          f"twin: metrics, rows by key, dense params and adam's state bit "
          f"for bit; ms/step of one world in turns, the guard attached and "
          f"detached: on {turns['guard_on']}, off "
          f"{turns['guard_off']}; the poller read {len(lags)} entries (a "
          f"run of 16 each) at a lag of {lags[0]}-{lags[-1]} steps "
          f"(median {lags[len(lags) // 2]}); launches "
          f"{launches['guard_guard_on_files']}; on the dataset passes "
          f"{len(eager_lags)} entries (a step each) at a lag of "
          f"{eager_lags[0]}-{eager_lags[-1]} (median "
          f"{eager_lags[len(eager_lags) // 2]}); the hook's host time "
          f"(us, a run of 16 each) p50 "
          f"{np.percentile(hook_us['files'], 50):.1f}, max "
          f"{max(hook_us['files']):.1f} over {len(hook_us['files'])} calls; "
          f"train_from_dataset ms/step in turns (a hook call a step): on "
          f"{eager['guard_on']}, off {eager['guard_off']}, the hook p50 "
          f"{np.percentile(hook_us['dataset'], 50):.1f} us, p90 "
          f"{np.percentile(hook_us['dataset'], 90):.1f} [{card}]")

    # (b) a rollback: a base after one batch, then a poisoned run_pass

    rb, twin = world(), world()
    root = os.path.join(WORK, "guard-model")
    pm = PassManager(SparsePS({"embedding": rb.table}), root,
                     [SlotDataset(feed, buckets=fbuckets)])
    pm.set_date("20260105")
    for tr in (rb, twin):
        tr.train_from_dataset(GuardBatches(batches[:1]))
    pm.pass_id = 1
    pm.save_base(dense_state=(rb.params, rb.opt_state), wait=True)
    base_rows = len(rb.table)
    hb = os.path.join(WORK, "guard-hb.jsonl")
    guard = TrainGuard(rb, pass_manager=pm, policy=GuardPolicy(
        on_nan="rollback", quarantine_window=GUARD_WINDOW)).attach()
    rb.step.set_sentinel(timed_hook(guard, "run_pass"))
    rollback_s = []
    rollback = guard._rollback

    def timed_rollback(trip):
        s, _ = timed_secs(lambda: rollback(trip))
        rollback_s.append(s)
    guard._rollback = timed_rollback
    r0 = {k: REGISTRY.counter(k).get() for k in
          ("guard.trips_nan", "guard.rollbacks")}
    with flag_env(obs_heartbeat_path=hb):
        pass_s, out, launches["guard_rollback"] = count_path(
            lambda: guard.run_pass(GuardBatches(batches[1:],
                                                (GUARD_POISON,))),
            n - 1, "guard (4p) rollback")
    guard.detach()
    pm.close()
    recs = guard_records(hb)
    trip = recs[0]
    require([r["event"] for r in recs] == ["trip", "rollback", "pass"] and
            (trip["detector"], trip["step"], trip["window"]) ==
            ("nan", GUARD_POISON, [GUARD_POISON,
                                   GUARD_POISON + GUARD_WINDOW]) and
            {k: REGISTRY.counter(k).get() - v for k, v in r0.items()} ==
            {"guard.trips_nan": 1, "guard.rollbacks": 1} and
            len(rollback_s) == 1,
            f"guard (4p) rollback: records {recs}")
    # the batches the model trained: the base's, then all but the window
    rest = [b for i, b in enumerate(batches[1:])
            if not GUARD_POISON <= i < GUARD_POISON + GUARD_WINDOW]
    touched = key_rows(rb.table, np.unique(np.concatenate(
        [b.keys[:b.num_keys] for b in batches[:1] + rest])))
    require(all(bool(torch.isfinite(p).all())
                for p in rb.params.parameters()) and
            bool(torch.isfinite(rb.table.values[touched.cuda()]).all()) and
            bool(torch.isfinite(rb.table.state[touched.cuda()]).all()),
            "guard (4p) rollback: a non-finite value")
    plan = discovery.latest_committed(root)
    discovery.apply_plan(SparsePS({"embedding": twin.table}), plan)
    discovery.load_dense(plan, (twin.params, twin.opt_state))
    reset_auc_state_(twin.auc_state)
    twin.reset_metrics()
    twin_out = twin.train_from_dataset(GuardBatches(rest))
    same("rollback vs a twin restored from the base", rb, twin)
    require(out == twin_out, f"guard (4p) rollback: metrics {out} vs "
                             f"{twin_out}")
    print(f"guard (4p) rollback: a base of {base_rows} rows after one "
          f"batch, then TrainGuard.run_pass over {n - 1} batches with NaN "
          f"labels in source batch {GUARD_POISON}: one nan trip at step "
          f"{trip['step']} window {trip['window']}, one rollback in "
          f"{rollback_s[0]:.4f} s, the pass in {pass_s:.3f} s; every dense "
          f"leaf and the {touched.numel()} rows the batches touch finite; "
          f"all {len(rb.table)} rows by key, dense "
          f"params and adam's state bit for bit with a twin restored from "
          f"the base and trained on the {len(rest)} batches outside the "
          f"window; launches {launches['guard_rollback']}; the hook's host "
          f"time (us, a step each) p50 "
          f"{np.percentile(hook_us['run_pass'], 50):.1f}, p90 "
          f"{np.percentile(hook_us['run_pass'], 90):.1f}, max "
          f"{max(hook_us['run_pass']):.1f} over "
          f"{len(hook_us['run_pass'])} calls [{card}]")

    # (c) check_nan_inf: the trainer's own guard aborts, one bundle
    pmdir = os.path.join(WORK, "guard-postmortem")
    with flag_env(check_nan_inf="1", obs_postmortem_dir=pmdir):
        ab = world(tbl=rb.table)
        require(ab._guard is not None and
                ab._guard.policy.action_for("nan") == "abort",
                "guard (4p): no abort guard under check_nan_inf")
        try:
            ab.train_from_dataset(GuardBatches(batches[:ABORT_BATCHES],
                                               (ABORT_POISON,)))
            raise AssertionError("guard (4p): the poisoned pass finished")
        except GuardAbort as e:
            abort = e
        finally:
            ab._guard.detach()
    bundles = os.listdir(pmdir)
    require(len(bundles) == 1, f"guard (4p): bundles {bundles}")
    bundle = os.path.join(pmdir, bundles[0])
    atomic.verify(bundle, require_manifest=True)
    with open(os.path.join(bundle, "crash.json")) as f:
        crash = json.load(f)
    require(sorted(os.listdir(bundle)) == BUNDLE_FILES and
            crash["exception"]["type"] == "GuardAbort" and
            abort.trip.step == ABORT_POISON,
            f"guard (4p) abort: {os.listdir(bundle)}, {crash['reason']}")
    del ab, rb, twin
    print(f"guard (4p) abort: under check_nan_inf a new trainer's guard "
          f"raised GuardAbort at step {abort.trip.step} of "
          f"{ABORT_BATCHES}; one postmortem bundle ({crash['reason']}): "
          f"{sorted(os.listdir(bundle))}, its manifest's crcs verified")

    # (d) the section profile on (a)'s twins
    err = io.StringIO()
    for tr in (plain, guarded):
        tr.reset_metrics()
    with flag_env(profile_trainer="1"), contextlib.redirect_stderr(err):
        _, prof_out, launches["guard_profile"] = count_path(
            lambda: guarded.train_from_dataset(GuardBatches(batches)), n,
            "guard (4p) profile", extra=(merge_offsets.__name__,))
    plain_out = plain.train_from_dataset(GuardBatches(batches))
    (line,) = [x for x in err.getvalue().splitlines()
               if x.startswith("log_for_profile")]
    sections = guarded.last_heartbeat["sections"]
    require(all(f"{k[:-3]}=" in line for k in sections) and
            len(sections) == 9 and sections["step_total_ms"] > 0,
            f"guard (4p) profile: {line}")
    require(prof_out == plain_out, f"guard (4p) profile: metrics "
                                   f"{prof_out} vs {plain_out}")
    same("profile=True vs profile=False", guarded, plain)
    print(line)
    print(f"guard (4p) profile: train_from_dataset over {n} batches with "
          f"profile=True (sections of the first batch, ms: {sections}) vs "
          f"profile=False: metrics, rows by key, dense params and adam's "
          f"state bit for bit; launches {launches['guard_profile']} "
          f"[{card}]")
    del plain, guarded, table, init

    # (e) the mirrors: three short disk-tier passes (a pass admits a key
    # at its second show: the first rejects, the second admits and
    # spills, the third restages from disk), then the ingest and
    # checkpoint counts since the phase began
    small = os.path.join(WORK, "guard-disk-part")
    lengths = rng.integers(1, 4, size=(MIRROR_ROWS, TS))
    write_slot_lines(small, lengths,
                     rng.integers(1, MIRROR_VOCAB, size=int(lengths.sum()),
                                  dtype=np.uint64),
                     rng.integers(0, 2, size=MIRROR_ROWS))
    with flag_env(ps_admit_shows="2"):
        dw = tiered_world(conf, tconf, copy.deepcopy(model),
                          os.path.join(WORK, "guard-disk-model"),
                          saves=False,
                          disk_root=os.path.join(WORK, "guard-disk-ssd"))
    names = [f"ps.disk.{k}" for k in ("bloom_hit", "bloom_miss",
                                      "admit_admitted", "admit_rejected")]
    ssd0 = registry_counts(("ps.ssd.",))
    disk_recs = []
    for p in range(MIRROR_PASSES):
        before = {k: REGISTRY.counter(k).get() for k in names}
        ds = dw["pm"].begin_pass([small])
        _, _, launches[f"guard_disk_{p}"] = count_path(
            lambda: dw["tr"].train_from_dataset(ds), MIRROR_ROWS // TB,
            f"guard (4p) disk pass {p}")
        dw["pm"].end_pass()
        quiesce(dw)
        dw["disk"].evict_cold(show_threshold=float("inf"))
        dw["disk"].compact()
        got = dw["pm"].last_heartbeat["disk"]
        want = {k.rsplit(".", 1)[-1]: REGISTRY.counter(k).get() - before[k]
                for k in names}
        require({k: got[k] for k in want} == want,
                f"guard (4p) end_pass disk {got} vs registry {want}")
        disk_recs.append(want)
    dw["pm"].close()
    ssd = {k: v - ssd0.get(k, 0)
           for k, v in registry_counts(("ps.ssd.",)).items()
           if not k.endswith((".sum", ".p50", ".p95", ".p99", ".max"))}
    require(all(ssd.get(k, 0) > 0 for k in (
        "ps.ssd.spill_bytes", "ps.ssd.spill_rows", "ps.ssd.stage_bytes",
        "ps.ssd.compactions")) and disk_recs[0]["admit_rejected"] > 0 and
            disk_recs[1]["admit_admitted"] > 0 and
            disk_recs[2]["bloom_hit"] > 0,
            f"guard (4p) disk mirrors: {ssd}, {disk_recs}")
    now = registry_counts(("ingest.", "ckpt."))
    grown = {k: v - marks.get(k, 0) for k, v in now.items()
             if v != marks.get(k, 0) and not k.endswith(
                 (".sum", ".p50", ".p95", ".p99", ".max"))
             and k not in ("ingest.records_in_memory", "ckpt.queue_depth")}
    require(grown.get("ingest.lines_ok", 0) > 0 and
            grown.get("ingest.files_ok", 0) > 0 and
            grown.get("ckpt.jobs_ok", 0) >= 1,
            f"guard (4p) mirrors: {grown}")
    print(f"guard (4p) mirrors: {MIRROR_PASSES} disk-tier passes of "
          f"{MIRROR_ROWS} rows (admission at 2 shows): end_pass disk "
          f"deltas = the registry's {disk_recs}; ps.ssd.* {ssd}; ingest "
          f"and ckpt since the phase began {dict(sorted(grown.items()))}")
    del dw
    result = {"launches": launches, "turns_ms": turns, "eager_ms": eager,
              "lags": lags, "eager_lags": eager_lags,
              "hook_us": hook_us,
              "rollback_s": rollback_s[0], "sections": sections,
              "phase_s": time.perf_counter() - t_phase}
    print(f"guard (4p): {result['phase_s']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return result


# -- phase 4q: the single-host serving tier -----------------------------------

SRV_CLIENTS = 4             # concurrent connections of 4q's traffic
SRV_DAY = "20260901"        # the day of 4q's checkpoint trail
SRV_REWRITE = 0.05          # share of the table's rows the delta rewrites
SRV_NEW = 10_000            # new keys of the delta
SRV_SHED_MS = 1.0           # the shed rule's p99 threshold: a request of
#                              512 lines takes longer (its parse alone)


def criteo_lines(batch) -> list:
    """The MultiSlot text lines of a Criteo batch's rows, in the slot order
    of ``criteo_feed_config`` (label, the 13 dense values, then one key
    group a categorical slot)."""
    offs = np.concatenate([[0], np.cumsum(batch.lengths.reshape(-1))])
    keys = batch.keys.tolist()
    out = []
    for r in range(batch.num_rows):
        parts = [f"1 {float(batch.labels[r])!r}",
                 f"{batch.dense.shape[1]} " + " ".join(
                     repr(float(x)) for x in batch.dense[r])]
        for s in range(batch.num_slots):
            i = r * batch.num_slots + s
            ks = keys[offs[i]:offs[i + 1]]
            parts.append(" ".join(map(str, [len(ks), *ks])))
        out.append(" ".join(parts))
    return out


def traffic(address, chunks, clients: int = SRV_CLIENTS,
            deadline_ms: float = 60000.0):
    """Each chunk one ``predict_lines`` request, from ``clients``
    connections at once (client c sends chunks c, c + clients, ...).
    Returns the scores in chunk order, each request's ms, the wall seconds
    and the failures."""
    scores = [None] * len(chunks)
    lat, failures = [], []
    lock = threading.Lock()

    def client(c):
        for i in range(c, len(chunks), clients):
            t0 = time.perf_counter()
            try:
                s = predict_lines(*address, chunks[i],
                                  deadline_ms=deadline_ms)
            except Exception as e:  # noqa: BLE001 - reported, then required
                with lock:
                    failures.append(f"{type(e).__name__}: {e}")
                continue
            with lock:
                lat.append((time.perf_counter() - t0) * 1e3)
            scores[i] = s

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return scores, lat, time.perf_counter() - t0, failures


def direct_turn(pred, chunks):
    """``predict_records`` of each chunk in turn, as one caller would:
    (scores, each call's ms, wall seconds)."""
    out, lat = [], []
    t0 = time.perf_counter()
    for recs in chunks:
        t1 = time.perf_counter()
        out.append(pred.predict_records(recs))
        lat.append((time.perf_counter() - t1) * 1e3)
    return out, lat, time.perf_counter() - t0


def lat_summary(lat, rows: int, secs: float) -> dict:
    return {"p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "examples_per_s": rows / secs}


def served_in_turns(tag: str, first: dict, address, line_chunks, pred,
                    rec_chunks, card: str) -> dict:
    """The served path and a direct ``predict_records`` of the same
    records, in turns: ``first`` (the counted served run), direct, direct,
    served."""
    rows = sum(len(c) for c in line_chunks)
    runs = {"served": [first], "direct": []}
    for which in ("direct", "direct", "served"):
        if which == "served":
            _s, lat, secs, failures = traffic(address, line_chunks)
            require(not failures, f"{tag}: {failures[:3]}")
        else:
            _s, lat, secs = direct_turn(pred, rec_chunks)
        runs[which].append(lat_summary(lat, rows, secs))
    shown = {w: [{k: round(v, 4) for k, v in r.items()} for r in rs]
             for w, rs in runs.items()}
    print(f"timing {tag}: {len(line_chunks)} requests of {B} lines from "
          f"{SRV_CLIENTS} connections, in turns with a direct "
          f"predict_records of each {B} records: served {shown['served']}; "
          f"direct {shown['direct']} [{card}]")
    return runs


def child_launches(fleet) -> float:
    """The children's seqpool launches, as their side channels last
    reported them."""
    return sum(REGISTRY.gauge(
        f"serving.replica.{r.name}.child.serve.launches.seqpool_cvm_cuda"
    ).get() for r in fleet.replicas)


def wait_until(cond, timeout: float = 20.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def same_scores(tag: str, got, want) -> Tuple[float, bool]:
    got, want = np.concatenate(got), np.concatenate(want)
    require(got.shape == want.shape and bool(np.isfinite(got).all()),
            f"{tag}: scores {got.shape} vs {want.shape}")
    err = float(np.abs(got - want).max())
    require(err <= 1e-6, f"{tag}: |served - direct CTRPredictor| = {err}")
    return err, bool(np.array_equal(got.view(np.uint32),
                                    want.view(np.uint32)))


def per_replica_scores(fleet, records) -> list:
    """``records`` scored once on each replica (its batcher directly)."""
    return [r.submit(records, time.monotonic() + 60.0).result(60.0)
            for r in fleet.replicas]


def parse_prometheus(text: str) -> dict:
    """``name{labels} value`` samples of a Prometheus text page; raises on
    a line that is neither a sample nor a comment."""
    out = {}
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        name, value = ln.rsplit(" ", 1)
        require(re.fullmatch(r'[a-zA-Z_:][a-zA-Z0-9_:]*(\{le="[^"]+"\})?',
                             name) is not None, f"prometheus line {ln!r}")
        out[name] = float(value)
    return out


def http_status(address, path: str) -> Tuple[int, dict]:
    url = f"http://{address[0]}:{address[1]}{path}"
    try:
        rep = urllib.request.urlopen(url, timeout=10)
        return rep.status, json.loads(rep.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def phase_serving_tier(rng, bundle: str, batches) -> dict:
    """(4q) The single-host serving tier over phase 3's flagship bundle
    (DeepFM 512-256-128, 26 Criteo slots + 13 dense, B=512, a table of
    4,194,304 rows) on the card: (a) ``PredictServer``; (b) a thread-scope
    ``ReplicaSet`` of 2 behind a ``FrontDoor``, then a ``ReloadWatcher``
    over a trail the port's ``PassManager`` commits (a base of the whole
    table with new dense weights, then a delta rewriting 5% of the rows
    and adding new keys) swapping to the next pass under traffic; (c) a
    process-scope ``ReplicaSet`` of 2 children, a SIGKILL under traffic,
    the monitor's restart, a reload in the children; (d) a shed rule on
    the process fleet's p99, its 503, and ``/metrics``. Each tier serves
    16 requests of 512 lines from 4 connections, counted: the seqpool
    kernel once a request (in the children by their side channels), the
    scores within 1e-6 of a direct ``CTRPredictor``."""
    from paddlebox_tpu_torch.ckpt import discovery
    from paddlebox_tpu_torch.obs.slo import Rule, SloEngine
    from paddlebox_tpu_torch.serving import (FrontDoor, ReloadWatcher,
                                             ReplicaSet, SheddingLoad)
    from paddlebox_tpu_torch.serving.reload import load_predictor_from_plan
    card = card_line()
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    line_chunks = [criteo_lines(b) for b in batches]
    direct = CTRPredictor(bundle, device="cuda")
    parser = SlotParser(direct.feed_conf)
    rec_chunks = [[parser.parse_line(ln) for ln in c] for c in line_chunks]
    want = [direct.predict_records(c) for c in rec_chunks]
    conf = direct.table_conf
    print(f"serving tier (4q): {len(line_chunks)} requests of {B} lines, a "
          f"direct CTRPredictor's scores {time.perf_counter() - t0:.2f} s")

    # the checkpoint trail: a base of the whole table with new dense
    # weights, committed in the background while (a) runs
    t0 = time.perf_counter()
    root = os.path.join(WORK, "tier_ckpt")
    table = EmbeddingTable(conf)
    with np.load(os.path.join(bundle, "table.npz")) as snap:
        table_keys = snap["keys"]
        table.import_rows(table_keys, snap["values"], snap["state"])
    base_model = random_deepfm(rng, S * conf.pull_dim + 13)
    pm = PassManager(SparsePS({"embedding": table}), root,
                     [SlotDataset(direct.feed_conf)])
    pm.set_date(SRV_DAY)
    pm.pass_id = 1
    pm.save_base(dense_state=(base_model, {}))
    print(f"serving tier (4q): trail base of {len(table)} rows queued "
          f"{time.perf_counter() - t0:.2f} s")

    # (a) PredictServer
    srv = PredictServer(bundle, device="cuda")
    with srv:
        _s, _l, _t, failures = traffic((srv.host, srv.port),
                                       line_chunks[:1])         # warm-up
        require(not failures, f"(a) warm-up failures {failures[:3]}")
        seqpool_cvm_cuda.launches = 0
        got, lat, secs, failures = traffic((srv.host, srv.port), line_chunks)
        launches_a = seqpool_cvm_cuda.launches
        require(not failures, f"(a) failures {failures[:3]}")
        require(launches_a == len(line_chunks),
                f"(a) seqpool launched {launches_a} times for "
                f"{len(line_chunks)} requests of {B}")
        err_a, bits_a = same_scores("(a)", got, want)
        first = lat_summary(lat, B * len(line_chunks), secs)
        print(f"serving tier (4q) (a) PredictServer: {len(line_chunks)} "
              f"requests, seqpool launches {launches_a}, max |served - "
              f"direct| {err_a:.3e}, bits equal {bits_a} [{card}]")
        turns_a = served_in_turns("serving tier (4q) (a) PredictServer",
                                  first, (srv.host, srv.port), line_chunks,
                                  direct, rec_chunks, card)
    del srv
    gc.collect()
    torch.cuda.empty_cache()

    # (c) a process-scope fleet: two children on the card (the
    # base's commit goes on meanwhile)
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    pfleet = ReplicaSet.from_bundle(bundle, replicas=2, scope="process",
                                    device="cuda", probe_interval=3600.0)
    spawn_s = time.perf_counter() - t0
    free1 = torch.cuda.mem_get_info()[0]
    per_child = (free0 - free1) / 2
    spawns = [r.spawn_timing for r in pfleet.replicas]
    print(f"serving tier (4q) (c) process fleet of 2: spawned at once in "
          f"{spawn_s:.3f} s; a child's split "
          f"{[{k: round(v, 3) for k, v in t.items()} for t in spawns]} "
          f"(start: interpreter and imports to the child's main; context: "
          f"its CUDA context; build: the bundle's load and upload); device "
          f"memory a child {per_child:.0f} B (free memory before and after "
          f"the spawn) [{card}]")
    engine = SloEngine(registry=REGISTRY, interval=3600.0)
    pfleet.start(metrics_port=0)
    try:
        door = FrontDoor(pfleet)
        door.start()
        pfleet.warm(line_chunks[0])
        # each child's count to 0 just before the run, read just after
        for r in pfleet.replicas:
            r.launch_counts(reset=True)
        require(wait_until(lambda: child_launches(pfleet) == 0),
                "(c) the children's reset counts never reached the parent")
        got, lat, secs, failures = traffic(door.address, line_chunks)
        require(not failures, f"(c) failures {failures[:3]}")
        launches_c = sum(r.launch_counts()["seqpool_cvm_cuda"]
                         for r in pfleet.replicas)
        require(launches_c == len(line_chunks),
                f"(c) the children launched seqpool {launches_c} times for "
                f"{len(line_chunks)} requests")
        require(wait_until(lambda: child_launches(pfleet) == launches_c),
                f"(c) the side channels carried {child_launches(pfleet)} "
                f"launches, the children counted {launches_c}")
        err_c, bits_c = same_scores("(c)", got, want)
        first = lat_summary(lat, B * len(line_chunks), secs)
        print(f"serving tier (4q) (c) process fleet behind a FrontDoor: "
              f"seqpool launches in the children {launches_c}, max |served "
              f"- direct| {err_c:.3e}, bits equal {bits_c} [{card}]")
        turns_c = served_in_turns("serving tier (4q) (c) process fleet",
                                  first, door.address, line_chunks, direct,
                                  rec_chunks, card)
        # SIGKILL a child under traffic
        deaths = REGISTRY.counter("serving.proc_child_deaths").get()
        victim = pfleet.replicas[0]
        box = {}
        th = threading.Thread(target=lambda: box.update(zip(
            ("scores", "lat", "secs", "failures"),
            traffic(door.address, line_chunks))))
        th.start()
        require(wait_until(lambda: victim.outstanding() > 0, 10.0),
                "(c) no request reached the victim")
        free_live = torch.cuda.mem_get_info()[0]
        victim.kill()
        th.join()
        require(not box["failures"],
                f"(c) failures with a child killed {box['failures'][:3]}")
        err_k, _ = same_scores("(c) kill", box["scores"], want)
        require(REGISTRY.counter("serving.proc_child_deaths").get()
                == deaths + 1, "(c) the death was not counted")
        require(wait_until(lambda: not victim._proc.is_alive()),
                "(c) the killed child was not reaped")
        require(wait_until(lambda: torch.cuda.mem_get_info()[0] - free_live
                           >= 0.5 * per_child),
                "(c) the killed child's memory was not released")
        freed = torch.cuda.mem_get_info()[0] - free_live
        t0 = time.perf_counter()
        require(pfleet._probe_once() == 1, "(c) the monitor restarted none")
        restart_s = time.perf_counter() - t0
        require(pfleet.healthy_count() == 2 and
                pfleet.replicas[0].child_pid != victim.child_pid,
                "(c) the slot did not come back")
        require(pfleet.supervisor.state("r0")["circuit"] == "closed",
                "(c) the supervisor opened the circuit")
        restarted = pfleet.replicas[0].spawn_timing
        print(f"serving tier (4q) (c) SIGKILL of child {victim.child_pid} "
              f"under traffic: {len(box['lat'])} requests answered, 0 "
              f"failed, max |served - direct| {err_k:.3e}, "
              f"serving.rerouted {REGISTRY.counter('serving.rerouted').get()}"
              f"; its memory released ({freed} B back); the monitor's tick "
              f"restarted it in {restart_s:.3f} s (split "
              f"{ {k: round(v, 3) for k, v in restarted.items()} }) "
              f"[{card}]")
        t_b = time.perf_counter()
        pm.barrier()
        print(f"serving tier (4q): the base committed (the training thread "
              f"waited {time.perf_counter() - t_b:.2f} s in barrier())")

        # (b) a thread-scope fleet behind a front door, and its reload
        fleet = ReplicaSet.from_bundle(bundle, replicas=2, scope="thread",
                                       device="cuda")
        with fleet, FrontDoor(fleet) as tdoor:
            fleet.warm(line_chunks[0])
            seqpool_cvm_cuda.launches = 0
            got, lat, secs, failures = traffic(tdoor.address, line_chunks)
            launches_b = seqpool_cvm_cuda.launches
            require(not failures, f"(b) failures {failures[:3]}")
            require(launches_b == len(line_chunks),
                    f"(b) seqpool launched {launches_b} times for "
                    f"{len(line_chunks)} requests")
            err_b, bits_b = same_scores("(b)", got, want)
            first = lat_summary(lat, B * len(line_chunks), secs)
            print(f"serving tier (4q) (b) thread fleet of 2 behind a "
                  f"FrontDoor: seqpool launches {launches_b}, max |served - "
                  f"direct| {err_b:.3e}, bits equal {bits_b} [{card}]")
            turns_b = served_in_turns("serving tier (4q) (b) thread fleet",
                                      first, tdoor.address, line_chunks,
                                      direct, rec_chunks, card)
            # the two scopes in turns, both fleets of 2 up at once
            scopes = {"thread": [], "process": []}
            for which in ("thread", "process", "process", "thread"):
                _s, lat, secs, failures = traffic(
                    tdoor.address if which == "thread" else door.address,
                    line_chunks)
                require(not failures, f"(b) {which}: {failures[:3]}")
                scopes[which].append(round(B * len(line_chunks) / secs, 1))
            print(f"timing serving tier (4q) thread against process fleet "
                  f"of 2, in turns: examples/s {scopes} [{card}]")
            watcher = ReloadWatcher(fleet, bundle, root, poll_s=3600.0)
            t0 = time.perf_counter()
            require(watcher.poll_once(), "(b) no reload to the base")
            first_s = time.perf_counter() - t0
            require(fleet.versions() == [f"{SRV_DAY}/00001"] * 2,
                    f"(b) versions {fleet.versions()}")
            # the next pass: 5% of the rows rewritten (the traffic's keys among
            # them), new keys added
            t0 = time.perf_counter()
            file_keys = np.unique(np.concatenate(
                [b.keys[:b.num_keys] for b in batches]))
            others = rng.choice(table_keys, size=int(SRV_REWRITE
                                                     * table_keys.size),
                                replace=False)
            fresh = rng.integers(1 << 40, 1 << 62, size=SRV_NEW,
                                 dtype=np.uint64)
            keys = np.unique(np.concatenate([file_keys, others, fresh]))
            values = (rng.normal(size=(keys.size, conf.pull_dim)) * 0.05
                      ).astype(np.float32)
            values[:, 0] = rng.integers(0, 40, size=keys.size)
            values[:, 1] = np.floor(values[:, 0] * 0.2)
            table.import_rows(keys, values,
                              np.zeros((keys.size, state_dim(conf)),
                                       np.float32))
            pm.pass_id = 2
            pm.save_delta(wait=True)
            delta_s = time.perf_counter() - t0
            # the swap under traffic
            stop = threading.Event()
            under = {"requests": 0, "failures": []}

            def hammer(c):
                i = c
                while not stop.is_set():
                    try:
                        predict_lines(*tdoor.address, line_chunks[i % 16],
                                      deadline_ms=60000.0)
                        under["requests"] += 1
                    except Exception as e:  # noqa: BLE001 - required below
                        under["failures"].append(f"{type(e).__name__}: {e}")
                    i += SRV_CLIENTS

            recompiled = REGISTRY.counter("serving.reload_recompiled").get()
            hist = REGISTRY.histogram("serving.reload_ms")
            hist0 = (hist.count, hist.sum)
            threads = [threading.Thread(target=hammer, args=(c,))
                       for c in range(SRV_CLIENTS)]
            for t in threads:
                t.start()
            time.sleep(0.5)
            torch.cuda.synchronize()
            mem_before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            require(watcher.poll_once(), "(b) no reload to the delta")
            swap_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            time.sleep(0.5)
            stop.set()
            for t in threads:
                t.join()
            v2 = f"{SRV_DAY}/00002"
            require(not under["failures"], f"(b) failures under the swap "
                    f"{under['failures'][:3]}")
            require(fleet.versions() == [v2] * 2,
                    f"(b) versions {fleet.versions()}")
            require(REGISTRY.counter("serving.reload_recompiled").get()
                    == recompiled, "(b) the swap counted a recompile")
            plan = discovery.latest_committed(root)
            fresh_pred = load_predictor_from_plan(bundle, plan, device="cuda")
            want2 = fresh_pred.predict_records(rec_chunks[0])
            for s in per_replica_scores(fleet, rec_chunks[0]):
                require(np.array_equal(s.view(np.uint32),
                                       want2.view(np.uint32)),
                        "(b) a swapped replica's scores differ from a fresh "
                        "load_predictor_from_plan's")
            require(float(np.abs(want2 - want[0]).max()) > 0,
                    "(b) the reload changed no score")
            thread_reload_ms = (hist.sum - hist0[1]) / (hist.count - hist0[0])
            print(f"serving tier (4q) (b) reload: base of {len(table)} "
                  f"rows (pass 1) swapped in {first_s:.3f} s before "
                  f"traffic; a delta of {keys.size} rows (pass 2) committed "
                  f"in {delta_s:.3f} s and swapped under traffic from "
                  f"{SRV_CLIENTS} connections in {swap_s:.3f} s "
                  f"({under['requests']} requests, 0 failed, "
                  f"serving.reload_recompiled unchanged), both replicas at "
                  f"{v2}, scores bit for bit a fresh "
                  f"load_predictor_from_plan's; "
                  f"serving.reload_ms {thread_reload_ms:.3f} a replica "
                  f"({hist.count - hist0[0]} swaps); device memory during the "
                  f"swap: {mem_before} B before, peak {peak} B [{card}]")
            del fresh_pred
        del fleet, tdoor
        gc.collect()
        torch.cuda.empty_cache()

        # one reload in the children
        hist0 = (hist.count, hist.sum)
        t0 = time.perf_counter()
        require(ReloadWatcher(pfleet, bundle, root,
                              poll_s=3600.0).poll_once(),
                "(c) no reload")
        proc_swap_s = time.perf_counter() - t0
        require(pfleet.versions() == [v2] * 2,
                f"(c) versions {pfleet.versions()}")
        for s in per_replica_scores(pfleet, rec_chunks[0]):
            require(np.array_equal(s.view(np.uint32), want2.view(np.uint32)),
                    "(c) a reloaded child's scores differ from a fresh "
                    "load_predictor_from_plan's")
        proc_reload_ms = (hist.sum - hist0[1]) / (hist.count - hist0[0])
        print(f"serving tier (4q) (c) reload in the children to {v2}: "
              f"{proc_swap_s:.3f} s for both, serving.reload_ms "
              f"{proc_reload_ms:.3f} a replica ({hist.count - hist0[0]} "
              f"swaps), scores bit for bit the fresh predictor's [{card}]")

        # (d) the SLO rule, /healthz and /metrics
        rule = Rule("tier_p99_ms", metric="serve.request_ms", agg="p99",
                    op=">", threshold=SRV_SHED_MS,
                    labels={"action": "shed"})
        pfleet.attach_slo(engine, rules=[rule])
        engine.evaluate()
        _s, _l, _t, failures = traffic(door.address, line_chunks[:4])
        require(not failures, f"(d) failures before the shed {failures[:3]}")
        engine.evaluate()
        require(pfleet.admission.shedding, "(d) the fleet does not shed")
        try:
            predict_lines(*door.address, line_chunks[0])
        except RuntimeError as e:
            require("shedding" in str(e), f"(d) {e}")
        else:
            raise AssertionError("(d) a request passed while shedding")
        try:
            pfleet.predict_records(rec_chunks[0])
        except SheddingLoad:
            pass
        else:
            raise AssertionError("(d) predict_records passed while shedding")
        code, doc = http_status(pfleet.metrics_address, "/healthz")
        require(code == 503 and doc["shedding"], f"(d) /healthz {code}")
        fired = engine.alerts()[0]
        engine.evaluate()                   # a window without traffic
        require(not pfleet.admission.shedding, "(d) shedding did not clear")
        code2, _ = http_status(pfleet.metrics_address, "/healthz")
        require(code2 == 200, f"(d) /healthz after {code2}")
        got, _l, _t, failures = traffic(door.address, line_chunks[:1])
        require(not failures, f"(d) failures after the clear {failures[:3]}")
        err_d, _ = same_scores("(d) after the clear", got, [want2])
        url = (f"http://{pfleet.metrics_address[0]}:"
               f"{pfleet.metrics_address[1]}/metrics")
        page = parse_prometheus(urllib.request.urlopen(
            url, timeout=10).read().decode())
        for name in ("pbx_serve_request_ms_count", "pbx_serving_requests",
                     "pbx_serving_replica_r0_child_serve_predict_ms_count",
                     "pbx_serving_replica_r1_child_serve_launches_"
                     "seqpool_cvm_cuda", "pbx_serving_shed",
                     "pbx_alert_firing_tier_p99_ms"):
            require(name in page, f"(d) /metrics lacks {name}")
        print(f"serving tier (4q) (d) SLO: rule p99(serve.request_ms) > "
              f"{SRV_SHED_MS} ms action=shed fired at {fired['value']:.3f} "
              f"ms, the fleet shed (SheddingLoad, /healthz {code}), a quiet "
              f"window resolved it (/healthz {code2}, a request then served, "
              f"max |served - fresh| {err_d:.3e}); /metrics parses "
              f"({len(page)} samples, the children's serve.* included) "
              f"[{card}]")
    finally:
        engine.stop()
        door.stop()
        pfleet.stop()
    require(all(not r._proc.is_alive() for r in pfleet.replicas),
            "(c) a child outlived the fleet")
    pm.close()
    del table, direct
    gc.collect()
    torch.cuda.empty_cache()
    result = {"launches": {"serve_server": {"seqpool_cvm_cuda": launches_a},
                           "serve_fleet_thread": {
                               "seqpool_cvm_cuda": launches_b},
                           "serve_fleet_proc": {
                               "seqpool_cvm_cuda": launches_c}},
              "turns": {"server": turns_a, "thread": turns_b,
                        "proc": turns_c}, "scopes": scopes,
              "spawn": spawns, "per_child_bytes": per_child,
              "thread_reload_ms": thread_reload_ms,
              "proc_reload_ms": proc_reload_ms,
              "phase_s": time.perf_counter() - t_phase}
    print(f"serving tier (4q): {result['phase_s']:.1f} s")
    return result


# -- phase 4r: the multi-host serving tier ------------------------------------

HOSTS = 2                   # serving hosts of 4r's fleet
HT_CLIENTS = 4              # client threads of 4r's traffic, through the LB
HT_DEADLINE_MS = 60000.0    # a request's deadline through failover


def host_counts(hf, reset: bool = False) -> dict:
    """Each live host's seqpool launches, read on its control channel."""
    return {h.name: h.launch_counts(reset=reset).get("seqpool_cvm_cuda", 0)
            for h in hf.hosts if h is not None}


def fleet_gauges(fm, hf, metric: str) -> dict:
    """A metric of each live host, scraped from its ``/metrics`` through
    the fleet view."""
    fm.scrape_once()
    return {h.name: fm.registry.gauge(f"fleet.hosts.{h.name}.{metric}").get()
            for h in hf.hosts if h is not None}


class LBLoad:
    """``HT_CLIENTS`` threads sending the chunks through an ``LBClient``:
    client c sends chunk (c + i) % n on its i-th request, ``per_client``
    requests, or until ``stop`` is set (``per_client=None``). Each answer
    is held to ``want`` of its chunk."""

    def __init__(self, lb, chunks, want, per_client=None):
        self.lb, self.chunks, self.want = lb, chunks, want
        self.per_client = per_client
        self.stop = threading.Event()
        self.failures, self.lat = [], []
        self.worst = 0.0
        self.rows = 0
        self._lock = threading.Lock()
        self.threads = [threading.Thread(target=self._client, args=(c,))
                        for c in range(HT_CLIENTS)]

    def _client(self, c: int) -> None:
        i = 0
        while (i < self.per_client if self.per_client is not None
               else not self.stop.is_set()):
            k = (c + i) % len(self.chunks)
            i += 1
            t0 = time.perf_counter()
            try:
                s = np.asarray(self.lb.predict_lines(
                    self.chunks[k], deadline_ms=HT_DEADLINE_MS), np.float32)
            except Exception as e:  # noqa: BLE001 - reported, then required
                with self._lock:
                    self.failures.append(f"{type(e).__name__}: {e}")
                continue
            ms = (time.perf_counter() - t0) * 1e3
            err = (float(np.abs(s - self.want[k]).max())
                   if s.shape == self.want[k].shape else float("inf"))
            with self._lock:
                self.lat.append(ms)
                self.worst = max(self.worst, err)
                self.rows += s.shape[0]

    def start(self) -> "LBLoad":
        self.t0 = time.perf_counter()
        for t in self.threads:
            t.start()
        return self

    def join(self) -> "LBLoad":
        self.stop.set()
        for t in self.threads:
            t.join()
        self.secs = time.perf_counter() - self.t0
        return self

    def check(self, tag: str) -> None:
        require(not self.failures, f"{tag}: {len(self.failures)} client "
                f"failures, {self.failures[:3]}")
        require(self.worst <= 1e-6, f"{tag}: |LB - direct CTRPredictor| = "
                f"{self.worst}")

    def summary(self) -> dict:
        return {"requests": len(self.lat), "rows": self.rows,
                "secs": self.secs, "examples_per_s": self.rows / self.secs,
                "p50_ms": float(np.percentile(self.lat, 50)),
                "p99_ms": float(np.percentile(self.lat, 99)),
                "max_err": self.worst}


def phase_host_tier(bundle: str, batches) -> dict:
    """(4r) The multi-host serving tier over phase 3's flagship bundle
    (DeepFM 512-256-128, 26 Criteo slots + 13 dense, B=512, 4,194,304
    rows): a ``HostFleet`` of 2 spawned hosts, each a process group with a
    thread-scope ``ReplicaSet`` of 1 ``CTRPredictor`` on the card (its own
    CUDA context and table), a ``FrontDoor`` and a ``/metrics``, publishing
    to an endpoints file a ``FileResolver`` watches for an ``LBClient``.
    (a) 4 client threads x 16 requests of 512 lines through the LB, each
    host's launch counts set to 0 first: the scores within 1e-6 of a direct
    ``CTRPredictor``, each host's seqpool launches equal to the requests it
    served, on both hosts, the same counts scraped from each host's
    ``/metrics`` through ``FleetMetrics``. (b) the reference drill's
    ``host_sigkill``: a killpg of one host under closed-loop traffic, no
    client failure, a newer generation published, the host restarted, its
    group gone; the MTTR (the kill to the restored set published), then 16
    more requests served by both hosts. (c) ``rolling_drain``: a
    decommission under traffic, no failure, then ``add_host``. Prints
    ``host_failover``'s numbers: steady examples/s, examples/s in the kill
    window, MTTR."""
    from paddlebox_tpu_torch.obs.fleet import FleetMetrics
    from paddlebox_tpu_torch.obs.metrics import MetricsRegistry
    from paddlebox_tpu_torch.serving import FileResolver, HostFleet, LBClient
    card = card_line()
    t_phase = time.perf_counter()
    chunks = [criteo_lines(b) for b in batches]
    direct = CTRPredictor(bundle, device="cuda")
    parser = SlotParser(direct.feed_conf)
    want = [direct.predict_records([parser.parse_line(ln) for ln in c])
            for c in chunks]
    del direct
    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.join(WORK, "host_tier")
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "endpoints.json")
    reg = MetricsRegistry()
    spec = {"scope": "thread", "replicas": 1,
            "worker_spec": {"bundle": bundle, "device": "cuda"}}
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    hf = HostFleet(spec, hosts=HOSTS, resolver_path=path, registry=reg,
                   probe_interval=0.25)
    spawn_s = time.perf_counter() - t0
    per_host = (free0 - torch.cuda.mem_get_info()[0]) / HOSTS
    pgids = {h.pgid for h in hf.hosts}
    print(f"host tier (4r): {HOSTS} hosts spawned at once in {spawn_s:.3f} s "
          f"(each {[round(h.spawn_s, 3) for h in hf.hosts]} s to its ready "
          f"document), device memory a host {per_host:.0f} B, generation "
          f"{hf.generation} [{card}]")
    require(all(g != os.getpgrp() for g in pgids),
            "(4r) a host shares the parent's process group")
    hf.start()
    res = FileResolver(path, poll_s=0.1, registry=reg)
    lb = LBClient(res, registry=reg, probe_interval=0.25).start()
    fm = FleetMetrics(interval=3600.0)
    fm.add_host_fleet(hf)
    try:
        # warm each host on its own front door, then the counts to 0
        for h in hf.hosts:
            predict_lines("127.0.0.1", h.port, chunks[0],
                          deadline_ms=HT_DEADLINE_MS)
        host_counts(hf, reset=True)
        served0 = fleet_gauges(fm, hf, "pbx_serving_requests")
        # (a) steady traffic, counted
        steady = LBLoad(lb, chunks, want, per_client=len(chunks)).start()
        steady.join().check("(a)")
        counts = host_counts(hf)
        scraped = fleet_gauges(fm, hf, "pbx_serve_launches_seqpool_cvm_cuda")
        served = fleet_gauges(fm, hf, "pbx_serving_requests")
        share = {n: served[n] - served0[n] for n in served}
        require(sum(counts.values()) == HT_CLIENTS * len(chunks),
                f"(a) seqpool launched {counts} for "
                f"{HT_CLIENTS * len(chunks)} requests")
        require(counts == share and min(counts.values()) > 0,
                f"(a) launches {counts} against each host's requests {share}")
        require(scraped == {n: float(v) for n, v in counts.items()},
                f"(a) /metrics carried {scraped}, the hosts counted {counts}")
        a = steady.summary()
        print(f"host tier (4r) (a) {HT_CLIENTS} clients x {len(chunks)} "
              f"requests of {B} lines through the LB: seqpool launches by "
              f"host {counts} (each host's share of requests {share}, its "
              f"/metrics {scraped}), max |LB - direct| {a['max_err']:.3e}, "
              f"p50 {a['p50_ms']:.1f} ms, p99 {a['p99_ms']:.1f} ms, "
              f"{a['examples_per_s']:.1f} examples/s [{card}]")

        # (b) host_sigkill under closed-loop traffic
        victim = hf.hosts[0]
        gen0 = hf.generation
        restarts0 = reg.counter("serving.host_restarts").get()
        load = LBLoad(lb, chunks, want).start()
        require(wait_until(lambda: len(load.lat) >= HT_CLIENTS, 60.0),
                "(b) no request answered before the kill")
        t_kill = time.monotonic()
        hf.kill_host(0)
        restored = wait_until(
            lambda: reg.counter("serving.host_restarts").get() > restarts0
            and len(hf.endpoints()) == HOSTS, 120.0)
        mttr = time.monotonic() - t_kill
        load.join().check("(b) through the kill")
        require(restored, "(b) the host was not restarted")
        require(hf.generation > gen0 + 1,
                f"(b) generations {gen0} -> {hf.generation}")
        require(wait_until(lambda: res.generation == hf.generation, 10.0),
                f"(b) the resolver holds generation {res.generation}, the "
                f"fleet published {hf.generation}")
        require(wait_until(lambda: not pgid_alive(victim.pgid), 20.0),
                "(b) the killed host's group outlived it")
        kill = load.summary()
        pgids.add(hf.hosts[0].pgid)
        host_counts(hf, reset=True)
        after = LBLoad(lb, chunks, want, per_client=len(chunks) // HT_CLIENTS)
        after.start().join().check("(b) after the restart")
        counts_b = host_counts(hf)
        require(sum(counts_b.values()) == len(chunks) and
                min(counts_b.values()) > 0,
                f"(b) after the restart seqpool launched {counts_b} for "
                f"{len(chunks)} requests")
        print(f"host tier (4r) (b) host_sigkill: killpg of {victim.name} "
              f"(pgid {victim.pgid}) under traffic from {HT_CLIENTS} "
              f"clients: {kill['requests']} requests answered, 0 failed, max "
              f"|LB - direct| {kill['max_err']:.3e}, "
              f"serving.failover_retries "
              f"{reg.counter('serving.failover_retries').get()}, "
              f"serving.lb.ejections "
              f"{reg.counter('serving.lb.ejections').get()}; generation "
              f"{gen0} -> {hf.generation}; MTTR {mttr:.3f} s (the new host's "
              f"spawn {hf.hosts[0].spawn_s:.3f} s); then {len(chunks)} "
              f"requests, seqpool launches by host {counts_b} [{card}]")

        # (c) rolling_drain: decommission under traffic, then add_host
        load = LBLoad(lb, chunks, want).start()
        require(wait_until(lambda: len(load.lat) >= HT_CLIENTS, 60.0),
                "(c) no request answered before the drain")
        gen1 = hf.generation
        t0 = time.perf_counter()
        hf.decommission(0, grace=0.5)
        drain_s = time.perf_counter() - t0
        require(wait_until(lambda: len(lb.hosts()) == HOSTS - 1, 10.0),
                f"(c) the LB still holds {lb.hosts()}")
        t0 = time.perf_counter()
        slot = hf.add_host()
        add_s = time.perf_counter() - t0
        pgids.add(hf.hosts[slot].pgid)
        require(wait_until(lambda: len(lb.hosts()) == HOSTS, 10.0),
                f"(c) the LB holds {lb.hosts()} after add_host")
        require(wait_until(lambda: len(load.lat) >= HT_CLIENTS * 4, 60.0),
                "(c) traffic stalled")
        load.join().check("(c) through the drain")
        drain = load.summary()
        print(f"host tier (4r) (c) rolling_drain: decommission of h0 under "
              f"traffic in {drain_s:.3f} s (grace 0.5 s), add_host slot "
              f"{slot} in {add_s:.3f} s, generation {gen1} -> "
              f"{hf.generation}; {drain['requests']} requests answered, 0 "
              f"failed, max |LB - direct| {drain['max_err']:.3e} [{card}]")
        print(f"timing host tier (4r) host_failover: steady "
              f"{a['examples_per_s']:.1f} examples/s ({a['requests']} "
              f"requests), kill window {kill['examples_per_s']:.1f} "
              f"examples/s ({kill['requests']} requests over "
              f"{kill['secs']:.3f} s), MTTR {mttr:.3f} s; drain window "
              f"{drain['examples_per_s']:.1f} examples/s [{card}]")
    finally:
        fm.stop()
        lb.stop()
        res.stop()
        hf.stop()
    for g in sorted(pgids):
        require(wait_until(lambda: not pgid_alive(g), 20.0),
                f"(4r) host group {g} outlived the fleet")
    gc.collect()
    torch.cuda.empty_cache()
    result = {"launches": {"serve_hosts": {"seqpool_cvm_cuda": sum(
                  counts.values()) + sum(counts_b.values())}},
              "steady": a, "kill": kill, "drain": drain, "mttr_s": mttr,
              "spawn_s": spawn_s, "per_host_bytes": per_host,
              "phase_s": time.perf_counter() - t_phase}
    print(f"host tier (4r): {result['phase_s']:.1f} s")
    return result


def pgid_alive(pgid: int) -> bool:
    try:
        os.killpg(pgid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


# -- phase 4s: the embedded serving export and its C++ loader -----------------

def start_loader_build():
    """The loader's build (``csrc/pbx_serve.cpp`` against PyTorch's C++
    library, minutes with its headers) on a thread of its own, started
    once phase 1's libraries exist; 4s waits for it."""
    pool = ThreadPoolExecutor(1)

    def run():
        t0 = time.perf_counter()
        res = _build.build("pbx_serve")
        return (time.perf_counter() - t0, res is not None,
                str(_build.library_path("pbx_serve")))

    fut = pool.submit(run)
    pool.shutdown(wait=False)
    return fut


#: processes the script starts beside its phases (stopped at its end)
BACKGROUND = []


def start_export(bundle: str, batches) -> dict:
    """Phase 4s's export of phase 3's bundle (``export_embedded_bundle`` on
    the card; AOTInductor's compile takes most of two minutes) on a process
    of its own, started once phase 3 wrote the bundle: it runs beside
    phases 4-4p and ends before 4q, whose device-memory readings it would
    disturb; at the lowest CPU priority and with one inductor compile
    thread, so that it takes the cores those phases leave idle. Its key
    padding is the largest of phase 3's batches'."""
    out = os.path.join(WORK, "embedded")
    npad = max(int(b.keys.shape[0]) for b in batches)
    log_path = os.path.join(WORK, "export.log")
    code = (f"import os, sys, time; os.nice(19); "
            f"sys.path.insert(0, {ROOT!r}); "
            "from paddlebox_tpu_torch.inference.export_embedded import "
            "export_embedded_bundle; t0 = time.perf_counter(); "
            f"export_embedded_bundle({bundle!r}, {out!r}, npad={npad}, "
            "device='cuda'); "
            "print(f'export {time.perf_counter() - t0:.3f} s')")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-c", code], stdout=log,
            stderr=subprocess.STDOUT, cwd=ROOT,
            env=dict(os.environ, TORCHINDUCTOR_COMPILE_THREADS="1"))
    BACKGROUND.append(proc)
    return {"proc": proc, "t0": time.perf_counter(), "out": out,
            "npad": npad, "log": log_path}


def run_loader(exe: str, *args, env=None):
    return subprocess.run([exe, *args], capture_output=True, text=True,
                          timeout=600, env=env)


def phase_embedded(bundle: str, batches, loader_build, export) -> dict:
    """(4s) The embedded serving export of phase 3's flagship bundle
    (4,194,304 rows) and its C++ loader: ``export_embedded_bundle`` (on its
    process since phase 3, ``start_export``) writes the key and value
    files, the manifest, the layout, the exported dense program and its
    AOTInductor package; ``pbx_serve`` (built by
    ``ops/_build.py`` from the checkout) scores 16 batches of 512 of phase
    3's lines with no Python: the key index's lookup, the seqpool+CVM
    kernel, the AOTI dense forward. Its scores within rtol 2e-5, atol 1e-6
    of ``CTRPredictor`` on the card, its printed launches equal to its
    batches; a truncated bundle, no CUDA device and no kernel library each
    make it exit nonzero."""
    from paddlebox_tpu_torch.inference.export_embedded import (AOTI_FILE,
                                                               EP_FILE)
    card = card_line()
    t_phase = time.perf_counter()
    proc, out = export["proc"], export["out"]
    rc = proc.wait(timeout=900)
    waited_s = time.perf_counter() - t_phase
    with open(export["log"]) as f:
        log = f.read()
    require(rc == 0, f"(4s) the export exited {rc}: {log[-3000:]}")
    m = re.search(r"export ([\d.]+) s", log)
    require(m is not None, f"(4s) the export printed no time: {log[-500:]}")
    export_s = float(m.group(1))
    sizes = {f: os.path.getsize(os.path.join(out, f)) for f in (
        "table.keys.u64", "table.vals.f32", EP_FILE, AOTI_FILE)}
    require(sizes["table.keys.u64"] == TABLE_ROWS * 8,
            f"(4s) key file {sizes['table.keys.u64']} B")
    print(f"embedded (4s): export of {TABLE_ROWS} rows, npad "
          f"{export['npad']}, in {export_s:.3f} s on its own process "
          f"(AOTInductor included; 4s waited {waited_s:.3f} s for it); file "
          f"bytes {sizes} [{card}]")
    direct = CTRPredictor(bundle, device="cuda")
    want = np.concatenate([direct.predict_batch(b) for b in batches])
    del direct
    gc.collect()
    torch.cuda.empty_cache()
    data = os.path.join(out, "input.txt")
    with open(data, "w") as f:
        for b in batches:
            f.write("\n".join(criteo_lines(b)) + "\n")
    build_s, built, exe = loader_build.result()
    print(f"embedded (4s): loader {os.path.basename(exe)} "
          f"{'built' if built else 'already built'} in {build_s:.2f} s "
          f"(g++ against libtorch, on its own thread since phase 1)")
    t0 = time.perf_counter()
    run = run_loader(exe, out, data)
    run_s = time.perf_counter() - t0
    require(run.returncode == 0,
            f"(4s) pbx_serve exited {run.returncode}: {run.stderr[-2000:]}")
    got = np.array(run.stdout.split(), dtype=np.float64).astype(np.float32)
    require(got.shape == want.shape, f"(4s) {got.shape} scores for "
            f"{want.shape[0]} rows")
    err = np.abs(got.astype(np.float64) - want)
    tol = 1e-6 + 2e-5 * np.abs(want)
    require(bool((err <= tol).all()) and bool(np.isfinite(got).all()),
            f"(4s) loader vs CTRPredictor: max error {err.max()}, "
            f"{int((err > tol).sum())} rows over rtol 2e-5, atol 1e-6")
    m = re.search(r"pbx_serve: launches (\d+) batches (\d+)", run.stderr)
    require(m is not None, f"(4s) no launch line: {run.stderr[-500:]}")
    launches, n_batches = int(m.group(1)), int(m.group(2))
    require(launches == n_batches == len(batches),
            f"(4s) {launches} launches over {n_batches} batches for "
            f"{len(batches)}")
    split = re.search(r"pbx_serve: load ([\d.]+) ms; first batch ([\d.]+) "
                      r"ms; ms a batch after it: (.*)", run.stderr)
    require(split is not None, f"(4s) no time line: {run.stderr[-500:]}")
    steps = dict(zip(split.group(3).split()[::2],
                     map(float, split.group(3).split()[1::2])))
    print(f"embedded (4s): pbx_serve scored {got.shape[0]} rows in "
          f"{n_batches} batches, seqpool launches {launches}, max |loader - "
          f"CTRPredictor| {float(err.max()):.3e}; process {run_s:.3f} s, "
          f"bundle load {float(split.group(1)):.1f} ms, first batch "
          f"{float(split.group(2)):.1f} ms; ms a batch after it {steps} "
          f"[{card}]")

    # no fallback: a truncated bundle, no card, no kernel library
    bad = os.path.join(out, "truncated")
    os.makedirs(bad, exist_ok=True)
    for f in os.listdir(out):
        if os.path.isfile(os.path.join(out, f)) and f != "table.keys.u64":
            dst = os.path.join(bad, f)
            if not os.path.exists(dst):
                os.symlink(os.path.join(out, f), dst)
    with open(os.path.join(bad, "table.keys.u64"), "wb") as f:
        f.write(b"\x00" * 8)
    refusals = {}
    # the loader beside its key index but not its kernel library
    lonely = os.path.join(out, "alone")
    os.makedirs(lonely, exist_ok=True)
    shutil.copy(exe, lonely)
    index_lib = _build.library_path(HOST_INDEX)
    if not os.path.exists(os.path.join(lonely, index_lib.name)):
        os.symlink(index_lib, os.path.join(lonely, index_lib.name))
    for tag, cmd, env in (
            ("truncated", (exe, bad, data), None),
            ("no CUDA device", (exe, out, data),
             dict(os.environ, CUDA_VISIBLE_DEVICES="")),
            ("no kernel library",
             (os.path.join(lonely, os.path.basename(exe)), out, data), None)):
        r = run_loader(*cmd, env=env)
        require(r.returncode != 0 and not r.stdout.strip(),
                f"(4s) {tag}: exit {r.returncode}, stdout "
                f"{r.stdout[:200]!r}")
        refusals[tag] = (r.returncode, r.stderr.strip().splitlines()[-1]
                         if r.stderr.strip() else "")
    print(f"embedded (4s): refusals (exit code, last stderr line) "
          f"{refusals}")
    result = {"launches": {"embedded_loader": {"seqpool_cvm_cuda": launches}},
              "steps_ms": steps, "export_s": export_s, "build_s": build_s,
              "run_s": run_s, "max_err": float(err.max()),
              "phase_s": time.perf_counter() - t_phase}
    print(f"embedded (4s): {result['phase_s']:.1f} s")
    return result


# -- phase 4t: the CTR dense ops and AucRunner ---------------------------------

CTR_MAX_RANK = 3             # rank_attention's ranks (the reference default)
CTR_PARA_COL = 16            # rank_attention's output columns
CTR_OUT = 128                # scaled_fc's output columns
CTR_BLOCKS = TS              # batch_fc's column blocks: a slot's D columns each
CTR_FIELDS = TS // 2         # cross_norm's (a, b) pairs of D columns each
CTR_F32_TOL = 1e-5           # card vs CPU, relative to the op's largest entry
CTR_BF16_TOL = 0.05          # scaled_fc's bf16 product: the reference tests'
AUC_SLOTS = 4                # slots slot_importance permutes
AUC_PHASES = ([0, 1], [2, 3])    # slot_importance_pool's phases
AUC_POOL = 2048              # its candidate pool


def pv_groups(rng, n: int):
    """Ranks and PV offsets of ``n`` instances in PV groups of 1-5 ads (5%
    of the ranks unknown)."""
    sizes = []
    while sum(sizes) < n:
        sizes.append(min(int(rng.integers(1, 6)), n - sum(sizes)))
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    ranks = np.concatenate([np.arange(1, s + 1) for s in sizes])
    ranks[rng.random(n) < 0.05] = 0
    return ranks, offsets


def ctr_case(tag: str, fn, arrays, grad_of=(), bf16: bool = False) -> float:
    """``fn`` over ``arrays`` on the card and on the CPU, the output and the
    gradients of the inputs in ``grad_of`` (of a seeded cotangent); each
    held within the tolerance relative to the CPU's largest entry. Returns
    the worst relative error."""
    outs = {}
    for dev in ("cuda", "cpu"):
        ts = [torch.from_numpy(a).to(dev) for a in arrays]
        for i in grad_of:
            ts[i].requires_grad_(True)
        out = fn(*ts)
        if grad_of:
            cot = torch.from_numpy(np.random.default_rng(1).normal(
                size=tuple(out.shape)).astype(np.float32)).to(dev)
            (out * cot).sum().backward()
        outs[dev] = [out.detach().cpu().numpy()] + [
            ts[i].grad.cpu().numpy() for i in grad_of]
    worst = 0.0
    for j, (got, want) in enumerate(zip(outs["cuda"], outs["cpu"])):
        scale = max(float(np.abs(want).max()), 1.0)
        err = float(np.abs(got - want).max())
        tol = CTR_BF16_TOL * scale if bf16 and j == 0 else CTR_F32_TOL * scale
        require(np.isfinite(got).all() and err <= tol,
                f"ctr ops (4t) {tag}[{j}]: card vs CPU {err:.3e} > {tol:.3e}")
        worst = max(worst, err / scale)
    return worst


def phase_ctr_ops(rng, files) -> dict:
    """(4t) Every CTR dense op on the card against the same code on the CPU
    at the flagship's training batch (the pooled input [B, TS*D]), with
    rank_attention over seeded PV groups of 1-5 ads through
    ``PvBatchAssembler``'s rank offsets; then ``AucRunner`` over the
    flagship DeepFM after one trainer-cell file: AUC_SLOTS slots by
    permutation and the pool's phases, the dataset restored bit for bit,
    the forward kernel launched once a batch of each evaluation."""
    t_phase = time.perf_counter()
    width = TS * D
    x = rng.normal(size=(TB, width)).astype(np.float32)
    col = lambda: rng.normal(size=width).astype(np.float32)
    summ = (np.full(width, 1e4, np.float32), col() * 100,
            np.abs(col()) * 1e4 + 1e3)
    mask = (rng.random(TB) < 0.9).astype(np.float32)
    ranks, offsets = pv_groups(rng, TB)
    # the rank offsets as the PV assembler builds them, over records
    # carrying these PV ids and ranks
    feed = slot_feed_conf(1, TB)
    recs = [SlotParser(feed).parse_line(f"1 0 1 {i + 1}") for i in range(TB)]
    pv_id = np.repeat(np.arange(offsets.size - 1), np.diff(offsets))
    for r, sid, rank in zip(recs, pv_id, ranks):
        r.search_id, r.rank = int(sid) + 1, int(rank)
    pvb = next(PvBatchAssembler(feed, offsets.size - 1,
                                CTR_MAX_RANK).batches(recs))
    ro = pvb.rank_offset
    require(np.array_equal(ro, build_rank_offset(ranks, offsets,
                                                 CTR_MAX_RANK))
            and pvb.pv_num == offsets.size - 1,
            "ctr ops (4t): PvBatchAssembler's rank offsets")
    param = (rng.normal(size=(CTR_MAX_RANK ** 2 * width, CTR_PARA_COL))
             * 0.05).astype(np.float32)
    w_fc = (rng.normal(size=(D, CTR_BLOCKS * 8)) * 0.3).astype(np.float32)
    b_fc = rng.normal(size=CTR_BLOCKS * 8).astype(np.float32)
    w_sc = (rng.normal(size=(width, CTR_OUT)) * 0.06).astype(np.float32)
    b_sc = rng.normal(size=CTR_OUT).astype(np.float32)
    cw = CTR_FIELDS * (3 * D + 1)
    c_mean = (rng.normal(size=cw) * 0.1).astype(np.float32)
    c_scale = (np.abs(rng.normal(size=cw)) + 0.5).astype(np.float32)
    errs = {
        "data_norm": ctr_case(
            "data_norm", lambda a, s, q, n, w, b: ctr_ops.data_norm(
                a, s, q, n, w, b),
            [x, summ[0], summ[1], summ[2], col(), col()], (0, 4, 5)),
        "data_norm_stats": max(ctr_case(
            f"data_norm_stats[{i}]",
            lambda a, m, i=i: ctr_ops.data_norm_stats(a, m)[i], [x, mask])
            for i in range(3)),
        "data_norm_update_summary": ctr_case(
            "data_norm_update_summary",
            lambda a, m, n, s, q: torch.stack(
                ctr_ops.data_norm_update_summary(
                    n, s, q, ctr_ops.data_norm_stats(a, m))),
            [x, mask, *summ]),
        "rank_attention": ctr_case(
            "rank_attention", lambda a, r, p: ctr_ops.rank_attention(
                a, r, p, CTR_MAX_RANK), [x, ro, param], (2,)),
        "batch_fc": ctr_case(
            "batch_fc", lambda a, w, b: ctr_ops.batch_fc(a, w, b,
                                                         CTR_BLOCKS),
            [x, w_fc, b_fc], (0, 1, 2)),
        "scaled_fc": ctr_case(
            "scaled_fc", lambda a, w, b: ctr_ops.scaled_fc(a, w, b, 0.5, 2.0),
            [x, w_sc, b_sc], bf16=True),
        "cross_norm_raw": ctr_case(
            "cross_norm_raw", lambda a: ctr_ops.cross_norm_raw(
                a[:, :2 * CTR_FIELDS * D], CTR_FIELDS, D), [x]),
        "cross_norm_hadamard": ctr_case(
            "cross_norm_hadamard",
            lambda a, m, s: ctr_ops.cross_norm_hadamard(
                a[:, :2 * CTR_FIELDS * D], m, s, CTR_FIELDS, D),
            [x, c_mean, c_scale], (0,)),
    }
    print(f"ctr ops (4t): card vs CPU at B={TB}, input [{TB}, {width}], "
          f"max_rank {CTR_MAX_RANK} over {offsets.size - 1} PV groups of "
          f"1-5 ads; worst error relative to each op's largest entry "
          f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} }")

    # AucRunner over the flagship DeepFM after one trainer-cell file
    conf, tconf, buckets = train_confs()
    tfeed = trainer_feed_conf()
    ds = SlotDataset(tfeed, buckets=BucketSpec(min_size=TNPAD,
                                               max_size=1 << 18))
    ds.set_filelist(files[:1])
    ds.load_into_memory()
    n_batches = ds.num_instances() // TB
    table = DeviceTable(conf, capacity=HOT_VOCAB + 1 + TRAINER_HEADROOM,
                        uniq_buckets=buckets, device="cuda",
                        backend="native", index_threads=1)
    table.prepopulate(HOT_VOCAB)
    trainer = CTRTrainer(random_deepfm(rng, TS * conf.pull_dim), tfeed,
                         conf, tconf, table=table)
    train_s, metrics, _ = count_launches(
        lambda: trainer.train_from_dataset(ds), n_batches, "auc runner's "
        "training file")
    before = [(r.uint64_feas.copy(), r.uint64_offsets.copy())
              for r in ds.records]
    runner = AucRunner(trainer, seed=7)
    evals = (1 + AUC_SLOTS) + (1 + len(AUC_PHASES))

    def both():
        t0 = time.perf_counter()
        perm = runner.slot_importance(ds, range(AUC_SLOTS))
        t1 = time.perf_counter()
        pool = runner.slot_importance_pool(ds, AUC_PHASES,
                                           pool_size=AUC_POOL)
        return perm, pool, t1 - t0, time.perf_counter() - t1

    auc_s, (perm, pool, perm_s, pool_s), launches = counted(
        both, {"seqpool_cvm_cuda": evals * n_batches}, "auc runner (4t)")
    restored = all(np.array_equal(f, r.uint64_feas) and
                   np.array_equal(o, r.uint64_offsets)
                   for (f, o), r in zip(before, ds.records))
    require(restored and len(before) == ds.num_instances(),
            "auc runner (4t): the dataset was not restored bit for bit")
    require(sorted(perm) == list(range(AUC_SLOTS)) and sorted(pool) ==
            sorted(s for ph in AUC_PHASES for s in ph) and all(
                np.isfinite(v) for v in [*perm.values(), *pool.values()]),
            f"auc runner (4t): importances {perm} {pool}")
    print(f"auc runner (4t): one trainer file ({n_batches} batches of "
          f"B={TB}, {train_s:.2f} s, auc {metrics['auc']:.6f}); "
          f"slot_importance over {AUC_SLOTS} slots {perm_s:.2f} s "
          f"{ {k: float(f'{v:.6f}') for k, v in perm.items()} }; "
          f"slot_importance_pool phases {list(AUC_PHASES)} pool "
          f"{AUC_POOL} {pool_s:.2f} s "
          f"{ {k: float(f'{v:.6f}') for k, v in pool.items()} }; "
          f"{evals} evaluations, launches {launches}; dataset restored bit "
          f"for bit")
    result = {"launches": {"auc_runner": launches}, "ctr_errs": errs,
              "perm_s": perm_s, "pool_s": pool_s,
              "phase_s": time.perf_counter() - t_phase}
    print(f"ctr ops and auc runner (4t): {result['phase_s']:.1f} s")
    return result


# -- phase 4u: the networked PS service ----------------------------------------

PS_SHARDS = 2                # shard servers of the service
PS_IMPORT_CHUNK = 1 << 20    # rows an import_rows call carries
PS_KILL_BATCH = TNPAD        # keys a step of (c), a training batch's


def hist_mean(reg, name: str, since=(0, 0.0)) -> Tuple[float, int]:
    """(mean, count) of a histogram's observations after ``since``, an
    earlier (count, sum) of it."""
    h = reg.histogram(name)
    n, total = h.count - since[0], h.sum - since[1]
    return (total / n if n else 0.0), n


def hist_mark(reg, name: str) -> Tuple[int, float]:
    h = reg.histogram(name)
    return h.count, h.sum


def host_engine_pass(tr, ds) -> Tuple[float, list, dict]:
    """One ``train_from_dataset`` pass: (seconds, losses, metrics)."""
    losses = []
    secs, metrics = timed_secs(lambda: tr.train_from_dataset(
        ds, fetch_handler=lambda s, loss, p: losses.append(loss)))
    return secs, losses, metrics


def phase_ps_service(rng, files, bundle: str, batches) -> dict:
    """(4u) The networked PS service on the card's host: (a) the flagship
    DeepFM at B=2048 on the host-table engine over a 2-shard service, one
    trainer-cell file, bit for bit against the same over a local
    ``EmbeddingTable``, then both timed in turns; (b) phase 3's bundle
    loaded into a 2-shard service by ``import_rows``, ``CTRPredictor(
    ps_endpoints=)`` scoring phase 3's batches bit for bit against the
    bundle's predictor, both timed in turns with their device bytes; (c)
    the drill's ``shard_kill`` at the flagship width; (d) its
    ``cache_wall``."""
    t_phase = time.perf_counter()
    conf, tconf, _buckets = train_confs()
    feed = trainer_feed_conf()
    ds = SlotDataset(feed, buckets=BucketSpec(min_size=TNPAD,
                                              max_size=1 << 18))
    ds.set_filelist(files[:1])
    ds.load_into_memory()
    n_batches = ds.num_instances() // TB
    expect = {"seqpool_cvm_cuda": n_batches,
              "seqpool_cvm_grad_cuda": n_batches}
    reg = MetricsRegistry()
    t0 = time.perf_counter()
    svc = ShardService({"embedding": conf}, num_shards=PS_SHARDS,
                       registry=reg)
    spawn_s = time.perf_counter() - t0
    launches = {}
    try:
        # (a) training through the service
        model = random_deepfm(rng, TS * conf.pull_dim)
        local = CTRTrainer(copy.deepcopy(model), feed, conf, tconf,
                           table=EmbeddingTable(conf),
                           use_device_table=False)
        remote_table = RemoteTable(conf, svc.client(), cache_rows=0)
        remote = CTRTrainer(model, feed, conf, tconf, table=remote_table,
                            use_device_table=False)
        require(not local.fused and not remote.fused,
                "ps service (4u): not the host-table engine")
        _, want, launches["ps_local_train"] = counted(
            lambda: host_engine_pass(local, ds), expect,
            "ps service (4u) local table")
        bytes0 = {k: reg.counter(f"ps.remote.bytes_{k}").get()
                  for k in ("in", "out")}
        pull0 = hist_mark(reg, "ps.remote.pull_ms")
        push0 = hist_mark(reg, "ps.remote.push_ms")
        _, got, launches["ps_service_train"] = counted(
            lambda: host_engine_pass(remote, ds), expect,
            "ps service (4u) remote table")
        wire = {k: (reg.counter(f"ps.remote.bytes_{k}").get() - v)
                / n_batches for k, v in bytes0.items()}
        pull_ms, n_pulls = hist_mean(reg, "ps.remote.pull_ms", pull0)
        push_ms, _ = hist_mean(reg, "ps.remote.push_ms", push0)

        def same_training(tag: str) -> None:
            snap = local.table.snapshot(reset_dirty=False)
            order = np.argsort(snap["keys"], kind="stable")
            rows = {k: v[order] for k, v in snap.items()}
            merged = remote_table.merged_snapshot()
            require(set(rows) == set(merged) and all(
                np.array_equal(rows[k], merged[k]) for k in rows),
                f"ps service (4u) {tag}: rows differ from the local table")
            require(all(torch.equal(a, b) for a, b in zip(
                local.model.state_dict().values(),
                remote.model.state_dict().values())),
                f"ps service (4u) {tag}: dense weights differ")

        require(got[1] == want[1] and got[2] == want[2],
                "ps service (4u) (a): losses or metrics differ from the "
                "local table's")
        same_training("(a)")
        turns = {"local": [], "remote": []}
        for name in ("local", "remote", "remote", "local"):
            tr = local if name == "local" else remote
            turns[name].append(host_engine_pass(tr, ds)[0] / n_batches * 1e3)
        same_training("(a) after the turns")
        rows_a = len(local.table)
        print(f"ps service (4u) (a): {PS_SHARDS} shards spawned in "
              f"{spawn_s:.3f} s; CTRTrainer host-table engine, DeepFM "
              f"B={TB}, {n_batches} steps: remote bit for bit with the "
              f"local table (losses, metrics, {rows_a} rows by key, dense "
              f"weights), also after 2 more passes each; launches local "
              f"{launches['ps_local_train']} remote "
              f"{launches['ps_service_train']}; ms/step in turns local "
              f"{[round(v, 3) for v in turns['local']]} remote "
              f"{[round(v, 3) for v in turns['remote']]}; a step's wire "
              f"bytes out {wire['out']:.0f} in {wire['in']:.0f}, pull "
              f"{pull_ms:.3f} ms ({n_pulls} pulls) push {push_ms:.3f} ms "
              f"[{card_line()}]")

        # (b) serving through the service
        with open(os.path.join(bundle, "model.json")) as f:
            sconf = TableConfig(**json.load(f)["table"])
        ssvc = ShardService({"embedding": sconf}, num_shards=PS_SHARDS,
                            registry=reg)
        try:
            t0 = time.perf_counter()
            with np.load(os.path.join(bundle, "table.npz")) as z:
                snap = {k: z[k] for k in ("keys", "values", "state")}
            loader = RemoteTable(sconf, ssvc.client(), cache_rows=0)
            for i in range(0, snap["keys"].size, PS_IMPORT_CHUNK):
                sl = slice(i, i + PS_IMPORT_CHUNK)
                loader.import_rows(snap["keys"][sl], snap["values"][sl],
                                   snap["state"][sl])
            import_s = time.perf_counter() - t0
            require(len(loader) == TABLE_ROWS,
                    f"ps service (4u) (b): {len(loader)} rows imported")

            def built(fn):
                gc.collect()
                torch.cuda.synchronize()
                m0 = torch.cuda.memory_allocated()
                pred = fn()
                pred.predict_batch(batches[0])      # warm-up
                torch.cuda.synchronize()
                return pred, torch.cuda.memory_allocated() - m0

            bundle_pred, bundle_bytes = built(lambda: CTRPredictor(bundle))
            ps_pred, ps_bytes = built(lambda: CTRPredictor(
                bundle, ps_endpoints=ssvc.endpoints()))
            require(isinstance(ps_pred.table, RemoteTable) and
                    ps_pred.table._cache is None, "ps service (4u) (b): "
                    "the predictor does not pull through the service")
            serve_expect = {"seqpool_cvm_cuda": len(batches)}
            _, want_s, launches["ps_bundle_serve"] = counted(
                lambda: [bundle_pred.predict_batch(b) for b in batches],
                serve_expect, "ps service (4u) bundle predictor")
            _, got_s, launches["ps_service_serve"] = counted(
                lambda: [ps_pred.predict_batch(b) for b in batches],
                serve_expect, "ps service (4u) service predictor")
            require(all(np.array_equal(g, w) for g, w in zip(got_s, want_s)),
                    "ps service (4u) (b): scores through the service differ "
                    "from the bundle's")
            serve_turns = {"bundle": [], "service": []}
            # the predictor's client reports to the global registry
            sreg = ps_pred.table.registry
            pull1 = hist_mark(sreg, "ps.remote.pull_ms")
            in1 = sreg.counter("ps.remote.bytes_in").get()
            for name in ("bundle", "service", "service", "bundle"):
                pred = bundle_pred if name == "bundle" else ps_pred
                secs, _ = timed_secs(lambda: [pred.predict_batch(b)
                                              for b in batches])
                serve_turns[name].append(secs / len(batches) * 1e3)
            serve_pull_ms, serve_pulls = hist_mean(sreg, "ps.remote.pull_ms",
                                                   pull1)
            serve_in = (sreg.counter("ps.remote.bytes_in").get() - in1) / \
                max(serve_pulls, 1)
            print(f"ps service (4u) (b): {TABLE_ROWS} rows imported into "
                  f"{PS_SHARDS} shards in {import_s:.2f} s; "
                  f"CTRPredictor(ps_endpoints=) over {len(batches)} batches "
                  f"of B={B} bit for bit with the bundle's predictor; "
                  f"launches bundle {launches['ps_bundle_serve']} service "
                  f"{launches['ps_service_serve']}; ms/batch in turns "
                  f"bundle {[round(v, 3) for v in serve_turns['bundle']]} "
                  f"service {[round(v, 3) for v in serve_turns['service']]};"
                  f" a pull {serve_pull_ms:.3f} ms, {serve_in:.0f} bytes in; "
                  f"device bytes bundle {bundle_bytes} service {ps_bytes} "
                  f"[{card_line()}]")
            del bundle_pred, ps_pred, snap
        finally:
            ssvc.stop()
    finally:
        svc.stop()

    # (c) shard_kill at the flagship width; (d) cache_wall
    pool = ds.extract_keys()
    t0 = time.perf_counter()
    kill = ps_drill.scenario_shard_kill(
        int(rng.integers(1 << 30)), os.path.join(WORK, "ps_kill"),
        conf=conf, pool=pool, batch=PS_KILL_BATCH)
    kill_s = time.perf_counter() - t0
    require(kill["ok"], f"ps service (4u) (c): {kill['detail']}")
    print(f"ps service (4u) (c): shard_kill over {pool.size} keys, "
          f"{PS_KILL_BATCH} keys a step, {kill_s:.2f} s: {kill['detail']}")
    t0 = time.perf_counter()
    wall = ps_drill.scenario_cache_wall(int(rng.integers(1 << 30)),
                                        os.path.join(WORK, "ps_wall"))
    wall_s = time.perf_counter() - t0
    require(wall["ok"], f"ps service (4u) (d): {wall['detail']}")
    print(f"ps service (4u) (d): cache_wall {wall_s:.2f} s: "
          f"{wall['detail']} [{card_line()}]")
    result = {"launches": launches, "spawn_s": spawn_s,
              "train_turns_ms": turns, "wire_bytes": wire,
              "pull_ms": pull_ms, "push_ms": push_ms,
              "import_s": import_s, "serve_turns_ms": serve_turns,
              "serve_pull_ms": serve_pull_ms,
              "device_bytes": {"bundle": bundle_bytes, "service": ps_bytes},
              "kill": kill["numbers"], "cache_wall": wall["numbers"],
              "phase_s": time.perf_counter() - t_phase}
    print(f"ps service (4u): {result['phase_s']:.1f} s")
    return result


# -- phase 4v: the device-sharded mesh engine ----------------------------------

MESH_STEPS = 32              # (a): steps of each engine's stream
MESH_CAPACITY = 1 << 22      # (a): arena rows a shard (bench.py:294-330)
MESH_CPU_ROWS = 1 << 18      # (a): the CPU twins' rows: 2 steps' keys
MESH_SHARDS = 4              # (b): shards of the mesh, all on cuda:0
MESH_B_STEPS = 8             # (b): its steps, in runs of MESH_B_CHUNK
MESH_B_CHUNK = 4
MESH_B_CAPACITY = 1 << 19    # (b): rows a shard (8 steps' keys)
MESH_C_CAPACITY = 1 << 21    # (c): the trainer's rows a shard
MERGE = "segment_merge"
SHORT_MERGE_KEYS = 32        # the short merge kernel's longest segment
MERGE_REPLAYS = 3            # (d): replays of a captured merge, each checked
MESH_WRAPPERS = DEVICE_PREP_WRAPPERS + (segment_merge_cuda,)


def mesh_expect(steps: int, ndev: int, device_prep: bool) -> dict:
    """Launches of ``steps`` mesh steps over ``ndev`` shards: each shard's
    forward, backward, push and requester merge; device prep: the
    requester's K5 (whose order the merge takes) and the owner's K5 with
    K6 folded in (two sorts); host plan: the merge order's boundary kernel
    of the requester's merge and of the push."""
    n = steps * ndev
    out = {"seqpool_cvm_cuda": n, "seqpool_cvm_grad_cuda": n,
           "sparse_push_cuda": n, "segment_merge_cuda": n}
    if device_prep:
        out.update(dedup_sort_cuda=2 * n, device_dedup_cuda=n,
                   device_dedup_probe_cuda=n)
    else:
        out["merge_offsets"] = 2 * n
    return out


def mesh_tuples(batches):
    """(keys, segs, labels) batches of the training shape as one-shard
    ``train_stream`` tuples ([1, ...] each) and as ``FusedTrainStep``'s."""
    flat, sharded = [], []
    for keys, segs, labels in batches:
        args = (keys, segs, np.stack([np.ones(TB, np.float32), labels], 1),
                labels, np.zeros((TB, 0), np.float32),
                np.ones(TB, np.float32))
        flat.append(args)
        sharded.append(tuple(a[None] for a in args))
    return flat, sharded


def split_batches(rng, n: int, ndev: int):
    """``n`` batches of the training shape (global B=TB) split row-wise
    over ``ndev`` shards (``split_batch``), as ``train_stream`` tuples."""
    out = []
    while len(out) < n:
        lengths = rng.integers(1, 4, size=(TB, TS)).astype(np.int32)
        nk = int(lengths.sum())
        if nk > TNPAD:
            continue
        segs, _ = segment_layout(TB, TS, lengths.reshape(-1), TNPAD)
        keys = np.zeros(TNPAD, np.uint64)
        keys[:nk] = rng.integers(1, HOT_VOCAB, size=nk)
        labels = rng.integers(0, 2, size=TB).astype(np.float32)
        sb = split_batch(CsrBatch(keys, segs, lengths, labels,
                                  np.zeros((TB, 0), np.float32), TB, TS, nk,
                                  TB), ndev)
        out.append((sb.keys, sb.segment_ids,
                    np.stack([np.ones_like(sb.labels), sb.labels], -1),
                    sb.labels, sb.dense, sb.row_mask))
    return out


def mesh_world(model, device, ndev: int, capacity: int, device_prep: bool):
    conf, tconf, _ = train_confs()
    table = ShardedDeviceTable(conf, make_mesh(ndev, device=device),
                               capacity_per_shard=capacity, backend="native")
    step = FusedShardedTrainStep(model, table, tconf, TB // ndev, TS,
                                 device_prep=device_prep)
    return step, table, [*step.init(), step.init_auc_state()]


def carry_shards(src: ShardedDeviceTable, dst, rows: int) -> None:
    """``src``'s first ``rows`` arena rows of each shard into ``dst``'s
    (a ``ShardedDeviceTable`` or a ``DeviceTable``)."""
    vals = dst.values if isinstance(dst.values, list) else [dst.values]
    state = dst.state if isinstance(dst.state, list) else [dst.state]
    for s in range(len(vals)):
        vals[s][:rows].copy_(src.values[s][:rows])
        state[s][:rows].copy_(src.state[s][:rows])


def mesh_stream(world, tuples, chunk=None, snap=None):
    """``train_stream`` over ``tuples``; returns the per-step losses (host
    floats). ``snap(steps)`` runs after each step."""
    step, _, st = world
    losses = []

    def on_step(i, loss):
        losses.append(loss)
        if snap is not None:
            snap(i)

    *st[:], _, n = step.train_stream(*st, iter(tuples), chunk=chunk,
                                     on_step=on_step)
    require(n == len(tuples), f"mesh: {n} steps of {len(tuples)}")
    return [float(x) for x in losses]


def shard_rows(table, keys: np.ndarray, model=None):
    """The rows of ``keys`` (each in shard 0's index) on a one-shard
    table: (values, state, dense params) on the host."""
    rows, _ = table._indexes[0].lookup(keys, False, True, 0)
    require(bool((rows > 0).all()), "mesh: a touched key has no row")
    idx = torch.from_numpy(rows.astype(np.int64)).to(table.devices[0])
    return (table.values[0][idx].cpu(), table.state[0][idx].cpu(),
            None if model is None else
            [p.detach().cpu().clone() for p in model.parameters()])


def snapshot_by_key(table):
    snap = table.snapshot()
    order = np.argsort(snap["keys"])
    return tuple(snap[k][order] for k in ("keys", "values", "state"))


def require_close_tables(tag: str, a, b) -> float:
    """Two tables' snapshots by key: the same keys, show/clk exact, the
    rest within TRAIN_ATOL. Returns the largest difference."""
    (ka, va, sa), (kb, vb, sb) = snapshot_by_key(a), snapshot_by_key(b)
    require(np.array_equal(ka, kb), f"{tag}: the tables hold other keys")
    require(np.array_equal(va[:, :2], vb[:, :2]), f"{tag}: show/clk differ")
    err = max(float(np.abs(va - vb).max()), float(np.abs(sa - sb).max()))
    require(err <= TRAIN_ATOL, f"{tag}: rows by key differ by {err}")
    return err


F32_UNIT = 2.0 ** -24        # float32's unit roundoff


def adam_host(state) -> dict:
    return {"count": state["count"].cpu().clone(),
            "mu": [m.cpu().clone() for m in state["mu"]],
            "nu": [v.cpu().clone() for v in state["nu"]]}


def host_grads(grads) -> list:
    return [None if g is None else g.detach().cpu().clone() for g in grads]


class DenseRecorder:
    """A mesh step's dense state around each of its updates, as host
    copies: the params and adam's state before the step (``pre``), each
    shard's dense gradients (``shard_grads``), the summed ones the update
    took (``grads``), the params and state after it (``post``).
    ``replay``: before each step, the world's params and adam state are
    overwritten in place by ``replay.pre`` of that step (a re-synced
    twin)."""

    def __init__(self, step, replay=None):
        self.step, self.replay = step, replay
        self.pre, self.grads, self.post, self.shard_grads = [], [], [], []
        dense_step, update = step._dense_step, step.optimizer.update
        shard_grads = step._shard_grads

        def rec_dense_step(params, opt_state, *args):
            if self.replay is not None:
                load_dense_state(params, opt_state,
                                 self.replay.pre[len(self.pre)])
            self.pre.append({"params": [p.detach().cpu().clone()
                                        for p in params.parameters()],
                             "adam": adam_host(opt_state)})
            return dense_step(params, opt_state, *args)

        def rec_shard_grads(models, embs, inputs):
            out = shard_grads(models, embs, inputs)
            self.shard_grads.append([host_grads(g) for g in out[3]])
            return out

        def rec_update(model, state):
            self.grads.append(host_grads(p.grad for p in model.parameters()))
            out = update(model, state)
            self.post.append({"params": [p.detach().cpu().clone()
                                         for p in model.parameters()],
                              "adam": adam_host(state)})
            return out

        step._dense_step = rec_dense_step
        step._shard_grads = rec_shard_grads
        step.optimizer.update = rec_update

    def detach(self) -> None:
        for name in ("_dense_step", "_shard_grads"):
            self.step.__dict__.pop(name, None)
        self.step.optimizer.__dict__.pop("update", None)


def relu_linears(model) -> list:
    """The ``nn.Linear`` layers of a model's MLP that a ReLU follows."""
    return [lin for mlp in model.modules() if isinstance(mlp, MLP)
            for lin in mlp.layers[:-1]]


class KinkAligner:
    """The card's pre-activations of every ReLU layer of every forward
    (``record`` on the card's models), and a twin's (``follow`` on its
    models, their forwards in the same order) set to the card's value
    where the two lie on opposite sides of 0 within the float32 rounding
    bound of the layer's product, (fan_in + 1) * 2^-24 * (|x| |W|^T +
    |b|): one ReLU, flipped by rounding alone, would otherwise switch a
    whole row's term into or out of the layer's gradient. The value
    moves; the gradient still flows through the twin's own product."""

    def __init__(self):
        self.z, self.at, self.aligned, self._hooks = {}, {}, 0, []

    def record(self, *models) -> "KinkAligner":
        for m in models:
            for li, lin in enumerate(relu_linears(m)):
                self._hooks.append(lin.register_forward_hook(
                    self._recorder(li)))
        return self

    def _recorder(self, li: int):
        def hook(mod, inp, out):
            self.z.setdefault(li, []).append(out.detach().cpu())
        return hook

    def follow(self, *models, group: int = 1) -> "KinkAligner":
        """A twin's hooks: each of its forwards of layer ``li`` takes the
        next ``group`` recorded ones of that layer, joined by rows (a twin
        on the merged batch follows the shards' forwards). ``aligned``
        counts this twin's."""
        self.at, self.aligned = {}, 0
        for m in models:
            for li, lin in enumerate(relu_linears(m)):
                self._hooks.append(lin.register_forward_hook(
                    self._follower(li, group)))
        return self

    def _follower(self, li: int, group: int):
        def hook(mod, inp, out):
            i = self.at.get(li, 0)
            self.at[li] = i + group
            zc = torch.cat(self.z[li][i:i + group]).to(out.device)
            x = inp[0].detach()
            bound = (x.shape[-1] + 1) * F32_UNIT * (
                x.abs() @ mod.weight.detach().abs().t()
                + mod.bias.detach().abs())
            flip = ((zc > 0) != (out > 0)) & ((zc - out).abs() <= bound)
            n = int(flip.sum())
            if not n:
                return None
            self.aligned += n
            return out + torch.where(flip, zc - out,
                                     torch.zeros_like(out)).detach()
        return hook

    def remove(self) -> None:
        for h in self._hooks:
            h.remove()
        self._hooks = []


def shard_order_sum(parts) -> torch.Tensor:
    """Host float32 ``parts[0] + parts[1] + ...`` in that order (None a
    zero), as ``Mesh.psum`` adds them."""
    ref = next(p for p in parts if p is not None)
    out = None
    for p in parts:
        p = torch.zeros_like(ref) if p is None else p
        out = p.clone() if out is None else out + p
    return out


def compare_dense_steps(rec, twin, fails: list,
                        exact_sums: bool = True) -> dict:
    """Step by step, a recorded step's (``rec``: a ``DenseRecorder``) dense
    update against its re-synced twin's (``twin``: one with ``grads`` and
    ``post``): adam's count equal; with ``exact_sums`` the summed dense
    gradients equal the shards' added in shard order, bit for bit; each
    parameter's summed gradient within TRAIN_RTOL of the twin's in norm;
    the params after the step within TRAIN_ATOL. Failures go to
    ``fails``; returns the largest differences."""
    worst = {"dense": 0.0, "grad_rel": 0.0}
    for t in range(len(rec.grads)):
        if int(rec.post[t]["adam"]["count"]) != \
                int(twin.post[t]["adam"]["count"]):
            fails.append(f"step {t + 1}: adam counts differ")
        for i, (g, gp) in enumerate(zip(rec.grads[t], twin.grads[t])):
            if exact_sums and (g is None or not torch.equal(
                    g, shard_order_sum([sg[i] for sg in
                                        rec.shard_grads[t]]))):
                fails.append(f"step {t + 1}, param {i}: the summed dense "
                             "gradients are not the shards' added in "
                             "shard order")
                continue
            rel = float((g - gp).norm() / gp.norm().clamp(min=1e-30))
            worst["grad_rel"] = max(worst["grad_rel"], rel)
            if rel > TRAIN_RTOL:
                fails.append(f"step {t + 1}, param {i}: summed dense "
                             f"gradients {rel:.3g} from the twin's in norm")
            dp = float((rec.post[t]["params"][i] -
                        twin.post[t]["params"][i]).abs().max())
            worst["dense"] = max(worst["dense"], dp)
            if dp > TRAIN_ATOL:
                fails.append(f"step {t + 1}, param {i}: dense params {dp} "
                             "from the re-synced twin's")
    return worst


class UpdateRecorder:
    """A dense optimizer's updates: the grads each took (``grads``) and the
    params and adam state after it (``post``), as host copies."""

    def __init__(self, optimizer):
        self.optimizer, self.grads, self.post = optimizer, [], []
        update = optimizer.update

        def rec_update(model, state):
            self.grads.append(host_grads(p.grad for p in model.parameters()))
            out = update(model, state)
            self.post.append({"params": [p.detach().cpu().clone()
                                         for p in model.parameters()],
                              "adam": adam_host(state)})
            return out
        optimizer.update = rec_update

    def detach(self) -> None:
        self.optimizer.__dict__.pop("update", None)


def load_dense_state(model, state, src) -> None:
    """``src`` (a recorded ``pre``: params and adam state, host copies)
    into ``model`` and ``state`` in place."""
    with torch.no_grad():
        for p, q in zip(model.parameters(), src["params"]):
            p.copy_(q)
        state["count"].copy_(src["adam"]["count"])
        for name in ("mu", "nu"):
            for a, b in zip(state[name], src["adam"][name]):
                a.copy_(b)


def check_mesh_dense(tag: str, card, cpu, batches, rec: DenseRecorder,
                     kinks: KinkAligner, losses) -> dict:
    """4v (b)'s dense check, a re-synced twin: ``cpu`` (the same mesh on
    the CPU, the same arena) takes each step from the card's dense params
    and adam state before it (``rec``, recorded on the card), so that no
    rounding builds up over the steps; its ReLU pre-activations take the
    card's where rounding alone put them on the other side of 0
    (``kinks``, recorded on the card). Each step:

    - the summed dense gradients the card's update took equal its shards'
      gradients added in shard order, bit for bit (float32 adds in one
      order round alike on the card and the host);
    - each parameter's summed gradient within TRAIN_RTOL of the twin's,
      in norm;
    - the params after the step within TRAIN_ATOL of the twin's, adam's
      count equal.

    Then the 8-step losses (rtol) and the tables' rows by key, as before.
    Every failure is gathered before the one ``require``. Returns the
    largest differences."""
    cpu_rec = DenseRecorder(cpu[0], replay=rec)
    kinks.follow(cpu[2][0])
    try:
        twin = mesh_stream(cpu, batches, chunk=MESH_B_CHUNK)
    finally:
        cpu_rec.detach()
        kinks.remove()
    require(len(rec.grads) == len(cpu_rec.grads) == len(batches),
            f"{tag}: {len(rec.grads)} card and {len(cpu_rec.grads)} CPU "
            f"updates over {len(batches)} steps")
    fails = []
    if not np.allclose(losses, twin, rtol=TRAIN_RTOL, atol=0):
        fails.append(f"losses {losses} vs the re-synced CPU's {twin}")
    try:
        rows_err = require_close_tables(tag, card[1], cpu[1])
    except RuntimeError as e:
        fails.append(str(e))
        rows_err = float("nan")
    worst = compare_dense_steps(rec, cpu_rec, fails)
    worst["kinks_aligned"] = kinks.aligned
    worst["rows"] = rows_err
    require(not fails, f"{tag}: {len(fails)} failures: {fails[:4]}")
    return worst


MERGE_PROFILE_CALLS = 20     # (d): merge calls in a profiled run


def zipf_keys(rng, like: np.ndarray) -> np.ndarray:
    """``like``'s layout (its real keys first, then padding) with the real
    keys drawn by a Zipf law (exponent 1.2, phase 4m's mix) over
    HOT_VOCAB - 1 keys in a random rank order: a skewed head that repeats
    hundreds of times in a batch."""
    nk = int((like > 0).sum())
    ranked = rng.permutation(np.arange(1, HOT_VOCAB, dtype=np.uint64))
    keys = np.zeros_like(like)
    keys[:nk] = ranked[np.minimum(rng.zipf(1.2, size=nk) - 1,
                                  ranked.size - 1)]
    return keys


CRITEO_FEW_SLOT = 8          # (d): Criteo's C9, a slot of a few values
CRITEO_FEW_VALUES = 3


def criteo_keys(rng, like: np.ndarray) -> np.ndarray:
    """``like``'s length, holding one batch of TB rows of slot-keyed Criteo
    traffic, row by row, then padding: the package's generator
    (``make_synthetic_criteo``: a key ``(slot + 1) << 32 | value``, at most
    one a slot a row, each slot Zipf(1.3) over 1,000 values, 5% missing),
    with slot C9 drawn by the same generator over CRITEO_FEW_VALUES values
    (a slot of a few values, as Criteo's C9 and C20: its hottest value
    repeats past a chunk)."""
    seed = int(rng.integers(1 << 31))
    os.makedirs(WORK, exist_ok=True)
    mats = []
    for values in (1000, CRITEO_FEW_VALUES):
        path = os.path.join(WORK, f"merge_criteo_{values}.txt")
        make_synthetic_criteo(path, TB, seed=seed + values,
                              vocab_per_slot=values)
        with open(path, "rb") as f:
            _, _, keys, lengths = _parse_lines(f.readlines())
        mat = np.zeros(lengths.shape, dtype=np.uint64)
        mat[lengths > 0] = keys  # row by row, as the parser read them
        mats.append(mat)
    mats[0][:, CRITEO_FEW_SLOT] = mats[1][:, CRITEO_FEW_SLOT]
    flat = mats[0][mats[0] > 0]
    out = np.zeros_like(like)
    out[:flat.size] = flat
    return out


def merge_work(offsets: torch.Tensor) -> Tuple[int, int, int]:
    """The long merge kernel's work of these segments: (its work items, a
    chunk of ``SEGMENT_CHUNK`` keys of each segment past
    ``SHORT_MERGE_KEYS``; the longest segment's keys; its chunks)."""
    lens = (offsets[1:] - offsets[:-1]).long()
    chunks = -(-lens // SEGMENT_CHUNK)
    longest = int(lens.max()) if lens.numel() else 0
    return (int(chunks[lens > SHORT_MERGE_KEYS].sum()), longest,
            -(-longest // SEGMENT_CHUNK))


def check_merge(tag: str, demb, order, offsets, want) -> None:
    """The merge kernel equals ``want`` (its plain version's ``g``) bit for
    bit: two launches on the same inputs, and a launch captured in a CUDA
    graph after each of MERGE_REPLAYS replays (the counters are zeroed
    inside the captured sequence)."""
    for i in range(2):
        got = segment_merge_cuda(demb, order, offsets)
        require(torch.equal(got, want), f"{MERGE} {tag}: launch {i} differs "
                                        "from plain")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        segment_merge_cuda(demb, order, offsets)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = segment_merge_cuda(demb, order, offsets)
    for i in range(MERGE_REPLAYS):
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        require(torch.equal(out, want), f"{MERGE} {tag}: graph replay {i} "
                                        "differs from plain")


def merge_inputs(step, keys: np.ndarray, R: int, rng,
                 by_unique: bool = True):
    """The merge's inputs that the step gives it for ``keys`` (``_route``):
    device prep merges by unique over K5's order with key 0's segment
    emptied (``_unique_merge_order``), the host plan by request position
    (``merge_order`` of the positions, the null position's keys at the
    dropped segment M); random grads. Returns (demb, order, offsets, the
    request positions with M at null: ``index_add_``'s index)."""
    M = step.ndev * R
    _, seg, _, dd, _ = step._route(
        torch.from_numpy(keys.view(np.int64)).cuda(), R)
    seg = torch.where(seg > 0, seg, M).to(torch.int32)
    if by_unique:
        order, offsets = step._unique_merge_order(dd)
    else:
        order, offsets = merge_order(seg, M + 1)
        offsets = offsets[:M + 1]
    demb = torch.from_numpy(rng.normal(size=(keys.size, D)).astype(
        np.float32)).cuda()
    return demb, order, offsets, seg


def merge_bytes(offsets: torch.Tensor) -> int:
    """The merge's bytes at D: the merged keys' grads and order entries
    read once, the offsets read, g written once."""
    n_live = int(offsets[-1] - offsets[0])
    return n_live * D * 4 + n_live * 8 + offsets.numel() * 4 + \
        (offsets.numel() - 1) * D * 4


def merge_case(tag: str, step, keys: np.ndarray, R: int, rng,
               by_unique: bool = True) -> dict:
    """(d) The merge kernel against its plain version on the card at one
    shape, on ``merge_inputs``, bit for bit; its times per call and in a
    CUDA graph beside the bound and ``index_add_`` (the merge only, by
    position); after them, bit for bit again (``check_merge``: two
    launches, graph replays). Then the long kernel's work items and the
    segments past the short kernel's 32 keys, with each kernel's device
    time from a profiled run."""
    M = step.ndev * R
    demb, order, offsets, seg = merge_inputs(step, keys, R, rng, by_unique)
    n_seg = offsets.numel() - 1
    n_live = int(offsets[-1] - offsets[0])
    got = segment_merge_cuda(demb, order, offsets)
    # the plain version reads the longest chunk back (no graph) and makes a
    # pass a key rank of a chunk: the check's call is its time
    plain_s, want = timed_secs(lambda: segment_merge_plain(demb, order,
                                                           offsets))
    err = float((got - want).abs().max())
    require(torch.equal(got, want), f"{MERGE} {tag}: kernel vs plain max "
                                    f"abs err {err}, not bit for bit")
    seg_l = seg.long()
    g = torch.empty((M + 1, D), dtype=torch.float32, device="cuda")
    kernel = lambda: segment_merge_cuda(demb, order, offsets)  # noqa: E731
    library = lambda: g.zero_().index_add_(0, seg_l, demb)  # noqa: E731
    t = {"ms": cuda_ms(kernel, ITERS), "plain_ms": plain_s * 1e3,
         "library_ms": cuda_ms(library, ITERS), "graph_ms": graph_ms(kernel),
         "plain_graph_ms": None, "library_graph_ms": graph_ms(library),
         "max_abs_err": err, "keys": keys.size, "merged_keys": n_live,
         "segments": n_seg, "by": "unique" if by_unique else "position"}
    check_merge(f"{tag} after the timings", demb, order, offsets, want)
    lens = offsets[1:] - offsets[:-1]
    t["work_items"], longest, t["longest_chunks"] = merge_work(offsets)
    t["long_segments"] = int((lens > SHORT_MERGE_KEYS).sum())
    t["long_segment_keys"] = int(lens[lens > SHORT_MERGE_KEYS].sum())
    t["chunked_segments"] = int((lens > SEGMENT_CHUNK).sum())
    t["chunked_segment_keys"] = int(lens[lens > SEGMENT_CHUNK].sum())
    n_full = max(int((lens > 0).sum()), 1)
    key_share = (lambda n: 100 * n / max(n_live, 1))  # noqa: E731
    by_name = device_profile(f"{MERGE} {tag}", lambda: [
        kernel() for _ in range(MERGE_PROFILE_CALLS)], kernels=(MERGE,))
    long_us = [us for name, us in by_name.items()
               if "segment_merge_long" in name]
    short_us = [us for name, us in by_name.items()
                if "segment_merge_short" in name]
    t["long_kernel_ms"] = (sum(long_us) / MERGE_PROFILE_CALLS / 1e3
                           if long_us else None)
    t["short_kernel_ms"] = (sum(short_us) / MERGE_PROFILE_CALLS / 1e3
                            if short_us else None)
    with_bound(t, merge_bytes(offsets), n_live * D)
    fmt = (lambda x: "not measured" if x is None else f"{x:.5f} ms")
    print(f"timing {MERGE} {tag} (keys {keys.size}, {n_live} of them "
          f"merged, by {t['by']}, key 0's dropped; segments {n_seg}, D={D}, "
          f"longest segment {longest} keys ({t['longest_chunks']} chunks of "
          f"{SEGMENT_CHUNK}), {t['long_segments']} segments of more than "
          f"{SHORT_MERGE_KEYS} keys holding {t['long_segment_keys']} keys "
          f"({100 * t['long_segments'] / n_full:.2f}% of the {n_full} "
          f"segments with keys, {key_share(t['long_segment_keys']):.2f}% "
          f"of the keys), {t['chunked_segments']} of more than "
          f"{SEGMENT_CHUNK} holding {t['chunked_segment_keys']} "
          f"({100 * t['chunked_segments'] / n_full:.3f}%, "
          f"{key_share(t['chunked_segment_keys']):.2f}%): "
          f"{t['work_items']} work items): kernel vs plain bit for bit, "
          f"and after the timings twice and after {MERGE_REPLAYS} graph "
          f"replays; per call: kernel {t['ms']:.5f} ms, plain "
          f"{t['plain_ms']:.5f} ms (a pass a key rank of a chunk), index_add_ "
          f"{t['library_ms']:.5f} ms; bound {t['bound_ms']:.6f} ms "
          f"({t['bound_bytes']} bytes); in a CUDA graph: kernel "
          f"{t['graph_ms']:.5f} ms ({100 * t['bound_ms'] / t['graph_ms']:.1f}"
          f"% of bound), index_add_ {t['library_graph_ms']:.5f} ms (plain: "
          f"not capturable); device time a call (profiler): short kernel "
          f"{fmt(t['short_kernel_ms'])}, long kernel "
          f"{fmt(t['long_kernel_ms'])}; {card_line()}")
    return t


def merge_edges(rng) -> float:
    """(d) The merge kernel against its plain version, bit for bit
    (``check_merge``), on segments of 0, 1, 31, 32 and 33 keys (the short
    kernel's limit), 2,600 (three chunk-sized stages at D=1, 650 at
    D=256), C - 1, C, C + 1 and 2C + 1 keys (C = SEGMENT_CHUNK: a chunk's
    edges) and 17,612 (the Zipf mix's hot key: 18 chunks), at D = 1, 11,
    64, 256, grads of mixed sign and scale. Returns the largest error
    (0)."""
    C = SEGMENT_CHUNK
    lengths = [0, 1, 31, 32, 33, 0, 2600, 1, 0, C - 1, C, C + 1, 2 * C + 1,
               17612, 0]
    seg = np.repeat(np.arange(len(lengths), dtype=np.int32), lengths)
    seg = seg[rng.permutation(seg.size)]
    err = 0.0
    for dim in (1, 11, 64, 256):
        demb = torch.from_numpy((rng.normal(size=(seg.size, dim)) *
                                 10.0 ** rng.integers(-3, 3, size=(
                                     seg.size, 1))).astype(np.float32)).cuda()
        order, offsets = merge_order(torch.from_numpy(seg).cuda(),
                                     len(lengths))
        got = segment_merge_cuda(demb, order, offsets)
        want = segment_merge_plain(demb, order, offsets)
        e = float((got - want).abs().max())
        require(torch.equal(got, want),
                f"{MERGE} edges D={dim}: kernel vs plain max abs err {e}")
        check_merge(f"edges D={dim}", demb, order, offsets, want)
        err = max(err, e)
    print(f"{MERGE} edges: segments of {lengths} keys at D = 1, 11, 64, "
          f"256 ({merge_work(offsets)[0]} work items): kernel and plain bit "
          f"for bit, twice, and after {MERGE_REPLAYS} graph replays")
    return err


def phase_mesh(rng, files) -> dict:
    """(4v) The device-sharded mesh engine at the reference bench's width
    (``bench.py:280-350``, ``_mesh_child``): (a) a one-shard mesh on
    cuda:0, device prep and host plan through ``train_stream``, against
    ``FusedTrainStep`` on the same batches and weights and, 2 steps, the
    CPU; timed in turns beside ``FusedTrainStep``'s run graphs and eager
    run loop; (b) a 4-shard mesh on cuda:0 (device prep) against the same
    mesh on the CPU; (c) ``CTRTrainer(mesh=make_mesh(1))`` over a trainer
    file, ``evaluate``, save, load and a delta into a ``DeviceTable``; (d)
    the requester's merge kernel against its plain version at (a)'s and
    (b)'s shapes, each also under a Zipf(1.2) key mix, at (a)'s under
    slot-keyed Criteo traffic, and at edge segments, timed."""
    t_phase = time.perf_counter()
    conf, tconf, _ = train_confs()
    model = random_deepfm(rng, TS * conf.pull_dim)
    flat, tuples = mesh_tuples(make_train_batches(rng, MESH_STEPS))
    two_keys = np.unique(np.concatenate([a[0] for a in flat[:CPU_STEPS]]))
    two_keys = two_keys[two_keys > 0]
    all_keys = np.unique(np.concatenate([a[0] for a in flat]))
    all_keys = all_keys[all_keys > 0]
    launches, worlds, out = {}, {}, {"ms_per_step": {}}
    parts, t_part = {}, time.perf_counter()

    def part(name: str) -> None:
        """Wall seconds of the part of the phase that just ended."""
        nonlocal t_part
        now = time.perf_counter()
        parts[name] = round(now - t_part, 2)
        t_part = now

    # (a) each engine: the card's stream counted, against FusedTrainStep
    # from the same arena and weights, its first 2 steps against the CPU
    for engine, dp in (("device_prep", True), ("host_plan", False)):
        tag = f"mesh (4v) (a) {engine}"
        world = mesh_world(copy.deepcopy(model), "cuda", 1, MESH_CAPACITY,
                           dp)
        table = world[1]
        cpu = mesh_world(copy.deepcopy(model), "cpu", 1, MESH_CPU_ROWS, dp)
        carry_shards(table, cpu[1], MESH_CPU_ROWS)
        single = DeviceTable(conf, capacity=MESH_CAPACITY, device="cuda",
                             backend="native", index_threads=1)
        carry_shards(table, single, MESH_CAPACITY)
        fs = FusedTrainStep(copy.deepcopy(model), single, tconf, TB, TS,
                            device_prep=dp)
        fst = [*fs.init(), fs.init_auc_state()]
        at_two = {}

        def snap(i, table=table, at_two=at_two, params=world[2][0]):
            if i == CPU_STEPS:
                at_two["after"] = shard_rows(table, two_keys, params)

        secs, losses, launches[f"mesh_{engine}"] = counted(
            lambda: mesh_stream(world, tuples, snap=snap),
            mesh_expect(MESH_STEPS, 1, dp), tag, MESH_WRAPPERS)
        require(all(np.isfinite(losses)), f"{tag}: non-finite loss")
        want = []
        # each step's loss read at once: a replayed run's are its graph's
        # outputs, which the next replay overwrites
        fs.train_stream(*fst, iter(flat),
                        on_step=lambda i, loss: want.append(float(loss)))
        require(np.allclose(losses, want, rtol=TRAIN_RTOL, atol=0),
                f"{tag}: losses {losses[:4]}... vs FusedTrainStep's "
                f"{want[:4]}...")
        mv, mst, mp = shard_rows(table, all_keys, world[2][0])
        rows, _ = single._index.lookup(all_keys, False, True, 0)
        idx = torch.from_numpy(rows.astype(np.int64)).cuda()
        fv, fst_rows = single.values[idx].cpu(), single.state[idx].cpu()
        require(torch.equal(mv[:, :2], fv[:, :2]), f"{tag}: show/clk differ "
                                                   "from FusedTrainStep's")
        row_err = max(float((mv - fv).abs().max()),
                      float((mst - fst_rows).abs().max()))
        dense_err = max(float((a - b.detach().cpu()).abs().max())
                        for a, b in zip(mp, fst[0].parameters()))
        require(row_err <= TRAIN_ATOL and dense_err <= TRAIN_ATOL,
                f"{tag}: rows {row_err}, dense {dense_err} from "
                "FusedTrainStep's")
        init_vals, init_state = (cpu[1].values[0].clone(),
                                 cpu[1].state[0].clone())
        twin = mesh_stream(cpu, tuples[:CPU_STEPS])
        rows2, _ = cpu[1]._indexes[0].lookup(two_keys, False, True, 0)
        r2 = torch.from_numpy(rows2.astype(np.int64))
        before = (init_vals[r2], init_state[r2], None)
        compare_twin(f"{tag}: card vs CPU", losses, at_two["after"], twin,
                     shard_rows(cpu[1], two_keys, cpu[2][0]), before)
        del cpu, init_vals, init_state
        print(f"{tag}: {MESH_STEPS} steps through train_stream in "
              f"{secs:.2f} s (new keys every step), launches "
              f"{launches[f'mesh_{engine}']}, losses {losses[0]:.6f} -> "
              f"{losses[-1]:.6f}, against FusedTrainStep: losses within "
              f"rtol {TRAIN_RTOL}, {all_keys.size} rows by key max abs err "
              f"{row_err:.3e}, dense {dense_err:.3e}")
        worlds[engine] = world
        worlds[f"fts_{engine}"] = (fs, single, fst)
        part(f"a_{engine}")

    # timed in turns over the same batches, every key now in the tables
    fs, _, fst = worlds["fts_device_prep"]
    runs = {
        "run_graphs": lambda: fs.train_stream(*fst, iter(flat)),
        "eager_run_loop": lambda: eager_run_loop(fs, tuple(fst), flat),
        "mesh_device_prep": lambda: mesh_stream(worlds["device_prep"],
                                                tuples),
        "mesh_host_plan": lambda: mesh_stream(worlds["host_plan"], tuples)}
    turns = {k: [] for k in runs}
    order = list(runs)
    for name in order + order[::-1]:
        secs, _ = timed_secs(runs[name])
        turns[name].append(secs / MESH_STEPS * 1e3)
    for name, ms in turns.items():
        print(f"timing mesh (4v) (a) {name}: ms/step {[round(x, 4) for x in ms]}"
              f", examples/s {[round(TB / x * 1e3, 1) for x in ms]} (B={TB}, "
              f"{MESH_STEPS} steps a turn, in turns; {card_line()})")
    out["ms_per_step"] = turns
    del runs, fs, fst
    worlds.clear()
    torch.cuda.empty_cache()
    part("a_turns")

    # (b) four shards on cuda:0 against four on the CPU
    tag = "mesh (4v) (b) 4 shards"
    b_batches = split_batches(rng, MESH_B_STEPS, MESH_SHARDS)
    card = mesh_world(copy.deepcopy(model), "cuda", MESH_SHARDS,
                      MESH_B_CAPACITY, True)
    cpu = mesh_world(copy.deepcopy(model), "cpu", MESH_SHARDS,
                     MESH_B_CAPACITY, True)
    carry_shards(card[1], cpu[1], MESH_B_CAPACITY)
    rec = DenseRecorder(card[0])
    kinks = KinkAligner().record(card[2][0])
    try:
        secs, losses, launches["mesh_4_shards"] = counted(
            lambda: mesh_stream(card, b_batches, chunk=MESH_B_CHUNK),
            mesh_expect(MESH_B_STEPS, MESH_SHARDS, True), tag,
            MESH_WRAPPERS)
    finally:
        rec.detach()
        kinks.remove()
    t0 = time.perf_counter()
    dense = check_mesh_dense(tag, card, cpu, b_batches, rec, kinks, losses)
    cpu_s = time.perf_counter() - t0
    R4 = card[0]._req_cap(b_batches[0][0].shape[1])
    print(f"{tag}: {MESH_B_STEPS} steps of B={TB} ({TB // MESH_SHARDS} a "
          f"shard, Npad {b_batches[0][0].shape[1]} a shard, R {R4}) in "
          f"{secs:.2f} s, launches {launches['mesh_4_shards']}, against the "
          f"CPU re-synced each step ({cpu_s:.2f} s): losses within rtol "
          f"{TRAIN_RTOL}, {len(card[1])} rows by key max abs err "
          f"{dense['rows']:.3e}, dense sums in shard order bit for bit, "
          f"dense grads within {dense['grad_rel']:.3e} in norm, dense "
          f"params {dense['dense']:.3e}, ReLU pre-activations aligned "
          f"across 0 {dense['kinks_aligned']}, shard fill "
          f"{card[1].shard_sizes()}")
    b_keys = b_batches[0][0][0]
    b_step = card[0]
    del cpu
    part("b")

    # (c) the trainer entry over one trainer file
    tag = "mesh (4v) (c) CTRTrainer(mesh=make_mesh(1))"
    feed = trainer_feed_conf()
    ds = SlotDataset(feed, buckets=BucketSpec(min_size=TNPAD,
                                              max_size=1 << 18))
    ds.set_filelist(files[:1])
    ds.load_into_memory()
    n_rows = ds.num_instances()
    n_batches = n_rows // TB
    tr = CTRTrainer(copy.deepcopy(model), feed, conf, tconf,
                    mesh=make_mesh(1), device_capacity=MESH_C_CAPACITY)
    require(isinstance(tr.table, ShardedDeviceTable) and
            tr.step.device_prep, f"{tag}: not the device-prep mesh engine")
    secs, metrics, launches["mesh_trainer"] = counted(
        lambda: tr.train_from_dataset(ds),
        mesh_expect(n_batches, 1, True), tag, MESH_WRAPPERS)
    require(metrics["ins_num"] == n_rows and 0.0 <= metrics["auc"] <= 1.0,
            f"{tag}: pass metrics {metrics}")
    _, ev, launches["mesh_trainer_evaluate"] = counted(
        lambda: tr.evaluate(ds), {"seqpool_cvm_cuda": n_batches},
        f"{tag} evaluate", MESH_WRAPPERS)
    require(ev["ins_num"] == n_rows and 0.0 <= ev["auc"] <= 1.0,
            f"{tag}: evaluate {ev}")
    os.makedirs(WORK, exist_ok=True)
    base = os.path.join(WORK, "mesh_base.npz")
    delta = os.path.join(WORK, "mesh_delta.npz")
    t0 = time.perf_counter()
    tr.table.save(base)
    save_s = time.perf_counter() - t0
    fresh = ShardedDeviceTable(conf, make_mesh(1),
                               capacity_per_shard=MESH_C_CAPACITY,
                               backend="native")
    t0 = time.perf_counter()
    fresh.load(base)
    load_s = time.perf_counter() - t0
    kb, vb, sb = snapshot_by_key(tr.table)
    kf, vf, sf = snapshot_by_key(fresh)
    require(np.array_equal(kb, kf) and np.array_equal(vb, vf) and
            np.array_equal(sb, sf), f"{tag}: the loaded table differs")
    del fresh
    # one more step (the first batch again): its rows are the delta
    sb = split_batch(next(iter(ds.batches())), 1)
    tr.params, tr.opt_state, tr.auc_state = tr.step.step_device(
        tr.params, tr.opt_state, tr.auc_state, sb.keys, sb.segment_ids,
        np.stack([np.ones_like(sb.labels), sb.labels], -1), sb.labels,
        sb.dense, sb.row_mask)[:3]
    n_touched = np.unique(sb.keys[sb.keys > 0]).size
    n_delta = tr.table.save_delta(delta)
    require(n_delta == n_touched, f"{tag}: a delta of {n_delta} rows after "
                                  f"a step over {n_touched} keys")
    single = DeviceTable(conf, capacity=MESH_C_CAPACITY, device="cuda")
    single.load_delta(delta)
    require(n_delta == len(single) and 0 < n_delta <= len(tr.table),
            f"{tag}: a delta of {n_delta} rows loaded {len(single)} into a "
            "DeviceTable")
    dk, dv, _ = snapshot_by_key(single)
    ok = np.isin(dk, kb)
    require(bool(ok.all()), f"{tag}: the delta holds keys the table lacks")
    print(f"{tag}: {n_batches} batches of B={TB} ({n_rows} rows, "
          f"{len(tr.table)} keys) in {secs:.2f} s, launches "
          f"{launches['mesh_trainer']}, metrics auc {metrics['auc']:.6f} "
          f"ins_num {metrics['ins_num']}; evaluate auc {ev['auc']:.6f} "
          f"ins_num {ev['ins_num']}; save {save_s:.2f} s, load {load_s:.2f} "
          f"s (bit for bit), a step's delta of {n_delta} rows into a "
          "DeviceTable")
    del tr, single, ds
    part("c")

    # (d) the merge kernel at (a)'s and (b)'s shapes, each engine's form,
    # and under a skewed head: Zipf(1.2) and slot-keyed Criteo traffic
    one = mesh_world(copy.deepcopy(model), "cuda", 1, 1 << 10, True)
    R1 = one[0]._req_cap(TNPAD)
    merge = {"training": merge_case("(a) one shard", one[0], flat[0][0],
                                    R1, rng),
             "training_host_plan": merge_case(
                 "(a) one shard, host plan", one[0], flat[0][0], R1, rng,
                 by_unique=False),
             "four_shards": merge_case("(b) shard 0 of 4", b_step, b_keys,
                                       R4, rng),
             "zipf": merge_case("(a) one shard, Zipf(1.2) keys", one[0],
                                zipf_keys(rng, flat[0][0]), R1, rng),
             "four_shards_zipf": merge_case(
                 "(b) shard 0 of 4, Zipf(1.2) keys", b_step,
                 zipf_keys(rng, b_keys), R4, rng),
             "criteo": merge_case(
                 "(a) one shard, Criteo slot keys with a slot of "
                 f"{CRITEO_FEW_VALUES} values", one[0],
                 criteo_keys(rng, flat[0][0]), R1, rng),
             "edges_max_abs_err": merge_edges(rng)}
    del one, card, b_step
    torch.cuda.empty_cache()
    part("d")
    out.update(launches=launches, merge=merge, parts_s=parts,
               phase_s=time.perf_counter() - t_phase)
    print(f"mesh (4v): {out['phase_s']:.1f} s; by part s {parts}")
    return out


# -- phase 4w: the host-table and dense-sharding mesh engines -----------------

MH_SHARDS = 4                # (b)-(g): shards of each mesh, all on cuda:0
MH_STEPS = 8                 # (b)-(d): steps of the 4-shard engines
MH_SYNC = 4                  # (c): LocalSGD's dense_sync_steps
MH_MM_STEPS = 4              # (e): host-table steps of the MMoE
MH_PIPE_STEPS = 32           # (f): two runs of 16: eager, then captured
MH_PIPE_CAPACITY = 1 << 22   # (f): its DeviceTable's rows
RING_SHAPE = (2, 8192, 8, 64)     # (g): B, T, H, D
RING_RTOL, RING_ATOL = 2e-4, 2e-5       # (g): the reference test's
RING_GRAD_RTOL, RING_GRAD_ATOL = 2e-3, 2e-4
SEQPOOL_WRAPPERS = (seqpool_cvm_cuda, seqpool_cvm_grad_cuda)


def seqpool_expect(n_fwd: int, n_bwd: int) -> dict:
    return {seqpool_cvm_cuda.__name__: n_fwd,
            seqpool_cvm_grad_cuda.__name__: n_bwd}


def host_mesh_run(step, state, table, sbs, before=None, after=None):
    """``step`` (a ``ShardedTrainStep`` or a ``ZeroShardedTrainStep``)
    over ``sbs`` (``ShardedBatch``es), the table's flat pull before and
    push after each, as the trainer's host-table mesh branch runs a batch;
    ``before(t)`` / ``after(t)`` around step ``t``. ``state`` ([params,
    opt, auc] and the step counter of a ``ShardedTrainStep``) is updated in
    place. Returns the losses (floats)."""
    D = table.conf.pull_dim
    zero = isinstance(step, ZeroShardedTrainStep)
    losses = []
    for t, sb in enumerate(sbs):
        if before is not None:
            before(t)
        emb = table.pull(sb.flat_keys()).reshape(sb.ndev, -1, D)
        args = (emb, sb.segment_ids, np.stack([np.ones_like(sb.labels),
                                               sb.labels], -1),
                sb.labels, sb.dense, sb.row_mask)
        if zero:
            *state[:3], demb, loss, _ = step(*state[:3], *args)
        else:
            *state[:4], demb, loss, _ = step(*state[:4], *args)
        table.push(sb.flat_keys(), demb.reshape(-1, D))
        losses.append(float(loss))
        if after is not None:
            after(t)
    return losses


def host_snapshot(table: EmbeddingTable):
    snap = table.snapshot(reset_dirty=False)
    order = np.argsort(snap["keys"], kind="stable")
    return {k: v[order] for k, v in snap.items()}


def require_same_host_tables(tag: str, a, b) -> None:
    sa, sb = host_snapshot(a), host_snapshot(b)
    require(set(sa) == set(sb) and all(np.array_equal(sa[k], sb[k])
                                       for k in sa),
            f"{tag}: the tables' rows differ")


def require_close_host_tables(tag: str, a, b) -> float:
    """Two host tables by key: the same keys, show/clk exact, the rest
    within TRAIN_ATOL. Returns the largest difference."""
    sa, sb = host_snapshot(a), host_snapshot(b)
    require(np.array_equal(sa["keys"], sb["keys"]),
            f"{tag}: the tables hold other keys")
    require(np.array_equal(sa["values"][:, :2], sb["values"][:, :2]),
            f"{tag}: show/clk differ")
    err = max(float(np.abs(sa[k] - sb[k]).max()) for k in ("values",
                                                          "state"))
    require(err <= TRAIN_ATOL, f"{tag}: rows by key differ by {err}")
    return err


def dense_host(model, state) -> dict:
    return {"params": [p.detach().cpu().clone() for p in model.parameters()],
            "adam": adam_host(state)}


def phase_mesh_host(rng, files, device: str = "cuda") -> dict:
    """(4w) The host-table and dense-sharding mesh engines, the flagship
    DeepFM over a native ``EmbeddingTable`` (B=2048, 24 slots) and one
    trainer-cell file: (a) ``CTRTrainer(mesh=make_mesh(1, device="cuda"),
    use_device_table=False)`` against ``CTRTrainer(use_device_table=
    False)``, 16 steps, bit for bit, then both timed in turns; (b) sync DP
    over 4 shards on cuda:0 (512 a shard), 8 steps, against the same mesh
    on the CPU and the card's single-device step on the merged batch, each
    re-synced to the card mesh's dense state before every step, as 4v
    (b); (c) LocalSGD (``dense_sync_steps=4``), the replicas equal after
    steps 4 and 8, against the CPU twin re-synced each step; (d) ZeRO
    (adam) replaying (b)'s dense state, against (b), its bytes a shard
    beside the replicated layout's; (e) ``expert_shardings`` of phase 4f's
    MMoE over an ``ep`` mesh of 4, the forward and 4 host-table steps
    against the unsharded MMoE; (f) a ``PipelinedTower`` (4 stages x 2
    blocks, hidden 64, 4 microbatches) under ``FusedTrainStep`` on a
    ``DeviceTable``, 32 steps through ``train_stream`` (its second run
    captured), its forward against ``sequential_reference``; (g)
    ``ring_self_attention`` at B=2, T=8192, H=8, D=64 over an ``sp`` mesh
    of 4, causal and not, forward and grads against
    ``dense_attention``. Every part on ``device`` (the CPU only to
    rehearse the phase's control flow at small shapes)."""
    t_phase = time.perf_counter()
    conf, tconf, _ = train_confs()
    fwd, bwd = seqpool_cvm_cuda.__name__, seqpool_cvm_grad_cuda.__name__
    feed = trainer_feed_conf()
    ds = SlotDataset(feed, buckets=batch_bucket_spec())
    ds.set_filelist(files[:1])
    ds.load_into_memory()
    n = ds.num_instances() // TB
    model = random_deepfm(rng, TS * conf.pull_dim)
    launches, out, parts = {}, {}, {}
    t_part = time.perf_counter()

    def part(name: str) -> None:
        nonlocal t_part
        now = time.perf_counter()
        parts[name] = round(now - t_part, 2)
        t_part = now

    # (a) one shard against the single-device host-table engine
    tag = "mesh host (4w) (a)"
    single = CTRTrainer(copy.deepcopy(model), feed, conf, tconf,
                        use_device_table=False, device=device)
    mesh1 = CTRTrainer(copy.deepcopy(model), feed, conf, tconf,
                       mesh=make_mesh(1, device=device),
                       use_device_table=False)
    require(isinstance(mesh1.step, ShardedTrainStep) and not mesh1.fused
            and not single.fused, f"{tag}: not the host-table engines")
    fetched = {"single": [], "mesh": []}

    def one_pass(name, tr):
        return tr.train_from_dataset(ds, fetch_handler=lambda s, loss, p:
                                     fetched[name].append((float(loss), p)))

    _, want, launches["mesh_host_single"] = counted(
        lambda: one_pass("single", single), seqpool_expect(n, n),
        f"{tag} single device", SEQPOOL_WRAPPERS)
    _, got, launches["mesh_host_one_shard"] = counted(
        lambda: one_pass("mesh", mesh1), seqpool_expect(n, n),
        f"{tag} one shard", SEQPOOL_WRAPPERS)

    def same(when: str) -> None:
        require(len(fetched["single"]) == len(fetched["mesh"]) and all(
            a[0] == b[0] and np.array_equal(a[1].reshape(-1),
                                            b[1].reshape(-1))
            for a, b in zip(fetched["single"], fetched["mesh"])),
            f"{tag} {when}: losses or preds differ")
        require(all(torch.equal(a, b) for a, b in zip(
            single.params.state_dict().values(),
            mesh1.params.state_dict().values())),
            f"{tag} {when}: dense params differ")
        require_same_host_tables(f"{tag} {when}", single.table, mesh1.table)

    require(got == want, f"{tag}: pass metrics {got} vs {want}")
    same("")
    turns = {"single": [], "one_shard_mesh": []}
    for name in ("single", "one_shard_mesh", "one_shard_mesh", "single"):
        tr = single if name == "single" else mesh1
        turns[name].append(host_engine_pass(tr, ds)[0] / n * 1e3)
    fetched = {"single": [], "mesh": []}
    same("after the turns")
    out["ms_per_step"] = turns
    ms = {k: [round(x, 3) for x in v] for k, v in turns.items()}
    eps = {k: [round(TB / x * 1e3, 1) for x in v] for k, v in turns.items()}
    print(f"{tag}: CTRTrainer(mesh=make_mesh(1), use_device_table=False) "
          f"bit for bit with CTRTrainer(use_device_table=False) over {n} "
          f"steps of B={TB} (losses, preds, metrics, dense params, "
          f"{len(single.table)} rows by key), also after 2 more passes "
          f"each; launches single {launches['mesh_host_single']} one shard "
          f"{launches['mesh_host_one_shard']}; ms/step in turns {ms}, "
          f"examples/s {eps} [{card_line()}]")
    del single, mesh1
    part("a")

    # (b) sync DP over 4 shards on cuda:0
    tag = f"mesh host (4w) (b) {MH_SHARDS} shards"
    batches = list(ds.batches())[:MH_STEPS]
    sbs = [split_batch(b, MH_SHARDS) for b in batches]
    Bl = TB // MH_SHARDS

    def world(device, trainer_conf=tconf, cls=None):
        step = (cls or ShardedTrainStep)(
            copy.deepcopy(model), conf, trainer_conf,
            make_mesh(MH_SHARDS, device=device), Bl, TS)
        state = [*step.init(), step.init_auc_state()]
        if isinstance(step, ShardedTrainStep):
            state.append(step.init_step_counter())
        return step, state, EmbeddingTable(conf)

    card, cstate, ctable = world(device)
    rec = DenseRecorder(card)
    kinks = KinkAligner().record(cstate[0])
    try:
        secs, closs, launches["mesh_host_4_shards"] = counted(
            lambda: host_mesh_run(card, cstate, ctable, sbs),
            seqpool_expect(MH_STEPS * MH_SHARDS, MH_STEPS * MH_SHARDS), tag,
            SEQPOOL_WRAPPERS)
    finally:
        rec.detach()
        kinks.remove()
    out["b_ms_per_step"] = secs / MH_STEPS * 1e3
    fails = []
    cpu, pstate, ptable = world("cpu")
    cpu_rec = DenseRecorder(cpu, replay=rec)
    kinks.follow(pstate[0])
    try:
        ploss = host_mesh_run(cpu, pstate, ptable, sbs)
    finally:
        cpu_rec.detach()
        kinks.remove()
    cpu_kinks = kinks.aligned
    if not np.allclose(closs, ploss, rtol=TRAIN_RTOL, atol=0):
        fails.append(f"losses {closs} vs the CPU's {ploss}")
    vs_cpu = compare_dense_steps(rec, cpu_rec, fails)
    vs_cpu["rows"] = require_close_host_tables(f"{tag} vs CPU", ctable,
                                               ptable)
    # the card's single-device step on the merged batches, re-synced
    one = TrainStep(copy.deepcopy(model), conf, tconf, TB, TS,
                    device=device)
    ostate = [*one.init(), one.init_auc_state()]
    otable = EmbeddingTable(conf)
    orec = UpdateRecorder(one.optimizer)
    kinks.follow(ostate[0], group=MH_SHARDS)
    oloss = []
    try:
        for t, b in enumerate(batches):
            load_dense_state(ostate[0], ostate[1], rec.pre[t])
            ostate, losses = host_hand_loop(one, ostate, otable, [b])
            oloss += losses
    finally:
        orec.detach()
        kinks.remove()
    if not np.allclose(closs, oloss, rtol=TRAIN_RTOL, atol=0):
        fails.append(f"losses {closs} vs the single device's {oloss}")
    vs_one = compare_dense_steps(rec, orec, fails, exact_sums=False)
    vs_one["rows"] = require_close_host_tables(f"{tag} vs one device",
                                               ctable, otable)
    require(not fails, f"{tag}: {len(fails)} failures: {fails[:4]}")
    print(f"{tag}: {MH_STEPS} steps of B={TB} ({Bl} a shard) in "
          f"{secs:.2f} s ({out['b_ms_per_step']:.3f} ms/step), launches "
          f"{launches['mesh_host_4_shards']}; each step re-synced: against "
          f"the same mesh on the CPU: losses within rtol {TRAIN_RTOL}, "
          f"dense sums in shard order bit for bit, grads within "
          f"{vs_cpu['grad_rel']:.3e} in norm, params {vs_cpu['dense']:.3e},"
          f" rows {vs_cpu['rows']:.3e}, ReLU pre-activations aligned "
          f"{cpu_kinks}; against the card's single-device step on the "
          f"merged batch: grads {vs_one['grad_rel']:.3e}, params "
          f"{vs_one['dense']:.3e}, rows {vs_one['rows']:.3e}, aligned "
          f"{kinks.aligned} [{card_line()}]")
    del cpu, pstate, ptable, one, ostate, otable
    part("b")

    # (c) LocalSGD: dense_sync_steps=4
    tag = f"mesh host (4w) (c) LocalSGD every {MH_SYNC}"
    tl = dataclasses.replace(tconf, dense_sync_steps=MH_SYNC)
    lcard, lstate, ltable = world(device, tl)
    lcpu, lpstate, lptable = world("cpu", tl)
    pre, post, ppost, synced = [], [], [], []
    lk = KinkAligner().record(*lstate[0])

    def card_before(t):
        pre.append([dense_host(m, o) for m, o in zip(lstate[0],
                                                     lstate[1])])

    def card_after(t):
        post.append([dense_host(m, o) for m, o in zip(lstate[0],
                                                      lstate[1])])
        if (t + 1) % MH_SYNC == 0:
            synced.append(t + 1)
            require(all(torch.equal(a, b) for r in post[-1][1:]
                        for a, b in zip(r["params"], post[-1][0]["params"])),
                    f"{tag}: the replicas differ after step {t + 1}")

    try:
        secs, lloss, launches["mesh_host_localsgd"] = counted(
            lambda: host_mesh_run(lcard, lstate, ltable, sbs, card_before,
                                  card_after),
            seqpool_expect(MH_STEPS * MH_SHARDS, MH_STEPS * MH_SHARDS), tag,
            SEQPOOL_WRAPPERS)
    finally:
        lk.remove()
    out["c_ms_per_step"] = secs / MH_STEPS * 1e3
    lk.follow(*lpstate[0])
    lpl = host_mesh_run(
        lcpu, lpstate, lptable, sbs,
        lambda t: [load_dense_state(m, o, src) for m, o, src in
                   zip(lpstate[0], lpstate[1], pre[t])],
        lambda t: ppost.append([dense_host(m, o) for m, o in
                                zip(lpstate[0], lpstate[1])]))
    lk.remove()
    require(np.allclose(lloss, lpl, rtol=TRAIN_RTOL, atol=0),
            f"{tag}: losses {lloss} vs the CPU's {lpl}")
    l_err = max(float((a - b).abs().max()) for t in range(MH_STEPS)
                for r, q in zip(post[t], ppost[t])
                for a, b in zip(r["params"], q["params"]))
    require(l_err <= TRAIN_ATOL, f"{tag}: replicas' params {l_err} from "
                                 "the re-synced CPU's")
    l_rows = require_close_host_tables(tag, ltable, lptable)
    require(synced == [MH_SYNC, 2 * MH_SYNC], f"{tag}: synced at {synced}")
    print(f"{tag}: {MH_STEPS} steps in {secs:.2f} s "
          f"({out['c_ms_per_step']:.3f} ms/step), launches "
          f"{launches['mesh_host_localsgd']}; the {MH_SHARDS} replicas "
          f"equal after steps {synced}; each step re-synced against the "
          f"CPU: losses within rtol {TRAIN_RTOL}, replicas' params "
          f"{l_err:.3e}, rows {l_rows:.3e}, aligned {lk.aligned} "
          f"[{card_line()}]")
    del lcpu, lpstate, lptable
    part("c")

    # (d) ZeRO (adam), replaying (b)'s dense state
    tag = f"mesh host (4w) (d) ZeRO {MH_SHARDS} shards"
    zstep, zstate, ztable = world(device, cls=ZeroShardedTrainStep)
    spec = zstep._spec
    C = spec.chunk

    def z_before(t):
        src = rec.pre[t]
        flats = {"p": spec.to_flat(src["params"]),
                 "mu": spec.to_flat(src["adam"]["mu"]),
                 "nu": spec.to_flat(src["adam"]["nu"])}
        with torch.no_grad():
            for s_, (c, st) in enumerate(zip(zstate[0], zstate[1])):
                c.flat.copy_(flats["p"][s_ * C:(s_ + 1) * C])
                st["mu"][0].copy_(flats["mu"][s_ * C:(s_ + 1) * C])
                st["nu"][0].copy_(flats["nu"][s_ * C:(s_ + 1) * C])
                st["count"].copy_(src["adam"]["count"])

    zpost = []
    kinks.follow(zstep._skeleton(zstep.device))
    try:
        secs, zloss, launches["mesh_host_zero"] = counted(
            lambda: host_mesh_run(zstep, zstate, ztable, sbs, z_before,
                                  lambda t: zpost.append([
                                      p.detach().cpu() for p in
                                      zstep.materialize(zstate[0])
                                      .parameters()])),
            seqpool_expect(MH_STEPS * MH_SHARDS, MH_STEPS * MH_SHARDS), tag,
            SEQPOOL_WRAPPERS)
    finally:
        kinks.remove()
    out["d_ms_per_step"] = secs / MH_STEPS * 1e3
    require(np.allclose(zloss, closs, rtol=TRAIN_RTOL, atol=0),
            f"{tag}: losses {zloss} vs sync DP's {closs}")
    z_err = max(float((a - b).abs().max()) for t in range(MH_STEPS)
                for a, b in zip(zpost[t], rec.post[t]["params"]))
    require(z_err <= TRAIN_ATOL, f"{tag}: params {z_err} from sync DP's")
    z_rows = require_close_host_tables(tag, ztable, ctable)
    zbytes = zstep.shard_bytes(zstate[0], zstate[1])
    P = spec.total
    rep_bytes = 4 * 3 * P + 4     # params, mu, nu and the count a device
    out["zero_bytes"] = {"shard": zbytes, "replicated": rep_bytes}
    print(f"{tag}: {MH_STEPS} steps in {secs:.2f} s "
          f"({out['d_ms_per_step']:.3f} ms/step), launches "
          f"{launches['mesh_host_zero']}; each step from sync DP's dense "
          f"state (b): losses within rtol {TRAIN_RTOL}, params {z_err:.3e},"
          f" rows {z_rows:.3e}, aligned {kinks.aligned}; bytes of params "
          f"and adam state a shard {zbytes} (chunk {C} of {P} params) "
          f"against {rep_bytes} a device replicated [{card_line()}]")
    # (b)-(d) timed in turns, uninstrumented (the checks above copy the
    # dense state to the host each step), over the same batches again
    engines = {"sync": (card, cstate, ctable),
               "localsgd": (lcard, lstate, ltable),
               "zero": (zstep, zstate, ztable)}
    order = list(engines)
    bturns = {k: [] for k in order}
    for name in order + order[::-1]:
        secs, _ = timed_secs(lambda: host_mesh_run(*engines[name], sbs))
        bturns[name].append(secs / MH_STEPS * 1e3)
    out["bcd_ms_per_step"] = bturns
    ms = {k: [round(x, 3) for x in v] for k, v in bturns.items()}
    eps = {k: [round(TB / x * 1e3, 1) for x in v] for k, v in bturns.items()}
    print(f"timing mesh host (4w) (b)-(d): ms/step in turns {ms}, "
          f"examples/s {eps} (B={TB}, {MH_SHARDS} shards on one card, "
          f"{MH_STEPS} steps a turn; {card_line()})")
    del engines, zstep, zstate, ztable, card, cstate, ctable, rec
    del lcard, lstate, ltable
    part("d")

    # (e) expert shards of phase 4f's MMoE
    tag = f"mesh host (4w) (e) MMoE experts over ep {MH_SHARDS}"
    econf, etconf = example_confs()
    mb = csr_batches(rng, MH_MM_STEPS, MM_B, MM_S, 0, HE_VOCAB)
    mm = MMoE(MM_S * econf.pull_dim, **MM_KW)
    ep = make_mesh(MH_SHARDS, device=device, axis_names=(AXIS_EP,))
    sharded = expert_shardings(copy.deepcopy(mm), ep)
    with torch.no_grad():
        sparse = torch.randn(MM_B, MM_S, econf.pull_dim, device=device)
        zeros = torch.zeros(MM_B, 0, device=device)
        f_err = float((sharded.to(device)(sparse, zeros) -
                       copy.deepcopy(mm).to(device)(sparse, zeros))
                      .abs().max())
    require(f_err <= TRAIN_ATOL, f"{tag}: forward {f_err}")
    worlds_e = {}
    for name, m in (("unsharded", mm), ("sharded", sharded)):
        st = TrainStep(m, econf, etconf, MM_B, MM_S, device=device)
        state = [*st.init(), st.init_auc_state()]
        tab = EmbeddingTable(econf)
        _, (state, losses), launches[f"mesh_host_mmoe_{name}"] = counted(
            lambda: host_hand_loop(st, state, tab, mb,
                                   labels_of=mmoe_labels),
            seqpool_expect(MH_MM_STEPS, MH_MM_STEPS), f"{tag} {name}",
            SEQPOOL_WRAPPERS)
        worlds_e[name] = (state[0], tab, losses)
    require(np.allclose(worlds_e["sharded"][2], worlds_e["unsharded"][2],
                        rtol=TRAIN_RTOL, atol=0),
            f"{tag}: losses {worlds_e['sharded'][2]} vs "
            f"{worlds_e['unsharded'][2]}")
    e_err = max(float((a.detach() - b.detach()).abs().max()) for a, b in zip(
        unshard_experts(worlds_e["sharded"][0]).parameters(),
        worlds_e["unsharded"][0].parameters()))
    require(e_err <= TRAIN_ATOL, f"{tag}: params {e_err}")
    e_rows = require_close_host_tables(tag, worlds_e["sharded"][1],
                                       worlds_e["unsharded"][1])
    E = MM_KW["num_experts"]
    print(f"{tag}: E={E}, {E // MH_SHARDS} a shard on one device; "
          f"forward (B={MM_B}) within {f_err:.3e} of the unsharded MMoE's; "
          f"{MH_MM_STEPS} host-table steps: losses within rtol "
          f"{TRAIN_RTOL}, params {e_err:.3e}, rows {e_rows:.3e}; launches "
          f"{launches['mesh_host_mmoe_sharded']} (unsharded "
          f"{launches['mesh_host_mmoe_unsharded']}) [{card_line()}]")
    del worlds_e, sharded, mm
    part("e")

    # (f) the pipelined tower under FusedTrainStep, run graphs
    tag = f"mesh host (4w) (f) PipelinedTower {MH_SHARDS} stages"
    torch.manual_seed(int(rng.integers(1 << 31)))
    pp = make_mesh(MH_SHARDS, device=device, axis_names=(AXIS_PP,))
    tower = PipelinedTower(TS * conf.pull_dim, hidden=64,
                           blocks_per_stage=2, microbatches=4, mesh=pp)
    ptab = DeviceTable(conf, capacity=MH_PIPE_CAPACITY, device=device,
                       backend="native", index_threads=1)
    fs = FusedTrainStep(tower, ptab, tconf, TB, TS, device_prep=True)
    fst = [*fs.init(), fs.init_auc_state()]
    flat, _ = mesh_tuples(make_train_batches(rng, MH_PIPE_STEPS))
    plosses = []
    secs, _, launches["mesh_host_pipeline"] = counted(
        lambda: fs.train_stream(*fst, iter(flat), on_step=lambda i, loss:
                                plosses.append(float(loss))),
        seqpool_expect(MH_PIPE_STEPS, MH_PIPE_STEPS), tag, SEQPOOL_WRAPPERS)
    require(len(plosses) == MH_PIPE_STEPS and all(np.isfinite(plosses)),
            f"{tag}: losses {plosses}")
    graphs = fs.run_graphs         # None on the CPU: no graphs there
    captures = graphs.captures if graphs is not None else 0
    replays = graphs.replays if graphs is not None else 0
    with torch.no_grad():
        sparse = torch.randn(TB, TS, conf.pull_dim, device=device)
        p_err = float((tower(sparse, None) -
                       sequential_reference(tower, sparse)).abs().max())
    require(p_err <= TRAIN_ATOL, f"{tag}: forward {p_err} from "
                                 "sequential_reference")
    out["pipeline"] = {"captures": captures, "replays": replays,
                       "ms_per_step": secs / MH_PIPE_STEPS * 1e3}
    print(f"{tag} x 2 blocks, hidden 64, 4 microbatches: "
          f"{MH_PIPE_STEPS} steps of B={TB} through train_stream (device "
          f"prep) in {secs:.2f} s, run graphs captures {captures} replays "
          f"{replays}, launches "
          f"{launches['mesh_host_pipeline']}, losses {plosses[0]:.6f} -> "
          f"{plosses[-1]:.6f}; forward within {p_err:.3e} of "
          f"sequential_reference [{card_line()}]")
    del fs, fst, ptab, tower
    # the run graph goes now: a graph freed by a later collection, inside
    # another capture, would invalidate that capture
    gc.collect()
    torch.cuda.empty_cache()
    part("f")

    # (g) ring attention over an sp mesh of 4
    tag = f"mesh host (4w) (g) ring attention {MH_SHARDS} shards"
    sp = make_mesh(MH_SHARDS, device=device, axis_names=(AXIS_SP,))
    gen = torch.Generator(device=device).manual_seed(
        int(rng.integers(1 << 31)))
    ring = {}

    def ring_cases():
        for causal in (False, True):
            ring_case(causal)

    def ring_case(causal: bool) -> None:
        q, k, v, cot = (torch.randn(RING_SHAPE, device=device,
                                    generator=gen) for _ in range(4))
        res = {}
        for name, fn in (("ring", lambda *a: ring_self_attention(
                *a, sp, causal=causal)),
                         ("dense", lambda *a: dense_attention(
                             *a, causal=causal))):
            ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
            t_ms, o = timed_secs(lambda: fn(*ins))
            (o * cot).sum().backward()
            res[name] = (o.detach(), [x.grad for x in ins], t_ms * 1e3)
            del ins, o
        o_err = float((res["ring"][0] - res["dense"][0]).abs().max())
        require(torch.allclose(res["ring"][0], res["dense"][0],
                               rtol=RING_RTOL, atol=RING_ATOL),
                f"{tag} causal={causal}: forward {o_err}")
        g_err = 0.0
        for a, b in zip(res["ring"][1], res["dense"][1]):
            g_err = max(g_err, float((a - b).abs().max()))
            require(torch.allclose(a, b, rtol=RING_GRAD_RTOL,
                                   atol=RING_GRAD_ATOL),
                    f"{tag} causal={causal}: grads {g_err}")
        ring[f"causal={causal}"] = {"fwd_err": o_err, "grad_err": g_err,
                                    "ring_fwd_ms": res["ring"][2],
                                    "dense_fwd_ms": res["dense"][2]}
        del res, q, k, v, cot
        torch.cuda.empty_cache()
    _, _, launches["mesh_host_ring"] = counted(
        ring_cases, seqpool_expect(0, 0), tag, SEQPOOL_WRAPPERS)
    out["ring"] = ring
    print(f"{tag}: B, T, H, D = {RING_SHAPE}, forward and the grads of q, "
          f"k, v against dense_attention within rtol {RING_RTOL} atol "
          f"{RING_ATOL} (grads rtol {RING_GRAD_RTOL} atol {RING_GRAD_ATOL}; "
          f"the reference test's: a streaming softmax adds the blocks in "
          f"another order than the one-pass softmax): {ring}, launches "
          f"{launches['mesh_host_ring']} [{card_line()}]")
    part("g")
    out.update(launches=launches, parts_s=parts,
               phase_s=time.perf_counter() - t_phase)
    print(f"mesh host (4w): {out['phase_s']:.1f} s; by part s {parts}")
    return out


# -- phase 4x: multi-host training ---------------------------------------------

MX_WORLD = 2                 # ranks, each a process on the one card
MX_CHECK_BATCHES = 4         # (a): a rank's steps held against the CPU
MX_CAPACITY = 1 << 21        # arena rows a shard (a rank's pass: ~1.31M keys)
MX_SGD = dict(dense_optimizer="sgd", dense_learning_rate=0.05)
MX_PASSES = 2                # (a): the main path's passes of each engine
MX_B_STEPS = 16              # (b): host-table steps a rank
MX_BEAT_S = 0.25             # (c): the heartbeat's interval
MX_ABORT_S = 2.0             # (c): its abort timeout
MX_KILL_AFTER = 4            # (c): rank 1's steps before the kill
MX_ABORT_EXIT = 17           # (c): rank 0's exit code after the abort
MX_ENGINES = ("device_prep", "host_plan")


class SendMeter:
    """The bytes a coordinator sends to its peers (each frame's header,
    tag and payload), added up under the bucket set at the time."""

    def __init__(self, coord):
        self.bucket = "other"
        self.bytes = {}
        send = coord.send

        def metered(to, tag, payload=b"", connect_timeout=None):
            if to != coord.rank:
                self.bytes[self.bucket] = self.bytes.get(self.bucket, 0) + \
                    12 + len(tag.encode()) + len(payload)
            return send(to, tag, payload, connect_timeout)

        coord.send = metered


class FirstBatches:
    """A dataset's first ``n`` batches, for ``train_from_dataset``."""

    def __init__(self, ds, n: int):
        self.ds, self.n = ds, n

    def batches(self):
        return itertools.islice(self.ds.batches(), self.n)

    def keys(self) -> np.ndarray:
        return np.concatenate([b.keys for b in self.batches()])


def mx_dataset(files, rank: int, world: int, batch: int,
               slots: int) -> SlotDataset:
    """Rank ``rank``'s shard of ``files`` (SlotDataset's split by file) in
    batches of ``batch`` rows of ``slots`` slots."""
    ds = SlotDataset(slot_feed_conf(slots, batch),
                     buckets=batch_bucket_spec(),
                     shard_id=rank, num_shards=world)
    ds.set_filelist(files)
    ds.load_into_memory()
    return ds


def mx_keys(ds) -> np.ndarray:
    return np.concatenate([r.uint64_feas for r in ds.records])


def mx_trainer(coord, leaves, shape, tconf, device, device_prep: bool,
               capacity: int, hook=None):
    """A rank's trainer: ``CTRTrainer(mesh=make_mesh(1), table=
    TieredShardedDeviceTable(DistributedTable))`` (writeback "delta"),
    the dense mean through the coordinator after each sync step.
    ``shape``: (batch, slots, hidden)."""
    batch, slots, hidden = shape
    conf, _, _ = train_confs()
    mesh = make_mesh(1, device=device)
    backing = DistributedTable(conf, coord, local_table=EmbeddingTable(
        conf, backend="native"))
    table = TieredShardedDeviceTable(conf, mesh, backing=backing,
                                     capacity_per_shard=capacity,
                                     writeback_mode="delta",
                                     backend="native")
    return CTRTrainer(deepfm_from_flax_leaves(leaves, hidden),
                      slot_feed_conf(slots, batch), conf, tconf, table=table,
                      mesh=mesh, device_prep=device_prep,
                      dense_sync_hook=hook or dense_mean_hook(coord))


def mx_host_trainer(coord, leaves, shape, device):
    """(b)'s rank trainer: ``CTRTrainer(table=DistributedTable,
    use_device_table=False)``, the host-table engine (dense SGD)."""
    batch, slots, hidden = shape
    conf, _, _ = train_confs()
    return CTRTrainer(deepfm_from_flax_leaves(leaves, hidden),
                      slot_feed_conf(slots, batch), conf,
                      TrainerConfig(**MX_SGD),
                      table=DistributedTable(conf, coord, local_table=(
                          EmbeddingTable(conf, backend="native"))),
                      use_device_table=False, device=device)


def mx_rows(local: EmbeddingTable) -> dict:
    """A rank's shard of the PS by key."""
    snap = local.snapshot(reset_dirty=False)
    order = np.argsort(snap["keys"])
    return {k: snap[k][order] for k in ("keys", "values", "state")}


def mx_check_pass(tr, sub) -> dict:
    """One checked pass: stage ``sub``'s keys, train it batch by batch
    (the per-batch mesh path: the hook after every step), write back."""
    losses = []
    tr.table.begin_feed_pass(sub.keys())
    m = tr.train_from_dataset(sub, fetch_handler=lambda i, loss, p:
                              losses.append(float(loss)))
    tr.table.end_pass()
    out = mx_rows(tr.table.backing.local)
    out.update(losses=np.asarray(losses), auc=np.float64(m["auc"]),
               ins_num=np.float64(m["ins_num"]))
    for i, leaf in enumerate(flax_leaves_from_model(tr.params)):
        out[f"dense{i}"] = leaf
    return out


def mx_host_pass(tr, ds, n: int, on_step=None) -> dict:
    """``n`` host-table steps of a rank over ``ds``'s first batches."""
    losses = []

    def fetch(i, loss, p):
        losses.append(float(loss))
        if on_step is not None:
            on_step(len(losses))

    m = tr.train_from_dataset(FirstBatches(ds, n), fetch_handler=fetch)
    out = mx_rows(tr.table.local)
    out.update(losses=np.asarray(losses), ins_num=np.float64(m["ins_num"]))
    return out


def mx_save(out_dir: str, name: str, arrays: dict) -> None:
    """``arrays`` as ``<name>.npz``, renamed into place once written (the
    parent polls for it)."""
    path = os.path.join(out_dir, f"{name}.npz")
    with open(path + ".tmp", "wb") as f:
        np.savez(f, **arrays)
    os.replace(path + ".tmp", path)


def mx_json(out_dir: str, name: str, obj) -> None:
    path = os.path.join(out_dir, f"{name}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".tmp", path)


def mx_read(out_dir: str, name: str, timeout: float, procs=()):
    """A rank's result file, waiting up to ``timeout`` seconds; fails when
    a rank process ends with an error first."""
    path = os.path.join(out_dir, name)
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        for p in procs:
            require(p.poll() in (None, 0), f"multi-host (4x): rank process "
                    f"{p.args[-1]} exited {p.poll()} before {name}")
        require(time.monotonic() < deadline,
                f"multi-host (4x): no {name} after {timeout} s")
        time.sleep(0.05)
    if name.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    with np.load(path) as z:
        return dict(z)


def mx_launches(fn, wrappers) -> Tuple[object, dict]:
    """``fn()`` with the wrappers' counts set to 0 just before it and read
    just after."""
    for w in wrappers:
        w.launches = 0
    out = fn()
    return out, {w.__name__: w.launches for w in wrappers}


def multihost_rank(spec_path: str) -> int:
    """One rank of phase 4x, a process of its own (``chip_smoke.py
    --mx-rank SPEC``): its role from ``PBOX_TRAINER_ID`` and
    ``PBOX_TRAINER_ENDPOINTS``, gloo beside the coordinator; (a) the check
    and the main path, (b) the host-table engine, (c) the heartbeat and,
    for rank 0, the abort. Writes its results into the spec's ``out``
    directory as it goes."""
    import torch.distributed as dist
    with open(spec_path) as f:
        spec = json.load(f)
    dev, out_dir, files = spec["device"], spec["out"], spec["files"]
    B, world = spec["batch"], spec["world"]
    shape = (B, spec["slots"], tuple(spec["hidden"]))
    # NCCL puts no two ranks of one communicator on one device: gloo
    role = fleet.init(init_torch_distributed=True, backend="gloo",
                      device=dev, dist_endpoint=spec["dist_endpoint"])
    r, coord = role.rank, role.coordinator
    one = torch.ones(1) * (r + 1)
    dist.all_reduce(one)
    require(float(one) == world * (world + 1) / 2, "gloo all_reduce")
    torch.zeros(1, device=dev).sum().item()      # the card's context
    info = {"ready_t": time.time(), "pid": os.getpid(),
            "gloo": role.dist_backend}
    with np.load(spec["leaves"]) as z:
        leaves = [z[f"l{i}"] for i in range(len(z.files))]
    ds = mx_dataset(files, r, world, B, spec["slots"])
    info["batches"] = n = ds.num_instances() // B
    meter = SendMeter(coord)
    wrappers = MESH_WRAPPERS
    sync = (torch.cuda.synchronize if str(dev).startswith("cuda")
            else (lambda: None))

    # (a) the check: MX_CHECK_BATCHES steps under dense SGD, each engine
    for engine in MX_ENGINES:
        tr = mx_trainer(coord, leaves, shape, TrainerConfig(**MX_SGD), dev,
                        engine == "device_prep", spec["capacity"])
        mx_save(out_dir, f"check_{engine}_rank{r}", mx_check_pass(
            tr, FirstBatches(ds, spec["check_batches"])))
        del tr
    # (a) the main path: the flagship's adam, the dense mean every step,
    # MX_PASSES passes over the rank's file, each engine; in turns (rank
    # pass, single-process pass twice, rank pass) with the one-process
    # device-sharded engine over both files on a 2-shard mesh (rank 0)
    _, adam, _ = train_confs()
    adam = dataclasses.replace(adam, dense_sync_steps=1)
    union = None
    main = {}
    for engine in MX_ENGINES:
        dp = engine == "device_prep"
        dense_s = []
        hook = dense_mean_hook(coord)

        def timed_hook(params, hook=hook, dense_s=dense_s):
            sync()
            meter.bucket = "dense"
            t0 = time.perf_counter()
            out = hook(params)
            dense_s.append(time.perf_counter() - t0)
            meter.bucket = "other"
            return out

        tr = mx_trainer(coord, leaves, shape, adam, dev, dp,
                        spec["capacity"], hook=timed_hook)
        keys = mx_keys(ds)
        passes, launches, singles = [], {}, []
        for p in range(MX_PASSES):
            coord.barrier(f"mx-{engine}-{p}")
            meter.bytes.clear()
            st = {}

            def one_pass(st=st):
                meter.bucket = "stage"
                t0 = time.perf_counter()
                st["rows"] = tr.table.begin_feed_pass(keys)
                st["stage_s"] = time.perf_counter() - t0
                meter.bucket = "other"
                sync()
                t0 = time.perf_counter()
                m = tr.train_from_dataset(ds)
                sync()
                st["train_s"] = time.perf_counter() - t0
                st["auc"] = m["auc"]
                meter.bucket = "writeback"
                t0 = time.perf_counter()
                st["written"] = tr.table.writeback()
                st["writeback_s"] = time.perf_counter() - t0
                meter.bucket = "other"
                tr.table.end_pass()

            _, counts = mx_launches(one_pass, wrappers)
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
            st["ms_per_step"] = st["train_s"] / n * 1e3
            st["bytes"] = dict(meter.bytes)
            passes.append(st)
            if p == 0:
                # the comparator's two turns, rank 0's process alone on
                # the card while rank 1 waits
                if r == 0:
                    if union is None:
                        union = mx_dataset(files, 0, 1, B * world,
                                           spec["slots"])
                    for _ in range(2):
                        singles.append(mx_single_pass(
                            union, leaves, (B * world,) + shape[1:], dev,
                            dp, spec["capacity"], sync))
                    coord.send(1, f"mx-single-{engine}")
                else:
                    coord.recv(0, f"mx-single-{engine}", timeout=900)
        want = mesh_expect(MX_PASSES * n, 1, dp)
        want = {k: want.get(k, 0) for k in launches}
        require(launches == want or not str(dev).startswith("cuda"),
                f"multi-host (4x) (a) rank {r} {engine}: launches "
                f"{launches}, expected {want}")
        main[engine] = {"passes": passes, "launches": launches,
                        "single": singles,
                        "dense_ms": [x * 1e3 for x in dense_s]}
        del tr
    info["main"] = main
    mx_json(out_dir, f"main_rank{r}", info)
    del union

    # (b) the host-table engine over the DistributedTable, no dense sync
    tr = mx_host_trainer(coord, leaves, shape, dev)
    bout, blaunch = mx_launches(lambda: mx_host_pass(tr, ds, spec["b_steps"]),
                                SEQPOOL_WRAPPERS)
    bout["launches"] = np.array([blaunch[w.__name__]
                                 for w in SEQPOOL_WRAPPERS])
    mx_save(out_dir, f"b_rank{r}", bout)

    # (c) the heartbeat; rank 1 is killed after MX_KILL_AFTER steps
    coord.barrier("mx-c")
    coord.start_heartbeat(interval=MX_BEAT_S, abort_timeout=MX_ABORT_S)

    def marker(i):
        if r == 1 and i == MX_KILL_AFTER:
            mx_json(out_dir, "kill_me", {"t": time.time()})

    try:
        mx_host_pass(tr, ds, n, on_step=marker)
    except RuntimeError as e:
        mx_json(out_dir, f"abort_rank{r}", {
            "raised_t": time.time(), "msg": str(e),
            "aborted_dead": coord.aborted_dead})
        sys.stdout.flush()
        os._exit(MX_ABORT_EXIT)
    mx_json(out_dir, f"abort_rank{r}", {"raised_t": None})
    fleet.stop()
    return 0


def mx_single_pass(ds, leaves, shape, dev, dp: bool, capacity: int,
                   sync) -> dict:
    """The comparator's pass: the one-process device-sharded engine (a
    ``TieredShardedDeviceTable`` over a host table, 2 shards on ``dev``)
    over both files at the global batch, the flagship's adam."""
    batch, slots, hidden = shape
    conf, tconf, _ = train_confs()
    mesh = make_mesh(MX_WORLD, device=dev)
    table = TieredShardedDeviceTable(conf, mesh, capacity_per_shard=capacity,
                                     backend="native")
    tr = CTRTrainer(deepfm_from_flax_leaves(leaves, hidden),
                    slot_feed_conf(slots, batch), conf, tconf,
                    table=table, mesh=mesh, device_prep=dp)
    t0 = time.perf_counter()
    table.begin_feed_pass(mx_keys(ds))
    stage_s = time.perf_counter() - t0
    sync()
    t0 = time.perf_counter()
    tr.train_from_dataset(ds)
    sync()
    train_s = time.perf_counter() - t0
    table.end_pass()
    steps = ds.num_instances() // batch
    return {"stage_s": stage_s, "train_s": train_s,
            "ms_per_step": train_s / steps * 1e3}


def mx_twin_check(spec: dict, leaves):
    """The ranks' CPU twins (threads in this process, plain versions):
    (a)'s check of each engine and (b)'s host-table steps."""
    shape = (spec["batch"], spec["slots"], tuple(spec["hidden"]))
    dss = [mx_dataset(spec["files"], r, MX_WORLD, spec["batch"],
                      spec["slots"]) for r in range(MX_WORLD)]
    out = {}
    for engine in MX_ENGINES:
        eps = local_endpoints(MX_WORLD)
        coords = [Coordinator(r, eps) for r in range(MX_WORLD)]
        out[engine] = mx_threads(coords, lambda r, c: mx_check_pass(
            mx_trainer(c, leaves, shape, TrainerConfig(**MX_SGD), "cpu",
                       engine == "device_prep", spec["capacity"]),
            FirstBatches(dss[r], spec["check_batches"])))
    eps = local_endpoints(MX_WORLD)
    coords = [Coordinator(r, eps) for r in range(MX_WORLD)]
    out["b"] = mx_threads(coords, lambda r, c: mx_host_pass(
        mx_host_trainer(c, leaves, shape, "cpu"), dss[r], spec["b_steps"]))
    return out


def mx_threads(coords, fn):
    """``fn(rank, coord)`` on a thread a rank; the first failure
    raised."""
    res, errs = [None] * len(coords), [None] * len(coords)

    def run(r):
        try:
            res[r] = fn(r, coords[r])
        except BaseException as e:  # raised below, on the caller's thread
            errs[r] = e

    ts = [threading.Thread(target=run, args=(r,)) for r in range(len(coords))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for c in coords:
        c.close()
    for e in errs:
        if e is not None:
            raise e
    return res


def mx_compare(tag: str, got: dict, want: dict, dense: bool) -> float:
    """A rank's card result against its CPU twin: the losses within
    TRAIN_RTOL; its shard by key, show/clk exact and the rest within
    TRAIN_ATOL; the AUC and the dense params within TRAIN_ATOL. Returns
    the largest difference."""
    require(np.allclose(got["losses"], want["losses"], rtol=TRAIN_RTOL,
                        atol=0), f"{tag}: losses {got['losses'][:4]} vs "
            f"{want['losses'][:4]}")
    require(float(got["ins_num"]) == float(want["ins_num"]),
            f"{tag}: ins_num")
    require(np.array_equal(got["keys"], want["keys"]),
            f"{tag}: the shard holds other keys")
    require(np.array_equal(got["values"][:, :2], want["values"][:, :2]),
            f"{tag}: show/clk differ")
    err = max(float(np.abs(got["values"] - want["values"]).max()),
              float(np.abs(got["state"] - want["state"]).max()))
    if dense:
        require(abs(float(got["auc"]) - float(want["auc"])) <= TRAIN_ATOL,
                f"{tag}: auc {got['auc']} vs {want['auc']}")
        i = 0
        while f"dense{i}" in got:
            err = max(err, float(np.abs(got[f"dense{i}"] -
                                        want[f"dense{i}"]).max()))
            i += 1
    require(err <= TRAIN_ATOL, f"{tag}: rows or dense differ by {err}")
    return err


def phase_multihost(rng, files, device: str = "cuda",
                    batch: int = TB // MX_WORLD, slots: int = TS,
                    hidden=HIDDEN, capacity: int = MX_CAPACITY) -> dict:
    """(4x) Multi-host training, the reference's flagship deployment: two
    rank processes on the one card (``device``), each with its role from
    ``PBOX_TRAINER_ID``/``PBOX_TRAINER_ENDPOINTS`` (``fleet.init(
    init_torch_distributed=True)``, gloo: NCCL puts no two ranks of one
    communicator on one device), a ``DistributedTable`` over a native
    ``EmbeddingTable`` (its half of the keys), a ``TieredShardedDeviceTable``
    (writeback "delta") on a one-shard mesh, and ``CTRTrainer(mesh=,
    table=, dense_sync_hook=)``, the dense mean through
    ``Coordinator.allreduce_sum``; the flagship DeepFM, 24 slots, B=2048
    global (``batch`` a rank), each rank one of the trainer cell's
    ``files`` (``SlotDataset(shard_id=rank, num_shards=2)``). (a) both
    engines: a check of ``MX_CHECK_BATCHES`` steps under dense SGD against
    the same two ranks on the CPU (threads, plain versions): losses,
    metrics, each rank's shard by key, the dense params; then the main
    path, the flagship's adam, ``MX_PASSES`` passes, launches counted in
    each rank, in turns with the one-process device-sharded engine over
    both files on a 2-shard mesh (rank 0's process); (b) the host-table
    engine over the ``DistributedTable`` (the reference's example 05),
    ``MX_B_STEPS`` steps against the CPU twin; (c) rank 1 SIGKILLed mid
    pass: rank 0's blocked collective raises within the heartbeat's abort
    timeout, naming rank 1, and rank 0 exits ``MX_ABORT_EXIT``. ``device``
    "cpu" rehearses the control flow at small shapes (``batch``,
    ``slots``, ``hidden``, ``capacity``)."""
    t_phase = time.perf_counter()
    out_dir = os.path.join(WORK, "mx")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    conf, _, _ = train_confs()
    leaves = flax_leaves_from_model(random_deepfm(rng, slots * conf.pull_dim,
                                                  hidden))
    leaves_path = os.path.join(out_dir, "leaves.npz")
    np.savez(leaves_path, **{f"l{i}": x for i, x in enumerate(leaves)})
    eps = local_endpoints(MX_WORLD + 1)
    spec = {"device": device, "out": out_dir, "files": list(files),
            "batch": batch, "world": MX_WORLD, "leaves": leaves_path,
            "dist_endpoint": eps[-1], "capacity": capacity,
            "slots": slots, "hidden": list(hidden),
            "check_batches": MX_CHECK_BATCHES, "b_steps": MX_B_STEPS}
    spec_path = os.path.join(out_dir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    procs, logs = [], []
    t_spawn = time.time()
    for r in range(MX_WORLD):
        env = dict(os.environ, PBOX_TRAINER_ID=str(r),
                   PBOX_TRAINER_ENDPOINTS=",".join(eps[:MX_WORLD]))
        log = open(os.path.join(out_dir, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--mx-rank", spec_path], env=env, cwd=ROOT, stdout=log,
            stderr=subprocess.STDOUT))
        BACKGROUND.append(procs[-1])
    try:
        return mx_parent(procs, out_dir, spec, leaves, t_spawn, t_phase)
    except BaseException:
        for r, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
            p.wait()
            with open(os.path.join(out_dir, f"rank{r}.log")) as f:
                print(f"multi-host (4x): rank {r}'s log (tail):\n"
                      f"{f.read()[-4000:]}", file=sys.stderr)
        raise
    finally:
        for log in logs:
            log.close()


def mx_parent(procs, out_dir, spec, leaves, t_spawn, t_phase) -> dict:
    """Phase 4x's side in this process: the CPU twins, the checks against
    the ranks' results, the report, the kill of (c)."""
    tag = "multi-host (4x)"
    device = spec["device"]
    card = card_line() if device != "cpu" else "cpu"
    twin = mx_twin_check(spec, leaves)
    out = {"launches": {}}
    errs = {}
    for engine in MX_ENGINES:
        for r in range(MX_WORLD):
            got = mx_read(out_dir, f"check_{engine}_rank{r}.npz", 600, procs)
            errs[f"{engine}_rank{r}"] = mx_compare(
                f"{tag} (a) {engine} rank {r}: card vs CPU", got,
                twin[engine][r], dense=True)
    print(f"{tag} (a) check: {spec['check_batches']} steps a rank under "
          f"dense SGD (lr {MX_SGD['dense_learning_rate']}), each engine, "
          f"both ranks against their CPU twins (threads, plain versions): "
          f"losses within rtol {TRAIN_RTOL}, metrics, shard rows by key "
          f"(show/clk exact) and dense params within {TRAIN_ATOL}: max abs "
          f"err {errs} [{card}]")
    mains = [mx_read(out_dir, f"main_rank{r}.json", 900, procs)
             for r in range(MX_WORLD)]
    out["spawn_s"] = [m["ready_t"] - t_spawn for m in mains]
    ms = {}
    for engine in MX_ENGINES:
        for r, m in enumerate(mains):
            res = m["main"][engine]
            out["launches"][f"multihost_rank{r}_{engine}"] = res["launches"]
            ms[f"rank{r}_{engine}"] = [p["ms_per_step"]
                                       for p in res["passes"]]
        ms[f"single_{engine}"] = [s["ms_per_step"]
                                  for s in mains[0]["main"][engine]["single"]]
    out["ms_per_step"] = ms
    n = mains[0]["batches"]
    B = spec["batch"]
    for engine in MX_ENGINES:
        r0 = mains[0]["main"][engine]
        single = r0["single"]
        print(f"timing {tag} (a) {engine}: in turns (rank pass, one-process "
              f"pass x2, rank pass), ms/step ranks "
              f"{[round(x, 3) for x in ms[f'rank0_{engine}']]} (rank 0) "
              f"{[round(x, 3) for x in ms[f'rank1_{engine}']]} (rank 1), "
              f"one process (2 shards on {device}) "
              f"{[round(x, 3) for x in ms[f'single_{engine}']]}; examples/s "
              f"ranks {[round(B * MX_WORLD / x * 1e3, 1) for x in ms[f'rank0_{engine}']]}"
              f", one process "
              f"{[round(B * MX_WORLD / x * 1e3, 1) for x in ms[f'single_{engine}']]}"
              f" (B={B * MX_WORLD} global, {n} steps a pass); pass boundary "
              f"s: begin_feed_pass "
              f"{[round(p['stage_s'], 3) for p in r0['passes']]}, writeback "
              f"{[round(p['writeback_s'], 3) for p in r0['passes']]} "
              f"({[p['written'] for p in r0['passes']]} rows), one process "
              f"begin_feed_pass {[round(s['stage_s'], 3) for s in single]}; "
              f"bytes each rank sends a pass "
              f"{[[p['bytes'] for p in m['main'][engine]['passes']] for m in mains]}"
              f"; dense sync ms a step median "
              f"{float(np.median(r0['dense_ms'])):.3f} (p90 "
              f"{float(np.percentile(r0['dense_ms'], 90)):.3f}), launches "
              f"each rank {[m['main'][engine]['launches'] for m in mains]} "
              f"[{card}]")
    out["dense_ms"] = {e: float(np.median(mains[0]["main"][e]["dense_ms"]))
                       for e in MX_ENGINES}
    print(f"{tag}: a rank's spawn to ready (the interpreter, imports, "
          f"fleet.init with {mains[0]['gloo']}, the card's context) s "
          f"{[round(x, 3) for x in out['spawn_s']]} [{card}]")

    # (b) the host-table engine against its twin
    b_err = []
    for r in range(MX_WORLD):
        got = mx_read(out_dir, f"b_rank{r}.npz", 600, procs)
        want_n = spec["b_steps"] if device != "cpu" else 0
        require(list(got["launches"]) == [want_n, want_n],
                f"{tag} (b) rank {r}: seqpool launches {got['launches']}")
        out["launches"][f"multihost_b_rank{r}"] = dict(zip(
            [w.__name__ for w in SEQPOOL_WRAPPERS],
            [int(x) for x in got["launches"]]))
        b_err.append(mx_compare(f"{tag} (b) rank {r}", got, twin["b"][r],
                                dense=False))
    print(f"{tag} (b) CTRTrainer(table=DistributedTable, "
          f"use_device_table=False): {spec['b_steps']} steps a rank, losses "
          f"and each rank's shard by key against the CPU twin, max abs err "
          f"{b_err}")

    # (c) rank 1 killed mid pass
    mx_read(out_dir, "kill_me.json", 300, procs)
    procs[1].kill()
    t_kill = time.time()
    procs[1].wait()
    rc = procs[0].wait(timeout=60)
    ab = mx_read(out_dir, "abort_rank0.json", 5)
    require(rc == MX_ABORT_EXIT, f"{tag} (c): rank 0 exited {rc}")
    require(ab["aborted_dead"] == [1] and "dead ranks: [1]" in ab["msg"],
            f"{tag} (c): {ab}")
    lat = ab["raised_t"] - t_kill
    require(lat <= MX_ABORT_S + 3 * MX_BEAT_S,
            f"{tag} (c): rank 0 raised {lat:.3f} s after the kill")
    out["abort_s"] = lat
    print(f"{tag} (c): rank 1 SIGKILLed after {MX_KILL_AFTER} steps of a "
          f"pass; rank 0's blocked collective raised {lat:.3f} s later "
          f"(abort timeout {MX_ABORT_S} s, beat {MX_BEAT_S} s): "
          f"{ab['msg']!r}; rank 0 exited {rc} [{card}]")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"{tag}: {out['phase_s']:.1f} s")
    return out


# -- phase 4f: the host-table engine and the models ---------------------------

HE_BATCHES = 16              # batches of each path of the phase
HE_VOCAB = 1 << 22           # the host-engine paths' keys: [1, HE_VOCAB)
WD_B, WD_S, WD_DENSE = 512, 26, 13     # examples/01: Wide&Deep
WD_HIDDEN = (256, 128, 64)
MM_B, MM_S = 2048, 20                  # examples/04: MMoE, at the flagship's B
MM_KW = dict(num_tasks=2, num_experts=4, expert_hidden=(128,),
             expert_out=64, tower_hidden=(64,))
FD_B, FD_S, FD_NPAD = 512, 40, 65536   # examples/03: FeedDNN
FD_VOCAB = 1 << 19           # FeedDNN's keys: within its 2^20-row arena
FD_BATCHES = 32              # two runs of 16: eager, then a graph replay
SERVE_BATCHES = 4            # batches each bundle serves, counted


def example_confs():
    """The examples' table (embedx from the start, lr 0.2, init range 0.01)
    and dense optimizer (adam, lr 1e-3)."""
    return (TableConfig(embedx_dim=8, embedx_threshold=0.0,
                        learning_rate=0.2, initial_range=0.01),
            TrainerConfig(dense_learning_rate=1e-3))


def csr_batches(rng, n: int, batch: int, slots: int, dense_dim: int,
                vocab: int, npad: int = 0):
    """``n`` batches of ``batch`` rows of ``slots`` slots with 1-3 keys
    each, keys uniform over [1, vocab), random labels, normal dense
    values; Npad ``npad``, or the key count rounded up to 1024."""
    out = []
    for _ in range(n):
        lengths = rng.integers(1, 4, size=(batch, slots))
        nk = int(lengths.sum())
        pad = npad or -(-nk // 1024) * 1024
        segs, _ = segment_layout(batch, slots, lengths.reshape(-1), pad)
        keys = np.zeros(pad, np.uint64)
        keys[:nk] = rng.integers(1, vocab, size=nk, dtype=np.uint64)
        out.append(CsrBatch(
            keys=keys, segment_ids=segs, lengths=lengths.astype(np.int32),
            labels=rng.integers(0, 2, size=batch).astype(np.float32),
            dense=rng.normal(size=(batch, dense_dim)).astype(np.float32),
            batch_size=batch, num_slots=slots, num_keys=nk,
            num_rows=batch))
    return out


def mmoe_labels(b) -> np.ndarray:
    """``examples/04``'s labels [B, 2]: the click, and a synthetic
    conversion (a click on an even row)."""
    conv = b.labels * (np.arange(b.batch_size) % 2 == 0)
    return np.stack([b.labels, conv.astype(np.float32)], axis=1)


def host_hand_loop(step, state, table, batches, labels_of=None,
                   dembs=None):
    """``TrainStep`` with the host table's pull before and push after, as
    the host-table engine runs each batch (each step's demb appended to
    ``dembs``, if given); returns the new state and the losses
    (floats)."""
    params, opt, auc = state
    losses = []
    for b in batches:
        cvm = np.stack([np.ones(b.batch_size, np.float32), b.labels], axis=1)
        labels = b.labels if labels_of is None else labels_of(b)
        emb = table.pull(b.keys)
        params, opt, auc, demb, loss, _ = step(
            params, opt, auc, emb, b.segment_ids, cvm, labels, b.dense,
            b.row_mask())
        table.push(b.keys, demb)
        losses.append(float(loss))
        if dembs is not None:
            dembs.append(demb)
    return (params, opt, auc), losses


def host_rows(table: EmbeddingTable):
    """keys, values, state and embedx_ok of every row, by key."""
    snap = table.snapshot(reset_dirty=False)
    order = np.argsort(snap["keys"])
    return [snap[k][order] for k in ("keys", "values", "state",
                                     "embedx_ok")]


def host_world(losses, table, params, dembs=()):
    """(losses, rows by key, host copies of the dense params, the steps'
    dembs)."""
    return (list(losses), host_rows(table),
            [p.detach().cpu().clone() for p in params.parameters()],
            list(dembs))


def require_same_host(tag: str, a, b) -> None:
    """Two host-engine worlds (``host_world``) bit for bit."""
    (la, ra, pa, _), (lb, rb, pb, _) = a, b
    require(la == lb, f"{tag}: losses {la} vs {lb}")
    require(all(np.array_equal(x, y) for x, y in zip(ra, rb)),
            f"{tag}: rows by key differ")
    require(all(torch.equal(x, y) for x, y in zip(pa, pb)),
            f"{tag}: the dense params differ")


def host_vs_cpu(tag: str, card, cpu, conf: TableConfig) -> None:
    """The card's first CPU_STEPS steps against the CPU's (``host_world``
    each): losses within TRAIN_RTOL; each step's demb, the backward
    kernel's output and the push's input, with show/clk exact and the
    grads within TRAIN_DELTA_RTOL of their largest entry; the same keys,
    show/clk and embedx gates; the rows and the dense params within
    TRAIN_ATOL, and the rows' change as ``require_change(stored=True)``
    holds it. A row starts from its key's ``key_init_uniform`` values
    (every group: the threshold is 0, so embedx materializes at the first
    push) and a zero state."""
    (lc, rc, pc, dc), (lp, rp, pp, dp) = card, cpu
    require(len(dc) == len(dp) == CPU_STEPS, f"{tag}: {len(dc)}, {len(dp)} "
                                             "dembs")
    grads = []
    for i, (g, want) in enumerate(zip(dc, dp)):
        scale = float(np.abs(want[:, 2:]).max())
        gerr = float(np.abs(g[:, 2:] - want[:, 2:]).max())
        require(np.array_equal(g[:, :2], want[:, :2]) and scale > 0 and
                gerr <= TRAIN_DELTA_RTOL * scale,
                f"{tag}: step {i} demb: show/clk differ, or max abs err "
                f"{gerr} > {TRAIN_DELTA_RTOL} * {scale}")
        grads.append(f"{gerr:.3e} of {scale:.3e}")
    require(np.allclose(lc, lp, rtol=TRAIN_RTOL, atol=0),
            f"{tag}: losses {lc} vs {lp}")
    require(np.array_equal(rc[0], rp[0]) and
            np.array_equal(rc[1][:, :2], rp[1][:, :2]) and
            np.array_equal(rc[3], rp[3]),
            f"{tag}: keys, show/clk or embedx gates differ")
    require(conf.embedx_threshold == 0 and rc[3].all(),
            f"{tag}: a row's embedx has not materialized")
    row_err = max(float(np.abs(rc[i] - rp[i]).max()) for i in (1, 2))
    dense_err = max(float((x - y).abs().max()) for x, y in zip(pc, pp))
    require(row_err <= TRAIN_ATOL and dense_err <= TRAIN_ATOL,
            f"{tag}: rows {row_err}, dense params {dense_err}")
    init = key_init_uniform(rp[0], conf.seed or 42, 2, conf.pull_dim - 2,
                            conf.initial_range)
    changes = require_change(tag, (
        ("values", rc[1][:, 2:], rp[1][:, 2:], init, 0.0),
        ("state", rc[2], rp[2], np.zeros_like(rp[2]), 0.0)), stored=True)
    print(f"{tag} vs the CPU over {CPU_STEPS} steps: losses {lc} vs {lp}, "
          f"demb (show/clk exact) max abs err of the largest grad a step "
          f"{', '.join(grads)}; {rc[0].size} rows by key (show/clk exact, "
          f"max abs err {row_err:.3e}; their change: {changes}), dense max "
          f"abs err {dense_err:.3e}")


def step_split(tag: str, fn, steps: int) -> dict:
    """The host-engine step's device split from a profile of ``fn`` over
    ``steps`` steps: ms a step of host->device copies (the upload), of
    device->host copies (the demb and preds downloads) and of the rest
    (kernels)."""
    by_name = device_profile(tag, fn, kernels=(KERNEL, GRAD))
    h2d = sum(v for k, v in by_name.items() if "HtoD" in k)
    d2h = sum(v for k, v in by_name.items() if "DtoH" in k)
    rest = sum(by_name.values()) - h2d - d2h
    split = {"upload_ms": h2d / steps / 1e3, "download_ms": d2h / steps / 1e3,
             "device_ms": rest / steps / 1e3} if by_name else {}
    print(f"timing {tag}: inside the step, ms a step: " + (", ".join(
        f"{k[:-3]} {v:.4f}" for k, v in split.items()) or "not measured"))
    return split


def serve_bundle(tag: str, bundle: str, batches, tasks: int):
    """Serve ``batches`` through ``CTRPredictor(device="cuda")``, counted:
    the forward once a batch; scores against the predictor on the CPU.
    Returns (ms a batch, launches)."""
    pred = CTRPredictor(bundle, device="cuda")
    pred.predict_batch(batches[0])           # warm-up, before the count
    secs, scores, launches = counted(
        lambda: [pred.predict_batch(b) for b in batches],
        {seqpool_cvm_cuda.__name__: len(batches)}, tag)
    cpu = CTRPredictor(bundle, device="cpu")
    shape = (batches[0].num_rows,) + ((tasks,) if tasks > 1 else ())
    err = 0.0
    for b, got in zip(batches, scores):
        require(got.shape == shape and np.isfinite(got).all(),
                f"{tag}: scores {got.shape}")
        err = max(err, float(np.abs(got - cpu.predict_batch(b)).max()))
    require(err <= SCORE_ATOL, f"{tag}: card vs CPU predictor {err}")
    ms = secs / len(batches) * 1e3
    print(f"{tag}: {len(batches)} batches of {batches[0].batch_size}, "
          f"launches {launches[seqpool_cvm_cuda.__name__]}, scores "
          f"{shape}, max |card - CPU predictor| {err:.3e}; {ms:.4f} "
          "ms/batch")
    return ms, launches


def phase_host_engine(rng, seed: int) -> dict:
    """The host-table engine and the models of ``examples/01``, ``03`` and
    ``04`` at their widths, and serving bundles of MMoE and FeedDNN."""
    conf, tconf = example_confs()
    fwd, bwd = seqpool_cvm_cuda.__name__, seqpool_cvm_grad_cuda.__name__
    out: dict = {"launches": {}}
    os.makedirs(WORK, exist_ok=True)

    # (a) examples/01: Wide&Deep through CTRTrainer(use_device_table=False)
    path = os.path.join(WORK, "widedeep-part-0")
    lengths = rng.integers(1, 4, size=(HE_BATCHES * WD_B, WD_S))
    write_slot_lines(path, lengths,
                     rng.integers(1, HE_VOCAB, size=int(lengths.sum()),
                                  dtype=np.uint64),
                     rng.integers(0, 2, size=lengths.shape[0]),
                     rng.normal(size=(lengths.shape[0], WD_DENSE)))
    feed = slot_feed_conf(WD_S, WD_B, WD_DENSE)
    ds = SlotDataset(feed)
    ds.set_filelist([path])
    ds.load_into_memory()
    batches = list(ds.batches())
    require(len(batches) == HE_BATCHES, f"host engine: {len(batches)} "
                                        "batches loaded")
    torch.manual_seed(seed)
    model = WideDeep(WD_S * conf.pull_dim + WD_DENSE, WD_HIDDEN)
    twin_model, cpu_model = copy.deepcopy(model), copy.deepcopy(model)
    trainer = CTRTrainer(model, feed, conf, tconf, use_device_table=False,
                         device="cuda")
    require(not trainer.fused and trainer.table.backend == "native",
            "host engine: the trainer did not take a native EmbeddingTable")
    losses = []
    n = HE_BATCHES
    pass_s, metrics, out["launches"]["host_engine_trainer"] = counted(
        lambda: trainer.train_from_dataset(
            ds, fetch_handler=lambda s, loss, p: losses.append(float(loss))),
        {fwd: n, bwd: n}, "host engine trainer")
    size = len(trainer.table)
    eval_s, ev, out["launches"]["host_engine_evaluate"] = counted(
        lambda: trainer.evaluate(ds), {fwd: n}, "host engine evaluate")
    require(len(trainer.table) == size and ev["ins_num"] == n * WD_B,
            "host engine: evaluate created rows or lost instances")
    step = TrainStep(twin_model, conf, tconf, WD_B, WD_S, WD_DENSE,
                     device="cuda")
    twin = EmbeddingTable(conf, backend="native")
    dembs = []
    state, first = host_hand_loop(step, (*step.init(), step.init_auc_state()),
                                  twin, batches[:CPU_STEPS], dembs=dembs)
    card2 = host_world(first, twin, state[0], dembs)
    state, rest = host_hand_loop(step, state, twin, batches[CPU_STEPS:])
    calc = AucCalculator()
    calc.absorb(state[2])
    require(metrics == calc.compute(), f"host engine trainer vs hand loop: "
                                       f"metrics {metrics} vs "
                                       f"{calc.compute()}")
    require_same_host("host engine trainer vs hand loop",
                      host_world(losses, trainer.table, trainer.params),
                      host_world(first + rest, twin, state[0]))
    cstep = TrainStep(cpu_model, conf, tconf, WD_B, WD_S, WD_DENSE,
                      device="cpu")
    ctable, cdembs = EmbeddingTable(conf, backend="native"), []
    cstate, clost = host_hand_loop(
        cstep, (*cstep.init(), cstep.init_auc_state()), ctable,
        batches[:CPU_STEPS], dembs=cdembs)
    host_vs_cpu("host engine (Wide&Deep)", card2,
                host_world(clost, ctable, cstate[0], cdembs), conf)
    # a second pass, warm (the first paid the process's first GEMMs and
    # allocations), without the fetch handler
    trainer.reset_metrics()
    warm_s, _ = timed_secs(lambda: trainer.train_from_dataset(ds))
    t = trainer.timer
    out["wide_deep"] = {
        "first_pass_ms_per_step": pass_s / n * 1e3,
        "ms_per_step": warm_s / n * 1e3, "examples_per_s": n * WD_B / warm_s,
        "eval_ms_per_batch": eval_s / n * 1e3,
        **{f"{k}_ms": t.mean_ms(k) for k in ("pull", "step", "push")}}
    print(f"host engine (a): CTRTrainer(WideDeep {WD_HIDDEN}, "
          f"use_device_table=False) over {n} batches of B={WD_B} "
          f"({WD_S} slots, {WD_DENSE} dense): launches "
          f"{out['launches']['host_engine_trainer']}, losses "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}, auc {metrics['auc']:.6f}; "
          f"losses, metrics, all {size} rows by key and the dense params "
          f"bit for bit vs a hand loop of TrainStep + pull/push on a twin; "
          f"evaluate launches {out['launches']['host_engine_evaluate']}")
    print(f"timing host engine (a): the counted pass "
          f"{out['wide_deep']['first_pass_ms_per_step']:.4f} ms/step (the "
          f"fetch handler's read a batch); a second pass "
          f"{out['wide_deep']['ms_per_step']:.4f} ms/step, "
          f"{out['wide_deep']['examples_per_s']:.1f} examples/s, its spans "
          f"ms a step: pull {t.mean_ms('pull'):.4f}, step "
          f"{t.mean_ms('step'):.4f}, push {t.mean_ms('push'):.4f}; evaluate "
          f"{out['wide_deep']['eval_ms_per_batch']:.4f} ms/batch")
    out["wide_deep"].update(step_split(
        "host engine (a)", lambda: host_hand_loop(step, state, twin,
                                                  batches[:4]), 4))

    # (b) examples/04: MMoE through TrainStep over a host table
    mbatches = csr_batches(rng, HE_BATCHES, MM_B, MM_S, 0, HE_VOCAB)
    mm = MMoE(MM_S * conf.pull_dim, **MM_KW)
    cpu_mm = copy.deepcopy(mm)
    mstep = TrainStep(mm, conf, tconf, MM_B, MM_S, device="cuda")
    mtable = EmbeddingTable(conf, backend="native")
    reg = MetricRegistry()
    for name in ("ctr_auc", "cvr_auc"):
        reg.init_metric(name, num_buckets=1 << 16)
    timer = SpanTimer()
    mstate = [*mstep.init(), mstep.init_auc_state()]
    mlosses, mdembs, after = [], [], []

    def mmoe_pass():
        for i, b in enumerate(mbatches):
            labels = mmoe_labels(b)
            cvm = np.stack([np.ones(MM_B, np.float32), b.labels], axis=1)
            with timer.span("pull"):
                emb = mtable.pull(b.keys)
            with timer.span("step"):
                *mstate[:3], demb, loss, preds = mstep(
                    *mstate, emb, b.segment_ids, cvm, labels, b.dense,
                    b.row_mask())
            with timer.span("push"):
                mtable.push(b.keys, demb)
            p = preds.cpu().numpy()
            reg["ctr_auc"].add(p[:, 0], labels[:, 0], mask=b.row_mask())
            reg["cvr_auc"].add(p[:, 1], labels[:, 1], mask=b.row_mask())
            mlosses.append(float(loss))
            if i < CPU_STEPS and not after:
                mdembs.append(demb)
            if i == CPU_STEPS - 1 and not after:
                after.append(host_world(mlosses, mtable, mstate[0], mdembs))

    mm_s, _, out["launches"]["mmoe_host_engine"] = counted(
        mmoe_pass, {fwd: n, bwd: n}, "mmoe host engine")
    msgs = {k: reg.get_metric_msg(k) for k in ("ctr_auc", "cvr_auc")}
    require(np.isfinite(mlosses).all() and
            all(m["ins_num"] == n * MM_B for m in msgs.values()),
            f"mmoe: losses {mlosses}, metrics {msgs}")
    cstep = TrainStep(cpu_mm, conf, tconf, MM_B, MM_S, device="cpu")
    ctable, cdembs = EmbeddingTable(conf, backend="native"), []
    cstate, clost = host_hand_loop(
        cstep, (*cstep.init(), cstep.init_auc_state()), ctable,
        mbatches[:CPU_STEPS], labels_of=mmoe_labels, dembs=cdembs)
    host_vs_cpu("mmoe host engine", after[0],
                host_world(clost, ctable, cstate[0], cdembs), conf)
    # a second pass over the same batches, warm
    timer.reset()
    warm_s, _ = timed_secs(mmoe_pass)
    out["mmoe"] = {
        "first_pass_ms_per_step": mm_s / n * 1e3,
        "ms_per_step": warm_s / n * 1e3, "examples_per_s": n * MM_B / warm_s,
        **{f"{k}_ms": timer.mean_ms(k) for k in ("pull", "step", "push")}}
    print(f"mmoe (b): MMoE {MM_KW} through TrainStep over a native "
          f"EmbeddingTable, {n} steps of B={MM_B} ({MM_S} slots): launches "
          f"{out['launches']['mmoe_host_engine']}, losses "
          f"{mlosses[0]:.6f} -> {mlosses[n - 1]:.6f}, ctr_auc "
          f"{msgs['ctr_auc']['auc']:.6f}, cvr_auc "
          f"{msgs['cvr_auc']['auc']:.6f} over the counted pass; "
          f"{len(mtable)} rows")
    print(f"timing mmoe (b): the counted pass "
          f"{out['mmoe']['first_pass_ms_per_step']:.4f} ms/step; a second "
          f"pass {out['mmoe']['ms_per_step']:.4f} ms/step, "
          f"{out['mmoe']['examples_per_s']:.1f} examples/s (preds "
          f"downloaded for the registry), its spans ms a step: pull "
          f"{timer.mean_ms('pull'):.4f}, step {timer.mean_ms('step'):.4f}, "
          f"push {timer.mean_ms('push'):.4f}")
    mm_bundle = save_inference_model(
        os.path.join(WORK, "mmoe_bundle"), mstate[0],
        mtable.snapshot(reset_dirty=False), slot_feed_conf(MM_S, MM_B),
        conf)
    out["mmoe"].update(step_split(
        "mmoe (b)", lambda: host_hand_loop(mstep, mstate, mtable,
                                           mbatches[:4], mmoe_labels), 4))

    # (c) examples/03: FeedDNN on the fused engine, device prep
    fbatches = csr_batches(rng, FD_BATCHES, FD_B, FD_S, 0, FD_VOCAB,
                           npad=FD_NPAD)
    table = DeviceTable(conf, capacity=1 << 20, device="cuda",
                        backend="native", index_threads=1)
    # the twins start from the main path's arena: the eager run loop on
    # the card, and device prep on the CPU (every kernel's plain version)
    arena = (table.values.cpu().numpy(), table.state.cpu().numpy(),
             table.row_keys())
    ftwin, cpu_ftable = (DeviceTable(conf, capacity=1, device=dev,
                                     backend="native", index_threads=1)
                         for dev in ("cuda", "cpu"))
    ftwin.load_arena(*arena)
    cpu_ftable.load_arena(*arena)
    del arena
    dnn = FeedDNN(FD_S * conf.pull_dim)
    twin_fs = FusedTrainStep(copy.deepcopy(dnn), ftwin, tconf, FD_B, FD_S,
                             device_prep=True)
    cpu_fs = FusedTrainStep(copy.deepcopy(dnn), cpu_ftable, tconf, FD_B,
                            FD_S, device_prep=True)
    fs = FusedTrainStep(dnn, table, tconf, FD_B, FD_S, device_prep=True)
    tuples = reader_tuples(fbatches)
    fstate = (*fs.init(), fs.init_auc_state())
    first = np.unique(np.concatenate([b.keys for b in
                                      fbatches[:CPU_STEPS]]))
    first = first[first != 0]
    flosses, after = [], []

    def on_step(steps, loss):
        flosses.append(loss)
        if steps == CPU_STEPS:     # in the eager warm-up run
            rows = key_rows(table, first)
            after.append((rows, snapshot_rows(table, rows, fstate[0])))

    fd_s, res, out["launches"]["feed_dnn_run_graphs"] = count_launches(
        lambda: fs.train_stream(*fstate, iter(tuples), on_step=on_step),
        FD_BATCHES, "feed dnn")
    fstate = res[:3]
    graphs = fs.run_graphs
    require(res[4] == FD_BATCHES and
            (graphs.captures, graphs.replays) == (1, 1),
            f"feed dnn: {res[4]} steps, {graphs.captures} captures, "
            f"{graphs.replays} replays")
    require(not bool(fs.bad_flag), "feed dnn: the numeric sentinel tripped")
    tstate, tlosses = eager_run_loop(
        twin_fs, (*twin_fs.init(), twin_fs.init_auc_state()), tuples)
    flosses = [float(x) for x in flosses]
    require(flosses == [float(x) for x in tlosses],
            f"feed dnn vs eager run loop: losses {flosses} vs {tlosses}")
    require_same_training("feed dnn vs eager run loop",
                          (table, *fstate), (ftwin, *tstate))
    # the first CPU_STEPS steps on the CPU: its index takes the first
    # run's keys as the main path's did, so each key has the same row
    cpu_ftable.ensure_keys(np.concatenate([t[0] for t in
                                           tuples[:fs.DEV_CHUNK]]))
    rows, card_after = after[0]
    require(torch.equal(key_rows(cpu_ftable, first), rows),
            "feed dnn: the CPU twin numbered the keys otherwise")
    before = snapshot_rows(cpu_ftable, rows)
    cstate, closses = eager_run_loop(
        cpu_fs, (*cpu_fs.init(), cpu_fs.init_auc_state()),
        tuples[:CPU_STEPS])
    compare_twin("feed dnn: card vs CPU", flosses, card_after, closses,
                 snapshot_rows(cpu_ftable, rows, cstate[0]), before,
                 stored=True)
    del cpu_fs, cpu_ftable
    replay_s, _ = timed_secs(lambda: fs.train_stream(*fstate, iter(tuples)))
    out["feed_dnn"] = {"ms_per_step": fd_s / FD_BATCHES * 1e3,
                       "examples_per_s": FD_BATCHES * FD_B / fd_s,
                       "replay_ms_per_step": replay_s / FD_BATCHES * 1e3}
    print(f"feed dnn (c): FeedDNN {dnn.hidden} over a DeviceTable of 2^20 "
          f"rows, device prep, train_stream over {FD_BATCHES} batches of "
          f"B={FD_B} ({FD_S} slots, Npad {FD_NPAD}): 1 capture, 1 replay, "
          f"launches {out['launches']['feed_dnn_run_graphs']}, losses "
          f"{flosses[0]:.6f} -> {flosses[-1]:.6f}; losses, all {len(table)} "
          f"rows by key, the dense params, adam's state and the AUC state "
          f"bit for bit vs the eager run loop on a twin")
    print(f"timing feed dnn (c): {out['feed_dnn']['ms_per_step']:.4f} "
          f"ms/step, {out['feed_dnn']['examples_per_s']:.1f} examples/s (a "
          f"warm-up run and a captured one); every run replayed "
          f"{out['feed_dnn']['replay_ms_per_step']:.4f} ms/step")
    fd_bundle = save_inference_model(
        os.path.join(WORK, "feed_dnn_bundle"), fstate[0],
        table.to_host_table().snapshot(reset_dirty=False),
        slot_feed_conf(FD_S, FD_B), conf)

    # (d) serving both bundles on the card
    out["serve_mmoe_ms"], out["launches"]["serve_mmoe"] = serve_bundle(
        "serve mmoe (d)", mm_bundle, mbatches[:SERVE_BATCHES], 2)
    out["serve_feed_dnn_ms"], out["launches"]["serve_feed_dnn"] = \
        serve_bundle("serve feed dnn (d)", fd_bundle,
                     fbatches[:SERVE_BATCHES], 1)
    return out


# -- phase 4g: low-precision and variable arenas -------------------------------

# push variants: (value dtype, variable layout). The main path of the phase
# launches the first four, a row each in the kernels line; var_bf16 is
# checked against plain only.
ARENAS = {"int8": (torch.int8, False), "bf16": (torch.bfloat16, False),
          "var_f32": (torch.float32, True), "var_int8": (torch.int8, True),
          "var_bf16": (torch.bfloat16, True)}
ARENA_ROWS = ("int8", "bf16", "var_f32", "var_int8")
# examples/08's variable table: embedx 4 | expand 6 (pull 13, arena 9)
VAR_KW = dict(embedx_dim=4, expand_dim=6, variable_embedding=True)
# a bfloat16 value's neighbours lie at most 2^-7 of its magnitude away
BF16_SPACING = 2.0 ** -7
# int8 scales, kernel vs plain: the same IEEE divide of a group maximum
# that the plain merge's atomics move by up to PUSH_ATOL, so a scale moves
# by up to PUSH_ATOL / 127 beside its own rounding (rtol 1e-6)
SCALE_RTOL = 1e-6
# card vs CPU after CPU_STEPS steps over a low-precision arena: the share
# of stored values (int8 codes, bfloat16 values) allowed one step apart.
# The float32 rows before storing differ by ~1e-11 (PERF.md), so a value
# rounds the other way where it lies that close to a rounding boundary
STEP_SHARE = 1e-4
# (c) card vs CPU under bf16 dense compute: each dense weight within this
# share of adam's step (lr). bfloat16 products rounded apart change a
# near-cancelling grad by a large share of itself, and adam's first steps
# move each weight by about lr whatever its grad's size (PERF.md: 3.3e-5
# at lr 1e-3); a skipped or wrong-signed step is off by about lr
BF16_DENSE_LR_SHARE = 0.1
ARENA_REPEATS = 2            # push launches a case beside the first
ARENA_STEPS = 16             # host-prep steps of (b) and (d)
BF16_STEPS = 4               # (c) host prep, cut in depth


def arena_conf(variant: str, opt: str, threshold: float = 10.0):
    dtype, var = ARENAS[variant]
    kw = dict(embedx_dim=8, cvm_offset=3, embedx_threshold=threshold,
              optimizer=opt, seed=7)
    if var:
        kw.update(VAR_KW)
    return TableConfig(**kw), dtype


def warm_arena(rng, table: DeviceTable) -> None:
    """Rows past the null row: show/clk straddling the embedx threshold,
    warm optimizer state, int8 codes over their whole range at scales
    spread over four decades, size codes 0 (unclaimed), 1 and 2."""
    lay, conf = table.layout, table.conf
    n = len(table) + 1
    gen = torch.Generator(device="cuda")
    gen.manual_seed(int(rng.integers(1 << 31)))

    def ints(lo, hi, cols=None):
        shape = (n - 1,) if cols is None else (n - 1, cols)
        return torch.randint(lo, hi, shape, device="cuda", generator=gen)

    show = ints(0, int(max(2 * conf.embedx_threshold, 4.0))).float()
    stats = table.state if lay.stats_in_state else table.values
    stats[1:n, 0] = show.to(stats.dtype)
    stats[1:n, 1] = torch.floor(show * 0.3).to(stats.dtype)
    so = lay.stat_off
    ost = table.state[1:n, so:so + int(lay.state_offsets[-1])]
    if conf.optimizer == "adagrad":
        ost.uniform_(0.0, 2.0, generator=gen)
    elif conf.optimizer == "adam":
        ost.uniform_(0.0, 0.1, generator=gen)
        for gi in range(len(lay.groups)):
            ost[:, int(lay.state_offsets[gi])] = ints(0, 5).float()
    if lay.quantized:
        table.values[1:n, 2:] = ints(-127, 128, lay.dim - 2).to(torch.int8)
        table.state[1:n, 2:so] = 10.0 ** torch.empty(
            (n - 1, so - 2), device="cuda").uniform_(-6.0, -2.0,
                                                     generator=gen)
    if lay.variable:
        table.state[1:n, lay.size_col] = ints(0, 3).float()


def arena_grads(rng, layout, npad: int, n_keys: int) -> np.ndarray:
    """``push_grads`` at the grad width; under the variable layout each
    key's grads go to the base group (45%), the expand group (45%) or
    both (10%, base wins the claim), as slots of either width send."""
    demb = push_grads(rng, npad, layout.grad_dim, n_keys)
    if layout.variable:
        s, ex, ed = layout.groups[-1][0], layout.conf.embedx_dim, \
            layout.conf.expand_dim
        dest = rng.choice(3, size=npad, p=[0.45, 0.45, 0.1])
        demb[dest == 0, s + ex:s + ex + ed] = 0.0
        demb[dest == 1, s:s + ex] = 0.0
    return demb


def arena_table(rng, conf: TableConfig, dtype, vocab: int, upad_min: int):
    table = DeviceTable(conf, capacity=vocab + 1, device="cuda",
                        value_dtype=dtype,
                        uniq_buckets=BucketSpec(min_size=upad_min,
                                                max_size=1 << 18))
    table.prepopulate(vocab)
    warm_arena(rng, table)
    return table


def arena_batch(rng, conf: TableConfig, dtype, vocab: int, npad: int,
                n_keys: int, hot: int = 0, unknown: int = 0,
                upad_min: int = 1024):
    """``push_batch`` over a warm arena of ``dtype``."""
    table = arena_table(rng, conf, dtype, vocab, upad_min)
    keys = np.zeros(npad, np.uint64)
    keys[:n_keys] = rng.integers(1, vocab + 1, size=n_keys)
    if hot:
        keys[rng.choice(n_keys, size=hot, replace=False)] = 1 + vocab // 2
    if unknown:
        keys[rng.choice(n_keys, size=unknown, replace=False)] = \
            vocab + 1 + rng.integers(0, 1000, size=unknown)
    idx = table.prepare_batch(keys, create=False)
    return table, (arena_grads(rng, table.layout, npad, n_keys),
                   idx.inverse, idx.uniq_rows, idx.uniq_mask)


def arena_mixed(rng, conf: TableConfig, dtype, vocab: int, upad: int):
    """``mixed_batch`` over a warm arena of ``dtype``."""
    table = arena_table(rng, conf, dtype, vocab, 1024)
    kind = rng.choice(3, size=upad, p=[0.6, 0.2, 0.2])
    live = kind == 0
    urows = np.zeros(upad, np.int32)
    urows[live] = rng.choice(np.arange(1, vocab + 1), size=int(live.sum()),
                             replace=False)
    with_keys = np.flatnonzero(kind != 2)
    inv = rng.permutation(np.repeat(with_keys, rng.integers(
        1, 4, size=with_keys.size))).astype(np.int32)
    return table, (arena_grads(rng, table.layout, inv.size, inv.size), inv,
                   urows, live.astype(np.float32))


def arena_err(name: str, layout, got, want) -> float:
    """Kernel (``got``) vs plain (``want``) arenas under the arena's
    tolerances: show/clk and size codes exact; optimizer state within
    PUSH_ATOL; float32 values within PUSH_ATOL, bfloat16 ones within one
    spacing plus PUSH_ATOL (the new weight's float32 sums, rounded), int8
    codes within 1 with scales within SCALE_RTOL and the
    dequantized values within one quantum of their group. Returns the
    largest error of the (dequantized) values and the state."""
    (gv, gs), (wv, ws) = got, want
    so = layout.stat_off
    sv = (gs, ws) if layout.stats_in_state else (gv, wv)
    require(torch.equal(sv[0][:, :2], sv[1][:, :2]),
            f"{name}: show/clk differ between the push kernel and plain")
    if layout.variable:
        col = layout.size_col
        require(torch.equal(gs[:, col], ws[:, col]),
                f"{name}: size codes differ")
    ocols = slice(so, so + int(layout.state_offsets[-1]))
    serr = float((gs[:, ocols] - ws[:, ocols]).abs().max()) \
        if ocols.stop > so else 0.0
    require(serr <= PUSH_ATOL, f"{name}: optimizer state err {serr}")
    if layout.quantized:
        code = int((gv.int() - wv.int()).abs().max())
        require(code <= 1, f"{name}: int8 codes {code} apart")
        gsc, wsc = gs[:, 2:so], ws[:, 2:so]
        dsc = (gsc - wsc).abs()
        require(bool((dsc <= SCALE_RTOL * wsc.abs() +
                      PUSH_ATOL / layout.QMAX).all()),
                f"{name}: scales beyond rtol {SCALE_RTOL} + {PUSH_ATOL} / "
                f"127: largest difference {float(dsc.max())} (relative "
                f"{float((dsc / wsc.abs().clamp_min(1e-30)).max())})")
        verr = 0.0
        for gi, (start, width, _) in enumerate(layout.groups):
            a = gv[:, start:start + width].float() * gsc[:, gi:gi + 1]
            b = wv[:, start:start + width].float() * wsc[:, gi:gi + 1]
            quantum = torch.maximum(gsc, wsc)[:, gi:gi + 1]
            d = (a - b).abs()
            require(bool((d <= quantum * (1 + layout.QMAX * SCALE_RTOL) +
                          PUSH_ATOL).all()),
                    f"{name}: a dequantized value more than one quantum "
                    f"(+ {PUSH_ATOL}) from plain's")
            verr = max(verr, float(d.max()))
    elif layout.value_dtype == torch.bfloat16:
        a, b = gv.float(), wv.float()
        d = (a - b).abs()
        require(bool((d <= BF16_SPACING * torch.maximum(a.abs(), b.abs()) +
                      PUSH_ATOL).all()),
                f"{name}: bf16 values more than a spacing (+ {PUSH_ATOL}) "
                "apart")
        verr = float(d.max())
    else:
        verr = float((gv - wv).abs().max())
        require(verr <= PUSH_ATOL, f"{name}: values err {verr}")
    return max(verr, serr)


def check_arena(name: str, table, inputs):
    """The push kernel's variant vs plain on one batch: ARENA_REPEATS more
    launches from the same arenas with the dirty mark give the same bits
    and ``mark_dirty_plain``'s bitmap; ``arena_err``'s tolerances; the
    null row untouched. Returns the error and the card inputs."""
    demb, inv, urows, umask = (torch.from_numpy(np.ascontiguousarray(x))
                               .cuda() for x in inputs)
    layout = table.layout
    got, again, want = [(table.values.clone(), table.state.clone())
                        for _ in range(3)]
    sparse_push_cuda(layout, *got, demb, inv, urows, umask)
    dirty = torch.zeros(table.capacity, dtype=torch.bool, device="cuda")
    want_dirty = torch.zeros_like(dirty)
    mark_dirty_plain(want_dirty, urows)
    for rep in range(ARENA_REPEATS):
        again[0].copy_(table.values)
        again[1].copy_(table.state)
        dirty.zero_()
        sparse_push_cuda(layout, *again, demb, inv, urows, umask,
                         dirty=dirty)
        torch.cuda.synchronize()
        require(torch.equal(got[0], again[0]) and
                torch.equal(got[1], again[1]),
                f"{name}: launch {rep + 2} differs from the first")
        require(torch.equal(dirty, want_dirty),
                f"{name}: launch {rep + 2}: the dirty bitmap differs")
    sparse_push_plain(layout, *want, demb, inv, urows, umask)
    require(torch.equal(got[0][0], table.values[0]) and
            torch.equal(got[1][0], table.state[0]),
            f"{name}: null row written")
    err = arena_err(name, layout, got, want)
    live = umask > 0
    rows = urows[live].long()
    trained = int((got[0][rows, 2:] != table.values[rows, 2:]).any(1)
                  .sum())
    extra = ""
    if layout.variable:
        codes = got[1][rows, layout.size_col]
        extra = (f" size codes 0/1/2 after: {int((codes == 0).sum())}/"
                 f"{int((codes == 1).sum())}/{int((codes == 2).sum())};")
    lanes, cols = push_geometry(layout.dim)
    print(f"kernel check {PUSH} {name}: {layout.conf.optimizer} "
          f"{layout.value_dtype} D={layout.dim} grads {layout.grad_dim} "
          f"G={lanes} C={cols} state={table.state.shape[1]} "
          f"Npad={demb.shape[0]} Upad={urows.shape[0]} "
          f"live={int(live.sum())} rows trained={trained};{extra} max err "
          f"{err:.3e}; {ARENA_REPEATS + 1} launches bit-identical, bitmap "
          "exact")
    return err, (layout, table.values, table.state, demb, inv, urows, umask)


def phase_arena_push(rng):
    """(a) Each push variant vs plain: the training batch (hot key x500,
    50 unknown keys; adagrad and adam) over a 4,194,304-row warm arena,
    then all-padding, one-key, threshold-0 (sgd) and mixed warps. Returns
    each variant's largest error and the training inputs of the variants
    of the main path."""
    n_train = TB * TS * 2
    err = {v: 0.0 for v in ARENAS}
    train = {}
    for variant, (dtype, _) in ARENAS.items():
        for opt in ("adagrad", "adam"):
            conf, _ = arena_conf(variant, opt)
            e, inputs = check_arena(f"{variant} training-{opt}", *arena_batch(
                rng, conf, dtype, HOT_VOCAB, TNPAD, n_train, hot=500,
                unknown=50, upad_min=TNPAD))
            err[variant] = max(err[variant], e)
            if variant in ARENA_ROWS:
                train[(variant, opt)] = inputs
        for name, opt, thr, npad, n in (
                ("all-padding", "adagrad", 10.0, 1024, 0),
                ("one-key", "adam", 10.0, 1024, 1000),
                ("threshold-0", "sgd", 0.0, 2048, 1500)):
            conf, _ = arena_conf(variant, opt, thr)
            table, inputs = arena_batch(
                rng, conf, dtype, 4096, npad, n,
                hot=n - 1 if name == "one-key" else 0,
                unknown=20 if n > 1000 else 0)
            err[variant] = max(err[variant], check_arena(
                f"{variant} {name}", table, inputs)[0])
        for opt, upad in (("adagrad", 1003), ("adam", 1001)):
            conf, _ = arena_conf(variant, opt)
            err[variant] = max(err[variant], check_arena(
                f"{variant} mixed-warps-{opt}",
                *arena_mixed(rng, conf, dtype, 4096, upad))[0])
    return err, train


def arena_twin(table: DeviceTable, device: str, backend: str,
               arena=None) -> DeviceTable:
    """A table of ``table``'s layout on ``device`` holding ``arena``
    (values as float32, state, row keys; ``table``'s own by default)."""
    twin = DeviceTable(table.conf, capacity=1, uniq_buckets=table.uniq_buckets,
                       device=device, value_dtype=table.value_dtype,
                       backend=backend, index_threads=1)
    twin.load_arena(*(arena or arena_of(table)))
    return twin


def arena_of(table: DeviceTable):
    return (table.values.float().cpu().numpy(), table.state.cpu().numpy(),
            table.row_keys())


def arena_host_prep(tag: str, table: DeviceTable, model, tconf, batches,
                    variant: str, cpu_arena):
    """Host prep over ``batches`` on the card, counted (forward, backward,
    push and merge offsets once a step; the push as ``variant``), its
    first CPU_STEPS steps held against a CPU twin of ``cpu_arena`` (every
    kernel's plain version). Returns (state, launches, ms/step)."""
    cpu_model = copy.deepcopy(model)
    fs = FusedTrainStep(model, table, tconf, TB, TS)
    state = (*fs.init(), fs.init_auc_state())
    counters = TRAIN_WRAPPERS + tuple(PUSH_VARIANTS.values())
    t0 = time.perf_counter()
    state, losses, launches, touched, after = run_counted(fs, state, batches,
                                                          counters)
    secs = time.perf_counter() - t0
    n = len(batches)
    for name, k in launches.items():
        want = n if name in {w.__name__ for w in TRAIN_WRAPPERS} or \
            name == PUSH_VARIANTS[variant].__name__ else 0
        require(k == want, f"{tag}: {name} launched {k} times in {n} steps")
    cpu = arena_twin(table, "cpu", "numpy", cpu_arena)
    before = snapshot_rows(cpu, touched)
    cfs = FusedTrainStep(cpu_model, cpu, tconf, TB, TS)
    _, cpu_losses = train_steps(cfs, (*cfs.init(), cfs.init_auc_state()),
                                batches[:CPU_STEPS])
    compare_twin(f"{tag}: card vs CPU", losses, after, cpu_losses,
                 snapshot_rows(cpu, touched, cpu_model), before,
                 layout=table.layout, dense_atol=(
                     BF16_DENSE_LR_SHARE * tconf.dense_learning_rate
                     if tconf.bf16 else TRAIN_ATOL))
    print(f"{tag}: {n} host-prep steps, launches {launches}, losses "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}, {secs / n * 1e3:.4f} "
          "ms/step (first steps, syncs included)")
    return state, launches


def arena_files(tag: str, table: DeviceTable, model, conf, tconf, files,
                stream, variant: str):
    """``CTRTrainer(table=...).train_from_files`` over ``files`` (two runs
    of 16: one eager, one captured and replayed), counted (the push as
    the storage ``variant``), against the eager run loop over the same
    batches on a twin of the same arena and weights, bit for bit. Returns
    (trainer, launches, metrics, the eager twin's (step, state))."""
    run_fs = FusedTrainStep(copy.deepcopy(model), arena_twin(
        table, "cuda", "native"), tconf, TB, TS, device_prep=True)
    run_state = (*run_fs.init(), run_fs.init_auc_state())
    trainer = CTRTrainer(model, trainer_feed_conf(), conf, tconf,
                         table=table, buckets=BucketSpec(min_size=TNPAD,
                                                         max_size=1 << 18))
    require(trainer.step.device_prep, f"{tag}: device prep resolved off")
    n = len(stream)
    for c in PUSH_VARIANTS.values():
        c.launches = 0
    secs, metrics, launches = count_launches(
        lambda: trainer.train_from_files(files), n, tag)
    launches.update({c.__name__: c.launches for c in PUSH_VARIANTS.values()})
    for c in PUSH_VARIANTS.values():
        want = n if c is PUSH_VARIANTS[variant] else 0
        require(c.launches == want,
                f"{tag}: {c.__name__} launched {c.launches} times")
    graphs = trainer.step.run_graphs
    require((graphs.captures, graphs.replays) == (1, n // 16 - 1),
            f"{tag}: {graphs.captures} captures, {graphs.replays} replays")
    run_state, _ = eager_run_loop(run_fs, run_state, stream)
    require_same_training(f"{tag} (graphs) vs the eager run loop",
                          (trainer.table, trainer.params, trainer.opt_state,
                           None), (run_fs.table, *run_state[:2], None))
    calc = AucCalculator()
    calc.absorb(run_state[2])
    require(calc.compute() == metrics,
            f"{tag}: metrics {metrics} vs the eager run loop's "
            f"{calc.compute()}")
    require(not bool(trainer.step.bad_flag), f"{tag}: sentinel tripped")
    print(f"{tag}: train_from_files over {len(files)} files ({n} batches, "
          f"1 capture, {graphs.replays} replay), launches {launches}, auc "
          f"{metrics['auc']:.6f}; pass metrics, all {len(table)} rows by "
          f"key (values and state), the dense params and every optimizer "
          f"state tensor bit for bit vs the eager run loop on a twin; "
          f"{secs / n * 1e3:.4f} ms/step (first pass)")
    return trainer, launches, metrics, (run_fs, run_state)


def random_model(rng, in_dim: int, dtype=torch.float32):
    """``random_deepfm``'s weights in a ``DeepFM`` of ``dtype``."""
    model = random_deepfm(rng, in_dim)
    out = DeepFM(in_dim, HIDDEN, dtype=dtype)
    out.load_state_dict(model.state_dict())
    return out


def arena_step_ms(worlds, stream) -> dict:
    """ms/step of ``train_stream`` (run graphs, both runs replayed) over
    ``stream`` for each world, in turns (forward, then back)."""
    order = list(worlds) + list(reversed(worlds))
    ms = {k: [] for k in worlds}
    for k in order:
        fs, state = worlds[k]
        secs, _ = timed_secs(lambda: fs.train_stream(*state, iter(stream)))
        ms[k].append(secs / len(stream) * 1e3)
    return ms


def phase_arenas(rng) -> dict:
    """(b)-(e): the flagship over int8 and bf16 arenas, the variable+int8
    table, the int8 table's bundle; bytes per row; ms/step in turns."""
    conf, tconf, buckets = train_confs()
    out: dict = {"launches": {}}
    os.makedirs(WORK, exist_ok=True)
    files = [os.path.join(WORK, f"arena-part-{i}")
             for i in range(TRAINER_FILES)]
    for i, path in enumerate(files):
        write_trainer_file(rng, path, i * (HOT_VOCAB + 1))
    ds = SlotDataset(trainer_feed_conf(), buckets=BucketSpec(
        min_size=TNPAD, max_size=1 << 18))
    ds.set_filelist(files)
    ds.load_into_memory()
    stream = reader_tuples(list(ds.batches()))
    rows = {}
    for name, dtype, c in (("float32", torch.float32, conf),
                           ("bf16", torch.bfloat16, conf),
                           ("int8", torch.int8, conf),
                           ("var_int8", torch.int8,
                            TableConfig(cvm_offset=3, **VAR_KW))):
        t = DeviceTable(c, capacity=HOT_VOCAB, device="cuda",
                        value_dtype=dtype)
        rows[name] = (t.values[0].nbytes, t.state[0].nbytes,
                      t.memory_bytes())
        del t
    print("arenas: bytes a row (values, state, whole) and of a "
          f"{HOT_VOCAB}-row arena, read from the card: " + "; ".join(
              f"{k} {v} + {s} = {v + s} B, {m} B" for k, (v, s, m) in
              rows.items()))
    out["row_bytes"] = rows

    # (b) the flagship over the int8 table
    table = DeviceTable(conf, capacity=HOT_VOCAB + 1 + TRAINER_HEADROOM,
                        uniq_buckets=buckets, device="cuda",
                        value_dtype=torch.int8, backend="native",
                        index_threads=1)
    table.prepopulate(HOT_VOCAB)
    model = random_model(rng, TS * conf.pull_dim)
    init = arena_of(table)
    host_model = copy.deepcopy(model)
    trainer, launches, _, _ = arena_files(
        "arenas int8 (b): trainer files", table, model, conf, tconf, files,
        stream, "int8")
    out["launches"]["int8_files"] = launches
    hbatches = make_train_batches(rng, ARENA_STEPS)
    _, out["launches"]["int8_host_prep"] = arena_host_prep(
        "arenas int8 (b): host prep", arena_twin(table, "cuda", "native",
                                                 init),
        host_model, tconf, hbatches, "int8", init)

    # (e) the int8 table's bundle, served against the CPU predictor
    snap = table.snapshot()
    snap["embedx_ok"] = snap["values"][:, 0] >= conf.embedx_threshold
    bundle = save_inference_model(os.path.join(WORK, "int8_bundle"),
                                  trainer.params, snap, trainer_feed_conf(),
                                  conf)
    del snap
    out["serve_int8_ms"], out["launches"]["serve_int8"] = serve_bundle(
        "arenas serve int8 (e)", bundle, csr_batches(
            rng, SERVE_BATCHES, TB, TS, 0, HOT_VOCAB, npad=TNPAD), 1)
    shutil.rmtree(bundle, ignore_errors=True)
    del trainer, table, init
    gc.collect()

    # (c) the bf16 arena with bf16 dense compute, cut in depth
    bconf = TrainerConfig(dense_optimizer="adam", dense_learning_rate=1e-3,
                          bf16=True)
    table = DeviceTable(conf, capacity=HOT_VOCAB + 1 + TRAINER_HEADROOM,
                        uniq_buckets=buckets, device="cuda",
                        value_dtype=torch.bfloat16, backend="native",
                        index_threads=1)
    table.prepopulate(HOT_VOCAB)
    model = random_model(rng, TS * conf.pull_dim, torch.bfloat16)
    init = arena_of(table)
    host_model = copy.deepcopy(model)
    trainer, launches, _, _ = arena_files(
        "arenas bf16 (c): trainer files", table, model, conf, bconf, files,
        stream, "bf16")
    out["launches"]["bf16_files"] = launches
    _, out["launches"]["bf16_host_prep"] = arena_host_prep(
        "arenas bf16 (c): host prep", arena_twin(table, "cuda", "native",
                                                 init),
        host_model, bconf, hbatches[:BF16_STEPS], "bf16", init)
    del trainer, table, init
    gc.collect()

    # (d) variable (+int8) FusedTrainStep at examples/08's widths
    vconf = TableConfig(cvm_offset=3, embedx_threshold=0.0,
                        initial_range=0.01, learning_rate=0.1, seed=1,
                        **VAR_KW)
    for variant, dtype, steps in (("var_int8", torch.int8, ARENA_STEPS),
                                  ("var_f32", torch.float32, BF16_STEPS)):
        table = DeviceTable(vconf, capacity=HOT_VOCAB + 1,
                            uniq_buckets=buckets, device="cuda",
                            value_dtype=dtype, backend="native",
                            index_threads=1)
        table.prepopulate(HOT_VOCAB)
        init = arena_of(table)
        _, out["launches"][f"{variant}_host_prep"] = arena_host_prep(
            f"arenas {variant} (d): host prep", table,
            random_model(rng, TS * vconf.pull_dim), tconf,
            hbatches[:steps], variant, init)
        del table, init
        gc.collect()

    # ms/step of the three arenas under the flagship's f32 dense step, in
    # turns: train_stream's run graphs over the file batches
    worlds = {}
    model = random_model(rng, TS * conf.pull_dim)
    for name, dtype in (("int8", torch.int8), ("bf16", torch.bfloat16),
                        ("float32", torch.float32)):
        t = DeviceTable(conf, capacity=HOT_VOCAB + 1 + TRAINER_HEADROOM,
                        uniq_buckets=buckets, device="cuda",
                        value_dtype=dtype, backend="native", index_threads=1)
        t.prepopulate(HOT_VOCAB)
        fs = FusedTrainStep(copy.deepcopy(model), t, tconf, TB, TS,
                            device_prep=True)
        state = (*fs.init(), fs.init_auc_state())
        fs.train_stream(*state, iter(stream))     # warm-up and capture
        worlds[name] = (fs, state)
    out["ms_per_step"] = arena_step_ms(worlds, stream)
    print(f"timing arenas: ms/step of train_stream's run graphs over "
          f"{len(stream)} batches (B={TB}, device prep, f32 dense), in "
          f"turns: " + "; ".join(f"{k} {v}" for k, v in
                                 out["ms_per_step"].items()))
    del worlds
    gc.collect()
    return out


# -- phase 4h: the dense optimizers -------------------------------------------

# the dense optimizers and step options of A.2c, each over the flagship
DENSE_OPTS = {
    "lars": dict(dense_optimizer="lars", dense_learning_rate=0.1,
                 dense_weight_decay=1e-4),
    "lamb": dict(dense_optimizer="lamb", dense_learning_rate=1e-3,
                 dense_weight_decay=1e-4),
    "merge4": dict(dense_optimizer="adam", dense_learning_rate=1e-3,
                   grad_merge_steps=4),
    "recompute": dict(dense_optimizer="adam", dense_learning_rate=1e-3,
                      recompute=True),
}
MERGE_CPU_STEPS = 5          # gradient merging of 4: one emit and a step on


def flat_params(params) -> np.ndarray:
    """The dense params, one host float32 vector."""
    return np.concatenate([p.detach().float().cpu().numpy().ravel()
                           for p in params])


def opt_host_prep(tag: str, table: DeviceTable, model, tconf, batches):
    """Host prep on the card over the first steps of ``batches`` (2; 5
    under gradient merging), counted (every device-prep count held, the
    idle ones at 0), the dense params checked after each step (under
    merging: bit-unchanged but on the emit steps), held against a CPU twin
    of the same arena and weights (every kernel's plain version) by
    ``compare_twin``'s rule. The trust-ratio optimizers' dense steps (lars
    ~1e-4, lamb ~7e-4 over 2 steps) come within ten times of TRAIN_ATOL,
    so their dense change is held as the rows' is (``require_change``);
    adam's steps are lr = 1e-3 each, a hundred times TRAIN_ATOL, and its
    normalized step flips sign on near-zero grads, which puts card vs CPU
    at ~1e-6, above a thousandth of the change. Returns the launches."""
    every_k = max(int(tconf.grad_merge_steps), 1)
    steps = MERGE_CPU_STEPS if every_k > 1 else CPU_STEPS
    batches = batches[:steps]
    cpu_arena = arena_of(table)
    cpu_model = copy.deepcopy(model).cpu()
    init_params = flat_params(cpu_model.parameters())
    fs = FusedTrainStep(model, table, tconf, TB, TS)
    state = (*fs.init(), fs.init_auc_state())
    touched = touched_rows(table, batches)

    def run():
        nonlocal state
        losses, moved = [], []
        for b in batches:
            prev = [p.detach().clone() for p in state[0].parameters()]
            state, more = train_steps(fs, state, [b])
            losses += more
            moved.append(any(not torch.equal(a, p) for a, p in
                             zip(prev, state[0].parameters())))
        return losses, moved

    _, (losses, moved), launches = counted(
        run, {w.__name__: steps for w in TRAIN_WRAPPERS}, tag)
    want = [(i + 1) % every_k == 0 for i in range(steps)]
    require(moved == want, f"{tag}: the dense params moved on steps "
                           f"{moved}, expected {want}")
    after = snapshot_rows(table, touched, state[0])
    cpu = arena_twin(table, "cpu", "numpy", cpu_arena)
    before = snapshot_rows(cpu, touched)
    cfs = FusedTrainStep(cpu_model, cpu, tconf, TB, TS)
    _, cpu_losses = train_steps(cfs, (*cfs.init(), cfs.init_auc_state()),
                                batches)
    twin_after = snapshot_rows(cpu, touched, cpu_model)
    compare_twin(f"{tag}: card vs CPU", losses, after, cpu_losses,
                 twin_after, before)
    got, cwant = flat_params(after[2]), flat_params(twin_after[2])
    if tconf.dense_optimizer in ("lars", "lamb"):
        change = require_change(f"{tag}: card vs CPU", (
            ("dense params", got, cwant, init_params, 0.0),))
    else:
        change = (f"dense params' largest change "
                  f"{float(np.abs(cwant - init_params).max()):.3e}, held "
                  f"at atol {TRAIN_ATOL}")
    print(f"{tag}: card vs CPU over {steps} steps, {change}; launches "
          f"{launches}")
    if every_k > 1:
        print(f"{tag}: the dense params moved on host-prep steps {moved} "
              f"(gradient merging of {every_k}: bit-unchanged between "
              "emits)")
    return launches


def phase_dense_optimizers(rng) -> dict:
    """(4h) lars, lamb, adam under gradient merging of 4 and adam with
    recompute, each training the flagship (DeepFM 512-256-128, the
    adagrad table of 4,194,304 prepopulated rows, B=2048, 24 slots,
    Npad=102,400) through ``CTRTrainer.train_from_files`` on device prep
    with run graphs over two files of 16 batches, bit for bit against
    the eager run loop; then host-prep steps against the CPU; then each
    world's run graphs beside plain adam's, in turns."""
    card = card_line()
    conf, tconf, buckets = train_confs()
    out: dict = {"launches": {}}
    os.makedirs(WORK, exist_ok=True)
    files = [os.path.join(WORK, f"opt-part-{i}")
             for i in range(TRAINER_FILES)]
    for i, path in enumerate(files):
        write_trainer_file(rng, path, 0)
    ds = SlotDataset(trainer_feed_conf(), buckets=BucketSpec(
        min_size=TNPAD, max_size=1 << 18))
    ds.set_filelist(files)
    ds.load_into_memory()
    stream = reader_tuples(list(ds.batches()))
    base = DeviceTable(conf, capacity=HOT_VOCAB + 1 + TRAINER_HEADROOM,
                       uniq_buckets=buckets, device="cuda", backend="native",
                       index_threads=1)
    base.prepopulate(HOT_VOCAB)
    init = arena_of(base)
    model = random_model(rng, TS * conf.pull_dim)
    hbatches = make_train_batches(rng, MERGE_CPU_STEPS)
    worlds = {}
    for name, kw in DENSE_OPTS.items():
        oconf = TrainerConfig(**kw)
        tag = f"dense optimizers {name}"
        trainer, launches, _, (run_fs, run_state) = arena_files(
            f"{tag}: trainer files", arena_twin(base, "cuda", "native", init),
            copy.deepcopy(model), conf, oconf, files, stream, "f32")
        out["launches"][f"{name}_files"] = launches
        # host prep from the eager twin's trained arena and weights
        out["launches"][f"{name}_host_prep"] = opt_host_prep(
            f"{tag}: host prep", run_fs.table, copy.deepcopy(run_state[0]),
            oconf, hbatches)
        del run_fs, run_state
        worlds[name] = (trainer.step, [trainer.params, trainer.opt_state,
                                       trainer.auc_state])
        gc.collect()
    adam = FusedTrainStep(copy.deepcopy(model), arena_twin(
        base, "cuda", "native", init), tconf, TB, TS, device_prep=True)
    state = [*adam.init(), adam.init_auc_state()]
    adam.train_stream(*state, iter(stream))        # warm-up and capture
    worlds = {"adam": (adam, state), **worlds}
    out["ms_per_step"] = arena_step_ms(worlds, stream)
    print(f"timing dense optimizers: ms/step of train_stream's run graphs "
          f"over {len(stream)} batches (B={TB}, device prep, the flagship), "
          f"in turns: " + "; ".join(f"{k} {v}" for k, v in
                                    out["ms_per_step"].items()) +
          f" [{card}]")
    del worlds, adam, state, base
    gc.collect()
    torch.cuda.empty_cache()
    return out


def time_arena_push(train: dict) -> dict:
    """Each main-path push variant at the training shape (adagrad), with
    its merge order, per call and in a CUDA graph, beside plain and
    ``index_add_`` (the merge only), and its bound (``push_bound``: the
    grads of the live uniques' keys read once, the index arrays once, each
    live row's state and the value columns the variant touches read and
    written once)."""
    out = {}
    for variant in ARENA_ROWS:
        layout, values, state, demb, inv, urows, umask = \
            train[(variant, "adagrad")]
        pv, ps = values.clone(), state.clone()
        merged = torch.zeros((urows.shape[0], demb.shape[1]), device="cuda")
        inv_l = inv.long()
        t = timed(lambda: sparse_push_cuda(layout, values, state, demb, inv,
                                           urows, umask),
                  lambda: sparse_push_plain(layout, pv, ps, demb, inv, urows,
                                            umask),
                  lambda: merged.index_add_(0, inv_l, demb))
        with_bound(t, *push_bound(layout, demb, inv, urows, umask))
        vb, sb = layout.row_bytes()
        t["row_bytes"] = {"values": vb, "state": sb}
        t["dim"], t["grad_dim"] = layout.dim, layout.grad_dim
        print_timing(f"{PUSH}_{variant}", "training adagrad",
                     f"Npad={demb.shape[0]} D={layout.dim} grads "
                     f"{layout.grad_dim} row {vb} + {sb} B Upad="
                     f"{urows.shape[0]} live={int((umask > 0).sum())}",
                     "index_add_ (the merge only)", t)
        out[variant] = t
    return out


# -- phase 5 -----------------------------------------------------------------

def timed(kernel, plain, library) -> dict:
    """Kernel, plain and library call, per call and in a CUDA graph."""
    return {"ms": cuda_ms(kernel, ITERS), "plain_ms": cuda_ms(plain, ITERS),
            "library_ms": cuda_ms(library, ITERS),
            "graph_ms": graph_ms(kernel), "plain_graph_ms": graph_ms(plain),
            "library_graph_ms": graph_ms(library)}


def with_bound(t: dict, nbytes: int, ops: int) -> dict:
    """Add the least time the card could take: the larger of the bytes
    over HBM bandwidth and the operations over the float32 rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    t["bound_ms"] = max(bytes_ms, ops_ms)
    t["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    t["bound_bytes"] = nbytes
    return t


def print_timing(name: str, tag: str, shape: str, library: str,
                 t: dict) -> None:
    print(f"timing {name} {tag} ({shape}): per call: kernel {t['ms']:.5f} "
          f"ms, plain {t['plain_ms']:.5f} ms, {library} "
          f"{t['library_ms']:.5f} ms; bound {t['bound_ms']:.6f} ms "
          f"({t['bound_bytes']} bytes)")
    print(f"timing {name} {tag} in a CUDA graph (device time, no launch "
          f"gaps): kernel {t['graph_ms']:.5f} ms "
          f"({100 * t['bound_ms'] / t['graph_ms']:.1f}% of bound), plain "
          f"{t['plain_graph_ms']:.5f} ms, {library} "
          f"{t['library_graph_ms']:.5f} ms")


def time_shape(tag: str, batch: int, inputs, slots: int = S) -> dict:
    """Forward kernel, plain and ``segment_reduce`` at one shape."""
    emb, segs, n = inputs
    seg_lengths = torch.bincount(segs[:n].long(), minlength=batch * slots)
    valid = emb[:n]
    t = timed(lambda: seqpool_cvm_cuda(emb, segs, batch, slots, True, 2, 0.0),
              lambda: seqpool_cvm_plain(emb, segs, batch, slots, True, 2,
                                        0.0),
              lambda: torch.segment_reduce(valid, "sum", lengths=seg_lengths,
                                           unsafe=True))
    # the kernel must load the rows and ids of the n valid keys (padding
    # rows are not needed) and write the whole output once
    dim = emb.shape[1]
    nbytes = n * dim * 4 + n * 4 + batch * slots * dim * 4
    # adds over the keys, +pad, 2 logs, 1 sub
    ops = n * dim + batch * slots * 4
    with_bound(t, nbytes, ops)
    print_timing(KERNEL, tag, f"B={batch} S={slots} D={dim} "
                 f"Npad={emb.shape[0]} keys={n}", "segment_reduce", t)
    return t


def phase_timing(shapes: dict) -> dict:
    row = time_shape("serving", *shapes["serving"])
    row["launch_floor_ms"] = graph_ms(lambda: torch.cuda._sleep(0))
    print(f"timing launch floor: torch.cuda._sleep(0) in a CUDA graph "
          f"{row['launch_floor_ms']:.5f} ms")
    mk = time_shape("multi-key", *shapes["multikey"])
    row.update({f"multikey_{k}": v for k, v in mk.items()})
    tr = time_shape("training", *shapes["training"], TS)
    row.update({f"training_{k}": v for k, v in tr.items()})
    return row


def time_grad(inputs) -> dict:
    """Backward kernel at the training shape. Library yardstick:
    ``index_select`` of the zero-padded tail of g by segment id, which
    computes the non-CVM columns only."""
    g, segs, cvm = inputs
    off = cvm.shape[1]
    tail = torch.cat([g.reshape(TB * TS, -1)[:, off:],
                      g.new_zeros((1, g.shape[-1] - off))])
    t = timed(lambda: seqpool_cvm_grad_cuda(g, segs, cvm, TB, TS, True, off),
              lambda: seqpool_cvm_grad_plain(g, segs, cvm, TB, TS, True, off),
              lambda: torch.index_select(tail, 0, segs))
    with_bound(t, grad_bytes(g, segs, cvm), 0)
    print_timing(GRAD, "training", f"B={TB} S={TS} D={g.shape[-1]} "
                 f"Npad={segs.shape[0]}", "index_select", t)
    return t


def grad_bytes(g, segs, cvm) -> int:
    """Bytes of one backward with use_cvm: write d_emb once; read the ids,
    the tail columns of g and cvm_in once."""
    npad, dim = segs.shape[0], g.shape[-1]
    n_seg = g.shape[0] * g.shape[1]
    return npad * dim * 4 + npad * 4 + n_seg * (dim - cvm.shape[1]) * 4 + \
        cvm.numel() * 4


def push_bound(layout, demb, inv, urows, umask) -> Tuple[int, int]:
    """Bytes and operations of one push: read the grads of the keys of live
    uniques (the others are never read; ``grad_dim`` float32 each),
    inverse, uniq_rows and uniq_mask once; read and write the state row
    (float32) and the value row of each live unique once, the values at
    the arena's element size. Value columns 0, 1 (show/clk) count where
    the push touches them: read and written in a float32 arena; neither
    in a bfloat16 one (show/clk live in the state); written, not read, in
    an int8 one (they hold 0). Operations: the merge's adds, show/clk and
    ~6 a trained column (~3 more an int8 column: dequantize, divide,
    round)."""
    npad, gdim = demb.shape
    live = int((umask > 0).sum())
    live_keys = int((umask[inv.long()] > 0).sum())
    vb, sb = layout.row_bytes()
    item = vb // layout.dim
    body = (layout.dim - 2) * item
    if not layout.stats_in_state:
        vread = vwrite = vb
    elif layout.quantized:
        vread, vwrite = body, vb
    else:
        vread = vwrite = body
    nbytes = live_keys * gdim * 4 + npad * 4 + urows.shape[0] * 8 + \
        live * (vread + vwrite + 2 * sb)
    per_col = 9 if layout.quantized else 6
    return nbytes, live_keys * gdim + live * (2 + per_col * (layout.dim - 2))


def time_push(inputs) -> dict:
    """Push at the training shape, the wrapper's merge order (stable sort
    of ``inverse`` and the boundary kernel) included, and the push kernel
    alone on a precomputed merge order, with and without the dirty mark
    (in turns); the sort alone beside them. Library yardstick:
    ``index_add_`` of demb into [Upad, D], the merge only. Each call
    trains the arena copies further; the work per call stays."""
    layout, values, state, demb, inv, urows, umask = inputs
    upad = urows.shape[0]
    pv, ps = values.clone(), state.clone()
    merged = torch.zeros((upad, demb.shape[1]), device="cuda")
    inv_l = inv.long()
    t = timed(lambda: sparse_push_cuda(layout, values, state, demb, inv,
                                       urows, umask),
              lambda: sparse_push_plain(layout, pv, ps, demb, inv, urows,
                                        umask),
              lambda: merged.index_add_(0, inv_l, demb))
    order, offsets = merge_order(inv, upad)
    dirty = torch.zeros(values.shape[0], dtype=torch.bool, device="cuda")

    def kernel():
        push_rows(layout, values, state, demb, order, offsets, urows, umask)

    def marking():
        push_rows(layout, values, state, demb, order, offsets, urows, umask,
                  dirty)

    t["kernel_ms"] = cuda_ms(kernel, ITERS)
    t["kernel_graph_ms"] = graph_ms(kernel)
    # the kernel as device prep launches it, marking the bitmap, beside
    # the kernel without it (host prep's, and every step's before the
    # mark), in turns
    t["kernel_graph_turns_ms"], t["mark_graph_turns_ms"] = in_turns(
        kernel, marking)
    t["mark_ms"] = cuda_ms(marking, ITERS)
    t["mark_graph_ms"] = float(np.mean(t["mark_graph_turns_ms"]))
    t["mark_plain_graph_ms"] = graph_ms(lambda: (
        sparse_push_plain(layout, pv, ps, demb, inv, urows, umask),
        mark_dirty_plain(dirty, urows)))
    # the kernel's bound with the mark: one byte a distinct marked row
    t["mark_bytes"] = int(torch.unique(urows).numel())
    t["mark_bound_ms"] = (push_bound(layout, demb, inv, urows, umask)[0] +
                          t["mark_bytes"]) / HBM_BYTES_PER_S * 1e3
    t["sort_ms"] = cuda_ms(lambda: torch.sort(inv, stable=True), ITERS)
    t["sort_graph_ms"] = graph_ms(lambda: torch.sort(inv, stable=True))
    with_bound(t, *push_bound(layout, demb, inv, urows, umask))
    t["state_columns"] = state.shape[1]
    opt = layout.conf.optimizer
    print_timing(PUSH, f"training {opt}", f"Npad={demb.shape[0]} "
                 f"D={demb.shape[1]} Upad={upad} live="
                 f"{int((umask > 0).sum())} state columns {state.shape[1]}",
                 "index_add_", t)
    print(f"timing {PUSH} training {opt}: the push kernel alone (merge "
          f"order precomputed), per call {t['kernel_ms']:.5f} ms, in a CUDA "
          f"graph {t['kernel_graph_ms']:.5f} ms "
          f"({100 * t['bound_ms'] / t['kernel_graph_ms']:.1f}% of bound); "
          f"the stable sort of inverse alone, per call {t['sort_ms']:.5f} "
          f"ms, in a CUDA graph {t['sort_graph_ms']:.5f} ms")
    print(f"timing {PUSH} training {opt}: the push kernel alone in a CUDA "
          f"graph, in turns (plain launch, marking, marking, plain): "
          f"without the dirty mark {t['kernel_graph_turns_ms']} ms, with "
          f"it {t['mark_graph_turns_ms']} ms; with it per call "
          f"{t['mark_ms']:.5f} ms, bound {t['mark_bound_ms']:.6f} ms "
          f"({t['mark_bytes']} bytes of marks); plain push and plain mark "
          f"in a CUDA graph {t['mark_plain_graph_ms']:.5f} ms")
    return t


def time_offsets(inputs) -> dict:
    """The boundary kernel at the training shape, on the sorted inverse.
    Plain: ``merge_offsets_plain`` (``bincount`` reads the largest id back
    to the host, so it cannot be captured in a CUDA graph); library:
    ``searchsorted`` of each unique in the sorted inverse."""
    inv, urows = inputs[4], inputs[5]
    upad = urows.shape[0]
    sorted_inv = torch.sort(inv, stable=True).values
    grid = torch.arange(upad + 1, dtype=inv.dtype, device=inv.device)
    kernel = lambda: merge_offsets(sorted_inv, upad)  # noqa: E731
    library = lambda: torch.searchsorted(  # noqa: E731
        sorted_inv, grid, out_int32=True)
    t = {"ms": cuda_ms(kernel, ITERS),
         "plain_ms": cuda_ms(lambda: merge_offsets_plain(sorted_inv, upad),
                             ITERS),
         "library_ms": cuda_ms(library, ITERS),
         "graph_ms": graph_ms(kernel), "plain_graph_ms": None,
         "library_graph_ms": graph_ms(library)}
    # read the sorted inverse once, write the offsets once
    with_bound(t, inv.numel() * 4 + (upad + 1) * 4, 0)
    print(f"timing {OFFSETS} training (Npad={inv.numel()} Upad={upad}): per "
          f"call: kernel {t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, "
          f"searchsorted {t['library_ms']:.5f} ms; bound "
          f"{t['bound_ms']:.6f} ms ({t['bound_bytes']} bytes); in a CUDA "
          f"graph: kernel {t['graph_ms']:.5f} ms "
          f"({100 * t['bound_ms'] / t['graph_ms']:.1f}% of bound), "
          f"searchsorted {t['library_graph_ms']:.5f} ms (plain: not "
          "capturable)")
    return t


def probe_bound(mirror, keys: torch.Tensor, n_valid: torch.Tensor) -> int:
    """Bytes of one probe: the valid keys read, the 16-byte quads each
    non-zero key walks until its match or the first empty quad (at most
    the window), rows and found written for all N keys."""
    n, nv = keys.shape[0], int(n_valid)
    valid = keys[:nv]
    khi, klo = key_halves(valid)
    start = device_hash(khi, klo) & mirror.mask
    idx = start[:, None] + torch.arange(mirror.window, device=keys.device)
    win = mirror.tab[idx]
    stop = ((win[..., 0] == -1) & (win[..., 1] == -1)) | (
        ((win[..., 0].long() & 0xFFFFFFFF) == khi[:, None]) &
        ((win[..., 1].long() & 0xFFFFFFFF) == klo[:, None]))
    walked = torch.where(stop.any(1), stop.int().argmax(1) + 1,
                         mirror.window)
    quads = int(walked[valid != 0].sum())
    return nv * 8 + quads * 16 + n * 5 + 4, quads


def time_dedup(tag: str, keys: np.ndarray) -> dict:
    """K5 on one batch: whole, per call and in a CUDA graph; its sort half
    and its numbering half; ``torch.sort`` of the packed keys (the sort's
    library call); plain and ``torch.unique`` (the function's library
    call), per call only: they read values back to the host, so they are
    not captured in a graph."""
    kt = torch.from_numpy(keys.view(np.int64)).cuda()
    packed = kt ^ SIGN
    srt = dedup_sort_cuda(kt)
    active = [d for d, on in enumerate(srt.plan[:DIGITS].tolist()) if on]
    n = keys.size
    t = {"ms": cuda_ms(lambda: device_dedup_cuda(kt), ITERS),
         "graph_ms": graph_ms(lambda: device_dedup_cuda(kt)),
         "sort_ms": cuda_ms(lambda: dedup_sort_cuda(kt), ITERS),
         "sort_graph_ms": graph_ms(lambda: dedup_sort_cuda(kt)),
         "number_ms": cuda_ms(lambda: dedup_number_cuda(srt), ITERS),
         "number_graph_ms": graph_ms(lambda: dedup_number_cuda(srt)),
         "library_sort_ms": cuda_ms(lambda: torch.sort(packed, stable=True),
                                    ITERS),
         "library_sort_graph_ms": graph_ms(
             lambda: torch.sort(packed, stable=True)),
         "plain_ms": cuda_ms(lambda: device_dedup_plain(kt), ITERS),
         "plain_graph_ms": None,
         "library_ms": cuda_ms(lambda: torch.unique(
             packed, sorted=True, return_inverse=True), ITERS),
         "library_graph_ms": None, "active_digits": active}
    # the keys read once; inverse, uniques, order, offsets and n_uniq
    # written once
    with_bound(t, n * 8 + n * 4 + n * 8 + n * 8 + (n + 1) * 4 + 4, 0)
    print(f"timing {DEDUP} {tag} (N={n}, active digits {active}): per call "
          f"{t['ms']:.5f} ms, in a CUDA graph {t['graph_ms']:.5f} ms "
          f"({100 * t['bound_ms'] / t['graph_ms']:.1f}% of bound "
          f"{t['bound_ms']:.6f} ms, {t['bound_bytes']} bytes); its sort "
          f"{t['sort_ms']:.5f} per call, {t['sort_graph_ms']:.5f} in a graph; "
          f"its numbering {t['number_ms']:.5f} per call, "
          f"{t['number_graph_ms']:.5f} in a graph; torch.sort(stable) "
          f"{t['library_sort_ms']:.5f} per call, "
          f"{t['library_sort_graph_ms']:.5f} in a graph; plain "
          f"{t['plain_ms']:.5f}, torch.unique {t['library_ms']:.5f} per call "
          "(neither capturable)")
    return t


def in_turns(a, b, timer=graph_ms) -> Tuple[list, list]:
    """``timer``'s readings of ``a`` and ``b`` taken in turns (a, b, b,
    a): two each, in the same state of the card."""
    ra, rb = [timer(a)], [timer(b)]
    rb.append(timer(b))
    ra.append(timer(a))
    return ra, rb


def time_dedup_probe(inputs, quads: int) -> dict:
    """The fused dedup and probe on the training batch over the
    4,194,304-key mirror, whole and its numbering half, beside the pair it
    replaces (K5 then K6), each per call and in a CUDA graph, the graphs in
    turns. Plain: per call only (it reads a count back). No single PyTorch
    call computes it."""
    mirror, keys = inputs["mirror"], inputs["keys"]
    kt = torch.from_numpy(keys.view(np.int64)).cuda()
    m = (mirror.tab, mirror.mask, mirror.window)
    srt = dedup_sort_cuda(kt)

    def fused():
        device_dedup_probe_cuda(kt, *m)

    def fused_number():
        dedup_number_probe_cuda(srt, *m)

    def pair():
        dd = device_dedup_cuda(kt)
        device_probe_cuda(*m, dd.uniq_keys, dd.n_uniq)

    def pair_number():
        dd = dedup_number_cuda(srt)
        device_probe_cuda(*m, dd.uniq_keys, dd.n_uniq)

    whole = in_turns(fused, pair)
    number = in_turns(fused_number, pair_number)
    cold = in_turns(fused_number, pair_number, cold_graph_ms)
    t = {"ms": cuda_ms(fused, ITERS), "graph_ms": float(np.mean(whole[0])),
         "number_ms": cuda_ms(fused_number, ITERS),
         "number_graph_ms": float(np.mean(number[0])),
         "pair_ms": cuda_ms(pair, ITERS),
         "pair_graph_ms": float(np.mean(whole[1])),
         "pair_number_ms": cuda_ms(pair_number, ITERS),
         "pair_number_graph_ms": float(np.mean(number[1])),
         "number_cold_ms": float(np.mean(cold[0])),
         "pair_number_cold_ms": float(np.mean(cold[1])),
         "graph_readings": {"whole": whole[0], "number": number[0],
                            "pair": whole[1], "pair_number": number[1],
                            "number_cold": cold[0],
                            "pair_number_cold": cold[1]},
         "plain_ms": cuda_ms(lambda: device_dedup_probe_plain(kt, *m),
                             ITERS),
         "plain_graph_ms": None, "library_ms": None,
         "library_graph_ms": None, "quads_walked": quads}
    # K5's bytes (keys read; inverse, uniques, order, offsets, n_uniq
    # written), the quads walked, rows and found written for all N
    n = keys.size
    with_bound(t, n * 8 + n * 4 + n * 8 + n * 8 + (n + 1) * 4 + 4 +
               quads * 16 + n * 5, 0)
    print(f"timing {DEDUP_PROBE} training (N={n}, {quads} quads walked): "
          f"whole per call {t['ms']:.5f} ms, in a CUDA graph "
          f"{t['graph_ms']:.5f} ({100 * t['bound_ms'] / t['graph_ms']:.1f}% "
          f"of bound {t['bound_ms']:.6f} ms, {t['bound_bytes']} bytes), "
          f"readings {whole[0]}; its numbering {t['number_ms']:.5f} per "
          f"call, {t['number_graph_ms']:.5f} in a graph, readings "
          f"{number[0]}; the pair it replaces (K5, then K6): whole "
          f"{t['pair_ms']:.5f} per call, {t['pair_graph_ms']:.5f} in a graph "
          f"{whole[1]}, numbering then K6 {t['pair_number_ms']:.5f} per "
          f"call, {t['pair_number_graph_ms']:.5f} in a graph {number[1]}; "
          f"with cold caches (L2 flushed before each replay): numbering "
          f"{t['number_cold_ms']:.5f} {cold[0]}, numbering then K6 "
          f"{t['pair_number_cold_ms']:.5f} {cold[1]}; plain "
          f"{t['plain_ms']:.5f} per call (not capturable)")
    return t


def time_index(inputs) -> Tuple[dict, dict, dict]:
    """K5, K6 and the fused dedup and probe at the training shape. K5
    (``time_dedup``) on the training batch (keys in [1, 2^22]) and on as
    many keys over all 64 bits. K6: the probe of the batch's uniques over
    the 4,194,304-key mirror; no single PyTorch call computes it. The
    fused pass: ``time_dedup_probe``."""
    dd, mirror, keys = inputs["dedup"], inputs["mirror"], inputs["keys"]
    n = keys.size
    k5 = time_dedup("training", keys)
    k5["keys64"] = time_dedup("keys over 64 bits", inputs["keys64"])
    args = (mirror.tab, mirror.mask, mirror.window, dd.uniq_keys, dd.n_uniq)
    k6 = {"ms": cuda_ms(lambda: device_probe_cuda(*args), ITERS),
          "graph_ms": graph_ms(lambda: device_probe_cuda(*args)),
          "plain_ms": cuda_ms(lambda: device_probe_plain(*args), ITERS),
          "plain_graph_ms": graph_ms(lambda: device_probe_plain(*args)),
          "library_ms": None, "library_graph_ms": None}
    nbytes, quads = probe_bound(mirror, dd.uniq_keys, dd.n_uniq)
    with_bound(k6, nbytes, 0)
    k6["quads_walked"] = quads
    print(f"timing {PROBE} training (N={n}, {int(dd.n_uniq)} uniques, "
          f"{quads} quads walked, mirror {mirror.tab.shape[0]} slots): per "
          f"call: kernel {k6['ms']:.5f} ms, plain {k6['plain_ms']:.5f} ms; "
          f"bound {k6['bound_ms']:.6f} ms ({k6['bound_bytes']} bytes); in a "
          f"CUDA graph: kernel {k6['graph_ms']:.5f} ms "
          f"({100 * k6['bound_ms'] / k6['graph_ms']:.1f}% of bound), plain "
          f"{k6['plain_graph_ms']:.5f} ms; no library call")
    return k5, k6, time_dedup_probe(inputs, quads)


PHASE_S: dict = {}            # wall seconds of each phase_* call, in order


def time_phases() -> None:
    """Wrap every ``phase_*`` function of this module so that each call
    adds its wall seconds to ``PHASE_S`` under its name."""
    def wrap(fn):
        key = fn.__name__[len("phase_"):]

        @functools.wraps(fn)
        def timed_phase(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                PHASE_S[key] = round(PHASE_S.get(key, 0.0) +
                                     time.perf_counter() - t0, 2)
        return timed_phase
    for name, fn in list(globals().items()):
        if name.startswith("phase_") and callable(fn):
            globals()[name] = wrap(fn)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mx-rank", metavar="SPEC",
                    help="run one rank of phase 4x from its spec file "
                         "(the phase starts these processes itself)")
    args = ap.parse_args()
    if args.mx_rank:
        return multihost_rank(args.mx_rank)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    rng = np.random.default_rng(args.seed)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    time_phases()
    try:
        ptxas = phase_build()
        loader_build = start_loader_build()
        err, shapes = phase_kernel(rng)
        grad_err, grad_inputs = phase_kernel_grad(rng)
        push_err, push_inputs = phase_kernel_push(rng)
        train_inputs = push_inputs["adagrad"]
        offsets_err = phase_kernel_offsets(rng, train_inputs[4],
                                           train_inputs[5].shape[0])
        # the phases added since draw from generators of their own, so the
        # earlier phases keep their inputs
        index_rng = np.random.default_rng([args.seed, 7])
        index_err, index_inputs = phase_kernel_index(
            index_rng, make_train_batches(index_rng, 1)[0][0],
            np.random.default_rng([args.seed, 9]))
        serve_launches, serve_bundle, serve_batches = phase_serve(
            rng, args.seed)
        export = start_export(serve_bundle, serve_batches)
        train, train_init = phase_train(rng)
        train_dev = phase_train_device(np.random.default_rng([args.seed, 8]),
                                       train_init)
        trainer = phase_trainer(np.random.default_rng([args.seed, 11]))
        growth = phase_graph_growth(np.random.default_rng([args.seed, 13]))
        loop = phase_pass_loop(np.random.default_rng([args.seed, 17]))
        tiered = phase_tiered_loop(np.random.default_rng([args.seed, 19]))
        engines = phase_host_engine(np.random.default_rng([args.seed, 23]),
                                    args.seed)
        arena_rng = np.random.default_rng([args.seed, 29])
        arena_errs, arena_train = phase_arena_push(arena_rng)
        arenas = phase_arenas(arena_rng)
        dense = phase_dense_optimizers(np.random.default_rng([args.seed, 31]))
        disk = phase_disk_ladder(np.random.default_rng([args.seed, 37]),
                                 tiered["files"])
        rest = phase_rest(np.random.default_rng([args.seed, 41]), args.seed)
        tiered_lp = phase_tiered_arenas(
            np.random.default_rng([args.seed, 43]), tiered["files"])
        deferred = phase_deferred(np.random.default_rng([args.seed, 47]),
                                  trainer["files"])
        q8 = phase_int8_serving(np.random.default_rng([args.seed, 53]),
                                tiered_lp.pop("int8_backing"),
                                tiered_lp.pop("int8_model"))
        feed = phase_data_feed(np.random.default_rng([args.seed, 59]))
        feed_files = feed.pop("files")
        staged = phase_staged_feed(np.random.default_rng([args.seed, 61]),
                                   feed_files)
        guard = phase_guard(np.random.default_rng([args.seed, 67]),
                            feed_files)
        tier = phase_serving_tier(np.random.default_rng([args.seed, 71]),
                                  serve_bundle, serve_batches)
        hosts = phase_host_tier(serve_bundle, serve_batches)
        embedded = phase_embedded(serve_bundle, serve_batches, loader_build,
                                  export)
        ctr = phase_ctr_ops(np.random.default_rng([args.seed, 73]),
                            trainer["files"])
        ps = phase_ps_service(np.random.default_rng([args.seed, 79]),
                              trainer["files"], serve_bundle, serve_batches)
        mesh = phase_mesh(np.random.default_rng([args.seed, 83]),
                          trainer["files"])
        mesh_host = phase_mesh_host(np.random.default_rng([args.seed, 89]),
                                    trainer["files"])
        multihost = phase_multihost(np.random.default_rng([args.seed, 97]),
                                    trainer["files"])
        timing = phase_timing(shapes)
        grad_timing = time_grad(grad_inputs)
        push_timing = time_push(train_inputs)
        push_timing["adam"] = time_push(push_inputs["adam"])
        offsets_timing = time_offsets(train_inputs)
        dedup_timing, probe_timing, fused_timing = time_index(index_inputs)
        arena_timing = time_arena_push(arena_train)
        del arena_train
    finally:
        for proc in BACKGROUND:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(WORK, ignore_errors=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    arena_ms = {k: round(float(np.mean(v)), 4)
                for k, v in arenas["ms_per_step"].items()}
    dense_ms = {k: round(float(np.mean(v)), 4)
                for k, v in dense["ms_per_step"].items()}
    lp_ms = {k: [round(r["train_ms"], 4) for r in v]
             for k, v in tiered_lp["passes"].items()}
    tier_p99 = {k: [round(r["p99_ms"], 3) for r in v["served"]]
                for k, v in tier["turns"].items()}
    print(f"chip_smoke: all phases {time.perf_counter() - t_start:.1f} s; "
          f"train host-prep (numpy index) {train['ms_per_step']:.4f} "
          f"ms/step, {train['examples_per_s']:.1f} examples/s; host-prep "
          f"(native index) {train_dev['host_prep_native_ms_per_step']:.4f} "
          f"ms/step; device-prep {train_dev['ms_per_step']:.4f} ms/step, "
          f"{train_dev['examples_per_s']:.1f} examples/s; trainer "
          f"(CTRTrainer.train_from_dataset, device prep) "
          f"{trainer['ms_per_step']:.4f} ms/step, "
          f"{trainer['examples_per_s']:.1f} examples/s, hand loop "
          f"{trainer['hand_ms_per_step']:.4f} ms/step; trainer files "
          f"(CTRTrainer.train_from_files) "
          f"{trainer['files_ms_per_step']:.4f} ms/step; step paths over "
          f"the trainer's batches: run graphs "
          f"{trainer['path_ms']['graph']:.4f}, eager run loop "
          f"{trainer['path_ms']['eager']:.4f}, hand loop "
          f"{trainer['path_ms']['hand']:.4f} ms/step; pass loop "
          f"{loop['loop_s']:.2f} s for 4 passes, barrier wait "
          f"{loop['barrier_s']:.4f} s, resume {loop['resume_s']:.4f} s; "
          f"tiered loop {tiered['loop_s']:.2f} s for "
          f"{sum(n for _, n in TIER_DAYS)} passes and their "
          f"sync twin's, train ms/step "
          f"{[round(r['train_ms'], 4) for r in tiered['passes']]}, a "
          f"backing of {tiered['backing_rows']} rows over an arena of "
          f"{TIER_ARENA}; host engine (Wide&Deep, CTRTrainer "
          f"use_device_table=False, B={WD_B}, a second pass) "
          f"{engines['wide_deep']['ms_per_step']:.4f} ms/step, "
          f"{engines['wide_deep']['examples_per_s']:.1f} examples/s; MMoE "
          f"(TrainStep over a host table, B={MM_B}, a second pass) "
          f"{engines['mmoe']['ms_per_step']:.4f} ms/step, "
          f"{engines['mmoe']['examples_per_s']:.1f} examples/s; FeedDNN "
          f"(train_stream, run graphs, B={FD_B}) "
          f"{engines['feed_dnn']['ms_per_step']:.4f} ms/step, "
          f"{engines['feed_dnn']['examples_per_s']:.1f} examples/s; serving "
          f"MMoE {engines['serve_mmoe_ms']:.4f}, FeedDNN "
          f"{engines['serve_feed_dnn_ms']:.4f} ms/batch; arenas "
          f"(train_stream run graphs, f32 dense) ms/step {arena_ms}, "
          f"serving the int8 table {arenas['serve_int8_ms']:.4f} ms/batch; "
          f"dense optimizers (run graphs) ms/step {dense_ms}; "
          f"disk ladder {disk['loop_s']:.2f} s for 4 worlds of "
          f"{sum(n for _, n in DISK_DAYS)} passes; "
          f"tiered int8 and bf16 (4k) train ms/step {lp_ms}, "
          f"bytes a row {tiered_lp['row_bytes']}, "
          f"{tiered_lp['phase_s']:.1f} s; deferred run graphs (4l) "
          f"{deferred['turns_ms']['deferred']} ms/step against ensure "
          f"{deferred['turns_ms']['ensure']}, {deferred['phase_s']:.1f} s; "
          f"int8 serving (4m) ms/batch {q8['turns_ms']}, table bytes "
          f"float32 {q8['f32_bytes']} int8 {q8['q8_bytes']}, "
          f"{q8['phase_s']:.1f} s; data feed (4n) train_from_files "
          f"ms/step by workers {feed['turns_ms']}, parse "
          f"{feed['parse_mb_s']:.1f} MB/s (one thread), "
          f"{feed['mp_mb_s']:.1f} MB/s ({FEED_WORKERS} workers), a "
          f"worker's start {feed['spawn_s']:.4f} s, "
          f"{feed['phase_s']:.1f} s; staged feed (4o) train_from_files "
          f"ms/step staged {staged['turns_ms']['staged']} unstaged "
          f"{staged['turns_ms']['unstaged']}, host_share "
          f"{staged['host_share']}, H2D GB/s {staged['h2d']['gb_s']}, "
          f"{staged['phase_s']:.1f} s; guard (4p) train_from_files "
          f"ms/step guard on {guard['turns_ms']['guard_on']} off "
          f"{guard['turns_ms']['guard_off']}, poll lag {guard['lags'][0]}-"
          f"{guard['lags'][-1]} steps, rollback {guard['rollback_s']:.4f} "
          f"s, {guard['phase_s']:.1f} s; serving tier (4q) p99 ms "
          f"{tier_p99}, examples/s thread against process fleet "
          f"{tier['scopes']}, reload ms a replica thread "
          f"{tier['thread_reload_ms']:.1f} process "
          f"{tier['proc_reload_ms']:.1f}, {tier['phase_s']:.1f} s; host "
          f"tier (4r) examples/s steady "
          f"{hosts['steady']['examples_per_s']:.1f}, kill window "
          f"{hosts['kill']['examples_per_s']:.1f}, MTTR "
          f"{hosts['mttr_s']:.3f} s, {hosts['phase_s']:.1f} s; embedded "
          f"(4s) loader ms a batch {embedded['steps_ms']}, "
          f"{embedded['phase_s']:.1f} s; ctr ops and auc runner (4t) "
          f"slot_importance {ctr['perm_s']:.2f} s, pool "
          f"{ctr['pool_s']:.2f} s, {ctr['phase_s']:.1f} s; ps service (4u) "
          f"spawn {ps['spawn_s']:.3f} s, host engine ms/step local "
          f"{[round(v, 3) for v in ps['train_turns_ms']['local']]} remote "
          f"{[round(v, 3) for v in ps['train_turns_ms']['remote']]}, "
          f"serving ms/batch bundle "
          f"{[round(v, 3) for v in ps['serve_turns_ms']['bundle']]} "
          f"service "
          f"{[round(v, 3) for v in ps['serve_turns_ms']['service']]}, "
          f"device bytes {ps['device_bytes']}, cache_wall "
          f"{ps['cache_wall']}, {ps['phase_s']:.1f} s; mesh (4v) ms/step "
          f"{ {k: [round(x, 4) for x in v] for k, v in mesh['ms_per_step'].items()} }, "
          f"{mesh['phase_s']:.1f} s; mesh host (4w) ms/step "
          f"{ {k: [round(x, 3) for x in v] for k, v in mesh_host['ms_per_step'].items()} }"
          f", 4 shards "
          f"{ {k: [round(x, 3) for x in v] for k, v in mesh_host['bcd_ms_per_step'].items()} }"
          f", ZeRO bytes a shard {mesh_host['zero_bytes']}, "
          f"{mesh_host['phase_s']:.1f} s; multi-host (4x) ms/step "
          f"{ {k: [round(x, 3) for x in v] for k, v in multihost['ms_per_step'].items()} }"
          f", dense sync ms a step {multihost['dense_ms']}, rank spawn s "
          f"{[round(x, 3) for x in multihost['spawn_s']]}, abort "
          f"{multihost['abort_s']:.3f} s, {multihost['phase_s']:.1f} s")
    print(f"chip_smoke: wall s by phase {PHASE_S} [{card_line()}]")
    print(smi.stdout.strip())
    host, dev = train["launches"], train_dev["launches"]

    def by_path(wrapper, **more) -> dict:
        """Launches on each main path (each counted from 0)."""
        paths = {**more, "train_host_prep": host.get(wrapper.__name__, 0),
                 "train_device_prep": dev[wrapper.__name__],
                 "trainer_device_prep": trainer["launches"][
                     wrapper.__name__],
                 "trainer_files": trainer["files_launches"][
                     wrapper.__name__],
                 "run_graphs_growth": growth["launches"][wrapper.__name__],
                 "pass_loop": loop["launches"][wrapper.__name__],
                 "tiered_loop": tiered["launches"][wrapper.__name__],
                 **{path: counts[wrapper.__name__]
                    for path, counts in engines["launches"].items()},
                 **{f"dense_{path}": counts.get(wrapper.__name__, 0)
                    for path, counts in dense["launches"].items()},
                 **{path: counts.get(wrapper.__name__, 0)
                    for path, counts in {**disk["launches"],
                                         **rest["launches"],
                                         **tiered_lp["launches"],
                                         **deferred["launches"],
                                         **q8["launches"],
                                         **feed["launches"],
                                         **staged["launches"],
                                         **guard["launches"],
                                         **tier["launches"],
                                         **hosts["launches"],
                                         **embedded["launches"],
                                         **ctr["launches"],
                                         **ps["launches"],
                                         **mesh["launches"],
                                         **mesh_host["launches"],
                                         **multihost["launches"]}.items()}}
        return {"launches": sum(paths.values()), "launches_by_path": paths,
                "counted_by": wrapper.__name__}

    rows = [
        {"name": KERNEL, "route": "cuda",
         "source": "paddlebox_tpu_torch/csrc/seqpool_cvm.cu",
         "replaces": "paddlebox_tpu/ops/pallas_seqpool.py:123",
         **by_path(seqpool_cvm_cuda, serve=serve_launches,
                   trainer_evaluate=trainer["eval_launches"]),
         "max_abs_err": err, **timing},
        {"name": GRAD, "route": "cuda",
         "source": "paddlebox_tpu_torch/csrc/seqpool_cvm_grad.cu",
         "replaces": "paddlebox_tpu/ops/seqpool_cvm.py:109",
         **by_path(seqpool_cvm_grad_cuda),
         "max_abs_err": grad_err, **grad_timing, "ptxas": ptxas[GRAD]},
        {"name": PUSH, "route": "cuda",
         "source": "paddlebox_tpu_torch/csrc/sparse_push.cu",
         "replaces": "paddlebox_tpu/ps/device_table.py:189",
         # the dirty mark folded in: the device-prep step's scatter
         "also_replaces": "paddlebox_tpu/trainer/fused_step.py:373",
         **by_path(sparse_push_cuda),
         "max_abs_err": push_err, **push_timing,
         "ptxas": [r for r in ptxas[PUSH] if r["name"].startswith(
             f"sparse_push_kernel<0,0,{push_geometry(D)[1]},")]},
        {"name": OFFSETS, "route": "cuda",
         "source": "paddlebox_tpu_torch/csrc/sparse_push.cu",
         "replaces": "paddlebox_tpu/ps/device_table.py:189",
         **by_path(merge_offsets),
         "max_abs_err": offsets_err, **offsets_timing},
        # device prep launches K5's sort and count pass through the fused
        # entry: its launches are the sort's
        {"name": DEDUP, "route": "cuda",
         "source": "paddlebox_tpu_torch/csrc/device_index.cu",
         "replaces": "paddlebox_tpu/ps/device_index.py:112",
         **by_path(dedup_sort_cuda),
         "max_abs_err": index_err[0], **dedup_timing,
         "ptxas": [r for r in ptxas[INDEX] if ("dedup" in r["name"] or
                   "radix" in r["name"]) and "probe" not in r["name"]]},
        {"name": PROBE, "route": "cuda",
         "source": "paddlebox_tpu_torch/csrc/device_index.cu",
         "replaces": "paddlebox_tpu/ps/device_index.py:133",
         **by_path(device_probe_cuda, mirror_probe_new_keys=train_dev[
             "mirror_probe_launches"]),
         "max_abs_err": index_err[1], **probe_timing,
         "ptxas": [r for r in ptxas[INDEX] if r["name"] == "probe_kernel"]},
        {"name": DEDUP_PROBE, "route": "cuda",
         "source": "paddlebox_tpu_torch/csrc/device_index.cu",
         "replaces": "paddlebox_tpu/trainer/fused_step.py:362",
         **by_path(device_dedup_probe_cuda),
         "max_abs_err": index_err[2], **fused_timing,
         "ptxas": [r for r in ptxas[INDEX]
                   if r["name"] == "dedup_write_probe_kernel"]},
    ]
    # the mesh step's requester merge (phase 4v): launches on its paths;
    # its numbers at (a)'s shape, (b)'s beside them
    mesh_paths = {path: counts.get(segment_merge_cuda.__name__, 0)
                  for path, counts in {**mesh["launches"],
                                       **multihost["launches"]}.items()}
    merge_a, merge_b = mesh["merge"]["training"], mesh["merge"]["four_shards"]
    rows.append({
        "name": MERGE, "route": "cuda",
        "source": "paddlebox_tpu_torch/csrc/sparse_push.cu",
        # the reference's requester segment_sum (an XLA scatter-add), in
        # the device-prep body and in _exchange_push
        "replaces": "paddlebox_tpu/parallel/fused_dp_step.py:321",
        "also_replaces": "paddlebox_tpu/parallel/fused_dp_step.py:645",
        "launches": sum(mesh_paths.values()), "launches_by_path": mesh_paths,
        "counted_by": segment_merge_cuda.__name__, **merge_a,
        "max_abs_err": max(merge_a["max_abs_err"], merge_b["max_abs_err"],
                           mesh["merge"]["training_host_plan"]["max_abs_err"],
                           mesh["merge"]["zipf"]["max_abs_err"],
                           mesh["merge"]["four_shards_zipf"]["max_abs_err"],
                           mesh["merge"]["criteo"]["max_abs_err"],
                           mesh["merge"]["edges_max_abs_err"]),
        "four_shards": merge_b,
        "host_plan": mesh["merge"]["training_host_plan"],
        "zipf": mesh["merge"]["zipf"],
        "four_shards_zipf": mesh["merge"]["four_shards_zipf"],
        "criteo": mesh["merge"]["criteo"]})
    # the push's storage variants: launches on phase 4g's paths, counted
    # by each variant's counter
    for variant, kind in zip(ARENA_ROWS, ("2,0", "1,0", "0,1", "2,1")):
        counter = PUSH_VARIANTS[variant].__name__
        paths = {path: counts.get(counter, 0)
                 for path, counts in {**arenas["launches"],
                                      **tiered_lp["launches"]}.items()}
        cols = push_geometry(arena_timing[variant]["dim"])[1]
        rows.append({
            "name": f"{PUSH}_{variant}", "route": "cuda",
            "source": "paddlebox_tpu_torch/csrc/sparse_push.cu",
            "replaces": "paddlebox_tpu/ps/device_table.py:189",
            "launches": sum(paths.values()), "launches_by_path": paths,
            "counted_by": counter, "max_abs_err": arena_errs[variant],
            **arena_timing[variant],
            "ptxas": [r for r in ptxas[PUSH] if r["name"].startswith(
                f"sparse_push_kernel<{kind},{cols},")]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
