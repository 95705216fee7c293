"""The staged device feed: a bounded ring of pinned host rows, uploaded
ahead of the step on a copy stream (counterpart of
``paddlebox_tpu/data/device_feed.py``, itself the reference system's
``MiniBatchGpuPack`` double buffer).

    reader (C++ tokenizer, GIL released)
      -> ColumnarSlice views        data/fast_feed.py stream_columnar: no
                                    padding, no segment expansion
      -> staging ring row           one C pass (pack_cols_row) into a
                                    pinned, reused host row
      -> H2D on the copy stream     the producer thread: non-blocking,
                                    into the slot's own device buffer,
                                    an event recorded after it
      -> the step                   FusedTrainStep._train_stream_staged:
                                    the replay stream waits on the event,
                                    copies the run into its graph's static
                                    buffer and replays; segment ids, row
                                    mask and cvm input are rebuilt on the
                                    device (step_cols_tensors)

The wire is the reference's, word for word (``wire_len``): a batch's row
is ``khi | klo [2 * npad] + lengths [B * S] + labels [B] + dense [B * Dd]
+ nrows``, 32-bit words, so a row packed by either package decodes in
both. The port holds it as int32 and reads labels and dense through
``.view(torch.float32)``.

``StagingRing`` hands out at most ``buffers`` slots in all, each a pinned
host block [DEV_CHUNK, L] with a device block of the same shape beside it,
allocated at first use; with every slot out, the producer blocks until
the consumer retires a run. A slot goes back to the ring only after an
event recorded after its run has completed (``DeviceFeed.retire``), so
neither its host row nor its device buffer is overwritten while a copy
or a step still reads it. On the CPU (tests ask for it) a slot is plain
memory and the upload a copy.

A CUDA graph captures in torch's global mode, in which no other thread
may call CUDA. The producer makes every CUDA call of its own (pinned and
device allocations, the copy, the event) under ``DeviceFeed.gate``, and
``RunGraphs`` holds that lock across a capture: the producer's upload
waits for the capture to end (``gate_waits`` counts how often).

Failures ride ``data/channel.py``'s ``Channel``: a dying producer poisons
it, and the consumer re-raises the original error after the chunks
already staged. ``stop()`` wakes a producer blocked on the ring or the
channel, joins it, and returns every slot still queued, with the
shared-memory leases pinned to it (defer-recycle mode).

Metrics, in the global registry as the reference names them:
``feed.h2d_ms`` (issuing a run's upload), ``feed.pack_ms`` (one batch's
pack), ``feed.ring_wait_ms`` (the producer waiting for a slot, over
0.05 ms), the ``feed.buffers_in_flight`` gauge, and from the consumer
``feed.stage_wait_ms`` and the ``feed.host_ms`` counter
(``trainer/fused_step.py``). The port adds ``feed.h2d_device_ms``: a
run's copy on the card, between two events on the copy stream. Trace
spans ``feed.pack`` and ``feed.h2d``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch.config import feed_prefetch_conf
from paddlebox_tpu_torch.data.channel import Channel
from paddlebox_tpu_torch.data.fast_feed import ColumnarSlice
from paddlebox_tpu_torch.obs import trace
from paddlebox_tpu_torch.obs.metrics import REGISTRY
from paddlebox_tpu_torch.ps import native
from paddlebox_tpu_torch.ps.native import wire_len, wire_offsets


class FeedStopped(RuntimeError):
    """The feed was stopped (the consumer left) while the producer
    waited."""


@dataclasses.dataclass
class _Slot:
    host: torch.Tensor    # [K, L] int32, pinned on a card (reused)
    wire: np.ndarray      # [K, L] uint32 view of ``host``: the pack target
    keys: np.ndarray      # [K * npad] uint64 sidecar for ensure_keys
    dev: torch.Tensor     # [K, L] int32 on the feed's device
    # events on the copy stream around the upload (None on the CPU)
    start: Optional[torch.cuda.Event] = None
    done: Optional[torch.cuda.Event] = None
    #: shared-memory leases pinned to this slot (defer-recycle mode),
    #: released with it, once the run that read it has retired
    holds: list = dataclasses.field(default_factory=list)


class StagingRing:
    """Bounded pool of reused slots: ``acquire(shape, keys_len)`` hands out
    a slot of ``shape`` (DEV_CHUNK, L), allocating up to ``buffers`` in
    all; at the cap it takes a free slot of another shape (a bucket
    switch) or blocks until ``release``. ``device`` is where the slots'
    device blocks live; on a card the host blocks are pinned, every
    allocation runs under ``gate``, and the device blocks come from
    ``stream``'s pool (the copy stream that writes them): a block from
    another stream's pool may still be in use by work queued there, which
    the copy stream does not wait for."""

    def __init__(self, buffers: int, device: torch.device = None,
                 gate: Optional[threading.Lock] = None,
                 stream: Optional[torch.cuda.Stream] = None):
        if buffers < 2:
            raise ValueError(f"staging ring needs >= 2 buffers, "
                             f"got {buffers}")
        self.buffers = buffers
        self.device = torch.device("cpu") if device is None else device
        self.gate = gate or threading.Lock()
        self.stream = stream
        self._cv = threading.Condition()
        self._free: dict = {}          # shape -> [_Slot]  guarded-by: _cv
        self._allocated = 0            # guarded-by: _cv
        self._held = 0                 # guarded-by: _cv
        self._closed = False           # guarded-by: _cv
        #: free slots dropped at the cap for a slot of another shape
        self.reshaped = 0              # guarded-by: _cv

    @property
    def held(self) -> int:
        """Slots handed out and not yet released."""
        with self._cv:
            return self._held

    def _new_slot(self, shape: Tuple[int, int], keys_len: int) -> _Slot:
        cuda = self.device.type == "cuda"
        with self.gate:
            # pin_memory raises where it cannot pin: a card never stages
            # through pageable memory
            host = torch.zeros(shape, dtype=torch.int32, pin_memory=cuda)
            with (torch.cuda.stream(self.stream) if self.stream is not None
                  else contextlib.nullcontext()):
                dev = torch.empty(shape, dtype=torch.int32,
                                  device=self.device)
            start = done = None
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                done = torch.cuda.Event(enable_timing=True)
        return _Slot(host=host, wire=host.numpy().view(np.uint32),
                     keys=np.zeros(keys_len, np.uint64), dev=dev,
                     start=start, done=done)

    def acquire(self, shape: Tuple[int, int], keys_len: int) -> _Slot:
        t0 = time.perf_counter()
        with self._cv:
            while True:
                if self._closed:
                    raise FeedStopped("staging ring closed")
                free = self._free.get(shape)
                if free:
                    slot = free.pop()
                    break
                if self._allocated < self.buffers:
                    slot = self._new_slot(shape, keys_len)
                    self._allocated += 1
                    break
                # at the cap with no free slot of this shape: drop a free
                # slot of another shape (a bucket switch) for a new one,
                # or every slot could keep the wrong shape forever
                other = next((s for s in self._free if s != shape
                              and self._free[s]), None)
                if other is not None:
                    with self.gate:
                        # the dropped slot's pinned and device blocks go
                        # back to their caches here, under the gate, as
                        # every other CUDA call of the producer does
                        self._free[other].pop()
                    self.reshaped += 1
                    slot = self._new_slot(shape, keys_len)
                    break
                # every slot is staged or in a run: wait for a retire
                self._cv.wait(timeout=0.2)
            self._held += 1
            REGISTRY.gauge("feed.buffers_in_flight").set(self._held)
        waited = (time.perf_counter() - t0) * 1e3
        if waited > 0.05:
            REGISTRY.observe("feed.ring_wait_ms", waited)
        return slot

    def release(self, slot: _Slot) -> None:
        # the pinned leases first, outside the ring's lock: a release
        # writes the worker's free channel (a pipe)
        if slot.holds:
            holds, slot.holds = slot.holds, []
            for h in holds:
                try:
                    h.release()
                except Exception:  # noqa: BLE001 - a dead worker's
                    pass           # free channel is already gone
        with self._cv:
            self._free.setdefault(tuple(slot.host.shape), []).append(slot)
            self._held -= 1
            REGISTRY.gauge("feed.buffers_in_flight").set(self._held)
            self._cv.notify_all()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def reopen(self) -> None:
        """Re-arm after ``close()``: the next ``start`` reuses the slots."""
        with self._cv:
            self._closed = False


@dataclasses.dataclass
class StagedChunk:
    """``k`` batches staged on the device: what the consumer runs."""

    dev: torch.Tensor   # [k, L] int32 on the device, its upload issued
    slot: _Slot         # returned by the consumer once its run retired
    npad: int
    k: int              # batches in the chunk (rows of ``dev``)

    @property
    def event(self) -> Optional[torch.cuda.Event]:
        """Recorded on the copy stream after the upload (None on the
        CPU): the consumer's stream waits on it before reading ``dev``."""
        return self.slot.done

    @property
    def keys(self) -> np.ndarray:
        """The chunk's keys, each batch's zero-padded to ``npad``, for
        ``ensure_keys``: a view of the slot's sidecar, valid until the
        slot is released."""
        return self.slot.keys[:self.k * self.npad]


@dataclasses.dataclass
class TailBatches:
    """A short run (a bucket switch, the stream's end) decoded back into
    the per-batch host tuples, which go through ``step_device`` as the
    unstaged stream's short runs do (a masked last batch included)."""

    batches: List[tuple]


def pack_cols_row(sl: ColumnarSlice, batch: int, n_slots: int,
                  dense_dim: int, out_row: np.ndarray) -> None:
    """Pack one columnar slice into its wire row (``out_row``, uint32):
    one C pass (``ps/native.py`` ``pack_cols``, in the tokenizer's library,
    which the reader that made ``sl`` already needs). The tails are
    zeroed: ring rows are reused, and a stale key past ``num_keys`` would
    alias a real one."""
    native.pack_cols(sl.keys, sl.lengths, sl.labels, sl.dense, batch,
                     n_slots, dense_dim, sl.npad, out_row)


def pack_cols_row_numpy(sl: ColumnarSlice, batch: int, n_slots: int,
                        dense_dim: int, out_row: np.ndarray) -> None:
    """``pack_cols_row``'s numpy twin, the same words: what the C pass is
    held to."""
    npad = sl.npad
    nk = sl.num_keys
    n = sl.num_rows
    o_len, o_lab, o_den, o_n = wire_offsets(npad, batch, n_slots, dense_dim)
    hi = out_row[:npad]
    lo = out_row[npad:o_len]
    hi[:nk] = sl.keys >> np.uint64(32)        # unsafe-cast assign: masked
    lo[:nk] = sl.keys & np.uint64(0xFFFFFFFF)
    hi[nk:] = 0
    lo[nk:] = 0
    lrow = out_row[o_len:o_lab]
    lrow[:n * n_slots] = sl.lengths.reshape(-1)
    lrow[n * n_slots:] = 0
    lab = out_row[o_lab:o_den].view(np.float32)
    lab[:n] = sl.labels
    lab[n:] = 0.0
    den = out_row[o_den:o_n].view(np.float32)
    den[:n * dense_dim] = sl.dense.reshape(-1)
    den[n * dense_dim:] = 0.0
    out_row[o_n] = n


def unpack_cols_row(row: np.ndarray, npad: int, batch: int, n_slots: int,
                    dense_dim: int) -> tuple:
    """A wire row back to the step's per-batch host tuple ``(keys,
    segment_ids, cvm_in, labels, dense, row_mask)``, the unstaged stream's
    arrays bit for bit: for runs too short for a chunk, and for tests."""
    BS = batch * n_slots
    o_len, o_lab, o_den, o_n = wire_offsets(npad, batch, n_slots, dense_dim)
    khi = row[:npad].astype(np.uint64)
    klo = row[npad:o_len].astype(np.uint64)
    keys = (khi << np.uint64(32)) | klo
    lengths = row[o_len:o_lab].astype(np.int32)
    labels = row[o_lab:o_den].view(np.float32).copy()
    dense = row[o_den:o_n].view(np.float32).copy().reshape(batch, dense_dim)
    n = int(row[o_n])
    segs = np.full(npad, BS, dtype=np.int32)
    total = int(lengths.sum())
    segs[:total] = np.repeat(np.arange(BS, dtype=np.int32), lengths)
    mask = np.zeros(batch, dtype=np.float32)
    mask[:n] = 1.0
    cvm = np.stack([np.ones(batch, np.float32), labels], axis=1)
    return keys, segs, cvm, labels, dense, mask


class DeviceFeed:
    """The producer half of the staged feed: a thread turns
    ``ColumnarSlice`` views into staged chunks while the training thread
    runs steps (the consumer is ``FusedTrainStep._train_stream_staged``).

    ``depth`` bounds the chunks queued ahead (2 is the classic double
    buffer), ``buffers`` the ring's slots in all. The consumer holds up to
    ``min(2, buffers - 1)`` slots as its dispatch window, so one slot
    always serves the producer; the default ``depth + 3`` is where the
    full ``depth`` of staged chunks materializes (``depth + 1`` is the
    deadlock-free minimum). Unset, both come from the
    ``feed_device_prefetch`` and ``feed_staging_buffers`` flags
    (``config.feed_prefetch_conf``). ``device`` defaults to the step's:
    a feed for a step on a card uploads to that card, never through the
    CPU."""

    def __init__(self, step, depth: Optional[int] = None,
                 buffers: Optional[int] = None, device=None):
        f_depth, f_buffers = feed_prefetch_conf()
        self.depth = f_depth if depth is None else int(depth)
        if buffers is not None:
            self.buffers = int(buffers)
        elif depth is None:
            self.buffers = f_buffers
        else:
            # an explicit depth: the default ring follows it, not the flag
            self.buffers = self.depth + 3
        if self.depth < 1:
            raise ValueError(
                f"DeviceFeed needs depth >= 1, got {self.depth} "
                "(depth 0 is the unstaged path: build no feed for it)")
        if self.buffers < self.depth + 1:
            raise ValueError(
                f"feed_staging_buffers ({self.buffers}) must be >= "
                f"depth + 1 ({self.depth + 1}): one slot packs while "
                "`depth` are staged")
        if not getattr(step, "device_prep", False):
            raise ValueError(
                "the device feed stages the columnar wire, which only the "
                "device-prep fused engine consumes (dedup and probe on the "
                "device); this engine runs host-side prep")
        self.step = step
        self.device = torch.device(device if device is not None
                                   else step.device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        #: held around every CUDA call of the producer, and by the
        #: consumer across a graph capture
        self.gate = threading.Lock()
        self.gate_waits = 0
        #: the consumer's note at each graph capture it made: chunks
        #: staged in the channel then, and whether the producer was alive
        self.captures: List[dict] = []
        #: shared-memory leases pinned to a slot (defer-recycle mode)
        self.pins = 0
        self.copy_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)
        self.ring = StagingRing(self.buffers, self.device, self.gate,
                                self.copy_stream)
        self.chunk = step.DEV_CHUNK
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._ch: Optional[Channel] = None

    # -- producer ------------------------------------------------------------

    def start(self, col_iter: Iterator[ColumnarSlice]) -> Channel:
        """Start the producer over ``col_iter``; returns the bounded
        channel of ``StagedChunk`` and ``TailBatches`` the consumer
        drains. One producer at a time."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("DeviceFeed.start while a producer is "
                               "still running (call stop() first)")
        self._stop = False
        ch: Channel = Channel(capacity=self.depth)
        th = threading.Thread(target=self._produce, args=(col_iter, ch),
                              name="device-feed", daemon=True)
        self._ch = ch
        self._thread = th
        th.start()
        return ch

    @property
    def producing(self) -> bool:
        """Whether the producer thread is alive."""
        th = self._thread
        return th is not None and th.is_alive()

    def staged(self) -> int:
        """Chunks queued in the channel, not yet taken by the consumer."""
        ch = self._ch
        return 0 if ch is None else len(ch)

    def stop(self) -> None:
        """The consumer's teardown: wake the producer (blocked on a full
        channel's put or an exhausted ring's acquire), join it, and
        return every slot still queued, with its pinned leases."""
        self._stop = True
        self.ring.close()
        if self._ch is not None:
            self._ch.close()   # a put on a closed channel raises
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if self.copy_stream is not None:
            # an upload still in flight reads a slot about to be free
            self.copy_stream.synchronize()
        if self._ch is not None:
            try:
                while True:
                    block = self._ch.get_many(64)
                    if not block:
                        break
                    for item in block:
                        if isinstance(item, StagedChunk):
                            self.ring.release(item.slot)
            except BaseException:  # noqa: BLE001 - a poisoned channel
                pass               # raises once its prefix is popped
        self._ch = None
        self.ring.reopen()

    def retire(self, item: StagedChunk) -> None:
        """Return a consumed chunk's slot to the ring: call once the run
        that read it has completed. On a card, observes the upload's
        device time in ``feed.h2d_device_ms``."""
        s = item.slot
        try:
            if s.start is not None and s.done.query():
                REGISTRY.observe("feed.h2d_device_ms",
                                 s.start.elapsed_time(s.done))
        finally:
            self.ring.release(s)

    def _put(self, ch: Channel, item) -> None:
        """A bounded put that ends the producer cleanly when the consumer
        has stopped the feed (the channel closed under it)."""
        try:
            ch.put(item)
        except RuntimeError:
            if self._stop:
                raise FeedStopped("consumer stopped the feed")
            raise

    def _upload(self, s: _Slot) -> None:
        """Issue the slot's host-to-device copy: on a card non-blocking on
        the copy stream between the slot's two events, under the gate."""
        if self.copy_stream is None:
            s.dev.copy_(s.host)
            return
        if not self.gate.acquire(blocking=False):
            self.gate_waits += 1
            self.gate.acquire()
        try:
            with torch.cuda.stream(self.copy_stream):
                s.start.record(self.copy_stream)
                s.dev.copy_(s.host, non_blocking=True)
                s.done.record(self.copy_stream)
        finally:
            self.gate.release()

    def _produce(self, col_iter: Iterator[ColumnarSlice],
                 ch: Channel) -> None:
        step = self.step
        B, S, Dd = step.batch_size, step.num_slots, step.dense_dim
        K = self.chunk
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        try:
            with ch.producing():
                slot: Optional[_Slot] = None
                npad = 0
                i = 0

                def flush(full: bool):
                    nonlocal slot, i
                    if slot is None or i == 0:
                        return
                    # the slot changes hands before anything that can
                    # fail: released here while this frame owns it, by
                    # the consumer's retire once delivered
                    s, n = slot, i
                    slot, i = None, 0
                    try:
                        if full:
                            t0 = time.perf_counter()
                            with trace.span("feed.h2d", rows=n):
                                self._upload(s)
                            REGISTRY.observe(
                                "feed.h2d_ms",
                                (time.perf_counter() - t0) * 1e3)
                            self._put(ch, StagedChunk(dev=s.dev, slot=s,
                                                      npad=npad, k=n))
                            s = None   # delivered: the consumer owns it
                        else:
                            L = wire_len(npad, B, S, Dd)
                            tb = TailBatches([
                                unpack_cols_row(s.wire[j, :L], npad, B,
                                                S, Dd)
                                for j in range(n)])
                            self.ring.release(s)
                            s = None
                            self._put(ch, tb)
                    except BaseException:
                        if s is not None:
                            self.ring.release(s)
                        raise

                try:
                    for sl in col_iter:
                        if self._stop:
                            raise FeedStopped("consumer stopped the feed")
                        if slot is not None and sl.npad != npad:
                            flush(full=False)
                        if slot is None:
                            npad = sl.npad
                            L = wire_len(npad, B, S, Dd)
                            slot = self.ring.acquire((K, L), K * npad)
                        t0 = time.perf_counter()
                        with trace.span("feed.pack"):
                            pack_cols_row(sl, B, S, Dd, slot.wire[i])
                            ko = i * npad
                            slot.keys[ko:ko + sl.num_keys] = sl.keys
                            slot.keys[ko + sl.num_keys:ko + npad] = 0
                        # defer-recycle mode: the slice's shared-memory
                        # lease stays pinned to this slot until its run
                        # retires; pin() is False (no release owed)
                        # outside that mode
                        own = getattr(sl, "owner", None)
                        if own is not None and own.pin():
                            slot.holds.append(own)
                            self.pins += 1
                        REGISTRY.observe("feed.pack_ms",
                                         (time.perf_counter() - t0) * 1e3)
                        i += 1
                        if i == K:
                            flush(full=True)
                    flush(full=False)
                except BaseException:
                    # an abort with a slot in hand returns it, and its
                    # pinned leases
                    if slot is not None:
                        self.ring.release(slot)
                        slot = None
                    raise
        except FeedStopped:
            # the consumer stopped the feed: nothing to report, and the
            # channel is closed already
            pass
        except Exception:  # noqa: BLE001
            # producing() poisoned the channel with the original error,
            # which the consumer re-raises
            pass

    def __enter__(self) -> "DeviceFeed":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
