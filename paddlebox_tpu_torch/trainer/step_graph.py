"""A device-prep run of ``DEV_CHUNK`` steps as one CUDA graph (counterpart of
the reference's one-dispatch chunk, ``paddlebox_tpu/trainer/fused_step.py``
``_step_dev_chunk``: a ``lax.scan`` of the step body over a run's packed
wire, jitted once as ``_jit_chunk_dev`` and dispatched once a run by
``_train_stream_dev``).

``RunGraph`` captures ``FusedTrainStep.step_device_tensors`` K times over
views of one static device buffer, the run's packed upload (keys [K, Npad]
int64, segment ids [K, Npad] int32, float blocks [K, F]), and keeps each
step's loss and numeric sentinel as static outputs. A run then costs one
host->device copy into that buffer, on the stream that replays, and one
``replay()``: none of the step's ~100 small ops is dispatched from Python,
and nothing is read back to the host.

A staged run (the device feed, ``data/device_feed.py``; its shape is
``("cols", npad)``) captures ``FusedTrainStep.step_cols_tensors`` over the
K rows of a static int32 wire [K, L] (the reference's
``_step_cols_chunk``); its replay copies the staged chunk into that
buffer on the device. Its capture holds the feed's ``gate``, so the
feed's producer thread makes no CUDA call while it lasts. Every capture
holds ``RunGraphs.capture_lock``, under which the train guard's poller
(``trainer/guard.py``) makes its CUDA calls.

A capture bakes in device addresses: the arenas, the table's dirty bitmap,
the mirror table (and its mask, an argument of the dedup-and-probe
launch), the miss ring and its count (each step appends its misses), the
dense params, the optimizer state and the AUC state. ``run_key`` lists them beside the run
shape. ``RunGraphs`` keeps one graph a run shape, all in one memory pool,
and drops a graph whose addresses differ from the current ones, so that
the run is captured anew: ``DeviceTable._grow_to`` (the arenas and the
bitmap), ``DeviceIndexMirror.sync`` at a new capacity, ``load_arena`` and
``load`` put new tensors in place. Everything a step changes it changes in
place (adam's count is a device tensor, ``_drain_auc`` zeroes the AUC
state in place, a save's ``_clear_dirty`` zeroes the bitmap in place), so
a replay advances the same state an eager run would.

A shape's first full run goes eagerly and is the warm-up (the kernels'
libraries load, cuBLAS picks its kernels); capture executes nothing, so no
step runs twice. Capture is in torch's global mode, in which no other
thread may call CUDA: the file reader's prefetch thread parses on the host
only, and the staged feed's producer waits on the feed's gate. Graphs share their pool on the understanding that they
run one at a time on one stream and that a replay's outputs are cloned
before the next replay: a later graph may place its scratch where an
earlier one keeps its outputs.

The wrappers count launches in Python (``<wrapper>.launches``), which a
replay does not run. ``LaunchDelta`` takes back what the capture added
(nothing ran then) and adds it again at each replay, so the counts still
count kernel launches that ran on the card.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, Iterable, Iterator, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch.ops.device_index_kernel import (
    dedup_sort_cuda, device_dedup_cuda, device_dedup_probe_cuda,
    device_probe_cuda)
from paddlebox_tpu_torch.ops.seqpool_kernel import (seqpool_cvm_cuda,
                                                    seqpool_cvm_grad_cuda)
from paddlebox_tpu_torch.ops.sparse_push import (PUSH_VARIANTS, merge_offsets,
                                                 segment_merge_cuda,
                                                 sparse_push_cuda)

# every wrapper that counts its launches
COUNTED_WRAPPERS = (seqpool_cvm_cuda, seqpool_cvm_grad_cuda,
                    sparse_push_cuda, merge_offsets, dedup_sort_cuda,
                    device_dedup_cuda, device_dedup_probe_cuda,
                    device_probe_cuda, segment_merge_cuda)
# and beside them the push's counts by variant
COUNTERS = COUNTED_WRAPPERS + tuple(PUSH_VARIANTS.values())


class LaunchDelta:
    """What one capture added to each wrapper's ``launches``: taken back
    when the capture ends, added again by ``replayed``."""

    def __init__(self, wrappers: Iterable = COUNTERS):
        self.wrappers = tuple(wrappers)
        self.delta = (0,) * len(self.wrappers)

    @contextlib.contextmanager
    def capture(self) -> Iterator["LaunchDelta"]:
        before = [w.launches for w in self.wrappers]
        try:
            yield self
        finally:
            self.delta = tuple(w.launches - b
                               for w, b in zip(self.wrappers, before))
            for w, d in zip(self.wrappers, self.delta):
                w.launches -= d

    def replayed(self) -> None:
        for w, d in zip(self.wrappers, self.delta):
            w.launches += d

    def by_name(self) -> Dict[str, int]:
        return {w.__name__: d for w, d in zip(self.wrappers, self.delta)}


def state_tensors(state: Any) -> Iterator[torch.Tensor]:
    """The tensors of an optimizer or AUC state, in key order (a nested
    state, such as gradient merging's inner one, in its own)."""
    for k in sorted(state):
        v = state[k]
        if isinstance(v, torch.Tensor):
            yield v
        elif isinstance(v, dict):
            yield from state_tensors(v)
        else:
            yield from v


def run_key(fs, params, opt_state, auc_state, shape) -> tuple:
    """Everything a capture of a run over ``fs`` bakes in: the run shape,
    then the address and shape of the arenas, the mirror table, the dirty
    bitmap, the miss ring and its count, the dense params and the
    optimizer and AUC state, and the mirror's mask and window."""
    t, m = fs.table, fs.table.mirror

    def at(tensors):
        return tuple((x.data_ptr(), tuple(x.shape)) for x in tensors)

    return (shape, at((t.values, t.state, m.tab, t.dirty_dev, t.miss_ring,
                       t.miss_cnt)), m.mask,
            m.window, at(params.parameters()),
            at(state_tensors(opt_state)), at(state_tensors(auc_state)))


class RunGraph:
    """One run of K device-prep steps at one shape, captured at
    construction. ``shape`` is ``(layout, labels_t)``: the packed upload's
    layout (``FusedTrainStep._pack``) and the label count a row; the
    upload is ``nbytes`` long."""

    def __init__(self, owner: "RunGraphs", params, opt_state, auc_state,
                 shape, key, nbytes: int):
        fs = owner.fs
        self.owner = owner
        self.key = key
        if shape[0] == "cols":
            npad = shape[1]
            self.buf = torch.empty((fs.DEV_CHUNK, fs.wire_len(npad)),
                                   dtype=torch.int32, device=fs.device)

            def step(j, params, opt_state, auc_state):
                return fs.step_cols_tensors(params, opt_state, auc_state,
                                            self.buf[j], npad)
        else:
            layout, labels_t = shape
            self.buf = torch.empty(nbytes, dtype=torch.uint8,
                                   device=fs.device)
            keys, segs, pf = fs._views(self.buf, layout)

            def step(j, params, opt_state, auc_state):
                return fs.step_device_tensors(
                    params, opt_state, auc_state, keys[j], segs[j],
                    *fs._split_floats(pf[j], labels_t))

        def body():
            nonlocal params, opt_state, auc_state
            losses, bads = [], []
            for j in range(fs.DEV_CHUNK):
                params, opt_state, auc_state, loss, _ = step(
                    j, params, opt_state, auc_state)
                losses.append(loss)
                bads.append(fs.bad_flag)
            return torch.stack(losses), torch.stack(bads)

        self.launches = LaunchDelta()
        t0 = time.perf_counter()
        with self.launches.capture():
            self.out = self._capture(body)
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def _capture(self, body):
        """Capture ``body`` (which executes nothing then) into a CUDA
        graph; returns its outputs, which each replay refills."""
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=self.owner.pool()):
            return body()

    def _launch(self) -> None:
        self.graph.replay()

    def replay(self, src) -> Tuple[torch.Tensor, torch.Tensor]:
        """The run over ``src``: a packed upload of the graph's layout (a
        host array, copied synchronously) or a staged wire chunk (a
        device tensor, copied on the device, in stream order); then one
        replay. Returns the K losses and the K numeric sentinels, cloned
        out of the static outputs."""
        self.buf.copy_(torch.from_numpy(src) if isinstance(src, np.ndarray)
                       else src)
        self._launch()
        self.launches.replayed()
        losses, bads = self.out
        return losses.clone(), bads.clone()

    def reset(self) -> None:
        graph = getattr(self, "graph", None)
        if graph is not None:
            graph.reset()
        self.out = None


class RunGraphs:
    """The run graphs of one ``FusedTrainStep``: one a run shape, sharing
    one memory pool (a fresh one once every graph has been dropped).
    ``warm`` holds the shapes whose first full run has gone
    eagerly; ``captures`` and ``replays`` count since construction.
    ``capture_lock`` is held across each capture: another thread that
    calls CUDA while the step runs takes it."""

    def __init__(self, fs):
        self.fs = fs
        self.graphs: Dict[Any, RunGraph] = {}
        self.warm = set()
        self.captures = 0
        self.replays = 0
        self.capture_ms = []
        self._pool = None
        self.capture_lock = threading.Lock()

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def replay(self, params, opt_state, auc_state, host, shape, gate=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The run over ``host`` (``RunGraph.replay``'s ``src``) through its
        shape's graph, captured first when it is missing or baked in other
        addresses, holding ``gate`` (a lock) across the capture. A capture
        that fails raises."""
        key = run_key(self.fs, params, opt_state, auc_state, shape)
        for s in [s for s, g in self.graphs.items() if g.key[1:] != key[1:]]:
            self.graphs.pop(s).reset()
        if not self.graphs:
            # a pool that no live graph uses takes no new capture while
            # tensors from its last one (the grads) still hold its blocks
            self._pool = None
        graph = self.graphs.get(shape)
        if graph is None:
            with self.capture_lock, (gate if gate is not None
                                     else contextlib.nullcontext()):
                graph = RunGraph(self, params, opt_state, auc_state, shape,
                                 key, host.nbytes)
            self.graphs[shape] = graph
            self.captures += 1
            self.capture_ms.append(graph.capture_ms)
        out = graph.replay(host)
        self.replays += 1
        return out
