"""Per-section profile of one training step (counterpart of
``paddlebox_tpu/trainer/profiler.py``, the reference's answer to
``TrainFilesWithProfiler``): the step's sections run one at a time, each
timed over ``iters`` calls, so the table shows where a step's time goes.

Sections, in the reference's names: host prepare (``prepare_batch`` on
the host), pull (the arena gather), forward (the seqpool forward kernel
and the model), forward+backward (the seqpool backward kernel too),
backward (their difference), dense update, sparse push (the push kernel,
with its merge order) and AUC update, then the real step's total (the
trainer's entry: ``step_device`` under device prep in "ensure" mode, else
the host-prep ``__call__``). On the card each section is bracketed by
CUDA events on the step's stream, on the CPU by the host clock; host
prepare is always the host clock. Each section is a ``profile.<name>``
span of the trace and an observation of the ``profile.<name>_ms``
histogram.

Sections run alone pay their own launches and lose the step's overlap,
so their sum may exceed the step's total: the table weighs sections
against each other.

The profile leaves training as it found it: the sections run on copies
(the dense params and optimizer state, the arenas the push writes, the
AUC state) or write nothing, and the total's real steps run on copies of
the dense and AUC state over the live arenas, which are restored in place
afterwards (values, state, the device dirty bitmap and the miss ring), so
a captured run graph that baked in their addresses replays the restored
bytes. The sentinel hook is muted meanwhile, so a guard sees none of the
profile's steps. The one residue is the batch's key inserts, which its
first real step would make anyway.
"""

from __future__ import annotations

import copy
import time
from typing import Callable, Dict

import numpy as np
import torch

from paddlebox_tpu_torch.metrics.auc import auc_update
from paddlebox_tpu_torch.obs import trace
from paddlebox_tpu_torch.obs.metrics import REGISTRY
from paddlebox_tpu_torch.trainer.fused_step import FusedTrainStep
from paddlebox_tpu_torch.trainer.train_step import masked_bce_loss


def _timeit(fn: Callable[[], object], device: torch.device, iters: int,
            name: str) -> float:
    """Mean ms a call of ``fn`` over ``iters`` calls after one warm call:
    CUDA events around the calls on the card, the host clock on the CPU.
    One ``profile.<name>`` span, one ``profile.<name>_ms`` observation."""
    fn()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    with trace.span(f"profile.{name}", iters=iters):
        if cuda:
            t0, t1 = torch.cuda.Event(True), torch.cuda.Event(True)
            t0.record()
            for _ in range(iters):
                fn()
            t1.record()
            t1.synchronize()
            ms = t0.elapsed_time(t1) / iters
        else:
            c0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ms = (time.perf_counter() - c0) / iters * 1e3
    REGISTRY.observe(f"profile.{name}_ms", ms)
    return ms


def profile_sections(fstep: FusedTrainStep, params, opt_state, auc_state,
                     keys, segment_ids, cvm_in, labels, dense, row_mask,
                     iters: int = 8) -> Dict[str, float]:
    """Mean ms of each section for one batch (module docstring); leaves
    the training state as it found it."""
    table = fstep.table
    dev = fstep.device
    idx = table.prepare_batch(keys)   # the batch's key inserts, paid here
    t_h0 = time.perf_counter()
    for _ in range(iters):
        idx = table.prepare_batch(keys)
    host_ms = (time.perf_counter() - t_h0) / iters * 1e3

    def on_dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    inverse = on_dev(idx.inverse, np.int32)
    uniq_rows = on_dev(idx.uniq_rows, np.int32)
    uniq_mask = (uniq_rows > 0).float()
    rows = uniq_rows[inverse.long()]
    segs = on_dev(segment_ids, np.int32)
    cvm = on_dev(cvm_in, np.float32)
    labels_t = on_dev(labels, np.float32)
    dense_t = on_dev(dense, np.float32)
    mask = on_dev(row_mask, np.float32)
    p0 = torch.zeros(fstep.batch_size, device=dev)
    l0 = labels_t if labels_t.dim() == 1 else labels_t[:, 0]
    weights = list(params.parameters())

    def pull():
        return table.device_pull(table.values, rows, table.state)

    emb = pull()

    def loss_of(e):
        logits = fstep._forward(params, e, segs, cvm, dense_t,
                                fstep.compute_dtype)
        return masked_bce_loss(logits, labels_t, mask)[0]

    def fwd():
        with torch.no_grad():
            return loss_of(emb)

    def fwd_bwd():
        e = emb.detach().requires_grad_(True)
        return torch.autograd.grad(loss_of(e), weights + [e],
                                   allow_unused=True)

    *dparams, demb = fwd_bwd()
    # the dense update and the push write in place: they run on copies
    p_upd = copy.deepcopy(params)
    o_upd = copy.deepcopy(opt_state)
    for p, g in zip(p_upd.parameters(), dparams):
        p.grad = g
    v_push, s_push = table.values.clone(), table.state.clone()
    a_upd = {k: v.clone() for k, v in auc_state.items()}

    out = {
        "host_prepare_ms": round(host_ms, 4),
        "pull_ms": round(_timeit(pull, dev, iters, "pull"), 4),
        "forward_ms": round(_timeit(fwd, dev, iters, "fwd"), 4),
        "forward_backward_ms": round(_timeit(fwd_bwd, dev, iters,
                                             "fwd_bwd"), 4),
        "dense_update_ms": round(_timeit(
            lambda: fstep.optimizer.update(p_upd, o_upd), dev, iters,
            "dense_upd"), 4),
        "sparse_push_ms": round(_timeit(
            lambda: table.device_push(v_push, s_push, demb, inverse,
                                      uniq_rows, uniq_mask),
            dev, iters, "push"), 4),
        "auc_update_ms": round(_timeit(
            lambda: auc_update(a_upd, p0, l0, mask), dev, iters, "auc"),
            4),
    }
    out["backward_ms"] = round(
        max(out["forward_backward_ms"] - out["forward_ms"], 0.0), 4)
    del p_upd, o_upd, v_push, s_push, a_upd

    # the real step: copies of the dense and AUC state, the live arenas,
    # restored in place afterwards
    saved = [t.clone() for t in _arena_tensors(table)]
    p = copy.deepcopy(params)
    o = copy.deepcopy(opt_state)
    a = {k: v.clone() for k, v in auc_state.items()}
    entry = (fstep.step_device if fstep.device_prep and
             fstep.insert_mode == "ensure" else fstep)
    cb, bad = fstep._sentinel_cb, fstep.bad_flag
    fstep._sentinel_cb = None
    try:
        out["step_total_ms"] = round(_timeit(
            lambda: entry(p, o, a, keys, segment_ids, cvm_in, labels,
                          dense, row_mask), dev, iters, "step_total"), 4)
    finally:
        fstep._sentinel_cb, fstep.bad_flag = cb, bad
        for live, was in zip(_arena_tensors(table), saved):
            live.copy_(was)
    return out


def _arena_tensors(table):
    """What a step writes in the table, in place: the arenas, the device
    dirty bitmap, the miss ring and its count (those the table has)."""
    return [t for t in (table.values, table.state, table.dirty_dev,
                        table.miss_ring, table.miss_cnt) if t is not None]


def format_sections(sections: Dict[str, float]) -> str:
    """One line for the ``log_for_profile`` line."""
    return " ".join(f"{k[:-3]}={v:.3f}ms" for k, v in sections.items())
