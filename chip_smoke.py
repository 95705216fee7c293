#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``paddlebox_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed 0]

Phases, each fatal on failure:

1. build   — compile the port's native sources from the repository, one
             process each, all at once: with ``nvcc`` the seqpool+CVM
             forward, its backward (the gather), the push (with its
             boundary kernel) and the in-step key dedup and mirror probe
             (``csrc/device_index.cu``); with ``g++`` the host key index
             (``csrc/pbx_index.cpp``). Print each kernel's ptxas report
             (registers, spills, shared memory).
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
             rest within 1e-6, and two launches bit-identical. The boundary
             kernel's offsets (and the sorted order) equal
             ``merge_order_plain``'s.
             Dedup (K5) and probe (K6), bit-exact, and against
             ``np.unique`` and the host index: the training batch over the
             4,194,304-key mirror (2^24 + 64 slots, 268 MB), keys at or
             above 2^63 beside small ones, all padding, one key N times,
             ragged tails, keys absent from the mirror, a cluster whose run
             reaches slot 63 of its window and a run that ends in the guard.
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
             (``FusedTrainStep.step_device``, "ensure" mode): the dedup,
             probe, forward, backward and push launch once a step and the
             boundary kernel never. Losses finite, the sentinel untripped;
             the first 2 steps match the CPU (host prep), and the host-prep
             step on the card and the device-prep step on the CPU (device
             prep).
   Time per step and examples/s of device prep, of host prep over each
   index, host time by phase and a device profile; ``ensure_keys`` and
   ``prepare_batch`` on batches with 5% new keys.
5. timing  — forward at the serving, the multi-key and the training
             shape; backward, push, boundary kernel, dedup and probe at the
             training shape: kernel, plain and library times, per call and
             in a CUDA graph, beside each kernel's bound; the push kernel
             alone beside the push with its merge order, adam beside
             adagrad; the dedup's passes beside its sort; and the launch
             floor, the graph time of ``torch.cuda._sleep(0)``.

Prints the card's ``name, power.limit`` line, then one JSON line of
per-kernel numbers, then ``{"ok": true, "device": {...}}`` last. Exits
nonzero, printing no result, without CUDA.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np
import torch

from paddlebox_tpu_torch.config import (BucketSpec, TableConfig,
                                        TrainerConfig, batch_bucket_spec)
from paddlebox_tpu_torch.data.criteo import (CriteoReader, criteo_feed_config,
                                             make_synthetic_criteo)
from paddlebox_tpu_torch.inference.predictor import (CTRPredictor,
                                                     save_inference_model)
from paddlebox_tpu_torch.models.convert import deepfm_from_flax_leaves
from paddlebox_tpu_torch.ops import _build
from paddlebox_tpu_torch.ops.seqpool_kernel import (bulk_loads, grad_lanes,
                                                    seqpool_cvm_cuda,
                                                    seqpool_cvm_grad_cuda,
                                                    seqpool_cvm_grad_plain,
                                                    seqpool_cvm_plain)
from paddlebox_tpu_torch.ops.sparse_push import (merge_offsets,
                                                 merge_offsets_plain,
                                                 merge_order,
                                                 merge_order_plain,
                                                 push_geometry, push_rows,
                                                 sparse_push_cuda,
                                                 sparse_push_plain)
from paddlebox_tpu_torch.ops.device_index_kernel import (SIGN,
                                                         device_dedup_cuda,
                                                         device_probe_cuda)
from paddlebox_tpu_torch.ps.device_index import (DeviceIndexMirror,
                                                 device_dedup_plain,
                                                 device_hash,
                                                 device_probe_plain,
                                                 host_hash, key_halves)
from paddlebox_tpu_torch.ps.device_table import DeviceTable
from paddlebox_tpu_torch.ps.native import NativeIndex
from paddlebox_tpu_torch.ps.table import state_dim
from paddlebox_tpu_torch.trainer.fused_step import FusedTrainStep

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
KERNEL = "seqpool_cvm"
GRAD = "seqpool_cvm_grad"
PUSH = "sparse_push"
OFFSETS = "merge_offsets"
DEDUP = "device_dedup"
PROBE = "device_probe"
INDEX = "device_index"      # csrc/device_index.cu: K5 and K6
HOST_INDEX = "pbx_index"    # csrc/pbx_index.cpp: the host key index (g++)


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


def device_profile(tag: str, fn, kernels=(KERNEL,)) -> None:
    """Print the device's busy share over one call of ``fn``, its five
    largest device activities and those of ``kernels``, from a
    torch.profiler trace."""
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
        return
    print(f"profile {tag}: wall {wall_us:.0f} us, device busy {busy:.0f} us "
          f"({100 * busy / wall_us:.1f}%; overlapping activities counted "
          "twice)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    for name, us in top[:8] + [kv for kv in top[8:]
                               if any(k in kv[0] for k in kernels)]:
        print(f"  {us:10.1f} us  {name[:90]}")


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
    """One nvcc process per source, all started together. Returns each
    source's ptxas report (empty for a library built by an earlier run)."""
    names = (KERNEL, GRAD, PUSH, INDEX, HOST_INDEX)
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
    """Push kernel vs plain on one batch; a second launch on the same
    inputs must give the same bits. Returns the largest error off
    show/clk and the card inputs."""
    demb, inv, urows, umask = (torch.from_numpy(np.ascontiguousarray(x))
                               .cuda() for x in inputs)
    layout = table.layout
    got, again, want = [(table.values.clone(), table.state.clone())
                        for _ in range(3)]
    sparse_push_cuda(layout, *got, demb, inv, urows, umask)
    sparse_push_cuda(layout, *again, demb, inv, urows, umask)
    torch.cuda.synchronize()
    sparse_push_plain(layout, *want, demb, inv, urows, umask)
    (gv, gs), (wv, ws) = got, want
    require(torch.equal(gv, again[0]) and torch.equal(gs, again[1]),
            f"{name}: two launches on the same inputs differ")
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
          f"rows trained={changed} max_abs_err={err:.3e} deterministic ok")
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


def check_dedup(name: str, keys: np.ndarray):
    """K5 vs its plain version on the card, every output exactly, and both
    against ``np.unique`` of the uint64 keys. Returns the kernel's
    result."""
    kt = torch.from_numpy(np.ascontiguousarray(keys, np.uint64).view(
        np.int64)).cuda()
    got = device_dedup_cuda(kt)
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
    uniq, inverse = np.unique(keys, return_inverse=True)
    nu = int(got.n_uniq)
    require(nu == uniq.size, f"{DEDUP} {name}: n_uniq {nu} != {uniq.size}")
    host_uniq = got.uniq_keys.cpu().numpy().view(np.uint64)
    require(np.array_equal(host_uniq[:nu], uniq) and not host_uniq[nu:].any(),
            f"{DEDUP} {name}: uniques differ from np.unique's")
    require(np.array_equal(got.inverse.cpu().numpy(), inverse),
            f"{DEDUP} {name}: inverse differs from np.unique's")
    require(torch.equal(got.offsets, merge_offsets_plain(got.inverse,
                                                         keys.size)),
            f"{DEDUP} {name}: offsets are not the uniques' boundaries")
    print(f"kernel check {DEDUP} {name}: N={keys.size} n_uniq={nu} "
          "bit-exact ok")
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


def colliding_keys(mask: int, home: int, n: int, rng) -> np.ndarray:
    """``n`` distinct non-zero keys whose ``Map64::hash & mask`` is
    ``home``."""
    out = []
    while len(out) < n:
        cand = rng.integers(1, np.iinfo(np.uint64).max, size=1 << 20,
                            dtype=np.uint64)
        out += list(cand[(host_hash(cand) & np.uint32(mask)) == home])
    return np.unique(np.array(out[:n], dtype=np.uint64))


def phase_kernel_index(rng, train_keys: np.ndarray):
    """K5 and K6 vs their plain versions at the training shape over the
    4,194,304-key mirror and at edge cases. Returns the largest error (0:
    bit-exact) of each and the training batch's dedup and mirror for
    timing."""
    index = NativeIndex()  # as DeviceTable.prepopulate(HOT_VOCAB) builds it
    index.rebuild(np.concatenate([
        np.array([np.iinfo(np.uint64).max - 1], np.uint64),
        np.arange(1, HOT_VOCAB + 1, dtype=np.uint64)]))
    mirror = DeviceIndexMirror(index, "cuda")
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
    # keys absent from the mirror, high keys and key 0 beside present ones
    probe_keys = np.concatenate([
        rng.integers(HOT_VOCAB + 1, 1 << 62, size=4000).astype(np.uint64),
        mixed, rng.integers(1, HOT_VOCAB + 1, size=4000).astype(np.uint64)])
    want = np.where(probe_keys <= HOT_VOCAB, probe_keys, 0).astype(np.int32)
    probe_err = max(probe_err, check_probe(
        "absent-and-present", mirror, torch.from_numpy(
            probe_keys.view(np.int64)).cuda(), want_rows=want))
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
    return (dedup_err, probe_err), {"dedup": dd, "mirror": mirror,
                                    "keys": train_keys}


# -- phase 3 -----------------------------------------------------------------

def random_deepfm(rng, in_dim: int):
    widths = [in_dim, *HIDDEN, 1]
    leaves = []
    for a, b in zip(widths[:-1], widths[1:]):
        leaves.append((rng.normal(size=b) * 0.01).astype(np.float32))
        leaves.append((rng.normal(size=(a, b)) / np.sqrt(a)).astype(
            np.float32))
    leaves.append(np.float32(rng.normal() * 0.1).reshape(()))
    return deepfm_from_flax_leaves(leaves, HIDDEN)


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


def phase_serve(rng, seed: int) -> int:
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
    return launches


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
                 before) -> None:
    """The first steps of the main path vs its twin's, from the same init:
    losses (rtol), the touched rows (show/clk exact, the rest and their
    change from ``before``), the dense params."""
    losses = [float(x) for x in losses[:CPU_STEPS]]
    twin_losses = [float(x) for x in twin_losses]
    require(np.allclose(losses, twin_losses, rtol=TRAIN_RTOL, atol=0),
            f"{tag}: losses {losses} vs {twin_losses}")
    (vals, st, params), (cvals, cst, cparams) = after, twin_after
    require(torch.equal(vals[:, :2], cvals[:, :2]),
            f"{tag}: show/clk of the touched rows differ")
    row_err = max(float((vals - cvals).abs().max()),
                  float((st - cst).abs().max()))
    dense_err = max(float((a - b).abs().max())
                    for a, b in zip(params, cparams))
    require(row_err <= TRAIN_ATOL, f"{tag}: table rows {row_err}")
    require(dense_err <= TRAIN_ATOL, f"{tag}: dense params {dense_err}")
    changes = []
    for what, got, want, init in (
            ("values", vals[:, 2:], cvals[:, 2:], before[0][:, 2:]),
            ("state", st, cst, before[1])):
        scale = float((want - init).abs().max())
        derr = float(((got - init) - (want - init)).abs().max())
        require(scale > 0, f"{tag}: the steps left the touched rows' {what} "
                           "unchanged")
        require(derr <= TRAIN_DELTA_RTOL * scale,
                f"{tag}: change of the touched rows' {what} {derr} > "
                f"{TRAIN_DELTA_RTOL} * {scale}")
        changes.append(f"{what} max abs err {derr:.3e} of a largest "
                       f"change {scale:.3e}")
    print(f"{tag} over {CPU_STEPS} steps: losses {losses} vs {twin_losses}, "
          f"{vals.shape[0]} touched rows (show/clk exact, max abs err "
          f"{row_err:.3e}; their change: {', '.join(changes)}), dense max "
          f"abs err {dense_err:.3e}")


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


def time_steps(fs, state, batches, step=None):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = train_steps(fs, state, batches, step)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return state, secs / len(batches) * 1e3, TB * len(batches) / secs


def with_new_keys(rng, batches, fresh: int):
    """The batches' keys with 5% of each batch's replaced by keys new to
    the table, from ``fresh`` on."""
    out = []
    for keys, _, _ in batches:
        keys = keys.copy()
        nk = int((keys > 0).sum())
        pick = rng.choice(nk, size=nk // 20, replace=False)
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


DEVICE_PREP_WRAPPERS = TRAIN_WRAPPERS + (device_dedup_cuda, device_probe_cuda)


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
    for name, n in launches.items():
        want = 0 if name == merge_offsets.__name__ else TRAIN_STEPS
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
    device_profile("train device-prep, 4 steps",
                   lambda: train_steps(fs, state, batches[:4],
                                       fs.step_device),
                   kernels=(KERNEL, PUSH, "dedup", "probe"))
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
    new = np.unique(np.concatenate(fresh))
    new = new[new > HOT_VOCAB]
    rows, found = table.mirror.probe(torch.from_numpy(new.view(
        np.int64)).cuda())
    want, _ = table._index.lookup(new, False, True, 0)
    require(bool(found.all()) and np.array_equal(rows.cpu().numpy(), want),
            "train device-prep: the mirror lacks inserted keys")
    new_prep_ms = time_inserts(
        "train host-prep: prepare_batch (native index)",
        host_table.prepare_batch,
        with_new_keys(rng, batches[:5], HOT_VOCAB + 1))
    return {"launches": launches, "ms_per_step": ms, "examples_per_s": eps,
            "host_prep_native_ms_per_step": host_ms,
            "host_prep_native_examples_per_s": host_eps,
            "prepare_batch_native_ms": prep_ms,
            "ensure_keys_new_keys_ms": ensure_ms,
            "prepare_batch_native_new_keys_ms": new_prep_ms}


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
    uniques (the others are never read), inverse, uniq_rows and uniq_mask
    once; read and write the value and state rows of the live uniques
    once; the merge's adds, show/clk and ~6 operations a trained column."""
    npad, dim = demb.shape
    live = int((umask > 0).sum())
    live_keys = int((umask[inv.long()] > 0).sum())
    sd = max(layout.state_dim, 1)
    nbytes = live_keys * dim * 4 + npad * 4 + urows.shape[0] * 8 + \
        live * (dim + sd) * 4 * 2
    return nbytes, live_keys * dim + live * (2 + 6 * (dim - 2))


def time_push(inputs) -> dict:
    """Push at the training shape, the wrapper's merge order (stable sort
    of ``inverse`` and the boundary kernel) included, and the push kernel
    alone on a precomputed merge order; the sort alone beside them.
    Library yardstick: ``index_add_`` of demb into [Upad, D], the merge
    only. Each call trains the arena copies further; the work per call
    stays."""
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

    def kernel():
        push_rows(layout, values, state, demb, order, offsets, urows, umask)

    t["kernel_ms"] = cuda_ms(kernel, ITERS)
    t["kernel_graph_ms"] = graph_ms(kernel)
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


def time_index(inputs) -> Tuple[dict, dict]:
    """K5 and K6 at the training shape. K5: the hand-written passes on the
    sorted keys (``ms``, against the bound of their own bytes), the
    wrapper with its sort, the sort alone; plain and ``torch.unique`` read
    values back to the host, so they are not captured in a graph. K6: the
    probe of the batch's uniques over the 4,194,304-key mirror; no single
    PyTorch call computes it."""
    dd, mirror, keys = inputs["dedup"], inputs["mirror"], inputs["keys"]
    kt = torch.from_numpy(keys.view(np.int64)).cuda()
    packed = kt ^ SIGN
    presorted = torch.sort(packed, stable=True)
    n = keys.size
    k5 = {"ms": cuda_ms(lambda: device_dedup_cuda(kt, presorted), ITERS),
          "graph_ms": graph_ms(lambda: device_dedup_cuda(kt, presorted)),
          "with_sort_ms": cuda_ms(lambda: device_dedup_cuda(kt), ITERS),
          "with_sort_graph_ms": graph_ms(lambda: device_dedup_cuda(kt)),
          "sort_ms": cuda_ms(lambda: torch.sort(packed, stable=True), ITERS),
          "sort_graph_ms": graph_ms(lambda: torch.sort(packed, stable=True)),
          "plain_ms": cuda_ms(lambda: device_dedup_plain(kt), ITERS),
          "plain_graph_ms": None,
          "library_ms": cuda_ms(lambda: torch.unique(
              packed, sorted=True, return_inverse=True), ITERS),
          "library_graph_ms": None}
    tiles = -(-n // 1024)
    # sorted keys and sidx read, inverse, uniques, offsets and n_uniq
    # written, the tile counts written and read
    with_bound(k5, n * 16 + n * 4 + n * 8 + (n + 1) * 4 + 4 + tiles * 8, 0)
    print(f"timing {DEDUP} training (N={n}, n_uniq={int(dd.n_uniq)}): the "
          f"passes on sorted keys per call {k5['ms']:.5f} ms, in a CUDA "
          f"graph {k5['graph_ms']:.5f} ms "
          f"({100 * k5['bound_ms'] / k5['graph_ms']:.1f}% of bound "
          f"{k5['bound_ms']:.6f} ms, {k5['bound_bytes']} bytes); with its "
          f"sort per call {k5['with_sort_ms']:.5f} ms, in a graph "
          f"{k5['with_sort_graph_ms']:.5f} ms; the sort alone per call "
          f"{k5['sort_ms']:.5f} ms, in a graph {k5['sort_graph_ms']:.5f} "
          f"ms; plain {k5['plain_ms']:.5f} ms, torch.unique "
          f"{k5['library_ms']:.5f} ms per call (neither capturable)")
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
    return k5, k6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    rng = np.random.default_rng(args.seed)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    try:
        ptxas = phase_build()
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
            index_rng, make_train_batches(index_rng, 1)[0][0])
        serve_launches = phase_serve(rng, args.seed)
        train, train_init = phase_train(rng)
        train_dev = phase_train_device(np.random.default_rng([args.seed, 8]),
                                       train_init)
        timing = phase_timing(shapes)
        grad_timing = time_grad(grad_inputs)
        push_timing = time_push(train_inputs)
        push_timing["adam"] = time_push(push_inputs["adam"])
        offsets_timing = time_offsets(train_inputs)
        dedup_timing, probe_timing = time_index(index_inputs)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"chip_smoke: all phases {time.perf_counter() - t_start:.1f} s; "
          f"train host-prep (numpy index) {train['ms_per_step']:.4f} "
          f"ms/step, {train['examples_per_s']:.1f} examples/s; host-prep "
          f"(native index) {train_dev['host_prep_native_ms_per_step']:.4f} "
          f"ms/step; device-prep {train_dev['ms_per_step']:.4f} ms/step, "
          f"{train_dev['examples_per_s']:.1f} examples/s")
    print(smi.stdout.strip())
    host, dev = train["launches"], train_dev["launches"]

    def by_path(wrapper, **more) -> dict:
        """Launches on each main path (each counted from 0)."""
        paths = {**more, "train_host_prep": host.get(wrapper.__name__, 0),
                 "train_device_prep": dev[wrapper.__name__]}
        return {"launches": sum(paths.values()), "launches_by_path": paths}

    rows = [
        {"name": KERNEL, "route": "cuda",
         "source": "paddlebox_tpu_torch/csrc/seqpool_cvm.cu",
         "replaces": "paddlebox_tpu/ops/pallas_seqpool.py:123",
         **by_path(seqpool_cvm_cuda, serve=serve_launches),
         "max_abs_err": err, **timing},
        {"name": GRAD, "route": "cuda",
         "source": "paddlebox_tpu_torch/csrc/seqpool_cvm_grad.cu",
         "replaces": "paddlebox_tpu/ops/seqpool_cvm.py:109",
         **by_path(seqpool_cvm_grad_cuda),
         "max_abs_err": grad_err, **grad_timing, "ptxas": ptxas[GRAD]},
        {"name": PUSH, "route": "cuda",
         "source": "paddlebox_tpu_torch/csrc/sparse_push.cu",
         "replaces": "paddlebox_tpu/ps/device_table.py:189",
         **by_path(sparse_push_cuda),
         "max_abs_err": push_err, **push_timing,
         "ptxas": [r for r in ptxas[PUSH] if r["name"].startswith(
             f"sparse_push_kernel<{push_geometry(D)[1]},")]},
        {"name": OFFSETS, "route": "cuda",
         "source": "paddlebox_tpu_torch/csrc/sparse_push.cu",
         "replaces": "paddlebox_tpu/ps/device_table.py:189",
         **by_path(merge_offsets),
         "max_abs_err": offsets_err, **offsets_timing},
        {"name": DEDUP, "route": "cuda",
         "source": "paddlebox_tpu_torch/csrc/device_index.cu",
         "replaces": "paddlebox_tpu/ps/device_index.py:112",
         **by_path(device_dedup_cuda),
         "max_abs_err": index_err[0], **dedup_timing,
         "ptxas": [r for r in ptxas[INDEX] if "dedup" in r["name"]]},
        {"name": PROBE, "route": "cuda",
         "source": "paddlebox_tpu_torch/csrc/device_index.cu",
         "replaces": "paddlebox_tpu/ps/device_index.py:133",
         **by_path(device_probe_cuda),
         "max_abs_err": index_err[1], **probe_timing,
         "ptxas": [r for r in ptxas[INDEX] if "probe" in r["name"]]},
    ]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
