#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``paddlebox_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed 0]

Phases, each fatal on failure:

1. build   — compile the serving path's CUDA kernel from the repository's
             source with ``nvcc``.
2. kernel  — hold ``seqpool_cvm_cuda`` against its plain PyTorch version on
             the card at the serving shape (B=512, S=26, D=11, Npad from the
             bucket), at the multi-key shape (B=4096, 1-3 keys a slot) and
             at edge shapes aimed at the kernel's 128-key tiles; show/clk
             sums must be exact.
3. serve   — write a seeded synthetic Criteo file, export a DeepFM
             (hidden 512-256-128) bundle whose table has >= 4M rows, serve
             every batch through ``CTRPredictor(device="cuda")``; the kernel's
             launch count must equal the batch count, and the scores must
             match the same predictor with a plain pool, and the predictor on
             the CPU.
   Scoring time per batch and a device profile of the serving loop.
4. timing  — at the serving and the multi-key shape: kernel, plain and
             ``segment_reduce`` times, per call and in a CUDA graph, beside
             the kernel's bound; and the launch floor, the graph time of
             ``torch.cuda._sleep(0)``.

Prints the card's ``name, power.limit`` line, then one JSON line of
per-kernel numbers, then ``{"ok": true, "device": {...}}`` last. Exits
nonzero, printing no result, without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from paddlebox_tpu_torch.config import TableConfig, batch_bucket_spec
from paddlebox_tpu_torch.data.criteo import (CriteoReader, criteo_feed_config,
                                             make_synthetic_criteo)
from paddlebox_tpu_torch.inference.predictor import (CTRPredictor,
                                                     save_inference_model)
from paddlebox_tpu_torch.models.convert import deepfm_from_flax_leaves
from paddlebox_tpu_torch.ops import _build
from paddlebox_tpu_torch.ops.seqpool_kernel import (bulk_loads,
                                                    seqpool_cvm_cuda,
                                                    seqpool_cvm_plain)
from paddlebox_tpu_torch.ps.table import state_dim

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
# H100 SXM data sheet: HBM3 bandwidth and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# kernel vs plain: both sum in float32, in another order (index_add_ on CUDA
# is atomic); show/clk are integer-valued and must be exact before the log
RTOL, ATOL = 1e-6, 1e-5
# scores: float32 GEMMs on the card vs another summation order
SCORE_ATOL = 1e-5
HIDDEN = (512, 256, 128)
B, S, D = 512, 26, 11
MK_B = 4096                  # batch of the multi-key (training-sized) shape
BATCHES = 16                 # Criteo batches of B served on the main path
TABLE_ROWS = 1 << 22         # rows of the served table snapshot
ITERS = 200                  # calls per timing
KERNEL = "seqpool_cvm"


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


def device_profile(fn) -> None:
    """Print the device's busy share over one call of ``fn``, its five
    largest device activities and the seqpool kernel's, from a
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
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    busy = sum(by_name.values())
    if not busy:
        print("profile serve: device time not measured (no device events)")
        return
    print(f"profile serve: wall {wall_us:.0f} us, device busy {busy:.0f} us "
          f"({100 * busy / wall_us:.1f}%; overlapping activities counted "
          "twice)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    for name, us in top[:5] + [kv for kv in top[5:] if KERNEL in kv[0]]:
        print(f"  {us:10.1f} us  {name[:90]}")


# -- phase 1 -----------------------------------------------------------------

def phase_build() -> None:
    built = _build.build(KERNEL)
    require(_build.library_path(KERNEL).exists(), f"{KERNEL} was not built")
    if built is None:
        print(f"build: {KERNEL} already built")
        return
    secs, log = built
    print(f"build: {KERNEL} {secs:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


# -- phase 2 -----------------------------------------------------------------

def make_pool_inputs(rng, batch: int, slots: int, dim: int, lengths,
                     npad: int, offset_rows: int = 0):
    """emb [npad, dim] (show/clk integer-valued), sorted segment ids; the
    padding rows hold garbage the pool must ignore. With ``offset_rows``
    emb is a view that many rows into its allocation."""
    n = min(int(lengths.sum()), npad)
    segs = np.full(npad, batch * slots, dtype=np.int32)
    segs[:n] = np.repeat(np.arange(batch * slots, dtype=np.int32),
                         lengths)[:n]
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
                           pad_value)
    torch.cuda.synchronize()
    want = seqpool_cvm_plain(emb, segs, batch, slots, use_cvm, cvm_offset,
                             pad_value)
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
    return err, {"serving": (B, serving), "multikey": (MK_B, multikey)}


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
    device_profile(lambda: [pred.predict_batch(b) for b in batches])
    return launches


# -- phase 4 -----------------------------------------------------------------

def time_shape(tag: str, batch: int, inputs) -> dict:
    """Kernel, plain and ``segment_reduce`` per call and in a CUDA graph,
    beside the kernel's bound, at one shape."""
    emb, segs, n = inputs
    kernel = lambda: seqpool_cvm_cuda(emb, segs, batch, S, True, 2, 0.0)
    plain = lambda: seqpool_cvm_plain(emb, segs, batch, S, True, 2, 0.0)
    seg_lengths = torch.bincount(segs[:n].long(), minlength=batch * S)
    valid = emb[:n]
    library = lambda: torch.segment_reduce(valid, "sum", lengths=seg_lengths,
                                           unsafe=True)
    t = {"ms": cuda_ms(kernel, ITERS), "plain_ms": cuda_ms(plain, ITERS),
         "library_ms": cuda_ms(library, ITERS), "graph_ms": graph_ms(kernel),
         "plain_graph_ms": graph_ms(plain),
         "library_graph_ms": graph_ms(library)}
    # the kernel must load the rows and ids of the n valid keys (padding
    # rows are not needed) and write the whole output once
    dim = emb.shape[1]
    nbytes = n * dim * 4 + n * 4 + batch * S * dim * 4
    ops = n * dim + batch * S * 4  # adds over the keys, +pad, 2 logs, 1 sub
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    t["bound_ms"] = max(bytes_ms, ops_ms)
    t["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"timing seqpool_cvm {tag} (B={batch} S={S} D={dim} "
          f"Npad={emb.shape[0]} keys={n}): per call: kernel {t['ms']:.5f} "
          f"ms, plain {t['plain_ms']:.5f} ms, segment_reduce "
          f"{t['library_ms']:.5f} ms; bound {t['bound_ms']:.6f} ms "
          f"({nbytes} bytes)")
    print(f"timing seqpool_cvm {tag} in a CUDA graph (device time, no launch "
          f"gaps): kernel {t['graph_ms']:.5f} ms "
          f"({100 * t['bound_ms'] / t['graph_ms']:.1f}% of bound), plain "
          f"{t['plain_graph_ms']:.5f} ms, segment_reduce "
          f"{t['library_graph_ms']:.5f} ms")
    return t


def phase_timing(shapes: dict) -> dict:
    row = time_shape("serving", *shapes["serving"])
    row["launch_floor_ms"] = graph_ms(lambda: torch.cuda._sleep(0))
    print(f"timing launch floor: torch.cuda._sleep(0) in a CUDA graph "
          f"{row['launch_floor_ms']:.5f} ms")
    mk = time_shape("multi-key", *shapes["multikey"])
    row.update({f"multikey_{k}": v for k, v in mk.items()})
    return row


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
    try:
        phase_build()
        err, shapes = phase_kernel(rng)
        launches = phase_serve(rng, args.seed)
        timing = phase_timing(shapes)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    row = {"name": KERNEL, "route": "cuda",
           "source": "paddlebox_tpu_torch/csrc/seqpool_cvm.cu",
           "replaces": "paddlebox_tpu/ops/pallas_seqpool.py:123",
           "launches": launches, "max_abs_err": err, **timing}
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
