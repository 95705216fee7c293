#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``paddlebox_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed 0]

Phases, each fatal on failure:

1. build   — compile the serving path's CUDA kernel from the repository's
             source with ``nvcc``.
2. kernel  — hold ``seqpool_cvm_cuda`` against its plain PyTorch version on
             the card at the serving shape (B=512, S=26, D=11, Npad from the
             bucket) and at edge shapes; show/clk sums must be exact.
3. serve   — write a seeded synthetic Criteo file, export a DeepFM
             (hidden 512-256-128) bundle whose table has >= 4M rows, serve
             every batch through ``CTRPredictor(device="cuda")``; the kernel's
             launch count must equal the batch count, and the scores must
             match the same predictor with a plain pool, and the predictor on
             the CPU.
4. timing  — kernel, plain and library times with the kernel's bound;
             scoring time per batch.

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
from paddlebox_tpu_torch.ops.seqpool_kernel import (seqpool_cvm_cuda,
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
    """Print the device's busy share over one call of ``fn`` and its five
    largest device activities, from a torch.profiler trace."""
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
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
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
                     npad: int):
    """emb [npad, dim] (show/clk integer-valued), sorted segment ids; the
    padding rows hold garbage the pool must ignore."""
    n = min(int(lengths.sum()), npad)
    segs = np.full(npad, batch * slots, dtype=np.int32)
    segs[:n] = np.repeat(np.arange(batch * slots, dtype=np.int32),
                         lengths)[:n]
    emb = (rng.normal(size=(npad, dim)) * 0.3).astype(np.float32)
    emb[:, 0] = rng.integers(1, 30, size=npad)
    emb[:, 1] = rng.integers(0, 2, size=npad)
    emb[n:] = rng.normal(size=(npad - n, dim)) * 1e3
    return (torch.from_numpy(emb).cuda(), torch.from_numpy(segs).cuda(), n)


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
    print(f"kernel check {name}: B={batch} S={slots} D={emb.shape[1]} "
          f"Npad={emb.shape[0]} use_cvm={use_cvm} cvm_offset={cvm_offset} "
          f"pad={pad_value} max_abs_err={err:.3e} ok")
    return err


def phase_kernel(rng) -> dict:
    bucket = batch_bucket_spec()
    # serving shape: Criteo-like, one key per (row, slot) 95% of the time
    lengths = (rng.uniform(size=B * S) > 0.05).astype(np.int64)
    npad = bucket.bucket(int(lengths.sum()))
    emb, segs, n = make_pool_inputs(rng, B, S, D, lengths, npad)
    err = check_kernel("serving", emb, segs, B, S, True, 2, 0.0)

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
    for name, b, s, d, lens, npd, use_cvm, off, pad in cases:
        e, sg, _ = make_pool_inputs(rng, b, s, d, lens, npd)
        err = max(err, check_kernel(name, e, sg, b, s, use_cvm, off, pad))

    # timings at the serving shape
    ms = cuda_ms(lambda: seqpool_cvm_cuda(emb, segs, B, S, True, 2, 0.0),
                 ITERS)
    plain_ms = cuda_ms(lambda: seqpool_cvm_plain(emb, segs, B, S, True, 2,
                                                 0.0), ITERS)
    seg_lengths = torch.bincount(segs[:n].long(), minlength=B * S)
    valid = emb[:n]
    library_ms = cuda_ms(lambda: torch.segment_reduce(
        valid, "sum", lengths=seg_lengths, unsafe=True), ITERS)
    graph_kernel = graph_ms(lambda: seqpool_cvm_cuda(emb, segs, B, S, True,
                                                     2, 0.0))
    graph_plain = graph_ms(lambda: seqpool_cvm_plain(emb, segs, B, S, True,
                                                     2, 0.0))
    graph_library = graph_ms(lambda: torch.segment_reduce(
        valid, "sum", lengths=seg_lengths, unsafe=True))
    # the kernel loads the rows and ids of the n valid keys only (padding
    # rows are never read), and writes the whole output once
    nbytes = n * D * 4 + n * 4 + B * S * D * 4
    ops = n * D + B * S * 4        # adds over the keys, +pad, 2 logs, 1 sub
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    print(f"timing seqpool_cvm (B={B} S={S} D={D} Npad={npad} keys={n}): "
          f"kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
          f"segment_reduce {library_ms:.5f} ms, bound {max(bytes_ms, ops_ms):.6f}"
          f" ms ({nbytes} bytes)")
    print(f"timing seqpool_cvm in a CUDA graph (device time, no launch "
          f"gaps): kernel {graph_kernel:.5f} ms, plain {graph_plain:.5f} ms, "
          f"segment_reduce {graph_library:.5f} ms")
    return {"name": "seqpool_cvm", "route": "cuda",
            "source": "paddlebox_tpu_torch/csrc/seqpool_cvm.cu",
            "replaces": "paddlebox_tpu/ops/pallas_seqpool.py:123",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms}


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


def phase_serve(rng, seed: int) -> dict:
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
    return {"launches": launches}


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
        row = phase_kernel(rng)
        row.update(phase_serve(rng, args.seed))
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
