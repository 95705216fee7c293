"""Development script: a kernel of the package against earlier versions of
its source, on the card. Not part of the package or of ``chip_smoke.py``.

    mkdir -p build/old
    git show 043fc54:paddlebox_tpu_torch/csrc/sparse_push.cu \\
        > build/old/push_v1.cu
    python3 kernel_versions.py push --old build/old/push_v1.cu
    git show 8ff1c7d:paddlebox_tpu_torch/csrc/seqpool_cvm_grad.cu \\
        > build/old/grad_v1.cu
    python3 kernel_versions.py grad --old build/old/grad_v1.cu
    python3 kernel_versions.py index --old build/old/first2.cu
    git show 611a138:paddlebox_tpu_torch/csrc/sparse_push.cu \\
        > build/old/push_parent.cu
    python3 kernel_versions.py push --old build/old/push_parent.cu \\
        --ptxas-only
    git show b8ceb62:paddlebox_tpu_torch/csrc/sparse_push.cu \\
        > build/old/merge_v2.cu
    python3 kernel_versions.py merge --old build/old/merge_v2.cu

The script builds the earlier sources and the package's kernel, one
``nvcc`` each, all at once, and prints each one's ptxas report (registers,
spills, shared memory). It holds each against the plain version at the
training shape (B=2048, S=24, D=11, Npad=102,400), then times them in turns
in one process on one card: the earlier ones in the order given, the
package's kernel twice, the earlier ones in reverse order. Run it from the
root of a checkout, before anything has built the package's kernel (or it
prints no ptxas report for it): it takes its inputs and timers from
``chip_smoke.py``. With ``--ptxas-only`` it stops after the reports, so an
earlier source of any C interface can be held against the package's
registers and spills.

``push``: each earlier source has version 1's C interface, ``pbx_sparse_push``
taking an int32 ``order`` and ``offsets`` from ``searchsorted``, with no
lane geometry (the kernel of commit 043fc54). Checks: adagrad and adam with
one key 500 times in the batch, and adagrad with keys uniform over the
table; show/clk exact, the rest within 1e-6. Each turn reads the kernel
alone and the push with its merge order in a CUDA graph, and the push per
call between CUDA events, beside the byte bound.

``grad``: each earlier source has version 1's C interface,
``pbx_seqpool_cvm_grad(g, ids, cvm_in, d_emb, n_keys, dim, n_seg,
num_slots, use_cvm, cvm_offset, stream)`` (the kernel of commit 8ff1c7d),
or version 2's, which takes ``lanes`` before ``stream``; the script reads
which from the source. Checks: bit for bit, use_cvm, cvm_offset 2. Each
turn reads a CUDA graph (device time) and a per-call time between CUDA
events (the host's launch rate), beside the byte bound that
``chip_smoke.py`` counts and ``index_select``'s time, read before and after
the turns.

``index``: each earlier source of ``csrc/device_index.cu`` has this
version's C interface (``pbx_dedup_sort``, ``pbx_dedup_number_probe``) and
runs through the package's wrappers with its library swapped in. Checks:
the fused dedup and probe bit for bit against ``device_dedup_probe_plain``
on ``chip_smoke.py``'s training batch and on as many keys over all 64 bits,
over the training table's 4,194,304-key mirror, 10 launches each. Each
turn reads the fused numbering (count pass and fused write pass, on a
sort made beforehand) and the whole fused dedup and probe in a CUDA graph,
the numbering with cold caches (``chip_smoke.cold_graph_ms``), and the
whole per call, beside the byte bound ``chip_smoke.py`` counts.

``merge``: the mesh step's requester merge (``segment_merge_cuda``). Each
earlier source is a whole ``csrc/sparse_push.cu``, built as its merge
part alone (``-DPBX_PUSH_PART=6``, the push's launchers stubbed), with
version 2's C interface, ``pbx_segment_merge(demb, order, offsets, g,
work, n_seg, dim, stream)`` and ``work`` [n_seg + 1] int32 (the kernels of
commit b8ceb62, summing every segment in key order), or this version's
(``pbx_segment_merge_scratch`` and ``work_words, n_keys`` before
``n_seg``, summing by chunks of ``SEGMENT_CHUNK`` keys past that many);
the script reads which from the source. Inputs: ``chip_smoke.py`` phase
4v (d)'s (``merge_inputs``): (a) one shard by unique and by position,
(b) shard 0 of 4, (a) and (b) under the Zipf(1.2) key mix, and (a) under
slot-keyed Criteo traffic with a slot of 3 values (``criteo_keys``). Checks:
each version bit for bit against the plain version of its own order
(``segment_merge_plain``, or the key-order sum), two launches each. Each
turn reads every shape in a CUDA graph and per call, beside the byte
bound and ``index_add_``'s time (the merge only, by position), read before
and after the turns. Then the push (``sparse_push_cuda`` with its merge
order, adagrad) at the training shape, its keys uniform and under the Zipf
mix, in turns (uniform, Zipf, Zipf, uniform), checked against
``sparse_push_plain``: whether the push's own merge pays for a hot key.
"""

from __future__ import annotations

import argparse
import copy
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

import chip_smoke as cs
from paddlebox_tpu_torch.config import TableConfig
from paddlebox_tpu_torch.ops import _build
from paddlebox_tpu_torch.ops import device_index_kernel as dik
from paddlebox_tpu_torch.ops.seqpool_kernel import (grad_lanes,
                                                    seqpool_cvm_grad_cuda,
                                                    seqpool_cvm_grad_plain)
from paddlebox_tpu_torch.ops.sparse_push import (_OPTIMIZERS, _sum_in_order,
                                                 merge_order, push_rows,
                                                 segment_merge_cuda,
                                                 segment_merge_plain,
                                                 sparse_push_cuda,
                                                 sparse_push_plain)
from paddlebox_tpu_torch.ps.device_index import device_dedup_probe_plain

# the package's source of each kernel
SOURCES = {"push": "sparse_push", "grad": "seqpool_cvm_grad",
           "index": "device_index", "merge": "sparse_push"}

# merge: the push's launchers, which an earlier source's merge part calls
# and never reaches here
PUSH_STUBS = "".join(
    f"extern \"C\" void pbx_push_launch_{p}(const void*, int, int, int, "
    "void*) {}\n" for p in range(6))


def build_old(kernel: str, src: Path) -> Tuple[ctypes.CDLL, str]:
    """Compiles an earlier source; returns the library and nvcc's output."""
    work = _build.BUILD_DIR / "kernel_versions" / kernel
    work.mkdir(parents=True, exist_ok=True)
    out = work / f"lib{src.stem}.so"
    extra = []
    if kernel == "merge":
        stubs = work / "push_stubs.cu"
        stubs.write_text(PUSH_STUBS)
        extra = ["-DPBX_PUSH_PART=6", str(stubs)]
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                          str(src), *extra], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{src} build failed:\n{res.stderr}")
    return ctypes.CDLL(str(out)), res.stdout + res.stderr


def turns(tags: List[str]) -> List[str]:
    return tags + ["new", "new"] + tags[::-1]


# -- push ---------------------------------------------------------------------


class OldPush:
    """An earlier push kernel, with the merge order its wrapper built: a
    stable sort, ``searchsorted`` for the offsets and an int32 cast of the
    order."""

    def __init__(self, lib: ctypes.CDLL):
        lib.pbx_sparse_push.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        lib.pbx_sparse_push.restype = ctypes.c_int
        self.lib = lib

    @staticmethod
    def merge_order(inv: torch.Tensor, upad: int):
        sorted_inv, order = torch.sort(inv, stable=True)
        offsets = torch.searchsorted(
            sorted_inv, torch.arange(upad + 1, dtype=inv.dtype,
                                     device=inv.device), out_int32=True)
        return order.int(), offsets

    @staticmethod
    def group_desc(layout) -> ctypes.Array:
        """Version 1's descriptor: (start, width, gated, state offset) a
        group, float32 arenas only."""
        desc = []
        for gi, (start, width, gated) in enumerate(layout.groups):
            desc += [start, width, int(gated),
                     int(layout.state_offsets[gi])]
        return (ctypes.c_int * max(len(desc), 1))(*desc)

    def push_rows(self, layout, values, state, demb, order, offsets, urows,
                  umask) -> None:
        conf = layout.conf
        rc = self.lib.pbx_sparse_push(
            values.data_ptr(), state.data_ptr(), demb.data_ptr(),
            order.data_ptr(), offsets.data_ptr(), urows.data_ptr(),
            umask.data_ptr(), urows.shape[0], values.shape[1],
            state.shape[1], len(layout.groups), self.group_desc(layout),
            _OPTIMIZERS[conf.optimizer], conf.learning_rate,
            conf.initial_g2sum, conf.embedx_threshold,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"old push kernel launch failed: {rc}")

    def push(self, layout, values, state, demb, inv, urows, umask) -> None:
        self.push_rows(layout, values, state, demb,
                       *self.merge_order(inv, urows.shape[0]), urows, umask)


class NewPush:
    """The package's push, through its wrappers."""

    merge_order = staticmethod(merge_order)
    push_rows = staticmethod(push_rows)
    push = staticmethod(sparse_push_cuda)


def check_push(name: str, ver, inputs) -> float:
    layout, values, state, demb, inv, urows, umask = inputs
    got = (values.clone(), state.clone())
    want = (values.clone(), state.clone())
    ver.push(layout, *got, demb, inv, urows, umask)
    torch.cuda.synchronize()
    sparse_push_plain(layout, *want, demb, inv, urows, umask)
    cs.require(torch.equal(got[0][:, :2], want[0][:, :2]),
               f"{name}: show/clk differ from plain")
    err = max(float((got[0] - want[0]).abs().max()),
              float((got[1] - want[1]).abs().max()))
    cs.require(err <= cs.PUSH_ATOL, f"{name}: max abs err {err}")
    return err


def push_readings(ver, inputs) -> Tuple[float, float, float]:
    """Kernel alone (graph), push with merge order (graph), per call."""
    layout, values, state, demb, inv, urows, umask = inputs
    order, offsets = ver.merge_order(inv, urows.shape[0])
    alone = cs.graph_ms(lambda: ver.push_rows(layout, values, state, demb,
                                              order, offsets, urows, umask))
    full = cs.graph_ms(lambda: ver.push(layout, values, state, demb, inv,
                                        urows, umask))
    call = cs.cuda_ms(lambda: ver.push(layout, values, state, demb, inv,
                                       urows, umask), cs.ITERS)
    return alone, full, call


def run_push(olds: Dict[str, ctypes.CDLL], rng, smi: str) -> None:
    versions = {tag: OldPush(lib) for tag, lib in olds.items()}
    versions["new"] = NewPush
    # chip_smoke.py's timing batch (a key 500 times, 50 unknown keys), and
    # the training phase's (keys uniform over the table)
    for opt, hot, unknown in (("adagrad", 500, 50), ("adagrad", 0, 0),
                              ("adam", 500, 50)):
        conf = TableConfig(embedx_dim=8, cvm_offset=3, embedx_threshold=10.0,
                           optimizer=opt, seed=7)
        table, batch = cs.push_batch(rng, conf, cs.HOT_VOCAB, cs.TNPAD,
                                     cs.TB * cs.TS * 2, hot=hot,
                                     unknown=unknown, upad_min=cs.TNPAD)
        opt = f"{opt} hot={hot}"
        demb, inv, urows, umask = (torch.from_numpy(x).cuda() for x in batch)
        nbytes, ops = cs.push_bound(table.layout, demb, inv, urows, umask)
        bound_ms = cs.with_bound({}, nbytes, ops)["bound_ms"]
        inputs = {tag: (table.layout, table.values.clone(),
                        table.state.clone(), demb, inv, urows, umask)
                  for tag in versions}
        for tag, ver in versions.items():
            err = check_push(f"{tag} {opt}", ver, inputs[tag])
            print(f"check {tag} {opt}: show/clk exact, max abs err "
                  f"{err:.3e} ok")
        print(f"{opt}: Npad={cs.TNPAD} D={table.dim} Upad={urows.shape[0]} "
              f"live={int((umask > 0).sum())} state columns "
              f"{table.state.shape[1]}; bound {bound_ms:.6f} ms ({nbytes} "
              f"bytes) on {smi}")
        for turn, tag in enumerate(turns(list(olds))):
            alone, full, call = push_readings(versions[tag], inputs[tag])
            print(f"turn {turn} {tag} {opt}: kernel alone {alone:.5f} ms "
                  f"({100 * bound_ms / alone:.1f}% of bound), with merge "
                  f"order {full:.5f} ms (CUDA graph); per call {call:.5f} ms")


# -- grad ---------------------------------------------------------------------


class OldGrad:
    """An earlier backward kernel, through version 1's or version 2's C
    interface."""

    def __init__(self, lib: ctypes.CDLL, src: Path):
        self.lanes = re.search(r"pbx_seqpool_cvm_grad\([^)]*\blanes\b",
                               src.read_text()) is not None
        lib.pbx_seqpool_cvm_grad.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int] + [ctypes.c_int] * self.lanes + [
            ctypes.c_void_p]
        lib.pbx_seqpool_cvm_grad.restype = ctypes.c_int
        self.lib, self.tag = lib, src.stem

    def __call__(self, g, segs, cvm, batch, slots, use_cvm, cvm_offset):
        dim = g.shape[-1] + (0 if use_cvm else cvm_offset)
        d_emb = torch.empty((segs.shape[0], dim), device=g.device)
        lanes = (grad_lanes(dim),) if self.lanes else ()
        rc = self.lib.pbx_seqpool_cvm_grad(
            g.data_ptr(), segs.data_ptr(), cvm.data_ptr(), d_emb.data_ptr(),
            segs.shape[0], dim, batch * slots, slots, int(use_cvm),
            cvm_offset, *lanes, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.tag} launch failed: {rc}")
        return d_emb


def run_grad(olds: Dict[str, ctypes.CDLL], srcs: List[Path], rng,
             smi: str) -> None:
    versions = {src.stem: OldGrad(olds[src.stem], src) for src in srcs}
    versions["new"] = seqpool_cvm_grad_cuda
    # checks the package's kernel against plain, bit for bit
    _, (g, segs, cvm) = cs.check_grad(rng, "training", cs.TB, cs.TS, cs.D,
                                      rng.integers(1, 4, size=cs.TB * cs.TS),
                                      cs.TNPAD, True, 2)
    args = (g, segs, cvm, cs.TB, cs.TS, True, 2)
    want = seqpool_cvm_grad_plain(*args)
    for tag in olds:
        got = versions[tag](*args)
        torch.cuda.synchronize()
        cs.require(torch.equal(got, want), f"{tag}: differs from plain")
        print(f"check {tag}: bit-exact against plain ok")
    nbytes = cs.grad_bytes(g, segs, cvm)
    bound_ms = cs.with_bound({}, nbytes, 0)["bound_ms"]
    tail = torch.cat([g.reshape(cs.TB * cs.TS, -1)[:, 2:],
                      g.new_zeros((1, g.shape[-1] - 2))])

    def library():
        torch.index_select(tail, 0, segs)

    print(f"training shape B={cs.TB} S={cs.TS} D={cs.D} Npad={cs.TNPAD}: "
          f"bound {bound_ms:.6f} ms ({nbytes} bytes) on {smi}")
    print(f"index_select before: {cs.graph_ms(library):.5f} ms (CUDA graph); "
          f"per call {cs.cuda_ms(library, cs.ITERS):.5f} ms")
    for turn, tag in enumerate(turns(list(olds))):
        fn = versions[tag]
        graph = cs.graph_ms(lambda: fn(*args))
        call = cs.cuda_ms(lambda: fn(*args), cs.ITERS)
        print(f"turn {turn} {tag}: {graph:.5f} ms ({100 * bound_ms / graph:.1f}"
              f"% of bound) (CUDA graph); per call {call:.5f} ms")
    print(f"index_select after: {cs.graph_ms(library):.5f} ms (CUDA graph); "
          f"per call {cs.cuda_ms(library, cs.ITERS):.5f} ms")


# -- index --------------------------------------------------------------------


class IndexVersion:
    """A build of ``csrc/device_index.cu`` behind the package's wrappers:
    an earlier source's library stands in for the package's during each
    call."""

    def __init__(self, lib=None):
        self.lib = dik.bind(lib) if lib is not None else None

    def __call__(self, fn, *args):
        if self.lib is None:
            return fn(*args)
        saved = dik._lib
        dik._lib = lambda: self.lib
        try:
            return fn(*args)
        finally:
            dik._lib = saved


def run_index(olds: Dict[str, ctypes.CDLL], seed: int, smi: str) -> None:
    versions = {tag: IndexVersion(lib) for tag, lib in olds.items()}
    versions["new"] = IndexVersion()
    _, mirror = cs.training_mirror()
    m = (mirror.tab, mirror.mask, mirror.window)
    # chip_smoke.py's training batch and 64-bit keys at the same seed
    train = cs.make_train_batches(np.random.default_rng([seed, 7]), 1)[0][0]
    keys64 = np.random.default_rng([seed, 9]).integers(
        0, 1 << 64, size=cs.TNPAD, dtype=np.uint64)
    cases = {name: torch.from_numpy(keys.view(np.int64)).cuda()
             for name, keys in (("training", train), ("keys64", keys64))}
    for name, kt in cases.items():
        want, _ = cs.dedup_probe_fields(device_dedup_probe_plain(kt, *m))
        for tag, ver in versions.items():
            for _ in range(cs.DEDUP_REPEATS):
                got, _ = cs.dedup_probe_fields(
                    ver(dik.device_dedup_probe_cuda, kt, *m))
                cs.require(all(torch.equal(a, b) for a, b in zip(got, want)),
                           f"{tag} {name}: differs from plain")
            print(f"check {tag} {name}: bit-exact against plain, "
                  f"{cs.DEDUP_REPEATS} launches, ok")
    kt = cases["training"]
    dd = device_dedup_probe_plain(kt, *m)[0]
    nbytes_probe, quads = cs.probe_bound(mirror, dd.uniq_keys, dd.n_uniq)
    n = kt.shape[0]
    nbytes = n * 8 + n * 4 + n * 8 + n * 8 + (n + 1) * 4 + 4 + quads * 16 + \
        n * 5
    bound_ms = cs.with_bound({}, nbytes, 0)["bound_ms"]
    print(f"training batch N={n} n_uniq={int(dd.n_uniq)}, {quads} quads "
          f"walked: bound {bound_ms:.6f} ms ({nbytes} bytes) on {smi}")
    sorts = {tag: ver(dik.dedup_sort_cuda, kt)
             for tag, ver in versions.items()}
    for turn, tag in enumerate(turns(list(olds))):
        ver, srt = versions[tag], sorts[tag]
        number = cs.graph_ms(lambda: ver(dik.dedup_number_probe_cuda, srt,
                                         *m))
        whole = cs.graph_ms(lambda: ver(dik.device_dedup_probe_cuda, kt, *m))
        cold = cs.cold_graph_ms(lambda: ver(dik.dedup_number_probe_cuda,
                                            srt, *m))
        call = cs.cuda_ms(lambda: ver(dik.device_dedup_probe_cuda, kt, *m),
                          cs.ITERS)
        print(f"turn {turn} {tag}: numbering {number:.5f} ms, whole "
              f"{whole:.5f} ms ({100 * bound_ms / whole:.1f}% of bound) "
              f"(CUDA graph); numbering with cold caches {cold:.5f} ms; "
              f"whole per call {call:.5f} ms")


# -- merge --------------------------------------------------------------------


class OldMerge:
    """An earlier merge, through version 2's C interface or this
    version's, with the plain version of its own order."""

    def __init__(self, lib: ctypes.CDLL, src: Path):
        self.chunked = "pbx_segment_merge_scratch" in src.read_text()
        if self.chunked:
            lib.pbx_segment_merge_scratch.argtypes = [ctypes.c_int64,
                                                      ctypes.c_int]
            lib.pbx_segment_merge_scratch.restype = ctypes.c_int64
            lib.pbx_segment_merge.argtypes = [ctypes.c_void_p] * 5 + [
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                ctypes.c_void_p]
        else:
            lib.pbx_segment_merge.argtypes = [ctypes.c_void_p] * 5 + [
                ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        lib.pbx_segment_merge.restype = ctypes.c_int
        self.lib, self.tag = lib, src.stem

    def __call__(self, demb, order, offsets):
        n_keys, dim = demb.shape
        n_seg = offsets.shape[0] - 1
        g = torch.empty((n_seg, dim), device=demb.device)
        stream = torch.cuda.current_stream().cuda_stream
        if self.chunked:
            words = self.lib.pbx_segment_merge_scratch(n_keys, dim)
            work = torch.empty(words, dtype=torch.int32, device=demb.device)
            args = (words, n_keys, n_seg, dim, stream)
        else:
            work = torch.empty(n_seg + 1, dtype=torch.int32,
                               device=demb.device)
            args = (n_seg, dim, stream)
        rc = self.lib.pbx_segment_merge(demb.data_ptr(), order.data_ptr(),
                                        offsets.data_ptr(), g.data_ptr(),
                                        work.data_ptr(), *args)
        if rc != 0:
            raise RuntimeError(f"{self.tag} launch failed: {rc}")
        return g

    def plain(self, demb, order, offsets):
        if self.chunked:
            return segment_merge_plain(demb, order, offsets)
        starts = offsets[:-1].long()
        return _sum_in_order(demb, order, starts, offsets[1:].long() - starts)


class NewMerge:
    """The package's merge, through its wrapper."""

    __call__ = staticmethod(segment_merge_cuda)
    plain = staticmethod(segment_merge_plain)


def merge_cases(rng) -> Dict[str, tuple]:
    """chip_smoke.py phase 4v (d)'s shapes: name -> (demb, order, offsets,
    index_add_'s positions, its M)."""
    conf, _, _ = cs.train_confs()
    model = cs.random_deepfm(rng, cs.TS * conf.pull_dim)
    one = cs.mesh_world(copy.deepcopy(model), "cuda", 1, 1 << 10, True)[0]
    four = cs.mesh_world(model, "cuda", cs.MESH_SHARDS, 1 << 10, True)[0]
    keys = cs.make_train_batches(rng, 1)[0][0]
    b_keys = cs.split_batches(rng, 1, cs.MESH_SHARDS)[0][0][0]
    R1, R4 = one._req_cap(keys.size), four._req_cap(b_keys.size)
    shapes = {"a": (one, keys, R1, True), "a_position": (one, keys, R1, False),
              "b": (four, b_keys, R4, True),
              "zipf": (one, cs.zipf_keys(rng, keys), R1, True),
              "b_zipf": (four, cs.zipf_keys(rng, b_keys), R4, True),
              "criteo": (one, cs.criteo_keys(rng, keys), R1, True)}
    return {name: (*cs.merge_inputs(step, k, R, rng, by), step.ndev * R)
            for name, (step, k, R, by) in shapes.items()}


def zipf_push_batch(rng, conf: TableConfig):
    """A push table over HOT_VOCAB keys and two batches of the training
    shape through it, numpy inputs: chip_smoke.py's training keys
    (uniform) and the same layout under phase 4v (d)'s Zipf(1.2) mix."""
    table = cs.push_table(rng, conf, cs.HOT_VOCAB, cs.TNPAD)
    keys = cs.make_train_batches(rng, 1)[0][0]
    nk = int((keys > 0).sum())
    out = {}
    for name, k in (("uniform", keys), ("zipf", cs.zipf_keys(rng, keys))):
        idx = table.prepare_batch(k, create=False)
        out[name] = (cs.push_grads(rng, cs.TNPAD, table.dim, nk),
                     idx.inverse, idx.uniq_rows, idx.uniq_mask)
    return table, out


def run_merge(olds: Dict[str, ctypes.CDLL], srcs: List[Path], rng,
              smi: str) -> None:
    versions = {src.stem: OldMerge(olds[src.stem], src) for src in srcs}
    versions["new"] = NewMerge()
    cases = merge_cases(rng)
    libs = {}
    for name, (demb, order, offsets, seg, M) in cases.items():
        lens = (offsets[1:] - offsets[:-1]).long()
        items, longest, chunks = cs.merge_work(offsets)
        for tag, ver in versions.items():
            want = ver.plain(demb, order, offsets)
            for _ in range(2):
                got = ver(demb, order, offsets)
                cs.require(torch.equal(got, want),
                           f"{tag} {name}: differs from its plain version")
        g = torch.empty((M + 1, cs.D), device="cuda")
        seg_l = seg.long()
        libs[name] = (lambda g=g, seg_l=seg_l, demb=demb:  # noqa: E731
                      g.zero_().index_add_(0, seg_l, demb))
        nbytes = cs.merge_bytes(offsets)
        print(f"check {name}: every version bit for bit against the plain "
              f"version of its order, 2 launches; {offsets.numel() - 1} "
              f"segments, {int(lens.sum())} merged keys, longest {longest} "
              f"({chunks} chunks), {int((lens > cs.SHORT_MERGE_KEYS).sum())} "
              f"past {cs.SHORT_MERGE_KEYS} keys, {items} work items; bound "
              f"{cs.with_bound({}, nbytes, 0)['bound_ms']:.6f} ms ({nbytes} "
              f"bytes) on {smi}")

    def library(when: str) -> None:
        for name, fn in libs.items():
            print(f"index_add_ {when} {name}: {cs.graph_ms(fn):.5f} ms (CUDA "
                  f"graph); per call {cs.cuda_ms(fn, cs.ITERS):.5f} ms")

    library("before")
    for turn, tag in enumerate(turns(list(olds))):
        ver = versions[tag]
        for name, (demb, order, offsets, _, _) in cases.items():
            bound = cs.with_bound({}, cs.merge_bytes(offsets), 0)["bound_ms"]
            graph = cs.graph_ms(lambda: ver(demb, order, offsets))
            call = cs.cuda_ms(lambda: ver(demb, order, offsets), cs.ITERS)
            print(f"turn {turn} {tag} {name}: {graph:.5f} ms "
                  f"({100 * bound / graph:.1f}% of bound) (CUDA graph); per "
                  f"call {call:.5f} ms")
    library("after")
    run_push_zipf(rng, smi)


def run_push_zipf(rng, smi: str) -> None:
    conf = TableConfig(embedx_dim=8, cvm_offset=3, embedx_threshold=10.0,
                       optimizer="adagrad", seed=7)
    table, batches = zipf_push_batch(rng, conf)
    inputs = {}
    for name, batch in batches.items():
        demb, inv, urows, umask = (torch.from_numpy(x).cuda() for x in batch)
        inputs[name] = (table.layout, table.values.clone(),
                        table.state.clone(), demb, inv, urows, umask)
        got = (inputs[name][1].clone(), inputs[name][2].clone())
        want = (inputs[name][1].clone(), inputs[name][2].clone())
        sparse_push_cuda(table.layout, *got, demb, inv, urows, umask)
        sparse_push_plain(table.layout, *want, demb, inv, urows, umask)
        cs.require(torch.equal(got[0][:, :2], want[0][:, :2]),
                   f"push {name}: show/clk differ from plain")
        # the plain version's merge is index_add_'s atomics: a hot key's
        # sum in another order
        err = max(float((got[0] - want[0]).abs().max()),
                  float((got[1] - want[1]).abs().max()))
        nbytes, ops = cs.push_bound(table.layout, demb, inv, urows, umask)
        counts = torch.bincount(inv.long()[umask[inv.long()] > 0])
        print(f"check push {name}: show/clk exact, max abs err {err:.3e} "
              f"(PUSH_ATOL {cs.PUSH_ATOL}); "
              f"live uniques {int((umask > 0).sum())}, the hottest "
              f"{int(counts.max())} keys; bound "
              f"{cs.with_bound({}, nbytes, ops)['bound_ms']:.6f} ms "
              f"({nbytes} bytes) on {smi}")
    for turn, name in enumerate(["uniform", "zipf", "zipf", "uniform"]):
        alone, full, call = push_readings(NewPush, inputs[name])
        print(f"turn {turn} push {name}: kernel alone {alone:.5f} ms, with "
              f"merge order {full:.5f} ms (CUDA graph); per call {call:.5f} "
              "ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(SOURCES))
    ap.add_argument("--old", required=True, type=Path, nargs="+",
                    help="earlier sources of the kernel (see the module's "
                         "docstring for the C interfaces they may have)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ptxas-only", action="store_true",
                    help="build and print the ptxas reports, then stop "
                         "(any C interface)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_versions: CUDA is not available", file=sys.stderr)
        return 1
    tags = [src.stem for src in args.old]
    if "new" in tags or len(set(tags)) != len(tags):
        ap.error("earlier sources need distinct file names other than new.cu")
    with ThreadPoolExecutor(len(args.old) + 1) as pool:
        old_f = [pool.submit(build_old, args.kernel, src) for src in args.old]
        new_f = pool.submit(_build.build, SOURCES[args.kernel])
        built = [f.result() for f in old_f]
        new = new_f.result()
    olds = {tag: lib for tag, (lib, _) in zip(tags, built)}
    logs = {tag: log for tag, (_, log) in zip(tags, built)}
    logs["new"] = new[1] if new else ""
    for tag, log in logs.items():
        reports = [r for r in cs.ptxas_report(log)
                   if args.kernel != "merge" or "segment_merge" in r["name"]]
        for r in reports or [{"name": "already built, no report"}]:
            print(f"ptxas {tag}: {r['name']}: {r.get('registers')} "
                  f"registers, spill stores {r.get('spill_stores')} B, "
                  f"spill loads {r.get('spill_loads')} B, stack "
                  f"{r.get('stack')} B, smem {r.get('smem')} B")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    if args.ptxas_only:
        return 0
    rng = np.random.default_rng(args.seed)
    if args.kernel == "push":
        run_push(olds, rng, smi)
    elif args.kernel == "grad":
        run_grad(olds, args.old, rng, smi)
    elif args.kernel == "index":
        run_index(olds, args.seed, smi)
    else:
        run_merge(olds, args.old, rng, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
