"""Development script: the push kernel against an earlier version of its
source, on the card. Not part of the package or of ``chip_smoke.py``.

    mkdir -p build/push_v1
    git show 043fc54:paddlebox_tpu_torch/csrc/sparse_push.cu \
        > build/push_v1/sparse_push.cu
    python3 push_versions.py --old build/push_v1/sparse_push.cu

The earlier source must have version 1's C interface: ``pbx_sparse_push``
taking an int32 ``order`` and ``offsets`` from ``searchsorted``, with no lane
geometry (the kernel of commit 043fc54). The tool builds both sources,
prints each one's ptxas report (registers, spills, shared memory), holds
both against the plain version at the training shape (B=2048, S=24, D=11,
Npad=102,400; adagrad and adam with one key 500 times in the batch, and
adagrad with keys uniform over the table; show/clk exact, the rest within
1e-6), and
then times them in turns (old, new, new, old) in one process on one card:
the kernel alone and the push with its merge order in a CUDA graph, and the
push per call between CUDA events, beside the byte bound. Run it from the
root of a checkout: it takes its inputs and timers from ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

import chip_smoke as cs
from paddlebox_tpu_torch.config import TableConfig
from paddlebox_tpu_torch.ops import _build
from paddlebox_tpu_torch.ops.sparse_push import (_OPTIMIZERS, merge_order,
                                                 push_rows, sparse_push_cuda,
                                                 sparse_push_plain)


class Old:
    """The earlier kernel, with the merge order its wrapper built: a stable
    sort, ``searchsorted`` for the offsets and an int32 cast of the order."""

    def __init__(self, src: Path):
        work = _build.BUILD_DIR / "push_versions"
        work.mkdir(parents=True, exist_ok=True)
        out = work / "libold.so"
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                              str(out), str(src)], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"old push kernel build failed:\n{res.stderr}")
        self.log = res.stdout + res.stderr
        lib = ctypes.CDLL(str(out))
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

    def push_rows(self, layout, values, state, demb, order, offsets, urows,
                  umask) -> None:
        conf = layout.conf
        rc = self.lib.pbx_sparse_push(
            values.data_ptr(), state.data_ptr(), demb.data_ptr(),
            order.data_ptr(), offsets.data_ptr(), urows.data_ptr(),
            umask.data_ptr(), urows.shape[0], values.shape[1],
            state.shape[1], len(layout.groups), layout.push_desc,
            _OPTIMIZERS[conf.optimizer], conf.learning_rate,
            conf.initial_g2sum, conf.embedx_threshold,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"old push kernel launch failed: {rc}")

    def push(self, layout, values, state, demb, inv, urows, umask) -> None:
        self.push_rows(layout, values, state, demb,
                       *self.merge_order(inv, urows.shape[0]), urows, umask)


class New:
    """The package's kernel, through its wrappers."""

    log = ""
    merge_order = staticmethod(merge_order)
    push_rows = staticmethod(push_rows)
    push = staticmethod(sparse_push_cuda)


def check(name: str, ver, inputs) -> float:
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


def readings(ver, inputs) -> Tuple[float, float, float]:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="the earlier sparse_push.cu (version 1 interface)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("push_versions: CUDA is not available", file=sys.stderr)
        return 1
    with ThreadPoolExecutor(2) as pool:
        old_f = pool.submit(Old, args.old)
        new_f = pool.submit(_build.build, "sparse_push")
        old = old_f.result()
        built = new_f.result()
    if built is None:
        print("ptxas new: already built, no report")
    else:
        New.log = built[1]
    versions = {"old": old, "new": New}
    for tag, ver in versions.items():
        for r in cs.ptxas_report(ver.log):
            print(f"ptxas {tag}: {r['name']}: {r['registers']} registers, "
                  f"spill stores {r['spill_stores']} B, spill loads "
                  f"{r['spill_loads']} B, stack {r['stack']} B, smem "
                  f"{r['smem']} B")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    rng = np.random.default_rng(args.seed)
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
            err = check(f"{tag} {opt}", ver, inputs[tag])
            print(f"check {tag} {opt}: show/clk exact, max abs err "
                  f"{err:.3e} ok")
        print(f"{opt}: Npad={cs.TNPAD} D={table.dim} Upad={urows.shape[0]} "
              f"live={int((umask > 0).sum())} state columns "
              f"{table.state.shape[1]}; bound {bound_ms:.6f} ms ({nbytes} "
              f"bytes) on {smi}")
        for turn, tag in enumerate(("old", "new", "new", "old")):
            alone, full, call = readings(versions[tag], inputs[tag])
            print(f"turn {turn} {tag} {opt}: kernel alone {alone:.5f} ms "
                  f"({100 * bound_ms / alone:.1f}% of bound), with merge "
                  f"order {full:.5f} ms (CUDA graph); per call {call:.5f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
