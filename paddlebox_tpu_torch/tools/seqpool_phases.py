"""Where a block of the seqpool+CVM kernel spends its time, on the card.

Builds a copy of ``csrc/seqpool_cvm.cu`` with clock reads at the edges of a
block's two phases (issue and wait for the loads; ownership, sums and
writes) and runs it at the serving shape (B=512, S=26, D=11, Criteo
lengths) and the multi-key shape (B=4096, 1-3 keys a slot). Prints, for
each shape, the span of one launch on the global timer, each block's time,
and the SM cycles of each phase (median and max over the blocks that own
segments). The clock reads and one extra barrier add a little to each
block, so these times sit slightly above the kernel's own.

    python3 -m paddlebox_tpu_torch.tools.seqpool_phases

Needs a card and ``nvcc``; builds into ``build/`` at the root of the
checkout.
"""

from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from paddlebox_tpu_torch.config import batch_bucket_spec
from paddlebox_tpu_torch.ops import _build

MAX_BLOCKS = 1 << 14

_PROBES = [
    # (anchor in the kernel source, text inserted after it)
    ("namespace {\n",
     "__device__ long long pbx_phase[{} * 4];\n"
     "__device__ __forceinline__ long long pbx_gtime() {{\n"
     "  long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}}\n".format(MAX_BLOCKS)),
    ("  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * kt;\n",
     "  const long long pbx_g0 = pbx_gtime(), pbx_c0 = clock64();\n"),
    ("  if (tails) {\n    asm volatile(\"cp.async.wait_all;\\n\" ::: "
     "\"memory\");\n    __syncthreads();  // every thread's cp.asyncs have "
     "landed\n  }\n",
     "  const long long pbx_c1 = clock64();\n"),
    ("      __syncthreads();  // start[] and show_clk are rewritten by the "
     "next one\n    }\n  }\n",
     "  __syncthreads();\n"
     "  if (t == 0 && blockIdx.x < {}) {{\n"
     "    long long* p = pbx_phase + 4 * blockIdx.x;\n"
     "    p[0] = pbx_g0;\n    p[1] = pbx_gtime();\n"
     "    p[2] = pbx_c1 - pbx_c0;\n    p[3] = clock64() - pbx_c1;\n"
     "  }}\n".format(MAX_BLOCKS)),
]


def probed_source() -> str:
    src = (_build.CSRC / "seqpool_cvm.cu").read_text()
    for anchor, text in _PROBES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in the kernel: "
                               f"{anchor!r}")
        src = src.replace(anchor, anchor + text)
    return src + ('extern "C" int pbx_phase_read(void* dst, int n) {\n'
                  '  return cudaMemcpyFromSymbol(dst, pbx_phase, n * 8);\n}\n')


def build() -> ctypes.CDLL:
    work = _build.BUILD_DIR / "seqpool_phases"
    work.mkdir(parents=True, exist_ok=True)
    (work / "probed.cu").write_text(probed_source())
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                          str(work / "libprobed.so"), str(work / "probed.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"probed kernel build failed:\n{res.stderr}")
    lib = ctypes.CDLL(str(work / "libprobed.so"))
    lib.pbx_seqpool_cvm_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.pbx_phase_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def inputs(rng, batch: int, slots: int, dim: int, lengths):
    n = int(lengths.sum())
    npad = batch_bucket_spec().bucket(n)
    segs = np.full(npad, batch * slots, dtype=np.int32)
    segs[:n] = np.repeat(np.arange(batch * slots, dtype=np.int32), lengths)
    emb = rng.normal(size=(npad, dim)).astype(np.float32)
    return torch.from_numpy(emb).cuda(), torch.from_numpy(segs).cuda()


def measure(lib, name: str, emb, segs, batch: int, slots: int) -> None:
    out = torch.empty((batch * slots, emb.shape[1]), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    lib_args = (emb.data_ptr(), segs.data_ptr(), out.data_ptr(),
                emb.shape[0], emb.shape[1], batch * slots, 1, 2, 0.0, 1,
                stream)
    for _ in range(20):   # warm; the last launch is the one read
        if lib.pbx_seqpool_cvm_fwd(*lib_args) != 0:
            raise RuntimeError("probed kernel launch failed")
    torch.cuda.synchronize()
    buf = np.zeros(MAX_BLOCKS * 4, np.int64)
    if lib.pbx_phase_read(buf.ctypes.data, buf.size) != 0:
        raise RuntimeError("reading the phase clocks failed")
    p = buf.reshape(-1, 4)
    p = p[p[:, 0] > 0]    # blocks that reached the end (not padding tiles)
    dur = p[:, 1] - p[:, 0]
    print(f"{name}: {len(p)} blocks recorded, launch span "
          f"{p[:, 1].max() - p[:, 0].min()} ns, block time median "
          f"{np.median(dur):.0f} ns max {dur.max()} ns")
    for col, phase in ((2, "loads"), (3, "ownership + sums + writes")):
        print(f"  {phase}: median {np.median(p[:, col]):.0f} cycles, "
              f"max {p[:, col].max()}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("seqpool_phases: needs a CUDA device")
    lib = build()
    rng = np.random.default_rng(0)
    serving = (rng.uniform(size=512 * 26) > 0.05).astype(np.int64)
    measure(lib, "serving", *inputs(rng, 512, 26, 11, serving), 512, 26)
    multikey = rng.integers(1, 4, size=4096 * 26)
    measure(lib, "multi-key", *inputs(rng, 4096, 26, 11, multikey), 4096,
            26)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
