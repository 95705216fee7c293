// Seqpool+CVM backward (the straight-through gather), for Hopper (sm_90a).
//
// Replaces the XLA function paddlebox_tpu/ops/seqpool_cvm.py::_bwd, which
// the TPU kernel's custom_vjp (ops/pallas_seqpool.py::_bwd) reuses. For each
// key k with segment seg = ids[k] and each column c:
//
//   d_emb[k, c] = cvm_in[seg / S, c]                     c <  cvm_offset
//   d_emb[k, c] = g[seg, c - cvm_offset + g_skip]        c >= cvm_offset
//   d_emb[k, :] = 0                                      seg >= n_seg (padding)
//
// with g [n_seg, g_width] the pooled output's gradient: g_width = D and
// g_skip = cvm_offset with use_cvm (the derivative of the CVM log columns is
// discarded), g_width = D - cvm_offset and g_skip = 0 without it. The show/
// clk columns thus carry the instance's counts to the push, as the
// reference's FusedSeqpoolCVMGradKernel* do.
//
// What bounds it on an H100: bytes, since there is no arithmetic. The
// training shape (B=2048, S=24, D=11, Npad=102,400) writes 4.5 MB of d_emb
// and reads 0.4 MB of ids, 1.8 MB of g's tail columns and 16 KB of cvm_in:
// 6.7 MB, 2.0 us at 3.35 TB/s; a launch costs about 1 us on top. Every load
// of a row waits on the load of its id, so each key is a chain of two round
// trips; what the design can do is run every chain at once, in one wave,
// and write each warp's rows as one contiguous, coalesced run.
//
// Design (version 2; version 1 ran one thread per output element, 1.1M
// threads in ~4 waves, each dividing in 64 bits and storing 4 bytes):
// - A group of `lanes` threads owns a key (ops/seqpool_kernel.py::
//   grad_lanes: 1 at D=11, up to 8 for wide rows), lane l its columns l,
//   l + lanes, ...; a warp owns a chunk of 32 / lanes consecutive keys, and
//   the grid one warp a chunk (3,200 warps in 800 blocks of 128 threads at
//   the training shape: one wave).
// - Two rounds of loads a key: its id, then its cvm_in and g columns, all
//   in flight together (four at a time a lane). No block barrier, no
//   search and no staging of g: ids in any order take the same path.
// - The warp writes its chunk's rows [32 / lanes, D] into shared memory,
//   then copies them to d_emb, where they are contiguous, with coalesced
//   4-byte stores.
// Staging g's rows by TMA in tiles of 256 keys (the first cut of this
// version) ran 0.0056-0.0058 ms in a graph: its block barriers held every
// block's phases in lockstep. A TMA bulk store of each chunk read ~0.1 us
// (3%) faster than the 4-byte stores, too little for its fences and
// alignment rules (PERF.md).
// The result is bit-exact against the plain version: it only copies values.
//
// Preconditions (checked by the wrapper): ids in [0, n_seg], cvm_in
// [n_seg / S, cvm_offset], all pointers to contiguous float32/int32 data.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_DIM = 256;

// Writes tw columns of one key's row to o: lane `lane` of a group of
// `lanes` takes columns lane, lane + lanes, ..., with four loads in flight
// before their stores.
template <typename Load>
__device__ __forceinline__ void write_row(float* __restrict__ o, int lane,
                                          int lanes, int tw, Load load) {
  for (int c0 = lane; c0 < tw; c0 += 4 * lanes) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + i * lanes;
      v[i] = c < tw ? load(c) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + i * lanes;
      if (c < tw) {
        o[c] = v[i];
      }
    }
  }
}

// Dynamic shared memory: each warp's chunk [32 / lanes, dim].
__global__ void __launch_bounds__(THREADS)
    seqpool_cvm_grad_kernel(const float* __restrict__ g,
                            const int* __restrict__ ids,
                            const float* __restrict__ cvm_in,
                            float* __restrict__ d_emb, int64_t n_keys,
                            int dim, int n_seg, int num_slots, int cvm_offset,
                            int g_width, int g_skip, int lanes) {
  extern __shared__ float rows[];
  const int t = threadIdx.x;
  const int wl = t & 31;
  const int kpw = 32 / lanes;  // keys a warp
  const int64_t kb =
      (static_cast<int64_t>(blockIdx.x) * WARPS + (t >> 5)) * kpw;
  if (kb >= n_keys) {
    return;  // a whole warp: the grid's last block may hold idle warps
  }
  const int nk = static_cast<int>(n_keys - kb < kpw ? n_keys - kb : kpw);
  float* chunk = rows + (t >> 5) * kpw * dim;

  const int k = wl / lanes;
  const int lane = wl & (lanes - 1);
  if (k < nk) {
    const int s = __ldg(ids + kb + k);
    float* o = chunk + k * dim;
    if (s >= n_seg) {
      for (int c = lane; c < dim; c += lanes) {
        o[c] = 0.0f;
      }
    } else {
      const float* cv = cvm_in + static_cast<int64_t>(
                                     static_cast<unsigned>(s) / num_slots) *
                                     cvm_offset;
      for (int c = lane; c < cvm_offset; c += lanes) {
        o[c] = __ldg(cv + c);
      }
      const float* row = g + g_skip + static_cast<int64_t>(s) * g_width;
      write_row(o + cvm_offset, lane, lanes, dim - cvm_offset,
                [row](int c) { return __ldg(row + c); });
    }
  }

  // the chunk's rows are contiguous in d_emb
  __syncwarp();
  const int n_out = nk * dim;
  float* dst = d_emb + kb * dim;
  for (int i = wl; i < n_out; i += 32) {
    dst[i] = chunk[i];
  }
}

}  // namespace

extern "C" {

// g [n_seg, g_width], ids [n_keys], cvm_in [n_seg / num_slots, cvm_offset],
// d_emb [n_keys, dim]. lanes (1, 2, 4 or 8) threads a key. Launches on
// `stream` and returns a cudaError_t (0 = launched).
int pbx_seqpool_cvm_grad(const void* g, const void* ids, const void* cvm_in,
                         void* d_emb, int64_t n_keys, int dim, int64_t n_seg,
                         int num_slots, int use_cvm, int cvm_offset,
                         int lanes, void* stream) {
  if (n_keys <= 0) {
    return 0;
  }
  if (dim < 1 || dim > MAX_DIM || n_seg < 0 || n_seg > INT32_MAX ||
      num_slots < 1 || cvm_offset < 0 || cvm_offset >= dim ||
      (lanes != 1 && lanes != 2 && lanes != 4 && lanes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t keys_per_block = static_cast<int64_t>(WARPS) * (32 / lanes);
  const int64_t blocks = (n_keys + keys_per_block - 1) / keys_per_block;
  const size_t smem =
      static_cast<size_t>(keys_per_block) * dim * sizeof(float);
  seqpool_cvm_grad_kernel<<<static_cast<unsigned>(blocks), THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int*>(ids),
      static_cast<const float*>(cvm_in), static_cast<float*>(d_emb), n_keys,
      dim, static_cast<int>(n_seg), num_slots, cvm_offset,
      use_cvm ? dim : dim - cvm_offset, use_cvm ? cvm_offset : 0, lanes);
  return static_cast<int>(cudaGetLastError());
}

const char* pbx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
