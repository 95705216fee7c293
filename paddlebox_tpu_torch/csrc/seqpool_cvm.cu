// Fused sequence sum-pool + CVM transform, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel paddlebox_tpu/ops/pallas_seqpool.py
// (pallas_seqpool_cvm -> _forward -> _kernel). That kernel restates the
// pool as one-hot matmuls on the TPU's matrix unit over (segment tile x key
// tile) pairs. Here the ids are sorted (the batch assembler emits them
// row-major), so the pool is a plain segmented reduction:
//
//   out[seg, c] = pad_value + sum_{k : ids[k] == seg} emb[k, c]
//   use_cvm:  out[., 0] = log(show + 1), out[., 1] = log(clk + 1) - log(show + 1)
//   !use_cvm: the first cvm_offset columns are dropped
//
// Design. Each block owns a tile of SEG_TILE consecutive segments. It finds
// the tile's SEG_TILE + 1 segment boundaries by binary search in the sorted
// ids (one search per boundary, into shared memory), so no host-side CSR is
// needed. Then its threads walk the (segment, column) pairs of the tile with
// the column fastest, so neighbouring threads read neighbouring floats of
// the same or the next key row, and write neighbouring outputs. Each output
// sums its keys in key order in fp32 with no atomics: the result does not
// depend on scheduling. Ids at or above n_seg (the padding segment B*S)
// fall outside every tile and are ignored.
//
// What bounds it. At the serving path's shapes (B=512, S=26, D=11,
// Npad ~ 13-15k keys, n ~ 12.6k of them valid) one call moves about 1.2 MB:
// n*D*4 bytes of embeddings (padding rows are never read), n*4 of ids and
// B*S*D*4 of output, some 0.36 us of HBM time at 3.35 TB/s, and does ~n*D
// adds. The kernel is bound by its launch,
// not by bytes or operations; fusing it with the pull gather and the first
// matmul is where later speed comes from.
//
// Precondition (not checked here): ids are non-decreasing and >= 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SEG_TILE = 64;
constexpr int THREADS = 256;

__device__ __forceinline__ int64_t lower_bound(const int* __restrict__ ids,
                                               int64_t n, int64_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(ids[mid]) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
seqpool_cvm_fwd_kernel(const float* __restrict__ emb,
                       const int* __restrict__ ids,
                       float* __restrict__ out, int64_t n_keys, int dim,
                       int64_t n_seg, int use_cvm, int cvm_offset,
                       float pad_value) {
  __shared__ int64_t bounds[SEG_TILE + 1];
  const int64_t seg0 = static_cast<int64_t>(blockIdx.x) * SEG_TILE;
  const int nloc = static_cast<int>(
      n_seg - seg0 < SEG_TILE ? n_seg - seg0 : SEG_TILE);
  for (int i = threadIdx.x; i <= nloc; i += blockDim.x) {
    bounds[i] = lower_bound(ids, n_keys, seg0 + i);
  }
  __syncthreads();

  const int out_dim = use_cvm ? dim : dim - cvm_offset;
  const int col0 = use_cvm ? 0 : cvm_offset;
  for (int t = threadIdx.x; t < nloc * out_dim; t += blockDim.x) {
    const int s = t / out_dim;
    const int c = t - s * out_dim;
    const int64_t beg = bounds[s];
    const int64_t end = bounds[s + 1];
    float v;
    if (use_cvm && c < 2) {
      // both CVM columns need the show sum
      float show = 0.f, clk = 0.f;
      for (int64_t k = beg; k < end; ++k) {
        show += emb[k * dim];
        clk += emb[k * dim + 1];
      }
      const float log_show = logf(show + pad_value + 1.f);
      v = c == 0 ? log_show : logf(clk + pad_value + 1.f) - log_show;
    } else {
      float acc = 0.f;
      for (int64_t k = beg; k < end; ++k) {
        acc += emb[k * dim + col0 + c];
      }
      v = acc + pad_value;
    }
    out[(seg0 + s) * out_dim + c] = v;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// out is [n_seg, use_cvm ? dim : dim - cvm_offset] float32, written whole.
int pbx_seqpool_cvm_fwd(const void* emb, const void* ids, void* out,
                        int64_t n_keys, int dim, int64_t n_seg, int use_cvm,
                        int cvm_offset, float pad_value, void* stream) {
  if (n_seg <= 0) {
    return 0;
  }
  const int64_t blocks = (n_seg + SEG_TILE - 1) / SEG_TILE;
  seqpool_cvm_fwd_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(emb), static_cast<const int*>(ids),
      static_cast<float*>(out), n_keys, dim, n_seg, use_cvm, cvm_offset,
      pad_value);
  return static_cast<int>(cudaGetLastError());
}

const char* pbx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
