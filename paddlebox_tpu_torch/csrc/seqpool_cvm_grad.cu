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
// and reads 0.4 MB of ids, 2.2 MB of g and 16 KB of cvm_in, ~7.1 MB or
// ~2.1 us at 3.35 TB/s; a launch costs about 1 us on top.
//
// Design: one thread per output element (key, column), the column fastest,
// so that each warp writes 128 contiguous bytes. The D threads of a key read
// the same id (one transaction); the g rows of a segment are read once per
// key of the segment, and the repeats hit L1/L2. A grid-stride loop covers
// any Npad. The result is bit-exact against the plain version: it only
// copies values.
//
// Preconditions (checked by the wrapper): ids in [0, n_seg], cvm_in
// [n_seg / S, cvm_offset], all pointers to contiguous float32/int32 data.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    seqpool_cvm_grad_kernel(const float* __restrict__ g,
                            const int* __restrict__ ids,
                            const float* __restrict__ cvm_in,
                            float* __restrict__ d_emb, int64_t total,
                            int dim, int n_seg, int num_slots,
                            int cvm_offset, int g_width, int g_skip) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < total; i += stride) {
    const int64_t k = i / dim;
    const int c = static_cast<int>(i - k * dim);
    const int seg = __ldg(ids + k);
    float v = 0.0f;
    if (seg < n_seg) {
      v = c < cvm_offset
              ? __ldg(cvm_in + static_cast<int64_t>(seg / num_slots) *
                                   cvm_offset + c)
              : __ldg(g + static_cast<int64_t>(seg) * g_width +
                      (c - cvm_offset + g_skip));
    }
    d_emb[i] = v;
  }
}

}  // namespace

extern "C" {

// g [n_seg, g_width], ids [n_keys], cvm_in [n_seg / num_slots, cvm_offset],
// d_emb [n_keys, dim]; returns a cudaError_t (0 = launched).
int pbx_seqpool_cvm_grad(const void* g, const void* ids, const void* cvm_in,
                         void* d_emb, int64_t n_keys, int dim, int64_t n_seg,
                         int num_slots, int use_cvm, int cvm_offset,
                         void* stream) {
  if (n_keys <= 0) {
    return 0;
  }
  if (dim < 1 || n_seg < 0 || n_seg > INT32_MAX || num_slots < 1 ||
      cvm_offset < 0 || cvm_offset >= dim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = n_keys * dim;
  const int64_t blocks64 = (total + kThreads - 1) / kThreads;
  const int blocks =
      static_cast<int>(blocks64 < (1 << 20) ? blocks64 : (1 << 20));
  const int g_width = use_cvm ? dim : dim - cvm_offset;
  const int g_skip = use_cvm ? cvm_offset : 0;
  seqpool_cvm_grad_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int*>(ids),
      static_cast<const float*>(cvm_in), static_cast<float*>(d_emb), total,
      dim, static_cast<int>(n_seg), num_slots, cvm_offset, g_width, g_skip);
  return static_cast<int>(cudaGetLastError());
}

const char* pbx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
