// In-step key dedup (K5) and mirror probe (K6) of device-prep training, for
// Hopper (sm_90a).
//
// K5 replaces the XLA function paddlebox_tpu/ps/device_index.py::
// device_dedup. The wrapper (ops/device_index_kernel.py) packs each uint64
// key k as the int64 k ^ (1 << 63), so that signed order is the unsigned key
// order, and sorts it stably with its positions (torch.sort: `sorted`,
// `sidx`; the reference's sort is XLA's too). Two kernels then do the rest:
//
//   dedup_count_kernel  a block counts the first occurrences in its tile of
//                       kTile sorted keys (i == 0 or sorted[i] != sorted[i-1])
//   dedup_write_kernel  a block sums the counts of the tiles before it and
//                       of all tiles (n_uniq), scans its own flags, and for
//                       sorted position i with uid u (flags up to i, less 1)
//                       writes inverse[sidx[i]] = u and, at a first
//                       occurrence, uniq[u] = sorted[i] ^ (1 << 63) and
//                       offsets[u] = i; its grid-stride part writes
//                       uniq[u] = 0 for u in [n_uniq, n) and offsets[u] = n
//                       for u in [n_uniq, n]; block 0 writes n_uniq.
//
// uids follow ascending unsigned key order (key 0, the padding, is uid 0 when
// present) and, the sort being stable, `sidx` lists each unique's positions
// in ascending order: it is the push's merge order and `offsets` its
// boundaries, so the push sums each unique's keys as the host-prep path does.
//
// K6 replaces paddlebox_tpu/ps/device_index.py::device_probe (and
// device_probe2's main level: the port keeps one level). For key k, with
// hi/lo its 32-bit halves and start = fmix32(hi ^ fmix32(lo)) & mask (the
// host map's Map64::hash, csrc/pbx_index.cpp), one thread walks the mirror's
// [cap + guard, 4] int32 quads (hi, lo, row, 0) from `start`, at most
// `window` (kMaxRun = 64) of them, with 16-byte loads, and stops at the match
// or at the first empty quad (hi = lo = 0xFFFFFFFF). Stopping there is sound
// because the map never deletes and bounds its runs without wraparound, so a
// present key has no empty slot between its home and itself. It writes row
// (0 if absent) and found; key 0 and the reserved key ~0 are never found.
//
// What bounds them on an H100, at the training shape (N = Npad = 102,400,
// ~97k uniques, a 2^24 + 64-slot mirror at load 0.25): K5 moves ~3.3 MB
// (sorted keys and sidx read, inverse, uniques and offsets written), ~1 us at
// 3.35 TB/s, in two launches; its write pass scatters `inverse` 4 bytes at a
// time. K6 reads ~1.2 quads a key, 16 bytes each, scattered over a 268 MB
// table, so each key is one or two dependent round trips to HBM; one thread a
// key puts all of them in flight at once (~400 blocks, one wave). Both are
// simple first versions: right before fast.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;                   // consecutive sorted keys a thread
constexpr int kTile = kThreads * kItems;    // sorted keys a block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kSign = -0x7fffffffffffffffLL - 1;  // 1 << 63

// Exclusive scan of v over the block; *total receives the block's sum.
// Every thread must call it; `warp_sums` is kWarps ints of shared memory,
// free again when it returns.
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;  // inclusive
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kWarps - 1];
  __syncthreads();
  return before + x - v;
}

// First-occurrence flags of the thread's kItems sorted keys, as bits.
__device__ unsigned first_flags(const long long* __restrict__ sorted, int n,
                                int i0, long long* keys) {
  unsigned flags = 0;
  long long prev = i0 > 0 && i0 <= n ? __ldg(&sorted[i0 - 1]) : 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = i0 + j;
    if (i < n) {
      keys[j] = __ldg(&sorted[i]);
      if (i == 0 || keys[j] != prev) flags |= 1u << j;
      prev = keys[j];
    }
  }
  return flags;
}

__global__ void __launch_bounds__(kThreads)
dedup_count_kernel(const long long* __restrict__ sorted, int n,
                   int* __restrict__ tile_counts) {
  __shared__ int warp_sums[kWarps];
  long long keys[kItems];
  const int i0 = blockIdx.x * kTile + threadIdx.x * kItems;
  const int count = __popc(first_flags(sorted, n, i0, keys));
  int total;
  block_exclusive_scan(count, warp_sums, &total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
dedup_write_kernel(const long long* __restrict__ sorted,
                   const int64_t* __restrict__ sidx, int n,
                   const int* __restrict__ tile_counts, int n_tiles,
                   int* __restrict__ inverse, long long* __restrict__ uniq,
                   int* __restrict__ offsets, int* __restrict__ n_uniq_out) {
  __shared__ int warp_sums[kWarps];
  // the uniques of the tiles before this one, and of all tiles
  int before = 0, all = 0;
  for (int t = threadIdx.x; t < n_tiles; t += kThreads) {
    const int c = __ldg(&tile_counts[t]);
    all += c;
    if (t < static_cast<int>(blockIdx.x)) before += c;
  }
  int n_uniq, prefix;
  block_exclusive_scan(all, warp_sums, &n_uniq);
  block_exclusive_scan(before, warp_sums, &prefix);

  long long keys[kItems];
  const int i0 = blockIdx.x * kTile + threadIdx.x * kItems;
  const unsigned flags = first_flags(sorted, n, i0, keys);
  int ignored;
  int seen = prefix + block_exclusive_scan(__popc(flags), warp_sums,
                                           &ignored);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = i0 + j;
    if (i < n) {
      const bool first = (flags >> j) & 1u;
      seen += first;
      const int u = seen - 1;
      inverse[__ldg(&sidx[i])] = u;
      if (first) {
        uniq[u] = keys[j] ^ kSign;
        offsets[u] = i;
      }
    }
  }
  // the tail past the last unique
  for (int u = blockIdx.x * kThreads + threadIdx.x; u <= n;
       u += gridDim.x * kThreads) {
    if (u >= n_uniq) {
      offsets[u] = n;
      if (u < n) uniq[u] = 0;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *n_uniq_out = n_uniq;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  return x;
}

__global__ void __launch_bounds__(kThreads)
probe_kernel(const int4* __restrict__ tab, uint32_t mask, int window,
             const long long* __restrict__ keys,
             const int* __restrict__ n_valid, int n, int* __restrict__ rows,
             bool* __restrict__ found) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int limit = n_valid != nullptr ? __ldg(n_valid) : n;
  int row = 0;
  bool hit = false;
  if (i < limit) {
    const unsigned long long k =
        static_cast<unsigned long long>(__ldg(&keys[i]));
    if (k != 0) {
      const uint32_t lo = static_cast<uint32_t>(k);
      const uint32_t hi = static_cast<uint32_t>(k >> 32);
      const size_t start = fmix32(hi ^ fmix32(lo)) & mask;
      for (int j = 0; j < window; ++j) {
        const int4 q = __ldg(&tab[start + j]);
        if (q.x == -1 && q.y == -1) break;  // empty: the run ends
        if (static_cast<uint32_t>(q.x) == hi &&
            static_cast<uint32_t>(q.y) == lo) {
          row = q.z;
          hit = true;
          break;
        }
      }
    }
  }
  rows[i] = row;
  found[i] = hit;
}

}  // namespace

extern "C" {

int pbx_dedup_tile() { return kTile; }

// sorted [n] int64 (packed keys, ascending), sidx [n] int64 (their
// positions), tile_counts [ceil(n / kTile)] int32 scratch; writes inverse
// [n] int32, uniq [n] int64, offsets [n + 1] int32 and n_uniq [1] int32.
// Returns a cudaError_t (0 = launched).
int pbx_device_dedup(const void* sorted, const void* sidx, int64_t n,
                     void* tile_counts, void* inverse, void* uniq,
                     void* offsets, void* n_uniq, void* stream) {
  if (n <= 0 || n >= INT32_MAX - kTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = static_cast<int>((n + kTile - 1) / kTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dedup_count_kernel<<<tiles, kThreads, 0, s>>>(
      static_cast<const long long*>(sorted), static_cast<int>(n),
      static_cast<int*>(tile_counts));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dedup_write_kernel<<<tiles, kThreads, 0, s>>>(
      static_cast<const long long*>(sorted),
      static_cast<const int64_t*>(sidx), static_cast<int>(n),
      static_cast<const int*>(tile_counts), tiles,
      static_cast<int*>(inverse), static_cast<long long*>(uniq),
      static_cast<int*>(offsets), static_cast<int*>(n_uniq));
  return static_cast<int>(cudaGetLastError());
}

// tab [n_slots, 4] int32, keys [n] int64, n_valid [1] int32 or null (all n
// keys valid); writes rows [n] int32 and found [n] bool. The wrapper checks
// mask + window <= n_slots. Returns a cudaError_t (0 = launched).
int pbx_device_probe(const void* tab, int64_t n_slots, int64_t mask,
                     int window, const void* keys, const void* n_valid,
                     int64_t n, void* rows, void* found, void* stream) {
  if (n <= 0 || n >= INT32_MAX - kThreads || mask < 0 ||
      mask >= (int64_t(1) << 32) || window < 1 ||
      mask + window > n_slots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = static_cast<int>((n + kThreads - 1) / kThreads);
  probe_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(tab), static_cast<uint32_t>(mask), window,
      static_cast<const long long*>(keys), static_cast<const int*>(n_valid),
      static_cast<int>(n), static_cast<int*>(rows),
      static_cast<bool*>(found));
  return static_cast<int>(cudaGetLastError());
}

const char* pbx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
