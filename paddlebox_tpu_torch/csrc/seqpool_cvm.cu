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
// Ids at or above n_seg (the padding segment B*S) are discarded.
//
// What bounds it, on an H100 (numbers from chip_smoke.py):
// - serving, B=512 S=26 D=11 (Criteo: at most one key a slot): ~12.6k valid
//   keys of Npad 15,104 move ~1.2 MB, 0.36 us at 3.35 TB/s. Latency bounds
//   it: ~1 us of launch, one round trip to L2 (~0.5 us through TMA), then
//   the block's dependent steps in shared memory and its barriers. The
//   kernel this one replaced ran 65 binary searches a block over the whole
//   id array, ~14 dependent device loads deep, before it read one row.
// - multi-key, B=4096 S=26 D=11 with 1-3 keys a slot: ~213k keys move
//   ~15 MB, 4.5 us at 3.35 TB/s. Bytes bound it if every SM keeps enough
//   loads in flight and spends few instructions a tile.
//
// Design: tile by keys, so that no block searches device memory and each
// block waits on one round trip.
// - Block b owns kt consecutive keys [k0, k0 + kt): kt = KT = 128, or fewer
//   (a multiple of 4) when that spreads the keys over every SM in one wave.
//   One wave (serving) runs 512-thread blocks, a block an SM; more tiles
//   (multi-key: 1,672) run 128-thread blocks, up to 16 an SM, ~7 KB of
//   loads in flight each.
// - One round of loads. Before any value is used, the block issues every
//   load it needs into shared memory at once: the ids from k0 - 4 (which
//   brings the id before the tile) and the rows from k0, each through the
//   tile and a halo of HALO keys after it. Each range is one 1-D TMA bulk
//   copy completing on an mbarrier when both pointers are 16-byte aligned;
//   4-byte cp.asyncs take a sub-16-byte tail, or everything when a pointer
//   is misaligned.
// - Ownership without search. Segment s belongs to the tile that holds
//   lower_bound(ids, s), position n_keys to the last tile. So the tile owns
//   the segments (ids[k0 - 1], ids[k0 + kt - 1]], clamped to [0, n_seg);
//   tile 0 starts at 0 and the last tile runs to n_seg - 1. Every segment,
//   empty ones included, has exactly one writer; a tile of padding owns
//   nothing. Each key k writes the start of the owned segments
//   (ids[k - 1], ids[k]] into shared memory, once, in parallel.
// - Threads map to (owned segment, column) with the column fastest, sum
//   their rows from shared memory in key order in fp32 (no atomics: the
//   result does not depend on scheduling, and integer show/clk sums stay
//   exact) and write contiguous outputs; the show/clk sums go through
//   shared memory to one thread a segment for the two logs. At most one
//   owned segment runs on past the tile; the halo holds its keys when it
//   ends within HALO keys of the tile's end (always, with 1-3 keys a slot).
//   A longer one is finished by the whole block, which reads on from
//   device memory a tile at a time in the same key order.
//
// Preconditions (not checked here): ids are non-decreasing and >= 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KT = 128;   // keys a tile at most, one tile a block
constexpr int HALO = 16;  // keys loaded past the tile's end
// (KT + HALO) * (MAX_DIM + 1) * 4 B = 148 KB of shared memory at most
constexpr int MAX_DIM = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// 1-D TMA bulk copy, device memory -> shared memory; completes on `bar`.
// dst, src and bytes must be multiples of 16.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// First position in ids[0, n) whose id is >= v.
__device__ __forceinline__ int lower_bound(const int* ids, int n, int64_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(ids[mid]) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Issues 4-byte cp.asyncs of src[from, n) to dst[from, n).
template <int THREADS, typename T>
__device__ __forceinline__ void copy_async4(T* dst, const T* __restrict__ src,
                                            int from, int n) {
  for (int i = from + static_cast<int>(threadIdx.x); i < n; i += THREADS) {
    cp_async4(dst + i, src + i);
  }
}

// Columns a thread sums for the long run below: t, t + THREADS, ...
template <int THREADS>
constexpr int kRunCols = (MAX_DIM + THREADS - 1) / THREADS;

// Sums of columns t + i * THREADS (< dim) over the keys of segment s that
// start at tile position `beg` and run on past the halo: the block reads on
// from device memory a tile at a time, in key order. Overwrites rows and
// tids.
template <int THREADS>
__device__ void sum_long_run(const float* __restrict__ emb,
                             const int* __restrict__ ids, int64_t kb,
                             int64_t n_keys, int dim, int s, int beg, int nh,
                             float* rows, int* tids,
                             float (&acc)[kRunCols<THREADS>]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kRunCols<THREADS>; ++i) {
    acc[i] = 0.f;
    const int c = t + i * THREADS;
    for (int k = beg; c < dim && k < nh; ++k) {
      acc[i] += rows[k * dim + c];
    }
  }
  for (;; kb += KT + HALO) {
    __syncthreads();  // the tile's shared memory is read out
    const int m =
        static_cast<int>(n_keys - kb < KT + HALO ? n_keys - kb : KT + HALO);
    copy_async4<THREADS>(tids, ids + kb, 0, m);
    copy_async4<THREADS>(rows, emb + kb * dim, 0, m * dim);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRunCols<THREADS>; ++i) {
      const int c = t + i * THREADS;
      for (int k = 0; c < dim && k < m && tids[k] == s; ++k) {
        acc[i] += rows[k * dim + c];
      }
    }
    if (m < KT + HALO || tids[m - 1] != s) {
      return;
    }
  }
}

// MIN_BLOCKS blocks of THREADS threads an SM: 128 x 16 caps a thread at 32
// registers, 512 x 2 at 64.
template <int THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
seqpool_cvm_fwd_kernel(const float* __restrict__ emb,
                       const int* __restrict__ ids,
                       float* __restrict__ out, int64_t n_keys, int dim,
                       int n_seg, int use_cvm, int cvm_offset,
                       float pad_value, int bulk, int kt,
                       uint32_t div_magic) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* rows = reinterpret_cast<float*>(smem);  // [KT + HALO, dim]
  // [4 + KT + HALO]: tids[-1] is ids[k0 - 1], the id before the tile
  int* tids = reinterpret_cast<int*>(rows + (KT + HALO) * dim) + 4;
  __shared__ int start[THREADS];
  __shared__ float show_clk[THREADS - 1][2];  // raw CVM sums of a chunk
  __shared__ __align__(8) uint64_t bar;

  const int t = threadIdx.x;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * kt;
  // nk is 0 only when n_keys is: then the one block owns every segment
  const int nk = static_cast<int>(n_keys - k0 < kt ? n_keys - k0 : kt);
  const int nh = static_cast<int>(n_keys - k0 < kt + HALO ? n_keys - k0
                                                          : kt + HALO);
  const bool first = blockIdx.x == 0;
  const bool last = blockIdx.x == gridDim.x - 1;

  // -- one round of loads: everything is issued before anything is used.
  // The ids from k0 - 4 (k0 on the first tile), so that the id before the
  // tile comes with them, and the rows from k0. TMA takes the 16-byte
  // multiples of both ranges when bulk is set; 4-byte cp.asyncs take the
  // rest (all of it when bulk is not set).
  const int lead = first ? 0 : 4;
  const int n_ids = nh + lead;
  const uint32_t id_bulk = bulk ? (4u * n_ids) & ~15u : 0;
  const uint32_t row_bulk = bulk ? (4u * nh * dim) & ~15u : 0;
  if (bulk && t == 0) {
    mbar_init(&bar);
    mbar_expect_tx(&bar, id_bulk + row_bulk);
    if (id_bulk) {
      bulk_g2s(tids - lead, ids + k0 - lead, id_bulk, &bar);
    }
    if (row_bulk) {
      bulk_g2s(rows, emb + k0 * dim, row_bulk, &bar);
    }
  }
  const bool tails = id_bulk < 4u * n_ids || row_bulk < 4u * nh * dim;
  if (tails) {
    copy_async4<THREADS>(tids - lead, ids + k0 - lead, id_bulk / 4, n_ids);
    copy_async4<THREADS>(rows, emb + k0 * dim, row_bulk / 4, nh * dim);
  }
  __syncthreads();  // the mbarrier is initialised; the loads are in flight
  if (bulk) {
    mbar_wait(&bar, 0);
  }
  if (tails) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // every thread's cp.asyncs have landed
  }

  // -- the owned segments [s_lo, s_hi]
  if (!first && tids[-1] >= n_seg) {
    return;  // a tile of padding owns nothing
  }
  const int s_lo = first ? 0 : tids[-1] + 1;
  const int s_hi =
      last ? n_seg - 1 : (tids[nk - 1] < n_seg ? tids[nk - 1] : n_seg - 1);
  // the owned segment whose keys run on past the tile, or -1; long_run
  // when they run past the halo too
  const int run_on = (!last && tids[nk] == tids[nk - 1] &&
                      tids[nk] < n_seg && tids[nk] >= s_lo)
                         ? tids[nk]
                         : -1;
  const bool long_run =
      run_on >= 0 && tids[nh - 1] == run_on && k0 + nh < n_keys;

  const int out_dim = use_cvm ? dim : dim - cvm_offset;
  const int col0 = use_cvm ? 0 : cvm_offset;
  // (segment, column) steps of a thread through a chunk, column fastest;
  // x / out_dim is umulhi(x, div_magic) (x itself when out_dim is 1)
  const int step_j = out_dim == 1 ? THREADS : __umulhi(THREADS, div_magic);
  const int step_c = THREADS - step_j * out_dim;
  const int j0 = out_dim == 1 ? t : __umulhi(t, div_magic);
  for (int c0 = s_lo; c0 <= s_hi; c0 += THREADS - 1) {
    const int cnt = s_hi - c0 + 1 < THREADS - 1 ? s_hi - c0 + 1 : THREADS - 1;
    // start[i] = lower_bound(tids, nh, c0 + i) for i in [0, cnt]: key k
    // starts the segments (tids[k - 1], tids[k]], position nh the ones
    // after the last key; each entry has exactly one writer
    for (int k = t; k <= nh; k += THREADS) {
      // relative to c0; hi <= cnt, so prev + 1 cannot overflow
      const int prev = (k > 0 || !first ? tids[k - 1] : -1) - c0;
      const int hi = k < nh && tids[k] - c0 < cnt ? tids[k] - c0 : cnt;
      for (int i = prev < 0 ? 0 : prev + 1; prev < hi && i <= hi; ++i) {
        start[i] = k;
      }
    }
    __syncthreads();
    // each output's sum in key order: straight to out, but the CVM
    // columns' raw sums go to show_clk
    float* o = out + static_cast<int64_t>(c0) * out_dim;
    const int jr = long_run ? run_on - c0 : -1;  // finished below
    int j = j0;
    int c = t - j0 * out_dim;
    for (int f = t; f < cnt * out_dim; f += THREADS) {
      const float* p = rows + start[j] * dim + col0 + c;
      const float* e = rows + start[j + 1] * dim + col0 + c;
      float acc = 0.f;
#pragma unroll 1
      for (; p < e; p += dim) {
        acc += *p;
      }
      acc += pad_value;
      if (use_cvm && c < 2) {
        show_clk[j][c] = acc;
      } else if (j != jr) {
        o[f] = acc;
      }
      j += step_j;
      c += step_c;
      if (c >= out_dim) {
        c -= out_dim;
        ++j;
      }
    }
    if (jr >= 0 && jr < cnt) {  // run_on is s_hi: the last chunk
      float acc[kRunCols<THREADS>];
      sum_long_run<THREADS>(emb, ids, k0 + nh, n_keys, dim, run_on,
                            lower_bound(tids, nk, run_on), nh, rows, tids,
                            acc);
#pragma unroll
      for (int i = 0; i < kRunCols<THREADS>; ++i) {
        const int col = t + i * THREADS;  // input column
        if (use_cvm && col < 2) {
          show_clk[jr][col] = acc[i] + pad_value;
        } else if (col >= col0 && col < dim) {
          o[jr * out_dim + col - col0] = acc[i] + pad_value;
        }
      }
    }
    // the CVM columns, one thread a segment
    if (use_cvm) {
      __syncthreads();
      for (int i = t; i < cnt; i += THREADS) {
        const float log_show = logf(show_clk[i][0] + 1.f);
        o[i * out_dim] = log_show;
        o[i * out_dim + 1] = logf(show_clk[i][1] + 1.f) - log_show;
      }
    }
    if (c0 + cnt <= s_hi) {
      __syncthreads();  // start[] and show_clk are rewritten by the next one
    }
  }
}

template <int THREADS, int MIN_BLOCKS>
cudaError_t launch(int64_t tiles, size_t smem, cudaStream_t stream,
                   const float* emb, const int* ids, float* out,
                   int64_t n_keys, int dim, int n_seg, int use_cvm,
                   int cvm_offset, float pad_value, int bulk, int kt,
                   uint32_t div_magic) {
  auto* kernel = seqpool_cvm_fwd_kernel<THREADS, MIN_BLOCKS>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      return e;
    }
  }
  kernel<<<static_cast<unsigned>(tiles), THREADS, smem, stream>>>(
      emb, ids, out, n_keys, dim, n_seg, use_cvm, cvm_offset, pad_value,
      bulk, kt, div_magic);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns a cudaError_t (0 = launched).
// out is [n_seg, use_cvm ? dim : dim - cvm_offset] float32, written whole.
// bulk = 1 only when emb and ids are both 16-byte aligned: it selects the
// TMA load path; 0 takes the 4-byte cp.async path.
int pbx_seqpool_cvm_fwd(const void* emb, const void* ids, void* out,
                        int64_t n_keys, int dim, int64_t n_seg, int use_cvm,
                        int cvm_offset, float pad_value, int bulk,
                        void* stream) {
  if (n_seg <= 0) {
    return 0;
  }
  if (dim < 1 || dim > MAX_DIM || n_keys < 0 || n_seg > INT32_MAX ||
      (use_cvm ? dim < 2 : cvm_offset < 0 || cvm_offset >= dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      (static_cast<size_t>(KT + HALO) * (dim + 1) + 4) * sizeof(float);
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (e != cudaSuccess) {
    return static_cast<int>(e);
  }
  // Tiles of KT keys; fewer keys than that when the keys fit in one wave,
  // so that every SM takes a tile. A multiple of 4 keys keeps each tile's
  // ids and rows 16-byte aligned for TMA.
  const int64_t per_sm = n_keys > sms ? (n_keys + sms - 1) / sms : 1;
  const int kt = per_sm >= KT ? KT : static_cast<int>((per_sm + 3) / 4 * 4);
  const int64_t tiles = n_keys > 0 ? (n_keys + kt - 1) / kt : 1;
  // ceil(2^32 / out_dim) for out_dim > 1: x / out_dim is then the high
  // word of x * div_magic, exactly, for x < 2^32 / out_dim
  const uint32_t out_dim = use_cvm ? dim : dim - cvm_offset;
  const uint32_t div_magic =
      out_dim > 1
          ? static_cast<uint32_t>(((uint64_t{1} << 32) + out_dim - 1) / out_dim)
          : 0;
  // One wave (the serving shape): a block has an SM to itself and takes
  // 512 threads, to spread its outputs thin. More tiles than SMs: blocks of
  // 128 threads, up to 16 an SM, keep many tiles' loads in flight and
  // spend few instructions a tile.
  const auto fn = tiles <= sms ? launch<512, 2> : launch<128, 16>;
  return static_cast<int>(
      fn(tiles, smem, static_cast<cudaStream_t>(stream),
         static_cast<const float*>(emb), static_cast<const int*>(ids),
         static_cast<float*>(out), n_keys, dim, static_cast<int>(n_seg),
         use_cvm, cvm_offset, pad_value, bulk, kt, div_magic));
}

const char* pbx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
