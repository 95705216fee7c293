// In-step key dedup (K5) and mirror probe (K6) of device-prep training, for
// Hopper (sm_90a).
//
// K5 replaces the XLA function paddlebox_tpu/ps/device_index.py::
// device_dedup. Each uint64 key k is packed as the int64 k ^ (1 << 63), so
// that signed order is the unsigned key order, and sorted stably with its
// positions by a hand-written LSD radix sort (8 digits of 8 bits, the digits
// of k itself; the reference's sort is XLA's):
//
//   radix_hist_kernel       a block packs its tile of kSortTile (2048) keys
//                           into buffer A with positions iota, and adds the
//                           tile's histogram of all eight digits to a global
//                           [8][256] one (shared, then global atomics). The
//                           last block (an atomic ticket) writes the plan: a
//                           digit is active unless one bin holds all n keys,
//                           and each active pass reads the buffer the one
//                           before it wrote (A or B). Nothing goes back to
//                           the host, so K5 is capturable in a CUDA graph.
//   radix_tile_count_kernel per digit: each tile's 256 digit counts (returns
//                           at once if the digit is inactive, as does:)
//   radix_scatter_kernel    per digit: a block takes each bin's base (the
//                           keys of smaller digits, and of this digit in
//                           earlier tiles), ranks its keys stably (a warp
//                           walks 256 consecutive keys 32 at a time, peers by
//                           a vote on each digit bit, per-warp bin counters
//                           in shared memory, then scanned over warps),
//                           stages the tile in shared memory in digit order
//                           and writes it to the other buffer, a bin's keys
//                           at consecutive addresses.
//
// Two kernels then number the sorted keys, reading the buffer the plan names:
//
//   dedup_count_kernel  a block counts the first occurrences in its tile of
//                       kTile sorted keys (i == 0 or sorted[i] != sorted[i-1])
//   dedup_write_kernel  a block sums the counts of the tiles before it and
//                       of all tiles (n_uniq), scans its own flags, and for
//                       sorted position i with uid u (flags up to i, less 1)
//                       writes order[i] = sidx[i], inverse[sidx[i]] = u and,
//                       at a first occurrence, uniq[u] = sorted[i] ^ (1 << 63)
//                       and offsets[u] = i; its grid-stride part writes
//                       uniq[u] = 0 for u in [n_uniq, n) and offsets[u] = n
//                       for u in [n_uniq, n]; block 0 writes n_uniq.
//
// uids follow ascending unsigned key order (key 0, the padding, is uid 0 when
// present) and, every pass being stable, `order` lists each unique's
// positions in ascending order: it is the push's merge order and `offsets`
// its boundaries, so the push sums each unique's keys as the host-prep path
// does. One unstable pass would leave `inverse` right and break that order.
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
// The walk (probe_home, probe_walk) has two callers:
//
//   probe_kernel              one thread a key of any list (K6 alone)
//   dedup_write_probe_kernel  dedup_write_kernel that also walks each unique
//                             it numbers, from the key it holds in a
//                             register, and writes rows[u] and found[u]
//                             (row 0, not found for u in [n_uniq, n)): the
//                             reference's dedup and probe of one jitted
//                             step (trainer/fused_step.py:362-363) with no
//                             probe launch and no second read of the keys.
//                             A thread first issues the home-quad load of
//                             each unique it holds, then compares; only a
//                             key whose run goes on loads again.
//
// What bounds them on an H100, at the training shape (N = Npad = 102,400,
// ~97k uniques, a 2^24 + 64-slot mirror at load 0.25): K5 must read the keys
// and write inverse, uniques, order and offsets, ~3.3 MB, ~1 us at 3.35 TB/s;
// it takes 1 + 2 * 8 + 2 launches and a memset whatever the keys, and each
// active digit moves the keys and positions through HBM (L2) twice more.
// At N = 102,400 the sort has 50 tiles, so its passes run on 50 of the 132
// SMs and are latency-bound: each block's work is a chain of loads, votes,
// shared atomics and barriers, which the design keeps short (every load of
// a pass issued at once, votes before atomics, one scan for both bin
// bases). Keys in [1, 2^22] have three active digits: the other ten pass
// launches return at once, ~1 us each in a graph, the design's floor. The
// write pass scatters `inverse` 4 bytes at a time. K6 reads ~1.2 quads a
// key, 16 bytes each, scattered over a 268 MB table, so each key is one or
// two dependent round trips to HBM; one thread a key puts all of them in
// flight at once (~400 blocks, one wave). Folded into the write pass (100
// blocks, four keys a thread) it saves a launch (~1 us in a graph) and the
// uniques' read (~0.8 MB); its round trips overlap the pass's scan, but a
// warp still waits for the longest walk of its 128 keys.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;                   // consecutive sorted keys a thread
constexpr int kTile = kThreads * kItems;    // sorted keys a block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kSign = -0x7fffffffffffffffLL - 1;  // 1 << 63

// The radix sort: a block of kSortThreads takes kSortTile keys, each warp
// kWarpKeys consecutive ones, kRounds rounds of 32.
constexpr int kDigits = 8;
constexpr int kBins = 256;                  // 8-bit digits
constexpr int kSortThreads = kBins;         // a thread a bin
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortTile = 2048;
constexpr int kWarpKeys = kSortTile / kSortWarps;
constexpr int kRounds = kWarpKeys / 32;
static_assert(kWarpKeys % 32 == 0, "whole rounds");
// The histogram pass takes the same tiles with more threads: its cost is
// the latency of a vote and a shared atomic for each of a key's 8 digits.
constexpr int kHistThreads = 1024;
constexpr int kHistWarpKeys = kSortTile / (kHistThreads / 32);
constexpr int kHistRounds = kHistWarpKeys / 32;
static_assert(kHistWarpKeys % 32 == 0, "whole rounds");
// The plan, int32: digit d active (kPlanActive + d), the buffer pass d reads
// (kPlanSrc + d; 0 = A, 1 = B), the buffer holding the sorted keys.
constexpr int kPlanActive = 0;
constexpr int kPlanSrc = kDigits;
constexpr int kPlanFinal = 2 * kDigits;

// Exclusive scan of v over a block of kBlock threads; *total receives the
// block's sum. Every thread must call it; `warp_sums` is kBlock / 32 values
// of shared memory, free again when it returns.
template <int kBlock, typename T>
__device__ T block_exclusive_scan(T v, T* warp_sums, T* total) {
  constexpr int kBlockWarps = kBlock / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kBlockWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kBlockWarps) warp_sums[lane] = w;  // inclusive
  }
  __syncthreads();
  const T before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kBlockWarps - 1];
  __syncthreads();
  return before + x - v;
}

// Digit d of the key whose packed form is `packed`.
__device__ __forceinline__ int digit_of(long long packed, int d) {
  return static_cast<int>(
      (static_cast<unsigned long long>(packed ^ kSign) >> (8 * d)) & 0xFF);
}

// Lanes of a warp whose digit equals this lane's (dig < kBins), this lane
// included: a vote on each of the digit's bits (faster on an H100 than
// __match_any_sync).
__device__ __forceinline__ unsigned warp_peers(int dig) {
  unsigned peers = __ballot_sync(kFull, dig < kBins);
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool on = (dig >> b) & 1;
    const unsigned m = __ballot_sync(kFull, on);
    peers &= on ? m : ~m;
  }
  return peers;
}

// For each j, adds one to counts[base[j] + dig[j]] for each lane that holds
// a key (dig[j] < kBins; the lanes that hold none are the warp's last). A
// warp whose keys share one digit, as the high digits of small keys do,
// adds once; other warps add lane by lane. All the votes come first, so
// they overlap and only the atomics are left.
template <int kN>
__device__ __forceinline__ void warp_count(int* counts, const int (&dig)[kN],
                                           const int (&base)[kN]) {
  int first[kN], held[kN];
  bool same[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) first[j] = __shfl_sync(kFull, dig[j], 0);
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    same[j] = __all_sync(kFull, dig[j] == first[j] || dig[j] == kBins);
    held[j] = __popc(__ballot_sync(kFull, dig[j] < kBins));
  }
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    if (same[j]) {
      if ((threadIdx.x & 31) == 0 && first[j] < kBins) {
        atomicAdd(&counts[base[j] + first[j]], held[j]);
      }
    } else if (dig[j] < kBins) {
      atomicAdd(&counts[base[j] + dig[j]], 1);
    }
  }
}

__global__ void __launch_bounds__(kHistThreads)
radix_hist_kernel(const long long* __restrict__ raw, int n,
                  long long* __restrict__ keys_a, int* __restrict__ pos_a,
                  int* __restrict__ hist, unsigned* __restrict__ ticket,
                  int* __restrict__ plan) {
  __shared__ int counts[kDigits * kBins];
  __shared__ bool last;
  for (int j = threadIdx.x; j < kDigits * kBins; j += kHistThreads) {
    counts[j] = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int i0 = blockIdx.x * kSortTile + (threadIdx.x >> 5) * kHistWarpKeys;
  unsigned long long k[kHistRounds];  // all the warp's keys in flight at once
#pragma unroll
  for (int r = 0; r < kHistRounds; ++r) {
    const int i = i0 + r * 32 + lane;
    k[r] = i < n ? static_cast<unsigned long long>(__ldg(&raw[i])) : 0;
  }
  int base[kDigits];
#pragma unroll
  for (int d = 0; d < kDigits; ++d) base[d] = d * kBins;
#pragma unroll
  for (int r = 0; r < kHistRounds; ++r) {
    const int i = i0 + r * 32 + lane;
    int dig[kDigits];
#pragma unroll
    for (int d = 0; d < kDigits; ++d) {
      dig[d] = i < n ? static_cast<int>((k[r] >> (8 * d)) & 0xFF) : kBins;
    }
    if (i < n) {
      keys_a[i] = static_cast<long long>(k[r]) ^ kSign;
      pos_a[i] = i;
    }
    warp_count(counts, dig, base);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kDigits * kBins; j += kHistThreads) {
    if (counts[j] != 0) atomicAdd(&hist[j], counts[j]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // The last block sees every block's histogram: a digit whose one bin
  // holds all n keys orders nothing and is skipped.
  __threadfence();
  int c[kDigits];
#pragma unroll
  for (int d = 0; d < kDigits; ++d) {
    c[d] = threadIdx.x < kBins ? __ldcg(&hist[d * kBins + threadIdx.x]) : 0;
  }
  unsigned active = 0;
#pragma unroll
  for (int d = 0; d < kDigits; ++d) {
    if (!__syncthreads_or(c[d] == n)) active |= 1u << d;
  }
  if (threadIdx.x == 0) {
    int src = 0;
    for (int d = 0; d < kDigits; ++d) {
      const int on = (active >> d) & 1;
      plan[kPlanActive + d] = on;
      plan[kPlanSrc + d] = src;
      src ^= on;  // an inactive pass moves nothing
    }
    plan[kPlanFinal] = src;
  }
}

__global__ void __launch_bounds__(kSortThreads)
radix_tile_count_kernel(const int* __restrict__ plan, int d,
                        const long long* keys_a, const long long* keys_b,
                        int n, int* __restrict__ tile_counts) {
  if (!__ldg(&plan[kPlanActive + d])) return;  // block-uniform
  const long long* src = __ldg(&plan[kPlanSrc + d]) ? keys_b : keys_a;
  __shared__ int counts[kBins];
  counts[threadIdx.x] = 0;
  const int i0 = blockIdx.x * kSortTile + (threadIdx.x >> 5) * kWarpKeys;
  int dig[kRounds];  // all the warp's keys in flight at once
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = i0 + r * 32 + (threadIdx.x & 31);
    dig[r] = i < n ? digit_of(__ldg(&src[i]), d) : kBins;
  }
  int base[kRounds] = {};
  __syncthreads();
  warp_count(counts, dig, base);
  __syncthreads();
  tile_counts[blockIdx.x * kBins + threadIdx.x] = counts[threadIdx.x];
}

__global__ void __launch_bounds__(kSortThreads)
radix_scatter_kernel(const int* __restrict__ plan, int d,
                     long long* keys_a, long long* keys_b, int* pos_a,
                     int* pos_b, int n, const int* __restrict__ hist,
                     const int* __restrict__ tile_counts) {
  if (!__ldg(&plan[kPlanActive + d])) return;  // block-uniform
  const bool from_b = __ldg(&plan[kPlanSrc + d]) != 0;
  const long long* in_k = from_b ? keys_b : keys_a;
  const int* in_p = from_b ? pos_b : pos_a;
  long long* out_k = from_b ? keys_a : keys_b;
  int* out_p = from_b ? pos_a : pos_b;

  __shared__ long long warp_sums[kSortWarps];
  // per-warp bin counts, then offsets (first the earlier tiles' sums)
  __shared__ __align__(16) int warp_bins[kSortWarps][kBins];
  __shared__ int tile_start[kBins];  // the bin's first slot in the tile
  __shared__ int out_start[kBins];   // the tile's bin's first output slot
  __shared__ long long staged_keys[kSortTile];
  __shared__ int staged_pos[kSortTile];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bin = threadIdx.x;
  const int tile0 = blockIdx.x * kSortTile;
  const int i0 = tile0 + warp * kWarpKeys;

  // all the warp's keys in flight at once
  long long key[kRounds];
  int pos[kRounds], dig[kRounds], rank[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = i0 + r * 32 + lane;
    key[r] = i < n ? __ldg(&in_k[i]) : 0;
    pos[r] = i < n ? __ldg(&in_p[i]) : 0;
    dig[r] = i < n ? digit_of(key[r], d) : kBins;
  }

  // where the tile's bin starts in the output: the keys with a smaller digit,
  // then those with this digit in earlier tiles; and in the tile
  // (the earlier tiles' counts: kGroups groups of threads each sum a share
  // of the tiles, four bins a thread in one 16-byte load a tile)
  constexpr int kQuads = kBins / 4;
  constexpr int kGroups = kSortThreads / kQuads;
  const int4* quads = reinterpret_cast<const int4*>(tile_counts);
  int4 acc = make_int4(0, 0, 0, 0);
#pragma unroll 8
  for (int t = threadIdx.x / kQuads; t < static_cast<int>(blockIdx.x);
       t += kGroups) {
    const int4 c = __ldg(&quads[t * kQuads + threadIdx.x % kQuads]);
    acc.x += c.x;
    acc.y += c.y;
    acc.z += c.z;
    acc.w += c.w;
  }
  reinterpret_cast<int4*>(&warp_bins[0][0])[threadIdx.x] = acc;
  const int below = __ldg(&hist[d * kBins + bin]);
  const int mine = __ldg(&tile_counts[blockIdx.x * kBins + bin]);
  __syncthreads();
  int earlier = 0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    earlier += (&warp_bins[0][0])[g * kBins + bin];
  }
  // both scans over the bins in one: the keys of smaller digits in the
  // high half, the tile's in the low half (a tile's count never carries)
  long long ignored;
  const long long both = block_exclusive_scan<kSortThreads>(
      (static_cast<long long>(below) << 32) | mine, warp_sums, &ignored);
  tile_start[bin] = static_cast<int>(both & 0xffffffff);
  out_start[bin] = static_cast<int>(both >> 32) + earlier;
  for (int j = threadIdx.x; j < kSortWarps * kBins; j += kSortThreads) {
    (&warp_bins[0][0])[j] = 0;
  }
  __syncthreads();

  // stable ranks in the warp: a key follows the warp's earlier keys of its
  // digit, those of earlier rounds and of lower lanes in its round. The
  // votes of all rounds come first; then, round by round, each lane reads
  // its digit's count and the digit's lowest lane adds the round's keys.
  const unsigned lower = (1u << lane) - 1;
  int* counts = warp_bins[warp];
  unsigned peers[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) peers[r] = warp_peers(dig[r]);
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const bool held = dig[r] < kBins;
    const int seen = held ? counts[dig[r]] : 0;
    __syncwarp();
    if (held && (peers[r] & lower) == 0) {
      counts[dig[r]] = seen + __popc(peers[r]);
    }
    __syncwarp();
    rank[r] = seen + __popc(peers[r] & lower);
  }
  __syncthreads();
  // each bin's warps in order: counts -> the warp's first slot in the bin
  int run = 0;
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w) {
    const int c = warp_bins[w][bin];
    warp_bins[w][bin] = run;
    run += c;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (dig[r] < kBins) {
      const int slot = tile_start[dig[r]] + counts[dig[r]] + rank[r];
      staged_keys[slot] = key[r];
      staged_pos[slot] = pos[r];
    }
  }
  __syncthreads();
  // the tile in digit order: a bin's keys go to consecutive addresses
  const int tile_n = min(kSortTile, n - tile0);
#pragma unroll
  for (int r = 0; r < kSortTile / kSortThreads; ++r) {
    const int j = r * kSortThreads + threadIdx.x;
    if (j < tile_n) {
      const long long k = staged_keys[j];
      const int g = digit_of(k, d);
      const int dst = out_start[g] + j - tile_start[g];
      out_k[dst] = k;
      out_p[dst] = staged_pos[j];
    }
  }
}

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  return x;
}

// K6's walk, in two parts. probe_home gives key k's home slot (k != 0),
// Map64::hash(k) & mask; the caller loads the quad there itself, so that a
// thread can put the home loads of all its keys in flight before it
// compares any of them. probe_walk, given that quad, walks on a quad at a
// time to the match, to the first empty quad or to `window` quads, and
// returns (row, 1) on a match, else (0, 0).
__device__ __forceinline__ size_t probe_home(unsigned long long k,
                                             uint32_t mask) {
  const uint32_t lo = static_cast<uint32_t>(k);
  const uint32_t hi = static_cast<uint32_t>(k >> 32);
  return fmix32(hi ^ fmix32(lo)) & mask;
}

__device__ __forceinline__ int2 probe_walk(const int4* __restrict__ tab,
                                           int window, unsigned long long k,
                                           size_t start, int4 q) {
  const uint32_t lo = static_cast<uint32_t>(k);
  const uint32_t hi = static_cast<uint32_t>(k >> 32);
  for (int j = 1;; ++j) {
    if (q.x == -1 && q.y == -1) return make_int2(0, 0);  // the run ends
    if (static_cast<uint32_t>(q.x) == hi &&
        static_cast<uint32_t>(q.y) == lo) {
      return make_int2(q.z, 1);
    }
    if (j == window) return make_int2(0, 0);
    q = __ldg(&tab[start + j]);
  }
}

// The mirror that dedup_write_probe_kernel resolves the uniques against,
// and its outputs.
struct Mirror {
  const int4* tab;
  uint32_t mask;
  int window;
  int* rows;
  bool* found;
};

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
dedup_count_kernel(const int* __restrict__ plan, const long long* keys_a,
                   const long long* keys_b, int n,
                   int* __restrict__ tile_counts) {
  __shared__ int warp_sums[kWarps];
  const long long* sorted = __ldg(&plan[kPlanFinal]) ? keys_b : keys_a;
  long long keys[kItems];
  const int i0 = blockIdx.x * kTile + threadIdx.x * kItems;
  const int count = __popc(first_flags(sorted, n, i0, keys));
  int total;
  block_exclusive_scan<kThreads>(count, warp_sums, &total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

// The write pass; with kProbe it also resolves each unique it numbers
// against the mirror m.
template <bool kProbe>
__device__ __forceinline__ void dedup_write(
    const int* __restrict__ plan, const long long* keys_a,
    const long long* keys_b, const int* pos_a, const int* pos_b, int n,
    const int* __restrict__ tile_counts, int n_tiles,
    int* __restrict__ inverse, long long* __restrict__ uniq,
    int64_t* __restrict__ order, int* __restrict__ offsets,
    int* __restrict__ n_uniq_out, const Mirror& m) {
  __shared__ int warp_sums[kWarps];
  const bool in_b = __ldg(&plan[kPlanFinal]) != 0;
  const long long* sorted = in_b ? keys_b : keys_a;
  const int* sidx = in_b ? pos_b : pos_a;
  // the uniques of the tiles before this one, and of all tiles
  int before = 0, all = 0;
  for (int t = threadIdx.x; t < n_tiles; t += kThreads) {
    const int c = __ldg(&tile_counts[t]);
    all += c;
    if (t < static_cast<int>(blockIdx.x)) before += c;
  }
  int n_uniq, prefix;
  block_exclusive_scan<kThreads>(all, warp_sums, &n_uniq);
  block_exclusive_scan<kThreads>(before, warp_sums, &prefix);

  long long keys[kItems];
  const int i0 = blockIdx.x * kTile + threadIdx.x * kItems;
  const unsigned flags = first_flags(sorted, n, i0, keys);
  // the home quads of the thread's non-zero uniques, all in flight before
  // the scan and before any compare (a home slot is at most mask < 2^32:
  // held as 64 bits, the four of them cost a spill)
  unsigned walks = 0;
  uint32_t start[kItems];
  int4 q[kItems];
  if (kProbe) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const unsigned long long k =
          static_cast<unsigned long long>(keys[j] ^ kSign);
      if (((flags >> j) & 1u) && k != 0) {
        walks |= 1u << j;
        start[j] = probe_home(k, m.mask);
        q[j] = __ldg(&m.tab[start[j]]);
      }
    }
  }
  int ignored;
  int seen = prefix + block_exclusive_scan<kThreads>(__popc(flags),
                                                     warp_sums, &ignored);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = i0 + j;
    if (i < n) {
      const bool first = (flags >> j) & 1u;
      seen += first;
      const int u = seen - 1;
      const int p = __ldg(&sidx[i]);
      order[i] = p;
      inverse[p] = u;
      if (first) {
        const long long k = keys[j] ^ kSign;
        uniq[u] = k;
        offsets[u] = i;
        if (kProbe) {
          const int2 hit =
              ((walks >> j) & 1u)
                  ? probe_walk(m.tab, m.window,
                               static_cast<unsigned long long>(k), start[j],
                               q[j])
                  : make_int2(0, 0);
          m.rows[u] = hit.x;
          m.found[u] = hit.y != 0;
        }
      }
    }
  }
  // the tail past the last unique
  for (int u = blockIdx.x * kThreads + threadIdx.x; u <= n;
       u += gridDim.x * kThreads) {
    if (u >= n_uniq) {
      offsets[u] = n;
      if (u < n) {
        uniq[u] = 0;
        if (kProbe) {
          m.rows[u] = 0;
          m.found[u] = false;
        }
      }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *n_uniq_out = n_uniq;
}

__global__ void __launch_bounds__(kThreads)
dedup_write_kernel(const int* __restrict__ plan, const long long* keys_a,
                   const long long* keys_b, const int* pos_a,
                   const int* pos_b, int n,
                   const int* __restrict__ tile_counts, int n_tiles,
                   int* __restrict__ inverse, long long* __restrict__ uniq,
                   int64_t* __restrict__ order, int* __restrict__ offsets,
                   int* __restrict__ n_uniq_out) {
  dedup_write<false>(plan, keys_a, keys_b, pos_a, pos_b, n, tile_counts,
                     n_tiles, inverse, uniq, order, offsets, n_uniq_out,
                     Mirror{});
}

__global__ void __launch_bounds__(kThreads)
dedup_write_probe_kernel(const int* __restrict__ plan,
                         const long long* keys_a, const long long* keys_b,
                         const int* pos_a, const int* pos_b, int n,
                         const int* __restrict__ tile_counts, int n_tiles,
                         int* __restrict__ inverse,
                         long long* __restrict__ uniq,
                         int64_t* __restrict__ order,
                         int* __restrict__ offsets,
                         int* __restrict__ n_uniq_out, Mirror m) {
  dedup_write<true>(plan, keys_a, keys_b, pos_a, pos_b, n, tile_counts,
                    n_tiles, inverse, uniq, order, offsets, n_uniq_out, m);
}

__global__ void __launch_bounds__(kThreads)
probe_kernel(const int4* __restrict__ tab, uint32_t mask, int window,
             const long long* __restrict__ keys,
             const int* __restrict__ n_valid, int n, int* __restrict__ rows,
             bool* __restrict__ found) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int limit = n_valid != nullptr ? __ldg(n_valid) : n;
  int2 hit = make_int2(0, 0);
  if (i < limit) {
    const unsigned long long k =
        static_cast<unsigned long long>(__ldg(&keys[i]));
    if (k != 0) {
      const size_t start = probe_home(k, mask);
      hit = probe_walk(tab, window, k, start, __ldg(&tab[start]));
    }
  }
  rows[i] = hit.x;
  found[i] = hit.y != 0;
}

bool bad_size(int64_t n) { return n <= 0 || n >= INT32_MAX - kSortTile; }

// The mirror's precondition: every walk stays in the table's n_slots.
bool bad_mirror(int64_t n_slots, int64_t mask, int window) {
  return mask < 0 || mask >= (int64_t(1) << 32) || window < 1 ||
         mask + window > n_slots;
}

// The count pass, then the write pass (with `m`, the fused one).
int number(const void* keys_ab, const void* pos_ab, const void* plan,
           int64_t n, void* tile_counts, void* inverse, void* uniq,
           void* order, void* offsets, void* n_uniq, const Mirror* m,
           void* stream) {
  const int tiles = static_cast<int>((n + kTile - 1) / kTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* keys_a = static_cast<const long long*>(keys_ab);
  const int* pos_a = static_cast<const int*>(pos_ab);
  const int* p = static_cast<const int*>(plan);
  dedup_count_kernel<<<tiles, kThreads, 0, s>>>(
      p, keys_a, keys_a + n, static_cast<int>(n),
      static_cast<int*>(tile_counts));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m == nullptr) {
    dedup_write_kernel<<<tiles, kThreads, 0, s>>>(
        p, keys_a, keys_a + n, pos_a, pos_a + n, static_cast<int>(n),
        static_cast<const int*>(tile_counts), tiles,
        static_cast<int*>(inverse), static_cast<long long*>(uniq),
        static_cast<int64_t*>(order), static_cast<int*>(offsets),
        static_cast<int*>(n_uniq));
  } else {
    dedup_write_probe_kernel<<<tiles, kThreads, 0, s>>>(
        p, keys_a, keys_a + n, pos_a, pos_a + n, static_cast<int>(n),
        static_cast<const int*>(tile_counts), tiles,
        static_cast<int*>(inverse), static_cast<long long*>(uniq),
        static_cast<int64_t*>(order), static_cast<int*>(offsets),
        static_cast<int*>(n_uniq), *m);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pbx_dedup_tile() { return kTile; }
int pbx_dedup_sort_tile() { return kSortTile; }
int pbx_dedup_sort_bins() { return kBins; }
int pbx_dedup_digits() { return kDigits; }

// K5's sort. keys [n] int64 (the uint64 keys); keys_ab [2, n] int64 and
// pos_ab [2, n] int32, buffers A and B; hist [kDigits * kBins + 1] int32
// scratch (the histogram and the last block's ticket, zeroed here);
// tile_counts [ceil(n / kSortTile) * kBins] int32 scratch; writes the plan
// [2 * kDigits + 1] int32. The packed keys end sorted, with their positions,
// in the buffer plan[kPlanFinal] names. Returns a cudaError_t (0 =
// launched).
int pbx_dedup_sort(const void* keys, int64_t n, void* keys_ab, void* pos_ab,
                   void* hist, void* tile_counts, void* plan, void* stream) {
  if (bad_size(n)) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = static_cast<int>((n + kSortTile - 1) / kSortTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* keys_a = static_cast<long long*>(keys_ab);
  long long* keys_b = keys_a + n;
  int* pos_a = static_cast<int*>(pos_ab);
  int* pos_b = pos_a + n;
  int* h = static_cast<int*>(hist);
  int* counts = static_cast<int*>(tile_counts);
  int* p = static_cast<int*>(plan);
  cudaError_t err = cudaMemsetAsync(
      h, 0, (kDigits * kBins + 1) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  radix_hist_kernel<<<tiles, kHistThreads, 0, s>>>(
      static_cast<const long long*>(keys), static_cast<int>(n), keys_a, pos_a,
      h, reinterpret_cast<unsigned*>(h + kDigits * kBins), p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int d = 0; d < kDigits; ++d) {
    radix_tile_count_kernel<<<tiles, kSortThreads, 0, s>>>(
        p, d, keys_a, keys_b, static_cast<int>(n), counts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    radix_scatter_kernel<<<tiles, kSortThreads, 0, s>>>(
        p, d, keys_a, keys_b, pos_a, pos_b, static_cast<int>(n), h, counts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// K5's numbering of pbx_dedup_sort's result (keys_ab, pos_ab, plan);
// tile_counts [ceil(n / kTile)] int32 scratch; writes inverse [n] int32,
// uniq [n] int64, order [n] int64, offsets [n + 1] int32 and n_uniq [1]
// int32. Returns a cudaError_t (0 = launched).
int pbx_dedup_number(const void* keys_ab, const void* pos_ab,
                     const void* plan, int64_t n, void* tile_counts,
                     void* inverse, void* uniq, void* order, void* offsets,
                     void* n_uniq, void* stream) {
  if (bad_size(n)) return static_cast<int>(cudaErrorInvalidValue);
  return number(keys_ab, pos_ab, plan, n, tile_counts, inverse, uniq, order,
                offsets, n_uniq, nullptr, stream);
}

// pbx_dedup_number, whose write pass also resolves each unique against the
// mirror tab [n_slots, 4] int32: writes rows [n] int32 and found [n] bool,
// as pbx_device_probe of uniq with n_valid = n_uniq would. Returns a
// cudaError_t (0 = launched).
int pbx_dedup_number_probe(const void* keys_ab, const void* pos_ab,
                           const void* plan, int64_t n, void* tile_counts,
                           void* inverse, void* uniq, void* order,
                           void* offsets, void* n_uniq, const void* tab,
                           int64_t n_slots, int64_t mask, int window,
                           void* rows, void* found, void* stream) {
  if (bad_size(n) || bad_mirror(n_slots, mask, window)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Mirror m{static_cast<const int4*>(tab), static_cast<uint32_t>(mask),
                 window, static_cast<int*>(rows), static_cast<bool*>(found)};
  return number(keys_ab, pos_ab, plan, n, tile_counts, inverse, uniq, order,
                offsets, n_uniq, &m, stream);
}

// tab [n_slots, 4] int32, keys [n] int64, n_valid [1] int32 or null (all n
// keys valid); writes rows [n] int32 and found [n] bool. Returns a
// cudaError_t (0 = launched).
int pbx_device_probe(const void* tab, int64_t n_slots, int64_t mask,
                     int window, const void* keys, const void* n_valid,
                     int64_t n, void* rows, void* found, void* stream) {
  if (n <= 0 || n >= INT32_MAX - kThreads ||
      bad_mirror(n_slots, mask, window)) {
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
