// Sparse push: merge per-key grads by unique row and apply the in-table
// optimizer, for Hopper (sm_90a). Beside it, its boundary kernel
// (merge_offsets_kernel) and the mesh step's merge alone
// (segment_merge_short_kernel and segment_merge_long_kernel, which say
// what they replace).
//
// Replaces the XLA function paddlebox_tpu/ps/device_table.py::ArenaLayout.push
// with ops/sparse_optim.py::apply_update, for every storage type of the
// arena (ops/sparse_push.py::sparse_push_plain is its plain version). For
// each unique u with uniq_mask[u] > 0 (live) and arena row r = uniq_rows[u]:
//
//   merged[c]  = sum of demb[k, c] over the keys k with inverse[k] == u,
//                in ascending k (the order XLA's CPU segment_sum adds in)
//   show, clk += merged[0], merged[1]
//   for each column group (start, width, gated, state offset):
//     mask = !gated || new_show >= embedx_threshold
//     if mask: the group's w and optimizer state take one step of
//              sgd | adagrad | adam (the rules of ops/sparse_optim.py)
//
// A unique that is not live (padding uniques, key 0, unknown keys: all at
// row 0) writes nothing; a masked group keeps w and state untouched.
//
// Storage types (the kernel's template arguments KIND and VAR; KIND picks
// the element type through ArenaType: float, __nv_bfloat16 or int8_t):
// - float32: show/clk are value columns 0, 1.
// - bfloat16: show/clk live in float32 state columns 0, 1 and value
//   columns 0, 1 are left alone; a trained w is stored round-to-nearest-
//   even (__float2bfloat16_rn).
// - int8: as bfloat16, plus one float32 scale a group in state column
//   2 + gi; w = q * scale. After the step, every group of a live row, a
//   masked one too, is requantized at gscale = max(max |new w|, 1e-12) /
//   127 (an IEEE divide, as is new_w / gscale), q = clip(rint(new_w /
//   gscale), -127, 127), rint rounding half to even as jnp.round does;
//   value columns 0, 1 are written 0. The build has no fast-math flags.
// - variable (VAR): the last group is the union group of var_width
//   columns at var_start; the grads are pull-wide (grad_dim = var_start +
//   embedx_dim + expand_dim), so a lane merges for each of its union
//   columns var_start + j both the base grad (column var_start + j, j <
//   embedx_dim) and the expand grad (column var_start + embedx_dim + j,
//   j < expand_dim). An unclaimed row (size code 0 in state column
//   size_col) is claimed by the first of base or expand whose merged grads
//   hold a nonzero (base wins a tie), the union group trains on the grads
//   of the row's code, and a row still unclaimed masks the group. The
//   "any nonzero" is reduced over the unique's G lanes, not the warp.
//
// The dirty mark: given a bitmap `dirty` [cap] (bool, one byte a row; null:
// no mark), every unique u, live or not, stores dirty[uniq_rows[u]] = 1 from
// its group's lane 0, right after round 1 loads the row. That is the
// reference's dirty.at[uniq_rows].set(True) in its device-prep step
// (paddlebox_tpu/trainer/fused_step.py:373, an XLA scatter), here without
// a launch of its own: one byte store a unique beside the ~15.6 MB the push
// moves at the training shape. Live rows are distinct; the padding
// uniques all store the same byte to row 0, which no save reads.
//
// Merging without atomics: the wrapper sorts `inverse` stably on the card
// (`order`, the key positions grouped by unique, ascending within each) and
// merge_offsets_kernel turns the sorted inverse into `offsets` [n_uniq + 1],
// where each unique's keys start in `order`. Every row is then written by
// one group of lanes, and live rows are distinct, so there are no write
// races and the sums do not depend on scheduling: show/clk are exact, the
// rest match the plain version's atomic sums closely, and two launches on
// the same inputs agree bit for bit.
//
// What bounds it on an H100: the latency of dependent loads, not bytes. The
// training shape (B=2048, S=24, D=11, Npad=102,400, ~97k uniques, adagrad)
// moves ~16 MB, ~4.7 us at 3.35 TB/s, but every unique's work is a chain:
// offsets and the row index, then the row, its state and `order`, then the
// grads `order` points at. Each link is a round trip to HBM (the rows are
// scattered over a 185 MB arena). Version 1 gave a unique a warp (11 of 32
// lanes busy at D=11) and walked a chain of six links; ~97k warps ran in
// ~12 waves, each paying the whole chain.
//
// Design (version 3):
// - A group of G lanes holds a unique, and each lane C columns of its row in
//   registers, interleaved (lane l: columns l, l + G, ...; G and C from
//   ops/sparse_push.py::push_geometry, G the smallest power of two with
//   4 G >= D). At D=11, G=4 and C=3: eight uniques a warp, ~12k warps in
//   one or two waves.
// - Three rounds of dependent loads: (1) mask, row, offsets[u], offsets[u+1];
//   (2) the lane's columns of the value row, its part of the state row and
//   the unique's first kKeys `order` entries; (3) the grads those entries
//   point at, summed in ascending key order in float32.
// - A unique with more keys (a hot key: hundreds of copies in a batch)
//   merges kKeys keys a trip: all their grads in flight at once, with the
//   next trip's `order` entries beside them, so a trip costs one round trip
//   (L2 hits in a step: the grads were just written) and not one per key.
//   A first cut that took one key at a time spent 0.17 ms on an H100 on a
//   500-key unique while the rest of the batch took a fraction of that.
// - Group reductions and broadcasts by shuffles within the G lanes (masks of
//   the group's own lanes, so groups of one warp may diverge): the sum of
//   g^2 for adagrad, the new show and clk, the group's state scalars. No
//   shared memory, no barriers.
// - Dead and padding uniques mark their row dirty and leave, the whole
//   group at once. Each lane writes its own columns; the group's lane 0,
//   which alone reads the state scalars, writes show, clk and each group's
//   scalars (adagrad's g2sum, adam's t, int8's scale, the size code). No
//   atomics anywhere.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The split build (ops/_build.py SPLIT): nvcc spends nearly all of this
// file's build on the push kernel's 126 instances (3 storage kinds x 2
// layouts x 7 column counts x 3 optimizers), one after another. Built with
// -DPBX_PUSH_PART=p, p in 0..5, a translation unit holds only the instances
// of kind p / 2 and layout p % 2 and their launcher pbx_push_launch_<p>;
// part 6 holds the rest (the other kernels and the C interface, which calls
// the six launchers). The seven compile at once and link into one library.
// Without PBX_PUSH_PART the file is one translation unit holding every part.
#ifndef PBX_PUSH_PART
#define PBX_PUSH_PART -1
#endif
#define PBX_REST_PART 6
#define PBX_IN_PART(p) (PBX_PUSH_PART < 0 || PBX_PUSH_PART == (p))

namespace {

constexpr int kThreads = 256;  // a block: 256 / G uniques
constexpr int kMaxGroups = 3;  // embed_w, embedx, expand
constexpr int kMaxDim = 256;
constexpr int kMaxCols = 8;    // C: 2 (G = 1, D = 2) to 8 (G = 32, D = 256)
constexpr int kKeys = 8;       // keys of a unique whose grads are in flight
constexpr float kQmax = 127.0f;

enum Optimizer { kSgd = 0, kAdagrad = 1, kAdam = 2 };
enum Kind { kF32 = 0, kBf16 = 1, kInt8 = 2 };

// the element type of each storage kind, and its conversions
template <int KIND> struct ArenaType;
template <> struct ArenaType<kF32> {
  using T = float;
  static __device__ __forceinline__ float load(const T* p) { return *p; }
};
template <> struct ArenaType<kBf16> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ float load(const T* p) {
    return __bfloat162float(*p);
  }
};
template <> struct ArenaType<kInt8> {
  using T = int8_t;
  static __device__ __forceinline__ float load(const T* p) {
    return static_cast<float>(*p);
  }
};

// constants of ops/sparse_optim.py; the (1 - beta) factors are rounded
// from double, as the reference's Python floats are
constexpr float kBeta1 = 0.9f;
constexpr float kBeta2 = 0.999f;
constexpr float kOneMinusBeta1 = static_cast<float>(1.0 - 0.9);
constexpr float kOneMinusBeta2 = static_cast<float>(1.0 - 0.999);
constexpr float kEps = 1e-8f;

// Column groups, contiguous from column 2 to dim. Unused entries have
// start = dim, so a column's group is (col >= start[1]) + (col >= start[2]).
struct Groups {
  int n;
  int start[kMaxGroups];  // first value column
  int width[kMaxGroups];
  int gated[kMaxGroups];  // embedx/expand: trained once show >= threshold
  int soff[kMaxGroups];   // first state column of the optimizer's state
  int scol[kMaxGroups];   // int8: the group's scale column (2 + gi)
};

// read-only inputs are loaded through the read-only path (__ldg)
struct PushArgs {
  void* values;                // [cap, dim] of the storage type
  float* state;                // [cap, state_dim]
  const float* demb;           // [n_keys, grad_dim]
  const int64_t* order;        // [n_keys]
  const int* offsets;          // [n_uniq + 1]
  const int* uniq_rows;        // [n_uniq]
  const float* uniq_mask;      // [n_uniq]
  uint8_t* dirty;              // [cap] or null
  int n_uniq, dim, grad_dim, state_dim, log2g;
  int size_col, embedx_dim, expand_dim;  // variable layout
  float lr, g2sum0, threshold;
  Groups groups;
};

#if PBX_IN_PART(PBX_REST_PART)
// Thread t of the sorted inverse s writes offsets[u] = t for every u in
// (s[t-1], s[t]]; thread t <= upad writes offsets[t] = n_keys when t is past
// the last unique that has keys. Every u in [0, upad] is written once; a
// unique with no keys gets an empty range. Values outside [0, upad) are a
// broken precondition: they are clamped so that no write leaves `offsets`.
__global__ void merge_offsets_kernel(const int* __restrict__ sorted_inv,
                                     int* __restrict__ offsets, int n_keys,
                                     int upad) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n_keys) {
    const int lo = t > 0 ? max(sorted_inv[t - 1], -1) : -1;
    const int hi = min(sorted_inv[t], upad);
    for (int u = lo + 1; u <= hi; ++u) {
      offsets[u] = t;
    }
  }
  if (t <= upad) {
    const int last = n_keys > 0 ? sorted_inv[n_keys - 1] : -1;
    if (t > last) {
      offsets[t] = n_keys;
    }
  }
}

// The requester's gradient merge of the mesh step
// (ops/sparse_push.py::merge_segments, parallel/fused_dp_step.py): g[s, c] =
// the sum of demb[k, c] over the keys k of segment s, the keys grouped by
// segment in `order` and segment s's keys at order[offsets[s] ..
// offsets[s+1]). Device prep's segments are its uniques, in K5's order; the
// host plan's are request positions, in a stable sort of them
// (merge_order). Every row of g is written, a segment with no keys as zeros.
//
// The order of the adds is fixed, in float32, and the same on the CPU
// (ops/sparse_push.py::segment_merge_plain, whose SEGMENT_CHUNK mirrors
// kChunk), so the result is the plain version's bit for bit and does not
// depend on scheduling:
// - a segment of at most kChunk keys sums from 0, its keys one by one in
//   key order;
// - a longer one sums each chunk [lo + j kChunk, lo + (j + 1) kChunk) so,
//   then from 0 the chunks' partial sums in chunk order.
// kChunk is a constant of the function, never derived from the card or the
// grid. At 1,024 or more, every segment of the earlier checks (the longest
// ~1,003 keys) keeps key order, so they hold bit for bit. The reference's
// segment_sum fixes no order either.
//
// Replaces no TPU kernel: the reference's jax.ops.segment_sum (an XLA
// scatter-add, paddlebox_tpu/parallel/fused_dp_step.py:321 and :645), which
// the port keeps off the atomics of index_add_ so that the sums are
// deterministic. On an H100 it is bound by the latency of its dependent
// loads (offsets, then order, then the grads) and, for a hot key, by the
// gather of its scattered rows and its chain of dependent adds, not by its
// bytes (demb read once, g written once: ~10 MB at the training shape,
// 3.0 us).
//
// One memset (the counters), two kernels:
// - segment_merge_short_kernel: a thread a (segment, column) output, summing
//   up to kKeys grads a trip in key order. A segment of more than kLongKeys
//   keys is the long kernel's: its column-0 thread reserves all its chunks
//   in the work list with one atomicAdd (the list's order varies, not what
//   an item sums), and a segment of several chunks its partial slots with
//   another.
// - segment_merge_long_kernel: kLongBlocks persistent blocks, a block a work
//   item (a chunk) at a time. It loads the chunk's `order` entries into
//   shared memory, then, tile by tile, every thread gathers grads into the
//   tile by 4-byte cp.async copies, column-major, and thread c adds column
//   c (and c + kLongThreads) in key order, four keys a 16-byte read. A
//   segment of one chunk writes g; a chunk of a longer one writes its
//   partial, and the last of its segment's chunks to finish (a
//   __threadfence, then an arrival counter: the threadFenceReduction
//   pattern) adds the partials in chunk order and writes g. With no long
//   segment it returns at its first instruction. TMA's tiled copies do not
//   fit the gather: a row is 44 B at D=11, no 16-byte multiple, and the
//   rows are gathered by index.
// The designs tried before this one, and their times, are in PERF.md §6
// (the requester merge's rows). The counters (the work list's and the
// slots' lengths, the arrival counters) are zeroed by the memset of each
// call, so a CUDA graph's replays stay right. Scratch (`work`):
// pbx_segment_merge_scratch words, allocated by the wrapper at the worst
// case for n_keys.
constexpr int kLongKeys = 32;        // a longer segment goes to the long kernel
constexpr int kChunk = 1024;         // keys a chunk (SEGMENT_CHUNK)
constexpr int kLongThreads = 128;    // a long block
constexpr int kLongCols = kMaxDim / kLongThreads;  // columns an adder adds
constexpr int kLongBlocks = 264;     // long blocks: two an H100 SM
constexpr int kTileFloats = 5104;    // a tile of gathered grads (~20 KB)
constexpr int kBatch = 8;            // a thread's copies issued at once
constexpr int kAdds = 32;            // an adder's values loaded at once
constexpr int kHeadWords = 4;        // scratch: items, slots reserved

struct __align__(16) MergeItem {
  int seg;    // its segment
  int start;  // its first key's position in `order`
  int n;      // its keys, 1 to kChunk
  int slot;   // its partial's slot, -1 for a segment of one chunk
};

// The scratch words: the head, the arrival counters (one at each segment's
// first slot), the work items (16-byte aligned) and the partials [slots,
// dim]. A segment of L > kLongKeys keys is ceil(L / kChunk) <= 1 + (L - 1)
// / kChunk items, one of L > kChunk keys as many slots, <= 2 L / kChunk.
struct MergeScratch {
  int64_t slot_cap, item_cap, items_at, partials_at, words;
};

__host__ __device__ inline MergeScratch merge_scratch(int64_t n_keys,
                                                      int dim) {
  MergeScratch s;
  s.slot_cap = 2 * (n_keys / kChunk) + 1;
  s.item_cap = n_keys / (kLongKeys + 1) + n_keys / kChunk + 1;
  s.items_at = (kHeadWords + s.slot_cap + 3) / 4 * 4;
  s.partials_at = s.items_at + 4 * s.item_cap;
  s.words = s.partials_at + s.slot_cap * dim;
  return s;
}

struct MergeWork {
  int* head;          // [0]: items reserved, [1]: slots reserved
  int* arrive;        // [slot_cap]: chunks finished, at a segment's 1st slot
  MergeItem* items;   // [item_cap]
  float* partials;    // [slot_cap, dim]
  int item_cap, slot_cap;
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The work items of segment seg (keys lo..hi), reserved by one thread.
// Beyond the caps (offsets outside [0, n_keys]: a broken precondition)
// nothing is written.
__device__ void reserve_chunks(const MergeWork& w, int seg, int lo, int hi) {
  const int n = hi - lo;
  const int chunks = (n + kChunk - 1) / kChunk;
  const int it = atomicAdd(w.head, chunks);
  const int slot = chunks > 1 ? atomicAdd(w.head + 1, chunks) : -1;
  if (it + chunks > w.item_cap || slot + chunks > w.slot_cap) {
    return;
  }
  for (int j = 0; j < chunks; ++j) {
    w.items[it + j] = MergeItem{seg, lo + j * kChunk,
                                min(kChunk, n - j * kChunk),
                                slot < 0 ? -1 : slot + j};
  }
}

// A thread a (segment, column) output; a segment's column-0 thread
// reserves its chunks when it is long.
__global__ void __launch_bounds__(kThreads)
    segment_merge_short_kernel(const float* __restrict__ demb,
                               const int64_t* __restrict__ order,
                               const int* __restrict__ offsets,
                               float* __restrict__ g, int n_seg, int dim,
                               const MergeWork w) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_seg * dim) {
    return;
  }
  const int seg = t / dim;
  const int col = t - seg * dim;
  const int lo = __ldg(offsets + seg);
  const int hi = __ldg(offsets + seg + 1);
  if (hi - lo > kLongKeys) {
    if (col == 0) {
      reserve_chunks(w, seg, lo, hi);
    }
    return;
  }
  float acc = 0.0f;
  for (int j = lo; j < hi; j += kKeys) {
    const int n = min(kKeys, hi - j);
    float v[kKeys];
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      if (i < n) {
        v[i] = __ldg(demb + __ldg(order + j + i) * dim + col);
      }
    }
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      if (i < n) {
        acc += v[i];
      }
    }
  }
  g[t] = acc;
}

// kLongBlocks blocks of kLongThreads threads (thread c adds columns c,
// c + kLongThreads); `w` as the short kernel left it.
__global__ void __launch_bounds__(kLongThreads)
    segment_merge_long_kernel(const float* __restrict__ demb,
                              const int64_t* __restrict__ order,
                              const int* __restrict__ offsets,
                              float* __restrict__ g, int dim,
                              const MergeWork w) {
  __shared__ int s_row[kChunk];
  __shared__ __align__(16) float s_tile[kTileFloats];
  __shared__ int s_last[2];  // chunks to combine (0: not last), first slot
  if (*w.head == 0) {
    return;  // no long segment: first, before any set-up
  }
  const int tid = threadIdx.x;
  const int n_items = min(*w.head, w.item_cap);
  // 4 more than a multiple of 32: a column starts 16-byte aligned, and
  // the 16-byte reads of one key by eight adders, a column apart, take
  // distinct banks
  const int tile_keys = (min(kChunk, kTileFloats / dim) - 4) / 32 * 32 + 4;
  const int dkey = kLongThreads / dim;  // a thread's copies step so
  const int dcol = kLongThreads - dkey * dim;
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const MergeItem item = w.items[it];
    for (int i = tid; i < item.n; i += kLongThreads) {
      s_row[i] = static_cast<int>(__ldg(order + item.start + i));
    }
    __syncthreads();
    float acc[kLongCols];
#pragma unroll
    for (int cc = 0; cc < kLongCols; ++cc) {
      acc[cc] = 0.0f;
    }
    for (int first = 0; first < item.n; first += tile_keys) {
      // the gather, column-major (column c's keys at c tile_keys on):
      // element e of the tile's rows is key first + e / dim, column e %
      // dim; kBatch rows' indices read, then their copies issued (the
      // reads clamped into s_row and not branched around, so they
      // pipeline)
      const int nk = min(tile_keys, item.n - first);
      const int ne = nk * dim;
      int key = first + tid / dim;
      int col = tid - (tid / dim) * dim;
      for (int e = tid; e < ne; e += kLongThreads * kBatch) {
        int64_t src[kBatch];
        int at[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          src[u] = static_cast<int64_t>(s_row[min(key, kChunk - 1)]) * dim +
                   col;
          at[u] = col * tile_keys + key - first;
          key += dkey;
          col += dcol;
          if (col >= dim) {
            col -= dim;
            ++key;
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (e + kLongThreads * u < ne) {
            cp_async4(s_tile + at[u], demb + src[u]);
          }
        }
      }
      cp_async_wait_all();
      __syncthreads();
#pragma unroll
      for (int cc = 0; cc < kLongCols; ++cc) {
        const int c = tid + cc * kLongThreads;
        if (c >= dim) {
          break;
        }
        // the column's keys, contiguous: kAdds values loaded, four a
        // 16-byte read, then added in key order
        const float* q = s_tile + c * tile_keys;
        float a = acc[cc];
        int i = 0;
        for (; i + kAdds <= nk; i += kAdds) {
          float4 v[kAdds / 4];
#pragma unroll
          for (int u = 0; u < kAdds / 4; ++u) {
            v[u] = reinterpret_cast<const float4*>(q + i)[u];
          }
#pragma unroll
          for (int u = 0; u < kAdds / 4; ++u) {
            a += v[u].x;
            a += v[u].y;
            a += v[u].z;
            a += v[u].w;
          }
        }
        for (; i < nk; ++i) {
          a += q[i];
        }
        acc[cc] = a;
      }
      __syncthreads();  // the tile is refilled next
    }
    // a segment of one chunk: g; else the chunk's partial
    float* out = item.slot < 0
                     ? g + static_cast<int64_t>(item.seg) * dim
                     : w.partials + static_cast<int64_t>(item.slot) * dim;
#pragma unroll
    for (int cc = 0; cc < kLongCols; ++cc) {
      if (tid + cc * kLongThreads < dim) {
        out[tid + cc * kLongThreads] = acc[cc];
      }
    }
    if (item.slot < 0) {
      continue;  // s_row is rewritten after the tile loop's last sync
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int lo = __ldg(offsets + item.seg);
      const int n = __ldg(offsets + item.seg + 1) - lo;
      const int all = (n + kChunk - 1) / kChunk;
      const int first = item.slot - (item.start - lo) / kChunk;
      s_last[0] = atomicAdd(w.arrive + first, 1) == all - 1 ? all : 0;
      s_last[1] = first;
    }
    __syncthreads();
    const int chunks = s_last[0];
    const int first = s_last[1];
    __syncthreads();  // s_last is rewritten by the next item
    if (chunks == 0) {
      continue;
    }
    __threadfence();
    for (int col = tid; col < dim; col += kLongThreads) {
      // kBatch partials loaded, then added in chunk order
      const float* p = w.partials + static_cast<int64_t>(first) * dim + col;
      float sum = 0.0f;
      for (int j0 = 0; j0 < chunks; j0 += kBatch) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          v[u] = __ldcg(p + static_cast<int64_t>(min(j0 + u, chunks - 1)) *
                                dim);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (j0 + u < chunks) {
            sum += v[u];
          }
        }
      }
      g[static_cast<int64_t>(item.seg) * dim + col] = sum;
    }
  }
}

#endif  // PBX_IN_PART(PBX_REST_PART)

__device__ __forceinline__ int pick(int gi, int a0, int a1, int a2) {
  return gi == 0 ? a0 : (gi == 1 ? a1 : a2);
}

__device__ __forceinline__ float pick(int gi, const float (&a)[kMaxGroups]) {
  return gi == 0 ? a[0] : (gi == 1 ? a[1] : a[2]);
}

template <int KIND, int VAR, int C, int OPT>
__global__ void __launch_bounds__(kThreads)
    sparse_push_kernel(const PushArgs a) {
  using Arena = ArenaType<KIND>;
  using T = typename Arena::T;
  constexpr bool kStats = KIND != kF32;  // show/clk in state columns 0, 1
  // the float32 arena without the variable layout keeps the code of the
  // kernel before the storage variants (its column tests inline, its
  // grads dim wide): so compiled, its every instance keeps that kernel's
  // registers and spills none (kernel_versions.py push --ptxas-only)
  constexpr bool kPlain = KIND == kF32 && !VAR;
  const Groups& gr = a.groups;
  const int G = 1 << a.log2g;
  const int u = (blockIdx.x * kThreads + threadIdx.x) >> a.log2g;
  const int l = threadIdx.x & (G - 1);
  if (u >= a.n_uniq) {
    return;  // whole groups: G divides kThreads
  }
  const unsigned gmask =
      G == 32 ? 0xffffffffu
              : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));

  // round 1
  const float live = __ldg(a.uniq_mask + u);
  const int row = __ldg(a.uniq_rows + u);
  const int k0 = __ldg(a.offsets + u);
  const int kend = __ldg(a.offsets + u + 1);
  if (a.dirty != nullptr && l == 0) {
    a.dirty[row] = 1;
  }
  if (!(live > 0.0f)) {
    return;  // a dead unique writes nothing; its whole group leaves here
  }

  // round 2: the row's columns, the state, the first `order` entries
  T* vrow = static_cast<T*>(a.values) + static_cast<int64_t>(row) * a.dim;
  float* srow = a.state + static_cast<int64_t>(row) * a.state_dim;
  // the union group (variable layout): its index and first column
  const int vg = gr.n - 1;
  const int vstart = VAR ? gr.start[vg] : a.dim;
  float qs[kMaxGroups] = {1.0f, 1.0f, 1.0f};  // int8: each group's scale
  if constexpr (KIND == kInt8) {
#pragma unroll
    for (int gi = 0; gi < kMaxGroups; ++gi) {
      if (gi < gr.n) {
        qs[gi] = srow[gr.scol[gi]];
      }
    }
  }
  float w[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = l + c * G;
    if (col >= a.dim) {
      w[c] = 0.0f;
    } else if (kStats && col < 2) {
      w[c] = srow[col];
    } else {
      w[c] = Arena::load(vrow + col);
      if constexpr (KIND == kInt8) {
        if (col >= 2) {
          w[c] *= pick((col >= gr.start[1]) + (col >= gr.start[2]), qs);
        }
      }
    }
  }
  float cur = 0.0f;  // variable: the row's size code
  if constexpr (VAR) {
    cur = srow[a.size_col];
  }
  float scal[kMaxGroups] = {0.0f, 0.0f, 0.0f};  // lane 0: g2sum or t
  if constexpr (OPT != kSgd) {
#pragma unroll
    for (int gi = 0; gi < kMaxGroups; ++gi) {
      if (l == 0 && gi < gr.n) {
        scal[gi] = srow[gr.soff[gi]];
      }
    }
  }
  float m[OPT == kAdam ? C : 1];
  float v[OPT == kAdam ? C : 1];
  if constexpr (OPT == kAdam) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = l + c * G;
      m[c] = 0.0f;
      v[c] = 0.0f;
      if (col >= 2 && col < a.dim) {
        const int gi = (col >= gr.start[1]) + (col >= gr.start[2]);
        const int start = pick(gi, gr.start[0], gr.start[1], gr.start[2]);
        const int width = pick(gi, gr.width[0], gr.width[1], gr.width[2]);
        const float* st = srow + pick(gi, gr.soff[0], gr.soff[1], gr.soff[2]);
        m[c] = st[1 + col - start];
        v[c] = st[1 + width + col - start];
      }
    }
  }
  // the grad columns each register merges: its own column (a union column
  // j: the base grad, j < embedx_dim), and under VAR the expand grad at
  // column + embedx_dim (j < expand_dim)
  bool own[kPlain ? 1 : C];
  bool has_e[kPlain ? 1 : C];
#pragma unroll
  for (int c = 0; c < (kPlain ? 0 : C); ++c) {
    const int col = l + c * G;
    own[c] = col < a.dim && (col < vstart || col - vstart < a.embedx_dim);
    has_e[c] = VAR && col >= vstart && col < a.dim &&
             col - vstart < a.expand_dim;
  }
  // the unique's first kKeys entries of `order`, the same in every lane
  int ord[kKeys];
#pragma unroll
  for (int q = 0; q < kKeys; ++q) {
    ord[q] = k0 + q < kend ? static_cast<int>(__ldg(a.order + k0 + q)) : 0;
  }

  // round 3: the merge, kKeys keys a trip with all their grads in flight
  // and the next trip's `order` entries beside them; added in ascending
  // key order
  float acc[C];
  float acc_e[VAR ? C : 1];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    acc[c] = 0.0f;
    if constexpr (VAR) {
      acc_e[c] = 0.0f;
    }
  }
  for (int j0 = k0; j0 < kend; j0 += kKeys) {
    float x[kKeys][C];
    float y[VAR ? kKeys : 1][VAR ? C : 1];
#pragma unroll
    for (int q = 0; q < kKeys; ++q) {
      const float* grow =
          a.demb +
          static_cast<int64_t>(ord[q]) * (kPlain ? a.dim : a.grad_dim) + l;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const bool mine = kPlain ? l + c * G < a.dim : own[c];
        x[q][c] = j0 + q < kend && mine ? __ldg(grow + c * G) : 0.0f;
        if constexpr (VAR) {
          y[q][c] = j0 + q < kend && has_e[c]
                        ? __ldg(grow + c * G + a.embedx_dim)
                        : 0.0f;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kKeys; ++q) {
      const int j = j0 + kKeys + q;
      ord[q] = j < kend ? static_cast<int>(__ldg(a.order + j)) : 0;
    }
#pragma unroll
    for (int q = 0; q < kKeys; ++q) {
      if (j0 + q < kend) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          acc[c] += x[q][c];
          if constexpr (VAR) {
            acc_e[c] += y[q][c];
          }
        }
      }
    }
  }

  // show and clk sit in column 0 (lane 0) and column 1 (lane 1, or lane 0's
  // second column when G == 1)
  const float mine = w[0] + acc[0] * live;
  const float new_show = __shfl_sync(gmask, mine, 0, G);
  const float new_clk =
      G == 1 ? w[1] + acc[1] * live : __shfl_sync(gmask, mine, 1, G);
  if constexpr (OPT != kSgd) {
#pragma unroll
    for (int gi = 0; gi < kMaxGroups; ++gi) {
      scal[gi] = __shfl_sync(gmask, scal[gi], 0, G);
    }
  }
  // the variable claim: does the base (bit 0) or the expand (bit 1) grad
  // hold a nonzero, over the group's lanes; then the union columns take
  // the grads of the row's code
  float code = cur;
  if constexpr (VAR) {
    int nz = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = l + c * G;
      if (col >= vstart && col < a.dim) {
        nz |= (acc[c] != 0.0f ? 1 : 0) | (acc_e[c] != 0.0f ? 2 : 0);
      }
    }
    for (int off = G >> 1; off > 0; off >>= 1) {
      nz |= __shfl_xor_sync(gmask, nz, off, G);
    }
    if (cur == 0.0f) {
      code = (nz & 1) ? 1.0f : ((nz & 2) ? 2.0f : 0.0f);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = l + c * G;
      if (col >= vstart && col < a.dim) {
        acc[c] = code == 1.0f ? acc[c] : (code == 2.0f ? acc_e[c] : 0.0f);
      }
    }
  }
  // a group trains (bit gi) when it is not gated below the threshold
  // and, the union group, when its row is claimed
  int trains = 0;
#pragma unroll
  for (int gi = 0; gi < kMaxGroups; ++gi) {
    trains |= (gi < gr.n && (!gr.gated[gi] || new_show >= a.threshold) &&
               (!VAR || gi != vg || code > 0.0f))
              << gi;
  }
  float sq[kMaxGroups] = {0.0f, 0.0f, 0.0f};  // adagrad: sum of g^2
  if constexpr (OPT == kAdagrad) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = l + c * G;
      if (col >= 2 && col < a.dim) {
        const int gi = (col >= gr.start[1]) + (col >= gr.start[2]);
        const float g2 = acc[c] * acc[c];
        sq[0] += gi == 0 ? g2 : 0.0f;
        sq[1] += gi == 1 ? g2 : 0.0f;
        sq[2] += gi == 2 ? g2 : 0.0f;
      }
    }
    for (int off = G >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int gi = 0; gi < kMaxGroups; ++gi) {
        sq[gi] += __shfl_xor_sync(gmask, sq[gi], off, G);
      }
    }
  }

  // each lane steps its own trained columns (a masked one keeps w)
  float nw[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = l + c * G;
    nw[c] = w[c];
    if (col < 2 || col >= a.dim) {
      continue;
    }
    const int gi = (col >= gr.start[1]) + (col >= gr.start[2]);
    if (!((trains >> gi) & 1)) {
      continue;
    }
    const float g = acc[c];
    if constexpr (OPT == kSgd) {
      nw[c] = w[c] - a.lr * g;
    } else if constexpr (OPT == kAdagrad) {
      const float scale = sqrtf(a.g2sum0 / (a.g2sum0 + pick(gi, scal)));
      nw[c] = w[c] - a.lr * scale * g;
    } else {
      const int start = pick(gi, gr.start[0], gr.start[1], gr.start[2]);
      const int width = pick(gi, gr.width[0], gr.width[1], gr.width[2]);
      float* st = srow + pick(gi, gr.soff[0], gr.soff[1], gr.soff[2]);
      const float t = pick(gi, scal) + 1.0f;
      const float mn = m[c] * kBeta1 + kOneMinusBeta1 * g;
      const float vn = v[c] * kBeta2 + kOneMinusBeta2 * (g * g);
      const float mhat = mn / (1.0f - powf(kBeta1, t));
      const float vhat = vn / (1.0f - powf(kBeta2, t));
      nw[c] = w[c] - a.lr * mhat / (sqrtf(vhat) + kEps);
      st[1 + col - start] = mn;
      st[1 + width + col - start] = vn;
    }
    if constexpr (KIND == kF32) {
      vrow[col] = nw[c];
    } else if constexpr (KIND == kBf16) {
      vrow[col] = __float2bfloat16_rn(nw[c]);
    }
  }
  // int8: every group requantized at the scale of its new max
  float gs[kMaxGroups] = {0.0f, 0.0f, 0.0f};
  if constexpr (KIND == kInt8) {
    float mx[kMaxGroups] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = l + c * G;
      if (col >= 2 && col < a.dim) {
        const int gi = (col >= gr.start[1]) + (col >= gr.start[2]);
        const float x = fabsf(nw[c]);
        mx[0] = gi == 0 ? fmaxf(mx[0], x) : mx[0];
        mx[1] = gi == 1 ? fmaxf(mx[1], x) : mx[1];
        mx[2] = gi == 2 ? fmaxf(mx[2], x) : mx[2];
      }
    }
    for (int off = G >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int gi = 0; gi < kMaxGroups; ++gi) {
        mx[gi] = fmaxf(mx[gi], __shfl_xor_sync(gmask, mx[gi], off, G));
      }
    }
#pragma unroll
    for (int gi = 0; gi < kMaxGroups; ++gi) {
      gs[gi] = __fdiv_rn(fmaxf(mx[gi], 1e-12f), kQmax);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = l + c * G;
      if (col >= a.dim) {
        continue;
      }
      float q = 0.0f;
      if (col >= 2) {
        const int gi = (col >= gr.start[1]) + (col >= gr.start[2]);
        q = fminf(fmaxf(rintf(__fdiv_rn(nw[c], pick(gi, gs))), -kQmax),
                  kQmax);
      }
      vrow[col] = static_cast<int8_t>(q);
    }
  }
  if (l == 0) {
    if constexpr (kStats) {
      srow[0] = new_show;
      srow[1] = new_clk;
    } else {
      vrow[0] = new_show;
      vrow[1] = new_clk;
    }
#pragma unroll
    for (int gi = 0; gi < kMaxGroups; ++gi) {
      if (gi >= gr.n) {
        continue;
      }
      if constexpr (KIND == kInt8) {
        srow[gr.scol[gi]] = gs[gi];
      }
      if constexpr (OPT != kSgd) {
        if ((trains >> gi) & 1) {
          srow[gr.soff[gi]] =
              OPT == kAdagrad
                  ? scal[gi] + sq[gi] / static_cast<float>(gr.width[gi])
                  : scal[gi] + 1.0f;
        }
      }
    }
    if constexpr (VAR) {
      srow[a.size_col] = code;
    }
  }
}

template <int KIND, int VAR, int C>
void launch_opt(const PushArgs& a, int opt, int blocks, cudaStream_t s) {
  if (opt == kSgd) {
    sparse_push_kernel<KIND, VAR, C, kSgd><<<blocks, kThreads, 0, s>>>(a);
  } else if (opt == kAdagrad) {
    sparse_push_kernel<KIND, VAR, C, kAdagrad><<<blocks, kThreads, 0, s>>>(a);
  } else {
    sparse_push_kernel<KIND, VAR, C, kAdam><<<blocks, kThreads, 0, s>>>(a);
  }
}

template <int KIND, int VAR>
void launch_cols(const PushArgs& a, int cols, int opt, int blocks,
                 cudaStream_t s) {
  switch (cols) {
    case 2: launch_opt<KIND, VAR, 2>(a, opt, blocks, s); break;
    case 3: launch_opt<KIND, VAR, 3>(a, opt, blocks, s); break;
    case 4: launch_opt<KIND, VAR, 4>(a, opt, blocks, s); break;
    case 5: launch_opt<KIND, VAR, 5>(a, opt, blocks, s); break;
    case 6: launch_opt<KIND, VAR, 6>(a, opt, blocks, s); break;
    case 7: launch_opt<KIND, VAR, 7>(a, opt, blocks, s); break;
    default: launch_opt<KIND, VAR, 8>(a, opt, blocks, s); break;
  }
}

}  // namespace

// pbx_push_launch_<p>: the push of storage kind p / 2 and layout p % 2;
// `a` points at the PushArgs that pbx_sparse_push filled
#define PBX_PUSH_LAUNCHER(P, KIND, VAR)                                     \
  extern "C" void pbx_push_launch_##P(const void* a, int cols, int opt,     \
                                      int blocks, cudaStream_t s) {         \
    launch_cols<KIND, VAR>(*static_cast<const PushArgs*>(a), cols, opt,     \
                           blocks, s);                                      \
  }
#if PBX_IN_PART(0)
PBX_PUSH_LAUNCHER(0, kF32, 0)
#endif
#if PBX_IN_PART(1)
PBX_PUSH_LAUNCHER(1, kF32, 1)
#endif
#if PBX_IN_PART(2)
PBX_PUSH_LAUNCHER(2, kBf16, 0)
#endif
#if PBX_IN_PART(3)
PBX_PUSH_LAUNCHER(3, kBf16, 1)
#endif
#if PBX_IN_PART(4)
PBX_PUSH_LAUNCHER(4, kInt8, 0)
#endif
#if PBX_IN_PART(5)
PBX_PUSH_LAUNCHER(5, kInt8, 1)
#endif

#if PBX_IN_PART(PBX_REST_PART)
extern "C" {

void pbx_push_launch_0(const void*, int, int, int, cudaStream_t);
void pbx_push_launch_1(const void*, int, int, int, cudaStream_t);
void pbx_push_launch_2(const void*, int, int, int, cudaStream_t);
void pbx_push_launch_3(const void*, int, int, int, cudaStream_t);
void pbx_push_launch_4(const void*, int, int, int, cudaStream_t);
void pbx_push_launch_5(const void*, int, int, int, cudaStream_t);

// sorted_inv [n_keys] int32 (inverse sorted), offsets [upad + 1] int32.
// Returns a cudaError_t (0 = launched).
int pbx_merge_offsets(const void* sorted_inv, void* offsets, int64_t n_keys,
                      int64_t upad, void* stream) {
  if (n_keys < 0 || upad < 0 || n_keys > INT32_MAX - kThreads ||
      upad >= INT32_MAX - kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t threads = n_keys > upad + 1 ? n_keys : upad + 1;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  merge_offsets_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sorted_inv), static_cast<int*>(offsets),
      static_cast<int>(n_keys), static_cast<int>(upad));
  return static_cast<int>(cudaGetLastError());
}

// The int32 words of scratch pbx_segment_merge takes for n_keys keys of
// dim columns (its worst case, whatever the segments).
int64_t pbx_segment_merge_scratch(int64_t n_keys, int dim) {
  return merge_scratch(n_keys < 0 ? 0 : n_keys, dim).words;
}

// demb [n_keys, dim] float32, order [n_keys] int64, offsets [n_seg + 1]
// int32 (non-decreasing, within [0, n_keys]: a precondition, not checked),
// g [n_seg, dim] float32 (every row written), work [work_words] int32
// scratch, 16-byte aligned, at least pbx_segment_merge_scratch(n_keys,
// dim) words. Returns a cudaError_t (0 = launched).
int pbx_segment_merge(const void* demb, const void* order,
                      const void* offsets, void* g, void* work,
                      int64_t work_words, int64_t n_keys, int64_t n_seg,
                      int dim, void* stream) {
  if (n_seg < 0 || n_keys < 0 || n_keys > INT32_MAX || dim < 1 ||
      dim > kMaxDim || n_seg * dim > INT32_MAX - kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MergeScratch sc = merge_scratch(n_keys, dim);
  if (work_words < sc.words ||
      reinterpret_cast<uintptr_t>(work) % alignof(MergeItem) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_seg == 0) {
    return 0;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  int* base = static_cast<int*>(work);
  const MergeWork w{base, base + kHeadWords,
                    reinterpret_cast<MergeItem*>(base + sc.items_at),
                    reinterpret_cast<float*>(base + sc.partials_at),
                    static_cast<int>(sc.item_cap),
                    static_cast<int>(sc.slot_cap)};
  const cudaError_t rc = cudaMemsetAsync(
      base, 0, (kHeadWords + sc.slot_cap) * sizeof(int), s);
  if (rc != cudaSuccess) {
    return static_cast<int>(rc);
  }
  const int blocks = static_cast<int>((n_seg * dim + kThreads - 1) /
                                      kThreads);
  const auto* d = static_cast<const float*>(demb);
  const auto* o = static_cast<const int64_t*>(order);
  const auto* off = static_cast<const int*>(offsets);
  auto* out = static_cast<float*>(g);
  segment_merge_short_kernel<<<blocks, kThreads, 0, s>>>(
      d, o, off, out, static_cast<int>(n_seg), dim, w);
  segment_merge_long_kernel<<<kLongBlocks, kLongThreads, 0, s>>>(
      d, o, off, out, dim, w);
  return static_cast<int>(cudaGetLastError());
}

// values [cap, dim] of the storage kind, state [cap, state_dim] float32,
// demb [n_keys, grad_dim] float32, order [n_keys] int64, offsets
// [n_uniq + 1] int32, uniq_rows [n_uniq] int32, uniq_mask [n_uniq], dirty
// [cap] bytes or null. desc is ops/sparse_push.py::group_desc: kDescHead
// ints (kind, variable, n_groups, stat_off, size_col, embedx_dim,
// expand_dim, grad_dim), then (start, width, gated, soff, scol) a group.
// group_lanes (G) and cols (C) come from push_geometry. Returns a
// cudaError_t (0 = launched).
int pbx_sparse_push(void* values, void* state, const void* demb,
                    const void* order, const void* offsets,
                    const void* uniq_rows, const void* uniq_mask,
                    void* dirty, int64_t n_uniq, int dim, int state_dim,
                    const int* desc, int desc_len, int opt, int group_lanes,
                    int cols, float lr, float g2sum0, float threshold,
                    void* stream) {
  constexpr int kDescHead = 8;
  constexpr int kDescGroup = 5;
  if (n_uniq <= 0) {
    return 0;
  }
  if (desc_len < kDescHead) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int kind = desc[0];
  const int var = desc[1];
  const int n_groups = desc[2];
  const int stat_off = desc[3];
  int log2g = 0;
  while ((1 << log2g) < group_lanes && log2g < 5) {
    ++log2g;
  }
  if (kind < kF32 || kind > kInt8 || (var != 0 && var != 1) ||
      dim < 2 || dim > kMaxDim || state_dim < 1 || n_groups < 0 ||
      n_groups > kMaxGroups || desc_len != kDescHead + kDescGroup * n_groups ||
      opt < kSgd || opt > kAdam || n_uniq > INT32_MAX / 32 ||
      (1 << log2g) != group_lanes || cols < 2 || cols > kMaxCols ||
      group_lanes * cols < dim ||
      stat_off != (kind == kF32 ? 0 : kind == kBf16 ? 2 : 2 + n_groups) ||
      stat_off > state_dim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PushArgs a{};
  a.values = values;
  a.state = static_cast<float*>(state);
  a.demb = static_cast<const float*>(demb);
  a.order = static_cast<const int64_t*>(order);
  a.offsets = static_cast<const int*>(offsets);
  a.uniq_rows = static_cast<const int*>(uniq_rows);
  a.uniq_mask = static_cast<const float*>(uniq_mask);
  a.dirty = static_cast<uint8_t*>(dirty);
  a.n_uniq = static_cast<int>(n_uniq);
  a.dim = dim;
  a.grad_dim = desc[7];
  a.state_dim = state_dim;
  a.log2g = log2g;
  a.size_col = desc[4];
  a.embedx_dim = desc[5];
  a.expand_dim = desc[6];
  a.lr = lr;
  a.g2sum0 = g2sum0;
  a.threshold = threshold;
  a.groups.n = n_groups;
  int next = 2;  // groups tile the columns 2..dim in order
  for (int gi = 0; gi < kMaxGroups; ++gi) {
    a.groups.start[gi] = dim;
    if (gi >= n_groups) {
      continue;
    }
    const int* g = desc + kDescHead + kDescGroup * gi;
    a.groups.start[gi] = g[0];
    a.groups.width[gi] = g[1];
    a.groups.gated[gi] = g[2];
    a.groups.soff[gi] = g[3];
    a.groups.scol[gi] = g[4];
    if (g[0] != next || g[1] < 1 || g[3] < stat_off ||
        (opt != kSgd && g[3] >= state_dim) ||
        g[4] != (kind == kInt8 ? 2 + gi : -1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    next += g[1];
  }
  if (next != dim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (var) {
    const int vg = n_groups - 1;
    if (n_groups < 1 || !a.groups.gated[vg] || a.embedx_dim < 1 ||
        a.expand_dim < 1 ||
        a.groups.width[vg] != max(a.embedx_dim, a.expand_dim) ||
        a.grad_dim != a.groups.start[vg] + a.embedx_dim + a.expand_dim ||
        a.grad_dim > kMaxDim || a.size_col < stat_off ||
        a.size_col >= state_dim) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (a.grad_dim != dim || a.size_col != -1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = static_cast<int>(
      (n_uniq * group_lanes + kThreads - 1) / kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  using Launch = void (*)(const void*, int, int, int, cudaStream_t);
  static const Launch kLaunch[3][2] = {
      {pbx_push_launch_0, pbx_push_launch_1},
      {pbx_push_launch_2, pbx_push_launch_3},
      {pbx_push_launch_4, pbx_push_launch_5}};
  kLaunch[kind][var](&a, cols, opt, blocks, s);
  return static_cast<int>(cudaGetLastError());
}

const char* pbx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
#endif  // PBX_IN_PART(PBX_REST_PART)
