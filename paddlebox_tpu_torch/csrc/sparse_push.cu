// Sparse push: merge per-key grads by unique row and apply the in-table
// optimizer, for Hopper (sm_90a).
//
// Replaces the XLA function paddlebox_tpu/ps/device_table.py::ArenaLayout.push
// with ops/sparse_optim.py::apply_update, for the float32 arena. For each
// unique u with uniq_mask[u] > 0 (live) and arena row r = uniq_rows[u]:
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
// - Dead and padding uniques run the same code with an empty merge and
//   write nothing. Each lane writes its own columns; the group's lane 0,
//   which alone reads the state scalars, writes show, clk and each group's
//   scalar (adagrad's g2sum, adam's t). No atomics anywhere.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a block: 256 / G uniques
constexpr int kMaxGroups = 3;  // embed_w, embedx, expand
constexpr int kMaxDim = 256;
constexpr int kMaxCols = 8;    // C: 2 (G = 1, D = 2) to 8 (G = 32, D = 256)
constexpr int kKeys = 8;       // keys of a unique whose grads are in flight

enum Optimizer { kSgd = 0, kAdagrad = 1, kAdam = 2 };

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
  int soff[kMaxGroups];   // first state column
};

// read-only inputs are loaded through the read-only path (__ldg)
struct PushArgs {
  float* values;               // [cap, dim]
  float* state;                // [cap, state_dim]
  const float* demb;           // [n_keys, dim]
  const int64_t* order;        // [n_keys]
  const int* offsets;          // [n_uniq + 1]
  const int* uniq_rows;        // [n_uniq]
  const float* uniq_mask;      // [n_uniq]
  uint8_t* dirty;              // [cap] or null
  int n_uniq, dim, state_dim, log2g;
  float lr, g2sum0, threshold;
  Groups groups;
};

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

__device__ __forceinline__ int pick(int gi, int a0, int a1, int a2) {
  return gi == 0 ? a0 : (gi == 1 ? a1 : a2);
}

__device__ __forceinline__ float pick(int gi, const float (&a)[kMaxGroups]) {
  return gi == 0 ? a[0] : (gi == 1 ? a[1] : a[2]);
}

template <int C, int OPT>
__global__ void __launch_bounds__(kThreads)
    sparse_push_kernel(const PushArgs a) {
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
  const int k1 = __ldg(a.offsets + u + 1);
  const bool act = live > 0.0f;
  const int kend = act ? k1 : k0;  // a dead unique merges nothing
  if (a.dirty != nullptr && l == 0) {
    a.dirty[row] = 1;
  }

  // round 2: the row's columns, the state, the first `order` entries
  float* vrow = a.values + static_cast<int64_t>(row) * a.dim;
  float* srow = a.state + static_cast<int64_t>(row) * a.state_dim;
  float w[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = l + c * G;
    w[c] = col < a.dim ? vrow[col] : 0.0f;
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
#pragma unroll
  for (int c = 0; c < C; ++c) {
    acc[c] = 0.0f;
  }
  for (int j0 = k0; j0 < kend; j0 += kKeys) {
    float x[kKeys][C];
#pragma unroll
    for (int q = 0; q < kKeys; ++q) {
      const float* grow = a.demb + static_cast<int64_t>(ord[q]) * a.dim + l;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        x[q][c] = j0 + q < kend && l + c * G < a.dim ? __ldg(grow + c * G)
                                                     : 0.0f;
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
  if (!act) {
    return;  // after the group's last shuffle
  }

  // each lane writes its own trained columns
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = l + c * G;
    if (col < 2 || col >= a.dim) {
      continue;
    }
    const int gi = (col >= gr.start[1]) + (col >= gr.start[2]);
    if (pick(gi, gr.gated[0], gr.gated[1], gr.gated[2]) &&
        !(new_show >= a.threshold)) {
      continue;
    }
    const float g = acc[c];
    if constexpr (OPT == kSgd) {
      vrow[col] = w[c] - a.lr * g;
    } else if constexpr (OPT == kAdagrad) {
      const float scale = sqrtf(a.g2sum0 / (a.g2sum0 + pick(gi, scal)));
      vrow[col] = w[c] - a.lr * scale * g;
    } else {
      const int start = pick(gi, gr.start[0], gr.start[1], gr.start[2]);
      const int width = pick(gi, gr.width[0], gr.width[1], gr.width[2]);
      float* st = srow + pick(gi, gr.soff[0], gr.soff[1], gr.soff[2]);
      const float t = pick(gi, scal) + 1.0f;
      const float mn = m[c] * kBeta1 + kOneMinusBeta1 * g;
      const float vn = v[c] * kBeta2 + kOneMinusBeta2 * (g * g);
      const float mhat = mn / (1.0f - powf(kBeta1, t));
      const float vhat = vn / (1.0f - powf(kBeta2, t));
      vrow[col] = w[c] - a.lr * mhat / (sqrtf(vhat) + kEps);
      st[1 + col - start] = mn;
      st[1 + width + col - start] = vn;
    }
  }
  if (l == 0) {
    vrow[0] = new_show;
    vrow[1] = new_clk;
    if constexpr (OPT != kSgd) {
#pragma unroll
      for (int gi = 0; gi < kMaxGroups; ++gi) {
        if (gi < gr.n && (!gr.gated[gi] || new_show >= a.threshold)) {
          srow[gr.soff[gi]] =
              OPT == kAdagrad
                  ? scal[gi] + sq[gi] / static_cast<float>(gr.width[gi])
                  : scal[gi] + 1.0f;
        }
      }
    }
  }
}

template <int C>
void launch_cols(const PushArgs& a, int opt, int blocks, cudaStream_t s) {
  if (opt == kSgd) {
    sparse_push_kernel<C, kSgd><<<blocks, kThreads, 0, s>>>(a);
  } else if (opt == kAdagrad) {
    sparse_push_kernel<C, kAdagrad><<<blocks, kThreads, 0, s>>>(a);
  } else {
    sparse_push_kernel<C, kAdam><<<blocks, kThreads, 0, s>>>(a);
  }
}

}  // namespace

extern "C" {

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

// values [cap, dim], state [cap, state_dim], demb [n_keys, dim], order
// [n_keys] int64, offsets [n_uniq + 1] int32, uniq_rows [n_uniq] int32,
// uniq_mask [n_uniq], dirty [cap] bytes or null; group_desc is a host
// array of n_groups x (start, width, gated, soff); group_lanes (G) and cols
// (C) come from push_geometry. Returns a cudaError_t (0 = launched).
int pbx_sparse_push(void* values, void* state, const void* demb,
                    const void* order, const void* offsets,
                    const void* uniq_rows, const void* uniq_mask,
                    void* dirty, int64_t n_uniq, int dim, int state_dim,
                    int n_groups, const int* group_desc, int opt,
                    int group_lanes, int cols, float lr, float g2sum0,
                    float threshold, void* stream) {
  if (n_uniq <= 0) {
    return 0;
  }
  int log2g = 0;
  while ((1 << log2g) < group_lanes && log2g < 5) {
    ++log2g;
  }
  if (dim < 2 || dim > kMaxDim || state_dim < 1 || n_groups < 0 ||
      n_groups > kMaxGroups || opt < kSgd || opt > kAdam ||
      n_uniq > INT32_MAX / 32 || (1 << log2g) != group_lanes || cols < 2 ||
      cols > kMaxCols || group_lanes * cols < dim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PushArgs a{};
  a.values = static_cast<float*>(values);
  a.state = static_cast<float*>(state);
  a.demb = static_cast<const float*>(demb);
  a.order = static_cast<const int64_t*>(order);
  a.offsets = static_cast<const int*>(offsets);
  a.uniq_rows = static_cast<const int*>(uniq_rows);
  a.uniq_mask = static_cast<const float*>(uniq_mask);
  a.dirty = static_cast<uint8_t*>(dirty);
  a.n_uniq = static_cast<int>(n_uniq);
  a.dim = dim;
  a.state_dim = state_dim;
  a.log2g = log2g;
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
    a.groups.start[gi] = group_desc[4 * gi];
    a.groups.width[gi] = group_desc[4 * gi + 1];
    a.groups.gated[gi] = group_desc[4 * gi + 2];
    a.groups.soff[gi] = group_desc[4 * gi + 3];
    if (a.groups.start[gi] != next || a.groups.width[gi] < 1 ||
        a.groups.soff[gi] < 0 ||
        (opt != kSgd && a.groups.soff[gi] >= state_dim)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    next += a.groups.width[gi];
  }
  if (next != dim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = static_cast<int>(
      (n_uniq * group_lanes + kThreads - 1) / kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (cols) {
    case 2: launch_cols<2>(a, opt, blocks, s); break;
    case 3: launch_cols<3>(a, opt, blocks, s); break;
    case 4: launch_cols<4>(a, opt, blocks, s); break;
    case 5: launch_cols<5>(a, opt, blocks, s); break;
    case 6: launch_cols<6>(a, opt, blocks, s); break;
    case 7: launch_cols<7>(a, opt, blocks, s); break;
    default: launch_cols<8>(a, opt, blocks, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* pbx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
