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
// Merging without atomics: the wrapper sorts `inverse` stably on the card
// and passes `order` (key positions grouped by unique, ascending within
// each) and `offsets` [n_uniq + 1]. Every row is then written by one warp,
// and real rows are unique, so there are no write races and the sums do
// not depend on scheduling: show/clk are exact, the rest match the plain
// version's atomic sums closely.
//
// What bounds it on an H100: bytes. The training shape (B=2048, S=24,
// D=11, Npad=102,400, ~98k uniques, adagrad with 2 state columns) reads
// 4.5 MB of grads and ~1.2 MB of order/offsets/rows/mask, and reads and
// writes ~98k rows of values and state (~10 MB): ~16 MB, ~4.8 us at
// 3.35 TB/s. The rows are scattered over the arena, so each warp waits on
// a chain of dependent loads (offsets -> order -> grads, rows -> values);
// many warps in flight hide that latency.
//
// Design: one warp per unique, lanes over columns. A lane sums its column
// over the unique's keys, the warp shares the merged row through shared
// memory (a group's mean of g^2 and the gate on the new show need other
// lanes' columns), reads every value it needs before any lane writes, then
// writes its own columns; one lane writes the shared scalars (show, clk,
// adagrad's g2sum, adam's t).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;      // warps a block, one unique each
constexpr int kMaxGroups = 3;  // embed_w, embedx, expand
constexpr int kMaxDim = 256;

enum Optimizer { kSgd = 0, kAdagrad = 1, kAdam = 2 };

// constants of ops/sparse_optim.py; the (1 - beta) factors are rounded
// from double, as the reference's Python floats are
constexpr float kBeta1 = 0.9f;
constexpr float kBeta2 = 0.999f;
constexpr float kOneMinusBeta1 = static_cast<float>(1.0 - 0.9);
constexpr float kOneMinusBeta2 = static_cast<float>(1.0 - 0.999);
constexpr float kEps = 1e-8f;

struct Groups {
  int n;
  int start[kMaxGroups];  // first value column
  int width[kMaxGroups];
  int gated[kMaxGroups];  // embedx/expand: trained once show >= threshold
  int soff[kMaxGroups];   // first state column
};

__global__ void __launch_bounds__(kWarps * 32)
    sparse_push_kernel(float* __restrict__ values, float* __restrict__ state,
                       const float* __restrict__ demb,
                       const int* __restrict__ order,
                       const int* __restrict__ offsets,
                       const int* __restrict__ uniq_rows,
                       const float* __restrict__ uniq_mask, int n_uniq,
                       int dim, int state_dim, Groups groups, int opt,
                       float lr, float g2sum0, float threshold) {
  extern __shared__ float merged_all[];  // kWarps x dim
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * kWarps + warp;
  if (u >= n_uniq) {
    return;
  }
  const float live = uniq_mask[u];
  if (!(live > 0.0f)) {
    return;
  }
  float* merged = merged_all + warp * dim;
  const int k0 = offsets[u];
  const int k1 = offsets[u + 1];
  for (int c = lane; c < dim; c += 32) {
    float acc = 0.0f;
    for (int j = k0; j < k1; ++j) {
      acc += demb[static_cast<int64_t>(order[j]) * dim + c];
    }
    merged[c] = acc;
  }
  __syncwarp();
  float* vrow = values + static_cast<int64_t>(uniq_rows[u]) * dim;
  float* srow = state + static_cast<int64_t>(uniq_rows[u]) * state_dim;
  const float new_show = vrow[0] + merged[0] * live;
  const float new_clk = vrow[1] + merged[1] * live;
  // the shared scalar of each group's state (adagrad g2sum, adam t), read
  // by every lane before lane 0 writes it
  float scalar[kMaxGroups];
  float sumsq[kMaxGroups];
  bool on[kMaxGroups];
#pragma unroll
  for (int gi = 0; gi < kMaxGroups; ++gi) {
    if (gi >= groups.n) {
      break;
    }
    on[gi] = !groups.gated[gi] || new_show >= threshold;
    scalar[gi] = opt == kSgd ? 0.0f : srow[groups.soff[gi]];
    float s = 0.0f;
    if (opt == kAdagrad) {
      for (int c = 0; c < groups.width[gi]; ++c) {
        const float g = merged[groups.start[gi] + c];
        s += g * g;
      }
    }
    sumsq[gi] = s;
  }
  __syncwarp();
#pragma unroll
  for (int gi = 0; gi < kMaxGroups; ++gi) {
    if (gi >= groups.n) {
      break;
    }
    if (!on[gi]) {
      continue;
    }
    const int start = groups.start[gi];
    const int width = groups.width[gi];
    float* st = srow + groups.soff[gi];
    if (opt == kSgd) {
      for (int c = lane; c < width; c += 32) {
        vrow[start + c] = vrow[start + c] - lr * merged[start + c];
      }
    } else if (opt == kAdagrad) {
      const float g2 = scalar[gi];
      const float scale = sqrtf(g2sum0 / (g2sum0 + g2));
      for (int c = lane; c < width; c += 32) {
        vrow[start + c] = vrow[start + c] - lr * scale * merged[start + c];
      }
      if (lane == 0) {
        st[0] = g2 + sumsq[gi] / static_cast<float>(width);
      }
    } else {
      const float t = scalar[gi] + 1.0f;
      const float bc1 = 1.0f - powf(kBeta1, t);
      const float bc2 = 1.0f - powf(kBeta2, t);
      for (int c = lane; c < width; c += 32) {
        const float g = merged[start + c];
        const float m = st[1 + c] * kBeta1 + kOneMinusBeta1 * g;
        const float v = st[1 + width + c] * kBeta2 + kOneMinusBeta2 * (g * g);
        const float mhat = m / bc1;
        const float vhat = v / bc2;
        vrow[start + c] = vrow[start + c] - lr * mhat / (sqrtf(vhat) + kEps);
        st[1 + c] = m;
        st[1 + width + c] = v;
      }
      if (lane == 0) {
        st[0] = t;
      }
    }
  }
  if (lane == 0) {
    vrow[0] = new_show;
    vrow[1] = new_clk;
  }
}

}  // namespace

extern "C" {

// values [cap, dim], state [cap, state_dim], demb [n_keys, dim], order
// [n_keys], offsets [n_uniq + 1], uniq_rows [n_uniq], uniq_mask [n_uniq];
// group_desc is a host array of n_groups x (start, width, gated, soff).
// Returns a cudaError_t (0 = launched).
int pbx_sparse_push(void* values, void* state, const void* demb,
                    const void* order, const void* offsets,
                    const void* uniq_rows, const void* uniq_mask,
                    int64_t n_uniq, int dim, int state_dim, int n_groups,
                    const int* group_desc, int opt, float lr, float g2sum0,
                    float threshold, void* stream) {
  if (n_uniq <= 0) {
    return 0;
  }
  if (dim < 2 || dim > kMaxDim || state_dim < 1 || n_groups < 0 ||
      n_groups > kMaxGroups || opt < kSgd || opt > kAdam ||
      n_uniq > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Groups groups{};
  groups.n = n_groups;
  for (int gi = 0; gi < n_groups; ++gi) {
    groups.start[gi] = group_desc[4 * gi];
    groups.width[gi] = group_desc[4 * gi + 1];
    groups.gated[gi] = group_desc[4 * gi + 2];
    groups.soff[gi] = group_desc[4 * gi + 3];
    if (groups.start[gi] < 2 || groups.width[gi] < 1 ||
        groups.start[gi] + groups.width[gi] > dim || groups.soff[gi] < 0 ||
        (opt != kSgd && groups.soff[gi] >= state_dim)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int blocks = static_cast<int>((n_uniq + kWarps - 1) / kWarps);
  const size_t smem = static_cast<size_t>(kWarps) * dim * sizeof(float);
  sparse_push_kernel<<<blocks, kWarps * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(values), static_cast<float*>(state),
      static_cast<const float*>(demb), static_cast<const int*>(order),
      static_cast<const int*>(offsets), static_cast<const int*>(uniq_rows),
      static_cast<const float*>(uniq_mask), static_cast<int>(n_uniq), dim,
      state_dim, groups, opt, lr, g2sum0, threshold);
  return static_cast<int>(cudaGetLastError());
}

const char* pbx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
