// Embedded (no-Python) CTR serving loader on one NVIDIA GPU: scores a
// bundle exported by paddlebox_tpu_torch/inference/export_embedded.py
// (counterpart of the top-level csrc/pbx_serve.cpp, the PJRT loader of the
// JAX package's StableHLO bundle).
//
//   pbx_serve <bundle_dir> [input.txt]
//
// In order:
// 1. reads and checks manifest.txt, layout.txt and the sizes of
//    table.keys.u64 / table.vals.f32 (a truncated bundle exits 1);
// 2. dlopens the port's key index (csrc/pbx_index.cpp: pbx_map_create,
//    pbx_map_rebuild, pbx_map_lookup, pbx_gather_rows) and the seqpool+CVM
//    kernel (csrc/seqpool_cvm.cu: pbx_seqpool_cvm_fwd), the libraries
//    ops/_build.py built beside this executable (their file names are
//    compiled in); unknown keys score with zeros;
// 3. parses MultiSlot lines (layout.txt's groups: L label, S sparse slot,
//    D<n> dense slot, X skipped) into batches of `batch` rows, each padded
//    to `npad` keys with segment id batch * slots;
// 4. per batch: the key lookup and row gather on the host, the copies to
//    the card, the kernel on the current CUDA stream, the dense forward
//    (dense_fwd.aoti.pt2 through torch::inductor::AOTIModelPackageLoader),
//    the copy back;
// 5. prints one score a line (a multi-task model's scores space-separated).
//
// Without an input file it scores one batch without keys. On stderr it
// prints its kernel launches ("pbx_serve: launches N batches M"), the
// first batch's milliseconds and the mean milliseconds a later batch of
// each step (host clock, each step ending in a stream synchronize),
// before it exits 0. With no CUDA device, or without
// either library, it exits 1: there is no fallback.
//
// Built by ops/_build.py (build("pbx_serve")): g++ against PyTorch's and
// the CUDA toolkit's headers, linked to libtorch, libtorch_cuda, libc10
// and libc10_cuda with an rpath to torch's lib/.

#include <dlfcn.h>
#include <limits.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/stat.h>
#include <unistd.h>

#include <chrono>
#include <string>
#include <vector>

#include <ATen/ATen.h>
#include <c10/cuda/CUDAFunctions.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#if !defined(PBX_INDEX_LIB) || !defined(PBX_KERNEL_LIB)
#error "build through paddlebox_tpu_torch/ops/_build.py: it names the libraries"
#endif

namespace {

[[noreturn]] void die(const char* what, const std::string& detail = "") {
  fprintf(stderr, "pbx_serve: %s%s%s\n", what, detail.empty() ? "" : ": ",
          detail.c_str());
  exit(1);
}

std::string read_text(const std::string& path) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) die("cannot open", path);
  std::string out;
  char buf[4096];
  size_t n;
  while ((n = fread(buf, 1, sizeof(buf), f)) > 0) out.append(buf, n);
  fclose(f);
  return out;
}

std::string value_of(const std::string& text, const char* key,
                     const std::string& file) {
  const std::string pat = std::string(key) + "=";
  size_t p = 0;
  while ((p = text.find(pat, p)) != std::string::npos) {
    if (p == 0 || text[p - 1] == '\n') {
      const size_t e = text.find('\n', p);
      return text.substr(p + pat.size(),
                         e == std::string::npos ? std::string::npos
                                                : e - p - pat.size());
    }
    ++p;
  }
  die("missing key", file + ": " + key);
}

int64_t int_of(const std::string& text, const char* key,
               const std::string& file) {
  const std::string v = value_of(text, key, file);
  char* end = nullptr;
  const long long x = strtoll(v.c_str(), &end, 10);
  if (end == v.c_str() || x < 0) die("bad value", file + ": " + key);
  return x;
}

int64_t file_size(const std::string& path) {
  struct stat st;
  if (stat(path.c_str(), &st) != 0) die("cannot stat", path);
  return st.st_size;
}

template <typename T>
std::vector<T> read_array(const std::string& path, int64_t n) {
  std::vector<T> out(n > 0 ? n : 1);
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) die("cannot open", path);
  if (n && fread(out.data(), sizeof(T), n, f) != static_cast<size_t>(n))
    die("short read", path);
  fclose(f);
  return out;
}

std::string exe_dir() {
  char buf[PATH_MAX];
  const ssize_t n = readlink("/proc/self/exe", buf, sizeof(buf) - 1);
  if (n <= 0) die("cannot read /proc/self/exe");
  buf[n] = '\0';
  std::string p(buf);
  return p.substr(0, p.rfind('/'));
}

void* open_lib(const std::string& path) {
  void* h = dlopen(path.c_str(), RTLD_NOW | RTLD_LOCAL);
  if (!h) die("dlopen failed", dlerror());
  return h;
}

template <typename F>
F sym(void* lib, const char* name) {
  void* p = dlsym(lib, name);
  if (!p) die("missing symbol", name);
  return reinterpret_cast<F>(p);
}

// One group of a line's layout.
struct Group {
  char kind;   // 'L', 'S', 'D', 'X'
  int64_t dim;  // D's width
};

// The parsed lines: keys of each (row, slot) in order, dense values.
struct Rows {
  std::vector<uint64_t> keys;
  std::vector<int64_t> lengths;  // [n, S]
  std::vector<float> dense;      // [n, dd]
  int64_t n = 0;
};

double ms_since(std::chrono::steady_clock::time_point t0) {
  return std::chrono::duration<double, std::milli>(
             std::chrono::steady_clock::now() - t0)
      .count();
}

[[noreturn]] void bad_line(const char* file, int64_t lineno,
                           const std::string& what) {
  fprintf(stderr, "pbx_serve: %s:%lld: %s\n", file,
          static_cast<long long>(lineno), what.c_str());
  exit(1);
}

// Parses the MultiSlot lines of `path` as SlotParser does: each group is a
// count and that many tokens; blank lines are skipped; a missing count or
// value is an error (a wrong input file must not score).
Rows parse_lines(const char* path, const std::vector<Group>& groups,
                 int64_t S, int64_t dd) {
  Rows r;
  FILE* in = fopen(path, "r");
  if (!in) die("cannot open input", path);
  char* line = nullptr;
  size_t cap = 0;
  int64_t lineno = 0;
  std::vector<std::vector<uint64_t>> slot_keys(S);
  while (getline(&line, &cap, in) > 0) {
    ++lineno;
    char* p = line;
    while (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n') ++p;
    if (!*p) continue;
    for (auto& v : slot_keys) v.clear();
    std::vector<float> dense(dd, 0.0f);
    int64_t slot = 0, col = 0;
    for (size_t g = 0; g < groups.size(); ++g) {
      char* before = p;
      const long long c = strtoll(p, &p, 10);
      if (p == before || c < 0)
        bad_line(path, lineno, "group " + std::to_string(g) + " of " +
                                   std::to_string(groups.size()) +
                                   " has no count");
      for (long long j = 0; j < c; ++j) {
        while (*p == ' ' || *p == '\t') ++p;
        if (!*p || *p == '\n' || *p == '\r')
          bad_line(path, lineno,
                   "group " + std::to_string(g) + " declares " +
                       std::to_string(c) + " values, the line ends after " +
                       std::to_string(j));
        before = p;
        const Group& gr = groups[g];
        if (gr.kind == 'S') {
          slot_keys[slot].push_back(strtoull(p, &p, 10));
        } else if (gr.kind == 'D') {
          // numpy's parse: the nearest double, then float32
          const double x = strtod(p, &p);
          if (j < gr.dim) dense[col + j] = static_cast<float>(x);
        } else {
          while (*p && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r')
            ++p;
        }
        if (p == before) bad_line(path, lineno, "unparsable value");
      }
      if (groups[g].kind == 'S') ++slot;
      if (groups[g].kind == 'D') col += groups[g].dim;
    }
    for (int64_t s = 0; s < S; ++s) {
      r.lengths.push_back(static_cast<int64_t>(slot_keys[s].size()));
      r.keys.insert(r.keys.end(), slot_keys[s].begin(), slot_keys[s].end());
    }
    r.dense.insert(r.dense.end(), dense.begin(), dense.end());
    ++r.n;
  }
  free(line);
  fclose(in);
  return r;
}

using MapCreate = void* (*)(int64_t);
using MapRebuild = int64_t (*)(void*, const uint64_t*, int64_t);
using MapLookup = int64_t (*)(void*, const uint64_t*, int64_t, int64_t*, int,
                              int, uint64_t, int64_t);
using GatherRows = void (*)(const float*, const int64_t*, int64_t, int64_t,
                            float*);
using SeqpoolFwd = int (*)(const void*, const void*, void*, int64_t, int,
                           int64_t, int, int, float, int, void*);
using ErrorString = const char* (*)(int);

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2 || argc > 3) {
    fprintf(stderr, "usage: pbx_serve <bundle_dir> [input.txt]\n");
    return 2;
  }
  const std::string bundle = argv[1];

  // 1. the bundle, checked before anything is loaded
  const std::string mf = bundle + "/manifest.txt";
  const std::string manifest = read_text(mf);
  const int64_t npad = int_of(manifest, "npad", mf);
  const int64_t B = int_of(manifest, "batch", mf);
  const int64_t S = int_of(manifest, "slots", mf);
  const int64_t D = int_of(manifest, "pull_dim", mf);
  const int64_t dd = int_of(manifest, "dense_dim", mf);
  const int64_t rows = int_of(manifest, "rows", mf);
  if (npad < 1 || B < 1 || S < 1 || D < 1 || B * S > INT32_MAX)
    die("bad shapes in", mf);
  const std::string lf = bundle + "/layout.txt";
  const std::string layout = read_text(lf);
  const int use_cvm = static_cast<int>(int_of(layout, "use_cvm", lf));
  const int cvm_offset = static_cast<int>(int_of(layout, "cvm_offset", lf));
  const int64_t out_dim = use_cvm ? D : D - cvm_offset;
  if (out_dim < 1) die("bad cvm_offset in", lf);
  std::vector<Group> groups;
  {
    const std::string gs = value_of(layout, "groups", lf);
    size_t i = 0;
    int64_t n_sparse = 0, n_dense = 0;
    while (i < gs.size()) {
      while (i < gs.size() && gs[i] == ' ') ++i;
      if (i >= gs.size()) break;
      Group g{gs[i], 0};
      if (g.kind == 'D') g.dim = strtoll(gs.c_str() + i + 1, nullptr, 10);
      if (g.kind != 'L' && g.kind != 'S' && g.kind != 'D' && g.kind != 'X')
        die("bad group in", lf);
      n_sparse += g.kind == 'S';
      n_dense += g.dim;
      groups.push_back(g);
      while (i < gs.size() && gs[i] != ' ') ++i;
    }
    if (n_sparse != S || n_dense != dd)
      die("layout.txt's groups disagree with manifest.txt");
  }
  const std::string kf = bundle + "/table.keys.u64";
  const std::string vf = bundle + "/table.vals.f32";
  if (file_size(kf) != rows * 8 || file_size(vf) != rows * D * 4)
    die("table snapshot size mismatch with manifest");

  // 2. the card and the libraries: no fallback without them
  if (c10::cuda::device_count() < 1) die("no CUDA device");
  const std::string dir = exe_dir();
  void* index = open_lib(dir + "/" PBX_INDEX_LIB);
  void* kernel = open_lib(dir + "/" PBX_KERNEL_LIB);
  auto map_create = sym<MapCreate>(index, "pbx_map_create");
  auto map_rebuild = sym<MapRebuild>(index, "pbx_map_rebuild");
  auto map_lookup = sym<MapLookup>(index, "pbx_map_lookup");
  auto gather_rows = sym<GatherRows>(index, "pbx_gather_rows");
  auto seqpool_fwd = sym<SeqpoolFwd>(kernel, "pbx_seqpool_cvm_fwd");
  auto error_string = sym<ErrorString>(kernel, "pbx_cuda_error_string");

  auto t_load = std::chrono::steady_clock::now();
  const std::vector<uint64_t> keys = read_array<uint64_t>(kf, rows);
  const std::vector<float> vals = read_array<float>(vf, rows * D);
  void* map = map_create(rows + 1);
  if (!map || map_rebuild(map, keys.data(), rows) < 0)
    die("cannot build the key index");
  const at::Device dev(at::kCUDA, 0);
  c10::cuda::set_device(0);
  torch::inductor::AOTIModelPackageLoader model(bundle +
                                                "/dense_fwd.aoti.pt2");
  const double load_ms = ms_since(t_load);

  // 3. the input
  Rows in;
  if (argc == 3) {
    in = parse_lines(argv[2], groups, S, dd);
  } else {
    in.n = B;
    in.lengths.assign(B * S, 0);
    in.dense.assign(B * dd, 0.0f);
  }

  // 4. batch by batch
  const auto stream = c10::cuda::getCurrentCUDAStream(0);
  std::vector<uint64_t> bkeys(npad);
  std::vector<int32_t> segs(npad);
  std::vector<int64_t> krows(npad);
  std::vector<float> emb(npad * D);
  std::vector<float> dense(B * (dd > 0 ? dd : 1));
  int64_t launches = 0, batches = 0, dropped = 0;
  // each step's ms summed over the batches after the first; the first
  // batch's whole ms apart (it loads the program's kernels and cuBLAS)
  double t_lookup = 0, t_h2d = 0, t_pool = 0, t_dense = 0, t_d2h = 0;
  double first_ms = 0;
  int64_t first_key = 0;
  for (int64_t r0 = 0; r0 < in.n; r0 += B) {
    const int64_t nrows = std::min<int64_t>(B, in.n - r0);
    const double before = t_lookup + t_h2d + t_pool + t_dense + t_d2h;
    auto t0 = std::chrono::steady_clock::now();
    int64_t nk = 0;
    std::fill(segs.begin(), segs.end(), static_cast<int32_t>(B * S));
    std::fill(bkeys.begin(), bkeys.end(), 0);
    for (int64_t i = 0; i < nrows * S; ++i) {
      const int64_t len = in.lengths[r0 * S + i];
      for (int64_t j = 0; j < len; ++j, ++first_key) {
        if (nk < npad) {
          bkeys[nk] = in.keys[first_key];
          segs[nk] = static_cast<int32_t>(i);
          ++nk;
        } else {
          ++dropped;
        }
      }
    }
    map_lookup(map, bkeys.data(), nk, krows.data(), 0, 0, 0, 0);
    gather_rows(vals.data(), krows.data(), nk, D, emb.data());
    std::fill(emb.begin() + nk * D, emb.end(), 0.0f);
    std::fill(dense.begin(), dense.end(), 0.0f);
    std::copy(in.dense.begin() + r0 * dd, in.dense.begin() + (r0 + nrows) * dd,
              dense.begin());
    t_lookup += ms_since(t0);

    t0 = std::chrono::steady_clock::now();
    const auto f32 = at::TensorOptions().dtype(at::kFloat);
    at::Tensor emb_d = at::from_blob(emb.data(), {npad, D}, f32).to(dev);
    at::Tensor segs_d =
        at::from_blob(segs.data(), {npad}, at::TensorOptions().dtype(at::kInt))
            .to(dev);
    at::Tensor dense_d = at::from_blob(dense.data(), {B, dd}, f32).to(dev);
    stream.synchronize();
    t_h2d += ms_since(t0);

    t0 = std::chrono::steady_clock::now();
    at::Tensor pooled = at::empty({B * S, out_dim}, f32.device(dev));
    const int bulk = reinterpret_cast<uintptr_t>(emb_d.data_ptr()) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(segs_d.data_ptr()) % 16 == 0;
    const int rc = seqpool_fwd(emb_d.data_ptr(), segs_d.data_ptr(),
                               pooled.data_ptr(), npad, static_cast<int>(D),
                               B * S, use_cvm, cvm_offset, 0.0f, bulk,
                               stream.stream());
    if (rc != 0) die("seqpool_cvm kernel launch failed", error_string(rc));
    ++launches;
    stream.synchronize();
    t_pool += ms_since(t0);

    t0 = std::chrono::steady_clock::now();
    std::vector<at::Tensor> outs =
        model.run({pooled.view({B, S * out_dim}), dense_d}, stream.stream());
    stream.synchronize();
    t_dense += ms_since(t0);

    t0 = std::chrono::steady_clock::now();
    at::Tensor preds = outs.at(0).to(at::kCPU).to(at::kFloat).contiguous();
    t_d2h += ms_since(t0);

    if (batches == 0) {
      first_ms = t_lookup + t_h2d + t_pool + t_dense + t_d2h - before;
      t_lookup = t_h2d = t_pool = t_dense = t_d2h = 0;
    }
    const int64_t tasks = preds.dim() > 1 ? preds.size(1) : 1;
    const float* pp = preds.data_ptr<float>();
    for (int64_t i = 0; i < nrows; ++i) {
      for (int64_t t = 0; t < tasks; ++t)
        printf(t ? " %.9g" : "%.9g", pp[i * tasks + t]);
      printf("\n");
    }
    ++batches;
  }
  fflush(stdout);
  if (dropped)
    fprintf(stderr,
            "pbx_serve: warning: %lld key(s) beyond npad=%lld were dropped: "
            "their rows score on a prefix of their features\n",
            static_cast<long long>(dropped), static_cast<long long>(npad));
  const double nb = batches > 1 ? static_cast<double>(batches - 1) : 1.0;
  fprintf(stderr, "pbx_serve: launches %lld batches %lld\n",
          static_cast<long long>(launches), static_cast<long long>(batches));
  fprintf(stderr,
          "pbx_serve: load %.3f ms; first batch %.3f ms; ms a batch after "
          "it: lookup %.4f h2d %.4f pool %.4f dense %.4f d2h %.4f\n",
          load_ms, first_ms, t_lookup / nb, t_h2d / nb, t_pool / nb,
          t_dense / nb, t_d2h / nb);
  return 0;
}
