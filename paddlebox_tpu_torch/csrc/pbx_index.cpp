// Host key -> row index of the device table: the open-addressing Map64, its
// thread-sharded MtMap, and their C entry points (ps/native.py loads this
// file through ctypes; ops/_build.py compiles it with g++ at first use).
//
// A copy of the index parts of the reference's csrc/pbx_ps.cpp (Entry and
// its allocators, kBlock/kMaxRun/kGuard, Map64, MtMap, pbx_mt_* and
// pbx_map_*), kept bit for bit where it matters: Map64::hash, the slot
// placement, the row numbering (uniques in first-occurrence order, new keys
// take next_row + i) and the [capacity + guard, 4] u32 export layout. The
// device mirror (ps/device_index.py) and its CUDA probe
// (csrc/device_index.cu) recompute Map64::hash and walk the same slots.
// Nothing else of pbx_ps.cpp comes along: no wire packing, parser or mesh
// planner.
//
// No external dependencies; thread-safety is the caller's job.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

#include <sys/mman.h>

namespace {

// The index is probed ~100k times per batch with uniformly random keys over
// a multi-GB table: every probe is a DRAM (and, with 4K pages, TLB) miss, so
// the layout is chosen to cost exactly ONE cache line per resolved key:
//   - key and row interleaved in one 16-byte entry (two parallel arrays
//     would cost two misses per key)
//   - backing store is anonymous mmap with MADV_HUGEPAGE: 2M pages keep the
//     whole table's translations in the TLB (4K pages page-walk per probe)
//   - hot loops run block-pipelined: a tight pass hashes + prefetches a
//     block of keys, a second pass resolves them — by then the lines are in
//     flight/L1, hiding most of the ~100ns DRAM latency
// Entries store ~key ("nkey") so that the mmap zero page means EMPTY and no
// multi-GB memset is needed on allocation or growth.
struct Entry {
  uint64_t nkey;  // ~key; 0 = empty slot
  int64_t row;
};

inline Entry* entry_alloc(size_t cap) {
  size_t bytes = cap * sizeof(Entry);
  void* p = mmap(nullptr, bytes, PROT_READ | PROT_WRITE,
                 MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
  // bad_alloc (not nullptr): callers sit deep inside probe loops; the C
  // boundary catches it and returns -1 so Python raises MemoryError
  // instead of the trainer dying on a null write mid-grow
  if (p == MAP_FAILED) throw std::bad_alloc();
#ifdef MADV_HUGEPAGE
  madvise(p, bytes, MADV_HUGEPAGE);
#endif
  return static_cast<Entry*>(p);
}

inline void entry_free(Entry* p, size_t cap) {
  if (p) munmap(p, cap * sizeof(Entry));
}

constexpr int kBlock = 256;  // pipeline depth of the block-prefetch passes

// Probe runs are NOT allowed to wrap around: the table carries kGuard extra
// slots past capacity, and an insert whose run would exceed kMaxRun slots
// from its home position grows the table instead. Bounded straight-line
// runs are what let the device mirror (ps/device_index.py) resolve any key
// by walking at most kMaxRun contiguous slots from its home slot, with no
// wraparound logic (csrc/device_index.cu).
constexpr int kMaxRun = 64;
constexpr int kGuard = kMaxRun;

struct Map64 {
  Entry* tab = nullptr;
  size_t mask = 0;
  size_t size = 0;
  uint64_t generation = 0;  // bumped on grow(): device mirrors must resync

  explicit Map64(size_t cap_hint) {
    size_t cap = 1024;
    while (cap < cap_hint * 2) cap <<= 1;
    tab = entry_alloc(cap + kGuard);
    mask = cap - 1;
  }
  Map64(const Map64&) = delete;
  Map64& operator=(const Map64&) = delete;
  Map64(Map64&& o) noexcept { *this = std::move(o); }
  Map64& operator=(Map64&& o) noexcept {
    if (this != &o) {
      entry_free(tab, mask + 1 + kGuard);
      entry_free(reinterpret_cast<Entry*>(sk),
                 sk_mask ? sk_mask + 1 : 0);
      tab = o.tab; mask = o.mask; size = o.size;
      generation = o.generation;
      sk = o.sk; sk_mask = o.sk_mask; epoch = o.epoch;
      o.tab = nullptr; o.sk = nullptr; o.mask = o.sk_mask = 0;
    }
    return *this;
  }
  ~Map64() {
    entry_free(tab, mask + 1 + kGuard);
    entry_free(reinterpret_cast<Entry*>(sk),
               sk_mask ? sk_mask + 1 : 0);
  }

  // Key hash built from two murmur3 fmix32 rounds over the key's 32-bit
  // halves, so that the device mirror can recompute it in uint32
  // arithmetic (ps/device_index.py and csrc/device_index.cu match it bit
  // for bit).
  static inline uint32_t fmix32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x85ebca6bu;
    x ^= x >> 13;
    x *= 0xc2b2ae35u;
    x ^= x >> 16;
    return x;
  }

  static inline size_t hash(uint64_t k) {
    const uint32_t lo = static_cast<uint32_t>(k);
    const uint32_t hi = static_cast<uint32_t>(k >> 32);
    return static_cast<size_t>(fmix32(hi ^ fmix32(lo)));
  }

  void grow() {
    Entry* old = tab;
    size_t ocap = mask + 1;
    size_t cap = ocap;
    // the fmix32-composed hash only reaches 2^32 distinct home slots, so a
    // table past 2^32 slots could never spread runs into its upper half;
    // refuse (as host-OOM) rather than doubling forever (a 2^32 cap at 0.7
    // load is ~3B keys per single map — multi-host sharding territory)
    if (ocap >= (size_t(1) << 32)) throw std::bad_alloc();
    // double until every run fits kMaxRun again (retry by re-growing if a
    // pathological cluster persists — vanishingly rare below 0.5 load)
    while (true) {
      cap <<= 1;
      Entry* fresh;
      try {
        fresh = entry_alloc(cap + kGuard);
      } catch (const std::bad_alloc&) {
        // keep the map intact (old tab/mask) so the caller can still
        // checkpoint after Python surfaces the MemoryError
        tab = old;
        mask = ocap - 1;
        throw;
      }
      tab = fresh;
      mask = cap - 1;
      if (replace_all(old, ocap + kGuard)) break;
      entry_free(tab, cap + kGuard);
    }
    ++generation;
    entry_free(old, ocap + kGuard);
  }

  // re-place every entry of ``old`` into the freshly allocated ``tab``;
  // false when some run would exceed kMaxRun (caller grows again)
  bool replace_all(const Entry* old, size_t on) {
    size_t hs[kBlock];
    uint64_t ks[kBlock];
    int64_t rs[kBlock];
    int nb = 0;
    auto flush = [&]() -> bool {
      for (int j = 0; j < nb; ++j) {
        size_t p = hs[j];
        const size_t limit = hs[j] + kMaxRun;
        while (tab[p].nkey != 0) {
          if (++p >= limit) return false;
        }
        tab[p].nkey = ks[j];
        tab[p].row = rs[j];
      }
      nb = 0;
      return true;
    };
    for (size_t i = 0; i < on; ++i) {
      if (old[i].nkey == 0) continue;
      ks[nb] = old[i].nkey;
      rs[nb] = old[i].row;
      hs[nb] = hash(~old[i].nkey) & mask;
      __builtin_prefetch(&tab[hs[nb]], 1);
      if (++nb == kBlock && !flush()) return false;
    }
    return flush();
  }

  inline int64_t find(uint64_t k) const {
    const uint64_t nk = ~k;
    size_t p = hash(k) & mask;
    while (true) {
      if (tab[p].nkey == nk) return tab[p].row;
      if (tab[p].nkey == 0) return -1;
      ++p;  // runs never wrap: bounded by kMaxRun < kGuard at insert
    }
  }

  // slot of an existing key, or -1 (for device-mirror update export)
  inline int64_t find_slot(uint64_t k) const {
    const uint64_t nk = ~k;
    size_t p = hash(k) & mask;
    while (true) {
      if (tab[p].nkey == nk) return static_cast<int64_t>(p);
      if (tab[p].nkey == 0) return -1;
      ++p;
    }
  }

  // returns row (existing or newly assigned = next_row); *slot_out = the
  // slot the key occupies (valid whenever the return is >= 0)
  inline int64_t find_or_insert_slot(uint64_t k, int64_t next_row,
                                     bool* inserted, int64_t* slot_out) {
    if (size * 10 >= (mask + 1) * 7) grow();
    const uint64_t nk = ~k;
    while (true) {
      size_t p = hash(k) & mask;
      const size_t limit = p + kMaxRun;
      while (true) {
        if (tab[p].nkey == nk) {
          *inserted = false;
          *slot_out = static_cast<int64_t>(p);
          return tab[p].row;
        }
        if (tab[p].nkey == 0) {
          tab[p].nkey = nk;
          tab[p].row = next_row;
          ++size;
          *inserted = true;
          *slot_out = static_cast<int64_t>(p);
          return next_row;
        }
        if (++p >= limit) break;
      }
      grow();  // run at capacity: rehash and retry
    }
  }

  inline int64_t find_or_insert(uint64_t k, int64_t next_row, bool* inserted) {
    int64_t slot;
    return find_or_insert_slot(k, next_row, inserted, &slot);
  }

  // scratch dedup map (epoch-tagged so it resets in O(1) between batches);
  // same 16-byte interleaved layout: {key, epoch, uid}
  struct SEntry {
    uint64_t key;
    uint32_t epoch;
    int32_t uid;
  };
  SEntry* sk = nullptr;
  uint32_t epoch = 0;
  size_t sk_mask = 0;

  void scratch_reserve(size_t n) {
    size_t cap = 1024;
    while (cap < n * 2) cap <<= 1;
    if (sk == nullptr || cap > sk_mask + 1) {
      static_assert(sizeof(SEntry) == sizeof(Entry), "layout");
      // allocate BEFORE freeing: if entry_alloc throws, sk stays valid
      SEntry* fresh = reinterpret_cast<SEntry*>(entry_alloc(cap));
      entry_free(reinterpret_cast<Entry*>(sk),
                 sk_mask ? sk_mask + 1 : 0);
      sk = fresh;
      sk_mask = cap - 1;
      epoch = 0;
    }
    ++epoch;
    if (epoch == 0) {
      // uint32 wrap: stale tags (and the zeroed ep of fresh slots) would
      // alias the new epoch -> wipe tags and restart at 1
      for (size_t i = 0; i <= sk_mask; ++i) sk[i].epoch = 0;
      epoch = 1;
    }
  }
};

// Sharded map for the multithreaded prepare: thread t owns keys with
// hash(k) % T == t, so shards never contend; arena rows come from one
// atomic counter (contended only while a key is NEW — steady-state passes
// insert nothing).
struct MtMap {
  std::vector<Map64> shards;
  std::atomic<int64_t> next_row{1};  // row 0 = null

  explicit MtMap(int n_shards, size_t cap_hint) {
    for (int i = 0; i < n_shards; ++i) shards.emplace_back(cap_hint);
  }
  inline int shard_of(uint64_t k) const {
    return static_cast<int>(Map64::hash(k ^ 0x5bd1e995u) %
                            shards.size());
  }
};

}  // namespace

extern "C" {

void* pbx_mt_create(int n_shards, int64_t cap_hint) try {
  return new MtMap(n_shards > 0 ? n_shards : 4,
                   static_cast<size_t>(cap_hint > 0 ? cap_hint : 1024));
} catch (const std::bad_alloc&) {
  return nullptr;
}

void pbx_mt_destroy(void* h) { delete static_cast<MtMap*>(h); }

int64_t pbx_mt_size(void* h) {
  int64_t s = 0;
  for (auto& m : static_cast<MtMap*>(h)->shards)
    s += static_cast<int64_t>(m.size);
  return s;
}

int64_t pbx_mt_next_row(void* h) {
  return static_cast<MtMap*>(h)->next_row.load();
}

// Parallel fused dedup + row mapping. Same contract as pbx_map_prepare but
// rows come from the internal atomic counter; returns n_uniq and writes
// *n_new_out. uid order is (shard, first-occurrence-within-shard).
int64_t pbx_mt_prepare(void* h, const uint64_t* keys, int64_t n, int create,
                       int skip, uint64_t skip_key, int32_t* rows_out,
                       int32_t* inverse_out, int32_t* uniq_rows_out,
                       int64_t* n_new_out) try {
  MtMap* mt = static_cast<MtMap*>(h);
  const int T = static_cast<int>(mt->shards.size());
  std::vector<int64_t> uniq_count(T, 0), new_count(T, 0);
  std::vector<std::vector<int32_t>> local_uniq(T);

  auto phase_a = [&](int t) {
    Map64& m = mt->shards[t];
    // worst-case: every unique key lands in one shard
    m.scratch_reserve(static_cast<size_t>(n));
    const uint32_t ep = m.epoch;
    auto& uniq = local_uniq[t];
    uniq.reserve(static_cast<size_t>(n / T + 64));
    int64_t n_new = 0;
    for (int64_t i = 0; i < n; ++i) {
      const uint64_t k = keys[i];
      if (mt->shard_of(k) != t) continue;
      size_t p = Map64::hash(k) & m.sk_mask;
      int32_t uid;
      while (true) {
        if (m.sk[p].epoch != ep) {
          m.sk[p].epoch = ep;
          m.sk[p].key = k;
          uid = static_cast<int32_t>(uniq.size());
          m.sk[p].uid = uid;
          // find first: rows are only allocated for genuinely-new keys
          // (an optimistic fetch_add would leak a row per re-seen unique)
          int64_t row = m.find(k);
          if (row < 0 && create && !(skip && k == skip_key)) {
            row = mt->next_row.fetch_add(1);
            bool ins = false;
            m.find_or_insert(k, row, &ins);
            ++n_new;
          }
          uniq.push_back(row < 0 ? 0 : static_cast<int32_t>(row));
          break;
        }
        if (m.sk[p].key == k) {
          uid = m.sk[p].uid;
          break;
        }
        p = (p + 1) & m.sk_mask;
      }
      inverse_out[i] = uid;  // local uid; offset added in phase B
    }
    uniq_count[t] = static_cast<int64_t>(uniq.size());
    new_count[t] = n_new;
  };

  std::vector<std::thread> ths;
  for (int t = 0; t < T; ++t) ths.emplace_back(phase_a, t);
  for (auto& th : ths) th.join();

  std::vector<int64_t> off(T + 1, 0);
  for (int t = 0; t < T; ++t) off[t + 1] = off[t] + uniq_count[t];
  for (int t = 0; t < T; ++t) {
    std::memcpy(uniq_rows_out + off[t], local_uniq[t].data(),
                sizeof(int32_t) * local_uniq[t].size());
  }

  auto phase_b = [&](int t) {
    const int32_t o = static_cast<int32_t>(off[t]);
    for (int64_t i = 0; i < n; ++i) {
      if (mt->shard_of(keys[i]) != t) continue;
      const int32_t uid = inverse_out[i] + o;
      inverse_out[i] = uid;
      rows_out[i] = uniq_rows_out[uid];
    }
  };
  ths.clear();
  for (int t = 0; t < T; ++t) ths.emplace_back(phase_b, t);
  for (auto& th : ths) th.join();

  int64_t n_new = 0;
  for (int t = 0; t < T; ++t) n_new += new_count[t];
  *n_new_out = n_new;
  return off[T];
} catch (const std::bad_alloc&) {
  return -1;
}

// single-threaded batch lookup against the sharded map (compat path for
// feed_pass / contains / load)
int64_t pbx_mt_lookup(void* h, const uint64_t* keys, int64_t n,
                      int64_t* rows_out, int create, int skip,
                      uint64_t skip_key) try {
  MtMap* mt = static_cast<MtMap*>(h);
  int64_t n_new = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t k = keys[i];
    Map64& m = mt->shards[mt->shard_of(k)];
    int64_t row = m.find(k);
    if (row < 0 && create && !(skip && k == skip_key)) {
      row = mt->next_row.fetch_add(1);
      bool ins = false;
      m.find_or_insert(k, row, &ins);
      ++n_new;
    }
    rows_out[i] = row;
  }
  return n_new;
} catch (const std::bad_alloc&) {
  return -1;
}

void pbx_mt_dump(void* h, uint64_t* out, int64_t n) {
  MtMap* mt = static_cast<MtMap*>(h);
  for (auto& m : mt->shards) {
    for (size_t p = 0; p < m.mask + 1 + kGuard; ++p) {
      if (m.tab[p].nkey == 0) continue;
      int64_t r = m.tab[p].row;
      if (r >= 0 && r < n) out[r] = ~m.tab[p].nkey;
    }
  }
}

// rebuild: keys[i] -> row i; resets the row counter to n
int64_t pbx_mt_rebuild(void* h, const uint64_t* keys, int64_t n) try {
  MtMap* mt = static_cast<MtMap*>(h);
  const int T = static_cast<int>(mt->shards.size());
  for (int t = 0; t < T; ++t) {
    mt->shards[t] = Map64(static_cast<size_t>(n / T + 1024));
  }
  for (int64_t i = 0; i < n; ++i) {
    bool ins = false;
    mt->shards[mt->shard_of(keys[i])].find_or_insert(keys[i], i, &ins);
  }
  mt->next_row.store(n);
  return 0;
} catch (const std::bad_alloc&) {
  return -1;
}

void* pbx_map_create(int64_t cap_hint) try {
  return new Map64(static_cast<size_t>(cap_hint > 0 ? cap_hint : 1024));
} catch (const std::bad_alloc&) {
  return nullptr;
}

void pbx_map_destroy(void* h) { delete static_cast<Map64*>(h); }

int64_t pbx_map_size(void* h) {
  return static_cast<int64_t>(static_cast<Map64*>(h)->size);
}

// rows_out[i] = row of keys[i] or -1; when create != 0, absent keys are
// inserted with sequential rows starting at next_row (skipping key
// `skip_key` when skip != 0). Returns the number of new inserts.
int64_t pbx_map_lookup(void* h, const uint64_t* keys, int64_t n,
                       int64_t* rows_out, int create, int skip,
                       uint64_t skip_key, int64_t next_row) try {
  Map64* m = static_cast<Map64*>(h);
  int64_t inserted_n = 0;
  for (int64_t base = 0; base < n; base += kBlock) {
    const int nb = static_cast<int>(std::min<int64_t>(kBlock, n - base));
    if (create) {
      for (int j = 0; j < nb; ++j) {
        __builtin_prefetch(&m->tab[Map64::hash(keys[base + j]) & m->mask],
                           1);
      }
    } else {
      for (int j = 0; j < nb; ++j) {
        __builtin_prefetch(&m->tab[Map64::hash(keys[base + j]) & m->mask],
                           0);
      }
    }
    for (int j = 0; j < nb; ++j) {
      const uint64_t k = keys[base + j];
      if (!create || (skip && k == skip_key)) {
        rows_out[base + j] = m->find(k);
        continue;
      }
      bool ins = false;
      rows_out[base + j] = m->find_or_insert(k, next_row + inserted_n, &ins);
      if (ins) ++inserted_n;
    }
  }
  return inserted_n;
} catch (const std::bad_alloc&) {
  return -1;
}

// dump keys into out[row] for rows [0, n)
void pbx_map_dump(void* h, uint64_t* out, int64_t n) {
  Map64* m = static_cast<Map64*>(h);
  for (size_t p = 0; p < m->mask + 1 + kGuard; ++p) {
    if (m->tab[p].nkey == 0) continue;
    int64_t r = m->tab[p].row;
    if (r >= 0 && r < n) out[r] = ~m->tab[p].nkey;
  }
}

// rebuild the map from keys[i] -> row i (load / shrink compaction).
// Block-pipelined: hashing+prefetching a block ahead of the probe pass
// keeps ~kBlock DRAM misses in flight instead of 1 (this is the path
// behind DeviceTable.prepopulate/load — 100M rows at one miss each would
// cost minutes serialized). Duplicate keys keep their FIRST row.
int64_t pbx_map_rebuild(void* h, const uint64_t* keys, int64_t n) try {
  Map64* m = static_cast<Map64*>(h);
  size_t cap = 1024;
  while (cap < static_cast<size_t>(n) * 2) cap <<= 1;
  Entry* fresh = entry_alloc(cap + kGuard);  // before free: throw-safe
  entry_free(m->tab, m->mask + 1 + kGuard);
  m->tab = fresh;
  m->mask = cap - 1;
  m->size = 0;
  ++m->generation;
  size_t hs[kBlock];
  for (int64_t base = 0; base < n; base += kBlock) {
    const int nb = static_cast<int>(std::min<int64_t>(kBlock, n - base));
    for (int j = 0; j < nb; ++j) {
      hs[j] = Map64::hash(keys[base + j]) & m->mask;
      __builtin_prefetch(&m->tab[hs[j]], 1);
    }
    for (int j = 0; j < nb; ++j) {
      bool ins = false;
      m->find_or_insert(keys[base + j], base + j, &ins);
    }
  }
  return 0;
} catch (const std::bad_alloc&) {
  return -1;
}

// Fused dedup + row mapping in ONE pass (the hot host path of the device
// table, ps/device_table.py prepare_batch): assigns uids in
// first-occurrence order, looks up / inserts arena rows, emits
//   rows_out[i]      arena row per input key (0 = null row)
//   inverse_out[i]   uid per input key
//   uniq_rows_out[u] arena row per uid
// Returns n_uniq; *n_new_out = newly inserted key count.
static int64_t map_prepare_impl(Map64* m, const uint64_t* keys, int64_t n,
                                int create, int skip, uint64_t skip_key,
                                int64_t next_row, int32_t* rows_out,
                                int32_t* inverse_out,
                                int32_t* uniq_rows_out, int64_t* n_new_out,
                                int64_t* new_slots_out,
                                uint32_t* new_hi_out, uint32_t* new_lo_out,
                                int32_t* new_rows_out) {
  m->scratch_reserve(static_cast<size_t>(n));
  const uint32_t ep = m->epoch;
  int64_t n_uniq = 0, n_new = 0;
  // block pipeline: pass 1 hashes + prefetches kBlock scratch and main-map
  // lines; pass 2 resolves them with the misses already in flight. A
  // sliding-window prefetch stalls here because the loop body is a handful
  // of cycles per key while each miss is ~100ns; a whole block of
  // independent prefetches keeps the memory system saturated instead.
  size_t hs[kBlock];
  for (int64_t base = 0; base < n; base += kBlock) {
    const int nb = static_cast<int>(std::min<int64_t>(kBlock, n - base));
    if (create) {
      for (int j = 0; j < nb; ++j) {
        const size_t hv = Map64::hash(keys[base + j]);
        hs[j] = hv;
        __builtin_prefetch(&m->sk[hv & m->sk_mask], 1);
        __builtin_prefetch(&m->tab[hv & m->mask], 1);
      }
    } else {
      for (int j = 0; j < nb; ++j) {
        const size_t hv = Map64::hash(keys[base + j]);
        hs[j] = hv;
        __builtin_prefetch(&m->sk[hv & m->sk_mask], 1);
        __builtin_prefetch(&m->tab[hv & m->mask], 0);
      }
    }
    for (int j = 0; j < nb; ++j) {
      const uint64_t k = keys[base + j];
      size_t p = hs[j] & m->sk_mask;
      int32_t uid;
      while (true) {
        if (m->sk[p].epoch != ep) {
          // first occurrence: resolve the arena row once
          m->sk[p].epoch = ep;
          m->sk[p].key = k;
          uid = static_cast<int32_t>(n_uniq++);
          m->sk[p].uid = uid;
          int64_t row;
          if (!create || (skip && k == skip_key)) {
            row = m->find(k);
          } else {
            bool ins = false;
            int64_t slot = -1;
            row = m->find_or_insert_slot(k, next_row + n_new, &ins, &slot);
            if (ins) {
              if (new_slots_out != nullptr) {
                new_slots_out[n_new] = slot;
                new_hi_out[n_new] = static_cast<uint32_t>(k >> 32);
                new_lo_out[n_new] = static_cast<uint32_t>(k);
                new_rows_out[n_new] = static_cast<int32_t>(row);
              }
              ++n_new;
            }
          }
          uniq_rows_out[uid] = row < 0 ? 0 : static_cast<int32_t>(row);
          break;
        }
        if (m->sk[p].key == k) {
          uid = m->sk[p].uid;
          break;
        }
        p = (p + 1) & m->sk_mask;
      }
      inverse_out[base + j] = uid;
      rows_out[base + j] = uniq_rows_out[uid];
    }
  }
  *n_new_out = n_new;
  return n_uniq;
}

int64_t pbx_map_prepare(void* h, const uint64_t* keys, int64_t n, int create,
                        int skip, uint64_t skip_key, int64_t next_row,
                        int32_t* rows_out, int32_t* inverse_out,
                        int32_t* uniq_rows_out, int64_t* n_new_out) try {
  return map_prepare_impl(static_cast<Map64*>(h), keys, n, create, skip,
                          skip_key, next_row, rows_out, inverse_out,
                          uniq_rows_out, n_new_out, nullptr, nullptr,
                          nullptr, nullptr);
} catch (const std::bad_alloc&) {
  return -1;
}

// prepare + device-mirror update feed: for each newly inserted key, emits
// (slot, key_hi, key_lo, row) so the caller can scatter the same entries
// into the HBM mirror (ps/device_index.py). If the map grew during this
// call (generation changed), the slot list is stale — callers MUST check
// pbx_map_generation and fall back to a full export.
int64_t pbx_map_prepare_dev(void* h, const uint64_t* keys, int64_t n,
                            int create, int skip, uint64_t skip_key,
                            int64_t next_row, int32_t* rows_out,
                            int32_t* inverse_out, int32_t* uniq_rows_out,
                            int64_t* n_new_out, int64_t* new_slots_out,
                            uint32_t* new_hi_out, uint32_t* new_lo_out,
                            int32_t* new_rows_out) try {
  return map_prepare_impl(static_cast<Map64*>(h), keys, n, create, skip,
                          skip_key, next_row, rows_out, inverse_out,
                          uniq_rows_out, n_new_out, new_slots_out,
                          new_hi_out, new_lo_out, new_rows_out);
} catch (const std::bad_alloc&) {
  return -1;
}

// Collect the keys (non-zero) that are NOT in the map into out[];
// returns the count. Block-prefetched find-only scan — the host-side
// new-key detector of the device-prep engine (a device->host miss read
// is not an option on backends where any d2h degrades the stream).
int64_t pbx_map_missing(void* h, const uint64_t* keys, int64_t n,
                        uint64_t* out) {
  Map64* m = static_cast<Map64*>(h);
  size_t hs[kBlock];
  int64_t cnt = 0;
  for (int64_t base = 0; base < n; base += kBlock) {
    const int nb = static_cast<int>(std::min<int64_t>(kBlock, n - base));
    for (int j = 0; j < nb; ++j) {
      hs[j] = Map64::hash(keys[base + j]) & m->mask;
      __builtin_prefetch(&m->tab[hs[j]], 0);
    }
    for (int j = 0; j < nb; ++j) {
      const uint64_t k = keys[base + j];
      if (k == 0) continue;
      if (m->find(k) < 0) out[cnt++] = k;
    }
  }
  return cnt;
}

int64_t pbx_map_capacity(void* h) {
  return static_cast<int64_t>(static_cast<Map64*>(h)->mask + 1);
}

int64_t pbx_map_generation(void* h) {
  return static_cast<int64_t>(static_cast<Map64*>(h)->generation);
}

int64_t pbx_map_guard() { return kGuard; }
int64_t pbx_map_max_run() { return kMaxRun; }

// Full dump of the table in SLOT order for the device mirror, directly in
// the mirror's interleaved [total, 4] u32 quad layout (key_hi, key_lo,
// row, 0); empty slots -> hi=lo=0xFFFFFFFF, row 0. One sequential pass —
// the buffer uploads to HBM as-is, no host-side re-packing.
void pbx_map_export(void* h, uint32_t* out4) {
  Map64* m = static_cast<Map64*>(h);
  const size_t total = m->mask + 1 + kGuard;
  for (size_t p = 0; p < total; ++p) {
    uint32_t* q = out4 + p * 4;
    if (m->tab[p].nkey == 0) {
      q[0] = 0xFFFFFFFFu;
      q[1] = 0xFFFFFFFFu;
      q[2] = 0;
    } else {
      const uint64_t k = ~m->tab[p].nkey;
      q[0] = static_cast<uint32_t>(k >> 32);
      q[1] = static_cast<uint32_t>(k);
      q[2] = static_cast<uint32_t>(m->tab[p].row);
    }
    q[3] = 0;
  }
}

}  // extern "C"
