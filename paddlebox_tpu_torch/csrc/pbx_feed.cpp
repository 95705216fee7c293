// Text slot-block tokenizer of the columnar file feed: one pass over a raw
// MultiSlot text buffer -> columnar arrays (keys / per-slot lengths / dense
// floats / labels). data/fast_feed.py FastSlotReader calls it through
// ps/native.py parse_block (ctypes, which releases the GIL for the call);
// ops/_build.py compiles it with g++ at first use.
//
// Beside it, pbx_pack_cols: the staged device feed's one pass from a
// batch's columnar views into its wire row (data/device_feed.py
// pack_cols_row, through ps/native.py pack_cols), a copy of the
// reference's csrc/pbx_ps.cpp pbx_pack_cols.
//
// A copy of the tokenizer part of the reference's csrc/pbx_ps.cpp
// (feed_skip_ws, feed_parse_u64, feed_parse_f32, pbx_parse_block), kept
// byte for byte in behaviour: the same accepted syntax, the same
// out-of-range rejections, the same row numbering of a malformed record.
//
// Line format (MultiSlot): for each configured slot, "<count> <vals...>".
// kinds[i] describes slot i: 0=sparse used (uint64 keys out), 1=sparse
// skipped, 2=float used (floats out), 3=label (first value -> labels),
// 4=float skipped.
//
// No external dependencies; one call touches only its own buffers.

#include <charconv>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline const char* feed_skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* feed_parse_u64(const char* p, const char* end,
                                  uint64_t* out) {
  uint64_t v = 0;
  const char* q = p;
  while (q < end && *q >= '0' && *q <= '9') {
    v = v * 10 + static_cast<uint64_t>(*q - '0');
    ++q;
  }
  *out = v;
  return q == p ? nullptr : q;
}

// Float token parse with a portable fallback: libstdc++ ships
// floating-point std::from_chars only from gcc 11 (__cpp_lib_to_chars);
// on older toolchains fall back to strtof on a bounded stack copy (the
// input block is NOT null-terminated at `end`, so strtof cannot run on
// it directly). The fallback mirrors from_chars semantics: no leading
// '+', no leading whitespace (the caller already skipped it).
inline const char* feed_parse_f32(const char* p, const char* end,
                                  float* out) {
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
  auto res = std::from_chars(p, end, *out);
  if (res.ec != std::errc() || res.ptr == p) return nullptr;
  return res.ptr;
#else
  // Divergences from from_chars are closed explicitly so a file parses
  // the same on every toolchain: no leading '+', no hex literals,
  // out-of-range REJECTS the line (strtof would return +/-inf and
  // poison training), and a token at the copy cap rejects instead of
  // silently truncating-and-reparsing the remainder.
  if (p >= end || *p == '+') return nullptr;
  char tmp[64];
  int64_t n = 0;
  while (p + n < end && n < 63 && p[n] != ' ' && p[n] != '\t' &&
         p[n] != '\r' && p[n] != '\n') {
    tmp[n] = p[n];
    ++n;
  }
  if (n >= 63) return nullptr;  // token hit the cap: cannot parse safely
  tmp[n] = '\0';
  const char* digits = tmp[0] == '-' ? tmp + 1 : tmp;
  if (digits[0] == '0' && (digits[1] == 'x' || digits[1] == 'X')) {
    return nullptr;  // from_chars(general) has no hex floats
  }
  char* q = nullptr;
  errno = 0;
  float v = strtof(tmp, &q);
  if (q == tmp) return nullptr;
  // glibc sets ERANGE for underflow to a REPRESENTABLE subnormal too
  // (which from_chars accepts) — only overflow to +/-inf and underflow
  // to zero are truly out-of-range on both toolchains
  if (errno == ERANGE && (std::isinf(v) || v == 0.0f)) return nullptr;
  *out = v;
  return p + (q - tmp);
#endif
}

}  // namespace

extern "C" {

// Returns rows parsed (>= 0), or -(bad_row + 1) on a malformed/overflowing
// record. out_counts = {rows, n_keys, n_floats}.
int64_t pbx_parse_block(const char* buf, int64_t len, const int32_t* kinds,
                        int32_t n_slots, int64_t max_rows, uint64_t* keys,
                        int64_t keys_cap, int32_t* lengths, float* floats,
                        int64_t floats_cap, int32_t* flengths, float* labels,
                        int64_t* out_counts) {
  int32_t ns = 0, nfu = 0;
  for (int32_t s = 0; s < n_slots; ++s) {
    if (kinds[s] == 0) ++ns;
    if (kinds[s] == 2) ++nfu;
  }
  const char* p = buf;
  const char* end = buf + len;
  int64_t rows = 0, nk = 0, nf = 0;
  while (p < end && rows < max_rows) {
    while (p < end && (*p == '\n' || *p == ' ' || *p == '\r' ||
                       *p == '\t')) {
      ++p;
    }
    if (p >= end) break;
    int32_t* lrow = lengths + rows * ns;
    int32_t* frow = flengths + rows * nfu;
    labels[rows] = 0.0f;
    int32_t si = 0, fi = 0;
    bool ok = true;
    for (int32_t s = 0; s < n_slots && ok; ++s) {
      p = feed_skip_ws(p, end);
      uint64_t cnt = 0;
      const char* q = feed_parse_u64(p, end, &cnt);
      if (q == nullptr) {
        ok = false;
        break;
      }
      p = q;
      const int32_t kind = kinds[s];
      for (uint64_t j = 0; j < cnt && ok; ++j) {
        p = feed_skip_ws(p, end);
        if (kind == 0 || kind == 1) {
          uint64_t v = 0;
          q = feed_parse_u64(p, end, &v);
          if (q == nullptr) {
            ok = false;
            break;
          }
          p = q;
          if (kind == 0) {
            if (nk >= keys_cap) {
              ok = false;
              break;
            }
            keys[nk++] = v;
          }
        } else {
          float v = 0.0f;
          const char* fq = feed_parse_f32(p, end, &v);
          if (fq == nullptr) {
            ok = false;
            break;
          }
          p = fq;
          if (kind == 2) {
            if (nf >= floats_cap) {
              ok = false;
              break;
            }
            floats[nf++] = v;
          } else if (kind == 3 && j == 0) {
            labels[rows] = v;
          }
        }
      }
      if (!ok) break;
      if (kind == 0) lrow[si++] = static_cast<int32_t>(cnt);
      else if (kind == 2) frow[fi++] = static_cast<int32_t>(cnt);
    }
    if (!ok) return -(rows + 1);
    // only whitespace may remain before the newline
    while (p < end && *p != '\n') {
      if (*p != ' ' && *p != '\r' && *p != '\t') return -(rows + 1);
      ++p;
    }
    ++rows;
  }
  out_counts[0] = rows;
  out_counts[1] = nk;
  out_counts[2] = nf;
  return rows;
}

// The staged wire row of one batch: khi[npad] | klo[npad] | lengths[B*S]
// | labels[B] | dense[B*Dd] | nrows, all 32-bit words. No segment
// expansion and no padding arrays: the step rebuilds the segment ids, the
// row mask and the cvm input on the device from lengths and nrows. The
// tails are zeroed, because ring rows are reused (a stale key would alias
// a real one).
void pbx_pack_cols(const uint64_t* keys, int64_t num_keys,
                   const int32_t* lengths, int64_t num_rows,
                   const float* labels, const float* dense,
                   int64_t batch, int64_t n_slots, int64_t dense_dim,
                   int64_t npad, uint32_t* out) {
  uint32_t* hi = out;
  uint32_t* lo = out + npad;
  for (int64_t i = 0; i < num_keys; ++i) {
    hi[i] = static_cast<uint32_t>(keys[i] >> 32);
    lo[i] = static_cast<uint32_t>(keys[i]);
  }
  std::memset(hi + num_keys, 0, sizeof(uint32_t) * (npad - num_keys));
  std::memset(lo + num_keys, 0, sizeof(uint32_t) * (npad - num_keys));
  uint32_t* q = out + 2 * npad;
  std::memcpy(q, lengths, sizeof(uint32_t) * num_rows * n_slots);
  std::memset(q + num_rows * n_slots, 0,
              sizeof(uint32_t) * (batch - num_rows) * n_slots);
  q += batch * n_slots;
  std::memcpy(q, labels, sizeof(float) * num_rows);
  std::memset(q + num_rows, 0, sizeof(float) * (batch - num_rows));
  q += batch;
  std::memcpy(q, dense, sizeof(float) * num_rows * dense_dim);
  std::memset(q + num_rows * dense_dim, 0,
              sizeof(float) * (batch - num_rows) * dense_dim);
  q += batch * dense_dim;
  *q = static_cast<uint32_t>(num_rows);
}

}  // extern "C"
