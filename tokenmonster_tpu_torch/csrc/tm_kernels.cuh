// Per-thread arithmetic of the four tokenization kernels.
//
// Every function here is __host__ __device__: tm_kernels.cu wraps each in a
// CUDA kernel, and tm_host.cpp wraps the same functions in plain host loops
// so that a CPU-only test can compile them with g++ and hold them against
// the PyTorch plain versions (tokenmonster_tpu_torch/ops/*.py).
//
// Word formats are those of the JAX package, so stage outputs compare one
// to one:
//   match   M(p) = (idx << 6) | len, 0 = no match (Mb(p): len includes the
//           virtual space prefix)
//   decide  ctl = delta | fd'<<6 | has_tok<<7 | has_del<<8 | miss<<9
//           tok = idx | w3<<S (w3 == 3: literal id)
//   follow  rec = (pos << 4) | fd' | has_tok<<1 | has_del<<2 | miss<<3,
//           tok = the token word, its low S + 2 bits
//   compact out[q_l + j] = tok | has_del<<(S + 2) for the kept records of
//           lane l
// S, the token word's shift (``w3_shift`` in the argument structs), is 20
// below 2^20 dictionary entries, where the words are the JAX package's bit
// for bit, and from there the fewest bits, 21 to 24, that hold every
// dictionary index and the unk and delete ids (ops/tables.py::w3_shift); a
// compacted word fits S + 3 bits, 27 at most.  The hash placement's index
// fields hold idx+1 in up to 24 bits (2^24 - 2 entries, every vocabulary of
// the format's 24-bit ids), so a match word fits 30 bits.
//
// The argument structs are mirrored field for field by ctypes.Structure
// classes in ops/_build.py; change both together.  A dispatch's valid byte
// count ``n`` is a pointer to a device int32 (ops/scan.py keeps each
// dispatch's n, last lane and final flag in one small device array), so a
// captured CUDA graph serves texts of every length: only the geometry
// (buffer length N, lanes, chunk, record rows) is fixed at launch.
#pragma once
#include <stdint.h>

#if defined(__CUDACC__)
#define TM_HD __host__ __device__ __forceinline__
#else
#define TM_HD inline
#endif

#if defined(__CUDACC__)
#define TM_UNROLL _Pragma("unroll")
#else
#define TM_UNROLL
#endif

#if defined(__CUDA_ARCH__)
#define TM_LDG(p) __ldg(p)
#define TM_CLZ64(x) __clzll((long long)(x))
#else
#define TM_LDG(p) (*(p))
#define TM_CLZ64(x) __builtin_clzll(x)
#endif

namespace tmk {

constexpr uint32_t SEED = 0x811C9DC5u;  // ops/hashmatch.py SEED, C1, C2
constexpr uint32_t C1 = 0x9E3779B1u;
constexpr uint32_t C2 = 0x85EBCA6Bu;
constexpr uint32_t FILTER_MULT = 0x27D4EB2Fu;      // ops/tables.py key_filter
constexpr uint32_t FILTER_MULT2 = 0x2C1B3C6Du;
constexpr uint32_t FILTER_LEN_MULT = 0x9E3779B9u;
constexpr int32_t MAX_KEY_LEN = 63;                // candidate lengths: 64-bit mask

// Per-class descriptor row (int32, DESC_W wide); built by ops/tables.py.
enum {
  D_LEN = 0,         // key length l
  D_S = 1,           // slot count S (multiple of 128)
  D_BBITS = 2,       // log2(buckets); 0 = one bucket
  D_SALT = 3,        // g-hash salt (u32 bit pattern)
  D_NF = 4,          // int32 field planes per slot
  D_FOFF = 5,        // offset of plane 0 in the flat field array
  D_STRIDE = 6,      // elements between planes (8-row padded R8 * 128)
  D_DOFF = 7,        // offset of the u16-pair displacement plane
  D_NOVF = 8,        // overflow keys (full-hash collisions)
  D_OVF_BYTES = 9,   // offset of their raw bytes in the overflow blob
  D_OVF_SCALARS = 10,  // index of their idx+1 entries in the scalar vector
  D_NSCALE = 11,     // NAF terms of S
  D_SCALE = 12,      // terms, each k*2 + (sign < 0)
  DESC_W = 32,
};
constexpr int MAX_SCALE = DESC_W - D_SCALE;

struct MatchArgs {
  const uint8_t* text;
  const int32_t* fields;
  const int32_t* disp;
  const int32_t* single;        // (256,) idx+1 of 1-byte keys
  const int32_t* space_single;  // (256,) idx+1 of stripped 1-byte keys
  const int32_t* scalars;       // [space_empty+1, overflow idx+1 ...]
  const int32_t* desc;          // (n_cls, DESC_W)
  const int32_t* len_cls;       // (max_len+1,) class of each length, -1
  const uint8_t* ovf_keys;
  uint32_t* m;
  uint32_t* mb;                 // written only when has_space
  const int32_t* n;             // valid bytes, on the device (a dispatch's
                                // scalar, ops/scan.py): matches end at or
                                // before n
  int64_t N;                    // buffer length (positions computed)
  int32_t max_len;
  int32_t idx1_bits;
  int32_t has_space;
  int32_t lil_off;
  const uint32_t* filt;         // key filter, 2^(filt_log2 - 5) words
  int32_t filt_log2;
  int32_t n_cls;                // rows of desc
  int32_t disp_words;           // length of disp
  int32_t pad_;
};

struct DecideArgs {
  const uint32_t* m;
  const uint32_t* mb;           // == m when the vocabulary has no delete
  const uint8_t* text;
  const int32_t* entries;       // (rows, n_entries, 4): ops/tables.py
                                // decide_entries
  const int32_t* bb;            // (256,) begin-byte class, each below 256
  uint32_t* ctl;                // (rows, N)
  uint32_t* tok;
  const int32_t* n;             // valid bytes, on the device
  const int32_t* literals;      // [unk id, has unk, delete id] on the device
                                // (ops/tables.py): a trainer candidate's,
                                // so a captured score chain serves every
                                // candidate
  int64_t N;
  int64_t n_entries;            // R*128
  int32_t has_delete;
  int32_t lil_off;
  int32_t w3_shift;             // S: tok = idx | w3 << S
  int32_t pad_;
};

struct FollowArgs {
  const uint32_t* ctl;          // (rows, N)
  const uint32_t* tok;
  uint32_t* recs;               // (t_rec, L)
  uint32_t* toks;
  int32_t* done_all;            // set to 1 by the caller; lanes clear it
  const int32_t* n;             // valid bytes, on the device
  int64_t N;
  int32_t rows;
  int32_t chunk;
  int32_t overlap;
  int32_t W;                    // per-lane window (JAX kernel geometry)
  int32_t L;
  int32_t t_rec;
  int32_t w3_shift;             // S: token words keep their low S + 2 bits
  int32_t pad_;
};

struct CompactArgs {
  const uint32_t* recs;         // (T, L)
  const uint32_t* toks;
  const int32_t* s;             // (L,) first kept record
  const int32_t* e;             // (L,) last kept record (inclusive)
  const int32_t* q;             // (L,) output slot of record 0
  uint32_t* out;                // [out_len]: the kernel writes every word
  int64_t out_len;
  int32_t T;
  int32_t L;
  int32_t w3_shift;             // S: the delete marker is bit S + 2
  int32_t pad_;
};

TM_HD uint32_t byte_at(const uint8_t* t, int64_t N, int64_t q) {
  return q < N ? (uint32_t)t[q] : 0u;
}

TM_HD uint32_t word_at(const uint32_t* w, int64_t N, int64_t q) {
  return q < N ? w[q] : 0u;
}

TM_HD int32_t clip127(int32_t d) { return d < 0 ? 0 : (d > 127 ? 127 : d); }

// ---------------------------------------------------------------- match
// Longest dictionary match at p (ops/pallas_match.py kernel body): the
// same poly hash, CHD bucket/slot math and exact key compare, one class
// probe per key length, longer hits overriding shorter ones.
//
// The kernel (tm_kernels.cu) stages a tile of text in shared memory and
// holds the small tables there; this per-position code reads them through
// pointers, so the host harness runs it on ordinary arrays.  The text
// window ``win`` holds the bytes [p0, p0 + len) as little-endian u32 words,
// zero past N; position p sits at byte offset t = p - p0.

// The tables a position reads often: in shared memory in the kernel.
struct MatchTables {
  const int32_t* desc;          // (n_cls, desc_stride), stride >= DESC_W
  const int32_t* len_cls;       // (max_len+1,)
  const int32_t* single;        // (256,)
  const int32_t* space_single;  // (256,)
  const int32_t* disp;          // disp_words
  const uint32_t* filt;         // 2^(filt_log2-5) words
  int32_t desc_stride;          // words between rows: the kernel pads them
                                // to an odd count, so that threads reading
                                // one field of different classes hit
                                // different shared-memory banks
};

constexpr int32_t PLANE_BATCH = 4;  // key planes loaded together on a hit
constexpr int32_t KEEP = 2;         // longest candidates kept with their hash

TM_HD uint32_t win_byte(const uint32_t* win, int32_t o) {
  return (win[o >> 2] >> ((o & 3) * 8)) & 0xFFu;
}

// Bytes o, o+1, ... of the window from bit 0 up: two word loads and a
// funnel shift, at least 40 valid bits.
TM_HD uint64_t win_load64(const uint32_t* win, int32_t o) {
  const int32_t q = o >> 2;
  const uint64_t v = ((uint64_t)win[q + 1] << 32) | (uint64_t)win[q];
  return v >> ((o & 3) * 8);
}

// 32 bits of the text stream at byte offset t, from its bit s (s > -32):
// bit i of the result is text bit s + i, zero below the text's bit 0.  The
// key bits of a slot's field plane f sit at payload bits ib + 8k, so plane
// f lines up with the text stream from bit 32 f - ib.
TM_HD uint32_t win_bits(const uint32_t* win, int32_t t, int32_t s) {
  if (s < 0) return (uint32_t)win_load64(win, t) << (-s);
  return (uint32_t)(win_load64(win, t + (s >> 3)) >> (s & 7));
}

// Whether both key-filter bits of a window of length l whose poly hash is
// h are set (ops/tables.py filter_mix): if not, no key of length l is
// there.
TM_HD bool filter_passes(const uint32_t* filt, uint32_t h, int32_t l, int32_t log2) {
  const uint32_t x = (h + (uint32_t)l * FILTER_LEN_MULT) * FILTER_MULT;
  const uint32_t b1 = x >> (32 - log2);
  if (!((filt[b1 >> 5] >> (b1 & 31u)) & 1u)) return false;
  const uint32_t b2 = ((x ^ (x >> 15)) * FILTER_MULT2) >> (32 - log2);
  return (filt[b2 >> 5] >> (b2 & 31u)) & 1u;
}

// Whether field plane f of a slot (word w) holds the window's key bits:
// payload bits [ib, kend) are the key bytes, plane f bits [32f, 32f+32).
TM_HD bool key_plane_equal(uint32_t w, const uint32_t* win, int32_t t,
                           int32_t f, int32_t ib, int32_t kend) {
  const int32_t lo = ib - 32 * f, hi = kend - 32 * f;
  uint32_t m = hi >= 32 ? 0xFFFFFFFFu : ((1u << hi) - 1u);
  if (lo > 0) m &= ~((1u << lo) - 1u);
  return ((w ^ win_bits(win, t, 32 * f - ib)) & m) == 0;
}

// One class probe of the window's first l bytes (poly hash h): the main
// and space-stripped dictionary index + 1 of the key it holds, each 0 when
// there is none (or, on masked tables, when it is dead).  The CHD slot,
// then the key 32 bits at a time: its first plane alone (most probes that
// pass the filter and still miss end there), then the rest of a hit's
// planes PLANE_BATCH at a time, their loads in flight together; then the
// class's overflow keys, byte by byte.
TM_HD void match_probe(const MatchArgs& a, const MatchTables& tb,
                       const uint32_t* win, int32_t t, int32_t l, uint32_t h,
                       int32_t& im, int32_t& is) {
  const int32_t* d = tb.desc + (int64_t)tb.len_cls[l] * tb.desc_stride;
  const int32_t S = d[D_S];
  const int32_t bbits = d[D_BBITS];
  // bucket: top b_bits of h*C1; a shift by 32 is undefined, so 0 bits is
  // its own case
  const uint32_t bucket = bbits ? (h * C1) >> (32 - bbits) : 0u;
  // slot hash g: the truncated NAF sum of hashmatch.scale_to, not a high
  // multiply (which differs by up to the number of terms)
  const uint32_t y = (h ^ (uint32_t)d[D_SALT]) * C2;
  int32_t g = 0;
  for (int32_t i = 0; i < d[D_NSCALE]; ++i) {
    const int32_t e = d[D_SCALE + i];
    const int32_t term = (int32_t)(y >> (32 - (e >> 1)));
    g += (e & 1) ? -term : term;
  }
  g = g < 0 ? 0 : (g > S - 1 ? S - 1 : g);
  const uint32_t dw = (uint32_t)tb.disp[d[D_DOFF] + (bucket >> 1)];
  const uint32_t dd = ((bucket & 1u) ? (dw >> 16) : dw) & 0xFFFFu;
  int32_t slot = g + (int32_t)dd;
  if (slot >= S) slot -= S;
  const int32_t* F = a.fields + d[D_FOFF] + slot;
  const int64_t stride = d[D_STRIDE];
  const int32_t n_idx = a.has_space ? 2 : 1;
  const int32_t ib = a.idx1_bits * n_idx;
  const int32_t kend = ib + 8 * l;
  const int32_t nf = d[D_NF];
  int32_t f = ib >> 5;
  const uint32_t w_first = (uint32_t)TM_LDG(F + f * stride);
  bool eq = key_plane_equal(w_first, win, t, f, ib, kend);
  uint32_t w0 = w_first;
  if (eq && f > 0) w0 = (uint32_t)TM_LDG(F);
  for (++f; eq && f < nf; f += PLANE_BATCH) {
    uint32_t w[PLANE_BATCH];
    TM_UNROLL
    for (int32_t j = 0; j < PLANE_BATCH; ++j)
      w[j] = f + j < nf ? (uint32_t)TM_LDG(F + (f + j) * stride) : 0u;
    TM_UNROLL
    for (int32_t j = 0; j < PLANE_BATCH; ++j)
      if (f + j < nf) eq = eq && key_plane_equal(w[j], win, t, f + j, ib, kend);
  }
  im = is = 0;
  if (eq) {
    const uint32_t imask = (1u << a.idx1_bits) - 1u;
    im = (int32_t)(w0 & imask);
    if (a.has_space) {
      uint32_t sw = w0 >> a.idx1_bits;
      if (2 * a.idx1_bits > 32) sw |= (uint32_t)TM_LDG(F + stride) << (32 - a.idx1_bits);
      is = (int32_t)(sw & imask);
    }
    return;  // the window is this key, so it is no overflow key
  }
  // keys whose full hash collides with a placed key: direct compare
  for (int32_t j = 0; j < d[D_NOVF]; ++j) {
    const uint8_t* key = a.ovf_keys + d[D_OVF_BYTES] + (int64_t)j * l;
    bool ok = true;
    for (int32_t k = 0; k < l && ok; ++k) ok = key[k] == win_byte(win, t + k);
    if (!ok) continue;
    const int32_t* sc = a.scalars + d[D_OVF_SCALARS] + j * n_idx;
    im = sc[0];
    if (a.has_space) is = sc[1];
    return;
  }
}

// Bit l set for each key length l that has a class: the lengths the key
// filter is asked about.
TM_HD uint64_t class_lengths(const MatchTables& tb, int32_t max_len) {
  uint64_t mask = 0;
  for (int32_t l = 1; l <= max_len; ++l)
    if (tb.len_cls[l] >= 0) mask |= 1ull << l;
  return mask;
}

TM_HD uint32_t hash_window(const uint32_t* win, int32_t t, int32_t l) {
  uint32_t h = SEED;
  for (int32_t k = 0; k < l; ++k) {
    h = h * 257u + win_byte(win, t + k);
    h ^= h >> 11;
  }
  return h;
}

// The search for M (and Mb) at one position: the words found so far,
// which are still wanted, and the lengths still to probe.
struct MatchState {
  int32_t best, bestb;
  bool need_m, need_b;
  uint64_t cand;       // lengths that passed the key filter, not yet probed
  int32_t kl[KEEP];    // the longest of them, longest first, with their
  uint32_t kh[KEEP];   // poly hashes (0 where fewer passed)
};

// Position p (window offset t): the single-byte and bare-prefix words,
// then every length's hash against the key filter, from the window, 4
// bytes per read and 4 lengths per batch of filter loads: lengths that
// fail it hold no key.  ``lengths`` is class_lengths.
TM_HD MatchState match_begin(const MatchArgs& a, const MatchTables& tb, uint64_t lengths,
                             const uint32_t* win, int32_t t, int64_t p) {
  MatchState st;
  const int32_t n = TM_LDG(a.n);
  const uint32_t t0 = win_byte(win, t);
  const bool fits1 = p + 1 <= n;
  st.best = st.bestb = 0;
  const int32_t s1 = tb.single[t0];
  if (s1 > 0 && fits1) st.best = ((s1 - 1) << 6) | 1;
  if (a.has_space) {
    // the bare prefix token matches everywhere, p >= n included
    const int32_t se = TM_LDG(a.scalars);
    if (se > 0) st.bestb = ((se - 1) << 6) | a.lil_off;
    const int32_t sp = tb.space_single[t0];
    if (sp > 0 && fits1) st.bestb = ((sp - 1) << 6) | (1 + a.lil_off);
  }
  st.need_m = true;
  st.need_b = a.has_space != 0;
  // a hit needs p + l <= n, so no longer length can hit past that point
  const int64_t room = (int64_t)n - p;
  const int32_t lmax = room < a.max_len ? (int32_t)(room < 0 ? 0 : room) : a.max_len;
  uint64_t cand = 0;
  uint32_t h = SEED;
  int32_t kl0 = 0, kl1 = 0;
  uint32_t kh0 = 0, kh1 = 0;
  for (int32_t l0 = 0; l0 < lmax; l0 += 4) {
    // four lengths at a time: their hashes and filter bits first, then the
    // eight filter words' loads together, then the tests
    const uint32_t four = (uint32_t)win_load64(win, t + l0);
    uint32_t hq[4], b1[4], b2[4];
    TM_UNROLL
    for (int32_t j = 0; j < 4; ++j) {
      h = h * 257u + ((four >> (8 * j)) & 0xFFu);
      h ^= h >> 11;
      hq[j] = h;
      const uint32_t x = (h + (uint32_t)(l0 + j + 1) * FILTER_LEN_MULT) * FILTER_MULT;
      b1[j] = x >> (32 - a.filt_log2);
      b2[j] = ((x ^ (x >> 15)) * FILTER_MULT2) >> (32 - a.filt_log2);
    }
    uint32_t w1[4], w2[4];
    TM_UNROLL
    for (int32_t j = 0; j < 4; ++j) {
      w1[j] = tb.filt[b1[j] >> 5];
      w2[j] = tb.filt[b2[j] >> 5];
    }
    TM_UNROLL
    for (int32_t j = 0; j < 4; ++j) {
      const int32_t l = l0 + j + 1;
      if (l <= lmax && ((lengths >> l) & 1u) && ((w1[j] >> (b1[j] & 31u)) & (w2[j] >> (b2[j] & 31u)) & 1u)) {
        cand |= 1ull << l;
        kl1 = kl0;
        kh1 = kh0;
        kl0 = l;
        kh0 = hq[j];
      }
    }
  }
  st.cand = cand;
  st.kl[0] = kl0;
  st.kl[1] = kl1;
  st.kh[0] = kh0;
  st.kh[1] = kh1;
  return st;
}

// The result of probing length l: M (and Mb) take the longest hit with an
// index, so a probe in descending order settles each at its first hit.
TM_HD void match_take(const MatchArgs& a, MatchState& st, int32_t l, int32_t im, int32_t is) {
  if (st.need_m && im > 0) {
    st.best = ((im - 1) << 6) | l;
    st.need_m = false;
  }
  if (st.need_b && is > 0) {
    st.bestb = ((is - 1) << 6) | (l + a.lil_off);
    st.need_b = false;
  }
  st.cand &= ~(1ull << l);
}

TM_HD bool match_wants(const MatchState& st) { return st.cand && (st.need_m || st.need_b); }

// A hit as one word of the kernel's shared hit list (tm_kernels.cu
// match_lane), where atomicMax keeps a position's longest: the length (6
// bits, MAX_KEY_LEN) above the index (HIT_IDX_BITS, the widest index field:
// the format's 24-bit ids, ops/tables.py ID_BITS; change both together).
constexpr int32_t HIT_IDX_BITS = 24;

TM_HD uint32_t match_hit(int32_t l, int32_t idx) {
  return ((uint32_t)l << HIT_IDX_BITS) | (uint32_t)idx;
}

// The match word of hit word r, its length plus ``add`` (Mb's lil_off).
TM_HD int32_t match_hit_word(uint32_t r, int32_t add) {
  return (int32_t)(((r & ((1u << HIT_IDX_BITS) - 1u)) << 6) | ((r >> HIT_IDX_BITS) + (uint32_t)add));
}

// Probe the longest length left, its hash kept or hashed again.
TM_HD void match_next(const MatchArgs& a, const MatchTables& tb, const uint32_t* win,
                      int32_t t, MatchState& st) {
  const int32_t l = 63 - TM_CLZ64(st.cand);
  uint32_t h;
  if (l == st.kl[0]) {
    h = st.kh[0];
  } else if (l == st.kl[1]) {
    h = st.kh[1];
  } else {
    h = hash_window(win, t, l);
  }
  int32_t im, is;
  match_probe(a, tb, win, t, l, h, im, is);
  match_take(a, st, l, im, is);
}

TM_HD void match_end(const MatchArgs& a, const MatchState& st, int64_t p) {
  a.m[p] = (uint32_t)st.best;
  if (a.has_space) a.mb[p] = (uint32_t)st.bestb;
}

// M (and Mb) at p, the window's byte offset t: the longest length l whose
// window is a key with a main (and, for Mb, a space-stripped) index.  The
// lengths that pass the key filter are probed longest first, and the
// search ends once M (and Mb) are found, so most positions probe one or
// two lengths.  (The kernel runs the same search with the probes after
// the first shared among a warp's lanes; tm_kernels.cu.)
TM_HD void match_window(const MatchArgs& a, const MatchTables& tb, uint64_t lengths,
                        const uint32_t* win, int32_t t, int64_t p) {
  MatchState st = match_begin(a, tb, lengths, win, t, p);
  while (match_wants(st)) match_next(a, tb, win, t, st);
  match_end(a, st, p);
}

// The window word j of a tile starting at p0: bytes p0 + 4j .. + 3, zero
// past N.
TM_HD uint32_t match_win_word(const MatchArgs& a, int64_t p0, int32_t j) {
  const int64_t q = p0 + 4 * (int64_t)j;
  uint32_t w = 0;
  for (int32_t k = 0; k < 4; ++k) w |= byte_at(a.text, a.N, q + k) << (8 * k);
  return w;
}

// Positions of the match kernel's warp tile: each lane of a warp takes
// MATCH_PER_LANE of them.  The host harness (tm_host.cpp) and the tests
// read it through tm_match_tile.
constexpr int32_t MATCH_PER_LANE = 2;
constexpr int32_t MATCH_TILE = 32 * MATCH_PER_LANE;

// Words of a tile's window: tile positions, then max_len bytes of
// lookahead, then two words of slack for the funnel-shift loads.
TM_HD int32_t match_win_words(int32_t tile, int32_t max_len) {
  return (tile + max_len + 3) / 4 + 3;
}

// --------------------------------------------------------------- decide
// The exact 6-branch ungreedy decision at (fd, p) (ops/pallas_decide.py
// kernel body; go/tokenmonster.go:1057, :1075-1108, tie order :1132-1133).
// Reads past N see zero words and zero text bytes, as the JAX kernel's
// zero margin rows do: a zero byte still maps through begin-byte and a
// zero match word still fetches the metadata of index 0.
//
// A decision takes up to three branches: its first token is the match or
// one of the match's two alternatives, its second the token matched right
// after the first, under M or (the forward-delete branches) under Mb.  A
// branch's score is
//   bl + (f >> 7) + (sf >> 7) + max0(fnw - 1) + max0(snw - 1) + (sf >> 2 & 1)
//      + (nb >> 2 & 1) + 100 (fnw + snw + (nb >> 3)) - deductions,
// bl the two lengths, f/fnw and sf/snw the flags and word counts of the
// first and second token, nb the begin-byte class of the byte after the
// second.  Three kinds of term, each summed where it is known:
//   - the first token's, once per token and fd row on the host: the
//     decide entries of ops/tables.py, four words a token
//   - the second token's and the next byte's, which depend on the text
//     position alone, once per position: decide_stage packs them into a
//     pair of words, held in shared memory for a tile and its DECIDE_REACH
//     positions of lookahead
//   - the deductions that join the two, per branch, in decide_tile_at,
//     from flag bits that sit at the same bit of an entry and of a pair.
// Token lengths are at most 63 (the match word's 6 bits), so a second
// token lies within 63 positions and the byte after it within 126: the
// clamp of every offset to 127 never moves a read a decision uses.
constexpr int32_t NEG = -1000000;
constexpr int32_t DECIDE_REACH = 128;  // every offset is clamped by clip127
constexpr int32_t DECIDE_THREADS = 256;
constexpr int32_t DECIDE_PER = 2;      // positions per thread
constexpr int32_t DECIDE_TILE = DECIDE_THREADS * DECIDE_PER;

// Entry words of a token as the first of branch r (ops/tables.py
// decide_entries), f its flag and fnw its word count less fd:
//   bit 0     (word 0) the match's flag bit 5: no branch before class 12
//   bits 1-2  (word 0) how many alternatives stand: 0, 1, 2
//   bit 7     f & 1         bit 8  f >> 3 & 1
//   bits 9-23 (f >> 7) + max0(fnw - 1) + 100 fnw + 100
//   bits 24-31 (words 1, 2) the alternative's length less fd
// and word 3 the token's flag and word count, for decide_stage.
constexpr int32_t E_WORDS = 4;

// What decisions read of the tokens matched at one text position.  With
// sf/snw the flag and word count of M's token, nb the class of the byte
// after it, and the same of Mb's token (sfb, snwb, nbb; the byte after it
// lies lil_off earlier, the virtual space not being in the text):
//   a: bits 0-5  len(M)      bit 6  M != 0
//      bit 7  sf >> 1 & 1    bit 8  sf >> 4 & 1
//      bit 9  the forward-delete branch is wanted: sf >> 1 & 1, snw == 0,
//             nb == 1 and len(Mb) > len(M) + 1
//      bit 10 nb == 12
//      bits 11-25 len(M) + (sf >> 7) + max0(snw - 1) + (sf >> 2 & 1)
//             + 100 snw + (nb >> 2 & 1) + 100 (nb >> 3) - 3 (sf & nb & 1) + 3
//   b: bits 0-5  len(Mb)     bit 8  sfb >> 4 & 1     bit 10 nbb == 12
//      bits 11-25 len(Mb) + (sfb >> 7) + max0(snwb - 1) + 100 snwb
//             + (nbb >> 2 & 1) + 100 (nbb >> 3) - 3 (sfb & nbb & 1) + 3
struct alignas(8) DecideNb {
  uint32_t a, b;
};

// What a decision reads of its own token: the match word and the first
// three entry words of its fd row.
struct DecideOwn {
  uint32_t mf, w[3];
};

TM_HD int32_t max0(int32_t x) { return x > 0 ? x : 0; }

// The begin-byte table as class words:
//   (nb >> 2 & 1) + 100 (nb >> 3) | (nb & 1) << 12 | (nb == 1) << 13 |
//   (nb == 12) << 14
typedef uint16_t DecideCls;

TM_HD DecideCls decide_cls(uint32_t nb) {
  return (DecideCls)((((nb >> 2) & 1u) + 100u * (nb >> 3)) | ((nb & 1u) << 12) |
                     ((nb == 1u ? 1u : 0u) << 13) | ((nb == 12u ? 1u : 0u) << 14));
}

// Bits 10-25 of a pair word: a token of length len, flag f and word count
// nw as the second of a branch, before a byte of class word c; ``plain``
// adds the flag's bit 2, which the forward-delete branches leave out.
TM_HD uint32_t decide_second(uint32_t len, uint32_t f, uint32_t nw, uint32_t c, bool plain) {
  const uint32_t part = len + (f >> 7) + (uint32_t)max0((int32_t)nw - 1) + 100u * nw +
                        (plain ? (f >> 2) & 1u : 0u) + (c & 0xFFFu) + 3u - 3u * (f & (c >> 12) & 1u);
  return (((c >> 14) & 1u) << 10) | (part << 11);
}

// The entry of dictionary index idx in fd row fd: one 16-byte read.
struct alignas(16) DecideEntry {
  uint32_t w[E_WORDS];
};

TM_HD DecideEntry decide_entry(const DecideArgs& a, int32_t fd, uint32_t idx) {
  const int32_t* e = a.entries + ((int64_t)fd * a.n_entries + idx) * E_WORDS;
#if defined(__CUDA_ARCH__)
  const int4 v = __ldg((const int4*)e);
  return DecideEntry{{(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z, (uint32_t)v.w}};
#else
  return DecideEntry{{(uint32_t)e[0], (uint32_t)e[1], (uint32_t)e[2], (uint32_t)e[3]}};
#endif
}

// The class word of the text byte at q (zero past N).  ``cls_of`` is
// decide_cls of the begin-byte table: in shared memory in the kernel.
TM_HD uint32_t decide_cls_at(const DecideArgs& a, const DecideCls* cls_of, int64_t q) {
  return cls_of[q < a.N ? (uint32_t)TM_LDG(a.text + q) : 0u];
}

// The pair of text position q (match words zero past N) and in own[fd],
// unless own is null, what the decisions at q itself read.
TM_HD DecideNb decide_stage(const DecideArgs& a, const DecideCls* cls_of, int64_t q, DecideOwn* own) {
  const bool in = q < a.N;
  const uint32_t m = in ? TM_LDG(a.m + q) : 0u;
  const uint32_t mb = a.has_delete && in ? TM_LDG(a.mb + q) : 0u;
  const DecideEntry em = decide_entry(a, 0, m >> 6);
  const uint32_t len = m & 63u, sf = em.w[3] & 0xFFu, snw = (em.w[3] >> 8) & 0xFFu;
  const uint32_t c = decide_cls_at(a, cls_of, q + len);
  DecideNb w;
  w.a = len | (m ? 64u : 0u) | (((sf >> 1) & 1u) << 7) | (((sf >> 4) & 1u) << 8) |
        decide_second(len, sf, snw, c, true);
  w.b = 0u;
  if (own) own[0] = DecideOwn{m, {em.w[0], em.w[1], em.w[2]}};
  if (a.has_delete) {
    const DecideEntry eb = decide_entry(a, 1, mb >> 6);
    const uint32_t lenb = mb & 63u, sfb = eb.w[3] & 0xFFu, snwb = (eb.w[3] >> 8) & 0xFFu;
    const uint32_t cb = decide_cls_at(a, cls_of, q + max0((int32_t)lenb - a.lil_off));
    w.b = lenb | (((sfb >> 4) & 1u) << 8) | decide_second(lenb, sfb, snwb, cb, false);
    const bool want = ((sf >> 1) & 1u) && snw == 0u && ((c >> 13) & 1u) && lenb > len + 1u;
    w.a |= (want ? 1u : 0u) << 9;
    if (own) own[1] = DecideOwn{mb, {eb.w[0], eb.w[1], eb.w[2]}};
  }
  return w;
}

// The decision at (fd, p): ``nb[k]`` is the pair of position p + k, for k
// in [0, DECIDE_REACH), and ``o`` what decide_stage gave for (p, fd).
TM_HD void decide_tile_at(const DecideArgs& a, const DecideNb* nb, int64_t p, int32_t fd,
                          const DecideOwn& o) {
  const uint32_t mf = o.mf;
  const int32_t cur_idx = (int32_t)(mf >> 6);
  const int32_t cur_len = (int32_t)(mf & 63u) - fd * a.lil_off;
  const bool found = mf != 0;
  // the byte after the match is the one after the token matched here
  const uint32_t here = fd ? nb[0].b : nb[0].a;
  const int32_t n = TM_LDG(a.n);
  const bool do_eval = found && (p + cur_len < n) && !((o.w[0] & 1u) && ((here >> 10) & 1u));
  const int32_t n_first = do_eval ? 1 + (int32_t)((o.w[0] >> 1) & 3u) : 0;
  const int32_t first_len[3] = {cur_len, (int32_t)(o.w[1] >> 24), (int32_t)(o.w[2] >> 24)};

  // first hit of the largest score in the order s1 > s2 > s3 > s1b > s2b >
  // s3b: the plain branches first, each taking over only when larger
  int32_t mx = NEG, w6 = 0;
  int32_t scores_b[3] = {NEG, NEG, NEG};
  TM_UNROLL
  for (int r = 0; r < 3; ++r) {
    // a branch whose first token does not stand scores NEG both ways
    if (r >= n_first) break;
    const uint32_t w = o.w[r];
    const int32_t delta3 = first_len[r];
    const DecideNb second = nb[clip127(delta3)];
    if (!((second.a >> 6) & 1u)) continue;  // no second token
    // the first token's terms, less the 100 and the 3 the fields carry
    const int32_t first = delta3 + (int32_t)((w >> 9) & 0x7FFFu) - 103;
    {
      const uint32_t both = w & second.a;  // bit 7: f & sf >> 1, bit 8: f >> 3 & sf >> 4
      const int32_t bl = delta3 + (int32_t)(second.a & 63u);
      int32_t score = first + (int32_t)((second.a >> 11) & 0x7FFFu) - 103 * (int32_t)((both >> 7) & 1u) -
                      100 * (int32_t)((both >> 8) & 1u);
      if (r > 0) score -= (bl < cur_len ? 100 : 0) + (bl == cur_len ? 10000 : 0);
      if (score > mx) {
        mx = score;
        w6 = r;
      }
    }
    if ((second.a >> 9) & 1u) {
      // forward-delete branch: the second token re-probed with the
      // virtual space prefix
      const int32_t bl = delta3 + (int32_t)(second.b & 63u) - a.lil_off;
      int32_t score = first - a.lil_off - 1 + (int32_t)((second.b >> 11) & 0x7FFFu) -
                      103 * (int32_t)((w >> 7) & 1u) - 100 * (int32_t)(((w & second.b) >> 8) & 1u);
      if (r > 0) score -= (bl < cur_len ? 100 : 0) + (bl == cur_len ? 10000 : 0);
      scores_b[r] = score;
    }
  }
  TM_UNROLL
  for (int r = 0; r < 3; ++r)
    if (scores_b[r] > mx) {
      mx = scores_b[r];
      w6 = 3 + r;
    }
  const bool any_branch = mx != NEG;
  const int32_t w3 = w6 >= 3 ? w6 - 3 : w6;
  const bool is_b = any_branch && w6 >= 3;
  const int32_t adv = w3 == 0 ? first_len[0] : (w3 == 1 ? first_len[1] : first_len[2]);
  const int32_t new_pos_rel = found ? (any_branch ? adv : cur_len) : 1;
  const bool miss = !found && p < n;
  const bool has_tok = found || (miss && TM_LDG(a.literals + 1));
  // an alternative branch may advance 0 bytes: at fd = 1 one of length 1
  // is the virtual space alone (go/tokenmonster.go i += len1 - fd), and
  // the chain goes on from (p, fd = 0); the JAX kernel clamps this to 1
  const int32_t lo = any_branch && w3 > 0 ? 0 : 1;
  const int32_t delta_out = new_pos_rel < lo ? lo : (new_pos_rel > 63 ? 63 : new_pos_rel);
  const uint32_t ctl = (uint32_t)delta_out | (is_b ? (1u << 6) | (1u << 8) : 0u) |
                       (has_tok ? 1u << 7 : 0u) | (miss ? 1u << 9 : 0u);
  const uint32_t tok = miss ? ((3u << a.w3_shift) | (uint32_t)TM_LDG(a.literals))
                            : ((uint32_t)cur_idx | ((uint32_t)w3 << a.w3_shift));
  a.ctl[fd * a.N + p] = ctl;
  a.tok[fd * a.N + p] = tok;
}

// --------------------------------------------------------------- follow
// Chain-follow of one lane from (lane start, fd = 0) through chunk +
// overlap bytes (ops/pallas_follow.py; ops/decision.py::follow_lanes with
// packed=True).  Steps after the lane finishes write zero records.
//
// The kernel copies a tile of each lane's window, ``w = follow_pack(ctl,
// tok)`` over TW window positions, into shared memory and walks the chain
// there;
// a lane whose chain leaves its tile stops, and walks on once the tile is
// refilled from where it stopped (window positions only rise).  Tile
// layout: window position tb + k, fd row r at tile[k * rows + r], the rows
// of a position side by side.  A position past the window's last reads
// the last one's words, as the chain clamps its reads to W - 1.

struct FollowLane {
  int64_t start;
  int32_t stop;       // the chain is done once pos_rel >= stop
  int32_t t;          // next record row
  int32_t pos_rel;
  int32_t fd;
  bool done;
};

TM_HD FollowLane follow_begin(const FollowArgs& a, int32_t lane) {
  FollowLane s;
  s.start = (int64_t)lane * a.chunk;
  int64_t stop = (int64_t)TM_LDG(a.n) - s.start;
  const int64_t span = (int64_t)a.chunk + a.overlap;
  s.stop = (int32_t)(stop < -1 ? -1 : (stop > span ? span : stop));
  s.done = s.stop <= 0;
  s.t = 0;
  s.pos_rel = 0;
  s.fd = 0;
  return s;
}

// A decision as one tile word: ctl bits 0-7 (delta, fd', has_tok), miss
// at bit 8, the token word's S + 2 bits from bit 9.  has_del (ctl bit 8) is
// left out: decide sets it exactly with fd', and follow_walk writes fd' for
// both.  That is 9 + S + 2 bits: a u32 up to S = 21, a u64 above
// (follow_wide), whose tiles take twice the shared memory.
template <class W>
TM_HD W follow_pack(uint32_t ctl, uint32_t tok) {
  return (W)((ctl & 0xFFu) | (((ctl >> 9) & 1u) << 8)) | ((W)tok << 9);
}

TM_HD bool follow_wide(int32_t w3_shift) { return 9 + w3_shift + 2 > 32; }

TM_HD int32_t follow_word_bytes(int32_t w3_shift) { return follow_wide(w3_shift) ? 8 : 4; }

// The packed word of fd row ``row`` at window position ``k`` (clamped to
// the window) of a lane starting at ``start``: zero past N.
template <class W>
TM_HD W follow_word(const FollowArgs& a, int64_t start, int32_t row, int64_t k) {
  const int64_t q = start + (k < a.W - 1 ? k : a.W - 1);
  if (q >= a.N) return 0u;
  const int64_t at = (int64_t)row * a.N + q;
  return follow_pack<W>((uint32_t)TM_LDG(a.ctl + at), (uint32_t)TM_LDG(a.tok + at));
}

// Steps of one lane on a tile holding window positions [tb, tb + TW).
// Returns true when the next step reads past the tile: refill it from
// s.pos_rel and call again.  Returns false once the lane is done or t_rec
// records are written; then follow_end writes the rest.
template <class W>
TM_HD bool follow_walk(const FollowArgs& a, int32_t lane, FollowLane& s,
                       const W* tile, int32_t tb, int32_t TW) {
  // rec = (pos << 4) | fd' | has_tok<<1 | has_del<<2 | miss<<3: the low
  // nibble is ctl bits 6..9 as they stand
  const int32_t rows = a.rows > 1 ? a.rows : 1;
  const uint32_t start = (uint32_t)s.start;
  const W* at = tile - (int64_t)tb * rows;
  int32_t t = s.t, pos = s.pos_rel, fd = s.fd;
  bool done = s.done;
  uint32_t* recs = a.recs + (int64_t)t * a.L + lane;
  uint32_t* toks = a.toks + (int64_t)t * a.L + lane;
  const int32_t end = tb + TW;
  const uint32_t tok_mask = (1u << (a.w3_shift + 2)) - 1u;
  for (; !done && t < a.t_rec; ++t, recs += a.L, toks += a.L) {
    if (pos >= end) break;
    const W w = at[pos * rows + fd];
    const uint32_t lo = (uint32_t)w;
    pos += (int32_t)(lo & 63u);
    fd = (int32_t)((lo >> 6) & 1u);
    *recs = ((start + (uint32_t)pos) << 4) | ((lo >> 6) & 3u) | ((uint32_t)fd << 2) | (((lo >> 8) & 1u) << 3);
    *toks = (uint32_t)(w >> 9) & tok_mask;
    done = pos >= s.stop;
  }
  s.t = t;
  s.pos_rel = pos;
  s.fd = fd;
  s.done = done;
  return !done && t < a.t_rec;
}

// Zero records of a lane from its row s.t on, rows s.t + first, + step,
// ... (the kernel's threads split them); and done_all cleared if the lane
// did not finish.
TM_HD void follow_end(const FollowArgs& a, int32_t lane, const FollowLane& s,
                      int32_t first, int32_t step) {
  for (int32_t t = s.t + first; t < a.t_rec; t += step) {
    a.recs[(int64_t)t * a.L + lane] = 0u;
    a.toks[(int64_t)t * a.L + lane] = 0u;
  }
  if (first == 0 && !s.done) a.done_all[0] = 0;
}

// -------------------------------------------------------------- compact
// The kept records [s_l, e_l] of lane l to the dense slots q_l + j, with
// the delete marker (record bit 2) folded into bit S + 2 of the token word,
// and zero in every slot no kept record maps to
// (ops/pallas_stitch.py::make_compact_kernel writes into a zeroed buffer).
//
// The kernel reads a tile of COMPACT_LANES lanes x COMPACT_RECS record rows
// along the lane axis, the way (T, L) arrays lie in memory, turns it
// through shared memory and writes each lane's run of consecutive slots;
// blocks of a second kind each own COMPACT_ZERO output slots, mark in a
// bitmap the slots some lane's kept range maps to, and zero the others.
// The two kinds write disjoint slots, so neither waits for the other.
constexpr int32_t COMPACT_LANES = 32;
constexpr int32_t COMPACT_RECS = 64;
constexpr int32_t COMPACT_ZERO = 8192;  // a multiple of 32

// A lane's kept records [s, e], clamped to the grid's rows (s > e: none),
// and the output slot q of its record 0.
struct CompactLane {
  int32_t s, e, q;
};

TM_HD CompactLane compact_lane(const CompactArgs& a, int32_t lane) {
  if (lane >= a.L) return CompactLane{1, 0, 0};
  const int32_t s = TM_LDG(a.s + lane), e = TM_LDG(a.e + lane);
  return CompactLane{s < 0 ? 0 : s, e < a.T - 1 ? e : a.T - 1, TM_LDG(a.q + lane)};
}

// Whether the lane keeps a record among rows [j0, j0 + nj).
TM_HD bool compact_lane_in(const CompactLane& c, int32_t j0, int32_t nj) {
  return c.s <= c.e && c.s < j0 + nj && c.e >= j0;
}

TM_HD bool compact_keeps(const CompactLane& c, int32_t j) { return c.s <= j && j <= c.e; }

// The output word of record j of a lane.
TM_HD uint32_t compact_word(const CompactArgs& a, int32_t lane, int32_t j) {
  const int64_t at = (int64_t)j * a.L + lane;
  return TM_LDG(a.toks + at) | (((TM_LDG(a.recs + at) >> 2) & 1u) << (a.w3_shift + 2));
}

// Word w of kept record j to its slot, dropped outside [0, out_len).
TM_HD void compact_put(const CompactArgs& a, const CompactLane& c, int32_t j, uint32_t w) {
  const int64_t slot = (int64_t)c.q + j;
  if (slot >= 0 && slot < a.out_len) a.out[slot] = w;
}

#if defined(__CUDA_ARCH__)
#define TM_OR(p, v) atomicOr((p), (v))
#else
#define TM_OR(p, v) (*(p) |= (v))
#endif

// Mark in ``bits`` (bit i: slot x0 + i, for i in [0, n_slots)) the slots
// the lane's kept records map to.
TM_HD void compact_mark(const CompactLane& c, int64_t x0, int32_t n_slots, uint32_t* bits) {
  if (c.s > c.e) return;
  int64_t lo = (int64_t)c.q + c.s - x0, hi = (int64_t)c.q + c.e - x0;
  if (lo < 0) lo = 0;
  if (hi > n_slots - 1) hi = n_slots - 1;
  if (lo > hi) return;
  for (int64_t w = lo >> 5; w <= hi >> 5; ++w) {
    uint32_t mask = 0xFFFFFFFFu;
    if (w == lo >> 5) mask &= 0xFFFFFFFFu << (lo & 31);
    if (w == hi >> 5) mask &= 0xFFFFFFFFu >> (31 - (hi & 31));
    TM_OR(bits + w, mask);
  }
}

// Zero the unmarked ones of slots x0 + i .. x0 + i + 3 (i a multiple of
// 4) below out_len: one 16-byte store where none of the four is marked.
TM_HD void compact_zero4(const CompactArgs& a, int64_t x0, const uint32_t* bits, int32_t i) {
  const int64_t x = x0 + i;
  const uint32_t marked = (bits[i >> 5] >> (i & 31)) & 0xFu;
#if defined(__CUDA_ARCH__)
  if (!marked && x + 3 < a.out_len && ((uintptr_t)(a.out + x) & 15u) == 0) {
    *(uint4*)(a.out + x) = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
#endif
  for (int32_t k = 0; k < 4; ++k)
    if (!((marked >> k) & 1u) && x + k < a.out_len) a.out[x + k] = 0u;
}

}  // namespace tmk
