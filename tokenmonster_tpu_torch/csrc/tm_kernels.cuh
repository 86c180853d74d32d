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
//           tok = idx | w3<<20 (w3 == 3: literal id)
//   follow  rec = (pos << 4) | fd' | has_tok<<1 | has_del<<2 | miss<<3,
//           tok = the 22-bit token word
//   compact out[q_l + j] = tok | has_del<<22 for the kept records of lane l
//
// The argument structs are mirrored field for field by ctypes.Structure
// classes in ops/_build.py; change both together.
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
  int64_t N;                    // buffer length (positions computed)
  int32_t n;                    // valid bytes; matches end at or before n
  int32_t max_len;
  int32_t idx1_bits;
  int32_t has_space;
  int32_t lil_off;
  int32_t pad_;
  // fields from here on are read by the shared-memory design only; the
  // struct's head is the one-thread-per-position design's, unchanged
  const uint32_t* filt;         // key filter, 2^(filt_log2 - 5) words
  int32_t filt_log2;
  int32_t n_cls;                // rows of desc
  int32_t disp_words;           // length of disp
  int32_t pad2_;
};

struct DecideArgs {
  const uint32_t* m;
  const uint32_t* mb;           // == m when the vocabulary has no delete
  const uint8_t* text;
  const int32_t* meta;          // (2, R*128) planes, see build_meta_planes
  const int32_t* bb;            // (256,) begin-byte class
  uint32_t* ctl;                // (rows, N)
  uint32_t* tok;
  int64_t N;
  int64_t meta_stride;          // R*128
  int32_t n;
  int32_t has_delete;
  int32_t has_unk;
  int32_t unk_token;
  int32_t lil_off;
  int32_t pad_;
};

struct FollowArgs {
  const uint32_t* ctl;          // (rows, N)
  const uint32_t* tok;
  uint32_t* recs;               // (t_rec, L)
  uint32_t* toks;
  int32_t* done_all;            // set to 1 by the caller; lanes clear it
  int64_t N;
  int32_t rows;
  int32_t n;
  int32_t chunk;
  int32_t overlap;
  int32_t W;                    // per-lane window (JAX kernel geometry)
  int32_t L;
  int32_t t_rec;
  int32_t pad_;
};

struct CompactArgs {
  const uint32_t* recs;         // (T, L)
  const uint32_t* toks;
  const int32_t* s;             // (L,) first kept record
  const int32_t* e;             // (L,) last kept record (inclusive)
  const int32_t* q;             // (L,) output slot of record 0
  uint32_t* out;                // zeroed by the caller
  int64_t out_len;
  int32_t T;
  int32_t L;
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
  const uint32_t t0 = win_byte(win, t);
  const bool fits1 = p + 1 <= a.n;
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
  const int64_t room = (int64_t)a.n - p;
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
constexpr int32_t NEG = -1000000;

struct DecideCtx {
  const DecideArgs* a;
  int64_t p;
  TM_HD uint32_t m_at(int32_t delta) const {
    return word_at(a->m, a->N, p + clip127(delta));
  }
  TM_HD uint32_t mb_at(int32_t delta) const {
    return word_at(a->mb, a->N, p + clip127(delta));
  }
  TM_HD int32_t bb_at(int32_t delta) const {
    return a->bb[byte_at(a->text, a->N, p + clip127(delta))];
  }
  TM_HD int32_t meta0(uint32_t w) const { return a->meta[w >> 6]; }
};

TM_HD int32_t max0(int32_t x) { return x > 0 ? x : 0; }

TM_HD void decide_at(const DecideArgs& a, int64_t p, int32_t fd) {
  const DecideCtx c{&a, p};
  const uint32_t mf = fd ? a.mb[p] : a.m[p];
  const int32_t cur_idx = (int32_t)(mf >> 6);
  const int32_t cur_len = (int32_t)(mf & 63u) - fd * a.lil_off;
  const bool found = mf != 0;
  const int32_t F0 = a.meta[cur_idx];
  const int32_t F1 = a.meta[a.meta_stride + cur_idx];
  const int32_t of = F0 & 0xFF, onw = (F0 >> 8) & 0xFF;
  const int32_t olen1 = (F0 >> 16) & 0xFF, olen2 = (F0 >> 24) & 0xFF;
  const int32_t af1 = F1 & 0xFF, anw1 = (F1 >> 8) & 0xFF;
  const int32_t af2 = (F1 >> 16) & 0xFF, anw2 = (F1 >> 24) & 0xFF;

  const bool do_eval = found && (p + cur_len < a.n) &&
                       (((of & 32) == 0) || c.bb_at(cur_len) != 12);
  const bool valid_first[3] = {do_eval, do_eval && olen1 > 0,
                               do_eval && olen1 > 0 && olen2 > 0};
  const int32_t first_len[3] = {cur_len, olen1 - fd, olen2 - fd};
  const int32_t f_first[3] = {of, af1, af2};
  const int32_t fnw[3] = {onw - fd, anw1 - fd, anw2 - fd};

  int32_t scores[6];
  int32_t n_scores = a.has_delete ? 6 : 3;
  for (int r = 0; r < 3; ++r) {
    const int32_t delta3 = valid_first[r] ? first_len[r] : cur_len;
    const uint32_t m3 = c.m_at(delta3);
    const int32_t s_len = (int32_t)(m3 & 63u);
    const bool valid_nb = valid_first[r] && m3 != 0;
    const int32_t sF0 = c.meta0(m3);
    const int32_t sf = sF0 & 0xFF, snw = (sF0 >> 8) & 0xFF;
    const int32_t nb_nb = c.bb_at(delta3 + s_len);
    {
      const int32_t bl = first_len[r] + s_len;
      const int32_t base = bl + (f_first[r] >> 7) + (sf >> 7) + max0(fnw[r] - 1) +
                           max0(snw - 1) + ((sf >> 2) & 1) + ((nb_nb >> 2) & 1) +
                           (fnw[r] + snw + (nb_nb >> 3)) * 100;
      int32_t ded = (f_first[r] & 1 & (sf >> 1)) * 103 +
                    ((f_first[r] >> 3) & 1 & (sf >> 4)) * 100 + (sf & 1 & nb_nb) * 3;
      if (r > 0) ded += (bl < cur_len ? 100 : 0) + (bl == cur_len ? 10000 : 0);
      scores[r] = valid_nb ? base - ded : NEG;
    }
    if (a.has_delete) {
      // forward-delete branch: the second token re-probed with the
      // virtual space prefix
      const uint32_t mb3 = c.mb_at(delta3);
      const int32_t sbF0 = c.meta0(mb3);
      const int32_t secb_lenf = (int32_t)(mb3 & 63u);
      const int32_t secb_len = secb_lenf - a.lil_off;
      const int32_t sfb = sbF0 & 0xFF, snwb = (sbF0 >> 8) & 0xFF;
      const bool want_b = valid_nb && (sf & 2) != 0 && nb_nb == 1 && snw == 0 &&
                          secb_lenf > s_len + 1;
      const int32_t nb_b = c.bb_at(delta3 + secb_len);
      const int32_t bl = first_len[r] + secb_len;
      const int32_t base = bl + (f_first[r] >> 7) + (sfb >> 7) + max0(fnw[r] - 1) +
                           max0(snwb - 1) + ((nb_b >> 2) & 1) +
                           (fnw[r] + snwb + (nb_b >> 3)) * 100;
      int32_t ded = (f_first[r] & 1) * 103 + ((f_first[r] >> 3) & 1 & (sfb >> 4)) * 100 +
                    (sfb & 1 & nb_b) * 3 + 1;
      if (r > 0) ded += (bl < cur_len ? 100 : 0) + (bl == cur_len ? 10000 : 0);
      scores[3 + r] = want_b ? base - ded : NEG;
    }
  }
  int32_t mx = scores[0];
  for (int r = 1; r < n_scores; ++r) mx = scores[r] > mx ? scores[r] : mx;
  int32_t w6 = 0;  // first hit: s1 > s2 > s3 > s1b > s2b > s3b
  while (scores[w6] != mx) ++w6;
  const bool any_branch = mx != NEG;
  const int32_t w3 = w6 % 3;
  const bool is_b = any_branch && w6 >= 3;
  const int32_t new_pos_rel = found ? (any_branch ? first_len[w3] : cur_len) : 1;
  const bool miss = !found && p < a.n;
  const bool has_tok = found || (miss && a.has_unk);
  // an alternative branch may advance 0 bytes: at fd = 1 one of length 1
  // is the virtual space alone (go/tokenmonster.go i += len1 - fd), and
  // the chain goes on from (p, fd = 0); the JAX kernel clamps this to 1
  const int32_t lo = any_branch && w3 > 0 ? 0 : 1;
  const int32_t delta_out = new_pos_rel < lo ? lo : (new_pos_rel > 63 ? 63 : new_pos_rel);
  const uint32_t ctl = (uint32_t)delta_out | (is_b ? (1u << 6) | (1u << 8) : 0u) |
                       (has_tok ? 1u << 7 : 0u) | (miss ? 1u << 9 : 0u);
  const uint32_t tok = miss ? ((3u << 20) | (uint32_t)a.unk_token)
                            : ((uint32_t)cur_idx | ((uint32_t)w3 << 20));
  a.ctl[fd * a.N + p] = ctl;
  a.tok[fd * a.N + p] = tok;
}

// --------------------------------------------------------------- follow
// Chain-follow of one lane from (lane start, fd = 0) through chunk +
// overlap bytes (ops/pallas_follow.py; ops/decision.py::follow_lanes with
// packed=True).  Steps after the lane finishes write zero records.
//
// The kernel copies a tile of each lane's window, ``w = ctl | tok << 10``
// over TW window positions, into shared memory and walks the chain there;
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
  int64_t stop = (int64_t)a.n - s.start;
  const int64_t span = (int64_t)a.chunk + a.overlap;
  s.stop = (int32_t)(stop < -1 ? -1 : (stop > span ? span : stop));
  s.done = s.stop <= 0;
  s.t = 0;
  s.pos_rel = 0;
  s.fd = 0;
  return s;
}

// The packed word of fd row ``row`` at window position ``k`` (clamped to
// the window) of a lane starting at ``start``: zero past N.
TM_HD uint32_t follow_word(const FollowArgs& a, int64_t start, int32_t row, int64_t k) {
  const int64_t q = start + (k < a.W - 1 ? k : a.W - 1);
  if (q >= a.N) return 0u;
  const int64_t at = (int64_t)row * a.N + q;
  return (uint32_t)TM_LDG(a.ctl + at) | ((uint32_t)TM_LDG(a.tok + at) << 10);
}

// Steps of one lane on a tile holding window positions [tb, tb + TW).
// Returns true when the next step reads past the tile: refill it from
// s.pos_rel and call again.  Returns false once the lane is done or t_rec
// records are written; then follow_end writes the rest.
TM_HD bool follow_walk(const FollowArgs& a, int32_t lane, FollowLane& s,
                       const uint32_t* tile, int32_t tb, int32_t TW) {
  // rec = (pos << 4) | fd' | has_tok<<1 | has_del<<2 | miss<<3: the low
  // nibble is ctl bits 6..9 as they stand
  const int32_t rows = a.rows > 1 ? a.rows : 1;
  const uint32_t start = (uint32_t)s.start;
  const uint32_t* at = tile - (int64_t)tb * rows;
  int32_t t = s.t, pos = s.pos_rel, fd = s.fd;
  bool done = s.done;
  uint32_t* recs = a.recs + (int64_t)t * a.L + lane;
  uint32_t* toks = a.toks + (int64_t)t * a.L + lane;
  const int32_t end = tb + TW;
  for (; !done && t < a.t_rec; ++t, recs += a.L, toks += a.L) {
    if (pos >= end) break;
    const uint32_t w = at[pos * rows + fd];
    pos += (int32_t)(w & 63u);
    fd = (int32_t)((w >> 6) & 1u);
    *recs = ((start + (uint32_t)pos) << 4) | ((w >> 6) & 15u);
    *toks = w >> 10;
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
// One kept record j of lane l to its global slot q_l + j, with the delete
// marker (record bit 2) folded into bit 22 of the token word
// (ops/pallas_stitch.py::make_compact_kernel).
TM_HD void compact_at(const CompactArgs& a, int32_t lane, int32_t j) {
  const int64_t slot = (int64_t)a.q[lane] + j;
  if (slot < 0 || slot >= a.out_len) return;
  const int64_t at = (int64_t)j * a.L + lane;
  a.out[slot] = a.toks[at] | (((a.recs[at] >> 2) & 1u) << 22);
}

TM_HD int32_t compact_first(const CompactArgs& a, int32_t lane) {
  return a.s[lane] < 0 ? 0 : a.s[lane];
}

TM_HD int32_t compact_last(const CompactArgs& a, int32_t lane) {
  return a.e[lane] < a.T - 1 ? a.e[lane] : a.T - 1;
}

}  // namespace tmk
