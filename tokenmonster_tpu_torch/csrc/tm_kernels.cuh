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

namespace tmk {

constexpr uint32_t SEED = 0x811C9DC5u;  // ops/hashmatch.py SEED, C1, C2
constexpr uint32_t C1 = 0x9E3779B1u;
constexpr uint32_t C2 = 0x85EBCA6Bu;

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
TM_HD void match_at(const MatchArgs& a, int64_t p) {
  const uint32_t t0 = byte_at(a.text, a.N, p);
  const bool fits1 = p + 1 <= a.n;
  int32_t best = 0, bestb = 0;
  const int32_t s1 = a.single[t0];
  if (s1 > 0 && fits1) best = ((s1 - 1) << 6) | 1;
  if (a.has_space) {
    // the bare prefix token matches everywhere, p >= n included
    const int32_t se = a.scalars[0];
    if (se > 0) bestb = ((se - 1) << 6) | a.lil_off;
    const int32_t sp = a.space_single[t0];
    if (sp > 0 && fits1) bestb = ((sp - 1) << 6) | (1 + a.lil_off);
  }
  const uint32_t imask = (1u << a.idx1_bits) - 1u;
  const int32_t n_idx = a.has_space ? 2 : 1;
  const int32_t ib = a.idx1_bits * n_idx;
  uint32_t h = SEED;
  // a hit needs p + l <= n, so no longer length can hit past that point
  for (int32_t l = 1; l <= a.max_len && p + l <= a.n; ++l) {
    h = h * 257u + byte_at(a.text, a.N, p + l - 1);
    h ^= h >> 11;
    const int32_t c = a.len_cls[l];
    if (c < 0) continue;
    const int32_t* d = a.desc + (int64_t)c * DESC_W;
    const int32_t S = d[D_S];
    const int32_t bbits = d[D_BBITS];
    // bucket: top b_bits of h*C1; a shift by 32 is undefined, so 0 bits
    // is its own case
    const uint32_t bucket = bbits ? (h * C1) >> (32 - bbits) : 0u;
    // slot hash g: the truncated NAF sum of hashmatch.scale_to, not a
    // high multiply (which differs by up to the number of terms)
    const uint32_t y = (h ^ (uint32_t)d[D_SALT]) * C2;
    int32_t g = 0;
    for (int32_t i = 0; i < d[D_NSCALE]; ++i) {
      const int32_t e = d[D_SCALE + i];
      const int32_t term = (int32_t)(y >> (32 - (e >> 1)));
      g += (e & 1) ? -term : term;
    }
    g = g < 0 ? 0 : (g > S - 1 ? S - 1 : g);
    const uint32_t dw = (uint32_t)a.disp[d[D_DOFF] + (bucket >> 1)];
    const uint32_t dd = ((bucket & 1u) ? (dw >> 16) : dw) & 0xFFFFu;
    int32_t slot = g + (int32_t)dd;
    if (slot >= S) slot -= S;
    const int32_t* F = a.fields + d[D_FOFF] + slot;
    const int32_t stride = d[D_STRIDE];
    bool eq = true;
    for (int32_t k = 0; k < l && eq; ++k) {
      const int32_t bit = ib + 8 * k;
      const int32_t f = bit >> 5, off = bit & 31;
      uint32_t w = (uint32_t)F[(int64_t)f * stride] >> off;
      if (off > 24) w |= (uint32_t)F[(int64_t)(f + 1) * stride] << (32 - off);
      eq = (w & 0xFFu) == byte_at(a.text, a.N, p + k);
    }
    if (eq) {
      const uint32_t w0 = (uint32_t)F[0];
      const int32_t im = (int32_t)(w0 & imask);
      if (im > 0) best = ((im - 1) << 6) | l;
      if (a.has_space) {
        uint32_t sw = w0 >> a.idx1_bits;
        if (2 * a.idx1_bits > 32) sw |= (uint32_t)F[stride] << (32 - a.idx1_bits);
        const int32_t is = (int32_t)(sw & imask);
        if (is > 0) bestb = ((is - 1) << 6) | (l + a.lil_off);
      }
    }
    // keys whose full hash collides with a placed key: direct compare
    for (int32_t j = 0; j < d[D_NOVF]; ++j) {
      const uint8_t* key = a.ovf_keys + d[D_OVF_BYTES] + (int64_t)j * l;
      bool ok = true;
      for (int32_t k = 0; k < l && ok; ++k)
        ok = key[k] == byte_at(a.text, a.N, p + k);
      if (!ok) continue;
      const int32_t* sc = a.scalars + d[D_OVF_SCALARS] + j * n_idx;
      if (sc[0] > 0) best = ((sc[0] - 1) << 6) | l;
      if (a.has_space && sc[1] > 0) bestb = ((sc[1] - 1) << 6) | (l + a.lil_off);
    }
  }
  a.m[p] = (uint32_t)best;
  if (a.has_space) a.mb[p] = (uint32_t)bestb;
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
TM_HD void follow_lane(const FollowArgs& a, int32_t lane) {
  const int64_t start = (int64_t)lane * a.chunk;
  int64_t stop = (int64_t)a.n - start;
  const int64_t span = (int64_t)a.chunk + a.overlap;
  stop = stop < -1 ? -1 : (stop > span ? span : stop);
  bool done = stop <= 0;
  int32_t pos_rel = 0, fd = 0;
  for (int32_t t = 0; t < a.t_rec; ++t) {
    uint32_t rec = 0, tk = 0;
    if (!done) {
      const int32_t pr = pos_rel > a.W - 1 ? a.W - 1 : pos_rel;
      const int64_t q = start + pr;
      const int64_t row = a.rows > 1 ? fd : 0;
      const uint32_t w = q < a.N ? (a.ctl[row * a.N + q] | (a.tok[row * a.N + q] << 10)) : 0u;
      const int32_t new_rel = pos_rel + (int32_t)(w & 63u);
      const int32_t new_fd = (int32_t)((w >> 6) & 1u);
      rec = ((uint32_t)(start + new_rel) << 4) | (uint32_t)new_fd |
            (((w >> 7) & 1u) << 1) | (((w >> 8) & 1u) << 2) | (((w >> 9) & 1u) << 3);
      tk = w >> 10;
      done = new_rel >= stop;
      pos_rel = new_rel;
      fd = new_fd;
    }
    a.recs[(int64_t)t * a.L + lane] = rec;
    a.toks[(int64_t)t * a.L + lane] = tk;
  }
  if (!done) a.done_all[0] = 0;
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
