// Native host runtime for tokenmonster_tpu: ungreedy tokenizer + capcode.
//
// Exact port of the reference hot loops for the host/serving path:
//   - 6-branch ungreedy tokenize: go/tokenmonster.go:1017-1279
//   - capcode encode/decode:      javascript/tokenmonster.js:900-1065
// Unicode classification tables are supplied by Python (chartypes.py), so
// this file needs no ICU.  Exposed as a C ABI consumed via ctypes.
//
// Build: g++ -O3 -fPIC -shared -o tm_native.so tm_native.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <memory>
#include <cstdlib>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t DOES_NOT_EXIST = 16777215;

// ---------------- dictionary ----------------

struct Slot {
  uint64_t hash8;     // mixed hash of the packed key
  uint32_t index;     // dictionary index + 1 (0 = empty)
  uint32_t len;       // key length
};

struct Dict {
  // Open addressing, power-of-two slots, keyed by (len, packed key words).
  // Keys are packed big-endian into up to 5 uint64 words zero-padded at the
  // tail — the same packing as the reference's pansearch
  // (tokenmonster-cpp/src/tokenmonster.cpp:919-958) — so a probe window is
  // loaded once as 5 words and every candidate length needs only a mask,
  // two multiplies and (on slot hit) word compares, no per-byte work.
  // Per-first-two-bytes length masks gate candidate lengths (same role as
  // pansearch's length-bucketed blooms).
  std::vector<Slot> slots;
  std::vector<uint64_t> packed;        // 5 words per index
  uint64_t mask = 0;
  std::vector<uint64_t> len_mask2;     // [b0<<8|b1]: lengths == 2 present
  std::vector<uint64_t> len_mask3;     // [hash3 & M3]: lengths >= 3 (superset)
  static constexpr uint32_t M3_BITS = 19;
  uint8_t has_len1[256] = {0};
  int max_len = 0;

  static inline uint32_t hash3(const uint8_t* p) {
    uint32_t h = ((uint32_t)p[0] << 16) | ((uint32_t)p[1] << 8) | p[2];
    h *= 2654435761u;
    return h >> (32 - M3_BITS);
  }

  static inline uint64_t mix(uint64_t h, uint32_t len) {
    h ^= (uint64_t)len * 0x9E3779B97F4A7C15ULL;
    h ^= h >> 29;
    h *= 0xBF58476D1CE4E5B9ULL;
    h ^= h >> 32;
    return h;
  }

  static inline uint64_t loadbe(const uint8_t* p) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    return __builtin_bswap64(w);
  }

  static inline uint64_t tail_mask(uint32_t tail_bytes) {
    // keep the top `tail_bytes` bytes of a big-endian word (1..8)
    return ~0ULL << ((8 - tail_bytes) * 8);
  }

  // pack key (len<=40) into w[0..4], zero-padded
  static void pack_key(const uint8_t* p, uint32_t len, uint64_t* w) {
    uint8_t buf[40] = {0};
    std::memcpy(buf, p, len);
    for (int i = 0; i < 5; i++) w[i] = loadbe(buf + i * 8);
  }

  static inline uint64_t hash_words(const uint64_t* w, uint32_t len) {
    uint32_t nw = (len + 7) / 8;
    uint64_t h = 1469598103934665603ULL;
    for (uint32_t i = 0; i < nw; i++) h = (h ^ w[i]) * 1099511628211ULL;
    return mix(h, len);
  }

  void build(const uint8_t* bytes, const uint32_t* offs, uint32_t n) {
    len_mask2.assign(65536, 0);
    len_mask3.assign((size_t)1 << M3_BITS, 0);
    packed.assign((size_t)n * 5, 0);
    uint64_t cap = 16;
    while (cap < (uint64_t)n * 2) cap <<= 1;
    slots.assign(cap, Slot{0, 0, 0});
    mask = cap - 1;
    for (uint32_t i = 0; i < n; i++) {
      const uint8_t* p = bytes + offs[i];
      uint32_t len = offs[i + 1] - offs[i];
      if ((int)len > max_len) max_len = (int)len;
      if (len == 1) {
        has_len1[p[0]] = 1;
      } else if (len == 2) {
        len_mask2[((uint32_t)p[0] << 8) | p[1]] |= 1ULL << len;
      } else {
        len_mask3[hash3(p)] |= 1ULL << len;
      }
      uint64_t* w = packed.data() + (size_t)i * 5;
      pack_key(p, len, w);
      uint64_t h = hash_words(w, len);
      uint64_t at = h & mask;
      while (slots[at].index) at = (at + 1) & mask;
      slots[at] = Slot{h, i + 1, len};
    }
  }

  inline int32_t find_w(const uint64_t* w, uint32_t len, uint64_t h) const {
    uint64_t at = h & mask;
    uint32_t nw = (len + 7) / 8;
    while (true) {
      const Slot& s = slots[at];
      if (!s.index) return -1;
      if (s.hash8 == h && s.len == len) {
        uint32_t idx = s.index - 1;
        const uint64_t* kw = packed.data() + (size_t)idx * 5;
        bool eq = true;
        for (uint32_t i = 0; i < nw; i++) {
          if (kw[i] != w[i]) {
            eq = false;
            break;
          }
        }
        if (eq) return (int32_t)idx;
      }
      at = (at + 1) & mask;
    }
  }

  inline int32_t find(const uint8_t* p, uint32_t len) const {
    uint64_t w[5];
    pack_key(p, len, w);
    return find_w(w, len, hash_words(w, len));
  }

  // longest key that is a prefix of data[0..limit).
  // NOTE: requires >= 40 readable bytes beyond `data` (callers pad).
  inline bool longest(const uint8_t* data, int limit, int32_t* index,
                      int* length) const {
    if (limit <= 0) return false;
    uint64_t lm = 0;
    if (limit >= 2) {
      lm = len_mask2[((uint32_t)data[0] << 8) | data[1]];
      if (limit >= 3) lm |= len_mask3[hash3(data)];
      int maxl = limit < max_len ? limit : max_len;
      lm &= (maxl >= 63) ? ~0ULL : ((2ULL << maxl) - 1);
    }
    if (lm) {
      int top = 63 - __builtin_clzll(lm);
      // load the window once; fold whole-word prefix hashes once
      uint64_t w[5], pre[6];
      int nw_top = (top + 7) / 8;
      uint64_t h = 1469598103934665603ULL;
      pre[0] = h;
      for (int i = 0; i < nw_top; i++) {
        w[i] = loadbe(data + i * 8);
        h = (h ^ w[i]) * 1099511628211ULL;
        pre[i + 1] = h;
      }
      uint64_t wq[5];
      do {
        int l = 63 - __builtin_clzll(lm);
        uint32_t nw = ((uint32_t)l + 7) / 8;
        uint32_t tail = (uint32_t)l - (nw - 1) * 8;
        uint64_t last = w[nw - 1] & tail_mask(tail);
        uint64_t hh = mix((pre[nw - 1] ^ last) * 1099511628211ULL, (uint32_t)l);
        // query words with masked tail (cheap partial copy)
        for (uint32_t i = 0; i + 1 < nw; i++) wq[i] = w[i];
        wq[nw - 1] = last;
        int32_t idx = find_w(wq, (uint32_t)l, hh);
        if (idx >= 0) {
          *index = idx;
          *length = l;
          return true;
        }
        lm &= (1ULL << l) - 1;
      } while (lm);
    }
    if (has_len1[data[0]]) {
      uint64_t w0 = (uint64_t)data[0] << 56;
      int32_t idx = find_w(&w0, 1, mix((1469598103934665603ULL ^ w0) *
                                           1099511628211ULL, 1));
      if (idx >= 0) {
        *index = idx;
        *length = 1;
        return true;
      }
    }
    return false;
  }
};

// ---------------- vocab ----------------

struct Vocab {
  Dict dict;
  std::vector<uint8_t> flag, nwords;
  std::vector<uint32_t> index1, index2, id, id1, id2;
  std::vector<int32_t> len1, len2;
  uint8_t begin_byte[256];
  int max_token_length = 0;
  uint32_t delete_token = DOES_NOT_EXIST;
  uint32_t unk_token = DOES_NOT_EXIST;
  int charset = 1;
};

inline int branch_score(int branch_len, int ff, int nw_adj, int sf, int snw,
                        int nb, int is_b, int greedy_len, int is_alt) {
  // go/tokenmonster.go:1075-1084 (exact integer formula)
  int nw1 = nw_adj - 1;
  if (nw1 < 0) nw1 = 0;
  int nw2 = snw - 1;
  if (nw2 < 0) nw2 = 0;
  int base = branch_len + (ff >> 7) + (sf >> 7) + nw1 + nw2 +
             (is_b ? 0 : ((sf >> 2) & 1)) + ((nb >> 2) & 1) +
             (nw_adj + snw + (nb >> 3)) * 100;
  int ded = (is_b ? (ff & 1) : (ff & 1 & (sf >> 1))) * 103 +
            ((ff >> 3) & 1 & (sf >> 4)) * 100 + (sf & 1 & nb) * 3 +
            (is_b ? 1 : 0);
  if (is_alt) {
    if (branch_len < greedy_len) ded += 100;
    if (branch_len == greedy_len) ded += 10000;
  }
  return base - ded;
}

}  // namespace

extern "C" {

void* tm_vocab_new(const uint8_t* key_bytes, const uint32_t* key_offs,
                   uint32_t n_info, const uint8_t* flag, const uint8_t* nwords,
                   const uint32_t* index1, const uint32_t* index2,
                   const int32_t* len1, const int32_t* len2,
                   const uint32_t* id, const uint32_t* id1, const uint32_t* id2,
                   const uint8_t* begin_byte, int max_token_length,
                   uint32_t delete_token, uint32_t unk_token, int charset) {
  Vocab* v = new Vocab();
  v->dict.build(key_bytes, key_offs, n_info);
  v->flag.assign(flag, flag + n_info);
  v->nwords.assign(nwords, nwords + n_info);
  v->index1.assign(index1, index1 + n_info);
  v->index2.assign(index2, index2 + n_info);
  v->len1.assign(len1, len1 + n_info);
  v->len2.assign(len2, len2 + n_info);
  v->id.assign(id, id + n_info);
  v->id1.assign(id1, id1 + n_info);
  v->id2.assign(id2, id2 + n_info);
  std::memcpy(v->begin_byte, begin_byte, 256);
  v->max_token_length = max_token_length;
  v->delete_token = delete_token;
  v->unk_token = unk_token;
  v->charset = charset;
  return v;
}

void tm_vocab_free(void* vp) { delete (Vocab*)vp; }

// Ids a scan from position i0 of an n-byte text can emit: at most
// 3 * (n - i0), so id buffers hold id_bound(n - i0) (the byte count is not
// enough: a delete-token vocabulary emits more ids than bytes).
//
// Proof.  The scan ends at most at n, so it advances i by at most n - i0
// bytes in all.  Each step of the scan does one of:
//  - a missing byte: at most one id (unk), advancing 1 byte;
//  - s1, s2, s3 or the skip path: one id, advancing the current token's
//    length (at least 1 byte: tokens are never empty) or an alternative's
//    length less fd.  That is 0 bytes only at fd 1 with a one-byte
//    alternative (the virtual space alone), and the step leaves fd 0;
//  - s1b, s2b, s3b (a forward-delete branch): two ids, the token and the
//    delete token, leaving fd 1.  At fd 0 it advances at least 1 byte.  At
//    fd 1 it advances 0 bytes only through a one-byte alternative, and then
//    the scan is back in the state it was in: the same position, fd 1, and
//    the same longest match of the virtual space plus the text there (the
//    branch looks it up at that position, as the step that set fd 1 did),
//    so the scan would repeat that step forever.  In a scan that ends,
//    every forward-delete branch advances at least 1 byte.
// Only a forward-delete branch leaves fd 1, so before every step that
// advances 0 bytes (one id) comes a forward-delete branch that advanced at
// least 1 byte (two ids), and the step after it runs at fd 0 and advances
// again.  Charging each 0-byte step to the branch before it, every byte
// advanced carries at most 3 ids.  (zero_step_vocab with unk on "out\xc2":
// o + delete, the virtual space alone, u, t, unk: 6 ids for 4 bytes.)
// tokenize_impl stops a scan that reaches the bound (one that would never
// end) and returns -1.
static inline int64_t id_bound(int64_t bytes) { return 3 * bytes + 8; }

// Core scan over [i0, stop): emits ids and (optionally) per-emission records
// packed as pos<<4 | fd | ntok<<1 | miss<<3 — the automaton state
// (position, forwardDelete) at each emission, used for exact speculative
// stitching (same scheme as the TPU scan kernel, ops/scan.py).  ``out``
// holds ``cap`` ids (id_bound(n - i0) for a scan that ends); returns the id
// count, or -1 where the scan reached ``cap``.
static int64_t tokenize_impl(const Vocab* v, const uint8_t* data, int64_t n,
                             int64_t i0, int64_t stop, uint32_t* out,
                             int64_t cap, int64_t* missing_out,
                             std::vector<uint64_t>* recs,
                             std::vector<uint32_t>* rec_offs,
                             int64_t* score_acc = nullptr,
                             int64_t* tokens_count = nullptr,
                             uint8_t* miss_mask = nullptr) {
  const Dict& D = v->dict;
  int64_t n_out = 0, missing = 0;

  const int lil_off = (v->charset == 2) ? 2 : 1;
  const int max_len = v->max_token_length;
  const int max_len_ws = max_len - lil_off;
  uint8_t lilbuf[48] = {0};
  lilbuf[0] = 32;
  const bool has_delete = v->delete_token != DOES_NOT_EXIST;
  const bool has_unk = v->unk_token != DOES_NOT_EXIST;

  int64_t i = i0;
  int fd = 0;
  int32_t index = 0;
  int length = 0;

  int64_t prev_pos = i0;
  int64_t n_tokens = 0;
  auto rec = [&](int64_t pos, int fd_, int ntok, int miss_) {
    if (recs) {
      recs->push_back(((uint64_t)pos << 4) | (uint64_t)fd_ |
                      ((uint64_t)ntok << 1) | ((uint64_t)miss_ << 3));
      rec_offs->push_back((uint32_t)n_out);
    }
    if (score_acc) {
      // trainvocab.go:1105-1160: scores[id] += consumed bytes (already
      // forwardDelete-adjusted); the delete marker itself scores +1.
      if (!miss_ && ntok >= 1) {
        score_acc[out[n_out - ntok]] += pos - prev_pos;
        if (ntok == 2) score_acc[out[n_out - 1]] += 1;
      }
      n_tokens += miss_ ? 1 : ntok;
    }
    prev_pos = pos;
  };

  while (i < stop) {
    if (n_out + 2 > cap) return -1;
    int lim = (int)((n - i) < max_len ? (n - i) : max_len);
    if (!D.longest(data + i, lim, &index, &length)) {
      if (has_unk) out[n_out++] = v->unk_token;
      if (miss_mask) miss_mask[data[i]] = 1;
      i++;
      missing++;
      fd = 0;
      rec(i, 0, has_unk ? 1 : 0, 1);
      continue;
    }
    while (true) {  // checkpoint
      if (n_out + 2 > cap) return -1;
      int of = v->flag[index];
      int64_t i1 = i + length;
      if (i1 < n && ((of & 32) == 0 || v->begin_byte[data[i1]] != 12)) {
        int s1 = -1000000, s2 = -1000000, s3 = -1000000;
        int s1b = -1000000, s2b = -1000000, s3b = -1000000;
        int32_t iA = 0, iAb = 0, iB = 0, iBb = 0, iC = 0, iCb = 0;
        int lA = 0, lAb = 0, lB = 0, lBb = 0, lC = 0, lCb = 0;
        int nw_adj = (int)v->nwords[index] - fd;

        int limA = (int)((n - i1) < max_len ? (n - i1) : max_len);
        bool fA = D.longest(data + i1, limA, &iA, &lA);
        if (fA) {
          int sf = v->flag[iA], snw = v->nwords[iA];
          int nb = v->begin_byte[data[i1 + lA]];
          s1 = branch_score(length + lA, of, nw_adj, sf, snw, nb, 0, length, 0);
          if (has_delete && (sf & 2) && nb == 1 && snw == 0) {
            int l1b = (int)((n - i1) < max_len_ws ? (n - i1) : max_len_ws);
            std::memcpy(lilbuf + lil_off, data + i1, (size_t)l1b);
            int ml;
            if (D.longest(lilbuf, l1b + lil_off, &iAb, &ml) && ml > lA + 1) {
              lAb = ml - lil_off;
              int sf2 = v->flag[iAb], snw2 = v->nwords[iAb];
              int nb2 = v->begin_byte[data[i1 + lAb]];
              s1b = branch_score(length + lAb, of, nw_adj, sf2, snw2, nb2, 1,
                                 length, 0);
            }
          }
        }
        if (v->index1[index] != DOES_NOT_EXIST) {
          int32_t a1 = (int32_t)v->index1[index];
          int al1 = v->len1[index];
          int64_t i2 = i + al1 - fd;
          int limB = (int)((n - i2) < max_len ? (n - i2) : max_len);
          bool fB = D.longest(data + i2, limB, &iB, &lB);
          if (fB) {
            int ff = v->flag[a1];
            int fnw = (int)v->nwords[a1] - fd;
            int sf = v->flag[iB], snw = v->nwords[iB];
            int nb = v->begin_byte[data[i2 + lB]];
            int bl = al1 + lB - fd;
            s2 = branch_score(bl, ff, fnw, sf, snw, nb, 0, length, 1);
            if (has_delete && (sf & 2) && nb == 1 && snw == 0) {
              int l2b = (int)((n - i2) < max_len_ws ? (n - i2) : max_len_ws);
              std::memcpy(lilbuf + lil_off, data + i2, (size_t)l2b);
              int ml;
              if (D.longest(lilbuf, l2b + lil_off, &iBb, &ml) && ml > lB + 1) {
                lBb = ml - lil_off;
                int sf2 = v->flag[iBb], snw2 = v->nwords[iBb];
                int blb = al1 + lBb - fd;
                int nb2 = v->begin_byte[data[i2 + lBb]];
                s2b = branch_score(blb, ff, fnw, sf2, snw2, nb2, 1, length, 1);
              }
            }
          }
          if (v->index2[index] != DOES_NOT_EXIST) {
            int32_t a2 = (int32_t)v->index2[index];
            int al2 = v->len2[index];
            int64_t i3 = i + al2 - fd;
            int limC = (int)((n - i3) < max_len ? (n - i3) : max_len);
            bool fC = D.longest(data + i3, limC, &iC, &lC);
            if (fC) {
              int ff = v->flag[a2];
              int fnw = (int)v->nwords[a2] - fd;
              int sf = v->flag[iC], snw = v->nwords[iC];
              int nb = v->begin_byte[data[i3 + lC]];
              int bl = al2 + lC - fd;
              s3 = branch_score(bl, ff, fnw, sf, snw, nb, 0, length, 1);
              if (has_delete && (sf & 2) && nb == 1 && snw == 0) {
                int l3b = (int)((n - i3) < max_len_ws ? (n - i3) : max_len_ws);
                std::memcpy(lilbuf + lil_off, data + i3, (size_t)l3b);
                int ml;
                if (D.longest(lilbuf, l3b + lil_off, &iCb, &ml) && ml > lC + 1) {
                  lCb = ml - lil_off;
                  int sf2 = v->flag[iCb], snw2 = v->nwords[iCb];
                  int blb = al2 + lCb - fd;
                  int nb2 = v->begin_byte[data[i3 + lCb]];
                  s3b = branch_score(blb, ff, fnw, sf2, snw2, nb2, 1, length, 1);
                }
              }
            }
          }
        }
        int mx = s1;
        if (s2 > mx) mx = s2;
        if (s3 > mx) mx = s3;
        if (s1b > mx) mx = s1b;
        if (s2b > mx) mx = s2b;
        if (s3b > mx) mx = s3b;
        if (mx == -1000000) {
          // fall through to skip path
        } else if (mx == s1) {
          out[n_out++] = v->id[index];
          i += length;
          length = lA;
          index = iA;
          fd = 0;
          rec(i, 0, 1, 0);
          continue;
        } else if (mx == s2) {
          out[n_out++] = v->id1[index];
          i += v->len1[index] - fd;
          length = lB;
          index = iB;
          fd = 0;
          rec(i, 0, 1, 0);
          continue;
        } else if (mx == s3) {
          out[n_out++] = v->id2[index];
          i += v->len2[index] - fd;
          length = lC;
          index = iC;
          fd = 0;
          rec(i, 0, 1, 0);
          continue;
        } else if (mx == s1b) {
          out[n_out++] = v->id[index];
          out[n_out++] = v->delete_token;
          i += length;
          length = lAb;
          index = iAb;
          fd = 1;
          rec(i, 1, 2, 0);
          continue;
        } else if (mx == s2b) {
          out[n_out++] = v->id1[index];
          out[n_out++] = v->delete_token;
          i += v->len1[index] - fd;
          length = lBb;
          index = iBb;
          fd = 1;
          rec(i, 1, 2, 0);
          continue;
        } else if (mx == s3b) {
          out[n_out++] = v->id2[index];
          out[n_out++] = v->delete_token;
          i += v->len2[index] - fd;
          length = lCb;
          index = iCb;
          fd = 1;
          rec(i, 1, 2, 0);
          continue;
        }
      }
      // skip path
      out[n_out++] = v->id[index];
      i += length;
      fd = 0;
      rec(i, 0, 1, 0);
      break;
    }
  }
  *missing_out = missing;
  if (tokens_count) *tokens_count = n_tokens;
  return n_out;
}

// Scoring pass for the trainer: accumulate per-id chars-covered scores
// (exact trainvocab worker semantics) instead of returning the id stream.
// Returns tokensInText (tokens + missing bytes, b-branches count 2).
int64_t tm_tokenize_score(void* vp, const uint8_t* data_in, int64_t n,
                          int64_t* score_acc, int64_t* missing_out,
                          uint8_t* miss_mask) {
  Vocab* v = (Vocab*)vp;
  *missing_out = 0;
  if (n <= 0 || v->max_token_length == 0) return 0;
  std::vector<uint8_t> buf((size_t)n + 48, 0);
  std::memcpy(buf.data(), data_in, (size_t)n);
  // left uninitialised: the pages past the ids written are never touched
  const int64_t cap = id_bound(n);
  std::unique_ptr<uint32_t[]> out(new uint32_t[cap]);
  int64_t n_tokens = 0;
  if (tokenize_impl(v, buf.data(), n, 0, n, out.get(), cap, missing_out,
                    nullptr, nullptr, score_acc, &n_tokens, miss_mask) < 0)
    return -1;
  return n_tokens;
}

// Tokenize `data[0..n)` (already normalized+capcoded).  Writes ids into out
// (capacity ``cap``: id_bound(n) holds every scan that ends).  Returns the
// id count, -1 where the ids reached ``cap``; *missing_out = missing bytes.
int64_t tm_tokenize(void* vp, const uint8_t* data_in, int64_t n,
                    uint32_t* out, int64_t cap, int64_t* missing_out) {
  Vocab* v = (Vocab*)vp;
  *missing_out = 0;
  if (n <= 0 || v->max_token_length == 0) return 0;
  // +1 lookahead byte (go :1039-1046); extra zero padding so packed-word
  // probes may read 40 bytes past any in-range position.
  std::vector<uint8_t> buf((size_t)n + 48, 0);
  std::memcpy(buf.data(), data_in, (size_t)n);
  return tokenize_impl(v, buf.data(), n, 0, n, out, cap, missing_out,
                       nullptr, nullptr);
}

// Thread-parallel tokenize with exact speculative stitching: each thread
// scans its region from state (region_start, fd=0) and continues past the
// next junction; streams are spliced at the first shared emission state.
int64_t tm_tokenize_parallel(void* vp, const uint8_t* data_in, int64_t n,
                             uint32_t* out, int64_t cap,
                             int64_t* missing_out, int n_threads) {
  Vocab* v = (Vocab*)vp;
  *missing_out = 0;
  if (n <= 0 || v->max_token_length == 0) return 0;
  const int64_t W = 256;
  if (n_threads < 1) n_threads = 1;
  if ((int64_t)n_threads > n / (4 * W)) n_threads = (int)(n / (4 * W));
  if (n_threads <= 1)
    return tm_tokenize(vp, data_in, n, out, cap, missing_out);

  std::vector<uint8_t> buf((size_t)n + 48, 0);
  std::memcpy(buf.data(), data_in, (size_t)n);
  const uint8_t* data = buf.data();

  int64_t chunk = n / n_threads;
  // a thread's scan runs on past its stop until its checkpoint loop ends,
  // at most to n: its ids are bounded by id_bound(n - start), in buffers
  // left uninitialised (pages past the ids written are never touched)
  std::vector<std::unique_ptr<uint32_t[]>> ids(n_threads);
  std::vector<int64_t> counts(n_threads, 0);
  std::vector<std::vector<uint64_t>> recs(n_threads);
  std::vector<std::vector<uint32_t>> offs(n_threads);
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([&, t]() {
      int64_t start = (int64_t)t * chunk;
      int64_t end = (t == n_threads - 1) ? n : (int64_t)(t + 1) * chunk;
      int64_t stop = end + W < n ? end + W : n;
      int64_t cap_t = id_bound(n - start);
      ids[t].reset(new uint32_t[cap_t]);
      int64_t miss = 0;
      counts[t] = tokenize_impl(v, data, n, start, stop, ids[t].get(),
                                cap_t, &miss, &recs[t], &offs[t]);
    });
  }
  for (auto& th : threads) th.join();
  for (int t = 0; t < n_threads; t++)
    if (counts[t] < 0) return -1;

  // stitch
  int64_t n_out = 0, missing = 0;
  size_t start_rec = 0;  // first record of current thread NOT yet emitted
  for (int t = 0; t < n_threads; t++) {
    size_t end_rec = recs[t].size();  // exclusive
    size_t next_start = 0;
    if (t + 1 < n_threads) {
      int64_t J = (int64_t)(t + 1) * chunk;
      // two-pointer search for first shared (pos, fd) with pos >= J
      const auto& a = recs[t];
      const auto& b = recs[t + 1];
      size_t ia = 0, ib = 0;
      // advance ia to first record with pos >= J, and to no record before
      // the state the output has reached (start_rec - 1, the previous
      // junction's shared state): where chains stay out of phase, thread
      // t's scan runs on past J and an earlier junction may splice past
      // J, and a splice behind that state would emit its span twice
      while (ia < a.size() && (int64_t)(a[ia] >> 4) < J) ia++;
      if (start_rec > 0 && ia < start_rec - 1) ia = start_rec - 1;
      bool found = false;
      while (ia < a.size() && ib < b.size()) {
        uint64_t sa = a[ia] >> 4 << 1 | (a[ia] & 1);
        uint64_t sb = b[ib] >> 4 << 1 | (b[ib] & 1);
        if (sa == sb) {
          found = true;
          break;
        }
        if (sa < sb) ia++; else ib++;
      }
      if (!found) {
        // pathological junction: redo everything single-threaded
        return tm_tokenize(vp, data_in, n, out, cap, missing_out);
      }
      end_rec = ia + 1;
      next_start = ib + 1;
    }
    // emit ids for records (start_rec, end_rec)
    if (start_rec < end_rec) {
      uint32_t id_from = start_rec == 0 ? 0 : offs[t][start_rec - 1 + 1];
      // offs[k] = id count AFTER record k; span of records [s, e) is
      // [offs[s-1], offs[e-1]) with offs[-1] = 0
      uint32_t lo = start_rec == 0 ? 0 : offs[t][start_rec - 1];
      uint32_t hi = offs[t][end_rec - 1];
      (void)id_from;
      if (n_out + (int64_t)(hi - lo) > cap) return -1;
      std::memcpy(out + n_out, ids[t].get() + lo,
                  (size_t)(hi - lo) * sizeof(uint32_t));
      n_out += hi - lo;
      for (size_t k = start_rec; k < end_rec; k++) {
        missing += (recs[t][k] >> 3) & 1;
      }
    }
    start_rec = next_start;
  }
  *missing_out = missing;
  return n_out;
}

// ---------------- capcode (tables supplied by Python) ----------------

namespace {
const uint8_t* g_props = nullptr;     // chartypes bit flags per codepoint
const uint32_t* g_lower = nullptr;
const uint32_t* g_upper = nullptr;
constexpr uint8_t P_LETTER = 1, P_UPPER = 2, P_LOWER = 4, P_NUMBER = 8,
                  P_MODIFIER = 32, P_WHITESPACE = 64;

inline bool pl_letter(uint32_t cp) { return g_props[cp] & P_LETTER; }
inline bool pl_upper(uint32_t cp) { return g_props[cp] & P_UPPER; }
inline bool pl_lower(uint32_t cp) { return g_props[cp] & P_LOWER; }
inline bool pl_number(uint32_t cp) { return g_props[cp] & P_NUMBER; }
inline bool pl_mod(uint32_t cp) { return g_props[cp] & P_MODIFIER; }

// decode one UTF-8 rune; invalid => (cp=byte, len=1) passthrough sentinel
inline uint32_t dec(const uint8_t* p, int64_t rem, int* len) {
  uint8_t b0 = p[0];
  if (b0 < 0x80) { *len = 1; return b0; }
  if (b0 >= 0xC2 && b0 < 0xE0 && rem >= 2 && (p[1] & 0xC0) == 0x80) {
    *len = 2;
    return ((b0 & 0x1F) << 6) | (p[1] & 0x3F);
  }
  if (b0 >= 0xE0 && b0 < 0xF0 && rem >= 3 && (p[1] & 0xC0) == 0x80 &&
      (p[2] & 0xC0) == 0x80 && !(b0 == 0xE0 && p[1] < 0xA0) &&
      !(b0 == 0xED && p[1] >= 0xA0)) {
    *len = 3;
    return ((b0 & 0x0F) << 12) | ((p[1] & 0x3F) << 6) | (p[2] & 0x3F);
  }
  if (b0 >= 0xF0 && b0 < 0xF5 && rem >= 4 && (p[1] & 0xC0) == 0x80 &&
      (p[2] & 0xC0) == 0x80 && (p[3] & 0xC0) == 0x80 &&
      !(b0 == 0xF0 && p[1] < 0x90) && !(b0 == 0xF4 && p[1] >= 0x90)) {
    *len = 4;
    return ((b0 & 0x07) << 18) | ((p[1] & 0x3F) << 12) | ((p[2] & 0x3F) << 6) |
           (p[3] & 0x3F);
  }
  *len = 1;
  return 0x110000 + b0;  // invalid-byte sentinel (passes through unchanged)
}

inline int enc(uint32_t cp, uint8_t* o) {
  if (cp >= 0x110000) { o[0] = (uint8_t)(cp - 0x110000); return 1; }
  if (cp < 0x80) { o[0] = (uint8_t)cp; return 1; }
  if (cp < 0x800) {
    o[0] = 0xC0 | (cp >> 6);
    o[1] = 0x80 | (cp & 0x3F);
    return 2;
  }
  if (cp < 0x10000) {
    o[0] = 0xE0 | (cp >> 12);
    o[1] = 0x80 | ((cp >> 6) & 0x3F);
    o[2] = 0x80 | (cp & 0x3F);
    return 3;
  }
  o[0] = 0xF0 | (cp >> 18);
  o[1] = 0x80 | ((cp >> 12) & 0x3F);
  o[2] = 0x80 | ((cp >> 6) & 0x3F);
  o[3] = 0x80 | (cp & 0x3F);
  return 4;
}

inline bool cls_valid(uint32_t cp) { return cp < 0x110000; }
inline bool c_letter(uint32_t cp) { return cls_valid(cp) && pl_letter(cp); }
inline bool c_upper(uint32_t cp) { return cls_valid(cp) && pl_upper(cp); }
inline bool c_lower(uint32_t cp) { return cls_valid(cp) && pl_lower(cp); }
inline bool c_number(uint32_t cp) { return cls_valid(cp) && pl_number(cp); }
inline bool c_mod(uint32_t cp) { return cls_valid(cp) && pl_mod(cp); }
inline uint32_t c_toupper(uint32_t cp) {
  return cls_valid(cp) ? g_upper[cp] : cp;
}

constexpr uint32_t APOS = '\'';
constexpr uint32_t APOS2 = 0x2019;  // ’

}  // namespace

void tm_set_tables(const uint8_t* props, const uint32_t* lower,
                   const uint32_t* upper) {
  g_props = props;
  g_lower = lower;
  g_upper = upper;
}

namespace {

struct Room {
  uint8_t* o;
  int64_t cap;
};

// The capcode encoder's output moves from the caller's buffer to `spill`
// once it outgrows cap, and `spill` grows from there: room for k more
// bytes at pos.
Room spill_room(std::vector<uint8_t>& spill, uint8_t* o, int64_t cap,
                int64_t pos, int64_t k) {
  const int64_t want = std::max(2 * cap, pos + k) + 64;
  const bool first = spill.empty();
  spill.resize((size_t)want);
  if (first) std::memcpy(spill.data(), o, (size_t)pos);
  return {spill.data(), want};
}

typedef uint8_t u8x16 __attribute__((vector_size(16)));

// The offset in p[0..16) of the first byte outside a word that may need a
// decision, or 16: a byte >= 0x80, an A-Z, an a-z after a byte that is not a
// space or an ASCII letter, a 0-9 after a byte that is not a space or a
// digit.  p[-1] is the byte before.  Every other byte is copied as it is.
// The ASCII classes are those of g_props below 0x80 (tests hold them so).
inline int first_decision(const uint8_t* p) {
  u8x16 c, q;
  std::memcpy(&c, p, 16);
  std::memcpy(&q, p - 1, 16);
  const auto space = q == ' ';
  const auto flag =
      (c >= 0x80) | ((u8x16)(c - 'A') < 26) |
      (((u8x16)(c - 'a') < 26) & ~(space | ((u8x16)((q | 0x20) - 'a') < 26))) |
      (((u8x16)(c - '0') < 10) & ~(space | ((u8x16)(q - '0') < 10)));
  uint64_t w[2];
  std::memcpy(w, &flag, 16);
  if (w[0]) return __builtin_ctzll(w[0]) >> 3;
  if (w[1]) return 8 + (__builtin_ctzll(w[1]) >> 3);
  return 16;
}

}  // namespace

// capcode level-2 encode over UTF-8 bytes into out, which holds cap bytes.
// Returns the output's length, and writes no byte past cap (where the
// length is over cap, the caller calls again with room for it: "1a"
// encodes as "D 1D a").  *run_bytes gets the input bytes copied as runs.
// Port of javascript/tokenmonster.js:900-1005.  Outside a word the input
// is scanned 16 bytes at a time and the bytes before the first that may
// need a decision are copied as they are; that byte, and every code point
// inside a word, takes the reference's step.  The retro-fixup rewrites the
// word's bytes: markers are ASCII, and a word holds only code points that
// decode as they were written.  The output and the tables are held in
// locals, which the output's byte stores cannot alias.
int64_t tm_capcode_encode(const uint8_t* in, int64_t n, uint8_t* out,
                          int64_t cap, int64_t* run_bytes) {
  const uint8_t* const props = g_props;
  const uint32_t* const lower = g_lower;
  auto is = [props](uint32_t cp, uint8_t bit) {
    return cp < 0x110000 && (props[cp] & bit);
  };
  auto to_lower = [lower](uint32_t cp) {
    return cp < 0x110000 ? lower[cp] : cp;
  };
  auto word_sep = [&](uint32_t r) {
    return !(is(r, P_LETTER) || r == APOS || r == APOS2 ||
             is(r, P_MODIFIER));
  };
  uint8_t* o = out;
  int64_t room = cap, pos = 0;
  std::vector<uint8_t> spill, fix;
  auto need = [&](int64_t k) {
    if (pos + k > room) {
      const Room got = spill_room(spill, o, room, pos, k);
      o = got.o;
      room = got.cap;
    }
  };
  auto marker = [&](uint8_t b) {
    o[pos] = 'D';
    o[pos + 1] = b;
    pos += 2;
  };
  int64_t goback_pos = 0, word_token_pos = 0, runs = 0;
  uint32_t rlast = '.', rlast2 = '.';
  bool in_word = false, multi_letter = false;
  for (int64_t i = 0; i < n;) {
    // A byte >= 0x80 or an A-Z takes the step whatever the scan says.
    if (!in_word && i > 0 && in[i] < 0x80 && (uint8_t)(in[i] - 'A') >= 26) {
      const int64_t i0 = i;
      while (n - i >= 16) {
        need(16);
        std::memcpy(o + pos, in + i, 16);
        const int j = first_decision(in + i);
        i += j;
        pos += j;
        if (j < 16) break;
      }
      if (i > i0) {
        runs += i - i0;
        rlast2 = i - i0 >= 2 ? in[i - 2] : rlast;
        rlast = in[i - 1];
        if (i == n) break;
      }
    }
    int l;
    const uint32_t r = dec(in + i, n - i, &l);
    i += l;
    need(8);
    if (in_word) {
      if (is(r, P_UPPER)) {
        if (word_sep(rlast)) marker(' ');
        multi_letter = true;
        pos += enc(to_lower(r), o + pos);
      } else {
        if (is(r, P_LOWER)) {
          in_word = false;
          o[word_token_pos] = 'C';
          if (multi_letter) {
            // "D " before a lowercase code point becomes "DC ", and "DC "
            // goes before every other one.
            const int64_t end = pos;
            fix.clear();
            for (int64_t k = goback_pos; k < end;) {
              int cl;
              if (o[k] == 'D' && k + 1 < end && o[k + 1] == ' ') {
                if (k + 2 >= end) {
                  fix.insert(fix.end(), {'D', ' '});
                  break;
                }
                if (is(dec(o + k + 2, end - k - 2, &cl), P_LOWER))
                  fix.insert(fix.end(), {'D', 'C', ' '});
                else
                  fix.insert(fix.end(), {'D', ' '});
                fix.insert(fix.end(), o + k + 2, o + k + 2 + cl);
                k += 2 + cl;
              } else {
                if (is(dec(o + k, end - k, &cl), P_LOWER))
                  fix.insert(fix.end(), {'D', 'C', ' '});
                fix.insert(fix.end(), o + k, o + k + cl);
                k += cl;
              }
            }
            pos = goback_pos;
            need((int64_t)fix.size() + 8);
            std::memcpy(o + pos, fix.data(), fix.size());
            pos += (int64_t)fix.size();
          }
          if (word_sep(rlast)) marker(' ');
        } else if (is(r, P_NUMBER)) {
          if (!is(rlast, P_NUMBER)) marker(' ');
        } else if (!(r == APOS || r == APOS2 || is(r, P_MODIFIER))) {
          in_word = false;
        }
        pos += enc(r, o + pos);
      }
    } else {
      if (is(r, P_LOWER)) {
        if (!(rlast == ' ' || is(rlast, P_LETTER) ||
              (is(rlast2, P_LETTER) && (rlast == APOS || rlast == APOS2)) ||
              is(rlast, P_MODIFIER)))
          marker(' ');
      } else if (is(r, P_UPPER)) {
        if (rlast == ' ') {
          word_token_pos = pos - 1;
          o[word_token_pos] = 'W';
          o[pos++] = ' ';
        } else {
          marker('W');
          word_token_pos = pos - 1;
          o[pos++] = ' ';
        }
        pos += enc(to_lower(r), o + pos);
        goback_pos = pos;
        multi_letter = false;
        in_word = true;
      } else if (is(r, P_NUMBER)) {
        if (!(rlast == ' ' || is(rlast, P_NUMBER))) marker(' ');
      }
      if (!in_word) pos += enc(r, o + pos);
    }
    rlast2 = rlast;
    rlast = r;
  }
  *run_bytes = runs;
  if (o != out && pos <= cap) std::memcpy(out, o, (size_t)pos);
  return pos;
}

// capcode level-1 encode (0x7F delete token), no case transform.  out
// capacity must be >= 3*n bytes (each input code point is copied as it is,
// after at most one 2-byte marker).  Returns output length.
int64_t tm_nocapcode_encode(const uint8_t* in, int64_t n, uint8_t* out) {
  int64_t pos = 0;
  uint32_t rlast = '.', rlast2 = '.';
  for (int64_t i = 0; i < n;) {
    int l;
    uint32_t r = dec(in + i, n - i, &l);
    if (c_letter(r)) {
      if (!(rlast == ' ' || c_letter(rlast) ||
            (c_letter(rlast2) && (rlast == APOS || rlast == APOS2)) ||
            c_mod(rlast))) {
        out[pos++] = 0x7F;
        out[pos++] = ' ';
      }
    } else if (c_number(r)) {
      if (!(rlast == ' ' || c_number(rlast))) {
        out[pos++] = 0x7F;
        out[pos++] = ' ';
      }
    }
    std::memcpy(out + pos, in + i, (size_t)l);
    pos += l;
    i += l;
    rlast2 = rlast;
    rlast = r;
  }
  return pos;
}

// streaming capcode decode; state: [in_word, in_char, del, ignore] bytes
int64_t tm_capcode_decode(const uint8_t* in, int64_t n, uint8_t* out,
                          uint8_t* state) {
  bool in_word = state[0], in_char = state[1], del = state[2],
       ignore = state[3];
  int64_t pos = 0;
  for (int64_t i = 0; i < n;) {
    int l;
    uint32_t r = dec(in + i, n - i, &l);
    i += l;
    if (r == 'C') {
      in_char = true;
      in_word = false;
      continue;
    }
    if (r == 'W') {
      in_word = true;
      in_char = false;
      ignore = true;
      continue;
    }
    if (r == 'D') {
      del = true;
      continue;
    }
    if (r == ' ') {
      if (del) {
        del = false;
      } else {
        out[pos++] = ' ';
        if (!ignore) in_word = false;
      }
    } else {
      if (del) {
        del = false;
      } else if (in_char) {
        in_char = false;
        pos += enc(c_toupper(r), out + pos);
      } else if (in_word) {
        if (c_lower(r) || c_upper(r)) {
          pos += enc(c_toupper(r), out + pos);
        } else {
          pos += enc(r, out + pos);
          if (!(c_number(r) || r == APOS || r == APOS2 || c_mod(r)))
            in_word = false;
        }
      } else {
        pos += enc(r, out + pos);
      }
    }
    ignore = false;
  }
  state[0] = in_word;
  state[1] = in_char;
  state[2] = del;
  state[3] = ignore;
  return pos;
}

int64_t tm_nocapcode_decode(const uint8_t* in, int64_t n, uint8_t* out,
                            uint8_t* state) {
  bool del = state[2];
  int64_t pos = 0;
  for (int64_t i = 0; i < n;) {
    int l;
    uint32_t r = dec(in + i, n - i, &l);
    if (r == 0x7F) {
      del = true;
      i += l;
      continue;
    }
    if (del) {
      del = false;
      i += l;
      continue;
    }
    std::memcpy(out + pos, in + i, (size_t)l);
    pos += l;
    i += l;
  }
  state[2] = del;
  return pos;
}


// ---------------- candidate vocabulary metadata builder ----------------
//
// The trainer rebuilds per-token metadata (flags, word counts, ungreedy
// alternatives, beginByte votes) for every candidate vocabulary each round
// (trainvocab.go:592-907 duplicates go/tokenmonster.go:3486-3788).  This is
// the exact same computation as core/tokenmeta.py, in native code.

namespace {

inline uint32_t dec_rune(const uint8_t* p, int64_t rem, int* len) {
  if (rem <= 0) { *len = 0; return 0xFFFD; }
  uint32_t cp = dec(p, rem, len);
  if (cp >= 0x110000) return 0xFFFD;  // invalid byte sentinel -> U+FFFD
  return cp;
}

// Go utf8.DecodeLastRune semantics
inline uint32_t dec_last_rune(const uint8_t* p, int64_t n) {
  if (n <= 0) return 0xFFFD;
  if (p[n - 1] < 0x80) return p[n - 1];
  int64_t start = n - 1;
  int64_t lim = n - 4 < 0 ? 0 : n - 4;
  while (start >= lim && (p[start] & 0xC0) == 0x80) start--;
  if (start < 0 || (p[start] & 0xC0) == 0x80) return 0xFFFD;
  int l;
  uint32_t cp = dec_rune(p + start, n - start, &l);
  if (start + l != n) return 0xFFFD;
  return cp;
}

struct MetaCls {
  int capcode;
  inline bool letter(uint32_t r) const {
    uint8_t pr = g_props[r];
    if ((pr & P_LETTER) && (capcode != 2 || (r != 67 && r != 87 && r != 68)))
      return true;
    return (pr & P_MODIFIER) != 0;
  }
  inline bool alphanum(uint32_t r) const {
    uint8_t pr = g_props[r];
    if ((pr & P_LETTER) && (capcode != 2 || (r != 67 && r != 87 && r != 68)))
      return true;
    return (pr & (P_NUMBER | P_MODIFIER)) != 0;
  }
  inline bool number(uint32_t r) const { return g_props[r] & P_NUMBER; }
  inline bool space(uint32_t r) const { return g_props[r] & P_WHITESPACE; }
  inline bool cap(uint32_t r) const {
    return (capcode == 1 && r == 0x7F)
           || (capcode == 2 && (r == 67 || r == 87 || r == 68));
  }
};

}  // namespace

// Token-id stream -> concatenated token bytes (the decode hot loop; the
// reference C++ decodes at ~186 MB/s, tokenmonster-cpp/README.md:70).
// blob/offs: concatenation of all token byte strings and per-id offsets
// (offs has n_tokens+1 entries; deleted ids have zero length).  Returns the
// number of bytes written to out (caller sizes out via sum of lengths).
extern "C" int64_t tm_decode(const uint32_t* ids, int64_t n_ids,
                             const uint8_t* blob, const int64_t* offs,
                             uint32_t n_tokens, uint8_t* out) {
  int64_t pos = 0;
  for (int64_t i = 0; i < n_ids; i++) {
    uint32_t t = ids[i];
    if (t >= n_tokens) continue;
    int64_t o = offs[t];
    int64_t l = offs[t + 1] - o;
    std::memcpy(out + pos, blob + o, (size_t)l);
    pos += l;
  }
  return pos;
}

// Compute flag/nwords/alt indices/lengths and beginByte for every token.
// special_mask[i] != 0 marks special tokens (flag 64, no classification).
// Outputs: flag u8[n], nwords u8[n], index1/index2 u32[n] (DOES_NOT_EXIST
// when absent), len1/len2 i32[n], begin_byte u8[256].
void tm_build_meta(const uint8_t* key_bytes, const uint32_t* key_offs,
                   uint32_t n, int using_capcode,
                   const uint8_t* special_mask,
                   uint8_t* flag_out, uint8_t* nwords_out,
                   uint32_t* index1_out, uint32_t* index2_out,
                   int32_t* len1_out, int32_t* len2_out,
                   uint8_t* begin_byte_out) {
  Dict D;
  D.build(key_bytes, key_offs, n);
  MetaCls C{using_capcode};
  uint32_t begin_counts[256][4] = {};
  const uint32_t APOSU = 0x27, APOS2U = 0x2019;

  for (uint32_t ti = 0; ti < n; ti++) {
    const uint8_t* tok = key_bytes + key_offs[ti];
    int64_t tlen = key_offs[ti + 1] - key_offs[ti];
    index1_out[ti] = DOES_NOT_EXIST;
    index2_out[ti] = DOES_NOT_EXIST;
    len1_out[ti] = 0;
    len2_out[ti] = 0;
    nwords_out[ti] = 0;
    if (special_mask && special_mask[ti]) {
      flag_out[ti] = 64;
      continue;
    }
    int flag = 0, nwords = 0, min_alt = 1, bucket;
    int n1, n2;
    uint32_t r = dec_rune(tok, tlen, &n1);
    uint32_t r2 = dec_rune(tok + n1, tlen - n1, &n2);
    if (r == 0x20) {
      flag = 4;
      bucket = 0;
      if (C.alphanum(r2)) { nwords++; min_alt = 2; }
    } else if (C.letter(r)) {
      flag = 2;
      bucket = 1;
    } else if (C.cap(r)) {
      if (r == 67 || r == 87) flag = 4;
      flag |= 16;
      bucket = 3;
    } else if (C.number(r)) {
      bucket = 2;
    } else {
      bucket = 3;
    }
    bool only_ls = false, only_ns = false, only_p = false;
    if (tlen == 1) {
      only_p = true;
    } else {
      if ((r == 0x20 || C.letter(r)) && C.letter(r2)) only_ls = true;
      else if ((r == 0x20 || C.number(r)) && C.number(r2)) only_ns = true;
      else if (!C.alphanum(r) && !C.alphanum(r2)) only_p = true;
      uint32_t rr = r, rr2 = r2;
      int nn2 = n2;
      for (int64_t i = n1 + n2; i < tlen; i += nn2) {
        rr = rr2;
        rr2 = dec_rune(tok + i, tlen - i, &nn2);
        if (nn2 <= 0) break;
        if (rr == 0x20 && C.alphanum(rr2)) nwords++;
        if (C.letter(rr2)) { only_p = false; only_ns = false; }
        else if (C.number(rr2)) { only_p = false; only_ls = false; }
        else if (rr2 != 0x20) { only_ls = false; only_ns = false; }
      }
    }
    uint32_t last = dec_last_rune(tok, tlen);
    if (min_alt == 2 && C.letter(last) && only_ls && nwords == 1) flag |= 32;
    if (min_alt == 2 && nwords <= 1) min_alt = 1;
    if (C.cap(last)) flag |= 8;
    if (C.letter(last)) flag |= 1;
    if (only_ls || only_ns || only_p) flag |= 128;
    flag_out[ti] = (uint8_t)flag;
    nwords_out[ti] = (uint8_t)nwords;
    begin_counts[tok[0]][bucket]++;

    // hasSuffixPos (go :287-299)
    int64_t hassuffix = -1;
    {
      static const uint8_t s1[] = {0x27, 's'};
      static const uint8_t s2[] = {0xE2, 0x80, 0x99, 's'};
      const uint8_t* sufs[2] = {s1, s2};
      const int64_t suflens[2] = {2, 4};
      for (int si = 0; si < 2; si++) {
        int64_t sl = suflens[si];
        if (tlen > sl && std::memcmp(tok + tlen - sl, sufs[si], sl) == 0) {
          uint32_t rb = dec_last_rune(tok, tlen - sl);
          if (C.letter(rb)) { hassuffix = tlen - sl; break; }
        }
      }
    }

    // alternatives (go :3595-3764)
    uint32_t i1 = DOES_NOT_EXIST, i2v = DOES_NOT_EXIST;
    int l1 = 0, l2 = 0, p1 = 0, p2 = 0;
    auto place = [&](int32_t idx, int length, int priority) {
      if (p1 < p2 || (p1 == p2 && l1 <= l2)) {
        if (p1 < priority) { i1 = (uint32_t)idx; l1 = length; p1 = priority; }
      } else {
        if (p2 < priority) { i2v = (uint32_t)idx; l2 = length; p2 = priority; }
      }
    };
    for (int64_t length = tlen - 1; length >= min_alt; length--) {
      int32_t idx = D.find(tok, (uint32_t)length);
      if (idx < 0) continue;
      if (length <= tlen - 2 && tok[length] == 0x20) {
        int l_;
        uint32_t rr = dec_rune(tok + length + 1, tlen - length - 1, &l_);
        if (C.letter(rr) || C.number(rr)) { place(idx, (int)length, 10); continue; }
      }
      uint32_t rA = dec_last_rune(tok, length);
      int l_;
      uint32_t rB = dec_rune(tok + length, tlen - length, &l_);
      if (using_capcode == 0) {
        if (((!C.letter(rA) && rA != 0x5F) && (C.letter(rB) || rB == 0x5F))
            || (!C.number(rA) && C.number(rB))) {
          place(idx, (int)length, 9);
          continue;
        }
      }
      if (((C.letter(rA) || rA == 0x5F) && (!C.letter(rB) && rB != 0x5F))
          || (C.number(rA) && !C.number(rB))) {
        place(idx, (int)length, 9);
        continue;
      }
      if (C.space(rA) && !C.space(rB)) { place(idx, (int)length, 7); continue; }
      if (!C.space(rA) && C.space(rB)) { place(idx, (int)length, 8); continue; }
      if (C.cap(rB)) { place(idx, (int)length, 9); continue; }
      if (length == hassuffix) { place(idx, (int)length, 8); break; }
      place(idx, (int)length, 1);
    }
    if (l2 > 0 && (p2 > p1 || (p2 == p1 && l2 > l1))) {
      std::swap(i1, i2v);
      std::swap(l1, l2);
    }
    index1_out[ti] = i1;
    index2_out[ti] = i2v;
    len1_out[ti] = l1;
    len2_out[ti] = l2;
    (void)APOSU; (void)APOS2U;
  }

  // beginByte vote (go :3779-3788)
  for (int i = 0; i < 256; i++) {
    const uint32_t* c = begin_counts[i];
    uint8_t v = 0;
    if (c[1] > c[0] && c[1] > c[2] && c[1] > c[3] && c[1] > 2) v = 1;
    else if (c[0] > c[1] && c[0] > c[2] && c[0] > c[3] && c[0] > 2) v = 12;
    else if (c[3] > c[0] && c[3] > c[1] && c[3] > c[2] && c[3] > 2) v = 10;
    begin_byte_out[i] = v;
  }
}


// ---------------- Aho-Corasick DFA builder (ops/automaton.py in native) ----
//
// Builds the dense reversed-key AC DFA used by the TPU match kernels.
// Exact port of MatchAutomaton.build (ops/automaton.py): trie over
// reversed keys, BFS fail links collapsed into dense rows, per-state
// deepest-terminal packed outputs; alphabet 257 (byte 256 = reset).

namespace {
constexpr int AC_ALPHA = 257;

struct AcHandle {
  std::vector<uint32_t> dfa;   // n_states * AC_ALPHA
  std::vector<uint32_t> out;   // n_states
  uint32_t n_states = 0;
};
}  // namespace

void* tm_ac_build(const uint8_t* key_bytes, const uint32_t* key_offs,
                  uint32_t n, const uint32_t* indices,
                  const uint32_t* lengths) {
  // trie over reversed keys
  std::vector<std::vector<std::pair<uint8_t, uint32_t>>> children(1);
  std::vector<uint32_t> term_idx(1, 0xFFFFFF);
  std::vector<uint8_t> term_len(1, 0);
  for (uint32_t i = 0; i < n; i++) {
    const uint8_t* p = key_bytes + key_offs[i];
    int64_t len = key_offs[i + 1] - key_offs[i];
    uint32_t node = 0;
    for (int64_t j = len - 1; j >= 0; j--) {
      uint8_t c = p[j];
      uint32_t nxt = 0;
      for (auto& kv : children[node]) {
        if (kv.first == c) { nxt = kv.second; break; }
      }
      if (!nxt) {
        nxt = (uint32_t)children.size();
        children[node].push_back({c, nxt});
        children.push_back({});
        term_idx.push_back(0xFFFFFF);
        term_len.push_back(0);
      }
      node = nxt;
    }
    term_idx[node] = indices[i];
    term_len[node] = (uint8_t)lengths[i];
  }

  uint32_t n_states = (uint32_t)children.size();
  AcHandle* h = new AcHandle();
  h->n_states = n_states;
  h->dfa.assign((size_t)n_states * AC_ALPHA, 0);
  h->out.assign(n_states, 0);
  std::vector<uint32_t> fail(n_states, 0);
  if (term_len[0] > 0)
    h->out[0] = (term_idx[0] << 6) | term_len[0];

  std::vector<uint32_t> queue;
  queue.reserve(n_states);
  uint32_t* root_row = h->dfa.data();
  for (auto& kv : children[0]) {
    root_row[kv.first] = kv.second;
    fail[kv.second] = 0;
    queue.push_back(kv.second);
  }
  for (size_t qi = 0; qi < queue.size(); qi++) {
    uint32_t s = queue[qi];
    uint32_t f = fail[s];
    h->out[s] = term_len[s] > 0 ? ((term_idx[s] << 6) | term_len[s])
                                : h->out[f];
    uint32_t* row = h->dfa.data() + (size_t)s * AC_ALPHA;
    std::memcpy(row, h->dfa.data() + (size_t)f * AC_ALPHA,
                AC_ALPHA * sizeof(uint32_t));
    for (auto& kv : children[s]) {
      fail[kv.second] = row[kv.first];
      row[kv.first] = kv.second;
      queue.push_back(kv.second);
    }
    row[256] = 0;  // reset sentinel
  }
  return h;
}

// ---------------- sorted-window substring counting ----------------
// Bounded suffix sort for the getalltokens counting engine
// (training/getalltokens.go:1120-1157 enumerates all substrings; here one
// sort of the width-byte windows serves every substring length at once —
// see train/getalltokens.py::SortedWindows).  Orders positions 0..n-1 by
// their width-byte window (lexicographic; position as tiebreak, matching a
// stable sort) and reports the first differing byte column between
// lexicographic neighbours (LCP capped at width).
// `data` must have n + width + 8 readable bytes (caller pads).
void tm_sorted_windows(const uint8_t* data, int64_t n, int32_t width,
                       int32_t n_threads, uint32_t* order_out,
                       uint8_t* first_diff_out) {
  if (n <= 0) return;
  const int nw = (width + 7) / 8;
  const uint32_t tail = (uint32_t)width - (uint32_t)(nw - 1) * 8;
  const uint64_t tmask = Dict::tail_mask(tail);
  std::vector<uint64_t> packed((size_t)n * nw);
  if (n_threads < 1) n_threads = 1;

  auto pack_range = [&](int64_t lo, int64_t hi) {
    for (int64_t p = lo; p < hi; p++) {
      uint64_t* w = packed.data() + (size_t)p * nw;
      for (int i = 0; i < nw; i++) w[i] = Dict::loadbe(data + p + i * 8);
      w[nw - 1] &= tmask;
    }
  };

  // stable counting sort by the first two bytes, then per-bucket sorts
  std::vector<int64_t> bucket_off(65537, 0);
  for (int64_t p = 0; p < n; p++)
    bucket_off[(((uint32_t)data[p] << 8) | data[p + 1]) + 1]++;
  for (int i = 0; i < 65536; i++) bucket_off[i + 1] += bucket_off[i];
  {
    std::vector<int64_t> cur(bucket_off.begin(), bucket_off.end() - 1);
    for (int64_t p = 0; p < n; p++)
      order_out[cur[((uint32_t)data[p] << 8) | data[p + 1]]++] = (uint32_t)p;
  }

  auto run = [&](int64_t lo, int64_t hi) { pack_range(lo, hi); };
  if (n_threads > 1 && n > 1 << 16) {
    std::vector<std::thread> ts;
    int64_t step = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
      int64_t lo = t * step, hi = lo + step < n ? lo + step : n;
      if (lo < hi) ts.emplace_back(run, lo, hi);
    }
    for (auto& t : ts) t.join();
  } else {
    run(0, n);
  }

  auto sort_buckets = [&](int b_lo, int b_hi) {
    for (int b = b_lo; b < b_hi; b++) {
      int64_t lo = bucket_off[b], hi = bucket_off[b + 1];
      if (hi - lo < 2) continue;
      std::sort(order_out + lo, order_out + hi,
                [&](uint32_t a, uint32_t c) {
                  const uint64_t* wa = packed.data() + (size_t)a * nw;
                  const uint64_t* wc = packed.data() + (size_t)c * nw;
                  for (int i = 0; i < nw; i++)
                    if (wa[i] != wc[i]) return wa[i] < wc[i];
                  return a < c;
                });
    }
  };
  if (n_threads > 1) {
    // split bucket ranges by cumulative size for balance
    std::vector<std::thread> ts;
    int64_t per = (n + n_threads - 1) / n_threads;
    int b = 0;
    for (int t = 0; t < n_threads && b < 65536; t++) {
      int b_lo = b;
      int64_t target = bucket_off[b_lo] + per;
      while (b < 65536 && bucket_off[b + 1] < target) b++;
      b++;
      if (b > 65536) b = 65536;
      ts.emplace_back(sort_buckets, b_lo, b);
    }
    for (auto& t : ts) t.join();
  } else {
    sort_buckets(0, 65536);
  }

  // first differing byte column between adjacent sorted windows
  auto diff_range = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; i++) {
      const uint64_t* wa = packed.data() + (size_t)order_out[i] * nw;
      const uint64_t* wb = packed.data() + (size_t)order_out[i + 1] * nw;
      int fd = width;
      for (int k = 0; k < nw; k++) {
        uint64_t x = wa[k] ^ wb[k];
        if (x) {
          fd = k * 8 + (__builtin_clzll(x) >> 3);
          break;
        }
      }
      first_diff_out[i] = (uint8_t)fd;
    }
  };
  if (n_threads > 1 && n > 1 << 16) {
    std::vector<std::thread> ts;
    int64_t m = n - 1, step = (m + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
      int64_t lo = t * step, hi = lo + step < m ? lo + step : m;
      if (lo < hi) ts.emplace_back(diff_range, lo, hi);
    }
    for (auto& t : ts) t.join();
  } else {
    diff_range(0, n - 1);
  }
}

uint32_t tm_ac_states(void* hp) { return ((AcHandle*)hp)->n_states; }

void tm_ac_export(void* hp, uint32_t* dfa_out, uint32_t* out_out) {
  AcHandle* h = (AcHandle*)hp;
  std::memcpy(dfa_out, h->dfa.data(), h->dfa.size() * sizeof(uint32_t));
  std::memcpy(out_out, h->out.data(), h->out.size() * sizeof(uint32_t));
}

void tm_ac_free(void* hp) { delete (AcHandle*)hp; }

// ---------------- candidate-token mode filters ----------------
//
// Native port of train/filters.py (itself a line-by-line port of
// training/getalltokens.go:462-1105): clean / balanced / consistent /
// strict.  This is getalltokens' hot loop at trainer scale — the reference
// runs these in a threaded filter pool (getalltokens.go:1236-1314); here a
// batch call classifies every unique substring in one native pass.

namespace {
namespace filt {

constexpr uint32_t FRUNE_ERR = 0xFFFD;

// Go utf8.DecodeRune semantics: invalid -> (U+FFFD, 1); end -> (U+FFFD, 0).
inline uint32_t fdec(const uint8_t* b, int64_t n, int64_t i, int* sz) {
  if (i >= n) { *sz = 0; return FRUNE_ERR; }
  int l;
  uint32_t r = dec(b + i, n - i, &l);
  if (r >= 0x110000) { *sz = 1; return FRUNE_ERR; }
  *sz = l;
  return r;
}

inline uint32_t fdec_last(const uint8_t* b, int64_t n, int* sz) {
  if (n == 0) { *sz = 0; return FRUNE_ERR; }
  if (b[n - 1] < 0x80) { *sz = 1; return b[n - 1]; }
  int64_t start = n - 1;
  int64_t lim = n - 4 < 0 ? 0 : n - 4;
  while (start >= lim && (b[start] & 0xC0) == 0x80) start--;
  if (start < 0 || (b[start] & 0xC0) == 0x80) { *sz = 1; return FRUNE_ERR; }
  int l;
  uint32_t r = fdec(b, n, start, &l);
  if (start + l != n) { *sz = 1; return FRUNE_ERR; }
  *sz = l;
  return r;
}

inline bool is_delim(uint32_t r) {
  switch (r) {
    case 34: case 39: case 40: case 41: case 91: case 93: case 96:
    case 123: case 125: case 171: case 187: case 8216: case 8217:
    case 8219: case 8220: case 8221: case 8222: case 8223: case 8243:
    case 8249: case 8250: case 10075: case 10076: case 10077: case 10078:
    case 10094: case 10095: case 11816: case 11817: case 12296: case 12297:
    case 12298: case 12299: case 12300: case 12301: case 12302: case 12303:
    case 12308: case 12309: case 12317: case 12318: case 65378: case 65379:
      return true;
    default:
      return false;
  }
}
inline bool is_delim2(uint32_t r) {
  return r == 60 || r == 62 || is_delim(r);
}
inline uint32_t pair_closer(uint32_t r) {
  switch (r) {
    case 34: return 34;   case 39: return 39;   case 40: return 41;
    case 91: return 93;   case 96: return 96;   case 123: return 125;
    case 171: return 187; case 8216: return 8217; case 8219: return 8217;
    case 8220: return 8221; case 8222: return 8221; case 8223: return 8221;
    case 8243: return 8243; case 8249: return 8250; case 10075: return 10076;
    case 10077: return 10078; case 10094: return 10095;
    case 11816: return 11817; case 12296: return 12297;
    case 12298: return 12299; case 12300: return 12301;
    case 12302: return 12303; case 12308: return 12309;
    case 12317: return 12318; case 65378: return 65379;
    default: return 0;
  }
}

struct Ctx {
  int charset, capcode, words_per_token;

  // Python Ctx.decode: charset 2 returns (0xFFFD, 0) — filtered modes are
  // UTF-8-only, matching train/filters.py exactly
  inline uint32_t decode(const uint8_t* b, int64_t n, int64_t i,
                         int* sz) const {
    if (charset == 2) { *sz = 0; return FRUNE_ERR; }
    return fdec(b, n, i, sz);
  }

  inline bool is_letter(uint32_t r) const {
    uint8_t p = r < 0x110000 ? g_props[r] : 0;
    if ((p & P_LETTER) && (capcode != 2 || (r != 67 && r != 87 && r != 68)))
      return true;
    return (p & P_MODIFIER) != 0;
  }
  inline bool is_alphanum(uint32_t r) const {
    uint8_t p = r < 0x110000 ? g_props[r] : 0;
    if ((p & P_LETTER) && (capcode != 2 || (r != 67 && r != 87 && r != 68)))
      return true;
    return (p & (P_NUMBER | P_MODIFIER)) != 0;
  }
  inline bool is_number(uint32_t r) const {
    return r < 0x110000 && (g_props[r] & P_NUMBER);
  }
  inline bool is_space(uint32_t r) const {
    return r < 0x110000 && (g_props[r] & P_WHITESPACE);
  }
  inline bool is_capcode(uint32_t r) const {
    return (capcode == 1 && r == 0x7F)
           || (capcode == 2 && (r == 67 || r == 87 || r == 68));
  }
  inline bool is_other(uint32_t r) const { return !is_alphanum(r); }

  // strip_last_punc / strip_open_close operate on a (ptr, len) view
  inline int64_t strip_last_punc(const uint8_t* b, int64_t n) const {
    int nlast;
    uint32_t rlast = fdec_last(b, n, &nlast);
    if (is_other(rlast)) {
      if (is_space(rlast) || is_delim(rlast) || is_capcode(rlast)) return n;
      return n - nlast;
    }
    return n;
  }

  // returns true when stripped; updates *off/*len to the inner slice
  inline bool strip_open_close(const uint8_t* b, int64_t* off, int64_t* len,
                               uint32_t r, int n) const {
    const uint8_t* p = b + *off;
    int64_t ln = *len;
    if (ln <= n) return false;
    int64_t drop = n;
    if (r == 0x20) {
      int nx;
      r = decode(p, ln, 1, &nx);
      drop += nx;
      if (ln <= drop) return false;
    }
    uint32_t closer = pair_closer(r);
    if (closer == 0) return false;
    int n2;
    uint32_t last = fdec_last(p, ln, &n2);
    if (last == closer && ln - n2 >= drop) {
      *off += drop;
      *len = ln - drop - n2;
      return true;
    }
    return false;
  }

  inline bool words_exceeded(const uint8_t* b, int64_t n, int64_t i0) const {
    if (words_per_token <= 0) return false;
    bool in_space = true;
    int n_sp = 0;
    int64_t i = i0;
    while (i < n) {
      int n3;
      uint32_t r3 = decode(b, n, i, &n3);
      if (n3 <= 0) break;
      if (is_space(r3)) {
        if (!in_space) {
          in_space = true;
          if (++n_sp >= words_per_token) return true;
        }
      } else {
        in_space = false;
      }
      i += n3;
    }
    return false;
  }
};

// Every filter returns the kept prefix length (key minus its lookahead
// rune) or -1 when rejected — mirroring (token, ok) in filters.py.

int32_t filter_clean(const Ctx& c, const uint8_t* key, int64_t klen) {
  int nnext;
  uint32_t rnext = fdec_last(key, klen, &nnext);
  int64_t tlen = klen - nnext;
  if (tlen < 2) return -1;
  int64_t trimmed = tlen;

  bool removed = false;
  for (int64_t nn = tlen - 1; nn > 0; nn--) {
    if (key[nn] != 0x0A && key[nn] != 0x0D) { tlen = nn + 1; break; }
    removed = true;
  }

  int n_space = 0, n_newlines = 0, space_runs = 0, space_char = 0;
  bool has_alpha = false, has_capcode = false, exists = false,
       last_space = false, double_space = false, other = false,
       first_space = false;
  int64_t i = 0;
  uint32_t r = FRUNE_ERR;
  bool have_r = false;
  while (i < tlen) {
    int nr;
    r = c.decode(key, tlen, i, &nr);
    if (nr <= 0) break;
    have_r = true;
    if (c.is_letter(r) || c.is_number(r)) {
      exists = true; has_alpha = true; last_space = false;
    } else if (c.is_capcode(r)) {
      has_capcode = true;
    } else if (is_delim(r)) {
      exists = true; last_space = false;
    } else if (c.is_space(r)) {
      if (i == 0) {
        first_space = true;
        if (r == 0x20) space_char = 1;
      } else if (i == 1) {
        space_char = 0;
      }
      n_space++;
      if (r == 0x0A || r == 0x0D || r == 0x09) n_newlines++;
      if (last_space) {
        double_space = true;
        if (has_alpha && n_space != n_newlines) return -1;
      } else {
        space_runs++;
      }
      last_space = true;
    } else {
      other = true; last_space = false;
    }
    i += nr;
  }
  (void)have_r;
  space_runs -= space_char;
  n_space -= space_char;
  if (double_space && (exists || (other && space_runs > 1))) {
    if ((r == 0x20 && other && !removed)
        || (!last_space && !first_space && n_space > 3)
        || (!(n_space == n_newlines && space_runs <= 1)
            && !(n_space >= tlen - 1 && (!last_space || !first_space))))
      return -1;
  }
  if (c.capcode != 0
      && ((has_alpha || has_capcode || exists
           || (other && c.is_alphanum(rnext)))
          && r == 0x20 && !removed))
    return -1;
  return (int32_t)trimmed;
}

int32_t filter_balanced(const Ctx& c, const uint8_t* key, int64_t klen) {
  int nnext;
  uint32_t rnext = fdec_last(key, klen, &nnext);
  int64_t tlen = klen - nnext;
  if (tlen < 2) return -1;

  int n_space = 0, n_newlines = 0, space_runs = 0;
  bool has_alpha = false, has_capcode = false, exists = false,
       last_space = false, double_space = false, other = false,
       first_space = false, has_letter = false, space_char = false;
  int64_t i = 0;
  uint32_t r = FRUNE_ERR;
  while (i < tlen) {
    int nr;
    r = c.decode(key, tlen, i, &nr);
    if (nr <= 0) break;
    if (c.is_letter(r)) {
      exists = true; has_alpha = true; last_space = false; has_letter = true;
    } else if (c.is_number(r)) {
      exists = true; has_alpha = true; last_space = false;
    } else if (c.is_capcode(r)) {
      has_capcode = true;
    } else if (is_delim(r)) {
      exists = true; last_space = false;
    } else if (c.is_space(r)) {
      if (i == 0) {
        first_space = true;
        if (r == 0x20) space_char = true;
      } else if (i == 1) {
        space_char = false;
      }
      n_space++;
      if (r == 0x0A || r == 0x0D || r == 0x09) n_newlines++;
      if (last_space) {
        double_space = true;
        if (has_alpha) return -1;
      } else {
        space_runs++;
      }
      last_space = true;
    } else {
      other = true; last_space = false;
    }
    i += nr;
  }
  if (space_char) {
    first_space = false;
    space_runs--;
    n_space--;
  }
  if (r == 0x0A || r == 0x0D) space_runs--;
  if (double_space && (exists || (other && space_runs > 1))) {
    if (has_alpha || (r == 0x20 && other)
        || (exists && (n_space > 5
                       || (n_space > 3 && n_space != n_newlines)))
        || (!(n_space == n_newlines && space_runs <= 1)
            && !(n_space >= tlen - 1 && (!last_space || !first_space))))
      return -1;
  }
  if (has_alpha && c.capcode == 2 && c.is_capcode(r)) {
    if (tlen < 3) return -1;
    uint8_t b2 = key[tlen - 2], b3 = key[tlen - 3];
    if (!((b2 == 0x2E || b2 == 0x2D)
          || ((b2 == 68 || b2 == 127) && (b3 == 0x2E || b3 == 0x2D))))
      return -1;
  }
  if (c.capcode != 0 && (has_alpha || has_capcode) && c.is_space(r)) return -1;
  if (c.capcode != 0 && (other || exists) && r == 0x20) return -1;
  if (has_letter && c.is_letter(rnext)
      && (n_space >= 2 || (space_char && n_space >= 1)
          || ((n_space == 1 || (n_space == 0 && space_char))
              && key[0] != 0x20)))
    return -1;
  return (int32_t)tlen;
}

int32_t filter_consistent(const Ctx& c, const uint8_t* key, int64_t klen) {
  int nnext;
  uint32_t rnext = fdec_last(key, klen, &nnext);
  int64_t trimmed = klen - nnext;
  if (trimmed < 2) return -1;

  // (off, tlen) is the working slice of key[0:trimmed]
  int64_t off = 0, tlen = trimmed;
  int n1, n2 = 0;
  uint32_t r1 = c.decode(key + off, tlen, 0, &n1);
  uint32_t r2 = FRUNE_ERR;
  if (tlen > n1) {
    if (c.words_exceeded(key + off, tlen, n1)) return -1;
    r2 = c.decode(key + off, tlen, n1, &n2);
  } else {
    return (int32_t)trimmed;  // single multi-byte character
  }

  bool open_close_stripped = c.strip_open_close(key, &off, &tlen, r1, n1);
  if (open_close_stripped) {
    if (tlen == 0) return (int32_t)trimmed;
    r1 = c.decode(key + off, tlen, 0, &n1);
    if (tlen > n1) {
      r2 = c.decode(key + off, tlen, n1, &n2);
    } else {
      return (int32_t)trimmed;
    }
  }

  if (c.is_capcode(r1) && (c.is_capcode(r2) || r2 == 0x20)) {
    if (r2 == 0x20) {
      off += 1; tlen -= 1;
      r1 = 0x20; n1 = 1;
    } else {
      off += 2; tlen -= 2;
      r1 = c.decode(key + off, tlen, 0, &n1);
    }
    if (tlen > n1) {
      r2 = c.decode(key + off, tlen, n1, &n2);
    } else {
      return (int32_t)trimmed;
    }
  }

  const uint8_t* t = key + off;

  if (r1 == 0x20 && c.is_letter(r2)) {
    bool apos = false, space = false, has_space = false;
    int hyphenok = 0;
    int64_t sl = c.strip_last_punc(t, tlen);
    uint32_t r3 = FRUNE_ERR;
    bool any3 = false;
    int64_t i = n1 + n2;
    while (i < sl) {
      int n3;
      r3 = c.decode(t, sl, i, &n3);
      if (n3 <= 0) break;
      any3 = true;
      if (c.is_letter(r3) || c.is_number(r3)) {
        space = apos = false; hyphenok = 0;
      } else if (r3 == 0x20) {
        if (space) return -1;
        space = true; apos = false; has_space = true; hyphenok = 0;
      } else if (r3 == APOS || r3 == APOS2) {
        if (apos) return -1;
        apos = true; space = false;
      } else {
        space = apos = false;
        if (r3 == 0x2D || r3 == 0x2E || r3 == 0x5F) {
          if (hyphenok == 0) hyphenok = 1; else return -1;
        } else if (c.is_capcode(r3)) {
          if (hyphenok == 1) hyphenok = 2;
          else if (hyphenok == 2) hyphenok = 3;
        } else {
          return -1;
        }
      }
      i += n3;
    }
    if (!any3) r3 = r2;
    if (r3 == 0x20 || r3 == 0x2E || r3 == 0x2D
        || (c.is_capcode(r3) && hyphenok <= 1))
      return -1;
    if (c.is_letter(rnext) && has_space) return -1;
    return (int32_t)trimmed;
  }

  if (r1 == 0x20 && c.is_number(r2)) {
    int64_t sl = c.strip_last_punc(t, tlen);
    for (int64_t i = n1 + n2; i < sl;) {
      int n3;
      uint32_t r3 = c.decode(t, sl, i, &n3);
      if (n3 <= 0 || !c.is_number(r3)) return -1;
      i += n3;
    }
    return (int32_t)trimmed;
  }

  if (c.is_number(r1)) {
    if (!c.is_number(r2)) return -1;
    int64_t sl = c.strip_last_punc(t, tlen);
    for (int64_t i = n1 + n2; i < sl;) {
      int n3;
      uint32_t r3 = c.decode(t, sl, i, &n3);
      if (n3 <= 0 || !c.is_number(r3)) return -1;
      i += n3;
    }
    return (int32_t)trimmed;
  }

  if (c.is_letter(r1) && !c.is_letter(r2)) return -1;
  if (((r1 == APOS || r1 == APOS2) && c.is_letter(r2)) || c.is_letter(r1)) {
    int64_t sl = c.strip_last_punc(t, tlen);
    for (int64_t i = n1 + n2; i < sl;) {
      int n3;
      uint32_t r3 = c.decode(t, sl, i, &n3);
      if (n3 <= 0 || !c.is_letter(r3)) return -1;
      i += n3;
    }
    return (int32_t)trimmed;
  }

  int num_delim = 0, num_capcode = 0, num_space = 0, num_newline = 0,
      num_other = 0;
  int spaces_run = 0, max_spaces_run = 0, n_space_runs = 0;
  bool last_space = false, gt = false;
  uint32_t delim = 0;
  bool have_delim = false;
  int64_t delim_pos = 0;
  uint32_t r3 = FRUNE_ERR;
  int64_t i = 0;
  while (i < tlen) {
    int n3;
    r3 = c.decode(t, tlen, i, &n3);
    if (n3 <= 0) break;
    if (c.is_alphanum(r3)) {
      return -1;
    } else if (is_delim2(r3)) {
      num_delim++; delim = r3; have_delim = true; delim_pos = i;
      last_space = false;
    } else if (c.is_capcode(r3)) {
      num_capcode++;
    } else if (c.is_space(r3)) {
      num_space++;
      if (r3 == 0x0A || r3 == 0x0D || r3 == 0x09) num_newline++;
      if (last_space) {
        spaces_run++;
      } else {
        if (spaces_run > max_spaces_run) max_spaces_run = spaces_run;
        n_space_runs++;
        spaces_run = 1;
        last_space = true;
      }
    } else {
      num_other++;
      last_space = false;
      if (gt && r3 == 0x3C) return -1;
      if (r3 == 0x3E) gt = true;
    }
    i += n3;
  }
  (void)have_delim;
  if (spaces_run > max_spaces_run) max_spaces_run = spaces_run;
  if (r3 == 0x20 && (num_other > 0 || num_capcode > 0 || num_delim > 0))
    return -1;
  if (c.is_capcode(r3)) {
    if (tlen == 2 || (tlen <= 4 && num_capcode == 2)
        || (num_other == 0 && num_delim == 0))
      return (int32_t)trimmed;
  }
  if (max_spaces_run > 1
      && (num_delim != 0 || num_capcode != 0 || num_other != 0)
      && ((num_space != num_newline || (num_other + num_delim) > 3)
          || n_space_runs > 1))
    return -1;
  if (num_delim > 1 || (num_delim > 0 && open_close_stripped)) return -1;
  int other_and_space = num_other + num_space + num_capcode;
  if (num_delim == 1) {
    if (delim == 0x28 || delim == 0x5B || delim == 0x7B) {
      for (int64_t i2 = 0; i2 < delim_pos; i2++) {
        uint8_t bch = t[i2];
        if (bch != 0x2C && bch != 0x2E && bch != 0x20 && bch != 0x0D
            && bch != 0x0A)
          return -1;
      }
    } else if (delim == 0x29 || delim == 0x5D || delim == 0x7D) {
      for (int64_t i2 = delim_pos + 1; i2 < tlen; i2++) {
        uint8_t bch = t[i2];
        if (bch != 0x2C && bch != 0x2E && bch != 0x20 && bch != 0x0D
            && bch != 0x0A)
          return -1;
      }
    }
    if (is_delim(r1)) {
      if (tlen <= 3 && num_space <= 1) return (int32_t)trimmed;
    } else {
      if (other_and_space <= 1
          || (tlen == 3 && (r1 == 0x20 || r2 == 0x20))
          || r1 == 0x09)
        return (int32_t)trimmed;
    }
    return -1;
  }
  return (int32_t)trimmed;
}

int32_t filter_strict(const Ctx& c, const uint8_t* key, int64_t klen) {
  int nnext;
  uint32_t rnext = fdec_last(key, klen, &nnext);
  int64_t trimmed = klen - nnext;
  if (trimmed < 2) return -1;
  const uint8_t* t = key;
  int64_t tlen = trimmed;

  int n1, n2 = 0;
  uint32_t r1 = c.decode(t, tlen, 0, &n1);
  uint32_t r2 = FRUNE_ERR;
  if (tlen > n1) {
    if (c.words_exceeded(t, tlen, n1)) return -1;
    r2 = c.decode(t, tlen, n1, &n2);
  } else {
    return (int32_t)trimmed;
  }

  if (r1 == 0x20 && c.is_letter(r2)) {
    bool apos = false, space = false, has_space = false;
    uint32_t r3 = FRUNE_ERR;
    bool any3 = false;
    int64_t i = n1 + n2;
    while (i < tlen) {
      int n3;
      r3 = c.decode(t, tlen, i, &n3);
      if (n3 <= 0) break;
      any3 = true;
      if (c.is_letter(r3)) {
        space = apos = false;
      } else if (r3 == 0x20) {
        if (space) return -1;
        has_space = true; space = true; apos = false;
      } else if (r3 == APOS || r3 == APOS2) {
        if (apos) return -1;
        apos = true; space = false;
      } else {
        return -1;
      }
      i += n3;
    }
    if (!any3) r3 = r2;
    if (r3 == 0x20) return -1;
    if (c.is_letter(rnext) && has_space) return -1;
    return (int32_t)trimmed;
  }

  if (r1 == 0x20 && c.is_number(r2)) {
    for (int64_t i = n1 + n2; i < tlen;) {
      int n3;
      uint32_t r3 = c.decode(t, tlen, i, &n3);
      if (n3 <= 0 || !c.is_number(r3)) return -1;
      i += n3;
    }
    return (int32_t)trimmed;
  }

  if (c.is_number(r1)) {
    if (!c.is_number(r2)) return -1;
    for (int64_t i = n1 + n2; i < tlen;) {
      int n3;
      uint32_t r3 = c.decode(t, tlen, i, &n3);
      if (n3 <= 0 || !c.is_number(r3)) return -1;
      i += n3;
    }
    return (int32_t)trimmed;
  }

  if (c.is_letter(r1) && !c.is_letter(r2)) return -1;
  if (((r1 == APOS || r1 == APOS2) && c.is_letter(r2)) || c.is_letter(r1)) {
    for (int64_t i = n1 + n2; i < tlen;) {
      int n3;
      uint32_t r3 = c.decode(t, tlen, i, &n3);
      if (n3 <= 0 || !c.is_letter(r3)) return -1;
      i += n3;
    }
    return (int32_t)trimmed;
  }

  if (tlen == 2) {
    if ((r1 == 0x28 && r2 == 0x29) || (r1 == 0x5B && r2 == 0x5D)
        || (r1 == 0x7B && r2 == 0x7D) || (r1 == 0x22 && r2 == 0x22)
        || (r1 == 0x27 && r2 == 0x27))
      return (int32_t)trimmed;
    if ((r1 == 0x2C || r2 == 0x2C || r1 == 0x2E) && !c.is_space(r2))
      return (int32_t)trimmed;
  }

  int num_delim = 0, num_capcode = 0, num_space = 0, num_newline = 0,
      num_other = 0;
  int spaces_run = 0, max_spaces_run = 0, n_space_runs = 0;
  bool last_space = false, gt = false;
  uint32_t r3 = FRUNE_ERR;
  int64_t i = 0;
  while (i < tlen) {
    int n3;
    r3 = c.decode(t, tlen, i, &n3);
    if (n3 <= 0) break;
    if (c.is_alphanum(r3)) {
      return -1;
    } else if (is_delim(r3)) {
      num_delim++;
      last_space = false;
    } else if (c.is_capcode(r3)) {
      num_capcode++;
    } else if (c.is_space(r3)) {
      num_space++;
      if (r3 == 0x0A || r3 == 0x0D) num_newline++;
      if (last_space) {
        spaces_run++;
      } else {
        if (spaces_run > max_spaces_run) max_spaces_run = spaces_run;
        n_space_runs++;
        spaces_run = 1;
        last_space = true;
      }
    } else {
      num_other++;
      last_space = false;
      if (gt && r3 == 0x3C) return -1;
      if (r3 == 0x3E) gt = true;
    }
    i += n3;
  }
  if (spaces_run > max_spaces_run) max_spaces_run = spaces_run;

  if (c.is_capcode(r3)
      && (tlen == 2 || (tlen == 3 && num_capcode == 2)))
    return (int32_t)trimmed;
  if (num_space != tlen && r3 == 0x20) return -1;
  if (max_spaces_run > 1
      && (num_delim != 0 || num_capcode != 0 || num_other != 0)
      && ((num_space != num_newline || num_other > 1 || n_space_runs > 1)
          || (r3 != 0x0A && r3 != 0x0D && !c.is_capcode(r3))))
    return -1;
  int other_and_space = num_other + num_space + num_capcode;
  if (num_delim > 1) return -1;
  if (num_delim == 1) {
    if (other_and_space == 0
        || (other_and_space - num_capcode == 1 && r1 == 0x20))
      return (int32_t)trimmed;
    if (other_and_space == 1 && c.is_space(r1) && r1 != 0x09)
      return (int32_t)trimmed;
    return -1;
  }
  return (int32_t)trimmed;
}

}  // namespace filt
}  // namespace

// ---------------- token occurrence counter ----------------
//
// Fixed-width (48-byte row = 40 token bytes + length + padding) counting
// hash map for getalltokens' accumulation — the role of pansearch.Counter
// with Build_With_Min pruning (getalltokens.go:1128-1157).  A Python dict
// here is the scale killer: a diverse 20 MB micro-chunk yields tens of
// millions of unique candidates.

namespace {

struct Counter48 {
  static constexpr int KW = 6;  // 6 u64 words per key row
  std::vector<uint64_t> keys;   // KW words per entry
  std::vector<int64_t> counts;
  std::vector<int64_t> slots;   // entry index + 1, 0 = empty
  uint64_t mask = 0;

  static inline uint64_t hash_row(const uint64_t* w) {
    uint64_t h = 1469598103934665603ULL;
    for (int i = 0; i < KW; i++) h = (h ^ w[i]) * 1099511628211ULL;
    h ^= h >> 29;
    h *= 0xBF58476D1CE4E5B9ULL;
    h ^= h >> 32;
    return h;
  }

  void rehash(uint64_t cap) {
    slots.assign(cap, 0);
    mask = cap - 1;
    int64_t n = (int64_t)counts.size();
    for (int64_t e = 0; e < n; e++) {
      uint64_t at = hash_row(keys.data() + (size_t)e * KW) & mask;
      while (slots[at]) at = (at + 1) & mask;
      slots[at] = e + 1;
    }
  }

  void add(const uint64_t* w, int64_t c) {
    if (slots.empty() || counts.size() * 2 >= slots.size()) {
      uint64_t cap = slots.empty() ? (1 << 16) : slots.size() * 2;
      rehash(cap);
    }
    uint64_t at = hash_row(w) & mask;
    while (true) {
      int64_t e = slots[at];
      if (!e) {
        keys.insert(keys.end(), w, w + KW);
        counts.push_back(c);
        slots[at] = (int64_t)counts.size();
        return;
      }
      const uint64_t* kw = keys.data() + (size_t)(e - 1) * KW;
      if (std::memcmp(kw, w, KW * 8) == 0) {
        counts[(size_t)e - 1] += c;
        return;
      }
      at = (at + 1) & mask;
    }
  }

  void prune(int64_t min_occur) {
    int64_t n = (int64_t)counts.size();
    int64_t out = 0;
    for (int64_t e = 0; e < n; e++) {
      if (counts[e] >= min_occur) {
        if (out != e) {
          std::memcpy(keys.data() + (size_t)out * KW,
                      keys.data() + (size_t)e * KW, KW * 8);
          counts[(size_t)out] = counts[(size_t)e];
        }
        out++;
      }
    }
    keys.resize((size_t)out * KW);
    counts.resize((size_t)out);
    uint64_t cap = 1 << 16;
    while (cap < (uint64_t)out * 4) cap <<= 1;
    rehash(cap);
  }
};

}  // namespace

void* tm_counter_new() { return new Counter48(); }
void tm_counter_free(void* h) { delete (Counter48*)h; }

// rows: n * 48 bytes (40 token bytes zero-padded, byte 40 = length, 41..47
// zero); counts: per-row occurrence counts.
void tm_counter_add_batch(void* h, const uint8_t* rows, const int64_t* cnts,
                          int64_t n) {
  Counter48* c = (Counter48*)h;
  for (int64_t i = 0; i < n; i++) {
    uint64_t w[Counter48::KW];
    std::memcpy(w, rows + (size_t)i * 48, 48);
    c->add(w, cnts[i]);
  }
}

void tm_counter_prune(void* h, int64_t min_occur) {
  ((Counter48*)h)->prune(min_occur);
}

int64_t tm_counter_size(void* h) {
  return (int64_t)((Counter48*)h)->counts.size();
}

void tm_counter_export(void* h, uint8_t* rows_out, int64_t* counts_out) {
  Counter48* c = (Counter48*)h;
  std::memcpy(rows_out, c->keys.data(), c->counts.size() * 48);
  std::memcpy(counts_out, c->counts.data(), c->counts.size() * 8);
}

// One-pass candidate counting over pre-sorted windows: for every candidate
// length, walk the shared-prefix runs of the sorted window order (runs are
// maximal i-ranges with first_diff >= length), mode-filter the run's key
// once, and accumulate (token, run_count) into the counter.  Replaces the
// per-unique Python/numpy pipeline (extract -> filter -> pack -> add) with
// ~100ns/unique of native work.  prefilter_min > 1 drops raw substrings
// rarer than the micro-chunk floor before filtering (the same information-
// loss class as the reference's per-micro Build_With_Min prune,
// getalltokens.go:1128-1141).
void tm_count_from_sorted(const uint8_t* data, int64_t n,
                          const uint32_t* order, const uint8_t* first_diff,
                          int len_lo, int len_hi, int level, int charset,
                          int capcode, int words_per_token,
                          int max_token_length, int64_t prefilter_min,
                          void* counter_h, int n_threads) {
  Counter48* counter = (Counter48*)counter_h;
  filt::Ctx ctx{charset, capcode, words_per_token};
  (void)n_threads;
  for (int length = len_lo; length <= len_hi; length++) {
    int64_t i = 0;
    while (i < n) {
      // run of windows sharing the first `length` bytes
      int64_t j = i;
      while (j < n - 1 && first_diff[j] >= length) j++;
      int64_t count = j - i + 1;
      const uint8_t* key = data + order[i];
      i = j + 1;
      if (count < prefilter_min) continue;
      int32_t kept;
      switch (level) {
        case 0: kept = (int32_t)length; break;
        case 1: kept = filt::filter_clean(ctx, key, length); break;
        case 2: kept = filt::filter_balanced(ctx, key, length); break;
        case 3: kept = filt::filter_consistent(ctx, key, length); break;
        case 4: kept = filt::filter_strict(ctx, key, length); break;
        default: kept = (int32_t)length; break;
      }
      if (kept < 2 || kept > max_token_length) continue;
      uint64_t w[Counter48::KW] = {0, 0, 0, 0, 0, 0};
      std::memcpy(w, key, (size_t)kept);
      ((uint8_t*)w)[40] = (uint8_t)kept;
      counter->add(w, count);
    }
  }
}

// Batch-classify candidate substrings: for key i (bytes blob[offs[i] ..
// offs[i+1])) write out_len[i] = kept prefix length, or -1 when the mode
// filter rejects it.  level: 1 clean, 2 balanced, 3 consistent, 4 strict.
// Threaded over keys (reference: getalltokens.go:1236-1314 filter pool).
void tm_filter_batch(const uint8_t* blob, const int64_t* offs,
                     int64_t n_keys, int level, int charset, int capcode,
                     int words_per_token, int n_threads, int32_t* out_len) {
  filt::Ctx ctx{charset, capcode, words_per_token};
  auto run = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; i++) {
      const uint8_t* key = blob + offs[i];
      int64_t klen = offs[i + 1] - offs[i];
      int32_t res;
      switch (level) {
        case 1: res = filt::filter_clean(ctx, key, klen); break;
        case 2: res = filt::filter_balanced(ctx, key, klen); break;
        case 3: res = filt::filter_consistent(ctx, key, klen); break;
        case 4: res = filt::filter_strict(ctx, key, klen); break;
        default: res = (int32_t)klen; break;
      }
      out_len[i] = res;
    }
  };
  if (n_threads <= 1 || n_keys < 4096) {
    run(0, n_keys);
    return;
  }
  std::vector<std::thread> threads;
  int64_t per = (n_keys + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    int64_t lo = t * per, hi = std::min<int64_t>(n_keys, lo + per);
    if (lo >= hi) break;
    threads.emplace_back(run, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
