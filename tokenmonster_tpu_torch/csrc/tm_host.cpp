// Host loops over the kernels' per-thread functions (tm_kernels.cuh).
//
// Not part of the device path: the CPU tests compile this file with g++ and
// hold each loop against the PyTorch plain version of the same stage, which
// is the only check of the kernels' own arithmetic that runs without a card.
//
// Every loop stages its tiles (text, neighbourhood pairs, lane windows,
// record tiles) in ordinary arrays, the way the kernels stage them in
// shared memory, with the tile size a parameter so the tests can make
// tiles small.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libtm_host.so tm_host.cpp
#include <algorithm>
#include <cstddef>
#include <vector>

#include "tm_kernels.cuh"

namespace {

// Lanes walked on tiles of ``tw`` window positions in the kernel's tile
// word: a u32, or a u64 where the token words need it (tmk::follow_wide).
template <class W>
void follow_host(const tmk::FollowArgs* a, int tw) {
  const int32_t rows = a->rows > 1 ? a->rows : 1;
  std::vector<W> tile(static_cast<std::size_t>(rows) * tw);
  for (int32_t lane = 0; lane < a->L; ++lane) {
    tmk::FollowLane s = tmk::follow_begin(*a, lane);
    for (int32_t tb = 0;; tb = s.pos_rel) {
      for (int32_t k = 0; k < tw; ++k)
        for (int32_t r = 0; r < rows; ++r)
          tile[static_cast<std::size_t>(k) * rows + r] = tmk::follow_word<W>(*a, s.start, r, (int64_t)tb + k);
      if (!tmk::follow_walk<W>(*a, lane, s, tile.data(), tb, tw)) break;
    }
    tmk::follow_end(*a, lane, s, 0, 1);
  }
}

}  // namespace

extern "C" {

void tm_match_host(const tmk::MatchArgs* a, int tile) {
  const tmk::MatchTables tb{a->desc, a->len_cls, a->single, a->space_single, a->disp, a->filt, tmk::DESC_W};
  const uint64_t lengths = tmk::class_lengths(tb, a->max_len);
  std::vector<uint32_t> win(tmk::match_win_words(tile, a->max_len));
  for (int64_t p0 = 0; p0 < a->N; p0 += tile) {
    for (int32_t j = 0; j < (int32_t)win.size(); ++j) win[j] = tmk::match_win_word(*a, p0, j);
    for (int32_t t = 0; t < tile && p0 + t < a->N; ++t) tmk::match_window(*a, tb, lengths, win.data(), t, p0 + t);
  }
}

// The kernel's warp tile, in positions (tm_kernels.cuh MATCH_TILE).
int tm_match_tile() { return tmk::MATCH_TILE; }

// Tiles of ``tile`` positions, each with its DECIDE_REACH of lookahead
// staged first, as the kernel's blocks stage them in shared memory.
void tm_decide_host(const tmk::DecideArgs* a, int tile) {
  const int32_t rows = a->has_delete ? 2 : 1;
  tmk::DecideCls cls_of[256];
  for (int32_t i = 0; i < 256; ++i) cls_of[i] = tmk::decide_cls((uint32_t)a->bb[i]);
  std::vector<tmk::DecideNb> win(static_cast<std::size_t>(tile) + tmk::DECIDE_REACH);
  std::vector<tmk::DecideOwn> own(static_cast<std::size_t>(tile) * 2);
  for (int64_t p0 = 0; p0 < a->N; p0 += tile) {
    for (int32_t i = 0; i < (int32_t)win.size(); ++i)
      win[i] = tmk::decide_stage(*a, cls_of, p0 + i, i < tile ? &own[2 * i] : nullptr);
    for (int32_t i = 0; i < tile && p0 + i < a->N; ++i)
      for (int32_t fd = 0; fd < rows; ++fd) tmk::decide_tile_at(*a, win.data() + i, p0 + i, fd, own[2 * i + fd]);
  }
}

// The kernel's tile, in positions.
int tm_decide_tile() { return tmk::DECIDE_TILE; }

void tm_follow_host(const tmk::FollowArgs* a, int tw) {
  if (tmk::follow_wide(a->w3_shift))
    follow_host<uint64_t>(a, tw);
  else
    follow_host<uint32_t>(a, tw);
}

// Bytes of the follow kernel's tile word at these arguments.
int tm_follow_word_bytes(const tmk::FollowArgs* a) { return tmk::follow_word_bytes(a->w3_shift); }

// The match word the kernel's shared hit list gives for a hit of length
// ``l`` and index ``idx``, its length plus ``add``.
int tm_match_hit_word(int l, int idx, int add) { return tmk::match_hit_word(tmk::match_hit(l, idx), add); }

// Tiles of ``lane_tile`` lanes x ``rec_tile`` record rows turned through
// an array, then chunks of ``zero_chunk`` output slots (a multiple of 32)
// zeroed where no kept record maps, as the kernel's two kinds of block do.
void tm_compact_host(const tmk::CompactArgs* a, int lane_tile, int rec_tile, int zero_chunk) {
  std::vector<uint32_t> tile(static_cast<std::size_t>(rec_tile) * (lane_tile + 1));
  std::vector<tmk::CompactLane> lanes(lane_tile);
  for (int32_t lane0 = 0; lane0 < a->L; lane0 += lane_tile)
    for (int32_t j0 = 0; j0 < a->T; j0 += rec_tile) {
      bool live = false;
      for (int32_t i = 0; i < lane_tile; ++i) {
        lanes[i] = tmk::compact_lane(*a, lane0 + i);
        live = live || tmk::compact_lane_in(lanes[i], j0, rec_tile);
      }
      if (!live) continue;
      for (int32_t jj = 0; jj < rec_tile; ++jj)
        for (int32_t i = 0; i < lane_tile; ++i)
          if (tmk::compact_keeps(lanes[i], j0 + jj))
            tile[static_cast<std::size_t>(jj) * (lane_tile + 1) + i] = tmk::compact_word(*a, lane0 + i, j0 + jj);
      for (int32_t i = 0; i < lane_tile; ++i)
        for (int32_t jj = 0; jj < rec_tile; ++jj)
          if (tmk::compact_keeps(lanes[i], j0 + jj))
            tmk::compact_put(*a, lanes[i], j0 + jj, tile[static_cast<std::size_t>(jj) * (lane_tile + 1) + i]);
    }
  std::vector<uint32_t> bits(zero_chunk / 32);
  for (int64_t x0 = 0; x0 < a->out_len; x0 += zero_chunk) {
    std::fill(bits.begin(), bits.end(), 0u);
    for (int32_t l = 0; l < a->L; ++l) tmk::compact_mark(tmk::compact_lane(*a, l), x0, zero_chunk, bits.data());
    for (int32_t i = 0; i < zero_chunk; i += 4) tmk::compact_zero4(*a, x0, bits.data(), i);
  }
}

// The kernel's tiles: lanes, and in *recs record rows and *zero output
// slots of a zero-fill chunk.
int tm_compact_tile(int* recs, int* zero) {
  *recs = tmk::COMPACT_RECS;
  *zero = tmk::COMPACT_ZERO;
  return tmk::COMPACT_LANES;
}

// The layout of the argument structs, for the check of their ctypes
// mirrors (ops/_build.py): per struct its size, then each field's offset
// in declaration order.  Returns the number of values written.
int tm_args_layout(int64_t* out) {
#define TM_OFF(S, f) (int64_t) offsetof(tmk::S, f)
  const int64_t v[] = {
      (int64_t)sizeof(tmk::MatchArgs), TM_OFF(MatchArgs, text), TM_OFF(MatchArgs, fields),
      TM_OFF(MatchArgs, disp), TM_OFF(MatchArgs, single), TM_OFF(MatchArgs, space_single),
      TM_OFF(MatchArgs, scalars), TM_OFF(MatchArgs, desc), TM_OFF(MatchArgs, len_cls),
      TM_OFF(MatchArgs, ovf_keys), TM_OFF(MatchArgs, m), TM_OFF(MatchArgs, mb), TM_OFF(MatchArgs, n),
      TM_OFF(MatchArgs, N), TM_OFF(MatchArgs, max_len), TM_OFF(MatchArgs, idx1_bits),
      TM_OFF(MatchArgs, has_space), TM_OFF(MatchArgs, lil_off), TM_OFF(MatchArgs, filt),
      TM_OFF(MatchArgs, filt_log2), TM_OFF(MatchArgs, n_cls), TM_OFF(MatchArgs, disp_words),
      TM_OFF(MatchArgs, pad_),
      (int64_t)sizeof(tmk::DecideArgs), TM_OFF(DecideArgs, m), TM_OFF(DecideArgs, mb),
      TM_OFF(DecideArgs, text), TM_OFF(DecideArgs, entries), TM_OFF(DecideArgs, bb),
      TM_OFF(DecideArgs, ctl), TM_OFF(DecideArgs, tok), TM_OFF(DecideArgs, n),
      TM_OFF(DecideArgs, literals), TM_OFF(DecideArgs, N), TM_OFF(DecideArgs, n_entries),
      TM_OFF(DecideArgs, has_delete), TM_OFF(DecideArgs, lil_off), TM_OFF(DecideArgs, w3_shift),
      TM_OFF(DecideArgs, pad_),
      (int64_t)sizeof(tmk::FollowArgs), TM_OFF(FollowArgs, ctl), TM_OFF(FollowArgs, tok),
      TM_OFF(FollowArgs, recs), TM_OFF(FollowArgs, toks), TM_OFF(FollowArgs, done_all),
      TM_OFF(FollowArgs, n), TM_OFF(FollowArgs, N), TM_OFF(FollowArgs, rows), TM_OFF(FollowArgs, chunk),
      TM_OFF(FollowArgs, overlap), TM_OFF(FollowArgs, W), TM_OFF(FollowArgs, L),
      TM_OFF(FollowArgs, t_rec), TM_OFF(FollowArgs, w3_shift), TM_OFF(FollowArgs, pad_),
      (int64_t)sizeof(tmk::CompactArgs), TM_OFF(CompactArgs, recs), TM_OFF(CompactArgs, toks),
      TM_OFF(CompactArgs, s), TM_OFF(CompactArgs, e), TM_OFF(CompactArgs, q), TM_OFF(CompactArgs, out),
      TM_OFF(CompactArgs, out_len), TM_OFF(CompactArgs, T), TM_OFF(CompactArgs, L),
      TM_OFF(CompactArgs, w3_shift), TM_OFF(CompactArgs, pad_)};
#undef TM_OFF
  const int count = (int)(sizeof(v) / sizeof(v[0]));
  for (int i = 0; i < count; ++i) out[i] = v[i];
  return count;
}

}  // extern "C"
