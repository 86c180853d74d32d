// Host loops over the kernels' per-thread functions (tm_kernels.cuh).
//
// Not part of the device path: the CPU tests compile this file with g++ and
// hold each loop against the PyTorch plain version of the same stage, which
// is the only check of the kernels' own arithmetic that runs without a card.
//
// The match and follow loops stage text tiles and lane-window tiles in
// ordinary arrays, the way the kernels stage them in shared memory, with
// the tile size a parameter so the tests can make tiles small.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libtm_host.so tm_host.cpp
#include <vector>

#include "tm_kernels.cuh"

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

void tm_decide_host(const tmk::DecideArgs* a, int rows) {
  for (int32_t fd = 0; fd < rows; ++fd)
    for (int64_t p = 0; p < a->N; ++p) tmk::decide_at(*a, p, fd);
}

void tm_follow_host(const tmk::FollowArgs* a, int tw) {
  const int32_t rows = a->rows > 1 ? a->rows : 1;
  std::vector<uint32_t> tile(static_cast<std::size_t>(rows) * tw);
  for (int32_t lane = 0; lane < a->L; ++lane) {
    tmk::FollowLane s = tmk::follow_begin(*a, lane);
    for (int32_t tb = 0;; tb = s.pos_rel) {
      for (int32_t k = 0; k < tw; ++k)
        for (int32_t r = 0; r < rows; ++r)
          tile[static_cast<std::size_t>(k) * rows + r] = tmk::follow_word(*a, s.start, r, (int64_t)tb + k);
      if (!tmk::follow_walk(*a, lane, s, tile.data(), tb, tw)) break;
    }
    tmk::follow_end(*a, lane, s, 0, 1);
  }
}

void tm_compact_host(const tmk::CompactArgs* a) {
  for (int32_t lane = 0; lane < a->L; ++lane) {
    const int32_t last = tmk::compact_last(*a, lane);
    for (int32_t j = tmk::compact_first(*a, lane); j <= last; ++j) tmk::compact_at(*a, lane, j);
  }
}

}  // extern "C"
