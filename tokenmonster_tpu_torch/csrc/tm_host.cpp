// Host loops over the kernels' per-thread functions (tm_kernels.cuh).
//
// Not part of the device path: the CPU tests compile this file with g++ and
// hold each loop against the PyTorch plain version of the same stage, which
// is the only check of the kernels' own arithmetic that runs without a card.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libtm_host.so tm_host.cpp
#include "tm_kernels.cuh"

extern "C" {

void tm_match_host(const tmk::MatchArgs* a) {
  for (int64_t p = 0; p < a->N; ++p) tmk::match_at(*a, p);
}

void tm_decide_host(const tmk::DecideArgs* a, int rows) {
  for (int32_t fd = 0; fd < rows; ++fd)
    for (int64_t p = 0; p < a->N; ++p) tmk::decide_at(*a, p, fd);
}

void tm_follow_host(const tmk::FollowArgs* a) {
  for (int32_t lane = 0; lane < a->L; ++lane) tmk::follow_lane(*a, lane);
}

void tm_compact_host(const tmk::CompactArgs* a) {
  for (int32_t lane = 0; lane < a->L; ++lane) {
    const int32_t last = tmk::compact_last(*a, lane);
    for (int32_t j = tmk::compact_first(*a, lane); j <= last; ++j) tmk::compact_at(*a, lane, j);
  }
}

}  // extern "C"
