// CUDA kernels of the tokenization path, for Hopper (sm_90a).
//
// Built by ops/_build.py with nvcc into one shared library with a plain C
// interface, loaded with ctypes.  Each launcher takes its argument struct
// (tm_kernels.cuh) and the caller's stream, launches, allocates nothing,
// does not synchronise, and returns cudaGetLastError().
//
// match   replaces tokenmonster_tpu/ops/pallas_match.py::make_match_kernel.
//         One thread per byte position, an inner loop over key lengths.
//         Bound on this card by dependent gathers into the hash tables
//         (about 1.8 MB for a 32k vocabulary, so they stay in the 50 MB L2)
//         and by the per-length serial hash chain; the TPU's VMEM
//         partitioning and halving row-select have no counterpart here.
//         The loop stops at the first length that would end past n.
// decide  replaces tokenmonster_tpu/ops/pallas_decide.py::make_decide_kernel.
//         One thread per (position, fd row).  Bound by about 20 scattered
//         reads per thread into the match words, text and metadata planes,
//         all within 127 positions of p, so neighbouring threads share
//         cache lines; the metadata planes (2 x 4 B per token) sit in L2.
// follow  replaces tokenmonster_tpu/ops/pallas_follow.py::make_follow_kernel.
//         One thread per lane (at most 512), a serial chain of dependent
//         loads: latency-bound and using a few SMs.  It reads the decision
//         words in place, with no lane-window transpose.
// compact replaces tokenmonster_tpu/ops/pallas_stitch.py::make_compact_kernel.
//         One block per lane, threads striding over the lane's kept
//         records; writes are coalesced, reads stride by L words.  Kept
//         ranges of different lanes map to disjoint slots whenever every
//         junction synced; otherwise the output is discarded by the caller.
#include <cuda_runtime.h>

#include "tm_kernels.cuh"

namespace {

__global__ void match_kernel(tmk::MatchArgs a) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p < a.N) tmk::match_at(a, p);
}

__global__ void decide_kernel(tmk::DecideArgs a) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p < a.N) tmk::decide_at(a, p, (int32_t)blockIdx.y);
}

__global__ void follow_kernel(tmk::FollowArgs a) {
  const int32_t lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < a.L) tmk::follow_lane(a, lane);
}

__global__ void compact_kernel(tmk::CompactArgs a) {
  const int32_t lane = blockIdx.x;
  const int32_t last = tmk::compact_last(a, lane);
  for (int32_t j = tmk::compact_first(a, lane) + threadIdx.x; j <= last; j += blockDim.x)
    tmk::compact_at(a, lane, j);
}

int blocks_for(int64_t n, int threads) { return (int)((n + threads - 1) / threads); }

}  // namespace

extern "C" {

int tm_match_launch(const tmk::MatchArgs* a, void* stream) {
  const int threads = 256;
  if (a->N > 0)
    match_kernel<<<blocks_for(a->N, threads), threads, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

int tm_decide_launch(const tmk::DecideArgs* a, int rows, void* stream) {
  const int threads = 256;
  if (a->N > 0) {
    dim3 grid(blocks_for(a->N, threads), rows);
    decide_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(*a);
  }
  return (int)cudaGetLastError();
}

int tm_follow_launch(const tmk::FollowArgs* a, void* stream) {
  const int threads = 32;  // one warp per block spreads the lanes over SMs
  if (a->L > 0)
    follow_kernel<<<blocks_for(a->L, threads), threads, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

int tm_compact_launch(const tmk::CompactArgs* a, void* stream) {
  if (a->L > 0) compact_kernel<<<a->L, 256, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

const char* tm_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
