// CUDA kernels of the tokenization path, for Hopper (sm_90a).
//
// Built by ops/_build.py with nvcc into one shared library with a plain C
// interface, loaded with ctypes.  Each launcher takes its argument struct
// (tm_kernels.cuh) and the caller's stream, launches, allocates nothing,
// does not synchronise, and returns cudaGetLastError().
//
// match   replaces tokenmonster_tpu/ops/pallas_match.py::make_match_kernel.
//         Persistent blocks of 1024 threads, one per SM.  Each block copies
//         the small tables into shared memory once: the key filter, the
//         class descriptors (rows padded to an odd stride), the
//         length-to-class map, the single-byte tables and, where they fit
//         beside the rest (the launcher checks), the displacement planes.
//         Each warp then takes tiles of MATCH_TILE positions on its own,
//         interleaved with the other warps', and stages each tile's text
//         window (tile + max_len bytes) with word loads; each lane runs a
//         position's hash chain from shared memory, tests every length
//         against the key filter there, and probes the hash tables in
//         global memory (L2) only for the lengths that pass, comparing
//         keys 32 bits at a time, a hit's planes loaded together.  Each
//         position probes the lengths that pass longest first and stops
//         once M (and Mb) are found; after a first probe in every lane,
//         the lanes' remaining lengths are probed by the whole warp from
//         one list, so one lane's long search does not idle the others.
// decide  replaces tokenmonster_tpu/ops/pallas_decide.py::make_decide_kernel.
//         One thread per (position, fd row).  Bound by about 20 scattered
//         reads per thread into the match words, text and metadata planes,
//         all within 127 positions of p, so neighbouring threads share
//         cache lines; the metadata planes (2 x 4 B per token) sit in L2.
// follow  replaces tokenmonster_tpu/ops/pallas_follow.py::make_follow_kernel.
//         FOLLOW_LANES lanes per block.  The whole block copies each lane's
//         window, w = ctl | tok << 10 of every fd row, into shared memory
//         with 16-byte loads; then one thread per lane walks the serial
//         chain there, a shared-memory read per step instead of two
//         dependent global reads.  Its record writes, one word per lane and
//         step, land side by side.  A window longer than the tile that fits
//         (a bridge or repair lane of a long span) is walked tile by tile:
//         lanes that leave their tile stop, the block refills those tiles
//         from where each stopped, and they walk on.
// compact replaces tokenmonster_tpu/ops/pallas_stitch.py::make_compact_kernel.
//         One block per lane, threads striding over the lane's kept
//         records; writes are coalesced, reads stride by L words.  Kept
//         ranges of different lanes map to disjoint slots whenever every
//         junction synced; otherwise the output is discarded by the caller.
#include <cuda_runtime.h>

#include <initializer_list>

#include "tm_kernels.cuh"

namespace {

constexpr int MATCH_THREADS = 1024;
constexpr int MATCH_WARPS = MATCH_THREADS / 32;
using tmk::MATCH_PER_LANE;
using tmk::MATCH_TILE;
constexpr int DESC_STRIDE = tmk::DESC_W + 1;       // odd: no bank conflicts
constexpr int MATCH_QUEUE = 64;                    // shared probes per warp and round
constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr int FOLLOW_THREADS = 256;
constexpr int FOLLOW_LANES = 4;   // most lanes per block
constexpr int SMEM_SLACK = 1024;  // bytes left for static shared memory

// Shared-memory layout of the match kernel, in u32 words.
struct MatchLayout {
  int32_t filt, desc, len_cls, single, space, disp, win, queue, total;
};

__host__ __device__ inline MatchLayout match_layout(const tmk::MatchArgs& a, bool disp_smem) {
  MatchLayout L;
  L.filt = 0;
  L.desc = L.filt + (1 << (a.filt_log2 - 5));
  L.len_cls = L.desc + a.n_cls * DESC_STRIDE;
  L.single = L.len_cls + a.max_len + 1;
  L.space = L.single + 256;
  L.disp = L.space + 256;
  L.win = L.disp + (disp_smem ? a.disp_words : 0);
  L.win += L.win & 1;  // 8-byte aligned window
  L.queue = L.win + MATCH_WARPS * tmk::match_win_words(MATCH_TILE, a.max_len);
  L.total = L.queue + MATCH_WARPS * (MATCH_QUEUE + 64);
  return L;
}

template <class T>
__device__ void copy_words(T* dst, const T* src, int32_t n) {
  for (int32_t i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
}

// tmk::match_window for the 32 positions of a warp, one per lane, window
// offset t: every lane probes its longest candidate; then the lengths the
// lanes still have go to one list, the whole warp probes them (a lane with
// many no longer holds up 31 lanes with none), and each lane keeps its
// longest hits, gathered with atomicMax on (length << 21 | index).  A lane
// whose lengths do not fit the list probes them alone afterwards.
__device__ void match_lane(const tmk::MatchArgs& a, const tmk::MatchTables& tb, uint64_t lengths,
                           const uint32_t* win, int32_t t, int64_t p0, uint32_t* queue,
                           uint32_t* res) {
  const int32_t lane = threadIdx.x & 31;
  const bool valid = p0 + t < a.N;
  tmk::MatchState st{};
  if (valid) st = tmk::match_begin(a, tb, lengths, win, t, p0 + t);
  if (valid && tmk::match_wants(st)) tmk::match_next(a, tb, win, t, st);
  const uint32_t n = valid && tmk::match_wants(st) ? __popcll(st.cand) : 0u;
  uint32_t incl = n;
  for (int32_t d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += y;
  }
  const bool listed = incl <= MATCH_QUEUE;
  if (listed) {
    uint64_t c = st.cand;
    for (uint32_t i = incl - n; i < incl; ++i) {
      const int32_t l = 63 - __clzll((long long)c);
      c &= ~(1ull << l);
      queue[i] = (uint32_t)t | ((uint32_t)l << 8);
    }
  }
  res[lane] = 0u;
  res[32 + lane] = 0u;
  const uint32_t listed_lanes = __ballot_sync(FULL, listed);  // a prefix of the lanes
  const uint32_t last = __shfl_sync(FULL, incl, listed_lanes ? 31 - __clz((int)listed_lanes) : 0);
  const uint32_t n_list = listed_lanes ? last : 0u;
  __syncwarp();
  for (uint32_t j = lane; j < n_list; j += 32) {
    const int32_t tt = (int32_t)(queue[j] & 255u), l = (int32_t)(queue[j] >> 8);
    int32_t im, is;
    tmk::match_probe(a, tb, win, tt, l, tmk::hash_window(win, tt, l), im, is);
    if (im > 0) atomicMax(res + (tt & 31), ((uint32_t)l << 21) | (uint32_t)(im - 1));
    if (is > 0) atomicMax(res + 32 + (tt & 31), ((uint32_t)l << 21) | (uint32_t)(is - 1));
  }
  __syncwarp();
  if (listed && n) {
    const uint32_t rm = res[lane], rb = res[32 + lane];
    if (st.need_m && rm) st.best = (int32_t)(((rm & 0x1FFFFFu) << 6) | (rm >> 21));
    if (st.need_b && rb) st.bestb = (int32_t)(((rb & 0x1FFFFFu) << 6) | ((rb >> 21) + a.lil_off));
    st.cand = 0;
  }
  while (valid && tmk::match_wants(st)) tmk::match_next(a, tb, win, t, st);
  if (valid) tmk::match_end(a, st, p0 + t);
}

template <bool kDispSmem>
__global__ void __launch_bounds__(MATCH_THREADS, 1) match_kernel(tmk::MatchArgs a, int32_t n_tiles) {
  extern __shared__ __align__(16) uint32_t sm[];
  const MatchLayout L = match_layout(a, kDispSmem);
  copy_words(sm + L.filt, a.filt, 1 << (a.filt_log2 - 5));
  for (int32_t i = threadIdx.x; i < a.n_cls * tmk::DESC_W; i += blockDim.x)
    sm[L.desc + (i / tmk::DESC_W) * DESC_STRIDE + i % tmk::DESC_W] = (uint32_t)__ldg(a.desc + i);
  copy_words((int32_t*)sm + L.len_cls, a.len_cls, a.max_len + 1);
  copy_words((int32_t*)sm + L.single, a.single, 256);
  copy_words((int32_t*)sm + L.space, a.space_single, 256);
  if (kDispSmem) copy_words((int32_t*)sm + L.disp, a.disp, a.disp_words);
  const tmk::MatchTables tb{(const int32_t*)sm + L.desc, (const int32_t*)sm + L.len_cls,
                            (const int32_t*)sm + L.single, (const int32_t*)sm + L.space,
                            kDispSmem ? (const int32_t*)sm + L.disp : a.disp, sm + L.filt,
                            DESC_STRIDE};
  __syncthreads();  // the tables are in; from here each warp works alone
  const uint64_t lengths = tmk::class_lengths(tb, a.max_len);
  // each warp stages the text of its own tiles, so a warp whose positions
  // probe much (runs of a repeated byte) holds up no other warp
  const int32_t win_words = tmk::match_win_words(MATCH_TILE, a.max_len);
  const int32_t warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* win = sm + L.win + warp * win_words;
  uint32_t* queue = sm + L.queue + warp * (MATCH_QUEUE + 64);
  uint32_t* res = queue + MATCH_QUEUE;
  const bool aligned = ((uintptr_t)a.text & 3u) == 0;
  const int32_t warps = gridDim.x * MATCH_WARPS;
  for (int32_t tile = blockIdx.x * MATCH_WARPS + warp; tile < n_tiles; tile += warps) {
    const int64_t p0 = (int64_t)tile * MATCH_TILE;
    __syncwarp();  // the last tile's readers are done
    for (int32_t j = lane; j < win_words; j += 32) {
      const int64_t q = p0 + 4 * (int64_t)j;
      win[j] = aligned && q + 3 < a.N ? __ldg((const uint32_t*)(a.text + q))
                                      : tmk::match_win_word(a, p0, j);
    }
    __syncwarp();
#pragma unroll 1
    for (int32_t k = 0; k < MATCH_PER_LANE; ++k)
      match_lane(a, tb, lengths, win, 32 * k + lane, p0, queue, res);
  }
}

__global__ void decide_kernel(tmk::DecideArgs a) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p < a.N) tmk::decide_at(a, p, (int32_t)blockIdx.y);
}

// Window positions [k0, k0 + tw) of every fd row of the lane starting at
// ``start`` into ``dst`` (the tile layout of tm_kernels.cuh), by the whole
// block: 16-byte loads of ctl and tok where they are aligned and below
// both the window's last position and N, word loads for the rest.
__device__ void fill_tile(const tmk::FollowArgs& a, int64_t start, int32_t k0, uint32_t* dst,
                          int32_t tw, int32_t rows) {
  const int64_t q0 = start + k0;
  int64_t exact = tw;
  if (a.W - k0 < exact) exact = a.W - k0;
  if (a.N - q0 < exact) exact = a.N - q0;
  int32_t n4 = exact > 0 ? (int32_t)(exact / 4) : 0;
  for (int32_t r = 0; r < rows; ++r)
    if (((uintptr_t)(a.ctl + r * a.N + q0) & 15u) || ((uintptr_t)(a.tok + r * a.N + q0) & 15u)) n4 = 0;
  if (n4 > 0 && rows == 2) {
    const uint4* c0 = (const uint4*)(a.ctl + q0);
    const uint4* t0 = (const uint4*)(a.tok + q0);
    const uint4* c1 = (const uint4*)(a.ctl + a.N + q0);
    const uint4* t1 = (const uint4*)(a.tok + a.N + q0);
    uint4* d4 = (uint4*)dst;
    for (int32_t j = threadIdx.x; j < n4; j += blockDim.x) {
      const uint4 ca = __ldg(c0 + j), ta = __ldg(t0 + j), cb = __ldg(c1 + j), tb = __ldg(t1 + j);
      d4[2 * j] = make_uint4(ca.x | (ta.x << 10), cb.x | (tb.x << 10), ca.y | (ta.y << 10), cb.y | (tb.y << 10));
      d4[2 * j + 1] = make_uint4(ca.z | (ta.z << 10), cb.z | (tb.z << 10), ca.w | (ta.w << 10), cb.w | (tb.w << 10));
    }
  } else if (n4 > 0) {
    const uint4* c0 = (const uint4*)(a.ctl + q0);
    const uint4* t0 = (const uint4*)(a.tok + q0);
    uint4* d4 = (uint4*)dst;
    for (int32_t j = threadIdx.x; j < n4; j += blockDim.x) {
      const uint4 ca = __ldg(c0 + j), ta = __ldg(t0 + j);
      d4[j] = make_uint4(ca.x | (ta.x << 10), ca.y | (ta.y << 10), ca.z | (ta.z << 10), ca.w | (ta.w << 10));
    }
  }
  for (int32_t i = 4 * n4 * rows + threadIdx.x; i < tw * rows; i += blockDim.x)
    dst[i] = tmk::follow_word(a, start, i % rows, (int64_t)k0 + i / rows);
}

__global__ void __launch_bounds__(FOLLOW_THREADS) follow_kernel(tmk::FollowArgs a, int32_t tw,
                                                                 int32_t lpb) {
  extern __shared__ __align__(16) uint32_t sm[];
  __shared__ int32_t base[FOLLOW_LANES];
  __shared__ int32_t need[FOLLOW_LANES];
  __shared__ tmk::FollowLane lanes[FOLLOW_LANES];
  const int32_t rows = a.rows > 1 ? a.rows : 1;
  const int32_t lane0 = blockIdx.x * lpb;
  const int32_t me = threadIdx.x;
  if (me < lpb) {
    base[me] = 0;
    need[me] = lane0 + me < a.L;
    if (need[me]) lanes[me] = tmk::follow_begin(a, lane0 + me);
  }
  for (;;) {
    __syncthreads();
    for (int32_t i = 0; i < lpb; ++i)
      if (need[i]) fill_tile(a, lanes[i].start, base[i], sm + (size_t)i * rows * tw, tw, rows);
    __syncthreads();
    int32_t more = 0;
    if (me < lpb && need[me]) {
      tmk::FollowLane s = lanes[me];
      more = tmk::follow_walk(a, lane0 + me, s, sm + (size_t)me * rows * tw, base[me], tw);
      lanes[me] = s;
      base[me] = s.pos_rel;
      need[me] = more;
    }
    if (!__syncthreads_or(more)) break;
  }
  // the rows after each lane's last step, by the whole block
  for (int32_t i = 0; i < lpb && lane0 + i < a.L; ++i)
    tmk::follow_end(a, lane0 + i, lanes[i], me, blockDim.x);
}

__global__ void compact_kernel(tmk::CompactArgs a) {
  const int32_t lane = blockIdx.x;
  const int32_t last = tmk::compact_last(a, lane);
  for (int32_t j = tmk::compact_first(a, lane) + threadIdx.x; j <= last; j += blockDim.x)
    tmk::compact_at(a, lane, j);
}

int blocks_for(int64_t n, int threads) { return (int)((n + threads - 1) / threads); }

// Per-device limits, read once per device.
struct DeviceLimits {
  int sms = 0;
  int smem_optin = 0;  // bytes of shared memory a block may ask for
  bool attrs_set = false;
};
DeviceLimits g_limits[64];

cudaError_t device_limits(DeviceLimits** out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  DeviceLimits& d = g_limits[dev];
  if (!d.attrs_set) {
    if ((e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&d.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
        cudaSuccess)
      return e;
    for (const void* k : {(const void*)match_kernel<true>, (const void*)match_kernel<false>,
                          (const void*)follow_kernel})
      if ((e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    d.smem_optin - SMEM_SLACK)) != cudaSuccess)
        return e;
    d.attrs_set = true;
  }
  *out = &d;
  return cudaSuccess;
}

// Shared-memory bytes of a match launch and whether the displacement
// planes are among them; 0 when even the rest does not fit.
int match_plan(const tmk::MatchArgs* a, const DeviceLimits& d, int* disp_smem) {
  const MatchLayout with = match_layout(*a, true);
  const MatchLayout without = match_layout(*a, false);
  const int cap = d.smem_optin - SMEM_SLACK;
  *disp_smem = with.total * 4 <= cap;
  const int bytes = (*disp_smem ? with.total : without.total) * 4;
  return bytes <= cap ? bytes : 0;
}

int follow_lanes_per_block(const tmk::FollowArgs* a) {
  return a->L < FOLLOW_LANES ? a->L : FOLLOW_LANES;
}

// Tile width of a follow launch: as much of each lane's window as fits.
int follow_tile(const tmk::FollowArgs* a, const DeviceLimits& d) {
  const int rows = a->rows > 1 ? a->rows : 1;
  const int64_t fit = (int64_t)(d.smem_optin - SMEM_SLACK) / (4 * follow_lanes_per_block(a) * rows);
  return (int)(a->W < fit ? a->W : fit) & ~3;  // 16-byte aligned lane tiles
}

}  // namespace

extern "C" {

int tm_match_launch(const tmk::MatchArgs* a, void* stream) {
  if (a->N <= 0) return (int)cudaGetLastError();
  if (a->max_len > tmk::MAX_KEY_LEN || a->filt_log2 < 5 || a->filt_log2 > 31)
    return (int)cudaErrorInvalidValue;
  DeviceLimits* d = nullptr;
  cudaError_t e = device_limits(&d);
  if (e != cudaSuccess) return (int)e;
  int disp_smem = 0;
  const int bytes = match_plan(a, *d, &disp_smem);
  if (bytes == 0) return (int)cudaErrorInvalidConfiguration;
  const int64_t tiles = (a->N + MATCH_TILE - 1) / MATCH_TILE;
  const int64_t blocks = (tiles + MATCH_WARPS - 1) / MATCH_WARPS;
  const int grid = (int)(blocks < d->sms ? blocks : d->sms);
  if (disp_smem)
    match_kernel<true><<<grid, MATCH_THREADS, bytes, (cudaStream_t)stream>>>(*a, (int32_t)tiles);
  else
    match_kernel<false><<<grid, MATCH_THREADS, bytes, (cudaStream_t)stream>>>(*a, (int32_t)tiles);
  return (int)cudaGetLastError();
}

// How a match launch uses shared memory: its bytes (0: it cannot launch)
// and, in *disp_smem, whether the displacement planes are held there.
int tm_match_smem(const tmk::MatchArgs* a, int* disp_smem) {
  DeviceLimits* d = nullptr;
  if (device_limits(&d) != cudaSuccess) return 0;
  return match_plan(a, *d, disp_smem);
}

// The match kernel's geometry: positions per warp tile, and in *block the
// positions a block covers per round (its warps take consecutive tiles).
int tm_match_tile(int* block) {
  *block = MATCH_WARPS * MATCH_TILE;
  return MATCH_TILE;
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
  if (a->L <= 0) return (int)cudaGetLastError();
  DeviceLimits* d = nullptr;
  cudaError_t e = device_limits(&d);
  if (e != cudaSuccess) return (int)e;
  const int tw = follow_tile(a, *d);
  const int lpb = follow_lanes_per_block(a);
  const int rows = a->rows > 1 ? a->rows : 1;
  const size_t bytes = (size_t)4 * lpb * rows * tw;
  follow_kernel<<<blocks_for(a->L, lpb), FOLLOW_THREADS, bytes, (cudaStream_t)stream>>>(*a, tw, lpb);
  return (int)cudaGetLastError();
}

// The follow kernel's tile width (window positions per lane and fd row
// held in shared memory) for a launch with these arguments.
int tm_follow_tile(const tmk::FollowArgs* a) {
  DeviceLimits* d = nullptr;
  if (device_limits(&d) != cudaSuccess) return 0;
  return follow_tile(a, *d);
}

int tm_compact_launch(const tmk::CompactArgs* a, void* stream) {
  if (a->L > 0) compact_kernel<<<a->L, 256, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

const char* tm_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
