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
//         A decision scores up to six branches: a first token (the match
//         or one of its two alternatives) and the token matched after it,
//         under M or Mb, up to 63 positions on, and the byte after that.
//         One thread per (position, fd row) gathering all of that itself
//         is bound by the gathers (about 16 scattered metadata reads a
//         position, one cache line per cycle and SM), and what is left
//         after that by the integer arithmetic of the scores.  So each
//         term is summed where it is known.  The first token's share of a
//         score and its flag bits come per token from a table built on
//         the host (four words a token and fd row).  A block owns 512
//         consecutive positions and both fd rows; once per position of its
//         tile and the 128 after it, it gathers the two tokens' table
//         entries (one 16-byte read each) and packs the share of the
//         second token and of the byte after it, with the flag bits that
//         meet the first token's, into an 8-byte pair in shared memory.
//         Then each thread decides its positions: one 8-byte shared-memory
//         read and a few operations a branch, and only the branches whose
//         first token stands.
// follow  replaces tokenmonster_tpu/ops/pallas_follow.py::make_follow_kernel.
//         FOLLOW_LANES lanes per block.  The whole block copies each lane's
//         window, w = tmk::follow_pack(ctl, tok) of every fd row (a u32, or
//         a u64 where the token words take more than 21 + 2 bits), into
//         shared memory with 16-byte loads; then one thread per lane walks
//         the serial chain there, a shared-memory read per step instead of
//         two dependent global reads.  Its record writes, one word per lane and
//         step, land side by side.  A window longer than the tile that fits
//         (a bridge or repair lane of a long span) is walked tile by tile:
//         lanes that leave their tile stop, the block refills those tiles
//         from where each stopped, and they walk on.
// compact replaces tokenmonster_tpu/ops/pallas_stitch.py::make_compact_kernel.
//         Moves little (about 12 bytes per kept record) and is bound by
//         latency and by how its reads fall: records lie lane-fastest, so a
//         thread per record of one lane reads 4 bytes of every 32-byte
//         sector it touches.  Blocks read tiles of 32 lanes x 64 record
//         rows along the lane axis (a warp reads 128 consecutive bytes),
//         turn them through shared memory, and write each lane's run of
//         consecutive slots; tiles outside every lane's kept range end
//         after reading the ranges.  Further blocks of the same launch zero
//         the slots no kept record maps to (a bitmap of the lanes' slot
//         ranges per 8,192 slots), so the caller allocates the output
//         without clearing it.  Kept ranges of different lanes map to
//         disjoint slots whenever every junction synced; otherwise the
//         output is discarded by the caller.
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
using tmk::DECIDE_PER;
using tmk::DECIDE_THREADS;
using tmk::DECIDE_TILE;
constexpr int COMPACT_THREADS = 256;

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
// longest hits, gathered with atomicMax on tmk::match_hit (length << 24 |
// index).  A lane whose lengths do not fit the list probes them alone
// afterwards.
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
    if (im > 0) atomicMax(res + (tt & 31), tmk::match_hit(l, im - 1));
    if (is > 0) atomicMax(res + 32 + (tt & 31), tmk::match_hit(l, is - 1));
  }
  __syncwarp();
  if (listed && n) {
    const uint32_t rm = res[lane], rb = res[32 + lane];
    if (st.need_m && rm) st.best = tmk::match_hit_word(rm, 0);
    if (st.need_b && rb) st.bestb = tmk::match_hit_word(rb, a.lil_off);
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

// A block decides DECIDE_TILE consecutive positions, every fd row: its
// threads first gather what the tile and its lookahead offer to their
// neighbours (tmk::decide_stage) into shared memory, each keeping what its
// own positions need in registers; then each thread decides its positions
// from shared memory alone.  Thread t takes positions t, t + blockDim, ...
// of the tile in both phases.
__global__ void __launch_bounds__(DECIDE_THREADS) decide_kernel(tmk::DecideArgs a) {
  __shared__ tmk::DecideNb win[DECIDE_TILE + tmk::DECIDE_REACH];
  __shared__ tmk::DecideCls cls_of[256];
  const int32_t t = threadIdx.x;
  for (int32_t i = t; i < 256; i += DECIDE_THREADS) cls_of[i] = tmk::decide_cls((uint32_t)__ldg(a.bb + i));
  __syncthreads();
  const int64_t p0 = (int64_t)blockIdx.x * DECIDE_TILE;
  tmk::DecideOwn own[DECIDE_PER][2];
#pragma unroll
  for (int32_t k = 0; k < DECIDE_PER; ++k) {
    const int32_t i = t + k * DECIDE_THREADS;
    win[i] = tmk::decide_stage(a, cls_of, p0 + i, own[k]);
  }
  for (int32_t i = DECIDE_TILE + t; i < DECIDE_TILE + tmk::DECIDE_REACH; i += DECIDE_THREADS)
    win[i] = tmk::decide_stage(a, cls_of, p0 + i, nullptr);
  __syncthreads();
  const int32_t rows = a.has_delete ? 2 : 1;
#pragma unroll
  for (int32_t k = 0; k < DECIDE_PER; ++k) {
    const int32_t i = t + k * DECIDE_THREADS;
    if (p0 + i >= a.N) continue;
#pragma unroll
    for (int32_t fd = 0; fd < 2; ++fd)
      if (fd < rows) tmk::decide_tile_at(a, win + i, p0 + i, fd, own[k][fd]);
  }
}

// Four tile words to dst[0..3], 16-byte aligned: one 16-byte store of u32
// words, two of u64 words.
__device__ __forceinline__ void store4(uint32_t* dst, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  *(uint4*)dst = make_uint4(a, b, c, d);
}

__device__ __forceinline__ void store4(uint64_t* dst, uint64_t a, uint64_t b, uint64_t c, uint64_t d) {
  ((ulonglong2*)dst)[0] = make_ulonglong2(a, b);
  ((ulonglong2*)dst)[1] = make_ulonglong2(c, d);
}

// Window positions [k0, k0 + tw) of every fd row of the lane starting at
// ``start`` into ``dst`` (the tile layout of tm_kernels.cuh), by the whole
// block: 16-byte loads of ctl and tok where they are aligned and below
// both the window's last position and N, word loads for the rest.
template <class W>
__device__ void fill_tile(const tmk::FollowArgs& a, int64_t start, int32_t k0, W* dst, int32_t tw,
                          int32_t rows) {
  using tmk::follow_pack;
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
    for (int32_t j = threadIdx.x; j < n4; j += blockDim.x) {
      const uint4 ca = __ldg(c0 + j), ta = __ldg(t0 + j), cb = __ldg(c1 + j), tb = __ldg(t1 + j);
      store4(dst + 8 * j, follow_pack<W>(ca.x, ta.x), follow_pack<W>(cb.x, tb.x), follow_pack<W>(ca.y, ta.y),
             follow_pack<W>(cb.y, tb.y));
      store4(dst + 8 * j + 4, follow_pack<W>(ca.z, ta.z), follow_pack<W>(cb.z, tb.z),
             follow_pack<W>(ca.w, ta.w), follow_pack<W>(cb.w, tb.w));
    }
  } else if (n4 > 0) {
    const uint4* c0 = (const uint4*)(a.ctl + q0);
    const uint4* t0 = (const uint4*)(a.tok + q0);
    for (int32_t j = threadIdx.x; j < n4; j += blockDim.x) {
      const uint4 ca = __ldg(c0 + j), ta = __ldg(t0 + j);
      store4(dst + 4 * j, follow_pack<W>(ca.x, ta.x), follow_pack<W>(ca.y, ta.y), follow_pack<W>(ca.z, ta.z),
             follow_pack<W>(ca.w, ta.w));
    }
  }
  for (int32_t i = 4 * n4 * rows + threadIdx.x; i < tw * rows; i += blockDim.x)
    dst[i] = tmk::follow_word<W>(a, start, i % rows, (int64_t)k0 + i / rows);
}

// W: the tile word, uint32_t up to S = 21, uint64_t above
// (tmk::follow_wide).
template <class W>
__global__ void __launch_bounds__(FOLLOW_THREADS) follow_kernel(tmk::FollowArgs a, int32_t tw,
                                                                 int32_t lpb) {
  extern __shared__ __align__(16) uint32_t sm_words[];
  W* sm = (W*)sm_words;
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
      if (need[i]) fill_tile<W>(a, lanes[i].start, base[i], sm + (size_t)i * rows * tw, tw, rows);
    __syncthreads();
    int32_t more = 0;
    if (me < lpb && need[me]) {
      tmk::FollowLane s = lanes[me];
      more = tmk::follow_walk<W>(a, lane0 + me, s, sm + (size_t)me * rows * tw, base[me], tw);
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

// Blocks [0, n_tiles) each turn one tile of COMPACT_LANES lanes x
// COMPACT_RECS record rows: warps read rows (consecutive lanes, side by side
// in memory), the tile's columns go out as runs of consecutive slots.  A
// tile no lane keeps a record of is left after reading the lanes' ranges.
// Blocks from n_tiles on each zero the slots of their COMPACT_ZERO that no
// kept record maps to.
__global__ void __launch_bounds__(COMPACT_THREADS) compact_kernel(tmk::CompactArgs a,
                                                                   int32_t n_tiles,
                                                                   int32_t row_tiles) {
  using tmk::COMPACT_LANES;
  using tmk::COMPACT_RECS;
  using tmk::COMPACT_ZERO;
  __shared__ uint32_t tile[COMPACT_RECS][COMPACT_LANES + 1];  // odd stride: no bank conflicts
  __shared__ tmk::CompactLane lanes[COMPACT_LANES];
  __shared__ uint32_t bits[COMPACT_ZERO / 32];
  const int32_t t = threadIdx.x, warp = t >> 5, lane = t & 31;
  if ((int32_t)blockIdx.x >= n_tiles) {
    const int64_t x0 = (int64_t)(blockIdx.x - n_tiles) * COMPACT_ZERO;
    for (int32_t i = t; i < COMPACT_ZERO / 32; i += COMPACT_THREADS) bits[i] = 0u;
    __syncthreads();
    for (int32_t l = t; l < a.L; l += COMPACT_THREADS)
      tmk::compact_mark(tmk::compact_lane(a, l), x0, COMPACT_ZERO, bits);
    __syncthreads();
    for (int32_t i = 4 * t; i < COMPACT_ZERO; i += 4 * COMPACT_THREADS)
      tmk::compact_zero4(a, x0, bits, i);
    return;
  }
  const int32_t lane0 = ((int32_t)blockIdx.x / row_tiles) * COMPACT_LANES;
  const int32_t j0 = ((int32_t)blockIdx.x % row_tiles) * COMPACT_RECS;
  bool live = false;
  if (t < COMPACT_LANES) {
    lanes[t] = tmk::compact_lane(a, lane0 + t);
    live = tmk::compact_lane_in(lanes[t], j0, COMPACT_RECS);
  }
  if (!__syncthreads_or(live)) return;
  const tmk::CompactLane mine = lanes[lane];
  for (int32_t jj = warp; jj < COMPACT_RECS; jj += COMPACT_THREADS / 32)
    if (tmk::compact_keeps(mine, j0 + jj)) tile[jj][lane] = tmk::compact_word(a, lane0 + lane, j0 + jj);
  __syncthreads();
  for (int32_t l = warp; l < COMPACT_LANES; l += COMPACT_THREADS / 32) {
    const tmk::CompactLane c = lanes[l];
    for (int32_t jj = lane; jj < COMPACT_RECS; jj += 32)
      if (tmk::compact_keeps(c, j0 + jj)) tmk::compact_put(a, c, j0 + jj, tile[jj][l]);
  }
}

// Takes no time on the card beyond its launch unless asked to spin: the
// yardstick of what a launch costs, and a way to hold a stream while the
// host queues work behind it.
__global__ void spin_kernel(long long cycles) {
  if (cycles <= 0) return;
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
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
                          (const void*)follow_kernel<uint32_t>, (const void*)follow_kernel<uint64_t>})
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
  const int64_t fit =
      (int64_t)(d.smem_optin - SMEM_SLACK) / (tmk::follow_word_bytes(a->w3_shift) * follow_lanes_per_block(a) * rows);
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

int tm_decide_launch(const tmk::DecideArgs* a, void* stream) {
  if (a->N > 0)
    decide_kernel<<<blocks_for(a->N, DECIDE_TILE), DECIDE_THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// The decide kernel's geometry: positions per block, and in *smem the
// bytes of shared memory a block holds for them and their lookahead.
int tm_decide_tile(int* smem) {
  *smem = (int)sizeof(tmk::DecideNb) * (DECIDE_TILE + tmk::DECIDE_REACH) + 256 * (int)sizeof(tmk::DecideCls);
  return DECIDE_TILE;
}

// Blocks of the decide kernel an SM holds at once (0: the query failed),
// and in *regs the registers of a thread.
int tm_decide_occupancy(int* regs) {
  cudaFuncAttributes attr;
  int blocks = 0;
  if (cudaFuncGetAttributes(&attr, (const void*)decide_kernel) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, (const void*)decide_kernel, DECIDE_THREADS,
                                                    0) != cudaSuccess)
    return 0;
  *regs = attr.numRegs;
  return blocks;
}

int tm_follow_launch(const tmk::FollowArgs* a, void* stream) {
  if (a->L <= 0) return (int)cudaGetLastError();
  DeviceLimits* d = nullptr;
  cudaError_t e = device_limits(&d);
  if (e != cudaSuccess) return (int)e;
  const int tw = follow_tile(a, *d);
  const int lpb = follow_lanes_per_block(a);
  const int rows = a->rows > 1 ? a->rows : 1;
  const size_t bytes = (size_t)tmk::follow_word_bytes(a->w3_shift) * lpb * rows * tw;
  if (tmk::follow_wide(a->w3_shift))
    follow_kernel<uint64_t><<<blocks_for(a->L, lpb), FOLLOW_THREADS, bytes, (cudaStream_t)stream>>>(*a, tw, lpb);
  else
    follow_kernel<uint32_t><<<blocks_for(a->L, lpb), FOLLOW_THREADS, bytes, (cudaStream_t)stream>>>(*a, tw, lpb);
  return (int)cudaGetLastError();
}

// The follow kernel's tile width (window positions per lane and fd row
// held in shared memory, in u32 words up to S = 21 and u64 above) for a
// launch with these arguments.
int tm_follow_tile(const tmk::FollowArgs* a) {
  DeviceLimits* d = nullptr;
  if (device_limits(&d) != cudaSuccess) return 0;
  return follow_tile(a, *d);
}

int tm_compact_launch(const tmk::CompactArgs* a, void* stream) {
  const int64_t lane_tiles = (a->L + tmk::COMPACT_LANES - 1) / tmk::COMPACT_LANES;
  const int64_t row_tiles = (a->T + tmk::COMPACT_RECS - 1) / tmk::COMPACT_RECS;
  const int64_t n_tiles = a->L > 0 && a->T > 0 ? lane_tiles * row_tiles : 0;
  const int64_t zero_blocks = (a->out_len + tmk::COMPACT_ZERO - 1) / tmk::COMPACT_ZERO;
  if (n_tiles + zero_blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidConfiguration;
  if (n_tiles + zero_blocks > 0)
    compact_kernel<<<(unsigned)(n_tiles + zero_blocks), COMPACT_THREADS, 0, (cudaStream_t)stream>>>(
        *a, (int32_t)n_tiles, (int32_t)(row_tiles > 0 ? row_tiles : 1));
  return (int)cudaGetLastError();
}

// One thread that spins for ``cycles`` of the card's clock (0: returns at
// once).
int tm_spin_launch(long long cycles, void* stream) {
  spin_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(cycles);
  return (int)cudaGetLastError();
}

const char* tm_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
