// sorted_grouped_sum: per-group sums over rows sorted by dense group rank.
//
//   out[v, g] = sum over rows i with codes[i] == g of values[v, i]
//
// codes: int32 [n], sorted ascending, dense ranks in [0, num_groups) (a code
// outside that range adds nothing). values: float32 [nv, n], row-major,
// pre-masked by the caller (row 0 is the filter mask itself, so out[0] is
// the per-group count). out: float32 [nv, num_groups]; the kernels write
// every element exactly once (groups that no row holds get 0), so the caller
// need not zero it. scratch: float32 [tiles, 2, nv], tiles = ceil(n / TILE).
//
// Replaces the Pallas TPU kernel ballista_tpu/ops/pallas_kernels.py::
// sorted_grouped_sum (_build_sorted.kernel). On the TPU that kernel reached
// the MXU with a one-hot [AV, B] @ [B, W] product per 1024-row block and a
// read-modify-write DMA of a 256-lane-padded output window, on a grid that
// runs in order. Here the function is a reduce-by-key over the sorted codes.
//
// Bound on an H100 SXM: memory. The function reads n * 4 bytes of codes and
// nv * n * 4 bytes of values once and writes nv * num_groups * 4 bytes, about
// 2 flops per value element. At 3.35 TB/s, TPC-H q18's inner aggregate at
// SF 1 (n ~ 6.0M, nv = 2, G ~ 1.5M) is ~84 MB, ~25 us.
//
// Design (a reduce-by-key that reads the codes once for up to 4 value rows).
// - Tiles and strips. A block owns tiles of TILE = 2048 rows; each of its
//   256 threads owns a strip of 8 consecutive rows of the tile and reduces
//   it by key in registers. The sum of each strip's last run is carried
//   across the block by a segmented scan (shuffles inside a warp, then a
//   shuffle scan of the 8 warps' totals), so a run that spans strips is
//   summed where it ends. Every value row of a pass shares the one pass over
//   the codes; nv > 4 runs ceil(nv / 4) passes (one launch each).
// - Loads in flight. The grid is persistent (2 blocks per SM, each walking
//   tiles b, b + grid, ...). Each block keeps a ring of 3 stages in shared
//   memory, filled by cp.async.bulk copies (one per array per tile) that
//   complete on an mbarrier (bulk_ring.cuh), so two tiles are in flight
//   while one is reduced: 2 x 2 x 24.6 KB per SM at nv = 2. Deeper rings and
//   more blocks measured slower on the H100. The copies mark their lines
//   evict-first in L2, and run sums leave with streaming stores.
//   The windowed copy keeps each row's phase modulo 16, so a value row that
//   starts 4- or 8-byte aligned (row v starts at v * n * 4 bytes) is read
//   from shared memory with 16-byte loads and a shift chosen per row.
// - Runs that cross tiles: a two-pass fix-up, no atomics. Pass 1 writes each
//   run that ends in its tile and did not start in an earlier one directly,
//   and each tile's first and last run sums ("pieces") to scratch. Pass 2
//   gives one warp to each tile where a run that crossed into it ends: it
//   finds the tile where the run began (the previous tile, or a 32-way
//   search over the tiles' last codes when the run fills it), sums the
//   pieces in tile order with a fixed reduction tree and writes the group.
//   So the sums are bit-reproducible from run to run, and a single group
//   spanning hundreds of tiles costs one warp's walk over its pieces.
// - No zero-fill. Groups in [0, num_groups) that no row holds are written 0
//   by the thread that ends the run before them (and by tile 0 for those
//   below the first code), so the output needs no memset. With dense ranks
//   there are no such gaps; the common run end (a group strictly inside the
//   tile, followed by the next group) takes a short path of NVP stores.
//
// Precision: sums accumulate in f32 in a fixed order. Counts (row 0) are
// exact while a group has at most 2^24 rows; the fused stage gates this
// route to stages of at most 2^24 rows (the JAX package's gate, kept).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_ring.cuh"

namespace {

constexpr int WARP = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / WARP;
constexpr int STRIP = 8;                    // rows per thread
constexpr int TILE = THREADS * STRIP;       // rows per tile
constexpr int MAX_NVP = 4;                  // value rows per pass
constexpr int BUF_BYTES = TILE * 4 + 16;    // one array's stage buffer
constexpr int STAGES = 3;                   // ring depth

// rows base .. base + K - 1 of a stage buffer whose row 0 sits at word
// `sh` (0..3); base is a multiple of 4, so three 16-byte loads cover them
template <int K>
__device__ __forceinline__ void read_rows(const uint32_t* buf, int sh, int base,
                                          uint32_t (&out)[K]) {
  static_assert(K <= 9, "three 16-byte loads hold rows base .. base + 8");
  const uint4* p = reinterpret_cast<const uint4*>(buf + base);
  uint32_t w[12];
  const uint4 a = p[0], b = p[1];
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  if (K > 8 || sh != 0) {
    const uint4 c = p[2];
    w[8] = c.x; w[9] = c.y; w[10] = c.z; w[11] = c.w;
  } else {
    w[8] = w[9] = w[10] = w[11] = 0u;
  }
#define BT_SEL(S)                                 \
  _Pragma("unroll") for (int j = 0; j < K; ++j) { \
    out[j] = w[j + S];                            \
  }
  switch (sh) {
    case 0: BT_SEL(0) break;
    case 1: BT_SEL(1) break;
    case 2: BT_SEL(2) break;
    default: BT_SEL(3) break;
  }
#undef BT_SEL
}

template <int NVP>
struct Carry {
  int flag;  // a run starts at or after the first strip of the span
  float v[NVP];
};

// the segmented combine: (left) then (right)
template <int NVP>
__device__ __forceinline__ Carry<NVP> combine(const Carry<NVP>& l, const Carry<NVP>& r) {
  Carry<NVP> c;
  c.flag = l.flag | r.flag;
#pragma unroll
  for (int v = 0; v < NVP; ++v) c.v[v] = r.flag ? r.v[v] : l.v[v] + r.v[v];
  return c;
}

template <int NVP>
__global__ void __launch_bounds__(THREADS, 2)
sorted_grouped_sum_tiles(const int32_t* __restrict__ codes,
                         const float* __restrict__ values, float* __restrict__ out,
                         float* __restrict__ scratch, int64_t n, int nv, int v0,
                         int64_t num_groups, int64_t tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bars[STAGES];
  __shared__ int warp_flag[WARPS];
  __shared__ float warp_val[WARPS][NVP];

  const int tid = threadIdx.x;
  const int lane = tid & (WARP - 1);
  const int warp = tid >> 5;
  constexpr int ARRAYS = 1 + NVP;
  constexpr int STAGE_BYTES = ARRAYS * BUF_BYTES;
  const float* vbase = values + (int64_t)v0 * n;
  const void* c_begin = codes;
  const void* c_end = codes + n;
  const void* v_begin = values;
  const void* v_end = values + (int64_t)nv * n;

  // the segment plans of one tile: array 0 codes, 1.. the pass's value rows
  auto seg = [&](int64_t tile, int a) {
    const int64_t r0 = tile * TILE;
    const int64_t r1 = r0 + TILE < n ? r0 + TILE : n;
    if (a == 0)
      return ring::plan(c_begin, c_end, reinterpret_cast<uint64_t>(codes + r0),
                        reinterpret_cast<uint64_t>(codes + r1));
    const float* row = vbase + (int64_t)(a - 1) * n;
    return ring::plan(v_begin, v_end, reinterpret_cast<uint64_t>(row + r0),
                      reinterpret_cast<uint64_t>(row + r1));
  };
  auto issue_tile = [&](int64_t tile, int st) {
    unsigned char* stage = smem + (size_t)st * STAGE_BYTES;
    uint32_t bytes = 0;
#pragma unroll
    for (int a = 0; a < ARRAYS; ++a) bytes += ring::copy_bytes(seg(tile, a));
    ring::mbar_arrive_expect_tx(&bars[st], bytes);
#pragma unroll
    for (int a = 0; a < ARRAYS; ++a) ring::issue(seg(tile, a), stage + a * BUF_BYTES, &bars[st]);
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) ring::mbar_init(&bars[s], 1);
    ring::fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      const int64_t tile = blockIdx.x + (int64_t)s * gridDim.x;
      if (tile < tiles) issue_tile(tile, s);
    }
  }

  for (int64_t it = 0;; ++it) {
    const int64_t tile = blockIdx.x + it * gridDim.x;
    if (tile >= tiles) break;
    const int st = (int)(it % STAGES);
    const uint32_t parity = (uint32_t)((it / STAGES) & 1);
    const int64_t r0 = tile * TILE;
    const int len = (int)(r0 + TILE < n ? TILE : n - r0);
    const bool has_prev = r0 > 0;
    const bool has_next = r0 + len < n;
    const int32_t prev_code = has_prev ? __ldg(codes + r0 - 1) : 0;
    const int32_t next_code = has_next ? __ldg(codes + r0 + len) : 0;
    unsigned char* stage = smem + (size_t)st * STAGE_BYTES;

    ring::mbar_wait(&bars[st], parity);
    bool rag = false;
#pragma unroll
    for (int a = 0; a < ARRAYS; ++a) rag |= ring::ragged(seg(tile, a));
    if (rag) {
#pragma unroll
      for (int a = 0; a < ARRAYS; ++a)
        ring::fill_ragged(seg(tile, a), stage + a * BUF_BYTES, tid, THREADS);
      __syncthreads();
    }

    // row 0 of each array sits at word sh of its buffer
    int sh[ARRAYS];
#pragma unroll
    for (int a = 0; a < ARRAYS; ++a) {
      const ring::Seg g = seg(tile, a);
      sh[a] = (int)((g.s - g.W) >> 2);
    }
    const uint32_t* cbuf = reinterpret_cast<const uint32_t*>(stage);
    const int32_t first = (int32_t)cbuf[sh[0]];
    const int32_t last = (int32_t)cbuf[sh[0] + len - 1];

    const int base = tid * STRIP;
    const int cnt = len - base < 0 ? 0 : (len - base > STRIP ? STRIP : len - base);
    uint32_t kw[STRIP + 1];
    read_rows<STRIP + 1>(cbuf, sh[0], base, kw);
    int32_t k[STRIP + 1];
#pragma unroll
    for (int j = 0; j <= STRIP; ++j) k[j] = (int32_t)kw[j];
    float x[NVP][STRIP];
#pragma unroll
    for (int v = 0; v < NVP; ++v) {
      uint32_t xw[STRIP];
      read_rows<STRIP>(reinterpret_cast<const uint32_t*>(stage + (v + 1) * BUF_BYTES),
                       sh[v + 1], base, xw);
#pragma unroll
      for (int j = 0; j < STRIP; ++j) x[v][j] = j < cnt ? __uint_as_float(xw[j]) : 0.0f;
    }
    const int32_t k_before = tid > 0 ? (int32_t)cbuf[sh[0] + base - 1] : 0;

    Carry<NVP> mine;
    bool uniform = true;
#pragma unroll
    for (int v = 0; v < NVP; ++v) mine.v[v] = 0.0f;
#pragma unroll
    for (int j = 0; j < STRIP; ++j) {
      if (j < cnt) {
        if (j > 0 && k[j] != k[j - 1]) {
          uniform = false;
#pragma unroll
          for (int v = 0; v < NVP; ++v) mine.v[v] = 0.0f;
        }
#pragma unroll
        for (int v = 0; v < NVP; ++v) mine.v[v] += x[v][j];
      }
    }
    const bool cont = tid > 0 && cnt > 0 && k[0] == k_before;
    mine.flag = (cnt == 0 || !uniform || !cont) ? 1 : 0;
    Carry<NVP> inc = mine;
#pragma unroll
    for (int off = 1; off < WARP; off <<= 1) {
      Carry<NVP> o;
      o.flag = __shfl_up_sync(0xffffffffu, inc.flag, off);
#pragma unroll
      for (int v = 0; v < NVP; ++v) o.v[v] = __shfl_up_sync(0xffffffffu, inc.v[v], off);
      if (lane >= off) inc = combine(o, inc);
    }
    if (lane == WARP - 1) {
      warp_flag[warp] = inc.flag;
#pragma unroll
      for (int v = 0; v < NVP; ++v) warp_val[warp][v] = inc.v[v];
    }
    __syncthreads();
    // the warps' totals, scanned across lanes 0 .. WARPS - 1 by shuffles
    Carry<NVP> tw;
    tw.flag = lane < WARPS ? warp_flag[lane] : 0;
#pragma unroll
    for (int v = 0; v < NVP; ++v) tw.v[v] = lane < WARPS ? warp_val[lane][v] : 0.0f;
#pragma unroll
    for (int off = 1; off < WARPS; off <<= 1) {
      Carry<NVP> o;
      o.flag = __shfl_up_sync(0xffffffffu, tw.flag, off);
#pragma unroll
      for (int v = 0; v < NVP; ++v) o.v[v] = __shfl_up_sync(0xffffffffu, tw.v[v], off);
      if (lane >= off) tw = combine(o, tw);
    }
    Carry<NVP> pre;  // the warps before this one
    const int src = warp > 0 ? warp - 1 : 0;
    pre.flag = warp > 0 ? __shfl_sync(0xffffffffu, tw.flag, src) : 0;
#pragma unroll
    for (int v = 0; v < NVP; ++v) {
      const float t = __shfl_sync(0xffffffffu, tw.v[v], src);
      pre.v[v] = warp > 0 ? t : 0.0f;
    }
    Carry<NVP> up;
    up.flag = __shfl_up_sync(0xffffffffu, inc.flag, 1);
#pragma unroll
    for (int v = 0; v < NVP; ++v) up.v[v] = __shfl_up_sync(0xffffffffu, inc.v[v], 1);
    const Carry<NVP> excl = lane == 0 ? pre : combine(pre, up);
    float acc[NVP];
#pragma unroll
    for (int v = 0; v < NVP; ++v) acc[v] = cont ? excl.v[v] : 0.0f;
    if (tile == 0 && tid == 0) {
      const int64_t hi = first < num_groups ? first : num_groups;
      for (int64_t g = 0; g < hi; ++g) {
#pragma unroll
        for (int v = 0; v < NVP; ++v) out[(int64_t)(v0 + v) * num_groups + g] = 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < STRIP; ++j) {
      if (j < cnt) {
#pragma unroll
        for (int v = 0; v < NVP; ++v) acc[v] += x[v][j];
        const int32_t key = k[j];
        const bool tile_end = base + j == len - 1;
        if (tile_end || k[j + 1] != key) {
          if (key > first && key < last && k[j + 1] == key + 1) {
            // the common case: a run wholly inside the tile, no gap after it
            if (key >= 0 && key < num_groups) {
#pragma unroll
              for (int v = 0; v < NVP; ++v) {
                __stcs(out + (int64_t)(v0 + v) * num_groups + key, acc[v]);  // streaming store
              }
            }
#pragma unroll
            for (int v = 0; v < NVP; ++v) acc[v] = 0.0f;
            continue;
          }
          if (key == first || key == last) {
            float* piece = scratch + (tile * 2 + (key == first ? 0 : 1)) * nv + v0;
#pragma unroll
            for (int v = 0; v < NVP; ++v) piece[v] = acc[v];
          }
          const bool run_end = !tile_end || !has_next || next_code != key;
          if (run_end) {
            const bool crossed = key == first && has_prev && prev_code == first;
            if (!crossed && key >= 0 && key < num_groups) {
#pragma unroll
              for (int v = 0; v < NVP; ++v) out[(int64_t)(v0 + v) * num_groups + key] = acc[v];
            }
            // groups between this run and the next that no row holds
            const int64_t nk = tile_end ? (has_next ? (int64_t)next_code : num_groups)
                                        : (int64_t)k[j + 1];
            const int64_t lo = (int64_t)key + 1 > 0 ? (int64_t)key + 1 : 0;
            const int64_t hi = nk < num_groups ? nk : num_groups;
            for (int64_t g = lo; g < hi; ++g) {
#pragma unroll
              for (int v = 0; v < NVP; ++v) out[(int64_t)(v0 + v) * num_groups + g] = 0.0f;
            }
          }
#pragma unroll
          for (int v = 0; v < NVP; ++v) acc[v] = 0.0f;
        }
      }
    }
    if (rag) ring::fence_proxy_async();  // the plain stores before the next copies
    __syncthreads();  // the stage and the scan slots are free again
    if (tid == 0) {
      const int64_t refill = tile + (int64_t)STAGES * gridDim.x;
      if (refill < tiles) issue_tile(refill, st);
    }
  }
}

// the last code of a tile
__device__ __forceinline__ int32_t tile_last(const int32_t* codes, int64_t tile, int64_t n) {
  const int64_t r1 = (tile + 1) * TILE < n ? (tile + 1) * TILE : n;
  return __ldg(codes + r1 - 1);
}

// Pass 2: one warp per tile t. If a run crossed into t and ends in it, find
// the tile where it began and write the sum of its pieces, in tile order.
__global__ void __launch_bounds__(THREADS)
sorted_grouped_sum_fixup(const int32_t* __restrict__ codes,
                         const float* __restrict__ scratch, float* __restrict__ out,
                         int64_t n, int nv, int64_t num_groups, int64_t tiles) {
  const int lane = threadIdx.x & (WARP - 1);
  const int64_t t = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (t == 0 || t >= tiles) return;
  const int64_t r0 = t * TILE;
  const int32_t key = __ldg(codes + r0);
  if (__ldg(codes + r0 - 1) != key) return;  // no run crossed into t
  const int64_t r1 = r0 + TILE < n ? r0 + TILE : n;
  if (r1 < n && __ldg(codes + r1) == key) return;  // it goes on past t
  if (key < 0 || key >= num_groups) return;
  // the tile where the run began: t - 1, unless the run fills tile t - 1
  // (then the first tile whose last code is >= key, by a 32-way search)
  int64_t s0 = t - 1;
  if (__ldg(codes + (t - 1) * TILE) == key) {
    int64_t lo = 0, hi = t - 1;
    while (lo < hi) {
      const int64_t step = (hi - lo + WARP - 1) / WARP;
      const int64_t s = lo + lane * step;
      const bool p = s >= hi || tile_last(codes, s, n) >= key;
      const unsigned b = __ballot_sync(0xffffffffu, p);
      if (b == 0) {
        lo = lo + (WARP - 1) * step + 1;
      } else {
        const int j = __ffs(b) - 1;
        const int64_t nhi = lo + j * step;
        lo = j > 0 ? lo + (j - 1) * step + 1 : lo;
        hi = nhi < hi ? nhi : hi;
      }
    }
    s0 = lo;
  }
  // the run's piece in s0 is its first run when s0 holds nothing else
  const bool s0_head = __ldg(codes + s0 * TILE) == key;
  for (int v = 0; v < nv; ++v) {
    float sum = 0.0f;
    for (int64_t s = s0 + lane; s <= t; s += WARP) {
      const int slot = (s == s0 && !s0_head) ? 1 : 0;
      sum += scratch[(s * 2 + slot) * nv + v];
    }
#pragma unroll
    for (int off = WARP / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) out[(int64_t)v * num_groups + key] = sum;
  }
}

template <int NVP>
cudaError_t launch_tiles(const int32_t* codes, const float* values, float* out,
                         float* scratch, int64_t n, int nv, int v0, int64_t num_groups,
                         int64_t tiles, int sms, cudaStream_t stream) {
  const int stage_bytes = (1 + NVP) * BUF_BYTES;
  const int smem = STAGES * stage_bytes;
  cudaError_t err = cudaFuncSetAttribute(sorted_grouped_sum_tiles<NVP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sorted_grouped_sum_tiles<NVP>,
                                                      THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (per_sm > 2) per_sm = 2;
  const int64_t want = (int64_t)sms * per_sm;
  const unsigned int grid = (unsigned int)(tiles < want ? tiles : want);
  sorted_grouped_sum_tiles<NVP><<<grid, THREADS, smem, stream>>>(
      codes, values, out, scratch, n, nv, v0, num_groups, tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bt_sorted_grouped_sum_tile_rows() { return TILE; }

extern "C" int bt_sorted_grouped_sum_f32(const void* codes, const void* values, void* out,
                                         void* scratch, long long n, int nv,
                                         long long num_groups, long long tiles,
                                         void* stream) {
  if (n <= 0 || nv <= 0 || num_groups <= 0) return (int)cudaSuccess;
  if (tiles != (n + TILE - 1) / TILE) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t* c = (const int32_t*)codes;
  const float* v = (const float*)values;
  float* o = (float*)out;
  float* sc = (float*)scratch;
  for (int v0 = 0; v0 < nv; v0 += MAX_NVP) {
    const int nvp = nv - v0 < MAX_NVP ? nv - v0 : MAX_NVP;
    switch (nvp) {
      case 1: err = launch_tiles<1>(c, v, o, sc, n, nv, v0, num_groups, tiles, sms, s); break;
      case 2: err = launch_tiles<2>(c, v, o, sc, n, nv, v0, num_groups, tiles, sms, s); break;
      case 3: err = launch_tiles<3>(c, v, o, sc, n, nv, v0, num_groups, tiles, sms, s); break;
      default: err = launch_tiles<4>(c, v, o, sc, n, nv, v0, num_groups, tiles, sms, s); break;
    }
    if (err != cudaSuccess) return (int)err;
  }
  if (tiles > 1) {
    const unsigned int grid = (unsigned int)((tiles + WARPS - 1) / WARPS);
    sorted_grouped_sum_fixup<<<grid, THREADS, 0, s>>>(c, sc, o, n, nv, num_groups, tiles);
    err = cudaGetLastError();
  }
  return (int)err;
}
