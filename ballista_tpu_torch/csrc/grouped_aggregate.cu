// grouped_aggregate: masked per-group sums for a small number of groups.
//
//   out[g, a] = sum over rows i with codes[i] == g and mask[i] of values[i, a]
//
// codes: int32 [n]; a row whose code lies outside [0, num_groups) adds
// nothing. values: float32 [n, A], row-major. mask: bool [n], one byte per
// row. out: float32 [num_groups, A], zeroed by the caller. num_groups <= 128
// (the reference's limit); any n, with no padding.
//
// Replaces the Pallas TPU kernel ballista_tpu/ops/pallas_kernels.py::
// grouped_aggregate (_build.kernel). On the TPU that kernel multiplied the
// values by the mask and reached the MXU with a one-hot [G, B] @ [B, A]
// product per 1024-row block, the output block resident in VMEM across a
// grid that runs in order. Here the function is computed directly as a
// scatter-reduce: no one-hot product, no block padding.
//
// Non-finite inputs: masked-out rows and rows with an out-of-range code are
// skipped, never multiplied by 0, so a NaN or inf in such a row reaches no
// group. In the TPU kernel a NaN in any row spread, through 0 * NaN in the
// one-hot product, to every group of its column.
//
// Bound on an H100 SXM: memory. The work reads n * (4 + 1 + 4A) bytes once
// and writes G * A * 4 bytes, one add per value. TPC-H q1's shape at SF 1
// (n ~ 6.0M, A = 8) is ~222 MB, ~66 us at 3.35 TB/s; the adds (48M) are
// far below the f32 rate.
//
// Design. The wrapper picks the mode (cuda_kernels.grouped_aggregate_geometry).
// Every row's code and mask byte are loaded once, and its A values as
// contiguous 16-byte runs where they allow it (q1's A = 7 makes 28-byte rows).
// - "registers" (G <= 8, A <= 8: q1's batches, the synthetic G = 4 case). A
//   persistent grid (up to 2 blocks per SM) walks tiles of R rows (R * A * 4 ~ 32
//   KB) through a ring of 3-8 shared-memory stages filled by cp.async.bulk
//   copies on an mbarrier (bulk_ring.cuh): a tile's codes, mask bytes and
//   values are three contiguous runs. Thread t takes rows t, t + 256, ... of
//   each tile and adds the row's A values to the [8, A] sums in registers
//   that its code selects by compares (templated on A and on 4 or 8 groups):
//   no atomics. At the end the sums of each warp meet by shuffles, the
//   block's by shared memory, and the block adds its G * A partials to out.
// - "warp tiles" (otherwise, e.g. G = 128): a grid-stride walk over rows,
//   one row per thread, 4 rows in flight, straight from device memory at
//   full occupancy (the ring's shared memory would cost the warps that hide
//   the latency of the adds below). Each warp owns a [G, A] tile in shared
//   memory. Lanes whose rows share a group find each other with
//   __match_any_sync and take turns (rank 0 first, __syncwarp between), so
//   in each turn the lanes that add hold distinct groups and a plain
//   read-modify-write of their A columns (16-byte when A % 4 == 0) is
//   race-free: no shared atomic is issued. On sm_90a a shared f32 atomicAdd
//   compiles to a compare-and-swap loop (ATOMS.CAST.SPIN, cuobjdump -sass),
//   which is what the previous design spent its adds on. When 8 tiles do
//   not fit the default 48 KB, warps share fewer tiles and add atomically.
//
// Precision: sums accumulate in f32, in an order that varies from run to run
// (the per-block partials meet in global atomics).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_ring.cuh"


namespace {

constexpr int WARP = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / WARP;
constexpr int REG_COLUMNS = 8;  // "registers": A <= 8, G <= 8
constexpr int MAX_STAGES = 8;
constexpr int MIN_STAGES = 3;
constexpr int BLOCK_BUDGET = 110 * 1024;  // shared bytes of one block's ring
constexpr int ROWS_UNROLL = 4;  // rows in flight per thread
constexpr int DEFAULT_SMEM = 48 * 1024;
constexpr int MAX_SMEM = 232448;  // the opt-in limit of one block on sm_90
constexpr int MODE_REGISTERS = 0, MODE_WARP_TILES = 1;

__host__ __device__ __forceinline__ int align16(int x) { return (x + 15) & ~15; }

// "registers": A_T columns (1..8) and GR groups (4 or 8) in registers
template <int A_T, int GR>
__global__ void __launch_bounds__(THREADS, 2)
grouped_aggregate_tiles(const int32_t* __restrict__ codes,
                        const float* __restrict__ values,
                        const uint8_t* __restrict__ mask, float* __restrict__ out,
                        int64_t n, int G, int R, int64_t tiles, int stages) {
  constexpr int A = A_T;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bars[MAX_STAGES];
  __shared__ float warp_part[WARPS * GR * A];
  const int tid = threadIdx.x;
  const int lane = tid & (WARP - 1);
  const int warp = tid >> 5;
  const int c_bytes = align16(R * 4 + 16);
  const int m_bytes = align16(R + 16);
  const int v_bytes = align16(R * A * 4 + 16);
  const int stage_bytes = c_bytes + m_bytes + v_bytes;

  auto seg = [&](int64_t tile, int a) {
    const int64_t r0 = tile * R;
    const int64_t r1 = r0 + R < n ? r0 + R : n;
    if (a == 0)
      return ring::plan(codes, codes + n, reinterpret_cast<uint64_t>(codes + r0),
                        reinterpret_cast<uint64_t>(codes + r1));
    if (a == 1)
      return ring::plan(mask, mask + n, reinterpret_cast<uint64_t>(mask + r0),
                        reinterpret_cast<uint64_t>(mask + r1));
    return ring::plan(values, values + n * A, reinterpret_cast<uint64_t>(values + r0 * A),
                      reinterpret_cast<uint64_t>(values + r1 * A));
  };
  auto buf = [&](int st, int a) {
    unsigned char* stage = smem + (size_t)st * stage_bytes;
    return a == 0 ? stage : (a == 1 ? stage + c_bytes : stage + c_bytes + m_bytes);
  };
  auto issue_tile = [&](int64_t tile, int st) {
    uint32_t bytes = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) bytes += ring::copy_bytes(seg(tile, a));
    ring::mbar_arrive_expect_tx(&bars[st], bytes);
#pragma unroll
    for (int a = 0; a < 3; ++a) ring::issue(seg(tile, a), buf(st, a), &bars[st]);
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) ring::mbar_init(&bars[s], 1);
    ring::fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      const int64_t tile = blockIdx.x + (int64_t)s * gridDim.x;
      if (tile < tiles) issue_tile(tile, s);
    }
  }

  float acc[GR][A];
#pragma unroll
  for (int g = 0; g < GR; ++g)
#pragma unroll
    for (int a = 0; a < A; ++a) acc[g][a] = 0.0f;

  for (int64_t it = 0;; ++it) {
    const int64_t tile = blockIdx.x + it * gridDim.x;
    if (tile >= tiles) break;
    const int st = (int)(it % stages);
    const int64_t r0 = tile * R;
    const int len = (int)(r0 + R < n ? R : n - r0);
    ring::mbar_wait(&bars[st], (uint32_t)((it / stages) & 1));
    bool rag = false;
#pragma unroll
    for (int a = 0; a < 3; ++a) rag |= ring::ragged(seg(tile, a));
    if (rag) {
#pragma unroll
      for (int a = 0; a < 3; ++a) ring::fill_ragged(seg(tile, a), buf(st, a), tid, THREADS);
      __syncthreads();
    }
    const ring::Seg gc = seg(tile, 0), gm = seg(tile, 1), gv = seg(tile, 2);
    const int32_t* cs = reinterpret_cast<const int32_t*>(buf(st, 0) + (gc.s - gc.W));
    const uint8_t* ms = buf(st, 1) + (gm.s - gm.W);
    const float* vs = reinterpret_cast<const float*>(buf(st, 2) + (gv.s - gv.W));
    // rows of 16-byte multiples that start on 16 bytes: 16-byte loads
    const bool vec = (A & 3) == 0 && (reinterpret_cast<uintptr_t>(vs) & 15) == 0;

    // one row per thread per step: its code and mask are read once
    for (int row = tid; row < len; row += THREADS) {
      const int32_t c = cs[row];
      if (ms[row] == 0 || c < 0 || c >= G) continue;
      const float* vr = vs + row * A;
      float v[A];
      if (vec) {
#pragma unroll
        for (int a = 0; a < A; a += 4) {
          const float4 q = *reinterpret_cast<const float4*>(vr + a);
          v[a] = q.x;
          if (a + 1 < A) v[a + 1] = q.y;
          if (a + 2 < A) v[a + 2] = q.z;
          if (a + 3 < A) v[a + 3] = q.w;
        }
      } else {
#pragma unroll
        for (int a = 0; a < A; ++a) v[a] = vr[a];
      }
#pragma unroll
      for (int g = 0; g < GR; ++g) {
        if (c == g) {
#pragma unroll
          for (int a = 0; a < A; ++a) acc[g][a] += v[a];
        }
      }
    }

    if (rag) ring::fence_proxy_async();  // the plain stores before the next copies
    __syncthreads();  // the stage is free again
    if (tid == 0) {
      const int64_t refill = tile + (int64_t)stages * gridDim.x;
      if (refill < tiles) issue_tile(refill, st);
    }
  }

  // the block's partials into out
#pragma unroll
  for (int g = 0; g < GR; ++g) {
#pragma unroll
    for (int a = 0; a < A; ++a) {
      float s = acc[g][a];
#pragma unroll
      for (int off = WARP / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) warp_part[(warp * GR + g) * A + a] = s;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * A; i += THREADS) {
    float s = 0.0f;
    for (int w = 0; w < WARPS; ++w) s += warp_part[w * GR * A + i];
    if (s != 0.0f) atomicAdd(out + i, s);  // NaN != 0: still added
  }
}

// "warp tiles": a grid-stride walk over rows, one row per thread, straight
// from device memory (its code, mask byte and A values; 16-byte loads when
// a row is a multiple of 16 bytes). Each warp owns a [G, A] tile (copies
// < 8: warps share tiles). The lanes of a step that hold one group find each
// other with __match_any_sync and take turns (rank 0 first), so in each
// turn the lanes that add hold distinct groups and a plain read-modify-write
// of their A columns is race-free. Shared tiles (copies < 8) use atomics.
// A_T = 0: A at run time.
template <int A_T>
__global__ void __launch_bounds__(THREADS)
grouped_aggregate_rows(const int32_t* __restrict__ codes, const float* __restrict__ values,
                       const uint8_t* __restrict__ mask, float* __restrict__ out, int64_t n,
                       int A_rt, int G, int copies) {
  constexpr int AV = A_T > 0 ? A_T : 1;
  const int A = A_T > 0 ? A_T : A_rt;
  extern __shared__ __align__(16) float tiles[];  // [copies][G][A]
  const int tsize = G * A;
  const int lane = threadIdx.x & (WARP - 1);
  for (int i = threadIdx.x; i < copies * tsize; i += THREADS) tiles[i] = 0.0f;
  __syncthreads();
  float* mine = tiles + ((threadIdx.x / WARP) % copies) * tsize;
  const bool own = copies == WARPS;  // the tile is this warp's alone
  const bool vec = A_T > 0 && A_T % 4 == 0 && (reinterpret_cast<uintptr_t>(values) & 15) == 0;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  // every lane of a warp runs the same steps (the warp votes below)
  const int64_t first = (int64_t)blockIdx.x * THREADS + (threadIdx.x - lane);
  for (int64_t r0 = first; r0 < n; r0 += ROWS_UNROLL * stride) {
    int32_t c[ROWS_UNROLL];
    float v[ROWS_UNROLL][AV];
#pragma unroll
    for (int u = 0; u < ROWS_UNROLL; ++u) {
      const int64_t row = r0 + lane + u * stride;
      const bool in = row < n;
      const int32_t cu = in ? __ldg(codes + row) : -1;
      c[u] = in && __ldg(mask + row) != 0 && cu >= 0 && cu < G ? cu : -1;
      if (A_T > 0) {
        const float* vr = values + row * A_T;
        if (vec) {
#pragma unroll
          for (int a = 0; a < AV; a += 4) {
            const float4 q = in ? __ldg(reinterpret_cast<const float4*>(vr + a))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
            v[u][a] = q.x;
            if (a + 1 < AV) v[u][a + 1] = q.y;
            if (a + 2 < AV) v[u][a + 2] = q.z;
            if (a + 3 < AV) v[u][a + 3] = q.w;
          }
        } else {
#pragma unroll
          for (int a = 0; a < AV; ++a) v[u][a] = in ? __ldg(vr + a) : 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < ROWS_UNROLL; ++u) {
      const float* vr = values + (r0 + lane + u * stride) * A;
      if (!own) {
        if (c[u] >= 0) {
          if (A_T > 0) {
#pragma unroll
            for (int a = 0; a < AV; ++a) atomicAdd(mine + c[u] * A + a, v[u][a]);
          } else {
            for (int a = 0; a < A; ++a) atomicAdd(mine + c[u] * A + a, __ldg(vr + a));
          }
        }
        continue;
      }
      const unsigned peers = __match_any_sync(0xffffffffu, c[u]);
      const unsigned rank = __popc(peers & ((1u << lane) - 1));
      const unsigned turns = __reduce_max_sync(0xffffffffu, c[u] >= 0 ? rank + 1 : 0u);
      for (unsigned t = 0; t < turns; ++t) {
        if (c[u] >= 0 && rank == t) {
          float* dst = mine + c[u] * A;
          if (A_T > 0 && A_T % 4 == 0) {
#pragma unroll
            for (int a = 0; a < AV; a += 4) {
              float4 t = *reinterpret_cast<float4*>(dst + a);
              t.x += v[u][a];
              t.y += v[u][a + 1 < AV ? a + 1 : a];
              t.z += v[u][a + 2 < AV ? a + 2 : a];
              t.w += v[u][a + 3 < AV ? a + 3 : a];
              *reinterpret_cast<float4*>(dst + a) = t;
            }
          } else if (A_T > 0) {
#pragma unroll
            for (int a = 0; a < AV; ++a) dst[a] += v[u][a];
          } else {
            for (int a = 0; a < A; ++a) dst[a] += __ldg(vr + a);
          }
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tsize; i += THREADS) {
    float s = 0.0f;
    for (int k = 0; k < copies; ++k) s += tiles[k * tsize + i];
    if (s != 0.0f) atomicAdd(out + i, s);  // NaN != 0: still added
  }
}

template <int A_T, int GR>
cudaError_t launch_registers(const int32_t* codes, const float* values, const uint8_t* mask,
                             float* out, int64_t n, int G, int R, int64_t tiles, int sms,
                             cudaStream_t stream) {
  auto kernel = grouped_aggregate_tiles<A_T, GR>;
  const int stage_bytes = align16(R * 4 + 16) + align16(R + 16) + align16(R * A_T * 4 + 16);
  int stages = BLOCK_BUDGET / stage_bytes;
  stages = stages < MIN_STAGES ? MIN_STAGES : (stages > MAX_STAGES ? MAX_STAGES : stages);
  const int smem = stages * stage_bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (per_sm > 2) per_sm = 2;
  const int64_t want = (int64_t)sms * per_sm;
  const unsigned int grid = (unsigned int)(tiles < want ? tiles : want);
  kernel<<<grid, THREADS, smem, stream>>>(codes, values, mask, out, n, G, R, tiles, stages);
  return cudaGetLastError();
}

template <int GR>
cudaError_t registers_for(int A, const int32_t* c, const float* v, const uint8_t* m,
                          float* o, int64_t n, int G, int R, int64_t tiles, int sms,
                          cudaStream_t s) {
  switch (A) {
#define BT_CASE(AT) \
  case AT: return launch_registers<AT, GR>(c, v, m, o, n, G, R, tiles, sms, s);
    BT_CASE(1) BT_CASE(2) BT_CASE(3) BT_CASE(4) BT_CASE(5) BT_CASE(6) BT_CASE(7) BT_CASE(8)
#undef BT_CASE
    default: return cudaErrorInvalidValue;
  }
}

template <int A_T>
cudaError_t launch_rows(const int32_t* codes, const float* values, const uint8_t* mask,
                        float* out, int64_t n, int A, int G, int sms, cudaStream_t stream) {
  auto kernel = grouped_aggregate_rows<A_T>;
  const int tile_bytes = G * A * 4;
  if (tile_bytes > MAX_SMEM) return cudaErrorInvalidValue;
  int copies = WARPS;
  while (copies > 1 && copies * tile_bytes > DEFAULT_SMEM) copies >>= 1;
  const int smem = copies * tile_bytes;
  if (smem > DEFAULT_SMEM) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t want = (n + THREADS - 1) / THREADS;
  const int64_t cap = (int64_t)sms * per_sm;
  const unsigned int grid = (unsigned int)(want < cap ? want : cap);
  kernel<<<grid, THREADS, smem, stream>>>(codes, values, mask, out, n, A, G, copies);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bt_grouped_aggregate_f32(const void* codes, const void* values,
                                        const void* mask, void* out, long long n, int A,
                                        int G, int mode, int tile_rows, long long tiles,
                                        void* stream) {
  if (n <= 0 || A <= 0 || G <= 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t* c = (const int32_t*)codes;
  const float* v = (const float*)values;
  const uint8_t* m = (const uint8_t*)mask;
  float* o = (float*)out;
  if (mode == MODE_REGISTERS) {
    if (A > REG_COLUMNS || G > 8) return (int)cudaErrorInvalidValue;
    if (tile_rows <= 0 || tiles != (n + tile_rows - 1) / tile_rows)
      return (int)cudaErrorInvalidValue;
    err = G <= 4 ? registers_for<4>(A, c, v, m, o, n, G, tile_rows, tiles, sms, s)
                 : registers_for<8>(A, c, v, m, o, n, G, tile_rows, tiles, sms, s);
  } else if (mode == MODE_WARP_TILES) {
    switch (A) {
#define BT_CASE(AT) \
  case AT: err = launch_rows<AT>(c, v, m, o, n, A, G, sms, s); break;
      BT_CASE(1) BT_CASE(2) BT_CASE(3) BT_CASE(4) BT_CASE(5) BT_CASE(6) BT_CASE(7) BT_CASE(8)
#undef BT_CASE
      default: err = launch_rows<0>(c, v, m, o, n, A, G, sms, s); break;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
