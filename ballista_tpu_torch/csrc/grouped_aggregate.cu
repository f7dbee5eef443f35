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
// Design. A grid-stride loop walks the flat [n * A] value array, so
// neighbouring threads load neighbouring floats; each thread keeps its
// element's row and column incrementally (one division at the start) and
// loads U elements before it adds any, to keep loads in flight. The
// contention of few groups (q1 has 4) is the hazard: with one shared tile,
// every warp of a block would hammer the same G * A addresses. So each warp
// adds into its own private [G, A] tile in shared memory (a native shared
// f32 atomicAdd); lanes of one warp collide only when rows of one 32-value
// step share a group (at most 32 / A rows per step). When the private tiles
// do not fit the default 48 KB, warps share fewer tiles; a single tile above
// 48 KB opts in to the larger dynamic shared memory. At the end the block
// sums its tiles and atomicAdds the non-zero partials into out.
//
// Precision: sums accumulate in f32, in an order that varies from run to run
// (the per-block partials meet in global atomics).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int WARPS_PER_BLOCK = 8;
constexpr int THREADS = WARP * WARPS_PER_BLOCK;
constexpr int UNROLL = 4;
constexpr int BLOCKS_PER_SM = 4;
constexpr long long DEFAULT_SMEM = 48 * 1024;
constexpr long long MAX_SMEM = 232448;  // the opt-in limit of one block on sm_90

__global__ void __launch_bounds__(THREADS)
grouped_aggregate_kernel(const int32_t* __restrict__ codes,
                         const float* __restrict__ values,
                         const uint8_t* __restrict__ mask,
                         float* __restrict__ out, int64_t n, int A, int G,
                         int copies) {
  extern __shared__ float tiles[];  // [copies, G * A]
  const int tile = G * A;
  for (int i = threadIdx.x; i < copies * tile; i += blockDim.x) tiles[i] = 0.0f;
  __syncthreads();
  float* mine = tiles + ((threadIdx.x / WARP) % copies) * tile;

  const int64_t total = n * (int64_t)A;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t row_step = stride / A;
  const int col_step = (int)(stride - row_step * A);
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t row = e / A;
  int col = (int)(e - row * A);

  for (; e < total; e += UNROLL * stride) {
    int32_t g[UNROLL];
    uint8_t m[UNROLL];
    float v[UNROLL];
    int c[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t eu = e + u * stride;
      const bool in = eu < total;
      c[u] = col;
      g[u] = in ? __ldg(codes + row) : -1;
      m[u] = in ? __ldg(mask + row) : 0;
      v[u] = in ? __ldg(values + eu) : 0.0f;
      row += row_step;
      col += col_step;
      if (col >= A) {
        col -= A;
        ++row;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (m[u] && g[u] >= 0 && g[u] < G) atomicAdd(mine + g[u] * A + c[u], v[u]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < copies; ++k) s += tiles[k * tile + i];
    if (s != 0.0f) atomicAdd(out + i, s);  // NaN != 0: still added
  }
}

}  // namespace

extern "C" int bt_grouped_aggregate_f32(const void* codes, const void* values,
                                        const void* mask, void* out,
                                        long long n, int A, int G,
                                        void* stream) {
  if (n <= 0 || A <= 0 || G <= 0) return (int)cudaSuccess;
  const long long tile_bytes = (long long)G * A * (long long)sizeof(float);
  if (tile_bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  int copies = WARPS_PER_BLOCK;
  while (copies > 1 && copies * tile_bytes > DEFAULT_SMEM) copies >>= 1;
  const long long smem = copies * tile_bytes;
  if (smem > DEFAULT_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        grouped_aggregate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long total = n * (long long)A;
  const long long want = (total + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  const long long cap = (long long)sms * BLOCKS_PER_SM;
  const unsigned int blocks = (unsigned int)(want < cap ? want : cap);
  grouped_aggregate_kernel<<<blocks, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (const int32_t*)codes, (const float*)values, (const uint8_t*)mask,
      (float*)out, (int64_t)n, A, G, copies);
  return (int)cudaGetLastError();
}
