// sorted_grouped_sum: per-group sums over rows sorted by dense group rank.
//
//   out[v, g] = sum over rows i with codes[i] == g of values[v, i]
//
// codes: int32 [n], sorted ascending, dense ranks in [0, num_groups).
// values: float32 [nv, n], row-major, pre-masked by the caller (row 0 is the
// filter mask itself, so out[0] is the per-group count).
// out: float32 [nv, num_groups], zeroed by the caller.
//
// Replaces the Pallas TPU kernel ballista_tpu/ops/pallas_kernels.py::
// sorted_grouped_sum (_build_sorted.kernel). On the TPU that kernel reached
// the MXU with a one-hot [AV, B] @ [B, W] product per 1024-row block and a
// read-modify-write DMA of a 256-lane-padded output window, on a grid that
// runs in order. Here the function is computed directly as a segmented
// reduction over the sorted keys: no one-hot product, no lane window, no
// sublane padding, and no requirement that n be a multiple of 1024 (the
// ragged edge is masked in the kernel).
//
// Bound on an H100 SXM: memory. The work reads n * 4 bytes of codes and
// nv * n * 4 bytes of values once and writes nv * num_groups * 4 bytes, about
// 2 flops per value row element. At 3.35 TB/s, TPC-H q18's inner aggregate
// at SF 1 (n ~ 6.0M, nv = 2, G ~ 1.5M) is about 72 MB read + 12 MB written,
// about 25 us; q15's revenue view (G = 10,000) about 22 us.
//
// Design. Each warp owns a tile of WARP_TILE consecutive rows and walks it in
// chunks of 32 rows (one row per lane, coalesced loads). Inside a chunk an
// inclusive segmented shuffle scan on equal keys sums each run; the partial
// sum of the run still open at the chunk's end is carried in registers to
// the next chunk. A run that lies wholly inside the tile is owned by this
// warp alone (keys are sorted, so no other warp holds its rows) and is
// stored directly. Only the tile's first and last runs may continue into a
// neighbouring tile: those are added with atomicAdd. blockIdx.y selects the
// value row, so each warp reduces one value row of its tile.
//
// Precision: sums accumulate in f32. The atomics make the order in which a
// boundary run's pieces are added vary from run to run. Counts (row 0) are
// exact only while a group has at most 2^24 rows; the fused stage gates this
// route to stages of at most 2^24 rows (the JAX package's gate, kept).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int WARPS_PER_BLOCK = 8;
constexpr int CHUNKS_PER_TILE = 32;
constexpr int WARP_TILE = WARP * CHUNKS_PER_TILE;  // rows per warp

__global__ void sorted_grouped_sum_kernel(const int32_t* __restrict__ codes,
                                          const float* __restrict__ values,
                                          float* __restrict__ out,
                                          int64_t n, int64_t num_groups) {
  const int lane = threadIdx.x & (WARP - 1);
  const int64_t warp_id =
      (int64_t)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int64_t t0 = warp_id * WARP_TILE;
  if (t0 >= n) return;
  const int64_t t_end = (t0 + WARP_TILE < n) ? t0 + WARP_TILE : n;
  const float* vrow = values + (int64_t)blockIdx.y * n;
  float* orow = out + (int64_t)blockIdx.y * num_groups;

  const int32_t first_key = __ldg(codes + t0);
  const int32_t last_key = __ldg(codes + t_end - 1);

  float carry = 0.0f;       // partial sum of the run open at the chunk end
  int32_t carry_key = -1;   // its key (-1: no open run)

  for (int64_t c0 = t0; c0 < t_end; c0 += WARP) {
    const int64_t row = c0 + lane;
    const bool valid = row < t_end;
    // invalid lanes carry a key no valid row has, so no scan reaches them
    const int32_t k = valid ? __ldg(codes + row) : INT32_MIN;
    float x = valid ? __ldg(vrow + row) : 0.0f;

    // inclusive segmented scan: lanes of one run are contiguous because the
    // keys are sorted, so "key equal at lane - off" means the whole span is
    // the same run
#pragma unroll
    for (int off = 1; off < WARP; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, x, off);
      const int32_t ky = __shfl_up_sync(0xffffffffu, k, off);
      if (lane >= off && ky == k) x += y;
    }
    if (k == carry_key) x += carry;

    // does this lane's run end here? (next row in the tile has another key)
    int32_t k_next = __shfl_down_sync(0xffffffffu, k, 1);
    const int64_t nrow = row + 1;
    if (lane == WARP - 1) k_next = nrow < t_end ? __ldg(codes + nrow) : INT32_MIN;
    const bool run_end = valid && (nrow >= t_end || k_next != k);

    if (run_end && k >= 0 && (int64_t)k < num_groups) {
      if (k == first_key || k == last_key) {
        atomicAdd(orow + k, x);  // may share its group with a neighbour tile
      } else {
        orow[k] = x;  // run wholly inside this warp's tile
      }
    }

    // the run open at lane 31 continues into the next chunk
    const float x31 = __shfl_sync(0xffffffffu, x, WARP - 1);
    const int32_t k31 = __shfl_sync(0xffffffffu, k, WARP - 1);
    const bool end31 = __shfl_sync(0xffffffffu, (int)run_end, WARP - 1) != 0;
    if (end31) {
      carry = 0.0f;
      carry_key = -1;
    } else {
      carry = x31;
      carry_key = k31;
    }
  }
}

}  // namespace

extern "C" int bt_sorted_grouped_sum_f32(const void* codes, const void* values,
                                         void* out, long long n, int nv,
                                         long long num_groups, void* stream) {
  if (n <= 0 || nv <= 0) return (int)cudaSuccess;
  const int64_t warps = (n + WARP_TILE - 1) / WARP_TILE;
  const unsigned int blocks_x =
      (unsigned int)((warps + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
  const dim3 grid(blocks_x, (unsigned int)nv);
  const dim3 block(WARP * WARPS_PER_BLOCK);
  sorted_grouped_sum_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int32_t*)codes, (const float*)values, (float*)out, (int64_t)n,
      (int64_t)num_groups);
  return (int)cudaGetLastError();
}
