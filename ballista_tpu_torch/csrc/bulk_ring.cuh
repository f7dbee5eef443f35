// bulk_ring.cuh: a ring of shared-memory stages filled by one-dimensional
// bulk copies (cp.async.bulk, Hopper's TMA without a tensor map) that
// complete on an mbarrier, for kernels that stream contiguous arrays.
//
// A bulk copy needs 16-byte-aligned global and shared addresses and a size
// that is a multiple of 16. A segment [s, e) of an array (a tile's rows) is
// copied as the 16-byte-aligned window around it, [W, E) with
// W = s & ~15, E = (e + 15) & ~15, into a stage buffer that starts at W: the
// byte at global address x lands at buffer offset x - W, so the rows keep
// their phase modulo 16 and no row is split. The window may reach a few
// bytes into the neighbouring rows; it is clipped to the aligned interior of
// the whole array [align_up(begin), align_down(end)), so no byte outside the
// array is read. The bytes of the segment that the clip leaves out (at most
// 15 at the array's start and 15 at its end, or the whole of a segment too
// small to hold an aligned 16 bytes) are loaded by the block's threads with
// plain loads (fill_ragged) before anyone reads the stage.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ring {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// make the barriers' initialisation visible to the async proxy
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// order this thread's earlier shared-memory accesses (generic proxy) before
// the bulk copies it issues next (async proxy) into the same stage
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "RING_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra RING_DONE;\n"
      "bra RING_WAIT;\n"
      "RING_DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// the copy marks its lines evict-first in L2: the arrays stream through once,
// and the kernel's outputs should not be the lines that make room for them
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// One segment [s, e) (global byte addresses) of an array [begin, end): the
// window base W and the clipped copy range [lo, hi) (lo == hi: no copy).
struct Seg {
  uint64_t s, e, W, lo, hi;
};

__host__ __device__ __forceinline__ Seg plan(const void* begin, const void* end,
                                             uint64_t s, uint64_t e) {
  Seg g;
  g.s = s;
  g.e = e;
  g.W = s & ~uint64_t(15);
  const uint64_t E = (e + 15) & ~uint64_t(15);
  const uint64_t cl = (reinterpret_cast<uint64_t>(begin) + 15) & ~uint64_t(15);
  const uint64_t ch = reinterpret_cast<uint64_t>(end) & ~uint64_t(15);
  g.lo = g.W > cl ? g.W : cl;
  g.hi = E < ch ? E : ch;
  if (g.hi <= g.lo) g.lo = g.hi = g.W;
  return g;
}

// bytes the segment's copy moves (0 when nothing is copied)
__device__ __forceinline__ uint32_t copy_bytes(const Seg& g) {
  return static_cast<uint32_t>(g.hi - g.lo);
}

// one thread: issue the segment's copy into buf (the window base W maps to
// buf[0]); the barrier must already expect the bytes
__device__ __forceinline__ void issue(const Seg& g, unsigned char* buf, uint64_t* bar) {
  if (g.hi > g.lo)
    bulk_g2s(buf + (g.lo - g.W), reinterpret_cast<const void*>(g.lo),
             static_cast<uint32_t>(g.hi - g.lo), bar);
}

// does any byte of the segment lie outside its copy?
__device__ __forceinline__ bool ragged(const Seg& g) {
  return g.s < g.e && (g.s < g.lo || g.e > g.hi);
}

// all threads of the block: plain-load the segment's bytes that the copy
// left out into buf (the caller synchronises the block afterwards)
__device__ __forceinline__ void fill_ragged(const Seg& g, unsigned char* buf, int tid,
                                            int nthreads) {
  const uint64_t h_end = g.lo < g.e ? g.lo : g.e;  // head: [s, min(lo, e))
  for (uint64_t x = g.s + tid; x < h_end; x += nthreads)
    buf[x - g.W] = __ldg(reinterpret_cast<const unsigned char*>(x));
  const uint64_t t_beg = g.hi > g.s ? g.hi : g.s;  // tail: [max(hi, s), e)
  for (uint64_t x = (t_beg > h_end ? t_beg : h_end) + tid; x < g.e; x += nthreads)
    buf[x - g.W] = __ldg(reinterpret_cast<const unsigned char*>(x));
}

}  // namespace ring
