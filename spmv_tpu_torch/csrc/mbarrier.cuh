// Shared-memory mbarriers and bulk asynchronous copies (Hopper, sm_90a),
// shared by bsr_spmm_tc.cu (TMA tensor loads), wellcw_spmv.cu (1-D bulk
// copies of the WELL-CW chunk stream and x window, L2 prefetches) and
// dia_spmm.cu (K2's slabs of X and of the diagonals).
//
// A producer thread arms a stage's "full" barrier with the bytes it
// expects (mbar_expect_tx), issues the copies, and the copies complete
// the transaction count; consumers wait on the phase's parity and free
// the stage on its "empty" barrier.  Every wait traps after 2^34 clocks
// (seconds; a healthy wait takes microseconds), so a lost transfer fails
// the launch instead of hanging the card.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace spmv_tpu_torch {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible to the async proxy (the bulk
// copies) and to the rest of the cluster.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(
          smem_addr(bar))
      : "memory");
}

// Spin until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  const long long start = clock64();
  uint32_t done = 0;
  for (;;) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 34)) __trap();
  }
}

__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_evict_normal() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

// One contiguous 1-D bulk copy of `bytes` (a multiple of 16; both
// addresses 16-byte aligned) from device memory into this CTA's shared
// memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// Ask the L2 to fetch `bytes` (a multiple of 16; `src` 16-byte aligned)
// of device memory ahead of the loads that will read them.
__device__ __forceinline__ void bulk_prefetch_l2(const void* src,
                                                 uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(src),
               "r"(bytes)
               : "memory");
}

}  // namespace spmv_tpu_torch
