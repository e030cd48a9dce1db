// Shared-memory rings filled by asynchronous copies that complete on
// mbarriers (Hopper): the helpers that depth_draft.cu and probe_depth.cu
// share.  A stage's "full" barrier completes when its expected bytes have
// landed (cp.async.bulk with complete_tx) and its expected arrivals have
// come; an "empty" barrier completes when the stage's readers have arrived.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace bulk {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// `count` arrivals complete a phase; call from one thread, then make the
// initialisation visible (fence_init) before any thread uses the barrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also adds `bytes` to the phase's expected transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(smem_u32(bar))
      : "memory");
}

// true once the phase of the given parity (0 for the first use of the
// barrier, then 1, 0, ...) has completed; may suspend the thread a while
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing as transactions on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// one 4-byte asynchronous copy from global to shared memory (no alignment
// beyond 4 bytes); cp_async_arrive makes the thread's copies so far count
// as one arrival on bar when they have landed
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

}  // namespace bulk
