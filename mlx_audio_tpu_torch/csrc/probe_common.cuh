// Helpers shared by the depth-draft probes (probe_depth.cu, probe_vpu.cu,
// probe_auto.cu): exact sums of 16 loaded bytes and a block's int64 total.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace probe {

constexpr unsigned kFull = 0xffffffffu;

// sum of the sixteen int8 values of a 16-byte word (dp4a against ones)
__device__ __forceinline__ int sum16_s8(uint4 v) {
  int a = __dp4a((int)v.x, 0x01010101, 0);
  a = __dp4a((int)v.y, 0x01010101, a);
  a = __dp4a((int)v.z, 0x01010101, a);
  return __dp4a((int)v.w, 0x01010101, a);
}

__device__ __forceinline__ float bf16_pair_sum(uint32_t u) {
  return __uint_as_float(u << 16) + __uint_as_float(u & 0xffff0000u);
}

// sum of the eight bf16 values of a 16-byte word; the probes' values are
// integers below 128 in magnitude, so every partial sum here is exact
__device__ __forceinline__ float sum16_bf16(uint4 v) {
  return (bf16_pair_sum(v.x) + bf16_pair_sum(v.y)) +
         (bf16_pair_sum(v.z) + bf16_pair_sum(v.w));
}

// adds the block's values of v into *out (one atomic a block); every thread
// of the block must call it
__device__ __forceinline__ void block_add_i64(long long v, long long* out) {
  __shared__ long long part[32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = (blockDim.x + 31) / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? part[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    if (lane == 0)
      atomicAdd(reinterpret_cast<unsigned long long*>(out),
                (unsigned long long)v);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// a shared-memory load the compiler may neither drop nor hoist out of a loop
__device__ __forceinline__ uint32_t lds_u32(const void* p) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(smem_addr(p)));
  return v;
}

__device__ __forceinline__ uint4 lds_v4(const void* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(smem_addr(p)));
  return v;
}

}  // namespace probe
