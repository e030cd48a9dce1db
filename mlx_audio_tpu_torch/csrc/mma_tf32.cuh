// Helpers shared by the two 3xTF32 convolution kernels (banded_conv1d.cu,
// dilated_conv1d.cu): cp.async copies into shared memory, the TF32 split of
// a float32 value, ldmatrix, the m16n8k8 TF32 tensor-core product, a warp's
// 3xTF32 k8 step and the store of two outputs.
//
// Both kernels sum each tap's products in an accumulator of their own,
// zeroed a tap, and add it to the running sum in float32 (fold_into): the
// tensor core's float32 accumulation truncates, and one chain of all
// 3 C K / 8 products, biased by it, erred 2.5e-4 against float64 at
// C = 768, K = 7 (1.4e-4 at C = 512), failing atol = rtol = 1e-4; folded a
// tap, 5.8e-6 (3.9e-6), for 14-17% more time (scripts/tune_conv.py, H100
// 80GB HBM3 at 700 W).  Two build variants keep the comparison, neither of
// them the port's build:
//   -DCONV_ONE_CHAIN  one accumulator for every product;
//   -DCONV_ONE_PASS   drops the two small products: one TF32 pass.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

__device__ inline uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory; zeros when !valid (src-size 0)
__device__ inline void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v rounded to TF32, ties away from zero: the rounding of
// cvt.rna.tf32.f32 for every finite v, done with an integer add and mask,
// which issue faster on an H100 than the conversion instruction (NaN
// payloads below bit 13 may come out as inf)
__device__ inline uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// a = big + small, both TF32 (float32 with the low 13 bits zero)
__device__ inline void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

__device__ inline void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ inline void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k8 step of a warp's M x N tiles: acc += (as bb + ab bs) + ab bb, the
// small products first; M N independent tiles between two products into
// one accumulator
template <int M, int N>
__device__ inline void mma_3xtf32(float (&acc)[M][N][4],
                                  const uint32_t (&ab)[M][4],
                                  const uint32_t (&as)[M][4],
                                  const uint32_t (&bb)[N][2],
                                  const uint32_t (&bs)[N][2]) {
#ifndef CONV_ONE_PASS
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(acc[i][j], as[i], bb[j]);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(acc[i][j], ab[i], bs[j]);
#endif
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(acc[i][j], ab[i], bb[j]);
}

// out[0], out[1] = lo, hi
__device__ inline void store2(float* out, float lo, float hi) {
  *reinterpret_cast<float2*>(out) = make_float2(lo, hi);
}

// acc += part, in float32 (round to nearest)
template <int M, int N>
__device__ inline void fold_into(float (&acc)[M][N][4],
                                 const float (&part)[M][N][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
}
