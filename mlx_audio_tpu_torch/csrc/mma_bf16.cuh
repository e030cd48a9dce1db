// Helpers of the bf16 variants of the two convolution kernels
// (banded_conv1d.cu, dilated_conv1d.cu): 16-byte cp.async copies of bf16
// rows, the transposing ldmatrix that gives an m16n8k16 B fragment from a
// [k][n] row-major tile, the m16n8k16 bf16 tensor-core product with float32
// accumulators, and the store of two outputs rounded to bf16.
//
// A bf16 product is exact in float32, so a bf16 operand needs no split: one
// product a k16 step where the float32 kernels take three a k8 step
// (mma_tf32.cuh).  The accumulators are float32 and each tap's products are
// folded into the running sum as in the float32 kernels (-DCONV_ONE_CHAIN
// drops the fold for both); the output is rounded to bf16 once, to nearest
// even.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

typedef __nv_bfloat16 bf16;

// 16 bytes (8 values) from global to shared memory; zeros when !valid
__device__ inline void cp_async16(bf16* dst, const bf16* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// four 8x8 b16 matrices, each transposed on the way: lane i receives rows
// 2 (i % 4) and 2 (i % 4) + 1 of column i / 4 of each, which is the
// m16n8k16 B fragment of a tile stored [k][n]
__device__ inline void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k16 step of a warp's M x N tiles
template <int M, int N>
__device__ inline void mma_bf16_tiles(float (&acc)[M][N][4],
                                      const uint32_t (&a)[M][4],
                                      const uint32_t (&b)[N][2]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) mma_bf16(acc[i][j], a[i], b[j]);
}

// B fragments of N n8 tiles (N even) for one k16 step: ldmatrix.trans of
// the [16][8 N] slice at base, whose lane address is row
// lane % 8 + 8 ((lane / 8) % 2) and column 8 (lane / 16) of the slice
template <int N>
__device__ inline void load_b_frags(uint32_t (&b)[N][2], uint32_t base) {
#pragma unroll
  for (int j = 0; j < N; j += 2) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, base + sizeof(bf16) * 8 * j);
    b[j][0] = r[0];
    b[j][1] = r[1];
    b[j + 1][0] = r[2];
    b[j + 1][1] = r[3];
  }
}

// out[0], out[1] = lo, hi, each rounded to bf16 (nearest even)
__device__ inline void store2(bf16* out, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(lo, hi);
}

__device__ inline void store2(float* out, float lo, float hi) {
  *reinterpret_cast<float2*>(out) = make_float2(lo, hi);
}
