// Shared inner loop of the two convolution kernels: a 256-thread block owns a
// 64 x 64 tile of outputs, and each thread accumulates a 4 x 4 sub-tile in
// float32 registers with CUDA-core FMAs (float32 means float32 here: no TF32).
//
// Thread (ty, tx) of the 16 x 16 grid owns rows ty + 16 i and columns
// tx + 16 j.  A warp covers two rows and sixteen consecutive columns, so a
// read of the A operand is a broadcast of two words and a read of the B
// operand touches sixteen consecutive banks: neither has bank conflicts.
#pragma once

#include <cuda_runtime.h>

namespace tile {

constexpr int kTile = 64;      // rows and columns of a block's output tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kSub = 16;       // thread grid edge

// acc[i][j] += sum_k a[k * a_stride + ty + 16 i] * b[k * kTile + tx + 16 j]
__device__ __forceinline__ void fma_tile(const float* a, int a_stride,
                                         const float* b, int depth, int ty,
                                         int tx, float acc[4][4]) {
#pragma unroll 4
  for (int k = 0; k < depth; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[k * a_stride + ty + kSub * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[k * kTile + tx + kSub * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

}  // namespace tile
