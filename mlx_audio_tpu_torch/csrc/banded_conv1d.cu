// Dense ('same', dilation 1) conv1d through the banded formulation: the
// Hopper counterpart of banded_conv1d_pallas (mlx_audio_tpu/nn/pallas_ops.py,
// _banded_conv_kernel, _banded_weight and banded_conv1d_pallas).
//
// View x [B, L, C] as rows of 8 samples, [L/8, 8C].  Output group g (samples
// 8g .. 8g+7) needs the window of 8Q samples that starts at 8g - pad, and the
// whole K-tap conv of the group is one product with the banded weight
//   out[b, g, :] (8 Cout) = window(g) (8Q C) @ W_band [8Q C, 8 Cout],
//   W_band[(j + tap) C + c, j Cout + o] = w[tap, c, o],   Q = 1 + ceil((K-1)/8)
// (W_band is built in PyTorch by nn/kernels.banded_weight, once per call).
// So the conv is a GEMM with M = B L/8 rows, N = 8 Cout, depth 8Q C, whose
// A operand is x itself: row g of A is the contiguous stretch of x that
// starts at sample 8g - pad, and rows overlap.
//
// What bounds it on this card: operations.  The band multiplies zeros too,
// 8Q/K times the dense conv's FMAs (16/7 for K = 7, 24/11 for K = 11), and
// the product stays far above the ~20 operations per byte where the float32
// FMA rate and the memory rate meet.  The TPU chose the form because it
// turns K misaligned row shifts into aligned matmuls; on Hopper it is one
// plain GEMM, kept here as the port of the TPU kernel and as the base for a
// tensor-core version, which may skip the zero blocks of the band.
//
// Design.  A 256-thread block computes a 64-group x 64-column tile of the
// output view and walks the depth in slices of 32, staging a [64, 32] slice
// of A and a [32, 64] slice of W_band in 16.5 KB of shared memory whatever
// K, C and Cout are (the TPU gate's 10 MiB VMEM budget for W_band has no
// counterpart: W_band stays in device memory).  The 'same' padding and the
// ragged tail are masked in the kernel: A reads zero outside [0, L), and
// outputs past sample L are not stored.
#include <cuda_runtime.h>

#include "tile_fma.cuh"

namespace {

constexpr int kDepth = 32;  // depth of one shared-memory slice

__global__ void __launch_bounds__(tile::kThreads)
    banded_conv1d_kernel(const float* __restrict__ x,
                         const float* __restrict__ wb, float* __restrict__ out,
                         int L, int C, int Cout, int Q, int pad) {
  __shared__ float as[kDepth][tile::kTile + 1];  // A slice, depth-major
  __shared__ float bs[kDepth][tile::kTile];      // W_band slice

  const int g0 = blockIdx.x * tile::kTile;
  const int n0 = blockIdx.y * tile::kTile;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % tile::kSub;
  const int ty = tid / tile::kSub;
  const long long lc = (long long)L * C;
  const int n_cols = 8 * Cout;
  const int depth = 8 * Q * C;
  const float* xb = x + (size_t)b * lc;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < depth; k0 += kDepth) {
    for (int e = tid; e < tile::kTile * kDepth; e += tile::kThreads) {
      const int kk = e % kDepth;
      const int gi = e / kDepth;
      const int k = k0 + kk;
      // flat index into x[b]: sample 8g - pad + k / C, channel k % C
      const long long idx = (8LL * (g0 + gi) - pad) * C + k;
      float v = 0.0f;
      if (k < depth && idx >= 0 && idx < lc) v = xb[idx];
      as[kk][gi] = v;
    }
    for (int e = tid; e < kDepth * tile::kTile; e += tile::kThreads) {
      const int n = e % tile::kTile;
      const int kk = e / tile::kTile;
      const int k = k0 + kk;
      const int col = n0 + n;
      float v = 0.0f;
      if (k < depth && col < n_cols) v = wb[(size_t)k * n_cols + col];
      bs[kk][n] = v;
    }
    __syncthreads();
    tile::fma_tile(&as[0][0], tile::kTile + 1, &bs[0][0], kDepth, ty, tx, acc);
    __syncthreads();
  }

  // output view [L/8, 8 Cout] is x's flat layout: element (g, n) is
  // out[b] + 8 g Cout + n, sample 8g + n / Cout
  const long long l_cout = (long long)L * Cout;
  float* ob = out + (size_t)b * l_cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = 8LL * (g0 + ty + tile::kSub * i) * Cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + tile::kSub * j;
      if (n < n_cols && row + n < l_cout) ob[row + n] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int banded_conv1d_forward(const float* x, const float* wb,
                                     float* out, int B, int L, int C,
                                     int Cout, int K, void* stream) {
  const int span = K - 1;
  const int q_groups = 1 + (span + 7) / 8;
  const int groups = (L + 7) / 8;
  const dim3 grid((groups + tile::kTile - 1) / tile::kTile,
                  (8 * Cout + tile::kTile - 1) / tile::kTile, B);
  banded_conv1d_kernel<<<grid, tile::kThreads, 0, (cudaStream_t)stream>>>(
      x, wb, out, L, C, Cout, q_groups, span / 2);
  return (int)cudaGetLastError();
}

extern "C" const char* banded_conv1d_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
