// 'Same'-padded dilated conv1d, channels last: the Hopper counterpart of
// dilated_conv1d_pallas (mlx_audio_tpu/nn/pallas_ops.py,
// _dilated_conv_kernel and dilated_conv1d_pallas).
//
//   out[b, l, o] = sum_k sum_c x[b, l + k d - pad, c] * w[k, c, o],
//   pad = (K - 1) d / 2, x read as zero outside [0, L).
//
// x [B, L, C], w [K, C, Cout], out [B, L, Cout], all float32 and contiguous.
//
// What bounds it on this card: operations.  At the Kokoro-82M resblock
// shapes (C = Cout = 128 or 256, K = 3) each input row feeds K Cout products
// per channel, far above the ~20 operations per byte where the card's
// float32 rate and its memory rate meet, so the float32 FMA rate is the
// limit, and the work is to keep the FMA units fed from shared memory.
//
// Design.  The TPU kernel copied a halo window of tile_l + (K-1) d rows per
// tile (rounded up to 8 rows, with a pad of the tail on the host) and ran K
// shifted [tile_l, C] x [C, Cout] matmuls against weights resident in VMEM.
// Here a block owns 64 output rows and 64 output channels.  For each slice
// of 16 input channels it stages the halo window, 64 + (K-1) d rows, and the
// K matching [16, 64] weight slices in shared memory, then every tap reads
// its shifted view of the same window: x is read from device memory once per
// block and channel slice, not once per tap.  The ragged edges (rows outside
// [0, L), channels past C or Cout) are masked in the kernel: no rounding of
// the window and no padded copy of x.  Shared memory is
// 4 (16 (64 + (K-1) d + 1) + 16 K 64) bytes, 17 KB for K = 3, d = 5.
// wgmma and TMA (implicit GEMM on the tensor cores) are later work.
#include <cuda_runtime.h>

#include "tile_fma.cuh"

namespace {

constexpr int kChannels = 16;  // input channels staged per pass

__host__ __device__ inline int window_stride(int K, int dilation) {
  const int window = tile::kTile + (K - 1) * dilation;
  return window | 1;  // odd, so the transposed stores spread over the banks
}

__global__ void __launch_bounds__(tile::kThreads)
    dilated_conv1d_kernel(const float* __restrict__ x,
                          const float* __restrict__ w, float* __restrict__ out,
                          int L, int C, int Cout, int K, int dilation) {
  extern __shared__ float smem[];
  const int span = (K - 1) * dilation;
  const int pad = span / 2;
  const int window = tile::kTile + span;
  const int stride = window_stride(K, dilation);
  float* xs = smem;                         // [kChannels][stride]
  float* ws = smem + kChannels * stride;    // [K][kChannels][kTile]

  const int l0 = blockIdx.x * tile::kTile;
  const int o0 = blockIdx.y * tile::kTile;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % tile::kSub;
  const int ty = tid / tile::kSub;
  const float* xb = x + (size_t)b * L * C;

  float acc[4][4] = {};
  for (int c0 = 0; c0 < C; c0 += kChannels) {
    for (int e = tid; e < window * kChannels; e += tile::kThreads) {
      const int i = e / kChannels;
      const int c = e % kChannels;
      const int l = l0 - pad + i;
      const int cc = c0 + c;
      float v = 0.0f;
      if (l >= 0 && l < L && cc < C) v = xb[(size_t)l * C + cc];
      xs[c * stride + i] = v;
    }
    for (int e = tid; e < K * kChannels * tile::kTile; e += tile::kThreads) {
      const int o = e % tile::kTile;
      const int c = (e / tile::kTile) % kChannels;
      const int k = e / (tile::kTile * kChannels);
      const int cc = c0 + c;
      const int oo = o0 + o;
      float v = 0.0f;
      if (cc < C && oo < Cout) v = w[((size_t)k * C + cc) * Cout + oo];
      ws[(k * kChannels + c) * tile::kTile + o] = v;
    }
    __syncthreads();
    for (int k = 0; k < K; ++k)
      tile::fma_tile(xs + k * dilation, stride,
                     ws + k * kChannels * tile::kTile, kChannels, ty, tx, acc);
    __syncthreads();
  }

  float* ob = out + (size_t)b * L * Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = l0 + ty + tile::kSub * i;
    if (l >= L) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx + tile::kSub * j;
      if (o < Cout) ob[(size_t)l * Cout + o] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int dilated_conv1d_smem_bytes(int K, int dilation) {
  return (int)(sizeof(float) * (kChannels * window_stride(K, dilation) +
                                K * kChannels * tile::kTile));
}

extern "C" int dilated_conv1d_forward(const float* x, const float* w,
                                      float* out, int B, int L, int C,
                                      int Cout, int K, int dilation,
                                      void* stream) {
  const int smem = dilated_conv1d_smem_bytes(K, dilation);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dilated_conv1d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((L + tile::kTile - 1) / tile::kTile,
                  (Cout + tile::kTile - 1) / tile::kTile, B);
  dilated_conv1d_kernel<<<grid, tile::kThreads, smem, (cudaStream_t)stream>>>(
      x, w, out, L, C, Cout, K, dilation);
  return (int)cudaGetLastError();
}

extern "C" const char* dilated_conv1d_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
