// Weight-only dequantize-matmul: the Hopper counterpart of quantized_matmul
// (mlx_audio_tpu/nn/pallas_ops.py, _quant_matmul_kernel and
// quantized_matmul).
//
// Computes y[b, o] = sum_i x[b, i] * (q[o, i] * scale[o, g] + bias[o, g]),
// g = i / group_size, from uint8 codes q [O, I], or from two 4-bit codes a
// byte [O, I/2] in the concat-half layout (low nibble = column j, high
// nibble = column j + I/2).  The dense weight is never written anywhere.
//
// What bounds it on this card: bytes.  A decode step multiplies a few rows
// of x by every weight once, about 2 B operations per code byte, far below
// the roughly 20 operations per byte at which the card's float32 rate and
// its 3.35 TB/s of device memory balance.  So the design streams the codes
// once, coalesced, and keeps everything else on chip:
//   * a block owns 16 output columns (8 warps x 2) and up to 8 rows of x;
//   * the rows' x is staged in shared memory 512 (or 128) columns at a time;
//   * each lane reads 4 consecutive code bytes per load (a warp reads 128
//     contiguous bytes of a weight row), dequantizes them in registers with
//     the group's scale and bias, and multiplies them into the 8 rows;
//   * a warp shuffle sums the lanes' partial dot products.
// Each output's sum runs in the same order whatever the number of rows, so a
// row's result does not depend on the rows batched with it.  The TPU kernel
// held all of x and a 128-column tile of codes in VMEM; here the row tile
// and the chunked x keep shared memory at 32 KB or less whatever I is.
// Later work: cp.async/TMA double buffering of the code stream, and
// tensor-core dequant GEMM for prefill-sized row counts.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kCols = 2;  // output columns per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kColsPerBlock = kWarps * kCols;

// VEC codes a load (4 when every row and group boundary is 4-aligned, else
// 1); TB rows of x a block; PACKED two 4-bit codes a byte.
template <int VEC, int TB, bool PACKED>
__global__ void __launch_bounds__(kThreads)
    qmm_kernel(const float* __restrict__ x, const uint8_t* __restrict__ codes,
               const float* __restrict__ scales,
               const float* __restrict__ biases, float* __restrict__ y,
               int rows, int in_f, int out_f, int gs) {
  constexpr int kChunk = 32 * VEC * 4;  // stored columns per chunk
  constexpr int kHalves = PACKED ? 2 : 1;
  __shared__ __align__(16) float xs[TB][kHalves][kChunk];
  const int stored = PACKED ? in_f / 2 : in_f;
  const int groups = in_f / gs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * TB;
  const int col0 = blockIdx.x * kColsPerBlock + warp * kCols;

  float acc[kCols][TB];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
#pragma unroll
    for (int t = 0; t < TB; ++t) acc[c][t] = 0.0f;

  for (int c0 = 0; c0 < stored; c0 += kChunk) {
    __syncthreads();  // the previous chunk's reads of xs are done
    for (int n = threadIdx.x; n < TB * kHalves * kChunk; n += kThreads) {
      const int t = n / (kHalves * kChunk);
      const int h = (n / kChunk) % kHalves;
      const int k = n % kChunk;
      const int row = row0 + t, col = c0 + k;
      xs[t][h][k] = (row < rows && col < stored)
                        ? x[(size_t)row * in_f + (size_t)h * stored + col]
                        : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = j * 32 * VEC + lane * VEC;  // chunk-local stored column
      const int p = c0 + k;
      if (p >= stored) break;
      // the VEC codes of a load share one group (and so do their high
      // nibbles' columns p + I/2 .. when packed)
      const int g = p / gs;
      const int g2 = PACKED ? (p + stored) / gs : 0;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int o = col0 + c;
        if (o >= out_f) break;
        const uint8_t* qrow = codes + (size_t)o * stored;
        uint32_t word;
        if (VEC == 4) {
          word = *reinterpret_cast<const uint32_t*>(qrow + p);
        } else {
          word = qrow[p];
        }
        const float s = scales[(size_t)o * groups + g];
        const float z = biases[(size_t)o * groups + g];
        float s2 = 0.0f, z2 = 0.0f;
        if (PACKED) {
          s2 = scales[(size_t)o * groups + g2];
          z2 = biases[(size_t)o * groups + g2];
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const uint32_t byte = (word >> (8 * e)) & 0xFFu;
          // q * scale + bias rounded as the plain version rounds it
          const float w = __fadd_rn(
              __fmul_rn((float)(PACKED ? (byte & 0xFu) : byte), s), z);
#pragma unroll
          for (int t = 0; t < TB; ++t) acc[c][t] = fmaf(w, xs[t][0][k + e], acc[c][t]);
          if (PACKED) {
            const float w2 = __fadd_rn(__fmul_rn((float)(byte >> 4), s2), z2);
#pragma unroll
            for (int t = 0; t < TB; ++t)
              acc[c][t] = fmaf(w2, xs[t][1][k + e], acc[c][t]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kCols; ++c) {
#pragma unroll
    for (int t = 0; t < TB; ++t) {
      float v = acc[c][t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      const int o = col0 + c, row = row0 + t;
      if (lane == 0 && o < out_f && row < rows) y[(size_t)row * out_f + o] = v;
    }
  }
}

template <int VEC, bool PACKED>
cudaError_t launch_rows(const float* x, const uint8_t* codes,
                        const float* scales, const float* biases, float* y,
                        int rows, int in_f, int out_f, int gs,
                        cudaStream_t stream) {
  const unsigned gx = (unsigned)((out_f + kColsPerBlock - 1) / kColsPerBlock);
  auto grid = [&](int tb) { return dim3(gx, (unsigned)((rows + tb - 1) / tb)); };
  if (rows == 1) {
    qmm_kernel<VEC, 1, PACKED><<<grid(1), kThreads, 0, stream>>>(
        x, codes, scales, biases, y, rows, in_f, out_f, gs);
  } else if (rows <= 2) {
    qmm_kernel<VEC, 2, PACKED><<<grid(2), kThreads, 0, stream>>>(
        x, codes, scales, biases, y, rows, in_f, out_f, gs);
  } else if (rows <= 4) {
    qmm_kernel<VEC, 4, PACKED><<<grid(4), kThreads, 0, stream>>>(
        x, codes, scales, biases, y, rows, in_f, out_f, gs);
  } else {
    qmm_kernel<VEC, 8, PACKED><<<grid(8), kThreads, 0, stream>>>(
        x, codes, scales, biases, y, rows, in_f, out_f, gs);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int quantized_matmul_forward(const float* x, const uint8_t* codes,
                                        const float* scales,
                                        const float* biases, float* y,
                                        int rows, int in_f, int out_f, int gs,
                                        int packed, void* stream) {
  if (rows < 1 || out_f < 1 || gs < 1 || in_f % gs != 0 ||
      (packed && in_f % 2 != 0) || (rows + 7) / 8 > 65535)
    return (int)cudaErrorInvalidValue;
  const int stored = packed ? in_f / 2 : in_f;
  const bool vec = stored % 4 == 0 && gs % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(codes) % 4 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (packed) {
    err = vec ? launch_rows<4, true>(x, codes, scales, biases, y, rows, in_f, out_f, gs, s)
              : launch_rows<1, true>(x, codes, scales, biases, y, rows, in_f, out_f, gs, s);
  } else {
    err = vec ? launch_rows<4, false>(x, codes, scales, biases, y, rows, in_f, out_f, gs, s)
              : launch_rows<1, false>(x, codes, scales, biases, y, rows, in_f, out_f, gs, s);
  }
  return (int)err;
}

extern "C" const char* quantized_matmul_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
