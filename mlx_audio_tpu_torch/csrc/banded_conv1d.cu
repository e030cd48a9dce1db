// Dense ('same', dilation 1) conv1d, channels last, on the tensor cores: the
// Hopper counterpart of banded_conv1d_pallas (mlx_audio_tpu/nn/pallas_ops.py
// :321-401, _banded_conv_kernel, _banded_weight and banded_conv1d_pallas).
//
//   out[b, l, o] = sum_tap sum_c x[b, l + tap - pad, c] * w[tap, c, o],
//   pad = (K - 1) / 2, x read as zero outside [0, L).
//
// x [B, L, C], w [K, C, Cout], out [B, L, Cout], all float32, contiguous; C a multiple of 8, Cout a multiple of 8, x and w 16-byte
// aligned.
//
// Why no band.  The TPU kernel turned the K misaligned row shifts into one
// aligned matmul per 8-row group against a banded weight W_band
// [8Q C, 8 Cout], Q = 1 + ceil((K-1)/8), and so multiplied 8Q/K times the
// conv's products (24/11 at K = 11), most of them zeros.  Here a shift by one
// row is free: mma.sync fragments address shared-memory rows freely, so every
// tap reads the same staged window at a row offset of tap, and the weight is
// read in its natural [K, C, Cout] layout.  The band is never formed.
//
// What bounds it on this card: operations.  The port runs float32, and one
// TF32 pass keeps 10 mantissa bits, too few for the 1e-4 the port holds its
// kernels to at a reduction depth of K C = 1408.  So each operand is split,
// a = big + small with big = tf32_rna(a) and small = tf32_rna(a - big), and
// each multiply-add takes three TF32 products (small big, big small,
// big big) summed in float32, which keeps the error well inside 1e-4 where
// one pass lands several 1e-4 off: 3 TF32 products a multiply-add at
// 495 TFLOP/s dense, a bound of 0.68 ms at
// [2, 156001, 128] K = 11, against 1.68 ms for float32 FMAs.
//
// Design: an implicit GEMM with M = B L output rows, N = Cout, depth K C.
// A 384-thread block owns one batch row, 192 samples and 128 output
// channels; its 12 warps each own 64 x 32 of them as 4 x 4 m16n8k8 tiles
// (mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, accumulators in
// registers; each tap's products in their own, folded into the running sum
// in float32, see mma_tf32.cuh).  The block walks C in slices of 8 channels through a ring of
// three shared-memory stages filled by 16-byte cp.async.cg copies, so the
// next slices load while this one multiplies.  A stage holds
//   the halo window  [192 + K - 1 rows][8 channels, row stride 12] and
//   the weights      w[0:K, slice, n-tile]  [K * 8 rows][128, stride 136];
// rows outside [0, L) and columns past Cout are zero-filled (src-size 0).
// Once a stage lands, the block splits its window in place (big) and into
// one small buffer, so a window value is split once and not once per tap and
// warp; the A fragments come from both by ldmatrix.  The weights are split
// on the fragment load.  The strides put the 8 rows of an A fragment (48-byte
// rows for ldmatrix) and the 4 rows of a B fragment (136 floats apart) on
// distinct banks.  Shared memory is 4 (3 (W + 1088 K) + W) bytes with
// W = 12 (191 + K): 178 KB at K = 11, within the 227 KB a block has up to
// K = 13.  Twelve warps hide the fragment loads' latency better than eight
// (150 registers a thread, one block an SM).  Outputs past sample L and
// channels past Cout are not stored.
//
// Why not wgmma yet.  wgmma reads A from shared memory through descriptors
// that anchor a tile to its swizzle atom, so a one-row tap shift cannot be
// expressed as a descriptor; it needs A from registers.  bf16 operands take
// csrc/conv1d_bf16.cu, which does that; a TF32 counterpart is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kTileM = 192;                  // output samples a block
constexpr int kTileN = 128;                  // output channels a block
constexpr int kStages = 3;                   // cp.async ring depth
constexpr int kWarpM = 64;                   // output samples a warp
constexpr int kWarpN = 32;                   // output channels a warp
constexpr int kWarpsM = kTileM / kWarpM;     // 3 along M, 4 along N
constexpr int kThreads = 32 * kWarpsM * (kTileN / kWarpN);
constexpr int kMTiles = kWarpM / 16;         // m16 tiles a warp
constexpr int kNTiles = kWarpN / 8;          // n8 tiles a warp
constexpr int kWStride = kTileN + 8;         // weight row stride, values
constexpr int kVec = 4;                      // values in 16 bytes: a cp.async
constexpr int kSlice = 8;                    // input channels a stage
constexpr int kXStride = kSlice + kVec;      // the window's row stride

__host__ __device__ inline int window_elems(int K) {
  return (kTileM + K - 1) * kXStride;
}

__host__ __device__ inline int stage_elems(int K) {
  return window_elems(K) + K * kSlice * kWStride;
}

// three stages and one more window, the split remainder
int smem_bytes(int K) {
  return (int)(sizeof(float) * (kStages * stage_elems(K) + window_elems(K)));
}

// Issue the copies of channel slice c0 into one stage: the halo window of
// kTileM + K - 1 rows from l0 - pad and the K [kSlice, kTileN] weight slices.
__device__ inline void load_stage(float* stage, const float* xb,
                                  const float* w, int l0, int pad, int L,
                                  int C, int Cout, int K, int c0, int n0,
                                  int tid) {
  float* xs = stage;
  float* ws = stage + window_elems(K);
  const int rows = kTileM + K - 1;
  for (int e = tid; e < rows * (kSlice / kVec); e += kThreads) {
    const int i = e / (kSlice / kVec);
    const int part = kVec * (e % (kSlice / kVec));
    const int l = l0 - pad + i;
    const bool ok = l >= 0 && l < L && c0 + part < C;
    cp_async16(xs + i * kXStride + part,
               ok ? xb + (size_t)l * C + c0 + part : xb, ok);
  }
  constexpr int kChunks = kTileN / kVec;
  for (int e = tid; e < K * kSlice * kChunks; e += kThreads) {
    const int j = kVec * (e % kChunks);
    const int r = e / kChunks;  // tap * kSlice + channel
    const int c = c0 + r % kSlice;
    const int n = n0 + j;
    const bool ok = n < Cout && c < C;
    const size_t src = ((size_t)(r / kSlice) * C + c) * Cout + n;
    cp_async16(ws + r * kWStride + j, ok ? w + src : w, ok);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    banded_conv1d_kernel(const float* __restrict__ x,
                         const float* __restrict__ w, float* __restrict__ out,
                         int L, int C, int Cout, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int tiles_n = (Cout + kTileN - 1) / kTileN;
  const int n0 = (blockIdx.x % tiles_n) * kTileN;
  const int l0 = (blockIdx.x / tiles_n) * kTileM;
  const int b = blockIdx.y;
  const int pad = (K - 1) / 2;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int warp_m = warp % kWarpsM;
  const int warp_n = warp / kWarpsM;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread in group
  const float* xb = x + (size_t)b * L * C;
  const int sf = stage_elems(K);
  const int wf = window_elems(K);
  float* xsmall = smem + kStages * sf;  // split remainder of the window
  const int slices = (C + kSlice - 1) / kSlice;

  // ldmatrix row of this lane: matrices (rows 0-7 | 8-15) x (the first |
  // second 16 bytes of k) give a0, a1, a2, a3 of the m16n8k8 A fragment
  const int lane_row = lane % 8 + 8 * ((lane / 8) % 2);
  const int a_off = (warp_m * kWarpM + lane_row) * kXStride + kVec * (lane / 16);
  const uint32_t small_base = smem_addr(xsmall + a_off);

  float acc[kMTiles][kNTiles][4] = {};

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slices)
      load_stage(smem + s * sf, xb, w, l0, pad, L, C, Cout, K, s * kSlice, n0,
                 tid);
    cp_async_commit();
  }
  for (int it = 0; it < slices; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage it landed; every warp is done with it - 1
    float* stage = smem + (it % kStages) * sf;
    const int next = it + kStages - 1;
    if (next < slices)
      load_stage(smem + (next % kStages) * sf, xb, w, l0, pad, L, C, Cout, K,
                 next * kSlice, n0, tid);
    cp_async_commit();

    for (int e = tid; e < (kTileM + K - 1) * kSlice; e += kThreads) {
      const int idx = (e / kSlice) * kXStride + e % kSlice;
      uint32_t big, small;
      split_tf32(stage[idx], big, small);
      stage[idx] = __uint_as_float(big);
      xsmall[idx] = __uint_as_float(small);
    }
    __syncthreads();

    const uint32_t big_base = smem_addr(stage + a_off);
    for (int tap = 0; tap < K; ++tap) {
#ifdef CONV_ONE_CHAIN
      float(&part)[kMTiles][kNTiles][4] = acc;
#else
      float part[kMTiles][kNTiles][4] = {};  // this tap's products
#endif
      const float* ws = stage + wf + t * kWStride + warp_n * kWarpN + g;
      uint32_t bb[kNTiles][2], bs[kNTiles][2];
      const float* wt = ws + tap * kSlice * kWStride;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        split_tf32(wt[8 * j], bb[j][0], bs[j][0]);
        split_tf32(wt[4 * kWStride + 8 * j], bb[j][1], bs[j][1]);
      }
      uint32_t ab[kMTiles][4], as[kMTiles][4];
#pragma unroll
      for (int i = 0; i < kMTiles; ++i) {
        const uint32_t row = sizeof(float) * (16 * i + tap) * kXStride;
        ldmatrix_x4(ab[i], big_base + row);
        ldmatrix_x4(as[i], small_base + row);
      }
      mma_3xtf32(part, ab, as, bb, bs);
#ifndef CONV_ONE_CHAIN
      fold_into(acc, part);
#endif
    }
  }

  // accumulator i, j: rows g and g + 8 of m-tile i, columns 2t, 2t + 1 of
  // n-tile j; Cout % 8 == 0 keeps an n-tile wholly in or out
  float* ob = out + (size_t)b * L * Cout;
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
    const int o = n0 + warp_n * kWarpN + 8 * j + 2 * t;
    if (o >= Cout) continue;
#pragma unroll
    for (int i = 0; i < kMTiles; ++i) {
      const int l = l0 + warp_m * kWarpM + 16 * i + g;
      if (l < L) store2(ob + (size_t)l * Cout + o, acc[i][j][0], acc[i][j][1]);
      if (l + 8 < L)
        store2(ob + (size_t)(l + 8) * Cout + o, acc[i][j][2], acc[i][j][3]);
    }
  }
}

int forward(const float* x, const float* w, float* out, int B, int L, int C,
            int Cout, int K, void* stream) {
  const int smem = smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(
      banded_conv1d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_m = (L + kTileM - 1) / kTileM;
  const int tiles_n = (Cout + kTileN - 1) / kTileN;
  const dim3 grid(tiles_m * tiles_n, B);
  banded_conv1d_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, w, out, L, C, Cout, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int banded_conv1d_smem_bytes(int K) { return smem_bytes(K); }

extern "C" int banded_conv1d_forward(const float* x, const float* w,
                                     float* out, int B, int L, int C,
                                     int Cout, int K, void* stream) {
  return forward(x, w, out, B, L, C, Cout, K, stream);
}

extern "C" const char* banded_conv1d_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
