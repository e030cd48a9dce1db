// 'Same'-padded dilated conv1d, channels last, on the tensor cores: the
// Hopper counterpart of dilated_conv1d_pallas (mlx_audio_tpu/nn/pallas_ops.py
// :240-298, _dilated_conv_kernel and dilated_conv1d_pallas).
//
//   out[b, l, o] = sum_tap sum_c x[b, l + tap d - pad, c] * w[tap, c, o],
//   pad = (K - 1) d / 2, x read as zero outside [0, L).
//
// x [B, L, C], w [K, C, Cout], out [B, L, Cout], all float32 and contiguous;
// K odd, C a multiple of 8, Cout a multiple of 8, x and w 16-byte aligned.
//
// What bounds it on this card: operations.  At Kokoro-82M's resblock shapes
// (K = 3, d = 1, 3, 5, C = Cout = 128 or 256) every input row feeds 2 K Cout
// operations a channel, far above the operations per byte where the card's
// compute and memory rates meet.  The port runs float32, and one TF32 pass
// keeps 10 mantissa bits, too few for the 1e-4 the port holds its kernels
// to.  So each operand is split, a = big + small with big = tf32_rna(a) and
// small = tf32_rna(a - big), and each multiply-add takes three TF32 products
// (small big, big small, big big) summed in float32: 3 TF32 products a
// multiply-add at 495 TFLOP/s dense, a bound of 0.124 ms at [2, 26000, 256]
// K = 3 and 0.186 ms at [2, 156001, 128] K = 3, against 0.305 and 0.458 ms
// for float32 FMAs.
//
// Design: banded_conv1d.cu's implicit GEMM with the taps d rows apart, as a
// kernel of its own.  M = B L output rows, N = Cout, depth K C.  A
// 384-thread block owns one batch row, 192 samples and 128 output channels;
// its 12 warps each own 64 x 32 of them as 4 x 4 m16n8k8 tiles
// (mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, accumulators in
// registers; each tap's products in their own, folded into the running sum
// in float32, see mma_tf32.cuh).  The block walks C in slices of s channels through a ring of
// S shared-memory stages filled by 16-byte cp.async.cg copies, so the next
// slices load while this one multiplies.  A stage holds
//   the halo window  [192 + (K-1) d rows][s channels, row stride s + 4] and
//   the weights      w[0:K, slice, n-tile]  [K * s rows][128, stride 136];
// rows outside [0, L), channels past C and columns past Cout are
// zero-filled (src-size 0).  Every tap reads the same window at row offset
// tap d through ldmatrix, so x leaves device memory once a tile and slice,
// not once a tap; a row stride of s + 4 floats (48 or 144 bytes) keeps the 8
// rows of an A fragment on distinct banks from any start row, so the
// dilation costs no bank conflicts.  Once a stage lands, the block splits
// its window in place (big) and into one small buffer, so a window value is
// split once and not once per tap and warp; the weights are split on the
// fragment load.
//
// The stage: at K = 3 a stage has only three taps, so its fixed cost (the
// window split, the copies, two barriers) weighs more than at K = 11.  On
// the card, at Kokoro's K = 3 shapes, slices of 16 channels beat slices of
// 8, and slices of 32 in a ring of two stages beat both (with 40 bytes of
// register spills; 168 registers a thread, one block an SM).  Shared memory
// is 4 (S (W + 136 s K) + W) bytes with W = (s + 4) (192 + (K-1) d); the
// kernel takes the first of (s, S) = (32, 2), (8, 3), (8, 2) that fits in
// the 227 KiB a block has: 184 KiB at K = 3, d = 1 and 187 KiB at d = 5;
// 186 KiB (8, 3) at K = 11, d = 5; 156 KiB (8, 2) at K = 15, d = 1.
// Outputs past sample L and channels past Cout are not stored.
//
// Why mma.sync and not wgmma: wgmma reads A from shared memory through
// descriptors anchored to a swizzle atom, so a tile that starts tap d rows
// into the window cannot be a descriptor; it needs A from registers, which is
// later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kTileM = 192;                  // output samples a block
constexpr int kTileN = 128;                  // output channels a block
constexpr int kWarpM = 64;                   // output samples a warp
constexpr int kWarpN = 32;                   // output channels a warp
constexpr int kWarpsM = kTileM / kWarpM;     // 3 along M, 4 along N
constexpr int kThreads = 32 * kWarpsM * (kTileN / kWarpN);
constexpr int kMTiles = kWarpM / 16;         // m16 tiles a warp
constexpr int kNTiles = kWarpN / 8;          // n8 tiles a warp
constexpr int kWStride = kTileN + 8;         // weight row stride, floats
constexpr int kSmemLimit = 232448;           // bytes a block may use (H100)

// A stage's channel slice and the ring's depth, in the order tried.
struct Config {
  int slice, stages;
};
constexpr Config kConfigs[] = {{32, 2}, {8, 3}, {8, 2}};

// span = (K - 1) d: the window's rows beyond the tile
__host__ __device__ constexpr int window_floats(int slice, int span) {
  return (kTileM + span) * (slice + 4);
}

__host__ __device__ constexpr int stage_floats(int slice, int K, int span) {
  return window_floats(slice, span) + K * slice * kWStride;
}

int smem_bytes(Config cfg, int K, int span) {
  return (int)(sizeof(float) * (cfg.stages * stage_floats(cfg.slice, K, span) +
                                window_floats(cfg.slice, span)));
}

// the first config whose shared memory fits a block (the last if none does)
Config config_for(int K, int span) {
  for (const Config& cfg : kConfigs)
    if (smem_bytes(cfg, K, span) <= kSmemLimit) return cfg;
  return kConfigs[2];
}

// Issue the copies of channel slice c0 into one stage: the halo window of
// kTileM + span rows from l0 - pad and the K [kSlice, kTileN] weight slices.
template <int kSlice>
__device__ inline void load_stage(float* stage, const float* xb,
                                  const float* w, int l0, int pad, int span,
                                  int L, int C, int Cout, int K, int c0,
                                  int n0, int tid) {
  constexpr int kXStride = kSlice + 4;
  float* xs = stage;
  float* ws = stage + window_floats(kSlice, span);
  constexpr int kParts = kSlice / 4;
  for (int e = tid; e < (kTileM + span) * kParts; e += kThreads) {
    const int i = e / kParts;
    const int c = c0 + 4 * (e % kParts);
    const int l = l0 - pad + i;
    const bool ok = l >= 0 && l < L && c < C;
    cp_async16(xs + i * kXStride + c - c0, ok ? xb + (size_t)l * C + c : xb,
               ok);
  }
  constexpr int kChunks = kTileN / 4;
  for (int e = tid; e < K * kSlice * kChunks; e += kThreads) {
    const int j = 4 * (e % kChunks);
    const int r = e / kChunks;  // tap * kSlice + channel
    const int c = c0 + r % kSlice;
    const int n = n0 + j;
    const bool ok = n < Cout && c < C;
    const size_t src = ((size_t)(r / kSlice) * C + c) * Cout + n;
    cp_async16(ws + r * kWStride + j, ok ? w + src : w, ok);
  }
}

template <int kSlice, int kStages>
__global__ void __launch_bounds__(kThreads, 1)
    dilated_conv1d_kernel(const float* __restrict__ x,
                          const float* __restrict__ w, float* __restrict__ out,
                          int L, int C, int Cout, int K, int dilation) {
  constexpr int kXStride = kSlice + 4;  // window row stride, floats
  extern __shared__ __align__(16) float smem[];
  const int tiles_n = (Cout + kTileN - 1) / kTileN;
  const int n0 = (blockIdx.x % tiles_n) * kTileN;
  const int l0 = (blockIdx.x / tiles_n) * kTileM;
  const int b = blockIdx.y;
  const int span = (K - 1) * dilation;
  const int pad = span / 2;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int warp_m = warp % kWarpsM;
  const int warp_n = warp / kWarpsM;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread in group
  const float* xb = x + (size_t)b * L * C;
  const int sf = stage_floats(kSlice, K, span);
  const int wf = window_floats(kSlice, span);
  float* xsmall = smem + kStages * sf;  // split remainder of the window
  const int slices = (C + kSlice - 1) / kSlice;

  // ldmatrix row of this lane: matrices (rows 0-7 | 8-15) x (cols 0-3 | 4-7)
  // give a0, a1, a2, a3 of the m16n8k8 A fragment
  const int a_off =
      (warp_m * kWarpM + lane % 8 + 8 * ((lane / 8) % 2)) * kXStride +
      4 * (lane / 16);
  const uint32_t small_base = smem_addr(xsmall + a_off);

  float acc[kMTiles][kNTiles][4] = {};

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slices)
      load_stage<kSlice>(smem + s * sf, xb, w, l0, pad, span, L, C, Cout, K,
                         s * kSlice, n0, tid);
    cp_async_commit();
  }
  for (int it = 0; it < slices; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage it landed; every warp is done with it - 1
    float* stage = smem + (it % kStages) * sf;
    const int next = it + kStages - 1;
    if (next < slices)
      load_stage<kSlice>(smem + (next % kStages) * sf, xb, w, l0, pad, span,
                         L, C, Cout, K, next * kSlice, n0, tid);
    cp_async_commit();

    for (int e = tid; e < (kTileM + span) * kSlice; e += kThreads) {
      const int idx = (e / kSlice) * kXStride + e % kSlice;
      uint32_t big, small;
      split_tf32(stage[idx], big, small);
      stage[idx] = __uint_as_float(big);
      xsmall[idx] = __uint_as_float(small);
    }
    __syncthreads();

    const uint32_t big_base = smem_addr(stage + a_off);
    const float* ws = stage + wf + t * kWStride + warp_n * kWarpN + g;
    for (int tap = 0; tap < K; ++tap) {
      const int shift = tap * dilation;  // the tap's row offset in the window
#ifdef CONV_ONE_CHAIN
      float(&part)[kMTiles][kNTiles][4] = acc;
#else
      float part[kMTiles][kNTiles][4] = {};  // this tap's products
#endif
#pragma unroll
      for (int kk = 0; kk < kSlice / 8; ++kk) {  // one k8 step a pass
        uint32_t bb[kNTiles][2], bs[kNTiles][2];
        const float* wt = ws + (tap * kSlice + 8 * kk) * kWStride;
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) {
          split_tf32(wt[8 * j], bb[j][0], bs[j][0]);
          split_tf32(wt[4 * kWStride + 8 * j], bb[j][1], bs[j][1]);
        }
        uint32_t ab[kMTiles][4], as[kMTiles][4];
#pragma unroll
        for (int i = 0; i < kMTiles; ++i) {
          const uint32_t at =
              sizeof(float) * ((16 * i + shift) * kXStride + 8 * kk);
          ldmatrix_x4(ab[i], big_base + at);
          ldmatrix_x4(as[i], small_base + at);
        }
        mma_3xtf32(part, ab, as, bb, bs);
      }
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
      if (l < L)
        *reinterpret_cast<float2*>(ob + (size_t)l * Cout + o) =
            make_float2(acc[i][j][0], acc[i][j][1]);
      if (l + 8 < L)
        *reinterpret_cast<float2*>(ob + (size_t)(l + 8) * Cout + o) =
            make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
}

}  // namespace

extern "C" int dilated_conv1d_smem_bytes(int K, int dilation) {
  const int span = (K - 1) * dilation;
  return smem_bytes(config_for(K, span), K, span);
}

extern "C" int dilated_conv1d_forward(const float* x, const float* w,
                                      float* out, int B, int L, int C,
                                      int Cout, int K, int dilation,
                                      void* stream) {
  const int span = (K - 1) * dilation;
  const Config cfg = config_for(K, span);
  const int smem = smem_bytes(cfg, K, span);
  auto kernel = cfg.slice == 32   ? dilated_conv1d_kernel<32, 2>
                : cfg.stages == 3 ? dilated_conv1d_kernel<8, 3>
                                  : dilated_conv1d_kernel<8, 2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_m = (L + kTileM - 1) / kTileM;
  const int tiles_n = (Cout + kTileN - 1) / kTileN;
  const dim3 grid(tiles_m * tiles_n, B);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(x, w, out, L, C, Cout,
                                                         K, dilation);
  return (int)cudaGetLastError();
}

extern "C" const char* dilated_conv1d_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
