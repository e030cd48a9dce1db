// Weight-only dequantize-matmul: the Hopper counterpart of quantized_matmul
// (mlx_audio_tpu/nn/pallas_ops.py:144-201, _quant_matmul_kernel and
// quantized_matmul).
//
// Computes y[b, o] = sum_i x[b, i] * (q[o, i] * scale[o, g] + bias[o, g]),
// g = i / group_size, from uint8 codes q [O, I], or from two 4-bit codes a
// byte [O, I/2] in the concat-half layout (low nibble = column j, high
// nibble = column j + I/2).  The dense weight is never written anywhere.
//
// What bounds it on this card.  At decode row counts (1 to 8 rows), bytes: a
// row does 2 operations a code byte, far below the roughly 20 operations a
// byte at which the card's float32 rate and its 3.35 TB/s of device memory
// balance.  At CSM's 32-row verify, float32 FMAs: 64 operations a code byte.
//
// Why split over I.  A decode step's O is small (1024 columns for the depth
// decoder's down projection), so a grid over output columns alone leaves
// most of the 132 SMs idle while each block walks all of I.  The stored
// columns are cut into `parts` pieces of P columns (the last may be
// shorter), P a multiple of the group size; a block owns one column tile,
// one part and up to TB <= 8 rows, so the grid is (column tiles, parts, row
// tiles).  The choice of parts depends on (I, O, group size, packed) alone,
// never on the row count (quantized_matmul_parts below, mirrored by
// nn/kernels.py:quantized_matmul_parts).
//
// The order contract.  Each output's sum runs in one order whatever the row
// count and TB: a lane's partial over its codes in ascending column order
// (the low nibble before the high one of a byte), the warp's shuffle tree,
// then the parts in ascending order.  So a row's result does not depend on
// the rows batched with it, and CSM's 32-row verify gives a decode step's
// 1-row logits bit for bit.  With more than one part, the first kernel
// (qmm_kernel_part) writes each part's sums to a workspace [parts, rows, O]
// that the wrapper allocates, and a second kernel (qmm_kernel_sum) adds them
// in ascending part order; with one part the first kernel writes y and the
// second is not launched.  No float atomics, whose order would change from
// run to run.
//
// The defaults below (parts of up to 2048 stored columns, 2 output columns a
// warp, loads 2 steps ahead) were the fastest at CSM-1B's shapes of the
// variants that mlx_audio_tpu_torch/scripts/tune_qmm.py builds and times
// (parts of 512, 1024 or 2048; 2 or 4 columns; 2 or 4 steps).
//
// In a block, each of 8 warps owns kWarpCols output columns.  Its part of x
// (TB rows, both halves when packed) is staged in shared memory once, behind
// one barrier, while the first code loads are already in flight.  Where the
// stored width and the group size are multiples of 16 and the codes 16-byte
// aligned, a lane loads 16 consecutive codes as one uint4, so a warp reads
// 512 contiguous bytes of a weight row; it issues the loads of all its
// columns kDepth steps ahead of their use.  The codes of a load share one
// group.  A lane reads x as float4 from shared memory, stored with a swizzle
// that puts a quarter-warp's float4s on distinct banks, and reuses each x
// value across its columns; its dequantized codes feed all TB rows.  Shapes
// that fail the alignment test take the same kernel with 4-code or 1-code
// loads.  A code becomes a float through its mantissa (2^23 + q, minus
// 2^23: exact, and cheaper than a conversion), and is dequantized as the
// plain version rounds it: __fadd_rn(__fmul_rn(q, scale), bias), then fmaf
// into float32 registers.
//
// Why no tensor cores or TMA here.  At decode row counts the tensor cores
// have nothing to do that the memory system would let them finish sooner,
// and 16-byte loads, several in flight a lane, are enough to keep the
// device memory busy (the depth-draft probes stream a step at 76-114% of
// 3.35 TB/s through loads alone).  A tensor-core dequant GEMM for 32 rows
// and up, and a TMA ring, are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef QMM_PART_COLS
#define QMM_PART_COLS 2048  // stored columns a part, at most
#endif
#ifndef QMM_WARP_COLS
#define QMM_WARP_COLS 2  // output columns a warp
#endif
#ifndef QMM_DEPTH
#define QMM_DEPTH 2  // code loads in flight a lane, in steps
#endif

namespace {

constexpr int kPartCols = QMM_PART_COLS;
constexpr int kWarpCols = QMM_WARP_COLS;
constexpr int kDepth = QMM_DEPTH;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockCols = kWarps * kWarpCols;
constexpr int kSumThreads = 256;

// stored columns a part: a multiple of the group size (of 16 when a group
// is longer than kPartCols), or all of them when they fit in one
int part_cols(int in_f, int gs, int packed) {
  const int stored = packed ? in_f / 2 : in_f;
  const int p = gs <= kPartCols ? (kPartCols / gs) * gs : kPartCols;
  return stored <= p ? stored : p;
}

// VEC codes of one load: 16 as a uint4, 4 as a word, 1 as a byte
template <int VEC>
struct Slot {
  uint32_t w[VEC == 16 ? 4 : 1];
  float s, z, s2, z2;  // the group's scale and bias (s2, z2: high nibbles)
};

// shared-memory float index of part-local stored column k: for 16-code
// loads, lane l's quarter e goes to float4 slot 4 c + (e ^ ((c >> 1) & 3)) of
// its chunk c = k / 16, so the 8 lanes of a quarter-warp hit 8 distinct
// 16-byte bank groups
template <int VEC>
__device__ __forceinline__ int x_index(int k) {
  if constexpr (VEC != 16) return k;
  const int c = k >> 4, e = (k >> 2) & 3;
  return (c << 4) | ((e ^ ((c >> 1) & 3)) << 2) | (k & 3);
}

// q as a float: 2^23 + q built in the mantissa, minus 2^23 (exact)
__device__ __forceinline__ float code_float(uint32_t q) {
  return __fsub_rn(__uint_as_float(0x4B000000u | q), 8388608.0f);
}

template <int VEC, bool PACKED>
__device__ __forceinline__ void fetch(Slot<VEC>& slot,
                                      const uint8_t* __restrict__ qrow,
                                      const float* __restrict__ srow,
                                      const float* __restrict__ zrow, int p,
                                      int stored, int gs) {
  if constexpr (VEC == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(qrow + p));
    slot.w[0] = v.x;
    slot.w[1] = v.y;
    slot.w[2] = v.z;
    slot.w[3] = v.w;
  } else if constexpr (VEC == 4) {
    slot.w[0] = __ldg(reinterpret_cast<const unsigned int*>(qrow + p));
  } else {
    slot.w[0] = __ldg(qrow + p);
  }
  const int g = p / gs;
  slot.s = __ldg(srow + g);
  slot.z = __ldg(zrow + g);
  if constexpr (PACKED) {
    const int g2 = (p + stored) / gs;
    slot.s2 = __ldg(srow + g2);
    slot.z2 = __ldg(zrow + g2);
  }
}

// One block: kBlockCols output columns, one part of the stored columns, TB
// rows.  Writes y (parts == 1) or the part's slice of the workspace.
template <int VEC, int TB, bool PACKED>
__global__ void __launch_bounds__(kThreads)
    qmm_kernel_part(const float* __restrict__ x,
                    const uint8_t* __restrict__ codes,
                    const float* __restrict__ scales,
                    const float* __restrict__ biases, float* __restrict__ out,
                    int rows, int in_f, int out_f, int gs, int part) {
  constexpr int kHalves = PACKED ? 2 : 1;
  constexpr int kStep = 32 * VEC;  // stored columns a warp step
  extern __shared__ __align__(16) float xs[];  // [TB][kHalves][part]
  const int stored = PACKED ? in_f / 2 : in_f;
  const int groups = in_f / gs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p0 = blockIdx.y * part;
  const int len = min(part, stored - p0);
  const int row0 = blockIdx.z * TB;
  const int col0 = blockIdx.x * kBlockCols + warp * kWarpCols;
  const int nsteps = (len + kStep - 1) / kStep;

  const uint8_t* qrow[kWarpCols];
  const float* srow[kWarpCols];
  const float* zrow[kWarpCols];
#pragma unroll
  for (int c = 0; c < kWarpCols; ++c) {
    // a column past O reads column O - 1 and is not stored
    const int o = min(col0 + c, out_f - 1);
    qrow[c] = codes + (size_t)o * stored;
    srow[c] = scales + (size_t)o * groups;
    zrow[c] = biases + (size_t)o * groups;
  }

  // the first kDepth steps' codes, issued before x is staged
  Slot<VEC> buf[kDepth][kWarpCols];
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    const int k = d * kStep + lane * VEC;
    if (k < len) {
#pragma unroll
      for (int c = 0; c < kWarpCols; ++c)
        fetch<VEC, PACKED>(buf[d][c], qrow[c], srow[c], zrow[c], p0 + k,
                           stored, gs);
    }
  }

#pragma unroll
  for (int t = 0; t < TB; ++t) {
    const int row = row0 + t;
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      float* dst = xs + (t * kHalves + h) * part;
      const float* src = x + (size_t)row * in_f + (size_t)h * stored + p0;
      for (int k = threadIdx.x; k < len; k += kThreads)
        dst[x_index<VEC>(k)] = row < rows ? src[k] : 0.0f;
    }
  }
  __syncthreads();

  float acc[kWarpCols][TB];
#pragma unroll
  for (int c = 0; c < kWarpCols; ++c)
#pragma unroll
    for (int t = 0; t < TB; ++t) acc[c][t] = 0.0f;

  for (int s0 = 0; s0 < nsteps; s0 += kDepth) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int k = (s0 + d) * kStep + lane * VEC;
      if (s0 + d >= nsteps) break;
      if (k < len) {
        // quarters of 4 codes (one for VEC 4 and 1)
#pragma unroll
        for (int e = 0; e < (VEC == 16 ? 4 : 1); ++e) {
          constexpr int kN = VEC == 1 ? 1 : 4;  // codes a quarter
          float xv[TB][kHalves][kN];
#pragma unroll
          for (int t = 0; t < TB; ++t)
#pragma unroll
            for (int h = 0; h < kHalves; ++h) {
              const float* base = xs + (t * kHalves + h) * part;
              if constexpr (VEC == 1) {
                xv[t][h][0] = base[k];
              } else {
                const float4 v = *reinterpret_cast<const float4*>(
                    base + x_index<VEC>(k + 4 * e));
                xv[t][h][0] = v.x;
                xv[t][h][1] = v.y;
                xv[t][h][2] = v.z;
                xv[t][h][3] = v.w;
              }
            }
#pragma unroll
          for (int c = 0; c < kWarpCols; ++c) {
            const Slot<VEC>& sl = buf[d][c];
            const uint32_t word = sl.w[VEC == 16 ? e : 0];
#pragma unroll
            for (int b = 0; b < kN; ++b) {
              const uint32_t byte = (word >> (8 * b)) & 0xFFu;
              const float w = __fadd_rn(
                  __fmul_rn(code_float(PACKED ? (byte & 0xFu) : byte), sl.s),
                  sl.z);
#pragma unroll
              for (int t = 0; t < TB; ++t)
                acc[c][t] = fmaf(w, xv[t][0][b], acc[c][t]);
              if constexpr (PACKED) {
                const float w2 = __fadd_rn(
                    __fmul_rn(code_float(byte >> 4), sl.s2), sl.z2);
#pragma unroll
                for (int t = 0; t < TB; ++t)
                  acc[c][t] = fmaf(w2, xv[t][kHalves - 1][b], acc[c][t]);
              }
            }
          }
        }
        // refill this slot kDepth steps ahead
        const int kn = k + kDepth * kStep;
        if (kn < len) {
#pragma unroll
          for (int c = 0; c < kWarpCols; ++c)
            fetch<VEC, PACKED>(buf[d][c], qrow[c], srow[c], zrow[c],
                               p0 + kn, stored, gs);
        }
      }
    }
  }

  float* dst = out + (size_t)blockIdx.y * rows * out_f;
#pragma unroll
  for (int c = 0; c < kWarpCols; ++c) {
#pragma unroll
    for (int t = 0; t < TB; ++t) {
      float v = acc[c][t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      const int o = col0 + c, row = row0 + t;
      if (lane == 0 && o < out_f && row < rows) dst[(size_t)row * out_f + o] = v;
    }
  }
}

// y[n] = the parts' sums of output n added in ascending part order
__global__ void __launch_bounds__(kSumThreads)
    qmm_kernel_sum(const float* __restrict__ ws, float* __restrict__ y, int n,
                   int parts) {
  const int i = blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= n) return;
  float v = ws[i];
  for (int p = 1; p < parts; ++p) v = __fadd_rn(v, ws[(size_t)p * n + i]);
  y[i] = v;
}

template <int VEC, int TB, bool PACKED>
cudaError_t launch_part(const float* x, const uint8_t* codes,
                        const float* scales, const float* biases, float* out,
                        int rows, int in_f, int out_f, int gs, int part,
                        int parts, cudaStream_t stream) {
  constexpr int kHalves = PACKED ? 2 : 1;
  const size_t smem = sizeof(float) * TB * kHalves * part;
  auto kernel = qmm_kernel_part<VEC, TB, PACKED>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((out_f + kBlockCols - 1) / kBlockCols),
                  (unsigned)parts, (unsigned)((rows + TB - 1) / TB));
  kernel<<<grid, kThreads, smem, stream>>>(x, codes, scales, biases, out,
                                           rows, in_f, out_f, gs, part);
  return cudaGetLastError();
}

template <int VEC, bool PACKED>
cudaError_t launch_rows(const float* x, const uint8_t* codes,
                        const float* scales, const float* biases, float* out,
                        int rows, int in_f, int out_f, int gs, int part,
                        int parts, cudaStream_t s) {
  if (rows == 1)
    return launch_part<VEC, 1, PACKED>(x, codes, scales, biases, out, rows,
                                       in_f, out_f, gs, part, parts, s);
  if (rows <= 2)
    return launch_part<VEC, 2, PACKED>(x, codes, scales, biases, out, rows,
                                       in_f, out_f, gs, part, parts, s);
  if (rows <= 4)
    return launch_part<VEC, 4, PACKED>(x, codes, scales, biases, out, rows,
                                       in_f, out_f, gs, part, parts, s);
  return launch_part<VEC, 8, PACKED>(x, codes, scales, biases, out, rows,
                                     in_f, out_f, gs, part, parts, s);
}

template <bool PACKED>
cudaError_t launch_vec(int vec, const float* x, const uint8_t* codes,
                       const float* scales, const float* biases, float* out,
                       int rows, int in_f, int out_f, int gs, int part,
                       int parts, cudaStream_t s) {
  if (vec == 16)
    return launch_rows<16, PACKED>(x, codes, scales, biases, out, rows, in_f,
                                   out_f, gs, part, parts, s);
  if (vec == 4)
    return launch_rows<4, PACKED>(x, codes, scales, biases, out, rows, in_f,
                                  out_f, gs, part, parts, s);
  return launch_rows<1, PACKED>(x, codes, scales, biases, out, rows, in_f,
                                out_f, gs, part, parts, s);
}

}  // namespace

// The number of parts I is cut into: from (I, O, group size, packed) alone.
// O does not change the choice today.
extern "C" int quantized_matmul_parts(int in_f, int out_f, int gs,
                                      int packed) {
  (void)out_f;
  if (in_f < 1 || gs < 1) return 0;
  const int stored = packed ? in_f / 2 : in_f;
  const int part = part_cols(in_f, gs, packed);
  return (stored + part - 1) / part;
}

// ws: float32 [parts, rows, O] where parts > 1, else unused (may be null)
extern "C" int quantized_matmul_forward(const float* x, const uint8_t* codes,
                                        const float* scales,
                                        const float* biases, float* y,
                                        float* ws, int rows, int in_f,
                                        int out_f, int gs, int packed,
                                        void* stream) {
  if (rows < 1 || out_f < 1 || gs < 1 || in_f % gs != 0 ||
      (packed && in_f % 2 != 0) || (rows + 7) / 8 > 65535)
    return (int)cudaErrorInvalidValue;
  const int stored = packed ? in_f / 2 : in_f;
  const int part = part_cols(in_f, gs, packed);
  const int parts = quantized_matmul_parts(in_f, out_f, gs, packed);
  if (parts > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(codes);
  const int vec = stored % 16 == 0 && gs % 16 == 0 && addr % 16 == 0 ? 16
                  : stored % 4 == 0 && gs % 4 == 0 && addr % 4 == 0  ? 4
                                                                     : 1;
  cudaStream_t s = (cudaStream_t)stream;
  float* out = parts > 1 ? ws : y;
  cudaError_t err =
      packed ? launch_vec<true>(vec, x, codes, scales, biases, out, rows,
                                in_f, out_f, gs, part, parts, s)
             : launch_vec<false>(vec, x, codes, scales, biases, out, rows,
                                 in_f, out_f, gs, part, parts, s);
  if (err != cudaSuccess || parts == 1) return (int)err;
  const int n = rows * out_f;
  qmm_kernel_sum<<<(n + kSumThreads - 1) / kSumThreads, kSumThreads, 0, s>>>(
      ws, y, n, parts);
  return (int)cudaGetLastError();
}

extern "C" const char* quantized_matmul_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
