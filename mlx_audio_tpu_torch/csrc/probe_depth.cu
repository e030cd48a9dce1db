// Depth-draft weight-stream and s8-dot probes: the Hopper counterpart of
// make(mode) in scripts/probe_depth.py (the pallas_call over a grid of
// steps).  They size depth_draft.cu's redesign: does one draft step's weight
// stream, or its batch-1 int8 arithmetic, set its time?
//
// One draft step streams L layers of [dm, cols] weights (4 x 1024 x 28672
// int8, 117 MB).  A probe run is `steps` such steps in one launch, one
// persistent block a SM (the TPU grid over steps was one pallas_call).
//
// Stream modes (the result: per step, the sum over chunks c of
// (c + 1) * sum(chunk c), accumulated over steps in int64, so a chunk read
// twice, skipped or out of place changes it; every streamed byte enters it):
//   dma    strided column slices [dm, cw] of w[l], as the TPU kernel's own
//          scheme: 2D tensor-map (TMA) tiles of 32 KB, 2 stages in flight;
//   dmac   the pre-chunked contiguous layout, 1D bulk copies of 32 KB, 2
//          stages;
//   dma8   contiguous, 16 KB copies, 8 stages;
//   dmabig contiguous, 64 KB copies (the largest power of two of which two
//          stages fit a block's 227 KB), 2 stages.
// A step's tiles (stage-sized pieces of its chunks) are dealt round robin to
// the blocks over all steps; each block runs a ring of shared-memory stages
// filled by cp.async.bulk completing on an mbarrier, and every thread sums
// its share of a stage after it lands.  Bound: bytes (3.35 TB/s).
//
// mxu: batch-1 s8 dots on a resident chunk (block 0 of the chunked layout)
// with tensor-core mma.sync.m16n8k32 (x padded to 16 rows), the TPU probe's
// dot count: L * n_chunks matvecs x[1, dm] @ chunk[dm, cw] a step.  A block
// keeps one 32-column slice of the chunk in shared memory; 8 warps take its
// four n-tiles and two halves of dm, four accumulators each.  A step's
// products accumulate in int32 (as on the TPU); the result is their int64
// sum over columns and steps.  Bound: int8 tensor-core operations, or the
// shared-memory reads of the resident slice.
//
// Loads from the resident slice are volatile and each mma accumulates into
// the live accumulator, so no repetition can be folded or dropped.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "probe_common.cuh"

namespace {

using bulk::bulk_copy;
using bulk::mbar_expect_tx;
using bulk::mbar_init;
using bulk::mbar_wait;

constexpr int kThreads = 256;
enum Mode { kDma = 0, kDmac = 1, kDma8 = 2, kDmaBig = 3, kMxu = 4 };

__host__ __device__ constexpr int stages_of(int mode) { return mode == kDma8 ? 8 : 2; }
__host__ __device__ constexpr int stage_bytes_of(int mode) {
  return mode == kDma8 ? 16384 : mode == kDmaBig ? 65536 : 32768;
}
constexpr int kTmaBoxBytesCols = 256;  // dma: a tile's columns (<= 256)

struct StreamArgs {
  const uint8_t* w;
  long long* out;
  int elem_bytes;
  int n_chunks;        // chunks a step, L * cols / cw
  int chunks_a_layer;  // cols / cw
  int dm, cw;
  int steps;
  int box_cols, box_rows;  // dma: the tensor-map tile, in elements
};

__device__ __forceinline__ void tma_copy_2d(void* dst, const CUtensorMap* map,
                                            int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(probe::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(probe::smem_addr(bar)),
      "r"(col), "r"(row)
      : "memory");
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    stream_kernel(const __grid_constant__ CUtensorMap map, StreamArgs a) {
  constexpr int kStages = stages_of(MODE);
  constexpr int kStage = stage_bytes_of(MODE);
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kStages];
  uint8_t* buf = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));

  const long long chunk_bytes = (long long)a.dm * a.cw * a.elem_bytes;
  const int tiles_a_chunk = (int)(chunk_bytes / kStage);
  const int tiles_a_step = a.n_chunks * tiles_a_chunk;
  const long long total = (long long)tiles_a_step * a.steps;
  const int mine = blockIdx.x < total
                       ? (int)((total - blockIdx.x + gridDim.x - 1) / gridDim.x)
                       : 0;

  auto chunk_of = [&](int k) {
    const long long g = blockIdx.x + (long long)k * gridDim.x;
    return (int)((g % tiles_a_step) / tiles_a_chunk);
  };
  auto load_stage = [&](int k, int slot) {
    const long long g = blockIdx.x + (long long)k * gridDim.x;
    const int t = (int)(g % tiles_a_step);
    const int c = t / tiles_a_chunk, sub = t % tiles_a_chunk;
    uint8_t* dst = buf + (size_t)slot * kStage;
    mbar_expect_tx(&bars[slot], kStage);
    if (MODE == kDma) {
      const int l = c / a.chunks_a_layer, j = c % a.chunks_a_layer;
      const int across = a.cw / a.box_cols;
      const int col = j * a.cw + (sub % across) * a.box_cols;
      const int row = l * a.dm + (sub / across) * a.box_rows;
      tma_copy_2d(dst, &map, col, row, &bars[slot]);
    } else {
      bulk_copy(dst, a.w + c * chunk_bytes + (long long)sub * kStage, kStage,
                &bars[slot]);
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s], 1);
    bulk::fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 0; k < kStages && k < mine; ++k) load_stage(k, k);

  long long acc = 0;
  for (int k = 0; k < mine; ++k) {
    const int slot = k % kStages;
    mbar_wait(&bars[slot], (uint32_t)((k / kStages) & 1));
    const uint4* words = reinterpret_cast<const uint4*>(buf + (size_t)slot * kStage);
    long long part;
    if (a.elem_bytes == 1) {
      int s = 0;
#pragma unroll 4
      for (int i = threadIdx.x; i < kStage / 16; i += kThreads)
        s += probe::sum16_s8(words[i]);
      part = s;
    } else {
      float s = 0.0f;
#pragma unroll 4
      for (int i = threadIdx.x; i < kStage / 16; i += kThreads)
        s += probe::sum16_bf16(words[i]);
      part = (long long)s;
    }
    acc += (long long)(chunk_of(k) + 1) * part;
    __syncthreads();  // every thread is done with the stage
    if (threadIdx.x == 0 && k + kStages < mine) load_stage(k + kStages, slot);
  }
  probe::block_add_i64(acc, a.out);
}

constexpr int kSliceCols = 32;  // resident columns a block (four n-tiles)

__global__ void __launch_bounds__(kThreads)
    mxu_kernel(const int8_t* __restrict__ chunk, const int8_t* __restrict__ x,
               long long* out, int dm, int cw, int reps, int steps) {
  extern __shared__ uint8_t smem_raw[];
  const int stride = dm + 16;  // padded row: the 8 n-rows of a load hit 8 bank quads
  int8_t* slice = reinterpret_cast<int8_t*>(smem_raw);  // [32 cols][stride]
  int8_t* xs = slice + kSliceCols * stride;             // [dm]
  const int col0 = blockIdx.x * kSliceCols;
  for (int i = threadIdx.x; i < dm * kSliceCols; i += kThreads) {
    const int k = i / kSliceCols, n = i % kSliceCols;
    slice[n * stride + k] = chunk[(size_t)k * cw + col0 + n];
  }
  for (int i = threadIdx.x; i < dm; i += kThreads) xs[i] = x[i];
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int ntile = warp & 3, half = warp >> 2;
  const int ksteps = dm / 64;  // k-steps of 32 in this warp's half (% 4 == 0)
  const int8_t* brow = slice + (ntile * 8 + gid) * stride;
  long long acc = 0;
  for (int s = 0; s < steps; ++s) {
    int c[4][4] = {};
    for (int r = 0; r < reps; ++r) {
      for (int q = 0; q < ksteps; q += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {  // four independent accumulators
          const int k0 = (half * ksteps + q + u) * 32;
          // A: row 0 is x, rows 1-15 zero; B: this lane's column, 4 + 4 k
          const uint32_t xa = probe::lds_u32(xs + k0 + tig * 4);
          const uint32_t xb = probe::lds_u32(xs + k0 + 16 + tig * 4);
          const uint32_t a0 = gid == 0 ? xa : 0u, a2 = gid == 0 ? xb : 0u;
          const uint32_t b0 = probe::lds_u32(brow + k0 + tig * 4);
          const uint32_t b1 = probe::lds_u32(brow + k0 + 16 + tig * 4);
          asm volatile(
              "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
              "{%0, %1, %2, %3};"
              : "+r"(c[u][0]), "+r"(c[u][1]), "+r"(c[u][2]), "+r"(c[u][3])
              : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
        }
      }
    }
    if (gid == 0)  // row 0 of the tile: columns 2 tig and 2 tig + 1
      for (int u = 0; u < 4; ++u) acc += (long long)c[u][0] + c[u][1];
  }
  probe::block_add_i64(acc, out);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

cudaError_t encode_strided_map(CUtensorMap* map, const void* w, int elem_bytes,
                               int rows, int cols, int box_cols, int box_rows) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess) return err;
  if (found != cudaDriverEntryPointSuccess || fn == nullptr)
    return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = reinterpret_cast<EncodeTiled>(fn)(
      map,
      elem_bytes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(w), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int MODE>
cudaError_t launch_stream(const CUtensorMap& map, const StreamArgs& a,
                          int blocks, cudaStream_t stream) {
  const int smem = stages_of(MODE) * stage_bytes_of(MODE) + 128;
  cudaError_t err = cudaFuncSetAttribute(
      stream_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  stream_kernel<MODE><<<blocks, kThreads, smem, stream>>>(map, a);
  return cudaGetLastError();
}

}  // namespace

// w: for dma the strided weights [L, dm, cols], else the chunked layout
// [L * cols / chunk, dm, chunk]; int8 (elem_bytes 1) or bf16 (2).  x: int8
// [dm] (mxu only).  *out (int64, zeroed by the caller) receives the result.
extern "C" int probe_depth_forward(const void* w, const int8_t* x,
                                   long long* out, int mode, int elem_bytes,
                                   int n_layers, int dm, int cols, int chunk,
                                   int steps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_layers < 1 || dm < 1 || chunk < 1 || cols % chunk || steps < 1 ||
      (elem_bytes != 1 && elem_bytes != 2) || mode < kDma || mode > kMxu)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (mode == kMxu) {
    if (elem_bytes != 1 || dm % 256 || chunk % kSliceCols)
      return (int)cudaErrorInvalidValue;
    const int smem = kSliceCols * (dm + 16) + dm;
    err = cudaFuncSetAttribute(
        mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    mxu_kernel<<<chunk / kSliceCols, kThreads, smem, s>>>(
        static_cast<const int8_t*>(w), x, out, dm, chunk,
        n_layers * (cols / chunk), steps);
    return (int)cudaGetLastError();
  }
  StreamArgs a{static_cast<const uint8_t*>(w), out, elem_bytes,
               n_layers * (cols / chunk), cols / chunk, dm, chunk, steps, 0, 0};
  const long long chunk_bytes = (long long)dm * chunk * elem_bytes;
  CUtensorMap map = {};
  switch (mode) {
    case kDma: {
      a.box_cols = kTmaBoxBytesCols / elem_bytes;
      a.box_rows = stage_bytes_of(kDma) / kTmaBoxBytesCols;
      if (chunk % a.box_cols || dm % a.box_rows) return (int)cudaErrorInvalidValue;
      err = encode_strided_map(&map, w, elem_bytes, n_layers * dm, cols,
                               a.box_cols, a.box_rows);
      if (err != cudaSuccess) return (int)err;
      return (int)launch_stream<kDma>(map, a, sms, s);
    }
    case kDmac:
      if (chunk_bytes % stage_bytes_of(kDmac)) return (int)cudaErrorInvalidValue;
      return (int)launch_stream<kDmac>(map, a, sms, s);
    case kDma8:
      if (chunk_bytes % stage_bytes_of(kDma8)) return (int)cudaErrorInvalidValue;
      return (int)launch_stream<kDma8>(map, a, sms, s);
    default:
      if (chunk_bytes % stage_bytes_of(kDmaBig)) return (int)cudaErrorInvalidValue;
      return (int)launch_stream<kDmaBig>(map, a, sms, s);
  }
}

extern "C" const char* probe_depth_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
