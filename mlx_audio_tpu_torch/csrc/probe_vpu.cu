// CUDA-core int8 matvec on a resident chunk: the Hopper counterpart of
// make_vpu() in scripts/probe_depth.py (the TPU's vector-unit
// broadcast-multiply-accumulate over a resident [dm/8, 8, cw] int8 buffer).
//
// Computes, for `steps` steps of `reps` repetitions each, x @ chunk with
// x [dm] int8 (the first column of the TPU probe's [dm/8, 8, 128] draw) and
// chunk [dm, cw] int8 (block 0 of the chunked weights, the [dm/8, 8, cw]
// view read row by row).  A step's products accumulate in int32; the result
// is their int64 sum over columns and steps, exact whatever the order.
//
// The instruction is __dp4a, the one depth_draft.cu uses for the same job:
// four s8 x s8 products added into an int32.  A block keeps a 32-column
// slice of the chunk in shared memory, transposed so that a column's dm
// values are contiguous; eight threads share a column, each reading its
// dm / 8 values with 16-byte volatile shared loads every repetition (no
// repetition can be hoisted or folded).  Bound: CUDA-core int8 operations,
// or the shared-memory reads of the resident slice.
#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSliceCols = 32;
constexpr int kPerCol = kThreads / kSliceCols;  // threads a column

__global__ void __launch_bounds__(kThreads)
    vpu_kernel(const int8_t* __restrict__ chunk, const int8_t* __restrict__ x,
               long long* out, int dm, int cw, int reps, int steps) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int stride = dm + 16;  // keeps 16-byte alignment, staggers banks
  int8_t* slice = reinterpret_cast<int8_t*>(smem_raw);  // [32 cols][stride]
  int8_t* xs = slice + kSliceCols * stride;             // [dm]
  const int col0 = blockIdx.x * kSliceCols;
  for (int i = threadIdx.x; i < dm * kSliceCols; i += kThreads) {
    const int k = i / kSliceCols, n = i % kSliceCols;
    slice[n * stride + k] = chunk[(size_t)k * cw + col0 + n];
  }
  for (int i = threadIdx.x; i < dm; i += kThreads) xs[i] = x[i];
  __syncthreads();

  const int n = threadIdx.x / kPerCol, part = threadIdx.x % kPerCol;
  const int span = dm / kPerCol;  // bytes of k a thread covers (% 16 == 0)
  const int8_t* wcol = slice + n * stride + part * span;
  const int8_t* xk = xs + part * span;
  long long acc = 0;
  for (int s = 0; s < steps; ++s) {
    int a = 0;
    for (int r = 0; r < reps; ++r) {
      for (int k = 0; k < span; k += 16) {
        const uint4 wv = probe::lds_v4(wcol + k);
        const uint4 xv = probe::lds_v4(xk + k);
        a = __dp4a((int)wv.x, (int)xv.x, a);
        a = __dp4a((int)wv.y, (int)xv.y, a);
        a = __dp4a((int)wv.z, (int)xv.z, a);
        a = __dp4a((int)wv.w, (int)xv.w, a);
      }
    }
    acc += a;
  }
  probe::block_add_i64(acc, out);
}

}  // namespace

// chunk: int8 [dm, cw] row-major; x: int8 [dm]; *out (int64, zeroed by the
// caller) receives the result.  dm % 128 == 0, cw % 32 == 0.
extern "C" int probe_vpu_forward(const int8_t* chunk, const int8_t* x,
                                 long long* out, int dm, int cw, int reps,
                                 int steps, void* stream) {
  if (dm < 128 || dm % 128 || cw < kSliceCols || cw % kSliceCols || reps < 1 ||
      steps < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = kSliceCols * (dm + 16) + dm;
  cudaError_t err = cudaFuncSetAttribute(
      vpu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  vpu_kernel<<<cw / kSliceCols, kThreads, smem, (cudaStream_t)stream>>>(
      chunk, x, out, dm, cw, reps, steps);
  return (int)cudaGetLastError();
}

extern "C" const char* probe_vpu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
