// Compiler-pipelined weight stream: the Hopper counterpart of make_auto() in
// scripts/probe_depth.py (Mosaic's own BlockSpec prefetcher over a
// (steps, L * n_chunks) grid, no manual DMA).
//
// Streams the chunked weights [C, dm, cw] (int8 or bf16) once a step for
// `steps` steps and returns the stream probes' checksum: per step the sum
// over chunks c of (c + 1) * sum(chunk c), accumulated over steps in int64.
// There is no explicit asynchronous copy.  One persistent block a SM; each
// thread walks a step's 16-byte words with a stride of the grid's thread
// count, eight read-only loads (ld.global.nc.v4) started before any is used,
// so that several are in flight a thread, as the compiler's pipelining
// would keep them.  The loads are volatile: every step reads every byte.
// Bound: bytes (3.35 TB/s).
#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kInFlight = 8;

__device__ __forceinline__ uint4 ldg_nc(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

template <int ELEM_BYTES>
__global__ void __launch_bounds__(kThreads)
    auto_kernel(const uint4* __restrict__ w, long long* out, int step_words,
                int chunk_words, int steps) {
  const int nthreads = gridDim.x * kThreads;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  long long acc = 0;
  for (int s = 0; s < steps; ++s) {
    for (int base = tid; base < step_words; base += kInFlight * nthreads) {
      uint4 v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = base + u * nthreads;
        v[u] = i < step_words ? ldg_nc(w + i) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = base + u * nthreads;
        if (i < step_words) {
          const long long part = ELEM_BYTES == 1
                                     ? (long long)probe::sum16_s8(v[u])
                                     : (long long)probe::sum16_bf16(v[u]);
          acc += (long long)(i / chunk_words + 1) * part;
        }
      }
    }
  }
  probe::block_add_i64(acc, out);
}

}  // namespace

// w: chunked weights [n_chunks, dm, cw], int8 (elem_bytes 1) or bf16 (2),
// 16-byte aligned; *out (int64, zeroed by the caller) receives the result.
extern "C" int probe_auto_forward(const void* w, long long* out,
                                  int elem_bytes, int n_chunks, int dm, int cw,
                                  int steps, void* stream) {
  const long long chunk_bytes = (long long)dm * cw * elem_bytes;
  const long long step_words = chunk_bytes / 16 * n_chunks;
  if ((elem_bytes != 1 && elem_bytes != 2) || n_chunks < 1 || steps < 1 ||
      chunk_bytes < 16 || chunk_bytes % 16 || step_words > (1LL << 30) ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const uint4* words = static_cast<const uint4*>(w);
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 1)
    auto_kernel<1><<<sms, kThreads, 0, s>>>(words, out, (int)step_words,
                                            (int)(chunk_bytes / 16), steps);
  else
    auto_kernel<2><<<sms, kThreads, 0, s>>>(words, out, (int)step_words,
                                            (int)(chunk_bytes / 16), steps);
  return (int)cudaGetLastError();
}

extern "C" const char* probe_auto_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
