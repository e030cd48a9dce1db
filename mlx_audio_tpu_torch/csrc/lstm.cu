// LSTM recurrence in one launch: the Hopper counterpart of lstm_pallas
// (mlx_audio_tpu/nn/pallas_ops.py, _lstm_kernel and lstm_pallas).
//
// Computes, for every batch row b and step t = 0 .. T-1,
//   gates = x_proj[b, t] + h @ wh            (wh is [H, 4H], torch order i,f,g,o)
//   c     = sigmoid(f) * c + sigmoid(i) * tanh(g)
//   h     = sigmoid(o) * tanh(c)
// and writes every h and c ([B, T, H] each) plus the final (h_T, c_T), with
// the state carried in float32.
//
// What bounds it on this card: the recurrence.  Step t needs all of h from
// step t-1, so the T steps are a chain of [1, H] x [H, 4H] products whose
// operands are tiny next to the card; the FLOP and byte counts of the whole
// call (2 B T H 4H operations, x_proj and the outputs moved once) give a
// roofline time far below what the chain of T dependent steps can reach.
// The TPU kernel ran its grid over T in order and kept the state in scratch
// between grid steps.  Hopper blocks run in no order and share nothing, so
// here the time loop lives inside one block: one block per batch row, one
// thread per gate column (4H = 1024 threads for H = 256), h and c in shared
// memory, and two barriers per step.  Each step reads all of wh (1 MiB in
// float32 for H = 256): too large for one SM's 227 KB of shared memory, it
// is served from the 50 MB L2, and that per-SM L2 read is the step's cost.
//
// The later redesign (ROADMAP queue 2, item 1) splits the 4H columns over a
// thread-block cluster so that each SM keeps its slice of wh in shared
// memory, and exchanges h through distributed shared memory every step.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(1024)
    lstm_kernel(const float* __restrict__ xp, const float* __restrict__ wh,
                const float* __restrict__ h0, const float* __restrict__ c0,
                float* __restrict__ hs, float* __restrict__ cs,
                float* __restrict__ h_last, float* __restrict__ c_last, int T,
                int H) {
  extern __shared__ float smem[];
  float* h = smem;              // [H]
  float* c = smem + H;          // [H]
  float* gates = smem + 2 * H;  // [4H], activated
  const int b = blockIdx.x;
  const int h4 = 4 * H;

  for (int n = threadIdx.x; n < H; n += blockDim.x) {
    h[n] = h0[(size_t)b * H + n];
    c[n] = c0[(size_t)b * H + n];
  }
  __syncthreads();

  const float* xb = xp + (size_t)b * T * h4;
  float* hsb = hs + (size_t)b * T * H;
  float* csb = cs + (size_t)b * T * H;
  for (int t = 0; t < T; ++t) {
    const float* xt = xb + (size_t)t * h4;
    for (int j = threadIdx.x; j < h4; j += blockDim.x) {
      // column j of h @ wh: consecutive threads read consecutive words of
      // each row of wh, and every thread reads the same h[k] (a broadcast)
      float acc = 0.0f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) acc = fmaf(h[k], wh[(size_t)k * h4 + j], acc);
      const float g = xt[j] + acc;
      gates[j] = (j >= 2 * H && j < 3 * H) ? tanhf(g) : sigmoid(g);
    }
    __syncthreads();  // all reads of h done, all gates written
    for (int n = threadIdx.x; n < H; n += blockDim.x) {
      const float c_new = gates[H + n] * c[n] + gates[n] * gates[2 * H + n];
      const float h_new = gates[3 * H + n] * tanhf(c_new);
      c[n] = c_new;
      h[n] = h_new;
      hsb[(size_t)t * H + n] = h_new;
      csb[(size_t)t * H + n] = c_new;
    }
    __syncthreads();  // the new h is complete before the next step reads it
  }
  for (int n = threadIdx.x; n < H; n += blockDim.x) {
    h_last[(size_t)b * H + n] = h[n];
    c_last[(size_t)b * H + n] = c[n];
  }
}

}  // namespace

extern "C" int lstm_forward(const float* xp, const float* wh, const float* h0,
                            const float* c0, float* hs, float* cs,
                            float* h_last, float* c_last, int B, int T, int H,
                            void* stream) {
  const int h4 = 4 * H;
  int threads = ((h4 + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = (size_t)6 * H * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lstm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  lstm_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      xp, wh, h0, c0, hs, cs, h_last, c_last, T, H);
  return (int)cudaGetLastError();
}

extern "C" const char* lstm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
