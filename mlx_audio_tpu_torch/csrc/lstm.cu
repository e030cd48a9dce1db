// LSTM recurrence in one launch: the Hopper counterpart of
// mlx_audio_tpu/nn/pallas_ops.py::_lstm_kernel / lstm_pallas.
//
// Computes, for every batch row b and step t = 0 .. T-1,
//   gates = x_proj[b, t] + h @ wh            (wh is [H, 4H], torch order i,f,g,o)
//   c     = sigmoid(f) * c + sigmoid(i) * tanh(g)
//   h     = sigmoid(o) * tanh(c)
// and writes every h and c ([B, T, H] each) plus the final (h_T, c_T), with
// the state carried in float32.
//
// What bounds it on this card: the chain of T dependent steps.  Step t needs
// all of h from step t-1, and the whole call's bytes and FLOPs (x_proj and
// the outputs moved once, 2 B T H 4H operations) are a few tens of
// microseconds of the card, so the time is T times the latency of one step.
// The TPU kernel ran its grid over T in order and kept the state in scratch
// between grid steps; here the time loop lives inside the kernel.
//
// The cluster route (lstm_cluster_kernel): one thread-block cluster of
// LSTM_CLUSTER = 8 CTAs a batch row.  CTA r owns hidden units
// [r H/8, (r+1) H/8) and their four gate columns {g H + u}, so the cell
// update is local and only h crosses CTAs.  Its slice of wh, [H, 4H/8]
// (128 KB at H = 256), is loaded once before the time loop and kept in
// registers (64 floats a thread at 512 threads): no step reads wh from L2.
// A step:
//   1. every column's H-long dot is split over 4 threads (a quarter of k
//      each, 4 independent accumulators); the partials go to shared memory;
//   2. one __syncthreads; 4 threads a unit (one a gate) add the 4 partials
//      in ascending order, add x_proj (prefetched 3 steps ahead with
//      cp.async), apply sigmoid or tanh, and hand the gates to the unit's
//      first lane by warp shuffles, which updates c and h;
//   3. the unit's h is stored into every CTA's h buffer through distributed
//      shared memory.  h is double buffered by step parity, so one cluster
//      barrier (barrier.cluster.arrive.release + wait.acquire) a step is all
//      the synchronisation across CTAs; h and c go to global memory between
//      its arrive and its wait.
// So a step costs one DSMEM exchange, one cluster barrier, one block
// barrier and a 16-FMA-deep dot, not an L2 stream.  Every output's sum
// order depends on H alone, so two launches give equal bits whatever B, T
// or the cluster size.
//
// The row route (lstm_row_kernel) takes the H the cluster route does not
// (lstm_route): one block a batch row, one thread a gate column, wh read
// from L2 every step.
//
// Build variants (scripts/tune_lstm.py): -DLSTM_CLUSTER=4|8|16 (CTAs a
// row), -DLSTM_WH_REGS=n (the first n of a thread's quarter of k in
// registers, the rest in shared memory), -DLSTM_SYNC_ONLY (no arithmetic:
// the exchange and the barriers alone, the least a step of this design can
// take; its results are not the LSTM's).  Two more knobs were measured on
// the card and dropped: x_proj 1 or 7 steps ahead instead of 3 tied or lost,
// and storing h and c before the barrier's arrive instead of between arrive
// and wait lost (PERF.md, row 1 of the kernel table).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#ifndef LSTM_CLUSTER
#define LSTM_CLUSTER 8
#endif
#ifndef LSTM_WH_REGS
#define LSTM_WH_REGS 64
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = LSTM_CLUSTER;  // CTAs a batch row
constexpr int kSplit = 4;               // threads a gate column, a quarter of k each
constexpr int kMaxK = 64;               // most of k one thread sums
constexpr int kMaxH = kSplit * kMaxK;   // 256
constexpr int kWhRegs = LSTM_WH_REGS < kMaxK ? LSTM_WH_REGS : kMaxK;
constexpr int kMaxThreads = 4 * kSplit * kMaxH / kCluster;
constexpr int kGatePad = 8;             // keeps a warp's partial reads on 32 banks
constexpr int kXDepth = 4;              // steps of x_proj in flight or staged
constexpr size_t kSmemLimit = 232448;   // 227 KB a block

__host__ __device__ constexpr int cluster_threads(int H) {
  return 4 * kSplit * H / kCluster;
}

size_t cluster_smem_bytes(int H) {
  const int units = H / kCluster;
  const int kq = H / kSplit;
  const int in_smem = kq > kWhRegs ? kq - kWhRegs : 0;
  return sizeof(float) *
         (2 * (size_t)H + kSplit * 4 * (size_t)(units + kGatePad) +
          kXDepth * 4 * (size_t)units + (size_t)in_smem * cluster_threads(H));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the most recent n groups complete
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__global__ void __launch_bounds__(kMaxThreads, 1)
    lstm_cluster_kernel(const float* __restrict__ xp,
                            const float* __restrict__ wh,
                            const float* __restrict__ h0,
                            const float* __restrict__ c0,
                            float* __restrict__ hs, float* __restrict__ cs,
                            float* __restrict__ h_last,
                            float* __restrict__ c_last, int T, int H) {
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int b = blockIdx.x / kCluster;
  const int units = H / kCluster;  // hidden units of this CTA
  const int nc = 4 * units;        // its gate columns
  const int kq = H / kSplit;       // k one thread sums
  const int h4 = 4 * H;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int gp = units + kGatePad;  // one gate's partials, padded

  extern __shared__ __align__(16) float smem[];
  float* hbuf = smem;                 // [2][H]: h of the step, by parity
  float* part = hbuf + 2 * H;         // [kSplit][4][gp]: partial dots
  float* xs = part + kSplit * 4 * gp; // [kXDepth][nc]: x_proj, a step a slot
  float* wsm = xs + kXDepth * nc;     // [kq - kWhRegs][nt]: wh not in registers

  // the dot: column j (gate gj, unit uj) of this CTA, quarter q of k
  const int q = tid / nc;
  const int j = tid - q * nc;
  const int gj = j / units, uj = j - gj * units;
  const float* wcol = wh + (size_t)q * kq * h4 + gj * H + r * units + uj;
  float wr[kWhRegs > 0 ? kWhRegs : 1];
#pragma unroll
  for (int k = 0; k < kWhRegs; ++k) wr[k] = k < kq ? wcol[(size_t)k * h4] : 0.0f;
  for (int k = kWhRegs; k < kq; ++k)
    wsm[(k - kWhRegs) * nt + tid] = wcol[(size_t)k * h4];

  // the gates: 4 consecutive threads a unit, thread gg of them gate gg
  const bool gate = tid < nc;
  const int gate_threads = (nc + 31) & ~31;  // whole warps, for the shuffles
  const int gu = tid >> 2, gg = tid & 3;
  const int unit = r * units + gu;
  const float* xcol = xp + (size_t)b * T * h4 + gg * H + unit;
  float c = 0.0f;  // the unit's cell state, in its first lane
  if (gate && gg == 0) c = c0[(size_t)b * H + unit];
  // x_proj runs kXDepth - 1 steps ahead: one cp.async group a step
  for (int s = 0; s < kXDepth - 1; ++s) {
    if (gate && s < T) cp_async4(xs + s * nc + tid, xcol + (size_t)s * h4);
    cp_async_commit();
  }
  for (int k = tid; k < H; k += nt) hbuf[k] = h0[(size_t)b * H + k];
  // every CTA of the cluster runs, and h0 is in place, before any exchange
  cluster.sync();

  for (int t = 0; t < T; ++t) {
    const int p = t & 1;
    const int ahead = t + kXDepth - 1;
    if (gate && ahead < T)
      cp_async4(xs + (ahead & (kXDepth - 1)) * nc + tid, xcol + (size_t)ahead * h4);
    cp_async_commit();
#ifndef LSTM_SYNC_ONLY
    {
      const float4* hq = reinterpret_cast<const float4*>(hbuf + p * H + q * kq);
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
      for (int i = 0; i < kMaxK / 4; ++i) {
        if (4 * i < kq) {
          const float4 hv = hq[i];  // one address a warp: a broadcast
#define LSTM_W(k) ((k) < kWhRegs ? wr[(k) < kWhRegs ? (k) : 0] \
                                 : wsm[((k) - kWhRegs) * nt + tid])
          a0 = fmaf(hv.x, LSTM_W(4 * i), a0);
          a1 = fmaf(hv.y, LSTM_W(4 * i + 1), a1);
          a2 = fmaf(hv.z, LSTM_W(4 * i + 2), a2);
          a3 = fmaf(hv.w, LSTM_W(4 * i + 3), a3);
#undef LSTM_W
        }
      }
      part[(q * 4 + gj) * gp + uj] = (a0 + a1) + (a2 + a3);
    }
#endif
    __syncthreads();  // every partial written
    float hn = 0.0f, cn = 0.0f;
    if (tid < gate_threads) {
      cp_async_wait<kXDepth - 1>();  // this thread's x_proj of step t is in
      float a = 0.0f;
      if (gate) {
        const float x = xs[(t & (kXDepth - 1)) * nc + tid];
#ifdef LSTM_SYNC_ONLY
        a = x;
#else
        const float* pg = part + gg * gp + gu;
        const float dot = ((pg[0] + pg[4 * gp]) + pg[8 * gp]) + pg[12 * gp];
        const float z = x + dot;
        a = gg == 2 ? tanhf(z) : sigmoid(z);
#endif
      }
      const float fa = __shfl_down_sync(0xffffffffu, a, 1);
      const float ga = __shfl_down_sync(0xffffffffu, a, 2);
      const float oa = __shfl_down_sync(0xffffffffu, a, 3);
      if (gg == 0) {
#ifdef LSTM_SYNC_ONLY
        c = fa;
        hn = ga + oa;
#else
        c = fa * c + a * ga;
        hn = oa * tanhf(c);
#endif
      }
      const int lead = tid & 31 & ~3;
      hn = __shfl_sync(0xffffffffu, hn, lead);
      cn = __shfl_sync(0xffffffffu, c, lead);
      if (gate) {
        float* mine = hbuf + (p ^ 1) * H + unit;
        for (int peer = gg; peer < kCluster; peer += 4)
          *cluster.map_shared_rank(mine, peer) = hn;
      }
    }
    const size_t at = ((size_t)b * T + t) * H + unit;
    // the one cluster barrier of the step: the step's h is in every CTA, and
    // every read of this step's buffers is done, before any CTA starts the
    // next step.  The outputs go to global memory between arrive and wait,
    // off the barrier's release (nothing in the kernel reads them).
    __cluster_barrier_arrive();
    if (gate && gg == 0) hs[at] = hn;
    if (gate && gg == 1) cs[at] = cn;
    __cluster_barrier_wait();
  }
  if (gate && gg == 0) {
    h_last[(size_t)b * H + unit] = hbuf[(T & 1) * H + unit];
    c_last[(size_t)b * H + unit] = c;
  }
}

__global__ void __launch_bounds__(1024)
    lstm_row_kernel(const float* __restrict__ xp, const float* __restrict__ wh,
                    const float* __restrict__ h0, const float* __restrict__ c0,
                    float* __restrict__ hs, float* __restrict__ cs,
                    float* __restrict__ h_last, float* __restrict__ c_last,
                    int T, int H) {
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

cudaError_t prepare_cluster(int H) {
  const size_t smem = cluster_smem_bytes(H);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lstm_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  if (kCluster > 8)
    return cudaFuncSetAttribute(lstm_cluster_kernel,
                                cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return cudaSuccess;
}

cudaLaunchConfig_t cluster_config(int B, int H, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * kCluster);
  cfg.blockDim = dim3(cluster_threads(H));
  cfg.dynamicSmemBytes = cluster_smem_bytes(H);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// 1 where the cluster route takes hidden size H, 0 where the row route does:
// a whole quarter of k in float4s (H % 16 == 0), whole units a CTA
// (H % LSTM_CLUSTER == 0), at most 64 of k a thread (H <= 256), whole warps
// and at most 1024 threads a CTA, and the shared memory within a block's.
// nn/kernels.py::lstm_route mirrors it.
extern "C" int lstm_route(int H) {
  if (H < 16 || H > kMaxH || H % 16 || H % kCluster) return 0;
  const int nt = cluster_threads(H);
  if (nt % 32 || nt > 1024) return 0;
  return cluster_smem_bytes(H) <= kSmemLimit;
}

extern "C" int lstm_cluster_size() { return kCluster; }

// cudaOccupancyMaxActiveClusters of the cluster route's launch at H into
// *out: how many batch rows run at once
extern "C" int lstm_max_active_clusters(int H, int* out) {
  if (!lstm_route(H)) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare_cluster(H);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(1, H, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, lstm_cluster_kernel, &cfg);
}

extern "C" int lstm_forward(const float* xp, const float* wh, const float* h0,
                            const float* c0, float* hs, float* cs,
                            float* h_last, float* c_last, int B, int T, int H,
                            int cluster, void* stream) {
  if (cluster) {
    if (!lstm_route(H)) return (int)cudaErrorInvalidValue;
    cudaError_t err = prepare_cluster(H);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(B, H, (cudaStream_t)stream, &attr);
    err = cudaLaunchKernelEx(&cfg, lstm_cluster_kernel, xp, wh, h0, c0, hs,
                             cs, h_last, c_last, T, H);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  const int h4 = 4 * H;
  int threads = ((h4 + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = (size_t)6 * H * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lstm_row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  lstm_row_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      xp, wh, h0, c0, hs, cs, h_last, c_last, T, H);
  return (int)cudaGetLastError();
}

extern "C" const char* lstm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
