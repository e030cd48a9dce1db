// The depth-draft kernel as first ported (one cooperative launch, every
// warp streaming its columns straight from device memory, cg::grid.sync
// between phases), kept only as the baseline variant of
// scripts/tune_depth.py; the port builds and launches depth_draft.cu.
//
// CSM depth-decoder draft, 30 sequential int8 steps in one launch: the
// Hopper counterpart of depth_draft_pallas (mlx_audio_tpu/nn/pallas_depth.py,
// _depth_kernel and depth_draft_pallas).
//
// For one frame and steps s = 0 .. S-1 (position pos = s + 2), it takes the
// input row of token c_{s+1} from the pre-projected embedding slab, runs L
// Llama layers (RMSNorm, int8 q/k/v, RoPE, grouped-query attention over the
// KV cache, int8 o-proj, RMSNorm, int8 SwiGLU MLP), the int8 head of codebook
// s + 2, a top-k mask by 24-step value bisection and a Gumbel argmax on given
// noise, and feeds the token to the next step.  Matrices are int8 [Out, In]
// with symmetric per-128-group scales; activations are quantized per row
// (_quant_row) and each 128-group dot is s8 x s8 -> s32 (__dp4a).
//
// What bounds it on this card: bytes.  Each step streams every weight once,
// about 111 MB at llama-100M (4 layers x 27.8 M plus a 2.2 MB head), 3.4 GB
// a frame, so the floor is about 1 ms a frame at 3.35 TB/s.  One block
// cannot stream that, and a Hopper grid has no order, so the design is one
// cooperative launch with one block of 512 threads on every SM:
//   * each matrix-vector product splits its output columns over all the
//     grid's warps; a warp reads one column's In bytes with 16-byte loads
//     (512 contiguous bytes a warp a load), eight lanes make one group's dot;
//   * the small phases (RMSNorm, quantizing a row, RoPE, attention over at
//     most Cap slots, bisection, argmax) run redundantly in every block, on
//     the block's own copy of the residual in shared memory;
//   * cooperative_groups grid syncs separate the phases: four per layer, one
//     after the head, 17 a step at L = 4.
// The TPU kernel ran the steps as a sequential grid with the KV cache in
// VMEM scratch and double-buffered DMA of the weight chunks; here the cache
// is a working copy in device memory (block 0 writes each new slot) and
// the weight stream is the warps' own loads.
//
// Token exactness against the plain version (nn/pallas_depth.py,
// depth_draft_plain) follows from the same operations in the same order:
// group dots are exact integers, each column adds its groups in ascending
// order as acc + part * (scale * sx), every other reduction that feeds a
// token is taken in float64 and rounded once to float32, and the file is
// compiled with --fmad=false so that no multiply-add is contracted where the
// plain version rounds twice.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 128;
constexpr int kMaxPerThread = 8;  // logits a thread holds: Vp <= 4096
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInv127 = (float)(1.0 / 127.0);

struct Params {
  const int8_t* wqkv;
  const float* sqkv;
  const int8_t* wo;
  const float* so;
  const int8_t* wgu;
  const float* sgu;
  const int8_t* wdown;
  const float* sdown;
  const float* norms;       // [L, 2, Dm]
  const float* final_norm;  // [Dm]
  const int8_t* heads;      // [S, Vp, Dm]
  const float* sheads;      // [S, Vp, Dm / 128]
  const __nv_bfloat16* emb_proj;  // [S, Vp, Dm]
  const float* rope_cos;    // [P, Dh / 2]
  const float* rope_sin;
  float* kc;                // working caches [L, Hkv, Cap, Dh]
  float* vc;
  const float* noise;       // [S, Vp]
  const int* c1;            // [1]
  int* tok_out;             // [S]
  float* qkv;               // scratch [Cqkv]
  float* y;                 // scratch [Dm]
  float* h;                 // scratch [F]
  float* logits;            // scratch [Vp]
  int n_layers, dm, f_inter, hq, hkv, dh, cap, vocab, vpad, n_steps, top_k;
  float temp, attn_scale;
};

struct Scratch {
  double d[kWarps];
  float f[kWarps];
  int i[kWarps];
};

// -- block reductions: every thread returns the same value ------------------

__device__ double block_sum(double v, Scratch& sc) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  __syncthreads();  // the scratch's previous readers are done
  if (threadIdx.x % 32 == 0) sc.d[threadIdx.x / 32] = v;
  __syncthreads();
  double t = 0.0;
  for (int w = 0; w < kWarps; ++w) t += sc.d[w];
  return t;
}

__device__ int block_sum(int v, Scratch& sc) {
  v = __reduce_add_sync(kFull, v);
  __syncthreads();
  if (threadIdx.x % 32 == 0) sc.i[threadIdx.x / 32] = v;
  __syncthreads();
  int t = 0;
  for (int w = 0; w < kWarps; ++w) t += sc.i[w];
  return t;
}

template <bool kMax>
__device__ float block_extreme(float v, Scratch& sc) {
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(kFull, v, off);
    v = kMax ? fmaxf(v, o) : fminf(v, o);
  }
  __syncthreads();
  if (threadIdx.x % 32 == 0) sc.f[threadIdx.x / 32] = v;
  __syncthreads();
  float t = sc.f[0];
  for (int w = 1; w < kWarps; ++w) t = kMax ? fmaxf(t, sc.f[w]) : fminf(t, sc.f[w]);
  return t;
}

// (value, index) with ties to the lower index, as jnp.argmax and torch.argmax
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ int block_argmax(float v, int i, Scratch& sc) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
  __syncthreads();
  if (threadIdx.x % 32 == 0) {
    sc.f[threadIdx.x / 32] = v;
    sc.i[threadIdx.x / 32] = i;
  }
  __syncthreads();
  float bv = sc.f[0];
  int bi = sc.i[0];
  for (int w = 1; w < kWarps; ++w)
    if (better(sc.f[w], sc.i[w], bv, bi)) { bv = sc.f[w]; bi = sc.i[w]; }
  return bi;
}

// -- row operations (every block, on its own copy) ---------------------------

// out = x * rsqrt(mean(x^2) + 1e-5) * w, the mean in float64
__device__ void rms(const float* x, const float* w, int n, float* out,
                    Scratch& sc) {
  double s = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) s += (double)x[i] * (double)x[i];
  s = block_sum(s, sc);
  const float r = rsqrtf((float)(s / (double)n) + 1e-5f);
  for (int i = threadIdx.x; i < n; i += kThreads) out[i] = x[i] * r * w[i];
  __syncthreads();
}

// symmetric per-row int8: xq = clip(rint(x * 127 / amax), +-127); returns
// the row's scale amax / 127.  kGlobal: src was written by other blocks.
template <bool kGlobal>
__device__ float quant_row(const float* src, int n, int8_t* xq, Scratch& sc) {
  float m = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads)
    m = fmaxf(m, fabsf(kGlobal ? __ldcg(src + i) : src[i]));
  const float amax = fmaxf(block_extreme<true>(m, sc), 1e-30f);
  const float inv = 127.0f / amax;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float r = rintf((kGlobal ? __ldcg(src + i) : src[i]) * inv);
    xq[i] = (int8_t)fminf(fmaxf(r, -127.0f), 127.0f);
  }
  __syncthreads();
  return amax * kInv127;
}

// One output column: sum over 128-groups g, in order, of
// part_g * (scale_g * sx), part_g the exact s8 dot of the group.  Called by
// a whole warp; every lane returns the column's value.
__device__ float column_dot(const int8_t* __restrict__ wrow,
                            const float* __restrict__ srow, const int8_t* xq,
                            int in, float sx) {
  const int lane = threadIdx.x % 32;
  const int groups = in / kGroup;
  float acc = 0.0f;
  for (int base = 0; base < in; base += 4 * 512) {
    int4 wv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * 512 + lane * 16;
      wv[u] = i < in ? __ldcs(reinterpret_cast<const int4*>(wrow + i))
                     : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * 512 + lane * 16;
      int part = 0;
      if (i < in) {
        const int4 xv = *reinterpret_cast<const int4*>(xq + i);
        part = __dp4a(wv[u].x, xv.x, part);
        part = __dp4a(wv[u].y, xv.y, part);
        part = __dp4a(wv[u].z, xv.z, part);
        part = __dp4a(wv[u].w, xv.w, part);
      }
      // eight lanes hold one group
      part += __shfl_xor_sync(kFull, part, 4);
      part += __shfl_xor_sync(kFull, part, 2);
      part += __shfl_xor_sync(kFull, part, 1);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int pk = __shfl_sync(kFull, part, 8 * k);
        const int g = (base + u * 512) / kGroup + k;
        if (g < groups) acc = acc + (float)pk * (srow[g] * sx);
      }
    }
  }
  return acc;
}

// RoPE on q and the new k, attention of the Hq heads over slots 0..pos
// (slot pos from this step's k and v), output [Hq * Dh] into out.  Block 0
// writes the new k and v into the working cache for the later steps.
__device__ void attention(const Params& p, int l, int pos, float* qv,
                          float* probs, float* out, Scratch& sc) {
  const int dh = p.dh, half = dh / 2, hq = p.hq, hkv = p.hkv, cap = p.cap;
  const int rep = hq / hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* c = p.rope_cos + (size_t)pos * half;
  const float* sn = p.rope_sin + (size_t)pos * half;
  for (int n = tid; n < (hq + hkv) * half; n += kThreads) {
    const int head = n / half, d = n % half;
    const float t1 = __ldcg(p.qkv + head * dh + d);
    const float t2 = __ldcg(p.qkv + head * dh + d + half);
    qv[head * dh + d] = t1 * c[d] - t2 * sn[d];
    qv[head * dh + d + half] = t2 * c[d] + t1 * sn[d];
  }
  for (int n = tid; n < hkv * dh; n += kThreads)
    qv[(hq + hkv) * dh + n] = __ldcg(p.qkv + (hq + hkv) * dh + n);
  __syncthreads();
  const float* knew = qv + hq * dh;
  const float* vnew = qv + (hq + hkv) * dh;
  float* kc = p.kc + (size_t)l * hkv * cap * dh;
  float* vc = p.vc + (size_t)l * hkv * cap * dh;
  if (blockIdx.x == 0) {
    for (int n = tid; n < hkv * dh; n += kThreads) {
      const size_t at = ((size_t)(n / dh) * cap + pos) * dh + n % dh;
      kc[at] = knew[n];
      vc[at] = vnew[n];
    }
  }
  // scores, one warp a (head, slot) pair
  const int slots = pos + 1;
  for (int pr = warp; pr < hq * slots; pr += kWarps) {
    const int hh = pr / slots, j = pr % slots, kvh = hh / rep;
    double acc = 0.0;
    for (int d = lane; d < dh; d += 32) {
      const float kv = j == pos ? knew[kvh * dh + d]
                                : __ldcg(kc + ((size_t)kvh * cap + j) * dh + d);
      acc += (double)qv[hh * dh + d] * (double)kv;
    }
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
    if (lane == 0) probs[hh * cap + j] = (float)acc * p.attn_scale;
  }
  __syncthreads();
  // softmax, one warp a head: e = exp(s - max), p = e / sum(e)
  for (int hh = warp; hh < hq; hh += kWarps) {
    float* row = probs + hh * cap;
    float m = -INFINITY;
    for (int j = lane; j < slots; j += 32) m = fmaxf(m, row[j]);
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    double ssum = 0.0;
    for (int j = lane; j < slots; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      ssum += (double)e;
    }
    for (int off = 16; off > 0; off >>= 1) ssum += __shfl_xor_sync(kFull, ssum, off);
    const float denom = (float)ssum;
    for (int j = lane; j < slots; j += 32) row[j] = row[j] / denom;
  }
  __syncthreads();
  for (int n = tid; n < hq * dh; n += kThreads) {
    const int hh = n / dh, d = n % dh, kvh = hh / rep;
    double acc = 0.0;
    for (int j = 0; j < slots; ++j) {
      const float vv = j == pos ? vnew[kvh * dh + d]
                                : __ldcg(vc + ((size_t)kvh * cap + j) * dh + d);
      acc += (double)probs[hh * cap + j] * (double)vv;
    }
    out[n] = (float)acc;
  }
  __syncthreads();
}

// temperature, bisection top-k, Gumbel noise and argmax over the logits
__device__ int sample(const Params& p, int s, Scratch& sc) {
  float z[kMaxPerThread];
  const int vpad = p.vpad;
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int i = threadIdx.x + k * kThreads;
    z[k] = i < vpad ? __ldcg(p.logits + i) : -INFINITY;
  }
  if (p.temp > 0.0f) {
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) z[k] = z[k] / p.temp;
    if (p.top_k > 0 && p.top_k < p.vocab) {
      float lo = INFINITY, hi = -INFINITY;
#pragma unroll
      for (int k = 0; k < kMaxPerThread; ++k) {
        const int i = threadIdx.x + k * kThreads;
        if (i < p.vocab) lo = fminf(lo, z[k]);
        hi = fmaxf(hi, z[k]);
      }
      lo = block_extreme<false>(lo, sc);
      hi = block_extreme<true>(hi, sc);
      for (int it = 0; it < 24; ++it) {
        const float mid = 0.5f * (lo + hi);
        int cnt = 0;
#pragma unroll
        for (int k = 0; k < kMaxPerThread; ++k) cnt += z[k] >= mid;
        if (block_sum(cnt, sc) >= p.top_k) lo = mid; else hi = mid;
      }
#pragma unroll
      for (int k = 0; k < kMaxPerThread; ++k) z[k] = z[k] >= lo ? z[k] : -INFINITY;
    }
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < vpad) z[k] = z[k] + p.noise[(size_t)s * vpad + i];
    }
  }
  float bv = -INFINITY;
  int bi = vpad;
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < vpad && better(z[k], i, bv, bi)) { bv = z[k]; bi = i; }
  }
  return block_argmax(bv, bi, sc);
}

__global__ void __launch_bounds__(kThreads, 1) depth_draft_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Scratch sc;
  const int dm = p.dm, hd = p.hq * p.dh, f = p.f_inter;
  const int cqkv = (p.hq + 2 * p.hkv) * p.dh;
  const int widest = max(max(dm, hd), f);
  int8_t* xq = reinterpret_cast<int8_t*>(smem);
  float* x = reinterpret_cast<float*>(smem + ((widest + 15) / 16) * 16);
  float* xn = x + dm;
  float* qv = xn + max(dm, hd);
  float* probs = qv + cqkv;
  const int lane = threadIdx.x % 32;
  const int gwarp = blockIdx.x * kWarps + threadIdx.x / 32;
  const int nwarps = gridDim.x * kWarps;
  const int gd = dm / kGroup, gh = hd / kGroup, gf = f / kGroup;

  int tok = *p.c1;
  for (int s = 0; s < p.n_steps; ++s) {
    const int pos = s + 2;
    const __nv_bfloat16* erow = p.emb_proj + ((size_t)s * p.vpad + tok) * dm;
    for (int i = threadIdx.x; i < dm; i += kThreads) x[i] = __bfloat162float(erow[i]);
    __syncthreads();
    for (int l = 0; l < p.n_layers; ++l) {
      // q, k, v
      rms(x, p.norms + (size_t)(2 * l) * dm, dm, xn, sc);
      float sx = quant_row<false>(xn, dm, xq, sc);
      const int8_t* w = p.wqkv + (size_t)l * cqkv * dm;
      const float* sw = p.sqkv + (size_t)l * cqkv * gd;
      for (int o = gwarp; o < cqkv; o += nwarps) {
        const float v = column_dot(w + (size_t)o * dm, sw + (size_t)o * gd, xq, dm, sx);
        if (lane == 0) p.qkv[o] = v;
      }
      grid.sync();
      // attention, o-proj
      attention(p, l, pos, qv, probs, xn, sc);
      sx = quant_row<false>(xn, hd, xq, sc);
      w = p.wo + (size_t)l * dm * hd;
      sw = p.so + (size_t)l * dm * gh;
      for (int o = gwarp; o < dm; o += nwarps) {
        const float v = column_dot(w + (size_t)o * hd, sw + (size_t)o * gh, xq, hd, sx);
        if (lane == 0) p.y[o] = v;
      }
      grid.sync();
      // residual, gate and up: one warp makes h[j] = silu(gate_j) * up_j
      for (int i = threadIdx.x; i < dm; i += kThreads) x[i] = x[i] + __ldcg(p.y + i);
      __syncthreads();
      rms(x, p.norms + (size_t)(2 * l + 1) * dm, dm, xn, sc);
      sx = quant_row<false>(xn, dm, xq, sc);
      w = p.wgu + (size_t)l * 2 * f * dm;
      sw = p.sgu + (size_t)l * 2 * f * gd;
      for (int j = gwarp; j < f; j += nwarps) {
        const float g = column_dot(w + (size_t)j * dm, sw + (size_t)j * gd, xq, dm, sx);
        const float u = column_dot(w + (size_t)(f + j) * dm, sw + (size_t)(f + j) * gd,
                                   xq, dm, sx);
        // silu as PyTorch writes it: x / (1 + exp(-x))
        if (lane == 0) p.h[j] = g / (1.0f + expf(-g)) * u;
      }
      grid.sync();
      // down
      sx = quant_row<true>(p.h, f, xq, sc);
      w = p.wdown + (size_t)l * dm * f;
      sw = p.sdown + (size_t)l * dm * gf;
      for (int o = gwarp; o < dm; o += nwarps) {
        const float v = column_dot(w + (size_t)o * f, sw + (size_t)o * gf, xq, f, sx);
        if (lane == 0) p.y[o] = v;
      }
      grid.sync();
      for (int i = threadIdx.x; i < dm; i += kThreads) x[i] = x[i] + __ldcg(p.y + i);
      __syncthreads();
    }
    // head of codebook s + 2
    rms(x, p.final_norm, dm, xn, sc);
    const float sx = quant_row<false>(xn, dm, xq, sc);
    const int8_t* w = p.heads + (size_t)s * p.vpad * dm;
    const float* sw = p.sheads + (size_t)s * p.vpad * gd;
    for (int o = gwarp; o < p.vpad; o += nwarps) {
      const float v = column_dot(w + (size_t)o * dm, sw + (size_t)o * gd, xq, dm, sx);
      if (lane == 0) p.logits[o] = o < p.vocab ? v : -INFINITY;
    }
    grid.sync();
    tok = sample(p, s, sc);
    if (blockIdx.x == 0 && threadIdx.x == 0) p.tok_out[s] = tok;
  }
}

}  // namespace

extern "C" int depth_draft_forward(
    const int8_t* wqkv, const float* sqkv, const int8_t* wo, const float* so,
    const int8_t* wgu, const float* sgu, const int8_t* wdown,
    const float* sdown, const float* norms, const float* final_norm,
    const int8_t* heads, const float* sheads, const void* emb_proj,
    const float* rope_cos, const float* rope_sin, float* kc, float* vc,
    const float* noise, const int* c1, int* tok_out, float* qkv, float* y,
    float* h, float* logits, int n_layers, int dm, int f_inter, int hq,
    int hkv, int dh, int cap, int vocab, int vpad, int n_steps, int top_k,
    int rope_rows, float temp, float attn_scale, void* stream) {
  const int hd = hq * dh;
  if (dm % kGroup || hd % kGroup || f_inter % kGroup || dh % 2 || hkv < 1 ||
      hq % hkv || vpad > kThreads * kMaxPerThread || vocab < 1 ||
      vocab > vpad || n_steps + 2 > cap || n_steps + 2 > rope_rows)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  const int widest = dm > hd ? dm : hd;
  const int widest_in = widest > f_inter ? widest : f_inter;
  const size_t smem = (size_t)((widest_in + 15) / 16) * 16 +
                      sizeof(float) * ((size_t)dm + widest +
                                       (size_t)(hq + 2 * hkv) * dh +
                                       (size_t)hq * cap);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(depth_draft_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, depth_draft_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  Params p{wqkv, sqkv, wo, so, wgu, sgu, wdown, sdown, norms, final_norm,
           heads, sheads, reinterpret_cast<const __nv_bfloat16*>(emb_proj),
           rope_cos, rope_sin, kc, vc, noise, c1, tok_out, qkv, y, h, logits,
           n_layers, dm, f_inter, hq, hkv, dh, cap, vocab, vpad, n_steps,
           top_k, temp, attn_scale};
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)depth_draft_kernel, dim3(sms),
                                    dim3(kThreads), args, smem,
                                    (cudaStream_t)stream);
  return (int)err;
}

extern "C" const char* depth_draft_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
