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
// a frame, so the floor is about 1 ms a frame at 3.35 TB/s.  But the step is
// a chain of dependent matrix-vector products, 4 a layer and the head, each
// of which needs the whole previous activation, so every product's outputs
// must reach every SM before the next starts.  The weights do not depend on
// any activation, so the design keeps their stream running through those
// exchanges and keeps the exchanges themselves short:
//   * one cooperative launch (all CTAs resident), one CTA of 9 warps on
//     every SM; each CTA owns a fixed, contiguous range of output columns of
//     every matrix (gate and up rows j and F + j together), so its share of
//     a phase is one contiguous run of bytes (two for gate/up);
//   * one producer warp walks the CTA's schedule for all S steps (L x 4
//     phases and the head a step), cutting each range into tiles of whole
//     columns of at most 16 KB, and copies each tile into the next stage of a
//     ring in shared memory: the weights with cp.async.bulk, the scales with
//     4-byte cp.async, both completing on the stage's "full" mbarrier.  It
//     waits only for the stage's "empty" mbarrier, never for another CTA, so
//     it runs a ring ahead, across phases and steps;
//   * 8 consumer warps split into teams, as many as the phase has tiles (one
//     tile: all 8 warps; eight: a warp each), and take the tiles round robin:
//     a lane computes a 128-group's exact dot, then one lane a column folds
//     them; every warp waits for every tile and arrives on its empty
//     barrier, so no warp falls a phase of a stage behind;
//   * a product's outputs go to device memory as 64-bit words, the float's
//     bits and the step's tag, in a region of their own (two steps' regions
//     of an exchange that lives across launches); a CTA reads a vector by
//     polling its words until every tag is the step's.  The data is its own
//     flag: no grid barrier, no fence, one trip to L2 and back.  A launch
//     tags its steps tag_base + 1 .. tag_base + S, and the caller advances
//     tag_base by S each launch, so every word of an earlier launch carries a
//     smaller tag and the exchange is zeroed only when it is allocated;
//   * the small phases (RMSNorm, quantizing a row, RoPE, attention over at
//     most S + 2 slots, bisection, argmax) run redundantly in every CTA's
//     consumer warps, on the CTA's own copy of the residual.  Every CTA
//     writes each new k and v row to the working cache (the same bits from
//     every CTA); its producer brings a layer's earlier rows back through the
//     ring, a tile a kv head, just before the layer's o-proj tiles; the
//     RMSNorm weights and the RoPE rows come by bulk copies a phase ahead.
// The TPU kernel ran the steps as a sequential grid with the KV cache in
// VMEM scratch and double-buffered DMA of the weight chunks.
//
// Token exactness against the plain version (nn/pallas_depth.py,
// depth_draft_plain) follows from the same operations in the same order:
// group dots are exact integers, each column adds its groups in ascending
// order as acc + part * (scale * sx), every other reduction that feeds a
// token is taken in float64 and rounded once to float32, and the file is
// compiled with --fmad=false so that no multiply-add is contracted where the
// plain version rounds twice.
//
// Build variants (scripts/tune_depth.py): -DDRAFT_PHASE_CLOCKS makes CTA 0
// stamp clock64 at each phase boundary of three steps and count the cycles
// spent waiting for tiles and for other CTAs' outputs (depth_draft_clocks);
// -DDRAFT_NO_STREAM copies no weights (its tokens are not the draft's: it
// times the serial path alone, everything but the stream).
//
// Designs measured and dropped (H100 80GB HBM3 at 700 W, llama-100M, 30
// steps, scripts/tune_depth.py, against 3.70-3.72 ms greedy for this one):
// the consumers reading the scales from L2 instead of through the ring, 0.78
// ms slower; the ring cut from 11 stages to 6, 0.30 ms slower; a grid
// barrier of one counter before each exchanged vector is read instead of
// polling the tagged words, 4.60-4.61 ms.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace cg = cooperative_groups;

namespace {

// 8 consumer warps leave a thread up to 168 registers (17 warps leave 96,
// and the spills then go through an L1 that 227 KB of shared memory leaves
// too small to hold them)
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kGroup = 128;
constexpr int kMaxPerThread = 16;  // logits a consumer thread holds: Vp <= 4096
constexpr int kMaxF = 32 * kConsumers;  // h values a consumer thread holds: 32
constexpr int kStageW = 16384;    // weight bytes a stage: a tile's columns
constexpr int kStageS = kStageW / kGroup * 4;  // its scales
constexpr int kStageBytes = kStageW + kStageS;
constexpr int kMaxStages = 16;
constexpr int kMaxTileCols = 32;  // columns a tile: one lane folds each
constexpr int kPerLane = kStageW / kGroup / 32;  // groups a lane a tile
constexpr int kMaxRep = 8;  // query heads a key/value head
constexpr int kMaxLayers = 8;  // one "k and v written" barrier each
constexpr int kConsumerBar = 1;   // named barrier id of the consumer warps
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
  uint64_t* xch;            // [2, L (Cqkv + 2 Dm + F) + Vp]
  int n_layers, dm, f_inter, hq, hkv, dh, cap, vocab, vpad, n_steps, top_k;
  int stages;               // ring stages
  float temp, attn_scale;
  // every word of xch carries a tag <= tag_base.  Last, so that the fields
  // above keep their offsets: at the 168-register cap ptxas's allocation
  // turned on them (this field placed after xch cost 112 bytes of spills
  // and 0.4 ms a draft on an H100).
  uint32_t tag_base;
};

// phase kinds: the product, and the exchange of its outputs
enum Kind { kQkv = 0, kO = 1, kGateUp = 2, kDown = 3, kHead = 4 };

#ifdef DRAFT_PHASE_CLOCKS
// CTA 0's thread 0 stamps clock64 in three steps (0, S / 2, S - 1): at the
// step's start (slot 0), kLayerStamps times a layer (slot 1 + 16 l + k, k as
// scripts/tune_depth.py names them), then kHeadStamps times in the head;
// %globaltimer too at the step's first and last stamp
constexpr int kClockLayers = 8;
constexpr int kLayerStamps = 16;
constexpr int kHeadStamps = 3;
constexpr int kClockSlots = 1 + kLayerStamps * kClockLayers + kHeadStamps;
__device__ unsigned long long g_clocks[3][kClockSlots][2];
// CTA 0's thread 0, cycles waiting on full stages, by phase kind
__device__ unsigned long long g_wait[5];
// every CTA's thread 0, cycles polling for other CTAs' outputs, by kind
constexpr int kClockCtas = 256;
__device__ unsigned long long g_xwait[kClockCtas][5];
// CTA 0's teams: cycles computing tiles, and tiles, by phase kind
__device__ unsigned long long g_compute[5][2];
// CTA 0's tiles of step S / 2, by their index in the step: kind, the
// team's first warp, clock64 when that warp found the tile full, and when
// its team had computed it
constexpr int kTimelineTiles = 96;
__device__ unsigned long long g_timeline[kTimelineTiles][4];
__shared__ long long s_timeline_base;  // the step's first tile, or -1
// the same counts while the launch runs, in shared memory
__shared__ unsigned long long s_tile_wait[5];
__shared__ unsigned long long s_xwait[5];
__shared__ unsigned long long s_compute[5][2];

__device__ __forceinline__ void stamp(const Params& p, int s, int slot) {
  const int row = s == 0 ? 0 : s == p.n_steps / 2 ? 1 : s == p.n_steps - 1 ? 2 : -1;
  if (row < 0 || blockIdx.x != 0 || threadIdx.x != 0 || slot >= kClockSlots) return;
  unsigned long long t = 0;  // %globaltimer is slow to read: the step's ends only
  if (slot == 0 || slot == kLayerStamps * p.n_layers + kHeadStamps)
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  g_clocks[row][slot][0] = t;
  g_clocks[row][slot][1] = (unsigned long long)clock64();
}
#define STAMP(s, slot) stamp(p, s, slot)
#define LAYER_STAMP(s, l, k) STAMP(s, 1 + kLayerStamps * (l) + (k))
#define CLOCK_START(t) const long long t = clock64()
#define CLOCK_ADD(counter, t) \
  if (threadIdx.x == 0) counter += clock64() - (t)
#else
#define STAMP(s, slot) ((void)0)
#define LAYER_STAMP(s, l, k) ((void)0)
#define CLOCK_START(t) ((void)0)
#define CLOCK_ADD(counter, t) ((void)0)
#endif

// -- synchronisation -------------------------------------------------------------

// A wait that has spun this many times is a fault of the kernel (a schedule
// the producer and the consumers do not share, an output never written):
// trap, so that the launch fails instead of holding the card.
constexpr unsigned kSpinLimit = 1u << 24;

__device__ __forceinline__ void wait_stage(uint64_t* bar, uint32_t parity) {
  for (unsigned n = 0; !bulk::mbar_try_wait(bar, parity); ++n)
    if (n == kSpinLimit) __trap();
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;" ::"r"(kConsumerBar), "r"(kConsumers) : "memory");
}

// a product's output: the float's bits and the step's tag in one 64-bit word
__device__ __forceinline__ void put(uint64_t* at, float v, uint32_t tag) {
  const uint64_t w = ((uint64_t)tag << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(at), "l"(w) : "memory");
}

__device__ __forceinline__ uint64_t peek(const uint64_t* at) {
  uint64_t w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(w) : "l"(at) : "memory");
  return w;
}

// Waits until every one of a thread's words w[k] (loaded from src[i_k],
// i_k = base + threadIdx.x + k * kConsumers, those below n) carries the tag:
// the stale ones are loaded again together, one trip to L2 a round.
template <int K>
__device__ __forceinline__ void settle(const uint64_t* src, int base, int n,
                                       uint32_t tag, uint64_t (&w)[K]) {
  for (unsigned round = 0;; ++round) {
    bool stale = false;
#pragma unroll
    for (int k = 0; k < K; ++k)
      stale |= base + (int)threadIdx.x + k * kConsumers < n && (uint32_t)(w[k] >> 32) != tag;
    if (!stale) return;
    if (round == kSpinLimit) __trap();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = base + threadIdx.x + k * kConsumers;
      if (i < n && (uint32_t)(w[k] >> 32) != tag) w[k] = peek(src + i);
    }
  }
}

// loads a thread's words of src, K a thread, from base
template <int K>
__device__ __forceinline__ void load_words(const uint64_t* src, int base, int n,
                                           uint64_t (&w)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = base + threadIdx.x + k * kConsumers;
    w[k] = i < n ? peek(src + i) : 0;
  }
}

__device__ __forceinline__ float value_of(uint64_t w) {
  return __uint_as_float((uint32_t)w);
}

// dst[i] = (kAdd ? dst[i] : 0) + v_i for the n tagged words of src
template <bool kAdd>
__device__ void gather(const uint64_t* src, int n, uint32_t tag, float* dst) {
  constexpr int kPer = 4;
  for (int base = 0; base < n; base += kPer * kConsumers) {
    uint64_t w[kPer];
    load_words(src, base, n, w);
    settle(src, base, n, tag, w);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = base + threadIdx.x + k * kConsumers;
      if (i < n) dst[i] = kAdd ? dst[i] + value_of(w[k]) : value_of(w[k]);
    }
  }
}

// -- block reductions over the consumer threads: each returns the same
// value; two scratch buffers taken in turn need one barrier a reduction

struct Scratch {
  double d[kConsumerWarps];
  float f[kConsumerWarps];
  int i[kConsumerWarps];
};

struct Red {
  Scratch* sc;  // [2]
  int turn;
  __device__ Scratch& next() {
    Scratch& s = sc[turn];
    turn ^= 1;
    return s;
  }
};

__device__ double block_sum(double v, Red& red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  Scratch& sc = red.next();
  if (threadIdx.x % 32 == 0) sc.d[threadIdx.x / 32] = v;
  consumer_sync();
  double t = 0.0;
  for (int w = 0; w < kConsumerWarps; ++w) t += sc.d[w];
  return t;
}

__device__ int block_sum(int v, Red& red) {
  v = __reduce_add_sync(kFull, v);
  Scratch& sc = red.next();
  if (threadIdx.x % 32 == 0) sc.i[threadIdx.x / 32] = v;
  consumer_sync();
  int t = 0;
  for (int w = 0; w < kConsumerWarps; ++w) t += sc.i[w];
  return t;
}

template <bool kMax>
__device__ float block_extreme(float v, Red& red) {
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(kFull, v, off);
    v = kMax ? fmaxf(v, o) : fminf(v, o);
  }
  Scratch& sc = red.next();
  if (threadIdx.x % 32 == 0) sc.f[threadIdx.x / 32] = v;
  consumer_sync();
  float t = sc.f[0];
  for (int w = 1; w < kConsumerWarps; ++w) t = kMax ? fmaxf(t, sc.f[w]) : fminf(t, sc.f[w]);
  return t;
}

// (value, index) with ties to the lower index, as jnp.argmax and torch.argmax
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ int block_argmax(float v, int i, Red& red) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
  Scratch& sc = red.next();
  if (threadIdx.x % 32 == 0) {
    sc.f[threadIdx.x / 32] = v;
    sc.i[threadIdx.x / 32] = i;
  }
  consumer_sync();
  float bv = sc.f[0];
  int bi = sc.i[0];
  for (int w = 1; w < kConsumerWarps; ++w)
    if (better(sc.f[w], sc.i[w], bv, bi)) { bv = sc.f[w]; bi = sc.i[w]; }
  return bi;
}

// -- row operations (every CTA, on its own copy) ------------------------------

__device__ __forceinline__ int8_t quant(float v, float inv) {
  return (int8_t)fminf(fmaxf(rintf(v * inv), -127.0f), 127.0f);
}

// xq = the symmetric per-row int8 of xn = x * rsqrt(mean(x^2) + 1e-5) * w
// (the mean in float64; xn itself is not kept): clip(rint(xn * 127 / amax),
// +-127); returns the row's scale amax / 127.  x and w in shared memory.
__device__ float rms_quant(const float* x, const float* w, int n, int8_t* xq,
                           Red& red) {
  double s = 0.0;
  for (int i = threadIdx.x; i < n; i += kConsumers) s += (double)x[i] * (double)x[i];
  s = block_sum(s, red);
  const float r = rsqrtf((float)(s / (double)n) + 1e-5f);
  float m = 0.0f;
  for (int i = threadIdx.x; i < n; i += kConsumers) m = fmaxf(m, fabsf(x[i] * r * w[i]));
  const float amax = fmaxf(block_extreme<true>(m, red), 1e-30f);
  const float inv = 127.0f / amax;
  for (int i = threadIdx.x; i < n; i += kConsumers) xq[i] = quant(x[i] * r * w[i], inv);
  consumer_sync();
  return amax * kInv127;
}

// The same quantization of a row in shared memory.
__device__ float quant_row(const float* src, int n, int8_t* xq, Red& red) {
  float m = 0.0f;
  for (int i = threadIdx.x; i < n; i += kConsumers) m = fmaxf(m, fabsf(src[i]));
  const float amax = fmaxf(block_extreme<true>(m, red), 1e-30f);
  const float inv = 127.0f / amax;
  for (int i = threadIdx.x; i < n; i += kConsumers) xq[i] = quant(src[i], inv);
  consumer_sync();
  return amax * kInv127;
}

// The same of the n <= kMaxF tagged words other CTAs wrote, each read once
// and kept in registers.
__device__ float quant_exchanged(const uint64_t* src, int n, uint32_t tag, int8_t* xq,
                                 Red& red) {
  constexpr int kMax = kMaxF / kConsumers, kHalf = kMax / 2;
  float v[kMax];
  float m = 0.0f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // two rounds of loads, half the registers
    uint64_t w[kHalf];
    load_words(src, h * kHalf * kConsumers, n, w);
    settle(src, h * kHalf * kConsumers, n, tag, w);
#pragma unroll
    for (int k = 0; k < kHalf; ++k) {
      v[h * kHalf + k] = value_of(w[k]);
      m = fmaxf(m, fabsf(v[h * kHalf + k]));
    }
  }
  const float amax = fmaxf(block_extreme<true>(m, red), 1e-30f);
  const float inv = 127.0f / amax;
#pragma unroll
  for (int k = 0; k < kMax; ++k) {
    const int i = threadIdx.x + k * kConsumers;
    if (i < n) xq[i] = quant(v[k], inv);
  }
  consumer_sync();
  return amax * kInv127;
}

// -- the weight stream ----------------------------------------------------------

// One matrix-vector product of a step: `out` items (output columns, or
// gate/up pairs when width is 2: rows j and out + j), each `in` int8 bytes
// a row with in / 128 scales.
struct Phase {
  const int8_t* w;
  const float* s;
  int in, groups, out, width;
  int kind;
};

// phase k of layer l, or the head of step s when l == n_layers
__device__ __forceinline__ Phase phase_of(const Params& p, int s, int l, int k) {
  const int dm = p.dm, hd = p.hq * p.dh, f = p.f_inter;
  const int cqkv = (p.hq + 2 * p.hkv) * p.dh;
  if (l == p.n_layers)
    return {p.heads + (size_t)s * p.vpad * dm, p.sheads + (size_t)s * p.vpad * (dm / kGroup),
            dm, dm / kGroup, p.vpad, 1, kHead};
  switch (k) {
    case kQkv:
      return {p.wqkv + (size_t)l * cqkv * dm, p.sqkv + (size_t)l * cqkv * (dm / kGroup),
              dm, dm / kGroup, cqkv, 1, kQkv};
    case kO:
      return {p.wo + (size_t)l * dm * hd, p.so + (size_t)l * dm * (hd / kGroup),
              hd, hd / kGroup, dm, 1, kO};
    case kGateUp:
      return {p.wgu + (size_t)l * 2 * f * dm, p.sgu + (size_t)l * 2 * f * (dm / kGroup),
              dm, dm / kGroup, f, 2, kGateUp};
    default:
      return {p.wdown + (size_t)l * dm * f, p.sdown + (size_t)l * dm * (f / kGroup),
              f, f / kGroup, dm, 1, kDown};
  }
}

// This CTA's items [lo, hi) of each phase kind, and the items a tile:
// computed once, as they take 64-bit divisions.
struct Ranges {
  int lo[5], hi[5], per_tile[5];
  int team_log2[5];  // a tile is computed by 2^team_log2 warps together
};

__device__ void fill_ranges(const Params& p, Ranges& rg) {
  const int hd = p.hq * p.dh, cqkv = (p.hq + 2 * p.hkv) * p.dh;
  const int out[5] = {cqkv, p.dm, p.f_inter, p.dm, p.vpad};
  const int in[5] = {p.dm, hd, p.dm, p.f_inter, p.dm};
  const int width[5] = {1, 1, 2, 1, 1};
  for (int k = 0; k < 5; ++k) {
    rg.lo[k] = (int)((long long)out[k] * blockIdx.x / gridDim.x);
    rg.hi[k] = (int)((long long)out[k] * (blockIdx.x + 1) / gridDim.x);
    rg.per_tile[k] = min(kStageW / (in[k] * width[k]), kMaxTileCols / width[k]);
    // the most warps a tile such that every tile of the phase has its own
    const int tiles = (rg.hi[k] - rg.lo[k] + rg.per_tile[k] - 1) / rg.per_tile[k];
    int t = 0;
    while ((2 << t) <= kConsumerWarps && (2 << t) * tiles <= kConsumerWarps) ++t;
    rg.team_log2[k] = t;
  }
}

// A position in the ring: the running tile count, its stage and the parity
// of the stage's current use, advanced together (no division in the loops)
struct Cursor {
  uint32_t it = 0;
  int st = 0;
  uint32_t parity = 0;
  __device__ void next(int stages) {
    ++it;
    if (++st == stages) {
      st = 0;
      parity ^= 1;
    }
  }
};

__device__ __forceinline__ int phases_of(const Params& p, int l) {
  return l < p.n_layers ? 4 : 1;
}

// The producer warp: every tile of every phase of every step, in order.
__device__ void produce(const Params& p, const Ranges& rg, uint8_t* ring,
                        uint64_t* full, uint64_t* empty, uint64_t* kv_written) {
  const int lane = threadIdx.x % 32;
  Cursor cur;
  for (int s = 0; s < p.n_steps; ++s)
    for (int l = 0; l <= p.n_layers; ++l)
      for (int k = 0; k < phases_of(p, l); ++k) {
        if (l < p.n_layers && k == kO) {
          // the attention's k and v slots 0..pos-1: one tile a kv head each,
          // from the working cache, once this CTA has written the last step's
          const uint32_t bytes = (uint32_t)(s + 2) * p.dh * 4;
          if (s > 0) wait_stage(&kv_written[l], (s - 1) & 1);
          for (int i = 0; i < 2 * p.hkv; ++i, cur.next(p.stages)) {
            uint8_t* stage = ring + (size_t)cur.st * kStageBytes;
            wait_stage(&empty[cur.st], cur.parity ^ 1);
#ifdef DRAFT_NO_STREAM
            bulk::mbar_arrive(&full[cur.st]);
            if (lane == 0) bulk::mbar_expect_tx(&full[cur.st], 0);
#else
            bulk::cp_async_arrive(&full[cur.st]);
            if (lane == 0) {
              const int kvh = i % p.hkv;
              bulk::mbar_expect_tx(&full[cur.st], bytes);
              bulk::bulk_copy(stage,
                              (i < p.hkv ? p.kc : p.vc) +
                                  ((size_t)l * p.hkv + kvh) * p.cap * p.dh,
                              bytes, &full[cur.st]);
            }
#endif
            __syncwarp();
          }
        }
        const Phase ph = phase_of(p, s, l, k);
        const int lo = rg.lo[ph.kind], hi = rg.hi[ph.kind], per_tile = rg.per_tile[ph.kind];
        for (int c = lo; c < hi; c += per_tile, cur.next(p.stages)) {
          const int n = min(per_tile, hi - c), st = cur.st;
          uint8_t* stage = ring + (size_t)st * kStageBytes;
          wait_stage(&empty[st], cur.parity ^ 1);
#ifdef DRAFT_NO_STREAM
          // nothing is copied: zero scales, so every logit is 0
          float* zeros = reinterpret_cast<float*>(stage + kStageW);
          for (int i = lane; i < kStageS / 4; i += 32) zeros[i] = 0.0f;
          bulk::mbar_arrive(&full[st]);
          if (lane == 0) bulk::mbar_expect_tx(&full[st], 0);
          __syncwarp();
          continue;
#endif
          float* sdst = reinterpret_cast<float*>(stage + kStageW);
          const int ns = n * ph.groups;
          for (int r = 0; r < ph.width; ++r) {
            const float* src = ph.s + ((size_t)r * ph.out + c) * ph.groups;
            for (int i = lane; i < ns; i += 32) bulk::cp_async4(sdst + r * ns + i, src + i);
          }
          bulk::cp_async_arrive(&full[st]);
          if (lane == 0) {
            const uint32_t run = (uint32_t)n * ph.in;
            bulk::mbar_expect_tx(&full[st], run * ph.width);
            for (int r = 0; r < ph.width; ++r)
              bulk::bulk_copy(stage + r * run, ph.w + ((size_t)r * ph.out + c) * ph.in,
                              run, &full[st]);
          }
          __syncwarp();
        }
      }
}

// The exact s8 dots of K 128-byte groups of weights (w + q * 128, q = q0 +
// stride k) with their slices of x (xq + (q % groups) * 128), all in shared
// memory; a group at or past `total` reads group 0 and gives 0.  No branch
// in the loop, so the loads of all K groups are in flight together.
// Lane-rotated 16-byte chunks keep a warp's loads of 32 groups (128 bytes
// apart) free of bank conflicts.
template <int K>
__device__ __forceinline__ void group_dots_k(const int8_t* w, const int8_t* xq, int total,
                                             int groups, int q0, int stride,
                                             int (&part)[kPerLane]) {
  const int lane = threadIdx.x % 32;
  int woff[K], xoff[K];
  int g = q0 % groups;
  const int step = stride % groups;
#pragma unroll
  for (int k = 0; k < K; ++k) {  // (q0 + stride k) % groups
    const int q = q0 + stride * k;
    woff[k] = q < total ? q * kGroup : 0;
    xoff[k] = q < total ? g * kGroup : 0;
    part[k] = 0;
    g += step;
    g = g >= groups ? g - groups : g;
  }
#pragma unroll(4 / K)
  for (int j = 0; j < 8; ++j) {
    const int cj = ((j + lane) & 7) * 16;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int4 wv = *reinterpret_cast<const int4*>(w + woff[k] + cj);
      const int4 xv = *reinterpret_cast<const int4*>(xq + xoff[k] + cj);
      part[k] = __dp4a(wv.x, xv.x, part[k]);
      part[k] = __dp4a(wv.y, xv.y, part[k]);
      part[k] = __dp4a(wv.z, xv.z, part[k]);
      part[k] = __dp4a(wv.w, xv.w, part[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (q0 + stride * k >= total) part[k] = 0;
}

// group_dots_k for the groups this lane's warp has any of (k < count, the
// same for the whole warp; 1, 2 or 4 of them); part[k] = 0 from there on
__device__ __forceinline__ void group_dots(const int8_t* w, const int8_t* xq, int total,
                                           int groups, int q0, int stride,
                                           int (&part)[kPerLane]) {
  const int first = q0 - threadIdx.x % 32;  // the warp's first group
  const int count = first >= total ? 0 : min(kPerLane, (total - first + stride - 1) / stride);
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) part[k] = 0;
  if (count == 1)
    group_dots_k<1>(w, xq, total, groups, q0, stride, part);
  else if (count == 2)
    group_dots_k<2>(w, xq, total, groups, q0, stride, part);
  else if (count > 2)  // 3 as 4, the fourth masked
    group_dots_k<4>(w, xq, total, groups, q0, stride, part);
}

// the warps of one team (2^team_log2 of them, named barrier 2 + team)
__device__ __forceinline__ void team_sync(int team, int team_log2) {
  if (team_log2 == 0)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(2 + team), "r"(32 << team_log2) : "memory");
}

// The consumer warps' side of one phase.  Every warp waits for every tile
// and arrives on its empty barrier, so no warp falls a phase of a stage
// behind.  A phase of T tiles splits the 8 warps into teams of 8 / T (a
// power of two; one warp from T = 5 on), and tile t goes to team t mod
// teams: its warps compute the exact dot of each 128-group, a lane a group,
// into the team's part of sm_parts; then lane c of the team's first warp
// folds column c's groups in ascending order as acc + part * (scale * sx).
// Puts item i's value, tagged, at out[i]: the column (q/k/v, o, down),
// silu(gate) * up (gate/up), or the logit, -inf past the vocabulary (head).
// `cur` is the ring position, as the producer keeps it.
__device__ void consume(const Phase& ph, int stages, int vocab, const Ranges& rg,
                        Cursor& cur, uint8_t* ring, uint64_t* full, uint64_t* empty,
                        const int8_t* xq, int* sm_parts, float sx, uint64_t* out,
                        uint32_t tag) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lo = rg.lo[ph.kind], hi = rg.hi[ph.kind], per_tile = rg.per_tile[ph.kind];
  const int team_log2 = rg.team_log2[ph.kind];
  const int team = warp >> team_log2, rank = warp & ((1 << team_log2) - 1);
  const int teams = kConsumerWarps >> team_log2;
  int* parts = sm_parts + team * kPerLane * 32;
  int t = 0;
  for (int c = lo; c < hi; c += per_tile, ++t, cur.next(stages)) {
    const int st = cur.st;
    uint8_t* stage = ring + (size_t)st * kStageBytes;
    CLOCK_START(t0);
    wait_stage(&full[st], cur.parity);
    CLOCK_ADD(s_tile_wait[ph.kind], t0);
    if ((t & (teams - 1)) == team) {
      CLOCK_START(tc);
      const int n = min(per_tile, hi - c);
      const int cols = ph.width * n, total = cols * ph.groups;
      const int q0 = rank * 32 + lane, stride = 32 << team_log2;
      int part[kPerLane];
      group_dots(reinterpret_cast<const int8_t*>(stage), xq, total, ph.groups, q0, stride,
                 part);
#pragma unroll
      for (int k = 0; k < kPerLane; ++k)
        if (q0 + stride * k < total) parts[q0 + stride * k] = part[k];
      team_sync(team, team_log2);
      if (rank == 0) {
        float acc = 0.0f;
        if (lane < cols) {
          const float* sc = reinterpret_cast<const float*>(stage + kStageW) + lane * ph.groups;
          const int* pc = parts + lane * ph.groups;
#pragma unroll 8
          for (int g = 0; g < ph.groups; ++g) acc = acc + (float)pc[g] * (sc[g] * sx);
        }
        if (ph.width == 2) {
          const float u = __shfl_sync(kFull, acc, (lane + n) & 31);
          // silu as PyTorch writes it: x / (1 + exp(-x))
          if (lane < n) put(out + c + lane, acc / (1.0f + expf(-acc)) * u, tag);
        } else if (lane < n) {
          put(out + c + lane, ph.kind == kHead && c + lane >= vocab ? -INFINITY : acc, tag);
        }
      }
      team_sync(team, team_log2);  // the parts are read
#ifdef DRAFT_PHASE_CLOCKS
      if (threadIdx.x % (32 << team_log2) == 0) {
        const long long te = clock64();
        atomicAdd(&s_compute[ph.kind][0], (unsigned long long)(te - tc));
        atomicAdd(&s_compute[ph.kind][1], 1ull);
        const long long k = (long long)cur.it - s_timeline_base;
        if (blockIdx.x == 0 && s_timeline_base >= 0 && k >= 0 && k < kTimelineTiles) {
          g_timeline[k][0] = ph.kind;
          g_timeline[k][1] = warp;
          g_timeline[k][2] = tc;
          g_timeline[k][3] = te;
        }
      }
#endif
    }
    if (lane == 0) bulk::mbar_arrive(&empty[st]);
  }
}

// -- attention --------------------------------------------------------------------

// Shared memory beside the ring, per CTA.
struct Smem {
  int8_t* xq;     // the quantized row, [max(Dm, Hq Dh, F)]
  float* x;       // the residual [Dm]
  float* xn;      // attention output [Hq Dh]
  float* qv;      // q, k, v [Cqkv] as the q/k/v product gave them, q RoPE'd
  float* probs;   // scores [Hq, Cap]
  double* pd;     // probabilities [Hq, Cap]
  float* newkv;   // this step's k (RoPE'd) and v, [2, Hkv, Dh]
  int* parts;     // the consumer warps' group dots, [8, 128]
  float* norm;    // RMSNorm weights: [0] input (or final), [1] post-attention
  float* rope;    // cos [Dh / 2], then sin [Dh / 2] of the step's position
  uint64_t* bar;  // [2]: norm[0] landed; the layer's RoPE rows and norm[1] landed
};

// Copies dm RMSNorm weights to shared memory (one bulk copy, on bar).
__device__ __forceinline__ void prefetch_norm(const Params& p, const float* src,
                                              float* dst, uint64_t* bar) {
  if (threadIdx.x == 0) {
    bulk::mbar_expect_tx(bar, p.dm * 4);
    bulk::bulk_copy(dst, src, p.dm * 4, bar);
  }
}

// Copies the RoPE rows of pos and the layer's post-attention RMSNorm
// weights to shared memory: three bulk copies, on sm.bar[1].
__device__ void prefetch_layer(const Params& p, const Smem& sm, int l, int pos) {
  if (threadIdx.x != 0) return;
  const int half = p.dh / 2;
  bulk::mbar_expect_tx(sm.bar + 1, p.dh * 4 + p.dm * 4);
  bulk::bulk_copy(sm.rope, p.rope_cos + (size_t)pos * half, half * 4, sm.bar + 1);
  bulk::bulk_copy(sm.rope + half, p.rope_sin + (size_t)pos * half, half * 4, sm.bar + 1);
  bulk::bulk_copy(sm.norm + p.dm, p.norms + (size_t)(2 * l + 1) * p.dm, p.dm * 4,
                  sm.bar + 1);
}

// The q/k/v product's outputs (tagged words at src), RoPE on q and the new
// k, attention of the Hq heads over slots 0..pos, output [Hq * Dh] into
// sm.xn.  Slots below pos come through the ring: 2 Hkv tiles at `cur` (the
// k rows of each kv head, then the v rows), which this warp waits for and
// then releases; slot pos from sm.newkv; the RoPE rows from prefetch_layer
// (sm.bar[1], phase `parity`).  Products in float64 are exact, so each fma
// below rounds as a multiply and an add would; a kv head's v serves its rep
// query heads, converted to float64 once.
__device__ void attention(const Params& p, const Smem& sm, int s, int l, int pos,
                          const uint64_t* src, uint32_t tag, uint32_t parity,
                          Cursor& cur, uint8_t* ring, uint64_t* full, uint64_t* empty) {
  const int dh = p.dh, half = dh / 2, hq = p.hq, hkv = p.hkv, cap = p.cap;
  const int rep = hq / hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* qv = sm.qv;
  CLOCK_START(t0);
  gather<false>(src, (hq + 2 * hkv) * dh, tag, qv);
  CLOCK_ADD(s_xwait[kQkv], t0);
  // the rows of tile i (k of kv head i, then v of kv head i - hkv)
  auto rows_of = [&](int i) {
    int st = cur.st + i;
    st = st >= p.stages ? st - p.stages : st;
    return reinterpret_cast<const float*>(ring + (size_t)st * kStageBytes);
  };
  {
    Cursor c = cur;
    for (int i = 0; i < 2 * hkv; ++i, c.next(p.stages)) wait_stage(&full[c.st], c.parity);
  }
  wait_stage(sm.bar + 1, parity);  // the RoPE rows
  consumer_sync();
  LAYER_STAMP(s, l, 3);
  const float* c = sm.rope;
  const float* sn = sm.rope + half;
  for (int head = warp; head < hq + hkv; head += kConsumerWarps) {
    for (int d = lane; d < half; d += 32) {
      const float t1 = qv[head * dh + d], t2 = qv[head * dh + d + half];
      const float r1 = t1 * c[d] - t2 * sn[d], r2 = t2 * c[d] + t1 * sn[d];
      float* row = head < hq ? qv + head * dh : sm.newkv + (head - hq) * dh;
      row[d] = r1;
      row[d + half] = r2;
    }
  }
  for (int n = tid; n < hkv * dh; n += kConsumers)
    sm.newkv[hkv * dh + n] = qv[(hq + hkv) * dh + n];
  consumer_sync();
  LAYER_STAMP(s, l, 4);
  // scores, one warp a head, one lane a slot: four float64 sums over Dh,
  // chunks rotated by slot against bank conflicts
  const int slots = pos + 1, chunks = dh / 4;
  for (int hh = warp; hh < hq; hh += kConsumerWarps) {
    const int kvh = hh / rep;
    const float4* q4 = reinterpret_cast<const float4*>(qv + hh * dh);
    for (int j = lane; j < slots; j += 32) {
      const float4* k4 = reinterpret_cast<const float4*>(
          j == pos ? sm.newkv + kvh * dh : rows_of(kvh) + (size_t)j * dh);
      int rot = j;
      while (rot >= chunks) rot -= chunks;
      double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
#pragma unroll 4
      for (int n = 0; n < chunks; ++n) {
        int cd = n + rot;
        cd = cd >= chunks ? cd - chunks : cd;
        const float4 kv = k4[cd], q = q4[cd];
        a0 = fma((double)q.x, (double)kv.x, a0);
        a1 = fma((double)q.y, (double)kv.y, a1);
        a2 = fma((double)q.z, (double)kv.z, a2);
        a3 = fma((double)q.w, (double)kv.w, a3);
      }
      sm.probs[hh * cap + j] = (float)((a0 + a1) + (a2 + a3)) * p.attn_scale;
    }
  }
  consumer_sync();
  LAYER_STAMP(s, l, 5);
  // softmax, one warp a head: e = exp(s - max), p = e / sum(e)
  for (int hh = warp; hh < hq; hh += kConsumerWarps) {
    const float* row = sm.probs + hh * cap;
    float m = -INFINITY;
    for (int j = lane; j < slots; j += 32) m = fmaxf(m, row[j]);
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    double ssum = 0.0;
    for (int j = lane; j < slots; j += 32) ssum += (double)expf(row[j] - m);
    for (int off = 16; off > 0; off >>= 1) ssum += __shfl_xor_sync(kFull, ssum, off);
    const float denom = (float)ssum;
    for (int j = lane; j < slots; j += 32)
      sm.pd[hh * cap + j] = (double)(expf(row[j] - m) / denom);
  }
  consumer_sync();
  LAYER_STAMP(s, l, 6);
  // output, one thread a (kv head, dim), its rep query heads at once
  int kvh = tid / dh, d = tid - kvh * dh;  // advanced by kConsumers a round
  const int kvh_step = kConsumers / dh, d_step = kConsumers - kvh_step * dh;
  for (; kvh < hkv; kvh += kvh_step, d += d_step) {
    if (d >= dh) {
      d -= dh;
      ++kvh;
      if (kvh >= hkv) break;
    }
    const float* v = rows_of(hkv + kvh) + d;
    const double* pr = sm.pd + (size_t)kvh * rep * cap;
    double acc[kMaxRep] = {};
    for (int j = 0; j < slots; ++j) {
      const double vd = (double)(j == pos ? sm.newkv[(hkv + kvh) * dh + d] : v[(size_t)j * dh]);
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r)
        if (r < rep) acc[r] = fma(pr[(size_t)r * cap + j], vd, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r)
      if (r < rep) sm.xn[(kvh * rep + r) * dh + d] = (float)acc[r];
  }
  __syncwarp();  // the warp has read the kv tiles
  for (int i = 0; i < 2 * hkv; ++i, cur.next(p.stages))
    if (lane == 0) bulk::mbar_arrive(&empty[cur.st]);
  consumer_sync();
}

// This step's k and v rows of layer l into the working cache, from which the
// producer's bulk copies bring them back at later steps (the async proxy:
// hence the fence); then phase s of kv_written completes, which the
// producer waits for before it copies the layer's slots for step s + 1.
// Off the critical path: after the gate/up product.
__device__ __forceinline__ void store_kv(const Params& p, const Smem& sm, int l, int pos,
                                         uint64_t* kv_written) {
  const int dh = p.dh, hkv = p.hkv;
  for (int n = threadIdx.x; n < 2 * hkv * dh; n += kConsumers) {
    const int which = n / (hkv * dh), kvh = (n / dh) % hkv, d = n % dh;
    float* cache = which ? p.vc : p.kc;
    cache[(((size_t)l * hkv + kvh) * p.cap + pos) * dh + d] = sm.newkv[n];
  }
  asm volatile("fence.proxy.async.global;" ::: "memory");
  consumer_sync();
  if (threadIdx.x == 0) bulk::mbar_arrive(kv_written + l);
}

// temperature, bisection top-k, Gumbel noise and argmax over the head's
// outputs (tagged words at src)
__device__ int sample(const Params& p, int s, const uint64_t* src, uint32_t tag,
                      Red& red) {
  float z[kMaxPerThread];
  uint64_t w[kMaxPerThread];
  const int vpad = p.vpad;
  load_words(src, 0, vpad, w);
  CLOCK_START(t0);
  settle(src, 0, vpad, tag, w);
  CLOCK_ADD(s_xwait[kHead], t0);
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k)
    z[k] = threadIdx.x + k * kConsumers < vpad ? value_of(w[k]) : -INFINITY;
  if (p.temp > 0.0f) {
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) z[k] = z[k] / p.temp;
    if (p.top_k > 0 && p.top_k < p.vocab) {
      float lo = INFINITY, hi = -INFINITY;
#pragma unroll
      for (int k = 0; k < kMaxPerThread; ++k) {
        const int i = threadIdx.x + k * kConsumers;
        if (i < p.vocab) lo = fminf(lo, z[k]);
        hi = fmaxf(hi, z[k]);
      }
      lo = block_extreme<false>(lo, red);
      hi = block_extreme<true>(hi, red);
      for (int it = 0; it < 24; ++it) {
        const float mid = 0.5f * (lo + hi);
        int cnt = 0;
#pragma unroll
        for (int k = 0; k < kMaxPerThread; ++k) cnt += z[k] >= mid;
        if (block_sum(cnt, red) >= p.top_k) lo = mid; else hi = mid;
      }
#pragma unroll
      for (int k = 0; k < kMaxPerThread; ++k) z[k] = z[k] >= lo ? z[k] : -INFINITY;
    }
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) {
      const int i = threadIdx.x + k * kConsumers;
      if (i < vpad) z[k] = z[k] + p.noise[(size_t)s * vpad + i];
    }
  }
  float bv = -INFINITY;
  int bi = vpad;
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int i = threadIdx.x + k * kConsumers;
    if (i < vpad && better(z[k], i, bv, bi)) { bv = z[k]; bi = i; }
  }
  return block_argmax(bv, bi, red);
}

// -- the kernel -------------------------------------------------------------------

// shared memory after the ring: the parts of Smem in order, each a multiple
// of 16 bytes
__host__ __device__ size_t activation_bytes(int dm, int hq, int hkv, int dh, int f,
                                            int cap) {
  const int hd = hq * dh, widest = dm > hd ? dm : hd;
  const int widest_in = widest > f ? widest : f;
  return (size_t)((widest_in + 15) / 16) * 16 +
         sizeof(float) * ((size_t)dm + widest + (size_t)(hq + 2 * hkv) * dh +
                          (size_t)((hq * cap + 3) / 4) * 4 + (size_t)((hq * cap + 1) / 2) * 4 +
                          2 * (size_t)dm + dh +
                          (size_t)2 * hkv * dh + kConsumerWarps * kPerLane * 32);
}

// tagged words of one step's exchanges: per layer q/k/v, o, gate/up, down
__host__ __device__ size_t layer_words(int dm, int hq, int hkv, int dh, int f) {
  return (size_t)(hq + 2 * hkv) * dh + 2 * (size_t)dm + f;
}

__global__ void __launch_bounds__(kThreads, 1) depth_draft_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];
  __shared__ Scratch scratch[2];
  __shared__ __align__(8) uint64_t staged[2];
  __shared__ __align__(8) uint64_t kv_written[kMaxLayers];
  __shared__ Ranges rg;
  const int dm = p.dm, hd = p.hq * p.dh, f = p.f_inter, cqkv = (p.hq + 2 * p.hkv) * p.dh;
  const int widest = max(dm, hd);
  uint8_t* ring = smem;
  Smem sm;
  sm.xq = reinterpret_cast<int8_t*>(smem + (size_t)p.stages * kStageBytes);
  sm.x = reinterpret_cast<float*>(sm.xq + ((max(widest, f) + 15) / 16) * 16);
  sm.xn = sm.x + dm;
  sm.qv = sm.xn + widest;
  sm.probs = sm.qv + cqkv;
  sm.pd = reinterpret_cast<double*>(sm.probs + (p.hq * p.cap + 3) / 4 * 4);
  sm.norm = reinterpret_cast<float*>(sm.pd + (p.hq * p.cap + 1) / 2 * 2);
  sm.rope = sm.norm + 2 * dm;
  sm.newkv = sm.rope + p.dh;
  sm.parts = reinterpret_cast<int*>(sm.newkv + 2 * p.hkv * p.dh);
  sm.bar = staged;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      bulk::mbar_init(&full[s], 33);  // the producer's lanes' cp.async, its expect_tx
      bulk::mbar_init(&empty[s], kConsumerWarps);
    }
    bulk::mbar_init(&staged[0], 1);
    bulk::mbar_init(&staged[1], 1);
    for (int l = 0; l < p.n_layers; ++l) bulk::mbar_init(&kv_written[l], 1);
    bulk::fence_init();
    fill_ranges(p, rg);
#ifdef DRAFT_PHASE_CLOCKS
    for (int k = 0; k < 5; ++k) s_tile_wait[k] = s_xwait[k] = s_compute[k][0] = s_compute[k][1] = 0;
    s_timeline_base = -1;
#endif
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    produce(p, rg, ring, full, empty, kv_written);
    return;
  }

  Red red{scratch, 0};
  const size_t per_layer = layer_words(dm, p.hq, p.hkv, p.dh, f);
  const size_t per_step = p.n_layers * per_layer + p.vpad;
  Cursor cur;
  uint32_t norm_parity = 0, layer_parity = 0;
  int tok = *p.c1;
  prefetch_norm(p, p.norms, sm.norm, sm.bar);
  for (int s = 0; s < p.n_steps; ++s) {
    STAMP(s, 0);
#ifdef DRAFT_PHASE_CLOCKS
    consumer_sync();
    if (threadIdx.x == 0) s_timeline_base = s == p.n_steps / 2 ? (long long)cur.it : -1;
    consumer_sync();
#endif
    const int pos = s + 2;
    const uint32_t tag = p.tag_base + s + 1;
    uint64_t* xs = p.xch + (size_t)(s & 1) * per_step;
    const __nv_bfloat16* erow = p.emb_proj + ((size_t)s * p.vpad + tok) * dm;
    for (int i = threadIdx.x; i < dm; i += kConsumers) sm.x[i] = __bfloat162float(erow[i]);
    for (int l = 0; l < p.n_layers; ++l) {
      uint64_t* xl = xs + l * per_layer;
      // q, k, v; then the RoPE rows and the post-attention RMSNorm weights
      wait_stage(sm.bar, norm_parity);
      norm_parity ^= 1;
      consumer_sync();
      float sx = rms_quant(sm.x, sm.norm, dm, sm.xq, red);
      LAYER_STAMP(s, l, 0);
      consume(phase_of(p, s, l, kQkv), p.stages, p.vocab, rg, cur, ring, full, empty, sm.xq,
              sm.parts, sx, xl, tag);
      LAYER_STAMP(s, l, 1);
      prefetch_layer(p, sm, l, pos);
      LAYER_STAMP(s, l, 2);
      // attention, o-proj
      attention(p, sm, s, l, pos, xl, tag, layer_parity, cur, ring, full, empty);
      layer_parity ^= 1;
      LAYER_STAMP(s, l, 7);
      sx = quant_row(sm.xn, hd, sm.xq, red);
      LAYER_STAMP(s, l, 8);
      consume(phase_of(p, s, l, kO), p.stages, p.vocab, rg, cur, ring, full, empty, sm.xq,
              sm.parts, sx, xl + cqkv, tag);
      LAYER_STAMP(s, l, 9);
      // residual, gate and up; then start staging the next RMSNorm's weights
      {
        CLOCK_START(t0);
        gather<true>(xl + cqkv, dm, tag, sm.x);
        CLOCK_ADD(s_xwait[kO], t0);
      }
      consumer_sync();
      LAYER_STAMP(s, l, 10);
      sx = rms_quant(sm.x, sm.norm + dm, dm, sm.xq, red);
      prefetch_norm(p, l + 1 < p.n_layers ? p.norms + (size_t)(2 * l + 2) * dm
                                          : p.final_norm, sm.norm, sm.bar);
      LAYER_STAMP(s, l, 11);
      consume(phase_of(p, s, l, kGateUp), p.stages, p.vocab, rg, cur, ring, full, empty, sm.xq,
              sm.parts, sx, xl + cqkv + dm, tag);
      store_kv(p, sm, l, pos, kv_written);
      LAYER_STAMP(s, l, 12);
      // down
      {
        CLOCK_START(t0);
        sx = quant_exchanged(xl + cqkv + dm, f, tag, sm.xq, red);
        CLOCK_ADD(s_xwait[kGateUp], t0);
      }
      LAYER_STAMP(s, l, 13);
      consume(phase_of(p, s, l, kDown), p.stages, p.vocab, rg, cur, ring, full, empty, sm.xq,
              sm.parts, sx, xl + cqkv + dm + f, tag);
      LAYER_STAMP(s, l, 14);
      {
        CLOCK_START(t0);
        gather<true>(xl + cqkv + dm + f, dm, tag, sm.x);
        CLOCK_ADD(s_xwait[kDown], t0);
      }
      LAYER_STAMP(s, l, 15);
    }
    // head of codebook s + 2; then start staging the first layer's RMSNorm
    wait_stage(sm.bar, norm_parity);
    norm_parity ^= 1;
    consumer_sync();
    const float sx = rms_quant(sm.x, sm.norm, dm, sm.xq, red);
    prefetch_norm(p, p.norms, sm.norm, sm.bar);
    LAYER_STAMP(s, p.n_layers, 0);
    uint64_t* head = xs + p.n_layers * per_layer;
    consume(phase_of(p, s, p.n_layers, 0), p.stages, p.vocab, rg, cur, ring, full, empty, sm.xq,
            sm.parts, sx, head, tag);
    LAYER_STAMP(s, p.n_layers, 1);
    tok = sample(p, s, head, tag, red);
    if (blockIdx.x == 0 && threadIdx.x == 0) p.tok_out[s] = tok;
    LAYER_STAMP(s, p.n_layers, 2);
  }
  wait_stage(sm.bar, norm_parity);  // the last step's copy of the first norm
#ifdef DRAFT_PHASE_CLOCKS
  if (threadIdx.x == 0) {
    for (int k = 0; k < 5; ++k) {
      if (blockIdx.x == 0) {
        g_wait[k] = s_tile_wait[k];
        g_compute[k][0] = s_compute[k][0];
        g_compute[k][1] = s_compute[k][1];
      }
      if (blockIdx.x < kClockCtas) g_xwait[blockIdx.x][k] = s_xwait[k];
    }
  }
#endif
}

// -- the floor of the synchronisation -------------------------------------------

// every consumer thread of every CTA; the target is (barriers so far) x CTAs
__device__ void grid_barrier(unsigned* count, unsigned target) {
  consumer_sync();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(count) : "memory");
    unsigned v = 0;
    for (unsigned n = 0;; ++n) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(count) : "memory");
      if (v >= target) break;
      if (n == kSpinLimit) __trap();
    }
  }
  consumer_sync();
}

// words of the sync-only probe's scratch (zero at launch): two rounds' words
// of up to kConsumers CTAs
constexpr int kSyncWords = 2 * kConsumers;

// n rounds of synchronisation and no work, at the draft's launch shape.
// mode 0: cooperative_groups' grid.sync() of all threads; 1: a grid barrier
// of the consumer warps (one red.release.gpu add a CTA on a counter, one
// thread spinning on ld.acquire.gpu); 2: the draft's exchange, every CTA
// puts one tagged word a round and polls every CTA's.
__global__ void __launch_bounds__(kThreads, 1)
    sync_only_kernel(uint64_t* scratch, int n, int mode) {
  if (mode == 0) {
    cg::grid_group grid = cg::this_grid();
    for (int i = 0; i < n; ++i) grid.sync();
    return;
  }
  if (threadIdx.x >= kConsumers) return;
  for (int i = 1; i <= n; ++i) {
    if (mode == 1) {
      grid_barrier(reinterpret_cast<unsigned*>(scratch), (unsigned)i * gridDim.x);
      continue;
    }
    uint64_t* words = scratch + (i & 1) * (kSyncWords / 2);
    if (threadIdx.x == 0) put(words + blockIdx.x, 0.0f, (uint32_t)i);
    uint64_t w[1];
    load_words(words, 0, gridDim.x, w);
    settle(words, 0, gridDim.x, (uint32_t)i, w);
    consumer_sync();
  }
}

// CTAs of a cooperative launch: one a SM, or `ctas` when that is positive
// and smaller; never more than `most`
cudaError_t grid_size(const void* kernel, size_t smem, int ctas, int most, int* grid) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return cudaErrorNotSupported;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  int g = ctas > 0 && ctas < sms ? ctas : sms;
  *grid = g < most ? g : most;
  return cudaSuccess;
}

}  // namespace

// Stages of the ring for these shapes on this card (0 if fewer than two
// fit beside the rest), or a negative CUDA error.
extern "C" int depth_draft_stages(int dm, int hq, int hkv, int dh, int f_inter,
                                  int cap) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, depth_draft_kernel);
  if (err != cudaSuccess) return -(int)err;
  const long long left =
      (long long)optin - (long long)attr.sharedSizeBytes -
      (long long)activation_bytes(dm, hq, hkv, dh, f_inter, cap);
  const long long stages = left / kStageBytes;
  return stages < 2 ? 0 : (int)(stages < kMaxStages ? stages : kMaxStages);
}

// Words of the exchange (int64, zero when allocated) for these shapes: two
// steps' regions.
extern "C" long long depth_draft_exchange_words(int n_layers, int dm, int hq,
                                                int hkv, int dh, int f_inter,
                                                int vpad) {
  return 2 * ((long long)n_layers * layer_words(dm, hq, hkv, dh, f_inter) + vpad);
}

extern "C" int depth_draft_forward(
    const int8_t* wqkv, const float* sqkv, const int8_t* wo, const float* so,
    const int8_t* wgu, const float* sgu, const int8_t* wdown,
    const float* sdown, const float* norms, const float* final_norm,
    const int8_t* heads, const float* sheads, const void* emb_proj,
    const float* rope_cos, const float* rope_sin, float* kc, float* vc,
    const float* noise, const int* c1, int* tok_out, uint64_t* xch,
    unsigned tag_base, int n_layers, int dm, int f_inter, int hq, int hkv,
    int dh, int cap, int vocab, int vpad, int n_steps, int top_k,
    int rope_rows, int ctas, float temp, float attn_scale, void* stream) {
  const int hd = hq * dh;
  // a gate/up pair, an o column and a down column each fit one stage; the
  // tags tag_base + 1 .. tag_base + S do not wrap
  if (n_layers < 1 || n_layers > kMaxLayers || dm % kGroup || hd % kGroup ||
      f_inter % kGroup || dh % 8 || hkv < 1 ||
      hq % hkv || hq > kMaxRep * hkv || 2 * dm > kStageW || hd > kStageW || f_inter > kMaxF ||
      vpad > kConsumers * kMaxPerThread || vocab < 1 || vocab > vpad ||
      n_steps < 1 || n_steps + 2 > cap || n_steps + 2 > rope_rows ||
      tag_base > 0xffffffffu - (unsigned)n_steps)
    return (int)cudaErrorInvalidValue;
  const int stages = depth_draft_stages(dm, hq, hkv, dh, f_inter, cap);
  if (stages < 0) return -stages;
  // the attention holds its 2 Hkv slot tiles at once, each up to S + 1 rows
  if (stages < 2 * hkv + 1 || (n_steps + 1) * dh * 4 > kStageW)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)stages * kStageBytes +
                      activation_bytes(dm, hq, hkv, dh, f_inter, cap);
  cudaError_t err = cudaFuncSetAttribute(
      depth_draft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // every CTA puts head outputs every step (Vp >= CTAs), so none can be two
  // steps behind another and an exchange region is free again when its
  // step parity comes round
  int grid = 0;
  err = grid_size((const void*)depth_draft_kernel, smem, ctas, vpad, &grid);
  if (err != cudaSuccess) return (int)err;
  Params p{wqkv, sqkv, wo, so, wgu, sgu, wdown, sdown, norms, final_norm,
           heads, sheads, reinterpret_cast<const __nv_bfloat16*>(emb_proj),
           rope_cos, rope_sin, kc, vc, noise, c1, tok_out, xch, n_layers, dm,
           f_inter, hq, hkv, dh, cap, vocab, vpad, n_steps, top_k, stages, temp,
           attn_scale, tag_base};
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel((const void*)depth_draft_kernel,
                                          dim3(grid), dim3(kThreads), args,
                                          smem, (cudaStream_t)stream);
}

// n rounds of the synchronisation of `mode` (sync_only_kernel) and no work;
// scratch: kSyncWords int64, zero
extern "C" int depth_draft_sync_only(uint64_t* scratch, int n, int mode, int ctas,
                                     void* stream) {
  if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  int grid = 0;
  // a round's words are polled by one consumer thread each
  cudaError_t err = grid_size((const void*)sync_only_kernel, 0, ctas, kConsumers, &grid);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&scratch, &n, &mode};
  return (int)cudaLaunchCooperativeKernel((const void*)sync_only_kernel,
                                          dim3(grid), dim3(kThreads), args, 0,
                                          (cudaStream_t)stream);
}

#ifdef DRAFT_PHASE_CLOCKS
// copies the last launch's stamps [3][1 + 16 * 8 + 3][2] (globaltimer ns,
// clock64), the cycles its CTA 0's thread 0 waited on tiles [5], every
// CTA's thread 0 polled for other CTAs' outputs [256][5], and CTA 0's teams
// computed tiles, with their count [5][2], by phase kind, and the
// timeline of step S / 2's tiles [96][4] to the host
extern "C" int depth_draft_clocks(unsigned long long* stamps,
                                  unsigned long long* waits,
                                  unsigned long long* exchange_waits,
                                  unsigned long long* compute,
                                  unsigned long long* timeline) {
  cudaError_t err = cudaMemcpyFromSymbol(stamps, g_clocks, sizeof(g_clocks));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(timeline, g_timeline, sizeof(g_timeline));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(compute, g_compute, sizeof(g_compute));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(waits, g_wait, sizeof(g_wait));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(exchange_waits, g_xwait, sizeof(g_xwait));
  return (int)err;
}
#endif

extern "C" const char* depth_draft_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
