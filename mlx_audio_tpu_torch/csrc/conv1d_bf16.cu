// 'Same'-padded conv1d over bf16 operands, channels last, on Hopper's
// warpgroup tensor cores: the bf16 counterpart of both TPU convolution
// kernels, dilated_conv1d_pallas (mlx_audio_tpu/nn/pallas_ops.py:259, with
// _dilated_conv_kernel at :240-298) and banded_conv1d_pallas
// (mlx_audio_tpu/nn/pallas_ops.py:353, with _banded_conv_kernel at
// :321-401).  banded_conv1d launches it at d = 1, dilated_conv1d at its d.
//
//   out[b, l, o] = sum_tap sum_c x[b, l + tap d - pad, c] * w[tap, c, o],
//   pad = (K - 1) d / 2, x read as zero outside [0, L).
//
// x [B, L, C], w [K, C, Cout], out [B, L, Cout], all bf16 and contiguous;
// K odd, C and Cout multiples of 8, x and w 16-byte aligned.  The sums are
// float32 and each output is rounded to bf16 once, to nearest even.
//
// What bounds it on this card: operations.  Every input row feeds 2 K Cout
// operations a channel, far above the 295 operations a byte where the
// H100's bf16 tensor-core rate (989 TFLOP/s dense) and its memory (3.35
// TB/s) meet: 0.0482 ms at Kokoro-82M's [2, 26000, 256] K = 7 and 0.1137 ms
// at [2, 156001, 128] K = 11.  Only at K = 3 with 128 channels do the bytes
// (2 (B L (C + Cout) + K C Cout)) bound it: 0.0477 ms at [2, 156001, 128].
//
// Design: an implicit GEMM, M = B L output rows, N = Cout, depth K C, with
// the tensor cores' only full-rate instruction, wgmma, fed by TMA.
// * Warp specialisation.  A block is three warpgroups: one thread of the
//   last issues every load; the other two (the consumers) each own 64 of
//   the tile's 128 output rows by its 128 output channels and multiply.
//   setmaxnreg moves the producer's registers to the consumers (40 and 232
//   a thread), who hold the running sum and a partial sum.  Blocks are
//   persistent: one a SM walks the tiles (output channels fastest), so a
//   block's next stages load while it finishes a tile.  (A 256-channel
//   tile, two wgmmas a step, spilled its sums past 232 registers.)
// * The input window.  x's tensor map is 3-D over (C, L, B), so TMA fills
//   the rows outside [0, L) of each batch row with zeros: the 'same'
//   padding costs no copy and no mask.  The window of one chunk of 64
//   channels (one 128-byte swizzled row a sample) is loaded once, tile +
//   (K - 1) d rows, and every tap reads it at a row offset of tap d.  When
//   the taps are farther apart than the tile (d > tile) the window would
//   be mostly gaps, so K boxes of one tile each are loaded instead, at
//   offsets tap d; either way the smaller of the two is staged.
// * The weights.  w's tensor map is 3-D over (Cout, C, K): a stage is
//   w[tap, chunk, n-tile], 64 channels by the tile's outputs, loaded in
//   boxes of 64 outputs with the 128-byte swizzle, zero past C or Cout.  It
//   is the wgmma B operand, read through a descriptor; w is
//   Cout-contiguous, so B is MN-major (transposed).
// * A from registers.  A tap's A tile is the window shifted by tap d rows,
//   and a one-row shift breaks the alignment an A descriptor needs, so
//   each lane loads its rows with ldmatrix at its own swizzled address
//   (conflict-free: the 8 rows of a matrix sit in 8 distinct 16-byte banks
//   groups) and wgmma.m64n128k16 takes A from registers (the RS form).
// * Two rings.  Windows (two stages where they fit, else one) and weight
//   stages (up to 8, one at the widest spans) each have a full and an
//   empty mbarrier a stage: TMA completes the full one with the stage's
//   bytes, the consumer warps arrive on the empty one when they have read
//   it.  A wait that sees no progress for about 2^34 clocks traps.
// * The fold.  One float32 chain of tensor-core sums over all K C products
//   is not accurate enough: the tensor core's accumulation truncates.  So a
//   tap's products over one chunk (CONV_BF16_FOLD = 64 channels, four k16
//   steps) go into a fresh accumulator, which is then added to the float32
//   running sum.  scripts/tune_conv.py --bf16 builds -DCONV_BF16_FOLD=16
//   and 32 beside it.
// * The epilogue.  Each consumer warpgroup rounds its outputs to bf16 into
//   a staging buffer of 64-output boxes with the 128-byte swizzle and one
//   thread stores them by TMA (asynchronously; the buffer is reused once
//   the store has read it), which skips rows past L and columns past Cout.
//   Stores straight from the registers (16 bytes a row a warp) held the
//   consumers back most at K = 3, where a tile's products are few.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

#ifndef CONV_BF16_FOLD
#define CONV_BF16_FOLD 64
#endif

namespace {

using bulk::mbar_arrive;
using bulk::mbar_expect_tx;
using bulk::mbar_init;
using bulk::smem_u32;

typedef __nv_bfloat16 bf16;

constexpr int kChunk = 64;                  // input channels a window stage
constexpr int kRowBytes = 2 * kChunk;       // one 128-byte swizzle row
constexpr int kSlab = 64;                   // outputs a box (128 bytes)
constexpr int kSlabBytes = 2 * 64 * kSlab;  // a box of 64 rows
constexpr int kTileM = 128;                 // output rows a tile
constexpr int kTileN = 128;                 // output channels a tile: a wgmma
constexpr int kWBytes = 2 * kChunk * kTileN;  // a weight stage
constexpr int kBoxes = kTileN / kSlab;      // 64-output boxes a tile
constexpr int kConsumers = kTileM / 64;     // consumer warpgroups a block
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kMaxBox = 256;                // rows a TMA box
constexpr int kMaxWStages = 8;
constexpr int kSmemLimit = 232448;          // bytes a block may use (H100)
constexpr int kMaxDevices = 64;
constexpr int kAlign = 1024;                // the 128-byte swizzle's period
constexpr int kFold = CONV_BF16_FOLD;
static_assert(kFold == 16 || kFold == 32 || kFold == 64,
              "CONV_BF16_FOLD: 16, 32 or 64 channels");
constexpr int kSteps = kFold / 16;          // k16 steps a partial sum
// B descriptor strides: 64-output slabs (8 KB apart), groups of 8 rows of k
constexpr uint32_t kLbo = kSlabBytes, kSbo = 1024;

struct Params {
  int K, pad, chunks;
  int tap_stride;   // rows between two taps' A tiles in a window stage
  int pieces;       // TMA boxes a window stage
  int piece_rows;   // rows a box
  int piece_step;   // input rows between two boxes' first rows
  int win_stages, w_stages, win_bytes;
  int tiles_m, tiles_n, tiles;
};

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// shared to global: the parts of the box inside the tensor are written
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// mbar_wait that traps after about 2^34 clocks (8-9 s) without the phase
// completing, so a fault in the rings ends the launch with an error instead
// of holding the card
__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
  const long long start = clock64();
  while (!bulk::mbar_try_wait(bar, parity))
    if (clock64() - start > (1ll << 34)) __trap();
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the descriptor of an MN-major B tile with the 128-byte swizzle
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kLbo >> 4) << 16) |
         ((uint64_t)(kSbo >> 4) << 32) | (1ull << 62);
}

// keeps the compiler from moving register reads or writes across the
// asynchronous wgmma that owns them
__device__ __forceinline__ void fence_regs(float (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// the 128 threads of consumer warpgroup wg (named barrier 1 + wg)
__device__ __forceinline__ void sync_warpgroup(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// d (+)= a b: a warpgroup's [64, 16] A from registers (each warp 16 rows,
// the m16n8k16 A fragment), B [16, 128] through its descriptor, MN-major;
// d zeroed first when !accumulate
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// A ring's stage and the parity of its current pass
struct Ring {
  int stage, phase;
  __device__ __forceinline__ void next(int stages) {
    if (++stage == stages) stage = 0, phase ^= 1;
  }
};

// A block's tile is 128 output rows (each consumer warpgroup 64) by 128
// output channels; the outputs leave through a staging buffer of 64-output
// boxes, 64 rows each, by TMA.
__global__ void __launch_bounds__(kThreads, 1)
    conv1d_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ CUtensorMap omap,
                       const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* wins = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) &
      ~uintptr_t(kAlign - 1));
  uint8_t* wts = wins + p.win_stages * p.win_bytes;
  uint8_t* staging = wts + p.w_stages * kWBytes;  // kBoxes boxes a warpgroup
  uint64_t* win_full =
      reinterpret_cast<uint64_t*>(staging + kConsumers * kBoxes * kSlabBytes);
  uint64_t* win_empty = win_full + p.win_stages;
  uint64_t* w_full = win_empty + p.win_stages;
  uint64_t* w_empty = w_full + p.w_stages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < p.win_stages; ++i) {
      mbar_init(&win_full[i], 1);
      mbar_init(&win_empty[i], 4 * kConsumers);
    }
    for (int i = 0; i < p.w_stages; ++i) {
      mbar_init(&w_full[i], 1);
      mbar_init(&w_empty[i], 4 * kConsumers);
    }
    bulk::fence_init();
  }
  __syncthreads();
  const int warp = tid / 32;
  const int lane = tid % 32;

  if (warp >= 4 * kConsumers) {
    // the producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != 128 * kConsumers) return;
    Ring win{0, 0}, w{0, 0};
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int n0 = (tile % p.tiles_n) * kTileN;
      const int mt = tile / p.tiles_n;
      const int l0 = (mt % p.tiles_m) * kTileM;
      const int b = mt / p.tiles_m;
      for (int c = 0; c < p.chunks; ++c) {
        // the first pass over a ring finds every stage free (parity 1)
        wait_phase(&win_empty[win.stage], win.phase ^ 1);
        mbar_expect_tx(&win_full[win.stage], p.win_bytes);
        uint8_t* dst = wins + win.stage * p.win_bytes;
        for (int i = 0; i < p.pieces; ++i)
          tma_load_3d(dst + i * p.piece_rows * kRowBytes, &xmap, c * kChunk,
                      l0 - p.pad + i * p.piece_step, b, &win_full[win.stage]);
        win.next(p.win_stages);
        for (int tap = 0; tap < p.K; ++tap) {
          wait_phase(&w_empty[w.stage], w.phase ^ 1);
          mbar_expect_tx(&w_full[w.stage], kWBytes);
          uint8_t* wt = wts + w.stage * kWBytes;
#pragma unroll
          for (int j = 0; j < kBoxes; ++j)
            tma_load_3d(wt + j * kSlabBytes, &wmap, n0 + j * kSlab,
                        c * kChunk, tap, &w_full[w.stage]);
          w.next(p.w_stages);
        }
      }
    }
  } else {
    // a consumer warpgroup: 64 rows of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp / 4;
    const int wtid = tid % 128;
    // this lane's ldmatrix row within the tile (rows 0-7 and 8-15 of its
    // warp's 16: the A fragment's two halves) and which 16 bytes of a k16
    // step it reads
    const int lane_row =
        64 * wg + 16 * (warp % 4) + lane % 8 + 8 * ((lane / 8) % 2);
    const int k_half = lane / 16;
    uint8_t* stage_out = staging + wg * kBoxes * kSlabBytes;
    float acc[64], part[64];
    Ring win{0, 0}, w{0, 0};
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int n0 = (tile % p.tiles_n) * kTileN;
      const int mt = tile / p.tiles_n;
      const int l0 = (mt % p.tiles_m) * kTileM;
      const int b = mt / p.tiles_m;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int c = 0; c < p.chunks; ++c) {
        wait_phase(&win_full[win.stage], win.phase);
        const uint32_t window = smem_u32(wins + win.stage * p.win_bytes);
        for (int tap = 0; tap < p.K; ++tap) {
          wait_phase(&w_full[w.stage], w.phase);
          const uint32_t wt = smem_u32(wts + w.stage * kWBytes);
          const int row = lane_row + tap * p.tap_stride;
          uint32_t a[kChunk / 16][4];
#pragma unroll
          for (int kk = 0; kk < kChunk / 16; ++kk)
            ldmatrix_x4(a[kk], window + row * kRowBytes +
                                   (((2 * kk + k_half) ^ (row & 7)) << 4));
#pragma unroll
          for (int f = 0; f < kChunk / kFold; ++f) {
            fence_regs(part);
            wgmma_fence();
#pragma unroll
            for (int j = 0; j < kSteps; ++j) {
              const int kk = f * kSteps + j;
              wgmma_rs(part, a[kk], b_desc(wt + kk * 16 * kRowBytes), j > 0);
            }
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(part);
#pragma unroll
            for (int i = 0; i < 64; ++i) acc[i] += part[i];
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&w_empty[w.stage]);
          w.next(p.w_stages);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&win_empty[win.stage]);
        win.next(p.win_stages);
      }

      // The epilogue: accumulator 4 j + e of a 64 x 128 product is row g
      // (e < 2) or g + 8 of the warp's 16, columns 8 j + 2 t and 8 j + 2 t
      // + 1.  Each pair goes, rounded to bf16, into the staging boxes with
      // the 128-byte swizzle (the 16-byte group j % 8 of row r sits at
      // position (j % 8) ^ (r % 8): conflict-free), then one thread stores
      // the boxes by TMA, which drops rows past L and columns past Cout.
      if (wtid == 0)  // the last tile's store has read the staging boxes
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      sync_warpgroup(wg);
      // row r = 16 (warp % 4) + g + 8 h has r % 8 = g; the lane's address
      // and g are taken afresh here (an opaque copy), so the compiler keeps
      // no precomputed staging address alive through the main loop
      uint32_t g, row_addr;
      asm volatile("mov.u32 %0, %1;" : "=r"(g) : "r"(lane / 4));
      asm volatile("mov.u32 %0, %1;"
                   : "=r"(row_addr)
                   : "r"(smem_u32(stage_out) + (16 * (warp % 4)) * 128 +
                         4 * (lane % 4)));
      row_addr += g * 128;
#pragma unroll
      for (int j = 0; j < kTileN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          asm volatile("st.shared.b32 [%0], %1;" ::"r"(
                           row_addr + (j / 8) * kSlabBytes + h * 8 * 128 +
                           (((j % 8) ^ g) << 4)),
                       "r"(*reinterpret_cast<const uint32_t*>(&v))
                       : "memory");
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      sync_warpgroup(wg);
      if (wtid == 0) {
#pragma unroll
        for (int j = 0; j < kBoxes; ++j)
          tma_store_3d(&omap, stage_out + j * kSlabBytes, n0 + j * kSlab,
                       l0 + 64 * wg, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    // the shared memory must outlive the last store's reads
    if (wtid == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// How a window stage is staged: tap_stride, pieces, piece_rows, piece_step
// as in Params, and its rows in all.
struct Geometry {
  int tap_stride, pieces, piece_rows, piece_step, rows;
};

Geometry geometry(int K, int d) {
  const int rows = kTileM + (K - 1) * d;
  const int pieces = (rows + kMaxBox - 1) / kMaxBox;
  const int piece_rows = ((rows + pieces - 1) / pieces + 7) / 8 * 8;
  Geometry g{d, pieces, piece_rows, piece_rows, pieces * piece_rows};
  if (K * kTileM < g.rows) g = Geometry{kTileM, K, kTileM, d, K * kTileM};
  return g;
}

// windows, weight stages of 64 channels by 128 outputs, the output staging
// (a 64-row box for each consumer warpgroup and 64 outputs), the mbarriers
// and the alignment
int smem_bytes(const Geometry& g, int win_stages, int w_stages) {
  return kAlign + win_stages * g.rows * kRowBytes + w_stages * kWBytes +
         kConsumers * kBoxes * kSlabBytes + 16 * (win_stages + w_stages);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

cudaError_t encode_fn(EncodeTiled* out) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || ptr == nullptr)
      return cudaErrorNotSupported;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  *out = fn;
  return cudaSuccess;
}

// a bf16 tensor [d2][d1][d0] in boxes of box0 x box1 x 1 with the 128-byte
// swizzle; loads read zeros outside it, stores skip what falls outside
cudaError_t encode_3d(CUtensorMap* map, const void* ptr, int d0, int d1,
                      int d2, int box0, int box1) {
  EncodeTiled fn;
  cudaError_t err = encode_fn(&fn);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)d0 * 2, (cuuint64_t)d0 * d1 * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
         dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// The shared memory the kernel needs at the least: the window and the
// weights in one stage each and the staging of a 128-output tile.  A
// launch takes more stages where they fit (two windows where two weight
// stages fit beside them, up to 8 weight stages).
extern "C" int conv1d_bf16_smem_bytes(int K, int dilation) {
  return smem_bytes(geometry(K, dilation), 1, 1);
}

extern "C" int conv1d_bf16_forward(const void* x, const void* w, void* out,
                                   int B, int L, int C, int Cout, int K,
                                   int dilation, void* stream) {
  // per device, asked once: its SM count and the shared memory the kernel
  // may take (raised as launches need more)
  static int sms_of[kMaxDevices], smem_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int sms = sms_of[dev];
  const Geometry g = geometry(K, dilation);
  const int win_stages = smem_bytes(g, 2, 2) <= kSmemLimit ? 2 : 1;
  int w_stages = 1;
  while (w_stages < kMaxWStages &&
         smem_bytes(g, win_stages, w_stages + 1) <= kSmemLimit)
    ++w_stages;
  const int smem = smem_bytes(g, win_stages, w_stages);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;

  Params p;
  p.K = K;
  p.pad = (K - 1) * dilation / 2;
  p.chunks = (C + kChunk - 1) / kChunk;
  p.tap_stride = g.tap_stride;
  p.pieces = g.pieces;
  p.piece_rows = g.piece_rows;
  p.piece_step = g.piece_step;
  p.win_stages = win_stages;
  p.w_stages = w_stages;
  p.win_bytes = g.rows * kRowBytes;
  p.tiles_m = (L + kTileM - 1) / kTileM;
  p.tiles_n = (Cout + kTileN - 1) / kTileN;
  p.tiles = B * p.tiles_m * p.tiles_n;

  CUtensorMap xmap, wmap, omap;
  err = encode_3d(&xmap, x, C, L, B, kChunk, g.piece_rows);
  if (err == cudaSuccess) err = encode_3d(&wmap, w, Cout, C, K, kSlab, kChunk);
  if (err == cudaSuccess) err = encode_3d(&omap, out, Cout, L, B, kSlab, 64);
  if (err != cudaSuccess) return (int)err;
  if (smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(
        conv1d_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = smem;
  }
  const int grid = p.tiles < sms ? p.tiles : sms;
  conv1d_bf16_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      xmap, wmap, omap, p);
  return (int)cudaGetLastError();
}

extern "C" const char* conv1d_bf16_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
