// 4x4 / stride-2 / pad-1 convolution kernels for Hopper (sm_90a), with a plain
// C interface: the FC-Discriminator's first conv (C = 19 classes -> CO = 64).
//
// K5a, conv_fwd: replaces rtda_semanticsegmentation_tpu/ops/pallas_conv.py
// ::conv4x4s2p1 (_conv_kernel).
//   y[b,co,i,j] = sum_{ci,ky,kx} bf16(x[b,ci,2i+ky-1,2j+kx-1]) * bf16(w[co,ci,ky,kx])
// K5b, conv_dw: replaces ...::conv4x4s2p1_dw (_dw_kernel).
//   dw[co,ci,ky,kx] = sum_{b,i,j} bf16(x[b,ci,2i+ky-1,2j+kx-1]) * bf16(dy[b,co,i,j])
// K5c, conv_dx: replaces ...::conv4x4s2p1_dx (_dx_kernel).
//   dx[b,ci,y,x] = sum over the 2x2 taps with ky = y+1 (mod 2), kx = x+1 (mod 2)
//                  and all co of bf16(dy[b,co,(y+1-ky)/2,(x+1-kx)/2]) * bf16(w[co,ci,ky,kx])
// Zero padding outside the image. The operands are rounded to bf16 (RNE), as
// the TPU kernels round them (pallas_conv.py:61,89; :219-223; :319,331); the
// products are exact and add in f32 on the tensor cores, and each result is
// rounded once to its output type.
//
// Layout: NCHW as the port keeps its softmax maps; w (CO, C, 4, 4) f32
// (OIHW); y and dy (B, CO, H/2, W/2). H and W are even. C <= kMaxC,
// CO <= kMaxCO. The kernels read x and dy as bf16 and write y and dx
// through TMA, which needs 16-byte aligned bases and row pitches: each takes
// the row pitches of its operands in elements, a multiple of 8 (4 for an
// f32 y or dx). The wrapper (kernels/conv4x4.py::launch_plan) copies an
// operand that is not so (an f32 x or dy, a width off a multiple of 8) and
// writes a padded y or dx, copied out; the flagship's maps need no copy.
//
// What bounds them on an H100: bytes. At the slice's shapes each kernel does
// about 140 FLOP per byte it must move, below the card's bf16 ratio of ~295
// (0.154 ms for a 720x1280 batch of 8). All three are persistent, warp-
// specialised wgmma kernels (hopper_conv.cuh): one block per SM, one TMA
// producer thread keeping a ring of stages filled across tiles, and
// consumer warpgroups (two for K5a and K5b, three for K5c):
// - a tile is two output rows, whose 6 input rows (a band; rows 2i-1 ..
//   2i+2 of the first) come in by tiled 4-D TMA boxes (W, H, C, B) of 144
//   columns per 64 output columns j0 .. j0+63: input columns 2 j0 - 8 on.
//   A tiled TMA access must start its innermost coordinate on a 16-byte
//   boundary (a start at 2 j0 - 1 faults with an illegal instruction on the
//   H100), so the box starts 7 columns before the first one the tile reads.
//   Boxes that start before the image or run past it read zeros: TMA's
//   zero fill is the padding. Each input row is read for 1.5 output rows
//   instead of the two of a one-row tile;
// - K5a: M = pixels, N = co (64), K = (ci, ky, kx), one k16 step per input
//   channel (its 16 taps). A comes from registers (wgmma m64n64k16, A in
//   registers, whose per-warp fragment is mma.sync m16n8k16's): the pair
//   (kx, kx+1) of pixel m lies at band columns 2m + kx + 7 and + 8, the odd
//   half of one word and the even half of the next, so a fragment register
//   is two aligned 32-bit loads and a byte permute. The bf16 weights are
//   staged once per block as the K-major B operand, in 8 x 8 core matrices.
//   A tile is 2 rows x 64 columns, one box, each consumer warpgroup one
//   row (one m64 block), so a ring of 4 stages (3 with an f32 y) fits
//   beside the weights (2 x 128-column tiles left room for 2 stages and
//   ran 0.697 ms per flagship step on an H100, against 0.623). The epilogue
//   rounds the block into shared memory in the 128-byte swizzle
//   (conflict-free writes), and one thread stores it into NCHW y by TMA,
//   which clips the ragged edges; two output buffers per warpgroup let the
//   store run on under the next tile's MMAs;
// - K5b: M = (ci, tap) (5 m64 blocks of 4 channels, split 3 / 2 over the two
//   warpgroups), N = co, K = pixels. A = im2col^T from registers: a pair of
//   neighbouring pixels of one tap lies two columns apart in the band, so a
//   fragment is eight 16-bit loads (144-column rows: a warp's two band rows
//   lie 8 banks apart). B = dy, already K-major in NCHW (pixels contiguous
//   per channel): a TMA box of 64 pixels x 64 co per output row, 128-byte
//   swizzle, read by wgmma from its descriptor as it lands. A tile is 2 rows
//   x 64 pixels; each m64 block's 8 k16 steps run as one chain into a fresh
//   accumulator, added into the f32 totals with round-to-nearest adds (the
//   tensor cores round their running sum toward zero). The blocks write
//   partial (C*16, 64) sums to a workspace and a second kernel adds them in
//   block order: deterministic, no float atomics;
// - K5c: the TPU's overlap-add along columns, a gather along rows. Output
//   rows 2i - 1 and 2i (a row pair) take the taps ky = ry + 2 from dy row
//   i - 1 and ky = ry from row i, so a pair is one GEMM with K = (2 dy
//   rows, co) = 128; M = (ry, kx, ci) = 3 m64 blocks, one per consumer
//   warpgroup (8 channels each, C padded to 24); N = 144 dy columns, the
//   tile's 128 and one 8-column group on each side. Warp w of a warpgroup
//   holds the taps of one output row parity and column parity, so each
//   output column adds one accumulator value of the thread to one of a
//   neighbour lane (a shuffle): no shifted operand, and no output written
//   twice. A (the weights) stays in registers for the launch; B (dy) comes
//   by TMA as 1 KB boxes of 8 columns x 64 co per dy row, the unswizzled
//   MN-major layout of 8 x 8 core matrices, read by descriptor; a tile is 2
//   row pairs whose 3 dy rows are one stage, so each dy row crosses L2 to
//   the SM 1.5 times (1.69 with the edge groups) instead of twice. dx goes
//   out by TMA from swizzled buffers, two per warpgroup, row by row (the
//   first pair's row -1 and the last pair's row H are skipped; TMA clips
//   columns past W and channels past C). Persistent, one block per SM, one
//   producer warpgroup and three consumer warpgroups (setmaxnreg 40 / 152);
//   each output is a sum of two f32 chains of 128 products (round-to-
//   nearest add), rounded once.
// A wedged pipeline traps after ~19 s (hopper_conv.cuh::mbar_wait).
//
// Each launch function encodes the tensor maps on the host, enqueues on the
// given stream and returns cudaGetLastError() or an encode error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_conv.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxC = 20;
constexpr int kMaxCO = 64;
constexpr size_t kMaxSmem = 232448;       // an H100 block's dynamic shared-memory limit

// ---- K5a and K5b (wgmma, TMA) ----
constexpr int kBandRows = 6;                                  // input rows of a 2-output-row tile
constexpr int kBoxW = 144;  // input columns of a box: 2 j0 - 8 .. 2 j0 + 135 for 64 outputs from j0
constexpr int kFwdBox = kMaxC * kBandRows * kBoxW * 2;        // bytes of a K5a box at C = 20
constexpr int kFwdStage = (kFwdBox + 1023) / 1024 * 1024;
constexpr int kWBytes = kMaxC * 2048;                         // K5a's weights: 2 KB per k16 step
constexpr int kDyBox = 64 * 128;                              // K5b: 64 co x 64 pixels, bf16
constexpr int kDwStage = (2 * kDyBox + kMaxC * kBandRows * kBoxW * 2 + 1023) / 1024 * 1024;
constexpr int kDwStages = 4;

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// the bf16 pair at columns 2 k + 1 and 2 k + 2 of a row, from the words at
// `addr` (columns 2 k, 2 k + 1) and `addr` + 4
__device__ __forceinline__ uint32_t pair_at(uint32_t addr) { return __byte_perm(lds32(addr), lds32(addr + 4), 0x5432); }

__device__ __forceinline__ uint32_t lds16(uint32_t addr) {
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

// d (+)= a (64 x 16, registers) * b (16 x 64, K-major in shared memory):
// wgmma m64n64k16, bf16 -> f32; scale_d 0 starts a fresh sum.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int q = 0; q < 32; ++q) hconv::fence_reg(d[q]);
}

__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

// A tile of K5a / K5b: image b, output rows 2 th, 2 th + 1, columns from
// tw x the tile width.
struct Tile {
  int b, th, tw;
  __device__ Tile(int tile, int tiles_w, int tiles_h)
      : b(tile / (tiles_w * tiles_h)), th((tile / tiles_w) % tiles_h), tw(tile % tiles_w) {}
};

struct FwdParams {
  int C, CO, Ho, Wo;
  int tiles_w, tiles_h, tiles;
  uint32_t tx_bytes;  // the TMA bytes of a stage: one box of (144, 6, C)
};

// Stages of K5a's ring: 4 with a bf16 y, 3 with an f32 y (whose output
// buffers take twice the room).
template <typename Ty>
__host__ __device__ constexpr int fwd_stages() { return sizeof(Ty) == 2 ? 4 : 3; }

template <typename Ty>
__host__ __device__ constexpr int fwd_out_bytes() { return 64 * 64 * sizeof(Ty); }

// K5a. Stage: one box, the band under output columns j0 .. j0+63 (input
// columns 2 j0 - 8 on). Consumer warpgroup wg computes output row
// 2 th + wg (one m64 block); its warp w the pixels 16 w .. 16 w + 15. Each
// warpgroup has two output buffers, so a tile's TMA store runs on while the
// next tile's MMAs are issued.
template <typename Ty>
__global__ void __launch_bounds__(hconv::kThreads, 1)
conv_fwd_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap ymap,
                const float* __restrict__ w, FwdParams p) {
  constexpr int kEpb = 128 / sizeof(Ty);  // y elements per 128-byte row of a store box
  constexpr int kOutBytes = fwd_out_bytes<Ty>();
  extern __shared__ uint8_t smem[];
  using R = hconv::Ring<kFwdStage, fwd_stages<Ty>()>;
  const R r(smem);
  const uint32_t wsm = r.extra(), outsm = wsm + kWBytes;
  uint8_t* const generic = smem - hconv::smem_u32(smem);  // shared address -> generic pointer
  {
    // weights (co, ci, tap) at k16 step ci, core matrix (co / 8, tap / 8), row co % 8, column tap % 8
    bf16* ws = reinterpret_cast<bf16*>(generic + wsm);
    for (int e = threadIdx.x; e < kMaxC * 1024; e += hconv::kThreads) {
      const int ci = e >> 10, co = ((e >> 7) & 7) * 8 + ((e >> 3) & 7), tap = ((e >> 6) & 1) * 8 + (e & 7);
      ws[e] = __float2bfloat16_rn(ci < p.C && co < p.CO ? w[(co * p.C + ci) * 16 + tap] : 0.0f);
    }
    hconv::fence_async_smem();
  }
  r.init();
  hconv::Cursor<R::kStages> c;
  const int wg = threadIdx.x / 128;

  if (wg == hconv::kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == hconv::kConsumers * 128) {
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, c.next()) {
        const Tile t(tile, p.tiles_w, p.tiles_h);
        hconv::mbar_wait(r.empty_bar(c.s), c.phase ^ 1);
        const uint32_t full = r.full_bar(c.s);
        hconv::mbar_expect_tx(full, p.tx_bytes);
        hconv::tma_load_4d(r.stage(c.s), &xmap, full, 128 * t.tw - 8, 4 * t.th - 1, 0, t.b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31, g = lane >> 2, q4 = lane & 3, warp = (threadIdx.x >> 5) & 3;
    const bool elected = (threadIdx.x & 127) == 0;
    // a0: band row 2 wg + q4 / 2, columns 2 m + kx + 7 and + 8 for pixel m = 16 warp + g and
    // kx = 2 (q4 & 1): the odd half of one word and the even half of the next; a1 pixel m + 8
    // (16 columns on), a2 and a3 two rows down (ky + 2)
    const uint32_t a_off = ((2 * wg + (q4 >> 1)) * kBoxW + 2 * (16 * warp + g) + 2 * (q4 & 1) + 6) * 2;
    constexpr uint32_t kRowBytes = kBoxW * 2, kChBytes = kBandRows * kBoxW * 2;
    float acc[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) acc[q] = 0.0f;
    int n = 0;  // tiles done by this block: output buffer n % 2
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, c.next(), ++n) {
      const Tile t(tile, p.tiles_w, p.tiles_h);
      hconv::mbar_wait(r.full_bar(c.s), c.phase);
      const uint32_t st = r.stage(c.s) + a_off;
      for (int ci = 0; ci < p.C; ++ci) {
        const uint32_t a = st + ci * kChBytes;
        const uint32_t a0 = pair_at(a), a1 = pair_at(a + 32), a2 = pair_at(a + 2 * kRowBytes),
                       a3 = pair_at(a + 2 * kRowBytes + 32);
        hconv::wgmma_fence();
        wgmma_rs(acc, a0, a1, a2, a3, hconv::desc_sw(wsm + ci * 2048, 128, 256, false), ci > 0);
      }
      hconv::wgmma_commit();
      hconv::wgmma_wait<0>();
      fence_acc(acc);
      hconv::mbar_arrive(r.empty_bar(c.s));

      // epilogue: acc[4 jn + q] is pixel 16 warp + g + 8 (q >> 1), channel
      // 8 jn + 2 q4 + (q & 1)
      const uint32_t out = outsm + (2 * wg + (n & 1)) * kOutBytes;
      const int i = 2 * t.th + wg, j0 = 64 * t.tw;
      if (elected) hconv::bulk_wait_read<1>();  // the store of two tiles ago has read this buffer
      hconv::named_barrier(1 + wg, 128);
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int px = 16 * warp + g + 8 * (q >> 1), co = 8 * jn + 2 * q4 + (q & 1);
          const int col = (px % kEpb) * static_cast<int>(sizeof(Ty));
          const uint32_t at = out + (px / kEpb) * 8192 + co * 128 + ((((col >> 4) ^ (co & 7)) << 4) | (col & 15));
          put(reinterpret_cast<Ty*>(generic + at), acc[4 * jn + q]);
        }
      }
      hconv::fence_async_smem();
      hconv::named_barrier(1 + wg, 128);
      if (elected) {
        if (i < p.Ho)
          for (int k = 0; k < 64 / kEpb && j0 + k * kEpb < p.Wo; ++k)
            hconv::tma_store_4d(&ymap, out + k * 8192, j0 + k * kEpb, i, 0, t.b);
        hconv::bulk_commit();  // one group per tile, empty past the last row
      }
    }
    if (elected) hconv::bulk_wait();
  }
}

struct DwParams {
  int C, Ho, Wo;
  int tiles_w, tiles_h, tiles;
  uint32_t tx_bytes;  // the TMA bytes of a stage: two dy boxes and one x box of (144, 6, C)
};

// K5b. Stage: dy of output rows 2 th and 2 th + 1, columns j0 .. j0+63 (two
// swizzled boxes of 64 co x 128 bytes), then the band (input columns
// 2 j0 - 8 on). Consumer warpgroup wg owns the m64 blocks wg, wg + 2, wg + 4
// (input channels 4 mb .. 4 mb + 3, one per warp, 16 taps each) and keeps
// their totals over every tile of its block.
__global__ void __launch_bounds__(hconv::kThreads, 1)
conv_dw_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap dymap,
               float* __restrict__ partial, DwParams p) {
  extern __shared__ uint8_t smem[];
  using R = hconv::Ring<kDwStage, kDwStages>;
  const R r(smem);
  r.init();
  hconv::Cursor<R::kStages> c;
  const int wg = threadIdx.x / 128;

  if (wg == hconv::kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == hconv::kConsumers * 128) {
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, c.next()) {
        const Tile t(tile, p.tiles_w, p.tiles_h);
        hconv::mbar_wait(r.empty_bar(c.s), c.phase ^ 1);
        const uint32_t full = r.full_bar(c.s), st = r.stage(c.s);
        hconv::mbar_expect_tx(full, p.tx_bytes);
        hconv::tma_load_4d(st, &dymap, full, 64 * t.tw, 2 * t.th, 0, t.b);
        hconv::tma_load_4d(st + kDyBox, &dymap, full, 64 * t.tw, 2 * t.th + 1, 0, t.b);
        hconv::tma_load_4d(st + 2 * kDyBox, &xmap, full, 128 * t.tw - 8, 4 * t.th - 1, 0, t.b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31, g = lane >> 2, q4 = lane & 3, warp = (threadIdx.x >> 5) & 3;
    // A row g is tap g: (ky, kx) = (g / 4, g % 4); row g + 8 is ky + 2. The
    // element (tap, pixel j) of output row rr lies at band row 2 rr + ky,
    // column 2 j + kx + 7: a0 holds pixels 2 q4, 2 q4 + 1 (columns c, c + 2),
    // a1 two rows down, a2 and a3 pixels 8 on (16 columns).
    constexpr uint32_t kRowBytes = kBoxW * 2, kChBytes = kBandRows * kBoxW * 2;
    const uint32_t a_off = ((g >> 2) * kBoxW + 4 * q4 + (g & 3) + 7) * 2;
    float total[3][32], acc[32];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int q = 0; q < 32; ++q) total[k][q] = 0.0f;
#pragma unroll
    for (int q = 0; q < 32; ++q) acc[q] = 0.0f;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, c.next()) {
      hconv::mbar_wait(r.full_bar(c.s), c.phase);
      const uint32_t st = r.stage(c.s);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int mb = wg + 2 * k;
        if (4 * mb >= p.C) break;  // uniform over the warpgroup
        const int ci = 4 * mb + warp;
        const bool live = ci < p.C;  // a channel past C is not in the box: zeros
        const uint32_t x0 = st + 2 * kDyBox + ci * kChBytes + a_off;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const uint32_t a = x0 + 2 * rr * kRowBytes + 64 * s;
            uint32_t av[4] = {0u, 0u, 0u, 0u};
            if (live) {
#pragma unroll
              for (int f = 0; f < 4; ++f) {
                const uint32_t e = a + (f & 1) * 2 * kRowBytes + (f >> 1) * 32;
                av[f] = lds16(e) | (lds16(e + 4) << 16);
              }
            }
            hconv::wgmma_fence();
            wgmma_rs(acc, av[0], av[1], av[2], av[3], hconv::desc_sw(st + rr * kDyBox + 32 * s, 16, 1024),
                     rr + s > 0);
          }
        }
        hconv::wgmma_commit();
        hconv::wgmma_wait<0>();
        fence_acc(acc);
#pragma unroll
        for (int q = 0; q < 32; ++q) total[k][q] = __fadd_rn(total[k][q], acc[q]);
      }
      hconv::mbar_arrive(r.empty_bar(c.s));
    }
    // partial[block][(ci*16 + tap)*kMaxCO + co]: total[k][4 jn + q] is tap
    // g + 8 (q >> 1), channel 8 jn + 2 q4 + (q & 1)
    float* outp = partial + static_cast<size_t>(blockIdx.x) * p.C * 16 * kMaxCO;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int ci = 4 * (wg + 2 * k) + warp;
      if (ci >= p.C) continue;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const int co = 8 * jn + 2 * q4;
        *reinterpret_cast<float2*>(outp + (ci * 16 + g) * kMaxCO + co) = make_float2(total[k][4 * jn], total[k][4 * jn + 1]);
        *reinterpret_cast<float2*>(outp + (ci * 16 + g + 8) * kMaxCO + co) =
            make_float2(total[k][4 * jn + 2], total[k][4 * jn + 3]);
      }
    }
  }
}

// ---- K5c (wgmma, TMA) ----
constexpr int kDxPairs = 2;                          // output row pairs of a K5c tile
constexpr int kDxRows = kDxPairs + 1;                // dy rows of its stage
constexpr int kDxCols = 128;                         // dy columns whose outputs a tile writes
constexpr int kDxGroups = kDxCols / 8 + 2;           // 8-column groups it reads: one more each side
constexpr int kDxGroupBytes = kDxRows * kMaxCO * 16; // one group: [row][co][8 columns] bf16
constexpr int kDxStage = kDxGroups * kDxGroupBytes;  // 55,296 B
constexpr int kDxConsumers = 3;                      // one per 8 input channels
constexpr int kDxThreads = 128 * (kDxConsumers + 1);

// Stages of K5c's ring: 3 with a bf16 dx, 2 with an f32 dx (whose output
// buffers take twice the room).
template <typename Tx>
__host__ __device__ constexpr int dx_stages() { return sizeof(Tx) == 2 ? 3 : 2; }

// One output buffer: 2 rows x 8 channels x 256 columns.
template <typename Tx>
__host__ __device__ constexpr int dx_out_bytes() { return 8 * 2 * 2 * kDxCols * sizeof(Tx); }

struct DxParams {
  int C, CO, H, W, Ho, Wo;
  int strips, chunks, tiles;
};

// A tile of K5c: image b, row pairs i0 .. i0 + kDxPairs - 1, dy columns j0
// .. j0 + 127 (strips fastest, so neighbouring strips share their edge
// groups in L2).
struct DxTile {
  int b, i0, j0;
  __device__ DxTile(int tile, const DxParams& p)
      : b(tile / (p.strips * p.chunks)),
        i0((tile / p.strips) % p.chunks * kDxPairs),
        j0(tile % p.strips * kDxCols) {}
};

// d (+)= a (64 x 16, registers) * b (16 x 144, MN-major in shared memory):
// wgmma m64n144k16, bf16 -> f32; scale_d 0 starts a fresh sum.
__device__ __forceinline__ void wgmma_dx(float (&d)[72], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71}, "
      "{%72, %73, %74, %75}, %76, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void fence_acc(float (&d)[72]) {
#pragma unroll
  for (int q = 0; q < 72; ++q) hconv::fence_reg(d[q]);
}

// K5c, the overlap-add of the TPU kernel along columns and a gather along
// rows. Output rows 2i - 1 and 2i (a row pair) read dy rows i - 1 (taps
// ky = ry + 2) and i (ky = ry), ry the row's parity. GEMM of a row pair:
// M = (ry, kx, ci) in 3 m64 blocks, one per consumer warpgroup (channels
// 8 wg .. 8 wg + 7); N = 144 dy columns, j0 - 8 .. j0 + 135; K = (dy row,
// co), 128. Warp w of a warpgroup holds ry = w / 2 and the column parity
// par = w % 2 of its outputs: rows g (kx = 1 + par) and g + 8 (kx = 3 - 3
// par) of its 16, so that dx[2j + 1] = Z[j][kx 2] + Z[j + 1][kx 0] and
// dx[2j] = Z[j][kx 1] + Z[j - 1][kx 3] add one value of the thread to one
// of its neighbour lane (a shuffle). A, the weights, stays in registers for
// the whole launch; B, dy, comes by TMA as 18 groups of 8 columns x 64 co x
// 3 rows, the unswizzled MN-major layout of 8 x 8 core matrices, read by
// descriptor (54 loads of 1 KB a stage). The epilogue writes the warpgroup's
// 2 rows x 8 channels x 256 columns into a swizzled buffer, and one thread
// stores it by TMA, row by row (rows -1 and H skipped; TMA clips columns
// past W and channels past C); two buffers per warpgroup let the store run
// under the next pair's MMAs.
template <typename Tx>
__global__ void __launch_bounds__(kDxThreads, 1)
conv_dx_kernel(const __grid_constant__ CUtensorMap dymap, const __grid_constant__ CUtensorMap dxmap,
               const float* __restrict__ w, DxParams p) {
  constexpr int kEpb = 128 / sizeof(Tx);  // dx elements per 128-byte row of a store box
  constexpr int kOutBytes = dx_out_bytes<Tx>();
  extern __shared__ uint8_t smem[];
  using R = hconv::Ring<kDxStage, dx_stages<Tx>(), kDxConsumers>;
  const R r(smem);
  r.init();
  hconv::Cursor<R::kStages> c;
  const int wg = threadIdx.x / 128;

  if (wg == kDxConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kDxConsumers * 128) {
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, c.next()) {
        const DxTile t(tile, p);
        hconv::mbar_wait(r.empty_bar(c.s), c.phase ^ 1);
        const uint32_t full = r.full_bar(c.s), st = r.stage(c.s);
        hconv::mbar_expect_tx(full, kDxStage);
        for (int q = 0; q < kDxGroups; ++q)
          for (int rr = 0; rr < kDxRows; ++rr)
            hconv::tma_load_4d(st + q * kDxGroupBytes + rr * kMaxCO * 16, &dymap, full, t.j0 - 8 + 8 * q,
                               t.i0 - 1 + rr, 0, t.b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n");
    const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3, warp = (threadIdx.x >> 5) & 3;
    const int ry = warp >> 1, par = warp & 1, ci = 8 * wg + g;
    // A fragment of k16 step ks: dy row i - 1 (ks < 4) or i, channels
    // 16 (ks % 4) + 2 t4 (+1) and + 8; register f: row g (kx_g) or g + 8
    // (kx_h) as f is even or odd
    const int kx_g = 1 + par, kx_h = 3 - 3 * par;
    uint32_t a[8][4];
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const int ky = ry + (ks < 4 ? 2 : 0);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int kx = (f & 1) ? kx_h : kx_g, co = 16 * (ks & 3) + 2 * t4 + 8 * (f >> 1);
        float v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          v[h] = ci < p.C && co + h < p.CO ? w[(((co + h) * p.C + ci) * 4 + ky) * 4 + kx] : 0.0f;
        const __nv_bfloat162 pair = __floats2bfloat162_rn(v[0], v[1]);
        a[ks][f] = *reinterpret_cast<const uint32_t*>(&pair);
      }
    }
    uint8_t* const generic = smem - hconv::smem_u32(smem);  // shared address -> generic pointer
    const bool elected = (threadIdx.x & 127) == 0;
    // the neighbour lane whose value completes an output: t4 + 1 (par 1) or t4 - 1 (par 0)
    const int src = (lane & ~3) | ((t4 + (par ? 1 : 3)) & 3);
    float acc[72];
    int n = 0;  // row pairs done by this warpgroup: output buffer n % 2
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, c.next()) {
      const DxTile t(tile, p);
      hconv::mbar_wait(r.full_bar(c.s), c.phase);
      const uint32_t st = r.stage(c.s);
      for (int pr = 0; pr < kDxPairs && t.i0 + pr <= p.Ho; ++pr, ++n) {
        const int i = t.i0 + pr;
        hconv::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          const uint32_t b = st + (pr + (ks >> 2)) * (kMaxCO * 16) + (ks & 3) * 256;
          wgmma_dx(acc, a[ks], hconv::desc_sw(b, 128, kDxGroupBytes, false), ks > 0);
        }
        hconv::wgmma_commit();
        hconv::wgmma_wait<0>();
        fence_acc(acc);

        // epilogue: acc[4 q + e] is row g, column 8 q + 2 t4 + e; acc[4 q + 2 + e] row g + 8
        const uint32_t out = r.extra() + (2 * wg + (n & 1)) * kOutBytes;
        if (elected) hconv::bulk_wait_read<1>();  // the store of two pairs ago has read this buffer
        hconv::named_barrier(1 + wg, 128);
        const int line = 8 * ry + g;  // the buffer's 128-byte row: output row 2i - 1 + ry, channel g
#pragma unroll
        for (int q = 1; q <= 16; ++q) {
          const float send = par ? (t4 == 0 ? acc[4 * q + 6] : acc[4 * q + 2]) : (t4 == 3 ? acc[4 * q - 1] : acc[4 * q + 3]);
          const float nb = __shfl_sync(0xffffffffu, send, src);
          const float v[2] = {par ? __fadd_rn(acc[4 * q], acc[4 * q + 3]) : __fadd_rn(acc[4 * q], nb),
                              par ? __fadd_rn(acc[4 * q + 1], nb) : __fadd_rn(acc[4 * q + 1], acc[4 * q + 2])};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 16 * (q - 1) + 4 * t4 + 2 * e + par;  // output column - 2 j0
            const int byte = (x % kEpb) * static_cast<int>(sizeof(Tx));
            const uint32_t at = out + (x / kEpb) * 2048 + line * 128 + ((((byte >> 4) ^ (line & 7)) << 4) | (byte & 15));
            put(reinterpret_cast<Tx*>(generic + at), v[e]);
          }
        }
        hconv::fence_async_smem();
        hconv::named_barrier(1 + wg, 128);
        if (elected) {
          for (int rw = 0; rw < 2; ++rw) {
            const int y = 2 * i - 1 + rw;  // rows -1 and H are not stored
            if (8 * wg >= p.C || y < 0 || y >= p.H) continue;
            for (int k = 0; k < 2 * kDxCols / kEpb && 2 * t.j0 + k * kEpb < p.W; ++k)
              hconv::tma_store_4d(&dxmap, out + k * 2048 + rw * 1024, 2 * t.j0 + k * kEpb, y, 8 * wg, t.b);
          }
          hconv::bulk_commit();  // one group per pair, empty where the warpgroup has no channel
        }
      }
      hconv::mbar_arrive(r.empty_bar(c.s));
    }
    if (elected) hconv::bulk_wait();
  }
}

// ---- the dW reduction ----
constexpr int kThreads = 256;

// Sums the blocks' partial weight gradients in block order into dw (CO, C, 4, 4).
__global__ void conv_dw_reduce(const float* __restrict__ partial, float* __restrict__ dw,
                               int blocks, int C, int CO) {
  const int n = C * 16 * kMaxCO;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int co = e % kMaxCO;
  if (co >= CO) return;
  float s = 0.0f;
  for (int j = 0; j < blocks; ++j) s += partial[static_cast<size_t>(j) * n + e];
  dw[static_cast<size_t>(co) * C * 16 + e / kMaxCO] = s;
}

bool valid_shape(int B, int C, int H, int W, int CO, int blocks) {
  return B >= 1 && C >= 1 && C <= kMaxC && CO >= 1 && CO <= kMaxCO && H >= 2 && W >= 2 &&
         H % 2 == 0 && W % 2 == 0 && blocks >= 1;
}

template <typename Ty>
int launch_fwd(const void* x, const void* w, void* y, int B, int C, int H, int W, int CO, int x_pitch, int y_pitch,
               int blocks, cudaStream_t s) {
  constexpr int es = sizeof(Ty);
  const int Ho = H / 2, Wo = W / 2;
  CUtensorMap xmap, ymap;
  const long long xrow = 2LL * x_pitch, yrow = 1LL * es * y_pitch;
  int err = hconv::encode_tiled_4d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, W, H, C, B, xrow, xrow * H,
                                   xrow * H * C, kBoxW, kBandRows, C, false);
  if (err) return err;
  err = hconv::encode_tiled_4d(&ymap, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                               y, Wo, Ho, CO, B, yrow, yrow * Ho, yrow * Ho * CO, 128 / es, 1, 64, true);
  if (err) return err;
  const int tiles_w = (Wo + 63) / 64, tiles_h = (Ho + 1) / 2;
  const long long tiles = 1LL * B * tiles_w * tiles_h;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const FwdParams p{C, CO, Ho, Wo, tiles_w, tiles_h, static_cast<int>(tiles),
                    static_cast<uint32_t>(C * kBandRows * kBoxW * 2)};
  const int smem = 1024 + fwd_stages<Ty>() * kFwdStage + 1024 + kWBytes + 4 * fwd_out_bytes<Ty>();
  static_assert(1024 + 4 * kFwdStage + 1024 + kWBytes + 4 * 8192 <= kMaxSmem, "K5a bf16 shared memory");
  static_assert(1024 + 3 * kFwdStage + 1024 + kWBytes + 4 * 16384 <= kMaxSmem, "K5a f32 shared memory");
  static const cudaError_t attr =
      cudaFuncSetAttribute(conv_fwd_kernel<Ty>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  conv_fwd_kernel<Ty><<<blocks, hconv::kThreads, smem, s>>>(xmap, ymap, static_cast<const float*>(w), p);
  return cudaGetLastError();
}

int launch_dw(const void* x, const void* dy, void* partial, void* dw, int B, int C, int H, int W, int CO,
              int x_pitch, int dy_pitch, int blocks, cudaStream_t s) {
  const int Ho = H / 2, Wo = W / 2;
  CUtensorMap xmap, dymap;
  const long long xrow = 2LL * x_pitch, dyrow = 2LL * dy_pitch;
  int err = hconv::encode_tiled_4d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, W, H, C, B, xrow, xrow * H,
                                   xrow * H * C, kBoxW, kBandRows, C, false);
  if (err) return err;
  err = hconv::encode_tiled_4d(&dymap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, dy, Wo, Ho, CO, B, dyrow, dyrow * Ho,
                               dyrow * Ho * CO, 64, 1, 64, true);
  if (err) return err;
  const int tiles_w = (Wo + 63) / 64, tiles_h = (Ho + 1) / 2;
  const long long tiles = 1LL * B * tiles_w * tiles_h;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const DwParams p{C, Ho, Wo, tiles_w, tiles_h, static_cast<int>(tiles),
                   static_cast<uint32_t>(2 * kDyBox + C * kBandRows * kBoxW * 2)};
  const int smem = 1024 + kDwStages * kDwStage + 1024;
  static const cudaError_t attr =
      cudaFuncSetAttribute(conv_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  conv_dw_kernel<<<blocks, hconv::kThreads, smem, s>>>(xmap, dymap, static_cast<float*>(partial), p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n = C * 16 * kMaxCO;
  conv_dw_reduce<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), blocks, C, CO);
  return cudaGetLastError();
}

template <typename Tx>
int launch_dx(const void* dy, const void* w, void* dx, int B, int C, int H, int W, int CO, int dy_pitch, int dx_pitch,
              int blocks, cudaStream_t s) {
  constexpr int es = sizeof(Tx);
  const int Ho = H / 2, Wo = W / 2;
  CUtensorMap dymap, dxmap;
  const long long dyrow = 2LL * dy_pitch, xrow = 1LL * es * dx_pitch;
  // dy (Wo, Ho, CO, B): a box is 8 columns x 1 row x 64 co, [co][8 columns] in shared memory
  int err = hconv::encode_tiled_4d(&dymap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, dy, Wo, Ho, CO, B, dyrow, dyrow * Ho,
                                   dyrow * Ho * CO, 8, 1, kMaxCO, false);
  if (err) return err;
  // dx (W, H, C, B): a store box is 128 bytes x 1 row x 8 channels, 128-byte swizzle
  err = hconv::encode_tiled_4d(&dxmap, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                               dx, W, H, C, B, xrow, xrow * H, xrow * H * C, 128 / es, 1, 8, true);
  if (err) return err;
  const int strips = (Wo + kDxCols - 1) / kDxCols, chunks = (Ho + 1 + kDxPairs - 1) / kDxPairs;
  const long long tiles = 1LL * B * strips * chunks;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const DxParams p{C, CO, H, W, Ho, Wo, strips, chunks, static_cast<int>(tiles)};
  const int smem = 1024 + dx_stages<Tx>() * kDxStage + 1024 + 2 * kDxConsumers * dx_out_bytes<Tx>();
  static_assert(1024 + 3 * kDxStage + 1024 + 6 * 8192 <= kMaxSmem, "K5c bf16 shared memory");
  static_assert(1024 + 2 * kDxStage + 1024 + 6 * 16384 <= kMaxSmem, "K5c f32 shared memory");
  static const cudaError_t attr =
      cudaFuncSetAttribute(conv_dx_kernel<Tx>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  conv_dx_kernel<Tx><<<blocks, kDxThreads, smem, s>>>(dymap, dxmap, static_cast<const float*>(w), p);
  return cudaGetLastError();
}

// K5a and K5b take x (and dy) bf16, 16-byte aligned, with row pitches in
// elements (multiples of 8, and of 4 for an f32 y); K5c takes dy so and
// writes dx with a row pitch of a multiple of 8 (bf16) or 4 (f32) elements.
// blocks: persistent blocks, one per SM. Shapes are those of x: (B, C, H, W).
bool pitched(const void* p, int pitch, int width, int esize) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && pitch >= width && (1LL * pitch * esize) % 16 == 0;
}

}  // namespace

extern "C" int conv4x4s2_fwd_launch(const void* x, const void* w, void* y, int B, int C, int H, int W, int CO,
                                    int x_pitch, int y_pitch, int y_bf16, int blocks, void* stream) {
  if (!valid_shape(B, C, H, W, CO, blocks) || !pitched(x, x_pitch, W, 2) ||
      !pitched(y, y_pitch, W / 2, y_bf16 ? 2 : 4))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (y_bf16) return launch_fwd<bf16>(x, w, y, B, C, H, W, CO, x_pitch, y_pitch, blocks, s);
  return launch_fwd<float>(x, w, y, B, C, H, W, CO, x_pitch, y_pitch, blocks, s);
}

extern "C" int conv4x4s2_dw_launch(const void* x, const void* dy, void* partial, void* dw, int B, int C, int H,
                                   int W, int CO, int x_pitch, int dy_pitch, int blocks, void* stream) {
  if (!valid_shape(B, C, H, W, CO, blocks) || !pitched(x, x_pitch, W, 2) || !pitched(dy, dy_pitch, W / 2, 2))
    return cudaErrorInvalidValue;
  return launch_dw(x, dy, partial, dw, B, C, H, W, CO, x_pitch, dy_pitch, blocks, static_cast<cudaStream_t>(stream));
}

extern "C" int conv4x4s2_dx_launch(const void* dy, const void* w, void* dx, int B, int C, int H, int W, int CO,
                                   int dy_pitch, int dx_pitch, int dx_bf16, int blocks, void* stream) {
  if (!valid_shape(B, C, H, W, CO, blocks) || !pitched(dy, dy_pitch, W / 2, 2) ||
      !pitched(dx, dx_pitch, W, dx_bf16 ? 2 : 4))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dx_bf16) return launch_dx<bf16>(dy, w, dx, B, C, H, W, CO, dy_pitch, dx_pitch, blocks, s);
  return launch_dx<float>(dy, w, dx, B, C, H, W, CO, dy_pitch, dx_pitch, blocks, s);
}
