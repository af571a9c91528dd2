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
// CO <= kMaxCO. K5a and K5b read x (and K5b dy) as bf16 through TMA, which
// needs 16-byte aligned bases and row pitches: each takes the row pitch of x
// (and of y or dy) in elements, a multiple of 8 (4 for an f32 y). The
// wrapper (kernels/conv4x4.py::launch_plan) copies an operand that is not so
// (an f32 x or dy, a width off a multiple of 8); the flagship's maps need no
// copy. K5c reads its operands as they are, bf16 or f32.
//
// What bounds them on an H100: bytes. At the slice's shapes each kernel does
// about 140 FLOP per byte it must move, below the card's bf16 ratio of ~295
// (0.154 ms for a 720x1280 batch of 8). K5a and K5b are persistent, warp-
// specialised wgmma kernels (hopper_conv.cuh): one block per SM, one TMA
// producer thread keeping a ring of stages filled across tiles, and two
// consumer warpgroups:
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
// - K5c (mma.sync): a gather, not the TPU's overlap-add. A tile is two input
//   rows by 256 input columns; the pixels of one row and column parity see
//   the same 2x2 taps, so each parity class is a GEMM pixels x (tap, co) x ci
//   with dy staged channel-innermost. Every output is written once: no
//   atomics, no scratch. Persistent blocks, two per SM (~91 KB of shared
//   memory each, so one block stages its next tile while the other
//   computes).
// A wedged K5a/K5b pipeline traps after ~19 s (hopper_conv.cuh::mbar_wait).
//
// Each launch function encodes the tensor maps on the host (K5a, K5b),
// enqueues on the given stream and returns cudaGetLastError() or an encode
// error.

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

// ---- K5c (mma.sync) and the dW reduction ----
constexpr int kThreads = 256;
constexpr int kDxTileW = 256;             // input columns of a K5c tile
constexpr int kDyCols = kDxTileW / 2 + 2; // dy columns a K5c tile reads
constexpr int kCoPad = kMaxCO + 8;        // bf16 per channel-innermost K5c entry (36 words)
constexpr int kLoadUnroll = 16;           // global loads in flight per thread while staging

__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }
__device__ __forceinline__ bf16 to_bf16(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// d += a (16x16, row) * b (16x8, col), bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float* d, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Stages n values into shared memory: fetch(e) reads element e from device
// memory as bf16, put(e, v) writes it. kLoadUnroll loads per thread are
// issued before the first store, so their latencies overlap.
template <typename Fetch, typename Put>
__device__ __forceinline__ void stage(int n, Fetch fetch, Put put) {
  for (int e0 = threadIdx.x; e0 < n; e0 += kThreads * kLoadUnroll) {
    bf16 v[kLoadUnroll];
#pragma unroll
    for (int k = 0; k < kLoadUnroll; ++k) {
      const int e = e0 + k * kThreads;
      v[k] = e < n ? fetch(e) : __float2bfloat16_rn(0.0f);
    }
#pragma unroll
    for (int k = 0; k < kLoadUnroll; ++k) {
      const int e = e0 + k * kThreads;
      if (e < n) put(e, v[k]);
    }
  }
}

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

// K5c. Block tile: input rows 2i-1 and 2i (both read dy rows i-1 and i),
// columns x0 .. x0+255. Warp w: row r = w&1 (y = 2i-1+r), column parity
// q = (w>>1)&1, half h = w>>2; its A rows are the pixels x0 + 2m + q with
// m = 64h .. 64h+63 (4 m16 tiles). Row y takes ky in {r, r+2} from dy rows
// i, i-1; column x takes kx = (q+1)&1 + {0, 2} from dy column
// x0/2 + m + (q+1-kx)/2. N is ci (3 n8 tiles), K is (tap, co).
template <typename Tdy, typename Tx>
__global__ void __launch_bounds__(kThreads, 2)
conv_dx_kernel(const Tdy* __restrict__ dy, const float* __restrict__ w, Tx* __restrict__ dx,
               int B, int C, int H, int W, int CO) {
  extern __shared__ float4 smem4[];
  bf16* ws = reinterpret_cast<bf16*>(smem4);  // [16 taps][24 ci][kCoPad]: w[co][ci][tap] at co
  bf16* ds = ws + 16 * 24 * kCoPad;           // [2 rows][kDyCols][kCoPad]: dy rows i-1, i
  const int Ho = H / 2, Wo = W / 2;
  for (int e = threadIdx.x; e < 16 * 24 * kMaxCO; e += kThreads) {
    const int co = e % kMaxCO, ci = (e / kMaxCO) % 24, tap = e / (kMaxCO * 24);
    const float v = (ci < C && co < CO) ? w[(static_cast<size_t>(co) * C + ci) * 16 + tap] : 0.0f;
    ws[(tap * 24 + ci) * kCoPad + co] = __float2bfloat16_rn(v);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = warp & 1, q = (warp >> 1) & 1;
  const int mbase = (warp >> 2) * 64;
  const int kxa = (q + 1) & 1;
  const int tiles_w = (W + kDxTileW - 1) / kDxTileW;
  const int tiles = B * (Ho + 1) * tiles_w;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int x0 = (tile % tiles_w) * kDxTileW;
    const int i = (tile / tiles_w) % (Ho + 1);
    const int b = tile / (tiles_w * (Ho + 1));
    __syncthreads();
    stage(
        2 * kMaxCO * kDyCols,
        [&](int e) {
          const int jl = e % kDyCols;
          const int co = (e / kDyCols) % kMaxCO;
          const int row = i - 1 + e / (kDyCols * kMaxCO);
          const int j = x0 / 2 - 1 + jl;
          if (co >= CO || row < 0 || row >= Ho || j < 0 || j >= Wo) return __float2bfloat16_rn(0.0f);
          return to_bf16(dy[((static_cast<size_t>(b) * CO + co) * Ho + row) * Wo + j]);
        },
        [&](int e, bf16 v) {
          const int jl = e % kDyCols, co = (e / kDyCols) % kMaxCO, lr = e / (kDyCols * kMaxCO);
          ds[(lr * kDyCols + jl) * kCoPad + co] = v;
        });
    __syncthreads();
    const int yy = 2 * i - 1 + r;
    if (yy < 0 || yy >= H) continue;  // every thread still meets the next tile's barriers
    float acc[4][3][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int n = 0; n < 3; ++n)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mt][n][k] = 0.0f;
#pragma unroll
    for (int ty = 0; ty < 2; ++ty) {
      const int ky = r + 2 * ty;
      const bf16* drow = ds + (1 - ty) * kDyCols * kCoPad;
#pragma unroll
      for (int tx = 0; tx < 2; ++tx) {
        const int kx = kxa + 2 * tx;
        const int col0 = mbase + g + 1 + (q + 1 - kx) / 2;
        const bf16* wt = ws + ((ky * 4 + kx) * 24 + g) * kCoPad + 2 * t;
        for (int c0 = 0; c0 < CO; c0 += 16) {
          uint32_t bq[3][2];
#pragma unroll
          for (int n = 0; n < 3; ++n) {
            bq[n][0] = ld32(wt + n * 8 * kCoPad + c0);
            bq[n][1] = ld32(wt + n * 8 * kCoPad + c0 + 8);
          }
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            const bf16* a = drow + (col0 + 16 * mt) * kCoPad + c0 + 2 * t;
            const uint32_t a0 = ld32(a), a1 = ld32(a + 8 * kCoPad), a2 = ld32(a + 8), a3 = ld32(a + 8 * kCoPad + 8);
#pragma unroll
            for (int n = 0; n < 3; ++n) mma(acc[mt][n], a0, a1, a2, a3, bq[n][0], bq[n][1]);
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int xx = x0 + 2 * (mbase + 16 * mt + g + 8 * (k >> 1)) + q;
        if (xx >= W) continue;
#pragma unroll
        for (int n = 0; n < 3; ++n) {
          const int ci = n * 8 + 2 * t + (k & 1);
          if (ci < C) store(dx + ((static_cast<size_t>(b) * C + ci) * H + yy) * W + xx, acc[mt][n][k]);
        }
      }
    }
  }
}

bool valid_shape(int B, int C, int H, int W, int CO, int blocks) {
  return B >= 1 && C >= 1 && C <= kMaxC && CO >= 1 && CO <= kMaxCO && H >= 2 && W >= 2 &&
         H % 2 == 0 && W % 2 == 0 && blocks >= 1;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
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

template <typename Tdy, typename Tx>
cudaError_t launch_dx(const void* dy, const void* w, void* dx, int B, int C, int H, int W, int CO, int blocks,
                      cudaStream_t s) {
  const size_t smem = (static_cast<size_t>(16) * 24 * kCoPad + static_cast<size_t>(2) * kDyCols * kCoPad) * sizeof(bf16);
  cudaError_t err = set_smem(conv_dx_kernel<Tdy, Tx>, smem);
  if (err != cudaSuccess) return err;
  conv_dx_kernel<Tdy, Tx><<<blocks, kThreads, smem, s>>>(
      static_cast<const Tdy*>(dy), static_cast<const float*>(w), static_cast<Tx*>(dx), B, C, H, W, CO);
  return cudaGetLastError();
}

// K5a and K5b take x (and dy) bf16, 16-byte aligned, with row pitches in
// elements (multiples of 8, and of 4 for an f32 y); blocks: persistent
// blocks, one per SM. K5c: *_bf16 flags 1 for bf16, 0 for f32. Shapes are
// those of x: (B, C, H, W).
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
                                   int dy_bf16, int dx_bf16, int blocks, void* stream) {
  if (!valid_shape(B, C, H, W, CO, blocks)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dy_bf16 && dx_bf16) return launch_dx<bf16, bf16>(dy, w, dx, B, C, H, W, CO, blocks, s);
  if (dy_bf16) return launch_dx<bf16, float>(dy, w, dx, B, C, H, W, CO, blocks, s);
  if (dx_bf16) return launch_dx<float, bf16>(dy, w, dx, B, C, H, W, CO, blocks, s);
  return launch_dx<float, float>(dy, w, dx, B, C, H, W, CO, blocks, s);
}
