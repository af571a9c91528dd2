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
// products are exact and add in f32 on the tensor cores (mma.sync
// m16n8k16 bf16 -> f32), and each result is rounded once to its output type.
//
// Layout: NCHW as the port keeps its softmax maps, x (B, C, H, W) bf16 or f32,
// contiguous, read as it is; w (CO, C, 4, 4) f32 (OIHW); y and dy
// (B, CO, H/2, W/2). H and W are even. C <= kMaxC, CO <= kMaxCO.
//
// What bounds them on an H100: at the slice's shapes each kernel does about
// 140 FLOP per byte it must move, below the card's bf16 ratio of ~295, so the
// bound is bytes (0.154 ms for a 720x1280 batch of 8). The design keeps every
// im2col in shared memory and feeds the tensor cores from there:
// - persistent blocks, two per SM (~90 KB of shared memory each, so one
//   block stages its next tile while the other computes), walking the tiles
//   of the output; the bf16 weights are staged once per block;
// - K5a: a tile is one output row by 128 output columns. Its 4 input rows are
//   staged as bf16 rows; the GEMM is pixels x (ci, ky, kx) x co, one k16 step
//   per input channel (its 16 taps), and a warp's A fragment is read straight
//   from the rows: the pair (kx, kx+1) of pixel m is the word at column
//   2m + kx. Each warp owns 16 pixels x 64 channels;
// - K5b: the same tile; the GEMM is (ci, tap) x pixels x co, one m16 tile per
//   input channel. The A pairs are two neighbouring pixels of one tap, so the
//   rows are staged split by column parity, twice (shifted by one word), which
//   keeps every fragment read aligned. Each warp owns 5 input channels x 32
//   output channels and accumulates over every tile its block visits; the
//   blocks write partial (C*16, 64) sums to a workspace and a second kernel
//   adds them in block order: deterministic, no float atomics;
// - K5c: a gather, not the TPU's overlap-add. A tile is two input rows by 256
//   input columns; the pixels of one row and column parity see the same 2x2
//   taps, so each parity class is a GEMM pixels x (tap, co) x ci with dy
//   staged channel-innermost. Every output is written once: no atomics, no
//   scratch.
//
// Each launch function enqueues on the given stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxC = 20;
constexpr int kMaxCO = 64;
constexpr int kTileW = 128;               // output columns of a K5a / K5b tile
constexpr int kInCols = 2 * kTileW + 2;   // input columns a K5a / K5b tile reads
constexpr int kFwdRow = 288;              // bf16 per staged K5a input row (144 words = 16 mod 32 banks)
constexpr int kPlane = 136;               // bf16 per K5b parity plane (68 words = 4 mod 32 banks)
constexpr int kDyRow = kTileW + 8;        // bf16 per staged K5b dy row
constexpr int kDxTileW = 256;             // input columns of a K5c tile
constexpr int kDyCols = kDxTileW / 2 + 2; // dy columns a K5c tile reads
constexpr int kCoPad = kMaxCO + 8;        // bf16 per channel-innermost K5c entry (36 words)
constexpr int kLoadUnroll = 16;           // global loads in flight per thread while staging
constexpr size_t kMaxSmem = 232448;       // an H100 block's dynamic shared-memory limit

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

// Element (ci, ky, u) of the input rows 2i-1 .. 2i+2 and columns 2*j0-1+u
// (u < kInCols) of image b, bf16, zero outside the image; e = (ci*4+ky)*kInCols + u.
template <typename Tx>
__device__ __forceinline__ bf16 fetch_x(const Tx* __restrict__ x, int e, int b, int i, int j0, int C, int H, int W) {
  const int u = e % kInCols;
  const int rk = e / kInCols;
  const int r = 2 * i + (rk & 3) - 1;
  const int c = 2 * j0 - 1 + u;
  if (r < 0 || r >= H || c < 0 || c >= W) return __float2bfloat16_rn(0.0f);
  return to_bf16(x[((static_cast<size_t>(b) * C + (rk >> 2)) * H + r) * W + c]);
}

// K5a. Block tile: output row i, columns j0 .. j0+127, all output channels.
// Warp w owns the pixels j0 + 16w .. +15 (the A rows) and all 8 n8 tiles.
template <typename Tx, typename Ty>
__global__ void __launch_bounds__(kThreads, 2)
conv_fwd_kernel(const Tx* __restrict__ x, const float* __restrict__ w, Ty* __restrict__ y,
                int B, int C, int H, int W, int CO) {
  extern __shared__ float4 smem4[];
  const int wrow = C * 16 + 8;                  // bf16 per weight row (a bank-conflict-free stride)
  bf16* ws = reinterpret_cast<bf16*>(smem4);    // [kMaxCO][wrow]: w[co][ci*16 + ky*4 + kx]
  bf16* xs = ws + kMaxCO * wrow;                // [C][4][kFwdRow]: input rows, column u at u
  const int Ho = H / 2, Wo = W / 2;
  for (int e = threadIdx.x; e < kMaxCO * C * 16; e += kThreads) {
    const int co = e / (C * 16), k = e % (C * 16);
    ws[co * wrow + k] = __float2bfloat16_rn(co < CO ? w[static_cast<size_t>(co) * C * 16 + k] : 0.0f);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m = warp * 16 + g;    // A rows g and g+8: pixels m and m+8
  const int kx = 2 * (t & 1);     // k = 2t -> (ky, kx) = (t>>1, 2(t&1)); k = 2t+8 -> ky + 2
  const int tiles_w = (Wo + kTileW - 1) / kTileW;
  const int tiles = B * Ho * tiles_w;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int j0 = (tile % tiles_w) * kTileW;
    const int i = (tile / tiles_w) % Ho;
    const int b = tile / (tiles_w * Ho);
    __syncthreads();  // the weights are staged; the last tile's reads of xs are done
    stage(
        C * 4 * kInCols, [&](int e) { return fetch_x(x, e, b, i, j0, C, H, W); },
        [&](int e, bf16 v) { xs[(e / kInCols) * kFwdRow + e % kInCols] = v; });
    __syncthreads();
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[n][q] = 0.0f;
    for (int ci = 0; ci < C; ++ci) {
      const bf16* r0 = xs + (ci * 4 + (t >> 1)) * kFwdRow + 2 * m + kx;
      const bf16* r1 = r0 + 2 * kFwdRow;
      const uint32_t a0 = ld32(r0), a1 = ld32(r0 + 16), a2 = ld32(r1), a3 = ld32(r1 + 16);
      const bf16* wk = ws + g * wrow + ci * 16 + 2 * t;
#pragma unroll
      for (int n = 0; n < 8; ++n) mma(acc[n], a0, a1, a2, a3, ld32(wk + n * 8 * wrow), ld32(wk + n * 8 * wrow + 8));
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int co = n * 8 + 2 * t + (q & 1);
        const int j = j0 + m + 8 * (q >> 1);
        if (co < CO && j < Wo) store(y + ((static_cast<size_t>(b) * CO + co) * Ho + i) * Wo + j, acc[n][q]);
      }
    }
  }
}

// K5b. Warp w owns the output channels 32 (w&1) .. +31 (4 n8 tiles) and the
// input channels (w>>1) + 4s, s < 5 (one m16 tile each: its 16 taps), summed
// over every pixel of every tile its block visits.
template <typename Tx, typename Tdy>
__global__ void __launch_bounds__(kThreads, 2)
conv_dw_kernel(const Tx* __restrict__ x, const Tdy* __restrict__ dy, float* __restrict__ partial,
               int B, int C, int H, int W, int CO) {
  extern __shared__ float4 smem4[];
  // [C][4 ky][2 parity][2 shift][kPlane]: input column 2(p + shift) + parity at p
  bf16* xs = reinterpret_cast<bf16*>(smem4);
  bf16* ds = xs + C * 16 * kPlane;  // [kMaxCO][kDyRow]: dy of the tile's pixels
  const int Ho = H / 2, Wo = W / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int co0 = 32 * (warp & 1), ci0 = warp >> 1;
  // A row g is tap g: (ky, kx) = (g>>2, g&3) -> plane (ky, kx&1, kx>>1); row g+8 is ky + 2
  const int plane = ((g >> 2) * 2 + (g & 1)) * 2 + ((g >> 1) & 1);
  float acc[5][4][4];
#pragma unroll
  for (int s = 0; s < 5; ++s)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[s][n][q] = 0.0f;
  const int tiles_w = (Wo + kTileW - 1) / kTileW;
  const int tiles = B * Ho * tiles_w;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int j0 = (tile % tiles_w) * kTileW;
    const int i = (tile / tiles_w) % Ho;
    const int b = tile / (tiles_w * Ho);
    __syncthreads();
    stage(
        C * 4 * kInCols, [&](int e) { return fetch_x(x, e, b, i, j0, C, H, W); },
        [&](int e, bf16 v) {
          const int u = e % kInCols;
          bf16* row = xs + (e / kInCols) * 4 * kPlane + (u & 1) * 2 * kPlane;
          row[u >> 1] = v;                              // shift 0
          if (u >= 2) row[kPlane + (u >> 1) - 1] = v;   // shift 1
        });
    stage(
        kMaxCO * kTileW,
        [&](int e) {
          const int p = e % kTileW, co = e / kTileW;
          const int j = j0 + p;
          if (co >= CO || j >= Wo) return __float2bfloat16_rn(0.0f);
          return to_bf16(dy[((static_cast<size_t>(b) * CO + co) * Ho + i) * Wo + j]);
        },
        [&](int e, bf16 v) { ds[(e / kTileW) * kDyRow + e % kTileW] = v; });
    __syncthreads();
    for (int p0 = 0; p0 < kTileW; p0 += 16) {
      uint32_t bq[4][2];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const bf16* d = ds + (co0 + n * 8 + g) * kDyRow + p0 + 2 * t;
        bq[n][0] = ld32(d);
        bq[n][1] = ld32(d + 8);
      }
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        const int ci = ci0 + 4 * s;
        if (ci < C) {
          const bf16* r0 = xs + (ci * 16 + plane) * kPlane + p0 + 2 * t;
          const bf16* r1 = r0 + 8 * kPlane;  // ky + 2
          const uint32_t a0 = ld32(r0), a1 = ld32(r1), a2 = ld32(r0 + 8), a3 = ld32(r1 + 8);
#pragma unroll
          for (int n = 0; n < 4; ++n) mma(acc[s][n], a0, a1, a2, a3, bq[n][0], bq[n][1]);
        }
      }
    }
  }
  // partial[block][(ci*16 + tap)*kMaxCO + co]
  float* out = partial + static_cast<size_t>(blockIdx.x) * C * 16 * kMaxCO;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int ci = ci0 + 4 * s;
    if (ci < C) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int co = co0 + n * 8 + 2 * t;
        *reinterpret_cast<float2*>(out + (ci * 16 + g) * kMaxCO + co) = make_float2(acc[s][n][0], acc[s][n][1]);
        *reinterpret_cast<float2*>(out + (ci * 16 + g + 8) * kMaxCO + co) = make_float2(acc[s][n][2], acc[s][n][3]);
      }
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

template <typename Tx, typename Ty>
cudaError_t launch_fwd(const void* x, const void* w, void* y, int B, int C, int H, int W, int CO, int blocks,
                       cudaStream_t s) {
  const size_t smem = (static_cast<size_t>(kMaxCO) * (C * 16 + 8) + static_cast<size_t>(C) * 4 * kFwdRow) * sizeof(bf16);
  cudaError_t err = set_smem(conv_fwd_kernel<Tx, Ty>, smem);
  if (err != cudaSuccess) return err;
  conv_fwd_kernel<Tx, Ty><<<blocks, kThreads, smem, s>>>(
      static_cast<const Tx*>(x), static_cast<const float*>(w), static_cast<Ty*>(y), B, C, H, W, CO);
  return cudaGetLastError();
}

template <typename Tx, typename Tdy>
cudaError_t launch_dw(const void* x, const void* dy, void* partial, void* dw, int B, int C, int H, int W, int CO,
                      int blocks, cudaStream_t s) {
  const size_t smem = (static_cast<size_t>(C) * 16 * kPlane + static_cast<size_t>(kMaxCO) * kDyRow) * sizeof(bf16);
  cudaError_t err = set_smem(conv_dw_kernel<Tx, Tdy>, smem);
  if (err != cudaSuccess) return err;
  conv_dw_kernel<Tx, Tdy><<<blocks, kThreads, smem, s>>>(
      static_cast<const Tx*>(x), static_cast<const Tdy*>(dy), static_cast<float*>(partial), B, C, H, W, CO);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
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

}  // namespace

// *_bf16 flags: 1 for bf16, 0 for f32. Shapes are those of x: (B, C, H, W).

extern "C" int conv4x4s2_fwd_launch(const void* x, const void* w, void* y, int B, int C, int H, int W, int CO,
                                    int x_bf16, int y_bf16, int blocks, void* stream) {
  if (!valid_shape(B, C, H, W, CO, blocks)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && y_bf16) return launch_fwd<bf16, bf16>(x, w, y, B, C, H, W, CO, blocks, s);
  if (x_bf16) return launch_fwd<bf16, float>(x, w, y, B, C, H, W, CO, blocks, s);
  if (y_bf16) return launch_fwd<float, bf16>(x, w, y, B, C, H, W, CO, blocks, s);
  return launch_fwd<float, float>(x, w, y, B, C, H, W, CO, blocks, s);
}

extern "C" int conv4x4s2_dw_launch(const void* x, const void* dy, void* partial, void* dw, int B, int C, int H,
                                   int W, int CO, int x_bf16, int dy_bf16, int blocks, void* stream) {
  if (!valid_shape(B, C, H, W, CO, blocks)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && dy_bf16) return launch_dw<bf16, bf16>(x, dy, partial, dw, B, C, H, W, CO, blocks, s);
  if (x_bf16) return launch_dw<bf16, float>(x, dy, partial, dw, B, C, H, W, CO, blocks, s);
  if (dy_bf16) return launch_dw<float, bf16>(x, dy, partial, dw, B, C, H, W, CO, blocks, s);
  return launch_dw<float, float>(x, dy, partial, dw, B, C, H, W, CO, blocks, s);
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
