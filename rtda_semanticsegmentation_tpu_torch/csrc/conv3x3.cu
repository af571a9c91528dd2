// 3x3 / stride-1 convolution with padding = dilation for Hopper (sm_90a), with a
// plain C interface: the 3x3 ConvBNs of the ResNet trunks (BasicBlock and
// Bottleneck, dilated in DeepLabV2's) and BiSeNet's FFM, BatchNorm folded in.
//
// K4, conv3x3: replaces rtda_semanticsegmentation_tpu/ops/pallas_conv3.py
// ::conv3x3s1p1 (_conv3_kernel), generalised to any H and W and to a dilation d
// (d = 1 is the TPU kernel's function):
//   acc[b,i,j,co] = sum_{dy,dx,c} bf16(x[b, i+(dy-1)d, j+(dx-1)d, c]) * bf16(w[dy,dx,c,co])
//   y = acc * scale[co] + shift[co]   (f32, when scale is given)
//   y = max(y, 0)                     (when relu)
// rounded once to bf16 or f32. Zero padding outside the image. The operands
// are rounded to bf16 (RNE) as the TPU kernel rounds them (pallas_conv3.py:48,
// 56); the products are exact and add in f32 on the tensor cores.
//
// Layout: x (B, H, W, Cx) NHWC bf16, contiguous, 16-byte aligned, Cx a
// multiple of 8 and >= C (channels past C are zero); w (3, 3, C, CO) HWIO
// bf16 with unit stride in CO and a row stride ldw (a multiple of 8, >= CO)
// between its (dy, dx, c) rows, 16-byte aligned; y (B, H, W, CO) NHWC. The
// wrapper (kernels/conv3x3.py) makes bf16 copies of operands that are not so.
//
// What bounds it on an H100: operations, at the model's shapes (2 * 9 * C
// multiply-adds per output for 2 C bytes of input; every conv of the serve
// paths is above the card's bf16 ratio of ~295 operations per byte), and in
// practice the L2-to-SM traffic of the tap windows, which an implicit GEMM
// reads 9 times. The design is an implicit GEMM (M = output pixels in NHWC
// order, N = CO, K = 9 taps x C) on the wgmma tensor cores, fed by TMA
// (hopper_conv.cuh):
// - a tile is 128 pixels x N = 128 or 24 (the FFM's CO = 19) channels, or
//   256 pixels x N = 64; each of two consumer warpgroups runs wgmma m64nNk16
//   (bf16 -> f32) on one or two 64-row blocks of it. The launch is
//   persistent: one block per SM walks the tiles (N fastest, so the blocks
//   at work share their A tiles in L2), and one producer thread keeps a ring
//   of up to 8 stages filled, running on into the next tile while the
//   consumers write this one (R18's 1/32 maps give 128 tiles, on 128 of
//   the 132 SMs);
// - a stage is one filter tap and 64 channels, the 9 taps of a chunk of
//   channels in a row, so that the chunk's shifted windows come from L2
//   (with the taps outermost, the 3328-channel FFM read its 436 MB input
//   from device memory once per tap). A is an im2col-mode TMA load of the
//   tile's shifted window (the tap as the load's offsets, scaled by d; the
//   hardware walks rows and images and zero-fills the border); B one or two
//   tiled loads of the HWIO rows (64 channels x 64 CO each, 128-byte
//   swizzle) or, at N = 24, three of 8 CO (unswizzled, 3 KB instead of a
//   64-column box's 8), read by wgmma MN-major (transposed);
// - the tensor cores round their running sum toward zero, so over K = 9 C
//   terms (up to 29,952 in BiSeNet-R101's FFM) one long chain drifts past
//   1e-5 of the largest output. Each chain of kChainStages stages (16 k16
//   steps) therefore starts from a zeroed accumulator (scale-d = 0) and is
//   added into an f32 total with round-to-nearest adds. Chains of 4, 8 and
//   16 k16 steps measured the same error at the serve paths' shapes (at
//   most 6.3e-6 of the largest output, the 3328-channel FFM), so the
//   longest is kept. Within a chain each stage's wgmmas stay in flight
//   while the next stage's are issued;
// - the epilogue (scale, shift, ReLU, one rounding) runs in registers and
//   writes channel pairs.
// The launch function encodes the two tensor maps on the host (the driver's
// encode functions through cudaGetDriverEntryPoint, no -lcuda), enqueues on
// the given stream and returns cudaGetLastError() or an encode error.

#include <cuda_bf16.h>

#include "hopper_conv.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hconv;

template <int N>
struct Wgmma;

template <>
struct Wgmma<24> {
  __device__ __forceinline__ static void mma(float (&d)[12], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11}, "
        "%12, %13, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n}\n"
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
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// The tile of an N width: 256 pixels at N = 64 (two m64 blocks per consumer
// warpgroup), which halves the weight traffic per output; 128 at N = 128
// (the chain and the total take 128 registers) and at N = 24. A stage is 64
// channels of one tap: the A tile, then B as one or two 64-column boxes of
// 64 rows (128-byte swizzle) or, at N = 24, three 8-column boxes (1 KB each,
// unswizzled 8 x 8 core matrices): 3 KB where a 64-column box would move 8.
__host__ __device__ constexpr int m_blocks(int bn) { return bn == 64 ? 2 : 1; }
__host__ __device__ constexpr int tile_m(int bn) { return 128 * m_blocks(bn); }
__host__ __device__ constexpr int a_bytes(int bn) { return tile_m(bn) * kRow; }
__host__ __device__ constexpr int b_bytes(int bn) { return bn == 24 ? 3 * 1024 : (bn == 128 ? 2 : 1) * 64 * kRow; }
__host__ __device__ constexpr int stage_bytes(int bn) { return a_bytes(bn) + b_bytes(bn); }

// Stages (of 4 k16 steps each) per accumulator chain.
constexpr int kChainStages = 4;

struct Params {
  int H, W, CO, M;  // M = B * H * W output pixels
  int iters;        // 9 taps x 64-channel chunks of C: the stages of a tile
  int d, relu;
  int ntn, tiles;   // N tiles; M tiles x N tiles
};

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
__device__ __forceinline__ void store1(bf16* p, float a) { *p = __float2bfloat16_rn(a); }
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }

template <int BN, typename Ty>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
               const float* __restrict__ scale, const float* __restrict__ shift, Ty* __restrict__ y, Params p) {
  constexpr int MB = m_blocks(BN), BM = tile_m(BN);
  extern __shared__ uint8_t smem[];
  using R = Ring<stage_bytes(BN)>;
  const R r(smem);
  r.init();
  Cursor<R::kStages> c;
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    // producer warpgroup: one thread issues every load, running up to a
    // ring ahead of the consumers, across tile boundaries
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      const int hw = p.H * p.W;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int n0 = (tile % p.ntn) * BN, m0 = (tile / p.ntn) * BM;
        const int b = m0 / hw, rem = m0 - b * hw;
        const int i = rem / p.W, j = rem - i * p.W;
        for (int it = 0; it < p.iters; ++it, c.next()) {
          mbar_wait(r.empty_bar(c.s), c.phase ^ 1);
          const uint32_t full = r.full_bar(c.s), a = r.stage(c.s);
          mbar_expect_tx(full, stage_bytes(BN));
          // chunk-major: the 9 taps of one 64-channel chunk in a row, so the
          // tile's shifted windows hit L2 even where the input outgrows it
          const int chunk = it / 9, tap = it - chunk * 9, c0 = chunk * 64;
          tma_load_im2col(a, &xmap, full, c0, j - p.d, i - p.d, b, static_cast<uint16_t>((tap % 3) * p.d),
                          static_cast<uint16_t>((tap / 3) * p.d));
          if (BN == 24) {
            for (int g = 0; g < 3; ++g) tma_load_3d(a + a_bytes(BN) + 1024 * g, &wmap, full, n0 + 8 * g, c0, tap);
          } else {
            tma_load_3d(a + a_bytes(BN), &wmap, full, n0, c0, tap);
            if (BN == 128) tma_load_3d(a + a_bytes(BN) + 64 * kRow, &wmap, full, n0 + 64, c0, tap);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int row = wg * 64 * MB + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);  // of the tile, block mb = 0
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int n0 = (tile % p.ntn) * BN, m0 = (tile / p.ntn) * BM;
      float acc[MB][BN / 2], total[MB][BN / 2];  // the current chain; the f32 total
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int q = 0; q < BN / 2; ++q) acc[mb][q] = total[mb][q] = 0.0f;
      int held = -1;  // the stage whose wgmmas may still be running
      for (int it = 0; it < p.iters; ++it, c.next()) {
        mbar_wait(r.full_bar(c.s), c.phase);
        const uint32_t a = r.stage(c.s) + wg * MB * 64 * kRow, bb = r.stage(c.s) + a_bytes(BN);
        const bool fresh = it % kChainStages == 0;
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // k16 steps: 32 bytes along A's rows, 16 rows down B's
          const uint64_t db = BN == 24 ? desc_sw(bb + 256 * k, 128, 1024, false)  // core matrices
                                       : desc_sw(bb + 2048 * k, 64 * kRow, 1024);
#pragma unroll
          for (int mb = 0; mb < MB; ++mb)
            Wgmma<BN>::mma(acc[mb], desc_sw(a + mb * 64 * kRow + 32 * k, 16, 1024), db, !(fresh && k == 0));
        }
        wgmma_commit();
        if ((it + 1) % kChainStages == 0 || it + 1 == p.iters) {
          // the chain ends: wait for it, free both stages, add it to the total
          wgmma_wait<0>();
#pragma unroll
          for (int mb = 0; mb < MB; ++mb)
#pragma unroll
            for (int q = 0; q < BN / 2; ++q) fence_reg(acc[mb][q]);
          if (held >= 0) mbar_arrive(r.empty_bar(held));
          mbar_arrive(r.empty_bar(c.s));
          held = -1;
#pragma unroll
          for (int mb = 0; mb < MB; ++mb)
#pragma unroll
            for (int q = 0; q < BN / 2; ++q) total[mb][q] = __fadd_rn(total[mb][q], acc[mb][q]);
        } else {
          // keep this stage's wgmmas in flight; the previous stage's are done
          wgmma_wait<1>();
          if (held >= 0) mbar_arrive(r.empty_bar(held));
          held = c.s;
        }
      }

      // epilogue: total[mb][4 jn + q] is pixel row + 64 mb + 8 (q >> 1),
      // channel 8 jn + 2 t + (q & 1)
      const bool pair_ok = (p.CO & 1) == 0;
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn) {
        const int co = n0 + jn * 8 + 2 * t;
        if (co >= p.CO) continue;
        const bool two = co + 1 < p.CO;
        float sc0 = 1.0f, sc1 = 1.0f, sh0 = 0.0f, sh1 = 0.0f;
        if (scale != nullptr) {
          sc0 = scale[co];
          sh0 = shift[co];
          if (two) {
            sc1 = scale[co + 1];
            sh1 = shift[co + 1];
          }
        }
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + row + 64 * mb + 8 * h;
            if (m >= p.M) continue;
            float v0 = total[mb][4 * jn + 2 * h], v1 = total[mb][4 * jn + 2 * h + 1];
            if (scale != nullptr) {
              v0 = __fadd_rn(__fmul_rn(v0, sc0), sh0);
              v1 = __fadd_rn(__fmul_rn(v1, sc1), sh1);
            }
            if (p.relu) {
              v0 = fmaxf(v0, 0.0f);
              v1 = fmaxf(v1, 0.0f);
            }
            Ty* out = y + static_cast<size_t>(m) * p.CO + co;
            if (two && pair_ok) {
              store2(out, v0, v1);
            } else {
              store1(out, v0);
              if (two) store1(out + 1, v1);
            }
          }
        }
      }
    }
  }
}

template <int BN, typename Ty>
int launch(const void* x, const void* w, const float* scale, const float* shift, void* y, int B, int H, int W,
           int Cx, int C, int CO, int ldw, int d, int relu, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  int err = encode_im2col(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, B, H, W, Cx, 3, 1, d, d, tile_m(BN));
  if (err) return err;
  // w as (CO, C, 9 taps), rows ldw apart; columns past CO and rows past C read zero
  err = encode_tiled_3d(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, CO, C, 9, 2LL * ldw, 2LL * C * ldw, 64, 1,
                        BN != 24);
  if (err) return err;
  const int M = B * H * W, kc = (C + 63) / 64;
  const int ntn = (CO + BN - 1) / BN;
  const long long tiles = static_cast<long long>((M + tile_m(BN) - 1) / tile_m(BN)) * ntn;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Params p{H, W, CO, M, 9 * kc, d, relu, ntn, static_cast<int>(tiles)};
  const int smem = smem_bytes(stage_bytes(BN));
  static const cudaError_t attr =
      cudaFuncSetAttribute(conv3x3_kernel<BN, Ty>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  conv3x3_kernel<BN, Ty><<<persistent_blocks(tiles), kThreads, smem, stream>>>(xmap, wmap, scale, shift,
                                                                              static_cast<Ty*>(y), p);
  return cudaGetLastError();
}

template <typename Ty>
int launch_bn(int bn, const void* x, const void* w, const float* scale, const float* shift, void* y, int B, int H,
              int W, int Cx, int C, int CO, int ldw, int d, int relu, cudaStream_t st) {
  if (bn == 128) return launch<128, Ty>(x, w, scale, shift, y, B, H, W, Cx, C, CO, ldw, d, relu, st);
  if (bn == 64) return launch<64, Ty>(x, w, scale, shift, y, B, H, W, Cx, C, CO, ldw, d, relu, st);
  if (bn == 24) return launch<24, Ty>(x, w, scale, shift, y, B, H, W, Cx, C, CO, ldw, d, relu, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x and w bf16 (see the layout above); y_bf16: 1 for a bf16 y, 0 for f32.
// scale and shift are both given (f32, CO each) or both null. bn is the N
// tile (128, 64 or 24).
extern "C" int conv3x3_launch(const void* x, const void* w, const void* scale, const void* shift, void* y, int B,
                              int H, int W, int Cx, int C, int CO, int ldw, int dilation, int relu, int y_bf16,
                              int bn, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || Cx < C || CO < 1 || ldw < CO) return cudaErrorInvalidValue;
  if (dilation < 1 || dilation > 128) return cudaErrorInvalidValue;  // the im2col box corners are 8-bit
  if (Cx % 8 != 0 || ldw % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return cudaErrorInvalidValue;  // TMA needs 16-byte aligned bases and row strides
  if ((scale == nullptr) != (shift == nullptr)) return cudaErrorInvalidValue;
  if (static_cast<long long>(B) * H * W >= 0x7fffffffLL) return cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (y_bf16) return launch_bn<bf16>(bn, x, w, sc, sh, y, B, H, W, Cx, C, CO, ldw, dilation, relu, st);
  return launch_bn<float>(bn, x, w, sc, sh, y, B, H, W, Cx, C, CO, ldw, dilation, relu, st);
}
