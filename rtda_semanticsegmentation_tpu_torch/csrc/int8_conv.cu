// s8 x s8 -> s32 NHWC convolution with the int8 serving epilogue fused, for
// Hopper (sm_90a), with a plain C interface.
//
// K3: replaces the TPU kernel rtda_semanticsegmentation_tpu/ops/pallas_conv_int8.py
// ::int8_conv3x3s1p1 (_conv3_s8_kernel + _epilogue), generalised from 3x3/s1/p1
// to any square kernel, stride, dilation d and symmetric padding (the quantized
// convs of BiSeNet are 3x3/s1/p1, 3x3/s2/p1 and 1x1 at stride 1 or 2;
// DeepLabV2's dilated layer3 and layer4 add 3x3/s1 at d = p = 2 and 4).
//
//   acc = sum_{kh,kw,c} xq_padded[b, oh*s+kh*d, ow*s+kw*d, c] * wq[kh, kw, c, co]
//   z   = acc * a[co] + b[co]                       (f32, each op rounded)
//   z   = max(z, 0)                                 (relu != 0)
//   out = z as f32 | z as bf16 (round to nearest even)
//       | clip(rint(z * inv[co]), 0, 254) - 127 as s8  (requantize)
//
// Padding pads the unsigned grid's zero code (-127), never 0: a zero pad would
// add 127 * w to every edge pixel. The TMA loads below fill the border with 0,
// so the epilogue restores the -127 exactly, in integers: for each output
// pixel, acc += -127 * sum of S[tap, co] over the taps whose input pixel lies
// outside the image, S[tap, co] = sum_c wq[tap, c, co] being the weights'
// column sums (precomputed with the K-major copy, kernels/int8_conv.py::
// kmajor_weights; the rule is int8_conv.py::zero_code_border_correction). No
// padded copy of the input is written.
//
// Layout: xq (B, H, W, C) NHWC s8, contiguous, 16-byte aligned, C a multiple
// of 16 (the wrapper appends code-0 channels, facing zero weights); wk
// (CO, KH*KW, C) s8, the weights K-major (s8 wgmma reads no other layout);
// S (KH*KW, CO) s32; out (B, HO, WO, CO) NHWC.
//
// What bounds it on an H100: int8 tensor-core operations at the serve path's
// shapes (2 * KH*KW * C operations per output for C input bytes), and in
// practice the L2-to-SM traffic of the tap windows and, for the smaller
// convs, the fixed cost of a launch and of the first stages. The design is
// an implicit GEMM (M = output pixels, N = CO, K = taps x C) on wgmma
// m64nNk32 s8 -> s32, fed by TMA (hopper_conv.cuh), the layout of
// conv3x3.cu:
// - a tile is 128 pixels x N = 128 channels, or 256 pixels x N = 24 (the
//   FFM's CO = 19 on a narrow tile); one persistent block per SM walks
//   the tiles, with two consumer warpgroups, one producer thread and a ring
//   of up to 8 stages that runs on into the next tile while the consumers
//   write this one (the 1/32 maps give 128 tiles, on 128 of the 132 SMs);
// - a stage is one tap and 128 channels, the taps of a chunk in a row: A an
//   im2col-mode TMA load (stride s as the map's traversal stride, the tap
//   times d as the load's offsets), B a tiled load of N rows of the K-major weights;
//   both 128-byte swizzled;
// - the s32 accumulator is exact, so one chain runs over all of K; each
//   stage's wgmmas stay in flight while the next stage's are issued.
//
// The epilogue rounds like the JAX oracle: __int2float_rn, __fmul_rn and
// __fadd_rn (no fused multiply-add), rintf (half to even, as jnp.round),
// __float2bfloat16_rn. The kernel therefore matches its plain PyTorch
// version (kernels/int8_conv.py::int8_conv_plain) bit for bit. The launch
// function encodes the tensor maps on the host (no -lcuda) and returns
// cudaGetLastError() or an encode error.

#include <cuda_bf16.h>

#include "hopper_conv.cuh"

namespace {

using namespace hconv;

template <int N>
struct Wgmma;

template <>
struct Wgmma<24> {
  __device__ __forceinline__ static void mma(int (&d)[12], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11}, "
        "%12, %13, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// The tile of an N width: 128 pixels at N = 128, 256 (two m64 blocks per
// consumer warpgroup) at N = 24. A stage is 128 channels of one tap: the A
// tile, then the N rows of B.
__host__ __device__ constexpr int m_blocks(int bn) { return bn == 128 ? 1 : 2; }
__host__ __device__ constexpr int tile_m(int bn) { return 128 * m_blocks(bn); }
__host__ __device__ constexpr int a_bytes(int bn) { return tile_m(bn) * kRow; }
__host__ __device__ constexpr int stage_bytes(int bn) { return a_bytes(bn) + bn * kRow; }

enum OutKind { kF32 = 0, kBF16 = 1, kS8 = 2 };

struct Params {
  int H, W, HO, WO, CO, M;  // M = B * HO * WO output pixels
  int KH, KW, stride, pad, dil;
  int iters;                // KH * KW taps x 128-channel chunks of C: the stages of a tile
  int relu;
  int ntn, tiles;           // N tiles; M tiles x N tiles
};

template <int kOut>
__device__ __forceinline__ void store(void* out, size_t o, float z, const float* inv, int n) {
  if (kOut == kF32) {
    static_cast<float*>(out)[o] = z;
  } else if (kOut == kBF16) {
    static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(z);
  } else {
    float q = rintf(__fmul_rn(z, inv[n]));
    q = fminf(fmaxf(q, 0.0f), 254.0f) - 127.0f;
    static_cast<int8_t*>(out)[o] = static_cast<int8_t>(q);
  }
}

template <int BN, int kOut>
__global__ void __launch_bounds__(kThreads, 1)
int8_conv_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                const int* __restrict__ colsum, const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ inv, void* __restrict__ out, Params p) {
  constexpr int MB = m_blocks(BN), BM = tile_m(BN);
  extern __shared__ uint8_t smem[];
  using R = Ring<stage_bytes(BN)>;
  const R r(smem);
  r.init();
  Cursor<R::kStages> c;
  const int wg = threadIdx.x / 128;
  const int hwo = p.HO * p.WO;

  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int n0 = (tile % p.ntn) * BN, m0 = (tile / p.ntn) * BM;
        const int bi = m0 / hwo, rem = m0 - bi * hwo;
        const int oh = rem / p.WO, ow = rem - oh * p.WO;
        for (int it = 0; it < p.iters; ++it, c.next()) {
          mbar_wait(r.empty_bar(c.s), c.phase ^ 1);
          const uint32_t full = r.full_bar(c.s), st = r.stage(c.s);
          mbar_expect_tx(full, stage_bytes(BN));
          // chunk-major: the taps of one 128-channel chunk in a row (conv3x3.cu)
          const int taps = p.KH * p.KW, chunk = it / taps, tap = it - chunk * taps, c0 = chunk * kRow;
          const int kw = tap % p.KW, kh = tap / p.KW;
          tma_load_im2col(st, &xmap, full, c0, ow * p.stride - p.pad, oh * p.stride - p.pad, bi,
                          static_cast<uint16_t>(kw * p.dil), static_cast<uint16_t>(kh * p.dil));
          tma_load_3d(st + a_bytes(BN), &wmap, full, c0, tap, n0);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int row = wg * 64 * MB + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);  // of the tile, block mb = 0
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int n0 = (tile % p.ntn) * BN, m0 = (tile / p.ntn) * BM;
      int acc[MB][BN / 2];
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int q = 0; q < BN / 2; ++q) acc[mb][q] = 0;
      int held = -1;  // the stage whose wgmmas may still be running
      for (int it = 0; it < p.iters; ++it, c.next()) {
        mbar_wait(r.full_bar(c.s), c.phase);
        const uint32_t ta = r.stage(c.s) + wg * MB * 64 * kRow, tb = r.stage(c.s) + a_bytes(BN);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k)  // k32 steps: 32 bytes along the rows of A and B
#pragma unroll
          for (int mb = 0; mb < MB; ++mb)
            Wgmma<BN>::mma(acc[mb], desc_sw(ta + mb * 64 * kRow + 32 * k, 16, 1024), desc_sw(tb + 32 * k, 16, 1024),
                           !(it == 0 && k == 0));
        wgmma_commit();
        if (it + 1 == p.iters) {
          wgmma_wait<0>();
#pragma unroll
          for (int mb = 0; mb < MB; ++mb)
#pragma unroll
            for (int q = 0; q < BN / 2; ++q) fence_reg(acc[mb][q]);
          if (held >= 0) mbar_arrive(r.empty_bar(held));
          mbar_arrive(r.empty_bar(c.s));
        } else {
          // keep this stage's wgmmas in flight; the previous stage's are done
          wgmma_wait<1>();
          if (held >= 0) mbar_arrive(r.empty_bar(held));
          held = c.s;
        }
      }

      // epilogue: acc[mb][4 jn + q] is pixel row + 64 mb + 8 (q >> 1),
      // channel 8 jn + 2 t + (q & 1)
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + row + 64 * mb + 8 * h;
          if (m >= p.M) continue;
          const int rem = m % hwo;
          const int ih0 = (rem / p.WO) * p.stride - p.pad, iw0 = (rem % p.WO) * p.stride - p.pad;
          // the taps whose input pixel lies outside the image: zero-filled by
          // TMA, -127 in the plain version
          uint32_t outside = 0;
          for (int kh = 0; kh < p.KH; ++kh) {
            const int ih = ih0 + kh * p.dil;
            const bool row_out = ih < 0 || ih >= p.H;
            for (int kw = 0; kw < p.KW; ++kw) {
              const int iw = iw0 + kw * p.dil;
              if (row_out || iw < 0 || iw >= p.W) outside |= 1u << (kh * p.KW + kw);
            }
          }
          for (int tap = 0; outside != 0; ++tap, outside >>= 1) {
            if (!(outside & 1)) continue;
            const int* st = colsum + static_cast<size_t>(tap) * p.CO;
#pragma unroll
            for (int jn = 0; jn < BN / 8; ++jn) {
              const int co = n0 + jn * 8 + 2 * t;
              if (co < p.CO) acc[mb][4 * jn + 2 * h] -= 127 * st[co];
              if (co + 1 < p.CO) acc[mb][4 * jn + 2 * h + 1] -= 127 * st[co + 1];
            }
          }
#pragma unroll
          for (int jn = 0; jn < BN / 8; ++jn) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = n0 + jn * 8 + 2 * t + e;
              if (n >= p.CO) continue;
              float z = __fadd_rn(__fmul_rn(__int2float_rn(acc[mb][4 * jn + 2 * h + e]), a[n]), b[n]);
              if (p.relu) z = fmaxf(z, 0.0f);
              store<kOut>(out, static_cast<size_t>(m) * p.CO + n, z, inv, n);
            }
          }
        }
      }
    }
  }
}

template <int BN, int kOut>
int launch(const void* x, const void* wk, const int* colsum, const float* a, const float* b, const float* inv,
           void* out, int B, int H, int W, int C, int HO, int WO, int CO, int KH, int KW, int stride, int pad,
           int dil, int relu, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  int err = encode_im2col(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x, B, H, W, C, KH, stride, pad, dil, tile_m(BN));
  if (err) return err;
  // wk as (C, taps, CO): boxes of 128 channels x 1 tap x BN output channels
  err = encode_tiled_3d(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wk, C, KH * KW, CO, C,
                        static_cast<long long>(C) * KH * KW, 1, BN);
  if (err) return err;
  const int M = B * HO * WO, kc = (C + kRow - 1) / kRow;
  const int ntn = (CO + BN - 1) / BN;
  const long long tiles = static_cast<long long>((M + tile_m(BN) - 1) / tile_m(BN)) * ntn;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Params p{H, W, HO, WO, CO, M, KH, KW, stride, pad, dil, KH * KW * kc, relu, ntn, static_cast<int>(tiles)};
  const int smem = smem_bytes(stage_bytes(BN));
  static const cudaError_t attr =
      cudaFuncSetAttribute(int8_conv_kernel<BN, kOut>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  int8_conv_kernel<BN, kOut><<<persistent_blocks(tiles), kThreads, smem, stream>>>(xmap, wmap, colsum, a, b, inv,
                                                                                   out, p);
  return cudaGetLastError();
}

template <int kOut>
int launch_bn(int bn, const void* x, const void* wk, const int* colsum, const float* a, const float* b,
              const float* inv, void* out, int B, int H, int W, int C, int HO, int WO, int CO, int KH, int KW,
              int stride, int pad, int dil, int relu, cudaStream_t st) {
  if (bn == 128)
    return launch<128, kOut>(x, wk, colsum, a, b, inv, out, B, H, W, C, HO, WO, CO, KH, KW, stride, pad, dil, relu,
                             st);
  if (bn == 24)
    return launch<24, kOut>(x, wk, colsum, a, b, inv, out, B, H, W, C, HO, WO, CO, KH, KW, stride, pad, dil, relu,
                            st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, bound with ctypes. Shapes and layouts are checked by
// the Python wrapper; returns the cudaError_t of the launch (0 = success) or
// an encode error (hopper_conv.cuh). bn is the N tile (128 or 24).
extern "C" int int8_conv_launch(const void* x, const void* wk, const void* colsum, const void* a, const void* b,
                                const void* inv, void* out, int B, int H, int W, int C, int HO, int WO, int CO,
                                int KH, int KW, int stride, int pad, int dil, int relu, int out_kind, int bn,
                                void* stream) {
  if (B < 1 || C < 1 || CO < 1 || HO < 1 || WO < 1 || KH * KW > 32 || stride < 1 || stride > 8 || pad > 127 ||
      dil < 1 || dil > 128 || pad - (KH - 1) * dil < -128 || KH != KW)
    return cudaErrorInvalidValue;  // a 32-bit tap mask; the im2col map's traversal stride and 8-bit box corners
  if (C % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(wk) % 16 != 0)
    return cudaErrorInvalidValue;  // TMA needs 16-byte aligned bases and row strides
  if (static_cast<long long>(B) * HO * WO >= 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* cs = static_cast<const int*>(colsum);
  const auto* ap = static_cast<const float*>(a);
  const auto* bp = static_cast<const float*>(b);
  const auto* ip = static_cast<const float*>(inv);
  switch (out_kind) {
    case kF32:
      return launch_bn<kF32>(bn, x, wk, cs, ap, bp, ip, out, B, H, W, C, HO, WO, CO, KH, KW, stride, pad, dil, relu,
                             s);
    case kBF16:
      return launch_bn<kBF16>(bn, x, wk, cs, ap, bp, ip, out, B, H, W, C, HO, WO, CO, KH, KW, stride, pad, dil, relu,
                             s);
    case kS8:
      return launch_bn<kS8>(bn, x, wk, cs, ap, bp, ip, out, B, H, W, C, HO, WO, CO, KH, KW, stride, pad, dil, relu,
                             s);
    default:
      return cudaErrorInvalidValue;
  }
}
