// s8 x s8 -> s32 NHWC convolution with the int8 serving epilogue fused.
//
// Replaces the TPU kernel rtda_semanticsegmentation_tpu/ops/pallas_conv_int8.py
// ::int8_conv3x3s1p1 (_conv3_s8_kernel + _epilogue), generalised from 3x3/s1/p1
// to any KHxKW kernel, stride and symmetric padding (BiSeNet-R18's quantized
// convs are 3x3/s1/p1, 3x3/s2/p1 and 1x1/s2/p0).
//
//   acc = sum_{kh,kw,c} xq_padded[b, oh*s+kh, ow*s+kw, c] * wq[kh, kw, c, co]
//   z   = acc * a[co] + b[co]                       (f32, each op rounded)
//   z   = max(z, 0)                                 (relu != 0)
//   out = z as f32 | z as bf16 (round to nearest even)
//       | clip(rint(z * inv[co]), 0, 254) - 127 as s8  (requantize)
//
// Padding pads the unsigned grid's zero code (-127), never 0: a zero pad would
// add 127 * w to every edge pixel. The pad is applied on the fly from bounds
// checks, so no padded copy of the input is ever written.
//
// Design (simple first): an implicit GEMM, M = B*HO*WO output pixels,
// N = CO output channels, K = KH*KW*C. One 256-thread block per 64x64 output
// tile; a plain loop over taps and 32-channel chunks stages a 64x32 s8 input
// tile and a 32x64 s8 weight tile in shared memory, packed four channels to a
// 32-bit word, and each thread accumulates a 4x4 sub-tile with __dp4a. The
// s32 accumulator stays in registers and only the epilogue's output is
// written to device memory.
//
// What bounds it on an H100: the dp4a issue rate and the shared-memory loads
// that feed it (8 loads per 16 dp4a), far below the int8 tensor-core rate.
// Left on the table: wgmma on int8 tensor cores, TMA / cp.async
// multi-stage pipelining of the tiles, a narrower N tile for the ragged
// CO=19 conv (a 64-wide tile wastes 70% of its work there), and chaining s8
// outputs between convs.
//
// The epilogue rounds like the JAX oracle: __int2float_rn, __fmul_rn and
// __fadd_rn (no fused multiply-add), rintf (half to even, as jnp.round),
// __float2bfloat16_rn. The kernel therefore matches its plain PyTorch
// version (kernels/int8_conv.py::int8_conv_plain) bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;          // output pixels per block
constexpr int kBN = 64;          // output channels per block
constexpr int kBK = 32;          // input channels per K step
constexpr int kWords = kBK / 4;  // packed 4-channel words per K step
constexpr int kThreads = 256;
constexpr uint32_t kZeroCode4 = 0x81818181u;  // four s8 codes of -127

enum OutKind { kF32 = 0, kBF16 = 1, kS8 = 2 };

// Four consecutive channels [c, c+4) of one input pixel, packed little-endian.
// Channels at or past C read as 0; their weights are 0, so they add nothing.
template <bool kVec>
__device__ __forceinline__ uint32_t load_x4(const int8_t* __restrict__ px,
                                            int c, int C) {
  if (kVec) {  // C % 4 == 0: c < C implies c + 3 < C, word-aligned
    return c < C ? __ldg(reinterpret_cast<const uint32_t*>(px + c)) : 0u;
  }
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (c + j < C) v |= static_cast<uint32_t>(static_cast<uint8_t>(px[c + j])) << (8 * j);
  }
  return v;
}

template <int kOut, bool kVec>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ inv, void* __restrict__ out,
                 int H, int W, int C, int HO, int WO, int CO, int KH, int KW,
                 int stride, int pad, int M, int relu) {
  __shared__ uint32_t xs[kWords][kBM];
  __shared__ uint32_t ws[kWords][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // Each thread stages two input words (pixel row, channel word) per K step.
  int x_row[2], x_word[2], x_b[2], x_ih0[2], x_iw0[2];
  bool x_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int idx = tid + r * kThreads;
    x_row[r] = idx / kWords;
    x_word[r] = idx % kWords;
    const int m = m0 + x_row[r];
    x_ok[r] = m < M;
    const int mm = x_ok[r] ? m : 0;
    const int hw = HO * WO;
    x_b[r] = mm / hw;
    const int rem = mm % hw;
    x_ih0[r] = (rem / WO) * stride - pad;
    x_iw0[r] = (rem % WO) * stride - pad;
  }
  // ... and two weight words (output channel, channel word).
  int w_col[2], w_word[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int idx = tid + r * kThreads;
    w_col[r] = idx % kBN;
    w_word[r] = idx / kBN;
  }

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int kh = 0; kh < KH; ++kh) {
    for (int kw = 0; kw < KW; ++kw) {
      const int8_t* __restrict__ wt = w + static_cast<size_t>(kh * KW + kw) * C * CO;
      for (int c0 = 0; c0 < C; c0 += kBK) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int ih = x_ih0[r] + kh;
          const int iw = x_iw0[r] + kw;
          uint32_t v = kZeroCode4;
          if (x_ok[r] && ih >= 0 && ih < H && iw >= 0 && iw < W) {
            const int8_t* px = x + ((static_cast<size_t>(x_b[r]) * H + ih) * W + iw) * C;
            v = load_x4<kVec>(px, c0 + 4 * x_word[r], C);
          }
          xs[x_word[r]][x_row[r]] = v;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int co = n0 + w_col[r];
          const int c = c0 + 4 * w_word[r];
          uint32_t v = 0;
          if (co < CO) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (c + j < C) {
                const int8_t q = __ldg(wt + static_cast<size_t>(c + j) * CO + co);
                v |= static_cast<uint32_t>(static_cast<uint8_t>(q)) << (8 * j);
              }
            }
          }
          ws[w_word[r]][w_col[r]] = v;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kWords; ++k) {
          int xv[4], wv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) xv[i] = static_cast<int>(xs[k][ty + 16 * i]);
#pragma unroll
          for (int j = 0; j < 4; ++j) wv[j] = static_cast<int>(ws[k][tx + 16 * j]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(xv[i], wv[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= CO) continue;
      float z = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), a[n]), b[n]);
      if (relu) z = fmaxf(z, 0.0f);
      const size_t o = static_cast<size_t>(m) * CO + n;
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
  }
}

template <int kOut>
void launch(bool vec, dim3 grid, cudaStream_t stream, const int8_t* x,
            const int8_t* w, const float* a, const float* b, const float* inv,
            void* out, int H, int W, int C, int HO, int WO, int CO, int KH,
            int KW, int stride, int pad, int M, int relu) {
  if (vec) {
    int8_conv_kernel<kOut, true><<<grid, kThreads, 0, stream>>>(
        x, w, a, b, inv, out, H, W, C, HO, WO, CO, KH, KW, stride, pad, M, relu);
  } else {
    int8_conv_kernel<kOut, false><<<grid, kThreads, 0, stream>>>(
        x, w, a, b, inv, out, H, W, C, HO, WO, CO, KH, KW, stride, pad, M, relu);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Shapes and layouts are checked by
// the Python wrapper; returns the cudaError_t of the launch (0 = success).
extern "C" int int8_conv_launch(const void* x, const void* w, const void* a,
                                const void* b, const void* inv, void* out,
                                int B, int H, int W, int C, int HO, int WO,
                                int CO, int KH, int KW, int stride, int pad,
                                int relu, int out_kind, void* stream) {
  const int M = B * HO * WO;
  const dim3 grid((M + kBM - 1) / kBM, (CO + kBN - 1) / kBN);
  const bool vec = (C % 4) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* ap = static_cast<const float*>(a);
  const auto* bp = static_cast<const float*>(b);
  const auto* ip = static_cast<const float*>(inv);
  switch (out_kind) {
    case kF32:
      launch<kF32>(vec, grid, s, xp, wp, ap, bp, ip, out, H, W, C, HO, WO, CO, KH, KW, stride, pad, M, relu);
      break;
    case kBF16:
      launch<kBF16>(vec, grid, s, xp, wp, ap, bp, ip, out, H, W, C, HO, WO, CO, KH, KW, stride, pad, M, relu);
      break;
    case kS8:
      launch<kS8>(vec, grid, s, xp, wp, ap, bp, ip, out, H, W, C, HO, WO, CO, KH, KW, stride, pad, M, relu);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
