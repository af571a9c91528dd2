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
// 56); the products are exact and add in f32 on the tensor cores (mma.sync
// m16n8k16 bf16 -> f32).
//
// Layout: x (B, H, W, C) NHWC, bf16 or f32, contiguous; w (3, 3, C, CO) HWIO,
// bf16 or f32, with unit stride in CO and a row stride ldw >= CO between its
// (dy, dx, c) rows (the port keeps the weights bf16 with CO padded to a
// multiple of 8); y (B, H, W, CO) NHWC, contiguous.
//
// What bounds it on an H100: operations, at the model's shapes. A 3x3 conv
// does 2 * 9 * C multiply-adds per output for 2 C bytes of input read (bf16),
// about 9 operations per input byte per output channel, so at CO >= 64 it is
// above the card's bf16 ratio of ~295 only once the input is read a few times
// at most; the layer1 convs (C = CO = 64 at 128x256) sit near the balance. The
// design is an implicit GEMM with no im2col in device memory:
// - M = output pixels (b, i, j) in NHWC order, N = CO, K = 9 taps x C. A block
//   computes 128 pixels x 64 channels; eight warps, 4 x 2, each 32 x 32 (2 x 4
//   m16n8 tiles);
// - a k-step is one tap and 32 input channels. Its A tile (128 pixels x 32
//   channels, the tap's shifted window, zero outside the image) and B tile (32
//   x 64 weights) are copied into shared memory with 16-byte cp.async (zero
//   fill for the border and the ragged K and N edges), three steps in flight;
//   shapes that do not allow 16-byte copies (f32 x, C or ldw not a multiple of
//   8) stage through registers instead;
// - fragments are read with ldmatrix (A row-major, B transposed from its HWIO
//   rows); row strides of 80 and 144 bytes put the 8 rows of each 8x8 matrix in
//   distinct banks;
// - the tensor cores round their running sum toward zero, so over K = 9 C
//   terms (up to 29,952 in BiSeNet-R101's FFM) the error of one long mma chain
//   grows with K, past 1e-5 of the largest output. Each chain therefore runs
//   over 4 k-steps (128 products) only, and is added into an f32 total with
//   round-to-nearest adds;
// - the f32 epilogue (scale, shift, ReLU, one rounding) runs in registers and
//   writes channel pairs.
// The launch function enqueues on the given stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kBM = 128;                // output pixels of a block tile
constexpr int kBN = 64;                 // output channels of a block tile
constexpr int kBK = 32;                 // input channels of a k-step (one tap)
constexpr int kStages = 3;              // k-steps in flight
constexpr int kChain = 4;               // k-steps summed on the tensor cores before an f32 add
constexpr int kARow = kBK + 8;          // bf16 per staged A row (80 B)
constexpr int kBRow = kBN + 8;          // bf16 per staged B row (144 B)
constexpr int kAStage = kBM * kARow;
constexpr int kBStage = kBK * kBRow;

__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }
__device__ __forceinline__ bf16 to_bf16(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
__device__ __forceinline__ void store1(bf16* p, float a) { *p = __float2bfloat16_rn(a); }
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Shape {
  int B, H, W, C, CO, ldw, d;
  int M;        // B * H * W output pixels
  int ksteps;   // 9 * ceil(C / kBK)
  int ntiles;   // ceil(CO / kBN)
};

// Block tile: pixels m0 .. m0+127, channels n0 .. n0+63, over all k-steps.
// Staging roles: for A, thread t copies channels 8 (t & 3) .. +7 of rows
// t >> 2 and (t >> 2) + 64; for B, channels 8 (t & 7) .. +7 of k-row t >> 3.
template <typename Tx, typename Ty>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_kernel(const Tx* __restrict__ x, const void* __restrict__ wv, const float* __restrict__ scale,
               const float* __restrict__ shift, Ty* __restrict__ y, Shape s, int w_bf16, int vec_a,
               int vec_b, int relu) {
  __shared__ __align__(16) bf16 As[kStages][kAStage];
  __shared__ __align__(16) bf16 Bs[kStages][kBStage];

  const int tid = threadIdx.x;
  const int n0 = (blockIdx.x % s.ntiles) * kBN;
  const int m0 = (blockIdx.x / s.ntiles) * kBM;
  const int kc = (s.C + kBK - 1) / kBK;

  // the two output pixels whose A rows this thread stages
  const int ra = tid >> 2, ca = (tid & 3) * 8;
  int pb[2], pi[2], pj[2];
  bool pv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + ra + 64 * r;
    pv[r] = m < s.M;
    const int mm = pv[r] ? m : 0;
    pb[r] = mm / (s.H * s.W);
    const int rem = mm - pb[r] * s.H * s.W;
    pi[r] = rem / s.W;
    pj[r] = rem - pi[r] * s.W;
  }
  const int kb = tid >> 3, cb = (tid & 7) * 8;

  auto load_step = [&](int step) {
    const int slot = step % kStages;
    const int tap = step / kc;
    const int c0 = (step - tap * kc) * kBK;
    const int oy = (tap / 3 - 1) * s.d, ox = (tap % 3 - 1) * s.d;
    // A: the tap's window of 32 channels for 128 pixels
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int ii = pi[r] + oy, jj = pj[r] + ox;
      const int c = c0 + ca;
      const bool in = pv[r] && ii >= 0 && ii < s.H && jj >= 0 && jj < s.W;
      bf16* dst = &As[slot][(ra + 64 * r) * kARow + ca];
      const size_t off = ((static_cast<size_t>(pb[r]) * s.H + ii) * s.W + jj) * s.C + c;
      if (vec_a) {
        const bool ok = in && c < s.C;
        cp_async16(dst, ok ? static_cast<const void*>(x + off) : static_cast<const void*>(x), ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (in && c + e < s.C) ? to_bf16(x[off + e]) : __float2bfloat16_rn(0.0f);
      }
    }
    // B: weights of input channels c0 .. c0+31 for output channels n0 .. n0+63
    {
      const int k = c0 + kb, co = n0 + cb;
      bf16* dst = &Bs[slot][kb * kBRow + cb];
      const size_t off = (static_cast<size_t>(tap) * s.C + k) * s.ldw + co;
      const bool kin = k < s.C;
      if (vec_b) {
        const bool ok = kin && co < s.CO;
        const bf16* w = static_cast<const bf16*>(wv);
        cp_async16(dst, ok ? static_cast<const void*>(w + off) : wv, ok ? 16 : 0);
      } else if (w_bf16) {
        const bf16* w = static_cast<const bf16*>(wv);
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = (kin && co + e < s.CO) ? w[off + e] : __float2bfloat16_rn(0.0f);
      } else {
        const float* w = static_cast<const float*>(wv);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = __float2bfloat16_rn((kin && co + e < s.CO) ? w[off + e] : 0.0f);
      }
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;
  float acc[2][4][4], sum[2][4][4];  // the current mma chain; the f32 total
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][b][q] = sum[a][b][q] = 0.0f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < s.ksteps) load_step(st);
    cp_async_commit();
  }
  // ldmatrix row of this lane: rows (or k-rows) lane & 15, column half lane >> 4
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;
  for (int step = 0; step < s.ksteps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step's tiles are in; every warp is done with step - 1's slot
    if (step + kStages - 1 < s.ksteps) load_step(step + kStages - 1);
    cp_async_commit();
    const bf16* a_s = As[step % kStages];
    const bf16* b_s = Bs[step % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[2][4], bfr[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) ldsm_x4(af[mt], a_s + (wm + mt * 16 + lrow) * kARow + kk + lcol);
#pragma unroll
      for (int nh = 0; nh < 2; ++nh) ldsm_x4_trans(bfr[nh], b_s + (kk + lrow) * kBRow + wn + nh * 16 + lcol);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma(acc[mt][nt], af[mt], bfr[nt >> 1][(nt & 1) * 2], bfr[nt >> 1][(nt & 1) * 2 + 1]);
    }
    if (step % kChain == kChain - 1 || step == s.ksteps - 1) {
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            sum[a][b][q] = __fadd_rn(sum[a][b][q], acc[a][b][q]);
            acc[a][b][q] = 0.0f;
          }
    }
  }
  cp_async_wait<0>();

  // epilogue: sum q of tile (mt, nt) is pixel g + 8 (q >> 1), channel 2t + (q & 1)
  const int g = lane >> 2, t = lane & 3;
  const bool pair_ok = (s.CO & 1) == 0;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int co = n0 + wn + nt * 8 + 2 * t;
    if (co >= s.CO) continue;
    const bool two = co + 1 < s.CO;
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
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mt * 16 + g + 8 * h;
        if (m >= s.M) continue;
        float v0 = sum[mt][nt][2 * h], v1 = sum[mt][nt][2 * h + 1];
        if (scale != nullptr) {
          v0 = __fadd_rn(__fmul_rn(v0, sc0), sh0);
          v1 = __fadd_rn(__fmul_rn(v1, sc1), sh1);
        }
        if (relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        Ty* out = y + static_cast<size_t>(m) * s.CO + co;
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

template <typename Tx, typename Ty>
cudaError_t launch(const void* x, const void* w, const float* scale, const float* shift, void* y, const Shape& s,
                   int w_bf16, int vec_a, int vec_b, int relu, cudaStream_t stream) {
  const long long blocks = static_cast<long long>((s.M + kBM - 1) / kBM) * s.ntiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  conv3x3_kernel<Tx, Ty><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const Tx*>(x), w, scale, shift, static_cast<Ty*>(y), s, w_bf16, vec_a, vec_b, relu);
  return cudaGetLastError();
}

}  // namespace

// x_bf16 / w_bf16 / y_bf16: 1 for bf16, 0 for f32. scale and shift are both
// given (f32, CO each) or both null.
extern "C" int conv3x3_launch(const void* x, const void* w, const void* scale, const void* shift, void* y, int B,
                              int H, int W, int C, int CO, int ldw, int dilation, int relu, int x_bf16, int w_bf16,
                              int y_bf16, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || CO < 1 || ldw < CO || dilation < 1) return cudaErrorInvalidValue;
  if ((scale == nullptr) != (shift == nullptr)) return cudaErrorInvalidValue;
  const long long m = static_cast<long long>(B) * H * W;
  if (m >= 0x7fffffffLL) return cudaErrorInvalidValue;
  Shape s{B, H, W, C, CO, ldw, dilation, static_cast<int>(m), 9 * ((C + kBK - 1) / kBK), (CO + kBN - 1) / kBN};
  const int vec_a = x_bf16 && C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_b = w_bf16 && ldw % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16 && y_bf16) return launch<bf16, bf16>(x, w, sc, sh, y, s, w_bf16, vec_a, vec_b, relu, st);
  if (x_bf16) return launch<bf16, float>(x, w, sc, sh, y, s, w_bf16, vec_a, vec_b, relu, st);
  if (y_bf16) return launch<float, bf16>(x, w, sc, sh, y, s, w_bf16, vec_a, vec_b, relu, st);
  return launch<float, float>(x, w, sc, sh, y, s, w_bf16, vec_a, vec_b, relu, st);
}
