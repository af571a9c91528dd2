// The backward of the bilinear resize (half-pixel centres, align_corners =
// False) as a gather, for Hopper (sm_90a), with a plain C interface.
//
// Replaces no TPU kernel: the JAX package's resize is jax.image.resize, left
// to XLA. It was added because PyTorch's backward of F.interpolate(mode=
// "bilinear") is a scatter (each output-gradient element adds its weighted
// value into up to four input pixels with atomics, rounded in bf16 at every
// add, 64-256 adds landing on each input pixel at an x8 resize), and it was
// the flagship train step's largest device operation.
//
// Per axis, output index o reads input i0 and i1 with weights l0 and l1,
// computed in f32 as PyTorch computes them for align_corners = False:
//   src = max(0, (o + 0.5) * (in / out) - 0.5),  i0 = floor(src),
//   i1 = i0 + (i0 < in - 1),  l1 = src - i0,  l0 = 1 - l1
// (each operation rounded on its own, as the plain version in
// kernels/upsample.py rounds it, so both pick the same taps). The input
// gradient is the adjoint, dx[i, j] = sum_oh sum_ow wh(oh, i) ww(ow, j)
// dy[oh, ow], taken per image and channel.
//
// What bounds it on an H100: bytes. The adjoint has to read dy once and write
// dx once (dy is ratio_h * ratio_w times dx: 64x at the flagship's logits),
// with about four multiply-adds per element of dy.
//
// The design reads dy once and writes dx once, with no atomics and no
// zero-fill:
// - the outputs that touch input index i form a contiguous range (i0 is
//   non-decreasing in o): those with i0 = i - 1 (weight l1) and those with
//   i0 = i (weight l0, or l0 + l1 at the last index). So each block owns a
//   band of BH input rows, a tile of TW input columns and TC channels of one
//   image, and streams the output rows of its band once, in order;
// - each output row's tile (the output columns that touch the block's
//   columns, times its channels) comes into shared memory by 16-byte
//   cp.async copies, kStages rows in flight;
// - each thread owns E elements (column, channel) of the tile: it reduces the
//   row along W into f32 from a per-block table of the W weights (tap-major,
//   so neighbouring columns read neighbouring words), then adds that partial
//   into two f32 accumulators in registers, the input rows i0 and i0 + 1 of
//   the output row, with the row's H weights. When i0 moves on, the lower
//   accumulator is complete: it is rounded once to the gradient's dtype and
//   written (if its row lies in the band; the band's edges are recomputed by
//   the neighbouring band, whose halo rows this block reads too);
// - layouts: dy is (N, C, Ho, Wo) with any strides where either the channel
//   stride is 1 (channels_last memory, or a channel slice of it such as the
//   gradient of one part of a torch.cat) or the W stride is 1 (a contiguous
//   NCHW tensor). kTiled copies runs of TC channels per output column (all
//   16-byte aligned), kMerged one run over the row's (Wo, C) span when C
//   leaves runs unaligned, kRows one run over the row's outputs per channel.
//   dx is written in the layout its strides give; channels_last keeps the
//   threads' writes contiguous.
//
// The tiles, the band height and the threads are chosen by launch_plan in
// kernels/upsample.py from the shape, the channel count and the ratio per
// axis; it also gives the largest span of output columns a tile reads and
// the most taps an input column has, computed with the same f32 arithmetic.
//
// The launch function enqueues on the given stream and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kStages = 4;
constexpr int kMaxThreads = 256;
constexpr size_t kMaxSmem = 232448;  // bytes of dynamic shared memory an H100 block may use

enum Layout { kTiled = 0, kMerged = 1, kRows = 2 };

struct Args {
  const void* dy;
  void* dx;
  long long gn, gc, gh, gw;  // dy's strides, elements
  long long on, oc, oh, ow;  // dx's strides, elements
  long long limit;           // dy's extent from its base, elements (its largest offset + 1)
  int C, Hi, Wi, Ho, Wo;
  int layout, tc, tw, bh, ntw;
  int taps;         // the most output columns that touch one input column
  int pitch;        // kRows: elements between the channels' runs in shared memory
  int stage_elems;  // elements of one row's stage in shared memory (a multiple of 8)
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// The source coordinate of output index o, max(0, (o + 0.5) * scale - 0.5),
// each operation rounded on its own (no fused multiply-add).
__device__ __forceinline__ float source(int o, float scale) {
  return fmaxf(__fsub_rn(__fmul_rn(scale, __fadd_rn(static_cast<float>(o), 0.5f)), 0.5f), 0.0f);
}

// Output index o's lower input index i0 and its two weights: a onto i0 and b
// onto i0 + 1 (b = 0 and a = l0 + l1 at the last input index, where i1 = i0).
__device__ __forceinline__ int source_tap(int o, float scale, int n_in, float* a, float* b) {
  const float src = source(o, scale);
  const int i0 = static_cast<int>(src);
  const float l1 = __fsub_rn(src, static_cast<float>(i0));
  const float l0 = __fsub_rn(1.0f, l1);
  const bool last = i0 >= n_in - 1;
  *a = last ? __fadd_rn(l0, l1) : l0;
  *b = last ? 0.0f : l1;
  return i0;
}

// The first output index whose i0 is at least k (n_out if none).
__device__ __forceinline__ int first_at_least(int k, float scale, int n_out) {
  int lo = 0, hi = n_out;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<int>(source(mid, scale)) >= k) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// 16 bytes from global to shared memory, the bytes past dy's extent zero-filled.
__device__ __forceinline__ void copy16(void* dst, const char* src, const char* base, const char* end) {
  const long long left = end - src;
  const int bytes = left >= 16 ? 16 : (left > 0 ? static_cast<int>(left) : 0);
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(bytes ? src : base), "r"(bytes));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Brings output row oh's tile (the block's output columns [ow0, ow0 + span)
// and channels [c0, c0 + tc)) into one stage.
template <typename T>
__device__ __forceinline__ void load_row(const Args& a, T* stage, long long row, int ow0, int span, int c0,
                                         int tc) {
  constexpr int V = 16 / sizeof(T);
  const T* dy = static_cast<const T*>(a.dy);
  const char* base = reinterpret_cast<const char*>(dy);
  const char* end = reinterpret_cast<const char*>(dy + a.limit);
  if (a.layout == kTiled) {  // span runs of tc channels, each 16-byte aligned
    const int per = tc / V;
    for (int i = threadIdx.x; i < span * per; i += blockDim.x) {
      const int r = i / per, x = i - r * per;
      const T* src = dy + row + (ow0 + r) * a.gw + c0 + x * V;
      copy16(stage + r * a.tc + x * V, reinterpret_cast<const char*>(src), base, end);
    }
  } else if (a.layout == kMerged) {  // one run over the (span, C) elements
    const char* first = reinterpret_cast<const char*>(dy + row + ow0 * a.gw);
    const char* lo = reinterpret_cast<const char*>(reinterpret_cast<uintptr_t>(first) & ~uintptr_t(15));
    const int chunks = static_cast<int>((first + static_cast<long long>(span) * a.C * sizeof(T) - lo + 15) / 16);
    for (int i = threadIdx.x; i < chunks; i += blockDim.x) copy16(stage + i * V, lo + 16 * i, base, end);
  } else {  // kRows: one run of span outputs per channel
    const int per = a.pitch / V;
    for (int i = threadIdx.x; i < tc * per; i += blockDim.x) {
      const int r = i / per, x = i - r * per;
      const char* first = reinterpret_cast<const char*>(dy + row + (c0 + r) * a.gc + ow0);
      const char* lo = reinterpret_cast<const char*>(reinterpret_cast<uintptr_t>(first) & ~uintptr_t(15));
      if (lo + 16 * x < first + span * sizeof(T)) copy16(stage + r * a.pitch + x * V, lo + 16 * x, base, end);
    }
  }
}

// Where element (column-in-tile, channel-in-tile) of a row's tile starts in
// its stage (the taps of one column follow at `step` elements apart).
template <typename T>
__device__ __forceinline__ int stage_base(const Args& a, long long row, int ow0, int c0, int cl) {
  const T* dy = static_cast<const T*>(a.dy);
  if (a.layout == kTiled) return cl;
  if (a.layout == kMerged) {
    return static_cast<int>((reinterpret_cast<uintptr_t>(dy + row + ow0 * a.gw) & 15) / sizeof(T)) + cl;
  }
  const uintptr_t first = reinterpret_cast<uintptr_t>(dy + row + (c0 + cl) * a.gc + ow0);
  return cl * a.pitch + static_cast<int>((first & 15) / sizeof(T));
}

template <typename T, int E>
__global__ void __launch_bounds__(kMaxThreads) upsample_bilinear2d_backward_gather(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* stages = reinterpret_cast<T*>(smem);
  float* wtab = reinterpret_cast<float*>(smem + static_cast<size_t>(kStages) * a.stage_elems * sizeof(T));
  int* first = reinterpret_cast<int*>(wtab + a.taps * a.tw);  // per column of the tile, its first tap
  int* count = first + a.tw;                                  // and its number of taps

  const int iw0 = (blockIdx.x % a.ntw) * a.tw, tw = min(a.tw, a.Wi - iw0);
  const int c0 = (blockIdx.x / a.ntw) * a.tc, tc = min(a.tc, a.C - c0);
  const int ih0 = blockIdx.y * a.bh, ih1 = min(ih0 + a.bh, a.Hi);
  const long long image = static_cast<long long>(blockIdx.z) * a.gn;
  const float sw = __fdiv_rn(static_cast<float>(a.Wi), static_cast<float>(a.Wo));
  const float sh = __fdiv_rn(static_cast<float>(a.Hi), static_cast<float>(a.Ho));
  const int step = a.layout == kTiled ? a.tc : (a.layout == kMerged ? a.C : 1);

  // the W taps of the tile's columns: outputs [ow0, ow0 + span) in all
  const int ow0 = first_at_least(iw0 - 1, sw, a.Wo);
  const int span = first_at_least(iw0 + tw, sw, a.Wo) - ow0;
  for (int j = threadIdx.x; j < tw; j += blockDim.x) {
    const int f = first_at_least(iw0 + j - 1, sw, a.Wo);
    first[j] = f - ow0;
    count[j] = first_at_least(iw0 + j + 1, sw, a.Wo) - f;
  }
  // the band's output rows: those whose i0 lies in [ih0 - 1, ih1)
  const int oh0 = first_at_least(ih0 - 1, sh, a.Ho), rows = first_at_least(ih1, sh, a.Ho) - oh0;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < rows) load_row<T>(a, stages + s * a.stage_elems, image + (oh0 + s) * a.gh, ow0, span, c0, tc);
    commit();
  }
  __syncthreads();
  for (int q = threadIdx.x; q < a.taps * tw; q += blockDim.x) {
    const int k = q / tw, j = q - k * tw;
    float w = 0.0f;
    if (k < count[j]) {
      float wa, wb;
      const int i0 = source_tap(ow0 + first[j] + k, sw, a.Wi, &wa, &wb);
      w = i0 == iw0 + j ? wa : wb;
    }
    wtab[k * a.tw + j] = w;
  }

  int col[E], chan[E], tap0[E], taps[E];
  bool mine[E];
  float lower[E], upper[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int idx = threadIdx.x + e * blockDim.x;
    mine[e] = idx < tw * tc;
    col[e] = mine[e] ? idx / tc : 0;
    chan[e] = mine[e] ? idx - col[e] * tc : 0;
    tap0[e] = first[col[e]];
    taps[e] = mine[e] ? count[col[e]] : 0;
    lower[e] = upper[e] = 0.0f;
  }

  T* dx = static_cast<T*>(a.dx);
  const long long out_image = static_cast<long long>(blockIdx.z) * a.on;
  int r = ih0 - 1;  // the input row of `lower`; `upper` holds row r + 1
  auto advance = [&]() {
    if (r >= ih0 && r < ih1) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (mine[e]) {
          store(dx + out_image + (c0 + chan[e]) * a.oc + r * a.oh + (iw0 + col[e]) * a.ow, lower[e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      lower[e] = upper[e];
      upper[e] = 0.0f;
    }
    ++r;
  };

  for (int q = 0; q < rows; ++q) {
    wait_group<kStages - 2>();
    __syncthreads();  // row q has landed, and every thread is done with the stage the next copy refills
    if (q + kStages - 1 < rows) {
      load_row<T>(a, stages + ((q + kStages - 1) % kStages) * a.stage_elems,
                  image + (oh0 + q + kStages - 1) * a.gh, ow0, span, c0, tc);
    }
    commit();
    float ha, hb;
    const int i0 = source_tap(oh0 + q, sh, a.Hi, &ha, &hb);
    while (r < i0) advance();
    const T* stage = stages + (q % kStages) * a.stage_elems;
    const long long row = image + (oh0 + q) * a.gh;
    int at[E];
    float part[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      at[e] = stage_base<T>(a, row, ow0, c0, chan[e]) + tap0[e] * step;
      part[e] = 0.0f;
    }
    for (int k = 0; k < a.taps; ++k) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (k < taps[e]) part[e] = fmaf(wtab[k * a.tw + col[e]], to_f32(stage[at[e] + k * step]), part[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      lower[e] = fmaf(ha, part[e], lower[e]);
      upper[e] = fmaf(hb, part[e], upper[e]);
    }
  }
  while (r < ih1) advance();
}

template <typename T, int E>
int launch(const Args& a, int bands, int n, int threads, size_t smem, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(upsample_bilinear2d_backward_gather<T, E>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.ntw * ((a.C + a.tc - 1) / a.tc), bands, n);
  upsample_bilinear2d_backward_gather<T, E><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int launch_e(const Args& a, int e, int bands, int n, int threads, size_t smem, cudaStream_t stream) {
  switch (e) {
    case 1: return launch<T, 1>(a, bands, n, threads, smem, stream);
    case 2: return launch<T, 2>(a, bands, n, threads, smem, stream);
    case 4: return launch<T, 4>(a, bands, n, threads, smem, stream);
    case 8: return launch<T, 8>(a, bands, n, threads, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int E>
int occupancy(int threads, size_t smem) {
  if (cudaFuncSetAttribute(upsample_bilinear2d_backward_gather<T, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess) {
    return 0;
  }
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, upsample_bilinear2d_backward_gather<T, E>, threads,
                                                    smem) != cudaSuccess) {
    return 0;
  }
  return blocks;
}

template <typename T>
int occupancy_e(int e, int threads, size_t smem) {
  switch (e) {
    case 1: return occupancy<T, 1>(threads, smem);
    case 2: return occupancy<T, 2>(threads, smem);
    case 4: return occupancy<T, 4>(threads, smem);
    case 8: return occupancy<T, 8>(threads, smem);
    default: return 0;
  }
}

}  // namespace

// Blocks of the kernel (f32 or bf16, e elements a thread) one SM holds at once
// with `threads` threads and `smem` bytes of shared memory; 0 on an error.
extern "C" int upsample_bwd_occupancy(int f32, int e, int threads, int smem) {
  if (smem < 0 || static_cast<size_t>(smem) > kMaxSmem) return 0;
  return f32 ? occupancy_e<float>(e, threads, smem) : occupancy_e<__nv_bfloat16>(e, threads, smem);
}

// dy (N, C, Ho, Wo) with strides g*, dx (N, C, Hi, Wi) with strides o*, both
// in elements; f32 = 1 for float, 0 for bf16. layout, tc, tw, bh, taps, pitch
// and stage_elems as kernels/upsample.py::launch_plan gives them; e elements a
// thread (1, 2, 4 or 8) of `threads` (at most 256).
extern "C" int upsample_bwd_launch(const void* dy, void* dx, int f32, int N, int C, int Hi, int Wi, int Ho, int Wo,
                                   long long gn, long long gc, long long gh, long long gw, long long on,
                                   long long oc, long long oh, long long ow, long long limit, int layout, int tc,
                                   int tw, int bh, int taps, int pitch, int stage_elems, int e, int threads,
                                   void* stream) {
  if (N < 1 || N > 65535 || C < 1 || Hi < 1 || Wi < 1 || Hi > Ho || Wi > Wo || tc < 1 || tw < 1 || bh < 1 ||
      taps < 1 || stage_elems % 8 || threads < 32 || threads > kMaxThreads || layout < kTiled ||
      layout > kRows || static_cast<long long>(e) * threads < static_cast<long long>(tw) * tc) {
    return cudaErrorInvalidValue;
  }
  const int bands = (Hi + bh - 1) / bh;
  if (bands > 65535) return cudaErrorInvalidValue;
  const size_t elem = f32 ? sizeof(float) : sizeof(__nv_bfloat16);
  const size_t smem = kStages * static_cast<size_t>(stage_elems) * elem +
                      (static_cast<size_t>(taps) * tw + 2 * static_cast<size_t>(tw)) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const Args a{dy, dx, gn, gc, gh, gw, on, oc, oh, ow, limit, C, Hi, Wi, Ho, Wo,
               layout, tc, tw, bh, (Wi + tw - 1) / tw, taps, pitch, stage_elems};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? launch_e<float>(a, e, bands, N, threads, smem, s)
             : launch_e<__nv_bfloat16>(a, e, bands, N, threads, smem, s);
}
