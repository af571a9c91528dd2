// Binned Lovász-Softmax kernels for Hopper (sm_90a), with a plain C interface.
//
// K1, lovasz_hist: replaces rtda_semanticsegmentation_tpu/ops/pallas_lovasz.py
// ::lovasz_radix_hist (_hist_kernel). Per class c and valid pixel
// (label != ignore), with fg = (label == c), e = |fg - p| and bucket
// k = min(int(e * bins), bins - 1), it sums [1, fg, bf16(e)] into
// out (C, 3, bins) f32.
//
// K2, lovasz_bwd: replaces ...::lovasz_radix_bwd (_bwd_kernel). Per pixel and
// class, out = bf16(table[c, (fg ? 0 : 1) if interp, k]) * (1 - 2 fg), and 0
// for invalid pixels.
//
// Layout: probas (B, C, N) f32, the port's NCHW softmax with H*W flattened,
// so each class row of an image is contiguous and neighbouring threads read
// neighbouring pixels. labels (B, N) int32.
//
// What bounds them on an H100: bytes. Both read the probabilities once (K2
// also writes its gradient once) and do a few operations per element, far
// below the card's ratio of operations to bytes.
//
// K1 counts into a private (cg, bins) histogram per block in shared memory
// (58 KB at C = 19, bins = 256) instead of the TPU's one-hot bf16 matrix
// products, which were only a stand-in for a scatter:
// - integer sums: the count and the foreground count of a bin share one u32
//   (16 bits each: the wrapper gives no block more than 65535 pixels), and
//   the error sums are u64 fixed-point numbers, s * 2^40, held in
//   shared memory as two u32 words with an explicit carry (add_run: on sm_90
//   only the u32 shared atomic add is one instruction; f32 and u64 adds are
//   compare-and-swap loops, which stalled the earlier design's f32 error
//   sums wherever lanes collided on a hot bucket). The sums of the shared
//   and global histograms are then independent of the order of the
//   atomics; 2^24 - 1 valid pixels (the wrapper's per-launch limit) times
//   the largest error, 1.0 = 2^40, still fit in 64 bits;
// - exact sums, whatever the cut: each error term is bf16(e) rounded to a
//   multiple of 2^-(log2(bins) + 16) (quantize; only terms of bucket 0 move:
//   a term of bucket k >= 1 lies on that grid already), so a run's f32 sum
//   of fewer than 256 terms, all in one bucket, is exact and so is its
//   conversion to 2^-40 fixed point. The integer histogram is then the sum
//   of every term's own fixed-point value, the same bits however the pixels
//   are cut into blocks, launches or ranks. With out == nullptr a launch
//   leaves that integer histogram in the workspace (the wrapper adds several
//   launches' and finalizes once);
// - no warp votes: each thread keeps, per class, a run in registers (the
//   bucket it saw last for a background pixel, its count and the f32 sum of
//   its bf16 errors, fewer than 256 terms) and one run for its foreground
//   pixels (class and bucket), and adds a run to shared memory, its sum
//   rounded to 2^-41, only when its bucket changes. The hot buckets (bucket
//   0 of a confident or spread model's background, the one bucket of every
//   background pixel of a class at initialisation, p = 1/C) so cost a
//   register add per element instead of a contended shared atomic. The V
//   elements of a class are binned with selects; only the flush of a run
//   that ends branches (for the whole warp, wherever one lane flushes);
// - loads of 16 bytes: where N is a multiple of 4 and the operands are
//   16-byte aligned, a thread takes 4 neighbouring pixels (an int4 of labels
//   and a float4 per class row), with the next two rows' loads in flight
//   while it bins one (deeper register prefetch and cp.async slots measured
//   slower on an H100; 768-thread blocks 3-6% faster but spilling in the
//   larger groups' kernels); else one pixel at a time;
// - one launch: each block adds its nonzero entries into one (C, bins)
//   workspace of u64 [count | fg << 32] and u64 error sums with global
//   atomics (zeroed by a memset on the same stream), and the last block to
//   finish converts it to (C, 3, bins) f32, each sum rounded once. No
//   per-block partial histograms, no second pass;
// - where the whole histogram does not fit a block's shared memory (C = 19
//   at 1024 bins needs 233,472 B), a second grid dimension splits the
//   classes into groups of cg, and each block bins one group; at 256 bins
//   there is one group. Groups of up to 20 classes keep their runs in
//   registers three blocks to an SM; larger groups (up to kMaxClasses) two.
//
// K2 keeps the bf16-rounded table (C * 2 * bins f32, 39 KB at 256 bins) in
// shared memory; where it does not fit a block (311,296 B at 2048 bins), a
// second grid dimension splits the classes into groups as K1 does, and each
// block reads and writes only its group's classes. Each thread first loads
// all of its pixel's probabilities of the group into registers (one
// coalesced load per class row). Every operation is exact, so it matches its
// plain PyTorch version bit for bit. A group holds at most kMaxClasses
// classes, the probabilities a thread keeps in registers; more classes make
// more groups.
//
// Each launch function enqueues on the given stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxClasses = 32;
constexpr int kSmallGroup = 20;        // K1 classes whose runs fit registers at 3 blocks an SM
constexpr float kFixScale = 1099511627776.0f;  // 2^40: K1's fixed-point error sums
constexpr unsigned kRunBits = 18;      // K1's background run: bucket << kRunBits | count
constexpr int kPrefetch = 2;           // K1: class rows whose loads a thread keeps in flight
constexpr size_t kMaxSmem = 232448;  // an H100 block's dynamic shared-memory limit

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// e * bins is exact (bins is a power of two); truncation as astype(int32)
__device__ __forceinline__ int bucket(float e, int bins) {
  int k = __float2int_rz(__fmul_rn(e, static_cast<float>(bins)));
  return min(max(k, 0), bins - 1);
}

__device__ __forceinline__ float error(bool fg, float p) {
  return fabsf(__fsub_rn(fg ? 1.0f : 0.0f, p));
}

__device__ __forceinline__ unsigned long long fixed(float ev) { return __float2ull_rn(ev * kFixScale); }

// bf16(e) on the grid of multiples of 1 / scale, scale = bins * 2^16: exact
// for e >= 1 / bins (bucket >= 1), rounded to nearest even below it
__device__ __forceinline__ float quantize(float ev, float scale, float inv_scale) {
  return __fmul_rn(rintf(__fmul_rn(ev, scale)), inv_scale);
}

// Adds a run (cf: count | fg << 16, v: its u64 error sum) into the bin at
// shared address `at` of a block's histogram, whose low and high words of
// the error sums lie `words` bytes and twice that after the counts. Shared
// memory has no native 64-bit or f32 atomic add on sm_90 (both compile to a
// compare-and-swap loop, ATOMS.CAST.SPIN), so the u64 sum is two u32 words:
// the low word's add returns the old value, and a carry out of it goes into
// the high word with the run's high bits.
__device__ __forceinline__ void add_run(uint32_t at, uint32_t words, unsigned cf, unsigned long long v) {
  const unsigned lo = static_cast<unsigned>(v);
  unsigned old;
  asm volatile("red.shared.add.u32 [%0], %1;\n" ::"r"(at), "r"(cf) : "memory");
  asm volatile("atom.shared.add.u32 %0, [%1], %2;\n" : "=r"(old) : "r"(at + words), "r"(lo) : "memory");
  const unsigned hi = static_cast<unsigned>(v >> 32) + (old + lo < old ? 1u : 0u);
  if (hi) asm volatile("red.shared.add.u32 [%0], %1;\n" ::"r"(at + 2 * words), "r"(hi) : "memory");
}

template <int V>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  __device__ static void labels(const int* p, int (&l)[4]) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    l[0] = v.x, l[1] = v.y, l[2] = v.z, l[3] = v.w;
  }
  __device__ static float4 probas(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ static float at(const float4& v, int j) { return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w; }
};
template <>
struct Vec<1> {
  using T = float;
  __device__ static void labels(const int* p, int (&l)[1]) { l[0] = __ldg(p); }
  __device__ static float probas(const float* p) { return __ldg(p); }
  __device__ static float at(float v, int) { return v; }
};

// Block (x, y) bins the classes c0 = y * cg .. c0 + cn - 1 of its share of
// the pixels, V neighbouring pixels a thread at a time, into its shared
// histogram, adds that into the workspace ws ([C * bins] u64 count | fg << 32,
// [C * bins] u64 error sums, one u32 counter of finished blocks), and the
// last block writes out (C, 3, bins) f32, unless out is null.
template <int kCg, int V>
__global__ void __launch_bounds__(kThreads, kCg <= kSmallGroup ? 3 : 2)
lovasz_hist_kernel(const float* __restrict__ probas, const int* __restrict__ labels,
                   unsigned long long* __restrict__ ws, float* __restrict__ out,
                   int B, int C, int N, int bins, int ignore, int cg) {
  extern __shared__ unsigned s_cf[];  // [cg][bins] count | fg << 16, then the low and high words of the error sums
  __shared__ bool s_last;
  const int c0 = blockIdx.y * cg;
  const int cn = min(cg, C - c0);
  const int size = cg * bins;
  unsigned* const s_lo = s_cf + size;
  unsigned* const s_hi = s_lo + size;
  for (int i = threadIdx.x; i < 3 * size; i += blockDim.x) s_cf[i] = 0u;
  __syncthreads();

  // background runs: bucket << kRunBits | count, and the f32 sum of their
  // errors (a run has fewer than 256 terms: no thread takes more pixels)
  unsigned run[kCg];
  float run_sum[kCg];
#pragma unroll
  for (int c = 0; c < kCg; ++c) run[c] = 0u, run_sum[c] = 0.0f;
  // shared addresses: bin `slot` of the counts at base + 4 slot
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(s_cf)), words = 4u * size;
  // the error terms' grid (quantize)
  const float scale = static_cast<float>(bins) * 65536.0f, inv_scale = 1.0f / scale;
  // the foreground run: slot c * bins + bucket (-1: none), count, error sum
  int fg_slot = -1;
  unsigned fg_n = 0u;
  float fg_sum = 0.0f;

  const int per_image = N / V;
  const int items = B * per_image;
  for (int it = blockIdx.x * blockDim.x + threadIdx.x; it < items; it += gridDim.x * blockDim.x) {
    const int b = it / per_image;
    const int n = (it - b * per_image) * V;
    int lab[V];
    Vec<V>::labels(labels + static_cast<size_t>(b) * N + n, lab);
    float p_fg[V];  // each pixel's probability of its own class, if in the group
#pragma unroll
    for (int j = 0; j < V; ++j) p_fg[j] = 0.0f;
    const float* prow = probas + (static_cast<size_t>(b) * C + c0) * N + n;
    // the next kPrefetch class rows' loads stay in flight while a row is binned
    typename Vec<V>::T rows[kPrefetch];
#pragma unroll
    for (int d = 0; d < kPrefetch; ++d)
      if (d < cn) rows[d] = Vec<V>::probas(prow + static_cast<size_t>(d) * N);
#pragma unroll
    for (int c = 0; c < kCg; ++c) {
      if (c >= cn) break;  // cn is uniform over the block
      const auto p = rows[c % kPrefetch];
      if (c + kPrefetch < cn) rows[c % kPrefetch] = Vec<V>::probas(prow + static_cast<size_t>(c + kPrefetch) * N);
      // the background elements of the V pixels, without branches: e = |p|
      bool bg[V];
      int k[V];
      float ev[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float pj = Vec<V>::at(p, j);
        if (lab[j] == c0 + c) p_fg[j] = pj;
        bg[j] = lab[j] != ignore && lab[j] != c0 + c;
        k[j] = bucket(fabsf(pj), bins);
        ev[j] = quantize(bf16_round(fabsf(pj)), scale, inv_scale);
      }
      // a run ends where a background element leaves its bucket: only the
      // flush branches (and only where some lane of the warp flushes), the
      // rest is selects
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const bool ends = bg[j] && static_cast<unsigned>(k[j]) != run[c] >> kRunBits;
        const unsigned count = run[c] & ((1u << kRunBits) - 1);
        if (ends && count)
          add_run(base + 4u * (c * bins + (run[c] >> kRunBits)), words, count, fixed(run_sum[c]));
        run[c] = (ends ? static_cast<unsigned>(k[j]) << kRunBits : run[c]) + (bg[j] ? 1u : 0u);
        run_sum[c] = (ends ? 0.0f : run_sum[c]) + (bg[j] ? ev[j] : 0.0f);
      }
    }
    // the foreground elements: one per valid pixel whose class is in the group
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = lab[j] - c0;
      if (lab[j] == ignore || c < 0 || c >= cn) continue;
      const float e = error(true, p_fg[j]);
      const int slot = c * bins + bucket(e, bins);
      if (slot != fg_slot) {
        if (fg_n) add_run(base + 4u * fg_slot, words, fg_n | fg_n << 16, fixed(fg_sum));
        fg_slot = slot, fg_n = 0u, fg_sum = 0.0f;
      }
      ++fg_n;
      fg_sum += quantize(bf16_round(e), scale, inv_scale);
    }
  }
#pragma unroll
  for (int c = 0; c < kCg; ++c) {
    const unsigned count = run[c] & ((1u << kRunBits) - 1);
    if (c < cn && count) add_run(base + 4u * (c * bins + (run[c] >> kRunBits)), words, count, fixed(run_sum[c]));
  }
  if (fg_n) add_run(base + 4u * fg_slot, words, fg_n | fg_n << 16, fixed(fg_sum));
  __syncthreads();

  const int total = C * bins;
  unsigned long long* const ws_cf = ws;
  unsigned long long* const ws_err = ws + total;
  unsigned* const done = reinterpret_cast<unsigned*>(ws + 2 * total);
  for (int i = threadIdx.x; i < cn * bins; i += blockDim.x) {
    const unsigned cf = s_cf[i];
    if (cf) {
      atomicAdd(ws_cf + c0 * bins + i, static_cast<unsigned long long>(cf & 0xffffu) |
                                           static_cast<unsigned long long>(cf >> 16) << 32);
      atomicAdd(ws_err + c0 * bins + i, static_cast<unsigned long long>(s_hi[i]) << 32 | s_lo[i]);
    }
  }
  if (out == nullptr) return;  // the integer histogram stays in ws
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(done, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const unsigned long long cf = __ldcg(ws_cf + i);
    const int c = i / bins, k = i - c * bins;
    float* const o = out + static_cast<size_t>(c) * 3 * bins + k;
    o[0] = static_cast<float>(static_cast<unsigned>(cf));
    o[bins] = static_cast<float>(static_cast<unsigned>(cf >> 32));
    o[2 * bins] = static_cast<float>(static_cast<double>(__ldcg(ws_err + i)) * 0x1p-40);
  }
}

// Block (x, y) writes the gradient of the classes c0 = y * cg .. c0 + cn - 1
// for its share of the pixels, from their rows of the table.
__global__ void __launch_bounds__(kThreads, 4)
lovasz_bwd_kernel(const float* __restrict__ probas, const int* __restrict__ labels,
                  const float* __restrict__ table, float* __restrict__ out,
                  int B, int C, int N, int bins, int ignore, int interp, int cg) {
  extern __shared__ float s_tab[];  // bf16-rounded table rows of the group, (cn, interp ? 2 : 1, bins)
  const int ntab = interp ? 2 : 1;
  const int c0 = blockIdx.y * cg;
  const int cn = min(cg, C - c0);
  const float* tab = table + static_cast<size_t>(c0) * ntab * bins;
  for (int i = threadIdx.x; i < cn * ntab * bins; i += blockDim.x) s_tab[i] = bf16_round(tab[i]);
  __syncthreads();

  const int total = B * N;
  for (int pix = blockIdx.x * blockDim.x + threadIdx.x; pix < total; pix += gridDim.x * blockDim.x) {
    const int b = pix / N;
    const int n = pix - b * N;
    const int label = labels[pix];
    const bool valid = label != ignore;
    const size_t base = (static_cast<size_t>(b) * C + c0) * N + n;
    float p[kMaxClasses];
#pragma unroll
    for (int c = 0; c < kMaxClasses; ++c) p[c] = c < cn ? __ldg(probas + base + static_cast<size_t>(c) * N) : 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxClasses; ++c) {
      if (c >= cn) break;
      float g = 0.0f;
      if (valid) {
        const bool fg = label == c0 + c;
        const int row = interp ? 2 * c + (fg ? 0 : 1) : c;
        const float coef = s_tab[row * bins + bucket(error(fg, p[c]), bins)];
        g = fg ? -coef : coef;  // coef * (1 - 2 fg), exactly
      }
      out[base + static_cast<size_t>(c) * N] = g;
    }
  }
}

template <int kCg, int V>
int launch_hist(const void* probas, const void* labels, void* ws, void* out, int B, int C, int N, int bins,
                int ignore, int blocks, int cg, size_t smem, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(lovasz_hist_kernel<kCg, V>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks, (C + cg - 1) / cg);
  lovasz_hist_kernel<kCg, V><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(probas), static_cast<const int*>(labels), static_cast<unsigned long long*>(ws),
      static_cast<float*>(out), B, C, N, bins, ignore, cg);
  return cudaGetLastError();
}

}  // namespace

// blocks: blocks per class group, each taking at most 65535 pixels; cg:
// classes per group (C for one group); vec: 4 pixels a thread (N a multiple
// of 4, probas and labels 16-byte aligned). ws: 2 * C * bins + 1 u64 of
// scratch, zeroed here; out null: no finalize, ws keeps the integer
// histogram ([C * bins] count | fg << 32, [C * bins] error sums * 2^40).
extern "C" int lovasz_hist_launch(const void* probas, const void* labels, void* ws, void* out, int B, int C,
                                  int N, int bins, int ignore, int blocks, int cg, int vec, void* stream) {
  if (C < 1 || blocks < 1 || cg < 1 || cg > C || cg > kMaxClasses || (vec && N % 4)) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(3) * cg * bins * sizeof(unsigned);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemsetAsync(ws, 0, (static_cast<size_t>(2) * C * bins + 1) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return err;
  if (cg <= kSmallGroup) {
    return vec ? launch_hist<kSmallGroup, 4>(probas, labels, ws, out, B, C, N, bins, ignore, blocks, cg, smem, s)
               : launch_hist<kSmallGroup, 1>(probas, labels, ws, out, B, C, N, bins, ignore, blocks, cg, smem, s);
  }
  return vec ? launch_hist<kMaxClasses, 4>(probas, labels, ws, out, B, C, N, bins, ignore, blocks, cg, smem, s)
             : launch_hist<kMaxClasses, 1>(probas, labels, ws, out, B, C, N, bins, ignore, blocks, cg, smem, s);
}

// blocks: blocks per class group; cg: classes per group (C for one group).
extern "C" int lovasz_bwd_launch(const void* probas, const void* labels, const void* table, void* out,
                                 int B, int C, int N, int bins, int ignore, int interp, int blocks, int cg,
                                 void* stream) {
  if (C < 1 || blocks < 1 || cg < 1 || cg > C || cg > kMaxClasses) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(interp ? 2 : 1) * cg * bins * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(lovasz_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks, (C + cg - 1) / cg);
  lovasz_bwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(probas), static_cast<const int*>(labels), static_cast<const float*>(table),
      static_cast<float*>(out), B, C, N, bins, ignore, interp, cg);
  return cudaGetLastError();
}
