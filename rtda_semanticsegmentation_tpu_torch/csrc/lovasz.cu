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
// so each class row of an image is contiguous and one thread per pixel reads
// its C values coalesced with its neighbours'. labels (B, N) int32.
//
// What bounds them on an H100: bytes. Both read the probabilities once (K2
// also writes its gradient once) and do a few operations per element, far
// below the card's ratio of operations to bytes. So:
// - each thread first loads all C probabilities of its pixel into registers,
//   which keeps C independent loads in flight per thread;
// - K1 counts into a private (3, C, bins) histogram per block in shared
//   memory (58 KB at C = 19, bins = 256) instead of the TPU's one-hot bf16
//   matrix products, which were only a stand-in for a scatter. The blocks
//   write their histograms to a workspace and a second, small kernel sums
//   them in a fixed order: no global atomics. Counts are u32, so they are
//   exact; the error sums are f32 and their order depends on the order of the
//   shared-memory atomics. Where the whole histogram does not fit a block's
//   shared memory (C = 19 at 1024 bins needs 233,472 B), a second grid
//   dimension splits the classes into groups of cg, and each block bins one
//   group; at 256 bins there is one group (of up to 32 classes);
// - contention: at initialisation p ~ 1/C puts nearly every background pixel
//   of a class into one bucket, so a warp's 32 lanes would hit one shared
//   address. A warp whose valid lanes fall in at most kAggMax distinct
//   buckets (__match_any_sync) first sums each bucket's lanes with shuffles
//   and lets one lane per bucket add; a warp spread over more buckets adds
//   lane by lane, where collisions are rare;
// - K2 keeps the bf16-rounded table (C * 2 * bins f32, 39 KB at 256 bins) in
//   shared memory; where it does not fit a block (311,296 B at 2048 bins), a
//   second grid dimension splits the classes into groups as K1 does, and each
//   block reads and writes only its group's classes. Every operation is
//   exact, so it matches its plain PyTorch version bit for bit;
// - a group holds at most kMaxClasses classes, the probabilities a thread
//   keeps in registers; more classes make more groups.
//
// Each launch function enqueues on the given stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxClasses = 32;
constexpr int kAggMax = 4;
constexpr unsigned kFull = 0xffffffffu;
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

// Block (x, y) bins the classes c0 = y * cg .. c0 + cn - 1 of its share of
// the pixels into partial[y][x] (3, cg, bins).
__global__ void __launch_bounds__(kThreads, 3)
lovasz_hist_kernel(const float* __restrict__ probas, const int* __restrict__ labels,
                   unsigned* __restrict__ partial, int B, int C, int N, int bins, int ignore, int cg) {
  extern __shared__ unsigned smem[];  // [3][cg][bins]: count, fg (u32), bf16 error sum (f32 bits)
  const int c0 = blockIdx.y * cg;
  const int cn = min(cg, C - c0);
  const int size = cg * bins;
  unsigned* s_cnt = smem;
  unsigned* s_fg = smem + size;
  float* s_err = reinterpret_cast<float*>(smem + 2 * size);
  for (int i = threadIdx.x; i < 3 * size; i += blockDim.x) smem[i] = 0u;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int total = B * N;
  // whole blocks step together, so every lane takes part in the warp collectives
  for (int base = blockIdx.x * blockDim.x; base < total; base += gridDim.x * blockDim.x) {
    const int pix = base + threadIdx.x;
    const bool in = pix < total;
    const int b = in ? pix / N : 0;
    const int n = in ? pix - b * N : 0;
    const int label = in ? labels[pix] : ignore;
    const bool valid = in && label != ignore;
    const float* prow = probas + (static_cast<size_t>(b) * C + c0) * N + n;
    float p[kMaxClasses];
#pragma unroll
    for (int c = 0; c < kMaxClasses; ++c) p[c] = (in && c < cn) ? __ldg(prow + static_cast<size_t>(c) * N) : 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxClasses; ++c) {
      if (c >= cn) break;  // cn is uniform: the whole warp leaves together
      const bool fg = label == c0 + c;
      const float e = error(fg, p[c]);
      const int k = valid ? bucket(e, bins) : -1;
      const float ev = bf16_round(e);
      const int slot = c * bins + k;
      const unsigned peers = __match_any_sync(kFull, k);
      const unsigned leaders = __ballot_sync(kFull, lane == __ffs(peers) - 1 && k >= 0);
      if (__popc(leaders) > kAggMax) {
        if (k >= 0) {
          atomicAdd(s_cnt + slot, 1u);
          if (fg) atomicAdd(s_fg + slot, 1u);
          atomicAdd(s_err + slot, ev);
        }
      } else {
        const unsigned fgmask = __ballot_sync(kFull, fg && k >= 0);
        for (unsigned todo = leaders; todo; todo &= todo - 1) {
          const int l = __ffs(todo) - 1;
          const unsigned grp = __shfl_sync(kFull, peers, l);
          float v = ((grp >> lane) & 1u) ? ev : 0.0f;
#pragma unroll
          for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
          if (lane == l) {
            atomicAdd(s_cnt + slot, static_cast<unsigned>(__popc(grp)));
            const unsigned f = __popc(grp & fgmask);
            if (f) atomicAdd(s_fg + slot, f);
            atomicAdd(s_err + slot, v);
          }
        }
      }
    }
  }
  __syncthreads();
  unsigned* out = partial + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * 3 * size;
  for (int i = threadIdx.x; i < 3 * size; i += blockDim.x) out[i] = smem[i];
}

// Sums the blocks' histograms in block order:
// partial (groups, blocks, 3, cg, bins) -> out (C, 3, bins)
__global__ void lovasz_hist_reduce(const unsigned* __restrict__ partial, float* __restrict__ out,
                                   int blocks, int C, int bins, int cg) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 3 * C * bins) return;
  const int row = i / (C * bins);
  const int c = (i - row * C * bins) / bins;
  const int k = i - (row * C + c) * bins;
  const int grp = c / cg;
  const size_t slab = static_cast<size_t>(3) * cg * bins;
  const unsigned* src = partial + grp * blocks * slab + (static_cast<size_t>(row) * cg + c - grp * cg) * bins + k;
  float* dst = out + (static_cast<size_t>(c) * 3 + row) * bins + k;
  if (row < 2) {
    unsigned long long s = 0;
    for (int j = 0; j < blocks; ++j) s += src[j * slab];
    *dst = static_cast<float>(s);
  } else {
    float s = 0.0f;
    for (int j = 0; j < blocks; ++j) s += __uint_as_float(src[j * slab]);
    *dst = s;
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

}  // namespace

// blocks: blocks per class group; cg: classes per group (C for one group).
// partial holds groups * blocks * 3 * cg * bins u32.
extern "C" int lovasz_hist_launch(const void* probas, const void* labels, void* partial, void* out,
                                  int B, int C, int N, int bins, int ignore, int blocks, int cg, void* stream) {
  if (C < 1 || blocks < 1 || cg < 1 || cg > C || cg > kMaxClasses) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(3) * cg * bins * sizeof(unsigned);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(lovasz_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks, (C + cg - 1) / cg);
  lovasz_hist_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(probas), static_cast<const int*>(labels), static_cast<unsigned*>(partial),
      B, C, N, bins, ignore, cg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_out = 3 * C * bins;
  lovasz_hist_reduce<<<(n_out + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const unsigned*>(partial), static_cast<float*>(out), blocks, C, bins, cg);
  return cudaGetLastError();
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
