// Train-mode BatchNorm, with the ReLU of its ConvBN, for Hopper (sm_90a), with
// a plain C interface.
//
// Replaces no TPU kernel: the JAX package's FoldableBatchNorm is plain jnp,
// left to XLA's fusions. It was added because PyTorch runs the same
// expressions (models/layers.py) as about 20 eager operations forward and 25
// backward a call, through f32 copies of every bf16 activation, and those
// passes held most of a DeepLabV2 train step's device time.
//
// What it computes (kernels/batchnorm.py holds the plain version), per
// channel c over the n = N*H*W elements x of the channel (data parallel,
// over every rank's):
//   mean = E[x], var = E[x^2] - mean^2 (sums in f32 a thread, f64 from the
//   block up), invstd = rsqrt(var + eps), mul = weight * invstd,
//   add = bias - mean * mul, each f32 operation rounded on its own as
//   PyTorch's eager operations round them;
//   running_mean = m * running_mean + (1 - m) * mean,
//   running_var = m * running_var + ((1 - m) * var) * n / (n - 1), flax's
//   momentum m, where `update` asks for it;
//   y = relu(round(round(x * round(mul)) + round(add))), round() to the
//   activation dtype, the ReLU where `relu` asks for it: the same bits as the
//   plain version's given the same mul and add.
// The backward, with g = dy where the output is above 0 and 0 elsewhere (the
// ReLU's mask, recomputed from x, mul and add: the same bits as the
// forward's; g = dy without the ReLU):
//   dbias = sum g, dweight = invstd * sum g (x - mean),
//   dx = g * mul + k (x - mean) + c0 with k = -weight invstd^3 sum g (x - mean) / n
//   and c0 = -mul sum g / n: the exact gradient through the batch mean and
//   variance, in f32, rounded once.
//
// What bounds it on an H100: bytes. Per element it has to read x for the
// statistics, read x and write y, read dy and x for the gradient's sums, and
// read dy and x and write dx: 16 bytes in bf16. The design moves no more:
// - one pass of partial sums (batchnorm_sums) reads x (and dy) once with
//   16-byte loads along the innermost axis, kUnroll loads in flight a
//   thread; each block writes its per-channel sums, in f64, to a partial row;
// - a small pass (batchnorm_finish_stats / batchnorm_finish_grad) adds the
//   partial rows of each channel in a fixed order (no atomics, so every run
//   gives the same bits) and makes the per-channel coefficients, the running
//   statistics and the parameters' gradients;
// - one elementwise pass (batchnorm_map) reads x (and dy) and writes y (dx).
// So a forward is 3 launches and a backward 3, and autograd keeps x and four
// vectors (mean, invstd, mul, add) a channel.
// Data parallel (the statistics of the global batch, n every rank's count),
// the partial sums' pass runs alone; the caller adds its partial rows, sums
// them and its count over the ranks, and hands that one row and the global n
// to the finishing and elementwise passes. The backward's dweight and dbias
// stay the rank's own: the caller takes them from its rows before the sum.
//
// Layout: the channels innermost (channels_last memory, or a (B, C, 1, 1)
// gate): x is [rows][C] (dy's rows may lie further apart: the gradient of one
// part of a torch.cat); each thread owns V channels and walks rows, so its
// coefficients stay in registers. V is 16 bytes of elements where the rows
// and the base are 16-byte aligned, else 1. The block shape (tx channel
// groups by ty rows) and the rows of a block's chunk are chosen by
// launch_plan in kernels/batchnorm.py from the shape and the dtype.
//
// The launch functions enqueue on the given stream and return
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVec = 8;
constexpr int kUnroll = 4;                             // rows (vectors) a thread loads before it adds
constexpr int kFinishChannels = 4;                     // channels a finishing block takes
constexpr int kFinishLanes = kThreads / kFinishChannels;  // threads that split one channel's partial rows
constexpr int kFinishUnroll = 4;                       // partial rows a lane loads before it adds
constexpr int kSums = 1, kFinish = 2, kMap = 4;        // the passes a launch runs

struct Args {
  const void* x;
  const void* dy;       // the backward's
  void* out;            // y, or dx
  const float* weight;
  const float* bias;
  float* running_mean;
  float* running_var;
  float* coef;          // [4][C]: mean, invstd, mul, add
  float* grad;          // [4][C]: dweight, dbias, k, c0
  double* partial;      // [chunks][2][C]
  const double* count;  // the global count n, where the ranks' sums are given (else rows)
  long long rows;       // N*H*W
  long long ld_dy;      // elements between dy's rows (C, or more for a channel slice)
  long long chunk_len;  // the partial sums' block: rows
  long long map_chunk_len;  // the elementwise pass's block: rows
  int C, tx, ty, chunks, map_chunks;
  int update, relu;
  float eps, momentum, rest;  // rest: 1 - momentum, as the plain version rounds it

  __device__ __forceinline__ double n() const { return count ? *count : static_cast<double>(rows); }
};

template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return v;
}
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ unsigned bf16_bits(float v) { return __bfloat16_as_ushort(__float2bfloat16_rn(v)); }

// V elements of T as loaded (16 bytes where V > 1), kept packed in
// registers until each element is read as f32.
template <typename T, int V>
struct Pack {
  uint4 r;

  __device__ __forceinline__ void load(const T* p) { r = __ldg(reinterpret_cast<const uint4*>(p)); }
  __device__ __forceinline__ void clear() { r = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ unsigned word(int i) const { return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w; }
  __device__ __forceinline__ float operator[](int i) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(word(i));
    } else {
      return __uint_as_float(i % 2 ? word(i / 2) & 0xffff0000u : word(i / 2) << 16);
    }
  }
};

template <typename T>
struct Pack<T, 1> {
  float v;

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (sizeof(T) == 4) {
      v = __ldg(reinterpret_cast<const float*>(p));
    } else {
      v = __uint_as_float(static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
    }
  }
  __device__ __forceinline__ void clear() { v = 0.0f; }
  __device__ __forceinline__ float operator[](int) const { return v; }
};

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float*>(p) = v[0];
    } else {
      *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(bf16_bits(v[0]));
    }
  } else {
    unsigned w[4];
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = __float_as_uint(v[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = bf16_bits(v[2 * i]) | (bf16_bits(v[2 * i + 1]) << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The forward's output before its ReLU: round(round(x * mul) + add), with mul
// and add already rounded to T (f32 products and sums, no fused multiply-add,
// as PyTorch's two eager operations compute them).
template <typename T>
__device__ __forceinline__ float affine(float x, float mul, float add) {
  return rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(x, mul)), add));
}

// The coefficients of the V channels c .. c + V - 1 a thread owns. mul is rounded to T in the forward (the
// apply's operand) and kept in f32 in the backward (dx's), where the ReLU's
// mask rounds it; mean, k and c0 only where the pass reads them.
template <typename T, int V, bool kGrad>
struct Coefs {
  float mul[V], add[V], mean[V], k[V], c0[V];

  __device__ __forceinline__ void load(const Args& a, int c, bool dx) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int ch = c + i;
      mul[i] = kGrad ? a.coef[2 * a.C + ch] : rnd<T>(a.coef[2 * a.C + ch]);
      add[i] = rnd<T>(a.coef[3 * a.C + ch]);
      if (kGrad) mean[i] = a.coef[ch];
      if (dx) {
        k[i] = a.grad[2 * a.C + ch];
        c0[i] = a.grad[3 * a.C + ch];
      }
    }
  }

  // The ReLU's mask for the gradient, as PyTorch's threshold_backward takes
  // it: 0 where the output is at most 0, dy elsewhere.
  __device__ __forceinline__ float masked(const Args& a, int i, float x, float dy) const {
    return a.relu && affine<T>(x, rnd<T>(mul[i]), add[i]) <= 0.0f ? 0.0f : dy;
  }
};

// The rows a thread visits, [first, end) in steps of ty, for chunks of
// `chunk_len`, and its channels c0 .. c0 + V - 1 (none past C: inactive).
template <int V>
struct Walk {
  long long first, end;
  int c0;
  bool active;

  __device__ __forceinline__ Walk(const Args& a, long long chunk_len) {
    const long long j0 = blockIdx.y * chunk_len;
    const int tx = threadIdx.x % a.tx, ty = threadIdx.x / a.tx;
    c0 = (blockIdx.x * a.tx + tx) * V;
    first = j0 + ty;
    end = min(j0 + chunk_len, a.rows);
    active = c0 < a.C;
  }
};

// The block's sums of s (one per thread and channel of its V) added over the
// block's ty rows in a fixed order, in f64, one thread a column; written to
// partial row `row`.
template <int V>
__device__ __forceinline__ void block_sums(const Args& a, const float (&s)[V], double* buf, long long row) {
  const int width = a.tx * V, tx = threadIdx.x % a.tx, ty = threadIdx.x / a.tx;
#pragma unroll
  for (int i = 0; i < V; ++i) buf[ty * width + tx * V + i] = s[i];
  __syncthreads();
  const int c = blockIdx.x * width + threadIdx.x;
  if (threadIdx.x < width && c < a.C) {
    double t = 0.0;
    for (int y = 0; y < a.ty; ++y) t += buf[y * width + threadIdx.x];
    a.partial[row * a.C + c] = t;
  }
  __syncthreads();  // buf is taken again
}

template <typename T, int V, bool kGrad>
__global__ void __launch_bounds__(kThreads, 2) batchnorm_sums(const Args a) {
  __shared__ double buf[kThreads * kMaxVec];
  float s0[V], s1[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s0[i] = s1[i] = 0.0f;
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  const Walk<V> w(a, a.chunk_len);
  if (w.active) {
    Coefs<T, V, kGrad> cf;
    if (kGrad) cf.load(a, w.c0, false);
    for (long long j = w.first; j < w.end; j += a.ty * kUnroll) {
      Pack<T, V> xv[kUnroll], dv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long jj = j + u * a.ty;
        xv[u].clear();
        if (kGrad) dv[u].clear();
        if (jj < w.end) {
          xv[u].load(x + jj * a.C + w.c0);
          if (kGrad) dv[u].load(dy + jj * a.ld_dy + w.c0);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xi = xv[u][i];
          if (kGrad) {
            const float g = cf.masked(a, i, xi, dv[u][i]);
            s0[i] += g;
            s1[i] = fmaf(g, xi - cf.mean[i], s1[i]);
          } else {
            s0[i] += xi;
            s1[i] = fmaf(xi, xi, s1[i]);
          }
        }
      }
    }
  }
  block_sums<V>(a, s0, buf, 2LL * blockIdx.y);
  block_sums<V>(a, s1, buf, 2LL * blockIdx.y + 1);
}

// Channel blockIdx.x * kFinishChannels + (threadIdx.x % kFinishChannels): its
// two sums over every partial row, in a fixed order (each lane adds its rows
// into kFinishUnroll accumulators, so as many loads are in flight, then the
// lanes are added in order); returns false for the threads that do not hold
// the result.
__device__ __forceinline__ bool channel_sums(const Args& a, int* c, double* t0, double* t1) {
  __shared__ double buf[2][kFinishLanes][kFinishChannels];
  const int k = threadIdx.x % kFinishChannels, lane = threadIdx.x / kFinishChannels;
  *c = blockIdx.x * kFinishChannels + k;
  double s0[kFinishUnroll] = {}, s1[kFinishUnroll] = {};
  if (*c < a.C) {
    for (int p = lane; p < a.chunks; p += kFinishLanes * kFinishUnroll) {
#pragma unroll
      for (int u = 0; u < kFinishUnroll; ++u) {
        const int q = p + u * kFinishLanes;
        if (q < a.chunks) {
          s0[u] += a.partial[(2LL * q) * a.C + *c];
          s1[u] += a.partial[(2LL * q + 1) * a.C + *c];
        }
      }
    }
  }
#pragma unroll
  for (int u = 1; u < kFinishUnroll; ++u) {
    s0[0] += s0[u];
    s1[0] += s1[u];
  }
  buf[0][lane][k] = s0[0];
  buf[1][lane][k] = s1[0];
  __syncthreads();
  if (lane != 0 || *c >= a.C) return false;
  *t0 = *t1 = 0.0;
  for (int l = 0; l < kFinishLanes; ++l) {
    *t0 += buf[0][l][k];
    *t1 += buf[1][l][k];
  }
  return true;
}

__global__ void __launch_bounds__(kThreads) batchnorm_finish_stats(const Args a) {
  int c;
  double sx, sxx;
  if (!channel_sums(a, &c, &sx, &sxx)) return;
  const double n = a.n();
  const double md = sx / n;
  const float mean = static_cast<float>(md);
  const float var = static_cast<float>(sxx / n - md * md);
  const float invstd = rsqrtf(__fadd_rn(var, a.eps));
  const float mul = __fmul_rn(a.weight[c], invstd);
  a.coef[c] = mean;
  a.coef[a.C + c] = invstd;
  a.coef[2 * a.C + c] = mul;
  a.coef[3 * a.C + c] = __fsub_rn(a.bias[c], __fmul_rn(mean, mul));
  if (a.update) {
    // the unbiased factor n / (n - 1) in f64, rounded once to f32
    const float unbiased = static_cast<float>(n / fmax(n - 1.0, 1.0));
    a.running_mean[c] = __fadd_rn(__fmul_rn(a.momentum, a.running_mean[c]), __fmul_rn(a.rest, mean));
    a.running_var[c] = __fadd_rn(__fmul_rn(a.momentum, a.running_var[c]),
                                 __fmul_rn(__fmul_rn(a.rest, var), unbiased));
  }
}

__global__ void __launch_bounds__(kThreads) batchnorm_finish_grad(const Args a) {
  int c;
  double sg, sgx;
  if (!channel_sums(a, &c, &sg, &sgx)) return;
  const double n = a.n();
  const double invstd = a.coef[a.C + c];
  a.grad[c] = static_cast<float>(sgx * invstd);
  a.grad[a.C + c] = static_cast<float>(sg);
  a.grad[2 * a.C + c] = static_cast<float>(-static_cast<double>(a.weight[c]) * invstd * invstd * invstd * sgx / n);
  a.grad[3 * a.C + c] = static_cast<float>(-static_cast<double>(a.coef[2 * a.C + c]) * sg / n);
}

template <typename T, int V, bool kGrad>
__global__ void __launch_bounds__(kThreads, 2) batchnorm_map(const Args a) {
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  T* out = static_cast<T*>(a.out);
  const Walk<V> w(a, a.map_chunk_len);
  if (!w.active) return;
  Coefs<T, V, kGrad> cf;
  cf.load(a, w.c0, kGrad);
  for (long long j = w.first; j < w.end; j += a.ty * kUnroll) {
    Pack<T, V> xv[kUnroll], dv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long jj = j + u * a.ty;
      if (jj < w.end) {
        xv[u].load(x + jj * a.C + w.c0);
        if (kGrad) dv[u].load(dy + jj * a.ld_dy + w.c0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long jj = j + u * a.ty;
      if (jj >= w.end) break;
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xi = xv[u][i];
        if (kGrad) {
          const float g = cf.masked(a, i, xi, dv[u][i]);
          o[i] = fmaf(g, cf.mul[i], fmaf(cf.k[i], xi - cf.mean[i], cf.c0[i]));
        } else {
          const float z = affine<T>(xi, cf.mul[i], cf.add[i]);
          o[i] = a.relu && z < 0.0f ? 0.0f : z;
        }
      }
      store<T, V>(out + jj * a.C + w.c0, o);
    }
  }
}

template <typename T>
struct Type {
  using type = T;
};
template <int N>
using Int = std::integral_constant<int, N>;

// Calls f(Type<T>, Int<V>) for the element type and vector width asked for.
template <typename F>
int with_types(int f32, int v, F&& f) {
  if (f32) return v == 4 ? f(Type<float>{}, Int<4>{}) : f(Type<float>{}, Int<1>{});
  return v == 8 ? f(Type<__nv_bfloat16>{}, Int<8>{}) : f(Type<__nv_bfloat16>{}, Int<1>{});
}

template <bool kGrad>
int launch(const Args& a, int f32, int v, int passes, cudaStream_t stream) {
  return with_types(f32, v, [&](auto t, auto vec) {
    using T = typename decltype(t)::type;
    constexpr int V = decltype(vec)::value;
    const int tiles = (a.C + a.tx * V - 1) / (a.tx * V);
    if (passes & kSums) batchnorm_sums<T, V, kGrad><<<dim3(tiles, a.chunks), a.tx * a.ty, 0, stream>>>(a);
    if (passes & kFinish) {
      const int blocks = (a.C + kFinishChannels - 1) / kFinishChannels;
      if (kGrad) {
        batchnorm_finish_grad<<<blocks, kThreads, 0, stream>>>(a);
      } else {
        batchnorm_finish_stats<<<blocks, kThreads, 0, stream>>>(a);
      }
    }
    if ((passes & kMap) && a.out != nullptr) {
      batchnorm_map<T, V, kGrad><<<dim3(tiles, a.map_chunks), a.tx * a.ty, 0, stream>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

// The checks every launch makes of its shape and plan: the grid of each pass
// it runs covers the rows.
bool valid(int f32, long long rows, int C, long long ld_dy, int v, int tx, int ty, int chunks, long long chunk_len,
           int map_chunks, long long map_chunk_len, int passes) {
  const int vec = f32 ? 4 : 8;
  if (rows < 1 || C < 1 || (v != 1 && v != vec) || C % v || ld_dy < C || ld_dy % v) return false;
  if (tx < 1 || tx > 32 || ty < 1 || tx * ty > kThreads || passes < 1 || passes > (kSums | kFinish | kMap)) {
    return false;
  }
  if (chunks < 1 || chunks > 65535 || map_chunks < 1 || map_chunks > 65535) return false;
  if ((passes & kSums) && static_cast<long long>(chunks) * chunk_len < rows) return false;
  return !(passes & kMap) || static_cast<long long>(map_chunks) * map_chunk_len >= rows;
}

Args make_args(const void* x, void* out, long long rows, int C, const float* weight, const float* coef,
               double* partial, const double* count, int relu, int tx, int ty, int chunks, long long chunk_len,
               int map_chunks, long long map_chunk_len) {
  Args a{};
  a.x = x;
  a.out = out;
  a.weight = weight;
  a.coef = const_cast<float*>(coef);
  a.partial = partial;
  a.count = count;
  a.rows = rows;
  a.ld_dy = C;
  a.chunk_len = chunk_len;
  a.map_chunk_len = map_chunk_len;
  a.C = C;
  a.tx = tx;
  a.ty = ty;
  a.chunks = chunks;
  a.map_chunks = map_chunks;
  a.relu = relu;
  return a;
}

}  // namespace

// Blocks of the partial-sums (map = 0) or the elementwise (map = 1) kernel of
// the forward (grad = 0) or the backward that one SM holds at once with
// `threads` threads; 0 on an error.
extern "C" int batchnorm_occupancy(int f32, int v, int grad, int map, int threads) {
  return with_types(f32, v, [&](auto t, auto vec) {
    using T = typename decltype(t)::type;
    constexpr int V = decltype(vec)::value;
    int blocks = 0;
    cudaError_t err;
    if (map) {
      err = grad ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, batchnorm_map<T, V, true>, threads, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, batchnorm_map<T, V, false>, threads, 0);
    } else {
      err = grad ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, batchnorm_sums<T, V, true>, threads, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, batchnorm_sums<T, V, false>, threads, 0);
    }
    return err == cudaSuccess ? blocks : 0;
  });
}

// passes: 1 the partial sums, 2 the finishing pass, 4 the elementwise pass
// (their sum for a whole forward or backward). x (and y) are (N, C, H, W)
// with the channels innermost, rows = N*H*W; f32 = 1 for float, 0 for bf16;
// v, tx, ty, chunks, chunk_len (the partial sums' grid), map_chunks and
// map_chunk_len (the elementwise pass's) as
// kernels/batchnorm.py::launch_plan gives them. coef: [4][C] f32, written by
// the finishing pass and read by the elementwise pass; partial: [chunks][2][C]
// f64, written by the partial sums and read by the finishing pass. count:
// null, or (data parallel) the global count n on the device, which the
// finishing pass divides by in place of rows; partial then holds the ranks'
// summed row (chunks 1).
extern "C" int batchnorm_forward(const void* x, void* y, int f32, long long rows, int C, const float* weight,
                                 const float* bias, float* running_mean, float* running_var, float* coef,
                                 double* partial, const double* count, int update, int relu, float eps,
                                 float momentum, float rest, int v, int tx, int ty, int chunks, long long chunk_len,
                                 int map_chunks, long long map_chunk_len, int passes, void* stream) {
  if (!valid(f32, rows, C, C, v, tx, ty, chunks, chunk_len, map_chunks, map_chunk_len, passes)) {
    return cudaErrorInvalidValue;
  }
  Args a = make_args(x, y, rows, C, weight, coef, partial, count, relu, tx, ty, chunks, chunk_len, map_chunks,
                     map_chunk_len);
  a.bias = bias;
  a.running_mean = running_mean;
  a.running_var = running_var;
  a.update = update;
  a.eps = eps;
  a.momentum = momentum;
  a.rest = rest;
  return launch<false>(a, f32, v, passes, static_cast<cudaStream_t>(stream));
}

// The backward of batchnorm_forward: dy's rows ld_dy >= C elements apart (a
// channel slice of a wider channels_last tensor; C where dense), coef the
// forward's. grad: [4][C] f32, dweight and dbias (the finishing pass writes
// them from the sums it is given) and the elementwise pass's two
// coefficients; dx may be null (no input gradient: the elementwise pass is
// skipped). partial and count as the forward's.
extern "C" int batchnorm_backward(const void* x, const void* dy, void* dx, int f32, long long rows, int C,
                                  long long ld_dy, const float* weight, const float* coef, float* grad,
                                  double* partial, const double* count, int relu, int v, int tx, int ty, int chunks,
                                  long long chunk_len, int map_chunks, long long map_chunk_len, int passes,
                                  void* stream) {
  if (!valid(f32, rows, C, ld_dy, v, tx, ty, chunks, chunk_len, map_chunks, map_chunk_len, passes)) {
    return cudaErrorInvalidValue;
  }
  Args a = make_args(x, dx, rows, C, weight, coef, partial, count, relu, tx, ty, chunks, chunk_len, map_chunks,
                     map_chunk_len);
  a.dy = dy;
  a.ld_dy = ld_dy;
  a.grad = grad;
  return launch<true>(a, f32, v, passes, static_cast<cudaStream_t>(stream));
}
