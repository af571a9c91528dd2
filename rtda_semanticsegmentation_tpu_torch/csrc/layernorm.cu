// LayerNorm over the last axis, train and eval, for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces no TPU kernel: the JAX package has no SegFormer and no LayerNorm.
// It was added because PyTorch's own kernels ran SegFormer-B5's 161 norms a
// step at about a tenth of their byte bound: a block for each 64-320-wide
// row forward, the affine parameters' gradient in a pass of its own over
// every row, and a cast of the f32 weight and bias to the activation dtype
// (and of their gradients back) around every call.
//
// What it computes (kernels/layernorm.py holds the plain version), for each
// row x of C elements, w and b the f32 weight and bias rounded to the
// activation dtype T (round() below):
//   mean = sum(x) / C, var = sum((x - mean)^2) / C (two passes over the row
//   held in registers, f32), rstd = rsqrt(var + eps);
//   y = round((x - mean) * rstd * w + b), f32 and rounded once.
// The backward, with x^ = (x - mean) * rstd from the forward's mean and rstd
// and g = dy * w:
//   dx = rstd * (g - mean(g) - x^ * mean(g * x^)), f32 and rounded once;
//   dweight = sum over rows of dy * x^, dbias = sum over rows of dy, f32.
//
// What bounds it on an H100: bytes. Forward: read x, write y (4 bytes an
// element in bf16, and 8 a row of statistics); backward: read dy and x, write
// dx (6). The design moves no more and launches three kernels a call:
// - layernorm_forward: a group of `lanes` threads (a power of two up to 32)
//   holds a row in registers, n 16-byte vectors of V elements a thread (the
//   row is a whole number of them, and the group's lanes * n is exactly its
//   vectors), lane-strided so that each load of the group is contiguous; the sums go across the group by shuffles; y is written, and
//   the row's mean and rstd where the caller keeps them for a backward; the
//   blocks, as many as the SMs hold at once, stride over the rows;
// - layernorm_backward: the same groups over rows; each block walks a fixed
//   range of rows, writes dx for each, and keeps f32 sums of dy * x^ and dy
//   for the channels its threads own; at its end it adds its groups' sums in
//   a fixed order into one partial row of 2C. Those sums take two registers
//   an element a thread holds, so x and dy stay packed as loaded, and a
//   thread that holds more than 16 elements (C = 320) runs in blocks of 128
//   bounded to three blocks an SM;
// - layernorm_finish: one warp a column of the partial rows adds them in a
//   fixed order (f64) into dweight and dbias.
// No atomics: every run gives the same bits. The grouping (V, lanes, n) and
// the backward's blocks and rows a block come from launch_plan in
// kernels/layernorm.py, from the shape and the dtype.
//
// The launch functions enqueue on the given stream, allocate nothing, and
// return cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxN = 5;          // vectors a thread holds of a row, at most
constexpr int kMaxThreads = 256;  // a block
constexpr int kFinishWarps = 8;   // columns a finishing block takes

struct LnArgs {
  const void* x;
  const void* dy;        // the backward's
  void* out;             // y, or dx
  const float* weight;
  const float* bias;
  float* mean;           // [rows]: written by the forward where not null, read by the backward
  float* rstd;           // [rows]
  float* partial;        // [2][C][blocks]: the backward's sums of dy * x^ and dy, a column a block
  float* dweight;
  float* dbias;
  long long rows;
  long long rows_per_block;  // the backward's
  int C, lanes, blocks;
  float eps;
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

// V elements of T (16 bytes) as loaded, kept packed in registers until each
// is read as f32.
template <typename T, int V>
struct Pack {
  uint4 r;

  __device__ __forceinline__ void load(const T* p) { r = __ldg(reinterpret_cast<const uint4*>(p)); }
  __device__ __forceinline__ unsigned word(int i) const { return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w; }
  __device__ __forceinline__ float operator[](int i) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(word(i));
    } else {
      return __uint_as_float(i % 2 ? word(i / 2) & 0xffff0000u : word(i / 2) << 16);
    }
  }
};

// V elements of T at p, as f32.
template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&v)[V]) {
  Pack<T, V> k;
  k.load(p);
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = k[i];
}

// V f32 values rounded to T and stored at p in one 16-byte store.
template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&v)[V]) {
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

// The sum of s over the thread's group of `lanes` (a power of two, the group
// aligned in its warp), by a butterfly: every lane ends with the same bits.
__device__ __forceinline__ float group_sum(float s, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// Where a thread's vectors of a row lie: vector k of lane `lane` is the
// row's vector k * lanes + lane (so each load of the group is contiguous),
// its first channel `ch(k)`.
template <int V>
struct Slots {
  int lane, lanes;

  __device__ __forceinline__ Slots(const LnArgs& a) : lane(threadIdx.x % a.lanes), lanes(a.lanes) {}
  __device__ __forceinline__ int ch(int k) const { return (k * lanes + lane) * V; }
};

// The f32 weight (or bias) of a vector's channels rounded to T.
template <typename T, int V>
__device__ __forceinline__ void weights(const float* p, int c, float (&w)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) w[i] = rnd<T>(__ldg(p + c + i));
}

// One row of the forward for each group of the block: `row`, or none past
// the rows (every thread takes part in its group's shuffles all the same).
template <typename T, int V, int N>
__device__ __forceinline__ void forward_row(const LnArgs& a, const Slots<V>& s, long long row) {
  const bool active = row < a.rows;
  const T* x = static_cast<const T*>(a.x) + row * a.C;
  float v[N][V];
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (active) {
      load<T, V>(x + s.ch(k), v[k]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[k][i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) sum += v[k][i];
  }
  const float mean = __fdiv_rn(group_sum(sum, a.lanes), static_cast<float>(a.C));
  float sq = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float d = v[k][i] - mean;  // 0 past the rows (v and mean are 0)
      sq = fmaf(d, d, sq);
    }
  }
  const float rstd = rsqrtf(__fdiv_rn(group_sum(sq, a.lanes), static_cast<float>(a.C)) + a.eps);
  if (!active) return;
  T* y = static_cast<T*>(a.out) + row * a.C;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float w[V], b[V], o[V];
    weights<T, V>(a.weight, s.ch(k), w);
    weights<T, V>(a.bias, s.ch(k), b);
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = fmaf((v[k][i] - mean) * rstd, w[i], b[i]);
    store<T, V>(y + s.ch(k), o);
  }
  if (a.mean != nullptr && s.lane == 0) {
    a.mean[row] = mean;
    a.rstd[row] = rstd;
  }
}

// The blocks stride over the rows, a row a group at a time: every thread of
// a block runs the same iterations.
template <typename T, int V, int N>
__global__ void __launch_bounds__(kMaxThreads) layernorm_forward(const LnArgs a) {
  const Slots<V> s(a);
  const int groups = blockDim.x / a.lanes;
  for (long long base = static_cast<long long>(blockIdx.x) * groups; base < a.rows;
       base += static_cast<long long>(gridDim.x) * groups) {
    forward_row<T, V, N>(a, s, base + threadIdx.x / a.lanes);
  }
}

// Elements a thread holds above which the backward runs in blocks of 128
// (kernels/layernorm.py LIGHT).
constexpr int kLight = 16;

template <int N, int V>
constexpr int kBwdThreads = N * V > kLight ? 128 : kMaxThreads;

template <typename T, int V, int N>
__global__ void __launch_bounds__(kBwdThreads<N, V>, N * V > kLight ? 3 : 1)
    layernorm_backward(const LnArgs a) {
  __shared__ float buf[kBwdThreads<N, V> * N * V];  // the block's groups' sums of one kind, [group][C]
  const Slots<V> s(a);
  const int groups = blockDim.x / a.lanes, group = threadIdx.x / a.lanes;
  const long long first = static_cast<long long>(blockIdx.x) * a.rows_per_block;
  const long long end = min(first + a.rows_per_block, a.rows);
  float sdw[N][V], sdb[N][V];
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int i = 0; i < V; ++i) sdw[k][i] = sdb[k][i] = 0.0f;
  }
  const float inv_c = 1.0f / static_cast<float>(a.C);
  // every thread of the block runs the same iterations (its group's shuffles)
  for (long long base = first; base < end; base += groups) {
    const long long row = base + group;
    const bool active = row < end;
    Pack<T, V> xv[N], dv[N];
    float mean = 0.0f, rstd = 0.0f;
    if (active) {
      mean = a.mean[row];
      rstd = a.rstd[row];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        xv[k].load(static_cast<const T*>(a.x) + row * a.C + s.ch(k));
        dv[k].load(static_cast<const T*>(a.dy) + row * a.C + s.ch(k));
      }
    }
    // x^ and g from the packed x and dy, the same expressions both times
    float sg = 0.0f, sgx = 0.0f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (active) {
        float w[V];
        weights<T, V>(a.weight, s.ch(k), w);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float d = dv[k][i], xh = (xv[k][i] - mean) * rstd, g = d * w[i];
          sdw[k][i] = fmaf(d, xh, sdw[k][i]);
          sdb[k][i] += d;
          sg += g;
          sgx = fmaf(g, xh, sgx);
        }
      }
    }
    const float mg = group_sum(sg, a.lanes) * inv_c, mgx = group_sum(sgx, a.lanes) * inv_c;
    if (active) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        float w[V], o[V];
        weights<T, V>(a.weight, s.ch(k), w);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xh = (xv[k][i] - mean) * rstd, g = dv[k][i] * w[i];
          o[i] = rstd * (g - mg - xh * mgx);
        }
        store<T, V>(static_cast<T*>(a.out) + row * a.C + s.ch(k), o);
      }
    }
  }
  // the groups' sums, each kind in turn: into buf by group, then one column
  // a thread added over the groups in order
  for (int kind = 0; kind < 2; ++kind) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
#pragma unroll
      for (int i = 0; i < V; ++i) buf[group * a.C + s.ch(k) + i] = kind ? sdb[k][i] : sdw[k][i];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < a.C; c += blockDim.x) {
      float t = 0.0f;
      for (int q = 0; q < groups; ++q) t += buf[q * a.C + c];
      a.partial[(static_cast<long long>(kind) * a.C + c) * a.blocks + blockIdx.x] = t;
    }
    __syncthreads();  // buf is taken again
  }
}

// Column blockIdx.x * kFinishWarps + warp of the partial rows ([2][C]
// columns of `blocks`): its sum in f64, each lane's in order, then the lanes'
// by a butterfly; dweight for the first C columns, dbias for the rest.
__global__ void __launch_bounds__(kFinishWarps * 32) layernorm_finish(const LnArgs a) {
  const int col = blockIdx.x * kFinishWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (col >= 2 * a.C) return;  // whole warps leave together
  const float* p = a.partial + static_cast<long long>(col) * a.blocks;
  double t[4] = {};  // four loads in flight a lane
  for (int j = lane; j < a.blocks; j += 128) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (j + 32 * u < a.blocks) t[u] += p[j + 32 * u];
    }
  }
  double sum = (t[0] + t[1]) + (t[2] + t[3]);
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    if (col < a.C) {
      a.dweight[col] = static_cast<float>(sum);
    } else {
      a.dbias[col - a.C] = static_cast<float>(sum);
    }
  }
}

template <typename T>
struct Type {
  using type = T;
};
template <int N>
using Int = std::integral_constant<int, N>;

// Calls f(Type<T>, Int<V>, Int<N>) for the element type asked for, its
// 16-byte vector's V elements, and the vectors a thread holds.
template <typename F>
int with_n(int n, F&& f) {
  switch (n) {
    case 1: return f(Int<1>{});
    case 2: return f(Int<2>{});
    case 3: return f(Int<3>{});
    case 4: return f(Int<4>{});
    default: return f(Int<5>{});
  }
}

template <typename F>
int with_types(int f32, int n, F&& f) {
  return with_n(n, [&](auto nn) {
    return f32 ? f(Type<float>{}, Int<4>{}, nn) : f(Type<__nv_bfloat16>{}, Int<8>{}, nn);
  });
}

// The checks every launch makes of its shape and grouping: the group's
// vectors are exactly a row's, and whole groups fill the block.
bool valid(int f32, long long rows, int C, int lanes, int n, int threads) {
  if (rows < 1 || C < 1) return false;
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) || n < 1 || n > kMaxN) return false;
  if (lanes * n * (f32 ? 4 : 8) != C) return false;
  return threads >= 32 && threads <= kMaxThreads && threads % 32 == 0;
}

LnArgs make_args(const void* x, void* out, const float* weight, float* mean, float* rstd, long long rows, int C,
                 int lanes) {
  LnArgs a{};
  a.x = x;
  a.out = out;
  a.weight = weight;
  a.mean = mean;
  a.rstd = rstd;
  a.rows = rows;
  a.C = C;
  a.lanes = lanes;
  return a;
}

}  // namespace

// Blocks of `threads` threads of the forward (bwd = 0) or the backward's row
// pass that one SM holds at once; 0 on an error.
extern "C" int layernorm_occupancy(int f32, int n, int bwd, int threads) {
  return with_types(f32, n, [&](auto t, auto vec, auto nn) {
    using T = typename decltype(t)::type;
    constexpr int V = decltype(vec)::value, N = decltype(nn)::value;
    int blocks = 0;
    const cudaError_t err =
        bwd ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, layernorm_backward<T, V, N>, threads, 0)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, layernorm_forward<T, V, N>, threads, 0);
    return err == cudaSuccess ? blocks : 0;
  });
}

// x, y: [rows][C] dense, f32 = 1 for float, 0 for bf16, C a whole number of
// 16-byte vectors; weight, bias: [C] f32; mean, rstd: [rows] f32, or null
// (no backward follows); lanes, n, threads and the blocks that stride over
// the rows as kernels/layernorm.py::launch_plan gives them.
extern "C" int layernorm_forward(const void* x, void* y, const float* weight, const float* bias, float* mean,
                                 float* rstd, int f32, long long rows, int C, float eps, int lanes, int n,
                                 int threads, int blocks, void* stream) {
  if (!valid(f32, rows, C, lanes, n, threads) || blocks < 1 || (mean == nullptr) != (rstd == nullptr)) {
    return cudaErrorInvalidValue;
  }
  LnArgs a = make_args(x, y, weight, mean, rstd, rows, C, lanes);
  a.bias = bias;
  a.eps = eps;
  return with_types(f32, n, [&](auto t, auto vec, auto nn) {
    using T = typename decltype(t)::type;
    constexpr int V = decltype(vec)::value, N = decltype(nn)::value;
    layernorm_forward<T, V, N><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
  });
}

// The backward of layernorm_forward: dy and x [rows][C] dense, mean and rstd
// the forward's; dx [rows][C]. blocks of the row pass,
// each over rows_per_block rows (the last over what is left); partial:
// [2][C][blocks] f32 scratch; dweight, dbias: [C] f32, written by the
// finishing pass.
extern "C" int layernorm_backward(const void* dy, const void* x, void* dx, const float* weight, const float* mean,
                                  const float* rstd, float* partial, float* dweight, float* dbias, int f32,
                                  long long rows, int C, int lanes, int n, int threads, int blocks,
                                  long long rows_per_block, void* stream) {
  if (!valid(f32, rows, C, lanes, n, threads) || (n * (f32 ? 4 : 8) > kLight && threads > 128) || blocks < 1 ||
      rows_per_block < 1 ||
      static_cast<long long>(blocks) * rows_per_block < rows) {
    return cudaErrorInvalidValue;
  }
  LnArgs a = make_args(x, dx, weight, const_cast<float*>(mean), const_cast<float*>(rstd), rows, C, lanes);
  a.dy = dy;
  a.partial = partial;
  a.dweight = dweight;
  a.dbias = dbias;
  a.blocks = blocks;
  a.rows_per_block = rows_per_block;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_types(f32, n, [&](auto t, auto vec, auto nn) {
    using T = typename decltype(t)::type;
    constexpr int V = decltype(vec)::value, N = decltype(nn)::value;
    layernorm_backward<T, V, N><<<blocks, threads, 0, s>>>(a);
    const int finish = (2 * C + kFinishWarps - 1) / kFinishWarps;
    layernorm_finish<<<finish, kFinishWarps * 32, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  });
}
