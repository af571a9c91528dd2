// Pieces shared by the wgmma convolutions (conv3x3.cu, K4, bf16;
// int8_conv.cu, K3, s8; conv4x4s2.cu, K5a, K5b and K5c, bf16): TMA loads into a ring of shared-memory stages
// with full / empty mbarriers, wgmma shared-memory descriptors for the
// 128-byte swizzle, and the host-side encoding of the tensor maps.
//
// The block: two consumer warpgroups (each one or two 64-row halves of a
// 128- or 256-pixel tile, on wgmma m64nN) and one producer warpgroup, of
// which one thread issues the TMA loads. A stage holds one K-slice of 128
// bytes per row: the A tile (the tile's output pixels x 128 B of one filter
// tap's channels, loaded by an im2col-mode tensor map) and the B tile (the
// weights of those channels for the tile's N output channels, by a tiled
// map). TMA writes A (and a wide B) with the 128-byte swizzle, the layout
// wgmma reads from a descriptor without bank conflicts.
//
// The driver's encode functions are reached through cudaGetDriverEntryPoint,
// so the libraries link against the CUDA runtime only (no -lcuda).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hconv {

constexpr int kConsumers = 2;                   // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kRow = 128;                       // bytes of one K-slice row (the swizzle span)
constexpr int kSmemBudget = 200 * 1024;         // ring bytes a block may take
constexpr int kMaxStages = 8;

// Stages that fit the budget for a given stage size (a multiple of 1024).
__host__ __device__ constexpr int stages_for(int stage_bytes) {
  return kSmemBudget / stage_bytes < kMaxStages ? kSmemBudget / stage_bytes : kMaxStages;
}

// Dynamic shared memory of a block: the ring, 1024 bytes of alignment slack
// (the swizzle atom), and the 2 x stages mbarriers.
__host__ __device__ constexpr int smem_bytes(int stage_bytes) {
  return stages_for(stage_bytes) * stage_bytes + 1024 + 2 * kMaxStages * 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// arrive, and expect `bytes` more of TMA traffic in this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spin until the phase of parity `parity` has completed; a wait of more
// than 2^35 cycles (~19 s) traps, so a broken pipeline fails the launch
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = -1;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 < 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1LL << 35)) {
      __trap();
    }
  }
}

// Tiled 3-D TMA load of one box into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// im2col-mode TMA load: pixelsPerColumn pixels from (w, h, n) on, in NHW
// order within the map's bounding box, each shifted by (off_w, off_h), with
// the map's channelsPerPixel channels from c on; out-of-bounds pixels and
// channels read as zero.
__device__ __forceinline__ void tma_load_im2col(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c, int w,
                                                int h, int n, uint16_t off_w, uint16_t off_h) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(n), "h"(off_w), "h"(off_h)
      : "memory");
}

// Tiled 4-D TMA load of one box into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Tiled 4-D TMA store of one box from shared memory (the parts of the box
// outside the tensor are not written), in this thread's bulk group.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2, int c3) {
  asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// wait until at most N of this thread's committed bulk store groups have
// not yet read their shared memory
template <int N = 0>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// wait until this thread's bulk stores are complete
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }
// makes this thread's generic writes to shared memory visible to TMA and wgmma
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
// barrier `id` (1-15) over `threads` threads (a multiple of 32)
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// wait until at most N committed wgmma groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of an accumulator register across the
// wgmma wait (the asm statements that write it complete asynchronously).
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_reg(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// wgmma descriptor of an operand at shared address `addr`. 128-byte
// swizzle (`swizzled`; the swizzle atom 1024-byte aligned): `lbo` the byte
// stride between 64-element column groups (MN-major only), `sbo` between
// 8-row groups. No swizzle (8 x 8 core matrices of 128 contiguous bytes):
// `lbo` the stride between core matrices along K, `sbo` along M or N.
__device__ __forceinline__ uint64_t desc_sw(uint32_t addr, uint32_t lbo, uint32_t sbo, bool swizzled = true) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (static_cast<uint64_t>(swizzled) << 62);
}

// The ring of a block: kStages stages of StageBytes from `ring` (aligned to
// the 1024-byte swizzle atom), then the full and empty barriers. `full`
// completes on the producer's arrival plus the stage's TMA bytes, `empty` on
// the arrival of every thread of the Consumers consumer warpgroups. The
// barriers take the first 128 bytes after the stages; a kernel that keeps
// more in shared memory puts it 1024 bytes after them (`extra`).
template <int StageBytes, int Stages = stages_for(StageBytes), int Consumers = kConsumers>
struct Ring {
  static_assert(Stages >= 1 && Stages <= kMaxStages, "stages");
  static constexpr int kStages = Stages;
  uint32_t ring, full, empty;

  __device__ explicit Ring(void* smem) {
    ring = (smem_u32(smem) + 1023) & ~1023u;
    full = ring + kStages * StageBytes;
    empty = full + 8 * kMaxStages;
  }
  __device__ uint32_t stage(int s) const { return ring + s * StageBytes; }
  __device__ uint32_t extra() const { return full + 1024; }
  __device__ uint32_t full_bar(int s) const { return full + 8 * s; }
  __device__ uint32_t empty_bar(int s) const { return empty + 8 * s; }

  // one thread initialises the barriers; the whole block waits for it
  __device__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full_bar(s), 1);
        mbar_init(empty_bar(s), 128 * Consumers);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
};

// A position in the ring: the stage and the parity of its current round.
// Producer and consumers walk the same sequence of stages over all the
// tiles of a (persistent) block.
template <int Stages>
struct Cursor {
  int s = 0;
  uint32_t phase = 0;
  __device__ void next() {
    if (++s == Stages) {
      s = 0;
      phase ^= 1;
    }
  }
};

// ---- host: tensor maps -------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const int*, const int*, cuuint32_t, cuuint32_t,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline void* driver_entry(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  if (cudaGetDriverEntryPointByVersion(name, &fn, 12000, cudaEnableDefault, &q) != cudaSuccess) return nullptr;
#else
  if (cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &q) != cudaSuccess) return nullptr;
#endif
  return q == cudaDriverEntryPointSuccess ? fn : nullptr;
}

// Blocks of a persistent launch: one per SM (a block takes most of an SM's
// shared memory), fewer when there are fewer tiles.
inline int persistent_blocks(long long tiles) {
  static const int sms = [] {
    int dev = 0, n = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return static_cast<int>(tiles < sms ? tiles : sms);
}

// Error codes the launch functions return besides cudaError_t values.
constexpr int kErrNoDriverEntry = 9001;   // cuTensorMapEncode* not found
constexpr int kErrEncode = 9002;          // the driver refused a tensor map

// NHWC activations (C, W, H, B innermost first; `esize` bytes per element)
// as an im2col map for a k x k, stride s, padding p, dilation d conv: each
// load is `pixels` output pixels x (128 / esize) channels of one filter tap,
// 128-byte swizzle. The bounding box of a tap's window runs from -p to
// dim - 1 + p - (k - 1) d, walked with the conv's stride.
inline int encode_im2col(CUtensorMap* map, CUtensorMapDataType dtype, int esize, const void* x, int B, int H, int W,
                         int C, int k, int s, int p, int d, int pixels) {
  static EncodeIm2col encode = reinterpret_cast<EncodeIm2col>(driver_entry("cuTensorMapEncodeIm2col"));
  if (encode == nullptr) return kErrNoDriverEntry;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C) * esize, static_cast<cuuint64_t>(W) * C * esize,
                                 static_cast<cuuint64_t>(H) * W * C * esize};
  const int lower[2] = {-p, -p};
  const int upper[2] = {p - (k - 1) * d, p - (k - 1) * d};
  const cuuint32_t elem_strides[4] = {1, static_cast<cuuint32_t>(s), static_cast<cuuint32_t>(s), 1};
  const CUresult r = encode(map, dtype, 4, const_cast<void*>(x), dims, strides, lower, upper, kRow / esize, pixels,
                            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

// A 3-D tensor (d0 innermost, strides in bytes) as a tiled map with boxes of
// b0 x b1 x b2 elements; b0 spans 128 bytes, with the 128-byte swizzle, or
// (`swizzled` false) 16 bytes, unswizzled. Out-of-bounds reads zero.
inline int encode_tiled_3d(CUtensorMap* map, CUtensorMapDataType dtype, int esize, const void* base, long long d0,
                           long long d1, long long d2, long long stride1, long long stride2, int b1, int b2,
                           bool swizzled = true) {
  static EncodeTiled encode = reinterpret_cast<EncodeTiled>(driver_entry("cuTensorMapEncodeTiled"));
  if (encode == nullptr) return kErrNoDriverEntry;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0), static_cast<cuuint64_t>(d1), static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(stride1), static_cast<cuuint64_t>(stride2)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>((swizzled ? kRow : 16) / esize), static_cast<cuuint32_t>(b1),
                             static_cast<cuuint32_t>(b2)};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(map, dtype, 3, const_cast<void*>(base), dims, strides, box, elem_strides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzled ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

// A 4-D tensor (d0 innermost; strides of d1-d3 in bytes, multiples of 16)
// as a tiled map with boxes of b0 x b1 x b2 x 1 elements, unswizzled or with
// the 128-byte swizzle (b0 then spans 128 bytes). Out-of-bounds reads zero.
inline int encode_tiled_4d(CUtensorMap* map, CUtensorMapDataType dtype, const void* base, long long d0, long long d1,
                           long long d2, long long d3, long long stride1, long long stride2, long long stride3,
                           int b0, int b1, int b2, bool swizzled) {
  static EncodeTiled encode = reinterpret_cast<EncodeTiled>(driver_entry("cuTensorMapEncodeTiled"));
  if (encode == nullptr) return kErrNoDriverEntry;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d0), static_cast<cuuint64_t>(d1), static_cast<cuuint64_t>(d2),
                              static_cast<cuuint64_t>(d3)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(stride1), static_cast<cuuint64_t>(stride2),
                                 static_cast<cuuint64_t>(stride3)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(b0), static_cast<cuuint32_t>(b1), static_cast<cuuint32_t>(b2),
                             1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, dtype, 4, const_cast<void*>(base), dims, strides, box, elem_strides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzled ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

}  // namespace hconv
