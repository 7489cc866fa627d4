// Hopper (sm_90a) primitives of the quantized matmuls on the tensor cores:
// csrc/int4_matmul.cu (the int4 decode matmul), csrc/int4_unpack_probe.cu
// (its unpack-schedule probe) and csrc/w8a8_matmul.cu.  All three stream a
// (K, N) N-contiguous weight through a ring of 2-D TMA boxes in the
// 128-byte swizzle, read their activations with `ldmatrix`, build B
// fragments in registers with byte permutes (one 32-bit word of four
// columns feeds four interleaved n8 tiles: tile j, column c is the warp's
// column 4c + j), and sum split-K partials in one launch through a
// thread-block cluster's distributed shared memory, in rank order.  The
// mbarriers and the tensor-map encoder are flash_fwd_sm90.cuh's.
#pragma once

#include <cooperative_groups.h>

#include "flash_fwd_sm90.cuh"

namespace quant_sm90 {

using flash_sm90::encode_tiled;
using flash_sm90::mbar_arrive;
using flash_sm90::mbar_expect_tx;
using flash_sm90::mbar_init;
using flash_sm90::mbar_wait;
using flash_sm90::prefetch_map;
using flash_sm90::smem_u32;

constexpr int kMaxSplits = 8;  // a portable cluster

// byte offset of (row r, byte c) in a 128-byte-swizzled tile of 128-byte rows
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((((c >> 4) ^ (r & 7)) << 4) | (c & 15));
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// d += a.b (m16n8k16, bf16 in, f32 accumulate); with kFirst, d = a.b
template <bool kFirst = false>
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  if constexpr (kFirst) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// four 8 x 16-byte matrices from shared memory, one a register: with the
// lanes' row addresses of an m16 tile (lanes 0-15 rows 0-15 at byte 0,
// lanes 16-31 the same rows at byte 16), the A fragment of m16n8k16 bf16
// and of m16n8k32 s8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// (a & b) | c and (a & b) ^ c in one instruction each
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ uint32_t and_xor(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// the two halves' products, each rounded once to bf16
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  const __nv_bfloat162 d = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// the fragment's rows outside [lo, hi) of the step zeroed (a group boundary
// or the split's end inside a k16 step)
__device__ __forceinline__ uint32_t row_mask(int r0, int lo, int hi) {
  return (r0 >= lo && r0 < hi ? 0x0000FFFFu : 0u) | (r0 + 1 >= lo && r0 + 1 < hi ? 0xFFFF0000u : 0u);
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// a 2-D (inner, outer) map with the given element type, row pitch in bytes
// and box; what lies outside the tensor reads as zeros
inline bool make_map_2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int inner,
                        int outer, long long pitch, int box_inner, int box_outer,
                        CUtensorMapSwizzle swizzle) {
  const auto encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// Launches `kernel` with `smem` bytes of dynamic shared memory and, with
// splits > 1, clusters of `splits` blocks along z; returns a cudaError_t
template <class Kernel, class... Args>
int launch_cluster(Kernel kernel, dim3 grid, int threads, int smem, int splits,
                   cudaStream_t stream, Args... args) {
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 1;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = splits;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace quant_sm90
