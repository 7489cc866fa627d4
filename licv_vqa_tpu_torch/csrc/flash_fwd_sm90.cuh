// Causal flash-attention forward for Hopper (sm_90a), bf16 in / bf16 out,
// head dim 128: one tile loop on the tensor cores (wgmma) fed by the Tensor
// Memory Accelerator (TMA), with the visibility rule and the bias as
// template parameters.  Its primitives (TMA loads, mbarriers, wgmma
// descriptors and products, the online softmax, the tensor maps) also serve
// csrc/flash_attn_bidir.cu (the towers' head dim 72), csrc/flash_attn_bwd.cu
// (the causal backward), csrc/vit_attention.cu (the CLIP towers' fused
// attention) and csrc/int4_matmul.cu (its mbarriers and tensor-map encoder).
// Two entry points instantiate the template:
//
// - csrc/flash_attn_fwd.cu, MaskRule::Segment, Bias::None (replaces
//   licv_vqa_tpu/models/layers.py::flash_attention_tpu, the upstream Pallas
//   kernel with causal=True and segment ids valid + 1): key k is visible to
//   query q iff k <= q and valid[k] == valid[q].  Every row sees itself, so
//   every output is finite, pad rows' too (their K/V go to the KV cache).
//   With a non-null lse it writes the per-row log-sum-exp m + log l of the
//   scaled natural-log scores as (B, H, S) f32, which csrc/flash_attn_bwd.cu
//   reads.
// - csrc/flash_alibi.cu, MaskRule::ValidKey, Bias::Alibi (replaces
//   licv_vqa_tpu/ops/flash_alibi.py::flash_alibi_attention): k is visible to
//   q iff k <= q and valid[k] != 0; the score is scale*q.k - slope_h*(q - k)
//   in f32.  A row with no visible key (a left-pad row) writes 0.
//
// What bounds it on the H100: at the prefill and teacher shapes (S = 512 ..
// 2560, H = 32) attention does 4*S*(S+1)/2*128*H operations on 4*S*128*H*2
// bytes, so it is bound by the tensor cores' bf16 rate (989 TFLOP/s) above
// S of about 600 and by bytes below.  The design keeps the (S, S) scores
// out of device memory and feeds the tensor cores from shared memory:
//
// - One block per (128-query tile, head, batch row): two consumer
//   warpgroups of 64 query rows each and a producer warpgroup whose first
//   warp issues the loads.  The producer gives its registers to the
//   consumers (setmaxnreg: 24 a thread, the consumers 240), which is why it
//   is a whole warpgroup: setmaxnreg moves registers only within the
//   block, and a lone producer warp would free 16 a consumer thread.  The
//   query tiles of a head run longest first (blockIdx.x counts down the
//   causal bound), so the short diagonal-only tiles fill the last wave.
//   At S = 512 that is 4 * 32 = 128 blocks in one wave on 132 SMs; 64-row
//   tiles would not shorten it, since at one block per SM (the ring takes
//   most of shared memory) the longest block's work, 128 rows by 512 keys,
//   stays the wave's length.
// - The producer loads the block's Q tile once and K/V tiles of 128 keys
//   through a ring of kStages = 3 stages (224 KB with Q) by TMA
//   (cp.async.bulk.tensor) with mbarriers: a full barrier per K and per V
//   stage (S = Q.K^T starts before V lands) and an empty barrier per stage
//   that the consumers' 8 warps arrive on.  The tensor maps are 4-D over (Dh, S, H, B) with the caller's
//   strides (16-byte multiples, models/layers.py _check_flash_operand), so
//   strided q/k/v views load without a copy; rows past S read as zeros.
//   They are encoded on the host per call through the driver entry point
//   that the runtime hands out, so nothing links against libcuda.
// - 128-byte swizzle: a 128-dim row is two 64-dim TMA boxes of 128 bytes,
//   each half of a tile 16 KB; the wgmma descriptors name the same swizzle.
// - S = Q.K^T: 8 wgmma m64n128k16 (bf16 -> f32), both operands from shared
//   memory, K-major (Dh contiguous in Q and K).
// - Online softmax in base 2 (the scale and the ALiBi slope times log2(e)),
//   on a whole 128-key tile a step; each thread holds two rows, reduced
//   over the 4 threads that share a row.  The running max guards m = -inf
//   (a row with nothing visible yet): the exponent then subtracts 0, never
//   -inf - -inf.  The row sums stay per thread until the epilogue.
// - O += P.V: 8 wgmma m64n128k16 with P from registers (the S accumulator's
//   layout is the A fragment's), ROUNDED TO BF16, and V from shared memory
//   as an MN-major B (the transpose bit).  The row sums l add the f32
//   probabilities.  The Pallas kernels keep P in f32 (the plain versions
//   round the normalized P to bf16); the rounding of the unnormalized P
//   reads about one bf16 ulp of the output, inside phase 3's 2e-2 of
//   max|plain|.
// - Within a warpgroup, tile n's S = Q.K^T and softmax run while tile
//   n - 1's P.V is still on the tensor cores (two wgmma groups in flight,
//   wait_group 1 for the scores); the O rescale by tile n's factor waits
//   for that P.V.  The two warpgroups take turns to issue their products
//   (named barriers 1 and 2), so one's softmax runs under the other's
//   wgmma.  With no bias the row max is taken on the raw q.k and the scale
//   folds into the exponent's FFMA.  PERF.md §6 times each of these steps
//   on the card.
// - The per-element mask runs only where a warp's tile needs it: the
//   diagonal tile (which also holds the ragged tail past S) and tiles whose
//   keys' validity differs from the rule's (a warp votes on 4 keys a lane).
//   The causal bound ends the key loop.
// - Epilogue: rescale by 1/l (0 for a row with l = 0), bf16 stores from the
//   registers; the lse (m + log2 l) * ln 2 where asked.
#pragma once

#include <cuda.h>  // CUtensorMap and the encode function's types; no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash_sm90 {

enum class MaskRule { Segment, ValidKey };
enum class Bias { None, Alibi };

constexpr int kHeadDim = 128;
constexpr int kBlockM = 128;  // query rows a block
constexpr int kBlockN = 128;  // keys a tile
static_assert(kBlockM == kBlockN, "one TMA box shape serves Q, K and V");
constexpr int kStages = 3;    // K/V ring depth
constexpr int kConsumerWarps = 8;  // two warpgroups of 64 rows
constexpr int kThreads = kConsumerWarps * 32 + 128;  // + the producer warpgroup
// setmaxnreg moves registers only within the block: at 384 threads ptxas
// gives every thread kEntryRegs (65536 / 384, in 8s); the producer
// warpgroup drops to kProducerRegs and the consumers take what it frees
constexpr int kEntryRegs = 168;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = kEntryRegs + (kEntryRegs - kProducerRegs) / 2;  // 240
constexpr int kHalfBytes = kBlockN * 64 * 2;  // one 64-dim half of a tile
constexpr int kTileBytes = 2 * kHalfBytes;
constexpr int kBarOffset = kTileBytes * (1 + 2 * kStages);  // after Q, K ring, V ring
constexpr int kSmemBytes = kBarOffset + 8 * (1 + 3 * kStages) + 1024;  // + align slack
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  __nv_bfloat16* out;
  long long o_sb, o_ss, o_sh;  // element strides
  const int32_t* valid;        // (B, S)
  float* lse;                  // (B, H, S) or null
  const float* slopes;         // (H,) for Bias::Alibi
  int S, H;
  float scale_log2;  // scale * log2(e)
};

// ---------------------------------------------------------------- PTX ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// `bytes` contiguous bytes (16-byte aligned, a multiple of 16), completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// one box of the 4-D map at (dim, seq, head, batch), completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d, int s, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(s), "r"(h), "r"(b)
      : "memory");
}

// brings a tensor map (a kernel parameter) into the TMA unit's cache ahead
// of its first load
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// a 128-row tile's two 64-dim halves
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int s, int h, int b) {
  tma_load(dst, map, bar, 0, s, h, b);
  tma_load(dst + kHalfBytes, map, bar, 64, s, h, b);
}

// wgmma shared-memory descriptor, 128-byte swizzle.  K-major (Q, K): rows
// 128 bytes apart, 8-row groups 1024 apart (the leading offset unused).
// MN-major (V): 8-key groups 1024 apart, the next 64 dims a half away.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead, uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>(lead >> 4) << 16
         | static_cast<uint64_t>(stride >> 4) << 32
         | 1ull << 62;
}
// the same with 32-byte swizzle (a 16-dim box: rows 32 bytes, 8-row groups
// 256 apart)
__device__ __forceinline__ uint64_t smem_desc_sw32(uint32_t addr, uint32_t lead, uint32_t stride) {
  return smem_desc(addr, lead, stride) | 3ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// waits until at most N of this warpgroup's wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[K][4]) {
#pragma unroll
  for (int i = 0; i < 4 * K; ++i) asm volatile("" : "+r"(r[i / 4][i % 4])::"memory");
}

// named barriers 1 and 2 order the two consumer warpgroups' wgmma issues
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kConsumerWarps * 32) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kConsumerWarps * 32) : "memory");
}

#define FLASH_SM90_D64                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "        \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define FLASH_SM90_R8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),    \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define FLASH_SM90_R64                                                           \
  FLASH_SM90_R8(0), FLASH_SM90_R8(8), FLASH_SM90_R8(16), FLASH_SM90_R8(24),      \
      FLASH_SM90_R8(32), FLASH_SM90_R8(40), FLASH_SM90_R8(48), FLASH_SM90_R8(56)

// d (64 x 128, f32) = A.B^T (+ d), both bf16 K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FLASH_SM90_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : FLASH_SM90_R64
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, f32) += A.B, A bf16 from registers, B bf16 MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FLASH_SM90_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FLASH_SM90_R64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#define FLASH_SM90_D32                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "        \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define FLASH_SM90_R32 FLASH_SM90_R8(0), FLASH_SM90_R8(8), FLASH_SM90_R8(16), FLASH_SM90_R8(24)

// d (64 x 64, f32) = A.B^T (+ d), both bf16 K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_SM90_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FLASH_SM90_R32
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 72, f32) += A.B, A bf16 from registers, B bf16 MN-major in shared
// memory: 64 columns in one 128-byte swizzle atom, 8 in the next (LBO away)
__device__ __forceinline__ void wgmma_rs_n72(float (&d)[36], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35}, {%36, %37, %38, %39}, %40, p, 1, 1, 1;\n}\n"
      : FLASH_SM90_R32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#define FLASH_SM90_D128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
#define FLASH_SM90_R128                                                          \
  FLASH_SM90_R64, FLASH_SM90_R8(64), FLASH_SM90_R8(72), FLASH_SM90_R8(80),    \
      FLASH_SM90_R8(88), FLASH_SM90_R8(96), FLASH_SM90_R8(104), FLASH_SM90_R8(112), \
      FLASH_SM90_R8(120)

// The fused ViT kernel's products (csrc/vit_attention.cu): a whole 257-key
// score row as m64n256k16 + m64n8k16, and P.V over head dims 64-79 as
// m64n64k16 + m64n16k16.

// d (64 x 256, f32) = A.B^T (+ d), both bf16 K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " FLASH_SM90_D128
      ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : FLASH_SM90_R128
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 8, f32) = A.B^T (+ d), both bf16 K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n8(float (&d)[4], uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += A.B, A bf16 from registers, B bf16 MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_SM90_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FLASH_SM90_R32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 16, f32) += A.B, A bf16 from registers, B bf16 MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : FLASH_SM90_R8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef FLASH_SM90_D64
#undef FLASH_SM90_D128
#undef FLASH_SM90_R128
#undef FLASH_SM90_D32
#undef FLASH_SM90_R8
#undef FLASH_SM90_R32
#undef FLASH_SM90_R64

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------------- the two products ----
// Accumulator layout of m64nNk16 (f32): warp w of the warpgroup holds rows
// 16w + lane/4 (d[4j], d[4j+1]) and 16w + lane/4 + 8 (d[4j+2], d[4j+3]) at
// columns 8j + 2*(lane%4) + {0, 1}.

// Each issues one wgmma group; the caller fences the registers first
// (fence_regs, wgmma_fence) and waits for the group (wgmma_wait).

// s = Q.K^T: q = this warpgroup's 64 rows in the Q tile, k = a K tile
__device__ __forceinline__ void qk_issue(float (&s)[64], uint32_t q, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
    const uint32_t off = (kk / 4) * kHalfBytes + (kk % 4) * 32;
    wgmma_ss(s, smem_desc(q + off, 16, 1024), smem_desc(k + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// o += P.V: p = the probabilities as bf16 A fragments (16 keys a step), v = a V tile
__device__ __forceinline__ void pv_issue(float (&o)[64], const uint32_t (&p)[8][4], uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    wgmma_rs(o, p[kk], smem_desc(v + kk * 16 * 128, kHalfBytes, 1024));
  }
  wgmma_commit();
}

// the A fragments of P (m64k16 per 16 keys) are the S accumulator's pairs
__device__ __forceinline__ void p_fragments(const float (&s)[64], uint32_t (&p)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) p[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
  }
}

// ----------------------------------------------------- the two rules ----

template <MaskRule kRule>
__device__ __forceinline__ bool key_visible(int vk, int vq) {
  if constexpr (kRule == MaskRule::ValidKey) return vk != 0;  // every valid key (ALiBi)
  return vk == vq;  // the segment rule: a pad query attends the pads
}

// The score the softmax takes from the raw q.k.  With no bias it is q.k
// itself: the scale folds into the exponent (exp2(x * scale_log2 - m), one
// FFMA).  ALiBi's is the log2-domain score scale*q.k - slope*(q - k).
template <Bias kBias>
__device__ __forceinline__ float score(float qk, float scale_log2, float slope_log2, int k, int q) {
  if constexpr (kBias == Bias::Alibi) return fmaf(slope_log2, float(k - q), qk * scale_log2);
  return qk;
}

// what a consumer thread knows of its two query rows
struct Rows {
  int q[2];        // the rows (16w + lane/4 and + 8 in the warpgroup's 64)
  int valid[2];    // their validity (-1 past S: never a key's)
  int valid_warp;  // the warp's first row's
  bool alike;      // the warp's 16 rows share valid_warp (or the rule ignores it)
  int lo;          // the warp's first row
  int col;         // 2 * (lane % 4): the thread's first column in each 8
};

// Folds one tile's scores (hidden keys at -inf) into the rows' running max
// m and sum l (base 2, m in log2 units; to_log2 takes a score there): s
// becomes the probabilities, alpha the factor the rows' earlier output takes.
__device__ __forceinline__ void online_softmax(float (&s)[64], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], float to_log2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx * to_log2);
    // nothing visible yet: subtract 0 (every term is exp2(-inf) = 0)
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = ex2(m[r] - m_use);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * r + e];
        x = ex2(fmaf(x, to_log2, -m_use));
        sum += x;
      }
    l[r] = l[r] * alpha[r] + sum;
  }
}

// Scores and masks one tile's raw q.k in place and folds them into the
// rows' running max m and sum l (base 2, m in log2 units): s becomes the
// probabilities, alpha the factor the rows' earlier output takes.  kv holds
// the tile's key validity, key n0 + 32i + lane in kv[i].
template <MaskRule kRule, Bias kBias>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const Rows& rows, int n0,
                                             const int (&kv)[4], float scale_log2,
                                             float slope_log2) {
  const bool diag = n0 + kBlockN - 1 > rows.lo;  // a key past one of the warp's queries
  const bool clean =
      !diag && rows.alike &&
      __all_sync(0xffffffffu, key_visible<kRule>(kv[0], rows.valid_warp) &&
                                  key_visible<kRule>(kv[1], rows.valid_warp) &&
                                  key_visible<kRule>(kv[2], rows.valid_warp) &&
                                  key_visible<kRule>(kv[3], rows.valid_warp));
  if (clean && kBias == Bias::Alibi) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = n0 + 8 * j + rows.col + (i & 1);
        s[4 * j + i] = score<kBias>(s[4 * j + i], scale_log2, slope_log2, k, rows.q[i / 2]);
      }
  } else if (!clean) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // key 8j + col + e of the tile is kv[j / 4] of lane 8(j % 4) + col + e
        const int vk = __shfl_sync(0xffffffffu, kv[j / 4], 8 * (j % 4) + rows.col + e);
        const int k = n0 + 8 * j + rows.col + e;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& x = s[4 * j + 2 * r + e];
          const bool visible = k <= rows.q[r] && key_visible<kRule>(vk, rows.valid[r]);
          x = visible ? score<kBias>(x, scale_log2, slope_log2, k, rows.q[r]) : -INFINITY;
        }
      }
  }
  // the factor from a score to log2 units (the scale > 0 keeps the max)
  online_softmax(s, m, l, alpha, kBias == Bias::Alibi ? 1.f : scale_log2);
}

// the tile's key validity for a warp: key n0 + 32i + lane in kv[i] (0 past S)
__device__ __forceinline__ void load_key_validity(int (&kv)[4], const int32_t* valid_b, int n0,
                                                  int S, int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = n0 + 32 * i + lane;
    kv[i] = kj < S ? valid_b[kj] : 0;
  }
}

// ------------------------------------------------------------ kernel ----

template <MaskRule kRule, Bias kBias>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle wants 1024-byte aligned boxes
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + kTileBytes;
  const uint32_t v_s = base + kTileBytes * (1 + kStages);
  const uint32_t q_full = base + kBarOffset;
  const uint32_t k_full = q_full + 8;  // + 8 * stage
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int m0 = qt * kBlockM;
  // the causal bound: no key past the tile's last query is visible
  const int n_tiles = (min(p.S, m0 + kBlockM) + kBlockN - 1) / kBlockN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // the producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(q_full, kTileBytes);
      tma_load_tile(q_s, &tq, q_full, m0, h, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % kStages;
        // the stage's previous tile released (passes at once on the first round)
        mbar_wait(empty + 8 * st, ((n / kStages) & 1) ^ 1);
        mbar_expect_tx(k_full + 8 * st, kTileBytes);
        tma_load_tile(k_s + st * kTileBytes, &tk, k_full + 8 * st, n * kBlockN, h, b);
        mbar_expect_tx(v_full + 8 * st, kTileBytes);
        tma_load_tile(v_s + st * kTileBytes, &tv, v_full + 8 * st, n * kBlockN, h, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int wg = warp / 4;
    const int32_t* valid_b = p.valid + static_cast<long long>(b) * p.S;
    Rows rows;
    rows.lo = m0 + 64 * wg + 16 * (warp % 4);
    rows.col = 2 * (lane % 4);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rows.q[r] = rows.lo + lane / 4 + 8 * r;
      rows.valid[r] = rows.q[r] < p.S ? valid_b[rows.q[r]] : -1;
    }
    rows.valid_warp = __shfl_sync(0xffffffffu, rows.valid[0], 0);
    // ValidKey ignores the query's validity; the segment rule needs the
    // warp's 16 rows alike for a tile to go unmasked
    rows.alike = kRule == MaskRule::ValidKey ||
                 __all_sync(0xffffffffu, rows.valid[0] == rows.valid_warp &&
                                             rows.valid[1] == rows.valid_warp);
    const float slope_log2 = kBias == Bias::Alibi ? p.slopes[h] * kLog2e : 0.f;
    const uint32_t q_wg = q_s + wg * 64 * 128;

    float o[64], s[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = s[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float alpha[2];
    int kv[4];
    uint32_t pf[8][4];

    // The warpgroups take turns to issue their products (barrier 1 + wg
    // is this one's turn): one's softmax runs under the other's wgmma.
    // Warpgroup 0 goes first.
    const int my_turn = 1 + wg, their_turn = 2 - wg;
    if (wg == 1) named_arrive(their_turn);

    // the first tile's probabilities
    load_key_validity(kv, valid_b, 0, p.S, lane);
    mbar_wait(q_full, 0);
    mbar_wait(k_full, 0);
    named_sync(my_turn);
    fence_regs(s);
    wgmma_fence();
    qk_issue(s, q_wg, k_s);
    named_arrive(their_turn);
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile<kRule, kBias>(s, m, l, alpha, rows, 0, kv, p.scale_log2, slope_log2);
    p_fragments(s, pf);
    // tile n's scores and softmax run while tile n - 1's P.V is on the
    // tensor cores
    for (int n = 1; n < n_tiles; ++n) {
      const int st = n % kStages;
      const int prev = (n - 1) % kStages;
      load_key_validity(kv, valid_b, n * kBlockN, p.S, lane);
      mbar_wait(k_full + 8 * st, (n / kStages) & 1);
      mbar_wait(v_full + 8 * prev, ((n - 1) / kStages) & 1);
      named_sync(my_turn);
      fence_regs(s);
      fence_regs(o);
      fence_regs(pf);
      wgmma_fence();
      qk_issue(s, q_wg, k_s + st * kTileBytes);
      pv_issue(o, pf, v_s + prev * kTileBytes);
      named_arrive(their_turn);
      wgmma_wait<1>();  // the scores
      fence_regs(s);
      softmax_tile<kRule, kBias>(s, m, l, alpha, rows, n * kBlockN, kv, p.scale_log2,
                                 slope_log2);
      wgmma_wait<0>();  // the previous P.V: its stage is free
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * prev);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[4 * j + i] *= alpha[i / 2];
      p_fragments(s, pf);
    }
    const int last = (n_tiles - 1) % kStages;
    mbar_wait(v_full + 8 * last, ((n_tiles - 1) / kStages) & 1);
    named_sync(my_turn);
    fence_regs(o);
    fence_regs(pf);
    wgmma_fence();
    pv_issue(o, pf, v_s + last * kTileBytes);
    // warpgroup 1's last turn hands none on: warpgroup 0 has had all its own
    if (wg == 0) named_arrive(their_turn);
    wgmma_wait<0>();
    fence_regs(o);

    // epilogue: O / l in bf16, and the log-sum-exp where asked
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = rows.q[r];
      if (qi >= p.S) continue;
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
      __nv_bfloat16* row = p.out + b * p.o_sb + static_cast<long long>(qi) * p.o_ss + h * p.o_sh;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + rows.col) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      }
      if (p.lse != nullptr && lane % 4 == 0) {
        p.lse[(static_cast<long long>(b) * p.H + h) * p.S + qi] = (m[r] + log2f(l[r])) * kLn2;
      }
    }
  }
}

// One warpgroup, one tile of each product at the kernel's shapes, through
// the same loads, descriptors and wgmma calls: s = Q.K^T (64 x 128) and
// o = bf16(s).V (64 x 128), both f32 row-major.  The card test holds them
// against torch.matmul.
__global__ void __launch_bounds__(128)
tile_check_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, float* s_out, float* o_out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + 3 * kTileBytes;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, 3 * kTileBytes);
    tma_load_tile(base, &tq, bar, 0, 0, 0);
    tma_load_tile(base + kTileBytes, &tk, bar, 0, 0, 0);
    tma_load_tile(base + 2 * kTileBytes, &tv, bar, 0, 0, 0);
  }
  mbar_wait(bar, 0);
  float s[64], o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = o[i] = 0.f;
  fence_regs(s);
  wgmma_fence();
  qk_issue(s, base, base + kTileBytes);
  wgmma_wait<0>();
  fence_regs(s);
  uint32_t pf[8][4];
  p_fragments(s, pf);
  fence_regs(o);
  wgmma_fence();
  pv_issue(o, pf, base + 2 * kTileBytes);
  wgmma_wait<0>();
  fence_regs(o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = (16 * warp + lane / 4 + 8 * (i / 2)) * 128 + 8 * j + 2 * (lane % 4) + (i & 1);
      s_out[idx] = s[4 * j + i];
      o_out[idx] = o[4 * j + i];
    }
}

// -------------------------------------------------------------- host ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// the 4-D (dh, S, H, B) map of a (B, S, H, dh) bf16 tensor with element
// strides sb, ss, sh, in boxes of box_dh dims by box_rows rows; what lies
// outside the tensor (rows past S, dims past dh) reads as zeros
inline bool make_map(CUtensorMap* map, const void* ptr, int dh, int box_dh, int box_rows,
                     CUtensorMapSwizzle swizzle, int B, int S, int H, long long sb, long long ss,
                     long long sh) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  // a dimension of extent 1 is never stepped: any legal stride will do
  auto bytes = [dh](long long stride, int extent) -> cuuint64_t {
    return static_cast<cuuint64_t>(extent > 1 ? stride : dh) * 2;
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {bytes(ss, S), bytes(sh, H), bytes(sb, B)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_dh), static_cast<cuuint32_t>(box_rows),
                             1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the template's map: 128 dims in boxes of 64 dims by kBlockN rows
inline bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, long long sb,
                     long long ss, long long sh) {
  return make_map(map, ptr, kHeadDim, 64, kBlockN, CU_TENSOR_MAP_SWIZZLE_128B, B, S, H, sb, ss,
                  sh);
}

// A kernel of 384 threads whose consumers take registers from a producer
// warpgroup (setmaxnreg) must enter at kEntryRegs: at another count the
// consumers would wait for registers no warp frees.  Returns the error to
// report, or cudaSuccess once the kernel may take `smem` bytes.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  cudaFuncAttributes fa;
  if (cudaFuncGetAttributes(&fa, kernel) != cudaSuccess || fa.numRegs != kEntryRegs) {
    return cudaErrorInvalidConfiguration;
  }
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// Encodes the maps and launches on `stream`; returns a cudaError_t (a map
// the driver refuses is cudaErrorInvalidValue).
template <MaskRule kRule, Bias kBias>
int launch(const void* q, const void* k, const void* v, const long long (&qs)[3],
           const long long (&ks)[3], const long long (&vs)[3], const long long (&os)[3],
           const void* valid, const void* slopes, void* out, void* lse, int B, int S, int H,
           float scale, void* stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, S, H, qs[0], qs[1], qs[2]) ||
      !make_map(&tk, k, B, S, H, ks[0], ks[1], ks[2]) ||
      !make_map(&tv, v, B, S, H, vs[0], vs[1], vs[2])) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_fwd_kernel<kRule, kBias>;
  const cudaError_t ready = prepare(kernel, kSmemBytes);
  if (ready != cudaSuccess) return static_cast<int>(ready);
  const Params p{static_cast<__nv_bfloat16*>(out), os[0], os[1], os[2],
                 static_cast<const int32_t*>(valid), static_cast<float*>(lse),
                 static_cast<const float*>(slopes), S, H, scale * kLog2e};
  const dim3 grid((S + kBlockM - 1) / kBlockM, H, B);
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash_sm90
