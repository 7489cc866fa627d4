// Fused short-sequence bidirectional attention for Hopper (sm_90a), bf16 in /
// bf16 out, for the CLIP vision towers (OpenFlamingo's ViT-L, Idefics-9B's
// ViT-H) and any tower sequence up to 1024 patches: Q.K^T and P.V on the
// tensor cores (wgmma) from shared memory that TMA fills, on the primitives
// of csrc/flash_fwd_sm90.cuh.
//
// Replaces: licv_vqa_tpu/ops/vit_attention.py::vit_attention_tpu (the Pallas
// kernels _kernel and _kernel_masked), which holds a group of heads' whole
// (S, S) f32 score block in VMEM.
//
// Semantics (the Pallas kernels' function): scores q.k * scale in f32; a
// masked key (valid[k] == 0) scores finfo(f32).min (-FLT_MAX); softmax exact
// over the whole row; each probability NORMALISED and then rounded to bf16
// (V's dtype) before P.V, which sums in f32; bf16 output.  A row whose keys
// are all masked has every score at -FLT_MAX, so its softmax is uniform over
// its S keys, as in the plain version.  valid may be null: every key is real.
//
// Layout: q/k/v/out are (B, S, H, DH) addressed through element strides for
// b, s and h (the head dim is contiguous, rows 16-byte aligned), so strided
// views load without a copy.  valid is a contiguous (B, S) int32 or null.
// DH is 64 (ViT-L), 72 (SigLIP) or 80 (ViT-H).
//
// What bounds it on the H100: at the towers' shapes (S = 257, H = 16,
// DH = 64 or 80, 1 or 33 images) the function moves 4*S*DH*H*2 bytes and
// does 4*S*S*DH*H operations, about 128 a byte: under the bf16 ridge (about
// 295), so the bound is the bytes.  At one image the grid is 80 blocks on
// 132 SMs and the time is the latency of one block's loads and products.
// The exponentials (one a score, 16 a clock an SM) take about as long as
// the two products at these head dims, so the design computes each score
// and each exponential once where it can:
//
// - The rounding point forbids an online softmax (it rescales P after the
//   fact), so P needs the row's exact max and sum before P.V.  Where the
//   whole row fits in registers (S <= 264: every CLIP tower, S = 257) ONE
//   PASS: a warpgroup's 64 query rows take Q.K^T over all keys at once,
//   m64n256k16 + m64n8k16 (keys 0-255 and 256-263, 132 f32 registers a
//   thread), the max and the sum come from the registers, P is normalised,
//   rounded to bf16 and fed from the registers to P.V (17 k16 steps over
//   272 staged keys; keys 264-271 have P = 0).  The head's K and V (272
//   rows, 42.5 KB each at DH 80) stay in shared memory, loaded by TMA once.
// - Past 264 keys, TWO PASSES: K streams through a ring of 128-key tiles
//   for each row's max and sum (online, f32), then K and V again: the
//   scores recomputed, p = exp(s - m) / l formed, rounded, and P.V.  One
//   template holds both schedules (kOne); the ring's loads are issued by
//   thread 0 as the block's warps release each stage.
// - Head dim 64 is one TMA box a row (128-byte swizzle); 72 and 80 are that
//   box plus a 16-dim box with 32-byte swizzle (dims 64-79; TMA writes
//   zeros at 72-79 for DH 72), as in csrc/flash_attn_bidir.cu.  Q.K^T takes
//   four k16 steps on the first box and a fifth in the 32-byte descriptor
//   mode; P.V is m64n64k16 on V's first box plus m64n16k16 on its second
//   (V MN-major).  A single m64n80k16 would need V's second box at the
//   128-byte swizzle's 64-dim width: 68 KB of V in place of 42.5 KB, one
//   block an SM in place of two.
// - The key rule as an additive term of the log2 score, one f32 a key in
//   shared memory: 0 for a key that counts, -FLT_MAX for a masked key (so
//   an all-masked row is uniform: every x - max is 0), -inf for a key past
//   S (TMA reads those rows as zeros, whose score 0 would otherwise count;
//   -inf keeps them out of the max and the sum).  x = q.k * scale*log2(e)
//   + term, one FFMA; p = exp2(x - max).
// - Grid, chosen by timing both shapes on the H100 (PERF.md §6): one pass, one
//   block per (64 query rows, head, image), one warpgroup and no producer
//   warp (thread 0 issues the loads): at S = 257 that is 5 x 16 = 80
//   blocks for one image, each on an SM of its own, and two blocks fit an
//   SM (97 KB of shared memory at DH 80, 206 registers a thread).  128-row
//   blocks of two warpgroups sharing the head's K and V halve the K/V
//   reads but put two warpgroups' work on each of 48 SMs, slower at one
//   image and at 33.  Two passes, two warpgroups sharing the K/V ring: its
//   136 KB leave one block an SM, and one warpgroup alone leaves the SM
//   half idle.
#include <float.h>

#include "flash_fwd_sm90.cuh"

namespace {

using namespace flash_sm90;

constexpr int kRows = 64;       // query rows a warpgroup (wgmma's M)
constexpr int kOneKeys = 264;   // one pass: every key of a row (n256 + n8)
constexpr int kOneRows = 272;   // K/V rows staged in one pass: P.V's 17 k16 steps
constexpr int kOneBox = 136;    // rows of a one-pass K/V TMA box (two boxes)
constexpr int kTileKeys = 128;  // two passes: keys a tile
constexpr int kRing = 3;        // two passes: K/V stages
constexpr int kMaxS = 1024;     // the gate (models/layers.py vit_attention_usable)

template <int DH>
struct Dims {
  static_assert(DH == 64 || DH == 72 || DH == 80, "ViT-L, SigLIP or ViT-H");
  static constexpr bool kSplit = DH > 64;   // dims 64-79 in a second, 32-byte box
  static constexpr int kB = kSplit ? 32 : 0;  // a row's bytes in the second box
  static constexpr int kRowBytes = 128 + kB;
};

// Shared memory, from the 1024-aligned base: the 128-byte-swizzle parts
// (each a multiple of 1024 bytes), then the 32-byte-swizzle parts (of 256),
// the key terms and the barriers.  kOne: the one-pass layout (one
// warpgroup, one K and one V buffer of 272 rows), else two warpgroups
// sharing kRing stages of 128 keys.
template <int DH, bool kOne>
struct Smem {
  static constexpr int W = kOne ? 1 : 2;  // warpgroups a block
  static constexpr int kKvRows = kOne ? kOneRows : kTileKeys;
  static constexpr int kStages = kOne ? 1 : kRing;
  static constexpr int kKvA = kKvRows * 128;
  static constexpr int kKvB = kKvRows * Dims<DH>::kB;
  static constexpr int q_a = 0;
  static constexpr int k_a = q_a + W * kRows * 128;  // + stage * kKvA
  static constexpr int v_a = k_a + kStages * kKvA;
  static constexpr int q_b = v_a + kStages * kKvA;
  static constexpr int k_b = q_b + W * kRows * Dims<DH>::kB;  // + stage * kKvB
  static constexpr int v_b = k_b + kStages * kKvB;
  static constexpr int terms = v_b + kStages * kKvB;
  static constexpr int bars = terms + 4 * (kOne ? kOneRows : kMaxS);
  static constexpr int bytes = bars + 8 * (1 + 2 * kRing) + 1024;  // + align slack
};

// box A: dims 0-63 (128-byte swizzle); box B: dims 64-79 (32-byte swizzle)
struct Maps {
  CUtensorMap qa, qb, ka, kb, va, vb;
};

struct VitParams {
  __nv_bfloat16* out;
  long long o_sb, o_ss, o_sh;  // element strides
  const int32_t* valid;        // (B, S) or null
  int S;
  float scale_log2;  // scale * log2(e)
};

// rows s.. of a tensor's map into a box-A and a box-B destination
template <int DH>
__device__ __forceinline__ void load_rows(uint32_t dst_a, uint32_t dst_b, const CUtensorMap* ma,
                                          const CUtensorMap* mb, uint32_t bar, int s, int h,
                                          int b) {
  tma_load(dst_a, ma, bar, 0, s, h, b);
  if constexpr (Dims<DH>::kSplit) tma_load(dst_b, mb, bar, 64, s, h, b);
}

// s (64 x 256) and s8 (64 x 8) = Q.K^T for keys 0-263: q_* this warpgroup's
// rows, k_* the K buffer's
template <int DH>
__device__ __forceinline__ void qk_row_issue(float (&s)[128], float (&s8)[4], uint32_t q_a,
                                             uint32_t q_b, uint32_t k_a, uint32_t k_b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t qd = smem_desc(q_a + kk * 32, 16, 1024);
    wgmma_ss_n256(s, qd, smem_desc(k_a + kk * 32, 16, 1024), kk > 0);
    wgmma_ss_n8(s8, qd, smem_desc(k_a + 256 * 128 + kk * 32, 16, 1024), kk > 0);
  }
  if constexpr (Dims<DH>::kSplit) {
    const uint64_t qd = smem_desc_sw32(q_b, 16, 256);
    wgmma_ss_n256(s, qd, smem_desc_sw32(k_b, 16, 256), 1);
    wgmma_ss_n8(s8, qd, smem_desc_sw32(k_b + 256 * 32, 16, 256), 1);
  }
  wgmma_commit();
}

// s (64 x 128) = Q.K^T for a 128-key tile
template <int DH>
__device__ __forceinline__ void qk_tile_issue(float (&s)[64], uint32_t q_a, uint32_t q_b,
                                              uint32_t k_a, uint32_t k_b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_ss(s, smem_desc(q_a + kk * 32, 16, 1024), smem_desc(k_a + kk * 32, 16, 1024), kk > 0);
  }
  if constexpr (Dims<DH>::kSplit) {
    wgmma_ss(s, smem_desc_sw32(q_b, 16, 256), smem_desc_sw32(k_b, 16, 256), 1);
  }
  wgmma_commit();
}

// o (64 x 64) and o2 (64 x 16, dims 64-79) += P.V over K16 k16 steps of 16
// keys: p the bf16 A fragments, v_* the V buffer (MN-major)
template <int DH, int K16>
__device__ __forceinline__ void pv_issue_vit(float (&o)[32], float (&o2)[8],
                                             const uint32_t (&p)[K16][4], uint32_t v_a,
                                             uint32_t v_b) {
#pragma unroll
  for (int kk = 0; kk < K16; ++kk) {
    wgmma_rs_n64(o, p[kk], smem_desc(v_a + kk * 16 * 128, 1024, 1024));
    if constexpr (Dims<DH>::kSplit) {
      wgmma_rs_n16(o2, p[kk], smem_desc_sw32(v_b + kk * 16 * 32, 256, 256));
    }
  }
  wgmma_commit();
}

// Accumulator layout (m64nNk16, f32): element 4j + 2r + e of a thread is row
// 16w + lane/4 + 8r of the warpgroup's 64, column 8j + 2*(lane%4) + e.

// x = q.k * scale*log2(e) + the key's term, in place, for keys n0 + 8j +
// col + e; returns the thread's max of each of its two rows
template <int N>
__device__ __forceinline__ void scores_log2(float (&s)[N], const float* terms, int n0, int col,
                                            float scale_log2, float (&mx)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float2 t = *reinterpret_cast<const float2*>(terms + n0 + 8 * j + col);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      s[4 * j + 2 * r] = fmaf(s[4 * j + 2 * r], scale_log2, t.x);
      s[4 * j + 2 * r + 1] = fmaf(s[4 * j + 2 * r + 1], scale_log2, t.y);
      mx[r] = fmaxf(mx[r], fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    }
  }
}

// the max of each row over the 4 threads that hold it
__device__ __forceinline__ void quad_max(float (&v)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    v[r] = fmaxf(v[r], __shfl_xor_sync(0xffffffffu, v[r], 1));
    v[r] = fmaxf(v[r], __shfl_xor_sync(0xffffffffu, v[r], 2));
  }
}

__device__ __forceinline__ void quad_sum(float (&v)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    v[r] += __shfl_xor_sync(0xffffffffu, v[r], 1);
    v[r] += __shfl_xor_sync(0xffffffffu, v[r], 2);
  }
}

// exp2(x - m) in place; adds the thread's part of each row's sum to l
template <int N>
__device__ __forceinline__ void exp2_rows(float (&s)[N], const float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[4 * j + i] = ex2(s[4 * j + i] - m[i / 2]);
      l[i / 2] += s[4 * j + i];
    }
}

// the normalised probabilities p * inv_l, rounded to bf16, as the A
// fragments of P.V (m64k16 per 16 keys: the accumulator's pairs, register
// i of a fragment holding row i % 2's)
template <int N, int K16>
__device__ __forceinline__ void normalised_fragments(const float (&s)[N], const float (&inv_l)[2],
                                                     uint32_t (&p)[K16][4]) {
  static_assert(N / 8 <= K16, "a fragment a 16 keys");
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[kk][i] = pack_bf16(s[8 * kk + 2 * i] * inv_l[i % 2], s[8 * kk + 2 * i + 1] * inv_l[i % 2]);
    }
}

// the one-pass row's last fragment: keys 256-263 from the n8 accumulator,
// keys 264-271 zero
__device__ __forceinline__ void tail_fragment(const float (&s8)[4], const float (&inv_l)[2],
                                              uint32_t (&p)[4]) {
  p[0] = pack_bf16(s8[0] * inv_l[0], s8[1] * inv_l[0]);
  p[1] = pack_bf16(s8[2] * inv_l[1], s8[3] * inv_l[1]);
  p[2] = p[3] = 0u;
}

// the output rows in bf16 (P came normalised)
template <int DH>
__device__ __forceinline__ void store_rows(const float (&o)[32], const float (&o2)[8],
                                           const VitParams& p, int row0, int warp, int lane,
                                           int h, int b) {
  const int col = 2 * (lane % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 16 * warp + lane / 4 + 8 * r;
    if (qi >= p.S) continue;
    __nv_bfloat16* row = p.out + b * p.o_sb + static_cast<long long>(qi) * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + col) = __floats2bfloat162_rn(
          o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
    }
#pragma unroll
    for (int j = 0; j < (DH - 64) / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(row + 64 + 8 * j + col) = __floats2bfloat162_rn(
          o2[4 * j + 2 * r], o2[4 * j + 2 * r + 1]);
    }
  }
}

template <int DH, bool kOne>
__global__ void __launch_bounds__(128 * Smem<DH, kOne>::W, 1)
vit_attention_kernel(const __grid_constant__ Maps maps, const VitParams p) {
  using L = Smem<DH, kOne>;
  constexpr int W = L::W;
  constexpr int kRowBytes = Dims<DH>::kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle wants 1024-byte aligned boxes
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  float* const terms = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) + L::terms);
  const uint32_t bar0 = base + L::bars;  // one pass: Q and K; two passes: Q
  // one pass: bar0 + 8 is V's; two passes: stage st's full and empty barriers
  auto full = [&](int st) { return bar0 + 8 * (1 + st); };
  auto empty = [&](int st) { return bar0 + 8 * (1 + kRing + st); };

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * W * kRows;
  const int n_tiles = kOne ? 1 : (p.S + kTileKeys - 1) / kTileKeys;
  const int n_loads = 2 * n_tiles;  // two passes: K tiles, then K and V tiles

  if (threadIdx.x == 0) {
    prefetch_map(&maps.qa);
    prefetch_map(&maps.ka);
    prefetch_map(&maps.va);
    if constexpr (Dims<DH>::kSplit) {
      prefetch_map(&maps.qb);
      prefetch_map(&maps.kb);
      prefetch_map(&maps.vb);
    }
    for (int i = 0; i < 1 + 2 * kRing; ++i) mbar_init(bar0 + 8 * i, i > kRing ? 4 * W : 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // each key's term of its log2 score: 0 counts, -FLT_MAX masked, -inf past S
  const int32_t* valid_b = p.valid != nullptr ? p.valid + static_cast<long long>(b) * p.S : nullptr;
  const int n_keys = kOne ? kOneRows : n_tiles * kTileKeys;
  for (int i = threadIdx.x; i < n_keys; i += blockDim.x) {
    terms[i] = i >= p.S ? -INFINITY : (valid_b == nullptr || valid_b[i] != 0 ? 0.f : -FLT_MAX);
  }
  __syncthreads();

  // two passes: load i is K tile i (pass 1), or K and V of tile i - n_tiles
  auto issue_load = [&](int i) {
    const int st = i % kRing;
    const bool with_v = i >= n_tiles;
    const int s0 = (with_v ? i - n_tiles : i) * kTileKeys;
    mbar_expect_tx(full(st), kTileKeys * kRowBytes * (with_v ? 2 : 1));
    load_rows<DH>(base + L::k_a + st * L::kKvA, base + L::k_b + st * L::kKvB, &maps.ka, &maps.kb,
                  full(st), s0, h, b);
    if (with_v) {
      load_rows<DH>(base + L::v_a + st * L::kKvA, base + L::v_b + st * L::kKvB, &maps.va,
                    &maps.vb, full(st), s0, h, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar0, W * kRows * kRowBytes + (kOne ? kOneRows * kRowBytes : 0));
    for (int wg = 0; wg < W; ++wg) {
      load_rows<DH>(base + L::q_a + wg * kRows * 128, base + L::q_b + wg * kRows * Dims<DH>::kB,
                    &maps.qa, &maps.qb, bar0, m0 + wg * kRows, h, b);
    }
    if constexpr (kOne) {
      for (int box = 0; box < 2; ++box) {
        load_rows<DH>(base + L::k_a + box * kOneBox * 128,
                      base + L::k_b + box * kOneBox * Dims<DH>::kB, &maps.ka, &maps.kb, bar0,
                      box * kOneBox, h, b);
      }
      mbar_expect_tx(bar0 + 8, kOneRows * kRowBytes);
      for (int box = 0; box < 2; ++box) {
        load_rows<DH>(base + L::v_a + box * kOneBox * 128,
                      base + L::v_b + box * kOneBox * Dims<DH>::kB, &maps.va, &maps.vb,
                      bar0 + 8, box * kOneBox, h, b);
      }
    } else {
      for (int i = 0; i < min(kRing, n_loads); ++i) issue_load(i);
    }
  }

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int col = 2 * (lane % 4);
  const int row0 = m0 + wg * kRows;
  const uint32_t q_a = base + L::q_a + wg * kRows * 128;
  const uint32_t q_b = base + L::q_b + wg * kRows * Dims<DH>::kB;
  float o[32], o2[8];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) o2[i] = 0.f;

  if constexpr (kOne) {
    float s[128], s8[4];
#pragma unroll
    for (int i = 0; i < 128; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) s8[i] = 0.f;
    mbar_wait(bar0, 0);
    fence_regs(s);
    fence_regs(s8);
    wgmma_fence();
    qk_row_issue<DH>(s, s8, q_a, q_b, base + L::k_a, base + L::k_b);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(s8);
    // the exact max and sum of each row from the registers
    float m[2] = {-INFINITY, -INFINITY};
    scores_log2(s, terms, 0, col, p.scale_log2, m);
    scores_log2(s8, terms, 256, col, p.scale_log2, m);
    quad_max(m);
    float l[2] = {0.f, 0.f};
    exp2_rows(s, m, l);
    exp2_rows(s8, m, l);
    quad_sum(l);
    // the rounding point: P normalised, then rounded; the output as P.V leaves it
    const float p_scale[2] = {1.f / l[0], 1.f / l[1]};
    uint32_t pf[17][4];
    normalised_fragments(s, p_scale, pf);
    tail_fragment(s8, p_scale, pf[16]);
    mbar_wait(bar0 + 8, 0);
    fence_regs(o);
    fence_regs(o2);
    fence_regs(pf);
    wgmma_fence();
    pv_issue_vit<DH, 17>(o, o2, pf, base + L::v_a, base + L::v_b);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(o2);
  } else {
    // the stage of load i is released by every warp; thread 0 then refills it
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(i % kRing));
      if (threadIdx.x == 0 && i + kRing < n_loads) {
        mbar_wait(empty(i % kRing), (i / kRing) & 1);
        issue_load(i + kRing);
      }
      __syncwarp();
    };
    mbar_wait(bar0, 0);
    float s[64];
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    // pass 1: each row's max and sum, online over the key tiles (key 0 is
    // inside S, so m is finite after the first tile)
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kRing;
      mbar_wait(full(st), (t / kRing) & 1);
      fence_regs(s);
      wgmma_fence();
      qk_tile_issue<DH>(s, q_a, q_b, base + L::k_a + st * L::kKvA, base + L::k_b + st * L::kKvB);
      wgmma_wait<0>();
      fence_regs(s);
      release(t);
      float mx[2] = {-INFINITY, -INFINITY};
      scores_log2(s, terms, t * kTileKeys, col, p.scale_log2, mx);
      quad_max(mx);
      const float m_new[2] = {fmaxf(m[0], mx[0]), fmaxf(m[1], mx[1])};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] *= ex2(m[r] - m_new[r]);
        m[r] = m_new[r];
      }
      exp2_rows(s, m, l);
    }
    quad_sum(l);
    const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
    // pass 2: the scores again, normalised and rounded, then P.V
    for (int t = 0; t < n_tiles; ++t) {
      const int i = n_tiles + t;
      const int st = i % kRing;
      mbar_wait(full(st), (i / kRing) & 1);
      fence_regs(s);
      wgmma_fence();
      qk_tile_issue<DH>(s, q_a, q_b, base + L::k_a + st * L::kKvA, base + L::k_b + st * L::kKvB);
      wgmma_wait<0>();
      fence_regs(s);
      float unused[2] = {-INFINITY, -INFINITY};
      scores_log2(s, terms, t * kTileKeys, col, p.scale_log2, unused);
      float l_unused[2] = {0.f, 0.f};
      exp2_rows(s, m, l_unused);
      uint32_t pf[8][4];
      normalised_fragments(s, inv_l, pf);
      fence_regs(o);
      fence_regs(o2);
      fence_regs(pf);
      wgmma_fence();
      pv_issue_vit<DH, 8>(o, o2, pf, base + L::v_a + st * L::kKvA, base + L::v_b + st * L::kKvB);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(o2);
      release(i);
    }
  }
  store_rows<DH>(o, o2, p, row0, warp, lane, h, b);
}

// One warpgroup, the one-pass schedule's two products on one head, through
// the same loads, descriptors and wgmma calls: s = Q.K^T (64 x 264, the
// n256 + n8 split) and o = bf16(s).V (64 x DH over 17 k16 steps, keys
// 264-271 zero), both f32 row-major.  The card test holds them against
// torch.matmul.
template <int DH>
__global__ void __launch_bounds__(128)
vit_tile_check_kernel(const __grid_constant__ Maps maps, float* s_out, float* o_out) {
  using L = Smem<DH, true>;
  constexpr int kRowBytes = Dims<DH>::kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + L::bars;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, (kRows + 2 * kOneRows) * kRowBytes);
    load_rows<DH>(base + L::q_a, base + L::q_b, &maps.qa, &maps.qb, bar, 0, 0, 0);
    for (int box = 0; box < 2; ++box) {
      load_rows<DH>(base + L::k_a + box * kOneBox * 128,
                    base + L::k_b + box * kOneBox * Dims<DH>::kB, &maps.ka, &maps.kb, bar,
                    box * kOneBox, 0, 0);
      load_rows<DH>(base + L::v_a + box * kOneBox * 128,
                    base + L::v_b + box * kOneBox * Dims<DH>::kB, &maps.va, &maps.vb, bar,
                    box * kOneBox, 0, 0);
    }
  }
  mbar_wait(bar, 0);
  float s[128], s8[4], o[32], o2[8];
#pragma unroll
  for (int i = 0; i < 128; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) s8[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) o2[i] = 0.f;
  fence_regs(s);
  fence_regs(s8);
  wgmma_fence();
  qk_row_issue<DH>(s, s8, base + L::q_a, base + L::q_b, base + L::k_a, base + L::k_b);
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(s8);
  const float one[2] = {1.f, 1.f};
  uint32_t pf[17][4];
  normalised_fragments(s, one, pf);
  tail_fragment(s8, one, pf[16]);
  fence_regs(o);
  fence_regs(o2);
  fence_regs(pf);
  wgmma_fence();
  pv_issue_vit<DH, 17>(o, o2, pf, base + L::v_a, base + L::v_b);
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(o2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 16 * warp + lane / 4 + 8 * (i / 2);
    const int c = 2 * (lane % 4) + (i & 1);
#pragma unroll
    for (int j = 0; j < 32; ++j) s_out[row * kOneKeys + 8 * j + c] = s[4 * j + i];
    s_out[row * kOneKeys + 256 + c] = s8[i];
#pragma unroll
    for (int j = 0; j < 8; ++j) o_out[row * DH + 8 * j + c] = o[4 * j + i];
#pragma unroll
    for (int j = 0; j < (DH - 64) / 8; ++j) o_out[row * DH + 64 + 8 * j + c] = o2[4 * j + i];
  }
}

// a (B, S, H, DH) tensor's two maps, in boxes of `rows` rows
template <int DH>
bool make_maps(CUtensorMap* a, CUtensorMap* b, const void* ptr, int rows, int B, int S, int H,
               long long sb, long long ss, long long sh) {
  if (!make_map(a, ptr, DH, 64, rows, CU_TENSOR_MAP_SWIZZLE_128B, B, S, H, sb, ss, sh)) {
    return false;
  }
  return !Dims<DH>::kSplit ||
         make_map(b, ptr, DH, 16, rows, CU_TENSOR_MAP_SWIZZLE_32B, B, S, H, sb, ss, sh);
}

template <int DH, bool kOne>
int launch(const void* q, const void* k, const void* v, const void* valid, void* out, int B,
           int S, int H, const long long (&st)[12], float scale, cudaStream_t stream) {
  using L = Smem<DH, kOne>;
  constexpr int W = L::W;
  Maps m{};
  const int kv_rows = kOne ? kOneBox : kTileKeys;
  if (!make_maps<DH>(&m.qa, &m.qb, q, kRows, B, S, H, st[0], st[1], st[2]) ||
      !make_maps<DH>(&m.ka, &m.kb, k, kv_rows, B, S, H, st[3], st[4], st[5]) ||
      !make_maps<DH>(&m.va, &m.vb, v, kv_rows, B, S, H, st[6], st[7], st[8])) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = vit_attention_kernel<DH, kOne>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const VitParams p{static_cast<__nv_bfloat16*>(out), st[9], st[10], st[11],
                    static_cast<const int32_t*>(valid), S, scale * kLog2e};
  const dim3 grid((S + W * kRows - 1) / (W * kRows), H, B);
  kernel<<<grid, 128 * W, L::bytes, stream>>>(m, p);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_dh(const void* q, const void* k, const void* v, const void* valid, void* out, int B,
              int S, int H, const long long (&st)[12], float scale, cudaStream_t stream) {
  // one pass: a warpgroup a block (two blocks an SM); two passes: two
  // warpgroups share the K/V ring (its 136 KB leave one block an SM)
  if (S <= kOneKeys) return launch<DH, true>(q, k, v, valid, out, B, S, H, st, scale, stream);
  return launch<DH, false>(q, k, v, valid, out, B, S, H, st, scale, stream);
}

template <int DH>
int tile_check(const void* q, const void* k, const void* v, void* s_out, void* o_out,
               cudaStream_t stream) {
  using L = Smem<DH, true>;
  Maps m{};
  if (!make_maps<DH>(&m.qa, &m.qb, q, kRows, 1, kRows, 1, 0, DH, 0) ||
      !make_maps<DH>(&m.ka, &m.kb, k, kOneBox, 1, kOneKeys, 1, 0, DH, 0) ||
      !make_maps<DH>(&m.va, &m.vb, v, kOneBox, 1, kOneKeys, 1, 0, DH, 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      vit_tile_check_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  vit_tile_check_kernel<DH><<<1, 128, L::bytes, stream>>>(m, static_cast<float*>(s_out),
                                                          static_cast<float*>(o_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Strides are in elements; valid
// may be null (every key real).  Launches on `stream`, does not synchronise,
// allocates nothing, and returns a cudaError_t so a refused launch or tensor
// map is reported to the caller; a head dim it was not built for, or S past
// the gate's 1024, returns cudaErrorInvalidValue without launching.
extern "C" int vit_attention_bf16(
    const void* q, const void* k, const void* v, const void* valid, void* out,
    int B, int S, int H, int DH, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale, void* stream) {
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (S < 1 || S > kMaxS) return static_cast<int>(cudaErrorInvalidValue);
  switch (DH) {
    case 64: return launch_dh<64>(q, k, v, valid, out, B, S, H, st, scale, cs);
    case 72: return launch_dh<72>(q, k, v, valid, out, B, S, H, st, scale, cs);
    case 80: return launch_dh<80>(q, k, v, valid, out, B, S, H, st, scale, cs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The one-pass products on one head, for the card test: q (64, DH), k and v
// (264, DH) contiguous bf16; s_out = q.k^T (64, 264) and o_out =
// bf16(s_out).v (64, DH), f32 each.
extern "C" int vit_tile_check(const void* q, const void* k, const void* v, void* s_out,
                              void* o_out, int DH, void* stream) {
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (DH) {
    case 64: return tile_check<64>(q, k, v, s_out, o_out, cs);
    case 72: return tile_check<72>(q, k, v, s_out, o_out, cs);
    case 80: return tile_check<80>(q, k, v, s_out, o_out, cs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
