// Causal flash-attention backward for Hopper (sm_90a): dq, dk, dv in bf16,
// on csrc/flash_fwd_sm90.cuh's primitives (TMA loads into mbarrier rings,
// wgmma from shared memory and from registers, a producer warpgroup that
// gives its registers to two consumer warpgroups).
//
// Replaces: the upstream Pallas TPU backward that
// licv_vqa_tpu/models/layers.py::flash_attention_tpu reaches under autograd
// (jax.experimental.pallas.ops.tpu.flash_attention: _flash_attention_bwd,
// which computes di = sum(o * do), then _flash_attention_bwd_dkv and
// _flash_attention_bwd_dq), with causal=True and segment ids valid + 1.
//
// Semantics: the forward's rule (csrc/flash_attn_fwd.cu): key k is visible
// to query q iff k <= q and valid[k] == valid[q].  With the forward's
// per-row log-sum-exp of the scaled scores (lse = m + log l):
//   P = exp(scale q.k - lse) on the visible pairs, 0 elsewhere
//   D = rowsum(do * o)        (o: the bf16 output the forward returned)
//   dV = P^T do,  dS = P * (do v^T - D),  dK = scale dS^T q,  dQ = scale dS k
// P and dS are rounded to bf16 as the A operands of the gradient products
// (f32 accumulation): the forward's rounding of P, carried over.
//
// Layout: q/k/v are (B, S, H, 128) addressed through element strides for
// b, s and h (head dim contiguous), as the forward takes them; o, do, dq,
// dk and dv are contiguous (B, S, H, 128); lse is a contiguous (B, H, S)
// f32; valid is a contiguous (B, S) int32.  `stats` is a scratch of
// (B, H, ceil(S / 64), 3, 64) f32 that the dQ kernel fills for the dK/dV
// kernel: per 64-query tile, the rows' lse * log2(e), D and validity.
//
// What bounds it on the H100: five products over the visible pairs (4 * 128
// operations a pair for the two score products, 6 * 128 for the three
// gradient products) against q, k, v, o, do read and dq, dk, dv written
// once: bound by the tensor cores from S of a few hundred up.  The design:
//
// - Deterministic, with no atomics, as upstream's split: two kernels on one
//   stream.  The price is that the dQ kernel computes S = Q.K^T and
//   dP = dO.V^T again (seven products where five would do).
// - flash_bwd_dq_kernel: one block per (128-query tile, head, batch row),
//   the longest tiles of the whole grid first (a 1-D grid, the tile rank
//   slowest: at (4,256,32,128) the 128 long blocks fill the first wave and
//   the short ones the second); two consumer warpgroups of 64 queries and a
//   producer warpgroup (setmaxnreg 24 / 240, as the forward).  Prologue: D
//   = rowsum(dO o) from the bf16 rows and the lse in base 2 (converted
//   once, here), written to `stats` with the rows' validity.  Then over the
//   64-key tiles up to the causal bound (K and V through a 3-stage TMA
//   ring): S = Q.K^T and dP = dO.V^T (wgmma m64n64k16, both operands K-major
//   in shared memory), P = exp2(S scale log2(e) - lse2) on the visible
//   pairs, dS = P (dP - D), dQ += dS.K (m64n128k16, dS from registers as
//   bf16, K an MN-major B), waited for under the next tile's scores.
//   Epilogue: dQ * scale.
// - flash_bwd_dkdv_kernel, launched after it: one block per (128-key tile,
//   head, batch row), 64 keys a consumer warpgroup, dK and dV (2 x 64 f32
//   a thread) in registers.  Over the 64-query tiles from the diagonal to S
//   (Q, dO and the tile's stats through the ring): S^T = K.Q^T and
//   dP^T = V.dO^T (m64n64k16), P^T and dS^T with lse2 and D from shared
//   memory, dV += P^T.dO (issued before dP^T is waited for, so it runs
//   while dS^T is formed) and dK += dS^T.Q (m64n128k16, A from registers,
//   B MN-major); the longest tiles first, as the dQ kernel.  Epilogue:
//   dK * scale.  About 192 accumulator registers a consumer thread of the
//   240.
// - The element mask runs only on tiles that need it: the diagonal tiles
//   and tiles whose keys' validity differs from the warp's rows' (a warp's
//   vote, as the forward's).
// - 128-byte swizzle: a 64-row tile is two 64-dim TMA boxes of 8 KB; the
//   wgmma descriptors name the same swizzle (K-major: rows 128 bytes apart,
//   8-row groups 1024; MN-major: the next 64 dims a box away).
#include "flash_fwd_sm90.cuh"

namespace {

using namespace flash_sm90;

constexpr int kRows = 64;               // rows of a tile
constexpr int kHalf64 = kRows * 64 * 2;  // one 64-dim half of a 64-row tile: 8 KB
constexpr int kTile64 = 2 * kHalf64;     // 16 KB
constexpr int kBwdStages = 3;
constexpr int kStatFloats = 3 * kRows;   // a 64-query tile's lse2, D and validity
constexpr int kStatBytes = 4 * kStatFloats;
// the dQ kernel: Q and dO (128 rows each), the K and V rings, barriers
constexpr int kDqBars = 4 * kTile64 + 2 * kBwdStages * kTile64;
constexpr int kDqSmem = kDqBars + 8 * (1 + 2 * kBwdStages) + 1024;
// the dK/dV kernel: K and V (128 rows each), the Q, dO and stats rings, barriers
constexpr int kKvBars = 4 * kTile64 + kBwdStages * (2 * kTile64 + kStatBytes);
constexpr int kKvSmem = kKvBars + 8 * (1 + 2 * kBwdStages) + 1024;

struct BwdParams {
  const __nv_bfloat16* o;     // (B, S, H, 128) contiguous
  const __nv_bfloat16* dout;  // the same
  const float* lse;           // (B, H, S), natural log
  const int32_t* valid;       // (B, S)
  __nv_bfloat16 *dq, *dk, *dv;
  float* stats;  // (B, H, ceil(S / 64), 3, 64)
  int B, S, H;
  float scale, scale_log2;
};

// A block's (tile rank, head, batch row) on the 1-D grid: every (head,
// batch row) of one tile rank before the next rank, so that the longest
// tiles of the whole grid go first and the short ones fill the last wave
struct BlockTile {
  int rank, h, b;
};
__device__ __forceinline__ BlockTile block_tile(const BwdParams& p) {
  const int bh = blockIdx.x % (p.B * p.H);
  return {static_cast<int>(blockIdx.x) / (p.B * p.H), bh % p.H, bh / p.H};
}

// the forward's rule; a validity of -1 or -2 marks a row past S
__device__ __forceinline__ bool visible(int kj, int qi, int seg_k, int seg_q) {
  return kj <= qi && seg_k == seg_q;
}

// a 64-row tile's two 64-dim halves
__device__ __forceinline__ void load_tile64(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int s, int h, int b) {
  tma_load(dst, map, bar, 0, s, h, b);
  tma_load(dst + kHalf64, map, bar, 64, s, h, b);
}

// acc (64 x 64, f32) = A.B^T over 128 dims: a and b 64-row tiles, K-major
__device__ __forceinline__ void ss64_issue(float (&acc)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t off = (kk / 4) * kHalf64 + (kk % 4) * 32;
    wgmma_ss_n64(acc, smem_desc(a + off, 16, 1024), smem_desc(b + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// acc (64 x 128, f32) += F.T: f = 64 columns as bf16 A fragments (16 a
// step), t = a 64-row tile as an MN-major B (its rows the product's K)
__device__ __forceinline__ void rs128(float (&acc)[64], const uint32_t (&f)[4][4], uint32_t t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, f[kk], smem_desc(t + kk * 16 * 128, kHalf64, 1024));
}

// the A fragments (m64k16 per 16 columns) of a 64 x 64 accumulator, bf16
__device__ __forceinline__ void fragments64(const float (&x)[32], uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) f[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// A 64 x 128 accumulator's rows to a contiguous (B, S, H, 128) bf16 tensor,
// times `mul`: rows[r] is the thread's row r (16w + lane/4 + 8r), stored
// where it lies inside S
__device__ __forceinline__ void store_rows(__nv_bfloat16* t, const float (&acc)[64],
                                           const int (&rows)[2], int b, int h, int S, int H,
                                           float mul) {
  const int col = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= S) continue;
    __nv_bfloat16* row = t + ((static_cast<long long>(b) * S + rows[r]) * H + h) * 128;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + col) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
    }
  }
}

__device__ __forceinline__ void init_barriers(uint32_t full0, uint32_t full, uint32_t empty) {
  mbar_init(full0, 1);
  for (int st = 0; st < kBwdStages; ++st) {
    mbar_init(full + 8 * st, 1);
    mbar_init(empty + 8 * st, kConsumerWarps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                   // 128 rows: two 64-row tiles
  const uint32_t do_s = base + 2 * kTile64;
  const uint32_t k_s = base + 4 * kTile64;     // + st * kTile64
  const uint32_t v_s = k_s + kBwdStages * kTile64;
  const uint32_t qdo_full = base + kDqBars;
  const uint32_t full = qdo_full + 8;          // K and V of a stage
  const uint32_t empty = full + 8 * kBwdStages;

  const BlockTile bt = block_tile(p);
  const int h = bt.h, b = bt.b;
  const int qt = (p.S + 2 * kRows - 1) / (2 * kRows) - 1 - bt.rank;  // the longest first
  const int m0 = qt * 2 * kRows;
  // the causal bound: no key past the tile's last query is visible
  const int n_tiles = (min(p.S, m0 + 2 * kRows) + kRows - 1) / kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) init_barriers(qdo_full, full, empty);
  __syncthreads();

  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(qdo_full, 4 * kTile64);
      for (int i = 0; i < 2; ++i) {
        load_tile64(q_s + i * kTile64, &tq, qdo_full, m0 + i * kRows, h, b);
        load_tile64(do_s + i * kTile64, &tdo, qdo_full, m0 + i * kRows, h, b);
      }
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % kBwdStages;
        mbar_wait(empty + 8 * st, ((n / kBwdStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, 2 * kTile64);
        load_tile64(k_s + st * kTile64, &tk, full + 8 * st, n * kRows, h, b);
        load_tile64(v_s + st * kTile64, &tv, full + 8 * st, n * kRows, h, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int wg = warp / 4;
    const int lo = m0 + 64 * wg + 16 * (warp % 4);  // the warp's first query
    const int col = 2 * (lane % 4);
    const long long bh = static_cast<long long>(b) * p.H + h;
    const int32_t* valid_b = p.valid + static_cast<long long>(b) * p.S;

    // Prologue: the warp's 16 rows' D, lse in base 2 and validity, two lanes
    // a row (64 dims each), to `stats` and to the threads that hold the rows
    float d_own[2], lse_own[2];
    int vq[2], qrow[2];
    {
      const int qi = lo + lane / 2;
      const bool in = qi < p.S;
      float d = 0.f;
      if (in) {
        const long long off = ((static_cast<long long>(b) * p.S + qi) * p.H + h) * 128 +
                              64 * (lane % 2);
        const uint4* o4 = reinterpret_cast<const uint4*>(p.o + off);
        const uint4* do4 = reinterpret_cast<const uint4*>(p.dout + off);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const uint4 a = o4[i], g = do4[i];
          const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
          const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 x = __bfloat1622float2(a2[e]), y = __bfloat1622float2(g2[e]);
            d = fmaf(x.x, y.x, fmaf(x.y, y.y, d));
          }
        }
      }
      const float d_row = d + __shfl_xor_sync(0xffffffffu, d, 1);  // D = rowsum(do * o)
      const float lse2 = in ? p.lse[bh * p.S + qi] * kLog2e : 0.f;  // base 2, once
      const int v = in ? valid_b[qi] : -1;
      const int n_q64 = (p.S + kRows - 1) / kRows;
      if (lane % 2 == 0 && qi < n_q64 * kRows) {
        float* st = p.stats + (bh * n_q64 + qi / kRows) * kStatFloats + qi % kRows;
        st[0] = lse2;
        st[kRows] = d_row;
        st[2 * kRows] = __int_as_float(v);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int src = 2 * (lane / 4 + 8 * r);
        d_own[r] = __shfl_sync(0xffffffffu, d_row, src);
        lse_own[r] = __shfl_sync(0xffffffffu, lse2, src);
        vq[r] = __shfl_sync(0xffffffffu, v, src);
        qrow[r] = lo + lane / 4 + 8 * r;
      }
    }
    const int valid_warp = __shfl_sync(0xffffffffu, vq[0], 0);
    const bool alike =
        __all_sync(0xffffffffu, vq[0] == valid_warp && vq[1] == valid_warp);
    const uint32_t q_wg = q_s + wg * kTile64;
    const uint32_t do_wg = do_s + wg * kTile64;

    float dq[64], s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    uint32_t dsf[4][4];
    mbar_wait(qdo_full, 0);
    for (int n = 0; n < n_tiles; ++n) {
      const int st = n % kBwdStages;
      const int n0 = n * kRows;
      int kv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kj = n0 + 32 * i + lane;
        kv[i] = kj < p.S ? valid_b[kj] : -2;
      }
      mbar_wait(full + 8 * st, (n / kBwdStages) & 1);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      ss64_issue(s, q_wg, k_s + st * kTile64);
      ss64_issue(dp, do_wg, v_s + st * kTile64);
      wgmma_wait<1>();  // the scores, and the previous tile's dQ product
      fence_regs(s);
      fence_regs(dq);
      if (n > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * ((n - 1) % kBwdStages));  // its K and V read
      }
      const bool diag = n0 + kRows - 1 > lo;  // a key past one of the warp's queries
      const bool clean =
          !diag && alike && __all_sync(0xffffffffu, kv[0] == valid_warp && kv[1] == valid_warp);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // key 8j + col + e of the tile is kv[j / 4] of lane 8(j % 4) + col + e
          const int vk = clean ? 0 : __shfl_sync(0xffffffffu, kv[j / 4], 8 * (j % 4) + col + e);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float& x = s[4 * j + 2 * r + e];
            const bool seen = clean || visible(n0 + 8 * j + col + e, qrow[r], vk, vq[r]);
            x = seen ? ex2(fmaf(x, p.scale_log2, -lse_own[r])) : 0.f;
          }
        }
      wgmma_wait<0>();  // dP
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - d_own[(i % 4) / 2]);
      fragments64(dp, dsf);
      fence_regs(dsf);
      fence_regs(dq);
      wgmma_fence();
      rs128(dq, dsf, k_s + st * kTile64);  // waited for under the next tile's scores
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dq);
    store_rows(p.dq, dq, qrow, b, h, p.S, p.H, p.scale);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, const BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const float* const base_ptr =
      reinterpret_cast<const float*>(smem_raw + (base - smem_u32(smem_raw)));
  const uint32_t k_s = base;                   // 128 rows: two 64-row tiles
  const uint32_t v_s = base + 2 * kTile64;
  const uint32_t q_s = base + 4 * kTile64;     // + st * kTile64
  const uint32_t do_s = q_s + kBwdStages * kTile64;
  const uint32_t stat_s = do_s + kBwdStages * kTile64;  // + st * kStatBytes
  const uint32_t kv_full = base + kKvBars;
  const uint32_t full = kv_full + 8;           // Q, dO and stats of a stage
  const uint32_t empty = full + 8 * kBwdStages;

  const BlockTile bt = block_tile(p);
  const int h = bt.h, b = bt.b;
  const int n0 = bt.rank * 2 * kRows;  // the longest first: the first key tile sees every query
  // the causal bound: no query before the tile's first key sees it
  const int n_tiles = (p.S - n0 + kRows - 1) / kRows;
  const int n_q64 = (p.S + kRows - 1) / kRows;
  const long long bh = static_cast<long long>(b) * p.H + h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) init_barriers(kv_full, full, empty);
  __syncthreads();

  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(kv_full, 4 * kTile64);
      for (int i = 0; i < 2; ++i) {
        load_tile64(k_s + i * kTile64, &tk, kv_full, n0 + i * kRows, h, b);
        load_tile64(v_s + i * kTile64, &tv, kv_full, n0 + i * kRows, h, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kBwdStages;
        const int q0 = n0 + t * kRows;
        mbar_wait(empty + 8 * st, ((t / kBwdStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, 2 * kTile64 + kStatBytes);
        load_tile64(q_s + st * kTile64, &tq, full + 8 * st, q0, h, b);
        load_tile64(do_s + st * kTile64, &tdo, full + 8 * st, q0, h, b);
        bulk_load(stat_s + st * kStatBytes, p.stats + (bh * n_q64 + q0 / kRows) * kStatFloats,
                  kStatBytes, full + 8 * st);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int wg = warp / 4;
    const int klo = n0 + 64 * wg + 16 * (warp % 4);  // the warp's first key
    const int col = 2 * (lane % 4);
    const int32_t* valid_b = p.valid + static_cast<long long>(b) * p.S;
    int krow[2], vk[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      krow[r] = klo + lane / 4 + 8 * r;
      vk[r] = krow[r] < p.S ? valid_b[krow[r]] : -2;
    }
    const int valid_warp = __shfl_sync(0xffffffffu, vk[0], 0);
    const bool alike =
        __all_sync(0xffffffffu, vk[0] == valid_warp && vk[1] == valid_warp);
    const uint32_t k_wg = k_s + wg * kTile64;
    const uint32_t v_wg = v_s + wg * kTile64;

    float dk[64], dv[64], s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    uint32_t pf[4][4], dsf[4][4];
    mbar_wait(kv_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kBwdStages;
      const int q0 = n0 + t * kRows;
      const float* lse_s = base_ptr + (stat_s - base + st * kStatBytes) / 4;
      const float* d_s = lse_s + kRows;
      const int* vq_s = reinterpret_cast<const int*>(lse_s + 2 * kRows);
      mbar_wait(full + 8 * st, (t / kBwdStages) & 1);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      ss64_issue(s, k_wg, q_s + st * kTile64);
      ss64_issue(dp, v_wg, do_s + st * kTile64);
      wgmma_wait<1>();  // the scores
      fence_regs(s);
      const bool diag = q0 < klo + 15;  // a query before one of the warp's keys
      const bool clean = !diag && alike &&
                         __all_sync(0xffffffffu, vq_s[lane] == valid_warp &&
                                                     vq_s[lane + 32] == valid_warp);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + col + e;  // the query q0 + c
          const float lse2 = lse_s[c];
          const int vq = vq_s[c];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float& x = s[4 * j + 2 * r + e];
            const bool seen = clean || visible(krow[r], q0 + c, vk[r], vq);
            x = seen ? ex2(fmaf(x, p.scale_log2, -lse2)) : 0.f;
          }
        }
      // dV += P^T.dO runs while dS^T is formed
      fragments64(s, pf);
      fence_regs(pf);
      fence_regs(dv);
      wgmma_fence();
      rs128(dv, pf, do_s + st * kTile64);
      wgmma_commit();
      wgmma_wait<1>();  // dP^T
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = d_s[8 * j + col + e];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * j + 2 * r + e;
            dp[i] = s[i] * (dp[i] - d);
          }
        }
      fragments64(dp, dsf);
      fence_regs(dsf);
      fence_regs(dk);
      wgmma_fence();
      rs128(dk, dsf, q_s + st * kTile64);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);  // Q, dO and stats of the stage read
    }
    store_rows(p.dk, dk, krow, b, h, p.S, p.H, p.scale);
    store_rows(p.dv, dv, krow, b, h, p.S, p.H, 1.f);
  }
}

// the 4-D map of a (B, S, H, 128) tensor in boxes of 64 dims by 64 rows
bool make_map64(CUtensorMap* map, const void* ptr, int B, int S, int H, long long sb,
                long long ss, long long sh) {
  return make_map(map, ptr, kHeadDim, 64, kRows, CU_TENSOR_MAP_SWIZZLE_128B, B, S, H, sb, ss, sh);
}

// One warpgroup, one tile of each product layout at the kernels' shapes,
// through the same loads, descriptors and wgmma calls: s = A.B^T (64 x 64,
// both K-major) and o = bf16(s).C (64 x 128, C MN-major), f32 row-major.
// The card test holds them against torch.matmul.
__global__ void __launch_bounds__(128)
bwd_tile_check_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                      const __grid_constant__ CUtensorMap tc, float* s_out, float* o_out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + 3 * kTile64;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, 3 * kTile64);
    load_tile64(base, &ta, bar, 0, 0, 0);
    load_tile64(base + kTile64, &tb, bar, 0, 0, 0);
    load_tile64(base + 2 * kTile64, &tc, bar, 0, 0, 0);
  }
  mbar_wait(bar, 0);
  float s[32], o[64];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  fence_regs(s);
  wgmma_fence();
  ss64_issue(s, base, base + kTile64);
  wgmma_wait<0>();
  fence_regs(s);
  uint32_t f[4][4];
  fragments64(s, f);
  fence_regs(f);
  fence_regs(o);
  wgmma_fence();
  rs128(o, f, base + 2 * kTile64);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 16 * warp + lane / 4 + 8 * (i / 2);
    const int c = 2 * (lane % 4) + (i & 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) s_out[row * 64 + 8 * j + c] = s[4 * j + i];
#pragma unroll
    for (int j = 0; j < 16; ++j) o_out[row * 128 + 8 * j + c] = o[4 * j + i];
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Strides (of q, k, v) are in
// elements.  `stats` is the scratch of (B, H, ceil(S / 64), 3, 64) f32.
// Launches the dQ kernel, which also fills the scratch, then the dK/dV
// kernel, on `stream`; does not synchronise, allocates nothing, and
// returns the first error (a refused tensor map is cudaErrorInvalidValue,
// a build at another entry register count cudaErrorInvalidConfiguration)
// so a refused launch is reported to the caller.
extern "C" int flash_attn_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* valid, void* dq, void* dk,
    void* dv, void* stats, int B, int S, int H, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, float scale,
    void* stream) {
  CUtensorMap tq, tk, tv, tdo;
  const long long ss = static_cast<long long>(H) * kHeadDim;
  if (!make_map64(&tq, q, B, S, H, q_sb, q_ss, q_sh) ||
      !make_map64(&tk, k, B, S, H, k_sb, k_ss, k_sh) ||
      !make_map64(&tv, v, B, S, H, v_sb, v_ss, v_sh) ||
      !make_map64(&tdo, dout, B, S, H, S * ss, ss, kHeadDim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = prepare(flash_bwd_dq_kernel, kDqSmem);
  if (err == cudaSuccess) err = prepare(flash_bwd_dkdv_kernel, kKvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdParams p{static_cast<const __nv_bfloat16*>(o),
                    static_cast<const __nv_bfloat16*>(dout),
                    static_cast<const float*>(lse),
                    static_cast<const int32_t*>(valid),
                    static_cast<__nv_bfloat16*>(dq),
                    static_cast<__nv_bfloat16*>(dk),
                    static_cast<__nv_bfloat16*>(dv),
                    static_cast<float*>(stats),
                    B, S, H, scale, scale * kLog2e};
  const dim3 grid((S + 2 * kRows - 1) / (2 * kRows) * H * B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  flash_bwd_dq_kernel<<<grid, kThreads, kDqSmem, st>>>(tq, tk, tv, tdo, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<<<grid, kThreads, kKvSmem, st>>>(tq, tk, tv, tdo, p);
  return static_cast<int>(cudaGetLastError());
}

// The kernels' two product layouts on one tile, for the card test: a, b
// and c (64, 128) contiguous bf16; s_out = a.b^T (64, 64) and o_out =
// bf16(s_out).c (64, 128), f32 each.
extern "C" int flash_bwd_sm90_tile_check(const void* a, const void* b, const void* c, void* s_out,
                                         void* o_out, void* stream) {
  CUtensorMap ta, tb, tc;
  if (!make_map64(&ta, a, 1, kRows, 1, 0, kHeadDim, 0) ||
      !make_map64(&tb, b, 1, kRows, 1, 0, kHeadDim, 0) ||
      !make_map64(&tc, c, 1, kRows, 1, 0, kHeadDim, 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = 3 * kTile64 + 8 + 1024;
  const cudaError_t attr = cudaFuncSetAttribute(
      bwd_tile_check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  bwd_tile_check_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      ta, tb, tc, static_cast<float*>(s_out), static_cast<float*>(o_out));
  return static_cast<int>(cudaGetLastError());
}
