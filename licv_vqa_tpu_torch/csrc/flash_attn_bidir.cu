// Bidirectional flash-attention forward for Hopper (sm_90a), bf16 in / bf16
// out, for the vision towers: a sibling of csrc/flash_fwd_sm90.cuh's causal
// template (its TMA ring, wgmma products, warpgroup turns and online
// softmax) at head dim 72 with no causal bound.
//
// Replaces: licv_vqa_tpu/models/layers.py::flash_attention_bidir_tpu, which
// calls the upstream Pallas TPU kernel (jax.experimental.pallas.ops.tpu.
// flash_attention) with causal=False and segment ids seg = valid + 1
// (real = 2, invalid = 1).
//
// Semantics (the TPU call's function): key k is visible to query q iff
// valid[k] == valid[q], over the whole sequence, with no causal bound.  A
// real patch attends the real patches only; an invalid one attends the
// invalid ones, so every row sees at least itself and every output is
// finite.  valid is a patch mask (nonzero = real), or null: every key is
// real; every row then has a key tile of its own kind to visit.  The TPU
// pads S to a multiple of 128 with keys of the invalid segment (a Mosaic
// block rule); this kernel gives the keys past S a validity no row has,
// which changes only the invalid rows, garbage by contract (the Idefics2
// perceiver's kv_mask drops them).
//
// Layout: q/k/v/out are (B, S, H, 72) addressed through element strides for
// b, s and h (the head dim is contiguous, rows 16-byte aligned: 144 bytes).
// valid is a contiguous (B, S) int32 or null.  72 is SigLIP-SO400M's head
// dim (1152 / 16 heads), the only one on the Idefics2 path.
//
// What bounds it on the H100: at the tower's shapes (S = 1024..5184, H = 16)
// attention is compute-bound: 4 * 72 operations a visible pair against
// 4 * S * 72 * H * 2 bytes, about 1300 operations a byte at S = 1920.  At
// Dh 72 the softmax's exponentials (one a pair, 16 a clock an SM) take
// about as long as the two products at the tensor cores' rate, so the
// design overlaps one warpgroup's softmax with the other's wgmma:
//
// - One block per (128-query tile, head, batch row), 384 threads: two
//   consumer warpgroups of 64 rows and a producer warpgroup (setmaxnreg 24,
//   the consumers 240), as in the causal template.  At the main shape
//   (1,1920,16,72) that is 15 x 16 = 240 blocks, 1.8 waves at one block an
//   SM (91% of the second wave busy); 64-row tiles would halve the K/V
//   reuse for the same 2 waves, and 33 images give 7920 blocks (60 waves),
//   where the tile height no longer matters.  No persistent grid.
// - Head dim 72 in K-steps of 16: each 128-row tile is two TMA boxes, dims
//   0-63 (128-byte swizzle, 16 KB) and dims 64-79 (32-byte swizzle, 4 KB),
//   the second past the map's 72 dims, so TMA writes zeros at 72-79.
//   S = Q.K^T takes four wgmma m64n128k16 on the first box and a fifth on
//   the second (its descriptors in the 32-byte mode).  V's tile is two
//   64-dim boxes with 128-byte swizzle (dims 72-127 zeros), so O += P.V is
//   one m64n72k16 a k-step (V MN-major: 64 columns in one swizzle atom, 8
//   in the next): 72 columns, where m64n64k16 + m64n16k16 over the 32-byte
//   box would take two issues and 80.  Q loads once; K/V through a ring of
//   kRing = 3 stages (176 KB with Q) with full and empty mbarriers.
// - The segment rule on a tile: a warp votes (__all_sync) whether its 16
//   rows share one validity that every key of the tile has; such a tile is
//   unmasked.  Otherwise (NaViT's interleaved pads: 3 of every 48 patches
//   of a 34x45-of-40x48 grid, so nearly every tile) the warp builds the
//   tile's two 128-bit key masks once with __ballot_sync, real keys and
//   invalid keys, and each row takes the one of its own validity: a select
//   an element, no shuffles.
// - Key tiles that no row of the block can see are skipped by the producer
//   and the consumers alike: the prologue marks, per key tile, whether it
//   holds real keys and invalid keys, and the block's own query tile says
//   which its rows are.  A NaViT grid's pad columns put an invalid patch in
//   every 128-row tile, so at phase 7's shapes no tile is skipped (and the
//   prologue's scan costs nothing measurable); a grid padded by whole rows
//   skips (15x55 of 20x55: 24 of 162 tiles, 18% of the time on an H100
//   80GB HBM3 at 700 W; PERF.md §6).
// - Online softmax in base 2 (the scale times log2(e) folded into the
//   exponent, the max taken on the raw q.k), P rounded to bf16 as the A
//   operand of P.V (f32 accumulation, f32 row sums), tile n's scores and
//   softmax under tile n - 1's P.V, the warpgroups taking turns to issue:
//   the causal template's schedule, with its functions.
// - Epilogue: O / l in bf16 from the registers (rows past S not stored).
#include "flash_fwd_sm90.cuh"

namespace {

using namespace flash_sm90;

constexpr int kDh = 72;                     // SigLIP-SO400M: 1152 dims over 16 heads
constexpr int kBoxA = kBlockN * 64 * 2;     // dims 0-63 of a 128-row tile, 128-byte swizzle
constexpr int kBoxB = kBlockN * 16 * 2;     // dims 64-79, 32-byte swizzle (72-79 zeros)
constexpr int kRowTile = kBoxA + kBoxB;     // a Q or K tile: 20 KB
constexpr int kVTile = 2 * kBoxA;           // a V tile, dims 0-127 (72-127 zeros): 32 KB
constexpr int kRing = 3;                    // K/V stages
constexpr int kBars = kRowTile * (1 + kRing) + kVTile * kRing;  // after Q, the K ring, the V ring
constexpr int kLists = kBars + 8 * (1 + 3 * kRing);  // the key tiles' flags and the visit list

// a map's two boxes of one tensor
struct Maps72 {
  CUtensorMap a, b;
};

struct BidirParams {
  __nv_bfloat16* out;
  long long o_sb, o_ss, o_sh;  // element strides
  const int32_t* valid;        // (B, S) or null
  int S;
  float scale_log2;  // scale * log2(e)
};

// a 128-row tile: dims 0-63 (box A), then dims 64-79 (box B)
__device__ __forceinline__ void load_tile72(uint32_t dst, const Maps72& m, uint32_t bar, int s,
                                            int h, int b) {
  tma_load(dst, &m.a, bar, 0, s, h, b);
  tma_load(dst + kBoxA, &m.b, bar, 64, s, h, b);
}

// s = Q.K^T over 80 dims: q_a, q_b = this warpgroup's 64 rows in the Q
// tile's two boxes, k = a K tile
__device__ __forceinline__ void qk72_issue(float (&s)[64], uint32_t q_a, uint32_t q_b,
                                           uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_ss(s, smem_desc(q_a + kk * 32, 16, 1024), smem_desc(k + kk * 32, 16, 1024), kk > 0);
  }
  wgmma_ss(s, smem_desc_sw32(q_b, 16, 256), smem_desc_sw32(k + kBoxA, 16, 256), 1);
  wgmma_commit();
}

// a V tile: dims 0-63, then 64-127 (72-127 read as zeros), both boxes of
// the 128-byte swizzle map
__device__ __forceinline__ void load_v72(uint32_t dst, const CUtensorMap* a, uint32_t bar, int s,
                                         int h, int b) {
  tma_load(dst, a, bar, 0, s, h, b);
  tma_load(dst + kBoxA, a, bar, 64, s, h, b);
}

// o (64 x 72) += P.V: p = the probabilities as bf16 A fragments (16 keys a
// step), v = a V tile (MN-major, the next 64 dims a box away)
__device__ __forceinline__ void pv72_issue(float (&o)[36], const uint32_t (&p)[8][4],
                                           uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    wgmma_rs_n72(o, p[kk], smem_desc(v + kk * 16 * 128, kBoxA, 1024));
  }
  wgmma_commit();
}

// a key's validity: 1 real, 0 invalid inside S (1 with no mask), past S
// one no row has
__device__ __forceinline__ int key_validity(const int32_t* valid_b, int kj, int S) {
  return kj < S ? (valid_b != nullptr ? valid_b[kj] != 0 : 1) : -2;
}

// the segment rule on a word of key bits: a real row sees the real keys, an
// invalid row the invalid ones, a row past S none
__device__ __forceinline__ uint32_t visible_keys(int vq, uint32_t real, uint32_t pad) {
  return vq == 1 ? real : vq == 0 ? pad : 0u;
}

// Masks one tile's raw q.k in place where the warp's rows do not all see
// every key (kv[i]: key 32i + lane's validity), then folds it into the
// rows' softmax state
__device__ __forceinline__ void bidir_softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                                   float (&alpha)[2], const Rows& rows,
                                                   const int (&kv)[4], float scale_log2) {
  const bool clean =
      rows.alike && __all_sync(0xffffffffu, kv[0] == rows.valid_warp && kv[1] == rows.valid_warp &&
                                                kv[2] == rows.valid_warp &&
                                                kv[3] == rows.valid_warp);
  if (!clean) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // keys 32i .. 32i + 31 of the tile: the real ones and the invalid ones
      const uint32_t real = __ballot_sync(0xffffffffu, kv[i] == 1);
      const uint32_t pad = __ballot_sync(0xffffffffu, kv[i] == 0);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // key 8j + col + e (j = 4i + jj) is bit 8jj + e of the shifted word
        const uint32_t bits = visible_keys(rows.valid[r], real, pad) >> rows.col;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * (4 * i + jj) + 2 * r + e];
            x = (bits >> (8 * jj + e)) & 1u ? x : -INFINITY;
          }
      }
    }
  }
  online_softmax(s, m, l, alpha, scale_log2);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bidir_kernel(const __grid_constant__ Maps72 tq, const __grid_constant__ Maps72 tk,
                   const __grid_constant__ CUtensorMap tv, const BidirParams p) {
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle wants 1024-byte aligned boxes
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t q_s = base;
  const uint32_t k_s = base + kRowTile;
  const uint32_t v_s = base + kRowTile * (1 + kRing);  // + st * kVTile
  const uint32_t q_full = base + kBars;
  const uint32_t k_full = q_full + 8;  // + 8 * stage
  const uint32_t v_full = k_full + 8 * kRing;
  const uint32_t empty = v_full + 8 * kRing;

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int m0 = qt * kBlockM;
  const int n_tiles = (p.S + kBlockN - 1) / kBlockN;  // no causal bound: every key tile
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int32_t* valid_b = p.valid != nullptr ? p.valid + static_cast<long long>(b) * p.S : nullptr;
  // per key tile: 1 if it holds a real key, 2 if an invalid one; then the
  // tiles the block's rows can see, in order, and their count
  int* const flags = reinterpret_cast<int*>(base_ptr + kLists);
  int* const tiles = flags + n_tiles;
  int* const n_visit = tiles + n_tiles;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kRing; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int t = warp; t < n_tiles; t += kThreads / 32) {
    bool real = false, pad = false;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = key_validity(valid_b, t * kBlockN + 32 * i + lane, p.S);
      real |= v == 1;
      pad |= v == 0;
    }
    const int f = (__any_sync(0xffffffffu, real) ? 1 : 0) | (__any_sync(0xffffffffu, pad) ? 2 : 0);
    if (lane == 0) flags[t] = f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // the block's rows are key tile qt's: a key tile is seen iff it shares a kind
    int n = 0;
    for (int t = 0; t < n_tiles; ++t) {
      if (flags[t] & flags[qt]) tiles[n++] = t;
    }
    *n_visit = n;
  }
  __syncthreads();
  const int n_seen = *n_visit;  // >= 1: every row sees itself

  if (warp >= kConsumerWarps) {
    // the producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(q_full, kRowTile);
      load_tile72(q_s, tq, q_full, m0, h, b);
      for (int t = 0; t < n_seen; ++t) {
        const int st = t % kRing;
        const int n0 = tiles[t] * kBlockN;
        // the stage's previous tile released (passes at once on the first round)
        mbar_wait(empty + 8 * st, ((t / kRing) & 1) ^ 1);
        mbar_expect_tx(k_full + 8 * st, kRowTile);
        load_tile72(k_s + st * kRowTile, tk, k_full + 8 * st, n0, h, b);
        mbar_expect_tx(v_full + 8 * st, kVTile);
        load_v72(v_s + st * kVTile, &tv, v_full + 8 * st, n0, h, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int wg = warp / 4;
    Rows rows;
    rows.lo = m0 + 64 * wg + 16 * (warp % 4);
    rows.col = 2 * (lane % 4);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rows.q[r] = rows.lo + lane / 4 + 8 * r;
      rows.valid[r] = rows.q[r] < p.S ? key_validity(valid_b, rows.q[r], p.S) : -1;
    }
    rows.valid_warp = __shfl_sync(0xffffffffu, rows.valid[0], 0);
    rows.alike = __all_sync(0xffffffffu, rows.valid[0] == rows.valid_warp &&
                                             rows.valid[1] == rows.valid_warp);
    const uint32_t q_a = q_s + wg * 64 * 128;
    const uint32_t q_b = q_s + kBoxA + wg * 64 * 32;

    float o[36], s[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 36; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float alpha[2];
    int kv[4];
    uint32_t pf[8][4];
    auto load_kv = [&](int n0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) kv[i] = key_validity(valid_b, n0 + 32 * i + lane, p.S);
    };

    // The warpgroups take turns to issue their products (barrier 1 + wg
    // is this one's turn): one's softmax runs under the other's wgmma.
    // Warpgroup 0 goes first.
    const int my_turn = 1 + wg, their_turn = 2 - wg;
    if (wg == 1) named_arrive(their_turn);

    // the first tile's probabilities
    load_kv(tiles[0] * kBlockN);
    mbar_wait(q_full, 0);
    mbar_wait(k_full, 0);
    named_sync(my_turn);
    fence_regs(s);
    wgmma_fence();
    qk72_issue(s, q_a, q_b, k_s);
    named_arrive(their_turn);
    wgmma_wait<0>();
    fence_regs(s);
    bidir_softmax_tile(s, m, l, alpha, rows, kv, p.scale_log2);
    p_fragments(s, pf);
    // tile t's scores and softmax run while tile t - 1's P.V is on the
    // tensor cores
    for (int t = 1; t < n_seen; ++t) {
      const int st = t % kRing;
      const int prev = (t - 1) % kRing;
      load_kv(tiles[t] * kBlockN);
      mbar_wait(k_full + 8 * st, (t / kRing) & 1);
      mbar_wait(v_full + 8 * prev, ((t - 1) / kRing) & 1);
      named_sync(my_turn);
      fence_regs(s);
      fence_regs(o);
      fence_regs(pf);
      wgmma_fence();
      qk72_issue(s, q_a, q_b, k_s + st * kRowTile);
      pv72_issue(o, pf, v_s + prev * kVTile);
      named_arrive(their_turn);
      wgmma_wait<1>();  // the scores
      fence_regs(s);
      bidir_softmax_tile(s, m, l, alpha, rows, kv, p.scale_log2);
      wgmma_wait<0>();  // the previous P.V: its stage is free
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * prev);
#pragma unroll
      for (int j = 0; j < 9; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[4 * j + i] *= alpha[i / 2];
      p_fragments(s, pf);
    }
    const int last = (n_seen - 1) % kRing;
    mbar_wait(v_full + 8 * last, ((n_seen - 1) / kRing) & 1);
    named_sync(my_turn);
    fence_regs(o);
    fence_regs(pf);
    wgmma_fence();
    pv72_issue(o, pf, v_s + last * kVTile);
    // warpgroup 1's last turn hands none on: warpgroup 0 has had all its own
    if (wg == 0) named_arrive(their_turn);
    wgmma_wait<0>();
    fence_regs(o);

    // epilogue: O / l in bf16
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
      for (int j = 0; j < 9; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + rows.col) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

// One warpgroup, one tile of each product at the kernel's shapes, through
// the same loads, descriptors and wgmma calls: s = Q.K^T (64 x 128) and
// o = bf16(s).V (64 x 72), both f32 row-major.  The card test holds them
// against torch.matmul.
__global__ void __launch_bounds__(128)
bidir_tile_check_kernel(const __grid_constant__ Maps72 tq, const __grid_constant__ Maps72 tk,
                        const __grid_constant__ CUtensorMap tv, float* s_out, float* o_out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + 2 * kRowTile + kVTile;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, 2 * kRowTile + kVTile);
    load_tile72(base, tq, bar, 0, 0, 0);
    load_tile72(base + kRowTile, tk, bar, 0, 0, 0);
    load_v72(base + 2 * kRowTile, &tv, bar, 0, 0, 0);
  }
  mbar_wait(bar, 0);
  float s[64], o[36];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 36; ++i) o[i] = 0.f;
  fence_regs(s);
  wgmma_fence();
  qk72_issue(s, base, base + kBoxA, base + kRowTile);
  wgmma_wait<0>();
  fence_regs(s);
  uint32_t pf[8][4];
  p_fragments(s, pf);
  fence_regs(o);
  fence_regs(pf);
  wgmma_fence();
  pv72_issue(o, pf, base + 2 * kRowTile);
  wgmma_wait<0>();
  fence_regs(o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 16 * warp + lane / 4 + 8 * (i / 2);
    const int c = 2 * (lane % 4) + (i & 1);
#pragma unroll
    for (int j = 0; j < 16; ++j) s_out[row * 128 + 8 * j + c] = s[4 * j + i];
#pragma unroll
    for (int j = 0; j < 9; ++j) o_out[row * kDh + 8 * j + c] = o[4 * j + i];
  }
}

// both boxes of a (B, S, H, 72) tensor's map
bool make_maps72(Maps72* m, const void* ptr, int B, int S, int H, long long sb, long long ss,
                 long long sh) {
  return make_map(&m->a, ptr, kDh, 64, kBlockN, CU_TENSOR_MAP_SWIZZLE_128B, B, S, H, sb, ss, sh) &&
         make_map(&m->b, ptr, kDh, 16, kBlockN, CU_TENSOR_MAP_SWIZZLE_32B, B, S, H, sb, ss, sh);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Strides are in elements; valid
// may be null (every key real).  Launches on `stream`, does not synchronise,
// allocates nothing, and returns a cudaError_t so a refused launch or
// tensor map is reported to the caller; a head dim it was not built for
// returns cudaErrorInvalidValue without launching.
extern "C" int flash_attn_bidir_bf16(
    const void* q, const void* k, const void* v, const void* valid, void* out,
    int B, int S, int H, int DH, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale, void* stream) {
  if (DH != kDh) return static_cast<int>(cudaErrorInvalidValue);
  Maps72 tq, tk;
  CUtensorMap tv;
  if (!make_maps72(&tq, q, B, S, H, q_sb, q_ss, q_sh) ||
      !make_maps72(&tk, k, B, S, H, k_sb, k_ss, k_sh) ||
      !make_map(&tv, v, kDh, 64, kBlockN, CU_TENSOR_MAP_SWIZZLE_128B, B, S, H, v_sb, v_ss, v_sh)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = (S + kBlockN - 1) / kBlockN;
  const int smem = kLists + 4 * (2 * n_tiles + 1) + 1024;  // + align slack
  const cudaError_t ready = prepare(flash_bidir_kernel, smem);
  if (ready != cudaSuccess) return static_cast<int>(ready);
  const BidirParams p{static_cast<__nv_bfloat16*>(out), o_sb, o_ss, o_sh,
                      static_cast<const int32_t*>(valid), S, scale * kLog2e};
  const dim3 grid(n_tiles, H, B);
  flash_bidir_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's two products on one tile, for the card test: q (64, 72),
// k and v (128, 72) contiguous bf16; s_out = q.k^T (64, 128) and o_out =
// bf16(s_out).v (64, 72), f32 each.
extern "C" int flash_bidir_tile_check(const void* q, const void* k, const void* v, void* s_out,
                                      void* o_out, void* stream) {
  Maps72 tq, tk;
  CUtensorMap tv;
  if (!make_maps72(&tq, q, 1, 64, 1, 0, kDh, 0) ||
      !make_maps72(&tk, k, 1, kBlockN, 1, 0, kDh, 0) ||
      !make_map(&tv, v, kDh, 64, kBlockN, CU_TENSOR_MAP_SWIZZLE_128B, 1, kBlockN, 1, 0, kDh, 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = 2 * kRowTile + kVTile + 8 + 1024;
  const cudaError_t attr = cudaFuncSetAttribute(
      bidir_tile_check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  bidir_tile_check_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<float*>(s_out), static_cast<float*>(o_out));
  return static_cast<int>(cudaGetLastError());
}
