// Weight-only int4 matmul (W4A16) for Hopper (sm_90a): bf16 activations
// times a nibble-packed int4 weight with group-wise bf16 scales, on the
// tensor cores (mma.sync m16n8k16, bf16 -> f32).
//
// Replaces: licv_vqa_tpu/ops/int4_matmul.py::int4_matmul_pallas (_kernel),
// the decode-step matmul of lmm.quantize=int4.  Computes y = x @ dequant(w)
// for the JAX package's layout (ops/quantize.py::quantize_array_int4),
// unchanged, with no repacked copy:
// - packed is (K/2, N) uint8, N contiguous; byte (i, n) holds in-feature i
//   in its low nibble as q_lo + 8, and in-feature i + K/2 in its high
//   nibble as two's-complement q_hi;
// - s is (K/G, N) bf16: one scale per (group of G in-features in original
//   order, column); G divides K/2, so a group never straddles the planes.
// x is (M, K) bf16 (M <= 64), y is (M, N) bf16 or f32; all contiguous.
//
// The TPU kernel decodes the nibbles with masks alone and corrects the
// planes outside the kernel (a second matmul for the +8, pre-divided
// high-plane scales); here both planes decode to their signed values in
// registers, so neither correction has a counterpart.
//
// What bounds it on the H100: at decode shapes it reads half a byte per
// weight plus the scales (8.4 MB at K = N = 4096: 2.5 us at 3.35 TB/s) and
// does 2*M operations per weight, under the bf16 ridge up to M = 64, so the
// bound is the bytes; at M = 3 the time is the latency of a few stages per
// block and the instructions that decode each byte.  The design:
//
// - Tensor cores, with the scale kept exact.  q in [-8, 7] is exact in bf16
//   (a nibble n put in the mantissa of 128 reads 128 + n; one bf16x2
//   subtraction of 136 leaves q), so x.q over a group's 16-row k-steps is an
//   exact-product f32 partial on mma.sync m16n8k16; at the group's end the
//   partial times s[g, n] is added to the accumulator in f32.  Each weight
//   is never rounded as q.s: the plain version dequantizes in f32.  At
//   G = 64 (the quantizer's) a stage is one group; other G (>= 16) split a
//   step where a group ends by masking the fragment's rows.
// - x is the A operand (ldmatrix from its 128-byte-swizzled stage); M is
//   padded to 16 (or 32, 64) by TMA's zero rows in shared memory, never in
//   device memory.
// - One byte load feeds both planes: a thread's 32-bit word (four columns
//   of one packed row) gives the low nibbles to the low plane's fragments
//   and the high nibbles to the high plane's, and the four bytes go to four
//   n8 tiles.  The tiles' columns are interleaved for that (tile j, column
//   c is the block's column 4c + j), so a B fragment's two k-rows of one
//   column are two words of two rows, merged with one byte permute.
// - Weight streaming: a producer warp keeps a ring of 4 stages in flight by
//   TMA: 64 packed rows x 128 columns of weights (128-byte swizzle, so the
//   fragment reads (four rows 2t, 2t+1, 2t+8, 2t+9 by 8 column words) are
//   free of bank conflicts), x's two planes for those rows (128-byte
//   swizzle) and the scale rows of the groups they touch.  Shapes TMA does
//   not take (N % 16 or K % 8 not 0, unaligned pointers) fill the same
//   layout with the producer warp's plain loads.
// - Which paths real traffic takes: every int4 projection of Idefics-9B
//   and Idefics2-8B (K and N among 1024, 1280, 4096, 11008 and 14336, all
//   multiples of 128; the quantizer's G = 64; contiguous layer slices,
//   16-byte aligned) takes TMA with G = 64, the variants <MT, WR, true,
//   true>.  The plain-load and any-G variants are reached only by other
//   shapes or groups (the tiny test configurations, the card tests' odd
//   shapes); they keep the function's shape rules
//   (ops/int4_matmul.py::int4_matmul_usable) whole.
//   The consumers are issue-bound, not the loads (PERF.md §6): their
//   shared-memory offsets are computed once, and a stage's partials start
//   from a zero-accumulator product.
// - Split-K in one launch, deterministic: the blocks that share a column
//   tile's K range form a thread-block cluster (at most 8).  Each block
//   writes each of its outputs into the receive buffer of the block that
//   owns that slice of the tile (distributed shared memory), one cluster
//   barrier later each block sums its slice over the senders in rank order
//   and writes it.  No atomics, no scratch, no second launch.
// Its primitives (TMA boxes, swizzle, fragments, cluster barriers, the
// launch) are csrc/quant_sm90.cuh's, which the int4 unpack probe and the
// w8a8 matmul share.
#include "quant_sm90.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace quant_sm90;

constexpr int kBN = 128;       // columns (packed bytes) a block
constexpr int kBK = 64;        // packed rows a stage
constexpr int kStages = 4;
constexpr int kMaxGroupRows = 5;  // scale rows of the groups a stage touches (G >= 16)
// the activation plane the low nibbles multiply (in-features i < K/2)
constexpr int kLoPlane = 0;
// bf16x2 {136, 136}: a nibble n in the mantissa of 128 reads 128 + n; the
// low nibble holds q + 8, the high one q + 8 once its sign bit is flipped
constexpr uint32_t kLoBias = 0x43084308u;
constexpr uint32_t kHiBias = 0x43084308u;

struct Problem {
  const __nv_bfloat16* x;  // (M, K)
  const uint8_t* packed;   // (K/2, N)
  const __nv_bfloat16* s;  // (K/G, N)
  void* out;               // (M, N)
  int M, K, N, G;
  int rows_per_split;      // a multiple of kBK
  int group_rows;          // scale rows a stage loads (its TMA box)
  int out_f32;
};

// a stage's layout: W (kBK x 128 bytes), x's two planes (MP rows x 64 bf16
// each), both 128-byte swizzled, then the scale rows (low plane's, high
// plane's; 128 bf16 each)
template <int MP>
struct Stage {
  static constexpr int w = 0;
  static constexpr int x = kBK * kBN;
  static constexpr int xplane = MP * 128;
  static constexpr int scales = x + 2 * xplane;
  static constexpr int splane = kMaxGroupRows * kBN * 2;
  static constexpr int bytes = (scales + 2 * splane + 1023) / 1024 * 1024;
};

// The B fragments of one k16 step for both planes: w[0..3] are a thread's
// words of packed rows 2t, 2t+1, 2t+8, 2t+9 (four columns each); tile j
// takes byte j.  Register 0 holds rows 2t and 2t+1, register 1 rows 2t+8
// and 2t+9 (the low row in the low half).
__device__ __forceinline__ void decode_fragments(const uint32_t (&w)[4], uint32_t (&lo)[4][2],
                                                 uint32_t (&hi)[4][2]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // byte j of both rows, each twice: the nibble pairs in the two halves
      const uint32_t v = __byte_perm(w[2 * r], w[2 * r + 1], 0x4400 + 0x1111 * j);
      lo[j][r] = bf16x2_sub(and_or(v, 0x000F000Fu, 0x43004300u), kLoBias);
      hi[j][r] = bf16x2_sub(and_xor(v >> 4, 0x000F000Fu, 0x43084308u), kHiBias);
    }
}

// A consumer thread's shared-memory offsets in a stage: its B words of
// step 0 (step kk is 2048 * kk further: 16 rows of 128 bytes) and its
// ldmatrix row address of step kk in the first m16 tile of the low plane
// (tile mt is 2048 * mt further, the high plane St::xplane)
struct Offsets {
  int w[4], x[4];
};

__device__ __forceinline__ Offsets thread_offsets(int wc, int lane) {
  const int g = lane / 4, t = lane % 4;
  Offsets o;
#pragma unroll
  for (int q = 0; q < 4; ++q) o.w[q] = swz(2 * t + (q & 1) + 8 * (q >> 1), 32 * wc + 4 * g);
  // lanes 0-7: rows 0-7, k 0-7; 8-15: rows 8-15, k 0-7; 16-31: the same at k 8-15
  const int row = lane % 16;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) o.x[kk] = swz(row, 32 * kk + 16 * (lane / 16));
  return o;
}

// one k16 step's fragments: the B fragments of both planes, decoded, and
// the A fragments of the warp's m16 tiles of both x planes
template <int MT>
struct Frags {
  uint32_t blo[4][2], bhi[4][2], alo[MT][4], ahi[MT][4];
};

// step kk of the stage at d (generic pointer) / sd (shared address), the
// warp's m16 tiles from tile0
template <int MT, int MP>
__device__ __forceinline__ void load_step(Frags<MT>& f, const uint8_t* d, uint32_t sd,
                                          const Offsets& o, int kk, int tile0) {
  using St = Stage<MP>;
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    w[q] = *reinterpret_cast<const uint32_t*>(d + St::w + o.w[q] + 2048 * kk);
  }
  decode_fragments(w, f.blo, f.bhi);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const uint32_t a = sd + St::x + o.x[kk] + 2048 * (tile0 + mt);
    ldmatrix_x4(f.alo[mt], a);
    ldmatrix_x4(f.ahi[mt], a + St::xplane);
  }
}

// plo/phi += x.q for both planes (kFirst: =), the B fragments' rows masked
// by m0 (register 0) and m1 (register 1)
template <int MT, bool kFirst = false>
__device__ __forceinline__ void mma_step(const Frags<MT>& f, uint32_t m0, uint32_t m1,
                                         float (&plo)[MT][4][4], float (&phi)[MT][4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t bl[2] = {f.blo[j][0] & m0, f.blo[j][1] & m1};
    const uint32_t bh[2] = {f.bhi[j][0] & m0, f.bhi[j][1] & m1};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma_bf16<kFirst>(plo[mt][j], f.alo[mt], bl);
      mma_bf16<kFirst>(phi[mt][j], f.ahi[mt], bh);
    }
  }
}

// A group's end: acc += partial * s[g, n] per plane, s_lo and s_hi the
// group's scale rows in the stage; the thread's columns are 8t + j
// (partials 0 and 2) and 8t + 4 + j (1 and 3) of the warp's 32
template <int MT>
__device__ __forceinline__ void fold(const uint8_t* s_lo, const uint8_t* s_hi, int wc, int t,
                                     const float (&plo)[MT][4][4], const float (&phi)[MT][4][4],
                                     float (&acc)[MT][4][4]) {
  const uint4 sl4 = *reinterpret_cast<const uint4*>(s_lo + (32 * wc + 8 * t) * 2);
  const uint4 sh4 = *reinterpret_cast<const uint4*>(s_hi + (32 * wc + 8 * t) * 2);
  const __nv_bfloat16* sl = reinterpret_cast<const __nv_bfloat16*>(&sl4);
  const __nv_bfloat16* sh = reinterpret_cast<const __nv_bfloat16*>(&sh4);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float a = __bfloat162float(sl[j + 4 * (e & 1)]);
      const float b = __bfloat162float(sh[j + 4 * (e & 1)]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        acc[mt][j][e] = fmaf(plo[mt][j][e], a, acc[mt][j][e]);
        acc[mt][j][e] = fmaf(phi[mt][j][e], b, acc[mt][j][e]);
      }
    }
}

// The warps of a block: 4 column slices of 32 by WR rows of MT m16 tiles
// (MP = 16 * MT * WR padded rows), and a producer warp.
template <int MT, int WR>
struct Shape {
  static constexpr int kMP = 16 * MT * WR;
  static constexpr int kConsumers = 4 * WR;
  static constexpr int kThreads = 32 * (kConsumers + 1);
  // the partial tiles the cluster's blocks send a block: its chunk of each
  // (whole float4s)
  static constexpr int kRecvFloats = kMP * kBN + 4 * kMaxSplits;
  static constexpr int kRecv = kStages * Stage<kMP>::bytes;
  static constexpr int kBars = kRecv + 4 * kRecvFloats;
  static constexpr int kSmem = kBars + 16 * kStages + 1024;  // + align slack
};

// kG64: G = 64, each stage one group (then K/2 is whole stages too), so no
// step needs a mask; else any G >= 16, a step's rows split at a group's
// end or the split's and each piece folded at once
template <int MT, int WR, bool kTma, bool kG64>
__global__ void __launch_bounds__(Shape<MT, WR>::kThreads)
int4_matmul_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap ts, const Problem p) {
  using Sh = Shape<MT, WR>;
  constexpr int MP = Sh::kMP;
  constexpr int kConsumers = Sh::kConsumers;
  using St = Stage<MP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  float* const recv = reinterpret_cast<float*>(base_ptr + Sh::kRecv);
  const uint32_t bars = base + Sh::kBars;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kStages + st); };

  // every block of the cluster has started before any writes into another
  // (the wait is just before the first such write)
  cluster_arrive_relaxed();
  const int K2 = p.K / 2;
  const int n0 = blockIdx.x * kBN;
  const int r_begin = blockIdx.z * p.rows_per_split;
  const int r_end = min(K2, r_begin + p.rows_per_split);
  const int n_stages = (r_end - r_begin + kBK - 1) / kBK;
  const int hi_groups = K2 / p.G;  // the high plane's first group
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    if constexpr (kTma) {
      prefetch_map(&tw);
      prefetch_map(&tx);
      prefetch_map(&ts);
    }
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), kTma ? 1 : 32);
      mbar_init(empty(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wc = warp % 4;   // a consumer warp's 32 columns: 32 * wc ..
  const int wr = warp / 4;   // its m16 tiles: MT * wr ..
  const int t = lane % 4;
  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  if (warp == kConsumers) {
    // the producer warp
    for (int i = 0; i < n_stages; ++i) {
      const int st = i % kStages;
      const int kb = r_begin + i * kBK;
      const int g0 = kb / p.G;
      const uint32_t dst = base + st * St::bytes;
      // the stage's previous contents released (passes at once on the first round)
      mbar_wait(empty(st), ((i / kStages) & 1) ^ 1);
      if constexpr (kTma) {
        if (lane == 0) {
          mbar_expect_tx(full(st), kBK * kBN + 2 * MP * 128 + 2 * p.group_rows * kBN * 2);
          tma_load_2d(dst + St::w, &tw, full(st), n0, kb);
          tma_load_2d(dst + St::x + kLoPlane * St::xplane, &tx, full(st), kb, 0);
          tma_load_2d(dst + St::x + (1 - kLoPlane) * St::xplane, &tx, full(st), K2 + kb, 0);
          tma_load_2d(dst + St::scales, &ts, full(st), n0, g0);
          tma_load_2d(dst + St::scales + St::splane, &ts, full(st), n0, g0 + hi_groups);
        }
      } else {
        uint8_t* const d = base_ptr + st * St::bytes;
        for (int e = lane; e < kBK * kBN; e += 32) {
          const int r = e / kBN, c = e % kBN;
          const bool in = kb + r < K2 && n0 + c < p.N;
          d[St::w + swz(r, c)] = in ? p.packed[static_cast<long long>(kb + r) * p.N + n0 + c] : 0;
        }
        for (int e = lane; e < 2 * MP * 64; e += 32) {
          const int plane = e / (MP * 64), m = (e / 64) % MP, c = e % 64;
          const bool in = m < p.M && kb + c < K2;
          const __nv_bfloat16 v =
              in ? p.x[static_cast<long long>(m) * p.K + plane * K2 + kb + c] : __float2bfloat16(0.f);
          const int xp = plane == 0 ? kLoPlane : 1 - kLoPlane;
          *reinterpret_cast<__nv_bfloat16*>(d + St::x + xp * St::xplane + swz(m, 2 * c)) = v;
        }
        for (int e = lane; e < 2 * p.group_rows * kBN; e += 32) {
          const int plane = e / (p.group_rows * kBN), r = (e / kBN) % p.group_rows, c = e % kBN;
          const int row = g0 + r + plane * hi_groups;
          const bool in = row < p.K / p.G && n0 + c < p.N;
          reinterpret_cast<__nv_bfloat16*>(d + St::scales + plane * St::splane)[r * kBN + c] =
              in ? p.s[static_cast<long long>(row) * p.N + n0 + c] : __float2bfloat16(0.f);
        }
        mbar_arrive(full(st));  // each lane: its stores are the stage's
      }
    }
  } else {
    const Offsets o = thread_offsets(wc, lane);
    float plo[MT][4][4], phi[MT][4][4];
    for (int i = 0; i < n_stages; ++i) {
      const int st = i % kStages;
      const int kb = r_begin + i * kBK;
      const uint8_t* const d = base_ptr + st * St::bytes;
      const uint32_t sd = base + st * St::bytes;
      mbar_wait(full(st), (i / kStages) & 1);
      if constexpr (kG64) {
        // the stage is one group: its partials start at its first step
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          Frags<MT> f;
          load_step<MT, MP>(f, d, sd, o, kk, MT * wr);
          if (kk == 0) {
            mma_step<MT, true>(f, ~0u, ~0u, plo, phi);
          } else {
            mma_step<MT>(f, ~0u, ~0u, plo, phi);
          }
        }
        fold(d + St::scales, d + St::scales + St::splane, wc, t, plo, phi, acc);
      } else {
        const int g0 = kb / p.G;
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const int kr = kb + 16 * kk;
          if (kr >= r_end) break;
          Frags<MT> f;
          load_step<MT, MP>(f, d, sd, o, kk, MT * wr);
          for (int lo = 0; lo < 16 && kr + lo < r_end;) {
            const int gi = (kr + lo) / p.G;
            const int hi = min(16, min((gi + 1) * p.G, r_end) - kr);
            mma_step<MT, true>(f, row_mask(2 * t, lo, hi), row_mask(2 * t + 8, lo, hi), plo, phi);
            fold(d + St::scales + (gi - g0) * kBN * 2,
                 d + St::scales + St::splane + (gi - g0) * kBN * 2, wc, t, plo, phi, acc);
            lo = hi;
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }
  }

  // Split-K in the cluster: the tile's M x 128 outputs in `splits` chunks
  // of whole float4s, chunk r summed by block r.  Each consumer thread
  // writes its outputs into their owner's receive buffer (this block's
  // slot), then one cluster barrier, then each block sums its chunk's slots
  // in rank order.
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_out = p.M * kBN;
  const int chunk = (n_out / 4 + splits - 1) / splits * 4;
  cluster_wait();
  if (warp < kConsumers) {
    const int g = lane / 4;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = 16 * (MT * wr + mt) + g + 8 * r;
        if (m >= p.M) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          // columns 32wc + 8t + 4 * half + j: acc[mt][j][2r + half], j = 0..3
          const int e = 2 * r + half;
          const int col = m * kBN + 32 * wc + 8 * t + 4 * half;
          const int owner = col / chunk;
          float* const slot =
              cluster.map_shared_rank(recv, owner) + rank * chunk + (col - owner * chunk);
          *reinterpret_cast<float4*>(slot) =
              make_float4(acc[mt][0][e], acc[mt][1][e], acc[mt][2][e], acc[mt][3][e]);
        }
      }
  }
  cluster_arrive();
  cluster_wait();
  const int c_begin = rank * chunk;
  const int c_end = min(n_out, c_begin + chunk);
  for (int c = c_begin + 4 * static_cast<int>(threadIdx.x); c < c_end;
       c += 4 * static_cast<int>(blockDim.x)) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < splits; ++q) {
      const float4 part = *reinterpret_cast<const float4*>(recv + q * chunk + (c - c_begin));
      v[0] += part.x;
      v[1] += part.y;
      v[2] += part.z;
      v[3] += part.w;
    }
    const int m = c / kBN, n = n0 + c % kBN;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (n + u >= p.N) break;
      const long long y = static_cast<long long>(m) * p.N + n + u;
      if (p.out_f32) {
        static_cast<float*>(p.out)[y] = v[u];
      } else {
        static_cast<__nv_bfloat16*>(p.out)[y] = __float2bfloat16_rn(v[u]);
      }
    }
  }
}

template <int MT, int WR, bool kTma, bool kG64>
int launch(const Problem& p, int splits, cudaStream_t stream) {
  using Sh = Shape<MT, WR>;
  CUtensorMap tw{}, tx{}, ts{};
  if constexpr (kTma) {
    if (!make_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.packed, p.N, p.K / 2, p.N, kBN, kBK,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
        !make_map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.x, p.K, p.M,
                     static_cast<long long>(p.K) * 2, 64, Sh::kMP, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !make_map_2d(&ts, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.s, p.N, p.K / p.G,
                     static_cast<long long>(p.N) * 2, kBN, p.group_rows,
                     CU_TENSOR_MAP_SWIZZLE_NONE)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return launch_cluster(int4_matmul_kernel<MT, WR, kTma, kG64>,
                        dim3((p.N + kBN - 1) / kBN, 1, splits), Sh::kThreads, Sh::kSmem, splits,
                        stream, tw, tx, ts, p);
}

// the block's warps for M rows: up to 16, one m16 tile a warp; up to 32,
// two; up to 64, two rows of warps with two each
template <bool kTma, bool kG64>
int launch_m(const Problem& p, int splits, cudaStream_t stream) {
  if (p.M <= 16) return launch<1, 1, kTma, kG64>(p, splits, stream);
  if (p.M <= 32) return launch<2, 1, kTma, kG64>(p, splits, stream);
  return launch<2, 2, kTma, kG64>(p, splits, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  `splits` blocks (one cluster,
// at most 8) share each column tile's K/2 packed rows, rows_per_split each
// (a multiple of 64).  Launches on `stream`, does not synchronise,
// allocates nothing, and returns a cudaError_t; shapes the kernel does not
// take (M outside 1..64, G under 16 or not dividing K/2, a split plan that
// does not cover K/2) return cudaErrorInvalidValue without launching.
extern "C" int int4_matmul_bf16(const void* x, const void* packed, const void* s, void* out,
                                int M, int K, int N, int G, int splits, int rows_per_split,
                                int out_f32, void* stream) {
  const int K2 = K / 2;
  if (M < 1 || M > 64 || K % 2 || N < 1 || G < 16 || K2 % G || splits < 1 ||
      splits > kMaxSplits || rows_per_split % kBK || (splits - 1) * rows_per_split >= K2 ||
      splits * rows_per_split < K2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the scale rows a stage's 64 rows touch: one per 64-multiple group, 64/G
  // for a divisor of 64, else at most ceil(64/G) + 1
  const int group_rows = G % kBK == 0 ? 1 : kBK % G == 0 ? kBK / G : (kBK + G - 1) / G + 1;
  const Problem p{static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
                  static_cast<const __nv_bfloat16*>(s), out, M, K, N, G, rows_per_split,
                  group_rows, out_f32};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  // TMA: 16-byte row pitches and addresses
  const bool tma = N % 16 == 0 && K % 8 == 0 && aligned16(x) && aligned16(packed) && aligned16(s);
  if (tma) {
    return G == kBK ? launch_m<true, true>(p, splits, cs) : launch_m<true, false>(p, splits, cs);
  }
  return G == kBK ? launch_m<false, true>(p, splits, cs) : launch_m<false, false>(p, splits, cs);
}
