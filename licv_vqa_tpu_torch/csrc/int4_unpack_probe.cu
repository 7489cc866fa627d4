// The int4 unpack-schedule probe for Hopper (sm_90a): four ways to widen a
// nibble-packed int4 weight, at a decode-step matmul, on the skeleton of
// the int4 decode kernel (csrc/int4_matmul.cu), so that the schedules are
// timed where that kernel's decode work is.
//
// Replaces: tools/exp_int4_unpack.py::make_fn (the Pallas kernel with its
// `body_a`, `body_d`, `body_e`, `body_f`).  Each instantiation computes
// y (M, N) f32 = bf16(x) @ (decode(packed) * s) as its JAX body does,
// rounding where that body rounds:
// - packed (K/2, N) uint8, N contiguous: byte (i, n) holds in-feature i in
//   its low nibble and in-feature i + K/2 in its high nibble;
// - s (K/G, N) f32: one scale per group of G in-features (original order)
//   and column; G divides K/2, so a group never straddles the planes.
// Schedules (`Planes` says how each reads its nibbles):
// - a (body_a): both nibbles biased (q + 8); w = q * s in f32.  The B
//   fragments are the exact integers q, each group's f32 partial of x.q is
//   multiplied by its f32 scale into the accumulator (as kernel 8 does), so
//   only the summation order differs from the plain version;
// - d (body_d): both biased, read without the -8; w = bf16((q + 8) *
//   bf16(s)), and the bias corrected in the kernel:
//   - 8 * sum_g bf16(sum of the group's x) * bf16(s), per plane.  The
//   group sums are exact (f64 sums of bf16 values), then rounded to f32 and
//   to bf16, as the plain version rounds them;
// - e (body_e): signed nibbles (two's complement); w = bf16(q * bf16(s));
// - f (body_f): the mixed-plane layout of ops/quantize.py: the low nibble
//   biased (read as u & 15), the high one two's complement (u & 0xF0 as
//   int8 = 16 q, with the high plane's scales divided by 16 beforehand:
//   w = bf16(16 q * bf16(s/16)), computed as q * (16 * bf16(s/16)), the
//   same product); without d's correction: the caller subtracts 8 *
//   x_lo-group-sums @ s_lo outside the kernel (ops/int4_unpack_probe.py),
//   as JAX's f_full does outside Pallas.
// For d, e and f one bf16x2 multiply of a decoded nibble pair (exact in
// bf16) by the bf16 scale pair gives w with the plain version's rounding:
// the product is exact in f32 and rounded once.
//
// What bounds it on the H100: at (8, 4096, 11008) it reads 22.5 MB of
// packed weights and 2.8 MB of f32 scales and does 2*M flops per weight,
// far under the compute roof: the bound is the bytes over 3.35 TB/s.
// Kernel 8 at these shapes is bound by its decode instructions, not its
// loads (PERF.md §6), which is what the schedules change.  The design is
// kernel 8's, with csrc/quant_sm90.cuh's primitives:
// - a producer warp keeps a ring of 4 TMA stages: 64 packed rows x 128
//   columns (128-byte swizzle), x's two planes for those rows (16 rows, M
//   padded by TMA's zeros in shared memory), and the f32 scale rows of the
//   groups they touch;
// - four consumer warps of 32 columns each: x is the A operand (`ldmatrix`)
//   of `mma.sync.m16n8k16` bf16 -> f32; a thread's word of four columns of
//   one packed row feeds four interleaved n8 tiles (tile j, column c is the
//   warp's column 4c + j) of both planes;
// - for d, a sixth warp sums each (row, plane)'s group of x in f64 as the
//   stages land, one lane a (row, plane), and hands the rounded sums to the
//   consumers through shared memory (an mbarrier a stage);
// - split-K in one launch through a thread-block cluster of up to 8 blocks
//   along K, summed in rank order in the owners' shared memory; a split is
//   whole groups and whole stages, so d's group sums are never cut;
// - G a multiple of 64 (the quantizer's 64, the tool's): a stage is one
//   group.  Other G (>= 8) split the work where a group ends and mask the
//   rows past the split's end; shapes TMA does not take (N % 16 or K % 8
//   not 0, unaligned pointers) fill the same layout with the producer's
//   plain loads.
#include "quant_sm90.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace quant_sm90;

constexpr int kBN = 128;           // columns (packed bytes) a block
constexpr int kBK = 64;            // packed rows a stage
constexpr int kStages = 4;
constexpr int kMP = 16;            // activation rows a block: one m16 tile
constexpr int kConsumers = 4;      // warps of 32 columns
constexpr int kMaxGroupRows = 9;   // scale rows of the groups a stage touches (G >= 8)

enum Schedule : int { kA = 0, kD = 1, kE = 2, kF = 3 };

// how a plane's nibble n reads: n - 8, n, or n as two's complement
enum class Nib { Biased, Unbiased, Signed };

// each schedule's nibble reading, low plane then high plane
template <int S> struct Planes;
template <> struct Planes<kA> { static constexpr Nib lo = Nib::Biased, hi = Nib::Biased; };
template <> struct Planes<kD> { static constexpr Nib lo = Nib::Unbiased, hi = Nib::Unbiased; };
template <> struct Planes<kE> { static constexpr Nib lo = Nib::Signed, hi = Nib::Signed; };
template <> struct Planes<kF> { static constexpr Nib lo = Nib::Unbiased, hi = Nib::Signed; };

// bf16x2 {128, 128} and {136, 136}: a nibble n put in the mantissa of 128
// reads 128 + n; with its sign bit flipped, 128 + n + 8 for a negative n
constexpr uint32_t k128 = 0x43004300u;
constexpr uint32_t k136 = 0x43084308u;

// the nibbles at bits 0-3 and 16-19 of v as a bf16x2 of their values
template <Nib kRead>
__device__ __forceinline__ uint32_t nibbles(uint32_t v) {
  if constexpr (kRead == Nib::Signed) {
    return bf16x2_sub(and_xor(v, 0x000F000Fu, k136), k136);
  } else {
    return bf16x2_sub(and_or(v, 0x000F000Fu, k128), kRead == Nib::Biased ? k136 : k128);
  }
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// a bf16 value in both halves
__device__ __forceinline__ uint32_t bf16_pair(float v) {
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  return b | b << 16;
}

struct Problem {
  const __nv_bfloat16* x;  // (M, K)
  const uint8_t* packed;   // (K/2, N)
  const float* s;          // (K/G, N)
  float* out;              // (M, N)
  int M, K, N, G;
  int rows_per_split;      // whole stages and whole groups
  int group_rows;          // scale rows a stage loads (its TMA box)
};

// a stage: W (64 x 128 bytes) and x's two planes (16 rows x 64 bf16 each),
// 128-byte swizzled, then the scale rows (low plane's, high plane's; 128
// f32 each)
struct St {
  static constexpr int w = 0;
  static constexpr int x = kBK * kBN;
  static constexpr int xplane = kMP * 128;
  static constexpr int scales = x + 2 * xplane;
  static constexpr int splane = kMaxGroupRows * kBN * 4;
  static constexpr int bytes = (scales + 2 * splane + 1023) / 1024 * 1024;
};

// the block: consumers, the producer warp, and for d the summing warp
template <int S>
struct Shape {
  static constexpr int kSummer = S == kD ? 1 : 0;
  static constexpr int kThreads = 32 * (kConsumers + 1 + kSummer);
  static constexpr int kRecvFloats = kMP * kBN + 4 * kMaxSplits;
  static constexpr int kRecv = kStages * St::bytes;
  // d's rounded group sums: a stage's groups by 32 (row, plane) lanes
  static constexpr int kSums = kRecv + 4 * kRecvFloats;
  static constexpr int kBars = kSums + 4 * kStages * kMaxGroupRows * 32;
  static constexpr int kSmem = kBars + 24 * kStages + 1024;  // + align slack
};

// a consumer thread's shared-memory offsets in a stage: its B words of
// step 0 (rows 2t, 2t+1, 2t+8, 2t+9; step kk is 2048 * kk further) and its
// ldmatrix row address of step kk in the low x plane (the high plane is
// St::xplane further)
struct Offsets {
  int w[4], x[4];
};

__device__ __forceinline__ Offsets thread_offsets(int wc, int lane) {
  const int g = lane / 4, t = lane % 4;
  Offsets o;
#pragma unroll
  for (int q = 0; q < 4; ++q) o.w[q] = swz(2 * t + (q & 1) + 8 * (q >> 1), 32 * wc + 4 * g);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) o.x[kk] = swz(lane % 16, 32 * kk + 16 * (lane / 16));
  return o;
}

// one k16 step's fragments: both planes' B fragments, decoded (not yet
// scaled), and both planes' A fragments
struct Frags {
  uint32_t blo[4][2], bhi[4][2], alo[4], ahi[4];
};

template <int S>
__device__ __forceinline__ void load_step(Frags& f, const uint8_t* d, uint32_t sd,
                                          const Offsets& o, int kk) {
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) w[q] = *reinterpret_cast<const uint32_t*>(d + o.w[q] + 2048 * kk);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // byte j of both rows, each twice: the nibble pairs in the two halves
      const uint32_t v = __byte_perm(w[2 * r], w[2 * r + 1], 0x4400 + 0x1111 * j);
      f.blo[j][r] = nibbles<Planes<S>::lo>(v);
      f.bhi[j][r] = nibbles<Planes<S>::hi>(v >> 4);
    }
  ldmatrix_x4(f.alo, sd + St::x + o.x[kk]);
  ldmatrix_x4(f.ahi, sd + St::x + St::xplane + o.x[kk]);
}

// d += x.b for both planes (kFirst: =), the B rows masked by m0
// (register 0) and m1 (register 1)
template <bool kFirst = false>
__device__ __forceinline__ void mma_step(const Frags& f, uint32_t m0, uint32_t m1,
                                         float (&dlo)[4][4], float (&dhi)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t bl[2] = {f.blo[j][0] & m0, f.blo[j][1] & m1};
    const uint32_t bh[2] = {f.bhi[j][0] & m0, f.bhi[j][1] & m1};
    mma_bf16<kFirst>(dlo[j], f.alo, bl);
    mma_bf16<kFirst>(dhi[j], f.ahi, bh);
  }
}

// the eight f32 scales of a thread's accumulator columns 8t + j + 4e' of
// the warp's 32, from a scale row in the stage
__device__ __forceinline__ void c_scales(const uint8_t* row, int wc, int t, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(row + (32 * wc + 8 * t) * 4);
  const float4 b = *reinterpret_cast<const float4*>(row + (32 * wc + 8 * t + 4) * 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// schedule a, a group's end: acc += partial * s[g, n] per plane
__device__ __forceinline__ void fold(const uint8_t* s_lo, const uint8_t* s_hi, int wc, int t,
                                     const float (&plo)[4][4], const float (&phi)[4][4],
                                     float (&acc)[4][4]) {
  float sl[8], sh[8];
  c_scales(s_lo, wc, t, sl);
  c_scales(s_hi, wc, t, sh);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[j][e] = fmaf(plo[j][e], sl[j + 4 * (e & 1)], acc[j][e]);
      acc[j][e] = fmaf(phi[j][e], sh[j + 4 * (e & 1)], acc[j][e]);
    }
}

// schedule d, a group's end: acc -= 8 * (gs_lo * bf16(s_lo) + gs_hi *
// bf16(s_hi)), gs the group's rounded sums of the thread's rows g, g + 8
// (lanes row and 16 + row of the summing warp)
__device__ __forceinline__ void correct(const float* gs, const uint8_t* s_lo, const uint8_t* s_hi,
                                        int wc, int lane, float (&acc)[4][4]) {
  const int g = lane / 4, t = lane % 4;
  float sl[8], sh[8];
  c_scales(s_lo, wc, t, sl);
  c_scales(s_hi, wc, t, sh);
  const float gl[2] = {-8.f * gs[g], -8.f * gs[g + 8]};
  const float gh[2] = {-8.f * gs[16 + g], -8.f * gs[16 + g + 8]};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[j][e] = fmaf(gl[e >> 1], bf16r(sl[j + 4 * (e & 1)]), acc[j][e]);
      acc[j][e] = fmaf(gh[e >> 1], bf16r(sh[j + 4 * (e & 1)]), acc[j][e]);
    }
}

// d, e, f: the B fragments times the bf16 scale pairs of their columns
// 32wc + 4g + j (f's high plane 16 times its table's)
template <int S>
__device__ __forceinline__ void scale_step(Frags& f, const uint32_t (&slo)[4][2],
                                           const uint32_t (&shi)[4][2]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      f.blo[j][r] = bf16x2_mul(f.blo[j][r], slo[j][r]);
      f.bhi[j][r] = bf16x2_mul(f.bhi[j][r], shi[j][r]);
    }
}

// kWhole: G a multiple of 64, so a stage lies in one group (and K/2 is whole
// stages); else any G >= 8, split where a group ends and masked past the
// split's end
template <int S, bool kTma, bool kWhole>
__global__ void __launch_bounds__(Shape<S>::kThreads)
probe_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tx,
             const __grid_constant__ CUtensorMap ts, const Problem p) {
  using Sh = Shape<S>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  float* const recv = reinterpret_cast<float*>(base_ptr + Sh::kRecv);
  float* const sums = reinterpret_cast<float*>(base_ptr + Sh::kSums);
  const uint32_t bars = base + Sh::kBars;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kStages + st); };
  auto summed = [&](int st) { return bars + 8 * (2 * kStages + st); };

  // every block of the cluster has started before any writes into another
  // (the wait is just before the first such write)
  cluster_arrive_relaxed();
  const int K2 = p.K / 2;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kMP;
  const int r_begin = blockIdx.z * p.rows_per_split;
  const int r_end = min(K2, r_begin + p.rows_per_split);
  const int n_stages = (r_end - r_begin + kBK - 1) / kBK;
  const int hi_groups = K2 / p.G;  // the high plane's first group
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    if constexpr (kTma) {
      prefetch_map(&tw);
      prefetch_map(&tx);
      prefetch_map(&ts);
    }
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), kTma ? 1 : 32);
      mbar_init(empty(st), kConsumers + Sh::kSummer);
      mbar_init(summed(st), 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wc = warp;  // a consumer warp's 32 columns: 32 * wc ..
  const int g = lane / 4, t = lane % 4;
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

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
          mbar_expect_tx(full(st), kBK * kBN + 2 * kMP * 128 + 2 * p.group_rows * kBN * 4);
          tma_load_2d(dst + St::w, &tw, full(st), n0, kb);
          tma_load_2d(dst + St::x, &tx, full(st), kb, m0);
          tma_load_2d(dst + St::x + St::xplane, &tx, full(st), K2 + kb, m0);
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
        for (int e = lane; e < 2 * kMP * 64; e += 32) {
          const int plane = e / (kMP * 64), m = (e / 64) % kMP, c = e % 64;
          const bool in = m0 + m < p.M && plane * K2 + kb + c < p.K;
          const __nv_bfloat16 v = in ? p.x[static_cast<long long>(m0 + m) * p.K + plane * K2 + kb + c]
                                     : __float2bfloat16(0.f);
          *reinterpret_cast<__nv_bfloat16*>(d + St::x + plane * St::xplane + swz(m, 2 * c)) = v;
        }
        for (int e = lane; e < 2 * p.group_rows * kBN; e += 32) {
          const int plane = e / (p.group_rows * kBN), r = (e / kBN) % p.group_rows, c = e % kBN;
          const int row = g0 + r + plane * hi_groups;
          const bool in = row < p.K / p.G && n0 + c < p.N;
          reinterpret_cast<float*>(d + St::scales + plane * St::splane)[r * kBN + c] =
              in ? p.s[static_cast<long long>(row) * p.N + n0 + c] : 0.f;
        }
        mbar_arrive(full(st));  // each lane: its stores are the stage's
      }
    }
  } else if (warp == kConsumers + 1) {
    // d's summing warp: lane = 16 * plane + row; each group's sum of x in
    // f64 (exact for bf16 values), rounded to f32 and to bf16 at its end
    const int plane = lane / 16, row = lane % 16;
    double run = 0.0;
    for (int i = 0; i < n_stages; ++i) {
      const int st = i % kStages;
      const int kb = r_begin + i * kBK;
      const uint8_t* const xr = base_ptr + st * St::bytes + St::x + plane * St::xplane;
      float* const out = sums + st * kMaxGroupRows * 32;
      mbar_wait(full(st), (i / kStages) & 1);
      if constexpr (kWhole) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const uint4 v = *reinterpret_cast<const uint4*>(xr + swz(row, 16 * c));
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            run += static_cast<double>(__uint_as_float(w[h] << 16));
            run += static_cast<double>(__uint_as_float(w[h] & 0xFFFF0000u));
          }
        }
        if ((kb + kBK) % p.G == 0) {
          out[lane] = bf16r(static_cast<float>(run));
          run = 0.0;
        }
      } else {
        const int g0 = kb / p.G;
        for (int c = 0; c < kBK && kb + c < r_end; ++c) {
          run += static_cast<double>(__bfloat162float(
              *reinterpret_cast<const __nv_bfloat16*>(xr + swz(row, 2 * c))));
          if ((kb + c + 1) % p.G == 0) {
            out[((kb + c) / p.G - g0) * 32 + lane] = bf16r(static_cast<float>(run));
            run = 0.0;
          }
        }
      }
      mbar_arrive(summed(st));
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }
  } else {
    const Offsets o = thread_offsets(wc, lane);
    constexpr float kHi = S == kF ? 16.f : 1.f;  // f's high plane: 16 q
    for (int i = 0; i < n_stages; ++i) {
      const int st = i % kStages;
      const int kb = r_begin + i * kBK;
      const int g0 = kb / p.G;
      const uint8_t* const d = base_ptr + st * St::bytes;
      const uint32_t sd = base + st * St::bytes;
      const uint8_t* const s_lo = d + St::scales;
      const uint8_t* const s_hi = d + St::scales + St::splane;
      mbar_wait(full(st), (i / kStages) & 1);
      if constexpr (kWhole) {
        if constexpr (S == kA) {
          // the stage is one group: its partials start at its first step
          float plo[4][4], phi[4][4];
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk) {
            Frags f;
            load_step<S>(f, d, sd, o, kk);
            if (kk == 0) {
              mma_step<true>(f, ~0u, ~0u, plo, phi);
            } else {
              mma_step(f, ~0u, ~0u, plo, phi);
            }
          }
          fold(s_lo, s_hi, wc, t, plo, phi, acc);
        } else {
          // the B columns' scale pairs, one a column for the whole stage
          const float4 a = *reinterpret_cast<const float4*>(s_lo + (32 * wc + 4 * g) * 4);
          const float4 b = *reinterpret_cast<const float4*>(s_hi + (32 * wc + 4 * g) * 4);
          const float al[4] = {a.x, a.y, a.z, a.w}, bh[4] = {b.x, b.y, b.z, b.w};
          uint32_t slo[4][2], shi[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            slo[j][0] = slo[j][1] = bf16_pair(al[j]);
            shi[j][0] = shi[j][1] = bf16_pair(kHi * bf16r(bh[j]));
          }
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk) {
            Frags f;
            load_step<S>(f, d, sd, o, kk);
            scale_step<S>(f, slo, shi);
            mma_step(f, ~0u, ~0u, acc, acc);
          }
          if constexpr (S == kD) {
            if ((kb + kBK) % p.G == 0) {
              mbar_wait(summed(st), (i / kStages) & 1);
              correct(sums + st * kMaxGroupRows * 32, s_lo, s_hi, wc, lane, acc);
            }
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const int kr = kb + 16 * kk;
          if (kr >= r_end) break;
          Frags f;
          load_step<S>(f, d, sd, o, kk);
          if constexpr (S == kA) {
            float plo[4][4], phi[4][4];
            for (int lo = 0; lo < 16 && kr + lo < r_end;) {
              const int gi = (kr + lo) / p.G;
              const int hi = min(16, min((gi + 1) * p.G, r_end) - kr);
              mma_step<true>(f, row_mask(2 * t, lo, hi), row_mask(2 * t + 8, lo, hi), plo, phi);
              fold(s_lo + (gi - g0) * kBN * 4, s_hi + (gi - g0) * kBN * 4, wc, t, plo, phi, acc);
              lo = hi;
            }
          } else {
            // each B row's scale from its own group, rows past the split
            // masked
            uint32_t slo[4][2], shi[4][2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int r0 = kr + 2 * t + 8 * r;
              const int ga = min(r0, r_end - 1) / p.G - g0, gb = min(r0 + 1, r_end - 1) / p.G - g0;
              const uint32_t mask = row_mask(r0 - kr, 0, r_end - kr);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int c = (32 * wc + 4 * g + j) * 4;
                const auto sc = [&](const uint8_t* rows, int gi) {
                  return *reinterpret_cast<const float*>(rows + gi * kBN * 4 + c);
                };
                slo[j][r] = (bf16_pair(sc(s_lo, ga)) & 0xFFFFu) |
                            (bf16_pair(sc(s_lo, gb)) & 0xFFFF0000u);
                shi[j][r] = (bf16_pair(kHi * bf16r(sc(s_hi, ga))) & 0xFFFFu) |
                            (bf16_pair(kHi * bf16r(sc(s_hi, gb))) & 0xFFFF0000u);
                slo[j][r] &= mask;
                shi[j][r] &= mask;
              }
            }
            scale_step<S>(f, slo, shi);
            mma_step(f, ~0u, ~0u, acc, acc);
          }
        }
        if constexpr (S == kD) {
          const int stage_end = min(kb + kBK, r_end);
          if ((g0 + 1) * p.G <= stage_end) {
            mbar_wait(summed(st), (i / kStages) & 1);
            // the groups that end in this stage (each began after the last one's end)
            for (int gi = g0; (gi + 1) * p.G <= stage_end; ++gi) {
              correct(sums + (st * kMaxGroupRows + gi - g0) * 32, s_lo + (gi - g0) * kBN * 4,
                      s_hi + (gi - g0) * kBN * 4, wc, lane, acc);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }
  }

  // Split-K in the cluster: the tile's rows x 128 outputs in `splits`
  // chunks of whole float4s, chunk r summed by block r.  Each consumer
  // thread writes its outputs into their owner's receive buffer (this
  // block's slot), then one cluster barrier, then each block sums its
  // chunk's slots in rank order.
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int rows = min(kMP, p.M - m0);
  const int n_out = rows * kBN;
  const int chunk = (n_out / 4 + splits - 1) / splits * 4;
  cluster_wait();
  if (warp < kConsumers) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = g + 8 * r;
      if (m >= rows) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // columns 32wc + 8t + 4 * half + j: acc[j][2r + half], j = 0..3
        const int e = 2 * r + half;
        const int col = m * kBN + 32 * wc + 8 * t + 4 * half;
        const int owner = col / chunk;
        float* const slot = cluster.map_shared_rank(recv, owner) + rank * chunk + (col - owner * chunk);
        *reinterpret_cast<float4*>(slot) = make_float4(acc[0][e], acc[1][e], acc[2][e], acc[3][e]);
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
    const int m = m0 + c / kBN, n = n0 + c % kBN;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (n + u < p.N) p.out[static_cast<long long>(m) * p.N + n + u] = v[u];
    }
  }
}

template <int S, bool kTma, bool kWhole>
int launch(const Problem& p, int splits, cudaStream_t stream) {
  CUtensorMap tw{}, tx{}, ts{};
  if constexpr (kTma) {
    if (!make_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.packed, p.N, p.K / 2, p.N, kBN, kBK,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
        !make_map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.x, p.K, p.M,
                     static_cast<long long>(p.K) * 2, 64, kMP, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !make_map_2d(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p.s, p.N, p.K / p.G,
                     static_cast<long long>(p.N) * 4, kBN, p.group_rows,
                     CU_TENSOR_MAP_SWIZZLE_NONE)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return launch_cluster(probe_kernel<S, kTma, kWhole>,
                        dim3((p.N + kBN - 1) / kBN, (p.M + kMP - 1) / kMP, splits),
                        Shape<S>::kThreads, Shape<S>::kSmem, splits, stream, tw, tx, ts, p);
}

template <int S>
int launch_s(const Problem& p, int splits, bool tma, cudaStream_t stream) {
  const bool whole = p.G % kBK == 0;
  if (tma) return whole ? launch<S, true, true>(p, splits, stream)
                        : launch<S, true, false>(p, splits, stream);
  return whole ? launch<S, false, true>(p, splits, stream) : launch<S, false, false>(p, splits, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  schedule: 0 = a, 1 = d, 2 = e,
// 3 = f.  `splits` blocks (one cluster, at most 8) share each column
// tile's K/2 packed rows, rows_per_split each (a multiple of 64 and of G).
// Launches on `stream`, does not synchronise, allocates nothing, and
// returns a cudaError_t; shapes the kernel does not take (N % 4 != 0, G
// under 8 or not dividing K/2, a split plan that does not cover K/2)
// return cudaErrorInvalidValue without launching.
extern "C" int int4_unpack_probe(const void* x, const void* packed, const void* s, void* out,
                                 int M, int K, int N, int G, int splits, int rows_per_split,
                                 int schedule, void* stream) {
  const int K2 = K / 2;
  if (M < 1 || K % 2 || N < 1 || N % 4 || G < 8 || K2 % G || splits < 1 ||
      splits > kMaxSplits || rows_per_split % kBK || rows_per_split % G ||
      (splits - 1) * rows_per_split >= K2 || splits * rows_per_split < K2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the scale rows a stage's 64 rows touch: one per 64-multiple group, 64/G
  // for a divisor of 64, else at most ceil(64/G) + 1
  const int group_rows = G % kBK == 0 ? 1 : kBK % G == 0 ? kBK / G : (kBK + G - 1) / G + 1;
  const Problem p{static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
                  static_cast<const float*>(s), static_cast<float*>(out), M, K, N, G,
                  rows_per_split, group_rows};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  // TMA: 16-byte row pitches and addresses
  const bool tma = N % 16 == 0 && K % 8 == 0 && aligned16(x) && aligned16(packed) && aligned16(s);
  switch (schedule) {
    case kA: return launch_s<kA>(p, splits, tma, cs);
    case kD: return launch_s<kD>(p, splits, tma, cs);
    case kE: return launch_s<kE>(p, splits, tma, cs);
    case kF: return launch_s<kF>(p, splits, tma, cs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
