// w8a8 matmul for Hopper (sm_90a): int8 activations times an int8 weight
// on the int8 tensor cores, with an exact int32 sum.
//
// Replaces: tools/exp_w8a8_tuning.py's two Pallas kernels, `w8a8_kernel`
// (activations quantized beforehand) and `w8a8_fused_kernel` (each row
// quantized in the kernel), probes of the w8a8 prefill that the JAX
// package computes in XLA (licv_vqa_tpu/ops/int8_matmul.py::_w8a8_dot).
// Computes what the port's plain version computes, bit for bit
// (licv_vqa_tpu_torch/ops/int8_matmul.py::w8a8_matmul_reference):
//     scale[m] = max(max_k |x[m, k]|, 1e-8) * f32(1/127)
//     xq[m, k] = clamp(round_half_even(x[m, k] / scale[m]), -127, 127)
//     y[m, n]  = (float(sum_k xq[m, k] * q[k, n]) * scale[m]) * s[n]
// with IEEE division, the int32 -> f32 cast rounding to nearest, and y in
// bf16 or f32 (round to nearest even).  x is (M, K) bf16 or f32, or xq
// (M, K) int8 with its scales xs (M,) f32 for the pre-quantized entry
// point; q is (K, N) int8 with N contiguous (the port's weight layout,
// which run A's int8 decode kernel reads too: no second copy); s is (N,)
// f32; all contiguous.  Any M, K, N: what lies outside is zero.
//
// What bounds it on the H100: 2*M*K*N int8 operations against M*K*2 + K*N
// bytes.  Up to M of about 512 (run A's 64-token prefill and bind, its
// 32-shot prefill, the perceiver's 321 rows) that is under the ~590
// operations a byte the card needs to be compute-bound at 1979 TOP/s: the
// bound is the weight bytes over 3.35 TB/s, and the work is keeping loads
// in flight.  Above, the bound is the int8 tensor-core rate.  The design:
//
// - Each row is quantized once: the fused entry point's first kernel
//   (`quantize_rows`, one block a row) writes xq and xs into the caller's
//   scratch; the matmul then reads int8 activations at every M, for both
//   entry points.  The fused call costs the pre-quantized one plus one pass
//   over x (the TPU kernel held the whole (mt, K) block in VMEM and
//   quantized it in every column block).
// - One matmul kernel, a producer warp and WM x WN consumer warps: the
//   producer keeps a ring of TMA stages, 128 K-bytes each, of xq (BM rows,
//   K contiguous) and of q in its own (K, N) layout (128 x 128-byte boxes),
//   all 128-byte swizzled.  A consumer warp owns MT m16 tiles by NB groups
//   of 32 columns; per k32 step it reads A with `ldmatrix` and feeds
//   `mma.sync.m16n8k32.s8` (the int8 `wgmma` takes B K-major only, and q
//   is N-major).
// - B fragments in registers: a thread reads one 32-bit word (four
//   columns) from each of four K-rows and transposes the 4 x 4 bytes with
//   byte permutes, so that each word feeds four n8 tiles (tile j, column c
//   is the group's column 4c + j).  A thread's K-rows are 4t + (i ^ (t & 2))
//   for its i-th load, so that the warp's four rows of one load fall in
//   four distinct 32-byte bank ranges of the swizzle; the permutes undo the
//   order.  A thread's outputs are then 8 contiguous columns of a row.
// - One tile for every M (ops/int8_matmul.py::W8A8_TILES, "64x128"): four
//   consumer warps of 64 rows by 32 columns, three stages, two blocks an
//   SM.  Where the tiles alone leave SMs idle (run A's 64 rows), K is split
//   over a thread-block cluster of up to 8 blocks: each block writes its
//   int32 tile in chunks into the owners' receive buffers (distributed
//   shared memory), one cluster barrier later each block sums its chunk
//   over the senders in rank order, applies the epilogue and writes it (no
//   atomics, no scratch, no second kernel).  At M = 4096 and 16384 it beat
//   both compute tiles timed against it with tools/exp_w8a8_tuning_torch.py
//   on the H100: a 128 x 256 tile of eight such warps, and a 128 x 256
//   `wgmma` tile whose consumers transposed each landed B stage into a
//   K-major, 128-byte-swizzled copy (PERF.md §6).
// - Shapes TMA does not take (K or N not a multiple of 16, unaligned
//   pointers) fill the same stage layout with the producer warp's plain
//   loads; what lies past M, K or N is zero either way.
#include "quant_sm90.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace quant_sm90;

constexpr int kBK = 128;               // K bytes a stage: four mma k32 steps
constexpr float kInv127 = 1.0f / 127.0f;  // f32(1/127), as XLA folds a / 127
constexpr int kRowThreads = 1024;      // the row pass's block: one row
constexpr int kRowVecs = 2;            // its vectors of 8 a thread held in registers

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// one activation to int8 as the plain version rounds it: the IEEE quotient
// v / scale, rounded half to even, clamped to +-127.  |v / scale| <= 127
// (v is in the row whose absmax made the scale), so v * (1 / scale) lies
// within 2^-15 of the rounded quotient and rounds to the same integer
// unless it is within 2^-13 of a half-integer; there the division decides
__device__ __forceinline__ uint32_t quantize(float v, float scale, float inv) {
  float y = __fmul_rn(v, inv);
  if (fabsf(y - floorf(y) - 0.5f) < 1.220703125e-4f) y = __fdiv_rn(v, scale);
  const int r = __float2int_rn(y);
  return static_cast<uint32_t>(max(-127, min(127, r))) & 0xFFu;
}

// eight activations from 16-byte-aligned p
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// eight activations quantized, as eight bytes
__device__ __forceinline__ uint2 quantize8(const float (&v)[8], float sc, float inv) {
  uint2 w;
  w.x = quantize(v[0], sc, inv) | quantize(v[1], sc, inv) << 8 |
        quantize(v[2], sc, inv) << 16 | quantize(v[3], sc, inv) << 24;
  w.y = quantize(v[4], sc, inv) | quantize(v[5], sc, inv) << 8 |
        quantize(v[6], sc, inv) << 16 | quantize(v[7], sc, inv) << 24;
  return w;
}

// the block's absmax from each thread's, as the row's scale
__device__ __forceinline__ float row_scale(float mx, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < kRowThreads / 32; ++w) mx = fmaxf(mx, red[w]);
  return __fmul_rn(fmaxf(mx, 1e-8f), kInv127);
}

// The fused entry point's first kernel, one block a row m: xs[m] =
// max(absmax, 1e-8) * f32(1/127) over the whole row, then the row's int8
// plane into xq.  With `vec` (K % 8 == 0, x 16-byte aligned) a row of up
// to kRowThreads * 8 * kRowVecs activations (every projection of the
// supported models) is read once, eight a load, into registers, all loads
// in flight together, and written eight bytes a store.  M = 64 rows are 64
// blocks on 132 SMs, so a row takes a whole block of 32 warps: the
// quantization's arithmetic, not the loads, bounds it (at K = 11008 on an
// H100 80GB HBM3 at 700 W, 256 threads a row took 9.3 µs, 1024 take 4.5;
// PERF.md §6)
template <class T>
__global__ void __launch_bounds__(kRowThreads)
quantize_rows(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs, int K,
              int vec) {
  __shared__ float red[kRowThreads / 32];
  const int m = blockIdx.x, tid = threadIdx.x;
  const T* row = x + static_cast<long long>(m) * K;
  int8_t* qrow = xq + static_cast<long long>(m) * K;
  const int k_end = K;  // the absmax runs over the whole row
  float mx = 0.f;
  if (vec && K <= kRowThreads * 8 * kRowVecs) {
    float v[kRowVecs][8];
#pragma unroll
    for (int i = 0; i < kRowVecs; ++i) {
      const int k = (tid + i * kRowThreads) * 8;
      if (k < K) load8(row + k, v[i]);
    }
#pragma unroll
    for (int i = 0; i < kRowVecs; ++i) {
      if ((tid + i * kRowThreads) * 8 >= k_end) continue;
#pragma unroll
      for (int e = 0; e < 8; ++e) mx = fmaxf(mx, fabsf(v[i][e]));
    }
    const float sc = row_scale(mx, red), inv = __frcp_rn(sc);
    if (tid == 0) xs[m] = sc;
#pragma unroll
    for (int i = 0; i < kRowVecs; ++i) {
      const int k = (tid + i * kRowThreads) * 8;
      if (k < K) *reinterpret_cast<uint2*>(qrow + k) = quantize8(v[i], sc, inv);
    }
    return;
  }
  // longer rows and unaligned ones: two passes, the second from the cache
  for (int k = tid; k < k_end; k += kRowThreads) mx = fmaxf(mx, fabsf(to_f32(row[k])));
  const float sc = row_scale(mx, red), inv = __frcp_rn(sc);
  if (tid == 0) xs[m] = sc;
  for (int k = tid; k < K; k += kRowThreads)
    qrow[k] = static_cast<int8_t>(quantize(to_f32(row[k]), sc, inv));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The s8 B registers of four n8 tiles from a thread's four words: w[i] is
// K-row 4t + (i ^ (t & 2)) at the thread's four columns; b[j] gets byte j
// of each row, K-rows 4t .. 4t + 3 from the low byte up.  sel_lo / sel_hi
// are 0x5410 / 0x7632 for t < 2 and 0x1054 / 0x3276 for t >= 2, whose
// first two words hold rows 2 and 3
__device__ __forceinline__ void s8_fragments(const uint32_t (&w)[4], uint32_t sel_lo,
                                             uint32_t sel_hi, uint32_t (&b)[4]) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
  b[0] = __byte_perm(lo01, lo23, sel_lo);
  b[1] = __byte_perm(lo01, lo23, sel_hi);
  b[2] = __byte_perm(hi01, hi23, sel_lo);
  b[3] = __byte_perm(hi01, hi23, sel_hi);
}

// the epilogue of one int32 sum: (float(acc) * xs) * s, each rounded
__device__ __forceinline__ float epilogue(int c, float xsr, float sc) {
  return __fmul_rn(__fmul_rn(__int2float_rn(c), xsr), sc);
}

struct Problem {
  const int8_t* a;   // xq (M, K)
  const float* xs;   // (M,)
  const int8_t* q;   // (K, N)
  const float* s;    // (N,)
  void* out;         // (M, N) bf16 or f32
  int M, K, N;
  int k_per_split;   // a multiple of kBK
  int out_f32;
};

// Eight outputs of row m from column n on: (acc * xs[m]) * s[n + u]
__device__ __forceinline__ void store8(const Problem& p, int m, int n, const int (&v)[8]) {
  if (m >= p.M) return;
  const float xsr = p.xs[m];
  float y[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) y[u] = n + u < p.N ? epilogue(v[u], xsr, __ldg(p.s + n + u)) : 0.f;
  const long long o = static_cast<long long>(m) * p.N + n;
  if (p.out_f32) {
    float* out = static_cast<float*>(p.out) + o;
    if (p.N % 4 == 0 && n + 8 <= p.N) {
      reinterpret_cast<float4*>(out)[0] = make_float4(y[0], y[1], y[2], y[3]);
      reinterpret_cast<float4*>(out)[1] = make_float4(y[4], y[5], y[6], y[7]);
    } else {
      for (int u = 0; u < 8 && n + u < p.N; ++u) out[u] = y[u];
    }
  } else {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + o;
    if (p.N % 8 == 0 && n + 8 <= p.N) {
      uint4 w;
      w.x = flash_sm90::pack_bf16(y[0], y[1]);
      w.y = flash_sm90::pack_bf16(y[2], y[3]);
      w.z = flash_sm90::pack_bf16(y[4], y[5]);
      w.w = flash_sm90::pack_bf16(y[6], y[7]);
      *reinterpret_cast<uint4*>(out) = w;
    } else {
      for (int u = 0; u < 8 && n + u < p.N; ++u) out[u] = __float2bfloat16_rn(y[u]);
    }
  }
}

// The producer warp: stage i (of STAGES) holds A, xq's BM rows by the 128
// K bytes from k_begin + 128 i, then q's 128 rows by BN columns from n0 as
// BN / 128 boxes of 128 x 128 bytes, all 128-byte swizzled; full(st) at
// bars + 8 st completes when it has landed, empty(st) after it frees it
template <int BM, int BN, int STAGES, bool kTma>
__device__ __forceinline__ void produce(const CUtensorMap& ta, const CUtensorMap& tq,
                                        const Problem& p, uint32_t base, uint8_t* base_ptr,
                                        uint32_t bars, int n_stages, int k_begin, int m0, int n0,
                                        int lane) {
  constexpr int kA = BM * kBK, kStage = kA + BN * kBK;
  for (int i = 0; i < n_stages; ++i) {
    const int st = i % STAGES;
    const int k0 = k_begin + i * kBK;
    const uint32_t dst = base + st * kStage, full = bars + 8 * st;
    // the stage's previous contents released (passes at once on the first round)
    mbar_wait(bars + 8 * (STAGES + st), ((i / STAGES) & 1) ^ 1);
    if constexpr (kTma) {
      if (lane == 0) {
        mbar_expect_tx(full, kStage);
        tma_load_2d(dst, &ta, full, k0, m0);
#pragma unroll
        for (int h = 0; h < BN / 128; ++h)
          tma_load_2d(dst + kA + h * 128 * kBK, &tq, full, n0 + 128 * h, k0);
      }
    } else {
      uint8_t* const d = base_ptr + st * kStage;
      for (int e = lane; e < BM * kBK; e += 32) {
        const int r = e / kBK, c = e % kBK;
        const bool in = m0 + r < p.M && k0 + c < p.K;
        d[swz(r, c)] = in ? p.a[static_cast<long long>(m0 + r) * p.K + k0 + c] : 0;
      }
      for (int e = lane; e < kBK * BN; e += 32) {
        const int r = e / BN, c = e % BN;
        const bool in = k0 + r < p.K && n0 + c < p.N;
        d[kA + (c / 128) * 128 * kBK + swz(r, c % 128)] =
            in ? p.q[static_cast<long long>(k0 + r) * p.N + n0 + c] : 0;
      }
      mbar_arrive(full);  // each lane: its stores are the stage's
    }
  }
}

// A block: WM x WN consumer warps of MT m16 tiles by NB 32-column groups
// (BM x BN outputs) and a producer warp; STAGES stages of A (BM x 128
// bytes) and B (BN / 128 boxes of 128 x 128 bytes), then the receive
// buffer of the cluster's int32 partial tiles
template <int MT, int NB, int WM, int WN, int STAGES>
struct Tile {
  static constexpr int kBM = 16 * MT * WM;
  static constexpr int kBN = 32 * NB * WN;
  static constexpr int kConsumers = WM * WN;
  static constexpr int kThreads = 32 * (kConsumers + 1);
  static constexpr int kA = kBM * kBK;
  static constexpr int kStage = kA + kBN * kBK;
  static constexpr int kRecvInts = kBM * kBN + 4 * kMaxSplits;
  static constexpr int kRecv = STAGES * kStage;
  static constexpr int kBars = kRecv + 4 * kRecvInts;
  static constexpr int kSmem = kBars + 16 * STAGES + 1024;  // + align slack
  static_assert(kBN % 128 == 0 && kStage % 1024 == 0, "tile");
};

template <int MT, int NB, int WM, int WN, int STAGES, bool kTma>
__global__ void __launch_bounds__(Tile<MT, NB, WM, WN, STAGES>::kThreads)
w8a8_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tq,
            const Problem p) {
  using T = Tile<MT, NB, WM, WN, STAGES>;
  constexpr int BM = T::kBM, BN = T::kBN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bars = base + T::kBars;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (STAGES + st); };

  // every block of the cluster has started before any writes into another
  // (the wait is just before the first such write)
  cluster_arrive_relaxed();
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * p.k_per_split;
  const int k_end = min(p.K, k_begin + p.k_per_split);
  const int n_stages = (k_end - k_begin + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    if constexpr (kTma) {
      prefetch_map(&ta);
      prefetch_map(&tq);
    }
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), kTma ? 1 : 32);
      mbar_init(empty(st), T::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wm = warp / WN, wn = warp % WN;
  const int g = lane / 4, t = lane % 4;
  int acc[MT][NB][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nb][j][e] = 0;

  if (warp == T::kConsumers) {
    produce<BM, BN, STAGES, kTma>(ta, tq, p, base, base_ptr, bars, n_stages, k_begin, m0, n0,
                                  lane);
  } else {
    // the thread's shared-memory offsets: its ldmatrix row address of k32
    // step kk in the warp's first m16 tile (tile mt is 2048 * mt further),
    // and its B words of step 0's first K half (the second is 16 rows, step
    // kk 32 rows further) in each column group
    int a_off[4], b_off[NB][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      a_off[kk] = MT * wm * 2048 + swz(lane % 16, 32 * kk + 16 * (lane / 16));
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int col = 32 * (wn * NB + nb) + 4 * g;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        b_off[nb][i] = T::kA + (col / 128) * 128 * kBK + swz(4 * t + (i ^ (t & 2)), col % 128);
    }
    const uint32_t sel_lo = t & 2 ? 0x1054u : 0x5410u;
    const uint32_t sel_hi = t & 2 ? 0x3276u : 0x7632u;
    for (int i = 0; i < n_stages; ++i) {
      const int st = i % STAGES;
      const uint8_t* const d = base_ptr + st * T::kStage;
      const uint32_t sd = base + st * T::kStage;
      mbar_wait(full(st), (i / STAGES) & 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(af[mt], sd + a_off[kk] + 2048 * mt);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          uint32_t w0[4], w1[4], b0[4], b1[4];
#pragma unroll
          for (int i2 = 0; i2 < 4; ++i2) {
            w0[i2] = *reinterpret_cast<const uint32_t*>(d + b_off[nb][i2] + 4096 * kk);
            w1[i2] = *reinterpret_cast<const uint32_t*>(d + b_off[nb][i2] + 4096 * kk + 2048);
          }
          s8_fragments(w0, sel_lo, sel_hi, b0);
          s8_fragments(w1, sel_lo, sel_hi, b1);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t b[2] = {b0[j], b1[j]};
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][nb][j], af[mt], b);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }
  }

  // A thread's outputs: row 16 * (MT * wm + mt) + g + 8 * half, the 8
  // columns 32 * (wn * NB + nb) + 8t ..: tile j's c0 / c2 at column 8t + j,
  // its c1 / c3 at 8t + 4 + j
  auto row_of = [&](int mt, int half) { return 16 * (MT * wm + mt) + g + 8 * half; };
  auto col_of = [&](int nb) { return 32 * (wn * NB + nb) + 8 * t; };
  auto values = [&](int mt, int nb, int half, int (&v)[8]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = acc[mt][nb][j][2 * half];
      v[4 + j] = acc[mt][nb][j][2 * half + 1];
    }
  };
  // Split-K in the cluster: the tile's rows x BN int32 sums in `splits`
  // chunks of whole int4s, chunk r summed by block r.  Each consumer
  // thread writes its sums into their owner's receive buffer (this
  // block's slot), then one cluster barrier, then each block sums its
  // chunk's slots in rank order and applies the epilogue.
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int rows = min(BM, p.M - m0);
  const int n_out = rows * BN;
  const int chunk = (n_out / 4 + splits - 1) / splits * 4;
  int* const recv = reinterpret_cast<int*>(base_ptr + T::kRecv);
  cluster_wait();
  if (splits == 1) {
    if (warp < T::kConsumers) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            int v[8];
            values(mt, nb, half, v);
            store8(p, m0 + row_of(mt, half), n0 + col_of(nb), v);
          }
    }
    return;
  }
  if (warp < T::kConsumers) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int lm = row_of(mt, half);
        if (lm >= rows) continue;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          int v[8];
          values(mt, nb, half, v);
#pragma unroll
          for (int h4 = 0; h4 < 2; ++h4) {
            const int e = lm * BN + col_of(nb) + 4 * h4;
            const int owner = e / chunk;
            int* const slot =
                cluster.map_shared_rank(recv, owner) + rank * chunk + (e - owner * chunk);
            *reinterpret_cast<int4*>(slot) =
                make_int4(v[4 * h4], v[4 * h4 + 1], v[4 * h4 + 2], v[4 * h4 + 3]);
          }
        }
      }
  }
  cluster_arrive();
  cluster_wait();
  const int c_begin = rank * chunk;
  const int c_end = min(n_out, c_begin + chunk);
  for (int c = c_begin + 4 * static_cast<int>(threadIdx.x); c < c_end;
       c += 4 * static_cast<int>(blockDim.x)) {
    int v[4] = {0, 0, 0, 0};
    for (int r = 0; r < splits; ++r) {
      const int4 part = *reinterpret_cast<const int4*>(recv + r * chunk + (c - c_begin));
      v[0] += part.x;
      v[1] += part.y;
      v[2] += part.z;
      v[3] += part.w;
    }
    const int m = m0 + c / BN, n = n0 + c % BN;
    const float xsr = p.xs[m];
    const long long o = static_cast<long long>(m) * p.N + n;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (n + u >= p.N) break;
      const float y = epilogue(v[u], xsr, __ldg(p.s + n + u));
      if (p.out_f32) {
        static_cast<float*>(p.out)[o + u] = y;
      } else {
        static_cast<__nv_bfloat16*>(p.out)[o + u] = __float2bfloat16_rn(y);
      }
    }
  }
}

template <int MT, int NB, int WM, int WN, int STAGES, bool kTma>
int launch_tile(const Problem& p, int splits, cudaStream_t stream) {
  using T = Tile<MT, NB, WM, WN, STAGES>;
  CUtensorMap ta{}, tq{};
  if constexpr (kTma) {
    if (!make_map_2d(&ta, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.a, p.K, p.M, p.K, kBK, T::kBM,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
        !make_map_2d(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.q, p.N, p.K, p.N, 128, kBK,
                     CU_TENSOR_MAP_SWIZZLE_128B)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const dim3 grid((p.N + T::kBN - 1) / T::kBN, (p.M + T::kBM - 1) / T::kBM,
                  (p.K + p.k_per_split - 1) / p.k_per_split);
  return launch_cluster(w8a8_kernel<MT, NB, WM, WN, STAGES, kTma>, grid, T::kThreads, T::kSmem,
                        splits, stream, ta, tq, p);
}

// the one tile, "64x128" (ops/int8_matmul.py::W8A8_TILES): four consumer
// warps of 64 rows x 32 columns, three stages, split-K in a cluster
template <bool kTma>
int launch_matmul(const Problem& p, int splits, cudaStream_t stream) {
  return launch_tile<4, 1, 1, 4, 3, kTma>(p, splits, stream);
}

int matmul(const int8_t* xq, const float* xs, const void* q, const void* s, void* out, int M,
           int K, int N, int tile, int splits, int out_f32, cudaStream_t stream) {
  if (M < 1 || K < 1 || N < 1 || tile != 0 || splits < 1 || splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  const int steps = (K + kBK - 1) / kBK;
  const int k_per_split = (steps + splits - 1) / splits * kBK;
  const Problem p{xq, xs, static_cast<const int8_t*>(q), static_cast<const float*>(s), out,
                  M, K, N, k_per_split, out_f32};
  const int used = (K + k_per_split - 1) / k_per_split;  // no split left empty
  // TMA: 16-byte row pitches and addresses
  const bool tma = K % 16 == 0 && N % 16 == 0 && aligned16(xq) && aligned16(q);
  return tma ? launch_matmul<true>(p, used, stream) : launch_matmul<false>(p, used, stream);
}

}  // namespace

// Plain C entry points (loaded with ctypes), one signature for both.  The
// fused one takes x (bf16, or f32 with a_f32 = 1), writes each row's scale
// into xs (M,) f32 and its int8 plane into xq (M, K), scratch the caller
// allocated, with a first kernel, then runs the matmul on them; the
// pre-quantized one takes xq (int8, as x) and its scales xs (M,) f32, and
// its xq argument is unused.  `tile` indexes ops/int8_matmul.py::W8A8_TILES
// (0, the one tile); with splits > 1 the K steps are shared by a cluster
// of `splits` blocks (at most 8) a tile, summed in the cluster.  Launch on
// `stream`, do not synchronise, allocate nothing, and return a
// cudaError_t.
extern "C" int w8a8_matmul_fused(const void* x, void* xq, void* xs, const void* q,
                                 const void* s, void* out, int M, int K, int N, int a_f32,
                                 int tile, int splits, int out_f32, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = K % 8 == 0 && aligned16(x);
  if (a_f32) {
    quantize_rows<float><<<M, kRowThreads, 0, st>>>(static_cast<const float*>(x),
                                                   static_cast<int8_t*>(xq),
                                                   static_cast<float*>(xs), K, vec);
  } else {
    quantize_rows<__nv_bfloat16><<<M, kRowThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq), static_cast<float*>(xs),
        K, vec);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return matmul(static_cast<const int8_t*>(xq), static_cast<const float*>(xs), q, s, out, M, K,
                N, tile, splits, out_f32, st);
}

extern "C" int w8a8_matmul_prequantized(const void* xq, void*, void* xs, const void* q,
                                        const void* s, void* out, int M, int K, int N, int,
                                        int tile, int splits, int out_f32, void* stream) {
  return matmul(static_cast<const int8_t*>(xq), static_cast<const float*>(xs), q, s, out, M, K,
                N, tile, splits, out_f32, static_cast<cudaStream_t>(stream));
}
