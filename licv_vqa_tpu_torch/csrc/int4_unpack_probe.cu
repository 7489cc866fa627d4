// The int4 unpack-schedule probe for Hopper (sm_90a): four ways to widen a
// nibble-packed int4 weight, at a decode-step matmul.
//
// Replaces: tools/exp_int4_unpack.py::make_fn (the Pallas kernel with its
// `body_a`, `body_d`, `body_e`, `body_f`), a probe beside the int4 decode
// kernel (csrc/int4_matmul.cu, which stays as it is).  Each instantiation
// computes y (M, N) f32 = bf16(x) @ (decode(packed) * s) as its JAX body
// does, rounding where that body rounds:
// - packed (K/2, N) uint8, N contiguous: byte (i, n) holds in-feature i in
//   its low nibble and in-feature i + K/2 in its high nibble;
// - s (K/G, N) f32: one scale per group of G in-features (original order)
//   and column; G divides K/2, so a group never straddles the planes.
// Schedules:
// - a (body_a): both nibbles biased (q + 8); int mask and shift, -8, an
//   f32 scale, w = q * s in f32;
// - d (body_d): both biased; the byte to a float without the -8, a bf16
//   scale, w = bf16((q + 8) * s), and the bias corrected in the kernel:
//   - 8 * sum_g bf16(sum of the group's x) * s, per plane;
// - e (body_e): signed nibbles (two's complement), sign-extended by
//   arithmetic shifts; a bf16 scale, w = bf16(q * s);
// - f (body_f): the mixed-plane layout of ops/quantize.py: the low nibble
//   biased, the high one `u & 0xF0` as int8 = 16 * q, with the high
//   plane's scales divided by 16 beforehand; w = bf16 products as in d,
//   without d's correction: the caller subtracts 8 * x_lo-group-sums @ s_lo
//   outside the kernel (ops/int4_unpack_probe.py), as JAX's f_full does
//   outside Pallas.
// The sum of x * w is f32 (fmaf).  d's group sums are taken in f64, exact
// for bf16 inputs whatever the order, then rounded to f32 and to bf16.
//
// What bounds it on the H100: at (8, 4096, 11008) it reads 22.5 MB of
// packed weights and 2.8 MB of f32 scales and does 2*M flops per weight,
// far under the compute roof: the bound is the bytes over 3.35 TB/s.  The
// design streams each weight byte once per chunk of 8 activation rows,
// four bytes (four columns) a lane, eight row loads in flight a thread,
// with the activations of the block's rows staged in shared memory as f32
// and the K rows split across blocks (f32 partials summed by a second
// kernel).  CUDA-core FMAs; no tensor cores, no TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = 8;           // activation rows per block
constexpr int kMaxRows = 256;    // packed rows per split, at most
constexpr int kMaxGroups = 32;   // groups per split and plane, at most (G >= 8)
constexpr int kU = 8;            // row loads in flight per thread
constexpr int kTileN = 128;      // columns per block: four a lane

enum Schedule : int { kA = 0, kD = 1, kE = 2, kF = 3 };

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the group scale as the schedule multiplies by it: f32 for a, bf16 else
template <int S>
__device__ __forceinline__ float group_scale(float v) {
  return S == kA ? v : bf16r(v);
}

// one packed byte to its two weights (low plane, high plane)
template <int S>
__device__ __forceinline__ void decode(uint32_t b, float sl, float sh, float& wl, float& wh) {
  if constexpr (S == kA) {
    wl = __fmul_rn(static_cast<float>(static_cast<int>(b & 15u) - 8), sl);
    wh = __fmul_rn(static_cast<float>(static_cast<int>(b >> 4) - 8), sh);
  } else if constexpr (S == kD) {
    wl = bf16r(__fmul_rn(static_cast<float>(b & 15u), sl));
    wh = bf16r(__fmul_rn(static_cast<float>(b >> 4), sh));
  } else if constexpr (S == kE) {
    const int lo = static_cast<int8_t>(b << 4) >> 4, hi = static_cast<int8_t>(b) >> 4;
    wl = bf16r(__fmul_rn(static_cast<float>(lo), sl));
    wh = bf16r(__fmul_rn(static_cast<float>(hi), sh));
  } else {
    wl = bf16r(__fmul_rn(static_cast<float>(b & 15u), sl));
    wh = bf16r(__fmul_rn(static_cast<float>(static_cast<int8_t>(b & 0xF0u)), sh));
  }
}

struct Args {
  const __nv_bfloat16* x;  // (M, K)
  const uint8_t* packed;   // (K/2, N)
  const float* s;          // (K/G, N)
  float* out;              // (M, N), or the (splits, M, N) partials
  int M, K, N, G, rows_per_split, splits;
};

template <int S>
__global__ void __launch_bounds__(kThreads) probe_kernel(const Args p) {
  __shared__ float x_s[2][kMT][kMaxRows];
  __shared__ float gs_s[2][kMT][kMaxGroups];  // d: bf16-rounded group sums
  __shared__ float red_s[kMT][4][32];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k2 = p.K / 2;
  const int n0 = blockIdx.x * kTileN + lane * 4;
  const bool n_in = n0 < p.N;  // N % 4 == 0: a lane's columns are all in or out
  const int k_begin = blockIdx.y * p.rows_per_split;
  const int len = min(p.rows_per_split, k2 - k_begin);
  const int m0 = blockIdx.z * kMT;
  const int mt = min(kMT, p.M - m0);
  const int groups = len / p.G;
  const int g_hi = k2 / p.G;  // the high plane's first group

  for (int i = threadIdx.x; i < 2 * kMT * kMaxRows; i += kThreads) {
    const int plane = i / (kMT * kMaxRows), m = (i / kMaxRows) % kMT, r = i % kMaxRows;
    x_s[plane][m][r] = m < mt && r < len
        ? __bfloat162float(p.x[static_cast<long long>(m0 + m) * p.K + plane * k2 + k_begin + r])
        : 0.f;
  }
  __syncthreads();
  if constexpr (S == kD) {
    for (int i = threadIdx.x; i < 2 * kMT * groups; i += kThreads) {
      const int plane = i / (kMT * groups), m = (i / groups) % kMT, gi = i % groups;
      double sum = 0.0;
      for (int r = gi * p.G; r < (gi + 1) * p.G; ++r) sum += x_s[plane][m][r];
      gs_s[plane][m][gi] = bf16r(static_cast<float>(sum));
    }
  }

  float acc[kMT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
  float sl[4], sh[4];
  int g_cur = -1;
  if (n_in) {
    for (int r0 = warp; r0 < len; r0 += kWarps * kU) {
      uint32_t raw[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int r = r0 + u * kWarps;
        raw[u] = r < len ? __ldg(reinterpret_cast<const uint32_t*>(
                               p.packed + static_cast<long long>(k_begin + r) * p.N + n0))
                         : 0u;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int r = r0 + u * kWarps;
        if (r >= len) break;
        const int g = (k_begin + r) / p.G;
        if (g != g_cur) {
          g_cur = g;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sl[j] = group_scale<S>(p.s[static_cast<long long>(g) * p.N + n0 + j]);
            sh[j] = group_scale<S>(p.s[static_cast<long long>(g + g_hi) * p.N + n0 + j]);
          }
        }
        float wl[4], wh[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) decode<S>((raw[u] >> (8 * j)) & 0xFFu, sl[j], sh[j], wl[j], wh[j]);
#pragma unroll
        for (int m = 0; m < kMT; ++m) {
          const float xl = x_s[0][m][r], xh = x_s[1][m][r];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xl, wl[j], fmaf(xh, wh[j], acc[m][j]));
        }
      }
    }
  }

  // the 8 warps' sums, one warp at a time
  for (int wi = 0; wi < kWarps; ++wi) {
    if (warp == wi && n_in) {
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          red_s[m][j][lane] = (wi == 0 ? 0.f : red_s[m][j][lane]) + acc[m][j];
    }
    __syncthreads();
  }

  const long long mn = static_cast<long long>(p.M) * p.N;
  for (int i = threadIdx.x; i < kMT * kTileN; i += kThreads) {
    const int m = i / kTileN, c = i % kTileN;
    const int n = blockIdx.x * kTileN + c;
    if (m >= mt || n >= p.N) continue;
    float v = red_s[m][c % 4][c / 4];
    if constexpr (S == kD) {
      float corr_lo = 0.f, corr_hi = 0.f;
      const int g0 = k_begin / p.G;
      for (int gi = 0; gi < groups; ++gi) {
        corr_lo = fmaf(gs_s[0][m][gi], bf16r(p.s[static_cast<long long>(g0 + gi) * p.N + n]),
                       corr_lo);
        corr_hi = fmaf(gs_s[1][m][gi],
                       bf16r(p.s[static_cast<long long>(g0 + gi + g_hi) * p.N + n]), corr_hi);
      }
      v = v - 8.f * corr_lo - 8.f * corr_hi;
    }
    const long long o = static_cast<long long>(m0 + m) * p.N + n;
    p.out[(p.splits > 1 ? blockIdx.y * mn : 0) + o] = v;
  }
}

// out[i] = sum over the splits of partial[split, i]
__global__ void sum_splits(const float* __restrict__ partial, float* __restrict__ out,
                           long long mn, int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < mn;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float v = 0.f;
    for (int sp = 0; sp < splits; ++sp) v += partial[sp * mn + i];
    out[i] = v;
  }
}

template <int S>
int launch(const Args& p, float* out, cudaStream_t stream) {
  const dim3 grid((p.N + kTileN - 1) / kTileN, p.splits, (p.M + kMT - 1) / kMT);
  probe_kernel<S><<<grid, kThreads, 0, stream>>>(p);
  if (p.splits > 1) {
    const long long mn = static_cast<long long>(p.M) * p.N;
    const int blocks = static_cast<int>(min((mn + 255) / 256, 4096LL));
    sum_splits<<<blocks, 256, 0, stream>>>(p.out, out, mn, p.splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes).  schedule: 0 = a, 1 = d, 2 = e,
// 3 = f.  The wrapper checks the shapes: N % 4 == 0, 8 <= G, G divides K/2
// and rows_per_split (a multiple of G, at most 256); with splits > 1,
// `partial` is an f32 (splits, M, N) scratch, summed into `out` by a
// second kernel on the same stream.  Launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError().
extern "C" int int4_unpack_probe(const void* x, const void* packed, const void* s, void* out,
                                 void* partial, int M, int K, int N, int G, int rows_per_split,
                                 int splits, int schedule, void* stream) {
  if (G < 8 || rows_per_split > kMaxRows || rows_per_split % G != 0 ||
      rows_per_split / G > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args p{static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
               static_cast<const float*>(s),
               splits > 1 ? static_cast<float*>(partial) : static_cast<float*>(out),
               M, K, N, G, rows_per_split, splits};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (schedule) {
    case kA: return launch<kA>(p, o, st);
    case kD: return launch<kD>(p, o, st);
    case kE: return launch<kE>(p, o, st);
    case kF: return launch<kF>(p, o, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
