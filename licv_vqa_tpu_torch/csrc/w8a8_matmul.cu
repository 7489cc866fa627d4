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
// point; q is (K, N) int8 with N contiguous (the port's weight layout);
// s is (N,) f32; all contiguous.  Any M, K, N: ragged tiles are masked.
//
// What bounds it on the H100: at the prefill shapes (M = 64 to 16384
// rows, K and N 1280 to 11008) it does 2*M*K*N int8 operations against
// M*K*2 + K*N bytes.  At run A's M = 64 that is about 128 operations a
// byte, under the ~590 the card needs to be compute-bound at 1979 TOP/s:
// the bound is the weight bytes over 3.35 TB/s, and the work is to keep
// enough loads in flight.  From M = 1024 up the bound is the int8
// tensor-core rate.  A simple kernel first: `mma.sync.m16n8k32` s8 tiles
// from shared memory, an int32 accumulator in registers; no TMA, no
// `wgmma` (later work).
//
// Design:
// - a block of 4 or 8 warps owns a BM x BN tile of y (64 x 64 or 128 x
//   128) and walks its K range in steps of 64 bytes; each warp owns a
//   sub-tile, its fragments loaded with `ldmatrix.x4`;
// - one stage of shared memory, with the next step's tiles loaded into
//   registers while the current step's products run;
// - the mma's B operand wants K contiguous per column, but q has N
//   contiguous, and `ldmatrix.trans` moves 16-bit elements only: q is
//   transposed while it is staged, a 4 x 4 block of bytes a thread (four
//   32-bit loads from four rows, byte permutes, four 32-bit stores into
//   the column-major tile);
// - split-K where the tiles alone would leave SMs idle (M = 64): the
//   blocks of a tile add their int32 sums into a zeroed (M, N) scratch
//   with atomics, exact in any order, and a last kernel applies the
//   epilogue;
// - the fused entry point needs each row's absmax over the whole K before
//   any tile is quantized (the TPU kernel held the whole (mt, K) block in
//   VMEM; a 64 x 11008 bf16 block is 1.4 MB, shared memory 227 KB).  A
//   first kernel sweeps each row once (one warp a row) and writes the row
//   scales; the matmul kernel quantizes every K tile of x as it stages it.
//   (Sweeping the rows in every block instead read them again for every
//   column block and K split: 197 against 49 us for the pre-quantized
//   kernel at (64, 11008, 4096) on the H100.)  The quotient v / scale is
//   taken as v * (1 / scale), with the IEEE division where that product
//   lies near a half-integer, so the rounding is the division's;
// - staged rows are padded to 80 bytes, so the eight 16-byte rows an
//   `ldmatrix` reads fall in distinct banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBK = 64;               // K bytes staged per step: two mma k-steps
constexpr int kRowBytes = kBK + 16;   // a staged row with its padding
constexpr float kInv127 = 1.0f / 127.0f;  // f32(1/127), as XLA folds a / 127

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

// four int8 bytes at p (in one row); `vec`: aligned and all in the row
__device__ __forceinline__ uint32_t load_bytes(const int8_t* p, bool vec, int cnt) {
  if (vec) return __ldg(reinterpret_cast<const uint32_t*>(p));
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < cnt) w |= static_cast<uint32_t>(static_cast<uint8_t>(p[j])) << (8 * j);
  return w;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the epilogue of one int32 sum: (float(acc) * xs) * s, each rounded
__device__ __forceinline__ float epilogue(int c, float xsr, float sc) {
  return __fmul_rn(__fmul_rn(__int2float_rn(c), xsr), sc);
}

__device__ __forceinline__ void store_out(void* out, long long o, float v, int out_f32) {
  if (out_f32) {
    static_cast<float*>(out)[o] = v;
  } else {
    static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
  }
}

// four 8 x 16-byte matrices from shared memory, one per register
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const int8_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// four activations as loaded (before quantization): the raw bytes of the
// input type
template <class T> struct Raw4;
template <> struct Raw4<int8_t> { uint32_t v; };
template <> struct Raw4<__nv_bfloat16> { uint2 v; };
template <> struct Raw4<float> { float4 v; };

template <class T>
__device__ __forceinline__ Raw4<T> load_raw4(const T* p, bool vec, int cnt) {
  Raw4<T> r;
  if constexpr (std::is_same<T, int8_t>::value) {
    r.v = load_bytes(p, vec, cnt);
  } else if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      r.v = __ldg(reinterpret_cast<const float4*>(p));
    } else {
      r.v.x = cnt > 0 ? p[0] : 0.f;
      r.v.y = cnt > 1 ? p[1] : 0.f;
      r.v.z = cnt > 2 ? p[2] : 0.f;
      r.v.w = cnt > 3 ? p[3] : 0.f;
    }
  } else {
    if (vec) {
      r.v = __ldg(reinterpret_cast<const uint2*>(p));
    } else {
      const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
      const uint32_t e0 = cnt > 0 ? h[0] : 0u, e1 = cnt > 1 ? h[1] : 0u;
      const uint32_t e2 = cnt > 2 ? h[2] : 0u, e3 = cnt > 3 ? h[3] : 0u;
      r.v.x = e0 | (e1 << 16);
      r.v.y = e2 | (e3 << 16);
    }
  }
  return r;
}

__device__ __forceinline__ void raw_floats(const Raw4<float>& r, float (&v)[4]) {
  v[0] = r.v.x; v[1] = r.v.y; v[2] = r.v.z; v[3] = r.v.w;
}
__device__ __forceinline__ void raw_floats(const Raw4<__nv_bfloat16>& r, float (&v)[4]) {
  v[0] = __uint_as_float(r.v.x << 16); v[1] = __uint_as_float(r.v.x & 0xFFFF0000u);
  v[2] = __uint_as_float(r.v.y << 16); v[3] = __uint_as_float(r.v.y & 0xFFFF0000u);
}

// The fused entry point's first kernel: one warp a row sweeps the whole K
// once, xs[m] = max(absmax, 1e-8) * f32(1/127)
template <class T>
__global__ void row_scales(const T* __restrict__ x, float* __restrict__ xs, int M, int K,
                           int a_vec) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (r >= M) return;
  const T* row = x + static_cast<long long>(r) * K;
  const int k_end = K;  // the absmax runs over the whole row
  float mx = 0.f;
  if (a_vec) {
    for (int k = lane * 4; k < k_end; k += 128) {
      float v[4];
      raw_floats(load_raw4(row + k, true, 4), v);
      mx = fmaxf(mx, fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3]))));
    }
  } else {
    for (int k = lane; k < k_end; k += 32) mx = fmaxf(mx, fabsf(to_f32(row[k])));
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
  if (lane == 0) xs[r] = __fmul_rn(fmaxf(mx, 1e-8f), kInv127);
}

// TA: int8_t (pre-quantized) or __nv_bfloat16 or float (fused: each K tile
// quantized as it is staged); xs holds the row scales either way.  With
// split-K (acc_out != nullptr) the blocks of blockIdx.z add their int32
// sums into acc_out and `finish` applies the epilogue.
template <class TA, int BM, int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
w8a8_kernel(const TA* __restrict__ a, const float* __restrict__ xs,
            const int8_t* __restrict__ q, const float* __restrict__ s, void* __restrict__ out,
            int* __restrict__ acc_out, int M, int K, int N,
            int k_per_split, int a_vec, int q_vec, int out_f32) {
  constexpr bool kFused = !std::is_same<TA, int8_t>::value;
  constexpr int kWarps = WARPS_M * WARPS_N;
  constexpr int kThreads = 32 * kWarps;
  constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;
  constexpr int MI = WTM / 16, NI = WTN / 8;
  constexpr int kItemsA = BM * (kBK / 4) / kThreads;         // 4 activations each
  constexpr int kItemsB = (kBK / 4) * (BN / 4) / kThreads;   // a 4 x 4 block of bytes each
  static_assert(WTM % 16 == 0 && WTN % 16 == 0 && BN % 32 == 0, "tile");
  static_assert(kItemsA * kThreads == BM * (kBK / 4) && kItemsB * kThreads == kBK * BN / 16,
                "staging");
  __shared__ __align__(16) int8_t a_s[BM * kRowBytes];  // (m, k), k contiguous
  __shared__ __align__(16) int8_t b_s[BN * kRowBytes];  // (n, k), k contiguous
  __shared__ float xs_s[BM];
  __shared__ float inv_s[BM];  // 1 / xs, IEEE rounded

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // the mma fragments' group and thread
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_stop = min(K, k_begin + k_per_split);

  for (int r = tid; r < BM; r += kThreads) {
    xs_s[r] = m0 + r < M ? xs[m0 + r] : 1.f;
    inv_s[r] = __frcp_rn(xs_s[r]);
  }
  __syncthreads();

  // the next tile, held in registers while the current one is multiplied
  Raw4<TA> ra[kItemsA];
  uint32_t rb[kItemsB][4];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int it = 0; it < kItemsA; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / (kBK / 4), gk = k0 + (i % (kBK / 4)) * 4;
      const int cnt = m0 + r < M ? max(0, min(4, k_stop - gk)) : 0;
      ra[it] = load_raw4(a + static_cast<long long>(m0 + r) * K + gk, a_vec && cnt == 4, cnt);
    }
    // eight neighbouring lanes read 32 contiguous bytes of a weight row
#pragma unroll
    for (int it = 0; it < kItemsB; ++it) {
      const int i = tid + it * kThreads;
      const int gn = n0 + ((i / (8 * (kBK / 4))) * 8 + i % 8) * 4;
      const int gk = k0 + ((i / 8) % (kBK / 4)) * 4;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int cnt = gk + kk < k_stop ? min(4, N - gn) : 0;
        rb[it][kk] = cnt > 0 ? load_bytes(q + static_cast<long long>(gk + kk) * N + gn,
                                          q_vec && cnt == 4, cnt)
                             : 0u;
      }
    }
  };
  // quantize (fused) and store A; transpose and store B
  auto store_tile = [&]() {
#pragma unroll
    for (int it = 0; it < kItemsA; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / (kBK / 4), c = (i % (kBK / 4)) * 4;
      uint32_t w;
      if constexpr (kFused) {
        float v[4];
        raw_floats(ra[it], v);
        const float sc = xs_s[r], inv = inv_s[r];
        w = quantize(v[0], sc, inv) | (quantize(v[1], sc, inv) << 8) |
            (quantize(v[2], sc, inv) << 16) | (quantize(v[3], sc, inv) << 24);
      } else {
        w = ra[it].v;
      }
      *reinterpret_cast<uint32_t*>(a_s + r * kRowBytes + c) = w;
    }
#pragma unroll
    for (int it = 0; it < kItemsB; ++it) {
      const int i = tid + it * kThreads;
      const int nc = ((i / (8 * (kBK / 4))) * 8 + i % 8) * 4;
      const int kr = ((i / 8) % (kBK / 4)) * 4;
      const uint32_t lo01 = __byte_perm(rb[it][0], rb[it][1], 0x5140);
      const uint32_t hi01 = __byte_perm(rb[it][0], rb[it][1], 0x7362);
      const uint32_t lo23 = __byte_perm(rb[it][2], rb[it][3], 0x5140);
      const uint32_t hi23 = __byte_perm(rb[it][2], rb[it][3], 0x7362);
      int8_t* dst = b_s + nc * kRowBytes + kr;
      *reinterpret_cast<uint32_t*>(dst) = __byte_perm(lo01, lo23, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + kRowBytes) = __byte_perm(lo01, lo23, 0x7632);
      *reinterpret_cast<uint32_t*>(dst + 2 * kRowBytes) = __byte_perm(hi01, hi23, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + 3 * kRowBytes) = __byte_perm(hi01, hi23, 0x7632);
    }
  };

  int acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  // ldmatrix row addresses: A's four matrices are (rows 0-7 | 8-15) x
  // (k 0-15 | 16-31), B's (n 0-7 | 8-15) x (k 0-15 | 16-31)
  const int a_row = wm * WTM + (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 16;
  const int b_row = wn * WTN + (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 16;

  if (k_begin < k_stop) {
    load_tile(k_begin);
    store_tile();
  }
  __syncthreads();
  for (int k0 = k_begin; k0 < k_stop; k0 += kBK) {
    const bool more = k0 + kBK < k_stop;
    if (more) load_tile(k0 + kBK);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldmatrix_x4(af[mi], a_s + (a_row + mi * 16) * kRowBytes + kk + a_col);
#pragma unroll
      for (int ni = 0; ni < NI; ni += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, b_s + (b_row + ni * 8) * kRowBytes + kk + b_col);
        bf[ni][0] = r[0]; bf[ni][1] = r[1]; bf[ni + 1][0] = r[2]; bf[ni + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
    if (more) {
      store_tile();
      __syncthreads();
    }
  }

  // c[0], c[1] are row g, columns 2t and 2t + 1; c[2], c[3] row g + 8
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lr = wm * WTM + mi * 16 + g + half * 8;
      if (m0 + lr >= M) continue;
      const float xsr = xs_s[lr];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + wn * WTN + ni * 8 + t * 2 + j;
          if (col >= N) continue;
          const int c = acc[mi][ni][half * 2 + j];
          const long long o = static_cast<long long>(m0 + lr) * N + col;
          if (acc_out != nullptr) {
            atomicAdd(acc_out + o, c);  // exact: int32 sums in any order
          } else {
            store_out(out, o, epilogue(c, xsr, s[col]), out_f32);
          }
        }
      }
    }
  }
}

// split-K: the epilogue of the summed int32 tile
__global__ void finish(const int* __restrict__ acc, const float* __restrict__ xs,
                       const float* __restrict__ s, void* __restrict__ out, int M, int N,
                       int out_f32) {
  const long long mn = static_cast<long long>(M) * N;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < mn;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    store_out(out, i, epilogue(acc[i], xs[i / N], s[i % N]), out_f32);
  }
}

template <class TA, int BM, int BN, int WM, int WN>
int launch_tile(const TA* a, float* xs, const int8_t* q, const float* s, void* out, int* acc,
                int M, int K, int N, int splits, int out_f32, cudaStream_t stream) {
  const int a_vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(a) % (4 * sizeof(TA)) == 0;
  const int q_vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0;
  if constexpr (!std::is_same<TA, int8_t>::value) {
    row_scales<TA><<<(M + 7) / 8, 256, 0, stream>>>(a, xs, M, K, a_vec);
  }
  const int steps = (K + kBK - 1) / kBK;
  const int k_per_split = (steps + splits - 1) / splits * kBK;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, (K + k_per_split - 1) / k_per_split);
  const bool split = grid.z > 1;
  w8a8_kernel<TA, BM, BN, WM, WN><<<grid, 32 * WM * WN, 0, stream>>>(
      a, xs, q, s, out, split ? acc : nullptr, M, K, N, k_per_split, a_vec, q_vec, out_f32);
  if (split) {
    const long long mn = static_cast<long long>(M) * N;
    const int blocks = static_cast<int>(min((mn + 255) / 256, 4096LL));
    finish<<<blocks, 256, 0, stream>>>(acc, xs, s, out, M, N, out_f32);
  }
  return static_cast<int>(cudaGetLastError());
}

// tile: 0 = 64 x 64 (4 warps), 1 = 128 x 128 (8 warps); ops/int8_matmul.py::W8A8_TILES
template <class TA>
int launch(const void* a, void* xs, const void* q, const void* s, void* out, void* acc, int M,
           int K, int N, int tile, int splits, int out_f32, void* stream) {
  const TA* av = static_cast<const TA*>(a);
  float* xv = static_cast<float*>(xs);
  const int8_t* qv = static_cast<const int8_t*>(q);
  const float* sv = static_cast<const float*>(s);
  int* accv = static_cast<int*>(acc);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0:
      return launch_tile<TA, 64, 64, 2, 2>(av, xv, qv, sv, out, accv, M, K, N, splits,
                                           out_f32, st);
    case 1:
      return launch_tile<TA, 128, 128, 2, 4>(av, xv, qv, sv, out, accv, M, K, N, splits,
                                             out_f32, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes), one signature for both.  The
// fused one takes x (bf16, or f32 with a_f32 = 1) and writes the row
// scales into xs, an (M,) f32 scratch, with a first kernel; the
// pre-quantized one takes xq (int8) and its scales xs (M,) f32.  With
// splits > 1 the K steps are shared by `splits` blocks a tile, whose int32
// sums go into `acc`, an (M, N) int32 scratch the caller zeroed, and a
// last kernel on the same stream applies the epilogue.  Launch on
// `stream`, do not synchronise, allocate nothing, and return
// cudaGetLastError().
extern "C" int w8a8_matmul_fused(const void* x, void* xs, const void* q, const void* s,
                                 void* out, void* acc, int M, int K, int N, int a_f32, int tile,
                                 int splits, int out_f32, void* stream) {
  return a_f32 ? launch<float>(x, xs, q, s, out, acc, M, K, N, tile, splits, out_f32, stream)
               : launch<__nv_bfloat16>(x, xs, q, s, out, acc, M, K, N, tile, splits, out_f32,
                                       stream);
}

extern "C" int w8a8_matmul_prequantized(const void* xq, void* xs, const void* q,
                                        const void* s, void* out, void* acc, int M, int K,
                                        int N, int, int tile, int splits, int out_f32,
                                        void* stream) {
  return launch<int8_t>(xq, xs, q, s, out, acc, M, K, N, tile, splits, out_f32, stream);
}
