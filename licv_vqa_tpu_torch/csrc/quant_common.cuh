// The skeleton shared by the quantized-weight matmul kernels
// (int8_matmul.cu, int4_matmul.cu): y = x @ dequant(w) for M activation
// rows (decode shapes: M <= 64) against a (rows, N) byte plane with N
// contiguous.  Each kernel file supplies an Op that says how a weight byte
// widens and where its activations are; everything else is here.
//
// Layout:
// - one block of 8 warps owns a tile of 32 * VEC output columns and a
//   chunk of MT activation rows (blockIdx.x, blockIdx.y); lane l owns
//   columns [l * VEC, (l + 1) * VEC) of the tile and reads them with one
//   VEC-byte load per weight row, so a warp's load is one contiguous
//   stretch of a row;
// - blockIdx.z splits the weight rows across blocks (split-K), so that
//   small-M, small-N shapes still launch about two blocks per SM.  Inside a
//   block, warp w takes rows w, w + 8, w + 16, ... and issues kU row loads
//   before it uses any: at decode shapes each thread has only a few rows,
//   so the time is memory latency unless the loads overlap;
// - the activations of a chunk of rows are staged in shared memory as f32
//   and read by broadcast; every weight byte is read from device memory
//   once per row chunk and widened in registers; accumulation is f32;
// - with split-K, every block writes its partial tile to the caller's
//   (splits, M, N) f32 scratch and a second small kernel, launched right
//   after on the same stream, sums the partials into the output.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace quant {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 256;  // weight rows per staged activation chunk
constexpr int kU = 8;        // row loads in flight per thread

// 2^23 as a float's bits: a byte b placed in the low mantissa bits reads
// 2^23 + b, so one subtraction recovers b (or b minus a bias) exactly.
constexpr uint32_t kMagic = 0x4B000000u;

// byte j (0..3) of w in the low mantissa bits of 2^23
__device__ __forceinline__ float magic_byte(uint32_t w, int j) {
  return __uint_as_float(__byte_perm(w, kMagic, 0x7440 | j));
}

// VEC (1, 2, 4 or 8) bytes at p, VEC-byte aligned, as 32-bit words (byte j
// of the run is byte j % 4 of word j / 4)
template <int VEC>
__device__ __forceinline__ void load_raw(const uint8_t* p, uint32_t* w) {
  if constexpr (VEC == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  } else if constexpr (VEC == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (VEC == 2) {
    w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    w[0] = __ldg(p);
  }
}

__device__ __forceinline__ void store_out(void* out, long long i, float v, int out_f32) {
  if (out_f32) {
    static_cast<float*>(out)[i] = v;
  } else {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  }
}

struct Problem {
  const __nv_bfloat16* x;  // (M, K) activations
  void* out;               // (M, N), bf16 or f32
  float* partial;          // (splits, M, N) scratch when splits > 1
  int M, K, N;
  int rows;                // weight rows (K for int8, K / 2 packed rows for int4)
  int rows_per_split, splits, out_f32;
};

template <class Op, int VEC, int MT>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const Op op, const Problem p) {
  constexpr int kTileN = 32 * VEC;
  constexpr int kWords = (VEC + 3) / 4;
  __shared__ float x_s[Op::kPlanes][MT][kChunk];
  // column (lane, j) of the tile at [m][j][lane]: a warp's stores are
  // consecutive words, free of bank conflicts
  __shared__ float red_s[MT][VEC][32];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kTileN + lane * VEC;
  const bool n_in = n0 < p.N;  // N % VEC == 0: a lane's columns are all in or out
  const int m0 = blockIdx.y * MT;
  const int mt = min(MT, p.M - m0);
  const int k_begin = blockIdx.z * p.rows_per_split;
  const int k_end = min(p.rows, k_begin + p.rows_per_split);

  float acc[MT][VEC];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[m][j] = 0.f;
  typename Op::template State<VEC> st;

  for (int kc = k_begin; kc < k_end; kc += kChunk) {
    const int len = min(kChunk, k_end - kc);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < Op::kPlanes * MT * kChunk; i += kThreads) {
      const int plane = i / (MT * kChunk);
      const int m = (i / kChunk) % MT;
      const int kk = i % kChunk;
      x_s[plane][m][kk] =
          (m < mt && kk < len)
              ? __bfloat162float(p.x[static_cast<long long>(m0 + m) * p.K +
                                     plane * op.plane_offset + kc + kk])
              : 0.f;
    }
    __syncthreads();
    if (!n_in) continue;
    for (int r0 = warp; r0 < len; r0 += kWarps * kU) {
      uint32_t raw[kU][kWords];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int r = r0 + u * kWarps;
        if (r < len) load_raw<VEC>(op.row(kc + r) + n0, raw[u]);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int r = r0 + u * kWarps;
        if (r < len) op.template accumulate<VEC, MT>(raw[u], kc + r, n0, x_s, r, mt, st, acc);
      }
    }
  }

  // sum the 8 warps' partial sums in shared memory, one warp at a time
  for (int wi = 0; wi < kWarps; ++wi) {
    if (warp == wi && n_in) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          red_s[m][j][lane] = (wi == 0 ? 0.f : red_s[m][j][lane]) + acc[m][j];
    }
    __syncthreads();
  }

  const long long mn = static_cast<long long>(p.M) * p.N;
  for (int i = threadIdx.x; i < MT * kTileN; i += kThreads) {
    const int m = i / kTileN;
    const int c = i % kTileN;
    const int n = blockIdx.x * kTileN + c;
    if (m >= mt || n >= p.N) continue;
    const long long o = static_cast<long long>(m0 + m) * p.N + n;
    const float v = red_s[m][c % VEC][c / VEC] * op.scale(n);
    if (p.splits == 1) {
      store_out(p.out, o, v, p.out_f32);
    } else {
      p.partial[blockIdx.z * mn + o] = v;
    }
  }
}

// out[i] = sum over the splits of partial[split, i], i over the M * N outputs
__global__ void splitk_reduce(const float* __restrict__ partial, void* out, long long mn,
                              int splits, int out_f32) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < mn;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float v = 0.f;
    for (int sp = 0; sp < splits; ++sp) v += partial[sp * mn + i];
    store_out(out, i, v, out_f32);
  }
}

// Launch with the VEC the wrapper picked and the activation rows per block
// M needs; with split-K, the reduction follows on the same stream
template <class Op, int VEC>
int launch_vec(const Op& op, const Problem& p, cudaStream_t stream) {
  constexpr int kTileN = 32 * VEC;
  const int mt = p.M <= 4 ? 4 : 8;
  const dim3 grid((p.N + kTileN - 1) / kTileN, (p.M + mt - 1) / mt, p.splits);
  if (mt == 4) {
    qmm_kernel<Op, VEC, 4><<<grid, kThreads, 0, stream>>>(op, p);
  } else {
    qmm_kernel<Op, VEC, 8><<<grid, kThreads, 0, stream>>>(op, p);
  }
  if (p.splits > 1) {
    const long long mn = static_cast<long long>(p.M) * p.N;
    const int blocks = static_cast<int>(min((mn + 255) / 256, 4096LL));
    splitk_reduce<<<blocks, 256, 0, stream>>>(p.partial, p.out, mn, p.splits, p.out_f32);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class Op>
int launch(const Op& op, const Problem& p, int vec, cudaStream_t stream) {
  switch (vec) {
    case 8: return launch_vec<Op, 8>(op, p, stream);
    case 4: return launch_vec<Op, 4>(op, p, stream);
    case 2: return launch_vec<Op, 2>(op, p, stream);
    case 1: return launch_vec<Op, 1>(op, p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace quant
