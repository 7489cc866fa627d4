// Weight-only int8 matmul (W8A16) for Hopper (sm_90a): bf16 activations
// times an int8 weight with per-output-column f32 scales.
//
// Replaces: licv_vqa_tpu/ops/int8_matmul.py::int8_matmul_pallas (_kernel),
// the decode-step matmul of lmm.quantize=int8.  Computes what the TPU
// kernel computes,
//     y[m, n] = (sum_k x[m, k] * q[k, n]) * s[n],
// with an f32 accumulator and y in bf16 or f32.  x is (M, K) bf16, q is
// (K, N) int8 row-major (N contiguous), s is (N,) f32; all contiguous.
//
// What bounds it on the H100: at decode shapes (M = 1..64 rows, K, N =
// 4096..32002) it does 2*M flops per weight byte, far under the ~295 the
// card needs to be compute-bound, so the bound is the weight bytes over
// 3.35 TB/s (5.0 us for 4096x4096).  The design streams each weight byte
// from device memory once per chunk of activation rows, with up to 8-byte
// loads and eight rows in flight per thread, widens it in registers
// (exact byte -> float through the 2^23 mantissa trick: a permute and a
// subtraction, no conversion instruction) and applies the column scale
// once to the sum.  Thread layout and split-K: quant_common.cuh.  A simple
// kernel first: CUDA-core FMAs, no tensor cores, no TMA.
#include "quant_common.cuh"

namespace {

using namespace quant;

struct Int8Op {
  static constexpr int kPlanes = 1;  // one activation per weight row
  const int8_t* q;
  const float* s;
  int N;
  int plane_offset;  // unused: one plane

  template <int VEC>
  struct State {};

  __device__ __forceinline__ const uint8_t* row(int k) const {
    return reinterpret_cast<const uint8_t*>(q) + static_cast<long long>(k) * N;
  }

  // the per-column scale, applied once to each column's sum
  __device__ __forceinline__ float scale(int n) const { return s[n]; }

  // acc[m][j] += x[m, k] * q[k, n0 + j], four bytes of a word at a time:
  // flipping each byte's sign bit biases it to v + 128, then 2^23 + 128 is
  // subtracted
  template <int VEC, int MT>
  __device__ __forceinline__ void accumulate(const uint32_t* raw, int, int,
                                             const float (&xs)[kPlanes][MT][kChunk], int r,
                                             int mt, State<VEC>&, float (&acc)[MT][VEC]) const {
    float w[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) w[j] = magic_byte(raw[j / 4] ^ 0x80808080u, j % 4) - 8388736.f;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < mt) {
        const float xv = xs[0][m][r];
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
      }
    }
  }
};

}  // namespace

// Plain C entry point (loaded with ctypes).  `vec` is the widest of 8, 4,
// 2, 1 bytes that divides N and q's address; `splits` blocks share each
// tile's K rows (rows_per_split each); with splits > 1, `partial` is an f32
// (splits, M, N) scratch from the wrapper, summed into `out` by a second
// kernel on the same stream.  Launches on `stream`, does not synchronise,
// allocates nothing, and returns cudaGetLastError().
extern "C" int int8_matmul_bf16(const void* x, const void* q, const void* s, void* out,
                                void* partial, int M, int K, int N, int vec, int splits,
                                int rows_per_split, int out_f32, void* stream) {
  const Int8Op op{static_cast<const int8_t*>(q), static_cast<const float*>(s), N, 0};
  const Problem p{static_cast<const __nv_bfloat16*>(x), out, static_cast<float*>(partial),
                  M, K, N, K, rows_per_split, splits, out_f32};
  return launch(op, p, vec, static_cast<cudaStream_t>(stream));
}
