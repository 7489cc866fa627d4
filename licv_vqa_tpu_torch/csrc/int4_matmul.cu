// Weight-only int4 matmul (W4A16) for Hopper (sm_90a): bf16 activations
// times a nibble-packed int4 weight with group-wise bf16 scales.
//
// Replaces: licv_vqa_tpu/ops/int4_matmul.py::int4_matmul_pallas (_kernel),
// the decode-step matmul of lmm.quantize=int4.  Computes y = x @ dequant(w)
// for the JAX package's layout (ops/quantize.py::quantize_array_int4),
// unchanged:
// - packed is (K/2, N) uint8, N contiguous; byte (i, n) holds in-feature i
//   in its low nibble as q_lo + 8, and in-feature i + K/2 in its high
//   nibble as two's-complement q_hi;
// - s is (K/G, N) bf16: one scale per (group of G in-features in original
//   order, column); G divides K/2, so a group never straddles the planes.
// x is (M, K) bf16, y is (M, N) bf16 or f32; all contiguous.
//
// The TPU kernel decodes the nibbles with masks alone (Mosaic legalizes no
// 8-bit shifts), leaving the low plane biased by +8 and the high plane
// scaled by 16, and corrects both outside the kernel: a second matmul for
// the +8 and pre-divided high-plane scales.  Here both planes decode to
// their signed values in registers (a mask and, for the high plane, a
// shift; then the exact 2^23 mantissa trick), so neither correction has a
// counterpart.  Each weight is q * s in f32 (exact: a 4-bit integer times
// a bf16 scale) and accumulates in f32.
//
// What bounds it on the H100: at decode shapes it reads half a byte per
// weight plus the scales (23.9 MB at K=4096, N=11008: 7.2 us at 3.35 TB/s)
// and does 2*M flops per weight, far under the compute roof; the unpack
// and the scale multiply are the other cost, a few integer and float
// operations per weight.  Thread layout and split-K: quant_common.cuh.  A
// simple kernel first: CUDA-core FMAs, no tensor cores, no TMA.
#include "quant_common.cuh"

namespace {

using namespace quant;

struct Int4Op {
  static constexpr int kPlanes = 2;  // a packed row feeds in-features i and i + K/2
  // the activation plane the low nibbles multiply (in-features i < K/2)
  static constexpr int kLoPlane = 0;
  // 2^23 + 8: a nibble brought to q + 8 in 0..15 reads 2^23 + q + 8 in the
  // mantissa, so this subtraction leaves q (low nibble: q_lo + 8 as
  // stored; high nibble: two's complement, its sign bit flipped)
  static constexpr float kLoMagic = 8388616.f;
  static constexpr float kHiMagic = 8388616.f;
  const uint8_t* packed;
  const __nv_bfloat16* s;
  int N;
  int plane_offset;  // K/2: the high plane's activations
  int G;
  int groups_lo;     // K/2 / G: the high plane's first group

  // this lane's scales of the current group, per plane
  template <int VEC>
  struct State {
    float sl[VEC], sh[VEC];
    int g = -1;
  };

  __device__ __forceinline__ const uint8_t* row(int k) const {
    return packed + static_cast<long long>(k) * N;
  }

  // the group scales are applied per weight
  __device__ __forceinline__ float scale(int) const { return 1.f; }

  // acc[m][j] += x[m, k] * w[k, n0 + j] + x[m, k + K/2] * w[k + K/2, n0 + j],
  // four packed bytes of a word at a time
  template <int VEC, int MT>
  __device__ __forceinline__ void accumulate(const uint32_t* raw, int k, int n0,
                                             const float (&xs)[kPlanes][MT][kChunk], int r,
                                             int mt, State<VEC>& st,
                                             float (&acc)[MT][VEC]) const {
    const int g = k / G;
    if (g != st.g) {
      st.g = g;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        st.sl[j] = __bfloat162float(s[static_cast<long long>(g) * N + n0 + j]);
        st.sh[j] = __bfloat162float(s[static_cast<long long>(g + groups_lo) * N + n0 + j]);
      }
    }
    float wl[VEC], wh[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const uint32_t l = raw[j / 4] & 0x0F0F0F0Fu;
      const uint32_t h = ((raw[j / 4] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
      wl[j] = (magic_byte(l, j % 4) - kLoMagic) * st.sl[j];
      wh[j] = (magic_byte(h, j % 4) - kHiMagic) * st.sh[j];
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < mt) {
        const float xl = xs[kLoPlane][m][r];
        const float xh = xs[1 - kLoPlane][m][r];
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[m][j] = fmaf(xl, wl[j], fmaf(xh, wh[j], acc[m][j]));
      }
    }
  }
};

}  // namespace

// Plain C entry point (loaded with ctypes).  `vec` is the widest of 8, 4,
// 2, 1 bytes that divides N and packed's address; `splits` blocks share
// each tile's K/2 packed rows (rows_per_split each); with splits > 1,
// `partial` is an f32 (splits, M, N) scratch from the wrapper, summed into
// `out` by a second kernel on the same stream.  Launches on `stream`, does
// not synchronise, allocates nothing, and returns cudaGetLastError().
extern "C" int int4_matmul_bf16(const void* x, const void* packed, const void* s, void* out,
                                void* partial, int M, int K, int N, int G, int vec, int splits,
                                int rows_per_split, int out_f32, void* stream) {
  const Int4Op op{static_cast<const uint8_t*>(packed), static_cast<const __nv_bfloat16*>(s),
                  N, K / 2, G, K / 2 / G};
  const Problem p{static_cast<const __nv_bfloat16*>(x), out, static_cast<float*>(partial),
                  M, K, N, K / 2, rows_per_split, splits, out_f32};
  return launch(op, p, vec, static_cast<cudaStream_t>(stream));
}
