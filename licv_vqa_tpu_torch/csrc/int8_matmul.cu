// Weight-only int8 matmul (W8A16) for Hopper (sm_90a): bf16 activations
// times an int8 weight with per-output-column f32 scales, on the tensor
// cores (mma.sync m16n8k16, bf16 -> f32).
//
// Replaces: licv_vqa_tpu/ops/int8_matmul.py::int8_matmul_pallas (_kernel),
// the decode-step matmul of lmm.quantize=int8.  Computes what the TPU
// kernel computes,
//     y[m, n] = (sum_k x[m, k] * q[k, n]) * s[n],
// with an f32 accumulator and y in bf16 or f32.  x is (M, K) bf16 (any M:
// blocks of 64 rows), q is (K, N) int8 row-major (N contiguous, the JAX
// package's layout, read as it is), s is (N,) f32; all contiguous.
//
// What bounds it on the H100: at decode shapes (M = 1..64 rows, K, N =
// 4096..32002) it does 2*M operations per weight byte, far under the ~295
// the card needs to be compute-bound, so the bound is the weight bytes
// over 3.35 TB/s (5.0 us for 4096x4096).  At M = 3 the kernel only streams
// and has to keep enough bytes in flight on every SM to cover the memory's
// latency.  The design, on the skeleton of csrc/quant_sm90.cuh that the
// int4 kernel shares:
//
// - Weight streaming: a producer warp keeps a ring of 4 stages in flight
//   by TMA, each 64 weight rows x 128 columns (128-byte swizzle) and x's 64
//   columns of the block's rows (128-byte swizzle; rows past M are TMA's
//   zeros, up to the m16 tile); at least two blocks an SM, so at least
//   64 KB in flight an SM at M = 3.
// - Tensor cores with exact operands: every int8 value is exact in bf16.
//   A byte is widened through f32: placed in the low mantissa bits of 2^23
//   (one byte permute, after its sign bit is flipped to bias it by 128) and
//   less 2^23 + 128 (one subtraction), the f32 value of q has zeros in its
//   low 16 bits, so its upper half is q in bf16 and one more permute packs
//   two rows' halves into a B register.  (No single bf16x2 subtraction
//   widens a byte exactly, as int4's decode does a nibble: bf16 keeps 7
//   mantissa bits, so no binade holds 256 consecutive integers.)  So the
//   products are x.q exactly, summed in f32 (mma.sync m16n8k16).
// - B fragments: a thread's 32-bit word of one weight row holds four
//   columns that feed four interleaved n8 tiles (tile j, column c is the
//   warp's column 4c + j); register r of tile j pairs byte j of rows
//   2t + 8r and 2t + 8r + 1.  The four words of a k16 step (rows 2t, 2t+1,
//   2t+8, 2t+9) are free of bank conflicts in the 128-byte swizzle.  At 64
//   rows one warp's four m16 tiles share each B fragment, so a byte is
//   widened once for all of them.
// - x is the A operand (ldmatrix from its swizzled stage).
// - The column scale is applied once, to the summed accumulator, in the
//   epilogue, as the TPU kernel applies it.
// - Split-K in one launch, deterministic: the blocks that share a column
//   tile's K range form a thread-block cluster (at most 8); each block
//   writes its partial tile into the receive buffers of the blocks that own
//   its slices (distributed shared memory), and after one cluster barrier
//   each block sums its slice over the senders in rank order, scales it and
//   writes it.  No atomics, no scratch, no second launch.
// - Shapes TMA does not take (a row pitch N or K*2 that is not a multiple
//   of 16 bytes, e.g. the Idefics-9B head's N = 32002, or unaligned
//   pointers) fill the same stages from two producer warpgroups' plain
//   loads: each lane a 4-byte aligned word of a row, merged with the next
//   lane's by a byte permute that undoes the row's misalignment, one warp
//   instruction a 128-byte row, the next stage's loads in flight while
//   this one is stored.  About 4x slower than TMA at a pitch TMA takes
//   (PERF.md §6): bulk copies of each row and cp.async were no faster.
#include "quant_sm90.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace quant_sm90;

constexpr int kBN = 128;     // columns (bytes) a block
constexpr int kBK = 64;      // weight rows a stage
// 2^23 as an f32's bits: a byte b in its low mantissa bits reads 2^23 + b
constexpr uint32_t kMagic = 0x4B000000u;
constexpr float kMagicBias = 8388736.f;  // 2^23 + 128: the byte was q + 128

struct Problem {
  const __nv_bfloat16* x;  // (M, K)
  const int8_t* q;         // (K, N)
  const float* s;          // (N,)
  void* out;               // (M, N)
  int M, K, N;
  int rows_per_split;      // a multiple of kBK
  int out_f32;
};

// a stage's layout: W (kBK x 128 bytes), then x (MP rows x 64 bf16), both
// 128-byte swizzled
template <int MP>
struct Stage {
  static constexpr int w = 0;
  static constexpr int x = kBK * kBN;
  static constexpr int bytes = (x + MP * 128 + 1023) / 1024 * 1024;
};

// The block: four consumer warps of 32 columns each, MT m16 tiles of rows
// (MP = 16 * MT), a ring of 4 stages, and the producer: one warp for TMA,
// two warpgroups for plain loads.
template <int MT, bool kTma>
struct Shape {
  static constexpr int kMP = 16 * MT;
  static constexpr int kStages = 4;
  static constexpr int kConsumers = 4;
  static constexpr int kProducers = kTma ? 1 : 8;
  static constexpr int kThreads = 32 * (kConsumers + kProducers);
  static constexpr int kRecvFloats = kMP * kBN + 4 * kMaxSplits;
  static constexpr int kRecv = kStages * Stage<kMP>::bytes;
  static constexpr int kBars = kRecv + 4 * kRecvFloats;
  static constexpr int kSmem = kBars + 16 * kStages + 1024;  // + align slack
};

// Rows k and k + 1 (the words w0, w1, sign bits flipped) of byte j's
// column, widened to a bf16x2 B register: f32 2^23 + q + 128, less
// 2^23 + 128, is q exactly with a zero lower half
template <int J>
__device__ __forceinline__ uint32_t widen_pair(uint32_t w0, uint32_t w1) {
  const float lo = __uint_as_float(__byte_perm(w0, kMagic, 0x7440 | J)) - kMagicBias;
  const float hi = __uint_as_float(__byte_perm(w1, kMagic, 0x7440 | J)) - kMagicBias;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);  // row k low, k+1 high
}

// The B fragments of one k16 step: w[0..3] a thread's words of rows 2t,
// 2t+1, 2t+8, 2t+9 (four columns each); tile j takes byte j
__device__ __forceinline__ void widen_fragments(const uint32_t (&w)[4], uint32_t (&b)[4][2]) {
  uint32_t f[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) f[q] = w[q] ^ 0x80808080u;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    b[0][r] = widen_pair<0>(f[2 * r], f[2 * r + 1]);
    b[1][r] = widen_pair<1>(f[2 * r], f[2 * r + 1]);
    b[2][r] = widen_pair<2>(f[2 * r], f[2 * r + 1]);
    b[3][r] = widen_pair<3>(f[2 * r], f[2 * r + 1]);
  }
}

// The plain producer warpgroups' share of a stage (weight rows kb ..):
// warp pw loads rows pw, pw + 8, .. and lane l the 4 bytes at columns 4l ..
// of the tile, as the aligned word at or before them merged with the next
// lane's (rows of any pitch: a byte permute undoes the row's
// misalignment); bytes past N and rows past K read as zeros.  Every load
// of a stage is issued before any is used (`load`), and merged and stored
// once the stage is free (`store`), so the next stage's loads are in flight
// meanwhile.  A word with no byte of q is not read; one with any is, whole
// (an aligned word does not cross a page).  Thread pt loads x's elements
// pt, pt + 256, .. of the stage (rows past M, columns past K: 0).
template <int MP>
struct PlainStage {
  static constexpr int kWarps = 8;
  static constexpr int kRows = kBK / kWarps;
  static constexpr int kXs = MP * 64 / (32 * kWarps);
  uint32_t lo[kRows], last[kRows];  // the lane's word; lane 31: also the next one
  unsigned short x[kXs];

  // a row's tile at column n0 (its address's low 2 bits: the misalignment)
  static __device__ __forceinline__ const uint8_t* tile_of(const Problem& p, int row, int n0) {
    return reinterpret_cast<const uint8_t*>(p.q) + static_cast<long long>(row) * p.N + n0;
  }

  __device__ __forceinline__ void load(const Problem& p, int kb, int n0, int m0, int pw,
                                       int lane) {
    const uint8_t* const q = reinterpret_cast<const uint8_t*>(p.q);
    const uint8_t* const q_end = q + static_cast<long long>(p.K) * p.N;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = kb + pw + kWarps * i;
      const uint8_t* const tile = tile_of(p, row, n0);
      const int o = static_cast<int>(reinterpret_cast<uintptr_t>(tile) & 3);
      const uint8_t* const a = tile - o + 4 * lane;
      const bool in = row < p.K && n0 + 4 * lane - o < p.N;
      lo[i] = in && a + 4 > q ? __ldg(reinterpret_cast<const unsigned int*>(a)) : 0u;
      last[i] = in && lane == 31 && a + 4 < q_end
                    ? __ldg(reinterpret_cast<const unsigned int*>(a + 4)) : 0u;
    }
    const int pt = 32 * pw + lane;
#pragma unroll
    for (int u = 0; u < kXs; ++u) {
      const int e = pt + 32 * kWarps * u;
      const int m = e / 64, c = e % 64;
      x[u] = m0 + m < p.M && kb + c < p.K
                 ? __ldg(reinterpret_cast<const unsigned short*>(p.x) +
                         static_cast<long long>(m0 + m) * p.K + kb + c)
                 : 0;
    }
  }

  __device__ __forceinline__ void store(const Problem& p, uint8_t* d, int kb, int n0, int pw,
                                        int lane) const {
    const int valid = p.N - n0 - 4 * lane;  // of the lane's 4 columns
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int o = static_cast<int>(
          reinterpret_cast<uintptr_t>(tile_of(p, kb + pw + kWarps * i, n0)) & 3);
      uint32_t hi = __shfl_down_sync(0xffffffffu, lo[i], 1);
      if (lane == 31) hi = last[i];
      uint32_t v = __byte_perm(lo[i], hi, 0x3210 + 0x1111 * o);
      v = valid >= 4 ? v : valid <= 0 ? 0u : v & ((1u << (8 * valid)) - 1u);
      *reinterpret_cast<uint32_t*>(d + Stage<MP>::w + swz(pw + kWarps * i, 4 * lane)) = v;
    }
    const int pt = 32 * pw + lane;
#pragma unroll
    for (int u = 0; u < kXs; ++u) {
      const int e = pt + 32 * kWarps * u;
      *reinterpret_cast<unsigned short*>(d + Stage<MP>::x + swz(e / 64, 2 * (e % 64))) = x[u];
    }
  }
};

// two blocks an SM (registers capped to fit), so that at M = 3 about 64 KB
// of stages are in flight an SM
template <int MT, bool kTma>
__global__ void __launch_bounds__(Shape<MT, kTma>::kThreads, 2)
int8_matmul_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tx,
                   const Problem p) {
  using Sh = Shape<MT, kTma>;
  constexpr int MP = Sh::kMP;
  using St = Stage<MP>;
  constexpr int kStages = Sh::kStages;
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
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * MP;
  const int k_begin = blockIdx.z * p.rows_per_split;
  const int k_end = min(p.K, k_begin + p.rows_per_split);
  const int n_stages = (k_end - k_begin + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    if constexpr (kTma) {
      prefetch_map(&tw);
      prefetch_map(&tx);
    }
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), kTma ? 1 : 32 * Sh::kProducers);
      mbar_init(empty(st), Sh::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wc = warp;  // a consumer warp's 32 columns: 32 * wc ..
  const int g = lane / 4, t = lane % 4;
  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  if (warp >= Sh::kConsumers) {
    // the producer; a stage's previous contents released before it is
    // written (the wait passes at once on the first round)
    if constexpr (kTma) {
      for (int i = 0; i < n_stages; ++i) {
        const int st = i % kStages;
        if (lane == 0) {
          const uint32_t dst = base + st * St::bytes;
          const int kb = k_begin + i * kBK;
          mbar_wait(empty(st), ((i / kStages) & 1) ^ 1);
          mbar_expect_tx(full(st), kBK * kBN + MP * 128);
          tma_load_2d(dst + St::w, &tw, full(st), n0, kb);
          tma_load_2d(dst + St::x, &tx, full(st), kb, m0);
        }
      }
    } else {
      // the next stage's loads in flight while this one is stored
      const int pw = warp - Sh::kConsumers;
      PlainStage<MP> cur, nxt;
      cur.load(p, k_begin, n0, m0, pw, lane);
      for (int i = 0; i < n_stages; ++i) {
        const int st = i % kStages;
        if (i + 1 < n_stages) nxt.load(p, k_begin + (i + 1) * kBK, n0, m0, pw, lane);
        mbar_wait(empty(st), ((i / kStages) & 1) ^ 1);
        cur.store(p, base_ptr + st * St::bytes, k_begin + i * kBK, n0, pw, lane);
        mbar_arrive(full(st));  // each thread: its stores are the stage's
        cur = nxt;
      }
    }
  } else {
    // a consumer thread's offsets in a stage: its B words of step 0 (step
    // kk is 2048 * kk further: 16 rows of 128 bytes) and its ldmatrix row
    // address of step kk in the first m16 tile (tile mt 2048 * mt further)
    int ow[4], ox[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) ow[q] = swz(2 * t + (q & 1) + 8 * (q >> 1), 32 * wc + 4 * g);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ox[kk] = swz(lane % 16, 32 * kk + 16 * (lane / 16));
    for (int i = 0; i < n_stages; ++i) {
      const int st = i % kStages;
      const uint8_t* const d = base_ptr + st * St::bytes;
      const uint32_t sd = base + st * St::bytes;
      mbar_wait(full(st), (i / kStages) & 1);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t w[4], b[4][2], a[MT][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          w[q] = *reinterpret_cast<const uint32_t*>(d + St::w + ow[q] + 2048 * kk);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(a[mt], sd + St::x + ox[kk] + 2048 * mt);
        widen_fragments(w, b);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][j], a[mt], b[j]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }
  }

  // Split-K in the cluster: the tile's rows x 128 outputs in `splits`
  // chunks of whole float4s, chunk r summed by block r.  Each consumer
  // thread writes its outputs into their owner's receive buffer (this
  // block's slot), then one cluster barrier, then each block sums its
  // chunk's slots in rank order and applies the column scales.
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int rows = min(MP, p.M - m0);
  const int n_out = rows * kBN;
  const int chunk = (n_out / 4 + splits - 1) / splits * 4;
  cluster_wait();
  if (warp < Sh::kConsumers) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = 16 * mt + g + 8 * r;
        if (m >= rows) continue;
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
    for (int sp = 0; sp < splits; ++sp) {
      const float4 part = *reinterpret_cast<const float4*>(recv + sp * chunk + (c - c_begin));
      v[0] += part.x;
      v[1] += part.y;
      v[2] += part.z;
      v[3] += part.w;
    }
    const int m = m0 + c / kBN, n = n0 + c % kBN;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (n + u >= p.N) break;
      const float y = v[u] * __ldg(p.s + n + u);  // the column scale, once
      const long long o = static_cast<long long>(m) * p.N + n + u;
      if (p.out_f32) {
        static_cast<float*>(p.out)[o] = y;
      } else {
        static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(y);
      }
    }
  }
}

template <int MT, bool kTma>
int launch(const Problem& p, int splits, cudaStream_t stream) {
  using Sh = Shape<MT, kTma>;
  CUtensorMap tw{}, tx{};
  if constexpr (kTma) {
    if (!make_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.q, p.N, p.K, p.N, kBN, kBK,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
        !make_map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.x, p.K, p.M,
                     static_cast<long long>(p.K) * 2, 64, Sh::kMP, CU_TENSOR_MAP_SWIZZLE_128B)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return launch_cluster(int8_matmul_kernel<MT, kTma>,
                        dim3((p.N + kBN - 1) / kBN, (p.M + Sh::kMP - 1) / Sh::kMP, splits),
                        Sh::kThreads, Sh::kSmem, splits, stream, tw, tx, p);
}

// the block's m16 tiles for M rows: one up to 16, two up to 32, else four
// (more than 64 rows: blocks of 64 along y)
template <bool kTma>
int launch_m(const Problem& p, int splits, cudaStream_t stream) {
  if (p.M <= 16) return launch<1, kTma>(p, splits, stream);
  if (p.M <= 32) return launch<2, kTma>(p, splits, stream);
  return launch<4, kTma>(p, splits, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  `splits` blocks (one cluster,
// at most 8) share each column tile's K rows, rows_per_split each (a
// multiple of 64).  `tma` takes the TMA path (N % 16 == 0, K % 8 == 0, x
// and q 16-byte aligned), else the plain loads (any N and K).  Launches on
// `stream`, does not synchronise, allocates nothing, and returns a
// cudaError_t; operands the kernel does not take (a split plan that does
// not cover K, TMA where the shape or pointers do not allow it) return
// cudaErrorInvalidValue without launching.
extern "C" int int8_matmul_bf16(const void* x, const void* q, const void* s, void* out, int M,
                                int K, int N, int splits, int rows_per_split, int tma,
                                int out_f32, void* stream) {
  if (M < 1 || K < 1 || N < 1 || splits < 1 || splits > kMaxSplits || rows_per_split % kBK ||
      rows_per_split < kBK || (splits - 1) * rows_per_split >= K ||
      static_cast<long long>(splits) * rows_per_split < K || reinterpret_cast<uintptr_t>(x) % 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Problem p{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
                  static_cast<const float*>(s), out, M, K, N, rows_per_split, out_f32};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (!tma) return launch_m<false>(p, splits, cs);
  if (N % 16 || K % 8 || !aligned16(x) || !aligned16(q)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_m<true>(p, splits, cs);
}
