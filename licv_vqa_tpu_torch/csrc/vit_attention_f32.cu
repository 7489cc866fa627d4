// Fused short-sequence bidirectional attention in f32 for Hopper (sm_90a):
// f32 Q/K/V in, f32 out, for the CLIP towers that run in f32 (RICE's CLIP
// ViT-B/32 image tower: S = 50, H = 12, DH = 64).  The bf16 towers take
// csrc/vit_attention.cu; layers.vit_attention picks the entry by dtype.
//
// Replaces: licv_vqa_tpu/ops/vit_attention.py::vit_attention_tpu (the Pallas
// kernels _kernel and _kernel_masked) on f32 operands: its out_shape follows
// q.dtype, so an f32 tower keeps f32 scores, probabilities and output.
//
// Semantics (the Pallas kernels' function at f32): scores q.k * scale in
// f32; a masked key (valid[k] == 0) scores finfo(f32).min (-FLT_MAX);
// softmax exact over the whole row (max, exp, sum, then each probability
// normalised), in f32 throughout, with no rounding of P; P.V summed in f32;
// f32 output.  A row whose keys are all masked has every score at -FLT_MAX,
// so its softmax is uniform over its S keys, as in the plain version.
// valid may be null: every key is real.
//
// Layout: q/k/v/out are (B, S, H, DH) addressed through element strides for
// b, s and h (the head dim contiguous), so strided views load without a
// copy.  valid is a contiguous (B, S) int32 or null.  DH is 64, 72 or 80;
// S is at most 264 (one pass: the whole score row in registers).
//
// What bounds it on the H100: wgmma has no f32 operand, and TF32 keeps 10
// mantissa bits, far outside the 1e-4 limit the f32 plain version is held
// to, so the products run on the CUDA cores (FFMA, 67 TFLOP/s).  At the
// RICE batch (8, 50, 12, 64) the function moves 4*S*DH*H*B*4 = 4.9 MB and
// does 4*S*S*DH*H*B = 61 MFLOP, about 12 a byte: under the f32 ridge (about
// 20), so the bound is the bytes (1.5 us), and at 96 blocks on 132 SMs the
// time is one block's latency.  First design, right before fast:
//
// - One block per (image, head, 16 query rows): the head's K and V (S rows
//   each) are read into shared memory by each of the head's ceil(S / 16)
//   blocks (from L2 after the first), by 16-byte loads where the rows
//   allow (S * (DH + 1) + S * DH floats; the K rows padded by one float so
//   that 32 lanes reading 32 keys at one dim hit 32 banks).  A warp's rows
//   run one after another, so 16 rows a block keeps that chain at two rows
//   and puts 384 blocks on 132 SMs at the RICE batch.
// - 8 warps; a warp takes the block's query rows w and w + 8, each row's q loaded
//   into registers one row ahead and read from the warp's slice of shared
//   memory by broadcast; lane l holds the scores of keys l, l + 32, ...: KPL =
//   ceil(S / 32) of them in registers (a template argument, 2 at S = 50),
//   so the max and the sum are two warp reductions.  The normalised
//   probabilities go to the warp's slice of shared memory, and P.V has
//   lane l own output dims l, l + 32, l + 64 (V rows unpadded:
//   consecutive lanes, consecutive banks).
// - 9 predicated keys a lane at any S, each q row loaded as its warp
//   reached it, and one block a head ran slower than the plain version
//   (PERF.md §6).
#include <float.h>
#include <stdint.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerBlock = 16;  // 2 query rows a warp
constexpr int kMaxS = 264;  // 9 keys a lane

// the K slice's floats, rounded up to whole 16-byte quads so that the V
// slice after it takes 16-byte stores
__host__ __device__ constexpr int k_floats(int s, int pitch) { return (s * pitch + 3) & ~3; }

struct Strides {
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DH, int KPL>
__global__ void __launch_bounds__(kWarps * 32)
vit_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int* __restrict__ valid,
                         float* __restrict__ out, int S, int H, Strides st, float scale,
                         bool vec) {
  constexpr int kPitch = DH + 1;  // K rows padded: conflict-free column reads
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                        // (S, DH + 1)
  float* vs = ks + k_floats(S, kPitch);    // (S, DH), 16-byte aligned
  float* qs = vs + S * DH;                 // (kWarps, DH)
  float* ps = qs + kWarps * DH;            // (kWarps, S)
  float* term = ps + kWarps * S;           // (S): 1 where the key counts

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // the head's K and V, each read from device memory once
  const float* qb = q + b * st.q_sb + h * st.q_sh;
  const float* kb = k + b * st.k_sb + h * st.k_sh;
  const float* vb = v + b * st.v_sb + h * st.v_sh;
  if (vec) {  // 16-byte loads: rows 16-byte aligned (checked by the launcher)
    constexpr int kQuads = DH / 4;
    for (int i = tid; i < S * kQuads; i += kWarps * 32) {
      const int r = i / kQuads, d = 4 * (i % kQuads);
      const float4 kq = *reinterpret_cast<const float4*>(kb + r * st.k_ss + d);
      const float4 vq = *reinterpret_cast<const float4*>(vb + r * st.v_ss + d);
      float* kd = ks + r * kPitch + d;
      kd[0] = kq.x; kd[1] = kq.y; kd[2] = kq.z; kd[3] = kq.w;
      *reinterpret_cast<float4*>(vs + r * DH + d) = vq;
    }
  } else {
    for (int i = tid; i < S * DH; i += kWarps * 32) {
      const int r = i / DH, d = i % DH;
      ks[r * kPitch + d] = kb[r * st.k_ss + d];
      vs[r * DH + d] = vb[r * st.v_ss + d];
    }
  }
  for (int r = tid; r < S; r += kWarps * 32) {
    term[r] = (valid == nullptr || valid[b * S + r] != 0) ? 1.f : 0.f;
  }
  __syncthreads();

  // a warp's q rows: each row's loads are issued a row ahead, into
  // registers, so their latency hides under the row before
  float* qw = qs + warp * DH;
  float* pw = ps + warp * S;
  constexpr int kDimsPerLane = (DH + 31) / 32;
  float qnext[kDimsPerLane];
  auto load_q = [&](int row) {
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int d = lane + 32 * i;
      qnext[i] = (row < S && d < DH) ? qb[row * st.q_ss + d] : 0.f;
    }
  };
  const int row_end = min(S, static_cast<int>(blockIdx.y + 1) * kRowsPerBlock);
  const int row0 = blockIdx.y * kRowsPerBlock + warp;
  load_q(row0 < row_end ? row0 : S);
  for (int row = row0; row < row_end; row += kWarps) {
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      if (lane + 32 * i < DH) qw[lane + 32 * i] = qnext[i];
    }
    __syncwarp();
    load_q(row + kWarps < row_end ? row + kWarps : S);
    // lane l scores keys l, l + 32, ...: KPL = ceil(S / 32) of them; a lane
    // past S reads key S - 1 and is dropped below
    int key_row[KPL];
#pragma unroll
    for (int j = 0; j < KPL; ++j) key_row[j] = min(lane + 32 * j, S - 1) * kPitch;
    float sc[KPL];
#pragma unroll
    for (int j = 0; j < KPL; ++j) sc[j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float qd = qw[d];
#pragma unroll
      for (int j = 0; j < KPL; ++j) sc[j] = fmaf(qd, ks[key_row[j] + d], sc[j]);
    }
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int key = lane + 32 * j;
      sc[j] = key >= S ? -INFINITY : (term[key] != 0.f ? sc[j] * scale : -FLT_MAX);
      m = fmaxf(m, sc[j]);
    }
    m = warp_max(m);
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      sc[j] = expf(sc[j] - m);  // keys past S: exp(-inf) = 0
      l += sc[j];
    }
    l = warp_sum(l);
    const float inv = 1.f / l;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int key = lane + 32 * j;
      if (key < S) pw[key] = sc[j] * inv;
    }
    __syncwarp();

    float acc[kDimsPerLane];
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int key = 0; key < S; ++key) {
      const float p = pw[key];
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < DH) acc[i] = fmaf(p, vs[key * DH + d], acc[i]);
      }
    }
    float* orow = out + b * st.o_sb + row * st.o_ss + h * st.o_sh;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < DH) orow[d] = acc[i];
    }
    __syncwarp();  // the warp's q and p slices are rewritten by its next row
  }
}

template <int DH, int KPL>
int launch(const void* q, const void* k, const void* v, const void* valid, void* out,
           int B, int S, int H, const Strides& st, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(k_floats(S, DH + 1)) + static_cast<size_t>(S) * DH +
                       kWarps * DH + kWarps * S + S);
  cudaError_t err = cudaFuncSetAttribute(vit_attention_f32_kernel<DH, KPL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  auto aligned = [](const void* p, long long sb, long long ss, long long sh) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 4 == 0 && ss % 4 == 0 &&
           sh % 4 == 0;
  };
  const bool vec = aligned(q, st.q_sb, st.q_ss, st.q_sh) && aligned(k, st.k_sb, st.k_ss, st.k_sh) &&
                   aligned(v, st.v_sb, st.v_ss, st.v_sh);
  const dim3 grid(B * H, (S + kRowsPerBlock - 1) / kRowsPerBlock);
  vit_attention_f32_kernel<DH, KPL><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(valid),
      static_cast<float*>(out), S, H, st, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_dh(const void* q, const void* k, const void* v, const void* valid, void* out,
              int B, int S, int H, const Strides& st, float scale, cudaStream_t stream) {
  switch ((S + 31) / 32) {  // keys a lane scores
    case 1: return launch<DH, 1>(q, k, v, valid, out, B, S, H, st, scale, stream);
    case 2: return launch<DH, 2>(q, k, v, valid, out, B, S, H, st, scale, stream);
    case 3: return launch<DH, 3>(q, k, v, valid, out, B, S, H, st, scale, stream);
    case 4: return launch<DH, 4>(q, k, v, valid, out, B, S, H, st, scale, stream);
    case 5: return launch<DH, 5>(q, k, v, valid, out, B, S, H, st, scale, stream);
    case 6: return launch<DH, 6>(q, k, v, valid, out, B, S, H, st, scale, stream);
    case 7: return launch<DH, 7>(q, k, v, valid, out, B, S, H, st, scale, stream);
    case 8: return launch<DH, 8>(q, k, v, valid, out, B, S, H, st, scale, stream);
    case 9: return launch<DH, 9>(q, k, v, valid, out, B, S, H, st, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int vit_attention_f32(
    const void* q, const void* k, const void* v, const void* valid, void* out,
    int B, int S, int H, int DH, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale, void* stream) {
  const Strides st{q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || S < 1 || S > kMaxS) return static_cast<int>(cudaErrorInvalidValue);
  switch (DH) {
    case 64: return launch_dh<64>(q, k, v, valid, out, B, S, H, st, scale, cs);
    case 72: return launch_dh<72>(q, k, v, valid, out, B, S, H, st, scale, cs);
    case 80: return launch_dh<80>(q, k, v, valid, out, B, S, H, st, scale, cs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
