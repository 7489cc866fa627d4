// Fused short-sequence bidirectional attention for Hopper (sm_90a), bf16 in /
// bf16 out, for the CLIP vision towers (OpenFlamingo's ViT-L, Idefics-9B's
// ViT-H) and any tower sequence under 1024 patches.
//
// Replaces: licv_vqa_tpu/ops/vit_attention.py::vit_attention_tpu (the Pallas
// kernels _kernel and _kernel_masked), which holds a group of heads' whole
// (S, S) f32 score block in VMEM.
//
// Semantics (the Pallas kernels' function): scores q.k * scale in f32; a
// masked key (valid[k] == 0) scores finfo(f32).min (-FLT_MAX); softmax exact
// over the whole row; each probability rounded to bf16 (V's dtype) before
// P.V, which sums in f32; bf16 output.  A row whose keys are all masked has
// every score at -FLT_MAX, so its softmax is uniform, as in the plain
// version.  valid may be null: every key is real.
//
// Why two passes: the plain version normalises the probabilities and then
// rounds them to bf16.  An online softmax rescales its accumulator as the
// running max moves, so it cannot round at that point.  Pass 1 streams the
// key tiles for the row's max m and sum l (online, f32); pass 2 streams K
// and V again, recomputes each score, forms p = exp(s - m) / l, rounds p to
// bf16 and accumulates p.v.  Neither keeps more than one 64-key tile of K
// and V in shared memory (41 KB at DH = 80), so every S up to the gate's
// 1024 runs the same code; staging a head's whole K and V (82 KB at S = 257,
// 327 KB at S = 1024 for DH = 80) would not fit at the top of that range.
//
// Layout: q/k/v/out are (B, S, H, DH) addressed through element strides for
// b, s and h (the head dim is contiguous, rows 16-byte aligned).  valid is a
// contiguous (B, S) int32 or null.  DH is a template parameter: 64 (ViT-L),
// 72 (SigLIP) and 80 (ViT-H).
//
// What bounds it on the H100: at the towers' shapes (S = 257, H = 16,
// DH = 64 or 80, 1 or 33 images) the function moves 4*S*DH*H*2 bytes and
// does 4*S*S*DH*H flops, about 128 flops per byte: below the bf16 ridge
// (about 295), so the bound is the bytes.  This first version is the
// simple, correct one and runs on the CUDA cores in f32 (three S*S*DH
// products, with QK^T done twice), so it reads many times that bound.  Its
// design keeps what the TPU kernel is for -- the (B, H, S, S) f32 scores
// never reach device memory (140 MB a layer for a 33-image ViT-H bind) --
// and leaves tensor cores (mma/wgmma) and TMA to later work:
//
// - one block per (64-query tile, head, batch row); 128 threads, 2 per
//   query row, each owning DH/2 dims as float4 groups g = part + 2*i, so the
//   two threads of a row read neighbouring 16 bytes of shared memory and all
//   rows of a warp read the same key (a broadcast, no bank conflicts);
// - K and V tiles are widened to f32 once, when staged, so the inner loops
//   are float4 loads feeding four FMAs each;
// - the dot product's two halves are summed with one xor shuffle, which
//   leaves both threads the same bits, so m and l agree across them without
//   communication.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreadsPerRow = 2;
constexpr int kThreads = kBlockQ * kThreadsPerRow;  // 128
constexpr int kChunk = 16;

struct Strides {
  long long b, s, h;
};

// One 64-key tile of a (B, S, H, DH) bf16 tensor into shared memory as f32;
// rows past S are zero.
template <int DH>
__device__ __forceinline__ void stage_tile(float (*dst)[DH],
                                           const __nv_bfloat16* __restrict__ src,
                                           Strides st, int b, int h, int k0, int S,
                                           int tid) {
  constexpr int kRowVec = DH / 8;  // uint4 per bf16 row
  for (int idx = tid; idx < kBlockK * kRowVec; idx += kThreads) {
    const int r = idx / kRowVec;
    const int c = idx % kRowVec;
    const int kj = k0 + r;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (kj < S) {
      u = reinterpret_cast<const uint4*>(src + b * st.b + (long long)kj * st.s +
                                         h * st.h)[c];
    }
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
    float4* d = reinterpret_cast<float4*>(&dst[r][8 * c]);
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const float2 lo = __bfloat1622float2(p[2 * w]);
      const float2 hi = __bfloat1622float2(p[2 * w + 1]);
      d[w] = make_float4(lo.x, lo.y, hi.x, hi.y);
    }
  }
}

// The scores of this thread's row against the 16 keys of a chunk: the
// dot product summed over the row's two threads, then the key rule (1: the
// key counts, 0: masked, -1: past S and not part of the row).
template <int DH>
__device__ __forceinline__ void chunk_scores(float* sc, const float* qf,
                                             const float (*k_s)[DH],
                                             const int* seg_s, int c0, int part) {
  constexpr int kVec = DH / 4 / kThreadsPerRow;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) sc[j] = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const float4 kk =
          reinterpret_cast<const float4*>(&k_s[c0 + j][0])[part + kThreadsPerRow * i];
      sc[j] = fmaf(qf[4 * i], kk.x, sc[j]);
      sc[j] = fmaf(qf[4 * i + 1], kk.y, sc[j]);
      sc[j] = fmaf(qf[4 * i + 2], kk.z, sc[j]);
      sc[j] = fmaf(qf[4 * i + 3], kk.w, sc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    sc[j] += __shfl_xor_sync(0xffffffffu, sc[j], 1);
    const int seg = seg_s[c0 + j];
    sc[j] = seg > 0 ? sc[j] : (seg == 0 ? -FLT_MAX : -INFINITY);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
vit_attention_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int32_t* __restrict__ valid,
                     __nv_bfloat16* __restrict__ out, int S, Strides qs,
                     Strides ks, Strides vs, Strides os, float scale) {
  static_assert(DH % 8 == 0, "rows are staged as 16-byte vectors of 8 bf16");
  constexpr int kVec = DH / 4 / kThreadsPerRow;  // float4 groups per thread
  __shared__ __align__(16) float k_s[kBlockK][DH];
  __shared__ __align__(16) float v_s[kBlockK][DH];
  __shared__ int seg_s[kBlockK];

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = tid / kThreadsPerRow;
  const int part = tid % kThreadsPerRow;
  const int qi = qt * kBlockQ + row;
  const bool q_in = qi < S;

  float qf[4 * kVec];
  float acc[4 * kVec];
  if (q_in) {
    const uint2* q_row = reinterpret_cast<const uint2*>(
        q + b * qs.b + (long long)qi * qs.s + h * qs.h);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const uint2 u = q_row[part + kThreadsPerRow * i];  // 4 bf16 of group g
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      qf[4 * i] = lo.x * scale;
      qf[4 * i + 1] = lo.y * scale;
      qf[4 * i + 2] = hi.x * scale;
      qf[4 * i + 3] = hi.y * scale;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4 * kVec; ++i) qf[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 4 * kVec; ++i) acc[i] = 0.f;

  // pass 1: the row's max and sum over every key (key 0 is always inside
  // S, so m is finite after the first chunk and exp(-inf) terms are 0)
  float m = -INFINITY;
  float l = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    const float inv_l = pass ? 1.f / l : 0.f;
    for (int k0 = 0; k0 < S; k0 += kBlockK) {
      __syncthreads();  // the previous tile is consumed
      stage_tile<DH>(k_s, k, ks, b, h, k0, S, tid);
      if (pass) stage_tile<DH>(v_s, v, vs, b, h, k0, S, tid);
      if (tid < kBlockK) {
        const int kj = k0 + tid;
        seg_s[tid] = kj >= S ? -1 : (valid ? valid[(long long)b * S + kj] : 1);
      }
      __syncthreads();

      for (int c0 = 0; c0 < kBlockK; c0 += kChunk) {
        float sc[kChunk];
        chunk_scores<DH>(sc, qf, k_s, seg_s, c0, part);
        if (!pass) {
          float m_chunk = -INFINITY;
#pragma unroll
          for (int j = 0; j < kChunk; ++j) m_chunk = fmaxf(m_chunk, sc[j]);
          const float m_new = fmaxf(m, m_chunk);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < kChunk; ++j) sum += expf(sc[j] - m_new);
          l = l * expf(m - m_new) + sum;
          m = m_new;
          continue;
        }
        // pass 2: the normalised probability, rounded to bf16 as the plain
        // version rounds it before P.V
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const float p = __bfloat162float(__float2bfloat16(expf(sc[j] - m) * inv_l));
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            const float4 vv =
                reinterpret_cast<const float4*>(&v_s[c0 + j][0])[part + kThreadsPerRow * i];
            acc[4 * i] = fmaf(p, vv.x, acc[4 * i]);
            acc[4 * i + 1] = fmaf(p, vv.y, acc[4 * i + 1]);
            acc[4 * i + 2] = fmaf(p, vv.z, acc[4 * i + 2]);
            acc[4 * i + 3] = fmaf(p, vv.w, acc[4 * i + 3]);
          }
        }
      }
    }
  }

  if (q_in) {
    uint2* o_row = reinterpret_cast<uint2*>(
        out + b * os.b + (long long)qi * os.s + h * os.h);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[4 * i], acc[4 * i + 1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[4 * i + 2], acc[4 * i + 3]);
      uint2 u;
      u.x = *reinterpret_cast<const uint32_t*>(&lo);
      u.y = *reinterpret_cast<const uint32_t*>(&hi);
      o_row[part + kThreadsPerRow * i] = u;
    }
  }
}

template <int DH>
void launch(const void* q, const void* k, const void* v, const void* valid,
            void* out, int B, int S, int H, Strides qs, Strides ks, Strides vs,
            Strides os, float scale, cudaStream_t stream) {
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  vit_attention_kernel<DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const int32_t*>(valid), static_cast<__nv_bfloat16*>(out), S,
      qs, ks, vs, os, scale);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Strides are in elements; valid
// may be null (every key real).  Launches on `stream`, does not synchronise,
// allocates nothing, and returns cudaGetLastError() so a refused launch is
// reported to the caller; a head dim it was not built for returns
// cudaErrorInvalidValue without launching.
extern "C" int vit_attention_bf16(
    const void* q, const void* k, const void* v, const void* valid, void* out,
    int B, int S, int H, int DH, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale, void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (DH) {
    case 64:
      launch<64>(q, k, v, valid, out, B, S, H, qs, ks, vs, os, scale, st);
      break;
    case 72:
      launch<72>(q, k, v, valid, out, B, S, H, qs, ks, vs, os, scale, st);
      break;
    case 80:
      launch<80>(q, k, v, valid, out, B, S, H, qs, ks, vs, os, scale, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
