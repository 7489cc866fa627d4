// Bidirectional flash-attention forward for Hopper (sm_90a), bf16 in / bf16
// out, for the vision towers.
//
// Replaces: licv_vqa_tpu/models/layers.py::flash_attention_bidir_tpu, which
// calls the upstream Pallas TPU kernel (jax.experimental.pallas.ops.tpu.
// flash_attention) with causal=False and segment ids seg = valid + 1
// (real = 2, invalid = 1).
//
// Semantics (the TPU call's function): key k is visible to query q iff
// valid[k] == valid[q], over the whole sequence, with no causal bound.  A
// real patch attends the real patches only; an invalid one attends the
// invalid ones, so every row sees at least itself and every output is
// finite.  valid may be null: every key is real.  The TPU pads S to a
// multiple of 128 with keys of the invalid segment (a Mosaic block rule);
// this kernel masks its ragged tail instead, which changes only the invalid
// rows, garbage by contract (the Idefics2 perceiver's kv_mask drops them).
//
// Layout: q/k/v/out are (B, S, H, DH) addressed through element strides for
// b, s and h (the head dim is contiguous, rows 16-byte aligned).  valid is a
// contiguous (B, S) int32 or null.  DH is a template parameter: 72 is
// SigLIP-SO400M's (1152 / 16 heads), the only head dim on the Idefics2 path.
//
// What bounds it on the H100: at the tower's shapes (S = 1024..5184, H = 16,
// DH = 72) attention is compute-bound (4*S*S*DH*H flops against 4*S*DH*H*2
// bytes, ~1300 flops per byte at S = 1920).  The bound counts the tensor
// cores' bf16 rate; this first version is the simple, correct one and runs
// on the CUDA cores in f32, so it reads many times its bound.  Its design
// keeps what makes flash attention worth having -- the (S, S) scores never
// reach device memory, which at 33 images of S = 1920 would be 7.8 GB of
// f32 per layer -- and leaves tensor cores (mma/wgmma) and TMA to later work:
//
// - one block per (64-query tile, head, batch row); 128 threads, 2 per
//   query row, each owning DH/2 dims as float4 groups g = part + 2*i, so
//   the two threads of a row read neighbouring 16 bytes of shared memory
//   and all rows of a warp read the same key (a broadcast, no conflicts);
// - a loop over 64-key tiles of the whole sequence; K and V tiles are
//   widened to f32 once, when staged in shared memory (2 x 18 KB at
//   DH = 72), so the inner loops are float4 loads and FMAs only, each load
//   feeding 4 FMAs;
// - the dot product's two halves are summed with one xor shuffle, which
//   leaves both threads the same bits, so the online-softmax state (running
//   max m, running sum l) agrees across them without communication;
// - online softmax in f32 over chunks of 16 keys; invisible keys score -inf
//   and the update is branch-free.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_bidir_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const int32_t* __restrict__ valid,
                   __nv_bfloat16* __restrict__ out, int S, Strides qs,
                   Strides ks, Strides vs, Strides os, float scale) {
  static_assert(DH % 8 == 0, "rows are staged as 16-byte vectors of 8 bf16");
  constexpr int kVec = DH / 4 / kThreadsPerRow;  // float4 groups per thread
  constexpr int kRowVec = DH / 8;                 // uint4 per bf16 row
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
  // -1 never equals a key's segment (0/1 inside S, -2 past it)
  const int seg_q = !q_in ? -1 : (valid ? valid[(long long)b * S + qi] : 1);

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
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < S; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kBlockK * kRowVec; idx += kThreads) {
      const int r = idx / kRowVec;
      const int c = idx % kRowVec;
      const int kj = k0 + r;
      uint4 kv4 = make_uint4(0, 0, 0, 0);
      uint4 vv4 = make_uint4(0, 0, 0, 0);
      if (kj < S) {
        kv4 = reinterpret_cast<const uint4*>(
            k + b * ks.b + (long long)kj * ks.s + h * ks.h)[c];
        vv4 = reinterpret_cast<const uint4*>(
            v + b * vs.b + (long long)kj * vs.s + h * vs.h)[c];
      }
      const __nv_bfloat162* kp = reinterpret_cast<const __nv_bfloat162*>(&kv4);
      const __nv_bfloat162* vp = reinterpret_cast<const __nv_bfloat162*>(&vv4);
      float4* kd = reinterpret_cast<float4*>(&k_s[r][8 * c]);
      float4* vd = reinterpret_cast<float4*>(&v_s[r][8 * c]);
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const float2 k_lo = __bfloat1622float2(kp[2 * w]);
        const float2 k_hi = __bfloat1622float2(kp[2 * w + 1]);
        const float2 v_lo = __bfloat1622float2(vp[2 * w]);
        const float2 v_hi = __bfloat1622float2(vp[2 * w + 1]);
        kd[w] = make_float4(k_lo.x, k_lo.y, k_hi.x, k_hi.y);
        vd[w] = make_float4(v_lo.x, v_lo.y, v_hi.x, v_hi.y);
      }
    }
    if (tid < kBlockK) {
      const int kj = k0 + tid;
      seg_s[tid] = kj >= S ? -2 : (valid ? valid[(long long)b * S + kj] : 1);
    }
    __syncthreads();

    for (int c0 = 0; c0 < kBlockK; c0 += kChunk) {
      float sc[kChunk];
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
      float m_chunk = -INFINITY;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        sc[j] += __shfl_xor_sync(0xffffffffu, sc[j], 1);
        sc[j] = seg_s[c0 + j] == seg_q ? sc[j] : -INFINITY;
        m_chunk = fmaxf(m_chunk, sc[j]);
      }
      const float m_new = fmaxf(m, m_chunk);
      // nothing visible yet: keep the state (exp(-inf) terms are 0 below)
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = __expf(m - m_use);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < 4 * kVec; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = __expf(sc[j] - m_use);
        l += p;
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
      m = m_new;
    }
  }

  if (q_in) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    uint2* o_row = reinterpret_cast<uint2*>(
        out + b * os.b + (long long)qi * os.s + h * os.h);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const __nv_bfloat162 lo =
          __floats2bfloat162_rn(acc[4 * i] * inv, acc[4 * i + 1] * inv);
      const __nv_bfloat162 hi =
          __floats2bfloat162_rn(acc[4 * i + 2] * inv, acc[4 * i + 3] * inv);
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
  flash_bidir_kernel<DH><<<grid, kThreads, 0, stream>>>(
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
extern "C" int flash_attn_bidir_bf16(
    const void* q, const void* k, const void* v, const void* valid, void* out,
    int B, int S, int H, int DH, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale, void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (DH) {
    case 72:
      launch<72>(q, k, v, valid, out, B, S, H, qs, ks, vs, os, scale, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
