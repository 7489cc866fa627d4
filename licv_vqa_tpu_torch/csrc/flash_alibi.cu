// Causal flash-attention forward with in-kernel ALiBi for Hopper (sm_90a),
// bf16 in / bf16 out, for the MPT backbone of OpenFlamingo.
//
// Replaces: licv_vqa_tpu/ops/flash_alibi.py::flash_alibi_attention (its
// Pallas _kernel), which keeps a (batch, head)'s whole K/V rows in VMEM and
// computes the ALiBi bias from the per-head slope instead of reading a
// materialized (B, H, S, S) bias.
//
// Semantics (the Pallas kernel's function): scores (q.k) * scale in f32,
// minus slope_h * (q_idx - k_idx); key k is visible to query q iff k <= q
// (sequence index) and valid[k] != 0; softmax and P.V in f32, P not rounded.
// The index difference is the position difference for every real token
// under right padding (training) and under left padding (decode prompts),
// since ALiBi depends on differences only.  This is NOT the segment rule of
// flash_attn_fwd.cu: a right-pad query attends the earlier real keys, and a
// left-pad query with no visible key writes 0 (JAX: the row sum's 1e-30
// floor over zeroed probabilities).  Pad rows are garbage by contract; the
// rows with a visible key are the function's.
//
// Layout: q/k/v/out are (B, S, H, 128) addressed through element strides
// for b, s and h (the head dim is contiguous), so the JAX layout is taken
// without a transpose.  valid is a contiguous (B, S) int32, slopes an (H,)
// f32 from alibi_slopes on the host.
//
// What bounds it on the H100: MPT-7B's prefill (S = 512..2048, H = 32,
// Dh = 128) does 4*S*(S+1)/2*Dh*H flops on 4*S*Dh*H*2 bytes: bytes at S =
// 512 and operations at S = 2048 on the tensor cores' bf16 rate.  This
// first version is the simple, correct one on the CUDA cores in f32, the
// design of flash_attn_fwd.cu: the (S, S) scores and the bias never reach
// device memory (the plain path materializes both in f32, 537 MB each a
// layer at S = 2048); tensor cores (wgmma) and TMA are later work.
//
// - one block per (64-query tile, head, batch row); 256 threads, 4 per
//   query row, each owning 32 of the 128 dims as 16 interleaved bf16 pairs;
// - a loop over 64-key tiles up to the causal bound, K, V and valid staged
//   in shared memory with 16-byte loads;
// - online softmax in f32 over chunks of 16 keys; an invisible key scores
//   -inf, and a row with none visible keeps l = 0 and writes 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 128;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreadsPerRow = 4;
constexpr int kThreads = kBlockQ * kThreadsPerRow;              // 256
constexpr int kPairs = kHeadDim / 2 / kThreadsPerRow;            // 16 bf16 pairs
constexpr int kChunk = 16;
constexpr int kRowVec = kHeadDim * 2 / 16;                       // uint4 per row

struct Strides {
  long long b, s, h;
};

__global__ void __launch_bounds__(kThreads)
flash_alibi_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const int32_t* __restrict__ valid,
                   const float* __restrict__ slopes,
                   __nv_bfloat16* __restrict__ out, int S, Strides qs,
                   Strides ks, Strides vs, Strides os, float scale) {
  __shared__ __align__(16) __nv_bfloat162 k_s[kBlockK][kHeadDim / 2];
  __shared__ __align__(16) __nv_bfloat162 v_s[kBlockK][kHeadDim / 2];
  __shared__ int valid_s[kBlockK];

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = tid / kThreadsPerRow;
  const int part = tid % kThreadsPerRow;
  const int qi = qt * kBlockQ + row;
  const bool q_in = qi < S;
  const float slope = slopes[h];

  float qf[2 * kPairs];
  float acc[2 * kPairs];
  if (q_in) {
    const __nv_bfloat162* q_row = reinterpret_cast<const __nv_bfloat162*>(
        q + b * qs.b + (long long)qi * qs.s + h * qs.h);
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const float2 f = __bfloat1622float2(q_row[part + kThreadsPerRow * i]);
      qf[2 * i] = f.x * scale;
      qf[2 * i + 1] = f.y * scale;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2 * kPairs; ++i) qf[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 2 * kPairs; ++i) acc[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  // causal bound: no key past the tile's last query is visible
  const int k_end = min(S, (qt + 1) * kBlockQ);
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
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
      reinterpret_cast<uint4*>(&k_s[r][0])[c] = kv4;
      reinterpret_cast<uint4*>(&v_s[r][0])[c] = vv4;
    }
    if (tid < kBlockK) {
      const int kj = k0 + tid;
      valid_s[tid] = kj < S ? valid[(long long)b * S + kj] : 0;
    }
    __syncthreads();

    for (int c0 = 0; c0 < kBlockK; c0 += kChunk) {
      float sc[kChunk];
      float m_chunk = -INFINITY;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int r = c0 + j;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < kPairs; ++i) {
          const float2 kf =
              __bfloat1622float2(k_s[r][part + kThreadsPerRow * i]);
          dot = fmaf(qf[2 * i], kf.x, dot);
          dot = fmaf(qf[2 * i + 1], kf.y, dot);
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        const int kj = k0 + r;
        const bool visible = kj <= qi && valid_s[r] != 0;
        const float bias = slope * (float)(qi - kj);
        sc[j] = visible ? dot - bias : -INFINITY;
        m_chunk = fmaxf(m_chunk, sc[j]);
      }
      const float m_new = fmaxf(m, m_chunk);
      // nothing visible yet: keep the state (exp(-inf) terms are 0 below)
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = __expf(m - m_use);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < 2 * kPairs; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = __expf(sc[j] - m_use);
        l += p;
#pragma unroll
        for (int i = 0; i < kPairs; ++i) {
          const float2 vf =
              __bfloat1622float2(v_s[c0 + j][part + kThreadsPerRow * i]);
          acc[2 * i] = fmaf(p, vf.x, acc[2 * i]);
          acc[2 * i + 1] = fmaf(p, vf.y, acc[2 * i + 1]);
        }
      }
      m = m_new;
    }
  }

  if (q_in) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat162* o_row = reinterpret_cast<__nv_bfloat162*>(
        out + b * os.b + (long long)qi * os.s + h * os.h);
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      o_row[part + kThreadsPerRow * i] =
          __floats2bfloat162_rn(acc[2 * i] * inv, acc[2 * i + 1] * inv);
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Strides are in elements.
// Launches on `stream`, does not synchronise, allocates nothing, and
// returns cudaGetLastError() so a refused launch is reported to the caller.
extern "C" int flash_alibi_bf16(
    const void* q, const void* k, const void* v, const void* valid,
    const void* slopes, void* out,
    int B, int S, int H, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale, void* stream) {
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  flash_alibi_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const int32_t*>(valid), static_cast<const float*>(slopes),
      static_cast<__nv_bfloat16*>(out), S,
      Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
      Strides{v_sb, v_ss, v_sh}, Strides{o_sb, o_ss, o_sh}, scale);
  return static_cast<int>(cudaGetLastError());
}
