// Causal flash-attention forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces: licv_vqa_tpu/models/layers.py::flash_attention_tpu, which calls
// the upstream Pallas TPU kernel (jax.experimental.pallas.ops.tpu.
// flash_attention) with causal=True and segment ids seg = valid + 1.
//
// Semantics (identical to the TPU call): key k is visible to query q iff
// k <= q (sequence index) and valid[k] == valid[q].  So a real token attends
// the earlier real tokens, and a pad token attends the earlier pads only --
// every row has at least itself visible, so every output is finite.  That
// matters: pad rows' K/V are written into the KV cache, and a NaN there
// would turn every later decode step into NaN through 0 * NaN.
//
// Layout: q/k/v/out are (B, S, H, 128) addressed through element strides
// for b, s and h (the head dim is contiguous), so the JAX layout is taken
// without a transpose.  valid is a contiguous (B, S) int32.
//
// What bounds it on the H100: at the prefill shapes (S = 256..2048, H = 32,
// Dh = 128) attention is compute-bound (about 4*S*S*Dh*H/2 flops against
// 4*S*Dh*H*2 bytes).  This first version is the simple, correct one:
// scalar f32 FMAs, no tensor cores.  Its design keeps the property that
// makes flash attention worth having -- the (S, S) score matrix never goes
// to device memory -- and leaves tensor cores (wgmma) and TMA to later work:
//
// - one block per (64-query tile, head, batch row); 256 threads, 4 per
//   query row, each owning 32 of the 128 dims as 16 interleaved bf16 pairs
//   (pair index part + 4*i), so the 4 threads of a row read 4 neighbouring
//   shared-memory words: no bank conflicts, the other rows broadcast;
// - a loop over 64-key tiles up to the causal bound, K and V tiles staged
//   in shared memory with 16-byte loads (32 KB per block);
// - dot products reduced across the 4 threads with two xor shuffles, which
//   leave all 4 with the same bits, so the online-softmax state (running
//   max m, running sum l) agrees across them without communication;
// - online softmax in f32 over chunks of 16 keys; masked keys score -inf
//   and the update is branch-free;
// - where the caller passes an lse buffer (a forward that autograd will
//   differentiate), the per-row log-sum-exp m + log l of the scaled scores
//   goes to it as (B, H, S) f32 for csrc/flash_attn_bwd.cu; with a null
//   pointer (eval prefills, the no-grad teacher) nothing more is written.
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
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int32_t* __restrict__ valid,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int S, Strides qs, Strides ks, Strides vs, Strides os,
                 float scale) {
  __shared__ __align__(16) __nv_bfloat162 k_s[kBlockK][kHeadDim / 2];
  __shared__ __align__(16) __nv_bfloat162 v_s[kBlockK][kHeadDim / 2];
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
  const int seg_q = q_in ? valid[(long long)b * S + qi] : -1;

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
      seg_s[tid] = kj < S ? valid[(long long)b * S + kj] : -2;
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
        const bool visible = kj <= qi && seg_s[r] == seg_q;
        sc[j] = visible ? dot : -INFINITY;
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
    // every row sees itself, so m is finite and l >= 1
    if (lse != nullptr && part == 0) {
      lse[((long long)b * gridDim.y + h) * S + qi] = m + logf(l);
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Strides are in elements; lse
// may be null.
// Launches on `stream`, does not synchronise, allocates nothing, and
// returns cudaGetLastError() so a refused launch is reported to the caller.
extern "C" int flash_attn_fwd_bf16(
    const void* q, const void* k, const void* v, const void* valid, void* out,
    void* lse, int B, int S, int H, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale, void* stream) {
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  flash_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const int32_t*>(valid), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), S,
      Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
      Strides{v_sb, v_ss, v_sh}, Strides{o_sb, o_ss, o_sh}, scale);
  return static_cast<int>(cudaGetLastError());
}
