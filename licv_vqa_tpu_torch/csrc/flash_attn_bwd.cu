// Causal flash-attention backward for Hopper (sm_90a): dq, dk, dv in bf16.
//
// Replaces: the upstream Pallas TPU backward that
// licv_vqa_tpu/models/layers.py::flash_attention_tpu reaches under autograd
// (jax.experimental.pallas.ops.tpu.flash_attention: _flash_attention_bwd,
// which computes di = sum(o * do), then _flash_attention_bwd_dkv and
// _flash_attention_bwd_dq), with causal=True and segment ids valid + 1.
//
// Semantics: the forward's rule (csrc/flash_attn_fwd.cu): key k is visible
// to query q iff k <= q and valid[k] == valid[q].  With the forward's
// per-row log-sum-exp of the scaled scores (lse = m + log l):
//   P = exp(scale q.k - lse) on the visible pairs, 0 elsewhere
//   D = rowsum(do * o)        (o: the bf16 output the forward returned)
//   dV = P^T do,  dS = P * (do v^T - D),  dK = scale dS^T q,  dQ = scale dS k
//
// Layout: q/k/v are (B, S, H, 128) addressed through element strides for
// b, s and h (head dim contiguous), as the forward takes them; o, do, dq,
// dk and dv are contiguous (B, S, H, 128); lse and the D scratch are
// contiguous (B, H, S) f32; valid is a contiguous (B, S) int32.
//
// What bounds it on the H100: five products over the visible pairs (4*128
// flops a pair for the two score products, 6*128 for the three gradient
// products) against q, k, v, o, do read and dq, dk, dv written once:
// compute-bound from S of a few hundred up.  This first version is the
// simple, correct one: scalar f32 FMAs, no tensor cores, and it keeps what
// makes flash attention worth having -- no (S, S) matrix reaches device
// memory -- and is deterministic (no atomics), as upstream's split is:
//
// - flash_bwd_dq_kernel: one block per (64-query tile, head, batch row);
//   each query row computes D from its o and do rows (the D pass, fused),
//   writes it to the scratch, and loops over 64-key tiles up to the causal
//   bound with K and V staged in shared memory, accumulating dQ in f32;
// - flash_bwd_dkdv_kernel, launched after it on the same stream: one block
//   per (64-key tile, head, batch row); it loops over the query tiles from
//   the diagonal to S with Q, dO, lse and D staged in shared memory,
//   accumulating dK and dV in f32 registers.
//
// Both use 512 threads, 8 per row, each owning 16 of the 128 dims as 8
// interleaved bf16 pairs (pair index part + 8*i), so the 8 threads of a row
// read 8 neighbouring shared-memory words (no bank conflicts; the warp's
// other rows read the same words, a broadcast).  Dot products are reduced
// across the 8 threads with three xor shuffles, which leave all 8 with the
// same bits.  Shared memory: 32 KB of tiles a block, under the 48 KB a
// static allocation may take.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 128;
constexpr int kBlock = 64;                                   // rows a tile
constexpr int kThreadsPerRow = 8;
constexpr int kThreads = kBlock * kThreadsPerRow;            // 512
constexpr int kPairs = kHeadDim / 2 / kThreadsPerRow;        // 8 bf16 pairs
constexpr int kDims = 2 * kPairs;                            // 16 dims
constexpr int kRowVec = kHeadDim * 2 / 16;                   // uint4 per row

struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

// the forward's rule; a segment of -1 or -2 marks a row past S
__device__ __forceinline__ bool visible(int kj, int qi, int seg_k, int seg_q) {
  return kj <= qi && seg_k == seg_q;
}

// this thread's 16 dims of one bf16 row (global or shared) as f32
__device__ __forceinline__ void load_dims(const __nv_bfloat162* row, int part,
                                          float* out) {
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const float2 f = __bfloat1622float2(row[part + kThreadsPerRow * i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_dims(__nv_bfloat162* row, int part,
                                           const float* x, float mul) {
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    row[part + kThreadsPerRow * i] =
        __floats2bfloat162_rn(x[2 * i] * mul, x[2 * i + 1] * mul);
  }
}

__device__ __forceinline__ float dot(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kDims; ++i) acc = fmaf(a[i], b[i], acc);
  return row_sum(acc);
}

// copy one 64-row tile of a (B, S, H, 128) tensor into shared memory with
// 16-byte loads; rows past S are zeros
__device__ __forceinline__ void stage_tile(__nv_bfloat162 (*dst)[kHeadDim / 2],
                                           const __nv_bfloat16* src, Strides st,
                                           int b, int h, int r0, int S) {
  for (int idx = threadIdx.x; idx < kBlock * kRowVec; idx += kThreads) {
    const int r = idx / kRowVec;
    const int c = idx % kRowVec;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r0 + r < S) {
      x = reinterpret_cast<const uint4*>(
          src + b * st.b + (long long)(r0 + r) * st.s + h * st.h)[c];
    }
    reinterpret_cast<uint4*>(&dst[r][0])[c] = x;
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const int32_t* __restrict__ valid,
                    __nv_bfloat16* __restrict__ dq, float* __restrict__ dsum,
                    int S, Strides qs, Strides ks, Strides vs, Strides cs,
                    float scale) {
  __shared__ __align__(16) __nv_bfloat162 k_s[kBlock][kHeadDim / 2];
  __shared__ __align__(16) __nv_bfloat162 v_s[kBlock][kHeadDim / 2];
  __shared__ int seg_s[kBlock];

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = threadIdx.x / kThreadsPerRow;
  const int part = threadIdx.x % kThreadsPerRow;
  const int qi = qt * kBlock + row;
  const bool q_in = qi < S;
  const long long bh = ((long long)b * gridDim.y + h) * S;
  const int seg_q = q_in ? valid[(long long)b * S + qi] : -1;

  float qf[kDims], dof[kDims], acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) qf[i] = dof[i] = acc[i] = 0.f;
  float lse_q = 0.f;
  if (q_in) {
    const long long c_off = b * cs.b + (long long)qi * cs.s + h * cs.h;
    load_dims(reinterpret_cast<const __nv_bfloat162*>(
                  q + b * qs.b + (long long)qi * qs.s + h * qs.h),
              part, qf);
    load_dims(reinterpret_cast<const __nv_bfloat162*>(dout + c_off), part, dof);
    load_dims(reinterpret_cast<const __nv_bfloat162*>(o + c_off), part, acc);
    lse_q = lse[bh + qi];
  }
  const float d_row = dot(dof, acc);  // D = rowsum(do * o)
  if (q_in && part == 0) dsum[bh + qi] = d_row;
#pragma unroll
  for (int i = 0; i < kDims; ++i) acc[i] = 0.f;

  // causal bound: no key past the tile's last query is visible
  const int k_end = min(S, (qt + 1) * kBlock);
  for (int k0 = 0; k0 < k_end; k0 += kBlock) {
    __syncthreads();  // the previous tile is consumed
    stage_tile(k_s, k, ks, b, h, k0, S);
    stage_tile(v_s, v, vs, b, h, k0, S);
    if (threadIdx.x < kBlock) {
      const int kj = k0 + threadIdx.x;
      seg_s[threadIdx.x] = kj < S ? valid[(long long)b * S + kj] : -2;
    }
    __syncthreads();
    for (int r = 0; r < kBlock; ++r) {
      float kr[kDims], vr[kDims];
      load_dims(k_s[r], part, kr);
      load_dims(v_s[r], part, vr);
      const float s = dot(qf, kr) * scale;
      const float p =
          visible(k0 + r, qi, seg_s[r], seg_q) ? __expf(s - lse_q) : 0.f;
      const float ds = p * (dot(dof, vr) - d_row);
#pragma unroll
      for (int i = 0; i < kDims; ++i) acc[i] = fmaf(ds, kr[i], acc[i]);
    }
  }
  if (q_in) {
    store_dims(reinterpret_cast<__nv_bfloat162*>(
                   dq + b * cs.b + (long long)qi * cs.s + h * cs.h),
               part, acc, scale);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum,
                      const int32_t* __restrict__ valid,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int S, Strides qs,
                      Strides ks, Strides vs, Strides cs, float scale) {
  __shared__ __align__(16) __nv_bfloat162 q_s[kBlock][kHeadDim / 2];
  __shared__ __align__(16) __nv_bfloat162 do_s[kBlock][kHeadDim / 2];
  __shared__ float lse_s[kBlock];
  __shared__ float d_s[kBlock];
  __shared__ int seg_s[kBlock];

  const int kt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = threadIdx.x / kThreadsPerRow;
  const int part = threadIdx.x % kThreadsPerRow;
  const int kj = kt * kBlock + row;
  const bool k_in = kj < S;
  const long long bh = ((long long)b * gridDim.y + h) * S;
  const int seg_k = k_in ? valid[(long long)b * S + kj] : -1;

  float kf[kDims], vf[kDims], dkf[kDims], dvf[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) kf[i] = vf[i] = dkf[i] = dvf[i] = 0.f;
  if (k_in) {
    load_dims(reinterpret_cast<const __nv_bfloat162*>(
                  k + b * ks.b + (long long)kj * ks.s + h * ks.h),
              part, kf);
    load_dims(reinterpret_cast<const __nv_bfloat162*>(
                  v + b * vs.b + (long long)kj * vs.s + h * vs.h),
              part, vf);
  }

  // causal bound: no query before the tile's first key sees it
  for (int q0 = kt * kBlock; q0 < S; q0 += kBlock) {
    __syncthreads();  // the previous tile is consumed
    stage_tile(q_s, q, qs, b, h, q0, S);
    stage_tile(do_s, dout, cs, b, h, q0, S);
    if (threadIdx.x < kBlock) {
      const int qi = q0 + threadIdx.x;
      const bool in = qi < S;
      seg_s[threadIdx.x] = in ? valid[(long long)b * S + qi] : -2;
      lse_s[threadIdx.x] = in ? lse[bh + qi] : 0.f;
      d_s[threadIdx.x] = in ? dsum[bh + qi] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < kBlock; ++r) {
      float qr[kDims], dor[kDims];
      load_dims(q_s[r], part, qr);
      load_dims(do_s[r], part, dor);
      const float s = dot(qr, kf) * scale;
      const float p =
          visible(kj, q0 + r, seg_k, seg_s[r]) ? __expf(s - lse_s[r]) : 0.f;
      const float ds = p * (dot(dor, vf) - d_s[r]);
#pragma unroll
      for (int i = 0; i < kDims; ++i) {
        dvf[i] = fmaf(p, dor[i], dvf[i]);
        dkf[i] = fmaf(ds, qr[i], dkf[i]);
      }
    }
  }
  if (k_in) {
    const long long c_off = b * cs.b + (long long)kj * cs.s + h * cs.h;
    store_dims(reinterpret_cast<__nv_bfloat162*>(dk + c_off), part, dkf, scale);
    store_dims(reinterpret_cast<__nv_bfloat162*>(dv + c_off), part, dvf, 1.f);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Strides (of q, k, v) are in
// elements.  Launches the dQ kernel, which also writes D into `dsum`, then
// the dK/dV kernel, on `stream`; does not synchronise, allocates nothing,
// and returns the first launch error (cudaGetLastError) so a refused launch
// is reported to the caller.
extern "C" int flash_attn_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* valid, void* dq, void* dk,
    void* dv, void* dsum, int B, int S, int H, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, float scale,
    void* stream) {
  const dim3 grid((S + kBlock - 1) / kBlock, H, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const Strides cs{(long long)S * H * kHeadDim, (long long)H * kHeadDim, kHeadDim};
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* dop = static_cast<const __nv_bfloat16*>(dout);
  const auto* lsep = static_cast<const float*>(lse);
  const auto* validp = static_cast<const int32_t*>(valid);
  flash_bwd_dq_kernel<<<grid, kThreads, 0, st>>>(
      qp, kp, vp, static_cast<const __nv_bfloat16*>(o), dop, lsep, validp,
      static_cast<__nv_bfloat16*>(dq), static_cast<float*>(dsum), S, qs, ks,
      vs, cs, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<<<grid, kThreads, 0, st>>>(
      qp, kp, vp, dop, lsep, static_cast<const float*>(dsum), validp,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, qs,
      ks, vs, cs, scale);
  return static_cast<int>(cudaGetLastError());
}
