// Causal flash-attention forward for Hopper (sm_90a), bf16 in / bf16 out,
// head dim 128: the segment rule's instantiation of flash_fwd_sm90.cuh,
// whose note gives the design.
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
// without a transpose.  valid is a contiguous (B, S) int32.  Where the
// caller passes an lse buffer (a forward that autograd will differentiate),
// the per-row log-sum-exp m + log l of the scaled scores goes to it as
// (B, H, S) f32 for csrc/flash_attn_bwd.cu; with a null pointer (eval
// prefills, the no-grad teacher) nothing more is written.
#include "flash_fwd_sm90.cuh"

using namespace flash_sm90;

// Plain C entry point (loaded with ctypes).  Strides are in elements; lse
// may be null.
// Launches on `stream`, does not synchronise, allocates nothing, and
// returns a cudaError_t so a refused launch or tensor map is reported to
// the caller.
extern "C" int flash_attn_fwd_bf16(
    const void* q, const void* k, const void* v, const void* valid, void* out,
    void* lse, int B, int S, int H, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale, void* stream) {
  return launch<MaskRule::Segment, Bias::None>(
      q, k, v, {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh}, {o_sb, o_ss, o_sh},
      valid, nullptr, out, lse, B, S, H, scale, stream);
}

// The template's two products on one tile, for the card test: q (64, 128),
// k and v (128, 128) contiguous bf16; s_out = q.k^T and o_out =
// bf16(s_out).v, (64, 128) f32 each.
extern "C" int flash_fwd_sm90_tile_check(const void* q, const void* k, const void* v,
                                         void* s_out, void* o_out, void* stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, 1, 64, 1, 0, kHeadDim, 0) ||
      !make_map(&tk, k, 1, kBlockN, 1, 0, kHeadDim, 0) ||
      !make_map(&tv, v, 1, kBlockN, 1, 0, kHeadDim, 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = 3 * kTileBytes + 8 + 1024;
  const cudaError_t attr = cudaFuncSetAttribute(
      tile_check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  tile_check_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<float*>(s_out), static_cast<float*>(o_out));
  return static_cast<int>(cudaGetLastError());
}
