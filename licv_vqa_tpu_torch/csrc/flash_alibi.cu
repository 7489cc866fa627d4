// Causal flash-attention forward with in-kernel ALiBi for Hopper (sm_90a),
// bf16 in / bf16 out, for the MPT backbone of OpenFlamingo: the valid-key
// rule's instantiation of flash_fwd_sm90.cuh, whose note gives the design.
//
// Replaces: licv_vqa_tpu/ops/flash_alibi.py::flash_alibi_attention (its
// Pallas _kernel), which keeps a (batch, head)'s whole K/V rows in VMEM and
// computes the ALiBi bias from the per-head slope instead of reading a
// materialized (B, H, S, S) bias.
//
// Semantics (the Pallas kernel's function): scores (q.k) * scale in f32,
// minus slope_h * (q_idx - k_idx); key k is visible to query q iff k <= q
// (sequence index) and valid[k] != 0; softmax in f32, P rounded to bf16
// before P.V (the Pallas kernel keeps it in f32; the header's note).
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
#include "flash_fwd_sm90.cuh"

using namespace flash_sm90;

// Plain C entry point (loaded with ctypes).  Strides are in elements.
// Launches on `stream`, does not synchronise, allocates nothing, and
// returns a cudaError_t so a refused launch or tensor map is reported to
// the caller.
extern "C" int flash_alibi_bf16(
    const void* q, const void* k, const void* v, const void* valid,
    const void* slopes, void* out,
    int B, int S, int H, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale, void* stream) {
  return launch<MaskRule::ValidKey, Bias::Alibi>(
      q, k, v, {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh}, {o_sb, o_ss, o_sh},
      valid, slopes, out, nullptr, B, S, H, scale, stream);
}
