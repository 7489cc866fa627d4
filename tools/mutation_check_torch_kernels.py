#!/usr/bin/env python
"""Broken copies of the port's kernels, read by ``chip_smoke.py``'s own
checks: where a wrong kernel lands against their limits.

Each mutation is applied to a copy of the tree in a temporary directory
(never to the checkout), and the kernel-vs-plain error ratio (max-abs error
over the plain output's max-abs, worst output) of every case of the broken
kernel in ``chip_smoke.kernel_cases`` is printed from that copy, beside the
case's limit, and the mean error ratio (``chip_smoke.mean_ratio``) beside
its limit where the case has one (a CUDA source is rebuilt from the
copy).  For the
ICV-backward mutation, the full-width
gradient check (``chip_smoke.gradient_check``, Idefics-9B with random
weights, ~18 GB on the card) is run from the copy too, and for the flash
backward's, phase 9's (``chip_smoke.flagship_gradient_check`` on the bench
tool's flagship model, int8 weights), both against
``chip_smoke.REL_L2_TOL``.  Needs an NVIDIA GPU.  Run from the repository
root: ``python3 tools/mutation_check_torch_kernels.py [name ...]`` (the
names of ``MUTATIONS`` to run; all by default).
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
ICV_BWD = "licv_vqa_tpu_torch/csrc/icv_inject_bwd.cu"
KL = "licv_vqa_tpu_torch/csrc/masked_kl.cu"
ICV_FWD = "licv_vqa_tpu_torch/ops/icv_inject.py"
INT8 = "licv_vqa_tpu_torch/csrc/int8_matmul.cu"
INT4 = "licv_vqa_tpu_torch/csrc/int4_matmul.cu"
BIDIR = "licv_vqa_tpu_torch/csrc/flash_attn_bidir.cu"
# the causal flash forward and the ALiBi flash: one template
FLASH_FWD = "licv_vqa_tpu_torch/csrc/flash_fwd_sm90.cuh"
VIT = "licv_vqa_tpu_torch/csrc/vit_attention.cu"
FLASH_BWD = "licv_vqa_tpu_torch/csrc/flash_attn_bwd.cu"
W8A8 = "licv_vqa_tpu_torch/csrc/w8a8_matmul.cu"
PROBE4 = "licv_vqa_tpu_torch/csrc/int4_unpack_probe.cu"
KL_CASES = ("masked_kl_fwd", "masked_kl_bwd")
# the one-pass ViT schedule from P's fragments to the end of P.V
_VIT_PV = """\
    uint32_t pf[17][4];
    normalised_fragments(s, p_scale, pf);
    tail_fragment(s8, p_scale, pf[16]);
    mbar_wait(bar0 + 8, 0);
    fence_regs(o);
    fence_regs(o2);
    fence_regs(pf);
    wgmma_fence();
    pv_issue_vit<DH, 17>(o, o2, pf, base + L::v_a, base + L::v_b);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(o2);
"""
# name: (file, the kernel's line, its broken form, the cases that read it,
# the full-width gradient check that reads it: None, "training" or
# "flagship")
MUTATIONS = {
    "icv_bwd_no_norm_term": (
        ICV_BWD, "          d_h[i] = d_s[i] + k_h * (hv / n_h);\n", "          d_h[i] = d_s[i];\n",
        ("icv_inject_bwd",), "training"),
    # the first cluster partial of each half left out of the last
    # cluster's sum of the shift's gradient (reads where a segment has more
    # than one cluster)
    "icv_bwd_partial_dropped": (
        ICV_BWD, "      for (int q = half * per_half; q < q_end; ++q) {\n",
        "      for (int q = half * per_half + 1; q < q_end; ++q) {\n", ("icv_inject_bwd",), None),
    "kl_bwd_no_q_term": (
        KL, "        d_s[e] = g * (pv[e] * c_sum - qv[e] * __fdividef(pv[e], pv[e] + eps));\n",
        "        d_s[e] = g * (pv[e] * c_sum);\n", KL_CASES, None),
    "kl_bwd_no_mean_a": (
        KL, "        d_t[e] = g * (qv[e] * (a[e] - ea));\n",
        "        d_t[e] = g * (qv[e] * a[e]);\n", KL_CASES, None),
    # p without the thread's running max: the stored exps times exp(-lse)
    "kl_fwd_running_max_dropped": (
        KL, "      const float scale_s = exp_diff(chunk_max[0][j], lse_s);\n",
        "      const float scale_s = exp_diff(0.f, lse_s);\n", KL_CASES, None),
    # rank 0's (max, sum exp) left out of the cluster's merge (every case
    # whose row is split, all of phase 3's)
    "kl_merge_rank_dropped": (
        KL, "    for (int q = 0; q < k; ++q) {\n      l_s += row_pairs[q].y",
        "    for (int q = 1; q < k; ++q) {\n      l_s += row_pairs[q].y", KL_CASES, None),
    # a zero-weight row's gradients written as garbage (ones), not zeros
    # (reads on the masked cases)
    "kl_bwd_zero_row_not_zeroed": (
        KL, "  const float zero[4] = {0.f, 0.f, 0.f, 0.f};\n",
        "  const float zero[4] = {1.f, 1.f, 1.f, 1.f};\n", KL_CASES, None),
    # the block output's entry injects into h alone, the residual's delta
    # dropped (reads on the after_add cases)
    "icv_fused_delta_dropped": (
        ICV_FWD, "            h = (h + res).to(out_ptr.dtype.element_ty)\n",
        "            h = h.to(out_ptr.dtype.element_ty)\n", ("icv_inject",), None),
    "int8_no_column_scale": (
        INT8, "      const float y = v[u] * __ldg(p.s + n + u);  // the column scale, once\n",
        "      const float y = v[u];  // the column scale, once\n", ("int8_matmul",), None),
    # the cluster's split-K sum without rank 0's partial (every case that
    # splits K)
    "int8_split_partial_dropped": (
        INT8, "    for (int sp = 0; sp < splits; ++sp) {\n",
        "    for (int sp = 1; sp < splits; ++sp) {\n", ("int8_matmul",), None),
    # rows k and k + 1 swapped in every B register
    "int8_k_pair_swapped": (
        INT8,
        "  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);"
        "  // row k low, k+1 high\n",
        "  return __byte_perm(__float_as_uint(hi), __float_as_uint(lo), 0x7632);"
        "  // row k low, k+1 high\n", ("int8_matmul",), None),
    # the x plane of in-features i + K/2 against the low nibbles, and the
    # other way round
    "int4_planes_swapped": (
        INT4, "constexpr int kLoPlane = 0;\n", "constexpr int kLoPlane = 1;\n",
        ("int4_matmul",), None),
    # the low nibble read as q + 8 (128 subtracted where 136 is)
    "int4_low_nibble_unbiased": (
        INT4, "constexpr uint32_t kLoBias = 0x43084308u;\n",
        "constexpr uint32_t kLoBias = 0x43004300u;\n", ("int4_matmul",), None),
    # the high plane's partial times its low-plane group's scale (group g
    # where g + K/(2G)), on the path of G a multiple of 64 (phase 3's)
    "int4_scale_of_the_wrong_group": (
        INT4, "        fold(d + St::scales, d + St::scales + St::splane, wc, t, plo, phi, acc);\n",
        "        fold(d + St::scales, d + St::scales, wc, t, plo, phi, acc);\n",
        ("int4_matmul",), None),
    # every key inside S visible on a masked tile (the tail past S stays
    # masked): reads only where a patch mask is (the all-valid case is
    # unchanged)
    "bidir_no_segment_rule": (
        BIDIR, "  return vq == 1 ? real : vq == 0 ? pad : 0u;\n",
        "  return vq >= 0 ? real | pad : 0u;\n", ("flash_attention_bidir",), None),
    # the causal template's key loop: no key past the block's last query
    "bidir_causal_bound_left_in": (
        BIDIR,
        "  const int n_tiles = (p.S + kBlockN - 1) / kBlockN;  // no causal bound: every key tile\n",
        "  const int n_tiles = (min(p.S, m0 + kBlockM) + kBlockN - 1) / kBlockN;\n",
        ("flash_attention_bidir",), None),
    # the keys past S get the invalid rows' validity (TMA's zero rows): the
    # invalid rows attend the ragged tail; reads on the ragged case's
    # invalid rows only
    "bidir_tail_keys_visible": (
        BIDIR, "  return kj < S ? (valid_b != nullptr ? valid_b[kj] != 0 : 1) : -2;\n",
        "  return kj < S ? (valid_b != nullptr ? valid_b[kj] != 0 : 1) : 0;\n",
        ("flash_attention_bidir",), None),
    "alibi_bias_dropped": (
        FLASH_FWD,
        "  if constexpr (kBias == Bias::Alibi)"
        " return fmaf(slope_log2, float(k - q), qk * scale_log2);\n",
        "  if constexpr (kBias == Bias::Alibi) return qk * scale_log2;\n",
        ("flash_alibi_attention",), None),
    # the causal forward's rule for the ALiBi kernel: on the compared rows
    # (those with a visible key) it differs only where a right-pad row would
    # attend the real keys
    "alibi_segment_rule_for_valid": (
        FLASH_FWD,
        "  if constexpr (kRule == MaskRule::ValidKey) return vk != 0;"
        "  // every valid key (ALiBi)\n",
        "  if constexpr (kRule == MaskRule::ValidKey) return vk == vq;"
        "  // every valid key (ALiBi)\n",
        ("flash_alibi_attention",), None),
    # the causal forward: the ALiBi kernel's rule (a pad query attends no
    # key and writes 0): reads on the pad rows, which phase 3 compares
    "flash_fwd_no_segment_rule": (
        FLASH_FWD, "  return vk == vq;  // the segment rule: a pad query attends the pads\n",
        "  return vk != 0;  // the segment rule: a pad query attends the pads\n",
        ("flash_attention_fwd",), None),
    # the diagonal tile unmasked where its keys' validity matches the rows'
    # (the later keys visible); the ALiBi kernel shares the line
    "flash_fwd_diagonal_unmasked": (
        FLASH_FWD,
        "  const bool diag = n0 + kBlockN - 1 > rows.lo;"
        "  // a key past one of the warp's queries\n",
        "  const bool diag = false;\n", ("flash_attention_fwd",), None),
    # the log-sum-exp without its log l: read by the log-sum-exp check of
    # the backward cases (their forward) and by phase 9's gradients
    "flash_fwd_lse_without_log_l": (
        FLASH_FWD,
        "        p.lse[(static_cast<long long>(b) * p.H + h) * p.S + qi]"
        " = (m[r] + log2f(l[r])) * kLn2;\n",
        "        p.lse[(static_cast<long long>(b) * p.H + h) * p.S + qi] = m[r] * kLn2;\n",
        ("flash_attention_bwd",), "flagship"),
    # every key inside S counts: reads only on the masked cases
    "vit_key_mask_ignored": (
        VIT,
        "    terms[i] = i >= p.S ? -INFINITY : (valid_b == nullptr || valid_b[i] != 0 ? 0.f : -FLT_MAX);\n",
        "    terms[i] = i >= p.S ? -INFINITY : 0.f;\n", ("vit_attention",), None),
    # the keys past S (TMA's zero rows) score 0 and count in every row: the
    # one-pass schedule's 7 of 264 at S = 257, a two-pass tile's tail
    "vit_tail_keys_visible": (
        VIT,
        "    terms[i] = i >= p.S ? -INFINITY : (valid_b == nullptr || valid_b[i] != 0 ? 0.f : -FLT_MAX);\n",
        "    terms[i] = i >= p.S ? 0.f : (valid_b == nullptr || valid_b[i] != 0 ? 0.f : -FLT_MAX);\n",
        ("vit_attention",), None),
    # the causal flash backward: D = rowsum(do * o) left out of dS (the dQ
    # kernel writes the 0 it computes for the dK/dV kernel too)
    "flash_bwd_no_d": (
        FLASH_BWD,
        "      const float d_row = d + __shfl_xor_sync(0xffffffffu, d, 1);  // D = rowsum(do * o)\n",
        "      const float d_row = 0.f;\n", ("flash_attention_bwd",), "flagship"),
    # the log-sum-exp used without its log2(e) in both kernels (the dQ
    # kernel converts it once, for both): every P off by a factor
    "flash_bwd_lse_natural_log": (
        FLASH_BWD,
        "      const float lse2 = in ? p.lse[bh * p.S + qi] * kLog2e : 0.f;  // base 2, once\n",
        "      const float lse2 = in ? p.lse[bh * p.S + qi] : 0.f;  // base 2, once\n",
        ("flash_attention_bwd",), "flagship"),
    # every key up to the query inside S visible: reads only where a row is
    # padded (all but the all-valid case)
    "flash_bwd_no_segment_rule": (
        FLASH_BWD, "  return kj <= qi && seg_k == seg_q;\n",
        "  return kj <= qi && seg_k >= 0 && seg_q >= 0;\n", ("flash_attention_bwd",), "flagship"),
    "flash_bwd_dk_unscaled": (
        FLASH_BWD, "    store_rows(p.dk, dk, krow, b, h, p.S, p.H, p.scale);\n",
        "    store_rows(p.dk, dk, krow, b, h, p.S, p.H, 1.f);\n",
        ("flash_attention_bwd",), "flagship"),
    # w8a8 (phase 3's limit: equality): ties and every non-integer quotient
    # rounded toward zero; the absmax of the first K tile only (the rows'
    # scales too small: values clamp); the activation scale dropped
    "w8a8_round_toward_zero": (
        W8A8, "  const int r = __float2int_rn(y);\n", "  const int r = __float2int_rz(y);\n",
        ("w8a8_matmul",), None),
    "w8a8_absmax_first_tile_only": (
        W8A8, "  const int k_end = K;  // the absmax runs over the whole row\n",
        "  const int k_end = min(K, kBK);\n", ("w8a8_matmul",), None),
    "w8a8_activation_scale_dropped": (
        W8A8, "  return __fmul_rn(__fmul_rn(__int2float_rn(c), xsr), sc);\n",
        "  return __fmul_rn(__int2float_rn(c), sc);\n", ("w8a8_matmul",), None),
    # the s8 B fragments: tile 0 gets tile 1's columns (the interleaved n8
    # tiles' mapping); and the K-rows of the lanes t >= 2, loaded rotated by
    # two for the banks, left in load order
    "w8a8_n8_tiles_swapped": (
        W8A8, "  b[0] = __byte_perm(lo01, lo23, sel_lo);\n",
        "  b[0] = __byte_perm(lo01, lo23, sel_hi);\n", ("w8a8_matmul",), None),
    "w8a8_row_rotation_not_undone": (
        W8A8, "    const uint32_t sel_lo = t & 2 ? 0x1054u : 0x5410u;\n",
        "    const uint32_t sel_lo = 0x5410u;\n", ("w8a8_matmul",), None),
    # schedule e reads its nibbles unsigned (reads on the e cases only)
    "int4_probe_e_not_sign_extended": (
        PROBE4,
        "template <> struct Planes<kE> { static constexpr Nib lo = Nib::Signed, hi = Nib::Signed; };\n",
        "template <> struct Planes<kE> { static constexpr Nib lo = Nib::Unbiased, hi = Nib::Unbiased; };\n",
        ("int4_unpack_probe",), None),
    # P rounded to bf16 before it is normalised, the output divided by l
    # after P.V (the flash kernels' rounding point; the tensor cores take P
    # in bf16, so "not rounded" moves the rounding): one pass (S <= 264)
    # only.  About an ulp of every output: under phase 3's max-abs limit,
    # above its mean-error limit for the fused ViT (VIT_MEAN_TOL)
    "vit_probabilities_not_rounded": (
        VIT, "    const float p_scale[2] = {1.f / l[0], 1.f / l[1]};\n" + _VIT_PV + "  } else {\n",
        "    const float p_scale[2] = {1.f, 1.f};\n" + _VIT_PV
        + "    for (int i = 0; i < 32; ++i) o[i] /= l[(i / 2) % 2];\n"
        "    for (int i = 0; i < 8; ++i) o2[i] /= l[(i / 2) % 2];\n  } else {\n",
        ("vit_attention",), None),
}
PROBE = """
import sys, torch, chip_smoke as C
for c in C.kernel_cases(torch.device("cuda")):
    if c.name in sys.argv[1:]:
        try:
            _, ratio = C.compare(*(c.check or (c.kernel, c.plain)), c.rows)
            mean = "" if c.mean_tol is None else (
                f", mean ratio {C.mean_ratio(c.kernel, c.plain, c.rows):.3e}"
                f" (limit {c.mean_tol})")
            print(f"  {c.name} {c.label}: ratio {ratio:.3e} (limit {c.tol}){mean}", flush=True)
        except AssertionError as e:
            print(f"  {c.name} {c.label}: {e}", flush=True)
"""
GRADIENT_PROBES = {
    "training": """
import tempfile, torch, chip_smoke as C
from pathlib import Path
with tempfile.TemporaryDirectory() as tmp:
    C.write_training_split(Path(tmp))
    r = C.gradient_check(C.training_inputs(torch.device("cuda", 0)))
print(f"  full-width gradient check: {r} (limit {C.REL_L2_TOL})", flush=True)
""",
    "flagship": """
import torch, chip_smoke as C
dev = torch.device("cuda", 0)
tool = C.bench_tool()
_, _, params, batch, _ = tool._build("flagship", "inner", dev)
r = C.flagship_gradient_check(tool, "flagship", "inner", params, batch, dev)
print(f"  flagship gradient check: {r} (limit {C.REL_L2_TOL})", flush=True)
""",
}


def main(names=None) -> int:
    names = names or list(MUTATIONS)
    unknown = sorted(set(names) - set(MUTATIONS))
    if unknown:
        raise SystemExit(f"unknown mutations {unknown}; known: {sorted(MUTATIONS)}")
    with tempfile.TemporaryDirectory(prefix="mutation_check_") as tmp:
        for name in names:
            path, line, broken, cases, gradient = MUTATIONS[name]
            dst = Path(tmp) / name
            shutil.copytree(REPO, dst, ignore=shutil.ignore_patterns(
                ".git", "_archive", "*_out", "_build", "__pycache__"))
            f = dst / path
            text = f.read_text()
            if text.count(line) != 1:
                raise RuntimeError(f"{name}: the line to break is not in {path} once")
            f.write_text(text.replace(line, broken))
            print(name, flush=True)
            for probe in (PROBE, GRADIENT_PROBES[gradient]) if gradient else (PROBE,):
                r = subprocess.run([sys.executable, "-c", probe, *cases], cwd=dst, text=True,
                                   capture_output=True, timeout=600)
                print(r.stdout, end="", flush=True)
                if r.returncode:
                    print(r.stderr[-2000:], flush=True)
                    return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
