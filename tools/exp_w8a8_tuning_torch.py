#!/usr/bin/env python
"""Where does w8a8 prefill lose to the card's int8 peak?  The PyTorch/CUDA
counterpart of ``tools/exp_w8a8_tuning.py``, on one NVIDIA GPU.

Variants, at the flagship decoder's prefill matmuls (d=4096, d_ff=11008)
at serving token counts M = bs·prompt (64 x 64 = 4096; ``--wide`` adds
(4096, 4096, 4096) and the teacher length 8 x 2048 = 16384):

  a_bf16              dense bf16 matmul (the rate w8a8 must beat)
  b_w8a8              the port's route (``ops/int8_matmul.qdot`` with
                      ``a8``): the fused entry point of
                      ``csrc/w8a8_matmul.cu``
  c_s8s8              ``torch._int_mm`` on activations quantized
                      beforehand, then the scales: isolates the activation
                      quantization from the matmul itself
  d_kernel_<tile>     the pre-quantized entry point, per tile
                      (``W8A8_TILES``: the weight-streaming tile and the
                      compute tile)
  e_kernel_fused_<t>  the fused entry point (a row pass writes each row's
                      scale and int8 plane once, then the matmul), per tile

``b`` must equal its plain version (``w8a8_matmul_reference``) exactly,
and each variant is checked against that output with the JAX tool's rule
(relative error < 2e-2 of its max-abs; ``a`` is printed, not checked),
its max-abs error printed.  Times: CUDA events around
``--reps`` back-to-back calls, as % of the H100's dense peaks (1979 TOP/s
int8, 989 TFLOP/s bf16), with the card's name and power limit.

Usage, from the repository root:
    python tools/exp_w8a8_tuning_torch.py [--wide] [--only=d,e] [--reps 30]
    python tools/exp_w8a8_tuning_torch.py --device cpu --shape 24,96,40
(on the CPU the wrappers take their plain versions and the times are the
host's, not the card's).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

INT8_PEAK_TOPS = 1979e12
BF16_PEAK_FLOPS = 989e12
SHAPES = ((4096, 4096, 11008), (4096, 11008, 4096))  # MLP in, MLP out
WIDE_SHAPES = SHAPES + ((4096, 4096, 4096), (16384, 4096, 11008))
REL_LIMIT = 2e-2  # the JAX tool's rule against b


def variants(m, k, n, dev, tiles):
    """``({name: (fn, peak, kernel wrapper calls a call)}, plain)`` at one
    shape, on operands drawn as the JAX tool draws them."""
    import torch

    from licv_vqa_tpu_torch.ops import int8_matmul as I8
    from licv_vqa_tpu_torch.ops.quantize import quantize_array

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev, torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32) * 0.02).to(dev)
    leaf = quantize_array(w)
    q, s = leaf["q"], leaf["s"]
    wb = w.to(torch.bfloat16)
    del w
    xq, xs = I8.quantize_act_rows(x)
    bf16 = torch.bfloat16
    if dev.type == "cuda" and k % 8 == 0 and n % 8 == 0:
        xq_p = I8.pad_rows_for_int_mm(xq)  # padded once, outside the timed calls

        def c_s8s8():
            return (torch._int_mm(xq_p, q)[:m].float() * xs * s).to(bf16)
    else:
        def c_s8s8():
            return (I8._int_product(xq, q) * xs * s).to(bf16)

    out = {
        "a_bf16": (lambda: x @ wb, BF16_PEAK_FLOPS, 0),
        "b_w8a8": (lambda: I8.qdot(x, leaf, preferred_element_type=bf16, a8=True),
                   INT8_PEAK_TOPS, 1),
        "c_s8s8": (c_s8s8, INT8_PEAK_TOPS, 0),
    }
    for t in tiles:
        out[f"d_kernel_{t}"] = (
            lambda t=t: I8.w8a8_matmul_prequantized(xq, xs, q, s, bf16, tile=t),
            INT8_PEAK_TOPS, 1)
    for t in tiles:
        out[f"e_kernel_fused_{t}"] = (
            lambda t=t: I8.w8a8_matmul(x, q, s, bf16, tile=t), INT8_PEAK_TOPS, 1)
    plain = lambda: I8.w8a8_matmul_reference(x, q, s, bf16)  # noqa: E731
    return out, plain


def run(dev, shapes=SHAPES, tiles=None, only=(), reps: int = 30) -> list:
    """Every variant at every shape: one dict a variant (shape, name, us,
    pct_peak, rel, max_abs, launches: its calls of the kernel wrappers,
    each a kernel launch on the card)."""
    from licv_vqa_tpu_torch.utils.profiling import per_call_us

    from licv_vqa_tpu_torch.ops.int8_matmul import W8A8_TILES

    rows = []
    for m, k, n in shapes:
        vs, plain = variants(m, k, n, dev, tiles or W8A8_TILES)
        ref = plain().float()  # b's plain version: b must equal it
        print(f"== M={m} K={k} N={n} ==", flush=True)
        flops = 2.0 * m * k * n
        for name, (fn, peak, per_call) in vs.items():
            if only and not any(name.startswith(p) for p in only):
                continue
            got = fn().float()
            err = (got - ref).abs().max().item()
            rel = err / (ref.abs().max().item() + 1e-9)
            if name == "b_w8a8" and err != 0:
                raise AssertionError(f"({m},{k},{n}) b_w8a8 differs from its plain version "
                                     f"by {err}")
            if name != "a_bf16" and not rel < REL_LIMIT:
                raise AssertionError(f"({m},{k},{n}) {name}: rel. error {rel} >= {REL_LIMIT}")
            us = per_call_us(fn, reps, dev)
            # a share of the card's peak from a card's time only
            pct = flops / (us * 1e-6) / peak * 100 if dev.type == "cuda" else None
            # the check, the warm call and the reps
            rows.append(dict(shape=(m, k, n), name=name, us=us, pct_peak=pct, rel=rel,
                             max_abs=err, launches=per_call * (2 + reps)))
            share = f"{pct:5.1f}% of peak" if pct is not None else "(host time)"
            print(f"  {name:24s} {us:10.1f} us  {share}  rel {rel:.2e}  max-abs {err:.3e}",
                  flush=True)
        del vs, plain, ref
    return rows


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wide", action="store_true")
    ap.add_argument("--only", default="", help="comma-separated name prefixes")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shape", action="append", default=[], help="M,K,N (repeatable)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("exp_w8a8_tuning_torch: no CUDA device (use --device cpu)", file=sys.stderr)
        return 1
    from licv_vqa_tpu_torch.utils.profiling import card

    shapes = ([tuple(int(v) for v in s.split(",")) for s in args.shape]
              or (WIDE_SHAPES if args.wide else SHAPES))
    print(f"device: {card(dev)}; peaks: {INT8_PEAK_TOPS / 1e12:.0f} TOP/s int8, "
          f"{BF16_PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16"
          + ("" if dev.type == "cuda" else " (host times on the CPU: not device metrics)"),
          flush=True)
    run(dev, shapes, None, tuple(p for p in args.only.split(",") if p), args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
