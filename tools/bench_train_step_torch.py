#!/usr/bin/env python
"""Flagship train-step benchmark of the PyTorch/CUDA port: step time per
remat mode (counterpart of ``tools/bench_train_step_tpu.py``).

The same shapes, batch, loss setup and FLOPs model as the JAX tool, on one
NVIDIA GPU: the tiny CLI shape (s_tea 64, s_stu 32, bs 2) and the flagship
(Idefics-9B at full width, int8 frozen weights on ``layers`` and ``xattn``,
s_tea 2048 from ``TRAINBENCH_SEQ``, s_stu 256, bs 4 from ``TRAINBENCH_BS``),
``hard_loss_weight=0.5``, ``warm_steps=0``, the gather-before-head teacher
(``TRAINBENCH_LEGACY_HEAD=1`` for the full-logits path).  At the flagship
the 256-token student takes the flash kernels under autograd
(``csrc/flash_attn_fwd.cu`` with its log-sum-exp, ``csrc/flash_attn_bwd.cu``)
and the 2048-token teacher the forward kernel.

Nothing is compiled ahead of the first step, so the JAX tool's ``trace_s``
and ``compile_s`` become ``first_step_s``, the first step's wall (kernel
builds, Triton specialisations and the allocator's warm-up included).
``mfu_pct_bf16_peak`` divides by the H100's 989 TFLOP/s dense bf16, and the
line names the card (``nvidia-smi``'s name and power limit).

Each mode runs in its own subprocess with a budget.  Usage, from the
repository root on a machine with the card:
    python tools/bench_train_step_torch.py                  # tiny, all modes
    python tools/bench_train_step_torch.py --flagship       # 32L, inner,both
    python tools/bench_train_step_torch.py --run tiny:inner # one child
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

S_STU = 256  # student (zero-shot query) length
PROMPT_IMG = 1
BF16_PEAK = 989e12  # H100 SXM dense bf16 tensor-core rate


def _n_elems(tree) -> int:
    """Elements of a param tree, a quantized leaf counted by its plane."""
    from licv_vqa_tpu_torch.ops.quantize import is_any_quantized_leaf

    if is_any_quantized_leaf(tree):
        return (tree["q"] if "q" in tree else tree["q4"]).numel()
    if isinstance(tree, dict):
        return sum(_n_elems(v) for v in tree.values())
    return tree.numel()


def shape_config(shape: str, mode: str):
    """``(cfg, s_tea, s_stu, bs, quantize)`` of the tiny or the flagship
    shape under remat ``mode``."""
    from licv_vqa_tpu_torch.models.idefics import IdeficsConfig

    if shape == "tiny":
        cfg = IdeficsConfig.tiny()
        s_tea, s_stu, bs = 64, 32, 2
        quantize = False
    else:  # flagship: 32L 4096d, int8 frozen weights, as the JAX tool runs it
        cfg = IdeficsConfig.idefics_9b()
        s_tea = int(os.environ.get("TRAINBENCH_SEQ", 2048))
        s_stu, bs = S_STU, int(os.environ.get("TRAINBENCH_BS", 4))
        quantize = True
    return dataclasses.replace(cfg, remat_mode=mode), s_tea, s_stu, bs, quantize


def build_params(cfg, quantize: bool, device):
    """The tool's frozen weights: Idefics params drawn from a seed-0
    generator on ``device``, ``layers`` and ``xattn`` int8 under
    ``quantize``."""
    import torch

    from licv_vqa_tpu_torch.models.idefics import init_idefics_params

    params = init_idefics_params(torch.Generator(device).manual_seed(0), cfg, device)
    if quantize:
        from licv_vqa_tpu_torch.ops.quantize import quantize_layer_stack

        params["layers"] = quantize_layer_stack(params["layers"])
        params["xattn"] = quantize_layer_stack(params["xattn"])
    return params


def _build(shape: str, mode: str, device):
    """``(step, state, params, batch, meta)`` of one shape and remat mode on
    ``device``, as the JAX tool's ``_build``."""
    import torch

    from licv_vqa_tpu_torch.icv.encoder import GlobalICVEncoder
    from licv_vqa_tpu_torch.icv.module import ICVModuleConfig, init_train_state, make_train_step
    from licv_vqa_tpu_torch.models.idefics import make_idefics_forward_fns

    device = torch.device(device)
    cfg, s_tea, s_stu, bs, quantize = shape_config(shape, mode)
    params = build_params(cfg, quantize, device)

    train_forward, _ = make_idefics_forward_fns(cfg, eos_token_id=2)
    t = cfg.text
    encoder = GlobalICVEncoder(t.d_model, t.n_layers,
                               generator=torch.Generator().manual_seed(1), device=device)
    mcfg = ICVModuleConfig(hard_loss_weight=0.5, warm_steps=0)
    state = init_train_state(encoder, mcfg, total_steps=100)
    head_fn = None
    if os.environ.get("TRAINBENCH_LEGACY_HEAD", "0") != "1":
        from licv_vqa_tpu_torch.models.decoder import logits_from_hidden

        head_fn = lambda p, h: logits_from_hidden(t, p, h)  # noqa: E731
    step = make_train_step(train_forward, mcfg, pad_token_id=0, head_fn=head_fn)

    rng = np.random.default_rng(0)
    img_hw = cfg.vision.image_size

    def inputs(s):
        ids = rng.integers(3, t.vocab_size - 10, size=(bs, s)).astype(np.int32)
        ids[:, 1] = cfg.image_token_id
        pixels = rng.normal(size=(bs, PROMPT_IMG, img_hw, img_hw, 3)).astype(np.float32)
        return {
            "input_ids": torch.from_numpy(ids).to(device),
            "attention_mask": torch.ones((bs, s), dtype=torch.int32, device=device),
            "pixel_values": torch.from_numpy(pixels).to(device),
            "pixel_valid": torch.ones((bs, PROMPT_IMG), dtype=torch.bool, device=device),
        }

    batch = {
        "query_inputs": inputs(s_stu),
        "inputs": inputs(s_tea),
        "query_x_length": torch.full((bs,), s_stu // 2, dtype=torch.int32, device=device),
        "in_context_length": torch.full((bs,), s_tea - s_stu // 2, dtype=torch.int32,
                                        device=device),
    }

    # the JAX tool's roofline FLOPs model: teacher fwd 2·P_act a token over
    # bs·s_tea; student fwd + recompute + activation-grad bwd 6·P_act over
    # bs·s_stu (frozen weights: no dW products); heads at D·V a position
    # (the teacher's over the gathered s_stu window); the towers' forward
    # per image on both streams
    p_act = sum(_n_elems(params[key]) for key in ("layers", "xattn"))
    d, v = t.d_model, t.vocab_size
    vit_flops = 2.0 * sum(_n_elems(params[key]) for key in ("vision", "perceiver"))
    head = 2.0 * d * v
    flops = (
        2.0 * p_act * bs * s_tea
        + 6.0 * p_act * bs * s_stu
        + head * bs * s_stu
        + 3.0 * head * bs * s_stu
        + vit_flops * bs * 2 * PROMPT_IMG
    )
    meta = dict(s_tea=s_tea, s_stu=s_stu, bs=bs, model_tflops=round(flops / 1e12, 1))
    return step, state, params, batch, meta


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def measure(step, state, params, batch, meta, reps: int = 3) -> dict:
    """The first step's wall, then the mean of ``reps`` steps (host clock
    around work that ends in a device synchronise)."""
    import torch

    def one() -> float:
        loss = float(step(state, params, batch)["loss"])  # a host read: a sync
        torch.cuda.synchronize()
        return loss

    t0 = time.perf_counter()
    loss0 = one()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        one()
    dt = (time.perf_counter() - t0) / reps
    out = {
        **meta,
        "first_step_s": round(first, 1),
        "step_ms": round(dt * 1e3, 1),
        "tokens_per_sec": round(meta["bs"] * (meta["s_tea"] + meta["s_stu"]) / dt, 0),
        "loss": round(loss0, 4),
    }
    # train matmuls are bf16 with int8 frozen weights too (weight-only)
    out["mfu_pct_bf16_peak"] = round(100 * meta["model_tflops"] * 1e12 / dt / BF16_PEAK, 1)
    return out


def _child(spec: str) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_train_step_torch: needs an NVIDIA GPU")
    shape, mode = spec.split(":")
    built = _build(shape, mode, torch.device("cuda", 0))
    out = {"shape": shape, "mode": mode, **measure(*built), "card": card()}
    print(json.dumps(out), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--flagship", action="store_true")
    ap.add_argument("--modes", default=None)
    ap.add_argument("--budget", type=int, default=2400)
    args = ap.parse_args()
    shape = "flagship" if args.flagship else "tiny"
    modes = (args.modes or ("inner,policy,outer,both" if shape == "tiny"
                            else "inner,both")).split(",")
    for mode in modes:
        spec = f"{shape}:{mode}"
        t0 = time.monotonic()
        try:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--run", spec],
                capture_output=True, text=True, timeout=args.budget,
            )
        except subprocess.TimeoutExpired:
            print(f"{spec}: exceeded {args.budget}s budget", flush=True)
            continue
        out = proc.stdout.strip().splitlines()
        if proc.returncode == 0 and out:
            print(out[-1], flush=True)
        else:
            print(
                f"{spec}: rc={proc.returncode} in {time.monotonic()-t0:.0f}s\n"
                f"{proc.stderr[-1500:]}",
                flush=True,
            )


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--run":
        _child(sys.argv[2])
    else:
        main()
