#!/usr/bin/env python
"""Chip smoke test of the PyTorch/CUDA port (``licv_vqa_tpu_torch``) on one
NVIDIA GPU.  Run from the repository root: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero before the result lines):

1. require ``torch.cuda.is_available()``; print the card's name and power
   limit as ``nvidia-smi`` reports them;
2. build the CUDA library from ``licv_vqa_tpu_torch/csrc`` (nvcc, sm_90a)
   and print the build time;
3. hold each kernel against its plain PyTorch version on the same bf16
   inputs at the main path's shapes, printing the max-abs error (limit
   ``REL_TOL`` times the plain output's max-abs) and two times for each:
   the device time per call (the sum of the device-kernel intervals that
   ``torch.profiler`` records over many calls, divided by the calls) and
   the host-clocked time per call (CUDA events around back-to-back calls,
   median of several runs; launch costs included).  The ICV injection at
   (1, 512, 4096), (1, 64, 4096) and (3, 1, 4096) for each shift layout,
   the flash-attention forward at (1, S, 32, 128) for S = 384, 512 and
   2048 with left padding;
4. the main path at Idefics-9B FULL width (32 layers, d=4096, ViT-H, 6-layer
   perceiver, 8 cross-attention blocks; random bf16 weights made on the card
   from a seed, ~18 GB), through the runner entry points the CLI calls
   (``icv_inference`` / ``icl_inference``) with the CLI's composed config and
   in-memory 224x224 uint8 images: ``test_icv`` with a random (32, 4096) ICV
   read back from an ``icv_cpk.pth``, beam-3, ``max_new_tokens=5``; then
   ``test_icl`` with 32 shots, whose prompt is >= 256 tokens.  The kernel
   launch counts are zeroed before and read after each; the ICV count must
   equal 32 x forward passes and the flash count 32 x questions.  Prints
   per-question latency, peak memory, and checks the answers: decoded
   strings scored by the port CLI's VQA accuracy, and the full-width ICL prefill
   logits with the flash kernel against the plain attention path;
5. one ``{"kernels": [...]}`` line;
6. the last line: ``{"ok": true, "device": {...}}``.

The port CLI itself is held against ``inference.py`` by
``tests/test_torch_cli.py``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
# kernel vs plain, bf16 in/out and f32 math on both sides: max-abs error
# <= REL_TOL * max|plain|.  One bf16 ulp is at most 2^-7 of a value, so this
# allows about 2.5 ulps at the largest output; a kernel with a wrong mask or
# a wrong shift row reads far above it (PERF.md, Findings).
REL_TOL = 2e-2
# whole-model check: 32 bf16 layers amplify the kernels' rounding
# differences (the plain attention rounds probabilities to bf16 before P·V)
REL_L2_TOL = 0.1
N_ICV_Q = 4
N_ICL_Q = 2
ICL_SHOTS = 32
MAX_NEW = 5


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 5, inner: int = 20) -> float:
    """Median over ``reps`` of the mean per-launch time of ``inner``
    back-to-back launches (CUDA events), after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return sorted(times)[len(times) // 2]


def device_ms(fn, calls: int) -> float:
    """Device time per call of ``fn``: the sum of the device-kernel
    intervals ``torch.profiler`` records over ``calls`` calls, divided by
    ``calls``.  Host launch gaps between kernels are not counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(
        e.time_range.end - e.time_range.start
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    if us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return us / calls / 1e3


def kernel_cases(dev):
    """The kernel-vs-plain cases at the main path's shapes, from a seed:
    ``(kernel name, label, kernel call, plain call)``."""
    import torch

    from licv_vqa_tpu_torch.models import layers as L
    from licv_vqa_tpu_torch.ops.icv_inject import icv_inject, icv_inject_reference

    g = torch.Generator(device=dev).manual_seed(0)
    for (b, s, d) in ((1, 512, 4096), (1, 64, 4096), (3, 1, 4096)):
        h = torch.randn((b, s, d), generator=g, device=dev).to(torch.bfloat16)
        layouts = (("row", (d,)), ("batch", (b, d)), ("batch1", (b, 1, d)), ("per_pos", (b, s, d)))
        for layout, vshape in layouts:
            v = (torch.randn(vshape, generator=g, device=dev) * 0.5).to(torch.bfloat16)
            yield (
                "icv_inject", f"({b},{s},{d}) shift={layout}",
                lambda h=h, v=v: icv_inject(h, v),
                lambda h=h, v=v: icv_inject_reference(h, v),
            )
    for s, pad in ((384, 57), (512, 39), (2048, 301)):
        q, k, v = (
            torch.randn((1, s, 32, 128), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(3)
        )
        valid = torch.ones((1, s), dtype=torch.int32, device=dev)
        valid[:, :pad] = 0  # left padding, as the decode prompts are
        yield (
            "flash_attention_fwd", f"(1,{s},32,128) left pad {pad}",
            lambda q=q, k=k, v=v, valid=valid: L.flash_attention(q, k, v, valid),
            lambda q=q, k=k, v=v, valid=valid: L.flash_attention_reference(q, k, v, valid),
        )


def compare(kernel, plain) -> tuple[float, float]:
    """``(max-abs error, max|plain|)`` of one kernel call against its plain
    version on the same inputs; a non-finite kernel output raises."""
    import torch

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite kernel output")
    return (got.float() - want.float()).abs().max().item(), want.float().abs().max().item()


# the main path's most frequent call of each kernel: the ICV injection at a
# beam step (32 per step), the flash forward at the 32-shot prefill (512)
MAIN_SHAPE = {"icv_inject": "(3,1,4096) shift=row", "flash_attention_fwd": "(1,512,32,128)"}


def check_kernels(dev) -> dict:
    """Phase 3.  Returns per-kernel summaries for the kernels line."""
    out = {}
    for name, label, kernel, plain in kernel_cases(dev):
        err, ref_max = compare(kernel, plain)
        calls = 50 if name == "icv_inject" else 5
        dev_ms, dev_plain = device_ms(kernel, calls), device_ms(plain, calls)
        ev_ms, ev_plain = time_ms(kernel, inner=calls), time_ms(plain, inner=calls)
        log(f"{name} {label}: max_abs={err:.3e} (max|plain| {ref_max:.3e}, "
            f"ratio {err / ref_max:.3e}); device {dev_ms:.5f} ms vs plain {dev_plain:.5f} ms; "
            f"host-clocked {ev_ms:.4f} ms vs plain {ev_plain:.4f} ms")
        if not err <= REL_TOL * ref_max:
            raise AssertionError(f"{name} {label} disagrees: {err} > {REL_TOL} x {ref_max}")
        row = out.setdefault(name, dict(max_abs_err=0.0))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if label.startswith(MAIN_SHAPE[name]):
            row.update(ms=dev_ms, plain_ms=dev_plain)
    return out


def synthetic_vqa(n: int, offset: int, seed: int):
    """In-memory VQA rows with 224x224 uint8 images."""
    import numpy as np

    rng = np.random.default_rng(seed)
    answers = ["red", "blue", "two", "cat", "yes", "no"]
    rows = []
    for i in range(n):
        ans = answers[i % len(answers)]
        rows.append({
            "question_id": offset + i,
            "image_id": offset + 1000 + i,
            "image": rng.integers(0, 255, size=(224, 224, 3), dtype=np.uint8),
            "question": f"What is the color of thing {i}?",
            "answer": ans,
            "answers": [{"answer": ans, "answer_id": j + 1} for j in range(10)],
            "question_type": "what",
            "answer_type": "other",
        })
    return rows


def vqa_accuracy(results: dict, rows: list, tmp: Path, tag: str) -> float:
    """The port CLI's VQA scoring over question and annotation files made
    from ``rows``."""
    from licv_vqa_tpu.metrics import vqa_postprocess
    from licv_vqa_tpu_torch.cli.inference import evaluate_vqa

    ques = tmp / f"{tag}_questions.json"
    anns = tmp / f"{tag}_annotations.json"
    ques.write_text(json.dumps({"questions": [
        {k: r[k] for k in ("question_id", "image_id", "question")} for r in rows
    ]}))
    anns.write_text(json.dumps({"annotations": [
        {k: r[k] for k in ("question_id", "image_id", "question_type", "answer_type", "answers")}
        | {"multiple_choice_answer": r["answer"]}
        for r in rows
    ]}))
    acc = evaluate_vqa(results, "idefics-9b", str(ques), str(anns), vqa_postprocess)
    return float(acc["overall"])


def main_path(dev, tmp: Path) -> dict:
    """Phase 4.  Returns the launch counts of the main path."""
    import dataclasses

    import torch

    from licv_vqa_tpu.api import init_prompt_manager
    from licv_vqa_tpu.data.processor import CLIP_MEAN, CLIP_STD
    from licv_vqa_tpu.utils import compose
    from licv_vqa_tpu_torch.infer.runner import icl_inference, icv_inference
    from licv_vqa_tpu_torch.models import idefics as I
    from licv_vqa_tpu_torch.models import layers as L
    from licv_vqa_tpu_torch.models.registry import _wrap_pixel_normalize, build_model
    from licv_vqa_tpu_torch.ops.icv_inject import icv_inject
    from licv_vqa_tpu_torch.train.checkpoint import load_icv_checkpoint

    for key in ("RESULT_DIR", "MODEL_CPK_DIR", "VQAV2_PATH", "COCO_PATH", "OKVQA_PATH"):
        os.environ[key] = str(tmp / key.lower())
    cfg = compose(str(REPO / "config"), "inference", [
        "lmm=idefics-9B", "device=cuda", "run_name=chip_smoke", "bs=1",
        f"generate_kwargs.max_new_tokens={MAX_NEW}", "generate_kwargs.num_beams=3",
        "generate_kwargs.length_penalty=0.0",
    ])
    gen_kwargs = cfg.generate_kwargs.to_dict()
    instruction = str(cfg.prompt.instruction)

    t0 = time.perf_counter()
    bundle = build_model(cfg, device=dev)  # no weights on disk: random init
    torch.cuda.synchronize()
    n_params = sum(
        x.numel() for x in _leaves(bundle.params)
    )
    log(f"model: Idefics-9B full width, {n_params / 1e9:.3f} B params bf16, "
        f"built in {time.perf_counter() - t0:.1f} s")
    t = bundle.model_cfg.text
    if (t.n_layers, t.d_model, bundle.model_cfg.vision.d_model) != (32, 4096, 1280):
        raise AssertionError(f"not full width: {t}")

    # a random ICV written in the reference artifact layout, read back by the port
    g = torch.Generator().manual_seed(0)
    cpk = tmp / "icv_cpk" / "icv_cpk.pth"
    cpk.parent.mkdir(parents=True)
    torch.save({
        "icv_encoder.icv": torch.randn((1, t.n_layers, t.d_model), generator=g) * 0.05,
        "icv_encoder.alpha": torch.full((1, t.n_layers), 0.5),
        "use_sigmoid": False,
        "lmm_args": {"total_layers": t.n_layers, "intervention_layer": -1},
    }, cpk)
    loaded = load_icv_checkpoint(cpk.parent, device=dev)
    icv_scaled = loaded["alpha"][:, None] * loaded["icv"]

    pm = init_prompt_manager(cfg)
    val = synthetic_vqa(N_ICV_Q + 1, 100, seed=1)
    train = synthetic_vqa(ICL_SHOTS + 8, 500, seed=2)
    shots = [list(range(i, i + ICL_SHOTS)) for i in range(N_ICL_Q + 1)]

    # ICL prompt length (the flash gate needs >= 256 tokens)
    p = [instruction]
    for si in shots[0]:
        p += [train[si]["image"], pm.gen_ice_text_with_label(train[si], add_sep_token=True)]
    p += [val[0]["image"], pm.gen_query_text_without_label(val[0])]
    enc = bundle.processor.prepare_input([p], padding=True, padding_side="left")
    s_icl = enc["input_ids"].shape[1]
    log(f"test_icl prompt: {int(enc['attention_mask'].sum())} tokens, padded to {s_icl}, "
        f"{enc['pixel_values'].shape[1]} images")
    if s_icl < 256:
        raise AssertionError(f"ICL prompt {s_icl} < 256: the flash path would not run")

    # warm-up (Triton specialisations, library load, allocator) on one question
    icv_inference(val[:1], bundle, pm, 1, gen_kwargs, instruction, icv_scaled, progress=False)
    icl_inference(train, val[:1], shots[:1], bundle, pm, 1, gen_kwargs, instruction, progress=False)
    torch.cuda.synchronize()

    counts = {}
    torch.cuda.reset_peak_memory_stats(dev)
    icv_inject.launches = 0
    L.flash_attention.launches = 0
    t0 = time.perf_counter()
    res_icv = icv_inference(
        val[1:], bundle, pm, 1, gen_kwargs, instruction, icv_scaled, progress=False
    )
    torch.cuda.synchronize()
    dt_icv = (time.perf_counter() - t0) / N_ICV_Q
    counts["icv_inject", "test_icv"] = icv_inject.launches
    counts["flash", "test_icv"] = L.flash_attention.launches

    icv_inject.launches = 0
    L.flash_attention.launches = 0
    t0 = time.perf_counter()
    res_icl = icl_inference(
        train, val[1 : 1 + N_ICL_Q], shots[1:], bundle, pm, 1, gen_kwargs, instruction,
        progress=False,
    )
    torch.cuda.synchronize()
    dt_icl = (time.perf_counter() - t0) / N_ICL_Q
    counts["icv_inject", "test_icl"] = icv_inject.launches
    counts["flash", "test_icl"] = L.flash_attention.launches
    peak = torch.cuda.max_memory_allocated(dev) / 2**30

    forwards = N_ICV_Q * MAX_NEW  # bs=1: one prefill + (max_new - 1) beam steps each
    log(f"test_icv: {N_ICV_Q} questions, {dt_icv * 1e3:.1f} ms/question; "
        f"icv_inject launches {counts['icv_inject', 'test_icv']} "
        f"(want 32 x {forwards} forwards = {32 * forwards}), "
        f"flash launches {counts['flash', 'test_icv']}")
    log(f"test_icl ({ICL_SHOTS}-shot): {N_ICL_Q} questions, {dt_icl * 1e3:.1f} ms/question; "
        f"flash launches {counts['flash', 'test_icl']} (want 32 x {N_ICL_Q}), "
        f"icv_inject launches {counts['icv_inject', 'test_icl']}")
    log(f"peak device memory over both: {peak:.2f} GiB")
    if counts["icv_inject", "test_icv"] != 32 * forwards:
        raise AssertionError("icv_inject launch count != 32 x forward passes")
    if counts["flash", "test_icl"] != 32 * N_ICL_Q:
        raise AssertionError("flash launch count != 32 x ICL prefills")

    # the answers: decoded strings, scored by the repo's VQA accuracy
    for tag, res, rows in (("icv", res_icv, val[1:]), ("icl", res_icl, val[1 : 1 + N_ICL_Q])):
        if len(res) != len(rows) or not all(isinstance(r["prediction"], str) for r in res.values()):
            raise AssertionError(f"test_{tag}: malformed results {res}")
        acc = vqa_accuracy(res, rows, tmp, tag)
        if not 0.0 <= acc <= 100.0:
            raise AssertionError(f"test_{tag}: accuracy {acc}")
        log(f"test_{tag} predictions {[r['prediction'] for r in res.values()]} "
            f"VQA accuracy {acc:.2f} (random weights)")

    # full-width prefill: flash kernel path vs plain attention path, same input
    ids = torch.from_numpy(enc["input_ids"]).to(dev)
    mask = torch.from_numpy(enc["attention_mask"]).to(dev)
    px = torch.from_numpy(enc["pixel_values"]).to(dev)
    pv = torch.from_numpy(enc["pixel_valid"]).to(dev)
    pos = torch.clamp(torch.cumsum(mask, -1) - 1, min=0)
    logits = {}
    for impl in ("flash", "xla"):
        mc = dataclasses.replace(
            bundle.model_cfg, text=dataclasses.replace(t, attention_impl=impl)
        )
        bind = _wrap_pixel_normalize(
            I.make_idefics_forward_fns(mc, bundle.eos_token_id), CLIP_MEAN, CLIP_STD
        )
        with torch.inference_mode():
            fwd = bind(bundle.params, px, pv, ids, None, s_icl + 1)
            logits[impl] = fwd(ids, mask, pos, None)[0][:, -1].float()
    a, b = logits["flash"], logits["xla"]
    diff = (a - b).abs().max().item()
    rel = ((a - b).norm() / b.norm()).item()
    log(f"full-width ICL prefill logits (32 bf16 layers), flash kernel vs plain "
        f"attention: max_abs={diff:.4e}, rel_l2={rel:.4e} (max |logit| "
        f"{b.abs().max().item():.4e}), argmax "
        f"{'agrees' if a.argmax().item() == b.argmax().item() else 'differs'}")
    if not (torch.isfinite(a).all() and rel <= REL_L2_TOL):
        raise AssertionError("flash path logits disagree with the plain path")
    return {
        "icv_inject": counts["icv_inject", "test_icv"] + counts["icv_inject", "test_icl"],
        "flash_attention_fwd": counts["flash", "test_icv"] + counts["flash", "test_icl"],
    }


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    # the port's modules: importing them fails outside a checkout
    from licv_vqa_tpu_torch import csrc

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    log(f"card: {gpu_name_and_power()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    lib, secs, nvcc_log = csrc.build("flash_attn_fwd.cu")
    if nvcc_log:
        log(f"built {lib.relative_to(REPO)} with nvcc in {secs:.1f} s")
    else:
        log(f"found {lib.relative_to(REPO)} (built earlier from the same source)")
    for line in nvcc_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  nvcc: {line.strip()}")

    summary = check_kernels(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        counts = main_path(dev, Path(tmp))

    kernels = [
        {
            "name": "icv_inject",
            "route": "triton",
            "source": "licv_vqa_tpu_torch/ops/icv_inject.py",
            "replaces": "licv_vqa_tpu/ops/icv_inject.py:56",
            "launches": counts["icv_inject"],
            "max_abs_err": summary["icv_inject"]["max_abs_err"],
            "ms": summary["icv_inject"]["ms"],
            "plain_ms": summary["icv_inject"]["plain_ms"],
        },
        {
            "name": "flash_attention_fwd",
            "route": "cuda",
            "source": "licv_vqa_tpu_torch/csrc/flash_attn_fwd.cu",
            "replaces": "licv_vqa_tpu/models/layers.py:148",
            "launches": counts["flash_attention_fwd"],
            "max_abs_err": summary["flash_attention_fwd"]["max_abs_err"],
            "ms": summary["flash_attention_fwd"]["ms"],
            "plain_ms": summary["flash_attention_fwd"]["plain_ms"],
        },
    ]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} was never launched on the main path")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
