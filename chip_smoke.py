#!/usr/bin/env python
"""Chip smoke test of the PyTorch/CUDA port (``licv_vqa_tpu_torch``) on one
NVIDIA GPU.  Run from the repository root: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero before the result lines):

1. require ``torch.cuda.is_available()``; print the card's name and power
   limit as ``nvidia-smi`` reports them;
2. build the CUDA library from ``licv_vqa_tpu_torch/csrc`` (nvcc, sm_90a)
   and print the build time (the Triton kernels compile at first launch);
3. hold each kernel against its plain PyTorch version on the same inputs
   at the main paths' shapes, printing the error (max-abs over the plain
   output's max-abs, limit ``REL_TOL`` for bf16 outputs and ``F32_REL_TOL``
   for the f32 KL outputs), the device time per call of the
   kernel, its plain version and, where one PyTorch call computes the same
   function, that call (the sum of the device-kernel intervals
   ``torch.profiler`` records over many calls, divided by the calls), the
   host-clocked time per call (CUDA events, launch costs included) and the
   bound: the larger of the bytes the function must move over 3.35 TB/s
   and its operations over the peak rate for their type (989 TFLOP/s bf16
   tensor cores, 67 TFLOP/s f32).  Cases: the ICV injection forward at
   (1, 512, 4096), (1, 64, 4096) and (3, 1, 4096) and its backward (the
   kernel and the reduction of its per-row shift gradient, as autograd runs
   them) at (2, 64, 4096) and (1, 512, 4096) bf16, each for every shift
   layout; the
   flash-attention forward at (1, S, 32, 128) for S = 384, 512 and 2048
   with left padding; the masked temperature-KL forward and backward at
   (128, 32000) and (512, 32000) f32 with a partial mask;
4. the eval path at Idefics-9B FULL width (32 layers, d=4096, ViT-H, 6-layer
   perceiver, 8 cross-attention blocks; random bf16 weights made on the card
   from a seed, ~18 GB), through the runner entry points the CLI calls
   (``icv_inference`` / ``icl_inference``) with the CLI's composed config and
   in-memory 224x224 uint8 images: ``test_icv`` with a random (32, 4096) ICV
   read back from an ``icv_cpk.pth``, beam-3, ``max_new_tokens=5``; then
   ``test_icl`` with 32 shots, whose prompt is >= 256 tokens.  The kernel
   launch counts are zeroed before and read after each; the ICV count must
   equal 32 x forward passes and the flash count 32 x questions.  Prints
   per-question latency, peak memory, and checks the answers: decoded
   strings scored by the port CLI's VQA accuracy, and the full-width ICL
   prefill logits with the flash kernel against the plain attention path;
5. the training path at Idefics-9B full width, through the port's train
   CLI (``licv_vqa_tpu_torch.cli.train.main``) on a synthetic VQAv2 split
   written to a temporary directory: ``trainer=debug`` (4 micro-steps, 2
   optimizer steps), bs=2, 32-shot teacher prompts (>= 256 tokens, so the
   teacher runs the flash kernel), ``kl_impl=pallas``.  Every kernel count
   must equal what the structure predicts per micro-step: KL forward 1, KL
   backward 1, ICV backward 32, flash forward 32 (the teacher), ICV forward
   3·32 − 8 = 88 (the student's forward, the per-group recompute up to each
   group's last layer, the per-layer recompute; ``remat_mode=both``).  The
   losses must be finite and the artifact must carry the reference keys and
   load through the port.  Prints ms per micro-step and peak memory.  Then,
   on one batch with the same weights and ICV: the (icv, alpha) gradients
   of the kernel path (flash, ICV and KL kernels) against the plain path
   (plain attention, plain injection, ``kl_impl=xla``), rel. L2 within
   ``REL_L2_TOL``; and where the time of the kernel path's loss and
   backward goes (its wall, the teacher forward alone, and over one
   profiled pass the device busy share and the device time by kernel);
6. one ``{"kernels": [...]}`` line;
7. the last line: ``{"ok": true, "device": {...}}``.

The port CLIs themselves are held against ``inference.py`` and ``train.py``
by the CPU tests (``tests/test_torch_cli.py``, ``tests/test_torch_train*.py``).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
# kernel vs plain: max-abs error <= REL_TOL * max|plain|, per output.  For
# bf16 outputs one ulp is at most 2^-7 of a value, so this allows about 2.5
# ulps at the largest output; a kernel with a wrong mask, a wrong shift row
# or a wrong gradient term reads far above it (PERF.md, Findings).
REL_TOL = 2e-2
# the f32 KL outputs differ from their plain versions by summation order
# only (about 1e-6); a kernel that rounded through bf16 reads above this
F32_REL_TOL = 1e-4
# whole-model checks, rel. L2: 32 bf16 layers amplify any reordering of the
# rounding (the plain attention rounds probabilities to bf16 before P·V), so
# the sound kernel path reads several 1e-2 here.  A sanity bound on the
# whole path; phase 3 is the kernels' correctness check (PERF.md, Findings)
REL_L2_TOL = 0.1
N_ICV_Q = 4
N_ICL_Q = 2
ICL_SHOTS = 32
MAX_NEW = 5
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}
TRAIN_BS = 2
TRAIN_MICRO = 4  # trainer=debug: limit_train_batches 4, accumulate 2
KL_EPS = 1e-6


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
    ``calls``.  Host launch gaps between kernels are not counted.  A
    profiling session now and then records no device activity at all; it
    is repeated, up to three sessions."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(
            e.time_range.end - e.time_range.start
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
        )
        if us > 0:
            break
        log(f"  torch.profiler recorded no device time (session {attempt + 1} of 3)")
    else:
        raise RuntimeError("torch.profiler recorded no device time")
    return us / calls / 1e3


@dataclasses.dataclass
class Case:
    """One kernel-vs-plain case: the calls, and the work the bound counts."""

    name: str
    label: str
    kernel: object
    plain: object
    bytes_moved: float  # each input read once, each output written once
    ops: float
    op_type: str  # key of PEAK_OPS
    library: object = None  # one PyTorch call computing the same function
    calls: int = 20
    tol: float = REL_TOL  # error ratio limit against the plain version

    def bound(self) -> tuple[float, str]:
        t_bytes = self.bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = self.ops / PEAK_OPS[self.op_type] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_cases(dev):
    """The kernel-vs-plain cases at the main paths' shapes, from a seed."""
    import torch
    import torch.nn.functional as F

    from licv_vqa_tpu_torch.models import layers as L
    from licv_vqa_tpu_torch.ops import masked_kl_kernel as K
    from licv_vqa_tpu_torch.ops.icv_inject import (
        icv_inject,
        icv_inject_backward,
        icv_inject_backward_reference,
        icv_inject_reference,
    )

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def layouts(b, s, d):
        return (("row", (d,)), ("batch", (b, d)), ("batch1", (b, 1, d)), ("per_pos", (b, s, d)))

    for (b, s, d) in ((1, 512, 4096), (1, 64, 4096), (3, 1, 4096)):
        h = randn((b, s, d))
        for layout, vshape in layouts(b, s, d):
            v = randn(vshape, 0.5)
            n = b * s * d
            yield Case(
                "icv_inject", f"({b},{s},{d}) shift={layout}",
                lambda h=h, v=v: icv_inject(h, v),
                lambda h=h, v=v: icv_inject_reference(h, v),
                bytes_moved=2 * n * 2 + v.numel() * 2, ops=8 * n, op_type="f32", calls=50,
            )
    for (b, s, d) in ((2, 64, 4096), (1, 512, 4096)):
        h, gout = randn((b, s, d)), randn((b, s, d))
        for layout, vshape in layouts(b, s, d):
            v = randn(vshape, 0.5)
            n = b * s * d
            yield Case(
                "icv_inject_bwd", f"({b},{s},{d}) shift={layout}",
                lambda h=h, v=v, gout=gout: icv_inject_backward(h, v, gout),
                lambda h=h, v=v, gout=gout: icv_inject_backward_reference(h, v, gout),
                # h and g read, dh written, the shift read and its gradient
                # written (all bf16); the kernel's per-row f32 ds is not the
                # function's and is not counted
                bytes_moved=n * (2 + 2 + 2) + 2 * v.numel() * 2, ops=16 * n,
                op_type="f32", calls=50,
            )
    for s, pad in ((384, 57), (512, 39), (2048, 301)):
        q, k, v = (randn((1, s, 32, 128)) for _ in range(3))
        valid = torch.ones((1, s), dtype=torch.int32, device=dev)
        valid[:, :pad] = 0  # left padding, as the decode prompts are
        mask = L.segment_causal_mask(valid)
        # the causal half: QK^T and PV over the s(s+1)/2 visible pairs
        flops = 4 * 32 * 128 * s * (s + 1) / 2
        yield Case(
            "flash_attention_fwd", f"(1,{s},32,128) left pad {pad}",
            lambda q=q, k=k, v=v, valid=valid: L.flash_attention(q, k, v, valid),
            lambda q=q, k=k, v=v, valid=valid: L.flash_attention_reference(q, k, v, valid),
            bytes_moved=4 * q.numel() * 2 + valid.numel() * 4, ops=flops, op_type="bf16",
            library=lambda q=q, k=k, v=v, mask=mask: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask
            ),
            calls=5,
        )
    for n in (128, 512):
        v_sz = 32000
        stu, tea = randn((n, v_sz), 3.0, torch.float32), randn((n, v_sz), 3.0, torch.float32)
        w = (torch.rand((n,), generator=g, device=dev) < 0.7).float()
        gw = w / w.sum()  # the masked mean's per-row cotangent
        _, lse_s, lse_t = K.rowwise_kl_reference(stu, tea, KL_EPS)
        elems = n * v_sz
        yield Case(
            "masked_kl_fwd", f"({n},{v_sz}) f32",
            lambda stu=stu, tea=tea: K.rowwise_kl_forward(stu, tea, KL_EPS),
            lambda stu=stu, tea=tea: K.rowwise_kl_reference(stu, tea, KL_EPS),
            bytes_moved=2 * elems * 4 + 3 * n * 4, ops=17 * elems, op_type="f32",
            tol=F32_REL_TOL,
        )
        yield Case(
            "masked_kl_bwd", f"({n},{v_sz}) f32",
            lambda stu=stu, tea=tea, a=lse_s, b=lse_t, gw=gw: K.rowwise_kl_backward(
                stu, tea, a, b, gw, KL_EPS),
            lambda stu=stu, tea=tea, a=lse_s, b=lse_t, gw=gw: K.rowwise_kl_backward_reference(
                stu, tea, a, b, gw, KL_EPS),
            bytes_moved=4 * elems * 4 + 3 * n * 4, ops=30 * elems, op_type="f32",
            tol=F32_REL_TOL,
        )


def compare(kernel, plain) -> tuple[float, float]:
    """``(max-abs error, worst error ratio)`` of one kernel call against its
    plain version on the same inputs, over every output; the ratio is each
    output's max-abs error over that output's max|plain|.  A non-finite
    kernel output raises."""
    import torch

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err, ratio = 0.0, 0.0
    for a, b in zip(got, want, strict=True):
        if not torch.isfinite(a).all():
            raise AssertionError("non-finite kernel output")
        e = (a.float() - b.float()).abs().max().item()
        err = max(err, e)
        ratio = max(ratio, e / max(b.float().abs().max().item(), 1e-30))
    return err, ratio


# the main paths' most frequent call of each kernel: the ICV injection at a
# beam step (32 per step), the flash forward at the 32-shot prefill (512),
# the ICV backward and the KL at the training student (bs=2, 64 tokens)
MAIN_SHAPE = {
    "icv_inject": "(3,1,4096) shift=row",
    "flash_attention_fwd": "(1,512,32,128)",
    "icv_inject_bwd": "(2,64,4096) shift=row",
    "masked_kl_fwd": "(128,32000)",
    "masked_kl_bwd": "(128,32000)",
}


def check_kernels(dev) -> dict:
    """Phase 3.  Returns per-kernel summaries for the kernels line."""
    out = {}
    for c in kernel_cases(dev):
        err, ratio = compare(c.kernel, c.plain)
        dev_ms, dev_plain = device_ms(c.kernel, c.calls), device_ms(c.plain, c.calls)
        lib_ms = device_ms(c.library, c.calls) if c.library is not None else None
        ev_ms, ev_plain = time_ms(c.kernel, inner=c.calls), time_ms(c.plain, inner=c.calls)
        bound_ms, bound_by = c.bound()
        lib = f"{lib_ms:.5f} ms" if lib_ms is not None else "none"
        log(f"{c.name} {c.label}: max_abs={err:.3e} (ratio to max|plain| {ratio:.3e}); "
            f"device {dev_ms:.5f} ms, plain {dev_plain:.5f} ms, library {lib}, "
            f"bound {bound_ms:.5f} ms ({bound_by}); host-clocked {ev_ms:.4f} ms vs plain "
            f"{ev_plain:.4f} ms")
        if not ratio <= c.tol:
            raise AssertionError(f"{c.name} {c.label} disagrees: ratio {ratio} > {c.tol}")
        row = out.setdefault(c.name, dict(max_abs_err=0.0))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if c.label.startswith(MAIN_SHAPE[c.name]):
            row.update(ms=dev_ms, plain_ms=dev_plain, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
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


def write_vqa_split(root: Path, img_root: Path, split: str, n: int, seed: int) -> None:
    """A VQAv2 split on disk (question, annotation and JPEG files), as
    ``tests/test_cli_e2e.py`` writes one."""
    from PIL import Image

    img_root.mkdir(parents=True, exist_ok=True)
    root.mkdir(parents=True, exist_ok=True)
    rows = synthetic_vqa(n, 100, seed)
    for r in rows:
        Image.fromarray(r["image"]).save(img_root / f"COCO_{split}_{r['image_id']:012d}.jpg")
    questions = [{k: r[k] for k in ("question_id", "image_id", "question")} for r in rows]
    anns = [
        {k: r[k] for k in ("question_id", "image_id", "question_type", "answer_type", "answers")}
        | {"multiple_choice_answer": r["answer"]}
        for r in rows
    ]
    (root / f"v2_OpenEnded_mscoco_{split}_questions.json").write_text(
        json.dumps({"questions": questions}))
    (root / f"v2_mscoco_{split}_annotations.json").write_text(json.dumps({"annotations": anns}))
    if split == "val2014":
        (root / "v2_mscoco_val2014_annotations_subdata.json").write_text(
            json.dumps({"annotations": anns}))


def vqa_accuracy(results: dict, rows: list, tmp: Path, tag: str) -> float:
    """The port CLI's VQA scoring over question and annotation files made
    from ``rows``."""
    from licv_vqa_tpu_torch.cli.inference import evaluate_vqa
    from licv_vqa_tpu_torch.metrics import vqa_postprocess

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


def set_env(tmp: Path) -> None:
    tmp.mkdir(parents=True, exist_ok=True)
    for key in ("RESULT_DIR", "MODEL_CPK_DIR", "VQAV2_PATH", "COCO_PATH", "OKVQA_PATH"):
        os.environ[key] = str(tmp / key.lower())


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main_path(dev, tmp: Path) -> dict:
    """Phase 4.  Returns the launch counts of the eval path."""
    import torch

    from licv_vqa_tpu_torch.api import init_prompt_manager
    from licv_vqa_tpu_torch.data.processor import CLIP_MEAN, CLIP_STD
    from licv_vqa_tpu_torch.infer.runner import icl_inference, icv_inference
    from licv_vqa_tpu_torch.models import idefics as I
    from licv_vqa_tpu_torch.models import layers as L
    from licv_vqa_tpu_torch.models.registry import _wrap_pixel_normalize, build_model
    from licv_vqa_tpu_torch.ops.icv_inject import icv_inject
    from licv_vqa_tpu_torch.train.checkpoint import load_icv_checkpoint
    from licv_vqa_tpu_torch.utils import compose

    set_env(tmp)
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
    n_params = sum(x.numel() for x in _leaves(bundle.params))
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
        _, bind = _wrap_pixel_normalize(
            *I.make_idefics_forward_fns(mc, bundle.eos_token_id), CLIP_MEAN, CLIP_STD
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


def _counters():
    from licv_vqa_tpu_torch.models import layers as L
    from licv_vqa_tpu_torch.ops import masked_kl_kernel as K
    from licv_vqa_tpu_torch.ops.icv_inject import icv_inject, icv_inject_backward

    return {
        "icv_inject": icv_inject,
        "icv_inject_bwd": icv_inject_backward,
        "flash_attention_fwd": L.flash_attention,
        "masked_kl_fwd": K.rowwise_kl_forward,
        "masked_kl_bwd": K.rowwise_kl_backward,
    }


def free_device_memory() -> None:
    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


TRAIN_ARGS = [
    "lmm=idefics-9B", "trainer=debug", f"data_cfg.bs={TRAIN_BS}",
    f"data_cfg.task.datasets.few_shot_num={ICL_SHOTS}", "icv_module.kl_impl=pallas",
    "icv_module.icv_encoder.alpha_init_value=0.5", "data_cfg.task.datasets.max_train_size=-1",
    "trainer.log_every_n_steps=1", "run_name=chip_smoke", "device=cuda",
]


def write_training_split(tmp: Path) -> None:
    """The synthetic VQAv2 train and val splits under ``tmp``, with the
    config's paths pointed there."""
    set_env(tmp)
    vqa, coco = tmp / "vqav2_path", tmp / "coco_path" / "mscoco2014"
    write_vqa_split(vqa, coco / "train2014", "train2014", 2 * TRAIN_BS * TRAIN_MICRO, seed=3)
    write_vqa_split(vqa, coco / "val2014", "val2014", 4, seed=4)


def training_path(dev, tmp: Path) -> dict:
    """Phase 5, the train CLI.  Returns the launch counts of the run."""
    import torch

    from licv_vqa_tpu_torch.cli.train import main as train_main
    from licv_vqa_tpu_torch.train.checkpoint import load_icv_checkpoint

    write_training_split(tmp)
    batch = _collated_batch(TRAIN_ARGS)
    s_tea = batch["inputs"]["input_ids"].shape[1]
    s_stu = batch["query_inputs"]["input_ids"].shape[1]
    log(f"training batch: student {s_stu} tokens, teacher {s_tea} tokens "
        f"({int(batch['inputs']['attention_mask'].sum(1).min())}+ real), "
        f"{batch['inputs']['pixel_values'].shape[1]} teacher images per row")
    if s_tea < 256:
        raise AssertionError(f"teacher prompt {s_tea} < 256: the flash gate is not reached")

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    run_dir = train_main(TRAIN_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30

    rows = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in rows]
    step_s = rows[-1].get("step_time_mean_s")
    log(f"train CLI: {len(rows)} micro-steps in {wall:.1f} s (model build and data included); "
        f"{step_s * 1e3:.1f} ms per micro-step (mean of steps 2-{len(rows)}, trainer's "
        f"StepTimer); peak device memory {peak:.2f} GiB; losses {losses}; "
        f"grad norms {[r['grad_norm'] for r in rows]}")
    if len(rows) != TRAIN_MICRO or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training: {len(rows)} steps, losses {losses}")
    want = {
        "masked_kl_fwd": 1, "masked_kl_bwd": 1, "icv_inject_bwd": 32,
        "flash_attention_fwd": 32, "icv_inject": 3 * 32 - 8,
    }
    for k, per_step in want.items():
        log(f"  {k} launches {counts[k]} (want {per_step} x {TRAIN_MICRO} micro-steps)")
        if counts[k] != per_step * TRAIN_MICRO:
            raise AssertionError(f"{k}: {counts[k]} launches != {per_step} x {TRAIN_MICRO}")

    state = torch.load(run_dir / "icv_cpk.pth", weights_only=False)
    keys = {"icv_encoder.icv", "icv_encoder.alpha", "use_sigmoid", "lmm_args"}
    if not keys <= set(state) or state["icv_encoder.icv"].shape != (1, 32, 4096):
        raise AssertionError(f"icv_cpk.pth: keys {sorted(state)}")
    loaded = load_icv_checkpoint(run_dir, device=dev)
    if not (torch.isfinite(loaded["icv"]).all() and loaded["alpha"].shape == (32,)):
        raise AssertionError("icv_cpk.pth does not load back")
    log(f"icv_cpk.pth keys {sorted(state)}, lmm_args.total_layers "
        f"{state['lmm_args'].get('total_layers')}, loaded back through the port")
    return counts


def _collated_batch(args, proc=None):
    """One training batch as the train CLI collates it (host numpy), with
    ``proc`` or the processor the registry builds when no tokenizer is on
    disk."""
    from licv_vqa_tpu_torch.api import init_prompt_manager, init_train_dataset
    from licv_vqa_tpu_torch.data.collator import collate_icv_batch
    from licv_vqa_tpu_torch.data.processor import CLIP_MEAN, CLIP_STD, ImageTransform, PromptProcessor
    from licv_vqa_tpu_torch.data.tokenizer import WhitespaceTokenizer
    from licv_vqa_tpu_torch.utils import compose

    cfg = compose(str(REPO / "config"), "train", args)
    ds = init_train_dataset(cfg, init_prompt_manager(cfg), seed=int(cfg.seed))
    if proc is None:
        proc = PromptProcessor(
            WhitespaceTokenizer(), ImageTransform(224, CLIP_MEAN, CLIP_STD),
            family="idefics", max_length=2048,
        )
    proc.padding_side = "right"
    return collate_icv_batch([ds[i] for i in range(TRAIN_BS)], proc)


@dataclasses.dataclass
class TrainInputs:
    """What the gradient check and the profile share: the full-width model,
    the plain path's forward, one collated batch and a seeded encoder."""

    bundle: object
    plain_forward: object
    batch: dict
    encoder: object
    temperature: object


def training_inputs(dev) -> TrainInputs:
    """Built on the split ``write_training_split`` wrote."""
    import torch

    from licv_vqa_tpu_torch.data.processor import CLIP_MEAN, CLIP_STD
    from licv_vqa_tpu_torch.icv.encoder import GlobalICVEncoder
    from licv_vqa_tpu_torch.models import idefics as I
    from licv_vqa_tpu_torch.models.registry import _wrap_pixel_normalize, build_model
    from licv_vqa_tpu_torch.train.trainer import batch_to_device
    from licv_vqa_tpu_torch.utils import compose

    bundle = build_model(compose(str(REPO / "config"), "train", TRAIN_ARGS), device=dev)
    mc = bundle.model_cfg
    xla = dataclasses.replace(mc, text=dataclasses.replace(mc.text, attention_impl="xla"))
    plain_forward, _ = _wrap_pixel_normalize(
        *I.make_idefics_forward_fns(xla, bundle.eos_token_id), CLIP_MEAN, CLIP_STD
    )
    encoder = GlobalICVEncoder(
        bundle.hidden_size, bundle.n_layers, alpha_init_value=0.5, use_sigmoid=True,
        generator=torch.Generator().manual_seed(0), device=dev,
    )
    return TrainInputs(
        bundle, plain_forward, batch_to_device(_collated_batch(TRAIN_ARGS, bundle.processor), dev),
        encoder, torch.tensor(1.0, device=dev),
    )


def loss_and_grads(m: TrainInputs, path: str):
    """``(loss, (d_icv, d_alpha))`` of one batch on the kernel path (flash,
    ICV and KL kernels) or the plain path (plain attention, the plain
    injection differentiated by autograd, ``kl_impl=xla``)."""
    import torch

    from licv_vqa_tpu_torch.icv.module import ICVModuleConfig, icv_loss_fn
    from licv_vqa_tpu_torch.models import decoder as Dm
    from licv_vqa_tpu_torch.ops.icv_inject import icv_inject, icv_inject_reference

    kernel = path == "kernel"
    b = m.bundle
    Dm.icv_inject = icv_inject if kernel else icv_inject_reference
    try:
        loss, _ = icv_loss_fn(
            m.encoder, m.temperature, b.params, m.batch,
            b.train_forward if kernel else m.plain_forward,
            ICVModuleConfig(kl_impl="pallas" if kernel else "xla"), b.pad_token_id, b.head_fn,
        )
        grads = torch.autograd.grad(loss, (m.encoder.icv, m.encoder.alpha))
    finally:
        Dm.icv_inject = icv_inject
    return loss.detach(), grads


def gradient_check(m: TrainInputs) -> dict:
    """Phase 5, second part: the (icv, alpha) gradients of the kernel path
    against the plain path at full width, on one batch with the same
    weights and ICV."""
    (lk, gk), (lp, gp) = loss_and_grads(m, "kernel"), loss_and_grads(m, "plain")
    rel = [((a - b).norm() / b.norm()).item() for a, b in zip(gk, gp, strict=True)]
    out = {"loss_kernel": lk.item(), "loss_plain": lp.item(),
           "rel_l2_icv": rel[0], "rel_l2_alpha": rel[1]}
    log(f"full-width gradients, kernel path vs plain path (one batch, same weights and ICV): "
        f"loss {out['loss_kernel']:.6e} vs {out['loss_plain']:.6e}; rel_l2 d_icv "
        f"{rel[0]:.4e}, d_alpha {rel[1]:.4e} (limit {REL_L2_TOL})")
    return out


def busy_ms(events) -> float:
    """Length of the union of the device intervals (µs in, ms out)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in events):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def profile_training(m: TrainInputs) -> None:
    """Phase 5, last part: where the time of the kernel path's loss and
    backward (a micro-step without the optimizer update) goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def step():
        loss_and_grads(m, "kernel")

    def teacher():
        with torch.no_grad():
            m.bundle.train_forward(m.bundle.params, m.batch["inputs"], None, return_hidden=True)

    walls = [wall_ms(step) for _ in range(2)]
    t_teacher = wall_ms(teacher)
    for _ in range(3):  # a session now and then records no device activity
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = wall_ms(step)
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    else:
        raise RuntimeError("torch.profiler recorded no device time")
    busy = busy_ms(events)
    total = sum(e.time_range.end - e.time_range.start for e in events) / 1e3
    log(f"kernel-path loss+backward: {walls[0]:.1f}, {walls[1]:.1f} ms unprofiled; teacher "
        f"forward alone {t_teacher:.1f} ms; profiled {wall:.1f} ms wall, {len(events)} device "
        f"kernels, device busy {busy:.1f} ms ({100 * busy / wall:.1f}% of the wall)")
    by_name: dict = {}
    for e in events:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    log("  device time by kernel (top 12; ms, share of the summed device time, launches):")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"  {ms:9.3f}  {100 * ms / total:5.1f}%  {n:6d}  {name[:100]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    # the port's modules: importing them fails outside a checkout
    from licv_vqa_tpu_torch import csrc

    os.chdir(REPO)  # the CLIs compose ``config/`` from the working directory
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
        counts = main_path(dev, Path(tmp) / "eval")
        free_device_memory()  # phase 4's model goes before phase 5 builds its own
        counts_train = training_path(dev, Path(tmp) / "train")
        free_device_memory()
        m = training_inputs(dev)
        grad = gradient_check(m)
        if not (math.isfinite(grad["loss_kernel"])
                and max(grad["rel_l2_icv"], grad["rel_l2_alpha"]) <= REL_L2_TOL):
            raise AssertionError("kernel-path gradients disagree with the plain path")
        profile_training(m)

    sources = {
        "icv_inject": ("triton", "licv_vqa_tpu_torch/ops/icv_inject.py",
                       "licv_vqa_tpu/ops/icv_inject.py:56"),
        "flash_attention_fwd": ("cuda", "licv_vqa_tpu_torch/csrc/flash_attn_fwd.cu",
                                "licv_vqa_tpu/models/layers.py:148"),
        "masked_kl": ("triton", "licv_vqa_tpu_torch/ops/masked_kl_kernel.py",
                      "licv_vqa_tpu/ops/masked_kl_kernel.py:128"),
        "icv_inject_bwd": ("triton", "licv_vqa_tpu_torch/ops/icv_inject.py",
                           "licv_vqa_tpu/ops/icv_inject.py:113"),
    }
    launches = {
        "icv_inject": counts["icv_inject"] + counts_train["icv_inject"],
        "flash_attention_fwd": counts["flash_attention_fwd"] + counts_train["flash_attention_fwd"],
        "icv_inject_bwd": counts_train["icv_inject_bwd"],
    }
    kernels = []
    for name, (route, source, replaces) in sources.items():
        if name == "masked_kl":
            # one kernel pair behind one autograd Function: the row sums fwd + bwd
            f, b = summary["masked_kl_fwd"], summary["masked_kl_bwd"]
            row = {
                "launches": counts_train["masked_kl_fwd"] + counts_train["masked_kl_bwd"],
                "max_abs_err": max(f["max_abs_err"], b["max_abs_err"]),
                "ms": f["ms"] + b["ms"], "plain_ms": f["plain_ms"] + b["plain_ms"],
                "bound_ms": f["bound_ms"] + b["bound_ms"], "bound_by": "bytes",
                "library_ms": None,
                "fwd": {"launches": counts_train["masked_kl_fwd"], "ms": f["ms"],
                        "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"]},
                "bwd": {"launches": counts_train["masked_kl_bwd"], "ms": b["ms"],
                        "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"]},
            }
        else:
            s = summary[name]
            row = {"launches": launches[name], "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                   "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                   "bound_by": s["bound_by"], "library_ms": s["library_ms"]}
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        **row})
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
