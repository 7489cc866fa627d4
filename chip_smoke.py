#!/usr/bin/env python
"""Chip smoke test of the PyTorch/CUDA port (``licv_vqa_tpu_torch``) on one
NVIDIA GPU.  Run from the repository root: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero before the result lines):

1. require ``torch.cuda.is_available()``; print the card's name and power
   limit as ``nvidia-smi`` reports them;
2. build the CUDA libraries from ``licv_vqa_tpu_torch/csrc`` (one nvcc per
   source, sm_90a, all started together) and print the build times (the
   Triton kernels compile at first launch);
3. hold each kernel against its plain PyTorch version on the same inputs
   at the main paths' shapes, printing the error (max-abs over the plain
   output's max-abs, limit ``REL_TOL`` for bf16 outputs and ``F32_REL_TOL``
   for the f32 outputs: the KL's and the quantized matmuls'), the device
   time per call of the
   kernel, its plain version and, where one PyTorch call computes the same
   function, that call (the sum of the device-kernel intervals
   ``torch.profiler`` records over many calls, divided by the calls), the
   host-clocked time per call (CUDA events, launch costs included) and the
   bound: the larger of the bytes the function must move over 3.35 TB/s
   and its operations over the peak rate for their type (989 TFLOP/s bf16
   tensor cores, 67 TFLOP/s f32).  Cases: the ICV injection forward at
   (1, 512, 4096), (1, 64, 4096) and (3, 1, 4096), alone and with the
   residual add folded in (``icv_inject_after_add``, the block output's
   site; ``add_icv_inject``, the MLP output's), the add and ``icv_inject``
   timed beside the fused entries as their two-launch yardstick and the
   sum the first writes under autograd held bit-equal to ``h + delta``,
   and its backward (one launch: dh and the shift's gradient reduced to
   the shift's shape) at (2, 64, 4096), (1, 512, 4096) and (4, 256, 4096)
   bf16, each for every shift layout ((1, S, D) shared by the batch
   included) and the backward called twice for equal bits; the
   flash-attention forward at ``FLASH_FWD_SHAPES`` ((1, S, 32, 128) for S =
   384, 512, 2048 and 2560 with left padding, every row compared, the
   library call ``F.scaled_dot_product_attention`` under the segment mask;
   the flagship teacher's (4, 2048, 32, 128) all valid, where the library
   call is its own causal path); its backward (``csrc/flash_attn_bwd.cu``:
   dq, dk and dv each) at ``FLASH_BWD_SHAPES`` (the flagship student's (4, 256, 32,
   128) with ragged rows and with every row valid, (4, 512, 8, 128) and
   (1, 2048, 32, 128), right-padded) on the forward kernel's output and
   log-sum-exp (the log-sum-exp held against the plain one to
   ``F32_REL_TOL``), with the backward of ``F.scaled_dot_product_attention``
   under the segment mask as the library call, and under ``is_causal=True``
   (PyTorch's own flash backward) where every row is valid
   (``torch.autograd.grad`` alone timed); the masked temperature-KL forward and
   backward (``csrc/masked_kl.cu``) at (128, 32000) and (512, 32000) f32
   with a 70% mask and with every row weighted, and at (128, 32002), the
   Idefics-9B head's width, under the answer mask of phase 5's collated
   batch (``training_kl_mask``), the forward compared on the weighted rows
   and through the masked mean, the backward on every element, both
   called twice for equal bits, the bound counting the weighted rows' reads
   and every row's writes; the int8 and
   int4 decode matmuls at ``QUANT_SHAPES`` (a beam step's projections, a
   64-row block), the int8 one at ``HEAD_SHAPES`` (the head at a beam step
   and at prefill) and the int4 one at ``INT4_PREFILL_SHAPES`` (run B's
   64-row prefill MLP and bind-time K/V) and with its weights cold
   (``INT4_COLD_SHAPE``, each call on the next of ``INT4_COLD_COPIES``
   weight copies, past the L2; the library call likewise, every copy's
   layout built before the timed calls), the int8 one likewise cold at
   ``INT8_COLD`` (with the dense bf16 matmul cold beside it), every int8
   and int4 case also called twice for equal bits (their split-K sums in
   a fixed order), with
   ``torch._weight_int8pack_mm`` as the int8 library call where this torch
   runs it on the card, and the bf16 matmul with the dense weight printed
   beside as a note; the bidirectional flash attention at ``BIDIR_SHAPES``
   (the SigLIP tower, H=16, Dh=72: one 980x980 image, one 640x480 image
   padded to 672x560, a 32-shot prompt's 33 images, and two images of a
   20x55 grid, whose S = 1100 leaves a ragged tail), every row compared,
   with ``F.scaled_dot_product_attention`` under the segment mask as the
   library call; the ALiBi flash attention at ``ALIBI_SHAPES`` (MPT-7B's
   H=32, Dh=128 at S = 512 and 2048, left- and right-padded), compared on
   the rows with a visible key, with ``F.scaled_dot_product_attention``
   under the bias and mask as one float mask as the library call; the
   fused ViT attention at ``VIT_SHAPES`` (ViT-L and ViT-H, H=16, Dh=64 and
   80, 1 and 33 images, a key mask, S = 1024), every row compared, its
   mean error ratio held to ``VIT_MEAN_TOL`` too (where P is rounded), with
   ``F.scaled_dot_product_attention`` under the key mask as the library
   call; the w8a8 kernel (``csrc/w8a8_matmul.cu``), both entry points
   (fused, pre-quantized) at ``W8A8_SHAPES`` (run A's 64-token prefill,
   its 32-shot ``test_icl`` prefill in the 512-token bucket, its bind-time
   K/V and perceiver calls at K = 1280, and the tuning tool's
   serving-prefill MLP), held to EQUAL its plain version (limit 0) and
   called twice for equal bits, with ``torch._int_mm`` on the
   pre-quantized plane (rows padded as ``_int_product`` pads them) as the
   library call, and the fused entry point with its weights cold at
   ``W8A8_COLD_SHAPES`` (each call on the next of a set of weight copies
   past the L2, the library call likewise); and the int4 unpack-schedule
   probe (``csrc/int4_unpack_probe.cu``), its four schedules at the tool's
   (8, 4096, 11008), G = 64, each to ``F32_REL_TOL``, warm and with its
   weights cold, with ``torch._weight_int4pack_mm`` (the layout converted
   once, for each copy before the timed calls) as the library call, which
   the int4 matmul's cases get too.  A device time is the sum of every
   kernel one call launches (the w8a8 row pass and matmul, schedule f's
   correction outside the probe kernel); a profiled session that recorded
   fewer kernels than the calls launch is not used;
4. the eval path at Idefics-9B FULL width (32 layers, d=4096, ViT-H, 6-layer
   perceiver, 8 cross-attention blocks; random bf16 weights made on the card
   from a seed, ~18 GB), through the runner entry points the CLI calls
   (``icv_inference`` / ``icl_inference``) with the CLI's composed config and
   in-memory 224x224 uint8 images: ``test_icv`` with a random (32, 4096) ICV
   read back from an ``icv_cpk.pth``, beam-3, ``max_new_tokens=5``; then
   ``test_icl`` with 32 shots, whose prompt is >= 256 tokens.  The kernel
   launch counts are zeroed before and read after each; the ICV count must
   equal 32 x forward passes, the flash count 32 x questions and the fused
   ViT kernel's 32 x binds (the ViT-H tower, s=257).  Prints
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
   group's last layer, the per-layer recompute; ``remat_mode=both``), fused
   ViT 2·32 (the teacher's bind and the student's), flash backward 0 (the
   64-token student is under the flash gate), int8 0.  The losses must be finite and the artifact must carry the reference keys and
   load through the port.  Prints ms per micro-step and peak memory.  Then,
   on one batch with the same weights and ICV: the (icv, alpha) gradients
   of the kernel path (flash, ICV and KL kernels) against the plain path
   (plain attention, plain injection, ``kl_impl=xla``), rel. L2 within
   ``REL_L2_TOL``; and where the time of the kernel path's loss and
   backward goes (its wall, the teacher forward alone, and over one
   profiled pass the device busy share and the device time by kernel);
6. the weight-quantized eval at full width, quantized on the card by the
   registry, through the runner entry points as in phase 4 (``QUANT_RUNS``):
   A, int8 weights with the int8 head, the int8 KV cache, w8a8 prefill and
   the int8 vision tower, ``test_icv`` then ``test_icl``; B, int4 weights
   (bf16 head), ``test_icv``.  The int8, w8a8 and int4 kernel counts are
   zeroed before and read after each path and must equal
   ``predicted_quantized_launches`` (derived from ``qdot``'s routes), the
   ICV count 32 x forwards, the fused ViT kernel's 32 x binds; no call of
   ``torch._int_mm`` is made (w8a8 goes through the kernel).  Prints ms per question, peak memory and a
   profile of one ``test_icv`` question (device busy share, device time by
   kernel), and holds the test_icv prompt's prefill and first-step logits
   through the kernels against the same weights through their plain
   versions (rel. L2 within ``REL_L2_TOL``, the same argmax);
7. the Idefics2-8B-base eval at full width (32 Mistral layers, d=4096, GQA
   8, d_ff 14336; 27 SigLIP layers at d=1152; a 3-layer perceiver; random
   bf16 weights made on the card, ~17 GB), built through the registry and
   driven through the runner entry points as in phase 4, with in-memory
   uint8 images of COCO's common sizes (``COCO_SIZES``) that the NaViT
   processor resizes and pads: ``test_icv`` (4 questions at 640x480, the
   ICV of an ``icv_cpk.pth`` whose ``layer_format`` names the MLP site),
   then ``test_icl`` (2 questions, 32 shots).  The counts of the
   bidirectional flash, the causal flash and the ICV kernels are zeroed
   before and read after each path and must equal
   ``predicted_idefics2_launches`` (the tower's kernel at its 27 layers in
   every bind; the causal one at the 32 layers of test_icl's prefills;
   the ICV at the 32 layers of every test_icv forward).  Prints ms per
   question, peak memory and one profiled question per path, then holds
   the test_icv prompt's and an 8-shot prompt's prefill logits through the
   kernels against the plain path (rel. L2 within ``REL_L2_TOL``) and both
   against the plain path in f32 (the kernel path no farther from it than
   ``F32_DRIFT_RATIO`` times the plain path; the same argmax, or a tie at
   bf16's resolution: ``kernel_vs_plain_f32_logits``);
8. the OpenFlamingo-9B eval at full width (32 MPT-7B layers, d=4096, ALiBi,
   d_ff 16384, the head tied to the 50432-row table; 24 ViT-L layers at
   d=1024; a 6-layer perceiver; 8 gated cross-attention blocks; random bf16
   weights made on the card, ~16 GB), built through the registry and driven
   through the runner entry points as in phase 4 on 224x224 images:
   ``test_icv`` (4 questions, the ICV of an ``icv_cpk.pth`` whose
   ``layer_format`` names the MPT block output), then ``test_icl`` (2
   questions, 32 shots, a prompt of >= 128 tokens).  The counts of the
   fused ViT, the ALiBi flash and the ICV kernels are zeroed before and
   read after each path and must equal ``predicted_openflamingo_launches``
   (the tower's 24 layers in every bind; the ALiBi kernel at the 32 layers
   of test_icl's prefills; the ICV at the 32 layers of every test_icv
   forward).  Prints ms per question, peak memory and one profiled question
   per path, then holds the test_icv prompt's and the 32-shot prompt's
   prefill logits through the kernels against the plain path and both
   against an f32 path, as phase 7 does;
9. the flagship ICV train step of ``tools/bench_train_step_torch.py``
   (Idefics-9B at full width with int8 frozen ``layers`` and ``xattn``, a
   2048-token teacher, a 256-token student, bs=4), in process, under
   ``remat_mode`` inner and both (``FLAGSHIP_MODES``): ms a step, tokens/s,
   MFU against 989 TFLOP/s bf16, peak memory, and the launch counts of
   every step (the flash forward for the teacher, the student and its
   recompute; the flash backward; the ICV forward and backward; the fused
   ViT; the int8 kernel) against ``predicted_flagship_launches``, and a
   profile of one step (device busy share, device time by kernel); then
   ``flagship_gradient_check``: the kernel path's (icv, alpha) gradients
   against the student's attention plain, within ``REL_L2_TOL``, on one
   batch whose student rows are right-padded to different lengths, on the
   model's first ``FLAGSHIP_GRAD_LAYERS`` layers (the whole-path and f32
   comparisons printed beside it, and all four at full depth);
10. the two probe tools in process at their shapes
   (``tools/exp_w8a8_tuning_torch.py``: every variant at (4096, 4096,
   11008) and (4096, 11008, 4096), each tile; ``tools/exp_int4_unpack_torch.py``:
   the four schedules at (8, 4096, 11008)), each variant checked by the
   tool, the launches of the w8a8 and int4-probe kernels counted against
   the tools' own tallies;
11. one ``{"kernels": [...]}`` line;
12. the last line: ``{"ok": true, "device": {...}}``.

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
# kernel vs plain: max-abs error <= REL_TOL * max|plain|, per output.  For
# bf16 outputs one ulp is at most 2^-7 of a value, so this allows about 2.5
# ulps at the largest output; a kernel with a wrong mask, a wrong shift row
# or a wrong gradient term reads far above it (PERF.md, Findings).
REL_TOL = 2e-2
# the f32 outputs (the KL kernels', the quantized matmuls') differ from
# their plain versions by summation order only (about 1e-6); a kernel that
# rounded through bf16 reads above this
F32_REL_TOL = 1e-4
# whole-model checks, rel. L2: 32 bf16 layers amplify any reordering of the
# rounding (the plain attention rounds probabilities to bf16 before P·V), so
# the sound kernel path reads several 1e-2 here.  A sanity bound on the
# whole path; phase 3 is the kernels' correctness check (PERF.md, Findings)
REL_L2_TOL = 0.1
# phase 7: the kernel path's rel. L2 distance to the same weights run in
# f32 over the plain path's.  Rounding alone puts the two bf16 paths about
# equally far (PERF.md, Findings); a kernel with a wrong mask or rule adds its
# error on top
F32_DRIFT_RATIO = 1.25
N_ICV_Q = 4
N_ICL_Q = 2
ICL_SHOTS = 32
MAX_NEW = 5
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
TRAIN_BS = 2
TRAIN_MICRO = 4  # trainer=debug: limit_train_batches 4, accumulate 2
KL_EPS = 1e-6
CUDA_SOURCES = ("flash_attn_fwd.cu", "flash_attn_bwd.cu", "int8_matmul.cu", "int4_matmul.cu",
                "flash_attn_bidir.cu", "flash_alibi.cu", "vit_attention.cu", "w8a8_matmul.cu",
                "int4_unpack_probe.cu", "icv_inject_bwd.cu", "masked_kl.cu")


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


_profiler_works = True  # cleared once torch.profiler records no device activity


def device_events(fn, always: bool = False):
    """``(wall_ms, events)`` of one call of ``fn`` under ``torch.profiler``:
    the device-kernel events, or None where three sessions recorded no
    device activity (it happens now and then, more often after phase 3's
    hundreds of sessions, and on some machines always).  After such a
    failure the kernel cases stop asking the profiler; a main path's
    profile (``always``) asks it all the same."""
    global _profiler_works
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3 if _profiler_works or always else 0):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return wall, events
        log(f"  torch.profiler recorded no device activity (session {attempt + 1} of 3)")
    if _profiler_works:
        log("  torch.profiler is not used for the rest of the kernel cases; their device "
            "times come from CUDA events around work queued behind a spin kernel")
    _profiler_works = False
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, None


_spin_cycles_per_ms = None


def queued_ms(fn, calls: int, reps: int = 3) -> float:
    """Device time per call of ``fn`` from CUDA events around ``calls``
    calls that the host queues behind a spin kernel (``torch.cuda._sleep``)
    long enough for it to enqueue them all: the interval holds the device's
    work and the gaps between its kernels, not the host's launch cost.
    Median over ``reps``."""
    global _spin_cycles_per_ms
    import torch

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    if _spin_cycles_per_ms is None:
        start, end = events()
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        _spin_cycles_per_ms = 10_000_000 / start.elapsed_time(end)
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        start, end = events()
        torch.cuda._sleep(int(_spin_cycles_per_ms * (2 * host_ms + 1)))
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return sorted(times)[len(times) // 2]


def device_times(fns, calls: int) -> tuple[list, str]:
    """Device time per call of each of ``fns`` and how it was taken: the
    sum of the device-kernel intervals ``torch.profiler`` records over
    ``calls`` calls, divided by ``calls`` (every kernel a call launches;
    host launch gaps between kernels not counted), or, where the profiler
    records nothing for one of them or fewer kernels over the ``calls``
    calls than ``calls`` times what it records for one call (a session
    that lost events reads too low), ``queued_ms`` for all of them, so
    that they stay comparable."""
    times = []
    for fn in fns:
        fn()
        _, one = device_events(fn) if _profiler_works else (None, None)
        _, events = (device_events(lambda: [fn() for _ in range(calls)])
                     if one is not None else (None, None))
        if events is not None and len(events) < calls * len(one):
            log(f"  torch.profiler recorded {len(events)} kernels over {calls} calls of "
                f"{len(one)} each: timed from CUDA events instead")
            events = None
        if events is None:
            return [queued_ms(f, calls) for f in fns], "events"
        times.append(sum(e.time_range.end - e.time_range.start for e in events) / calls / 1e3)
    return times, "profiler"


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
    # a call that is not the same function, timed and printed as a note: the
    # bf16 matmul with a dense weight, which the quantized bytes save against
    dense: object = None
    dense_label: str = "bf16 matmul with the dense weight"
    # (B, S) bool: the rows the function defines, where the comparison looks
    # (the ALiBi kernel's rows with a visible key); None = every row
    rows: object = None
    # two kernel calls on the same inputs must give equal bits (the int4
    # kernel's split-K sums in a fixed order)
    deterministic: bool = False
    # limit of the mean error ratio (``mean_ratio``), where the max-abs
    # ratio cannot see a fault: None = not checked
    mean_tol: float = None
    # the calls compared, where they are not the timed ones (the KL
    # forward's weighted rows and masked mean): None = kernel and plain
    check: tuple = None
    # () -> (got, want), which must be equal bit for bit: None = no such check
    exact: object = None

    def bound(self) -> tuple[float, str]:
        t_bytes = self.bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = self.ops / PEAK_OPS[self.op_type] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# phase 5's KL rows when no collated batch is given (the CPU tests): bs=2
# student rows of 64 tokens, each with a 3-token answer and its EOS
KL_TRAIN_MASK_STAND_IN = ((60, 64), (57, 61))


def training_kl_mask(tmp: Path):
    """(128,) bool: the KL's row weights of phase 5's first collated batch
    (the student's answer-region mask over its 2 x 64 positions), on the
    synthetic split ``write_training_split`` writes under ``tmp``."""
    import torch

    from licv_vqa_tpu_torch.data.tokenizer import WhitespaceTokenizer
    from licv_vqa_tpu_torch.ops.kl import answer_region_mask

    write_training_split(tmp)
    batch = _collated_batch(TRAIN_ARGS)
    q = batch["query_inputs"]
    ids, attn = torch.as_tensor(q["input_ids"]), torch.as_tensor(q["attention_mask"]).bool()
    mask = answer_region_mask(ids, torch.as_tensor(batch["query_x_length"]),
                              WhitespaceTokenizer().pad_token_id) & attn.any(dim=1)[:, None]
    return mask.reshape(-1)


def kernel_cases(dev, kl_mask=None):
    """The kernel-vs-plain cases at the main paths' shapes, from a seed;
    ``kl_mask`` the KL's row weights at the training shape
    (``training_kl_mask``; a stand-in where None)."""
    import functools

    import torch
    import torch.nn.functional as F

    from licv_vqa_tpu_torch.models import layers as L
    from licv_vqa_tpu_torch.ops import flash_alibi as FA
    from licv_vqa_tpu_torch.ops import masked_kl_kernel as K
    from licv_vqa_tpu_torch.ops.icv_inject import (
        ADD_THEN_INJECT,
        _icv_inject_triton,
        add_icv_inject,
        add_icv_inject_reference,
        icv_inject,
        icv_inject_after_add,
        icv_inject_after_add_reference,
        icv_inject_backward,
        icv_inject_backward_reference,
        icv_inject_reference,
    )

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def layouts(b, s, d):
        # the (1, S, D) shift shared by the batch differs from per_pos at B > 1
        return (("row", (d,)), ("batch", (b, d)), ("batch1", (b, 1, d)), ("per_pos", (b, s, d)),
                *((("pos", (1, s, d)),) if b > 1 and s > 1 else ()))

    def written_sum(h, delta, v):
        """The sum the block output's entry writes for its backward, and
        eager PyTorch's."""
        return _icv_inject_triton(h, v, delta, ADD_THEN_INJECT, write_s=True)[1], h + delta

    for (b, s, d) in ((1, 512, 4096), (1, 64, 4096), (3, 1, 4096)):
        h, other = randn((b, s, d)), randn((b, s, d))
        for layout, vshape in layouts(b, s, d):
            v = randn(vshape, 0.5)
            n = b * s * d
            yield Case(
                "icv_inject", f"({b},{s},{d}) shift={layout}",
                lambda h=h, v=v: icv_inject(h, v),
                lambda h=h, v=v: icv_inject_reference(h, v),
                bytes_moved=2 * n * 2 + v.numel() * 2, ops=8 * n, op_type="f32", calls=50,
            )
            # the residual add folded in: two rows read, one written; the add
            # then the injection timed beside as the two launches it replaces
            yield Case(
                "icv_inject", f"({b},{s},{d}) shift={layout} after_add",
                lambda h=h, o=other, v=v: icv_inject_after_add(h, o, v),
                lambda h=h, o=other, v=v: icv_inject_after_add_reference(h, o, v),
                bytes_moved=3 * n * 2 + v.numel() * 2, ops=9 * n, op_type="f32", calls=50,
                dense=lambda h=h, o=other, v=v: icv_inject(h + o, v),
                dense_label="the add then icv_inject (two launches)",
                exact=lambda h=h, o=other, v=v: written_sum(h, o, v),
            )
            yield Case(
                "icv_inject", f"({b},{s},{d}) shift={layout} add_after",
                lambda h=h, o=other, v=v: add_icv_inject(o, h, v),
                lambda h=h, o=other, v=v: add_icv_inject_reference(o, h, v),
                bytes_moved=3 * n * 2 + v.numel() * 2, ops=9 * n, op_type="f32", calls=50,
                dense=lambda h=h, o=other, v=v: o + icv_inject(h, v),
                dense_label="icv_inject then the add (two launches)",
            )
    # training's student (bs=2, 64 tokens), a 512-token row, and phase 9's
    # flagship student (bs=4, 256 tokens)
    for (b, s, d) in ((2, 64, 4096), (1, 512, 4096), (4, 256, 4096)):
        h, gout = randn((b, s, d)), randn((b, s, d))
        for layout, vshape in layouts(b, s, d):
            v = randn(vshape, 0.5)
            n = b * s * d
            yield Case(
                "icv_inject_bwd", f"({b},{s},{d}) shift={layout}",
                lambda h=h, v=v, gout=gout: icv_inject_backward(h, v, gout),
                lambda h=h, v=v, gout=gout: icv_inject_backward_reference(h, v, gout),
                # h and g read, dh written, the shift read and its gradient
                # written (all bf16); the kernel's f32 partials of the
                # gradient are scratch, not the function's, and not counted
                bytes_moved=n * (2 + 2 + 2) + 2 * v.numel() * 2, ops=16 * n,
                op_type="f32", calls=50,
                # the gradient's partials are summed in a fixed order
                deterministic=True,
            )
    for b, s, pad in FLASH_FWD_SHAPES:
        q, k, v = (randn((b, s, 32, 128)) for _ in range(3))
        valid = torch.ones((b, s), dtype=torch.int32, device=dev)
        valid[:, :pad] = 0  # left padding, as the decode prompts are
        # with no pad the segment rule is the causal mask alone: the
        # library's own causal flash path is the same function
        mask = L.segment_causal_mask(valid) if pad else None
        yield Case(
            "flash_attention_fwd",
            f"({b},{s},32,128) " + (f"left pad {pad}" if pad else "all valid"),
            lambda q=q, k=k, v=v, valid=valid: L.flash_attention(q, k, v, valid),
            lambda q=q, k=k, v=v, valid=valid: L.flash_attention_reference(q, k, v, valid),
            # QK^T and PV over the pairs the segment rule leaves visible
            bytes_moved=4 * q.numel() * 2 + valid.numel() * 4,
            ops=4 * 32 * 128 * causal_segment_pairs(valid), op_type="bf16",
            library=lambda q=q, k=k, v=v, mask=mask: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
                is_causal=mask is None,
            ),
            calls=3 if b * s > 2048 else 5,
        )
    yield from flash_backward_cases(dev, randn)
    for b, s, grids, grid_w in BIDIR_SHAPES:
        q, k, v = (randn((b, s, 16, 72)) for _ in range(3))
        valid = navit_valid(b, s, grids, grid_w, dev)
        mask = L.segment_bidir_mask(valid)
        n_real = valid.sum(dim=1).double()
        # the visible pairs: real rows attend the real keys, invalid rows the
        # invalid ones (QK^T and PV)
        pairs = float((n_real ** 2 + (s - n_real) ** 2).sum())
        yield Case(
            "flash_attention_bidir", f"({b},{s},16,72) {bidir_label(s, grids, grid_w)}",
            lambda q=q, k=k, v=v, valid=valid: L.flash_attention_bidir(q, k, v, valid),
            lambda q=q, k=k, v=v, valid=valid: L.flash_attention_bidir_reference(q, k, v, valid),
            bytes_moved=4 * q.numel() * 2 + valid.numel() * 4, ops=4 * 16 * 72 * pairs,
            op_type="bf16",
            library=lambda q=q, k=k, v=v, mask=mask: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask
            ),
            calls=3 if b > 1 else 5,
        )
    for s, pad, side in ALIBI_SHAPES:
        q, k, v = (randn((1, s, 32, 128)) for _ in range(3))
        valid = torch.ones((1, s), dtype=torch.int32, device=dev)
        if side == "left":
            valid[:, :pad] = 0  # the decode prompts' padding
        else:
            valid[:, s - pad :] = 0  # the training batches'
        slopes = L.alibi_slopes(32, dev)
        rows = torch.cumsum(valid, dim=1) > 0  # rows with a visible key
        # the visible pairs (k <= q and valid[k]): QK^T and PV over them
        pairs = float(torch.cumsum(valid, dim=1).sum())
        yield Case(
            "flash_alibi_attention", f"(1,{s},32,128) {side} pad {pad}",
            lambda q=q, k=k, v=v, valid=valid, sl=slopes: FA.flash_alibi_attention(
                q, k, v, valid, sl, 128 ** -0.5),
            lambda q=q, k=k, v=v, valid=valid, sl=slopes: FA.flash_alibi_reference(
                q, k, v, valid, sl, 128 ** -0.5),
            bytes_moved=4 * q.numel() * 2 + valid.numel() * 4 + 32 * 4,
            ops=4 * 32 * 128 * pairs, op_type="bf16",
            library=lambda q=q, k=k, v=v, m=functools.cache(
                lambda valid=valid: alibi_float_mask(valid)): F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=m(),
                scale=128 ** -0.5),
            calls=5, rows=rows,
        )
    for b, s, dh, masked in VIT_SHAPES:
        q, k, v = (randn((b, s, 16, dh)) for _ in range(3))
        valid = None
        keys = torch.full((b,), float(s), device=dev)
        if masked:
            valid = torch.rand((b, s), generator=g, device=dev) > 0.3
            valid[-1] = False  # no valid key: the uniform softmax
            n = valid.sum(dim=1).float()
            keys = torch.where(n > 0, n, float(s))
        yield Case(
            "vit_attention", f"({b},{s},16,{dh}) {'masked' if masked else 'all valid'}",
            lambda q=q, k=k, v=v, valid=valid: L.vit_attention(q, k, v, valid),
            lambda q=q, k=k, v=v, valid=valid: L.vit_attention_reference(q, k, v, valid),
            bytes_moved=4 * q.numel() * 2 + (0 if valid is None else valid.numel() * 4),
            # QK^T and PV over every query and the keys its softmax weighs
            ops=4 * 16 * dh * s * float(keys.sum()), op_type="bf16",
            library=lambda q=q, k=k, v=v, valid=valid: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=None if valid is None else valid[:, None, None, :]),
            calls=5, mean_tol=VIT_MEAN_TOL,
        )
    if kl_mask is None:
        kl_mask = torch.zeros((2, 64), dtype=torch.bool)
        for row, (lo, hi) in enumerate(KL_TRAIN_MASK_STAND_IN):
            kl_mask[row, lo:hi] = True
    kl_mask = kl_mask.reshape(-1).to(dev)
    for n, v_sz, mask in ((128, 32000, "70%"), (128, 32000, "all"), (512, 32000, "70%"),
                          (512, 32000, "all"), (128, 32002, "train")):
        stu, tea = randn((n, v_sz), 3.0, torch.float32), randn((n, v_sz), 3.0, torch.float32)
        w = {"70%": lambda: (torch.rand((n,), generator=g, device=dev) < 0.7).float(),
             "all": lambda: torch.ones((n,), device=dev),
             "train": lambda: kl_mask.float()}[mask]()
        n_w = int((w != 0).sum())
        gw = w / w.sum()  # the masked mean's per-row cotangent
        _, lse_s, lse_t = K.rowwise_kl_reference(stu, tea, KL_EPS, w)
        label = f"({n},{v_sz}) f32 {mask} ({n_w} of {n} rows weighted)"
        keep = w != 0

        def weighted(out, w=w, keep=keep):
            """The forward's outputs on the weighted rows, and the masked mean."""
            kl, a, b = out
            return kl[keep], a[keep], b[keep], (torch.dot(kl, w) / w.sum())[None]

        yield Case(
            "masked_kl_fwd", label,
            lambda stu=stu, tea=tea, w=w: K.rowwise_kl_forward(stu, tea, KL_EPS, w),
            lambda stu=stu, tea=tea, w=w: K.rowwise_kl_reference(stu, tea, KL_EPS, w),
            # the weighted rows read; three outputs a row written
            bytes_moved=2 * n_w * v_sz * 4 + 4 * n * 4, ops=17 * n_w * v_sz, op_type="f32",
            tol=F32_REL_TOL, deterministic=True,
            check=(lambda stu=stu, tea=tea, w=w: weighted(
                       K.rowwise_kl_forward(stu, tea, KL_EPS, w)),
                   lambda stu=stu, tea=tea, w=w: weighted(
                       K.rowwise_kl_reference(stu, tea, KL_EPS, w))),
        )
        yield Case(
            "masked_kl_bwd", label,
            lambda stu=stu, tea=tea, a=lse_s, b=lse_t, gw=gw, w=w: K.rowwise_kl_backward(
                stu, tea, a, b, gw, KL_EPS, w),
            lambda stu=stu, tea=tea, a=lse_s, b=lse_t, gw=gw, w=w:
                K.rowwise_kl_backward_reference(stu, tea, a, b, gw, KL_EPS, w),
            # the weighted rows read, every row's two gradients written
            bytes_moved=(2 * n_w + 2 * n) * v_sz * 4 + 5 * n * 4, ops=30 * n_w * v_sz,
            op_type="f32", tol=F32_REL_TOL, deterministic=True,
        )


    yield from quantized_cases(dev)
    yield from w8a8_cases(dev)
    yield from int4_probe_cases(dev)


# the causal flash forward's cases at H=32, Dh=128: (B, S, left pad).  The
# 32-shot prefill buckets of Idefics-9B (384, 512), its 2048 bucket, the
# Idefics2 test_icl prefill (2560), and the flagship teacher's call (phase
# 9: four 2048-token rows, all valid)
FLASH_FWD_SHAPES = ((1, 384, 57), (1, 512, 39), (1, 2048, 301), (1, 2560, 173), (4, 2048, 0))

# the causal flash backward's cases: (B, S, H) at Dh 128 and each row's real
# length, right-padded as the training batches are.  The flagship student
# (phase 9's) with ragged rows and with every row valid (the library call is
# then PyTorch's own causal flash backward); the shape of JAX
# tools/validate_flash_tpu.py's gradient check (valid[1, 400:] = 0,
# valid[3, 100:] = 0); one 2048-token row
FLASH_BWD_SHAPES = (
    ((4, 256, 32), (256, 201, 150, 77)),
    ((4, 256, 32), (256, 256, 256, 256)),
    ((4, 512, 8), (512, 400, 512, 100)),
    ((1, 2048, 32), (1798,)),
)


def right_padded(lengths, s: int, dev):
    """(B, S) int32: row i real up to ``lengths[i]``."""
    import torch

    return (torch.arange(s, device=dev)[None] < torch.tensor(lengths, device=dev)[:, None]).to(
        torch.int32)


def causal_segment_pairs(valid) -> float:
    """The (query, key) pairs the causal segment rule leaves visible: a real
    query sees the real keys up to it, a pad query the pads up to it."""
    import torch

    v = valid.long()
    return float(torch.where(v.bool(), torch.cumsum(v, 1), torch.cumsum(1 - v, 1)).sum())


def flash_backward_cases(dev, randn):
    """The backward kernels against the plain backward at
    ``FLASH_BWD_SHAPES``, on the output and log-sum-exp the forward kernel
    writes (its log-sum-exp first held against the plain one, to
    ``F32_REL_TOL``); the library call is the backward of
    ``F.scaled_dot_product_attention`` under the segment mask, timed on
    ``torch.autograd.grad`` alone."""
    import functools

    import torch
    import torch.nn.functional as F

    from licv_vqa_tpu_torch.models import layers as L

    scale = 128 ** -0.5
    for (b, s, h), lengths in FLASH_BWD_SHAPES:
        q, k, v, do = (randn((b, s, h, 128)) for _ in range(4))
        valid = right_padded(lengths, s, dev)
        every = all(n == s for n in lengths)
        label = f"({b},{s},{h},128) " + (
            "all valid" if every else f"lengths {','.join(map(str, lengths))}")

        @functools.cache
        def forward(q=q, k=k, v=v, valid=valid, label=label):
            """The forward kernel's output and log-sum-exp (made on first use,
            its log-sum-exp held against the plain one then)."""
            if dev.type == "cuda":
                o, lse = L._flash_attention_cuda(q, k, v, valid, scale, with_lse=True)
            else:  # the CPU rehearsal: the plain output and log-sum-exp
                o = L.flash_attention_reference(q, k, v, valid, scale)
                lse = L.flash_attention_lse_reference(q, k, valid, scale)
            want = L.flash_attention_lse_reference(q, k, valid, scale)
            err = (lse - want).abs().max().item()
            log(f"flash_attention_fwd {label} log-sum-exp: max_abs={err:.3e} "
                f"(max|plain| {want.abs().max().item():.3e}, limit {F32_REL_TOL} of it)")
            if not err <= F32_REL_TOL * want.abs().max().item():
                raise AssertionError(f"flash_attention_fwd {label}: log-sum-exp disagrees")
            return o, lse

        @functools.cache
        def library_graph(q=q, k=k, v=v, valid=valid, every=every):
            leaves = [x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v)]
            # with every row valid the segment rule is the causal mask alone
            mask = None if every else L.segment_causal_mask(valid)
            out = F.scaled_dot_product_attention(
                *leaves, attn_mask=mask, is_causal=every, scale=scale)
            return out, leaves

        rest = (do, valid, scale)
        yield Case(
            "flash_attention_bwd", label,
            lambda f=forward, x=(q, k, v), r=rest: L.flash_attention_backward(*x, *f(), *r),
            lambda f=forward, x=(q, k, v), r=rest: L.flash_attention_bwd_reference(*x, *f(), *r),
            # q, k, v, o, do read and dq, dk, dv written (bf16), the f32
            # log-sum-exp and the int32 validity read
            bytes_moved=8 * q.numel() * 2 + b * h * s * 4 + valid.numel() * 4,
            # five products over the visible pairs: QK^T and dO·V^T again,
            # dV, dK, dQ
            ops=5 * 2 * 128 * h * causal_segment_pairs(valid), op_type="bf16",
            library=lambda g=library_graph, do=do: torch.autograd.grad(
                g()[0], g()[1], do.transpose(1, 2), retain_graph=True),
            calls=3 if s >= 2048 else 10,
        )


# the SigLIP tower's attention (H=16, Dh=72) in phase 7: (B, S, the valid
# (rows, cols) of each image's patch grid, cycled (None = every patch real),
# the padded grid's columns).  One 980x980 image (70x70 patches); one
# 640x480 image padded to 672x560 (48x40 patches, 34x45 valid); a 32-shot
# prompt's 33 images of 640x480, 640x427 and 500x378 (the 378-pixel
# minimum), all padded to 672x560; two images padded to a 20x55 grid, whose
# S = 1100 is no multiple of the kernel's 128-key tile (the invalid rows
# must not see the ragged tail)
BIDIR_SHAPES = (
    (1, 4900, None, None),
    (1, 1920, ((34, 45),), 48),
    (33, 1920, ((34, 45), (30, 45), (27, 35)), 48),
    (2, 1100, ((20, 30), (15, 55)), 55),
)

# the MPT prefill's ALiBi attention (H=32, Dh=128) in phase 8: (S, pad, side).
# A 32-shot prompt's bucket and the longest one MPT-7B's context takes, each
# left-padded (the decode prompts) and right-padded (the training batches)
ALIBI_SHAPES = ((512, 39, "left"), (512, 61, "right"), (2048, 301, "left"),
                (2048, 250, "right"))
# the CLIP towers' attention (H=16) in phases 4-8: (B, S, Dh, masked).
# OpenFlamingo's ViT-L (Dh 64) at a test_icv bind and at a 32-shot bind's 33
# images, Idefics-9B's ViT-H (Dh 80) at a 32-shot bind; a key mask (one row
# with no valid key); the gate's largest S
VIT_SHAPES = ((1, 257, 64, False), (33, 257, 64, False), (33, 257, 80, False),
              (4, 257, 80, True), (2, 1024, 80, True))
# the fused ViT kernel's mean error ratio against its plain version.  P
# rounded to bf16 before it is normalised (in place of after, as the plain
# version rounds) moves every output by about an ulp: under the max-abs
# limit, above this one
VIT_MEAN_TOL = 3e-4


def alibi_float_mask(valid):
    """The ALiBi bias and the causal-and-valid mask as one (1, H, S, S) bf16
    additive mask (masked entries at bf16's lowest, so no row is NaN): the
    library call's operand."""
    import torch

    from licv_vqa_tpu_torch.models import layers as L

    pos = torch.arange(valid.shape[1], device=valid.device)[None].expand_as(valid)
    bias = L.alibi_bias(32, pos, pos)
    mask = L.causal_mask(pos, pos, valid.bool())
    return bias.masked_fill(~mask, torch.finfo(torch.bfloat16).min).to(torch.bfloat16)


def navit_valid(b: int, s: int, grids, gw: int, dev):
    """(B, S) int32 patch validity: each image fills the top-left rows x
    cols of the padded (S / gw) x gw grid, as the NaViT processor pads it."""
    import torch

    valid = torch.ones((b, s), dtype=torch.int32, device=dev)
    if grids is not None:
        for i in range(b):
            rows, cols = grids[i % len(grids)]
            grid = torch.zeros((s // gw, gw), dtype=torch.int32, device=dev)
            grid[:rows, :cols] = 1
            valid[i] = grid.reshape(-1)
    return valid


def bidir_label(s: int, grids, gw) -> str:
    if grids is None:
        return "all valid"
    return "valid " + ",".join(f"{r}x{c}" for r, c in grids) + f" of {s // gw}x{gw}"


# the quantized decode matmuls' cases: ((M, K, N), output dtype).  A beam
# step's projections (3 rows: wq/wk/wv/wo with bf16 outputs, the MLP's
# gate/up and down with f32 outputs) and a 64-row prefill block, for both
# kernels; the int8 head (int8 in both modes) at a 32000-word vocabulary
# and at Idefics-9B's 32000 + 2 added tokens, whose rows take 2-byte loads,
# at a beam step and at prefill (run A, one row); run B's 64-row prefill
# MLP and its bind-time cross-attention K/V (64 latents of the perceiver's
# 1280 features)
QUANT_SHAPES = (
    ((3, 4096, 4096), "bf16"), ((3, 4096, 11008), "f32"), ((3, 11008, 4096), "f32"),
    ((64, 4096, 4096), "bf16"),
)
HEAD_SHAPES = (((3, 4096, 32000), "f32"), ((3, 4096, 32002), "f32"), ((1, 4096, 32002), "f32"))
INT4_PREFILL_SHAPES = (
    ((64, 4096, 11008), "f32"), ((64, 11008, 4096), "f32"), ((64, 1280, 4096), "bf16"),
)
INT4_GROUP = 64


def quantized_cases(dev):
    """The int8 and int4 kernels against their plain versions.  Inputs are
    made on first use, on ``dev``: a random bf16 weight quantized as the
    registry does, and bf16 activations."""
    import functools

    import torch

    from licv_vqa_tpu_torch.ops import int4_matmul as I4
    from licv_vqa_tpu_torch.ops import int8_matmul as I8
    from licv_vqa_tpu_torch.ops import quantize as Q

    for mode, shapes in (("int8", QUANT_SHAPES + HEAD_SHAPES),
                         ("int4", QUANT_SHAPES + INT4_PREFILL_SHAPES)):
        for (m, k, n), out in shapes:
            odt = torch.float32 if out == "f32" else torch.bfloat16

            @functools.cache
            def inputs(m=m, k=k, n=n, mode=mode):
                g = torch.Generator(device=dev).manual_seed(m + k + n)
                w = (torch.randn((k, n), generator=g, device=dev) * 0.02).to(torch.bfloat16)
                x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
                if mode == "int8":
                    leaf = Q.quantize_array(w)
                    # _weight_int8pack_mm's layout: (N, K) int8, (N,) scales
                    return dict(x=x, dense=w, args=(leaf["q"], leaf["s"]),
                                w_nk=leaf["q"].t().contiguous(),
                                sc=leaf["s"].reshape(-1).to(x.dtype))
                leaf = Q.quantize_array_int4(w, INT4_GROUP)
                s = leaf["s"].reshape(k // INT4_GROUP, n)
                return dict(x=x, dense=w, args=(leaf["q4"], s, INT4_GROUP),
                            signed=Q._unpack_int4(leaf["q4"]), sc=s)

            ob = 4 if out == "f32" else 2
            if mode == "int8":
                wrapper, plain = I8.int8_matmul, I8.int8_matmul_reference
                w_bytes = k * n + n * 4  # int8 plane, f32 column scales
                library = lambda i=inputs: torch._weight_int8pack_mm(
                    i()["x"], i()["w_nk"], i()["sc"])
            else:
                wrapper, plain = I4.int4_matmul, I4.int4_matmul_reference
                w_bytes = k * n // 2 + (k // INT4_GROUP) * n * 2  # packed nibbles, bf16 scales
                library = int4pack_library(
                    lambda i=inputs: (i()["x"], i()["signed"], i()["sc"]), INT4_GROUP)
            yield Case(
                f"{mode}_matmul", f"({m},{k},{n}) {out} out",
                lambda i=inputs, f=wrapper, o=odt: f(i()["x"], *i()["args"], o),
                lambda i=inputs, f=plain, o=odt: f(i()["x"], *i()["args"], o),
                bytes_moved=m * k * 2 + w_bytes + m * n * ob, ops=2 * m * k * n,
                op_type="bf16", library=library,
                # f32 outputs differ from the plain version by summation
                # order only; one rounded through bf16 reads above 1e-4
                tol=F32_REL_TOL if out == "f32" else REL_TOL,
                dense=lambda i=inputs: i()["x"] @ i()["dense"],
                # split-K sums in a fixed order (a cluster's ranks)
                deterministic=True,
            )
    yield int4_cold_case(dev)
    for shape, copies in INT8_COLD:
        yield int8_cold_case(dev, shape, copies)


# the int4 kernel with its weights cold: a beam step's (M, K, N), each call
# on the next of INT4_COLD_COPIES copies of the weights (8 x 8.9 MB, past
# the 50 MB L2), as a decode step streams its weights from device memory
INT4_COLD_SHAPE = (3, 4096, 4096)
INT4_COLD_COPIES = 8


def int4_cold_case(dev):
    """The int4 kernel, its plain version and the library call at
    ``INT4_COLD_SHAPE``, each cycling through ``INT4_COLD_COPIES`` copies
    of one quantized weight (equal bytes at other addresses, so the first
    call of each compares equal inputs and two calls give equal bits); the
    library call through as many copies of its own layout."""
    import functools

    import torch

    from licv_vqa_tpu_torch.ops import int4_matmul as I4
    from licv_vqa_tpu_torch.ops import quantize as Q

    m, k, n = INT4_COLD_SHAPE

    @functools.cache
    def inputs():
        g = torch.Generator(device=dev).manual_seed(m + k + n)
        w = (torch.randn((k, n), generator=g, device=dev) * 0.02).to(torch.bfloat16)
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        leaf = Q.quantize_array_int4(w, INT4_GROUP)
        s = leaf["s"].reshape(k // INT4_GROUP, n)
        copies = [(leaf["q4"].clone(), s.clone()) for _ in range(INT4_COLD_COPIES)]
        return x, copies, Q._unpack_int4(leaf["q4"]), s

    layouts = [int4pack_library(lambda: (inputs()[0], *inputs()[2:]), INT4_GROUP)
               for _ in range(INT4_COLD_COPIES)]

    @functools.cache
    def built():
        # each copy's layout is built at its first call: all of them at the
        # case's first library call, before any timed one
        for layout in layouts:
            layout()
        return layouts

    return Case(
        "int4_matmul", f"cold ({m},{k},{n}) bf16 out, {INT4_COLD_COPIES} weight copies",
        cycling(lambda i: I4.int4_matmul(inputs()[0], *inputs()[1][i], INT4_GROUP,
                                         torch.bfloat16), INT4_COLD_COPIES),
        cycling(lambda i: I4.int4_matmul_reference(inputs()[0], *inputs()[1][i], INT4_GROUP,
                                                   torch.bfloat16), INT4_COLD_COPIES),
        bytes_moved=m * k * 2 + k * n // 2 + (k // INT4_GROUP) * n * 2 + m * n * 2,
        ops=2 * m * k * n, op_type="bf16",
        library=cycling(lambda i: built()[i](), INT4_COLD_COPIES), deterministic=True,
    )


# the int8 kernel with its weights cold: a beam step's wq/wk/wv/wo across
# 8 copies of the weights (8 x 16.8 MB) and its MLP gate/up across 4 (4 x
# 45.1 MB), past the 50 MB L2, as a decode step streams its weights from
# device memory; the dense bf16 matmul beside it cold too
INT8_COLD = ((((3, 4096, 4096), "bf16"), 8), (((3, 4096, 11008), "f32"), 4))


def int8_cold_case(dev, shape, copies: int):
    """The int8 kernel, its plain version and the library call, each
    cycling through ``copies`` copies of one quantized weight (equal bytes
    at other addresses: equal outputs, so two calls give equal bits); the
    library's (N, K) layout and the dense bf16 weight (the note) each in as
    many copies, built before any timed call."""
    import functools

    import torch

    from licv_vqa_tpu_torch.ops import int8_matmul as I8
    from licv_vqa_tpu_torch.ops import quantize as Q

    (m, k, n), out = shape
    odt = torch.float32 if out == "f32" else torch.bfloat16

    @functools.cache
    def inputs():
        g = torch.Generator(device=dev).manual_seed(m + k + n)
        w = (torch.randn((k, n), generator=g, device=dev) * 0.02).to(torch.bfloat16)
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        leaf = Q.quantize_array(w)
        sc = leaf["s"].reshape(-1).to(x.dtype)
        return dict(x=x, q=[(leaf["q"].clone(), leaf["s"].clone()) for _ in range(copies)],
                    nk=[(leaf["q"].t().contiguous(), sc) for _ in range(copies)],
                    dense=[w.clone() for _ in range(copies)])

    return Case(
        "int8_matmul", f"cold, {copies} weight copies, ({m},{k},{n}) {out} out",
        cycling(lambda i: I8.int8_matmul(inputs()["x"], *inputs()["q"][i], odt), copies),
        cycling(lambda i: I8.int8_matmul_reference(inputs()["x"], *inputs()["q"][i], odt),
                copies),
        bytes_moved=m * k * 2 + k * n + n * 4 + m * n * (4 if out == "f32" else 2),
        ops=2 * m * k * n, op_type="bf16",
        library=cycling(lambda i: torch._weight_int8pack_mm(inputs()["x"], *inputs()["nk"][i]),
                        copies),
        tol=F32_REL_TOL if out == "f32" else REL_TOL,
        dense=cycling(lambda i: inputs()["x"] @ inputs()["dense"][i], copies),
        deterministic=True,
    )


def int4pack_library(operands, group: int):
    """The call of ``torch._weight_int4pack_mm`` that computes ``x @ (q ·
    s)`` from ``operands() = (x, q, s)``: q (K, N) the signed int4 values,
    s (K/G, N) the group scales.  Its layout (uint4 = q + 8 with a zero
    point of 0, two a byte along K, then ``_convert_weight_to_int4pack``)
    is built once, at the first call, outside the timed calls; a torch that
    refuses it raises there, and ``library_runs`` records why."""
    import functools

    import torch

    @functools.cache
    def layout():
        x, q, s = operands()
        u = (q.t().to(torch.int32) + 8).contiguous()  # (N, K)
        packed = (u[:, ::2] << 4 | u[:, 1::2]).to(torch.uint8)
        w = torch._convert_weight_to_int4pack(packed, 8)
        sz = torch.stack([s.to(torch.bfloat16), torch.zeros_like(s, dtype=torch.bfloat16)],
                         dim=-1).contiguous()  # (K/G, N, 2): scale, zero
        return x.to(torch.bfloat16), w, sz

    def call():
        x, w, sz = layout()
        return torch._weight_int4pack_mm(x, w, group, sz)

    return call


# w8a8 (phase 6's run A and the tuning tool): (M, K, N) and the output
# dtype.  Run A's 64-token prefill (the attention projections; the MLP in
# and out, f32), its 32-shot test_icl prefill in the 512-token bucket (the
# same projections), the bind-time cross-attention K/V of 64 perceiver
# latents (K = 1280: 16 a question) and the perceiver's K/V over 64 latents
# and 257 patches (12 a question); the tool's serving-prefill MLP (M = 64 x
# 64)
W8A8_SHAPES = (
    ((64, 4096, 4096), "bf16"), ((64, 4096, 11008), "f32"), ((64, 11008, 4096), "f32"),
    ((512, 4096, 4096), "bf16"), ((512, 4096, 11008), "f32"), ((512, 11008, 4096), "f32"),
    ((64, 1280, 4096), "bf16"), ((321, 1280, 1536), "bf16"),
    ((4096, 4096, 11008), "bf16"), ((4096, 11008, 4096), "bf16"),
)
# the fused w8a8 kernel with its weights cold: run A's 64-token prefill
# projection and MLP-in, each call on the next of the copies (8 x 16.8 MB
# and 4 x 45.1 MB, past the 50 MB L2), as a prefill streams its layers'
# weights from device memory
W8A8_COLD_SHAPES = (((64, 4096, 4096), "bf16", 8), ((64, 4096, 11008), "f32", 4))
# the int4 unpack probe's shape (tools/exp_int4_unpack.py: M, K, N, G) and
# its cold copies (6 x 25.3 MB)
INT4_PROBE_SHAPE = (8, 4096, 11008)
INT4_PROBE_COLD_COPIES = 6


def cycling(call, copies: int):
    """``call(i)`` on the next of ``copies`` operand copies at each call."""
    import itertools

    count = itertools.count()
    return lambda: call(next(count) % copies)


def w8a8_cases(dev):
    """The w8a8 kernel, both entry points, against its plain versions: equal
    outputs (the int32 sum is exact and the epilogue the same f32
    arithmetic).  Inputs made on first use: a random bf16 weight quantized
    as the registry does, bf16 activations."""
    import functools

    import torch

    from licv_vqa_tpu_torch.ops import int8_matmul as I8
    from licv_vqa_tpu_torch.ops import quantize as Q

    for (m, k, n), out in W8A8_SHAPES:
        odt = torch.float32 if out == "f32" else torch.bfloat16
        ob = 4 if out == "f32" else 2

        @functools.cache
        def inputs(m=m, k=k, n=n):
            g = torch.Generator(device=dev).manual_seed(m + k + n)
            leaf = Q.quantize_array(
                (torch.randn((k, n), generator=g, device=dev) * 0.02).to(torch.bfloat16))
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            xq, xs = I8.quantize_act_rows(x)
            return dict(x=x, q=leaf["q"], s=leaf["s"], xq=xq, xs=xs,
                        xq_p=I8.pad_rows_for_int_mm(xq))

        library = lambda i=inputs: torch._int_mm(i()["xq_p"], i()["q"])  # noqa: E731
        calls = 5 if m * k * n > 1e10 else 20
        w_bytes = k * n + n * 4  # the int8 plane, f32 column scales
        yield Case(
            "w8a8_matmul", f"fused ({m},{k},{n}) {out} out",
            lambda i=inputs, o=odt: I8.w8a8_matmul(i()["x"], i()["q"], i()["s"], o),
            lambda i=inputs, o=odt: I8.w8a8_matmul_reference(i()["x"], i()["q"], i()["s"], o),
            bytes_moved=m * k * 2 + w_bytes + m * n * ob, ops=2 * m * k * n, op_type="int8",
            library=library, calls=calls, tol=0.0, deterministic=True,
        )
        yield Case(
            "w8a8_matmul", f"prequantized ({m},{k},{n}) {out} out",
            lambda i=inputs, o=odt: I8.w8a8_matmul_prequantized(
                i()["xq"], i()["xs"], i()["q"], i()["s"], o),
            lambda i=inputs, o=odt: I8.w8a8_prequantized_reference(
                i()["xq"], i()["xs"], i()["q"], i()["s"], o),
            bytes_moved=m * k + m * 4 + w_bytes + m * n * ob, ops=2 * m * k * n, op_type="int8",
            library=library, calls=calls, tol=0.0, deterministic=True,
        )
    for (m, k, n), out, copies in W8A8_COLD_SHAPES:
        yield w8a8_cold_case(dev, m, k, n, out, copies)


def w8a8_cold_case(dev, m: int, k: int, n: int, out: str, copies: int):
    """The fused w8a8 kernel, its plain version and the library call, each
    cycling through ``copies`` copies of one quantized weight (equal bytes
    at other addresses: equal outputs, so two calls give equal bits);
    ``torch._int_mm`` takes the weight's own layout, so its copies are
    built as the kernel's are, before any timed call."""
    import functools

    import torch

    from licv_vqa_tpu_torch.ops import int8_matmul as I8
    from licv_vqa_tpu_torch.ops import quantize as Q

    odt = torch.float32 if out == "f32" else torch.bfloat16

    @functools.cache
    def inputs():
        g = torch.Generator(device=dev).manual_seed(m + k + n)
        leaf = Q.quantize_array(
            (torch.randn((k, n), generator=g, device=dev) * 0.02).to(torch.bfloat16))
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        xq_p = I8.pad_rows_for_int_mm(I8.quantize_act_rows(x)[0])
        return x, [(leaf["q"].clone(), leaf["s"].clone()) for _ in range(copies)], xq_p

    return Case(
        "w8a8_matmul", f"cold fused ({m},{k},{n}) {out} out, {copies} weight copies",
        cycling(lambda i: I8.w8a8_matmul(inputs()[0], *inputs()[1][i], odt), copies),
        cycling(lambda i: I8.w8a8_matmul_reference(inputs()[0], *inputs()[1][i], odt), copies),
        bytes_moved=m * k * 2 + k * n + n * 4 + m * n * (4 if out == "f32" else 2),
        ops=2 * m * k * n, op_type="int8",
        library=cycling(lambda i: torch._int_mm(inputs()[2], inputs()[1][i][0]), copies),
        tol=0.0, deterministic=True,
    )


def int4_probe_cases(dev):
    """The int4 unpack probe's four schedules against their plain versions,
    on the tool's operands (``np.random.default_rng(0)``), packed per
    schedule."""
    import functools

    import numpy as np
    import torch

    from licv_vqa_tpu_torch.ops import int4_unpack_probe as P

    m, k, n = INT4_PROBE_SHAPE
    g = INT4_GROUP

    @functools.cache
    def operands():
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev)
        q = torch.from_numpy(rng.integers(-7, 8, size=(k, n)).astype(np.int8)).to(dev)
        s = torch.from_numpy(rng.random((k // g, n)).astype(np.float32) * 0.01 + 0.001).to(dev)
        return x, q, s

    library = int4pack_library(operands, g)
    # bf16 x, a byte a nibble pair, f32 group scales, f32 out
    nbytes = m * k * 2 + k * n // 2 + (k // g) * n * 4 + m * n * 4
    for sched in P.SCHEDULES:
        packed = functools.cache(lambda sched=sched: P.probe_operands(*operands()[1:], sched))
        yield Case(
            "int4_unpack_probe", f"{sched} ({m},{k},{n}) G={g}",
            lambda sched=sched, pk=packed: P.int4_unpack_probe(operands()[0], *pk(), g, sched),
            lambda sched=sched, pk=packed: P.int4_unpack_probe_reference(
                operands()[0], *pk(), g, sched),
            bytes_moved=nbytes, ops=2 * m * k * n, op_type="bf16", library=library, calls=50,
            tol=F32_REL_TOL,
        )
    # schedule a (the int4 kernel's decode) with its weights cold: the
    # kernel, its plain version and the library call each cycling through
    # INT4_PROBE_COLD_COPIES copies, the library's layouts built before any
    # timed call
    copies = INT4_PROBE_COLD_COPIES
    cold = functools.cache(lambda: [tuple(t.clone() for t in P.probe_operands(*operands()[1:], "a"))
                                    for _ in range(copies)])
    layouts = [int4pack_library(operands, g) for _ in range(copies)]

    @functools.cache
    def built():
        for layout in layouts:
            layout()
        return layouts

    yield Case(
        "int4_unpack_probe", f"cold a ({m},{k},{n}) G={g}, {copies} weight copies",
        cycling(lambda i: P.int4_unpack_probe(operands()[0], *cold()[i], g, "a"), copies),
        cycling(lambda i: P.int4_unpack_probe_reference(operands()[0], *cold()[i], g, "a"),
                copies),
        bytes_moved=nbytes, ops=2 * m * k * n, op_type="bf16",
        library=cycling(lambda i: built()[i](), copies), calls=50, tol=F32_REL_TOL,
    )


def compare(kernel, plain, rows=None) -> tuple[float, float]:
    """``(max-abs error, worst error ratio)`` of one kernel call against its
    plain version on the same inputs, over every output (on ``rows`` only
    where given: a (B, S) bool over the outputs' leading dims); the ratio is
    each output's max-abs error over that output's max|plain|.  A
    non-finite kernel output raises."""
    import torch

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err, ratio = 0.0, 0.0
    for a, b in zip(got, want, strict=True):
        if not torch.isfinite(a).all():
            raise AssertionError("non-finite kernel output")
        if rows is not None:
            a, b = a[rows], b[rows]
        e = (a.float() - b.float()).abs().max().item()
        err = max(err, e)
        ratio = max(ratio, e / max(b.float().abs().max().item(), 1e-30))
    return err, ratio


def mean_ratio(kernel, plain, rows=None) -> float:
    """The worst output's mean-abs error of one kernel call against its
    plain version on the same inputs, over that output's mean|plain| (on
    ``rows`` only where given): what a systematic error of an ulp reads,
    where the max-abs ratio sees only the largest element's."""
    import torch

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    for a, b in zip(got, want, strict=True):
        if rows is not None:
            a, b = a[rows], b[rows]
        e = (a.float() - b.float()).abs().mean().item()
        worst = max(worst, e / max(b.float().abs().mean().item(), 1e-30))
    return worst


# the main paths' most frequent call of each kernel: the ICV injection at a
# beam step (32 per step), the flash forward at the 32-shot prefill (512),
# the ICV backward and the KL at the training student (bs=2, 64 tokens)
MAIN_SHAPE = {
    # every ICV launch of the main paths is now a fused one: Idefics-9B's
    # and OpenFlamingo's at the block output
    "icv_inject": "(3,1,4096) shift=row after_add",
    "flash_attention_fwd": "(1,512,32,128)",
    # the flagship student's layer (phase 9), the only path that reaches it
    "flash_attention_bwd": "(4,256,32,128) lengths",
    "icv_inject_bwd": "(2,64,4096) shift=row",
    # the training student's rows at the head's width, its answer mask
    "masked_kl_fwd": "(128,32002) f32 train",
    "masked_kl_bwd": "(128,32002) f32 train",
    # a beam step's wq/wk/wv/wo (the most frequent quantized call)
    "int8_matmul": "(3,4096,4096)",
    "int4_matmul": "(3,4096,4096)",
    # the tower at a test_icv bind (one 640x480 image), phase 7's most
    # frequent call
    "flash_attention_bidir": "(1,1920,16,72)",
    # phase 8's 32-shot prefill (its 512-token bucket, left-padded)
    "flash_alibi_attention": "(1,512,32,128) left",
    # the ViT-L tower at an OpenFlamingo test_icv bind (one image)
    "vit_attention": "(1,257,16,64)",
    # run A's 64-token prefill projections (the most frequent w8a8 call)
    "w8a8_matmul": "fused (64,4096,4096)",
    # the JAX tool's first schedule, its production kernel of the time
    "int4_unpack_probe": "a (8,4096,11008)",
}


def equal_bits(first, second) -> bool:
    """Whether two kernel calls' outputs (a tensor or a tuple of them) are
    equal bit for bit."""
    import torch

    torch.cuda.synchronize()
    first = first if isinstance(first, tuple) else (first,)
    second = second if isinstance(second, tuple) else (second,)
    return all(torch.equal(a, b) for a, b in zip(first, second, strict=True))


def library_runs(c: Case) -> tuple:
    """``(True, "")`` where the case has a library call that this torch runs
    on the card, else ``(False, reason)``."""
    import torch

    if c.library is None:
        return False, "none"
    try:
        c.library()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as err:
        return False, f"none ({str(err).strip().splitlines()[0][:120]})"
    return True, ""


def check_kernels(dev, kl_mask=None) -> dict:
    """Phase 3.  Returns per-kernel summaries for the kernels line."""
    import torch

    out = {}
    for c in kernel_cases(dev, kl_mask):
        err, ratio = compare(*(c.check or (c.kernel, c.plain)), c.rows)
        mean = None if c.mean_tol is None else mean_ratio(c.kernel, c.plain, c.rows)
        if c.deterministic and not equal_bits(c.kernel(), c.kernel()):
            raise AssertionError(f"{c.name} {c.label}: two calls on equal inputs differ")
        if c.exact is not None and not equal_bits(*c.exact()):
            raise AssertionError(f"{c.name} {c.label}: not bit-equal to eager PyTorch")
        has_lib, lib = library_runs(c)
        fns = [c.kernel, c.plain] + [f for f, on in ((c.library, has_lib), (c.dense, c.dense))
                                     if on]
        times, timed_by = device_times(fns, c.calls)
        dev_ms, dev_plain = times[:2]
        lib_ms = times[2] if has_lib else None
        if has_lib:
            lib = f"{lib_ms:.5f} ms"
        ev_ms, ev_plain = time_ms(c.kernel, inner=c.calls), time_ms(c.plain, inner=c.calls)
        bound_ms, bound_by = c.bound()
        note = f"; note: {c.dense_label} {times[-1]:.5f} ms" if c.dense is not None else ""
        mean_note = "" if mean is None else f", mean ratio {mean:.3e} (limit {c.mean_tol})"
        log(f"{c.name} {c.label}: max_abs={err:.3e} (ratio to max|plain| {ratio:.3e}"
            f"{mean_note}); "
            f"device ({timed_by}) {dev_ms:.5f} ms, plain {dev_plain:.5f} ms, library {lib}, "
            f"bound {bound_ms:.5f} ms ({bound_by}); host-clocked {ev_ms:.4f} ms vs plain "
            f"{ev_plain:.4f} ms{note}")
        if not ratio <= c.tol:
            raise AssertionError(f"{c.name} {c.label} disagrees: ratio {ratio} > {c.tol}")
        if mean is not None and not mean <= c.mean_tol:
            raise AssertionError(
                f"{c.name} {c.label} disagrees: mean ratio {mean} > {c.mean_tol}")
        row = out.setdefault(c.name, dict(max_abs_err=0.0))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if c.label.startswith(MAIN_SHAPE[c.name]):
            row.update(ms=dev_ms, plain_ms=dev_plain, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=bound_by, timed_by=timed_by)
    return out


def synthetic_vqa(n: int, offset: int, seed: int, sizes=((224, 224),)):
    """In-memory VQA rows with uint8 images of the (width, height) ``sizes``,
    cycled."""
    import numpy as np

    rng = np.random.default_rng(seed)
    answers = ["red", "blue", "two", "cat", "yes", "no"]
    rows = []
    for i in range(n):
        ans = answers[i % len(answers)]
        w, h = sizes[i % len(sizes)]
        rows.append({
            "question_id": offset + i,
            "image_id": offset + 1000 + i,
            "image": rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8),
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
    # CHECKPOINT_PATH: where OpenFlamingo's config looks for the flamingo deltas
    for key in ("RESULT_DIR", "MODEL_CPK_DIR", "VQAV2_PATH", "COCO_PATH", "OKVQA_PATH",
                "CHECKPOINT_PATH"):
        os.environ[key] = str(tmp / key.lower())


def route_icv(kernels: bool) -> None:
    """Point the decoder's injection at the kernels (``icv_inject`` and the
    entries with the residual add folded in) or at their plain versions."""
    import importlib

    from licv_vqa_tpu_torch.models import decoder as Dm

    iv = importlib.import_module("licv_vqa_tpu_torch.ops.icv_inject")
    Dm.icv_inject = iv.icv_inject if kernels else iv.icv_inject_reference
    Dm.icv_inject_after_add = (iv.icv_inject_after_add if kernels
                               else iv.icv_inject_after_add_reference)
    Dm.add_icv_inject = iv.add_icv_inject if kernels else iv.add_icv_inject_reference


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@dataclasses.dataclass
class EvalSetup:
    """A full-width model and the eval inputs phases 4 and 6 share."""

    bundle: object
    gen_kwargs: dict
    instruction: str
    pm: object
    icv_scaled: object
    val: list
    train: list
    shots: list


def eval_setup(dev, tmp: Path, extra_args: list, lmm: str = "idefics-9B") -> EvalSetup:
    """The CLI's composed config with ``extra_args``, the model the registry
    builds from it (random weights), a random ICV read back from an
    ``icv_cpk.pth`` in the reference layout, and the synthetic rows."""
    import torch

    from licv_vqa_tpu_torch.api import init_prompt_manager
    from licv_vqa_tpu_torch.models.registry import build_model
    from licv_vqa_tpu_torch.train.checkpoint import load_icv_checkpoint
    from licv_vqa_tpu_torch.utils import compose

    set_env(tmp)
    cfg = compose(str(REPO / "config"), "inference", [
        f"lmm={lmm}", f"device={dev.type}", "run_name=chip_smoke", "bs=1",
        f"generate_kwargs.max_new_tokens={MAX_NEW}", "generate_kwargs.num_beams=3",
        "generate_kwargs.length_penalty=0.0", *extra_args,
    ])
    t0 = time.perf_counter()
    bundle = build_model(cfg, device=dev)  # no weights on disk: random init
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(bundle.params))
    n_bytes = sum(x.numel() * x.element_size() for x in _leaves(bundle.params))
    log(f"model: {lmm} {' '.join(extra_args) or 'bf16'}: "
        f"{n_params / 1e9:.3f} B stored elements, {n_bytes / 2**30:.2f} GiB, "
        f"built in {time.perf_counter() - t0:.1f} s")
    t = bundle.model_cfg.text
    full = {"idefics-9B": (32, 4096, 1280, 32), "idefics2-8B-base": (32, 4096, 1152, 27),
            "openflamingov2-9B": (32, 4096, 1024, 24)}
    v = bundle.model_cfg.vision
    if lmm in full and (t.n_layers, t.d_model, v.d_model, v.n_layers) != full[lmm]:
        raise AssertionError(f"not full width: {t} {v}")

    # a random ICV written in the reference artifact layout, read back by the port
    g = torch.Generator().manual_seed(0)
    cpk = tmp / "icv_cpk" / "icv_cpk.pth"
    cpk.parent.mkdir(parents=True)
    torch.save({
        "icv_encoder.icv": torch.randn((1, t.n_layers, t.d_model), generator=g) * 0.05,
        "icv_encoder.alpha": torch.full((1, t.n_layers), 0.5),
        "use_sigmoid": False,
        "lmm_args": {"total_layers": t.n_layers, "intervention_layer": -1,
                     "layer_format": str(cfg.lmm.layer_format)},
    }, cpk)
    loaded = load_icv_checkpoint(cpk.parent, device=dev)
    return EvalSetup(
        bundle=bundle, gen_kwargs=cfg.generate_kwargs.to_dict(),
        instruction=str(cfg.prompt.instruction), pm=init_prompt_manager(cfg),
        icv_scaled=loaded["alpha"][:, None] * loaded["icv"],
        val=synthetic_vqa(N_ICV_Q + 1, 100, seed=1),
        train=synthetic_vqa(ICL_SHOTS + 8, 500, seed=2),
        shots=[list(range(i, i + ICL_SHOTS)) for i in range(N_ICL_Q + 1)],
    )


def icl_prompt(e: EvalSetup, q: int, shots: list) -> list:
    p = [e.instruction]
    for si in shots:
        p += [e.train[si]["image"], e.pm.gen_ice_text_with_label(e.train[si], add_sep_token=True)]
    return p + [e.val[q]["image"], e.pm.gen_query_text_without_label(e.val[q])]


def icv_prompt(e: EvalSetup, q: int) -> list:
    """The zero-shot prompt as ``icv_inference`` builds it."""
    p = [e.instruction] if e.instruction else []
    return p + [e.val[q]["image"], e.pm.gen_query_text_without_label(e.val[q])]


def vit_per_bind(vc, dev) -> int:
    """Fused ViT kernel launches in one bind of a CLIP tower (one call per
    layer over all the bind's images) where ``layers.vit_attention_usable``
    holds for its sequence, else 0."""
    from licv_vqa_tpu_torch.models import layers as L

    return vc.n_layers * L.vit_attention_usable(vc.n_patches, vc.d_model // vc.n_heads, dev)


def eval_runs(e: EvalSetup) -> dict:
    """path -> (run(rows[, shots]) through the runner entry point, the
    prompt of question q, the number of questions timed)."""
    from licv_vqa_tpu_torch.infer.runner import icl_inference, icv_inference

    b = e.bundle
    return {
        "icv": (lambda rows: icv_inference(rows, b, e.pm, 1, e.gen_kwargs, e.instruction,
                                           e.icv_scaled, progress=False),
                lambda q: icv_prompt(e, q), N_ICV_Q),
        "icl": (lambda rows, shots=None: icl_inference(
                    e.train, rows, shots, b, e.pm, 1, e.gen_kwargs, e.instruction, progress=False),
                lambda q: icl_prompt(e, q, e.shots[q]), N_ICL_Q),
    }


def main_path(dev, tmp: Path) -> dict:
    """Phase 4.  Returns the launch counts of the eval path."""
    import torch

    from licv_vqa_tpu_torch.data.processor import CLIP_MEAN, CLIP_STD
    from licv_vqa_tpu_torch.infer.runner import icl_inference, icv_inference
    from licv_vqa_tpu_torch.models import idefics as I
    from licv_vqa_tpu_torch.models import layers as L
    from licv_vqa_tpu_torch.models.registry import _wrap_pixel_normalize
    from licv_vqa_tpu_torch.ops.icv_inject import icv_inject

    e = eval_setup(dev, tmp, [])
    bundle, gen_kwargs, instruction, pm = e.bundle, e.gen_kwargs, e.instruction, e.pm
    icv_scaled, val, train, shots = e.icv_scaled, e.val, e.train, e.shots
    t = bundle.model_cfg.text

    # ICL prompt length (the flash gate needs >= 256 tokens)
    enc = bundle.processor.prepare_input(
        [icl_prompt(e, 0, shots[0])], padding=True, padding_side="left")
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
    vit_bind = vit_per_bind(bundle.model_cfg.vision, dev)
    icv_inject.launches = 0
    L.flash_attention.launches = 0
    L.vit_attention.launches = 0
    t0 = time.perf_counter()
    res_icv = icv_inference(
        val[1:], bundle, pm, 1, gen_kwargs, instruction, icv_scaled, progress=False
    )
    torch.cuda.synchronize()
    dt_icv = (time.perf_counter() - t0) / N_ICV_Q
    counts["icv_inject", "test_icv"] = icv_inject.launches
    counts["flash", "test_icv"] = L.flash_attention.launches
    counts["vit", "test_icv"] = L.vit_attention.launches

    icv_inject.launches = 0
    L.flash_attention.launches = 0
    L.vit_attention.launches = 0
    t0 = time.perf_counter()
    res_icl = icl_inference(
        train, val[1 : 1 + N_ICL_Q], shots[1:], bundle, pm, 1, gen_kwargs, instruction,
        progress=False,
    )
    torch.cuda.synchronize()
    dt_icl = (time.perf_counter() - t0) / N_ICL_Q
    counts["icv_inject", "test_icl"] = icv_inject.launches
    counts["flash", "test_icl"] = L.flash_attention.launches
    counts["vit", "test_icl"] = L.vit_attention.launches
    peak = torch.cuda.max_memory_allocated(dev) / 2**30

    forwards = N_ICV_Q * MAX_NEW  # bs=1: one prefill + (max_new - 1) beam steps each
    log(f"test_icv: {N_ICV_Q} questions, {dt_icv * 1e3:.1f} ms/question; "
        f"icv_inject launches {counts['icv_inject', 'test_icv']} "
        f"(want 32 x {forwards} forwards = {32 * forwards}), "
        f"flash launches {counts['flash', 'test_icv']}, vit_attention launches "
        f"{counts['vit', 'test_icv']} (want {vit_bind} x {N_ICV_Q} binds)")
    log(f"test_icl ({ICL_SHOTS}-shot): {N_ICL_Q} questions, {dt_icl * 1e3:.1f} ms/question; "
        f"flash launches {counts['flash', 'test_icl']} (want 32 x {N_ICL_Q}), "
        f"icv_inject launches {counts['icv_inject', 'test_icl']}, vit_attention launches "
        f"{counts['vit', 'test_icl']} (want {vit_bind} x {N_ICL_Q} binds)")
    log(f"peak device memory over both: {peak:.2f} GiB")
    if counts["icv_inject", "test_icv"] != 32 * forwards:
        raise AssertionError("icv_inject launch count != 32 x forward passes")
    if counts["flash", "test_icl"] != 32 * N_ICL_Q:
        raise AssertionError("flash launch count != 32 x ICL prefills")
    for path, n_q in (("test_icv", N_ICV_Q), ("test_icl", N_ICL_Q)):
        if counts["vit", path] != vit_bind * n_q:
            raise AssertionError(f"{path}: vit_attention launch count != layers x binds")

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
        if impl == "xla":  # the tower's plain attention too
            os.environ["LICV_VIT_FUSED_ATTN"] = "0"
        try:
            with torch.inference_mode():
                fwd = bind(bundle.params, px, pv, ids, None, s_icl + 1)
                logits[impl] = fwd(ids, mask, pos, None)[0][:, -1].float()
        finally:
            os.environ.pop("LICV_VIT_FUSED_ATTN", None)
    a, b = logits["flash"], logits["xla"]
    diff = (a - b).abs().max().item()
    rel = ((a - b).norm() / b.norm()).item()
    log(f"full-width ICL prefill logits (32 bf16 layers), flash and ViT kernels vs plain "
        f"attention: max_abs={diff:.4e}, rel_l2={rel:.4e} (max |logit| "
        f"{b.abs().max().item():.4e}), argmax "
        f"{'agrees' if a.argmax().item() == b.argmax().item() else 'differs'}")
    if not (torch.isfinite(a).all() and rel <= REL_L2_TOL):
        raise AssertionError("flash path logits disagree with the plain path")
    return {
        "icv_inject": counts["icv_inject", "test_icv"] + counts["icv_inject", "test_icl"],
        "flash_attention_fwd": counts["flash", "test_icv"] + counts["flash", "test_icl"],
        "vit_attention": counts["vit", "test_icv"] + counts["vit", "test_icl"],
    }


# phase 6's two runs: (mode, the lmm options, the eval paths run)
QUANT_RUNS = (
    # A: every quantized option composed (tests/test_quantize.py:110-129)
    ("int8", ["lmm.quantize=int8", "lmm.quantize_head=true", "lmm.kv_cache=int8",
              "lmm.w8a8_prefill=true", "lmm.quantize_vision=true"], ("icv", "icl")),
    # B: the head left bf16, so this run launches only the int4 kernel
    ("int4", ["lmm.quantize=int4"], ("icv",)),
)


def predicted_quantized_launches(mc, mode: str, opts: list, bs: int, s_prompt: int,
                                 n_img: int, beams: int, max_new: int) -> dict:
    """Launches of the int8, w8a8 and int4 kernels in ONE generate (bs
    prompts of ``s_prompt`` tokens with ``n_img`` images each), derived
    from the code's routes.  A matmul launches the int8 or int4 kernel iff
    its weight is quantized and the call has at most ``KERNEL_MAX_ROWS``
    rows (``ops/int8_matmul.py::qdot``), except that an int8 weight takes
    w8a8 (the w8a8 kernel, at any row count) under ``lmm.w8a8_prefill`` in
    a block of at least ``W8A8_MIN_TOKENS`` tokens (the vision tower never:
    ``idefics.encode_images``; the head never), and an int4 weight needs
    K/2 % G == 0.
    Per forward: 7 projections per decoder layer (wq wk wv wo, gate up:
    K = d_model; down: K = d_ff) and 5 per cross-attention block with its
    bound K/V (wq wo gate up, down), one block per ``cross_layer_interval``
    layers.  The prefill has bs·s_prompt rows and s_prompt tokens; each of
    the max_new − 1 beam steps has bs·beams rows and 1 token (the last
    token needs no forward).  The bind-time K/V (wk wv per block) has
    bs·n_img·n_latents rows and n_img·n_latents tokens.  The int8 head
    (``quantize_head``, int8 in either mode) has bs rows at the prefill (its
    last position) and bs·beams per step.  The int8 tower
    (``quantize_vision``) runs 6 projections per layer on bs·n_img·n_patches
    rows; the perceiver 4 per block on its latents (bs·n_img·n_latents rows,
    n_latents tokens) and 2 on latents and patches together."""
    from licv_vqa_tpu_torch.models.decoder import W8A8_MIN_TOKENS
    from licv_vqa_tpu_torch.ops.int8_matmul import KERNEL_MAX_ROWS
    from licv_vqa_tpu_torch.ops.quantize import _int4_group

    a8 = "lmm.w8a8_prefill=true" in opts

    def w8a8(tokens, int8: bool) -> int:
        """1 if one matmul in a block of ``tokens`` tokens (None: never
        w8a8) takes w8a8."""
        return int(int8 and a8 and tokens is not None and tokens >= W8A8_MIN_TOKENS)

    def takes(rows: int, tokens, k: int, int8: bool) -> int:
        """1 if one matmul of ``rows`` rows, a block of ``tokens`` tokens
        (None: never w8a8) and ``k`` in-features launches the int8 or int4
        kernel."""
        if rows > KERNEL_MAX_ROWS or w8a8(tokens, int8):
            return 0
        if int8:
            return 1
        return int((k // 2) % _int4_group(k) == 0)

    t, v, p = mc.text, mc.vision, mc.perceiver
    groups = t.n_layers // mc.cross_layer_interval
    int8 = mode == "int8"

    def stacks(rows: int, tokens: int) -> int:
        d, f = (takes(rows, tokens, k, int8) for k in (t.d_model, t.d_ff))
        return t.n_layers * (6 * d + f) + groups * (4 * d + f)

    n_k = n_img * p.n_latents
    n = (stacks(bs * s_prompt, s_prompt) + (max_new - 1) * stacks(bs * beams, 1)
         + 2 * groups * takes(bs * n_k, n_k, p.d_model, int8))
    per_stack = t.n_layers * 7 + groups * 5
    out = {"int8_matmul": n if int8 else 0, "int4_matmul": 0 if int8 else n,
           "w8a8_matmul": (per_stack * (w8a8(s_prompt, int8) + (max_new - 1) * w8a8(1, int8))
                           + 2 * groups * w8a8(n_k, int8))}
    if "lmm.quantize_head=true" in opts:
        out["int8_matmul"] += (takes(bs, 1, t.d_model, True)
                               + (max_new - 1) * takes(bs * beams, 1, t.d_model, True))
    if "lmm.quantize_vision=true" in opts:
        imgs, lat, np_ = bs * n_img, p.n_latents, v.n_patches
        out["int8_matmul"] += (
            v.n_layers * 6 * takes(imgs * np_, None, v.d_model, True)
            + p.n_layers * (4 * takes(imgs * lat, lat, p.d_model, True)
                            + 2 * takes(imgs * (lat + np_), lat + np_, p.d_model, True))
        )
        out["w8a8_matmul"] += p.n_layers * (4 * w8a8(lat, True) + 2 * w8a8(lat + np_, True))
    return out


def quantized_path(dev, tmp: Path, mode: str, opts: list, paths: tuple,
                   lmm: str = "idefics-9B") -> dict:
    """Phase 6, one run: the weight-quantized eval at full width through the
    runner entry points.  Returns the launch counts of the run."""
    import torch

    from licv_vqa_tpu_torch.models import layers as L
    from licv_vqa_tpu_torch.ops import int4_matmul as I4
    from licv_vqa_tpu_torch.ops import int8_matmul as I8
    from licv_vqa_tpu_torch.ops.icv_inject import icv_inject

    e = eval_setup(dev, tmp, opts, lmm)
    b = e.bundle
    n_layers = b.model_cfg.text.n_layers
    counters = {"int8_matmul": I8.int8_matmul, "int4_matmul": I4.int4_matmul,
                "w8a8_matmul": I8.w8a8_matmul, "icv_inject": icv_inject,
                "flash_attention_fwd": L.flash_attention, "vit_attention": L.vit_attention}
    vit_bind = vit_per_bind(b.model_cfg.vision, b.device)
    beams = int(e.gen_kwargs["num_beams"])
    runs = eval_runs(e)
    # warm-up on one question of each path
    runs["icv"][0](e.val[:1])
    if "icl" in paths:
        runs["icl"][0](e.val[:1], e.shots[:1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    total = dict.fromkeys(counters, 0)
    for path in paths:
        run, prompt, n_q = runs[path]
        want = dict.fromkeys(("int8_matmul", "int4_matmul", "w8a8_matmul"), 0)
        for q in range(1, 1 + n_q):
            enc = b.processor.prepare_input([prompt(q)], padding=True, padding_side="left")
            for k, v in predicted_quantized_launches(
                b.model_cfg, mode, opts, 1, enc["input_ids"].shape[1],
                enc["pixel_values"].shape[1], beams, MAX_NEW,
            ).items():
                want[k] += v
        for fn in counters.values():
            fn.launches = 0
        int_mm = torch._int_mm
        int_mm_calls = []

        def counted_int_mm(*a, **k):
            int_mm_calls.append(1)
            return int_mm(*a, **k)

        torch._int_mm = counted_int_mm  # w8a8 takes the kernel: no library call
        try:
            t0 = time.perf_counter()
            rows = e.val[1 : 1 + n_q]
            res = run(rows) if path == "icv" else run(rows, e.shots[1 : 1 + n_q])
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / n_q
        finally:
            torch._int_mm = int_mm
        counts = {k: fn.launches for k, fn in counters.items()}
        log(f"{mode} test_{path}: {n_q} questions, {dt * 1e3:.1f} ms/question; launches "
            f"{counts} (int8/int4/w8a8 predicted {want}), torch._int_mm calls "
            f"{len(int_mm_calls)}; predictions "
            f"{[r['prediction'] for r in res.values()]}, VQA accuracy "
            f"{vqa_accuracy(res, rows, tmp, f'{mode}_{path}'):.2f} (random weights)")
        for k, v in want.items():
            if counts[k] != v:
                raise AssertionError(f"{mode} test_{path}: {k} launched {counts[k]} != {v}")
        if int_mm_calls:
            raise AssertionError(f"{mode} test_{path}: torch._int_mm called on the main path")
        if path == "icv" and counts["icv_inject"] != n_layers * n_q * MAX_NEW:
            raise AssertionError("icv_inject launch count != 32 x forward passes")
        if counts["vit_attention"] != vit_bind * n_q:  # one bind a question
            raise AssertionError(f"{mode} test_{path}: vit_attention launched "
                                 f"{counts['vit_attention']} != {vit_bind} x {n_q}")
        if len(res) != n_q or not all(isinstance(r["prediction"], str) for r in res.values()):
            raise AssertionError(f"{mode} test_{path}: malformed results {res}")
        for k in total:
            total[k] += counts[k]
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"{mode}: peak device memory over the runs {peak:.2f} GiB (the bf16 build's is phase 4's)")
    if dev.type == "cuda":
        profile_question(lambda: runs["icv"][0](e.val[1:2]), f"{mode} test_icv")
    kernel_vs_plain_logits(e, mode)
    return total


def profile_question(fn, tag: str, top: int = 6, what: str = "one question") -> None:
    """One warm call of ``fn`` (``what``: a question, a train step) under
    ``torch.profiler``: its wall, the device's busy share of it and the
    device time by kernel."""
    wall, events = device_events(fn, always=True)
    if events is None:
        log(f"{tag}, {what}: {wall:.1f} ms wall; device busy share and device time "
            "by kernel not measured (torch.profiler recorded no device activity)")
        return
    busy = busy_ms(events)
    total = sum(e.time_range.end - e.time_range.start for e in events) / 1e3
    log(f"{tag}, {what} profiled: {wall:.1f} ms wall, {len(events)} device kernels, "
        f"device busy {busy:.1f} ms ({100 * busy / wall:.1f}% of the wall)")
    by_name: dict = {}
    for e in events:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  {ms:9.3f}  {100 * ms / total:5.1f}%  {n:6d}  {name[:90]}")


def kernel_vs_plain_logits(e: EvalSetup, mode: str) -> None:
    """The test_icv prompt's prefill logits and one greedy step's, through
    the quantized kernels against the same weights through the kernels'
    plain versions (the wrappers swapped for them in ``qdot``)."""
    import torch

    from licv_vqa_tpu_torch.ops import int4_matmul as I4
    from licv_vqa_tpu_torch.ops import int8_matmul as I8

    b = e.bundle
    dev = b.device
    enc = b.processor.prepare_input([icv_prompt(e, 1)], padding=True, padding_side="left")
    ids, mask, px, pv = (torch.from_numpy(enc[k]).to(dev) for k in (
        "input_ids", "attention_mask", "pixel_values", "pixel_valid"))
    pos = torch.clamp(torch.cumsum(mask, -1) - 1, min=0)
    out = {}
    kernels = (I8.int8_matmul, I4.int4_matmul, I8.w8a8_matmul)
    for path in ("kernel", "plain"):
        if path == "plain":
            I8.int8_matmul, I4.int4_matmul, I8.w8a8_matmul = (
                I8.int8_matmul_reference, I4.int4_matmul_reference, I8.w8a8_matmul_reference)
        try:
            with torch.inference_mode():
                fwd = b.bind_decode(b.params, px, pv, ids, e.icv_scaled, ids.shape[1] + 2)
                pre, cache = fwd(ids, mask, pos, None)
                tok = pre[:, -1].argmax(-1)[:, None].to(ids.dtype)
                step, _ = fwd(tok, torch.ones_like(tok), pos[:, -1:] + 1, cache)
            out[path] = (pre[:, -1].float(), step[:, -1].float())
        finally:
            I8.int8_matmul, I4.int4_matmul, I8.w8a8_matmul = kernels
    for i, what in enumerate(("prefill", "step")):
        a, p = out["kernel"][i], out["plain"][i]
        rel = ((a - p).norm() / p.norm()).item()
        same = a.argmax().item() == p.argmax().item()
        log(f"{mode} full-width {what} logits, kernel path vs plain path (same quantized "
            f"weights): max_abs={(a - p).abs().max().item():.4e}, rel_l2={rel:.4e}, argmax "
            f"{'agrees' if same else 'differs'}")
        if not (torch.isfinite(a).all() and rel <= REL_L2_TOL and same):
            raise AssertionError(f"{mode} {what} logits: kernel path disagrees with plain path")


# phase 7: COCO's common (width, height): the test_icv query is 640x480,
# the 32 shots of test_icl cycle all three; the kernel-vs-plain logits use
# an 8-shot prompt (the plain tower's scores fit there)
COCO_SIZES = ((640, 480), (640, 427), (500, 375))
IDEFICS2_CHECK_SHOTS = 8


def predicted_idefics2_launches(mc, s_prompt: int, n_patches: int, with_icv: bool,
                                dev) -> dict:
    """Launches in ONE bs=1 question (one bind, a prefill of ``s_prompt``
    tokens, MAX_NEW - 1 beam steps): the tower's flash kernel at every
    vision layer when ``layers.flash_bidir_usable`` holds for the bind's
    ``n_patches`` (always at full width: every NaViT image is at least
    1024 patches); the causal flash kernel at every decoder layer of the
    prefill when ``layers.flash_attention_usable`` holds (>= 256 tokens:
    test_icl's prompt, not test_icv's); the ICV injection at every decoder
    layer of every forward when the ICV is on."""
    from licv_vqa_tpu_torch.models import layers as L

    t, v = mc.text, mc.vision
    bidir = L.flash_bidir_usable(n_patches, dev)
    return {
        "flash_attention_bidir": v.n_layers * bidir,
        # the fused short-sequence kernel takes the tower only under 1024
        # patches, which no NaViT image at full width has
        "vit_attention": v.n_layers * (not bidir) * L.vit_attention_usable(
            n_patches, v.d_model // v.n_heads, dev),
        "flash_attention_fwd": t.n_layers * L.flash_attention_usable(
            t, s_prompt, t.head_dim, dev),
        "icv_inject": t.n_layers * MAX_NEW if with_icv else 0,
    }


def idefics2_path(dev, tmp: Path, lmm: str = "idefics2-8B-base") -> dict:
    """Phase 7: the Idefics2 eval at full width through the runner entry
    points, test_icv then test_icl.  Returns the launch counts of the run."""
    import torch

    from licv_vqa_tpu_torch.models import layers as L
    from licv_vqa_tpu_torch.ops.icv_inject import icv_inject

    e = eval_setup(dev, tmp, [], lmm)
    e.val = synthetic_vqa(N_ICV_Q + 1, 100, seed=1, sizes=COCO_SIZES[:1])
    e.train = synthetic_vqa(ICL_SHOTS + 8, 500, seed=2, sizes=COCO_SIZES)
    b = e.bundle
    fmt = torch.load(tmp / "icv_cpk" / "icv_cpk.pth", weights_only=False)["lmm_args"]
    if not fmt["layer_format"].endswith(".mlp"):
        raise AssertionError(f"icv_cpk.pth layer_format {fmt['layer_format']}: not the MLP site")
    counters = {"flash_attention_bidir": L.flash_attention_bidir,
                "vit_attention": L.vit_attention,
                "flash_attention_fwd": L.flash_attention, "icv_inject": icv_inject}
    runs = eval_runs(e)
    runs["icv"][0](e.val[:1])  # warm-up (Triton specialisations, libraries, allocator)
    runs["icl"][0](e.val[:1], e.shots[:1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    total = dict.fromkeys(counters, 0)
    patch = b.model_cfg.vision.patch_size
    for path in ("icv", "icl"):
        run, prompt, n_q = runs[path]
        want = dict.fromkeys(counters, 0)
        for q in range(1, 1 + n_q):
            enc = b.processor.prepare_input([prompt(q)], padding=True, padding_side="left")
            hh, ww = enc["pixel_values"].shape[2:4]
            for k, v in predicted_idefics2_launches(
                b.model_cfg, enc["input_ids"].shape[1], (hh // patch) * (ww // patch),
                path == "icv", dev,
            ).items():
                want[k] += v
            if q == 1:
                log(f"idefics2 test_{path} prompt: {int(enc['attention_mask'].sum())} tokens, "
                    f"padded to {enc['input_ids'].shape[1]}, {enc['pixel_values'].shape[1]} "
                    f"images padded to {ww}x{hh} ({(hh // patch) * (ww // patch)} patches), "
                    f"{int(enc['pixel_attention_mask'].sum()) if 'pixel_attention_mask' in enc else 'all'} "
                    "real pixels")
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        rows = e.val[1 : 1 + n_q]
        res = run(rows) if path == "icv" else run(rows, e.shots[1 : 1 + n_q])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / n_q
        counts = {k: fn.launches for k, fn in counters.items()}
        log(f"idefics2 test_{path}: {n_q} questions, {dt * 1e3:.1f} ms/question; launches "
            f"{counts} (predicted {want}); predictions {[r['prediction'] for r in res.values()]}, "
            f"VQA accuracy {vqa_accuracy(res, rows, tmp, f'idefics2_{path}'):.2f} (random weights)")
        if counts != want:
            raise AssertionError(f"idefics2 test_{path}: launches {counts} != {want}")
        if len(res) != n_q or not all(isinstance(r["prediction"], str) for r in res.values()):
            raise AssertionError(f"idefics2 test_{path}: malformed results {res}")
        for k in total:
            total[k] += counts[k]
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"idefics2: peak device memory over both paths {peak:.2f} GiB")
    if dev.type == "cuda":
        profile_question(lambda: runs["icv"][0](e.val[1:2]), "idefics2 test_icv")
        profile_question(lambda: runs["icl"][0](e.val[1:2], e.shots[1:2]),
                         f"idefics2 test_icl ({ICL_SHOTS}-shot)")
    from licv_vqa_tpu_torch.data.processor import SIGLIP_MEAN, SIGLIP_STD
    from licv_vqa_tpu_torch.models.idefics2 import make_idefics2_forward_fns

    kernel_vs_plain_f32_logits(
        e, "idefics2", make_idefics2_forward_fns, SIGLIP_MEAN, SIGLIP_STD,
        (("test_icv", icv_prompt(e, 1), e.icv_scaled),
         (f"{IDEFICS2_CHECK_SHOTS}-shot ICL",
          icl_prompt(e, 1, e.shots[1][:IDEFICS2_CHECK_SHOTS]), None)),
    )
    return total


def plain_config(mc, f32: bool = False):
    """``mc`` with the decoder's plain attention (``attention_impl=xla``),
    and with every tower in f32 where ``f32``."""
    import torch

    text = dataclasses.replace(mc.text, attention_impl="xla")
    if not f32:
        return dataclasses.replace(mc, text=text)
    return dataclasses.replace(
        mc, text=dataclasses.replace(text, dtype=torch.float32),
        vision=dataclasses.replace(mc.vision, dtype=torch.float32),
        perceiver=dataclasses.replace(mc.perceiver, dtype=torch.float32),
    )


def f32_tree(tree):
    """The floating leaves of a param tree in f32 (int8 planes stay)."""
    if isinstance(tree, dict):
        return {k: f32_tree(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


def kernel_vs_plain_f32_logits(e: EvalSetup, tag_prefix: str, make_fns, mean, std,
                               checks) -> None:
    """For each ``(tag, prompt, icv)`` of ``checks``: the prompt's prefill
    logits through the kernels (the towers' and the decoder's attention
    kernels, the ICV injection) against the same weights through their
    plain versions (``LICV_VIT_FLASH=0``, ``LICV_VIT_FUSED_ATTN=0``,
    ``attention_impl=xla``, the plain injection), and both against the
    plain path with the weights in f32.  ``make_fns`` is the family's
    ``make_*_forward_fns``, ``mean``/``std`` its pixel normalisation.

    At random init two bf16 paths differ by rounding amplified through the
    tower and the decoder (rel. L2 5e-2 to 8e-2 for Idefics2, each path
    alike from the f32 one), and the top two logits can lie closer than
    that, so the argmax alone can flip on a sound kernel (PERF.md,
    Findings).  The checks: kernel vs plain within ``REL_L2_TOL``; the
    kernel path no farther from the f32 path than ``F32_DRIFT_RATIO`` times
    the plain path is; the same argmax, or, where the two bf16 paths pick
    different tokens, tokens whose f32 logits lie within the kernel-vs-plain
    max-abs difference (a tie at bf16's resolution)."""
    import torch

    from licv_vqa_tpu_torch.models.registry import _wrap_pixel_normalize

    b = e.bundle
    mc = b.model_cfg

    def plain_bind(cfg):
        return _wrap_pixel_normalize(*make_fns(cfg, b.eos_token_id), mean, std)[1]

    paths = (("kernel", b.bind_decode, b.params),
             ("plain", plain_bind(plain_config(mc)), b.params),
             ("f32", plain_bind(plain_config(mc, f32=True)), f32_tree(b.params)))
    for tag, prompt, icv in checks:
        enc = b.processor.prepare_input([prompt], padding=True, padding_side="left")
        ids, mask, px, pv = (torch.from_numpy(enc[k]).to(b.device) for k in (
            "input_ids", "attention_mask", "pixel_values", "pixel_valid"))
        kw = {k: torch.from_numpy(enc[k]).to(b.device) for k in ("pixel_attention_mask",)
              if k in enc}  # NaViT at full width; the tiny configs keep squares
        pos = torch.clamp(torch.cumsum(mask, -1) - 1, min=0)
        out = {}
        for path, bind, params in paths:
            if path != "kernel":
                os.environ["LICV_VIT_FLASH"] = os.environ["LICV_VIT_FUSED_ATTN"] = "0"
                route_icv(kernels=False)
            try:
                with torch.inference_mode():
                    fwd = bind(params, px, pv, ids, icv, ids.shape[1] + 1, **kw)
                    out[path] = fwd(ids, mask, pos, None)[0][:, -1].float()
            finally:
                os.environ.pop("LICV_VIT_FLASH", None)
                os.environ.pop("LICV_VIT_FUSED_ATTN", None)
                route_icv(kernels=True)
            free_device_memory()
        a, p, g = out["kernel"], out["plain"], out["f32"]

        def rel(x, y):
            return ((x - y).norm() / y.norm()).item()

        diff = (a - p).abs().max().item()
        ta, tp = a.argmax().item(), p.argmax().item()
        tie = abs((g[0, ta] - g[0, tp]).item())
        top2 = g[0].topk(2).values
        log(f"{tag_prefix} full-width {tag} prefill logits ({ids.shape[1]} tokens, "
            f"{px.shape[1]} images): kernel vs plain max_abs={diff:.4e}, rel_l2={rel(a, p):.4e}; "
            f"rel_l2 to the f32 path: kernel {rel(a, g):.4e}, plain {rel(p, g):.4e}; argmax "
            f"kernel {ta}, plain {tp}, f32 {g.argmax().item()} (f32 top-2 gap "
            f"{(top2[0] - top2[1]).item():.4e}; f32 gap between the two picks {tie:.4e})")
        ok = (torch.isfinite(a).all() and rel(a, p) <= REL_L2_TOL
              and rel(a, g) <= F32_DRIFT_RATIO * rel(p, g) and (ta == tp or tie <= diff))
        if not ok:
            raise AssertionError(f"{tag_prefix} {tag} logits: kernel path disagrees with plain path")
    del paths
    free_device_memory()


def predicted_openflamingo_launches(mc, s_prompt: int, with_icv: bool, dev) -> dict:
    """Launches in ONE bs=1 question (one bind, a prefill of ``s_prompt``
    tokens, MAX_NEW - 1 beam steps): the fused ViT kernel at every tower
    layer when ``layers.vit_attention_usable`` holds for the tower's 257
    tokens (on the card, always); the ALiBi flash kernel at every decoder
    layer of the prefill when ``flash_alibi.flash_alibi_usable`` holds (>=
    128 tokens: test_icl's prompt, not test_icv's); the ICV injection at
    every decoder layer of every forward when the ICV is on; the rope flash
    kernel never (MPT has no rope)."""
    from licv_vqa_tpu_torch.ops import flash_alibi as FA

    t = mc.text
    return {
        "vit_attention": vit_per_bind(mc.vision, dev),
        "flash_alibi_attention": t.n_layers * FA.flash_alibi_usable(
            t, s_prompt, t.head_dim, dev),
        "flash_attention_fwd": 0,
        "icv_inject": t.n_layers * MAX_NEW if with_icv else 0,
    }


def openflamingo_path(dev, tmp: Path, lmm: str = "openflamingov2-9B") -> dict:
    """Phase 8: the OpenFlamingo-9B eval at full width through the runner
    entry points, test_icv then test_icl.  Returns the launch counts of the
    run."""
    import torch

    from licv_vqa_tpu_torch.data.processor import CLIP_MEAN, CLIP_STD
    from licv_vqa_tpu_torch.models import layers as L
    from licv_vqa_tpu_torch.models.openflamingo import make_openflamingo_forward_fns
    from licv_vqa_tpu_torch.ops import flash_alibi as FA
    from licv_vqa_tpu_torch.ops.icv_inject import icv_inject

    e = eval_setup(dev, tmp, [], lmm)
    b = e.bundle
    fmt = torch.load(tmp / "icv_cpk" / "icv_cpk.pth", weights_only=False)["lmm_args"]
    if ".transformer.blocks." not in fmt["layer_format"]:
        raise AssertionError(f"icv_cpk.pth layer_format {fmt['layer_format']}: not the MPT block")
    counters = {"vit_attention": L.vit_attention, "flash_alibi_attention": FA.flash_alibi_attention,
                "flash_attention_fwd": L.flash_attention, "icv_inject": icv_inject}
    runs = eval_runs(e)
    enc = b.processor.prepare_input([icl_prompt(e, 1, e.shots[1])], padding=True,
                                    padding_side="left")
    s_icl = enc["input_ids"].shape[1]
    log(f"openflamingo test_icl prompt: {int(enc['attention_mask'].sum())} tokens, padded to "
        f"{s_icl}, {enc['pixel_values'].shape[1]} images")
    if s_icl < 128:
        raise AssertionError(f"{ICL_SHOTS}-shot prompt {s_icl} < 128: the ALiBi flash gate "
                             "is not reached")
    runs["icv"][0](e.val[:1])  # warm-up (Triton specialisations, libraries, allocator)
    runs["icl"][0](e.val[:1], e.shots[:1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    total = dict.fromkeys(counters, 0)
    for path in ("icv", "icl"):
        run, prompt, n_q = runs[path]
        want = dict.fromkeys(counters, 0)
        for q in range(1, 1 + n_q):
            enc = b.processor.prepare_input([prompt(q)], padding=True, padding_side="left")
            for k, v in predicted_openflamingo_launches(
                b.model_cfg, enc["input_ids"].shape[1], path == "icv", dev,
            ).items():
                want[k] += v
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        rows = e.val[1 : 1 + n_q]
        res = run(rows) if path == "icv" else run(rows, e.shots[1 : 1 + n_q])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / n_q
        counts = {k: fn.launches for k, fn in counters.items()}
        log(f"openflamingo test_{path}: {n_q} questions, {dt * 1e3:.1f} ms/question; launches "
            f"{counts} (predicted {want}); predictions {[r['prediction'] for r in res.values()]}, "
            f"VQA accuracy {vqa_accuracy(res, rows, tmp, f'openflamingo_{path}'):.2f} "
            "(random weights)")
        if counts != want:
            raise AssertionError(f"openflamingo test_{path}: launches {counts} != {want}")
        if len(res) != n_q or not all(isinstance(r["prediction"], str) for r in res.values()):
            raise AssertionError(f"openflamingo test_{path}: malformed results {res}")
        for k in total:
            total[k] += counts[k]
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"openflamingo: peak device memory over both paths {peak:.2f} GiB")
    if dev.type == "cuda":
        profile_question(lambda: runs["icv"][0](e.val[1:2]), "openflamingo test_icv")
        profile_question(lambda: runs["icl"][0](e.val[1:2], e.shots[1:2]),
                         f"openflamingo test_icl ({ICL_SHOTS}-shot)")
    kernel_vs_plain_f32_logits(
        e, "openflamingo", make_openflamingo_forward_fns, CLIP_MEAN, CLIP_STD,
        (("test_icv", icv_prompt(e, 1), e.icv_scaled),
         (f"{ICL_SHOTS}-shot ICL", icl_prompt(e, 1, e.shots[1]), None)),
    )
    return total


def _counters():
    from licv_vqa_tpu_torch.models import layers as L
    from licv_vqa_tpu_torch.ops import int8_matmul as I8
    from licv_vqa_tpu_torch.ops import masked_kl_kernel as K
    from licv_vqa_tpu_torch.ops.icv_inject import icv_inject, icv_inject_backward

    return {
        "icv_inject": icv_inject,
        "icv_inject_bwd": icv_inject_backward,
        "flash_attention_fwd": L.flash_attention,
        "flash_attention_bwd": L.flash_attention_backward,
        "vit_attention": L.vit_attention,
        "masked_kl_fwd": K.rowwise_kl_forward,
        "masked_kl_bwd": K.rowwise_kl_backward,
        "int8_matmul": I8.int8_matmul,
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
        # the student (64 tokens) is under the flash gate; bf16 weights
        "flash_attention_bwd": 0, "int8_matmul": 0,
        # the ViT-H tower's 32 layers in the teacher's bind and the student's
        "vit_attention": 2 * 32,
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
    plain_forward, _ = _wrap_pixel_normalize(
        *I.make_idefics_forward_fns(plain_config(mc), bundle.eos_token_id), CLIP_MEAN, CLIP_STD
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
    ViT, ICV and KL kernels) or the plain path (plain attention in the
    decoder and the tower, the plain injection differentiated by autograd,
    ``kl_impl=xla``)."""
    import torch

    from licv_vqa_tpu_torch.icv.module import ICVModuleConfig, icv_loss_fn

    kernel = path == "kernel"
    b = m.bundle
    route_icv(kernel)
    if not kernel:  # the tower's plain attention too
        os.environ["LICV_VIT_FUSED_ATTN"] = "0"
    try:
        loss, _ = icv_loss_fn(
            m.encoder, m.temperature, b.params, m.batch,
            b.train_forward if kernel else m.plain_forward,
            ICVModuleConfig(kl_impl="pallas" if kernel else "xla"), b.pad_token_id, b.head_fn,
        )
        grads = torch.autograd.grad(loss, (m.encoder.icv, m.encoder.alpha))
    finally:
        route_icv(kernels=True)
        os.environ.pop("LICV_VIT_FUSED_ATTN", None)
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
    wall, events = device_events(step, always=True)
    if events is None:
        log(f"kernel-path loss+backward: {walls[0]:.1f}, {walls[1]:.1f} ms; teacher forward "
            f"alone {t_teacher:.1f} ms; device busy share and device time by kernel not "
            "measured (torch.profiler recorded no device activity)")
        return
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


# phase 9: the remat modes run (the JAX tool's flagship modes) and the
# steps timed after the first in each; the student rows' real lengths in
# the gradient check (right-padded, each past the query's 128 tokens)
FLAGSHIP_MODES = ("inner", "both")
FLAGSHIP_REPS = 2
FLAGSHIP_GRAD_LENGTHS = (256, 224, 192, 160)
# the depth of the checked gradient comparison (two cross-attention groups):
# at 32 random bf16 layers the plain path alone is as far from an f32 path
# as REL_L2_TOL (PERF.md, Findings)
FLAGSHIP_GRAD_LAYERS = 8


def load_tool(name: str):
    """``tools/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench_tool():
    """``tools/bench_train_step_torch.py`` as a module."""
    return load_tool("bench_train_step_torch")


def predicted_flagship_launches(mc, mode: str, s_tea: int, s_stu: int, bs: int, n_img: int,
                                int8: bool, dev) -> dict:
    """Launches in ONE train step of the bench tool, from the structure.
    The teacher (no gradient) runs the flash forward at every layer where
    ``layers.flash_attention_usable`` holds for ``s_tea``.  The student's
    layers are checkpointed: its forward runs every layer once, and the
    backward's recompute runs them again, L more under "inner" and L − G
    more under "both" (a group's recompute stops before its last layer,
    whose input the inner checkpoint kept): the flash forward (where the
    gate holds for ``s_stu``) and the ICV injection each run at every layer
    run.  The flash backward runs at every layer whose attention input
    depends on the ICV: all but the first (the ICV enters at each block's
    output).  The ICV backward at every layer; the fused ViT kernel in the
    teacher's bind and the student's.  The int8 kernel takes int8 matmuls
    of at most ``KERNEL_MAX_ROWS`` rows; the smallest here has
    min(bs·s_stu, bs·n_img·n_latents) rows, over it at the flagship, so 0."""
    from licv_vqa_tpu_torch.models import layers as L
    from licv_vqa_tpu_torch.ops.int8_matmul import KERNEL_MAX_ROWS

    t = mc.text
    n, g = t.n_layers, t.n_layers // mc.cross_layer_interval
    runs = {"inner": 2 * n, "both": 3 * n - g}[mode]
    stu = L.flash_attention_usable(t, s_stu, t.head_dim, dev)
    if int8 and min(bs * s_stu, bs * n_img * mc.perceiver.n_latents) <= KERNEL_MAX_ROWS:
        raise NotImplementedError("an int8 matmul of <= KERNEL_MAX_ROWS rows: not predicted")
    return {
        "flash_attention_fwd": n * L.flash_attention_usable(t, s_tea, t.head_dim, dev)
        + runs * stu,
        "flash_attention_bwd": (n - 1) * stu,
        "icv_inject": runs,
        "icv_inject_bwd": n,
        "vit_attention": 2 * vit_per_bind(mc.vision, dev),
        "int8_matmul": 0,
    }


def flagship_train_path(dev, shape: str = "flagship") -> dict:
    """Phase 9: the bench tool's train step (``_build``, ``measure``) in
    each of ``FLAGSHIP_MODES``, in process; the launch counts of every step
    against ``predicted_flagship_launches``, and one step profiled; then,
    after the first mode's run, ``flagship_gradient_check``.  Returns the
    launch counts of the runs."""
    import torch

    tool = bench_tool()
    counters = _counters()
    total = dict.fromkeys(counters, 0)
    for mode in FLAGSHIP_MODES:
        step, state, params, batch, meta = tool._build(shape, mode, dev)
        mc, *_, int8 = tool.shape_config(shape, mode)
        want = predicted_flagship_launches(
            mc, mode, meta["s_tea"], meta["s_stu"], meta["bs"],
            batch["inputs"]["pixel_values"].shape[1], int8, dev)
        steps = 1 + FLAGSHIP_REPS
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        res = tool.measure(step, state, params, batch, meta, reps=FLAGSHIP_REPS)
        counts = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        log(f"flagship train step, remat_mode={mode} ({shape}: s_tea {meta['s_tea']}, s_stu "
            f"{meta['s_stu']}, bs {meta['bs']}, {meta['model_tflops']} model TFLOP a step): "
            f"{res['step_ms']} ms a step (mean of {FLAGSHIP_REPS} after the first, which took "
            f"{res['first_step_s']} s), {res['tokens_per_sec']} tokens/s, MFU "
            f"{res['mfu_pct_bf16_peak']}% of 989 TFLOP/s bf16, loss {res['loss']}, peak device "
            f"memory {peak:.2f} GiB")
        for k, per_step in want.items():
            log(f"  {k} launches {counts[k]} (predicted {per_step} x {steps} steps)")
            if counts[k] != per_step * steps:
                raise AssertionError(f"flagship {mode}: {k} launched {counts[k]} != "
                                     f"{per_step} x {steps}")
        if not math.isfinite(res["loss"]):
            raise AssertionError(f"flagship {mode}: loss {res['loss']}")
        for k in total:
            total[k] += counts[k]
        if dev.type == "cuda":
            profile_question(lambda: step(state, params, batch), f"flagship remat_mode={mode}",
                             top=10, what="one train step")
        if mode == FLAGSHIP_MODES[0]:
            grad = flagship_gradient_check(tool, shape, mode, params, batch, dev)
        del step, state, params, batch
        free_device_memory()
    if not (math.isfinite(grad["loss_kernel"])
            and max(grad["rel_l2_icv"], grad["rel_l2_alpha"]) <= REL_L2_TOL):
        raise AssertionError("flagship: kernel-path gradients disagree with the plain path")
    return total


def flagship_gradient_check(tool, shape: str, mode: str, params, batch, dev) -> dict:
    """Phase 9's gradient check on the bench tool's model and batch, the
    student rows right-padded to ``FLAGSHIP_GRAD_LENGTHS`` (pad id 0), with
    a seeded encoder whose alpha is not 0 (the tool's starts at 0, where
    d_icv is).  The check: the (icv, alpha) gradients of the kernel path
    against the same path with the student's attention plain (plain
    attention differentiated by autograd), rel. L2 within ``REL_L2_TOL``, on
    the model's first ``FLAGSHIP_GRAD_LAYERS`` layers; the teacher's target,
    the ICV, ViT and KL kernels are the same in both, so the two differ by
    the flash kernels under autograd alone.  Printed beside it, not
    checked: the kernel path against the whole plain path (phase 5's
    comparison) and both against that plain path with the weights in f32,
    at that depth and at the model's full depth.  At full depth the plain
    path itself is as far from the f32 path as the limit (PERF.md,
    Findings): a gradient check there cannot tell a sound kernel."""
    import torch

    from licv_vqa_tpu_torch.icv.encoder import GlobalICVEncoder
    from licv_vqa_tpu_torch.icv.module import ICVModuleConfig, icv_loss_fn
    from licv_vqa_tpu_torch.models import decoder as Dm
    from licv_vqa_tpu_torch.models.idefics import make_idefics_forward_fns

    full = tool.shape_config(shape, mode)[0]
    q = dict(batch["query_inputs"])
    s_stu = q["input_ids"].shape[1]
    lengths = FLAGSHIP_GRAD_LENGTHS if shape == "flagship" else (s_stu, s_stu - 7)
    q["attention_mask"] = right_padded(lengths, s_stu, dev)
    q["input_ids"] = q["input_ids"] * q["attention_mask"]
    batch = {**batch, "query_inputs": q}

    def grads(mc, prm, fwd, student: str, teacher: str, kernels: bool, f32: bool = False):
        """``(loss, (d_icv, d_alpha))``: the student's and the teacher's
        forwards by name; ``kernels`` = the ICV, ViT and KL kernels, else
        their plain versions."""
        t = mc.text
        enc = GlobalICVEncoder(t.d_model, t.n_layers, alpha_init_value=0.5, use_sigmoid=True,
                               generator=torch.Generator().manual_seed(0), device=dev)

        def forward(p, inputs, icv, return_hidden=False):
            # the teacher is the call without an ICV
            return fwd[teacher if icv is None else student](p, inputs, icv, return_hidden)

        route_icv(kernels)
        if not kernels:
            os.environ["LICV_VIT_FUSED_ATTN"] = "0"
        try:
            loss, _ = icv_loss_fn(
                enc, torch.tensor(1.0, device=dev), f32_tree(prm) if f32 else prm, batch,
                forward, ICVModuleConfig(kl_impl="pallas" if kernels else "xla"), 0,
                lambda p, h: Dm.logits_from_hidden(
                    dataclasses.replace(t, dtype=torch.float32) if f32 else t, p, h))
            g = torch.autograd.grad(loss, (enc.icv, enc.alpha))
        finally:
            route_icv(kernels=True)
            os.environ.pop("LICV_VIT_FUSED_ATTN", None)
        free_device_memory()
        return loss.item(), g

    out = {}
    for depth in dict.fromkeys((min(FLAGSHIP_GRAD_LAYERS, full.text.n_layers),
                                full.text.n_layers)):
        mc = dataclasses.replace(full, text=dataclasses.replace(full.text, n_layers=depth))
        groups = depth // mc.cross_layer_interval
        prm = {**params, "layers": _first(params["layers"], depth),
               "xattn": _first(params["xattn"], groups)}
        fwd = {name: make_idefics_forward_fns(cfg, 2)[0] for name, cfg in (
            ("kernel", mc), ("plain", plain_config(mc)), ("f32", plain_config(mc, f32=True)))}
        paths = {
            "kernel": grads(mc, prm, fwd, "kernel", "kernel", True),
            "student attention plain": grads(mc, prm, fwd, "plain", "kernel", True),
            "plain": grads(mc, prm, fwd, "plain", "plain", False),
            "plain f32": grads(mc, prm, fwd, "f32", "f32", False, f32=True),
        }
        gated = not out
        log(f"flagship gradient check (remat_mode={mode}) at {depth} layers, one batch, the "
            f"student rows of {lengths} real tokens{'' if gated else ' (not checked)'}:")
        for a, b in (("kernel", "student attention plain"), ("kernel", "plain"),
                     ("kernel", "plain f32"), ("plain", "plain f32")):
            r = [((x - y).norm() / y.norm()).item()
                 for x, y in zip(paths[a][1], paths[b][1], strict=True)]
            checked = gated and b == "student attention plain"
            if checked:
                out = {"loss_kernel": paths["kernel"][0], "rel_l2_icv": r[0], "rel_l2_alpha": r[1]}
            log(f"  {a} path vs {b} path: loss {paths[a][0]:.6e} vs {paths[b][0]:.6e}; rel_l2 "
                f"d_icv {r[0]:.4e}, d_alpha {r[1]:.4e}"
                + (f" (limit {REL_L2_TOL})" if checked else ""))
        del paths, prm
    return out


def tools_path(dev, w8a8_shapes=None, int4_shape=None, reps=None) -> dict:
    """Phase 10: the two probe tools in process at their own shapes (each
    checks its variants and raises on a wrong one); the w8a8 and int4-probe
    kernel launches, zeroed before and read after, must equal the tools'
    tallies of their wrapper calls."""
    import torch

    from licv_vqa_tpu_torch.ops import int4_unpack_probe as P
    from licv_vqa_tpu_torch.ops import int8_matmul as I8

    w8, i4 = load_tool("exp_w8a8_tuning_torch"), load_tool("exp_int4_unpack_torch")
    I8.w8a8_matmul.launches = 0
    P.int4_unpack_probe.launches = 0
    t0 = time.perf_counter()
    rows_w = w8.run(dev, w8a8_shapes or w8.SHAPES, None, (), reps or 30)
    rows_i = i4.run(dev, int4_shape or i4.SHAPE, i4.G, reps or 200)
    torch.cuda.synchronize()
    counts = {"w8a8_matmul": I8.w8a8_matmul.launches,
              "int4_unpack_probe": P.int4_unpack_probe.launches}
    want = {"w8a8_matmul": sum(r["launches"] for r in rows_w),
            "int4_unpack_probe": sum(r["launches"] for r in rows_i)}
    log(f"probe tools: {time.perf_counter() - t0:.1f} s; launches {counts} (the tools' "
        f"tallies {want})")
    if counts != want:
        raise AssertionError(f"probe tools: launches {counts} != {want}")
    return counts


def _first(tree, n: int):
    """The first ``n`` layers of a layer-stacked param tree (views)."""
    if isinstance(tree, dict):
        return {k: _first(v, n) for k, v in tree.items()}
    return tree[:n]


# the kernels line's rows: (route, source, the TPU kernel it replaces)
KERNEL_SOURCES = {
    "icv_inject": ("triton", "licv_vqa_tpu_torch/ops/icv_inject.py",
                   "licv_vqa_tpu/ops/icv_inject.py:56"),
    "flash_attention_fwd": ("cuda", "licv_vqa_tpu_torch/csrc/flash_attn_fwd.cu",
                            "licv_vqa_tpu/models/layers.py:148"),
    # upstream's dkv and dq kernels, which flash_attention_tpu reaches
    # under autograd
    "flash_attention_bwd": ("cuda", "licv_vqa_tpu_torch/csrc/flash_attn_bwd.cu",
                            "licv_vqa_tpu/models/layers.py:148"),
    "masked_kl": ("cuda", "licv_vqa_tpu_torch/csrc/masked_kl.cu",
                  "licv_vqa_tpu/ops/masked_kl_kernel.py:128"),
    "icv_inject_bwd": ("cuda", "licv_vqa_tpu_torch/csrc/icv_inject_bwd.cu",
                       "licv_vqa_tpu/ops/icv_inject.py:113"),
    "int8_matmul": ("cuda", "licv_vqa_tpu_torch/csrc/int8_matmul.cu",
                    "licv_vqa_tpu/ops/int8_matmul.py:67"),
    "int4_matmul": ("cuda", "licv_vqa_tpu_torch/csrc/int4_matmul.cu",
                    "licv_vqa_tpu/ops/int4_matmul.py:134"),
    "flash_attention_bidir": ("cuda", "licv_vqa_tpu_torch/csrc/flash_attn_bidir.cu",
                              "licv_vqa_tpu/models/layers.py:233"),
    "flash_alibi_attention": ("cuda", "licv_vqa_tpu_torch/csrc/flash_alibi.cu",
                              "licv_vqa_tpu/ops/flash_alibi.py:124"),
    "vit_attention": ("cuda", "licv_vqa_tpu_torch/csrc/vit_attention.cu",
                      "licv_vqa_tpu/ops/vit_attention.py:118"),
    # the tuning probe's w8a8_kernel and w8a8_fused_kernel (JAX's production
    # w8a8 is XLA)
    "w8a8_matmul": ("cuda", "licv_vqa_tpu_torch/csrc/w8a8_matmul.cu",
                    "tools/exp_w8a8_tuning.py:36"),
    "int4_unpack_probe": ("cuda", "licv_vqa_tpu_torch/csrc/int4_unpack_probe.cu",
                          "tools/exp_int4_unpack.py:111"),
}


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

    # one nvcc per CUDA source, all started together
    with ThreadPoolExecutor() as pool:
        builds = list(pool.map(csrc.build, CUDA_SOURCES))
    for (lib, secs, nvcc_log) in builds:
        if nvcc_log:
            log(f"built {lib.relative_to(REPO)} with nvcc in {secs:.1f} s")
        else:
            log(f"found {lib.relative_to(REPO)} (built earlier from the same source)")
        for line in nvcc_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  nvcc: {line.strip()}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        kl_mask = training_kl_mask(Path(tmp))
    log(f"phase 5's KL rows: {int(kl_mask.sum())} of {kl_mask.numel()} weighted "
        f"({100 * float(kl_mask.float().mean()):.2f}%)")
    summary = check_kernels(dev, kl_mask)
    free_device_memory()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        counts = main_path(dev, Path(tmp) / "eval")
        free_device_memory()  # each phase's model goes before the next builds its own
        counts_train = training_path(dev, Path(tmp) / "train")
        free_device_memory()
        m = training_inputs(dev)
        grad = gradient_check(m)
        if not (math.isfinite(grad["loss_kernel"])
                and max(grad["rel_l2_icv"], grad["rel_l2_alpha"]) <= REL_L2_TOL):
            raise AssertionError("kernel-path gradients disagree with the plain path")
        profile_training(m)
        del m
        free_device_memory()
        counts_q = dict.fromkeys(("int8_matmul", "int4_matmul", "w8a8_matmul", "icv_inject",
                                  "flash_attention_fwd", "vit_attention"), 0)
        for mode, opts, paths in QUANT_RUNS:
            for k, v in quantized_path(dev, Path(tmp) / mode, mode, opts, paths).items():
                counts_q[k] += v
            free_device_memory()
        counts_i2 = idefics2_path(dev, Path(tmp) / "idefics2")
        free_device_memory()
        counts_of = openflamingo_path(dev, Path(tmp) / "openflamingo")
        free_device_memory()
    counts_fl = flagship_train_path(dev)
    free_device_memory()
    counts_tools = tools_path(dev)
    free_device_memory()

    phases = (counts, counts_train, counts_q, counts_i2, counts_of, counts_fl)
    launches = {
        name: sum(c.get(name, 0) for c in phases)
        for name in ("icv_inject", "flash_attention_fwd", "vit_attention", "icv_inject_bwd",
                     "flash_attention_bwd", "int8_matmul")
    }
    launches.update({
        "flash_alibi_attention": counts_of["flash_alibi_attention"],
        "flash_attention_bidir": counts_i2["flash_attention_bidir"],
        "int4_matmul": counts_q["int4_matmul"],
        "w8a8_matmul": counts_q["w8a8_matmul"] + counts_tools["w8a8_matmul"],
        "int4_unpack_probe": counts_tools["int4_unpack_probe"],
    })
    kernels = []
    for name, (route, source, replaces) in KERNEL_SOURCES.items():
        if name == "masked_kl":
            # one kernel pair behind one autograd Function: the row sums fwd + bwd
            f, b = summary["masked_kl_fwd"], summary["masked_kl_bwd"]
            row = {
                "launches": counts_train["masked_kl_fwd"] + counts_train["masked_kl_bwd"],
                "max_abs_err": max(f["max_abs_err"], b["max_abs_err"]),
                "ms": f["ms"] + b["ms"], "plain_ms": f["plain_ms"] + b["plain_ms"],
                "bound_ms": f["bound_ms"] + b["bound_ms"], "bound_by": "bytes",
                "library_ms": None,
                "timed_by": f["timed_by"] if f["timed_by"] == b["timed_by"] else "mixed",
                "fwd": {"launches": counts_train["masked_kl_fwd"], "ms": f["ms"],
                        "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"]},
                "bwd": {"launches": counts_train["masked_kl_bwd"], "ms": b["ms"],
                        "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"]},
            }
        else:
            s = summary[name]
            row = {"launches": launches[name], "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                   "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                   "bound_by": s["bound_by"], "library_ms": s["library_ms"],
                   "timed_by": s["timed_by"]}
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
