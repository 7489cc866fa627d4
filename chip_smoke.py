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
   and at prefill) and at ``ENGINE_INT8_SHAPES`` (a step of phase 4d's
   8-row greedy pool: projections and head) and the int4 one at ``INT4_PREFILL_SHAPES`` (run B's
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
   call; its f32 entry (``csrc/vit_attention_f32.cu``) at ``VIT_F32_SHAPES``
   (RICE's CLIP ViT-B/32, H=12, Dh=64: the encoder's batch of 8, a batch
   of 64, the batch of 8 with 7 keys of each image masked), to
   ``F32_REL_TOL``, with ``F.scaled_dot_product_attention`` on the same f32
   tensors as the library call; the w8a8 kernel (``csrc/w8a8_matmul.cu``), both entry points
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
   then, on the same model, 4b: ``test_icv`` greedy (``num_beams=1``) and
   again with a draft of its first ``spec_draft_layers`` (8) layers and
   ``SPEC_GAMMA`` (4) tokens a round, per-row acceptance, through
   ``icv_inference``: the tokens equal, or first differing where the
   target's f32 top-2 logit gap is under ``NEAR_TIE`` (printed), the ICV
   count 32 x target forwards + 8 x draft forwards, the peak memory at most
   phase 4's plus the draft cache, s/question for both; and 4c: RICE
   retrieval at CLIP ViT-B/32's published widths (random f32 weights made
   on the card) with the port's ``MMTopkRetriever`` and ``ClipTowerEncoder``,
   ``i2i``, an index of ``RICE_INDEX_ROWS`` (4096) rows over
   ``RICE_IMAGES`` (2048) images made on the card and ``RICE_TEST_ROWS``
   (256) test rows, ``retrieve`` for 1 and 32 shots: seconds to encode and
   to retrieve, the f32 fused ViT launches (12 x 544 batches of 8), the
   features against the plain path (``LICV_VIT_FUSED_ATTN=0``) within
   ``RICE_FEATURE_TOL`` a row, the 32-shot indices against the plain
   path's (a difference allowed only under an f32 score gap of
   ``RICE_GAP_TOL``), ties lower index first, the 1-shot result the
   32-shot one's first column, the cache reloaded; the text tower on 64
   ragged id rows (no fused launch, equal to the plain path); then the
   32-shot indices of 2 test rows through ``icl_inference`` on this model;
   and 4d: the continuous-batching engines (``infer/serving.py``) through
   the runner entry points ``icv_inference_continuous`` /
   ``icl_inference_continuous`` on the same model: (a) ``test_icv``
   beam-3 with ``CONT_BEAM_SLOTS`` (4) request groups, (b) ``test_icv``
   greedy with ``CONT_GREEDY_SLOTS`` (8) slots, (c) ``test_icl`` greedy on
   ``CONT_ICL_SHOTS`` (6 requests of 1, 8 and 32 shots: mixed buckets,
   media buffers 33 images wide) with ``CONT_ICL_SLOTS`` (4) slots; a
   greedy admission into an occupied pool rides a merged forward.  Each
   is run twice (the first warms up); the second's counts of the ICV, the
   fused ViT and the causal flash kernels must equal
   ``predicted_engine_launches`` (32 x (admission prefills + decode steps),
   32 x admission groups, 32 x groups of a bucket of >= 256 tokens); its
   tokens are held against the static path's at bs=1 (``decoded_tokens``)
   under the near-tie rule (greedy: ``near_tie_check``; beam:
   ``beam_near_tie_check``, a difference allowed only where some decision
   of the static beam search had an f32 margin under ``NEAR_TIE``).
   Prints s/question beside the static path's, tokens/s, peak memory, the
   admissions, the decode steps and the synchronizing CUDA calls that
   ``torch.cuda.set_sync_debug_mode("warn")`` reports inside decode chunks
   (one fails the phase); and 4e: the pooled beam eval
   chain (``infer/eval_chain.py``) through ``icv_inference_pooled`` /
   ``icl_inference_pooled`` on the same model: (a) ``test_icv`` beam-3 on
   ``POOLED_ICV_Q`` (8) questions in chunks of ``POOL_QUESTIONS`` (4), then
   in one chunk of 8, (b)
   ``test_icl`` on ``CONT_ICL_SHOTS`` (one chain a bucket; the 32-shot
   bucket's prefill lane takes the causal flash kernel), each run twice,
   the second's ICV, fused ViT and causal flash counts held to
   ``predicted_pooled_launches`` (a chain of n questions: one prologue
   prefill and n + P merged forwards, P = max_new − 1; the ICV 32 x (1 +
   2 x merged forwards) in ``test_icv``), its tokens to the static beam's
   under ``pooled_near_tie_check`` (where a question differs, the chain's
   own f32 log-probabilities at the first differing token against the
   static path's along the same prefix: within twice the static path's
   own bs-1-to-bs-4 drift, or the two tokens under ``NEAR_TIE`` apart),
   printing s/question beside the static beam's and 4d (a)'s beam
   engine's, ms a merged forward (CUDA events around each), peak memory
   and the synchronizing calls inside the chains (one fails the phase); (c)
   ``test_icv`` greedy on ``MERGED_REQUESTS`` (16) questions through
   ``CONT_GREEDY_SLOTS`` (8) slots, the CLI's, with merged admission (the
   engine's own choice on every admission into an occupied pool, as in
   4d) and then with plain admission, each as a 4d configuration, its
   tokens under ``drift_tie_check`` (4d (d)'s rule: a differing token's
   static f32 top-2 gap under ``NEAR_TIE`` or under twice the static
   path's own drift there between bs 1 and the 16 questions decoded
   together);
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
   ``torch._int_mm`` is made (w8a8 goes through the kernel); run A then
   decodes one ``test_icv`` question with the draft (``speculative_int8``:
   the int8 kernel's launches at M = 4 rows and at M = 1 against the
   forwards that ran, the tokens against int8 greedy under the near-tie
   rule) and one ``test_icv`` greedy run through the engine with 8 slots
   (``continuous_int8``, phase 4d (d): the int8 kernel's launches at M = 8
   rows against the decode steps times ``predicted_quantized_launches``'s
   per-step term, the other counts and the tokens as in 4d) and one chain
   of 4 ``test_icv`` questions through the pooled schedule with w8a8 off
   (``pooled_int8``, phase 4e (d): the int8 and w8a8 launches against
   ``predicted_pooled_launches``, the tokens as in 4e).  Prints ms
   per question, peak memory and a
   profile of one ``test_icv`` question (device busy share, device time by
   kernel), and holds the test_icv prompt's prefill and first-step logits
   through the kernels against the same weights through their plain
   versions (rel. L2 within ``REL_L2_TOL``, the same argmax).  Then
   OpenFlamingo-9B (``QUANT_FLAMINGO``: int8 weights, the int8 KV cache
   under ALiBi, w8a8 prefill; the tied head and the tower bf16), built and
   quantized the same way: ``test_icv`` (4 questions) and ``test_icl`` (1),
   the int8, w8a8 and ALiBi flash counts against
   ``predicted_quantized_launches`` (the family's matmuls:
   ``quant_matmuls``) and ``prefill_flash``, then one greedy ``test_icv``
   run through the engine under the int8 cache (``continuous_int8``: the
   per-row index with the ALiBi bias on the int8 cache; plain admission,
   as w8a8 prefills keep), the profile and the kernel-vs-plain logits;
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
   bf16's resolution: ``kernel_vs_plain_f32_logits``); then 7b, the
   engines, merged admission and the pooled chain on the same model, with
   4d's and 4e's checks (each configuration run twice, the second counted;
   the tower's bidirectional flash counted with the rest, 27 launches a
   bind of an admission group or a merged forward's prefill lane; no
   synchronizing call inside a chunk or a chain): (a) ``test_icv`` beam-3
   through ``icv_inference_continuous`` on ``IDEFICS2_ENGINE_Q`` (12)
   questions whose images cycle ``COCO_SIZES``, so their admissions split
   by NaViT mask shape, ``CONT_BEAM_SLOTS`` (4) request groups; (b)
   ``test_icv`` greedy on ``MERGED_REQUESTS`` (16) such questions at
   ``CONT_GREEDY_SLOTS`` (8) slots, merged admission and then plain (4e
   (c)'s ``merged_vs_plain``); (c) ``test_icl`` beam-3 on
   ``CONT_ICL_SHOTS`` through the beam engine at ``CONT_ICL_SLOTS`` (4)
   requests (the causal flash in the 32-shot admissions, 33 images a
   bind; peak memory printed); (d) the pooled chain of the bundle
   (``pooled_eval_chain``) on ``POOLED_ICV_Q`` (8) ``test_icv`` questions
   of ``UNIFORM_SIZE`` (672x672, whole 112-pixel buckets: no padded pixel,
   no mask) in one chunk, under 4e's token rule;
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
   against an f32 path, as phase 7 does; then 8b, the engines, merged
   admission and the pooled chain on the same model, with 4d's and 4e's
   checks (the fused ViT at 24 layers a bind, the ALiBi flash at 32
   layers of each admission prefill and each prologue or merged prefill
   lane of >= 128 tokens, the ICV in both lanes; no synchronizing call
   inside a chunk or a chain): (a) ``test_icv`` beam-3 on
   ``OPENFLAMINGO_ENGINE_Q`` (12) questions, ``CONT_BEAM_SLOTS`` request
   groups; (b) ``merged_vs_plain`` on ``MERGED_REQUESTS`` (16) greedy
   questions at ``CONT_GREEDY_SLOTS`` slots; (c) ``test_icl`` beam-3 on
   ``CONT_ICL_SHOTS`` at ``CONT_ICL_SLOTS`` requests (media buffers 33
   images wide, the ALiBi flash in the 32-shot admissions); (d) the pooled
   chain through ``icv_inference_pooled`` (``POOLED_ICV_Q`` questions, one
   chunk) and ``icl_inference_pooled`` (``CONT_ICL_SHOTS`` in chunks of
   ``POOL_QUESTIONS``: the ALiBi flash in the 32-shot chain's prefill
   lanes), under 4e's token rule;
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

import contextlib
import dataclasses
import gc
import json
import importlib
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

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
                "int4_unpack_probe.cu", "icv_inject_bwd.cu", "masked_kl.cu",
                "vit_attention_f32.cu")


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
    for b, s, pad, h in FLASH_FWD_SHAPES:
        q, k, v = (randn((b, s, h, 128)) for _ in range(3))
        valid = torch.ones((b, s), dtype=torch.int32, device=dev)
        valid[:, :pad] = 0  # left padding, as the decode prompts are
        # with no pad the segment rule is the causal mask alone: the
        # library's own causal flash path is the same function
        mask = L.segment_causal_mask(valid) if pad else None
        yield Case(
            "flash_attention_fwd",
            f"({b},{s},{h},128) " + (f"left pad {pad}" if pad else "all valid"),
            lambda q=q, k=k, v=v, valid=valid: L.flash_attention(q, k, v, valid),
            lambda q=q, k=k, v=v, valid=valid: L.flash_attention_reference(q, k, v, valid),
            # QK^T and PV over the pairs the segment rule leaves visible
            bytes_moved=4 * q.numel() * 2 + valid.numel() * 4,
            ops=4 * h * 128 * causal_segment_pairs(valid), op_type="bf16",
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
    for b, s, h, dh, masked in VIT_SHAPES:
        q, k, v = (randn((b, s, h, dh)) for _ in range(3))
        valid = None
        keys = torch.full((b,), float(s), device=dev)
        if masked:
            valid = torch.rand((b, s), generator=g, device=dev) > 0.3
            valid[-1] = False  # no valid key: the uniform softmax
            n = valid.sum(dim=1).float()
            keys = torch.where(n > 0, n, float(s))
        yield Case(
            "vit_attention", f"({b},{s},{h},{dh}) {'masked' if masked else 'all valid'}",
            lambda q=q, k=k, v=v, valid=valid: L.vit_attention(q, k, v, valid),
            lambda q=q, k=k, v=v, valid=valid: L.vit_attention_reference(q, k, v, valid),
            bytes_moved=4 * q.numel() * 2 + (0 if valid is None else valid.numel() * 4),
            # QK^T and PV over every query and the keys its softmax weighs
            ops=4 * h * dh * s * float(keys.sum()), op_type="bf16",
            library=lambda q=q, k=k, v=v, valid=valid: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=None if valid is None else valid[:, None, None, :]),
            calls=5, mean_tol=VIT_MEAN_TOL,
        )
    for b, s, h, dh, hidden in VIT_F32_SHAPES:
        q, k, v = (randn((b, s, h, dh), dtype=torch.float32) for _ in range(3))
        valid = None
        if hidden:
            valid = torch.ones((b, s), dtype=torch.bool, device=dev)
            for row in range(b):
                valid[row, torch.randperm(s, generator=g, device=dev)[:hidden]] = False
        label = f"({b},{s},{h},{dh}) f32 " + (f"masked {hidden}" if hidden else "all valid")
        yield Case(
            "vit_attention_f32", label,
            lambda q=q, k=k, v=v, valid=valid: L.vit_attention(q, k, v, valid),
            lambda q=q, k=k, v=v, valid=valid: L.vit_attention_reference(q, k, v, valid),
            bytes_moved=4 * q.numel() * 4 + (0 if valid is None else valid.numel() * 4),
            # QK^T and PV over every query and the keys its softmax weighs
            ops=4 * h * dh * s * b * (s - hidden), op_type="f32",
            library=lambda q=q, k=k, v=v, valid=valid: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=None if valid is None else valid[:, None, None, :]),
            calls=20, tol=F32_REL_TOL,
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
# (B, S, left pad, H): H = 16 is a rank's heads at tp = 2 (phase 11 (b): the
# 32-shot test_icl prefill)
FLASH_FWD_SHAPES = ((1, 384, 57, 32), (1, 512, 39, 32), (1, 2048, 301, 32), (1, 2560, 173, 32),
                    (4, 2048, 0, 32), (1, 512, 39, 16), (1, 2048, 301, 16))

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
# with H: (B, S, H, Dh, masked); H = 8 is a rank's heads of ViT-H at tp = 2
# (phase 11 (b) and (d): a 32-shot bind)
VIT_SHAPES = ((1, 257, 16, 64, False), (33, 257, 16, 64, False), (33, 257, 16, 80, False),
              (4, 257, 16, 80, True), (2, 1024, 16, 80, True), (33, 257, 8, 80, False))
# the f32 entry of the fused ViT kernel (csrc/vit_attention_f32.cu): RICE's
# CLIP ViT-B/32 image tower (S = 50, H = 12, Dh 64), the encoder's batch of
# 8, a batch of 64, and the batch of 8 under a key mask that hides 7 keys of
# each image: (B, S, H, Dh, masked keys an image)
VIT_F32_SHAPES = ((8, 50, 12, 64, 0), (64, 50, 12, 64, 0), (8, 50, 12, 64, 7))
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
# with a rank's shards at tp = 2 (phase 11 (d)'s decode steps): a beam
# step's column-split projections (N = 4096 / 2, 11008 / 2) and row-split
# ones (K = 4096 / 2, 11008 / 2; f32 partial sums)
QUANT_SHAPES = (
    ((3, 4096, 4096), "bf16"), ((3, 4096, 11008), "f32"), ((3, 11008, 4096), "f32"),
    ((64, 4096, 4096), "bf16"), ((3, 4096, 2048), "bf16"), ((3, 5504, 4096), "f32"),
    ((3, 4096, 5504), "f32"), ((3, 2048, 4096), "f32"),
)
# with the vocab-sharded head's rank shard at tp = 2 (32002 / 2, phase 11 (d))
HEAD_SHAPES = (((3, 4096, 32000), "f32"), ((3, 4096, 32002), "f32"), ((1, 4096, 32002), "f32"),
               ((1, 4096, 16001), "f32"), ((3, 4096, 16001), "f32"))
# phase 4d (d): a decode step of the engine's 8-row greedy pool (run A)
ENGINE_INT8_SHAPES = (((8, 4096, 4096), "bf16"), ((8, 4096, 11008), "f32"),
                      ((8, 11008, 4096), "f32"), ((8, 4096, 32002), "f32"))
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

    for mode, shapes in (("int8", QUANT_SHAPES + HEAD_SHAPES + ENGINE_INT8_SHAPES),
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
    # a rank's shards at tp = 2 in the 512-token prefill: column-split
    # projection and MLP-in, row-split output projection and MLP-out
    # (phase 11 (d) quantizes the row-split ones with the whole row's scale)
    ((512, 4096, 2048), "bf16"), ((512, 4096, 5504), "f32"), ((512, 2048, 4096), "bf16"),
    ((512, 5504, 4096), "f32"),
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
    # the RICE encoder's batch of 8 images (CLIP ViT-B/32, f32)
    "vit_attention_f32": "(8,50,12,64) f32 all valid",
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


def synthetic_vqa(n: int, offset: int, seed: int, sizes=((224, 224),), answers=None):
    """In-memory VQA rows with uint8 images of the (width, height) ``sizes``,
    cycled, and ``answers`` cycled (one-word ones by default)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    answers = answers or ["red", "blue", "two", "cat", "yes", "no"]
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


def write_vqa_split(root: Path, img_root: Path, split: str, n: int, seed: int,
                    answers=None) -> None:
    """A VQAv2 split on disk (question, annotation and JPEG files), as
    ``tests/test_cli_e2e.py`` writes one."""
    from PIL import Image

    img_root.mkdir(parents=True, exist_ok=True)
    root.mkdir(parents=True, exist_ok=True)
    rows = synthetic_vqa(n, 100, seed, answers=answers)
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
    return row_prompt(e, e.val[q])


def row_prompt(e: EvalSetup, row: dict) -> list:
    p = [e.instruction] if e.instruction else []
    return p + [row["image"], e.pm.gen_query_text_without_label(row)]


def vit_per_bind(vc, dev) -> int:
    """Fused ViT kernel launches in one bind of a CLIP tower (one call per
    layer over all the bind's images) where ``layers.vit_attention_usable``
    holds for its sequence, else 0."""
    from licv_vqa_tpu_torch.models import layers as L

    return vc.n_layers * L.vit_attention_usable(vc.n_patches, vc.d_model // vc.n_heads, dev)


def bind_patches(vc, hw) -> int:
    """Patches an image of ``hw`` (height, width) pixels makes."""
    return (hw[0] // vc.patch_size) * (hw[1] // vc.patch_size)


def tower_launches(vc, n_patches: int, dev) -> dict:
    """The tower's attention launches in one bind of images of ``n_patches``
    patches, one call a layer over all the bind's images, by
    ``vision._vit_layer``'s branches: the bidirectional flash kernel where
    ``layers.flash_bidir_usable`` holds for the tokens (a SigLIP/NaViT
    tower from 1024 patches: every Idefics2 image at full width), else the
    fused ViT kernel where ``layers.vit_attention_usable`` does (Idefics'
    CLIP tower at 257 tokens)."""
    from licv_vqa_tpu_torch.models import layers as L

    n = n_patches + int(vc.use_class_token)
    bidir = L.flash_bidir_usable(n, dev)
    return {"flash_attention_bidir": vc.n_layers * bidir,
            "vit_attention": vc.n_layers * (not bidir) * L.vit_attention_usable(
                n, vc.d_model // vc.n_heads, dev)}


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
    PHASE11_REFS["b"] = tp_references(e)
    spec = speculative_path(e, dev, peak)
    rice = rice_path(e, dev, tmp)
    cont = continuous_path(e)
    pooled = pooled_path(e, cont["beam_s_per_q"])
    return {
        "icv_inject": (counts["icv_inject", "test_icv"] + counts["icv_inject", "test_icl"]
                       + spec["icv_inject"] + cont["icv_inject"] + pooled["icv_inject"]),
        "flash_attention_fwd": (counts["flash", "test_icv"] + counts["flash", "test_icl"]
                                + cont["flash_attention_fwd"] + pooled["flash_attention_fwd"]),
        "vit_attention": counts["vit", "test_icv"] + counts["vit", "test_icl"]
        + spec["vit_attention"] + cont["vit_attention"] + pooled["vit_attention"],
        "vit_attention_f32": rice["vit_attention_f32"],
    }


# phase 4b: self-speculative greedy decoding on phase 4's model, a block of
# SPEC_GAMMA draft tokens a round (generate_kwargs.speculative_gamma); a
# position where the two decodes differ passes only where the target's f32
# top-2 logit gap there is under NEAR_TIE (JAX speculative.py:8-14)
SPEC_GAMMA = 4
NEAR_TIE = 0.05


def spec_draft_layers(mc) -> int:
    """The draft's depth (``speculative_draft_layers``): a quarter of the
    decoder, 8 of Idefics-9B's 32 layers, at least one cross-attention
    group."""
    return max(mc.cross_layer_interval, mc.text.n_layers // 4)


def encoded(b, prompts: list) -> tuple:
    """``(ids, mask, pixels, pixel_valid, kw)`` of ``prompts`` as the
    runner encodes them, on the bundle's device; ``kw`` holds the
    ``pixel_attention_mask`` where the processor marks real pixels
    (Idefics2's NaViT at full width), for the bind."""
    import torch

    enc = b.processor.prepare_input(prompts, padding=True, padding_side="left")
    keys = ("input_ids", "attention_mask", "pixel_values", "pixel_valid")
    kw = {k: torch.from_numpy(enc[k]).to(b.device) for k in ("pixel_attention_mask",)
          if k in enc}
    return (*(torch.from_numpy(enc[k]).to(b.device) for k in keys), kw)


def top2_gap(e: EvalSetup, prompt: list, prefix, icv_scaled) -> float:
    """The target's f32 gap between its two largest logits after ``prompt``
    and the generated tokens ``prefix``: a prefill of the whole sequence
    through the bundle's bind (the token the decodes disagree on comes
    next)."""
    import torch

    b = e.bundle
    dev = b.device
    ids, mask, px, pv, kw = encoded(b, [prompt])
    ids = torch.cat([ids, prefix[None].to(device=dev, dtype=ids.dtype)], dim=1)
    mask = torch.cat([mask, torch.ones_like(ids[:, mask.shape[1]:])], dim=1)
    pos = torch.clamp(torch.cumsum(mask, -1) - 1, min=0)
    with torch.inference_mode():
        fwd = b.bind_decode(b.params, px, pv, ids, icv_scaled, ids.shape[1] + 1, **kw)
        top = fwd(ids, mask, pos, None)[0][0, -1].float().topk(2).values
    return float(top[0] - top[1])


def forced_decode_logits(e: EvalSetup, prompts: list, prefixes: list, icv_scaled):
    """(B, V) f32: the static greedy path's logits after each prompt and its
    tokens ``prefixes`` (of one length), the prompts at bs = len(prompts)
    as the runner batches them: one prefill, then one decode step a token
    with the given tokens in place of the argmax (``greedy_generate``'s
    calls, so at bs 1 these are its logits along that prefix)."""
    import torch

    from licv_vqa_tpu_torch.models.decoder import _positions_from_mask

    b = e.bundle
    dev = b.device
    ids, mask, px, pv, kw = encoded(b, prompts)
    pos = _positions_from_mask(mask)
    with torch.inference_mode():
        fwd = b.bind_decode(b.params, px, pv, ids, icv_scaled, ids.shape[1] + MAX_NEW + 1,
                            **kw)
        logits, cache = fwd(ids, mask, pos, None)
        next_pos = pos[:, -1] + 1
        step_mask = torch.ones((len(prompts), 1), dtype=torch.int32, device=dev)
        for k in range(len(prefixes[0])):
            tok = torch.stack([x[k] for x in prefixes]).to(device=dev, dtype=ids.dtype)
            logits, cache = fwd(tok[:, None], step_mask, next_pos[:, None], cache)
            next_pos = next_pos + 1
    return logits[:, -1].float()


def decoded_tokens(e: EvalSetup, gen_kwargs: dict, prompts: list, icv_scaled) -> list:
    """Each prompt's generated tokens (bs 1) through the runner's generate
    and dispatch, as ``icv_inference`` runs them."""
    from licv_vqa_tpu_torch.infer import runner

    gen = runner.make_generate_fn(e.bundle, gen_kwargs)
    out = []
    for p in prompts:
        toks, _, s = runner._dispatch_generate(e.bundle, gen, [p], icv_scaled)
        out.append(toks[0, s:].cpu())
    return out


def near_tie_check(e: EvalSetup, tag: str, prompts: list, greedy: list, spec: list,
                   icv_scaled) -> int:
    """Speculative tokens against greedy's: equal, or differing first where
    the target's top-2 gap is under ``NEAR_TIE`` (after that the two
    sequences continue from different tokens).  Prints each such position
    and returns their number."""
    n = 0
    for q, (p, a, b) in enumerate(zip(prompts, greedy, spec, strict=True)):
        diff = (a != b).nonzero()
        if not len(diff):
            continue
        at = int(diff[0])
        gap = top2_gap(e, p, a[:at], icv_scaled)
        log(f"{tag}: question {q} differs from greedy at token {at} ({a.tolist()} vs "
            f"{b.tolist()}); the target's f32 top-2 gap there {gap:.6f} (limit {NEAR_TIE})")
        if not gap < NEAR_TIE:
            raise AssertionError(f"{tag}: differs from greedy away from a near tie")
        n += 1
    return n


def speculative_path(e: EvalSetup, dev, peak_greedy_gib: float) -> dict:
    """Phase 4b: ``test_icv`` greedy, then with a draft of the first
    ``spec_draft_layers`` layers and ``SPEC_GAMMA`` tokens a round, per-row
    acceptance, through the runner entry points on phase 4's Idefics-9B.
    Returns the launch counts of the speculative run."""
    import torch

    from licv_vqa_tpu_torch.infer.runner import icv_inference
    from licv_vqa_tpu_torch.infer.speculative import speculative_greedy_generate
    from licv_vqa_tpu_torch.models import layers as L
    from licv_vqa_tpu_torch.ops.icv_inject import icv_inject

    b, t = e.bundle, e.bundle.model_cfg.text
    k = spec_draft_layers(b.model_cfg)
    greedy_kw = dict(e.gen_kwargs, num_beams=1)
    spec_kw = dict(greedy_kw, speculative_draft_layers=k, speculative_gamma=SPEC_GAMMA)
    rows = e.val[1 : 1 + N_ICV_Q]
    prompts = [icv_prompt(e, q) for q in range(1, 1 + N_ICV_Q)]
    kws = {"greedy": greedy_kw, "speculative": spec_kw}
    for kw in kws.values():  # warm-up
        icv_inference(e.val[:1], b, e.pm, 1, kw, e.instruction, e.icv_scaled, progress=False)
    secs, res, counts = {}, {}, {}
    for tag, kw in kws.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        icv_inject.launches = L.vit_attention.launches = 0
        fwd = speculative_greedy_generate.forwards
        before = dict(fwd)
        t0 = time.perf_counter()
        res[tag] = icv_inference(rows, b, e.pm, 1, kw, e.instruction, e.icv_scaled,
                                 progress=False)
        torch.cuda.synchronize()
        secs[tag] = (time.perf_counter() - t0) / N_ICV_Q
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        counts[tag] = {"icv_inject": icv_inject.launches, "vit_attention": L.vit_attention.launches,
                       "target": fwd["target"] - before["target"],
                       "draft": fwd["draft"] - before["draft"], "peak": peak}
    c = counts["speculative"]
    want_icv = t.n_layers * c["target"] + k * c["draft"]
    # the draft's cache: its layers' K and V, positions and validity, at
    # the longest prompt's length
    s_max = max(b.processor.prepare_input([p], padding=True, padding_side="left")
                ["input_ids"].shape[1] for p in prompts)
    max_len = s_max + MAX_NEW + SPEC_GAMMA + 1
    draft_cache = (2 * k * max_len * t.n_kv_heads * t.head_dim * 2
                   + max_len * 5) / 2**30
    log(f"speculative (draft {k} layers, gamma {SPEC_GAMMA}, per row): "
        f"{N_ICV_Q} questions, {secs['speculative']:.3f} s/question vs greedy "
        f"{secs['greedy']:.3f} s/question; target forwards {c['target']}, draft forwards "
        f"{c['draft']}; icv_inject launches {c['icv_inject']} (want {t.n_layers} x "
        f"{c['target']} + {k} x {c['draft']} = {want_icv}); vit_attention "
        f"launches {c['vit_attention']} (the target's and the draft's binds); peak device "
        f"memory {c['peak']:.2f} GiB (greedy {counts['greedy']['peak']:.2f}; limit phase 4's "
        f"{peak_greedy_gib:.2f} + the draft cache {draft_cache:.4f})")
    if c["icv_inject"] != want_icv or c["target"] <= N_ICV_Q:
        raise AssertionError("speculative: icv_inject launches != layers x target + draft "
                             "layers x draft forwards")
    if c["peak"] > peak_greedy_gib + draft_cache:
        raise AssertionError("speculative: peak memory above phase 4's plus the draft cache")
    log(f"greedy predictions {[r['prediction'] for r in res['greedy'].values()]}, "
        f"speculative {[r['prediction'] for r in res['speculative'].values()]}")
    if dev.type == "cuda":
        profile_question(lambda: icv_inference(rows[:1], b, e.pm, 1, spec_kw, e.instruction,
                                               e.icv_scaled, progress=False),
                         "speculative test_icv")
    greedy = decoded_tokens(e, greedy_kw, prompts, e.icv_scaled)
    spec = decoded_tokens(e, spec_kw, prompts, e.icv_scaled)
    n = near_tie_check(e, "speculative bf16", prompts, greedy, spec, e.icv_scaled)
    log(f"speculative bf16 tokens: {N_ICV_Q - n} of {N_ICV_Q} questions equal greedy's, "
        f"{n} differ at a near tie")
    return {"icv_inject": c["icv_inject"], "vit_attention": c["vit_attention"]}


def speculative_int8(e: EvalSetup) -> dict:
    """Phase 6 run A's speculative check: one ``test_icv`` question with the
    draft on the int8 model.  Inside the speculative decode (the binds
    excluded), the int8 kernel's launches at M = gamma rows (every verify
    forward's projections and head) and at M = 1 (every draft step's, and
    the two prefills' heads) against the forwards that ran; the tokens
    against int8 greedy under the near-tie rule."""
    import torch

    from licv_vqa_tpu_torch.infer import speculative as S
    from licv_vqa_tpu_torch.ops import int8_matmul as I8

    b, t = e.bundle, e.bundle.model_cfg.text
    k = spec_draft_layers(b.model_cfg)
    greedy_kw = dict(e.gen_kwargs, num_beams=1)
    spec_kw = dict(greedy_kw, speculative_draft_layers=k, speculative_gamma=SPEC_GAMMA)
    prompts = [icv_prompt(e, 1)]
    greedy = decoded_tokens(e, greedy_kw, prompts, e.icv_scaled)
    decoded_tokens(e, spec_kw, prompts, e.icv_scaled)  # warm-up
    kernel, decode, rows, inside = I8.int8_matmul, S.speculative_greedy_generate, [], []

    def counted(x, *a, **kw):
        if inside:
            rows.append(x.shape[0])
        return kernel(x, *a, **kw)

    def traced(*a, **kw):
        inside.append(1)
        try:
            return decode(*a, **kw)
        finally:
            inside.clear()

    fwd = decode.forwards
    before = dict(fwd)
    # the wrapper adds its launches to the module's ``int8_matmul``: the spy
    # carries the count while it stands in
    counted.launches = kernel.launches
    I8.int8_matmul, S.speculative_greedy_generate = counted, traced
    try:
        spec = decoded_tokens(e, spec_kw, prompts, e.icv_scaled)
        torch.cuda.synchronize()
    finally:
        I8.int8_matmul, S.speculative_greedy_generate = kernel, decode
        kernel.launches = counted.launches
    target, draft = fwd["target"] - before["target"], fwd["draft"] - before["draft"]

    def per(layers: int) -> int:  # 7 projections a layer, 5 a group, the int8 head
        return 7 * layers + 5 * (layers // b.model_cfg.cross_layer_interval) + 1

    at_gamma, at_one = rows.count(SPEC_GAMMA), rows.count(1)
    want_gamma, want_one = (target - 1) * per(t.n_layers), (draft - 1) * per(k) + 2
    log(f"int8 speculative (draft {k} layers): {target} target and {draft} draft forwards; "
        f"int8 kernel launches at M = {SPEC_GAMMA} rows {at_gamma} (want {target - 1} "
        f"verifies x {per(t.n_layers)} = {want_gamma}), at M = 1 {at_one} (want "
        f"{draft - 1} draft steps x {per(k)} + 2 prefill heads = {want_one}), "
        f"{len(rows)} in all")
    if (at_gamma, at_one) != (want_gamma, want_one) or target < 2:
        raise AssertionError("int8 speculative: int8 kernel launches off the forwards that ran")
    n = near_tie_check(e, "speculative int8", prompts, greedy, spec, e.icv_scaled)
    log(f"speculative int8 tokens: {1 - n} of 1 question equal int8 greedy's")
    return {"int8_matmul": len(rows)}


# phase 4d: the continuous-batching engines on phase 4's model; (d) on run
# A's int8 model in phase 6.  Slots: request groups of 3 beams for (a)
CONT_BEAM_SLOTS = 4
CONT_GREEDY_SLOTS = 8
CONT_ICL_SLOTS = 4
CONT_ICL_SHOTS = (1, 8, 32, 1, 8, 32)


def engine_counters() -> dict:
    """The engines' and chains' counted kernels (the towers' two, the
    decoder's causal and ALiBi flash and the ICV injection): name ->
    wrapper."""
    from licv_vqa_tpu_torch.models import layers as L
    from licv_vqa_tpu_torch.ops import flash_alibi as FA
    from licv_vqa_tpu_torch.ops.icv_inject import icv_inject

    return {"icv_inject": icv_inject, "vit_attention": L.vit_attention,
            "flash_attention_bidir": L.flash_attention_bidir,
            "flash_attention_fwd": L.flash_attention,
            "flash_alibi_attention": FA.flash_alibi_attention}


def prefill_flash(t, tokens: int, dev) -> dict:
    """The decoder's flash launches a layer in a prefill of ``tokens``
    tokens into an empty cache, by ``decoder._attend``'s branches: the
    causal kernel for a rope decoder where ``layers.flash_attention_usable``
    holds, the ALiBi kernel for MPT's where ``flash_alibi.flash_alibi_usable``
    does."""
    from licv_vqa_tpu_torch.models import layers as L
    from licv_vqa_tpu_torch.ops import flash_alibi as FA

    alibi = t.positional == "alibi"
    return {"flash_attention_fwd": int(not alibi and L.flash_attention_usable(
                t, tokens, t.head_dim, dev)),
            "flash_alibi_attention": int(alibi and FA.flash_alibi_usable(
                t, tokens, t.head_dim, dev))}


@contextlib.contextmanager
def engine_spy():
    """Records each engine run (the engine and its tokens) and each
    admission group's (height, width) of pixels (``binds``), counts the
    synchronizing CUDA calls that ``torch.cuda.set_sync_debug_mode("warn")``
    reports inside its decode chunks (the first one's source line kept) and
    brackets each chunk with CUDA events (``step_ms``: their mean interval
    over the steps, after a synchronize)."""
    import warnings

    import numpy as np
    import torch

    from licv_vqa_tpu_torch.infer.serving import ServingEngine

    spy = SimpleNamespace(runs=[], syncs=0, first_sync=None, events=[], steps=0, binds=[])

    def step_ms():
        if not spy.events:
            return None
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in spy.events) / spy.steps

    spy.step_ms = step_ms
    run, chunk, admit = ServingEngine.run, ServingEngine._chunk, ServingEngine._admit_group

    def spied_admit(self, group, *a):
        spy.binds.append(tuple(np.asarray(group[0].pixel_values).shape[1:3]))
        return admit(self, group, *a)

    def spied_run(self, *a, **kw):
        out = run(self, *a, **kw)
        spy.runs.append((self, out))
        return out

    def spied_chunk(self):
        if self.device.type != "cuda":
            return chunk(self)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                start.record()
                chunk(self)
                end.record()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        spy.events.append((start, end))
        spy.steps += self.sync_steps
        syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
        spy.syncs += len(syncs)
        if syncs and spy.first_sync is None:
            spy.first_sync = f"{syncs[0].filename}:{syncs[0].lineno}: {syncs[0].message}"
        return None

    ServingEngine.run, ServingEngine._chunk = spied_run, spied_chunk
    ServingEngine._admit_group = spied_admit
    try:
        yield spy
    finally:
        ServingEngine.run, ServingEngine._chunk = run, chunk
        ServingEngine._admit_group = admit


def predicted_engine_launches(mc, engine, binds: list, with_icv: bool, dev) -> dict:
    """The ICV, tower and causal flash launches of one engine run, from its
    admissions, their pixels' (height, width) ``binds`` and its decode
    steps: every admission group prefills once (a bind of the group's
    images, the tower's layers once, ``tower_launches``; the causal flash
    at every layer where the bucket passes the flash gate) and every decode
    step forwards the whole pool once; the ICV enters every layer of both.
    A merged admission is both in one forward (its prefill lane and its
    decode lane each take the ICV, and the flash where the bucket
    passes).  The flash is the causal kernel or, for MPT, the ALiBi one
    (``prefill_flash``)."""
    t = mc.text
    groups = engine.admissions
    if len(binds) != len(groups):
        raise AssertionError(f"{len(binds)} binds recorded for {len(groups)} admissions")
    out = {
        "icv_inject": t.n_layers * (len(groups) + engine.steps_run) if with_icv else 0,
        "vit_attention": 0, "flash_attention_bidir": 0, "flash_attention_fwd": 0,
        "flash_alibi_attention": 0,
    }
    for _, bucket in groups:
        for k, v in prefill_flash(t, bucket, dev).items():
            out[k] += t.n_layers * v
    for hw in binds:
        for k, v in tower_launches(mc.vision, bind_patches(mc.vision, hw), dev).items():
            out[k] += v
    return out


def engine_tokens(engine_out: dict, n: int, pad: int) -> list:
    """The engine's tokens of requests 0..n-1 as the static decode lays
    them out: ``MAX_NEW`` long, pad after EOS."""
    import torch

    out = []
    for uid in range(n):
        toks = torch.full((MAX_NEW,), pad, dtype=torch.long)
        toks[: len(engine_out[uid])] = torch.from_numpy(engine_out[uid].astype("int64"))
        out.append(toks)
    return out


def beam_min_margin(e: EvalSetup, gen_kwargs: dict, prompt: list, icv_scaled, run=None) -> float:
    """The smallest f32 margin of any decision of the static beam search on
    ``prompt`` at bs 1: around rank K and rank 2K of the expanded
    candidates (which beams go on, which EOS candidates may enter the
    finished pool), rank K of the live candidates and of the finished pool,
    and rank 1 of the final hypotheses.  Entries at ``NEG_INF / 2`` or below
    (beams not started, an unfilled pool) are not compared.  A drift of the
    scores under this margin changes no decision.  ``run``: the decode to
    spy on, in place of the static path's on ``prompt``."""
    import torch

    from licv_vqa_tpu_torch.infer import decode as D

    margins = []

    def gap(scores, rank: int):
        s = torch.sort(scores.float(), dim=-1, descending=True).values
        if s.shape[-1] > rank:
            a, b = s[..., rank - 1], s[..., rank]
            keep = b > D.NEG_INF / 2
            if bool(keep.any()):
                margins.append(float((a - b)[keep].min()))

    transition, finalize = D.beam_transition, D.beam_finalize

    def spied_transition(live_scores, live_tokens, fin_scores, fin_tokens, last_logp, t, **kw):
        out = transition(live_scores, live_tokens, fin_scores, fin_tokens, last_logp, t, **kw)
        b, k = live_scores.shape
        logp = last_logp.clone()
        if t < kw["min_new_tokens"]:
            logp[..., kw["eos_token_id"]] = D.NEG_INF
        cand = live_scores[:, :, None] + logp
        gap(cand.reshape(b, -1), k)
        gap(cand.reshape(b, -1), 2 * k)
        top, _, token = D._topk_2k_two_stage(cand, b, k, logp.shape[-1])
        is_eos = token == kw["eos_token_id"]
        gap(torch.where(is_eos, D.NEG_INF, top), k)
        div = float(kw["prompt_len"] + t + 1) ** kw["length_penalty"]
        rank_ok = torch.arange(2 * k, device=top.device)[None, :] < k
        gap(torch.cat([fin_scores, torch.where(is_eos & rank_ok, top / div, D.NEG_INF)], 1), k)
        return out

    def spied_finalize(live_scores, live_tokens, fin_scores, fin_tokens, **kw):
        div = float(kw["prompt_len"] + kw["max_new_tokens"]) ** kw["length_penalty"]
        gap(torch.cat([fin_scores, live_scores / div], dim=1), 1)
        return finalize(live_scores, live_tokens, fin_scores, fin_tokens, **kw)

    D.beam_transition, D.beam_finalize = spied_transition, spied_finalize
    try:
        run() if run is not None else decoded_tokens(e, gen_kwargs, [prompt], icv_scaled)
    finally:
        D.beam_transition, D.beam_finalize = transition, finalize
    return min(margins) if margins else math.inf


def beam_near_tie_check(e: EvalSetup, tag: str, gen_kwargs: dict, prompts: list, static: list,
                        engine: list, icv_scaled) -> int:
    """Engine beam tokens against the static beam search's: equal, or the
    static search took some decision at an f32 margin under ``NEAR_TIE``
    (``beam_min_margin``).  Returns the number of such questions."""
    n = 0
    for q, (p, a, b) in enumerate(zip(prompts, static, engine, strict=True)):
        if bool((a == b).all()):
            continue
        margin = beam_min_margin(e, gen_kwargs, p, icv_scaled)
        log(f"{tag}: question {q} differs from the static beam ({a.tolist()} vs "
            f"{b.tolist()}); the static search's smallest f32 decision margin {margin:.6f} "
            f"(limit {NEAR_TIE})")
        if not margin < NEAR_TIE:
            raise AssertionError(f"{tag}: the engine's beam differs away from a near tie")
        n += 1
    return n


def counted_run(e: EvalSetup, run, counters: dict, spy_cm) -> tuple:
    """``run()`` once to warm up, then once counted and timed inside the
    spy ``spy_cm()``: ``(results, wall s, launches, peak GiB, the spy)``."""
    import torch

    dev = e.bundle.device
    run()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters.values():
        fn.launches = 0
    with spy_cm() as spy:
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in counters.items()}
    return res, wall, counts, torch.cuda.max_memory_allocated(dev) / 2**30, spy


def timed_static(e: EvalSetup, gen_kwargs: dict, prompts: list, icv_scaled) -> tuple:
    """The static path's tokens of ``prompts`` at bs 1 and its s/question."""
    import torch

    t0 = time.perf_counter()
    static = decoded_tokens(e, gen_kwargs, prompts, icv_scaled)
    torch.cuda.synchronize()
    return static, (time.perf_counter() - t0) / len(prompts)


def engine_run(e: EvalSetup, tag: str, run, prompts: list, gen_kwargs: dict, icv_scaled,
               counters: dict, check=None) -> dict:
    """One configuration of phase 4d: ``run()`` (a runner entry point) once
    to warm up, then once counted and timed; its launches against
    ``predicted_engine_launches``; the static path's tokens at bs 1 (timed)
    and the near-tie rule (``check(static, engine)``, which returns the
    number of questions that differ, in its place where given).  Returns
    the counted run's launches, the engine and its tokens."""
    b = e.bundle
    res, wall, counts, peak, spy = counted_run(e, run, counters, engine_spy)
    step_ms = spy.step_ms()
    (engine, out), = spy.runs
    want = predicted_engine_launches(b.model_cfg, engine, spy.binds, icv_scaled is not None,
                                     b.device)
    n = len(prompts)
    static, static_s = timed_static(e, gen_kwargs, prompts, icv_scaled)
    tokens = engine_tokens(out, n, b.pad_token_id)
    n_tok = sum(len(x) for x in out.values())
    step = ("not measured (no card)" if step_ms is None
            else f"{step_ms:.2f} ms (CUDA events around the chunks)")
    first = f", the first at {spy.first_sync}" if spy.first_sync else ""
    log(f"{tag}: {n} requests, {wall / n:.3f} s/question (static bs=1 {static_s:.3f}), "
        f"{n_tok / wall:.1f} tokens/s; {len(engine.admissions)} admissions "
        f"{engine.admissions} (size, bucket), {engine.merged_admits} of them "
        f"merged, {engine.steps_run} decode steps of "
        f"{engine.n_rows} rows over {engine.cache_len} cache columns, a step {step}; "
        f"launches {counts} (predicted {want}); peak device memory {peak:.2f} GiB; "
        f"synchronizing CUDA calls inside decode chunks {spy.syncs} (predicted 0){first}")
    log(f"{tag} predictions {[r['prediction'] for r in res.values()]}")
    if len(res) != n or not all(isinstance(r["prediction"], str) for r in res.values()):
        raise AssertionError(f"{tag}: malformed results {res}")
    for k, v in want.items():
        if counts[k] != v:
            raise AssertionError(f"{tag}: {k} launched {counts[k]} != {v}")
    if spy.syncs:
        raise AssertionError(f"{tag}: {spy.syncs} synchronizing CUDA calls inside decode chunks")
    if check is not None:
        ties = check(static, tokens)
    elif int(gen_kwargs.get("num_beams", 1)) > 1:
        ties = beam_near_tie_check(e, tag, gen_kwargs, prompts, static, tokens, icv_scaled)
    else:
        ties = near_tie_check(e, tag, prompts, static, tokens, icv_scaled)
    log(f"{tag} tokens: {n - ties} of {n} requests equal the static path's, {ties} differ "
        f"at a near tie")
    return {"counts": counts, "engine": engine, "tokens": out, "s_per_q": wall / n,
            "static_s_per_q": static_s, "binds": spy.binds, "peak_gib": peak}


def continuous_path(e: EvalSetup) -> dict:
    """Phase 4d (a)-(c) on phase 4's Idefics-9B.  Returns the launch counts."""
    from licv_vqa_tpu_torch.infer.runner import icl_inference_continuous, icv_inference_continuous

    b = e.bundle
    counters = engine_counters()
    rows = e.val[1 : 1 + N_ICV_Q]
    icv_prompts = [icv_prompt(e, q) for q in range(1, 1 + N_ICV_Q)]
    greedy_kw = dict(e.gen_kwargs, num_beams=1)
    # (c): request q asks val row q % rows with shots q .. q + n - 1
    icl_rows = [e.val[q % len(e.val)] for q in range(len(CONT_ICL_SHOTS))]
    icl_shots = [list(range(q, q + n)) for q, n in enumerate(CONT_ICL_SHOTS)]
    icl_prompts = [icl_prompt(e, q % len(e.val), s) for q, s in enumerate(icl_shots)]
    runs = (
        ("continuous beam-3 test_icv", e.gen_kwargs, icv_prompts, e.icv_scaled,
         lambda: icv_inference_continuous(rows, b, e.pm, e.gen_kwargs, e.instruction,
                                          e.icv_scaled, False, CONT_BEAM_SLOTS)),
        ("continuous greedy test_icv", greedy_kw, icv_prompts, e.icv_scaled,
         lambda: icv_inference_continuous(rows, b, e.pm, greedy_kw, e.instruction,
                                          e.icv_scaled, False, CONT_GREEDY_SLOTS)),
        (f"continuous greedy test_icl {CONT_ICL_SHOTS} shots", greedy_kw, icl_prompts, None,
         lambda: icl_inference_continuous(e.train, icl_rows, icl_shots, b, e.pm, greedy_kw,
                                          e.instruction, False, CONT_ICL_SLOTS)),
    )
    total = dict.fromkeys(counters, 0)
    for tag, kw, prompts, icv, run in runs:
        got = engine_run(e, tag, run, prompts, kw, icv, counters)
        for k, v in got["counts"].items():
            total[k] += v
        total.setdefault("beam_s_per_q", got["s_per_q"])  # (a)'s, for phase 4e
    return total


def drift_tie_check(e: EvalSetup, tag: str, prompts: list, static: list, engine: list,
                    icv_scaled, engine_logits=None) -> int:
    """Greedy engine tokens against the static path's: equal, or first
    differing where the static decode's f32 top-2 gap is under ``NEAR_TIE``
    or under twice the static path's own batch drift there (the max-abs
    difference of its logits for that token between bs 1 and the
    questions decoded together, ``forced_decode_logits``): a bf16 drift of
    that size flips the token in a static batch as in the engine.  With
    ``engine_logits(q, t)`` (``engine_logits_recorder``) the engine's own
    logits for that token are printed against the static path's.  Returns
    the number of such questions."""
    n = 0
    for q, (p, a, t) in enumerate(zip(prompts, static, engine, strict=True)):
        diff = (a != t).nonzero()
        if not len(diff):
            continue
        at = int(diff[0])
        want = forced_decode_logits(e, [p], [a[:at]], icv_scaled)[0]
        # the questions decoded together along the static tokens: the
        # static path's own batch drift
        batch = forced_decode_logits(e, prompts, [aj[:at] for aj in static], icv_scaled)[q]
        drift = float((batch - want).abs().max())
        top = want.topk(2).values
        gap = float(top[0] - top[1])

        def rel(x):
            return float((x - want).norm() / want.norm())

        own = ""
        if engine_logits is not None:
            got = engine_logits(q, at).to(want.device)
            own = (f"; the engine's: rel. L2 {rel(got):.4e}; its max-abs "
                   f"{float((got - want).abs().max()):.4f}")
        log(f"{tag}: question {q} differs from the static path at token {at} "
            f"({a.tolist()} vs {t.tolist()}); the static f32 top-2 gap there {gap:.6f}; "
            f"the static path's logits there at bs {len(prompts)} against bs 1: max-abs "
            f"{drift:.4f}, rel. L2 {rel(batch):.4e}{own}; limit: the gap under {NEAR_TIE} "
            f"or under twice that drift")
        if not gap < max(NEAR_TIE, 2 * drift):
            raise AssertionError(f"{tag}: the engine differs from the static path where the "
                                 f"static path's own batch drift cannot flip the token")
        n += 1
    return n


def continuous_int8(e: EvalSetup, opts: list, tag: str = "continuous int8") -> dict:
    """Phase 4d (d) on run A's int8 model: ``test_icv`` greedy through the
    engine with ``CONT_GREEDY_SLOTS`` slots.  Inside the decode chunks (the
    admissions excluded) the int8 kernel launches at M = the pool's rows
    alone (every step's projections and head), as many as the decode steps
    times ``predicted_quantized_launches``'s per-step term.  The tokens
    against the static path's: equal, or first differing where the static
    decode's f32 top-2 gap is under ``NEAR_TIE`` or under twice the static
    path's own batch drift there (the max-abs difference of its logits for
    that token between bs 1 and the questions decoded together,
    ``forced_decode_logits``): w8a8 rounds every activation row and the
    int8 KV cache every cached row to 127 steps, so a bf16 drift can move a
    value a whole step, in a static batch as in the engine.  Printed beside it: the engine's logits for that
    token (``engine_logits_recorder``) against the static path's."""
    from licv_vqa_tpu_torch.infer.runner import icv_inference_continuous
    from licv_vqa_tpu_torch.infer.serving import ServingEngine
    from licv_vqa_tpu_torch.ops import int8_matmul as I8

    b = e.bundle
    kernel, chunk, rows_seen, inside = I8.int8_matmul, ServingEngine._chunk, [], []

    def counted(x, *a, **kw):
        if inside:
            rows_seen.append(x.shape[0])
        return kernel(x, *a, **kw)

    def traced_chunk(self):
        inside.append(1)
        try:
            return chunk(self)
        finally:
            inside.clear()

    counters = dict(engine_counters(), int8_matmul=counted)
    greedy_kw = dict(e.gen_kwargs, num_beams=1)
    rows = e.val[1 : 1 + N_ICV_Q]
    prompts = [icv_prompt(e, q) for q in range(1, 1 + N_ICV_Q)]
    recorded = {}

    def run():
        rows_seen.clear()  # the counted run's alone
        with engine_logits_recorder() as rec:
            out = icv_inference_continuous(rows, b, e.pm, greedy_kw, e.instruction,
                                           e.icv_scaled, False, CONT_GREEDY_SLOTS)
        recorded.update(rec)
        return out

    def check(static, engine):
        return drift_tie_check(e, tag, prompts, static, engine, e.icv_scaled,
                               recorded["logits"])

    # the wrapper adds its launches to the module's ``int8_matmul``: the spy
    # carries the count while it stands in
    counted.launches = kernel.launches
    I8.int8_matmul, ServingEngine._chunk = counted, traced_chunk
    try:
        got = engine_run(e, f"{tag} greedy test_icv", run, prompts, greedy_kw,
                         e.icv_scaled, counters, check=check)
    finally:
        I8.int8_matmul, ServingEngine._chunk = kernel, chunk
        kernel.launches = counted.launches
    engine = got["engine"]
    m = engine.n_rows

    def launches(max_new: int) -> int:
        return predicted_quantized_launches(b.model_cfg, "int8", opts, m, 1, 1, 1,
                                            max_new)["int8_matmul"]

    per_step = launches(2) - launches(1)
    at_m, want = rows_seen.count(m), engine.steps_run * per_step
    log(f"{tag}: int8 kernel launches inside decode chunks {len(rows_seen)}, at "
        f"M = {m} rows {at_m} (want {engine.steps_run} decode steps x {per_step} = {want})")
    if (at_m, len(rows_seen)) != (want, want):
        raise AssertionError(f"{tag}: int8 kernel launches in the decode chunks off "
                             "the decode steps")
    return got["counts"]


# phase 4e: the pooled beam eval chain (infer_engine=pooled) and merged
# admission on phase 4's model; (d) on run A's int8 model in phase 6.  (a)
# runs POOLED_ICV_Q questions in chunks of POOL_QUESTIONS
POOL_QUESTIONS = 4
POOLED_ICV_Q = 8
MERGED_REQUESTS = 16  # (c): through CONT_GREEDY_SLOTS slots, two waves of admissions


@contextlib.contextmanager
def chain_spy():
    """Records each pooled chain the runner makes and calls: its (questions,
    bucket, images a question, (height, width) of its pixels), its prompts
    (host copies, taken before the chain runs) and answers; brackets each
    merged forward with CUDA events (``merged_ms``: their mean interval,
    after a synchronize) and counts the synchronizing CUDA calls that
    ``set_sync_debug_mode("warn")`` reports inside a chain (the first one's
    source line kept); keeps, on the device, the live tokens and f32
    log-probabilities of every beam transition of a chain, in order (two an
    iteration: the finalize of the group answered, then all P groups)."""
    import warnings

    import torch

    from licv_vqa_tpu_torch.infer import eval_chain as EC

    spy = SimpleNamespace(chains=[], outputs=[], transitions=[], merged=0, events=[], syncs=0,
                          first_sync=None)
    make, transition = EC._make_pooled_chain, EC.beam_transition

    def recorded(live_s, live_t, fin_s, fin_t, last_logp, t, **kw):
        spy.transitions[-1].append((live_t.clone(), last_logp.clone()))
        return transition(live_s, live_t, fin_s, fin_t, last_logp, t, **kw)

    def merged_ms():
        if not spy.events:
            return None
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in spy.events) / len(spy.events)

    spy.merged_ms = merged_ms

    def spied_make(text_cfg, prefill, merged, axes, **kw):
        def timed_merged(*a):
            spy.merged += 1
            if a[1].device.type != "cuda":
                return merged(*a)
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            out = merged(*a)
            end.record()
            spy.events.append((start, end))
            return out

        chain = make(text_cfg, prefill, timed_merged, axes, **kw)

        def spied_chain(params, ids, mask, pixels, valid, icv):
            spy.chains.append((ids.shape[0], ids.shape[-1], pixels.shape[2],
                               tuple(pixels.shape[3:5])))
            spy.transitions.append([])
            host = (ids.cpu(), mask.cpu())
            if ids.device.type != "cuda":
                out = chain(params, ids, mask, pixels, valid, icv)
            else:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        out = chain(params, ids, mask, pixels, valid, icv)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
                spy.syncs += len(syncs)
                if syncs and spy.first_sync is None:
                    spy.first_sync = f"{syncs[0].filename}:{syncs[0].lineno}: {syncs[0].message}"
            spy.outputs.append((*host, out))
            return out

        return spied_chain

    EC._make_pooled_chain, EC.beam_transition = spied_make, recorded
    try:
        yield spy
    finally:
        EC._make_pooled_chain, EC.beam_transition = make, transition


def predicted_pooled_launches(mc, chains: list, with_icv: bool, dev, opts=None,
                              beams: int = 3) -> dict:
    """The ICV, tower and causal flash launches of the pooled chains
    ``chains`` ((questions, bucket, images, (height, width)) each), and
    with ``opts`` (an int8 Idefics build's lmm options) the int8 and w8a8
    ones.  A chain of n questions runs one prologue prefill and n + P
    merged forwards (P = max_new − 1), each of them a bind (the tower's
    layers once, ``tower_launches``) and a prefill lane; the ICV enters
    every layer of the prologue and of both lanes of every merged forward,
    the causal or ALiBi flash every layer of each where the bucket passes
    its gate (``prefill_flash``).  Int8 (``quant_routes``, the family's
    matmuls ``quant_matmuls``): the prologue as
    ``predicted_quantized_launches``'s prefill; a merged forward packs the
    decoder's projections over P·K + bucket rows, weight-only; its
    cross-attention blocks run per lane (P·K rows at one token, the
    bucket's rows at the bucket's tokens); its bind as the prologue's; the
    int8 head once over P·K + 1 rows."""
    t, v, pc = mc.text, mc.vision, mc.perceiver
    p = MAX_NEW - 1
    rows_d = p * beams
    out = dict.fromkeys(("icv_inject", "vit_attention", "flash_attention_bidir",
                         "flash_attention_fwd", "flash_alibi_attention"), 0)
    if opts is not None:
        out.update(int8_matmul=0, w8a8_matmul=0)
        takes, w8a8 = quant_routes(opts)
        dec, xat, kv_mms, groups = quant_matmuls(mc)
    for n, bucket, n_img, hw in chains:
        merged = n + p
        for k, binds in tower_launches(v, bind_patches(v, hw), dev).items():
            out[k] += binds * (1 + merged)
        for k, per_layer in prefill_flash(t, bucket, dev).items():
            out[k] += t.n_layers * (1 + merged) * per_layer
        if with_icv:
            out["icv_inject"] += t.n_layers * (1 + 2 * merged)
        if opts is None:
            continue
        pro = predicted_quantized_launches(mc, "int8", opts, 1, bucket, n_img, beams, 1)

        def xattn(rows, tokens):  # a cross-attention block, its K/V bound
            return sum(takes(rows, tokens, k, True) for k in xat)

        n_k, packed = n_img * pc.n_latents, rows_d + bucket
        int8 = (t.n_layers * sum(takes(packed, None, k, True) for k in dec)
                + groups * (xattn(rows_d, 1) + xattn(bucket, bucket))
                + kv_mms * groups * takes(n_k, n_k, pc.d_model, True))
        a8 = groups * len(xat) * w8a8(bucket, True) + kv_mms * groups * w8a8(n_k, True)
        if "lmm.quantize_head=true" in opts and not t.tie_embeddings:
            int8 += takes(rows_d + 1, 1, t.d_model, True)
        if "lmm.quantize_vision=true" in opts:
            lat, np_ = pc.n_latents, v.n_patches
            int8 += (v.n_layers * 6 * takes(n_img * np_, None, v.d_model, True)
                     + pc.n_layers * (4 * takes(n_img * lat, lat, pc.d_model, True)
                                      + 2 * takes(n_img * (lat + np_), lat + np_, pc.d_model,
                                                  True)))
            a8 += pc.n_layers * (4 * w8a8(lat, True) + 2 * w8a8(lat + np_, True))
        out["int8_matmul"] += pro["int8_matmul"] + merged * int8
        out["w8a8_matmul"] += pro["w8a8_matmul"] + merged * a8
    return out


def chain_answers(e: EvalSetup, spy, prompts: list) -> list:
    """Each prompt's ``(tokens, chain, row)``: the chain that answered it
    and the row whose unpadded ids are the prompt's (padding repeats of a
    question answer as it does)."""
    import torch

    out = []
    for prompt in prompts:
        enc = e.bundle.processor.prepare_input([prompt], padding=True, padding_side="left")
        want = torch.from_numpy(enc["input_ids"][0][enc["attention_mask"][0] > 0].astype("int64"))
        for c, (ids, mask, toks) in enumerate(spy.outputs):
            hit = [r for r in range(ids.shape[0]) if torch.equal(
                ids[r, 0][mask[r, 0] > 0].long(), want)]
            if hit:
                out.append((toks[hit[0], 0].cpu().long(), c, hit[0]))
                break
        else:
            raise AssertionError("pooled: a question no chain answered")
    return out


def chain_logp(spy, chain: int, row: int, prefix):
    """(V,) f32: the log-probabilities the chain's search read after
    question ``row``'s tokens ``prefix`` (``chain_spy``'s transitions).
    Question r sits in group r mod P from iteration r: at age t < P its
    step is iteration r + t's transition of all groups, at t = P the
    finalize of iteration r + P; its beam is the row whose live tokens are
    ``prefix``.  None where no beam of the chain holds ``prefix``."""
    p, at = MAX_NEW - 1, len(prefix)
    calls = spy.transitions[chain]
    if at < p:
        live_t, logp = (x[row % p] for x in calls[2 * (row + at) + 1])
    else:
        live_t, logp = (x[0] for x in calls[2 * (row + p)])
    hit = (live_t[:, :at] == prefix.to(live_t)).all(dim=-1).nonzero()
    return logp[int(hit[0])] if len(hit) else None


def pooled_near_tie_check(e: EvalSetup, tag: str, spy, prompts: list, static: list,
                          icv_scaled) -> int:
    """Phase 4e's token rule: the pooled chain's tokens against the static
    beam's at bs 1.  Where a question differs, first at token ``at``, the
    chain's own f32 log-probabilities at that decision (``chain_logp``,
    along the static answer's first ``at`` tokens, which the chain's answer
    shares) are held against the static path's along the same prefix at
    bs 1 (``forced_decode_logits``): they pass where their max-abs
    difference is within twice the static path's own drift there between
    bs 1 and a batch of up to ``POOL_QUESTIONS`` questions (its neighbours
    in the run's order, along their static answers), or where the two answers' tokens lie under ``NEAR_TIE`` apart in the
    static log-probabilities.  Returns the number of such questions."""
    import torch

    answers = chain_answers(e, spy, prompts)
    n = 0
    for q, (p, a, (b, chain, row)) in enumerate(zip(prompts, static, answers, strict=True)):
        diff = (a != b).nonzero()
        if not len(diff):
            continue
        at = int(diff[0])
        q0 = q - q % POOL_QUESTIONS
        group = list(range(q0, min(q0 + POOL_QUESTIONS, len(prompts))))
        want = torch.log_softmax(forced_decode_logits(e, [p], [a[:at]], icv_scaled)[0], -1)
        batch = torch.log_softmax(forced_decode_logits(
            e, [prompts[j] for j in group], [static[j][:at] for j in group],
            icv_scaled)[q - q0], -1)
        got = chain_logp(spy, chain, row, a[:at])
        if got is None:
            raise AssertionError(f"{tag}: question {q}: no beam of the chain holds the static "
                                 f"answer's first {at} tokens")
        drift = float((batch - want).abs().max())
        err = float((got.to(want.device) - want).abs().max())
        gap = abs(float(want[int(a[at])] - want[int(b[at])]))
        log(f"{tag}: question {q} differs from the static beam at token {at} ({a.tolist()} "
            f"vs {b.tolist()}); there the chain's f32 log-probabilities against the static "
            f"path's at bs 1: max-abs {err:.4f}, the static path's own at bs {len(group)}: "
            f"{drift:.4f}; the two tokens' static f32 gap {gap:.6f}; limit: within twice that "
            f"drift, or the gap under {NEAR_TIE}")
        if not (err <= 2 * drift or gap < NEAR_TIE):
            raise AssertionError(f"{tag}: the chain's logits at the first differing token "
                                 f"are off the static path's beyond its own batch drift, "
                                 f"away from a near tie")
        n += 1
    return n


def pooled_run(e: EvalSetup, tag: str, run, prompts: list, icv_scaled, counters: dict,
               opts=None, beam_s=None) -> dict:
    """One configuration of phase 4e: ``run()`` (a runner entry point) once
    to warm up, then once counted and timed; its launches against
    ``predicted_pooled_launches``; the static beam path's tokens at bs 1
    (timed) under ``pooled_near_tie_check``.  Returns the launches."""
    b = e.bundle
    res, wall, counts, peak, spy = counted_run(e, run, counters, chain_spy)
    merged_ms = spy.merged_ms()
    want = predicted_pooled_launches(b.model_cfg, spy.chains, icv_scaled is not None, b.device,
                                     opts)
    n = len(prompts)
    static, static_s = timed_static(e, e.gen_kwargs, prompts, icv_scaled)
    fwd = ("not measured (no card)" if merged_ms is None
           else f"{merged_ms:.2f} ms (CUDA events around each)")
    engine = "" if beam_s is None else f", 4d's beam engine {beam_s:.3f}"
    first = f", the first at {spy.first_sync}" if spy.first_sync else ""
    log(f"{tag}: {n} questions, {wall / n:.3f} s/question (static beam bs=1 {static_s:.3f}"
        f"{engine}); chains (questions, bucket, images, pixels) {spy.chains}, {spy.merged} merged "
        f"forwards, a merged forward {fwd}; launches {counts} (predicted {want}); peak "
        f"device memory {peak:.2f} GiB; synchronizing CUDA calls inside the chains "
        f"{spy.syncs} (predicted 0){first}")
    log(f"{tag} predictions {[r['prediction'] for r in res.values()]}")
    if len(res) != n or not all(isinstance(r["prediction"], str) for r in res.values()):
        raise AssertionError(f"{tag}: malformed results {res}")
    for k, v in want.items():
        if counts[k] != v:
            raise AssertionError(f"{tag}: {k} launched {counts[k]} != {v}")
    if spy.syncs:
        raise AssertionError(f"{tag}: {spy.syncs} synchronizing CUDA calls inside the chains")
    ties = pooled_near_tie_check(e, tag, spy, prompts, static, icv_scaled)
    log(f"{tag} tokens: {n - ties} of {n} questions equal the static beam's, {ties} differ "
        f"within the rule")
    return counts


def pooled_path(e: EvalSetup, beam_s: float) -> dict:
    """Phase 4e (a)-(c) on phase 4's Idefics-9B; ``beam_s`` is 4d (a)'s
    s/question.  Returns the launch counts."""
    from licv_vqa_tpu_torch.infer.runner import icl_inference_pooled, icv_inference_pooled

    b = e.bundle
    counters = engine_counters()
    more = synthetic_vqa(MERGED_REQUESTS - len(e.val) + 1, 200, seed=5)
    rows = (e.val[1:] + more)[:POOLED_ICV_Q]
    icv_prompts = [row_prompt(e, r) for r in rows]
    icl_rows = [e.val[q % len(e.val)] for q in range(len(CONT_ICL_SHOTS))]
    icl_shots = [list(range(q, q + n)) for q, n in enumerate(CONT_ICL_SHOTS)]
    icl_prompts = [icl_prompt(e, q % len(e.val), s) for q, s in enumerate(icl_shots)]
    total = dict.fromkeys(counters, 0)
    for tag, prompts, icv, run in (
        (f"pooled beam-3 test_icv, chunks of {POOL_QUESTIONS}", icv_prompts, e.icv_scaled,
         lambda: icv_inference_pooled(rows, b, e.pm, e.gen_kwargs, e.instruction,
                                      e.icv_scaled, False, POOL_QUESTIONS)),
        # the same questions in one chain: P + 1 fewer forwards of warm-up
        # and drain
        (f"pooled beam-3 test_icv, one chunk of {POOLED_ICV_Q}", icv_prompts, e.icv_scaled,
         lambda: icv_inference_pooled(rows, b, e.pm, e.gen_kwargs, e.instruction,
                                      e.icv_scaled, False, POOLED_ICV_Q)),
        (f"pooled beam-3 test_icl {CONT_ICL_SHOTS} shots", icl_prompts, None,
         lambda: icl_inference_pooled(e.train, icl_rows, icl_shots, b, e.pm, e.gen_kwargs,
                                      e.instruction, False, POOL_QUESTIONS)),
    ):
        got = pooled_run(e, tag, run, prompts, icv, counters, beam_s=beam_s)
        for k, v in got.items():
            total[k] += v

    # (c) the greedy engine at the CLI's slot count, merged admission (its
    # own choice) against plain admission
    for k, v in merged_vs_plain(e, "", e.val[1:] + more, counters).items():
        total[k] += v
    return total


def merged_vs_plain(e: EvalSetup, prefix: str, rows: list, counters: dict) -> dict:
    """4e (c) and 7b (b): greedy ``test_icv`` on ``rows`` through the engine
    at the CLI's ``CONT_GREEDY_SLOTS`` slots, with merged admission (the
    engine's own choice on every admission into an occupied pool) and then
    plain (``plain_admission``), each as a 4d configuration under
    ``drift_tie_check``.  Returns the launch counts of both."""
    from licv_vqa_tpu_torch.infer.runner import icv_inference_continuous

    greedy_kw = dict(e.gen_kwargs, num_beams=1)
    prompts = [row_prompt(e, r) for r in rows]
    s_per_q, total, recorded = {}, dict.fromkeys(counters, 0), {}

    def run():
        with engine_logits_recorder() as rec:
            out = icv_inference_continuous(rows, e.bundle, e.pm, greedy_kw, e.instruction,
                                           e.icv_scaled, False, CONT_GREEDY_SLOTS)
        recorded.update(rec)  # the counted run's, the last
        return out

    for merged in (True, False):
        tag = (f"{prefix}{'merged' if merged else 'plain'} admission greedy test_icv, "
               f"{CONT_GREEDY_SLOTS} slots")
        with contextlib.nullcontext() if merged else plain_admission():
            got = engine_run(e, tag, run, prompts, greedy_kw, e.icv_scaled, counters,
                             check=lambda static, tokens, tag=tag: drift_tie_check(
                                 e, tag, prompts, static, tokens, e.icv_scaled,
                                 recorded["logits"]))
        if merged != (got["engine"].merged_admits > 0):
            raise AssertionError(f"{tag}: merged_admits {got['engine'].merged_admits}")
        s_per_q[merged] = got["s_per_q"]
        for k, v in got["counts"].items():
            total[k] += v
    log(f"{prefix}merged admission: {s_per_q[True]:.3f} s/question against plain "
        f"admission's {s_per_q[False]:.3f} ({CONT_GREEDY_SLOTS} slots, {len(rows)} greedy "
        f"test_icv questions)")
    return total


@contextlib.contextmanager
def plain_admission():
    """``ServingEngine.from_bundle`` without the merged function inside:
    every admission plain (4e (c)'s comparison)."""
    from licv_vqa_tpu_torch.infer.serving import ServingEngine

    make = ServingEngine.__dict__["from_bundle"]

    def plain(cls, bundle, **kw):
        return make.__func__(cls, bundle, merged_admit_fn=None, **kw)

    ServingEngine.from_bundle = classmethod(plain)
    try:
        yield
    finally:
        ServingEngine.from_bundle = make


def pooled_int8(e: EvalSetup, opts: list) -> dict:
    """Phase 4e (d) on run A's int8 model (int8 weights, head and tower, the
    int8 KV cache), ``N_ICV_Q`` ``test_icv`` questions in one chunk.  The
    merged forward is weight-only where the static prefill under
    ``lmm.w8a8_prefill`` takes w8a8, so both run here on a view of the
    bundle with w8a8 off (the same int8 weights; the bind rebuilt from the
    configuration): a question then differs from the static beam only at
    a near tie.  The int8 launches against ``predicted_pooled_launches``
    (the packed projections' P·K + bucket rows pass ``KERNEL_MAX_ROWS`` and
    take the scale-on-output route)."""
    from licv_vqa_tpu_torch.infer.runner import icv_inference_pooled
    from licv_vqa_tpu_torch.models import idefics as I
    from licv_vqa_tpu_torch.ops import int8_matmul as I8

    b = e.bundle
    mc = b.model_cfg
    mc = dataclasses.replace(mc, text=dataclasses.replace(mc.text, w8a8_prefill=False))
    _, raw_bind = I.make_idefics_forward_fns(mc, b.eos_token_id)

    def bind(params, pixels, *a, **kw):
        return raw_bind(params, b.model_pixels(pixels), *a, **kw)

    e = dataclasses.replace(e, bundle=dataclasses.replace(b, model_cfg=mc, bind_decode=bind))
    opts = [o for o in opts if o != "lmm.w8a8_prefill=true"]
    counters = dict(engine_counters(), int8_matmul=I8.int8_matmul,
                    w8a8_matmul=I8.w8a8_matmul)
    rows = e.val[1: 1 + N_ICV_Q]
    return pooled_run(
        e, "pooled int8 beam-3 test_icv (w8a8 off)",
        lambda: icv_inference_pooled(rows, e.bundle, e.pm, e.gen_kwargs, e.instruction,
                                     e.icv_scaled, False, N_ICV_Q),
        [row_prompt(e, r) for r in rows], e.icv_scaled, counters, opts)


@contextlib.contextmanager
def engine_logits_recorder():
    """Keeps, on the device, the f32 logits of every admission prefill and
    decode step (plain or merged) of the greedy engine runs inside, with
    each row's token count and each request's slot and tenure (a slot may
    hold several requests in turn).  Yields a dict whose
    ``"logits"(uid, t)`` is the logits vector the engine took token ``t``
    of request ``uid`` from."""
    from licv_vqa_tpu_torch.infer.serving import ServingEngine

    admit, scatter, update = (ServingEngine._admit_group, ServingEngine._scatter_admit,
                              ServingEngine._update)
    # uid -> [slot, its group's prefill, the first and past-the-last step
    # of its tenure]; slot -> its current request
    tenure, holder, prefills, steps = {}, {}, [], []

    def spied_admit(self, group, slots, bucket):
        for r, slot in zip(group, slots):
            if slot in holder:
                tenure[holder[slot]][3] = len(steps)
            holder[slot] = r.uid
            tenure[r.uid] = [slot, len(prefills), len(steps), None]
        return admit(self, group, slots, bucket)

    def spied_scatter(self, rows, bucket, last, *a, **kw):
        prefills.append((rows[:, 0].clone(), last.clone()))
        return scatter(self, rows, bucket, last, *a, **kw)

    def spied_update(self, logits, emit, adv, *a):
        steps.append((self._state["tok_count"].clone(), adv.clone(), logits.clone()))
        return update(self, logits, emit, adv, *a)

    def logits(uid, t):
        row, pre, first, end = tenure[uid]
        if t == 0:
            rows, last = prefills[pre]
            return last[int((rows == row).nonzero()[0])]
        for count, adv, lg in steps[first:end]:  # the step that forwarded token t - 1
            if int(adv[row]) == 1 and int(count[row]) == t - 1:
                return lg[row]
        raise KeyError((uid, t))

    ServingEngine._admit_group = spied_admit
    ServingEngine._scatter_admit = spied_scatter
    ServingEngine._update = spied_update
    try:
        yield {"logits": logits}
    finally:
        ServingEngine._admit_group, ServingEngine._scatter_admit = admit, scatter
        ServingEngine._update = update


# the RICE phase: CLIP ViT-B/32 at its published widths, random f32 weights;
# an index of RICE_INDEX_ROWS question rows over RICE_IMAGES images (each in
# RICE_INDEX_ROWS / RICE_IMAGES rows, so equal images tie) and RICE_TEST_ROWS
# test rows, the first half of them on index images
RICE_IMAGES = 2048
RICE_INDEX_ROWS = 4096
RICE_TEST_ROWS = 256
RICE_BATCH = 8
RICE_TEXT_ROWS = 64
RICE_FEATURE_TOL = 1e-5  # kernel path vs plain path, rel. L2 of each feature row
RICE_GAP_TOL = 1e-6  # a differing rank is allowed only under this f32 score gap


def rice_rows(dev, side: int):
    """(index rows, test rows): VQA rows whose uint8 ``side`` x ``side``
    images are made on the device from a seed and brought to the host
    once."""
    import torch

    g = torch.Generator(device=dev).manual_seed(7)
    n_new = RICE_TEST_ROWS - RICE_TEST_ROWS // 2
    imgs = torch.randint(0, 256, (RICE_IMAGES + n_new, side, side, 3), generator=g,
                         device=dev, dtype=torch.uint8).cpu().numpy()
    answers = ["red", "blue", "two", "cat", "yes", "no"]

    def row(i, img):
        ans = answers[i % len(answers)]
        return {"question_id": 10_000 + i, "image": img, "question": f"What is thing {i}?",
                "answer": ans, "answers": [{"answer": ans, "answer_id": 1}],
                "question_type": "what", "answer_type": "other"}

    index = [row(i, imgs[i % RICE_IMAGES]) for i in range(RICE_INDEX_ROWS)]
    test = [row(RICE_INDEX_ROWS + j, imgs[3 * j] if j < RICE_TEST_ROWS // 2
                else imgs[RICE_IMAGES + j - RICE_TEST_ROWS // 2])
            for j in range(RICE_TEST_ROWS)]
    return index, test


def rice_path(e: EvalSetup, dev, tmp: Path, cfg=None) -> dict:
    """Phase 4c: RICE retrieval with the port's ``MMTopkRetriever`` and its
    CLIP towers (``ClipTowerEncoder``) in f32 on the card, ``i2i``; the f32
    fused ViT kernel's launches, the kernel path against the plain one, the
    tie rule, the cache, the text tower, then the 32-shot indices of two
    test rows through ``icl_inference`` on phase 4's model.  ``cfg``: CLIP
    ViT-B/32 (its published widths, checked) unless given (the CPU
    rehearsal's tiny one).  Returns the launch counts."""
    import numpy as np
    import torch

    from licv_vqa_tpu_torch.data.processor import CLIP_MEAN, CLIP_STD
    from licv_vqa_tpu_torch.infer.runner import icl_inference
    from licv_vqa_tpu_torch.models import layers as L
    from licv_vqa_tpu_torch.models.clip import ClipConfig, clip_text_features, init_clip_params
    from licv_vqa_tpu_torch.retrieval.rice import ClipTowerEncoder, MMTopkRetriever

    published = cfg is None
    cfg = cfg or ClipConfig.vit_b32()
    v, t = cfg.vision, cfg.text
    widths = (v.image_size, v.patch_size, v.d_model, v.n_layers, v.n_heads, v.d_ff,
              t.vocab_size, t.max_positions, t.d_model, t.n_layers, t.n_heads, t.d_ff,
              cfg.projection_dim)
    if published and widths != (224, 32, 768, 12, 12, 3072, 49408, 77, 512, 12, 8, 2048, 512):
        raise AssertionError(f"not CLIP ViT-B/32's widths: {cfg}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("TF32 is on: the f32 towers and the product would not be f32")
    params = init_clip_params(torch.Generator(device=dev).manual_seed(3), cfg, dev)
    mean = torch.tensor(CLIP_MEAN, device=dev)
    std = torch.tensor(CLIP_STD, device=dev)

    def preprocess(images):  # uint8 HWC on the host -> normalized f32 NHWC on the card
        x = torch.from_numpy(np.stack(images)).to(dev, non_blocking=True)
        return (x.float() / 255.0 - mean) / std

    enc = ClipTowerEncoder(cfg, params, preprocess, batch_size=RICE_BATCH, device=dev)
    index, test = rice_rows(dev, v.image_size)
    cache = tmp / "cache" / f"vqav2_{RICE_TEST_ROWS}_rice_imgemb.pkl"

    def build(cache_file=None, encoder=enc):
        return MMTopkRetriever(index, test, mode="i2i", batch_size=RICE_BATCH,
                               cache_file=cache_file, encoder=encoder, device=dev)

    MMTopkRetriever(index[:16], test[:8], encoder=enc, device=dev).retrieve(1)  # warm-up
    L.vit_attention.launches_f32 = L.vit_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = build(str(cache))
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    launches = L.vit_attention.launches_f32
    t0 = time.perf_counter()
    one = r.retrieve(1)
    t_one = time.perf_counter() - t0
    t0 = time.perf_counter()
    top = r.retrieve(32)
    t_32 = time.perf_counter() - t0
    n_enc = RICE_INDEX_ROWS + RICE_TEST_ROWS
    want = v.n_layers * math.ceil(n_enc / RICE_BATCH)
    log(f"RICE (CLIP {v.d_model}-wide tower, f32, i2i): encoded {n_enc} images in {t_enc:.2f} s "
        f"({n_enc / t_enc:.1f} images/s); retrieve(1) {t_one:.4f} s, retrieve(32) "
        f"{t_32:.4f} s; f32 vit_attention launches {launches} (want {v.n_layers} x "
        f"{math.ceil(n_enc / RICE_BATCH)} = {want}), bf16 {L.vit_attention.launches}")
    if launches != want or L.vit_attention.launches:
        raise AssertionError("RICE: f32 fused ViT launches != layers x batches")
    if one != [row[:1] for row in top]:
        raise AssertionError("RICE: the 1-shot result is not the 32-shot one's first column")
    if dev.type == "cuda":
        some = [x["image"] for x in index[: 8 * RICE_BATCH]]
        profile_question(lambda: enc.encode_images(some), "RICE encode",
                         what=f"{len(some)} images")

    # the plain path: the same towers with the fused ViT route off
    cache_plain = tmp / "cache_plain" / cache.name
    os.environ["LICV_VIT_FUSED_ATTN"] = "0"
    try:
        plain = build(str(cache_plain))
    finally:
        os.environ.pop("LICV_VIT_FUSED_ATTN", None)
    raw, raw_plain = (torch.load(f, weights_only=False) for f in (cache, cache_plain))
    for side in ("index", "test"):
        a, b_ = (torch.from_numpy(np.asarray(x[side])) for x in (raw, raw_plain))
        rel = ((a - b_).norm(dim=1) / b_.norm(dim=1)).max().item()
        log(f"RICE {side} features, kernel vs plain path: worst row rel. L2 {rel:.3e} "
            f"(limit {RICE_FEATURE_TOL})")
        if not rel <= RICE_FEATURE_TOL:
            raise AssertionError(f"RICE: {side} features disagree with the plain path")
    top_plain = plain.retrieve(32)
    scores = torch.from_numpy(r.test_feats) @ torch.from_numpy(r.index_feats).T
    differ, worst_gap = 0, 0.0
    for i, (a, b_) in enumerate(zip(top, top_plain, strict=True)):
        if a != b_:
            differ += 1
            at = next(j for j, (x, y) in enumerate(zip(a, b_)) if x != y)
            gap = abs(float(scores[i, a[at]] - scores[i, b_[at]]))
            worst_gap = max(worst_gap, gap)
            log(f"RICE test row {i}: rank {at} differs ({a[at]} vs {b_[at]}), f32 score gap "
                f"{gap:.3e}")
    log(f"RICE 32-shot indices, kernel vs plain path: {differ} of {RICE_TEST_ROWS} rows differ "
        f"(worst f32 score gap {worst_gap:.3e}, limit {RICE_GAP_TOL})")
    if not worst_gap < RICE_GAP_TOL:
        raise AssertionError("RICE: the kernel path ranks apart from the plain path")

    # ties: index rows of equal features, lower index first
    ties = 0
    for row in top:
        for a, b_ in zip(row, row[1:]):
            if np.array_equal(r.index_feats[a], r.index_feats[b_]):
                ties += 1
                if not a < b_:
                    raise AssertionError(f"RICE: a tie not lower index first: {row}")
    lead = sum(row[:2] == [3 * j, 3 * j + RICE_IMAGES]
               for j, row in enumerate(top[: RICE_TEST_ROWS // 2]))
    log(f"RICE ties: {ties} adjacent pairs of equal features, each lower index first; "
        f"{lead} of {RICE_TEST_ROWS // 2} test rows on an index image lead with its two rows")

    class NoEncode:
        def encode_images(self, images):
            raise AssertionError("RICE: a cache hit encoded images")

    if build(str(cache), NoEncode()).retrieve(32) != top:
        raise AssertionError("RICE: the reloaded cache ranks differently")

    # the text tower: causal, never the fused kernel
    g = torch.Generator(device=dev).manual_seed(9)
    lengths = torch.randint(2, t.max_positions + 1, (RICE_TEXT_ROWS,), generator=g, device=dev)
    ids = torch.randint(1, t.vocab_size - 1, (RICE_TEXT_ROWS, t.max_positions), generator=g,
                        device=dev)
    cols = torch.arange(t.max_positions, device=dev)[None, :]
    mask = (cols < lengths[:, None]).long()
    ids = torch.where(cols == lengths[:, None] - 1, t.vocab_size - 1, ids * mask)
    L.vit_attention.launches_f32 = L.vit_attention.launches = 0
    with torch.inference_mode():
        text = clip_text_features(cfg, params, ids, mask)
        os.environ["LICV_VIT_FUSED_ATTN"] = "0"
        try:
            text_plain = clip_text_features(cfg, params, ids, mask)
        finally:
            os.environ.pop("LICV_VIT_FUSED_ATTN", None)
    text_launches = L.vit_attention.launches_f32 + L.vit_attention.launches
    log(f"CLIP text tower: {RICE_TEXT_ROWS} rows of lengths {int(lengths.min())}-"
        f"{int(lengths.max())}, features {tuple(text.shape)}, fused ViT launches "
        f"{text_launches}, equal to the plain path: {torch.equal(text, text_plain)}")
    if text_launches or not torch.isfinite(text).all() or not torch.equal(text, text_plain):
        raise AssertionError("CLIP text tower: fused launches, or not the plain path")

    # the retrieved shots into the eval path of phase 4's model
    t0 = time.perf_counter()
    res = icl_inference(index, test[:N_ICL_Q], top[:N_ICL_Q], e.bundle, e.pm, 1, e.gen_kwargs,
                        e.instruction, progress=False)
    torch.cuda.synchronize()
    log(f"RICE 32-shot test_icl on {e.bundle.name}: {N_ICL_Q} questions in "
        f"{time.perf_counter() - t0:.2f} s; predictions {[x['prediction'] for x in res.values()]}")
    if len(res) != N_ICL_Q or not all(isinstance(x["prediction"], str) for x in res.values()):
        raise AssertionError(f"RICE test_icl: malformed results {res}")
    return {"vit_attention_f32": launches}


# phase 6's two runs: (mode, the lmm options, the eval paths run)
QUANT_RUNS = (
    # A: every quantized option composed (tests/test_quantize.py:110-129)
    ("int8", ["lmm.quantize=int8", "lmm.quantize_head=true", "lmm.kv_cache=int8",
              "lmm.w8a8_prefill=true", "lmm.quantize_vision=true"], ("icv", "icl")),
    # B: the head left bf16, so this run launches only the int4 kernel
    ("int4", ["lmm.quantize=int4"], ("icv",)),
)
# phase 6's OpenFlamingo-9B run: int8 weights, the int8 KV cache under ALiBi
# and w8a8 prefill (the head stays the tied bf16 table; the tower bf16);
# test_icl on one question
QUANT_FLAMINGO = ("int8", ["lmm.quantize=int8", "lmm.kv_cache=int8", "lmm.w8a8_prefill=true"],
                  ("icv", "icl"))
QUANT_FLAMINGO_ICL_Q = 1


def quant_routes(opts: list) -> tuple:
    """``(takes, w8a8)`` under the lmm options ``opts``, from ``qdot``'s
    routes: ``takes(rows, tokens, k, int8)`` is 1 if one matmul of ``rows``
    rows in a block of ``tokens`` tokens (None: a weight-only call, never
    w8a8) with ``k`` in-features launches the int8 (``int8``) or int4
    kernel, and ``w8a8(tokens, int8)`` 1 if it takes w8a8."""
    from licv_vqa_tpu_torch.models.decoder import W8A8_MIN_TOKENS
    from licv_vqa_tpu_torch.ops.int8_matmul import KERNEL_MAX_ROWS
    from licv_vqa_tpu_torch.ops.quantize import _int4_group

    a8 = "lmm.w8a8_prefill=true" in opts

    def w8a8(tokens, int8: bool) -> int:
        return int(int8 and a8 and tokens is not None and tokens >= W8A8_MIN_TOKENS)

    def takes(rows: int, tokens, k: int, int8: bool) -> int:
        if rows > KERNEL_MAX_ROWS or w8a8(tokens, int8):
            return 0
        if int8:
            return 1
        return int((k // 2) % _int4_group(k) == 0)

    return takes, w8a8


def quant_matmuls(mc) -> tuple:
    """``(decoder layer's in-features, cross-attention block's, the bind's
    K/V matmuls a block, blocks)`` of a family's quantized matmuls (the
    in-features decide int4's route).  Idefics: wq wk wv wo, gate up (K =
    d_model) and down (K = d_ff) a layer; wq wo gate up, down a block, its
    K/V two matmuls (wk, wv), a block every ``cross_layer_interval``
    layers.  OpenFlamingo: MPT's wq wk wv wo and up (K = d_model) and down
    (K = d_ff); wq, wo (K = the block's heads' width), ff up and ff down (K
    = ``xattn_ff_mult`` · d_model), its K/V one matmul (wkv), a block every
    ``cross_attn_every_n_layers`` layers."""
    t = mc.text
    if hasattr(mc, "cross_attn_every_n_layers"):
        heads = mc.xattn_heads * mc.xattn_head_dim
        return ([t.d_model] * 5 + [t.d_ff],
                [t.d_model, heads, t.d_model, mc.xattn_ff_mult * t.d_model], 1,
                t.n_layers // mc.cross_attn_every_n_layers)
    return ([t.d_model] * 6 + [t.d_ff], [t.d_model] * 4 + [t.d_ff], 2,
            t.n_layers // mc.cross_layer_interval)


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
    Per forward, the family's matmuls (``quant_matmuls``): each decoder
    layer's projections and each cross-attention block's with its bound
    K/V.  The prefill has bs·s_prompt rows and s_prompt tokens; each of
    the max_new − 1 beam steps has bs·beams rows and 1 token (the last
    token needs no forward).  The bind-time K/V (Idefics' wk and wv a
    block, OpenFlamingo's wkv) has bs·n_img·n_latents rows and
    n_img·n_latents tokens.  The int8 head
    (``quantize_head``, int8 in either mode) has bs rows at the prefill (its
    last position) and bs·beams per step.  The int8 tower
    (``quantize_vision``) runs 6 projections per layer on bs·n_img·n_patches
    rows; the perceiver 4 per block on its latents (bs·n_img·n_latents rows,
    n_latents tokens) and 2 on latents and patches together."""
    takes, w8a8 = quant_routes(opts)
    t, v, p = mc.text, mc.vision, mc.perceiver
    dec, xat, kv_mms, groups = quant_matmuls(mc)
    int8 = mode == "int8"

    def stacks(rows: int, tokens: int) -> int:
        return (t.n_layers * sum(takes(rows, tokens, k, int8) for k in dec)
                + groups * sum(takes(rows, tokens, k, int8) for k in xat))

    n_k = n_img * p.n_latents
    n = (stacks(bs * s_prompt, s_prompt) + (max_new - 1) * stacks(bs * beams, 1)
         + kv_mms * groups * takes(bs * n_k, n_k, p.d_model, int8))
    per_stack = t.n_layers * len(dec) + groups * len(xat)
    out = {"int8_matmul": n if int8 else 0, "int4_matmul": 0 if int8 else n,
           "w8a8_matmul": (per_stack * (w8a8(s_prompt, int8) + (max_new - 1) * w8a8(1, int8))
                           + kv_mms * groups * w8a8(n_k, int8))}
    if "lmm.quantize_head=true" in opts and not t.tie_embeddings:
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
                   lmm: str = "idefics-9B", icl_q=None) -> dict:
    """Phase 6, one run: the weight-quantized eval at full width through the
    runner entry points (``icl_q`` questions of ``test_icl`` where given,
    else ``N_ICL_Q``), then, under
    int8, Idefics' draft, engine and pooled chain runs, or OpenFlamingo's
    engine run.  Returns the launch counts of the run."""
    import torch

    from licv_vqa_tpu_torch.models import layers as L
    from licv_vqa_tpu_torch.ops import flash_alibi as FA
    from licv_vqa_tpu_torch.ops import int4_matmul as I4
    from licv_vqa_tpu_torch.ops import int8_matmul as I8
    from licv_vqa_tpu_torch.ops.icv_inject import icv_inject

    e = eval_setup(dev, tmp, opts, lmm)
    b = e.bundle
    flamingo = "flamingo" in lmm.lower()
    tag = f"{mode} {lmm}" if flamingo else mode
    n_layers = b.model_cfg.text.n_layers
    counters = {"int8_matmul": I8.int8_matmul, "int4_matmul": I4.int4_matmul,
                "w8a8_matmul": I8.w8a8_matmul, "icv_inject": icv_inject,
                "flash_attention_fwd": L.flash_attention, "vit_attention": L.vit_attention,
                "flash_alibi_attention": FA.flash_alibi_attention}
    vit_bind = vit_per_bind(b.model_cfg.vision, b.device)
    beams = int(e.gen_kwargs["num_beams"])
    runs = eval_runs(e)
    if icl_q is not None:
        runs["icl"] = runs["icl"][:2] + (icl_q,)
    # warm-up on one question of each path
    runs["icv"][0](e.val[:1])
    if "icl" in paths:
        runs["icl"][0](e.val[:1], e.shots[:1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    total = dict.fromkeys(counters, 0)
    for path in paths:
        run, prompt, n_q = runs[path]
        want = dict.fromkeys(("int8_matmul", "int4_matmul", "w8a8_matmul",
                              "flash_attention_fwd", "flash_alibi_attention"), 0)
        for q in range(1, 1 + n_q):
            enc = b.processor.prepare_input([prompt(q)], padding=True, padding_side="left")
            s_prompt = enc["input_ids"].shape[1]
            for k, v in predicted_quantized_launches(
                b.model_cfg, mode, opts, 1, s_prompt, enc["pixel_values"].shape[1], beams,
                MAX_NEW,
            ).items():
                want[k] += v
            for k, v in prefill_flash(b.model_cfg.text, s_prompt, dev).items():
                want[k] += n_layers * v
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
        log(f"{tag} test_{path}: {n_q} questions, {dt * 1e3:.1f} ms/question; launches "
            f"{counts} (int8/int4/w8a8/flash predicted {want}), torch._int_mm calls "
            f"{len(int_mm_calls)}; predictions "
            f"{[r['prediction'] for r in res.values()]}, VQA accuracy "
            f"{vqa_accuracy(res, rows, tmp, f'{mode}_{path}'):.2f} (random weights)")
        for k, v in want.items():
            if counts[k] != v:
                raise AssertionError(f"{tag} test_{path}: {k} launched {counts[k]} != {v}")
        if int_mm_calls:
            raise AssertionError(f"{tag} test_{path}: torch._int_mm called on the main path")
        if path == "icv" and counts["icv_inject"] != n_layers * n_q * MAX_NEW:
            raise AssertionError("icv_inject launch count != 32 x forward passes")
        if counts["vit_attention"] != vit_bind * n_q:  # one bind a question
            raise AssertionError(f"{tag} test_{path}: vit_attention launched "
                                 f"{counts['vit_attention']} != {vit_bind} x {n_q}")
        if len(res) != n_q or not all(isinstance(r["prediction"], str) for r in res.values()):
            raise AssertionError(f"{tag} test_{path}: malformed results {res}")
        for k in total:
            total[k] += counts[k]
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"{tag}: peak device memory over the runs {peak:.2f} GiB (the bf16 build's is "
        f"phase {8 if flamingo else 4}'s)")
    if (mode, opts) == QUANT_RUNS[0][:2] and not flamingo:
        PHASE11_REFS["d"] = int8_tp_reference(e)
    if mode == "int8":
        extra = [continuous_int8(e, opts, f"continuous {tag}")]
        if not flamingo:
            total["int8_matmul"] += speculative_int8(e)["int8_matmul"]
            extra.append(pooled_int8(e, opts))
        for counts in extra:
            for k, v in counts.items():  # the engines also count the tower's flash
                total[k] = total.get(k, 0) + v
    if dev.type == "cuda":
        profile_question(lambda: runs["icv"][0](e.val[1:2]), f"{tag} test_icv")
    kernel_vs_plain_logits(e, tag)
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
    """Launches in ONE bs=1 question (one bind of images of ``n_patches``
    patches, a prefill of ``s_prompt`` tokens, MAX_NEW - 1 beam steps): the
    tower's (``tower_launches``: the bidirectional flash kernel at every vision
    layer, as every NaViT image at full width is at least 1024 patches);
    the causal flash kernel at every decoder layer of the prefill when
    ``layers.flash_attention_usable`` holds (>= 256 tokens: test_icl's
    prompt, not test_icv's); the ICV injection at every decoder layer of
    every forward when the ICV is on."""
    from licv_vqa_tpu_torch.models import layers as L

    t = mc.text
    return {
        **tower_launches(mc.vision, n_patches, dev),
        "flash_attention_fwd": t.n_layers * L.flash_attention_usable(
            t, s_prompt, t.head_dim, dev),
        "icv_inject": t.n_layers * MAX_NEW if with_icv else 0,
    }


def idefics2_setup(dev, tmp: Path, lmm: str) -> EvalSetup:
    """Phase 4's set-up for an Idefics2 lmm, its rows' images of COCO's
    sizes: the ``test_icv`` questions at 640x480, the shots cycling all
    three."""
    e = eval_setup(dev, tmp, [], lmm)
    e.val = synthetic_vqa(N_ICV_Q + 1, 100, seed=1, sizes=COCO_SIZES[:1])
    e.train = synthetic_vqa(ICL_SHOTS + 8, 500, seed=2, sizes=COCO_SIZES)
    return e


def idefics2_path(dev, tmp: Path, lmm: str = "idefics2-8B-base") -> dict:
    """Phase 7: the Idefics2 eval at full width through the runner entry
    points, test_icv then test_icl.  Returns the launch counts of the run."""
    import torch

    from licv_vqa_tpu_torch.models import layers as L
    from licv_vqa_tpu_torch.ops.icv_inject import icv_inject

    e = idefics2_setup(dev, tmp, lmm)
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
    for k, v in idefics2_serving_path(e).items():
        total[k] = total.get(k, 0) + v
    PHASE11_REFS.setdefault("g", {})[lmm] = sp_family_reference(e, lmm)
    return total


# phase 7b: the engines, merged admission and the pooled chain on phase 7's
# Idefics2-8B-base.  (a) and (b) take images cycling COCO_SIZES (three NaViT
# mask shapes); (d) images of UNIFORM_SIZE, whole 112-pixel buckets, so no
# pixel is padded and the chain needs no mask
IDEFICS2_ENGINE_Q = 12
UNIFORM_SIZE = (672, 672)


def idefics2_serving_path(e: EvalSetup) -> dict:
    """Phase 7b (a)-(d) on phase 7's Idefics2-8B-base, with 4d's and 4e's
    checks (launches against ``predicted_engine_launches`` and
    ``predicted_pooled_launches``, no synchronizing call inside a chunk or
    a chain, the tokens against the static path's).  Returns the launch
    counts."""
    from licv_vqa_tpu_torch.infer.runner import icl_inference_continuous, icv_inference_continuous

    b = e.bundle
    counters = engine_counters()
    total = dict.fromkeys(counters, 0)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    # (a) beam-3 test_icv: the admission groups split by NaViT shape
    rows = synthetic_vqa(IDEFICS2_ENGINE_Q, 300, seed=7, sizes=COCO_SIZES)
    got = engine_run(e, "idefics2 continuous beam-3 test_icv", lambda: icv_inference_continuous(
        rows, b, e.pm, e.gen_kwargs, e.instruction, e.icv_scaled, False, CONT_BEAM_SLOTS),
        [row_prompt(e, r) for r in rows], e.gen_kwargs, e.icv_scaled, counters)
    shapes = sorted(set(got["binds"]))
    log(f"idefics2 continuous beam-3 test_icv: admission groups over the padded pixels "
        f"{shapes} (height, width)")
    if len(shapes) < 2:
        raise AssertionError("idefics2 (a): the admissions saw fewer than two NaViT shapes")
    add(got["counts"])
    beam_s = got["s_per_q"]

    # (b) greedy test_icv at the CLI's slots, merged against plain admission
    add(merged_vs_plain(e, "idefics2 ", synthetic_vqa(MERGED_REQUESTS, 400, seed=8,
                                                      sizes=COCO_SIZES), counters))

    # (c) beam-3 test_icl of mixed shots: the causal flash in the 32-shot
    # buckets' admission prefills, 33 images a bind
    icl_rows = [e.val[q % len(e.val)] for q in range(len(CONT_ICL_SHOTS))]
    icl_shots = [list(range(q, q + n)) for q, n in enumerate(CONT_ICL_SHOTS)]
    tag = f"idefics2 continuous beam-3 test_icl {CONT_ICL_SHOTS} shots"
    got = engine_run(e, tag, lambda: icl_inference_continuous(
        e.train, icl_rows, icl_shots, b, e.pm, e.gen_kwargs, e.instruction, False,
        CONT_ICL_SLOTS), [icl_prompt(e, q % len(e.val), s) for q, s in enumerate(icl_shots)],
        e.gen_kwargs, None, counters)
    log(f"{tag}: peak device memory {got['peak_gib']:.2f} GiB (a pool of "
        f"{got['engine'].n_rows} rows over {got['engine'].cache_len} cache columns)")
    add(got["counts"])

    # (d) the pooled chain on uniform-resolution questions
    rows = synthetic_vqa(POOLED_ICV_Q, 600, seed=9, sizes=(UNIFORM_SIZE,))
    add(pooled_run(e, f"idefics2 pooled beam-3 test_icv, one chunk of {POOLED_ICV_Q}",
                   lambda: uniform_pooled(e, rows),
                   [row_prompt(e, r) for r in rows], e.icv_scaled, counters, beam_s=beam_s))
    return total


def uniform_pooled(e: EvalSetup, rows: list) -> dict:
    """``icv_inference_pooled``'s results on ``rows`` of one resolution
    through the bundle's pooled chain (``eval_chain.pooled_eval_chain``),
    one chunk.  Idefics2's processor gives every image a pixel mask, which
    the runner's pooled route refuses (NaViT is engine-only, as in JAX);
    here every pixel is real, so the mask is dropped once it is checked to
    be all ones."""
    import numpy as np
    import torch

    from licv_vqa_tpu_torch.infer.eval_chain import pooled_eval_chain

    b = e.bundle
    encs = []
    for r in rows:
        enc = b.processor.prepare_input([row_prompt(e, r)], padding=True, padding_side="left")
        pam = enc.get("pixel_attention_mask")
        if pam is not None and not pam.all():
            raise AssertionError("uniform_pooled: a padded pixel")
        real = enc["attention_mask"][0] > 0
        encs.append((enc["input_ids"][0][real], enc["pixel_values"][0], enc["pixel_valid"][0]))
    if len({px.shape for _, px, _ in encs}) != 1:
        raise AssertionError("uniform_pooled: more than one pixel shape")
    bucket = max(-(-len(ids) // 64) * 64 for ids, _, _ in encs)
    ids = np.full((len(encs), 1, bucket), b.pad_token_id, np.int32)
    mask = np.zeros((len(encs), 1, bucket), np.int32)
    for i, (q, _, _) in enumerate(encs):  # left padding
        ids[i, 0, bucket - len(q):] = q
        mask[i, 0, bucket - len(q):] = 1
    px = np.stack([x[1] for x in encs])[:, None]
    pv = np.stack([x[2] for x in encs])[:, None]
    out = pooled_eval_chain(b, e.gen_kwargs)(
        *(torch.from_numpy(x).to(b.device) for x in (ids, mask, px, pv)), e.icv_scaled)
    return {i: {"prediction": b.tokenizer.batch_decode([toks[0]], skip_special_tokens=True)[0]}
            for i, toks in enumerate(out.cpu().numpy())}


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
        ids, mask, px, pv, kw = encoded(b, [prompt])
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
    for k, v in openflamingo_serving_path(e).items():
        total[k] = total.get(k, 0) + v
    PHASE11_REFS.setdefault("g", {})[lmm] = sp_family_reference(e, lmm)
    return total


# phase 8b: the engines, merged admission and the pooled chain on phase 8's
# OpenFlamingo-9B, on 224x224 images (CLIP's fixed size)
OPENFLAMINGO_ENGINE_Q = 12


def openflamingo_serving_path(e: EvalSetup) -> dict:
    """Phase 8b (a)-(d) on phase 8's OpenFlamingo-9B, with 4d's and 4e's
    checks (launches against ``predicted_engine_launches`` and
    ``predicted_pooled_launches``: the fused ViT at 24 layers a bind, the
    ALiBi flash at 32 layers of each admission prefill and each prologue or
    merged prefill lane of >= 128 tokens, the ICV at both lanes; no
    synchronizing call inside a chunk or a chain; the tokens against the
    static path's).  Returns the launch counts."""
    from licv_vqa_tpu_torch.infer.runner import (
        icl_inference_continuous,
        icl_inference_pooled,
        icv_inference_continuous,
        icv_inference_pooled,
    )
    from licv_vqa_tpu_torch.infer.serving import _leaves as tensors

    b = e.bundle
    counters = engine_counters()
    total = dict.fromkeys(counters, 0)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    # (a) beam-3 test_icv through the engine
    rows = synthetic_vqa(OPENFLAMINGO_ENGINE_Q, 300, seed=7)
    got = engine_run(
        e, "openflamingo continuous beam-3 test_icv", lambda: icv_inference_continuous(
            rows, b, e.pm, e.gen_kwargs, e.instruction, e.icv_scaled, False, CONT_BEAM_SLOTS),
        [row_prompt(e, r) for r in rows], e.gen_kwargs, e.icv_scaled, counters)
    add(got["counts"])
    beam_s = got["s_per_q"]

    # (b) greedy test_icv at the CLI's slots, merged against plain admission
    add(merged_vs_plain(e, "openflamingo ", synthetic_vqa(MERGED_REQUESTS, 400, seed=8),
                        counters))

    # (c) beam-3 test_icl of mixed shots: the ALiBi flash in the 32-shot
    # admission prefills; media buffers max_images (33) images wide
    icl_rows = [e.val[q % len(e.val)] for q in range(len(CONT_ICL_SHOTS))]
    icl_shots = [list(range(q, q + n)) for q, n in enumerate(CONT_ICL_SHOTS)]
    icl_prompts = [icl_prompt(e, q % len(e.val), s) for q, s in enumerate(icl_shots)]
    tag = f"openflamingo continuous beam-3 test_icl {CONT_ICL_SHOTS} shots"
    got = engine_run(e, tag, lambda: icl_inference_continuous(
        e.train, icl_rows, icl_shots, b, e.pm, e.gen_kwargs, e.instruction, False,
        CONT_ICL_SLOTS), icl_prompts, e.gen_kwargs, None, counters)
    eng = got["engine"]
    media = sum(x.numel() * x.element_size() for x in tensors(eng._media))
    log(f"{tag}: peak device memory {got['peak_gib']:.2f} GiB (a pool of {eng.n_rows} rows "
        f"over {eng.cache_len} cache columns; media buffers {eng._media_n_img} images wide, "
        f"{media / eng.n_rows / 2**20:.1f} MiB a row)")
    add(got["counts"])

    # (d) the pooled chain: test_icv in one chunk, then test_icl of mixed
    # shots in chunks (the ALiBi flash in the 32-shot chain's prologue and
    # merged prefill lanes)
    rows = synthetic_vqa(POOLED_ICV_Q, 600, seed=9)
    add(pooled_run(e, f"openflamingo pooled beam-3 test_icv, one chunk of {POOLED_ICV_Q}",
                   lambda: icv_inference_pooled(rows, b, e.pm, e.gen_kwargs, e.instruction,
                                                e.icv_scaled, False, POOLED_ICV_Q),
                   [row_prompt(e, r) for r in rows], e.icv_scaled, counters, beam_s=beam_s))
    add(pooled_run(e, f"openflamingo pooled beam-3 test_icl {CONT_ICL_SHOTS} shots",
                   lambda: icl_inference_pooled(e.train, icl_rows, icl_shots, b, e.pm,
                                                e.gen_kwargs, e.instruction, False,
                                                POOL_QUESTIONS),
                   icl_prompts, None, counters, beam_s=beam_s))
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


def write_training_split(tmp: Path, answers=None) -> None:
    """The synthetic VQAv2 train and val splits under ``tmp``, with the
    config's paths pointed there."""
    set_env(tmp)
    vqa, coco = tmp / "vqav2_path", tmp / "coco_path" / "mscoco2014"
    write_vqa_split(vqa, coco / "train2014", "train2014", 2 * TRAIN_BS * TRAIN_MICRO, seed=3,
                    answers=answers)
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
    PHASE5["want"] = want

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
            PHASE11_REFS["f"] = flagship_teacher_reference(shape, mc, params, batch, dev)
        del step, state, params, batch
        free_device_memory()
    if not (math.isfinite(grad["loss_kernel"])
            and max(grad["rel_l2_icv"], grad["rel_l2_alpha"]) <= REL_L2_TOL):
        raise AssertionError("flagship: kernel-path gradients disagree with the plain path")
    return total


def flagship_teacher_reference(shape: str, mc, params, batch, dev) -> dict:
    """(f)'s reference: the flagship teacher's post-norm hidden states in
    one process (the causal flash kernel at every layer), no gradient, and
    that forward's peak device memory."""
    import torch

    from licv_vqa_tpu_torch.models import layers as L
    from licv_vqa_tpu_torch.models.idefics import make_idefics_forward_fns

    forward = make_idefics_forward_fns(mc, eos_token_id=2)[0]
    free_device_memory()
    torch.cuda.reset_peak_memory_stats(dev)
    flash = L.flash_attention.launches
    with torch.no_grad():
        hidden = forward(params, batch["inputs"], None, return_hidden=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    flash = L.flash_attention.launches - flash
    log(f"phase 11 (f) reference: flagship teacher forward {tuple(hidden.shape)} in one "
        f"process, {flash} flash launches, peak device memory {peak:.2f} GiB")
    return {"shape": shape, "inputs": {k: v.cpu() for k, v in batch["inputs"].items()},
            "hidden": hidden.cpu(), "peak_gib": round(peak, 2)}


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


# ---------------------------------------------------------------------------
# phase 11: distribution (tensor, data and sequence parallelism on
# torch.distributed)
# ---------------------------------------------------------------------------
# (a) runs in this process at world size 1 over NCCL; (b)-(g) in
# PHASE11_WORLD ranks that share the card over gloo (NCCL refuses two ranks
# on one device), each a subprocess of this script (``--phase11-rank``).
# (e)-(g) run at sp = PHASE11_WORLD: ring attention, its exchange staged
# through the host under gloo.
# Two ranks on one card measure correctness and memory, not multi-GPU speed.
PHASE11_WORLD = 2
# (d): run A's int8 model cut to its first layers (two cross-attention blocks)
TP_INT8_LAYERS = 8
# (d)'s decode: beam-shaped steps of test_icv (three rows, the first three
# questions, the ICV on) whose tokens are tp = 1's argmax at every step
TP_INT8_ROWS = 3
TP_INT8_STEPS = 3
# what phase 11 is held to, gathered by the earlier phases: (b) phase 4's
# encodings, beam tokens and first-step logits; (c) phase 5's batch, loss
# and gradients, which (e) is held to as well; (d) phase 6 run A's cut
# model's ICL prefill; (f) phase 9's flagship teacher forward; (g) phases
# 7's and 8's models cut to SP_FAMILY_LAYERS, one 32-shot teacher forward
PHASE11_REFS: dict = {}
# (g)'s depth: two of OpenFlamingo's cross-attention groups
SP_FAMILY_LAYERS = 8
# phase 5's launch prediction a micro-step, for (a) and (c)
PHASE5: dict = {}
ENC_KEYS = ("input_ids", "attention_mask", "pixel_values", "pixel_valid")


def encode(bundle, prompt: list) -> dict:
    """A prompt as the runner's processor encodes it (bs 1, left padding), numpy."""
    import numpy as np

    enc = bundle.processor.prepare_input([prompt], padding=True, padding_side="left")
    return {k: np.asarray(enc[k]) for k in ENC_KEYS}


def encode_rows(bundle, prompts: list) -> dict:
    """Prompts as one left-padded batch, numpy."""
    import numpy as np

    enc = bundle.processor.prepare_input(prompts, padding=True, padding_side="left")
    return {k: np.asarray(enc[k]) for k in ENC_KEYS}


def on_device(enc: dict, dev) -> tuple:
    import torch

    return tuple(torch.from_numpy(enc[k]).to(dev) for k in ENC_KEYS)


def prefill_logits(bind, params, enc: dict, icv, dev):
    """The last position's f32 logits of a prefill of ``enc``."""
    import torch

    ids, mask, px, pv = on_device(enc, dev)
    pos = torch.clamp(torch.cumsum(mask, -1) - 1, min=0)
    with torch.inference_mode():
        return bind(params, px, pv, ids, icv, ids.shape[1] + 1)(ids, mask, pos, None)[0][:, -1].float()


def tp_references(e: EvalSetup) -> dict:
    """(b)'s references from phase 4's model: the encodings and static beam
    tokens (bs 1) of the test_icv questions (ICV on) and of one 32-shot
    test_icl question, and the first test_icv question's first-step logits.
    The encodings travel: the ranks' tokenizers have not grown the same
    vocabulary as phase 4's."""
    icv_p = [icv_prompt(e, q) for q in range(1, 1 + N_ICV_Q)]
    icl_p = [icl_prompt(e, 1, e.shots[1])]
    tokens = (decoded_tokens(e, e.gen_kwargs, icv_p, e.icv_scaled)
              + decoded_tokens(e, e.gen_kwargs, icl_p, None))
    encs = [encode(e.bundle, p) for p in icv_p + icl_p]
    b = e.bundle
    return {"encs": encs, "tokens": [t.numpy() for t in tokens], "icv": e.icv_scaled.cpu(),
            "logits": prefill_logits(b.bind_decode, b.params, encs[0], e.icv_scaled,
                                     b.device).cpu(),
            "gen_kwargs": e.gen_kwargs, "vit_bind": vit_per_bind(b.model_cfg.vision, b.device)}


def first_layers(params: dict, mc, n: int, copy: bool = False) -> tuple:
    """Idefics params and config cut to the first ``n`` decoder layers and
    the cross-attention blocks among them (views, or copies so that the
    rest can go)."""
    every = mc.cross_layer_interval
    out = dict(params, layers=_first(params["layers"], n), xattn=_first(params["xattn"], n // every))
    if copy:
        for key in ("layers", "xattn"):
            out[key] = _cloned(out[key])
    return out, dataclasses.replace(mc, text=dataclasses.replace(mc.text, n_layers=n))


def _cloned(tree):
    if isinstance(tree, dict):
        return {k: _cloned(v) for k, v in tree.items()}
    return tree.clone()


def cut_bind(bundle, mc):
    """The bundle's bind for the cut config ``mc`` (pixels normalised as the
    registry's)."""
    from licv_vqa_tpu_torch.data.processor import CLIP_MEAN, CLIP_STD
    from licv_vqa_tpu_torch.models import idefics as I
    from licv_vqa_tpu_torch.models.registry import _wrap_pixel_normalize

    return _wrap_pixel_normalize(*I.make_idefics_forward_fns(mc, bundle.eos_token_id),
                                 CLIP_MEAN, CLIP_STD)[1]


def quant_counters() -> dict:
    from licv_vqa_tpu_torch.ops import int8_matmul as I8

    return {"int8_matmul": I8.int8_matmul, "w8a8_matmul": I8.w8a8_matmul}


def forced_steps(bind, params, enc: dict, icv, dev, tokens=None) -> tuple:
    """A prefill of ``enc``'s rows, then ``TP_INT8_STEPS`` decode steps
    whose tokens are ``tokens[k]`` (each step's argmax where None): the
    tokens fed and each step's last-position f32 logits, (steps, rows, V)."""
    import torch

    from licv_vqa_tpu_torch.models.decoder import _positions_from_mask

    ids, mask, px, pv = on_device(enc, dev)
    pos = _positions_from_mask(mask)
    fed, logits = [], []
    with torch.inference_mode():
        fwd = bind(params, px, pv, ids, icv, ids.shape[1] + TP_INT8_STEPS + 1)
        lg, cache = fwd(ids, mask, pos, None)
        nxt, one = pos[:, -1:] + 1, torch.ones_like(mask[:, -1:])
        for k in range(TP_INT8_STEPS):
            tok = lg[:, -1].argmax(-1) if tokens is None else tokens[k].to(dev)
            fed.append(tok.cpu())
            lg, cache = fwd(tok[:, None].to(ids.dtype), one, nxt, cache)
            nxt = nxt + 1
            logits.append(lg[:, -1].float().cpu())
    return fed, torch.stack(logits)


def first_rows(icv, n: int):
    """An ICV's first ``n`` layers' rows (and host flags), on the host."""
    return (icv[0][:n].cpu(), icv[1][:n]) if isinstance(icv, tuple) else icv[:n].cpu()


def icv_to(icv, dev):
    return (icv[0].to(dev), icv[1]) if isinstance(icv, tuple) else icv.to(dev)


def int8_tp_reference(e: EvalSetup) -> dict:
    """(d)'s reference: run A's int8 model (every option) cut to
    ``TP_INT8_LAYERS`` layers at tp = 1: one 32-shot test_icl prefill, its
    logits and int8/w8a8 launches; then ``TP_INT8_STEPS`` decode steps of
    ``TP_INT8_ROWS`` test_icv questions, their tokens, logits and launches."""
    import torch

    b = e.bundle
    params, mc = first_layers(b.params, b.model_cfg, min(TP_INT8_LAYERS, b.model_cfg.text.n_layers))
    bind = cut_bind(b, mc)
    enc = encode(b, icl_prompt(e, 1, e.shots[1]))
    counters = quant_counters()
    for fn in counters.values():
        fn.launches = 0
    logits = prefill_logits(bind, params, enc, None, b.device)
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in counters.items()}
    log(f"phase 11 (d) reference: int8 {TP_INT8_LAYERS}-layer test_icl prefill at tp=1, "
        f"{enc['input_ids'].shape[1]} tokens, launches {counts}")
    enc_icv = encode_rows(b, [row_prompt(e, r) for r in e.val[:TP_INT8_ROWS]])
    icv = first_rows(e.icv_scaled, mc.text.n_layers)
    for fn in counters.values():
        fn.launches = 0
    fed, steps = forced_steps(bind, params, enc_icv, icv_to(icv, b.device), b.device)
    torch.cuda.synchronize()
    step_counts = {k: fn.launches for k, fn in counters.items()}
    log(f"phase 11 (d) reference: test_icv prefill of {TP_INT8_ROWS} rows x "
        f"{enc_icv['input_ids'].shape[1]} tokens and {TP_INT8_STEPS} steps at tp=1, tokens "
        f"{[t.tolist() for t in fed]}, launches {step_counts}")
    if not step_counts["int8_matmul"]:
        raise AssertionError("phase 11 (d) reference: the decode steps launched no int8 kernel")
    return {"enc": enc, "logits": logits.cpu(), "counts": counts, "opts": QUANT_RUNS[0][1],
            "enc_icv": enc_icv, "icv": icv, "fed": fed, "steps": steps,
            "step_counts": step_counts}


# (c)'s answers: the dp halves of a global batch of two hold answers of
# different token counts
DP_ANSWERS = ["red", "two red cats"]


def dp_reference(m: TrainInputs) -> dict:
    """(c)'s reference: a batch of phase 5's configuration collated from a
    split whose rows 0 and 1 answer with different token counts, its loss
    and (icv, alpha) gradients on the kernel path in one process."""
    import torch

    from licv_vqa_tpu_torch.ops.kl import answer_region_mask
    from licv_vqa_tpu_torch.train.trainer import batch_to_device

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        write_training_split(Path(tmp), answers=DP_ANSWERS)
        batch = _collated_batch(TRAIN_ARGS, m.bundle.processor)
    q = batch["query_inputs"]
    mq = dataclasses.replace(m, batch=batch_to_device(batch, m.bundle.device))
    loss, grads = loss_and_grads(mq, "kernel")
    answers = answer_region_mask(torch.from_numpy(q["input_ids"]),
                                 torch.from_numpy(batch["query_x_length"]),
                                 m.bundle.pad_token_id).sum(1).tolist()
    log(f"phase 11 (c) reference: one process, rows' answer tokens {answers}, "
        f"loss {loss.item():.6e}")
    if answers[0] == answers[1]:
        raise AssertionError("phase 11 (c): the dp halves hold equal answer counts")
    return {"batch": batch, "loss": loss.item(), "grads": [g.cpu() for g in grads]}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def world_of_one():
    """This process as rank 0 of a launcher's world of one (NCCL on the card)."""
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port())}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def world_one_path(dev, tmp: Path) -> dict:
    """Phase 11 (a): the train CLI at ``trainer.strategy=dp`` and the
    inference CLI at ``infer_dp=1 infer_tp=1``, at world size 1 over NCCL,
    each against the same CLI run without a launcher on the same split:
    the losses within 1e-5 relative, the launches phase 5's prediction, the
    answers equal.  Phases 4's and 5's runs cannot be the references: the
    whitespace tokenizer's vocabulary grew over other prompts there (phase
    4) and in a race of the loader's threads (phase 5)."""
    import torch
    import torch.distributed as dist

    from licv_vqa_tpu_torch.cli.inference import main as infer_main
    from licv_vqa_tpu_torch.cli.train import main as train_main
    from licv_vqa_tpu_torch.utils import compose, get_icv_cpk_path

    write_training_split(tmp)
    counters = _counters()
    seen = []
    init = dist.init_process_group

    def spy_init(*a, **kw):  # the backend the CLI asked for
        seen.append(kw.get("backend"))
        return init(*a, **kw)

    # one loader thread: the whitespace tokenizer's vocabulary then grows in
    # one order, so two runs see the same token ids (phase 5's loader
    # threads race on it)
    args = TRAIN_ARGS + ["trainer.strategy=dp", "data_cfg.num_workers=1"]
    losses = {}
    for run in ("plain", "world1"):
        for fn in counters.values():
            fn.launches = 0
        dist.init_process_group = spy_init
        try:
            with world_of_one() if run == "world1" else contextlib.nullcontext():
                run_dir = train_main(args + [f"run_name=phase11_{run}"])
        finally:
            dist.init_process_group = init
        torch.cuda.synchronize()
        rows = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
        losses[run] = [r["loss"] for r in rows]
    counts = {k: fn.launches for k, fn in counters.items()}  # the world-1 run's
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["world1"], losses["plain"], strict=True))
    log(f"phase 11 (a) train CLI, strategy=dp, world 1 over {seen}: losses {losses['world1']} "
        f"vs the same CLI without a launcher {losses['plain']}: max rel {rel:.3e} (limit "
        f"1e-5); launches {counts} (phase 5's prediction a micro-step {PHASE5['want']})")
    if seen != ["nccl"] or rel > 1e-5:
        raise AssertionError("phase 11 (a): the dp train CLI at world 1 is not the one-process run")
    for k, per_step in PHASE5["want"].items():
        if counts[k] != per_step * TRAIN_MICRO:
            raise AssertionError(f"phase 11 (a) {k}: {counts[k]} != {per_step} x {TRAIN_MICRO}")

    args = ["lmm=idefics-9B", "device=cuda", "bs=1", "test_icv=true", f"test_num={N_ICV_Q}",
            f"generate_kwargs.max_new_tokens={MAX_NEW}", "generate_kwargs.num_beams=3",
            "generate_kwargs.length_penalty=0.0", "data_cfg.task.datasets.max_train_size=-1"]
    cfg = compose(str(REPO / "config"), "inference", args + ["run_name=x"])
    g = torch.Generator().manual_seed(0)
    icv = {"icv_encoder.icv": torch.randn((1, 32, 4096), generator=g) * 0.05,
           "icv_encoder.alpha": torch.full((1, 32), 0.5), "use_sigmoid": False,
           "lmm_args": {"total_layers": 32, "intervention_layer": -1,
                        "layer_format": str(cfg.lmm.layer_format)}}
    from licv_vqa_tpu_torch.infer import runner

    preds, tokens = {}, {}
    collect = runner._collect_generate
    for run in ("plain", "world1"):
        d = get_icv_cpk_path(cfg.result_dir, str(cfg.lmm.model_name),
                             cfg.data_cfg.task.datasets.name, run)
        d.mkdir(parents=True)
        torch.save(icv, d / "icv_cpk.pth")
        tokens[run] = []

        def spy_collect(bundle, pending, seen=tokens[run]):  # the generated ids
            seen.append(pending[0][:, pending[2]:].cpu().tolist())
            return collect(bundle, pending)

        for fn in counters.values():
            fn.launches = 0
        runner._collect_generate = spy_collect
        try:
            with world_of_one() if run == "world1" else contextlib.nullcontext():
                infer_main(args + [f"run_name={run}"] + (["infer_dp=1", "infer_tp=1"]
                                                         if run == "world1" else []))
        finally:
            runner._collect_generate = collect
        if run == "world1":  # the main path's launches: the world-1 runs'
            icv_launches = counters["icv_inject"].launches
            for k, fn in counters.items():
                counts[k] += fn.launches
        meta = next((Path(cfg.result_dir) / "inference" / str(cfg.lmm.model_name)
                     / cfg.data_cfg.task.datasets.name / run / "meta_info").glob("*icv.json"))
        res = json.loads(meta.read_text())
        preds[run] = [res[k]["prediction"] for k in sorted(res, key=int)]
    log(f"phase 11 (a) inference CLI test_icv, infer_dp=1 infer_tp=1 at world 1: tokens "
        f"{tokens['world1']}, answers {preds['world1']}; without a launcher {tokens['plain']}, "
        f"{preds['plain']}; ICV launches {icv_launches} (want 32 x {N_ICV_Q * MAX_NEW} forwards)")
    if (tokens["world1"] != tokens["plain"] or preds["world1"] != preds["plain"]
            or len(tokens["plain"]) != N_ICV_Q or icv_launches != 32 * N_ICV_Q * MAX_NEW):
        raise AssertionError("phase 11 (a): the world-1 inference CLI's tokens differ")
    free_device_memory()
    return counts


def distribution_path(dev, tmp: Path) -> dict:
    """Phase 11.  Returns the launch counts of (a) and of every rank of (b)-(d)."""
    import torch

    t0 = time.perf_counter()
    counts = world_one_path(dev, tmp / "world1")
    t_a = time.perf_counter() - t0
    refs = tmp / "phase11_refs.pt"
    torch.save(dict(PHASE11_REFS, phase5_want=PHASE5["want"]), refs)
    port = _free_port()
    procs = []
    for r in range(PHASE11_WORLD):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(PHASE11_WORLD), LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), "--phase11-rank", str(refs)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO))
    results = {}

    def pump(r, p):
        for line in p.stdout:
            line = line.rstrip("\n")
            if line.startswith("PHASE11_RANK_RESULT "):
                results[r] = json.loads(line.split(" ", 1)[1])
            else:
                print(f"[rank {r}] {line}", flush=True)

    with ThreadPoolExecutor(PHASE11_WORLD) as pool:
        for r, p in enumerate(procs):
            pool.submit(pump, r, p)
        deadline = time.monotonic() + 600
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        for p in procs:  # every process this phase started stops here
            if p.poll() is None:
                p.kill()
            p.wait()
    codes = [p.returncode for p in procs]
    if codes != [0] * PHASE11_WORLD or len(results) != PHASE11_WORLD:
        raise AssertionError(f"phase 11: rank exit codes {codes}")
    for r in range(PHASE11_WORLD):
        for k, v in results[r]["counts"].items():
            counts[k] = counts.get(k, 0) + v
    log(f"phase 11: (a) {t_a:.1f} s, ranks {time.perf_counter() - t0 - t_a:.1f} s; rank "
        f"peak device memory {[results[r]['peak_gib'] for r in range(PHASE11_WORLD)]} GiB over "
        f"(b)-(d), {[results[r]['sp_peak_gib'] for r in range(PHASE11_WORLD)]} GiB in (f)'s "
        f"forward ({PHASE11_REFS['f']['peak_gib']} GiB in one process); launches over (a) and "
        f"every rank {counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 11's ranks
# ---------------------------------------------------------------------------


def one_by_one(fn):
    """``fn()`` on each rank in turn (builds of the full tree: one rank's
    peak at a time on the shared card)."""
    import torch.distributed as dist

    out = None
    for r in range(dist.get_world_size()):
        if dist.get_rank() == r:
            out = fn()
        dist.barrier()
    return out


def heads_spy():
    """Record the head counts the flash and the fused ViT kernels see."""
    from licv_vqa_tpu_torch.models import layers as L

    seen = {"flash": set(), "vit": set()}
    flash, tower = L._flash_attention_cuda, L._tower_attention_cuda

    def spy_flash(q, *a, **kw):
        seen["flash"].add(q.shape[2])
        return flash(q, *a, **kw)

    def spy_tower(fn, *a, **kw):
        seen.setdefault("vit" if fn == "vit_attention" else fn, set()).add(a[4].shape[2])
        return tower(fn, *a, **kw)

    @contextlib.contextmanager
    def cm():
        L._flash_attention_cuda, L._tower_attention_cuda = spy_flash, spy_tower
        try:
            yield seen
        finally:
            L._flash_attention_cuda, L._tower_attention_cuda = flash, tower

    return cm()


def rank_tp_path(dev, ref: dict) -> dict:
    """(b): full-width Idefics-9B at tp = 2, beam-3 test_icv on phase 4's
    questions and one 32-shot test_icl question, from phase 4's encodings."""
    import torch

    from licv_vqa_tpu_torch.core.mesh import MeshConfig, create_mesh, set_current_mesh
    from licv_vqa_tpu_torch.infer import runner
    from licv_vqa_tpu_torch.models import layers as L
    from licv_vqa_tpu_torch.models.registry import build_model
    from licv_vqa_tpu_torch.ops.icv_inject import icv_inject
    from licv_vqa_tpu_torch.utils import compose

    mesh = create_mesh(MeshConfig(dp=1, tp=PHASE11_WORLD))
    set_current_mesh(mesh)
    cfg = compose(str(REPO / "config"), "inference", [
        "lmm=idefics-9B", "device=cuda", "run_name=phase11", "bs=1"])
    b = one_by_one(lambda: build_model(cfg, device=dev, mesh=mesh))
    n_bytes = sum(x.numel() * x.element_size() for x in _leaves(b.params))
    log(f"(b) Idefics-9B at tp={mesh.tp}: this rank's shards {n_bytes / 2**30:.2f} GiB")
    icv = ref["icv"].to(dev)
    gen = runner.make_generate_fn(b, ref["gen_kwargs"])
    n_icv = len(ref["encs"]) - 1
    logits = prefill_logits(b.bind_decode, b.params, ref["encs"][0], icv, dev).cpu()
    rel = ((logits - ref["logits"]).norm() / ref["logits"].norm()).item()
    counters = {"icv_inject": icv_inject, "flash_attention_fwd": L.flash_attention,
                "vit_attention": L.vit_attention}
    for fn in counters.values():
        fn.launches = 0
    got = []
    with heads_spy() as heads, torch.inference_mode():
        for q, enc in enumerate(ref["encs"]):
            ids, mask, px, pv = on_device(enc, dev)
            out = gen(b.params, ids, mask, px, pv, icv if q < n_icv else None)
            got.append(out[0, ids.shape[1]:].cpu())
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in counters.items()}
    want = {"icv_inject": 32 * MAX_NEW * n_icv, "flash_attention_fwd": 32,
            "vit_attention": ref["vit_bind"] * len(ref["encs"])}
    differ = [q for q, (a, w) in enumerate(zip(got, ref["tokens"], strict=True))
              if a.tolist() != list(w)]
    log(f"(b) first-step logits vs tp=1 (phase 4): rel_l2 {rel:.4e} (limit {REL_L2_TOL}); "
             f"tokens {[t.tolist() for t in got]}; questions differing from phase 4's {differ}; "
             f"launches {counts} (want {want}); heads seen {heads}")
    if not rel <= REL_L2_TOL:
        raise AssertionError("(b): tp=2 first-step logits disagree with tp=1")
    if counts != want or heads["flash"] != {16} or heads["vit"] != {8}:
        raise AssertionError("(b): launches or head counts are not the predicted ones")
    for q in differ:  # phase 4's near-tie rule, on this rank's own search
        enc = ref["encs"][q]

        def run(enc=enc, q=q):
            ids, mask, px, pv = on_device(enc, dev)
            return gen(b.params, ids, mask, px, pv, icv if q < n_icv else None)

        margin = beam_min_margin(None, None, None, None, run=run)
        log(f"(b) question {q}: smallest f32 decision margin {margin:.6f} (limit {NEAR_TIE})")
        if not margin < NEAR_TIE:
            raise AssertionError("(b): tp=2 beam differs from phase 4's away from a near tie")
    return counts


def rank_dp_path(dev, ref: dict, tmp: Path) -> dict:
    """(c): phase 5's configuration at dp = 2, each rank one row of the
    global batch: the loss and the (icv, alpha) gradients against one
    process's, then one trainer step whose artifact rank 0 alone writes."""
    import torch
    import torch.distributed as dist

    from licv_vqa_tpu_torch.core.mesh import MeshConfig, create_mesh, set_current_mesh
    from licv_vqa_tpu_torch.icv.encoder import GlobalICVEncoder
    from licv_vqa_tpu_torch.icv.module import ICVModuleConfig, icv_loss_fn
    from licv_vqa_tpu_torch.models.registry import build_model
    from licv_vqa_tpu_torch.parallel.sharding import all_reduce_dp, dp_row_slice
    from licv_vqa_tpu_torch.train import trainer as T
    from licv_vqa_tpu_torch.utils import compose

    mesh = create_mesh(MeshConfig(dp=PHASE11_WORLD, tp=1))
    set_current_mesh(mesh)
    b = one_by_one(lambda: build_model(compose(str(REPO / "config"), "train", TRAIN_ARGS),
                                       device=dev, mesh=mesh))

    def encoder():
        return GlobalICVEncoder(b.hidden_size, b.n_layers, alpha_init_value=0.5,
                                use_sigmoid=True, generator=torch.Generator().manual_seed(0),
                                device=dev)

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    enc = encoder()
    rows = dp_row_slice(len(ref["batch"]["query_x_length"]))
    batch = T.batch_to_device(T._take_rows(ref["batch"], rows), dev)
    loss, _ = icv_loss_fn(enc, torch.tensor(1.0, device=dev), b.params, batch, b.train_forward,
                          ICVModuleConfig(kl_impl="pallas"), b.pad_token_id, b.head_fn)
    grads = [all_reduce_dp(g) for g in torch.autograd.grad(loss, (enc.icv, enc.alpha))]
    loss = all_reduce_dp(loss.detach()).item()
    rel_loss = abs(loss - ref["loss"]) / abs(ref["loss"])
    rel = [((g.cpu() - w).norm() / w.norm()).item() for g, w in zip(grads, ref["grads"],
                                                                   strict=True)]
    log(f"(c) dp={mesh.dp}, rows {rows}: global loss {loss:.6e} vs one process "
             f"{ref['loss']:.6e} (rel {rel_loss:.3e}, limit {REL_TOL}); rel_l2 d_icv {rel[0]:.4e}, "
             f"d_alpha {rel[1]:.4e} (limit {REL_L2_TOL})")
    if not (rel_loss <= REL_TOL and max(rel) <= REL_L2_TOL):
        raise AssertionError("(c): the dp loss or gradients disagree with one process's")

    writes = []
    save = T.save_icv_checkpoint

    def spy_save(*a, **kw):
        writes.append(1)
        return save(*a, **kw)

    T.save_icv_checkpoint = spy_save
    try:
        tcfg = T.TrainerConfig(strategy="dp", max_epochs=1, checkpoint_every_n_steps=0,
                               log_every_n_steps=1)
        trainer = T.Trainer(tcfg, ICVModuleConfig(kl_impl="pallas"), encoder(),
                            b.train_forward, b.params, b.pad_token_id, head_fn=b.head_fn,
                            mesh=mesh)
        state = trainer.fit([ref["batch"]], tmp / "dp_run")
    finally:
        T.save_icv_checkpoint = save
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in counters.items()}
    icv = state.encoder.icv.detach()
    mine = icv.clone()
    dist.all_reduce(icv)  # gloo: the ranks' ICVs summed
    same = bool(torch.equal(icv, mine * PHASE11_WORLD))
    log(f"(c) one trainer step: artifact writes on this rank {len(writes)}, ranks' ICVs "
             f"equal {same}; launches {counts} (per step {PHASE5['want']})")
    if len(writes) != (1 if mesh.dp_index == 0 else 0) or not same:
        raise AssertionError("(c): the artifact is not rank 0's alone, or the ranks' ICVs differ")
    for k, per_step in PHASE5["want"].items():
        if counts[k] != 2 * per_step:
            raise AssertionError(f"(c) {k}: {counts[k]} != 2 x {per_step}")
    return counts


def rank_int8_path(dev, ref: dict, tmp: Path) -> dict:
    """(d): run A's options at full width cut to ``TP_INT8_LAYERS`` layers,
    tp = 2: one test_icl prefill through the kernels, against their plain
    versions and against tp = 1 (phase 6), and each rank's int8 and w8a8
    launches against tp = 1's."""
    import torch

    from licv_vqa_tpu_torch.core.mesh import MeshConfig, create_mesh, set_current_mesh
    from licv_vqa_tpu_torch.models.registry import build_model
    from licv_vqa_tpu_torch.ops import int8_matmul as I8
    from licv_vqa_tpu_torch.parallel.sharding import shard_params
    from licv_vqa_tpu_torch.utils import compose

    mesh = create_mesh(MeshConfig(dp=1, tp=PHASE11_WORLD))
    set_current_mesh(mesh)
    cfg = compose(str(REPO / "config"), "inference", [
        "lmm=idefics-9B", "device=cuda", "run_name=phase11", "bs=1", *ref["opts"]])

    def build():
        full = build_model(cfg, device=dev)  # quantized on the card, as phase 6's
        params, mc = first_layers(full.params, full.model_cfg, TP_INT8_LAYERS, copy=True)
        full.params = None
        free_device_memory()
        return shard_params(params, mesh), mc, full

    params, mc, b = one_by_one(build)
    bind = cut_bind(b, mc)
    counters = quant_counters()
    out = {}
    kernels = (I8.int8_matmul, I8.w8a8_matmul, I8.w8a8_matmul_prequantized)
    for path in ("kernel", "plain"):
        for fn in counters.values():
            fn.launches = 0
        if path == "plain":
            I8.int8_matmul, I8.w8a8_matmul, I8.w8a8_matmul_prequantized = (
                I8.int8_matmul_reference, I8.w8a8_matmul_reference,
                I8.w8a8_prequantized_reference)
        try:
            out[path] = prefill_logits(bind, params, ref["enc"], None, dev).cpu()
        finally:
            I8.int8_matmul, I8.w8a8_matmul, I8.w8a8_matmul_prequantized = kernels
        torch.cuda.synchronize()
        if path == "kernel":
            counts = {k: fn.launches for k, fn in counters.items()}
    k, p, t1 = out["kernel"], out["plain"], ref["logits"]
    rel_p = ((k - p).norm() / p.norm()).item()
    rel_1 = ((k - t1).norm() / t1.norm()).item()
    log(f"(d) int8 + w8a8 at tp={mesh.tp}, {TP_INT8_LAYERS} layers, test_icl prefill of "
             f"{ref['enc']['input_ids'].shape[1]} tokens: kernel vs plain rel_l2 {rel_p:.4e}, "
             f"vs tp=1 rel_l2 {rel_1:.4e} (limit {REL_L2_TOL}), argmax "
             f"{int(k.argmax())}/{int(p.argmax())}/{int(t1.argmax())}; launches {counts} "
             f"(tp=1: {ref['counts']})")
    if not (rel_p <= REL_L2_TOL and rel_1 <= REL_L2_TOL and torch.isfinite(k).all()):
        raise AssertionError("(d): the tp=2 int8 prefill disagrees")
    if counts != ref["counts"]:
        raise AssertionError("(d): the rank's int8/w8a8 launches are not tp=1's")
    step_counts = int8_tp_steps(bind, params, ref, counters, dev)
    return {k: counts[k] + step_counts[k] for k in counts}


def int8_tp_steps(bind, params, ref: dict, counters: dict, dev) -> dict:
    """(d)'s decode: tp = 1's test_icv prefill and forced steps at tp = 2,
    kernel path and plain path; the step logits against each other and
    against tp = 1's, the rank's int8/w8a8 launches against tp = 1's, and
    the int8 kernel's (M, K, N) on this rank (column and row shards, the
    head's vocab shard)."""
    import torch

    from licv_vqa_tpu_torch.ops import int8_matmul as I8

    kernels = (I8.int8_matmul, I8.w8a8_matmul, I8.w8a8_matmul_prequantized)
    launch, shapes = I8._launch, set()

    def spy_launch(x, q, *a):  # the int8 wrapper's kernel launch
        shapes.add((x.shape[0], q.shape[0], q.shape[1]))
        return launch(x, q, *a)

    icv = icv_to(ref["icv"], dev)
    out = {}
    for path in ("kernel", "plain"):
        for fn in counters.values():
            fn.launches = 0
        I8._launch = spy_launch
        if path == "plain":
            I8.int8_matmul, I8.w8a8_matmul, I8.w8a8_matmul_prequantized = (
                I8.int8_matmul_reference, I8.w8a8_matmul_reference,
                I8.w8a8_prequantized_reference)
        try:
            out[path] = forced_steps(bind, params, ref["enc_icv"], icv, dev, ref["fed"])[1]
        finally:
            I8.int8_matmul, I8.w8a8_matmul, I8.w8a8_matmul_prequantized = kernels
            I8._launch = launch
        torch.cuda.synchronize()
        if path == "kernel":
            counts = {k: fn.launches for k, fn in counters.items()}
    k, p, t1 = out["kernel"], out["plain"], ref["steps"]
    rel_p = [((a - b).norm() / b.norm()).item() for a, b in zip(k, p, strict=True)]
    rel_1 = [((a - b).norm() / b.norm()).item() for a, b in zip(k, t1, strict=True)]
    log(f"(d) test_icv decode at tp=2, {TP_INT8_ROWS} rows, {TP_INT8_STEPS} forced steps: "
        f"step logits kernel vs plain rel_l2 {[f'{r:.4e}' for r in rel_p]}, vs tp=1 "
        f"{[f'{r:.4e}' for r in rel_1]} (limit {REL_L2_TOL}), max_abs vs plain "
        f"{(k - p).abs().max().item():.4e}; launches {counts} (tp=1: {ref['step_counts']}); "
        f"int8 kernel (M, K, N) {sorted(shapes)}")
    if not (max(rel_p) <= REL_L2_TOL and max(rel_1) <= REL_L2_TOL and torch.isfinite(k).all()):
        raise AssertionError("(d): the tp=2 int8 decode steps disagree")
    if counts != ref["step_counts"] or not counts["int8_matmul"]:
        raise AssertionError("(d): the rank's decode launches are not tp=1's")
    return counts


def family_cut(bundle, n: int, copy: bool = False) -> tuple:
    """An Idefics2 or OpenFlamingo bundle's model cut to its first ``n``
    decoder layers (and OpenFlamingo's cross-attention groups among them):
    ``(params, train_forward)``, the forward normalising raw pixels as the
    registry's does; the cut leaves views, or copies so that the rest can
    go."""
    from licv_vqa_tpu_torch.data.processor import CLIP_MEAN, CLIP_STD, SIGLIP_MEAN, SIGLIP_STD
    from licv_vqa_tpu_torch.models import idefics2, openflamingo
    from licv_vqa_tpu_torch.models.registry import _wrap_pixel_normalize

    mc = bundle.model_cfg
    n = min(n, mc.text.n_layers)
    params = dict(bundle.params, layers=_first(bundle.params["layers"], n))
    if "idefics2" in bundle.name:
        make, mean, std = idefics2.make_idefics2_forward_fns, SIGLIP_MEAN, SIGLIP_STD
    else:
        make, mean, std = openflamingo.make_openflamingo_forward_fns, CLIP_MEAN, CLIP_STD
        params["xattn"] = _first(bundle.params["xattn"], n // mc.cross_attn_every_n_layers)
    if copy:
        for key in ("layers", "xattn"):
            if key in params:
                params[key] = _cloned(params[key])
    cut = dataclasses.replace(mc, text=dataclasses.replace(mc.text, n_layers=n))
    fwd = _wrap_pixel_normalize(*make(cut, bundle.eos_token_id), mean, std)[0]
    return params, fwd


def tower_counters() -> dict:
    from licv_vqa_tpu_torch.models import layers as L
    from licv_vqa_tpu_torch.ops import flash_alibi as FA

    return {"flash_attention_fwd": L.flash_attention,
            "flash_alibi_attention": FA.flash_alibi_attention,
            "flash_attention_bidir": L.flash_attention_bidir, "vit_attention": L.vit_attention}


def sp_family_reference(e: EvalSetup, lmm: str) -> dict:
    """(g)'s reference from phase 7's or 8's model: its first
    ``SP_FAMILY_LAYERS`` layers, one 32-shot teacher forward in one process
    through the flash kernels, right-padded to an even length as the
    trainer pads it for sp = 2: the inputs, the post-norm hidden states and
    the launches."""
    import numpy as np
    import torch

    from licv_vqa_tpu_torch.train.trainer import _pad_seq_to_multiple, batch_to_device

    b = e.bundle
    enc = b.processor.prepare_input([icl_prompt(e, 1, e.shots[1])], padding=True,
                                    padding_side="right")
    inputs = {k: np.asarray(v) for k, v in enc.items()
              if k in ENC_KEYS + ("pixel_attention_mask",)}
    inputs = _pad_seq_to_multiple(inputs, PHASE11_WORLD, b.pad_token_id)
    params, forward = family_cut(b, SP_FAMILY_LAYERS)
    counters = tower_counters()
    before = {k: fn.launches for k, fn in counters.items()}
    with torch.no_grad():
        hidden = forward(params, batch_to_device(inputs, b.device), None, return_hidden=True)
    torch.cuda.synchronize()
    counts = {k: fn.launches - before[k] for k, fn in counters.items()}
    log(f"phase 11 (g) reference: {lmm} cut to {SP_FAMILY_LAYERS} layers, {ICL_SHOTS}-shot "
        f"teacher of {int(inputs['attention_mask'].sum())} tokens padded to "
        f"{inputs['input_ids'].shape[1]}, one process, launches {counts}")
    return {"inputs": inputs, "hidden": hidden.cpu(), "counts": counts}


def sp_mesh():
    """The dp 1 x sp ``PHASE11_WORLD`` mesh of (e)-(g), made current."""
    from licv_vqa_tpu_torch.core.mesh import MeshConfig, create_mesh, set_current_mesh

    mesh = create_mesh(MeshConfig(dp=1, tp=1, sp=PHASE11_WORLD))
    set_current_mesh(mesh)
    return mesh


def odd_teacher(batch: dict, pad_id: int) -> dict:
    """``batch`` with its teacher one column shorter (a trailing column of
    pads dropped) or longer (one of pads added): an odd length, which the
    trainer pads back to an sp multiple.  Every real token stays."""
    import numpy as np

    tea = dict(batch["inputs"])
    ids, mask = tea["input_ids"], tea["attention_mask"]
    if ids.shape[1] % 2 == 0:
        if not mask[:, -1].any():
            ids, mask = ids[:, :-1], mask[:, :-1]
        else:
            ids = np.pad(ids, [(0, 0), (0, 1)], constant_values=pad_id)
            mask = np.pad(mask, [(0, 0), (0, 1)])
    tea.update(input_ids=np.ascontiguousarray(ids), attention_mask=np.ascontiguousarray(mask))
    return dict(batch, inputs=tea)


def rel_l2(a, b) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return ((a - b).norm() / b.norm()).item()


def rank_sp_train_path(dev, ref: dict, mesh, tmp: Path) -> dict:
    """(e): phase 5's configuration at ``dp_sp``, sp = 2, on (c)'s batch
    with its teacher made odd in length: the loss and the (icv, alpha)
    gradients against one process's, each ICV launch on the rank's chunk,
    no flash launch; then one trainer step, which pads the sequences and
    whose artifact rank 0 alone writes."""
    import torch
    import torch.distributed as dist

    from licv_vqa_tpu_torch.icv.encoder import GlobalICVEncoder
    from licv_vqa_tpu_torch.icv.module import ICVModuleConfig, icv_loss_fn, reduce_gradients
    from licv_vqa_tpu_torch.models.registry import build_model
    from licv_vqa_tpu_torch.train import trainer as T
    from licv_vqa_tpu_torch.utils import compose

    # the module (``licv_vqa_tpu_torch.ops`` re-exports the function under its name)
    I = importlib.import_module("licv_vqa_tpu_torch.ops.icv_inject")
    b = one_by_one(lambda: build_model(compose(str(REPO / "config"), "train", TRAIN_ARGS),
                                       device=dev, mesh=mesh))

    def encoder():
        return GlobalICVEncoder(b.hidden_size, b.n_layers, alpha_init_value=0.5,
                                use_sigmoid=True, generator=torch.Generator().manual_seed(0),
                                device=dev)

    batch = odd_teacher(ref["batch"], b.pad_token_id)
    padded = T._pad_seq_to_multiple(batch, mesh.sp, b.pad_token_id)
    lengths = {k: (batch[k]["input_ids"].shape[1], padded[k]["input_ids"].shape[1])
               for k in ("query_inputs", "inputs")}
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    chunks, launch = set(), I._icv_inject_triton

    def spy(x, *a, **kw):  # the ICV kernel's tokens a launch
        chunks.add(x.shape[1])
        return launch(x, *a, **kw)

    I._icv_inject_triton = spy
    writes, save = [], T.save_icv_checkpoint

    def spy_save(*a, **kw):
        writes.append(1)
        return save(*a, **kw)

    T.save_icv_checkpoint = spy_save
    try:
        enc = encoder()
        loss, _ = icv_loss_fn(enc, torch.tensor(1.0, device=dev), b.params,
                              T.batch_to_device(padded, dev), b.train_forward,
                              ICVModuleConfig(kl_impl="pallas"), b.pad_token_id, b.head_fn)
        grads = reduce_gradients(dict(zip(("icv", "alpha"),
                                          torch.autograd.grad(loss, (enc.icv, enc.alpha)))))
        loss = loss.item()
        tcfg = T.TrainerConfig(strategy="dp_sp", sp=mesh.sp, max_epochs=1,
                               checkpoint_every_n_steps=0, log_every_n_steps=1)
        state = T.Trainer(tcfg, ICVModuleConfig(kl_impl="pallas"), encoder(), b.train_forward,
                          b.params, b.pad_token_id, head_fn=b.head_fn, mesh=mesh,
                          ).fit([batch], tmp / "sp_run")
    finally:
        I._icv_inject_triton = launch
        T.save_icv_checkpoint = save
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in counters.items()}
    rel_loss = abs(loss - ref["loss"]) / abs(ref["loss"])
    rel = [rel_l2(grads[k], w) for k, w in zip(("icv", "alpha"), ref["grads"], strict=True)]
    want = dict(PHASE5["want"], flash_attention_fwd=0, flash_attention_bwd=0)
    chunk = padded["query_inputs"]["input_ids"].shape[1] // mesh.sp
    icv = state.encoder.icv.detach()
    mine = icv.clone()
    dist.all_reduce(icv)
    same = bool(torch.equal(icv, mine * PHASE11_WORLD))
    log(f"(e) dp_sp, sp={mesh.sp}, chunk {mesh.sp_index}: lengths (given, padded) {lengths}; "
        f"loss {loss:.6e} vs one process {ref['loss']:.6e} (rel {rel_loss:.3e}, limit {REL_TOL}); "
        f"rel_l2 d_icv {rel[0]:.4e}, d_alpha {rel[1]:.4e} (limit {REL_L2_TOL}); ICV kernel "
        f"tokens a launch {sorted(chunks)} (the student's chunk {chunk}); one trainer step: "
        f"artifact writes on this rank {len(writes)}, ranks' ICVs equal {same}; launches "
        f"{counts} (per step {want})")
    if lengths["inputs"][0] % 2 == 0 or lengths["inputs"][1] % mesh.sp:
        raise AssertionError("(e): the teacher was not odd, or not padded to an sp multiple")
    if not (rel_loss <= REL_TOL and max(rel) <= REL_L2_TOL):
        raise AssertionError("(e): the sp loss or gradients disagree with one process's")
    if chunks != {chunk}:
        raise AssertionError(f"(e): ICV launches over {sorted(chunks)} tokens, not the chunk")
    if len(writes) != (1 if mesh.rank == 0 else 0) or not same:
        raise AssertionError("(e): the artifact is not rank 0's alone, or the ranks' ICVs differ")
    for k, per_step in want.items():
        if counts[k] != 2 * per_step:
            raise AssertionError(f"(e) {k}: {counts[k]} != 2 x {per_step}")
    return counts


def rank_sp_flagship_path(dev, ref: dict, mesh) -> dict:
    """(f): the flagship teacher (int8 Idefics-9B, bs 4, 2048 tokens; the
    bench tool's weights) forward at sp = 2, no gradient: the gathered
    hidden states against one process's, no flash launch, and the rank's
    peak device memory beside the one process's."""
    import torch

    from licv_vqa_tpu_torch.models.idefics import make_idefics_forward_fns

    tool = bench_tool()
    mc, *_, quantize = tool.shape_config(ref["shape"], FLAGSHIP_MODES[0])
    params = one_by_one(lambda: tool.build_params(mc, quantize, dev))
    forward = make_idefics_forward_fns(mc, eos_token_id=2)[0]
    inputs = {k: v.to(dev) for k, v in ref["inputs"].items()}
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    free_device_memory()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        hidden = forward(params, inputs, None, return_hidden=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    counts = {k: fn.launches for k, fn in counters.items()}
    rel = rel_l2(hidden, ref["hidden"])
    want_vit = vit_per_bind(mc.vision, dev)
    log(f"(f) flagship teacher forward {tuple(hidden.shape)} at sp={mesh.sp}, chunk "
        f"{mesh.sp_index}: gathered hidden vs one process rel_l2 {rel:.4e} (limit {REL_L2_TOL}); "
        f"{wall:.2f} s (host clock, two ranks on one card over gloo); peak device memory "
        f"{peak:.2f} GiB on this rank, {ref['peak_gib']:.2f} GiB in one process; launches "
        f"{counts} (vit_attention {want_vit}, no flash)")
    if not (rel <= REL_L2_TOL and torch.isfinite(hidden).all()):
        raise AssertionError("(f): the sp teacher's hidden states disagree with one process's")
    if counts["flash_attention_fwd"] or counts["vit_attention"] != want_vit:
        raise AssertionError("(f): launches are not the predicted ones")
    return dict(counts, sp_peak_gib=round(peak, 2))


def rank_sp_family_path(dev, ref: dict, mesh, lmm: str) -> dict:
    """(g): ``lmm`` cut to ``SP_FAMILY_LAYERS`` layers, one 32-shot teacher
    forward at sp = 2 against one process's (phase 7's or 8's model): the
    gathered hidden states, the towers' launches those of one process (the
    towers run whole on every sp rank), no decoder flash launch."""
    import torch

    from licv_vqa_tpu_torch.models.registry import build_model
    from licv_vqa_tpu_torch.train.trainer import batch_to_device
    from licv_vqa_tpu_torch.utils import compose

    cfg = compose(str(REPO / "config"), "inference", [
        f"lmm={lmm}", "device=cuda", "run_name=phase11", "bs=1"])

    def build():
        full = build_model(cfg, device=dev)
        cut = family_cut(full, SP_FAMILY_LAYERS, copy=True)
        full.params = None
        free_device_memory()
        return cut

    params, forward = one_by_one(build)
    counters = tower_counters()
    for fn in counters.values():
        fn.launches = 0
    with torch.no_grad():
        hidden = forward(params, batch_to_device(ref["inputs"], dev), None, return_hidden=True)
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in counters.items()}
    rel = rel_l2(hidden, ref["hidden"])
    want = dict(ref["counts"], flash_attention_fwd=0, flash_alibi_attention=0)
    log(f"(g) {lmm}, {SP_FAMILY_LAYERS} layers, {ICL_SHOTS}-shot teacher "
        f"{tuple(hidden.shape)} at sp={mesh.sp}, chunk {mesh.sp_index}: gathered hidden vs one "
        f"process rel_l2 {rel:.4e} (limit {REL_L2_TOL}); launches {counts} (want {want})")
    if not (rel <= REL_L2_TOL and torch.isfinite(hidden).all()):
        raise AssertionError(f"(g) {lmm}: the sp teacher's hidden states disagree")
    if counts != want:
        raise AssertionError(f"(g) {lmm}: launches are not the predicted ones")
    return counts


def ring_ms(dev, mesh) -> dict:
    """Milliseconds one ``ring_shift`` of (f)'s K/V chunk takes between the
    ranks (mean of 3 after a warm-up): (2, 4, 1024, 32, 128) bf16, 64 MiB,
    staged through the host under gloo."""
    import torch

    from licv_vqa_tpu_torch.parallel.ring import ring_shift, sequence_ring

    s = 1024 * mesh.sp
    ring = sequence_ring(torch.zeros((4, s), dtype=torch.int32, device=dev),
                         torch.ones((4, s), dtype=torch.int32, device=dev))
    x = torch.ones((2, 4, 1024, 32, 128), dtype=torch.bfloat16, device=dev)
    ring_shift(x, ring)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        y = ring_shift(x, ring)
    torch.cuda.synchronize()
    if not torch.equal(y, x):
        raise AssertionError("ring_shift: the chunk came back changed")
    return {"(2,4,1024,32,128) bf16": round((time.perf_counter() - t0) / 3 * 1e3, 3)}


def collective_ms(dev) -> dict:
    """Milliseconds an f32 all-reduce between the ranks takes on the card
    (mean of 10 after 2 warm-up calls): a beam step's activation (3 x 4096)
    and a 2300-token prefill's (2300 x 4096)."""
    import torch
    import torch.distributed as dist

    out = {}
    for rows in (3, 2300):
        x = torch.ones((rows, 4096), device=dev)
        for _ in range(2):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        out[f"({rows},4096) f32"] = round((time.perf_counter() - t0) / 10 * 1e3, 3)
    return out


def phase11_rank(refs_path: Path) -> int:
    """A rank of phase 11 (b)-(g), started by ``distribution_path`` with the
    launcher's environment; two ranks share the card over gloo."""
    import torch

    from licv_vqa_tpu_torch.core.distributed import maybe_initialize_distributed
    from licv_vqa_tpu_torch.core.distributed import shutdown_distributed

    os.chdir(REPO)
    dev = maybe_initialize_distributed("cuda", backend="gloo")
    refs = torch.load(refs_path, weights_only=False)
    PHASE5["want"] = refs["phase5_want"]
    route_icv(kernels=True)
    log(f"gloo all-reduce of CUDA tensors between the ranks on one card, ms: "
        f"{collective_ms(dev)}")
    counts: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rank_") as tmp:
        for run in (lambda: rank_tp_path(dev, refs["b"]),
                    lambda: rank_dp_path(dev, refs["c"], Path(tmp)),
                    lambda: rank_int8_path(dev, refs["d"], Path(tmp))):
            for k, v in run().items():
                counts[k] = counts.get(k, 0) + v
            free_device_memory()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        t0 = time.perf_counter()
        mesh = sp_mesh()
        log(f"sp={mesh.sp}: ring_shift between the ranks on one card over gloo, ms: "
            f"{ring_ms(dev, mesh)} (collective_ms beside it: {collective_ms(dev)})")
        sp_peak = None
        for run in (lambda: rank_sp_train_path(dev, refs["c"], mesh, Path(tmp)),
                    lambda: rank_sp_flagship_path(dev, refs["f"], mesh),
                    *(lambda lmm=lmm: rank_sp_family_path(dev, refs["g"][lmm], mesh, lmm)
                      for lmm in refs["g"])):
            res = run()
            sp_peak = res.pop("sp_peak_gib", sp_peak)
            for k, v in res.items():
                counts[k] = counts.get(k, 0) + v
            free_device_memory()
        log(f"(e)-(g): {time.perf_counter() - t0:.1f} s")
    shutdown_distributed()
    print("PHASE11_RANK_RESULT " + json.dumps({"counts": counts, "peak_gib": round(peak, 2),
                                               "sp_peak_gib": sp_peak}), flush=True)
    return 0


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
    # the same Pallas kernel on f32 operands (its out_shape follows q.dtype)
    "vit_attention_f32": ("cuda", "licv_vqa_tpu_torch/csrc/vit_attention_f32.cu",
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
    if sys.argv[1:2] == ["--phase11-rank"]:
        return phase11_rank(Path(sys.argv[2]))
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
        PHASE11_REFS["c"] = dp_reference(m)
        if not (math.isfinite(grad["loss_kernel"])
                and max(grad["rel_l2_icv"], grad["rel_l2_alpha"]) <= REL_L2_TOL):
            raise AssertionError("kernel-path gradients disagree with the plain path")
        profile_training(m)
        del m
        free_device_memory()
        counts_q = {}
        for mode, opts, paths in QUANT_RUNS:
            for k, v in quantized_path(dev, Path(tmp) / mode, mode, opts, paths).items():
                counts_q[k] = counts_q.get(k, 0) + v
            free_device_memory()
        mode, opts, paths = QUANT_FLAMINGO
        for k, v in quantized_path(dev, Path(tmp) / "int8_flamingo", mode, opts, paths,
                                   lmm="openflamingov2-9B", icl_q=QUANT_FLAMINGO_ICL_Q).items():
            counts_q[k] = counts_q.get(k, 0) + v
        free_device_memory()
        counts_i2 = idefics2_path(dev, Path(tmp) / "idefics2")
        free_device_memory()
        counts_of = openflamingo_path(dev, Path(tmp) / "openflamingo")
        free_device_memory()
    counts_fl = flagship_train_path(dev)
    free_device_memory()
    counts_tools = tools_path(dev)
    free_device_memory()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        counts_dist = distribution_path(dev, Path(tmp))
    free_device_memory()

    phases = (counts, counts_train, counts_q, counts_i2, counts_of, counts_fl, counts_dist)
    launches = {
        name: sum(c.get(name, 0) for c in phases)
        for name in ("icv_inject", "flash_attention_fwd", "vit_attention", "icv_inject_bwd",
                     "flash_attention_bwd", "int8_matmul")
    }
    launches.update({
        "vit_attention_f32": counts["vit_attention_f32"],
        "flash_alibi_attention": counts_of["flash_alibi_attention"]
        + counts_q["flash_alibi_attention"],
        "flash_attention_bidir": counts_i2["flash_attention_bidir"]
        + counts_dist.get("flash_attention_bidir", 0),
        "int4_matmul": counts_q["int4_matmul"],
        "w8a8_matmul": counts_q["w8a8_matmul"] + counts_tools["w8a8_matmul"]
        + counts_dist["w8a8_matmul"],
        "int4_unpack_probe": counts_tools["int4_unpack_probe"],
    })
    kernels = []
    for name, (route, source, replaces) in KERNEL_SOURCES.items():
        if name == "masked_kl":
            # one kernel pair behind one autograd Function: the row sums fwd + bwd
            f, b = summary["masked_kl_fwd"], summary["masked_kl_bwd"]
            row = {
                "launches": sum(c[k] for c in (counts_train, counts_dist)
                                for k in ("masked_kl_fwd", "masked_kl_bwd")),
                "max_abs_err": max(f["max_abs_err"], b["max_abs_err"]),
                "ms": f["ms"] + b["ms"], "plain_ms": f["plain_ms"] + b["plain_ms"],
                "bound_ms": f["bound_ms"] + b["bound_ms"], "bound_by": "bytes",
                "library_ms": None,
                "timed_by": f["timed_by"] if f["timed_by"] == b["timed_by"] else "mixed",
                "fwd": {"launches": counts_train["masked_kl_fwd"] + counts_dist["masked_kl_fwd"],
                        "ms": f["ms"],
                        "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"]},
                "bwd": {"launches": counts_train["masked_kl_bwd"] + counts_dist["masked_kl_bwd"],
                        "ms": b["ms"],
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
