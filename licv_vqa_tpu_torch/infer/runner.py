"""Batched evaluation runners: ICV-steered zero-shot and few-shot ICL
(counterpart of the static path of ``licv_vqa_tpu/infer/runner.py``).

Prompts are LEFT-padded to bucket multiples by the shared processor; a short
final batch is padded to the batch size by repeating its last sample and the
extra rows are discarded (reference inference.py:264-267).  Greedy
decoding may take a layer-truncated draft (``speculative_draft_layers``,
``infer/speculative.py``).  ``icv_inference_continuous`` and
``icl_inference_continuous`` run the same evals through the
continuous-batching engines (``infer/serving.py``; Idefics only), and
``icv_inference_pooled`` and ``icl_inference_pooled`` through the pooled
beam schedule (``infer/eval_chain.py``; Idefics-9B's family only).

Under a mesh (``core.mesh.current_mesh()``, the CLI's ``infer_dp`` /
``infer_tp``; JAX runner.py:195-209) every rank tokenizes the whole batch,
repeats its last row up to a dp multiple, generates its contiguous dp rows
(on its tp shards of the weights, the logits gathered whole) and gathers
the dp ranks' tokens, so every rank holds every answer; the CLI's rank 0
writes them.  The continuous engines and the pooled chain take no mesh
(their dp slot pool is ROADMAP.md Queue 1 item 16b).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..data.prompt import PromptManager
from ..parallel.sharding import dp_row_slice, dp_size, gather_rows_dp
from ..utils.log import get_logger
from .decode import beam_generate, greedy_generate

logger = get_logger("infer")


def _chunked(seq, n):
    buf = []
    for x in seq:
        buf.append(x)
        if len(buf) == n:
            yield buf
            buf = []
    if buf:
        yield buf


def make_generate_fn(bundle, generate_kwargs: dict) -> Callable:
    """One generate over (params, ids, mask, pixels, valid, icv) and, for
    NaViT variable resolution (Idefics2), the ``pixel_attention_mask`` the
    processor emits.  The KV cache length follows the (bucketed) prompt
    length of each call.

    ``speculative_draft_layers = K > 0`` with greedy decoding drafts with
    the model's first K layers (``registry.build_draft_decode``) and
    verifies with the whole model, ``speculative_gamma`` tokens a round
    (JAX runner.py:54-130); beam search and ``min_new_tokens > 0`` fall
    back to the plain decode with a warning."""
    max_new = int(generate_kwargs.get("max_new_tokens", 5))
    min_new = int(generate_kwargs.get("min_new_tokens", 0))
    num_beams = int(generate_kwargs.get("num_beams", 1))
    length_penalty = float(generate_kwargs.get("length_penalty", 0.0))
    draft_layers = int(generate_kwargs.get("speculative_draft_layers", 0))
    gamma = int(generate_kwargs.get("speculative_gamma", 4))
    eos, pad = bundle.eos_token_id, bundle.pad_token_id

    draft = None
    if draft_layers > 0:
        if num_beams > 1:
            logger.warning(
                "speculative decoding requires num_beams == 1 (exact greedy "
                "verification; no beam-verification scheme is implemented) — "
                "falling back to plain beam search"
            )
        elif min_new > 0:
            logger.warning(
                "speculative decoding does not implement min_new_tokens "
                "(EOS suppression for the first %d steps) — falling back to "
                "plain greedy so the contract 'equals greedy token-for-token' "
                "holds",
                min_new,
            )
        else:
            from ..models.registry import build_draft_decode

            draft = build_draft_decode(bundle, draft_layers)
    # the verify writes up to gamma rows past the current index: without
    # this margin the last rounds would write past the cache
    margin = gamma if draft is not None else 0

    @torch.inference_mode()
    def gen(params, input_ids, attention_mask, pixels, pixel_valid, icv_scaled,
            pixel_attention_mask=None):
        bind_kw = (
            {"pixel_attention_mask": pixel_attention_mask}
            if pixel_attention_mask is not None
            else {}
        )
        max_len = input_ids.shape[1] + max_new + margin + 1
        fwd = bundle.bind_decode(
            params, pixels, pixel_valid, input_ids, icv_scaled, max_len, **bind_kw,
        )
        if draft is not None:
            from .speculative import speculative_greedy_generate

            draft_params, draft_bind = draft
            dfwd = draft_bind(
                draft_params, pixels, pixel_valid, input_ids,
                _draft_icv(bundle, icv_scaled, draft_layers), max_len, **bind_kw,
            )
            return speculative_greedy_generate(
                fwd, dfwd, input_ids, attention_mask, max_new_tokens=max_new,
                eos_token_id=eos, pad_token_id=pad, gamma=gamma,
            )
        if num_beams > 1:
            return beam_generate(
                fwd, input_ids, attention_mask, max_new_tokens=max_new,
                eos_token_id=eos, pad_token_id=pad, num_beams=num_beams,
                length_penalty=length_penalty, min_new_tokens=min_new,
            )
        return greedy_generate(
            fwd, input_ids, attention_mask, max_new_tokens=max_new,
            eos_token_id=eos, pad_token_id=pad, min_new_tokens=min_new,
        )

    return gen


def _draft_icv(bundle, icv_scaled, draft_layers: int):
    """The draft's ICV: the target's per-layer rows truncated to the draft's
    depth.  Under subset-layer intervention the K rows are expanded to
    per-layer ``(rows, flags)`` first (the draft bind is the raw forward,
    not the bundle's intervention wrapper).  Its fidelity moves only the
    acceptance rate, never the output: the target verifies every token."""
    if icv_scaled is None:
        return None
    if bundle.intervention_layers is not None:
        from ..icv.encoder import expand_icv_to_layers

        rows, flags = expand_icv_to_layers(
            icv_scaled, bundle.intervention_layers, bundle.model_cfg.text.n_layers
        )
        return rows[:draft_layers], list(flags)[:draft_layers]
    return icv_scaled[:draft_layers]


def _dispatch_generate(bundle, gen_fn: Callable, prompts: list[list], icv_scaled):
    """Tokenize, move to the bundle's device and launch one generation;
    returns ``(device_out, rows, prompt_len)``.  The launches are queued on
    the device stream; nothing is read back until ``_collect_generate``.
    Under dp the batch's last row is repeated up to a dp multiple (the
    extras discarded) and this rank generates its contiguous rows."""
    enc = bundle.processor.prepare_input(prompts, padding=True, padding_side="left")
    dev = bundle.device
    keys = ["input_ids", "attention_mask", "pixel_values", "pixel_valid"]
    if "pixel_attention_mask" in enc:  # NaViT variable resolution
        keys.append("pixel_attention_mask")
    arrays = [np.asarray(enc[key]) for key in keys]
    rem = (-len(prompts)) % dp_size()
    if rem:
        arrays = [np.concatenate([a, np.repeat(a[-1:], rem, axis=0)]) for a in arrays]
    rows = dp_row_slice(arrays[0].shape[0])
    ids, mask, px, pv, *extra = (torch.from_numpy(a[rows]).to(dev) for a in arrays)
    kw = {"pixel_attention_mask": extra[0]} if extra else {}
    out = gen_fn(bundle.params, ids, mask, px, pv, icv_scaled, **kw)
    return out, len(prompts), enc["input_ids"].shape[1]


def _collect_generate(bundle, pending) -> list[str]:
    """Wait for a ``_dispatch_generate`` handle and decode ONLY the
    continuation (reference inference.py:300-321)."""
    out, rows, prompt_len = pending
    out = gather_rows_dp(out).cpu().numpy()[:rows]
    return bundle.tokenizer.batch_decode(
        [row[prompt_len:] for row in out], skip_special_tokens=True
    )


def generate_answers(bundle, gen_fn: Callable, prompts: list[list], icv_scaled) -> list[str]:
    """Tokenize → generate → decode ONLY the continuation."""
    return _collect_generate(bundle, _dispatch_generate(bundle, gen_fn, prompts, icv_scaled))


def _store(results: dict, batch: list, generated: list[str]) -> None:
    for sample, text in zip(batch, generated):
        row = {k: v for k, v in sample.items() if k != "image"}
        results[len(results)] = {"prediction": text, **row}


def icv_inference(
    val_ds,
    bundle,
    prompt_manager: PromptManager,
    bs: int,
    generate_kwargs: dict,
    instruction: str = "",
    icv_scaled: Optional[torch.Tensor] = None,
    progress: bool = True,
) -> dict:
    """Zero-shot (+ optional ICV) eval loop (reference inference.py:246-297)."""
    gen_fn = make_generate_fn(bundle, generate_kwargs)
    results: dict = {}
    for batch in _chunked(_maybe_tqdm(val_ds, progress), bs):
        padded = batch + [batch[-1]] * (bs - len(batch))
        prompts = []
        for sample in padded:
            p = [instruction] if instruction else []
            p += [sample["image"], prompt_manager.gen_query_text_without_label(sample)]
            prompts.append(p)
        _store(results, batch, generate_answers(bundle, gen_fn, prompts, icv_scaled))
    return results


def icl_inference(
    train_ds,
    val_ds,
    ice_idx_list: list[list[int]],
    bundle,
    prompt_manager: PromptManager,
    bs: int,
    generate_kwargs: dict,
    instruction: str = "",
    progress: bool = True,
) -> dict:
    """True few-shot ICL eval (reference inference.py:324-378)."""
    gen_fn = make_generate_fn(bundle, generate_kwargs)
    results: dict = {}
    cursor = 0  # next ice_idx_list row
    for batch in _chunked(_maybe_tqdm(val_ds, progress), bs):
        real = len(batch)
        ice_ids = ice_idx_list[cursor : cursor + real]
        cursor += real
        ice_ids = ice_ids + [ice_ids[-1]] * (bs - real)
        padded = batch + [batch[-1]] * (bs - real)
        prompts = []
        for sample, shots in zip(padded, ice_ids):
            p = [instruction] if instruction else []
            for si in shots:
                shot = train_ds[si]
                p += [
                    shot["image"],
                    prompt_manager.gen_ice_text_with_label(shot, add_sep_token=True),
                ]
            p += [sample["image"], prompt_manager.gen_query_text_without_label(sample)]
            prompts.append(p)
        _store(results, batch, generate_answers(bundle, gen_fn, prompts, None))
    return results


def _icv_prompts(val_ds, prompt_manager, instruction: str, progress: bool):
    """``(sample, prompt)`` of each zero-shot question, as ``icv_inference``
    builds them."""
    for sample in _maybe_tqdm(val_ds, progress):
        p = [instruction] if instruction else []
        p += [sample["image"], prompt_manager.gen_query_text_without_label(sample)]
        yield sample, p


def _icl_prompts(train_ds, val_ds, ice_idx_list, prompt_manager, instruction: str,
                 progress: bool):
    """``(sample, prompt)`` of each few-shot question (its shots from
    ``ice_idx_list``), as ``icl_inference`` builds them."""
    for idx, sample in enumerate(_maybe_tqdm(val_ds, progress)):
        p = [instruction] if instruction else []
        for si in ice_idx_list[idx]:
            shot = train_ds[si]
            p += [shot["image"], prompt_manager.gen_ice_text_with_label(shot, add_sep_token=True)]
        p += [sample["image"], prompt_manager.gen_query_text_without_label(sample)]
        yield sample, p


def _run_continuous(prompt_iter, bundle, generate_kwargs: dict, icv_scaled, n_slots: int,
                    sync_steps: int) -> dict:
    """Encode each ``(sample, prompt)`` of ``prompt_iter`` into an engine
    ``Request``, serve them and return ``icv_inference``'s results dict
    (JAX runner.py:329-419).  ``num_beams > 1`` (the reference's beam-3
    default) takes ``BeamServingEngine``, greedy ``ServingEngine`` (whose
    admissions into an occupied pool ride a merged forward,
    ``ServingEngine.from_bundle``)."""
    from .serving import BeamServingEngine, Request, ServingEngine

    num_beams = int(generate_kwargs.get("num_beams", 1))
    max_new = int(generate_kwargs.get("max_new_tokens", 5))
    min_new = int(generate_kwargs.get("min_new_tokens", 0))
    proc = bundle.processor

    samples, requests = [], []
    for idx, (sample, p) in enumerate(prompt_iter):
        enc = proc.prepare_input([p], padding=True, padding_side="left")
        mask = np.asarray(enc["attention_mask"][0], bool)
        requests.append(Request(
            uid=idx, input_ids=np.asarray(enc["input_ids"][0])[mask],
            pixel_values=np.asarray(enc["pixel_values"][0]),
            pixel_valid=np.asarray(enc["pixel_valid"][0], bool),
            max_new=max_new, min_new=min_new,
            # Idefics2's NaViT real-pixel mask: the engine admits by its shape
            pixel_attention_mask=(np.asarray(enc["pixel_attention_mask"][0])
                                  if "pixel_attention_mask" in enc else None),
        ))
        samples.append(sample)

    # 64-multiple prompt buckets over the observed lengths
    buckets = tuple(sorted({-(-len(r.input_ids) // 64) * 64 for r in requests})) or (64,)
    kw = dict(
        icv_scaled=icv_scaled, n_slots=n_slots, out_cap=max(max_new, 1),
        prompt_buckets=buckets, sync_steps=sync_steps,
        # mixed-shot ICL: the media buffers carry the widest request's images
        max_images=max((r.pixel_values.shape[0] for r in requests), default=None),
    )
    if num_beams > 1:
        engine = BeamServingEngine.from_bundle(
            bundle, num_beams=num_beams,
            length_penalty=float(generate_kwargs.get("length_penalty", 0.0)), **kw,
        )
    else:
        engine = ServingEngine.from_bundle(bundle, **kw)
    for r in requests:
        engine.submit(r)
    tokens = engine.run()

    results = {}
    for idx, sample in enumerate(samples):
        text = bundle.tokenizer.batch_decode([tokens[idx]], skip_special_tokens=True)[0]
        row = {k: v for k, v in sample.items() if k != "image"}
        results[idx] = {"prediction": text, **row}
    return results


def icv_inference_continuous(
    val_ds,
    bundle,
    prompt_manager: PromptManager,
    generate_kwargs: dict,
    instruction: str = "",
    icv_scaled: Optional[torch.Tensor] = None,
    progress: bool = True,
    n_slots: int = 8,
    sync_steps: int = 4,
) -> dict:
    """``icv_inference`` through the continuous-batching engine: the same
    results, each request's tokens its own bs=1 decode's (in f32), with
    every slot kept busy on ragged workloads."""

    return _run_continuous(_icv_prompts(val_ds, prompt_manager, instruction, progress), bundle,
                           generate_kwargs, icv_scaled, n_slots, sync_steps)


def icl_inference_continuous(
    train_ds,
    val_ds,
    ice_idx_list: list[list[int]],
    bundle,
    prompt_manager: PromptManager,
    generate_kwargs: dict,
    instruction: str = "",
    progress: bool = True,
    n_slots: int = 8,
    sync_steps: int = 4,
) -> dict:
    """``icl_inference`` through the continuous-batching engine, the
    reference's raggedest workload (prompt lengths vary about 30x across
    ``few_shot_list``): mixed shot counts admit as groups of one bucket and
    image count against ``max_images``-wide media buffers."""

    return _run_continuous(
        _icl_prompts(train_ds, val_ds, ice_idx_list, prompt_manager, instruction, progress),
        bundle, generate_kwargs, None, n_slots, sync_steps)


def _run_pooled(prompt_iter, bundle, generate_kwargs: dict, icv_scaled,
                pool_questions: int) -> dict:
    """The pooled beam schedule (``infer_engine=pooled``, JAX
    runner.py:495-599): P = max_new − 1 staggered beam groups share every
    merged forward with the next question's prefill
    (``eval_chain.pooled_eval_chain``, which normalises the pixels and lays
    out the ICV as the bundle's own forwards do).

    Prompts bucket by 64-multiple length and image count; each bucket runs
    in chunks of ``pool_questions`` questions, the last padded by repeating
    its last question (the extra answers dropped); the answers are read
    back once a chunk.  Each question's tokens are ``beam_generate``'s at
    bs=1, so the results are the static beam path's in f32."""
    from .eval_chain import pooled_eval_chain

    chain = pooled_eval_chain(bundle, generate_kwargs)
    proc = bundle.processor
    samples, encs = [], []
    for sample, p in prompt_iter:
        enc = proc.prepare_input([p], padding=True, padding_side="left")
        if "pixel_attention_mask" in enc:
            raise ValueError("NaViT variable resolution is engine-only; use "
                             "infer_engine=continuous")
        mask = np.asarray(enc["attention_mask"][0], bool)
        encs.append((np.asarray(enc["input_ids"][0])[mask], np.asarray(enc["pixel_values"][0]),
                     np.asarray(enc["pixel_valid"][0], bool)))
        samples.append(sample)

    buckets: dict = {}  # (64-multiple length, image count) -> question indices
    for idx, (ids, px, _) in enumerate(encs):
        buckets.setdefault((max(-(-len(ids) // 64) * 64, 64), px.shape[0]), []).append(idx)

    dev, pad_id = bundle.device, bundle.pad_token_id
    answers: dict = {}
    for (bucket, n_img), idxs in sorted(buckets.items()):
        c = min(int(pool_questions), len(idxs))
        for lo in range(0, len(idxs), c):
            chunk = idxs[lo: lo + c]
            real = len(chunk)
            chunk = chunk + [chunk[-1]] * (c - real)
            ids = np.full((c, 1, bucket), pad_id, np.int32)
            mask = np.zeros((c, 1, bucket), np.int32)
            pixels = np.stack([encs[qi][1] for qi in chunk])[:, None]
            pvs = np.stack([encs[qi][2] for qi in chunk])[:, None]
            for r, qi in enumerate(chunk):  # left padding
                q_ids = encs[qi][0]
                ids[r, 0, bucket - len(q_ids):] = q_ids
                mask[r, 0, bucket - len(q_ids):] = 1
            out = chain(torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev),
                        torch.from_numpy(pixels).to(dev), torch.from_numpy(pvs).to(dev),
                        icv_scaled).cpu().numpy()  # (c, 1, max_new)
            for r, qi in enumerate(chunk[:real]):
                answers[qi] = bundle.tokenizer.batch_decode([out[r, 0]],
                                                            skip_special_tokens=True)[0]

    results = {}
    for idx, sample in enumerate(samples):
        row = {k: v for k, v in sample.items() if k != "image"}
        results[idx] = {"prediction": answers[idx], **row}
    return results


def icv_inference_pooled(
    val_ds,
    bundle,
    prompt_manager: PromptManager,
    generate_kwargs: dict,
    instruction: str = "",
    icv_scaled: Optional[torch.Tensor] = None,
    progress: bool = True,
    pool_questions: int = 32,
) -> dict:
    """``icv_inference`` through the pooled beam schedule: one-image VQA
    questions at the reference's decode settings (reference
    config/inference.yaml:11,26-30)."""

    return _run_pooled(_icv_prompts(val_ds, prompt_manager, instruction, progress), bundle,
                       generate_kwargs, icv_scaled, pool_questions)


def icl_inference_pooled(
    train_ds,
    val_ds,
    ice_idx_list: list[list[int]],
    bundle,
    prompt_manager: PromptManager,
    generate_kwargs: dict,
    instruction: str = "",
    progress: bool = True,
    pool_questions: int = 32,
) -> dict:
    """``icl_inference`` through the pooled beam schedule: mixed shot counts
    bucket by (prompt length, image count), each bucket its own chains."""

    return _run_pooled(
        _icl_prompts(train_ds, val_ds, ice_idx_list, prompt_manager, instruction, progress),
        bundle, generate_kwargs, None, pool_questions)


def _maybe_tqdm(it, enabled: bool):
    if not enabled:
        return it
    try:
        from tqdm import tqdm

        return tqdm(it, total=len(it))
    except ImportError:
        return it
