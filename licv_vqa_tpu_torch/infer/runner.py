"""Batched evaluation runners: ICV-steered zero-shot and few-shot ICL
(counterpart of the static path of ``licv_vqa_tpu/infer/runner.py``).

Prompts are LEFT-padded to bucket multiples by the shared processor; a short
final batch is padded to the batch size by repeating its last sample and the
extra rows are discarded (reference inference.py:264-267).  No mesh, no
pooled or continuous engine, no speculative draft: those wait for ROADMAP
Queue 1 items 12-16.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..data.prompt import PromptManager
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
    """One generate over (params, ids, mask, pixels, valid, icv).  The KV
    cache length follows the (bucketed) prompt length of each call."""
    max_new = int(generate_kwargs.get("max_new_tokens", 5))
    min_new = int(generate_kwargs.get("min_new_tokens", 0))
    num_beams = int(generate_kwargs.get("num_beams", 1))
    length_penalty = float(generate_kwargs.get("length_penalty", 0.0))
    if int(generate_kwargs.get("speculative_draft_layers", 0)) > 0:
        raise NotImplementedError(
            "speculative decoding is not ported to licv_vqa_tpu_torch yet "
            "(ROADMAP.md Queue 1 item 12)"
        )
    eos, pad = bundle.eos_token_id, bundle.pad_token_id

    @torch.inference_mode()
    def gen(params, input_ids, attention_mask, pixels, pixel_valid, icv_scaled):
        fwd = bundle.bind_decode(
            params, pixels, pixel_valid, input_ids, icv_scaled,
            input_ids.shape[1] + max_new + 1,
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


def _dispatch_generate(bundle, gen_fn: Callable, prompts: list[list], icv_scaled):
    """Tokenize, move to the bundle's device and launch one generation;
    returns ``(device_out, rows, prompt_len)``.  The launches are queued on
    the device stream; nothing is read back until ``_collect_generate``."""
    enc = bundle.processor.prepare_input(prompts, padding=True, padding_side="left")
    dev = bundle.device
    ids, mask, px, pv = (
        torch.from_numpy(np.asarray(enc[key])).to(dev)
        for key in ("input_ids", "attention_mask", "pixel_values", "pixel_valid")
    )
    out = gen_fn(bundle.params, ids, mask, px, pv, icv_scaled)
    return out, len(prompts), enc["input_ids"].shape[1]


def _collect_generate(bundle, pending) -> list[str]:
    """Wait for a ``_dispatch_generate`` handle and decode ONLY the
    continuation (reference inference.py:300-321)."""
    out, rows, prompt_len = pending
    out = out.cpu().numpy()[:rows]
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


def _maybe_tqdm(it, enabled: bool):
    if not enabled:
        return it
    try:
        from tqdm import tqdm

        return tqdm(it, total=len(it))
    except ImportError:
        return it
