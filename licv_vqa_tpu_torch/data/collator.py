"""The 4-view ICV training collator.

Reference contract (icv_src/icv_datamodule.py:73-130): per batch tokenize
``query_prompt`` (query WITH label, +EOS), ``query_x`` (query WITHOUT label),
``ice_prompt`` (shots only) and the concatenation ``ice+query`` (+EOS); emit

- ``query_inputs``      — student inputs,
- ``inputs``            — teacher (full ICL) inputs,
- ``in_context_length`` — nonpad(ice) + nonpad-nonbos(query_x),
- ``query_x_length``    — nonpad(query_x).

All views are right-padded to bucket multiples (static shapes for XLA).
"""

from __future__ import annotations

import numpy as np


def _nonpad(view: dict) -> np.ndarray:
    # count via attention_mask (set positionally by prepare_input), NOT by
    # comparing input_ids to pad_id: when the tokenizer aliases pad to
    # another special token (unk/eos fallback), a real occurrence of that
    # token inside the prompt must still count toward the length
    return view["attention_mask"].sum(axis=1)


def collate_icv_batch(data_list: list[dict], processor) -> dict:
    query_prompt = [d["query_prompt"] for d in data_list]
    ice_prompt = [d["ice_prompt"] for d in data_list]
    query_x = [d["query_x"] for d in data_list]

    bos_id = processor.tokenizer.bos_token_id

    query_inputs = processor.prepare_input(
        query_prompt, padding=True, add_eos_token=True, padding_side="right"
    )
    # these two views are consumed only for their token LENGTHS — never
    # materialize their pixels (ice alone is 32 images/sample)
    query_x_enc = processor.prepare_input(
        query_x, padding=True, padding_side="right", with_pixels=False
    )
    ice_enc = processor.prepare_input(
        ice_prompt, padding=True, padding_side="right", with_pixels=False
    )
    inputs = processor.prepare_input(
        [list(i) + list(q) for i, q in zip(ice_prompt, query_prompt)],
        padding=True,
        add_eos_token=True,
        padding_side="right",
    )

    qx_ids = query_x_enc["input_ids"]
    query_x_nonbos = (
        (query_x_enc["attention_mask"] == 1) & (qx_ids != bos_id)
    ).sum(axis=1)
    in_context_length = (_nonpad(ice_enc) + query_x_nonbos).astype(np.int32)

    # Reject a truncated teacher: if the ICL view hit the processor's
    # max_length, the answer region (positions >= in_context_length) fell
    # off the end and the KL target is garbage.  Fail fast with the fix.
    tea_len = _nonpad(inputs)
    if np.any(in_context_length >= tea_len):
        bad = int(np.argmax(in_context_length >= tea_len))
        raise ValueError(
            f"teacher ICL view truncated: sample {bad} has "
            f"in_context_length={int(in_context_length[bad])} but only "
            f"{int(tea_len[bad])} teacher tokens (processor max_length="
            f"{processor.max_length}) — the answer region was cut off; "
            "raise lmm.max_length or lower few_shot_num"
        )
    return {
        "query_inputs": query_inputs,
        "inputs": inputs,
        "in_context_length": in_context_length,
        "query_x_length": _nonpad(query_x_enc).astype(np.int32),
    }
