"""Per-model-family output postprocessing (reference: utils.py:115-133)."""

from __future__ import annotations

from .okvqa_stem import postprocess_ok_vqa_generation
from .vqa_accuracy import postprocess_vqa_generation


def caption_postprocess(text: str, model_name: str) -> str:
    if "flamingo" in model_name:
        return text.split("Output", 1)[0].replace('"', "").strip()
    return text.split("Caption", 1)[0].replace('"', "").replace("\n", "").strip()


def vqa_postprocess(text: str, model_name: str) -> str:
    if "flamingo" in model_name:
        return postprocess_vqa_generation(text).strip()
    return postprocess_vqa_generation(text).replace("\n", "").strip()


def ok_vq_postprocess(text: str, model_name: str) -> str:
    if "flamingo" in model_name:
        return postprocess_ok_vqa_generation(text).strip()
    return postprocess_ok_vqa_generation(text).replace("\n", "").strip()
