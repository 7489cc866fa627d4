from .vqa_accuracy import (
    compute_vqa_accuracy,
    normalize_vqa_answer,
    postprocess_vqa_generation,
)
from .okvqa_stem import OKVQAStemmer, postprocess_ok_vqa_generation
from .cider import compute_cider
from .postprocess import caption_postprocess, ok_vq_postprocess, vqa_postprocess

__all__ = [
    "compute_vqa_accuracy",
    "normalize_vqa_answer",
    "postprocess_vqa_generation",
    "OKVQAStemmer",
    "postprocess_ok_vqa_generation",
    "compute_cider",
    "caption_postprocess",
    "ok_vq_postprocess",
    "vqa_postprocess",
]
