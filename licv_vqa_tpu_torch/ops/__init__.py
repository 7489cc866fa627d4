from .icv_inject import icv_inject, icv_inject_reference
from .kl import (
    aligned_teacher_gather,
    answer_region_mask,
    masked_kl_divergence,
    shifted_cross_entropy,
)

__all__ = [
    "aligned_teacher_gather",
    "answer_region_mask",
    "icv_inject",
    "icv_inject_reference",
    "masked_kl_divergence",
    "shifted_cross_entropy",
]
