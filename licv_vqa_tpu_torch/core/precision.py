"""Precision policy: bf16 params and activations; norms, softmax, logits and
losses in f32 (counterpart of ``licv_vqa_tpu/core/precision.py``).

Also maps the dtype names the configs and the JAX package use (``"bf16"``,
``"bfloat16"``, ``"float32"``, numpy dtypes) to ``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

import torch


class Precision(str, enum.Enum):
    BF16 = "bf16"
    F32 = "fp32"
    BF16_MIXED = "bf16-mixed"
    F16_MIXED = "16-mixed"  # accepted for config parity; mapped to bf16


_DTYPES = {
    Precision.BF16: torch.bfloat16,
    Precision.F32: torch.float32,
    Precision.BF16_MIXED: torch.bfloat16,
    Precision.F16_MIXED: torch.bfloat16,
}

_NAMES = {
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "fp32": torch.float32,
    "f32": torch.float32,
    "float32": torch.float32,
    "fp16": torch.float16,
    "float16": torch.float16,
    "int32": torch.int32,
    "int64": torch.int64,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "bool": torch.bool,
}


def to_torch_dtype(dt: Any) -> torch.dtype:
    """``torch.dtype`` for a torch dtype, a dtype name, or a numpy/JAX dtype
    (anything whose ``str()`` or ``.name`` is a known name)."""
    if isinstance(dt, torch.dtype):
        return dt
    name = getattr(dt, "name", None) or getattr(dt, "__name__", None) or str(dt)
    try:
        return _NAMES[str(name).lower()]
    except KeyError:
        raise ValueError(f"no torch dtype for {dt!r}") from None


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """dtypes for (frozen) params, activations, and loss math."""

    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    loss_dtype: torch.dtype = torch.float32

    @classmethod
    def from_string(cls, s: str) -> "PrecisionPolicy":
        dt = _DTYPES[Precision(s)]
        return cls(param_dtype=dt, compute_dtype=dt, loss_dtype=torch.float32)

    def cast_params(self, tree: Any) -> Any:
        if isinstance(tree, dict):
            return {k: self.cast_params(v) for k, v in tree.items()}
        if isinstance(tree, torch.Tensor) and tree.is_floating_point():
            return tree.to(self.param_dtype)
        return tree
