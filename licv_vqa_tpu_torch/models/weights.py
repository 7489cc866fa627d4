"""Carry a JAX param tree across to the port.

The port keeps the JAX layout (nested dicts, ``(in, out)`` kernels,
layer-stacked leaves), so the conversion is per leaf: numpy (or anything
``np.asarray`` takes, such as a jax array) → ``torch.Tensor``.  Tests build
params with the JAX package's init and hand them to both sides: two random
inits never agree, since ``jax.random`` and ``torch.Generator`` draw
different numbers from the same seed.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..core.precision import to_torch_dtype
from ..ops.quantize import is_any_quantized_leaf


def _leaf(x: Any, dtype: Optional[torch.dtype], device, keep_bf16: bool = False) -> torch.Tensor:
    a = np.asarray(x)
    bf16 = a.dtype.kind == "V" or a.dtype.name == "bfloat16"  # ml_dtypes bf16
    if bf16:
        a = a.astype(np.float32)
    t = torch.from_numpy(np.array(a, copy=True))  # writable, contiguous
    if bf16 and keep_bf16:
        t = t.to(torch.bfloat16)  # exact: the values are bf16
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree: Any, dtype=None, device="cpu") -> Any:
    """Nested dict of arrays → the same nesting of tensors on ``device``.
    Floating leaves are cast to ``dtype`` when given (a torch dtype, or a
    JAX/numpy dtype or name such as ``jnp.bfloat16`` or ``"bf16"``); other
    leaves keep their dtype.  Quantized leaves keep JAX's dtypes whatever
    ``dtype`` is: int8/f32 for ``{"q", "s"}``, uint8/bf16 for
    ``{"q4", "s"}`` (rounding an int8 layer's f32 scales to bf16 would
    change its weights)."""
    if dtype is not None:
        dtype = to_torch_dtype(dtype)
    if is_any_quantized_leaf(tree):
        return {k: _leaf(v, None, device, keep_bf16=True) for k, v in tree.items()}
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_from_jax(v, dtype, device) for v in tree)
    return _leaf(tree, dtype, device)
