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


def _leaf(x: Any, dtype: Optional[torch.dtype], device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":  # ml_dtypes bf16
        a = a.astype(np.float32)
    t = torch.from_numpy(np.array(a, copy=True))  # writable, contiguous
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree: Any, dtype=None, device="cpu") -> Any:
    """Nested dict of arrays → the same nesting of tensors on ``device``.
    Floating leaves are cast to ``dtype`` when given (a torch dtype, or a
    JAX/numpy dtype or name such as ``jnp.bfloat16`` or ``"bf16"``); other
    leaves keep their dtype."""
    if dtype is not None:
        dtype = to_torch_dtype(dtype)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_from_jax(v, dtype, device) for v in tree)
    return _leaf(tree, dtype, device)
