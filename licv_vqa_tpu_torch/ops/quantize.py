"""Int8/int4 weight-only quantization of the frozen LMM and the int8 KV rows
(counterpart of ``licv_vqa_tpu/ops/quantize.py``).

Leaf formats are the JAX package's, byte for byte, so a quantized JAX tree
carries across unchanged (``models/weights.py``):

- int8 leaf: ``{"q": int8 (..., in, out), "s": f32 (..., 1, out)}``:
  per-OUTPUT-channel symmetric scales;
- int4 leaf: ``{"q4": uint8 (..., in/2, out), "s": bf16 (..., in/G, 1, out)}``:
  group-wise symmetric scales over G input features per output channel
  (round to nearest after a per-group MSE clip search, G=64 by default),
  nibble-packed in the mixed-plane layout: low nibble = ``q_lo + 8`` for
  in-feature ``i``, high nibble = two's-complement ``q_hi`` for in-feature
  ``i + in/2``.

``quantize_layer_stack`` quantizes a layer-stacked leaf one layer slice at
a time: the scales are per (group, column) within a layer, so the planes
and scales equal those of quantizing the whole stack, while the f32
temporaries stay at one layer's size.
"""

from __future__ import annotations

from typing import Any

import torch

_QKEYS = ("q", "s")
_Q4KEYS = ("q4", "s")
INT4_GROUP = 64
# MSE-optimal clipping candidates (fractions of the group absmax), the JAX
# package's order: the first candidate wins ties
_INT4_CLIP_CANDS = (1.0, 0.95, 0.9, 0.85)


def is_quantized_leaf(x: Any) -> bool:
    return isinstance(x, dict) and set(x.keys()) == set(_QKEYS)


def is_quantized4_leaf(x: Any) -> bool:
    return isinstance(x, dict) and set(x.keys()) == set(_Q4KEYS)


def is_any_quantized_leaf(x: Any) -> bool:
    return is_quantized_leaf(x) or is_quantized4_leaf(x)


def quantize_array(w: torch.Tensor) -> dict:
    """Per-output-channel (last axis) symmetric int8."""
    wf = w.float()
    amax = torch.amax(torch.abs(wf), dim=-2, keepdim=True)  # over in-features
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def _int4_group(k: int, group: int = INT4_GROUP) -> int:
    for g in (group, 64, 32):
        if k % g == 0:
            return g
    return k  # degenerate: one group per column


def _quantize_int4(w: torch.Tensor, group: int) -> dict:
    *lead, k, n = w.shape
    g = group
    wf = w.float().reshape(*lead, k // g, g, n)
    amax = torch.amax(torch.abs(wf), dim=-2, keepdim=True)  # (..., k/g, 1, n)
    best_e = best_s = None
    for c in _INT4_CLIP_CANDS:
        s = torch.clamp(amax * c, min=1e-8) / 7.0
        q = torch.clamp(torch.round(wf / s), -7, 7)
        e = torch.sum((q * s - wf) ** 2, dim=-2, keepdim=True)
        if best_e is None:
            best_e, best_s = e, s
        else:
            best_s = torch.where(e < best_e, s, best_s)
            best_e = torch.minimum(e, best_e)
    best_s = best_s.to(torch.bfloat16).float()  # the storage dtype's values
    qi = torch.clamp(torch.round(wf / best_s), -7, 7).to(torch.int8)
    qi = qi.reshape(*lead, k, n)
    k2 = k // 2
    lo = (qi[..., :k2, :] + 8).to(torch.uint8)  # biased low plane
    hi = qi[..., k2:, :].to(torch.uint8) & 0xF  # two's-complement high plane
    return {"q4": lo | (hi << 4), "s": best_s.to(torch.bfloat16)}


def quantize_array_int4(w: torch.Tensor, group: int = INT4_GROUP) -> dict:
    """Group-wise symmetric int4, nibble-packed into uint8 (module
    docstring).  Expect ~10% relative weight RMS error at G=64."""
    k = w.shape[-2]
    if k % 2:
        raise ValueError(f"int4 nibble packing requires even in-features, got {k}")
    return _quantize_int4(w, _int4_group(k, group))


def _unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """The signed nibbles of a packed ``(..., K/2, N)`` plane, as int8
    ``(..., K, N)`` in original feature order."""
    lo = (packed & 0xF).to(torch.int8) - 8  # biased low plane
    hi = packed.view(torch.int8) >> 4  # arithmetic shift: two's complement
    return torch.cat([lo, hi], dim=-2)


def dequantize_int4(leaf: dict, dtype) -> torch.Tensor:
    packed, s = leaf["q4"], leaf["s"]
    *lead, k2, n = packed.shape
    k = 2 * k2
    kg = s.shape[-3]
    q = _unpack_int4(packed)
    wf = q.float().reshape(*lead, kg, k // kg, n) * s.float()
    return wf.reshape(*lead, k, n).to(dtype)


def _should_quantize(path: tuple, leaf: Any) -> bool:
    if not isinstance(leaf, torch.Tensor) or leaf.ndim < 2:
        return False
    if not leaf.is_floating_point():
        return False
    names = [str(p) for p in path]
    # norm params live under a norm-named dict as {"w", "b"}: the bare "w"
    # leaf key must not match the projection patterns below
    if any(n.startswith("ln") or n.endswith("_ln") or "norm" in n for n in names):
        return False
    name = next((n for n in names[::-1] if n), "")
    return name.startswith(("w", "fc", "c_proj", "ff_"))


def _quantize_leaf(leaf: torch.Tensor, mode: str) -> dict:
    if leaf.ndim < 3:
        return {"int8": quantize_array, "int4": quantize_array_int4}[mode](leaf)
    # one layer slice at a time into the stacked leaf (the same planes and
    # scales as quantizing the whole stack at once)
    first = _quantize_leaf(leaf[0], mode)
    out = {
        key: torch.empty((leaf.shape[0], *v.shape), dtype=v.dtype, device=v.device)
        for key, v in first.items()
    }
    for i in range(leaf.shape[0]):
        part = first if i == 0 else _quantize_leaf(leaf[i], mode)
        for key, v in part.items():
            out[key][i] = v
    return out


def quantize_layer_stack(layers: Any, mode: str = "int8", _path: tuple = ()) -> Any:
    """Quantize every weight matrix in a (stacked) layer param dict."""
    if isinstance(layers, dict):
        return {k: quantize_layer_stack(v, mode, _path + (k,)) for k, v in layers.items()}
    if _should_quantize(_path, layers):
        return _quantize_leaf(layers, mode)
    return layers


def dequantize_tree(tree: Any, dtype) -> Any:
    """Restore compute-dtype weights."""
    if is_quantized_leaf(tree):
        return (tree["q"].float() * tree["s"]).to(dtype)
    if is_quantized4_leaf(tree):
        return dequantize_int4(tree, dtype)
    if isinstance(tree, dict):
        return {k: dequantize_tree(v, dtype) for k, v in tree.items()}
    return tree


def quantize_kv_rows(x: torch.Tensor) -> tuple:
    """Per-(…, head) symmetric int8 over the LAST (head_dim) axis:
    ``(q int8 (..., Dh), s f32 (..., 1))``."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * s).to(dtype)


def quantization_error(w: torch.Tensor, mode: str = "int8") -> float:
    """Relative Frobenius error of round-tripping one matrix (diagnostics)."""
    if mode == "int4":
        back = dequantize_int4(quantize_array_int4(w), torch.float32)
    else:
        qd = quantize_array(w)
        back = qd["q"].float() * qd["s"]
    wf = w.float()
    return float(torch.linalg.norm(back - wf) / torch.clamp(torch.linalg.norm(wf), min=1e-9))
