"""The int4 decode kernel's wrapper (counterpart of
``licv_vqa_tpu/ops/int4_matmul.py``).

The kernel (``csrc/int4_matmul.cu``) reads the packed stacks that
``ops/quantize.py`` writes, unchanged: ``packed (K/2, N) uint8`` with the
low nibble holding ``q_lo + 8`` for in-feature ``i`` and the high nibble
two's-complement ``q_hi`` for in-feature ``i + K/2``, and ``s (K/G, N)``
bf16 group scales over G in-features in original order.  It decodes both
planes to their signed values itself, so the TPU wrapper's pre-divided
high-plane scales (int4_matmul.py:158) and its +8 correction matmul
(:185-191), both Mosaic workarounds, have no counterpart here.
"""

from __future__ import annotations

import torch

from .int8_matmul import KERNEL_MAX_ROWS, _check_operands, _launch


def int4_matmul_usable(m: int, k: int, n: int, g: int) -> bool:
    """The shape rules of the function itself: decode-shaped (at most
    ``KERNEL_MAX_ROWS`` rows), even K, and groups that do not straddle the
    two nibble planes (``K/2 % G == 0``).  The TPU's ``m % 8`` and tile
    rules have no counterpart (ROADMAP Queue 3)."""
    return 0 < m <= KERNEL_MAX_ROWS and n > 0 and k % 2 == 0 and g > 0 and (k // 2) % g == 0


def int4_matmul_reference(x, packed, s, group: int, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of ``int4_matmul``: dequantize, then an f32 matmul, as
    JAX's fallback computes it (int8_matmul.py:198-203)."""
    from .quantize import dequantize_int4

    k2, n = packed.shape
    w = dequantize_int4({"q4": packed, "s": s.reshape(-1, 1, n)}, torch.float32)
    return (x.float() @ w).to(out_dtype)


def int4_matmul(x, packed, s, group: int, out_dtype=None) -> torch.Tensor:
    """``x @ dequant(packed, s)``: x (M, K), packed (K/2, N) uint8, s
    (K/G, N) bf16 (counterpart of ``int4_matmul_pallas``).

    CUDA tensors launch the hand-written kernel ``csrc/int4_matmul.cu``
    (x in bf16, f32 accumulation, output bf16 or f32) or raise; CPU tensors
    take ``int4_matmul_reference``."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return int4_matmul_reference(x, packed, s, group, out_dtype)
    _check_operands("int4_matmul", x, packed, s, torch.uint8, torch.bfloat16, out_dtype)
    m, k = x.shape
    k2, n = packed.shape
    if k != 2 * k2 or tuple(s.shape) != (k // group, n) or not int4_matmul_usable(1, k, n, group):
        raise ValueError(f"int4_matmul: x {tuple(x.shape)}, packed {tuple(packed.shape)}, "
                         f"s {tuple(s.shape)}, G={group} do not agree")
    x = x.to(torch.bfloat16).contiguous()
    out = _launch("int4_matmul_bf16", "int4_matmul.cu", x, packed, s, out_dtype, k2, (group,))
    int4_matmul.launches += 1
    return out


int4_matmul.launches = 0  # kernel launches (CUDA tensors only)
