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

import ctypes
import math

import torch

from .int8_matmul import KERNEL_MAX_ROWS, _check_operands, _sm_count

# the kernel's tiles (csrc/int4_matmul.cu): 128 output columns a block, 64
# packed rows a stage; the blocks of one column tile's split-K form one
# thread-block cluster, at most 8
TILE_N = 128
STAGE_ROWS = 64
MAX_SPLITS = 8
# the smallest group the kernel takes (a 64-row stage then touches at most
# 5 groups' scale rows)
MIN_GROUP = 16


def int4_matmul_usable(m: int, k: int, n: int, g: int) -> bool:
    """The shape rules of the function itself: decode-shaped (at most
    ``KERNEL_MAX_ROWS`` rows), even K, and groups that do not straddle the
    two nibble planes (``K/2 % G == 0``) of at least ``MIN_GROUP``
    in-features (the quantizer's are 64 or 32).  The TPU's ``m % 8`` and
    tile rules have no counterpart (ROADMAP Queue 3)."""
    return (0 < m <= KERNEL_MAX_ROWS and n > 0 and k % 2 == 0 and g >= MIN_GROUP
            and (k // 2) % g == 0)


def launch_plan(m: int, k2: int, n: int, n_sm: int) -> tuple[int, int]:
    """``(splits, rows_per_split)`` for M = ``m`` rows, K/2 = ``k2`` packed
    rows and N = ``n`` columns: split-K blocks (one cluster, at most
    ``MAX_SPLITS``) of whole 64-row stages, no split left empty, enough for
    about two blocks an SM up to 32 rows.  Above, the blocks' registers
    allow one an SM, and clusters of 4 such blocks over 128 SMs took two
    waves (a cluster's blocks share one GPC): at most half the SMs' worth
    of blocks (timed on the H100: PERF.md §6)."""
    tiles = math.ceil(n / TILE_N)
    stages = math.ceil(k2 / STAGE_ROWS)
    want = math.ceil(2 * n_sm / tiles) if m <= 32 else n_sm // (2 * tiles)
    splits = max(1, min(MAX_SPLITS, stages, want))
    per = math.ceil(stages / splits) * STAGE_ROWS
    return math.ceil(k2 / per), per


def _launch(x, packed, s, out_dtype, group: int) -> torch.Tensor:
    """Allocate the output, launch ``int4_matmul_bf16``, raise on a launch
    error."""
    from ..csrc import load_library

    m, k = x.shape
    k2, n = packed.shape
    splits, per = launch_plan(m, k2, n, _sm_count(x.device.index or 0))
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    fn = load_library("int4_matmul.cu").int4_matmul_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    err = fn(x.data_ptr(), packed.data_ptr(), s.data_ptr(), out.data_ptr(), m, k, n, group,
             splits, per, int(out_dtype == torch.float32),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int4_matmul_bf16 launch failed: cudaError {err}")
    return out


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
    if k != 2 * k2 or tuple(s.shape) != (k // group, n) or not int4_matmul_usable(m, k, n, group):
        raise ValueError(f"int4_matmul: x {tuple(x.shape)}, packed {tuple(packed.shape)}, "
                         f"s {tuple(s.shape)}, G={group} do not agree or the kernel does not "
                         f"take them (M <= {KERNEL_MAX_ROWS}, G >= {MIN_GROUP})")
    x = x.to(torch.bfloat16).contiguous()
    out = _launch(x, packed, s, out_dtype, group)
    int4_matmul.launches += 1
    return out


int4_matmul.launches = 0  # kernel launches (CUDA tensors only)
