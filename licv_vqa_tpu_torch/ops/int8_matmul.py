"""Quantized-weight matmuls: ``qdot`` and the int8 decode kernel's wrapper
(counterpart of ``licv_vqa_tpu/ops/int8_matmul.py``).

``qdot(x, w)`` takes a plain weight or a quantized leaf (``ops/quantize.py``)
and picks its route by the leaf and the call's shape, as JAX's does:

- plain weight: ``x @ w``;
- int4 leaf: the int4 kernel (``ops/int4_matmul.py``) for decode-shaped
  calls (at most ``KERNEL_MAX_ROWS`` rows), else dequantize + matmul;
- int8 leaf with ``a8``: w8a8, per-row int8 activations times the int8
  weight with an exact int32 accumulator (``w8a8_matmul``: on the card
  ``csrc/w8a8_matmul.cu``, where JAX leaves it to XLA);
- int8 leaf, decode-shaped: the int8 kernel (``int8_matmul``);
- int8 leaf, otherwise: scale-on-output, ``(x @ q) * s``.

Three routing rules differ from JAX's (ROADMAP Queue 3): the int8 kernel
is on by default (JAX keeps it behind ``LICV_INT8_PALLAS=1`` because
inside ``lax.scan`` it broke XLA's cross-op pipelining; eager PyTorch has
no such fusion, and the scale-on-output route widens the whole weight on
every call); w8a8 goes through a hand-written kernel, which computes what
XLA computes for JAX, bit for bit; and no kernel asks for ``m % 8 == 0``,
a tileable shape or rows padded to 8.

Kernel wrappers (``int8_matmul`` and ``w8a8_matmul`` here,
``int4_matmul``) launch their kernel for CUDA tensors or raise; CPU
tensors take the plain version.  The
kernel routes carry an activation-only backward (``_FrozenWeightMatmul``):
the quantized weights are frozen in ICV training.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .quantize import dequantize_int4, is_quantized4_leaf, is_quantized_leaf

# decode-shaped calls (beam rows, prefill blocks and bind K/V of at most
# this many rows) take the kernels
KERNEL_MAX_ROWS = 64


# ---------------------------------------------------------------------------
# The int8 kernel's launch plan (csrc/int8_matmul.cu)
# ---------------------------------------------------------------------------

# the kernel's tiles: 128 output columns and up to 64 rows a block, 64
# weight rows a stage; the blocks of one tile's split-K form one
# thread-block cluster: the kernel takes up to 8, the plan asks for at most
# 6 (on the H100, 8 were slower than 6 at every beam-step shape and 1.4x at
# 64 rows: clusters of 8 did not all fit in one wave; PERF.md §6)
INT8_TILE_N = 128
INT8_TILE_M = 64
INT8_STAGE_ROWS = 64
INT8_MAX_SPLITS = 6


def tma_path(k: int, n: int, x_addr: int = 0, q_addr: int = 0) -> bool:
    """Whether the kernel streams its operands by TMA: row pitches of 16
    bytes (``N % 16 == 0`` and ``K % 8 == 0``) and 16-byte aligned x and
    q.  Else its producer warpgroup's plain loads take any pitch (the
    Idefics-9B head's N = 32002, the card tests' odd N)."""
    return n % 16 == 0 and k % 8 == 0 and x_addr % 16 == 0 and q_addr % 16 == 0


def launch_plan(m: int, k: int, n: int, n_sm: int) -> tuple[int, int]:
    """``(splits, rows_per_split)`` for M = ``m`` rows, K = ``k`` weight rows
    and N = ``n`` columns: split-K blocks (one cluster, at most
    ``INT8_MAX_SPLITS``) of whole 64-row stages, none left empty, enough
    for about two blocks an SM where the cluster allows."""
    tiles = math.ceil(n / INT8_TILE_N) * math.ceil(m / INT8_TILE_M)
    stages = math.ceil(k / INT8_STAGE_ROWS)
    splits = max(1, min(INT8_MAX_SPLITS, stages, math.ceil(2 * n_sm / tiles)))
    per = math.ceil(stages / splits) * INT8_STAGE_ROWS
    return math.ceil(k / per), per


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(x, w, s, out_dtype):
    """Allocate the output, launch ``int8_matmul_bf16``, raise on a launch
    error."""
    from ..csrc import load_library

    m, k = x.shape
    n = w.shape[1]
    splits, per = launch_plan(m, k, n, _sm_count(x.device.index or 0))
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    fn = load_library("int8_matmul.cu").int8_matmul_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    err = fn(
        x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(), m, k, n, splits, per,
        int(tma_path(k, n, x.data_ptr(), w.data_ptr())), int(out_dtype == torch.float32),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"int8_matmul_bf16 launch failed: cudaError {err}")
    return out


def _check_operands(name: str, x, w, s, w_dtype, s_dtype, out_dtype) -> None:
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{name}: x and the weight must be 2-D, got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    for t, what in ((w, "weight"), (s, "scales")):
        if t.device != x.device:
            raise ValueError(f"{name}: {what} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if w.dtype != w_dtype or s.dtype != s_dtype:
        raise TypeError(f"{name}: weight {w.dtype} / scales {s.dtype}, want "
                        f"{w_dtype} / {s_dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: out_dtype must be bf16 or f32, got {out_dtype}")


# ---------------------------------------------------------------------------
# The int8 kernel and its plain version
# ---------------------------------------------------------------------------


def int8_matmul_reference(x, q, s, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of ``int8_matmul``: ``(x @ q) * s`` in f32, as JAX's
    fallback computes it (int8_matmul.py:224-228)."""
    return ((x.float() @ q.float()) * s.reshape(1, -1).float()).to(out_dtype)


def int8_matmul(x, q, s, out_dtype=None) -> torch.Tensor:
    """``(x @ q) * s``: x (M, K), q (K, N) int8, s (1, N) or (N,) f32 per
    output column (counterpart of ``int8_matmul_pallas``).

    CUDA tensors launch the hand-written kernel ``csrc/int8_matmul.cu``
    (x in bf16, as the TPU kernel casts it; f32 accumulation; output bf16
    or f32) or raise; CPU tensors take ``int8_matmul_reference``."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return int8_matmul_reference(x, q, s, out_dtype)
    s = s.reshape(-1)
    _check_operands("int8_matmul", x, q, s, torch.int8, torch.float32, out_dtype)
    if s.numel() != q.shape[1] or x.shape[1] != q.shape[0]:
        raise ValueError(f"int8_matmul: x {tuple(x.shape)}, q {tuple(q.shape)}, "
                         f"s {tuple(s.shape)} do not agree")
    x = x.to(torch.bfloat16).contiguous()
    out = _launch(x, q, s, out_dtype)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0  # kernel launches (CUDA tensors only)


# ---------------------------------------------------------------------------
# w8a8
# ---------------------------------------------------------------------------


# the reciprocal JAX multiplies by: under ``jit`` XLA rewrites ``a / 127.0``
# as ``a * f32(1/127)`` (eager JAX divides; the two differ by an ulp in a
# few rows in 25, and JAX runs w8a8 under jit)
INV_127 = 1.0 / 127.0
# w8a8 kernel tiles (rows x columns of the output a block computes), the
# instantiations of csrc/w8a8_matmul.cu in its order: one, which streams the
# weight at run A's 64 rows (split-K in a cluster) and beat two compute
# tiles at the tool's 4096 and 16384 (PERF.md §6)
W8A8_TILES = ("64x128",)
# the w8a8 kernel's K bytes a stage and its largest cluster (split-K blocks)
_W8A8_STAGE_K = 128
_W8A8_MAX_SPLITS = 8


def quantize_act_rows(x: torch.Tensor):
    """Dynamic per-row symmetric int8 quantization of activations:
    ``(int8 plane, f32 scale (..., 1))`` with ``scale = absmax · f32(1/127)``
    over the contraction dim, as JAX computes it under jit; all-zero rows
    get a floor scale."""
    xf = x.float()
    absmax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) * INV_127
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def _int_product(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The exact integer product of two int8 matrices, as f32 (JAX:
    ``dot_general`` s8 x s8 -> s32, then a cast).  On the card
    ``torch._int_mm``, which wants more than 16 rows and K, N multiples of
    8: the rows are zero-padded to a multiple of 8 above 16.  Elsewhere an
    f64 matmul, exact for these magnitudes (|sum| < 2^53)."""
    m, k = xq.shape
    n = q.shape[1]
    if xq.device.type == "cuda" and k % 8 == 0 and n % 8 == 0:
        return torch._int_mm(pad_rows_for_int_mm(xq), q)[:m].float()
    return (xq.double() @ q.double()).float()


def pad_rows_for_int_mm(xq: torch.Tensor) -> torch.Tensor:
    """``xq`` zero-padded to the rows ``torch._int_mm`` takes: at least 24,
    a multiple of 8."""
    m, k = xq.shape
    mp = max(24, math.ceil(m / 8) * 8)
    return xq if mp == m else torch.cat([xq, xq.new_zeros((mp - m, k))])


def w8a8_matmul_reference(x, q, s, out_dtype) -> torch.Tensor:
    """Plain version of ``w8a8_matmul``: int8 activations x int8 weight with
    an int32 accumulator; the per-row activation scale and the per-column
    weight scale both commute out of the K contraction and apply to the f32
    accumulator, ``(acc · xs) · s``."""
    xq, xs = quantize_act_rows(x)
    return w8a8_prequantized_reference(xq, xs, q, s, out_dtype)


def w8a8_prequantized_reference(xq, xs, q, s, out_dtype) -> torch.Tensor:
    """Plain version of ``w8a8_matmul_prequantized``."""
    return (_int_product(xq, q) * xs * s.reshape(1, -1)).to(out_dtype)


def _w8a8_tile(tile) -> int:
    """Index into ``W8A8_TILES``: the caller's, else the first."""
    return W8A8_TILES.index(tile or W8A8_TILES[0])


def _w8a8_splits(m: int, k: int, n: int, tile: int, n_sm: int) -> int:
    """Blocks of one cluster that share a tile's K stages (of 128): as many
    as fill about three quarters of the SMs with one block each, at most 8,
    each with whole stages and none empty (the kernel's own arithmetic).
    Timed on the H100 at run A's shapes (PERF.md §6): two blocks an SM,
    though their shared memory fits, and clusters over all the SMs (a
    cluster's blocks share a GPC, so the last ones wait for a second wave)
    were slower."""
    bm, bn = (int(v) for v in W8A8_TILES[tile].split("x"))
    tiles = math.ceil(n / bn) * math.ceil(m / bm)
    stages = math.ceil(k / _W8A8_STAGE_K)
    want = max(1, min(_W8A8_MAX_SPLITS, stages, 3 * n_sm // (4 * tiles)))
    per = math.ceil(stages / want)  # the kernel's stages a split: none left empty
    return math.ceil(stages / per)


def _w8a8_launch(fn_name: str, a, xs, q, s, out_dtype, tile) -> torch.Tensor:
    """Launch one entry point of ``csrc/w8a8_matmul.cu``.  ``xs`` is None for
    the fused one, which writes the rows' int8 plane and scales into a
    scratch of its own (one pass over x), then runs the matmul on them."""
    from ..csrc import load_library

    m, k = a.shape
    n = q.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    xq = None
    if xs is None:
        xq = torch.empty((m, k), dtype=torch.int8, device=a.device)
        xs = torch.empty((m,), dtype=torch.float32, device=a.device)
    ti = _w8a8_tile(tile)
    splits = _w8a8_splits(m, k, n, ti, _sm_count(a.device.index or 0))
    fn = getattr(load_library("w8a8_matmul.cu"), fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    err = fn(
        a.data_ptr(), xq.data_ptr() if xq is not None else None, xs.data_ptr(), q.data_ptr(),
        s.data_ptr(), out.data_ptr(), m, k, n, int(a.dtype == torch.float32), ti, splits,
        int(out_dtype == torch.float32), torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {err}")
    return out


def _check_w8a8(name, a, q, s, out_dtype, a_dtypes) -> torch.Tensor:
    s = s.reshape(-1)
    _check_operands(name, a, q, s, torch.int8, torch.float32, out_dtype)
    if a.dtype not in a_dtypes:
        raise TypeError(f"{name}: activations {a.dtype}, want one of {a_dtypes}")
    if s.numel() != q.shape[1] or a.shape[1] != q.shape[0]:
        raise ValueError(f"{name}: x {tuple(a.shape)}, q {tuple(q.shape)}, "
                         f"s {tuple(s.shape)} do not agree")
    return s


def w8a8_matmul(x, q, s, out_dtype, tile=None) -> torch.Tensor:
    """w8a8 from bf16 or f32 ``x`` (M, K): each row quantized to int8 with
    its own scale, times the int8 weight q (K, N) with an exact int32 sum,
    then ``(acc · xs) · s`` with s the (1, N) or (N,) f32 column scales
    (counterpart of the TPU probe's ``w8a8_fused_kernel``,
    tools/exp_w8a8_tuning.py:67; JAX's production w8a8 is XLA,
    ``_w8a8_dot``).

    CUDA tensors launch the fused entry point of ``csrc/w8a8_matmul.cu``
    (a row pass writes each row's scale and int8 plane, then the matmul;
    ``tile`` one of ``W8A8_TILES``) or raise; CPU tensors
    take ``w8a8_matmul_reference``.  Bit-equal to the reference."""
    if x.device.type == "cpu":
        return w8a8_matmul_reference(x, q, s, out_dtype)
    s = _check_w8a8("w8a8_matmul", x, q, s, out_dtype, (torch.bfloat16, torch.float32))
    out = _w8a8_launch("w8a8_matmul_fused", x.contiguous(), None, q, s, out_dtype, tile)
    w8a8_matmul.launches += 1
    return out


w8a8_matmul.launches = 0  # kernel launches (CUDA tensors only), both entry points


def w8a8_matmul_prequantized(xq, xs, q, s, out_dtype, tile=None) -> torch.Tensor:
    """``(float(xq @ q) · xs) · s`` from activations quantized beforehand
    (``quantize_act_rows``): xq (M, K) int8, xs (M, 1) f32 (the TPU probe's
    ``w8a8_kernel``, tools/exp_w8a8_tuning.py:61).  CUDA tensors launch the
    pre-quantized kernel of ``csrc/w8a8_matmul.cu`` or raise; CPU tensors
    take ``w8a8_prequantized_reference``."""
    if xq.device.type == "cpu":
        return w8a8_prequantized_reference(xq, xs, q, s, out_dtype)
    s = _check_w8a8("w8a8_matmul_prequantized", xq, q, s, out_dtype, (torch.int8,))
    xs = xs.reshape(-1)
    if xs.numel() != xq.shape[0] or xs.dtype != torch.float32 or xs.device != xq.device:
        raise ValueError(f"w8a8_matmul_prequantized: xs {tuple(xs.shape)} {xs.dtype} does "
                         f"not match xq {tuple(xq.shape)}")
    out = _w8a8_launch("w8a8_matmul_prequantized", xq.contiguous(), xs.contiguous(), q, s,
                       out_dtype, tile)
    w8a8_matmul.launches += 1
    return out


# ---------------------------------------------------------------------------
# qdot
# ---------------------------------------------------------------------------


class _FrozenWeightMatmul(torch.autograd.Function):
    """A quantized-weight matmul differentiable with respect to ``x`` only
    (JAX ``_frozen_weight_vjp``): ``gx = gy @ W^T`` with ``W`` the exact
    dequantized weight, widened only on the backward pass."""

    @staticmethod
    def forward(ctx, x, matmul, dense_weight):
        ctx.dense_weight = dense_weight
        ctx.x_dtype = x.dtype
        return matmul(x)

    @staticmethod
    def backward(ctx, gy):
        w = ctx.dense_weight().float()
        return (gy.float() @ w.T).to(ctx.x_dtype), None, None


def _frozen(x, matmul, dense_weight):
    if torch.is_grad_enabled() and x.requires_grad:
        return _FrozenWeightMatmul.apply(x, matmul, dense_weight)
    return matmul(x)


def qdot(x: torch.Tensor, w, preferred_element_type=None, a8: bool = False) -> torch.Tensor:
    """``x @ w`` where ``w`` is a plain tensor or an int8 ``{"q", "s"}`` /
    int4 ``{"q4", "s"}`` leaf; the output dtype is ``preferred_element_type``
    or x's.  Leading dims of ``x`` are flattened for the quantized routes.
    ``a8`` (callers gate it on a token count, ``decoder.W8A8_MIN_TOKENS``)
    takes the w8a8 route for int8 leaves and is ignored by the others."""
    if not (is_quantized_leaf(w) or is_quantized4_leaf(w)):
        y = x @ w
        return y if preferred_element_type is None else y.to(preferred_element_type)
    out_dtype = preferred_element_type or x.dtype
    lead = x.shape[:-1]
    m = math.prod(lead)
    if is_quantized4_leaf(w):
        from .int4_matmul import int4_matmul, int4_matmul_usable

        packed, s = w["q4"], w["s"]
        k2, n = packed.shape[-2:]
        k, kg = 2 * k2, s.shape[-3]
        if packed.dim() == 2 and int4_matmul_usable(m, k, n, k // kg):
            y = _frozen(
                x.reshape(m, k),
                lambda xv: int4_matmul(xv, packed, s.reshape(kg, n), k // kg, out_dtype),
                lambda: dequantize_int4(w, torch.float32),
            )
            return y.reshape(*lead, n)
        y = x @ dequantize_int4(w, x.dtype)
        return y if preferred_element_type is None else y.to(preferred_element_type)
    q, s = w["q"], w["s"]
    k, n = q.shape
    xm = x.reshape(m, k)
    if a8:
        y = _frozen(xm, lambda xv: w8a8_matmul(xv, q, s, out_dtype), lambda: q.float() * s)
    elif m <= KERNEL_MAX_ROWS:
        y = _frozen(xm, lambda xv: int8_matmul(xv, q, s, out_dtype), lambda: q.float() * s)
    else:
        # scale-on-output: the per-column scale commutes with the contraction
        y = ((xm @ q.to(x.dtype)).float() * s.reshape(1, -1)).to(out_dtype)
    return y.reshape(*lead, n)
