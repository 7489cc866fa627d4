"""Transformer building blocks as plain functions over param dicts
(counterpart of ``licv_vqa_tpu/models/layers.py``).

Numerical conventions are the JAX package's, which follow HF LLaMA: RMSNorm
in f32, RoPE in the rotate-half form, attention scores and softmax in f32,
SwiGLU MLP.  Kernels are stored ``(in_features, out_features)``.

A bf16 matmul rounds its output to bf16 before any f32 upcast (as HF's
PyTorch modules do), where JAX asks for an f32 result
(``preferred_element_type``); the two agree exactly in f32, which is how the
tests compare them.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.int8_matmul import qdot

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


def layer_norm(
    w: torch.Tensor, b: Optional[torch.Tensor], x: torch.Tensor, eps: float
) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * w.float()
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (HF rotate-half convention)
# ---------------------------------------------------------------------------


def rope_cos_sin(
    positions: torch.Tensor,  # (B, S) int
    head_dim: int,
    theta: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    exponent = (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
        / head_dim
    )
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exponent)
    angles = positions.float()[..., None] * inv_freq  # (B, S, Dh/2)
    angles = torch.cat([angles, angles], dim=-1)  # (B, S, Dh)
    return torch.cos(angles), torch.sin(angles)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, Dh); cos/sin: (B, S, Dh)."""
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


# ---------------------------------------------------------------------------
# ALiBi (the MPT backbone of OpenFlamingo)
# ---------------------------------------------------------------------------


def alibi_slopes(n_heads: int, device=None) -> torch.Tensor:
    """(H,) f32 per-head slopes (Press et al.): ``2^(-8i/n)`` for a power of
    two ``n``; otherwise those of the nearest lower power of two followed by
    every other slope of the next one (JAX layers.py:81-94)."""

    def pow2slopes(n: int) -> torch.Tensor:
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3.0)))
        return start ** torch.arange(1, n + 1, dtype=torch.float32, device=device)

    if math.log2(n_heads).is_integer():
        return pow2slopes(n_heads)
    closest = 2 ** math.floor(math.log2(n_heads))
    extra = pow2slopes(2 * closest)[0::2][: n_heads - closest]
    return torch.cat([pow2slopes(closest), extra])


def alibi_bias(n_heads: int, q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    """ALiBi additive bias (B, H, Sq, Sk) f32: ``-slope_h · (q_pos − k_pos)``."""
    slopes = alibi_slopes(n_heads, q_pos.device)
    rel = (q_pos[:, :, None] - k_pos[:, None, :]).float()  # (B, Sq, Sk)
    return -slopes[None, :, None, None] * rel[:, None, :, :]


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KV, Dh) → (B, S, KV*n_rep, Dh)."""
    if n_rep == 1:
        return x
    b, s, kv, dh = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, n_rep, dh).reshape(b, s, kv * n_rep, dh)


def dot_product_attention(
    q: torch.Tensor,  # (B, Sq, H, Dh)
    k: torch.Tensor,  # (B, Sk, H, Dh)
    v: torch.Tensor,  # (B, Sk, H, Dh)
    bias: Optional[torch.Tensor] = None,  # broadcastable to (B, H, Sq, Sk)
    mask: Optional[torch.Tensor] = None,  # bool, broadcastable to (B, H, Sq, Sk)
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Scores and softmax in f32; masked scores are ``finfo(f32).min``, never
    ``-inf``, so a fully masked row gives a uniform (finite) softmax, as in
    JAX.  The probabilities are rounded to v's dtype before the weighted sum
    (f32 accumulation), as JAX's ``preferred_element_type=f32`` einsum does."""
    dh = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if logit_softcap:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    if bias is not None:
        scores = scores + bias.float()
    if mask is not None:
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def segment_causal_mask(valid: torch.Tensor) -> torch.Tensor:
    """(B, 1, S, S) mask of the flash rule: key k is visible to query q iff
    ``k <= q`` (sequence index) and ``valid[k] == valid[q]`` (the JAX call's
    segment ids ``valid + 1``, layers.py:169)."""
    s = valid.shape[1]
    idx = torch.arange(s, device=valid.device)
    causal = idx[None, :] <= idx[:, None]  # (S, S)
    seg = valid.to(torch.int32)
    same = seg[:, None, :] == seg[:, :, None]  # (B, S, S)
    return (causal[None] & same)[:, None]


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of ``flash_attention``: ``dot_product_attention`` under
    the same causal-and-segment mask."""
    return dot_product_attention(q, k, v, mask=segment_causal_mask(valid), scale=scale)


def _segment_causal_scores(q, k, valid, scale: float) -> torch.Tensor:
    """(B, H, S, S) f32 scores ``scale · q·k`` with the keys the segment
    rule hides at ``-inf``."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return scores.masked_fill(~segment_causal_mask(valid), -math.inf)


def flash_attention_lse_reference(
    q: torch.Tensor, k: torch.Tensor, valid: torch.Tensor, scale: float
) -> torch.Tensor:
    """(B, H, S) f32 per-row log-sum-exp of the visible scaled scores: what
    the forward kernel writes for the backward (``m + log l``).  Every row
    sees itself, so every value is finite, pad rows' too."""
    return torch.logsumexp(_segment_causal_scores(q, k, valid, scale), dim=-1)


def flash_attention_bwd_reference(
    q: torch.Tensor,  # (B, S, H, Dh)
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,  # the forward's output
    lse: torch.Tensor,  # (B, H, S) f32
    do: torch.Tensor,  # (B, S, H, Dh) output cotangent
    valid: torch.Tensor,
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``flash_attention_backward``, step by step in f32
    (upstream ``_flash_attention_bwd``): ``P = exp(scale·q·k − lse)`` on the
    visible pairs, ``D = rowsum(do ∘ o)``, ``dV = Pᵀ·do``,
    ``dS = P ∘ (do·vᵀ − D)``, ``dK = scale·dSᵀ·q``, ``dQ = scale·dS·k``.
    Returns ``(dq, dk, dv)`` in the inputs' dtypes."""
    f = (lambda x: x.float().transpose(1, 2))  # (B, H, S, Dh)
    qf, kf, vf, of, dof = (f(x) for x in (q, k, v, o, do))
    p = torch.exp(_segment_causal_scores(q, k, valid, scale) - lse.float()[..., None])
    d = (dof * of).sum(dim=-1, keepdim=True)
    dv = p.transpose(-1, -2) @ dof
    ds = p * (dof @ vf.transpose(-1, -2) - d)
    dk = scale * (ds.transpose(-1, -2) @ qf)
    dq = scale * (ds @ kf)
    return tuple(x.transpose(1, 2).to(y.dtype) for x, y in ((dq, q), (dk, k), (dv, v)))


_FLASH_HEAD_DIM = 128


def _check_flash_operand(name: str, x: torch.Tensor, shape: tuple,
                         fn: str = "flash_attention", dtype: torch.dtype = torch.bfloat16) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{fn}: {name} has shape {tuple(x.shape)}, want {shape}")
    if x.stride(-1) != 1:
        raise ValueError(f"{fn}: {name} needs a contiguous head dim")
    # 16-byte loads of K/V rows and 4-byte bf16x2 accesses everywhere
    if x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:-1]):
        raise ValueError(f"{fn}: {name} rows must be 16-byte aligned")


def _check_flash_qkv(fn: str, q, k, v, valid) -> torch.Tensor:
    """Check q/k/v for the causal kernels; returns ``valid`` as a contiguous
    (B, S) int32 on q's device."""
    b, s, h, dh = q.shape
    if dh != _FLASH_HEAD_DIM:
        raise ValueError(f"{fn} kernel supports head_dim=128, got {dh}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{fn}: {name} is on {x.device}, q on {q.device}")
        _check_flash_operand(name, x, (b, s, h, dh), fn)
    if tuple(valid.shape) != (b, s):
        raise ValueError(f"{fn}: valid has shape {tuple(valid.shape)}, want {(b, s)}")
    return valid.to(device=q.device, dtype=torch.int32).contiguous()


def _flash_attention_cuda(q, k, v, valid, scale, with_lse: bool = False):
    """The forward kernel (``csrc/flash_attn_fwd.cu``).  Returns the output,
    and with ``with_lse`` also the (B, H, S) f32 log-sum-exp the backward
    needs; without it the kernel writes none."""
    from ..csrc import load_library

    b, s, h, _ = q.shape
    valid_i32 = _check_flash_qkv("flash_attention", q, k, v, valid)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_lse else None
    fn = load_library("flash_attn_fwd.cu").flash_attn_fwd_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_void_p]
    )
    strides = [st for x in (q, k, v, out) for st in x.stride()[:3]]
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_i32.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, s, h, *strides, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd_bf16 launch failed: cudaError {err}")
    flash_attention.launches += 1
    return (out, lse) if with_lse else out


def flash_attention_backward(
    q: torch.Tensor,  # (B, S, H, Dh)
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,  # the forward's output
    lse: torch.Tensor,  # (B, H, S) f32, the forward's log-sum-exp
    do: torch.Tensor,  # (B, S, H, Dh) output cotangent
    valid: torch.Tensor,  # (B, S) 1 = real token
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of causal flash attention (counterpart of upstream
    ``_flash_attention_bwd``, which JAX's ``flash_attention_tpu`` reaches
    under autograd).

    CUDA tensors launch ``csrc/flash_attn_bwd.cu`` (bf16, head_dim 128: a
    dQ kernel that also writes ``D = rowsum(do ∘ o)`` and the base-2
    log-sum-exp to a scratch, then a dK/dV kernel)
    or raise; CPU tensors take ``flash_attention_bwd_reference``.  q/k/v
    may be strided views; o, do and lse are made contiguous (autograd may
    hand ``do`` in with zero strides)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, valid, scale)
    from ..csrc import load_library

    b, s, h, dh = q.shape
    valid_i32 = _check_flash_qkv("flash_attention_backward", q, k, v, valid)
    o, do, lse = o.contiguous(), do.contiguous(), lse.contiguous()
    for name, x in (("o", o), ("do", do)):
        _check_flash_operand(name, x, (b, s, h, dh), "flash_attention_backward")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, s):
        raise ValueError(f"flash_attention_backward: lse must be f32 {(b, h, s)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if any(x.device != q.device for x in (o, do, lse)):
        raise ValueError("flash_attention_backward: o, do and lse must be on q's device")
    dq, dk, dv = (torch.empty_like(x, memory_format=torch.contiguous_format) for x in (q, k, v))
    # the dQ kernel's row statistics for the dK/dV kernel: per 64-query
    # tile, the rows' lse·log2(e), D and validity
    stats = torch.empty((b, h, -(-s // 64), 3, 64), dtype=torch.float32, device=q.device)
    fn = load_library("flash_attn_bwd.cu").flash_attn_bwd_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 9
        + [ctypes.c_float, ctypes.c_void_p]
    )
    strides = [st for x in (q, k, v) for st in x.stride()[:3]]
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        valid_i32.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        b, s, h, *strides, float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd_bf16 launch failed: cudaError {err}")
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0  # kernel launches (CUDA tensors only)


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with its log-sum-exp, and the backward kernels
    (JAX ``flash_attention_tpu``'s custom VJP); on CPU tensors the plain
    forward, the plain LSE and the plain backward."""

    @staticmethod
    def forward(ctx, q, k, v, valid, scale):
        if q.device.type == "cpu":
            out = flash_attention_reference(q, k, v, valid, scale)
            lse = flash_attention_lse_reference(q, k, valid, scale)
        else:
            out, lse = _flash_attention_cuda(q, k, v, valid, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, valid)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, valid = ctx.saved_tensors
        return (*flash_attention_backward(q, k, v, o, lse, do, valid, ctx.scale), None, None)


def flash_attention(
    q: torch.Tensor,  # (B, S, H, Dh)
    k: torch.Tensor,
    v: torch.Tensor,
    valid: torch.Tensor,  # (B, S) 1 = real token
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal flash attention (counterpart of ``flash_attention_tpu``).

    CUDA tensors launch the hand-written kernel ``csrc/flash_attn_fwd.cu``
    (bf16, head_dim 128) or raise; CPU tensors take the plain version
    ``flash_attention_reference``.  A call that needs a gradient goes
    through ``_FlashAttention``: the forward kernel also writes the per-row
    log-sum-exp and the backward launches ``csrc/flash_attn_bwd.cu``.
    Outputs at pad positions follow the segment rule (a pad attends the
    earlier pads), so they are finite, and are garbage by contract as on
    the TPU (layers.py:157-159)."""
    scale = float(scale if scale is not None else 1.0 / math.sqrt(q.shape[-1]))
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, valid, scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, valid, scale)
    return _flash_attention_cuda(q, k, v, valid, scale)


flash_attention.launches = 0  # forward kernel launches (CUDA tensors only)


def flash_attention_usable(cfg, q_len: int, head_dim: int, device: torch.device) -> bool:
    """Gate of the flash branch: ``attention_impl == "flash"``, a CUDA
    tensor, ``q_len >= 256`` and ``head_dim == 128`` (the kernel's width).
    The caller adds the other condition: a self-contained block (a prefill
    into an empty cache).  JAX also requires ``q_len % 128 == 0``, a TPU
    block constraint the CUDA kernel does not have (it masks its ragged
    tail); dropping it changes outputs only at pad rows, which are garbage
    by contract (ROADMAP Queue 3)."""
    return (
        getattr(cfg, "attention_impl", "xla") == "flash"
        and torch.device(device).type == "cuda"
        and q_len >= 256
        and head_dim == _FLASH_HEAD_DIM
    )


def segment_bidir_mask(valid: torch.Tensor) -> torch.Tensor:
    """(B, 1, S, S) mask of the bidirectional flash rule: key k is visible
    to query q iff ``valid[k] == valid[q]`` (the JAX call's segment ids,
    real=2 and invalid=1, layers.py:261-265), with no causal bound."""
    seg = valid.to(torch.int32)
    return (seg[:, None, :] == seg[:, :, None])[:, None]


def flash_attention_bidir_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of ``flash_attention_bidir``: ``dot_product_attention``
    under the segment mask (no mask when every key is real)."""
    mask = None if valid is None else segment_bidir_mask(valid)
    return dot_product_attention(q, k, v, mask=mask, scale=scale)


# the head dims the bidirectional kernel is built for: SigLIP-SO400M's
# 1152/16 (the CLIP towers' s=257 takes vit_attention)
_FLASH_BIDIR_HEAD_DIMS = (72,)


def _tower_attention_cuda(fn: str, source: str, symbol: str, head_dims: tuple,
                          off_switch: str, q, k, v, valid, scale,
                          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Launch one of the towers' bidirectional attention kernels
    (``csrc/flash_attn_bidir.cu``, ``csrc/vit_attention.cu``,
    ``csrc/vit_attention_f32.cu``: one plain C interface) on ``dtype`` (B,
    S, H, Dh) strided views and an optional (B, S) ``valid``.  ``fn`` names
    the wrapper in errors, ``off_switch`` the environment variable that
    takes its plain path."""
    from ..csrc import load_library

    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        # the towers are frozen, and a ctypes output has no grad_fn: a
        # backward would skip attention without a word
        raise RuntimeError(
            f"{fn}: the CUDA kernel has a forward only (the vision towers are "
            f"frozen). Run under torch.no_grad(), or with {off_switch}=0 for a gradient"
        )
    b, s, h, dh = q.shape
    if dh not in head_dims:
        raise ValueError(f"{fn} kernel supports head_dim in {head_dims}, got {dh}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{fn}: {name} is on {x.device}, q on {q.device}")
        _check_flash_operand(name, x, (b, s, h, dh), fn, dtype)
    valid_ptr = None  # every key real
    if valid is not None:
        if tuple(valid.shape) != (b, s):
            raise ValueError(f"{fn}: valid has shape {tuple(valid.shape)}, want {(b, s)}")
        valid = valid.to(device=q.device, dtype=torch.int32).contiguous()
        valid_ptr = valid.data_ptr()
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    kernel = getattr(load_library(source), symbol)
    kernel.restype = ctypes.c_int
    kernel.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_void_p]
    )
    strides = [st for x in (q, k, v, out) for st in x.stride()[:3]]
    err = kernel(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_ptr, out.data_ptr(),
        b, s, h, dh, *strides, float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError {err}")
    return out


def flash_attention_bidir(
    q: torch.Tensor,  # (B, S, H, Dh)
    k: torch.Tensor,
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,  # (B, S) 1 = real; None = all real
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Bidirectional flash attention for the vision towers (counterpart of
    ``flash_attention_bidir_tpu``).

    CUDA tensors launch the hand-written kernel ``csrc/flash_attn_bidir.cu``
    (bf16, head_dim 72) or raise; CPU tensors take the plain version
    ``flash_attention_bidir_reference``.  Key k is visible to query q iff
    ``valid[k] == valid[q]``, so real tokens never attend invalid ones and
    every row sees itself.  Outputs at invalid positions are garbage by
    contract, as on the TPU (every consumer masks them: the Idefics2
    perceiver's ``kv_mask``).  They differ from JAX's there: JAX pads S to a
    multiple of 128 with keys of the invalid segment (a Mosaic block rule,
    layers.py:256-260), the kernel masks its ragged tail instead."""
    scale = float(scale if scale is not None else 1.0 / math.sqrt(q.shape[-1]))
    if q.device.type == "cpu":
        return flash_attention_bidir_reference(q, k, v, valid, scale)
    out = _tower_attention_cuda(
        "flash_attention_bidir", "flash_attn_bidir.cu", "flash_attn_bidir_bf16",
        _FLASH_BIDIR_HEAD_DIMS, "LICV_VIT_FLASH", q, k, v, valid, scale,
    )
    flash_attention_bidir.launches += 1
    return out


flash_attention_bidir.launches = 0  # kernel launches (CUDA tensors only)


def flash_bidir_usable(s: int, device: torch.device) -> bool:
    """Gate of the vision towers' flash branch (JAX ``flash_bidir_usable``,
    layers.py:215-230, with a CUDA device in place of a TPU): long
    sequences only (``s >= 1024``: every Idefics2 NaViT image), and
    ``LICV_VIT_FLASH=0`` turns the branch off."""
    return (
        torch.device(device).type == "cuda"
        and s >= 1024
        and os.environ.get("LICV_VIT_FLASH", "1") != "0"
    )


def vit_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of ``vit_attention``: ``dot_product_attention`` under
    the key mask ``valid[:, None, None, :]`` (no mask when every key is
    real)."""
    mask = None if valid is None else valid.bool()[:, None, None, :]
    return dot_product_attention(q, k, v, mask=mask, scale=scale)


# the head dims the fused ViT kernel is built for: OpenFlamingo's ViT-L
# (1024/16), SigLIP-SO400M's (1152/16), Idefics-9B's ViT-H (1280/16)
_VIT_HEAD_DIMS = (64, 72, 80)
# the f32 kernel holds a head's whole score row in registers (one pass)
_VIT_F32_MAX_S = 264


def vit_attention(
    q: torch.Tensor,  # (B, S, H, Dh)
    k: torch.Tensor,
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,  # (B, S) key mask; None = every key
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused bidirectional attention for short vision sequences
    (counterpart of ``vit_attention_tpu``): f32 scores and an exact softmax
    over the whole row, masked keys at ``finfo(f32).min``, the probabilities
    rounded to V's dtype before P·V with f32 accumulation.

    CUDA tensors launch a hand-written kernel by dtype, or raise: bf16
    ``csrc/vit_attention.cu`` (head_dim 64, 72 or 80, S <= 1024; counted in
    ``launches``), f32 ``csrc/vit_attention_f32.cu`` (the f32 CLIP towers
    of RICE; head_dim 64, 72 or 80, S <= 264; counted in
    ``launches_f32``).  CPU tensors take the plain version
    ``vit_attention_reference``.  A row with no valid key gets the uniform
    softmax, as in the plain version."""
    scale = float(scale if scale is not None else 1.0 / math.sqrt(q.shape[-1]))
    if q.device.type == "cpu":
        return vit_attention_reference(q, k, v, valid, scale)
    if q.dtype == torch.float32:
        if q.shape[1] > _VIT_F32_MAX_S:
            raise ValueError(
                f"vit_attention: the f32 kernel takes S <= {_VIT_F32_MAX_S}, got {q.shape[1]} "
                "(LICV_VIT_FUSED_ATTN=0 takes the plain path)")
        out = _tower_attention_cuda(
            "vit_attention", "vit_attention_f32.cu", "vit_attention_f32", _VIT_HEAD_DIMS,
            "LICV_VIT_FUSED_ATTN", q, k, v, valid, scale, torch.float32,
        )
        vit_attention.launches_f32 += 1
        return out
    out = _tower_attention_cuda(
        "vit_attention", "vit_attention.cu", "vit_attention_bf16", _VIT_HEAD_DIMS,
        "LICV_VIT_FUSED_ATTN", q, k, v, valid, scale,
    )
    vit_attention.launches += 1
    return out


vit_attention.launches = 0  # bf16 kernel launches (CUDA tensors only)
vit_attention.launches_f32 = 0  # f32 kernel launches (CUDA tensors only)


def vit_attention_usable(s: int, dh: int, device: torch.device) -> bool:
    """Gate of the towers' fused short-sequence branch: a CUDA device,
    ``s <= 1024``, a head dim the kernel is built for, and
    ``LICV_VIT_FUSED_ATTN`` not ``0``.  On by default, where JAX keeps it
    opt-in (``ops/vit_attention.py:92-115``: on the TPU the kernel lost
    XLA's in-tower fusion).  Eager PyTorch has no such fusion: the plain
    branch upcasts Q/K/V to f32 and writes and reads (B, H, S, S) f32
    scores in device memory (ROADMAP Queue 3).  The caller adds the other
    condition: the layer's mask is a key mask."""
    return (
        torch.device(device).type == "cuda"
        and s <= 1024
        and dh in _VIT_HEAD_DIMS
        and os.environ.get("LICV_VIT_FUSED_ATTN", "1") != "0"
    )


def causal_mask(
    q_positions: torch.Tensor,  # (B, Sq) absolute positions
    k_positions: torch.Tensor,  # (B, Sk)
    k_valid: Optional[torch.Tensor] = None,  # (B, Sk) bool padding mask
) -> torch.Tensor:
    """(B, 1, Sq, Sk) boolean mask: causal ∧ key-valid."""
    m = k_positions[:, None, :] <= q_positions[:, :, None]
    if k_valid is not None:
        m = m & k_valid[:, None, :]
    return m[:, None, :, :]


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def swiglu_mlp(p: dict, x: torch.Tensor, a8: bool = False) -> torch.Tensor:
    """Weights may be quantized leaves (``ops.int8_matmul.qdot``)."""
    gate = qdot(x, p["w_gate"], preferred_element_type=torch.float32, a8=a8)
    up = qdot(x, p["w_up"], preferred_element_type=torch.float32, a8=a8)
    h = (F.silu(gate) * up).to(x.dtype)
    return qdot(h, p["w_down"], preferred_element_type=torch.float32, a8=a8).to(x.dtype)


def gelu_mlp(p: dict, x: torch.Tensor, a8: bool = False) -> torch.Tensor:
    h = qdot(x, p["w_up"], preferred_element_type=torch.float32, a8=a8)
    if "b_up" in p:
        h = h + p["b_up"].float()
    h = F.gelu(h, approximate="none").to(x.dtype)
    out = qdot(h, p["w_down"], preferred_element_type=torch.float32, a8=a8)
    if "b_down" in p:
        out = out + p["b_down"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Param helpers
# ---------------------------------------------------------------------------


def layer_slice(tree, i: int):
    """Layer ``i`` of a layer-stacked param dict (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def dense_init(
    generator: torch.Generator, shape, dtype: torch.dtype, device, scale: float = 0.02
) -> torch.Tensor:
    """N(0, scale²) drawn directly in ``dtype`` on ``device`` (no transient
    f32 copy of multi-GB weight stacks)."""
    x = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    return x.mul_(scale)
