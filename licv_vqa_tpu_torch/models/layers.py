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
from typing import Optional

import torch
import torch.nn.functional as F

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


_FLASH_HEAD_DIM = 128


def _check_flash_operand(name: str, x: torch.Tensor, shape: tuple) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention: {name} must be bf16, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"flash_attention: {name} has shape {tuple(x.shape)}, want {shape}")
    if x.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name} needs a contiguous head dim")
    # 16-byte loads of K/V rows and 4-byte bf16x2 accesses everywhere
    if x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:-1]):
        raise ValueError(f"flash_attention: {name} rows must be 16-byte aligned")


def _flash_attention_cuda(q, k, v, valid, scale) -> torch.Tensor:
    from ..csrc import load_library

    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        # the kernel writes a fresh tensor through ctypes: its output has no
        # grad_fn, and a backward would skip attention without a word
        raise RuntimeError(
            "flash_attention: the CUDA kernel has a forward only; its backward "
            "(dq, dk, dv) is not ported yet (ROADMAP.md Queue 2 item 2). Run "
            "under torch.no_grad(), or with attention_impl=xla for a gradient"
        )
    b, s, h, dh = q.shape
    if dh != _FLASH_HEAD_DIM:
        raise ValueError(f"flash_attention kernel supports head_dim=128, got {dh}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {x.device}, q on {q.device}")
        _check_flash_operand(name, x, (b, s, h, dh))
    if tuple(valid.shape) != (b, s):
        raise ValueError(f"flash_attention: valid has shape {tuple(valid.shape)}, want {(b, s)}")
    valid_i32 = valid.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lib = load_library("flash_attn_fwd.cu")
    fn = lib.flash_attn_fwd_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_void_p]
    )
    strides = [st for x in (q, k, v, out) for st in x.stride()[:3]]
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_i32.data_ptr(), out.data_ptr(),
        b, s, h, *strides, float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd_bf16 launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


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
    ``flash_attention_reference``.  Outputs at pad positions follow the
    segment rule (a pad attends the earlier pads), so they are finite, and
    are garbage by contract as on the TPU (layers.py:157-159)."""
    scale = float(scale if scale is not None else 1.0 / math.sqrt(q.shape[-1]))
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, valid, scale)
    return _flash_attention_cuda(q, k, v, valid, scale)


flash_attention.launches = 0  # kernel launches (CUDA tensors only)


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


def swiglu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    gate = (x @ p["w_gate"]).float()
    up = (x @ p["w_up"]).float()
    h = (F.silu(gate) * up).to(x.dtype)
    return (h @ p["w_down"]).to(x.dtype)


def gelu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = (x @ p["w_up"]).float()
    if "b_up" in p:
        h = h + p["b_up"].float()
    h = F.gelu(h, approximate="none").to(x.dtype)
    out = (h @ p["w_down"]).float()
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
