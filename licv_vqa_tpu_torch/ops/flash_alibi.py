"""Causal flash attention with the ALiBi bias made in the kernel, for the
MPT backbone of OpenFlamingo (counterpart of ``licv_vqa_tpu/ops/flash_alibi.py``).

Contract (JAX's): right- or left-padded batches, ``valid`` marks the real
tokens, key k is visible to query q iff ``k <= q`` (sequence index) and
``valid[k]``; the bias is ``-slope_h · (q − k)``, which equals the position
difference for every real token under either padding.  Outputs at pad
positions are garbage by contract: a right-pad row attends the earlier real
keys, and a left-pad row with no visible key is 0 in the kernel and a
uniform average in the plain version.

CUDA tensors launch ``csrc/flash_alibi.cu`` or raise; CPU tensors take the
plain version ``flash_alibi_reference``.  The gradient recomputes through
the plain version under autograd, as JAX's ``_bwd`` does: the hot user is
the 32-shot teacher forward, which runs without gradients.
"""

from __future__ import annotations

import ctypes

import torch

from ..models import layers as L

_HEAD_DIM = 128


def flash_alibi_reference(
    q: torch.Tensor,  # (B, S, H, Dh)
    k: torch.Tensor,
    v: torch.Tensor,
    valid: torch.Tensor,  # (B, S) 1 = real token
    slopes: torch.Tensor,  # (H,) f32
    scale: float,
) -> torch.Tensor:
    """JAX's ``_dense_reference`` (flash_alibi.py:111-121):
    ``dot_product_attention`` with the ALiBi bias over sequence indices and
    ``causal_mask(pos, pos, valid)``."""
    b, s = q.shape[:2]
    pos = torch.arange(s, dtype=torch.int32, device=q.device)[None].expand(b, s)
    rel = (pos[:, :, None] - pos[:, None, :]).float()
    bias = -slopes.float().to(q.device)[None, :, None, None] * rel[:, None]
    mask = L.causal_mask(pos, pos, valid.bool())
    return L.dot_product_attention(q, k, v, bias=bias, mask=mask, scale=scale)


def _flash_alibi_cuda(q, k, v, valid, slopes, scale) -> torch.Tensor:
    from ..csrc import load_library

    b, s, h, _ = q.shape
    valid_i32 = L._check_flash_qkv("flash_alibi_attention", q, k, v, valid)
    if tuple(slopes.shape) != (h,):
        raise ValueError(
            f"flash_alibi_attention: slopes has shape {tuple(slopes.shape)}, want {(h,)}"
        )
    slopes_f32 = slopes.to(device=q.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    fn = load_library("flash_alibi.cu").flash_alibi_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_void_p]
    )
    strides = [st for x in (q, k, v, out) for st in x.stride()[:3]]
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_i32.data_ptr(), slopes_f32.data_ptr(),
        out.data_ptr(), b, s, h, *strides, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_alibi_bf16 launch failed: cudaError {err}")
    flash_alibi_attention.launches += 1
    return out


class _FlashAlibi(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, valid, slopes, scale):
        ctx.save_for_backward(q, k, v, valid, slopes)
        ctx.scale = scale
        if q.device.type == "cpu":
            return flash_alibi_reference(q, k, v, valid, slopes, scale)
        return _flash_alibi_cuda(q, k, v, valid, slopes, scale)

    @staticmethod
    def backward(ctx, g):
        # dense recompute, as JAX's _bwd (flash_alibi.py:134-142): only a
        # differentiated long student forward takes it
        q, k, v, valid, slopes = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [x.detach().requires_grad_(True) for x in (q, k, v)]
            out = flash_alibi_reference(*qkv, valid, slopes, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None, None


def flash_alibi_attention(
    q: torch.Tensor,  # (B, S, H, Dh)
    k: torch.Tensor,
    v: torch.Tensor,
    valid: torch.Tensor,  # (B, S) 1 = real token
    slopes: torch.Tensor,  # (H,) f32, layers.alibi_slopes
    scale: float,
) -> torch.Tensor:
    """Causal ALiBi attention (counterpart of JAX ``flash_alibi_attention``);
    the module docstring gives the contract."""
    return _FlashAlibi.apply(q, k, v, valid, slopes, float(scale))


flash_alibi_attention.launches = 0  # kernel launches (CUDA tensors only)


def flash_alibi_usable(cfg, q_len: int, head_dim: int, device: torch.device) -> bool:
    """Gate of the ALiBi flash branch: ``attention_impl == "flash"``, a CUDA
    device, ``q_len >= 128`` and ``head_dim == 128`` (the kernel's width).
    The caller adds the other condition: a self-contained block (training,
    or a prefill into an empty cache).  JAX also requires ``q_len % 128 ==
    0`` and ``head_dim % 128 == 0`` (flash_alibi.py:148-156), TPU block
    rules the CUDA kernel does not have (it masks its ragged tail)."""
    return (
        getattr(cfg, "attention_impl", "xla") == "flash"
        and torch.device(device).type == "cuda"
        and q_len >= 128
        and head_dim == _HEAD_DIM
    )
