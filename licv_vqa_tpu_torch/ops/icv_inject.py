"""ICV residual-stream injection: ``h' = (h+v) / ‖h+v‖₂ · ‖h‖₂``
(counterpart of ``licv_vqa_tpu/ops/icv_inject.py``).

Math (per token, last dim D): ``s = h + v``; ``h' = s · (‖h‖₂ / ‖s‖₂)``, with
the norms accumulated in f32 whatever the input dtype, and no epsilon (the
reference adds none, ``icv_inject.py:24``): ``h = -v`` gives NaN, as in JAX.

The kernel, in Triton, replaces ``_icv_inject_pallas`` (``icv_inject.py:56``,
body ``_inject_kernel`` :41-48).  JAX fuses the jnp form into every decoder
layer; eager PyTorch fuses nothing, so on the card this one kernel stands in
for the four to six elementwise and reduction launches of the plain version.
What bounds it on the H100: memory.  It reads h once and writes it once (2
bytes each way per bf16 element) plus one D-row of shift, and does ~6 flops
per element.  Its design: one program per row of D (4096 on Idefics-9B),
the whole row in registers (``BLOCK_D`` a power of two ≥ D, masked tail),
both sums of squares reduced in f32 from that one read, one ``rsqrt·sqrt``
per row, the scaled row written back in h's dtype — no intermediate in
device memory.  The shift is read through its batch and position strides,
so every layout the reference broadcasts — (D,), (B, D), (B, 1, D) and a
per-position (B, S, D) — launches the kernel; the TPU kernel's gate that
sends a per-position shift to the jnp path (:94-106) has no counterpart on
the card.  The backward (``_bwd``, :113-133) belongs to the training slice
(ROADMAP Queue 2).
"""

from __future__ import annotations

import functools

import torch


def icv_inject_reference(h: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Plain injection. ``h``: (..., D); ``shift`` broadcastable to ``h``, or
    the kernel's (B, D) per-batch-row layout for a (B, S, D) ``h``."""
    if h.ndim == 3 and shift.ndim == 2 and shift.shape[0] > 1:
        shift = shift[:, None, :]
    hf = h.float()
    sf = hf + shift.float()
    h_norm = torch.sqrt(torch.sum(hf * hf, dim=-1, keepdim=True))
    s_norm = torch.sqrt(torch.sum(sf * sf, dim=-1, keepdim=True))
    return (sf * (h_norm / s_norm)).to(h.dtype)


@functools.cache
def _triton_kernel():
    """Define the Triton kernel on first launch (triton is imported only
    here: a machine without it can still import this module)."""
    import triton
    import triton.language as tl

    @triton.jit
    def inject_kernel(
        h_ptr, v_ptr, out_ptr, rows_per_batch, d, v_stride_b, v_stride_s,
        BLOCK_D: tl.constexpr,
    ):
        row = tl.program_id(0).to(tl.int64)
        b = row // rows_per_batch
        pos = row % rows_per_batch
        offs = tl.arange(0, BLOCK_D)
        m = offs < d
        base = row * d
        h = tl.load(h_ptr + base + offs, mask=m, other=0.0).to(tl.float32)
        v_row = v_ptr + b * v_stride_b + pos * v_stride_s
        v = tl.load(v_row + offs, mask=m, other=0.0).to(tl.float32)
        s = h + v
        h_sq = tl.sum(h * h, axis=0)
        s_sq = tl.sum(s * s, axis=0)
        scale = tl.math.rsqrt(s_sq) * tl.sqrt(h_sq)
        tl.store(out_ptr + base + offs, (s * scale).to(out_ptr.dtype.element_ty), mask=m)

    return triton, inject_kernel


def _icv_inject_triton(h: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    b, s, d = h.shape
    if shift.device != h.device:
        raise ValueError(f"icv_inject: shift on {shift.device}, h on {h.device}")
    if shift.ndim == 2:
        shift = shift[:, None, :]  # (B, D) → (B, 1, D), as the reference reads it
    try:
        shift = shift.expand(b, s, d)  # broadcast dims get stride 0
    except RuntimeError:
        raise ValueError(
            f"icv_inject: shift {tuple(shift.shape)} does not broadcast to {(b, s, d)}"
        ) from None
    if shift.stride(-1) != 1:
        shift = shift.contiguous()
    h = h.contiguous()
    out = torch.empty_like(h)
    triton, kernel = _triton_kernel()
    block_d = triton.next_power_of_2(d)
    kernel[(b * s,)](
        h, shift, out, s, d, shift.stride(0), shift.stride(1),
        BLOCK_D=block_d, num_warps=max(1, min(16, block_d // 512)),
    )
    icv_inject.launches += 1
    return out


def icv_inject(h: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Injection: the Triton kernel for a CUDA ``(B, S, D)`` h, whatever the
    shift's layout; the plain version for a CPU tensor."""
    if h.device.type == "cpu":
        return icv_inject_reference(h, shift)
    if h.ndim != 3:
        raise ValueError(f"icv_inject kernel takes (B, S, D) h, got {tuple(h.shape)}")
    return _icv_inject_triton(h, shift)


icv_inject.launches = 0  # kernel launches (CUDA tensors only)
