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
the card.

The backward is a second Triton kernel (``_bwd``, :113-133, which JAX
leaves to XLA's fusion; the plain backward is about ten launches with f32
intermediates in eager PyTorch).  Per row, with r = ‖h‖/‖s‖ and gs = g·s:
``ds = r·(g − s·gs/‖s‖²)`` and ``dh = ds + (gs/‖s‖)·h/‖h‖``.  Memory bounds
it too: it reads h, g and the shift row once and writes dh (h's dtype) and
the per-row ds (f32), with the three row sums (Σh², Σs², Σg·s) reduced from
the one read.  The wrapper then reduces ds to the shift's shape, as
``_reduce_to_shape`` does in JAX.  That per-row f32 ds is written and read
back only because the reduction is a second launch: the function itself
moves h, g and dh (6 bytes per bf16 element) plus the shift and its
gradient, and folding the reduction into the kernel is queued in ROADMAP.md.
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


def _per_row_shift(h: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """The shift as the kernels read it: a view broadcast to ``h``'s (B, S, D)
    (broadcast dims get stride 0), the (B, D) layout read per batch row."""
    b, s, d = h.shape
    if shift.device != h.device:
        raise ValueError(f"icv_inject: shift on {shift.device}, h on {h.device}")
    if shift.ndim == 2 and shift.shape[0] > 1:
        shift = shift[:, None, :]  # (B, D) → (B, 1, D), as the reference reads it
    try:
        shift = shift.expand(b, s, d)
    except RuntimeError:
        raise ValueError(
            f"icv_inject: shift {tuple(shift.shape)} does not broadcast to {(b, s, d)}"
        ) from None
    return shift if shift.stride(-1) == 1 else shift.contiguous()


def reduce_shift_grad(ds: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Per-row (B, S, D) shift gradient → the shift's own shape and dtype
    (JAX ``_reduce_to_shape``)."""
    if ds.ndim == 3 and shift.ndim == 2 and shift.shape[0] > 1:
        red = ds.sum(dim=1)  # the (B, D) per-batch-row layout
    else:
        red = ds.sum_to_size(shift.shape)
    return red.to(shift.dtype)


def icv_inject_backward_reference(
    h: torch.Tensor, shift: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain backward, JAX ``_bwd`` written out: ``(dh in h's dtype, the
    shift's gradient in its shape and dtype)``."""
    hf = h.float()
    sf = hf + _per_row_shift(h, shift).float()
    gf = g.float()
    n_h = torch.sqrt(torch.sum(hf * hf, dim=-1, keepdim=True))
    n_s = torch.sqrt(torch.sum(sf * sf, dim=-1, keepdim=True))
    r = n_h / n_s
    gs = torch.sum(gf * sf, dim=-1, keepdim=True)
    ds = r * (gf - sf * (gs / (n_s * n_s)))
    dh = ds + (gs / n_s) * (hf / n_h)
    return dh.to(h.dtype), reduce_shift_grad(ds, shift)


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

    @triton.jit
    def inject_bwd_kernel(
        h_ptr, v_ptr, g_ptr, dh_ptr, ds_ptr, rows_per_batch, d, v_stride_b, v_stride_s,
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
        g = tl.load(g_ptr + base + offs, mask=m, other=0.0).to(tl.float32)
        s = h + v
        n_h = tl.sqrt(tl.sum(h * h, axis=0))
        s_sq = tl.sum(s * s, axis=0)
        n_s = tl.sqrt(s_sq)
        gs = tl.sum(g * s, axis=0)
        ds = (n_h / n_s) * (g - s * (gs / s_sq))
        dh = ds + (gs / n_s) * (h / n_h)
        tl.store(ds_ptr + base + offs, ds, mask=m)
        tl.store(dh_ptr + base + offs, dh.to(dh_ptr.dtype.element_ty), mask=m)

    return triton, inject_kernel, inject_bwd_kernel


def _num_warps(block_d: int) -> int:
    return max(1, min(16, block_d // 512))


def _icv_inject_triton(h: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    b, s, d = h.shape
    shift = _per_row_shift(h, shift)
    h = h.contiguous()
    out = torch.empty_like(h)
    triton, kernel, _ = _triton_kernel()
    block_d = triton.next_power_of_2(d)
    kernel[(b * s,)](
        h, shift, out, s, d, shift.stride(0), shift.stride(1),
        BLOCK_D=block_d, num_warps=_num_warps(block_d),
    )
    icv_inject.launches += 1
    return out


def icv_inject_backward(
    h: torch.Tensor, shift: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dh, the shift's gradient)``: the Triton kernel, then the reduction
    of its per-row ds, for CUDA tensors; the plain version for CPU tensors."""
    if h.device.type == "cpu":
        return icv_inject_backward_reference(h, shift, g)
    if h.ndim != 3 or g.shape != h.shape:
        raise ValueError(
            f"icv_inject backward kernel takes (B, S, D) h and g, got "
            f"{tuple(h.shape)} and {tuple(g.shape)}"
        )
    b, s, d = h.shape
    rows = _per_row_shift(h, shift)
    h, g = h.contiguous(), g.contiguous()
    dh = torch.empty_like(h)
    ds = torch.empty(h.shape, dtype=torch.float32, device=h.device)
    triton, _, kernel = _triton_kernel()
    block_d = triton.next_power_of_2(d)
    kernel[(b * s,)](
        h, rows, g, dh, ds, s, d, rows.stride(0), rows.stride(1),
        BLOCK_D=block_d, num_warps=_num_warps(block_d),
    )
    icv_inject_backward.launches += 1
    return dh, reduce_shift_grad(ds, shift)


icv_inject_backward.launches = 0  # kernel launches (CUDA tensors only)


class _ICVInject(torch.autograd.Function):
    """The forward kernel with the backward kernel (JAX ``icv_inject``'s
    custom VJP)."""

    @staticmethod
    def forward(ctx, h, shift):
        ctx.save_for_backward(h, shift)
        return _icv_inject_triton(h, shift)

    @staticmethod
    def backward(ctx, g):
        h, shift = ctx.saved_tensors
        return icv_inject_backward(h, shift, g)


def icv_inject(h: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Injection: the Triton kernels (forward, and backward under autograd)
    for a CUDA ``(B, S, D)`` h, whatever the shift's layout; the plain
    version, differentiated by autograd, for a CPU tensor."""
    if h.device.type == "cpu":
        return icv_inject_reference(h, shift)
    if h.ndim != 3:
        raise ValueError(f"icv_inject kernel takes (B, S, D) h, got {tuple(h.shape)}")
    return _ICVInject.apply(h, shift)


icv_inject.launches = 0  # forward kernel launches (CUDA tensors only)
