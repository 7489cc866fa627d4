"""Fused masked temperature-KL, forward and backward, as Triton kernels
(counterpart of ``licv_vqa_tpu/ops/masked_kl_kernel.py``).

Math (per row, ε from the config's ``kl_eps``):

    p = softmax(s),  q = softmax(t)
    KL = Σ_j q_j (log(q_j+ε) − log(p_j+ε))

    ∂KL/∂s_i = p_i·C − q_i p_i/(p_i+ε),      C = Σ_j q_j p_j/(p_j+ε)
    ∂KL/∂t_j = q_j (A_j − Σ_i q_i A_i),      A_i = log(q_i+ε) − log(p_i+ε)
                                                   + q_i/(q_i+ε)

Temperature scaling and the ×T² factor stay outside the op (``ops/kl.py``),
as does the masked mean: the op returns one KL per row and its backward
takes one cotangent per row, so a learnable temperature's gradient flows
through both scaled operands by the ordinary chain rule.

The kernels replace ``_kl_fwd_kernel`` (:43) and ``_kl_bwd_kernel`` (:50)
behind ``_rowwise_kl`` (:75).  What bounds them on the H100: memory.  On the
training path the operands are (N, V) = (bs·64, 32000) f32; the forward
must read both once (8 bytes per element) and the backward read both and
write both gradients (16 bytes per element), against ~20 and ~30 flops per
element.  The TPU kernel holds whole (r, V) row blocks in VMEM; a Hopper
block has registers and 227 KB of shared memory, so the design walks V in
chunks of ``BLOCK_V``, one program per row:

- forward: one pass keeps each operand's running max and sum of exps
  (rescaled per chunk, so one read gives both log-sum-exps), a second pass
  accumulates the KL; it writes the two log-sum-exps per row beside the KL;
- backward: takes those log-sum-exps (no max/sum pass), one pass
  accumulates C and Σ qA, a second writes both gradients.

The ε inside the logs rules out a log-softmax shortcut: p and q are formed
explicitly as ``exp(x − lse)``.  A row's second read (256 KB for the two
operands) comes mostly from the 50 MB L2 while ~132 rows are in flight.
The TPU's pad-rows-to-8 rule (:140) is a sublane constraint with no
counterpart here: rows are launched as they are.
"""

from __future__ import annotations

import functools

import torch

BLOCK_V = 2048  # chunk of the vocabulary per loop step (8 f32 per thread at 8 warps)
NUM_WARPS = 8


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the yardstick on the card)
# ---------------------------------------------------------------------------


def rowwise_kl_reference(stu: torch.Tensor, tea: torch.Tensor, eps: float):
    """Per-row KL of (N, V) f32 scaled logits: ``(kl (N,), lse_s (N,),
    lse_t (N,))``, the same three outputs as the forward kernel."""
    lse_s = torch.logsumexp(stu, dim=-1)
    lse_t = torch.logsumexp(tea, dim=-1)
    p = torch.exp(stu - lse_s[:, None])
    q = torch.exp(tea - lse_t[:, None])
    kl = torch.sum(q * (torch.log(q + eps) - torch.log(p + eps)), dim=-1)
    return kl, lse_s, lse_t


def rowwise_kl_backward_reference(stu, tea, lse_s, lse_t, g, eps: float):
    """Both input gradients of the per-row KL, each row scaled by its
    cotangent ``g`` (N,): the closed forms in the module docstring."""
    p = torch.exp(stu - lse_s[:, None])
    q = torch.exp(tea - lse_t[:, None])
    g = g[:, None].float()
    pr = p / (p + eps)
    c = torch.sum(q * pr, dim=-1, keepdim=True)
    dstu = g * (p * c - q * pr)
    a = torch.log(q + eps) - torch.log(p + eps) + q / (q + eps)
    ea = torch.sum(q * a, dim=-1, keepdim=True)
    dtea = g * (q * (a - ea))
    return dstu.to(stu.dtype), dtea.to(tea.dtype)


# ---------------------------------------------------------------------------
# Triton kernels
# ---------------------------------------------------------------------------


@functools.cache
def _triton_kernels():
    """Define the kernels on first launch (triton is imported only here: a
    machine without it can still import this module)."""
    import triton
    import triton.language as tl

    @triton.jit
    def kl_fwd_kernel(
        s_ptr, t_ptr, kl_ptr, lse_s_ptr, lse_t_ptr, v, stride_s, stride_t, eps,
        BLOCK: tl.constexpr,
    ):
        row = tl.program_id(0).to(tl.int64)
        s_row = s_ptr + row * stride_s
        t_row = t_ptr + row * stride_t
        offs = tl.arange(0, BLOCK)
        # running max and sum of exps per lane, merged across lanes after
        # the loop; -1e30 (not -inf) for lanes not yet seen, so no lane ever
        # computes inf - inf
        m_s = tl.full((BLOCK,), -1.0e30, tl.float32)
        m_t = tl.full((BLOCK,), -1.0e30, tl.float32)
        l_s = tl.zeros((BLOCK,), dtype=tl.float32)
        l_t = tl.zeros((BLOCK,), dtype=tl.float32)
        for start in range(0, v, BLOCK):
            idx = start + offs
            msk = idx < v
            x = tl.load(s_row + idx, mask=msk, other=-1.0e30)
            y = tl.load(t_row + idx, mask=msk, other=-1.0e30)
            ms_new = tl.maximum(m_s, x)
            mt_new = tl.maximum(m_t, y)
            l_s = l_s * tl.exp(m_s - ms_new) + tl.where(msk, tl.exp(x - ms_new), 0.0)
            l_t = l_t * tl.exp(m_t - mt_new) + tl.where(msk, tl.exp(y - mt_new), 0.0)
            m_s = ms_new
            m_t = mt_new
        max_s = tl.max(m_s, axis=0)
        max_t = tl.max(m_t, axis=0)
        lse_s = max_s + tl.log(tl.sum(l_s * tl.exp(m_s - max_s), axis=0))
        lse_t = max_t + tl.log(tl.sum(l_t * tl.exp(m_t - max_t), axis=0))
        acc = tl.zeros((BLOCK,), dtype=tl.float32)
        for start in range(0, v, BLOCK):
            idx = start + offs
            msk = idx < v
            x = tl.load(s_row + idx, mask=msk, other=0.0)
            y = tl.load(t_row + idx, mask=msk, other=0.0)
            p = tl.exp(x - lse_s)
            q = tl.exp(y - lse_t)
            term = q * (tl.log(q + eps) - tl.log(p + eps))
            acc += tl.where(msk, term, 0.0)
        tl.store(kl_ptr + row, tl.sum(acc, axis=0))
        tl.store(lse_s_ptr + row, lse_s)
        tl.store(lse_t_ptr + row, lse_t)

    @triton.jit
    def kl_bwd_kernel(
        s_ptr, t_ptr, lse_s_ptr, lse_t_ptr, g_ptr, ds_ptr, dt_ptr, v,
        stride_s, stride_t, stride_ds, stride_dt, eps,
        BLOCK: tl.constexpr,
    ):
        row = tl.program_id(0).to(tl.int64)
        s_row = s_ptr + row * stride_s
        t_row = t_ptr + row * stride_t
        lse_s = tl.load(lse_s_ptr + row)
        lse_t = tl.load(lse_t_ptr + row)
        g = tl.load(g_ptr + row)
        offs = tl.arange(0, BLOCK)
        acc_c = tl.zeros((BLOCK,), dtype=tl.float32)
        acc_a = tl.zeros((BLOCK,), dtype=tl.float32)
        for start in range(0, v, BLOCK):
            idx = start + offs
            msk = idx < v
            x = tl.load(s_row + idx, mask=msk, other=0.0)
            y = tl.load(t_row + idx, mask=msk, other=0.0)
            p = tl.exp(x - lse_s)
            q = tl.exp(y - lse_t)
            a = tl.log(q + eps) - tl.log(p + eps) + q / (q + eps)
            acc_c += tl.where(msk, q * (p / (p + eps)), 0.0)
            acc_a += tl.where(msk, q * a, 0.0)
        c = tl.sum(acc_c, axis=0)
        ea = tl.sum(acc_a, axis=0)
        for start in range(0, v, BLOCK):
            idx = start + offs
            msk = idx < v
            x = tl.load(s_row + idx, mask=msk, other=0.0)
            y = tl.load(t_row + idx, mask=msk, other=0.0)
            p = tl.exp(x - lse_s)
            q = tl.exp(y - lse_t)
            a = tl.log(q + eps) - tl.log(p + eps) + q / (q + eps)
            ds = g * (p * c - q * (p / (p + eps)))
            dt = g * (q * (a - ea))
            tl.store(ds_ptr + row * stride_ds + idx, ds, mask=msk)
            tl.store(dt_ptr + row * stride_dt + idx, dt, mask=msk)

    return kl_fwd_kernel, kl_bwd_kernel


def _check_operands(stu: torch.Tensor, tea: torch.Tensor) -> None:
    if stu.ndim != 2 or stu.shape != tea.shape:
        raise ValueError(
            f"masked KL kernel takes two (N, V) operands, got {tuple(stu.shape)} "
            f"and {tuple(tea.shape)}"
        )
    for name, x in (("student", stu), ("teacher", tea)):
        if x.dtype != torch.float32:
            raise TypeError(f"masked KL kernel: {name} must be f32, got {x.dtype}")
        if x.device != stu.device:
            raise ValueError(f"masked KL kernel: {name} on {x.device}, student on {stu.device}")
        if x.stride(-1) != 1:
            raise ValueError(f"masked KL kernel: {name} needs a contiguous last dim")


def rowwise_kl_forward(stu: torch.Tensor, tea: torch.Tensor, eps: float):
    """``(kl, lse_s, lse_t)``, each (N,) f32: the Triton kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if stu.device.type == "cpu":
        return rowwise_kl_reference(stu, tea, eps)
    _check_operands(stu, tea)
    n, v = stu.shape
    kl, lse_s, lse_t = (torch.empty((n,), dtype=torch.float32, device=stu.device) for _ in range(3))
    fwd, _ = _triton_kernels()
    fwd[(n,)](
        stu, tea, kl, lse_s, lse_t, v, stu.stride(0), tea.stride(0), float(eps),
        BLOCK=BLOCK_V, num_warps=NUM_WARPS,
    )
    rowwise_kl_forward.launches += 1
    return kl, lse_s, lse_t


rowwise_kl_forward.launches = 0  # kernel launches (CUDA tensors only)


def rowwise_kl_backward(stu, tea, lse_s, lse_t, g, eps: float):
    """``(d stu, d tea)``, (N, V) f32 each, rows scaled by ``g`` (N,): the
    Triton kernel for CUDA tensors, the plain version for CPU tensors."""
    if stu.device.type == "cpu":
        return rowwise_kl_backward_reference(stu, tea, lse_s, lse_t, g, eps)
    _check_operands(stu, tea)
    n, v = stu.shape
    g = g.to(device=stu.device, dtype=torch.float32).contiguous()
    lse_s, lse_t = lse_s.contiguous(), lse_t.contiguous()
    if g.shape != (n,) or lse_s.shape != (n,) or lse_t.shape != (n,):
        raise ValueError("masked KL backward: per-row tensors must be (N,)")
    dstu = torch.empty((n, v), dtype=torch.float32, device=stu.device)
    dtea = torch.empty((n, v), dtype=torch.float32, device=stu.device)
    _, bwd = _triton_kernels()
    bwd[(n,)](
        stu, tea, lse_s, lse_t, g, dstu, dtea, v, stu.stride(0), tea.stride(0),
        dstu.stride(0), dtea.stride(0), float(eps), BLOCK=BLOCK_V, num_warps=NUM_WARPS,
    )
    rowwise_kl_backward.launches += 1
    return dstu, dtea


rowwise_kl_backward.launches = 0  # kernel launches (CUDA tensors only)


class _RowwiseKL(torch.autograd.Function):
    """Per-row KL with the fused backward (JAX ``_rowwise_kl`` custom VJP)."""

    @staticmethod
    def forward(ctx, stu, tea, eps):
        kl, lse_s, lse_t = rowwise_kl_forward(stu, tea, eps)
        ctx.save_for_backward(stu, tea, lse_s, lse_t)
        ctx.eps = eps
        return kl

    @staticmethod
    def backward(ctx, g):
        stu, tea, lse_s, lse_t = ctx.saved_tensors
        dstu, dtea = rowwise_kl_backward(stu, tea, lse_s, lse_t, g, ctx.eps)
        return dstu, dtea, None


def masked_kl_pallas(
    student_scaled: torch.Tensor,  # (B, S, V) logits ALREADY divided by T
    teacher_scaled: torch.Tensor,  # (B, S, V) aligned, scaled
    mask: torch.Tensor,  # (B, S) bool
    eps: float = 1e-6,
) -> torch.Tensor:
    """Masked mean of per-row KLs (×T² applied by the caller).  The name
    keeps the JAX function's, so ``kl_impl=pallas`` reads the same."""
    b, s, v = student_scaled.shape
    n = b * s
    stu2d = student_scaled.reshape(n, v).float()
    tea2d = teacher_scaled.reshape(n, v).float()
    if stu2d.stride(-1) != 1:
        stu2d = stu2d.contiguous()
    if tea2d.stride(-1) != 1:
        tea2d = tea2d.contiguous()
    w = mask.reshape(n).float()
    denom = torch.clamp(torch.sum(w), min=1.0)
    kl = _RowwiseKL.apply(stu2d, tea2d, float(eps))
    # weighted mean as a dot, so the backward sees per-row cotangents w/Σw
    return torch.dot(kl, w) / denom
