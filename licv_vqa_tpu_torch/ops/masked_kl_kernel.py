"""Fused masked temperature-KL, forward and backward, as CUDA C++ kernels
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

The masked mean takes per-row weights ``w`` (the mask as f32): a row of
weight 0 adds nothing to it and gets a zero cotangent, so the op defines
its KL and log-sum-exps as 0 and its gradients as 0 without reading it.
JAX computes such a row and multiplies it by 0: the same values, except
that non-finite logits in a masked row give NaN there and a finite loss
here.

The kernels, in CUDA C++ (``csrc/masked_kl.cu``), replace ``_kl_fwd_kernel``
(:43) and ``_kl_bwd_kernel`` (:50) behind ``_rowwise_kl`` (:75).  What
bounds them on the H100: memory.  On the training path the operands are
(N, V) = (bs·64, 32002) f32 and most rows lie outside the answer mask; the
forward must read both operands of each weighted row once (8 bytes an
element) and the backward read them and write both gradients (16 bytes an
element, 8 for a zero-weight row), against ~20 and ~30 flops an element.
The TPU kernel holds whole (r, V) row blocks in VMEM; a Hopper block has
227 KB of shared memory, so each row is split over a thread-block cluster
of up to 8 blocks (``launch_plan``), each holding its slice of both
operands in shared memory from one read, each cluster of a persistent
grid taking its share of the weighted rows: the slices' (max, Σexp) pairs
and partial sums are merged through distributed shared memory in rank
order (no atomics; equal bits across calls).  The source's comment has the
design.  The ε inside the logs rules out a log-softmax shortcut: p and q
are formed explicitly.  The TPU's pad-rows-to-8 rule (:140) is a sublane
constraint with no counterpart here: rows are launched as they are.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

# the cluster sizes a row is split over, the fewest columns a block takes
# where the row allows (four 16-byte copies a thread), and the most rows of
# each weight kind a cluster of the persistent grid takes
KL_CLUSTERS = (1, 2, 4, 8)
KL_MIN_SLICE = 4 * 256
KL_MAX_ROWS = 256


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the yardstick on the card)
# ---------------------------------------------------------------------------


def _weighted(w, n: int, device) -> torch.Tensor:
    """The (N,) f32 row weights, every row weighted where ``w`` is None."""
    if w is None:
        return torch.ones((n,), dtype=torch.float32, device=device)
    return w.to(device=device, dtype=torch.float32)


def rowwise_kl_reference(stu: torch.Tensor, tea: torch.Tensor, eps: float, w=None):
    """Per-row KL of (N, V) f32 scaled logits: ``(kl (N,), lse_s (N,),
    lse_t (N,))``, the same three outputs as the forward kernel, each 0 in
    a row of weight ``w`` 0 (``w`` (N,); None: every row)."""
    lse_s = torch.logsumexp(stu, dim=-1)
    lse_t = torch.logsumexp(tea, dim=-1)
    p = torch.exp(stu - lse_s[:, None])
    q = torch.exp(tea - lse_t[:, None])
    kl = torch.sum(q * (torch.log(q + eps) - torch.log(p + eps)), dim=-1)
    if w is None:
        return kl, lse_s, lse_t
    keep = _weighted(w, stu.shape[0], stu.device) != 0
    return tuple(torch.where(keep, x, torch.zeros_like(x)) for x in (kl, lse_s, lse_t))


def rowwise_kl_backward_reference(stu, tea, lse_s, lse_t, g, eps: float, w=None):
    """Both input gradients of the per-row KL, each row scaled by its
    cotangent ``g`` (N,): the closed forms in the module docstring; 0 in a
    row of weight ``w`` 0."""
    p = torch.exp(stu - lse_s[:, None])
    q = torch.exp(tea - lse_t[:, None])
    g = g[:, None].float()
    pr = p / (p + eps)
    c = torch.sum(q * pr, dim=-1, keepdim=True)
    dstu = g * (p * c - q * pr)
    a = torch.log(q + eps) - torch.log(p + eps) + q / (q + eps)
    ea = torch.sum(q * a, dim=-1, keepdim=True)
    dtea = g * (q * (a - ea))
    if w is not None:
        keep = (_weighted(w, stu.shape[0], stu.device) != 0)[:, None]
        dstu = torch.where(keep, dstu, torch.zeros_like(dstu))
        dtea = torch.where(keep, dtea, torch.zeros_like(dtea))
    return dstu.to(stu.dtype), dtea.to(tea.dtype)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/masked_kl.cu)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KLPlan:
    """A row over a cluster of ``cluster`` blocks, block ``r`` the columns
    ``[r * width, min(V, (r + 1) * width))``; a persistent grid of
    ``clusters`` such clusters, each taking every ``clusters``-th weighted
    row and every ``clusters``-th zero-weight one."""

    cluster: int
    width: int
    clusters: int = 1

    def slices(self, v: int) -> list:
        return [range(r * self.width, min(v, (r + 1) * self.width)) for r in range(self.cluster)]


def _split(v: int, cluster: int) -> KLPlan:
    """V over at most ``cluster`` blocks, each a multiple of 4 columns wide
    and none empty."""
    width = 4 * math.ceil(v / (4 * cluster))
    return KLPlan(math.ceil(v / width), width)


def launch_plan(n: int, v: int, max_clusters) -> KLPlan:
    """The plan for N rows of V columns: of the splits over ``KL_CLUSTERS``
    blocks (no block narrower than ``KL_MIN_SLICE`` where the row is
    wider), the one whose blocks have the fewest columns to take in turn
    (the rows a cluster takes, ``ceil(N / clusters at once)``, times the
    slice's width) with the card's clusters (``max_clusters(plan)``: how
    many it runs at once, 0 where its slices do not fit a block), the
    larger cluster on a tie; a grid of that many clusters, or N if fewer."""
    plans = {_split(v, c) for c in KL_CLUSTERS
             if c == 1 or 4 * math.ceil(v / (4 * c)) >= KL_MIN_SLICE}
    best = None
    for plan in sorted(plans, key=lambda pl: -pl.cluster):
        at_once = max_clusters(plan)
        if at_once <= 0:
            continue
        columns = math.ceil(n / at_once) * plan.width
        if best is None or columns < best[0]:
            best = (columns, dataclasses.replace(plan, clusters=min(at_once, n)))
    if best is None:
        raise ValueError(f"masked KL kernel: no split of {v} columns fits the card")
    if math.ceil(n / best[1].clusters) > KL_MAX_ROWS:
        raise ValueError(f"masked KL kernel: {n} rows over {best[1].clusters} clusters exceed "
                         f"{KL_MAX_ROWS} a cluster")
    return best[1]


def smem_bytes(width: int, backward: bool) -> int:
    """A block's dynamic shared memory: its slice of both operands (and of A
    in the backward), 4 columns of room for the row's misalignment each."""
    return (3 if backward else 2) * (width + 4) * 4


@functools.cache
def _max_clusters(device_index: int, width: int, cluster: int, backward: bool) -> int:
    """The clusters the card runs at once (``masked_kl_max_clusters``); 0
    where a block's slices exceed its shared memory."""
    from ..csrc import load_library

    # the kernels' static shared memory (the row lists, under 3 KB) beside the slices
    limit = torch.cuda.get_device_properties(device_index).shared_memory_per_block_optin - 3072
    if smem_bytes(width, backward) > limit:
        return 0
    fn = load_library("masked_kl.cu").masked_kl_max_clusters
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3
    with torch.cuda.device(device_index):
        got = fn(width, cluster, int(backward))
    if got < 0:
        raise RuntimeError(f"masked_kl_max_clusters failed: cudaError {-got}")
    return got


def _card_plan(x: torch.Tensor, backward: bool) -> KLPlan:
    n, v = x.shape
    return launch_plan(n, v, lambda pl: _max_clusters(
        x.device.index or 0, pl.width, pl.cluster, backward))


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous with a 16-byte aligned start, as the kernels read it."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


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


def _per_row(x, n: int, device) -> torch.Tensor:
    x = x.to(device=device, dtype=torch.float32).contiguous()
    if x.shape != (n,):
        raise ValueError(f"masked KL kernel: per-row tensors must be ({n},), got {tuple(x.shape)}")
    return x


def rowwise_kl_forward(stu: torch.Tensor, tea: torch.Tensor, eps: float, w=None):
    """``(kl, lse_s, lse_t)``, each (N,) f32, 0 in a row of weight ``w`` 0
    (``w`` (N,); None: every row): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if stu.device.type == "cpu":
        return rowwise_kl_reference(stu, tea, eps, w)
    _check_operands(stu, tea)
    from ..csrc import load_library

    n, v = stu.shape
    stu, tea = _rows(stu), _rows(tea)
    w = _per_row(_weighted(w, n, stu.device), n, stu.device)
    kl, lse_s, lse_t = (torch.empty((n,), dtype=torch.float32, device=stu.device) for _ in range(3))
    plan = _card_plan(stu, backward=False)
    fn = load_library("masked_kl.cu").masked_kl_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    err = fn(stu.data_ptr(), tea.data_ptr(), w.data_ptr(), kl.data_ptr(), lse_s.data_ptr(),
             lse_t.data_ptr(), n, v, plan.width, plan.cluster, plan.clusters, float(eps),
             torch.cuda.current_stream(stu.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"masked_kl_fwd launch failed: cudaError {err}")
    rowwise_kl_forward.launches += 1
    return kl, lse_s, lse_t


rowwise_kl_forward.launches = 0  # kernel launches (CUDA tensors only)


def rowwise_kl_backward(stu, tea, lse_s, lse_t, g, eps: float, w=None):
    """``(d stu, d tea)``, (N, V) f32 each, rows scaled by ``g`` (N,), 0 in
    a row of weight ``w`` 0: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if stu.device.type == "cpu":
        return rowwise_kl_backward_reference(stu, tea, lse_s, lse_t, g, eps, w)
    _check_operands(stu, tea)
    from ..csrc import load_library

    n, v = stu.shape
    stu, tea = _rows(stu), _rows(tea)
    w, g, lse_s, lse_t = (_per_row(x, n, stu.device)
                          for x in (_weighted(w, n, stu.device), g, lse_s, lse_t))
    dstu = torch.empty((n, v), dtype=torch.float32, device=stu.device)
    dtea = torch.empty((n, v), dtype=torch.float32, device=stu.device)
    plan = _card_plan(stu, backward=True)
    fn = load_library("masked_kl.cu").masked_kl_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    err = fn(stu.data_ptr(), tea.data_ptr(), w.data_ptr(), lse_s.data_ptr(), lse_t.data_ptr(),
             g.data_ptr(), dstu.data_ptr(), dtea.data_ptr(), n, v, plan.width, plan.cluster,
             plan.clusters, float(eps), torch.cuda.current_stream(stu.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"masked_kl_bwd launch failed: cudaError {err}")
    rowwise_kl_backward.launches += 1
    return dstu, dtea


rowwise_kl_backward.launches = 0  # kernel launches (CUDA tensors only)


class _RowwiseKL(torch.autograd.Function):
    """Per-row KL with the fused backward (JAX ``_rowwise_kl`` custom VJP),
    rows of weight ``w`` 0 neither read nor differentiated."""

    @staticmethod
    def forward(ctx, stu, tea, w, eps):
        kl, lse_s, lse_t = rowwise_kl_forward(stu, tea, eps, w)
        ctx.save_for_backward(stu, tea, lse_s, lse_t, w)
        ctx.eps = eps
        return kl

    @staticmethod
    def backward(ctx, g):
        stu, tea, lse_s, lse_t, w = ctx.saved_tensors
        dstu, dtea = rowwise_kl_backward(stu, tea, lse_s, lse_t, g, ctx.eps, w)
        return dstu, dtea, None, None


def masked_kl_pallas(
    student_scaled: torch.Tensor,  # (B, S, V) logits ALREADY divided by T
    teacher_scaled: torch.Tensor,  # (B, S, V) aligned, scaled
    mask: torch.Tensor,  # (B, S) bool
    eps: float = 1e-6,
    denom=None,  # the mean's denominator where it is not this mask's Σ
) -> torch.Tensor:
    """Masked mean of per-row KLs (×T² applied by the caller).  The name
    keeps the JAX function's, so ``kl_impl=pallas`` reads the same.
    ``denom`` (a dp-split batch): the global batch's mask count, so the
    ranks' values sum to the global mean."""
    b, s, v = student_scaled.shape
    n = b * s
    stu2d = student_scaled.reshape(n, v).float()
    tea2d = teacher_scaled.reshape(n, v).float()
    if stu2d.stride(-1) != 1:
        stu2d = stu2d.contiguous()
    if tea2d.stride(-1) != 1:
        tea2d = tea2d.contiguous()
    w = mask.reshape(n).float()
    denom = torch.clamp(torch.sum(w) if denom is None else denom, min=1.0)
    kl = _RowwiseKL.apply(stu2d, tea2d, w, float(eps))
    # weighted mean as a dot, so the backward sees per-row cotangents w/Σw
    return torch.dot(kl, w) / denom
