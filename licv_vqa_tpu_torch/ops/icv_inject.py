"""ICV residual-stream injection: ``h' = (h+v) / ‖h+v‖₂ · ‖h‖₂``
(counterpart of ``licv_vqa_tpu/ops/icv_inject.py``).

Math (per token, last dim D): ``s = h + v``; ``h' = s · (‖h‖₂ / ‖s‖₂)``, with
the norms accumulated in f32 whatever the input dtype, and no epsilon (the
reference adds none, ``icv_inject.py:24``): ``h = -v`` gives NaN, as in JAX.

The kernel, in Triton, replaces ``_icv_inject_pallas`` (``icv_inject.py:56``,
body ``_inject_kernel`` :41-48).  JAX fuses the jnp form into every decoder
layer, with the residual add beside it (JAX ``models/decoder.py:690-697``);
eager PyTorch fuses nothing, so on the card this one kernel stands in for
the four to six elementwise and reduction launches of the plain version,
and two entry points take the adjacent residual add into the same pass:
``icv_inject_after_add(h, delta, shift)`` injects into ``h + delta`` (the
block output's site) and ``add_icv_inject(h, x, shift)`` adds the injected
``x`` to ``h`` (the MLP output's site), each rounding where eager PyTorch
rounds.
What bounds it on the H100: memory.  It reads h once and writes it once (2
bytes each way per bf16 element) plus one D-row of shift, and does ~6 flops
per element.  Its design: one program per row of D (4096 on Idefics-9B),
the whole row in registers (``BLOCK_D`` a power of two ≥ D, masked tail),
both sums of squares reduced in f32 from that one read, one ``rsqrt·sqrt``
per row, the scaled row written back in h's dtype — no intermediate in
device memory.  The shift is read through its batch and position strides,
so every layout the reference broadcasts — (D,), (B, D), (B, 1, D), (1, S,
D) and a per-position (B, S, D) — launches the kernel; the TPU kernel's gate that
sends a per-position shift to the jnp path (:94-106) has no counterpart on
the card.

The backward is a CUDA C++ kernel, ``csrc/icv_inject_bwd.cu`` (``_bwd``,
:113-133, with ``_reduce_to_shape`` :136, which JAX leaves to XLA's fusion;
the plain backward is about ten launches with f32 intermediates in eager
PyTorch).  Per row, with r = ‖h‖/‖s‖ and gs = g·s: ``ds = r·(g −
s·gs/‖s‖²)`` and ``dh = ds + (gs/‖s‖)·h/‖h‖``.  Memory bounds it too: it
reads h, g and the shift once and writes dh and the shift's gradient, with
the three row sums reduced from the one read.  It reduces the gradient to
the shift's own shape in the same launch (``backward_plan``): blocks of
rows of one segment (every row for a (D,) shift, a batch row's S rows for a
(B, D) or (B, 1, D) one, a position's B rows for a (1, S, D) one shared by
the batch) sum their rows' ds in f32 registers, a
thread-block cluster sums its blocks' through distributed shared memory
into one f32 partial, and the last cluster of a segment (an atomic ticket)
sums the partials in order, each of its blocks a slice of D, and writes the
gradient in the shift's dtype.  No float atomics: two calls give equal
bits.  A per-position (B, S, D) shift takes its ds directly.  CUDA C++
rather than Triton for the cluster: a single program summing every partial
left a tail of microseconds that Triton cannot spread over programs.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

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


def icv_inject_after_add_reference(
    h: torch.Tensor, delta: torch.Tensor, shift: torch.Tensor
) -> torch.Tensor:
    """Plain ``icv_inject_after_add``: the residual add, then the injection."""
    return icv_inject_reference(h + delta, shift)


def add_icv_inject_reference(h: torch.Tensor, x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Plain ``add_icv_inject``: ``x`` injected, then added to ``h``."""
    return h + icv_inject_reference(x, shift)


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


# the forward kernel's residual add: none, before the injection (block
# output) or after it (MLP output)
INJECT, ADD_THEN_INJECT, INJECT_THEN_ADD = 0, 1, 2


@functools.cache
def _triton_kernel():
    """Define the forward Triton kernel on first launch (triton is imported
    only here: a machine without it can still import this module)."""
    import triton
    import triton.language as tl

    @triton.jit
    def inject_kernel(
        x_ptr, r_ptr, v_ptr, out_ptr, s_ptr, rows_per_batch, d, v_stride_b, v_stride_s,
        BLOCK_D: tl.constexpr, ADD: tl.constexpr, WRITE_S: tl.constexpr,
    ):
        # ADD_THEN_INJECT: s = round(x + r) is injected (and written to s_ptr
        # where WRITE_S); INJECT_THEN_ADD: out = round(r + round(inject(x)));
        # INJECT: out = inject(x).  Rounding to each tensor's dtype where
        # eager PyTorch's add and the injection round.
        row = tl.program_id(0).to(tl.int64)
        b = row // rows_per_batch
        pos = row % rows_per_batch
        offs = tl.arange(0, BLOCK_D)
        m = offs < d
        base = row * d
        h = tl.load(x_ptr + base + offs, mask=m, other=0.0).to(tl.float32)
        if ADD != 0:
            res = tl.load(r_ptr + base + offs, mask=m, other=0.0).to(tl.float32)
        if ADD == 1:
            h = (h + res).to(out_ptr.dtype.element_ty)
            if WRITE_S:
                tl.store(s_ptr + base + offs, h, mask=m)
            h = h.to(tl.float32)
        v_row = v_ptr + b * v_stride_b + pos * v_stride_s
        v = tl.load(v_row + offs, mask=m, other=0.0).to(tl.float32)
        s = h + v
        h_sq = tl.sum(h * h, axis=0)
        s_sq = tl.sum(s * s, axis=0)
        scale = tl.math.rsqrt(s_sq) * tl.sqrt(h_sq)
        out = s * scale
        if ADD == 2:
            out = res + out.to(x_ptr.dtype.element_ty).to(tl.float32)
        tl.store(out_ptr + base + offs, out.to(out_ptr.dtype.element_ty), mask=m)

    return triton, inject_kernel


def _num_warps(block_d: int) -> int:
    return max(1, min(16, block_d // 512))


def _check_rows(h: torch.Tensor, *others: torch.Tensor) -> None:
    if h.ndim != 3:
        raise ValueError(f"icv_inject kernel takes (B, S, D) h, got {tuple(h.shape)}")
    for x in others:
        if x.shape != h.shape or x.device != h.device:
            raise ValueError(f"icv_inject kernel: the residual operand {tuple(x.shape)} on "
                             f"{x.device} is not h's {tuple(h.shape)} on {h.device}")


def _icv_inject_triton(
    x: torch.Tensor, shift: torch.Tensor, residual: torch.Tensor = None,
    add: int = INJECT, write_s: bool = False,
):
    """One launch of the forward kernel on (B, S, D) ``x``: ``out``, or
    ``(out, s)`` where ``write_s`` (``ADD_THEN_INJECT`` only)."""
    b, s, d = x.shape
    shift = _per_row_shift(x, shift)
    x = x.contiguous()
    out_dtype = x.dtype if add == INJECT else torch.result_type(x, residual)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    s_rows = torch.empty_like(out) if write_s else None
    r = residual.contiguous() if add != INJECT else x
    triton, kernel = _triton_kernel()
    block_d = triton.next_power_of_2(d)
    kernel[(b * s,)](
        x, r, shift, out, s_rows if write_s else out, s, d, shift.stride(0), shift.stride(1),
        BLOCK_D=block_d, ADD=add, WRITE_S=write_s, num_warps=_num_warps(block_d),
    )
    icv_inject.launches += 1
    return (out, s_rows) if write_s else out


# the backward kernel (csrc/icv_inject_bwd.cu): its rows a step (loaded
# together), the blocks it aims at over all segments, its largest cluster
BWD_STEP_ROWS = 2
BWD_BLOCKS = 128
BWD_MAX_CLUSTER = 8


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """How the backward kernel's blocks cover the rows and reduce the
    shift's gradient.  ``segments`` of ``seg_rows`` rows each reduce to one
    D-row of the gradient (a per-position shift: one segment, no
    reduction); row ``i`` of segment ``g`` is ``g * seg_step + i *
    row_step`` (consecutive rows, or a position's rows of every batch row);
    block ``j`` of a segment takes its rows ``[j * rows_per_block, (j + 1)
    * rows_per_block)`` (none past its end), adding each row's ds in that
    order; its segment's blocks form clusters of ``cluster`` consecutive
    blocks, summed in rank order into one partial each, and the partials
    are summed in cluster order."""

    reduce: bool
    segments: int
    seg_rows: int
    rows_per_block: int
    blocks_per_seg: int
    cluster: int
    seg_step: int
    row_step: int = 1

    @property
    def blocks(self) -> int:
        return self.segments * self.blocks_per_seg

    @property
    def clusters(self) -> int:
        return self.blocks // self.cluster

    def segment_rows(self, seg: int) -> range:
        return range(seg * self.seg_step, seg * self.seg_step + self.seg_rows * self.row_step,
                     self.row_step)

    def rows(self, block: int) -> range:
        seg, j = divmod(block, self.blocks_per_seg)
        start = min(j * self.rows_per_block, self.seg_rows)
        stop = min(start + self.rows_per_block, self.seg_rows)
        return self.segment_rows(seg)[start:stop]


def backward_plan(b: int, s: int, layout: str, max_blocks: int = BWD_BLOCKS) -> BackwardPlan:
    """The plan for (B, S, D) rows and a shift ``layout``: "row" (one D-row
    over every row), "batch" (one a batch row, over its S rows), "pos" (one
    a position, over its B rows ``b * S + j``) or "per_pos" (no
    reduction).  About ``max_blocks`` blocks (the card's one wave of
    clusters, at most ``BWD_BLOCKS``) of whole ``BWD_STEP_ROWS``-row steps
    (fewer where the rows run out), in clusters of up to
    ``BWD_MAX_CLUSTER``."""
    reduce = layout != "per_pos"
    segments, seg_rows = {"batch": (b, s), "pos": (s, b)}.get(layout, (1, b * s))
    seg_step, row_step = (1, s) if layout == "pos" else (seg_rows, 1)
    steps = math.ceil(seg_rows / BWD_STEP_ROWS)
    blocks = min(steps, max(1, min(BWD_BLOCKS, max_blocks) // segments))
    cluster = min(BWD_MAX_CLUSTER, blocks) if reduce else 1
    blocks = math.ceil(blocks / cluster) * cluster
    rows = BWD_STEP_ROWS * math.ceil(steps / blocks)
    return BackwardPlan(reduce, segments, seg_rows, rows, blocks, cluster, seg_step, row_step)


def _shift_layout(rows: torch.Tensor) -> str:
    """The layout of a shift broadcast to (B, S, D) by ``_per_row_shift``,
    from its strides: one row for every row, one a batch row, one a
    position shared by the batch, or one a row."""
    b, s, _ = rows.shape
    if (b == 1 or rows.stride(0) == 0) and (s == 1 or rows.stride(1) == 0):
        return "row"
    if s == 1 or rows.stride(1) == 0:
        return "batch"
    if b == 1 or rows.stride(0) != 0:
        return "per_pos"
    return "pos"


@functools.cache
def _one_wave(device_index: int, d: int, h_f32: bool, v_f32: bool) -> int:
    """The blocks of one wave of the backward kernel's largest clusters on
    the card (``icv_inject_bwd_max_clusters``)."""
    from ..csrc import load_library

    fn = load_library("icv_inject_bwd.cu").icv_inject_bwd_max_clusters
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4
    with torch.cuda.device(device_index):
        n = fn(d, BWD_MAX_CLUSTER, int(h_f32), int(v_f32))
    if n <= 0:
        raise RuntimeError(f"icv_inject_bwd_max_clusters failed: cudaError {-n}")
    return n * BWD_MAX_CLUSTER


_tickets = {}  # device -> int32 counters, zero between calls


def _ticket_buffer(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters on ``device``, kept across
    calls: the kernel's last clusters leave them zero."""
    buf = _tickets.get(device)
    if buf is None or buf.numel() < n:
        buf = _tickets[device] = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
    return buf


def icv_inject_backward(
    h: torch.Tensor, shift: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dh, the shift's gradient)``: one launch of the CUDA kernel
    ``csrc/icv_inject_bwd.cu``, dh and the gradient reduced to the shift's
    shape and dtype in it, for CUDA tensors (h in bf16 or f32, D a multiple
    of 16 bytes of it, at most 4096; the shift in bf16 or f32); the plain
    version for CPU tensors."""
    if h.device.type == "cpu":
        return icv_inject_backward_reference(h, shift, g)
    if h.ndim != 3 or g.shape != h.shape or g.dtype != h.dtype:
        raise ValueError(
            f"icv_inject backward kernel takes (B, S, D) h and g of one dtype, got "
            f"{tuple(h.shape)} {h.dtype} and {tuple(g.shape)} {g.dtype}"
        )
    kinds = (torch.bfloat16, torch.float32)
    if h.dtype not in kinds or shift.dtype not in kinds:
        raise TypeError(f"icv_inject backward kernel: h {h.dtype}, shift {shift.dtype}; "
                        f"takes {kinds}")
    from ..csrc import load_library

    b, s, d = h.shape
    rows = _per_row_shift(h, shift)
    h_f32, v_f32 = h.dtype == torch.float32, shift.dtype == torch.float32
    plan = backward_plan(b, s, _shift_layout(rows),
                         _one_wave(h.device.index or 0, d, h_f32, v_f32))
    h, g = h.contiguous(), g.contiguous()
    dh = torch.empty_like(h)
    ds = torch.empty(shift.shape, dtype=shift.dtype, device=h.device)
    part = tickets = None
    if plan.clusters > plan.segments:  # the partials of a segment's clusters
        part = torch.empty((plan.clusters, d), dtype=torch.float32, device=h.device)
        tickets = _ticket_buffer(h.device, plan.segments)
    fn = load_library("icv_inject_bwd.cu").icv_inject_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    err = fn(
        h.data_ptr(), rows.data_ptr(), g.data_ptr(), dh.data_ptr(), ds.data_ptr(),
        part.data_ptr() if part is not None else None,
        tickets.data_ptr() if tickets is not None else None, s, d, rows.stride(0),
        rows.stride(1), plan.segments, plan.seg_rows, plan.rows_per_block, plan.blocks_per_seg,
        plan.seg_step, plan.row_step, plan.cluster, int(plan.reduce), int(h_f32), int(v_f32),
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"icv_inject_bwd launch failed: cudaError {err}")
    icv_inject_backward.launches += 1
    return dh, ds


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


class _ICVInjectAfterAdd(torch.autograd.Function):
    """``inject(h + delta)`` in one forward launch that also writes the sum
    s, whose backward is the ICV backward kernel at s (the add's gradient
    passes through to both operands)."""

    @staticmethod
    def forward(ctx, h, delta, shift):
        out, s = _icv_inject_triton(h, shift, delta, ADD_THEN_INJECT, write_s=True)
        ctx.save_for_backward(s, shift)
        ctx.dtypes = h.dtype, delta.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        s, shift = ctx.saved_tensors
        ds, dshift = icv_inject_backward(s, shift, g.to(s.dtype))
        return ds.to(ctx.dtypes[0]), ds.to(ctx.dtypes[1]), dshift


class _AddICVInject(torch.autograd.Function):
    """``h + inject(x)`` in one forward launch, whose backward passes g to h
    and runs the ICV backward kernel at x."""

    @staticmethod
    def forward(ctx, h, x, shift):
        ctx.save_for_backward(x, shift)
        ctx.h_dtype = h.dtype
        return _icv_inject_triton(x, shift, h, INJECT_THEN_ADD)

    @staticmethod
    def backward(ctx, g):
        x, shift = ctx.saved_tensors
        dx, dshift = icv_inject_backward(x, shift, g.to(x.dtype))
        return g.to(ctx.h_dtype), dx, dshift


def _recording(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def icv_inject(h: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Injection: the Triton forward kernel, and under autograd the CUDA
    backward kernel (``csrc/icv_inject_bwd.cu``), for a CUDA ``(B, S, D)``
    h, whatever the shift's layout; the plain version, differentiated by
    autograd, for a CPU tensor."""
    if h.device.type == "cpu":
        return icv_inject_reference(h, shift)
    _check_rows(h)
    return _ICVInject.apply(h, shift)


icv_inject.launches = 0  # forward kernel launches, the fused entries' too (CUDA only)


def icv_inject_after_add(h: torch.Tensor, delta: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``inject(h + delta, shift)``, the sum rounded to its dtype first, as
    eager PyTorch rounds it: one launch of the forward kernel for CUDA
    ``(B, S, D)`` h and delta (it writes the sum too only under autograd,
    for the backward kernel); the plain add and injection for CPU tensors."""
    if h.device.type == "cpu":
        return icv_inject_after_add_reference(h, delta, shift)
    _check_rows(h, delta)
    if _recording(h, delta, shift):
        return _ICVInjectAfterAdd.apply(h, delta, shift)
    return _icv_inject_triton(h, shift, delta, ADD_THEN_INJECT)


def add_icv_inject(h: torch.Tensor, x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``h + inject(x, shift)``, the injection rounded to x's dtype first, as
    eager PyTorch rounds it: one launch of the forward kernel for CUDA
    ``(B, S, D)`` h and x; the plain injection and add for CPU tensors."""
    if h.device.type == "cpu":
        return add_icv_inject_reference(h, x, shift)
    _check_rows(x, h)
    if _recording(h, x, shift):
        return _AddICVInject.apply(h, x, shift)
    return _icv_inject_triton(x, shift, h, INJECT_THEN_ADD)
