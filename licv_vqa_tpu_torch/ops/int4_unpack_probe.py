"""The int4 unpack-schedule probe (counterpart of
``tools/exp_int4_unpack.py::make_fn``): four ways to widen a nibble-packed
int4 weight at a decode-step matmul, ``y (M, N) f32 = bf16(x) @
(decode(packed) · s)``, each rounding where its JAX body rounds.

Operands, as the JAX tool's ``main`` packs them (``probe_operands``):
``packed (K/2, N) uint8`` with in-feature ``i`` in the low nibble and
``i + K/2`` in the high one, and ``s (K/G, N) f32`` group scales in feature
order.  Schedules (``SCHEDULES``):

- ``a`` (``body_a``): both nibbles biased by +8; ``w = (u - 8) · s`` in f32;
- ``d`` (``body_d``): both biased; ``w = bf16((q + 8) · bf16(s))`` and, in
  the kernel, ``- 8 · Σ_g bf16(Σ_{i∈g} x_i) · bf16(s_g)`` per plane;
- ``e`` (``body_e``): signed nibbles; ``w = bf16(q · bf16(s))``;
- ``f`` (``body_f``): the mixed-plane layout of ``ops/quantize.py`` (low
  biased, high two's complement), read as ``u & 15`` and ``u & 0xF0`` as
  int8 (= 16·q) with the high plane's scales divided by 16 beforehand;
  ``w`` as in ``d``; the +8 correction of the low plane is a small matmul
  outside the kernel (``_f_correction``), as JAX's ``f_full`` does it.

``int4_unpack_probe`` launches ``csrc/int4_unpack_probe.cu`` for CUDA
tensors or raises; CPU tensors take ``int4_unpack_probe_reference``.  The
production int4 matmul is ``ops/int4_matmul.py``; this probe is reached by
``tools/exp_int4_unpack_torch.py``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .int8_matmul import _sm_count

SCHEDULES = ("a", "d", "e", "f")
# the kernel's tiles (csrc/int4_unpack_probe.cu): 128 output columns by 16
# activation rows a block, 64 packed rows a stage; the blocks of one tile's
# split-K form one thread-block cluster, at most 8
TILE_N = 128
TILE_M = 16
STAGE_ROWS = 64
MAX_SPLITS = 8
MIN_GROUP = 8


def probe_operands(q: torch.Tensor, s: torch.Tensor, schedule: str):
    """``(packed, s_table)`` for ``schedule`` from signed int4 values ``q``
    (K, N) int8 in [-7, 7] and group scales ``s`` (K/G, N) f32, packed as
    the JAX tool's ``main`` packs them (exp_int4_unpack.py:160-171)."""
    k = q.shape[0]
    k2, kg = k // 2, s.shape[0]
    if schedule == "e":  # two's-complement nibbles in both planes
        u = q.view(torch.uint8) & 0xF
        return u[:k2] | (u[k2:] << 4), s.float().clone()
    qb = (q + 8).to(torch.uint8)  # biased
    if schedule in ("a", "d"):
        return qb[:k2] | (qb[k2:] << 4), s.float().clone()
    if schedule != "f":
        raise ValueError(f"unknown schedule {schedule!r}, want one of {SCHEDULES}")
    packed = (qb[:k2] & 15) | ((q[k2:].view(torch.uint8) & 0xF) << 4)
    table = s.float().clone()
    table[kg // 2:] /= 16.0
    return packed, table


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _group_sums_bf16(xb: torch.Tensor, group: int) -> torch.Tensor:
    """Each group's sum of the bf16 activations (M, K') -> (M, K'/G), exact
    in f64, rounded to f32 and then to bf16 (as f32)."""
    m, k = xb.shape
    return _bf16(xb.double().reshape(m, k // group, group).sum(-1).float())


def _decode(packed: torch.Tensor, schedule: str):
    """The two planes' integer values (K/2, N) as the schedule reads them."""
    u = packed.to(torch.int32)
    lo, hi = u & 15, u >> 4
    if schedule == "a":
        return lo - 8, hi - 8
    if schedule == "d":
        return lo, hi
    if schedule == "e":  # sign extension of each nibble
        return lo - 16 * (lo >= 8), hi - 16 * (hi >= 8)
    return lo, (u & 0xF0) - 256 * ((u & 0xF0) >= 128)  # f: u & 0xF0 as int8


def _raw_reference(x, packed, s, group: int, schedule: str) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch (f32)."""
    k2, n = packed.shape
    xb = x.to(torch.bfloat16).float()
    rows = s.float().repeat_interleave(group, dim=0)  # (K, N) per in-feature
    if schedule != "a":
        rows = _bf16(rows)
    lo, hi = _decode(packed, schedule)
    w_lo, w_hi = lo.float() * rows[:k2], hi.float() * rows[k2:]
    if schedule != "a":
        w_lo, w_hi = _bf16(w_lo), _bf16(w_hi)
    y = xb[:, :k2] @ w_lo + xb[:, k2:] @ w_hi
    if schedule == "d":
        sb, kg2 = _bf16(s.float()), k2 // group
        y = (y - 8.0 * (_group_sums_bf16(xb[:, :k2], group) @ sb[:kg2])
             - 8.0 * (_group_sums_bf16(xb[:, k2:], group) @ sb[kg2:]))
    return y


def _f_correction(x, s, group: int) -> torch.Tensor:
    """Schedule f's +8 bias of the low plane: ``8 · bf16 group sums of x_lo
    @ bf16(s_lo)`` (the table's low half is not divided)."""
    k = x.shape[1]
    xg = _group_sums_bf16(x.to(torch.bfloat16).float()[:, : k // 2], group)
    return 8.0 * (xg @ _bf16(s.float()[: k // 2 // group]))


def _f_corrected(out, xb, s, group: int) -> torch.Tensor:
    """``out - _f_correction`` in fewer launches, for the kernel's output:
    the group sums from the bf16 activations ``xb`` the kernel read, the
    product and the subtraction in one ``addmm`` (8 is a power of two, so
    scaling the product by -8 rounds nothing)."""
    m, k = xb.shape
    xg = xb[:, : k // 2].reshape(m, -1, group).sum(-1, dtype=torch.float64)
    xg = xg.float().to(torch.bfloat16)
    return torch.addmm(out, xg.float(), s[: k // 2 // group].to(torch.bfloat16).float(),
                       alpha=-8.0)


def int4_unpack_probe_reference(x, packed, s, group: int, schedule: str) -> torch.Tensor:
    """Plain version of ``int4_unpack_probe``."""
    y = _raw_reference(x, packed, s, group, schedule)
    return y - _f_correction(x, s, group) if schedule == "f" else y


def launch_plan(m: int, k2: int, n: int, group: int, n_sm: int) -> tuple[int, int]:
    """``(splits, rows_per_split)`` for M = ``m`` rows, K/2 = ``k2`` packed
    rows, N = ``n`` columns and groups of ``group``: split-K blocks (one
    cluster, at most ``MAX_SPLITS``) of whole stages and whole groups (so
    that schedule d's group sums are never cut), no split left empty,
    enough for about two blocks an SM, as the int4 decode kernel plans at
    its beam-step shapes (``ops/int4_matmul.py::launch_plan``)."""
    unit = math.lcm(STAGE_ROWS, group)
    units = math.ceil(k2 / unit)
    tiles = math.ceil(n / TILE_N) * math.ceil(m / TILE_M)
    splits = max(1, min(MAX_SPLITS, units, math.ceil(2 * n_sm / tiles)))
    per = math.ceil(units / splits) * unit
    return math.ceil(k2 / per), per


def _check(x, packed, s, group: int, schedule: str) -> None:
    m, k = x.shape
    k2, n = packed.shape
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}, want one of {SCHEDULES}")
    if packed.dtype != torch.uint8 or s.dtype != torch.float32:
        raise TypeError(f"int4_unpack_probe: packed {packed.dtype} / s {s.dtype}, want uint8 / "
                        "float32")
    if k != 2 * k2 or tuple(s.shape) != (k // group, n) or group < MIN_GROUP or k2 % group \
            or n % 4:
        raise ValueError(f"int4_unpack_probe: x {tuple(x.shape)}, packed {tuple(packed.shape)}, "
                         f"s {tuple(s.shape)}, G={group} do not agree (N % 4 == 0, G >= "
                         f"{MIN_GROUP}, G divides K/2)")
    for t, what in ((packed, "packed"), (s, "s")):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"int4_unpack_probe: {what} must be contiguous on {x.device}")


def int4_unpack_probe(x, packed, s, group: int, schedule: str) -> torch.Tensor:
    """``bf16(x) @ (decode(packed) · s)`` under ``schedule`` (module
    docstring): x (M, K), packed (K/2, N) uint8, s (K/G, N) f32; returns
    (M, N) f32.

    CUDA tensors launch ``csrc/int4_unpack_probe.cu`` (one launch, split-K
    summed in a cluster; schedule f's +8 correction then follows as a
    plain matmul) or raise; CPU tensors take
    ``int4_unpack_probe_reference``."""
    if x.device.type == "cpu":
        return int4_unpack_probe_reference(x, packed, s, group, schedule)
    from ..csrc import load_library

    _check(x, packed, s, group, schedule)
    m, k = x.shape
    k2, n = packed.shape
    xb = x.to(torch.bfloat16).contiguous()
    splits, per = launch_plan(m, k2, n, group, _sm_count(x.device.index or 0))
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = load_library("int4_unpack_probe.cu").int4_unpack_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    err = fn(
        xb.data_ptr(), packed.data_ptr(), s.data_ptr(), out.data_ptr(), m, k, n, group, splits,
        per, SCHEDULES.index(schedule), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"int4_unpack_probe launch failed: cudaError {err}")
    int4_unpack_probe.launches += 1
    return _f_corrected(out, xb, s, group) if schedule == "f" else out


int4_unpack_probe.launches = 0  # kernel launches (CUDA tensors only)
