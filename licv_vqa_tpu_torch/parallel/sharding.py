"""Sharding rules, explicit shards and the Megatron collectives
(counterpart of ``licv_vqa_tpu/parallel/sharding.py``).

The rule tables are JAX's, so ``param_specs`` gives the same spec tree leaf
for leaf (a spec is a tuple of axis names, ``()`` replicated):

- ``tp``: column split on the QKV / MLP-in projections (out-features),
  row split on the output projections (in-features), the column biases
  with their columns, the LM head by vocab; norms, embeddings and every
  other leaf replicate.  Quantized leaves split by their PARENT name.
- ``dp``: batch rows (the trainer's and the runner's slices).

GSPMD lays the shards out and inserts the collectives for JAX; here
``shard_params`` gives each rank its own shard of each leaf, and the model
code calls the collectives:

- ``copy_to_tp``: identity forward, all-reduce backward, where a
  replicated activation enters a column-split projection (without it the
  ICV's gradient under tp would be a partial sum);
- ``reduce_from_tp``: all-reduce forward, identity backward, after a
  row-split projection;
- ``gather_from_tp``: the vocab-sharded head's logits made whole (an
  all-reduce of a zero-filled buffer into which each rank writes its
  slice), before argmax, the beam step and the masked KL;
- ``qdot_row``: a row-split projection's ``qdot`` and its sum over tp;
  under w8a8 each row is quantized with the whole row's absmax (an
  all-reduce of the local ones, as GSPMD reduces JAX's over the shards).

Every collective is an ``all_reduce`` or a ``broadcast``, so the same code
runs under NCCL and under gloo (two ranks on one card, the CPU tests).
Sums run in f32.  Three layouts differ from JAX's shards, where GSPMD would
reshard or pad:

- an int4 row-split leaf (``{"q4", "s"}`` under ``wo``/``w_down``/...) is
  re-packed per rank: JAX packs in-feature ``i`` and ``i + in/2`` into one
  byte, so a slice of ``q4`` along ``in/2`` holds two separate feature
  ranges while its scales and activation columns cover one; the rank's
  contiguous in-features are unpacked, sliced and packed again in the
  half-plane layout with their own group scales;
- the LM head's vocab is zero-padded to a tp multiple (GSPMD pads uneven
  shards: Idefics-9B's 32002 rows at tp = 4) and the padding is dropped
  from the gathered logits;
- every other sharded dim must divide by tp (head counts included: a rank
  computes whole heads); one that does not raises.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch

from ..core.mesh import AXIS_TP, Mesh, current_mesh
from ..ops import int8_matmul as I8
from ..ops.quantize import (
    _unpack_int4,
    is_any_quantized_leaf,
    is_quantized4_leaf,
    is_quantized_leaf,
)

# leaf-name → which axis of the kernel gets the tp shards (JAX's tables)
_COLUMN_SPLIT = {"wq", "wk", "wv", "w_gate", "w_up", "fc", "w1"}  # out-features
_ROW_SPLIT = {"wo", "w_down", "c_proj", "w2"}  # in-features
_COLUMN_BIAS = {"bq", "bk", "bv", "b1"}


def _leaf_spec(name: str, leaf: torch.Tensor) -> tuple:
    nd = leaf.ndim
    if name in _COLUMN_SPLIT and nd >= 2:
        return (None,) * (nd - 1) + (AXIS_TP,)
    if name in _ROW_SPLIT and nd >= 2:
        return (None,) * (nd - 2) + (AXIS_TP, None)
    if name in _COLUMN_BIAS and nd >= 1:
        return (None,) * (nd - 1) + (AXIS_TP,)
    if name == "lm_head" and nd == 2:  # (D, V): shard vocab
        return (None, AXIS_TP)
    return ()


def _quantized_specs(parent: str, leaf: dict) -> dict:
    """Specs for an int8 ``{"q","s"}`` / int4 ``{"q4","s"}`` weight leaf,
    keyed on the PARENT name (JAX ``_quantized_specs``).  Layouts: ``q``
    (…, in, out); int8 ``s`` (…, 1, out); int4 ``q4`` (…, in/2, out); int4
    ``s`` (…, in/G, 1, out)."""
    out = {}
    q_nd = leaf["q"].ndim if "q" in leaf else leaf["q4"].ndim
    for key, sub in leaf.items():
        nd = sub.ndim
        if parent == "lm_head" or parent in _COLUMN_SPLIT:
            # the head's per-output scales follow their columns, as every
            # column-split component does (out-features is the last dim)
            out[key] = (None,) * (nd - 1) + (AXIS_TP,)
        elif parent in _ROW_SPLIT:
            if key in ("q", "q4"):  # shard the contraction
                out[key] = (None,) * (nd - 2) + (AXIS_TP, None)
            elif key == "s" and nd >= 3 and sub.shape[-2] == 1 and nd == q_nd + 1:
                # int4 group scales follow the contraction split; int8
                # per-output scales (same rank as q) replicate
                out[key] = (None,) * (nd - 3) + (AXIS_TP, None, None)
            else:
                out[key] = ()
        else:
            out[key] = ()
    return out


def param_specs(params: Any, _name: str = "") -> Any:
    """The spec tree of a model param tree (JAX ``param_specs``): a tuple of
    axis names per leaf, quantized leaves a dict of their components'."""
    if is_any_quantized_leaf(params):
        return _quantized_specs(_name, params)
    if isinstance(params, dict):
        return {k: param_specs(v, k) for k, v in params.items()}
    return _leaf_spec(_name, params)


# ---------------------------------------------------------------------------
# Shards
# ---------------------------------------------------------------------------


def _chunk(x: torch.Tensor, dim: int, n: int, i: int, what: str) -> torch.Tensor:
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"{what}: dim {dim} of {tuple(x.shape)} does not divide by tp={n}")
    per = size // n
    return x.narrow(dim, i * per, per).contiguous()


def _pad_to(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` zero-padded along ``dim`` to a multiple of ``n``."""
    rem = (-x.shape[dim]) % n
    if rem == 0:
        return x
    shape = list(x.shape)
    shape[dim] = rem
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Signed int4 values ``(..., K, N)`` (int8) in the half-plane layout
    (``ops/quantize.py``): low nibble ``q[i] + 8``, high nibble
    ``q[i + K/2]`` in two's complement."""
    k2 = q.shape[-2] // 2
    lo = (q[..., :k2, :] + 8).to(torch.uint8)
    hi = q[..., k2:, :].to(torch.uint8) & 0xF
    return lo | (hi << 4)


def repack_int4_rows(leaf: dict, tp: int, rank: int) -> dict:
    """Rank ``rank``'s contiguous in-features ``[r·in/tp, (r+1)·in/tp)`` of
    an int4 leaf as an int4 leaf of its own: the nibbles unpacked, sliced
    and packed again in the half-plane layout, with the group scales of
    that slice.  The local in-features must be even and hold whole groups
    (or lie inside one group, which then gives the slice its one scale);
    the int4 kernel takes the leaf where ``(in/tp)/2 % G == 0``."""
    packed, s = leaf["q4"], leaf["s"]
    k = 2 * packed.shape[-2]
    kg = s.shape[-3]
    g = k // kg
    if k % tp or (k // tp) % 2:
        raise ValueError(f"int4 row shard: in-features {k} over tp={tp} is not an even split")
    kl = k // tp
    lo_f = rank * kl
    q = _unpack_int4(packed)[..., lo_f:lo_f + kl, :]
    if kl % g == 0:
        scales = s.narrow(-3, lo_f // g, kl // g)
    elif g % kl == 0:
        scales = s.narrow(-3, lo_f // g, 1)
    else:
        raise ValueError(f"int4 row shard: {kl} in-features a rank cut groups of {g}")
    return {"q4": _pack_int4(q).contiguous(), "s": scales.contiguous()}


def _shard_leaf(name: str, leaf, spec, tp: int, rank: int, what: str):
    if is_any_quantized_leaf(leaf):
        if name in _ROW_SPLIT and is_quantized4_leaf(leaf):
            return repack_int4_rows(leaf, tp, rank)
        return {k: _shard_leaf(name, v, spec[k], tp, rank, f"{what}.{k}")
                for k, v in leaf.items()}
    if AXIS_TP not in spec:
        return leaf
    dim = spec.index(AXIS_TP)
    if name == "lm_head":
        leaf = _pad_to(leaf, dim, tp)
    return _chunk(leaf, dim, tp, rank, what)


def shard_params(params: dict, mesh: Optional[Mesh]) -> dict:
    """Each leaf that ``param_specs`` shards over tp replaced, IN PLACE, by
    this rank's shard (a contiguous copy), so the full tree's memory goes
    as it is sharded; every other leaf stays as it is.  A mesh with tp = 1
    (or None) changes nothing.  Returns ``params``."""
    if mesh is None or mesh.tp == 1:
        return params
    specs = param_specs(params)

    def walk(tree: dict, spec: dict, path: str):
        for k in list(tree):
            v, sp = tree[k], spec[k]
            if isinstance(v, dict) and not is_any_quantized_leaf(v):
                walk(v, sp, f"{path}{k}.")
            else:
                tree[k] = _shard_leaf(k, v, sp, mesh.tp, mesh.tp_index, path + k)

    walk(params, specs, "")
    return params


# ---------------------------------------------------------------------------
# Collectives (all_reduce / broadcast only)
# ---------------------------------------------------------------------------


def tp_size() -> int:
    mesh = current_mesh()
    return 1 if mesh is None else mesh.tp


def tp_rank() -> int:
    mesh = current_mesh()
    return 0 if mesh is None else mesh.tp_index


def local_heads(n_heads: int) -> int:
    """Heads a rank computes: ``n_heads / tp`` (raises where tp does not
    divide them)."""
    tp = tp_size()
    if n_heads % tp:
        raise ValueError(f"{n_heads} heads do not divide over tp={tp}")
    return n_heads // tp


def tp_slice(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """This rank's contiguous ``1/tp`` of a replicated ``x`` along ``dim``
    (a view): the local heads' ALiBi slopes, the local heads of a
    replicated projection's output."""
    tp = tp_size()
    if tp == 1:
        return x
    n = x.shape[dim]
    if n % tp:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide by tp={tp}")
    per = n // tp
    return x.narrow(dim, tp_rank() * per, per)


def _all_reduce_f32(x: torch.Tensor, group, op=None) -> torch.Tensor:
    """An f32 copy of ``x`` reduced over ``group`` (``x`` is left as it is)."""
    import torch.distributed as dist

    y = x.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(y, op=op or dist.ReduceOp.SUM, group=group)
    return y


class _CopyToTP(torch.autograd.Function):
    """Identity forward, all-reduce (sum over tp) backward."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, current_mesh().tp_group).to(g.dtype)


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce (sum over tp) forward, identity backward."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce_f32(x, current_mesh().tp_group).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    """A replicated activation entering column-split projections."""
    if tp_size() == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToTP.apply(x)


def reduce_from_tp(x: torch.Tensor) -> torch.Tensor:
    """The sum over tp of a row-split projection's partial outputs, in f32
    (returned in ``x``'s dtype)."""
    if tp_size() == 1:
        return x
    return _ReduceFromTP.apply(x)


class _GatherFromTP(torch.autograd.Function):
    """Concatenation over tp along the last dim (a zero-filled buffer,
    each rank's slice written in, all-reduced); backward: this rank's
    slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x):
        mesh = current_mesh()
        n = x.shape[-1]
        buf = torch.zeros((*x.shape[:-1], n * mesh.tp), dtype=torch.float32, device=x.device)
        buf[..., mesh.tp_index * n:(mesh.tp_index + 1) * n] = x.float()
        import torch.distributed as dist

        dist.all_reduce(buf, group=mesh.tp_group)
        ctx.n = n
        return buf.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        i = current_mesh().tp_index
        return g[..., i * ctx.n:(i + 1) * ctx.n]


def gather_from_tp(x: torch.Tensor, full: int) -> torch.Tensor:
    """The vocab-sharded head's logits made whole: ``(..., full)``, the
    padding past ``full`` dropped."""
    if tp_size() == 1:
        return x
    return _GatherFromTP.apply(x)[..., :full]


def all_reduce_max_tp(x: torch.Tensor) -> torch.Tensor:
    """Element-wise max over tp (f32): the w8a8 row absmax of an activation
    whose columns are split."""
    import torch.distributed as dist

    if tp_size() == 1:
        return x
    return _all_reduce_f32(x, current_mesh().tp_group, dist.ReduceOp.MAX)


def _w8a8_whole_rows(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """w8a8 on this rank's in-features of a row-split int8 leaf: the rows
    quantized with the whole row's absmax, then the pre-quantized entry of
    ``csrc/w8a8_matmul.cu`` (its plain version on the CPU); the f32 partial
    product."""
    absmax = all_reduce_max_tp(torch.amax(torch.abs(x.float()), dim=-1, keepdim=True))
    xq, xs = I8.quantize_act_rows(x, absmax)
    return I8.w8a8_matmul_prequantized(xq, xs, q, s, torch.float32)


def qdot_row(x: torch.Tensor, w, preferred_element_type=None, a8: bool = False) -> torch.Tensor:
    """``qdot`` of a row-split (output) projection: ``wo``, ``w_down``,
    ``c_proj``, ``w2``.  Under tp ``x`` holds this rank's in-features and
    ``w`` their rows; the f32 partial products are summed over tp
    (``reduce_from_tp``) and returned in ``preferred_element_type`` or x's
    dtype.  w8a8 (``a8`` on an int8 leaf) quantizes each row with the whole
    row's absmax.  At tp = 1 it is ``qdot``."""
    if tp_size() == 1:
        return I8.qdot(x, w, preferred_element_type, a8)
    out_dtype = preferred_element_type or x.dtype
    if a8 and is_quantized_leaf(w):
        q, s = w["q"], w["s"]
        lead = x.shape[:-1]
        y = I8.frozen_weight_matmul(x.reshape(math.prod(lead), x.shape[-1]),
                                    lambda xv: _w8a8_whole_rows(xv, q, s),
                                    lambda: q.float() * s)
        y = y.reshape(*lead, q.shape[1])
    else:
        y = I8.qdot(x, w, preferred_element_type=torch.float32, a8=a8)
    return reduce_from_tp(y).to(out_dtype)


def dp_size() -> int:
    mesh = current_mesh()
    return 1 if mesh is None else mesh.dp


def all_reduce_dp(x: torch.Tensor) -> torch.Tensor:
    """Sum over dp (f32, no gradient): the loss denominators, the
    ``(icv, alpha)`` gradients, the logged losses."""
    if dp_size() == 1:
        return x
    return _all_reduce_f32(x.detach(), current_mesh().dp_group).to(x.dtype)


def sp_size() -> int:
    mesh = current_mesh()
    return 1 if mesh is None else mesh.sp


def all_reduce_grad(x: torch.Tensor) -> torch.Tensor:
    """Sum over dp × sp (f32, no gradient): the ``(icv, alpha)`` gradients,
    each sp rank's the part its chunk of tokens carries.  At sp = 1 it is
    ``all_reduce_dp``."""
    mesh = current_mesh()
    if mesh is None or mesh.dp * mesh.sp == 1:
        return x
    return _all_reduce_f32(x.detach(), mesh.grad_group).to(x.dtype)


def dp_row_slice(n_rows: int) -> slice:
    """This rank's contiguous rows of a global batch of ``n_rows`` (a dp
    multiple)."""
    mesh = current_mesh()
    if mesh is None or mesh.dp == 1:
        return slice(0, n_rows)
    if n_rows % mesh.dp:
        raise ValueError(f"{n_rows} rows do not split over dp={mesh.dp}")
    per = n_rows // mesh.dp
    return slice(mesh.dp_index * per, (mesh.dp_index + 1) * per)


def gather_rows_dp(x: torch.Tensor) -> torch.Tensor:
    """The dp ranks' row slices (equal shapes) concatenated in rank order
    on every rank (a zero-filled buffer, all-reduced)."""
    import torch.distributed as dist

    mesh = current_mesh()
    if mesh is None or mesh.dp == 1:
        return x
    per = x.shape[0]
    buf = torch.zeros((per * mesh.dp, *x.shape[1:]), dtype=torch.float64 if not
                      x.is_floating_point() else torch.float32, device=x.device)
    buf[mesh.dp_index * per:(mesh.dp_index + 1) * per] = x.to(buf.dtype)
    dist.all_reduce(buf, group=mesh.dp_group)
    return buf.to(x.dtype)
