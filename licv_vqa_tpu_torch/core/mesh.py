"""The process mesh: one process per rank, the world's process groups per
axis (counterpart of ``licv_vqa_tpu/core/mesh.py``).

JAX runs one process over N devices and lets GSPMD insert the collectives;
the port runs N processes (``python -m torch.distributed.run``), one per
rank, and calls the collectives itself (``parallel/sharding.py``).  The
axes and their order are JAX's:

- ``dp``: data parallel (batch rows);
- ``tp``: tensor parallel (Megatron column / row shards of the frozen
  weights, one all-reduce per projection pair);
- ``sp``: sequence parallel (the train forwards' ring attention,
  ``parallel/ring.py``): each sp rank computes its ``S/sp`` tokens of the
  same batch rows.

The dp×tp×sp layout keeps JAX's device order (``create_mesh`` reshapes the
device list to ``(dp, tp, sp)``): sp varies fastest, then tp, so rank
``r = (d·tp + t)·sp + s`` (at sp = 1, ``r = d·tp + t``).
``current_mesh()`` is the mesh the model code reads (the tp group of the
projections, the sp group of the ring and the hidden-state gather, the dp
group of the loss, the gradient group of the ``(icv, alpha)`` sums);
``using_mesh`` sets it for a run (the CLIs, ``Trainer.fit``) and
``set_current_mesh`` for good (the tests' ranks); ``None`` means one
process and no collectives.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Optional

AXIS_DP = "dp"
AXIS_TP = "tp"
AXIS_SP = "sp"
MESH_AXES = (AXIS_DP, AXIS_TP, AXIS_SP)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape. ``-1`` on one axis absorbs remaining devices."""

    dp: int = -1
    tp: int = 1
    sp: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int]:
        sizes = [self.dp, self.tp, self.sp]
        if sizes.count(-1) > 1:
            raise ValueError("at most one mesh axis may be -1")
        known = math.prod(s for s in sizes if s != -1)
        if -1 in sizes:
            if n_devices % known:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes {known}")
            sizes[sizes.index(-1)] = n_devices // known
        if math.prod(sizes) != n_devices:
            raise ValueError(f"mesh {tuple(sizes)} != {n_devices} devices")
        return tuple(sizes)  # type: ignore[return-value]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a dp×tp×sp mesh and the process groups it
    joins: ``tp_group`` (the ranks that share its batch rows and tokens and
    split its weights), ``sp_group`` (the ranks that share its rows and
    weight shard and split the tokens: the ring and the hidden-state
    gather), ``dp_group`` (the ranks that hold its weight shard and tokens
    and split the batch: the loss's denominators) and ``grad_group`` (the
    ranks that hold its weight shard: dp × sp, the ``(icv, alpha)``
    gradient sums).  A group of one rank is ``None``: its collectives are
    no-ops."""

    dp: int
    tp: int
    rank: int
    dp_index: int
    tp_index: int
    tp_group: Any = None
    dp_group: Any = None
    sp: int = 1
    sp_index: int = 0
    sp_group: Any = None
    grad_group: Any = None

    @property
    def world_size(self) -> int:
        return self.dp * self.tp * self.sp


def mesh_rank(d: int, t: int, s: int, tp: int, sp: int) -> int:
    """The rank at mesh coordinates ``(d, t, s)``: JAX's device order."""
    return (d * tp + t) * sp + s


def rank_coords(rank: int, dp: int, tp: int, sp: int = 1) -> tuple[int, int, int]:
    """``(dp_index, tp_index, sp_index)`` of ``rank`` in JAX's device order
    (sp fastest, then tp)."""
    if not 0 <= rank < dp * tp * sp:
        raise ValueError(f"rank {rank} outside a {dp}x{tp}x{sp} mesh")
    return rank // (tp * sp), (rank // sp) % tp, rank % sp


def group_members(dp: int, tp: int, sp: int) -> dict:
    """Every process group of a dp×tp×sp mesh as lists of global ranks, in
    the order ``create_mesh`` creates them: ``tp`` (one a (dp, sp) index),
    ``dp`` (one a (tp, sp) index), and at sp > 1 ``sp`` (one a (dp, tp)
    index) and ``grad`` (one a tp index: its dp × sp ranks)."""
    out = {
        "tp": [[mesh_rank(d, t, s, tp, sp) for t in range(tp)]
               for d in range(dp) for s in range(sp)],
        "dp": [[mesh_rank(d, t, s, tp, sp) for d in range(dp)]
               for t in range(tp) for s in range(sp)],
    }
    if sp > 1:
        out["sp"] = [[mesh_rank(d, t, s, tp, sp) for s in range(sp)]
                     for d in range(dp) for t in range(tp)]
        out["grad"] = [[mesh_rank(d, t, s, tp, sp) for d in range(dp) for s in range(sp)]
                       for t in range(tp)]
    return out


def create_mesh(config: Optional[MeshConfig] = None, world_size: Optional[int] = None,
                rank: Optional[int] = None) -> Mesh:
    """The mesh of ``config`` over the default process group's ranks (or
    ``world_size``/``rank`` given: one process and no groups, which needs a
    world of one).  Every rank must call it in the same order: it creates
    the groups with ``torch.distributed.new_group``, which is collective."""
    import torch.distributed as dist

    config = config or MeshConfig()
    initialized = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if initialized else 1
    if rank is None:
        rank = dist.get_rank() if initialized else 0
    dp, tp, sp = config.resolve(world_size)
    if world_size > 1 and not initialized:
        raise RuntimeError(
            f"a mesh of {world_size} ranks needs an initialised torch.distributed "
            "default group (core.distributed.maybe_initialize_distributed)")
    if initialized and dist.get_world_size() != world_size:
        raise ValueError(f"mesh of {world_size} ranks in a world of {dist.get_world_size()}")
    d, t, s = rank_coords(rank, dp, tp, sp)
    groups = {"tp": None, "dp": None, "sp": None, "grad": None}
    if world_size > 1:
        # new_group is collective over the whole world: every rank creates
        # every group, in one order
        for name, member_lists in group_members(dp, tp, sp).items():
            for members in member_lists:
                g = dist.new_group(members) if len(members) > 1 else None
                if rank in members:
                    groups[name] = g
        if sp == 1:
            groups["grad"] = groups["dp"]
    return Mesh(dp=dp, tp=tp, rank=rank, dp_index=d, tp_index=t, tp_group=groups["tp"],
                dp_group=groups["dp"], sp=sp, sp_index=s, sp_group=groups["sp"],
                grad_group=groups["grad"])


_current: Optional[Mesh] = None


def set_current_mesh(mesh: Optional[Mesh]) -> None:
    """Make ``mesh`` the one the model code and the loss read (None: one
    process, no collectives)."""
    global _current
    _current = mesh


def current_mesh() -> Optional[Mesh]:
    return _current


@contextlib.contextmanager
def using_mesh(mesh: Optional[Mesh]):
    """``mesh`` the current one inside the block; the one before it after."""
    prev = current_mesh()
    set_current_mesh(mesh)
    try:
        yield mesh
    finally:
        set_current_mesh(prev)
