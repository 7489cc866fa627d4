"""Ring attention over the ``sp`` mesh axis: sequence parallelism for the
train forwards (counterpart of ``licv_vqa_tpu/parallel/ring.py``).

Each sp rank holds the same batch rows and computes ``S/sp`` of their
tokens, its chunk ``s`` (``SeqRing.take``).  Attention keeps the rank's
query chunk resident while the key/value chunks travel round the ring:
the local chunk is absorbed first, then ``sp − 1`` times every rank sends
the chunk it holds to rank ``s + 1`` and receives the one of ``s − 1``
(``ring_shift``), and absorbs it with the online softmax in f32 (JAX's
``_ring_body``, ring.py:65-154).  Per-rank score memory is ``(B, H, S/sp,
S/sp)`` a step and K/V are never gathered.

Semantics are JAX's dense masked softmax with a causal-and-padding mask
from absolute positions: scale, then the optional tanh softcap, then the
optional ALiBi bias ``−slope·(q_pos − k_pos)``, then the mask ``k_pos <=
q_pos & k_valid``; a row with no visible key gives 0.  Both products read
the inputs' values and sum in f32 (the port's ``dot_product_attention``
upcasts its operands, which is the same arithmetic: a bf16 product is
exact in f32).  JAX rotates the positions and the key validity with the
chunks; here every rank holds them whole (``SeqRing.positions`` /
``valid``, computed from the whole rows before the split), so only K and
V travel, as their KV heads (GQA repeats them per block).  Under tp a rank
holds ``H/tp`` heads: the ring rotates only those, within its sp group,
with the ALiBi slopes of all heads sliced to the rank's.

The exchange is ``ring_shift``, an autograd Function: forward to ``s + 1``
(from ``s − 1``), backward the reverse shift, so autograd through the
absorb steps gives JAX's gradient (which differentiates ``scan`` and
``ppermute``).  The backend decides how the chunk moves: under NCCL one
``batch_isend_irecv`` pair on the device tensors; under gloo, whose
send/recv take CPU tensors only, through host copies of the chunk (two
ranks that share one card run this way; so do the CPU tests, where the
copies are none).  Another backend raises.

``gather_sequence`` makes the rank's post-norm hidden chunk whole again
(a zero-filled ``(B, S, D)`` buffer, the chunk written in, all-reduced over
sp): the head, ``return_hidden`` and the teacher's window see the whole
sequence.  Its backward is the rank's chunk of the gradient, so each sp
rank's ``(icv, alpha)`` gradient is the part its tokens carry and the sum
over dp × sp is the whole (``icv/module.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..core.mesh import current_mesh, mesh_rank


@dataclasses.dataclass(frozen=True)
class SeqRing:
    """A train forward's sequence split over sp: the whole rows' positions
    and key validity, this rank's chunk index and its sp group (the
    group's global ranks in sp order)."""

    positions: torch.Tensor  # (B, S) int, absolute
    valid: torch.Tensor  # (B, S) bool: 1 = real key
    sp: int
    index: int
    group: Any
    ranks: tuple

    @property
    def chunk(self) -> int:
        return self.positions.shape[1] // self.sp

    def block(self, x: torch.Tensor, src: int, dim: int = 1) -> torch.Tensor:
        """Chunk ``src`` of ``x`` along ``dim``."""
        return x.narrow(dim, src * self.chunk, self.chunk)

    def take(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's chunk of ``x`` along ``dim``."""
        return self.block(x, self.index, dim)

    @property
    def next_rank(self) -> int:
        return self.ranks[(self.index + 1) % self.sp]

    @property
    def prev_rank(self) -> int:
        return self.ranks[(self.index - 1) % self.sp]


def sequence_ring(positions: torch.Tensor, attention_mask: torch.Tensor) -> Optional[SeqRing]:
    """The current mesh's split of a no-cache forward's sequence, or None
    at sp = 1.  Raises where sp does not divide the sequence (the trainer
    pads it to an sp multiple, ``train/trainer.py::_pad_seq_to_multiple``)."""
    mesh = current_mesh()
    if mesh is None or mesh.sp == 1:
        return None
    s = positions.shape[1]
    if s % mesh.sp:
        raise ValueError(f"sequence parallelism needs S % sp == 0: S={s}, sp={mesh.sp} "
                         "(pad the sequence to an sp multiple)")
    if mesh.sp_group is None:
        raise RuntimeError(f"sp={mesh.sp} mesh without an sp process group")
    ranks = tuple(mesh_rank(mesh.dp_index, mesh.tp_index, i, mesh.tp, mesh.sp)
                  for i in range(mesh.sp))
    return SeqRing(positions, attention_mask.bool(), mesh.sp, mesh.sp_index, mesh.sp_group,
                   ranks)


def _exchange(x: torch.Tensor, send_to: int, recv_from: int, group) -> torch.Tensor:
    """``x`` sent to global rank ``send_to``; what ``recv_from`` sent back."""
    import torch.distributed as dist

    backend = dist.get_backend(group)
    x = x.contiguous()
    if backend == "nccl":
        out = torch.empty_like(x)
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, send_to, group),
                                       dist.P2POp(dist.irecv, out, recv_from, group)])
        for req in reqs:
            req.wait()
        return out
    if backend == "gloo":
        # gloo's send/recv take CPU tensors: a device chunk goes through host
        # copies (none for a CPU tensor)
        host = x.cpu()
        out = torch.empty_like(host)
        req = dist.isend(host, send_to, group)
        dist.recv(out, recv_from, group)
        req.wait()
        return out.to(x.device)
    raise RuntimeError(f"ring_shift: no exchange for the {backend!r} backend")


class _RingShift(torch.autograd.Function):
    """Forward: send to ``s + 1``, receive from ``s − 1``; backward: the
    reverse shift of the gradient."""

    @staticmethod
    def forward(ctx, x, ring: SeqRing):
        ctx.ring = ring
        return _exchange(x, ring.next_rank, ring.prev_rank, ring.group)

    @staticmethod
    def backward(ctx, g):
        ring = ctx.ring
        return _exchange(g, ring.prev_rank, ring.next_rank, ring.group), None


def ring_shift(x: torch.Tensor, ring: SeqRing) -> torch.Tensor:
    """The chunk of rank ``s − 1`` in the sp group, for this rank's ``x``."""
    return _RingShift.apply(x, ring)


def _absorb(o, m, l, qf, k_c, v_c, q_pos, k_pos, k_valid, scale, slopes, softcap):
    """Online-softmax update of ``(o, m, l)`` with one K/V chunk."""
    neg = torch.finfo(torch.float32).min
    n_rep = qf.shape[2] // k_c.shape[2]
    k_c = k_c.repeat_interleave(n_rep, dim=2) if n_rep > 1 else k_c
    v_c = v_c.repeat_interleave(n_rep, dim=2) if n_rep > 1 else v_c
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k_c.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    if slopes is not None:
        rel = (q_pos[:, :, None] - k_pos[:, None, :]).float()
        s = s - slopes[None, :, None, None] * rel[:, None, :, :]
    mask = ((k_pos[:, None, :] <= q_pos[:, :, None]) & k_valid[:, None, :])[:, None]
    s = s.masked_fill(~mask, neg)
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)
    # a row with every key masked gives exp(0) = 1 here: the mask kills it
    p = torch.exp(s - m_new[..., None]).masked_fill(~mask, 0.0)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v_c.dtype).float(), v_c.float())
    return o * corr.transpose(1, 2)[..., None] + pv, m_new, l_new


def ring_self_attention(
    q: torch.Tensor,  # (B, S/sp, h, Dh): this rank's chunk and heads
    k: torch.Tensor,  # (B, S/sp, kvh, Dh): the chunk's keys, KV heads
    v: torch.Tensor,
    ring: SeqRing,
    n_heads: int,  # heads over all tp ranks (the ALiBi slopes)
    alibi: bool = False,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Causal self-attention of this rank's query chunk against every
    chunk's keys, scaled by ``Dh ** -0.5``; returns ``(B, S/sp, h, Dh)`` in
    q's dtype."""
    b, c, h, dh = q.shape
    if c != ring.chunk:
        raise ValueError(f"ring_self_attention: chunk of {c} tokens, the ring's is {ring.chunk}")
    scale = dh ** -0.5
    slopes = None
    if alibi:
        from ..models.layers import local_alibi_slopes

        slopes = local_alibi_slopes(n_heads, q.device)
        if slopes.shape[0] != h:
            raise ValueError(f"ring_self_attention: {slopes.shape[0]} slopes for {h} heads")
    q_pos = ring.take(ring.positions)
    qf = q.float()
    o = torch.zeros((b, c, h, dh), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, c), torch.finfo(torch.float32).min, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, c), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for j in range(ring.sp):
        if j:  # rotate, then absorb: sp − 1 exchanges, the local chunk first
            kv = ring_shift(kv, ring)
        src = (ring.index - j) % ring.sp
        o, m, l = _absorb(o, m, l, qf, kv[0], kv[1], q_pos, ring.block(ring.positions, src),
                          ring.block(ring.valid, src), scale, slopes, logit_softcap)
    lt = l.transpose(1, 2)[..., None]
    out = torch.where(lt > 0, o / torch.clamp(lt, min=1e-30), torch.zeros_like(o))
    return out.to(q.dtype)


class _GatherSeq(torch.autograd.Function):
    """Concatenation over sp along the sequence (a zero-filled buffer, this
    rank's chunk written in, all-reduced: exact, each element is one
    rank's value plus zeros); backward: this rank's chunk of the
    gradient."""

    @staticmethod
    def forward(ctx, x, ring: SeqRing):
        import torch.distributed as dist

        ctx.ring = ring
        b, c = x.shape[:2]
        buf = torch.zeros((b, c * ring.sp, *x.shape[2:]), dtype=x.dtype, device=x.device)
        ring.take(buf).copy_(x)
        dist.all_reduce(buf, group=ring.group)
        return buf

    @staticmethod
    def backward(ctx, g):
        return ctx.ring.take(g).contiguous(), None


def gather_sequence(x: torch.Tensor, ring: Optional[SeqRing]) -> torch.Tensor:
    """This rank's ``(B, S/sp, ...)`` chunk made whole, ``(B, S, ...)`` on
    every sp rank; ``x`` itself without a ring."""
    if ring is None:
        return x
    return _GatherSeq.apply(x, ring)
