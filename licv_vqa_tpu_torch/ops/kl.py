"""Masked temperature-KL distillation loss with static shapes (counterpart of
``licv_vqa_tpu/ops/kl.py``).

Both answer masks select the same per-sample count of contiguous
answer+EOS positions: student positions start at ``query_x_length``,
teacher positions at ``in_context_length``.  So the teacher row for student
position ``t`` is ``t - query_x_length + in_context_length``: one gather,
then a weighted mean over the student mask (the reference's boolean masking,
icv_src/icv_module.py:107-148, without shape-dynamic tensors).

Over a dp-split batch the caller passes ``denom``, the GLOBAL batch's
weight count (JAX ``ops/kl.py:82-83``, ``:103`` divide by it): each rank's
value is then its share of the global mean, and the shares sum to it.  A
mean of per-rank means would be another loss wherever ranks hold different
numbers of answer tokens.
"""

from __future__ import annotations

import torch


def answer_region_mask(
    input_ids: torch.Tensor,  # (B, S) int
    lengths: torch.Tensor,  # (B,) int: prompt length before the answer region
    pad_token_id: int,
) -> torch.Tensor:
    """Positions with ``index >= length`` that are not padding (reference
    ``VQAICVModule.get_mask``, icv_src/icv_module.py:136-148)."""
    s = input_ids.shape[1]
    idx = torch.arange(s, device=input_ids.device)[None, :]
    return (idx >= lengths.to(input_ids.device)[:, None]) & (input_ids != pad_token_id)


def aligned_teacher_gather(
    teacher_logits: torch.Tensor,  # (B, S_tea, V), or hidden (B, S_tea, D)
    in_context_length: torch.Tensor,  # (B,)
    query_x_length: torch.Tensor,  # (B,)
    student_seq_len: int,
) -> torch.Tensor:
    """Teacher rows aligned to the student positions: (B, S_stu, V)."""
    s_tea = teacher_logits.shape[1]
    dev = teacher_logits.device
    t = torch.arange(student_seq_len, device=dev)[None, :]
    pos = t - query_x_length.to(dev).long()[:, None] + in_context_length.to(dev).long()[:, None]
    pos = torch.clamp(pos, 0, s_tea - 1)
    idx = pos[:, :, None].expand(-1, -1, teacher_logits.shape[2])
    return torch.gather(teacher_logits, 1, idx)


def masked_kl_divergence(
    student_logits: torch.Tensor,  # (B, S, V) aligned
    teacher_logits: torch.Tensor,  # (B, S, V) aligned (gather above)
    mask: torch.Tensor,  # (B, S) bool: student answer-region mask
    temperature,
    eps: float = 1e-6,
    impl: str = "xla",  # "xla" | "pallas"
    denom=None,  # the global Σmask over a dp-split batch (module docstring)
) -> torch.Tensor:
    """``mean_masked[ Σ_V p_tea (log(p_tea+ε) − log(p_stu+ε)) ] · T²`` in f32.

    ``impl="xla"`` is the plain formulation (JAX's jnp path and default);
    ``impl="pallas"`` is the fused kernel of ``masked_kl_kernel`` (its plain
    version for CPU tensors)."""
    t = torch.as_tensor(temperature, dtype=torch.float32, device=student_logits.device)
    stu = student_logits.float() / t
    tea = teacher_logits.float() / t
    if impl == "pallas":
        from .masked_kl_kernel import masked_kl_pallas

        return masked_kl_pallas(stu, tea, mask, eps=eps, denom=denom) * (t * t)
    if impl != "xla":
        raise ValueError(f"masked_kl_divergence: impl must be xla or pallas, got {impl!r}")
    p_stu = torch.softmax(stu, dim=-1)
    p_tea = torch.softmax(tea, dim=-1)
    per_pos = torch.sum(p_tea * (torch.log(p_tea + eps) - torch.log(p_stu + eps)), dim=-1)
    w = mask.float()
    denom = torch.clamp(torch.sum(w) if denom is None else denom, min=1.0)
    return (torch.sum(per_pos * w) / denom) * (t * t)


def shifted_cross_entropy(
    logits: torch.Tensor,  # (B, S, V)
    labels: torch.Tensor,  # (B, S) int; ignore_index = ignore
    ignore_index: int = -100,
    denom=None,  # the global count of positions not ignored (dp)
) -> torch.Tensor:
    """HF-convention causal LM loss: ``logits[:, :-1]`` vs ``labels[:, 1:]``,
    mean over the positions not ignored."""
    lg = logits[:, :-1, :].float()
    lb = labels[:, 1:]
    valid = lb != ignore_index
    lb_safe = torch.where(valid, lb, torch.zeros_like(lb)).long()
    logp = torch.log_softmax(lg, dim=-1)
    nll = -torch.gather(logp, -1, lb_safe[:, :, None])[:, :, 0]
    w = valid.float()
    return torch.sum(nll * w) / torch.clamp(torch.sum(w) if denom is None else denom, min=1.0)
