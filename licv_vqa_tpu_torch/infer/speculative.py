"""Self-speculative greedy decoding: a layer-skip draft and exact
verification (counterpart of ``licv_vqa_tpu/infer/speculative.py``).

A cheap DRAFT (the same network truncated to its first K layers,
``models.registry.build_draft_decode``) proposes ``gamma`` tokens one at a
time; the TARGET scores the whole block in one forward, and the longest
agreeing prefix is accepted with the target's own correction token after
it.  The output equals plain greedy decoding in exact arithmetic (the
target verifies every position).  In finite precision the verify forward
attends the same keys in another order than greedy's s=1 steps, so a
near-tie argmax could flip; the equality tests pin it at f32, and any flip
is between candidates the target scores equal to within rounding.  Draft
quality decides only how much target work each emitted token costs.

Acceptance is PER ROW by default: each row advances by its own accepted
count, through a ``(B,)`` cache index (``models.decoder.decode_cache_view``
takes a host int or a tensor).  ``lockstep=True`` advances the batch by
its minimum (the same outputs, more rounds on ragged batches); its index
is a 0-d tensor shared by every row.

Cache invariant at the top of every round: both caches hold K/V for
``prompt + out[0 .. n_out-2]``, i.e. ``index = S + n_out - 1`` per row, so
verification writes ``gamma`` rows and each row's index rolls back to
``index - gamma + n_emit``; rejected rows are overwritten later.

The loop: JAX runs a ``while_loop`` over ``any(n_out < max_new &
~finished)``.  Here the round count is that same condition read back to
the host once per round (one sync a round, never one a token): option (b)
of the two ways to drive it without a per-token sync.  A fixed count of
``max_new_tokens - 1`` rounds would never sync, but would run as many
rounds as greedy has steps, each ``gamma`` draft forwards and a verify,
whatever the draft accepts.  ``speculative_greedy_generate.forwards``
counts the target and draft forwards of every call (a host tally, for the
chip smoke's launch checks).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.decoder import _positions_from_mask


def speculative_greedy_generate(
    target_fwd: Callable,
    draft_fwd: Callable,
    input_ids: torch.Tensor,  # (B, S) LEFT-padded prompts
    attention_mask: torch.Tensor,
    max_new_tokens: int,
    eos_token_id: int,
    pad_token_id: int,
    gamma: int = 4,
    lockstep: bool = False,
) -> torch.Tensor:
    """Returns (B, S + max_new_tokens); equals ``greedy_generate`` token for
    token.  Both forwards follow ``greedy_generate``'s contract, and their
    caches need ``gamma`` columns past ``S + max_new_tokens`` (the verify
    writes a whole block past the last accepted token)."""
    if max_new_tokens <= 0:  # degenerate but accepted: prompt unchanged
        return input_ids
    b = input_ids.shape[0]
    dev = input_ids.device
    counts = _FORWARDS
    positions = _positions_from_mask(attention_mask)

    t_logits, t_cache = target_fwd(input_ids, attention_mask, positions, None)
    _, d_cache = draft_fwd(input_ids, attention_mask, positions, None)
    counts["target"] += 1
    counts["draft"] += 1
    # a device index from here on: per row, or one 0-d index in lockstep
    shape = () if lockstep else (b,)
    start = torch.full(shape, t_cache["index"], dtype=torch.long, device=dev)
    t_cache["index"] = start
    d_cache["index"] = start.clone()
    first = torch.argmax(t_logits[:, -1, :].float(), dim=-1).to(torch.int32)
    base_pos = positions[:, -1] + 1  # position of out[0], per row

    out = torch.full((b, max_new_tokens), pad_token_id, dtype=torch.int32, device=dev)
    out[:, 0] = first
    finished = first == eos_token_id
    n_out = torch.ones(shape, dtype=torch.long, device=dev)
    last_tok = first
    rows = torch.arange(b, device=dev)
    ones1 = torch.ones((b, 1), dtype=torch.int32, device=dev)
    steps = torch.arange(gamma, device=dev)

    while bool(((n_out < max_new_tokens) & ~finished).any()):  # one sync a round
        # ---- the draft proposes gamma tokens, one forward each -----------
        tok, drafts = last_tok, []
        for i in range(gamma):
            pos = (base_pos + n_out - 1 + i)[:, None]
            lg, d_cache = draft_fwd(tok[:, None], ones1, pos, d_cache)
            tok = torch.argmax(lg[:, -1, :].float(), dim=-1).to(torch.int32)
            drafts.append(tok)
        counts["draft"] += gamma
        drafts = torch.stack(drafts, dim=1)  # (B, gamma): drafts[:, i] follows block[:, i]

        # ---- the target verifies the block in one forward -----------------
        block = torch.cat([last_tok[:, None], drafts[:, :-1]], dim=1)
        pos = (base_pos + n_out - 1)[:, None] + steps[None, :]
        t_logits, t_cache = target_fwd(
            block, torch.ones((b, gamma), dtype=torch.int32, device=dev), pos, t_cache
        )
        counts["target"] += 1
        t_pred = torch.argmax(t_logits.float(), dim=-1).to(torch.int32)

        # each row's agreeing prefix
        prefix = torch.cumprod((t_pred == drafts).to(torch.long), dim=1)
        n_acc = torch.where(finished, gamma, prefix.sum(dim=1))
        a = n_acc.min() if lockstep else n_acc

        # emit a accepted drafts and, where a < gamma, the target's correction
        n_emit = torch.minimum(torch.where(a < gamma, a + 1, gamma), max_new_tokens - n_out)
        correction = t_pred[rows, torch.clamp(a, max=gamma - 1)]
        for i in range(gamma):
            tok = torch.where(i < a, drafts[:, i], correction)
            tok = torch.where(finished, pad_token_id, tok)
            write = (i < n_emit) & (n_out + i < max_new_tokens)
            col = torch.clamp(n_out + i, 0, max_new_tokens - 1).expand(b)
            out[rows, col] = torch.where(write, tok, out[rows, col])
            last_tok = torch.where(write & ~finished, tok, last_tok)
            finished = finished | (write & (tok == eos_token_id))

        # restore the cache invariant: index = S + (n_out + n_emit) - 1
        commit = t_cache["index"] - gamma + n_emit
        t_cache["index"] = commit
        d_cache["index"] = commit.clone()
        n_out = n_out + n_emit
    return torch.cat([input_ids, out.to(input_ids.dtype)], dim=1)


# target and draft forwards over every call (prefills included)
_FORWARDS = {"target": 0, "draft": 0}
speculative_greedy_generate.forwards = _FORWARDS
