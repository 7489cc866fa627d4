"""Greedy and beam search with a KV cache (counterpart of
``licv_vqa_tpu/infer/decode.py``).

JAX runs each decode as one ``lax.scan``; here it is a Python loop over
steps, every step one ``forward_fn`` call with no value read back to the
host (the loop bounds, the cache index and the beam bookkeeping shapes are
all host-static).  The bookkeeping is the JAX package's, token for token:

- beam search reproduces HF semantics at the reference's settings
  (``num_beams=3, length_penalty=0.0, min_new_tokens=0``): top-2K candidate
  expansion, EOS candidates retired to a finished pool, live beams merged
  into the pool at the end, best-by-score wins, all ``max_new_tokens`` steps
  run (see the JAX module docstring for why that is score-equivalent);
- every top-k keeps ``lax.top_k``'s tie order, lower index first, through
  a stable descending sort (``torch.topk`` promises no order among ties).

``forward_fn(input_ids, attention_mask, positions, cache) -> (logits,
cache)`` is the only model contract; the image latents and the ICV are
bound by the caller.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.decoder import _positions_from_mask

NEG_INF = -1.0e7


def _topk(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last dim: values descending, ties broken by
    the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ---------------------------------------------------------------------------
# Greedy
# ---------------------------------------------------------------------------


def greedy_generate(
    forward_fn: Callable,
    input_ids: torch.Tensor,  # (B, S) LEFT-padded prompts
    attention_mask: torch.Tensor,  # (B, S)
    max_new_tokens: int,
    eos_token_id: int,
    pad_token_id: int,
    min_new_tokens: int = 0,
) -> torch.Tensor:
    """Returns (B, S + max_new_tokens) sequences (prompt + generated)."""
    if max_new_tokens <= 0:
        return input_ids
    b = input_ids.shape[0]
    positions = _positions_from_mask(attention_mask)
    logits, cache = forward_fn(input_ids, attention_mask, positions, None)
    last_logits = logits[:, -1, :].float()
    next_pos = positions[:, -1] + 1
    finished = torch.zeros((b,), dtype=torch.bool, device=input_ids.device)
    step_mask = torch.ones((b, 1), dtype=torch.int32, device=input_ids.device)

    def emit(last_logits, finished, t):
        lg = last_logits
        if t < min_new_tokens:
            lg = lg.clone()
            lg[:, eos_token_id] = NEG_INF
        token = torch.argmax(lg, dim=-1).to(torch.int32)
        token = torch.where(finished, torch.full_like(token, pad_token_id), token)
        return token, finished | (token == eos_token_id)

    tokens = []
    # token t comes from step t-1's logits, so the LAST token needs no forward
    for t in range(max_new_tokens - 1):
        token, finished = emit(last_logits, finished, t)
        tokens.append(token)
        logits, cache = forward_fn(token[:, None], step_mask, next_pos[:, None], cache)
        last_logits = logits[:, -1, :].float()
        next_pos = next_pos + 1
    final_tok, _ = emit(last_logits, finished, max_new_tokens - 1)
    tokens.append(final_tok)
    return torch.cat([input_ids, torch.stack(tokens, dim=1).to(input_ids.dtype)], dim=1)


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------


def _kv_leaves(x) -> list:
    """The tensors of one K or V cache: itself, or an int8 cache's q and s."""
    return [x["q"], x["s"]] if isinstance(x, dict) else [x]


def _cache_map_batch(cache, fn: Callable):
    """Apply fn(leaf, batch_axis) to every batched cache leaf (the int8
    cache's ``{"q", "s"}`` leaves included)."""
    if cache is None:
        return None
    out = dict(cache)
    for key in cache:
        if key in ("k", "v"):  # (L, B, ...)
            x = cache[key]
            out[key] = (
                {name: fn(leaf, 1) for name, leaf in x.items()} if isinstance(x, dict) else fn(x, 1)
            )
        elif key != "index":
            out[key] = fn(cache[key], 0)  # (B, ...)
    return out


def _beam_gather_cache(cache: dict, flat_sel: torch.Tensor, prompt_len: int) -> dict:
    """Reorder the KV cache by beam parent, touching only rows that can
    differ across beams, in place.

    Beams start as identical copies of one prefill and decode only writes
    rows at index >= prompt_len, so rows [0, prompt_len) are identical across
    the K beams of a batch item and the parent gather is the identity there:
    only the decoded tail is gathered (~max_new rows instead of the whole
    cache)."""
    for key in ("k", "v"):
        for x in _kv_leaves(cache[key]):  # (L, B·K, S, KV, Dh|1)
            x[:, :, prompt_len:] = x[:, flat_sel, prompt_len:]
    for key in ("pos", "valid"):
        x = cache[key]  # (B·K, S)
        x[:, prompt_len:] = x[flat_sel, prompt_len:]
    return cache


def _topk_2k_two_stage(cand: torch.Tensor, b: int, k: int, vocab: int):
    """Global top-2K candidate selection as per-beam top-2K + a (B, K·2K)
    combine — exact vs one flat top-k over (B, K·V), tie order included
    (both stages prefer the lower (beam, vocab) index, which is the flat
    index order).  Returns ``(scores, src_beam, token)`` each (B, 2K)."""
    s1, i1 = _topk(cand.reshape(b * k, vocab), 2 * k)  # per beam
    s1 = s1.reshape(b, k * 2 * k)
    i1 = i1.reshape(b, k * 2 * k)
    top_scores, sel = _topk(s1, 2 * k)  # (B, 2K) over K*2K entries
    src_beam = torch.div(sel, 2 * k, rounding_mode="floor")
    token = torch.gather(i1, 1, sel).to(torch.int32)
    return top_scores, src_beam, token


def _f32(x, device) -> torch.Tensor:
    """A 0-d f32 tensor made on ``device`` (a fill, no copy from the host)."""
    return torch.full((), float(x), dtype=torch.float32, device=device)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx[:, :, None], axis=1)`` for (B, N, T) x."""
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[-1]))


def beam_transition(
    live_scores, live_tokens, fin_scores, fin_tokens, last_logp, t,
    *, prompt_len: int, eos_token_id: int, length_penalty: float,
    min_new_tokens: int,
):
    """One beam-search transition from the current step's logprobs: update
    the finished pool and select the K live continuations (no forward).
    ``t``, the step, is a host int, or a (B,) int tensor of each batch
    item's own step (the pooled eval chain's groups, ``infer/eval_chain.py``),
    which the host never reads."""
    b, k = live_scores.shape
    vocab = last_logp.shape[-1]
    dev = live_scores.device
    per_row = isinstance(t, torch.Tensor)
    logp = last_logp
    if per_row and min_new_tokens > 0:
        logp = logp.clone()
        logp[..., eos_token_id] = torch.where((t < min_new_tokens)[:, None], NEG_INF,
                                              logp[..., eos_token_id])
    elif not per_row and t < min_new_tokens:
        logp = logp.clone()
        logp[..., eos_token_id] = NEG_INF
    cand = live_scores[:, :, None] + logp  # (B, K, V)
    top_scores, src_beam, token = _topk_2k_two_stage(cand, b, k, vocab)
    is_eos = token == eos_token_id

    # candidate histories: the parent's history + the new token at slot t
    cand_hist = _take_rows(live_tokens, src_beam)  # (B, 2K, T)
    if per_row:
        cols = torch.arange(cand_hist.shape[-1], device=dev)
        cand_hist = torch.where(cols[None, None, :] == t[:, None, None], token[:, :, None],
                                cand_hist)
    else:
        cand_hist[:, :, t] = token  # gather made a new tensor

    # finished pool: EOS candidates ranked < K compete for K slots, scored
    # with HF's length penalty over the FULL (padded prompt + generated)
    # length, an f32 power made on the device (no host-to-device copy)
    if per_row:
        lp_div = (prompt_len + t + 1).float()[:, None] ** length_penalty
    else:
        lp_div = _f32(prompt_len + t + 1, dev) ** length_penalty
    rank_ok = torch.arange(2 * k, device=token.device)[None, :] < k
    neg = torch.full_like(top_scores, NEG_INF)
    eos_scores = torch.where(is_eos & rank_ok, top_scores / lp_div, neg)
    pool_scores = torch.cat([fin_scores, eos_scores], dim=1)  # (B, 3K)
    pool_tokens = torch.cat([fin_tokens, cand_hist], dim=1)
    fin_scores, best_idx = _topk(pool_scores, k)
    fin_tokens = _take_rows(pool_tokens, best_idx)

    # the top-K non-EOS candidates become the new live beams
    live_cand = torch.where(is_eos, neg, top_scores)
    new_scores, sel = _topk(live_cand, k)
    new_beam = torch.gather(src_beam, 1, sel)
    new_token = torch.gather(token, 1, sel)
    live_tokens = _take_rows(cand_hist, sel)
    return new_scores, live_tokens, fin_scores, fin_tokens, new_beam, new_token


def beam_finalize(
    live_scores, live_tokens, fin_scores, fin_tokens,
    *, prompt_len: int, max_new_tokens: int, length_penalty: float,
):
    """HF finalize: merge live beams into the pool, pick the best hypothesis
    per batch item — (B, max_new) tokens."""
    lp_div = _f32(prompt_len + max_new_tokens, live_scores.device) ** length_penalty
    live_final = live_scores / lp_div
    all_scores = torch.cat([fin_scores, live_final], dim=1)
    all_tokens = torch.cat([fin_tokens, live_tokens], dim=1)
    best = torch.argmax(all_scores, dim=1)
    return _take_rows(all_tokens, best[:, None])[:, 0]


def beam_generate(
    forward_fn: Callable,
    input_ids: torch.Tensor,  # (B, S) LEFT-padded prompts
    attention_mask: torch.Tensor,
    max_new_tokens: int,
    eos_token_id: int,
    pad_token_id: int,
    num_beams: int = 3,
    length_penalty: float = 0.0,
    min_new_tokens: int = 0,
) -> torch.Tensor:
    """Returns the best beam per batch item: (B, S + max_new_tokens)."""
    if max_new_tokens <= 0:
        return input_ids
    b, s = input_ids.shape
    k = num_beams
    dev = input_ids.device
    positions = _positions_from_mask(attention_mask)

    # prefill once per batch item, then replicate the state across beams
    logits, cache = forward_fn(input_ids, attention_mask, positions, None)
    last_logp = torch.log_softmax(logits[:, -1, :].float(), dim=-1)
    vocab = last_logp.shape[-1]
    cache = _cache_map_batch(cache, lambda x, axis: torch.repeat_interleave(x, k, dim=axis))
    next_pos = torch.repeat_interleave(positions[:, -1] + 1, k)  # (B*K,)

    live_scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    live_scores[:, 0] = 0.0  # force beam 0 first
    live_tokens = torch.full((b, k, max_new_tokens), pad_token_id, dtype=torch.int32, device=dev)
    fin_scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    fin_tokens = live_tokens.clone()
    last_logp = last_logp[:, None, :].expand(b, k, vocab)
    step_mask = torch.ones((b * k, 1), dtype=torch.int32, device=dev)
    batch_base = torch.arange(b, device=dev)[:, None] * k

    def transition(t):
        return beam_transition(
            live_scores, live_tokens, fin_scores, fin_tokens, last_logp, t,
            prompt_len=s, eos_token_id=eos_token_id,
            length_penalty=length_penalty, min_new_tokens=min_new_tokens,
        )

    for t in range(max_new_tokens - 1):
        live_scores, live_tokens, fin_scores, fin_tokens, new_beam, new_token = transition(t)
        # beam-major flat index b*K + beam; only the decoded tail can differ
        cache = _beam_gather_cache(cache, (batch_base + new_beam).reshape(-1), s)
        logits, cache = forward_fn(
            new_token.reshape(b * k, 1), step_mask, next_pos[:, None], cache
        )
        last_logp = torch.log_softmax(logits[:, -1, :].float(), dim=-1).reshape(b, k, vocab)
        next_pos = next_pos + 1
    # the LAST transition needs no cache gather or forward
    live_scores, live_tokens, fin_scores, fin_tokens, _, _ = transition(max_new_tokens - 1)
    best = beam_finalize(
        live_scores, live_tokens, fin_scores, fin_tokens,
        prompt_len=s, max_new_tokens=max_new_tokens, length_penalty=length_penalty,
    )
    return torch.cat([input_ids, best.to(input_ids.dtype)], dim=1)
