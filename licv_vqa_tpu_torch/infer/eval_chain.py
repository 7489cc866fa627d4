"""The pooled beam eval chain of the reference's beam eval (counterpart of
``licv_vqa_tpu/infer/eval_chain.py``): bs=1 questions, beam-3,
``max_new_tokens=5`` (reference config/inference.yaml:11,26-30).  P =
max_new − 1 question groups of K beam rows each run staggered through one
merged forward per iteration, together with the next question's prefill
(``models/idefics.py::make_idefics_merged_admit_fn``), so one question
completes per forward where ``beam_generate`` takes max_new.  Idefics2's
chain (``make_idefics2_pooled_eval_chain``) and OpenFlamingo's
(``make_openflamingo_pooled_eval_chain``) run the same body on their own
serving and merged functions (Idefics2's media are empty; OpenFlamingo's
merged forward carries a per-lane ALiBi bias).

JAX's ``lax.scan`` becomes a Python loop here.  The pool's cache, media,
beam state and each iteration's best hypothesis stay in device tensors:
the host reads nothing inside a chain, and its caller reads the answers
once.  Per question the tokens are ``decode.beam_generate``'s (the same
``beam_transition`` and ``beam_finalize``, the same tail-only parent
gather; groups never share a row), held equal on the CPU in f32 by
``tests/test_torch_eval_chain.py``.  In bf16 on the card a packed matmul
may pick other tiles than the static batch's, so a near tie can flip, as
between two static batch sizes.

JAX's overlapped chain (``make_idefics_eval_chain``: one prefill packed
into each question's first beam step) is not ported: only JAX's bench
calls it, and the pooled chain gives the same tokens in fewer forwards
(ROADMAP Queue 1 item 14a).
"""

from __future__ import annotations

import torch

from ..models.decoder import init_kv_cache
from .decode import NEG_INF, _beam_gather_cache, _kv_leaves, beam_finalize, beam_transition
from .serving import _leaves, _map


def _first_beam(k: int, device) -> torch.Tensor:
    """(K,) f32 live scores of a fresh question: beam 0 at 0, the others at
    -inf (made on the device: writing a host scalar into one element is a
    synchronizing copy)."""
    return torch.where(torch.arange(k, device=device) == 0, 0.0, NEG_INF).float()


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.float(), dim=-1)


def _make_pooled_chain(
    text_cfg,
    prefill,
    merged,
    media_axes,
    *,
    num_beams: int,
    max_new_tokens: int,
    length_penalty: float,
    min_new_tokens: int,
    eos_token_id: int,
    pad_token_id: int = 0,
):
    """The family-generic body of the pooled chain (JAX eval_chain.py:217-442)
    over a family's serving ``prefill``, merged admission function and media
    axes ((batch axis, image axis) per key).

    P = max_new − 1 groups of K rows.  Iteration i, for group g = i mod P:
      - finalize g's question: the transition at t = max_new − 1 on its
        logits in hand (no forward) and HF's finalize;
      - re-admit g: the pending prefill (of the previous iteration's merged
        forward, or the prologue's) written over g's K rows, its beam state
        reset (beam 0 at score 0, the others at -inf);
      - one transition of all P groups, each at its own step
        (i − g') mod P (group g at 0, on the prefill's logits): the steps
        repeat with period P, so their P patterns are made on the device
        once and row i mod P is taken;
      - the pool's decoded tails permuted by beam parent;
      - ONE merged forward: the P·K decode rows and question i+1's prefill.

    N + P iterations: the first P outputs are warm-up groups (zeros and
    finite garbage, each in its own rows until its first admission) and
    dropped; the last P prefill wrapped questions whose outputs are
    dropped.  Question q is admitted at iteration q and answered at q + P."""
    if max_new_tokens < 2:
        raise ValueError("the pooled chain needs max_new_tokens >= 2")
    k = int(num_beams)
    p = max_new_tokens - 1  # groups in flight == decode forwards per question

    @torch.inference_mode()
    def chain(params, ids, mask, pixels, valid, icv):
        n, b, s = ids.shape
        if b != 1:
            raise ValueError("the eval chain decodes bs=1 questions")
        dev = ids.device
        rows = p * k
        cache_len = s + max_new_tokens + 1
        kw = dict(prompt_len=s, eos_token_id=eos_token_id, length_penalty=length_penalty,
                  min_new_tokens=min_new_tokens)

        # the prologue: question 0's prefill, the first pending admission
        pend = prefill(params, pixels[0], valid[0], ids[0], mask[0], icv, cache_len)
        vocab = pend[0].shape[-1]

        # the pool, zeros until each group's first admission
        cache = init_kv_cache(text_cfg, rows, cache_len, dev)
        cache["index"] = torch.zeros((rows,), dtype=torch.long, device=dev)

        def pool_zeros(x, ax):
            shape = list(x.shape)
            shape[ax] *= rows
            return x.new_zeros(shape)

        media = {key: _map(lambda x, ax=ax: pool_zeros(x, ax), pend[2][key])
                 for key, (ax, _) in media_axes.items()}
        live_s = torch.full((p, k), NEG_INF, dtype=torch.float32, device=dev)
        fin_s = live_s.clone()
        live_t = torch.full((p, k, max_new_tokens), pad_token_id, dtype=torch.int32, device=dev)
        fin_t = live_t.clone()
        last_logp = torch.zeros((p, k, vocab), dtype=torch.float32, device=dev)
        next_pos = torch.zeros((rows,), dtype=torch.int32, device=dev)
        live0 = _first_beam(k, dev)
        groups = torch.arange(p, device=dev)
        ages = torch.remainder(groups[:, None] - groups[None, :], p)  # [i mod P, group]
        parent_base = groups[:, None] * k
        step_mask = torch.ones((rows, 1), dtype=torch.int32, device=dev)

        bests = []
        for i in range(n + p):
            g, nxt = i % p, (i + 1) % n
            r0, r1 = g * k, (g + 1) * k

            # finalize group g
            fin = beam_transition(live_s[g:g + 1], live_t[g:g + 1], fin_s[g:g + 1],
                                  fin_t[g:g + 1], last_logp[g:g + 1], max_new_tokens - 1,
                                  **kw)[:4]
            bests.append(beam_finalize(*fin, prompt_len=s, max_new_tokens=max_new_tokens,
                                       length_penalty=length_penalty))

            # re-admit group g from the pending prefill, over its K rows
            last_pf, cache_pf, media_pf, pos_pf = pend
            live_s[g] = live0
            live_t[g] = pad_token_id
            fin_s[g] = NEG_INF
            fin_t[g] = pad_token_id
            last_logp[g] = _log_softmax(last_pf)
            for key in ("k", "v"):
                for big, sm in zip(_kv_leaves(cache[key]), _kv_leaves(cache_pf[key])):
                    big[:, r0:r1] = sm
            for key in ("pos", "valid"):
                cache[key][r0:r1] = cache_pf[key]
            cache["index"][r0:r1] = cache_pf["index"]
            for key, (ax, _) in media_axes.items():
                for big, sm in zip(_leaves(media[key]), _leaves(media_pf[key])):
                    big.narrow(ax, r0, k).copy_(sm)
            next_pos[r0:r1] = pos_pf

            # one transition of every group at its own step, then the tails
            live_s, live_t, fin_s, fin_t, new_beam, new_tok = beam_transition(
                live_s, live_t, fin_s, fin_t, last_logp, ages[g], **kw)
            _beam_gather_cache(cache, (parent_base + new_beam).reshape(rows), s)

            # ONE merged forward: P·K decode rows + question i+1's prefill
            logits, cache, *pend = merged(
                params, new_tok.reshape(rows, 1), step_mask, next_pos[:, None], cache, media,
                icv, pixels[nxt], valid[nxt], ids[nxt], mask[nxt], cache_len)
            last_logp = _log_softmax(logits[:, -1]).reshape(p, k, vocab)
            next_pos = next_pos + 1
        return torch.stack(bests[p:])  # (N, 1, max_new)

    return chain


def make_idefics_pooled_eval_chain(
    cfg,
    eos_token_id: int,
    *,
    num_beams: int = 3,
    max_new_tokens: int = 5,
    length_penalty: float = 0.0,
    min_new_tokens: int = 0,
    pad_token_id: int = 0,
):
    """The pooled chain for Idefics (JAX eval_chain.py:445-489)::

        chain(params, ids (N,1,S), mask (N,1,S), pixels (N,1,I,H,W,3),
              valid (N,1,I), icv) -> (N, 1, max_new) best-beam tokens

    Pixels are the model's normalised floats and the ICV its per-layer
    rows (``pooled_eval_chain`` takes a bundle's raw inputs).  Tokens past
    an EOS are ``pad_token_id``, as ``beam_generate`` leaves them."""
    from ..models.idefics import make_idefics_merged_admit_fn, make_idefics_serving_fns

    prefill, _, media_axes = make_idefics_serving_fns(cfg, eos_token_id)
    return _make_pooled_chain(
        cfg.text, prefill, make_idefics_merged_admit_fn(cfg, eos_token_id), media_axes,
        num_beams=num_beams, max_new_tokens=max_new_tokens, length_penalty=length_penalty,
        min_new_tokens=min_new_tokens, eos_token_id=eos_token_id, pad_token_id=pad_token_id,
    )


def make_idefics2_pooled_eval_chain(
    cfg,
    eos_token_id: int,
    *,
    num_beams: int = 3,
    max_new_tokens: int = 5,
    length_penalty: float = 0.0,
    min_new_tokens: int = 0,
    pad_token_id: int = 0,
):
    """The pooled chain for Idefics2 (JAX eval_chain.py:492-522), with the
    contract of ``make_idefics_pooled_eval_chain``.  The image latents merge
    into the prefill's embeddings, so the pool carries no media.  Uniform
    resolution only: the chain passes no ``pixel_attention_mask`` (NaViT
    inputs take the engines)."""
    from ..models.idefics2 import make_idefics2_merged_admit_fn, make_idefics2_serving_fns

    prefill, _, media_axes = make_idefics2_serving_fns(cfg, eos_token_id)
    return _make_pooled_chain(
        cfg.text, prefill, make_idefics2_merged_admit_fn(cfg, eos_token_id), media_axes,
        num_beams=num_beams, max_new_tokens=max_new_tokens, length_penalty=length_penalty,
        min_new_tokens=min_new_tokens, eos_token_id=eos_token_id, pad_token_id=pad_token_id,
    )


def make_openflamingo_pooled_eval_chain(
    cfg,
    eos_token_id: int,
    *,
    num_beams: int = 3,
    max_new_tokens: int = 5,
    length_penalty: float = 0.0,
    min_new_tokens: int = 0,
    pad_token_id: int = 0,
):
    """The pooled chain for OpenFlamingo (JAX eval_chain.py:525-554), with
    the contract of ``make_idefics_pooled_eval_chain``: the pool carries
    each group's media (latents, step one-hot, cross-attention K/V) as
    Idefics' does."""
    from ..models.openflamingo import (
        make_openflamingo_merged_admit_fn,
        make_openflamingo_serving_fns,
    )

    prefill, _, media_axes = make_openflamingo_serving_fns(cfg, eos_token_id)
    return _make_pooled_chain(
        cfg.text, prefill, make_openflamingo_merged_admit_fn(cfg, eos_token_id), media_axes,
        num_beams=num_beams, max_new_tokens=max_new_tokens, length_penalty=length_penalty,
        min_new_tokens=min_new_tokens, eos_token_id=eos_token_id, pad_token_id=pad_token_id,
    )


def pooled_eval_chain(bundle, generate_kwargs: dict):
    """The pooled chain of a ``ModelBundle`` at ``generate_kwargs``' beam
    settings::

        chain(ids (N,1,S), mask (N,1,S), pixels (N,1,I,H,W,3) as the
              processor emits them, valid (N,1,I), icv) -> (N, 1, max_new)

    The bundle's weights, its pixel normalisation and its ICV layout
    (``ModelBundle.model_pixels``/``model_icv``) are applied on the device
    before the loop; the family picks the chain."""
    from ..models.idefics import IdeficsConfig
    from ..models.idefics2 import Idefics2Config
    from ..models.openflamingo import OpenFlamingoConfig

    num_beams = int(generate_kwargs.get("num_beams", 1))
    max_new = int(generate_kwargs.get("max_new_tokens", 5))
    if num_beams < 2 or max_new < 2:
        raise ValueError("the pooled schedule needs num_beams >= 2 and max_new_tokens >= 2 "
                         "(greedy or 1-token workloads: use infer_engine=continuous)")
    cfg = bundle.model_cfg
    factory = {
        IdeficsConfig: make_idefics_pooled_eval_chain,
        Idefics2Config: make_idefics2_pooled_eval_chain,
        OpenFlamingoConfig: make_openflamingo_pooled_eval_chain,
    }[type(cfg)]
    chain = factory(
        cfg, bundle.eos_token_id, num_beams=num_beams, max_new_tokens=max_new,
        length_penalty=float(generate_kwargs.get("length_penalty", 0.0)),
        min_new_tokens=int(generate_kwargs.get("min_new_tokens", 0)),
        pad_token_id=bundle.pad_token_id,
    )

    def bundle_chain(ids, mask, pixels, valid, icv_scaled):
        return chain(bundle.params, ids, mask, bundle.model_pixels(pixels), valid,
                     bundle.model_icv(icv_scaled))

    return bundle_chain
