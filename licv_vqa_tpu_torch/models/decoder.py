"""Causal decoder layer with the ICV injection and a KV cache (counterpart
of ``licv_vqa_tpu/models/decoder.py``): LLaMA's rope / RMSNorm / SwiGLU
branch and MPT's ALiBi / bias-free LayerNorm / GELU branch (OpenFlamingo).
The ALiBi bias reaches the layer as a (B, H, s, Sk) f32 tensor from the
caller; a prefill of at least 128 tokens into an empty cache on the card
takes ``ops.flash_alibi.flash_alibi_attention`` instead, which makes the
bias inside the kernel.

Layer params are layer-stacked ``(L, ...)`` leaves as in JAX; the multimodal
wrapper (``idefics.py``) loops over the layers in Python and hands each layer
its slice.

The KV cache is updated IN PLACE.  JAX's layer does not write the cache: it
attends (old cache with the incoming columns masked out) ∥ (this step's local
keys) with a split softmax and returns the new rows, which the caller
bulk-writes after the layer scan (``decoder.py:224-336``).  The port writes
each layer's new rows into its cache first (``apply_kv_rows``) and then
attends the written prefix.  The two are equal in exact arithmetic: the
masked-out incoming columns hold exactly the local keys.

With the int8 cache (``kv_cache_dtype="int8"``, ``{"q", "s"}`` leaves) the
layer writes the quantized rows and, as JAX does, attends the earlier rows
as their int8 planes with the per-(token, head) scales applied to the f32
scores and to the probabilities (``_int8_cached_attention``), and this
step's own keys and values as their int8 round trip in the compute dtype
(``decoder.py:399-402``).  Projections go through
``ops.int8_matmul.qdot``, so weights may be quantized leaves; blocks of at
least ``W8A8_MIN_TOKENS`` tokens take w8a8 under ``cfg.w8a8_prefill``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.flash_alibi import flash_alibi_attention, flash_alibi_usable
from ..ops.icv_inject import add_icv_inject, icv_inject, icv_inject_after_add
from ..ops.int8_matmul import qdot
from ..ops.quantize import dequantize_kv, quantize_kv_rows
from . import layers as L
from .config import BLOCK_OUTPUT, MLP_OUTPUT, DecoderConfig

# w8a8 (``cfg.w8a8_prefill``) applies only to blocks of at least this many
# tokens (JAX decoder.py:33): prefill and bind matmuls; decode steps (s=1)
# keep the weight-only routes
W8A8_MIN_TOKENS = 16

# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def init_layer_params(
    generator: torch.Generator, cfg: DecoderConfig, n_layers: int, device
) -> dict:
    """Stacked decoder-layer params with leading dim ``n_layers``."""
    d, dh = cfg.d_model, cfg.head_dim
    h, kv, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff

    def w(*shape):
        return L.dense_init(generator, (n_layers, *shape), cfg.dtype, device)

    def ones(*shape):
        return torch.ones((n_layers, *shape), dtype=cfg.dtype, device=device)

    p = {
        "attn": {
            "wq": w(d, h * dh),
            "wk": w(d, kv * dh),
            "wv": w(d, kv * dh),
            "wo": w(h * dh, d),
        },
        "ln1": ones(d),
        "ln2": ones(d),
    }
    if cfg.activation == "silu_glu":
        p["mlp"] = {"w_gate": w(d, f), "w_up": w(d, f), "w_down": w(f, d)}
    else:
        # MPT: a two-matrix GELU MLP and no ln1_b/ln2_b, as JAX (the real
        # checkpoints are bias-free; the layer still reads a converted bias)
        p["mlp"] = {"w_up": w(d, f), "w_down": w(f, d)}
    return p


def init_decoder_params(generator: torch.Generator, cfg: DecoderConfig, device) -> dict:
    """Embedding, stacked layers, final norm and (untied) head, as JAX's
    ``init_decoder_params`` (decoder.py:77-88)."""
    params = {
        "embed": L.dense_init(generator, (cfg.vocab_size, cfg.d_model), cfg.dtype, device),
        "layers": init_layer_params(generator, cfg, cfg.n_layers, device),
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(
            generator, (cfg.d_model, cfg.vocab_size), cfg.dtype, device
        )
    return params


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: DecoderConfig, batch: int, max_len: int, device) -> dict:
    """``cfg.dtype`` cache, or with ``kv_cache_dtype="int8"`` ``{"q": int8,
    "s": f32 (..., 1)}`` leaves (one scale per token and head).  ``index``
    (the next column to write) is a host int: decode advances all rows in
    lockstep, and keeping it on the host means the loop never reads a
    device value back."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)

    def kv():
        if cfg.kv_cache_dtype == "int8":
            return {
                "q": torch.zeros(shape, dtype=torch.int8, device=device),
                "s": torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=device),
            }
        return torch.zeros(shape, dtype=cfg.dtype, device=device)

    return {
        "k": kv(),
        "v": kv(),
        "pos": torch.zeros((batch, max_len), dtype=torch.int32, device=device),
        "valid": torch.zeros((batch, max_len), dtype=torch.bool, device=device),
        "index": 0,
    }


def decode_cache_view(
    cache: dict, positions: torch.Tensor, attention_mask: torch.Tensor, s: int
):
    """Bookkeeping for decoding ``s`` new tokens against a cache: writes the
    new columns' positions and validity into ``cache["pos"]`` /
    ``cache["valid"]`` in place at ``cache["index"]`` and returns
    ``(mask (B,1,s,S), cache_pos, cache_valid)``."""
    index = cache["index"]
    max_len = cache["pos"].shape[1]
    if index + s > max_len:
        raise ValueError(f"KV cache overflow: {index}+{s} > {max_len}")
    cache_pos, cache_valid = cache["pos"], cache["valid"]
    cache_pos[:, index : index + s] = positions.to(torch.int32)
    cache_valid[:, index : index + s] = attention_mask.to(torch.bool)
    written = torch.arange(max_len, device=cache_pos.device) < (index + s)
    mask = (
        (cache_pos[:, None, :] <= positions[:, :, None])
        & cache_valid[:, None, :]
        & written[None, None, :]
    )[:, None, :, :]
    return mask, cache_pos, cache_valid


def apply_kv_rows(k_cache_l, v_cache_l, k_rows, v_rows, index: int) -> None:
    """Write one layer's new K/V rows (B, s, KV, Dh) into its cache (B, S,
    KV, Dh) in place at ``index`` (JAX bulk-writes all layers after the
    scan, ``decoder.py:170``); int8 caches take ``{"q", "s"}`` rows."""
    for cache_l, rows in ((k_cache_l, k_rows), (v_cache_l, v_rows)):
        if isinstance(cache_l, dict):
            for key in ("q", "s"):
                cache_l[key][:, index : index + rows[key].shape[1]] = rows[key]
        else:
            cache_l[:, index : index + rows.shape[1]] = rows


def _cached_attention(
    q: torch.Tensor,  # (B, s, H, Dh)
    k_cache_l: torch.Tensor,  # (B, S, KV, Dh), rows [0, end) written
    v_cache_l: torch.Tensor,
    mask: torch.Tensor,  # (B, 1, s, S) from decode_cache_view
    end: int,
    logit_softcap=None,
    bias: Optional[torch.Tensor] = None,  # (B, H, s, S) ALiBi over cache columns
) -> torch.Tensor:
    """Attention over the written cache prefix ``[0, end)``.  Columns past
    ``end`` are masked in JAX's full-width mask, so dropping them (and their
    bias) changes nothing but the work."""
    n_rep = q.shape[2] // k_cache_l.shape[2]
    return L.dot_product_attention(
        q,
        L.repeat_kv(k_cache_l[:, :end], n_rep),
        L.repeat_kv(v_cache_l[:, :end], n_rep),
        bias=None if bias is None else bias[..., :end],
        mask=mask[..., :end],
        logit_softcap=logit_softcap,
    )


def _int8_cached_attention(
    q: torch.Tensor,  # (B, s, H, Dh)
    k_cache_l: dict,  # int8 {"q", "s"} leaves, rows [0, index) from earlier steps
    v_cache_l: dict,
    k_local: torch.Tensor,  # (B, s, KV, Dh): this step's int8 round trip
    v_local: torch.Tensor,
    mask: torch.Tensor,  # (B, 1, s, S) from decode_cache_view
    index: int,
    logit_softcap=None,
) -> torch.Tensor:
    """JAX's split softmax over (earlier rows ∥ this step's rows) for the
    int8 cache (``decoder.py:201-330``): the earlier rows stay int8 planes
    and their per-(token, head) f32 scales multiply the f32 scores (K) and
    the probabilities before they are rounded to the compute dtype (V)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    n_rep = q.shape[2] // k_local.shape[2]

    def plane(c):
        return L.repeat_kv(c["q"][:, :index], n_rep).float()

    def col_scale(c):  # (B, index, KV, 1) -> (B, H, 1, index)
        return L.repeat_kv(c["s"][:, :index], n_rep)[..., 0].transpose(1, 2)[:, :, None, :]

    qf = q.float()
    scores = torch.cat([
        torch.einsum("bqhd,bkhd->bhqk", qf, plane(k_cache_l)) * scale * col_scale(k_cache_l),
        torch.einsum("bqhd,bkhd->bhqk", qf, L.repeat_kv(k_local, n_rep).float()) * scale,
    ], dim=-1)
    if logit_softcap:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    scores = scores.masked_fill(~mask[..., : index + q.shape[1]], torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    p_cache = (probs[..., :index] * col_scale(v_cache_l)).to(q.dtype).float()
    p_local = probs[..., index:].to(v_local.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", p_cache, plane(v_cache_l)) + torch.einsum(
        "bhqk,bkhd->bqhd", p_local, L.repeat_kv(v_local, n_rep).float()
    )
    return out.to(q.dtype)


def _norm(cfg: DecoderConfig, w, b, x):
    """RMSNorm, or LayerNorm with an optional bias (MPT's are bias-free)."""
    if cfg.norm_type == "rmsnorm":
        return L.rms_norm(w, x, cfg.norm_eps)
    return L.layer_norm(w, b, x, cfg.norm_eps)


def decoder_layer(
    cfg: DecoderConfig,
    p: dict,  # one layer's params (no leading L)
    h: torch.Tensor,  # (B, s, D)
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask: Optional[torch.Tensor],  # (B, 1, s, Sk) bool
    icv_row,  # (D,) scaled ICV row, a (row, flag) pair, or None
    kv_write: Optional[tuple] = None,  # (k_cache_l, v_cache_l, index)
    flash_valid: Optional[torch.Tensor] = None,  # (B, s): enables the flash path
    bias: Optional[torch.Tensor] = None,  # (B, H, s, Sk) f32 ALiBi bias
) -> torch.Tensor:
    """One pre-norm layer, LLaMA's or MPT's (``cfg.positional``).  With
    ``kv_write`` the new K/V rows go into the cache in place (see the module
    docstring).  ``flash_valid`` is passed only for self-contained blocks (a
    prefill into an EMPTY cache, or the no-cache train forward), so the
    flash kernels attend the local keys and ignore the cache mask.  ALiBi
    layers take ``bias`` over the same key columns as ``mask``; it may be
    None only where the ALiBi flash branch is taken."""
    b, s, d = h.shape
    nh, nkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    # a token-count gate: prefill and bind blocks run w8a8, decode steps
    # keep the weight-only routes
    a8 = cfg.w8a8_prefill and s >= W8A8_MIN_TOKENS

    x = _norm(cfg, p["ln1"], p.get("ln1_b"), h)
    q = qdot(x, p["attn"]["wq"], a8=a8).reshape(b, s, nh, dh)
    k = qdot(x, p["attn"]["wk"], a8=a8).reshape(b, s, nkv, dh)
    v = qdot(x, p["attn"]["wv"], a8=a8).reshape(b, s, nkv, dh)
    alibi = cfg.positional == "alibi"
    if not alibi:
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
    if "q_norm" in p["attn"]:  # idefics qk_layer_norms: per-head-dim RMSNorm
        q = L.rms_norm(p["attn"]["q_norm"], q, cfg.norm_eps)
        k = L.rms_norm(p["attn"]["k_norm"], k, cfg.norm_eps)

    k_local, v_local = k, v
    if kv_write is not None:
        k_cache, v_cache, index = kv_write
        if isinstance(k_cache, dict):  # int8 cache: write the quantized rows
            kq, ks = quantize_kv_rows(k)
            vq, vs = quantize_kv_rows(v)
            apply_kv_rows(k_cache, v_cache, {"q": kq, "s": ks}, {"q": vq, "s": vs}, index)
            # this step attends the round trip that later steps read back
            k_local = dequantize_kv(kq, ks, h.dtype)
            v_local = dequantize_kv(vq, vs, h.dtype)
        else:
            apply_kv_rows(k_cache, v_cache, k, v, index)
    self_contained = flash_valid is not None and cfg.attn_logit_softcap is None
    use_flash = (
        self_contained and not alibi and L.flash_attention_usable(cfg, s, dh, h.device)
    )
    # ALiBi depends on index differences only, so left-padded prefill rows
    # are fine: q_idx - k_idx equals q_pos - k_pos for every real token
    use_flash_alibi = self_contained and alibi and flash_alibi_usable(cfg, s, dh, h.device)
    if alibi and bias is None and not use_flash_alibi:
        raise ValueError("decoder_layer: an ALiBi layer off the flash branch needs its bias")
    if use_flash:
        attn = L.flash_attention(
            q, L.repeat_kv(k_local, nh // nkv), L.repeat_kv(v_local, nh // nkv), flash_valid
        )
    elif use_flash_alibi:
        attn = flash_alibi_attention(
            q, L.repeat_kv(k_local, nh // nkv), L.repeat_kv(v_local, nh // nkv), flash_valid,
            L.alibi_slopes(nh, h.device), float(dh) ** -0.5,
        )
    elif kv_write is not None and isinstance(k_cache, dict):
        attn = _int8_cached_attention(
            q, k_cache, v_cache, k_local, v_local, mask, index, cfg.attn_logit_softcap
        )
    elif kv_write is not None:
        attn = _cached_attention(
            q, k_cache, v_cache, mask, index + s, cfg.attn_logit_softcap, bias
        )
    else:
        attn = L.dot_product_attention(
            q, L.repeat_kv(k, nh // nkv), L.repeat_kv(v, nh // nkv),
            bias=bias, mask=mask, logit_softcap=cfg.attn_logit_softcap,
        )
    h = h + qdot(attn.reshape(b, s, nh * dh), p["attn"]["wo"], a8=a8).to(h.dtype)

    x2 = _norm(cfg, p["ln2"], p.get("ln2_b"), h)
    mlp = (L.swiglu_mlp(p["mlp"], x2, a8=a8) if cfg.activation == "silu_glu"
           else L.gelu_mlp(p["mlp"], x2, a8=a8))
    return _add_mlp(h, mlp, icv_row, cfg.injection_site)


def _add_mlp(h: torch.Tensor, mlp: torch.Tensor, icv_row, site: str) -> torch.Tensor:
    """The residual add of the MLP output, with the ICV injected at ``site``
    (into the sum at BLOCK_OUTPUT, into ``mlp`` at MLP_OUTPUT).  ``icv_row``
    is None, a (D,) row (inject at every layer) or a ``(row, flag)`` pair
    for subset-layer intervention (reference ``intervention_layer``
    semantics, icv_intervention.py:39-42).  ``flag`` is a HOST bool: an off
    layer is the plain add, and the host never reads a device value back.
    On the card the add and the injection are one kernel launch; on the CPU
    they are the add and ``icv_inject`` in that order."""
    row, flag = icv_row if isinstance(icv_row, tuple) else (icv_row, icv_row is not None)
    if not flag or site not in (MLP_OUTPUT, BLOCK_OUTPUT):
        return h + mlp
    if h.device.type == "cpu":
        return icv_inject(h + mlp, row) if site == BLOCK_OUTPUT else h + icv_inject(mlp, row)
    if site == BLOCK_OUTPUT:
        return icv_inject_after_add(h, mlp, row)
    return add_icv_inject(h, mlp, row)


def alibi_bias_for(cfg: DecoderConfig, positions: torch.Tensor, cache: Optional[dict],
                   flash_valid: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The (B, H, s, Sk) ALiBi bias of one forward: over the cache's columns
    (``cache["pos"]``, after ``decode_cache_view`` wrote this block's) or
    over the block itself.  None where every layer takes the ALiBi flash
    branch (a self-contained block the gate passes), which makes the bias
    in the kernel: the plain path's f32 bias is 537 MB a forward at 2048
    tokens and 32 heads."""
    s = positions.shape[1]
    if (flash_valid is not None and cfg.attn_logit_softcap is None
            and flash_alibi_usable(cfg, s, cfg.head_dim, positions.device)):
        return None
    k_pos = cache["pos"] if cache is not None else positions
    return L.alibi_bias(cfg.n_heads, positions, k_pos)


def _positions_from_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """HF convention: position_ids = cumsum(mask)-1, clipped at 0."""
    pos = torch.cumsum(attention_mask.to(torch.int32), dim=-1, dtype=torch.int32) - 1
    return torch.clamp(pos, min=0)


def logits_from_hidden(cfg: DecoderConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    """Hidden → vocab logits (f32).  ``params["lm_head"]`` may be an int8
    leaf (``lmm.quantize_head``); tied embeddings keep the bf16 table."""
    if cfg.tie_embeddings:
        return (h @ params["embed"].T).float()
    return qdot(h, params["lm_head"], preferred_element_type=torch.float32)


def _icv_row(icv, li: int):
    """Layer ``li``'s ICV argument: a row, a ``(row, host flag)`` pair, or
    None."""
    if icv is None:
        return None
    if isinstance(icv, tuple):
        return icv[0][li], icv[1][li]
    return icv[li]


def cast_icv(icv_scaled, dtype):
    """ICV rows in the model's compute dtype, as JAX casts the floating
    leaves; subset-layer flags stay host bools."""
    if icv_scaled is None:
        return None
    if isinstance(icv_scaled, tuple):
        rows, flags = icv_scaled
        return rows.to(dtype), list(flags)
    return icv_scaled.to(dtype)


def forward_hidden(
    cfg: DecoderConfig,
    params: dict,
    inputs_embeds: torch.Tensor,  # (B, S, D)
    attention_mask: torch.Tensor,  # (B, S) 1 = real token
    icv_scaled=None,  # (L, D) rows, ((L, D) rows, [L] host flags), or None
    cache: Optional[dict] = None,
    positions: Optional[torch.Tensor] = None,
    remat: bool = False,
    prefill_flash: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, Optional[dict]]:
    """The stacked decoder (JAX ``forward_hidden``, decoder.py:728-820);
    returns ``(post-norm hidden (B, S, D), cache or None)``.

    Without a cache: the causal mask from ``attention_mask``, which also
    gates the flash branch (a self-contained block); ``remat`` checkpoints
    each layer for the backward (``jax.checkpoint(body)``, :795-796), when
    autograd is recording.  With one: this block's K/V are written into it
    in place at ``cache["index"]``, and ``prefill_flash`` (the attention
    mask) marks a prefill into an EMPTY cache, which enables the flash
    kernel."""
    icv = cast_icv(icv_scaled, cfg.dtype)
    h = inputs_embeds
    s = h.shape[1]
    if cache is None:
        if positions is None:
            positions = _positions_from_mask(attention_mask)
        mask = L.causal_mask(positions, positions, attention_mask.bool())
        flash_valid, index = attention_mask, None
    else:
        if positions is None:
            raise ValueError("positions required when decoding with a cache")
        index = cache["index"]
        mask, _, _ = decode_cache_view(cache, positions, attention_mask, s)
        flash_valid = prefill_flash
    cos = sin = bias = None
    if cfg.positional == "rope":
        cos, sin = L.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    else:
        bias = alibi_bias_for(cfg, positions, cache, flash_valid)
    remat = remat and cache is None and torch.is_grad_enabled()
    for li in range(cfg.n_layers):
        p_l = L.layer_slice(params["layers"], li)
        kv_write = None
        if cache is not None:
            kv_write = (L.layer_slice(cache["k"], li), L.layer_slice(cache["v"], li), index)

        def layer_fn(hh, icv_arg, p_l=p_l, kv_write=kv_write):
            return decoder_layer(
                cfg, p_l, hh, cos, sin, mask, icv_arg, kv_write=kv_write,
                flash_valid=flash_valid, bias=bias,
            )

        icv_arg = _icv_row(icv, li)
        if remat:
            h = checkpoint(layer_fn, h, icv_arg, use_reentrant=False)
        else:
            h = layer_fn(h, icv_arg)
    if cache is not None:
        cache["index"] = index + s
    return _norm(cfg, params["final_norm"], params.get("final_norm_b"), h), cache


def causal_lm_forward(
    cfg: DecoderConfig,
    params: dict,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    icv_scaled=None,
    cache: Optional[dict] = None,
    positions: Optional[torch.Tensor] = None,
    remat: bool = False,
    prefill_flash: Optional[torch.Tensor] = None,
    return_hidden: bool = False,
):
    """Text-only causal LM (JAX decoder.py:841-870): returns ``(logits f32
    (B, S, V), cache)``, or the post-norm hidden in place of the logits."""
    ids = torch.clamp(input_ids, 0, params["embed"].shape[0] - 1).long()
    h, cache = forward_hidden(
        cfg, params, params["embed"][ids].to(cfg.dtype), attention_mask,
        icv_scaled=icv_scaled, cache=cache, positions=positions, remat=remat,
        prefill_flash=prefill_flash,
    )
    if return_hidden:
        return h, cache
    return logits_from_hidden(cfg, params, h), cache
