"""Causal LLaMA decoder layer with the ICV injection and a KV cache
(counterpart of ``licv_vqa_tpu/models/decoder.py``, rope path only).

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
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.icv_inject import icv_inject
from . import layers as L
from .config import BLOCK_OUTPUT, MLP_OUTPUT, DecoderConfig

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

    return {
        "attn": {
            "wq": w(d, h * dh),
            "wk": w(d, kv * dh),
            "wv": w(d, kv * dh),
            "wo": w(h * dh, d),
        },
        "ln1": ones(d),
        "ln2": ones(d),
        "mlp": {"w_gate": w(d, f), "w_up": w(d, f), "w_down": w(f, d)},
    }


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: DecoderConfig, batch: int, max_len: int, device) -> dict:
    """bf16 (``cfg.dtype``) cache.  ``index`` (the next column to write) is a
    host int: decode advances all rows in lockstep, and keeping it on the host
    means the loop never reads a device value back."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
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


def apply_kv_rows(
    k_cache_l: torch.Tensor,  # (B, S, KV, Dh): one layer's cache
    v_cache_l: torch.Tensor,
    k_rows: torch.Tensor,  # (B, s, KV, Dh): this step's rows
    v_rows: torch.Tensor,
    index: int,
) -> None:
    """Write one layer's new K/V rows into its cache in place at ``index``
    (JAX bulk-writes all layers after the scan, ``decoder.py:170``)."""
    s = k_rows.shape[1]
    k_cache_l[:, index : index + s] = k_rows
    v_cache_l[:, index : index + s] = v_rows


def _cached_attention(
    q: torch.Tensor,  # (B, s, H, Dh)
    k_cache_l: torch.Tensor,  # (B, S, KV, Dh), rows [0, end) written
    v_cache_l: torch.Tensor,
    mask: torch.Tensor,  # (B, 1, s, S) from decode_cache_view
    end: int,
    logit_softcap=None,
) -> torch.Tensor:
    """Attention over the written cache prefix ``[0, end)``.  Columns past
    ``end`` are masked in JAX's full-width mask, so dropping them changes
    nothing but the work."""
    n_rep = q.shape[2] // k_cache_l.shape[2]
    return L.dot_product_attention(
        q,
        L.repeat_kv(k_cache_l[:, :end], n_rep),
        L.repeat_kv(v_cache_l[:, :end], n_rep),
        mask=mask[..., :end],
        logit_softcap=logit_softcap,
    )


def _norm(cfg: DecoderConfig, w, x):
    return L.rms_norm(w, x, cfg.norm_eps)


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
) -> torch.Tensor:
    """One pre-norm LLaMA layer.  With ``kv_write`` the new K/V rows go into
    the cache in place (see the module docstring).  ``flash_valid`` is passed
    only for self-contained blocks (a prefill into an EMPTY cache), so the
    flash kernel attends the local keys and ignores the cache mask."""
    b, s, d = h.shape
    nh, nkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    x = _norm(cfg, p["ln1"], h)
    q = (x @ p["attn"]["wq"]).reshape(b, s, nh, dh)
    k = (x @ p["attn"]["wk"]).reshape(b, s, nkv, dh)
    v = (x @ p["attn"]["wv"]).reshape(b, s, nkv, dh)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    if "q_norm" in p["attn"]:  # idefics qk_layer_norms: per-head-dim RMSNorm
        q = L.rms_norm(p["attn"]["q_norm"], q, cfg.norm_eps)
        k = L.rms_norm(p["attn"]["k_norm"], k, cfg.norm_eps)

    if kv_write is not None:
        k_cache, v_cache, index = kv_write
        apply_kv_rows(k_cache, v_cache, k, v, index)
    use_flash = (
        flash_valid is not None
        and cfg.attn_logit_softcap is None
        and L.flash_attention_usable(cfg, s, dh, h.device)
    )
    if use_flash:
        attn = L.flash_attention(
            q, L.repeat_kv(k, nh // nkv), L.repeat_kv(v, nh // nkv), flash_valid
        )
    elif kv_write is not None:
        attn = _cached_attention(
            q, k_cache, v_cache, mask, index + s, cfg.attn_logit_softcap
        )
    else:
        attn = L.dot_product_attention(
            q, L.repeat_kv(k, nh // nkv), L.repeat_kv(v, nh // nkv),
            mask=mask, logit_softcap=cfg.attn_logit_softcap,
        )
    h = h + (attn.reshape(b, s, nh * dh) @ p["attn"]["wo"]).to(h.dtype)

    mlp = L.swiglu_mlp(p["mlp"], _norm(cfg, p["ln2"], h))
    if icv_row is not None and cfg.injection_site == MLP_OUTPUT:
        mlp = _apply_icv(mlp, icv_row)
    h = h + mlp
    if icv_row is not None and cfg.injection_site == BLOCK_OUTPUT:
        h = _apply_icv(h, icv_row)
    return h


def _apply_icv(x: torch.Tensor, icv_row) -> torch.Tensor:
    """``icv_row`` is a (D,) row (inject at every layer) or a ``(row, flag)``
    pair for subset-layer intervention (reference ``intervention_layer``
    semantics, icv_intervention.py:39-42).  ``flag`` is a HOST bool: an off
    layer skips the launch, and the host never reads a device value back."""
    if isinstance(icv_row, tuple):
        row, flag = icv_row
        return icv_inject(x, row) if flag else x
    return icv_inject(x, icv_row)


def _positions_from_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """HF convention: position_ids = cumsum(mask)-1, clipped at 0."""
    pos = torch.cumsum(attention_mask.to(torch.int32), dim=-1, dtype=torch.int32) - 1
    return torch.clamp(pos, min=0)


def logits_from_hidden(cfg: DecoderConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    """Hidden → vocab logits (f32)."""
    if cfg.tie_embeddings:
        return (h @ params["embed"].T).float()
    return (h @ params["lm_head"]).float()
