"""Perceiver resampler: N image patches → ``n_latents`` latents
(counterpart of ``licv_vqa_tpu/models/perceiver.py``).

Matches HF ``IdeficsPerceiverResampler``: learned latents; per-block
cross-attention whose keys/values are the CONCAT of context and latents;
optional per-head-dim LayerNorm on q/k; LN→fc→ReLU→proj MLP; final
LayerNorm.

Under tp a block computes its rank's heads (``wq``/``wk``/``wv`` columns,
``wo`` rows) and columns of the MLP (``fc`` columns, ``c_proj`` rows), each
row-split product summed over tp.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.int8_matmul import qdot
from ..parallel.sharding import copy_to_tp, qdot_row
from . import layers as L
from .config import PerceiverConfig
from .decoder import W8A8_MIN_TOKENS


def init_perceiver_params(
    generator: torch.Generator, cfg: PerceiverConfig, qk_layer_norms: bool, device
) -> dict:
    d, hd, nh, f, n = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.d_ff, cfg.n_layers
    dt = cfg.dtype

    def w(*shape):
        return L.dense_init(generator, shape, dt, device)

    def ln(*shape):
        return {
            "w": torch.ones(shape, dtype=dt, device=device),
            "b": torch.zeros(shape, dtype=dt, device=device),
        }

    blocks = {
        "ctx_ln": ln(n, d),
        "lat_ln": ln(n, d),
        "wq": w(n, d, nh * hd),
        "wk": w(n, d, nh * hd),
        "wv": w(n, d, nh * hd),
        "wo": w(n, nh * hd, d),
        "mlp_ln": ln(n, d),
        "fc": w(n, d, f),
        "c_proj": w(n, f, d),
    }
    if qk_layer_norms:
        blocks["q_ln"] = ln(n, hd)
        blocks["k_ln"] = ln(n, hd)
    return {"latents": w(cfg.n_latents, d), "blocks": blocks, "final_ln": ln(d)}


def perceiver_forward(
    cfg: PerceiverConfig, params: dict, context: torch.Tensor, a8: bool = False
) -> torch.Tensor:
    """context: (B, N_patches, D) → (B, n_latents, D).  ``a8``: w8a8 for
    int8-quantized blocks, gated on each side's token count as in JAX."""
    b = context.shape[0]
    hd = cfg.head_dim
    latents = (
        params["latents"][None]
        .expand(b, cfg.n_latents, context.shape[-1])
        .to(context.dtype)
    )
    a8_lat = a8 and cfg.n_latents >= W8A8_MIN_TOKENS
    a8_kv = a8 and cfg.n_latents + context.shape[1] >= W8A8_MIN_TOKENS
    for i in range(cfg.n_layers):
        p = L.layer_slice(params["blocks"], i)
        ctx = L.layer_norm(p["ctx_ln"]["w"], p["ctx_ln"]["b"], context, cfg.norm_eps)
        lat = L.layer_norm(p["lat_ln"]["w"], p["lat_ln"]["b"], latents, cfg.norm_eps)
        kv_in = copy_to_tp(torch.cat([ctx, lat], dim=1))
        lat = copy_to_tp(lat)
        nl, nk = lat.shape[1], kv_in.shape[1]
        q = qdot(lat, p["wq"], a8=a8_lat).reshape(b, nl, -1, hd)
        k = qdot(kv_in, p["wk"], a8=a8_kv).reshape(b, nk, -1, hd)
        v = qdot(kv_in, p["wv"], a8=a8_kv).reshape(b, nk, -1, hd)
        if "q_ln" in p:
            q = L.layer_norm(p["q_ln"]["w"], p["q_ln"]["b"], q, cfg.norm_eps)
            k = L.layer_norm(p["k_ln"]["w"], p["k_ln"]["b"], k, cfg.norm_eps)
        attn = L.dot_product_attention(q, k, v)
        latents = latents + qdot_row(
            attn.reshape(b, nl, -1), p["wo"], a8=a8_lat
        ).to(latents.dtype)
        x = copy_to_tp(L.layer_norm(p["mlp_ln"]["w"], p["mlp_ln"]["b"], latents, cfg.norm_eps))
        x = qdot(x, p["fc"], a8=a8_lat)
        if cfg.activation == "gelu":  # open_flamingo FeedForward (exact erf)
            x = F.gelu(x.float(), approximate="none").to(latents.dtype)
        else:  # HF IdeficsPerceiverResampler MLP
            x = F.relu(x)
        latents = latents + qdot_row(x, p["c_proj"], a8=a8_lat).to(latents.dtype)
    return L.layer_norm(
        params["final_ln"]["w"], params["final_ln"]["b"], latents, cfg.norm_eps
    )
