"""CLIP-style ViT vision tower, Idefics-9B's OpenCLIP ViT-H/14
(counterpart of ``licv_vqa_tpu/models/vision.py``).

Patchify is a reshape plus one matmul (a stride == kernel convolution is
exactly that).  Pre-LN encoder, biased projections, GELU MLP, as HF
``IdeficsVisionTransformer``.  Returns ``last_hidden_state`` (no post
layernorm), which the perceiver consumes.  Attention is the plain
``dot_product_attention`` (JAX's default branch at ViT-H's s=257); the
NaViT tower and the opt-in ``vit_attention`` / ``flash_bidir`` kernels are
not ported here (ROADMAP Queue 2).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.int8_matmul import qdot
from . import layers as L
from .config import VisionConfig
from .decoder import W8A8_MIN_TOKENS


def init_vision_params(generator: torch.Generator, cfg: VisionConfig, device) -> dict:
    d, f, p, n = cfg.d_model, cfg.d_ff, cfg.patch_size, cfg.n_layers
    dt = cfg.dtype

    def w(*shape):
        return L.dense_init(generator, shape, dt, device)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    def ln(*lead):
        return {"w": ones(*lead, d), "b": zeros(*lead, d)}

    params = {
        "patch_embed": w(p * p * 3, d),
        "pos_embed": w(cfg.n_patches, d),
        "post_ln": ln(),
        "layers": {
            "ln1": ln(n),
            "ln2": ln(n),
            "attn": {
                "wq": w(n, d, d), "bq": zeros(n, d),
                "wk": w(n, d, d), "bk": zeros(n, d),
                "wv": w(n, d, d), "bv": zeros(n, d),
                "wo": w(n, d, d), "bo": zeros(n, d),
            },
            "mlp": {
                "w1": w(n, d, f), "b1": zeros(n, f),
                "w2": w(n, f, d), "b2": zeros(n, d),
            },
        },
    }
    if cfg.use_pre_norm:
        params["pre_ln"] = ln()
    params["class_embed"] = w(d)
    return params


def patchify(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, 3) → (B, N, P·P·3) in (p_h, p_w, channel) order — matches a
    stride-P conv with kernel layout (kh, kw, C, D)."""
    b, h, w, c = pixels.shape
    gh, gw = h // patch, w // patch
    x = pixels.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # (B, gh, gw, P, P, C)
    return x.reshape(b, gh * gw, patch * patch * c)


def _vit_layer(cfg: VisionConfig, p: dict, h: torch.Tensor, a8: bool = False) -> torch.Tensor:
    b, s, d = h.shape
    nh, dh = cfg.n_heads, d // cfg.n_heads
    x = L.layer_norm(p["ln1"]["w"], p["ln1"]["b"], h, cfg.norm_eps)
    a = p["attn"]
    q = (qdot(x, a["wq"], a8=a8) + a["bq"]).reshape(b, s, nh, dh)
    k = (qdot(x, a["wk"], a8=a8) + a["bk"]).reshape(b, s, nh, dh)
    v = (qdot(x, a["wv"], a8=a8) + a["bv"]).reshape(b, s, nh, dh)
    attn = L.dot_product_attention(q, k, v)
    h = h + (qdot(attn.reshape(b, s, d), a["wo"], a8=a8) + a["bo"]).to(h.dtype)

    x2 = L.layer_norm(p["ln2"]["w"], p["ln2"]["b"], h, cfg.norm_eps)
    m = p["mlp"]
    z = (qdot(x2, m["w1"], a8=a8) + m["b1"]).float()
    if cfg.activation == "quick_gelu":  # OpenAI CLIP: x·σ(1.702x)
        z = z * torch.sigmoid(1.702 * z)
    else:
        z = F.gelu(z, approximate="tanh" if cfg.activation == "gelu_tanh" else "none")
    z = z.to(h.dtype)
    return h + (qdot(z, m["w2"], a8=a8) + m["b2"]).to(h.dtype)


def vision_forward(
    cfg: VisionConfig, params: dict, pixels: torch.Tensor, a8: bool = False
) -> torch.Tensor:
    """(B, H, W, 3) float → last_hidden_state (B, N, D).  ``a8``: w8a8 for
    int8-quantized layers, gated on the token count as in JAX."""
    x = patchify(pixels.to(cfg.dtype), cfg.patch_size)
    h = x @ params["patch_embed"]
    cls = params["class_embed"][None, None, :].expand(h.shape[0], 1, h.shape[-1])
    h = torch.cat([cls, h], dim=1)
    h = h + params["pos_embed"][None, : h.shape[1], :]
    if cfg.use_pre_norm:
        h = L.layer_norm(params["pre_ln"]["w"], params["pre_ln"]["b"], h, cfg.norm_eps)
    a8 = a8 and h.shape[1] >= W8A8_MIN_TOKENS
    layers = params["layers"]
    for i in range(cfg.n_layers):
        h = _vit_layer(cfg, L.layer_slice(layers, i), h, a8=a8)
    if cfg.use_post_norm:
        h = L.layer_norm(params["post_ln"]["w"], params["post_ln"]["b"], h, cfg.norm_eps)
    return h
