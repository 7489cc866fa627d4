"""ViT vision towers (counterpart of ``licv_vqa_tpu/models/vision.py``):
Idefics-9B's OpenCLIP ViT-H/14 and Idefics2's SigLIP-SO400M with NaViT
variable resolution.

Patchify is a reshape plus one matmul (a stride == kernel convolution is
exactly that).  Pre-LN encoder, biased projections, GELU MLP, as HF
``IdeficsVisionTransformer`` / ``Idefics2VisionTransformer``.  CLIP towers
prepend a class token and add learned positions; SigLIP towers have a
biased patch conv, no class token, NaViT bucketized position ids and a
patch mask for batch-padded images, and a post-layernorm.

Attention, in JAX's order (vision.py:93-111): sequences of at least 1024
patches on the card (every Idefics2 image) take the bidirectional flash
kernel (``layers.flash_attention_bidir``, ``csrc/flash_attn_bidir.cu``);
shorter ones on the card (the CLIP towers' s=257: Idefics-9B's ViT-H,
OpenFlamingo's ViT-L) take the fused short-sequence kernel
(``layers.vit_attention``, ``csrc/vit_attention.cu``), on by default where
JAX keeps it opt-in (``LICV_VIT_FUSED_ATTN=0`` turns it off; ROADMAP Queue
3), and only under a key mask; the rest take the plain
``dot_product_attention`` with the layer's mask.
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
    if cfg.use_class_token:
        params["class_embed"] = w(d)
    if cfg.patch_bias:
        params["patch_bias"] = zeros(d)
    return params


def patchify(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, 3) → (B, N, P·P·3) in (p_h, p_w, channel) order — matches a
    stride-P conv with kernel layout (kh, kw, C, D)."""
    b, h, w, c = pixels.shape
    gh, gw = h // patch, w // patch
    x = pixels.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # (B, gh, gw, P, P, C)
    return x.reshape(b, gh * gw, patch * patch * c)


def _vit_layer(
    cfg: VisionConfig, p: dict, h: torch.Tensor, mask=None, valid=None, a8: bool = False
) -> torch.Tensor:
    """``mask``: the plain branch's mask, a (B, 1, 1, S) key mask or any
    other (a text encoder's causal mask); ``valid``: the patch validity (B,
    S) of a key mask, for the kernels.  The fused short-sequence kernel
    takes key masks only (no ``mask``, or a ``valid``): JAX's branch drops
    ``mask`` (vision.py:102-110) and would attend a causal one
    bidirectionally (ROADMAP Queue 3, reference behaviour not to copy)."""
    b, s, d = h.shape
    nh, dh = cfg.n_heads, d // cfg.n_heads
    x = L.layer_norm(p["ln1"]["w"], p["ln1"]["b"], h, cfg.norm_eps)
    a = p["attn"]
    q = (qdot(x, a["wq"], a8=a8) + a["bq"]).reshape(b, s, nh, dh)
    k = (qdot(x, a["wk"], a8=a8) + a["bk"]).reshape(b, s, nh, dh)
    v = (qdot(x, a["wv"], a8=a8) + a["bv"]).reshape(b, s, nh, dh)
    if L.flash_bidir_usable(s, h.device):
        # never builds the (B, H, S, S) f32 scores (7.8 GB a layer for a
        # 32-shot prompt's 33 images of 1920 patches); invalid rows differ
        # from the plain branch's and are consumed by nothing (the
        # perceiver's kv_mask drops them)
        attn = L.flash_attention_bidir(q, k, v, valid=valid)
    elif (mask is None or valid is not None) and L.vit_attention_usable(s, dh, h.device):
        # never writes the (B, H, S, S) f32 scores to device memory
        attn = L.vit_attention(q, k, v, valid)
    else:
        attn = L.dot_product_attention(q, k, v, mask=mask)
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


def navit_position_ids(
    grid_h: int, grid_w: int, table_side: int, patch_mask: torch.Tensor
) -> torch.Tensor:
    """NaViT bucketized position ids (HF ``Idefics2VisionEmbeddings``): each
    image fills the top-left ``nb_h × nb_w`` rectangle of the padded grid,
    and its patches map to the fixed ``table_side²``-entry table by
    bucketizing fractional coordinates.  ``patch_mask``: (B, gh, gw) bool.
    Returns (B, gh·gw) int64; invalid patches get 0 (they are masked out of
    attention).  The f32 arithmetic is JAX's (vision.py:129-157), so the
    buckets agree at exact boundaries too."""
    dev = patch_mask.device
    nb_h = patch_mask[:, :, 0].to(torch.int32).sum(dim=1)  # (B,)
    nb_w = patch_mask[:, 0, :].to(torch.int32).sum(dim=1)
    # made on the device: a host scalar copied over would synchronize
    eps = torch.full((), 1.0 - 1e-6, dtype=torch.float32, device=dev)

    def frac(n: int, nb: torch.Tensor) -> torch.Tensor:
        ar = torch.arange(n, dtype=torch.float32, device=dev)[None, :]
        return ar / torch.clamp(nb, min=1)[:, None].to(torch.float32) * eps

    # torch.bucketize(v, arange(1/S, 1, 1/S), right=True) == floor(v·S)
    bh = torch.clamp(torch.floor(frac(grid_h, nb_h) * table_side).long(), 0, table_side - 1)
    bw = torch.clamp(torch.floor(frac(grid_w, nb_w) * table_side).long(), 0, table_side - 1)
    pos = (bh[:, :, None] * table_side + bw[:, None, :]).reshape(patch_mask.shape[0], -1)
    return torch.where(patch_mask.reshape(patch_mask.shape[0], -1), pos, torch.zeros_like(pos))


def vision_forward(
    cfg: VisionConfig,
    params: dict,
    pixels: torch.Tensor,
    patch_mask: torch.Tensor = None,  # (B, gh, gw) bool, NaViT variable resolution
    a8: bool = False,
) -> torch.Tensor:
    """(B, H, W, 3) float → last_hidden_state (B, N, D).

    SigLIP-family towers (no class token) take NaViT position ids, so H×W
    may differ from ``cfg.image_size`` (the position table's reference
    size, 980 for Idefics2).  ``patch_mask`` marks the valid patches of
    batch-padded images; the others are masked out of attention as keys.
    ``a8``: w8a8 for int8-quantized layers, gated on the token count as in
    JAX."""
    b, hh, ww, _ = pixels.shape
    x = patchify(pixels.to(cfg.dtype), cfg.patch_size)
    h = x @ params["patch_embed"]
    if "patch_bias" in params:
        h = h + params["patch_bias"]
    mask = valid = None
    if cfg.use_class_token:
        cls = params["class_embed"][None, None, :].expand(h.shape[0], 1, h.shape[-1])
        h = torch.cat([cls, h], dim=1)
        h = h + params["pos_embed"][None, : h.shape[1], :]
    else:
        gh, gw = hh // cfg.patch_size, ww // cfg.patch_size
        if patch_mask is None:
            patch_mask = torch.ones((b, gh, gw), dtype=torch.bool, device=h.device)
        patch_mask = patch_mask.bool()
        pos_ids = navit_position_ids(gh, gw, cfg.image_size // cfg.patch_size, patch_mask)
        h = h + params["pos_embed"][pos_ids]
        valid = patch_mask.reshape(b, -1)
        mask = valid[:, None, None, :]  # mask the keys of padded patches
    if cfg.use_pre_norm:
        h = L.layer_norm(params["pre_ln"]["w"], params["pre_ln"]["b"], h, cfg.norm_eps)
    a8 = a8 and h.shape[1] >= W8A8_MIN_TOKENS
    layers = params["layers"]
    for i in range(cfg.n_layers):
        h = _vit_layer(cfg, L.layer_slice(layers, i), h, mask=mask, valid=valid, a8=a8)
    if cfg.use_post_norm:
        h = L.layer_norm(params["post_ln"]["w"], params["post_ln"]["b"], h, cfg.norm_eps)
    return h
