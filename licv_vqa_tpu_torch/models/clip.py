"""CLIP dual encoder (ViT-B/32 class): RICE's retrieval featurizer
(counterpart of ``licv_vqa_tpu/models/clip.py``).

The reference encodes RICE features with transformers' CLIP on the host
(reference: icv_src/utils/mm_topk_retriver.py:26,82-106); here both towers
run on the device, in f32 as in JAX (``retrieval/rice.py`` builds them with
``dtype=f32``).

The vision tower is ``models.vision`` (class token, pre-layernorm, biased
projections) with the OpenAI ``quick_gelu`` MLP.  Its attention, a key-mask-
free bidirectional one over 50 tokens, takes the fused ViT kernel on the
card (``layers.vit_attention``: f32 tensors launch
``csrc/vit_attention_f32.cu``).  The text tower is the same pre-LN encoder
layer run with a causal-and-padding mask, so its attention is always the
plain ``dot_product_attention`` (the fused kernel takes key masks only,
``vision._vit_layer``); then the final layernorm, EOT pooling (HF pools at
``input_ids.argmax(-1)``: the EOT token has the highest id in CLIP's
vocab; or at the first ``eos_token_id``), and the learned projections to
the shared embedding space.  ``convert_hf_clip`` maps a transformers
``CLIPModel`` state dict.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import layers as L
from .config import VisionConfig
from .vision import _vit_layer, init_vision_params, vision_forward


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    max_positions: int = 77
    d_model: int = 512
    n_layers: int = 12
    n_heads: int = 8
    d_ff: int = 2048
    norm_eps: float = 1e-5
    activation: str = "quick_gelu"
    # HF pooling contract (modeling_clip.py): eos_token_id == 2 (the OpenAI
    # checkpoints' legacy value) pools at argmax(input_ids), EOT being the
    # highest id; any other value pools at the FIRST position equal to it
    eos_token_id: int = 2
    dtype: torch.dtype = torch.float32


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    vision: VisionConfig = dataclasses.field(
        default_factory=lambda: VisionConfig(
            image_size=224, patch_size=32, d_model=768, n_layers=12, n_heads=12,
            d_ff=3072, activation="quick_gelu", dtype=torch.float32,
        )
    )
    text: ClipTextConfig = dataclasses.field(default_factory=ClipTextConfig)
    projection_dim: int = 512

    @classmethod
    def vit_b32(cls) -> "ClipConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "ClipConfig":
        return cls(
            vision=VisionConfig(
                image_size=32, patch_size=8, d_model=32, n_layers=2, n_heads=4,
                d_ff=64, activation="quick_gelu", dtype=torch.float32,
            ),
            text=ClipTextConfig(
                vocab_size=128, max_positions=16, d_model=24, n_layers=2, n_heads=4, d_ff=48,
            ),
            projection_dim=16,
        )


def init_clip_params(generator: torch.Generator, cfg: ClipConfig, device) -> dict:
    """Random params of JAX's ``init_clip_params`` layout (N(0, 0.02²)
    matrices, unit norms, zero biases), drawn on ``device``."""
    t = cfg.text
    n, d, f, dt = t.n_layers, t.d_model, t.d_ff, t.dtype

    def w(*shape, dtype=dt):
        return L.dense_init(generator, shape, dtype, device)

    def ln(*lead):
        return {"w": torch.ones((*lead, d), dtype=dt, device=device),
                "b": torch.zeros((*lead, d), dtype=dt, device=device)}

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    text = {
        "token_embed": w(t.vocab_size, d),
        "pos_embed": w(t.max_positions, d),
        "final_ln": ln(),
        "layers": {
            "ln1": ln(n),
            "ln2": ln(n),
            "attn": {
                "wq": w(n, d, d), "bq": zeros(n, d),
                "wk": w(n, d, d), "bk": zeros(n, d),
                "wv": w(n, d, d), "bv": zeros(n, d),
                "wo": w(n, d, d), "bo": zeros(n, d),
            },
            "mlp": {"w1": w(n, d, f), "b1": zeros(n, f), "w2": w(n, f, d), "b2": zeros(n, d)},
        },
    }
    return {
        "vision": init_vision_params(generator, cfg.vision, device),
        "text": text,
        "visual_projection": w(cfg.vision.d_model, cfg.projection_dim, dtype=torch.float32),
        "text_projection": w(t.d_model, cfg.projection_dim, dtype=torch.float32),
    }


def clip_image_features(cfg: ClipConfig, params: dict, pixels: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) normalized floats → (B, P) projected features.

    HF semantics: ``pooled = post_layernorm(last_hidden[:, 0])`` then
    ``visual_projection`` (modeling_clip.py CLIPVisionTransformer)."""
    h = vision_forward(cfg.vision, params["vision"], pixels)
    post = params["vision"]["post_ln"]
    pooled = L.layer_norm(post["w"], post["b"], h[:, 0, :], cfg.vision.norm_eps)
    return pooled @ params["visual_projection"]


def clip_text_features(
    cfg: ClipConfig,
    params: dict,
    input_ids: torch.Tensor,  # (B, S) int, right-padded
    attention_mask: torch.Tensor,  # (B, S) 1 = real
) -> torch.Tensor:
    """HF semantics: causal encoder, final layernorm, EOT pooling per the
    ``eos_token_id`` contract (see ``ClipTextConfig``), ``text_projection``."""
    t = cfg.text
    p = params["text"]
    b, s = input_ids.shape
    ids = input_ids.long()
    h = (p["token_embed"][ids] + p["pos_embed"][None, :s, :]).to(t.dtype)
    pos = torch.arange(s, device=ids.device)
    # a causal mask: the layer takes the plain attention, never the fused
    # kernel (key masks only)
    mask = (pos[None, :] <= pos[:, None])[None, None] & attention_mask.bool()[:, None, None, :]
    vcfg = VisionConfig(
        d_model=t.d_model, n_layers=t.n_layers, n_heads=t.n_heads, d_ff=t.d_ff,
        norm_eps=t.norm_eps, activation=t.activation, dtype=t.dtype,
    )
    for i in range(t.n_layers):
        h = _vit_layer(vcfg, L.layer_slice(p["layers"], i), h, mask=mask)
    h = L.layer_norm(p["final_ln"]["w"], p["final_ln"]["b"], h, t.norm_eps)
    if t.eos_token_id == 2:
        eot = torch.argmax(ids, dim=-1)
    else:
        eot = torch.argmax((ids == t.eos_token_id).to(torch.int32), dim=-1)
    pooled = h[torch.arange(b, device=ids.device), eot]
    return pooled @ params["text_projection"]


# ---------------------------------------------------------------------------
# HF CLIPModel converter
# ---------------------------------------------------------------------------


def _np(t) -> np.ndarray:
    return t.detach().cpu().float().numpy() if hasattr(t, "detach") else np.asarray(t)


def _stack_text_layers(sd: dict, prefix: str, n: int) -> dict:
    """HF encoder layers ``{prefix}.layers.{i}`` → layer-stacked leaves,
    linear weights transposed to ``(in, out)``."""

    def take(fmt, transpose=False):
        mats = [_np(sd[fmt.format(i=i)]) for i in range(n)]
        return torch.from_numpy(np.stack([m.T if transpose else m for m in mats]))

    layer = prefix + ".layers.{i}."
    return {
        "ln1": {"w": take(layer + "layer_norm1.weight"), "b": take(layer + "layer_norm1.bias")},
        "ln2": {"w": take(layer + "layer_norm2.weight"), "b": take(layer + "layer_norm2.bias")},
        "attn": {
            "wq": take(layer + "self_attn.q_proj.weight", True),
            "bq": take(layer + "self_attn.q_proj.bias"),
            "wk": take(layer + "self_attn.k_proj.weight", True),
            "bk": take(layer + "self_attn.k_proj.bias"),
            "wv": take(layer + "self_attn.v_proj.weight", True),
            "bv": take(layer + "self_attn.v_proj.bias"),
            "wo": take(layer + "self_attn.out_proj.weight", True),
            "bo": take(layer + "self_attn.out_proj.bias"),
        },
        "mlp": {
            "w1": take(layer + "mlp.fc1.weight", True),
            "b1": take(layer + "mlp.fc1.bias"),
            "w2": take(layer + "mlp.fc2.weight", True),
            "b2": take(layer + "mlp.fc2.bias"),
        },
    }


def _cast(tree, dtype, device):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype, device) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype)


def convert_hf_clip(sd: dict, cfg: ClipConfig, device="cpu") -> dict:
    """transformers ``CLIPModel.state_dict()`` → the port's tree (JAX's
    layout).  The vision patch conv (D, C, kh, kw) flattens to the
    (kh·kw·C, D) patchify layout; ``pre_layrnorm`` is HF's actual
    (misspelled) name."""
    v, t = cfg.vision, cfg.text

    def arr(key):
        return torch.from_numpy(_np(sd[key]))

    conv = _np(sd["vision_model.embeddings.patch_embedding.weight"])
    vision = {
        "patch_embed": torch.from_numpy(
            np.ascontiguousarray(conv.transpose(2, 3, 1, 0).reshape(-1, conv.shape[0]))),
        "class_embed": arr("vision_model.embeddings.class_embedding"),
        "pos_embed": arr("vision_model.embeddings.position_embedding.weight"),
        "pre_ln": {"w": arr("vision_model.pre_layrnorm.weight"),
                   "b": arr("vision_model.pre_layrnorm.bias")},
        "post_ln": {"w": arr("vision_model.post_layernorm.weight"),
                    "b": arr("vision_model.post_layernorm.bias")},
        "layers": _stack_text_layers(sd, "vision_model.encoder", v.n_layers),
    }
    text = {
        "token_embed": arr("text_model.embeddings.token_embedding.weight"),
        "pos_embed": arr("text_model.embeddings.position_embedding.weight"),
        "final_ln": {"w": arr("text_model.final_layer_norm.weight"),
                     "b": arr("text_model.final_layer_norm.bias")},
        "layers": _stack_text_layers(sd, "text_model.encoder", t.n_layers),
    }
    return {
        "vision": _cast(vision, v.dtype, device),
        "text": _cast(text, t.dtype, device),
        "visual_projection": arr("visual_projection.weight").T.contiguous().to(device),
        "text_projection": arr("text_projection.weight").T.contiguous().to(device),
    }
