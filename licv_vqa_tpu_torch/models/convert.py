"""HF checkpoint → port params, the Idefics, Idefics2 and OpenFlamingo
families (counterpart of ``licv_vqa_tpu/models/convert.py``:
``convert_llama`` :36, ``convert_idefics`` :172, ``convert_siglip_vision``
:256, ``convert_idefics2`` :296, ``convert_mpt`` :339,
``convert_openclip_vision`` :370, ``convert_flamingo_perceiver`` :415,
``convert_flamingo_xattn`` :451 and ``convert_openflamingo_checkpoint``
:481).

Input is any mapping of HF parameter names to tensors or arrays (a torch
``state_dict``, safetensors shards); output is the layer-stacked param dict
the port's forwards consume, in the JAX layout.  HF ``nn.Linear``
stores (out, in); the port stores (in, out), hence the transposes.  The JAX
converter itself cannot be imported here: its module pulls in jax.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _stack(sd: Mapping, fmt: str, n: int, transpose: bool = False) -> torch.Tensor:
    rows = [_t(sd[fmt.format(i=i)]) for i in range(n)]
    return torch.stack([r.T if transpose else r for r in rows])


def _ln(sd: Mapping, prefix: str) -> dict:
    return {"w": _t(sd[prefix + "weight"]), "b": _t(sd[prefix + "bias"])}


def _cast_tree(tree, dtype: torch.dtype, device):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype, device) for k, v in tree.items()}
    x = tree.to(dtype) if tree.is_floating_point() else tree
    return x.contiguous().to(device)


def _decoder_layers(sd: Mapping, lp: str, n: int) -> dict:
    """One LLaMA/Mistral layer stack; ``lp`` formats ``{i}``."""
    return {
        "attn": {
            "wq": _stack(sd, lp + "self_attn.q_proj.weight", n, True),
            "wk": _stack(sd, lp + "self_attn.k_proj.weight", n, True),
            "wv": _stack(sd, lp + "self_attn.v_proj.weight", n, True),
            "wo": _stack(sd, lp + "self_attn.o_proj.weight", n, True),
        },
        "mlp": {
            "w_gate": _stack(sd, lp + "mlp.gate_proj.weight", n, True),
            "w_up": _stack(sd, lp + "mlp.up_proj.weight", n, True),
            "w_down": _stack(sd, lp + "mlp.down_proj.weight", n, True),
        },
        "ln1": _stack(sd, lp + "input_layernorm.weight", n),
        "ln2": _stack(sd, lp + "post_attention_layernorm.weight", n),
    }


def convert_llama(
    sd: Mapping, cfg, prefix: str = "model.", dtype: Optional[torch.dtype] = None,
    device="cpu",
) -> dict:
    """LLaMA/Mistral-family state dict → decoder params (``embed``,
    ``layers``, ``final_norm``, ``lm_head`` unless tied); the text backbone
    inside Idefics2 given ``prefix="model.text_model."``.  ``cfg`` is a
    ``config.DecoderConfig``."""
    params = {
        "embed": _t(sd[prefix + "embed_tokens.weight"]),
        "layers": _decoder_layers(sd, prefix + "layers.{i}.", cfg.n_layers),
        "final_norm": _t(sd[prefix + "norm.weight"]),
    }
    if not cfg.tie_embeddings:
        head_key = "lm_head.weight"
        if head_key not in sd:  # a head nested under the prefix
            head_key = prefix + "lm_head.weight"
        params["lm_head"] = _t(sd[head_key]).T
    return _cast_tree(params, dtype or cfg.dtype, device)


def _vit_layers(sd: Mapping, lp: str, n: int) -> dict:
    """One CLIP/SigLIP encoder layer stack; ``lp`` formats ``{i}``."""
    return {
        "ln1": {
            "w": _stack(sd, lp + "layer_norm1.weight", n),
            "b": _stack(sd, lp + "layer_norm1.bias", n),
        },
        "ln2": {
            "w": _stack(sd, lp + "layer_norm2.weight", n),
            "b": _stack(sd, lp + "layer_norm2.bias", n),
        },
        "attn": {
            "wq": _stack(sd, lp + "self_attn.q_proj.weight", n, True),
            "bq": _stack(sd, lp + "self_attn.q_proj.bias", n),
            "wk": _stack(sd, lp + "self_attn.k_proj.weight", n, True),
            "bk": _stack(sd, lp + "self_attn.k_proj.bias", n),
            "wv": _stack(sd, lp + "self_attn.v_proj.weight", n, True),
            "bv": _stack(sd, lp + "self_attn.v_proj.bias", n),
            "wo": _stack(sd, lp + "self_attn.out_proj.weight", n, True),
            "bo": _stack(sd, lp + "self_attn.out_proj.bias", n),
        },
        "mlp": {
            "w1": _stack(sd, lp + "mlp.fc1.weight", n, True),
            "b1": _stack(sd, lp + "mlp.fc1.bias", n),
            "w2": _stack(sd, lp + "mlp.fc2.weight", n, True),
            "b2": _stack(sd, lp + "mlp.fc2.bias", n),
        },
    }


def _patch_embed(sd: Mapping, prefix: str) -> torch.Tensor:
    conv = _t(sd[prefix + "embeddings.patch_embedding.weight"])  # (D, C, P, P)
    return conv.permute(2, 3, 1, 0).reshape(-1, conv.shape[0])


def convert_siglip_vision(sd: Mapping, cfg, prefix: str) -> dict:
    """SigLIP tower (Idefics2): biased patch conv, no class token, a
    post-layernorm on the sequence."""
    return {
        "patch_embed": _patch_embed(sd, prefix),
        "patch_bias": _t(sd[prefix + "embeddings.patch_embedding.bias"]),
        "pos_embed": _t(sd[prefix + "embeddings.position_embedding.weight"]),
        "post_ln": _ln(sd, prefix + "post_layernorm."),
        "layers": _vit_layers(sd, prefix + "encoder.layers.{i}.", cfg.n_layers),
    }


def convert_idefics2(
    sd: Mapping, cfg, dtype: Optional[torch.dtype] = None, device="cpu"
) -> dict:
    """``Idefics2ForConditionalGeneration`` state dict → port params.
    ``cfg`` is a ``licv_vqa_tpu_torch.models.idefics2.Idefics2Config``."""
    dtype = dtype or cfg.text.dtype
    pp = "model.connector.perceiver_resampler."
    n = cfg.perceiver.n_layers
    lp = pp + "layers.{i}."
    perceiver = {
        "latents": _t(sd[pp + "latents"]),
        "layers": {
            "lat_norm": _stack(sd, lp + "input_latents_norm.weight", n),
            "ctx_norm": _stack(sd, lp + "input_context_norm.weight", n),
            "wq": _stack(sd, lp + "self_attn.q_proj.weight", n, True),
            "wk": _stack(sd, lp + "self_attn.k_proj.weight", n, True),
            "wv": _stack(sd, lp + "self_attn.v_proj.weight", n, True),
            "wo": _stack(sd, lp + "self_attn.o_proj.weight", n, True),
            "post_norm": _stack(sd, lp + "post_attention_layernorm.weight", n),
            "mlp": {
                "w_gate": _stack(sd, lp + "mlp.gate_proj.weight", n, True),
                "w_up": _stack(sd, lp + "mlp.up_proj.weight", n, True),
                "w_down": _stack(sd, lp + "mlp.down_proj.weight", n, True),
            },
        },
        "final_norm": _t(sd[pp + "norm.weight"]),
    }
    cp = "model.connector.modality_projection."
    connector = {k: _t(sd[cp + f"{k[2:]}_proj.weight"]).T for k in ("w_gate", "w_up", "w_down")}
    extra = {
        "vision": convert_siglip_vision(sd, cfg.vision, "model.vision_model."),
        "connector": connector,
        "perceiver": perceiver,
    }
    return {
        **convert_llama(sd, cfg.text, prefix="model.text_model.", dtype=dtype, device=device),
        **_cast_tree(extra, dtype, device),
    }


def convert_idefics_vision(sd: Mapping, cfg, prefix: str) -> dict:
    return {
        "patch_embed": _patch_embed(sd, prefix),
        "class_embed": _t(sd[prefix + "embeddings.class_embedding"]),
        "pos_embed": _t(sd[prefix + "embeddings.position_embedding.weight"]),
        "pre_ln": _ln(sd, prefix + "pre_layrnorm."),  # (sic — HF key)
        "post_ln": _ln(sd, prefix + "post_layernorm."),
        "layers": _vit_layers(sd, prefix + "encoder.layers.{i}.", cfg.n_layers),
    }


def convert_idefics_perceiver(sd: Mapping, n_layers: int, prefix: str) -> dict:
    bp = prefix + "blocks.{i}.0."
    mp = prefix + "blocks.{i}.1."
    n = n_layers
    blocks = {
        "ctx_ln": {
            "w": _stack(sd, bp + "context_layer_norm.weight", n),
            "b": _stack(sd, bp + "context_layer_norm.bias", n),
        },
        "lat_ln": {
            "w": _stack(sd, bp + "latents_layer_norm.weight", n),
            "b": _stack(sd, bp + "latents_layer_norm.bias", n),
        },
        "wq": _stack(sd, bp + "q_proj.weight", n, True),
        "wk": _stack(sd, bp + "k_proj.weight", n, True),
        "wv": _stack(sd, bp + "v_proj.weight", n, True),
        "wo": _stack(sd, bp + "output_proj.weight", n, True),
        "mlp_ln": {
            "w": _stack(sd, mp + "ln.weight", n),
            "b": _stack(sd, mp + "ln.bias", n),
        },
        "fc": _stack(sd, mp + "fc.weight", n, True),
        "c_proj": _stack(sd, mp + "c_proj.weight", n, True),
    }
    if prefix + "blocks.0.0.q_layer_norm.weight" in sd:
        blocks["q_ln"] = {
            "w": _stack(sd, bp + "q_layer_norm.weight", n),
            "b": _stack(sd, bp + "q_layer_norm.bias", n),
        }
        blocks["k_ln"] = {
            "w": _stack(sd, bp + "k_layer_norm.weight", n),
            "b": _stack(sd, bp + "k_layer_norm.bias", n),
        }
    return {
        "latents": _t(sd[prefix + "latents"]),
        "blocks": blocks,
        "final_ln": _ln(sd, prefix + "layer_norm."),
    }


def _gate(sd: Mapping, key: str, alpha_type: str) -> torch.Tensor:
    a = _t(sd[key]).reshape(-1)
    return a[0] if alpha_type == "float" else a


def convert_idefics(
    sd: Mapping, cfg, dtype: Optional[torch.dtype] = None, device="cpu"
) -> dict:
    """Full ``IdeficsForVisionText2Text`` state dict → port params.

    ``cfg`` is a ``licv_vqa_tpu_torch.models.idefics.IdeficsConfig``.
    Decoupled embedding / lm_head extra rows are concatenated into single
    tables."""
    t = cfg.text
    dtype = dtype or t.dtype
    n = t.n_layers
    lp = "model.layers.{i}."

    embed = _t(sd["model.embed_tokens.weight"])
    if "model.embed_tokens.additional_embedding.weight" in sd:
        embed = torch.cat(
            [embed, _t(sd["model.embed_tokens.additional_embedding.weight"])]
        )
    head = _t(sd["lm_head.weight"])
    if "lm_head.additional_fc.weight" in sd:
        head = torch.cat([head, _t(sd["lm_head.additional_fc.weight"])])

    layers = _decoder_layers(sd, lp, n)
    if "model.layers.0.self_attn.q_layer_norm.weight" in sd:
        layers["attn"]["q_norm"] = _stack(sd, lp + "self_attn.q_layer_norm.weight", n)
        layers["attn"]["k_norm"] = _stack(sd, lp + "self_attn.k_layer_norm.weight", n)

    n_x = n // cfg.cross_layer_interval
    xp = "model.gated_cross_attn_layers.{i}."
    xattn = {
        "ln1": _stack(sd, xp + "input_layernorm.weight", n_x),
        "ln2": _stack(sd, xp + "post_attention_layernorm.weight", n_x),
        "attn": {
            "wq": _stack(sd, xp + "cross_attn.q_proj.weight", n_x, True),
            "wk": _stack(sd, xp + "cross_attn.k_proj.weight", n_x, True),
            "wv": _stack(sd, xp + "cross_attn.v_proj.weight", n_x, True),
            "wo": _stack(sd, xp + "cross_attn.o_proj.weight", n_x, True),
        },
        "mlp": {
            "w_gate": _stack(sd, xp + "mlp.gate_proj.weight", n_x, True),
            "w_up": _stack(sd, xp + "mlp.up_proj.weight", n_x, True),
            "w_down": _stack(sd, xp + "mlp.down_proj.weight", n_x, True),
        },
        "alpha_xattn": torch.stack(
            [_gate(sd, xp.format(i=i) + "alpha_cross_attn", cfg.alpha_type) for i in range(n_x)]
        ),
        "alpha_dense": torch.stack(
            [_gate(sd, xp.format(i=i) + "alpha_dense", cfg.alpha_type) for i in range(n_x)]
        ),
    }
    if "model.gated_cross_attn_layers.0.cross_attn.q_layer_norm.weight" in sd:
        xattn["attn"]["q_norm"] = _stack(sd, xp + "cross_attn.q_layer_norm.weight", n_x)
        xattn["attn"]["k_norm"] = _stack(sd, xp + "cross_attn.k_layer_norm.weight", n_x)

    params = {
        "embed": embed,
        "layers": layers,
        "xattn": xattn,
        "final_norm": _t(sd["model.norm.weight"]),
        "lm_head": head.T,
        "vision": convert_idefics_vision(sd, cfg.vision, "model.vision_model."),
        "perceiver": convert_idefics_perceiver(
            sd, cfg.perceiver.n_layers, "model.perceiver_resampler."
        ),
    }
    return _cast_tree(params, dtype, device)


# ---------------------------------------------------------------------------
# OpenFlamingo: the MPT base, the open_clip tower and the flamingo deltas
# (JAX convert.py:339-540).  open_clip and open_flamingo are not needed: the
# converters read their state-dict naming only.
# ---------------------------------------------------------------------------


def convert_mpt(
    sd: Mapping, cfg, prefix: str = "transformer.", dtype: Optional[torch.dtype] = None,
    device="cpu",
) -> dict:
    """HF ``MptForCausalLM`` state dict → decoder params (OpenFlamingo's
    language encoder).  The fused ``Wqkv`` (3D, D) splits into q/k/v; the
    LayerNorms are bias-free; the LM head ties to the embedding.  ``cfg`` is
    a ``config.DecoderConfig``."""
    n, d = cfg.n_layers, cfg.d_model
    lp = prefix + "blocks.{i}."
    wqkv = _stack(sd, lp + "attn.Wqkv.weight", n)  # (L, 3D, D)
    layers = {
        "attn": {
            "wq": wqkv[:, :d, :].transpose(1, 2),
            "wk": wqkv[:, d : 2 * d, :].transpose(1, 2),
            "wv": wqkv[:, 2 * d :, :].transpose(1, 2),
            "wo": _stack(sd, lp + "attn.out_proj.weight", n, True),
        },
        "mlp": {
            "w_up": _stack(sd, lp + "ffn.up_proj.weight", n, True),
            "w_down": _stack(sd, lp + "ffn.down_proj.weight", n, True),
        },
        "ln1": _stack(sd, lp + "norm_1.weight", n),
        "ln2": _stack(sd, lp + "norm_2.weight", n),
    }
    params = {
        "embed": _t(sd[prefix + "wte.weight"]),
        "layers": layers,
        "final_norm": _t(sd[prefix + "norm_f.weight"]),
    }
    return _cast_tree(params, dtype or cfg.dtype, device)


def convert_openclip_vision(sd: Mapping, cfg, prefix: str = "visual.") -> dict:
    """open_clip ``VisionTransformer`` (CLIP ViT-L/14, OpenFlamingo's frozen
    tower) → the port's vision params.  open_clip fuses q/k/v into
    ``attn.in_proj_weight`` (3D, D); the patch conv has no bias.  Returns
    the source dtypes on the CPU (``_cast_tree`` places them)."""
    n, d = cfg.n_layers, cfg.d_model
    lp = prefix + "transformer.resblocks.{i}."
    conv = _t(sd[prefix + "conv1.weight"])  # (D, 3, P, P)
    in_w = _stack(sd, lp + "attn.in_proj_weight", n)  # (L, 3D, D)
    in_b = _stack(sd, lp + "attn.in_proj_bias", n)  # (L, 3D)
    return {
        "patch_embed": conv.permute(2, 3, 1, 0).reshape(-1, conv.shape[0]),
        "class_embed": _t(sd[prefix + "class_embedding"]).reshape(-1),
        "pos_embed": _t(sd[prefix + "positional_embedding"]),
        "pre_ln": _ln(sd, prefix + "ln_pre."),
        "post_ln": _ln(sd, prefix + "ln_post."),
        "layers": {
            "ln1": {"w": _stack(sd, lp + "ln_1.weight", n), "b": _stack(sd, lp + "ln_1.bias", n)},
            "ln2": {"w": _stack(sd, lp + "ln_2.weight", n), "b": _stack(sd, lp + "ln_2.bias", n)},
            "attn": {
                "wq": in_w[:, :d, :].transpose(1, 2),
                "bq": in_b[:, :d],
                "wk": in_w[:, d : 2 * d, :].transpose(1, 2),
                "bk": in_b[:, d : 2 * d],
                "wv": in_w[:, 2 * d :, :].transpose(1, 2),
                "bv": in_b[:, 2 * d :],
                "wo": _stack(sd, lp + "attn.out_proj.weight", n, True),
                "bo": _stack(sd, lp + "attn.out_proj.bias", n),
            },
            "mlp": {
                "w1": _stack(sd, lp + "mlp.c_fc.weight", n, True),
                "b1": _stack(sd, lp + "mlp.c_fc.bias", n),
                "w2": _stack(sd, lp + "mlp.c_proj.weight", n, True),
                "b2": _stack(sd, lp + "mlp.c_proj.bias", n),
            },
        },
    }


def convert_flamingo_perceiver(sd: Mapping, n_layers: int, prefix: str = "perceiver.") -> dict:
    """open_flamingo ``PerceiverResampler`` naming → the port's perceiver
    params: ``layers.{i}.0`` is the attention (norm_media/norm_latents, a
    fused to_kv split k first, as torch's ``chunk(2, dim=-1)``) and
    ``layers.{i}.1`` the FeedForward (LN, Linear, GELU, Linear; bias-free
    linears)."""
    n = n_layers
    ap = prefix + "layers.{i}.0."
    fp = prefix + "layers.{i}.1."
    to_kv = _stack(sd, ap + "to_kv.weight", n, True)  # (L, De, 2·inner)
    inner = to_kv.shape[-1] // 2
    return {
        "latents": _t(sd[prefix + "latents"]),
        "blocks": {
            "ctx_ln": {"w": _stack(sd, ap + "norm_media.weight", n),
                       "b": _stack(sd, ap + "norm_media.bias", n)},
            "lat_ln": {"w": _stack(sd, ap + "norm_latents.weight", n),
                       "b": _stack(sd, ap + "norm_latents.bias", n)},
            "wq": _stack(sd, ap + "to_q.weight", n, True),
            "wk": to_kv[:, :, :inner],
            "wv": to_kv[:, :, inner:],
            "wo": _stack(sd, ap + "to_out.weight", n, True),
            "mlp_ln": {"w": _stack(sd, fp + "0.weight", n), "b": _stack(sd, fp + "0.bias", n)},
            "fc": _stack(sd, fp + "1.weight", n, True),
            "c_proj": _stack(sd, fp + "3.weight", n, True),
        },
        "final_ln": _ln(sd, prefix + "norm."),
    }


def convert_flamingo_xattn(
    sd: Mapping, n_xattn: int, prefix: str = "lang_encoder.gated_cross_attn_layers."
) -> dict:
    """open_flamingo ``GatedCrossAttentionBlock`` naming → the port's xattn
    stack (``openflamingo.init_flamingo_xattn_params``).  The fused to_kv
    stays fused: the block reshapes it (…, 2, nh, dh), k first."""
    n = n_xattn
    xp = prefix + "{i}."

    def gate(name):
        return torch.stack([_t(sd[xp.format(i=i) + name]).reshape(-1)[0] for i in range(n)])

    return {
        "ln_attn": {"w": _stack(sd, xp + "attn.norm.weight", n),
                    "b": _stack(sd, xp + "attn.norm.bias", n)},
        "wq": _stack(sd, xp + "attn.to_q.weight", n, True),
        "wkv": _stack(sd, xp + "attn.to_kv.weight", n, True),
        "wo": _stack(sd, xp + "attn.to_out.weight", n, True),
        "attn_gate": gate("attn_gate"),
        "ln_ff": {"w": _stack(sd, xp + "ff.0.weight", n), "b": _stack(sd, xp + "ff.0.bias", n)},
        "ff_up": _stack(sd, xp + "ff.1.weight", n, True),
        "ff_down": _stack(sd, xp + "ff.3.weight", n, True),
        "ff_gate": gate("ff_gate"),
    }


def convert_openflamingo_checkpoint(
    sd: Mapping, cfg, params: dict, dtype: Optional[torch.dtype] = None, device=None
) -> tuple:
    """Merge an open_flamingo ``checkpoint.pt`` state dict into ``params``;
    returns ``(new_params, updated_keys)``.

    The released checkpoints carry only the trained deltas: the perceiver,
    the gated cross-attention layers and the resized input embedding
    (``lang_encoder.transformer.wte.weight``); the MPT base and the CLIP
    tower load separately.  A full-model dump also carries the MPT blocks
    and the tower (``vision_encoder.visual.*``).  Keys may be
    ``module.``-prefixed (DDP).  ``cfg`` is an ``OpenFlamingoConfig``; the
    new leaves go to ``device`` (default: where ``params["embed"]`` is)."""
    t = cfg.text
    dtype = dtype or t.dtype
    device = device if device is not None else params["embed"].device
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    out = dict(params)
    updated = []
    if "perceiver.latents" in sd:
        out["perceiver"] = _cast_tree(
            convert_flamingo_perceiver(sd, cfg.perceiver.n_layers), dtype, device
        )
        updated.append("perceiver")
    n_xattn = t.n_layers // cfg.cross_attn_every_n_layers
    if "lang_encoder.gated_cross_attn_layers.0.attn_gate" in sd:
        out["xattn"] = _cast_tree(convert_flamingo_xattn(sd, n_xattn), dtype, device)
        updated.append("xattn")
    if "lang_encoder.transformer.wte.weight" in sd:
        # embeddings resized for <image>/<|endofchunk|>; MPT ties the head
        out["embed"] = _cast_tree(_t(sd["lang_encoder.transformer.wte.weight"]), dtype, device)
        updated.append("embed")
    if "lang_encoder.transformer.blocks.0.attn.Wqkv.weight" in sd:
        # a full-model dump: the MPT base rides along
        mpt = convert_mpt(sd, t, prefix="lang_encoder.transformer.", dtype=dtype, device=device)
        out["layers"], out["final_norm"] = mpt["layers"], mpt["final_norm"]
        if "embed" not in updated:
            out["embed"] = mpt["embed"]
        updated.append("layers")
    if "vision_encoder.visual.conv1.weight" in sd:
        out["vision"] = _cast_tree(
            convert_openclip_vision(sd, cfg.vision, "vision_encoder.visual."), dtype, device
        )
        updated.append("vision")
    return out, updated
