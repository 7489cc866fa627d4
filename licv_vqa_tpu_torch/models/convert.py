"""HF checkpoint → port params, Idefics family
(counterpart of ``licv_vqa_tpu/models/convert.py::convert_idefics``, :92-255).

Input is any mapping of HF parameter names to tensors or arrays (a torch
``state_dict``, safetensors shards); output is the layer-stacked param dict
the port's Idefics forward consumes, in the JAX layout.  HF ``nn.Linear``
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


def convert_idefics_vision(sd: Mapping, cfg, prefix: str) -> dict:
    n = cfg.n_layers
    lp = prefix + "encoder.layers.{i}."
    conv = _t(sd[prefix + "embeddings.patch_embedding.weight"])  # (D, C, P, P)
    return {
        "patch_embed": conv.permute(2, 3, 1, 0).reshape(-1, conv.shape[0]),
        "class_embed": _t(sd[prefix + "embeddings.class_embedding"]),
        "pos_embed": _t(sd[prefix + "embeddings.position_embedding.weight"]),
        "pre_ln": _ln(sd, prefix + "pre_layrnorm."),  # (sic — HF key)
        "post_ln": _ln(sd, prefix + "post_layernorm."),
        "layers": {
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
        },
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

    layers = {
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
