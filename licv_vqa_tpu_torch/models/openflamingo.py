"""OpenFlamingo-9B: MPT-7B backbone + CLIP ViT-L/14 tower + perceiver +
Flamingo gated cross-attention, with the ICV injected at the decoder-block
output (counterpart of ``licv_vqa_tpu/models/openflamingo.py``).

As in JAX (the open_flamingo convention):

- MPT decoder: ALiBi, bias-free LayerNorm, GELU MLP, the LM head tied to
  the embedding table (``decoder.py``'s MPT branch);
- gated cross-attention runs BEFORE decoder layer ``l`` when
  ``l % every == every - 1`` (the end of each group, where Idefics runs it
  at the start); scalar ``tanh`` gates; text tokens attend only the most
  recent preceding image's latents; a bias-free exact-erf GELU FF;
- the tower's tokens are post-layernormed with the class token dropped.

Both forwards are ported: the cached one (prefill + decode) and the grouped
no-cache train forward, which checkpoints for the backward where JAX's
``jax.checkpoint`` sits.  So are the continuous engines' slot-oriented
serving functions (``make_openflamingo_serving_fns``, per-slot media as
Idefics-9B's) and the merged admission forward
(``make_openflamingo_merged_admit_fn``: one pool decode step and one
admission group's prefill over ``decoder.merged_decoder_layer`` with a
per-lane ALiBi bias).

The decoder and cross-attention stacks may hold int8 or int4 leaves
(``lmm.quantize``); under ``w8a8_prefill`` the blocks of at least
``decoder.W8A8_MIN_TOKENS`` tokens (text or media) take w8a8, the tower
stays weight-only and the perceiver takes it (JAX :199-224, :262).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.int8_matmul import qdot
from . import layers as L
from .config import BLOCK_OUTPUT, DecoderConfig, PerceiverConfig, VisionConfig
from .decoder import (
    W8A8_MIN_TOKENS,
    _icv_row,
    _positions_from_mask,
    alibi_bias_for,
    cast_icv,
    decode_cache_view,
    decoder_layer,
    init_kv_cache,
    init_layer_params,
    logits_from_hidden,
    merged_decoder_layer,
)
from .idefics import _xattn_mask, image_attention_onehot, last_image_onehot
from .perceiver import init_perceiver_params, perceiver_forward
from .vision import init_vision_params, vision_forward


@dataclasses.dataclass(frozen=True)
class OpenFlamingoConfig:
    text: DecoderConfig
    vision: VisionConfig
    perceiver: PerceiverConfig
    cross_attn_every_n_layers: int = 4
    xattn_heads: int = 8
    xattn_head_dim: int = 64
    xattn_ff_mult: int = 4
    image_token_id: int = 50277
    media_token: str = "<image>"

    @classmethod
    def openflamingo_9b(cls, dtype=torch.bfloat16) -> "OpenFlamingoConfig":
        """OpenFlamingo-9B (MPT-7B + ViT-L/14; config/lmm/openflamingov2-9B.yaml:
        32 layers, hidden 4096, cross_attn_every_n_layers=4)."""
        return cls(
            text=DecoderConfig(
                vocab_size=50432, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=32,
                d_ff=16384, norm_eps=1e-5, positional="alibi", norm_type="layernorm",
                activation="gelu", tie_embeddings=True, injection_site=BLOCK_OUTPUT,
                dtype=dtype,
            ),
            vision=VisionConfig(
                image_size=224, patch_size=14, d_model=1024, n_layers=24, n_heads=16,
                d_ff=4096, use_class_token=True, use_pre_norm=True, use_post_norm=True,
                dtype=dtype,
            ),
            perceiver=PerceiverConfig(
                n_latents=64, n_layers=6, n_heads=8, head_dim=64, d_model=1024,
                d_ff=4096, activation="gelu", dtype=dtype,
            ),
        )

    @classmethod
    def tiny(cls, dtype=torch.float32) -> "OpenFlamingoConfig":
        """Tiny-random config for tests (the JAX ``tiny``'s shapes)."""
        return cls(
            text=DecoderConfig(
                vocab_size=130, d_model=64, n_layers=4, n_heads=4, n_kv_heads=4,
                d_ff=256, norm_eps=1e-5, positional="alibi", norm_type="layernorm",
                activation="gelu", tie_embeddings=True, dtype=dtype,
            ),
            vision=VisionConfig(
                image_size=28, patch_size=14, d_model=32, n_layers=2, n_heads=2, d_ff=64,
                use_post_norm=True, dtype=dtype,
            ),
            perceiver=PerceiverConfig(
                n_latents=4, n_layers=2, n_heads=2, head_dim=16, d_model=32, d_ff=64,
                activation="gelu", dtype=dtype,
            ),
            cross_attn_every_n_layers=2,
            xattn_heads=2,
            xattn_head_dim=16,
            image_token_id=125,
        )


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_flamingo_xattn_params(
    generator: torch.Generator, cfg: OpenFlamingoConfig, n_xattn: int, device
) -> dict:
    t = cfg.text
    d, de = t.d_model, cfg.perceiver.d_model
    nh, dh = cfg.xattn_heads, cfg.xattn_head_dim
    f = cfg.xattn_ff_mult * d

    def w(*shape):
        return L.dense_init(generator, (n_xattn, *shape), t.dtype, device)

    def full(value, *shape):
        return torch.full((n_xattn, *shape), value, dtype=t.dtype, device=device)

    return {
        "ln_attn": {"w": full(1.0, d), "b": full(0.0, d)},
        "wq": w(d, nh * dh),
        "wkv": w(de, 2 * nh * dh),
        "wo": w(nh * dh, d),
        "attn_gate": full(0.0),
        "ln_ff": {"w": full(1.0, d), "b": full(0.0, d)},
        "ff_up": w(d, f),
        "ff_down": w(f, d),
        "ff_gate": full(0.0),
    }


def init_openflamingo_params(
    generator: torch.Generator, cfg: OpenFlamingoConfig, device
) -> dict:
    """Random init (N(0, 0.02²) weights, unit norms, zero biases and gates)
    on ``device`` in ``cfg``'s dtypes — about 16 GB at OpenFlamingo-9B width
    in bf16.  Tests carry JAX params across with ``weights.params_from_jax``."""
    t = cfg.text
    return {
        "embed": L.dense_init(generator, (t.vocab_size, t.d_model), t.dtype, device),
        "layers": init_layer_params(generator, t, t.n_layers, device),
        "xattn": init_flamingo_xattn_params(
            generator, cfg, t.n_layers // cfg.cross_attn_every_n_layers, device
        ),
        "final_norm": torch.ones((t.d_model,), dtype=t.dtype, device=device),
        "final_norm_b": torch.zeros((t.d_model,), dtype=t.dtype, device=device),
        "vision": init_vision_params(generator, cfg.vision, device),
        "perceiver": init_perceiver_params(generator, cfg.perceiver, False, device),
    }


def encode_media(
    cfg: OpenFlamingoConfig, params: dict, pixel_values: torch.Tensor
) -> torch.Tensor:
    """(B, N_img, H, W, 3) → latents (B, N_img·n_lat, De).  The tower's
    tokens are post-layernormed with the class token dropped (open_clip's
    token output).  Under ``w8a8_prefill`` the perceiver takes w8a8 and a
    quantized tower stays weight-only, as in ``idefics.encode_images``."""
    b, n_img = pixel_values.shape[:2]
    flat = pixel_values.reshape((b * n_img,) + tuple(pixel_values.shape[2:]))
    feats = vision_forward(cfg.vision, params["vision"], flat, a8=False)[:, 1:, :]
    latents = perceiver_forward(cfg.perceiver, params["perceiver"], feats,
                                a8=cfg.text.w8a8_prefill)
    return latents.reshape(b, n_img * latents.shape[1], latents.shape[2])


# ---------------------------------------------------------------------------
# Gated cross-attention block
# ---------------------------------------------------------------------------


def flamingo_xattn_block(
    cfg: OpenFlamingoConfig,
    p: dict,  # one block's params
    h: torch.Tensor,  # (B, S, D)
    media: Optional[torch.Tensor],  # (B, Nk, De); unused when kv given
    media_mask: torch.Tensor,  # (B, 1, S, Nk) bool
    gate: torch.Tensor,  # (B, S) 1.0 where the token attends an image
    kv: Optional[tuple] = None,  # precomputed (k, v) each (B, Nk, nh, dh)
) -> torch.Tensor:
    t = cfg.text
    b, s, _ = h.shape
    nh, dh = cfg.xattn_heads, cfg.xattn_head_dim
    # token-count gates (JAX :223-224): the text block's here, the media's
    # at its K/V projection
    a8 = t.w8a8_prefill and s >= W8A8_MIN_TOKENS
    x = L.layer_norm(p["ln_attn"]["w"], p["ln_attn"]["b"], h, t.norm_eps)
    q = qdot(x, p["wq"], a8=a8).reshape(b, s, nh, dh)
    if kv is not None:
        k, v = kv  # decode-invariant media K/V, computed at bind time
    else:
        a8_med = t.w8a8_prefill and media.shape[1] >= W8A8_MIN_TOKENS
        kvm = qdot(media, p["wkv"], a8=a8_med).reshape(b, -1, 2, nh, dh)  # k first
        k, v = kvm[:, :, 0], kvm[:, :, 1]
    # a token before the first <image> has a fully masked row: its uniform
    # (finite) softmax is zeroed by the gate
    attn = L.dot_product_attention(q, k, v, mask=media_mask)
    attn = qdot(attn.reshape(b, s, nh * dh), p["wo"], a8=a8).to(h.dtype)
    attn = attn * gate[:, :, None].to(attn.dtype)
    h = h + torch.tanh(p["attn_gate"]).to(h.dtype) * attn

    x2 = L.layer_norm(p["ln_ff"]["w"], p["ln_ff"]["b"], h, t.norm_eps)
    # open_flamingo's FeedForward: nn.GELU(), exact erf
    z = F.gelu(qdot(x2, p["ff_up"], preferred_element_type=torch.float32, a8=a8),
               approximate="none").to(h.dtype)
    ff = qdot(z, p["ff_down"], a8=a8).to(h.dtype)
    return h + torch.tanh(p["ff_gate"]).to(h.dtype) * ff


def precompute_xattn_kv(
    cfg: OpenFlamingoConfig, params: dict, media_latents: torch.Tensor
) -> tuple:
    """K/V of the media latents for every gated-xattn block, (G, B, Nk, nh,
    dh) each: decode-invariant, computed once per bind (w8a8 by the bind's
    media token count, JAX :262)."""
    t = cfg.text
    b, n_k = media_latents.shape[:2]
    nh, dh = cfg.xattn_heads, cfg.xattn_head_dim
    a8 = t.w8a8_prefill and n_k >= W8A8_MIN_TOKENS
    ks, vs = [], []
    for g in range(t.n_layers // cfg.cross_attn_every_n_layers):
        w = L.layer_slice(params["xattn"]["wkv"], g)  # a tensor or a quantized leaf
        kv = qdot(media_latents, w, a8=a8).reshape(b, n_k, 2, nh, dh)
        ks.append(kv[:, :, 0].to(t.dtype))
        vs.append(kv[:, :, 1].to(t.dtype))
    return torch.stack(ks), torch.stack(vs)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def openflamingo_forward(
    cfg: OpenFlamingoConfig,
    params: dict,
    input_ids: torch.Tensor,  # (B, s)
    attention_mask: torch.Tensor,  # (B, s)
    media_latents: torch.Tensor,  # (B0, N_img·n_lat, De) from encode_media
    media_onehot: torch.Tensor,  # (B, s, N_img) incl. pixel_valid masking
    icv_scaled=None,  # (L, D) rows, ((L, D) rows, [L] host flags), or None
    cache: Optional[dict] = None,
    positions: Optional[torch.Tensor] = None,
    remat: bool = False,
    xattn_kv: Optional[tuple] = None,  # precomputed (G, B, Nk, nh, dh) k/v
    last_logit_only: bool = False,  # decode prefill: skip S-1 head rows
    prefill_flash: Optional[torch.Tensor] = None,  # mask: empty-cache prefill
    return_hidden: bool = False,  # train forward: post-norm hidden, no head
):
    """Returns ``(logits f32 (B, s|1, V), cache)``, as JAX's (:273-469).

    With a ``cache``: writes this block's K/V into it in place; the ALiBi
    bias spans the cache's columns.  ``prefill_flash`` (the attention mask)
    marks a prefill into an EMPTY cache, which lets the ALiBi flash kernel
    run.  Without one: the grouped train forward; ``cache`` comes back
    None and ``return_hidden`` gives the post-norm hidden states."""
    t = cfg.text
    every = cfg.cross_attn_every_n_layers
    n_groups = t.n_layers // every
    b, s = input_ids.shape
    ids = torch.clamp(input_ids, 0, params["embed"].shape[0] - 1).long()
    h = params["embed"][ids].to(t.dtype)

    xmask, gate = _xattn_mask(media_latents, media_onehot)  # (B, 1, s, Nk), (B, s)
    icv = cast_icv(icv_scaled, t.dtype)

    if cache is None:
        h = _grouped_train_forward(
            cfg, params, h, attention_mask, media_latents, xmask, gate, icv,
            remat and torch.is_grad_enabled(),
        )
    else:
        index = cache["index"]
        mask, _, _ = decode_cache_view(cache, positions, attention_mask, s)
        bias = alibi_bias_for(t, positions, cache, prefill_flash)
        for li in range(t.n_layers):
            # flamingo: cross-attention BEFORE the layer that closes a group
            if li % every == every - 1:
                g = li // every
                kv_g = (xattn_kv[0][g], xattn_kv[1][g]) if xattn_kv is not None else None
                h = flamingo_xattn_block(
                    cfg, L.layer_slice(params["xattn"], g), h, media_latents, xmask, gate,
                    kv=kv_g,
                )
            h = decoder_layer(
                t, L.layer_slice(params["layers"], li), h, None, None, mask,
                _icv_row(icv, li),
                kv_write=(L.layer_slice(cache["k"], li), L.layer_slice(cache["v"], li), index),
                flash_valid=prefill_flash, bias=bias,
            )
        cache["index"] = index + s
    h = L.layer_norm(params["final_norm"], params["final_norm_b"], h, t.norm_eps)
    if cache is None and return_hidden:
        return h, None
    if last_logit_only:
        h = h[:, -1:, :]  # LEFT-padded decode prompts: the last position is live
    return logits_from_hidden(t, params, h), cache


def _grouped_train_forward(cfg, params, h, attention_mask, media_latents, xmask, gate, icv,
                           remat: bool):
    """The no-cache stack as JAX's grouped scan: per group, ``every - 1``
    layers, the gated cross-attention, then the group's last layer.  Under
    ``remat`` it checkpoints where ``jax.checkpoint`` sits: the group, each
    of its first ``every - 1`` layers and the cross-attention (the last
    layer is not checkpointed on its own, as in JAX).  The flash branch is
    gated on the attention mask as JAX's train forward gates it."""
    t = cfg.text
    every = cfg.cross_attn_every_n_layers
    n_groups = t.n_layers // every
    if n_groups * every != t.n_layers:
        raise ValueError(
            f"openflamingo train forward needs n_layers ({t.n_layers}) divisible by "
            f"cross_attn_every_n_layers ({every})"
        )
    positions = _positions_from_mask(attention_mask)
    mask = L.causal_mask(positions, positions, attention_mask.bool())
    bias = alibi_bias_for(t, positions, None, attention_mask)

    def run(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)

    def layer(li):
        p_l = L.layer_slice(params["layers"], li)

        def layer_fn(hh, icv_arg):
            return decoder_layer(
                t, p_l, hh, None, None, mask, icv_arg, flash_valid=attention_mask, bias=bias
            )

        return layer_fn

    def group_body(h, g):
        for li in range(g * every, (g + 1) * every - 1):
            h = run(layer(li), h, _icv_row(icv, li))
        xp = L.layer_slice(params["xattn"], g)
        h = run(lambda hh: flamingo_xattn_block(cfg, xp, hh, media_latents, xmask, gate), h)
        last = (g + 1) * every - 1
        return layer(last)(h, _icv_row(icv, last))

    for g in range(n_groups):
        h = run(group_body, h, g)
    return h


def bind_media(cfg: OpenFlamingoConfig, params: dict, pixel_values, pixel_valid, ids,
               eos_token_id: int) -> tuple:
    """One bind's media: ``(latents, prefill one-hot (B, s, N_img),
    step one-hot (B, 1, N_img), cross-attention K/V)``, the one-hots
    masked by ``pixel_valid``."""
    latents = encode_media(cfg, params, pixel_values)
    n_img = pixel_values.shape[1]
    pv = pixel_valid[:, None, :].float()
    prefill_onehot = image_attention_onehot(ids, cfg.image_token_id, eos_token_id, n_img) * pv
    step_onehot = last_image_onehot(ids, cfg.image_token_id, n_img) * pv
    return latents, prefill_onehot, step_onehot, precompute_xattn_kv(cfg, params, latents)


def make_openflamingo_forward_fns(cfg: OpenFlamingoConfig, eos_token_id: int):
    """``(train_forward, bind_images)``, as JAX's
    ``make_openflamingo_forward_fns`` (:472-543) and the port's
    ``idefics.make_idefics_forward_fns``: the train forward over a batch
    dict with recompute on, and a bind that encodes the images once and
    returns ``forward_fn(input_ids, attention_mask, positions, cache)`` for
    the decode loops (``cache=None`` is the prefill into a fresh cache of
    ``max_len`` columns; later calls may carry a beam-expanded batch)."""

    def train_forward(params, inputs, icv_scaled, return_hidden=False):
        latents = encode_media(cfg, params, inputs["pixel_values"])
        onehot = image_attention_onehot(
            inputs["input_ids"], cfg.image_token_id, eos_token_id,
            inputs["pixel_values"].shape[1],
        ) * inputs["pixel_valid"][:, None, :].float()
        out, _ = openflamingo_forward(
            cfg, params, inputs["input_ids"], inputs["attention_mask"], latents, onehot,
            icv_scaled=icv_scaled, remat=True, return_hidden=return_hidden,
        )
        return out

    def bind_images(params, pixel_values, pixel_valid, prompt_ids, icv_scaled, max_len):
        latents, prefill_onehot, step_onehot, xattn_kv = bind_media(
            cfg, params, pixel_values, pixel_valid, prompt_ids, eos_token_id)
        expanded = {1: xattn_kv}  # beam-expanded media K/V, built once per factor

        def forward_fn(input_ids, attention_mask, positions, cache):
            b = input_ids.shape[0]
            if cache is None:
                cache = init_kv_cache(cfg.text, b, max_len, input_ids.device)
                return openflamingo_forward(
                    cfg, params, input_ids, attention_mask, latents, prefill_onehot,
                    icv_scaled=icv_scaled, cache=cache, positions=positions,
                    xattn_kv=xattn_kv, last_logit_only=True, prefill_flash=attention_mask,
                )
            rep = b // latents.shape[0]
            if rep not in expanded:
                expanded[rep] = tuple(torch.repeat_interleave(x, rep, dim=1) for x in xattn_kv)
            so = torch.repeat_interleave(step_onehot, rep, dim=0)
            onehot = so.expand(b, input_ids.shape[1], so.shape[-1])
            return openflamingo_forward(
                cfg, params, input_ids, attention_mask, latents, onehot,
                icv_scaled=icv_scaled, cache=cache, positions=positions,
                xattn_kv=expanded[rep],
            )

        return forward_fn

    return train_forward, bind_images


# per-slot media state the continuous-batching engine keeps for the decode
# steps: each key's (batch axis, image axis), as ``idefics.SERVING_MEDIA_AXES``
# (JAX names the batch axis alone, openflamingo.py:546-548)
SERVING_MEDIA_AXES = {"latents": (0, 1), "step_onehot": (0, 2), "xattn_kv": (1, 2)}


def make_openflamingo_serving_fns(cfg: OpenFlamingoConfig, eos_token_id: int):
    """Slot-oriented ``(prefill, decode_step, SERVING_MEDIA_AXES)`` for the
    continuous-batching engine (JAX ``make_openflamingo_serving_fns``,
    openflamingo.py:714-785), with the contract of
    ``idefics.make_idefics_serving_fns``: every decode step cross-attends
    the slot's own media, so the engine keeps ``{latents, step_onehot,
    xattn_kv}`` a slot."""

    def prefill(params, pixel_values, pixel_valid, input_ids, attention_mask,
                icv_scaled, cache_len):
        latents, prefill_onehot, step_onehot, xattn_kv = bind_media(
            cfg, params, pixel_values, pixel_valid, input_ids, eos_token_id)
        positions = _positions_from_mask(attention_mask)
        cache = init_kv_cache(cfg.text, input_ids.shape[0], cache_len, input_ids.device)
        logits, cache = openflamingo_forward(
            cfg, params, input_ids, attention_mask, latents, prefill_onehot,
            icv_scaled=icv_scaled, cache=cache, positions=positions, xattn_kv=xattn_kv,
            last_logit_only=True, prefill_flash=attention_mask,
        )
        media = {"latents": latents, "step_onehot": step_onehot, "xattn_kv": xattn_kv}
        return logits[:, -1, :].float(), cache, media, positions[:, -1] + 1

    def decode_step(params, token_ids, attention_mask, positions, cache, icv_scaled, media):
        b, s = token_ids.shape
        so = media["step_onehot"]
        return openflamingo_forward(
            cfg, params, token_ids, attention_mask, media["latents"],
            so.expand(b, s, so.shape[-1]), icv_scaled=icv_scaled, cache=cache,
            positions=positions, xattn_kv=media["xattn_kv"],
        )

    return prefill, decode_step, SERVING_MEDIA_AXES


def make_openflamingo_merged_admit_fn(cfg: OpenFlamingoConfig, eos_token_id: int):
    """ONE forward of a pool decode step and an admission group's prefill
    for the MPT/ALiBi family (JAX ``make_openflamingo_merged_admit_fn``,
    openflamingo.py:551-711), with the contract of
    ``idefics.make_idefics_merged_admit_fn``.  Each decoder projection, the
    MLP and the tied head pack over both token streams
    (``decoder.merged_decoder_layer``); the gated cross-attention runs per
    lane BEFORE each layer that closes a group (``li % every == every - 1``,
    as ``openflamingo_forward``).  The decode lane's ALiBi bias spans the
    pool cache's columns; the prefill lane's is None wherever the ALiBi
    flash gate passes (``decoder.alibi_bias_for``: the kernel makes it),
    else it spans the fresh cache's."""
    t = cfg.text
    every = cfg.cross_attn_every_n_layers

    def merged_step(params, dec_tok, dec_adv, dec_pos, cache, media, icv_scaled,
                    pixels, pv, ids, mask, cache_len):
        b1 = dec_tok.shape[0]
        b2, s2 = ids.shape
        embed = params["embed"]

        # the prefill lane's bind (ViT-L, perceiver, media K/V)
        latents_p, onehot_p, step_onehot, xkv_p = bind_media(
            cfg, params, pixels, pv, ids, eos_token_id)
        pos_p = _positions_from_mask(mask)
        cache_p = init_kv_cache(t, b2, cache_len, ids.device)

        # per-lane attention views, ALiBi biases and cross-attention masks
        index_d, index_p = cache["index"], cache_p["index"]
        mask_d, cache_pos_d, _ = decode_cache_view(cache, dec_pos, dec_adv, 1)
        mask_p, _, _ = decode_cache_view(cache_p, pos_p, mask, s2)
        bias_d = L.alibi_bias(t.n_heads, dec_pos, cache_pos_d)
        bias_p = alibi_bias_for(t, pos_p, cache_p, mask)
        so = media["step_onehot"]
        xmask_d, gate_d = _xattn_mask(media["latents"], so.expand(b1, 1, so.shape[-1]))
        xmask_p, gate_p = _xattn_mask(latents_p, onehot_p)

        h_d = embed[torch.clamp(dec_tok, 0, embed.shape[0] - 1).long()].to(t.dtype)
        h_p = embed[torch.clamp(ids, 0, embed.shape[0] - 1).long()].to(t.dtype)
        icv = cast_icv(icv_scaled, t.dtype)
        for li in range(t.n_layers):
            if li % every == every - 1:
                g = li // every
                xp = L.layer_slice(params["xattn"], g)
                xkv_d = media["xattn_kv"]
                h_d = flamingo_xattn_block(cfg, xp, h_d, media["latents"], xmask_d, gate_d,
                                           kv=(xkv_d[0][g], xkv_d[1][g]))
                h_p = flamingo_xattn_block(cfg, xp, h_p, latents_p, xmask_p, gate_p,
                                           kv=(xkv_p[0][g], xkv_p[1][g]))
            icv_arg = _icv_row(icv, li)
            h_d, h_p = merged_decoder_layer(
                t, L.layer_slice(params["layers"], li), h_d, h_p, None, None,
                mask_d, (L.layer_slice(cache["k"], li), L.layer_slice(cache["v"], li), index_d),
                mask_p, (L.layer_slice(cache_p["k"], li), L.layer_slice(cache_p["v"], li),
                         index_p),
                mask, icv_arg, icv_arg, bias_d=bias_d, bias_p=bias_p,
            )
        cache["index"] = index_d + 1
        cache_p["index"] = index_p + s2

        # the final norm per lane, one read of the tied head for both lanes'
        # last rows
        h = torch.cat([h_d, h_p[:, -1:, :]], dim=0)
        logits = logits_from_hidden(
            t, params, L.layer_norm(params["final_norm"], params["final_norm_b"], h, t.norm_eps))
        media_p = {"latents": latents_p, "step_onehot": step_onehot, "xattn_kv": xkv_p}
        return (logits[:b1], cache, logits[b1:, -1, :].float(), cache_p, media_p,
                pos_p[:, -1] + 1)

    return merged_step
