"""Idefics2-8B-base: Mistral backbone + SigLIP/NaViT tower + perceiver
connector, image features spliced INLINE into the token stream
(counterpart of ``licv_vqa_tpu/models/idefics2.py``, :1-410).

The ICV injection site is the decoder MLP SUBLAYER output (the reference's
``layer_format: "model.model.text_model.layers.<L>.mlp"``), handled by the
decoder's ``injection_site=MLP_OUTPUT``.

As HF ``Idefics2ForConditionalGeneration``: a SigLIP ViT (post-LN, biased
patch conv, tanh-GELU, NaViT position ids and patch mask), a connector of a
SwiGLU modality projection (vision → text width) and an RMSNorm GQA
perceiver (3 layers, 64 latents), and a Mistral decoder (GQA, 8 KV heads)
run by ``decoder.forward_hidden``.  Each run of 64 ``<image>`` tokens is
replaced by that image's 64 latents through a cumsum gather (HF uses
``masked_scatter``).  The serving functions and the merged admission
forward (JAX :413-597) carry no per-slot media: the latents merge into the
prompt's embeddings at prefill, and decode steps never read them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.int8_matmul import qdot
from . import layers as L
from .config import MLP_OUTPUT, DecoderConfig, VisionConfig
from .decoder import (
    W8A8_MIN_TOKENS,
    _icv_row,
    _norm,
    _positions_from_mask,
    cast_icv,
    decode_cache_view,
    forward_hidden,
    init_decoder_params,
    init_kv_cache,
    logits_from_hidden,
    merged_decoder_layer,
)
from .vision import init_vision_params, vision_forward

IMAGE_SEQ_LEN = 64


@dataclasses.dataclass(frozen=True)
class Idefics2PerceiverCfg:
    n_latents: int = 64
    n_layers: int = 3
    n_heads: int = 16
    n_kv_heads: int = 4
    head_dim: int = 96
    d_model: int = 4096
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class Idefics2Config:
    text: DecoderConfig
    vision: VisionConfig
    perceiver: Idefics2PerceiverCfg
    image_token_id: int = 32001
    image_seq_len: int = IMAGE_SEQ_LEN

    @classmethod
    def idefics2_8b(cls, dtype=torch.bfloat16) -> "Idefics2Config":
        """Idefics2-8B-base shapes (config/lmm/idefics2-8B-base.yaml: 32
        layers, hidden 4096; SigLIP-SO400M tower, Mistral-7B text)."""
        return cls(
            text=DecoderConfig(
                vocab_size=32003, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
                d_ff=14336, norm_eps=1e-5, injection_site=MLP_OUTPUT, dtype=dtype,
            ),
            vision=VisionConfig(
                # 980 = the position table's reference size (70x70 buckets);
                # inputs are variable-resolution (longest edge <= 980,
                # shortest >= 378: the HF Idefics2ImageProcessor defaults)
                image_size=980, patch_size=14, d_model=1152, n_layers=27, n_heads=16,
                d_ff=4304, use_class_token=False, use_pre_norm=False,
                use_post_norm=True, patch_bias=True, activation="gelu_tanh", dtype=dtype,
            ),
            perceiver=Idefics2PerceiverCfg(dtype=dtype),
        )

    @classmethod
    def tiny(cls, dtype=torch.float32) -> "Idefics2Config":
        """Tiny-random config for tests (the JAX ``tiny``'s shapes)."""
        return cls(
            text=DecoderConfig(
                vocab_size=120, d_model=64, n_layers=4, n_heads=4, n_kv_heads=2, d_ff=128,
                norm_eps=1e-5, injection_site=MLP_OUTPUT, dtype=dtype,
            ),
            vision=VisionConfig(
                image_size=28, patch_size=14, d_model=32, n_layers=2, n_heads=2, d_ff=64,
                use_class_token=False, use_pre_norm=False, use_post_norm=True,
                patch_bias=True, activation="gelu_tanh", dtype=dtype,
            ),
            perceiver=Idefics2PerceiverCfg(
                n_latents=4, n_layers=2, n_heads=2, n_kv_heads=1, head_dim=16, d_model=64,
                dtype=dtype,
            ),
            image_token_id=118,
            image_seq_len=4,
        )


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_idefics2_params(generator: torch.Generator, cfg: Idefics2Config, device) -> dict:
    """Random init (N(0, 0.02²) weights, unit norms and latents, zero
    biases) allocated directly on ``device`` in ``cfg``'s dtypes — about
    17 GB at Idefics2-8B width in bf16.  Values differ from ``jax.random``
    for the same seed: tests carry JAX params across with
    ``weights.params_from_jax``."""
    t, p, v = cfg.text, cfg.perceiver, cfg.vision
    n, d, hd = p.n_layers, p.d_model, p.head_dim

    def w(*shape):
        return L.dense_init(generator, shape, t.dtype, device)

    def ones(*shape):
        return torch.ones(shape, dtype=t.dtype, device=device)

    perceiver = {
        "latents": ones(p.n_latents, d),
        "layers": {
            "lat_norm": ones(n, d),
            "ctx_norm": ones(n, d),
            "wq": w(n, d, p.n_heads * hd),
            "wk": w(n, d, p.n_kv_heads * hd),
            "wv": w(n, d, p.n_kv_heads * hd),
            "wo": w(n, p.n_heads * hd, d),
            "post_norm": ones(n, d),
            "mlp": {"w_gate": w(n, d, 4 * d), "w_up": w(n, d, 4 * d), "w_down": w(n, 4 * d, d)},
        },
        "final_norm": ones(d),
    }
    connector = {
        "w_gate": w(v.d_model, t.d_ff),
        "w_up": w(v.d_model, t.d_ff),
        "w_down": w(t.d_ff, t.d_model),
    }
    return {
        **init_decoder_params(generator, t, device),
        "vision": init_vision_params(generator, v, device),
        "connector": connector,
        "perceiver": perceiver,
    }


# ---------------------------------------------------------------------------
# Connector
# ---------------------------------------------------------------------------


def _perceiver_layer(
    cfg: Idefics2PerceiverCfg, p: dict, latents: torch.Tensor, context: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None, a8: bool = False,
) -> torch.Tensor:
    b, nl, _ = latents.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    a8_lat = a8 and nl >= W8A8_MIN_TOKENS  # token-count gates (w8a8)
    a8_kv = a8 and nl + context.shape[1] >= W8A8_MIN_TOKENS
    lat = L.rms_norm(p["lat_norm"], latents, cfg.norm_eps)
    ctx = L.rms_norm(p["ctx_norm"], context, cfg.norm_eps)
    kv_in = torch.cat([ctx, lat], dim=1)
    q = qdot(lat, p["wq"], a8=a8_lat).reshape(b, nl, nh, hd)
    k = qdot(kv_in, p["wk"], a8=a8_kv).reshape(b, -1, nkv, hd)
    v = qdot(kv_in, p["wv"], a8=a8_kv).reshape(b, -1, nkv, hd)
    attn = L.dot_product_attention(
        q, L.repeat_kv(k, nh // nkv), L.repeat_kv(v, nh // nkv), mask=kv_mask
    )
    latents = latents + qdot(attn.reshape(b, nl, nh * hd), p["wo"], a8=a8_lat).to(latents.dtype)
    x = L.rms_norm(p["post_norm"], latents, cfg.norm_eps)
    return latents + L.swiglu_mlp(p["mlp"], x, a8=a8_lat)


def patch_mask_from_pixel_mask(pixel_mask: torch.Tensor, patch: int) -> torch.Tensor:
    """(B*, H, W) pixel validity → (B*, gh, gw) patch validity: a patch is
    valid iff ALL its pixels are (HF ``Idefics2Model.get_image_features``)."""
    b = pixel_mask.shape[0]
    gh, gw = pixel_mask.shape[1] // patch, pixel_mask.shape[2] // patch
    sub = pixel_mask.reshape(b, gh, patch, gw, patch).to(torch.int32)
    return sub.sum(dim=(2, 4)) == patch * patch


def encode_images2(
    cfg: Idefics2Config,
    params: dict,
    pixel_values: torch.Tensor,  # (B, N_img, H, W, 3)
    pixel_attention_mask: Optional[torch.Tensor] = None,  # (B, N_img, H, W)
) -> torch.Tensor:
    """Per-image latents (B, N_img, image_seq_len, D).

    NaViT variable resolution: images are resized preserving their aspect
    and batch-padded on the host; ``pixel_attention_mask`` marks the real
    pixels.  Padded patches are masked out of the tower's attention and out
    of the perceiver's context keys (HF semantics).  Under ``w8a8_prefill``
    the connector and perceiver take w8a8 and the tower does not, as in
    JAX."""
    b, n_img = pixel_values.shape[:2]
    flat = pixel_values.reshape((b * n_img,) + tuple(pixel_values.shape[2:]))
    patch_mask = None
    if pixel_attention_mask is not None:
        pm = pixel_attention_mask.reshape((b * n_img,) + tuple(pixel_attention_mask.shape[2:]))
        patch_mask = patch_mask_from_pixel_mask(pm, cfg.vision.patch_size)
    a8 = cfg.text.w8a8_prefill
    feats = vision_forward(cfg.vision, params["vision"], flat, patch_mask=patch_mask, a8=False)
    feats = L.swiglu_mlp(  # modality projection
        params["connector"], feats, a8=a8 and feats.shape[1] >= W8A8_MIN_TOKENS
    )
    pcfg = cfg.perceiver
    latents = params["perceiver"]["latents"][None].expand(
        feats.shape[0], pcfg.n_latents, pcfg.d_model
    ).to(feats.dtype)
    kv_mask = None
    if patch_mask is not None:
        ctx_valid = patch_mask.reshape(b * n_img, -1)
        lat_valid = torch.ones((b * n_img, pcfg.n_latents), dtype=torch.bool, device=feats.device)
        kv_mask = torch.cat([ctx_valid, lat_valid], dim=1)[:, None, None, :]
    layers = params["perceiver"]["layers"]
    for i in range(pcfg.n_layers):
        latents = _perceiver_layer(
            pcfg, L.layer_slice(layers, i), latents, feats, kv_mask=kv_mask, a8=a8
        )
    latents = L.rms_norm(params["perceiver"]["final_norm"], latents, pcfg.norm_eps)
    return latents.reshape(b, n_img, pcfg.n_latents, pcfg.d_model)


def merge_image_embeds(
    input_ids: torch.Tensor,  # (B, S)
    inputs_embeds: torch.Tensor,  # (B, S, D)
    image_latents: torch.Tensor,  # (B, N_img, image_seq_len, D)
    image_token_id: int,
) -> torch.Tensor:
    """Replace the k-th ``<image>`` token with the k-th flattened latent:
    the static-shape form of HF's ``masked_scatter``."""
    b, s, d = inputs_embeds.shape
    flat = image_latents.reshape(b, -1, d)
    is_img = input_ids == image_token_id
    k = torch.cumsum(is_img.to(torch.int32), dim=1) - 1
    k = torch.clamp(k, 0, flat.shape[1] - 1).long()
    gathered = torch.gather(flat, 1, k[:, :, None].expand(b, s, d))
    return torch.where(is_img[:, :, None], gathered.to(inputs_embeds.dtype), inputs_embeds)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def idefics2_forward(
    cfg: Idefics2Config,
    params: dict,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    image_latents: Optional[torch.Tensor],  # None for decode steps
    icv_scaled=None,  # (L, D) rows, ((L, D) rows, [L] host flags), or None
    cache: Optional[dict] = None,
    positions: Optional[torch.Tensor] = None,
    remat: bool = False,
    prefill_flash: Optional[torch.Tensor] = None,
    last_logit_only: bool = False,  # decode prefill: skip S-1 lm_head rows
    return_hidden: bool = False,  # post-norm hidden in place of the logits
):
    """Returns ``(logits f32 (B, s|1, V), cache)``; see
    ``decoder.forward_hidden`` for the cache, ``prefill_flash`` and
    ``remat``."""
    # out-of-range ids clamp, as JAX gathers do
    ids = torch.clamp(input_ids, 0, params["embed"].shape[0] - 1).long()
    embeds = params["embed"][ids].to(cfg.text.dtype)
    if image_latents is not None:
        embeds = merge_image_embeds(input_ids, embeds, image_latents, cfg.image_token_id)
    h, cache = forward_hidden(
        cfg.text, params, embeds, attention_mask, icv_scaled=icv_scaled, cache=cache,
        positions=positions, remat=remat, prefill_flash=prefill_flash,
    )
    if last_logit_only:
        h = h[:, -1:, :]  # left-padded decode prompts: the last position is live
    if return_hidden:
        return h, cache
    return logits_from_hidden(cfg.text, params, h), cache


def _bound_latents(cfg: Idefics2Config, params: dict, pixel_values, pixel_valid,
                   pixel_attention_mask):
    """The bind's latents: the tower, the connector and the perceiver, a
    padded image slot's latents zeroed."""
    latents = encode_images2(cfg, params, pixel_values, pixel_attention_mask=pixel_attention_mask)
    return latents * pixel_valid[:, :, None, None].to(latents.dtype)


def make_idefics2_forward_fns(cfg: Idefics2Config, eos_token_id: int):
    """``(train_forward, bind_images)`` with the contracts of
    ``idefics.make_idefics_forward_fns`` (JAX idefics2.py:341-410); both
    take the optional NaViT ``pixel_attention_mask`` (in ``inputs`` for the
    train forward, as a keyword for the bind).  Inline image tokens need no
    EOS-dependent image masking, so ``eos_token_id`` is unused."""
    del eos_token_id

    def train_forward(params, inputs, icv_scaled, return_hidden=False):
        latents = _bound_latents(cfg, params, inputs["pixel_values"], inputs["pixel_valid"],
                                 inputs.get("pixel_attention_mask"))
        out, _ = idefics2_forward(
            cfg, params, inputs["input_ids"], inputs["attention_mask"], latents,
            icv_scaled=icv_scaled, remat=True, return_hidden=return_hidden,
        )
        return out

    def bind_images(
        params, pixel_values, pixel_valid, prompt_ids, icv_scaled, max_len,
        pixel_attention_mask=None,
    ):
        del prompt_ids
        latents = _bound_latents(cfg, params, pixel_values, pixel_valid, pixel_attention_mask)

        def forward_fn(input_ids, attention_mask, positions, cache):
            if cache is None:  # prefill into a fresh cache
                cache = init_kv_cache(cfg.text, input_ids.shape[0], max_len, input_ids.device)
                return idefics2_forward(
                    cfg, params, input_ids, attention_mask, latents, icv_scaled=icv_scaled,
                    cache=cache, positions=positions, prefill_flash=attention_mask,
                    last_logit_only=True,
                )
            # image tokens occur only in the prompt
            return idefics2_forward(
                cfg, params, input_ids, attention_mask, None, icv_scaled=icv_scaled,
                cache=cache, positions=positions,
            )

        return forward_fn

    return train_forward, bind_images


# no per-slot media: the image latents merge into the prompt's embeddings at
# prefill and never feed a decode step, so the engines scatter nothing
SERVING_MEDIA_AXES: dict = {}


def make_idefics2_serving_fns(cfg: Idefics2Config, eos_token_id: int):
    """Slot-oriented ``(prefill, decode_step, SERVING_MEDIA_AXES)`` for the
    continuous-batching engines (JAX ``make_idefics2_serving_fns``,
    idefics2.py:542-597), with the contract of
    ``idefics.make_idefics_serving_fns``; ``media`` is ``{}`` both ways.
    NaViT variable resolution rides the prefill's optional
    ``pixel_attention_mask`` (the engine passes each admission group's
    stacked masks; mixed resolutions admit as groups of one shape)."""
    del eos_token_id  # inline image tokens need no EOS-dependent masking

    def prefill(params, pixel_values, pixel_valid, input_ids, attention_mask, icv_scaled,
                cache_len, pixel_attention_mask=None):
        latents = _bound_latents(cfg, params, pixel_values, pixel_valid, pixel_attention_mask)
        positions = _positions_from_mask(attention_mask)
        cache = init_kv_cache(cfg.text, input_ids.shape[0], cache_len, input_ids.device)
        logits, cache = idefics2_forward(
            cfg, params, input_ids, attention_mask, latents, icv_scaled=icv_scaled, cache=cache,
            positions=positions, prefill_flash=attention_mask, last_logit_only=True,
        )
        return logits[:, -1, :].float(), cache, {}, positions[:, -1] + 1

    def decode_step(params, token_ids, attention_mask, positions, cache, icv_scaled, media):
        del media
        return idefics2_forward(cfg, params, token_ids, attention_mask, None,
                                icv_scaled=icv_scaled, cache=cache, positions=positions)

    return prefill, decode_step, SERVING_MEDIA_AXES


def make_idefics2_merged_admit_fn(cfg: Idefics2Config, eos_token_id: int):
    """ONE forward of a pool decode step and an admission group's prefill,
    every decoder projection and the MLP packed over both token streams
    (``decoder.merged_decoder_layer``; JAX ``make_idefics2_merged_admit_fn``,
    idefics2.py:418-539), with the contract of
    ``idefics.make_idefics_merged_admit_fn`` plus the prefill lane's
    optional NaViT ``pixel_attention_mask``; both media dicts are ``{}``.

    The prefill lane's embeddings are its bind (the tower, the connector and
    the perceiver) merged inline (``merge_image_embeds``); the decode lane
    has no media.  Rope and the cache view are per lane (the pool's per-row
    index, the fresh cache's columns from 0); GQA's 8 KV heads and the ICV
    at the MLP output pass through the packed layer as they are.  Both
    lanes' last rows go through one head matmul.  Weight-only matmuls."""
    del eos_token_id
    t = cfg.text

    def merged_step(params, dec_tok, dec_adv, dec_pos, cache, media, icv_scaled,
                    pixels, pv, ids, mask, cache_len, pixel_attention_mask=None):
        del media
        b1 = dec_tok.shape[0]
        b2, s2 = ids.shape
        embed = params["embed"]

        latents = _bound_latents(cfg, params, pixels, pv, pixel_attention_mask)
        h_p = merge_image_embeds(
            ids, embed[torch.clamp(ids, 0, embed.shape[0] - 1).long()].to(t.dtype), latents,
            cfg.image_token_id,
        )
        h_d = embed[torch.clamp(dec_tok, 0, embed.shape[0] - 1).long()].to(t.dtype)
        pos_p = _positions_from_mask(mask)
        cache_p = init_kv_cache(t, b2, cache_len, ids.device)

        index_d, index_p = cache["index"], cache_p["index"]
        mask_d, _, _ = decode_cache_view(cache, dec_pos, dec_adv, 1)
        mask_p, _, _ = decode_cache_view(cache_p, pos_p, mask, s2)
        rope_d = L.rope_cos_sin(dec_pos, t.head_dim, t.rope_theta)
        rope_p = L.rope_cos_sin(pos_p, t.head_dim, t.rope_theta)
        icv = cast_icv(icv_scaled, t.dtype)
        for li in range(t.n_layers):
            icv_arg = _icv_row(icv, li)
            h_d, h_p = merged_decoder_layer(
                t, L.layer_slice(params["layers"], li), h_d, h_p, rope_d, rope_p,
                mask_d, (L.layer_slice(cache["k"], li), L.layer_slice(cache["v"], li), index_d),
                mask_p, (L.layer_slice(cache_p["k"], li), L.layer_slice(cache_p["v"], li),
                         index_p),
                mask, icv_arg, icv_arg,
            )
        cache["index"] = index_d + 1
        cache_p["index"] = index_p + s2

        # the final norm per lane, one head matmul for both lanes' last rows
        h = _norm(t, params["final_norm"], params.get("final_norm_b"),
                  torch.cat([h_d, h_p[:, -1:, :]], dim=0))
        logits = logits_from_hidden(t, params, h)
        return logits[:b1], cache, logits[b1:, -1, :].float(), cache_p, {}, pos_p[:, -1] + 1

    return merged_step
