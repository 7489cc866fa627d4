"""Idefics-9B: LLaMA backbone + CLIP ViT-H tower + perceiver + gated
cross-attention, with the ICV injected at the decoder-block output
(counterpart of ``licv_vqa_tpu/models/idefics.py``, cached path).

As in JAX (and HF ``IdeficsForVisionText2Text``):

- gated cross-attention runs BEFORE decoder layer ``i`` when
  ``i % cross_layer_interval == 0``;
- each text token cross-attends ONLY to the most recent preceding image
  (one-hot from ``<image>`` positions), output gated by ``tanh(alpha)`` and
  zeroed for tokens with no preceding image;
- per-head-dim RMSNorm on q/k in the gated cross-attention only.

Both forwards are ported: the cached one (prefill + decode) and the
grouped no-cache train forward, which checkpoints for the backward where
JAX's ``jax.checkpoint`` sits (``IdeficsConfig.remat_mode``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..ops.int8_matmul import qdot
from . import layers as L
from .config import BLOCK_OUTPUT, DecoderConfig, PerceiverConfig, VisionConfig
from .decoder import (
    W8A8_MIN_TOKENS,
    _icv_row,
    _positions_from_mask,
    cast_icv,
    decode_cache_view,
    decoder_layer,
    init_kv_cache,
    init_layer_params,
    logits_from_hidden,
    merged_decoder_layer,
)
from .perceiver import init_perceiver_params, perceiver_forward
from .vision import init_vision_params, vision_forward


@dataclasses.dataclass(frozen=True)
class IdeficsConfig:
    text: DecoderConfig
    vision: VisionConfig
    perceiver: PerceiverConfig
    cross_layer_interval: int = 4
    qk_layer_norms: bool = False
    qk_layer_norms_perceiver: bool = False
    alpha_type: str = "float"  # "float" | "vector"
    additional_vocab_size: int = 2
    image_token_id: int = 32001  # <image> in the extended vocab
    use_resampler: bool = True
    # train-forward recompute structure (JAX ``remat_mode``): "both" =
    # checkpoint each group of (cross-attention block + ``interval`` layers)
    # and, inside it, each layer; "inner" = each layer; "outer" = each
    # group; "policy" = each layer, keeping the weight matmuls' outputs and
    # recomputing the rest; "none" = no recompute.  The cross-attention
    # block is checkpointed under every mode but "none".
    remat_mode: str = "both"

    @classmethod
    def idefics_9b(cls, dtype=torch.bfloat16) -> "IdeficsConfig":
        """Idefics-9B shapes (config/lmm/idefics-9B.yaml: 32 layers, hidden
        4096; vision = OpenCLIP ViT-H/14)."""
        return cls(
            text=DecoderConfig(
                vocab_size=32002, d_model=4096, n_layers=32, n_heads=32,
                n_kv_heads=32, d_ff=11008, injection_site=BLOCK_OUTPUT, dtype=dtype,
            ),
            vision=VisionConfig(
                image_size=224, patch_size=14, d_model=1280, n_layers=32,
                n_heads=16, d_ff=5120, dtype=dtype,
            ),
            perceiver=PerceiverConfig(
                n_latents=64, n_layers=6, n_heads=16, head_dim=96, d_model=1280,
                d_ff=5120, dtype=dtype,
            ),
            cross_layer_interval=4,
            qk_layer_norms=True,
            qk_layer_norms_perceiver=True,
            additional_vocab_size=2,
            image_token_id=32001,
        )

    @classmethod
    def tiny(cls, dtype=torch.float32) -> "IdeficsConfig":
        """Tiny-random config for tests (same shapes as the JAX ``tiny``)."""
        return cls(
            text=DecoderConfig(
                vocab_size=110, d_model=64, n_layers=4, n_heads=4, n_kv_heads=4,
                d_ff=128, dtype=dtype,
            ),
            vision=VisionConfig(
                image_size=28, patch_size=14, d_model=32, n_layers=2, n_heads=2,
                d_ff=64, dtype=dtype,
            ),
            perceiver=PerceiverConfig(
                n_latents=4, n_layers=2, n_heads=2, head_dim=16, d_model=32,
                d_ff=64, dtype=dtype,
            ),
            cross_layer_interval=2,
            qk_layer_norms=True,
            qk_layer_norms_perceiver=True,
            additional_vocab_size=2,
            image_token_id=108,
        )


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_xattn_params(
    generator: torch.Generator, cfg: IdeficsConfig, n_xattn: int, device
) -> dict:
    t = cfg.text
    d, de = t.d_model, cfg.perceiver.d_model
    nh, dh, f = t.n_heads, t.head_dim, t.d_ff

    def w(*shape):
        return L.dense_init(generator, (n_xattn, *shape), t.dtype, device)

    def full(value, *shape):
        return torch.full((n_xattn, *shape), value, dtype=t.dtype, device=device)

    alpha_shape = (d,) if cfg.alpha_type == "vector" else ()
    p = {
        "ln1": full(1.0, d),
        "ln2": full(1.0, d),
        "attn": {
            "wq": w(d, nh * dh),
            "wk": w(de, nh * dh),
            "wv": w(de, nh * dh),
            "wo": w(nh * dh, d),
        },
        "mlp": {"w_gate": w(d, f), "w_up": w(d, f), "w_down": w(f, d)},
        "alpha_xattn": full(0.0, *alpha_shape),
        "alpha_dense": full(0.0, *alpha_shape),
    }
    if cfg.qk_layer_norms:
        p["attn"]["q_norm"] = full(1.0, dh)
        p["attn"]["k_norm"] = full(1.0, dh)
    return p


def init_idefics_params(
    generator: torch.Generator, cfg: IdeficsConfig, device
) -> dict:
    """Random init (N(0, 0.02²) weights, unit norms, zero gates) allocated
    directly on ``device`` in ``cfg``'s dtypes — about 18 GB at Idefics-9B
    width in bf16.  Values differ from ``jax.random`` for the same seed:
    tests carry JAX params across with ``weights.params_from_jax``."""
    t = cfg.text
    return {
        "embed": L.dense_init(generator, (t.vocab_size, t.d_model), t.dtype, device),
        "layers": init_layer_params(generator, t, t.n_layers, device),
        "xattn": init_xattn_params(
            generator, cfg, t.n_layers // cfg.cross_layer_interval, device
        ),
        "final_norm": torch.ones((t.d_model,), dtype=t.dtype, device=device),
        "lm_head": L.dense_init(generator, (t.d_model, t.vocab_size), t.dtype, device),
        "vision": init_vision_params(generator, cfg.vision, device),
        "perceiver": init_perceiver_params(
            generator, cfg.perceiver, cfg.qk_layer_norms_perceiver, device
        ),
    }


# ---------------------------------------------------------------------------
# Image attention plumbing
# ---------------------------------------------------------------------------


def _one_hot(index: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot; an index outside [0, n) gives an all-zero row, as
    ``jax.nn.one_hot`` does."""
    return (index[..., None] == torch.arange(n, device=index.device)).float()


def image_attention_onehot(
    input_ids: torch.Tensor, image_token_id: int, eos_token_id: int, n_images: int
) -> torch.Tensor:
    """(B, S, N_img) one-hot: each token attends to the most recent preceding
    ``<image>`` token (HF ``image_attention_mask_for_packed_input_ids``):
    tokens strictly after an EOS attend to none UNTIL the next ``<image>``
    resets the EOS state, so EOS-packed multi-episode sequences keep
    per-episode image attention."""
    b, s = input_ids.shape
    is_img = input_ids == image_token_id
    count = torch.cumsum(is_img.to(torch.int32), dim=1) - 1  # -1 before any
    pos = torch.arange(s, dtype=torch.int32, device=input_ids.device)[None, :].expand(b, s)
    neg = torch.full_like(pos, -1)
    img_pos = torch.cummax(torch.where(is_img, pos, neg), dim=1).values
    eos_cm = torch.cummax(torch.where(input_ids == eos_token_id, pos, neg), dim=1).values
    # the EOS position itself still attends (HF checks seen_eod BEFORE
    # setting it): compare against the most recent eos STRICTLY before t
    eos_excl = torch.cat([neg[:, :1], eos_cm[:, :-1]], dim=1)
    valid = img_pos > eos_excl  # also false while img_pos == -1 (no image)
    onehot = _one_hot(torch.clamp(count, min=0), n_images)
    return onehot * valid[:, :, None].float()


def last_image_onehot(
    input_ids: torch.Tensor, image_token_id: int, n_images: int
) -> torch.Tensor:
    """(B, 1, N_img) one-hot of the LAST image in the prompt — the mask every
    generated token uses during decode."""
    count = torch.sum((input_ids == image_token_id).to(torch.int32), dim=1) - 1
    onehot = _one_hot(torch.clamp(count, min=0), n_images)
    return (onehot * (count >= 0)[:, None].float())[:, None, :]


def encode_images(
    cfg: IdeficsConfig, params: dict, pixel_values: torch.Tensor
) -> torch.Tensor:
    """(B, N_img, H, W, 3) → image latents (B, N_img·n_lat, De).  Under
    ``w8a8_prefill`` the perceiver takes w8a8 and the tower does not (JAX
    measured the tower's per-row activation quantization costing more than
    it saves, idefics.py:267-273); a quantized tower stays weight-only."""
    b, n_img = pixel_values.shape[:2]
    flat = pixel_values.reshape((b * n_img,) + tuple(pixel_values.shape[2:]))
    feats = vision_forward(cfg.vision, params["vision"], flat, a8=False)
    if cfg.use_resampler:
        feats = perceiver_forward(
            cfg.perceiver, params["perceiver"], feats, a8=cfg.text.w8a8_prefill
        )
    return feats.reshape(b, n_img * feats.shape[1], feats.shape[2])


# ---------------------------------------------------------------------------
# Gated cross-attention block
# ---------------------------------------------------------------------------


def gated_xattn_block(
    cfg: IdeficsConfig,
    p: dict,  # one block's params
    h: torch.Tensor,  # (B, S, D)
    image_latents: Optional[torch.Tensor],  # (B, Nk, De); unused when kv given
    img_mask: torch.Tensor,  # (B, 1, S, Nk) bool
    gate: torch.Tensor,  # (B, S) 1.0 where the token attends ≥1 image
    kv: Optional[tuple] = None,  # precomputed (k, v) each (B, Nk, nh, dh)
) -> torch.Tensor:
    t = cfg.text
    b, s, d = h.shape
    nh, dh = t.n_heads, t.head_dim
    a8 = t.w8a8_prefill and s >= W8A8_MIN_TOKENS  # token-count gates
    x = L.rms_norm(p["ln1"], h, t.norm_eps)
    q = qdot(x, p["attn"]["wq"], a8=a8).reshape(b, s, nh, dh)
    if "q_norm" in p["attn"]:
        q = L.rms_norm(p["attn"]["q_norm"], q, t.norm_eps)
    if kv is not None:
        k, v = kv  # decode-invariant image K/V, k_norm applied at bind time
    else:
        a8_img = t.w8a8_prefill and image_latents.shape[1] >= W8A8_MIN_TOKENS
        k = qdot(image_latents, p["attn"]["wk"], a8=a8_img).reshape(b, -1, nh, dh)
        v = qdot(image_latents, p["attn"]["wv"], a8=a8_img).reshape(b, -1, nh, dh)
        if "k_norm" in p["attn"]:
            k = L.rms_norm(p["attn"]["k_norm"], k, t.norm_eps)
    # a token before the first <image> has a fully masked row: the softmax
    # over finfo.min scores is uniform (finite) and the gate zeroes it
    attn = L.dot_product_attention(q, k, v, mask=img_mask)
    attn = qdot(attn.reshape(b, s, nh * dh), p["attn"]["wo"], a8=a8).to(h.dtype)
    attn = attn * gate[:, :, None].to(attn.dtype)
    h = h + torch.tanh(p["alpha_xattn"]).to(h.dtype) * attn
    mlp = L.swiglu_mlp(p["mlp"], L.rms_norm(p["ln2"], h, t.norm_eps), a8=a8)
    return h + torch.tanh(p["alpha_dense"]).to(h.dtype) * mlp


def precompute_xattn_kv(
    cfg: IdeficsConfig, params: dict, image_latents: torch.Tensor
) -> tuple:
    """K/V projections of the image latents for EVERY gated-xattn block,
    (G, B, Nk, nh, dh) each, with k_norm applied.  The latents never change
    during decode, so these matmuls run once per bind."""
    t = cfg.text
    b, n_k = image_latents.shape[:2]
    nh, dh = t.n_heads, t.head_dim
    a8 = t.w8a8_prefill and n_k >= W8A8_MIN_TOKENS
    ks, vs = [], []
    n_groups = t.n_layers // cfg.cross_layer_interval
    for g in range(n_groups):
        attn = L.layer_slice(params["xattn"]["attn"], g)
        k = qdot(image_latents, attn["wk"], a8=a8).reshape(b, n_k, nh, dh)
        v = qdot(image_latents, attn["wv"], a8=a8).reshape(b, n_k, nh, dh)
        if "k_norm" in attn:
            k = L.rms_norm(attn["k_norm"], k, t.norm_eps)
        ks.append(k.to(t.dtype))
        vs.append(v.to(t.dtype))
    return torch.stack(ks), torch.stack(vs)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _xattn_mask(image_latents: torch.Tensor, onehot: torch.Tensor) -> tuple:
    """``(mask (B, 1, s, Nk) bool, gate (B, s) f32)`` of the gated
    cross-attention: each token's image one-hot spread over that image's
    latents, and whether it sees any image."""
    n_lat = image_latents.shape[1] // onehot.shape[-1]
    xmask = torch.repeat_interleave(onehot, n_lat, dim=-1) > 0
    return xmask[:, None, :, :], torch.any(xmask, dim=-1).float()


def idefics_forward(
    cfg: IdeficsConfig,
    params: dict,
    input_ids: torch.Tensor,  # (B, s)
    attention_mask: torch.Tensor,  # (B, s)
    image_latents: torch.Tensor,  # (B0, N_img·n_lat, De) from encode_images
    image_attn_onehot: torch.Tensor,  # (B, s, N_img) incl. pixel_valid masking
    cache: Optional[dict] = None,
    positions: Optional[torch.Tensor] = None,
    icv_scaled=None,  # (L, D) rows, ((L, D) rows, [L] host flags), or None
    prefill_flash: Optional[torch.Tensor] = None,
    xattn_kv: Optional[tuple] = None,  # precomputed (G, B, Nk, nh, dh) k/v
    last_logit_only: bool = False,  # decode prefill: skip S-1 lm_head rows
    remat: bool = False,  # train forward: recompute per cfg.remat_mode
    return_hidden: bool = False,  # train forward: post-norm hidden, no head
):
    """Returns ``(logits f32 (B, s|1, V), cache)``.

    With a ``cache``: writes this block's K/V into it in place.
    ``prefill_flash`` (the attention mask) marks a prefill into an EMPTY
    cache, which enables the flash kernel.  With ``xattn_kv``,
    ``image_latents`` only sets the latent count per image and may have any
    batch size.

    Without one: the grouped train forward (JAX :508-577), ``cache`` comes
    back None; ``return_hidden`` gives the post-norm hidden states in place
    of the logits."""
    t = cfg.text
    interval = cfg.cross_layer_interval
    n_groups = t.n_layers // interval
    b, s = input_ids.shape

    # out-of-range ids clamp, as JAX gathers do
    ids = torch.clamp(input_ids, 0, params["embed"].shape[0] - 1).long()
    h = params["embed"][ids].to(t.dtype)

    xmask, gate = _xattn_mask(image_latents, image_attn_onehot)
    icv = cast_icv(icv_scaled, t.dtype)  # as JAX casts it (idefics.py:424-434)
    if cache is None:
        h = _grouped_train_forward(
            cfg, params, h, attention_mask, image_latents, xmask, gate, icv,
            cfg.remat_mode if remat and torch.is_grad_enabled() else "none",
        )
        h = L.rms_norm(params["final_norm"], h, t.norm_eps)
        if return_hidden:
            return h, None
        return logits_from_hidden(t, params, h), None

    index = cache["index"]
    mask, _, _ = decode_cache_view(cache, positions, attention_mask, s)
    cos, sin = L.rope_cos_sin(positions, t.head_dim, t.rope_theta)
    for li in range(t.n_layers):
        if li % interval == 0 and li // interval < n_groups:
            g = li // interval
            kv_g = (xattn_kv[0][g], xattn_kv[1][g]) if xattn_kv is not None else None
            h = gated_xattn_block(
                cfg, L.layer_slice(params["xattn"], g), h, image_latents, xmask,
                gate, kv=kv_g,
            )
        h = decoder_layer(
            t, L.layer_slice(params["layers"], li), h, cos, sin, mask, _icv_row(icv, li),
            kv_write=(L.layer_slice(cache["k"], li), L.layer_slice(cache["v"], li), index),
            flash_valid=prefill_flash,
        )
    cache["index"] = index + s
    h = L.rms_norm(params["final_norm"], h, t.norm_eps)
    if last_logit_only:
        # prompts are LEFT-padded for decode: the last position is the
        # continuation point
        h = h[:, -1:, :]
    return logits_from_hidden(t, params, h), cache


# the weight matmuls: a 2-D ``x @ w`` dispatches as mm (addmm with a bias);
# attention's batched products are bmm
_WEIGHT_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_weight_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_mode=policy``, the counterpart
    of ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the outputs of the products without batch dims, recompute the rest.
    Kernels launched through ctypes or Triton are not aten ops: they rerun
    in the recompute, and the ``torch.empty`` they write into is recomputed
    with them, never kept."""
    if op in _WEIGHT_MATMULS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _grouped_train_forward(cfg, params, h, attention_mask, image_latents, xmask, gate, icv, mode):
    """The no-cache decoder stack as JAX's grouped scan: per group, one
    gated cross-attention block then ``interval`` decoder layers.
    ``torch.utils.checkpoint`` stands where ``jax.checkpoint`` does
    (JAX idefics.py:545-574).  The flash branch is gated on the attention
    mask as the JAX train forward gates it."""
    t = cfg.text
    interval = cfg.cross_layer_interval
    n_groups = t.n_layers // interval
    if n_groups * interval != t.n_layers:
        raise ValueError(
            f"idefics train forward needs n_layers ({t.n_layers}) divisible by "
            f"cross_layer_interval ({interval}): layers run in groups"
        )
    if mode not in ("both", "inner", "outer", "policy", "none"):
        raise ValueError(f"remat_mode must be both|inner|outer|none|policy, got {mode!r}")
    positions = _positions_from_mask(attention_mask)
    mask = L.causal_mask(positions, positions, attention_mask.bool())
    cos, sin = L.rope_cos_sin(positions, t.head_dim, t.rope_theta)

    def run(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False)

    def run_policy(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _save_weight_matmuls))

    def group_body(h, g):
        xp = L.layer_slice(params["xattn"], g)

        def xattn_fn(hh):
            return gated_xattn_block(cfg, xp, hh, image_latents, xmask, gate)

        h = xattn_fn(h) if mode == "none" else run(xattn_fn, h)
        for li in range(g * interval, (g + 1) * interval):
            p_l = L.layer_slice(params["layers"], li)

            def layer_fn(hh, icv_arg, p_l=p_l):
                return decoder_layer(
                    t, p_l, hh, cos, sin, mask, icv_arg, flash_valid=attention_mask
                )

            icv_arg = _icv_row(icv, li)
            if mode in ("both", "inner"):
                h = run(layer_fn, h, icv_arg)
            elif mode == "policy":
                h = run_policy(layer_fn, h, icv_arg)
            else:
                h = layer_fn(h, icv_arg)
        return h

    for g in range(n_groups):
        h = run(group_body, h, g) if mode in ("both", "outer") else group_body(h, g)
    return h


def make_idefics_forward_fns(cfg: IdeficsConfig, eos_token_id: int):
    """``(train_forward, bind_images)``, as JAX's ``make_idefics_forward_fns``
    (idefics.py:580-668).

    ``train_forward(params, inputs, icv_scaled, return_hidden=False)`` runs
    the no-cache forward over a batch dict (``input_ids``,
    ``attention_mask``, ``pixel_values``, ``pixel_valid``) with recompute on.

    ``bind_images(params, pixel_values, pixel_valid, prompt_ids, icv_scaled,
    max_len)`` encodes the images once and returns
    ``forward_fn(input_ids, attention_mask, positions, cache)`` for the
    decode loops: ``cache=None`` is the prefill (a fresh cache of
    ``max_len`` columns); later calls decode against the returned cache,
    whose batch may be beam-expanded (a multiple of the prompt batch)."""

    def train_forward(params, inputs, icv_scaled, return_hidden=False):
        latents = encode_images(cfg, params, inputs["pixel_values"])
        onehot = image_attention_onehot(
            inputs["input_ids"], cfg.image_token_id, eos_token_id,
            inputs["pixel_values"].shape[1],
        )
        onehot = onehot * inputs["pixel_valid"][:, None, :].float()
        out, _ = idefics_forward(
            cfg, params, inputs["input_ids"], inputs["attention_mask"], latents, onehot,
            icv_scaled=icv_scaled, remat=True, return_hidden=return_hidden,
        )
        return out

    def bind_images(params, pixel_values, pixel_valid, prompt_ids, icv_scaled, max_len):
        latents = encode_images(cfg, params, pixel_values)
        n_img = pixel_values.shape[1]
        pv = pixel_valid[:, None, :].float()
        prefill_onehot = (
            image_attention_onehot(prompt_ids, cfg.image_token_id, eos_token_id, n_img)
            * pv
        )
        step_onehot = last_image_onehot(prompt_ids, cfg.image_token_id, n_img) * pv
        xattn_kv = precompute_xattn_kv(cfg, params, latents)
        expanded = {1: xattn_kv}  # beam-expanded image K/V, built once per factor

        def forward_fn(input_ids, attention_mask, positions, cache):
            b = input_ids.shape[0]
            if cache is None:
                cache = init_kv_cache(cfg.text, b, max_len, input_ids.device)
                return idefics_forward(
                    cfg, params, input_ids, attention_mask, latents, prefill_onehot,
                    cache, positions, icv_scaled=icv_scaled,
                    prefill_flash=attention_mask, xattn_kv=xattn_kv,
                    last_logit_only=True,
                )
            rep = b // latents.shape[0]
            if rep not in expanded:
                expanded[rep] = tuple(
                    torch.repeat_interleave(x, rep, dim=1) for x in xattn_kv
                )
            so = torch.repeat_interleave(step_onehot, rep, dim=0)
            onehot = so.expand(b, input_ids.shape[1], so.shape[-1])
            return idefics_forward(
                cfg, params, input_ids, attention_mask, latents, onehot, cache,
                positions, icv_scaled=icv_scaled, xattn_kv=expanded[rep],
            )

        return forward_fn

    return train_forward, bind_images


# per-slot media state the continuous-batching engine keeps for the decode
# steps (infer/serving.py): each key's (batch axis, image axis).  JAX's dict
# names the batch axis alone (idefics.py:675) and sizes the buffers from
# ``jax.eval_shape``; the port sizes them from the first admission's
# outputs, so it also names the axis whose length is the image count times
# a per-image width (latents and image K/V: n_latents; the step one-hot: 1)
SERVING_MEDIA_AXES = {"latents": (0, 1), "step_onehot": (0, 2), "xattn_kv": (1, 2)}


def make_idefics_serving_fns(cfg: IdeficsConfig, eos_token_id: int):
    """Slot-oriented ``(prefill, decode_step, SERVING_MEDIA_AXES)`` for the
    continuous-batching engine (JAX ``make_idefics_serving_fns``,
    idefics.py:851-933).  Unlike ``bind_images``, which closes over one
    batch's media, these keep the media explicit, so the engine can scatter
    it into per-slot buffers at admission and feed the whole pool at decode:

    - ``prefill(params, pixels, pixel_valid, input_ids, attention_mask,
      icv_scaled, cache_len) -> (last_logits f32 (B, V), cache, media,
      next_pos (B,))`` encodes the images, binds them and prefills into a
      FRESH cache of ``cache_len`` columns (the prompt bucket);
    - ``decode_step(params, token_ids, attention_mask, positions, cache,
      icv_scaled, media) -> (logits, cache)`` advances every slot one token
      against its own media rows.
    """

    def prefill(params, pixel_values, pixel_valid, input_ids, attention_mask,
                icv_scaled, cache_len):
        latents = encode_images(cfg, params, pixel_values)
        n_img = pixel_values.shape[1]
        pv = pixel_valid[:, None, :].float()
        prefill_onehot = (
            image_attention_onehot(input_ids, cfg.image_token_id, eos_token_id, n_img) * pv
        )
        step_onehot = last_image_onehot(input_ids, cfg.image_token_id, n_img) * pv
        xattn_kv = precompute_xattn_kv(cfg, params, latents)
        positions = _positions_from_mask(attention_mask)
        cache = init_kv_cache(cfg.text, input_ids.shape[0], cache_len, input_ids.device)
        logits, cache = idefics_forward(
            cfg, params, input_ids, attention_mask, latents, prefill_onehot, cache,
            positions, icv_scaled=icv_scaled, prefill_flash=attention_mask,
            xattn_kv=xattn_kv, last_logit_only=True,
        )
        media = {"latents": latents, "step_onehot": step_onehot, "xattn_kv": xattn_kv}
        return logits[:, -1, :].float(), cache, media, positions[:, -1] + 1

    def decode_step(params, token_ids, attention_mask, positions, cache, icv_scaled, media):
        b, s = token_ids.shape
        so = media["step_onehot"]
        return idefics_forward(
            cfg, params, token_ids, attention_mask, media["latents"],
            so.expand(b, s, so.shape[-1]), cache, positions, icv_scaled=icv_scaled,
            xattn_kv=media["xattn_kv"],
        )

    return prefill, decode_step, SERVING_MEDIA_AXES


def make_idefics_merged_admit_fn(cfg: IdeficsConfig, eos_token_id: int):
    """ONE forward of a pool decode step and an admission group's prefill,
    every decoder projection and the MLP packed over both token streams
    (``decoder.merged_decoder_layer``), so each layer's weights are read
    once for both (JAX ``make_idefics_merged_admit_fn``, idefics.py:678-848).

    Contract (``ServingEngine``'s merged admission and the eval chains of
    ``infer/eval_chain.py``)::

        merged_step(params, dec_tok (B1,1), dec_adv (B1,1), dec_pos (B1,1),
                    cache, media, icv_scaled,
                    pixels, pv, ids (B2,S2), mask, cache_len)
          -> (dec_logits (B1,1,V), cache, pre_last_logits (B2,V) f32,
              pre_cache, pre_media, pre_next_pos (B2,))

    The decode lane is the serving ``decode_step`` over ``cache`` (written
    in place, its ``index`` advanced by one: the caller sets its own) and
    ``media``; the prefill lane is the serving ``prefill``: its own bind
    (the images encoded, the cross-attention K/V, the one-hots) into a
    fresh cache of ``cache_len`` columns.  Gated cross-attention runs per
    lane (their sequence lengths differ); only the decoder layers and the
    head pack.  The matmuls are weight-only in both lanes."""
    t = cfg.text
    interval = cfg.cross_layer_interval
    n_groups = t.n_layers // interval

    def merged_step(params, dec_tok, dec_adv, dec_pos, cache, media, icv_scaled,
                    pixels, pv, ids, mask, cache_len):
        b1 = dec_tok.shape[0]
        b2, s2 = ids.shape
        embed = params["embed"]

        # the prefill lane's bind (vision tower, perceiver, image K/V)
        latents_p = encode_images(cfg, params, pixels)
        n_img = pixels.shape[1]
        pvf = pv[:, None, :].float()
        onehot_p = image_attention_onehot(ids, cfg.image_token_id, eos_token_id, n_img) * pvf
        step_onehot = last_image_onehot(ids, cfg.image_token_id, n_img) * pvf
        xkv_p = precompute_xattn_kv(cfg, params, latents_p)
        pos_p = _positions_from_mask(mask)
        cache_p = init_kv_cache(t, b2, cache_len, ids.device)

        # per-lane attention views, rope and cross-attention masks
        index_d, index_p = cache["index"], cache_p["index"]
        mask_d, _, _ = decode_cache_view(cache, dec_pos, dec_adv, 1)
        mask_p, _, _ = decode_cache_view(cache_p, pos_p, mask, s2)
        rope_d = L.rope_cos_sin(dec_pos, t.head_dim, t.rope_theta)
        rope_p = L.rope_cos_sin(pos_p, t.head_dim, t.rope_theta)
        so = media["step_onehot"]
        xmask_d, gate_d = _xattn_mask(media["latents"], so.expand(b1, 1, so.shape[-1]))
        xmask_p, gate_p = _xattn_mask(latents_p, onehot_p)

        h_d = embed[torch.clamp(dec_tok, 0, embed.shape[0] - 1).long()].to(t.dtype)
        h_p = embed[torch.clamp(ids, 0, embed.shape[0] - 1).long()].to(t.dtype)
        icv = cast_icv(icv_scaled, t.dtype)
        for li in range(t.n_layers):
            if li % interval == 0 and li // interval < n_groups:
                g = li // interval
                xp = L.layer_slice(params["xattn"], g)
                xkv_d = media["xattn_kv"]
                h_d = gated_xattn_block(cfg, xp, h_d, media["latents"], xmask_d, gate_d,
                                        kv=(xkv_d[0][g], xkv_d[1][g]))
                h_p = gated_xattn_block(cfg, xp, h_p, latents_p, xmask_p, gate_p,
                                        kv=(xkv_p[0][g], xkv_p[1][g]))
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
        h = torch.cat([h_d, h_p[:, -1:, :]], dim=0)
        logits = logits_from_hidden(t, params, L.rms_norm(params["final_norm"], h, t.norm_eps))
        media_p = {"latents": latents_p, "step_onehot": step_onehot, "xattn_kv": xkv_p}
        return (logits[:b1], cache, logits[b1:, -1, :].float(), cache_p, media_p,
                pos_p[:, -1] + 1)

    return merged_step
