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
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from . import layers as L
from .config import BLOCK_OUTPUT, DecoderConfig, PerceiverConfig, VisionConfig
from .decoder import (
    _positions_from_mask,
    decode_cache_view,
    decoder_layer,
    init_kv_cache,
    init_layer_params,
    logits_from_hidden,
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
    # group; "none" = no recompute.  The cross-attention block is
    # checkpointed under every mode but "none".
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
    """(B, N_img, H, W, 3) → image latents (B, N_img·n_lat, De)."""
    b, n_img = pixel_values.shape[:2]
    flat = pixel_values.reshape((b * n_img,) + tuple(pixel_values.shape[2:]))
    feats = vision_forward(cfg.vision, params["vision"], flat)
    if cfg.use_resampler:
        feats = perceiver_forward(cfg.perceiver, params["perceiver"], feats)
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
    x = L.rms_norm(p["ln1"], h, t.norm_eps)
    q = (x @ p["attn"]["wq"]).reshape(b, s, nh, dh)
    if "q_norm" in p["attn"]:
        q = L.rms_norm(p["attn"]["q_norm"], q, t.norm_eps)
    if kv is not None:
        k, v = kv  # decode-invariant image K/V, k_norm applied at bind time
    else:
        k = (image_latents @ p["attn"]["wk"]).reshape(b, -1, nh, dh)
        v = (image_latents @ p["attn"]["wv"]).reshape(b, -1, nh, dh)
        if "k_norm" in p["attn"]:
            k = L.rms_norm(p["attn"]["k_norm"], k, t.norm_eps)
    # a token before the first <image> has a fully masked row: the softmax
    # over finfo.min scores is uniform (finite) and the gate zeroes it
    attn = L.dot_product_attention(q, k, v, mask=img_mask)
    attn = (attn.reshape(b, s, nh * dh) @ p["attn"]["wo"]).to(h.dtype)
    attn = attn * gate[:, :, None].to(attn.dtype)
    h = h + torch.tanh(p["alpha_xattn"]).to(h.dtype) * attn
    mlp = L.swiglu_mlp(p["mlp"], L.rms_norm(p["ln2"], h, t.norm_eps))
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
    attn = params["xattn"]["attn"]
    ks, vs = [], []
    for g in range(attn["wk"].shape[0]):
        k = (image_latents @ attn["wk"][g]).reshape(b, n_k, nh, dh)
        v = (image_latents @ attn["wv"][g]).reshape(b, n_k, nh, dh)
        if "k_norm" in attn:
            k = L.rms_norm(attn["k_norm"][g], k, t.norm_eps)
        ks.append(k.to(t.dtype))
        vs.append(v.to(t.dtype))
    return torch.stack(ks), torch.stack(vs)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _cast_icv(icv_scaled, dtype):
    """ICV rows in the model's compute dtype, as JAX casts the floating
    leaves (idefics.py:424-434); subset-layer flags stay host bools."""
    if icv_scaled is None:
        return None
    if isinstance(icv_scaled, tuple):
        rows, flags = icv_scaled
        return rows.to(dtype), list(flags)
    return icv_scaled.to(dtype)


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

    # cross-attention mask: the per-image one-hot spread over its latents
    n_lat = image_latents.shape[1] // image_attn_onehot.shape[-1]
    xmask = torch.repeat_interleave(image_attn_onehot, n_lat, dim=-1) > 0
    gate = torch.any(xmask, dim=-1).float()  # (B, s)
    xmask = xmask[:, None, :, :]  # (B, 1, s, Nk)

    icv = _cast_icv(icv_scaled, t.dtype)
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
            kv_write=(cache["k"][li], cache["v"][li], index),
            flash_valid=prefill_flash,
        )
    cache["index"] = index + s
    h = L.rms_norm(params["final_norm"], h, t.norm_eps)
    if last_logit_only:
        # prompts are LEFT-padded for decode: the last position is the
        # continuation point
        h = h[:, -1:, :]
    return logits_from_hidden(t, params, h), cache


def _icv_row(icv, li: int):
    """Layer ``li``'s ICV argument: a row, a ``(row, host flag)`` pair, or
    None."""
    if icv is None:
        return None
    if isinstance(icv, tuple):
        return icv[0][li], icv[1][li]
    return icv[li]


def _grouped_train_forward(cfg, params, h, attention_mask, image_latents, xmask, gate, icv, mode):
    """The no-cache decoder stack as JAX's grouped scan: per group, one
    gated cross-attention block then ``interval`` decoder layers.
    ``torch.utils.checkpoint`` stands where ``jax.checkpoint`` does.  The
    flash branch is gated on the attention mask as the JAX train forward
    gates it; the kernel has no backward, so it is reached only without
    gradients (the teacher) or raises."""
    t = cfg.text
    interval = cfg.cross_layer_interval
    n_groups = t.n_layers // interval
    if n_groups * interval != t.n_layers:
        raise ValueError(
            f"idefics train forward needs n_layers ({t.n_layers}) divisible by "
            f"cross_layer_interval ({interval}): layers run in groups"
        )
    if mode == "policy":
        raise NotImplementedError(
            "remat_mode=policy (save the weight matmuls, recompute the rest) is "
            "not ported to licv_vqa_tpu_torch yet (ROADMAP.md Queue 1 item 8)"
        )
    if mode not in ("both", "inner", "outer", "none"):
        raise ValueError(f"remat_mode must be both|inner|outer|none|policy, got {mode!r}")
    positions = _positions_from_mask(attention_mask)
    mask = L.causal_mask(positions, positions, attention_mask.bool())
    cos, sin = L.rope_cos_sin(positions, t.head_dim, t.rope_theta)

    def run(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False)

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
            h = run(layer_fn, h, icv_arg) if mode in ("both", "inner") else layer_fn(h, icv_arg)
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
