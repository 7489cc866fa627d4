"""Model registry: config group ``lmm`` → a runnable model bundle
(counterpart of ``licv_vqa_tpu/models/registry.py``: Idefics, Idefics2 and
OpenFlamingo).

Weight resolution is the JAX package's: HF ``*.safetensors`` shards (or
``pytorch_model*.bin``) under ``{model_cpk_dir}/{model_name}``, converted by
``convert.convert_idefics`` / ``convert.convert_idefics2``; OpenFlamingo's
three pieces (the MPT base under ``lang_encoder_path``, the flamingo deltas
and the open_clip tower under ``flamingo_checkpoint_dir``) by
``convert.convert_mpt`` and ``convert.convert_openflamingo_checkpoint``.
Where weights are absent, parameters are randomly initialised on the device
with a loud warning, and the tokenizer falls back to
``WhitespaceTokenizer``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Callable, Optional

import torch

from ..data.processor import (
    CLIP_MEAN,
    CLIP_STD,
    SIGLIP_MEAN,
    SIGLIP_STD,
    ImageTransform,
    PromptProcessor,
)
from ..data.tokenizer import WhitespaceTokenizer, load_hf_tokenizer
from ..utils.config import InterpolationError
from ..ops.quantize import quantize_array, quantize_layer_stack
from ..utils.log import get_logger
from .convert import (
    _cast_tree,
    convert_idefics,
    convert_idefics2,
    convert_mpt,
    convert_openclip_vision,
    convert_openflamingo_checkpoint,
)
from .decoder import logits_from_hidden
from .idefics import IdeficsConfig, init_idefics_params, make_idefics_forward_fns
from .idefics2 import Idefics2Config, init_idefics2_params, make_idefics2_forward_fns
from .openflamingo import (
    OpenFlamingoConfig,
    init_openflamingo_params,
    make_openflamingo_forward_fns,
)

logger = get_logger("models")


@dataclasses.dataclass
class ModelBundle:
    name: str
    model_cfg: Any
    params: Any
    tokenizer: Any
    processor: PromptProcessor
    train_forward: Callable  # (params, inputs, icv_scaled, return_hidden=False) -> logits
    # (params, pixels, valid, prompt_ids, icv, max_len, **kw) -> fwd_fn; kw:
    # Idefics2's NaViT ``pixel_attention_mask``
    bind_decode: Callable
    hidden_size: int
    n_layers: int  # ICV rows the checkpoint carries (K for subset layers)
    device: torch.device
    # the processor's pixel statistics (CLIP's or SigLIP's): ``model_pixels``
    # normalises the raw uint8 pixels it emits on the device
    pixel_mean: tuple
    pixel_std: tuple
    # subset-layer intervention (lmm.intervention_layer int/list): the K
    # decoder layers the K ICV rows map to; None when the ICV covers every layer
    intervention_layers: Optional[list] = None
    # (params, hidden (B, S, D)) -> logits (B, S, V) f32: the LM head alone,
    # for the teacher path that gathers the student-aligned window of the
    # hidden states before the (D, V) projection (icv_loss_fn)
    head_fn: Optional[Callable] = None

    @property
    def pad_token_id(self) -> int:
        return self.tokenizer.pad_token_id

    @property
    def eos_token_id(self) -> int:
        return self.tokenizer.eos_token_id

    def model_pixels(self, pixels: torch.Tensor) -> torch.Tensor:
        """The processor's raw uint8 pixels as the model's normalised floats
        (floats pass through).  The bundle's own forwards do this; the
        engines and eval chains that call a family's raw functions call it."""
        return normalize_pixels(pixels, self.pixel_mean, self.pixel_std)

    def model_icv(self, icv_scaled):
        """The ICV as the model's layers take it: a subset-layer ICV's K rows
        expanded to per-layer ``(rows, flags)``; a whole-model ICV (or None)
        as it is."""
        if icv_scaled is None or self.intervention_layers is None:
            return icv_scaled
        from ..icv.encoder import expand_icv_to_layers

        return expand_icv_to_layers(icv_scaled, self.intervention_layers,
                                    self.model_cfg.text.n_layers)


def normalize_pixels(pixels: torch.Tensor, mean, std) -> torch.Tensor:
    """RAW uint8 pixels normalised on the device (the processor emits uint8);
    floats pass through (already normalised by a direct-API caller)."""
    if pixels.dtype != torch.uint8:
        return pixels
    m = torch.tensor(mean, dtype=torch.float32, device=pixels.device)
    inv_std = 1.0 / torch.tensor(std, dtype=torch.float32, device=pixels.device)
    return (pixels.float() * (1.0 / 255.0) - m) * inv_std


def _wrap_pixel_normalize(train_forward, bind_decode, mean, std):
    """Normalise RAW uint8 pixels on the device (the processor emits uint8)."""

    def tf(model_params, inputs, icv_scaled, **kw):
        inputs = dict(inputs, pixel_values=normalize_pixels(inputs["pixel_values"], mean, std))
        return train_forward(model_params, inputs, icv_scaled, **kw)

    def bd(model_params, pixels, valid, ids, icv_scaled, max_len, **kw):
        return bind_decode(model_params, normalize_pixels(pixels, mean, std), valid, ids,
                           icv_scaled, max_len, **kw)

    return tf, bd


def _max_length(cfg, default: int) -> int:
    if cfg is not None:
        v = cfg.lmm.get("max_length")
        if v is not None:
            return int(v)
    return default


def _wrap_intervention(cfg, n_layers: int, train_forward, bind_decode):
    """The reference's ``intervention_layer`` semantics (int/list/-1,
    icv_intervention.py:39-42): the checkpoint owns K = len(layers) rows; the
    model receives (L, D) rows plus per-layer host flags."""
    from ..icv.encoder import expand_icv_to_layers, prepare_intervention_layers

    intervention = -1
    if cfg is not None:
        raw = cfg.lmm.get("intervention_layer", -1)
        intervention = raw if isinstance(raw, (int, list)) else list(raw)
    layers = prepare_intervention_layers(intervention, n_layers)
    if layers == list(range(n_layers)):
        return train_forward, bind_decode, n_layers, None

    def tf(model_params, inputs, icv_scaled, **kw):
        return train_forward(
            model_params, inputs, expand_icv_to_layers(icv_scaled, layers, n_layers), **kw
        )

    def bd(model_params, pixels, valid, ids, icv_scaled, max_len, **kw):
        return bind_decode(
            model_params, pixels, valid, ids,
            expand_icv_to_layers(icv_scaled, layers, n_layers), max_len, **kw,
        )

    return tf, bd, len(layers), layers


def _load_hf_weights(model_dir: Path) -> Optional[dict]:
    shards = sorted(model_dir.glob("*.safetensors"))
    if shards:
        from safetensors.torch import load_file

        sd: dict = {}
        for shard in shards:
            sd.update(load_file(str(shard)))
        return sd
    bins = sorted(model_dir.glob("pytorch_model*.bin"))
    if bins:
        sd = {}
        for b in bins:
            sd.update(torch.load(b, map_location="cpu", weights_only=True))
        return sd
    return None


def _resolve_tokenizer(model_dir: Optional[Path]):
    if model_dir is not None and (model_dir / "tokenizer_config.json").exists():
        return load_hf_tokenizer(str(model_dir))
    logger.warning(
        "no HF tokenizer found (%s) — falling back to WhitespaceTokenizer "
        "(smoke/synthetic mode only)",
        model_dir,
    )
    return WhitespaceTokenizer()


def _model_dir(cfg) -> Optional[Path]:
    if cfg is not None and "model_cpk_dir" in cfg:
        try:
            return Path(str(cfg.model_cpk_dir)) / str(cfg.lmm.model_name)
        except InterpolationError:  # MODEL_CPK_DIR unset: no weights to find
            return None
    return None


def _family_bundle(cfg, model_cfg, name: str, device) -> ModelBundle:
    """Idefics (``IdeficsConfig``) or Idefics2 (``Idefics2Config``): the
    weights, tokenizer and processor, and the wrapped forwards (JAX
    ``_idefics_bundle`` :172 and ``_idefics2_bundle`` :233)."""
    idefics2 = isinstance(model_cfg, Idefics2Config)
    family = "idefics2" if idefics2 else "idefics"
    model_dir = _model_dir(cfg)
    sd = _load_hf_weights(model_dir) if model_dir and model_dir.exists() else None
    if sd is not None:
        convert = convert_idefics2 if idefics2 else convert_idefics
        params = convert(sd, model_cfg, device=device)
        logger.info("loaded %s weights from %s", family, model_dir)
    else:
        logger.warning(
            "%s weights not found under %s — RANDOM INIT (%s)",
            family, model_dir, model_cfg.text.dtype,
        )
        gen = torch.Generator(device=device).manual_seed(0)
        init = init_idefics2_params if idefics2 else init_idefics_params
        params = init(gen, model_cfg, device)

    tokenizer = _resolve_tokenizer(model_dir)
    # keep the processor's image token in sync with the model config
    tok_img = tokenizer.token_id("<image>")
    if tok_img is not None and tok_img >= 0 and sd is not None:
        model_cfg = dataclasses.replace(model_cfg, image_token_id=tok_img)
    if idefics2:
        # full-width towers take NaViT variable resolution (an aspect-
        # preserving resize into [378, 980] and a pixel_attention_mask, the
        # HF processor's defaults); the tiny configs keep fixed squares
        processor = PromptProcessor(
            tokenizer,
            ImageTransform(
                model_cfg.vision.image_size, SIGLIP_MEAN, SIGLIP_STD,
                variable_resolution=model_cfg.vision.image_size >= 378,
            ),
            family="idefics2",
            image_seq_len=model_cfg.image_seq_len,
            # Mistral-7B's long context: 64 inline tokens an image put a
            # 32-shot teacher view at thousands of tokens
            max_length=_max_length(cfg, default=8192),
        )
        mean, std, make_fns = SIGLIP_MEAN, SIGLIP_STD, make_idefics2_forward_fns
    else:
        processor = PromptProcessor(
            tokenizer,
            ImageTransform(model_cfg.vision.image_size, CLIP_MEAN, CLIP_STD),
            family="idefics",
            max_length=_max_length(cfg, default=2048),  # LLaMA-7B context
        )
        mean, std, make_fns = CLIP_MEAN, CLIP_STD, make_idefics_forward_fns
    # make the whitespace-tokenizer smoke path self-consistent
    if isinstance(tokenizer, WhitespaceTokenizer):
        model_cfg = dataclasses.replace(model_cfg, image_token_id=processor.image_token_id)

    train_fwd, bind = make_fns(model_cfg, tokenizer.eos_token_id)
    train_fwd, bind = _wrap_pixel_normalize(train_fwd, bind, mean, std)
    train_fwd, bind, n_icv_layers, icv_layer_ids = _wrap_intervention(
        cfg, model_cfg.text.n_layers, train_fwd, bind
    )
    return ModelBundle(
        name=name,
        model_cfg=model_cfg,
        params=params,
        tokenizer=tokenizer,
        processor=processor,
        train_forward=train_fwd,
        bind_decode=bind,
        hidden_size=model_cfg.text.d_model,
        n_layers=n_icv_layers,
        device=torch.device(device),
        pixel_mean=mean,
        pixel_std=std,
        intervention_layers=icv_layer_ids,
        head_fn=lambda p, h, _t=model_cfg.text: logits_from_hidden(_t, p, h),
    )


def _load_torch_state_dict(path: Path) -> Optional[dict]:
    """``torch.load`` a ``.pt``/``.bin`` and unwrap the common containers
    (JAX registry.py:519-533)."""
    try:
        obj = torch.load(str(path), map_location="cpu", weights_only=True)
    except Exception as e:  # a foreign pickle: skipped with a warning, as in JAX
        logger.warning("could not load %s: %s", path, e)
        return None
    if isinstance(obj, dict):
        for key in ("model_state_dict", "state_dict", "model"):
            if key in obj and isinstance(obj[key], dict):
                return obj[key]
        return obj
    return None


def _flamingo_dirs(cfg, name: str) -> tuple:
    """``(MPT base dir, flamingo checkpoint dir)``, either None, as JAX
    resolves them (registry.py:540-559): ``{model_cpk_dir}/{lang_encoder_path
    or model_name}``, and ``flamingo_checkpoint_dir`` or else
    ``{model_cpk_dir}/{hf_root}``; an unset environment variable in either
    leaves it None."""
    model_dir = flamingo_dir = None
    if cfg is None or "model_cpk_dir" not in cfg:
        return None, None
    try:
        base = cfg.lmm.get("lang_encoder_path", cfg.lmm.get("model_name", name))
        model_dir = Path(str(cfg.model_cpk_dir)) / str(base)
    except InterpolationError:
        model_dir = None
    try:
        fdir = cfg.lmm.get("flamingo_checkpoint_dir")
        if fdir:
            flamingo_dir = Path(str(fdir))
        elif cfg.lmm.get("hf_root"):
            flamingo_dir = Path(str(cfg.model_cpk_dir)) / str(cfg.lmm.hf_root)
    except InterpolationError:
        flamingo_dir = None
    return model_dir, flamingo_dir


def _openflamingo_bundle(cfg, model_cfg, name: str, device) -> ModelBundle:
    """OpenFlamingo (JAX ``_openflamingo_bundle``, registry.py:536-647): its
    weights come in three pieces (the MPT base, the flamingo deltas of
    ``checkpoint.pt``, the open_clip ViT-L tower), each over a random init
    on the device where it is missing; CLIP normalisation; the
    ``flamingo`` prompt family at MPT-7B's 2048-token context; the head
    tied to the embedding table."""
    model_dir, flamingo_dir = _flamingo_dirs(cfg, name)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_openflamingo_params(gen, model_cfg, device)
    sd = _load_hf_weights(model_dir) if model_dir and model_dir.exists() else None
    if sd is not None:
        mpt = convert_mpt(sd, model_cfg.text, device=device)
        params.update({k: mpt[k] for k in ("embed", "layers", "final_norm")})
        logger.info("loaded MPT backbone from %s", model_dir)
    else:
        logger.warning("openflamingo weights not found under %s — RANDOM INIT (%s)",
                       model_dir, model_cfg.text.dtype)
    if flamingo_dir is not None and flamingo_dir.exists():
        candidates = [flamingo_dir / "checkpoint.pt"] + sorted(
            p for p in flamingo_dir.glob("*.pt") if p.name != "checkpoint.pt"
        ) + sorted(flamingo_dir.glob("*.bin"))
        applied = []
        for path in candidates:
            fsd = _load_torch_state_dict(path) if path.exists() else None
            if fsd is None:
                continue
            keys = {k[len("module."):] if k.startswith("module.") else k for k in fsd}
            if any(k.startswith(("perceiver.", "lang_encoder.")) for k in keys):
                params, updated = convert_openflamingo_checkpoint(fsd, model_cfg, params)
                applied += updated
                logger.info("applied flamingo deltas %s from %s", updated, path)
            elif "visual.conv1.weight" in keys:  # a standalone open_clip tower
                params["vision"] = _cast_tree(
                    convert_openclip_vision(fsd, model_cfg.vision, "visual."),
                    model_cfg.vision.dtype, device,
                )
                applied.append("vision")
                logger.info("loaded open_clip ViT tower from %s", path)
        missing = {"perceiver", "xattn", "vision"} - set(applied)
        if missing:
            logger.warning("flamingo checkpoint dir %s left %s at random init",
                           flamingo_dir, sorted(missing))
    elif flamingo_dir is not None:
        logger.warning("flamingo_checkpoint_dir %s not found — perceiver/xattn/vision "
                       "stay at random init", flamingo_dir)

    tokenizer = _resolve_tokenizer(model_dir)
    processor = PromptProcessor(
        tokenizer,
        ImageTransform(model_cfg.vision.image_size, CLIP_MEAN, CLIP_STD),
        family="flamingo",
        max_length=_max_length(cfg, default=2048),  # MPT-7B context
    )
    if isinstance(tokenizer, WhitespaceTokenizer):
        model_cfg = dataclasses.replace(model_cfg, image_token_id=processor.image_token_id)
    train_fwd, bind = make_openflamingo_forward_fns(model_cfg, tokenizer.eos_token_id)
    mean, std = CLIP_MEAN, CLIP_STD
    train_fwd, bind = _wrap_pixel_normalize(train_fwd, bind, mean, std)
    train_fwd, bind, n_icv_layers, icv_layer_ids = _wrap_intervention(
        cfg, model_cfg.text.n_layers, train_fwd, bind
    )
    return ModelBundle(
        name=name,
        model_cfg=model_cfg,
        params=params,
        tokenizer=tokenizer,
        processor=processor,
        train_forward=train_fwd,
        bind_decode=bind,
        hidden_size=model_cfg.text.d_model,
        n_layers=n_icv_layers,
        device=torch.device(device),
        pixel_mean=mean,
        pixel_std=std,
        intervention_layers=icv_layer_ids,
        head_fn=lambda p, h, _t=model_cfg.text: logits_from_hidden(_t, p, h),
    )


def _leading(tree, n: int):
    """The first ``n`` entries along the leading (layer) axis of every leaf
    of a layer-stacked tree: views, no copies (quantized ``{"q", "s"}`` /
    ``{"q4", "s"}`` leaves included)."""
    if isinstance(tree, dict):
        return {k: _leading(v, n) for k, v in tree.items()}
    return tree[:n]


def build_draft_decode(bundle: ModelBundle, draft_layers: int):
    """A layer-truncated draft ``bind_decode`` for speculative decoding (JAX
    ``build_draft_decode``, registry.py:306-368): the same weights, the
    first ``draft_layers`` decoder layers and the cross-attention groups
    they hold (``k // cross_layer_interval`` for Idefics, ``k //
    cross_attn_every_n_layers`` for OpenFlamingo).  The draft's params are
    views of the bundle's tensors (quantized leaves too), so it costs no
    memory beyond its cache.  Returns ``(draft_params, bind_decode)``; the
    bind is pixel-normalize-wrapped like the bundle's (the processor emits
    raw uint8) and takes the ICV as per-layer rows (the runner expands a
    subset-layer ICV first)."""
    name = bundle.name
    mc = bundle.model_cfg
    k = draft_layers
    mean, std = (SIGLIP_MEAN, SIGLIP_STD) if "idefics2" in name else (CLIP_MEAN, CLIP_STD)
    new_cfg = dataclasses.replace(mc, text=dataclasses.replace(mc.text, n_layers=k))

    def draft(make_fns, group: Optional[tuple] = None):
        params = dict(bundle.params, layers=_leading(bundle.params["layers"], k))
        if group is not None:
            field, every = group
            if k % every:
                raise ValueError(f"draft_layers ({k}) must be a multiple of {field} ({every})")
            params["xattn"] = _leading(bundle.params["xattn"], k // every)
        _, bind = make_fns(new_cfg, bundle.eos_token_id)
        _, bind = _wrap_pixel_normalize(lambda *a, **kw: None, bind, mean, std)
        return params, bind

    if "idefics2" in name:
        return draft(make_idefics2_forward_fns)
    if "idefics" in name:
        return draft(make_idefics_forward_fns, ("cross_layer_interval", mc.cross_layer_interval))
    if "flamingo" in name.lower():
        return draft(make_openflamingo_forward_fns,
                     ("cross_attn_every_n_layers", mc.cross_attn_every_n_layers))
    raise ValueError(f"no draft builder for {name}")


def _apply_lmm_options(cfg, model_cfg):
    """Honor ``lmm.attention_impl`` (xla|flash), ``lmm.remat_mode``
    (both|inner|outer; policy raises in the train forward; only configs
    that have the field, as JAX does: Idefics2's has none), ``lmm.kv_cache``
    (bf16|int8) and ``lmm.w8a8_prefill`` on the model config (JAX
    ``_apply_attention_impl``, registry.py:446-487)."""
    impl = cfg.lmm.get("attention_impl")
    text = model_cfg.text
    if impl in ("xla", "flash"):
        text = dataclasses.replace(text, attention_impl=impl)
    rm = cfg.lmm.get("remat_mode")
    if rm is not None and hasattr(model_cfg, "remat_mode"):
        model_cfg = dataclasses.replace(model_cfg, remat_mode=str(rm))
    kvc = cfg.lmm.get("kv_cache")
    if kvc is not None:
        text = dataclasses.replace(text, kv_cache_dtype=str(kvc))
    if bool(cfg.lmm.get("w8a8_prefill", False)):
        # int8-activation prefill/bind matmuls; a no-op on unquantized leaves
        text = dataclasses.replace(text, w8a8_prefill=True)
    return dataclasses.replace(model_cfg, text=text)


def _maybe_quantize(cfg, bundle: ModelBundle) -> ModelBundle:
    """``lmm.quantize=int8|int4``: weight-only quantization of the decoder
    and (where the family has them) cross-attention stacks, on the device
    the params live on (JAX registry.py:372-443).  ``lmm.quantize_head``
    makes the (D, V) head int8 whatever the stack mode (tied embeddings keep
    the table); ``lmm.quantize_vision`` makes the vision tower, the
    perceiver (Idefics' and OpenFlamingo's ``blocks``, Idefics2's ``layers``) and Idefics2's
    connector int8.  Embeddings, norms, biases and latents stay as they
    are."""
    q = str(cfg.lmm.get("quantize", "none"))
    if q == "none":
        return bundle
    if q not in ("int8", "int4"):
        raise ValueError(f"lmm.quantize must be none|int8|int4, got {q!r}")
    p = bundle.params
    p["layers"] = quantize_layer_stack(p["layers"], mode=q)
    if "xattn" in p:
        p["xattn"] = quantize_layer_stack(p["xattn"], mode=q)
    logger.info("%s weight-only quantization applied to decoder stacks", q)
    if bool(cfg.lmm.get("quantize_head", False)):
        if bundle.model_cfg.text.tie_embeddings:
            logger.warning("quantize_head ignored: tied embeddings (the table also "
                           "serves the input gather)")
        else:
            p["lm_head"] = quantize_array(p["lm_head"])
            logger.info("int8 weight-only quantization applied to lm_head")
    if bool(cfg.lmm.get("quantize_vision", False)):
        p["vision"]["layers"] = quantize_layer_stack(p["vision"]["layers"])
        per = p.get("perceiver", {})
        for key in ("blocks", "layers"):  # Idefics / Idefics2
            if key in per:
                per[key] = quantize_layer_stack(per[key])
        if "connector" in p:
            p["connector"] = quantize_layer_stack(p["connector"])
        logger.info("int8 weight-only quantization applied to vision tower "
                    "(+perceiver/connector)")
    return bundle


def build_model(cfg, device="cuda") -> ModelBundle:
    """``cfg`` is the composed top-level config (needs ``cfg.lmm``)."""
    name = str(cfg.lmm.name)
    if name == "idefics-9b":
        model_cfg = IdeficsConfig.idefics_9b()
    elif name == "tiny-idefics":
        model_cfg = IdeficsConfig.tiny(dtype=torch.float32)
    elif name == "idefics2-8b-base":
        model_cfg = Idefics2Config.idefics2_8b()
    elif name == "tiny-idefics2":
        model_cfg = Idefics2Config.tiny(dtype=torch.float32)
    elif "openflamingo" in name.lower() or name == "tiny-flamingo":
        model_cfg = (OpenFlamingoConfig.tiny(dtype=torch.float32) if name == "tiny-flamingo"
                     else OpenFlamingoConfig.openflamingo_9b())
    else:
        raise ValueError(f"unknown lmm name: {name}")
    make = (_openflamingo_bundle if isinstance(model_cfg, OpenFlamingoConfig)
            else _family_bundle)
    return _maybe_quantize(cfg, make(cfg, _apply_lmm_options(cfg, model_cfg), name, device))
