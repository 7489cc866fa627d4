"""Model registry: config group ``lmm`` → a runnable model bundle
(counterpart of ``licv_vqa_tpu/models/registry.py``, Idefics part).

Weight resolution is the JAX package's: HF ``*.safetensors`` shards (or
``pytorch_model*.bin``) under ``{model_cpk_dir}/{model_name}``, converted by
``convert.convert_idefics``; when absent, parameters are randomly
initialised on the device with a loud warning, and the tokenizer falls back
to ``WhitespaceTokenizer``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Callable, Optional

import torch

from ..data.processor import CLIP_MEAN, CLIP_STD, ImageTransform, PromptProcessor
from ..data.tokenizer import WhitespaceTokenizer, load_hf_tokenizer
from ..utils.config import InterpolationError
from ..utils.log import get_logger
from .convert import convert_idefics
from .decoder import logits_from_hidden
from .idefics import IdeficsConfig, init_idefics_params, make_idefics_forward_fns

logger = get_logger("models")


@dataclasses.dataclass
class ModelBundle:
    name: str
    model_cfg: Any
    params: Any
    tokenizer: Any
    processor: PromptProcessor
    train_forward: Callable  # (params, inputs, icv_scaled, return_hidden=False) -> logits
    bind_decode: Callable  # (params, pixels, valid, prompt_ids, icv, max_len) -> fwd_fn
    hidden_size: int
    n_layers: int  # ICV rows the checkpoint carries (K for subset layers)
    device: torch.device
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


def _wrap_pixel_normalize(train_forward, bind_decode, mean, std):
    """Normalise RAW uint8 pixels on the device (the processor emits uint8)."""

    def norm(pixels: torch.Tensor) -> torch.Tensor:
        if pixels.dtype != torch.uint8:
            return pixels  # already normalised floats (direct-API callers)
        m = torch.tensor(mean, dtype=torch.float32, device=pixels.device)
        inv_std = 1.0 / torch.tensor(std, dtype=torch.float32, device=pixels.device)
        return (pixels.float() * (1.0 / 255.0) - m) * inv_std

    def tf(model_params, inputs, icv_scaled, **kw):
        inputs = dict(inputs, pixel_values=norm(inputs["pixel_values"]))
        return train_forward(model_params, inputs, icv_scaled, **kw)

    def bd(model_params, pixels, valid, ids, icv_scaled, max_len):
        return bind_decode(model_params, norm(pixels), valid, ids, icv_scaled, max_len)

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

    def bd(model_params, pixels, valid, ids, icv_scaled, max_len):
        return bind_decode(
            model_params, pixels, valid, ids,
            expand_icv_to_layers(icv_scaled, layers, n_layers), max_len,
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


def _idefics_bundle(cfg, model_cfg: IdeficsConfig, name: str, device) -> ModelBundle:
    model_dir = None
    if cfg is not None and "model_cpk_dir" in cfg:
        try:
            model_dir = Path(str(cfg.model_cpk_dir)) / str(cfg.lmm.model_name)
        except InterpolationError:  # MODEL_CPK_DIR unset: no weights to find
            model_dir = None

    sd = _load_hf_weights(model_dir) if model_dir and model_dir.exists() else None
    if sd is not None:
        params = convert_idefics(sd, model_cfg, device=device)
        logger.info("loaded idefics weights from %s", model_dir)
    else:
        logger.warning(
            "idefics weights not found under %s — RANDOM INIT (%s)",
            model_dir, model_cfg.text.dtype,
        )
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_idefics_params(gen, model_cfg, device)

    tokenizer = _resolve_tokenizer(model_dir)
    # keep the processor's image token in sync with the model config
    tok_img = tokenizer.token_id("<image>")
    if tok_img is not None and tok_img >= 0 and sd is not None:
        model_cfg = dataclasses.replace(model_cfg, image_token_id=tok_img)
    processor = PromptProcessor(
        tokenizer,
        ImageTransform(model_cfg.vision.image_size, CLIP_MEAN, CLIP_STD),
        family="idefics",
        max_length=_max_length(cfg, default=2048),  # LLaMA-7B context
    )
    # make the whitespace-tokenizer smoke path self-consistent
    if isinstance(tokenizer, WhitespaceTokenizer):
        model_cfg = dataclasses.replace(model_cfg, image_token_id=processor.image_token_id)

    train_fwd, bind = make_idefics_forward_fns(model_cfg, tokenizer.eos_token_id)
    train_fwd, bind = _wrap_pixel_normalize(train_fwd, bind, CLIP_MEAN, CLIP_STD)
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
        intervention_layers=icv_layer_ids,
        head_fn=lambda p, h, _t=model_cfg.text: logits_from_hidden(_t, p, h),
    )


def _apply_lmm_options(cfg, model_cfg: IdeficsConfig) -> IdeficsConfig:
    """Honor ``lmm.attention_impl`` (xla|flash) and ``lmm.remat_mode``
    (both|inner|outer; policy raises in the train forward).  ``lmm.kv_cache=int8``,
    ``lmm.w8a8_prefill`` and ``lmm.quantize`` are not ported: the config
    raises naming their ROADMAP item."""
    impl = cfg.lmm.get("attention_impl")
    kvc = cfg.lmm.get("kv_cache")
    a8 = bool(cfg.lmm.get("w8a8_prefill", False))
    text = model_cfg.text
    if impl in ("xla", "flash"):
        text = dataclasses.replace(text, attention_impl=impl)
    rm = cfg.lmm.get("remat_mode")
    if rm is not None:
        model_cfg = dataclasses.replace(model_cfg, remat_mode=str(rm))
    if kvc not in (None, "bf16") or a8:
        text = dataclasses.replace(
            text, kv_cache_dtype=kvc or "bf16", w8a8_prefill=a8
        )
    q = str(cfg.lmm.get("quantize", "none"))
    if q != "none":
        raise NotImplementedError(
            f"lmm.quantize={q} is not ported to licv_vqa_tpu_torch yet "
            "(ROADMAP.md Queue 1 item 9 (Quantization))"
        )
    return dataclasses.replace(model_cfg, text=text)


def build_model(cfg, device="cuda") -> ModelBundle:
    """``cfg`` is the composed top-level config (needs ``cfg.lmm``)."""
    name = str(cfg.lmm.name)
    if name == "idefics-9b":
        model_cfg = IdeficsConfig.idefics_9b()
    elif name == "tiny-idefics":
        model_cfg = IdeficsConfig.tiny(dtype=torch.float32)
    elif name in ("idefics2-8b-base", "tiny-idefics2"):
        raise NotImplementedError(
            f"lmm {name} is not ported to licv_vqa_tpu_torch yet "
            "(ROADMAP.md Queue 1 item 10 (Idefics2))"
        )
    elif "flamingo" in name.lower():
        raise NotImplementedError(
            f"lmm {name} is not ported to licv_vqa_tpu_torch yet "
            "(ROADMAP.md Queue 1 item 11 (OpenFlamingo))"
        )
    else:
        raise ValueError(f"unknown lmm name: {name}")
    return _idefics_bundle(cfg, _apply_lmm_options(cfg, model_cfg), name, device)
