"""Model configurations (counterpart of ``licv_vqa_tpu/models/config.py``),
re-declared with torch dtypes.

Both decoder branches are ported: LLaMA's rope / RMSNorm / SwiGLU and MPT's
ALiBi / bias-free LayerNorm / GELU, each with the int8 KV cache.  Values
outside the JAX config's raise ``ValueError``, so a config the port cannot
run fails at construction and never silently runs a different model.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

BLOCK_OUTPUT = "block_output"
MLP_OUTPUT = "mlp_output"


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Causal decoder: LLaMA-family (rope, RMSNorm, SwiGLU) or MPT (ALiBi,
    LayerNorm, GELU MLP)."""

    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    d_ff: int = 11008
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    injection_site: str = BLOCK_OUTPUT
    dtype: torch.dtype = torch.bfloat16
    positional: str = "rope"
    norm_type: str = "rmsnorm"
    activation: str = "silu_glu"
    attn_logit_softcap: Optional[float] = None
    # "flash": prefills of >= 256 tokens into an empty cache run the CUDA
    # flash-attention kernel (layers.flash_attention_usable); "xla" keeps
    # every attention on the plain path (the name is the JAX config's).
    attention_impl: str = "flash"
    # "int8": the KV cache holds {"q", "s"} leaves (decoder.init_kv_cache)
    kv_cache_dtype: str = "bf16"
    # w8a8 for blocks of >= decoder.W8A8_MIN_TOKENS tokens (int8 leaves only)
    w8a8_prefill: bool = False

    def __post_init__(self):
        for field, allowed in (("positional", ("rope", "alibi")),
                               ("norm_type", ("rmsnorm", "layernorm")),
                               ("activation", ("silu_glu", "gelu"))):
            if getattr(self, field) not in allowed:
                raise ValueError(
                    f"{field} must be {'|'.join(allowed)}, got {getattr(self, field)!r}"
                )
        if self.kv_cache_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_cache_dtype must be bf16|int8, got {self.kv_cache_dtype!r}")
        if self.attention_impl not in ("flash", "xla"):
            raise ValueError(f"attention_impl must be flash|xla, got {self.attention_impl!r}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """CLIP/SigLIP-family ViT encoder."""

    image_size: int = 224
    patch_size: int = 14
    d_model: int = 1280
    n_layers: int = 32
    n_heads: int = 16
    d_ff: int = 5120
    norm_eps: float = 1e-5
    use_class_token: bool = True  # CLIP yes, SigLIP no
    use_pre_norm: bool = True  # CLIP pre-layernorm on the embeddings
    use_post_norm: bool = False  # SigLIP post-layernorm on the sequence
    patch_bias: bool = False  # SigLIP's patch conv has a bias, CLIP's not
    activation: str = "gelu"  # "gelu" | "gelu_tanh" | "quick_gelu"
    dtype: torch.dtype = torch.bfloat16

    @property
    def n_patches(self) -> int:
        side = self.image_size // self.patch_size
        return side * side + (1 if self.use_class_token else 0)


@dataclasses.dataclass(frozen=True)
class PerceiverConfig:
    """Perceiver resampler (Idefics-9B; Idefics2 has its own,
    ``idefics2.Idefics2PerceiverCfg``)."""

    n_latents: int = 64
    n_layers: int = 6
    n_heads: int = 16
    head_dim: int = 96
    d_model: int = 4096
    d_ff: int = 16384
    norm_eps: float = 1e-6
    activation: str = "relu"  # "relu" (HF Idefics) | "gelu" (open_flamingo)
    dtype: torch.dtype = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class CrossAttnConfig:
    """Gated cross-attention blocks (Idefics-9B / Flamingo)."""

    every_n_layers: int = 4
    n_heads: int = 32
    d_ff: int = 11008
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
