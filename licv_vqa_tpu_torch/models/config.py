"""Model configurations (counterpart of ``licv_vqa_tpu/models/config.py``),
re-declared with torch dtypes.

Only the rope / RMSNorm / SwiGLU decoder branch is ported.  The other values
of the JAX config raise ``NotImplementedError`` naming the ROADMAP item that
ports them, so a config the port cannot run fails at construction and never
silently runs a different model.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

BLOCK_OUTPUT = "block_output"
MLP_OUTPUT = "mlp_output"


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to licv_vqa_tpu_torch yet (ROADMAP.md {item})"
    )


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """LLaMA-family causal decoder (rope, RMSNorm, SwiGLU)."""

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
    kv_cache_dtype: str = "bf16"
    w8a8_prefill: bool = False

    def __post_init__(self):
        if self.positional != "rope":
            raise _not_ported(
                f"positional={self.positional!r} (ALiBi / MPT)",
                "Queue 1 item 11 (OpenFlamingo)",
            )
        if self.norm_type != "rmsnorm" or self.activation != "silu_glu":
            raise _not_ported(
                f"norm_type={self.norm_type!r}/activation={self.activation!r}",
                "Queue 1 item 11 (OpenFlamingo)",
            )
        if self.kv_cache_dtype != "bf16":
            raise _not_ported(
                f"kv_cache_dtype={self.kv_cache_dtype!r}",
                "Queue 1 item 9 (Quantization)",
            )
        if self.w8a8_prefill:
            raise _not_ported("w8a8_prefill", "Queue 1 item 9 (Quantization)")
        if self.attention_impl not in ("flash", "xla"):
            raise ValueError(f"attention_impl must be flash|xla, got {self.attention_impl!r}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """CLIP-family ViT encoder."""

    image_size: int = 224
    patch_size: int = 14
    d_model: int = 1280
    n_layers: int = 32
    n_heads: int = 16
    d_ff: int = 5120
    norm_eps: float = 1e-5
    use_class_token: bool = True
    use_pre_norm: bool = True
    use_post_norm: bool = False
    activation: str = "gelu"  # "gelu" | "gelu_tanh" | "quick_gelu"
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if not self.use_class_token:
            raise _not_ported(
                "SigLIP / NaViT vision towers", "Queue 1 item 10 (Idefics2)"
            )

    @property
    def n_patches(self) -> int:
        side = self.image_size // self.patch_size
        return side * side + (1 if self.use_class_token else 0)


@dataclasses.dataclass(frozen=True)
class PerceiverConfig:
    """Perceiver resampler (Idefics-9B)."""

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
