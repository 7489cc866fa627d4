from .decode import beam_generate, greedy_generate
from .runner import icl_inference, icv_inference

__all__ = ["beam_generate", "greedy_generate", "icl_inference", "icv_inference"]
