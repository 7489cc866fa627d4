from .precision import Precision, PrecisionPolicy, to_torch_dtype

__all__ = ["Precision", "PrecisionPolicy", "to_torch_dtype"]
