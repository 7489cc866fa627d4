from .icv_inject import icv_inject, icv_inject_reference

__all__ = ["icv_inject", "icv_inject_reference"]
