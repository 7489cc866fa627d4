from .checkpoint import ICV_CPK_NAME, load_icv_checkpoint

__all__ = ["ICV_CPK_NAME", "load_icv_checkpoint"]
