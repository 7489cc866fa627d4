from .checkpoint import ICV_CPK_NAME, StepCheckpointer, load_icv_checkpoint, save_icv_checkpoint

__all__ = ["ICV_CPK_NAME", "StepCheckpointer", "load_icv_checkpoint", "save_icv_checkpoint"]
