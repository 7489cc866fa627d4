"""The ``icv_cpk.pth`` artifact, read side (counterpart of
``licv_vqa_tpu/train/checkpoint.py::load_icv_checkpoint``, :61-81).

The file is a torch pickle with the reference's keys
``{"icv_encoder.icv": (1,L,D), "icv_encoder.alpha": (1,L), "use_sigmoid":
bool, "lmm_args": dict}`` (reference train.py:88-110), so a checkpoint
written by either package, or by the PyTorch reference, loads here.  Saving
belongs to the training slice (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

from pathlib import Path

import torch

ICV_CPK_NAME = "icv_cpk.pth"


def load_icv_checkpoint(path: str | Path, device="cpu") -> dict:
    """Returns ``{"icv": (L, D) f32, "alpha": (L,) f32 (sigmoid applied iff
    use_sigmoid — reference inference.py:99-100), "lmm_args": dict}``."""
    path = Path(path)
    if path.is_dir():
        path = path / ICV_CPK_NAME
    # the artifact carries a plain dict (lmm_args) beside the tensors
    state = torch.load(path, map_location="cpu", weights_only=False)
    icv = state["icv_encoder.icv"].float()[0]
    alpha = state["icv_encoder.alpha"].float()[0]
    if state.get("use_sigmoid", None):
        alpha = torch.sigmoid(alpha)
    return {
        "icv": icv.to(device),
        "alpha": alpha.to(device),
        "lmm_args": dict(state.get("lmm_args", {})),
    }
