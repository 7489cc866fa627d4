"""Checkpoint IO (counterpart of ``licv_vqa_tpu/train/checkpoint.py``).

1. The ``icv_cpk.pth`` artifact, the reference's end-of-training product: a
   torch pickle with the reference's keys ``{"icv_encoder.icv": (1,L,D),
   "icv_encoder.alpha": (1,L), "use_sigmoid": bool, "lmm_args": dict}``
   (reference train.py:88-110), so a checkpoint written by either package,
   or by the PyTorch reference, loads in the others.
2. Step checkpoints for resume (JAX: Orbax): ``torch.save`` of the train
   state (encoder, temperature, optimizer, micro step) every N steps,
   published atomically, the newest ``max_to_keep`` kept, plus the loader's
   iterator state beside it where the loader has one.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional

import torch

ICV_CPK_NAME = "icv_cpk.pth"


def save_icv_checkpoint(
    save_dir: str | Path,
    icv: torch.Tensor,  # (L, D)
    alpha: torch.Tensor,  # (L,) raw (before any sigmoid)
    use_sigmoid: bool,
    lmm_args: dict,
    temperature: Optional[float] = None,
) -> Path:
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    state = {
        "icv_encoder.icv": icv.detach().float().cpu().clone()[None],
        "icv_encoder.alpha": alpha.detach().float().cpu().clone()[None],
        "use_sigmoid": bool(use_sigmoid),
        "lmm_args": dict(lmm_args),
    }
    if temperature is not None:
        state["temperature"] = torch.tensor(float(temperature))
    path = save_dir / ICV_CPK_NAME
    tmp = path.with_suffix(".tmp")
    torch.save(state, tmp)
    os.replace(tmp, path)  # atomic publish
    return path


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


class StepCheckpointer:
    """``<directory>/step_<N>.pt`` files (and ``loader_<N>.bin`` beside
    them); the newest ``max_to_keep`` are kept."""

    _STEP_RE = re.compile(r"^step_(\d+)\.pt$")

    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.max_to_keep = max_to_keep

    def all_steps(self) -> list[int]:
        if not self.directory.is_dir():
            return []
        steps = (self._STEP_RE.match(p.name) for p in self.directory.iterdir())
        return sorted(int(m.group(1)) for m in steps if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict, loader_state: Optional[bytes] = None) -> None:
        # idempotent per step: a preemption right after a restore re-saves
        # the step just restored, with the same state
        self.directory.mkdir(parents=True, exist_ok=True)
        path = self.directory / f"step_{step}.pt"
        if not path.exists():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            torch.save(state, tmp)
            os.replace(tmp, path)
        if loader_state is not None:
            lpath = self.directory / f"loader_{step}.bin"
            tmp = lpath.with_suffix(".tmp")
            tmp.write_bytes(loader_state)
            os.replace(tmp, lpath)
        for old in self.all_steps()[: -self.max_to_keep]:
            (self.directory / f"step_{old}.pt").unlink(missing_ok=True)
            (self.directory / f"loader_{old}.bin").unlink(missing_ok=True)

    def restore(self, map_location=None) -> tuple[Optional[int], Optional[dict]]:
        """``(step, state)`` of the newest checkpoint, or ``(None, None)``."""
        step = self.latest_step()
        if step is None:
            return None, None
        # only files this class wrote: tensors, dicts and numbers
        state = torch.load(
            self.directory / f"step_{step}.pt", map_location=map_location, weights_only=True
        )
        return step, state

    def restore_loader_state(self, step: int) -> Optional[bytes]:
        path = self.directory / f"loader_{step}.bin"
        return path.read_bytes() if path.exists() else None
