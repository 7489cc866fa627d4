"""The learnable ICV and the subset-layer intervention helpers (counterpart
of ``licv_vqa_tpu/icv/encoder.py``).

``GlobalICVEncoder`` has the reference encoder's semantics
(icv_src/icv_encoder/global_icv_encoder.py:5-43): ``alpha`` (L,) filled with
``alpha_init_value``, ``icv`` (L, D) drawn N(0, 0.01²), sigmoid on alpha iff
``use_sigmoid``.  Both stay f32 (optimizer math); the model casts the scaled
rows to its compute dtype at injection.  ``alpha_learnable=False`` leaves
alpha without ``requires_grad``, as the reference freezes it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn


class GlobalICVEncoder(nn.Module):
    def __init__(
        self,
        lmm_hidden_dim: int,
        lmm_layers: int,
        alpha_learnable: bool = True,
        alpha_init_value: float = 0.0,
        use_sigmoid: bool = False,
        generator: Optional[torch.Generator] = None,
        device="cpu",
    ):
        super().__init__()
        self.alpha_learnable = bool(alpha_learnable)
        self.use_sigmoid = bool(use_sigmoid)
        # drawn on the CPU from ``generator`` and moved, so one seed gives
        # one init on every device
        icv = torch.randn((lmm_layers, lmm_hidden_dim), generator=generator) * 0.01
        self.icv = nn.Parameter(icv.to(device))
        self.alpha = nn.Parameter(
            torch.full((lmm_layers,), float(alpha_init_value), device=device),
            requires_grad=self.alpha_learnable,
        )

    def get_alpha(self) -> torch.Tensor:
        return torch.sigmoid(self.alpha) if self.use_sigmoid else self.alpha

    def scaled_icv(self) -> torch.Tensor:
        """(L, D) injection rows ``alpha_l · v_l`` (reference
        icv_src/icv_module.py:89-92, inference.py:310-311)."""
        return self.get_alpha()[:, None] * self.icv

    @torch.no_grad()
    def load_params(self, params: dict) -> None:
        """Set ``icv`` and ``alpha`` from arrays (a JAX ``ICVParams`` dict)."""
        for name in ("icv", "alpha"):
            value = torch.from_numpy(np.array(params[name], dtype=np.float32))
            getattr(self, name).copy_(value)


def prepare_intervention_layers(intervention_layer, total_layers: int) -> list[int]:
    """Reference semantics (icv_intervention.py:39-42): ``-1`` → all layers,
    int → that single layer, list → as given."""
    if intervention_layer == -1 or intervention_layer is None:
        return list(range(total_layers))
    if isinstance(intervention_layer, int):
        return [intervention_layer]
    return [int(x) for x in intervention_layer]


def expand_icv_to_layers(
    icv_scaled: Optional[torch.Tensor],  # (K, D) for the K intervened layers
    layers: list[int],
    total_layers: int,
):
    """(K, D) → ((L, D) rows, [L] enable flags).  Layers not in ``layers``
    carry a zero row and a False flag: the injection is skipped entirely.
    The flags are host bools (a list), so the decoder decides per layer
    without reading the device."""
    if icv_scaled is None:
        return None
    d = icv_scaled.shape[-1]
    rows = torch.zeros((total_layers, d), dtype=icv_scaled.dtype, device=icv_scaled.device)
    rows[torch.tensor(layers, dtype=torch.long, device=icv_scaled.device)] = icv_scaled
    flags = [False] * total_layers
    for i in layers:
        flags[i] = True
    return rows, flags
