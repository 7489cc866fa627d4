"""Subset-layer intervention helpers (counterpart of
``licv_vqa_tpu/icv/encoder.py``: ``prepare_intervention_layers`` :66 and
``expand_icv_to_layers`` :78).  The trainable encoder itself belongs to the
training slice (ROADMAP Queue 1 item 8)."""

from __future__ import annotations

from typing import Optional

import torch


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
