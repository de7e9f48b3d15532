"""Masked segment reductions over padded crystal batches
(``matinvent_tpu/ops/segment.py``)."""
from __future__ import annotations

import torch


def masked_mean(
    x: torch.Tensor, mask: torch.Tensor, axis: int, eps: float = 1e-12
) -> torch.Tensor:
    """Mean of ``x`` over ``axis`` counting only entries where ``mask`` is set.

    ``mask`` is boolean or 0/1 and broadcastable to ``x``.
    """
    mask = mask.to(x.dtype)
    total = torch.sum(x * mask, dim=axis)
    count = torch.sum(mask, dim=axis)
    return total / torch.clamp(count, min=eps)


def graph_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-crystal mean over the atom axis: ``[B, A(, F)]`` -> ``[B(, F)]``."""
    m = mask[..., None] if x.dim() == mask.dim() + 1 else mask
    return masked_mean(x, m, axis=1)
