"""Wrapped-normal utilities for periodic fractional coordinates
(``matinvent_tpu/ops/wrapped_normal.py``)."""
from __future__ import annotations

import torch


def p_wrapped_normal(
    x: torch.Tensor, sigma: torch.Tensor, N: int = 10, T: float = 1.0
) -> torch.Tensor:
    """Unnormalized wrapped-normal density: sum_i exp(-(x + T*i)^2 / 2 sigma^2)."""
    p = torch.zeros_like(x)
    for i in range(-N, N + 1):
        p = p + torch.exp(-((x + T * i) ** 2) / 2.0 / sigma**2)
    return p


def d_log_p_wrapped_normal(
    x: torch.Tensor, sigma: torch.Tensor, N: int = 10, T: float = 1.0
) -> torch.Tensor:
    """Score of the wrapped normal, in the JAX package's sign convention:
    ``sum_i (x + T i)/sigma^2 exp(...) / p``, the negative of d/dx log p."""
    p = torch.zeros_like(x)
    for i in range(-N, N + 1):
        shifted = x + T * i
        p = p + shifted / sigma**2 * torch.exp(-(shifted**2) / 2.0 / sigma**2)
    return p / p_wrapped_normal(x, sigma, N, T)
