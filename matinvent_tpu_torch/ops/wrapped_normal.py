"""Wrapped-normal utilities for periodic fractional coordinates
(``matinvent_tpu/ops/wrapped_normal.py``)."""
from __future__ import annotations

import numpy as np
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


def log_prob_wrapped_normal(
    x: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor, N: int = 10, T: float = 1.0
) -> torch.Tensor:
    """Unnormalized wrapped-normal log-density of ``x`` around ``mu`` (no
    normalizing constant: used for log-prob differences), as a log-sum-exp
    over the ``2N + 1`` images."""
    terms = torch.stack(
        [-((x - mu + T * i) ** 2) / 2.0 / sigma**2 for i in range(-N, N + 1)], dim=0
    )
    return torch.logsumexp(terms, dim=0)


def d_log_p_wrapped_normal_np(x: np.ndarray, sigma: np.ndarray, N: int = 10,
                              T: float = 1.0) -> np.ndarray:
    """``d_log_p_wrapped_normal`` in numpy, in the dtype of ``x`` (the
    schedule's host-side Monte-Carlo normalizer)."""
    dt = x.dtype.type
    s2 = sigma * sigma
    num = np.zeros_like(x)
    den = np.zeros_like(x)
    for i in range(-N, N + 1):
        shifted = x + dt(T * i)
        e = np.exp(-(shifted * shifted) / dt(2.0) / s2)
        num += shifted / s2 * e
        den += e
    return num / den
