"""DiffCSP helpers the MatterGen sampler needs (``matinvent_tpu/models/diffcsp.py``).

Only the time embedding is ported so far; the DiffCSP family itself is later
work.
"""
from __future__ import annotations

import math

import torch


def sinusoidal_time_embedding(times: torch.Tensor, dim: int) -> torch.Tensor:
    """Transformer-style time embedding ``[N] -> [N, dim]``, in float32."""
    half_dim = dim // 2
    factor = math.log(10000.0) / (half_dim - 1)
    freqs = torch.exp(
        torch.arange(half_dim, dtype=torch.float32, device=times.device) * -factor
    )
    emb = times.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
