"""Batched crystal-lattice geometry (``matinvent_tpu/ops/lattice.py``).

Everything works on dense padded ``[B, A, ...]`` layouts. The products of
coordinates and cells are computed in float64 and rounded to float32, as the
port's other geometry (``models/cspnet.py:matmul3``): the JAX package pins
them to ``Precision.HIGHEST``, and on the card a float32 matmul may round
through TF32.
"""
from __future__ import annotations

import math

import torch


def _mm64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over the last two axes as a float64 broadcast product,
    rounded to float32."""
    a64, b64 = a.to(torch.float64), b.to(torch.float64)
    return (a64[..., :, :, None] * b64[..., None, :, :]).sum(-2).to(torch.float32)


def lattice_params_to_matrix(lengths: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Row-vector lattice matrices ``[..., 3, 3]`` from cell edge lengths
    ``[..., 3]`` (Angstrom) and angles alpha, beta, gamma ``[..., 3]``
    (degrees)."""
    angles_r = torch.deg2rad(angles)
    coses, sins = torch.cos(angles_r), torch.sin(angles_r)
    val = (coses[..., 0] * coses[..., 1] - coses[..., 2]) / (sins[..., 0] * sins[..., 1])
    # rounding may push |val| slightly above 1
    gamma_star = torch.arccos(torch.clamp(val, -1.0, 1.0))
    zeros = torch.zeros_like(lengths[..., 0])
    vector_a = torch.stack(
        [lengths[..., 0] * sins[..., 1], zeros, lengths[..., 0] * coses[..., 1]], dim=-1
    )
    vector_b = torch.stack(
        [
            -lengths[..., 1] * sins[..., 0] * torch.cos(gamma_star),
            lengths[..., 1] * sins[..., 0] * torch.sin(gamma_star),
            lengths[..., 1] * coses[..., 0],
        ],
        dim=-1,
    )
    vector_c = torch.stack([zeros, zeros, lengths[..., 2]], dim=-1)
    return torch.stack([vector_a, vector_b, vector_c], dim=-2)


def lattice_matrix_to_params(lattice: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(lengths ``[..., 3]``, angles in degrees ``[..., 3]``) of row-vector
    lattice matrices ``[..., 3, 3]``."""
    lengths = torch.sqrt(torch.sum(lattice**2, dim=-1))

    def angle(i: int) -> torch.Tensor:
        j, k = (i + 1) % 3, (i + 2) % 3
        cos = torch.sum(lattice[..., j, :] * lattice[..., k, :], dim=-1) / (
            lengths[..., j] * lengths[..., k]
        )
        return torch.arccos(torch.clamp(cos, -1.0, 1.0)) * (180.0 / math.pi)

    return lengths, torch.stack([angle(i) for i in range(3)], dim=-1)


def frac_to_cart(frac_coords: torch.Tensor, lattice: torch.Tensor,
                 regularized: bool = True) -> torch.Tensor:
    """Fractional ``[B, A, 3]`` -> Cartesian coordinates with ``[B, 3, 3]``
    cells; ``regularized`` wraps the fractional coordinates into [0, 1)
    first."""
    if regularized:
        frac_coords = frac_coords % 1.0
    return _mm64(frac_coords, lattice)


def cart_to_frac(cart_coords: torch.Tensor, lattice: torch.Tensor,
                 regularized: bool = True) -> torch.Tensor:
    """Cartesian -> fractional coordinates through the pseudo-inverse of the
    cell, so rank-deficient cells stay finite."""
    inv = torch.linalg.pinv(lattice.to(torch.float64))
    frac = _mm64(cart_coords, inv)
    if regularized:
        frac = frac % 1.0
    return frac


def lattice_volume(lattice: torch.Tensor) -> torch.Tensor:
    """Unit-cell volume (absolute determinant) of ``[..., 3, 3]`` cells."""
    return torch.abs(torch.linalg.det(lattice))
