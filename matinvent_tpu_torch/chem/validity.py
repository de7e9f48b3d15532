"""Structural sanity of sampled crystals (``matinvent_tpu/chem/validity.py:88-110``),
batched on the batch's device."""
from __future__ import annotations

import itertools

import torch

from matinvent_tpu_torch.models.batch import CrystalBatch

# 27 neighbour-cell offsets for minimum-image distances
_OFFSETS_27 = tuple(itertools.product((-1, 0, 1), repeat=3))


def structure_validity(
    batch: CrystalBatch, cutoff: float = 0.5, min_volume: float = 0.1
) -> torch.Tensor:
    """``[B]`` bool: finite lattice and coords, species in 1..100, at least
    one atom, cell volume >= ``min_volume`` (A^3) and no two atoms (or an
    atom and its own periodic image) closer than ``cutoff`` (A)."""
    f64 = torch.float64
    lat = batch.lattice.to(f64)  # [B, 3, 3] rows = cell vectors
    frac = batch.frac_coords.to(f64)  # [B, A, 3]
    mask = batch.mask
    B, A = mask.shape
    real = mask[..., None]
    finite = torch.isfinite(lat).flatten(1).all(1) & (
        torch.isfinite(frac) | ~real
    ).flatten(1).all(1)
    species = batch.atom_types
    species_ok = (((species >= 1) & (species <= 100)) | ~mask).all(1)
    volume = torch.linalg.det(lat).abs()

    lat0 = torch.where(torch.isfinite(lat), lat, torch.zeros_like(lat))
    frac0 = torch.where(torch.isfinite(frac) & real, frac, torch.zeros_like(frac))
    offsets = torch.tensor(_OFFSETS_27, dtype=f64, device=lat.device) @ lat0  # [B, 27, 3]
    cart = frac0 @ lat0  # [B, A, 3]
    diff = cart[:, None, :, :] - cart[:, :, None, :]  # [B, A, A, 3]
    d = torch.linalg.norm(diff[:, :, :, None, :] + offsets[:, None, None], dim=-1)
    dm = d.min(dim=-1).values  # [B, A, A] minimum-image distances
    pair = mask[:, :, None] & mask[:, None, :] & ~torch.eye(A, dtype=torch.bool, device=mask.device)
    inf = torch.full_like(dm, float("inf"))
    off_diag = torch.where(pair, dm, inf).flatten(1).min(1).values
    img = torch.linalg.norm(offsets, dim=-1)  # [B, 27]
    self_img = torch.where(img > 1e-8, img, torch.full_like(img, float("inf"))).min(1).values
    min_dist = torch.minimum(off_diag, self_img)
    return (
        finite & species_ok & (volume >= min_volume) & (batch.num_atoms > 0)
        & (min_dist >= cutoff)
    )
