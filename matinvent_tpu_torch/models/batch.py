"""Statically padded crystal batch (``matinvent_tpu/models/batch.py``).

Every crystal is padded to ``max_atoms``; per-atom tensors are dense
``[B, A, ...]`` with a validity mask derived from ``num_atoms``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

MAX_ATOMIC_NUM = 100


@dataclass
class CrystalBatch:
    """A batch of (possibly noisy) crystals with static shapes.

    Attributes:
        atom_types: ``[B, A]`` int atomic numbers (1-based; 0 = padding).
        frac_coords: ``[B, A, 3]`` fractional coordinates.
        lattice: ``[B, 3, 3]`` row-vector lattice matrices.
        num_atoms: ``[B]`` int true atom counts.
    """

    atom_types: torch.Tensor
    frac_coords: torch.Tensor
    lattice: torch.Tensor
    num_atoms: torch.Tensor

    @property
    def batch_size(self) -> int:
        return self.num_atoms.shape[0]

    @property
    def max_atoms(self) -> int:
        return self.frac_coords.shape[1]

    @property
    def mask(self) -> torch.Tensor:
        """``[B, A]`` bool: True for real atoms, False for padding."""
        ar = torch.arange(self.max_atoms, device=self.num_atoms.device)
        return ar[None, :] < self.num_atoms[:, None]

    def atom_onehot(self, num_classes: int = MAX_ATOMIC_NUM) -> torch.Tensor:
        """``[B, A, K]`` one-hot of (atom_types - 1); zeros on padding."""
        oh = torch.nn.functional.one_hot(
            (self.atom_types.long() - 1).clamp(min=0), num_classes
        ).to(self.frac_coords.dtype)
        return oh * self.mask[..., None].to(oh.dtype)

    def to(self, device: str | torch.device) -> "CrystalBatch":
        return CrystalBatch(
            atom_types=self.atom_types.to(device),
            frac_coords=self.frac_coords.to(device),
            lattice=self.lattice.to(device),
            num_atoms=self.num_atoms.to(device),
        )

    @classmethod
    def from_lists(
        cls,
        atom_types: Sequence[np.ndarray],
        frac_coords: Sequence[np.ndarray],
        lattices: Sequence[np.ndarray],
        max_atoms: int | None = None,
    ) -> "CrystalBatch":
        """Pad a host-side list of crystals into one (CPU) batch."""
        n = np.array([len(a) for a in atom_types], dtype=np.int32)
        a_max = int(max_atoms if max_atoms is not None else n.max())
        if (n > a_max).any():
            raise ValueError(f"crystal with {n.max()} atoms exceeds max_atoms={a_max}")
        B = len(atom_types)
        at = np.zeros((B, a_max), dtype=np.int32)
        fc = np.zeros((B, a_max, 3), dtype=np.float32)
        lat = np.zeros((B, 3, 3), dtype=np.float32)
        for i in range(B):
            at[i, : n[i]] = np.asarray(atom_types[i], dtype=np.int32)
            fc[i, : n[i]] = np.asarray(frac_coords[i], dtype=np.float32)
            lat[i] = np.asarray(lattices[i], dtype=np.float32)
        return cls(
            atom_types=torch.from_numpy(at),
            frac_coords=torch.from_numpy(fc),
            lattice=torch.from_numpy(lat),
            num_atoms=torch.from_numpy(n),
        )

    def to_lists(self) -> list[dict]:
        """Split back into host-side per-crystal dicts (drops padding)."""
        at = self.atom_types.cpu().numpy()
        fc = self.frac_coords.cpu().numpy()
        lat = self.lattice.cpu().numpy()
        n = self.num_atoms.cpu().numpy()
        out = []
        for i in range(self.batch_size):
            k = int(n[i])
            out.append(
                dict(
                    atom_types=at[i, :k].copy(),
                    frac_coords=fc[i, :k].copy(),
                    lattice=lat[i].copy(),
                    num_atoms=k,
                )
            )
        return out
