"""Batched structure relaxation on the device (``matinvent_tpu/chem/relax.py``).

A relaxer is any callable ``(structures) -> (relaxed_structures,
energies)``. ``SoftSphereRelaxer`` is the default: gradient descent on a
smooth pair potential (soft-sphere repulsion and a Morse-like attraction
scaled by covalent radii) over the padded batch, all structures at once.
It is not a trained MLIP: its energies are screening-grade, good for
removing overlaps and ranking. The JAX ``lax.scan`` of ``jax.grad`` steps
is a loop of ``torch.autograd.grad`` steps here.

The geometry products (fractional to cartesian, the lattice offsets) are
written as explicit f32 sums (``matvec3``), which no TF32 setting reaches:
the JAX package pins ``Precision.HIGHEST`` on them, because the phonon
workflow takes second derivatives of these distances.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from matinvent_tpu_torch.chem.structure import OFFSETS_27, Structure, save_extxyz
from matinvent_tpu_torch.device import resolve_device
from matinvent_tpu_torch.models.batch import CrystalBatch

# Covalent radii (Angstrom, Cordero 2008-style, public data); index = Z.
COVALENT_RADII = np.array(
    [0.2,
     0.31, 0.28, 1.28, 0.96, 0.84, 0.76, 0.71, 0.66, 0.57, 0.58,
     1.66, 1.41, 1.21, 1.11, 1.07, 1.05, 1.02, 1.06, 2.03, 1.76,
     1.70, 1.60, 1.53, 1.39, 1.39, 1.32, 1.26, 1.24, 1.32, 1.22,
     1.22, 1.20, 1.19, 1.20, 1.20, 1.16, 2.20, 1.95, 1.90, 1.75,
     1.64, 1.54, 1.47, 1.46, 1.42, 1.39, 1.45, 1.44, 1.42, 1.39,
     1.39, 1.38, 1.39, 1.40, 2.44, 2.15, 2.07, 2.04, 2.03, 2.01,
     1.99, 1.98, 1.98, 1.96, 1.94, 1.92, 1.92, 1.89, 1.90, 1.87,
     1.87, 1.75, 1.70, 1.62, 1.51, 1.44, 1.41, 1.36, 1.36, 1.32,
     1.45, 1.46, 1.48, 1.40, 1.50, 1.50, 2.60, 2.21, 2.15, 2.06,
     2.00, 1.96, 1.90, 1.87, 1.80, 1.69, 1.69, 1.68, 1.67, 1.66],
    dtype=np.float32,
)


def matvec3(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``x @ m`` for row vectors ``x [..., n, 3]`` and ``m [..., 3, 3]``, as
    three f32 products summed in order (never TF32)."""
    return (x[..., :, 0:1] * m[..., None, 0, :] + x[..., :, 1:2] * m[..., None, 1, :]
            + x[..., :, 2:3] * m[..., None, 2, :])


def pair_energy(
    frac_coords: torch.Tensor,  # [B, A, 3]
    lattice: torch.Tensor,  # [B, 3, 3]
    atom_types: torch.Tensor,  # [B, A] int
    mask: torch.Tensor,  # [B, A] bool
    radii: torch.Tensor,  # [100] f32
) -> torch.Tensor:
    """Per-crystal smooth pair energy ``[B]`` over the 27 minimum-image
    offsets (``matinvent_tpu/chem/relax.py:_pair_energy``)."""
    cart = matvec3(torch.remainder(frac_coords, 1.0), lattice)
    offsets = torch.as_tensor(OFFSETS_27, dtype=lattice.dtype, device=lattice.device)
    offsets = matvec3(offsets.expand(lattice.shape[0], 27, 3), lattice)  # [B, 27, 3]
    diff = cart[:, :, None, :] - cart[:, None, :, :]  # [B, A, A, 3]
    d = diff[:, :, :, None, :] + offsets[:, None, None, :, :]  # [B, A, A, 27, 3]
    dist = torch.sqrt(torch.sum(d**2, -1) + 1e-12)

    r = radii[atom_types.long()]  # [B, A] (0 -> dummy radius)
    r0 = r[:, :, None] + r[:, None, :]  # equilibrium distance [B, A, A]
    pair_mask = (mask[:, :, None] & mask[:, None, :]).to(dist.dtype)
    # drop the zero-distance self term (same atom, zero offset)
    A = dist.shape[1]
    self_term = torch.zeros(1, A, A, 27, dtype=torch.bool, device=dist.device)
    self_term[0, :, :, 13] = torch.eye(A, dtype=torch.bool, device=dist.device)
    dist = torch.where(self_term, torch.full_like(dist, 1e6), dist)

    x = dist / r0[..., None]
    # Morse-like: repulsive near overlap, shallow minimum at x=1, ~0 beyond 2
    e = torch.exp(-2.0 * 3.0 * (x - 1.0)) - 2.0 * torch.exp(-3.0 * (x - 1.0))
    e = torch.where(x < 2.5, e, torch.zeros_like(e))
    e = torch.sum(e, dim=-1) * pair_mask  # sum over images
    return 0.5 * torch.sum(e, dim=(1, 2))


class SoftSphereRelaxer:
    """Batched relaxer: joint gradient descent on fractional coords and cell,
    on ``device`` (the card unless ``"cpu"`` is asked for). Structures of
    more than ``max_atoms`` atoms pass through unchanged, with a NaN
    energy."""

    def __init__(
        self,
        steps: int = 200,
        lr_coords: float = 2e-3,
        lr_cell: float = 2e-3,
        max_atoms: int = 20,
        depth_scale: float = 0.3,
        device: str | torch.device | None = None,
    ):
        self.steps = steps
        self.lr_coords = lr_coords
        self.lr_cell = lr_cell
        self.max_atoms = max_atoms
        self.depth_scale = depth_scale
        self.device = resolve_device(device)
        self.radii = torch.as_tensor(COVALENT_RADII, device=self.device)

    def relax_batch(self, batch: CrystalBatch) -> tuple[CrystalBatch, torch.Tensor]:
        """``steps`` descent steps on a padded batch on the device; returns
        the relaxed batch and its energies ``[B]`` (times ``depth_scale``)."""
        types, mask = batch.atom_types, batch.mask
        frac, lat = batch.frac_coords, batch.lattice
        for _ in range(self.steps):
            with torch.enable_grad():
                frac = frac.detach().requires_grad_(True)
                lat = lat.detach().requires_grad_(True)
                energy = pair_energy(frac, lat, types, mask, self.radii).sum()
                g_frac, g_lat = torch.autograd.grad(energy, (frac, lat))
            frac = torch.remainder(frac.detach() - self.lr_coords * g_frac, 1.0)
            lat = lat.detach() - self.lr_cell * g_lat
        final = CrystalBatch(atom_types=types, frac_coords=frac, lattice=lat,
                             num_atoms=batch.num_atoms)
        with torch.no_grad():
            energies = pair_energy(frac, lat, types, mask, self.radii) * self.depth_scale
        return final, energies

    def __call__(
        self, structures: Sequence[Structure], xyz_path: str | None = None
    ) -> tuple[List[Structure], List[float]]:
        """``xyz_path``: when given, the relaxed structures are written back
        to it (the pipeline's ``mlip_opt`` overwrites the valid samples'
        extxyz)."""
        if not structures:
            return [], []
        ok = [s.num_atoms <= self.max_atoms for s in structures]
        batchable = [s for s, m in zip(structures, ok) if m]
        out_strucs = list(structures)
        energies = [float("nan")] * len(structures)
        if batchable:
            batch = CrystalBatch.from_lists(
                [s.species for s in batchable],
                [s.frac_coords for s in batchable],
                [s.lattice for s in batchable],
                max_atoms=self.max_atoms,
            ).to(self.device)
            relaxed, e = self.relax_batch(batch)
            dicts = relaxed.to_lists()
            e = e.cpu().numpy().astype(float)
            j = 0
            for i, m in enumerate(ok):
                if m:
                    d = dicts[j]
                    out_strucs[i] = Structure(d["lattice"], d["atom_types"], d["frac_coords"])
                    energies[i] = float(e[j])
                    j += 1
        if xyz_path:
            save_extxyz(out_strucs, xyz_path)
        return out_strucs, energies
