"""Host-side crystal ``Structure`` and its extxyz/CIF IO
(``matinvent_tpu/chem/structure.py``).

Density, volume, lattice parameters, the periodic distance matrix, the
composition, and the extxyz files the pipeline writes for each iteration.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from matinvent_tpu_torch.chem.composition import Composition
from matinvent_tpu_torch.chem.data import ATOMIC_WEIGHTS, SYMBOLS, Z_BY_SYMBOL

AVOGADRO = 6.02214076e23

# 27 neighbor-cell offsets for minimum-image distances
OFFSETS_27 = np.array(
    [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
    dtype=np.float64,
)


def lattice_params_to_matrix_np(lengths: Sequence[float], angles: Sequence[float]) -> np.ndarray:
    """NumPy twin of ops.lattice.lattice_params_to_matrix for host code."""
    a, b, c = lengths
    alpha, beta, gamma = np.deg2rad(angles)
    cos_a, cos_b, cos_g = np.cos([alpha, beta, gamma])
    sin_a, sin_b = np.sin([alpha, beta])
    val = (cos_a * cos_b - cos_g) / (sin_a * sin_b)
    val = np.clip(val, -1.0, 1.0)
    gamma_star = np.arccos(val)
    vec_a = [a * sin_b, 0.0, a * cos_b]
    vec_b = [-b * sin_a * np.cos(gamma_star), b * sin_a * np.sin(gamma_star), b * cos_a]
    vec_c = [0.0, 0.0, c]
    return np.array([vec_a, vec_b, vec_c], dtype=np.float64)


@dataclass
class Structure:
    """A periodic crystal: lattice (rows = cell vectors), species, frac coords."""

    lattice: np.ndarray  # [3, 3]
    species: np.ndarray  # [N] int atomic numbers
    frac_coords: np.ndarray  # [N, 3]

    def __post_init__(self):
        self.lattice = np.asarray(self.lattice, dtype=np.float64).reshape(3, 3)
        self.species = np.asarray(self.species, dtype=np.int64).reshape(-1)
        self.frac_coords = np.asarray(self.frac_coords, dtype=np.float64).reshape(-1, 3)
        if len(self.species) != len(self.frac_coords):
            raise ValueError("species/frac_coords length mismatch")

    @classmethod
    def from_parameters(
        cls,
        lengths: Sequence[float],
        angles: Sequence[float],
        species: Sequence[int],
        frac_coords: np.ndarray,
    ) -> "Structure":
        return cls(lattice_params_to_matrix_np(lengths, angles), np.asarray(species), frac_coords)

    # -------------------------------------------------------------- geometry
    @property
    def num_atoms(self) -> int:
        return len(self.species)

    @property
    def volume(self) -> float:
        return float(abs(np.linalg.det(self.lattice)))

    @property
    def lengths(self) -> np.ndarray:
        return np.linalg.norm(self.lattice, axis=1)

    @property
    def angles(self) -> np.ndarray:
        L = self.lattice
        lens = self.lengths
        ang = []
        for i in range(3):
            j, k = (i + 1) % 3, (i + 2) % 3
            cos = np.dot(L[j], L[k]) / (lens[j] * lens[k])
            ang.append(math.degrees(math.acos(np.clip(cos, -1, 1))))
        return np.array(ang)

    @property
    def cart_coords(self) -> np.ndarray:
        return (self.frac_coords % 1.0) @ self.lattice

    @property
    def composition(self) -> Composition:
        return Composition(self.species)

    @property
    def density(self) -> float:
        """g/cm^3, as pymatgen's ``Structure.density``."""
        mass_g = sum(ATOMIC_WEIGHTS[SYMBOLS[int(z)]] for z in self.species) / AVOGADRO
        vol_cm3 = self.volume * 1e-24
        if not np.isfinite(vol_cm3) or vol_cm3 <= 0.0:
            return float("nan")
        return mass_g / vol_cm3

    def distance_matrix(self) -> np.ndarray:
        """[N, N] minimum-image pairwise distances (27-offset search).

        Cached: structures are treated as immutable after construction, and
        validity + matcher fingerprints both need this matrix."""
        cached = getattr(self, "_dm_cache", None)
        if cached is not None:
            return cached
        cart = self.cart_coords
        offsets = OFFSETS_27 @ self.lattice  # [27, 3]
        diff = cart[None, :, :] - cart[:, None, :]  # [N, N, 3]
        d = diff[:, :, None, :] + offsets[None, None, :, :]  # [N, N, 27, 3]
        dists = np.linalg.norm(d, axis=-1)
        out = dists.min(axis=-1)
        object.__setattr__(self, "_dm_cache", out)
        return out

    def min_interatomic_distance(self) -> float:
        """Smallest atom-atom distance incl. periodic self-images."""
        n = self.num_atoms
        dm = self.distance_matrix()
        if n > 1:
            off_diag = dm[~np.eye(n, dtype=bool)].min()
        else:
            off_diag = np.inf
        # self-image distances: shortest nonzero lattice translation
        offsets = OFFSETS_27 @ self.lattice
        self_img = np.linalg.norm(offsets, axis=1)
        self_img = self_img[self_img > 1e-8].min()
        return float(min(off_diag, self_img))

    # --------------------------------------------------------------------- IO
    def to_extxyz_block(self) -> str:
        L = self.lattice.reshape(-1)
        lat_str = " ".join(f"{v:.8f}" for v in L)
        lines = [str(self.num_atoms)]
        lines.append(
            f'Lattice="{lat_str}" Properties=species:S:1:pos:R:3 pbc="T T T"'
        )
        cart = self.cart_coords
        for z, pos in zip(self.species, cart):
            sym = SYMBOLS[int(z)]
            lines.append(f"{sym} {pos[0]:.8f} {pos[1]:.8f} {pos[2]:.8f}")
        return "\n".join(lines)

    def to_cif(self) -> str:
        """Minimal P1 CIF (the long-term memory's audit trail)."""
        a, b, c = self.lengths
        al, be, ga = self.angles
        comp = self.composition
        lines = [
            f"data_{comp.reduced_formula}",
            f"_chemical_formula_sum '{comp.formula}'",
            f"_cell_length_a {a:.6f}",
            f"_cell_length_b {b:.6f}",
            f"_cell_length_c {c:.6f}",
            f"_cell_angle_alpha {al:.6f}",
            f"_cell_angle_beta {be:.6f}",
            f"_cell_angle_gamma {ga:.6f}",
            "_symmetry_space_group_name_H-M 'P 1'",
            "_symmetry_Int_Tables_number 1",
            "loop_",
            "_atom_site_type_symbol",
            "_atom_site_label",
            "_atom_site_fract_x",
            "_atom_site_fract_y",
            "_atom_site_fract_z",
            "_atom_site_occupancy",
        ]
        for i, (z, fc) in enumerate(zip(self.species, self.frac_coords % 1.0)):
            sym = SYMBOLS[int(z)]
            lines.append(f"{sym} {sym}{i} {fc[0]:.6f} {fc[1]:.6f} {fc[2]:.6f} 1.0")
        return "\n".join(lines) + "\n"

    def __repr__(self) -> str:
        return f"Structure({self.composition.reduced_formula}, n={self.num_atoms})"


def save_extxyz(structures: Sequence[Structure], path: str) -> str:
    """Write structures to one extxyz file."""
    with open(path, "w") as fh:
        for s in structures:
            fh.write(s.to_extxyz_block() + "\n")
    return path


def read_extxyz(path: str, limit: int | None = None) -> list[Structure]:
    """Parse an extxyz file written by :func:`save_extxyz` (its first
    ``limit`` structures, when given)."""
    structures = []
    with open(path) as fh:
        lines = fh.read().splitlines()
    i = 0
    while i < len(lines) and (limit is None or len(structures) < limit):
        if not lines[i].strip():
            i += 1
            continue
        n = int(lines[i].strip())
        header = lines[i + 1]
        lat_str = header.split('Lattice="')[1].split('"')[0]
        lattice = np.array([float(v) for v in lat_str.split()]).reshape(3, 3)
        species, cart = [], []
        for row in lines[i + 2 : i + 2 + n]:
            parts = row.split()
            species.append(Z_BY_SYMBOL[parts[0]])
            cart.append([float(parts[1]), float(parts[2]), float(parts[3])])
        cart = np.asarray(cart)
        frac = cart @ np.linalg.pinv(lattice)
        structures.append(Structure(lattice, np.asarray(species), frac % 1.0))
        i += 2 + n
    return structures
