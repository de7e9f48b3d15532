"""Native harmonic-phonon and elastic screening on the soft-sphere potential
(``matinvent_tpu/chem/phonon.py``).

The in-tree fallback of the MLIP reward workers (quacc ``relax_job`` +
``phonon_flow`` for the heat capacity at 300 K, ``elastic_tensor_flow``
for the bulk modulus), on the pair potential of ``chem.relax``:

* ``gamma_heat_capacity``: equilibrate, build a supercell, take the
  Γ-point dynamical matrix as the mass-weighted Hessian of the pair energy
  (``torch.func`` on the device), and evaluate the harmonic constant-volume
  heat capacity C_v(T) = k_B Σ x² eˣ/(eˣ−1)², x = ħω/k_BT, in J/(g·K).
* ``soft_sphere_bulk_modulus``: B = V₀ d²E/dV² from the curvature of the
  isotropic-strain energy curve, in GPa.

Both are screening-grade (the potential is not a trained MLIP; the well
depth is ``depth_eV`` per bond, the relaxer's ``depth_scale``). The
energies and the Hessian are computed in f32 on the device; the
eigenvalues, the scale search and C_v stay float64 numpy on the host, as
in the JAX package. A structure whose spectrum cannot be computed (a
singular cell, eigenvalues that do not converge) gets NaN; any other
failure raises.
"""
from __future__ import annotations

import logging
from typing import List, Sequence

import numpy as np
import torch

from matinvent_tpu_torch.chem.data import ATOMIC_WEIGHTS, SYMBOLS
from matinvent_tpu_torch.chem.relax import (
    COVALENT_RADII,
    SoftSphereRelaxer,
    matvec3,
    pair_energy,
)
from matinvent_tpu_torch.chem.structure import Structure
from matinvent_tpu_torch.device import resolve_device

# physical constants (SI)
_HBAR = 1.054571817e-34  # J s
_KB = 1.380649e-23  # J / K
_EV = 1.602176634e-19  # J
_AMU = 1.66053906660e-27  # kg
_EV_A2_AMU_TO_RAD2_S2 = _EV / (_AMU * 1e-20)  # (eV/Å²/amu) -> rad²/s²
_EV_PER_A3_TO_GPA = 160.21766208

MASSES_AMU = np.array(
    [1.0] + [ATOMIC_WEIGHTS.get(SYMBOLS[z], float("nan")) for z in range(1, 100)],
    dtype=np.float64,
)

# the Hessian's columns per vmapped chunk: a 160-atom supercell's pair
# tensors are 160·160·27·3 floats per column, so a chunk of 48 holds each
# intermediate under 0.5 GB
HESSIAN_CHUNK = 48


def supercell(structure: Structure, reps: tuple[int, int, int]) -> Structure:
    """Integer replication of the cell (species and coords tiled, lattice scaled)."""
    n1, n2, n3 = reps
    shifts = np.array(
        [[i, j, k] for i in range(n1) for j in range(n2) for k in range(n3)],
        dtype=np.float64,
    )  # [R, 3]
    frac = (structure.frac_coords[None, :, :] + shifts[:, None, :]).reshape(-1, 3)
    frac = frac / np.array(reps, dtype=np.float64)
    lattice = structure.lattice * np.array(reps, dtype=np.float64)[:, None]
    species = list(structure.species) * len(shifts)
    return Structure(species=species, frac_coords=frac, lattice=lattice)


def choose_reps(
    structure: Structure, min_length: float = 8.0, max_atoms: int = 160
) -> tuple[int, int, int]:
    """Replicate short axes toward ``min_length`` Å under an atom budget,
    the shortest axes first: the 27-offset pair sum sees first-shell images
    only, so the Γ-point-of-supercell approximation needs each axis longer
    than twice the interaction cutoff."""
    reps = [1, 1, 1]
    lengths = structure.lengths.astype(float)
    while True:
        grown = False
        order = np.argsort([lengths[i] * reps[i] for i in range(3)])
        for ax in order:
            new = reps.copy()
            new[ax] += 1
            if (
                lengths[ax] * reps[ax] < min_length
                and structure.num_atoms * int(np.prod(new)) <= max_atoms
            ):
                reps = new
                grown = True
                break
        if not grown:
            return tuple(reps)


def pair_hessian(structure: Structure, device: torch.device) -> torch.Tensor:
    """``[3A, 3A]`` f32 Hessian of the pair energy with respect to cartesian
    displacements, at the structure as given: reverse over reverse
    (``torch.func.jacrev`` of ``torch.func.grad``), its columns in vmapped
    chunks of ``HESSIAN_CHUNK``."""
    A = structure.num_atoms
    radii = torch.as_tensor(COVALENT_RADII, device=device)
    frac0 = torch.as_tensor(structure.frac_coords % 1.0, dtype=torch.float32, device=device)
    lattice = torch.as_tensor(structure.lattice, dtype=torch.float32, device=device)
    types = torch.as_tensor(structure.species, dtype=torch.int64, device=device)
    inv_lat = torch.linalg.inv(lattice)
    cart0 = matvec3(frac0, lattice)
    mask = torch.ones(1, A, dtype=torch.bool, device=device)

    def energy(u_flat):
        frac = matvec3(cart0 + u_flat.reshape(A, 3), inv_lat)
        return pair_energy(frac[None], lattice[None], types[None], mask, radii)[0]

    hess = torch.func.jacrev(torch.func.grad(energy), chunk_size=HESSIAN_CHUNK)
    return hess(torch.zeros(3 * A, device=device))


def gamma_frequencies(
    structure: Structure, depth_eV: float = 0.3, device: str | torch.device | None = None
) -> np.ndarray:
    """Γ-point angular frequencies (rad/s) of the structure as given.

    Mass-weighted Hessian eigenvalues; negative curvatures (unstable modes)
    come back as negative frequencies, for the caller to treat."""
    hess = pair_hessian(structure, resolve_device(device))
    h = hess.detach().cpu().numpy().astype(np.float64) * depth_eV  # eV / Å²
    m = np.repeat(MASSES_AMU[np.asarray(structure.species)], 3)  # [3A] amu
    dyn = h / np.sqrt(m[:, None] * m[None, :])
    w2 = np.linalg.eigvalsh((dyn + dyn.T) / 2.0) * _EV_A2_AMU_TO_RAD2_S2
    return np.sign(w2) * np.sqrt(np.abs(w2))


def harmonic_heat_capacity(
    omega: np.ndarray, mass_amu: float, temperature: float = 300.0
) -> float:
    """C_v from harmonic frequencies, J/(g·K). Drops non-positive modes
    (3 acoustic translations at Γ plus any imaginary ones)."""
    w = omega[omega > 1e10]  # rad/s; ~0.0016 THz floor
    if w.size == 0:
        return float("nan")
    x = _HBAR * w / (_KB * temperature)
    # x² eˣ/(eˣ−1)² as x² e⁻ˣ/(1−e⁻ˣ)²: stable for stiff modes
    ex = np.exp(-x)
    cv = _KB * np.sum(x**2 * ex / (1.0 - ex) ** 2)  # J/K
    mass_g = mass_amu * _AMU * 1e3
    return float(cv / mass_g)


def strain_energies(
    structure: Structure, scales: np.ndarray, device: torch.device
) -> np.ndarray:
    """Pair energy (float64 on the host) of the structure with its lattice
    scaled by each of ``scales``, one f32 batch on the device."""
    frac = torch.as_tensor(structure.frac_coords % 1.0, dtype=torch.float32, device=device)
    lattice = torch.as_tensor(structure.lattice, dtype=torch.float32, device=device)
    types = torch.as_tensor(structure.species, dtype=torch.int64, device=device)
    s = torch.as_tensor(np.asarray(scales, dtype=np.float32), device=device)
    n, A = s.shape[0], structure.num_atoms
    mask = torch.ones(n, A, dtype=torch.bool, device=device)
    radii = torch.as_tensor(COVALENT_RADII, device=device)
    with torch.no_grad():
        e = pair_energy(frac.expand(n, A, 3), lattice[None] * s[:, None, None],
                        types.expand(n, A), mask, radii)
    return e.cpu().numpy().astype(np.float64)


# the scale grid: wide enough that generated cells at ~2x over or under the
# potential's preferred volume still bracket a minimum
SCALE_GRID = np.linspace(0.35, 2.2, 75)
GOLDEN_STEPS = 12


def scale_search(structure: Structure, device: torch.device) -> tuple[int | None, float]:
    """(grid index of the chosen local minimum, refined scale) of the
    isotropic-scale search; ``(None, 1.0)`` where the grid brackets none.

    Among the grid's local minima the one nearest s=1 is chosen (the
    generated cell is near the data manifold; the potential's deep
    small-volume collapse basin is an artifact to be avoided), then refined
    by ``GOLDEN_STEPS`` golden-section steps inside its bracket."""
    k, s_opt, _ = scale_search_steps(structure, device)
    return k, s_opt


def scale_search_steps(structure: Structure, device: torch.device) -> tuple[int | None, float, list]:
    """``scale_search`` with its golden-section steps: each decision
    ``e1 < e2`` and its margin ``(e2 - e1) / max(|e1|, |e2|)`` (a margin at
    f32 rounding is a decision another device may take the other way)."""
    scales = SCALE_GRID
    e = strain_energies(structure, scales, device)
    interior = np.where(
        (e[1:-1] < e[:-2]) & (e[1:-1] <= e[2:]) & np.isfinite(e[1:-1])
    )[0] + 1
    if interior.size == 0:
        return None, 1.0, []
    k = int(interior[np.argmin(np.abs(scales[interior] - 1.0))])
    lo, hi = scales[k - 1], scales[k + 1]
    gr = (np.sqrt(5.0) - 1.0) / 2.0
    steps = []
    for _ in range(GOLDEN_STEPS):
        m1 = hi - gr * (hi - lo)
        m2 = lo + gr * (hi - lo)
        e1, e2 = strain_energies(structure, np.array([m1, m2]), device)
        steps.append((bool(e1 < e2), float((e2 - e1) / (max(abs(e1), abs(e2)) or 1.0))))
        if e1 < e2:
            hi = m2
        else:
            lo = m1
    return k, (lo + hi) / 2.0, steps


def equilibrate(
    structures: Sequence[Structure],
    relaxer: SoftSphereRelaxer | None = None,
    device: str | torch.device | None = None,
) -> List[Structure]:
    """Coordinate relaxation at fixed cell, then the 1-D isotropic-scale
    search (``scale_search``) to the potential's own volume minimum.

    Joint cell and coordinate descent over-binds (second shells pull the
    cell into collapse), and a half-relaxed cell sits at a saddle
    (imaginary Γ modes). Fixing the cell shape and searching one scale
    lands every structure at a minimum of the screening potential, where
    d²E/dV² > 0, which the curvature workflows need."""
    dev = resolve_device(device)
    relaxer = relaxer or SoftSphereRelaxer(
        max_atoms=max(max(s.num_atoms for s in structures), 1), lr_cell=0.0, device=dev
    )
    relaxed, _ = relaxer(list(structures))
    out = []
    for s in relaxed:
        k, s_opt = scale_search(s, dev)
        if k is None:
            out.append(s)
            continue
        out.append(Structure(species=list(s.species), frac_coords=s.frac_coords,
                             lattice=s.lattice * float(s_opt)))
    return out


def gamma_spectra(
    structures: Sequence[Structure],
    relaxer: SoftSphereRelaxer | None = None,
    min_length: float = 8.0,
    max_atoms: int = 160,
    depth_eV: float = 0.3,
    device: str | torch.device | None = None,
) -> List[tuple[Structure, Structure, np.ndarray | None]]:
    """(equilibrated structure, its supercell, Γ-point |ω| in rad/s) per
    structure, the spectrum None where the cell is singular or the
    eigenvalues do not converge: what ``gamma_heat_capacity`` sums over."""
    dev = resolve_device(device)
    out = []
    for s in equilibrate(structures, relaxer, dev):
        sc = supercell(s, choose_reps(s, min_length, max_atoms))
        try:
            omega = np.abs(gamma_frequencies(sc, depth_eV, dev))
        except (np.linalg.LinAlgError, torch.linalg.LinAlgError) as err:
            logging.warning(f"heat capacity: no spectrum for {s.composition}: {err}")
            omega = None
        out.append((s, sc, omega))
    return out


def supercell_mass(sc: Structure) -> float:
    """The supercell's mass in amu."""
    return float(np.sum(MASSES_AMU[np.asarray(sc.species)]))


def gamma_heat_capacity(
    structures: Sequence[Structure],
    temperature: float = 300.0,
    relaxer: SoftSphereRelaxer | None = None,
    min_length: float = 8.0,
    max_atoms: int = 160,
    depth_eV: float = 0.3,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Heat capacity at ``temperature`` (J/g/K) per structure: equilibrate,
    supercell, Γ-point phonons, the harmonic C_v. Residual soft modes enter
    as |ω|. NaN for a structure whose cell is singular or whose spectrum
    does not converge."""
    if not structures:
        return np.zeros(0)
    return np.asarray([
        float("nan") if omega is None
        else harmonic_heat_capacity(omega, supercell_mass(sc), temperature)
        for _, sc, omega in gamma_spectra(structures, relaxer, min_length, max_atoms, depth_eV,
                                          device)
    ])


def soft_sphere_bulk_modulus(
    structures: Sequence[Structure],
    relaxer: SoftSphereRelaxer | None = None,
    depth_eV: float = 0.3,
    delta: float = 0.02,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Bulk modulus (GPa) per structure from the isotropic E(V) curvature.

    B = V d²E/dV²; with the lattice scaled by s (V = V₀s³), at s=1 this is
    (E''(s) − 2E'(s))/(9V₀), the derivatives from a 5-point stencil around
    the equilibrated state. NaN where the curvature is not finite."""
    if not structures:
        return np.zeros(0)
    dev = resolve_device(device)
    scales = np.array([1.0 - 2 * delta, 1.0 - delta, 1.0, 1.0 + delta, 1.0 + 2 * delta])
    out = []
    for s in equilibrate(structures, relaxer, dev):
        e = strain_energies(s, scales, dev) * depth_eV  # eV
        d1 = (e[0] - 8 * e[1] + 8 * e[3] - e[4]) / (12 * delta)
        d2 = (-e[0] + 16 * e[1] - 30 * e[2] + 16 * e[3] - e[4]) / (12 * delta**2)
        b_gpa = ((d2 - 2.0 * d1) / (9.0 * s.volume)) * _EV_PER_A3_TO_GPA
        out.append(float(b_gpa) if np.isfinite(b_gpa) else float("nan"))
    return np.asarray(out)
