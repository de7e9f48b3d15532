"""Validity of sampled crystals (``matinvent_tpu/chem/validity.py``).

* ``smact_valid``: SMACT-style charge balance with a Pauling
  electronegativity test, an alloy exception for all-metal compositions;
  the oxidation-state search runs in ``csrc/charge_balance.cpp`` (built with
  g++ on first use, as the JAX package's native search: no cap on the
  number of combinations); ``charge_balanced_plain`` is its plain Python
  version;
* ``structure_validity``: finite cell and coordinates, species in 1..100,
  cell volume and minimum interatomic distance, for one ``Structure`` or
  batched over a ``CrystalBatch`` on the batch's device;
* ``cell_size_ok``: every cell edge below 25 A.
"""
from __future__ import annotations

import ctypes
import itertools
from functools import cache, lru_cache

import numpy as np
import torch

from matinvent_tpu_torch.chem.composition import Composition
from matinvent_tpu_torch.chem.data import ELECTRONEGATIVITY, OXIDATION_STATES
from matinvent_tpu_torch.chem.structure import Structure
from matinvent_tpu_torch.csrc.build import build_host
from matinvent_tpu_torch.models.batch import CrystalBatch

# 27 neighbour-cell offsets for minimum-image distances
_OFFSETS_27 = tuple(itertools.product((-1, 0, 1), repeat=3))


@cache
def _charge_balance_fn():
    fn = build_host("charge_balance").lib.charge_balanced
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double), ctypes.c_int,
    ]
    return fn


def charge_balanced(ox_lists: list[list[int]], counts: list[int], ens: list) -> bool:
    """Some oxidation-state assignment is charge neutral with no cation
    more electronegative than an anion (``None`` EN: not checked); the
    native search. A failed build raises."""
    flat, offsets = [], [0]
    for states in ox_lists:
        flat.extend(states)
        offsets.append(len(flat))
    n = len(ox_lists)
    return bool(
        _charge_balance_fn()(
            (ctypes.c_int * max(len(flat), 1))(*flat),
            (ctypes.c_int * (n + 1))(*offsets),
            (ctypes.c_int * n)(*counts),
            (ctypes.c_double * n)(*[-1.0 if e is None else e for e in ens]),
            n,
        )
    )


def _pauling_ok(ens: list, ox: tuple[int, ...]) -> bool:
    """Cations must not be more electronegative than anions."""
    cats = [e for e, o in zip(ens, ox) if o > 0]
    ans = [e for e, o in zip(ens, ox) if o < 0]
    if not cats or not ans:
        return False
    cats = [c for c in cats if c is not None]
    ans = [a for a in ans if a is not None]
    if not cats or not ans:
        return True  # missing EN data: not rejected
    return max(cats) <= min(ans)


def charge_balanced_plain(ox_lists: list[list[int]], counts: list[int], ens: list) -> bool:
    """``charge_balanced`` by enumerating every assignment."""
    if any(not states for states in ox_lists):
        return False
    for combo in itertools.product(*ox_lists):
        if sum(o * c for o, c in zip(combo, counts)) == 0 and _pauling_ok(ens, combo):
            return True
    return False


@lru_cache(maxsize=65536)
def _smact_valid_cached(symbols: tuple[str, ...], counts: tuple[int, ...]) -> bool:
    ox_lists = [OXIDATION_STATES.get(s, []) for s in symbols]
    if any(not states for states in ox_lists):
        return False
    return charge_balanced(ox_lists, list(counts), [ELECTRONEGATIVITY.get(s) for s in symbols])


def smact_valid(obj: Structure | Composition) -> bool:
    """Charge-balance validity of a composition: a single element, an
    all-metal composition, or a charge-neutral, electronegativity-consistent
    oxidation-state assignment of the reduced formula."""
    comp = obj.composition if isinstance(obj, Structure) else obj
    if "X" in comp.elements:
        return False  # dummy species (a surviving D3PM MASK state)
    if len(comp.elements) == 1 or comp.is_all_metal:
        return True
    red = comp.reduced_counts
    symbols = tuple(sorted(red))
    return _smact_valid_cached(symbols, tuple(int(red[s]) for s in symbols))


def cell_size_ok(structure: Structure, max_length: float = 25.0) -> bool:
    """Every cell edge is shorter than ``max_length`` (A)."""
    return bool(structure.lengths.max() < max_length)


def structure_validity(
    obj: Structure | CrystalBatch, cutoff: float = 0.5, min_volume: float = 0.1
) -> bool | torch.Tensor:
    """Finite lattice and coords, species in 1..100, at least one atom, cell
    volume >= ``min_volume`` (A^3) and no two atoms (or an atom and its own
    periodic image) closer than ``cutoff`` (A). A ``Structure`` gives a
    bool, a ``CrystalBatch`` a ``[B]`` bool tensor on its device."""
    if isinstance(obj, Structure):
        return _structure_valid(obj, cutoff, min_volume)
    return _batch_valid(obj, cutoff, min_volume)


def _structure_valid(s: Structure, cutoff: float, min_volume: float) -> bool:
    if not np.isfinite(s.lattice).all() or not np.isfinite(s.frac_coords).all():
        return False
    if (s.species < 1).any() or (s.species > 100).any():
        return False
    if s.volume < min_volume or s.num_atoms == 0:
        return False
    return s.min_interatomic_distance() >= cutoff


def _batch_valid(batch: CrystalBatch, cutoff: float, min_volume: float) -> torch.Tensor:
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
