"""Simplified Zur-McGill ZSL lattice matching for the substrate MCIA reward
(``matinvent_tpu/rewards/calculators/zsl.py``).

A stand-in for pymatgen's ``SubstrateAnalyzer``: the coincident-site-lattice
search over Miller-indexed surface cells:

1. build the 2D lattice basis of each (hkl) plane family (film and substrate
   Miller indices up to 1, mirroring ``SubstrateAnalyzer(film_max_miller=1,
   substrate_max_miller=1)``),
2. enumerate multiple pairs (i, j) with i*A_film ~ j*A_sub,
3. enumerate Hermite-normal-form supercell matrices of each determinant,
4. Lagrange-reduce each candidate 2D superlattice,
5. accept when length/angle strains are below tolerance (pymatgen
   ZSLGenerator defaults: max_area 400, area ratio tol 0.09, length tol
   0.03, angle tol 0.01),
6. return the minimal coincident area over all Miller pairs.
"""
from __future__ import annotations

import math
from itertools import product

import numpy as np


def _hnf_matrices(det: int) -> list[np.ndarray]:
    """All 2x2 Hermite-normal-form integer matrices with given determinant."""
    out = []
    for m11 in range(1, det + 1):
        if det % m11:
            continue
        m22 = det // m11
        for m21 in range(m22):
            out.append(np.array([[m11, 0], [m21, m22]], dtype=np.int64))
    return out


def _reduce_2d(v: np.ndarray) -> np.ndarray:
    """Lagrange/Gauss reduction of a 2D lattice basis (rows, 3-vectors)."""
    a, b = v[0].astype(np.float64), v[1].astype(np.float64)
    for _ in range(64):
        if np.dot(a, a) > np.dot(b, b):
            a, b = b, a
        mu = round(np.dot(a, b) / np.dot(a, a))
        b2 = b - mu * a
        if np.allclose(b2, b):
            break
        b = b2
    return np.stack([a, b])


def _cell_params(v: np.ndarray) -> tuple[float, float, float]:
    la = np.linalg.norm(v[0])
    lb = np.linalg.norm(v[1])
    cosang = np.dot(v[0], v[1]) / (la * lb)
    return la, lb, math.acos(max(-1.0, min(1.0, cosang)))


def min_coincident_area(
    film_surf: np.ndarray,  # [2, 3] film surface basis
    sub_surf: np.ndarray,  # [2, 3] substrate surface basis
    max_area: float = 400.0,
    max_length_tol: float = 0.03,
    max_angle_tol: float = 0.01,
    area_tol: float = 0.09,
    max_det: int = 12,
) -> float | None:
    """Smallest coincident interface area (A^2), or None if no match.

    Tolerance defaults mirror pymatgen's ``ZSLGenerator`` (max_area=400,
    max_area_ratio_tol=0.09, max_length_tol=0.03, max_angle_tol=0.01).
    """
    area_f = float(np.linalg.norm(np.cross(film_surf[0], film_surf[1])))
    area_s = float(np.linalg.norm(np.cross(sub_surf[0], sub_surf[1])))
    if area_f <= 0 or area_s <= 0:
        return None

    candidates: list[tuple[float, int, int]] = []
    for i in range(1, max_det + 1):
        if i * area_f > max_area:
            break
        for j in range(1, max_det + 1):
            rel = abs(i * area_f - j * area_s) / max(i * area_f, j * area_s)
            if rel < area_tol:
                candidates.append((i * area_f, i, j))
    candidates.sort()

    for area, i, j in candidates:
        film_cells = [_reduce_2d(m @ film_surf) for m in _hnf_matrices(i)]
        sub_cells = [_reduce_2d(m @ sub_surf) for m in _hnf_matrices(j)]
        for fc in film_cells:
            fa, fb, fang = _cell_params(fc)
            for sc in sub_cells:
                sa, sb, sang = _cell_params(sc)
                # match either orientation of the reduced basis
                for (x1, x2) in ((sa, sb), (sb, sa)):
                    strain_a = abs(fa - x1) / x1
                    strain_b = abs(fb - x2) / x2
                    strain_ang = abs(fang - sang) / max(sang, 1e-6)
                    if (
                        strain_a < max_length_tol
                        and strain_b < max_length_tol
                        and strain_ang < max_angle_tol
                    ):
                        return area
    return None


# The 13 distinct (hkl) plane families with |h|,|k|,|l| <= 1 (up to +-
# equivalence); SubstrateAnalyzer(film_max_miller=1) searches these.
MILLERS_MAX1: tuple[tuple[int, int, int], ...] = (
    (0, 0, 1), (0, 1, 0), (1, 0, 0),
    (0, 1, 1), (1, 0, 1), (1, 1, 0),
    (0, 1, -1), (1, 0, -1), (1, -1, 0),
    (1, 1, 1), (1, 1, -1), (1, -1, 1), (-1, 1, 1),
)


def plane_basis(lattice: np.ndarray, miller: tuple[int, int, int]) -> np.ndarray:
    """2D Cartesian basis [2, 3] of the (hkl) plane lattice.

    The integer vectors (u, v, w) with h*u + k*v + l*w = 0 form a rank-2
    sublattice; its two successive minima (shortest independent members,
    measured in Cartesian length) are always a basis in 2D. Brute-forced
    over a small coefficient cube — exact for |miller| <= 1 and safe for
    any reduced input cell.
    """
    h, k, l = (int(m) for m in miller)
    if h == 0 and k == 0 and l == 0:
        raise ValueError("miller index (0,0,0)")
    sols = []
    for u, v, w in product(range(-3, 4), repeat=3):
        if (u, v, w) == (0, 0, 0) or h * u + k * v + l * w != 0:
            continue
        cart = u * lattice[0] + v * lattice[1] + w * lattice[2]
        sols.append((float(np.dot(cart, cart)), (u, v, w), cart))
    sols.sort(key=lambda s: s[0])
    a_int, a_cart = sols[0][1], sols[0][2]
    for _, b_int, b_cart in sols[1:]:
        cross = np.cross(a_int, b_int)
        if np.any(cross != 0):  # linearly independent integer vectors
            return _reduce_2d(np.stack([a_cart, b_cart]))
    raise ValueError(f"no independent in-plane vector for miller {miller}")


def mcia_search(
    film_lattice: np.ndarray,  # [3, 3] rows
    sub_lattice: np.ndarray,  # [3, 3] rows
    film_millers=MILLERS_MAX1,
    sub_millers=MILLERS_MAX1,
    **zsl_kwargs,
) -> float | None:
    """Minimal coincident area over all film x substrate Miller pairs.

    As ``SubstrateAnalyzer.calculate(..., lowest=True)`` and
    ``min(match_area)``: substrate facets are restricted by ``SUB_MILLERS``
    where it names the substrate, else every distinct plane up to index 1
    is searched on both sides.
    """
    sub_bases = [plane_basis(sub_lattice, m) for m in sub_millers]
    max_area = zsl_kwargs.pop("max_area", 400.0)
    best: float | None = None
    for fm in film_millers:
        try:
            fb = plane_basis(film_lattice, fm)
        except ValueError:
            continue
        for sb in sub_bases:
            # candidates come out area-sorted, so the running best is a
            # valid search cutoff for every later pair
            cap = max_area if best is None else min(max_area, best)
            area = min_coincident_area(fb, sb, max_area=cap, **zsl_kwargs)
            if area is not None and (best is None or area < best):
                best = area
    return best
