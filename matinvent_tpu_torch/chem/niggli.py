"""Niggli cell reduction (Krivy-Gruber algorithm) and primitive-cell
reduction (``matinvent_tpu/chem/niggli.py``), in plain numpy: the same
floats as the JAX package's copy.

The Niggli reduced cell is the canonical lattice the structure matcher
compares and the sampler's ``niggli_reduction`` option writes.

Implementation: I. Krivy & B. Gruber, Acta Cryst. (1976) A32, 297, with the
epsilon treatment of Grosse-Kunstleve et al. (2004).
"""
from __future__ import annotations

import numpy as np

from matinvent_tpu_torch.chem.structure import Structure


def niggli_reduce_matrix(lattice: np.ndarray, eps: float = 1e-5, max_iter: int = 100) -> np.ndarray:
    """Return the Niggli-reduced lattice (rows are cell vectors)."""
    a_vec, b_vec, c_vec = [np.array(v, dtype=float) for v in lattice]

    def params():
        A = a_vec @ a_vec
        B = b_vec @ b_vec
        C = c_vec @ c_vec
        xi = 2 * (b_vec @ c_vec)
        eta = 2 * (a_vec @ c_vec)
        zeta = 2 * (a_vec @ b_vec)
        return A, B, C, xi, eta, zeta

    for _ in range(max_iter):
        A, B, C, xi, eta, zeta = params()
        # step 1
        if A > B + eps or (abs(A - B) < eps and abs(xi) > abs(eta) + eps):
            a_vec, b_vec = b_vec.copy(), a_vec.copy()
            a_vec, b_vec = -a_vec, -b_vec
            continue
        A, B, C, xi, eta, zeta = params()
        # step 2
        if B > C + eps or (abs(B - C) < eps and abs(eta) > abs(zeta) + eps):
            b_vec, c_vec = c_vec.copy(), b_vec.copy()
            b_vec, c_vec = -b_vec, -c_vec
            continue
        A, B, C, xi, eta, zeta = params()
        # steps 3/4 (Krivy-Gruber): make the angle cosines all positive when
        # xi*eta*zeta > 0, all non-positive otherwise. The diag(s1,s2,s3)
        # flips below have det +1 (each si is a parity of the other two
        # components' signs).
        strict_neg = sum(1 for v in (xi, eta, zeta) if v < -eps)
        strict_pos = sum(1 for v in (xi, eta, zeta) if v > eps)
        product_positive = strict_pos + strict_neg == 3 and strict_neg % 2 == 0
        if product_positive:
            s1 = 1 if (eta > -eps) == (zeta > -eps) else -1
            s2 = 1 if (xi > -eps) == (zeta > -eps) else -1
            s3 = 1 if (xi > -eps) == (eta > -eps) else -1
        else:
            s1 = 1 if (eta < eps) == (zeta < eps) else -1
            s2 = 1 if (xi < eps) == (zeta < eps) else -1
            s3 = 1 if (xi < eps) == (eta < eps) else -1
        a_vec, b_vec, c_vec = s1 * a_vec, s2 * b_vec, s3 * c_vec

        A, B, C, xi, eta, zeta = params()
        # step 5
        if abs(xi) > B + eps or (abs(B - xi) < eps and 2 * eta < zeta - eps) or (
            abs(B + xi) < eps and zeta < -eps
        ):
            c_vec = c_vec - np.sign(xi) * b_vec
            continue
        # step 6
        if abs(eta) > A + eps or (abs(A - eta) < eps and 2 * xi < zeta - eps) or (
            abs(A + eta) < eps and zeta < -eps
        ):
            c_vec = c_vec - np.sign(eta) * a_vec
            continue
        # step 7
        if abs(zeta) > A + eps or (abs(A - zeta) < eps and 2 * xi < eta - eps) or (
            abs(A + zeta) < eps and eta < -eps
        ):
            b_vec = b_vec - np.sign(zeta) * a_vec
            continue
        # step 8
        if xi + eta + zeta + A + B < -eps or (
            abs(xi + eta + zeta + A + B) < eps and 2 * (A + eta) + zeta > eps
        ):
            c_vec = c_vec + a_vec + b_vec
            continue
        break

    return np.stack([a_vec, b_vec, c_vec])


def niggli_reduce(structure: Structure, eps: float = 1e-5) -> Structure:
    """Structure with the Niggli-reduced cell (same crystal, remapped coords)."""
    new_lat = niggli_reduce_matrix(structure.lattice, eps=eps)
    cart = structure.cart_coords
    frac = cart @ np.linalg.pinv(new_lat)
    return Structure(new_lat, structure.species, frac % 1.0)


def primitive_reduce(structure: Structure, tol: float = 0.25) -> Structure:
    """Reduce to a primitive cell by detecting internal pure translations.

    pymatgen's ``StructureMatcher`` reduces both structures to their
    primitive cells before fitting (``primitive_cell=True`` default, the
    mode the reference's mattergen Default*StructureMatcher wrappers use);
    this is the equivalent host-side reduction. ``tol`` is the Cartesian
    site tolerance in Angstrom (pymatgen ``get_primitive_structure``
    default 0.25).

    Method: candidate fractional translations are differences between sites
    of the rarest species; a candidate is a pure translation when it maps
    every site onto a same-species site within ``tol`` (minimum image).
    The valid translations form a group of order g | n; a primitive basis
    is the shortest Cartesian triple drawn from {group translations} union
    {cell vectors} with |det| = V/g. Sites are remapped and deduplicated.
    """
    n = structure.num_atoms
    if n <= 1:
        return structure
    lat = structure.lattice
    frac = structure.frac_coords % 1.0
    sp = np.asarray(structure.species)

    def maps_onto_self(t: np.ndarray) -> bool:
        shifted = (frac + t) % 1.0
        # every shifted site must land on a same-species site within tol
        d = shifted[:, None, :] - frac[None, :, :]
        d -= np.round(d)
        dist2 = np.einsum("ijk,kl,ijl->ij", d, lat @ lat.T, d)
        ok = (dist2 <= tol * tol) & (sp[:, None] == sp[None, :])
        # a permutation must exist; for a pure translation the nearest
        # same-species site suffices (injective by the tolerance being
        # well below typical interatomic distances)
        return bool(np.all(ok.any(axis=1)))

    # a pure translation of a crystal with n atoms generates a group whose
    # order divides n, so its components are multiples of 1/m for some
    # m | n. Snap each raw candidate (which carries TWO sites' jitter) to
    # the nearest such fraction BEFORE verifying: verification then only
    # fights the per-site jitter, and the primitive-basis determinant check
    # below sees exact V/g volumes.
    divisors = [m for m in range(2, n + 1) if n % m == 0]

    def snap(t: np.ndarray) -> np.ndarray | None:
        for m in divisors:
            ts = np.round(t * m) / m
            ts -= np.round(ts)
            if not np.any(ts):
                continue
            d = t - ts
            d -= np.round(d)
            if float(d @ (lat @ lat.T) @ d) <= tol * tol:
                return ts
        return None

    vals, counts = np.unique(sp, return_counts=True)
    anchor_sites = np.where(sp == vals[np.argmin(counts)])[0]
    a0 = anchor_sites[0]
    snapped: list[np.ndarray] = []
    for j in anchor_sites[1:]:
        t = frac[j] - frac[a0]
        t -= np.round(t)  # minimum image, NOT % 1.0 (keep -0.005 small)
        ts = snap(t)
        if ts is not None and not any(
            np.allclose(ts, s0) for s0 in snapped
        ) and maps_onto_self(ts):
            snapped.append(ts)
    g = len(snapped) + 1
    if g == 1 or n % g:
        return structure

    # candidate primitive vectors (Cartesian): group translations + cell rows
    cands = np.concatenate([np.asarray(snapped) @ lat, lat], axis=0)
    order = np.argsort(np.linalg.norm(cands, axis=1))
    cands = cands[order]
    target = structure.volume / g
    best = None
    m = len(cands)
    for i in range(m):
        for j in range(i + 1, m):
            for k in range(j + 1, m):
                basis = np.stack([cands[i], cands[j], cands[k]])
                vol = abs(np.linalg.det(basis))
                if abs(vol - target) <= 1e-4 * structure.volume:
                    best = basis
                    break
            if best is not None:
                break
        if best is not None:
            break
    if best is None:  # group detected but no consistent basis: keep as-is
        return structure

    new_frac = (structure.cart_coords @ np.linalg.pinv(best)) % 1.0
    keep_idx: list[int] = []
    gram = best @ best.T
    for i in range(n):
        dup = False
        for kdx in keep_idx:
            d = new_frac[i] - new_frac[kdx]
            d -= np.round(d)
            if (sp[i] == sp[kdx]) and (d @ gram @ d) <= tol * tol:
                dup = True
                break
        if not dup:
            keep_idx.append(i)
    if len(keep_idx) != n // g:  # inconsistent dedup (heavy jitter): keep
        return structure
    return Structure(best, sp[keep_idx], new_frac[keep_idx])
