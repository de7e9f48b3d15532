"""Prototype-structure motifs and element pools for synthetic corpora
(``matinvent_tpu/chem/motifs.py``).

The ionic-crystal motif geometries of the demo pretraining corpus
(``tools/make_reference_dataset.py``'s plain mode), the predictor-training
corpus (``tools/make_predictor_dataset.py``) and the rich gen_eval
reference set (``make_rich_structure``): fractional coordinates per motif
and the (n_cations, n_anions) split of the species list. For the same
``np.random.Generator`` every function draws what the JAX package draws,
so both packages build the same structures.
"""
from __future__ import annotations

import numpy as np

from matinvent_tpu_torch.chem.data import OXIDATION_STATES, Z_BY_SYMBOL
from matinvent_tpu_torch.chem.relax import COVALENT_RADII
from matinvent_tpu_torch.chem.structure import Structure

MOTIFS: dict[str, tuple[np.ndarray, tuple[int, int]]] = {
    "rocksalt": (np.array([[0, 0, 0], [0.5, 0.5, 0.5]]), (1, 1)),
    "cscl": (np.array([[0, 0, 0], [0.5, 0.5, 0.5]]), (1, 1)),
    "fluorite": (
        np.array([[0, 0, 0], [0.25, 0.25, 0.25], [0.75, 0.75, 0.75]]), (1, 2)
    ),
    "antifluorite": (
        np.array([[0.25, 0.25, 0.25], [0.75, 0.75, 0.75], [0, 0, 0]]), (2, 1)
    ),
    "layered": (
        np.array([[0, 0, 0], [0.5, 0.5, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5]]),
        (2, 2),
    ),
    "perovskite": (
        np.array(
            [[0, 0, 0], [0.5, 0.5, 0.5],
             [0.5, 0.5, 0.0], [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]]
        ),
        (2, 3),
    ),
    "wurtzite-ish": (
        np.array(
            [[1 / 3, 2 / 3, 0.0], [2 / 3, 1 / 3, 0.5],
             [1 / 3, 2 / 3, 0.38], [2 / 3, 1 / 3, 0.88]]
        ),
        (2, 2),
    ),
}

# the 4-motif subset the plain demo corpus draws from
BASE_MOTIF_NAMES = ("rocksalt", "cscl", "fluorite", "layered")


def cation_pool(max_z: int = 83) -> list[int]:
    """Elements with a positive oxidation state (ionic-crystal cations)."""
    return [
        Z_BY_SYMBOL[s] for s, ox in OXIDATION_STATES.items()
        if s in Z_BY_SYMBOL and Z_BY_SYMBOL[s] <= max_z and any(o > 0 for o in ox)
    ]


def anion_pool(symbols=("O", "S", "Se", "F", "Cl", "Br", "N", "P")) -> list[int]:
    return [Z_BY_SYMBOL[s] for s in symbols]


def make_rich_structure(
    rng: np.random.Generator,
    max_atoms: int = 20,
    jitter: float = 0.02,
):
    """One structure from the full motif x supercell x element x distortion
    design space (2-``max_atoms`` atom cells). Its diversity levers, each
    distinguishable under anonymized exact matching:

    * all 7 prototype motifs (incl. perovskite / wurtzite-ish internal DOF),
    * random supercells up to ``max_atoms`` atoms (distinct geometries),
    * cation/anion site substitution in supercells (ordered derivatives
      with distinct stoichiometries),
    * anisotropic per-axis scaling + mild angle distortion (distinct
      lattices beyond cubic),
    * coordinate jitter.

    """
    cations, anions = cation_pool(), anion_pool()
    names = list(MOTIFS)
    while True:
        coords, (n_cat, n_an) = MOTIFS[names[rng.integers(len(names))]]
        base = len(coords)
        # random supercell factors that keep the cell under max_atoms
        cap = max_atoms // base
        if cap < 1:
            continue
        while True:
            f = rng.integers(1, 4, size=3)
            if int(np.prod(f)) <= cap:
                break
        reps = int(np.prod(f))
        # tile fractional coords into the supercell
        cells = np.stack(
            np.meshgrid(np.arange(f[0]), np.arange(f[1]), np.arange(f[2]),
                        indexing="ij"),
            axis=-1,
        ).reshape(-1, 3)
        sc = ((coords[None, :, :] + cells[:, None, :]) / f).reshape(-1, 3)

        cat = int(rng.choice(cations))
        an = int(rng.choice(anions))
        species = ([cat] * n_cat + [an] * n_an) * reps
        species = np.asarray(species)
        site_is_cat = np.asarray(([True] * n_cat + [False] * n_an) * reps)
        # ordered-derivative substitution: a second cation (and sometimes a
        # second anion) on a random subset of sites
        if reps > 1 or n_cat > 1:
            if rng.random() < 0.6:
                cat2 = int(rng.choice(cations))
                idx = np.where(site_is_cat)[0]
                k = rng.integers(1, max(len(idx) // 2, 1) + 1)
                species[rng.choice(idx, size=k, replace=False)] = cat2
            if (reps > 1 or n_an > 1) and rng.random() < 0.3:
                an2 = int(rng.choice(anions))
                idx = np.where(~site_is_cat)[0]
                k = rng.integers(1, max(len(idx) // 2, 1) + 1)
                species[rng.choice(idx, size=k, replace=False)] = an2

        r = COVALENT_RADII[cat] + COVALENT_RADII[an]
        # per-axis anisotropy on top of the supercell factors; mild angle
        # distortion half the time (triclinic-ish cells)
        abc = [float(r * rng.uniform(1.7, 2.3) * rng.uniform(0.92, 1.08) * fi)
               for fi in f]
        if rng.random() < 0.5:
            angles = [float(rng.uniform(82.0, 98.0)) for _ in range(3)]
        else:
            angles = [90.0, 90.0, 90.0]
        sc = (sc + rng.normal(0, jitter, sc.shape)) % 1.0
        return Structure.from_parameters(abc, angles, species.tolist(), sc)
