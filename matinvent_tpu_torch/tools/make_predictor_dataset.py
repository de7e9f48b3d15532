"""Generate a labeled structure set for predictor training
(``tools/make_predictor_dataset.py`` of the JAX package).

    python -m matinvent_tpu_torch.tools.make_predictor_dataset out=<dir> \\
        [n=6000] [seed=0] [max_atoms=16]

Writes ``<dir>/dataset.extxyz`` and ``<dir>/labels_<model>.txt`` for every
model of ``chem.proxy_labels.LABEL_FNS``: 55% motif crystals (wider anion
set, distorted cells), 15% their 2x1x1 supercells, 30% random junk, the
regimes an RL sampler emits. Non-finite labels (zero-volume cells) are
written as 0. The same arguments give the JAX tool's files.
"""
from __future__ import annotations

import os
import sys

import numpy as np

from matinvent_tpu_torch.chem.motifs import MOTIFS, anion_pool, cation_pool
from matinvent_tpu_torch.chem.proxy_labels import LABEL_FNS, label_structures
from matinvent_tpu_torch.chem.relax import COVALENT_RADII
from matinvent_tpu_torch.chem.structure import Structure, save_extxyz


def _element_pools():
    return cation_pool(), anion_pool(("O", "S", "Se", "Te", "F", "Cl", "Br", "I", "N", "P", "As"))


def motif_structure(rng: np.random.Generator) -> Structure:
    cations, anions = _element_pools()
    name = list(MOTIFS)[rng.integers(len(MOTIFS))]
    coords, (n_cat, n_an) = MOTIFS[name]
    cat = int(rng.choice(cations))
    an = int(rng.choice(anions))
    species = [cat] * n_cat + [an] * n_an
    # occasionally a ternary: swap one cation site
    if n_cat >= 2 and rng.random() < 0.4:
        species[1] = int(rng.choice(cations))
    r = COVALENT_RADII[cat] + COVALENT_RADII[an]
    a = float(r * rng.uniform(1.5, 2.6))
    lengths = [a * rng.uniform(0.9, 1.15) for _ in range(3)]
    angles = [rng.uniform(80, 100) for _ in range(3)]
    jitter = rng.normal(0, rng.uniform(0.0, 0.04), coords.shape)
    return Structure.from_parameters(lengths, angles, species, (coords + jitter) % 1.0)


def random_structure(rng: np.random.Generator, max_atoms: int) -> Structure:
    """The junk regime: what an untrained sampler emits."""
    n = int(rng.integers(1, max_atoms + 1))
    species = rng.integers(1, 84, n).tolist()
    lengths = rng.uniform(2.0, 14.0, 3).tolist()
    angles = rng.uniform(60.0, 120.0, 3).tolist()
    coords = rng.random((n, 3))
    return Structure.from_parameters(lengths, angles, species, coords)


def supercell_structure(rng: np.random.Generator, max_atoms: int) -> Structure:
    """A 2x1x1 supercell of a motif crystal (more atoms, same chemistry)."""
    s = motif_structure(rng)
    if 2 * s.num_atoms > max_atoms:
        return s
    fc = np.concatenate([s.frac_coords * [0.5, 1, 1], s.frac_coords * [0.5, 1, 1] + [0.5, 0, 0]])
    lat = s.lattice.copy()
    lat[0] *= 2.0
    return Structure(species=np.concatenate([s.species, s.species]), frac_coords=fc % 1.0,
                     lattice=lat)


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    out_dir = kv.get("out", "predictor_data")
    n = int(kv.get("n", 6000))
    seed = int(kv.get("seed", 0))
    max_atoms = int(kv.get("max_atoms", 16))
    rng = np.random.default_rng(seed)

    structures = []
    for _ in range(n):
        u = rng.random()
        if u < 0.55:
            structures.append(motif_structure(rng))
        elif u < 0.70:
            structures.append(supercell_structure(rng, max_atoms))
        else:
            structures.append(random_structure(rng, max_atoms))

    os.makedirs(out_dir, exist_ok=True)
    data_path = os.path.join(out_dir, "dataset.extxyz")
    save_extxyz(structures, data_path)
    print(f"wrote {len(structures)} structures -> {data_path}")
    for model_name in LABEL_FNS:
        labels = label_structures(structures, model_name)
        labels[~np.isfinite(labels)] = 0.0
        path = os.path.join(out_dir, f"labels_{model_name}.txt")
        np.savetxt(path, labels)
        print(f"{model_name}: mean={labels.mean():.3f} std={labels.std():.3f} "
              f"min={labels.min():.3f} max={labels.max():.3f} -> {path}")


if __name__ == "__main__":
    main()
