"""Build a gen_eval reference set: structures and hull energies
(``tools/make_reference_dataset.py`` of the JAX package).

    python -m matinvent_tpu_torch.tools.make_reference_dataset out=experiments/data \\
        [n=2000] [seed=0] [rich=1] [max_atoms=20] [name=reference]

Writes ``<out>/<name>.extxyz`` (the novelty structures) and
``<out>/<name>_energies.json`` (reduced formula -> the lowest analytic
formation energy in eV/atom over the set, ``chem/proxy_labels``, with 0.0
for each element). The candidates are drawn in batches of ``2 n`` and only
those passing ``invalid_filter`` are kept, up to ``n``. The plain mode
draws the 4-motif demo corpus (written and read back, as the JAX tool
does); ``rich=1`` draws ``chem.motifs.make_rich_structure``. The same
arguments give the JAX tool's files.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

from matinvent_tpu_torch.chem.motifs import BASE_MOTIF_NAMES, MOTIFS, anion_pool, cation_pool
from matinvent_tpu_torch.chem.motifs import make_rich_structure
from matinvent_tpu_torch.chem.proxy_labels import formation_energy_ev_per_atom
from matinvent_tpu_torch.chem.relax import COVALENT_RADII
from matinvent_tpu_torch.chem.structure import Structure, read_extxyz, save_extxyz
from matinvent_tpu_torch.pipeline.filters import invalid_filter


def make_demo_dataset(path: str, n: int = 400, seed: int = 0) -> None:
    """The demo corpus: binary crystals on the 4 base motifs, cells sized
    from covalent radii, written to ``path``."""
    rng = np.random.default_rng(seed)
    cations, anions = cation_pool(), anion_pool()
    names = list(BASE_MOTIF_NAMES)
    out = []
    for _ in range(n):
        coords, (n_cat, n_an) = MOTIFS[names[rng.integers(len(names))]]
        cat = int(rng.choice(cations))
        an = int(rng.choice(anions))
        species = [cat] * n_cat + [an] * n_an
        r = COVALENT_RADII[cat] + COVALENT_RADII[an]
        a = float(r * rng.uniform(1.7, 2.3))
        jitter = rng.normal(0, 0.01, coords.shape)
        out.append(Structure.from_parameters([a] * 3, [90] * 3, species, (coords + jitter) % 1.0))
    save_extxyz(out, path)


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    out_dir = kv.get("out", "experiments/data")
    n = int(kv.get("n", 2000))
    seed = int(kv.get("seed", 0))
    rich = kv.get("rich", "0") not in ("0", "false", "")
    max_atoms = int(kv.get("max_atoms", 20))
    name = kv.get("name", "reference")
    os.makedirs(out_dir, exist_ok=True)

    xyz_path = os.path.join(out_dir, f"{name}.extxyz")
    tmp_path = xyz_path + ".raw"
    structures: list = []
    tries = 0
    while len(structures) < n and tries < 6:
        if rich:
            rng = np.random.default_rng(seed + tries)
            cand = [make_rich_structure(rng, max_atoms=max_atoms) for _ in range(2 * n)]
        else:
            make_demo_dataset(tmp_path, n=2 * n, seed=seed + tries)
            cand = read_extxyz(tmp_path)
        mask = invalid_filter(cand, cand, return_mask=True)
        structures.extend([s for s, m in zip(cand, mask) if m])
        tries += 1
    if os.path.exists(tmp_path):
        os.remove(tmp_path)
    structures = structures[:n]
    save_extxyz(structures, xyz_path)

    energies: dict[str, float] = {}
    elements: set[str] = set()
    for s in structures:
        ef = formation_energy_ev_per_atom(s)
        if not np.isfinite(ef):
            continue
        f = s.composition.reduced_formula
        energies[f] = min(energies.get(f, np.inf), float(ef))
        elements.update(s.composition.elements)
    for el in sorted(elements):
        energies.setdefault(el, 0.0)
    json_path = os.path.join(out_dir, f"{name}_energies.json")
    with open(json_path, "w") as fh:
        json.dump(energies, fh, indent=1, sort_keys=True)
    print(f"wrote {len(structures)} structures -> {xyz_path}\n"
          f"wrote {len(energies)} phase energies ({len(elements)} elements) -> {json_path}")


if __name__ == "__main__":
    main()
