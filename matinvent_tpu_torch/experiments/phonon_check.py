"""The native phonon and elastic workflows on the card against the CPU,
one structure at a time; ``chip_smoke.py`` and the card tests run it.

``phonon_pair`` gives C_v and the bulk modulus of one structure on both
devices beside the discrete decisions either side may take differently by
f32 rounding, and the gaps that remain once those are accounted for.
"""
from __future__ import annotations

import numpy as np
import torch

from matinvent_tpu_torch.chem import phonon
from matinvent_tpu_torch.chem.relax import SoftSphereRelaxer
from matinvent_tpu_torch.chem.structure import Structure

KB, AMU_G = 1.380649e-23, 1.66053906660e-24


def rocksalt(a: float, cat: int, an: int) -> Structure:
    """A two-atom cubic cell of side ``a`` (Å), cation at the origin and
    anion at the body centre."""
    return Structure.from_parameters([a] * 3, [90] * 3, [cat, an],
                                     np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]))


def as_given(structs):
    """The identity relaxer: the structures unchanged, zero energies."""
    return list(structs), [0.0] * len(structs)


def phonon_pair(s: Structure, relax: bool, max_atoms: int, device: str = "cuda") -> dict:
    """C_v and the bulk modulus of one structure on ``device`` and on the
    CPU (``gamma_heat_capacity``, ``soft_sphere_bulk_modulus``; relaxed
    first, or taken as given), with the discrete decisions either side may
    take differently by f32 rounding: the scale search's end (bracket and
    golden-section steps) and the modes above C_v's 1e10 rad/s floor (the
    three acoustic translations are zero up to rounding and sit near it).
    ``cv_gap``: the relative C_v gap once the floor modes are accounted for
    (each adds k_B per mass to within 1e-7); ``bm_gap``: the bulk modulus's,
    None where the searches end apart."""
    side = {}
    for dev in (device, "cpu"):
        relaxer = None if relax else as_given
        r = (SoftSphereRelaxer(max_atoms=s.num_atoms, lr_cell=0.0, device=dev)([s])[0][0]
             if relax else s)
        eq = phonon.equilibrate([r], relaxer=as_given, device=dev)[0]
        sc = phonon.supercell(eq, phonon.choose_reps(eq, 8.0, max_atoms))
        w = phonon.gamma_frequencies(sc, device=dev)
        side[dev] = dict(
            cv=phonon.gamma_heat_capacity([s], relaxer=relaxer, max_atoms=max_atoms, device=dev)[0],
            bm=phonon.soft_sphere_bulk_modulus([s], relaxer=relaxer, device=dev)[0],
            search=phonon.scale_search(r, torch.device(dev)), modes=int(np.sum(np.abs(w) > 1e10)),
            mass_g=float(np.sum(phonon.MASSES_AMU[sc.species])) * AMU_G,
        )
    card, cpu = side[device], side["cpu"]
    expected = cpu["cv"] + (card["modes"] - cpu["modes"]) * KB / card["mass_g"]
    same = card["search"] == cpu["search"]
    return dict(name=s.composition.formula, cv=card["cv"], cv_cpu=cpu["cv"],
                cv_gap=abs(card["cv"] - expected) / abs(cpu["cv"]),
                floor_modes=(card["modes"], cpu["modes"]), bm=card["bm"], bm_cpu=cpu["bm"],
                bm_gap=abs(card["bm"] - cpu["bm"]) / abs(cpu["bm"]) if same else None)
