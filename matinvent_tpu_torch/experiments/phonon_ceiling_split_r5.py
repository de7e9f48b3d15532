"""Heat-capacity ceiling, split into sampling and potential
(``experiments/phonon_ceiling_split_r5.py`` of the JAX package), with the
Hessian on the card.

    python -m matinvent_tpu_torch.experiments.phonon_ceiling_split_r5 \\
        [out=runs/phonon_ceiling_split_r5] [device=cpu]

For each design (the measured ceiling design and two hydride cells), on
the native soft-sphere workflow (``chem.phonon``: equilibrate, supercell,
Γ-point Hessian, harmonic C_v at 300 K): the Dulong-Petit bound of its
composition; C_v against the supercell's minimum length (6/8/10/12 Å at
atom caps 80/160/300/480: the sampling split; the 12 Å cells hold 375-480
atoms); and C_v at 10 Å against a uniform frequency scale (0.5/0.707/1/1.414,
ω ∝ sqrt(well depth): the potential split).
``<out>/phonon_ceiling_split_r5.json`` has JAX's keys.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from matinvent_tpu_torch.chem.data import ATOMIC_WEIGHTS, SYMBOLS, Z_BY_SYMBOL
from matinvent_tpu_torch.chem.phonon import (
    MASSES_AMU,
    choose_reps,
    equilibrate,
    gamma_frequencies,
    harmonic_heat_capacity,
    supercell,
)
from matinvent_tpu_torch.chem.structure import Structure
from matinvent_tpu_torch.device import resolve_device
from matinvent_tpu_torch.experiments.validity_fix_r5 import ROOT
from matinvent_tpu_torch.main import pop_device

KB_3R_PER_G = 24.943  # Dulong-Petit 3R, J/(mol K); over the mean molar mass, J/(g K)

DESIGNS = {
    "Li2N_antifluorite": Structure.from_parameters(
        [3.582] * 3, [90.0] * 3,
        [Z_BY_SYMBOL["Li"]] * 2 + [Z_BY_SYMBOL["N"]],
        np.array([[0.25, 0.25, 0.25], [0.75, 0.75, 0.75], [0.0, 0.0, 0.0]]),
    ),
    "LiH_rocksalt": Structure.from_parameters(
        [2.04 * 2.0] * 3, [90.0] * 3,
        [Z_BY_SYMBOL["Li"], Z_BY_SYMBOL["H"]],
        np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
    ),
    "BeH2_fluorite": Structure.from_parameters(
        [1.27 * 2.0] * 3, [90.0] * 3,
        [Z_BY_SYMBOL["Be"], Z_BY_SYMBOL["H"], Z_BY_SYMBOL["H"]],
        np.array([[0.0, 0.0, 0.0], [0.25, 0.25, 0.25], [0.75, 0.75, 0.75]]),
    ),
}
LADDER = ((6.0, 80), (8.0, 160), (10.0, 300), (12.0, 480))  # (min_length Å, atom cap)
FREQ_SCALES = (0.5, 0.707, 1.0, 1.414)

REWARD_MIN, REWARD_MAX, THRESHOLD = 0.25, 2.00, 0.8


def reward_of(cv: float) -> float:
    return float(np.clip((cv - REWARD_MIN) / (REWARD_MAX - REWARD_MIN), 0, 1))


def dulong_petit_cv(structure: Structure) -> float:
    masses = [ATOMIC_WEIGHTS[SYMBOLS[z]] for z in structure.species]
    return round(KB_3R_PER_G / float(np.mean(masses)), 4)


def equilibrated_supercell(structure: Structure, min_length: float, max_atoms: int,
                           device=None) -> Structure:
    """``structure`` equilibrated (``chem.phonon.equilibrate``), in the
    supercell toward ``min_length`` Å under ``max_atoms`` atoms."""
    s = equilibrate([structure], None, resolve_device(device))[0]
    return supercell(s, choose_reps(s, min_length, max_atoms))


def cv_at(structure: Structure, min_length: float, max_atoms: int, freq_scale: float = 1.0,
          temperature: float = 300.0, device=None) -> tuple[float, int]:
    """(C_v in J/(g K), supercell atoms) of ``structure`` equilibrated, in
    the supercell toward ``min_length`` under ``max_atoms``, its Γ
    frequencies scaled by ``freq_scale``."""
    sc = equilibrated_supercell(structure, min_length, max_atoms, device)
    omega = np.abs(gamma_frequencies(sc, device=resolve_device(device))) * freq_scale
    mass = float(np.sum(MASSES_AMU[np.asarray(sc.species)]))
    return harmonic_heat_capacity(omega, mass, temperature), sc.num_atoms


def design_entry(s: Structure, device=None, name: str = "") -> dict:
    entry = {"dulong_petit_cv": dulong_petit_cv(s)}
    conv = {}
    for ml, cap in LADDER:
        t0 = time.time()
        cv, n = cv_at(s, ml, cap, device=device)
        conv[f"min_length_{ml:g}"] = dict(cv=round(cv, 4), reward=round(reward_of(cv), 4),
                                          supercell_atoms=n, seconds=round(time.time() - t0, 1))
        print(name, ml, "->", conv[f"min_length_{ml:g}"], flush=True)
    entry["supercell_convergence"] = conv
    pot = {}
    for fs in FREQ_SCALES:
        cv, _ = cv_at(s, 10.0, 300, freq_scale=fs, device=device)
        pot[f"freq_scale_{fs:g}"] = dict(cv=round(cv, 4), reward=round(reward_of(cv), 4),
                                         depth_equiv_eV=round(0.3 * fs * fs, 4))
    entry["potential_split"] = pot
    return entry


def main(argv: list[str] | None = None) -> dict:
    argv, device = pop_device(list(sys.argv[1:] if argv is None else argv))
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    out_dir = os.path.abspath(kv.get("out", os.path.join(ROOT, "runs", "phonon_ceiling_split_r5")))
    out = {"threshold_cv": REWARD_MIN + THRESHOLD * (REWARD_MAX - REWARD_MIN)}
    for name, s in DESIGNS.items():
        out[name] = design_entry(s, device, name)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "phonon_ceiling_split_r5.json"), "w") as fh:
        json.dump(out, fh, indent=2)
        fh.write("\n")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
