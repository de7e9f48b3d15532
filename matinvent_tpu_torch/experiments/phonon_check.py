"""The native phonon and elastic workflows on the card against the CPU,
and the heat-capacity reward against JAX's record; ``chip_smoke.py``,
``experiments.tools_check`` and the card tests run it.

``phonon_pair`` gives C_v and the bulk modulus of one structure on both
devices beside the discrete decisions either side may take differently by
f32 rounding, and the gaps that remain once those are accounted for.
``heat_against_jax`` holds the reward ceiling's heat capacities design by
design against ``reward_ceiling_heat_jax.json``, JAX's values with the
spectra behind them.
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path

import numpy as np
import torch

from matinvent_tpu_torch.chem import phonon
from matinvent_tpu_torch.chem.relax import SoftSphereRelaxer
from matinvent_tpu_torch.chem.structure import Structure, read_extxyz, save_extxyz

KB, AMU_G = 1.380649e-23, 1.66053906660e-24
HEAT_RECORD = (Path(__file__).resolve().parent / "results" / "reward_ceiling_heat_jax.json")
# a design's C_v against JAX's: relative, once the floor modes are accounted for
HEAT_RTOL = 1e-3
# the acoustic translations are the modes near the floor: at most 3 differ
FLOOR_MODES_MAX = 3


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


def spectra(structures, device) -> list[dict]:
    """The heat-capacity chain (``phonon.gamma_spectra``) run directly on
    ``structures`` as the MLIP worker reads them from its extxyz file, in
    one relaxation batch as the worker takes them: per structure C_v as the
    worker writes it (6 decimals), the count of modes above the 1e10 rad/s
    floor that C_v sums over, the supercell's mass, the equilibrated cell
    and the relaxed one (its coordinates, the cell as read in f32: the
    relaxer leaves it unchanged at ``lr_cell`` 0)."""
    with tempfile.TemporaryDirectory() as work:
        structures = read_extxyz(save_extxyz(structures, os.path.join(work, "pick.extxyz")))
    out = []
    for given, (s, sc, w) in zip(structures, phonon.gamma_spectra(structures, device=device)):
        mass = phonon.supercell_mass(sc)
        cv = float("nan") if w is None else phonon.harmonic_heat_capacity(w, mass)
        relaxed = Structure(species=list(s.species), frac_coords=s.frac_coords,
                            lattice=given.lattice.astype(np.float32).astype(float))
        out.append(dict(heat_capacity=float(f"{cv:.6f}"),
                        modes_above_floor=None if w is None else int(np.sum(w > 1e10)),
                        supercell_mass_amu=mass, lattice=s.lattice, frac_coords=s.frac_coords,
                        relaxed=relaxed))
    return out


def at_equilibrium(species, lattice, frac_coords, device) -> tuple[float, int]:
    """(C_v, modes above the floor) of the port's spectrum of a structure
    taken as equilibrated, with no relaxation or scale search."""
    s = Structure(species=list(species), frac_coords=np.asarray(frac_coords, float),
                  lattice=np.asarray(lattice, float))
    sc = phonon.supercell(s, phonon.choose_reps(s, 8.0, 160))
    w = np.abs(phonon.gamma_frequencies(sc, device=device))
    return phonon.harmonic_heat_capacity(w, phonon.supercell_mass(sc)), int(np.sum(w > 1e10))


def heat_against_jax(structures, bridge_cv, index, device) -> dict:
    """The port's heat capacities of the designs ``index`` of the pick
    (``structures``, ``bridge_cv`` as the reward's bridge gave them) held
    against JAX's record, design by design.

    The port's chain is run again directly (``spectra``): its C_v must
    equal the bridge's, so its spectrum is the one behind the reward. Both
    sides count the modes above C_v's 1e10 rad/s floor: the three acoustic
    translations are zero up to f32 rounding, and either side may count
    one of them, each adding k_B over the supercell's mass (as
    ``tests/test_torch_port_phonon.py`` accounts them; at most
    ``FLOOR_MODES_MAX``). Each design's kind:

    * ``equal``: within ``HEAT_RTOL`` of JAX's;
    * ``floor_modes n``: within it once the n modes counted on one side
      only are accounted for;
    * ``scale_search``: the equilibrated cells differ: the isotropic-scale
      search ended apart, one of its energy comparisons turned the other
      way on coordinates the relaxation left apart by f32 rounding
      (``lattice_gap``, ``frac_gap``; ``search_parts``: the step where the
      two searches part and both sides' margins there, JAX's from the
      record);
    * ``jax_nudge``: JAX's own value moves beyond ``HEAT_RTOL`` when every
      cell is scaled by 1 +- 1e-6;
    * ``differs``: none of these.

    And the probe of the spectrum alone: the port's C_v at JAX's
    equilibrated cell, within ``HEAT_RTOL`` of JAX's once the floor modes
    are accounted for, on every design. ``ok`` when the bridge and the
    direct run agree, no design ``differs`` and every probe holds."""
    ref = json.loads(HEAT_RECORD.read_text())
    ours = spectra(structures, device)
    rows, kinds = [], {}
    for k, i in enumerate(index):
        jax, theirs, mine = ref["heat_capacity"][i], ref["spectra"][i], ours[k]
        cv = mine["heat_capacity"]
        row = dict(ref["designs"][i], port=cv, jax=jax, bridge=float(bridge_cv[k]),
                   modes_above_floor=(mine["modes_above_floor"], theirs["modes_above_floor"]))
        if jax is None or not np.isfinite(cv):
            row["kind"] = "equal" if jax is None and not np.isfinite(cv) else "differs"
        else:
            nudged = [run[i] for run in ref["heat_capacity_nudged"]]
            n = mine["modes_above_floor"] - theirs["modes_above_floor"]
            mode = KB / (mine["supercell_mass_amu"] * AMU_G)
            row["gap"] = abs(cv - jax) / abs(jax)
            row["gap_floor_modes"] = abs(cv - jax - n * mode) / abs(jax)
            row["lattice_gap"] = float(np.abs(mine["lattice"] - np.asarray(theirs["lattice"])).max()
                                       / np.abs(np.asarray(theirs["lattice"])).max())
            row["frac_gap"] = float(np.abs((mine["frac_coords"] - np.asarray(theirs["frac_coords"])
                                            + 0.5) % 1.0 - 0.5).max())
            row["jax_nudge_gap"] = max(abs(v - jax) / abs(jax) if v is not None else np.inf
                                       for v in nudged)
            probe, probe_modes = at_equilibrium(structures[k].species, theirs["lattice"],
                                                theirs["frac_coords"], device)
            jax_mode = KB / (theirs["supercell_mass_amu"] * AMU_G)
            row["probe_modes"] = probe_modes - theirs["modes_above_floor"]
            row["probe_gap"] = abs(probe - jax - row["probe_modes"] * jax_mode) / abs(jax)
            if row["lattice_gap"] > 1e-9:
                # where the two searches part: the grid's minimum, or the
                # first golden-section decision taken the other way, with
                # both sides' margins there
                k_port, _, port_steps = phonon.scale_search_steps(mine["relaxed"], torch.device(device))
                k_jax, jax_steps = theirs["search"]
                part = next((j for j, (a, b) in enumerate(zip(port_steps, jax_steps))
                             if a[0] != b[0]), None)
                row["search_parts"] = (
                    dict(at="grid", k=(k_port, k_jax)) if k_port != k_jax
                    else dict(at=part, margins=(port_steps[part][1], jax_steps[part][1]))
                    if part is not None else dict(at=None))
            if row["gap"] <= HEAT_RTOL:
                row["kind"] = "equal"
            elif n and abs(n) <= FLOOR_MODES_MAX and row["gap_floor_modes"] <= HEAT_RTOL:
                row["kind"] = f"floor_modes {n:+d}"
            elif row["lattice_gap"] > 1e-9:
                row["kind"] = "scale_search"
            elif row["jax_nudge_gap"] > HEAT_RTOL:
                row["kind"] = "jax_nudge"
            else:
                row["kind"] = "differs"
        kinds[row["kind"].split()[0]] = kinds.get(row["kind"].split()[0], 0) + 1
        rows.append(row)
    bridge_equal = sum(r["port"] == r["bridge"] or not (np.isfinite(r["port"]) or np.isfinite(r["bridge"]))
                       for r in rows)
    probes = [r for r in rows if "probe_gap" in r]
    probe_ok = all(r["probe_gap"] <= HEAT_RTOL and abs(r["probe_modes"]) <= FLOOR_MODES_MAX
                   for r in probes)
    return dict(designs=rows, kinds=kinds, bridge_equal=bridge_equal,
                probe_gap_max=max((r["probe_gap"] for r in probes), default=None),
                ok=bridge_equal == len(rows) and "differs" not in kinds and probe_ok)
