"""Empirical (no-ML) property calculators (``matinvent_tpu/rewards/calculators/empirical.py``).

Density, the HHI supply-risk score, elemental price, (log) crustal
abundance, and the minimal coincident interface area with a substrate
(MCIA, ``zsl.py``).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from matinvent_tpu_torch.chem.data import (
    CRUSTAL_ABUNDANCE_PPM,
    ELEMENT_PRICE_USD_PER_KG,
    HHI_RESERVE,
)
from matinvent_tpu_torch.chem.niggli import niggli_reduce_matrix
from matinvent_tpu_torch.chem.structure import Structure
from matinvent_tpu_torch.rewards.calculators.base import Calculator
from matinvent_tpu_torch.rewards.calculators.zsl import MILLERS_MAX1, mcia_search


def calc_density(structures: List[Structure]) -> np.ndarray:
    """g/cm^3 per structure."""
    return np.array([s.density for s in structures], dtype=float)


def calc_hhi(structures: List[Structure]) -> np.ndarray:
    """Molar-fraction-weighted HHI reserve score per structure; NaN when an
    element lacks data (pymatgen's ``HHIModel`` weighting)."""
    out = []
    for s in structures:
        comp = s.composition
        total = comp.num_atoms
        try:
            val = sum(HHI_RESERVE[el] * n / total for el, n in comp.counts.items())
        except KeyError:
            val = np.nan
        out.append(val)
    return np.array(out, dtype=float)


def calc_price(structures: List[Structure]) -> np.ndarray:
    """Mass-fraction-weighted USD/kg."""
    out = []
    for s in structures:
        wf = s.composition.weight_fractions
        try:
            out.append(sum(ELEMENT_PRICE_USD_PER_KG[el] * f for el, f in wf.items()))
        except KeyError:
            out.append(np.nan)
    return np.array(out, dtype=float)


def calc_abundance_crust(structures: List[Structure]) -> np.ndarray:
    """Mass-fraction-weighted crustal abundance in ppm; NaN where it is not
    positive."""
    out = []
    for s in structures:
        wf = s.composition.weight_fractions
        try:
            val = sum(CRUSTAL_ABUNDANCE_PPM[el] * f for el, f in wf.items())
        except KeyError:
            val = np.nan
        if not np.isnan(val) and val <= 0.0:
            val = np.nan
        out.append(val)
    return np.array(out, dtype=float)


def calc_log_abundance_crust(structures: List[Structure]) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.log10(calc_abundance_crust(structures))


# Substrate facets restricted by industry practice: wafer substrates are
# cut (100); everything else searches all distinct planes up to Miller
# index 1.
SUB_MILLERS = {
    "Si": [(1, 0, 0)],
    "GaAs": [(1, 0, 0)],
    "InP": [(1, 0, 0)],
}


def calc_mcia(
    structures: List[Structure],
    substrate: Structure,
    substrate_millers=None,
    max_area: float = 400.0,
) -> np.ndarray:
    """Minimal coincident interface area (A^2) vs a substrate.

    Zur-McGill ZSL search over all film Miller indices <= 1 x the substrate
    facets (pymatgen ZSLGenerator tolerances). Cells are Niggli-reduced
    first, the stand-in for pymatgen's conventional standardization.
    """
    sub_lat = niggli_reduce_matrix(substrate.lattice)
    sub_millers = substrate_millers if substrate_millers is not None else MILLERS_MAX1
    out = []
    for s in structures:
        try:
            film_lat = niggli_reduce_matrix(s.lattice)
            area = mcia_search(
                film_lat, sub_lat, sub_millers=sub_millers, max_area=max_area
            )
            out.append(area if area is not None else np.nan)
        except Exception:
            out.append(np.nan)
    return np.array(out, dtype=float)


# 9 wafer substrates: conventional cells from public lattice constants.
# Only the lattice enters the ZSL search; sites are representative.
_DIAMOND = np.vstack(
    [
        np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]),
        np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]) + 0.25,
    ]
)
_WURTZITE = np.array(
    [
        [1 / 3, 2 / 3, 0.0], [2 / 3, 1 / 3, 0.5],  # cations
        [1 / 3, 2 / 3, 0.382], [2 / 3, 1 / 3, 0.882],  # anions
    ]
)


def make_substrate(name: str) -> Structure:
    def cubic(a, species, frac):
        return Structure.from_parameters([a] * 3, [90] * 3, species, frac % 1.0)

    def hexagonal(a, c, species, frac):
        return Structure.from_parameters(
            [a, a, c], [90, 90, 120], species, frac % 1.0
        )

    if name == "Si":  # diamond cubic
        return cubic(5.431, [14] * 8, _DIAMOND)
    if name == "Ge":  # diamond cubic
        return cubic(5.6749, [32] * 8, _DIAMOND)
    if name == "GaAs":  # zinc blende
        return cubic(5.653, [31] * 4 + [33] * 4, _DIAMOND)
    if name == "InP":  # zinc blende
        return cubic(5.869, [49] * 4 + [15] * 4, _DIAMOND)
    if name == "AlN":  # wurtzite
        return hexagonal(3.1286, 5.0170, [13, 13, 7, 7], _WURTZITE)
    if name == "GaN":  # wurtzite
        return hexagonal(3.1889, 5.1924, [31, 31, 7, 7], _WURTZITE)
    if name == "SiC":  # 6H polytype (hexagonal); sites simplified to 2H
        return hexagonal(3.0766, 15.0981, [14, 14, 6, 6], _WURTZITE)
    if name == "SiO2":  # alpha-quartz lattice
        return hexagonal(
            4.9150, 5.4313, [14, 14, 14, 8, 8, 8],
            np.array(
                [
                    [0.470, 0.0, 1 / 3], [0.0, 0.470, 2 / 3], [0.530, 0.530, 0.0],
                    [0.415, 0.267, 0.214], [0.733, 0.148, 0.547],
                    [0.852, 0.585, 0.881],
                ]
            ),
        )
    if name == "Al2O3":  # corundum (hexagonal setting); Al sites only
        return hexagonal(
            4.8050, 13.1163, [13] * 4 + [8] * 2,
            np.array(
                [
                    [0, 0, 0.352], [0, 0, 0.648], [1 / 3, 2 / 3, 0.019],
                    [2 / 3, 1 / 3, 0.981], [0.306, 0.0, 0.25], [0.0, 0.306, 0.75],
                ]
            ),
        )
    raise ValueError(f"unknown substrate {name}")


class Empirical(Calculator):
    """Task-dispatching empirical calculator; ``substrate`` names the MCIA
    task's substrate (``make_substrate``)."""

    TASKS = {
        "density": calc_density,
        "hhi": calc_hhi,
        "price": calc_price,
        "abundance": calc_abundance_crust,
        "log_abundance": calc_log_abundance_crust,
        "mcia": calc_mcia,
    }

    def __init__(self, root_dir: str, task: str = "density", substrate: str = "Si"):
        if task not in self.TASKS:
            raise ValueError(f"{task} is an unknown task for the Empirical calculator")
        super().__init__(root_dir, task)
        self.substrate = make_substrate(substrate) if task == "mcia" else None
        self.substrate_millers = SUB_MILLERS.get(substrate) if task == "mcia" else None

    def calc(self, samples: Tuple[List[Structure], str], label: str = "tmp") -> np.ndarray:
        structures = samples[0]
        if self.task == "mcia":
            results = calc_mcia(structures, self.substrate, substrate_millers=self.substrate_millers)
        else:
            results = self.TASKS[self.task](structures)
        self.save_results(results, label)
        return results
