"""Empirical (no-ML) property calculators (``matinvent_tpu/rewards/calculators/empirical.py``).

Ported: density and the HHI supply-risk score. The JAX package's other
tasks (price, abundance, log_abundance, mcia) raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from matinvent_tpu_torch.chem.data import HHI_RESERVE
from matinvent_tpu_torch.chem.structure import Structure
from matinvent_tpu_torch.rewards.calculators.base import Calculator


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


class Empirical(Calculator):
    """Task-dispatching empirical calculator."""

    TASKS = {"density": calc_density, "hhi": calc_hhi}
    NOT_PORTED = ("price", "abundance", "log_abundance", "mcia")

    def __init__(self, root_dir: str, task: str = "density"):
        if task in self.NOT_PORTED:
            raise NotImplementedError(f"the empirical task {task!r} is not ported yet")
        if task not in self.TASKS:
            raise ValueError(f"{task} is an unknown task for the Empirical calculator")
        super().__init__(root_dir, task)

    def calc(self, samples: Tuple[List[Structure], str], label: str = "tmp") -> np.ndarray:
        results = self.TASKS[self.task](samples[0])
        self.save_results(results, label)
        return results
