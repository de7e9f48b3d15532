"""Energy-above-hull stability (``matinvent_tpu/chem/ehull.py``).

The convex-hull energy at a query composition is computed directly as a
linear program:

    min sum_i w_i * E_i   s.t.  sum_i w_i * x_i = x_query,  sum_i w_i = 1,
                                w_i >= 0

over reference entries i restricted to the query's chemical system — the
hull energy is the cheapest mixture of known phases with the same overall
composition (scipy HiGHS; no explicit hull construction, robust in any
dimension).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np
from scipy.optimize import linprog

from matinvent_tpu_torch.chem.composition import Composition


@dataclass(frozen=True)
class PhaseEntry:
    """A known phase: composition + energy per atom (eV/atom)."""

    composition: Composition
    energy_per_atom: float

    @classmethod
    def make(cls, formula: str | Composition, energy_per_atom: float) -> "PhaseEntry":
        comp = formula if isinstance(formula, Composition) else Composition(formula)
        return cls(comp, float(energy_per_atom))


class ConvexHullReference:
    """Reference phase set with hull-energy queries."""

    def __init__(self, entries: Iterable[PhaseEntry]):
        self.entries = list(entries)
        self._by_element: dict[str, list[int]] = {}
        for i, e in enumerate(self.entries):
            for el in e.composition.elements:
                self._by_element.setdefault(el, []).append(i)

    @property
    def known_elements(self) -> set[str]:
        return set(self._by_element.keys())

    def _system_entries(self, elements: Sequence[str]) -> list[PhaseEntry]:
        system = set(elements)
        idx: set[int] = set()
        for el in system:
            idx.update(self._by_element.get(el, []))
        return [
            self.entries[i]
            for i in sorted(idx)
            if set(self.entries[i].composition.elements) <= system
        ]

    def hull_energy(self, comp: Composition) -> float:
        """Hull energy per atom at ``comp``; NaN if the system is not covered."""
        elements = comp.elements
        if not set(elements) <= self.known_elements:
            return float("nan")
        entries = self._system_entries(elements)
        if not entries:
            return float("nan")

        el_list = sorted(set(elements))
        total = comp.num_atoms
        x_query = np.array([comp.counts.get(el, 0.0) / total for el in el_list])

        # columns: one mixture weight per entry
        A_eq = np.zeros((len(el_list) + 1, len(entries)))
        for j, e in enumerate(entries):
            n = e.composition.num_atoms
            for i, el in enumerate(el_list):
                A_eq[i, j] = e.composition.counts.get(el, 0.0) / n
            A_eq[-1, j] = 1.0
        b_eq = np.concatenate([x_query, [1.0]])
        c = np.array([e.energy_per_atom for e in entries])

        res = linprog(c, A_eq=A_eq, b_eq=b_eq, bounds=(0, None), method="highs")
        if not res.success:
            return float("nan")
        return float(res.fun)

    def energy_above_hull(self, comp: Composition, energy_per_atom: float) -> float:
        hull = self.hull_energy(comp)
        if np.isnan(hull):
            return float("nan")
        return float(energy_per_atom) - hull


def stable_mask(
    structures,
    energies: Sequence[float],
    reference: ConvexHullReference,
    threshold: float = 0.1,
) -> np.ndarray:
    """True where energy-above-hull <= threshold (eV/atom). ``energies`` are
    TOTAL energies (eV) per structure, as the MLIP relaxers report."""
    out = np.zeros(len(structures), dtype=bool)
    for i, (s, e_tot) in enumerate(zip(structures, energies)):
        if e_tot is None or not np.isfinite(e_tot):
            continue
        e_per_atom = float(e_tot) / max(s.num_atoms, 1)
        ehull = reference.energy_above_hull(s.composition, e_per_atom)
        out[i] = np.isfinite(ehull) and ehull <= threshold
    return out
