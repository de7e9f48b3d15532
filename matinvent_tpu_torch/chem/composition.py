"""Composition: element counts, reduced formulas, weight fractions
(``matinvent_tpu/chem/composition.py``).

Reduced formulas are gcd-reduced and ordered by Pauling electronegativity
ascending (ties alphabetical), as the JAX package orders them: memory and
replay deduplicate by them.
"""
from __future__ import annotations

import math
import re
from collections import Counter
from functools import reduce
from typing import Iterable, Mapping

from matinvent_tpu_torch.chem.data import (
    ATOMIC_WEIGHTS,
    ELECTRONEGATIVITY,
    METALS,
    SYMBOLS,
    Z_BY_SYMBOL,
)

_FORMULA_TOKEN = re.compile(r"([A-Z][a-z]?|\(|\))(\d*\.?\d*)")


def _parse_formula(formula: str) -> Counter:
    """Parse a chemical formula incl. parenthesized groups and fractional
    counts, e.g. 'Ca(OH)2' -> {Ca:1, O:2, H:2}, 'Li0.5CoO2' -> {Li:0.5, ...}."""
    tokens = [(t, n) for t, n in _FORMULA_TOKEN.findall(formula) if t]
    if "".join(t + n for t, n in tokens) != formula.replace(" ", ""):
        raise ValueError(f"cannot parse formula: {formula!r}")

    def count(n: str) -> float:
        return float(n) if n else 1.0

    stack: list[Counter] = [Counter()]
    for tok, n in tokens:
        if tok == "(":
            if n:
                raise ValueError(f"cannot parse formula: {formula!r}")
            stack.append(Counter())
        elif tok == ")":
            if len(stack) < 2:
                raise ValueError(f"unbalanced parentheses in formula: {formula!r}")
            group = stack.pop()
            mult = count(n)
            for sym, c in group.items():
                stack[-1][sym] += c * mult
        else:
            stack[-1][tok] += count(n)
    if len(stack) != 1:
        raise ValueError(f"unbalanced parentheses in formula: {formula!r}")
    return stack[0]


class Composition:
    """Immutable element->count mapping with formula utilities."""

    def __init__(self, counts: Mapping[str, float] | Iterable[int] | str):
        if isinstance(counts, str):
            items = {k: v for k, v in _parse_formula(counts).items() if v > 0}
        elif isinstance(counts, Mapping):
            items = {k: v for k, v in counts.items() if v > 0}
        else:  # iterable of atomic numbers
            c: Counter = Counter()
            for z in counts:
                c[SYMBOLS[int(z)]] += 1
            items = c
        if not items:
            raise ValueError("empty composition")
        for sym in items:
            if sym not in Z_BY_SYMBOL:
                raise ValueError(f"unknown element symbol: {sym}")
        self._counts = dict(sorted(items.items()))

    # ------------------------------------------------------------- accessors
    @property
    def elements(self) -> list[str]:
        return list(self._counts.keys())

    @property
    def counts(self) -> dict[str, float]:
        return dict(self._counts)

    @property
    def num_atoms(self) -> float:
        return sum(self._counts.values())

    @property
    def weight(self) -> float:
        """Formula weight in g/mol."""
        return sum(ATOMIC_WEIGHTS[s] * n for s, n in self._counts.items())

    @property
    def weight_fractions(self) -> dict[str, float]:
        w = self.weight
        return {s: ATOMIC_WEIGHTS[s] * n / w for s, n in self._counts.items()}

    @property
    def is_all_metal(self) -> bool:
        return all(s in METALS for s in self._counts)

    # --------------------------------------------------------------- formulas
    def _sorted_symbols(self) -> list[str]:
        return sorted(
            self._counts.keys(),
            key=lambda s: (ELECTRONEGATIVITY.get(s, 5.0), s),
        )

    @property
    def reduced_counts(self) -> dict[str, int]:
        ints = {s: int(round(n)) for s, n in self._counts.items()}
        if any(abs(self._counts[s] - ints[s]) > 1e-6 for s in ints):
            # non-integer composition: no reduction
            return {s: n for s, n in self._counts.items()}
        g = reduce(math.gcd, ints.values())
        g = max(g, 1)
        return {s: n // g for s, n in ints.items()}

    @property
    def reduced_formula(self) -> str:
        red = self.reduced_counts
        parts = []
        for s in self._sorted_symbols():
            n = red[s]
            parts.append(s if n == 1 else f"{s}{n:g}")
        return "".join(parts)

    @property
    def formula(self) -> str:
        parts = []
        for s in self._sorted_symbols():
            n = self._counts[s]
            parts.append(f"{s}{n:g}" if n != 1 else s)
        return "".join(parts)

    # ------------------------------------------------------------------ dunder
    def __eq__(self, other) -> bool:
        return isinstance(other, Composition) and self._counts == other._counts

    def __hash__(self) -> int:
        return hash(tuple(sorted(self._counts.items())))

    def __repr__(self) -> str:
        return f"Composition({self.formula})"
