"""Row tables of the port's memory, ordered as pandas orders them.

The JAX package keeps its long-term memory and replay buffer in pandas
DataFrames; the port keeps lists of row dicts. Rewards tie often (the HHI
reward is clipped to [0, 1]), so the order of tied rows decides what is
kept: ``sort_by_reward`` reproduces ``DataFrame.sort_values('reward',
ascending=False)`` (pandas' ``nargsort``: reverse, ``argsort(kind=
'quicksort')``, reverse; NaN last) and ``drop_duplicates`` keeps the first
row of each key, as pandas does.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

Row = Dict[str, Any]


def sort_by_reward(rows: List[Row]) -> List[Row]:
    """``rows`` in the order of ``sort_values('reward', ascending=False)``."""
    r = np.array([row["reward"] for row in rows], dtype=float)
    nan = np.isnan(r)
    idx = np.arange(len(r))[~nan][::-1]
    order = idx[r[~nan][::-1].argsort(kind="quicksort")][::-1]
    order = np.concatenate([order, np.nonzero(nan)[0]])
    return [rows[i] for i in order]


def drop_duplicates(rows: List[Row], key: str) -> List[Row]:
    """The first row of each value of ``key``, in order."""
    seen, out = set(), []
    for row in rows:
        if row[key] not in seen:
            seen.add(row[key])
            out.append(row)
    return out


def comp_keys(strucs) -> tuple[list[str], list[tuple]]:
    """(reduced formulas, sorted element tuples) of ``strucs``."""
    comps = [s.composition.reduced_formula for s in strucs]
    ele_comb = [tuple(sorted(set(s.composition.elements))) for s in strucs]
    return comps, ele_comb
