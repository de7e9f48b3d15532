"""Long-term memory (``matinvent_tpu/memory/ltm.py``), on lists instead of pandas.

An append-only record of every scored crystal; the Augmented-Hill-Climb
diversity filter (occurrence-count reward decay); the Burden and
Diversity-Ratio metrics; a CSV dump with CIFs as the audit trail. The JAX
package's moving-average baseline is left out: its pipeline computes it
and does not use it.
"""
from __future__ import annotations

import csv
from collections import Counter
from typing import List, Tuple

import numpy as np

from matinvent_tpu_torch.chem.structure import Structure
from matinvent_tpu_torch.memory.table import Row, comp_keys, drop_duplicates, sort_by_reward


class LongTimeMem:
    COLUMNS = ("struc", "comp", "ele_comb", "reward", "RL_step")

    def __init__(self) -> None:
        self.memory: List[Row] = []
        self.unique_comps: List[str] = []

    def extend(self, strucs: List[Structure], rewards: np.ndarray, step: int) -> None:
        comps, ele_comb = comp_keys(strucs)
        for s, c, e, r in zip(strucs, comps, ele_comb, np.asarray(rewards, dtype=float)):
            self.memory.append(dict(struc=s, comp=c, ele_comb=e, reward=float(r), RL_step=step))
        self.unique_comps = list(dict.fromkeys(row["comp"] for row in self.memory))

    def div_filter(
        self,
        strucs: List[Structure],
        rewards: np.ndarray,
        tol: int = 10,
        buff: int = 20,
        method: str = "composition",
        **kwargs,
    ) -> Tuple[np.ndarray, list, int, int]:
        """Augmented-Hill-Climb reward decay: an occurrence count up to
        ``tol`` keeps the reward, one between ``tol`` and ``buff`` decays it
        linearly, and ``buff`` or more zeroes it (a penalty)."""
        if not tol < buff:
            raise ValueError(f"div_filter needs tol < buff, got {tol}, {buff}")
        comps, ele_comb = comp_keys(strucs)
        if method == "composition":
            key, values = "comp", comps
        elif method == "element_comb":
            key, values = "ele_comb", ele_comb
        else:
            raise ValueError(f"unknown div_filter method {method}")
        occ_counts = Counter(row[key] for row in self.memory)
        new_rewards, penalty_idx = [], []
        tol_n = buff_n = 0
        for i, v in enumerate(values):
            occ = occ_counts.get(v, 0)
            if occ <= tol:
                new_rewards.append(float(rewards[i]))
            elif occ < buff:
                new_rewards.append(float(rewards[i]) * (buff - occ) / (buff - tol))
                tol_n += 1
            else:
                new_rewards.append(0.0)
                penalty_idx.append(i)
                buff_n += 1
        return np.array(new_rewards), penalty_idx, tol_n, buff_n

    def calc_metrics(
        self, thred: float, budget: int = 3000, num_candidate: int = 100
    ) -> Tuple[float | None, float | None]:
        """Burden (evaluations per unique candidate above ``thred``, once
        ``num_candidate`` are found) and Diversity Ratio (unique
        compositions per evaluation within ``budget``)."""
        unique = self.deduplicate(self.memory)
        candidates = sum(row["reward"] > thred for row in unique)
        calc_cost = len(self.memory)
        burden = calc_cost / candidates if candidates >= num_candidate else None
        div_ratio = (
            len(self.unique_comps) / calc_cost if 0 < calc_cost <= budget else None
        )
        return burden, div_ratio

    @staticmethod
    def deduplicate(rows: List[Row], method: str = "composition") -> List[Row]:
        if method != "composition":
            raise ValueError(f"unknown dedup method {method}")
        return drop_duplicates(sort_by_reward(rows), "comp")

    def save(self, save_path: str) -> None:
        """CSV of every row plus its CIF, every field quoted."""
        with open(save_path, "w", newline="") as fh:
            w = csv.writer(fh, quoting=csv.QUOTE_ALL)
            w.writerow([*self.COLUMNS, "cif"])
            for row in self.memory:
                w.writerow([*(row[c] for c in self.COLUMNS), row["struc"].to_cif()])

    def __len__(self) -> int:
        return len(self.memory)
