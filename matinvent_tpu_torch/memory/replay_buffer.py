"""Experience replay buffer (``matinvent_tpu/memory/replay_buffer.py``), on
lists instead of pandas.

Keeps the ``buffer_size`` highest-reward crystals so far, one per reduced
formula, above a reward cutoff; samples a few for each fine-tune, and drops
the compositions the diversity filter penalizes. ``data`` entries are the
per-crystal sample dicts, ``struc`` the ``Structure`` objects.
"""
from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np

from matinvent_tpu_torch.chem.structure import Structure
from matinvent_tpu_torch.memory.table import Row, comp_keys, drop_duplicates, sort_by_reward


class ReplayBuffer:
    def __init__(
        self,
        buffer_size: int = 100,
        sample_size: int = 8,
        reward_cutoff: float = 0.0,
        seed: int | None = None,
    ) -> None:
        self.buffer_size = buffer_size
        self.sample_size = sample_size
        self.reward_cutoff = reward_cutoff
        self._rng = np.random.default_rng(seed)
        self.buffer: List[Row] = []

    @property
    def rewards(self) -> np.ndarray:
        return np.array([row["reward"] for row in self.buffer], dtype=float)

    def extend(self, data: List[Any], strucs: List[Structure], rewards: np.ndarray) -> None:
        if len(data) == 0:
            return
        comps, ele_comb = comp_keys(strucs)
        new = [
            dict(data=d, struc=s, comp=c, ele_comb=e, reward=float(r))
            for d, s, c, e, r in zip(data, strucs, comps, ele_comb, np.asarray(rewards, dtype=float))
        ]
        rows = sort_by_reward(self.deduplicate(self.buffer + new))[: self.buffer_size]
        self.buffer = [row for row in rows if row["reward"] > self.reward_cutoff]

    @staticmethod
    def deduplicate(rows: List[Row], method: str = "composition") -> List[Row]:
        return drop_duplicates(sort_by_reward(rows), "comp" if method == "composition" else "ele_comb")

    def sample(self) -> Tuple[List[Any], np.ndarray]:
        """Up to ``sample_size`` rows without replacement, drawn as pandas'
        ``DataFrame.sample(n, random_state=s)`` draws them."""
        n = min(len(self.buffer), self.sample_size)
        if n == 0:
            return [], np.array([])
        seed = int(self._rng.integers(2**31))
        idx = np.random.RandomState(seed).choice(len(self.buffer), size=n, replace=False)
        rows = [self.buffer[i] for i in idx]
        return [row["data"] for row in rows], np.array([row["reward"] for row in rows], dtype=float)

    def memory_purge(self, strucs: List[Structure]) -> None:
        comps = {s.composition.reduced_formula for s in strucs}
        self.buffer = [row for row in self.buffer if row["comp"] not in comps]

    def __len__(self) -> int:
        return len(self.buffer)
