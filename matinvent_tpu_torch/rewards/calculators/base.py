"""Calculator base class (``matinvent_tpu/rewards/calculators/base.py``).

A calculator gets ``samples = (structures, xyz_path)`` and returns one float
per structure, NaN marking a failure.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from matinvent_tpu_torch.chem.structure import Structure


class Calculator:
    def __init__(self, root_dir: str, task: str) -> None:
        self.root_dir = root_dir
        self.task = task
        os.makedirs(self.root_dir, exist_ok=True)

    def calc(self, samples: Tuple[List[Structure], str], label: str = "tmp") -> np.ndarray:
        raise NotImplementedError

    def save_results(self, results: np.ndarray, label: str) -> str:
        out_path = os.path.abspath(os.path.join(self.root_dir, f"{label}.txt"))
        np.savetxt(out_path, results, fmt="%.8f")
        return out_path
