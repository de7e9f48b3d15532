"""MLIP workflow bridge (``matinvent_tpu/rewards/calculators/mlip/calc.py``).

Runs the elastic (bulk modulus) or phonon (heat capacity at 300 K) worker
script in a subprocess, optionally inside another conda environment
(``conda run -n <env_name>``), exchanging the structures through an extxyz
file and the results through a text file of one value per structure. The
worker runs on the bridge's device (``--device``). It uses quacc's MLIP
workflows where quacc is importable and otherwise the native soft-sphere
workflows of ``chem.phonon``, and names its backend on stderr, which the
bridge logs. A worker that exits non-zero, or writes no file or the wrong
number of values, makes the bridge raise.

The subprocess inherits the caller's environment unchanged: the worker
script puts its own checkout on ``sys.path`` and imports only the port.
"""
from __future__ import annotations

import logging
import os
import subprocess
import sys
from typing import List, Tuple

import numpy as np
import torch

from matinvent_tpu_torch.chem.structure import Structure, save_extxyz
from matinvent_tpu_torch.device import resolve_device
from matinvent_tpu_torch.rewards.calculators.base import Calculator

_HERE = os.path.dirname(os.path.abspath(__file__))
ELASTIC_PATH = os.path.join(_HERE, "elastic.py")
PHONON_PATH = os.path.join(_HERE, "phonon.py")


class MLIPBridge(Calculator):
    TASK_SCRIPTS = {"bulk_modulus": ELASTIC_PATH, "heat_capacity": PHONON_PATH}

    def __init__(
        self,
        root_dir: str,
        task: str = "bulk_modulus",
        env_name: str | None = None,
        worker: int = 1,
        device: str | torch.device | None = None,
    ) -> None:
        super().__init__(root_dir, task)
        if task not in self.TASK_SCRIPTS:
            raise ValueError(f"{task} is an unknown task for the MLIP bridge")
        self.env_name = env_name
        self.worker = worker
        self.device = resolve_device(device)
        # the last worker's stderr (its backend line, any traceback)
        self.last_stderr = ""

    def calc(self, samples: Tuple[List[Structure], str | None], label: str = "tmp") -> np.ndarray:
        xyz_path = samples[1]
        if xyz_path is None:
            xyz_path = save_extxyz(samples[0], os.path.join(self.root_dir, f"{label}.extxyz"))
        xyz_path = os.path.abspath(xyz_path)
        out_path = os.path.abspath(os.path.join(self.root_dir, f"{label}.txt"))
        python = "python" if self.env_name else sys.executable
        cmd = (["conda", "run", "-n", self.env_name] if self.env_name else []) + [
            python, self.TASK_SCRIPTS[self.task], xyz_path, out_path, str(self.worker),
            "--device", str(self.device),
        ]
        # never accept a stale result file from a previous run with this label
        if os.path.exists(out_path):
            os.remove(out_path)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.last_stderr = proc.stderr
        for line in proc.stderr.splitlines():
            if line.startswith("[mlip/"):
                logging.info(line)
        if proc.returncode != 0 or not os.path.isfile(out_path):
            raise RuntimeError(
                f"MLIP worker failed (exit {proc.returncode}, output "
                f"{'present' if os.path.isfile(out_path) else 'missing'} at {out_path}): "
                f"{proc.stderr[-2000:]}"
            )
        results = np.atleast_1d(np.genfromtxt(out_path))
        if len(results) != len(samples[0]):
            raise RuntimeError(
                f"MLIP worker wrote {len(results)} results for {len(samples[0])} structures"
            )
        return results
