"""The DFT reward calculator (``matinvent_tpu/rewards/calculators/dft/calc.py``),
host code.

``DFTCalc`` writes one CIF per structure under ``<root_dir>/<label>/``,
submits one remote scheduler job per structure through a thread pool of
``max_node`` workers (the jobs wait on the network and the queue, not on
the host), blocks until each result file appears and returns the values,
NaN for any job that failed, as the JAX package does. The job settings are
``config.yaml`` beside this module (or ``config_path``), read with the
port's YAML reader.
"""
from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np

from matinvent_tpu_torch.chem.structure import Structure
from matinvent_tpu_torch.rewards.calculators.base import Calculator
from matinvent_tpu_torch.rewards.calculators.dft.job import RemoteQueueJob, Transport
from matinvent_tpu_torch.utils.yaml_io import read_yaml


def dft_run(
    task: str,
    job_dir: str,
    cif_path: str,
    config_path: str,
    transport: Transport | None = None,
) -> float:
    """The remote job's value for one structure; NaN on any failure."""
    try:
        config = read_yaml(config_path)
        config["task"] = task
        config["dir"] = job_dir
        config["cif"] = cif_path
        config["config"] = config_path
        job = RemoteQueueJob.from_config(config, transport=transport)
        return float(job.submit_wait_read())
    except Exception as e:
        logging.debug(f"dft_run failed for {cif_path}: {e}")
        return float("nan")


class DFTCalc(Calculator):
    def __init__(
        self,
        root_dir: str,
        task: str = "band_gap",
        max_node: int = 8,
        config_path: str | None = None,
        transport: Transport | None = None,
    ) -> None:
        super().__init__(root_dir, task)
        self.max_node = max_node
        if config_path is None:
            from matinvent_tpu_torch.rewards.calculators.dft import DFT_CONFIG_PATH

            config_path = DFT_CONFIG_PATH
        self.config_path = os.path.abspath(config_path)
        self.transport = transport  # None: an SSHTransport per job, from the config

    def calc(self, samples: Tuple[List[Structure], str], label: str = "tmp") -> np.ndarray:
        struc_list = samples[0]
        cif_dir = os.path.join(self.root_dir, label)
        os.makedirs(cif_dir, exist_ok=True)

        param_list = []
        for i, struc in enumerate(struc_list):
            cif_path = os.path.abspath(os.path.join(cif_dir, f"{i}.cif"))
            with open(cif_path, "w") as fh:
                fh.write(struc.to_cif())
            job_dir = os.path.join(label, f"{i:0>2d}")
            param_list.append((self.task, job_dir, cif_path, self.config_path))

        with ThreadPoolExecutor(max_workers=self.max_node) as pool:
            results = list(pool.map(lambda p: dft_run(*p, transport=self.transport), param_list))

        results = np.array(results, dtype=float)
        self.save_results(results, label)
        return results
