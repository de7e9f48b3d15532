"""Elastic-tensor MLIP worker: bulk modulus (GPa) per structure
(``matinvent_tpu/rewards/calculators/mlip/elastic.py``).

    python elastic.py <in.extxyz> <out.txt> <n_workers> [--device cuda|cpu]

quacc ``elastic_tensor_flow`` (eSEN-30M-OAM) where quacc is importable,
else the native E(V)-curvature workflow
(``chem.phonon.soft_sphere_bulk_modulus`` on the soft-sphere potential).
Both scripts run ``worker.run``.
"""
from __future__ import annotations

import os
import sys


def bulk_task(atoms) -> float:
    """Voigt bulk modulus (GPa) of one ``ase.Atoms`` by quacc's MLIP
    elastic workflow. ``worker.run`` calls it per structure: NaN where the
    workflow fails on that structure, while a missing part of the MLIP
    stack (an ImportError) ends the worker."""
    from quacc.recipes.mlp.elastic import elastic_tensor_flow

    result = elastic_tensor_flow(
        atoms,
        job_params={"all": dict(method="fairchem", name_or_path="esen-30m-oam",
                                task_name="omat")},
    )
    return float(result["elasticity_doc"].bulk_modulus.voigt)

if __name__ == "__main__":
    # run as a script: its own checkout on the path
    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), *[".."] * 4)))
    from matinvent_tpu_torch.chem.phonon import soft_sphere_bulk_modulus
    from matinvent_tpu_torch.rewards.calculators.mlip.worker import run

    run(sys.argv[1:], "elastic", bulk_task, "quacc MLIP (eSEN-30M-OAM)",
        soft_sphere_bulk_modulus, "native soft-sphere E(V) fallback")
