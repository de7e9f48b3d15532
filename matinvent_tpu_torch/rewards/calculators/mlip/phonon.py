"""Phonon MLIP worker: constant-volume heat capacity at 300 K per structure
(``matinvent_tpu/rewards/calculators/mlip/phonon.py``).

    python phonon.py <in.extxyz> <out.txt> <n_workers> [--device cuda|cpu]

quacc ``relax_job`` + ``phonon_flow`` (eSEN-30M-OAM) where quacc is
importable, else the native Γ-point workflow
(``chem.phonon.gamma_heat_capacity``: relax, supercell, mass-weighted
Hessian, Bose-Einstein C_v on the soft-sphere potential). Both scripts
run ``worker.run``.
"""
from __future__ import annotations

import os
import sys


def phonon_task(atoms) -> float:
    """Heat capacity (J/g/K) of one ``ase.Atoms`` by quacc's MLIP phonon
    workflow. ``worker.run`` calls it per structure: NaN where the
    workflow fails on that structure, while a missing part of the MLIP
    stack (an ImportError) ends the worker."""
    import numpy as np
    from quacc.recipes.mlp.core import relax_job
    from quacc.recipes.mlp.phonons import phonon_flow

    params = dict(method="fairchem", name_or_path="esen-30m-oam", task_name="omat")
    relaxed = relax_job(atoms, relax_cell=True, **params)
    flow = phonon_flow(
        relaxed["atoms"], job_params={"all": params},
        t_min=300.0, t_max=300.0, t_step=1.0,
    )
    tp = flow["results"]["thermal_properties"]
    idx = int(np.argmin(np.abs(np.array(tp["temperatures"]) - 300.0)))
    return float(tp["heat_capacity"][idx])

if __name__ == "__main__":
    # run as a script: its own checkout on the path
    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), *[".."] * 4)))
    from matinvent_tpu_torch.chem.phonon import gamma_heat_capacity
    from matinvent_tpu_torch.rewards.calculators.mlip.worker import run

    run(sys.argv[1:], "phonon", phonon_task, "quacc MLIP (eSEN-30M-OAM)",
        gamma_heat_capacity, "native soft-sphere Γ-phonon fallback")
