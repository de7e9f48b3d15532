"""Samplers' host side (``matinvent_tpu/models/sample.py``).

The num-atoms histograms of the training datasets (dataset statistics, not
code: probabilities indexed by atom count), the conversions between a padded
batch and host-side per-crystal dicts and ``Structure`` objects, and the
DiffCSP family's sampler.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Tuple

import numpy as np
import torch

from matinvent_tpu_torch.chem.structure import Structure
from matinvent_tpu_torch.models.batch import CrystalBatch

ATOM_DIST = {
    "perov_5": [0, 0, 0, 0, 0, 1],
    "carbon_24": [0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                  0.3250697750779839, 0.0, 0.27795107535708424, 0.0,
                  0.15383352487276308, 0.0, 0.11246100804465604, 0.0,
                  0.04958134953209654, 0.0, 0.038745690362830404, 0.0,
                  0.019044491873255624, 0.0, 0.010178952552946971, 0.0,
                  0.007059596125430964, 0.0, 0.006074536200952225],
    "mp_20": [0.0, 0.0021742334905660377, 0.021079009433962265,
              0.019826061320754717, 0.15271226415094338, 0.047132959905660375,
              0.08464770047169812, 0.021079009433962265, 0.07808814858490566,
              0.03434551886792453, 0.0972877358490566, 0.013303360849056603,
              0.09669811320754718, 0.02155807783018868, 0.06522700471698113,
              0.014372051886792452, 0.06703272405660378, 0.00972877358490566,
              0.053176591981132074, 0.010576356132075472, 0.08995430424528301],
    # derived from the largest in-repo corpus (experiments/data/
    # reference.extxyz, 2000 motif-based ionic structures)
    "matinvent_corpus": [0.0, 0.0, 0.5205, 0.2115, 0.268],
}

# the corrector's Langevin step size by task and dataset
DEFAULT_STEP_LR = {
    "csp": {"perov_5": 5e-7, "carbon_24": 5e-6, "mp_20": 1e-5, "mpts_52": 1e-5},
    "csp_multi": {"perov_5": 5e-7, "carbon_24": 5e-7, "mp_20": 1e-5, "mpts_52": 1e-5},
    "gen": {"perov_5": 1e-6, "carbon_24": 1e-5, "mp_20": 5e-6},
}


def sample_num_atoms(rng: np.random.Generator, total: int, dataset: str = "mp_20") -> np.ndarray:
    """``total`` atom counts drawn from the histogram ``dataset``."""
    dist = np.asarray(ATOM_DIST[dataset], dtype=float)
    dist = dist / dist.sum()
    return rng.choice(len(dist), size=total, p=dist).astype(np.int32)


def register_atom_dist(name: str, hist) -> None:
    """Register a num-atoms histogram (probabilities indexed by atom count)
    for both sampler families."""
    from matinvent_tpu_torch.models.mattergen.sample import register_num_atoms_distribution

    arr = np.asarray(hist, dtype=float)
    if arr.sum() <= 0:
        raise ValueError(f"histogram {name} has no mass")
    register_num_atoms_distribution(name, arr / arr.sum())


def atom_dist_from_structures(structures) -> np.ndarray:
    """Empirical num-atoms histogram (counts) of a structure list."""
    counts = np.array([s.num_atoms for s in structures], dtype=int)
    return np.bincount(counts, minlength=2).astype(float)


def batch_to_structures(batch: CrystalBatch) -> Tuple[List[dict], List[Structure]]:
    """Split a padded batch into host per-crystal dicts and Structures."""
    data_list = batch.to_lists()
    strucs = [Structure(d["lattice"], d["atom_types"], d["frac_coords"]) for d in data_list]
    return data_list, strucs


def collate_data_list(data_list: List[dict], max_atoms: int) -> CrystalBatch:
    """Host per-crystal dicts -> a padded (CPU) batch, for the fine-tune."""
    return CrystalBatch.from_lists(
        [d["atom_types"] for d in data_list],
        [d["frac_coords"] for d in data_list],
        [d["lattice"] for d in data_list],
        max_atoms=max_atoms,
    )


@dataclass
class DiffCSPSampler:
    """The DiffCSP family's sampler.

    ``launch`` samples all ``batch_size * num_batches`` crystals in one
    padded call, as the JAX package does: the reference's sampler keeps only
    its last loader batch (``sample.py:166-177`` there), a quirk that the JAX
    package fixed and the port does not restore; with ``num_batches`` 1, as
    every recipe sets it, the two agree."""

    batch_size: int | None = None
    num_batches: int | None = None
    num_atoms_distribution: str = "mp_20"
    # JSON file of {name: histogram} registered before the name is resolved
    num_atoms_distribution_file: str | None = None
    max_atoms: int = 20
    step_lr: float | None = None
    record_trajectories: bool = False
    seed: int = 0
    # the last recorded trajectory ([T, B, ...] tensors) and its num-atoms
    last_trajectory: Any = None
    last_num_atoms: Any = None
    _generator: torch.Generator | None = field(default=None, init=False, repr=False)

    def __post_init__(self):
        if self.num_atoms_distribution_file:
            from matinvent_tpu_torch.models.mattergen.sample import load_num_atoms_distributions

            load_num_atoms_distributions(self.num_atoms_distribution_file)
        if self.num_atoms_distribution not in ATOM_DIST:
            raise ValueError(
                f"num_atoms_distribution must be one of {list(ATOM_DIST)}, "
                f"got {self.num_atoms_distribution!r}"
            )
        self._rng = np.random.default_rng(self.seed)

    def resolved_step_lr(self) -> float:
        if self.step_lr is not None:
            return float(self.step_lr)
        return DEFAULT_STEP_LR["gen"].get(self.num_atoms_distribution, 5e-6)

    def _generator_for(self, device: torch.device) -> torch.Generator:
        # one stream per sampler, continued across launches
        if self._generator is None:
            self._generator = torch.Generator(device=device).manual_seed(self.seed)
        return self._generator

    def launch(self, model, batch_size: int | None = None,
               num_batches: int | None = None) -> CrystalBatch:
        """Sample ``batch_size * num_batches`` crystals on the model's device,
        recording the trajectory with ``record_trajectories``."""
        batch_size = batch_size or self.batch_size
        num_batches = num_batches or self.num_batches
        if batch_size is None or num_batches is None:
            raise ValueError("batch_size and num_batches are required")
        total = batch_size * num_batches
        num_atoms = sample_num_atoms(self._rng, total, self.num_atoms_distribution)
        # histograms may reach past max_atoms (carbon_24 reaches 24)
        num_atoms = np.clip(num_atoms, 1, self.max_atoms)
        device = model.device
        num_atoms_dev = torch.as_tensor(num_atoms, device=device)
        final, traj = model.sample(
            self._generator_for(device), num_atoms_dev, max_atoms=self.max_atoms,
            step_lr=self.resolved_step_lr(), record_traj=self.record_trajectories,
        )
        if self.record_trajectories:
            self.last_trajectory = traj
            self.last_num_atoms = num_atoms_dev
        return final

    def generate(self, model, **kwargs) -> Tuple[List[dict], List[Structure]]:
        return batch_to_structures(self.launch(model, **kwargs))
