"""GNN property predictors as reward calculators
(``matinvent_tpu/rewards/calculators/predictor.py``).

Each scalar property is one ``PropertyGNN``: a ``CSPNet`` (H=128, 4
layers, an embedding of the atomic number, layer norms, no time
conditioning) with a scalar head over the masked mean of its node features,
run on a batch padded to ``max_atoms`` on the calculator's device. Its
weights are the JAX package's flax checkpoints
(``<model_dir>/<model_name>.msgpack``: ``{"params": {"params": tree},
"y_mean", "y_std"}``), read with the port's msgpack decoder and carried into
the module by ``params_from_jax``; the output is de-standardized with
``y_mean``/``y_std``. The default ``model_dir`` is the repository's
``matinvent_tpu/rewards/calculators/weights/predictors/``, read as data.

``PropertyPredictor`` dispatches a task to its model and derives the four
composite tasks as the JAX package does: Vickers hardness (Tian's model,
Teter's below a 25 GPa bulk modulus), Pugh's ratio, Young's modulus and the
figure of merit (band gap x dielectric constant); it clamps the band gap at
0 and turns the per-atom moment into a magnetic density (``/0.84 * natoms /
volume``).
"""
from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

from matinvent_tpu_torch.chem.structure import Structure
from matinvent_tpu_torch.device import resolve_device
from matinvent_tpu_torch.models.batch import CrystalBatch
from matinvent_tpu_torch.models.cspnet import CSPNet
from matinvent_tpu_torch.models.suite.mattergen import params_from_jax, params_to_jax
from matinvent_tpu_torch.utils.msgpack import leaf_shapes, restore
from matinvent_tpu_torch.rewards.calculators.base import Calculator
from matinvent_tpu_torch.utils import msgpack

ROOT = Path(__file__).resolve().parents[3]
DEFAULT_MODEL_DIR = ROOT / "matinvent_tpu" / "rewards" / "calculators" / "weights" / "predictors"
LATENT_DIM = 8  # a zero time embedding: no time conditioning for regression

TASK_MODEL_DICT = {
    "band_gap": "mp_bandgap",
    "formation_energy": "mp_e_form",
    "bulk_modulus": "mp_bulk_modulus",
    "shear_modulus": "mp_shear_modulus",
    "magnetic_density": "mp_total_mag_per_atom",
    "total_dielectric_constant": "mp_dielectric",
    "vickers_hardness": "",
    "figure_of_merit": "",
    "pugh_ratio": "",
    "young_modulus": "",
}


def predictor_net(hidden_dim: int = 128, num_layers: int = 4) -> CSPNet:
    """The predictors' backbone (``PropertyGNN``'s ``CSPNet`` options)."""
    return CSPNet(
        hidden_dim=hidden_dim, latent_dim=LATENT_DIM, num_layers=num_layers,
        smooth=False, pred_type=False, pred_scalar=True, ln=True,
    )


class PropertyGNN:
    """One scalar-property model: the ``CSPNet`` backbone and scalar head,
    its weights from ``<model_dir>/<model_name>.msgpack`` when that file
    exists (``loaded``), else initialized from ``seed``."""

    def __init__(
        self,
        model_name: str,
        model_dir: str | os.PathLike | None = None,
        hidden_dim: int = 128,
        num_layers: int = 4,
        max_atoms: int = 32,
        seed: int = 0,
        device: str | torch.device | None = None,
    ):
        self.model_name = model_name
        self.max_atoms = max_atoms
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.net = predictor_net(hidden_dim, num_layers)
        # output standardization, stored in checkpoints trained on
        # standardized targets (experiments/train_predictor.py)
        self.y_mean = 0.0
        self.y_std = 1.0
        self.loaded = False
        if model_dir:
            path = os.path.join(model_dir, f"{model_name}.msgpack")
            if os.path.exists(path):
                self._load(path)
        self.net = self.net.to(self.device).eval()

    def template(self) -> dict:
        """This module's parameters as the flax tree ``{'params': ...}``."""
        sd = {k: v.detach().cpu().numpy() for k, v in self.net.state_dict().items()}
        return params_to_jax(sd, self.net, prefix="")

    def _load(self, path: str) -> None:
        with open(path, "rb") as fh:
            state = msgpack.unpackb(fh.read())
        template = self.template()
        try:
            ckpt = restore({"params": template, "y_mean": 0.0, "y_std": 1.0}, state)
            params, y_mean, y_std = ckpt["params"], float(ckpt["y_mean"]), float(ckpt["y_std"])
        except (ValueError, KeyError):  # legacy raw-params checkpoint
            params = restore(template, state)
            y_mean, y_std = 0.0, 1.0
        # the restore follows the tree only: check the leaf shapes, so a
        # checkpoint of another width cannot be loaded silently
        if leaf_shapes(template) == leaf_shapes(params):
            sd = params_from_jax(params, prefix="")
            self.net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
            self.y_mean, self.y_std = y_mean, y_std
            self.loaded = True
        else:
            logging.warning(
                f"predictor checkpoint {path} does not match this architecture "
                f"(hidden_dim/num_layers differ) — keeping random init"
            )

    def forward(self, batch: CrystalBatch) -> torch.Tensor:
        """Standardized predictions ``[B]`` of a batch on ``self.device``."""
        B = batch.batch_size
        out = self.net(
            torch.zeros((B, LATENT_DIM), device=batch.lattice.device),
            batch.atom_types, batch.frac_coords, batch.lattice, batch.num_atoms, batch.mask,
        )
        return out[:, 0]

    def batch(self, structures: List[Structure]) -> CrystalBatch:
        return CrystalBatch.from_lists(
            [s.species for s in structures],
            [s.frac_coords for s in structures],
            [s.lattice for s in structures],
            max_atoms=self.max_atoms,
        ).to(self.device)

    def predict(self, structures: List[Structure]) -> np.ndarray:
        """One value per structure in the label's units; NaN where the
        model cannot take it (over ``max_atoms`` atoms, a non-finite cell,
        species outside 1..100)."""
        ok = np.array([
            s.num_atoms <= self.max_atoms
            and np.isfinite(s.lattice).all()
            and (s.species >= 1).all()
            and (s.species <= 100).all()
            for s in structures
        ], dtype=bool)
        out = np.full(len(structures), np.nan)
        if ok.any():
            with torch.no_grad():
                vals = self.forward(self.batch([s for s, m in zip(structures, ok) if m]))
            vals = vals.cpu().numpy().astype(float)
            out[np.where(ok)[0]] = vals * self.y_std + self.y_mean
        return out


class PropertyPredictor(Calculator):
    """Task-dispatching reward calculator over ``PropertyGNN`` models, each
    built on first use and kept."""

    def __init__(
        self,
        root_dir: str,
        task: str = "band_gap",
        model_dir: str | os.PathLike | None = None,
        hidden_dim: int = 128,
        num_layers: int = 4,
        max_atoms: int = 32,
        device: str | torch.device | None = None,
        **kwargs,
    ) -> None:
        super().__init__(root_dir, task)
        if task not in TASK_MODEL_DICT:
            raise ValueError(f"{task} is an unknown task for PropertyPredictor")
        if model_dir is None:
            if not DEFAULT_MODEL_DIR.is_dir():
                raise FileNotFoundError(
                    f"the predictor weights directory {DEFAULT_MODEL_DIR} is missing: "
                    "pass model_dir, or model_dir='' for random weights"
                )
            model_dir = DEFAULT_MODEL_DIR
        self.model_dir = model_dir
        self.device = resolve_device(device)
        self._gnn_kwargs = dict(
            model_dir=model_dir, hidden_dim=hidden_dim, num_layers=num_layers,
            max_atoms=max_atoms, device=self.device,
        )
        self._models: dict[str, PropertyGNN] = {}

    def _model(self, task: str) -> PropertyGNN:
        name = TASK_MODEL_DICT[task]
        if name not in self._models:
            self._models[name] = PropertyGNN(name, **self._gnn_kwargs)
        return self._models[name]

    def calc(self, samples: Tuple[List[Structure], str], label: str = "tmp") -> np.ndarray:
        structures = samples[0]
        t = self.task

        if t == "vickers_hardness":
            bulk = self._model("bulk_modulus").predict(structures)
            bulk[bulk < 0.0] = 0.0
            shear = self._model("shear_modulus").predict(structures)
            shear[shear < 0.0] = 0.0
            with np.errstate(divide="ignore", invalid="ignore"):
                k = shear / bulk
                results = 0.92 * (k**1.137) * (shear**0.708)  # Tian's model
            results[bulk < 25.0] = 0.151 * shear[bulk < 25.0]  # Teter's model
            results[results < 0.0] = 0.0
            self.save_results(bulk, f"{label}_bulk")
            self.save_results(shear, f"{label}_shear")
        elif t == "pugh_ratio":
            bulk = self._model("bulk_modulus").predict(structures)
            bulk[bulk < 0.0] = 0.0
            shear = self._model("shear_modulus").predict(structures)
            shear[shear <= 0.0] = 0.01
            results = bulk / shear
            self.save_results(bulk, f"{label}_bulk")
            self.save_results(shear, f"{label}_shear")
        elif t == "young_modulus":
            bulk = self._model("bulk_modulus").predict(structures)
            bulk[bulk <= 0.0] = 0.01
            shear = self._model("shear_modulus").predict(structures)
            shear[shear <= 0.0] = 0.01
            results = 9 * bulk * shear / (3 * bulk + shear)
            self.save_results(bulk, f"{label}_bulk")
            self.save_results(shear, f"{label}_shear")
        elif t == "figure_of_merit":
            gap = self._model("band_gap").predict(structures)
            gap[gap < 0.0] = 0.0
            die = self._model("total_dielectric_constant").predict(structures)
            die[die < 0.0] = 0.0
            results = gap * die
            self.save_results(gap, f"{label}_gap")
            self.save_results(die, f"{label}_die")
        else:
            results = self._model(t).predict(structures)

        if t == "band_gap":
            results[results < 0.0] = 0.0

        if t == "magnetic_density":
            # per-atom moment -> density
            results = results / 0.84
            natom = np.array([s.num_atoms for s in structures], dtype=float)
            volumes = np.array([s.volume for s in structures], dtype=float)
            with np.errstate(divide="ignore", invalid="ignore"):
                results = results * natom / volumes
            results[results < 0.0] = 0.0

        self.save_results(results, label)
        return results
