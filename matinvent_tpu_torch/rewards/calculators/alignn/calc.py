"""The ALIGNN reward calculator over published checkpoints, on the card
(``matinvent_tpu/rewards/calculators/alignn/calc.py``).

``ALIGNN`` subclasses the port's ``PropertyPredictor`` as JAX's does, so
the task surface and the derived tasks (Vickers hardness by Tian / Teter,
Pugh's ratio, Young's modulus, the figure of merit, the magnetic density's
``/0.84 * n / V``) are the same code; only the backbone differs. The
checkpoints are files already on disk under ``model_dir`` (or
``$ALIGNN_MODEL_DIR``), resolved per task at its first call, first match
wins:

  <model_dir>/prop_pred/alignn/<prop>/       (HF snapshot layout)
  <model_dir>/<prop>/ or <model_dir>/<task>/ (a folder with config.json)
  <model_dir>/<figshare_name>.zip            (figshare zip)
  <model_dir>/<prop>.zip

``ALIGNNModel.predict`` builds each chunk's graphs on the host
(``graphs.build_batch``) and runs the forward on the calculator's device.

One difference from JAX, by design: JAX turns any exception in a chunk
into NaN. The port gives NaN for what the structure screen rejects (a
non-finite or flat cell, no atoms, species outside 1..100) and for a chunk
whose host graph build fails (no ``max_neighbors`` neighbours after the
cutoff's widening, a cell too skewed for the image search's memory), as
JAX does; an error of the device forward (CUDA, out
of memory) raises, so that no fallback hides the card.
"""
from __future__ import annotations

import logging
import os
from typing import List

import numpy as np
import torch

from matinvent_tpu_torch.chem.structure import Structure
from matinvent_tpu_torch.device import resolve_device
from matinvent_tpu_torch.rewards.calculators.alignn.graphs import build_batch
from matinvent_tpu_torch.rewards.calculators.alignn.load import load_alignn_checkpoint
from matinvent_tpu_torch.rewards.calculators.alignn.model import run_batch
from matinvent_tpu_torch.rewards.calculators.base import Calculator
from matinvent_tpu_torch.rewards.calculators.predictor import TASK_MODEL_DICT, PropertyPredictor

# task -> (HF folder under prop_pred/alignn/, figshare zip basename)
TASK_CKPT_NAMES = {
    "band_gap": ("band_gap", "mp_gappbe_alignn"),
    "formation_energy": ("formation_energy", "mp_e_form_alignn"),
    "bulk_modulus": ("bulk_modulus_voigt", "jv_bulk_modulus_kv_alignn"),
    "shear_modulus": ("shear_modulus_voigt", "jv_shear_modulus_gv_alignn"),
    "magnetic_density": ("total_magnetization_per_atom", "jv_magmom_oszicar_alignn"),
    "total_dielectric_constant": ("total_dielectric_constant", "mp_dielectric"),
}


def usable(s: Structure) -> bool:
    """The structure screen: what the graph builder and forward can take."""
    return bool(
        np.isfinite(s.lattice).all()
        and np.isfinite(s.frac_coords).all()
        and s.num_atoms >= 1
        and s.volume > 1e-6
        and (s.species >= 1).all()
        and (s.species <= 100).all()
    )


class ALIGNNModel:
    """One loaded checkpoint on ``device``, with the ``predict(structures)``
    that ``PropertyPredictor``'s task dispatch calls."""

    def __init__(
        self,
        ckpt_path: str,
        atom_init: str | None = None,
        cutoff: float = 8.0,
        max_neighbors: int = 12,
        chunk_size: int = 16,
        pad_multiple: int = 512,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.params, self.spec, self.atom_table = load_alignn_checkpoint(
            ckpt_path, atom_init=atom_init, device=self.device
        )
        self.cutoff = cutoff
        self.max_neighbors = max_neighbors
        self.chunk_size = chunk_size
        self.pad_multiple = pad_multiple
        self.loaded = True

    def predict(self, structures: List[Structure]) -> np.ndarray:
        out = np.full(len(structures), np.nan)
        for lo in range(0, len(structures), self.chunk_size):
            chunk = structures[lo: lo + self.chunk_size]
            idx = [lo + i for i, s in enumerate(chunk) if usable(s)]
            if not idx:
                continue
            try:
                batch = build_batch([structures[i] for i in idx], self.cutoff,
                                    self.max_neighbors, self.pad_multiple)
            except Exception as exc:  # host numpy only: the card is not involved
                logging.warning(f"ALIGNN graph build failed ({exc}); NaN for the chunk")
                continue
            out[np.asarray(idx)] = run_batch(self.params, self.spec, self.atom_table, batch)
        return out


class ALIGNN(PropertyPredictor):
    """The ALIGNN calculator: published-checkpoint backbone on ``device``,
    ``PropertyPredictor``'s task dispatch."""

    def __init__(
        self,
        root_dir: str,
        task: str = "band_gap",
        model_dir: str | None = None,
        atom_init: str | None = None,
        cutoff: float = 8.0,
        max_neighbors: int = 12,
        chunk_size: int = 16,
        device: str | torch.device | None = None,
        **kwargs,
    ) -> None:
        # not PropertyPredictor's init: its default weights are not ALIGNN's
        Calculator.__init__(self, root_dir, task)
        if task not in TASK_MODEL_DICT:
            raise ValueError(f"{task} is an unknown task for ALIGNN calculator")
        # the checkpoints are resolved at the first call, as JAX's are: a
        # config instantiates without weights on disk
        self.model_dir = model_dir or os.environ.get("ALIGNN_MODEL_DIR")
        self.atom_init = atom_init
        self.device = resolve_device(device)
        self._alignn_kwargs = dict(atom_init=atom_init, cutoff=cutoff,
                                   max_neighbors=max_neighbors, chunk_size=chunk_size,
                                   device=self.device)
        self._models: dict[str, ALIGNNModel] = {}

    def _resolve(self, task: str) -> str:
        if not self.model_dir:
            raise FileNotFoundError(
                "ALIGNN calculator has no model_dir: point it (or "
                "$ALIGNN_MODEL_DIR) at downloaded checkpoints, an HF "
                "jwchen25/MatInvent snapshot or figshare zips. For "
                "network-free operation use PropertyPredictor instead."
            )
        hf_prop, figshare = TASK_CKPT_NAMES[task]
        candidates = [
            os.path.join(self.model_dir, "prop_pred", "alignn", hf_prop),
            os.path.join(self.model_dir, hf_prop),
            os.path.join(self.model_dir, task),
            os.path.join(self.model_dir, f"{figshare}.zip"),
            os.path.join(self.model_dir, f"{hf_prop}.zip"),
        ]
        for c in candidates:
            if (os.path.isdir(c) and os.path.exists(os.path.join(c, "config.json"))) or (
                c.endswith(".zip") and os.path.exists(c)
            ):
                return c
        raise FileNotFoundError(
            f"no ALIGNN checkpoint for task '{task}' under {self.model_dir} "
            f"(tried {candidates})"
        )

    def _model(self, task: str) -> ALIGNNModel:
        if task not in self._models:
            self._models[task] = ALIGNNModel(self._resolve(task), **self._alignn_kwargs)
        return self._models[task]
