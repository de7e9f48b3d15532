"""Synthesizability score: a bagged MLP ensemble over composition embeddings
(``matinvent_tpu/rewards/calculators/syn_score.py``).

Each element has a 90-dim embedding; a composition's is the count-weighted
mean over its reduced formula. Each of the 100 bags is
``Linear(90->180) -> softplus -> Linear(180->2) -> softmax``, and the score
is the bags' mean probability of class 1. The whole ensemble is one batched
product on the calculator's device. Embeddings come from an
``element_emb.json`` when one is given, else from a deterministic fallback
descriptor; the ensemble from a stacked ``.npz`` (by default the
repository's ``matinvent_tpu/rewards/calculators/weights/syn_score.npz``,
read as data), a directory of ``.pth.tar`` bags, or a seeded random
initialization (``trained`` False).
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

from matinvent_tpu_torch.chem.data import (
    ATOMIC_WEIGHTS,
    ELECTRONEGATIVITY,
    OXIDATION_STATES,
    SYMBOLS,
)
from matinvent_tpu_torch.chem.structure import Structure
from matinvent_tpu_torch.device import resolve_device
from matinvent_tpu_torch.rewards.calculators.base import Calculator

EMB_DIM = 90
HID_DIM = 180
ROOT = Path(__file__).resolve().parents[3]
DEFAULT_MODEL_PATH = ROOT / "matinvent_tpu" / "rewards" / "calculators" / "weights" / "syn_score.npz"

# period boundaries: max Z of each period (H..Og)
_PERIOD_EDGES = (2, 10, 18, 36, 54, 86, 118)


def fallback_element_embedding(symbol: str) -> np.ndarray:
    """The deterministic 90-dim element descriptor used without an
    ``element_emb.json``: normalized scalars, an oxidation-state multi-hot
    (-5..+8) and its extremes, a period one-hot (29 dims), and a fixed
    projection of those, seeded by the atomic number, for the other 61."""
    z = SYMBOLS.index(symbol) if symbol in SYMBOLS else 0
    w = ATOMIC_WEIGHTS.get(symbol, np.nan)
    scalars = np.array(
        [
            z / 100.0,
            w / 250.0 if np.isfinite(w) else 0.0,
            ELECTRONEGATIVITY.get(symbol, 0.0) / 4.0,
            len(OXIDATION_STATES.get(symbol, [])) / 8.0,
        ]
    )
    ox = np.zeros(14)  # oxidation states -5..+8
    states = OXIDATION_STATES.get(symbol, ())
    for o in states:
        if -5 <= o <= 8:
            ox[o + 5] = 1.0
    ox_stats = np.array(
        [
            min(states) / 5.0 if states else 0.0,
            max(states) / 8.0 if states else 0.0,
            1.0 if any(o > 0 for o in states) else 0.0,
            1.0 if any(o < 0 for o in states) else 0.0,
        ]
    )
    period = np.zeros(7)
    for p, edge in enumerate(_PERIOD_EDGES):
        if z <= edge:
            period[p] = 1.0
            break
    out = np.zeros(EMB_DIM)
    feats = np.concatenate([scalars, ox, ox_stats, period])  # 29 dims
    out[: len(feats)] = feats
    rng = np.random.default_rng(z)
    proj = rng.standard_normal((EMB_DIM - len(feats), len(feats)))
    out[len(feats):] = (proj @ feats) / np.sqrt(len(feats))
    return out


def ensemble_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``x [B, 90]`` -> the mean over the bags of P(class 1) ``[B]``: one
    batched product per layer over all bags (``w1 [E,90,180]``, ``b1
    [E,180]``, ``w2 [E,180,2]``, ``b2 [E,2]``)."""
    h = torch.matmul(x[None], params["w1"]) + params["b1"][:, None, :]  # [E, B, 180]
    h = torch.logaddexp(h, torch.zeros((), dtype=h.dtype, device=h.device))  # softplus
    logits = torch.matmul(h, params["w2"]) + params["b2"][:, None, :]  # [E, B, 2]
    return torch.softmax(logits, dim=-1)[..., 1].mean(dim=0)


class SynScore(Calculator):
    def __init__(
        self,
        root_dir: str,
        task: str = "syn_score",
        emb_path: str | None = None,
        model_path: str | None = None,
        n_models: int = 100,
        seed: int = 0,
        device: str | torch.device | None = None,
    ) -> None:
        super().__init__(root_dir, task)
        self.n_models = n_models
        self.device = resolve_device(device)
        self._emb = self._load_embeddings(emb_path)
        # set by _load_ensemble when real weights load; the sample filter's
        # synthesizability screen refuses to gate on random-init scores
        self.trained = False
        params = self._load_ensemble(model_path, seed)
        self._params = {
            k: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=self.device)
            for k, v in params.items()
        }

    def _load_embeddings(self, emb_path: str | None) -> dict[str, np.ndarray]:
        if emb_path and os.path.exists(emb_path):
            with open(emb_path) as fh:
                raw = json.load(fh)
            return {k: np.asarray(v, dtype=np.float64) for k, v in raw.items()}
        return {s: fallback_element_embedding(s) for s in SYMBOLS[1:]}

    def comp_embedding(self, struc: Structure) -> np.ndarray:
        """Count-weighted mean element embedding over the reduced formula;
        NaN when an element has no embedding."""
        red = struc.composition.reduced_counts
        emb = np.zeros(EMB_DIM)
        num = 0.0
        for el, n in red.items():
            if el not in self._emb:
                return np.full(EMB_DIM, np.nan)
            emb += self._emb[el] * n
            num += n
        return emb / max(num, 1.0)

    def _load_ensemble(self, model_path: str | None, seed: int) -> dict[str, np.ndarray]:
        """Stacked numpy params: w1 [E,90,180] b1 [E,180] w2 [E,180,2] b2 [E,2]."""
        if model_path is None and DEFAULT_MODEL_PATH.is_file():
            model_path = str(DEFAULT_MODEL_PATH)
        if model_path and os.path.isdir(model_path):
            pths = sorted(f for f in os.listdir(model_path) if f.endswith(".pth.tar"))
            if pths:
                w1, b1, w2, b2 = [], [], [], []
                for f in pths[: self.n_models]:
                    sd = torch.load(
                        os.path.join(model_path, f), map_location="cpu", weights_only=False,
                    )["state_dict"]
                    w1.append(np.asarray(sd["cgnf_to_fc.weight"]).T)
                    b1.append(np.asarray(sd["cgnf_to_fc.bias"]))
                    w2.append(np.asarray(sd["fc_out.weight"]).T)
                    b2.append(np.asarray(sd["fc_out.bias"]))
                self.trained = True
                return {"w1": np.stack(w1), "b1": np.stack(b1), "w2": np.stack(w2),
                        "b2": np.stack(b2)}
        if model_path and os.path.isfile(model_path):
            with np.load(model_path) as data:
                self.trained = True
                return {k: data[k] for k in ("w1", "b1", "w2", "b2")}
        rng = np.random.default_rng(seed)
        E = self.n_models
        return {
            "w1": rng.standard_normal((E, EMB_DIM, HID_DIM)) * 0.05,
            "b1": np.zeros((E, HID_DIM)),
            "w2": rng.standard_normal((E, HID_DIM, 2)) * 0.05,
            "b2": np.zeros((E, 2)),
        }

    def calc(self, samples: Tuple[List[Structure], str], label: str = "tmp") -> np.ndarray:
        structures = samples[0]
        if not structures:
            return np.array([])
        embs = np.stack([self.comp_embedding(s) for s in structures])
        nan_mask = np.isnan(embs).any(axis=1)
        x = torch.as_tensor(np.nan_to_num(embs, nan=0.0), dtype=torch.float32, device=self.device)
        with torch.no_grad():
            scores = ensemble_forward(self._params, x).cpu().numpy().astype(float)
        scores[nan_mask] = np.nan
        self.save_results(scores, label)
        return scores
