"""Reward aggregator (``matinvent_tpu/rewards/reward.py``).

Per-property calculators -> NaN-to-zero properties and a failed mask ->
linear scaling to [0, 1] (ascending, descending or toward a float target)
-> mean, min or weighted-sum reduce -> reward 0 on failed samples.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from matinvent_tpu_torch.chem.structure import Structure


def linear_scaling(values: np.ndarray, minv: float = 0.0, maxv: float = 6.0) -> np.ndarray:
    ss = (values - minv) / (maxv - minv)
    return np.clip(ss, 0.0, 1.0)


class Reward:
    """Scores structures against property targets. Each entry of
    ``prop_cfg`` holds ``name``, ``calculator`` (a ``Calculator``),
    ``target`` ('ascending', 'descending' or a float), ``minv``, ``maxv``
    and, for ``reduce='weight'``, ``weight``."""

    def __init__(
        self,
        root_dir: str,
        prop_cfg: Sequence[Dict[str, Any]],
        reward_threshold: float,
        reduce: str = "mean",
    ) -> None:
        if reduce not in ("mean", "min", "weight"):
            raise ValueError(f"unknown reduce {reduce!r}")
        self.root_dir = root_dir
        self.prop_cfg = list(prop_cfg)
        self.threshold = reward_threshold
        self.reduce = reduce
        os.makedirs(self.root_dir, exist_ok=True)

    def calc_props(
        self, samples: Tuple[List[Structure], str], label: str = "tmp"
    ) -> tuple[Dict[str, np.ndarray], np.ndarray]:
        prop_dict, prop_list = {}, []
        for cfg in self.prop_cfg:
            raw = np.asarray(cfg["calculator"].calc(samples, label), dtype=float)
            prop_list.append(raw)
            prop_dict[cfg["name"]] = np.nan_to_num(raw, nan=0.0)
        failed_mask = np.isnan(np.array(prop_list)).any(axis=0)
        return prop_dict, failed_mask

    def scoring(
        self, samples: Tuple[List[Structure], str], label: str = "tmp"
    ) -> tuple[np.ndarray, Dict[str, np.ndarray], np.ndarray]:
        prop_dict, failed_mask = self.calc_props(samples, label)
        scaled: Dict[str, np.ndarray] = {}
        for cfg in self.prop_cfg:
            name, target = cfg["name"], cfg["target"]
            minv, maxv = float(cfg["minv"]), float(cfg["maxv"])
            if target == "ascending":
                s = linear_scaling(prop_dict[name], minv=minv, maxv=maxv)
            elif target == "descending":
                s = linear_scaling(-prop_dict[name], minv=-maxv, maxv=-minv)
            elif isinstance(target, (int, float)):
                diff = np.abs(prop_dict[name] - float(target))
                s = linear_scaling(-diff, minv=-maxv, maxv=-minv)
            else:
                raise TypeError(
                    "prop cfg target must be a float or 'descending' or 'ascending'"
                )
            scaled[name] = s

        if self.reduce == "mean":
            rewards = np.mean(np.array(list(scaled.values())), axis=0)
        elif self.reduce == "min":
            rewards = np.min(np.array(list(scaled.values())), axis=0)
        else:
            rewards = np.array(
                [scaled[cfg["name"]] * float(cfg.get("weight", 1.0)) for cfg in self.prop_cfg]
            ).sum(axis=0)
        rewards = np.asarray(rewards, dtype=float)
        rewards[failed_mask] = 0.0
        return rewards, prop_dict, failed_mask
