"""Reward-tail density of the r4 pretrain corpus (``experiments/
reward_tail_density_r5.py`` of the JAX package), on the card: the
distribution of four benchmark rewards over ``corpus_r4``, each built from
``configs/reward/<name>.yaml`` as the RL runs build it.

    python -m matinvent_tpu_torch.experiments.reward_tail_density_r5 \\
        [rewards=hhi,magnetic_density,gap_bulk,heat_capacity] \\
        [out=runs/reward_tail_density_r5] [device=cpu]

hhi scores the whole corpus; the others a subsample of ``CONFIGS``' size,
drawn by one ``np.random.default_rng(0)`` in ``CONFIGS``' order as JAX's
script draws them (each draw advances the generator for the next reward,
so the draws are made for every reward whether or not ``rewards`` names
it). Failed structures are left out of the statistics. Each reward is
scored from a temporary working directory. ``<out>/reward_tail_density_r5.json``
has JAX's keys for the rewards scored.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

from matinvent_tpu_torch.chem.structure import read_extxyz
from matinvent_tpu_torch.experiments.validity_fix_r5 import ROOT
from matinvent_tpu_torch.main import CONFIG_DIR, pop_device
from matinvent_tpu_torch.utils.config import instantiate, load_config

CORPUS = os.path.join(ROOT, "experiments", "data", "corpus_r4.extxyz")
# reward config -> subsample size (None: the whole corpus)
CONFIGS = {
    "hhi": None,
    "magnetic_density": 4000,
    "gap_bulk": 4000,
    "heat_capacity": 400,
}


def subsample_indices(n: int) -> dict[str, np.ndarray | None]:
    """Each reward's corpus indices (None: all ``n``), in JAX's draw order."""
    rng = np.random.default_rng(0)
    return {name: rng.choice(n, sub, replace=False) if sub is not None and n > sub else None
            for name, sub in CONFIGS.items()}


def rewards_of(name: str, strucs, device=None) -> tuple[np.ndarray, np.ndarray, float]:
    """(rewards, failed mask, threshold) of the reward ``name`` of
    ``configs/`` on ``strucs``, scored from a temporary directory."""
    cfg = load_config(CONFIG_DIR, "base", overrides=[f"reward={name}"])
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as td:
        try:
            os.chdir(td)
            reward = instantiate(cfg["reward"], device, "reward")
            rewards, _, failed = reward.scoring((strucs, None), label=name)
        finally:
            os.chdir(cwd)
    return np.asarray(rewards, float), np.asarray(failed, bool), float(reward.threshold)


def score(name: str, strucs, device=None) -> dict:
    """The reward ``name``'s statistics over ``strucs``, failures left out."""
    t0 = time.time()
    rewards, failed, thr = rewards_of(name, strucs, device)
    r = rewards[~failed]
    return dict(
        n_scored=int(r.size),
        n_failed=int(len(strucs) - r.size),
        threshold=thr,
        frac_ge_0p8=round(float(np.mean(r >= 0.8)), 5),
        frac_ge_threshold=round(float(np.mean(r >= thr)), 5),
        mean=round(float(r.mean()), 4),
        percentiles={f"p{p}": round(float(np.percentile(r, p)), 4) for p in (50, 90, 99, 99.9)},
        seconds=round(time.time() - t0, 1),
    )


def main(argv: list[str] | None = None) -> dict:
    argv, device = pop_device(list(sys.argv[1:] if argv is None else argv))
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    out_dir = os.path.abspath(kv.get("out", os.path.join(ROOT, "runs", "reward_tail_density_r5")))
    names = kv.get("rewards", ",".join(CONFIGS)).split(",")
    corpus = read_extxyz(CORPUS)
    out = {"corpus": os.path.basename(CORPUS), "corpus_n": len(corpus)}
    for name, idx in subsample_indices(len(corpus)).items():
        if name not in names:
            continue
        strucs = corpus if idx is None else [corpus[i] for i in idx]
        out[name] = score(name, strucs, device)
        print(f"[tail] {name}: {json.dumps(out[name])}", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "reward_tail_density_r5.json"), "w") as fh:
        json.dump(out, fh, indent=2)
        fh.write("\n")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
