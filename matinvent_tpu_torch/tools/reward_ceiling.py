"""The reachable reward ceiling of the predictor and MLIP rewards
(``tools/reward_ceiling.py`` of the JAX package), on the card.

Enumerates the design space the corpus generator spans (every motif x
cation x anion x lattice scale of ``chem/motifs.py``: 21,840 structures)
and scores it through the real reward path: the ``Reward`` that
``configs/reward/<name>.yaml`` instantiates, its ``_target_``s mapped to
the port as the entry point maps them, with the predictors (their weights
read from ``matinvent_tpu/rewards/calculators/weights/``, as data) and the
MLIP bridge's worker on the device. Heat capacity scores 300 structures:
the 200 with the highest Dulong-Petit bound and 100 spread over the rest.

Reports, per reward: the max, p99 and p95 reward, the fraction above the
configured threshold and the best design, over every scored structure and
over the valid ones (charge-balanced and structurally sane, as the RL
loop's ``invalid_filter`` screens them).

    python -m matinvent_tpu_torch.tools.reward_ceiling \\
        [rewards=magnetic_density,gap_bulk,heat_capacity] \\
        [out=matinvent_tpu_torch/experiments/results/reward_ceilings.json] [device=cpu]
"""
from __future__ import annotations

import json
import logging
import os
import sys
import tempfile

import numpy as np

from matinvent_tpu_torch.chem.data import ATOMIC_WEIGHTS, SYMBOLS
from matinvent_tpu_torch.chem.motifs import MOTIFS, anion_pool, cation_pool
from matinvent_tpu_torch.chem.relax import COVALENT_RADII
from matinvent_tpu_torch.chem.structure import Structure
from matinvent_tpu_torch.chem.validity import smact_valid, structure_validity
from matinvent_tpu_torch.device import resolve_device
from matinvent_tpu_torch.main import CONFIG_DIR, pop_device
from matinvent_tpu_torch.pipeline.logger import setup_logging
from matinvent_tpu_torch.utils.config import instantiate, load_config

DEFAULT_OUT = "matinvent_tpu_torch/experiments/results/reward_ceilings.json"
SCALES = (1.6, 1.8, 2.0, 2.2, 2.4)
# scored in fixed-size chunks (the tail padded by repetition, trimmed after)
CHUNK = 2048


def design_space() -> tuple[list[Structure], list[dict]]:
    """Every (motif, cation, anion, scale) the corpus generator can emit."""
    structures, meta = [], []
    for mname, (coords, (n_cat, n_an)) in MOTIFS.items():
        for cat in cation_pool():
            for an in anion_pool():
                species = [cat] * n_cat + [an] * n_an
                r = COVALENT_RADII[cat] + COVALENT_RADII[an]
                for scale in SCALES:
                    a = float(r * scale)
                    structures.append(Structure.from_parameters([a] * 3, [90] * 3, species, coords))
                    meta.append(dict(motif=mname, cation=SYMBOLS[cat], anion=SYMBOLS[an],
                                     a=round(a, 3)))
    return structures, meta


def dulong_petit_cv(structures: list[Structure]) -> np.ndarray:
    """Analytic upper bound on C_v per gram (3R per mole of atoms)."""
    out = []
    for s in structures:
        masses = [ATOMIC_WEIGHTS.get(SYMBOLS[z], np.nan) for z in s.species]
        out.append(24.943 / np.mean(masses))
    return np.array(out)


def heat_capacity_pick(structures: list[Structure]) -> np.ndarray:
    """Indices of the 200 highest Dulong-Petit bounds and 100 spread over
    the rest: the Gamma-phonon workflow takes seconds per structure."""
    order = np.argsort(-dulong_petit_cv(structures))
    return np.concatenate([order[:200], order[200:: max(len(order) // 100, 1)][:100]])


def build_reward(name: str, device=None):
    """(``configs/reward/<name>.yaml``'s reward on ``device``, its threshold)."""
    cfg = load_config(CONFIG_DIR, "base", overrides=[f"reward={name}"])
    return instantiate(cfg["reward"], device, "reward"), float(cfg["reward"].get("reward_threshold", 0.8))


def score_all(reward, structures: list[Structure], label: str = "ceiling"):
    """(rewards, properties, failed) of ``structures`` in ``CHUNK``-sized calls."""
    rewards_l, props_l, failed_l = [], [], []
    for i in range(0, len(structures), CHUNK):
        chunk = structures[i: i + CHUNK]
        n = len(chunk)
        if n < CHUNK and len(structures) > CHUNK:
            chunk = chunk + structures[: CHUNK - n]
        r, p, f = reward.scoring((chunk, None), f"{label}_{i}")
        rewards_l.append(np.asarray(r)[:n])
        failed_l.append(np.asarray(f)[:n])
        props_l.append({k: np.asarray(v)[:n] for k, v in p.items()})
        logging.info(f"[ceiling] {label}: {min(i + CHUNK, len(structures))}/{len(structures)}")
    props = {k: np.concatenate([pl[k] for pl in props_l]) for k in props_l[0]}
    return np.concatenate(rewards_l), props, np.concatenate(failed_l)


def valid_mask(structures: list[Structure]) -> np.ndarray:
    return np.array([smact_valid(s) and structure_validity(s) for s in structures])


def summarize(name: str, threshold: float, rewards, props: dict, failed, valid, meta) -> dict:
    """The JAX tool's summary of one reward's scores."""
    rewards = np.asarray(rewards, dtype=float)
    ok = ~np.asarray(failed)
    r = rewards[ok]
    best = int(np.argmax(rewards))
    rv = rewards[ok & valid]
    best_v = int(np.argmax(np.where(valid, rewards, -np.inf))) if valid.any() else best
    return dict(
        reward=name,
        threshold=threshold,
        n_scored=int(ok.sum()),
        # all failed (e.g. missing predictor weights): null statistics
        max=round(float(r.max()), 4) if r.size else None,
        p99=round(float(np.quantile(r, 0.99)), 4) if r.size else None,
        p95=round(float(np.quantile(r, 0.95)), 4) if r.size else None,
        frac_above_threshold=round(float((r >= threshold).mean()), 5) if r.size else None,
        best_design={**meta[best], "reward": round(float(rewards[best]), 4)},
        best_props={k: round(float(np.asarray(v)[best]), 5) for k, v in props.items()},
        # the validity-screened tier
        n_valid=int((ok & valid).sum()),
        max_valid=round(float(rv.max()), 4) if rv.size else None,
        frac_valid_above_threshold=(
            round(float((rv >= threshold).mean()), 5) if rv.size else None
        ),
        best_valid_design=(
            {**meta[best_v], "reward": round(float(rewards[best_v]), 4)} if valid.any() else None
        ),
    )


def score_reward(name: str, structures, meta, workdir: str, device=None) -> dict:
    """The summary of reward ``name`` over ``structures`` (heat capacity:
    over its pick); the calculators make their files under ``workdir``."""
    cwd = os.getcwd()
    os.makedirs(workdir, exist_ok=True)
    # calculators create their root_dir relative to cwd at instantiation
    os.chdir(workdir)
    try:
        reward, threshold = build_reward(name, device)
        if name == "heat_capacity":
            pick = heat_capacity_pick(structures)
            structures = [structures[i] for i in pick]
            meta = [meta[i] for i in pick]
        rewards, props, failed = score_all(reward, structures, f"ceiling_{name}")
    finally:
        os.chdir(cwd)
    return summarize(name, threshold, rewards, props, failed, valid_mask(structures), meta)


def main(argv: list[str] | None = None) -> dict:
    argv, device = pop_device(list(sys.argv[1:] if argv is None else argv))
    device = resolve_device(device)
    setup_logging()
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    names = kv.get("rewards", "magnetic_density,gap_bulk,heat_capacity").split(",")
    out_path = os.path.abspath(kv.get("out", DEFAULT_OUT))

    structures, meta = design_space()
    logging.info(f"[ceiling] design space: {len(structures)} structures")
    results = {}
    for name in names:
        results[name] = score_reward(
            name, structures, meta, os.path.join(tempfile.gettempdir(), f"ceiling_{name}"), device)
        logging.info("[ceiling] " + json.dumps(results[name]))

    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(results, fh, indent=2)
        fh.write("\n")
    logging.info(f"[ceiling] wrote {out_path}")
    return results


if __name__ == "__main__":
    main()
