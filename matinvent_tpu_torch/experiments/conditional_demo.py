"""Density-conditioned generation with classifier-free guidance
(``experiments/conditional_demo.py`` of the JAX package), on the card.

    python -m matinvent_tpu_torch.experiments.conditional_demo \\
        [out=runs/conditional_demo] [steps=20000] [timesteps=1000] \\
        [ckpt=experiments/results/pretrained_conditional_v2] [device=cpu]

Reads (or writes, the JAX tool's file) ``<out>/dataset_conditional.extxyz``
(the demo corpus, n=800, seed 1), standardizes the density condition to
the corpus' mean and spread, and loads the conditional h128/L4 MatterGen
of ``ckpt`` (the in-repository checkpoint by default; where it has no
``params.msgpack`` the net is pretrained for ``steps`` steps with
classifier-free condition dropout and saved to
``<out>/pretrained_conditional_v2``). It registers the corpus' atom-count
histogram and samples 128 crystals (seed 7) at the corpus' 15% and 85%
density quantiles and guidance factors 0, 0.5, 1 and 2, then writes
``conditional_demo_summary.json`` with JAX's keys: each row's sampled
density mean, spread and count (finite densities below 50), and the worst
relative error of each factor over the two targets, whose smallest is the
recommended factor (``summarize``).
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from matinvent_tpu_torch.chem.structure import read_extxyz
from matinvent_tpu_torch.experiments import rl_demo
from matinvent_tpu_torch.main import pop_device
from matinvent_tpu_torch.models.batch import CrystalBatch
from matinvent_tpu_torch.models.mattergen.sample import (
    MatterGenSampler,
    register_num_atoms_distribution,
)
from matinvent_tpu_torch.models.sample import batch_to_structures
from matinvent_tpu_torch.models.suite.mattergen import MatterGenSuite, load_weights
from matinvent_tpu_torch.parallel.pretrain import PretrainTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MAX_ATOMS = 8
GAMMAS = (0.0, 0.5, 1.0, 2.0)


def conditional_batches(structures, batch_size, max_atoms, rng):
    """``structures_to_batches`` with each structure's density attached:
    ``(CrystalBatch, {"density": [B]})``, JAX's batches for the same
    generator."""
    usable = [s for s in structures if 1 <= s.num_atoms <= max_atoms]
    n = len(usable)
    dens = np.array([s.density for s in usable], dtype=np.float32)
    while True:
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = order[i : i + batch_size]
            chunk = [usable[j] for j in idx]
            batch = CrystalBatch.from_lists(
                [s.species for s in chunk],
                [s.frac_coords for s in chunk],
                [s.lattice for s in chunk],
                max_atoms=max_atoms,
            )
            yield batch, {"density": dens[idx]}


def corpus(out_dir: str) -> tuple[list, np.ndarray]:
    """The conditional demo corpus (written where absent) and its
    densities."""
    path = os.path.join(out_dir, "dataset_conditional.extxyz")
    if not os.path.exists(path):
        os.makedirs(out_dir, exist_ok=True)
        rl_demo.make_dataset(path, n=800, seed=1)
    structures = read_extxyz(path)
    return structures, np.array([s.density for s in structures])


def density_targets(dens: np.ndarray) -> tuple[float, float]:
    return float(np.quantile(dens, 0.15)), float(np.quantile(dens, 0.85))


def conditional_model(ckpt_dir: str, cond_stats, timesteps: int, structures=None,
                      steps: int = 20000, cond_dropout: float = 0.1, save_dir: str | None = None,
                      device=None, log_every: int | None = None):
    """The conditional h128/L4 net: ``ckpt_dir``'s weights where it has a
    ``params.msgpack``, else pretrained on ``structures`` (batch 256, lr
    1.5e-3, ``cond_dropout``) and saved to ``save_dir``."""
    suite = MatterGenSuite(
        model_cfg=dict(hidden_dim=128, num_layers=4, time_dim=128, timesteps=timesteps,
                       condition_fields=("density",), condition_stats=cond_stats),
        sample_cfg={"max_atoms": MAX_ATOMS}, device=device,
    )
    model = suite.load_model()
    if os.path.exists(os.path.join(ckpt_dir, "params.msgpack")):
        load_weights(model, ckpt_dir)
        return model.eval()
    batches = conditional_batches(structures, 256, MAX_ATOMS, np.random.default_rng(0))
    trainer = PretrainTrainer(model, lr=1.5e-3, total_steps=steps, cond_dropout=cond_dropout)
    weights, _ = trainer.train(batches, steps, torch.Generator(device=model.device).manual_seed(0),
                               log_every=log_every or max(steps // 10, 1))
    model.load_state_dict(weights)
    suite.save_model(model, save_dir)
    return model.eval()


def register_corpus_histogram(name: str, structures) -> None:
    hist = np.bincount([s.num_atoms for s in structures], minlength=MAX_ATOMS + 1)
    register_num_atoms_distribution(name, hist.astype(float))


def sampled_densities(model, target: float, guidance: float, hist_name: str,
                      batch_size: int = 128, seed: int = 7) -> np.ndarray:
    """Densities of ``batch_size`` crystals sampled at ``target`` with
    ``guidance``, the finite ones below 50 g/cm^3."""
    sampler = MatterGenSampler(
        batch_size=batch_size, num_batches=1, max_atoms=MAX_ATOMS,
        num_atoms_distribution=hist_name, seed=seed,
        properties_to_condition_on={"density": float(target)},
        diffusion_guidance_factor=guidance,
    )
    _, strucs = batch_to_structures(sampler.launch(model))
    got = np.array([s.density for s in strucs])
    return got[np.isfinite(got) & (got < 50)]


def row(target: float, guidance: float, got: np.ndarray) -> dict:
    return dict(
        target=round(float(target), 3),
        guidance=guidance,
        sampled_density_mean=round(float(got.mean()), 3) if got.size else None,
        sampled_density_std=round(float(got.std()), 3) if got.size else None,
        n=int(got.size),
    )


def summarize(results: list[dict], dens: np.ndarray, cond_stats) -> dict:
    """JAX's summary: the worst relative error of each guidance factor over
    the two targets (factors with both rows), the factor that minimizes it,
    and the rows."""
    lo, hi = density_targets(dens)
    by_gamma: dict = {}
    for r in results:
        if r["sampled_density_mean"] is None:
            continue
        err = abs(r["sampled_density_mean"] - r["target"]) / max(r["target"], 1e-9)
        by_gamma.setdefault(r["guidance"], []).append(err)
    gamma_worst = {g: max(v) for g, v in by_gamma.items() if len(v) == 2}
    return dict(
        corpus_density_mean=round(float(dens.mean()), 3),
        targets=dict(low=round(lo, 3), high=round(hi, 3)),
        condition_stats=[list(e) for e in cond_stats],
        recommended_guidance=min(gamma_worst, key=gamma_worst.get) if gamma_worst else None,
        worst_rel_error_by_guidance={str(g): round(e, 4) for g, e in gamma_worst.items()},
        results=results,
    )


def main(argv: list[str] | None = None) -> dict:
    argv, device = pop_device(list(sys.argv[1:] if argv is None else argv))
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    steps = int(kv.get("steps", 20000))
    out_dir = os.path.abspath(kv.get("out", "runs/conditional_demo"))
    os.makedirs(out_dir, exist_ok=True)
    structures, dens = corpus(out_dir)
    print(f"[cond] corpus density: mean {dens.mean():.2f} std {dens.std():.2f} "
          f"range [{dens.min():.2f}, {dens.max():.2f}]", flush=True)
    cond_stats = (("density", float(dens.mean()), float(dens.std())),)
    ckpt = kv.get("ckpt", os.path.join(ROOT, "experiments/results/pretrained_conditional_v2"))
    model = conditional_model(
        os.path.abspath(ckpt), cond_stats, int(kv.get("timesteps", 1000)), structures, steps,
        save_dir=os.path.join(out_dir, "pretrained_conditional_v2"), device=device)
    register_corpus_histogram("cond_corpus", structures)

    results = []
    for target in density_targets(dens):
        for guidance in GAMMAS:
            results.append(row(target, guidance,
                               sampled_densities(model, target, guidance, "cond_corpus")))
            print(f"[cond] {results[-1]}", flush=True)
    summary = summarize(results, dens, cond_stats)
    with open(os.path.join(out_dir, "conditional_demo_summary.json"), "w") as fh:
        json.dump(summary, fh, indent=2)
        fh.write("\n")
    print("[cond] " + json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
