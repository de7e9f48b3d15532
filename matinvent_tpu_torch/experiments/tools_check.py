"""The tools' full-size runs on the card, held against the JAX records.

    python -m matinvent_tpu_torch.experiments.tools_check --out DIR [--parts distill,ceiling]

``distill``: ``tools.distill_mattergen`` at the archived run's settings
(``teacher=demo``, 4,000 steps, batch 64, h128/L4, T=100, cap 8, seed 0),
its output under ``DIR/distilled_mattergen``. Against
``experiments/results/distilled_mattergen/distill_summary.json``: the two
runs draw from different generators, so the gate is the order of
magnitude: each held-out student MSE within 3x of JAX's, and at least 100x
below its untrained baseline, as JAX's is. The sampled statistics are
reported beside JAX's, not gated.

``ceiling``: ``tools.reward_ceiling``'s scoring of the whole design space
for ``magnetic_density``, ``gap_bulk`` and ``heat_capacity`` (its 300-design
pick), each reward's wall time and designs per second; the predictor
rewards' scoring once more under ``torch.profiler`` for the device's busy
time (the host's share is one minus busy over wall). Against
``experiments/results/reward_ceilings.json`` (equal to a rerun of the JAX
tool on the CPU): ``n_scored``, ``n_valid``, the best designs, ``max``,
``p99``, ``p95`` and both fractions equal as rounded there. Heat capacity
design by design against ``reward_ceiling_heat_jax.json``
(``phonon_check.heat_against_jax``: each design equal within 1e-3, or a
named flip with the measurement that names it, and the port's spectrum at
JAX's equilibrated cells within 1e-3 of JAX's on every design); its
summary against JAX's as it is, and once more with JAX's values on the
named flips only (the designs beyond 1e-3 that a flip explains).

Prints one JSON record (the card's name and power limit included) and
writes it to ``DIR/tools_check.json``; exits non-zero when a gate fails.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from matinvent_tpu_torch.experiments.phonon_check import HEAT_RECORD, heat_against_jax
from matinvent_tpu_torch.experiments.rl_profile import _profiled
from matinvent_tpu_torch.experiments.timing import card
from matinvent_tpu_torch.rewards.reward import Reward
from matinvent_tpu_torch.tools import distill_mattergen, reward_ceiling

ROOT = Path(__file__).resolve().parents[2]
DISTILL_RECORD = ROOT / "experiments/results/distilled_mattergen/distill_summary.json"
CEILING_RECORD = ROOT / "experiments/results/reward_ceilings.json"
DISTILL_ARGS = ["teacher=demo", "steps=4000", "batch=64", "hidden=128", "layers=4",
                "timesteps=100", "max_atoms=8", "seed=0"]
FIELDS = ("cell", "pos", "type_kl")
EXACT = ("n_scored", "n_valid", "best_design", "best_valid_design", "max", "p99", "p95",
         "frac_above_threshold", "frac_valid_above_threshold")


def run_distill(out: Path) -> dict:
    timed: dict = {}
    train = distill_mattergen.distill

    def timed_train(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = train(*args, **kwargs)
        torch.cuda.synchronize()
        timed["seconds"] = time.perf_counter() - t
        return result

    distill_mattergen.distill = timed_train
    try:
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        summary = distill_mattergen.main(DISTILL_ARGS + [
            "corpus=experiments/results/dataset.extxyz", f"out={out / 'distilled_mattergen'}"])
        seconds = time.perf_counter() - t
    finally:
        distill_mattergen.distill = train
    ref = json.loads(DISTILL_RECORD.read_text())
    ours_m, ref_m = summary["heldout_match"], ref["heldout_match"]
    gates = {}
    for f in FIELDS:
        s, b = ours_m["student_mse"][f], ours_m["untrained_baseline_mse"][f]
        js = ref_m["student_mse"][f]
        gates[f] = dict(student=s, jax_student=js, ratio_to_jax=s / js, baseline=b,
                        jax_baseline=ref_m["untrained_baseline_mse"][f],
                        baseline_over_student=b / s if s else math.inf,
                        ok=s <= 3 * js and b >= 100 * s)
    return dict(summary=summary, jax_sampled_statistics=ref["sampled_statistics"],
                jax_relative_mse=ref_m["relative_mse"], gates=gates,
                ms_per_step=1e3 * timed["seconds"] / summary["steps"], train_seconds=timed["seconds"],
                seconds=seconds, peak_memory_bytes=torch.cuda.max_memory_allocated(),
                ok=all(g["ok"] for g in gates.values()))


def heat_against_pick(structures, meta, seen, summary: dict, ref: dict) -> dict:
    """The 300 heat capacities against JAX's (``heat_against_jax``), and
    the summary with JAX's rewards on the named flips: the designs beyond
    1e-3 of JAX's whose kind is a flip (floor modes, scale search, JAX's
    nudges). Where the port agrees within 1e-3 its own value stands."""
    pick = reward_ceiling.heat_capacity_pick(structures)
    (_, (rewards, props, failed)), = seen
    picked = [structures[i] for i in pick]
    against = heat_against_jax(picked, props["heat_capacity"], range(len(pick)), "cuda")
    heat_ref = json.loads(HEAT_RECORD.read_text())
    flipped = np.array([r["kind"] not in ("equal", "differs") for r in against["designs"]])
    mixed = np.where(flipped, np.asarray(heat_ref["rewards"], float), np.asarray(rewards, float))
    again = reward_ceiling.summarize("heat_capacity", summary["threshold"], mixed, props, failed,
                                     reward_ceiling.valid_mask(picked), [meta[i] for i in pick])
    # how far the port lies from JAX, beside how far JAX's own nudges move it
    jax = np.asarray(heat_ref["heat_capacity"], float)
    nudge = np.max(np.abs(np.asarray(heat_ref["heat_capacity_nudged"], float) - jax), axis=0)
    gaps = np.array([r.get("gap", np.nan) for r in against["designs"]])
    spread = {name: dict(zip(("median", "p90", "p99"), np.nanquantile(g, [0.5, 0.9, 0.99]).tolist()),
                         beyond=int(np.sum(g > 1e-3)))
              for name, g in (("port_against_jax", gaps), ("jax_nudged", nudge / np.abs(jax)))}
    return dict(designs_against_jax=against, named_flips=int(flipped.sum()), relative_gaps=spread,
                summary_with_named_flips=again,
                mismatch_against_jax_with_named_flips={
                    k: (again[k], ref[k]) for k in EXACT if again[k] != ref[k]})


def run_ceiling(work: Path) -> dict:
    structures, meta = reward_ceiling.design_space()
    ref = json.loads(CEILING_RECORD.read_text())
    seen: list = []
    scoring = Reward.scoring

    def recording(self, *args, **kwargs):
        out = scoring(self, *args, **kwargs)
        seen.append((self, out))
        return out

    results = {}
    Reward.scoring = recording
    try:
        for name in ("magnetic_density", "gap_bulk", "heat_capacity"):
            seen.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            summary = reward_ceiling.score_reward(name, structures, meta, str(work / name))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            n = summary["n_scored"] if name == "heat_capacity" else len(structures)
            mismatch = {k: (summary[k], ref[name][k]) for k in EXACT if summary[k] != ref[name][k]}
            rec = dict(summary=summary, seconds=wall, designs_per_second=n / wall,
                       mismatch_against_jax=mismatch)
            if name == "heat_capacity":
                rec.update(heat_against_pick(structures, meta, seen, summary, ref[name]))
            results[name] = rec
    finally:
        Reward.scoring = scoring
    # the predictor rewards once more under the profiler: the device's busy share
    cwd = os.getcwd()
    for name in ("magnetic_density", "gap_bulk"):
        os.chdir(work / name)
        try:
            reward, _ = reward_ceiling.build_reward(name)
            prof = _profiled(lambda: reward_ceiling.score_all(reward, structures, f"profiled_{name}"),
                             len(structures))
        finally:
            os.chdir(cwd)
        results[name]["profile"] = dict(
            wall_ms_per_design=prof["wall_ms"], device_ms_per_design=prof["device_ms"],
            host_share=prof["idle_share"], kernels_per_design=prof["kernel_launches"],
            top=prof["top"][:5])
    heat = results["heat_capacity"]
    results["ok"] = (all(not results[n]["mismatch_against_jax"]
                         for n in ("magnetic_density", "gap_bulk"))
                     and heat["designs_against_jax"]["ok"]
                     and not heat["mismatch_against_jax_with_named_flips"])
    return results


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="runs/tools_check")
    ap.add_argument("--parts", default="distill,ceiling")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("tools_check measures the card: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    rec: dict = dict(experiment="tools_check", device=card())
    parts = args.parts.split(",")
    if "distill" in parts:
        rec["distill"] = run_distill(out)
        print(json.dumps({"distill": rec["distill"]}), flush=True)
    if "ceiling" in parts:
        with tempfile.TemporaryDirectory(prefix="tools_check_ceiling_") as work:
            rec["ceiling"] = run_ceiling(Path(work))
    (out / "tools_check.json").write_text(json.dumps(rec, indent=1) + "\n")
    print(json.dumps(rec), flush=True)
    return 0 if all(rec[p]["ok"] for p in parts) else 1


if __name__ == "__main__":
    sys.exit(main())
