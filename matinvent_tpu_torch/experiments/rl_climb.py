"""A recipe's climb through the port's entry point, split across a resume.

    python -m matinvent_tpu_torch.experiments.rl_climb [--recipe rl_hhi_rich5] \
        [--iterations 60] [--split 30]

Runs two processes on one output directory (``--out``, default
``runs/<recipe>_climb``): the entry point with ``--rl-epoch SPLIT``, which
saves its run state on its last step, then with ``--rl-epoch ITERATIONS
--set pipeline.resume=true``, which resumes at step SPLIT. Each process's
output goes to ``process_<n>.log`` in the output directory. It then writes
``metrics.csv``, ``hparams.json`` and ``summary.json`` to ``--results``
(default ``matinvent_tpu_torch/experiments/results/<recipe>_climb``): the
keys of the JAX run's ``experiments/results/rl_hhi_rich5_summary.json``
(``iterations``, ``reward_first5_mean``, ``reward_last5_mean``,
``improvement``, ``reward_curve``), the means of the reward by ten
iterations, the first-5 and last-5 means of each property and a DDPO
run's ratio statistics, the same numbers of the archived JAX run of the
recipe (``experiments/results/<recipe>/metrics.csv``, its first ITERATIONS
rows) under ``jax``, the card's name and power limit, the seconds per phase of
each iteration, each process's wall seconds and the step the second process
resumed at; ``hparams.json`` names the repository's files relative to its
root. Prints the summary as one JSON line. Extra ``--set`` and ``--device``
arguments go to both processes.
"""
from __future__ import annotations

import argparse
import csv
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PHASES = ("time_sample_s", "time_score_s", "time_finetune_s")


def card() -> str | None:
    """``name, power limit`` of the card, as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def run_process(n: int, recipe: str, out: Path, rl_epoch: int,
                extra: list[str]) -> tuple[float, str]:
    """One process of the entry point; (wall seconds, its log)."""
    cmd = [sys.executable, "-m", "matinvent_tpu_torch.pipeline.mat_invent", "--recipe", recipe,
           "--rl-epoch", str(rl_epoch), "--out", str(out), *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    (out / f"process_{n}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"process {n} exited {proc.returncode}:\n{log[-4000:]}")
    return seconds, log


def curve_stats(curve: list[float]) -> dict:
    """First-5 and last-5 means, their difference and the means by ten
    iterations of a reward curve."""
    first, last = sum(curve[:5]) / len(curve[:5]), sum(curve[-5:]) / len(curve[-5:])
    tens = [curve[i : i + 10] for i in range(0, len(curve), 10)]
    return dict(
        reward_first5_mean=round(first, 4),
        reward_last5_mean=round(last, 4),
        improvement=round(last - first, 4),
        reward_means_by_ten=[round(sum(t) / len(t), 4) for t in tens],
    )


def reward_curve(path: Path, iterations: int | None = None) -> list[float]:
    """The ``reward mean`` column of a ``metrics.csv`` (its first
    ``iterations`` rows), NaN where a row has none."""
    with open(path) as fh:
        rows = list(csv.DictReader(fh))[:iterations]
    return [float(r["reward mean"]) if r.get("reward mean") else float("nan") for r in rows]


def column_stats(path: Path, iterations: int | None = None) -> dict:
    """First-5 and last-5 means of each property's ``<name> mean`` column,
    and, for a DDPO run, the ratio statistics over its iterations (the
    keys of ``experiments/results/rl_cond_ddpo_summary.json``)."""
    with open(path) as fh:
        rows = list(csv.DictReader(fh))[:iterations]
    out = {}
    for col in rows[0] if rows else ():
        if col.endswith(" mean") and col != "reward mean":
            v = [float(r[col]) for r in rows if r.get(col)]
            name = col[: -len(" mean")]
            if v:
                out[f"{name}_first5_mean"] = round(sum(v[:5]) / len(v[:5]), 4)
                out[f"{name}_last5_mean"] = round(sum(v[-5:]) / len(v[-5:]), 4)
    for col in ("ddpo_ratio_mean", "ddpo_ratio_max", "ddpo_clip_frac"):
        v = [float(r[col]) for r in rows if r.get(col)]
        if v:
            out[f"{col}_mean"] = round(sum(v) / len(v), 6)
            out[f"{col}_max"] = round(max(v), 6)
    return out


def summarize(out: Path, recipe: str, iterations: int) -> dict:
    with open(out / "metrics.csv") as fh:
        rows = list(csv.DictReader(fh))
    steps = [int(r["step"]) for r in rows]
    if steps != list(range(iterations)):
        raise RuntimeError(f"metrics.csv has steps {steps}, not 0..{iterations - 1}")
    curve = reward_curve(out / "metrics.csv")
    cfg = json.loads((out / "hparams.json").read_text())
    reward = "+".join(p["name"] for p in cfg["reward"]["prop_cfg"])
    summary = dict(
        iterations=iterations, **curve_stats(curve),
        run=recipe, reward=reward,
        family="diffcsp" if cfg["model"].get("class") == "DiffCSPSuite" else "mattergen",
        timesteps=cfg["model"]["model_cfg"]["timesteps"],
        batch=cfg["model"]["sample_cfg"]["batch_size"],
        reward_curve=[round(v, 4) for v in curve],
        **column_stats(out / "metrics.csv"),
        seconds_per_phase={p: [float(r[p]) if r.get(p) else None for r in rows] for p in PHASES},
    )
    archived = ROOT / "experiments/results" / recipe / "metrics.csv"
    if archived.is_file():
        jax_curve = reward_curve(archived, iterations)
        summary["jax"] = dict(metrics=str(archived.relative_to(ROOT)), **curve_stats(jax_curve),
                              **column_stats(archived, iterations),
                              reward_curve=[round(v, 4) for v in jax_curve])
    return summary


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--recipe", default="rl_hhi_rich5")
    parser.add_argument("--iterations", type=int, default=60)
    parser.add_argument("--split", type=int, default=30)
    parser.add_argument("--out", default=None, help="default runs/<recipe>_climb")
    parser.add_argument("--results", default=None,
                        help="default matinvent_tpu_torch/experiments/results/<recipe>_climb")
    parser.add_argument("--device", default=None)
    parser.add_argument("--set", action="append", default=[], metavar="KEY.PATH=VALUE")
    args = parser.parse_args(argv)
    if not 0 < args.split < args.iterations:
        raise ValueError("--split must lie between 0 and --iterations")
    out = Path(args.out or ROOT / "runs" / f"{args.recipe}_climb")
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    extra = [a for s in args.set for a in ("--set", s)]
    if args.device:
        extra += ["--device", args.device]
    first_seconds, _ = run_process(1, args.recipe, out, args.split, extra)
    second_seconds, log = run_process(
        2, args.recipe, out, args.iterations, [*extra, "--set", "pipeline.resume=true"])
    resumed = re.search(r"resumed run state at step (\d+)", log)
    if resumed is None or int(resumed.group(1)) != args.split:
        raise RuntimeError(f"the second process did not resume at step {args.split}")
    summary = summarize(out, args.recipe, args.iterations)
    summary.update(
        card=card(), resumed_at_step=int(resumed.group(1)),
        process_seconds=[first_seconds, second_seconds],
        command=" ".join(["python -m matinvent_tpu_torch.experiments.rl_climb",
                          f"--recipe {args.recipe}",
                          f"--iterations {args.iterations} --split {args.split}",
                          *(f"--set {s}" for s in args.set)]),
    )
    results = Path(args.results or ROOT / "matinvent_tpu_torch/experiments/results"
                   / f"{args.recipe}_climb")
    results.mkdir(parents=True, exist_ok=True)
    shutil.copy(out / "metrics.csv", results / "metrics.csv")
    # the repository's paths relative to its root, as the recipe gives them
    hparams = (out / "hparams.json").read_text().replace(str(ROOT) + "/", "")
    (results / "hparams.json").write_text(hparams)
    (results / "summary.json").write_text(json.dumps(summary, indent=2) + "\n")
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
