"""Summarize finished RL runs of one recipe beside its archived JAX run.

    python -m matinvent_tpu_torch.experiments.summarize_runs \
        --runs DIR [DIR ...] --archived experiments/results/rl_hhi_ddpo \
        --out SUMMARY.json [--command "how the runs were made"]

Each ``DIR`` holds a ``metrics.csv`` (the port's or the JAX package's
``main.py`` columns). Writes one JSON object: for each run, by its
directory name, the statistics of ``rl_climb.summarize`` (first-5 and
last-5 reward means, the improvement, the means by ten iterations, the
reward curve, each property's first-5 / last-5 means, a DDPO run's ratio
statistics), and the same of the archived run's first as many iterations
as the longest run has, under ``archived``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from matinvent_tpu_torch.experiments.rl_climb import ROOT, column_stats, curve_stats, reward_curve


def run_stats(metrics: Path, iterations: int | None = None) -> dict:
    curve = reward_curve(metrics, iterations)
    return dict(iterations=len(curve), **curve_stats(curve), **column_stats(metrics, iterations),
                reward_curve=[round(v, 4) for v in curve])


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", nargs="+", required=True)
    parser.add_argument("--archived", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--command", default=None)
    args = parser.parse_args(argv)
    runs = {Path(d).name: run_stats(Path(d) / "metrics.csv") for d in args.runs}
    longest = max(r["iterations"] for r in runs.values())
    archived = Path(args.archived) / "metrics.csv"
    summary = dict(runs=runs, archived=dict(
        metrics=str(archived.resolve().relative_to(ROOT)), **run_stats(archived, longest)))
    if args.command:
        summary["command"] = args.command
    Path(args.out).write_text(json.dumps(summary, indent=2) + "\n")
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
