"""The JAX package's RL and conditional-generation harnesses at their full
sizes on the card, each held against the JAX record in the repository.

    python -m matinvent_tpu_torch.experiments.harness_check [--out runs/harness_check] \\
        [--results matinvent_tpu_torch/experiments/results/harness_check] \\
        [--parts post_rl,conditional,cfg_ablation,rl_demo]

``post_rl``: ``post_rl_gen_eval`` on ``rl_hhi_rich5/models/final`` (32 x
32, relaxed, the disordered and ordered matchers, ``corpus_r5``) against
``experiments/results/post_rl_gen_eval_hhi_rich5.json``'s ``post_rl``:
``frac_validity``, ``frac_unique``, ``frac_novel``, ``frac_sun`` (n = 1024)
and ``frac_above_threshold`` (n = the record's ``n_scored``) each within 4
binomial sigma ``sqrt(p (1 - p) / n)`` at the two runs' mean ``p``, and
``reward_mean`` within 4 standard errors ``sqrt(s1^2 / n1 + s2^2 / n2)``
(``reward_std`` over ``n_scored`` of both). The pretrained side's reward
statistics (an archived generation, scored again) must equal the record's.

``conditional``: ``conditional_demo`` on the in-repository
``pretrained_conditional_v2``; ``cfg_ablation``: ``cfg_ablation_r4`` on
``pretrained_cfg_std_p0.1`` and ``pretrained_cfg_weak_p0.9``. Each row's
sampled density mean within 4 combined standard errors (the spread over
the square root of the count, of both runs) of the record's row
(``conditional_demo_summary.json``, 8 rows; ``cfg_ablation_r4.json``, 20).

``rl_demo``: ``rl_demo`` at its defaults (DiffCSP, 20,000 pretraining
steps, 40 iterations): the last-5 mean at least 0.40 and at least the
first-5 mean + 0.25 (JAX's ``experiments/results/rl_hhi_summary.json``:
0.0373 -> 0.6887).

Each part runs its harness's ``main`` with ``out=<out>/<part>``, prints
one JSON line (its gates, seconds, the card's name and power limit) and
copies the harness's summary to ``--results``; the record of every part
goes to ``<out>/harness_check.json``. Exits non-zero when a gate fails.
"""
from __future__ import annotations

import argparse
import json
import math
import shutil
import sys
import time
from pathlib import Path

import torch

from matinvent_tpu_torch.experiments import (
    cfg_ablation_r4,
    conditional_demo,
    post_rl_gen_eval,
    rl_demo,
)
from matinvent_tpu_torch.experiments.compare_gen_eval import binomial_z
from matinvent_tpu_torch.experiments.timing import card

ROOT = Path(__file__).resolve().parents[2]
RECORDS = ROOT / "experiments/results"
SIGMAS = 4.0
POST_FRACTIONS = ("frac_validity", "frac_unique", "frac_novel", "frac_sun")
DEMO_LAST5, DEMO_GAIN = 0.40, 0.25


def fraction_gate(a: float, b: float, n: int) -> dict:
    row = binomial_z(a, b, n)
    return dict(row, n=n, ok=row["z"] <= SIGMAS)


def mean_z(m1: float, s1: float, n1: int, m2: float, s2: float, n2: int) -> dict:
    se = math.sqrt(s1 ** 2 / n1 + s2 ** 2 / n2)
    z = 0.0 if m1 == m2 else abs(m1 - m2) / se if se > 0 else math.inf
    return dict(ours=m1, record=m2, se=se, z=z, ok=z <= SIGMAS)


def post_rl_gates(ours: dict, record: dict) -> dict:
    g, gr = ours["post_rl"]["gen_metrics"], record["post_rl"]["gen_metrics"]
    r, rr = ours["post_rl"]["reward_stats"], record["post_rl"]["reward_stats"]
    gates = {k: fraction_gate(g[k], gr[k], gr["num_generated"]) for k in POST_FRACTIONS}
    gates["frac_above_threshold"] = fraction_gate(r["frac_above_threshold"],
                                                  rr["frac_above_threshold"], rr["n_scored"])
    gates["reward_mean"] = mean_z(r["reward_mean"], r["reward_std"], r["n_scored"],
                                  rr["reward_mean"], rr["reward_std"], rr["n_scored"])
    pre_equal = ours["pretrain"]["reward_stats"] == record["pretrain"]["reward_stats"]
    gates["pretrain_reward_stats_equal"] = dict(ok=pre_equal)
    return gates


def density_gates(rows: list[dict], ref_rows: list[dict], mean: str, std: str) -> list[dict]:
    """Each row's sampled mean against the record's row of the same target
    and factor, in combined standard errors."""
    out = []
    for a, b in zip(rows, ref_rows, strict=True):
        if (a["target"], a["guidance"]) != (b["target"], b["guidance"]):
            raise AssertionError(f"row {a} does not match the record's {b}")
        out.append(dict(target=a["target"], guidance=a["guidance"],
                        **mean_z(a[mean], a[std], a["n"], b[mean], b[std], b["n"])))
    return out


def run_post_rl(out: Path) -> tuple[dict, dict, Path]:
    summary = post_rl_gen_eval.main([f"out={out}"])
    metrics = json.loads((out / "gen_eval_1024_post_hhi_rich5/metrics.json").read_text())
    record = json.loads((RECORDS / "post_rl_gen_eval_hhi_rich5.json").read_text())
    gates = post_rl_gates(summary, record)
    extra = dict(structures_per_sec=metrics["structures_per_sec"],
                 generation_time_s=metrics["generation_time_s"], by_matcher=metrics["by_matcher"])
    return dict(gates=gates, **extra), summary, out / "post_rl_gen_eval_hhi_rich5.json"


def run_conditional(out: Path) -> tuple[dict, dict, Path]:
    summary = conditional_demo.main([f"out={out}"])
    record = json.loads((RECORDS / "conditional_demo_summary.json").read_text())
    gates = density_gates(summary["results"], record["results"], "sampled_density_mean",
                          "sampled_density_std")
    return dict(gates=gates, recommended_guidance=summary["recommended_guidance"],
                jax_recommended_guidance=record["recommended_guidance"]), summary, \
        out / "conditional_demo_summary.json"


def run_cfg_ablation(out: Path) -> tuple[dict, dict, Path]:
    summary = cfg_ablation_r4.main([f"out={out}"])
    record = json.loads((RECORDS / "cfg_ablation_r4.json").read_text())
    gates = [g for tag, _ in cfg_ablation_r4.MODELS
             for g in density_gates(summary["models"][tag]["rows"], record["models"][tag]["rows"],
                                    "sampled_mean", "sampled_std")]
    derived = {tag: {k: (m[k], record["models"][tag][k]) for k in
                     ("best_gamma", "guidance_helps", "per_target_best_gamma")}
               for tag, m in summary["models"].items()}
    return dict(gates=gates, derived_ours_and_jax=derived), summary, out / "cfg_ablation_r4.json"


def run_rl_demo(out: Path) -> tuple[dict, dict, Path]:
    summary = rl_demo.main([f"out={out}"])
    record = json.loads((RECORDS / "rl_hhi_summary.json").read_text())
    first, last = summary["reward_first5_mean"], summary["reward_last5_mean"]
    gates = dict(last5=dict(ours=last, least=DEMO_LAST5, ok=last >= DEMO_LAST5),
                 gain=dict(ours=last - first, least=DEMO_GAIN, ok=last >= first + DEMO_GAIN))
    return dict(gates=gates, first5=first, last5=last,
                jax=dict(first5=record["reward_first5_mean"], last5=record["reward_last5_mean"])), \
        summary, out / "summary.json"


PARTS = {"post_rl": run_post_rl, "conditional": run_conditional,
         "cfg_ablation": run_cfg_ablation, "rl_demo": run_rl_demo}
KEPT = {"post_rl": "post_rl_gen_eval_hhi_rich5.json",
        "conditional": "conditional_demo_summary.json",
        "cfg_ablation": "cfg_ablation_r4.json", "rl_demo": "rl_demo_summary.json"}


def passed(gates) -> bool:
    items = gates.values() if isinstance(gates, dict) else gates
    return all(g["ok"] for g in items)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="runs/harness_check")
    ap.add_argument("--results",
                    default=str(ROOT / "matinvent_tpu_torch/experiments/results/harness_check"))
    ap.add_argument("--parts", default=",".join(PARTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("harness_check measures the card: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    out, results = Path(args.out).resolve(), Path(args.results).resolve()
    results.mkdir(parents=True, exist_ok=True)
    rec: dict = dict(experiment="harness_check", device=card())
    for part in args.parts.split(","):
        t = time.perf_counter()
        check, _, summary_path = PARTS[part](out / part)
        check.update(harness=part, device=rec["device"], seconds=time.perf_counter() - t,
                     ok=passed(check["gates"]))
        shutil.copy(summary_path, results / KEPT[part])
        rec[part] = check
        print(json.dumps(check), flush=True)
    (out / "harness_check.json").write_text(json.dumps(rec, indent=1) + "\n")
    return 0 if all(rec[p]["ok"] for p in args.parts.split(",")) else 1


if __name__ == "__main__":
    sys.exit(main())
