"""Hold a gen_eval ``metrics.json`` against a record, fraction by fraction.

    python -m matinvent_tpu_torch.experiments.compare_gen_eval \\
        matinvent_tpu_torch/experiments/results/gen_eval_1024_r5/metrics.json \\
        experiments/results/gen_eval_1024_r5_metrics.json [--sigmas 4]

For every fraction of every matcher tier (validity, unique, novel, stable,
SUN), the difference of the two runs in units of the binomial sigma
``sqrt(p (1 - p) / n)`` at their mean fraction ``p`` and the record's
``num_generated`` ``n``. Prints one JSON record and exits non-zero when a
difference exceeds ``--sigmas``.
"""
from __future__ import annotations

import argparse
import json
import math
import sys


def binomial_z(a: float, b: float, n: int) -> dict:
    """Two fractions' difference in units of the binomial sigma
    ``sqrt(p (1 - p) / n)`` at their mean ``p``."""
    p = (a + b) / 2
    sigma = math.sqrt(p * (1 - p) / n)
    z = 0.0 if a == b else abs(a - b) / sigma if sigma > 0 else math.inf
    return dict(ours=a, record=b, sigma=sigma, z=z)


def compare(ours: dict, record: dict, sigmas: float = 4.0) -> dict:
    n = record["num_generated"]
    tiers = record.get("by_matcher") or {record["structure_matcher"]: record}
    ours_tiers = ours.get("by_matcher") or {ours["structure_matcher"]: ours}
    rows, worst = {}, 0.0
    for tier, ref in tiers.items():
        for key, b in ref.items():
            rows[f"{tier}/{key}"] = row = binomial_z(ours_tiers[tier][key], b, n)
            worst = max(worst, row["z"])
    return dict(n=n, sigmas=sigmas, worst_z=worst, within=worst <= sigmas, fractions=rows)


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("ours")
    parser.add_argument("record")
    parser.add_argument("--sigmas", type=float, default=4.0)
    args = parser.parse_args(argv)
    with open(args.ours) as fh, open(args.record) as rf:
        out = compare(json.load(fh), json.load(rf), args.sigmas)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["within"] else 1)
