"""Which validity leg fails (``experiments/validity_diagnosis_r5.py`` of the
JAX package): each leg (SMACT charge balance, structural sanity, the 25 Å
cell edge) over the archived 1024 generations of the r4 pretrain and over
a 3,000-structure sample of its corpus. Host only.

    python -m matinvent_tpu_torch.experiments.validity_diagnosis_r5 \\
        [out=runs/validity_diagnosis_r5]

Paths are taken from the repository root. The corpus sample is JAX's:
``random.seed(0)`` then ``random.sample(corpus, 3000)`` of
``experiments/data/corpus_r4.extxyz``. ``<out>/validity_diagnosis_r5.json``
has the keys JAX's script writes (``generated_r4``, ``pretrain_corpus``).
"""
from __future__ import annotations

import json
import os
import random
import sys
from collections import Counter

import numpy as np

from matinvent_tpu_torch.chem.structure import read_extxyz
from matinvent_tpu_torch.chem.validity import cell_size_ok, smact_valid, structure_validity
from matinvent_tpu_torch.experiments.validity_fix_r5 import ROOT

GEN = os.path.join(ROOT, "experiments", "results", "gen_eval_1024_r4", "generated_crystals.extxyz")
CORPUS = os.path.join(ROOT, "experiments", "data", "corpus_r4.extxyz")
CORPUS_SAMPLE = 3000


def diagnose(structures, tag: str) -> dict:
    """Each leg's failure share, the shares failing one leg only, the first
    8 failures of each leg in order, and the structural failures' minimum
    distance percentiles."""
    legs = Counter()
    n = len(structures)
    fail_examples = {"smact": [], "structural": [], "cell": []}
    min_dists = []
    for s in structures:
        ok_smact = smact_valid(s)
        ok_struct = structure_validity(s)
        ok_cell = cell_size_ok(s)
        legs["smact_fail"] += not ok_smact
        legs["structural_fail"] += not ok_struct
        legs["cell_fail"] += not ok_cell
        legs["all_ok"] += ok_smact and ok_struct and ok_cell
        legs["only_smact_fail"] += (not ok_smact) and ok_struct and ok_cell
        legs["only_structural_fail"] += ok_smact and (not ok_struct) and ok_cell
        legs["only_cell_fail"] += ok_smact and ok_struct and (not ok_cell)
        if not ok_smact and len(fail_examples["smact"]) < 8:
            fail_examples["smact"].append(s.composition.reduced_formula)
        if not ok_struct:
            min_dists.append(float(s.min_interatomic_distance()))
            if len(fail_examples["structural"]) < 8:
                fail_examples["structural"].append(dict(
                    formula=s.composition.reduced_formula,
                    min_dist=round(float(s.min_interatomic_distance()), 3),
                    volume=round(float(s.volume), 2),
                ))
        if not ok_cell and len(fail_examples["cell"]) < 8:
            fail_examples["cell"].append(dict(formula=s.composition.reduced_formula,
                                              max_len=round(float(s.lengths.max()), 2)))
    out = {
        "tag": tag,
        "n": n,
        "frac_valid": round(legs["all_ok"] / n, 4),
        "frac_smact_fail": round(legs["smact_fail"] / n, 4),
        "frac_structural_fail": round(legs["structural_fail"] / n, 4),
        "frac_cell_fail": round(legs["cell_fail"] / n, 4),
        "frac_only_smact_fail": round(legs["only_smact_fail"] / n, 4),
        "frac_only_structural_fail": round(legs["only_structural_fail"] / n, 4),
        "frac_only_cell_fail": round(legs["only_cell_fail"] / n, 4),
        "examples": fail_examples,
    }
    if min_dists:
        out["structural_fail_min_dist_percentiles"] = {
            f"p{p}": round(float(np.percentile(min_dists, p)), 3) for p in (10, 50, 90)
        }
    return out


def corpus_sample(structures, k: int = CORPUS_SAMPLE) -> list:
    """JAX's sample of a corpus larger than ``k``: stdlib ``random`` at seed 0."""
    if len(structures) <= k:
        return structures
    random.seed(0)
    return random.sample(structures, k)


def main(argv: list[str] | None = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    out_dir = os.path.abspath(kv.get("out", os.path.join(ROOT, "runs", "validity_diagnosis_r5")))
    results = {"generated_r4": diagnose(read_extxyz(GEN), "generated_r4"),
               "pretrain_corpus": diagnose(corpus_sample(read_extxyz(CORPUS)),
                                           os.path.basename(CORPUS))}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "validity_diagnosis_r5.json"), "w") as fh:
        json.dump(results, fh, indent=2)
        fh.write("\n")
    print(json.dumps(results, indent=2), flush=True)
    return results


if __name__ == "__main__":
    main()
