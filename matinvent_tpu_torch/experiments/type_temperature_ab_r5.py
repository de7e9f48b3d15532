"""Type-temperature sweep (``experiments/type_temperature_ab_r5.py`` of the
JAX package), on the card: the validity legs and the distinct compositions
of a MatterGen checkpoint sampled at D3PM type temperatures tau.

    python -m matinvent_tpu_torch.experiments.type_temperature_ab_r5 \\
        [taus=1.0,0.8,0.7,0.6,0.5] [ckpt=experiments/results/pretrained_geneval_r4] \\
        [corpus=experiments/data/corpus_r4.extxyz] [sample_n=512] [seed=7] \\
        [out=runs/type_temperature_ab_r5] [device=cpu]

Each tau loads the checkpoint with ``config_overrides`` ``type_temperature
= tau`` (tau 1 is the exact posterior) and samples ``sample_n`` crystals
from a fresh sampler at ``seed`` (the corpus histogram, 4 size buckets,
cap 20). ``<out>/type_temperature_ab_r5.json`` has JAX's keys: per tau the
legs, the distinct reduced formulas and their fraction.
"""
from __future__ import annotations

import json
import os
import sys
import time

from matinvent_tpu_torch.chem.structure import read_extxyz
from matinvent_tpu_torch.experiments.validity_fix_r5 import (
    RESULTS,
    ROOT,
    corpus_sampler,
    measure_validity,
)
from matinvent_tpu_torch.main import pop_device
from matinvent_tpu_torch.models.suite.mattergen import MatterGenSuite

BASELINE_NOTE = ("tau=1.0 is the exact D3PM posterior (reference semantics); "
                 "train-side levers measured as losses in validity_fix_r5.json")


def tau_entry(ckpt: str, tau: float, structures, sample_n: int = 512, seed: int = 7,
              device=None, config_overrides: dict | None = None) -> tuple[dict, list]:
    """One tau's entry and its sampled structures; ``config_overrides`` go
    to the checkpoint's config beside ``type_temperature``."""
    model = MatterGenSuite(model_path=ckpt,
                           config_overrides=dict(config_overrides or {}, type_temperature=tau),
                           sample_cfg={"max_atoms": 20}, device=device).load_model()
    sampler = corpus_sampler(structures, sample_n, seed)
    t0 = time.time()
    _, strucs = sampler.generate(model)
    dt = time.time() - t0
    n = len(strucs)
    legs = measure_validity(strucs)
    comps = {s.composition.reduced_formula for s in strucs}
    entry = dict(
        tau=tau, n=n,
        **{k: legs[k] for k in ("smact_fail", "structural_fail", "cell_fail", "all_ok")},
        distinct_compositions=len(comps),
        frac_distinct_comps=round(len(comps) / n, 4),
        sample_seconds=round(dt, 1),
    )
    return entry, strucs


def main(argv: list[str] | None = None) -> dict:
    argv, device = pop_device(list(sys.argv[1:] if argv is None else argv))
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    out_dir = os.path.abspath(kv.get("out", os.path.join(ROOT, "runs", "type_temperature_ab_r5")))
    ckpt = os.path.abspath(kv.get("ckpt", os.path.join(RESULTS, "pretrained_geneval_r4")))
    corpus = os.path.abspath(kv.get("corpus", os.path.join(ROOT, "experiments", "data",
                                                           "corpus_r4.extxyz")))
    taus = [float(t) for t in kv.get("taus", "1.0,0.8,0.7,0.6,0.5").split(",")]
    sample_n = int(kv.get("sample_n", 512))
    seed = int(kv.get("seed", 7))

    structures = read_extxyz(corpus)
    results = []
    for tau in taus:
        entry, _ = tau_entry(ckpt, tau, structures, sample_n, seed, device)
        results.append(entry)
        print("[tau-ab] " + json.dumps(entry), flush=True)
    out = dict(ckpt=os.path.relpath(ckpt, RESULTS), sample_n=sample_n,
               baseline_note=BASELINE_NOTE, sweep=results)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "type_temperature_ab_r5.json"), "w") as fh:
        json.dump(out, fh, indent=2)
        fh.write("\n")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
