"""Validity against training steps (``experiments/validity_curve_r5.py`` of
the JAX package), on the card: the validity legs of a list of MatterGen
checkpoints, one sampler reused across them.

    python -m matinvent_tpu_torch.experiments.validity_curve_r5 \\
        ckpts=pretrained_geneval_r5_r5_long_s120000_ema[,...] [sample_n=512] \\
        [corpus=experiments/data/corpus_r5.extxyz] [seed=1] \\
        [out=runs/validity_curve_r5] [device=cpu]

A name in ``ckpts`` that is not absolute is taken under
``experiments/results/`` (read only). Each checkpoint samples ``sample_n``
crystals (the corpus histogram, 4 size buckets, cap 20) from the one
sampler, whose draws continue from checkpoint to checkpoint as JAX's do.
The entries, keyed by the checkpoint's basename (a later entry of the same
name replaces an earlier one), go into ``<out>/validity_curve_r5.json``.
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


def evaluate(sampler, ckpt: str, device=None) -> tuple[dict, list]:
    """One checkpoint's entry (its legs over a ``sampler`` call) and the
    structures sampled."""
    model = MatterGenSuite(model_path=ckpt, sample_cfg={"max_atoms": 20},
                           device=device).load_model()
    t0 = time.time()
    _, strucs = sampler.generate(model)
    legs = measure_validity(strucs)
    return dict(ckpt=os.path.basename(ckpt), **legs,
                sample_seconds=round(time.time() - t0, 1)), strucs


def main(argv: list[str] | None = None) -> dict:
    argv, device = pop_device(list(sys.argv[1:] if argv is None else argv))
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    out_dir = os.path.abspath(kv.get("out", os.path.join(ROOT, "runs", "validity_curve_r5")))
    corpus = os.path.abspath(kv.get("corpus", os.path.join(ROOT, "experiments", "data",
                                                           "corpus_r5.extxyz")))
    names = [c for c in kv.get("ckpts", "").split(",") if c]
    if not names:
        raise SystemExit("pass ckpts=name1,name2,... (relative to experiments/results)")
    sample_n = int(kv.get("sample_n", 512))
    seed = int(kv.get("seed", 1))

    sampler = corpus_sampler(read_extxyz(corpus), sample_n, seed)
    path = os.path.join(out_dir, "validity_curve_r5.json")
    data = json.load(open(path)) if os.path.exists(path) else {"runs": []}
    for name in names:
        ckpt = name if os.path.isabs(name) else os.path.join(RESULTS, name)
        entry, _ = evaluate(sampler, ckpt, device)
        data["runs"] = [r for r in data["runs"] if r.get("ckpt") != entry["ckpt"]] + [entry]
        os.makedirs(out_dir, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(data, fh, indent=2)
            fh.write("\n")
        print("[validity_curve] " + json.dumps(entry), flush=True)
    return data


if __name__ == "__main__":
    main()
