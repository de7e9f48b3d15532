"""Validity-fix probe (``experiments/validity_fix_r5.py`` of the JAX
package), on the card: a warm-start continuation of a MatterGen checkpoint
with a reweighted type loss, or a fresh pretrain, then the validity legs of
a sample.

    python -m matinvent_tpu_torch.experiments.validity_fix_r5 tag=wt4 wt=4.0 \\
        steps=10000 [lr=3e-4] [ckpt=experiments/results/pretrained_geneval_r4] \\
        [corpus=experiments/data/corpus_r4.extxyz] [sample_n=256] [wpos=0.1] \\
        [batch_size=256] [max_atoms=20] [seed=0] [scratch=1 hidden=256 layers=6 \\
        kind=uniform|absorbing] [ema=0.9995] [snap=30000] [out=runs/validity_fix_r5] \\
        [device=cpu]

The arguments and defaults are JAX's. ``ckpt`` warm-starts with
``config_overrides`` ``weight_types`` / ``weight_pos``; ``scratch=1``
pretrains an h``hidden``/L``layers``, T=1000 model of D3PM ``kind`` from
``seed`` instead. ``ema`` trains Polyak-averaged weights (saved and
sampled), ``snap`` saves raw and EMA snapshots as ``{new}_s{step}[_ema]``.
The trained checkpoint ``new`` is ``<out>/pretrained_geneval_r5_{tag}``:
with ``steps > 0`` it is trained there unless it already exists; with
``steps=0`` an existing one is sampled, from ``out`` or else the archived
``experiments/results/pretrained_geneval_r5_{tag}``, which is read and
never written; with neither, the warm-start checkpoint itself is sampled
(JAX's ``base`` entry). ``sample_n`` crystals are drawn at seed ``seed +
1`` (the corpus histogram, 4 size buckets) and their legs go into
``<out>/validity_fix_r5.json``, the entry with JAX's keys replacing any
earlier entry of the same ``tag``. Nothing is written under
``experiments/results/``.
"""
from __future__ import annotations

import copy
import json
import os
import sys
import time

import numpy as np
import torch

from matinvent_tpu_torch.chem.structure import read_extxyz
from matinvent_tpu_torch.chem.validity import cell_size_ok, smact_valid, structure_validity
from matinvent_tpu_torch.main import pop_device
from matinvent_tpu_torch.models.mattergen.sample import MatterGenSampler
from matinvent_tpu_torch.models.sample import atom_dist_from_structures, register_atom_dist
from matinvent_tpu_torch.models.suite.mattergen import MatterGenSuite
from matinvent_tpu_torch.parallel.pretrain import PretrainTrainer, structures_to_batches

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RESULTS = os.path.join(ROOT, "experiments", "results")


def measure_validity(strucs) -> dict:
    """The shares of the three validity legs (SMACT charge balance,
    structural sanity, cell size) that fail, and of all three passed,
    rounded to 4 places, and ``n``."""
    n = max(len(strucs), 1)
    c = {"smact_fail": 0, "structural_fail": 0, "cell_fail": 0, "all_ok": 0}
    for s in strucs:
        ok_s, ok_g, ok_c = smact_valid(s), structure_validity(s), cell_size_ok(s)
        c["smact_fail"] += not ok_s
        c["structural_fail"] += not ok_g
        c["cell_fail"] += not ok_c
        c["all_ok"] += ok_s and ok_g and ok_c
    return {k: round(v / n, 4) for k, v in c.items()} | {"n": len(strucs)}


def corpus_sampler(structures, sample_n: int, seed: int, max_atoms: int = 20) -> MatterGenSampler:
    """The studies' sampler: ``sample_n`` crystals in one batch, atom counts
    from the corpus histogram (registered as ``corpus``), 4 size buckets."""
    register_atom_dist("corpus", atom_dist_from_structures(structures))
    return MatterGenSampler(batch_size=sample_n, num_batches=1, max_atoms=max_atoms,
                            num_atoms_distribution="corpus", size_buckets=4, seed=seed)


def has_ckpt(path: str) -> bool:
    return os.path.exists(os.path.join(path, "params.msgpack"))


def main(argv: list[str] | None = None) -> dict:
    argv, device = pop_device(list(sys.argv[1:] if argv is None else argv))
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    out_dir = os.path.abspath(kv.get("out", os.path.join(ROOT, "runs", "validity_fix_r5")))
    ckpt = os.path.abspath(kv.get("ckpt", os.path.join(RESULTS, "pretrained_geneval_r4")))
    corpus = os.path.abspath(kv.get("corpus", os.path.join(ROOT, "experiments", "data",
                                                           "corpus_r4.extxyz")))
    tag = kv.get("tag", "wt4")
    wt = float(kv.get("wt", 4.0))
    wpos = float(kv.get("wpos", 0.1))
    steps = int(kv.get("steps", 10000))
    lr = float(kv.get("lr", 3e-4))
    batch_size = int(kv.get("batch_size", 256))
    max_atoms = int(kv.get("max_atoms", 20))
    sample_n = int(kv.get("sample_n", 256))
    seed = int(kv.get("seed", 0))
    scratch = kv.get("scratch", "0") not in ("0", "false", "")
    kind = kv.get("kind", "uniform")
    ema_decay = float(kv.get("ema", 0)) or None
    snapshot_every = int(kv.get("snap", 0)) or None

    if scratch:
        suite = MatterGenSuite(
            model_cfg=dict(hidden_dim=int(kv.get("hidden", 256)),
                           num_layers=int(kv.get("layers", 6)), time_dim=128, timesteps=1000,
                           weight_types=wt, weight_pos=wpos, d3pm_kind=kind),
            sample_cfg={"max_atoms": max_atoms}, seed=seed, device=device,
        )
    else:
        suite = MatterGenSuite(model_path=ckpt,
                               config_overrides=dict(weight_types=wt, weight_pos=wpos),
                               sample_cfg={"max_atoms": max_atoms}, device=device)
    model = suite.load_model()
    structures = read_extxyz(corpus)
    new_ckpt = os.path.join(out_dir, f"pretrained_geneval_r5_{tag}")
    archived = os.path.join(RESULTS, f"pretrained_geneval_r5_{tag}")
    print(f"[validity_fix] {len(structures)} corpus structures; warm start {ckpt} -> "
          f"{new_ckpt} (wt={wt}, wpos={wpos}, steps={steps}, lr={lr})", flush=True)

    train_seconds = None
    if steps > 0 and not has_ckpt(new_ckpt):
        batches = structures_to_batches(structures, batch_size, max_atoms,
                                        np.random.default_rng(seed))
        trainer = PretrainTrainer(model, lr=lr, total_steps=steps, ema_decay=ema_decay)

        def save(weights, path):
            snap = copy.deepcopy(model)
            snap.load_state_dict(weights)
            suite.save_model(snap, path)

        def snapshot(step, weights, ema):
            save(weights, f"{new_ckpt}_s{step}")
            if ema is not None:
                save(ema, f"{new_ckpt}_s{step}_ema")

        if model.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        weights, _ = trainer.train(
            batches, steps, torch.Generator(device=model.device).manual_seed(seed),
            log_every=max(steps // 10, 1), snapshot_every=snapshot_every,
            snapshot_cb=snapshot if snapshot_every else None,
        )
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        train_seconds = time.perf_counter() - t0
        print(f"[validity_fix] trained {steps} steps in {train_seconds:.0f}s", flush=True)
        model.load_state_dict(weights)
        suite.save_model(model, new_ckpt)
    else:
        found = next((p for p in (new_ckpt, archived) if has_ckpt(p)), None)
        if found is not None:
            model = MatterGenSuite(model_path=found, sample_cfg={"max_atoms": max_atoms},
                                   device=device).load_model()
            print(f"[validity_fix] reusing {found}", flush=True)

    sampler = corpus_sampler(structures, sample_n, seed + 1, max_atoms)
    t0 = time.time()
    _, strucs = sampler.generate(model)
    legs = measure_validity(strucs)
    legs["sample_seconds"] = round(time.time() - t0, 1)
    entry = dict(
        tag=tag, weight_types=wt, weight_pos=wpos, steps=steps, lr=lr,
        d3pm_kind=kind, scratch=scratch, ema_decay=ema_decay,
        corpus=os.path.basename(corpus),
        ckpt_in=None if scratch else os.path.relpath(ckpt, RESULTS),
        ckpt_out=os.path.relpath(new_ckpt, out_dir) if steps > 0 else None,
        **legs,
    )
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "validity_fix_r5.json")
    data = json.load(open(path)) if os.path.exists(path) else {"runs": []}
    data["runs"] = [r for r in data["runs"] if r.get("tag") != tag] + [entry]
    with open(path, "w") as fh:
        json.dump(data, fh, indent=2)
        fh.write("\n")
    print("[validity_fix] " + json.dumps(entry), flush=True)
    if train_seconds is not None:
        entry = dict(entry, train_seconds=train_seconds, ms_per_step=1e3 * train_seconds / steps)
    return entry


if __name__ == "__main__":
    main()
