"""When does classifier-free guidance help? (``experiments/cfg_ablation_r4.py``
of the JAX package), on the card.

    python -m matinvent_tpu_torch.experiments.cfg_ablation_r4 \\
        [out=runs/cfg_ablation_r4] [steps=20000] [timesteps=1000] [device=cpu]

The same conditional h128/L4 MatterGen on the same corpus as
``conditional_demo``, at condition dropout 0.1 (``std_p0.1``) and 0.9
(``weak_p0.9``): each model is the in-repository
``experiments/results/pretrained_cfg_<tag>`` where it has a
``params.msgpack`` (``ckpt_<tag>=DIR`` names another), else pretrained for
``steps`` steps and saved to ``<out>/pretrained_cfg_<tag>``. Each samples
128 crystals (seed 7) at the low and high density targets and the
guidance factors of ``GAMMAS``; ``cfg_ablation_r4.json`` has JAX's keys,
each model's derived fields from ``model_summary``: the worst relative
error by factor, the best factor and whether it beats factor 0, and the
same per target. JAX's closing ``story`` (its own reading of its run) is
not written.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

from matinvent_tpu_torch.experiments import conditional_demo as cond
from matinvent_tpu_torch.main import pop_device

GAMMAS = (0.0, 0.5, 1.0, 2.0, 3.0)
MODELS = (("std_p0.1", 0.1), ("weak_p0.9", 0.9))


def row(target: float, guidance: float, got: np.ndarray) -> dict:
    return dict(
        target=round(float(target), 3), guidance=guidance,
        sampled_mean=round(float(got.mean()), 3) if got.size else None,
        sampled_std=round(float(got.std()), 3) if got.size else None,
        rel_err=round(abs(float(got.mean()) - target) / max(target, 1e-9), 4)
        if got.size else None,
        n=int(got.size),
    )


def model_summary(rows: list[dict], dropout: float) -> dict:
    """One model's entry of ``cfg_ablation_r4.json``, derived from its rows
    as JAX derives it."""
    worst: dict = {}
    for r in rows:
        if r["rel_err"] is not None:
            worst[r["guidance"]] = max(worst.get(r["guidance"], 0.0), r["rel_err"])
    best_gamma = min(worst, key=worst.get) if worst else None
    per: dict = {}
    for r in rows:
        if r["rel_err"] is not None:
            per.setdefault(str(r["target"]), {})[str(r["guidance"])] = r["rel_err"]
    return dict(
        cond_dropout=dropout,
        rows=rows,
        worst_rel_error_by_guidance={str(g): round(e, 4) for g, e in worst.items()},
        best_gamma=best_gamma,
        guidance_helps=bool(best_gamma is not None and best_gamma > 0.0
                            and worst[best_gamma] < worst.get(0.0, np.inf)),
        per_target_best_gamma={t: min(g, key=g.get) for t, g in per.items()},
        per_target_gamma_helps={
            t: (min(g, key=g.get) != "0.0" and g[min(g, key=g.get)] < g.get("0.0", np.inf))
            for t, g in per.items()
        },
    )


def main(argv: list[str] | None = None) -> dict:
    argv, device = pop_device(list(sys.argv[1:] if argv is None else argv))
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    steps = int(kv.get("steps", 20000))
    out_dir = os.path.abspath(kv.get("out", "runs/cfg_ablation_r4"))
    T = int(kv.get("timesteps", 1000))
    os.makedirs(out_dir, exist_ok=True)
    structures, dens = cond.corpus(out_dir)
    cond_stats = (("density", float(dens.mean()), float(dens.std())),)
    cond.register_corpus_histogram("cfg_corpus", structures)
    lo, hi = cond.density_targets(dens)

    out = {
        "targets": dict(low=round(lo, 3), high=round(hi, 3)),
        "corpus_density_mean": round(float(dens.mean()), 3),
        "gammas": list(GAMMAS),
        "models": {},
    }
    for tag, dropout in MODELS:
        ckpt = kv.get(f"ckpt_{tag}",
                      os.path.join(cond.ROOT, f"experiments/results/pretrained_cfg_{tag}"))
        model = cond.conditional_model(
            os.path.abspath(ckpt), cond_stats, T, structures, steps, cond_dropout=dropout,
            save_dir=os.path.join(out_dir, f"pretrained_cfg_{tag}"), device=device,
            log_every=max(steps // 5, 1))
        rows = []
        for target in (lo, hi):
            for g in GAMMAS:
                rows.append(row(target, g, cond.sampled_densities(model, target, g, "cfg_corpus")))
                print(f"[cfg:{tag}] {rows[-1]}", flush=True)
        out["models"][tag] = model_summary(rows, dropout)
        del model

    with open(os.path.join(out_dir, "cfg_ablation_r4.json"), "w") as fh:
        json.dump(out, fh, indent=2)
        fh.write("\n")
    print("[cfg] " + json.dumps({k: v for k, v in out.items() if k != "models"}), flush=True)
    for tag, m in out["models"].items():
        print(f"[cfg] {tag}: worst_by_gamma={m['worst_rel_error_by_guidance']} "
              f"best_gamma={m['best_gamma']} helps={m['guidance_helps']}", flush=True)
    return out


if __name__ == "__main__":
    main()
