"""Generation quality and reward shift of an RL-finetuned checkpoint
(``experiments/post_rl_gen_eval.py`` of the JAX package), on the card.

    python -m matinvent_tpu_torch.experiments.post_rl_gen_eval \\
        [ckpt=experiments/results/rl_hhi_rich5/models/final] [name=hhi_rich5] \\
        [reward=hhi] [corpus=experiments/data/corpus_r5.extxyz] \\
        [pretrain_gen=experiments/results/gen_eval_1024_r5] [out=runs/post_rl_gen_eval] \\
        [hidden=256] [layers=6] [timesteps=1000] [max_atoms=20] \\
        [batch_size=32] [num_batches=32] [relax=true] [model.a.b=v ...] [device=cpu]

Generates ``batch_size x num_batches`` crystals (1024, the reference
workload) from the RL run's checkpoint through
``matinvent_tpu_torch.gen_eval`` with JAX's override list (relaxation,
the disordered and ordered matchers, the corpus as the novelty reference,
its hull ``<corpus>_energies.json`` and its atom-count histogram) into
``<out>/gen_eval_1024_post_<name>`` (kept where its ``metrics.json``
exists), then scores that generation and the pretrained model's
(``pretrain_gen``, read only) with the reward ``reward`` of ``configs/``
(``score_extxyz``) and writes ``<out>/post_rl_gen_eval_<name>.json`` with
JAX's keys. Further ``model.``-keys go to ``gen_eval`` after JAX's list
(e.g. ``model.config_overrides.timesteps=250`` for a shorter grid).
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

from matinvent_tpu_torch import gen_eval as entry_gen_eval
from matinvent_tpu_torch.chem.structure import read_extxyz
from matinvent_tpu_torch.main import CONFIG_DIR, pop_device
from matinvent_tpu_torch.utils.config import instantiate, load_config

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def score_extxyz(xyz_path: str, reward_name: str, work_dir: str, label: str,
                 device=None) -> dict:
    """Reward statistics of every structure of an extxyz file: ``n`` counts
    them all, the statistics are over the ``n_scored`` that the reward did
    not fail on (failures are excluded, not zero-filled). The reward's
    files go under ``work_dir``, from which it is scored."""
    cfg = load_config(CONFIG_DIR, "base", overrides=[f"reward={reward_name}"])
    strucs = read_extxyz(xyz_path)
    cwd = os.getcwd()
    os.makedirs(work_dir, exist_ok=True)
    os.chdir(work_dir)
    try:
        reward = instantiate(cfg["reward"], device, "reward")
        rewards, _, failed = reward.scoring((strucs, xyz_path), label)
    finally:
        os.chdir(cwd)
    ok = rewards[~failed] if failed.any() else rewards
    thr = float(cfg["reward"].get("reward_threshold", 0.8))
    return {
        "n": int(len(strucs)),
        "n_scored": int(len(ok)),
        "reward_mean": round(float(np.mean(ok)), 4),
        "reward_std": round(float(np.std(ok)), 4),
        "reward_p90": round(float(np.percentile(ok, 90)), 4),
        "frac_above_threshold": round(float(np.mean(ok >= thr)), 4),
        "threshold": thr,
    }


def main(argv: list[str] | None = None) -> dict:
    argv, device = pop_device(list(sys.argv[1:] if argv is None else argv))
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    extra = [f"{k}={v}" for k, v in kv.items() if k.startswith("model.")]
    out_dir = os.path.abspath(kv.get("out", "runs/post_rl_gen_eval"))
    ckpt = os.path.abspath(kv.get("ckpt", os.path.join(
        ROOT, "experiments/results/rl_hhi_rich5/models/final")))
    name = kv.get("name", "hhi_rich5")
    reward_name = kv.get("reward", "hhi")
    corpus = os.path.abspath(kv.get("corpus", os.path.join(
        ROOT, "experiments/data/corpus_r5.extxyz")))
    energies = os.path.splitext(corpus)[0] + "_energies.json"
    pretrain_gen = os.path.abspath(kv.get("pretrain_gen", os.path.join(
        ROOT, "experiments/results/gen_eval_1024_r5")))
    hidden = kv.get("hidden", "256")
    layers = kv.get("layers", "6")
    timesteps = kv.get("timesteps", "1000")
    max_atoms = kv.get("max_atoms", "20")

    post_dir = os.path.join(out_dir, f"gen_eval_1024_post_{name}")
    if not os.path.exists(os.path.join(post_dir, "metrics.json")):
        entry_gen_eval.main([
            "model=mattergen",
            f"model.model_path={ckpt}",
            f"model.model_cfg.hidden_dim={hidden}",
            f"model.model_cfg.num_layers={layers}",
            "model.model_cfg.time_dim=128",
            f"model.model_cfg.timesteps={timesteps}",
            f"model.sample_cfg.max_atoms={max_atoms}",
            f"output_dir={post_dir}",
            f"batch_size={kv.get('batch_size', '32')}",
            f"num_batches={kv.get('num_batches', '32')}",
            f"reference_path={corpus}", f"reference_energies={energies}",
            f"relax={kv.get('relax', 'true')}", f"num_atoms_from={corpus}",
            "structure_matcher=disordered,ordered",
        ] + extra + ([f"device={device}"] if device else []))

    with open(os.path.join(post_dir, "metrics.json")) as fh:
        post_metrics = json.load(fh)
    with open(os.path.join(pretrain_gen, "metrics.json")) as fh:
        pre_metrics = json.load(fh)

    def side(gen_dir: str, metrics: dict, label: str) -> dict:
        xyz = os.path.join(gen_dir, "generated_crystals.extxyz")
        return {
            "reward_stats": score_extxyz(xyz, reward_name, post_dir, label, device),
            "gen_metrics": {k: v for k, v in metrics.items() if k != "by_matcher"},
        }

    summary = {
        "description": (
            "Reference gen_eval.sh workflow on an RL-FINETUNED checkpoint: "
            "1024 structures from the RL-final model vs the same pretrain "
            "the run started from, with SUN metrics and the run's reward "
            "scored on both generations."
        ),
        "ckpt": os.path.relpath(ckpt, ROOT),
        "reward": reward_name,
        "pretrain": side(pretrain_gen, pre_metrics, "pre"),
        "post_rl": side(post_dir, post_metrics, "post"),
    }
    out_json = os.path.join(out_dir, f"post_rl_gen_eval_{name}.json")
    with open(out_json, "w") as fh:
        json.dump(summary, fh, indent=2)
        fh.write("\n")
    print("[post_rl_gen_eval] " + json.dumps({
        "pre_reward": summary["pretrain"]["reward_stats"]["reward_mean"],
        "post_reward": summary["post_rl"]["reward_stats"]["reward_mean"],
        "pre_sun": summary["pretrain"]["gen_metrics"].get("frac_sun"),
        "post_sun": summary["post_rl"]["gen_metrics"].get("frac_sun"),
        "out": out_json,
    }), flush=True)
    return summary


if __name__ == "__main__":
    main()
