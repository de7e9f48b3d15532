"""RL driven by the ML property predictors (``experiments/rl_predictor_runs.py``
of the JAX package, BASELINE.md's configs 3-5), on the card.

    python -m matinvent_tpu_torch.experiments.rl_predictor_runs \\
        run=mag|gapbulk|heatcap|hhi [iters=60] [family=diffcsp|mattergen] \\
        [out=runs/rl_predictor_runs] [timesteps=] [accum=] [batch=128] [lr=] \\
        [sigma=] [epochs=] [topk=] [seed=] [expname=] [ckpt=] [max_atoms=] \\
        [num_atoms_file=] [num_atoms_dist=] [replay_sample=] [div=off] \\
        [mode=ddpo] [ddpo_epochs=] [a.b=v ...] [device=cpu]

``mag``: MatterGen with the magnetic-density predictor; ``gapbulk``: band
gap and bulk modulus (``reward=gap_bulk``, ``reduce: weight``) with the
``OptFilter`` screen and the diversity filter (``family=`` DiffCSP by
default, at T=1000); ``heatcap``: heat capacity through the MLIP bridge;
``hhi``: MatterGen with the HHI reward. The demo corpus and its
pretraining are ``rl_demo``'s (the MatterGen checkpoint keyed by T, as
the time embedding ties a checkpoint to its T). Every dotted key
(``a.b=v``, ``+a.b=v``) goes to the entry point as it is. The entry point
``matinvent_tpu_torch.main`` gets JAX's override list; the run's summary
is ``<out>/<expname>_summary.json`` with JAX's fields.
"""
from __future__ import annotations

import json
import os
import sys

from matinvent_tpu_torch import main as entry_main
from matinvent_tpu_torch.experiments import rl_demo
from matinvent_tpu_torch.main import pop_device
from matinvent_tpu_torch.tools import pretrain as pretrain_tool


def summarize(run_dir: str, out_path: str, extra: dict) -> dict:
    rewards = rl_demo.reward_column(os.path.join(run_dir, "metrics.csv"))
    summary = dict(
        rl_demo.curve_summary(rewards), **extra,
        reward_curve=[round(float(r), 4) for r in rewards],
    )
    with open(out_path, "w") as fh:
        json.dump(summary, fh, indent=2)
        fh.write("\n")
    print("[rl_predictor] " + json.dumps(
        {k: v for k, v in summary.items() if k != "reward_curve"}), flush=True)
    return summary


def _ensure_diffcsp_pretrain(ckpt_dir: str, data_path: str, timesteps: int,
                             dev_args: list[str] = ()) -> None:
    if os.path.exists(os.path.join(ckpt_dir, "state_dict.npz")):
        return
    pretrain_tool.main(
        [f"data={data_path}", f"output_dir={ckpt_dir}", "steps=20000",
         "batch_size=128", "max_atoms=8", "lr=1.5e-3",
         "model.model_cfg.hidden_dim=128", "model.model_cfg.num_layers=4",
         "model.model_cfg.time_dim=128",
         f"model.model_cfg.timesteps={timesteps}"] + list(dev_args)
    )


def main(argv: list[str] | None = None) -> dict:
    argv, device = pop_device(list(sys.argv[1:] if argv is None else argv))
    dev_args = [f"device={device}"] if device else []
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    passthrough = [f"{k}={v}" for k, v in kv.items() if "." in k]
    kv = {k: v for k, v in kv.items() if "." not in k}
    run = kv.get("run", "mag")
    out_dir = os.path.abspath(kv.get("out", "runs/rl_predictor_runs"))
    iters = int(kv.get("iters", 60))
    timesteps = int(kv.get("timesteps", 1000 if run == "gapbulk" else 100))
    accum = int(kv.get("accum", 50 if run == "gapbulk" else 25))
    batch = int(kv.get("batch", 128))
    os.makedirs(out_dir, exist_ok=True)

    data_path = os.path.join(out_dir, "dataset.extxyz")
    if not os.path.exists(data_path):
        rl_demo.make_dataset(data_path)

    def mattergen_ckpt() -> str:
        suffix = "" if timesteps == 100 else f"_t{timesteps}"
        ckpt = os.path.join(out_dir, f"pretrained_mattergen{suffix}")
        if not os.path.exists(os.path.join(ckpt, "params.msgpack")):
            rl_demo.pretrain_mattergen(data_path, ckpt, timesteps=timesteps, device=device)
        return ckpt

    if run in ("mag", "heatcap", "hhi"):
        family = "mattergen"
        reward = {"mag": "magnetic_density", "heatcap": "heat_capacity", "hhi": "hhi"}[run]
        expname = {"mag": "rl_mag_density", "heatcap": "rl_heat_capacity",
                   "hhi": "rl_hhi_mattergen"}[run]
        ckpt_dir = mattergen_ckpt()
        filter_args = ["sample_cfg.filter=null"]
    elif run == "gapbulk":
        family = kv.get("family", "diffcsp")
        reward, expname = "gap_bulk", "rl_gap_bulk"
        if family == "mattergen":
            ckpt_dir = mattergen_ckpt()
        else:
            ckpt_dir = os.path.join(out_dir, "pretrained")
            _ensure_diffcsp_pretrain(ckpt_dir, data_path, timesteps, dev_args)
        filter_args = ["sample_cfg.filter.relax=false"]
    else:
        raise SystemExit(f"unknown run={run}")

    lr = kv.get("lr", "0.0001")
    sigma = kv.get("sigma", "0.1")
    epochs = kv.get("epochs", "3")
    topk = kv.get("topk", None)
    seed = kv.get("seed", "0")
    expname = kv.get("expname", expname)
    ckpt_dir = os.path.abspath(kv.get("ckpt", ckpt_dir))
    max_atoms = kv.get("max_atoms", "8")
    # absolute: the entry point changes into the run directory first
    num_atoms_file = kv.get("num_atoms_file")
    if num_atoms_file:
        num_atoms_file = os.path.abspath(num_atoms_file)

    cwd = os.getcwd()
    try:
        entry_main.main(
            [
                f"results_dir={out_dir}", f"expname={expname}", f"seed={seed}",
                f"rl_epoch={iters}", "eval_size=16",
                f"reward={reward}", "logger=csv", f"model={family}",
                f"model.model_path={ckpt_dir}",
                "+model.config_overrides.sample_clip=30.0",
                f"model.sample_cfg.batch_size={batch}",
                f"model.sample_cfg.max_atoms={max_atoms}",
                "model.sample_cfg.num_atoms_distribution="
                + kv.get("num_atoms_dist", "matinvent_corpus"),
                f"model.finetune_cfg.timesteps={timesteps}",
                f"pipeline.finetune_cfg.accum_steps={accum}",
                f"pipeline.finetune_cfg.epochs={epochs}",
                f"pipeline.finetune_cfg.sigma={sigma}",
                f"model.finetune_cfg.lr={lr}",
                f"pipeline.save_freq={iters}",
            ]
            + ([f"+model.sample_cfg.num_atoms_distribution_file={num_atoms_file}"]
               if num_atoms_file else [])
            + ([f"pipeline.topk_ratio={topk}"] if topk else [])
            + ([f"pipeline.replay_args.sample_size={kv['replay_sample']}"]
               if "replay_sample" in kv else [])
            + (["pipeline.div_filter=false"] if kv.get("div") == "off" else [])
            + (["+pipeline.finetune_mode=ddpo",
                f"+model.finetune_cfg.ddpo_epochs={kv.get('ddpo_epochs', '1')}"]
               if kv.get("mode") == "ddpo" else [])
            + filter_args
            + passthrough
            + dev_args
        )
    finally:
        os.chdir(cwd)

    return summarize(
        os.path.join(out_dir, expname),
        os.path.join(out_dir, f"{expname}_summary.json"),
        dict(run=run, family=family, reward=reward, timesteps=timesteps, batch=batch),
    )


if __name__ == "__main__":
    main()
